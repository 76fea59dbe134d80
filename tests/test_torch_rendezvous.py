"""The rendezvous half of the port's launcher
(tpu_dra_torch/workloads/launcher.py: ``RendezvousInfo``, ``resolve``,
``load_nodes_config``) against the reference's
(tpu_dra/workloads/launcher.py): field-equal results over settings-dir,
coordination-service, ``JAX_*`` override and multislice configs, the same
errors, ``initialize``'s contracts and its ``torch.distributed`` call, and
a real two-process gloo rendezvous through the settings dir, the port of
tests/test_jax_distributed.py."""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys

import pytest
import torch.distributed as dist

from tpu_dra.api.types import TpuSliceDomainNode
from tpu_dra.daemon.coordservice import serve
from tpu_dra.daemon.main import write_nodes_config
from tpu_dra.util.rank import rank_sorted as ref_rank_sorted
from tpu_dra.workloads import launcher as ref
from tpu_dra_torch.util.rank import rank_sorted
from tpu_dra_torch.workloads import launcher as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = "dep-uuid"
SLICE0, SLICE1 = f"{DEPLOY}.0", f"{DEPLOY}.3"
WAIT = 120


def fields(info) -> dict:
    return dataclasses.asdict(info)


def multislice_nodes():
    # insertion order scrambled: the order comes from (slice, worker, name)
    return [TpuSliceDomainNode("n3", "10.0.1.11", SLICE1, 1),
            TpuSliceDomainNode("n0", "10.0.0.10", SLICE0, 0),
            TpuSliceDomainNode("n2", "10.0.1.10", SLICE1, 0),
            TpuSliceDomainNode("n1", "10.0.0.11", SLICE0, 1)]


LEGACY = {"nodes": [
    {"name": "n1", "ipAddress": "10.0.0.11", "workerID": 1},
    {"name": "n0", "ipAddress": "10.0.0.10", "workerID": 0},
    {"name": "n2", "ipAddress": "10.0.0.12"},
    {"ipAddress": "10.0.0.13", "workerID": 1}]}
RANKED = {"generation": 7, "nodes": [
    {"name": "b", "ipAddress": "10.0.0.21", "rank": 1, "workerID": 0},
    {"name": "a", "ipAddress": "10.0.0.20", "rank": 0, "workerID": 5}]}
BAD_GENERATION = {"generation": "x", "nodes": [
    {"name": "a", "ipAddress": "10.0.0.20"}]}


@pytest.mark.parametrize("nodes", [LEGACY["nodes"], RANKED["nodes"], []])
def test_rank_sorted_is_the_reference_s(nodes):
    assert rank_sorted(nodes) == ref_rank_sorted(nodes)


@pytest.mark.parametrize("data", [LEGACY, RANKED, BAD_GENERATION,
                                  {"nodes": []}], ids=["legacy", "ranked",
                                                       "bad-generation",
                                                       "empty"])
@pytest.mark.parametrize("ip", ["10.0.0.10", "10.0.0.13", "10.0.0.21",
                                "10.0.0.20", "10.9.9.9"])
def test_info_from_config_equals_the_reference(data, ip):
    env = {"JAX_COORDINATOR_PORT": "9999"}
    want = ref._info_from_config(data, ip, env)
    got = port._info_from_config(data, ip, env)
    assert (got is None) == (want is None)
    if want is not None:
        assert fields(got) == fields(want)


@pytest.mark.parametrize("ip", ["10.0.0.10", "10.0.0.11", "10.0.1.10",
                                "10.0.1.11"])
@pytest.mark.parametrize("writer", [SLICE0, SLICE1])
def test_multislice_settings_dir_equals_the_reference(tmp_path, writer, ip):
    write_nodes_config(str(tmp_path), multislice_nodes(), writer)
    want = ref._from_settings_dir(str(tmp_path), ip, {})
    got = port._from_settings_dir(str(tmp_path), ip, {})
    assert fields(got) == fields(want)
    assert got.megascale_env({}) == want.megascale_env({})
    env = {"MEGASCALE_COORDINATOR_PORT": "7777"}
    assert got.megascale_env(env) == want.megascale_env(env)


def test_multislice_triple_and_megascale_env(tmp_path):
    write_nodes_config(str(tmp_path), multislice_nodes(), SLICE1)
    info = port._from_settings_dir(str(tmp_path), "10.0.1.10", {})
    assert (info.num_processes, info.process_id) == (4, 2)
    assert info.coordinator_address == "10.0.0.10:8476"
    assert (info.num_slices, info.slice_id) == (2, 1)
    assert info.megascale_env({}) == {
        "MEGASCALE_COORDINATOR_ADDRESS": "10.0.0.10:8080",
        "MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1"}
    assert port.RendezvousInfo("10.0.0.10:8476", 2, 0).megascale_env(
        {}) == {}


@pytest.mark.parametrize("ip", ["10.0.0.10", "10.0.1.11", "10.9.9.9"])
def test_coordservice_path_equals_the_reference(tmp_path, ip):
    write_nodes_config(str(tmp_path), multislice_nodes(), SLICE0)
    server = serve(str(tmp_path), port=0, address="127.0.0.1")
    try:
        svc = server.server_address[1]
        want = ref._from_coordservice(svc, ip, {})
        got = port._from_coordservice(svc, ip, {})
        assert (got is None) == (want is None)
        if want is not None:
            assert fields(got) == fields(want)
        env = {"SLICE_SETTINGS_DIR": str(tmp_path / "absent"),
               "SLICE_COORDINATOR_PORT": str(svc)}
        assert port.load_nodes_config(env) == ref.load_nodes_config(env)
        if want is not None:
            claim = dict(env, SLICE_DOMAIN_UUID="uid-9", POD_IP=ip)
            assert fields(port.resolve(claim)) == fields(ref.resolve(claim))
    finally:
        server.shutdown()


def test_resolve_from_settings_dir_equals_the_reference(tmp_path):
    (tmp_path / "nodes_config.json").write_text(json.dumps(LEGACY))
    env = {"SLICE_DOMAIN_UUID": "uid-1", "SLICE_SETTINGS_DIR": str(tmp_path),
           "POD_IP": "10.0.0.11"}
    got = port.resolve(env)
    assert fields(got) == fields(ref.resolve(env))
    assert got.coordinator_address == "10.0.0.10:8476"
    # (workerID, name): n0, the unnamed worker 1, n1, then n2 (no workerID)
    assert (got.num_processes, got.process_id, got.domain_uid) == \
        (4, 2, "uid-1")
    assert port.load_nodes_config(env) == ref.load_nodes_config(env)


@pytest.mark.parametrize("env", [
    {"JAX_COORDINATOR_ADDRESS": "1.2.3.4:999", "JAX_NUM_PROCESSES": "4",
     "JAX_PROCESS_ID": "2"},
    {"JAX_COORDINATOR_ADDRESS": "10.0.0.10:8476", "JAX_NUM_PROCESSES": "4",
     "JAX_PROCESS_ID": "3", "SLICE_DOMAIN_UUID": "uid-2",
     "MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1",
     "MEGASCALE_COORDINATOR_ADDRESS": "10.0.0.10:8080"},
], ids=["plain", "multislice"])
def test_explicit_env_wins_as_in_the_reference(env, tmp_path):
    # an explicit triple wins over a settings dir that would resolve too
    (tmp_path / "nodes_config.json").write_text(json.dumps(LEGACY))
    env = dict(env, SLICE_SETTINGS_DIR=str(tmp_path), POD_IP="10.0.0.11")
    got = port.resolve(env)
    assert fields(got) == fields(ref.resolve(env))
    assert got.coordinator_address == env["JAX_COORDINATOR_ADDRESS"]
    assert got.megascale_env(env) == ref.resolve(env).megascale_env(env)


def test_resolve_errors_are_the_reference_s(tmp_path):
    with pytest.raises(RuntimeError, match="channel claim"):
        port.resolve({})
    env = {"SLICE_DOMAIN_UUID": "uid-1",
           "SLICE_SETTINGS_DIR": str(tmp_path / "empty"),
           "POD_IP": "10.0.0.11", "SLICE_COORDINATOR_PORT": "1"}
    with pytest.raises(RuntimeError, match="could not resolve"):
        port.resolve(env)
    with pytest.raises(RuntimeError, match="could not resolve"):
        ref.resolve(env)


def test_resolve_fires_its_failpoint_and_records_its_span():
    from tpu_dra_torch.resilience import failpoint
    from tpu_dra_torch.trace import get_tracer
    env = {"JAX_COORDINATOR_ADDRESS": "1.2.3.4:999"}
    failpoint.activate("launcher.resolve=error(TimeoutError)")
    try:
        with pytest.raises(TimeoutError, match="launcher.resolve"):
            port.resolve(env)
    finally:
        failpoint.reset()
    tracer = get_tracer()
    seen = []
    real = tracer.start_span

    def spy(name, *a, **k):
        seen.append(name)
        return real(name, *a, **k)
    tracer.start_span = spy
    try:
        port.resolve(env)
    finally:
        del tracer.start_span
    assert seen == ["launcher.resolve_rendezvous"]


def test_initialize_applies_contracts_then_joins_the_group(monkeypatch):
    """The MEGASCALE_* env is exported before the group forms, without
    clobbering explicit user env; the triple becomes
    init_process_group's TCP rendezvous; the backend is explicit."""
    calls = {}

    def fake_init(backend, init_method, world_size, rank):
        calls["args"] = (backend, init_method, world_size, rank)
        calls["env"] = {k: os.environ.get(k) for k in (
            "MEGASCALE_COORDINATOR_ADDRESS", "MEGASCALE_NUM_SLICES",
            "MEGASCALE_SLICE_ID")}

    order = []
    for name in ("acquire_multiprocess_slot", "apply_hbm_limits",
                 "apply_scheduling_priority", "start_health_heartbeat"):
        monkeypatch.setattr(port, name,
                            lambda *a, _n=name, **k: order.append(_n))
    monkeypatch.setattr(dist, "init_process_group", fake_init)
    for k in ("MEGASCALE_COORDINATOR_ADDRESS", "MEGASCALE_NUM_SLICES",
              "MEGASCALE_SLICE_ID"):
        monkeypatch.delenv(k, raising=False)
    info = port.RendezvousInfo("10.0.0.10:8476", 4, 2, num_slices=2,
                               slice_id=1, megascale_coordinator="10.0.0.10")
    info.initialize("gloo")
    assert order == ["acquire_multiprocess_slot", "apply_hbm_limits",
                     "apply_scheduling_priority", "start_health_heartbeat"]
    assert calls["args"] == ("gloo", "tcp://10.0.0.10:8476", 4, 2)
    assert calls["env"] == {"MEGASCALE_COORDINATOR_ADDRESS": "10.0.0.10:8080",
                            "MEGASCALE_NUM_SLICES": "2",
                            "MEGASCALE_SLICE_ID": "1"}
    monkeypatch.setenv("MEGASCALE_COORDINATOR_ADDRESS", "10.7.7.7:9999")
    info.initialize("gloo")
    assert calls["env"]["MEGASCALE_COORDINATOR_ADDRESS"] == "10.7.7.7:9999"
    with pytest.raises(ValueError, match="backend"):
        info.initialize("mpi")


WORKER = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
from tpu_dra_torch.workloads.launcher import resolve
info = resolve()
info.initialize("gloo")
x = torch.ones(4) * (info.process_id + 1)
out = torch.empty(4 * dist.get_world_size())
dist.all_gather_into_tensor(out, x)
print(json.dumps({{"rank": dist.get_rank(), "processes":
                  dist.get_world_size(), "allgather_sum":
                  float(out.sum())}}), flush=True)
dist.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_rendezvous(tmp_path):
    """Two workers resolve the triple from the settings dir (as a channel
    claim's mount gives it) and form one gloo group."""
    with open(tmp_path / "nodes_config.json", "w") as f:
        json.dump({"nodes": [
            {"name": "n0", "ipAddress": "127.0.0.1", "workerID": 0},
            {"name": "n1", "ipAddress": "127.0.0.2", "workerID": 1}]}, f)
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO))
    port_no = free_port()
    procs = []
    for ip in ("127.0.0.1", "127.0.0.2"):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("TPU_", "JAX_", "XLA_"))}
        env.update({"SLICE_DOMAIN_UUID": "uid-1",
                    "SLICE_SETTINGS_DIR": str(tmp_path), "POD_IP": ip,
                    "JAX_COORDINATOR_PORT": str(port_no)})
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WAIT)
            assert p.returncode == 0, out[-2000:]
            outputs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert {o["rank"] for o in outputs} == {0, 1}
    for o in outputs:
        assert o["processes"] == 2
        assert o["allgather_sum"] == 12.0    # 1·4 + 2·4
