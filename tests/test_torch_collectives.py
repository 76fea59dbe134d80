"""The bandwidth half of the port's collectives
(tpu_dra_torch/workloads/collectives.py) and its acceptance job
(workloads/psum_job.py), on the CPU: two gloo processes run the four
bandwidth functions (each collective's values checked in the same
processes), ``psum_job`` as two processes through a settings dir and
alone with ``--local-only``, the reference's timing method of
``_time_op`` and its ``CollectiveResult``, ``matmul_throughput`` and
``section_collectives`` in a group of one and in two processes (the
fused collective-matmul comparison on the CPU's plain versions)."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from tpu_dra.workloads import collectives as ref
from tpu_dra_torch import bench
from tpu_dra_torch.workloads import collectives as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 180


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def clean_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "JAX_", "XLA_", "SLICE_"))}
    env["PYTHONPATH"] = REPO
    env.update(extra)
    return env


def run_pair(argvs: list, envs: list) -> list:
    procs = [subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=REPO)
             for argv, env in zip(argvs, envs)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WAIT)
            assert p.returncode == 0, out[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


WORKER = """
import json, sys
import torch
import torch.distributed as dist
from tpu_dra_torch.workloads import collectives as c
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
# the collectives the functions time, on values that show a wrong peer
x = torch.full((4,), float(rank + 1), dtype=torch.bfloat16)
s = x.clone(); dist.all_reduce(s)
g = torch.empty(8, dtype=torch.bfloat16); dist.all_gather_into_tensor(g, x)
r = torch.empty(2, dtype=torch.bfloat16)
dist.reduce_scatter_tensor(r, torch.arange(4, dtype=torch.bfloat16) + rank)
got = torch.empty_like(x)
ops = [dist.P2POp(dist.isend, x, (rank + 1) % 2),
       dist.P2POp(dist.irecv, got, (rank - 1) % 2)]
for w in dist.batch_isend_irecv(ops):
    w.wait()
results = {}
for fn in (c.psum_bandwidth, c.ppermute_bandwidth, c.all_gather_bandwidth,
           c.reduce_scatter_bandwidth):
    res = fn(mib_per_device=1, iters=2)
    results[res.name] = [res.n_devices, res.buffer_bytes,
                         res.seconds_per_op, res.algo_bytes_per_s]
auto = c.psum_bandwidth(mib_per_device=1)      # iters sized by the budget
print(json.dumps({"rank": rank, "device": str(c.group_device()),
                  "sum": s.tolist(), "gather": g.tolist(),
                  "scatter": r.tolist(), "shift": got.tolist(),
                  "results": results,
                  "auto": [auto.n_devices, auto.seconds_per_op]}),
      flush=True)
dist.destroy_process_group()
"""


def test_two_gloo_processes_run_the_four_bandwidths(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    p = str(free_port())
    outs = run_pair([[sys.executable, str(script), str(r), p]
                     for r in (0, 1)], [clean_env(), clean_env()])
    mib = 1024 * 1024
    for o in sorted(outs, key=lambda o: o["rank"]):
        rank = o["rank"]
        assert o["device"] == "cpu"
        assert o["sum"] == [3.0] * 4
        assert o["gather"] == [1.0] * 4 + [2.0] * 4
        # [0, 1, 2, 3] + [1, 2, 3, 4], cut in two
        assert o["scatter"] == ([1.0, 3.0] if rank == 0 else [5.0, 7.0])
        assert o["shift"] == [float(2 - rank)] * 4   # from the other rank
        res = o["results"]
        assert set(res) == {"psum", "ppermute", "all_gather",
                            "reduce_scatter"}
        for name, (n, nbytes, secs, algo) in res.items():
            assert n == 2 and nbytes == mib and secs > 0, name
        # algorithmic volumes, as the reference counts them (n = 2)
        for name, factor in (("psum", 2 * (2 - 1) / 2), ("ppermute", 1.0),
                             ("all_gather", 1.0),
                             ("reduce_scatter", (2 - 1) / 2)):
            n, nbytes, secs, algo = res[name]
            assert algo == pytest.approx(factor * nbytes / secs)
        assert o["auto"][0] == 2 and o["auto"][1] > 0


SECTION_WORKER = """
import functools, json, sys
import torch
import torch.distributed as dist
from tpu_dra_torch import bench
from tpu_dra_torch.workloads import collectives as c
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
bench.resolve_device = lambda device=None: torch.device("cpu")
for name in ("psum_bandwidth", "ppermute_bandwidth", "all_gather_bandwidth",
             "reduce_scatter_bandwidth"):
    setattr(c, name, functools.partial(getattr(c, name), mib_per_device=1,
                                       iters=2))
print(json.dumps(bench.section_collectives()), flush=True)
dist.destroy_process_group()
"""


def test_section_collectives_compares_the_fused_ring_in_two_processes(
        tmp_path):
    """Two gloo processes: the four bandwidths, then the ring kernels'
    group plain versions against the unfused pair on the CPU's (64, 128,
    128) a rank, under the reference's keys and with no
    ``collective_matmul_error``."""
    script = tmp_path / "section.py"
    script.write_text(SECTION_WORKER)
    p = str(free_port())
    outs = run_pair([[sys.executable, str(script), str(r), p]
                     for r in (0, 1)], [clean_env(), clean_env()])
    for o in outs:
        assert "collective_matmul_error" not in o, o
        for name in ("ag_matmul", "matmul_rs"):
            for key in ("fused_tflops", "xla_tflops"):
                assert o[f"{name}_{key}"] > 0, (name, key)
            assert isinstance(o[f"{name}_overlap_win_pct"], float)
        assert o["collective_matmul_shape"] == [64, 128, 128]
        assert o["collective_matmul_device"] == "cpu"
        assert o["collectives_devices"] == 2 and o["psum_gbps"] > 0


def psum_job(extra: list) -> list:
    return [sys.executable, "-m", "tpu_dra_torch.workloads.psum_job",
            "--mib", "1", *extra]


def test_psum_job_two_processes_through_a_settings_dir(tmp_path):
    with open(tmp_path / "nodes_config.json", "w") as f:
        json.dump({"nodes": [
            {"name": "n0", "ipAddress": "127.0.0.1", "workerID": 0},
            {"name": "n1", "ipAddress": "127.0.0.2", "workerID": 1}]}, f)
    p = str(free_port())
    envs = [clean_env(SLICE_DOMAIN_UUID="uid-1",
                      SLICE_SETTINGS_DIR=str(tmp_path), POD_IP=ip,
                      JAX_COORDINATOR_PORT=p)
            for ip in ("127.0.0.1", "127.0.0.2")]
    outs = run_pair([psum_job(["--backend", "gloo"]) for _ in envs],
                    envs)
    for o in outs:
        assert o["n_devices"] == 2
        assert o["allreduce_sum"] == 3.0
        for key in ("psum_gbps", "ppermute_gbps", "all_gather_gbps",
                    "reduce_scatter_gbps"):
            assert o[key] > 0, key


def test_psum_job_local_only_is_one_device(tmp_path):
    env = clean_env(SLICE_DOMAIN_UUID="uid-1",
                    SLICE_SETTINGS_DIR=str(tmp_path / "absent"))
    out = subprocess.run(psum_job(["--local-only"]), env=env,
                         capture_output=True, text=True, timeout=WAIT,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "n_devices": 1, "allreduce_sum": 1.0}


def test_psum_job_refuses_an_unknown_backend():
    from tpu_dra_torch.workloads import psum_job as job
    with pytest.raises(SystemExit):
        job.main(["--backend", "mpi"])


def test_time_op_differences_an_iters_run_against_twice_as_many():
    """The reference's method: the constant cost of a run (dispatch,
    readback) cancels in the difference, so a fixed overhead never reads
    as op time."""
    calls = []

    def op(a):
        calls.append(1)
        return a + 1

    x = torch.zeros(4)
    secs = port._time_op(op, x, iters=3)
    assert secs > 0
    # warm runs of 3 and 6, then best of 5 of each
    assert len(calls) == 3 + 6 + 5 * 3 + 5 * 6
    calls.clear()
    port._time_op(op, x, budget_s=1e-9)          # sized: clamp to 3
    assert len(calls) == 1 + 1 + 3 + 6 + 5 * 3 + 5 * 6


def test_collective_result_is_the_reference_s():
    import dataclasses
    assert [f.name for f in dataclasses.fields(port.CollectiveResult)] == \
        [f.name for f in dataclasses.fields(ref.CollectiveResult)]


def test_matmul_throughput_on_the_cpu():
    assert port.matmul_throughput(64, iters=2, device="cpu") > 0


def test_section_collectives_skips_a_single_device(monkeypatch):
    monkeypatch.setattr(bench, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    assert bench.section_collectives() == {
        "collectives_skipped": "single device"}
    assert bench.SECTIONS["collectives"] is bench.section_collectives
    assert list(bench.SECTIONS)[-1] == "collectives"
