"""The port's elastic supervision (tpu_dra_torch/workloads/elastic.py)
against the reference's (tpu_dra/workloads/elastic.py): the workload-side
cases of tests/test_elastic_domain.py (the watcher, the supervisor's
respawn, parking and propagation, the launcher's generation), the same
epochs from both over the same configs, a train process's teardown exit
and the supervisor's downtime recorded into the port's
``GoodputTracker``.  Every wait is bounded far above what the steps
need, so none of these times the machine."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import pytest

from tpu_dra.workloads import elastic as ref
from tpu_dra_torch.workloads import elastic as port
from tpu_dra_torch.workloads import launcher
from tpu_dra_torch.workloads.goodput import STATE_ENV, GoodputTracker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 60.0


def wait_until(pred, timeout: float = WAIT) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def write_config(tmp_path, members, generation=0, traceparent=""):
    data = {"nodes": [
        {"name": name, "ipAddress": ip, "workerID": i, "rank": i}
        for i, (name, ip) in enumerate(members)]}
    if generation:
        data["generation"] = generation
    if traceparent:
        data["traceparent"] = traceparent
    path = os.path.join(tmp_path, "nodes_config.json")
    with open(path + ".tmp", "w") as f:
        json.dump(data, f)
    os.replace(path + ".tmp", path)     # readers never see half a file


def child_env(tmp_path, ip: str) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "JAX_", "SLICE_"))}
    env.update(PYTHONPATH=REPO, SLICE_SETTINGS_DIR=str(tmp_path),
               POD_IP=ip)
    return env


def test_exit_code_contract_is_the_reference_s():
    assert port.EXIT_RECONFIGURED == ref.EXIT_RECONFIGURED == 75


CONFIGS = {
    "legacy": {"nodes": [{"name": "n1", "ipAddress": "10.0.0.11",
                          "workerID": 1},
                         {"name": "n0", "ipAddress": "10.0.0.10",
                          "workerID": 0}]},
    "ranked": {"generation": 4, "traceparent": "00-" + "ab" * 16 + "-"
               + "cd" * 8 + "-01",
               "nodes": [{"name": "b", "ipAddress": "10.0.0.21", "rank": 1},
                         {"name": "a", "ipAddress": "10.0.0.20",
                          "rank": 0}]},
    "bad-generation": {"generation": "x", "nodes": [
        {"ipAddress": "10.0.0.30"}]},
    "empty": {"nodes": []},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_read_epoch_equals_the_reference(tmp_path, name):
    with open(tmp_path / "nodes_config.json", "w") as f:
        json.dump(CONFIGS[name], f)
    env = {"SLICE_SETTINGS_DIR": str(tmp_path),
           "SLICE_COORDINATOR_PORT": "1"}
    want, got = ref.read_epoch(env), port.read_epoch(env)
    assert (got is None) == (want is None)
    if want is not None:
        assert (got.generation, got.members, got.traceparent) == \
            (want.generation, want.members, want.traceparent)


def test_read_epoch_is_none_without_a_config(tmp_path):
    env = {"SLICE_SETTINGS_DIR": str(tmp_path),
           "SLICE_COORDINATOR_PORT": "1"}
    assert port.read_epoch(env) is None is ref.read_epoch(env)


def test_generation_watcher_trips_on_membership_change(tmp_path):
    env = {"SLICE_SETTINGS_DIR": str(tmp_path)}
    write_config(tmp_path, [("n0", "10.0.0.10"), ("n1", "10.0.0.11")],
                 generation=1)
    w = port.GenerationWatcher(env=env, poll_interval=0.05).start()
    try:
        # same members, bumped generation: no restart
        write_config(tmp_path, [("n0", "10.0.0.10"), ("n1", "10.0.0.11")],
                     generation=2)
        assert wait_until(lambda: w.latest.generation == 2)
        assert not w.reconfigured.is_set()
        write_config(tmp_path, [("n0", "10.0.0.10"), ("n2", "10.0.0.12")],
                     generation=3, traceparent="00-" + "ab" * 16 + "-"
                     + "cd" * 8 + "-01")
        assert wait_until(w.reconfigured.is_set)
        assert w.latest.generation == 3
        assert w.latest.traceparent.startswith("00-")
        assert w.baseline.generation == 1
    finally:
        w.stop()
    epoch = port.read_epoch(env)
    assert epoch.generation == 3
    assert ("n2", "10.0.0.12") in epoch.members


def test_run_elastic_respawns_on_reconfiguration(tmp_path):
    """EXIT_RECONFIGURED respawns with the fresh generation and
    traceparent; exit 0 finishes.  The child resolves the new membership
    through the port's launcher: the second generation has two
    processes."""
    write_config(tmp_path, [("n0", "10.0.0.10")], generation=1)
    runs = str(tmp_path / "runs.jsonl")
    child = (
        "import json, os, sys\n"
        "from tpu_dra_torch.workloads.launcher import resolve\n"
        "info = resolve({**os.environ, 'SLICE_DOMAIN_UUID': 'uid-1'})\n"
        f"path = {runs!r}\n"
        "with open(path, 'a') as f:\n"
        "    json.dump({'gen': os.environ.get('TPU_ELASTIC_GENERATION'),"
        " 'tp': os.environ.get('TPU_TRACEPARENT', ''),"
        " 'world': info.num_processes, 'rank_gen': info.generation}, f)\n"
        "    f.write('\\n')\n"
        "runs = sum(1 for _ in open(path))\n"
        f"sys.exit({port.EXIT_RECONFIGURED} if runs == 1 else 0)\n")

    def on_spawn(proc, epoch):
        if epoch.generation == 1:
            # the reconfiguration the child exits for, once it has
            # resolved the first membership
            assert wait_until(lambda: os.path.exists(runs))
            proc.wait(timeout=WAIT)
            write_config(tmp_path, [("n0", "10.0.0.10"),
                                    ("n1", "10.0.0.11")], generation=2,
                         traceparent="00-" + "12" * 16 + "-" + "34" * 8
                         + "-01")

    rc = port.run_elastic([sys.executable, "-c", child],
                          env=child_env(tmp_path, "10.0.0.10"), poll=0.05,
                          member_timeout=WAIT, on_spawn=on_spawn)
    assert rc == 0
    lines = [json.loads(line) for line in open(runs)]
    assert [r["gen"] for r in lines] == ["1", "2"]
    assert [r["world"] for r in lines] == [1, 2]
    assert [r["rank_gen"] for r in lines] == [1, 2]
    assert lines[1]["tp"].startswith("00-12")


def test_run_elastic_parks_until_member(tmp_path):
    """A spare node's supervisor blocks until promotion puts its IP into
    the active config."""
    write_config(tmp_path, [("n0", "10.0.0.10")], generation=1)
    done = str(tmp_path / "ran")
    child = f"open({done!r}, 'w').close()"
    spawned = threading.Event()
    result = {}

    def supervise():
        result["rc"] = port.run_elastic(
            [sys.executable, "-c", child],
            env=child_env(tmp_path, "10.0.0.11"), poll=0.05,
            member_timeout=WAIT,
            on_spawn=lambda proc, epoch: spawned.set())

    t = threading.Thread(target=supervise)
    t.start()
    time.sleep(0.4)
    assert not spawned.is_set()     # parked: not a member yet
    write_config(tmp_path, [("n0", "10.0.0.10"), ("n1", "10.0.0.11")],
                 generation=2)
    t.join(timeout=WAIT)
    assert not t.is_alive() and result["rc"] == 0
    assert os.path.exists(done)


def test_run_elastic_stops_while_parked(tmp_path):
    write_config(tmp_path, [("n0", "10.0.0.10")], generation=1)
    stop = threading.Event()
    stop.set()
    rc = port.run_elastic([sys.executable, "-c", "pass"],
                          env=child_env(tmp_path, "10.0.0.99"), poll=0.05,
                          member_timeout=WAIT, stop=stop)
    assert rc == 130


def test_run_elastic_propagates_real_failures(tmp_path):
    write_config(tmp_path, [("n0", "10.0.0.10")], generation=1)
    rc = port.run_elastic(
        [sys.executable, "-c", "import sys; sys.exit(7)"],
        env=child_env(tmp_path, "10.0.0.10"), poll=0.05,
        member_timeout=WAIT, reconfigure_grace=0.3)
    assert rc == 7


def test_wait_until_member_times_out(tmp_path):
    write_config(tmp_path, [("n0", "10.0.0.10")], generation=1)
    with pytest.raises(TimeoutError, match="10.0.0.99"):
        port.wait_until_member(child_env(tmp_path, "10.0.0.99"), poll=0.05,
                               timeout=0.2)


def test_launcher_resolves_generation(tmp_path):
    write_config(tmp_path, [("n0", "10.0.0.10"), ("n1", "10.0.0.11")],
                 generation=5)
    info = launcher.resolve({"SLICE_DOMAIN_UUID": "uid-1",
                             "SLICE_SETTINGS_DIR": str(tmp_path),
                             "POD_IP": "10.0.0.11"})
    assert info.generation == 5
    assert info.process_id == 1


def test_exit_for_reconfiguration_tears_the_group_down(tmp_path):
    """A train process in a one-rank gloo group exits 75 through the
    bounded teardown, and the group is gone by then."""
    child = (
        "import atexit, sys, torch.distributed as dist\n"
        "from tpu_dra_torch.workloads.elastic import "
        "exit_for_reconfiguration\n"
        f"dist.init_process_group('gloo', init_method='file://"
        f"{tmp_path}/store', world_size=1, rank=0)\n"
        "atexit.register(lambda: print('initialized after:', "
        "dist.is_initialized(), flush=True))\n"
        "exit_for_reconfiguration()\n")
    out = subprocess.run([sys.executable, "-c", child],
                         env=child_env(tmp_path, "10.0.0.10"),
                         capture_output=True, text=True, timeout=WAIT)
    assert out.returncode == port.EXIT_RECONFIGURED, out.stderr[-2000:]
    assert "initialized after: False" in out.stdout


def test_downtime_lands_in_the_goodput_tracker(tmp_path):
    """The supervisor records the worker-exit to respawn interval as
    reconfiguration downtime, stamped with the new config's traceparent
    and generation, and hands the ledger's path to the worker."""
    write_config(tmp_path, [("n0", "10.0.0.10")], generation=1)
    state = str(tmp_path / "goodput.json")
    tracker = GoodputTracker(state_path=state)
    seen = str(tmp_path / "state_env")
    child = (
        "import os, sys\n"
        f"open({seen!r}, 'a').write(os.environ.get({STATE_ENV!r}, '') "
        "+ '\\n')\n"
        f"sys.exit({port.EXIT_RECONFIGURED} if os.environ["
        "'TPU_ELASTIC_GENERATION'] == '1' else 0)\n")

    def on_spawn(proc, epoch):
        if epoch.generation == 1:
            proc.wait()
            time.sleep(0.2)             # downtime the tracker must see
            write_config(tmp_path, [("n0", "10.0.0.10"),
                                    ("n1", "10.0.0.11")], generation=2,
                         traceparent="00-" + "56" * 16 + "-" + "78" * 8
                         + "-01")

    rc = port.run_elastic([sys.executable, "-c", child],
                          env=child_env(tmp_path, "10.0.0.10"), poll=0.05,
                          member_timeout=WAIT, on_spawn=on_spawn,
                          goodput_tracker=tracker)
    assert rc == 0
    assert open(seen).read().split() == [state, state]
    (record,) = tracker.reconfigurations()
    assert record["generation"] == 2
    assert record["traceparent"].startswith("00-5656")
    assert record["duration_s"] >= 0
    assert tracker.totals()["reconfiguration"] == pytest.approx(
        record["duration_s"], abs=1e-4)
    assert json.load(open(state))["reconfigurations"] == [record]
