"""The port's workload start-up contracts (tpu_dra_torch/workloads/
launcher.py) on the CPU, against the reference's launcher and the
driver-injected shim: the memory budget, the process-slot gate (in
subprocesses, so no test worker keeps a slot), the shim's slot marker
both ways, the priority, the heartbeat and the OOM sentinel, and
``init_tpu_workload`` on the environment the tenancy plugin writes."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from tpu_dra.api.configs import TpuSharedConfig
from tpu_dra.plugins.tpu import _shim_sitecustomize as shim
from tpu_dra.plugins.tpu.tenancy import tenant_edits
from tpu_dra.tpulib import FakeTpuLib
from tpu_dra.workloads import launcher as jl
from tpu_dra_torch.workloads import launcher as tl

ROOT = Path(__file__).resolve().parent.parent
GIB = 1 << 30
WAIT = 60

# the budget cases of tests/test_workloads.py and tests/test_shim.py that
# carry no libtpu flag of the user's (the port has no libtpu to defer to)
HBM_CASES = {
    "scoped tightest": {"TPU_HBM_LIMIT_BYTES_0": str(4 * GIB),
                        "TPU_HBM_LIMIT_BYTES_1": str(2 * GIB),
                        "TPU_VISIBLE_CHIPS": "0,1"},
    "scoped one": {"TPU_HBM_LIMIT_BYTES_0": str(4 * GIB),
                   "TPU_HBM_LIMIT_BYTES_1": str(2 * GIB),
                   "TPU_VISIBLE_CHIPS": "0"},
    "no budget": {"TPU_VISIBLE_CHIPS": "0"},
    "path-form entries": {"TPU_HBM_LIMIT_BYTES_0": str(GIB),
                          "TPU_VISIBLE_DEVICES": "/dev/accel0"},
    "unscoped one": {"TPU_HBM_LIMIT_BYTES_0": str(2 * GIB)},
    "unscoped tightest": {"TPU_HBM_LIMIT_BYTES_0": str(2 * GIB),
                          "TPU_HBM_LIMIT_BYTES_1": str(4 * GIB)},
    "scoped to chip 1": {"TPU_HBM_LIMIT_BYTES_0": str(2 * GIB),
                         "TPU_HBM_LIMIT_BYTES_1": str(4 * GIB),
                         "TPU_VISIBLE_CHIPS": "1"},
    "other flags": {"TPU_HBM_LIMIT_BYTES_0": str(2 * GIB),
                    "LIBTPU_INIT_ARGS": "--xla_flag=1"},
    "no match": {"TPU_HBM_LIMIT_BYTES_3": str(GIB),
                 "TPU_VISIBLE_CHIPS": "0"},
}


@pytest.mark.parametrize("case", sorted(HBM_CASES))
def test_hbm_budget_equals_the_reference(case):
    env = HBM_CASES[case]
    want = jl.apply_hbm_limits(dict(env), setenv=False)
    mine = dict(env)
    assert tl.apply_hbm_limits(mine, install=False) == want
    # installing needs CUDA: without it the same bytes and nothing else
    assert tl.apply_hbm_limits(mine) == want
    assert tl.apply_hbm_limits(mine, device="cpu") == want
    assert mine == env


def test_hbm_budget_malformed_and_user_flag():
    with pytest.raises(RuntimeError, match="malformed HBM limit"):
        tl.apply_hbm_limits({"TPU_HBM_LIMIT_BYTES_0": "lots"})
    with pytest.raises(RuntimeError, match="malformed HBM limit"):
        jl.apply_hbm_limits({"TPU_HBM_LIMIT_BYTES_0": "lots"}, setenv=False)
    # a libtpu bound of the user's is the reference's to honour; the
    # port's budget stands (ROADMAP.md section 3)
    env = {"TPU_HBM_LIMIT_BYTES_0": str(GIB),
           "LIBTPU_INIT_ARGS": "--xla_tpu_max_hbm_size_mib=512"}
    assert jl.apply_hbm_limits(dict(env), setenv=False) is None
    assert tl.apply_hbm_limits(dict(env), install=False) == GIB


def tenant_env(tmp_path: Path, weight: int) -> dict:
    """The environment tenancy.tenant_edits writes for a tenant of two
    partitions of chip 0, with its chip visible and a heartbeat mount."""
    chip = FakeTpuLib().enumerate_chips()[0]
    parts = chip.partitions(4)
    edits = tenant_edits(TpuSharedConfig(weight=weight), parts[:2],
                         {chip.uuid: chip}, "uid-t1",
                         slots_root=str(tmp_path / "slots"))
    beats = tmp_path / "heartbeats"
    (beats / "uid-t1").mkdir(parents=True)
    return dict(edits.env, TPU_VISIBLE_CHIPS=str(chip.minor),
                TPU_HEALTH_HEARTBEAT_DIR=str(beats))


@pytest.mark.parametrize("weight", [30, 10, 5])
def test_dry_run_on_the_tenancy_environment(tmp_path, weight):
    """``init_tpu_workload(dry_run=True)`` gives the reference's budget,
    niceness and beat paths for the tenant's environment, and changes
    nothing: no slot, no CUDA, no renice, no heartbeat, no span."""
    env = tenant_env(tmp_path, weight)
    want = jl.init_tpu_workload(dict(env), dry_run=True)
    before = dict(env)
    got = tl.init_tpu_workload(env, dry_run=True)
    assert env == before
    for key in ("slot", "hbm_limit_bytes", "nice", "heartbeat"):
        assert got[key] == want[key], key
    assert got["hbm_limit_bytes"] == int(env["TPU_HBM_LIMIT_BYTES_0"])
    assert got["nice"] == {30: -5, 10: None, 5: 10}[weight]
    assert tl._HEARTBEAT_THREAD is None and not tl._PRIORITY_APPLIED
    assert not tl._HELD_SLOTS and not tl._ACQUIRED_POOLS
    assert not os.listdir(tmp_path / "heartbeats" / "uid-t1")


# --------------------------------------------------------------------------
# The slot gate, in processes of their own
# --------------------------------------------------------------------------

HOLD = textwrap.dedent("""
    import json, sys
    from tpu_dra_torch.workloads import launcher
    env = {"TPU_MULTIPROCESS_SLOT_DIR": sys.argv[1]}
    try:
        got = launcher.acquire_multiprocess_slot(env)
    except RuntimeError as exc:
        print("REFUSED", exc, flush=True)
        sys.exit(3)
    again = launcher.acquire_multiprocess_slot(env)
    print("HELD", json.dumps([got, again, len(launcher._HELD_SLOTS)]),
          flush=True)
    sys.stdin.readline()
""")


def spawn(pool: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", HOLD, str(pool)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def first_line(proc) -> str:
    return proc.stdout.readline().strip()


def pool_of(tmp_path: Path, max_procs: int) -> Path:
    pool = tmp_path / "pool"
    pool.mkdir()
    (pool / "max").write_text(str(max_procs))
    return pool


def test_slot_gate_refuses_past_max_and_reentry_takes_one(tmp_path):
    pool = pool_of(tmp_path, 1)
    holder = spawn(pool)
    try:
        line = first_line(holder)
        assert line.startswith("HELD"), line
        got, again, fds = json.loads(line.split(" ", 1)[1])
        assert got == again == {"": 0} and fds == 1   # re-entry: one slot
        second = spawn(pool)
        out, _ = second.communicate(timeout=WAIT)
        assert second.returncode == 3
        assert "refusing to oversubscribe" in out and "maxProcesses=1" in out
    finally:
        holder.kill()
        holder.communicate(timeout=WAIT)


def test_crashed_holder_frees_its_slot(tmp_path):
    pool = pool_of(tmp_path, 1)
    holder = spawn(pool)
    assert first_line(holder).startswith("HELD")
    holder.send_signal(signal.SIGKILL)
    holder.communicate(timeout=WAIT)
    after = spawn(pool)
    try:
        line = first_line(after)
        assert line.startswith("HELD"), line
        # the crashed holder's pid stamp was replaced by the new one's
        assert (pool / "slot-0.lock").read_text().strip() == str(after.pid)
    finally:
        after.kill()
        after.communicate(timeout=WAIT)


MARKERS = textwrap.dedent("""
    import json, os, sys
    from tpu_dra.plugins.tpu import _shim_sitecustomize as shim
    from tpu_dra_torch.workloads import launcher
    a, b = sys.argv[1], sys.argv[2]
    # the port takes a slot of pool a: the shim's parser sees it
    env = {"TPU_MULTIPROCESS_SLOT_DIR": a}
    port_slot = launcher.acquire_multiprocess_slot(env)
    shim_sees = shim._parse_marker(env)
    # the shim takes a slot of pool b: the port re-enters it, no second
    env2 = {"TPU_MULTIPROCESS_SLOT_DIR": b}
    shim.acquire_slots(env2)
    fds = len(launcher._HELD_SLOTS)
    port_sees = launcher._parse_marker(env2)
    again = launcher.acquire_multiprocess_slot(env2)
    print(json.dumps({"port_slot": port_slot, "shim_sees": shim_sees,
                      "port_sees": port_sees, "again": again,
                      "new_fds": len(launcher._HELD_SLOTS) - fds,
                      "marker": env["TPU_DRA_SLOTS_HELD"]}))
""")


def test_slot_marker_crosses_between_port_and_shim(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    for pool in (a, b):
        pool.mkdir()
        (pool / "max").write_text("2")
    out = subprocess.run(
        [sys.executable, "-c", MARKERS, str(a), str(b)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=WAIT)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["port_slot"] == {"": 0}
    assert got["shim_sees"] == {os.path.realpath(a): 0}
    assert got["port_sees"] == {os.path.realpath(b): 0}
    assert got["again"] == {"": 0} and got["new_fds"] == 0
    assert got["marker"].startswith("pid=")


INIT = textwrap.dedent("""
    import json
    from tpu_dra_torch.trace import tracer
    from tpu_dra_torch.workloads import launcher
    applied = launcher.init_tpu_workload()
    span = [s for s in tracer.DEFAULT_RING.spans()
            if s["name"] == "launcher.init_tpu_workload"][-1]
    print(json.dumps({"applied": applied, "attrs": span["attributes"],
                      "parent": span["parent_id"]}), flush=True)
""")


def test_init_applies_every_contract_in_a_process(tmp_path):
    """The full start-up in a process of its own, on the tenancy plugin's
    environment with its slot pool mounted and a heartbeat file: one
    slot, the budget, the niceness, the beat (unlinked at exit), the
    span's attributes under the placing span."""
    env = tenant_env(tmp_path, 5)
    pools = tmp_path / "slots" / "mp-slots"
    beat = tmp_path / "beat"
    env.update(TPU_MULTIPROCESS_SLOT_DIR=str(pools),
               TPU_HEALTH_HEARTBEAT_FILE=str(beat),
               TPU_TRACEPARENT=f"00-{'ab' * 16}-{'cd' * 8}-01",
               PYTHONPATH=str(ROOT), PATH=os.environ.get("PATH", ""))
    out = subprocess.run([sys.executable, "-c", INIT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=WAIT)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    (group,) = os.listdir(pools)
    assert got["applied"] == {
        "slot": {group: 0},
        "hbm_limit_bytes": int(env["TPU_HBM_LIMIT_BYTES_0"]),
        "nice": 10, "heartbeat": [str(beat)], "goodput": False}
    assert got["attrs"] == {"slot": True, "hbm_limited": True,
                            "goodput": False}
    assert got["parent"] == "cd" * 8
    assert not beat.exists()             # unlinked at interpreter exit


# --------------------------------------------------------------------------
# Heartbeat and OOM sentinel
# --------------------------------------------------------------------------


def test_heartbeat_touches_then_unlinks(tmp_path):
    beat = tmp_path / "claims" / "beat"
    env = {"TPU_HEALTH_HEARTBEAT_FILE": str(beat)}
    try:
        assert tl.start_health_heartbeat(env, interval=0.05) == [str(beat)]
        assert beat.exists()
        # a second start is a no-op that reports the running beat
        assert tl.start_health_heartbeat(env, interval=9) == [str(beat)]
        os.utime(beat, (0, 0))
        deadline = time.monotonic() + WAIT
        while beat.stat().st_mtime == 0:
            assert time.monotonic() < deadline, "the heartbeat never beat"
            time.sleep(0.02)
    finally:
        tl.stop_health_heartbeat()
    assert not beat.exists() and tl._HEARTBEAT_THREAD is None
    assert tl.start_health_heartbeat({}) is None


def test_report_hbm_oom_writes_the_sentinel_beside_each_beat(tmp_path):
    written = {}
    for name, mod in (("port", tl), ("reference", jl)):
        base = tmp_path / name
        for claim in ("uid-a", "uid-b"):
            (base / claim).mkdir(parents=True)
        env = {"TPU_HEALTH_HEARTBEAT_DIR": str(base)}
        paths = mod.report_hbm_oom(env, detail="over budget")
        written[name] = [os.path.relpath(p, base) for p in paths]
        assert all(Path(p).read_text() == "over budget" for p in paths)
    assert written["port"] == written["reference"] == ["uid-a/oom",
                                                       "uid-b/oom"]
    assert tl.report_hbm_oom({}) == []
    # an unwritable beat directory is advisory: nothing written, no raise
    assert tl.report_hbm_oom({"TPU_HEALTH_HEARTBEAT_FILE":
                              "/proc/no/such/beat"}) == []


def test_priority_applies_once(monkeypatch):
    calls = []
    monkeypatch.setattr(tl.os, "nice", lambda d: calls.append(d) or 0)
    monkeypatch.setattr(tl, "_PRIORITY_APPLIED", False)
    assert tl.apply_scheduling_priority({"TPU_PROCESS_PRIORITY": "Low"}) == 10
    assert tl.apply_scheduling_priority(
        {"TPU_PROCESS_PRIORITY": "Low"}) is None
    monkeypatch.setattr(tl, "_PRIORITY_APPLIED", False)
    assert tl.apply_scheduling_priority(
        {"TPU_PROCESS_PRIORITY": "Normal"}) is None
    assert tl.apply_scheduling_priority(
        {"TPU_PROCESS_PRIORITY": "bogus"}) is None

    def eperm(_):
        raise OSError("EPERM")
    monkeypatch.setattr(tl.os, "nice", eperm)
    assert tl.apply_scheduling_priority(
        {"TPU_PROCESS_PRIORITY": "High"}) is None
    assert calls == [10]


@pytest.mark.parametrize("case", ["exit", "timeout"])
def test_run_local_group_fails_with_every_rank_s_output(case):
    """A rank that exits non-zero, or a group that outlives its timeout,
    ends the other ranks and raises with each rank's output tail; a
    clean group returns each rank's output in rank order, each rank
    seeing its own triple."""
    from tpu_dra_torch.workloads.launcher import run_local_group
    ok = run_local_group([sys.executable, "-c", "import os; print("
                          "os.environ['JAX_PROCESS_ID'], "
                          "os.environ['JAX_NUM_PROCESSES'])"], 2, timeout=60)
    assert [o.split() for o in ok] == [["0", "2"], ["1", "2"]]
    body = ("import os, sys, time; r = int(os.environ['JAX_PROCESS_ID']); "
            "print('rank', r, flush=True); ")
    body += ("sys.exit(3 if r else 0)" if case == "exit" else
             "time.sleep(0 if r else 300)")
    with pytest.raises(RuntimeError) as err:
        run_local_group([sys.executable, "-c", body], 2,
                        timeout=60 if case == "exit" else 5)
    said = str(err.value)
    assert ("rank 1 exited 3" if case == "exit" else "outlived 5") in said
    assert "rank 0" in said and "rank 1" in said
