"""The port's goodput accounting (tpu_dra_torch/workloads/goodput.py)
against the reference's (tpu_dra/workloads/goodput.py): the same segment
script under one fake clock gives equal totals and reports, each package
loads the other's state file, and the hooks of the port's ``fit`` and
``checkpointing`` accrue ``compile`` once a run, ``step`` for every later
step, ``checkpoint_save`` for each save and ``restore`` for each restore,
only once a tracker is started.  The launcher's start-up opens its span
on ``TPU_TRACEPARENT`` and starts the tracker from ``TPU_GOODPUT_FILE``."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from tpu_dra.util.metrics import Registry as JaxRegistry
from tpu_dra.workloads import goodput as jg
from tpu_dra_torch.trace import tracer as ttracer
from tpu_dra_torch.util.metrics import Registry
from tpu_dra_torch.workloads import goodput as tg
from tpu_dra_torch.workloads.checkpointing import (
    restore_train_state,
    save_train_state,
)
from tpu_dra_torch.workloads.fit import fit
from tpu_dra_torch.workloads.launcher import init_tpu_workload
from tpu_dra_torch.workloads.train import ModelConfig

TRACEPARENT = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"


class FakeClock:
    """``time.monotonic`` and ``time.time`` that move only when told."""

    def __init__(self, monkeypatch):
        self.now = 1000.0
        monkeypatch.setattr(time, "monotonic", lambda: self.now)
        monkeypatch.setattr(time, "time", lambda: self.now + 1.7e9)

    def sleep(self, dt: float) -> None:
        self.now += dt


def script(mod, registry, clock, path) -> dict:
    """One run of segments, blocked gaps, a nested save and a recorded
    downtime; returns (totals, report, ratio, exposition)."""
    t = mod.GoodputTracker(registry=registry, state_path=path,
                           flush_interval_s=0.0).start()
    with t.measure(mod.SEG_COMPILE):
        clock.sleep(2.5)
    for _ in range(3):
        with t.measure(mod.SEG_STEP):
            clock.sleep(0.75)
            with t.measure(mod.SEG_CHECKPOINT_SAVE):
                clock.sleep(0.125)
        clock.sleep(0.0625)                          # blocked
    with t.measure(mod.SEG_RESTORE):
        clock.sleep(1.5)
    t.record_downtime(4.0, traceparent=TRACEPARENT, generation=2)
    clock.sleep(0.5)
    t.stop()
    return {"totals": t.totals(), "report": t.report(), "ratio": t.ratio(),
            "text": registry.expose()}


def test_same_script_gives_equal_totals_and_report(monkeypatch, tmp_path):
    clock = FakeClock(monkeypatch)
    want = script(jg, JaxRegistry(), clock, str(tmp_path / "j.json"))
    clock.now = 1000.0
    got = script(tg, Registry(), clock, str(tmp_path / "t.json"))
    assert got["totals"] == want["totals"]
    assert got["report"] == want["report"]
    assert got["ratio"] == want["ratio"]
    assert got["text"] == want["text"]
    assert got["report"]["schema"] == "tpu-goodput/v1"
    assert set(got["totals"]) == set(tg.SEGMENTS)
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()


@pytest.mark.parametrize("writer,reader", [(jg, tg), (tg, jg)],
                         ids=["reference-to-port", "port-to-reference"])
def test_each_package_loads_the_others_state_file(tmp_path, writer, reader):
    path = str(tmp_path / "g.json")
    reg = JaxRegistry() if writer is jg else Registry()
    w = writer.GoodputTracker(registry=reg, state_path=path).start()
    with w.measure(writer.SEG_STEP):
        time.sleep(0.02)
    w.record_downtime(1.5, traceparent=TRACEPARENT)
    w.stop()
    reg = JaxRegistry() if reader is jg else Registry()
    r = reader.GoodputTracker(registry=reg, state_path=path).start()
    assert r.totals() == pytest.approx(w.totals(), abs=1e-5)
    assert r.reconfigurations() == w.reconfigurations()
    before = w.totals()["step"]
    with r.measure(reader.SEG_STEP):
        time.sleep(0.02)
    r.stop()
    state = json.loads((tmp_path / "g.json").read_text())
    assert state["schema"] == "tpu-goodput/v1"
    assert state["totals"]["step"] > before


def test_never_started_measure_is_the_shared_noop():
    t = tg.GoodputTracker(registry=Registry())
    assert t.measure(tg.SEG_STEP) is t.measure(tg.SEG_RESTORE) is \
        tg._NOOP_MEASURE
    with t.measure(tg.SEG_STEP):
        pass
    assert t.totals() == {} and t.ratio() == 0.0
    with pytest.raises(ValueError, match="unknown goodput segment"):
        tg.GoodputTracker(registry=Registry()).start().measure("coffee")


def test_record_downtime_exemplar_and_span(tmp_path):
    reg = Registry()
    t = tg.GoodputTracker(registry=reg,
                          state_path=str(tmp_path / "g.json")).start()
    t.record_downtime(2.5, traceparent=TRACEPARENT, generation=3)
    assert f'trace_id="{"ab" * 16}"' in reg.expose(openmetrics=True)
    assert any(s["name"] == "goodput.reconfiguration_downtime"
               for s in ttracer.DEFAULT_RING.spans(trace_id="ab" * 16))


CFG = ModelConfig(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                  max_seq=16)


@pytest.fixture()
def tracker(monkeypatch, tmp_path):
    """A started default tracker of its own, every segment entry
    recorded."""
    t = tg.GoodputTracker(registry=Registry(),
                          state_path=str(tmp_path / "goodput.json"))
    monkeypatch.setattr(tg, "_DEFAULT", t)
    entered: list[str] = []
    enter = t._enter
    monkeypatch.setattr(t, "_enter", lambda seg: (entered.append(seg),
                                                  enter(seg)))
    t.entered = entered
    return t


@pytest.fixture()
def data(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, CFG.vocab, 4096).astype(
        np.uint16).tofile(path)
    return str(path)


def test_fit_and_checkpoints_accrue_their_segments(tracker, data, tmp_path):
    """A run of 4 steps saving every 2 and a resumed run of 2: compile
    once a run, step for the other steps, checkpoint_save for each of the
    3 saves, restore for the one restore; the losses are the same with
    the tracker on."""
    ck = str(tmp_path / "ck")
    kw = dict(batch=2, log_every=1, checkpoint_dir=ck, checkpoint_every=2,
              device="cpu", log_fn=lambda _: None)
    tracker.start()
    first = fit(CFG, data, steps=4, **kw)
    second = fit(CFG, data, steps=2, resume=True, **kw)
    assert tracker.entered == (
        ["compile", "step", "checkpoint_save", "step", "step",
         "checkpoint_save"]
        + ["restore", "compile", "step", "checkpoint_save"])
    totals = tracker.totals()
    assert set(totals) >= {"compile", "step", "checkpoint_save", "restore",
                           "blocked"}
    assert sum(totals.values()) > 0
    assert second.step == 6 and len(first.losses) == 4


def test_fit_without_a_tracker_is_unchanged(data, tmp_path, monkeypatch):
    """The hooks of a process that never opted in are the no-op: nothing
    accrues, and the losses equal a tracked run's."""
    kw = dict(steps=3, batch=2, log_every=1, device="cpu",
              log_fn=lambda _: None)
    fresh = tg.GoodputTracker(registry=Registry())
    monkeypatch.setattr(tg, "_DEFAULT", fresh)
    plain = fit(CFG, data, **kw)
    assert not fresh.started and fresh.totals() == {}
    tracked = tg.GoodputTracker(registry=Registry()).start()
    monkeypatch.setattr(tg, "_DEFAULT", tracked)
    assert fit(CFG, data, **kw).losses == plain.losses
    assert tracked.totals()["step"] > 0


def test_save_and_restore_accrue_when_started(tracker, tmp_path):
    params = {"w": torch.ones(4)}
    save_train_state(str(tmp_path / "c"), 1, params)
    restore_train_state(str(tmp_path / "c"), device="cpu")
    assert tracker.entered == []                  # not started: no-op
    tracker.start()
    save_train_state(str(tmp_path / "c"), 2, params)
    restore_train_state(str(tmp_path / "c"), device="cpu")
    assert tracker.entered == ["checkpoint_save", "restore"]
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path / "missing"), device="cpu")
    assert tracker.entered == ["checkpoint_save", "restore"]


def test_init_tpu_workload_starts_span_and_goodput(monkeypatch, tmp_path):
    fresh = tg.GoodputTracker(registry=Registry())
    monkeypatch.setattr(tg, "_DEFAULT", fresh)
    # no other contract in the environment: only goodput is reported on
    none = {"slot": None, "hbm_limit_bytes": None, "nice": None,
            "heartbeat": None}
    assert init_tpu_workload({}) == {**none, "goodput": False}
    assert not fresh.started
    path = str(tmp_path / "g.json")
    env = {tg.STATE_ENV: path, "TPU_TRACEPARENT": TRACEPARENT}
    assert init_tpu_workload(env) == {**none, "goodput": True}
    assert fresh.started and fresh.state_path == path
    spans = [s for s in ttracer.DEFAULT_RING.spans(trace_id="ab" * 16)
             if s["name"] == "launcher.init_tpu_workload"]
    assert spans and spans[-1]["parent_id"] == "cd" * 8
    assert spans[-1]["attributes"]["goodput"] is True
    assert tg.start_from_env({}) is None
