"""The port's recapture ratchet (tpu_dra_torch/workloads/retrace_guard.py)
against the reference's (tpu_dra/workloads/retrace_guard.py): the cases of
tests/test_retrace_guard.py run through both guards on the same jitted
callables, the same stats from both over programs of the port's kind, the
captured-program bookkeeping of the engine (``continuous._GraphedProgram``:
captures, recaptures on moved tensors, launch counters moved from the
capture to the replays) with CUDA's graph API stubbed, the engine's
``stats()`` keys with the flag on and off, and the engine's pause that a
device trace starts and stops its profiler under."""

from __future__ import annotations

import contextlib
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import cfg_pair, jax_params, to_torch

from tpu_dra.workloads import retrace_guard as ref
from tpu_dra_torch.workloads import continuous as tc
from tpu_dra_torch.workloads import retrace_guard as port
from tpu_dra_torch.workloads.paged_kv import paged_attention
from tpu_dra_torch.workloads.quant import int8_product

GUARDS = pytest.mark.parametrize("Guard", [ref.RetraceGuard,
                                           port.RetraceGuard],
                                 ids=["reference", "port"])


def test_flag_and_keys_are_the_reference_s():
    assert port.ENV_FLAG == ref.ENV_FLAG == "TPU_DRA_RETRACE_GUARD"
    assert port.__all__ == ref.__all__
    g = port.RetraceGuard(enabled=True)
    assert set(g.stats()) == set(ref.RetraceGuard(enabled=True).stats()) \
        == {"recompiles_since_mark", "compile_cache_entries",
            "jit_callables_tracked"}


@pytest.mark.parametrize("cache_size_of", [ref.cache_size_of,
                                           port.cache_size_of],
                         ids=["reference", "port"])
def test_cache_size_of_rejects_non_programs(cache_size_of):
    assert cache_size_of(lambda x: x) is None
    assert cache_size_of(3) is None
    assert cache_size_of(None) is None
    assert cache_size_of(jax.jit(lambda x: x)) == 0

    class Odd:
        def _cache_size(self, needed):
            return needed
    assert cache_size_of(Odd()) is None


@GUARDS
def test_disabled_guard_is_inert(Guard):
    g = Guard(enabled=False)
    g.attach("eng", object())
    g.watch("f", jax.jit(lambda x: x))
    g.mark()
    assert g.counts() == {}
    assert g.recompiles_since_mark() == 0
    assert g.total_entries() == 0
    assert g.tracked() == 0
    assert g.stats() == {}


@GUARDS
def test_env_flag_controls_default(Guard, monkeypatch):
    monkeypatch.setenv(port.ENV_FLAG, "1")
    assert Guard().enabled
    monkeypatch.setenv(port.ENV_FLAG, "false")
    assert not Guard().enabled
    monkeypatch.setenv(port.ENV_FLAG, "0")
    assert not Guard().enabled
    monkeypatch.delenv(port.ENV_FLAG)
    assert not Guard().enabled
    monkeypatch.setenv(port.ENV_FLAG, "1")
    assert not Guard(enabled=False).enabled


@GUARDS
def test_exact_counts_across_cache_hits_and_misses(Guard):
    f = jax.jit(lambda x: x + 1)
    g = Guard(enabled=True)
    g.watch("f", f)
    g.mark()
    assert g.recompiles_since_mark() == 0
    f(jnp.zeros((2,)))                      # miss: first compile
    assert g.recompiles_since_mark() == 1
    f(jnp.ones((2,)))                       # hit
    f(jnp.zeros((2,)))                      # hit
    assert g.recompiles_since_mark() == 1
    f(jnp.zeros((3,)))                      # miss: new shape
    assert g.recompiles_since_mark() == 2
    f(jnp.zeros((3,), jnp.int32))           # miss: new dtype
    assert g.recompiles_since_mark() == 3
    g.mark()
    assert g.recompiles_since_mark() == 0
    f(jnp.zeros((3,)))
    assert g.recompiles_since_mark() == 0


@GUARDS
def test_compiles_before_mark_are_not_findings(Guard):
    f = jax.jit(lambda x: x * 2)
    g = Guard(enabled=True)
    g.watch("f", f)
    f(jnp.zeros((4,)))
    assert g.recompiles_since_mark() == 0   # no mark yet
    g.mark()
    assert g.recompiles_since_mark() == 0
    assert g.total_entries() == 1


@GUARDS
def test_attach_discovers_attrs_and_lazy_dict_values(Guard):
    class Holder:
        pass

    h = Holder()
    h.step = jax.jit(lambda x: x * 2)
    h.fns = {}
    g = Guard(enabled=True)
    g.attach("eng", h)
    h.step(jnp.ones((2,)))
    g.mark()
    assert g.recompiles_since_mark() == 0
    h.fns[16] = jax.jit(lambda x: x - 1)    # lazy factory product
    h.fns[16](jnp.ones((2,)))
    assert g.recompiles_since_mark() == 1
    assert {"eng.step", "eng.fns[16]"} <= set(g.counts())
    assert g.stats() == {"recompiles_since_mark": 1,
                         "compile_cache_entries": 2,
                         "jit_callables_tracked": 2}


@GUARDS
def test_non_program_attrs_and_dict_values_are_ignored(Guard):
    class Holder:
        pass

    h = Holder()
    h.name = "engine"
    h.counters = {"completed": 3}
    h.step = jax.jit(lambda x: x)
    g = Guard(enabled=True)
    g.attach("eng", h)
    assert set(g.counts()) == {"eng.step"}


class Program:
    """A program of the port's kind: ``_cache_size()`` counts captures."""

    def __init__(self) -> None:
        self.captures = 0

    def _cache_size(self) -> int:
        return self.captures


def test_both_guards_read_the_same_stats_over_captured_programs():
    """The engine idiom in the port: programs in a ``_graphs`` dict keyed
    on a tuple, captured lazily, one recaptured after the mark."""
    class Engine:
        pass

    eng = Engine()
    eng._graphs = {}
    guards = [G(enabled=True) for G in (ref.RetraceGuard, port.RetraceGuard)]
    for g in guards:
        g.attach("engine", eng)
    key = ("chunk", "paged", 32, 8, "int8")
    eng._graphs[key] = Program()
    eng._graphs[key].captures = 1           # warmup's capture
    for g in guards:
        g.mark()
    readings = []
    for step in range(3):
        if step == 1:
            eng._graphs[key].captures += 1  # tensors moved: recaptured
        if step == 2:
            eng._graphs[("spec",) + key[1:]] = Program()
            eng._graphs[("spec",) + key[1:]].captures = 1
        readings.append([(g.stats(), g.counts()) for g in guards])
    for ref_reading, port_reading in readings:
        assert ref_reading == port_reading
    assert [r[1][0]["recompiles_since_mark"] for r in readings] == [0, 1, 2]
    assert f"engine._graphs[{key!r}]" in readings[0][1][1]


class FakeStream:
    def wait_stream(self, other) -> None:
        pass


class FakeGraph:
    def __init__(self) -> None:
        self.replays = 0

    def replay(self) -> None:
        self.replays += 1


@pytest.fixture()
def stub_cuda_graphs(monkeypatch):
    """CUDA's stream and graph API stubbed: the 'capture' runs the body
    once, a replay runs nothing."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None:
                        FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, **kw: contextlib.nullcontext())
    monkeypatch.setattr(paged_attention, "launches", 0)
    monkeypatch.setattr(int8_product, "calls", 0)


def test_graphed_program_moves_counts_to_replays(stub_cuda_graphs):
    """A capture's kernel launches and int8 products are not counted
    where they were recorded (nor the eager pass before it) but once a
    replay; state is restored after the eager pass; a moved tensor is a
    recapture, which ``_cache_size()`` counts."""
    state = torch.zeros(3, dtype=torch.int32)
    out = torch.zeros(3, dtype=torch.int32)
    calls = []

    def body():
        calls.append(state.clone())
        paged_attention.launches += 2
        int8_product.calls += 5
        state.add_(1)
        return out

    prog = tc._GraphedProgram(torch.device("cpu"), pool=None)
    assert prog._cache_size() == 0
    assert prog.run(body, (1, 2), (state,)) is out
    # the eager pass and the capture both saw the state as it was
    assert [c.tolist() for c in calls] == [[0, 0, 0], [0, 0, 0]]
    assert prog._cache_size() == 1 and prog.replays == 1
    assert (paged_attention.launches, int8_product.calls) == (2, 5)
    prog.run(body, (1, 2), (state,))
    prog.run(body, (1, 2), (state,))
    assert len(calls) == 2 and prog._cache_size() == 1
    assert (paged_attention.launches, int8_product.calls) == (6, 15)
    prog.run(body, (1, 3), (state,))        # a static tensor moved
    assert prog._cache_size() == 2 and len(calls) == 4
    assert (paged_attention.launches, int8_product.calls) == (8, 20)
    guard = port.RetraceGuard(enabled=True)
    guard.watch("prog", prog)
    assert guard.total_entries() == 2


def test_weight_form_names_each_form():
    w = torch.zeros(2, 4, 4)
    assert tc.weight_form({"blocks": {"wqkv": w}}) == "float32"
    assert tc.weight_form({"blocks": {"wqkv": w.bfloat16()}}) == "bfloat16"
    assert tc.weight_form({"blocks": {"wqkv": {"q8": w, "s": w}}}) == "int8"
    assert tc.weight_form({"blocks": {"wqkv": {"q4": w, "s4": w}}}) == "int4"
    assert tc.weight_form({"blocks": {"wqkv": {
        "base": w, "a": w, "b": w, "scale": w}}}) == "lora"


CFG_KW = dict(vocab=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
              d_ff=128, max_seq=64, pos_emb="rope")


@pytest.mark.parametrize("kv_layout", ["slab", "paged"])
@pytest.mark.parametrize("flag", ["1", "0"])
def test_engine_stats_carry_the_guard_keys_when_on(flag, kv_layout,
                                                   monkeypatch):
    """The engine attaches itself, warmup marks, and stats() merges the
    reference's three keys only with the flag on; on the CPU nothing is
    captured, so the guard tracks no program and counts 0."""
    monkeypatch.setenv(port.ENV_FLAG, flag)
    jcfg, tcfg = cfg_pair(**CFG_KW)
    params = to_torch(jax_params(jcfg, seed=0))
    eng = tc.ContinuousEngine(tcfg, params, slots=2, chunk=2, max_len=32,
                              page_size=8, kv_layout=kv_layout, device="cpu")
    try:
        assert eng.retrace_guard.enabled == (flag == "1")
        eng.warmup(buckets=[16], burst=2)
        assert eng.submit([1, 2, 3], 4, timeout=120)
        stats = eng.stats()
        keys = {"recompiles_since_mark", "compile_cache_entries",
                "jit_callables_tracked"}
        if flag == "1":
            assert keys <= set(stats)
            assert stats["recompiles_since_mark"] == 0
            assert stats["jit_callables_tracked"] == 0
            assert eng._graphs == {}
        else:
            assert not keys & set(stats)
    finally:
        eng.shutdown()


def test_a_paused_engine_runs_no_pass():
    """paused() holds the batcher between passes: no decode step while
    it is held, the request finishes after it is let go."""
    jcfg, tcfg = cfg_pair(**CFG_KW)
    params = to_torch(jax_params(jcfg, seed=0))
    eng = tc.ContinuousEngine(tcfg, params, slots=2, chunk=2, max_len=32,
                              page_size=8, kv_layout="paged", device="cpu")
    try:
        req = eng.submit_async([1, 2, 3], 24)
        deadline = time.monotonic() + 120
        while eng.decode_steps == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        with eng.paused():
            steps = eng.decode_steps
            time.sleep(0.3)
            assert eng.decode_steps == steps
            assert not req.done.is_set()
        assert req.done.wait(120) and req.error is None
        assert len(req.tokens) == 24
    finally:
        eng.shutdown()


def test_device_trace_starts_and_stops_under_the_pause():
    from tpu_dra_torch.workloads.serve import capture_device_trace
    entered = []

    @contextlib.contextmanager
    def pause():
        entered.append(1)
        yield

    body, counts = capture_device_trace(0.01, torch.device("cpu"),
                                        pause=pause)
    assert len(entered) == 2 and body and counts["events"] >= 0
