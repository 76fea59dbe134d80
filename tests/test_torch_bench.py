"""The port's benchmark sections (tpu_dra_torch/bench.py) on the CPU:
every section refuses to time anything but the card, and the measuring
helpers the sections share run the decoders and the engine end to end
at a tiny size (their times are the CPU's and are not recorded)."""

from __future__ import annotations

import time
import types

import pytest
import torch

from tpu_dra_torch import bench
from tpu_dra_torch.workloads.continuous import ContinuousEngine
from tpu_dra_torch.workloads.quant import (
    cast_params_bf16,
    quantize_params_int4,
    quantize_params_int8,
)
from tpu_dra_torch.workloads.train import ModelConfig, init_params

TINY = ModelConfig(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                   max_seq=32, pos_emb="rope", n_kv_heads=2)


@pytest.mark.parametrize("name", list(bench.SECTIONS))
def test_every_section_measures_the_card_only(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.SECTIONS[name]()


def test_unknown_section_is_refused():
    with pytest.raises(SystemExit, match="unknown sections"):
        bench.main(["nope"])


@pytest.mark.parametrize("run", [
    dict(quant=cast_params_bf16), dict(quant=quantize_params_int8),
    dict(quant=quantize_params_int4),
    dict(quant=quantize_params_int8, cache_dtype="int8", window=8)],
    ids=["bf16", "int8", "int4", "int8-window"])
def test_decode_seconds_runs_each_decoder(run):
    assert bench.decode_seconds(TINY, B=2, S=5, steps=4, device="cpu",
                                reps=1, **run) > 0


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_serve_load_serves_the_mixed_load(layout):
    gen = torch.Generator().manual_seed(0)
    params = quantize_params_int8(init_params(TINY, gen))
    eng = ContinuousEngine(TINY, params, slots=4, chunk=2, device="cpu",
                           kv_layout=layout, page_size=8)
    try:
        out = bench.serve_load(eng, n_req=6, lengths=[2, 5], steps=[3, 6],
                               timeout=120)
        st = eng.stats()
    finally:
        eng.shutdown()
    assert "errors" not in out and out["tokens_per_s"] > 0
    assert out["req_p50_ms"] <= out["req_p95_ms"]
    assert st["completed"] == 6 and st["tokens_out"] == 3 * 3 + 3 * 6


def slow(mm):
    """``mm`` after a 10 ms sleep: an op whose chain of 2·iters surely
    takes longer than its chain of iters on a busy CPU."""
    def op(x, y):
        time.sleep(1e-2)
        return mm(x, y)
    return op


def test_time_op_runs_the_chained_op():
    a = torch.randn((16, 16))
    assert bench.time_op(lambda x: slow(torch.matmul)(x, a) * 0.25, a,
                         iters=2) > 0


def test_time_op_raises_where_the_longer_chain_took_no_longer(monkeypatch):
    clock = iter([0.0, 2.0, 10.0, 11.0])      # iters: 2 s, 2·iters: 1 s
    monkeypatch.setattr(bench, "time",
                        types.SimpleNamespace(perf_counter=lambda: next(clock)))
    a = torch.randn((4, 4))
    with pytest.raises(RuntimeError, match="no longer"):
        bench.time_op(lambda x: x @ a, a, iters=2, repeats=1)


def test_time_op_raises_on_a_result_that_is_not_finite():
    a = torch.ones((4, 4))
    with pytest.raises(RuntimeError, match="not finite"):
        bench.time_op(lambda x: x * float("inf"), a, iters=1, repeats=1)


@pytest.mark.parametrize("prefix", ["gpu_matmul", "pallas_matmul"])
def test_matmul_numbers_gives_the_reference_keys(prefix):
    from tpu_dra_torch.workloads.matmul import matmul
    mm = torch.matmul if prefix == "gpu_matmul" else matmul
    out = bench.matmul_numbers("cpu", slow(mm), prefix, n=32, iters=2)
    assert set(out) == {f"{prefix}_tflops", f"{prefix}_mfu_pct"}
    assert out[f"{prefix}_mfu_pct"] == bench.mfu_pct(out[f"{prefix}_tflops"])


def test_flash_numbers_runs_each_arm(monkeypatch):
    """Each arm's op runs once through a stand-in for :func:`time_op`
    (tested above; a busy CPU is no clock for ops this small)."""
    ran = []

    def once(fn, x, iters, repeats=5):
        ran.append(bool(torch.isfinite(fn(x)).all()))
        return 1e-3
    monkeypatch.setattr(bench, "time_op", once)
    out = bench.flash_numbers("cpu", bh=4, s=32, d=16, group=2,
                              iters=(1, 1))
    assert out["pallas_flash_gqa4_group"] == 2
    assert out["pallas_flash_bwd_impl"] in ("split", "fused")
    assert set(out) == {
        "pallas_flash_tflops", "pallas_flash_mfu_pct",
        "pallas_flash_fwd_bwd_tflops_effective",
        "pallas_flash_fwd_bwd_mfu_pct", "pallas_flash_bwd_impl",
        "pallas_flash_gqa4_tflops", "pallas_flash_gqa4_mfu_pct",
        "pallas_flash_gqa4_group"}
    assert out["pallas_flash_tflops"] >= 0
    assert ran == [True] * 3


def test_train_numbers_runs_every_arm():
    from tpu_dra_torch.workloads.mesh import Mesh
    cfg = ModelConfig(vocab=64, d_model=32, n_heads=4, n_layers=1, d_ff=64,
                      max_seq=16)
    long_cfg = ModelConfig(vocab=64, d_model=32, n_heads=4, n_layers=1,
                           d_ff=64, max_seq=32)
    out = bench.train_numbers(cfg, 2, Mesh({"dp": 1, "tp": 1}, device="cpu"),
                              long_cfg=long_cfg, windows=1, iters=1,
                              long_iters=1)
    for arm in ("train_step", "train_step_chunked", "train_step_fused"):
        assert out[f"{arm}_tokens_per_s"] > 0
        assert f"{arm}_mfu_pct" in out
    assert out["train_loss_finite"] and out["train_step_chunked_loss_finite"]
    assert out["train_step_fused_loss_finite"]
    assert out["train_params_m"] == round(sum(
        t.numel() for t in bench.tree_leaves(init_params(
            cfg, torch.Generator().manual_seed(0)))) / 1e6, 2)
    assert "train_step_fused_delta_pct" in out
    assert out["train_step_fused_norm_launches"] == 0      # plain on the CPU
    assert out["train_long_seq"] == 32 and out["train_long_loss_finite"]
    assert out["train_long_tokens_per_s"] > 0 and "train_long_mfu_pct" in out


def test_train_keys_count_six_flops_a_parameter_a_token():
    out = bench.train_keys("x", 2.0, 1000, 10 ** 9, 1.5)
    assert out == {"x_tokens_per_s": 500.0, "x_tflops": 3.0,
                   "x_mfu_pct": bench.mfu_pct(3.0), "x_loss_finite": True}
    assert not bench.train_keys("x", 1.0, 1, 1, float("nan"))[
        "x_loss_finite"]


GOOD = {"ok": True, "limit": 100, "bytes_limit": 100, "overalloc": None}


@pytest.mark.parametrize("results,want", [
    ([dict(GOOD, overalloc="rejected"), GOOD],
     {"multiprocess_ok": True, "multiprocess_succeeded": 2,
      "multiprocess_mode": "shared", "multiprocess_bytes_limit": 100,
      "multiprocess_limit_respected": True,
      "multiprocess_cap_enforced": True}),
    ([dict(GOOD, overalloc="allowed", bytes_limit=120), {"error": "x"}],
     {"multiprocess_ok": False, "multiprocess_succeeded": 1,
      "multiprocess_mode": "exclusive", "multiprocess_bytes_limit": 120,
      "multiprocess_limit_respected": False,
      "multiprocess_cap_enforced": False}),
    ([{"error": "timeout"}, {"ok": False, "limit": 100, "bytes_limit": 100,
                             "overalloc": None}],
     {"multiprocess_ok": False, "multiprocess_succeeded": 0,
      "multiprocess_mode": "failed"})],
    ids=["shared", "exclusive", "failed"])
def test_multiprocess_summary(results, want):
    out = bench.multiprocess_summary(results)
    err = out.pop("multiprocess_error", None)
    assert out == want
    assert (err is not None) == (want["multiprocess_succeeded"] == 0)


def test_sections_run_in_the_reference_order():
    names = list(bench.SECTIONS)
    assert names[:5] == ["probe", "matmul", "pallas_matmul", "flash",
                         "train"]
    # the reference appends collectives last (with more than one device)
    assert names[-3:] == ["visibility", "multiprocess", "collectives"]
