"""The port's benchmark sections (tpu_dra_torch/bench.py) on the CPU:
every section refuses to time anything but the card, and the measuring
helpers the sections share run the decoders and the engine end to end
at a tiny size (their times are the CPU's and are not recorded)."""

from __future__ import annotations

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
