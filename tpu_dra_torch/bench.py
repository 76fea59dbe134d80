"""Benchmark sections of the port, the counterparts of ``bench.py``'s.

- :func:`section_pallas_matmul`: the tiled-matmul kernel's throughput;
- :func:`section_decode`, :func:`section_decode_long`: greedy slab decode
  tokens/s of the serving model over bf16, int8 and int4 weights, GQA,
  an int8 KV cache and a 256-slot window;
- :func:`section_continuous`, :func:`section_paged`: the continuous
  engine under a mixed-length load of concurrent requests (slab, and
  paged with a pool a third of the slab's size), int8 weights: tokens/s
  and p50/p95 request latency; then the speculative engine's ceiling
  (draft == target, every proposal accepted) under a third of the load:
  tokens/s and tokens per pass (``*_spec_ceiling_*``,
  ``*_spec_tokens_per_pass``, the reference's keys);
- :func:`section_spec_real`: a real draft (the serving model truncated
  to 2 layers and distilled 150 steps) served speculatively on the slab
  and on pages beside the plain engine: tokens/s, accept rate, tokens
  per pass.

A section measures the card: it raises where CUDA is absent instead of
timing the CPU, and records the card's name and power limit (as
``nvidia-smi`` prints them) beside its numbers.

    python -m tpu_dra_torch.bench [SECTION ...]   # prints one JSON line
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

from tpu_dra_torch.device import resolve_device
from tpu_dra_torch.workloads.quant import (
    cast_params_bf16,
    quantize_params_int4,
    quantize_params_int8,
)
from tpu_dra_torch.workloads.train import ModelConfig, init_params

# NVIDIA's data-sheet dense bf16 peak of one H100 SXM
H100_BF16_FLOPS = 989e12

# the decode sections' model (bench.py _decode_env on a TPU): learned
# positions, full attention heads; and their batch, prompt and steps
DECODE_MODEL = dict(vocab=32768, d_model=1024, n_heads=8, n_layers=8,
                    d_ff=4096, max_seq=1024)
DECODE_RUN = dict(B=8, S=128, steps=256)
# the headline serving model of the engine sections: GQA, rope
SERVING_MODEL = dict(vocab=32768, d_model=1024, n_heads=8, n_kv_heads=2,
                     n_layers=8, d_ff=4096, max_seq=1024, pos_emb="rope")
# their request mix: prompt lengths and steps cycle over the requests
LOAD = dict(lengths=[16, 32, 64, 128], steps=[32, 64, 96, 128])
# the real draft of section_spec_real (bench.py:778): quarter depth,
# distilled at batch 16 on 256-token sequences; and its engine
SPEC_DISTILL = dict(n_layers=2, distill_steps=150, batch=16, seq=256)
SPEC_ENGINE = dict(slots=16, chunk=8)
SPEC_PAGES = dict(page_size=64, total_pages=320)


def card_info(dev: torch.device) -> dict:
    """The card's name, and its name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, timeout=60, check=True)
    return {"device": torch.cuda.get_device_name(dev),
            "nvidia_smi": smi.stdout.strip()}


def section_pallas_matmul() -> dict:
    """``matmul.matmul`` (row #2, ``csrc/matmul.cu``) on ``[n, n] @ [n,
    n]`` bf16 on the card, n = 4096: the op ``x ← matmul(x, b)·(1/n)``
    chained 200 times as the reference times it, timed with CUDA events
    after a warm-up.  Returns ``pallas_matmul_tflops`` (2n³ per op) and
    its share of the card's 989 TF/s bf16 peak as
    ``pallas_matmul_mfu_pct``, with the card's name."""
    from tpu_dra_torch.workloads.matmul import matmul
    n, iters = 4096, 200
    dev = resolve_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a = torch.randn((n, n), generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn((n, n), generator=gen, device=dev).to(torch.bfloat16)
    inv = float(torch.tensor(1.0 / n, dtype=torch.bfloat16))

    def run(x, count):
        for _ in range(count):
            x = matmul(x, b) * inv
        return x

    run(a, 3)
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = run(a, iters)
    end.record()
    torch.cuda.synchronize(dev)
    if not bool(torch.isfinite(out.float()).all()):
        raise RuntimeError("pallas matmul produced non-finite values")
    secs = start.elapsed_time(end) / 1e3 / iters
    tflops = 2 * n ** 3 / secs / 1e12
    return {"pallas_matmul_tflops": round(tflops, 2),
            "pallas_matmul_mfu_pct": round(
                100.0 * tflops * 1e12 / H100_BF16_FLOPS, 2),
            "device": torch.cuda.get_device_name(dev)}


def decode_seconds(cfg: ModelConfig, *, quant=cast_params_bf16,
                   cache_dtype: str = "bf16", B: int, S: int, steps: int,
                   window: int | None = None, device, reps: int = 3) -> float:
    """Best wall time of ``reps`` greedy decodes of ``steps`` tokens after
    a ``[B, S]`` prompt (one warm-up first), each ended by a readback of
    its last token: weights ``quant(init_params(seed 0))``, prompt from
    seed 1, the cache sized to the live sequence (or ``window`` slots)."""
    from tpu_dra_torch.workloads.decode import make_decoder
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = quant(init_params(cfg, gen))
    gen.manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device=device)
    dec = make_decoder(cfg, steps=steps,
                       max_len=None if window else S + steps,
                       cache_dtype=cache_dtype, window=window, device=device)

    def run():
        int(dec(params, prompt)[0, -1])

    run()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best


def _rates(out: dict, key: str, secs: float, B: int, steps: int) -> None:
    out[f"{key}_tokens_per_s"] = round(B * steps / secs, 1)
    out[f"{key}_ms_per_token"] = round(secs / steps * 1e3, 3)


def section_decode() -> dict:
    """Greedy slab decode of the serving model at batch 8, prompt 128,
    256 steps (host clock, best of 3): bf16, int8 and int4 weights, each
    with full heads and with GQA (kv heads = heads / 4), and int8 + GQA at
    batch 32."""
    dev = resolve_device()
    cfg = ModelConfig(**DECODE_MODEL)
    gqa = dataclasses.replace(cfg, n_kv_heads=cfg.n_heads // 4)
    B, S, steps = DECODE_RUN["B"], DECODE_RUN["S"], DECODE_RUN["steps"]
    out: dict = {"decode_steps": steps, "decode_batch": B}
    forms = {"": cast_params_bf16, "_int8": quantize_params_int8,
             "_int4": quantize_params_int4}
    for model, tag in ((cfg, ""), (gqa, "_gqa")):
        for form, quant in forms.items():
            secs = decode_seconds(model, quant=quant, B=B, S=S, steps=steps,
                                  device=dev)
            _rates(out, f"decode{form}{tag}", secs, B, steps)
    secs = decode_seconds(gqa, quant=quantize_params_int8, B=32, S=S,
                          steps=steps, device=dev)
    _rates(out, "decode_int8_gqa_b32", secs, 32, steps)
    out.update(card_info(dev))
    return out


def section_decode_long() -> dict:
    """Long-context decode: a 1024-token prompt at batch 8, 256 steps,
    where the cache read dominates: bf16 weights and cache; int8 weights
    and int8 cache; int8 weights and cache over a 256-slot window (rope).
    ``max_seq`` grows to hold the decoded positions."""
    dev = resolve_device()
    cfg = ModelConfig(**DECODE_MODEL)
    B, steps, SL = DECODE_RUN["B"], DECODE_RUN["steps"], 1024
    long_cfg = dataclasses.replace(cfg, max_seq=SL + steps)
    rope_cfg = dataclasses.replace(cfg, pos_emb="rope", max_seq=SL)
    out: dict = {}
    runs = {"decode_long": (long_cfg, cast_params_bf16, "bf16", None),
            "decode_long_full_int8": (long_cfg, quantize_params_int8, "int8",
                                      None),
            "decode_long_window256_int8": (rope_cfg, quantize_params_int8,
                                           "int8", 256)}
    for key, (model, quant, cache_dtype, window) in runs.items():
        secs = decode_seconds(model, quant=quant, cache_dtype=cache_dtype,
                              B=B, S=SL, steps=steps, window=window,
                              device=dev)
        _rates(out, key, secs, B, steps)
    out.update(card_info(dev))
    return out


def serve_load(eng, *, n_req: int, lengths: list[int], steps: list[int],
               timeout: float = 600) -> dict:
    """Warm every prompt bucket of ``eng``, then submit ``n_req`` requests
    at once (prompt ``[7 + i % 100] * lengths[i % ...]``, ``steps[i %
    ...]`` tokens) and wait for all: tokens/s over the wall time, the
    engine's p50/p95 request latency, and the first error if any."""
    for n in lengths:
        eng.submit([1] * n, steps=eng.chunk, timeout=timeout)
    eng.reset_stats()
    reqs = [([7 + i % 100] * lengths[i % len(lengths)],
             steps[i % len(steps)]) for i in range(n_req)]
    t0 = time.perf_counter()
    handles = [eng.submit_async(p, s) for p, s in reqs]
    errs = []
    for h in handles:
        if not h.done.wait(timeout):
            errs.append(f"timeout: request not done within {timeout}s")
        elif h.error:
            errs.append(h.error)
    secs = time.perf_counter() - t0
    stats = eng.stats()
    out = {"tokens_per_s": round(sum(len(h.tokens) for h in handles) / secs,
                                 1),
           "req_p50_ms": stats.get("latency_p50_ms"),
           "req_p95_ms": stats.get("latency_p95_ms")}
    if errs:
        out["errors"] = errs[0][:200]
    return out


def spec_load(eng, **load) -> dict:
    """:func:`serve_load` of a speculative engine, with its accept rate
    and committed tokens per slot-pass."""
    out = serve_load(eng, **load)
    st = eng.stats()
    out["accept_rate"] = st.get("spec_accept_rate")
    out["tokens_per_pass"] = st.get("spec_tokens_per_pass")
    return out


def _engine_section(prefix: str, n_req: int, spec_pages: int | None = None,
                    **engine_kw) -> dict:
    """The mixed load on a plain engine, then the speculative engine's
    ceiling (draft == target) on a third of it (``spec_pages``: the
    doubled pool a paged engine gets for it, as the reference's)."""
    from tpu_dra_torch.workloads.continuous import ContinuousEngine
    dev = resolve_device()
    cfg = ModelConfig(**SERVING_MODEL)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = quantize_params_int8(init_params(cfg, gen))
    eng = ContinuousEngine(cfg, params, slots=32, chunk=8, device=dev,
                           **engine_kw)
    try:
        load = serve_load(eng, n_req=n_req, **LOAD)
        out = {f"{prefix}_{k}": v for k, v in load.items()}
        if eng.pool is not None:
            out[f"{prefix}_pool_pages"] = eng.pool.total_pages
            out[f"{prefix}_page_size"] = eng.pool.page_size
            out[f"{prefix}_pool_vs_slab_pct"] = round(
                100.0 * eng.pool.total_pages / (eng.slots * eng._mp), 1)
    finally:
        eng.shutdown()
    if spec_pages is not None:
        engine_kw = dict(engine_kw, total_pages=spec_pages)
    eng = ContinuousEngine(cfg, params, slots=32, chunk=8, device=dev,
                           draft=(cfg, params), **engine_kw)
    try:
        spec = spec_load(eng, n_req=max(4, n_req // 3), **LOAD)
    finally:
        eng.shutdown()
    out[f"{prefix}_spec_ceiling_tokens_per_s"] = spec["tokens_per_s"]
    out[f"{prefix}_spec_tokens_per_pass"] = spec["tokens_per_pass"]
    if "errors" in spec:
        out[f"{prefix}_spec_errors"] = spec["errors"]
    out[f"{prefix}_slots"] = 32
    out[f"{prefix}_requests"] = n_req
    out.update(card_info(dev))
    return out


def section_continuous() -> dict:
    """The continuous engine on the slab: the headline serving model with
    int8 weights, 32 slots, chunk 8, 96 mixed-length requests at once."""
    return _engine_section("continuous", 96, kv_layout="slab")


def section_paged() -> dict:
    """The same load over pages: 64 requests, 64-token pages, a pool of
    160 pages (the worst live need is 128; the slab would hold 512)."""
    return _engine_section("paged", 64, spec_pages=320, kv_layout="paged",
                           page_size=64, total_pages=160)


def section_spec_real() -> dict:
    """A real draft, as the reference's ``section_spec_real``: the
    serving model (fp32 from seed 0) truncated to 2 layers and distilled
    150 steps at batch 16, seq 256 (host clock), then both models int8;
    32 mixed-length requests at 16 slots, chunk 8, through the plain
    engine and the speculative engine on the slab, and the speculative
    engine on 64-token pages (320 pages): tokens/s, accept rate, tokens
    per pass.  The random-init teacher's argmax is a max-entropy
    function, so the accept rate is a floor on a trained model's."""
    from tpu_dra_torch.workloads.continuous import ContinuousEngine
    from tpu_dra_torch.workloads.spec_draft import make_draft
    dev = resolve_device()
    cfg = ModelConfig(**SERVING_MODEL)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    fparams = init_params(cfg, gen)
    t0 = time.perf_counter()
    dcfg, dfloat = make_draft(cfg, fparams, **SPEC_DISTILL)
    torch.cuda.synchronize(dev)
    out = {"spec_real_draft_layers": dcfg.n_layers,
           "spec_real_target_layers": cfg.n_layers,
           "spec_real_distill_steps": SPEC_DISTILL["distill_steps"],
           "spec_real_distill_secs": round(time.perf_counter() - t0, 1)}
    params = quantize_params_int8(fparams)
    dparams = quantize_params_int8(dfloat)
    del fparams, dfloat
    load = dict(n_req=32, **LOAD)
    runs = {"spec_real_plain": dict(),
            "spec_real": dict(draft=(dcfg, dparams)),
            "paged_spec_real": dict(draft=(dcfg, dparams), kv_layout="paged",
                                    **SPEC_PAGES)}
    for key, kw in runs.items():
        eng = ContinuousEngine(cfg, params, device=dev, **SPEC_ENGINE, **kw)
        try:
            res = spec_load(eng, **load)
        finally:
            eng.shutdown()
        out[f"{key}_tokens_per_s"] = res["tokens_per_s"]
        if "draft" in kw:
            out[f"{key}_accept_rate"] = res["accept_rate"]
            out[f"{key}_tokens_per_pass"] = res["tokens_per_pass"]
        if "errors" in res:
            out[f"{key}_errors"] = res["errors"]
    out["spec_real_speedup_pct"] = round(
        100.0 * (out["spec_real_tokens_per_s"]
                 / out["spec_real_plain_tokens_per_s"] - 1), 1)
    out.update(card_info(dev))
    return out


SECTIONS = {"pallas_matmul": section_pallas_matmul,
            "decode": section_decode, "decode_long": section_decode_long,
            "continuous": section_continuous, "paged": section_paged,
            "spec_real": section_spec_real}


def main(argv=None) -> None:
    names = (sys.argv[1:] if argv is None else argv) or list(SECTIONS)
    unknown = [n for n in names if n not in SECTIONS]
    if unknown:
        raise SystemExit(f"unknown sections {unknown}; choose from "
                         f"{sorted(SECTIONS)}")
    out: dict = {}
    for name in names:
        out.update(SECTIONS[name]())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
