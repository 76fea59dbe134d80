#!/usr/bin/env python3
"""Time the flagship's training step of one checkout of the port on one
NVIDIA GPU: the run of chip_smoke.py's phase 8 without its checks.

    python3 chip_train_step.py [CHECKOUT]      # default: this checkout

It imports ``tpu_dra_torch`` from CHECKOUT (another commit unpacked with
``git archive`` compares two versions on one card: run them alternately,
A B B A), builds its kernels, writes chip_smoke.py's synthetic corpus
(2 200 000 uint16 tokens: a 64-token motif from seed 0, 5% noise) to a
temporary file, trains the flagship (vocab 32768, d_model 2048, 16
heads, 8 layers, d_ff 8192, max_seq 1024) 10 steps at batch 16 through
the checkout's ``fit`` with flash attention, and prints one JSON line:
the median step time of steps 2-10, the first step's, the peak of
``torch.cuda.max_memory_allocated``, the flash kernels' launches, the
losses, one more step of ``make_train_step`` under torch.profiler (its
wall time, the host's time to enqueue it, and the device's busy time:
what of the step is host dispatch and what device work), and the card's
name and power limit (nvidia-smi).
"""

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

MODEL = dict(vocab=32768, d_model=2048, n_heads=16, n_layers=8, d_ff=8192,
             max_seq=1024)
STEPS, BATCH, TOKENS, SEED = 10, 16, 2_200_000, 0


def profiled_step(cfg, path: str) -> dict:
    """One step of ``make_train_step`` (AdamW, flash attention, the
    weights from seed SEED) after two warm-up steps, under torch.profiler:
    its wall time to a synchronize, the time until ``step`` returned (the
    host's enqueueing), and the union of the CUDA kernels' intervals."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tpu_dra_torch.workloads.data import TokenDataset, batches
    from tpu_dra_torch.workloads.optim import default_optimizer
    from tpu_dra_torch.workloads.train import init_params, make_train_step
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = init_params(cfg, gen)
    step, init_opt = make_train_step(cfg, default_optimizer(),
                                     attn_impl="flash")
    state = init_opt(params)
    it = batches(TokenDataset(path), batch=BATCH, seq=cfg.max_seq)
    toks = [torch.from_numpy(next(it)).to("cuda") for _ in range(3)]
    for t in toks[:2]:
        params, state, _ = step(params, state, t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, state, toks[2])
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"traced_step_ms": 1e3 * (t2 - t0),
            "enqueue_ms": 1e3 * (t1 - t0), "busy_ms": busy / 1e3,
            "kernels": len(spans)}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_train_step: needs one CUDA card", file=sys.stderr)
        return 2
    root = Path(sys.argv[1] if len(sys.argv) > 1 else
                Path(__file__).resolve().parent).resolve()
    sys.path.insert(0, str(root))
    from tpu_dra_torch.kernels.build import build_all
    from tpu_dra_torch.workloads import flash as F
    from tpu_dra_torch.workloads.data import TokenDataset
    from tpu_dra_torch.workloads.fit import fit
    from tpu_dra_torch.workloads.train import ModelConfig
    import tpu_dra_torch
    if Path(tpu_dra_torch.__file__).resolve().parent.parent != root:
        raise SystemExit(f"imported {tpu_dra_torch.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cfg = ModelConfig(**MODEL)
    counters = {"flash_fwd": F.flash_attn_fwd,
                "flash_bwd_dq": F.flash_bwd_dq,
                "flash_bwd_dkdv": F.flash_bwd_dkdv}
    with tempfile.TemporaryDirectory(prefix="chip_train_step-") as tmp:
        rng = np.random.default_rng(SEED)
        toks = np.resize(rng.integers(0, cfg.vocab, 64), TOKENS)
        noise = rng.random(TOKENS) < 0.05
        toks[noise] = rng.integers(0, cfg.vocab, int(noise.sum()))
        path = str(Path(tmp) / "tokens.bin")
        TokenDataset.write(path, toks)
        for fn in counters.values():
            fn.launches = 0
        stamps = []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fit(cfg, path, steps=STEPS, batch=BATCH, attn_impl="flash",
                  log_every=1,
                  log_fn=lambda line: stamps.append(time.perf_counter()))
        peak = torch.cuda.max_memory_allocated()
        traced = profiled_step(cfg, path)
    times = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    print(json.dumps({
        "checkout": str(root), "step_ms": 1e3 * statistics.median(times[1:]),
        "first_step_ms": 1e3 * times[0], "peak_bytes": peak,
        "flash_launches": {n: fn.launches for n, fn in counters.items()},
        "losses": res.losses, **traced, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
