"""End-to-end training loop of the port, ported from
``tpu_dra/workloads/fit.py``: token file → deterministic batches → train
step (``train.make_train_step``, AdamW after global-norm clipping) on one
device.

    python -m tpu_dra_torch.workloads.fit --data tokens.bin --attn-impl flash

Same flags and defaults as the reference's CLI.  It trains on the card
(``resolve_device``); ``fit(..., device="cpu")`` runs the plain PyTorch
path on the CPU.  Initial weights come from a ``torch.Generator`` seeded
with 0, so they differ from the reference's ``jax.random`` ones.

Not ported yet (ROADMAP.md queue 1 item 10), and refused with
``NotImplementedError``: checkpoints and resume, MoE configs and ZeRO-1;
the reference's multi-device mesh and its opt-in goodput hooks have no
counterpart here.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from tpu_dra_torch.device import resolve_device
from tpu_dra_torch.workloads.data import TokenDataset, batches, device_prefetch
from tpu_dra_torch.workloads.optim import AdamW, make_schedule
from tpu_dra_torch.workloads.train import (
    ModelConfig,
    init_params,
    loss_fn,
    make_train_step,
)

_LATER = "ROADMAP.md queue 1 item 10"


@dataclass
class FitResult:
    step: int
    loss: float
    losses: list[float]
    tokens_per_s: float


def fit(cfg: ModelConfig, data_path: str, *, steps: int = 100,
        batch: int = 8, lr: float = 3e-4,
        lr_schedule: str = "constant", warmup_steps: int = 0,
        attn_impl: str = "dense", head_impl: str = "dense",
        accum_steps: int = 1, label_smoothing: float = 0.0,
        z_loss: float = 0.0, zero1: bool = False,
        checkpoint_dir: str | None = None, checkpoint_every: int = 0,
        resume: bool = False, log_every: int = 10,
        log_fn: Callable[[str], None] = print, device=None) -> FitResult:
    """Train ``cfg`` on a token file for ``steps`` optimizer steps on one
    device (default: the card).  ``tokens_per_s`` counts from before the
    first step, so it includes the first step's one-time costs, as the
    reference's does."""
    if not isinstance(cfg, ModelConfig):
        raise NotImplementedError(
            f"only the dense ModelConfig trains in the PyTorch port; "
            f"{type(cfg).__name__} (MoE) comes with {_LATER}")
    if zero1:
        raise NotImplementedError(f"zero1 comes with {_LATER}")
    if checkpoint_dir or checkpoint_every or resume:
        raise NotImplementedError(
            f"checkpointing and resume come with {_LATER}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if batch % accum_steps:
        raise ValueError(f"batch {batch} must be divisible by accum_steps "
                         f"{accum_steps}")
    dev = resolve_device(device)
    ds = TokenDataset(data_path)
    optimizer = AdamW(make_schedule(lr, lr_schedule, warmup_steps, steps))
    step_fn, init_opt = make_train_step(
        cfg, optimizer, attn_impl=attn_impl, head_impl=head_impl,
        accum_steps=accum_steps, label_smoothing=label_smoothing,
        z_loss=z_loss)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    opt_state = init_opt(params)

    it = device_prefetch(batches(ds, batch=batch, seq=cfg.max_seq), dev)
    losses: list[float] = []
    loss = None
    t0 = time.perf_counter()
    tokens_done = 0
    for step in range(steps):
        tokens = next(it)
        params, opt_state, loss = step_fn(params, opt_state, tokens)
        tokens_done += tokens.shape[0] * (tokens.shape[1] - 1)
        if log_every and (step + 1) % log_every == 0:
            lossf = float(loss)
            losses.append(lossf)
            log_fn(f"step {step + 1}: loss {lossf:.4f}")
    lossf = float(loss)               # waits for the device's last step
    secs = time.perf_counter() - t0
    return FitResult(step=steps, loss=lossf, losses=losses,
                     tokens_per_s=tokens_done / max(secs, 1e-9))


def evaluate(cfg: ModelConfig, params, data_path: str, *,
             batches_n: int = 16, batch: int = 8, attn_impl: str = "dense",
             head_impl: str = "dense") -> dict[str, float]:
    """Mean NLL and perplexity over ``batches_n`` deterministic batches at
    the TAIL of the window space (held out until a run wraps the
    dataset), on the device that holds ``params``."""
    dev = params["ln_f"].device
    ds = TokenDataset(data_path)
    n_windows = (len(ds) - 1) // cfg.max_seq
    tail_step = max(0, n_windows // batch - batches_n)
    it = device_prefetch(batches(ds, batch=batch, seq=cfg.max_seq,
                                 start_step=tail_step), dev)
    total = 0.0
    with torch.no_grad():
        for _ in range(batches_n):
            total += float(loss_fn(cfg, params, next(it), attn_impl,
                                   head_impl))
    nll = total / batches_n
    return {"nll": nll, "perplexity": float(np.exp(nll))}


def main(argv=None):
    """CLI: train the flagship config on a token file on the card.
    ``python -m tpu_dra_torch.workloads.fit --data t.bin``."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--data", required=True, help="flat token file")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--n-heads", type=int, default=8)
    ap.add_argument("--n-kv-heads", type=int, default=None)
    ap.add_argument("--n-layers", type=int, default=8)
    ap.add_argument("--d-ff", type=int, default=2048)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--pos-emb", default="rope",
                    choices=("rope", "learned"))
    ap.add_argument("--attn-impl", default="dense",
                    choices=("dense", "flash"))
    ap.add_argument("--head-impl", default="dense",
                    choices=("dense", "chunked"))
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--lr-schedule", default="constant",
                    choices=("constant", "cosine"))
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--label-smoothing", type=float, default=0.0)
    ap.add_argument("--z-loss", type=float, default=0.0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    cfg = ModelConfig(vocab=args.vocab, d_model=args.d_model,
                      n_heads=args.n_heads, n_kv_heads=args.n_kv_heads,
                      n_layers=args.n_layers, d_ff=args.d_ff,
                      max_seq=args.max_seq, pos_emb=args.pos_emb)
    res = fit(cfg, args.data, steps=args.steps, batch=args.batch,
              attn_impl=args.attn_impl, head_impl=args.head_impl,
              accum_steps=args.accum_steps, lr=args.lr,
              lr_schedule=args.lr_schedule,
              warmup_steps=args.warmup_steps,
              label_smoothing=args.label_smoothing, z_loss=args.z_loss,
              checkpoint_dir=args.checkpoint_dir,
              checkpoint_every=args.checkpoint_every, resume=args.resume)
    print(f"done: step {res.step} loss {res.loss:.4f} "
          f"{res.tokens_per_s:.0f} tok/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
