"""End-to-end training loop of the port, ported from
``tpu_dra/workloads/fit.py``: token file → deterministic batches → train
step (AdamW after global-norm clipping) on one device or a virtual mesh
→ periodic checkpoints → exact resume.

    python -m tpu_dra_torch.workloads.fit --data tokens.bin --attn-impl flash

Same flags and defaults as the reference's CLI.  It trains on the card
(``resolve_device``); ``fit(..., device="cpu")`` runs the plain PyTorch
path on the CPU.  Initial weights come from a ``torch.Generator`` seeded
with 0, so they differ from the reference's ``jax.random`` ones.  A
``moe.MoEConfig`` trains the MoE model (``moe.make_moe_optax_step``).

``mesh`` (a ``mesh.Mesh``) trains on a dp×tp mesh through
``train.make_optax_train_step``, or a MoE model on a dp×ep mesh through
``moe.make_moe_optax_step``; ``zero1=True`` shards the AdamW moments over
"dp" there.  Without a mesh the run is the one-device one (the
reference's default mesh puts every local device on "dp"; one card is
dp 1, where ZeRO-1 changes nothing).  A ``mesh.ProcessMesh`` (one
process a rank, every process calling ``fit`` alike) trains the dense
model on its dp×tp axes, or a MoE model on its dp×ep axes (the expert
banks cut over "ep"): each process builds the global init from the
one seed, keeps its shards, reads the same global batches and steps on
its shards; a save gathers the global tree and moments onto rank 0's
host, which writes the files of a replicated run, and every process
reads them back to resume.

Checkpoints (``checkpointing.py``, the port's own format) hold
``{params, extra: {opt_state: {count, mu, nu}, step}}`` with the global
moment tensors, whatever the layout (``optim.AdamWState.to_dict``), as
the reference's orbax saves global arrays: a ZeRO-1 run and a replicated
run resume each other's steps.  ``resume`` restores the newest committed
step and starts the data iterator there, so the resumed run sees the
batches the uninterrupted one would have.

Goodput (``goodput.py``, opt-in through ``TPU_GOODPUT_FILE``): the first
step of a run accrues to ``compile``, every later one to ``step``, and
saves and restores to their segments inside ``checkpointing.py``; a run
that opted in synchronizes the card after each step, so a step's time
holds its device work.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from tpu_dra_torch.device import resolve_device
from tpu_dra_torch.workloads import goodput
from tpu_dra_torch.workloads.checkpointing import (
    latest_step,
    restore_train_state,
    save_train_state,
)
from tpu_dra_torch.workloads.data import TokenDataset, batches, device_prefetch
from tpu_dra_torch.workloads.mesh import ProcessMesh
from tpu_dra_torch.workloads.moe import (
    MoEConfig,
    init_moe_params,
    make_moe_optax_step,
    moe_eval_nll,
)
from tpu_dra_torch.workloads.optim import AdamW, make_schedule
from tpu_dra_torch.workloads.train import (
    ModelConfig,
    init_params,
    loss_fn,
    make_optax_train_step,
    make_train_step,
    tree_leaves,
    tree_unflatten,
)


@dataclass
class FitResult:
    step: int
    loss: float
    losses: list[float]
    tokens_per_s: float


def fit(cfg: ModelConfig, data_path: str, *, mesh=None, steps: int = 100,
        batch: int = 8, lr: float = 3e-4,
        lr_schedule: str = "constant", warmup_steps: int = 0,
        attn_impl: str = "dense", head_impl: str = "dense",
        accum_steps: int = 1, label_smoothing: float = 0.0,
        z_loss: float = 0.0, zero1: bool = False,
        checkpoint_dir: str | None = None, checkpoint_every: int = 0,
        resume: bool = False, log_every: int = 10,
        log_fn: Callable[[str], None] = print, device=None) -> FitResult:
    """Train ``cfg`` on a token file for ``steps`` optimizer steps on one
    device (default: the card), or on ``mesh`` (on its device).

    - ``mesh``: a dp×tp ``mesh.Mesh`` or ``mesh.ProcessMesh`` (dp×ep
      for a ``MoEConfig``; one without "dp" and "ep" raises
      ``ValueError``); the batch must divide by dp × ``accum_steps``.
      ``zero1`` shards the moments over "dp".
    - ``checkpoint_every``: 0 disables; otherwise saves ``{params,
      extra={opt_state, step}}`` to ``checkpoint_dir`` every N steps and
      at the end.  On a ``ProcessMesh`` ``checkpoint_dir`` must be one
      directory that every process sees: rank 0 writes the gathered
      state and every process waits at a group barrier until the step is
      committed.
    - ``resume``: restore the newest committed checkpoint of
      ``checkpoint_dir`` and continue from its step, on the batches and
      the schedule an uninterrupted run would have used.

    ``tokens_per_s`` counts from before the first step, so it includes
    the first step's one-time costs, as the reference's does."""
    is_moe = isinstance(cfg, MoEConfig)
    procs = isinstance(mesh, ProcessMesh)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if is_moe and (accum_steps != 1 or label_smoothing or z_loss):
        raise ValueError(
            "MoE fit supports accum_steps=1 without label smoothing / "
            "z-loss (the MoE step has no microbatch scan)")
    if is_moe and mesh is not None and not {"dp", "ep"} <= set(mesh.axes):
        raise ValueError("MoE fit needs a mesh with 'dp' and 'ep' axes")
    dp = mesh.axis_size("dp") if mesh is not None else 1
    if batch % (dp * accum_steps):
        raise ValueError(f"batch {batch} must be divisible by dp x "
                         f"accum_steps ({dp} x {accum_steps})")
    dev = mesh.device if mesh is not None else resolve_device(device)
    ds = TokenDataset(data_path)
    # the schedule runs on the optimizer's ABSOLUTE update count, which a
    # resume restores: size its horizon from the restored step, or a
    # resumed cosine run would sit at the schedule's end value
    restored = (latest_step(checkpoint_dir) if resume and checkpoint_dir
                else None)
    horizon = steps if restored is None else restored + steps
    optimizer = AdamW(make_schedule(lr, lr_schedule, warmup_steps, horizon))
    if is_moe:
        step_fn, init_opt, p_shard, _ = make_moe_optax_step(
            cfg, mesh, optimizer, attn_impl=attn_impl, head_impl=head_impl,
            zero1=zero1)
    elif mesh is not None:
        step_fn, init_opt, p_shard, _ = make_optax_train_step(
            cfg, mesh, optimizer, attn_impl=attn_impl, head_impl=head_impl,
            accum_steps=accum_steps, label_smoothing=label_smoothing,
            z_loss=z_loss, zero1=zero1)
    else:
        step_fn, init_opt = make_train_step(
            cfg, optimizer, attn_impl=attn_impl, head_impl=head_impl,
            accum_steps=accum_steps, label_smoothing=label_smoothing,
            z_loss=z_loss)

    start = 0
    if restored is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = (init_moe_params if is_moe else init_params)(cfg, gen)
        if procs:                      # this process's shards only
            params = mesh.shard_tree(params, p_shard)
        opt_state = init_opt(params)
    else:
        t0 = time.perf_counter()
        # a process reads the global state on the host and keeps its
        # shards on the card
        state = restore_train_state(checkpoint_dir, step=restored,
                                    device="cpu" if procs else dev)
        params = state["params"]
        if procs:
            params = mesh.shard_tree(params, p_shard)
            params = tree_unflatten(params, [t.to(dev) for t in
                                             tree_leaves(params)])
        opt_state = init_opt.restore(state["extra"]["opt_state"])
        start = int(state["extra"]["step"])
        del state
        log_fn(f"resumed from step {start} (restored in "
               f"{time.perf_counter() - t0:.2f} s)")

    def save(step: int) -> None:
        t0 = time.perf_counter()
        # on a process mesh every process sends its shards to rank 0's
        # host (collectives), rank 0 writes, and the barrier holds the
        # others until it is committed
        if procs:
            tree = mesh.unshard_tree(params, p_shard, "cpu", dst=0)
            state = opt_state.to_dict("cpu", dst=0)
        else:
            tree, state = params, opt_state.to_dict()
        extra = {"opt_state": state, "step": step}
        if not procs or mesh.rank == 0:
            save_train_state(checkpoint_dir, step, tree, extra=extra)
        del tree, state, extra
        if procs:
            dist.barrier(group=mesh.group)
        log_fn(f"checkpoint step {step}: saved in "
               f"{time.perf_counter() - t0:.2f} s")

    it = device_prefetch(batches(ds, batch=batch, seq=cfg.max_seq,
                                 start_step=start), dev)
    losses: list[float] = []
    loss = None
    t0 = time.perf_counter()
    tokens_done = 0
    for step in range(start, start + steps):
        tokens = next(it)
        # the first step carries the first-use costs and is badput; data
        # stalls between steps fall into "blocked"
        seg = goodput.SEG_COMPILE if step == start else goodput.SEG_STEP
        with goodput.measure(seg):
            params, opt_state, loss = step_fn(params, opt_state, tokens)
            # a step's time must hold its device work, but only a run
            # that opted in waits for it: a sync every step would stall
            # the launch queue
            if goodput.default_tracker().started and dev.type == "cuda":
                torch.cuda.synchronize(dev)
        tokens_done += tokens.shape[0] * (tokens.shape[1] - 1)
        if log_every and (step + 1) % log_every == 0:
            lossf = float(loss)
            losses.append(lossf)
            log_fn(f"step {step + 1}: loss {lossf:.4f}")
        if (checkpoint_every and checkpoint_dir
                and (step + 1) % checkpoint_every == 0):
            save(step + 1)
    lossf = float(loss)               # waits for the device's last step
    secs = time.perf_counter() - t0
    if (checkpoint_dir and checkpoint_every
            and latest_step(checkpoint_dir) != start + steps):
        # the final save, unless the periodic one covered the last step
        save(start + steps)
    return FitResult(step=start + steps, loss=lossf, losses=losses,
                     tokens_per_s=tokens_done / max(secs, 1e-9))


def evaluate(cfg: ModelConfig, params, data_path: str, *,
             batches_n: int = 16, batch: int = 8, attn_impl: str = "dense",
             head_impl: str = "dense") -> dict[str, float]:
    """Mean NLL and perplexity over ``batches_n`` deterministic batches at
    the TAIL of the window space (held out until a run wraps the
    dataset), on the device that holds ``params``.  A ``MoEConfig``
    reports the pure NLL, without the load-balance loss."""
    dev = params["ln_f"].device
    eval_fn = moe_eval_nll if isinstance(cfg, MoEConfig) else loss_fn
    ds = TokenDataset(data_path)
    n_windows = (len(ds) - 1) // cfg.max_seq
    tail_step = max(0, n_windows // batch - batches_n)
    it = device_prefetch(batches(ds, batch=batch, seq=cfg.max_seq,
                                 start_step=tail_step), dev)
    total = 0.0
    with torch.no_grad():
        for _ in range(batches_n):
            total += float(eval_fn(cfg, params, next(it), attn_impl,
                                   head_impl))
    nll = total / batches_n
    return {"nll": nll, "perplexity": float(np.exp(nll))}


def main(argv=None):
    """CLI: train the flagship config on a token file on the card.
    ``python -m tpu_dra_torch.workloads.fit --data t.bin``.  Calls
    ``launcher.init_tpu_workload()`` first (the driver's process slot,
    memory budget, priority and heartbeat, ``TPU_TRACEPARENT``,
    ``TPU_GOODPUT_FILE``)."""
    import argparse

    from tpu_dra_torch.workloads.launcher import init_tpu_workload

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
    init_tpu_workload()

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
