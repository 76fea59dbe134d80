"""Draft models for speculative decoding, ported from
``tpu_dra/workloads/spec_draft.py``.

The continuous engine takes ``draft=(dcfg, dparams)``; its greedy commit
keeps the plain engine's tokens for any draft, so the draft decides only
the speed, through the share of its proposals the target accepts
(``stats()["spec_accept_rate"]``).  Two constructions, composable:

- ``truncate_draft``: the target's first ``n_layers`` blocks, sharing its
  embedding, positions, final norm and head;
- ``distill_draft``: Adam distillation of the draft against the target's
  logits, KL(target ‖ draft) on token batches drawn from an explicit
  ``torch.Generator``, every second batch re-tokened through the
  target's own argmax.
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Any, Optional

import torch

from tpu_dra_torch.workloads.optim import Adam
from tpu_dra_torch.workloads.train import (
    ModelConfig,
    forward,
    tree_leaves,
    tree_unflatten,
)


def _first_layers(node, n: int):
    return ({k: _first_layers(v, n) for k, v in node.items()}
            if isinstance(node, dict) else node[:n])


def truncate_draft(cfg: ModelConfig, params: dict[str, Any],
                   n_layers: int) -> tuple[ModelConfig, dict[str, Any]]:
    """First-``n_layers`` self-draft: the stacked block weights sliced
    (views of the target's), the embedding, positions, final norm and
    head shared.  Its cost is ~``n_layers / cfg.n_layers`` of the
    target's."""
    if not 1 <= n_layers <= cfg.n_layers:
        raise ValueError(
            f"draft depth {n_layers} must be in [1, {cfg.n_layers}]")
    dparams = dict(params)
    dparams["blocks"] = _first_layers(params["blocks"], n_layers)
    return replace(cfg, n_layers=n_layers), dparams


def _distill_loss(dcfg: ModelConfig, tcfg: ModelConfig, tparams, dparams,
                  tokens):
    """KL(teacher ‖ draft) averaged over positions, from fp32 log-softmaxes;
    the teacher's logits carry no gradient."""
    with torch.no_grad():
        t_logp = torch.log_softmax(forward(tcfg, tparams, tokens).float(),
                                   dim=-1)
    d_logp = torch.log_softmax(forward(dcfg, dparams, tokens).float(), dim=-1)
    return torch.mean(torch.sum(torch.exp(t_logp) * (t_logp - d_logp),
                                dim=-1))


def _distill_step(cfg: ModelConfig, params, dcfg: ModelConfig, dparams,
                  opt: Adam, state, tokens):
    """One Adam step of ``dparams`` (in place) on ``tokens``: returns
    ``(loss, next state)``."""
    live = [p.detach().requires_grad_() for p in tree_leaves(dparams)]
    loss = _distill_loss(dcfg, cfg, params, tree_unflatten(dparams, live),
                         tokens)
    grads = torch.autograd.grad(loss, live)
    with torch.no_grad():
        state = opt.update(dparams, tree_unflatten(dparams, list(grads)),
                           state)
    return loss.detach(), state


def distill_draft(cfg: ModelConfig, params: dict[str, Any],
                  dcfg: ModelConfig, dparams: dict[str, Any], *,
                  steps: int = 200, batch: int = 8,
                  seq: Optional[int] = None, lr: float = 3e-3,
                  seed: int = 0, resample: bool = True,
                  generator: Optional[torch.Generator] = None
                  ) -> dict[str, Any]:
    """Distill ``dparams`` toward the target's distribution with Adam at
    ``lr``, on the device of the draft's weights.

    Each step draws a uniform-random ``[batch, seq]`` token batch from
    ``generator`` (default: one seeded ``seed`` on that device); with
    ``resample`` every second batch is re-tokened through the teacher's
    argmax (``tokens[1:] = argmax(teacher)[:-1]``), so half the training
    mass lies on the continuations speculative decoding verifies.
    Returns NEW fp32 draft params; the inputs are untouched."""
    seq = seq or min(cfg.max_seq, 64)
    dev = params["embed"].device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    # a copy: the truncated draft shares the target's tensors
    dparams = tree_unflatten(dparams, [p.detach().float().clone()
                                       for p in tree_leaves(dparams)])
    opt = Adam(lr)
    state = opt.init(dparams)
    for i in range(steps):
        tokens = torch.randint(0, cfg.vocab, (batch, seq),
                               generator=generator, device=dev)
        if resample and i % 2 == 1:
            with torch.no_grad():
                preds = torch.argmax(forward(cfg, params, tokens), dim=-1)
            tokens = torch.cat([tokens[:, :1], preds[:, :-1]], dim=1)
        _, state = _distill_step(cfg, params, dcfg, dparams, opt, state,
                                 tokens)
    return dparams


def make_draft(cfg: ModelConfig, params: dict[str, Any], *,
               n_layers: Optional[int] = None, distill_steps: int = 200,
               batch: int = 8, seq: Optional[int] = None,
               lr: float = 3e-3, seed: int = 0
               ) -> tuple[ModelConfig, dict[str, Any]]:
    """Truncate (default: quarter depth, at least 1 layer) then distill
    from the fp32 target ``params``."""
    n_layers = n_layers or max(1, cfg.n_layers // 4)
    dcfg, dparams = truncate_draft(cfg, params, n_layers)
    if distill_steps:
        dparams = distill_draft(cfg, params, dcfg, dparams,
                                steps=distill_steps, batch=batch, seq=seq,
                                lr=lr, seed=seed)
    return dcfg, dparams


def measure_accept_rate(cfg: ModelConfig, params, dcfg, dparams, *,
                        prompts: list[list[int]], steps: int = 32,
                        slots: int = 4, chunk: int = 4,
                        max_len: int = 128, device=None) -> dict:
    """Serve ``prompts`` through a speculative ContinuousEngine on
    ``device`` (default: the card) and return its outputs, wall time,
    accept rate, tokens per pass and tokens out."""
    from tpu_dra_torch.workloads.continuous import ContinuousEngine

    eng = ContinuousEngine(cfg, params, slots=slots, chunk=chunk,
                           max_len=max_len, draft=(dcfg, dparams),
                           device=device)
    try:
        t0 = time.perf_counter()
        outs = [eng.submit(p, steps, timeout=600) for p in prompts]
        secs = time.perf_counter() - t0
        st = eng.stats()
    finally:
        eng.shutdown()
    return {"outputs": outs, "secs": secs,
            "accept_rate": st.get("spec_accept_rate", 0.0),
            "tokens_per_pass": st.get("spec_tokens_per_pass", 0.0),
            "tokens_out": st["tokens_out"]}
