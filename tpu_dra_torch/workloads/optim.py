"""The optimizer of the training loop: the counterpart of the optax chain
that ``tpu_dra/workloads/fit.py`` builds (93-114) and of
``train.default_optimizer`` (806),

    optax.chain(optax.clip_by_global_norm(1.0),
                optax.adamw(schedule, weight_decay=0.01))

written out rather than taken from ``torch.optim``, so each operation
rounds where optax's does:

- clipping scales by ``max_norm / g_norm`` only when ``g_norm >=
  max_norm``, as ``(g / g_norm) * max_norm`` (``torch.nn.utils.
  clip_grad_norm_`` would scale by ``max_norm / (g_norm + 1e-6)``
  always);
- AdamW: b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias-corrected moments,
  and decoupled weight decay on EVERY leaf (optax's ``adamw`` gets no
  mask, so norm gains and embeddings decay too);
- the learning rate is a schedule of optax's 0-based update count: the
  first update reads ``schedule(0)``.

:class:`Adam` is ``optax.adam`` alone (no clipping, no decay), the
optimizer ``spec_draft.distill_draft`` trains a draft with.

Where optax returns new arrays, ``update`` writes the parameters and
moments in place, so a step holds one copy of them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from tpu_dra_torch.workloads.train import tree_leaves, tree_unflatten

Schedule = Callable[[int], float]

# optax's adamw defaults, and the decay and clip norm fit.py gives them
B1, B2, EPS = 0.9, 0.999, 1e-8
WEIGHT_DECAY = 0.01
MAX_NORM = 1.0


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """``optax.linear_schedule``: from ``init_value`` at count 0 to
    ``end_value`` at ``transition_steps``, flat after."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: linear warmup to
    ``peak_value`` over ``warmup_steps``, then cosine decay to
    ``end_value`` at ``decay_steps`` (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"the cosine decay needs decay_steps > "
                         f"warmup_steps, got {decay_steps} <= "
                         f"{warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return warmup(count)
        t = min(count - warmup_steps, span)
        cosine = 0.5 * (1 + math.cos(math.pi * t / span))
        return peak_value * ((1 - alpha) * cosine + alpha)
    return schedule


def make_schedule(lr: float, lr_schedule: str, warmup_steps: int,
                  horizon: int) -> Schedule:
    """The schedule ``fit`` builds (``fit.py:98-111``): ``"cosine"`` warms
    up over ``max(warmup_steps, 1)`` and decays to 0 at ``max(horizon,
    warmup_steps + 1)``; ``"constant"`` warms up linearly from 0 when
    ``warmup_steps`` is set."""
    if lr_schedule == "cosine":
        return warmup_cosine_decay_schedule(
            0.0, lr, max(warmup_steps, 1), max(horizon, warmup_steps + 1))
    if lr_schedule == "constant":
        return (linear_schedule(0.0, lr, warmup_steps) if warmup_steps
                else constant_schedule(lr))
    raise ValueError(f"unknown lr_schedule {lr_schedule!r}")


@dataclass
class AdamWState:
    """Update count (optax's ``count``, 0 before the first update) and
    the two moment trees, shaped like the parameters."""
    count: int
    mu: dict
    nu: dict

    def to_dict(self) -> dict:
        """``{"count", "mu", "nu"}``: the form a checkpoint stores."""
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    @classmethod
    def from_dict(cls, d: dict) -> "AdamWState":
        return cls(int(d["count"]), d["mu"], d["nu"])


def _bias_correction(decay: float, count: int) -> float:
    """``1 − decay^count`` in fp32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class AdamW:
    """Global-norm clipping at MAX_NORM, then AdamW (B1, B2, EPS) with
    decoupled ``weight_decay`` at ``learning_rate``: a float or a schedule
    of the 0-based update count.  The default decay, WEIGHT_DECAY, is the
    chain ``fit`` trains with; ``optax.adamw``'s own default is 1e-4 (the
    LoRA step's, ``lora.LORA_WEIGHT_DECAY``)."""

    def __init__(self, learning_rate: float | Schedule = 3e-4,
                 weight_decay: float = WEIGHT_DECAY):
        self.schedule = (learning_rate if callable(learning_rate)
                         else constant_schedule(learning_rate))
        self.weight_decay = weight_decay

    def init(self, params) -> AdamWState:
        zeros = [torch.zeros_like(p) for p in tree_leaves(params)]
        return AdamWState(0, tree_unflatten(params, zeros),
                          tree_unflatten(params, [z.clone() for z in zeros]))

    def clip(self, grads: list) -> list:
        """``optax.clip_by_global_norm``: unchanged below ``max_norm``,
        else ``(g / g_norm) * max_norm``; decided on the device."""
        g_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        keep = g_norm < MAX_NORM
        return [torch.where(keep, g, (g / g_norm) * MAX_NORM) for g in grads]

    def update(self, params, grads, state: AdamWState) -> AdamWState:
        """One update of ``params`` (in place) from ``grads``; returns the
        next state (its moment tensors updated in place too)."""
        count = state.count + 1
        bc1 = _bias_correction(B1, count)
        bc2 = _bias_correction(B2, count)
        step_size = -self.schedule(state.count)
        for p, g, mu, nu in zip(tree_leaves(params),
                                self.clip(tree_leaves(grads)),
                                tree_leaves(state.mu), tree_leaves(state.nu)):
            mu.mul_(B1).add_((1 - B1) * g)
            nu.mul_(B2).add_((1 - B2) * g.square())
            u = (mu / bc1) / ((nu / bc2).sqrt() + EPS)
            p.add_((u + self.weight_decay * p) * step_size)
        return AdamWState(count, state.mu, state.nu)


class Adam:
    """``optax.adam(learning_rate)``: B1, B2, EPS, bias-corrected
    moments, no clipping and no weight decay, each operation rounding
    where optax's does."""

    def __init__(self, learning_rate: float = 1e-3):
        self.learning_rate = learning_rate

    init = AdamW.init

    def update(self, params, grads, state: AdamWState) -> AdamWState:
        """One update of ``params`` (in place) from ``grads``; returns the
        next state (its moment tensors updated in place too)."""
        count = state.count + 1
        bc1 = _bias_correction(B1, count)
        bc2 = _bias_correction(B2, count)
        for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(state.mu), tree_leaves(state.nu)):
            mu.mul_(B1).add_((1 - B1) * g)
            nu.mul_(B2).add_((1 - B2) * g.square())
            p.add_(((mu / bc1) / ((nu / bc2).sqrt() + EPS))
                   * -self.learning_rate)
        return AdamWState(count, state.mu, state.nu)


def default_optimizer() -> AdamW:
    """``train.default_optimizer``: clip 1.0, AdamW 3e-4, decay 0.01."""
    return AdamW(3e-4)
