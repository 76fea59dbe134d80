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

ZeRO-1 (``train.opt_state_shardings(..., zero1=True)``): a
:class:`MomentLayout` keeps each moment stacked on a virtual mesh
(``mesh.py``), cut over "dp" as well as by its parameter's spec.
``AdamW.update`` then updates each rank's moment shard against the same
slice of the clipped gradient and gathers the ranks' parameter updates
(``mesh.all_gather``) into the replicated parameters.  Each element goes
through the same operations in the same order as without the layout, so
the two are bit-equal.

On a ``mesh.ProcessMesh`` (one process a rank) a
:class:`ProcessMomentLayout` holds this process's shard of each moment,
ZeRO-1 or not: the clip's norm is the psum over "tp" of the shards'
sums of squares (the leaves whole over "tp" counted once), and under
ZeRO-1 a moment cut over "dp" updates its block of the parameter's shard
and the blocks' updates are gathered over the "dp" line
(``ProcessMesh.all_gather``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from tpu_dra_torch.workloads.mesh import all_gather, axes_of
from tpu_dra_torch.workloads.train import (tree_leaves, tree_like,
                                           tree_unflatten)

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


class MomentLayout:
    """Where ZeRO-1 keeps the moments: each parameter's spec and its
    moment's spec on ``mesh`` (two trees shaped like the parameters, read
    by key).  A moment is stored stacked by its spec (``Mesh.shard``), so
    rank r holds a contiguous 1/dp block of it; the parameters stay
    whole."""

    def __init__(self, mesh, param_specs: dict, moment_specs: dict):
        self.mesh = mesh
        self.param_specs = param_specs
        self.moment_specs = moment_specs

    def specs(self, like) -> list:
        """``(param spec, moment spec)`` of each leaf of ``like``, in its
        ``tree_leaves`` order."""
        return list(zip(tree_leaves(tree_like(like, self.param_specs)),
                        tree_leaves(tree_like(like, self.moment_specs))))

    def cut(self, tree: dict) -> dict:
        """Moments shaped like the step's parameters (fresh zeros) → the
        layout's."""
        return self.shard(tree)

    def sum_squares(self, grads: dict):
        """The clip's squared global norm of a gradient tree: fp32 sums
        of squares, summed leaf by leaf."""
        return sum(g.float().square().sum() for g in tree_leaves(grads))

    def shard(self, tree: dict) -> dict:
        """Global moment tensors → the layout's (after a restore)."""
        return tree_unflatten(tree, [
            self.mesh.shard(t, m)
            for t, (_, m) in zip(tree_leaves(tree), self.specs(tree))])

    def unshard(self, tree: dict) -> dict:
        """Stacked moment tensors → global ones (before a save)."""
        return tree_unflatten(tree, [
            self.mesh.unshard(t, m)
            for t, (_, m) in zip(tree_leaves(tree), self.specs(tree))])

    def rank_update(self, specs: tuple, p, g, mu, nu, moment_fn):
        """A leaf's parameter update: each rank runs ``moment_fn`` on its
        shards of ``p`` and ``g`` and its moment shards (in place), then
        the ranks' updates are gathered over "dp" and put together by the
        parameter's spec.  ``specs`` is the leaf's entry of
        :meth:`specs`."""
        mesh, (p_spec, spec) = self.mesh, specs

        def local(t):
            return mesh.local(t, spec)
        upd = moment_fn(local(mesh.shard(p, spec)),
                        local(mesh.shard(g, spec)), local(mu), local(nu))
        upd = mesh.from_local(upd, spec)
        dims = [d for d, e in enumerate(spec) if "dp" in axes_of(e)]
        if dims:
            n = len(mesh.axes)
            upd = all_gather(upd, mesh.axis_names.index("dp"), n + dims[0])
            spec = p_spec
        return mesh.unshard(upd, spec)


def _dp_dim(spec):
    """The dimension a moment spec cuts over "dp", or None."""
    return next((d for d, e in enumerate(spec) if "dp" in axes_of(e)), None)


class ProcessMomentLayout(MomentLayout):
    """The moments on a ``mesh.ProcessMesh``: each process holds its own
    shard of each moment, cut by the moment's spec.  Without ZeRO-1 that
    is its parameter's spec, so a moment is shaped like the process's
    parameter shard; with it a moment whose spec carries "dp" is the
    process's 1/dp block of that shard along the dimension the spec cuts.
    ``shard`` cuts a checkpoint's global moments (``ProcessMesh.shard``),
    ``unshard`` gathers them on every process (a collective)."""

    def cut(self, tree: dict) -> dict:
        """Moments shaped like this process's parameter shards → its
        moment shards (each cut over "dp" to its block)."""
        out = []
        for t, (_, spec) in zip(tree_leaves(tree), self.specs(tree)):
            d = _dp_dim(spec)
            if d is not None:
                n = t.shape[d] // self.mesh.axis_size("dp")
                t = t.narrow(d, self.mesh.axis_index("dp") * n,
                             n).contiguous()
            out.append(t)
        return tree_unflatten(tree, out)

    def sum_squares(self, grads: dict):
        """The squared global norm from this process's gradient shards:
        the fp32 sum of squares of the leaves cut over "tp", gathered
        over the "tp" line and summed in rank order, plus that of the
        leaves whole over "tp", counted once.  Each batch rank holds the
        same summed gradient, so nothing is summed over the batch axes;
        every process gets the same bits."""
        cut, whole = [], []
        for g, (p_spec, _) in zip(tree_leaves(grads), self.specs(grads)):
            tp = any("tp" in axes_of(e) for e in p_spec)
            (cut if tp else whole).append(g.float().square().sum())
        mine = sum(cut).reshape(1) if cut else \
            torch.zeros(1, device=self.mesh.device)
        return self.mesh.all_gather(mine, "tp", 0).sum() + sum(whole)

    def rank_update(self, specs: tuple, p, g, mu, nu, moment_fn):
        """A leaf's update of this process's parameter shard: where the
        moment is cut over "dp", ``moment_fn`` runs on the moment's block
        of ``p`` and ``g`` and the blocks' fp32 updates are gathered over
        the "dp" line (``ProcessMesh.all_gather``, through host memory
        under gloo); elsewhere it runs on the whole shard."""
        d = _dp_dim(specs[1])
        if d is None:
            return moment_fn(p, g, mu, nu)
        n, start = mu.shape[d], self.mesh.axis_index("dp") * mu.shape[d]
        upd = moment_fn(p.narrow(d, start, n), g.narrow(d, start, n), mu, nu)
        return self.mesh.all_gather(upd, "dp", d)


@dataclass
class AdamWState:
    """Update count (optax's ``count``, 0 before the first update) and
    the two moment trees, shaped like the parameters, or stacked on a
    mesh by ``layout`` (ZeRO-1)."""
    count: int
    mu: dict
    nu: dict
    layout: MomentLayout | None = None

    def to_dict(self) -> dict:
        """``{"count", "mu", "nu"}``: the form a checkpoint stores, with
        the global moment tensors whatever the layout (the reference's
        orbax saves global arrays), so a ZeRO-1 run and a replicated one
        read each other's steps."""
        if self.layout is None:
            return {"count": self.count, "mu": self.mu, "nu": self.nu}
        return {"count": self.count, "mu": self.layout.unshard(self.mu),
                "nu": self.layout.unshard(self.nu)}

    @classmethod
    def from_dict(cls, d: dict,
                  layout: MomentLayout | None = None) -> "AdamWState":
        """The inverse of :meth:`to_dict`: global moments, stacked by
        ``layout`` where one is given."""
        if layout is None:
            return cls(int(d["count"]), d["mu"], d["nu"])
        return cls(int(d["count"]), layout.shard(d["mu"]),
                   layout.shard(d["nu"]), layout)


class OptStateInit:
    """``init_opt_state`` of a step on a mesh: ``init(params)`` is the
    optimizer's fresh state, its moments stacked by ``layout`` under
    ZeRO-1; ``init.restore(d)`` is the state of a checkpoint's
    ``{"count", "mu", "nu"}`` (global moments) in the same layout."""

    def __init__(self, optimizer, layout: MomentLayout | None):
        self.optimizer = optimizer
        self.layout = layout

    def __call__(self, params) -> AdamWState:
        state = self.optimizer.init(params)
        if self.layout is None:
            return state
        return AdamWState(state.count, self.layout.cut(state.mu),
                          self.layout.cut(state.nu), self.layout)

    def restore(self, d: dict) -> AdamWState:
        return AdamWState.from_dict(d, self.layout)


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

    def clip(self, grads: list, sq=None) -> list:
        """``optax.clip_by_global_norm``: unchanged below ``max_norm``,
        else ``(g / g_norm) * max_norm``; decided on the device.  ``sq``
        is the squared global norm where the leaves are shards
        (:meth:`MomentLayout.sum_squares`)."""
        if sq is None:
            sq = sum(g.float().square().sum() for g in grads)
        g_norm = torch.sqrt(sq)
        keep = g_norm < MAX_NORM
        return [torch.where(keep, g, (g / g_norm) * MAX_NORM) for g in grads]

    def update(self, params, grads, state: AdamWState) -> AdamWState:
        """One update of ``params`` (in place) from ``grads``; returns the
        next state (its moment tensors updated in place too).  Under a
        ZeRO-1 ``state.layout`` each rank updates its moment shards and
        the parameter updates are gathered (:meth:`MomentLayout.
        rank_update`); on a process mesh ``params``, ``grads`` and the
        moments are this process's shards (:class:`ProcessMomentLayout`)."""
        count = state.count + 1
        bc1 = _bias_correction(B1, count)
        bc2 = _bias_correction(B2, count)
        step_size = -self.schedule(state.count)

        def moment_fn(p, g, mu, nu):
            mu.mul_(B1).add_((1 - B1) * g)
            nu.mul_(B2).add_((1 - B2) * g.square())
            u = (mu / bc1) / ((nu / bc2).sqrt() + EPS)
            return (u + self.weight_decay * p) * step_size

        layout = state.layout
        specs = layout.specs(params) if layout is not None else None
        sq = layout.sum_squares(grads) if layout is not None else None
        for i, (p, g, mu, nu) in enumerate(zip(
                tree_leaves(params), self.clip(tree_leaves(grads), sq),
                tree_leaves(state.mu), tree_leaves(state.nu))):
            p.add_(moment_fn(p, g, mu, nu) if layout is None
                   else layout.rank_update(specs[i], p, g, mu, nu,
                                           moment_fn))
        return AdamWState(count, state.mu, state.nu, layout)


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
