"""The Mixture-of-Experts model on one device, ported from
``tpu_dra/workloads/moe.py``: every block's FFN is a bank of experts
behind a router.

The reference's formulation, kept: top-k routing (1 = Switch, 2 =
GShard) with a fixed per-expert **capacity**, so every shape is static;
dispatch and combine are dense one-hots and the layer is three einsums;
the router runs in fp32, the expert matmuls in bf16; tokens over their
expert's capacity are dropped (the residual carries them); the Switch
load-balance loss keeps routing trainable.  Each block is rematerialized
in the backward (``train.remat``, where the reference wraps it in
``jax.checkpoint``), so a training step runs each block's forward,
flash kernel included, twice.

Cost of the dense dispatch: the ``[K, N, E, C]`` one-hot is fp32, with
C = capacity_factor·K·N/E slots, so 4·capacity_factor·K²·N² bytes a
layer (0.34 GB at N = 8192 tokens, K = 1; 1.34 GB at K = 2), and the
dispatch and combine einsums each cost N/d_ff of an expert matmul (one
at the flagship's N = d_ff = 8192).  An index-based dispatch would
gather and scatter K·N rows of D instead.

Expert parallelism (``moe_param_shardings``, ``make_moe_train_step``,
``make_moe_optax_step`` on a ``{"dp", "ep"}`` virtual mesh, ``mesh.py``):
the expert banks are stacked over "ep", ``[ep, E/ep, D, F]`` a layer, and
each rank computes its experts' rows of the dispatch; the ranks' partial
outputs are summed (``mesh.psum``), where the reference's
``_ep_constraint`` (162-168) lets GSPMD place the all-to-all.  The router
stays the one-device :func:`route` over the whole batch, so the mesh step
routes every token as the one-device step does, up to near-ties
(:class:`PinnedChoices` replays them); the rest of the block, whose
parameters replicate, is the one-device computation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from tpu_dra_torch.workloads.mesh import psum, refuse_process_mesh
from tpu_dra_torch.workloads.train import (
    ModelConfig,
    _attn_sublayer,
    _rmsnorm,
    attn_impl_fn,
    embed_tokens,
    head_logits,
    head_nll,
    layer_params,
    remat,
    value_and_grad,
)


@dataclass(frozen=True)
class MoEConfig(ModelConfig):
    n_experts: int = 8
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2
    # experts per token: 1 = Switch, 2 = GShard-style top-2 (gates
    # renormalized over the selected pair; capacity scales with k)
    router_top_k: int = 1

    def __post_init__(self):
        super().__post_init__()
        if self.tied_embeddings:
            raise NotImplementedError(
                "tied_embeddings is not wired through init_moe_params "
                "(it would be silently ignored)")
        if not 1 <= self.router_top_k <= self.n_experts:
            raise ValueError(
                f"router_top_k={self.router_top_k} must be in "
                f"[1, n_experts={self.n_experts}]")

    def capacity(self, n_tokens: int) -> int:
        # k routed copies of every token share the expert banks
        return max(1, int(self.capacity_factor * self.router_top_k *
                          n_tokens / self.n_experts))


def init_moe_params(cfg: MoEConfig, generator: torch.Generator,
                    device=None) -> dict[str, Any]:
    """``train.init_params`` with every block's FFN an expert bank
    (``wg [L, D, E]``, ``w1 [L, E, D, F]``, ``w2 [L, E, F, D]``): the
    reference's shapes and scale, drawn from ``generator`` on its own
    device or on ``device`` (the numbers differ from ``jax.random``'s)."""
    dev = generator.device if device is None else torch.device(device)
    scale = cfg.d_model ** -0.5
    L, E, D = cfg.n_layers, cfg.n_experts, cfg.d_model

    def norm(shape):
        return torch.randn(shape, generator=generator, device=dev) * scale

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    params: dict[str, Any] = {
        "embed": norm((cfg.vocab, D)),
        "blocks": {
            "wqkv": norm((L, D, D + 2 * cfg.d_kv)),
            "wo": norm((L, D, D)),
            "wg": norm((L, D, E)),
            "w1": norm((L, E, D, cfg.d_ff)),
            "w2": norm((L, E, cfg.d_ff, D)),
            "ln1": ones((L, D)),
            "ln2": ones((L, D)),
        },
        "ln_f": ones((D,)),
        "unembed": norm((D, cfg.vocab)),
    }
    if cfg.pos_emb == "learned":
        params["pos"] = norm((cfg.max_seq, D))
    return params


def _top_k(probs, k: int):
    """The router's choice: ``torch.topk`` over the experts (values,
    indices), replaced by :class:`PinnedChoices` while it replays."""
    return torch.topk(probs, k, dim=-1)


class PinnedChoices:
    """Record the router's top-k choices of one pass, then replay them in
    the next, so that two passes that part only by rounding (flash against
    dense attention) route every token alike and can be held to a
    gradient tolerance.  Unpinned, a near-tie that the two roundings
    break differently sends a token to another expert: on the CPU the
    reference's own flash and dense steps part by 7-17% relative L2 per
    gradient leaf (median) that way.  A harness for one thread:

        with PinnedChoices() as pin:
            a = value_and_grad(flash step)
            pin.replay()
            b = value_and_grad(dense step)

    Calls pair by order (a block's remat calls the router again in the
    backward, in the same order in both passes); the replayed values are
    the probabilities this pass gives the recorded experts."""

    def __init__(self):
        self.recorded: list = []
        self.replayed: int | None = None      # None while recording

    def _choose(self, probs, k: int):
        if self.replayed is None:
            vals, idx = torch.topk(probs, k, dim=-1)
            self.recorded.append(idx)
            return vals, idx
        if self.replayed == len(self.recorded):
            raise RuntimeError("the replaying pass called the router more "
                               "times than the recorded one")
        idx = self.recorded[self.replayed]
        self.replayed += 1
        return probs.gather(-1, idx), idx

    def replay(self) -> None:
        self.replayed = 0

    def __enter__(self):
        global _top_k
        self._saved, _top_k = _top_k, self._choose
        return self

    def __exit__(self, *exc):
        global _top_k
        _top_k = self._saved


def route(cfg: MoEConfig, flat, wg, capacity: int):
    """The router of :func:`moe_ffn` for ``flat [N, D]``: ``(probs [N, E]
    fp32, gates [N, K], onehot_k [N, K, E], disp_k [K, N, E, C])``.
    ``disp_k[k, n, e, c]`` is 1 where token n's k-th choice e holds slot
    c; slots are claimed choice-major (every first choice before any
    second), and a choice past the capacity holds none."""
    E = wg.shape[-1]
    N, K = flat.shape[0], cfg.router_top_k
    probs = torch.softmax(flat.float() @ wg.float(), dim=-1)
    topk_probs, topk_idx = _top_k(probs, K)                    # [N, K]
    if K == 1:
        gates = topk_probs        # Switch: the RAW router prob scales the
        #                           expert output (a learning signal)
    else:
        gates = topk_probs / torch.clamp(
            topk_probs.sum(-1, keepdim=True), min=1e-9)        # GShard pair
    onehot_k = F.one_hot(topk_idx, E).float()                  # [N, K, E]
    flat_oh = onehot_k.transpose(0, 1).reshape(K * N, E)
    pos = (torch.cumsum(flat_oh, dim=0) - 1.0) * flat_oh       # [KN, E]
    keep = flat_oh * (pos < capacity)
    # a position past the capacity one-hots to no slot (jax.nn.one_hot)
    slot = (pos.sum(-1).long()[:, None] == torch.arange(
        capacity, device=flat.device)).float()                 # [KN, C]
    disp_k = (keep[:, :, None] * slot[:, None, :]).reshape(K, N, E,
                                                           capacity)
    return probs, gates, onehot_k, disp_k


def _ep_experts(mesh, dispatch, combine, flat, w1, w2):
    """The expert FFN on banks stacked over "ep": ``w1 [E, D, F]`` and
    ``w2 [E, F, D]`` are cut by :func:`moe_param_shardings`' spec into
    ``[ep, E/ep, ...]``, rank r takes the dispatch rows of its E/ep
    experts, and the ranks' bf16 partial outputs (each rank's combine
    over its experts' slots, as GSPMD partitions the reference's einsum)
    are summed over the ranks in fp32 and rounded to bf16 once."""
    spec = ("ep", None, None)     # a layer of moe_param_shardings' banks
    ep = mesh.axis_size("ep")
    N, E, C = dispatch.shape

    def bank(w):                                  # [ep, E/ep, ...]
        return mesh.local(mesh.shard(w.to(torch.bfloat16), spec), spec)

    def ranks(t):                                 # [N, ep, E/ep, C]
        return t.reshape(N, ep, E // ep, C)
    expert_in = torch.einsum("nrec,nd->recd", ranks(dispatch),
                             flat.to(torch.bfloat16))
    h = F.gelu(torch.einsum("recd,redf->recf", expert_in, bank(w1)),
               approximate="tanh")
    expert_out = torch.einsum("recf,refd->recd", h, bank(w2))
    part = torch.einsum("nrec,recd->rnd", ranks(combine), expert_out)
    return psum(part.float(), 0)[0].to(torch.bfloat16)


def moe_ffn(cfg: MoEConfig, x, wg, w1, w2, capacity: int | None = None,
            mesh=None):
    """Top-k expert FFN.  ``x``: [B, S, D]; ``wg``: [D, E]; ``w1``:
    [E, D, F]; ``w2``: [E, F, D].  Returns ``(out [B, S, D], aux_loss
    scalar)``.  Tokens over their expert's capacity contribute zero.  The
    aux loss is E·Σ_e (fraction of tokens whose FIRST choice, before the
    capacity, is e) × (mean router probability of e).  A ``mesh`` with
    an "ep" axis runs the experts on its ranks (:func:`_ep_experts`)."""
    B, S, D = x.shape
    E = wg.shape[-1]
    N = B * S
    C = capacity if capacity is not None else cfg.capacity(N)
    flat = x.reshape(N, D)
    probs, gates, onehot_k, disp_k = route(cfg, flat, wg, C)
    dispatch = disp_k.sum(0)                                   # [N, E, C]

    d16 = dispatch.to(torch.bfloat16)
    combine = torch.einsum("knec,nk->nec", disp_k,
                           gates).to(torch.bfloat16)           # [N, E, C]
    if mesh is not None and "ep" in mesh.axes:
        out = _ep_experts(mesh, d16, combine, flat, w1, w2)
    else:
        expert_in = torch.einsum("nec,nd->ecd", d16,
                                 flat.to(torch.bfloat16))
        h = F.gelu(torch.einsum("ecd,edf->ecf", expert_in,
                                w1.to(torch.bfloat16)), approximate="tanh")
        expert_out = torch.einsum("ecf,efd->ecd", h, w2.to(torch.bfloat16))
        out = torch.einsum("nec,ecd->nd", combine, expert_out)

    first = onehot_k[:, 0]                                     # [N, E]
    frac = first.sum(0) / torch.clamp(first.sum(), min=1.0)    # [E]
    aux = E * torch.sum(frac * probs.mean(0))
    return out.reshape(B, S, D).to(x.dtype), aux


def _moe_block(cfg: MoEConfig, x, layer, capacity: int | None, attn_fn,
               mesh=None):
    x = _attn_sublayer(cfg, x, layer, attn_fn)
    h = _rmsnorm(x, layer["ln2"])
    ff, aux = moe_ffn(cfg, h, layer["wg"], layer["w1"], layer["w2"],
                      capacity, mesh)
    return x + ff, aux


def _moe_trunk(cfg: MoEConfig, params, tokens, capacity: int | None,
               attn_impl: str = "dense", mesh=None):
    """Embed + the MoE decoder stack → (pre-final-norm activations,
    Σ aux).  Each block is rematerialized in the backward.  The embedding
    rows come from ``train.embed_tokens`` (fp32 gradient sums, the port's
    departure for the dense model too)."""
    attn_fn = attn_impl_fn(attn_impl)
    x = embed_tokens(cfg, params, tokens)
    aux = x.new_zeros((), dtype=torch.float32)
    for i in range(cfg.n_layers):
        x, a = remat(_moe_block, cfg, x, layer_params(params["blocks"], i),
                     capacity, attn_fn, mesh)
        aux = aux + a
    return x, aux


def moe_forward(cfg: MoEConfig, params, tokens,
                capacity: int | None = None, mesh=None):
    """Logits + summed aux loss for a [B, S] integer batch."""
    x, aux = _moe_trunk(cfg, params, tokens, capacity, mesh=mesh)
    return head_logits(params, x), aux


def moe_loss_fn(cfg: MoEConfig, params, tokens, attn_impl: str = "dense",
                head_impl: str = "dense", mesh=None):
    """Next-token NLL of a ``[B, S+1]`` batch plus the weighted aux
    loss: the training objective."""
    x, aux = _moe_trunk(cfg, params, tokens[:, :-1], None, attn_impl, mesh)
    nll = head_nll(params, x, tokens[:, 1:].long(), head_impl).mean()
    return nll + cfg.aux_loss_weight * aux


def moe_eval_nll(cfg: MoEConfig, params, tokens, attn_impl: str = "dense",
                 head_impl: str = "dense", mesh=None):
    """Pure next-token NLL (NO aux loss): the eval metric."""
    x, _ = _moe_trunk(cfg, params, tokens[:, :-1], None, attn_impl, mesh)
    return head_nll(params, x, tokens[:, 1:].long(), head_impl).mean()


def moe_param_shardings(cfg: MoEConfig, mesh) -> dict[str, Any]:
    """Expert banks over "ep" on their expert axis, everything else
    replicated (``moe.moe_param_shardings``, 220-239), one spec a leaf."""
    out: dict[str, Any] = {
        "embed": (),
        "blocks": {
            "wqkv": (), "wo": (), "wg": (),
            "w1": (None, "ep", None, None),
            "w2": (None, "ep", None, None),
            "ln1": (), "ln2": (),
        },
        "ln_f": (),
        "unembed": (),
    }
    if cfg.pos_emb == "learned":
        out["pos"] = ()
    return out


def _ep_mesh(cfg: MoEConfig, mesh) -> tuple:
    """``(p_shard, t_shard)`` of a step on ``mesh``, after the reference's
    check that "ep" splits the experts."""
    ep = mesh.axis_size("ep")
    if cfg.n_experts % ep:
        raise ValueError(f"n_experts={cfg.n_experts} not divisible by "
                         f"ep={ep}")
    return moe_param_shardings(cfg, mesh), ("dp", None)


def make_moe_optax_step(cfg: MoEConfig, mesh=None, optimizer=None,
                        attn_impl: str = "dense", head_impl: str = "dense",
                        zero1: bool = False):
    """MoE training with the default optimizer of the dense model (AdamW
    after global-norm clipping), the expert-parallel sibling of
    ``train.make_optax_train_step`` (``moe.make_moe_optax_step``,
    242-282): ``(step, init_opt_state, p_shard, t_shard)`` with
    ``step(params, opt_state, tokens) -> (params, opt_state, loss)``; the
    optimizer updates ``params`` in place.  On a ``{"dp", "ep"}`` mesh
    the experts run on its ranks and the moments take their parameters'
    specs (``train.opt_state_shardings``; ``zero1`` shards them over "dp"
    too, bit-equal to the replicated update).  ``mesh=None`` is the one
    device (no specs; ``zero1`` has no "dp" to use)."""
    refuse_process_mesh(mesh, "make_moe_optax_step")
    from tpu_dra_torch.workloads.optim import OptStateInit, default_optimizer
    from tpu_dra_torch.workloads.train import (opt_state_shardings,
                                               param_shapes, tree_leaves)
    if optimizer is None:
        optimizer = default_optimizer()
    p_shard = t_shard = None
    init_opt_state = OptStateInit(optimizer, None)
    if mesh is not None:
        p_shard, t_shard = _ep_mesh(cfg, mesh)
        _, init_opt_state = opt_state_shardings(
            optimizer, param_shapes(cfg, init_moe_params), p_shard, mesh,
            zero1=zero1)

    def step(params, opt_state, tokens):
        if mesh is not None:
            mesh.check_device(tokens, *tree_leaves(params))
        loss, grads = value_and_grad(
            lambda p, t: moe_loss_fn(cfg, p, t, attn_impl, head_impl, mesh),
            params, tokens)
        opt_state = optimizer.update(params, grads, opt_state)
        return params, opt_state, loss

    return step, init_opt_state, p_shard, t_shard


def make_moe_train_step(cfg: MoEConfig, mesh, lr: float = 1e-2,
                        attn_impl: str = "dense", head_impl: str = "dense"):
    """The MoE SGD step over ``mesh`` (axes "dp", "ep";
    ``moe.make_moe_train_step``, 285-307): ``(step, p_shard, t_shard)``
    with ``step(params, tokens) -> (params, loss)`` on the mesh's device.
    ``ValueError`` unless ``cfg.n_experts % ep == 0``."""
    refuse_process_mesh(mesh, "make_moe_train_step")
    from tpu_dra_torch.workloads.train import tree_leaves, tree_unflatten
    p_shard, t_shard = _ep_mesh(cfg, mesh)

    def step(params, tokens):
        mesh.check_device(tokens, *tree_leaves(params))
        loss, grads = value_and_grad(
            lambda p, t: moe_loss_fn(cfg, p, t, attn_impl, head_impl, mesh),
            params, tokens)
        new = [p.detach() - lr * g for p, g in zip(tree_leaves(params),
                                                   tree_leaves(grads))]
        return tree_unflatten(params, new), loss

    return step, p_shard, t_shard
