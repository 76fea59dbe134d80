"""The Mixture-of-Experts model on one device, ported from
``tpu_dra/workloads/moe.py``: every block's FFN is a bank of experts
behind a router.

The reference's formulation, kept: top-k routing (1 = Switch, 2 =
GShard) with a fixed per-expert **capacity**, so every shape is static;
dispatch and combine are dense one-hots and the layer is three einsums;
the router runs in fp32, the expert matmuls in bf16; tokens over their
expert's capacity are dropped (the residual carries them); the Switch
load-balance loss keeps routing trainable.  Each block is rematerialized
in the backward (``torch.utils.checkpoint``, where the reference wraps
it in ``jax.checkpoint``), so a training step runs each block's forward,
flash kernel included, twice.

Cost of the dense dispatch: the ``[K, N, E, C]`` one-hot is fp32, with
C = capacity_factor·K·N/E slots, so 4·capacity_factor·K²·N² bytes a
layer (0.34 GB at N = 8192 tokens, K = 1; 1.34 GB at K = 2), and the
dispatch and combine einsums each cost N/d_ff of an expert matmul (one
at the flagship's N = d_ff = 8192).  An index-based dispatch would
gather and scatter K·N rows of D instead.

Not ported: ``moe_param_shardings``, ``make_moe_train_step`` and the
expert-parallel mesh (ROADMAP.md queue 1 item 9.4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpu_dra_torch.workloads.train import (
    ModelConfig,
    _attn_sublayer,
    _rmsnorm,
    attn_impl_fn,
    embed_tokens,
    head_logits,
    head_nll,
    layer_params,
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


def init_moe_params(cfg: MoEConfig,
                    generator: torch.Generator) -> dict[str, Any]:
    """``train.init_params`` with every block's FFN an expert bank
    (``wg [L, D, E]``, ``w1 [L, E, D, F]``, ``w2 [L, E, F, D]``): the
    reference's shapes and scale, drawn from ``generator`` on its own
    device (the numbers differ from ``jax.random``'s)."""
    dev = generator.device
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


def moe_ffn(cfg: MoEConfig, x, wg, w1, w2, capacity: int | None = None):
    """Top-k expert FFN.  ``x``: [B, S, D]; ``wg``: [D, E]; ``w1``:
    [E, D, F]; ``w2``: [E, F, D].  Returns ``(out [B, S, D], aux_loss
    scalar)``.  Tokens over their expert's capacity contribute zero.  The
    aux loss is E·Σ_e (fraction of tokens whose FIRST choice, before the
    capacity, is e) × (mean router probability of e)."""
    B, S, D = x.shape
    E = wg.shape[-1]
    N = B * S
    C = capacity if capacity is not None else cfg.capacity(N)
    flat = x.reshape(N, D)
    probs, gates, onehot_k, disp_k = route(cfg, flat, wg, C)
    dispatch = disp_k.sum(0)                                   # [N, E, C]

    d16 = dispatch.to(torch.bfloat16)
    expert_in = torch.einsum("nec,nd->ecd", d16, flat.to(torch.bfloat16))
    h = F.gelu(torch.einsum("ecd,edf->ecf", expert_in,
                            w1.to(torch.bfloat16)), approximate="tanh")
    expert_out = torch.einsum("ecf,efd->ecd", h, w2.to(torch.bfloat16))
    combine = torch.einsum("knec,nk->nec", disp_k,
                           gates).to(torch.bfloat16)           # [N, E, C]
    out = torch.einsum("nec,ecd->nd", combine, expert_out)

    first = onehot_k[:, 0]                                     # [N, E]
    frac = first.sum(0) / torch.clamp(first.sum(), min=1.0)    # [E]
    aux = E * torch.sum(frac * probs.mean(0))
    return out.reshape(B, S, D).to(x.dtype), aux


def _moe_block(cfg: MoEConfig, x, layer, capacity: int | None, attn_fn):
    x = _attn_sublayer(cfg, x, layer, attn_fn)
    h = _rmsnorm(x, layer["ln2"])
    ff, aux = moe_ffn(cfg, h, layer["wg"], layer["w1"], layer["w2"],
                      capacity)
    return x + ff, aux


def _moe_trunk(cfg: MoEConfig, params, tokens, capacity: int | None,
               attn_impl: str = "dense"):
    """Embed + the MoE decoder stack → (pre-final-norm activations,
    Σ aux).  Each block is rematerialized in the backward.  The embedding
    rows come from ``train.embed_tokens`` (fp32 gradient sums, the port's
    departure for the dense model too)."""
    attn_fn = attn_impl_fn(attn_impl)
    x = embed_tokens(cfg, params, tokens)
    aux = x.new_zeros((), dtype=torch.float32)
    for i in range(cfg.n_layers):
        x, a = checkpoint(_moe_block, cfg, x,
                          layer_params(params["blocks"], i), capacity,
                          attn_fn, use_reentrant=False)
        aux = aux + a
    return x, aux


def moe_forward(cfg: MoEConfig, params, tokens,
                capacity: int | None = None):
    """Logits + summed aux loss for a [B, S] integer batch."""
    x, aux = _moe_trunk(cfg, params, tokens, capacity)
    return head_logits(params, x), aux


def moe_loss_fn(cfg: MoEConfig, params, tokens, attn_impl: str = "dense",
                head_impl: str = "dense"):
    """Next-token NLL of a ``[B, S+1]`` batch plus the weighted aux
    loss: the training objective."""
    x, aux = _moe_trunk(cfg, params, tokens[:, :-1], None, attn_impl)
    nll = head_nll(params, x, tokens[:, 1:].long(), head_impl).mean()
    return nll + cfg.aux_loss_weight * aux


def moe_eval_nll(cfg: MoEConfig, params, tokens, attn_impl: str = "dense",
                 head_impl: str = "dense"):
    """Pure next-token NLL (NO aux loss): the eval metric."""
    x, _ = _moe_trunk(cfg, params, tokens[:, :-1], None, attn_impl)
    return head_nll(params, x, tokens[:, 1:].long(), head_impl).mean()


def make_moe_optax_step(cfg: MoEConfig, optimizer=None,
                        attn_impl: str = "dense", head_impl: str = "dense",
                        zero1: bool = False):
    """MoE training on one device with the default optimizer of the
    dense model (AdamW after global-norm clipping): ``(step,
    init_opt_state)`` with ``step(params, opt_state, tokens) -> (params,
    opt_state, loss)``; the optimizer updates ``params`` in place."""
    from tpu_dra_torch.workloads.optim import default_optimizer
    if zero1:
        raise NotImplementedError(
            "zero1 comes with the sharded optimizer step, ROADMAP.md "
            "queue 1 item 9")
    if optimizer is None:
        optimizer = default_optimizer()

    def step(params, opt_state, tokens):
        loss, grads = value_and_grad(
            lambda p, t: moe_loss_fn(cfg, p, t, attn_impl, head_impl),
            params, tokens)
        opt_state = optimizer.update(params, grads, opt_state)
        return params, opt_state, loss

    return step, optimizer.init
