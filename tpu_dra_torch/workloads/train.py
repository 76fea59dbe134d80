"""Model core of the decoder-only transformer, ported from
``tpu_dra/workloads/train.py``.

Same parameter layout as the reference: stacked ``[L, ...]`` block
weights, fp32 master copies (bf16 after ``quant.cast_params_bf16`` for
serving), bf16 activations.  The layer loop is a Python loop over the
stacked leading axis where the reference runs ``lax.scan``; remat and the
fused-collective branches of the reference trunk are not ported.

Rounding follows the reference op by op: a Python scalar that multiplies
a bf16 tensor is first rounded to bf16 (JAX's weak typing does that),
matmuls of bf16 operands return bf16, and norms and softmax compute in
fp32 before casting back.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from tpu_dra_torch.workloads.quant import matmul_any


@dataclass(frozen=True)
class ModelConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_seq: int = 128
    # GQA/MQA: number of shared k/v heads (None → MHA, one kv head per q
    # head)
    n_kv_heads: int | None = None
    # "learned" (absolute embedding table) or "rope" (rotary, applied to
    # q/k per head)
    pos_emb: str = "learned"
    rope_base: float = 10000.0
    # share the input embedding with the output head (logits = x·embedᵀ)
    tied_embeddings: bool = False

    def __post_init__(self):
        if self.pos_emb not in ("learned", "rope"):
            raise ValueError(f"unknown pos_emb {self.pos_emb!r}")
        if self.pos_emb == "rope" and self.d_head % 2:
            raise ValueError(
                f"rope needs an even head dim, got d_head {self.d_head}")
        if self.n_kv_heads is not None and self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_kv_heads {self.n_kv_heads} must divide "
                f"n_heads {self.n_heads}")

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def d_kv(self) -> int:
        return self.kv_heads * self.d_head


def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: what a Python scalar becomes when
    JAX multiplies it into an array of that dtype (weak typing).  torch
    keeps the scalar in fp32 for a bf16 op, so the port rounds it first."""
    return float(torch.tensor(value, dtype=dtype))


def init_params(cfg: ModelConfig,
                generator: torch.Generator) -> dict[str, Any]:
    """Stacked-by-layer fp32 params with the reference's shapes and scale
    (normal · d_model^-0.5, norm gains at 1), drawn from ``generator`` on
    its own device.  The numbers differ from ``jax.random``'s; tests carry
    JAX weights across with :mod:`tpu_dra_torch.convert` instead."""
    dev = generator.device
    scale = cfg.d_model ** -0.5
    L = cfg.n_layers

    def norm(shape):
        return torch.randn(shape, generator=generator, device=dev) * scale

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    params: dict[str, Any] = {
        "embed": norm((cfg.vocab, cfg.d_model)),
        "blocks": {
            "wqkv": norm((L, cfg.d_model, cfg.d_model + 2 * cfg.d_kv)),
            "wo": norm((L, cfg.d_model, cfg.d_model)),
            "w1": norm((L, cfg.d_model, cfg.d_ff)),
            "w2": norm((L, cfg.d_ff, cfg.d_model)),
            "ln1": ones((L, cfg.d_model)),
            "ln2": ones((L, cfg.d_model)),
        },
        "ln_f": ones((cfg.d_model,)),
    }
    if not cfg.tied_embeddings:
        params["unembed"] = norm((cfg.d_model, cfg.vocab))
    if cfg.pos_emb == "learned":
        params["pos"] = norm((cfg.max_seq, cfg.d_model))
    return params


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i`` of the stacked block weights (the scan slice)."""
    return {name: leaf[i] for name, leaf in blocks.items()}


def _rmsnorm(x, g):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + 1e-6) * g.float()).to(x.dtype)


def apply_rope(x, positions, base: float = 10000.0):
    """Rotate ``[B, H, S, Dh]`` head vectors by position (RoPE),
    half-split convention: ``(x[:d/2], x[d/2:])`` pairs.  ``positions``
    is int ``[S]`` (shared across the batch) or ``[B, S]``.  Computed in
    fp32, cast back."""
    dh = x.shape[-1]
    half = dh // 2
    inv = base ** (-torch.arange(half, dtype=torch.float32,
                                 device=x.device) / half)
    ang = positions.float()[..., :, None] * inv       # [(B,) S, half]
    if positions.dim() == 2:
        ang = ang[:, None]                 # [B, 1, S, half]: over heads
    sin, cos = torch.sin(ang), torch.cos(ang)
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _causal_dense_attention(q, k, v):
    """Dense causal softmax over ``[B, H, S, D]`` q against
    ``[B, Hkv, S, D]`` k/v; each kv head serves its group of H/Hkv query
    heads through a reshape (no repeat of k/v)."""
    B, H, S, D = q.shape
    hkv = k.shape[1]
    qg = q.reshape(B, hkv, H // hkv, S, D)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg, k) \
        * weak_scalar(D ** -0.5, q.dtype)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    attn = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bksd->bkgqd", attn, v)
    return out.reshape(B, H, S, D)


def _split_heads(cfg: ModelConfig, t, n: int | None = None):
    """``[B, S, n·Dh]`` → ``[B, n, S, Dh]``."""
    B, S = t.shape[:2]
    n = n or cfg.n_heads
    return t.reshape(B, S, n, cfg.d_head).transpose(1, 2)


def _split_qkv(cfg: ModelConfig, qkv):
    """The fused projection's q | k | v column blocks."""
    return torch.split(qkv, [cfg.d_model, cfg.d_kv, cfg.d_kv], dim=-1)


def _attn_sublayer(cfg: ModelConfig, x, layer, positions=None):
    """Pre-norm attention residual sublayer, GQA-aware.  With
    ``pos_emb="rope"`` q/k rotate by ``positions`` (default 0..S-1)."""
    B, S, D = x.shape
    qkv = matmul_any(_rmsnorm(x, layer["ln1"]), layer["wqkv"], x.dtype)
    q, k, v = _split_qkv(cfg, qkv)
    q = _split_heads(cfg, q)
    k = _split_heads(cfg, k, cfg.kv_heads)
    v = _split_heads(cfg, v, cfg.kv_heads)
    if cfg.pos_emb == "rope":
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=x.device)
        q = apply_rope(q, positions, cfg.rope_base)
        k = apply_rope(k, positions, cfg.rope_base)
    out = _causal_dense_attention(q, k, v)
    out = out.transpose(1, 2).reshape(B, S, D)
    return x + matmul_any(out, layer["wo"], x.dtype)


def _mlp(x, layer):
    """Pre-norm gelu MLP residual.  ``jax.nn.gelu`` defaults to the tanh
    approximation, so the port asks for it explicitly."""
    h = matmul_any(_rmsnorm(x, layer["ln2"]), layer["w1"], x.dtype)
    h = F.gelu(h, approximate="tanh")
    return x + matmul_any(h, layer["w2"], x.dtype)


def _block(cfg: ModelConfig, x, layer, positions=None):
    """One decoder block (attention then MLP sublayer)."""
    return _mlp(_attn_sublayer(cfg, x, layer, positions), layer)


def embed_tokens(cfg: ModelConfig, params, tokens, positions=None):
    """bf16 token embeddings (stored in the parameter dtype, cast on
    use), plus the learned position rows at ``positions`` (default
    0..S-1) for ``pos_emb="learned"``."""
    x = params["embed"].to(torch.bfloat16)[tokens]
    if cfg.pos_emb == "learned":
        if positions is None:
            positions = torch.arange(tokens.shape[-1], device=x.device)
        x = x + params["pos"].to(torch.bfloat16)[positions]
    return x


def _trunk(cfg: ModelConfig, params, tokens):
    """Embed + decoder stack; returns pre-final-norm activations."""
    x = embed_tokens(cfg, params, tokens)
    for i in range(cfg.n_layers):
        x = _block(cfg, x, layer_params(params["blocks"], i))
    return x


def head_logits(params, x):
    """Final norm + unembed, fp32 logits.  Tied models (no "unembed")
    project against the input embedding transposed."""
    x = _rmsnorm(x, params["ln_f"])
    if "unembed" not in params:
        e = params["embed"]
        if isinstance(e, dict):
            raise NotImplementedError(
                "tied head over a quantized/wrapped embed is unsupported "
                "— embeddings stay high precision")
        return (x.to(torch.bfloat16) @ e.to(torch.bfloat16).T).float()
    return matmul_any(x, params["unembed"], torch.bfloat16).float()


def forward(cfg: ModelConfig, params, tokens):
    """Logits ``[B, S, vocab]`` for a ``[B, S]`` integer token batch."""
    return head_logits(params, _trunk(cfg, params, tokens))
