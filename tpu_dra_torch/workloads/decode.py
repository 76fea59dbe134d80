"""Decode helpers, ported from ``tpu_dra/workloads/decode.py``: the ones
the paged path and the engine's sampling use.  The slab KV cache and the
slab decoders come with a later slice."""

from __future__ import annotations

import torch

from tpu_dra_torch.workloads.quant import matmul_any
from tpu_dra_torch.workloads.train import (
    ModelConfig,
    _rmsnorm,
    _split_heads,
    _split_qkv,
    apply_rope,
)


def _layer_kv(cfg: ModelConfig, layer, x):
    """k/v heads ``[B, Hkv, S, Dh]`` for a whole ``[B, S, D]`` activation
    block (prefill path).  With rope, keys are stored rotated."""
    h = _rmsnorm(x, layer["ln1"])
    qkv = matmul_any(h, layer["wqkv"], x.dtype)
    _, k, v = _split_qkv(cfg, qkv)
    k = _split_heads(cfg, k, cfg.kv_heads)
    if cfg.pos_emb == "rope":
        k = apply_rope(k, torch.arange(x.shape[1], dtype=torch.int32,
                                       device=x.device), cfg.rope_base)
    return k, _split_heads(cfg, v, cfg.kv_heads)


def _chunk_positions(pos, m: int):
    """``[B, m]`` absolute positions for an m-token chunk starting at
    ``pos`` (``[B]`` tensor)."""
    base = pos.to(torch.int32).reshape(-1, 1)
    return base + torch.arange(m, dtype=torch.int32,
                               device=base.device)[None, :]


def _filter_topk_topp(logits, top_k: int, top_p: float):
    """Mask ``[B, V]`` logits to the top-k / nucleus sets (no-op when both
    are off).  One descending sort serves both filters, and masking by
    rank keeps exactly the contract sets even when logits tie at the
    cutoff."""
    if not top_k and top_p <= 0.0:
        return logits
    sorted_logits, order = torch.sort(logits, dim=-1, descending=True,
                                      stable=True)
    V = logits.shape[-1]
    keep_sorted = torch.ones_like(sorted_logits, dtype=torch.bool)
    if top_k:
        keep_sorted &= torch.arange(V, device=logits.device)[None, :] \
            < top_k
    if top_p > 0.0:
        # nucleus: smallest prefix whose mass reaches top_p (the top
        # token's mass_before is 0 < top_p, so it always survives)
        probs = torch.softmax(sorted_logits.float(), dim=-1)
        mass_before = torch.cumsum(probs, dim=-1) - probs
        keep_sorted &= mass_before < top_p
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
