"""Weight and KV-cache forms, ported from ``tpu_dra/workloads/quant.py``:
only what the paged serving path reads.

The reference's ``matmul_any`` also dispatches int8 (``{"q8", "s"}``),
group-scaled int4 (``{"q4", "s4"}``) and LoRA-wrapped leaves; those weight
forms come with a later slice of the port.
"""

from __future__ import annotations

import torch


def quantize_kv(t):
    """``[..., m, Dh]`` k/v → ``(int8 [..., m, Dh], fp32 scales
    [..., m, 1])`` with symmetric per-position scales (amax / 127)."""
    tf = t.float()
    amax = tf.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(tf / s), -127, 127).to(torch.int8)
    return q, s


def matmul_any(x, w, dtype=None):
    """``x @ w`` with the weight cast to ``dtype`` (default: x's dtype);
    the result takes the promoted dtype of the two, as ``jnp`` does."""
    if isinstance(w, dict):
        raise NotImplementedError(
            "int8, int4 and LoRA weight leaves are not ported yet: they "
            "come with the quantized-weights slice of the PyTorch port; "
            "serve bf16 weights (cast_params_bf16) meanwhile")
    out_dtype = dtype or x.dtype
    dt = torch.promote_types(x.dtype, out_dtype)
    return x.to(dt) @ w.to(dt)


def cast_params_bf16(params: dict) -> dict:
    """Serving cast: every floating leaf → bf16 (norm gains included —
    rmsnorm upcasts to fp32 internally)."""
    def cast(leaf):
        if isinstance(leaf, dict):
            return {k: cast(v) for k, v in leaf.items()}
        if torch.is_tensor(leaf) and leaf.is_floating_point():
            return leaf.to(torch.bfloat16)
        return leaf
    return cast(params)
