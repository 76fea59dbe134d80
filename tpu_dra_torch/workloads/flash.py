"""Flash attention, ported from the flash part of
``tpu_dra/workloads/pallas_kernels.py``.

What maps to what:

- ``flash_attn_fwd_ref`` / ``flash_attn_fwd`` ↔ ``_flash_attn_fwd``
  (315-364) with its kernels ``_flash_attn_kernel`` (151-200) and, for
  GQA, ``_flash_attn_fwd_gqa`` / ``_flash_attn_gqa_kernel`` (221-312);
- ``flash_attn_bwd_ref`` / ``flash_attn_bwd`` ↔ ``_flash_attn_bwd``
  (543-703) with ``bwd_impl="split"``: the dQ kernel
  ``_flash_bwd_dq_kernel`` (367-417), the dK/dV kernel
  ``_flash_bwd_dkdv_kernel`` (453-491) and the GQA group sum
  ``_group_sum_kv`` (706-714);
- ``FlashAttention`` ↔ the ``custom_vjp`` ``_flash_attn`` (730-752);
- ``flash_attention`` ↔ the front door ``flash_attention`` (821) and
  ``_validate_and_fold`` (782-796).

Layouts are the reference's: ``[BH, S, D]`` bf16 q against
``[BHkv, Sk, D]`` k/v, where q rows ``b·g … (b+1)·g−1`` share kv row
``b``; ``l2`` is the per-row base-2 logsumexp ``[BH, S, 1]`` fp32.

CPU tensors take the plain versions.  CUDA tensors launch the
hand-written kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) or
raise; each launch adds one to the launching wrapper's ``launches``.
The port reads no ``flash_tune.json``: block sizes are the kernels' own,
and the kernels mask a ragged sequence tail themselves, so the TPU's
tile padding in ``train._flash_attention_fn`` is not needed.

Rounding points of the reference, kept by the plain versions and the
kernels alike: q is pre-scaled by ``D^-0.5·log2e`` (the scalar rounded to
bf16 by JAX's weak typing) and rounded to bf16; scores accumulate in
fp32 and the softmax runs in base 2; ``p`` is rounded to bf16 before
P·V while ``l`` sums the unrounded ``p``; ``l`` is clamped to 1e-30 so a
fully masked row gives 0; in the backward ``dS`` is rounded to bf16
before both of its products, dK's ``1/log2e`` and dQ's ``D^-0.5`` scale
the fp32 accumulators, and GQA's per-q-head dK/dV are rounded to bf16
and then group-summed in fp32.
"""

from __future__ import annotations

import torch

from tpu_dra_torch.workloads.train import weak_scalar

_LOG2E = 1.4426950408889634
_NEG = torch.finfo(torch.float32).min
HEAD_DIMS = (64, 128)

# A kernel against its plain version (chip_smoke.py, tests/test_torch_cuda
# .py): elementwise |got - want| <= ELEM_TOL + ELEM_TOL * |want| (four bf16
# ulps), and each head-row within ROW_TOL by :func:`row_rel_err`.  From
# the worst errors on an H100 80GB HBM3 at 700 W over the path's shapes
# and 40 edge cases (PERF.md §6): elementwise at most 0.35 of ELEM_TOL; per head-row out
# 0.0018 (the kernel rounds p against the running row max, the plain
# version against the final one) and the gradients 0.00096, so ROW_TOL is
# 5.5x and 3x the worst seen.
ELEM_TOL = 2 ** -6
ROW_TOL = {"out": 0.01, "dq": 0.003, "dk": 0.003, "dv": 0.003}
L2_ATOL = 1e-4


def row_rel_err(got, want, atol: float = ELEM_TOL):
    """Relative L2 error of each head-row (leading index) ``||got −
    want|| / (||want|| + atol·√n)``, fp32.  ``atol`` per element floors
    the denominator, so a row whose values are all ~0 (dq at S = 1) is
    held to its absolute error."""
    g = got.float().flatten(1)
    w = want.float().flatten(1)
    return (g - w).norm(dim=1) / (w.norm(dim=1) + atol * g.shape[1] ** 0.5)


def _prescale(q):
    """q in base-2 log space: ``q · D^-0.5·log2e``, rounded to bf16."""
    return q * weak_scalar(q.shape[-1] ** -0.5 * _LOG2E, q.dtype)


def _shapes(q, k, v, causal: bool):
    """``(bh, s, d, bhkv, sk, g)``; raises on shapes no flash path
    takes."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"flash attention takes q [BH, S, D] and k/v "
                         f"[BHkv, Sk, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, d = q.shape
    bhkv, sk, dk = k.shape
    if dk != d:
        raise ValueError(f"q and k/v head dims differ: {d} vs {dk}")
    if bh % bhkv:
        raise ValueError(f"q heads {bh} not a multiple of kv heads {bhkv}")
    if causal and sk != s:
        raise ValueError(f"causal flash attention requires equal q/k "
                         f"lengths, got q seq {s} vs k seq {sk}")
    return bh, s, d, bhkv, sk, bh // bhkv


def _causal_keep(s: int, sk: int, device):
    """Start-aligned causal mask ``rows >= cols`` ``[s, sk]``."""
    rows = torch.arange(s, device=device)[:, None]
    return rows >= torch.arange(sk, device=device)[None, :]


def flash_attn_fwd_ref(q, k, v, causal: bool = True):
    """Plain version of the forward: ``(out bf16 [BH, S, D], l2 fp32
    [BH, S, 1])``, whole rows at once (the kernels stream k tiles with an
    online softmax; the two agree up to where ``p`` is rounded)."""
    bh, s, d, bhkv, sk, g = _shapes(q, k, v, causal)
    qs = _prescale(q).float().reshape(bhkv, g, s, d)
    scores = qs @ k.float()[:, None].transpose(-1, -2)      # [bhkv,g,s,sk]
    if causal:
        keep = _causal_keep(s, sk, q.device)
        scores = scores.masked_fill(~keep, _NEG)
    m = scores.amax(dim=-1, keepdim=True)
    # a row masked everywhere must not gain weight from exp2(neg - neg)
    safe_m = torch.where(m == _NEG, torch.zeros_like(m), m)
    p = torch.exp2(scores - safe_m)
    if causal:
        p = p.masked_fill(~keep, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = p.to(torch.bfloat16).float() @ v.float()[:, None]
    out = (acc / l).to(q.dtype).reshape(bh, s, d)
    return out, (m + torch.log2(l)).reshape(bh, s, 1)


def _bwd_probs(qs, k, l2, causal: bool):
    """The backward's recomputed ``P = exp2(qs·kᵀ − l2)`` ``[BHkv, g, S,
    Sk]`` fp32, 0 where masked."""
    bh, s, d = qs.shape
    bhkv, sk = k.shape[:2]
    p = torch.exp2(qs.float().reshape(bhkv, bh // bhkv, s, d)
                   @ k.float()[:, None].transpose(-1, -2)
                   - l2.reshape(bhkv, bh // bhkv, s, 1))
    if causal:
        p = p.masked_fill(~_causal_keep(s, sk, qs.device), 0.0)
    return p


def _bwd_ds(p, v, dout, dd):
    """``dS = P∘(dO·Vᵀ − dd)``, rounded to bf16 (kept in fp32 storage)."""
    bhkv, g, s, _ = p.shape
    do = dout.float().reshape(bhkv, g, s, -1)
    dp = do @ v.float()[:, None].transpose(-1, -2)
    return (p * (dp - dd.reshape(bhkv, g, s, 1))).to(torch.bfloat16).float()


def flash_bwd_dq_ref(qs, k, v, dout, l2, dd, causal: bool = True):
    """Plain version of the dQ kernel: ``dq = (dS·K)·D^-0.5`` bf16
    ``[BH, S, D]`` from the pre-scaled ``qs``, ``l2`` and ``dd``."""
    bh, s, d, bhkv, sk, g = _shapes(qs, k, v, causal)
    ds = _bwd_ds(_bwd_probs(qs, k, l2, causal), v, dout, dd)
    dq = (ds @ k.float()[:, None]) * d ** -0.5
    return dq.to(qs.dtype).reshape(bh, s, d)


def flash_bwd_dkdv_ref(qs, k, v, dout, l2, dd, causal: bool = True):
    """Plain version of the dK/dV kernel: per-q-head ``dk = (dSᵀ·qs) /
    log2e`` and ``dv = bf16(P)ᵀ·dO``, bf16 ``[BH, Sk, D]``."""
    bh, s, d, bhkv, sk, g = _shapes(qs, k, v, causal)
    p = _bwd_probs(qs, k, l2, causal)
    do = dout.float().reshape(bhkv, g, s, d)
    dv = p.to(torch.bfloat16).float().transpose(-1, -2) @ do
    ds = _bwd_ds(p, v, dout, dd)
    dk = (ds.transpose(-1, -2) @ qs.float().reshape(bhkv, g, s, d)) \
        * (1.0 / _LOG2E)
    return (dk.to(k.dtype).reshape(bh, sk, d),
            dv.to(v.dtype).reshape(bh, sk, d))


def _split_bwd(q, k, v, out, l2, dout, causal: bool, dq_fn, dkdv_fn):
    """``_flash_attn_bwd`` with ``bwd_impl="split"``: ``qs`` and ``dd =
    rowsum(dO∘O)`` once, then the dQ and dK/dV computations, then the
    GQA group sum of the per-q-head dk/dv."""
    bh, s, d, bhkv, sk, g = _shapes(q, k, v, causal)
    qs = _prescale(q).contiguous()
    dd = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
    dq = dq_fn(qs, k, v, dout, l2, dd, causal)
    dk, dv = dkdv_fn(qs, k, v, dout, l2, dd, causal)
    if g > 1:
        dk = _group_sum(dk.reshape(bhkv, g, sk, d))
        dv = _group_sum(dv.reshape(bhkv, g, sk, d))
    return dq, dk, dv


def flash_attn_bwd_ref(q, k, v, out, l2, dout, causal: bool = True):
    """Plain version of the split backward: ``(dq, dk, dv)`` bf16 with
    dk/dv at the kv heads' resolution."""
    return _split_bwd(q, k, v, out, l2, dout, causal, flash_bwd_dq_ref,
                      flash_bwd_dkdv_ref)


def _group_sum(t):
    """Per-q-head ``[BHkv, g, Sk, D]`` bf16 → ``[BHkv, Sk, D]``, summed in
    fp32 (``_group_sum_kv``)."""
    return t.float().sum(dim=1).to(t.dtype)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _check_kernel_args(*tensors, d: int):
    """Raise on anything the CUDA kernels do not take."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernels take D 64 or 128, got {d}")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all operands must be on {dev}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("flash kernel operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("flash kernel operands must be 16-byte "
                             "aligned")


def _check_bf16(*tensors):
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash kernels take bf16 q/k/v/out/dout, got "
                             f"{t.dtype}")


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.tpu_dra_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def _on_cuda(t, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, got {t.device}")


def flash_attn_fwd(q, k, v, causal: bool = True):
    """Forward: ``(out [BH, S, D] bf16, l2 [BH, S, 1] fp32)``.

    CPU tensors take :func:`flash_attn_fwd_ref`.  CUDA tensors launch
    ``csrc/flash_fwd.cu`` (rows #3 and #4 of the kernel table: one kernel
    for any group size) or raise; each launch adds one to
    ``flash_attn_fwd.launches``."""
    if q.device.type == "cpu":
        return flash_attn_fwd_ref(q, k, v, causal)
    _on_cuda(q, "flash_attn_fwd")
    bh, s, d, bhkv, sk, _ = _shapes(q, k, v, causal)
    _check_bf16(q, k, v)
    _check_kernel_args(q, k, v, d=d)
    from tpu_dra_torch.kernels.build import library
    lib = library("flash_fwd")
    out = torch.empty_like(q)
    l2 = torch.empty((bh, s, 1), dtype=torch.float32, device=q.device)
    rc = lib.tpu_dra_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        l2.data_ptr(), bh, bhkv, s, sk, d, int(causal),
        weak_scalar(d ** -0.5 * _LOG2E, q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, rc, "flash_fwd")
    flash_attn_fwd.launches += 1
    return out, l2


flash_attn_fwd.launches = 0


def flash_bwd_dq(qs, k, v, dout, l2, dd, causal: bool):
    """dQ: ``qs`` pre-scaled q, ``l2`` and ``dd`` fp32 ``[BH, S, 1]``.
    CPU tensors take :func:`flash_bwd_dq_ref`; CUDA tensors launch the dQ
    kernel of ``csrc/flash_bwd.cu`` (row #6) or raise, and each launch
    adds one to ``flash_bwd_dq.launches``."""
    if qs.device.type == "cpu":
        return flash_bwd_dq_ref(qs, k, v, dout, l2, dd, causal)
    _on_cuda(qs, "flash_bwd_dq")
    bh, s, d, bhkv, sk, _ = _shapes(qs, k, v, causal)
    _check_bwd_args(qs, k, v, dout, l2, dd, bh, s, d)
    from tpu_dra_torch.kernels.build import library
    lib = library("flash_bwd")
    dq = torch.empty_like(qs)
    rc = lib.tpu_dra_flash_bwd_dq(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        l2.data_ptr(), dd.data_ptr(), dq.data_ptr(), bh, bhkv, s, sk, d,
        int(causal), d ** -0.5,
        torch.cuda.current_stream(qs.device).cuda_stream)
    _raise_on(lib, rc, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkdv(qs, k, v, dout, l2, dd, causal: bool):
    """dK/dV: per-q-head ``(dk, dv)`` ``[BH, Sk, D]`` bf16 (the caller
    group-sums them for GQA).  CPU tensors take
    :func:`flash_bwd_dkdv_ref`; CUDA tensors launch the dK/dV kernel of
    ``csrc/flash_bwd.cu`` (row #7) or raise, and each launch adds one to
    ``flash_bwd_dkdv.launches``."""
    if qs.device.type == "cpu":
        return flash_bwd_dkdv_ref(qs, k, v, dout, l2, dd, causal)
    _on_cuda(qs, "flash_bwd_dkdv")
    bh, s, d, bhkv, sk, _ = _shapes(qs, k, v, causal)
    _check_bwd_args(qs, k, v, dout, l2, dd, bh, s, d)
    from tpu_dra_torch.kernels.build import library
    lib = library("flash_bwd")
    dk = torch.empty((bh, sk, d), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    rc = lib.tpu_dra_flash_bwd_dkdv(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        l2.data_ptr(), dd.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
        bhkv, s, sk, d, int(causal),
        torch.cuda.current_stream(qs.device).cuda_stream)
    _raise_on(lib, rc, "flash_bwd_dkdv")
    flash_bwd_dkdv.launches += 1
    return dk, dv


flash_bwd_dkdv.launches = 0


def _check_bwd_args(qs, k, v, dout, l2, dd, bh: int, s: int, d: int):
    """Raise on backward operands the CUDA kernels do not take."""
    _check_bf16(qs, k, v, dout)
    if dout.shape != qs.shape:
        raise ValueError(f"dout must match q's shape {tuple(qs.shape)}, "
                         f"got {tuple(dout.shape)}")
    for t in (l2, dd):
        if t.dtype != torch.float32 or t.numel() != bh * s:
            raise ValueError(f"l2 and dd must be fp32 [BH, S, 1] = "
                             f"[{bh}, {s}, 1], got {t.dtype} "
                             f"{tuple(t.shape)}")
    _check_kernel_args(qs, k, v, dout, l2, dd, d=d)


def flash_attn_bwd(q, k, v, out, l2, dout, causal: bool = True):
    """Split backward: ``(dq, dk, dv)`` bf16, dk/dv at the kv heads'
    resolution.  The dQ and dK/dV steps go through their wrappers
    (kernels for CUDA tensors, plain versions for CPU tensors); ``qs``,
    ``dd = rowsum(dO∘O)`` and the GQA group sum are plain PyTorch, as
    they are plain XLA in the reference."""
    return _split_bwd(q, k, v, out, l2, dout, causal, flash_bwd_dq,
                      flash_bwd_dkdv)


class FlashAttention(torch.autograd.Function):
    """``[BH, S, D]`` flash attention with the split flash backward; the
    counterpart of the reference's ``_flash_attn`` custom VJP.  Forward
    saves ``(q, k, v, out, l2)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, l2 = flash_attn_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, l2)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, l2 = ctx.saved_tensors
        dq, dk, dv = flash_attn_bwd(q, k, v, out, l2, dout.contiguous(),
                                    ctx.causal)
        return dq, dk, dv, None


def _validate_and_fold(q, k, v, causal: bool):
    """``[B, H, S, D]`` → contiguous ``[B·H, S, D]`` (k/v ``[B·Hkv, S,
    D]``), after the reference's entry checks."""
    b, h, s, d = q.shape
    if causal and k.shape[2] != s:
        raise ValueError(f"causal flash_attention requires equal q/k "
                         f"lengths, got q seq {s} vs k seq {k.shape[2]}")
    if h % k.shape[1]:
        raise ValueError(f"q heads {h} not a multiple of kv heads "
                         f"{k.shape[1]}")

    def fold(x):
        return x.reshape(b * x.shape[1], x.shape[2], d).contiguous()
    return fold(q), fold(k), fold(v)


def flash_attention(q, k, v, causal: bool = True):
    """Memory-efficient attention for ``[B, H, S, D]`` q against
    ``[B, Hkv, Sk, D]`` k/v (Hkv divides H), differentiable through the
    flash backward."""
    b, h, s, d = q.shape
    qf, kf, vf = _validate_and_fold(q, k, v, causal)
    return FlashAttention.apply(qf, kf, vf, causal).reshape(b, h, s, d)
