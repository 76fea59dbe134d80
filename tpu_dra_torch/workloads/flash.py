"""Flash attention, ported from the flash part of
``tpu_dra/workloads/pallas_kernels.py``.

What maps to what:

- ``flash_attn_fwd_ref`` / ``flash_attn_fwd`` ↔ ``_flash_attn_fwd``
  (315-364) with its kernels ``_flash_attn_kernel`` (151-200) and, for
  GQA, ``_flash_attn_fwd_gqa`` / ``_flash_attn_gqa_kernel`` (221-312);
- ``flash_attn_bwd_ref`` / ``flash_attn_bwd`` ↔ ``_flash_attn_bwd``
  (543-703): with ``bwd_impl="split"`` the dQ kernel
  ``_flash_bwd_dq_kernel`` (367-417) and the dK/dV kernel
  ``_flash_bwd_dkdv_kernel`` (453-491); with ``bwd_impl="fused"`` the
  single-pass kernel ``_flash_bwd_fused_kernel`` (494-540) and the sum of
  its dQ partials (658); either way the GQA group sum ``_group_sum_kv``
  (706-714);
- ``FlashAttentionLse`` ↔ the ``custom_vjp``s ``_flash_attn`` (730-752)
  and ``_flash_attn_lse`` (755-779), whose l2 cotangent folds into dd
  (602-607): one Function serves both front doors;
- ``flash_attention`` ↔ the front door ``flash_attention`` (821), and
  ``flash_attention_with_lse`` ↔ ``flash_attention_with_lse`` (802),
  ``_resolve_flash_config`` (34-54) for ``bwd_impl`` and
  ``_validate_and_fold`` (782-796).

Layouts are the reference's: ``[BH, S, D]`` bf16 q against
``[BHkv, Sk, D]`` k/v, where q rows ``b·g … (b+1)·g−1`` share kv row
``b``; ``l2`` is the per-row base-2 logsumexp ``[BH, S, 1]`` fp32.

CPU tensors take the plain versions.  CUDA tensors launch the
hand-written kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) or
raise; each launch adds one to the launching wrapper's ``launches``.
Block sizes are the kernels' own, and the kernels mask a ragged sequence
tail themselves, so the TPU's tile padding in
``train._flash_attention_fn`` is not needed.  Of the reference's tune
table (``bench_cache/flash_tune.json``) the port reads only ``bwd_impl``,
from :data:`TUNE_FILE`: the one way training reaches the fused backward.

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

import functools
import json
from pathlib import Path

import torch

from tpu_dra_torch.kernels.build import check_launch, library, require_cuda
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

BWD_IMPLS = ("split", "fused")
# Keys per dQ partial of the fused backward: the reference's bk_kv =
# _cap_block(Sk, 1024), with S padded to a multiple of 1024 by
# train._flash_attention_fn from S = 1024 up (and one block below), so in
# training its partials are 1024-key blocks, the last one ragged here.
KV_BLOCK = 1024
# The counterpart of bench_cache/flash_tune.json, read for "bwd_impl" only
# ({"entries": {"<S>x<D>": {"bwd_impl": "fused"}}}); not committed, and
# where it is absent every shape takes the split backward.
TUNE_FILE = Path(__file__).resolve().parent.parent / "flash_tune.json"


def _tuned_entries() -> dict:
    """The entries of :data:`TUNE_FILE` ({} where the file is absent or
    unreadable, as the reference's loader does)."""
    try:
        with open(TUNE_FILE, encoding="utf-8") as f:
            return json.load(f).get("entries", {})
    except (OSError, ValueError):
        return {}


def _check_bwd_impl(bwd_impl) -> None:
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(f"bwd_impl must be 'split' or 'fused', got "
                         f"{bwd_impl!r}")


def resolve_bwd_impl(s: int, d: int, bwd_impl=None) -> str:
    """``bwd_impl`` for an ``[.., S, D]`` attention: an explicit value
    wins; ``None`` takes the tune table's entry ``"{S}x{D}"``, else
    ``"split"``.  Raises ``ValueError`` on any other name."""
    if bwd_impl is None:
        bwd_impl = _tuned_entries().get(f"{s}x{d}", {}).get("bwd_impl",
                                                             "split")
    _check_bwd_impl(bwd_impl)
    return bwd_impl


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


def flash_bwd_fused_ref(qs, k, v, dout, l2, dd, causal: bool = True,
                        bk: int = KV_BLOCK):
    """Plain version of the fused kernel: ``(dq [BH, S, D], dk, dv [BH,
    Sk, D])`` bf16, dk/dv per q head as the dK/dV kernel gives them.  dQ
    follows the reference's partials: for each block of ``bk`` keys,
    ``bf16(dS·K)`` summed in fp32; then the partials summed in fp32,
    times ``D^-0.5``, rounded to bf16 (:func:`_finish_dq`)."""
    bh, s, d, bhkv, sk, g = _shapes(qs, k, v, causal)
    p = _bwd_probs(qs, k, l2, causal)
    do = dout.float().reshape(bhkv, g, s, d)
    dv = p.to(torch.bfloat16).float().transpose(-1, -2) @ do
    ds = _bwd_ds(p, v, dout, dd)
    dk = (ds.transpose(-1, -2) @ qs.float().reshape(bhkv, g, s, d)) \
        * (1.0 / _LOG2E)
    kf = k.float()[:, None]
    parts = torch.stack([
        (ds[..., j:j + bk] @ kf[:, :, j:j + bk]).to(torch.bfloat16).float()
        for j in range(0, sk, bk)])
    return (_finish_dq(parts, d).reshape(bh, s, d),
            dk.to(k.dtype).reshape(bh, sk, d),
            dv.to(v.dtype).reshape(bh, sk, d))


def _finish_dq(parts, d: int):
    """dQ from its per-k-block partials ``[n_j, ...]`` (bf16 values in
    fp32 storage): ``bf16(Σ_j parts · D^-0.5)``, the sum in fp32
    (``_flash_attn_bwd`` :658)."""
    return (parts.sum(dim=0) * d ** -0.5).to(torch.bfloat16)


def _split(dq_fn, dkdv_fn):
    """The split pair as one ``(qs, k, v, dout, l2, dd, causal) -> (dq,
    dk, dv)`` step."""
    def grads(qs, k, v, dout, l2, dd, causal):
        return (dq_fn(qs, k, v, dout, l2, dd, causal),
                *dkdv_fn(qs, k, v, dout, l2, dd, causal))
    return grads


def _bwd(q, k, v, out, l2, dout, causal: bool, grads, g_l2=None):
    """``_flash_attn_bwd``: ``qs`` and ``dd = rowsum(dO∘O)`` once (with an
    l2 cotangent ``g_l2`` folded in as ``dd − log2e·g_l2``, 602-607: the
    kernels do not change), then ``grads`` (the split pair or the fused
    kernel), then the GQA group sum of the per-q-head dk/dv."""
    bh, s, d, bhkv, sk, g = _shapes(q, k, v, causal)
    qs = _prescale(q).contiguous()
    dd = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
    if g_l2 is not None:
        dd = dd - _LOG2E * g_l2.float().reshape(bh, s, 1)
    dq, dk, dv = grads(qs, k, v, dout, l2, dd, causal)
    if g > 1:
        dk = _group_sum(dk.reshape(bhkv, g, sk, d))
        dv = _group_sum(dv.reshape(bhkv, g, sk, d))
    return dq, dk, dv


def flash_attn_bwd_ref(q, k, v, out, l2, dout, causal: bool = True,
                       bwd_impl: str = "split", bk: int = KV_BLOCK,
                       g_l2=None):
    """Plain version of the backward: ``(dq, dk, dv)`` bf16 with dk/dv at
    the kv heads' resolution; ``bk`` is the fused path's dQ partition and
    ``g_l2`` an optional cotangent of l2."""
    _check_bwd_impl(bwd_impl)
    grads = (functools.partial(flash_bwd_fused_ref, bk=bk)
             if bwd_impl == "fused"
             else _split(flash_bwd_dq_ref, flash_bwd_dkdv_ref))
    return _bwd(q, k, v, out, l2, dout, causal, grads, g_l2)


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


def flash_attn_fwd(q, k, v, causal: bool = True):
    """Forward: ``(out [BH, S, D] bf16, l2 [BH, S, 1] fp32)``.

    CPU tensors take :func:`flash_attn_fwd_ref`.  CUDA tensors launch
    ``csrc/flash_fwd.cu`` (rows #3 and #4 of the kernel table: one kernel
    for any group size) or raise; each launch adds one to
    ``flash_attn_fwd.launches``."""
    if q.device.type == "cpu":
        return flash_attn_fwd_ref(q, k, v, causal)
    require_cuda(q, "flash_attn_fwd")
    bh, s, d, bhkv, sk, _ = _shapes(q, k, v, causal)
    _check_bf16(q, k, v)
    _check_kernel_args(q, k, v, d=d)
    lib = library("flash_fwd")
    out = torch.empty_like(q)
    l2 = torch.empty((bh, s, 1), dtype=torch.float32, device=q.device)
    rc = lib.tpu_dra_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        l2.data_ptr(), bh, bhkv, s, sk, d, int(causal),
        weak_scalar(d ** -0.5 * _LOG2E, q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(lib, rc, "flash_fwd")
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
    require_cuda(qs, "flash_bwd_dq")
    bh, s, d, bhkv, sk, _ = _shapes(qs, k, v, causal)
    _check_bwd_args(qs, k, v, dout, l2, dd, bh, s, d)
    lib = library("flash_bwd")
    dq = torch.empty_like(qs)
    rc = lib.tpu_dra_flash_bwd_dq(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        l2.data_ptr(), dd.data_ptr(), dq.data_ptr(), bh, bhkv, s, sk, d,
        int(causal), d ** -0.5,
        torch.cuda.current_stream(qs.device).cuda_stream)
    check_launch(lib, rc, "flash_bwd_dq")
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
    require_cuda(qs, "flash_bwd_dkdv")
    bh, s, d, bhkv, sk, _ = _shapes(qs, k, v, causal)
    _check_bwd_args(qs, k, v, dout, l2, dd, bh, s, d)
    lib = library("flash_bwd")
    dk = torch.empty((bh, sk, d), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    rc = lib.tpu_dra_flash_bwd_dkdv(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        l2.data_ptr(), dd.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
        bhkv, s, sk, d, int(causal),
        torch.cuda.current_stream(qs.device).cuda_stream)
    check_launch(lib, rc, "flash_bwd_dkdv")
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


def flash_bwd_fused(qs, k, v, dout, l2, dd, causal: bool):
    """Fused backward step: ``(dq, dk, dv)`` bf16 with dk/dv per q head
    (the caller group-sums them for GQA).  CPU tensors take
    :func:`flash_bwd_fused_ref`; CUDA tensors launch the fused kernel of
    ``csrc/flash_bwd.cu`` (row #5) or raise, and each launch adds one to
    ``flash_bwd_fused.launches``.  The kernel adds dQ's unscaled fp32 sums
    into one zeroed buffer per block of :data:`KV_BLOCK` keys, and a second
    pass forms dq from them as :func:`_finish_dq` does."""
    if qs.device.type == "cpu":
        return flash_bwd_fused_ref(qs, k, v, dout, l2, dd, causal)
    require_cuda(qs, "flash_bwd_fused")
    bh, s, d, bhkv, sk, _ = _shapes(qs, k, v, causal)
    _check_bwd_args(qs, k, v, dout, l2, dd, bh, s, d)
    bk = KV_BLOCK
    lib = library("flash_bwd")
    dq = torch.empty_like(qs)
    dk = torch.empty((bh, sk, d), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    dqacc = torch.zeros((-(-sk // bk), bh, s, d), dtype=torch.float32,
                        device=qs.device)
    rc = lib.tpu_dra_flash_bwd_fused(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        l2.data_ptr(), dd.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dqacc.data_ptr(), dq.data_ptr(), bh, bhkv, s, sk, d, int(causal), bk,
        d ** -0.5, torch.cuda.current_stream(qs.device).cuda_stream)
    check_launch(lib, rc, "flash_bwd_fused")
    flash_bwd_fused.launches += 1
    return dq, dk, dv


flash_bwd_fused.launches = 0


def flash_attn_bwd(q, k, v, out, l2, dout, causal: bool = True,
                   bwd_impl: str = "split", g_l2=None):
    """The flash backward: ``(dq, dk, dv)`` bf16, dk/dv at the kv heads'
    resolution, through the split pair (:func:`flash_bwd_dq`,
    :func:`flash_bwd_dkdv`) or the fused step (:func:`flash_bwd_fused`):
    kernels for CUDA tensors, plain versions for CPU tensors.  ``qs``,
    ``dd = rowsum(dO∘O)``, dQ's partial sum and the GQA group sum are
    plain PyTorch, as they are plain XLA in the reference.  ``g_l2``, an
    optional cotangent of l2 ``[BH, S]``, shifts the dd operand."""
    _check_bwd_impl(bwd_impl)
    grads = (flash_bwd_fused if bwd_impl == "fused"
             else _split(flash_bwd_dq, flash_bwd_dkdv))
    return _bwd(q, k, v, out, l2, dout, causal, grads, g_l2)


class FlashAttentionLse(torch.autograd.Function):
    """``[BH, S, D]`` flash attention that also returns the base-2
    logsumexp ``l2 [BH, S]`` fp32, with the flash backward named by
    ``bwd_impl``; the counterpart of the reference's ``_flash_attn`` and
    ``_flash_attn_lse`` custom VJPs (730-779).  Both outputs are
    differentiable: the l2 cotangent folds into the dd operand of the same
    backward kernels, and an l2 no one used arrives as ``None`` (grads are
    not materialized), so :func:`flash_attention` runs the backward of
    ``_flash_attn`` bit for bit.  Forward saves ``(q, k, v, out, l2)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, bwd_impl: str = "split"):
        out, l2 = flash_attn_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, l2)
        ctx.set_materialize_grads(False)
        ctx.causal = causal
        ctx.bwd_impl = bwd_impl
        return out, l2[..., 0].clone()

    @staticmethod
    def backward(ctx, dout, g_l2):
        q, k, v, out, l2 = ctx.saved_tensors
        dout = torch.zeros_like(out) if dout is None else dout.contiguous()
        dq, dk, dv = flash_attn_bwd(q, k, v, out, l2, dout, ctx.causal,
                                    ctx.bwd_impl, g_l2)
        return dq, dk, dv, None, None


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


def flash_attention(q, k, v, causal: bool = True, bwd_impl=None):
    """Memory-efficient attention for ``[B, H, S, D]`` q against
    ``[B, Hkv, Sk, D]`` k/v (Hkv divides H), differentiable through the
    flash backward.  ``bwd_impl`` ``None`` resolves through the tune table
    for this (S, D) (:func:`resolve_bwd_impl`); an explicit value wins."""
    b, h, s, d = q.shape
    bwd_impl = resolve_bwd_impl(s, d, bwd_impl)
    qf, kf, vf = _validate_and_fold(q, k, v, causal)
    out, _ = FlashAttentionLse.apply(qf, kf, vf, causal, bwd_impl)
    return out.reshape(b, h, s, d)


def flash_attention_with_lse(q, k, v, causal: bool = True, bwd_impl=None):
    """:func:`flash_attention` that also returns the per-row base-2
    logsumexp ``[B, H, S]`` fp32, the statistic that merges normalized
    partial attentions over disjoint key sets (the ring engine's
    ``_merge_partials``); the front door of the reference at 799-818.
    Both outputs are differentiable."""
    b, h, s, d = q.shape
    bwd_impl = resolve_bwd_impl(s, d, bwd_impl)
    qf, kf, vf = _validate_and_fold(q, k, v, causal)
    out, l2 = FlashAttentionLse.apply(qf, kf, vf, causal, bwd_impl)
    return out.reshape(b, h, s, d), l2.reshape(b, h, s)
