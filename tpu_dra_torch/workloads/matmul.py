"""The tiled matmul and the fused RMSNorm-matmul, ported from the matmul
part of ``tpu_dra/workloads/pallas_kernels.py``.

What maps to what:

- ``matmul_ref`` / ``matmul`` ↔ ``matmul`` (57-104) and its kernel
  ``_matmul_kernel``: bf16 ``x @ y``, fp32 accumulation, bf16 out;
- ``fused_rmsnorm_matmul_ref`` / ``fused_rmsnorm_matmul`` ↔
  ``fused_rmsnorm_matmul`` (932-961) and ``_fused_rmsnorm_matmul_kernel``
  (863-883): ``bf16(rmsnorm(x)·γ) @ W``, eps 1e-6;
- ``RmsnormMatmul`` ↔ the custom VJP ``rmsnorm_matmul_train`` (886-929):
  the forward is the fused kernel, the backward the reference's plain math
  (902-925), whose products stay plain ``torch`` matmuls as they are plain
  XLA dots in the reference.

Shapes follow the reference's contract: they must tile evenly by its
default blocks (``min(1024, m)``, ``min(1024, n)``, ``min(512, k)`` for
``matmul``; ``min(256, m)``, ``min(256, n)`` for the fused kernel), and
``ValueError`` takes the place of its ``assert``.  The CUDA kernel
(``csrc/matmul.cu``) picks its own tiles and masks ragged edges, so the
contract only decides what is admitted.

CPU tensors take the plain versions.  CUDA tensors launch the
hand-written kernel or raise; each launch adds one to the launching
wrapper's ``launches``.
"""

from __future__ import annotations

import torch

from tpu_dra_torch.kernels.build import check_launch, library, require_cuda
from tpu_dra_torch.workloads.train import dot_f32

EPS = 1e-6

# A kernel against its plain version (chip_smoke.py, tests/test_torch_cuda
# .py): elementwise |got - want| <= ELEM_TOL + ELEM_TOL * |want| (two to
# four bf16 ulps), and each output row within ROW_TOL by
# ``flash.row_rel_err``.  Both sum bf16 products and round the sum to bf16
# once, in different orders, and the tensor cores do not add in strict
# fp32; the fused kernel may also round a normed element the other way
# where its r differs from the plain version's in the last bit.  The worst
# errors on an H100 80GB HBM3 at 700 W over chip_smoke.py's nine cases
# (PERF.md §6): elementwise 0.49 of ELEM_TOL; per row 0.00070 (matmul) and
# 0.00119 (rmsnorm_matmul at the flagship's ln1 -> wqkv), so ROW_TOL is
# 2.5x the worst seen.
ELEM_TOL = 2 ** -6
ROW_TOL = 3e-3


def _dims(x, w):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul takes x [m, k] and w [k, n], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    return x.shape[0], x.shape[1], w.shape[1]


def _check_tiling(dims: dict) -> None:
    """Raise unless each dimension is a multiple of its (capped) block,
    as the reference asserts."""
    for name, (n, blk) in dims.items():
        if n % min(blk, n):
            raise ValueError(
                f"shapes must tile evenly: {name} = {n} is not a multiple "
                f"of its block {min(blk, n)}")


def matmul_ref(x, y):
    """Plain version: ``bf16(x @ y)`` with the products summed in fp32
    (bf16 values are exact in fp32)."""
    return (x.float() @ y.float()).to(x.dtype)


def fused_rmsnorm_matmul_ref(x, gamma, w, eps: float = EPS):
    """Plain version: ``normed = (x·rsqrt(mean(x²) + eps))·γ`` in fp32,
    rounded to x's dtype, then ``bf16(normed @ w)`` summed in fp32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)) * gamma.float()
    return (normed.to(x.dtype).float() @ w.float()).to(x.dtype)


def _check_kernel_args(x, w, *, k: int, n: int, others=()):
    """Raise on anything ``csrc/matmul.cu`` does not take."""
    for t in (x, w):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the matmul kernels take bf16 x and w, got "
                             f"{t.dtype}")
    if k % 8 or n % 8:
        raise ValueError(f"the matmul kernels take k and n multiples of 8 "
                         f"(16-byte rows), got k {k}, n {n}")
    for t in (x, w, *others):
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("matmul kernel operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("matmul kernel operands must be 16-byte "
                             "aligned")


def matmul(x, y, *, bm: int = 1024, bn: int = 1024, bk: int = 512):
    """Tiled ``x @ y`` (bf16 in, bf16 out, fp32 accumulate); shapes must
    tile evenly by ``(bm, bk, bn)``, each capped at its dimension.

    CPU tensors take :func:`matmul_ref`.  CUDA tensors launch
    ``csrc/matmul.cu`` (row #2 of the kernel table) or raise; each launch
    adds one to ``matmul.launches``."""
    m, k, n = _dims(x, y)
    _check_tiling({"m": (m, bm), "n": (n, bn), "k": (k, bk)})
    if x.device.type == "cpu":
        return matmul_ref(x, y)
    require_cuda(x, "matmul")
    _check_kernel_args(x, y, k=k, n=n)
    lib = library("matmul")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = lib.tpu_dra_matmul(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n,
                            k, torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, rc, "matmul")
    matmul.launches += 1
    return out


matmul.launches = 0


def fused_rmsnorm_matmul(x, gamma, w, *, bm: int = 256, bn: int = 256,
                         eps: float = EPS):
    """``rmsnorm(x, gamma) @ w`` in one kernel (bf16 x and w, gamma of any
    float dtype, read in fp32; fp32 accumulate; bf16 out); m and n must
    tile evenly by ``bm`` and ``bn``, each capped at its dimension.

    CPU tensors take :func:`fused_rmsnorm_matmul_ref`.  CUDA tensors
    launch the norm kernels of ``csrc/matmul.cu`` (row #8: a row-norm pass
    that writes normed x to a scratch the size of x, then the tiled
    matmul on it) or raise; each call adds one to
    ``fused_rmsnorm_matmul.launches``."""
    m, k, n = _dims(x, w)
    if gamma.shape != (k,):
        raise ValueError(f"gamma must be [{k}], got {tuple(gamma.shape)}")
    _check_tiling({"m": (m, bm), "n": (n, bn)})
    if x.device.type == "cpu":
        return fused_rmsnorm_matmul_ref(x, gamma, w, eps)
    require_cuda(x, "fused_rmsnorm_matmul")
    g32 = gamma.float().contiguous()
    _check_kernel_args(x, w, k=k, n=n, others=(g32,))
    lib = library("matmul")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    r = torch.empty(m, dtype=torch.float32, device=x.device)   # row norms
    xn = torch.empty_like(x)                                   # normed x
    rc = lib.tpu_dra_rmsnorm_matmul(
        x.data_ptr(), g32.data_ptr(), w.data_ptr(), r.data_ptr(),
        xn.data_ptr(), out.data_ptr(), m, n, k, eps,
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, rc, "rmsnorm_matmul")
    fused_rmsnorm_matmul.launches += 1
    return out


fused_rmsnorm_matmul.launches = 0


class RmsnormMatmul(torch.autograd.Function):
    """Differentiable ``rmsnorm(x, γ) @ w`` for x ``[M, K]`` bf16, γ
    ``[K]`` and w ``[K, N]`` bf16: the forward is
    :func:`fused_rmsnorm_matmul`, the backward the reference's plain math
    (``_rmsnorm_matmul_train_bwd``): dW and dNorm as bf16 products summed
    in fp32 (dW rounded to w's dtype), dγ and dx in fp32 (rounded to γ's
    and x's dtypes).  Forward saves ``(x, γ, w)``."""

    @staticmethod
    def forward(ctx, x, gamma, w):
        ctx.save_for_backward(x, gamma, w)
        return fused_rmsnorm_matmul(x, gamma, w)

    @staticmethod
    def backward(ctx, g):
        x, gamma, w = ctx.saved_tensors
        K = x.shape[-1]
        xf = x.float()
        r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + EPS)
        gf = gamma.float()
        n = (xf * r) * gf                                   # normed, fp32
        gb = g.to(x.dtype)
        dw = dot_f32(n.to(x.dtype).T, gb).to(w.dtype)
        dn = dot_f32(gb, w.to(x.dtype).T)                  # [M, K] fp32
        dgamma = (dn * xf * r).sum(dim=0).to(gamma.dtype)
        # rmsnorm backward: y_j = γ_j·x_j·r, dr/dx_i = −x_i·r³/K
        dg_gamma = dn * gf
        dx = (dg_gamma * r
              - xf * (r * r * r / K)
              * (dg_gamma * xf).sum(dim=-1, keepdim=True))
        return dx.to(x.dtype), dgamma, dw
