"""The ring kernels, ported from the collective part of
``tpu_dra/workloads/pallas_kernels.py`` (964-1368), on a virtual ring of
ranks that live on one card.

What maps to what:

- ``all_gather_matmul_ref`` / ``all_gather_matmul`` ↔ ``_ag_matmul_call``
  (1137-1162) and its kernel ``_ag_matmul_kernel`` (1058-1134): ``y =
  all_gather_rows(x) @ w`` and the gathered operand ``a``;
- ``matmul_reduce_scatter_ref`` / ``matmul_reduce_scatter`` ↔
  ``_matmul_rs_call`` (1213-1241) and ``_matmul_rs_kernel`` (1165-1210):
  ``y = reduce_scatter_rows(x @ w)``;
- ``ring_shift_ref`` / ``ring_shift`` ↔ ``_ring_shift_call`` (1329-1345)
  and ``_ring_shift_kernel`` (1313-1326): the ±1 ``ppermute``;
- ``AllGatherMatmul``, ``MatmulReduceScatter`` and ``RingShift`` ↔ the
  custom VJPs ``all_gather_matmul`` (1244-1277), ``matmul_reduce_scatter``
  (1280-1310) and ``ring_shift`` (1348-1368): the transpose of each matmul
  kernel is the other kernel, each ``dw`` a local contraction against the
  gathered operand, and the shift's cotangent shifts the other way.

Layout: every operand leads with ``[G, n]``, a group axis (the
data-parallel groups, each its own ring) and the ring's rank axis, and
rank ``(g, r)`` holds the reference's per-device operand at ``[g, r]``:
x ``[G, n, m, K]`` and w ``[G, n, K, N]`` for the gather (w is an
expanded view over G where the groups share one weight shard per rank),
x ``[G, n, n·m, K]`` for the reduce-scatter.

CPU tensors take the plain versions (the mesh collectives of
``mesh.py`` plus fp32-accumulated products).  CUDA tensors launch the
hand-written kernels of ``csrc/ring.cu`` or raise: one launch per ring
step, so a gather or reduce-scatter over n > 1 ranks adds n to its
wrapper's ``launches`` and a shift adds one.  At n = 1 the matmuls are the
plain product (the reference's ``n == 1`` branches, 1144-1146 and
1221-1223) and the shift the identity: no kernel runs.
"""

from __future__ import annotations

import torch

from tpu_dra_torch.kernels.build import check_launch, library, require_cuda
from tpu_dra_torch.workloads import matmul
from tpu_dra_torch.workloads.mesh import all_gather, ppermute, psum_scatter
from tpu_dra_torch.workloads.train import dot_f32

# A kernel against its plain version (chip_smoke.py, tests/test_torch_cuda
# .py): y elementwise within ELEM_TOL + ELEM_TOL·|want| and each output
# row within ROW_TOL by ``flash.row_rel_err``, the tiled matmul's bounds.
# Both sides sum bf16 products in fp32 and round once, in different
# orders; the reduce-scatter's kernel and plain version add the ranks'
# fp32 partials in the same ring order and round once at the end, so the
# products' order is all that differs, as for the tiled matmul.  The
# gathered operand and the shift are copies and must be byte-equal.
ELEM_TOL = matmul.ELEM_TOL
ROW_TOL = matmul.ROW_TOL


def _ring_dims(x, w, what: str):
    if x.dim() != 4 or w.dim() != 4 or x.shape[:2] != w.shape[:2] \
            or x.shape[3] != w.shape[2]:
        raise ValueError(f"{what} takes x [G, n, rows, K] and w [G, n, K, "
                         f"N], got {tuple(x.shape)} and {tuple(w.shape)}")
    return x.shape[0], x.shape[1], x.shape[2], x.shape[3], w.shape[3]


def _rank_products(x, w):
    """``x[g, r] @ w[g, r]`` for every rank, summed in fp32 and returned in
    fp32 ``[G, n, rows, N]`` (bf16 values are exact in fp32)."""
    return x.float() @ w.float()


def all_gather_matmul_ref(x, w):
    """Plain version: ``(y [G, n, n·m, N], a [G, n, n, m, K])`` with ``a``
    every rank's copy of the gathered shards and ``y = bf16(a·w)`` summed
    in fp32."""
    G, n, m, K, N = _ring_dims(x, w, "all_gather_matmul")
    a = all_gather(x[:, :, None], 1, 2)                  # [G, n, n, m, K]
    y = _rank_products(a.reshape(G, n, n * m, K), w)
    return y.to(x.dtype), a


def matmul_reduce_scatter_ref(x, w):
    """Plain version: rank r's ``y [m, N]`` is chunk r of the ranks'
    summed fp32 products, added in ring order (``mesh.psum_scatter``) and
    rounded to x's dtype once."""
    G, n, mk, K, N = _ring_dims(x, w, "matmul_reduce_scatter")
    if mk % n:
        raise ValueError(f"matmul_reduce_scatter: rows {mk} do not split "
                         f"over {n} ranks")
    return psum_scatter(_rank_products(x, w), 1, 2).to(x.dtype)


def ring_shift_ref(x, reverse: bool = False):
    """Plain version: rank r's block moves to rank r + 1 (``reverse``:
    r − 1) of its ring, dimension 1."""
    return ppermute(x, 1, -1 if reverse else 1)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _check_matmul_args(x, w, k: int, n_out: int, what: str):
    """Raise on anything the ring matmul kernels do not take; returns
    w's (rank, group) strides."""
    for t in (x, w):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{what} takes bf16 x and w, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, got "
                             f"{t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what} operands must be 16-byte aligned")
    if k % 8 or n_out % 8:
        raise ValueError(f"{what} takes K and N multiples of 8 (16-byte "
                         f"rows), got K {k}, N {n_out}")
    if not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous x")
    if w.stride(3) != 1 or w.stride(2) != n_out:
        raise ValueError(f"{what} takes each rank's w [K, N] contiguous")
    return w.stride(1), w.stride(0)


def _plain_rank_product(x, w):
    """The n = 1 branch: each rank's ``bf16(x @ w)`` summed in fp32."""
    out = torch.stack([dot_f32(x[g, 0], w[g, 0])
                       for g in range(x.shape[0])])
    return out.to(x.dtype)[:, None]


def all_gather_matmul(x, w):
    """``(y, a)``: ``y [G, n, n·m, N] = all_gather_rows(x) @ w`` per rank
    and ``a [G, n, n, m, K]`` the gathered operand, for x ``[G, n, m, K]``
    and w ``[G, n, K, N]``.

    CPU tensors take :func:`all_gather_matmul_ref`.  CUDA tensors launch
    the all-gather-matmul kernel of ``csrc/ring.cu`` (row #9 of the kernel
    table) once per ring step, bidirectional where m is even and n > 2 as
    the reference chooses, or raise; each launch adds one to
    ``all_gather_matmul.launches``."""
    G, n, m, K, N = _ring_dims(x, w, "all_gather_matmul")
    if x.device.type == "cpu":
        return all_gather_matmul_ref(x, w)
    require_cuda(x, "all_gather_matmul")
    if n == 1:
        return _plain_rank_product(x, w), x[:, :, None]
    w_rs, w_gs = _check_matmul_args(x, w, K, N, "all_gather_matmul")
    lib = library("ring")
    y = torch.empty((G, n, n * m, N), dtype=x.dtype, device=x.device)
    a = torch.empty((G, n, n, m, K), dtype=x.dtype, device=x.device)
    bidir = int(m % 2 == 0 and n > 2)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for step in range(n):
        rc = lib.tpu_dra_ring_ag_matmul(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), a.data_ptr(), G, n, m,
            K, N, m * K, n * m * K, w_rs, w_gs, step, bidir, stream)
        check_launch(lib, rc, "all_gather_matmul")
        all_gather_matmul.launches += 1
    return y, a


all_gather_matmul.launches = 0


def matmul_reduce_scatter(x, w):
    """``y [G, n, m, N]``: rank r's rows ``[r·m, (r+1)·m)`` of the ranks'
    summed products ``x[g, r] @ w[g, r]``, for x ``[G, n, n·m, K]`` and w
    as in :func:`all_gather_matmul`.

    CPU tensors take :func:`matmul_reduce_scatter_ref`.  CUDA tensors
    launch the matmul-reduce-scatter kernel of ``csrc/ring.cu`` (row #10)
    once per ring step, its fp32 partial chunks passed rank to rank
    through a double-buffered scratch, or raise; each launch adds one to
    ``matmul_reduce_scatter.launches``."""
    G, n, mk, K, N = _ring_dims(x, w, "matmul_reduce_scatter")
    if mk % n:
        raise ValueError(f"matmul_reduce_scatter: rows {mk} do not split "
                         f"over {n} ranks")
    if x.device.type == "cpu":
        return matmul_reduce_scatter_ref(x, w)
    require_cuda(x, "matmul_reduce_scatter")
    if n == 1:
        return _plain_rank_product(x, w)
    m = mk // n
    w_rs, w_gs = _check_matmul_args(x, w, K, N, "matmul_reduce_scatter")
    lib = library("ring")
    y = torch.empty((G, n, m, N), dtype=x.dtype, device=x.device)
    comm = torch.empty((G, n, 2, m, N), dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for step in range(n):
        rc = lib.tpu_dra_ring_matmul_rs(
            x.data_ptr(), w.data_ptr(), comm.data_ptr(), y.data_ptr(), G, n,
            m, K, N, mk * K, n * mk * K, w_rs, w_gs, step, stream)
        check_launch(lib, rc, "matmul_reduce_scatter")
        matmul_reduce_scatter.launches += 1
    return y


matmul_reduce_scatter.launches = 0


def ring_shift(x, reverse: bool = False):
    """Rank r's block ``x[g, r]`` lands at rank r + 1 (``reverse``: r − 1)
    of its ring, for any ``[G, n, ...]`` tensor.

    CPU tensors take :func:`ring_shift_ref`.  CUDA tensors launch the
    shift kernel of ``csrc/ring.cu`` (row #11) once, or raise; each launch
    adds one to ``ring_shift.launches``."""
    if x.dim() < 2:
        raise ValueError(f"ring_shift takes [G, n, ...], got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return ring_shift_ref(x, reverse)
    require_cuda(x, "ring_shift")
    G, n = x.shape[:2]
    if n == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    per_rank = x[0, 0].numel() * x.element_size()
    if per_rank == 0:
        return out
    lib = library("ring")
    rc = lib.tpu_dra_ring_shift(
        x.data_ptr(), out.data_ptr(), G, n, per_rank, -1 if reverse else 1,
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, rc, "ring_shift")
    ring_shift.launches += 1
    return out


ring_shift.launches = 0


# --------------------------------------------------------------------------
# Differentiable forms (the reference's custom VJPs)
# --------------------------------------------------------------------------


def _transposed(w):
    """Each rank's ``wᵀ [N, K]``, contiguous, keeping a group axis that
    is an expanded view (one weight shared by the groups) shared."""
    if w.shape[0] > 1 and w.stride(0) == 0:
        return _transposed(w[:1]).expand(w.shape[0], -1, -1, -1)
    return w.transpose(-1, -2).contiguous()


def _rank_dw(lhs, rhs):
    """``dw[g, r] = lhs[g, r]ᵀ @ rhs[g, r]`` summed in fp32 and rounded to
    bf16 (the reference's ``dot_general`` over rows with an fp32
    accumulator); lhs ``[G, n, R, K]``, rhs ``[G, n, R, N]``."""
    G, n = lhs.shape[:2]
    return torch.stack([torch.stack([
        dot_f32(lhs[g, r].T, rhs[g, r]) for r in range(n)])
        for g in range(G)]).to(lhs.dtype)


class AllGatherMatmul(torch.autograd.Function):
    """``all_gather_rows(x) @ w`` per rank (:func:`all_gather_matmul`),
    differentiable: dx rides the matmul-reduce-scatter kernel on ``g @
    wᵀ``, dw is each rank's ``aᵀ @ g`` against the gathered operand the
    forward already produced.  Forward saves ``(a, w)``."""

    @staticmethod
    def forward(ctx, x, w):
        y, a = all_gather_matmul(x, w)
        ctx.save_for_backward(a, w)
        return y

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        G, n, _, m, K = a.shape
        g = g.to(a.dtype).contiguous()
        dx = matmul_reduce_scatter(g, _transposed(w))
        dw = _rank_dw(a.reshape(G, n, n * m, K), g)
        return dx, dw.to(w.dtype)


class MatmulReduceScatter(torch.autograd.Function):
    """``reduce_scatter_rows(x @ w)`` per rank
    (:func:`matmul_reduce_scatter`), differentiable: dx rides the
    all-gather-matmul kernel on ``g`` and ``wᵀ``, dw contracts each
    rank's x against the gathered cotangent that ring produced.  Forward
    saves ``(x, w)``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return matmul_reduce_scatter(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        G, n, mk, _ = x.shape
        g = g.to(x.dtype).contiguous()
        dx, gg = all_gather_matmul(g, _transposed(w))
        dw = _rank_dw(x, gg.reshape(G, n, mk, g.shape[-1]))
        return dx, dw.to(w.dtype)


class RingShift(torch.autograd.Function):
    """:func:`ring_shift`, differentiable: the cotangent shifts the other
    way (the shift kernel again)."""

    @staticmethod
    def forward(ctx, x, reverse: bool = False):
        ctx.reverse = reverse
        return ring_shift(x, reverse)

    @staticmethod
    def backward(ctx, g):
        return ring_shift(g, not ctx.reverse), None
