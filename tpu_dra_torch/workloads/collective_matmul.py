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
hand-written kernels of ``csrc/ring.cu`` or raise: one launch a call,
which runs every ring step and synchronizes them inside the kernel on
flags in global memory (the reference's DMA semaphores), so each call
over n > 1 ranks adds one to its wrapper's ``launches``.  At n = 1 the
matmuls are the plain product (the reference's ``n == 1`` branches,
1144-1146 and 1221-1223) and the shift the identity: no kernel runs.

The flags carry each call's number on its ring (the epoch), so they are
never reset; the virtual ring keeps one zeroed buffer a (device,
stream, groups, ranks) (:func:`_virtual_flags`).  A wait in the kernel
is bounded (:data:`SPIN_TIMEOUT_S`): past the bound the kernel traps,
and the next ring call, or :func:`ring_synchronize`, raises
:class:`RingTimeout` naming the ring, the rank and the step.  A call
cannot be captured into a CUDA graph: a replay would reuse its epoch.

Across processes (:class:`ProcessRing`, one rank a process of a
``torch.distributed`` group, as the reference's kernels run one rank a
chip): each process passes its own shard, unstacked, and launches the
same kernels for its own rank, the copies to its neighbours landing in
their buffers through CUDA IPC; ``ProcessAllGatherMatmul``,
``ProcessMatmulReduceScatter`` and ``ProcessRingShift`` are the custom
VJPs there.  Their launches count on the same wrappers' ``launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from tpu_dra_torch.kernels.build import check_launch, library, require_cuda
from tpu_dra_torch.workloads import matmul
from tpu_dra_torch.workloads.mesh import (all_gather, group_all_gather,
                                          group_sendrecv, ppermute,
                                          psum_scatter)
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

# The bound of a ring kernel's waits on its flags, in seconds, read at
# every launch: a neighbour that never comes faults the kernel instead
# of hanging the card
SPIN_TIMEOUT_S = 30.0

_KERNELS = {1: "all_gather_matmul", 2: "matmul_reduce_scatter",
            3: "ring_shift"}
_WAITS = {0: "the neighbour barrier (its neighbour's start of the call)",
          1: "a gathered slot", 2: "a partial sum",
          3: "the block shifted into it"}


class RingTimeout(RuntimeError):
    """A ring kernel waited past :data:`SPIN_TIMEOUT_S` for a flag."""


def ring_fault() -> str | None:
    """What the fault record of ``csrc/ring.cu`` says, or None: the
    kernel, ring, rank and step of a wait that ran past the bound."""
    rec = (ctypes.c_int * 8)()
    if library("ring").tpu_dra_ring_fault(rec) != 1:
        return None
    _, kernel, g, r, step, epoch, what, local = rec
    ring = "the process ring" if local else f"group {g} of the virtual ring"
    return (f"{_KERNELS.get(kernel, kernel)}: rank {r} of {ring} waited "
            f"past the spin bound ({SPIN_TIMEOUT_S} s) for "
            f"{_WAITS.get(what, what)} at ring step {step} (call {epoch} "
            f"on the ring)")


def ring_synchronize(device=None) -> None:
    """Synchronize the current stream of ``device``; where a ring kernel
    faulted on its spin bound, raise :class:`RingTimeout` naming its ring,
    rank and step instead of the bare CUDA error."""
    try:
        torch.cuda.current_stream(device).synchronize()
    except RuntimeError as err:
        msg = ring_fault()
        if msg is None:
            raise
        raise RingTimeout(msg) from err


def _ring_library(what: str):
    """The ring library, once no earlier ring kernel has faulted and the
    spin bound is set; refuses a CUDA graph capture."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} cannot be captured in a CUDA graph: "
                           f"each call carries its own epoch")
    lib = library("ring")
    msg = ring_fault()
    if msg is not None:
        raise RingTimeout(msg)
    check_launch(lib, lib.tpu_dra_ring_set_timeout(SPIN_TIMEOUT_S), what)
    return lib


# (device index, stream, groups, ranks) → [flag words, the last epoch]
_FLAGS: dict = {}


def _virtual_flags(lib, device, stream: int, G: int, n: int) -> tuple:
    """The virtual ring's zeroed flag words ``[G, n, words]`` for calls on
    ``stream`` and the next call's epoch (the calls numbered from 1)."""
    key = (device.index, stream, G, n)
    rec = _FLAGS.get(key)
    if rec is None:
        words = lib.tpu_dra_ring_flag_words(n)
        rec = _FLAGS[key] = [torch.zeros(G * n * words, dtype=torch.int32,
                                         device=device), 0]
    rec[1] += 1
    return rec[0].data_ptr(), rec[1]


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
    table) once for all n ring steps, bidirectional where m is even and
    n > 2 as the reference chooses, or raise; each launch adds one to
    ``all_gather_matmul.launches``."""
    G, n, m, K, N = _ring_dims(x, w, "all_gather_matmul")
    if x.device.type == "cpu":
        return all_gather_matmul_ref(x, w)
    require_cuda(x, "all_gather_matmul")
    if n == 1:
        return _plain_rank_product(x, w), x[:, :, None]
    w_rs, w_gs = _check_matmul_args(x, w, K, N, "all_gather_matmul")
    lib = _ring_library("all_gather_matmul")
    y = torch.empty((G, n, n * m, N), dtype=x.dtype, device=x.device)
    a = torch.empty((G, n, n, m, K), dtype=x.dtype, device=x.device)
    bidir = int(m % 2 == 0 and n > 2)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    flags, epoch = _virtual_flags(lib, x.device, stream, G, n)
    rc = lib.tpu_dra_ring_ag_matmul(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), a.data_ptr(), flags, G, n,
        m, K, N, m * K, n * m * K, w_rs, w_gs, bidir, epoch, stream)
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
    once for all n ring steps, its fp32 partial chunks passed rank to rank
    through a scratch of n − 1 slots a rank (one a step, none reused), or
    raise; each launch adds one to ``matmul_reduce_scatter.launches``."""
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
    lib = _ring_library("matmul_reduce_scatter")
    y = torch.empty((G, n, m, N), dtype=x.dtype, device=x.device)
    comm = torch.empty((G, n, n - 1, m, N), dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    flags, epoch = _virtual_flags(lib, x.device, stream, G, n)
    rc = lib.tpu_dra_ring_matmul_rs(
        x.data_ptr(), w.data_ptr(), comm.data_ptr(), y.data_ptr(), flags, G,
        n, m, K, N, mk * K, n * mk * K, w_rs, w_gs, epoch, stream)
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
    lib = _ring_library("ring_shift")
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


# --------------------------------------------------------------------------
# The ring across processes
# --------------------------------------------------------------------------


def _local_dims(x, w, what: str):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{what} takes this rank's x [rows, K] and w [K, "
                         f"N], got {tuple(x.shape)} and {tuple(w.shape)}")
    return x.shape[0], x.shape[1], w.shape[1]


def _cuda_ok(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.tpu_dra_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


class ProcessRing:
    """The ring kernels over the processes of a ``torch.distributed``
    group, one rank a process: group rank r is ring rank r, its
    neighbours r ± 1 mod n.  Each call takes this rank's own operands:
    x ``[m, K]`` and w ``[K, N]`` for the gather (``(y [n·m, N], a [n,
    m, K])``), x ``[n·m, K]`` for the reduce-scatter (``y [m, N]``), any
    tensor for the shift.

    CPU tensors take the group plain versions (``*_ref``; the oracle on
    the card too): the gather by ``dist.all_gather`` and an fp32 product,
    the reduce-scatter's fp32 partial chunks passed rank to rank and
    added in the kernel's ring order, the shift by a send and a receive.
    CUDA tensors launch the kernels of ``csrc/ring.cu`` for this rank
    alone (the ``_peer`` C entries) or raise, one launch a call, each
    counted on the module's wrapper (``all_gather_matmul.launches`` and
    the others) as on the virtual ring.

    Peer buffers.  The gathered ``a``, the reduce-scatter's fp32 ``comm
    [n − 1, m, N]`` and the shift's output are written by the neighbours:
    they live in one buffer of this process, ``cudaMalloc``'d in the C
    side (the base of an allocation, as ``cudaIpcGetMemHandle`` wants),
    sized for the largest call so far.  Its IPC handle goes to every
    process once, and each opens its two neighbours'; a larger call grows
    every buffer and exchanges the handles again.  Every rank's call has
    the same shapes (a ring's slots are one size), so every process
    grows at the same call.  Results are copied out of the buffer, which
    the next call reuses.

    Order.  The kernels synchronize among themselves: each call's
    number on the ring (the epoch) goes to the kernel, which raises it in
    its neighbours' flag words (allocated and opened once, beside the
    buffers) and waits for theirs before it writes into them (the
    reference's neighbour barrier), then waits on flags for every slot or
    partial a neighbour delivers.  So a call neither synchronizes the
    stream nor meets the group; only growing the buffers and
    :meth:`close` (every process together) do."""

    def __init__(self, group=None):
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.right = (self.rank + 1) % self.n
        self.left = (self.rank - 1) % self.n
        self._buf = None        # this process's buffer (a device pointer)
        self._bytes = 0
        self._peers = {}        # neighbour's group rank → its mapped buffer
        self._flags = None      # this process's flag words
        self._flag_peers = {}   # neighbour's group rank → its flag words
        self._epoch = 0         # the calls launched on the ring

    # -- plain versions ---------------------------------------------------

    def all_gather_matmul_ref(self, x, w):
        """``(y, a)``: ``a [n, m, K]`` every rank's x in rank order,
        ``y = bf16(a·w)`` summed in fp32."""
        m, K, N = _local_dims(x, w, "all_gather_matmul")
        a = torch.stack(group_all_gather(x, self.group))
        y = a.reshape(self.n * m, K).float() @ w.float()
        return y.to(x.dtype), a

    def matmul_reduce_scatter_ref(self, x, w):
        """``y [m, N]``: chunk r of the ranks' summed fp32 products, added
        in ring order from rank r + 1 (``mesh.psum_scatter``'s order),
        each rank's running sum sent on to the next, rounded once."""
        mk, K, N = _local_dims(x, w, "matmul_reduce_scatter")
        n, r = self.n, self.rank
        if mk % n:
            raise ValueError(f"matmul_reduce_scatter: rows {mk} do not "
                             f"split over {n} ranks")
        m = mk // n
        part = x.float() @ w.float()
        acc = None
        for t in range(n):
            c = (r - 1 - t) % n
            mine = part[c * m:(c + 1) * m]
            acc = mine if acc is None else mine + acc
            if t < n - 1:
                acc = group_sendrecv(acc, self.right, self.left, self.group)
        return acc.to(x.dtype)

    def ring_shift_ref(self, x, reverse: bool = False):
        """This rank's ``x`` goes to rank r + 1 (``reverse``: r − 1); the
        block of rank r − 1 (r + 1) comes back."""
        if self.n == 1:
            return x.clone()
        to, frm = (self.left, self.right) if reverse else \
            (self.right, self.left)
        return group_sendrecv(x, to, frm, self.group)

    # -- the kernels across processes -------------------------------------

    def _buffers(self, device, nbytes: int) -> tuple:
        """``(own, right, left)`` pointers, this buffer at least ``nbytes``
        (every process's, as every rank's call asks the same), then the
        flag words and the call's epoch.  The group meets only to grow."""
        if nbytes > self._bytes:
            self._grow(device, nbytes)
        self._epoch += 1
        return (self._buf, self._peers[self.right], self._peers[self.left],
                self._flags, self._flag_peers[self.right],
                self._flag_peers[self.left], self._epoch)

    def _open(self, lib, nbytes: int, what: str) -> tuple:
        """A zeroed buffer of ``nbytes`` in this process and its two
        neighbours' mapped, the handles exchanged across the group."""
        ptr = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(64)
        _cuda_ok(lib, lib.tpu_dra_ipc_alloc(nbytes, ctypes.byref(ptr),
                                            handle), f"ProcessRing {what}")
        handles = [None] * self.n
        dist.all_gather_object(handles, handle.raw, group=self.group)
        peers = {}
        for peer in sorted({self.right, self.left}):
            mapped = ctypes.c_void_p()
            _cuda_ok(lib, lib.tpu_dra_ipc_open(handles[peer],
                                               ctypes.byref(mapped)),
                     f"ProcessRing: opening rank {peer}'s {what}")
            peers[peer] = mapped.value
        return ptr.value, peers

    def _grow(self, device, nbytes: int) -> None:
        """Every process together, once no kernel of the ring runs."""
        lib = library("ring")
        torch.cuda.set_device(device)
        torch.cuda.current_stream(device).synchronize()
        dist.barrier(group=self.group)
        self._release(lib)
        if self._flags is None:
            self._flags, self._flag_peers = self._open(
                lib, 4 * lib.tpu_dra_ring_flag_words(self.n), "flag words")
        self._buf, self._peers = self._open(lib, nbytes, "buffer")
        self._bytes = nbytes

    def _release(self, lib, flags: bool = False) -> None:
        """Unmap the neighbours' buffers (and flag words) and free this
        process's, every process together."""
        own = [self._buf] + ([self._flags] if flags else [])
        peers = [self._peers] + ([self._flag_peers] if flags else [])
        if all(p is None for p in own):
            return
        for mapped in peers:
            for ptr in mapped.values():
                _cuda_ok(lib, lib.tpu_dra_ipc_close(ptr),
                         "ProcessRing: closing a neighbour's buffer")
        dist.barrier(group=self.group)   # no peer holds them open
        for ptr in own:
            if ptr is not None:
                _cuda_ok(lib, lib.tpu_dra_ipc_free(ptr), "ProcessRing buffer")
        self._buf, self._bytes, self._peers = None, 0, {}
        if flags:
            self._flags, self._flag_peers = None, {}

    def _copy_out(self, lib, shape, like):
        out = torch.empty(shape, dtype=like.dtype, device=like.device)
        _cuda_ok(lib, lib.tpu_dra_ipc_copy(
            out.data_ptr(), self._buf, out.numel() * out.element_size(),
            torch.cuda.current_stream(like.device).cuda_stream),
            "ProcessRing: copying out of the buffer")
        return out

    def close(self) -> None:
        """Unmap the neighbours' buffers and flag words and free this
        process's; every process of the group calls it together."""
        if self._buf is not None or self._flags is not None:
            torch.cuda.synchronize()
            dist.barrier(group=self.group)
            self._release(library("ring"), flags=True)

    def all_gather_matmul(self, x, w):
        """``(y [n·m, N], a [n, m, K])`` for this rank's x ``[m, K]`` and
        w ``[K, N]`` (row #9 of the kernel table): one launch for the n
        ring steps, bidirectional where m is even and n > 2, as the
        reference chooses."""
        m, K, N = _local_dims(x, w, "all_gather_matmul")
        if x.device.type == "cpu":
            return self.all_gather_matmul_ref(x, w)
        require_cuda(x, "all_gather_matmul")
        n = self.n
        if n == 1:
            return dot_f32(x, w).to(x.dtype), x[None]
        _check_matmul_args(x[None, None], w[None, None], K, N,
                           "all_gather_matmul")
        lib = _ring_library("all_gather_matmul")
        own, right, left, *flags, epoch = self._buffers(x.device,
                                                        n * m * K * 2)
        y = torch.empty((n * m, N), dtype=x.dtype, device=x.device)
        bidir = int(m % 2 == 0 and n > 2)
        rc = lib.tpu_dra_ring_ag_matmul_peer(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), own, right, left,
            *flags, self.rank, n, m, K, N, bidir, epoch,
            torch.cuda.current_stream(x.device).cuda_stream)
        check_launch(lib, rc, "all_gather_matmul")
        all_gather_matmul.launches += 1
        return y, self._copy_out(lib, (n, m, K), x)

    def matmul_reduce_scatter(self, x, w):
        """``y [m, N]``, chunk r of the ranks' summed ``x @ w`` for this
        rank's x ``[n·m, K]`` (row #10): one launch for the n ring steps,
        the fp32 partials passed into rank r + 1's ``comm``."""
        mk, K, N = _local_dims(x, w, "matmul_reduce_scatter")
        n = self.n
        if mk % n:
            raise ValueError(f"matmul_reduce_scatter: rows {mk} do not "
                             f"split over {n} ranks")
        if x.device.type == "cpu":
            return self.matmul_reduce_scatter_ref(x, w)
        require_cuda(x, "matmul_reduce_scatter")
        if n == 1:
            return dot_f32(x, w).to(x.dtype)
        m = mk // n
        _check_matmul_args(x[None, None], w[None, None], K, N,
                           "matmul_reduce_scatter")
        lib = _ring_library("matmul_reduce_scatter")
        own, right, _, *flags, epoch = self._buffers(x.device,
                                                     (n - 1) * m * N * 4)
        y = torch.empty((m, N), dtype=x.dtype, device=x.device)
        rc = lib.tpu_dra_ring_matmul_rs_peer(
            x.data_ptr(), w.data_ptr(), own, right, y.data_ptr(), *flags,
            self.rank, n, m, K, N, epoch,
            torch.cuda.current_stream(x.device).cuda_stream)
        check_launch(lib, rc, "matmul_reduce_scatter")
        matmul_reduce_scatter.launches += 1
        return y

    def ring_shift(self, x, reverse: bool = False):
        """This rank's ``x`` into rank r + 1's buffer (``reverse``: r − 1)
        and the block that landed here back (row #11): one launch, which
        ends once that block has landed."""
        if x.device.type == "cpu":
            return self.ring_shift_ref(x, reverse)
        require_cuda(x, "ring_shift")
        if self.n == 1:
            return x.clone()
        x = x.contiguous()
        nbytes = x.numel() * x.element_size()
        if nbytes == 0:
            return torch.empty_like(x)
        lib = _ring_library("ring_shift")
        _, right, left, *flags, epoch = self._buffers(x.device, nbytes)
        rc = lib.tpu_dra_ring_shift_peer(
            x.data_ptr(), left if reverse else right, nbytes, *flags,
            self.rank, self.n, -1 if reverse else 1, epoch,
            torch.cuda.current_stream(x.device).cuda_stream)
        check_launch(lib, rc, "ring_shift")
        ring_shift.launches += 1
        return self._copy_out(lib, x.shape, x)


class ProcessAllGatherMatmul(torch.autograd.Function):
    """:meth:`ProcessRing.all_gather_matmul`'s y, differentiable, as
    :class:`AllGatherMatmul` on one process's rank: dx rides the
    reduce-scatter kernel on ``g @ wᵀ``, dw is ``aᵀ @ g``.
    ``apply(ring, x, w)``."""

    @staticmethod
    def forward(ctx, ring, x, w):
        y, a = ring.all_gather_matmul(x, w)
        ctx.ring = ring
        ctx.save_for_backward(a, w)
        return y

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        n, m, K = a.shape
        g = g.to(a.dtype).contiguous()
        dx = ctx.ring.matmul_reduce_scatter(g, w.T.contiguous())
        dw = dot_f32(a.reshape(n * m, K).T, g).to(a.dtype)
        return None, dx, dw.to(w.dtype)


class ProcessMatmulReduceScatter(torch.autograd.Function):
    """:meth:`ProcessRing.matmul_reduce_scatter`, differentiable: dx
    rides the gather kernel on ``g`` and ``wᵀ``, dw contracts x against
    the gathered cotangent.  ``apply(ring, x, w)``."""

    @staticmethod
    def forward(ctx, ring, x, w):
        ctx.ring = ring
        ctx.save_for_backward(x, w)
        return ring.matmul_reduce_scatter(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx, gg = ctx.ring.all_gather_matmul(g, w.T.contiguous())
        dw = dot_f32(x.T, gg.reshape(x.shape[0], g.shape[-1])).to(x.dtype)
        return None, dx, dw.to(w.dtype)


class ProcessRingShift(torch.autograd.Function):
    """Each of ``xs`` shifted one rank on (``reverse``: back), in one
    autograd node, so every process runs the shifts of its backward in
    the same order: the cotangents shift the other way.  ``plain``
    takes the group plain version (the reference's ``hop_impl="xla"``)
    instead of the kernel.  ``apply(ring, reverse, plain, *xs)`` returns
    a tuple."""

    @staticmethod
    def forward(ctx, ring, reverse, plain, *xs):
        ctx.ring, ctx.reverse, ctx.plain = ring, reverse, plain
        shift = ring.ring_shift_ref if plain else ring.ring_shift
        return tuple(shift(x, reverse) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ring = ctx.ring
        shift = ring.ring_shift_ref if ctx.plain else ring.ring_shift
        return (None, None, None,
                *(shift(g.contiguous(), not ctx.reverse) for g in gs))
