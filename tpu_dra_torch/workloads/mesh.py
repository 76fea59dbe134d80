"""The virtual device mesh: the port's counterpart of ``jax.sharding.Mesh``
with ``shard_map`` over it, for meshes whose ranks all live on one card.

A tensor split over mesh axes is stored **stacked**: one leading axis per
mesh axis, in the mesh's axis order, followed by the per-rank shard, so
rank ``(i, j)`` of a ``{"dp": 2, "tp": 4}`` mesh holds ``t[i, j]``.  A
tensor a spec leaves replicated over an axis is an expanded view there
(stride 0): every rank reads the same memory, as replicated shards hold the
same values.  :meth:`Mesh.shard` and :meth:`Mesh.unshard` cut a global
tensor by a spec and put it back together (``shard_map``'s ``in_specs``
and ``out_specs``); a spec is a tuple with one entry per dimension: ``None``
(not split), an axis name, or a tuple of axis names (split over their
product, the first outermost), as a ``PartitionSpec`` is.

The collectives act on the stacked axis of a rank dimension: :func:`psum`,
:func:`all_gather`, :func:`psum_scatter` and :func:`ppermute` (``torch.roll``
by ±1).  They are plain PyTorch, the plain versions of the ring kernels
(``collective_matmul.py``) and what the reference's XLA collectives
(``hop_impl="xla"``, the GSPMD reshards) become here.  :func:`psum_scatter`
sums each chunk in ring order, starting at the rank after the chunk's
owner, the order the matmul-reduce-scatter kernel adds in.

One process and a rank axis mirror JAX's single-controller ``shard_map``:
the same code runs on the CPU in the tests and on the card, where one
kernel launch serves every rank.  It does not show that ring traffic
overlaps the compute; only several cards can.

:class:`ProcessMesh` is the other form: one process a rank, over a
``torch.distributed`` group (``launcher.RendezvousInfo.initialize``), the
reference's per-device ``shard_map`` bodies run as they are, each
process holding its own shard unstacked.  Its collectives are the group's
(:func:`group_all_reduce`, :func:`group_all_gather`,
:func:`group_sendrecv`), staged through host memory where the group is
gloo, which takes host tensors: gloo serves the CPU and several
processes that share one card, where NCCL refuses two ranks.  The ring
kernels across processes are ``collective_matmul.ProcessRing``'s.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from tpu_dra_torch.device import resolve_device


def axes_of(entry) -> tuple:
    """The mesh axes a spec entry names (``()`` for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class _Axes:
    """What both meshes share: named axes of ranks, their specs and the
    device the mesh runs on."""

    def _set_axes(self, axes: dict) -> None:
        self.axes = {str(k): int(v) for k, v in dict(axes).items()}
        if not self.axes or any(v < 1 for v in self.axes.values()):
            raise ValueError(f"a mesh needs axes of size >= 1, got {axes}")

    @property
    def axis_names(self) -> tuple:
        return tuple(self.axes)

    @property
    def shape(self) -> tuple:
        return tuple(self.axes.values())

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        """The size of axis ``name`` (1 where the mesh has no such axis, as
        the reference's ``_mesh_axis_sizes(...).get(name, 1)``)."""
        return self.axes.get(name, 1)

    def batch_axes(self):
        """The spec entry of the batch dimension: the mesh's "dcn" and
        "dp" axes where it has them, as ``("dcn", "dp")``, one name, or
        ``None`` (the reference's ``batch_sharding`` and
        ``_fc_batch_axes``)."""
        axes = tuple(a for a in ("dcn", "dp") if a in self.axes)
        return axes if len(axes) > 1 else (axes[0] if axes else None)

    def check_device(self, *tensors) -> None:
        """Raise ``ValueError`` unless every tensor lies on the mesh's
        device."""
        for t in tensors:
            if t.device != self.device:
                raise ValueError(f"the mesh runs on {self.device}; got an "
                                 f"input on {t.device}")

    def _spec(self, spec, ndim: int) -> tuple:
        spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
        if len(spec) != ndim:
            raise ValueError(f"spec {spec} has more entries than the "
                             f"tensor's {ndim} dimensions")
        used = [a for e in spec for a in axes_of(e)]
        for a in used:
            if a not in self.axes:
                raise ValueError(f"spec names axis {a!r}, not in mesh "
                                 f"{self.axes}")
        if len(set(used)) != len(used):
            raise ValueError(f"spec {spec} names an axis twice")
        return spec

    def shard_shape(self, shape, spec) -> tuple:
        """The shape of one rank's shard of a global ``shape`` cut by
        ``spec`` (``NamedSharding.shard_shape``)."""
        spec = self._spec(spec, len(shape))
        return tuple(size // math.prod(self.axes[a] for a in axes_of(e))
                     for size, e in zip(shape, spec))

    def _unstack(self, t, spec):
        """Stacked ``t`` ``[*mesh.shape, *shard]`` → the global tensor:
        over an axis the spec does not name, every rank holds the same
        shard and rank 0's is taken."""
        n_mesh = len(self.axes)
        if tuple(t.shape[:n_mesh]) != self.shape:
            raise ValueError(f"stacked tensor {tuple(t.shape)} does not "
                             f"lead with the mesh shape {self.shape}")
        spec = self._spec(spec, t.dim() - n_mesh)
        named = {a for e in spec for a in axes_of(e)}
        for i in reversed(range(n_mesh)):
            if self.axis_names[i] not in named:
                t = t.select(i, 0)
        kept = [a for a in self.axes if a in named]
        perm, shape = [], []
        for d, entry in enumerate(spec):
            axes = axes_of(entry)
            perm += [kept.index(a) for a in axes] + [len(kept) + d]
            shape.append(t.shape[len(kept) + d]
                         * math.prod(self.axes[a] for a in axes))
        return t.permute(perm).reshape(shape)


class Mesh(_Axes):
    """Named axes of ranks on one device: ``Mesh({"dp": 1, "tp": 4})``.

    ``device`` defaults to the card (``resolve_device``: ``cuda:0``, or
    ``RuntimeError`` without CUDA); the tests pass ``device="cpu"``.  The
    steps and attention functions built on a mesh run on its device, and
    :meth:`check_device` refuses inputs that lie anywhere else."""

    def __init__(self, axes: dict, device=None):
        self._set_axes(axes)
        self.device = resolve_device(device)

    def ring_groups(self, axis: str) -> tuple:
        """``(G, n)`` of a ring over ``axis``, which must be the mesh's
        last axis: a stacked tensor then reshapes to ``[G, n, ...]``, the
        other axes' ranks as G groups of one ring each (the layout of the
        ring kernels)."""
        if self.axis_names[-1] != axis:
            raise ValueError(f"a ring runs over the mesh's last axis; mesh "
                             f"{self.axes} does not end with {axis!r}")
        n = self.axes[axis]
        return self.size // n, n

    def shard(self, x, spec):
        """Global ``x`` → stacked ``[*mesh.shape, *shard]``: dimension d
        is cut over the axes ``spec[d]`` names (each of size dividing it);
        axes the spec does not name are expanded views.  The shards are a
        contiguous copy, so each rank's block is contiguous."""
        spec = self._spec(spec, x.dim())
        shape, pos = [], {}
        for size, entry in zip(x.shape, spec):
            axes = axes_of(entry)
            parts = math.prod(self.axes[a] for a in axes)
            if size % parts:
                raise ValueError(f"dimension of size {size} does not split "
                                 f"evenly over {axes} ({parts} ranks)")
            for a in axes:
                pos[a] = len(shape)
                shape.append(self.axes[a])
            shape.append(size // parts)
        t = x.reshape(shape)
        lead = [pos[a] for a in self.axes if a in pos]
        t = t.permute(lead + [i for i in range(len(shape)) if i not in lead])
        t = t.contiguous()          # each rank's shard in one block
        for i, a in enumerate(self.axes):
            if a not in pos:
                t = t.unsqueeze(i)
        return t.expand(*self.shape, *t.shape[len(self.axes):])

    def local(self, t, spec):
        """Stacked ``t`` → its distinct shards: the mesh axes ``spec`` does
        not name (expanded views) are dropped, leaving ``[*named axes, in
        the mesh's order, *shard]``, a view of the memory every rank reads.
        Written in place, it changes what every rank holds."""
        named = {a for e in self._spec(spec, t.dim() - len(self.axes))
                 for a in axes_of(e)}
        for i in reversed(range(len(self.axes))):
            if self.axis_names[i] not in named:
                t = t.select(i, 0)
        return t

    def from_local(self, t, spec):
        """The inverse of :meth:`local`: the dropped axes come back as
        expanded views."""
        n_named = len({a for e in spec for a in axes_of(e)})
        named = {a for e in self._spec(spec, t.dim() - n_named)
                 for a in axes_of(e)}
        for i, a in enumerate(self.axes):
            if a not in named:
                t = t.unsqueeze(i)
        return t.expand(*self.shape, *t.shape[len(self.axes):])

    def unshard(self, t, spec):
        """Stacked ``t`` → the global tensor: the inverse of :meth:`shard`.
        Over an axis the spec does not name, every rank holds the same
        shard and rank 0's is taken."""
        return self._unstack(t, spec)


# --------------------------------------------------------------------------
# Collectives over the rank dimension ``dim`` of a stacked tensor
# --------------------------------------------------------------------------


def psum(x, dim: int):
    """Every rank gets the sum over the ranks of ``dim``."""
    return x.sum(dim=dim, keepdim=True).expand_as(x)


def all_gather(x, dim: int, gather_dim: int):
    """Every rank gets the ranks' shards concatenated along the shard
    dimension ``gather_dim`` (counted in the tensor, after ``dim``), in
    rank order: ``all_gather(..., tiled=True)``."""
    if gather_dim <= dim:
        raise ValueError("gather_dim must follow the rank dimension")
    g = torch.cat(x.unbind(dim), dim=gather_dim - 1)
    return g.unsqueeze(dim).expand(
        *x.shape[:dim], x.shape[dim], *g.shape[dim:])


def psum_scatter(x, dim: int, scatter_dim: int):
    """Rank c gets chunk c (along ``scatter_dim``) of the sum over the
    ranks, added in ring order: the shard of rank c + 1 first, then each
    following rank's added to the running sum, rank c's last — the order
    of the matmul-reduce-scatter kernel (``psum_scatter(..., tiled=True)``
    of the reference, whose order XLA leaves open)."""
    n = x.shape[dim]
    if scatter_dim <= dim or x.shape[scatter_dim] % n:
        raise ValueError(f"scatter dimension {scatter_dim} of {x.shape} "
                         f"must follow the rank dimension and split over "
                         f"{n} ranks")
    chunks = x.chunk(n, dim=scatter_dim)
    out = []
    for c in range(n):
        acc = chunks[c].select(dim, (c + 1) % n)
        for t in range(1, n):
            acc = chunks[c].select(dim, (c + 1 + t) % n) + acc
        out.append(acc)
    return torch.stack(out, dim=dim)


def ppermute(x, dim: int, shift: int):
    """Rank r's shard moves to rank r + shift (mod n): ``lax.ppermute``
    with ``perm=[(i, (i + shift) % n)]``."""
    return torch.roll(x, shifts=shift, dims=dim)


# --------------------------------------------------------------------------
# A mesh whose ranks are processes
# --------------------------------------------------------------------------


def _global(group, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def _host(x, group) -> bool:
    """Whether a collective of ``group`` needs ``x`` staged through host
    memory: gloo takes host tensors."""
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def group_all_reduce(x, group=None, op=dist.ReduceOp.SUM):
    """The sum (or ``op``) of ``x`` over the group's processes, a new
    tensor on x's device (every process gets the same bits)."""
    buf = x.detach().to("cpu", copy=True) if _host(x, group) \
        else x.detach().clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def group_reduce_scatter(x, group=None):
    """Chunk r (of n along dimension 0) of the sum of ``x`` over the
    group's processes, for group rank r."""
    src = x.detach().to("cpu") if _host(x, group) else x.detach()
    src = src.contiguous()
    n = dist.get_world_size(group)
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(x.device)


def group_all_to_all(x, out_splits: list, in_splits: list, group=None):
    """Rows ``in_splits[d]`` of ``x`` (dimension 0, in order) go to group
    rank d; the rows from each rank s (``out_splits[s]`` of them) come
    back concatenated in rank order."""
    src = x.detach().to("cpu") if _host(x, group) else x.detach()
    src = src.contiguous()
    out = src.new_empty((sum(out_splits), *src.shape[1:]))
    dist.all_to_all_single(out, src, list(out_splits), list(in_splits),
                           group=group)
    return out.to(x.device)


def group_all_gather(x, group=None, device=None) -> list:
    """Every process's ``x``, in group rank order, on x's device (or on
    ``device``: the host keeps what gloo gathered there)."""
    src = x.detach().to("cpu") if _host(x, group) else x.detach()
    src = src.contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [t.to(x.device if device is None else device) for t in out]


def group_gather(x, dst: int, group=None, device=None):
    """Every process's ``x``, in group rank order, at group rank ``dst``
    only (``None`` elsewhere), on x's device or on ``device``."""
    src = x.detach().to("cpu") if _host(x, group) else x.detach()
    src = src.contiguous()
    mine = dist.get_rank(group) == dst
    out = [torch.empty_like(src) for _ in range(
        dist.get_world_size(group))] if mine else None
    dist.gather(src, out, dst=_global(group, dst), group=group)
    if not mine:
        return None
    return [t.to(x.device if device is None else device) for t in out]


def group_sendrecv(x, to: int, frm: int, group=None):
    """Send ``x`` to group rank ``to`` and return the tensor like it that
    group rank ``frm`` sends (``lax.ppermute``'s one pair per process)."""
    src = x.detach().to("cpu") if _host(x, group) else x.detach()
    src = src.contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, _global(group, to), group),
           dist.P2POp(dist.irecv, out, _global(group, frm), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out.to(x.device)


class GroupSum(torch.autograd.Function):
    """:func:`group_all_reduce`, differentiable: its cotangent is summed
    over the group too (the reference's psum under ``shard_map``, whose
    transpose is a psum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group_all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return group_all_reduce(g, ctx.group), None


class GroupCopy(torch.autograd.Function):
    """Identity forward, psum of the cotangent backward (Megatron's entry
    into a tensor-parallel region): where a tensor every rank holds whole
    feeds each rank's share of a product, each rank's cotangent is a part
    and their sum the whole.  ``apply(x, group)``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return group_all_reduce(g, ctx.group), None


class GroupReduce(torch.autograd.Function):
    """Psum forward, identity backward (Megatron's exit from a
    tensor-parallel region): each rank holds a partial sum of a tensor
    that every rank then holds whole, and the whole one's cotangent is
    each part's.  ``apply(x, group)``."""

    @staticmethod
    def forward(ctx, x, group):
        return group_all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class GroupAllGather(torch.autograd.Function):
    """Every rank's ``x`` concatenated along ``dim`` in group rank order
    (``all_gather(..., tiled=True)``).  Its transpose reduce-scatters the
    cotangent along ``dim``; where the cotangent is the same on every
    rank (``replicated_grad``, the gathered tensor feeding replicated
    work) it is this rank's slice.  ``apply(x, group, dim,
    replicated_grad)``."""

    @staticmethod
    def forward(ctx, x, group, dim, replicated_grad):
        ctx.group, ctx.dim, ctx.replicated = group, dim, replicated_grad
        return torch.cat(group_all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.group, ctx.dim
        if ctx.replicated:
            n, r = dist.get_world_size(group), dist.get_rank(group)
            return g.chunk(n, dim)[r].contiguous(), None, None, None
        part = group_reduce_scatter(g.movedim(dim, 0), group)
        return part.movedim(0, dim).contiguous(), None, None, None


class GroupShard(torch.autograd.Function):
    """``shard_map``'s entry on a :class:`ProcessMesh`: a global tensor
    that every process holds alike → this process's shard
    (:meth:`ProcessMesh.shard`).  Its transpose gathers every process's
    cotangent shard into the global cotangent (:meth:`ProcessMesh.
    unshard`), so each process's global input gets the whole gradient,
    as the reference's replicated input does.  ``apply(x, mesh, spec)``."""

    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        return mesh.shard(x, spec)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.unshard(g.contiguous(), ctx.spec), None, None


class GroupUnshard(torch.autograd.Function):
    """``shard_map``'s exit on a :class:`ProcessMesh`: this process's
    shard → the global tensor gathered from every process.  Every process
    differentiates the same global function, so the global cotangent is
    the same on each, and its transpose is this process's shard of it.
    ``apply(t, mesh, spec)``."""

    @staticmethod
    def forward(ctx, t, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        return mesh.unshard(t, spec)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.shard(g, ctx.spec), None, None


def _all_to_all(x, group, split_dim: int, concat_dim: int):
    n = dist.get_world_size(group)
    chunks = torch.stack(x.chunk(n, split_dim))          # chunk d for rank d
    got = group_all_to_all(chunks.reshape(n, -1), [1] * n, [1] * n, group)
    return torch.cat(got.reshape(chunks.shape).unbind(0), dim=concat_dim)


class GroupAllToAll(torch.autograd.Function):
    """``x`` cut into n chunks along ``split_dim``, chunk d sent to group
    rank d, and the chunks received concatenated along ``concat_dim`` in
    rank order (``lax.all_to_all(..., tiled=True)``): a column cut becomes
    a row cut.  Its transpose is the inverse all-to-all.
    ``apply(x, group, split_dim, concat_dim)``."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(g, ctx.group, concat_dim, split_dim), None, None,
                None)


class ColumnPlan:
    """Who sends which columns where to move a last dimension cut one way
    (rank s holds global columns ``src[s]``, in order) to another (rank d
    wants ``dst[d]``, in order, a column possibly on several ranks), from
    group rank ``rank``'s side: each wanted column comes from the first
    rank that holds it.  ``send[d]``: the positions in this rank's
    columns that go to rank d, in d's order; ``recv[s]``: the positions in
    this rank's output that come from rank s."""

    def __init__(self, src, dst, rank: int):
        owner = {}
        for s, cols in enumerate(src):
            for i, c in enumerate(cols):
                owner.setdefault(c, (s, i))
        missing = {c for cols in dst for c in cols} - set(owner)
        if missing:
            raise ValueError(f"no rank holds columns {sorted(missing)[:8]}")
        self.width = len(dst[rank])
        self.send = [[owner[c][1] for c in cols if owner[c][0] == rank]
                     for cols in dst]
        self.recv = [[k for k, c in enumerate(dst[rank]) if owner[c][0] == s]
                     for s in range(len(src))]

    def index(self, which: list, device):
        return torch.tensor([i for part in which for i in part],
                            dtype=torch.long, device=device)


class GroupColumns(torch.autograd.Function):
    """The columns (last dimension) of ``x`` recut by a :class:`ColumnPlan`
    in one all-to-all.  Its transpose sends each cotangent column back to
    the rank that held the column and sums the columns that went to
    several ranks (in fp32, rounded once).  ``apply(x, group, plan)``."""

    @staticmethod
    def forward(ctx, x, group, plan):
        ctx.group, ctx.plan, ctx.shape = group, plan, x.shape
        cols = x.movedim(-1, 0)
        out = group_all_to_all(cols[plan.index(plan.send, x.device)],
                               [len(r) for r in plan.recv],
                               [len(s) for s in plan.send], group)
        y = out.new_empty((plan.width, *cols.shape[1:]))
        y[plan.index(plan.recv, x.device)] = out
        return y.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        cols = g.movedim(-1, 0)
        back = group_all_to_all(cols[plan.index(plan.recv, g.device)],
                                [len(s) for s in plan.send],
                                [len(r) for r in plan.recv], ctx.group)
        gx = torch.zeros((ctx.shape[-1], *cols.shape[1:]),
                         dtype=torch.float32, device=g.device)
        gx.index_add_(0, plan.index(plan.send, g.device), back.float())
        return gx.to(g.dtype).movedim(0, -1), None, None


def process_device(device, rank: int) -> torch.device:
    """The device of a process mesh's rank: ``None`` means its card,
    ``cuda:{rank % device_count}`` (on one card every rank shares
    ``cuda:0``), or ``RuntimeError`` without CUDA; the CPU only when
    asked (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run a process "
                "mesh's plain PyTorch path on the CPU")
        return torch.device("cuda", rank % torch.cuda.device_count())
    return resolve_device(device)


class ProcessMesh(_Axes):
    """Named axes of ranks that are processes: ``ProcessMesh({"dp": 2,
    "sp": 2})`` over the ``torch.distributed`` group ``group`` (default:
    the whole default group), whose size must be the mesh's.  Group rank
    r sits at the row-major coordinates of r over the axes, the
    reference's device order.  Every process of the default group makes
    the mesh together: it builds one sub-group per line of each axis (a
    ring, or a batch group), as ``dist.new_group`` asks.

    Each process holds its own shard: :meth:`shard` cuts a global tensor
    (the same on every process, built from one seed) down to it,
    :meth:`unshard` gathers the shards back, :meth:`psum` sums over named
    axes, :meth:`ring` is the ring kernels over an axis
    (``collective_matmul.ProcessRing``).  ``device``: see
    :func:`process_device`.  :meth:`close` releases the rings' peer
    buffers; every process calls it together."""

    def __init__(self, axes: dict, group=None, device=None):
        self._set_axes(axes)
        if not dist.is_initialized():
            raise RuntimeError("a ProcessMesh needs torch.distributed "
                               "initialized (launcher.RendezvousInfo."
                               "initialize)")
        self.group = group
        if dist.get_world_size(group) != self.size:
            raise ValueError(f"mesh {self.axes} has {self.size} ranks, its "
                             f"group {dist.get_world_size(group)} processes")
        self.rank = dist.get_rank(group)
        self.coords, rest = {}, self.rank
        for name in reversed(self.axis_names):
            rest, self.coords[name] = divmod(rest, self.axes[name])
        self.device = process_device(device, _global(group, self.rank))
        self._lines, self._rings = {}, {}
        for name in self.axis_names:
            self._lines[name] = self._new_lines(name)

    def _new_lines(self, name: str):
        """The sub-group of this process's line along axis ``name`` (the
        ranks whose other coordinates are this one's), made with every
        other line so that each process calls ``dist.new_group`` for
        each, in the same order."""
        if self.axes[name] == self.size:
            return self.group
        strides = {}
        step = 1
        for a in reversed(self.axis_names):
            strides[a] = step
            step *= self.axes[a]
        mine = None
        for base in range(self.size):
            if (base // strides[name]) % self.axes[name]:
                continue          # not the first rank of its line
            ranks = [base + i * strides[name]
                     for i in range(self.axes[name])]
            g = dist.new_group([_global(self.group, r) for r in ranks])
            if self.rank in ranks:
                mine = g
        return mine

    def axis_index(self, name: str) -> int:
        """This process's coordinate on axis ``name``
        (``lax.axis_index``)."""
        return self.coords[name]

    def shard(self, x, spec):
        """Global ``x`` → this process's shard, a contiguous copy:
        dimension d is cut over the axes ``spec[d]`` names (the first
        outermost), as :meth:`Mesh.shard` cuts rank ``coords``'s."""
        spec = self._spec(spec, x.dim())
        for d, entry in enumerate(spec):
            axes = axes_of(entry)
            parts = math.prod(self.axes[a] for a in axes)
            if x.shape[d] % parts:
                raise ValueError(f"dimension of size {x.shape[d]} does not "
                                 f"split evenly over {axes} ({parts} ranks)")
            idx = 0
            for a in axes:
                idx = idx * self.axes[a] + self.coords[a]
            size = x.shape[d] // parts
            x = x.narrow(d, idx * size, size)
        return x.contiguous()

    def unshard(self, t, spec, device=None, dst=None):
        """This process's shard ``t`` → the global tensor, gathered from
        every process (the inverse of :meth:`shard`), on t's device or on
        ``device`` (``"cpu"``: a save's gather, which then takes no card
        memory under gloo); with ``dst`` at that group rank only, and
        ``None`` on the others."""
        if dst is None:
            parts = group_all_gather(t, self.group, device)
        else:
            parts = group_gather(t, dst, self.group, device)
            if parts is None:
                return None
        return self._unstack(torch.stack(parts).reshape(*self.shape,
                                                        *t.shape), spec)

    def shard_in(self, x, spec):
        """:meth:`shard`, differentiable (:class:`GroupShard`): the
        gradient of the global ``x`` is gathered from every process."""
        return GroupShard.apply(x, self, spec)

    def unshard_out(self, t, spec):
        """:meth:`unshard`, differentiable (:class:`GroupUnshard`): the
        global cotangent, the same on every process, comes back as this
        process's shard of it."""
        return GroupUnshard.apply(t, self, spec)

    def shard_tree(self, tree: dict, specs: dict) -> dict:
        """:meth:`shard` of every leaf of a nested dict by the spec at the
        same key (``param_shardings``' form)."""
        return {k: self.shard_tree(v, specs[k]) if isinstance(v, dict)
                else self.shard(v, specs[k]) for k, v in tree.items()}

    def unshard_tree(self, tree: dict, specs: dict, device=None,
                     dst=None) -> dict:
        """:meth:`unshard` of every leaf: the global tree back on every
        process (collective), or at group rank ``dst`` only (its leaves
        ``None`` elsewhere), on ``device`` where one is given."""
        return {k: self.unshard_tree(v, specs[k], device, dst)
                if isinstance(v, dict)
                else self.unshard(v, specs[k], device, dst)
                for k, v in tree.items()}

    def psum(self, x, axes=None):
        """The sum of ``x`` over the processes of the named ``axes``
        (default: all), on every one of them; differentiable, its
        cotangent summed the same way (:class:`GroupSum`)."""
        names = self.axis_names if axes is None else tuple(axes_of(axes))
        groups = [self.group] if set(names) == set(self.axes) else \
            [self._lines[a] for a in names if self.axes[a] > 1]
        for g in groups:
            x = GroupSum.apply(x, g)
        return x

    # -- differentiable collectives along one axis's line, each the
    # identity (or a copy) where the axis has one rank ---------------------

    def all_gather(self, x, axis: str, dim: int,
                   replicated_grad: bool = False):
        """:class:`GroupAllGather` along ``axis``."""
        if self.axes[axis] == 1:
            return x
        return GroupAllGather.apply(x, self._lines[axis], dim,
                                    replicated_grad)

    def all_to_all(self, x, axis: str, split_dim: int, concat_dim: int):
        """:class:`GroupAllToAll` along ``axis``."""
        if self.axes[axis] == 1:
            return x
        return GroupAllToAll.apply(x, self._lines[axis], split_dim,
                                   concat_dim)

    def copy(self, x, axis: str):
        """:class:`GroupCopy` along ``axis``: identity forward, psum
        backward."""
        return x if self.axes[axis] == 1 else \
            GroupCopy.apply(x, self._lines[axis])

    def reduce(self, x, axis: str):
        """:class:`GroupReduce` along ``axis``: psum forward, identity
        backward."""
        return x if self.axes[axis] == 1 else \
            GroupReduce.apply(x, self._lines[axis])

    def pmax(self, x, axis: str):
        """The elementwise max of ``x`` over ``axis``, with no gradient."""
        x = x.detach()
        return x if self.axes[axis] == 1 else \
            group_all_reduce(x, self._lines[axis], dist.ReduceOp.MAX)

    def column_plan(self, axis: str, src, dst) -> ColumnPlan:
        """The :class:`ColumnPlan` of this process's rank along ``axis``."""
        return ColumnPlan(src, dst, self.coords[axis])

    def columns(self, x, axis: str, plan: ColumnPlan):
        """:class:`GroupColumns` along ``axis``."""
        if self.axes[axis] == 1:
            return x[..., plan.index(plan.send, x.device)]
        return GroupColumns.apply(x, self._lines[axis], plan)

    def ring(self, axis: str):
        """The ring kernels over this process's line along ``axis``
        (``collective_matmul.ProcessRing``; one per axis, kept)."""
        if axis not in self._rings:
            from tpu_dra_torch.workloads.collective_matmul import ProcessRing
            self._rings[axis] = ProcessRing(self._lines[axis])
        return self._rings[axis]

    def close(self) -> None:
        """Release every ring's peer buffers (collective)."""
        for ring in self._rings.values():
            ring.close()

