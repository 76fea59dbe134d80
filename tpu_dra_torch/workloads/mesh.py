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
"""

from __future__ import annotations

import math

import torch

from tpu_dra_torch.device import resolve_device


def axes_of(entry) -> tuple:
    """The mesh axes a spec entry names (``()`` for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Mesh:
    """Named axes of ranks on one device: ``Mesh({"dp": 1, "tp": 4})``.

    ``device`` defaults to the card (``resolve_device``: ``cuda:0``, or
    ``RuntimeError`` without CUDA); the tests pass ``device="cpu"``.  The
    steps and attention functions built on a mesh run on its device, and
    :meth:`check_device` refuses inputs that lie anywhere else."""

    def __init__(self, axes: dict, device=None):
        self.axes = {str(k): int(v) for k, v in dict(axes).items()}
        if not self.axes or any(v < 1 for v in self.axes.values()):
            raise ValueError(f"a mesh needs axes of size >= 1, got {axes}")
        self.device = resolve_device(device)

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

    def unshard(self, t, spec):
        """Stacked ``t`` → the global tensor: the inverse of :meth:`shard`.
        Over an axis the spec does not name, every rank holds the same
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
