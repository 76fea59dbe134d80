"""Mesh constructors, ported from ``tpu_dra/workloads/collectives.py``
(``make_mesh`` 89, ``make_multislice_mesh`` 95-125) onto the virtual mesh
(``mesh.Mesh``): every rank of the mesh lives on one device, so a
constructor takes a count of ranks where the reference takes a list of
devices.

Still to come, with the multi-card host side (ROADMAP.md queue 1 item 9):
the bandwidth functions (``psum_bandwidth``, ``all_gather_bandwidth``,
``ppermute_bandwidth``) and ``matmul_throughput``.  They measure traffic
between cards, which ranks on one card do not make.
"""

from __future__ import annotations

from tpu_dra_torch.workloads.mesh import Mesh


def make_mesh(n_ranks: int, axis: str = "x", device=None) -> Mesh:
    """One axis of ``n_ranks`` ranks: ``Mesh({axis: n_ranks})``."""
    return Mesh({axis: n_ranks}, device=device)


def make_multislice_mesh(num_slices: int, n_ranks: int, tp: int = 1,
                         device=None) -> Mesh:
    """A ``("dcn", "dp", "tp")`` mesh of ``num_slices`` slices of
    ``n_ranks / num_slices`` ranks each, ``tp`` of them a tensor-parallel
    group: the layout of the reference's multislice mesh, whose outer
    "dcn" axis crosses slice boundaries.  Raises ``ValueError`` where the
    ranks do not split into equal slices or ``tp`` does not divide a
    slice, as the reference does."""
    if n_ranks % num_slices:
        raise ValueError(f"{n_ranks} devices do not split into {num_slices} "
                         f"equal slices")
    per_slice = n_ranks // num_slices
    if per_slice % tp:
        raise ValueError(f"tp={tp} does not divide slice size {per_slice}")
    return Mesh({"dcn": num_slices, "dp": per_slice // tp, "tp": tp},
                device=device)
