"""Collective benchmarks and mesh constructors, ported from
``tpu_dra/workloads/collectives.py``.

The bandwidth half measures the collectives the workloads ride between
processes of a ``torch.distributed`` group, one device a process (the
reference times jitted ``lax.psum`` / ``ppermute`` / ``all_gather`` /
``psum_scatter`` over a ``Mesh`` of devices): ``all_reduce``, a ring
shift by ``batch_isend_irecv``, ``all_gather_into_tensor`` and
``reduce_scatter_tensor``, each reported as achieved bytes/s against the
algorithmic bytes it moves, and ``matmul_throughput``, one device's bf16
product rate.  The functions take a group where the reference takes a
``Mesh`` (``None``: the default group); the buffers live on the group's
device: the card under NCCL, the CPU under gloo (which moves CUDA
tensors through host memory anyway, and takes them for ``all_reduce``
and ``broadcast`` only).

The constructors (``make_mesh`` 89, ``make_multislice_mesh`` 95-125)
build the virtual mesh (``mesh.Mesh``): every rank of it lives on one
device, so they take a count of ranks where the reference takes a list
of devices.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from tpu_dra_torch.device import resolve_device
from tpu_dra_torch.workloads.mesh import Mesh


@dataclass
class CollectiveResult:
    name: str
    n_devices: int
    buffer_bytes: int
    seconds_per_op: float
    algo_bytes_per_s: float


def group_device(group=None) -> torch.device:
    """Where a group's buffers live: the process's card under NCCL, the
    CPU under any other backend."""
    import torch.distributed as dist
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _agreed(n: int, ranks, device) -> int:
    """The largest ``n`` over ``ranks`` (a process group, or None for
    this process alone): every rank must run the same number of
    collectives, and each calibrates on its own clock."""
    if ranks is None:
        return n
    import torch.distributed as dist
    t = torch.tensor([n], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=ranks)
    return int(t.item())


def _ranks(group):
    """The group whose ranks all run a collective: ``group``, or the
    default group."""
    import torch.distributed as dist
    return dist.group.WORLD if group is None else group


def _time_op(fn, x, iters: int | None = None, budget_s: float = 0.25,
             ranks=None) -> float:
    """Seconds of one application of the shape-preserving ``fn``, as the
    reference measures it: the op chained ``iters`` times and then
    ``2·iters`` times (each run ends in a scalar readback), the constant
    dispatch and readback cost removed by the difference, best of 5.
    ``iters=None`` sizes the chain to ``budget_s`` a run from one timed
    application (``clamp(budget / t, 3, 1000)``, the largest over the
    group); explicit ``iters`` wins.  On the card the runs are timed with
    CUDA events, on the CPU with the host clock.  ``ranks``: the process
    group whose every rank runs ``fn`` (its collectives), None when it
    runs in this process alone."""
    cuda = x.device.type == "cuda"

    def run(n: int) -> float:
        a = x
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            a = fn(a)
        float(a.float().sum())
        if cuda:
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        return time.perf_counter() - t0

    if iters is None:
        run(1)                             # warm
        t_one = max(run(1), 1e-9)
        iters = _agreed(max(3, min(1000, int(budget_s / t_one))), ranks,
                        x.device)
    run(iters)                             # warm both lengths
    run(2 * iters)
    t1 = min(run(iters) for _ in range(5))
    t2 = min(run(2 * iters) for _ in range(5))
    return max((t2 - t1) / iters, 1e-9)


def _buffer(group, mib_per_device: int, device, multiple: int = 1):
    """This process's bf16 buffer of ``mib_per_device`` MiB (rounded down
    to a multiple of ``multiple`` elements) and the group's size."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    elems = (mib_per_device * 1024 * 1024 // 2) // multiple * multiple
    dev = group_device(group) if device is None else torch.device(device)
    return torch.ones(elems, dtype=torch.bfloat16, device=dev), n


def psum_bandwidth(group=None, mib_per_device: int = 64,
                   iters: int | None = None,
                   device=None) -> CollectiveResult:
    """All-reduce bandwidth.  Ring all-reduce moves 2·(n-1)/n of the
    buffer per device; achieved B/s is reported against that algorithmic
    volume."""
    import torch.distributed as dist
    x, n = _buffer(group, mib_per_device, device)
    inv = 1.0 / n

    def allreduce(v):
        v = v.clone()
        dist.all_reduce(v, group=group)
        return v * inv

    secs = _time_op(allreduce, x, iters=iters, ranks=_ranks(group))
    buffer_bytes = x.numel() * 2
    algo = 2 * (n - 1) / max(n, 1) * buffer_bytes / secs if n > 1 else \
        buffer_bytes / secs
    return CollectiveResult("psum", n, buffer_bytes, secs, algo)


def ppermute_bandwidth(group=None, mib_per_device: int = 64,
                       iters: int | None = None,
                       device=None) -> CollectiveResult:
    """Neighbour-exchange (ring) bandwidth, the point-to-point probe:
    each rank sends its buffer to rank + 1 and receives rank - 1's."""
    import torch.distributed as dist
    x, n = _buffer(group, mib_per_device, device)
    me = dist.get_rank(group)

    def peer(r: int) -> int:
        r %= n
        return r if group is None else dist.get_global_rank(group, r)

    def shift(v):
        out = torch.empty_like(v)
        ops = [dist.P2POp(dist.isend, v, peer(me + 1), group),
               dist.P2POp(dist.irecv, out, peer(me - 1), group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out

    secs = _time_op(shift, x, iters=iters, ranks=_ranks(group))
    buffer_bytes = x.numel() * 2
    return CollectiveResult("ppermute", n, buffer_bytes, secs,
                            buffer_bytes / secs)


def all_gather_bandwidth(group=None, mib_per_device: int = 64,
                         iters: int | None = None,
                         device=None) -> CollectiveResult:
    """All-gather bandwidth: every device receives the other n-1 shards.
    The timed op must be shape-preserving (``_time_op`` chains it), so the
    gathered buffer is folded back through a tiny scaled mean that keeps
    the collective live."""
    import torch.distributed as dist
    x, n = _buffer(group, mib_per_device, device)

    def gather(v):
        w = torch.empty(n * v.numel(), dtype=v.dtype, device=v.device)
        dist.all_gather_into_tensor(w, v, group=group)
        return v + 1e-8 * w.float().mean().to(v.dtype)

    secs = _time_op(gather, x, iters=iters, ranks=_ranks(group))
    buffer_bytes = x.numel() * 2
    algo = (n - 1) * buffer_bytes / secs if n > 1 else buffer_bytes / secs
    return CollectiveResult("all_gather", n, buffer_bytes, secs, algo)


def reduce_scatter_bandwidth(group=None, mib_per_device: int = 64,
                             iters: int | None = None,
                             device=None) -> CollectiveResult:
    """Reduce-scatter bandwidth: each device sends its buffer and keeps
    one reduced shard, the other half of the ring all-reduce."""
    import torch.distributed as dist
    x, n = _buffer(group, mib_per_device, device,
                   multiple=dist.get_world_size(group))

    def scatter(v):
        r = torch.empty(v.numel() // n, dtype=v.dtype, device=v.device)
        dist.reduce_scatter_tensor(r, v, group=group)
        return v + 1e-8 * r.float().mean().to(v.dtype)

    secs = _time_op(scatter, x, iters=iters, ranks=_ranks(group))
    buffer_bytes = x.numel() * 2
    algo = (n - 1) / max(n, 1) * buffer_bytes / secs if n > 1 else \
        buffer_bytes / secs
    return CollectiveResult("reduce_scatter", n, buffer_bytes, secs, algo)


def matmul_throughput(size: int = 4096, iters: int | None = None,
                      device=None) -> float:
    """One device's bf16 matmul TFLOP/s (keeps the benchmark honest about
    the device actually running), on ``device`` (default: the card)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a = torch.randn((size, size), generator=gen, device=dev).to(
        torch.bfloat16)
    b = torch.randn((size, size), generator=gen, device=dev).to(
        torch.bfloat16)
    inv = 1.0 / size                        # keep the chained values finite

    def mm(x):
        return (x @ b) * inv

    secs = _time_op(mm, a, iters=iters)
    return 2 * size ** 3 / secs / 1e12


def make_mesh(n_ranks: int, axis: str = "x", device=None) -> Mesh:
    """One axis of ``n_ranks`` ranks: ``Mesh({axis: n_ranks})``."""
    return Mesh({axis: n_ranks}, device=device)


def make_multislice_mesh(num_slices: int, n_ranks: int, tp: int = 1,
                         device=None, processes: bool = False):
    """A ``("dcn", "dp", "tp")`` mesh of ``num_slices`` slices of
    ``n_ranks / num_slices`` ranks each, ``tp`` of them a tensor-parallel
    group: the layout of the reference's multislice mesh, whose outer
    "dcn" axis crosses slice boundaries.  Raises ``ValueError`` where the
    ranks do not split into equal slices or ``tp`` does not divide a
    slice, as the reference does.  ``processes=True``: a
    ``mesh.ProcessMesh`` of the same axes over the default process group
    of ``n_ranks`` processes (every one of them calls this together),
    else a virtual ``Mesh``."""
    if n_ranks % num_slices:
        raise ValueError(f"{n_ranks} devices do not split into {num_slices} "
                         f"equal slices")
    per_slice = n_ranks // num_slices
    if per_slice % tp:
        raise ValueError(f"tp={tp} does not divide slice size {per_slice}")
    axes = {"dcn": num_slices, "dp": per_slice // tp, "tp": tp}
    if processes:
        from tpu_dra_torch.workloads.mesh import ProcessMesh
        return ProcessMesh(axes, device=device)
    return Mesh(axes, device=device)
