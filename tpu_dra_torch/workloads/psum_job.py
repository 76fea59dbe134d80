"""The slice-domain acceptance job, ported from
``tpu_dra/workloads/psum_job.py`` (the nvbandwidth MPIJob analog).

Each worker pod holds the domain's channel claim; the driver injects the
coordination env and the settings mount.  The job resolves the
rendezvous (``launcher.resolve``), joins the ``torch.distributed`` group
(``RendezvousInfo.initialize``) and runs the four collective benchmarks
across every process of the domain, one device a process.

    python -m tpu_dra_torch.workloads.psum_job [--mib 64] [--local-only]
        [--backend nccl|gloo]

It prints one JSON line: ``n_devices`` (the group's size; 1 with
``--local-only`` or without a claim), ``allreduce_sum`` (the sum of
``rank + 1`` over the group, on the card when there is one: the
rendezvous's own check) and, with more than one device, the reference's
``psum_gbps``, ``ppermute_gbps``, ``all_gather_gbps`` and
``reduce_scatter_gbps``.  ``--backend`` (default ``nccl``) is the port's
own flag: ``gloo`` runs on the CPU, and lets several processes share one
card, which NCCL refuses; its buffers live in host memory, so its
bandwidths are not card-to-card figures.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    from tpu_dra_torch.workloads.launcher import BACKENDS, resolve
    parser = argparse.ArgumentParser()
    parser.add_argument("--mib", type=int, default=64,
                        help="per-device buffer MiB")
    parser.add_argument("--local-only", action="store_true",
                        help="skip torch.distributed (single-host smoke "
                             "test)")
    parser.add_argument("--backend", choices=BACKENDS, default="nccl",
                        help="torch.distributed backend: nccl (one card a "
                             "process) or gloo (the CPU, or processes "
                             "sharing a card)")
    args = parser.parse_args(argv)

    import torch
    import torch.distributed as dist
    if not args.local_only and os.environ.get("SLICE_DOMAIN_UUID"):
        info = resolve()
        print(f"rendezvous: coordinator={info.coordinator_address} "
              f"processes={info.num_processes} rank={info.process_id}",
              flush=True)
        info.initialize(args.backend)

    from tpu_dra_torch.workloads.collectives import (
        all_gather_bandwidth,
        ppermute_bandwidth,
        psum_bandwidth,
        reduce_scatter_bandwidth,
    )

    grouped = dist.is_initialized()
    n = dist.get_world_size() if grouped else 1
    check = torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")
    kind = torch.cuda.get_device_name(check) if check.type == "cuda" \
        else "cpu"
    print(f"devices: {n} × {kind}", flush=True)
    total = torch.tensor([float(dist.get_rank() + 1 if grouped else 1)],
                         device=check)
    if grouped:
        dist.all_reduce(total)
    results = {"allreduce_sum": float(total.item())}
    if n > 1:
        # the four collectives the workloads ride: all-reduce
        # (gradients), the ring shift (ring attention), all-gather and
        # reduce-scatter (the exposed communication the fused
        # collective-matmul kernels overlap away)
        suite = {
            "psum": psum_bandwidth,
            "ppermute": ppermute_bandwidth,
            "all_gather": all_gather_bandwidth,
            "reduce_scatter": reduce_scatter_bandwidth,
        }
        for name, bench in suite.items():
            res = bench(mib_per_device=args.mib)
            results[f"{name}_gbps"] = round(res.algo_bytes_per_s / 1e9, 2)
    print(json.dumps({"n_devices": n, **results}), flush=True)
    if grouped:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
