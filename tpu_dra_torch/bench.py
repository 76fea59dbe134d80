"""Benchmark sections of the port, the counterparts of ``bench.py``'s.

So far one: :func:`section_pallas_matmul`, the tiled-matmul kernel's
throughput (``bench.py`` ``section_pallas_matmul``).  The other sections
wait for the bench slice of the port.  A section measures the card: it
raises where CUDA is absent instead of timing the CPU.

    python -m tpu_dra_torch.bench       # prints one JSON line
"""

from __future__ import annotations

import json

import torch

# NVIDIA's data-sheet dense bf16 peak of one H100 SXM
H100_BF16_FLOPS = 989e12


def section_pallas_matmul() -> dict:
    """``matmul.matmul`` (row #2, ``csrc/matmul.cu``) on ``[n, n] @ [n,
    n]`` bf16 on the card, n = 4096: the op ``x ← matmul(x, b)·(1/n)``
    chained 200 times as the reference times it, timed with CUDA events
    after a warm-up.  Returns ``pallas_matmul_tflops`` (2n³ per op) and
    its share of the card's 989 TF/s bf16 peak as
    ``pallas_matmul_mfu_pct``, with the card's name."""
    from tpu_dra_torch.device import resolve_device
    from tpu_dra_torch.workloads.matmul import matmul
    n, iters = 4096, 200
    dev = resolve_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a = torch.randn((n, n), generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn((n, n), generator=gen, device=dev).to(torch.bfloat16)
    inv = float(torch.tensor(1.0 / n, dtype=torch.bfloat16))

    def run(x, count):
        for _ in range(count):
            x = matmul(x, b) * inv
        return x

    run(a, 3)
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = run(a, iters)
    end.record()
    torch.cuda.synchronize(dev)
    if not bool(torch.isfinite(out.float()).all()):
        raise RuntimeError("pallas matmul produced non-finite values")
    secs = start.elapsed_time(end) / 1e3 / iters
    tflops = 2 * n ** 3 / secs / 1e12
    return {"pallas_matmul_tflops": round(tflops, 2),
            "pallas_matmul_mfu_pct": round(
                100.0 * tflops * 1e12 / H100_BF16_FLOPS, 2),
            "device": torch.cuda.get_device_name(dev)}


def main() -> None:
    print(json.dumps(section_pallas_matmul()))


if __name__ == "__main__":
    main()
