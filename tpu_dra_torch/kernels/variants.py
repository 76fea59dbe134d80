"""Time variants of the flash forward kernel on the card, to show what each
part of its design buys.

A variant is ``csrc/flash_fwd.cu`` with named text substitutions (the
source as it stands is the first).  Each is built with the port's nvcc
flags into ``tpu_dra_torch/_build/variants/``, held to the plain version
(max abs error) and timed through its C entry with CUDA events at the
training path's shapes, each in a process of its own under a time limit,
so a variant that hangs costs only its limit.  Needs one CUDA card:

    python -m tpu_dra_torch.kernels.variants
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

from tpu_dra_torch.kernels import build

OUT_DIR = build.BUILD_DIR / "variants"
# name → [(text in csrc/flash_fwd.cu, replacement)]
VARIANTS = {
    "as built": [],
    "plain grid (one block per work item)": [
        ("*blocks = items < sms ? items : sms;", "*blocks = items;")],
    "no issue turns between the consumers": [
        ("  named_sync(kTurn + c, 2 * kWarpgroup);", ""),
        ("  named_arrive(kTurn + 1 - c, 2 * kWarpgroup);", "")],
    "exp2f in place of ex2.approx.ftz": [
        ("exp2_ftz(s[i] - safe[r])", "exp2f(s[i] - safe[r])")],
}
# (BH, BHkv, S, causal) at D 128: the flagship's and the GQA run's
# attention, and the flagship's without the mask
SHAPES = [(256, 256, 1024, True), (64, 16, 1024, True),
          (256, 256, 1024, False)]
TIME_LIMIT_S = 120


def _source(name: str) -> Path:
    src = (build.CSRC_DIR / "flash_fwd.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise ValueError(f"variant {name!r}: {old!r} not in the source")
        src = src.replace(old, new)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC_DIR.glob("*.cuh"):
        (OUT_DIR / header.name).write_text(header.read_text())
    path = OUT_DIR / f"v{list(VARIANTS).index(name)}.cu"
    path.write_text(src)
    return path


def build_variants() -> dict[str, Path]:
    """Every variant's library (one nvcc each, all at once); prints each
    build's ptxas spill lines."""
    procs = {}
    for name in VARIANTS:
        src = _source(name)
        lib = src.with_suffix(".so")
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln})
        print(f"[variants] {name}: nvcc exit {proc.returncode}; {spills}",
              flush=True)
        if proc.returncode == 0:
            libs[name] = lib
    return libs


def time_variant(lib: Path) -> str:
    """One line: each shape's time, TF/s of the products the mask keeps
    and max abs error against ``flash_attn_fwd_ref``."""
    import torch

    from tpu_dra_torch.workloads import flash as F
    from tpu_dra_torch.workloads.train import weak_scalar
    cdll = ctypes.CDLL(str(lib))
    fn = cdll.tpu_dra_flash_fwd
    fn.restype, fn.argtypes = build.SIGNATURES["flash_fwd"]["tpu_dra_flash_fwd"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    qscale = weak_scalar(128 ** -0.5 * F._LOG2E, torch.bfloat16)
    parts = []
    for bh, bhkv, s, causal in SHAPES:
        q, k, v = (torch.randn((n, s, 128), generator=gen, device="cuda")
                   .to(torch.bfloat16) for n in (bh, bhkv, bhkv))
        out = torch.empty_like(q)
        l2 = torch.empty((bh, s, 1), device="cuda")

        def call():
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    l2.data_ptr(), bh, bhkv, s, s, 128, int(causal), qscale,
                    stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
        call()
        torch.cuda.synchronize()
        err = float((out.float() - F.flash_attn_fwd_ref(q, k, v, causal)[0]
                     .float()).abs().max())
        for _ in range(3):
            call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call()
        end.record()
        torch.cuda.synchronize()
        us = start.elapsed_time(end) / 20 * 1e3
        kept = s * (s + 1) // 2 if causal else s * s
        parts.append(f"[{bh} over {bhkv}, {s}, 128] "
                     f"{'causal' if causal else 'full'} {us:.1f} us "
                     f"({4 * bh * kept * 128 / us / 1e6:.0f} TF/s, max abs "
                     f"err {err:.3g})")
    return "; ".join(parts)


def main() -> int:
    libs = build_variants()
    for name, lib in libs.items():
        try:
            res = subprocess.run(
                [sys.executable, "-m", "tpu_dra_torch.kernels.variants",
                 "--time", str(lib)], capture_output=True, text=True,
                timeout=TIME_LIMIT_S)
            line = res.stdout.strip() or f"failed: {res.stderr[-600:]}"
        except subprocess.TimeoutExpired:
            line = f"no result within {TIME_LIMIT_S} s"
        print(f"[variants] {name}: {line}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0 if len(libs) == len(VARIANTS) else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time"]:
        print(time_variant(Path(sys.argv[2])), flush=True)
        sys.exit(0)
    sys.exit(main())
