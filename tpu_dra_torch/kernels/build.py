"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled on first
use with ``nvcc`` for ``sm_90a`` into ``tpu_dra_torch/_build/`` (a
directory git ignores) and loaded with ``ctypes``; the library's file name
carries a hash of the source and the flags, so an edited source never
loads a stale build.

Nothing here runs at import time: the CPU tests import every module of
the port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name → {C function: (restype, argtypes)}
SIGNATURES = {
    "paged_attention": {
        "tpu_dra_paged_attention": (
            _I, [_P, _P, _P, _P, _P, _P, _P, _P,   # q k v k_s v_s tab len out
                 _I, _I, _I, _I, _I, _I, _I, _I,   # B H Hkv P ps Dh MP quant
                 _P]),                             # stream
        "tpu_dra_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
}


@dataclass
class Built:
    """One loaded kernel library and how it was built."""
    lib: ctypes.CDLL
    path: Path
    seconds: float          # nvcc wall time (0.0 when reused)
    log: str                # nvcc's output (ptxas registers/spills)


_lock = threading.Lock()
_loaded: dict[str, Built] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under /usr/local/cuda")


def _target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    return lib


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` (unless this exact source is built
    already) and load it; raise with the compiler output if nvcc fails."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        out = _target(name)
        secs, log = 0.0, ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC_DIR / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            secs, log = time.perf_counter() - t0, proc.stdout
            if proc.returncode != 0:
                raise RuntimeError(f"CUDA kernel build failed: {name}: nvcc "
                                   f"exit {proc.returncode}\n{log}")
            tmp.replace(out)          # atomic: a half-written .so never loads
        _loaded[name] = Built(_bind(name, out), out, secs, log)
        return _loaded[name]


def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    return build(name).lib
