"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled on first
use with ``nvcc`` for ``sm_90a`` into ``tpu_dra_torch/_build/`` (a
directory git ignores) and loaded with ``ctypes``; the library's file name
carries a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source never loads a stale build.  ``build_all``
starts one ``nvcc`` per source, all at once.

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
_F = ctypes.c_float
_L = ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)
_ERR = (ctypes.c_char_p, [_I])
# name → {C function: (restype, argtypes)}
SIGNATURES = {
    "paged_attention": {
        "tpu_dra_paged_attention": (
            _I, [_P, _P, _P, _P, _P, _P, _P, _P,   # q k v k_s v_s tab len out
                 _P,                               # ws
                 _I, _I, _I, _I, _I, _I, _I, _I,   # B H Hkv P ps Dh MP quant
                 _P]),                             # stream
        "tpu_dra_cuda_error_string": _ERR,
    },
    "flash_fwd": {
        "tpu_dra_flash_fwd": (
            _I, [_P, _P, _P, _P, _P,               # q k v out l2
                 _I, _I, _I, _I, _I, _I,           # BH BHkv S Sk D causal
                 _F, _P]),                         # qscale stream
        "tpu_dra_cuda_error_string": _ERR,
    },
    "flash_bwd": {
        "tpu_dra_flash_bwd_dq": (
            _I, [_P, _P, _P, _P, _P, _P, _P,       # qs k v dout l2 dd dq
                 _I, _I, _I, _I, _I, _I,           # BH BHkv S Sk D causal
                 _F, _P]),                         # scale stream
        "tpu_dra_flash_bwd_dkdv": (
            _I, [_P, _P, _P, _P, _P, _P, _P, _P,   # qs k v dout l2 dd dk dv
                 _I, _I, _I, _I, _I, _I,           # BH BHkv S Sk D causal
                 _P]),                             # stream
        "tpu_dra_flash_bwd_fused": (
            _I, [_P, _P, _P, _P, _P, _P, _P, _P,   # qs k v dout l2 dd dk dv
                 _P, _P,                           # scratch dq
                 _I, _I, _I, _I, _I, _I,           # BH BHkv S Sk D causal
                 _I,                               # kv_block
                 _F, _P]),                         # scale stream
        "tpu_dra_cuda_error_string": _ERR,
    },
    "matmul": {
        "tpu_dra_matmul": (
            _I, [_P, _P, _P,                       # x w out
                 _I, _I, _I,                       # M N K
                 _P]),                             # stream
        "tpu_dra_rmsnorm_matmul": (
            _I, [_P, _P, _P, _P, _P, _P,           # x gamma w r xn out
                 _I, _I, _I, _F,                   # M N K eps
                 _P]),                             # stream
        "tpu_dra_cuda_error_string": _ERR,
    },
    "ring": {
        "tpu_dra_ring_ag_matmul": (
            _I, [_P, _P, _P, _P,                   # x w y a
                 _I, _I, _I, _I, _I,               # G n m K N
                 _L, _L, _L, _L,                   # x/w rank, group strides
                 _I, _I, _P]),                     # step bidir stream
        "tpu_dra_ring_matmul_rs": (
            _I, [_P, _P, _P, _P,                   # x w comm y
                 _I, _I, _I, _I, _I,               # G n m K N
                 _L, _L, _L, _L,                   # x/w rank, group strides
                 _I, _P]),                         # step stream
        "tpu_dra_ring_shift": (
            _I, [_P, _P, _I, _I, _L, _I,           # x out G n bytes dir
                 _P]),                             # stream
        "tpu_dra_ring_ag_matmul_peer": (
            _I, [_P, _P, _P, _P, _P, _P,           # x w y a a_right a_left
                 _I, _I, _I, _I, _I,               # r n m K N
                 _I, _I, _P]),                     # step bidir stream
        "tpu_dra_ring_matmul_rs_peer": (
            _I, [_P, _P, _P, _P, _P,               # x w comm comm_right y
                 _I, _I, _I, _I, _I,               # r n m K N
                 _I, _P]),                         # step stream
        "tpu_dra_ipc_alloc": (_I, [_L, _PP, ctypes.c_char_p]),
        "tpu_dra_ipc_open": (_I, [ctypes.c_char_p, _PP]),
        "tpu_dra_ipc_close": (_I, [_P]),
        "tpu_dra_ipc_free": (_I, [_P]),
        "tpu_dra_ipc_copy": (_I, [_P, _P, _L, _P]),   # dst src bytes stream
        "tpu_dra_cuda_error_string": _ERR,
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
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    return lib


def build_all(names=None) -> dict[str, Built]:
    """Compile every ``csrc/<name>.cu`` in ``names`` (default: all of
    ``SIGNATURES``) that is not built already, one ``nvcc`` per source,
    all started together, and load them; raise with the compiler output
    if any nvcc fails."""
    names = list(SIGNATURES) if names is None else list(names)
    with _lock:
        todo = [n for n in names if n not in _loaded]
        procs = {}
        for name in todo:
            out = _target(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (out, tmp, time.perf_counter(), subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC_DIR / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        built = {}
        for name, (out, tmp, t0, proc) in procs.items():
            log = proc.communicate()[0]
            built[name] = (time.perf_counter() - t0, log, proc.returncode)
        failed = [n for n, (_, _, rc) in built.items() if rc != 0]
        if failed:
            raise RuntimeError("CUDA kernel build failed: " + "; ".join(
                f"{n}: nvcc exit {built[n][2]}\n{built[n][1]}"
                for n in failed))
        for name, (out, tmp, _, _) in procs.items():
            tmp.replace(out)          # atomic: a half-written .so never loads
        for name in todo:
            secs, log, _ = built.get(name, (0.0, "", 0))
            out = _target(name)
            _loaded[name] = Built(_bind(name, out), out, secs, log)
        return {n: _loaded[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    return build_all([name])[name].lib


def require_cuda(t, what: str) -> None:
    """Raise unless tensor ``t`` lies on a CUDA device (a kernel wrapper
    takes the CPU or the card, nothing else)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, got {t.device}")


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise with CUDA's message unless a C entry point of ``lib``
    returned 0 (its launch was enqueued)."""
    if rc != 0:
        msg = lib.tpu_dra_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
