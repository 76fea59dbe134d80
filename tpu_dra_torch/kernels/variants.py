"""Time variants of the redesigned kernels on the card (the flash forward,
the flash backward: the fused kernel and the split pair, the plain matmul
and the RMSNorm-matmul, the ring matmuls, the paged decode attention), to
show what each part of their designs buys.

A variant is a source (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``,
``csrc/matmul.cu``, ``csrc/ring.cu`` or ``csrc/paged_attention.cu``) with
named text substitutions (the source as it stands is the first).  Each is
built with the port's nvcc flags into ``tpu_dra_torch/_build/variants/``,
held to the plain version (max abs error) and timed through its C entry
with CUDA events at the paths' shapes, each in a process of its own under
a time limit, so a variant that hangs costs only its limit.  Needs one
CUDA card:

    python -m tpu_dra_torch.kernels.variants            # every set
    python -m tpu_dra_torch.kernels.variants flash_bwd  # or some of them
    python -m tpu_dra_torch.kernels.variants paged --before OLD.cu

``--before`` adds another paged-attention source with the C entry of the
kernel's first version (no workspace argument), timed beside the variants
in the same run: the source of an earlier commit, unpacked with ``git
archive``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

from tpu_dra_torch.kernels import build

OUT_DIR = build.BUILD_DIR / "variants"
_RING_CONFIG = "using RingConfig = Config<256, 4, 2>;"
_MATMUL_CONFIG = "using MatmulConfig = Config<256, 4, 2>;"
_PAGED_SPAN = "constexpr int kSpanTokens = 128;"
_PAGED_STAGES = "constexpr int kStages = 3;"
_BWD_WALK = """const int g0 = w / (kGroup * p.n_kt) * kGroup, gs = min(kGroup, p.BH - g0);
  const int bh = g0 + (w - g0 * p.n_kt) % gs, kt = (w - g0 * p.n_kt) / gs;"""
_BWD_SPIN = """            for (int spin = 0; ld_acquire_gpu(flag) != pos; ++spin)
              if (spin > (1 << 24)) __trap();"""
_Q_STAGES = "constexpr int kStages = 2;        // buffers in the q-tile ring"
_DQ_BK = "constexpr int kBK = 64;           // keys per K/V tile (S and dP are m64n64)"
_DQ_STAGES = "constexpr int kStages = 3;        // buffers in the K/V ring"
_DQ_QBUFS = "constexpr int kQBufs = 2;         // qs/dout tile buffers"
_KV_PAIRS = """        const int n_pairs = (p.n_kt + 1) / 2;
        int n = 0;
        for (int pw = blockIdx.x; pw < p.BH * n_pairs; pw += gridDim.x) {
          const int bh = pw / n_pairs, pr = pw % n_pairs;
          claim(n);
          produce(n++, pr * p.BH + bh);
          if (pr != p.n_kt - 1 - pr) {
            claim(n);
            produce(n++, (p.n_kt - 1 - pr) * p.BH + bh);
          }
        }"""
_KV_GRID = "grid_blocks(BH * ((n_kt + 1) / 2), &blocks)"
_BWD_EXP = "(DQ ? exp2f(e) : flash::exp2_ftz(e))"
# source → name → [(text in csrc/<source>.cu, replacement)]
VARIANTS = {
    "flash_fwd": {
        "as built": [],
        "plain grid (one block per work item)": [
            ("*blocks = items < sms ? items : sms;", "*blocks = items;")],
        "no issue turns between the consumers": [
            ("  named_sync(kTurn + c, 2 * kWarpgroup);", ""),
            ("  named_arrive(kTurn + 1 - c, 2 * kWarpgroup);", "")],
        "exp2f in place of ex2.approx.ftz": [
            ("exp2_ftz(s[i] - safe[r])", "exp2f(s[i] - safe[r])")],
    },
    "flash_bwd": {
        "as built": [],
        "finish pass at n_j = 1 too (dq not formed by the last add)": [
            ("const int direct = lay.n_j == 1;", "const int direct = 0;")],
        "1 q-tile ring stage (fused and dK/dV)": [
            (_Q_STAGES, "constexpr int kStages = 1;")],
        "3 q-tile ring stages (fused and dK/dV)": [
            (_Q_STAGES, "constexpr int kStages = 3;")],
        "static round robin walk (no item counter)": [
            ("const int w = atomicAdd(p.next, 1);",
             "const int w = blockIdx.x + n * gridDim.x;")],
        "head-row outermost (a head-row's items side by side)": [
            (_BWD_WALK, "const int bh = w / p.n_kt, kt = w % p.n_kt;")],
        "fused: ex2.approx.ftz in place of exp2f": [
            (_BWD_EXP, "flash::exp2_ftz(e)")],
        "key tile outermost (a head-row's items apart)": [
            (_BWD_WALK, "const int bh = w % p.BH, kt = w / p.BH;")],
        "registers 40 / 232 (fused and dK/dV)": [
            ("constexpr int kProducerRegs = 24;",
             "constexpr int kProducerRegs = 40;"),
            ("constexpr int kConsumerRegs = 240;",
             "constexpr int kConsumerRegs = 232;")],
        "dq adds not ordered (timing only; dq races, wrong)": [
            (_BWD_SPIN, "")],
        "dQ: 128-key K/V tiles, one qs/dout buffer, 2 K/V stages": [
            (_DQ_BK, "constexpr int kBK = 128;"),
            (_DQ_QBUFS, "constexpr int kQBufs = 1;"),
            (_DQ_STAGES, "constexpr int kStages = 2;")],
        "dQ: 2 K/V ring stages": [(_DQ_STAGES, "constexpr int kStages = 2;")],
        "dQ: one qs/dout buffer, 4 K/V ring stages": [
            (_DQ_QBUFS, "constexpr int kQBufs = 1;"),
            (_DQ_STAGES, "constexpr int kStages = 4;")],
        "dQ: q tiles one by one (no longest/shortest pairs)": [
            ("      for_each_tile(n_qt, p.BH, [&](int bh, int qt) {",
             "      one_by_one(n_qt, p.BH, [&](int bh, int qt) {"),
            ("    for_each_tile(n_qt, p.BH, [&](int bh, int qt) {",
             "    one_by_one(n_qt, p.BH, [&](int bh, int qt) {"),
            ("using flash::for_each_tile;",
             "template <typename F>\n"
             "__device__ void one_by_one(int n_qt, int BH, F&& f) {\n"
             "  for (int w = blockIdx.x; w < BH * n_qt; w += gridDim.x)\n"
             "    f(w / n_qt, n_qt - 1 - w % n_qt);\n"
             "}")],
        "dQ: exp2f in place of ex2.approx.ftz": [
            ("s[x] = keep ? flash::exp2_ftz(s[x] - l2r[h]) : 0.f;",
             "s[x] = keep ? exp2f(s[x] - l2r[h]) : 0.f;")],
        "dK/dV: exp2f in place of ex2.approx.ftz": [
            (_BWD_EXP, "exp2f(e)")],
        "dK/dV: one K/V item buffer": [
            ("constexpr int kv_bufs(bool dq) { return dq ? 1 : 2; }",
             "constexpr int kv_bufs(bool dq) { return 1; }")],
        "dK/dV: items from a counter, longest first": [
            ("      if constexpr (DQ) {\n"
             "        // the next item from the counter",
             "      if constexpr (true) {\n"
             "        // the next item from the counter"),
            ("  auto kernel = flash_bwd_fused_kernel<D, CAUSAL, false>;",
             "  static int* counter = [] {\n"
             "    void* c = nullptr;\n"
             "    cudaMalloc(&c, sizeof(int));\n"
             "    return static_cast<int*>(c);\n"
             "  }();\n"
             "  if ((err = cudaMemsetAsync(counter, 0, sizeof(int), stream)) "
             "!= cudaSuccess)\n"
             "    return err;\n"
             "  auto kernel = flash_bwd_fused_kernel<D, CAUSAL, false>;"),
            ("                 nullptr, nullptr, nullptr, nullptr,",
             "                 nullptr, nullptr, counter, nullptr,"),
            (_KV_GRID, "grid_blocks(BH * n_kt, &blocks)")],
        "dK/dV: static round robin, longest first (no pairs)": [
            (_KV_PAIRS, "        int n = 0;\n"
                        "        for (int w = blockIdx.x; w < items; w += "
                        "gridDim.x) {\n"
                        "          claim(n);\n"
                        "          produce(n++, w);\n"
                        "        }"),
            (_KV_GRID, "grid_blocks(BH * n_kt, &blocks)")],
    },
    "matmul": {
        "as built": [],
        "clusters of 1 (no multicast of the w tile)": [
            (_MATMUL_CONFIG, "using MatmulConfig = Config<256, 4, 1>;")],
        "tile 128x128, 6 stages": [
            (_MATMUL_CONFIG, "using MatmulConfig = Config<128, 6, 2>;")],
        "tile 128x128, 6 stages, clusters of 1": [
            (_MATMUL_CONFIG, "using MatmulConfig = Config<128, 6, 1>;")],
    },
    "ring": {
        "as built": [],
        "clusters of 1 (no multicast of the w tile)": [
            (_RING_CONFIG, "using RingConfig = Config<256, 4, 1>;")],
        "tile 128x128, 6 stages": [
            (_RING_CONFIG, "using RingConfig = Config<128, 6, 2>;")],
        "3 stages (three copy threads)": [
            (_RING_CONFIG, "using RingConfig = Config<256, 3, 2>;"),
            ("constexpr int kCopiers = 2;", "constexpr int kCopiers = 3;")],
        "ranks interleaved in the walk (rank innermost within a step)": [
            ("  const int rank = w / (nseg * rt * ct);\n"
             "  w %= nseg * rt * ct;",
             "  const int rank = w % ranks;\n  w /= ranks;")],
        "one copy thread (not two taking the stages in turn)": [
            ("constexpr int kCopiers = 2;", "constexpr int kCopiers = 1;")],
        "flags at system scope on the virtual ring too": [
            ("  return local ? ld_acquire_sys(flag) : ld_acquire_gpu(flag);",
             "  return ld_acquire_sys(flag);"),
            ("""  const int old = local ? atom_add_acq_rel_sys(count, 1)
                        : atom_add_acq_rel_gpu(count, 1);""",
             "  const int old = atom_add_acq_rel_sys(count, 1);"),
            ("""    if (local)
      st_release_sys(flag, epoch);
    else
      st_release_gpu(flag, epoch);""", "    st_release_sys(flag, epoch);")],
        "arrivals without acquire or release (timing only; races)": [
            ("""  const int old = local ? atom_add_acq_rel_sys(count, 1)
                        : atom_add_acq_rel_gpu(count, 1);""",
             "  const int old = atomicAdd(count, 1);"),
            ("""    if (local)
      st_release_sys(flag, epoch);
    else
      st_release_gpu(flag, epoch);""",
             "    *reinterpret_cast<volatile int*>(flag) = epoch;")],
        "RS without its fp32 partials' traffic (timing only; y is wrong)": [
            ("          if (t > 0)                         // the partial "
             "from the left", "          if (false)"),
            ("""            else if (t < n - 1)
              tma_store_5d(&p.out, half, c0, c1, t, (u.r + 1) % n, u.g);""",
             """            else if (t < n - 1)
              ;""")],
    },
    "paged": {
        "as built": [],
        "spans of 1 page (64 tokens)": [
            (_PAGED_SPAN, "constexpr int kSpanTokens = 64;")],
        "spans of 4 pages (256 tokens)": [
            (_PAGED_SPAN, "constexpr int kSpanTokens = 256;")],
        "2 copy stages": [(_PAGED_STAGES, "constexpr int kStages = 2;")],
        "tiles of 32 tokens": [
            ("constexpr int kTile = 64;", "constexpr int kTile = 32;")],
    },
}
# flash_fwd: (BH, BHkv, S, causal) at D 128: the flagship's and the GQA
# run's attention, and the flagship's without the mask
FLASH_SHAPES = [(256, 256, 1024, True), (64, 16, 1024, True),
                (256, 256, 1024, False)]
# flash_bwd: (BH, BHkv, S, causal) at D 128, the flagship's and the GQA
# run's attention, and one rank's causal block of the DP×SP step
BWD_SHAPES = [(256, 256, 1024, True), (64, 16, 1024, True),
              (256, 256, 256, True)]
# matmul: (m, k, n), the bench's 4096^3; the RMSNorm-matmul at the
# flagship's ln1 -> wqkv and ln2 -> w1
MATMUL_SHAPES = [(4096, 4096, 4096)]
NORM_SHAPES = [(16384, 2048, 6144), (16384, 2048, 8192)]
# ring: (kernel, label, m, K, N) at tp 4 on the flagship (chip_smoke.py
# phase 12)
RING_SHAPES = [("ag", "wqkv", 4096, 2048, 1536), ("ag", "w1", 4096, 2048, 2048),
               ("rs", "w2", 4096, 2048, 2048), ("rs", "wo", 4096, 512, 2048)]
# paged: (B, shortest, longest length) at H 8 over Hkv 2, Dh 128, 64-token
# pages, 16 table columns, a 160-page pool a layer: the serving path's
# decode step, and 4 slots at the full 1024 tokens (chip_smoke.py phase 3)
PAGED_SHAPES = [(32, 257, 320), (4, 1024, 1024)]
PAGED_LAYERS = 8
# the largest workspace any variant takes (spans of 64 tokens)
PAGED_MIN_SPAN = 64
TIME_LIMIT_S = 120


# the source of each set of variants
SOURCES = {"paged": "paged_attention"}
# the name of the first version's source given with --before
BEFORE = "first version (--before)"


def _source(kernel: str, name: str) -> Path:
    src = (build.CSRC_DIR / f"{SOURCES.get(kernel, kernel)}.cu").read_text()
    for old, new in VARIANTS[kernel][name]:
        if old not in src:
            raise ValueError(f"variant {name!r}: {old!r} not in the source")
        src = src.replace(old, new)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC_DIR.glob("*.cuh"):
        (OUT_DIR / header.name).write_text(header.read_text())
    path = OUT_DIR / f"{kernel}-v{list(VARIANTS[kernel]).index(name)}.cu"
    path.write_text(src)
    return path


def build_variants(kernels, before=None) -> dict[tuple[str, str], Path]:
    """Every variant's library (one nvcc each, all at once), and the
    ``before`` source's; prints each build's ptxas spill lines."""
    procs = {}
    for kernel in kernels:
        for name in VARIANTS[kernel]:
            if name == BEFORE:
                src = OUT_DIR / "paged-before.cu"
                src.write_text(Path(before).read_text())
            else:
                src = _source(kernel, name)
            lib = src.with_suffix(".so")
            procs[kernel, name] = (lib, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                 str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (kernel, name), (lib, proc) in procs.items():
        log = proc.communicate()[0]
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln})
        print(f"[variants] {kernel} / {name}: nvcc exit {proc.returncode}; "
              f"{spills}", flush=True)
        if proc.returncode:
            print(log[-2000:], flush=True)
        else:
            libs[kernel, name] = lib
    return libs


def _event_us(call, iters: int = 20) -> float:
    import torch
    for _ in range(3):
        call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def _graph_us(call, iters: int = 200, reps: int = 5) -> float:
    """Device time per call of ``call`` from a CUDA graph of ``iters``
    calls replayed ``reps`` times: the host's launch cost drops out, which
    a loop of launches would measure for a kernel of a few microseconds.
    ``call`` must launch on the current stream."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            call()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps) * 1e3


def _bind(lib: Path, kernel: str):
    cdll = ctypes.CDLL(str(lib))
    for fn, (restype, argtypes) in build.SIGNATURES[
            SOURCES.get(kernel, kernel)].items():
        f = getattr(cdll, fn)
        f.restype, f.argtypes = restype, argtypes
    return cdll


def _checked(rc):
    if rc:
        raise RuntimeError(f"launch failed: CUDA error {rc}")


def time_flash(lib: Path) -> str:
    """One line: each shape's time, TF/s of the products the mask keeps
    and max abs error against ``flash_attn_fwd_ref``."""
    import torch

    from tpu_dra_torch.workloads import flash as F
    from tpu_dra_torch.workloads.train import weak_scalar
    fn = _bind(lib, "flash_fwd").tpu_dra_flash_fwd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    qscale = weak_scalar(128 ** -0.5 * F._LOG2E, torch.bfloat16)
    parts = []
    for bh, bhkv, s, causal in FLASH_SHAPES:
        q, k, v = (torch.randn((n, s, 128), generator=gen, device="cuda")
                   .to(torch.bfloat16) for n in (bh, bhkv, bhkv))
        out = torch.empty_like(q)
        l2 = torch.empty((bh, s, 1), device="cuda")

        def call():
            _checked(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), l2.data_ptr(), bh, bhkv, s, s, 128,
                        int(causal), qscale, stream))
        call()
        torch.cuda.synchronize()
        err = float((out.float() - F.flash_attn_fwd_ref(q, k, v, causal)[0]
                     .float()).abs().max())
        us = _event_us(call)
        kept = s * (s + 1) // 2 if causal else s * s
        parts.append(f"[{bh} over {bhkv}, {s}, 128] "
                     f"{'causal' if causal else 'full'} {us:.1f} us "
                     f"({4 * bh * kept * 128 / us / 1e6:.0f} TF/s, max abs "
                     f"err {err:.3g})")
    return "; ".join(parts)


def time_flash_bwd(lib: Path) -> str:
    """One line: at each shape the times of the fused kernel, the dQ kernel
    and the dK/dV kernel, the TF/s of the products the mask keeps (five,
    three and four), the SDPA backward's time in the same process, and the
    max abs error of each output against its plain version."""
    import torch
    import torch.nn.functional as TF

    from tpu_dra_torch.workloads import flash as F
    cdll = _bind(lib, "flash_bwd")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    P = lambda t: t.data_ptr()      # noqa: E731
    parts = []
    for bh, bhkv, s, causal in BWD_SHAPES:
        q, k, v, do = (torch.randn((n, s, 128), generator=gen, device="cuda")
                       .to(torch.bfloat16) for n in (bh, bhkv, bhkv, bh))
        out, l2 = F.flash_attn_fwd_ref(q, k, v, causal)
        qs = F._prescale(q).contiguous()
        dd = (do.float() * out.float()).sum(-1, keepdim=True)
        args = (qs, k, v, do, l2, dd, causal)
        got = [torch.empty_like(q) for _ in range(6)]  # fused, then split
        scratch = torch.empty(
            -(-F.fused_scratch_bytes(bh, s, s, 128) // 4), device="cuda")
        ptrs = (P(qs), P(k), P(v), P(do), P(l2), P(dd))
        calls = {
            "fused": lambda: _checked(cdll.tpu_dra_flash_bwd_fused(
                *ptrs, P(got[1]), P(got[2]), P(scratch), P(got[0]), bh,
                bhkv, s, s, 128, int(causal), F.KV_BLOCK, 128 ** -0.5,
                stream)),
            "dq": lambda: _checked(cdll.tpu_dra_flash_bwd_dq(
                *ptrs, P(got[3]), bh, bhkv, s, s, 128, int(causal),
                128 ** -0.5, stream)),
            "dK/dV": lambda: _checked(cdll.tpu_dra_flash_bwd_dkdv(
                *ptrs, P(got[4]), P(got[5]), bh, bhkv, s, s, 128,
                int(causal), stream))}
        for call in calls.values():
            call()
        torch.cuda.synchronize()
        want = [*F.flash_bwd_fused_ref(*args), F.flash_bwd_dq_ref(*args),
                *F.flash_bwd_dkdv_ref(*args)]
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want)]
        del want
        us = {name: _event_us(call) for name, call in calls.items()}
        q4 = q.reshape(1, bh, s, 128).detach().requires_grad_()
        k4, v4 = (t.reshape(1, bhkv, s, 128).detach().requires_grad_()
                  for t in (k, v))
        o4 = TF.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                             enable_gqa=bh != bhkv)
        sdpa = _event_us(lambda: torch.autograd.grad(
            o4, (q4, k4, v4), do.reshape(1, bh, s, 128), retain_graph=True))
        kept = s * (s + 1) // 2 if causal else s * s
        rate = {name: n * 2 * bh * kept * 128 / us[name] / 1e6
                for name, n in (("fused", 5), ("dq", 3), ("dK/dV", 4))}
        parts.append(
            f"[{bh} over {bhkv}, {s}, 128] {'causal' if causal else 'full'}: "
            + ", ".join(f"{name} {us[name]:.1f} us ({rate[name]:.0f} TF/s)"
                        for name in calls)
            + f", pair {us['dq'] + us['dK/dV']:.1f} us; SDPA backward "
            f"{sdpa:.1f} us; max abs err fused dq, dk, dv "
            f"{', '.join(f'{e:.3g}' for e in errs[:3])}, split "
            f"{', '.join(f'{e:.3g}' for e in errs[3:])}")
        del q, k, v, do, out, qs, dd, got, scratch, q4, k4, v4, o4
    return "; ".join(parts)


def time_matmul(lib: Path) -> str:
    """One line: each shape's time, TF/s and max abs error against
    ``matmul_ref``, beside ``torch.matmul`` in the same process; then at
    the RMSNorm-matmul's shapes its C entry (the row-norm pass, then the
    matmul on its normed x), beside the unfused pair of PyTorch calls."""
    import torch

    from tpu_dra_torch.workloads import matmul as M
    from tpu_dra_torch.workloads.train import _rmsnorm
    cdll = _bind(lib, "matmul")
    fn = cdll.tpu_dra_matmul
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    parts = []
    for m, k, n in MATMUL_SHAPES:
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
        out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")

        def call():
            _checked(fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                        stream))
        call()
        torch.cuda.synchronize()
        err = float((out.float() - M.matmul_ref(x, w).float()).abs().max())
        us = _event_us(call, 50)
        lib_us = _event_us(lambda: torch.matmul(x, w), 50)
        parts.append(f"[{m}, {k}] @ [{k}, {n}] {us:.1f} us "
                     f"({2 * m * k * n / us / 1e6:.0f} TF/s; torch.matmul "
                     f"{lib_us:.1f} us; max abs err {err:.3g})")
        del x, w, out
    P = lambda t: t.data_ptr()      # noqa: E731
    for m, k, n in NORM_SHAPES:
        x = (torch.randn((m, k), generator=gen, device="cuda")
             * (torch.rand((m, 1), generator=gen, device="cuda") * 4 + 0.05)
             ).to(torch.bfloat16)
        g = 1 + 0.1 * torch.randn((k,), generator=gen, device="cuda")
        w = (torch.randn((k, n), generator=gen, device="cuda")
             * k ** -0.5).to(torch.bfloat16)
        r = torch.empty(m, device="cuda")
        xn = torch.empty_like(x)
        out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")

        def call():
            _checked(cdll.tpu_dra_rmsnorm_matmul(
                P(x), P(g), P(w), P(r), P(xn), P(out), m, n, k, M.EPS,
                stream))
        call()
        torch.cuda.synchronize()
        err = float((out.float() - M.fused_rmsnorm_matmul_ref(x, g, w)
                     .float()).abs().max())
        us = _event_us(call)
        pair = _event_us(lambda: torch.matmul(_rmsnorm(x, g), w))
        parts.append(
            f"rmsnorm [{m}, {k}] @ [{k}, {n}] {us:.1f} us "
            f"({2 * m * k * n / us / 1e6:.0f} TF/s, max abs err {err:.3g}; "
            f"the unfused pair _rmsnorm, torch.matmul {pair:.1f} us)")
        del x, w, xn, out
    return "; ".join(parts)


def paged_case(gen, B: int, lo: int, hi: int, layers: int):
    """One decode step's inputs on the card: lengths in [lo, hi], each slot
    its pages from a permutation of the pool, -1 past them, and ``layers``
    pools of K and V pages, so that timing cycles through them and reads
    its pages from device memory rather than the 50 MB L2 cache."""
    import torch
    Hkv, H, Dh, P, ps, MP = 2, 8, 128, 160, 64, 16
    lengths = torch.randint(lo, hi + 1, (B,), generator=gen, device="cuda",
                            dtype=torch.int32)
    need = (lengths + ps - 1) // ps
    perm = torch.randperm(P, generator=gen, device="cuda").to(torch.int32)
    table = torch.full((B, MP), -1, dtype=torch.int32, device="cuda")
    first = 0
    for b, n in enumerate(need.tolist()):
        table[b, :n] = perm[first:first + n]
        first += n
    q = torch.randn((B, H, Dh), generator=gen, device="cuda").to(
        torch.bfloat16)
    kv = [torch.randn((layers, Hkv, P, ps, Dh), generator=gen,
                      device="cuda").to(torch.bfloat16) for _ in range(2)]
    return q, kv, table, lengths


def time_paged(lib: Path, before: bool = False) -> str:
    """One line: at each of PAGED_SHAPES the C entry's device time (the
    spans and their merge) from a CUDA graph of its calls, cycling through
    PAGED_LAYERS layers' pools, its share of the bytes bound, the time of
    a loop of the same calls (the host's launch rate bounds it), and the
    max abs error and worst slot error against ``paged_attention_ref``;
    ``before``: a first-version source, whose C entry takes no
    workspace."""
    import torch

    from tpu_dra_torch.workloads import paged_kv as pk
    fn = _bind(lib, "paged").tpu_dra_paged_attention
    if before:
        fn.argtypes = fn.argtypes[:8] + fn.argtypes[9:]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    parts = []
    for B, lo, hi in PAGED_SHAPES:
        q, (k, v), table, lengths = paged_case(gen, B, lo, hi, PAGED_LAYERS)
        qs = (q * pk.weak_scalar(128 ** -0.5 * pk._LOG2E, q.dtype)
              ).contiguous()
        out = torch.empty_like(q)
        ws = torch.empty(B * 2 * -(-16 * 64 // PAGED_MIN_SPAN) * 4 * 130,
                         device="cuda")
        layer = [0]

        def call():
            i = layer[0] = (layer[0] + 1) % PAGED_LAYERS
            args = [qs.data_ptr(), k[i].data_ptr(), v[i].data_ptr(), None,
                    None, table.data_ptr(), lengths.data_ptr(),
                    out.data_ptr(), ws.data_ptr(), B, 8, 2, 160, 64, 128, 16,
                    0, torch.cuda.current_stream().cuda_stream]
            if before:
                del args[8]
            _checked(fn(*args))
        layer[0] = -1
        call()
        torch.cuda.synchronize()
        want = pk.paged_attention_ref(q, k[0], v[0], table, lengths)
        err = float((out.float() - want.float()).abs().max())
        rel = float(pk.slot_rel_err(out, want).max())
        us = _graph_us(call)
        loop = _event_us(call, 400)
        live = int(lengths.sum())
        nbytes = (2 * live * 2 * 128 * 2 + 2 * B * 8 * 128 * 2
                  + int(((lengths + 63) // 64).sum()) * 4 + B * 4)
        bound = nbytes / 3.35e12 * 1e6
        parts.append(f"B {B}, lengths {lo}-{hi}: {us:.2f} us ({bound / us:.3f} "
                     f"of the {bound:.2f} us bound; a loop of launches "
                     f"{loop:.2f} us; max abs err {err:.3g}, worst slot "
                     f"{rel:.4f})")
        del q, k, v, ws
    return "; ".join(parts)


def time_ring(lib: Path) -> str:
    """One line: each ring matmul shape's time for its one launch over
    the n = 4 ring steps (each call its own epoch on zeroed flag words),
    TF/s, and max abs error of y against the plain version (and whether
    the gathered operand is byte-equal)."""
    import torch

    from tpu_dra_torch.workloads import collective_matmul as cm
    cdll = _bind(lib, "ring")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    P = lambda t: t.data_ptr()      # noqa: E731
    n, parts = 4, []
    flags = torch.zeros(n * cdll.tpu_dra_ring_flag_words(n),
                        dtype=torch.int32, device="cuda")
    epoch = [0]

    def next_epoch():
        epoch[0] += 1
        return epoch[0]
    for kind, label, m, k, n_out in RING_SHAPES:
        rows = m if kind == "ag" else n * m
        x = torch.randn((1, n, rows, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (torch.randn((1, n, k, n_out), generator=gen, device="cuda")
             * k ** -0.5).to(torch.bfloat16)
        if kind == "ag":
            y = torch.empty((1, n, n * m, n_out), dtype=torch.bfloat16,
                            device="cuda")
            a = torch.empty((1, n, n, m, k), dtype=torch.bfloat16,
                            device="cuda")

            def call():
                _checked(cdll.tpu_dra_ring_ag_matmul(
                    P(x), P(w), P(y), P(a), P(flags), 1, n, m, k, n_out,
                    m * k, n * m * k, k * n_out, 0, 1, next_epoch(), stream))
            call()
            torch.cuda.synchronize()
            want_y, want_a = cm.all_gather_matmul_ref(x, w)
            extra = f", a byte-equal {torch.equal(a, want_a)}"
        else:
            y = torch.empty((1, n, m, n_out), dtype=torch.bfloat16,
                            device="cuda")
            comm = torch.empty((1, n, n - 1, m, n_out), dtype=torch.float32,
                               device="cuda")

            def call():
                _checked(cdll.tpu_dra_ring_matmul_rs(
                    P(x), P(w), P(comm), P(y), P(flags), 1, n, m, k, n_out,
                    n * m * k, n * n * m * k, k * n_out, 0, next_epoch(),
                    stream))
            call()
            torch.cuda.synchronize()
            want_y, extra = cm.matmul_reduce_scatter_ref(x, w), ""
        err = float((y.float() - want_y.float()).abs().max())
        us = _event_us(call)
        flops = 2 * n * (n * m) * k * n_out
        parts.append(f"{kind} {label} {us:.1f} us ({flops / us / 1e6:.0f} "
                     f"TF/s, max abs err {err:.3g}{extra})")
        del x, w, y
    return "; ".join(parts)


TIMERS = {"flash_fwd": time_flash, "flash_bwd": time_flash_bwd,
          "matmul": time_matmul, "ring": time_ring, "paged": time_paged,
          BEFORE: lambda lib: time_paged(lib, before=True)}


def main(kernels, before=None) -> int:
    if before is not None:
        VARIANTS["paged"][BEFORE] = []
    libs = build_variants(kernels, before)
    for (kernel, name), lib in libs.items():
        timer = BEFORE if name == BEFORE else kernel
        try:
            res = subprocess.run(
                [sys.executable, "-m", "tpu_dra_torch.kernels.variants",
                 "--time", timer, str(lib)], capture_output=True, text=True,
                timeout=TIME_LIMIT_S)
            line = res.stdout.strip() or f"failed: {res.stderr[-600:]}"
        except subprocess.TimeoutExpired:
            line = f"no result within {TIME_LIMIT_S} s"
        print(f"[variants] {kernel} / {name}: {line}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0 if len(libs) == sum(len(VARIANTS[k]) for k in kernels) else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time"]:
        print(TIMERS[sys.argv[2]](Path(sys.argv[3])), flush=True)
        sys.exit(0)
    args = sys.argv[1:]
    old = None
    if "--before" in args:
        i = args.index("--before")
        old = args[i + 1]
        del args[i:i + 2]
    sys.exit(main(args or list(VARIANTS), old))
