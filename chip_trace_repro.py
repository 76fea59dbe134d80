"""Reproduce the device-trace fault of ROADMAP.md section 3 on the card.

    python3 chip_trace_repro.py           # about 15 minutes
    python3 chip_trace_repro.py graphs    # about a minute
    python3 chip_trace_repro.py server    # about five minutes
    python3 chip_trace_repro.py graphed   # about two minutes

With no argument it runs chip_smoke.py's phases 1-20c in this process
with a 1 s torch.profiler probe session after each phase function (and
after each of its sub-phases), printing the kernel events each session
holds, so the first phase after which sessions go empty shows; then, on
the idle card, QUIET_PAIRS pairs of 1 s sessions, one with its kernel at
the start (as ``serve.capture_device_trace`` probes) and one with it
halfway through the window, each pair's kernel events printed; then,
with a paged server of phase 4's engine in the same process and 8
requests of LOAD_STEPS steps in flight, eight 1 s sessions: three
/debug/jax-trace captures on the server's threads, four on the main
thread (CPU and CUDA activity, CUDA alone, without the load, and with a
device synchronize before the profiler stops) and one on a fresh
thread, each session starting and stopping its profiler with the
engine held between passes (``ContinuousEngine.paused``), as the
server's own captures do.

``graphs`` runs probe sessions in a fresh process around one CUDA graph's
capture, replay and release (what phase 3's timing does), no other phase.
``server`` runs chip_smoke.py's 20d (``trace_check``: a server process of
its own, one capture under load) SERVER_RUNS times and prints how each
ended, no other phase.  ``graphed`` starts one fresh process for each of
GRAPHED_VARIANTS: a server of phase 4's engine (int8 weights from seed
0) in that process, one request (on the card the engine captures its
greedy chunk then), and two /debug/jax-trace?seconds=1 captures under 8
requests of LOAD_STEPS steps; "eager" turns the engine's capture off
first, "profiler first" runs a short profiler session on the main
thread before the server starts; each child's end and kernel counts are
printed.

Every probe also logs the two leads' readings: the offset of CUPTI's
clock (``cuptiGetTimestamp``, the clock of kineto's GPU records) from the
host's system and monotonic clocks (kineto's capture window is on the
system clock: a drift of the offset over the process's life would move
the kernels out of the window), and, at the first empty session and in
FLUSHED_PAIRS more quiet pairs, sessions whose CUPTI buffers are flushed
with ``cuptiActivityFlushAll(CUPTI_ACTIVITY_FLAG_FLUSH_FORCED)`` before
the profiler stops (records left in a buffer CUPTI has not handed over
would then arrive).

Run on a machine with one NVIDIA GPU, from the root of the repository;
KINETO_LOG_LEVEL=1 in the environment makes kineto print each session's
record counts.  It exits 0 after the sessions, whatever they held.
"""
import contextlib
import ctypes
import json
import os
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402

STORE = {}
orig_pool_phase = cs.pool_phase


def pool_phase(models, card):
    """Phase 20, keeping phase 17's models for the sessions after it."""
    STORE["models"] = models
    return orig_pool_phase(models, card)


PROBES = []
# the diagnostic load's steps a request, and the runs of ``server``
LOAD_STEPS = 512
SERVER_RUNS = 3
# the quiet pairs after phases 1-20c: the kernel at a session's start,
# then halfway through
QUIET_PAIRS = 8
# then pairs whose CUPTI buffers are flushed (forced) before the stop
FLUSHED_PAIRS = 4
CUPTI = {}


def cupti():
    """The libcupti this process loaded (kineto's), or None."""
    if "lib" not in CUPTI:
        CUPTI["lib"] = None
        try:
            with open("/proc/self/maps") as f:
                paths = sorted({ln.split()[-1] for ln in f
                                if "libcupti" in ln})
            for path in paths:
                lib = ctypes.CDLL(path)
                lib.cuptiGetTimestamp.argtypes = [
                    ctypes.POINTER(ctypes.c_uint64)]
                lib.cuptiActivityFlushAll.argtypes = [ctypes.c_uint32]
                CUPTI["lib"] = lib
                CUPTI["path"] = path
                break
        except (OSError, AttributeError) as exc:
            cs.log(f"[probe] libcupti not reachable: {exc}")
    return CUPTI["lib"]


def clock_offsets():
    """(CUPTI's timestamp minus the host's system clock, minus its
    monotonic clock), in ms, or NaNs without libcupti."""
    lib = cupti()
    if lib is None:
        return float("nan"), float("nan")
    ts = ctypes.c_uint64()
    t0, m0 = time.time_ns(), time.monotonic_ns()
    lib.cuptiGetTimestamp(ctypes.byref(ts))
    t1, m1 = time.time_ns(), time.monotonic_ns()
    return ((ts.value - (t0 + t1) / 2) / 1e6,
            (ts.value - (m0 + m1) / 2) / 1e6)
# chip_smoke.py's phase functions (and sub-phases) of phases 1-20c
PHASES = ("check_kernel", "time_kernel", "serve_phase", "check_flash",
          "time_flash", "check_matmul", "time_matmul", "bench_phase",
          "check_ring", "time_ring", "compare_step", "fit_phase",
          "dense_curve", "profile_step", "fused_compare_step",
          "fused_train_phase", "sharded_phase", "ring_phase", "quant_phase",
          "quant_serve_phase", "spec_serve_phase", "prefix_phase",
          "resume_phase", "checkpoint_serve_phase", "lora_phase",
          "moe_phase", "pool_generate_check", "pool_beam_check",
          "pool_spec_check")


def probe(tag, cuda_only=False, seconds=1.0, middle=False, flush=False):
    """A torch.profiler session of ``seconds`` (CPU and CUDA activity, or
    CUDA alone) that launches one kernel of its own at its start (or
    halfway through, ``middle``); ``flush``: CUPTI's buffers flushed,
    forced, before the profiler stops.  Logs and returns the CUDA kernel
    events it holds, with CUPTI's clock offsets.  The first session that
    holds none is followed by :func:`resets`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([] if cuda_only
                                      else [ProfilerActivity.CPU])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        if middle:
            time.sleep(seconds / 2)
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(seconds / 2 if middle else seconds)
        if flush and cupti() is not None:
            cupti().cuptiActivityFlushAll(1)
    events = prof.events()
    kernels = sum(e.device_type == DeviceType.CUDA for e in events)
    wall, mono = clock_offsets()
    PROBES.append((tag, kernels, round(wall, 3), round(mono, 3)))
    cs.log(f"[probe] after {tag}: {kernels} kernel events of "
           f"{len(events)} in a {seconds:g} s session"
           f"{' (CUPTI flushed, forced)' if flush else ''}; CUPTI clock "
           f"minus the system clock {wall:.3f} ms, minus the monotonic "
           f"clock {mono:.3f} ms")
    if not kernels and not RESETS:
        RESETS.append(tag)
        resets()
    return kernels


def resets():
    """At the first empty session: the threads alive, then sessions after
    candidate resets, one after another."""
    import gc
    import threading

    import torch
    cs.log(f"[probe] threads alive: "
           f"{sorted(t.name for t in threading.enumerate())}")
    probe("nothing more (the same state again)")
    probe("nothing more, CUDA activity alone", cuda_only=True)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    probe("gc.collect, synchronize and empty_cache")
    probe("nothing more, a 5 s session", seconds=5.0)
    probe("the 5 s session")
    probe("CUPTI flushed before the stop", flush=True)
    probe("CUPTI flushed before the stop, the kernel halfway", flush=True,
          middle=True)
    cs.log(f"[probe] libcupti: {CUPTI.get('path')}")


RESETS = []


def probed(name, fn):
    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        probe(name)
        return out
    return run


def graph_sessions():
    """Probe sessions around one CUDA graph, in this fresh process."""
    import gc

    import torch
    probe("nothing yet")
    x = torch.randn(1 << 20, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x * 2 + 1
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = x * 2 + 1
    probe("a CUDA graph capture")
    graph.replay()
    torch.cuda.synchronize()
    probe("a replay")
    graph.replay()
    probe("a second replay")
    del graph, y
    gc.collect()
    probe("the graph's release")
    for i in range(3):
        probe(f"session {i + 1} after it")
    cs.log(f"[probe] kernel events by session: {PROBES}")


def server_runs():
    """20d alone, SERVER_RUNS times: each run's end (its ``[trace]`` line
    is logged by chip_smoke.py) and seconds."""
    from tpu_dra_torch.kernels.build import build_all
    from tpu_dra_torch.workloads.train import ModelConfig
    build_all()
    cfg = ModelConfig(**cs.MODEL)
    ends = []
    for i in range(SERVER_RUNS):
        t0 = time.perf_counter()
        try:
            cs.trace_check(cfg, "this card")
            ends.append(("passed", round(time.perf_counter() - t0, 1)))
        except SystemExit as exc:
            ends.append((f"failed: {exc}", round(time.perf_counter() - t0, 1)))
    cs.log(f"[server] 20d runs: {ends}")


# the variants of ``graphed``, each a process of its own
GRAPHED_VARIANTS = ("eager", "graphed", "profiler first")
GRAPHED_WAIT = 300


def graphed_runs():
    """``graphed``: one child process a variant, each bounded."""
    import subprocess
    from tpu_dra_torch.kernels.build import build_all
    build_all()
    ends = []
    for variant in GRAPHED_VARIANTS:
        t0 = time.perf_counter()
        try:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "graphed-child",
                 variant], capture_output=True, text=True,
                timeout=GRAPHED_WAIT)
            rc, text = out.returncode, out.stdout + out.stderr
        except subprocess.TimeoutExpired as exc:
            rc = "timeout"
            text = (exc.stdout or b"").decode(errors="replace") + \
                (exc.stderr or b"").decode(errors="replace")
        said = [ln for ln in text.splitlines()
                if ln.startswith("[graphed]") or "ERROR" in ln
                or "Error" in ln]
        for ln in said[-12:]:
            cs.log(f"  {variant}: {ln[:300]}")
        ends.append((variant, rc, round(time.perf_counter() - t0, 1)))
    cs.log(f"[graphed] runs (variant, exit code, seconds): {ends}")


def graphed_child(variant):
    """One server in this process, traced twice under load."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tpu_dra_torch.workloads.quant import quantize_params_int8
    from tpu_dra_torch.workloads.serve import serve
    from tpu_dra_torch.workloads.train import ModelConfig, init_params
    cfg = ModelConfig(**cs.MODEL)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = quantize_params_int8(init_params(cfg, gen))
    if variant == "profiler first":
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
    srv = serve(cfg, params, port=0, **cs.ENGINE)
    if variant == "eager":
        srv.engine._capture = False
    port = srv.server_address[1]
    prompts = cs.request_prompts(cfg.vocab)
    try:
        cs.call(port, "/generate", {"tokens": [prompts[0]], "steps": 16})
        cs.log(f"[graphed] {variant}: captured programs "
               f"{len(srv.engine._graphs)}")
        for i in range(2):
            ts = [threading.Thread(target=cs.call, args=(
                port, "/generate", {"tokens": [prompts[j]],
                                    "steps": LOAD_STEPS}))
                for j in range(8)]
            for t in ts:
                t.start()
            time.sleep(0.3)
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/debug/jax-trace?seconds=1",
                        timeout=120) as r:
                    code = r.status
                    kernels = r.headers.get("X-Trace-Kernel-Events")
            except urllib.error.HTTPError as e:
                code, kernels = e.code, e.read()[:200]
            dt = time.perf_counter() - t0
            for t in ts:
                t.join(120)
            cs.log(f"[graphed] {variant}: capture {i + 1} answered {code}, "
                   f"kernels={kernels} in {dt:.2f} s")
    finally:
        srv.shutdown()
    cs.log(f"[graphed] {variant}: done")


def count_trace(path):
    """(events, kernel events, kernel #1's events) of a Chrome trace."""
    with open(path) as f:
        ev = json.load(f).get("traceEvents", [])
    k = [e["name"] for e in ev if e.get("cat") == "kernel"]
    return len(ev), len(k), sum(any(p in n for p in cs.PAGED_KERNEL) for n in k)


def diag(cfg, card, server=None):
    """In place of 20d (``trace_check(cfg, card, server)``; the server
    process it would trace is left to ``pool_phase``): the quiet pairs,
    the flushed pairs, the eight sessions, then exit 0."""
    if server is not None:
        cs.stop_server("20d's server (not traced here)", server)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tpu_dra_torch.workloads.serve import serve
    pairs = []
    for i in range(QUIET_PAIRS):
        start = probe(f"quiet pair {i + 1}, the kernel at the start")
        mid = probe(f"quiet pair {i + 1}, the kernel halfway", middle=True)
        pairs.append((start, mid))
    cs.log(f"[diag] quiet pairs (kernel at the start, halfway): {pairs}; "
           f"short of their 2 kernels {sum(a < 2 for a, _ in pairs)} and "
           f"{sum(b < 2 for _, b in pairs)} of {len(pairs)}")
    flushed = []
    for i in range(FLUSHED_PAIRS):
        flushed.append((probe(f"flushed pair {i + 1}, the kernel at the "
                              f"start", flush=True),
                        probe(f"flushed pair {i + 1}, the kernel halfway",
                              middle=True, flush=True)))
    cs.log(f"[diag] flushed pairs (CUPTI flushed, forced, before each "
           f"stop): {flushed}; short of their 2 kernels "
           f"{sum(a < 2 for a, _ in flushed)} and "
           f"{sum(b < 2 for _, b in flushed)} of {len(flushed)}")
    params = STORE["models"][1]
    prompts = cs.request_prompts(cfg.vocab)
    srv = serve(cfg, params, port=0, **cs.ENGINE)
    port = srv.server_address[1]

    def load():
        ts = [threading.Thread(target=cs.call, args=(
            port, "/generate", {"tokens": [prompts[i]], "steps": LOAD_STEPS}))
            for i in range(8)]
        for t in ts:
            t.start()
        time.sleep(0.3)
        return ts

    def server_capture(tag):
        ts = load()
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/debug/jax-trace?seconds=1",
                    timeout=300) as r:
                code, h = r.status, dict(r.headers)
                out = h.get("X-Trace-Kernel-Events")
        except urllib.error.HTTPError as e:
            code, out = e.code, e.read()[:200]
        dt = time.perf_counter() - t0
        for t in ts:
            t.join(600)
        cs.log(f"[diag] {tag}: server-thread capture {code} kernels={out} in {dt:.2f} s")

    def session(acts):
        """A profiler whose start and stop hold the engine between passes,
        as serve.capture_device_trace's do."""
        prof = profile(activities=acts)

        @contextlib.contextmanager
        def around():
            with srv.engine.paused():
                prof.start()
            try:
                yield prof
            finally:
                with srv.engine.paused():
                    prof.stop()
        return around()

    def main_capture(tag, acts, probe=True, loaded=True, sync=False):
        ts = load() if loaded else []
        t0 = time.perf_counter()
        with session(acts) as prof:
            if probe:
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
            time.sleep(1)
            if sync:
                torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as td:
            p = os.path.join(td, "t.json")
            prof.export_chrome_trace(p)
            n = count_trace(p)
        dt = time.perf_counter() - t0
        for t in ts:
            t.join(600)
        cs.log(f"[diag] {tag}: main-thread capture events, kernels, #1 = {n} in {dt:.2f} s")

    def thread_capture(tag):
        ts = load()
        res = {}

        def run():
            with session([ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as prof:
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
                time.sleep(1)
            with tempfile.TemporaryDirectory() as td:
                p = os.path.join(td, "t.json")
                prof.export_chrome_trace(p)
                res["n"] = count_trace(p)
        th = threading.Thread(target=run)
        th.start()
        th.join()
        for t in ts:
            t.join(600)
        cs.log(f"[diag] {tag}: fresh-thread capture events, kernels, #1 = {res.get('n')}")

    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        cs.call(port, "/generate", {"tokens": [prompts[0]], "steps": 16})
        server_capture("A1")
        main_capture("B1 main cpu+cuda", both)
        server_capture("A2")
        main_capture("B2 main cuda only", [ProfilerActivity.CUDA])
        thread_capture("C1")
        main_capture("B3 main no load", both, loaded=False)
        server_capture("A3")
        main_capture("B4 main cpu+cuda sync", both, sync=True)
    finally:
        srv.shutdown()
    cs.log(f"[probe] kernel events by session: {PROBES}")
    cs.log("[diag] done")
    raise SystemExit(0)


if __name__ == "__main__":
    if sys.argv[1:] == ["graphs"]:
        graph_sessions()
        sys.exit(0)
    if sys.argv[1:] == ["server"]:
        server_runs()
        sys.exit(0)
    if sys.argv[1:] == ["graphed"]:
        graphed_runs()
        sys.exit(0)
    if sys.argv[1:2] == ["graphed-child"]:
        graphed_child(sys.argv[2])
        sys.exit(0)
    import tpu_dra_torch.bench as bench
    bench.section_decode = probed("section_decode", bench.section_decode)
    for name in PHASES:
        setattr(cs, name, probed(name, getattr(cs, name)))
    cs.pool_phase = pool_phase
    cs.trace_check = diag
    sys.exit(cs.main())
