"""Reproduce the device-trace fault of ROADMAP.md section 3 on the card.

Runs chip_smoke.py's phases 1-20c in this process, then, with a paged
server of phase 4's engine in the same process and 8 requests of
TRACE_STEPS steps in flight, eight 1 s torch.profiler sessions: three
/debug/jax-trace captures on the server's threads, four on the main
thread (CPU and CUDA activity, CUDA alone, without the load, and with a
device synchronize before the profiler stops) and one on a fresh thread.
Each prints the kernel events its trace holds.  Run on a machine with
one NVIDIA GPU, from the root of the repository (about 15 minutes):

    KINETO_LOG_LEVEL=1 python3 chip_trace_repro.py

(KINETO_LOG_LEVEL=1 makes kineto print each session's record counts.)
It exits 0 after the sessions, whatever they held.
"""
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


def count_trace(path):
    """(events, kernel events, kernel #1's events) of a Chrome trace."""
    with open(path) as f:
        ev = json.load(f).get("traceEvents", [])
    k = [e["name"] for e in ev if e.get("cat") == "kernel"]
    return len(ev), len(k), sum(any(p in n for p in cs.PAGED_KERNEL) for n in k)


def diag(cfg, card):
    """In place of 20d: the eight sessions, then exit 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tpu_dra_torch.workloads.serve import serve
    params = STORE["models"][1]
    prompts = cs.request_prompts(cfg.vocab)
    srv = serve(cfg, params, port=0, **cs.ENGINE)
    port = srv.server_address[1]

    def load():
        ts = [threading.Thread(target=cs.call, args=(
            port, "/generate", {"tokens": [prompts[i]], "steps": cs.TRACE_STEPS}))
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

    def main_capture(tag, acts, probe=True, loaded=True, sync=False):
        ts = load() if loaded else []
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
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
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    cs.log("[diag] done")
    raise SystemExit(0)


if __name__ == "__main__":
    cs.pool_phase = pool_phase
    cs.trace_check = diag
    sys.exit(cs.main())
