"""HTTP inference server over the continuous engine, ported from
``tpu_dra/workloads/serve.py`` (its ``--continuous`` mode, slab or paged
KV layout).  stdlib HTTP server, one engine per process.

POST /generate  {"tokens": [[...]], "steps": N, "temperature": 0.0,
                 "seed": 0, "eos_id": null}
             → {"tokens": [[...]]}      (the generated ids per row; every
                 row is its own engine request, fanned in concurrently)
GET  /healthz → 200 "ok" while the engine's decode loop is live (ANDed
             with an optional external verdict); 503 + reason otherwise
GET  /stats   → the engine's ``stats()`` as JSON

Admission control, SLO tracking, /metrics, /prefill and /decode_handoff
come with later slices of the port.

Speculative serving: ``--speculative-continuous`` with a draft makes every
engine pass draft-and-verify (``continuous.py``).  ``--auto-draft`` builds
the draft from the serving weights (:func:`build_auto_draft`);
``--draft-params-npz`` loads one whose dimensions the ``--draft-*`` flags
give.  ``--logit-bias 'id:val,...'`` biases the logits in every mode.

Weights: ``--params-npz`` (a file written by
``tpu_dra_torch.convert.save_npz``) or ``--init-seed`` (random weights
drawn on the device from that seed), served in the form ``--weights``
names (``quant.py``: fp32, bf16, int8 or int4).  An npz that already
holds a quantized tree is served as it is, and ``--weights`` must name
its form.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from tpu_dra_torch.device import resolve_device
from tpu_dra_torch.workloads.continuous import (
    DEADLINE_ERROR,
    ContinuousEngine,
)
from tpu_dra_torch.workloads.train import ModelConfig

# upper bound on one request's wall time (first-use kernel build included)
ENGINE_REQUEST_TIMEOUT_S = 600


def make_handler(engine: ContinuousEngine, health=None,
                 health_stale_after: float = 600.0):
    """Request handler class over ``engine``.  ``health``: optional
    external /healthz verdict — a callable returning bool or
    ``(bool, detail)`` — ANDed with the engine's decode-loop liveness."""

    def healthz_verdict() -> tuple[bool, str]:
        if engine.draining:
            return False, "draining: shutting down after in-flight " \
                          "requests complete"
        ok, detail = engine.healthy(stale_after=health_stale_after)
        if ok and health is not None:
            verdict = health()
            if isinstance(verdict, tuple):
                ok, detail = verdict
            elif not verdict:
                ok, detail = False, "health monitor reports unhealthy"
        return ok, detail

    def generate(req: dict) -> dict:
        rows = req["tokens"]
        if not isinstance(rows, list) or not rows or not all(
                isinstance(r, list) and r for r in rows):
            raise ValueError("tokens must be a non-empty list of "
                             "non-empty rows")
        for knob, noop in (("top_k", 0.0), ("top_p", 0.0),
                           ("repetition_penalty", 1.0)):
            val = req.get(knob)
            if val is not None and float(val) != noop:
                raise ValueError(f"{knob} is engine-global in continuous "
                                 f"mode")
        rows = [[int(t) for t in r] for r in rows]
        eos = req.get("eos_id")
        handles = []
        try:
            for r in rows:
                handles.append(engine.submit_async(
                    r, int(req.get("steps", 16)),
                    eos_id=None if eos is None else int(eos),
                    temperature=float(req.get("temperature", 0.0)),
                    seed=int(req.get("seed", 0)),
                    prefix_id=req.get("prefix_id"),
                    stop=req.get("stop")))
        except (ValueError, RuntimeError):
            for h in handles:     # don't strand already-submitted rows
                engine.cancel(h)
            raise
        out = []
        for h in handles:
            if not h.done.wait(ENGINE_REQUEST_TIMEOUT_S):
                for h2 in handles:
                    engine.cancel(h2)
                raise RuntimeError(f"request not done within "
                                   f"{ENGINE_REQUEST_TIMEOUT_S}s")
            if h.error:
                raise RuntimeError(h.error)
            out.append(h.tokens)
        return {"tokens": out}

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):             # quiet by default
            pass

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self) -> bytes | None:
            """The request body, or None after answering 400 (with the
            connection closed: an unknown length leaves the stream
            unparseable)."""
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                n = -1
            if n < 0:
                self.close_connection = True
                self._send(400, json.dumps(
                    {"error": "bad Content-Length"}).encode())
                return None
            return self.rfile.read(n)

        def do_GET(self):
            if self.path == "/healthz":
                ok, detail = healthz_verdict()
                self._send(200 if ok else 503, (detail or "ok").encode(),
                           "text/plain")
            elif self.path == "/stats":
                self._send(200, json.dumps(engine.stats()).encode())
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            raw = self._read_body()
            if raw is None:
                return
            if self.path != "/generate":
                self._send(404, b"not found", "text/plain")
                return
            try:
                result = generate(json.loads(raw))
                code, body = 200, json.dumps(result).encode()
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as exc:
                code, body = 400, json.dumps(
                    {"error": str(exc)[:300]}).encode()
            except RuntimeError as exc:      # engine, not input
                msg = str(exc)
                code = 504 if msg == DEADLINE_ERROR else (
                    503 if "draining" in msg else 500)
                body = json.dumps({"error": msg[:300]}).encode()
            self._send(code, body)

    return Handler


def serve(cfg: ModelConfig, params, *, host: str = "127.0.0.1",
          port: int = 8477, cache_dtype: str = "bf16",
          continuous: bool = True, slots: int = 32, chunk: int = 4,
          kv_layout: str = "slab", page_size: int = 64,
          total_pages: int | None = None, draft: tuple | None = None,
          speculative_engine: bool = False,
          logit_bias: dict[int, float] | None = None, health=None,
          health_stale_after: float = 600.0,
          device=None) -> ThreadingHTTPServer:
    """Start the server on a daemon thread and return it (``.shutdown()``
    stops the server and the engine).  ``port`` 0 picks a free port
    (``server.server_address``).  ``/generate`` runs over a
    ContinuousEngine with ``slots`` in-flight sequences and a ``kv_layout``
    ("slab" or "paged") KV cache, on ``device`` (default: the card).
    ``speculative_engine`` (needs ``draft=(draft_cfg, draft_params)``)
    makes each engine pass one draft-and-verify iteration;
    ``logit_bias`` is the engine-global bias."""
    if not continuous:
        raise ValueError("only --continuous is ported; the bucketed "
                         "DecoderPool comes with later slices of the "
                         "PyTorch port")
    if speculative_engine != (draft is not None):
        raise ValueError("speculative_engine needs a draft model, and a "
                         "draft serves only in the speculative engine (the "
                         "bucketed /speculative path comes with later "
                         "slices of the PyTorch port)")
    engine = ContinuousEngine(cfg, params, slots=slots, chunk=chunk,
                              cache_dtype=cache_dtype, kv_layout=kv_layout,
                              page_size=page_size, total_pages=total_pages,
                              draft=draft, logit_bias=logit_bias,
                              device=device)
    try:
        srv = ThreadingHTTPServer(
            (host, port), make_handler(engine, health, health_stale_after))
    except OSError:
        engine.shutdown()
        raise
    srv.engine = engine
    orig_shutdown = srv.shutdown

    def shutdown():
        orig_shutdown()
        srv.server_close()
        engine.shutdown()
    srv.shutdown = shutdown
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="serve-http").start()
    return srv


WEIGHT_FORMS = ("fp32", "bf16", "int8", "int4")


def serving_form(params: dict) -> str | None:
    """"int8" or "int4" for a tree that already holds quantized leaves,
    else None."""
    leaves = [params.get("unembed"), *params["blocks"].values()]
    for form, key in (("int8", "q8"), ("int4", "q4")):
        if any(isinstance(w, dict) and key in w for w in leaves):
            return form
    return None


def load_params(cfg: ModelConfig, *, params_npz: str = "",
                init_seed: int | None = None, weights: str = "bf16",
                device=None) -> dict:
    """Serving weights in the form ``weights`` (one of
    :data:`WEIGHT_FORMS`) on ``device`` (default: the card): from an npz
    written by ``tpu_dra_torch.convert.save_npz``, else random from
    ``init_seed``.  A tree that is already quantized is returned as it
    is, and ``weights`` must name its form."""
    if weights not in WEIGHT_FORMS:
        raise ValueError(f"weights must be one of {WEIGHT_FORMS}, got "
                         f"{weights!r}")
    dev = resolve_device(device)
    if params_npz:
        from tpu_dra_torch.convert import load_npz
        params = load_npz(params_npz, device=dev)
    elif init_seed is not None:
        from tpu_dra_torch.workloads.train import init_params
        gen = torch.Generator(device=dev)
        gen.manual_seed(init_seed)
        params = init_params(cfg, gen)
    else:
        raise ValueError("give --params-npz or --init-seed")
    held = serving_form(params)
    if held is not None:
        if held != weights:
            raise ValueError(f"--params-npz {params_npz} holds {held} "
                             f"weights but --weights {weights} was asked "
                             f"for")
        return params
    return to_form(params, weights)


def to_form(params: dict, form: str) -> dict:
    """An fp32 tree in the serving weight ``form`` (``quant.py``)."""
    from tpu_dra_torch.workloads import quant
    return {"fp32": lambda p: p, "bf16": quant.cast_params_bf16,
            "int8": quant.quantize_params_int8,
            "int4": quant.quantize_params_int4}[form](params)


def build_auto_draft(cfg: ModelConfig, fp32_params, *, form: str = "fp32",
                     n_layers: int | None = None, steps: int = 200,
                     batch: int = 8):
    """A draft built from the serving model: quarter-depth truncation
    and distillation (``spec_draft.make_draft``) from the fp32 tree
    (quantized leaves have no gradients), then the serving weight
    ``form``, so the draft's per-token read shrinks with the target's."""
    from tpu_dra_torch.workloads.spec_draft import make_draft
    dcfg, dparams = make_draft(cfg, fp32_params, n_layers=n_layers,
                               distill_steps=steps, batch=batch)
    return dcfg, to_form(dparams, form)


# the flags that need checkpointing.py, not ported yet
_NEEDS_CHECKPOINTING = ("needs checkpointing.py, which comes with a later "
                        "slice of the PyTorch port (ROADMAP queue 1 item 5)")


def main(argv=None) -> int:
    """Serve the model: ``python -m tpu_dra_torch.workloads.serve
    --continuous --weights int8 --params-npz w.npz --vocab 32768 ...``
    (the flags must describe the model the weights belong to)."""
    import argparse
    import signal

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--params-npz", default="",
                    help="weights written by tpu_dra_torch.convert."
                         "save_npz (see README: from a JAX checkpoint)")
    ap.add_argument("--init-seed", type=int, default=None,
                    help="random weights from this seed (no --params-npz)")
    ap.add_argument("--port", type=int, default=8477)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--n-heads", type=int, default=8)
    ap.add_argument("--n-kv-heads", type=int, default=None)
    ap.add_argument("--n-layers", type=int, default=8)
    ap.add_argument("--d-ff", type=int, default=2048)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--pos-emb", default="rope")
    ap.add_argument("--weights", default="bf16", choices=WEIGHT_FORMS,
                    help="serving weight form (quant.py): fp32 serves the "
                         "weights as loaded; bf16 halves the fp32 weight "
                         "bytes, int8 quarters them, int4 (group-scaled, "
                         "one value per byte) quarters them too.  Default "
                         "bf16: the port has no --weights-cache to record "
                         "a form in, so it takes the reference's serving "
                         "baseline.  An npz that holds quantized weights "
                         "is served as it is and must be named by its form")
    ap.add_argument("--cache-dtype", default="bf16",
                    choices=("bf16", "int8"))
    ap.add_argument("--continuous", action="store_true",
                    help="continuously-batched /generate (required: the "
                         "only mode ported)")
    ap.add_argument("--kv-layout", default="slab",
                    choices=("slab", "paged"),
                    help="KV memory: 'slab' preallocates max_len per slot; "
                         "'paged' allocates block-table pages per request "
                         "(prompt + steps) from a shared pool")
    ap.add_argument("--slots", type=int, default=32,
                    help="concurrent in-flight sequences")
    ap.add_argument("--chunk", type=int, default=4,
                    help="tokens per pass (join granularity)")
    ap.add_argument("--page-size", type=int, default=64,
                    help="tokens per KV page")
    ap.add_argument("--total-pages", type=int, default=None,
                    help="pool capacity (default slots*max_seq/page_size)")
    ap.add_argument("--warmup", action="store_true",
                    help="run every prompt bucket once before accepting "
                         "traffic")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card; "
                         "'cpu' runs the plain versions of the kernels)")
    ap.add_argument("--logit-bias", default="",
                    help="engine-global logit bias 'id:val,id:val': ban "
                         "(-1e9) or nudge tokens in every mode (greedy, "
                         "sampled, the speculative p and q)")
    ap.add_argument("--speculative-continuous", action="store_true",
                    help="with a draft: the engine drafts and verifies "
                         "each pass (per-slot accept counts; greedy "
                         "requests keep the plain engine's tokens, sampled "
                         "ones commit by the rejection scheme)")
    ap.add_argument("--auto-draft", action="store_true",
                    help="build the draft from the serving weights: "
                         "quarter-depth truncation and distillation "
                         "(workloads/spec_draft.py) from the fp32 tree, "
                         "then the --weights form")
    ap.add_argument("--auto-draft-layers", type=int, default=None,
                    help="auto-draft depth (default n_layers//4, min 1)")
    ap.add_argument("--auto-draft-steps", type=int, default=200,
                    help="distillation steps at startup (0 = truncation "
                         "only)")
    ap.add_argument("--auto-draft-cache", default="",
                    help="directory caching the distilled draft "
                         "(not ported yet: " + _NEEDS_CHECKPOINTING + ")")
    ap.add_argument("--draft-checkpoint-dir", default="",
                    help="a draft model's training checkpoint (not ported "
                         "yet: " + _NEEDS_CHECKPOINTING + ")")
    ap.add_argument("--draft-params-npz", default="",
                    help="a draft model's weights written by "
                         "tpu_dra_torch.convert.save_npz, its dimensions "
                         "given by --draft-*; served in the --weights form")
    ap.add_argument("--draft-d-model", type=int, default=128)
    ap.add_argument("--draft-n-heads", type=int, default=4)
    ap.add_argument("--draft-n-kv-heads", type=int, default=None)
    ap.add_argument("--draft-n-layers", type=int, default=2)
    ap.add_argument("--draft-d-ff", type=int, default=512)
    args = ap.parse_args(argv)
    if not args.continuous:
        ap.error("only --continuous is ported")
    for flag in ("auto_draft_cache", "draft_checkpoint_dir"):
        if getattr(args, flag):
            ap.error(f"--{flag.replace('_', '-')} {_NEEDS_CHECKPOINTING}; "
                     f"serve with --auto-draft or --draft-params-npz")
    if args.auto_draft and args.draft_params_npz:
        ap.error("--auto-draft conflicts with --draft-params-npz (pick one "
                 "draft source)")
    has_draft = args.auto_draft or bool(args.draft_params_npz)
    if args.speculative_continuous != has_draft:
        ap.error("--speculative-continuous needs a draft (--auto-draft or "
                 "--draft-params-npz), and a draft serves only with "
                 "--speculative-continuous")
    logit_bias = None
    if args.logit_bias:
        try:
            logit_bias = {int(p.split(":")[0]): float(p.split(":")[1])
                          for p in args.logit_bias.split(",") if p}
        except (ValueError, IndexError):
            ap.error(f"--logit-bias must be 'id:val,id:val', got "
                     f"{args.logit_bias!r}")
    cfg = ModelConfig(vocab=args.vocab, d_model=args.d_model,
                      n_heads=args.n_heads, n_kv_heads=args.n_kv_heads,
                      n_layers=args.n_layers, d_ff=args.d_ff,
                      max_seq=args.max_seq, pos_emb=args.pos_emb)
    draft = None
    try:
        if args.auto_draft:
            # distillation needs the fp32 tree: load it, then take the
            # serving form of both models from it
            fp32 = load_params(cfg, params_npz=args.params_npz,
                               init_seed=args.init_seed, weights="fp32",
                               device=args.device)
            draft = build_auto_draft(cfg, fp32, form=args.weights,
                                     n_layers=args.auto_draft_layers,
                                     steps=args.auto_draft_steps)
            params = to_form(fp32, args.weights)
            del fp32
        else:
            params = load_params(cfg, params_npz=args.params_npz,
                                 init_seed=args.init_seed,
                                 weights=args.weights, device=args.device)
        if args.draft_params_npz:
            dcfg = ModelConfig(
                vocab=args.vocab, d_model=args.draft_d_model,
                n_heads=args.draft_n_heads,
                n_kv_heads=args.draft_n_kv_heads,
                n_layers=args.draft_n_layers, d_ff=args.draft_d_ff,
                max_seq=args.max_seq, pos_emb=args.pos_emb)
            draft = (dcfg, load_params(dcfg,
                                       params_npz=args.draft_params_npz,
                                       weights=args.weights,
                                       device=args.device))
    except ValueError as exc:
        ap.error(str(exc))
    srv = serve(cfg, params, host=args.host, port=args.port,
                cache_dtype=args.cache_dtype, continuous=True,
                slots=args.slots, chunk=args.chunk,
                kv_layout=args.kv_layout, page_size=args.page_size,
                total_pages=args.total_pages, draft=draft,
                speculative_engine=args.speculative_continuous,
                logit_bias=logit_bias, device=args.device)
    if args.warmup:
        print(f"warmed {srv.engine.warmup()} prompt buckets", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    print(f"serving on {srv.server_address}", flush=True)
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    srv.engine.drain(25.0)
    srv.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
