"""HTTP inference server over the continuous engine, ported from
``tpu_dra/workloads/serve.py`` (its ``--continuous`` mode, slab or paged
KV layout).  stdlib HTTP server, one engine per process.

POST /generate  {"tokens": [[...]], "steps": N, "temperature": 0.0,
                 "seed": 0, "eos_id": null, "prefix_id": null,
                 "stop": [[ids...], ...]}
             → {"tokens": [[...]]}      (the generated ids per row; every
                 row is its own engine request, fanned in concurrently;
                 a completed stop sequence retires the row and is
                 trimmed from its tokens)
POST /prefix    {"tokens": [...]} → {"prefix_id": id}: registers a shared
             prompt prefix (a system prompt) whose KV is computed once;
             /generate and /stream requests naming it prefill only their
             suffix (on pages the prefix's full pages are shared)
POST /stream    (one row) chunked NDJSON: a {"token": id} line per
             generated token as it lands, then {"done": true, "tokens":
             [...]} (authoritative after a stop trim); a client that
             disconnects cancels the request and frees its slot
GET  /healthz → 200 "ok" while the engine's decode loop is live (ANDed
             with an optional external verdict); 503 + reason otherwise,
             and from the moment a drain begins
GET  /stats   → the engine's ``stats()`` as JSON
GET  /metrics → Prometheus text: request counts by path, code and
             tenant (the ``X-Tenant`` header), generated tokens, request
             latency, TTFT and inter-token histograms, shed counts by
             reason, and the ``tpu_serve_engine_*`` gauges (the
             reference's names, labels and buckets)
GET  /debug/slo → multi-window error-budget burn rates (availability and
             latency objectives)
GET  /debug/overload → drain state, admission backlog, shed counts and
             the engine's saturation signals

Overload protection (``--admission-max-cost``): /generate and /stream
pass an admission gate first; excess load sheds with an immediate typed
503 + ``Retry-After``.  ``X-Deadline-Ms`` propagates into the engine, so
an expired request aborts, frees its slot and pages and answers 504
(``reason: deadline_expired``).  SIGTERM drains: new requests shed 503,
/healthz goes not-ready, in-flight ones finish, then the process exits.

Not ported yet, each answered 404 with its ROADMAP item: /beam and
/speculative (the bucketed ``DecoderPool``, queue 1 item 7), /prefill
and /decode_handoff (``kv_handoff.py``, item 8), /debug/traces and
/debug/jax-trace (spans and a profiler capture, item 7); OpenMetrics
exemplars wait for the spans.

Speculative serving: ``--speculative-continuous`` with a draft makes every
engine pass draft-and-verify (``continuous.py``).  ``--auto-draft`` builds
the draft from the serving weights (:func:`build_auto_draft`);
``--draft-params-npz`` loads one whose dimensions the ``--draft-*`` flags
give.  ``--logit-bias 'id:val,...'`` biases the logits in every mode.

Weights: ``--checkpoint-dir`` (a training checkpoint of the port's
``fit``, ``checkpointing.py``), ``--params-npz`` (a file written by
``tpu_dra_torch.convert.save_npz``: how a JAX checkpoint crosses) or
``--init-seed`` (random weights drawn on the device from that seed),
served in the form ``--weights`` names (``quant.py``: fp32, bf16, int8 or
int4; default: the weights cache's recorded form, else fp32).
``--weights-cache`` holds the serving tree: restored directly when
populated (no quantization at start), populated from the source above
otherwise; a cache of another form or model is an error.  An npz that
already holds a quantized tree is served as it is, and ``--weights`` must
name its form if given.  Drafts: ``--draft-checkpoint-dir`` serves a
draft's training checkpoint as it is; ``--auto-draft-cache`` keeps the
distilled draft (:func:`resolve_auto_draft`).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from tpu_dra_torch.device import resolve_device
from tpu_dra_torch.util.metrics import (
    Registry,
    bounded_label,
    negotiate_exposition,
)
from tpu_dra_torch.workloads.admission import (
    REASON_DEADLINE,
    REASON_DRAINING,
    AdmissionController,
    DeadlineExceeded,
    ShedError,
    parse_deadline_ms,
    request_cost,
)
from tpu_dra_torch.workloads.continuous import (
    DEADLINE_ERROR,
    ContinuousEngine,
)
from tpu_dra_torch.workloads.slo import (
    Objective,
    SloTracker,
    counter_good_total,
    histogram_under,
)
from tpu_dra_torch.workloads.train import ModelConfig

# upper bound on one request's wall time (first-use kernel build included)
ENGINE_REQUEST_TIMEOUT_S = 600

# the reference's endpoint surface: paths outside it still get their 404
# but collapse into one "other" label, so cycling request paths cannot
# mint unbounded tpu_serve_* series
_SERVE_PATHS = frozenset((
    "/healthz", "/metrics", "/debug/slo", "/debug/overload",
    "/debug/traces", "/debug/jax-trace", "/stream", "/prefix", "/beam",
    "/speculative", "/prefill", "/decode_handoff", "/generate"))

# endpoints of the reference not ported yet, and the ROADMAP item of each
_NOT_PORTED = {
    "/beam": "the bucketed DecoderPool's beam search (ROADMAP queue 1 "
             "item 7)",
    "/speculative": "the bucketed DecoderPool's speculative decode "
                    "(ROADMAP queue 1 item 7; the engine speculates with "
                    "--speculative-continuous)",
    "/prefill": "the KV handoff, kv_handoff.py (ROADMAP queue 1 item 8)",
    "/decode_handoff": "the KV handoff, kv_handoff.py (ROADMAP queue 1 "
                       "item 8)",
    "/debug/traces": "spans and their Chrome trace (ROADMAP queue 1 "
                     "item 7)",
    "/debug/jax-trace": "a device trace capture (ROADMAP queue 1 item 7)",
}


def _count_leaf_tokens(tokens) -> int:
    """Generated-token count of a /generate response's [rows][steps]."""
    if not isinstance(tokens, list):
        return 0
    if all(isinstance(t, int) for t in tokens):
        return len(tokens)
    return sum(_count_leaf_tokens(t) for t in tokens)


class ServeMetrics:
    """Prometheus series of the inference endpoint, with the reference's
    names, labels and buckets.

    Every request series carries a ``tenant`` label (the ``X-Tenant``
    header; ``default`` when absent).  The header is untrusted input
    becoming a label, so the first :data:`MAX_TENANTS` distinct values
    keep their own series and later ones collapse into
    :data:`OVERFLOW_TENANT` (values length-clamped)."""

    MAX_TENANTS = 64
    # the "~" is stripped from client input, so no header value can
    # claim this series
    OVERFLOW_TENANT = "~overflow~"

    def __init__(self) -> None:
        self.registry = Registry()
        self._tenants: set[str] = set()        # guarded by _tenant_mu
        self._tenant_mu = threading.Lock()
        self.requests = self.registry.counter(
            "tpu_serve_requests_total", "HTTP requests",
            ("path", "code", "tenant"))
        self.tokens = self.registry.counter(
            "tpu_serve_generated_tokens_total", "tokens generated")
        self.latency = self.registry.histogram(
            "tpu_serve_request_seconds", "request wall time",
            # cold requests include kernel builds and the engine timeout
            # is 600 s: the default buckets would collapse them into +Inf
            buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5,
                     5, 10, 30, 60, 120, 300, 600),
            labels=("path", "tenant"))
        self.ttft = self.registry.histogram(
            "tpu_serve_ttft_seconds",
            "time to first generated token (continuous engine requests)",
            buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5,
                     5, 10, 30, 60),
            labels=("tenant",))
        self.itl = self.registry.histogram(
            "tpu_serve_inter_token_seconds",
            "mean gap between generated tokens, one observation per "
            "continuous-engine request of 2+ tokens",
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1, 2.5),
            labels=("tenant",))
        # every shed decision, by typed reason: server-refused work
        # (503) burns the availability budget, deadline_expired (504) is
        # the client giving up and is attributed distinctly
        self.shed = self.registry.counter(
            "tpu_serve_shed_total",
            "requests shed instead of served, by typed reason",
            ("reason",))

    def tenant_label(self, raw: str) -> str:
        """The untrusted ``X-Tenant`` header as a bounded label value."""
        return bounded_label(
            raw, seen=self._tenants, cap=self.MAX_TENANTS,
            lock=self._tenant_mu, overflow=self.OVERFLOW_TENANT)

    def observe(self, path: str, code: int, secs: float,
                tokens: int = 0, tenant: str = "default") -> None:
        self.requests.inc(path, str(code), tenant)
        self.latency.observe(secs, path, tenant)
        if tokens:
            self.tokens.inc(by=tokens)

    def observe_engine_timing(self, tenant: str, handle) -> None:
        """TTFT and the mean inter-token gap from a finished engine
        request's timestamps."""
        if not handle.first_token_at:
            return
        self.ttft.observe(handle.first_token_at - handle.submitted,
                          tenant)
        n = len(handle.tokens)
        end = handle.finished or handle.first_token_at
        if n >= 2 and end > handle.first_token_at:
            self.itl.observe((end - handle.first_token_at) / (n - 1),
                             tenant)

    def scrape_engine(self, engine) -> None:
        """Refresh the ``tpu_serve_engine_*`` gauges at scrape time."""
        stats = engine.stats()
        slots = stats.get("slots") or 0
        gauges = {
            "tpu_serve_engine_completed": ("requests completed",
                                           stats.get("completed")),
            "tpu_serve_engine_tokens_out": ("tokens generated",
                                            stats.get("tokens_out")),
            "tpu_serve_engine_queued": ("requests waiting for a slot",
                                        stats.get("queued")),
            "tpu_serve_engine_active": ("requests decoding in a slot",
                                        stats.get("active")),
            "tpu_serve_engine_slots": ("concurrent sequence capacity",
                                       slots or None),
            "tpu_serve_engine_batch_occupancy": (
                "live slots over slot capacity (1.0 = decode batch "
                "full; admission pressure follows)",
                (stats.get("active", 0) / slots) if slots else None),
            "tpu_serve_engine_kv_pages_free": (
                "paged-KV pool pages currently free",
                stats.get("kv_pages_free")),
            "tpu_serve_engine_kv_pages_total": (
                "paged-KV pool capacity in pages",
                stats.get("kv_pages_total")),
            "tpu_serve_engine_goodput_slot_seconds": (
                "cumulative slot residency of requests that completed "
                "(the serving goodput segment)",
                stats.get("goodput_slot_s")),
            "tpu_serve_engine_spec_target_passes": (
                "speculative mode: target verify passes",
                stats.get("spec_target_passes")),
            "tpu_serve_engine_spec_tokens_per_pass": (
                "speculative mode: committed tokens per live slot per "
                "target pass (1.0 parity, chunk ceiling)",
                stats.get("spec_tokens_per_pass")),
            "tpu_serve_engine_spec_accept_rate": (
                "speculative mode: accepted drafted tokens / proposed "
                "(1.0 ceiling; ~1/vocab random draft)",
                stats.get("spec_accept_rate")),
        }
        for name, (help_, value) in gauges.items():
            if value is not None:
                self.registry.gauge(name, help_).set(float(value))
        badput = stats.get("badput_slot_s") or {}
        if badput:
            g = self.registry.gauge(
                "tpu_serve_engine_badput_slot_seconds",
                "cumulative slot residency of aborted requests (chip "
                "time nobody waited for), by reason", ("reason",))
            for reason, secs in badput.items():
                g.set(float(secs), reason)


def make_handler(engine: ContinuousEngine, health=None,
                 health_stale_after: float = 600.0, *, metrics=None,
                 slo=None, admission=None,
                 default_deadline_s: float | None = None):
    """Request handler class over ``engine``.  ``health``: optional
    external /healthz verdict — a callable returning bool or
    ``(bool, detail)`` — ANDed with the engine's decode-loop liveness.
    ``metrics`` (a :class:`ServeMetrics`) arms /metrics, ``slo`` (a
    ``SloTracker``) /debug/slo; ``admission`` (an
    ``AdmissionController``) gates /generate and /stream;
    ``default_deadline_s`` applies to requests without an
    ``X-Deadline-Ms`` header."""

    def _draining_shed(detail: str) -> ShedError:
        retry = int(admission.drain_grace_s) if admission is not None \
            else 5
        return ShedError(REASON_DRAINING, max(1, retry), detail)

    def draining() -> bool:
        return (admission is not None and admission.draining) or \
            engine.draining

    def healthz_verdict() -> tuple[bool, str]:
        if draining():
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

    def reject_engine_knobs(req: dict) -> None:
        for knob, noop in (("top_k", 0.0), ("top_p", 0.0),
                           ("repetition_penalty", 1.0)):
            val = req.get(knob)
            if val is not None and float(val) != noop:
                raise ValueError(f"{knob} is engine-global in continuous "
                                 f"mode")

    def stop_of(req: dict):
        stop = req.get("stop")
        return None if stop is None else [[int(t) for t in seq]
                                          for seq in stop]

    def submit(row, req: dict, deadline):
        eos = req.get("eos_id")
        try:
            return engine.submit_async(
                [int(t) for t in row], int(req.get("steps", 16)),
                eos_id=None if eos is None else int(eos),
                temperature=float(req.get("temperature", 0.0)),
                seed=int(req.get("seed", 0)),
                prefix_id=req.get("prefix_id"), stop=stop_of(req),
                deadline=deadline)
        except RuntimeError as exc:
            if "draining" in str(exc):
                # admission won the race against the drain, the engine
                # had already closed: still a typed, retryable shed
                raise _draining_shed(str(exc)) from None
            raise

    def generate(req: dict, tenant: str, deadline) -> dict:
        rows = req["tokens"]
        if not isinstance(rows, list) or not rows or not all(
                isinstance(r, list) and r for r in rows):
            raise ValueError("tokens must be a non-empty list of "
                             "non-empty rows")
        reject_engine_knobs(req)
        handles = []
        try:
            for r in rows:
                handles.append(submit(r, req, deadline))
        except (ValueError, TypeError, RuntimeError, ShedError):
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
                for h2 in handles:
                    engine.cancel(h2)
                if h.error == DEADLINE_ERROR:
                    # aborted or refused for the client's deadline; its
                    # pages are already back in the pool
                    raise DeadlineExceeded(h.error)
                raise RuntimeError(h.error)
            if metrics is not None:
                metrics.observe_engine_timing(tenant, h)
            out.append(h.tokens)
        return {"tokens": out}

    def register_prefix(req: dict, tenant: str, deadline) -> dict:
        return {"prefix_id": engine.register_prefix(req["tokens"])}

    class Handler(BaseHTTPRequestHandler):
        # chunked transfer (/stream) is an HTTP/1.1 construct
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):             # quiet by default
            pass

        def _path_label(self) -> str:
            return bounded_label(self.path, allowed=_SERVE_PATHS)

        def _content_length(self) -> int:
            """The body's length; a missing one is 0, an unparsable or
            negative one raises ``ValueError`` and closes the connection
            after the answer (the stream cannot be parsed past it)."""
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                n = -1
            if n < 0:
                self.close_connection = True
                raise ValueError("bad Content-Length")
            return n

        def _drain_body(self) -> None:
            """Consume the body before an early answer: on a keep-alive
            connection unread bytes would parse as the next request."""
            try:
                n = self._content_length()
            except ValueError:
                return
            if n:
                self.rfile.read(n)

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/json", headers=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def _count_shed(self, reason: str) -> None:
            """One accounting point for every shed: the counter and
            /debug/overload's snapshot must never diverge."""
            if metrics is not None:
                metrics.shed.inc(reason)
            if admission is not None:
                admission.record_shed(reason)

        @staticmethod
        def _shed_payload(shed: ShedError) -> tuple[bytes, dict]:
            """The typed 503's body and ``Retry-After`` header."""
            return (json.dumps(
                {"error": str(shed)[:300], "reason": shed.reason,
                 "retry_after_s": shed.retry_after_s}).encode(),
                {"Retry-After": str(shed.retry_after_s)})

        def _observe(self, code: int, t0: float, tokens: int,
                     tenant: str) -> None:
            if metrics is not None:
                metrics.observe(self._path_label(), code,
                                time.perf_counter() - t0, tokens, tenant)

        def _deadline(self) -> float | None:
            """Absolute deadline (perf_counter clock) from the
            ``X-Deadline-Ms`` budget, else the server's default."""
            budget = parse_deadline_ms(self.headers.get("X-Deadline-Ms"))
            if budget is None:
                budget = default_deadline_s
            return None if budget is None else time.perf_counter() + budget

        def _tenant(self) -> str:
            raw = self.headers.get("X-Tenant", "") or "default"
            return metrics.tenant_label(raw) if metrics is not None \
                else raw

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/healthz":
                ok, detail = healthz_verdict()
                self._send(200 if ok else 503, (detail or "ok").encode(),
                           "text/plain")
            elif path == "/stats":
                self._send(200, json.dumps(engine.stats()).encode())
            elif path == "/metrics" and metrics is not None:
                metrics.scrape_engine(engine)
                text, ctype = negotiate_exposition(
                    self.headers.get("Accept", ""), metrics.registry)
                self._send(200, text.encode(), ctype)
            elif path == "/debug/slo" and slo is not None:
                self._send(200, json.dumps(slo.burn_rates()).encode())
            elif path == "/debug/overload":
                self._send(200, json.dumps(self._overload()).encode())
            elif path in _NOT_PORTED:
                self._send(404, f"{path} is not ported yet: it comes with "
                                f"{_NOT_PORTED[path]}".encode(),
                           "text/plain")
            else:
                self._send(404, b"not found", "text/plain")

        @staticmethod
        def _overload() -> dict:
            """Drain state, admission backlog and sheds, and the engine's
            saturation signals (the reference's keys; the pool role is
            "any" until the KV handoff is ported)."""
            stats = engine.stats()
            slots = stats.get("slots") or 0
            return {
                "state": "draining" if draining() else "running",
                "role": "any",
                "admission": (admission.snapshot()
                              if admission is not None else None),
                "engine": {
                    "queued": stats.get("queued"),
                    "active": stats.get("active"),
                    "slots": slots,
                    "batch_occupancy": round(
                        stats.get("active", 0) / slots, 3)
                    if slots else None,
                    "kv_pages_free": stats.get("kv_pages_free"),
                    "kv_pages_total": stats.get("kv_pages_total"),
                    "expired_queued": stats.get("expired_queued"),
                    "expired_active": stats.get("expired_active"),
                    "goodput_slot_s": stats.get("goodput_slot_s"),
                    "badput_slot_s": stats.get("badput_slot_s"),
                },
            }

        def _json_post(self, handle, admit: bool = False):
            """Parse the JSON body, call ``handle(req, tenant, deadline)
            -> response dict``, and map failures to codes: a shed 503
            with ``Retry-After``, an expired deadline 504, bad input 400,
            an engine failure 500.  With ``admit`` the request passes the
            admission gate first.  Every request lands in /metrics
            before its answer is sent, so a client that has its reply
            finds it on the next scrape."""
            t0 = time.perf_counter()
            code, toks, headers = 200, 0, None
            tenant = self._tenant()
            ticket = None
            try:
                try:
                    req = json.loads(self.rfile.read(self._content_length()))
                    if not isinstance(req, dict):
                        raise ValueError("the body must be a JSON object")
                    deadline = self._deadline()
                    if admit and admission is not None:
                        ticket = admission.acquire(tenant, request_cost(
                            req.get("tokens") or [], req.get("steps", 16)))
                    if deadline is not None and \
                            time.perf_counter() > deadline:
                        raise DeadlineExceeded(
                            "deadline expired before admission")
                    result = handle(req, tenant, deadline)
                    toks = _count_leaf_tokens(result.get("tokens"))
                    body = json.dumps(result).encode()
                except ShedError as exc:
                    code = 503
                    body, headers = self._shed_payload(exc)
                    self._count_shed(exc.reason)
                except DeadlineExceeded as exc:
                    code = 504
                    body = json.dumps({"error": str(exc)[:300],
                                       "reason": REASON_DEADLINE}).encode()
                    self._count_shed(REASON_DEADLINE)
                except (KeyError, ValueError, TypeError,
                        json.JSONDecodeError) as exc:
                    code = 400
                    body = json.dumps({"error": str(exc)[:300]}).encode()
                except RuntimeError as exc:      # engine, not input
                    code = 500
                    body = json.dumps({"error": str(exc)[:300]}).encode()
                self._observe(code, t0, toks, tenant)
                self._send(code, body, headers=headers)
            finally:
                # released after the response is written: the drain's
                # wait_idle must not return while a client still waits
                if ticket is not None:
                    admission.release(ticket, completed=code == 200)

        def _stream(self):
            """POST /stream (one row): chunked NDJSON, a {"token": id}
            line per generated token as the engine emits it, then
            {"done": true, "tokens": [...]}.  With "stop", lines may
            carry tokens of a stop sequence the engine trims on its
            match: the final tokens are authoritative."""
            t0 = time.perf_counter()
            tenant = self._tenant()
            ticket = None
            try:
                raw = self.rfile.read(self._content_length())
                req = json.loads(raw)
                rows = req.get("tokens") if isinstance(req, dict) else None
                if not isinstance(rows, list) or len(rows) != 1 or \
                        not isinstance(rows[0], list) or not rows[0]:
                    raise ValueError("/stream takes exactly one non-empty "
                                     "row in tokens; fan /generate for "
                                     "batches")
                reject_engine_knobs(req)
                deadline = self._deadline()
                if admission is not None:
                    ticket = admission.acquire(
                        tenant, request_cost(rows, req.get("steps", 16)))
                handle = submit(rows[0], req, deadline)
            except ShedError as exc:
                if ticket is not None:
                    admission.release(ticket, completed=False)
                self._count_shed(exc.reason)
                self._observe(503, t0, 0, tenant)
                body, headers = self._shed_payload(exc)
                self._send(503, body, headers=headers)
                return
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as exc:
                if ticket is not None:
                    admission.release(ticket, completed=False)
                self._observe(400, t0, 0, tenant)
                self._send(400, json.dumps(
                    {"error": str(exc)[:300]}).encode())
                return
            except RuntimeError as exc:    # engine shut down
                if ticket is not None:
                    admission.release(ticket, completed=False)
                self._observe(500, t0, 0, tenant)
                self._send(500, json.dumps(
                    {"error": str(exc)[:300]}).encode())
                return
            try:
                if self.request_version != "HTTP/1.1":
                    code = self._stream_buffered(handle, tenant, t0)
                    completed = code == 200
                else:
                    code, completed = self._stream_chunked(handle, tenant,
                                                           t0)
                if ticket is not None:
                    admission.release(ticket, completed=completed)
            finally:
                # backstop for a raise mid-stream (a broken pipe on the
                # header write): never leak the slot or the ticket;
                # cancel is a no-op once done, release is idempotent
                try:
                    engine.cancel(handle)
                finally:
                    if ticket is not None:
                        admission.release(ticket, completed=False)

        def _stream_buffered(self, handle, tenant: str, t0: float) -> int:
            """An HTTP/1.0 client cannot parse chunked framing: it gets
            the whole answer as one JSON body."""
            if not handle.done.wait(ENGINE_REQUEST_TIMEOUT_S):
                engine.cancel(handle)
                code, body = 500, {"error": f"request not done within "
                                            f"{ENGINE_REQUEST_TIMEOUT_S}s"}
            elif handle.error == DEADLINE_ERROR:
                code, body = 504, {"error": handle.error,
                                   "reason": REASON_DEADLINE}
                self._count_shed(REASON_DEADLINE)
            elif handle.error:
                code, body = 500, {"error": handle.error[:300]}
            else:
                code, body = 200, {"done": True, "tokens": handle.tokens}
            if metrics is not None:
                metrics.observe_engine_timing(tenant, handle)
            self._observe(code, t0, len(handle.tokens), tenant)
            self._send(code, json.dumps(body).encode())
            return code

        def _stream_chunked(self, handle, tenant: str,
                            t0: float) -> tuple[int, bool]:
            """Push each token as it lands; a client gone (a failed
            write) or the time limit cancels the request so its slot and
            pages free.  Returns (code for the metrics, completed)."""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(obj) -> bool:
                data = (json.dumps(obj) + "\n").encode()
                try:
                    self.wfile.write(f"{len(data):x}\r\n".encode())
                    self.wfile.write(data + b"\r\n")
                    self.wfile.flush()
                    return True
                except OSError:
                    return False           # the client went away
            sent, alive, timed_out = 0, True, False
            limit = t0 + ENGINE_REQUEST_TIMEOUT_S
            while True:
                finished = handle.done.wait(0.05)
                current = list(handle.tokens)           # snapshot
                for tok in current[sent:]:
                    alive = alive and chunk({"token": tok})
                sent = len(current)
                if finished or not alive:
                    break
                if time.perf_counter() > limit:
                    timed_out = True
                    break
            if not alive or timed_out:
                engine.cancel(handle)
            code = 200
            if timed_out:
                code = 500
                alive = alive and chunk(
                    {"error": f"request not done within "
                              f"{ENGINE_REQUEST_TIMEOUT_S}s"})
            elif handle.error == DEADLINE_ERROR:
                # the status line already said 200: the error line is
                # the in-band signal, 504 in the metrics
                code = 504
                alive = alive and chunk({"error": handle.error,
                                         "reason": REASON_DEADLINE})
                self._count_shed(REASON_DEADLINE)
            elif handle.error:
                code = 500
                alive = alive and chunk({"error": handle.error[:300]})
            else:
                alive = alive and chunk({"done": True,
                                         "tokens": handle.tokens})
            try:
                self.wfile.write(b"0\r\n\r\n")      # chunked terminator
            except OSError:
                alive = False
            if metrics is not None:
                metrics.observe_engine_timing(tenant, handle)
            self._observe(code, t0, sent, tenant)
            return code, code == 200 and alive and not timed_out

        def do_POST(self):
            path = self.path
            if path == "/stream":
                self._stream()
            elif path == "/prefix":
                self._json_post(register_prefix)
            elif path == "/generate":
                self._json_post(generate, admit=True)
            elif path in _NOT_PORTED:
                self._drain_body()
                self._send(404, json.dumps(
                    {"error": f"{path} is not ported yet: it comes with "
                              f"{_NOT_PORTED[path]}"}).encode())
            else:
                self._drain_body()
                self._send(404, b"not found", "text/plain")

    return Handler


class _Server(ThreadingHTTPServer):
    # a burst of clients connecting at once (a router's fan-out, a load
    # test) must queue in the listen backlog, not be reset past
    # socketserver's default of 5
    request_queue_size = 128


def serve(cfg: ModelConfig, params, *, host: str = "127.0.0.1",
          port: int = 8477, cache_dtype: str = "bf16",
          continuous: bool = True, slots: int = 32, chunk: int = 4,
          kv_layout: str = "slab", page_size: int = 64,
          total_pages: int | None = None, draft: tuple | None = None,
          speculative_engine: bool = False,
          logit_bias: dict[int, float] | None = None, health=None,
          health_stale_after: float = 600.0,
          slo_latency_threshold: float = 1.0,
          slo_latency_target: float = 0.99,
          slo_availability_target: float = 0.999,
          admission_max_cost: int | None = None,
          admission_burst_fraction: float = 0.7,
          default_deadline_s: float | None = None,
          drain_grace_s: float = 25.0,
          device=None) -> ThreadingHTTPServer:
    """Start the server on a daemon thread and return it (``.shutdown()``
    stops the server, the SLO sampler and the engine; ``.drain()`` runs
    the graceful drain first).  ``port`` 0 picks a free port
    (``server.server_address``).  ``/generate`` runs over a
    ContinuousEngine with ``slots`` in-flight sequences and a ``kv_layout``
    ("slab" or "paged") KV cache, on ``device`` (default: the card).
    ``speculative_engine`` (needs ``draft=(draft_cfg, draft_params)``)
    makes each engine pass one draft-and-verify iteration;
    ``logit_bias`` is the engine-global bias.  ``admission_max_cost``
    arms overload protection (None: open admission): outstanding token
    cost (prompt + max new tokens) is bounded and excess sheds 503 with
    ``Retry-After``.  /debug/slo holds availability (non-5xx, 504 client
    deadlines excluded) to ``slo_availability_target`` and latency under
    ``slo_latency_threshold`` seconds to ``slo_latency_target``."""
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
    metrics = ServeMetrics()
    # shed 503s burn the availability budget (the server refused work);
    # 504s do not (the client's deadline passed) and are attributed in
    # tpu_serve_shed_total instead
    slo = SloTracker([
        Objective("availability", slo_availability_target,
                  counter_good_total(
                      metrics.requests,
                      is_bad=lambda lv: lv[1].startswith("5")
                      and lv[1] != "504"),
                  description="non-5xx responses over all responses "
                              "(504 client-deadline expiries excluded; "
                              "see tpu_serve_shed_total)"),
        Objective("latency", slo_latency_target,
                  histogram_under(metrics.latency, slo_latency_threshold),
                  description=f"requests faster than "
                              f"{slo_latency_threshold}s"),
    ]).start()
    admission = None
    if admission_max_cost is not None:
        admission = AdmissionController(
            admission_max_cost, burst_fraction=admission_burst_fraction,
            drain_grace_s=drain_grace_s)
    try:
        srv = _Server((host, port), make_handler(
            engine, health, health_stale_after, metrics=metrics, slo=slo,
            admission=admission, default_deadline_s=default_deadline_s))
    except OSError:
        slo.stop()
        engine.shutdown()
        raise
    srv.engine = engine
    srv.metrics = metrics
    srv.slo = slo
    srv.admission = admission

    def drain(timeout: float | None = None) -> bool:
        """Graceful drain: admission closes (typed 503) and /healthz
        goes not-ready at once, in-flight requests run to completion,
        and the call returns True once every admitted request has its
        answer (False past ``timeout``, default the drain grace).  The
        caller then calls ``shutdown()``."""
        budget = drain_grace_s if timeout is None else timeout
        deadline = time.perf_counter() + budget
        if admission is not None:
            admission.begin_drain()
        ok = engine.drain(timeout=max(0.0, deadline - time.perf_counter()))
        if admission is not None:
            # an empty engine is not an answered client: wait for the
            # handler threads to write every admitted response
            ok = admission.wait_idle(
                max(0.0, deadline - time.perf_counter())) and ok
        return ok
    srv.drain = drain
    orig_shutdown = srv.shutdown

    def shutdown():
        orig_shutdown()
        srv.server_close()
        slo.stop()
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
                init_seed: int | None = None, weights: str | None = None,
                device=None) -> dict:
    """Serving weights on ``device`` (default: the card): from an npz
    written by ``tpu_dra_torch.convert.save_npz``, else random from
    ``init_seed``, in the form ``weights`` (one of :data:`WEIGHT_FORMS`;
    None: as stored, i.e. fp32 or the npz's quantized form).  A tree that
    is already quantized is returned as it is, and ``weights``, if
    given, must name its form."""
    if weights is not None and weights not in WEIGHT_FORMS:
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
        if weights not in (None, held):
            raise ValueError(f"--params-npz {params_npz} holds {held} "
                             f"weights but --weights {weights} was asked "
                             f"for")
        return params
    return to_form(params, weights or "fp32")


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


def resolve_auto_draft(cfg: ModelConfig, fp32_params, model_dims: dict,
                       *, form: str = "fp32", cache: str = "",
                       n_layers: int | None = None, steps: int = 200,
                       device=None, error=None) -> tuple:
    """An auto-draft under the weights-cache discipline: restore the
    distilled draft from ``cache`` when populated (a form or model that
    differs from the meta sidecar's is an error, never a stale draft),
    else distill from the fp32 tree and save it there, so distillation
    runs once at deploy.  Prints one line, ``auto-draft: {json}``, with
    the source, the layers and the distillation seconds."""
    import dataclasses

    from tpu_dra_torch.workloads.checkpointing import (
        restore_serving_state, save_serving_state, serving_meta)

    def fail(msg: str):
        if error is not None:
            error(msg)
        raise ValueError(msg)

    def report(source: str, layers: int, secs: float) -> None:
        print("auto-draft: " + json.dumps(
            {"source": source, "layers": layers, "distill_s": secs}),
            flush=True)

    if cache:
        meta = serving_meta(cache)
        try:
            dparams = restore_serving_state(cache, device=device)
        except FileNotFoundError:
            dparams = None
        if dparams is not None:
            if meta is not None:
                if meta.get("form") != form:
                    fail(f"--auto-draft-cache holds form="
                         f"{meta.get('form')!r} but the serving form is "
                         f"{form!r}")
                if meta.get("model") not in (None, model_dims):
                    fail(f"--auto-draft-cache was distilled for "
                         f"{meta.get('model')}, flags describe "
                         f"{model_dims}")
                dlayers = int(meta.get("draft_layers",
                                       max(1, cfg.n_layers // 4)))
            else:
                dlayers = n_layers or max(1, cfg.n_layers // 4)
            report(f"cache {cache}", dlayers, 0.0)
            return dataclasses.replace(cfg, n_layers=dlayers), dparams
    if fp32_params is None:
        fail("--auto-draft needs --checkpoint-dir: distillation runs on "
             "the fp32 tree (a quantized --weights-cache alone cannot be "
             "distilled)")
    t0 = time.perf_counter()
    dcfg, dparams = build_auto_draft(cfg, fp32_params, form=form,
                                     n_layers=n_layers, steps=steps)
    report("distilled", dcfg.n_layers, time.perf_counter() - t0)
    if cache:
        save_serving_state(cache, dparams,
                           meta={"form": form, "model": model_dims,
                                 "draft_layers": dcfg.n_layers,
                                 "distill_steps": steps})
    return dcfg, dparams


def _serving_weights(ap, args, cfg: ModelConfig, model_dims: dict):
    """``(params, fp32_params, form)`` for ``main``: the serving tree
    from a populated ``--weights-cache`` (``fp32_params`` None), else
    from ``--checkpoint-dir``, ``--params-npz`` or ``--init-seed`` in the
    ``--weights`` form, saved into the cache when one is named.  Prints
    one ``serving weights: ...`` line saying which."""
    from tpu_dra_torch.workloads import checkpointing as ck
    dev = args.device
    if args.weights_cache:
        meta = ck.serving_meta(args.weights_cache)
        try:
            params = ck.restore_serving_state(args.weights_cache,
                                              device=dev)
        except FileNotFoundError:
            params = None
        if params is not None:
            form = (meta or {}).get("form")
            if meta is not None:
                # a cache hit must be what the operator asked for: never a
                # silent stale-weights serve
                if args.weights is not None and form != args.weights:
                    ap.error(f"--weights-cache {args.weights_cache} holds "
                             f"form={form!r} but --weights "
                             f"{args.weights!r} was requested; delete the "
                             f"cache or drop --weights")
                if meta.get("model") not in (None, model_dims):
                    ap.error(f"--weights-cache {args.weights_cache} was "
                             f"saved for model {meta.get('model')} but the "
                             f"flags describe {model_dims}")
            form = form or args.weights or serving_form(params) or "fp32"
            print(f"serving weights: restored from the cache "
                  f"{args.weights_cache}, form {form}", flush=True)
            return params, None, form
    sources = [f for f in ("checkpoint_dir", "params_npz") if getattr(
        args, f)] + (["init_seed"] if args.init_seed is not None else [])
    if not sources:
        ap.error("--checkpoint-dir required (no populated --weights-cache "
                 "to restore from; or give --params-npz or --init-seed)")
    if len(sources) > 1:
        ap.error(f"pick one weights source, got {sources}")
    t0 = time.perf_counter()
    if args.checkpoint_dir:
        raw = ck.restore_train_state(args.checkpoint_dir,
                                     device=dev)["params"]
    else:
        raw = load_params(cfg, params_npz=args.params_npz,
                          init_seed=args.init_seed, device=dev)
    held = serving_form(raw)
    if held is not None:
        if args.weights not in (None, held):
            ap.error(f"--params-npz {args.params_npz} holds {held} weights "
                     f"but --weights {args.weights} was asked for")
        params, fp32_params, form = raw, None, held
    else:
        form = args.weights or "fp32"
        params, fp32_params = to_form(raw, form), raw
    print(f"serving weights: {form} from --{sources[0].replace('_', '-')} "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    if args.weights_cache:
        ck.save_serving_state(args.weights_cache, params,
                              meta={"form": form, "model": model_dims})
        print(f"serving weights: cached in {args.weights_cache}",
              flush=True)
    return params, fp32_params, form


def main(argv=None) -> int:
    """Serve the model: ``python -m tpu_dra_torch.workloads.serve
    --continuous --checkpoint-dir ck --weights int8 --weights-cache wc
    --vocab 32768 ...`` (the flags must describe the model the weights
    belong to)."""
    import argparse
    import signal

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--checkpoint-dir", default="",
                    help="a training checkpoint of tpu_dra_torch's fit "
                         "(optional when --weights-cache already holds a "
                         "serving tree)")
    ap.add_argument("--weights-cache", default="",
                    help="serving-tree checkpoint directory: restored "
                         "directly when populated (quantize once at "
                         "deploy, not at every start); populated from "
                         "the weights source and --weights otherwise")
    ap.add_argument("--params-npz", default="",
                    help="weights written by tpu_dra_torch.convert."
                         "save_npz (see README: from a JAX checkpoint)")
    ap.add_argument("--init-seed", type=int, default=None,
                    help="random weights from this seed")
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
    ap.add_argument("--weights", default=None, choices=WEIGHT_FORMS,
                    help="serving weight form (quant.py): fp32 serves the "
                         "weights as loaded; bf16 halves the fp32 weight "
                         "bytes, int8 quarters them, int4 (group-scaled, "
                         "one value per byte) quarters them too.  Default: "
                         "the --weights-cache's recorded form, else fp32.  "
                         "An explicit form that contradicts a populated "
                         "cache, or a quantized npz, is an error")
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
    ap.add_argument("--health-stale-after", type=float, default=600.0,
                    help="seconds without a decode-loop heartbeat before "
                         "/healthz reports 503; must exceed the first "
                         "kernel build")
    ap.add_argument("--slo-latency-threshold", type=float, default=1.0,
                    help="latency SLO threshold in seconds (rounded down "
                         "to a tpu_serve_request_seconds bucket boundary "
                         "for /debug/slo)")
    ap.add_argument("--slo-latency-target", type=float, default=0.99,
                    help="fraction of requests that must beat the "
                         "latency threshold")
    ap.add_argument("--slo-availability-target", type=float,
                    default=0.999,
                    help="fraction of requests that must not 5xx")
    ap.add_argument("--admission-max-cost", type=int, default=None,
                    help="arm overload protection: bound the outstanding "
                         "token cost (prompt + max new tokens of the "
                         "admitted requests); excess sheds 503 with "
                         "Retry-After from the live drain rate.  Unset: "
                         "open admission")
    ap.add_argument("--admission-burst-fraction", type=float, default=0.7,
                    help="share of the admission capacity one tenant may "
                         "hold past its fair share when no other tenant "
                         "wants it")
    ap.add_argument("--default-deadline-ms", type=float, default=None,
                    help="deadline of requests without an X-Deadline-Ms "
                         "header; past it the engine aborts the request "
                         "and frees its slot (504).  Unset: none")
    ap.add_argument("--drain-grace", type=float, default=25.0,
                    help="SIGTERM drain budget in seconds: admission "
                         "closes and /healthz goes not-ready at once, "
                         "in-flight requests get this long to finish; "
                         "keep it below the pod's "
                         "terminationGracePeriodSeconds")
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
                    help="directory caching the distilled draft (the "
                         "weights-cache pattern): restored when populated, "
                         "so distillation runs once at deploy, else "
                         "distilled from the fp32 weights and saved here")
    ap.add_argument("--draft-checkpoint-dir", default="",
                    help="a draft model's training checkpoint, served as "
                         "it is; its dimensions given by --draft-*")
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
    draft_sources = [f for f in ("draft_params_npz", "draft_checkpoint_dir")
                     if getattr(args, f)]
    if args.auto_draft or args.auto_draft_cache:
        draft_sources.append("auto_draft")
    if len(draft_sources) > 1:
        ap.error(f"pick one draft source, got {draft_sources}")
    if args.speculative_continuous != bool(draft_sources):
        ap.error("--speculative-continuous needs a draft (--auto-draft, "
                 "--draft-params-npz or --draft-checkpoint-dir), and a "
                 "draft serves only with --speculative-continuous")
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
    model_dims = {"vocab": args.vocab, "d_model": args.d_model,
                  "n_heads": args.n_heads, "n_kv_heads": args.n_kv_heads,
                  "n_layers": args.n_layers, "d_ff": args.d_ff,
                  "pos_emb": args.pos_emb}
    dcfg = ModelConfig(vocab=args.vocab, d_model=args.draft_d_model,
                       n_heads=args.draft_n_heads,
                       n_kv_heads=args.draft_n_kv_heads,
                       n_layers=args.draft_n_layers, d_ff=args.draft_d_ff,
                       max_seq=args.max_seq, pos_emb=args.pos_emb)
    draft = None
    try:
        params, fp32, form = _serving_weights(ap, args, cfg, model_dims)
        if args.auto_draft or args.auto_draft_cache:
            # distillation runs on the fp32 tree; the draft takes the
            # serving form
            draft = resolve_auto_draft(
                cfg, fp32, model_dims, form=form,
                cache=args.auto_draft_cache,
                n_layers=args.auto_draft_layers,
                steps=args.auto_draft_steps, device=args.device,
                error=ap.error)
        elif args.draft_params_npz:
            draft = (dcfg, load_params(dcfg,
                                       params_npz=args.draft_params_npz,
                                       weights=form, device=args.device))
        elif args.draft_checkpoint_dir:
            from tpu_dra_torch.workloads.checkpointing import (
                restore_train_state)
            draft = (dcfg, restore_train_state(args.draft_checkpoint_dir,
                                               device=args.device)["params"])
        del fp32
    except (ValueError, FileNotFoundError) as exc:
        ap.error(str(exc))
    srv = serve(cfg, params, host=args.host, port=args.port,
                cache_dtype=args.cache_dtype, continuous=True,
                slots=args.slots, chunk=args.chunk,
                kv_layout=args.kv_layout, page_size=args.page_size,
                total_pages=args.total_pages, draft=draft,
                speculative_engine=args.speculative_continuous,
                logit_bias=logit_bias,
                health_stale_after=args.health_stale_after,
                slo_latency_threshold=args.slo_latency_threshold,
                slo_latency_target=args.slo_latency_target,
                slo_availability_target=args.slo_availability_target,
                admission_max_cost=args.admission_max_cost,
                admission_burst_fraction=args.admission_burst_fraction,
                default_deadline_s=(None if args.default_deadline_ms is None
                                    else args.default_deadline_ms / 1e3),
                drain_grace_s=args.drain_grace, device=args.device)
    if args.warmup:
        print(f"warmed {srv.engine.warmup()} prompt buckets", flush=True)
    stop = threading.Event()
    # installed before the ready line: a supervisor that signals as soon
    # as it reads the line must not meet the default handler
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    print(f"serving on {srv.server_address}", flush=True)
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    # the rolling-restart drain: new requests shed 503 and /healthz goes
    # not-ready at once, in-flight ones finish inside the grace
    drained = srv.drain(args.drain_grace)
    print(f"drain before shutdown: complete={drained}", flush=True)
    # linger: a connection that raced into the listen backlog as the
    # drain finished still gets its typed 503 rather than a reset
    time.sleep(min(1.5, max(0.0, args.drain_grace)))
    srv.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
