"""Continuous batching, ported from ``tpu_dra/workloads/continuous.py``
(both KV layouts, plain and speculative).

A fixed pool of ``slots`` sequences decodes together, every slot at its
own position; between chunks of ``chunk`` tokens the batcher thread
admits queued requests into free slots and retires finished ones, so a
short request submitted after a long one finishes first.

KV layouts:

- ``"slab"`` (the default, as in the reference): one ``max_len`` row of a
  slab cache per slot (``decode.init_kv_cache``).  An admission group
  prefills a ``[k, Sb]`` cache of its own and copies it into its slots'
  rows; a step is ``decode._token_logits`` over all slots, whose writes
  past ``max_len`` (finished slots running out a chunk) are dropped.
- ``"paged"``: KV pages from a shared pool (``paged_kv.py``), the decode
  step's attention in the paged-attention kernel.  Admission is
  page-gated and FIFO: the head request waits until the pool has its
  worst-case pages (prompt + steps), and later requests never overtake
  it.  Retirement sentinels the slot's table row before its pages return
  to the pool, so in-flight appends for the slot drop.

Admissions of the same prompt bucket are prefilled together in
power-of-two groups.

Sampling: greedy at temperature 0; above it, a Gumbel-max draw from the
temperature-scaled (and engine-global top-k/top-p filtered) logits, with
the noise drawn from one ``torch.Generator`` per request seeded from its
``seed``.  Outputs are reproducible per (prompt, steps, seed,
temperature), but they are not ``jax.random``'s stream.  An engine-global
``logit_bias`` is added wherever logits are consumed (greedy argmax,
sampling, the speculative p and q).

Speculative mode (``draft=(draft_cfg, draft_params)``): each pass is one
draft-propose / target-verify iteration.  The draft runs ``chunk`` steps
from each slot's committed token (on its own slab, or on its own page
pool under the target's block tables and page ids), the target verifies
``[token, d1 .. d_{chunk-1}]`` in one chunk forward (on pages through
``paged_kv.paged_chunk_logits``), and each slot commits its own count:
greedy requests the longest argmax-matching prefix plus the target's
next token, so their tokens are the plain engine's up to the rounding of
the chunk forward; sampled requests the rejection scheme of
``spec_sample.commit_sampled``, whose draws come from the request's
generator.  A request reserves ``chunk`` positions past its last token
for the pass that overshoots it.

Left for later slices (they raise ``ValueError``; ROADMAP queue 1 item 7
holds prefixes, with the speculative join paths, and stop sequences;
item 8 the KV handoff): shared prefixes, stop sequences and KV handoff.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import torch

from tpu_dra_torch.device import resolve_device
from tpu_dra_torch.workloads.decode import (
    _chunk_logits,
    _filter_topk_topp,
    _prefill_trunk,
    _token_logits,
    gumbel_noise,
    init_kv_cache,
)
from tpu_dra_torch.workloads.paged_kv import (
    PagePool,
    _paged_step,
    init_paged_cache,
    paged_attention,
    paged_chunk_logits,
    prefill_pages_hidden,
)
from tpu_dra_torch.workloads.spec_sample import commit_greedy, commit_sampled
from tpu_dra_torch.workloads.train import ModelConfig, head_logits

_PROMPT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

# the error string a deadline-expired request fails with
DEADLINE_ERROR = "deadline exceeded"

_LATER = ("not ported yet; it comes with a later slice of the PyTorch port "
          "(ROADMAP queue 1 item 7; the KV handoff item 8)")


@dataclass
class _Request:
    prompt: list[int]
    steps: int
    eos_id: Optional[int]
    temperature: float
    seed: int
    # set by cancel(): the batcher retires the slot at the next pass
    # boundary, or drops the request from the queue before admission
    cancelled: bool = False
    # absolute deadline (perf_counter clock): expired queued requests
    # fail without admitting, expired in-flight ones abort at the next
    # pass boundary and free their pages
    deadline: Optional[float] = None
    tokens: list[int] = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    submitted: float = field(default_factory=time.perf_counter)
    admitted_at: float = 0.0
    first_token_at: float = 0.0
    finished: float = 0.0
    error: Optional[str] = None

    @property
    def latency_s(self) -> float:
        return self.finished - self.submitted


def select_tokens(logits, temps, noise, top_k: int = 0,
                  top_p: float = 0.0):
    """Per-row token choice: argmax at temperature 0, else the Gumbel-max
    draw ``argmax(filter(logits / T) + noise)`` — a sample from the
    softmax of the filtered, temperature-scaled logits.  ``noise``
    [B, V] is ignored on greedy rows."""
    greedy = torch.argmax(logits, dim=-1)
    filt = _filter_topk_topp(
        logits / torch.clamp(temps, min=1e-6)[:, None], top_k, top_p)
    sampled = torch.argmax(filt + noise, dim=-1)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)


class ContinuousEngine:
    """Slot-based continuously-batched decoder over one model, with a
    slab or a paged KV cache (``kv_layout``).

    ``submit()`` blocks until the request's tokens are complete;
    concurrent submitters are batched dynamically.  ``slots`` bounds the
    in-flight sequences (excess requests queue FIFO); ``chunk`` is how
    many tokens each pass advances — joins and leaves happen at chunk
    boundaries.  Runs on ``device`` (default: the card; ``RuntimeError``
    without CUDA unless ``device="cpu"``).

    ``draft=(draft_cfg, draft_params)`` makes each pass one speculative
    iteration (module docstring): the draft proposes ``chunk - 1``
    tokens, the target verifies them in one chunk forward, and a slot
    with an agreeing draft commits ``chunk`` tokens for one target pass.
    ``logit_bias`` ``{token id: value}`` is added to the logits in every
    mode (``-1e9`` bans a token)."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 32,
                 max_len: Optional[int] = None, cache_dtype: str = "bf16",
                 chunk: int = 4, top_k: int = 0, top_p: float = 0.0,
                 logit_bias: Optional[dict[int, float]] = None,
                 latency_window: int = 1024, draft=None,
                 kv_layout: str = "slab", page_size: int = 64,
                 total_pages: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if kv_layout not in ("slab", "paged"):
            raise ValueError(f"kv_layout must be 'slab' or 'paged', "
                             f"got {kv_layout!r}")
        if draft is not None:
            if draft[0].vocab != cfg.vocab:
                raise ValueError(f"draft vocab {draft[0].vocab} != target "
                                 f"vocab {cfg.vocab}")
            if chunk < 2:
                raise ValueError("speculative engine needs chunk >= 2 "
                                 "(chunk-1 drafted + 1 bonus per pass)")
        self._bias = None
        if logit_bias:
            bad = [t for t in logit_bias if not 0 <= t < cfg.vocab]
            if bad:
                raise ValueError(f"logit_bias token ids out of "
                                 f"[0, {cfg.vocab}): {bad[:5]}")
            self._bias = torch.zeros(cfg.vocab, dtype=torch.float32,
                                     device=self.device)
            for t, v in logit_bias.items():
                self._bias[t] = v
        self.kv_layout = kv_layout
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.slots = slots
        self.chunk = chunk
        self.max_len = max_len or cfg.max_seq
        if cfg.pos_emb == "learned" and self.max_len > cfg.max_seq:
            raise ValueError(
                f"max_len {self.max_len} exceeds the learned-position "
                f"table (max_seq={cfg.max_seq})")
        self.top_k = top_k
        self.top_p = top_p
        self.cache_dtype = cache_dtype
        dev = self.device
        self.draft = None if draft is None else (
            draft[0], _to_device(draft[1], dev))
        # a speculative pass writes up to `chunk` positions past a slot's
        # committed stream: each request reserves them
        self._slack = chunk if draft is not None else 0
        self.pool: Optional[PagePool] = None
        self._page_ids: list[Optional[list[int]]] = [None] * slots
        if kv_layout == "slab":
            self._cache = init_kv_cache(cfg, slots, self.max_len,
                                        cache_dtype, device=dev)
            if draft is not None:
                self._dcache = init_kv_cache(draft[0], slots, self.max_len,
                                             cache_dtype, device=dev)
        else:
            ps = page_size
            # a power-of-two page and max_len a page multiple keep every
            # clamped prompt bucket's page padding inside max_len
            if ps < 1 or ps & (ps - 1):
                raise ValueError(f"page_size must be a power of two, got "
                                 f"{ps}")
            if ps > self.max_len or self.max_len % ps:
                raise ValueError(
                    f"max_len {self.max_len} must be a multiple of "
                    f"page_size {ps} (and at least one page)")
            self._mp = self.max_len // ps          # pages per slot, max
            cap = total_pages if total_pages is not None \
                else slots * self._mp
            self.pool = PagePool(cap, ps)
            self._cache = init_paged_cache(cfg, cap, ps, cache_dtype,
                                           device=dev)
            if draft is not None:
                # the draft's own pool under the target's block tables:
                # one allocation places both models' KV
                self._dcache = init_paged_cache(draft[0], cap, ps,
                                                cache_dtype, device=dev)
            self._table = torch.full((slots, self._mp), -1,
                                     dtype=torch.int32, device=dev)
        # device state: fixed shapes for the engine's lifetime
        self._token = torch.zeros(slots, dtype=torch.int32, device=dev)
        self._pos = torch.zeros(slots, dtype=torch.int32, device=dev)
        self._temp = torch.zeros(slots, dtype=torch.float32, device=dev)
        self._eos = torch.full((slots,), -1, dtype=torch.int32,
                               device=dev)        # -1: never matches
        self._done = torch.ones(slots, dtype=torch.bool,
                                device=dev)       # free ⇒ done
        # per-request sampling streams, by slot
        self._gens: list[Optional[torch.Generator]] = [None] * slots
        # host state
        self._requests: list[Optional[_Request]] = [None] * slots
        self._emitted: list[int] = [0] * slots
        self._pending: deque[_Request] = deque()
        self._cv = threading.Condition()
        self._stop = False
        self._draining = False
        # decode-loop heartbeat for /healthz; _failed records a batcher
        # death verbatim
        self.last_beat = time.perf_counter()
        self._failed: Optional[str] = None
        self.completed = 0
        self.cancelled = 0
        self.tokens_out = 0
        self.decode_steps = 0             # decode steps (all slots)
        # speculative passes: committed tokens vs live slot-passes, and
        # drafted tokens proposed vs accepted
        self.target_passes = 0
        self.spec_committed = 0
        self.spec_slot_passes = 0
        self.spec_drafted_proposed = 0
        self.spec_drafted_accepted = 0
        self.expired_queued = 0
        self.expired_active = 0
        # slot-seconds by outcome: answers somebody received vs answers
        # nobody waited for
        self.goodput_slot_s = 0.0
        self.badput_slot_s: dict[str, float] = {
            "deadline_expired": 0.0, "cancelled": 0.0}
        self.latencies_s: deque[float] = deque(maxlen=latency_window)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="continuous-batcher")
        self._thread.start()

    # -- public surface ------------------------------------------------------

    def submit(self, prompt: list[int], steps: int,
               eos_id: Optional[int] = None, temperature: float = 0.0,
               seed: int = 0, timeout: Optional[float] = None,
               **later) -> list[int]:
        """Generate ``steps`` tokens after ``prompt`` (stops early at
        ``eos_id``); blocks until complete.  Thread-safe."""
        req = self.submit_async(prompt, steps, eos_id=eos_id,
                                temperature=temperature, seed=seed,
                                **later)
        if not req.done.wait(timeout):
            raise TimeoutError(f"request not done within {timeout}s")
        if req.error:
            raise RuntimeError(req.error)
        return req.tokens

    def submit_async(self, prompt: list[int], steps: int,
                     eos_id: Optional[int] = None,
                     temperature: float = 0.0, seed: int = 0,
                     deadline: Optional[float] = None,
                     prefix_id: Optional[str] = None,
                     stop=None) -> _Request:
        """Enqueue without blocking; the returned request's ``done``
        event fires when ``tokens`` is complete (check ``error`` first).
        ``deadline`` (absolute, ``time.perf_counter`` clock): past it the
        engine stops working on the request and its ``error`` is
        :data:`DEADLINE_ERROR`."""
        cfg = self.cfg
        if prefix_id is not None:
            raise ValueError(f"shared prefixes (prefix_id) are {_LATER}")
        if stop is not None:
            raise ValueError(f"stop sequences are {_LATER}")
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if any(t < 0 or t >= cfg.vocab for t in prompt):
            raise ValueError(f"token ids must be in [0, {cfg.vocab})")
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if eos_id is not None and not 0 <= eos_id < cfg.vocab:
            raise ValueError(f"eos_id must be in [0, {cfg.vocab})")
        if self.pool is not None and self._pages_needed(
                len(prompt), steps) > self.pool.total_pages:
            # an unservable request must fail here: the FIFO gate would
            # otherwise wait on it forever and starve everything behind
            raise ValueError(
                f"request needs {self._pages_needed(len(prompt), steps)} "
                f"KV pages (prompt {len(prompt)} + steps {steps} @ "
                f"page_size {self.pool.page_size}) but the pool only has "
                f"{self.pool.total_pages}")
        slack = self._slack
        if len(prompt) + steps + slack > self.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + steps {steps} "
                f"{f'+ speculative overshoot {slack} ' if slack else ''}"
                f"exceeds the engine's max_len {self.max_len}")
        if len(prompt) > _PROMPT_BUCKETS[-1]:
            raise ValueError(f"prompt exceeds the largest bucket "
                             f"{_PROMPT_BUCKETS[-1]}")
        req = _Request(prompt=list(prompt), steps=steps, eos_id=eos_id,
                       temperature=float(temperature), seed=seed,
                       deadline=deadline)
        with self._cv:
            if self._stop:
                raise RuntimeError("engine is shut down")
            if self._draining:
                raise RuntimeError("engine is draining (rolling "
                                   "restart); retry against the new "
                                   "instance")
            self._pending.append(req)
            self._cv.notify_all()
        return req

    def submit_handoff(self, *_args, **_kwargs):
        raise ValueError(f"KV handoff is {_LATER}")

    def warmup(self, buckets: Optional[list[int]] = None,
               burst: Optional[int] = None) -> int:
        """Run every prompt bucket once before real traffic — a 1-token
        admission, then a ``burst``-wide concurrent one (default
        ``min(slots, 4)``) — so the kernel build and first-use costs
        never land on a client.  Stats reset afterwards.  Returns the
        number of buckets warmed."""
        want = buckets or [b for b in _PROMPT_BUCKETS if b < self.max_len]
        if not buckets and self.max_len > (want[-1] if want else 0):
            want.append(self.max_len)     # the clamped top bucket
        k = min(self.slots, 4) if burst is None else burst
        warmed = 0
        for b in want:
            # steps=2 so the chunk step runs too (a steps=1 request
            # finishes at admission without ever stepping)
            n = min(b, self.max_len - 2 - self._slack)
            if n < 1:
                continue
            if self.pool is not None:
                need = self._pages_needed(n, 2)
                if need > self.pool.total_pages:
                    continue              # bucket unservable at this pool
                if k > 1 and need * k > self.pool.total_pages:
                    k = max(1, self.pool.total_pages // need)
            self.submit([1] * n, 2, timeout=600)
            if k > 1:
                group = [self.submit_async([1] * n, 2) for _ in range(k)]
                for req in group:
                    if not req.done.wait(600):
                        raise TimeoutError(
                            "warmup burst not done within 600s")
                    if req.error:
                        raise RuntimeError(req.error)
            warmed += 1
        self.reset_stats()
        return warmed

    def cancel(self, req: _Request) -> None:
        """Abort a request from ``submit_async``: a queued request never
        admits, an in-flight one retires at the next pass boundary (its
        slot and pages free then).  Its ``done`` fires with ``error ==
        "cancelled"``; finished requests are left untouched."""
        with self._cv:
            if req.done.is_set():
                return
            req.cancelled = True
            self._cv.notify_all()

    def reset_stats(self) -> None:
        """Zero the counters and the latency window."""
        self.completed = 0
        self.cancelled = 0
        self.tokens_out = 0
        self.decode_steps = 0
        self.target_passes = 0
        self.spec_committed = 0
        self.spec_slot_passes = 0
        self.spec_drafted_proposed = 0
        self.spec_drafted_accepted = 0
        self.expired_queued = 0
        self.expired_active = 0
        self.goodput_slot_s = 0.0
        self.badput_slot_s = {"deadline_expired": 0.0, "cancelled": 0.0}
        self.latencies_s.clear()

    def stats(self) -> dict:
        lat = sorted(self.latencies_s)
        out = {"completed": self.completed,
               "cancelled": self.cancelled,
               "tokens_out": self.tokens_out,
               "decode_steps": self.decode_steps,
               "queued": len(self._pending),
               "active": sum(r is not None for r in self._requests),
               "slots": self.slots,
               "draining": self._draining,
               "expired_queued": self.expired_queued,
               "expired_active": self.expired_active,
               "goodput_slot_s": round(self.goodput_slot_s, 4),
               "badput_slot_s": {k: round(v, 4)
                                 for k, v in self.badput_slot_s.items()},
               "kv_layout": self.kv_layout,
               "device": str(self.device),
               # process-wide count of paged-attention kernel launches
               # (stays 0 on the CPU, where the plain version runs)
               "paged_attention_launches": paged_attention.launches}
        if self.draft is not None and self.target_passes:
            # committed tokens per live slot per target pass: 1.0 is the
            # plain engine's, chunk the full-accept ceiling
            out["spec_target_passes"] = self.target_passes
            out["spec_tokens_per_pass"] = round(
                self.spec_committed / max(1, self.spec_slot_passes), 3)
            # the share of drafted tokens the target accepted: whether
            # the draft earns its chunk-1 extra forwards
            out["spec_accept_rate"] = round(
                self.spec_drafted_accepted
                / max(1, self.spec_drafted_proposed), 4)
        if self.pool is not None:
            out["kv_pages_total"] = self.pool.total_pages
            out["kv_pages_free"] = self.pool.free_pages
            out["kv_page_size"] = self.pool.page_size
        if lat:
            out["latency_p50_ms"] = round(1e3 * lat[len(lat) // 2], 3)
            out["latency_p95_ms"] = round(
                1e3 * lat[min(len(lat) - 1, int(0.95 * len(lat)))], 3)
        return out

    def healthy(self, stale_after: float = 120.0) -> tuple[bool, str]:
        """Decode-loop liveness for /healthz: False when the batcher died,
        its thread is gone, or its heartbeat went stale."""
        with self._cv:
            failed, stopped = self._failed, self._stop
        if failed:
            return False, failed
        if stopped or not self._thread.is_alive():
            return False, "engine batcher is not running"
        age = time.perf_counter() - self.last_beat
        if age > stale_after:
            return False, (f"decode loop wedged: no heartbeat for "
                           f"{age:.0f}s (limit {stale_after:.0f}s)")
        return True, "ok"

    @property
    def draining(self) -> bool:
        with self._cv:
            return self._draining

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Reject new submissions, let queued and in-flight requests
        finish, and return True once the engine is empty (False on
        timeout).  The batcher keeps running; ``shutdown()`` stops it."""
        with self._cv:
            self._draining = True
        deadline = None if timeout is None else \
            time.perf_counter() + timeout
        with self._cv:
            while True:
                if not self._pending and all(r is None
                                             for r in self._requests):
                    return True
                remaining = None if deadline is None else \
                    deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(0.02 if remaining is None
                              else min(0.02, remaining))

    def shutdown(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=30)
        for req in list(self._pending) + self._requests:
            if req is not None and not req.done.is_set():
                req.error = "engine shut down"
                req.done.set()

    # -- scheduler -----------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in _PROMPT_BUCKETS:
            if n <= b:
                # never pad past the cache (submit guarantees n + steps
                # <= max_len, so the clamped bucket covers the prompt)
                return min(b, self.max_len)
        raise ValueError(n)

    def _admit(self) -> None:
        """Fill free slots from the FIFO queue (behind the page gate on
        pages), then prefill each prompt bucket's admissions together in
        power-of-two groups."""
        self._expire_queued()
        assigned: list[tuple[int, _Request]] = []
        for slot in range(self.slots):
            if self._requests[slot] is not None:
                continue
            with self._cv:
                # cancelled-while-queued requests drop at the head
                while self._pending and self._pending[0].cancelled:
                    bad = self._pending.popleft()
                    self.cancelled += 1
                    bad.error = "cancelled"
                    bad.done.set()
                if not self._pending:
                    break
                req = self._pending[0]
                # FIFO-preserving page gate: if the head cannot get its
                # worst-case pages, stop admitting — later, smaller
                # requests must not starve it
                if self.pool is not None:
                    need = self._pages_needed(len(req.prompt), req.steps)
                    if need > self.pool.free_pages:
                        break
                self._pending.popleft()
            if self.pool is not None:
                own = self.pool.alloc(need)
                self._page_ids[slot] = own
                self._table[slot] = torch.from_numpy(
                    self.pool.table_row(own, self._mp)).to(self.device)
            # attached before the prefill: if admission raises, the
            # request is visible to _fail_all instead of orphaned
            self._requests[slot] = req
            assigned.append((slot, req))
        groups: dict[int, list[tuple[int, _Request]]] = {}
        for slot, req in assigned:
            groups.setdefault(self._bucket(len(req.prompt)),
                              []).append((slot, req))
        for Sb, group in groups.items():
            while group:
                take = 1 << (len(group).bit_length() - 1)
                self._admit_plain(Sb, group[:take])
                group = group[take:]

    def _expire_queued(self) -> None:
        """Fail every queued request whose deadline has passed (a shed:
        no device time was spent on it)."""
        now = time.perf_counter()
        with self._cv:
            if not any(r.deadline is not None and now > r.deadline
                       and not r.cancelled for r in self._pending):
                return
            keep: deque[_Request] = deque()
            expired = []
            for req in self._pending:
                if req.deadline is not None and now > req.deadline \
                        and not req.cancelled:
                    expired.append(req)
                else:
                    keep.append(req)
            self._pending = keep
        for req in expired:
            self.expired_queued += 1
            req.error = DEADLINE_ERROR
            req.finished = time.perf_counter()
            req.done.set()

    def _pages_needed(self, prompt_len: int, steps: int) -> int:
        """A request's worst-case pages: prompt, steps and the speculative
        overshoot, whose writes must land in real pages."""
        return self.pool.pages_for(prompt_len + steps + self._slack)

    def _release_slot_pages(self, slot: int) -> None:
        """Sentinel the slot's table row, then return its pages."""
        self._table[slot] = -1
        if self._page_ids[slot]:
            self.pool.free(self._page_ids[slot])
        self._page_ids[slot] = None

    def _noise(self, gens: list[Optional[torch.Generator]], V: int):
        """Gumbel noise rows for the sampled slots (zeros elsewhere)."""
        noise = torch.zeros((len(gens), V), dtype=torch.float32,
                            device=self.device)
        for i, g in enumerate(gens):
            if g is not None:
                noise[i] = gumbel_noise(V, g)
        return noise

    def _admit_plain(self, Sb: int,
                     group: list[tuple[int, _Request]]) -> None:
        """One batched prefill for a same-bucket admission group, then
        each request's first token."""
        dev = self.device
        prompts = torch.tensor(
            [req.prompt + [0] * (Sb - len(req.prompt)) for _, req in group],
            dtype=torch.int64, device=dev)                 # [k, Sb]
        lengths = torch.tensor([len(req.prompt) for _, req in group],
                               dtype=torch.int32, device=dev)
        slots = torch.tensor([slot for slot, _ in group], device=dev)
        x = self._prefill(self.cfg, self.params, self._cache, prompts, slots)
        last = x[torch.arange(len(group), device=dev), lengths.long() - 1]
        logits = head_logits(self.params, last[:, None])[:, 0]
        if self.draft is not None:
            self._prefill(*self.draft, self._dcache, prompts, slots)
        gens = []
        for _, req in group:
            g = None
            if req.temperature > 0:
                g = torch.Generator(device=dev)
                g.manual_seed(req.seed)
            gens.append(g)
        temps = torch.tensor([req.temperature for _, req in group],
                             dtype=torch.float32, device=dev)
        first = select_tokens(self._biased(logits), temps,
                              self._noise(gens, self.cfg.vocab), self.top_k,
                              self.top_p)
        # one readback per admission group: the clients need these tokens
        for (slot, req), g, tok in zip(group, gens, first.tolist()):
            self._finish_admission(slot, req, tok, g)

    def _prefill(self, cfg, params, cache, prompts, slots):
        """Prefill ``[k, Sb]`` right-padded prompts of one model into the
        slots' KV and return the trunk activations ``[k, Sb', D]``.  On
        pages: into the slots' pages.  On the slab: into a cache of their
        own, copied into the slots' rows (pad positions land there too,
        masked until decode overwrites them)."""
        if self.pool is not None:
            return prefill_pages_hidden(cfg, params, cache, prompts,
                                        self._table[slots])
        k, Sb = prompts.shape
        small = init_kv_cache(cfg, k, Sb, self.cache_dtype,
                              device=self.device)
        small, x = _prefill_trunk(cfg, params, small, prompts)
        for name, buf in cache.items():
            buf[:, slots, :, :Sb] = small[name]
        return x

    def _finish_admission(self, slot: int, req: _Request, first: int,
                          gen: Optional[torch.Generator]) -> None:
        self._token[slot] = first
        self._pos[slot] = len(req.prompt)
        self._temp[slot] = req.temperature
        self._eos[slot] = -1 if req.eos_id is None else req.eos_id
        self._gens[slot] = gen
        req.admitted_at = req.admitted_at or time.perf_counter()
        req.first_token_at = time.perf_counter()
        req.tokens.append(first)
        self._emitted[slot] = 1
        if (req.eos_id is not None and first == req.eos_id) \
                or req.steps == 1:
            self._retire(slot, req)
            self._requests[slot] = None
        else:
            self._done[slot] = False
            self._requests[slot] = req

    def _retire(self, slot: int, req: _Request) -> None:
        if self._page_ids[slot] is not None:
            # -1 row first: the slot's appends must drop before its pages
            # go back to the pool
            self._release_slot_pages(slot)
        self._gens[slot] = None
        req.finished = time.perf_counter()
        if req.admitted_at:
            self.goodput_slot_s += req.finished - req.admitted_at
        self.completed += 1
        self.tokens_out += len(req.tokens)
        self.latencies_s.append(req.latency_s)
        req.done.set()

    def _abort_slot(self, slot: int, req: _Request, error: str,
                    badput_reason: str) -> None:
        """Cancel/deadline retirement: free the slot and its pages
        without counting a completion; the residency is badput."""
        if self._page_ids[slot] is not None:
            self._release_slot_pages(slot)
        self._gens[slot] = None
        req.error = error
        req.finished = time.perf_counter()
        if req.admitted_at:
            self.badput_slot_s[badput_reason] = (
                self.badput_slot_s.get(badput_reason, 0.0)
                + req.finished - req.admitted_at)
        req.done.set()
        self._requests[slot] = None
        self._done[slot] = True

    def _chunk_step(self):
        """Advance every slot ``chunk`` tokens.  Free and finished slots
        compute too (their writes drop on -1 table rows or past the slab's
        end, their tokens are never emitted); a frozen slot holds its
        token and position.
        Returns the ``[slots, chunk]`` tokens on the host — the loop's one
        designed readback per chunk."""
        cfg = self.cfg
        gens = self._sampling_gens()
        toks = []
        token, pos, done = self._token, self._pos, self._done
        for _ in range(self.chunk):
            if self.pool is not None:
                _, logits, _ = _paged_step(cfg, self.params, self._cache,
                                           token, pos, self._table)
            else:
                logits, _ = _token_logits(cfg, self.params, self._cache, pos,
                                          token)
            self.decode_steps += 1
            if gens is not None:
                noise = self._noise(gens, cfg.vocab)
                nxt = select_tokens(self._biased(logits), self._temp, noise,
                                    self.top_k, self.top_p)
            else:
                nxt = torch.argmax(self._biased(logits),
                                   dim=-1).to(torch.int32)
            nxt = torch.where(done, token, nxt)            # frozen slots hold
            pos = pos + (~done).to(torch.int32)
            done = done | (nxt == self._eos)
            token = nxt
            toks.append(nxt)
        self._token, self._pos, self._done = token, pos, done
        return torch.stack(toks, dim=1).cpu()

    def _sampling_gens(self) -> Optional[list]:
        """The live requests' generators by slot when any of them samples
        (None elsewhere), else None: an all-greedy pass draws nothing."""
        if not any(r is not None and r.temperature > 0
                   for r in self._requests):
            return None
        return [g if r is not None else None
                for g, r in zip(self._gens, self._requests)]

    def _biased(self, logits):
        """The engine-global logit bias, added in fp32 (a -1e9 ban
        survives) wherever logits are consumed."""
        if self._bias is None:
            return logits
        return logits.float() + self._bias

    def _filtered_logits(self, logits, temps):
        """FINAL sampling logits: bias, temperature and the engine-global
        top-k/top-p — the one definition of the sampling distribution,
        which the draft's proposals are drawn from and the rejection
        commit scores both models by."""
        return _filter_topk_topp(
            self._biased(logits) / torch.clamp(temps, min=1e-6)[:, None],
            self.top_k, self.top_p)

    def _draft_propose(self, token, pos, done, gens):
        """``chunk`` draft steps from each slot's committed token, so the
        draft's cache covers every position a pass accepted whole commits
        (the last proposal is discarded).  Greedy rows propose the argmax;
        with ``gens`` (some slot samples) sampled rows draw from the
        draft's :meth:`_filtered_logits`.  Frozen rows hold.  Returns
        ``(drafts [slots, chunk-1], q_filt [slots, chunk-1, V] or
        None)``."""
        dcfg, dparams = self.draft
        k = self.chunk
        tok, proposals, q_filt = token, [], []
        for j in range(k):
            if self.pool is not None:
                _, lg, _ = _paged_step(dcfg, dparams, self._dcache, tok,
                                       pos + j, self._table)
            else:
                lg, _ = _token_logits(dcfg, dparams, self._dcache, pos + j,
                                      tok)
            nxt = torch.argmax(self._biased(lg), dim=-1).to(torch.int32)
            if gens is not None:
                filt = self._filtered_logits(lg, self._temp)
                drawn = torch.argmax(filt + self._noise(gens, dcfg.vocab),
                                     dim=-1).to(torch.int32)
                nxt = torch.where(self._temp > 0, drawn, nxt)
                q_filt.append(filt)
            tok = torch.where(done, tok, nxt)
            proposals.append(tok)
        return (torch.stack(proposals[:k - 1], dim=1),
                None if gens is None else torch.stack(q_filt[:k - 1], dim=1))

    def _spec_commit(self, token, pos, done, drafts, t_lg):
        """The greedy commit, shared by both layouts: the longest draft
        prefix equal to the target's biased argmax, then the target's
        next token."""
        preds = torch.argmax(self._biased(t_lg), dim=-1).to(torch.int32)
        return commit_greedy(token, pos, self._eos, done, drafts, preds)

    def _spec_commit_mixed(self, token, pos, done, drafts, t_lg, q_filt,
                           gens):
        """Each slot's commit by its temperature: greedy slots by
        :meth:`_spec_commit`, sampled slots by the rejection scheme, its
        target distribution from :meth:`_filtered_logits` and its draws
        (k-1 uniforms, Gumbel noise for the resample and the bonus) from
        the request's generator."""
        greedy = self._spec_commit(token, pos, done, drafts, t_lg)
        slots, k, V = t_lg.shape
        t_filt = self._filtered_logits(
            t_lg.reshape(slots * k, V),
            self._temp.repeat_interleave(k)).reshape(slots, k, V)
        uniforms = torch.zeros((slots, k - 1), dtype=torch.float32,
                               device=self.device)
        for i, g in enumerate(gens):
            if g is not None:
                uniforms[i] = torch.rand(k - 1, generator=g, device=g.device)
        sampled = commit_sampled(token, pos, self._eos, done, drafts, t_filt,
                                 q_filt, uniforms, self._noise(gens, V),
                                 self._noise(gens, V))
        pick = self._temp > 0
        return tuple(torch.where(pick.reshape(-1, *[1] * (a.dim() - 1)), a,
                                 b)
                     for a, b in zip(sampled, greedy))

    def _spec_chunk(self):
        """One speculative pass for every slot: the draft proposes, the
        target verifies ``[token, d1 .. d_{chunk-1}]`` in one chunk
        forward (free and frozen slots compute too; their writes drop or
        stay masked), and each slot commits its count (0 when frozen).
        Returns the ``[slots, chunk]`` emitted tokens and the ``[slots]``
        counts on the host: the pass's one designed readback."""
        k = self.chunk
        token, pos, done = self._token, self._pos, self._done
        gens = self._sampling_gens()
        drafts, q_filt = self._draft_propose(token, pos, done, gens)
        chunk = torch.cat([token[:, None], drafts], dim=1)     # [slots, k]
        if self.pool is not None:
            t_lg, _ = paged_chunk_logits(self.cfg, self.params, self._cache,
                                         chunk, pos, self._table)
        else:
            t_lg, _ = _chunk_logits(self.cfg, self.params, self._cache, pos,
                                    chunk)
        if gens is None:
            out = self._spec_commit(token, pos, done, drafts, t_lg)
        else:
            out = self._spec_commit_mixed(token, pos, done, drafts, t_lg,
                                          q_filt, gens)
        self._token, self._pos, self._done, emit, counts = out
        host = torch.cat([emit, counts[:, None]], dim=1).cpu().tolist()
        toks, counts = [r[:k] for r in host], [r[k] for r in host]
        self.target_passes += 1
        live = [c for c, r in zip(counts, self._requests) if r is not None]
        self.spec_committed += sum(live)
        self.spec_slot_passes += len(live)
        # each live slot-pass proposes chunk-1 tokens and accepts count-1
        # of them (the +1 is the target's own token)
        active = [c for c in live if c > 0]
        self.spec_drafted_proposed += (k - 1) * len(active)
        self.spec_drafted_accepted += sum(c - 1 for c in active)
        return toks, counts

    def _fail_all(self, exc: BaseException) -> None:
        """A dead batcher must never strand a waiter: every in-flight and
        pending request gets the error and its done event."""
        msg = f"continuous batcher died: {exc!r}"[:500]
        with self._cv:
            self._stop = True
            self._failed = msg
            victims = [r for r in self._requests if r is not None]
            victims += list(self._pending)
            self._pending.clear()
            self._requests = [None] * self.slots
        for req in victims:
            req.error = msg
            req.done.set()

    def _loop(self) -> None:
        try:
            with torch.no_grad():
                self._loop_inner()
        except BaseException as exc:  # noqa: BLE001 — see _fail_all
            self._fail_all(exc)

    def _loop_inner(self) -> None:
        while True:
            with self._cv:
                while (not self._stop and not self._pending
                       and all(r is None for r in self._requests)):
                    self.last_beat = time.perf_counter()
                    self._cv.wait(timeout=0.5)
                if self._stop:
                    return
            self.last_beat = time.perf_counter()
            self._admit()
            if all(r is None for r in self._requests):
                with self._cv:
                    self._cv.notify_all()     # wake drain() waiters
                continue
            if self.draft is not None:
                toks, counts = self._spec_chunk()
            else:
                toks = self._chunk_step().tolist()
                counts = [self.chunk] * self.slots
            now = time.perf_counter()
            for slot, req in enumerate(self._requests):
                if req is None:
                    continue
                if req.cancelled:
                    # this pass's tokens are dropped — the client is gone
                    self.cancelled += 1
                    self._abort_slot(slot, req, "cancelled", "cancelled")
                    continue
                if req.deadline is not None and now > req.deadline:
                    self.expired_active += 1
                    self._abort_slot(slot, req, DEADLINE_ERROR,
                                     "deadline_expired")
                    continue
                for tok in toks[slot][:counts[slot]]:
                    if self._emitted[slot] >= req.steps:
                        break
                    if not req.first_token_at:
                        req.first_token_at = time.perf_counter()
                    req.tokens.append(tok)
                    self._emitted[slot] += 1
                    if req.eos_id is not None and tok == req.eos_id:
                        break
                hit_eos = (req.eos_id is not None and req.tokens
                           and req.tokens[-1] == req.eos_id)
                if self._emitted[slot] >= req.steps or hit_eos:
                    self._retire(slot, req)
                    self._requests[slot] = None
                    self._done[slot] = True
            with self._cv:
                self._cv.notify_all()         # wake drain() waiters


def _to_device(tree, device):
    """Every tensor leaf of a nested dict moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if torch.is_tensor(tree) else tree
