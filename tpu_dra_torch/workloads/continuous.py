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

Shared prefixes (``register_prefix``): a system prompt's KV is computed
once, on the caller's thread, and every request that names its id
prefills only its suffix, at positions ``[plen, plen + Sb)`` of a scratch
seeded with the prefix KV (``decode._chunk_hidden``).  On the slab the
scratch is copied into the slot's row; on pages the prefix's full pages
are allocated once at registration and shared by every joiner's block
table (``PagePool.ref``), their content written once by the first
joiner on the batcher thread, and only the prefix's tail partial page
and the suffix go to the joiner's own pages.  A speculative join seeds
the draft's cache the same way (``_Prefix.dkv``; on pages under the same
page ids).  Stop sequences are matched on the host after every emitted
token, and the matched sequence is trimmed from the output.

KV handoff (``submit_handoff``, paged plain engines): a prompt's KV
arrives from a prefill-pool engine (``kv_handoff.py``) instead of being
prefilled here; admission scatters its columns into the slot's own pages
(quantized at write on an int8 pool) and selects the first token from
its last-position logits through the same path a local admission takes,
so the request decodes the tokens a local admission would.

Captured programs: where the reference advances a chunk (and a
speculative pass) as one jitted program, the port on the card captures
the greedy chunk and the greedy speculative pass, in both layouts, as a
CUDA graph each (``_GraphedProgram``, in the ``_graphs`` dict keyed on
the kind, layout, slots, chunk and weight form) over the engine's static
tensors: ``_token``, ``_pos``, ``_done``, ``_eos``, ``_table``, the caches,
the bias and the parameters.  A pass is one replay and one readback.
Everything that changes them between passes writes in place; a tensor
that moved (weights replaced instead of copied into) is a recapture,
which the ``retrace_guard`` counts after ``warmup``.  A capture that
fails raises; the card never falls back to the eager loop.  Passes with
a sampled request draw their noise slot by slot from per-request
generators and stay eager, as does everything on the CPU.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Any, Optional

import torch

from tpu_dra_torch.device import resolve_device
from tpu_dra_torch.resilience import failpoint
from tpu_dra_torch.trace import current_context, get_tracer
from tpu_dra_torch.workloads.decode import (
    _chunk_hidden,
    _chunk_logits,
    _filter_topk_topp,
    _prefill_trunk,
    _token_logits,
    gumbel_noise,
    init_kv_cache,
)
from tpu_dra_torch.workloads.kv_handoff import (
    as_cpu_tensor,
    validate_handoff,
)
from tpu_dra_torch.workloads.paged_kv import (
    PagePool,
    _paged_step,
    init_paged_cache,
    paged_attention,
    last_position_logits,
    paged_chunk_logits,
    prefill_pages_hidden,
    scatter_pages_raw,
    scatter_prefill,
)
from tpu_dra_torch.workloads.quant import (
    int8_product,
    is_lora,
    is_quantized,
    is_quantized4,
)
from tpu_dra_torch.workloads.retrace_guard import RetraceGuard
from tpu_dra_torch.workloads.spec_sample import commit_greedy, commit_sampled
from tpu_dra_torch.workloads.train import ModelConfig, head_logits

_PROMPT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def prompt_bucket(n: int, max_len: int) -> int:
    """The width a prompt of ``n`` tokens is prefilled at: the smallest
    bucket that holds it, never past the cache (submit guarantees
    ``n + steps <= max_len``, so the clamped bucket covers the prompt).
    The engine's admissions and ``kv_handoff.PrefillExporter`` both take
    it: a handoff's columns are the bits a local admission writes."""
    for b in _PROMPT_BUCKETS:
        if n <= b:
            return min(b, max_len)
    raise ValueError(f"prompt of {n} tokens exceeds the largest bucket "
                     f"{_PROMPT_BUCKETS[-1]}")


def padded_prompts(prompts: list[list[int]], width: int, device):
    """Prompts right-padded with token 0 to ``width``: ``([k, width]``
    int64 tokens, ``[k]`` int32 lengths``)``."""
    tokens = torch.tensor([p + [0] * (width - len(p)) for p in prompts],
                          dtype=torch.int64, device=device)
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                           device=device)
    return tokens, lengths

# the error string a deadline-expired request fails with
DEADLINE_ERROR = "deadline exceeded"

failpoint.register("serve.engine.slow_decode",
                   "once per batcher pass with live slots: sleep() here "
                   "makes the engine deterministically slow, so overload "
                   "tests saturate at low load")


@dataclass
class _Request:
    prompt: list[int]
    steps: int
    eos_id: Optional[int]
    temperature: float
    seed: int
    prefix_id: Optional[str] = None   # a registered shared prefix
    # stop sequences over the generated tokens: matched on the host after
    # every emitted token, the match trimmed and the request retired
    stop: Optional[list[list[int]]] = None
    # pages: the _Prefix the admission gate priced and took references
    # on; the join refuses any other object under the same id (an
    # evict and re-register in between swaps the registry entry while
    # the slot's table holds the old page ids)
    gate_prefix: Optional["_Prefix"] = None
    # set by cancel(): the batcher retires the slot at the next pass
    # boundary, or drops the request from the queue before admission
    cancelled: bool = False
    # absolute deadline (perf_counter clock): expired queued requests
    # fail without admitting, expired in-flight ones abort at the next
    # pass boundary and free their pages
    deadline: Optional[float] = None
    # the submitter's sampled span context (None when unsampled): the
    # request retires on the batcher thread, long after its span left
    # the contextvar, and its serve.engine.decode span is a child of it
    trace_ctx: Optional[Any] = None
    # a KV handoff (kv_handoff.KVHandoff of CPU tensors): admission
    # imports its pages and first-token logits instead of prefilling
    handoff: Optional[Any] = None
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


@dataclass
class _Prefix:
    """A registered shared prompt prefix: its KV computed once
    (``[L, 1, Hkv, Pb, Dh or 1]`` in the engine's cache dtype, Pb its
    bucket) and seeded into every join's scratch, so a request prefills
    only its suffix."""
    tokens: list[int]
    kv: dict
    length: int
    bucket: int
    # pages: the prefix's full pages (length // page_size of them),
    # shared zero-copy by every joiner's table; their content is written
    # by the first joiner, on the batcher thread.  None: no full page (a
    # short prefix, or the pool was exhausted at registration), and each
    # join carries the whole prefix in its own pages
    pages: Optional[list[int]] = None
    pages_written: bool = False
    # speculative engines: the draft's prefix KV (same bucket), so a
    # join seeds the draft's cache too
    dkv: Optional[dict] = None


# the call counters of the wrappers a captured pass runs: a capture's
# calls are moved from the capture to every replay, so each counter still
# reads the launches (and products) the engine's passes made
_COUNTED = ((paged_attention, "launches"), (int8_product, "calls"))


class _GraphedProgram:
    """One captured program of an engine: a CUDA graph of ``body()``,
    which reads the engine's static tensors, writes its state back into
    them in place and returns the pass's readback tensor (static too).

    :meth:`run` captures on first use and again when the static tensors
    moved (``ptrs`` changed), then replays.  Before a capture ``body``
    runs once eagerly on the capture stream (lazy library and cuBLAS
    set-up must not happen under capture), with ``state`` restored after
    it: the eager pass's cache writes sit at the positions the replay
    writes again before it reads them.  ``_cache_size()`` counts the
    captures, the probe ``retrace_guard`` discovers; ``replays`` counts
    the passes it ran."""

    def __init__(self, device, pool) -> None:
        self._device = device
        self._pool = pool
        self._graph = None
        self._ptrs = None
        self._out = None
        self._stream = None
        self._per_replay = [0] * len(_COUNTED)
        self.captures = 0
        self.replays = 0

    def _cache_size(self) -> int:
        return self.captures

    def run(self, body, ptrs: tuple, state: tuple):
        if self._graph is None or ptrs != self._ptrs:
            self._capture(body, state)
            self._ptrs = ptrs
        self._graph.replay()
        self.replays += 1
        for (fn, attr), n in zip(_COUNTED, self._per_replay):
            setattr(fn, attr, getattr(fn, attr) + n)
        return self._out

    def _capture(self, body, state: tuple) -> None:
        counts = [getattr(fn, attr) for fn, attr in _COUNTED]
        saved = [t.clone() for t in state]
        if self._stream is None:
            self._stream = torch.cuda.Stream(self._device)
        stream, current = self._stream, torch.cuda.current_stream(
            self._device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            body()
        current.wait_stream(stream)
        for t, v in zip(state, saved):
            t.copy_(v)
        before = [getattr(fn, attr) for fn, attr in _COUNTED]
        self._graph = self._out = None
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=stream,
                              capture_error_mode="thread_local"):
            out = body()
        self._per_replay = [getattr(fn, attr) - b for (fn, attr), b
                            in zip(_COUNTED, before)]
        for (fn, attr), n in zip(_COUNTED, counts):
            setattr(fn, attr, n)
        self._graph, self._out = graph, out
        self.captures += 1


def weight_form(params) -> str:
    """The form of a parameter tree's block weights: ``int8``, ``int4``,
    ``lora`` or the dtype of a plain tensor."""
    w = params["blocks"]["wqkv"]
    if is_lora(w):
        return "lora"
    if is_quantized(w):
        return "int8"
    if is_quantized4(w):
        return "int4"
    return str(w.dtype).removeprefix("torch.")


def _tensors(tree):
    """Every tensor leaf of a nested dict (or a tensor), in a fixed
    order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _tensors(tree[key])
    elif torch.is_tensor(tree):
        yield tree


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
    mode (``-1e9`` bans a token).  ``max_prefixes`` bounds the shared
    prefix registry (LRU)."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 32,
                 max_len: Optional[int] = None, cache_dtype: str = "bf16",
                 chunk: int = 4, top_k: int = 0, top_p: float = 0.0,
                 logit_bias: Optional[dict[int, float]] = None,
                 latency_window: int = 1024, max_prefixes: int = 8,
                 draft=None, kv_layout: str = "slab", page_size: int = 64,
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
        # zero-copy prefix pages each slot's table references
        self._shared_ids: list[list[int]] = [[] for _ in range(slots)]
        # the pool is changed by the batcher (admit, retire) and by the
        # caller's thread (register_prefix's allocation and eviction);
        # when both are held, _cv is taken first
        self._pool_mu = threading.Lock()
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
        # held by the batcher over each pass's device work (admission and
        # the chunk, through its readback); paused() takes it
        self._pass_mu = threading.Lock()
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
        # peaks at admission boundaries: live slots, and on pages the
        # pages in use and the slots' own pages at that same moment (in
        # use = own + the registry's resident prefix pages)
        self.peak_active = 0
        self.peak_pages_used = 0
        self.pages_own_at_peak = 0
        # the shared-prefix registry (LRU, content-addressed)
        self.max_prefixes = max_prefixes
        self._prefixes: dict[str, _Prefix] = {}
        # the card's captured passes, by (kind, layout, slots, chunk,
        # weight form), sharing one memory pool
        self._graphs: dict[tuple, _GraphedProgram] = {}
        self._graph_pool = None
        self._capture = self.device.type == "cuda"
        # runtime recapture ratchet (off unless TPU_DRA_RETRACE_GUARD):
        # discovery-based, so the lazily captured programs that land in
        # _graphs are picked up as they appear; warmup() marks, stats()
        # reports the delta
        self.retrace_guard = RetraceGuard()
        self.retrace_guard.attach("engine", self)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="continuous-batcher")
        self._thread.start()

    # -- public surface ------------------------------------------------------

    def submit(self, prompt: list[int], steps: int,
               eos_id: Optional[int] = None, temperature: float = 0.0,
               seed: int = 0, timeout: Optional[float] = None,
               prefix_id: Optional[str] = None,
               stop: Optional[list[list[int]]] = None) -> list[int]:
        """Generate ``steps`` tokens after ``prompt`` (stops early at
        ``eos_id``, or when a ``stop`` sequence completes: the sequence is
        trimmed from the output); blocks until complete.  With
        ``prefix_id`` the context is the registered prefix + ``prompt``,
        and only ``prompt`` is prefilled.  Thread-safe."""
        req = self.submit_async(prompt, steps, eos_id=eos_id,
                                temperature=temperature, seed=seed,
                                prefix_id=prefix_id, stop=stop)
        if not req.done.wait(timeout):
            raise TimeoutError(f"request not done within {timeout}s")
        if req.error:
            raise RuntimeError(req.error)
        return req.tokens

    def submit_async(self, prompt: list[int], steps: int,
                     eos_id: Optional[int] = None,
                     temperature: float = 0.0, seed: int = 0,
                     prefix_id: Optional[str] = None,
                     stop: Optional[list[list[int]]] = None,
                     deadline: Optional[float] = None) -> _Request:
        """Enqueue without blocking; the returned request's ``done``
        event fires when ``tokens`` is complete (check ``error`` first).
        ``deadline`` (absolute, ``time.perf_counter`` clock): past it the
        engine stops working on the request and its ``error`` is
        :data:`DEADLINE_ERROR`.  ``stop``: 1-8 sequences of 1-16 ids."""
        cfg = self.cfg
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if any(t < 0 or t >= cfg.vocab for t in prompt):
            raise ValueError(f"token ids must be in [0, {cfg.vocab})")
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if eos_id is not None and not 0 <= eos_id < cfg.vocab:
            raise ValueError(f"eos_id must be in [0, {cfg.vocab})")
        if self.pool is not None:
            _, need, _ = self._paged_requirements(len(prompt), steps,
                                                  prefix_id)
            if need > self.pool.total_pages:
                # an unservable request must fail here: the FIFO gate
                # would otherwise wait on it forever and starve everything
                # behind it
                raise ValueError(
                    f"request needs {need} KV pages (prompt {len(prompt)} "
                    f"+ steps {steps} @ page_size {self.pool.page_size}) "
                    f"but the pool only has {self.pool.total_pages}")
        plen = 0
        if prefix_id is not None:
            with self._cv:
                pref = self._prefixes.get(prefix_id)
                if pref is None:
                    raise ValueError(f"unknown prefix_id {prefix_id!r} "
                                     f"(evicted or never registered)")
                self._prefixes[prefix_id] = self._prefixes.pop(prefix_id)
            plen = pref.length
        slack = self._slack
        if plen + len(prompt) + steps + slack > self.max_len:
            raise ValueError(
                f"{f'prefix {plen} + ' if plen else ''}prompt {len(prompt)} "
                f"+ steps {steps} "
                f"{f'+ speculative overshoot {slack} ' if slack else ''}"
                f"exceeds the engine's max_len {self.max_len}")
        if len(prompt) > _PROMPT_BUCKETS[-1]:
            raise ValueError(f"prompt exceeds the largest bucket "
                             f"{_PROMPT_BUCKETS[-1]}")
        stop = self._checked_stop(stop)
        req = _Request(prompt=list(prompt), steps=steps, eos_id=eos_id,
                       temperature=float(temperature), seed=seed,
                       prefix_id=prefix_id, stop=stop, deadline=deadline)
        self._enqueue(req)
        return req

    def _checked_stop(self, stop):
        """``stop`` (1-8 sequences of 1-16 ids in the vocabulary) as a
        list of lists; ``ValueError`` otherwise."""
        if stop is None:
            return None
        if not stop or len(stop) > 8:
            raise ValueError("stop must be 1..8 token sequences")
        for seq in stop:
            if not seq or len(seq) > 16:
                raise ValueError("each stop sequence must be 1..16 tokens")
            if any(t < 0 or t >= self.cfg.vocab for t in seq):
                raise ValueError(
                    f"stop token ids must be in [0, {self.cfg.vocab})")
        return [list(seq) for seq in stop]

    def _enqueue(self, req: _Request) -> None:
        """Queue ``req`` under the submitter's sampled span context;
        ``RuntimeError`` once the engine is shut down or draining."""
        ctx = current_context()
        if ctx is not None and ctx.sampled:
            req.trace_ctx = ctx
        with self._cv:
            if self._stop:
                raise RuntimeError("engine is shut down")
            if self._draining:
                raise RuntimeError("engine is draining (rolling "
                                   "restart); retry against the new "
                                   "instance")
            self._pending.append(req)
            self._cv.notify_all()

    def register_prefix(self, tokens: list[int]) -> str:
        """Register a shared prompt prefix (a system prompt); returns its
        content-addressed id (sha256 of the ids, 16 hex digits) for
        ``submit(prefix_id=...)``.  Its KV is computed once, here on the
        caller's thread; on pages its full pages are allocated here too
        (their content is written by the first join, on the batcher
        thread).  Idempotent; LRU-bounded at ``max_prefixes``."""
        cfg = self.cfg
        if not tokens:
            raise ValueError("prefix must be non-empty")
        if any(t < 0 or t >= cfg.vocab for t in tokens):
            raise ValueError(f"token ids must be in [0, {cfg.vocab})")
        if len(tokens) >= self.max_len:
            raise ValueError(f"prefix length {len(tokens)} must leave "
                             f"room under max_len {self.max_len}")
        pid = hashlib.sha256(
            ",".join(map(str, tokens)).encode()).hexdigest()[:16]
        with self._cv:
            if pid in self._prefixes:
                self._prefixes[pid] = self._prefixes.pop(pid)   # LRU
                return pid
        Pb = prompt_bucket(len(tokens), self.max_len)
        prompt, _ = padded_prompts([list(tokens)], Pb, self.device)
        # grad mode is per thread: the batcher's no_grad does not cover
        # the caller's thread
        with torch.no_grad():
            kv = self._prefix_kv(self.cfg, self.params, prompt)
            dkv = (None if self.draft is None
                   else self._prefix_kv(*self.draft, prompt))
        pages = None
        if self.pool is not None:
            # the full pages are shared; a prefix under one page, or a
            # pool without room, gives joins unshared pages (still right)
            full = len(tokens) // self.pool.page_size
            if full:
                with self._pool_mu:
                    if full <= self.pool.free_pages:
                        pages = self.pool.alloc(full)
        with self._cv:
            if pid in self._prefixes:
                # registered concurrently by another caller: give our
                # pages back instead of leaking them
                if pages:
                    with self._pool_mu:
                        self.pool.free(pages)
                self._prefixes[pid] = self._prefixes.pop(pid)
                return pid
            while len(self._prefixes) >= self.max_prefixes:
                self._evict_prefix_pages(
                    self._prefixes.pop(next(iter(self._prefixes))))
            self._prefixes[pid] = _Prefix(list(tokens), kv, len(tokens),
                                          Pb, pages=pages, dkv=dkv)
        return pid

    def _prefix_kv(self, cfg, params, prompt) -> dict:
        """A prefix's KV ``[L, 1, Hkv, Pb, ...]`` in the engine's cache
        dtype (quantized at write for int8), from a ``[1, Pb]``
        right-padded prefill; pad columns stay masked until a join's
        suffix or decode overwrites them."""
        small = init_kv_cache(cfg, 1, prompt.shape[1], self.cache_dtype,
                              device=self.device)
        small, _ = _prefill_trunk(cfg, params, small, prompt)
        return small

    def _evict_prefix_pages(self, pref: _Prefix) -> None:
        """Release the registry's reference on an evicted prefix's pages
        (joiners in flight keep them live by their own references)."""
        if pref.pages:
            with self._pool_mu:
                self.pool.free(pref.pages)
            pref.pages = None

    def submit_handoff(self, handoff, steps: int,
                       eos_id: Optional[int] = None,
                       temperature: float = 0.0, seed: int = 0,
                       stop: Optional[list[list[int]]] = None,
                       deadline: Optional[float] = None) -> _Request:
        """Enqueue a prefill-pool handoff (``kv_handoff.KVHandoff``):
        admission scatters its KV columns into this engine's pages and
        selects the first token from its last-position logits through
        the path a local admission takes, so the request decodes the
        tokens one engine would.  Paged plain engines only: the page
        table is what makes the KV addressable, and a draft's cache would
        hold no context for the imported pages.

        The blob is validated and its arrays converted here, on the
        caller's thread: a malformed one fails this request with
        ``ValueError``, never the batcher (which would fail every request
        of the engine)."""
        if self.kv_layout != "paged":
            raise ValueError("KV handoff needs kv_layout='paged' (the "
                             "page table is what makes a sequence's KV "
                             "addressable for import)")
        if self.draft is not None:
            raise ValueError(
                "speculative engines cannot import a handoff: the "
                "draft model's cache has no context for the imported "
                "pages; serve the decode pool without a draft")
        validate_handoff(handoff, self.cfg, self.pool, self.max_len,
                         steps, eos_id)
        stop = self._checked_stop(stop)
        try:
            handoff = replace(
                handoff, ks=as_cpu_tensor(handoff.ks, torch.bfloat16),
                vs=as_cpu_tensor(handoff.vs, torch.bfloat16),
                last_logits=as_cpu_tensor(handoff.last_logits,
                                          torch.float32))
        except (TypeError, RuntimeError) as exc:
            raise ValueError(f"handoff arrays are not numeric: "
                             f"{exc}") from None
        req = _Request(prompt=list(handoff.prompt), steps=steps,
                       eos_id=eos_id, temperature=float(temperature),
                       seed=seed, stop=stop, deadline=deadline,
                       handoff=handoff)
        self._enqueue(req)
        return req

    def warmup(self, buckets: Optional[list[int]] = None,
               burst: Optional[int] = None) -> int:
        """Run every prompt bucket once before real traffic — a 1-token
        admission, then a ``burst``-wide concurrent one (default
        ``min(slots, 4)``) — so the kernel build, first-use costs and, on
        the card, the capture of the greedy pass never land on a client.
        Stats reset afterwards and the retrace guard marks.  Returns the
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
                _, need, _ = self._paged_requirements(n, 2, None)
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
        # warmup captures are the point of warmup: snapshot the capture
        # counts so any capture AFTER this is a steady-state finding
        self.retrace_guard.mark()
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
        self.peak_active = 0
        self.peak_pages_used = 0
        self.pages_own_at_peak = 0

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
               "peak_active": self.peak_active,
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
        if self.retrace_guard.enabled:
            # the runtime recapture ratchet: nonzero recompiles_since_mark
            # after warmup means a pass was captured again in steady state
            out.update(self.retrace_guard.stats())
        if self.device.type == "cuda":
            # the caching allocator's peak: what a memory budget
            # (launcher.apply_hbm_limits) is held against
            out["max_memory_reserved"] = torch.cuda.max_memory_reserved(
                self.device)
        if self.pool is not None:
            out["kv_pages_total"] = self.pool.total_pages
            out["kv_pages_free"] = self.pool.free_pages
            out["kv_page_size"] = self.pool.page_size
            out["kv_pages_peak_used"] = self.peak_pages_used
            out["kv_pages_own_at_peak"] = self.pages_own_at_peak
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

    @contextlib.contextmanager
    def paused(self):
        """Hold the batcher between two passes: while held no admission
        and no pass runs on the card (the last pass has read back, so
        the engine's work on the card is done).  A device trace starts
        and stops its profiler under it: CUPTI enabling or flushing
        while another thread replays the captured chunk without a pause
        hung the trace's process on the card."""
        with self._pass_mu:
            yield

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
        if not self._thread.is_alive():
            self._graphs.clear()          # their memory pool goes with them

    # -- scheduler -----------------------------------------------------------

    def _admit(self) -> None:
        """Fill free slots from the FIFO queue (behind the page gate on
        pages); prefix joins are admitted one by one, the rest prefilled
        by prompt bucket in power-of-two groups."""
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
                if self.pool is not None:
                    # FIFO-preserving page gate: if the head cannot get
                    # its worst-case own pages, stop admitting — later,
                    # smaller requests must not starve it
                    if req.handoff is not None:
                        # a handoff carries its KV: no prefix shares, own
                        # pages for the imported context and the steps
                        shared, gate_pref = [], None
                        need = self.pool.pages_for(req.handoff.length
                                                   + req.steps)
                    else:
                        shared, need, gate_pref = self._paged_requirements(
                            len(req.prompt), req.steps, req.prefix_id,
                            take_refs=True)
                    # pages resident for prefixes free only by eviction
                    # (the joined prefix's own shared pages among them):
                    # a head that needs more than the rest can never be
                    # admitted, and must fail now rather than stall
                    ceiling = (self.pool.total_pages
                               - self._resident_prefix_pages())
                    if need > ceiling:
                        with self._pool_mu:
                            if shared:
                                self.pool.free(shared)
                        bad = self._pending.popleft()
                        bad.error = (
                            f"request needs {need} own KV pages but "
                            f"resident prefixes leave at most {ceiling} "
                            f"allocatable; evict prefixes or shrink the "
                            f"request")
                        bad.finished = time.perf_counter()
                        bad.done.set()
                        continue
                    with self._pool_mu:
                        own = (self.pool.alloc(need)
                               if need <= self.pool.free_pages else None)
                        if own is None and shared:
                            self.pool.free(shared)  # the gate's refs
                    if own is None:
                        break
                    req.gate_prefix = gate_pref
                self._pending.popleft()
            if self.pool is not None:
                self._page_ids[slot] = own
                self._shared_ids[slot] = list(shared)
                self._table[slot] = torch.from_numpy(self.pool.table_row(
                    shared + own, self._mp)).to(self.device)
            # attached before the prefill: if admission raises, the
            # request is visible to _fail_all instead of orphaned
            self._requests[slot] = req
            assigned.append((slot, req))
        self._note_peaks()
        groups: dict[int, list[tuple[int, _Request]]] = {}
        for slot, req in assigned:
            if req.handoff is not None:
                self._admit_handoff(slot, req)
            elif req.prefix_id is not None:
                self._admit_prefix(slot, req)
            else:
                groups.setdefault(prompt_bucket(len(req.prompt),
                                                self.max_len),
                                  []).append((slot, req))
        for Sb, group in groups.items():
            while group:
                take = 1 << (len(group).bit_length() - 1)
                self._admit_plain(Sb, group[:take])
                group = group[take:]

    def _note_peaks(self) -> None:
        """Record the peak of live slots and, on pages, the peak of pages
        in use with the slots' own pages at that moment."""
        self.peak_active = max(self.peak_active, sum(
            r is not None for r in self._requests))
        if self.pool is not None:
            with self._pool_mu:
                used = self.pool.total_pages - self.pool.free_pages
            if used > self.peak_pages_used:
                self.peak_pages_used = used
                self.pages_own_at_peak = sum(
                    len(p) for p in self._page_ids if p)

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

    def _paged_requirements(self, prompt_len: int, steps: int,
                            prefix_id, *, take_refs: bool = False):
        """(shared prefix pages, own pages needed, prefix snapshot) of
        one request: its worst case (prefix, prompt, steps and the
        speculative overshoot, whose writes must land in real pages)
        less the prefix's shared pages.

        ``take_refs`` (the admission gate) takes the references on the
        shared pages under ``_cv`` together with reading them, so an
        eviction can neither free them first nor hand them out; the
        caller releases them on every path that does not admit.  The
        snapshot pins which registry object the gate priced."""
        shared: list[int] = []
        plen = 0
        pref = None
        with self._cv:
            if prefix_id is not None:
                pref = self._prefixes.get(prefix_id)
                if pref is not None:
                    plen = pref.length
                    shared = list(pref.pages or ())
            if take_refs and shared:
                with self._pool_mu:
                    self.pool.ref(shared)
        need = self.pool.pages_for(plen + prompt_len + steps
                                   + self._slack) - len(shared)
        return shared, need, pref

    def _resident_prefix_pages(self) -> int:
        """Pages the prefix registry keeps resident."""
        with self._cv:
            return sum(len(p.pages or ()) for p in self._prefixes.values())

    def _release_slot_pages(self, slot: int) -> None:
        """Sentinel the slot's table row, then release one reference per
        page: its own pages return to the pool, shared prefix pages only
        when nobody else holds them."""
        self._table[slot] = -1
        with self._pool_mu:
            if self._page_ids[slot]:
                self.pool.free(self._page_ids[slot])
            if self._shared_ids[slot]:
                self.pool.free(self._shared_ids[slot])
        self._page_ids[slot] = None
        self._shared_ids[slot] = []

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
        prompts, lengths = padded_prompts([req.prompt for _, req in group],
                                          Sb, dev)         # [k, Sb]
        slots = torch.tensor([slot for slot, _ in group], device=dev)
        x = self._prefill(self.cfg, self.params, self._cache, prompts, slots)
        logits = last_position_logits(self.params, x, lengths)
        if self.draft is not None:
            self._prefill(*self.draft, self._dcache, prompts, slots)
        reqs = [req for _, req in group]
        firsts, gens = self._first_tokens(logits, reqs)
        for (slot, req), g, tok in zip(group, gens, firsts):
            self._finish_admission(slot, req, tok, g, len(req.prompt))

    def _first_tokens(self, logits, reqs: list[_Request]):
        """Each admitted request's first token from its ``[k, V]``
        logits, greedy or drawn from a generator seeded by the request's
        ``seed`` (which goes on to draw its later tokens): ``(tokens,
        generators)``, one readback for the group."""
        dev = self.device
        gens = []
        for req in reqs:
            g = None
            if req.temperature > 0:
                g = torch.Generator(device=dev)
                g.manual_seed(req.seed)
            gens.append(g)
        temps = torch.tensor([req.temperature for req in reqs],
                             dtype=torch.float32, device=dev)
        first = select_tokens(self._biased(logits), temps,
                              self._noise(gens, self.cfg.vocab), self.top_k,
                              self.top_p)
        return first.tolist(), gens

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

    def _admit_handoff(self, slot: int, req: _Request) -> None:
        """A handoff's admission: its KV columns scattered into the slot's
        pages (quantized at write on an int8 pool; columns past the
        slot's pages drop, as a local prefill's bucket padding does) and
        its first token selected from the blob's logits by
        ``_first_tokens``, as a local admission selects it."""
        h = req.handoff
        dev = self.device
        width = self._mp * self.pool.page_size
        scatter_prefill(self._cache, h.ks[:, :, :, :width].to(dev),
                        h.vs[:, :, :, :width].to(dev),
                        self._table[slot][None])
        (first,), (gen,) = self._first_tokens(
            h.last_logits.to(dev)[None], [req])
        self._finish_admission(slot, req, first, gen, h.length)

    def _admit_prefix(self, slot: int, req: _Request) -> None:
        """A shared-prefix join: the prefix KV seeds a scratch, only the
        suffix runs (at positions ``[plen, plen + Sb)``), and the scratch
        lands in the slot's row (slab) or in the slot's own pages from
        the prefix's tail page on (pages).  A prefix evicted since
        submit fails the request; it never decodes without its
        context."""
        write_pages: Optional[list[int]] = None
        with self._cv:
            pref = self._prefixes.get(req.prefix_id)
            if pref is not None and self.pool is not None:
                if (pref is not req.gate_prefix
                        or list(pref.pages or ()) != self._shared_ids[slot]):
                    # evicted and re-registered since the gate: the new
                    # object's pages are not the ones the slot's table
                    # holds, and a join would write one and read the other
                    pref = None
                elif pref.pages and not pref.pages_written:
                    # claim the one-time content write while _cv pins the
                    # entry; the slot's references keep the ids valid
                    pref.pages_written = True
                    write_pages = list(pref.pages)
        if pref is None:
            if self.pool is not None:
                self._release_slot_pages(slot)     # undo the gate's pages
            self._requests[slot] = None
            req.error = (f"prefix {req.prefix_id!r} evicted before "
                         f"admission; re-register and resubmit")
            req.finished = time.perf_counter()
            req.done.set()
            return
        dev = self.device
        suffix, _ = padded_prompts(
            [req.prompt], prompt_bucket(len(req.prompt), self.max_len), dev)
        if self.pool is None:
            def write(cache, small, width):
                for name, buf in cache.items():
                    buf[:, slot, :, :width] = small[name][:, 0]
        else:
            if write_pages is not None:
                # the first join writes the shared pages' content, here on
                # the batcher thread; pref.kv is already in the cache
                # dtype (an int8 engine registered it quantized), so the
                # columns go in raw with their scales
                rows = torch.tensor([write_pages], dtype=torch.int32,
                                    device=dev)
                cols = len(write_pages) * self.pool.page_size
                scatter_pages_raw(self._cache, {
                    n: b[:, :, :, :cols] for n, b in pref.kv.items()}, rows)
                if self.draft is not None:
                    # both pools share page ids
                    scatter_pages_raw(self._dcache, {
                        n: b[:, :, :, :cols] for n, b in pref.dkv.items()},
                        rows)
            start_page = len(self._shared_ids[slot])
            row = self._table[slot]

            def write(cache, small, width):
                self._scatter_join_cols(cache, small, width, start_page, row)
        x = self._join_cache(self.cfg, self.params, self._cache, pref.kv,
                             suffix, pref.length, write)
        if self.draft is not None:
            self._join_cache(*self.draft, self._dcache, pref.dkv, suffix,
                             pref.length, write)
        last = x[:, len(req.prompt) - 1]
        logits = head_logits(self.params, last[:, None])[:, 0]
        (first,), (gen,) = self._first_tokens(logits, [req])
        self._finish_admission(slot, req, first, gen,
                               pref.length + len(req.prompt))

    def _join_cache(self, cfg, params, cache, pkv, suffix, plen: int,
                    write):
        """One model's half of a join: a scratch of the prefix bucket +
        the suffix bucket (capped at ``max_len``; a short system prompt
        must not pay an O(max_len) copy) seeded with the prefix KV, the
        suffix's chunk forward at positions ``[plen, plen + Sb)``, and
        ``write(cache, scratch, width)`` into the engine's cache.
        Returns the suffix's activations ``[1, Sb, D]``.  Columns past
        the scratch keep the slot's stale rows, masked until decode
        overwrites them."""
        Pb, Sb = pkv["k"].shape[3], suffix.shape[1]
        width = min(Pb + Sb, self.max_len)
        small = init_kv_cache(cfg, 1, width, self.cache_dtype,
                              device=self.device)
        for name, buf in small.items():
            buf[:, :, :, :Pb] = pkv[name]
        x, small = _chunk_hidden(cfg, params, small, plen, suffix)
        write(cache, small, width)
        return x

    def _scatter_join_cols(self, cache, small, width: int, start_page: int,
                           row) -> None:
        """Scatter a join scratch's owned columns — the prefix's tail
        partial page and the suffix, ``[start_page·ps, width)`` — into the
        slot's pages (one implementation for both pools).  Columns
        [0, start_page·ps) are the prefix's full pages: shared, never
        rewritten.  Table entries past the slot's pages are -1 and
        drop."""
        ps = self.pool.page_size
        start_col = start_page * ps
        n_write = -(-(width - start_col) // ps)
        pad = start_col + n_write * ps - width
        cols = {name: torch.nn.functional.pad(
            buf[:, :, :, start_col:width], (0, 0, 0, pad))
            for name, buf in small.items()}
        scatter_pages_raw(cache, cols,
                          row[None, start_page:start_page + n_write])

    def _finish_admission(self, slot: int, req: _Request, first: int,
                          gen: Optional[torch.Generator],
                          start_pos: int) -> None:
        self._token[slot] = first
        self._pos[slot] = start_pos
        self._temp[slot] = req.temperature
        self._eos[slot] = -1 if req.eos_id is None else req.eos_id
        self._gens[slot] = gen
        req.admitted_at = req.admitted_at or time.perf_counter()
        req.first_token_at = time.perf_counter()
        req.tokens.append(first)
        self._emitted[slot] = 1
        hit_stop = bool(req.stop) and first != req.eos_id \
            and self._match_stop(req)
        if (req.eos_id is not None and first == req.eos_id) \
                or req.steps == 1 or hit_stop:
            self._retire(slot, req)
            self._requests[slot] = None
        else:
            self._done[slot] = False
            self._requests[slot] = req

    @staticmethod
    def _match_stop(req: _Request) -> bool:
        """Suffix-match the request's stop sequences against its
        generated tokens; on a match, trim the sequence from the output
        (OpenAI ``stop`` semantics) and return True.  At most 8 × 16
        comparisons a token."""
        toks = req.tokens
        for seq in req.stop:
            n = len(seq)
            if len(toks) >= n and toks[-n:] == seq:
                del toks[-n:]
                return True
        return False

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
        self._export_decode_span(req, "ok")
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
        self._export_decode_span(req, "error")
        req.done.set()
        self._requests[slot] = None
        self._done[slot] = True

    @staticmethod
    def _export_decode_span(req: _Request, status: str) -> None:
        """The slot residency (admission to retirement) as a
        ``serve.engine.decode`` child of the submitter's span, the
        engine-time leg that tells queueing from decoding.  Unsampled or
        never-admitted requests cost one None check."""
        if req.trace_ctx is None or not req.admitted_at:
            return
        dur = req.finished - req.admitted_at
        get_tracer().record_span(
            "serve.engine.decode", req.trace_ctx,
            start=time.time() - dur, duration=dur,
            attributes={"tokens": len(req.tokens), "steps": req.steps},
            status=status)

    def _chunk_step(self):
        """Advance every slot ``chunk`` tokens.  Free and finished slots
        compute too (their writes drop on -1 table rows or past the slab's
        end, their tokens are never emitted); a frozen slot holds its
        token and position.  On the card an all-greedy chunk is one
        replay of its captured program.
        Returns the ``[slots, chunk]`` tokens on the host — the loop's one
        designed readback per chunk."""
        gens = self._sampling_gens()
        if gens is None and self._capture:
            toks = self._graphed("chunk", self._chunk_body)
        else:
            toks = self._chunk_body(gens)
        self.decode_steps += self.chunk
        return toks.cpu()

    def _chunk_body(self, gens: Optional[list] = None):
        """The chunk's device work: ``chunk`` decode steps from the
        engine's state, which it writes back in place; returns the
        ``[slots, chunk]`` int32 tokens.  ``gens``: some slot samples."""
        cfg = self.cfg
        toks = []
        token, pos, done = self._token, self._pos, self._done
        for _ in range(self.chunk):
            if self.pool is not None:
                _, logits, _ = _paged_step(cfg, self.params, self._cache,
                                           token, pos, self._table)
            else:
                logits, _ = _token_logits(cfg, self.params, self._cache, pos,
                                          token)
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
        self._token.copy_(token)
        self._pos.copy_(pos)
        self._done.copy_(done)
        return torch.stack(toks, dim=1)

    def _graphed(self, kind: str, body):
        """Replay the captured ``kind`` pass (capturing it first when it
        is new or its static tensors moved); returns its readback
        tensor."""
        key = (kind, self.kv_layout, self.slots, self.chunk,
               weight_form(self.params))
        prog = self._graphs.get(key)
        if prog is None:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            prog = self._graphs[key] = _GraphedProgram(self.device,
                                                       self._graph_pool)
        return prog.run(body, self._static_ptrs(),
                        (self._token, self._pos, self._done))

    def _static_ptrs(self) -> tuple:
        """The addresses of every tensor a captured pass reads."""
        trees = [self.params, self._cache, self._token, self._pos,
                 self._done, self._eos]
        if self.pool is not None:
            trees.append(self._table)
        if self._bias is not None:
            trees.append(self._bias)
        if self.draft is not None:
            trees += [self.draft[1], self._dcache]
        return tuple(t.data_ptr() for tree in trees for t in _tensors(tree))

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
        stay masked), and each slot commits its count (0 when frozen).  On
        the card an all-greedy pass is one replay of its captured program.
        Returns the ``[slots, chunk]`` emitted tokens and the ``[slots]``
        counts on the host: the pass's one designed readback."""
        k = self.chunk
        gens = self._sampling_gens()
        if gens is None and self._capture:
            packed = self._graphed("spec", self._spec_body)
        else:
            packed = self._spec_body(gens)
        host = packed.cpu().tolist()
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

    def _spec_body(self, gens: Optional[list] = None):
        """The pass's device work from the engine's state, which it
        writes back in place; returns ``[slots, chunk + 1]`` int32: the
        emitted tokens, then each slot's count.  ``gens``: some slot
        samples."""
        token, pos, done = self._token, self._pos, self._done
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
        token2, pos2, done2, emit, counts = out
        self._token.copy_(token2)
        self._pos.copy_(pos2)
        self._done.copy_(done2)
        return torch.cat([emit, counts[:, None]], dim=1)

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
            with self._pass_mu:
                self._admit()
                idle = all(r is None for r in self._requests)
                if not idle:
                    if self.draft is not None:
                        toks, counts = self._spec_chunk()
                    else:
                        toks = self._chunk_step().tolist()
                        counts = [self.chunk] * self.slots
            if idle:
                with self._cv:
                    self._cv.notify_all()     # wake drain() waiters
                continue
            failpoint.hit("serve.engine.slow_decode")
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
                hit_stop = False
                for tok in toks[slot][:counts[slot]]:
                    if self._emitted[slot] >= req.steps:
                        break
                    if not req.first_token_at:
                        req.first_token_at = time.perf_counter()
                    req.tokens.append(tok)
                    self._emitted[slot] += 1
                    if req.eos_id is not None and tok == req.eos_id:
                        break
                    # after every committed token (a speculative pass
                    # commits several): the trim and the retire point
                    # are the plain engine's
                    if req.stop and self._match_stop(req):
                        hit_stop = True
                        break
                hit_eos = (req.eos_id is not None and req.tokens
                           and req.tokens[-1] == req.eos_id)
                if self._emitted[slot] >= req.steps or hit_eos or hit_stop:
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
