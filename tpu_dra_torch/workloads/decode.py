"""Autoregressive decoding over a slab KV cache, ported from
``tpu_dra/workloads/decode.py``.

The cache is one pre-allocated ``[L, B, Hkv, S_max, Dh]`` buffer per k
and v (bf16, or int8 with per-(position, head) fp32 scales ``k_s``/
``v_s``).  Prefill runs the training trunk over the prompt (dense or
flash attention, ``train._ATTN_IMPLS``) and fills the cache; each decode
step attends the whole cache under a position mask.  A ``window`` turns
the cache into a ring of that many slots (sliding-window attention).

Where the reference scans and returns a new cache, the port loops in
Python and writes the cache in place: ``_write_kv``, ``_decode_block``,
``_chunk_hidden`` and the prefills mutate the tensors of the ``cache``
dict and return the same dict.

Out-of-range writes: the reference's scatter drops positions past the
cache (``mode="drop"``), which the slab engine relies on for finished
slots; torch indexing would raise there, and would wrap a negative
position to the end.  ``_write_kv`` masks both explicitly: a position
outside ``[0, S_max)`` writes nothing.

Sampling draws its noise from an explicit ``torch.Generator`` (a
Gumbel-max draw from the filtered, temperature-scaled logits), so a
sampled stream is reproducible per generator seed but is not
``jax.random``'s.  ``speculative_decode`` verifies a draft model's
proposals in one cached chunk forward of the target.  Not ported yet:
``beam_decode`` (it raises).
"""

from __future__ import annotations

import torch

from tpu_dra_torch.device import resolve_device
from tpu_dra_torch.workloads.quant import matmul_any, quantize_kv
from tpu_dra_torch.workloads.spec_sample import commit_greedy, commit_sampled
from tpu_dra_torch.workloads.train import (
    ModelConfig,
    _block,
    _mlp,
    _rmsnorm,
    _split_heads,
    _split_qkv,
    apply_rope,
    attn_impl_fn,
    embed_tokens,
    head_logits,
    layer_params,
    weak_scalar,
)

_LATER = ("not ported yet: it comes with the remaining serving modes of "
          "the PyTorch port (ROADMAP queue 1 item 7)")


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  cache_dtype: str = "bf16", device=None) -> dict:
    """Zeroed cache ``k``/``v`` ``[L, B, Hkv, S_max, Dh]`` on ``device``
    (default: the card).  ``cache_dtype="int8"`` stores int8 k/v with
    per-(position, head) fp32 scales ``k_s``/``v_s`` ``[L, B, Hkv,
    S_max, 1]``."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.kv_heads, max_len, cfg.d_head)
    if cache_dtype == "int8":
        s_shape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_s": torch.zeros(s_shape, dtype=torch.float32, device=dev),
                "v_s": torch.zeros(s_shape, dtype=torch.float32, device=dev)}
    if cache_dtype != "bf16":
        raise ValueError(f"cache_dtype must be bf16 or int8, got "
                         f"{cache_dtype!r}")
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}


def _layer_kv(cfg: ModelConfig, layer, x):
    """k/v heads ``[B, Hkv, S, Dh]`` for a whole ``[B, S, D]`` activation
    block (prefill path).  With rope, keys are stored rotated."""
    h = _rmsnorm(x, layer["ln1"])
    qkv = matmul_any(h, layer["wqkv"], x.dtype)
    _, k, v = _split_qkv(cfg, qkv)
    k = _split_heads(cfg, k, cfg.kv_heads)
    if cfg.pos_emb == "rope":
        k = apply_rope(k, torch.arange(x.shape[1], dtype=torch.int32,
                                       device=x.device), cfg.rope_base)
    return k, _split_heads(cfg, v, cfg.kv_heads)


def _chunk_positions(pos, m: int):
    """``[B, m]`` absolute positions for an m-token chunk starting at
    ``pos`` (``[B]`` tensor, or ``[1]`` for one position shared by the
    batch)."""
    base = pos.to(torch.int32).reshape(-1, 1)
    return base + torch.arange(m, dtype=torch.int32,
                               device=base.device)[None, :]


def _as_pos(pos, device):
    """A start position (int, 0-d or ``[B]`` tensor) as an int32 ``[1]``
    or ``[B]`` tensor on ``device``."""
    return torch.as_tensor(pos, dtype=torch.int32,
                           device=device).reshape(-1)


def _write_kv(cache, new, pos):
    """Write ``new`` ``[B, Hkv, m, Dh]`` into ``cache`` ``[B, Hkv, S_max,
    Dh]`` at positions ``pos .. pos+m-1`` (``pos`` ``[1]`` or ``[B]``),
    in place.  A position outside ``[0, S_max)`` writes nothing: the
    reference drops past-the-end writes, and a negative one must never
    wrap into a live column.  No host sync: each out-of-range entry is
    sent to its row's in-range neighbour with that neighbour's value (or,
    in a row with none, rewrites the old value), so no column gets two
    different values."""
    B, hkv, m, dh = new.shape
    S = cache.shape[2]
    pos = pos.expand(B).long()
    j = torch.arange(m, device=cache.device)
    lo = (-pos).clamp(0, m)                       # first in-range entry
    hi = (S - pos).clamp(0, m)                    # one past the last
    src = torch.clamp(j[None, :], min=lo[:, None],
                      max=(hi - 1)[:, None]).clamp(0, m - 1)     # [B, m]
    dst = (pos[:, None] + src).clamp(0, S - 1)
    rows = torch.arange(B, device=cache.device)[:, None]
    vals = new.gather(2, src[:, None, :, None].expand(B, hkv, m, dh))
    vals = vals.transpose(1, 2).to(cache.dtype)             # [B, m, Hkv, Dh]
    keep = (hi > lo)[:, None, None, None]
    cache[rows, :, dst] = torch.where(keep, vals, cache[rows, :, dst])
    return cache


def _decode_block(cfg: ModelConfig, x, layer, k_cache, v_cache, pos,
                  k_s_cache=None, v_s_cache=None, window: int | None = None):
    """One decoder block for an m-token ``[B, m, D]`` chunk against a
    ``[B, Hkv, S_max, Dh]`` cache: the chunk's k/v are written at
    positions ``pos .. pos+m-1`` (``pos`` ``[1]`` or ``[B]``) in place,
    and the new activations returned.  Chunk token j attends cache
    columns ≤ its own position, so causality within the chunk falls out
    of the mask.

    With an int8 cache (``k_s_cache``/``v_s_cache`` given) the chunk's k/v
    quantize at write time, and the per-position scales stay outside the
    contractions as in the reference: the scores are multiplied by
    ``k_s`` after the QKᵀ product, the fp32 probabilities by ``v_s``
    before their cast to the serving dtype."""
    quantized = k_s_cache is not None
    B, m, _ = x.shape
    if window is not None and m != 1:
        raise ValueError("sliding window is a decode-step (m == 1) "
                         "feature; chunked paths keep the full cache")
    qkv = matmul_any(_rmsnorm(x, layer["ln1"]), layer["wqkv"], x.dtype)
    q, k, v = _split_qkv(cfg, qkv)
    q = _split_heads(cfg, q)                               # [B, H, m, Dh]
    k = _split_heads(cfg, k, cfg.kv_heads)                 # [B, Hkv, m, Dh]
    v = _split_heads(cfg, v, cfg.kv_heads)
    positions = _chunk_positions(pos, m)                   # [B|1, m]
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_base)
        k = apply_rope(k, positions, cfg.rope_base)        # cached rotated

    # under a window the slot is pos mod W; rope and the mask keep the
    # absolute position (rope is relative, so wrapped slots stay exact)
    wpos = pos if window is None else torch.remainder(pos, window)
    if quantized:
        k_q, k_s = quantize_kv(k)
        v_q, v_s = quantize_kv(v)
        _write_kv(k_cache, k_q, wpos)
        _write_kv(v_cache, v_q, wpos)
        _write_kv(k_s_cache, k_s, wpos)
        _write_kv(v_s_cache, v_s, wpos)
        k_read, v_read = k_cache.to(x.dtype), v_cache.to(x.dtype)
    else:
        _write_kv(k_cache, k, wpos)
        _write_kv(v_cache, v, wpos)
        k_read, v_read = k_cache, v_cache

    hkv, g = cfg.kv_heads, cfg.n_heads // cfg.kv_heads
    qg = q.reshape(B, hkv, g, m, cfg.d_head)
    scores = torch.einsum("bkgmd,bksd->bkgms", qg, k_read) * \
        weak_scalar(cfg.d_head ** -0.5, qg.dtype)
    if quantized:
        scores = scores * k_s_cache[..., 0][:, :, None, None, :].to(
            scores.dtype)
    col = torch.arange(k_cache.shape[2], device=x.device)
    pb = positions[:, :, None]                             # [B|1, m, 1]
    if window is None:
        valid = col[None, None, :] <= pb                   # [B|1, m, S]
    else:
        # slot c holds the latest absolute position ≤ pos congruent to c
        # (mod W); a negative one was never written and stays masked
        valid = pb - torch.remainder(pb - col[None, None, :], window) >= 0
    scores = scores.masked_fill(~valid[:, None, None],
                                torch.finfo(scores.dtype).min)
    attn = torch.softmax(scores.float(), dim=-1)
    if quantized:
        attn = attn * v_s_cache[..., 0][:, :, None, None, :]
    attn = attn.to(q.dtype)
    out = torch.einsum("bkgms,bksd->bkgmd", attn, v_read)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, m, cfg.n_heads * cfg.d_head)
    x = x + matmul_any(out, layer["wo"], x.dtype)
    return _mlp(x, layer)


def _chunk_hidden(cfg: ModelConfig, params, cache, pos, tokens,
                  window: int | None = None):
    """Cached trunk forward over an m-token chunk: ``tokens`` ``[B, m]``
    at positions ``pos .. pos+m-1`` (int, or ``[B]``) → (``[B, m, D]``
    final activations, the cache written in place)."""
    m = tokens.shape[1]
    pos = _as_pos(pos, tokens.device)
    x = embed_tokens(cfg, params, tokens, _chunk_positions(pos, m))
    quantized = "k_s" in cache
    for i in range(cfg.n_layers):
        scales = ({"k_s_cache": cache["k_s"][i], "v_s_cache": cache["v_s"][i]}
                  if quantized else {})
        x = _decode_block(cfg, x, layer_params(params["blocks"], i),
                          cache["k"][i], cache["v"][i], pos, window=window,
                          **scales)
    return x, cache


def _chunk_logits(cfg: ModelConfig, params, cache, pos, tokens,
                  window: int | None = None):
    """Cached forward over an m-token chunk → (``[B, m, vocab]`` fp32
    logits, cache)."""
    x, cache = _chunk_hidden(cfg, params, cache, pos, tokens, window=window)
    return head_logits(params, x), cache


def _token_logits(cfg: ModelConfig, params, cache, pos, token,
                  window: int | None = None):
    """One decode step: ``[B]`` token ids at position ``pos`` (int, or
    ``[B]``) → (``[B, vocab]`` logits, cache)."""
    logits, cache = _chunk_logits(cfg, params, cache, pos, token[:, None],
                                  window=window)
    return logits[:, 0], cache


def _prefill_trunk(cfg: ModelConfig, params, cache, prompt,
                   attn_impl: str = "dense", window: int | None = None):
    """Run ``[B, S]`` through the training trunk and fill the cache for
    positions ``[0, S)``: (cache, trunk activations ``[B, S, D]``).
    Attention runs through ``attn_impl`` (``"flash"``: the flash
    kernels on the card).  Under a ``window`` the last ``min(S, W)``
    positions land in their ring slots (pos mod W); prefill attention
    itself stays full-causal over the prompt."""
    attn_fn = attn_impl_fn(attn_impl)
    S = prompt.shape[1]
    keep = S if window is None else min(S, window)
    # contiguous from 0, or the ring slots of the last min(S, W) positions
    slots = slice(0, S) if window is None else \
        torch.arange(S - keep, S, device=prompt.device) % window
    quantized = "k_s" in cache
    x = embed_tokens(cfg, params, prompt)
    for i in range(cfg.n_layers):
        layer = layer_params(params["blocks"], i)
        k, v = _layer_kv(cfg, layer, x)
        k, v = k[:, :, S - keep:], v[:, :, S - keep:]
        if quantized:
            (k, k_s), (v, v_s) = quantize_kv(k), quantize_kv(v)
            cache["k_s"][i][:, :, slots] = k_s
            cache["v_s"][i][:, :, slots] = v_s
        cache["k"][i][:, :, slots] = k.to(cache["k"].dtype)
        cache["v"][i][:, :, slots] = v.to(cache["v"].dtype)
        x = _block(cfg, x, layer, attn_fn)
    return cache, x


def prefill(cfg: ModelConfig, params, cache, prompt,
            attn_impl: str = "dense", window: int | None = None):
    """Prefill for equal-length prompts: (cache, last-token logits)."""
    cache, x = _prefill_trunk(cfg, params, cache, prompt, attn_impl,
                              window=window)
    return cache, head_logits(params, x[:, -1:])[:, 0]


def prefill_chunked(cfg: ModelConfig, params, cache, prompt,
                    chunk: int = 256):
    """Prefill in ``chunk``-token pieces through the cached decode path
    (attention memory O(B·chunk·S_max) instead of O(B·S²)); a remainder
    runs as one final partial chunk and the vocab head runs once, on the
    last token.  Equal to :func:`prefill` up to float reduction order
    with a bf16 cache; with an int8 cache the chunk's own attention reads
    its quantized k/v.  Returns (cache, last-token logits)."""
    B, S = prompt.shape
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    cap = cache["k"].shape[3]
    if S > cap:
        raise ValueError(f"prompt length {S} exceeds cache capacity {cap}")
    for start in range(0, S, chunk):
        x, cache = _chunk_hidden(cfg, params, cache, start,
                                 prompt[:, start:start + chunk])
    return cache, head_logits(params, x[:, -1:])[:, 0]


def prefill_ragged(cfg: ModelConfig, params, cache, prompts, lengths,
                   attn_impl: str = "dense"):
    """Prefill right-padded ``[B, S_pad]`` prompts with true ``lengths``
    ``[B]``: (cache, logits at each sequence's own last real token).  Pad
    positions' k/v land in the cache but stay masked until decode
    overwrites them."""
    cache, x = _prefill_trunk(cfg, params, cache, prompts, attn_impl)
    B = prompts.shape[0]
    last = x[torch.arange(B, device=x.device), lengths.long() - 1]
    return cache, head_logits(params, last[:, None])[:, 0]


def _filter_topk_topp(logits, top_k: int, top_p: float):
    """Mask ``[B, V]`` logits to the top-k / nucleus sets (no-op when both
    are off).  One descending sort serves both filters, and masking by
    rank keeps exactly the contract sets even when logits tie at the
    cutoff."""
    if not top_k and top_p <= 0.0:
        return logits
    sorted_logits, order = torch.sort(logits, dim=-1, descending=True,
                                      stable=True)
    V = logits.shape[-1]
    keep_sorted = torch.ones_like(sorted_logits, dtype=torch.bool)
    if top_k:
        keep_sorted &= torch.arange(V, device=logits.device)[None, :] \
            < top_k
    if top_p > 0.0:
        # nucleus: smallest prefix whose mass reaches top_p (the top
        # token's mass_before is 0 < top_p, so it always survives)
        probs = torch.softmax(sorted_logits.float(), dim=-1)
        mass_before = torch.cumsum(probs, dim=-1) - probs
        keep_sorted &= mass_before < top_p
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return logits.masked_fill(~keep, torch.finfo(logits.dtype).min)


def gumbel_noise(n: int, generator: torch.Generator) -> torch.Tensor:
    """``n`` standard Gumbel draws from ``generator`` (on its device)."""
    u = torch.rand(n, generator=generator, device=generator.device)
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def _select_token(logits, generator, temperature: float, top_k: int,
                  top_p: float = 0.0):
    """Greedy (``temperature == 0``) or a draw from the temperature-scaled,
    top-k/top-p filtered ``[B, V]`` logits: the Gumbel-max draw
    ``argmax(filtered + noise)`` with the noise from ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    filt = _filter_topk_topp(logits / temperature, top_k, top_p)
    noise = gumbel_noise(filt.numel(), generator).reshape(filt.shape)
    return torch.argmax(filt + noise, dim=-1).to(torch.int32)


@torch.no_grad()
def decode(cfg: ModelConfig, params, prompt, *, steps: int,
           lengths=None, max_len: int | None = None,
           attn_impl: str = "dense", temperature: float = 0.0,
           top_k: int = 0, top_p: float = 0.0, generator=None,
           cache_dtype: str = "bf16", window: int | None = None,
           eos_id: int | None = None, repetition_penalty: float = 1.0):
    """Decode ``steps`` tokens after a ``[B, S]`` prompt on the prompt's
    device — greedy by default, temperature/top-k/top-p sampling with
    noise from ``generator`` (default: one seeded 0) when ``temperature >
    0``.  Returns ``[B, steps]`` int32 tokens.

    ``lengths`` (``[B]``) makes the batch ragged: ``prompt`` is
    right-padded and every sequence advances from its own length.
    ``window``: sliding-window attention over a ring cache of that many
    slots (rope only, full batches only).  ``eos_id``: a sequence
    freezes once it emits it (every later slot holds eos_id).
    ``repetition_penalty`` > 1 divides the positive logits of every token
    already seen (prompt included) and multiplies the negative ones."""
    B, S = prompt.shape
    dev = prompt.device
    if repetition_penalty <= 0:
        raise ValueError(
            f"repetition_penalty must be > 0, got {repetition_penalty} "
            f"(a negative value would BOOST seen tokens)")
    if eos_id is not None and not 0 <= eos_id < cfg.vocab:
        raise ValueError(f"eos_id {eos_id} outside [0, {cfg.vocab})")
    if window is not None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if cfg.pos_emb != "rope":
            raise ValueError("sliding-window decode needs pos_emb='rope' "
                             "(learned tables cannot express unbounded "
                             "positions)")
        if lengths is not None:
            raise ValueError("sliding-window decode does not support "
                             "ragged batches (pad slots could alias live "
                             "ring slots)")
        if max_len is not None and max_len != window:
            raise ValueError(
                f"window={window} fixes the cache at window slots; "
                f"drop max_len (got {max_len}) or make them equal")
        max_len = window
    else:
        max_len = max_len or cfg.max_seq
        if S + steps > max_len:
            raise ValueError(f"S + steps = {S + steps} exceeds max_len "
                             f"{max_len}")
    if cfg.pos_emb == "learned" and S + steps > cfg.max_seq:
        raise ValueError(
            f"S + steps = {S + steps} exceeds the learned-position table "
            f"(max_seq={cfg.max_seq}); grow max_seq or use rope")
    if lengths is not None:
        lengths = torch.as_tensor(lengths).to(device=dev, dtype=torch.int32)
        if bool((lengths < 1).any()) or bool((lengths > S).any()):
            raise ValueError(f"lengths must lie in [1, {S}], got "
                             f"{lengths.tolist()}")
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    cache = init_kv_cache(cfg, B, max_len, cache_dtype, device=dev)
    if lengths is None:
        cache, logits = prefill(cfg, params, cache, prompt, attn_impl,
                                window=window)
    else:
        cache, logits = prefill_ragged(cfg, params, cache, prompt, lengths,
                                       attn_impl)
    penalize = repetition_penalty != 1.0
    rows = torch.arange(B, device=dev)
    if penalize:
        # [B, vocab] presence of every token seen so far, prompt included
        # (ragged: pads go to a spare column that is cut off)
        cols = prompt.long()
        if lengths is not None:
            real = torch.arange(S, device=dev)[None, :] < lengths[:, None]
            cols = torch.where(real, cols, cfg.vocab)
        seen = torch.zeros((B, cfg.vocab + 1), dtype=torch.bool, device=dev)
        seen = seen.scatter_(1, cols, True)[:, :cfg.vocab]

    def shape_logits(logits):
        if not penalize:
            return logits
        pen = torch.where(logits > 0, logits / repetition_penalty,
                          logits * repetition_penalty)
        return torch.where(seen, pen, logits)

    token = _select_token(shape_logits(logits), generator, temperature,
                          top_k, top_p)
    done = (torch.zeros((B,), dtype=torch.bool, device=dev)
            if eos_id is None else token == eos_id)
    if penalize:
        seen[rows, token.long()] = True
    out = [token]
    for i in range(steps - 1):
        pos = S + i if lengths is None else lengths + i
        logits, cache = _token_logits(cfg, params, cache, pos, token,
                                      window=window)
        nxt = _select_token(shape_logits(logits), generator, temperature,
                            top_k, top_p)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        if penalize:
            seen[rows, nxt.long()] = True
        token = nxt
        out.append(token)
    return torch.stack(out, dim=1)


def greedy_decode(cfg: ModelConfig, params, prompt, *, steps: int,
                  max_len: int | None = None, attn_impl: str = "dense",
                  cache_dtype: str = "bf16", window: int | None = None):
    """Greedy-decode ``steps`` tokens after a ``[B, S]`` prompt."""
    return decode(cfg, params, prompt, steps=steps, max_len=max_len,
                  attn_impl=attn_impl, cache_dtype=cache_dtype,
                  window=window)


def decode_ragged(cfg: ModelConfig, params, prompts, lengths, *, steps: int,
                  max_len: int | None = None, attn_impl: str = "dense",
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 0.0, generator=None,
                  cache_dtype: str = "bf16", eos_id: int | None = None,
                  repetition_penalty: float = 1.0):
    """Batched decode over right-padded ``[B, S_pad]`` prompts with true
    ``lengths`` ``[B]`` in ``[1, S_pad]``: every sequence advances from
    its own position.  Returns ``[B, steps]`` tokens."""
    return decode(cfg, params, prompts, steps=steps, lengths=lengths,
                  max_len=max_len, attn_impl=attn_impl,
                  temperature=temperature, top_k=top_k, top_p=top_p,
                  generator=generator, cache_dtype=cache_dtype,
                  eos_id=eos_id, repetition_penalty=repetition_penalty)


def _snapshot_rows(caches: list, rows) -> list:
    """Copies of batch rows ``rows`` of every leaf of each cache (int8
    scale buffers included)."""
    return [{name: buf[:, rows].clone() for name, buf in c.items()}
            for c in caches]


def _restore_rows(caches: list, rows, saved: list) -> None:
    for c, s in zip(caches, saved):
        for name, buf in c.items():
            buf[:, rows] = s[name]


@torch.no_grad()
def speculative_decode(cfg: ModelConfig, params, draft_cfg: ModelConfig,
                       draft_params, prompt, *, steps: int, k: int = 4,
                       max_len: int | None = None,
                       attn_impl: str = "dense",
                       return_stats: bool = False,
                       cache_dtype: str = "bf16",
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 0.0, generator=None):
    """Speculative decoding: the draft model proposes ``k-1`` tokens one
    step at a time, the target verifies them in ONE cached ``k``-token
    chunk forward, and up to ``k`` tokens commit per target pass.

    ``temperature == 0``: greedy acceptance (the longest prefix of
    proposals equal to the target's argmax, then the target's own next
    token), so the output is ``greedy_decode(target)`` for any draft, up
    to the rounding of the chunk forward.  ``temperature > 0`` (needs
    ``generator``): proposals are drawn from the draft's filtered,
    temperature-scaled distribution and committed by the rejection
    scheme (``spec_sample.commit_sampled``), so the stream is distributed
    as target-only sampling.  A row that has its tokens is frozen: its
    caches (every leaf, int8 scales included) keep their state.  Rejected
    proposals leave stale cache entries past the committed position,
    masked until overwritten.

    Both models must share the vocab.  Returns ``[B, steps]`` int32
    tokens, and ``{"target_passes": n}`` too with ``return_stats``."""
    if k < 2:
        raise ValueError(f"k must be >= 2 (k-1 drafted tokens and one "
                         f"bonus per pass), got {k}")
    if cfg.vocab != draft_cfg.vocab:
        raise ValueError(f"draft vocab {draft_cfg.vocab} != target vocab "
                         f"{cfg.vocab}")
    sampling = temperature > 0
    if sampling and generator is None:
        raise ValueError("temperature > 0 needs a generator")
    B, S = prompt.shape
    dev = prompt.device
    max_len = max_len or cfg.max_seq
    # every pass commits >= 1 token and writes <= k cache positions past
    # the committed stream; frozen rows stop advancing
    if S + steps + k > max_len:
        raise ValueError(f"S + steps + k = {S + steps + k} exceeds max_len "
                         f"{max_len}")
    if cfg.pos_emb == "learned" and S + steps + k > cfg.max_seq:
        raise ValueError(
            f"S + steps + k = {S + steps + k} exceeds the learned-position "
            f"table (max_seq={cfg.max_seq}); grow max_seq or use rope")
    t_cache = init_kv_cache(cfg, B, max_len, cache_dtype, device=dev)
    t_cache, t_logits = prefill(cfg, params, t_cache, prompt, attn_impl)
    d_cache = init_kv_cache(draft_cfg, B, max_len, cache_dtype, device=dev)
    d_cache, _ = _prefill_trunk(draft_cfg, draft_params, d_cache, prompt,
                                attn_impl)

    def draw(logits):
        """A draw from the filtered, temperature-scaled logits, and those
        logits (the distribution the commit scores it against)."""
        filt = _filter_topk_topp(logits / temperature, top_k, top_p)
        noise = gumbel_noise(filt.numel(), generator).reshape(filt.shape)
        return torch.argmax(filt + noise, dim=-1).to(torch.int32), filt

    last = (draw(t_logits)[0] if sampling
            else torch.argmax(t_logits, dim=-1).to(torch.int32))
    width = steps + k                            # room for the overshoot
    out = torch.zeros((B, width + 1), dtype=torch.int32, device=dev)
    out[:, 0] = last                             # column `width`: dropped
    count = torch.ones(B, dtype=torch.int32, device=dev)
    pos = torch.full((B,), S, dtype=torch.int32, device=dev)
    no_eos = torch.full((B,), -1, dtype=torch.int32, device=dev)
    j = torch.arange(k, device=dev)[None, :]
    rows = torch.arange(B, device=dev)[:, None]
    caches = [t_cache, d_cache]
    passes = 0
    # steps - 1 passes at worst: count starts at 1, each pass commits >= 1
    while passes < steps:
        done_host = [c >= steps for c in count.tolist()]
        if all(done_host):
            break
        done = torch.tensor(done_host, device=dev)
        frozen = torch.nonzero(done)[:, 0]
        saved = _snapshot_rows(caches, frozen) if len(frozen) else None

        # 1. the draft runs k steps from `last` (its cache then covers
        #    every position a pass accepted whole commits); the k-th
        #    proposal is discarded
        tok, proposals, q_filt = last, [], []
        for i in range(k):
            lg, d_cache = _token_logits(draft_cfg, draft_params, d_cache,
                                        pos + i, tok)
            if sampling:
                tok, filt = draw(lg)
                q_filt.append(filt)
            else:
                tok = torch.argmax(lg, dim=-1).to(torch.int32)
            proposals.append(tok)
        drafts = torch.stack(proposals[:k - 1], dim=1)        # [B, k-1]

        # 2. the target verifies [last, d1 .. d_{k-1}] in one chunk
        chunk = torch.cat([last[:, None], drafts], dim=1)     # [B, k]
        t_lg, t_cache = _chunk_logits(cfg, params, t_cache, pos, chunk)

        # 3. commit
        if sampling:
            V = t_lg.shape[-1]
            t_filt = _filter_topk_topp(
                (t_lg / temperature).reshape(B * k, V), top_k,
                top_p).reshape(t_lg.shape)
            uniforms = torch.rand((B, k - 1), generator=generator,
                                  device=generator.device).to(dev)
            g_res = gumbel_noise(B * V, generator).reshape(B, V).to(dev)
            g_bonus = gumbel_noise(B * V, generator).reshape(B, V).to(dev)
            last2, _, _, emit, counts = commit_sampled(
                last, pos, no_eos, done, drafts, t_filt,
                torch.stack(q_filt[:k - 1], dim=1), uniforms, g_res,
                g_bonus)
        else:
            last2, _, _, emit, counts = commit_greedy(
                last, pos, no_eos, done, drafts,
                torch.argmax(t_lg, dim=-1).to(torch.int32))
        n = torch.clamp(counts - 1, min=0)

        # 4. write d1..dn and the final token; frozen rows write nothing
        dest = torch.where((j <= n[:, None]) & ~done[:, None],
                           count[:, None] + j, width)
        out[rows, dest.long()] = emit.to(torch.int32)
        if saved is not None:
            _restore_rows(caches, frozen, saved)
        adv = (n + 1).to(torch.int32)
        pos = torch.where(done, pos, pos + adv)
        count = torch.where(done, count, count + adv)
        last = last2
        passes += 1
    toks = out[:, :steps]
    if return_stats:
        # passes == target verify passes: the speedup observable
        return toks, {"target_passes": passes}
    return toks


def beam_decode(*_args, **_kwargs):
    """Beam search (reference ``decode.beam_decode``)."""
    raise NotImplementedError(f"beam_decode is {_LATER}")


def make_decoder(cfg: ModelConfig, *, steps: int, max_len: int | None = None,
                 attn_impl: str = "dense", temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0,
                 cache_dtype: str = "bf16", window: int | None = None,
                 device=None):
    """``(params, prompt [B, S][, generator]) -> tokens [B, steps]`` on
    ``device`` (default: the card); the prompt is moved there, the
    params must already live there.  A plain closure over
    :func:`decode` (the reference jit-compiles it)."""
    dev = resolve_device(device)

    def run(params, prompt, generator=None):
        return decode(cfg, params, torch.as_tensor(prompt).to(dev),
                      steps=steps, max_len=max_len, attn_impl=attn_impl,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      generator=generator, cache_dtype=cache_dtype,
                      window=window)
    return run
