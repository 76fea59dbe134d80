"""Paged KV cache and paged decode attention, ported from
``tpu_dra/workloads/paged_kv.py``.

Layouts match the reference:

- one page pool per layer, ``[L, Hkv, P, ps, Dh]`` bf16 (or int8 with
  per-(position, head) fp32 scales ``k_s``/``v_s`` ``[L, Hkv, P, ps, 1]``);
- int32 block tables ``[B, MP]``, entry -1 = no page;
- decode attention takes ``q`` ``[B, H, Dh]`` and walks the table.

Where the reference donates the pool to a jitted function and gets a new
one back, the port writes the pool in place: ``scatter_prefill``,
``append_chunk``/``append_token``, ``_paged_step`` and the chunk paths
(``paged_chunk_logits``, ``paged_chunked_prefill``) mutate the tensors of
the ``cache`` dict and return the same dict.

-1 entries: torch indexing wraps -1 to the LAST page (as numpy does), and
``index_put_`` has no drop mode — an index past the end raises instead of
dropping.  So every page write decides which of its entries land before
it indexes: a prefill's scatter (``scatter_pages_raw``, at admission)
selects them with a mask and one device→host sync; the appends of a
decode step or a chunk (``append_chunk``, ``_paged_chunk_hidden``) drop
theirs on the device, at a fixed shape and without a sync, so a CUDA
graph can capture them (``_append_targets``).  A retired slot's
all-(-1) table row writes nothing.

``paged_attention`` is the one kernel of the serving path: a CUDA kernel
(``csrc/paged_attention.cu``) for tensors on the card, its plain version
``paged_attention_ref`` for tensors on the CPU.  An m-token chunk (the
speculative verify, chunked prefill) attends through
``paged_attention_chunk_ref``, plain PyTorch on every device as the
reference's is XLA.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tpu_dra_torch.device import resolve_device
from tpu_dra_torch.workloads.decode import (_chunk_positions, _layer_kv,
                                            _on_processes)
from tpu_dra_torch.workloads.quant import matmul_any, quantize_kv
from tpu_dra_torch.workloads.train import (
    ModelConfig,
    _block,
    _mlp,
    _rmsnorm,
    _split_heads,
    _split_qkv,
    apply_rope,
    embed_tokens,
    head_logits,
    layer_params,
    weak_scalar,
)

_LOG2E = 1.4426950408889634


# --------------------------------------------------------------------------
# Host-side page allocator
# --------------------------------------------------------------------------


class PagePool:
    """Free-list page allocator: the host half of the paged cache.

    Single-threaded by design — it lives inside the engine loop like the
    slot bookkeeping does; callers needing cross-thread alloc wrap it in
    the engine's lock.  Pages carry refcounts: ``alloc`` hands them out at
    1, ``ref`` adds readers, ``free`` releases one reference and returns
    the page at zero.
    """

    def __init__(self, total_pages: int, page_size: int) -> None:
        if total_pages < 1 or page_size < 1:
            raise ValueError(f"need positive pool, got "
                             f"{total_pages}x{page_size}")
        self.total_pages = total_pages
        self.page_size = page_size
        self._free: list[int] = list(range(total_pages - 1, -1, -1))
        self._free_set: set[int] = set(self._free)
        self._refs: dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def alloc(self, n_pages: int) -> list[int]:
        """``n_pages`` page ids, or raise — callers gate admission on
        :attr:`free_pages` first."""
        if n_pages <= 0:
            # [-0:] would slice the WHOLE free list without removing
            # anything — handing out every page while keeping them free
            return []
        if n_pages > len(self._free):
            raise MemoryError(
                f"page pool exhausted: want {n_pages}, free "
                f"{len(self._free)}/{self.total_pages}")
        taken = self._free[-n_pages:][::-1]
        del self._free[len(self._free) - n_pages:]
        self._free_set.difference_update(taken)
        for p in taken:
            self._refs[p] = 1
        return taken

    def ref(self, pages: list[int]) -> None:
        """Add a reference to live pages (zero-copy sharing)."""
        for p in pages:
            if p in self._free_set or p not in self._refs:
                raise ValueError(f"cannot ref non-live page {p}")
        for p in pages:
            self._refs[p] += 1

    def free(self, pages: list[int]) -> None:
        """Release one reference per page; pages return to the free list
        at refcount zero."""
        for p in pages:
            if not 0 <= p < self.total_pages:
                raise ValueError(f"bad page id {p}")
            if p in self._free_set or p not in self._refs:
                # a double-free would alias one physical page to two
                # future requests — silent cross-request KV corruption
                raise ValueError(f"double free of page {p}")
        released = []
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                released.append(p)
        self._free.extend(reversed(released))
        self._free_set.update(released)

    def table_row(self, pages: list[int], max_pages: int):
        """int32 ``[max_pages]`` row: allocated ids then -1 sentinels."""
        row = np.full((max_pages,), -1, np.int32)
        row[:len(pages)] = pages
        return row


def init_paged_cache(cfg: ModelConfig, total_pages: int, page_size: int,
                     cache_dtype: str = "bf16",
                     device=None) -> dict[str, Any]:
    """Zeroed page pool ``[L, Hkv, P, ps, Dh]`` on ``device`` (default:
    the card).  ``cache_dtype="int8"`` adds fp32 scales ``k_s``/``v_s``
    ``[L, Hkv, P, ps, 1]``."""
    device = resolve_device(device)
    shape = (cfg.n_layers, cfg.kv_heads, total_pages, page_size,
             cfg.d_head)
    if cache_dtype == "int8":
        s_shape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(s_shape, dtype=torch.float32,
                                   device=device),
                "v_s": torch.zeros(s_shape, dtype=torch.float32,
                                   device=device)}
    if cache_dtype != "bf16":
        raise ValueError(f"cache_dtype must be bf16 or int8, got "
                         f"{cache_dtype!r}")
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


# --------------------------------------------------------------------------
# Page writes (in place)
# --------------------------------------------------------------------------


def _kv_cols(cache: dict, ks, vs) -> dict:
    """bf16 k/v columns → the cache's write set, quantizing at write when
    the cache carries scales."""
    if "k_s" in cache:
        kq, k_s = quantize_kv(ks)
        vq, v_s = quantize_kv(vs)
        return {"k": kq, "k_s": k_s, "v": vq, "v_s": v_s}
    return {"k": ks, "v": vs}


def scatter_pages_raw(cache: dict, cols: dict, table) -> dict:
    """Write already-cache-dtyped columns (``cols[name]`` ``[L, B, Hkv, S,
    last]``, S a page multiple) into the pages of ``table [B, MP]``, in
    place.  -1 entries write nothing: a sequence shorter than S simply
    writes fewer pages."""
    S = cols["k"].shape[3]
    P, ps = cache["k"].shape[2], cache["k"].shape[3]
    if S % ps:
        raise ValueError(f"prefill width {S} is not a multiple of the "
                         f"page size {ps}")
    npg = S // ps
    if npg > table.shape[1]:
        raise ValueError(f"{npg} prefill pages exceed the table's "
                         f"{table.shape[1]} columns")
    ids = table[:, :npg].long()                             # [B, npg]
    b_sel, j_sel = torch.nonzero((ids >= 0) & (ids < P), as_tuple=True)
    pages = ids[b_sel, j_sel]
    for name, buf in cache.items():
        L, B, hkv, _, last = cols[name].shape
        cp = cols[name].reshape(L, B, hkv, npg, ps, last).permute(
            1, 3, 0, 2, 4, 5)                   # [B, npg, L, hkv, ps, last]
        buf[:, :, pages] = cp[b_sel, j_sel].permute(1, 2, 0, 3, 4).to(
            buf.dtype)
    return cache


def scatter_prefill(cache: dict, ks, vs, table) -> dict:
    """Write prefill KV ``[L, B, Hkv, S, Dh]`` bf16 (S a page multiple —
    right-pad the prompt) into the pages of ``table [B, MP]`` in place,
    quantizing at write when the cache carries scales."""
    return scatter_pages_raw(cache, _kv_cols(cache, ks, vs), table)


def _append_targets(table, lengths, page_size: int, total_pages: int,
                    m: int = 1):
    """Where tokens ``lengths .. lengths+m-1`` of each sequence land, as
    ``(rows, chunk columns, page ids, offsets, any_kept)``: one entry per
    ``[B, m]`` token, ``[B·m]`` each, computed on the device without a
    host sync (a CUDA graph captures it).  An entry whose position falls
    before 0, past the row's width or on a -1 (or past-the-end) entry
    drops, the reference's ``mode="drop"``: it is sent to the first kept
    entry's place with that entry's value, so no place receives two
    different values and no live page is touched; when no entry is kept
    (``any_kept`` false) every entry rewrites page 0's first column with
    its own old value.  A -1 never wraps to the pool's last page.  A
    decode step or a chunk pass computes it once for every layer."""
    B, MP = table.shape
    dev = table.device
    posn = lengths.long().reshape(-1, 1) + torch.arange(
        m, device=dev)[None, :]                           # [B, m]
    pidx = posn // page_size
    ids = table.long().gather(1, pidx.clamp(0, MP - 1))
    ok = ((posn >= 0) & (pidx < MP) & (ids >= 0)
          & (ids < total_pages)).reshape(-1)
    n = torch.arange(B * m, device=dev)
    src = torch.where(ok, n, torch.argmax(ok.to(torch.int32)))
    any_kept = ok.any()
    rows, cols = src // m, src % m
    ids = torch.where(any_kept, ids.reshape(-1)[src], 0)
    off = torch.where(any_kept, (posn % page_size).reshape(-1)[src], 0)
    return rows, cols, ids, off, any_kept


def _append_at(cache: dict, cols: dict, targets) -> None:
    """Write ``cols[name]`` ``[L, B, Hkv, m, last]`` at ``targets`` in
    place (an all-dropped write set rewrites the old values)."""
    rows, js, ids, off, any_kept = targets
    for name, buf in cache.items():
        # [N, L, Hkv, last] → [L, Hkv, N, last]
        new = cols[name][:, rows, :, js].permute(1, 2, 0, 3).to(buf.dtype)
        buf[:, :, ids, off] = torch.where(any_kept, new, buf[:, :, ids, off])


def append_chunk(cache: dict, k_new, v_new, table, lengths, m: int) -> dict:
    """Write an m-token chunk's KV ``[L, B, Hkv, m, Dh]`` bf16 at
    positions ``lengths .. lengths+m-1`` of every sequence, in place: a
    token may cross a page boundary, each one routes through the table
    on its own; quantizes at write for int8 pools."""
    targets = _append_targets(table, lengths, cache["k"].shape[3],
                              cache["k"].shape[2], m)
    _append_at(cache, _kv_cols(cache, k_new, v_new), targets)
    return cache


def append_token(cache: dict, k_new, v_new, table, lengths) -> dict:
    """Write one token's KV ``[L, B, Hkv, Dh]`` bf16 at position
    ``lengths`` (0-based next index) of every sequence, in place: page
    ``lengths // ps`` via the table, offset ``lengths % ps``; quantizes at
    write for int8 pools."""
    return append_chunk(cache, k_new[:, :, :, None], v_new[:, :, :, None],
                        table, lengths, 1)


# --------------------------------------------------------------------------
# Paged decode attention: plain version and kernel wrapper
# --------------------------------------------------------------------------


def paged_attention_chunk_ref(q, k_pages, v_pages, table, pos, m: int,
                              k_s=None, v_s=None):
    """Plain PyTorch m-token chunk attention against pages (the
    speculative verify's shape) — the reference's
    ``paged_attention_chunk_ref``: ``q`` [B, H, m, Dh], row j attends
    columns ``<= pos + j`` (its own just-appended position included).
    Gathers each slot's whole table into a contiguous ``[B, Hkv, MP·ps,
    Dh]`` copy once for the m rows, rounds the QKᵀ scores to bf16 before
    taking them to fp32 (as the reference's einsum does), folds int8
    scales outside the contractions and casts P to bf16 before P·V; a
    row whose limit is below 0 gives zeros."""
    B, qh, _, d = q.shape
    hkv, P, ps, _ = k_pages.shape
    MP = table.shape[1]
    g = qh // hkv
    tab = table.clamp(min=0).long()

    def gather(pages, last):
        t = pages[:, tab]                      # [Hkv, B, MP, ps, last]
        return t.permute(1, 0, 2, 3, 4).reshape(B, hkv, MP * ps, last)

    k = gather(k_pages, d)
    v = gather(v_pages, d)
    quantized = k_s is not None
    if quantized:
        ks_row = gather(k_s, 1)[..., 0]        # [B, Hkv, S]
        vs_row = gather(v_s, 1)[..., 0]
        k = k.to(torch.bfloat16)
        v = v.to(torch.bfloat16)
    qg = q.reshape(B, hkv, g, m, d)
    scores = torch.einsum("bkgmd,bksd->bkgms", qg, k).float()
    scores = scores * (d ** -0.5)
    if quantized:
        scores = scores * ks_row[:, :, None, None, :]
    col = torch.arange(MP * ps, device=q.device)
    limit = pos.long().reshape(-1, 1) + torch.arange(
        m, device=q.device)[None, :]                       # [B, m]
    valid = (col[None, None, :] <= limit[:, :, None])[:, None, None]
    scores = scores.masked_fill(~valid, torch.finfo(torch.float32).min)
    attn = torch.softmax(scores, dim=-1).masked_fill(~valid, 0.0)
    if quantized:
        attn = attn * vs_row[:, :, None, None, :]
    attn = attn.to(torch.bfloat16)
    out = torch.einsum("bkgms,bksd->bkgmd", attn, v)
    return out.reshape(B, qh, m, d).to(torch.bfloat16)


def paged_attention_ref(q, k_pages, v_pages, table, lengths, k_s=None,
                        v_s=None):
    """Plain PyTorch paged decode attention — the reference's
    ``paged_attention_ref``: the chunk version at m=1 with row limit
    ``lengths - 1`` (a zero-length slot's limit is -1: every column
    masks and the output is zeros)."""
    out = paged_attention_chunk_ref(q[:, :, None], k_pages, v_pages, table,
                                    lengths.to(torch.int32) - 1, 1,
                                    k_s=k_s, v_s=v_s)
    return out[:, :, 0]


# Tokens of one work item of the CUDA kernel (``kSpanTokens`` in
# ``csrc/paged_attention.cu``): each (slot, kv head) is cut into
# ``ceil(MP * ps / SPAN_TOKENS)`` spans whose fp32 partials go through a
# workspace that the wrapper allocates.
SPAN_TOKENS = 128


def workspace_floats(B: int, H: int, Hkv: int, Dh: int, MP: int,
                     ps: int) -> int:
    """fp32 elements of the kernel's workspace: per (slot, kv head, span)
    the g = H / Hkv rows' partial output [g, Dh], running max and sum."""
    spans = -(-MP * ps // SPAN_TOKENS)
    return B * Hkv * spans * (H // Hkv) * (Dh + 2)


# How the CUDA kernel is held to ``paged_attention_ref``.  The two round
# at different points (the kernel's bf16 pre-scaled q above all), so a
# slot's outputs differ by about 1% of their norm.  A long slot's outputs
# are each only a few hundredths in size, so the elementwise rtol/atol of
# the reference's own tests (0.05 bf16 pages, 0.08 int8) hardly bind
# there; each slot is also judged on its own scale, where a dropped tile,
# a misread page or a mis-scaled int8 page of a long slot shows.
SLOT_REL_TOL = 0.02


def slot_rel_err(got, want):
    """Per-slot relative L2 error ``||got[b] - want[b]|| / ||want[b]||``
    over the slot's ``[H, Dh]`` outputs, in fp32.  A zero-length slot
    (``want[b]`` all zero) scores 0 only if ``got[b]`` is zero too."""
    diff = (got.float() - want.float()).flatten(1).norm(dim=1)
    norm = want.float().flatten(1).norm(dim=1)
    return torch.where(diff == 0, torch.zeros_like(diff), diff / norm)


def _check_kernel_args(q, k_pages, v_pages, table, lengths, k_s, v_s):
    """Raise on anything the CUDA kernel does not take."""
    B, qh, d = q.shape
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"k/v pages must both be [Hkv, P, ps, Dh], got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    hkv, P, ps, dk = k_pages.shape
    if dk != d or d not in (64, 128):
        raise ValueError(f"kernel takes Dh 64 or 128 matching q, got q "
                         f"Dh {d}, pages Dh {dk}")
    if qh % hkv or qh // hkv not in (1, 2, 4, 8):
        raise ValueError(f"kernel takes GQA groups of 1, 2, 4 or 8, got "
                         f"H {qh} over Hkv {hkv}")
    if ps % 8:
        raise ValueError(f"kernel takes page sizes that are multiples of "
                         f"8, got {ps}")
    if table.dim() != 2 or table.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"table must be [B, MP] and lengths [B] for B "
                         f"{B}, got {tuple(table.shape)} / "
                         f"{tuple(lengths.shape)}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"q must be bf16, got {q.dtype}")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("table and lengths must be int32")
    quantized = k_s is not None
    if quantized != (v_s is not None):
        raise ValueError("pass both k_s and v_s or neither")
    want = torch.int8 if quantized else torch.bfloat16
    if k_pages.dtype != want or v_pages.dtype != want:
        raise ValueError(f"pages must be {want}, got {k_pages.dtype}")
    tensors = [q, k_pages, v_pages, table, lengths]
    if quantized:
        for s in (k_s, v_s):
            if s.shape != (hkv, P, ps, 1) or s.dtype != torch.float32:
                raise ValueError(f"scales must be fp32 [Hkv, P, ps, 1], "
                                 f"got {s.dtype} {tuple(s.shape)}")
        tensors += [k_s, v_s]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all operands must be on {q.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    for t in (k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError("page pools must be 16-byte aligned")


def paged_attention(q, k_pages, v_pages, table, lengths, k_s=None,
                    v_s=None):
    """Decode-step attention against a paged cache.

    ``q`` [B, H, Dh] bf16 (one position per slot), ``k_pages``/
    ``v_pages`` [Hkv, P, ps, Dh] (bf16, or int8 with ``k_s``/``v_s``
    [Hkv, P, ps, 1] fp32), ``table`` [B, MP] int32 (-1 pad), ``lengths``
    [B] int32 valid context per slot, the just-appended token included.
    Returns [B, H, Dh] bf16; a zero-length slot gives zeros.

    CPU tensors take the plain version.  CUDA tensors launch the
    hand-written kernels (``csrc/paged_attention.cu``: the spans of each
    slot, then their merge) or raise; each call adds one to
    ``paged_attention.launches``."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, table, lengths,
                                   k_s, v_s)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, got "
                         f"{q.device}")
    _check_kernel_args(q, k_pages, v_pages, table, lengths, k_s, v_s)
    from tpu_dra_torch.kernels.build import library
    lib = library("paged_attention")
    B, qh, d = q.shape
    hkv, P, ps, _ = k_pages.shape
    # pre-scale into base-2 log space and round to bf16, as the
    # reference's wrapper does (its scalar is bf16-rounded by weak typing)
    qs = (q * weak_scalar(d ** -0.5 * _LOG2E, q.dtype)).contiguous()
    out = torch.empty((B, qh, d), dtype=torch.bfloat16, device=q.device)
    MP = table.shape[1]
    ws = torch.empty(workspace_floats(B, qh, hkv, d, MP, ps),
                     dtype=torch.float32, device=q.device)
    quantized = k_s is not None
    rc = lib.tpu_dra_paged_attention(
        qs.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_s.data_ptr() if quantized else None,
        v_s.data_ptr() if quantized else None,
        table.data_ptr(), lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
        B, qh, hkv, P, ps, d, MP, int(quantized),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        msg = lib.tpu_dra_cuda_error_string(rc).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"CUDA error {rc} ({msg})")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


# --------------------------------------------------------------------------
# Model paths over pages
# --------------------------------------------------------------------------


def _prefill_kv(cfg: ModelConfig, params, prompt):
    """Prefill pass: per-layer KV ``[L, B, Hkv, S, Dh]`` and the final
    pre-head activations ``[B, S, D]`` (dense causal attention through
    the training block)."""
    x = embed_tokens(cfg, params, prompt)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        layer = layer_params(params["blocks"], i)
        k, v = _layer_kv(cfg, layer, x)
        ks.append(k)
        vs.append(v)
        x = _block(cfg, x, layer)
    return torch.stack(ks), torch.stack(vs), x


def _paged_chunk_hidden(cfg: ModelConfig, params, cache, tokens, pos,
                        table):
    """Cached trunk forward of an m-token chunk against pages: ``tokens``
    ``[B, m]``, row j at absolute position ``pos + j`` (``pos`` ``[B]``,
    the context size before the chunk).  Per layer: project, append the
    chunk's KV to its pages, attend, mlp; causality within the chunk
    falls out of the per-row column limit.  Writes the pool in place and
    returns ``(pre-head activations [B, m, D], cache)``.

    A one-token chunk (the decode step) attends through the
    paged-attention kernel; a longer one (the speculative verify, chunked
    prefill) through :func:`paged_attention_chunk_ref`, plain PyTorch in
    the reference too.  The append targets are computed once for all
    layers."""
    m = tokens.shape[1]
    pos = pos.to(torch.int32)
    positions = _chunk_positions(pos, m)                   # [B, m]
    x = embed_tokens(cfg, params, tokens, positions)
    targets = _append_targets(table, pos, cache["k"].shape[3],
                              cache["k"].shape[2], m)
    for i in range(cfg.n_layers):
        layer = layer_params(params["blocks"], i)
        out = _paged_attn(cfg, x, layer, cache, i, table, pos, positions,
                          targets)
        x = x + matmul_any(out, layer["wo"], x.dtype)
        x = _mlp(x, layer)
    return x, cache


def _paged_attn(cfg: ModelConfig, x, layer, cache, i: int, table, pos,
                positions, targets):
    """Layer ``i``'s attention of :func:`_paged_chunk_hidden` up to its
    merged heads ``[B, m, n_heads·d_head]`` (before wo): project, append
    the chunk's KV to the layer's pages, attend.  ``cfg``'s heads are the
    projection's and the pool's: a tensor-parallel rank passes its share
    (``process_decode``)."""
    B, m = x.shape[:2]
    lc = {name: buf[i:i + 1] for name, buf in cache.items()}
    qkv = matmul_any(_rmsnorm(x, layer["ln1"]), layer["wqkv"], x.dtype)
    q, k, v = _split_qkv(cfg, qkv)
    q = _split_heads(cfg, q)                               # [B, H, m, Dh]
    k = _split_heads(cfg, k, cfg.kv_heads)
    v = _split_heads(cfg, v, cfg.kv_heads)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_base)
        k = apply_rope(k, positions, cfg.rope_base)
    _append_at(lc, _kv_cols(lc, k[None], v[None]), targets)
    scales = ({"k_s": lc["k_s"][0], "v_s": lc["v_s"][0]}
              if "k_s" in cache else {})
    if m == 1:
        out = paged_attention(q[:, :, 0].to(torch.bfloat16).contiguous(),
                              lc["k"][0], lc["v"][0], table, pos + 1,
                              **scales)[:, :, None]
    else:
        out = paged_attention_chunk_ref(q.to(torch.bfloat16), lc["k"][0],
                                        lc["v"][0], table, pos, m, **scales)
    return out.transpose(1, 2).reshape(
        B, m, cfg.n_heads * cfg.d_head).to(x.dtype)


def paged_chunk_logits(cfg: ModelConfig, params, cache, tokens, pos,
                       table):
    """m-token chunk forward against pages: appends every token's KV and
    returns ``([B, m, vocab] fp32 logits, cache)`` — the paged analog of
    ``decode._chunk_logits``, the speculative verify pass."""
    x, cache = _paged_chunk_hidden(cfg, params, cache, tokens, pos, table)
    return head_logits(params, x), cache


def _paged_step(cfg: ModelConfig, params, cache, token, lengths, table):
    """One decode step for every slot: embed → per layer (project,
    append to pages, paged attention, mlp) → logits.  ``lengths`` is the
    context size BEFORE this token.  Writes the pool in place; returns
    ``(cache, logits [B, vocab] fp32, lengths + 1)``."""
    x, cache = _paged_chunk_hidden(cfg, params, cache, token[:, None],
                                   lengths, table)
    return cache, head_logits(params, x)[:, 0], lengths.to(torch.int32) + 1


def _pad_to(prompt, multiple: int):
    """Right-pad ``[B, S]`` with token 0 to a multiple of ``multiple``."""
    pad = (-prompt.shape[1]) % multiple
    return torch.nn.functional.pad(prompt, (0, pad)) if pad else prompt


def prefill_columns(cfg: ModelConfig, params, prompt, page_size: int):
    """The trunk of a paged prefill: right-padded prompts ``[B, S]``
    padded on to a page multiple (causally dead, masked by the lengths);
    returns the KV columns ``[L, B, Hkv, S_pad, Dh]`` each of k and v,
    and the trunk activations ``[B, S_pad, D]``."""
    return _prefill_kv(cfg, params, _pad_to(prompt, page_size))


def prefill_pages_hidden(cfg: ModelConfig, params, cache, prompt, table):
    """Prefill right-padded prompts ``[B, S]`` into their pages,
    scattering the KV in place; returns the trunk activations
    ``[B, S_pad, D]``."""
    ks, vs, x = prefill_columns(cfg, params, prompt, cache["k"].shape[3])
    scatter_prefill(cache, ks, vs, table)
    return x


def last_position_logits(params, x, lengths):
    """The head on each row's last real position: activations
    ``[B, S, D]`` and lengths ``[B]`` to logits ``[B, vocab]`` fp32."""
    last = x[torch.arange(x.shape[0], device=x.device), lengths.long() - 1]
    return head_logits(params, last[:, None])[:, 0]


def prefill_pages(cfg: ModelConfig, params, cache, prompt, lengths,
                  table):
    """Prefill right-padded prompts ``[B, S]`` into their pages and
    return the last-real-position logits ``[B, vocab]``."""
    return last_position_logits(
        params, prefill_pages_hidden(cfg, params, cache, prompt, table),
        lengths)


def paged_chunked_prefill(cfg: ModelConfig, params, cache, prompt,
                          lengths, table, chunk: int):
    """Prefill a ``[B, S]`` right-padded prompt (S a multiple of
    ``chunk``) into pages ``chunk`` tokens at a time through the cached
    chunk forward: activations stay O(chunk·D) instead of O(S·D).  Each
    row's hidden state is harvested from the piece where its last real
    position falls, and the vocab head runs once at the end.  Returns
    ``(cache, last-real-position logits [B, vocab])``.  Pad positions
    append KV that decode overwrites before it is ever attended."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    B, S = prompt.shape
    if S % chunk:
        raise ValueError(f"prompt width {S} is not a multiple of the "
                         f"chunk {chunk}")
    dev = prompt.device
    last = lengths.to(device=dev, dtype=torch.int64) - 1
    rows = torch.arange(B, device=dev)
    last_x = torch.zeros((B, cfg.d_model), dtype=torch.bfloat16, device=dev)
    for base in range(0, S, chunk):
        x, cache = _paged_chunk_hidden(
            cfg, params, cache, prompt[:, base:base + chunk],
            torch.full((B,), base, dtype=torch.int32, device=dev), table)
        row = x[rows, (last - base).clamp(0, chunk - 1)]
        inside = (last >= base) & (last < base + chunk)
        last_x = torch.where(inside[:, None], row.to(last_x.dtype), last_x)
    return cache, head_logits(params, last_x[:, None])[:, 0]


@torch.no_grad()
def paged_greedy_decode(cfg: ModelConfig, params, prompt, table, *,
                        steps: int, total_pages: int, page_size: int,
                        lengths=None, cache_dtype: str = "bf16",
                        prefill_chunk: int | None = None, mesh=None):
    """Greedy decode ``steps`` tokens with all KV in pages, on the device
    of ``prompt``.

    ``prompt`` [B, S] int, right-padded; ``lengths`` [B] true prompt
    lengths (default: full S); ``table`` [B, MP] int32 page ids with
    capacity for ``lengths + steps``.  ``prefill_chunk``: prefill through
    :func:`paged_chunked_prefill` in pieces of that many tokens (the
    prompt padded to a page, then a chunk multiple) instead of the dense
    prefill trunk.  Returns [B, steps] int32 — the per-request oracle of
    the continuous engine.

    ``mesh``: a ``mesh.ProcessMesh`` decodes tensor-parallel from this
    process's serving shards (``process_decode.paged_greedy_decode``):
    the pool and the global table the same on every process, its pages
    its own kv heads, the global tokens returned on every process
    (``prefill_chunk`` raises ``NotImplementedError`` there); any other
    mesh raises ``TypeError``."""
    dev = prompt.device
    B, S = prompt.shape
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    lengths = lengths.to(device=dev, dtype=torch.int32)
    table = table.to(device=dev, dtype=torch.int32)
    if _on_processes(mesh):
        if prefill_chunk:
            raise NotImplementedError("paged decoding on a process mesh "
                                      "prefills whole prompts")
        from tpu_dra_torch.workloads import process_decode
        return process_decode.paged_greedy_decode(
            cfg, params, prompt, table, mesh, steps=steps,
            total_pages=total_pages, page_size=page_size, lengths=lengths,
            cache_dtype=cache_dtype)
    cache = init_paged_cache(cfg, total_pages, page_size, cache_dtype,
                             device=dev)
    if prefill_chunk:
        prompt = _pad_to(_pad_to(prompt, page_size), prefill_chunk)
        cache, logits = paged_chunked_prefill(cfg, params, cache, prompt,
                                              lengths, table, prefill_chunk)
    else:
        logits = prefill_pages(cfg, params, cache, prompt, lengths, table)
    token = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [token]
    lens = lengths
    for _ in range(steps - 1):
        cache, logits, lens = _paged_step(cfg, params, cache, token, lens,
                                          table)
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(token)
    return torch.stack(out, dim=1)                         # [B, steps]


def make_paged_decoder(cfg: ModelConfig, *, steps: int, total_pages: int,
                       page_size: int, cache_dtype: str = "bf16",
                       prefill_chunk: int | None = None, device=None):
    """``(params, prompt [B, S], table [B, MP][, lengths]) -> [B, steps]``
    greedy decoder over a paged cache on ``device`` (default: the card);
    prompt, table and lengths are moved there, the params must already
    live there.  A plain closure over :func:`paged_greedy_decode` (the
    reference jit-compiles it; the table is a plain operand either
    way, so one decoder serves any allocation pattern)."""
    dev = resolve_device(device)

    def run(params, prompt, table, lengths=None):
        return paged_greedy_decode(
            cfg, params, torch.as_tensor(prompt).to(dev),
            torch.as_tensor(table).to(dev), steps=steps,
            total_pages=total_pages, page_size=page_size,
            lengths=None if lengths is None else torch.as_tensor(lengths),
            cache_dtype=cache_dtype, prefill_chunk=prefill_chunk)
    return run
