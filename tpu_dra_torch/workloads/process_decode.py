"""Tensor-parallel decoding on a ``mesh.ProcessMesh``, one process a rank:
what ``decode.greedy_decode``, ``beam_decode``, ``speculative_decode``
and ``paged_kv.paged_greedy_decode`` run when given ``mesh=`` a process
mesh with a "tp" axis (and batch axes "dcn" / "dp").  The reference
decodes from parameters placed under the dp×tp shardings and lets GSPMD
partition each step; here every collective it inserts is an explicit
group collective along the "tp" line (``mesh.py``).

Each process holds its serving shards: ``quant.local_serving_tree(mesh,
mesh.shard_tree(params, specs), specs)`` with ``specs =
quant.serving_param_shardings(cfg, mesh, params)`` (:func:`local_tree`),
bf16, int8 or int4 leaves: the column shards of ``wqkv`` and ``w1``, the
row shards of ``wo`` and ``w2``, the ``(None, "tp")`` column shards of
``embed`` and ``unembed`` (and ``pos``).  :class:`TPModel` recuts the
fused projection's columns once, on the weight, to this rank's heads
(``process_train.head_columns``: its q heads and the kv heads they read,
one copy of a kv head for each q head where the kv heads do not split
over tp); a column's product does not depend on the other columns, so
the activations come out as a recut of them would.  Then, per token:

- the embedding's column shard is looked up and all-gathered over tp;
- ln1 feeds the local ``wqkv`` columns; attention runs on this rank's q
  heads against its own KV cache, which holds its kv heads only
  (``decode._decode_attn`` / ``paged_kv._paged_attn`` with the rank's
  share of the heads, so kernel #1 runs on ``[B, H/tp, Dh]``);
- ``wo`` is row-parallel, its fp32 partial products psummed over tp and
  rounded to bf16 once (one device rounds its whole product once); ln2
  feeds ``w1`` and gelu, then ``w2`` row-parallel, psummed alike;
- ``ln_f``, then the untied head's vocab shard, or the tied head's fp32
  partial logits psummed and rounded to bf16 once; the token is the
  global argmax across the vocab shards (``ProcessMesh.argmax``:
  ``jnp.argmax``'s first max), the beam's candidates the global top-w
  (``ProcessMesh.top_w``), its log-softmax vocab-parallel; the tied
  head's logits hold every column on every rank, so there both are
  each process's own.

An int8 leaf whose rows are cut (``wo``, ``w2``) quantizes each
activation row with its whole row's amax (``quant.RowMax``).  The prompt's
rows are cut over the batch axes; every process returns the global
tokens.  The decoders take greedy decoding of equal-length prompts
(ragged lengths on pages), a bf16 or int8 cache and dense or flash
prefill attention; the sampled, windowed and penalized options of the
one-device decoders raise ``NotImplementedError`` on a process mesh.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tpu_dra_torch.workloads.decode import (_chunk_positions, _decode_attn,
                                            _layer_kv, _restore_rows,
                                            _snapshot_rows, _top_w,
                                            init_kv_cache, length_normalized)
from tpu_dra_torch.workloads.mesh import axes_of
from tpu_dra_torch.workloads.paged_kv import (_append_targets, _pad_to,
                                              _paged_attn, init_paged_cache,
                                              scatter_prefill)
from tpu_dra_torch.workloads.process_train import _tp_layout
from tpu_dra_torch.workloads.quant import (column_major, is_quantized,
                                           is_quantized4, local_serving_tree,
                                           matmul_any, quantize_kv,
                                           serving_param_shardings)
from tpu_dra_torch.workloads.spec_sample import commit_greedy
from tpu_dra_torch.workloads.train import (_attn_core, _rmsnorm, attn_impl_fn,
                                           dot_f32, embed_tokens,
                                           layer_params)


def local_tree(cfg, mesh, params: dict) -> dict:
    """This process's serving shards of the global tree ``params`` (the
    same on every process) as the decoders read them: cut by
    ``quant.serving_param_shardings`` and read through
    ``quant.local_serving_tree``."""
    specs = serving_param_shardings(cfg, mesh, params)
    return local_serving_tree(mesh, mesh.shard_tree(params, specs), specs)


def _recut(mesh, plan, w):
    """The fused projection's local columns recut to this rank's heads."""
    if torch.is_tensor(w):
        return mesh.columns(w, "tp", plan)
    if is_quantized(w):
        return dict(w, q8=column_major(mesh.columns(w["q8"], "tp", plan)),
                    s=mesh.columns(w["s"], "tp", plan))
    if is_quantized4(w):
        return dict(w, q4=mesh.columns(w["q4"], "tp", plan),
                    s4=mesh.columns(w["s4"], "tp", plan))
    raise ValueError(f"the tensor-parallel decoder takes bf16, int8 or int4 "
                     f"wqkv leaves, got {sorted(w)}")


def _partial(x, w):
    """``matmul_any(x, w, x.dtype)`` before its rounding: the fp32 product
    (a plain weight cast to x's dtype, the product accumulated in fp32;
    an int8 or int4 leaf's product is fp32 already)."""
    if not torch.is_tensor(w):
        return matmul_any(x, w, torch.float32)
    y = dot_f32(x.reshape(-1, x.shape[-1]), w.to(x.dtype))
    return y.reshape(*x.shape[:-1], y.shape[-1])


class TPModel:
    """One process's share of a serving model on a ``ProcessMesh`` with a
    "tp" axis: ``params`` its :func:`local_tree`.  ``lcfg`` is the model
    as this rank's projection and caches see it (its q heads and kv
    heads, ``d_model`` their width), the KV caches' config."""

    @torch.no_grad()
    def __init__(self, cfg, params: dict, mesh):
        _, plan, (hl, kl) = _tp_layout(cfg, mesh, "tensor-parallel decoder")
        tp, r = mesh.axis_size("tp"), mesh.axis_index("tp")
        self.cfg, self.mesh = cfg, mesh
        self.lcfg = dataclasses.replace(cfg, d_model=hl * cfg.d_head,
                                        n_heads=hl, n_kv_heads=kl)
        blocks = dict(params["blocks"])
        blocks["wqkv"] = _recut(mesh, plan, blocks["wqkv"])
        self.params = dict(params, blocks=blocks)
        self.vocab_cut = "unembed" in params
        vl = cfg.vocab // tp if self.vocab_cut else cfg.vocab
        self.vocab_index = torch.arange(vl, device=mesh.device) + \
            (r * vl if self.vocab_cut else 0)
        self.row_spec = (mesh.batch_axes(), None)

    # -- the forward pieces --------------------------------------------

    def embed(self, tokens, positions=None):
        """``[B, m, D]``: the local embedding columns, all-gathered."""
        x = embed_tokens(self.cfg, self.params, tokens, positions)
        return self.mesh.all_gather(x, "tp", x.dim() - 1)

    def _finish(self, x, out, layer):
        """A block after its attention: wo row-parallel, then the MLP with
        w1's column shard and w2 row-parallel; each row-parallel product's
        fp32 partials psummed and rounded to x's dtype once, where one
        device rounds its whole product once."""
        mesh = self.mesh
        x = x + mesh.reduce(_partial(out, layer["wo"]), "tp").to(x.dtype)
        h = F.gelu(matmul_any(_rmsnorm(x, layer["ln2"]), layer["w1"],
                              x.dtype), approximate="tanh")
        return x + mesh.reduce(_partial(h, layer["w2"]), "tp").to(x.dtype)

    def prefill_kv(self, prompt, attn_impl: str = "dense",
                   trace: list | None = None):
        """The prompt through the trunk: this rank's k and v ``[L, B,
        Hkv/tp, S, Dh]`` (keys rotated) and the activations ``[B, S,
        D]``.  ``trace``: a list the activations after the embedding and
        after each layer are appended to."""
        attn_fn = attn_impl_fn(attn_impl)
        x = self.embed(prompt)
        ks, vs = [], []
        if trace is not None:
            trace.append(x)
        for i in range(self.cfg.n_layers):
            layer = layer_params(self.params["blocks"], i)
            k, v = _layer_kv(self.lcfg, layer, x)
            ks.append(k)
            vs.append(v)
            qkv = matmul_any(_rmsnorm(x, layer["ln1"]), layer["wqkv"],
                             x.dtype)
            x = self._finish(x, _attn_core(self.lcfg, qkv, attn_fn, None),
                             layer)
            if trace is not None:
                trace.append(x)
        return torch.stack(ks), torch.stack(vs), x

    def prefill(self, cache, prompt, attn_impl: str = "dense"):
        """Fill a slab cache (``decode.init_kv_cache(lcfg, ...)``) for
        positions ``[0, S)`` in place; the activations ``[B, S, D]``."""
        ks, vs, x = self.prefill_kv(prompt, attn_impl)
        S = prompt.shape[1]
        for i in range(self.cfg.n_layers):
            k, v = ks[i], vs[i]
            if "k_s" in cache:
                (k, k_s), (v, v_s) = quantize_kv(k), quantize_kv(v)
                cache["k_s"][i][:, :, :S] = k_s
                cache["v_s"][i][:, :, :S] = v_s
            cache["k"][i][:, :, :S] = k.to(cache["k"].dtype)
            cache["v"][i][:, :, :S] = v.to(cache["v"].dtype)
        return x

    def chunk_hidden(self, cache, pos, tokens):
        """The cached forward of ``tokens`` ``[B, m]`` at positions ``pos
        ..`` (int or ``[B]``) against a slab cache, written in place:
        ``[B, m, D]``."""
        m = tokens.shape[1]
        pos = torch.as_tensor(pos, dtype=torch.int32,
                              device=tokens.device).reshape(-1)
        x = self.embed(tokens, _chunk_positions(pos, m))
        quantized = "k_s" in cache
        for i in range(self.cfg.n_layers):
            layer = layer_params(self.params["blocks"], i)
            scales = ((cache["k_s"][i], cache["v_s"][i]) if quantized
                      else (None, None))
            out = _decode_attn(self.lcfg, x, layer, cache["k"][i],
                               cache["v"][i], pos, *scales)
            x = self._finish(x, out, layer)
        return x

    def paged_hidden(self, cache, tokens, pos, table):
        """The cached forward of ``tokens`` ``[B, m]`` against pages
        (``paged_kv.init_paged_cache(lcfg, ...)``; ``pos`` ``[B]`` the
        context before the chunk): ``[B, m, D]``.  A one-token chunk
        attends through ``paged_kv.paged_attention`` (#1)."""
        m = tokens.shape[1]
        pos = pos.to(torch.int32)
        positions = _chunk_positions(pos, m)
        x = self.embed(tokens, positions)
        targets = _append_targets(table, pos, cache["k"].shape[3],
                                  cache["k"].shape[2], m)
        for i in range(self.cfg.n_layers):
            layer = layer_params(self.params["blocks"], i)
            out = _paged_attn(self.lcfg, x, layer, cache, i, table, pos,
                              positions, targets)
            x = self._finish(x, out, layer)
        return x

    def head(self, x):
        """fp32 logits of ``[..., D]``: this rank's vocab shard (untied),
        or every column (tied: the partial logits against ``embed``'s
        column shard psummed in fp32, rounded to bf16 once)."""
        h = _rmsnorm(x, self.params["ln_f"])
        if self.vocab_cut:
            return matmul_any(h, self.params["unembed"],
                              torch.bfloat16).float()
        e = self.params["embed"]
        dl, r = e.shape[1], self.mesh.axis_index("tp")
        hl = h[..., r * dl:(r + 1) * dl].to(torch.bfloat16)
        part = dot_f32(hl.reshape(-1, dl), e.to(torch.bfloat16).T)
        logits = self.mesh.reduce(part, "tp").to(torch.bfloat16).float()
        return logits.reshape(*h.shape[:-1], -1)

    # -- reductions over the vocab ---------------------------------------

    def argmax(self, logits):
        """int32 global argmax of :meth:`head`'s logits."""
        if not self.vocab_cut:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return self.mesh.argmax(logits, "tp").to(torch.int32)

    def top_w(self, x, index, w: int):
        """The ``w`` largest entries of each row of ``x`` (:meth:`head`'s
        cut) over the global vocab and their global indices (``index``,
        each entry's), in ``jax.lax.top_k``'s order: merged across the
        vocab shards (``ProcessMesh.top_w``), or this process's own where
        every rank holds every column (the tied head)."""
        if not self.vocab_cut:
            vals, pos = _top_w(x, w)
            return vals, index[pos]
        return self.mesh.top_w(x, index, w, "tp")

    def log_softmax(self, logits):
        """The log-softmax over the global vocab of :meth:`head`'s
        logits, in their cut: ``logits − lse`` with the max all-reduced
        and the exp sums psummed."""
        if not self.vocab_cut:
            return torch.log_softmax(logits, dim=-1)
        m = self.mesh.pmax(logits.amax(dim=-1, keepdim=True), "tp")
        total = self.mesh.reduce(torch.exp(logits - m).sum(dim=-1,
                                                           keepdim=True),
                                 "tp")
        return logits - (m + torch.log(total))

    def full_logits(self, logits):
        """:meth:`head`'s logits with every vocab column, on every
        process."""
        if not self.vocab_cut:
            return logits
        return self.mesh.all_gather(logits, "tp", logits.dim() - 1)

    # -- the batch rows --------------------------------------------------

    def rows(self, t):
        """This process's rows of a global ``[B, ...]`` tensor (the rows
        cut over the batch axes)."""
        return self.mesh.shard(t, self.row_spec + (None,) * (t.dim() - 2))

    def gather_rows(self, t):
        """The global tensor of every process's rows."""
        return self.mesh.unshard(t.contiguous(),
                                 self.row_spec + (None,) * (t.dim() - 2))


@torch.no_grad()
def first_logits(cfg, params, prompt, mesh, *, max_len: int | None = None,
                 attn_impl: str = "dense", cache_dtype: str = "bf16"):
    """The global fp32 logits ``[B, vocab]`` after a ``[B, S]`` prompt (the
    first decode step's), on every process: the tensor-parallel
    counterpart of ``decode.prefill``'s."""
    m = TPModel(cfg, params, mesh)
    rows = m.rows(prompt)
    cache = init_kv_cache(m.lcfg, rows.shape[0], max_len or cfg.max_seq,
                          cache_dtype, device=prompt.device)
    x = m.prefill(cache, rows, attn_impl)
    return m.gather_rows(m.full_logits(m.head(x[:, -1])))


@torch.no_grad()
def greedy_decode(cfg, params, prompt, mesh, *, steps: int, max_len: int,
                  attn_impl: str = "dense", cache_dtype: str = "bf16"):
    """``decode.greedy_decode`` on a process mesh (the caller validated
    the arguments): ``[B, steps]`` int32 global tokens."""
    m = TPModel(cfg, params, mesh)
    rows = m.rows(prompt)
    B, S = rows.shape
    cache = init_kv_cache(m.lcfg, B, max_len, cache_dtype,
                          device=prompt.device)
    x = m.prefill(cache, rows, attn_impl)
    token = m.argmax(m.head(x[:, -1]))
    out = [token]
    for i in range(steps - 1):
        x = m.chunk_hidden(cache, S + i, token[:, None])
        token = m.argmax(m.head(x[:, 0]))
        out.append(token)
    return m.gather_rows(torch.stack(out, dim=1))


@torch.no_grad()
def paged_greedy_decode(cfg, params, prompt, table, mesh, *, steps: int,
                        total_pages: int, page_size: int, lengths,
                        cache_dtype: str = "bf16"):
    """``paged_kv.paged_greedy_decode`` on a process mesh: the pool and
    the global ``table`` ``[B, MP]`` are the same on every process (its
    rows cut with the prompt's), each process's ``[L, Hkv/tp, P, ps,
    Dh]`` pages its own kv heads.  ``[B, steps]`` int32 global tokens."""
    m = TPModel(cfg, params, mesh)
    rows, table, lengths = m.rows(prompt), m.rows(table), \
        m.rows(lengths[:, None])[:, 0]
    cache = init_paged_cache(m.lcfg, total_pages, page_size, cache_dtype,
                             device=prompt.device)
    ks, vs, x = m.prefill_kv(_pad_to(rows, page_size))
    scatter_prefill(cache, ks, vs, table)
    last = x[torch.arange(x.shape[0], device=x.device), lengths.long() - 1]
    token = m.argmax(m.head(last))
    out, lens = [token], lengths
    for _ in range(steps - 1):
        x = m.paged_hidden(cache, token[:, None], lens, table)
        token = m.argmax(m.head(x[:, 0]))
        lens = lens + 1
        out.append(token)
    return m.gather_rows(torch.stack(out, dim=1))


@torch.no_grad()
def beam_decode(cfg, params, prompt, mesh, *, steps: int, beams: int,
                max_len: int, attn_impl: str = "dense",
                cache_dtype: str = "bf16", eos_id: int | None = None,
                length_penalty: float = 0.0):
    """``decode.beam_decode`` on a process mesh: the same search over the
    global vocab, its candidates the global top-w (:meth:`TPModel.top_w`:
    the flat index ``parent·V + token``, lower first among equal
    scores), each process's cache rows reordered by the same global
    parents.  Global ``([B, beams, steps]`` tokens, ``[B, beams]``
    scores)."""
    m = TPModel(cfg, params, mesh)
    rows = m.rows(prompt)
    B, S = rows.shape
    W, V, dev = beams, cfg.vocab, prompt.device
    cache = init_kv_cache(m.lcfg, B, max_len, cache_dtype, device=dev)
    x = m.prefill(cache, rows, attn_impl)
    cache = {k: v.repeat_interleave(W, dim=1) for k, v in cache.items()}
    logp = m.log_softmax(m.head(x[:, -1]))
    scores, tok = m.top_w(logp, m.vocab_index, W)
    token = tok.reshape(B * W).to(torch.int32)
    done = (torch.zeros(B * W, dtype=torch.bool, device=dev)
            if eos_id is None else token == eos_id)
    hist = torch.zeros((B, W, steps), dtype=torch.int32, device=dev)
    hist[:, :, 0] = tok
    base = torch.arange(B, device=dev)[:, None] * W
    flat = (torch.arange(W, device=dev)[:, None] * V
            + m.vocab_index[None, :]).reshape(-1)
    if eos_id is not None:
        only_eos = torch.where(m.vocab_index == eos_id, 0.0, -1e30)
    for i in range(steps - 1):
        x = m.chunk_hidden(cache, S + i, token[:, None])
        logp = m.log_softmax(m.head(x[:, 0]))
        if eos_id is not None:
            logp = torch.where(done[:, None], only_eos, logp)
        total = scores.reshape(B * W, 1) + logp
        scores, idx = m.top_w(total.reshape(B, -1), flat, W)
        parent = torch.div(idx, V, rounding_mode="floor")
        tok = (idx % V).to(torch.int32)
        src = (base + parent).reshape(B * W)
        for buf in cache.values():
            for layer in buf:
                layer.copy_(layer.index_select(0, src))
        hist = hist.gather(1, parent[:, :, None].expand(B, W, steps))
        hist[:, :, i + 1] = tok
        token = tok.reshape(B * W)
        done = done[src]
        if eos_id is not None:
            done = done | (token == eos_id)
    if length_penalty > 0.0:
        hist, scores = length_normalized(hist, scores, done, eos_id,
                                         length_penalty)
    return m.gather_rows(hist), m.gather_rows(scores)


@torch.no_grad()
def speculative_decode(cfg, params, draft_cfg, draft_params, prompt, mesh,
                       *, steps: int, k: int, max_len: int,
                       attn_impl: str = "dense", cache_dtype: str = "bf16"):
    """``decode.speculative_decode``'s greedy acceptance on a process mesh:
    the draft (``spec_draft.truncate_draft`` of this process's tree, its
    embedding and head shards shared) proposes ``k − 1`` tokens, the
    target verifies them in one cached chunk; acceptance reads global
    argmaxes, so every tp rank accepts the same count.  ``([B, steps]``
    int32 global tokens, the most target passes a process's rows took)."""
    tm = TPModel(cfg, params, mesh)
    dm = TPModel(draft_cfg, draft_params, mesh)
    rows = tm.rows(prompt)
    B, S = rows.shape
    dev = prompt.device
    t_cache = init_kv_cache(tm.lcfg, B, max_len, cache_dtype, device=dev)
    last = tm.argmax(tm.head(tm.prefill(t_cache, rows, attn_impl)[:, -1]))
    d_cache = init_kv_cache(dm.lcfg, B, max_len, cache_dtype, device=dev)
    dm.prefill(d_cache, rows, attn_impl)
    width = steps + k
    out = torch.zeros((B, width + 1), dtype=torch.int32, device=dev)
    out[:, 0] = last
    count = torch.ones(B, dtype=torch.int32, device=dev)
    pos = torch.full((B,), S, dtype=torch.int32, device=dev)
    no_eos = torch.full((B,), -1, dtype=torch.int32, device=dev)
    j = torch.arange(k, device=dev)[None, :]
    at = torch.arange(B, device=dev)[:, None]
    caches = [t_cache, d_cache]
    passes = 0
    while passes < steps:
        done_host = [c >= steps for c in count.tolist()]
        if all(done_host):
            break
        done = torch.tensor(done_host, device=dev)
        frozen = torch.nonzero(done)[:, 0]
        saved = _snapshot_rows(caches, frozen) if len(frozen) else None
        tok, proposals = last, []
        for i in range(k):
            tok = dm.argmax(dm.head(dm.chunk_hidden(d_cache, pos + i,
                                                    tok[:, None])[:, 0]))
            proposals.append(tok)
        drafts = torch.stack(proposals[:k - 1], dim=1)
        chunk = torch.cat([last[:, None], drafts], dim=1)
        preds = tm.argmax(tm.head(tm.chunk_hidden(t_cache, pos, chunk)))
        last2, _, _, emit, counts = commit_greedy(last, pos, no_eos, done,
                                                  drafts, preds)
        n = torch.clamp(counts - 1, min=0)
        dest = torch.where((j <= n[:, None]) & ~done[:, None],
                           count[:, None] + j, width)
        out[at, dest.long()] = emit.to(torch.int32)
        if saved is not None:
            _restore_rows(caches, frozen, saved)
        adv = (n + 1).to(torch.int32)
        pos = torch.where(done, pos, pos + adv)
        count = torch.where(done, count, count + adv)
        last = last2
        passes += 1
    most = torch.tensor(passes, device=dev)
    for a in axes_of(tm.mesh.batch_axes()):
        most = tm.mesh.pmax(most, a)
    return tm.gather_rows(out[:, :steps]), int(most)
