"""The DP×TP train steps on a ``mesh.ProcessMesh``, one process a rank:
what ``train.make_sharded_train_step`` and ``train.make_optax_train_step``
build when their mesh is a process mesh (the reference's
``make_sharded_train_step``, 726-753, and ``make_optax_train_step``,
756-803, on a mesh whose devices belong to many processes).  Both run
:func:`make_process_grads`; the SGD step takes ``p − lr·g`` from its
gradient shards, the AdamW step hands them to the optimizer, whose
``optim.ProcessMomentLayout`` holds this process's moment shards (cut
over "dp" too under ZeRO-1).

Each process holds its own shards, cut by ``train.param_shardings``
(``ProcessMesh.shard_tree``), and every collective that GSPMD inserts in
the reference is an explicit group collective along the "tp" or the
batch axes' line (``mesh.py``), each with its transpose:

- ``matmul_impl="fused_collective"`` (the Megatron-SP layout of the
  reference's ``_trunk``, 366-451): the residual stream lives
  sequence-sharded, ``(batch, "tp", None)``.  The token tail is padded to
  a multiple of tp (where that would run past a learned-position table,
  the step takes the dense path, as the reference falls back).  The
  column-cut embedding (``embed`` and ``pos`` are ``(None, "tp")``) is
  looked up on this rank's columns and resharded to the sequence cut by
  an all-to-all.  Each sublayer opens with rmsnorm on this rank's rows
  and the all-gather-matmul ring kernel against the local column shard
  (``collective_matmul.ProcessAllGatherMatmul``, rows folded
  sequence-major as the reference's ``inner`` bodies fold them) and
  closes with the matmul-reduce-scatter ring kernel against the local row
  shard (``ProcessMatmulReduceScatter``); gelu runs on the column shard
  between w1 and w2.
- ``"dense"`` (Megatron TP, what GSPMD makes of the shardings with no
  ring kernel): the residual stream is whole on every tp rank, the
  embedding's column shards all-gathered.  wqkv and w1 are
  column-parallel behind :class:`mesh.GroupCopy` (identity forward, psum
  backward) on both the activations and the norm gain, so
  ``norm_impl="fused"`` sends the local product through
  ``matmul.RmsnormMatmul`` where its admission holds, as on one device;
  wo and w2 are row-parallel and :class:`mesh.GroupReduce` (psum forward,
  identity backward) sums their bf16 partial products.

In both, the fused projection's column block of rank r is not aligned to
heads, so it is recut explicitly (:func:`head_columns`,
``ProcessMesh.columns``): each rank gets the q columns of its
``n_heads/tp`` heads and the k and v columns of the kv heads they read
(where the kv heads do not split evenly over tp, one k/v head for each
q head).  The merged heads are then the ``(batch, None, "tp")`` cut that
wo's rows want.  The recut sits outside the remat's stretches
(``train._block``'s ``seg``), so the backward does not run it again.

The head: ln_f on every row (in the fused path after an all-gather of
the sequence shards, whose transpose reduce-scatters), then the untied
head's vocab-parallel log-softmax against ``unembed``'s vocab shard (a
max all-reduce, a psum of the exp sums, the target logit from the rank
that owns it), or the tied head's partial logits against ``embed``'s
column shard, psummed; label smoothing and z-loss on either
(``train.regularized``).  ``head_impl="chunked"`` streams the same
products in vocab chunks (``train._ChunkedNLL``): each rank its own
vocab shard, the stats combined across tp, or the tied head's chunk
partials psummed.  The loss is the psum over the batch axes of the
NLL sums over the psum of the token counts (each row counted once, not
once a tp rank).  Each rank differentiates its own share of that
global mean, so the gradients summed over the batch axes (and over tp
for the norm gains the fused path holds a row share of) are the
gradient of the global mean, with no rank-count factor, as the
reference's GSPMD step; every process ends with the same bits in each
replicated leaf.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from tpu_dra_torch.workloads.collective_matmul import (
    ProcessAllGatherMatmul, ProcessMatmulReduceScatter)
from tpu_dra_torch.workloads.mesh import axes_of
from tpu_dra_torch.workloads.quant import matmul_any
from tpu_dra_torch.workloads.train import (CHUNKED_REFUSES, _attn_core,
                                           _causal_dense_attention,
                                           _ChunkedNLL, _norm_matmul,
                                           _rmsnorm, attn_impl_fn,
                                           batch_sharding, dot_f32,
                                           embed_tokens, fc_splits,
                                           layer_params, opt_state_shardings,
                                           param_shapes, param_shardings,
                                           regularized, remat, smoothed_nll,
                                           tree_leaves, tree_like,
                                           tree_unflatten, vocab_chunks)

# the chunked head's chunk count over the whole vocab (train.head_nll's
# n_chunks); an untied rank streams its 1/tp share in CHUNKS/tp of them
CHUNKS = 16


def head_columns(cfg, tp: int) -> tuple:
    """``(src, dst, kv)`` of the fused projection's recut over tp ranks:
    ``src[r]`` the global columns of ``[q | k | v]`` rank r's column shard
    holds, ``dst[r]`` the columns its heads want (its q heads' q columns,
    then the k and the v columns of ``kv[r]``, the k/v heads it holds in
    its order).  A rank holds the distinct k/v heads its q heads read
    where each of them serves an equal run of its q heads, else one k/v
    head for each q head."""
    n_cols = cfg.d_model + 2 * cfg.d_kv
    if cfg.n_heads % tp or n_cols % tp:
        raise ValueError(f"{cfg.n_heads} heads and {n_cols} projection "
                         f"columns must split over tp {tp}")
    width, hl, dh = n_cols // tp, cfg.n_heads // tp, cfg.d_head
    group = cfg.n_heads // cfg.kv_heads
    src = [list(range(r * width, (r + 1) * width)) for r in range(tp)]
    dst, kv = [], []
    for r in range(tp):
        reads = [(r * hl + i) // group for i in range(hl)]
        heads = sorted(set(reads))
        run = hl // len(heads)
        if hl % len(heads) or any(reads[i] != heads[i // run]
                                  for i in range(hl)):
            heads = reads
        cols = list(range(r * hl * dh, (r + 1) * hl * dh))
        for base in (cfg.d_model, cfg.d_model + cfg.d_kv):
            cols += [base + h * dh + e for h in heads for e in range(dh)]
        dst.append(cols)
        kv.append(heads)
    return src, dst, kv


def fc_admitted(cfg, seq: int, tp: int) -> bool:
    """Whether a trunk of ``seq`` rows takes the ring kernels on a process
    mesh: the reference's fallback where padding to tp would run past a
    learned-position table, then ``train.fc_splits`` for each of the four
    weights (the process path cannot mix the layouts, so a refusal sends
    the whole trunk down the dense path)."""
    pad = (-seq) % tp
    if pad and cfg.pos_emb == "learned" and seq + pad > cfg.max_seq:
        return False
    d, n, f = cfg.d_model, cfg.d_model + 2 * cfg.d_kv, cfg.d_ff
    return all(fc_splits(seq + pad, shape, tp, contract)
               for shape, contract in (((d, n), False), ((d, f), False),
                                       ((d, d), True), ((f, d), True)))


def _fc_entry(x, gamma, w, ring):
    """rmsnorm on this rank's rows ``[bl, sl, D]`` (rematerialized), then
    the all-gather-matmul against the local column shard: ``[bl, S, N/tp]``
    for every row."""
    bl, sl, d = x.shape
    normed = remat(_rmsnorm, x, gamma)
    xf = normed.transpose(0, 1).reshape(sl * bl, d)
    y = ProcessAllGatherMatmul.apply(ring, xf, w.to(x.dtype))
    return y.reshape(-1, bl, y.shape[-1]).transpose(0, 1)


def _fc_exit(h, w, ring):
    """The matmul-reduce-scatter of the column shard ``[bl, S, K/tp]``
    against the local row shard: this rank's rows ``[bl, S/tp, D]``."""
    bl, s, kl = h.shape
    xf = h.transpose(0, 1).reshape(s * bl, kl)
    y = ProcessMatmulReduceScatter.apply(ring, xf, w.to(h.dtype))
    return y.reshape(-1, bl, y.shape[-1]).transpose(0, 1)


def _fc_trunk(cfg, params, tokens, mesh, attn_fn, plan, heads):
    """The fused-collective trunk on this rank's ``[bl, S]`` tokens:
    ``[bl, S, D]`` pre-final-norm activations, every row gathered."""
    tp, ring = mesh.axis_size("tp"), mesh.ring("tp")
    s = tokens.shape[1]
    pad = (-s) % tp
    if pad:
        tokens = F.pad(tokens, (0, pad))
    x = mesh.all_to_all(embed_tokens(cfg, params, tokens), "tp", 1, 2)
    for i in range(cfg.n_layers):
        layer = layer_params(params["blocks"], i)
        qkv = mesh.columns(_fc_entry(x, layer["ln1"], layer["wqkv"], ring),
                           "tp", plan)
        out = remat(_attn_core, cfg, qkv, attn_fn, None, heads)
        x = x + _fc_exit(out, layer["wo"], ring)
        h = F.gelu(_fc_entry(x, layer["ln2"], layer["w1"], ring),
                   approximate="tanh")
        x = x + _fc_exit(h, layer["w2"], ring)
    x = mesh.all_gather(x, "tp", 1)
    return x[:, :s] if pad else x


def _tp_norm_matmul(x, gamma, w, mesh, norm_impl: str):
    """A column-parallel sublayer entry: the whole x and gain behind
    :class:`mesh.GroupCopy`, then ``train._norm_matmul`` on the local
    column shard (the RMSNorm-matmul kernel where it admits the shape)."""
    return _norm_matmul(mesh.copy(x, "tp"), mesh.copy(gamma, "tp"), w,
                        x.dtype, norm_impl, seg=remat)


def _dense_trunk(cfg, params, tokens, mesh, attn_fn, plan, heads,
                 norm_impl: str, positions=None):
    """The Megatron-TP trunk: ``[bl, S, D]``, whole on every tp rank;
    ``positions`` ``[bl, S]`` (a packed row's per-document positions) for
    rope and the learned table."""
    x = mesh.all_gather(embed_tokens(cfg, params, tokens, positions), "tp",
                        2, replicated_grad=True)
    for i in range(cfg.n_layers):
        layer = layer_params(params["blocks"], i)
        qkv = mesh.columns(_tp_norm_matmul(x, layer["ln1"], layer["wqkv"],
                                           mesh, norm_impl), "tp", plan)
        out = remat(_attn_core, cfg, qkv, attn_fn, positions, heads)
        x = x + mesh.reduce(matmul_any(out, layer["wo"], x.dtype), "tp")
        h = F.gelu(_tp_norm_matmul(x, layer["ln2"], layer["w1"], mesh,
                                   norm_impl), approximate="tanh")
        x = x + mesh.reduce(matmul_any(h, layer["w2"], x.dtype), "tp")
    return x


def vocab_parallel_nll(logits, targets, mesh, label_smoothing: float = 0.0,
                       z_loss: float = 0.0):
    """Per-token NLL ``[bl, S, 1]`` from this rank's vocab shard of the
    fp32 logits ``[bl, S, V/tp]`` (rank r holds columns ``r·V/tp`` on):
    ``lse − target logit`` with ``lse = max + log(Σ exp(logits − max))``,
    the max all-reduced without a gradient, the exp sums and the target
    logit (from the rank that holds it) psummed; label smoothing's mean
    logit is the psum of the shards' sums over V (``train.regularized``)."""
    vl = logits.shape[-1]
    m = mesh.pmax(logits.amax(dim=-1, keepdim=True), "tp")
    total = mesh.reduce(torch.exp(logits - m).sum(dim=-1, keepdim=True),
                        "tp")
    off = targets - mesh.axis_index("tp") * vl
    hit = ((off >= 0) & (off < vl))[..., None]
    picked = logits.gather(-1, off.clamp(0, vl - 1)[..., None])
    target = mesh.reduce(torch.where(hit, picked, torch.zeros_like(picked)),
                         "tp")
    lse = m + torch.log(total)
    return regularized(
        lse - target, lse,
        lambda: mesh.reduce(logits.sum(dim=-1, keepdim=True), "tp")
        / (vl * mesh.axis_size("tp")), label_smoothing, z_loss)


def _lse_combine(mesh):
    """The chunked head's cross-rank combine of each rank's stats over its
    vocab shard: ``lse = m + log(Σ_r exp(lse_r − m))`` with m the max of
    the ``lse_r`` (no gradient), and the target logit from its owner."""
    def combine(lse, t):
        m = mesh.pmax(lse, "tp")
        return (m + torch.log(mesh.reduce(torch.exp(lse - m), "tp")),
                mesh.reduce(t, "tp"))
    return combine


def _chunked_head(h, params, targets, mesh):
    """The chunked head (``train._ChunkedNLL``) on the normed rows ``h``
    ``[bl, S, D]``: untied, each rank streams its own vocab shard of
    ``unembed`` ``[D, V/tp]`` in chunks and the stats combine across tp
    (:func:`_lse_combine`); tied, each chunk's partial logits against
    ``embed``'s column shard are psummed over tp before the stream takes
    them.  The backward recomputes each chunk's logits from the global
    lse; the rows' gradient is this rank's part, which the trunk's
    transposes sum over tp."""
    bl, s, d = h.shape
    tp, r = mesh.axis_size("tp"), mesh.axis_index("tp")
    if "unembed" in params:
        w = params["unembed"].to(torch.bfloat16)
        vl = w.shape[1]
        n = vocab_chunks(vl, max(1, CHUNKS // tp))
        nll = _ChunkedNLL.apply(h.reshape(bl * s, d).to(torch.bfloat16), w,
                                targets.reshape(-1) - r * vl, n, dot_f32,
                                _lse_combine(mesh))
        return nll.reshape(bl, s, 1)
    e = params["embed"]                            # [V, D/tp]
    dl = e.shape[1]
    hl = h[..., r * dl:(r + 1) * dl].reshape(bl * s, dl)
    nll = _ChunkedNLL.apply(
        hl.to(torch.bfloat16), e.to(torch.bfloat16).T, targets.reshape(-1),
        vocab_chunks(e.shape[0], CHUNKS),
        lambda a, b: mesh.reduce(dot_f32(a, b), "tp"))
    return nll.reshape(bl, s, 1)


def _head_nll(params, x, targets, mesh, fc: bool, head_impl: str,
              label_smoothing: float, z_loss: float):
    """ln_f on every row of x ``[bl, S, D]`` and the NLL through the
    untied head's vocab shard or the tied head's partial logits, dense or
    chunked."""
    gain = params["ln_f"]
    if not fc:
        x, gain = mesh.copy(x, "tp"), mesh.copy(gain, "tp")
    h = _rmsnorm(x, gain)
    if head_impl == "chunked":
        return _chunked_head(h, params, targets, mesh)
    if "unembed" in params:
        logits = matmul_any(h, params["unembed"], torch.bfloat16).float()
        return vocab_parallel_nll(logits, targets, mesh, label_smoothing,
                                  z_loss)
    e = params["embed"]                            # [V, D/tp]
    dl, r = e.shape[1], mesh.axis_index("tp")
    hl = h[..., r * dl:(r + 1) * dl].to(torch.bfloat16)
    part = dot_f32(hl.reshape(-1, dl), e.to(torch.bfloat16).T)
    logits = mesh.reduce(part, "tp").to(torch.bfloat16).float()
    logits = logits.reshape(*h.shape[:-1], -1)
    if label_smoothing or z_loss:
        return smoothed_nll(logits, targets, label_smoothing, z_loss)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None])


def psum_grads(mesh, grads: list, leaves: list, over: list,
               scale: float = 1) -> list:
    """Each gradient of ``grads`` summed over the mesh axes ``over[i]``
    names and divided by ``scale``, in ``leaves[i]``'s shape and dtype:
    one flat fp32 psum for each set of leaves summed over the same axes
    (the same bits on every process of the set).  Each entry of
    ``grads`` is set to ``None`` once it is in its set's flat buffer, so
    a step holds its gradients in one copy at a time (a caller that
    keeps no other reference lets them go)."""
    out = [None] * len(leaves)
    for axes in dict.fromkeys(over):
        idx = [i for i, a in enumerate(over) if a == axes]
        if scale == 1 and all(mesh.axis_size(a) == 1
                              for a in axes_of(axes)):
            for i in idx:          # one rank on each axis: nothing to sum
                out[i] = grads[i].float().to(leaves[i].dtype)
            continue
        flat = torch.cat([grads[i].reshape(-1).float() for i in idx])
        for i in idx:
            grads[i] = None
        flat = mesh.psum(flat, axes)
        if scale != 1:
            flat = flat / scale
        at = 0
        for i in idx:
            p = leaves[i]
            out[i] = flat[at:at + p.numel()].reshape(p.shape).to(p.dtype)
            at += p.numel()
    return out


def _tp_layout(cfg, mesh, what: str) -> tuple:
    """``(batch axes, plan, heads)`` of a DP×TP process mesh: the batch
    axes' names, the fused projection's :func:`head_columns` recut as
    this rank's :class:`mesh.ColumnPlan`, and ``(q heads, k/v heads)``
    this rank holds.  ``ValueError`` unless the mesh holds batch axes and
    "tp" only."""
    batch = axes_of(mesh.batch_axes())
    if "tp" not in mesh.axes or set(mesh.axes) - set(batch) - {"tp"}:
        raise ValueError(f"the {what}'s mesh holds batch axes and 'tp' "
                         f"only, got {mesh.axes}")
    tp = mesh.axis_size("tp")
    src, dst, kv = head_columns(cfg, tp)
    return (batch, mesh.column_plan("tp", src, dst),
            (cfg.n_heads // tp, len(kv[mesh.axis_index("tp")])))


def process_packed_loss(cfg, params, tokens, segment_ids, positions, mesh,
                        head_impl: str = "dense",
                        label_smoothing: float = 0.0, z_loss: float = 0.0):
    """``train.packed_loss_fn`` on a DP×TP ``ProcessMesh``: ``params`` this
    process's shards (``train.param_shardings``), the packed ``[B, S+1]``
    tokens, segment ids and positions global, the same on every process
    (``data.pack_documents``), their rows cut over the batch axes.  The
    dense TP trunk takes the segment mask on this rank's heads and rope
    (or the learned table) at the per-document positions; the NLL is
    vocab-parallel, masked where the next token leaves its document, its
    sum psummed over the batch axes and divided by the global count of
    valid tokens: the same scalar on every process (differentiable, as
    :func:`make_process_grads`' loss)."""
    batch, plan, heads = _tp_layout(cfg, mesh, "packed loss")
    if head_impl not in ("dense", "chunked"):
        raise ValueError(f"unknown head_impl {head_impl!r}")
    b_shard = batch_sharding(mesh)
    tok, seg, pos = (mesh.shard(t, b_shard)
                     for t in (tokens, segment_ids, positions))
    attn_fn = partial(_causal_dense_attention, segment_ids=seg[:, :-1])
    x = _dense_trunk(cfg, params, tok[:, :-1], mesh, attn_fn, plan, heads,
                     "dense", positions=pos[:, :-1])
    nll = _head_nll(params, x, tok[:, 1:].long(), mesh, False, head_impl,
                    label_smoothing, z_loss)
    valid = ((seg[:, :-1] == seg[:, 1:]) & (seg[:, :-1] > 0)).float()
    total = mesh.psum((nll[..., 0] * valid).sum(), batch)
    return total / mesh.psum(valid.sum(), batch).clamp(min=1.0)


def make_process_grads(cfg, mesh, attn_impl: str, head_impl: str,
                       accum_steps: int, norm_impl: str, matmul_impl: str,
                       label_smoothing: float = 0.0, z_loss: float = 0.0):
    """``(grads, p_shard, b_shard)`` on a ``ProcessMesh`` with a "tp" axis
    and batch axes ("dcn", "dp"): ``grads(params, tokens) -> (loss,
    grads)`` takes this process's shards of the parameters (cut by
    ``p_shard``) and the global ``[B, S+1]`` window batch, the same on
    every process, which it cuts by ``b_shard``; ``accum_steps`` equal
    microbatches of B / accum_steps global rows run one after another, as
    in ``train.grads_fn``.  ``grads`` is a tree like ``params`` of this
    process's shards of the gradient of the global mean loss, summed
    over the batch axes (one flat fp32 psum a set of leaves), the same
    bits on every process that holds a shard.  ``label_smoothing`` and
    ``z_loss`` need the dense head, as on one device."""
    if head_impl not in ("dense", "chunked"):
        raise ValueError(f"unknown head_impl {head_impl!r}")
    if head_impl == "chunked" and (label_smoothing or z_loss):
        raise NotImplementedError(CHUNKED_REFUSES)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    batch, plan, heads = _tp_layout(cfg, mesh, "DP×TP step")
    attn_fn = attn_impl_fn(attn_impl)
    p_shard, b_shard = param_shardings(cfg, mesh), batch_sharding(mesh)
    tp = mesh.axis_size("tp")
    everywhere = tuple(mesh.axis_names)

    def micro_grads(live, leaves, tokens, fc):
        tok = mesh.shard(tokens, b_shard)
        if fc:
            x = _fc_trunk(cfg, live, tok[:, :-1], mesh, attn_fn, plan, heads)
        else:
            x = _dense_trunk(cfg, live, tok[:, :-1], mesh, attn_fn, plan,
                             heads, norm_impl)
        nll = _head_nll(live, x, tok[:, 1:].long(), mesh, fc, head_impl,
                        label_smoothing, z_loss).sum()
        count = mesh.psum(torch.tensor(float(x.shape[0] * x.shape[1]),
                                       device=x.device), batch)
        g = list(torch.autograd.grad(nll / count, leaves))
        return mesh.psum(nll.detach(), batch) / count, g

    def grads(params, tokens):
        mesh.check_device(tokens, *tree_leaves(params))
        b, s1 = tokens.shape
        if b % accum_steps:
            raise ValueError(f"batch {b} must be divisible by accum_steps "
                             f"{accum_steps}")
        fc = matmul_impl == "fused_collective" and fc_admitted(cfg, s1 - 1,
                                                               tp)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        loss, g_sum = 0.0, None
        for micro in tokens.reshape(accum_steps, b // accum_steps, s1):
            part, g = micro_grads(live, leaves, micro, fc)
            loss = loss + part
            g_sum = g if g_sum is None else [a + c for a, c in zip(g_sum, g)]
        # summed over the batch axes, and over tp too for the leaves the
        # fused path holds whole but differentiates over its own rows only
        specs = tree_leaves(tree_like(params, p_shard))
        over = [everywhere if fc and "tp" not in
                {a for e in spec for a in axes_of(e)} else batch
                for spec in specs]
        out = psum_grads(mesh, g_sum, leaves, over, accum_steps)
        return loss / accum_steps, tree_unflatten(params, out)

    return grads, p_shard, b_shard


def make_process_sharded_train_step(cfg, mesh, lr: float, attn_impl: str,
                                    head_impl: str, accum_steps: int,
                                    norm_impl: str, matmul_impl: str):
    """``(step, p_shard, b_shard)`` of ``train.make_sharded_train_step`` on
    a ``ProcessMesh``: ``step(params, tokens) -> (params, loss)`` takes
    and returns this process's shards (:func:`make_process_grads`), each
    ``p − lr·g``."""
    grads, p_shard, b_shard = make_process_grads(
        cfg, mesh, attn_impl, head_impl, accum_steps, norm_impl, matmul_impl)

    def step(params, tokens):
        loss, g = grads(params, tokens)
        return tree_unflatten(params, [
            p.detach() - lr * gi
            for p, gi in zip(tree_leaves(params), tree_leaves(g))]), loss

    return step, p_shard, b_shard


def make_process_optax_train_step(cfg, mesh, optimizer, attn_impl: str,
                                  head_impl: str, accum_steps: int,
                                  label_smoothing: float, z_loss: float,
                                  zero1: bool, norm_impl: str,
                                  matmul_impl: str):
    """``(step, init_opt_state, p_shard, b_shard)`` of ``train.
    make_optax_train_step`` on a ``ProcessMesh``: the gradient shards of
    :func:`make_process_grads`, then ``optimizer.update`` on this
    process's shards (``optim.ProcessMomentLayout``: the clip's norm over
    the global tree, and under ZeRO-1 the moments cut over "dp" with the
    updates gathered over the "dp" line).  ``step(params, opt_state,
    tokens) -> (params, opt_state, loss)`` updates ``params`` in place, as
    the one-device step does."""
    grads, p_shard, b_shard = make_process_grads(
        cfg, mesh, attn_impl, head_impl, accum_steps, norm_impl, matmul_impl,
        label_smoothing, z_loss)
    _, init_opt_state = opt_state_shardings(optimizer, param_shapes(cfg),
                                            p_shard, mesh, zero1=zero1)

    def step(params, opt_state, tokens):
        loss, g = grads(params, tokens)
        return params, optimizer.update(params, g, opt_state), loss

    return step, init_opt_state, p_shard, b_shard


def cut_adapters(lora: dict, mesh, p_shard: dict) -> dict:
    """The replicated LoRA adapters cut, inside autograd, to this
    process's counterpart of its base shards (``p_shard``,
    ``train.param_shardings``): where the base ``[L, K, N]`` is cut over
    its columns N (``wqkv``, ``w1``) ``b [L, r, N]`` takes the same
    columns and ``a`` stays whole; where it is cut over its rows K
    (``wo``, ``w2``) ``a [L, K, r]`` takes the same rows and ``b`` stays
    whole.  Each process's adapter gradient is then a slice or a partial
    sum of the whole one."""
    out = {}
    for name, ab in lora["blocks"].items():
        lead, pk, pn = (tuple(p_shard["blocks"][name]) + (None,) * 3)[:3]
        out[name] = {"a": mesh.shard(ab["a"], (lead, pk, None)),
                     "b": mesh.shard(ab["b"], (lead, None, pn))}
    return {"blocks": out}


def make_process_lora_train_step(cfg, mesh, lcfg, optimizer, attn_impl: str,
                                 head_impl: str):
    """``(step, init_opt_state, lcfg, shardings)`` of
    ``lora.make_lora_train_step`` on a dp×tp ``ProcessMesh``:
    ``step(base, lora, opt_state, tokens, base_specs=None) -> (lora,
    opt_state, loss)`` takes this process's shards of the frozen base,
    cut by ``base_specs`` (default ``shardings["params"]``,
    ``train.param_shardings``; an int8 or int4 base cut by
    ``quant.serving_param_shardings`` passes that tree), the replicated
    adapters and the global ``[B, S+1]`` window batch, the same on every
    process.  The trunk is the Megatron dense trunk (the GSPMD layout of
    the reference's step) over ``lora.wrap_lora`` of the base shards, read
    through ``quant.local_serving_tree``, and of the adapters cut by
    :func:`cut_adapters`.  Each process differentiates its share of the
    global mean loss with respect to the whole adapters; its gradient is
    a slice (the cut factor) or a partial sum (the whole factor, and
    every factor over its dp rows), so the adapter gradients are summed
    over every mesh axis, dp and tp, in one flat fp32 psum
    (:func:`psum_grads`), the same bits on every process.  The optimizer
    then updates the replicated adapters alike everywhere; the base gets
    no gradient and no moments."""
    from tpu_dra_torch.workloads.lora import lora_shardings, wrap_lora
    from tpu_dra_torch.workloads.quant import local_serving_tree
    batch, plan, heads = _tp_layout(cfg, mesh, "LoRA step")
    if head_impl not in ("dense", "chunked"):
        raise ValueError(f"unknown head_impl {head_impl!r}")
    attn_fn = attn_impl_fn(attn_impl)
    p_shard, b_shard = param_shardings(cfg, mesh), batch_sharding(mesh)
    everywhere = tuple(mesh.axis_names)

    def step(base, lora, opt_state, tokens, base_specs=None):
        mesh.check_device(tokens, *tree_leaves(base), *tree_leaves(lora))
        tok = mesh.shard(tokens, b_shard)
        leaves = [t.detach().requires_grad_() for t in tree_leaves(lora)]
        live = wrap_lora(local_serving_tree(mesh, base,
                                            base_specs or p_shard),
                         cut_adapters(tree_unflatten(lora, leaves), mesh,
                                      p_shard), lcfg)
        x = _dense_trunk(cfg, live, tok[:, :-1], mesh, attn_fn, plan, heads,
                         "dense")
        nll = _head_nll(live, x, tok[:, 1:].long(), mesh, False, head_impl,
                        0.0, 0.0).sum()
        count = mesh.psum(torch.tensor(float(x.shape[0] * x.shape[1]),
                                       device=x.device), batch)
        g = list(torch.autograd.grad(nll / count, leaves))
        grads = psum_grads(mesh, g, leaves, [everywhere] * len(leaves))
        opt_state = optimizer.update(lora, tree_unflatten(lora, grads),
                                     opt_state)
        return lora, opt_state, mesh.psum(nll.detach(), batch) / count

    shardings = {"params": p_shard, "batch": b_shard,
                 "lora": lambda lora: lora_shardings(lora, mesh)}
    return step, optimizer.init, lcfg, shardings
