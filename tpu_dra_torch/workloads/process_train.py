"""The DP×TP train step on a ``mesh.ProcessMesh``, one process a rank:
what ``train.make_sharded_train_step`` builds when its mesh is a process
mesh (the reference's ``make_sharded_train_step``, 726-753, on a mesh
whose devices belong to many processes).

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
column shard, psummed.  The loss is the psum over the batch axes of the
NLL sums over the psum of the token counts (each row counted once, not
once a tp rank).  Each rank differentiates its own share of that
global mean, so the gradients summed over the batch axes (and over tp
for the norm gains the fused path holds a row share of) are the
gradient of the global mean, with no rank-count factor, as the
reference's GSPMD step; every process ends with the same bits in each
replicated leaf.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_dra_torch.workloads.collective_matmul import (
    ProcessAllGatherMatmul, ProcessMatmulReduceScatter)
from tpu_dra_torch.workloads.mesh import axes_of
from tpu_dra_torch.workloads.quant import matmul_any
from tpu_dra_torch.workloads.train import (_attn_core, _norm_matmul,
                                           _rmsnorm, attn_impl_fn,
                                           batch_sharding, dot_f32,
                                           embed_tokens, fc_splits,
                                           layer_params, param_shardings,
                                           remat, tree_leaves, tree_like,
                                           tree_unflatten)


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
                 norm_impl: str):
    """The Megatron-TP trunk: ``[bl, S, D]``, whole on every tp rank."""
    x = mesh.all_gather(embed_tokens(cfg, params, tokens), "tp", 2,
                        replicated_grad=True)
    for i in range(cfg.n_layers):
        layer = layer_params(params["blocks"], i)
        qkv = mesh.columns(_tp_norm_matmul(x, layer["ln1"], layer["wqkv"],
                                           mesh, norm_impl), "tp", plan)
        out = remat(_attn_core, cfg, qkv, attn_fn, None, heads)
        x = x + mesh.reduce(matmul_any(out, layer["wo"], x.dtype), "tp")
        h = F.gelu(_tp_norm_matmul(x, layer["ln2"], layer["w1"], mesh,
                                   norm_impl), approximate="tanh")
        x = x + mesh.reduce(matmul_any(h, layer["w2"], x.dtype), "tp")
    return x


def vocab_parallel_nll(logits, targets, mesh):
    """Per-token NLL ``[bl, S, 1]`` from this rank's vocab shard of the
    fp32 logits ``[bl, S, V/tp]`` (rank r holds columns ``r·V/tp`` on):
    ``max + log(Σ exp(logits − max)) − target logit``, the max
    all-reduced without a gradient, the exp sums and the target logit
    (from the rank that holds it) psummed."""
    vl = logits.shape[-1]
    m = mesh.pmax(logits.amax(dim=-1, keepdim=True), "tp")
    total = mesh.reduce(torch.exp(logits - m).sum(dim=-1, keepdim=True),
                        "tp")
    off = targets - mesh.axis_index("tp") * vl
    hit = ((off >= 0) & (off < vl))[..., None]
    picked = logits.gather(-1, off.clamp(0, vl - 1)[..., None])
    target = mesh.reduce(torch.where(hit, picked, torch.zeros_like(picked)),
                         "tp")
    return m + torch.log(total) - target


def _head_nll(params, x, targets, mesh, fc: bool):
    """ln_f on every row of x ``[bl, S, D]`` and the NLL through the
    untied head's vocab shard or the tied head's partial logits."""
    gain = params["ln_f"]
    if not fc:
        x, gain = mesh.copy(x, "tp"), mesh.copy(gain, "tp")
    h = _rmsnorm(x, gain)
    if "unembed" in params:
        logits = matmul_any(h, params["unembed"], torch.bfloat16).float()
        return vocab_parallel_nll(logits, targets, mesh)
    e = params["embed"]                            # [V, D/tp]
    dl, r = e.shape[1], mesh.axis_index("tp")
    hl = h[..., r * dl:(r + 1) * dl].to(torch.bfloat16)
    part = dot_f32(hl.reshape(-1, dl), e.to(torch.bfloat16).T)
    logits = mesh.reduce(part, "tp").to(torch.bfloat16).float()
    logp = torch.log_softmax(logits.reshape(*h.shape[:-1], -1), dim=-1)
    return -logp.gather(-1, targets[..., None])


def make_process_sharded_train_step(cfg, mesh, lr: float, attn_impl: str,
                                    head_impl: str, accum_steps: int,
                                    norm_impl: str, matmul_impl: str):
    """``(step, p_shard, b_shard)`` of ``train.make_sharded_train_step`` on
    a ``ProcessMesh`` with a "tp" axis and batch axes ("dcn", "dp"):
    ``step(params, tokens) -> (params, loss)`` takes and returns this
    process's shards of the parameters (cut by ``p_shard``) and the
    global ``[B, S+1]`` window batch, the same on every process, which it
    cuts by ``b_shard``; ``accum_steps`` equal microbatches of B /
    accum_steps global rows run one after another, as in
    ``train.grads_fn``.  ``head_impl="chunked"`` raises
    ``NotImplementedError``."""
    if head_impl == "chunked":
        raise NotImplementedError(
            "head_impl='chunked' on a ProcessMesh is not ported yet "
            "(ROADMAP.md §2, item 1)")
    if head_impl != "dense":
        raise ValueError(f"unknown head_impl {head_impl!r}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    batch = axes_of(mesh.batch_axes())
    if "tp" not in mesh.axes or set(mesh.axes) - set(batch) - {"tp"}:
        raise ValueError(f"the DP×TP step's mesh holds batch axes and 'tp' "
                         f"only, got {mesh.axes}")
    attn_fn = attn_impl_fn(attn_impl)
    p_shard, b_shard = param_shardings(cfg, mesh), batch_sharding(mesh)
    tp = mesh.axis_size("tp")
    src, dst, kv = head_columns(cfg, tp)
    plan = mesh.column_plan("tp", src, dst)
    heads = (cfg.n_heads // tp, len(kv[mesh.axis_index("tp")]))
    everywhere = tuple(mesh.axis_names)

    def grads(live, leaves, tokens, fc):
        tok = mesh.shard(tokens, b_shard)
        if fc:
            x = _fc_trunk(cfg, live, tok[:, :-1], mesh, attn_fn, plan, heads)
        else:
            x = _dense_trunk(cfg, live, tok[:, :-1], mesh, attn_fn, plan,
                             heads, norm_impl)
        nll = _head_nll(live, x, tok[:, 1:].long(), mesh, fc).sum()
        count = mesh.psum(torch.tensor(float(x.shape[0] * x.shape[1]),
                                       device=x.device), batch)
        g = torch.autograd.grad(nll / count, leaves)
        return mesh.psum(nll.detach(), batch) / count, g

    def step(params, tokens):
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
            part, g = grads(live, leaves, micro, fc)
            loss = loss + part
            g_sum = g if g_sum is None else [a + c for a, c in zip(g_sum, g)]
        # one flat fp32 psum for each set of leaves summed over the same
        # axes: the batch axes, and tp too for the leaves the fused path
        # holds whole but differentiates over its own rows only
        specs = tree_leaves(tree_like(params, p_shard))
        over = [everywhere if fc and "tp" not in
                {a for e in spec for a in axes_of(e)} else batch
                for spec in specs]
        new = [None] * len(leaves)
        for axes in dict.fromkeys(over):
            idx = [i for i, a in enumerate(over) if a == axes]
            flat = torch.cat([g_sum[i].reshape(-1).float() for i in idx])
            flat = mesh.psum(flat, axes) / accum_steps
            at = 0
            for i in idx:
                p = leaves[i]
                g = flat[at:at + p.numel()].reshape(p.shape).to(p.dtype)
                new[i] = p.detach() - lr * g
                at += p.numel()
        return tree_unflatten(params, new), loss / accum_steps

    return step, p_shard, b_shard
