"""Ring attention, sequence parallelism over a mesh axis, ported from
``tpu_dra/workloads/ring_attention.py`` onto the virtual mesh
(``mesh.py``).

What maps to what:

- ``_hop`` (49) and ``_check_hop_impl`` (62): one kv hop around the ring,
  ``hop_impl="pallas"`` through the ring-shift kernel
  (``collective_matmul.RingShift``, row #11), ``"xla"`` through the plain
  ``mesh.ppermute``;
- ``_block_attn`` (68) and ``ring_attention`` (173): the fp32 engine, a
  running (m, l, acc) online softmax over the ring's kv blocks;
- ``_merge_partials`` (91) and ``ring_attention_flash`` (109): the flash
  engine, one ``flash.flash_attention_with_lse`` per block and base-2
  logsumexp merges;
- ``make_ring_attention`` (240) and ``make_ring_attention_flash`` (161):
  the ``shard_map``-wrapped forms over ``[B, H, S, D]``;
- ``_sp_trunk`` (409) and ``make_ring_train_step`` (446): the DP×SP SGD
  step.

The engines take q, k, v in the ring layout ``[G, n, B, H, S/n, D]``: the
ring's n ranks on dimension 1 and the data-parallel groups on dimension 0.
Where the reference branches per device (``lax.cond`` on ``src < idx``),
the port computes the ranks that fold at a step together: at ring step t
those are ranks t..n−1, one flash launch for all of them, and the other
ranks' partials pass through.  The zigzag engines (256-403) are not ported
here: they call ``ppermute`` directly and run no kernel.
"""

from __future__ import annotations

import torch

from tpu_dra_torch.workloads.mesh import axes_of, ppermute, psum

HOP_IMPLS = ("xla", "pallas")
RING_IMPLS = ("xla", "flash")
_NEG = torch.finfo(torch.float32).min


def _hop(x, hop_impl: str):
    """One kv ring hop of ``[G, n, ...]`` blocks: rank r's block moves to
    rank r + 1."""
    if hop_impl == "pallas":
        from tpu_dra_torch.workloads.collective_matmul import RingShift
        return RingShift.apply(x, False)
    return ppermute(x, 1, 1)


def _check_hop_impl(hop_impl: str) -> None:
    if hop_impl not in HOP_IMPLS:
        raise ValueError(f"unknown hop_impl {hop_impl!r}; expected 'xla' or "
                         f"'pallas'")


def _block_attn(q, k, v, m, l, acc, mask, scale: float):
    """One online-softmax step against one k/v block, all fp32: q
    ``[..., Sq, D]``, k/v ``[..., Sk, D]``, m/l ``[..., Sq]``, acc ``[...,
    Sq, D]``, mask broadcastable to ``[..., Sq, Sk]`` (True = attend)."""
    s = (q @ k.transpose(-1, -2)) * scale
    s = torch.where(mask, s, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # rows that have seen nothing yet must not gain weight exp(neg - neg)
    safe_m = torch.where(m_new == _NEG, torch.zeros_like(m_new), m_new)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))
    corr = torch.where(m == _NEG, torch.zeros_like(m), torch.exp(m - safe_m))
    acc = acc * corr[..., None] + p @ v
    l = l * corr + p.sum(dim=-1)
    return m_new, l, acc


def ring_attention(q, k, v, causal: bool = True, hop_impl: str = "xla"):
    """Ring self-attention, the fp32 engine, on ``[G, n, B, H, S, D]``
    sequence shards (k/v may carry fewer heads: GQA repeats them at attend
    time only, so the ring moves the shared heads).  Step t attends each
    rank's q block to the k/v block that came from rank ``(idx − t) mod
    n``, then hops the blocks one rank on; causality is block-granular
    (the diagonal block masked within, future blocks fully masked, their
    work still done, as the reference does).  Returns q's dtype."""
    _check_hop_impl(hop_impl)
    G, n, B, H, S, D = q.shape
    grp = H // k.shape[3]

    def rep(t):
        return (t.repeat_interleave(grp, dim=3) if grp > 1 else t).float()
    scale = D ** -0.5
    qf = q.float()
    idx = torch.arange(n, device=q.device)
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]

    def block_mask(src):
        if not causal:
            return torch.ones((S, S), dtype=torch.bool, device=q.device)
        rel = (src - idx)[:, None, None]                 # per rank
        mask = torch.where(rel == 0, rows >= cols, rel < 0)
        return mask[None, :, None, None]                 # [1, n, 1, 1, S, S]

    m = torch.full((G, n, B, H, S), _NEG, device=q.device)
    l = torch.zeros((G, n, B, H, S), device=q.device)
    acc = torch.zeros((G, n, B, H, S, D), device=q.device)
    m, l, acc = _block_attn(qf, rep(k), rep(v), m, l, acc, block_mask(idx),
                            scale)
    for t in range(1, n):
        k = _hop(k, hop_impl)
        v = _hop(v, hop_impl)
        m, l, acc = _block_attn(qf, rep(k), rep(v), m, l, acc,
                                block_mask((idx - t) % n), scale)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def _merge_partials(out_a, l2_a, out_b, l2_b):
    """Two normalized partial attentions over disjoint key sets combined
    by their base-2 logsumexps: ``w_x = 2^(l2_x − max)``, out = the
    w-weighted mean (fp32, returned in out_a's dtype), l2 = max +
    log2(w_a + w_b)."""
    m = torch.maximum(l2_a, l2_b)
    w_a = torch.exp2(l2_a - m)[..., None]
    w_b = torch.exp2(l2_b - m)[..., None]
    tot = w_a + w_b
    out = (w_a * out_a.float() + w_b * out_b.float()) / tot
    return out.to(out_a.dtype), m + torch.log2(tot[..., 0])


def _flash_partial(q, k, v, causal: bool):
    """``flash_attention_with_lse`` over ``[G, n', B, H, S, D]`` blocks:
    one launch for all the ranks given."""
    from tpu_dra_torch.workloads.flash import flash_attention_with_lse
    lead = q.shape[:3]
    out, l2 = flash_attention_with_lse(
        q.reshape(-1, *q.shape[3:]), k.reshape(-1, *k.shape[3:]),
        v.reshape(-1, *v.shape[3:]), causal=causal)
    return out.reshape(*lead, *out.shape[1:]), l2.reshape(*lead,
                                                          *l2.shape[1:])


def ring_attention_flash(q, k, v, causal: bool = True,
                         hop_impl: str = "xla"):
    """Ring self-attention with the flash kernels as the per-block engine
    (forward and backward), on ``[G, n, B, H, S, D]`` shards: each step
    computes a normalized partial and its logsumexp and folds it in with
    :func:`_merge_partials`.  The local block runs causal; under causal
    attention step t folds the block from rank ``(idx − t) mod n`` only
    where that rank precedes, which is ranks idx ≥ t, computed together;
    without it every rank folds every step."""
    _check_hop_impl(hop_impl)
    n = q.shape[1]
    out, l2 = _flash_partial(q, k, v, causal)        # local (diagonal)
    for t in range(1, n):
        k = _hop(k, hop_impl)
        v = _hop(v, hop_impl)
        lo = t if causal else 0
        ob, lb = _flash_partial(q[:, lo:], k[:, lo:], v[:, lo:], False)
        mo, ml = _merge_partials(out[:, lo:], l2[:, lo:], ob, lb)
        out = torch.cat([out[:, :lo], mo], dim=1)
        l2 = torch.cat([l2[:, :lo], ml], dim=1)
    return out.to(q.dtype)


def _make(engine, mesh, axis_name: str, causal: bool, hop_impl: str):
    _check_hop_impl(hop_impl)
    G, n = mesh.ring_groups(axis_name)
    spec = (mesh.batch_axes(), None, axis_name, None)

    def attend(q, k, v):
        mesh.check_device(q, k, v)

        def ring(t):
            s = mesh.shard(t, spec)
            return s.reshape(G, n, *s.shape[len(mesh.axes):])
        out = engine(ring(q), ring(k), ring(v), causal=causal,
                     hop_impl=hop_impl)
        return mesh.unshard(out.reshape(*mesh.shape, *out.shape[2:]), spec)
    return attend


def make_ring_attention(mesh, *, axis_name: str = "sp", causal: bool = True,
                        hop_impl: str = "xla"):
    """:func:`ring_attention` over global ``[B, H, S, D]`` q/k/v on the
    mesh's device whose S axis is cut over ``axis_name`` (the mesh's last
    axis; the batch over :meth:`Mesh.batch_axes`), as the reference's
    ``shard_map`` wrapper.  The reference cuts the batch over "dp" alone;
    on a mesh with a "dcn" axis too that changes which ranks compute
    which rows, not the result."""
    return _make(ring_attention, mesh, axis_name, causal, hop_impl)


def make_ring_attention_flash(mesh, *, axis_name: str = "sp",
                              causal: bool = True, hop_impl: str = "xla"):
    """:func:`ring_attention_flash` over global ``[B, H, S, D]`` arrays
    (see :func:`make_ring_attention`)."""
    return _make(ring_attention_flash, mesh, axis_name, causal, hop_impl)


# --------------------------------------------------------------------------
# The sequence-parallel train step
# --------------------------------------------------------------------------


def _ring_attn_fn(engine, G: int, n: int, hop_impl: str):
    """An ``attn_fn`` for ``train._block`` over ``[G·n·B, H, S, D]`` rows
    (rank-major): the ring engine on the ``[G, n, B, ...]`` view."""
    def attn(q, k, v):
        def ring(t):
            return t.reshape(G, n, -1, *t.shape[1:])
        out = engine(ring(q), ring(k), ring(v), causal=True,
                     hop_impl=hop_impl)
        return out.reshape(q.shape)
    return attn


def _sp_trunk(cfg, params, tokens, ring_impl: str = "xla",
              hop_impl: str = "xla"):
    """Embed + decoder stack on sequence shards: ``[G, n, B, S/n]``
    tokens → ``[G, n, B, S/n, D]`` pre-final-norm activations, the block
    of ``train._block`` with ring attention swapped in.  Learned positions
    are the rows from the rank's global offset ``idx·S/n`` (the
    reference's ``dynamic_slice``, which clamps the start into the table);
    rope rotates by the global positions.

    No remat: the reference wraps each block in ``jax.checkpoint`` (442),
    which recomputes the forward (and its kv hops) in the backward; the
    port keeps the activations, as its one-device trunk does, so a step
    runs 2·(n−1) kv shifts per layer forward and as many in the backward."""
    from tpu_dra_torch.workloads.train import _block, embed_rows, layer_params
    if ring_impl not in RING_IMPLS:
        raise ValueError(f"unknown ring_impl {ring_impl!r}; expected 'xla' "
                         f"or 'flash'")
    _check_hop_impl(hop_impl)
    G, n, B, S = tokens.shape
    dev = tokens.device
    x = embed_rows(params["embed"], tokens)              # [G, n, B, S, D]
    start = torch.arange(n, device=dev) * S
    positions = None
    if cfg.pos_emb == "learned":
        start = start.clamp(max=max(cfg.max_seq - S, 0))
        rows = start[:, None] + torch.arange(S, device=dev)
        x = x + params["pos"].to(torch.bfloat16)[rows][None, :, None]
    else:
        rows = start[:, None] + torch.arange(S, device=dev)   # [n, S]
        positions = rows[None, :, None].expand(G, n, B, S).reshape(-1, S)
    engine = ring_attention_flash if ring_impl == "flash" else ring_attention
    attn = _ring_attn_fn(engine, G, n, hop_impl)
    x = x.reshape(G * n * B, S, -1)
    for i in range(cfg.n_layers):
        x = _block(cfg, x, layer_params(params["blocks"], i), attn_fn=attn,
                   positions=positions)
    return x.reshape(G, n, B, S, -1)


def make_ring_train_step(cfg, mesh, lr: float = 1e-2, axis_name: str = "sp",
                         ring_impl: str = "xla", hop_impl: str = "xla"):
    """The DP×SP SGD step (``ring_attention.make_ring_train_step``,
    446-503): ``(step, token_spec)`` with ``step(params, tokens, targets)
    -> (params, loss)``; tokens and targets ``[B, S]`` on the mesh's
    device (inputs anywhere else raise ``ValueError``), cut ``(("dcn",
    "dp"), axis_name)``, the parameters whole.  The caller shifts the
    targets globally, so the next-token pairs across shard boundaries stay
    right.

    The loss is the global mean: each rank's summed NLL over the psum of
    the token counts.  As in the reference, every rank differentiates its
    own replica of that loss and the gradients are summed over the mesh
    (486-497); the reference's psum transposes to a psum there, so its
    update carries a factor of the mesh's rank count over the gradient of
    the mean loss (4.0 on a dp × sp = 2 × 2 mesh with jax 0.9.0), and so
    does the port's, which holds to it in the tests."""
    from tpu_dra_torch.workloads.train import (head_nll, tree_leaves,
                                               tree_unflatten)
    batch = mesh.batch_axes()
    extra = set(mesh.axes) - set(axes_of(batch)) - {axis_name}
    if extra:
        raise ValueError(f"the ring step's mesh holds batch axes and "
                         f"{axis_name!r} only, got {mesh.axes}")
    if ring_impl not in RING_IMPLS:
        raise ValueError(f"unknown ring_impl {ring_impl!r}; expected 'xla' "
                         f"or 'flash'")
    _check_hop_impl(hop_impl)
    G, n = mesh.ring_groups(axis_name)
    tok_spec = (batch, axis_name)

    def ring(t):
        s = mesh.shard(t, tok_spec)
        return s.reshape(G, n, *s.shape[len(mesh.axes):])

    def step(params, tokens, targets):
        mesh.check_device(tokens, targets, *tree_leaves(params))
        tok, tgt = ring(tokens), ring(targets)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        x = _sp_trunk(cfg, live, tok, ring_impl, hop_impl)
        _, _, B, S, D = x.shape
        nll = head_nll(live, x.reshape(G * n * B, S, D),
                       tgt.reshape(G * n * B, S).long())
        local = nll.reshape(G, n, B * S).sum(dim=-1)     # each rank's sum
        count = torch.full_like(local, float(B * S))
        loss = psum(psum(local, 0), 1) / psum(psum(count, 0), 1)
        grads = torch.autograd.grad(loss.sum(), leaves)
        new = [p.detach() - lr * g for p, g in zip(leaves, grads)]
        return tree_unflatten(params, new), loss[0, 0].detach()

    return step, tok_spec

