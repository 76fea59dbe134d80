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
- ``zigzag_indices`` (258), ``_zigzag_schedule`` (282),
  ``zigzag_ring_attention`` (339), ``zigzag_ring_attention_flash`` (375)
  and ``make_zigzag_ring_attention`` (391): the load-balanced causal ring,
  whose kv hop is the plain ``ppermute``;
- ``_sp_trunk`` (409) and ``make_ring_train_step`` (446): the DP×SP SGD
  step.

On a ``mesh.ProcessMesh`` (one process a rank) the reference's
per-device bodies run as they are: :func:`ring_attention_group` and
:func:`ring_attention_flash_group` on this process's ``[B, H, S/n, D]``
block, hopping through ``collective_matmul.ProcessRing`` (the shift
kernel across processes, or the plain send and receive);
:func:`_zigzag_schedule_group` with its two engines on this process's
``[B, H, 2C, D]`` zigzag block, its own branch of the reference's
``lax.cond`` at each step; the three makers cut the global q/k/v to this
process's block and gather the output back (``ProcessMesh.shard_in``,
``unshard_out``, differentiable); and ``make_ring_train_step`` builds
the per-process step (:func:`_sp_trunk_group`).

The engines take q, k, v in the ring layout ``[G, n, B, H, S/n, D]``: the
ring's n ranks on dimension 1 and the data-parallel groups on dimension 0.
Where the reference branches per device (``lax.cond`` on ``src < idx``),
the port computes the ranks that fold at a step together: at ring step t
those are ranks t..n−1, one flash launch for all of them, and the other
ranks' partials pass through.  The zigzag schedule folds its rank subsets
the same way (:func:`_zigzag_schedule`).
"""

from __future__ import annotations

import torch

from tpu_dra_torch.workloads.mesh import ProcessMesh, axes_of, ppermute, psum

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


# --------------------------------------------------------------------------
# The engines on a process ring: this process's [B, H, S, D] block
# --------------------------------------------------------------------------


def _group_hop(ring, hop_impl: str, *blocks):
    """One kv hop of this process's blocks to rank r + 1 of ``ring``:
    the shift kernel across processes (``"pallas"``) or the plain send
    and receive (``"xla"``), k and v in one autograd node."""
    from tpu_dra_torch.workloads.collective_matmul import ProcessRingShift
    return ProcessRingShift.apply(ring, False, hop_impl == "xla", *blocks)


class _Keep(torch.autograd.Function):
    """``out`` (a copy) that also takes blocks it does not read, whose
    cotangent is zero: a process that folds no block at the last ring step
    still runs the backward of every hop, as its peers do, so that the
    group's shifts meet in the same order."""

    @staticmethod
    def forward(ctx, out, *blocks):
        ctx.like = [(b.shape, b.dtype, b.device) for b in blocks]
        return out.clone()

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(shape, dtype=dtype, device=dev)
                     for shape, dtype, dev in ctx.like))


def ring_attention_group(q, k, v, ring, causal: bool = True,
                         hop_impl: str = "xla"):
    """:func:`ring_attention`, the fp32 engine, as the reference's
    per-device body (173-237) on this process's ``[B, H, S, D]`` block,
    ``ring`` a ``collective_matmul.ProcessRing`` whose rank is the
    block's position in the sequence.  Every step attends (future blocks
    fully masked), so every hop's block is read."""
    _check_hop_impl(hop_impl)
    B, H, S, D = q.shape
    grp = H // k.shape[1]
    n, idx = ring.n, ring.rank

    def rep(t):
        return (t.repeat_interleave(grp, dim=1) if grp > 1 else t).float()
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]

    def block_mask(src):
        if not causal or src < idx:
            return torch.ones((S, S), dtype=torch.bool, device=q.device)
        return rows >= cols if src == idx else \
            torch.zeros((S, S), dtype=torch.bool, device=q.device)
    qf = q.float()
    m = torch.full((B, H, S), _NEG, device=q.device)
    l = torch.zeros((B, H, S), device=q.device)
    acc = torch.zeros((B, H, S, D), device=q.device)
    m, l, acc = _block_attn(qf, rep(k), rep(v), m, l, acc, block_mask(idx),
                            D ** -0.5)
    for t in range(1, n):
        k, v = _group_hop(ring, hop_impl, k, v)
        m, l, acc = _block_attn(qf, rep(k), rep(v), m, l, acc,
                                block_mask((idx - t) % n), D ** -0.5)
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def ring_attention_flash_group(q, k, v, ring, causal: bool = True,
                               hop_impl: str = "xla"):
    """:func:`ring_attention_flash` as the reference's per-device body
    (109-160) on this process's ``[B, H, S, D]`` block: the local block
    causal, then at step t the block from rank ``(idx − t) mod n``, folded
    only where it precedes (t ≤ idx, the reference's ``lax.cond``) under
    causal attention.  So rank idx launches the flash forward 1 + idx
    times a call (n without causality); every rank hops n − 1 times."""
    from tpu_dra_torch.workloads.flash import flash_attention_with_lse
    _check_hop_impl(hop_impl)
    n, idx = ring.n, ring.rank
    out, l2 = flash_attention_with_lse(q, k, v, causal=causal)
    for t in range(1, n):
        k, v = _group_hop(ring, hop_impl, k, v)
        if not causal or t <= idx:
            ob, lb = flash_attention_with_lse(q, k, v, causal=False)
            out, l2 = _merge_partials(out, l2, ob, lb)
    if n > 1:
        out = _Keep.apply(out, k, v)
    return out.to(q.dtype)


def _make_group(engine, mesh, axis_name: str, **kw):
    """:func:`_make` on a ``ProcessMesh``: every process passes the same
    global q/k/v, runs ``engine`` (a per-process body) on its own block
    over the ring of ``axis_name``, and gets the global output back.
    Every process differentiates the same function, so each gets the
    whole gradient of the global inputs."""
    ring = mesh.ring(axis_name)
    spec = (mesh.batch_axes(), None, axis_name, None)

    def attend(q, k, v):
        mesh.check_device(q, k, v)
        out = engine(*(mesh.shard_in(t, spec) for t in (q, k, v)), ring,
                     **kw)
        return mesh.unshard_out(out, spec)
    return attend


def _make(engine, mesh, axis_name: str, group_engine, **kw):
    """``engine`` over global ``[B, H, S, D]`` q/k/v on the mesh's device,
    S cut over ``axis_name`` and the batch over :meth:`Mesh.batch_axes`:
    the reference's ``shard_map`` with ``in_specs`` = ``out_specs`` =
    ``P(batch, None, axis_name, None)``.  On a ``ProcessMesh``,
    ``group_engine`` on this process's block (:func:`_make_group`)."""
    if isinstance(mesh, ProcessMesh):
        return _make_group(group_engine, mesh, axis_name, **kw)
    G, n = mesh.ring_groups(axis_name)
    spec = (mesh.batch_axes(), None, axis_name, None)

    def attend(q, k, v):
        mesh.check_device(q, k, v)

        def ring(t):
            s = mesh.shard(t, spec)
            return s.reshape(G, n, *s.shape[len(mesh.axes):])
        out = engine(ring(q), ring(k), ring(v), **kw)
        return mesh.unshard(out.reshape(*mesh.shape, *out.shape[2:]), spec)
    return attend


def make_ring_attention(mesh, *, axis_name: str = "sp", causal: bool = True,
                        hop_impl: str = "xla"):
    """:func:`ring_attention` over global ``[B, H, S, D]`` q/k/v on the
    mesh's device whose S axis is cut over ``axis_name`` (the mesh's last
    axis; the batch over :meth:`Mesh.batch_axes`), as the reference's
    ``shard_map`` wrapper.  The reference cuts the batch over "dp" alone;
    on a mesh with a "dcn" axis too that changes which ranks compute
    which rows, not the result.  On a ``mesh.ProcessMesh`` each process
    runs :func:`ring_attention_group` on its block; every process passes
    the same global arrays and gets the global output."""
    _check_hop_impl(hop_impl)
    return _make(ring_attention, mesh, axis_name, ring_attention_group,
                 causal=causal, hop_impl=hop_impl)


def make_ring_attention_flash(mesh, *, axis_name: str = "sp",
                              causal: bool = True, hop_impl: str = "xla"):
    """:func:`ring_attention_flash` over global ``[B, H, S, D]`` arrays
    (see :func:`make_ring_attention`)."""
    _check_hop_impl(hop_impl)
    return _make(ring_attention_flash, mesh, axis_name,
                 ring_attention_flash_group, causal=causal,
                 hop_impl=hop_impl)


# --------------------------------------------------------------------------
# Zigzag (load-balanced) causal ring attention
# --------------------------------------------------------------------------


def zigzag_indices(seq_len: int, n: int, device=None):
    """Natural → zigzag gather order: the sequence is cut into 2n chunks
    and rank i holds chunks (i, 2n−1−i), one early and one late, so the
    causal work is the same on every rank.  ``x[..., order, :]`` laid out
    contiguously is the ranks' pairs in rank order.  ``ValueError`` unless
    2n divides ``seq_len`` (the reference asserts it)."""
    if seq_len % (2 * n):
        raise ValueError(f"sequence length {seq_len} does not split into "
                         f"2 x {n} zigzag chunks")
    c = seq_len // (2 * n)
    order: list[int] = []
    for i in range(n):
        order.extend(range(i * c, (i + 1) * c))
        order.extend(range((2 * n - 1 - i) * c, (2 * n - i) * c))
    return torch.tensor(order, dtype=torch.long, device=device)


def inverse_permutation(order):
    return torch.argsort(order)


def _on_ranks(carry, lo: int, hi: int, fn):
    """``carry`` (a tuple of ``[G, n, ...]`` tensors) with ranks lo..hi−1
    replaced by ``fn`` of their slice; the other ranks pass through."""
    part = fn(tuple(c[:, lo:hi] for c in carry))
    return tuple(torch.cat([c[:, :lo], p, c[:, hi:]], dim=1)
                 for c, p in zip(carry, part))


def _zigzag_schedule(q, k, v, attend, finalize):
    """The balanced causal chunk schedule of both zigzag engines, on
    ``[G, n, B, H, 2C, D]`` ring shards whose two C-chunks are global
    chunks (idx, 2n−1−idx) of rank idx (k/v may carry fewer heads).

    At step 0 each rank attends both diagonal chunks causally and q_hi
    over its own kv_lo.  At step t ≥ 1 the stacked ``[2, ...]`` kv hops
    one rank on (``mesh.ppermute``) and holds the chunks of source
    s = (idx − t) mod n; q_hi is later than every lo chunk, so q_hi ×
    kv_lo runs unmasked on every rank, and exactly one more pair is
    unmasked: q_lo × kv_lo where s < idx, which is ranks t..n−1, and
    q_hi × kv_hi on the others, ranks 0..t−1 (s > idx puts chunk
    2n−1−s before q_hi's).  The reference branches per device
    (``lax.cond``); the port runs each rank subset in one call, so a
    step makes three attends, and a call 3n: with the flash engine, 3n
    forward kernel launches and 3n backward ones.

    ``attend(carry_or_None, qc, kc, vc, causal)`` folds one chunk-attend
    into the carry (a tuple of ``[G, n', ...]`` tensors; None = first
    touch) and ``finalize(carry) -> [G, n, B, H, C, D]``."""
    G, n, B, H, S2, D = q.shape
    Hkv = k.shape[3]
    C = S2 // 2
    qz = q.reshape(G, n, B, H, 2, C, D)
    q_lo, q_hi = qz[..., 0, :, :], qz[..., 1, :, :]
    kv = torch.stack([k, v])               # [2, G, n, B, Hkv, 2C, D]

    def chunks(kv):
        z = kv.reshape(2, G, n, B, Hkv, 2, C, D)
        return (z[0, ..., 0, :, :], z[1, ..., 0, :, :],
                z[0, ..., 1, :, :], z[1, ..., 1, :, :])

    k_lo, v_lo, k_hi, v_hi = chunks(kv)
    lo = attend(None, q_lo, k_lo, v_lo, True)
    hi = attend(None, q_hi, k_hi, v_hi, True)
    hi = attend(hi, q_hi, k_lo, v_lo, False)
    for t in range(1, n):
        kv = ppermute(kv, 2, 1)
        k_lo, v_lo, k_hi, v_hi = chunks(kv)
        hi = attend(hi, q_hi, k_lo, v_lo, False)
        lo = _on_ranks(lo, t, n, lambda c: attend(
            c, q_lo[:, t:], k_lo[:, t:], v_lo[:, t:], False))
        hi = _on_ranks(hi, 0, t, lambda c: attend(
            c, q_hi[:, :t], k_hi[:, :t], v_hi[:, :t], False))
    out = torch.stack([finalize(lo), finalize(hi)], dim=4)
    return out.reshape(G, n, B, H, S2, D).to(q.dtype)


def _fp32_chunks(q, k):
    """The fp32 engine's ``(attend, finalize)`` for zigzag chunks of
    ``q``'s shape (heads at dimension −3): a running (m, l, acc) online
    softmax; GQA repeats the Hkv circulating heads at attend time only."""
    grp = q.shape[-3] // k.shape[-3]
    C, D = q.shape[-2] // 2, q.shape[-1]
    tril = torch.ones((C, C), dtype=torch.bool, device=q.device).tril()
    ones = torch.ones((C, C), dtype=torch.bool, device=q.device)

    def rep(t):
        return (t.repeat_interleave(grp, dim=-3) if grp > 1 else t).float()

    def attend(carry, qc, kc, vc, causal):
        if carry is None:
            rows = qc.shape[:-1]
            carry = (torch.full(rows, _NEG, device=qc.device),
                     torch.zeros(rows, device=qc.device),
                     torch.zeros(qc.shape, device=qc.device))
        return _block_attn(qc.float(), rep(kc), rep(vc), *carry,
                           tril if causal else ones, D ** -0.5)

    def finalize(carry):
        _, l, acc = carry
        return acc / l.clamp_min(1e-30)[..., None]
    return attend, finalize


def _flash_chunks(partial):
    """The flash engine's ``(attend, finalize)``: ``partial(q, k, v,
    causal)`` gives a chunk-attend's normalized output and base-2
    logsumexp, merged into the carry by :func:`_merge_partials`."""
    def attend(carry, qc, kc, vc, causal):
        part = partial(qc, kc, vc, causal)
        return part if carry is None else _merge_partials(*carry, *part)
    return attend, lambda carry: carry[0]


def zigzag_ring_attention(q, k, v):
    """Causal ring attention over zigzag shards ``[G, n, B, H, 2C, D]``,
    the fp32 engine (:func:`_fp32_chunks`) under
    :func:`_zigzag_schedule`."""
    return _zigzag_schedule(q, k, v, *_fp32_chunks(q, k))


def zigzag_ring_attention_flash(q, k, v):
    """:func:`zigzag_ring_attention` with the flash kernels per chunk
    (``flash_attention_with_lse``, forward and backward; GQA in the
    kernel) and base-2 logsumexp merges (:func:`_flash_chunks`)."""
    return _zigzag_schedule(q, k, v, *_flash_chunks(_flash_partial))


def _zigzag_schedule_group(q, k, v, ring, attend, finalize):
    """:func:`_zigzag_schedule` as the reference's per-device body
    (277-333) on this process's ``[B, H, 2C, D]`` block, whose two
    C-chunks are global chunks (idx, 2n−1−idx), ``idx = ring.rank``.

    Step 0 attends both diagonal chunks causally and q_hi over its own
    kv_lo.  At step t ≥ 1 the stacked ``[2, B, Hkv, 2C, D]`` kv hops one
    rank on (``collective_matmul.ProcessRingShift`` with ``plain``: the
    reference's ``ppermute``, one autograd node), then this rank attends
    q_hi × kv_lo and its own branch of the reference's ``lax.cond``:
    q_lo × kv_lo where the source s = (idx − t) mod n precedes it, else
    q_hi × kv_hi.  So a call makes 2n + 1 chunk-attends (the flash engine:
    2n + 1 forward launches and as many of each backward kernel); every
    hop's kv is read by q_hi × kv_lo, so every process runs each hop's
    backward, in the same order."""
    from tpu_dra_torch.workloads.collective_matmul import ProcessRingShift
    B, H, S2, D = q.shape
    Hkv = k.shape[1]
    C = S2 // 2
    n, idx = ring.n, ring.rank
    qz = q.reshape(B, H, 2, C, D)
    q_lo, q_hi = qz[:, :, 0], qz[:, :, 1]
    kv = torch.stack([k, v])               # [2, B, Hkv, 2C, D]

    def chunks(kv):
        z = kv.reshape(2, B, Hkv, 2, C, D)
        return z[0, :, :, 0], z[1, :, :, 0], z[0, :, :, 1], z[1, :, :, 1]

    k_lo, v_lo, k_hi, v_hi = chunks(kv)
    lo = attend(None, q_lo, k_lo, v_lo, True)
    hi = attend(None, q_hi, k_hi, v_hi, True)
    hi = attend(hi, q_hi, k_lo, v_lo, False)
    for t in range(1, n):
        (kv,) = ProcessRingShift.apply(ring, False, True, kv)
        k_lo, v_lo, k_hi, v_hi = chunks(kv)
        hi = attend(hi, q_hi, k_lo, v_lo, False)
        if (idx - t) % n < idx:
            lo = attend(lo, q_lo, k_lo, v_lo, False)
        else:
            hi = attend(hi, q_hi, k_hi, v_hi, False)
    out = torch.stack([finalize(lo), finalize(hi)], dim=2)
    return out.reshape(B, H, S2, D).to(q.dtype)


def zigzag_ring_attention_group(q, k, v, ring):
    """:func:`zigzag_ring_attention`, the fp32 engine, on this process's
    zigzag block under :func:`_zigzag_schedule_group`."""
    return _zigzag_schedule_group(q, k, v, ring, *_fp32_chunks(q, k))


def zigzag_ring_attention_flash_group(q, k, v, ring):
    """:func:`zigzag_ring_attention_flash` on this process's zigzag block:
    one ``flash_attention_with_lse`` a chunk-attend (GQA in the
    kernel)."""
    from tpu_dra_torch.workloads.flash import flash_attention_with_lse
    return _zigzag_schedule_group(q, k, v, ring,
                                  *_flash_chunks(flash_attention_with_lse))


ZIGZAG_IMPLS = {"xla": zigzag_ring_attention,
                "flash": zigzag_ring_attention_flash}
ZIGZAG_GROUP_IMPLS = {"xla": zigzag_ring_attention_group,
                      "flash": zigzag_ring_attention_flash_group}


def make_zigzag_ring_attention(mesh, *, axis_name: str = "sp",
                               impl: str = "xla"):
    """Zigzag ring attention over global ``[B, H, S, D]`` q/k/v whose S
    axis is in zigzag order (gather with :func:`zigzag_indices` before,
    with :func:`inverse_permutation` after) and cut over ``axis_name``
    (see :func:`make_ring_attention`).  ``impl``: "xla" (the fp32
    engine) or "flash" (the flash kernels); anything else raises
    ``ValueError``.  The kv hop is the plain ``mesh.ppermute``, as the
    reference's is.  On a ``mesh.ProcessMesh`` each process runs
    :func:`_zigzag_schedule_group` on its block, its hop the plain send
    and receive."""
    if impl not in ZIGZAG_IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected 'xla' or 'flash'")
    return _make(ZIGZAG_IMPLS[impl], mesh, axis_name,
                 ZIGZAG_GROUP_IMPLS[impl])


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

    Each block is rematerialized whole in the backward, as the
    reference's ``jax.checkpoint(block)`` (442) is: nothing of it is kept,
    so a step runs 2·(n−1) kv shifts per layer forward, as many again
    when the backward recomputes the forward, and as many in the
    backward itself."""
    from tpu_dra_torch.workloads.train import (_block, embed_rows,
                                               layer_params, remat)
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
        x = remat(_block, cfg, x, layer_params(params["blocks"], i), attn,
                  positions)
    return x.reshape(G, n, B, S, -1)


def _sp_trunk_group(cfg, params, tokens, ring, ring_impl: str = "xla",
                    hop_impl: str = "xla"):
    """:func:`_sp_trunk` as the reference's per-device body (409-443) on
    this process's ``[B, S/n]`` tokens, ``ring.rank`` its sequence
    shard's index: ``[B, S/n, D]`` pre-final-norm activations, each block
    rematerialized whole in the backward."""
    from tpu_dra_torch.workloads.train import (_block, embed_rows,
                                               layer_params, remat)
    if ring_impl not in RING_IMPLS:
        raise ValueError(f"unknown ring_impl {ring_impl!r}; expected 'xla' "
                         f"or 'flash'")
    _check_hop_impl(hop_impl)
    B, S = tokens.shape
    dev = tokens.device
    x = embed_rows(params["embed"], tokens)              # [B, S, D]
    start = ring.rank * S
    positions = None
    if cfg.pos_emb == "learned":
        start = min(start, max(cfg.max_seq - S, 0))
        rows = start + torch.arange(S, device=dev)
        x = x + params["pos"].to(torch.bfloat16)[rows][None]
    else:
        positions = (start + torch.arange(S, device=dev))[None].expand(B, S)
    engine = ring_attention_flash_group if ring_impl == "flash" else \
        ring_attention_group

    def attn(q, k, v):
        return engine(q, k, v, ring, causal=True, hop_impl=hop_impl)
    for i in range(cfg.n_layers):
        x = remat(_block, cfg, x, layer_params(params["blocks"], i), attn,
                  positions)
    return x


def _group_ring_train_step(cfg, mesh, lr: float, axis_name: str,
                           ring_impl: str, hop_impl: str):
    """The DP×SP step on a ``ProcessMesh``: the reference's
    ``sharded_step`` (473-497) in each process."""
    from tpu_dra_torch.workloads.train import (head_nll, tree_leaves,
                                               tree_unflatten)
    ring = mesh.ring(axis_name)
    tok_spec = (mesh.batch_axes(), axis_name)

    def step(params, tokens, targets):
        mesh.check_device(tokens, targets, *tree_leaves(params))
        tok, tgt = mesh.shard(tokens, tok_spec), mesh.shard(targets,
                                                            tok_spec)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        x = _sp_trunk_group(cfg, live, tok, ring, ring_impl, hop_impl)
        nll = head_nll(live, x, tgt.long())
        count = torch.tensor(float(nll.numel()), device=nll.device)
        loss = mesh.psum(nll.sum()) / mesh.psum(count)
        grads = torch.autograd.grad(loss, leaves)
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        del grads
        flat = mesh.psum(flat)
        new, at = [], 0
        for p in leaves:
            g = flat[at:at + p.numel()].reshape(p.shape).to(p.dtype)
            new.append(p.detach() - lr * g)
            at += p.numel()
        return tree_unflatten(params, new), loss.detach()

    return step, tok_spec


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
    does the port's, which holds to it in the tests.

    On a ``mesh.ProcessMesh`` each process runs the reference's
    per-device step: every process passes the same global tokens and
    targets and its replica of the parameters, takes its ``(batch,
    axis_name)`` shard, differentiates its own replica of the loss (the
    psum of the local NLL sums, whose backward is a psum, over the psum
    of the counts) and sums the gradients over the whole mesh (one flat
    fp32 all-reduce), so the update carries the same factor and every
    process ends with the same parameters.  The hops ride
    ``ProcessRing`` (the shift kernel across processes, or the plain
    send and receive)."""
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
    if isinstance(mesh, ProcessMesh):
        return _group_ring_train_step(cfg, mesh, lr, axis_name, ring_impl,
                                      hop_impl)
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

