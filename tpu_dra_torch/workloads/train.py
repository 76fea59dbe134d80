"""Model core of the decoder-only transformer, ported from
``tpu_dra/workloads/train.py``.

Same parameter layout as the reference: stacked ``[L, ...]`` block
weights, fp32 master copies (bf16 after ``quant.cast_params_bf16`` for
serving), bf16 activations.  The layer loop is a Python loop over the
stacked leading axis where the reference runs ``lax.scan``.

The training half: ``loss_fn`` over the dense or chunked NLL head (label
smoothing, z-loss), ``grads_fn`` with gradient accumulation,
``sgd_train_step`` and ``make_train_step`` (the optimizer is
``optim.py``).  ``attn_impl="flash"`` runs attention through the flash
kernels (``flash.py``); ``norm_impl="fused"`` runs each sublayer's
rmsnorm→matmul pair through the fused kernel (``matmul.py``) where the
reference would.  The sharded half: ``param_shardings``,
``batch_sharding``, ``make_sharded_train_step`` and
``make_optax_train_step`` over a virtual mesh (``mesh.py``) or a
process mesh (``process_train.py``), with
``matmul_impl="fused_collective"`` running each sublayer's entry and
exit matmul through the ring kernels (``collective_matmul.py``), and
the optimizer state laid out by ``opt_state_shardings`` (ZeRO-1 over
"dp": ``optim.MomentLayout``, ``optim.ProcessMomentLayout``).
``packed_loss_fn`` trains on rows packed by ``data.pack_documents``
(dense attention only: the flash kernels have no segment mask).  The
trunk rematerializes in the backward what lies between its weight
products, whose outputs it keeps: the reference's selective policy
(:func:`remat`, :func:`_block`'s ``seg``).

Rounding follows the reference op by op: a Python scalar that multiplies
a bf16 tensor is first rounded to bf16 (JAX's weak typing does that),
matmuls of bf16 operands return bf16, and norms and softmax compute in
fp32 before casting back.  One departure is deliberate: the embedding
gradient sums in fp32 where the reference's adds into a bf16 table
(:func:`embed_rows`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpu_dra_torch.workloads.mesh import ProcessMesh
from tpu_dra_torch.workloads.quant import matmul_any


@dataclass(frozen=True)
class ModelConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_seq: int = 128
    # GQA/MQA: number of shared k/v heads (None → MHA, one kv head per q
    # head)
    n_kv_heads: int | None = None
    # "learned" (absolute embedding table) or "rope" (rotary, applied to
    # q/k per head)
    pos_emb: str = "learned"
    rope_base: float = 10000.0
    # share the input embedding with the output head (logits = x·embedᵀ)
    tied_embeddings: bool = False

    def __post_init__(self):
        if self.pos_emb not in ("learned", "rope"):
            raise ValueError(f"unknown pos_emb {self.pos_emb!r}")
        if self.pos_emb == "rope" and self.d_head % 2:
            raise ValueError(
                f"rope needs an even head dim, got d_head {self.d_head}")
        if self.n_kv_heads is not None and self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_kv_heads {self.n_kv_heads} must divide "
                f"n_heads {self.n_heads}")

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def d_kv(self) -> int:
        return self.kv_heads * self.d_head


def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: what a Python scalar becomes when
    JAX multiplies it into an array of that dtype (weak typing).  torch
    keeps the scalar in fp32 for a bf16 op, so the port rounds it first."""
    return float(torch.tensor(value, dtype=dtype))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict[str, Any]:
    """Stacked-by-layer fp32 params with the reference's shapes and scale
    (normal · d_model^-0.5, norm gains at 1), drawn from ``generator`` on
    its own device (or on ``device``: "meta" gives the shapes alone,
    :func:`param_shapes`).  The numbers differ from ``jax.random``'s;
    tests carry JAX weights across with :mod:`tpu_dra_torch.convert`
    instead."""
    dev = generator.device if device is None else torch.device(device)
    scale = cfg.d_model ** -0.5
    L = cfg.n_layers

    def norm(shape):
        return torch.randn(shape, generator=generator, device=dev) * scale

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    params: dict[str, Any] = {
        "embed": norm((cfg.vocab, cfg.d_model)),
        "blocks": {
            "wqkv": norm((L, cfg.d_model, cfg.d_model + 2 * cfg.d_kv)),
            "wo": norm((L, cfg.d_model, cfg.d_model)),
            "w1": norm((L, cfg.d_model, cfg.d_ff)),
            "w2": norm((L, cfg.d_ff, cfg.d_model)),
            "ln1": ones((L, cfg.d_model)),
            "ln2": ones((L, cfg.d_model)),
        },
        "ln_f": ones((cfg.d_model,)),
    }
    if not cfg.tied_embeddings:
        params["unembed"] = norm((cfg.d_model, cfg.vocab))
    if cfg.pos_emb == "learned":
        params["pos"] = norm((cfg.max_seq, cfg.d_model))
    return params


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i`` of the stacked block weights (the scan slice), into
    dict leaves too (quantized and LoRA-wrapped weights)."""
    return {name: layer_params(leaf, i) if isinstance(leaf, dict)
            else leaf[i] for name, leaf in blocks.items()}


def _rmsnorm(x, g):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + 1e-6) * g.float()).to(x.dtype)


def apply_rope(x, positions, base: float = 10000.0):
    """Rotate ``[B, H, S, Dh]`` head vectors by position (RoPE),
    half-split convention: ``(x[:d/2], x[d/2:])`` pairs.  ``positions``
    is int ``[S]`` (shared across the batch) or ``[B, S]``.  Computed in
    fp32, cast back."""
    dh = x.shape[-1]
    half = dh // 2
    inv = base ** (-torch.arange(half, dtype=torch.float32,
                                 device=x.device) / half)
    ang = positions.float()[..., :, None] * inv       # [(B,) S, half]
    if positions.dim() == 2:
        ang = ang[:, None]                 # [B, 1, S, half]: over heads
    sin, cos = torch.sin(ang), torch.cos(ang)
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _causal_dense_attention(q, k, v, segment_ids=None):
    """Dense causal softmax over ``[B, H, S, D]`` q against
    ``[B, Hkv, S, D]`` k/v; each kv head serves its group of H/Hkv query
    heads through a reshape (no repeat of k/v).

    ``segment_ids`` ``[B, S]`` (packing) also masks every pair of
    positions in different segments: the block-diagonal mask that keeps
    packed documents apart.  Id 0 is padding, whose positions attend
    earlier padding and whose outputs the packed loss masks out."""
    B, H, S, D = q.shape
    hkv = k.shape[1]
    qg = q.reshape(B, hkv, H // hkv, S, D)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg, k) \
        * weak_scalar(D ** -0.5, q.dtype)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    if segment_ids is not None:
        same = segment_ids[:, :, None] == segment_ids[:, None, :]
        mask = (mask & same)[:, None, None]                # [B, 1, 1, S, S]
    scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    attn = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bksd->bkgqd", attn, v)
    return out.reshape(B, H, S, D)


def _split_heads(cfg: ModelConfig, t, n: int | None = None):
    """``[B, S, n·Dh]`` → ``[B, n, S, Dh]``."""
    B, S = t.shape[:2]
    n = n or cfg.n_heads
    return t.reshape(B, S, n, cfg.d_head).transpose(1, 2)


def _split_qkv(cfg: ModelConfig, qkv):
    """The fused projection's q | k | v column blocks."""
    return torch.split(qkv, [cfg.d_model, cfg.d_kv, cfg.d_kv], dim=-1)


# --------------------------------------------------------------------------
# The fused-collective trunk (matmul_impl="fused_collective")
# --------------------------------------------------------------------------

MATMUL_IMPLS = ("dense", "fused_collective")


def _fc_active(x, w, mesh, matmul_impl: str, contract_sharded: bool) -> bool:
    """Whether this matmul takes the ring kernels (``train._fc_active``,
    177-193): ``matmul_impl="fused_collective"`` on a mesh with a > 1-way
    "tp" axis, a plain-tensor weight (dict leaves keep the plain path), a
    3-D x whose sequence splits over tp, and a weight whose sharded axis
    (its rows where the contraction is sharded, else its columns) does.
    The fallback is the reference's semantics: it changes which rank
    computes what, never the math."""
    if matmul_impl != "fused_collective" or mesh is None:
        return False
    if not torch.is_tensor(w) or x.dim() != 3:
        return False
    return fc_splits(x.shape[1], w.shape, mesh.axis_size("tp"),
                     contract_sharded)


def fc_splits(seq: int, w_shape, tp: int, contract_sharded: bool) -> bool:
    """The shape half of :func:`_fc_active`: a > 1-way tp, a sequence of
    ``seq`` rows and a ``w_shape`` weight's sharded axis that split over
    it."""
    if tp <= 1 or seq % tp:
        return False
    shard_dim = w_shape[0] if contract_sharded else w_shape[1]
    return shard_dim % tp == 0


def _direct(fn, *args):
    """``fn(*args)``: the ``seg`` of a block that keeps everything
    (:func:`_block`)."""
    return fn(*args)


def _fc_ag_norm_matmul(x, gamma, w, mesh, dtype, seg=_direct):
    """The sublayer entry of the Megatron-SP layout
    (``train._fc_ag_norm_matmul``, 204-230): x ``[B, S, D]`` cut
    ``(batch, "tp", None)`` (sequence-sharded), rmsnorm on each rank's
    rows, then the all-gather-matmul ring kernel against each rank's
    column shard of w; the result ``[B, S, N]`` comes back whole from
    the ``(batch, None, "tp")`` column shards.  Rows fold sequence-major
    (``[B, S/tp, D] → [S/tp·B, D]``), so the gathered row blocks are the
    sequence blocks.  ``seg`` runs the rmsnorm (:func:`_block`)."""
    from tpu_dra_torch.workloads.collective_matmul import AllGatherMatmul
    G, tp = mesh.ring_groups("tp")
    batch = mesh.batch_axes()
    D = x.shape[-1]
    xs = mesh.shard(x, (batch, "tp", None))          # [*mesh, bl, sl, D]
    bl, sl = xs.shape[-3], xs.shape[-2]
    normed = seg(_rmsnorm, xs, gamma)
    xf = normed.transpose(-3, -2).reshape(G, tp, sl * bl, D)
    wl = mesh.shard(w.to(x.dtype), (None, "tp"))
    y = AllGatherMatmul.apply(xf, wl.reshape(G, tp, *wl.shape[-2:]))
    y = y.reshape(*mesh.shape, tp * sl, bl, y.shape[-1]).transpose(-3, -2)
    return mesh.unshard(y, (batch, None, "tp")).to(dtype)


def _fc_matmul_rs(x, w, mesh, dtype):
    """The matching sublayer exit (``train._fc_matmul_rs``, 233-255): the
    contraction axis of x ``[B, S, K]`` is cut over tp
    (``(batch, None, "tp")``) and w's rows with it, so each rank holds a
    partial product; the matmul-reduce-scatter ring kernel sums it while
    it scatters the rows back to the sequence-sharded ``(batch, "tp",
    None)`` layout."""
    from tpu_dra_torch.workloads.collective_matmul import MatmulReduceScatter
    G, tp = mesh.ring_groups("tp")
    batch = mesh.batch_axes()
    xs = mesh.shard(x, (batch, None, "tp"))          # [*mesh, bl, S, K/tp]
    bl, S, kl = xs.shape[-3:]
    xf = xs.transpose(-3, -2).reshape(G, tp, S * bl, kl)
    wl = mesh.shard(w.to(x.dtype), ("tp", None))
    y = MatmulReduceScatter.apply(xf, wl.reshape(G, tp, *wl.shape[-2:]))
    y = y.reshape(*mesh.shape, S // tp, bl, y.shape[-1]).transpose(-3, -2)
    return mesh.unshard(y, (batch, "tp", None)).to(dtype)


def _out_matmul(x, w, dtype, matmul_impl: str = "dense", mesh=None):
    """The sublayer-closing projection (wo, w2; ``train._out_matmul``):
    the matmul-reduce-scatter ring kernel where :func:`_fc_active` admits
    it, else the plain matmul."""
    if _fc_active(x, w, mesh, matmul_impl, contract_sharded=True):
        return _fc_matmul_rs(x, w, mesh, dtype)
    return matmul_any(x, w, dtype)


def _norm_matmul(x, gamma, w, dtype, norm_impl: str = "dense",
                 matmul_impl: str = "dense", mesh=None, seg=_direct):
    """The rmsnorm→matmul pair each sublayer opens with
    (``train._norm_matmul``).  ``matmul_impl="fused_collective"`` on a
    mesh with a > 1-way "tp" axis sends it through the all-gather-matmul
    ring kernel where :func:`_fc_active` admits it (that branch comes
    first, as in the reference).  ``norm_impl="fused"`` sends a
    plain-tensor weight through :class:`matmul.RmsnormMatmul` when the
    flattened shapes pass the reference's admission rule (``m % min(256,
    m) == 0`` and ``n % min(256, n) == 0`` with ``m = B·S``); the weight is
    cast to x's dtype outside it, so its gradient reaches the fp32 master
    rounded to bf16.  Anything else (dict leaves, shapes the rules
    refuse, the default) takes the plain pair.  ``seg`` runs the rmsnorm
    (:func:`_block`)."""
    if _fc_active(x, w, mesh, matmul_impl, contract_sharded=False):
        return _fc_ag_norm_matmul(x, gamma, w, mesh, dtype, seg)
    if norm_impl == "fused" and torch.is_tensor(w):
        B, S, D = x.shape
        m, n = B * S, w.shape[1]
        if m % min(256, m) == 0 and n % min(256, n) == 0:
            from tpu_dra_torch.workloads.matmul import RmsnormMatmul
            out = RmsnormMatmul.apply(x.reshape(m, D), gamma, w.to(x.dtype))
            return out.reshape(B, S, n).to(dtype)
    return matmul_any(seg(_rmsnorm, x, gamma), w, dtype)


def _attn_core(cfg: ModelConfig, qkv, attn_fn, positions, heads=None):
    """What lies between the attention sublayer's two products: the
    fused projection ``[B, S, ·]`` split into heads, q/k rotated by
    ``positions`` (default 0..S-1; ``[S]`` or per-row ``[B, S]``) under
    ``pos_emb="rope"``, the attention, and the heads merged back to
    ``[B, S, q heads · d_head]``.  ``heads``: ``(q heads, k/v heads)`` the
    projection holds (default: the model's; a tensor-parallel rank holds
    its share)."""
    B, S = qkv.shape[:2]
    hq, hkv = heads or (cfg.n_heads, cfg.kv_heads)
    q, k, v = torch.split(qkv, [hq * cfg.d_head, hkv * cfg.d_head,
                                hkv * cfg.d_head], dim=-1)
    q = _split_heads(cfg, q, hq)
    k = _split_heads(cfg, k, hkv)
    v = _split_heads(cfg, v, hkv)
    if cfg.pos_emb == "rope":
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=qkv.device)
        q = apply_rope(q, positions, cfg.rope_base)
        k = apply_rope(k, positions, cfg.rope_base)
    out = attn_fn(q, k, v)
    return out.transpose(1, 2).reshape(B, S, hq * cfg.d_head)


def _attn_sublayer(cfg: ModelConfig, x, layer,
                   attn_fn=_causal_dense_attention, positions=None,
                   norm_impl: str = "dense", matmul_impl: str = "dense",
                   mesh=None, seg=_direct):
    """Pre-norm attention residual sublayer, GQA-aware
    (:func:`_attn_core`; ``seg`` as in :func:`_block`)."""
    qkv = _norm_matmul(x, layer["ln1"], layer["wqkv"], x.dtype, norm_impl,
                       matmul_impl, mesh, seg)
    out = seg(_attn_core, cfg, qkv, attn_fn, positions)
    return x + _out_matmul(out, layer["wo"], x.dtype, matmul_impl, mesh)


def _mlp(x, layer, norm_impl: str = "dense", matmul_impl: str = "dense",
         mesh=None, seg=_direct):
    """Pre-norm gelu MLP residual.  ``jax.nn.gelu`` defaults to the tanh
    approximation, so the port asks for it explicitly.  The gelu runs
    outside ``seg``: it keeps its input for the backward and the second
    product keeps its output, so its remat would keep the same two
    tensors and run it again."""
    h = _norm_matmul(x, layer["ln2"], layer["w1"], x.dtype, norm_impl,
                     matmul_impl, mesh, seg)
    h = F.gelu(h, approximate="tanh")
    return x + _out_matmul(h, layer["w2"], x.dtype, matmul_impl, mesh)


def _block(cfg: ModelConfig, x, layer, attn_fn=_causal_dense_attention,
           positions=None, norm_impl: str = "dense",
           matmul_impl: str = "dense", mesh=None, seg=_direct):
    """One decoder block (attention then MLP sublayer).  ``seg(fn,
    *args)`` runs each stretch that lies between two weight products: the
    two rmsnorms (where no fused kernel takes them) and
    :func:`_attn_core`; :func:`_trunk` passes :func:`remat`."""
    x = _attn_sublayer(cfg, x, layer, attn_fn, positions, norm_impl,
                       matmul_impl, mesh, seg)
    return _mlp(x, layer, norm_impl, matmul_impl, mesh, seg)


def _flash_attention_fn(q, k, v):
    """Flash attention (``flash.flash_attention``, causal) as a drop-in
    for :func:`_causal_dense_attention`.  The reference pads S up to its
    TPU tile here; the port's kernels mask the ragged tail themselves."""
    from tpu_dra_torch.workloads.flash import flash_attention
    return flash_attention(q, k, v, causal=True)


_ATTN_IMPLS: dict[str, Callable] = {"dense": _causal_dense_attention,
                                    "flash": _flash_attention_fn}


def attn_impl_fn(attn_impl: str) -> Callable:
    """The attention function named by ``attn_impl``."""
    if attn_impl not in _ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; expected one "
                         f"of {sorted(_ATTN_IMPLS)}")
    return _ATTN_IMPLS[attn_impl]


def embed_rows(embed, tokens):
    """bf16 rows of the embedding table at ``tokens``, gathered in the
    table's dtype and then cast.  The forward is the reference's
    cast-then-gather bit for bit.  The backward departs from it on
    purpose: the rows' gradients are scatter-added into the fp32 table,
    where the reference adds them into a bf16 one.  A token that recurs r
    times gets its fp32 sum, not a bf16 running sum whose rounding grows
    with r and depends on the order the tokens come in, so the one-device
    and the sequence-sharded steps agree (the bf16 sum had put the
    flagship's embed gradients of the two 4.8% apart, relative L2, on one
    [16, 1025] window of chip_smoke.py's corpus on an H100 80GB HBM3 at
    700 W).  The cost is a gap to the reference that grows with r:
    ``test_embed_grad_of_a_repetitive_window_stays_near_the_reference``
    reads 1.1% at 130 recurrences and 1.8% at 260 on the CPU."""
    return embed[tokens].to(torch.bfloat16)


def embed_tokens(cfg: ModelConfig, params, tokens, positions=None):
    """bf16 token embeddings (stored in the parameter dtype, cast on
    use, :func:`embed_rows`), plus the learned position rows at
    ``positions`` (default 0..S-1) for ``pos_emb="learned"``.  Given
    positions (a packed row's restart at each document), a row longer
    than the learned table raises ``ValueError``, as the reference's
    ``_trunk`` does (409-416), although every document may fit it."""
    x = embed_rows(params["embed"], tokens)
    if cfg.pos_emb == "learned":
        if positions is None:
            positions = torch.arange(tokens.shape[-1], device=x.device)
        elif tokens.shape[-1] > cfg.max_seq:
            raise ValueError(
                f"packed seq {tokens.shape[-1]} exceeds the learned-"
                f"position table (max_seq={cfg.max_seq})")
        x = x + params["pos"].to(torch.bfloat16)[positions]
    return x


def remat(fn, *args):
    """``fn(*args)`` with its activations rematerialized in the backward
    (``torch.utils.checkpoint``, non-reentrant; the reference's
    ``jax.checkpoint``): only the arguments are kept, and the backward
    runs ``fn`` again.  Where autograd is off (serving) ``fn`` just runs.
    Recomputation changes memory and launch counts, never a value: every
    recomputed op is deterministic."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def _trunk(cfg: ModelConfig, params, tokens,
           attn_fn=_causal_dense_attention, segment_ids=None, positions=None,
           norm_impl: str = "dense", matmul_impl: str = "dense", mesh=None):
    """Embed + decoder stack; returns pre-final-norm activations.

    The reference's selective remat (429-450,
    ``checkpoint_dots_with_no_batch_dims`` with the names
    ``fused_norm_mm`` and ``fc_collective_mm``) keeps the weight
    products' outputs and recomputes the rest.  The port keeps the same
    products by leaving them, the RMSNorm-matmul and the ring kernels
    included, outside :func:`remat`, which takes each stretch between
    them instead (``seg`` of :func:`_block`): the rmsnorms and the
    attention between the two projections, the flash forward included,
    run again in the backward; no product does.  Unlike the reference it
    also keeps each product's input (the normed rows, the merged heads,
    the gelu output) and the bf16 weight copies, which autograd saves for
    the weight gradients.

    Packing (``segment_ids`` and per-token ``positions``, ``[B, S]``):
    the dense attention takes the block-diagonal segment mask, and rope
    and the learned table read the per-document positions.  Any other
    attention raises ``NotImplementedError`` (the flash kernels have no
    segment mask), as in the reference (381-386).

    ``matmul_impl="fused_collective"`` with a mesh whose "tp" axis is > 1
    (``train._trunk``, 388-409), and no segments or positions: every
    sublayer's entry and exit matmul rides the ring kernels,
    sequence-sharded over tp between them.  The sequence must split over
    tp, so the token tail is zero-padded up to a multiple of tp (causal
    attention keeps the padded columns out of every real row, norms and
    residuals are row-local, and the padded rows are sliced off); where
    that padding would run past a learned-position table the shape keeps
    the plain path, as in the reference."""
    if segment_ids is not None:
        if attn_fn is not _causal_dense_attention:
            raise NotImplementedError(
                "packed segment masks need the dense attention path")
        attn_fn = partial(_causal_dense_attention, segment_ids=segment_ids)
    fc = (matmul_impl == "fused_collective" and mesh is not None
          and mesh.axis_size("tp") > 1 and segment_ids is None
          and positions is None)
    S = tokens.shape[1]
    pad = 0
    if fc:
        pad = (-S) % mesh.axis_size("tp")
        if pad and cfg.pos_emb == "learned" and S + pad > cfg.max_seq:
            pad = 0
        if pad:
            tokens = F.pad(tokens, (0, pad))
    x = embed_tokens(cfg, params, tokens, positions)
    for i in range(cfg.n_layers):
        x = _block(cfg, x, layer_params(params["blocks"], i), attn_fn,
                   positions, norm_impl, matmul_impl, mesh, seg=remat)
    return x[:, :S] if pad else x


def head_logits(params, x):
    """Final norm + unembed, fp32 logits.  Tied models (no "unembed")
    project against the input embedding transposed."""
    x = _rmsnorm(x, params["ln_f"])
    if "unembed" not in params:
        e = params["embed"]
        if isinstance(e, dict):
            raise NotImplementedError(
                "tied head over a quantized/wrapped embed is unsupported "
                "— embeddings stay high precision")
        return (x.to(torch.bfloat16) @ e.to(torch.bfloat16).T).float()
    return matmul_any(x, params["unembed"], torch.bfloat16).float()


def forward(cfg: ModelConfig, params, tokens, attn_impl: str = "dense",
            norm_impl: str = "dense", matmul_impl: str = "dense",
            mesh=None):
    """Logits ``[B, S, vocab]`` for a ``[B, S]`` integer token batch."""
    return head_logits(params, _trunk(cfg, params, tokens,
                                      attn_impl_fn(attn_impl),
                                      norm_impl=norm_impl,
                                      matmul_impl=matmul_impl, mesh=mesh))


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

_HEAD_IMPLS = ("dense", "chunked")


def head_nll(params, x, targets, head_impl: str = "dense",
             n_chunks: int = 16, label_smoothing: float = 0.0,
             z_loss: float = 0.0):
    """Per-token NLL ``[B, S, 1]`` through the final head (ln_f →
    unembed → log_softmax → target gather); ``targets`` int64 ``[B, S]``.

    ``head_impl="chunked"`` streams the vocab in ``n_chunks`` pieces (the
    largest divisor of V not above it) with an online logsumexp, so the
    ``[B, S, V]`` fp32 logits never exist at once; its backward recomputes
    each chunk's logits from the saved lse.  ``label_smoothing`` ε gives
    ``(1−ε)·nll + ε·(lse − mean(logits))`` and ``z_loss`` adds
    ``z_loss·lse²``; both need the dense head."""
    if head_impl not in _HEAD_IMPLS:
        raise ValueError(f"unknown head_impl {head_impl!r}; expected one "
                         f"of {_HEAD_IMPLS}")
    if label_smoothing or z_loss:
        if head_impl == "chunked":
            raise NotImplementedError(CHUNKED_REFUSES)
        return smoothed_nll(head_logits(params, x), targets,
                            label_smoothing, z_loss)
    if head_impl == "chunked":
        B, S, D = x.shape
        w_full = (params["embed"].T if "unembed" not in params
                  else params["unembed"])
        n = vocab_chunks(w_full.shape[1], n_chunks)
        h = _rmsnorm(x, params["ln_f"]).reshape(B * S, D)
        nll = _ChunkedNLL.apply(h.to(torch.bfloat16),
                                w_full.to(torch.bfloat16),
                                targets.reshape(B * S), n)
        return nll.reshape(B, S, 1)
    logp = torch.log_softmax(head_logits(params, x), dim=-1)
    return -logp.gather(-1, targets[..., None])


CHUNKED_REFUSES = ("label_smoothing/z_loss need the dense head (the "
                   "chunked backward doesn't carry mean-logit/lse stats)")


def smoothed_nll(logits, targets, label_smoothing: float, z_loss: float):
    """Per-token NLL ``[B, S, 1]`` of fp32 ``logits`` ``[B, S, V]`` with
    :func:`head_nll`'s label smoothing and z-loss (:func:`regularized`)."""
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    nll = lse - logits.gather(-1, targets[..., None])
    return regularized(nll, lse, lambda: logits.mean(dim=-1, keepdim=True),
                       label_smoothing, z_loss)


def regularized(nll, lse, mean_logit: Callable, label_smoothing: float,
                z_loss: float):
    """``(1−ε)·nll + ε·(lse − mean(logits))`` where ``label_smoothing`` ε
    is set (``mean_logit()`` gives the mean), plus ``z_loss·lse²`` where
    ``z_loss`` is."""
    if label_smoothing:
        uniform_nll = lse - mean_logit()
        nll = (1.0 - label_smoothing) * nll + label_smoothing * uniform_nll
    if z_loss:
        nll = nll + z_loss * lse.square()
    return nll


def vocab_chunks(vocab: int, n_chunks: int) -> int:
    """The chunked head's chunk count: the largest divisor of ``vocab``
    not above ``n_chunks``."""
    n = min(n_chunks, vocab)
    while vocab % n:
        n -= 1
    return n


def dot_f32(a, b):
    """2-D bf16 ``a @ b`` accumulated and returned in fp32 (the
    reference's ``preferred_element_type=float32``).  On the card one
    cuBLAS call with an fp32 output; on the CPU an fp32 product of the
    upcast operands, the same sum since bf16 values are exact in fp32."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunked_logits_stats(x, w, targets, n_chunks: int, logits_of=dot_f32):
    """Online logsumexp and target logit over vocab chunks: x ``[N, D]``
    bf16, w ``[D, V]`` bf16, targets ``[N]``; returns ``(lse, t_logit)``
    fp32 ``[N]``.  ``logits_of(x, w chunk)`` gives a chunk's fp32
    logits."""
    N, V = x.shape[0], w.shape[1]
    C = V // n_chunks
    m = torch.full((N,), torch.finfo(torch.float32).min,
                   dtype=torch.float32, device=x.device)
    l = torch.zeros(N, dtype=torch.float32, device=x.device)
    t = torch.zeros(N, dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        logits = logits_of(x, w[:, c * C:(c + 1) * C])
        m_new = torch.maximum(m, logits.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=-1)
        off = targets - c * C
        hit = (off >= 0) & (off < C)
        picked = logits.gather(1, off.clamp(0, C - 1)[:, None])[:, 0]
        t = t + torch.where(hit, picked, torch.zeros_like(picked))
        m = m_new
    return m + torch.log(l), t


class _ChunkedNLL(torch.autograd.Function):
    """Streamed-vocab NLL ``lse − target_logit`` ``[N]``; the counterpart
    of the reference's ``_chunked_nll`` custom VJP (``train.py:556-597``).
    Forward keeps only the lse; backward recomputes each chunk's logits,
    ``d nll/d logits = softmax − onehot(target)``.

    ``apply(x, w, targets, n_chunks, logits_of=dot_f32, combine=None)``:
    ``logits_of(x, w chunk)`` gives a chunk's fp32 logits, and
    ``combine(lse, t)`` turns the stream's stats into the ones the NLL
    takes (the process mesh's vocab-parallel head, ``process_train.py``,
    streams each rank's vocab shard and combines across ranks)."""

    @staticmethod
    def forward(ctx, x, w, targets, n_chunks: int, logits_of=dot_f32,
                combine=None):
        lse, t = _chunked_logits_stats(x, w, targets, n_chunks, logits_of)
        if combine is not None:
            lse, t = combine(lse, t)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.n_chunks, ctx.logits_of = n_chunks, logits_of
        return lse - t

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        n_chunks = ctx.n_chunks
        V = w.shape[1]
        C = V // n_chunks
        gf = g.float()
        cols = torch.arange(C, device=x.device)
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty((x.shape[1], V), dtype=torch.float32,
                         device=x.device)
        for c in range(n_chunks):
            wc = w[:, c * C:(c + 1) * C]
            p = torch.exp(ctx.logits_of(x, wc) - lse[:, None])
            onehot = ((targets - c * C)[:, None] == cols[None, :]).float()
            ds = ((p - onehot) * gf[:, None]).to(torch.bfloat16)   # [N, C]
            dx = dx + dot_f32(ds, wc.T)
            dw[:, c * C:(c + 1) * C] = dot_f32(x.T, ds)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None, None


def loss_fn(cfg: ModelConfig, params, tokens, attn_impl: str = "dense",
            head_impl: str = "dense", label_smoothing: float = 0.0,
            z_loss: float = 0.0, norm_impl: str = "dense",
            matmul_impl: str = "dense", mesh=None):
    """Mean next-token NLL of a ``[B, S+1]`` window batch: the trunk reads
    ``tokens[:, :-1]`` and predicts ``tokens[:, 1:]``."""
    trunk = _trunk(cfg, params, tokens[:, :-1], attn_impl_fn(attn_impl),
                   norm_impl=norm_impl, matmul_impl=matmul_impl, mesh=mesh)
    return head_nll(params, trunk, tokens[:, 1:].long(), head_impl,
                    label_smoothing=label_smoothing, z_loss=z_loss).mean()


def packed_loss_fn(cfg: ModelConfig, params, tokens, segment_ids,
                   positions, head_impl: str = "dense",
                   label_smoothing: float = 0.0, z_loss: float = 0.0,
                   mesh=None):
    """Mean next-token NLL over a packed ``[B, S+1]`` batch
    (``data.pack_documents``: tokens, segment ids, per-document
    positions): block-diagonal attention over the segments, positions
    restarting at each document, and the loss only where the next token
    continues the same document (a prediction across a boundary or from
    padding counts for nothing).  Dense attention; the reference's
    ``packed_loss_fn`` (621-636).

    ``mesh``: on a DP×TP ``mesh.ProcessMesh`` ``params`` is this
    process's shards (:func:`param_shardings`) and the loss the global
    one, on every process (``process_train.process_packed_loss``); the
    reference runs it under the dp×tp shardings.  A virtual mesh takes
    the whole tree, as on one device."""
    if isinstance(mesh, ProcessMesh):
        from tpu_dra_torch.workloads.process_train import \
            process_packed_loss
        return process_packed_loss(cfg, params, tokens, segment_ids,
                                   positions, mesh, head_impl,
                                   label_smoothing, z_loss)
    trunk = _trunk(cfg, params, tokens[:, :-1],
                   segment_ids=segment_ids[:, :-1],
                   positions=positions[:, :-1])
    nll = head_nll(params, trunk, tokens[:, 1:].long(), head_impl,
                   label_smoothing=label_smoothing, z_loss=z_loss)
    valid = ((segment_ids[:, :-1] == segment_ids[:, 1:])
             & (segment_ids[:, :-1] > 0)).float()
    return (nll[..., 0] * valid).sum() / valid.sum().clamp(min=1.0)


def tree_leaves(tree) -> list:
    """The tensors of a nested parameter dict, in insertion order."""
    out = []
    for v in tree.values():
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_unflatten(like, leaves) -> dict:
    """A nested dict shaped like ``like`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        return {k: build(v) if isinstance(v, dict) else next(it)
                for k, v in node.items()}
    return build(like)


def tree_like(like, tree) -> dict:
    """``tree``'s leaves, matched by key, in a dict shaped and ordered like
    ``like`` (two trees of one model may hold their keys in other
    orders: a reference tree crosses with jax's sorted keys)."""
    return {k: tree_like(v, tree[k]) if isinstance(v, dict) else tree[k]
            for k, v in like.items()}


def value_and_grad(fn: Callable, params, *args):
    """``(fn(params, *args), d fn / d params)``: the loss detached and
    the gradients as a dict shaped like ``params`` (``jax.value_and_grad``
    over the first argument)."""
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = fn(tree_unflatten(params, live), *args)
    return loss.detach(), tree_unflatten(
        params, list(torch.autograd.grad(loss, live)))


def grads_fn(cfg: ModelConfig, params, tokens, attn_impl: str = "dense",
             head_impl: str = "dense", accum_steps: int = 1,
             label_smoothing: float = 0.0, z_loss: float = 0.0,
             norm_impl: str = "dense", matmul_impl: str = "dense",
             mesh=None):
    """``(mean loss, grads)`` for a ``[B, S+1]`` batch; grads is a dict
    shaped like ``params``.  ``accum_steps > 1`` runs that many equal
    microbatches one after another and averages, so activations live for
    one microbatch at a time; equal microbatches make the mean of means
    the full-batch mean."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    B = tokens.shape[0]
    if B % accum_steps:
        raise ValueError(f"batch {B} must be divisible by accum_steps "
                         f"{accum_steps}")
    def loss_of(p, batch):
        return loss_fn(cfg, p, batch, attn_impl, head_impl, label_smoothing,
                       z_loss, norm_impl, matmul_impl, mesh)

    if accum_steps == 1:
        return value_and_grad(loss_of, params, tokens)
    micro = tokens.reshape(accum_steps, B // accum_steps, tokens.shape[1])
    loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    g_sum = [torch.zeros_like(p) for p in tree_leaves(params)]
    for batch in micro:
        loss, grads = value_and_grad(loss_of, params, batch)
        loss_sum = loss_sum + loss
        g_sum = [a + g for a, g in zip(g_sum, tree_leaves(grads))]
    inv = 1.0 / accum_steps
    return loss_sum * inv, tree_unflatten(params, [g * inv for g in g_sum])


def sgd_train_step(cfg: ModelConfig, lr: float, params, tokens,
                   attn_impl: str = "dense", head_impl: str = "dense",
                   accum_steps: int = 1, norm_impl: str = "dense",
                   matmul_impl: str = "dense", mesh=None):
    """One plain-SGD step: ``(new params, loss)``."""
    loss, grads = grads_fn(cfg, params, tokens, attn_impl=attn_impl,
                           head_impl=head_impl, accum_steps=accum_steps,
                           norm_impl=norm_impl, matmul_impl=matmul_impl,
                           mesh=mesh)
    new = [p.detach() - lr * g for p, g in zip(tree_leaves(params),
                                               tree_leaves(grads))]
    return tree_unflatten(params, new), loss


def make_train_step(cfg: ModelConfig, optimizer=None,
                    attn_impl: str = "dense", head_impl: str = "dense",
                    accum_steps: int = 1, label_smoothing: float = 0.0,
                    z_loss: float = 0.0, norm_impl: str = "dense",
                    matmul_impl: str = "dense", mesh=None):
    """The counterpart of the reference's ``make_optax_train_step`` on one
    device: ``(step, init_opt_state)`` where ``step(params, opt_state,
    tokens) -> (params, opt_state, loss)``.  The optimizer (default:
    :func:`optim.default_optimizer`, AdamW after global-norm clipping)
    updates ``params`` in place and returns the same dict;
    ``init_opt_state.restore`` takes a checkpoint's state.
    :func:`make_optax_train_step` runs it on a mesh."""
    from tpu_dra_torch.workloads.optim import OptStateInit, default_optimizer
    if optimizer is None:
        optimizer = default_optimizer()

    def step(params, opt_state, tokens):
        loss, grads = grads_fn(cfg, params, tokens, attn_impl=attn_impl,
                               head_impl=head_impl,
                               accum_steps=accum_steps,
                               label_smoothing=label_smoothing,
                               z_loss=z_loss, norm_impl=norm_impl,
                               matmul_impl=matmul_impl, mesh=mesh)
        opt_state = optimizer.update(params, grads, opt_state)
        return params, opt_state, loss

    return step, OptStateInit(optimizer, None)


# --------------------------------------------------------------------------
# Sharding over a mesh (mesh.Mesh, or mesh.ProcessMesh: process_train.py)
# --------------------------------------------------------------------------


def param_shardings(cfg: ModelConfig, mesh) -> dict[str, Any]:
    """How each parameter leaf splits over the mesh (``train.
    param_shardings``, 692-714), as one spec per leaf (``Mesh.shard``'s
    form): the big matmuls' feature axes over "tp", norms, embeddings'
    rows and the rest replicated.  The sharded steps on a virtual mesh
    take the whole tree, and on a process mesh each process's shards;
    this says how it is cut into per-rank shards."""
    out: dict[str, Any] = {
        "embed": (None, "tp"),
        "blocks": {
            "wqkv": (None, None, "tp"),
            "wo": (None, "tp", None),
            "w1": (None, None, "tp"),
            "w2": (None, "tp", None),
            "ln1": (None, None),
            "ln2": (None, None),
        },
        "ln_f": (None,),
    }
    if not cfg.tied_embeddings:
        out["unembed"] = (None, "tp")
    if cfg.pos_emb == "learned":
        out["pos"] = (None, "tp")
    return out


def batch_sharding(mesh) -> tuple:
    """The token batch's spec (``train.batch_sharding``, 717-723): rows
    over ``("dcn", "dp")`` on a multislice mesh, else over "dp"
    (:meth:`Mesh.batch_axes`)."""
    return (mesh.batch_axes(), None)


def make_sharded_train_step(cfg: ModelConfig, mesh, lr: float = 1e-2,
                            attn_impl: str = "dense",
                            head_impl: str = "dense", accum_steps: int = 1,
                            norm_impl: str = "dense",
                            matmul_impl: str = "dense"):
    """The DP×TP SGD step over ``mesh`` (axes "dp", "tp"; the counterpart
    of ``train.make_sharded_train_step``, 726-753): ``(step, p_shard,
    b_shard)`` with ``step(params, tokens) -> (params, loss)`` on the
    mesh's device (inputs anywhere else raise ``ValueError``).

    ``matmul_impl="dense"`` computes what the one-device step computes:
    GSPMD's collectives are plain there, and the step is
    :func:`sgd_train_step` over the whole tree.  ``"fused_collective"``
    runs each sublayer's entry and exit matmul through the ring kernels on
    the mesh (see :func:`_trunk`; no-op on a 1-way "tp" axis).  Anything
    else raises ``ValueError``.

    On a ``mesh.ProcessMesh`` (one process a rank) each process runs its
    share: ``step`` takes and returns this process's shards, cut by
    ``p_shard`` (``ProcessMesh.shard_tree``), and the global window
    batch, the same on every process
    (``process_train.make_process_sharded_train_step``)."""
    if matmul_impl not in MATMUL_IMPLS:
        raise ValueError(f"unknown matmul_impl {matmul_impl!r}; expected "
                         f"'dense' or 'fused_collective'")
    if isinstance(mesh, ProcessMesh):
        from tpu_dra_torch.workloads.process_train import \
            make_process_sharded_train_step
        return make_process_sharded_train_step(
            cfg, mesh, lr, attn_impl, head_impl, accum_steps, norm_impl,
            matmul_impl)
    p_shard = param_shardings(cfg, mesh)
    b_shard = batch_sharding(mesh)

    def step(params, tokens):
        mesh.check_device(tokens, *tree_leaves(params))
        return sgd_train_step(cfg, lr, params, tokens, attn_impl=attn_impl,
                              head_impl=head_impl, accum_steps=accum_steps,
                              norm_impl=norm_impl, matmul_impl=matmul_impl,
                              mesh=mesh)

    return step, p_shard, b_shard


def param_shapes(cfg: ModelConfig, init_fn=None) -> dict:
    """The leaf shapes ``init_fn(cfg, generator)`` gives (default
    :func:`init_params`), as tuples in a tree like its own, made on the
    meta device without drawing a number (``jax.eval_shape``)."""
    tree = (init_fn or init_params)(cfg, torch.Generator(), device="meta")
    return tree_unflatten(tree, [tuple(t.shape) for t in tree_leaves(tree)])


def opt_state_shardings(optimizer, param_shapes, p_shard, mesh,
                        zero1: bool = False):
    """``(opt_sh, init_opt_state)`` for the optimizer of a step on
    ``mesh`` (``train.opt_state_shardings``, 812-857): ``opt_sh`` is
    ``{"count": (), "mu": specs, "nu": specs}``, the count replicated and
    every moment leaf taking its parameter's spec.  With ``zero1`` and
    dp > 1 a moment leaf also takes "dp" on its first replicated
    dimension whose size dp divides (and keeps its parameter's spec where
    there is none); ``init_opt_state(params)`` then stores each moment
    stacked by its spec (``optim.MomentLayout``: each rank a contiguous
    1/dp block) and ``init_opt_state.restore(d)`` stacks the global
    moments of a checkpoint.  Without ZeRO-1 the specs are annotations:
    the moments stay global, as the one-device step keeps them.
    ``param_shapes`` and ``p_shard`` are trees of shapes and specs
    (:func:`param_shapes`, :func:`param_shardings`).

    On a ``mesh.ProcessMesh`` each process holds its own shard of every
    moment, cut by its spec, ZeRO-1 or not
    (``optim.ProcessMomentLayout``)."""
    from tpu_dra_torch.workloads.optim import (MomentLayout, OptStateInit,
                                               ProcessMomentLayout)
    dp = mesh.axis_size("dp")

    def moment_spec(shape, spec):
        if not zero1 or dp <= 1:
            return spec
        full = list(spec) + [None] * (len(shape) - len(spec))
        for dim, (size, entry) in enumerate(zip(shape, full)):
            if entry is None and size % dp == 0:
                full[dim] = "dp"
                return tuple(full)
        return spec                        # nothing dp-divisible: keep

    shapes = tree_leaves(tree_like(p_shard, param_shapes))
    m_specs = tree_unflatten(p_shard, [
        moment_spec(tuple(sh), sp)
        for sh, sp in zip(shapes, tree_leaves(p_shard))])
    opt_sh = {"count": (), "mu": m_specs, "nu": m_specs}
    if isinstance(mesh, ProcessMesh):
        layout = ProcessMomentLayout(mesh, p_shard, m_specs)
    else:
        layout = (MomentLayout(mesh, p_shard, m_specs) if zero1 and dp > 1
                  else None)
    return opt_sh, OptStateInit(optimizer, layout)


def opt_state_bytes_per_rank(opt_sh, param_shapes, mesh) -> int:
    """The moment bytes one rank holds under ``opt_sh`` (fp32 mu and nu,
    each leaf cut by its spec), the figure ZeRO-1 divides by dp."""
    total = 0
    for key in ("mu", "nu"):
        for shape, spec in zip(tree_leaves(tree_like(opt_sh[key],
                                                     param_shapes)),
                               tree_leaves(opt_sh[key])):
            total += 4 * math.prod(mesh.shard_shape(shape, spec))
    return total


def make_optax_train_step(cfg: ModelConfig, mesh, optimizer=None,
                          attn_impl: str = "dense",
                          head_impl: str = "dense", accum_steps: int = 1,
                          label_smoothing: float = 0.0, z_loss: float = 0.0,
                          zero1: bool = False, norm_impl: str = "dense",
                          matmul_impl: str = "dense"):
    """:func:`make_sharded_train_step` with the optimizer (default:
    AdamW after global-norm clipping) in place of SGD
    (``train.make_optax_train_step``, 756-803): ``(step, init_opt_state,
    p_shard, b_shard)`` with ``step(params, opt_state, tokens) ->
    (params, opt_state, loss)`` on the mesh's device (inputs anywhere
    else raise ``ValueError``).  The forward and backward are
    :func:`make_train_step`'s on the whole tree, as GSPMD's plain
    collectives make them; the optimizer state follows
    :func:`opt_state_shardings`, and ``zero1=True`` partitions the
    update over "dp" (bit-equal to ``zero1=False``: the global-norm clip
    still reduces over the whole gradient tree).

    On a ``mesh.ProcessMesh`` (one process a rank) ``step`` takes and
    returns this process's shards of the parameters (cut by ``p_shard``,
    ``ProcessMesh.shard_tree``) and of the moments, and the global window
    batch, the same on every process; ``opt_state.to_dict()`` gathers the
    global moments on every process (a collective)
    (``process_train.make_process_optax_train_step``)."""
    from tpu_dra_torch.workloads.optim import default_optimizer
    if matmul_impl not in MATMUL_IMPLS:
        raise ValueError(f"unknown matmul_impl {matmul_impl!r}; expected "
                         f"'dense' or 'fused_collective'")
    if optimizer is None:
        optimizer = default_optimizer()
    if isinstance(mesh, ProcessMesh):
        from tpu_dra_torch.workloads.process_train import \
            make_process_optax_train_step
        return make_process_optax_train_step(
            cfg, mesh, optimizer, attn_impl, head_impl, accum_steps,
            label_smoothing, z_loss, zero1, norm_impl, matmul_impl)
    p_shard = param_shardings(cfg, mesh)
    b_shard = batch_sharding(mesh)
    _, init_opt_state = opt_state_shardings(optimizer, param_shapes(cfg),
                                            p_shard, mesh, zero1=zero1)
    one_device, _ = make_train_step(
        cfg, optimizer, attn_impl=attn_impl, head_impl=head_impl,
        accum_steps=accum_steps, label_smoothing=label_smoothing,
        z_loss=z_loss, norm_impl=norm_impl, matmul_impl=matmul_impl,
        mesh=mesh)

    def step(params, opt_state, tokens):
        mesh.check_device(tokens, *tree_leaves(params))
        return one_device(params, opt_state, tokens)

    return step, init_opt_state, p_shard, b_shard
