"""Serving weight forms and the int8 KV-cache form, ported from
``tpu_dra/workloads/quant.py``.

Decode re-reads every matmul weight for each generated token, so the
weight bytes set its pace: bf16 halves fp32's, int8 quarters them.

- **int8 weights** (``{"q8": int8 [..., K, N], "s": fp32 [..., N]}``):
  symmetric per-output-channel scales over the contraction axis K.  The
  product quantizes each activation row on the fly (symmetric, per row),
  multiplies int8 by int8 into int32, and rescales by ``s_x`` then
  ``s_w``.  On the card the int32 product is cuBLASLt's
  (``torch._int_mm``), on the CPU the plain version; both are exact, so
  the two agree bit for bit, and with the reference.  ``q8`` is stored
  column-major (the values and shape are the reference's): that is the
  layout cuBLASLt's int8 product takes at full speed.
- **int4 weights** (``{"q4": int8 [..., K, N], "s4": fp32 [..., K/G,
  N]}``): symmetric scales per group of G positions of K and per output
  channel; the values lie in [-7, 7] and are stored one per int8 byte
  (the reference stores ``jnp.int4``).  The product takes each group's
  partial product, then applies the scales: fp32 operands on the CPU
  (the reference's CPU path), bf16 operands with fp32 accumulation on
  the card (the reference's accelerator choice).
- **LoRA** (``{"base", "a", "b", "scale"}``): the base product (plain or
  int8) plus ``scale · (x·A)·B``.

Rounding follows the reference step for step: ``x / s``, round half to
even, clip, all in fp32; ``amax`` floored at 1e-8.

:func:`serving_param_shardings` gives a serving tree's specs on a virtual
or a process mesh (``mesh.py``), as the reference's gives its
``NamedSharding``s; :func:`local_serving_tree` is a process's shards as
its products read them.
"""

from __future__ import annotations

from typing import Any

import torch

Leaf = Any

# weight leaves quantized inside each layer of params["blocks"] ([L, K, N]
# stacks only) and at the top level ([K, N] only); everything else is
# cast to bf16
_QUANT_BLOCK_LEAVES = ("wqkv", "wo", "w1", "w2")
_QUANT_TOP_LEAVES = ("unembed",)

# torch._int_mm on CUDA takes more than 16 rows, and K and N multiples of 8
_INT_MM_MIN_ROWS = 17


def _quantize(tf, dim: int, qmax: float, row_max=None):
    """Symmetric quantization of fp32 ``tf`` over ``dim``: the rounded,
    clipped values (still fp32) and the scales (``dim`` kept, size 1).
    ``qmax`` divides as a tensor on ``tf``'s device: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which can
    land one ulp from the reference's division.  ``row_max`` maps the
    local amax to the one the scale takes (a max across the processes
    that each hold a slice of ``dim``)."""
    amax = tf.abs().amax(dim=dim, keepdim=True)
    if row_max is not None:
        amax = row_max(amax)
    s = torch.clamp(amax, min=1e-8) / tf.new_full((), qmax)
    return torch.clamp(torch.round(tf / s), -qmax, qmax), s


def column_major(q):
    """``q`` with the memory of its last two axes transposed: the same
    values and shape, stored column-major."""
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_int8(w) -> dict:
    """``[..., K, N]`` float → ``{"q8": int8 (column-major), "s": fp32
    [..., N]}`` with symmetric per-output-channel scales over K."""
    q, s = _quantize(w.float(), -2, 127.0)
    return {"q8": column_major(q.to(torch.int8)), "s": s.squeeze(-2)}


def quantize_kv(t):
    """``[..., m, Dh]`` k/v → ``(int8 [..., m, Dh], fp32 scales
    [..., m, 1])`` with symmetric per-position scales (amax / 127)."""
    q, s = _quantize(t.float(), -1, 127.0)
    return q.to(torch.int8), s


def int8_product_ref(xq, wq):
    """The plain version of the int8 product: ``xq [M, K] @ wq [K, N]``
    as int32, through float64 (every product and partial sum is an
    integer below 2^53 for K < 2^39, so the result is exact on any
    device)."""
    return (xq.double() @ wq.double()).to(torch.int32)


def int8_product(xq, wq):
    """Exact int32 ``xq [M, K] @ wq [K, N]`` of int8 operands.

    CPU tensors take the plain version.  CUDA tensors take cuBLASLt's
    int8 product (``torch._int_mm``) or raise: M is padded with zero rows
    past 16, which it requires (the product is exact, so the padding
    changes no bit), and K and N must be multiples of 8.  A column-major
    ``wq`` is the layout it runs at full speed; a row-major one gives the
    same bits, up to 9× slower (``chip_smoke.py`` phase 15 on an H100
    80GB HBM3 at 700 W).  Each call on the card adds one to
    ``int8_product.calls``."""
    if xq.device.type == "cpu":
        return int8_product_ref(xq, wq)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_product runs on cpu or cuda, got "
                         f"{xq.device}")
    M, K = xq.shape
    N = wq.shape[1]
    if K % 8 or N % 8:
        raise ValueError(f"the int8 product on the card needs K and N "
                         f"multiples of 8, got K {K}, N {N}")
    pad = max(0, _INT_MM_MIN_ROWS - M)
    if pad:
        xq = torch.nn.functional.pad(xq, (0, 0, 0, pad))
    y = torch._int_mm(xq.contiguous(), wq)[:M]
    int8_product.calls += 1
    return y


int8_product.calls = 0


def _int8_matmul(x, wq, s_w, row_max=None):
    K, N = wq.shape
    xq, s_x = _quantize(x.float(), -1, 127.0, row_max)
    y = int8_product(xq.to(torch.int8).reshape(-1, K), wq)
    return y.reshape(*x.shape[:-1], N).float() * s_x * s_w


class Int8Matmul(torch.autograd.Function):
    """``x [..., K] @ wq [K, N]`` (int8) → fp32 ``[..., N]``, each row
    of x quantized on the fly.  The backward is the reference's
    straight-through estimator: ``dx = (g·s_w) @ wqᵀ`` in fp32, cast to
    x's dtype; ``wq`` and ``s_w`` get no gradient.  ``row_max``: see
    :func:`_quantize` (a row whose K is cut over processes takes the
    scale of its whole row, as the reference's GSPMD product does)."""

    @staticmethod
    def forward(ctx, x, wq, s_w, row_max=None):
        ctx.save_for_backward(wq, s_w)
        ctx.x_dtype = x.dtype
        return _int8_matmul(x, wq, s_w, row_max)

    @staticmethod
    def backward(ctx, g):
        wq, s_w = ctx.saved_tensors
        dx = (g * s_w).float() @ wq.float().T
        return dx.to(ctx.x_dtype), None, None, None


def int8_matmul(x, wq, s_w, row_max=None):
    """See :class:`Int8Matmul`."""
    return Int8Matmul.apply(x, wq, s_w, row_max)


def quantize_int4(w, group: int = 128) -> dict:
    """``[..., K, N]`` float → ``{"q4": int8 values in [-7, 7], "s4":
    fp32 [..., K/G, N]}`` with symmetric per-(K-group, output-channel)
    scales.  ``group`` is clamped to K and must divide it."""
    wf = w.float()
    k, n = wf.shape[-2:]
    group = min(group, k)
    if k % group:
        raise ValueError(f"group {group} must divide K {k}")
    grouped = wf.reshape(*wf.shape[:-2], k // group, group, n)
    q, s = _quantize(grouped, -2, 7.0)
    return {"q4": q.reshape(wf.shape).to(torch.int8), "s4": s.squeeze(-2)}


def int4_matmul(x, q4, s4):
    """``x [..., K] @ q4 [K, N]`` with group scales ``s4 [K/G, N]`` →
    fp32 ``[..., N]``: each group's partial product first, then the
    scales.  fp32 operands on the CPU; bf16 operands with fp32
    accumulation on the card (no bf16 rounding of the partials).
    Weight-only, so autograd gives the exact dx."""
    k, n = q4.shape
    ngroups = s4.shape[0]
    gsz = k // ngroups
    xg = x.reshape(-1, ngroups, gsz).transpose(0, 1)       # [G, R, gsz]
    wg = q4.reshape(ngroups, gsz, n)
    if x.device.type == "cuda":
        yg = torch.bmm(xg.to(torch.bfloat16), wg.to(torch.bfloat16),
                       out_dtype=torch.float32)
    else:
        yg = torch.bmm(xg.float(), wg.float())             # [G, R, N]
    y = torch.einsum("grn,gn->rn", yg, s4.float())
    return y.reshape(*x.shape[:-1], n)


def is_quantized(w: Leaf) -> bool:
    return isinstance(w, dict) and "q8" in w


def is_quantized4(w: Leaf) -> bool:
    return isinstance(w, dict) and "q4" in w


def is_lora(w: Leaf) -> bool:
    return isinstance(w, dict) and "a" in w and "b" in w


def matmul_any(x, w: Leaf, dtype=None):
    """The one matmul the model paths call, dispatched on the weight
    leaf's form:

    - a tensor: ``x @ w`` with w cast to ``dtype`` (default: x's dtype);
      the result takes the promoted dtype of the two, as ``jnp`` does;
    - ``{"q8", "s"}``: the int8 product, cast to ``dtype`` (with a
      ``"row_max"``, :func:`local_serving_tree`'s, the rows' scales
      span the processes that hold their K);
    - ``{"q4", "s4"}``: the group-scaled int4 product, cast to ``dtype``;
    - ``{"base", "a", "b", "scale"}``: the base product (any form) plus
      ``scale · (x·A)·B``.
    """
    out_dtype = dtype or x.dtype
    if is_lora(w):
        base = matmul_any(x, w["base"], out_dtype)
        xa = x.to(out_dtype) @ w["a"].to(out_dtype)
        return base + (xa @ w["b"].to(out_dtype)) * w["scale"].to(out_dtype)
    if is_quantized(w):
        return int8_matmul(x, w["q8"], w["s"],
                           w.get("row_max")).to(out_dtype)
    if is_quantized4(w):
        return int4_matmul(x, w["q4"], w["s4"]).to(out_dtype)
    if isinstance(w, dict):
        raise ValueError(f"unrecognized weight leaf {sorted(w)}")
    dt = torch.promote_types(x.dtype, out_dtype)
    return x.to(dt) @ w.to(dt)


def cast_params_bf16(params: dict) -> dict:
    """Serving cast: every floating leaf → bf16 (norm gains included —
    rmsnorm upcasts to fp32 internally)."""
    def cast(leaf):
        if isinstance(leaf, dict):
            return {k: cast(v) for k, v in leaf.items()}
        if torch.is_tensor(leaf) and leaf.is_floating_point():
            return leaf.to(torch.bfloat16)
        return leaf
    return cast(params)


def _quantize_params(params: dict, qfn) -> dict:
    """The serving quantizers' leaf rules: ``[L, K, N]`` block stacks
    named in ``_QUANT_BLOCK_LEAVES`` and ``[K, N]`` top leaves named in
    ``_QUANT_TOP_LEAVES`` become ``qfn(leaf)``, quantized from the
    full-precision leaf (not its bf16 copy); dict leaves (already
    quantized, or LoRA-wrapped) are kept; everything else is cast to
    bf16."""
    out = dict(cast_params_bf16(params))
    blocks = dict(out["blocks"])
    for name in _QUANT_BLOCK_LEAVES:
        leaf = params["blocks"].get(name)
        if torch.is_tensor(leaf) and leaf.dim() == 3:
            blocks[name] = qfn(leaf)
    out["blocks"] = blocks
    for name in _QUANT_TOP_LEAVES:
        leaf = params.get(name)
        if torch.is_tensor(leaf) and leaf.dim() == 2:
            out[name] = qfn(leaf)
    return out


def quantize_params_int8(params: dict) -> dict:
    """fp32/bf16 params → int8 serving params (``{"q8", "s"}`` leaves;
    see :func:`_quantize_params`)."""
    return _quantize_params(params, quantize_int8)


def serving_param_shardings(cfg, mesh, params: dict) -> dict:
    """The specs of a serving tree (plain, bf16, int8 or int4) on a TP
    mesh (``quant.serving_param_shardings``, 277-332), one
    ``Mesh.shard`` spec a leaf, shaped like ``params``: a weight keeps
    its ``train.param_shardings`` spec; an int8 scale ``s [..., N]``
    takes it without the K axis; an int4 scale ``s4 [..., K/G, N]``
    keeps K split only where the group count divides over K's mesh axes,
    and replicates it otherwise.  The port stores int4 one value a byte,
    but its leaf shapes are the reference's logical ones, and so are the
    specs.  An unknown dict leaf raises ``ValueError``.  On a
    ``mesh.ProcessMesh`` the specs are the same, and
    ``ProcessMesh.shard_tree`` cuts a serving tree by them; a process's
    products read its shards through :func:`local_serving_tree`."""
    import math

    from tpu_dra_torch.workloads.mesh import axes_of
    from tpu_dra_torch.workloads.train import param_shardings

    base = param_shardings(cfg, mesh)

    def leaf(spec, w: Leaf):
        if not isinstance(w, dict):
            return spec
        if not (is_quantized(w) or is_quantized4(w)):
            raise ValueError(f"unrecognized serving leaf {sorted(w)}")
        q = w["q8"] if is_quantized(w) else w["q4"]
        parts = tuple(spec) + (None,) * (q.dim() - len(spec))
        *lead, pk, pn = parts
        if is_quantized(w):
            return {"q8": spec, "s": (*lead, pn)}
        ngroups = w["s4"].shape[-2]
        split = math.prod(mesh.axis_size(a) for a in axes_of(pk))
        pk_s = pk if pk is not None and ngroups % split == 0 else None
        return {"q4": spec, "s4": (*lead, pk_s, pn)}

    out = dict(base)
    blocks = dict(base["blocks"])
    for name in _QUANT_BLOCK_LEAVES:
        if name in params["blocks"] and name in blocks:
            blocks[name] = leaf(blocks[name], params["blocks"][name])
    out["blocks"] = blocks
    for name in _QUANT_TOP_LEAVES:
        if name in params and name in base:
            out[name] = leaf(base[name], params[name])
    return out


def _k_block(mesh, entry) -> tuple:
    """``(index, parts)`` of this process's block of a dimension that
    ``entry`` cuts over the process mesh (the first axis outermost, as
    ``ProcessMesh.shard`` cuts it)."""
    from tpu_dra_torch.workloads.mesh import axes_of
    idx, parts = 0, 1
    for a in axes_of(entry):
        idx = idx * mesh.axis_size(a) + mesh.axis_index(a)
        parts *= mesh.axis_size(a)
    return idx, parts


class RowMax:
    """The ``row_max`` of an int8 leaf whose K a process holds a slice of
    (:func:`local_serving_tree`): the elementwise max of the rows' amax
    over the process mesh's ``axes`` that cut K (``ProcessMesh.pmax``).
    A layer's slice of the stacked leaf (``train.layer_params``) keeps
    the same reducer."""

    def __init__(self, mesh, axes: tuple):
        self.mesh, self.axes = mesh, axes

    def __call__(self, amax):
        for a in self.axes:
            amax = self.mesh.pmax(amax, a)
        return amax

    def __getitem__(self, i):
        return self


def _local_leaf(mesh, w: Leaf, spec):
    """One serving leaf of this process as its product reads it (see
    :func:`local_serving_tree`)."""
    from tpu_dra_torch.workloads.mesh import axes_of
    if not isinstance(w, dict):
        return w
    q = w["q8"] if is_quantized(w) else w["q4"]
    qspec = spec if not isinstance(spec, dict) else \
        spec["q8" if is_quantized(w) else "q4"]
    pk = (tuple(qspec) + (None,) * q.dim())[q.dim() - 2]
    if pk is None:
        return w
    if is_quantized(w):
        return dict(w, row_max=RowMax(mesh, axes_of(pk)))
    if not isinstance(spec, dict):
        raise ValueError("an int4 leaf cut by rows needs its "
                         "serving_param_shardings spec (s4's is not "
                         "its weight's)")
    sspec = tuple(spec["s4"]) + (None,) * w["s4"].dim()
    if sspec[w["s4"].dim() - 2] is not None:
        return w                              # s4 cut with q4's rows
    idx, parts = _k_block(mesh, pk)
    k_local, ngroups = q.shape[-2], w["s4"].shape[-2]
    group = k_local * parts // ngroups
    if group % k_local:
        raise ValueError(
            f"an int4 leaf q4 {tuple(q.shape)} (this process's rows of K "
            f"{k_local * parts}, cut over {parts} ranks) with s4 "
            f"{tuple(w['s4'].shape)} (groups of {group} rows, replicated) "
            f"cannot be cut by rows: a process's {k_local} rows straddle "
            f"its groups")
    g = idx * k_local // group
    return {"q4": w["q4"], "s4": w["s4"].narrow(-2, g, 1)}


def local_serving_tree(mesh, params: dict, specs: dict) -> dict:
    """This process's shards of a serving tree (``ProcessMesh.shard_tree``
    by ``specs``, :func:`serving_param_shardings`' tree; a tree without
    int4 leaves may take ``train.param_shardings``') as its products read
    them, where a leaf's K (its rows) is cut over the process mesh:

    - an int8 leaf gets a ``"row_max"``: each activation row's amax is
      the max over the processes that hold the row's K slices, so a row
      is quantized with its whole row's scale, as the reference's
      product does;
    - an int4 leaf whose ``s4`` is replicated (its group count does not
      divide the axes that cut K) keeps the scale row of the one group
      its K rows lie in; where a process's rows straddle two groups the
      reference's layout cannot be cut by rows, and this raises
      ``ValueError`` naming the shapes.

    Every other leaf is the shard itself."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict) and not (is_quantized(v)
                                        or is_quantized4(v)):
            out[k] = local_serving_tree(mesh, v, specs[k])
        else:
            out[k] = _local_leaf(mesh, v, specs[k])
    return out


def quantize_params_int4(params: dict, group: int = 128) -> dict:
    """fp32/bf16 params → int4 serving params (``{"q4", "s4"}`` leaves;
    see :func:`_quantize_params`)."""
    return _quantize_params(params, lambda w: quantize_int4(w, group))
