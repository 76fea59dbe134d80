"""Serving weight forms of the PyTorch port
(tpu_dra_torch/workloads/quant.py) against the JAX package on the CPU:
the quantizers bit for bit, the int8 product bit for bit and its
straight-through backward within fp32 rounding, the int4 product within
a stated fp32 tolerance, every leaf form of ``matmul_any``, and serving
trees crossing through ``convert.py``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import cfg_pair, f32, jax_params, to_numpy_tree, to_torch

from tpu_dra.workloads import lora as jlora
from tpu_dra.workloads import quant as jq
from tpu_dra_torch.convert import load_npz, params_from_numpy, save_npz
from tpu_dra_torch.workloads import quant as tq

# int4's product sums each group's partials, then the scaled groups, in
# fp32; the two packages sum in other orders, so they may part by a few
# fp32 ulps of the partial sums: 1e-5 of the output's largest magnitude
INT4_REL = 1e-5
# the STE backward is one fp32 matmul in both packages, summed in other
# orders
STE_REL = 1e-6


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def np_int(a) -> np.ndarray:
    """An integer array of either package (JAX int4 included) as int64."""
    if torch.is_tensor(a):
        return a.numpy().astype(np.int64)
    return np.asarray(a).astype(np.int8).astype(np.int64)


def bits(a) -> np.ndarray:
    """fp32 values of either package as their bit patterns."""
    return f32(a).view(np.uint32)


W_SHAPES = {"2d": (64, 48), "stack": (3, 64, 48)}


@pytest.mark.parametrize("shape", W_SHAPES.values(), ids=W_SHAPES.keys())
def test_quantize_int8_bit_equal(shape):
    w = rand(shape, 1)
    w[..., 5] = 0.0                     # a zero column: the 1e-8 floor
    w[..., 7] *= 1e3                    # a large one
    want = jq.quantize_int8(jnp.asarray(w))
    got = tq.quantize_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(np_int(got["q8"]), np_int(want["q8"]))
    np.testing.assert_array_equal(bits(got["s"]), bits(want["s"]))
    # the product's layout: column-major, same shape
    assert got["q8"].shape == shape and got["q8"].stride(-2) == 1


@pytest.mark.parametrize("group", [16, 64, 128], ids=lambda g: f"g{g}")
@pytest.mark.parametrize("shape", W_SHAPES.values(), ids=W_SHAPES.keys())
def test_quantize_int4_bit_equal(shape, group):
    w = rand(shape, 2)
    w[..., 3, 4] = 40.0                 # an outlier inside one group
    want = jq.quantize_int4(jnp.asarray(w), group)
    got = tq.quantize_int4(torch.from_numpy(w), group)
    assert got["q4"].dtype == torch.int8
    assert int(got["q4"].abs().max()) <= 7
    np.testing.assert_array_equal(np_int(got["q4"]), np_int(want["q4"]))
    np.testing.assert_array_equal(bits(got["s4"]), bits(want["s4"]))


def test_quantize_int4_group_must_divide():
    with pytest.raises(ValueError, match="must divide"):
        tq.quantize_int4(torch.ones(48, 8), group=32)


def flat(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("form", ["int8", "int4"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_quantize_params_bit_equal(form, tied):
    """The same leaves quantized (block stacks and unembed), the rest
    cast to bf16, every leaf bit-equal to the reference's."""
    jcfg, _ = cfg_pair(vocab=64, d_model=32, n_heads=2, n_layers=2,
                       d_ff=64, max_seq=16, tied_embeddings=tied)
    jp = jax_params(jcfg, seed=4)
    if form == "int8":
        want = jq.quantize_params_int8(jp)
        got = tq.quantize_params_int8(to_torch(jp))
    else:
        want = jq.quantize_params_int4(jp, group=16)
        got = tq.quantize_params_int4(to_torch(jp), group=16)
    want, got = dict(flat(to_numpy_tree(want))), dict(flat(got))
    assert sorted(got) == sorted(want)
    quantized = [k for k in got if k.endswith(("/q8", "/q4"))]
    assert len(quantized) == 4 + (not tied)
    for key, leaf in got.items():
        w = want[key]
        if key.endswith(("/q8", "/q4")):
            np.testing.assert_array_equal(np_int(leaf), np_int(w),
                                          err_msg=key)
        else:
            assert str(leaf.dtype).split(".")[-1] == \
                {"bfloat16": "bfloat16", "float32": "float32"}[w.dtype.name]
            np.testing.assert_array_equal(bits(leaf), bits(w), err_msg=key)


def test_quantize_params_keeps_dict_leaves_and_odd_ranks():
    """Already-quantized leaves are kept, and only [L, K, N] block stacks
    and [K, N] top leaves are quantized (the reference's leaf rules)."""
    jcfg, _ = cfg_pair(vocab=64, d_model=32, n_heads=2, n_layers=2,
                       d_ff=64, max_seq=16)
    p = tq.quantize_params_int8(to_torch(jax_params(jcfg)))
    again = tq.quantize_params_int8(p)
    assert torch.equal(again["blocks"]["wqkv"]["q8"],
                       p["blocks"]["wqkv"]["q8"])
    odd = {"blocks": {"w1": torch.ones(2, 3, 4, 8)},
           "unembed": torch.ones(3, 4, 8)}
    out = tq.quantize_params_int8(odd)
    assert torch.is_tensor(out["blocks"]["w1"])
    assert torch.is_tensor(out["unembed"])


X_CASES = {"rows-bf16": ((5, 64), "bf16"), "batch-bf16": ((2, 3, 64), "bf16"),
           "rows-f32": ((7, 64), "f32"), "one-row": ((1, 64), "bf16")}


def x_pair(shape, dtype, seed):
    x = rand(shape, seed, 2.0)
    x[0, ..., 9] = 30.0                 # an outlier row entry
    if dtype == "bf16":
        jx = jnp.asarray(x, jnp.bfloat16)
        return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
            torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("case", X_CASES.values(), ids=X_CASES.keys())
def test_int8_matmul_bit_equal(case):
    shape, dtype = case
    jx, tx = x_pair(shape, dtype, 5)
    w = jq.quantize_int8(jnp.asarray(rand((64, 48), 6)))
    want = jq.int8_matmul(jx, w["q8"], w["s"])
    got = tq.int8_matmul(tx, *to_torch(w).values())
    assert got.dtype == torch.float32 and got.shape == shape[:-1] + (48,)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_int8_product_is_exact_and_refuses_other_devices():
    r = np.random.default_rng(7)
    xq = r.integers(-127, 128, (9, 4096)).astype(np.int8)
    wq = r.integers(-127, 128, (4096, 16)).astype(np.int8)
    got = tq.int8_product(torch.from_numpy(xq), torch.from_numpy(wq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  xq.astype(np.int64) @ wq.astype(np.int64))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tq.int8_product(torch.zeros(2, 8, dtype=torch.int8, device="meta"),
                        torch.zeros(8, 8, dtype=torch.int8, device="meta"))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_int8_matmul_ste_backward_matches_jax_grad(dtype):
    jx, tx = x_pair((2, 3, 64), dtype, 8)
    w = jq.quantize_int8(jnp.asarray(rand((64, 48), 9)))
    g = rand((2, 3, 48), 10)
    want = jax.grad(lambda x: jnp.sum(
        jq.int8_matmul(x, w["q8"], w["s"]) * g))(jx)
    tx = tx.clone().requires_grad_(True)
    tw = to_torch(w)
    (tq.int8_matmul(tx, tw["q8"], tw["s"]) * torch.from_numpy(g)).sum() \
        .backward()
    assert tx.grad.dtype == tx.dtype
    want, got = np.asarray(want, np.float32), f32(tx.grad)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=STE_REL * np.abs(want).max())
    else:                               # one bf16 rounding of each
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("group", [16, 64])
@pytest.mark.parametrize("case", X_CASES.values(), ids=X_CASES.keys())
def test_int4_matmul_fp32_within_tolerance(case, group):
    shape, dtype = case
    jx, tx = x_pair(shape, dtype, 11)
    w = jq.quantize_int4(jnp.asarray(rand((64, 48), 12)), group)
    want = np.asarray(jq.int4_matmul(jx, w["q4"], w["s4"]))
    tw = to_torch(w)
    got = tq.int4_matmul(tx, tw["q4"], tw["s4"])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(f32(got), want, rtol=0,
                               atol=INT4_REL * np.abs(want).max())


def lora_leaf(base, seed):
    return {"base": base, "a": jnp.asarray(rand((64, 4), seed, 0.5)),
            "b": jnp.asarray(rand((4, 48), seed + 1, 0.5)),
            "scale": jnp.asarray(2.0, jnp.float32)}


def leaf_forms():
    w = jnp.asarray(rand((64, 48), 13))
    return {"plain-f32": w, "plain-bf16": w.astype(jnp.bfloat16),
            "int8": jq.quantize_int8(w), "int4": jq.quantize_int4(w, 16),
            "lora-plain": lora_leaf(w.astype(jnp.bfloat16), 14),
            "lora-int8": lora_leaf(jq.quantize_int8(w), 16)}


FORMS = list(leaf_forms())


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("form", FORMS)
def test_matmul_any_every_leaf_form(form, out):
    """Each leaf form through the dispatch: the forms with an exact
    product (int8) bit-equal, the rest within one bf16 rounding (or
    INT4_REL in fp32)."""
    jw = leaf_forms()[form]
    jx, tx = x_pair((2, 3, 64), "bf16", 15)
    odt = {"bf16": (jnp.bfloat16, torch.bfloat16),
           "f32": (jnp.float32, torch.float32)}[out]
    want = np.asarray(jq.matmul_any(jx, jw, odt[0]).astype(jnp.float32))
    tw = to_torch({"w": jw})["w"]
    got = tq.matmul_any(tx, tw, odt[1])
    assert got.dtype == odt[1] and got.shape == (2, 3, 48)
    if form == "int8":
        np.testing.assert_array_equal(f32(got), want)
    elif out == "f32" and form != "plain-f32":
        np.testing.assert_allclose(f32(got), want, rtol=0,
                                   atol=INT4_REL * np.abs(want).max())
    else:
        np.testing.assert_allclose(f32(got), want, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(want).max())


def test_matmul_any_refuses_an_unknown_leaf():
    with pytest.raises(ValueError, match="unrecognized weight leaf"):
        tq.matmul_any(torch.zeros(2, 8), {"q": torch.zeros(8, 8)})


def test_matmul_any_lora_over_int8_gradient_reaches_the_adapters():
    """LoRA over an int8 base trains: the adapters get gradients, the
    activations get the STE's, the int8 base none."""
    w = tq.quantize_int8(torch.from_numpy(rand((64, 48), 17)))
    a = torch.from_numpy(rand((64, 4), 18)).requires_grad_(True)
    b = torch.from_numpy(rand((4, 48), 19)).requires_grad_(True)
    x = torch.from_numpy(rand((3, 64), 20)).requires_grad_(True)
    leaf = {"base": w, "a": a, "b": b, "scale": torch.tensor(2.0)}
    tq.matmul_any(x, leaf).square().sum().backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0)
               for t in (a, b, x))
    assert w["q8"].grad is None


TREE_FORMS = ["int8", "int4", "lora-int8"]


def serving_tree(form):
    jcfg, _ = cfg_pair(vocab=64, d_model=32, n_heads=2, n_layers=2,
                       d_ff=64, max_seq=16)
    jp = jax_params(jcfg, seed=21)
    if form == "int8":
        return jq.quantize_params_int8(jp)
    if form == "int4":
        return jq.quantize_params_int4(jp, group=16)
    lcfg = jlora.LoRAConfig(rank=4)
    lora = jlora.init_lora(jp, lcfg, jax.random.PRNGKey(1))
    return jlora.wrap_lora(jq.quantize_params_int8(jp), lora, lcfg)


@pytest.mark.parametrize("form", TREE_FORMS)
def test_serving_tree_crosses_through_npz_unchanged(form, tmp_path):
    """A quantized JAX tree → params_from_numpy → save_npz → load_npz
    comes back unchanged: same keys, dtypes and bits, int4 as int8
    values in [-7, 7], q8 column-major."""
    jtree = to_numpy_tree(serving_tree(form))
    got = params_from_numpy(jtree, "cpu")
    save_npz(tmp_path / "w.npz", got)
    back = load_npz(tmp_path / "w.npz", "cpu")
    want = dict(flat(jtree))
    got, back = dict(flat(got)), dict(flat(back))
    assert sorted(got) == sorted(back) == sorted(want)
    for key, leaf in got.items():
        assert back[key].dtype == leaf.dtype, key
        assert torch.equal(back[key], leaf), key
        if key.endswith(("/q4", "/q8")):
            assert leaf.dtype == torch.int8
            np.testing.assert_array_equal(np_int(leaf), np_int(want[key]))
        else:
            np.testing.assert_array_equal(bits(leaf), bits(want[key]))
        if key.endswith("/q8"):
            assert leaf.stride(-2) == 1 and back[key].stride(-2) == 1
    # the reference's own numpy tree (int4 as ml_dtypes) writes too
    save_npz(tmp_path / "j.npz", jtree)
    direct = dict(flat(load_npz(tmp_path / "j.npz", "cpu")))
    assert all(torch.equal(direct[k], got[k]) for k in got)
