"""The port's tiled matmul and fused RMSNorm-matmul
(tpu_dra_torch/workloads/matmul.py) against the JAX reference
(tpu_dra/workloads/pallas_kernels.py) on the same inputs: the plain
versions against the Pallas kernels in interpret mode, the autograd
Function against ``jax.value_and_grad`` through ``rmsnorm_matmul_train``,
and the train trunk's admission rule for the fused kernel
(``train._norm_matmul``) against the reference's.

Tolerances.  matmul: both sum bf16 products in fp32 and round once, so
they part only where two fp32 sums straddle a bf16 rounding boundary:
one bf16 ulp, up to 2^-7 relative at the bottom of a binade (and an
absolute floor of 2^-7 for the few sums near 0).  The fused kernel adds
the norm: the fp32 rsqrt of the two frameworks may differ in its last
bit, which can turn one normed element the other way, a change of one
ulp of that element times a weight; held to 2^-6 relative and
absolute.  Gradients through the Function: the same plain math as the
reference's backward, in another summation order: 1e-5 relative on the
loss, and each gradient within 1% of its largest entry (the reference's
own test, tests/test_pallas.py, allows 2%).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import f32

from tpu_dra.workloads import pallas_kernels as pk
from tpu_dra.workloads import train as jt
from tpu_dra_torch.workloads import matmul as tm
from tpu_dra_torch.workloads import train as tt

ULP1 = dict(rtol=2 ** -7, atol=2 ** -7)
ULP2 = dict(rtol=2 ** -6, atol=2 ** -6)


def bf16(r, shape, scale=1.0):
    """bf16-exact float32 numpy from a numpy generator."""
    a = (r.standard_normal(shape) * scale).astype(np.float32)
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def jx(a, dtype=jnp.bfloat16):
    return jnp.asarray(a, dtype)


def th(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


# (m, k, n, blocks): the square case of tests/test_pallas.py at 128
# blocks, a rectangular one with several k steps, and one whose blocks
# are capped at the dimension
MATMUL_CASES = {"square-256": (256, 256, 256, (128, 128, 128)),
                "rect": (128, 384, 256, (64, 128, 128)),
                "capped": (96, 64, 40, (1024, 1024, 512))}


@pytest.mark.parametrize("name", sorted(MATMUL_CASES))
def test_matmul_ref_matches_interpret_kernel(name):
    m, k, n, (bm, bk, bn) = MATMUL_CASES[name]
    r = np.random.default_rng(0)
    x, y = bf16(r, (m, k)), bf16(r, (k, n))
    want = pk.matmul(jx(x), jx(y), bm=bm, bn=bn, bk=bk, interpret=True)
    got = tm.matmul(th(x), th(y), bm=bm, bn=bn, bk=bk)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    np.testing.assert_allclose(f32(got), f32(want), **ULP1)


def test_matmul_raises_where_the_reference_asserts():
    x = torch.zeros((1536, 64), dtype=torch.bfloat16)
    y = torch.zeros((64, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tile evenly"):
        tm.matmul(x, y)                       # 1536 % 1024
    with pytest.raises(ValueError, match="tile evenly"):
        tm.matmul(x[:128], y, bn=96)          # 128 % 96
    with pytest.raises(ValueError, match=r"\[k, n\]"):
        tm.matmul(x, y[:32])
    with pytest.raises(ValueError, match="gamma"):
        tm.fused_rmsnorm_matmul(x[:256], torch.ones(32), y)
    with pytest.raises(ValueError, match="tile evenly"):
        tm.fused_rmsnorm_matmul(x[:300], torch.ones(64), y)


@pytest.mark.parametrize("shape", [(256, 256, 256), (64, 128, 512)],
                         ids=["square-256", "rect"])
def test_fused_rmsnorm_matmul_ref_matches_interpret_kernel(shape):
    """The reference test's shape and gain (tests/test_pallas.py), and a
    rectangular case."""
    m, k, n = shape
    r = np.random.default_rng(1)
    x, w = bf16(r, (m, k)), bf16(r, (k, n))
    g = bf16(r, (k,), 0.1) + 1.0
    want = pk.fused_rmsnorm_matmul(jx(x), jx(g), jx(w), bm=128, bn=128,
                                   interpret=True)
    got = tm.fused_rmsnorm_matmul(th(x), th(g), th(w), bm=128, bn=128)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    np.testing.assert_allclose(f32(got), f32(want), **ULP2)
    # the unfused pair of the train trunk computes the same normed
    pair = tt._rmsnorm(th(x), th(g).float()).float() @ th(w).float()
    np.testing.assert_allclose(f32(got), f32(pair.bfloat16()), **ULP2)


def test_rmsnorm_matmul_function_matches_reference_vjp():
    """Loss and the three gradients of ``sum(out²)`` through
    ``RmsnormMatmul`` against ``rmsnorm_matmul_train`` (interpret mode),
    at the reference test's shapes (tests/test_pallas.py)."""
    r = np.random.default_rng(2)
    x = bf16(r, (32, 64))
    g = np.abs(r.standard_normal(64)).astype(np.float32) + 0.5
    w = bf16(r, (64, 128), 0.1)

    def jloss(x, g, w):
        out = pk.rmsnorm_matmul_train(x, g, w, True)
        return jnp.sum(out.astype(jnp.float32) ** 2)
    want_loss, want = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jx(x), jnp.asarray(g), jx(w))
    tx, tg, tw = th(x).requires_grad_(), th(g, torch.float32) \
        .requires_grad_(), th(w).requires_grad_()
    loss = (tm.RmsnormMatmul.apply(tx, tg, tw).float() ** 2).sum()
    got = torch.autograd.grad(loss, (tx, tg, tw))
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * abs(
        float(want_loss))
    for name, a, b, dtype in zip("xgw", got, want, (torch.bfloat16,
                                                   torch.float32,
                                                   torch.bfloat16)):
        assert a.dtype == dtype, name
        scale = np.abs(f32(b)).max()
        assert np.abs(f32(a) - f32(b)).max() <= 1e-2 * scale, name


def test_cpu_wrappers_take_the_plain_versions_without_launching():
    r = np.random.default_rng(3)
    x, w = th(bf16(r, (64, 32))), th(bf16(r, (32, 48)))
    g = torch.ones(32)
    before = (tm.matmul.launches, tm.fused_rmsnorm_matmul.launches)
    assert torch.equal(tm.matmul(x, w), tm.matmul_ref(x, w))
    assert torch.equal(tm.fused_rmsnorm_matmul(x, g, w),
                       tm.fused_rmsnorm_matmul_ref(x, g, w))
    assert (tm.matmul.launches, tm.fused_rmsnorm_matmul.launches) == before


# (B, S): m = B·S is admitted for 30 (its own block) and 512, refused for
# 300 (300 % 256); n = 192 (wqkv) and 128 (w1) are admitted
ADMISSION = {"m30": (2, 15, True), "m512": (2, 256, True),
             "m300": (3, 100, False)}


@pytest.mark.parametrize("case", sorted(ADMISSION))
def test_norm_matmul_admits_what_the_reference_admits(case, monkeypatch):
    """``_norm_matmul(norm_impl="fused")`` takes the fused kernel exactly
    where the reference's rule does, and matches the reference's
    ``_norm_matmul`` (which runs the Pallas kernel in interpret mode off
    the TPU)."""
    B, S, admitted = ADMISSION[case]
    r = np.random.default_rng(4)
    x, w = bf16(r, (B, S, 64)), r.standard_normal((64, 192)).astype(
        np.float32) * 0.125
    g = (1.0 + 0.1 * r.standard_normal(64)).astype(np.float32)
    calls = []
    real = tm.fused_rmsnorm_matmul

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)
    monkeypatch.setattr(tm, "fused_rmsnorm_matmul", spy)
    got = tt._norm_matmul(th(x), th(g, torch.float32), th(w, torch.float32),
                          torch.bfloat16, "fused")
    assert calls == ([(B * S, 64)] if admitted else [])
    want = jt._norm_matmul(jx(x), jnp.asarray(g), jnp.asarray(w),
                           jnp.bfloat16, "fused")
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, 192)
    np.testing.assert_allclose(f32(got), f32(want), **ULP2)
    # the default takes the plain pair
    calls.clear()
    tt._norm_matmul(th(x), th(g, torch.float32), th(w, torch.float32),
                    torch.bfloat16)
    assert calls == []


def test_norm_matmul_sends_dict_leaves_to_the_plain_pair(monkeypatch):
    """A dict (quantized or LoRA) leaf never reaches the fused kernel: it
    takes the plain pair, rmsnorm then ``matmul_any``."""
    from tpu_dra_torch.workloads.quant import matmul_any, quantize_int8
    calls = []
    monkeypatch.setattr(tm, "fused_rmsnorm_matmul",
                        lambda *a, **kw: calls.append(a))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 256, 64), generator=gen).to(torch.bfloat16)
    leaf = quantize_int8(torch.randn((64, 128), generator=gen))
    got = tt._norm_matmul(x, torch.ones(64), leaf, torch.bfloat16, "fused")
    want = matmul_any(tt._rmsnorm(x, torch.ones(64)), leaf, torch.bfloat16)
    assert calls == [] and torch.equal(got, want)


def test_bench_section_measures_the_card_only(monkeypatch):
    from tpu_dra_torch import bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.section_pallas_matmul()
