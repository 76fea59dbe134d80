"""The port's flash attention (tpu_dra_torch/workloads/flash.py) against
the JAX reference (tpu_dra/workloads/pallas_kernels.py) on the same
inputs: the plain versions against the Pallas kernels in interpret mode
(values, l2 and the split backward), the autograd Function against
``jax.vjp`` of ``flash_attention``, and both against the fp32 oracle
``_attn_reference``.

Tolerances.  Plain version vs interpret kernel: both round q, p and dS to
bf16 at the same points and differ only in summation order and, with
several k blocks, in p being rounded against the running rather than the
final row max, so they agree within two bf16 ulps (2^-7 relative, plus
the same absolute floor for near-zero entries); l2 is fp32, 1e-5.
Against the fp32 oracle the bf16 roundings add up: the reference's own
tests (tests/test_pallas.py) hold the kernel to 2e-2 (values) and 8e-2
(gradients) absolute, and so do these.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import f32

from tpu_dra.workloads import pallas_kernels as pk
from tpu_dra_torch.workloads import flash as tf

ULP2 = dict(rtol=2 ** -7, atol=2 ** -7)
L2_TOL = dict(rtol=0, atol=1e-5)


def case(bh, bhkv, s, d, sk=None, seed=0):
    """bf16-exact q [bh, s, d], k/v [bhkv, sk, d] and a cotangent, as
    float32 numpy from a seed."""
    r = np.random.default_rng(seed)
    sk = sk or s

    def bf16(shape):
        return np.asarray(jnp.asarray(r.standard_normal(shape, np.float32),
                                      jnp.bfloat16).astype(jnp.float32))
    return (bf16((bh, s, d)), bf16((bhkv, sk, d)), bf16((bhkv, sk, d)),
            bf16((bh, s, d)))


def jx(a):
    return jnp.asarray(a, jnp.bfloat16)


def th(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


# (BH, BHkv, S, D, block): g = 1, 2, 4; S 256 over 64-blocks is the
# multi-block online softmax, S 128 over 128-blocks a single block
SHAPES = [(4, 4, 256, 64, 64), (4, 2, 256, 64, 64), (8, 2, 256, 64, 128),
          (4, 4, 128, 128, 128)]
SHAPE_IDS = ["mha-4blk", "gqa2-4blk", "gqa4-2blk", "mha-d128-1blk"]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_fwd_ref_matches_interpret_kernel(shape, causal):
    bh, bhkv, s, d, blk = shape
    q, k, v, _ = case(bh, bhkv, s, d)
    want_out, want_l2 = pk._flash_attn_fwd(jx(q), jx(k), jx(v),
                                           causal=causal, bq=blk, bk=blk,
                                           interpret=True)
    out, l2 = tf.flash_attn_fwd_ref(th(q), th(k), th(v), causal)
    assert out.dtype == torch.bfloat16 and out.shape == (bh, s, d)
    assert l2.dtype == torch.float32 and l2.shape == (bh, s, 1)
    np.testing.assert_allclose(f32(out), f32(want_out), **ULP2)
    np.testing.assert_allclose(f32(l2), f32(want_l2), **L2_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_bwd_ref_matches_interpret_kernels(shape, causal):
    bh, bhkv, s, d, blk = shape
    q, k, v, do = case(bh, bhkv, s, d, seed=1)
    out, l2 = pk._flash_attn_fwd(jx(q), jx(k), jx(v), causal=causal,
                                 bq=blk, bk=blk, interpret=True)
    want = pk._flash_attn_bwd(jx(q), jx(k), jx(v), out, l2, jx(do),
                              causal=causal, bq=blk, bk=blk, interpret=True)
    got = tf.flash_attn_bwd_ref(th(q), th(k), th(v), th(f32(out)),
                                torch.tensor(f32(l2)), th(do), causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        np.testing.assert_allclose(f32(g), f32(w), err_msg=name, **ULP2)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hkv", [4, 2, 1], ids=["mha", "gqa2", "mqa"])
def test_flash_attention_function_matches_jax_vjp(hkv, causal):
    """The autograd Function on the CPU against ``jax.vjp`` of the
    reference front door (interpret mode) and the fp32 oracle."""
    b, h, s, d = 2, 4, 256, 64
    q, k, v, do = case(b * h, b * hkv, s, d, seed=2)
    q4, k4, v4, do4 = (x.reshape(b, -1, s, d) for x in (q, k, v, do))
    out_j, vjp = jax.vjp(lambda q, k, v: pk.flash_attention(
        q, k, v, causal=causal, bq=64, bk=64, interpret=True),
        jx(q4), jx(k4), jx(v4))
    grads_j = vjp(jx(do4))
    tq, tk, tv = (th(x).requires_grad_() for x in (q4, k4, v4))
    out = tf.flash_attention(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad(out, (tq, tk, tv), th(do4))
    np.testing.assert_allclose(f32(out), f32(out_j), **ULP2)
    for name, g, w in zip(("dq", "dk", "dv"), grads, grads_j):
        np.testing.assert_allclose(f32(g), f32(w), err_msg=name, **ULP2)

    # the fp32 oracle, at the reference tests' own tolerances
    def oracle(q, k, v):
        rep = h // hkv
        k, v = (jnp.repeat(t, rep, axis=1) for t in (k, v))
        fold = lambda x: x.reshape(b * h, s, d)
        return pk._attn_reference(fold(q), fold(k), fold(v),
                                  causal=causal).reshape(b, h, s, d)
    out_o, vjp_o = jax.vjp(oracle, jx(q4), jx(k4), jx(v4))
    assert float(np.abs(f32(out) - f32(out_o)).max()) < 2e-2
    for name, g, w in zip(("dq", "dk", "dv"), grads, vjp_o(jx(do4))):
        assert float(np.abs(f32(g) - f32(w)).max()) < 8e-2, name


@pytest.mark.parametrize("s", [1, 63, 65, 200])
def test_ragged_lengths_match_the_reference_padded_path(s):
    """Lengths off the TPU tile: the reference front door pads S to its
    tile (train._flash_attention_fn); the port masks the ragged tail."""
    from tpu_dra.workloads import train as jt
    b, h, d = 1, 2, 64
    q, k, v, do = case(b * h, b * h, s, d, seed=3)
    q4, k4, v4, do4 = (x.reshape(b, h, s, d) for x in (q, k, v, do))
    out_j, vjp = jax.vjp(jt._flash_attention_fn, jx(q4), jx(k4), jx(v4))
    tq, tk, tv = (th(x).requires_grad_() for x in (q4, k4, v4))
    out = tf.flash_attention(tq, tk, tv)
    grads = torch.autograd.grad(out, (tq, tk, tv), th(do4))
    np.testing.assert_allclose(f32(out), f32(out_j), **ULP2)
    for name, g, w in zip(("dq", "dk", "dv"), grads, vjp(jx(do4))):
        np.testing.assert_allclose(f32(g), f32(w), err_msg=name, **ULP2)


def test_l2_is_the_base2_logsumexp_and_out_the_weighted_mean():
    """With q = 0 every score is 0: row i averages v over keys 0..i and
    its base-2 logsumexp is log2(i + 1)."""
    s, d = 5, 64
    q = torch.zeros((1, s, d), dtype=torch.bfloat16)
    v = th(np.random.default_rng(5).standard_normal((1, s, d), np.float32))
    out, l2 = tf.flash_attn_fwd_ref(q, q, v, causal=True)
    rows = torch.arange(1., s + 1)
    np.testing.assert_allclose(f32(l2[0, :, 0]), np.log2(f32(rows)),
                               **L2_TOL)
    mean = v.float()[0].cumsum(0) / rows[:, None]
    np.testing.assert_allclose(f32(out[0]), f32(mean), **ULP2)


def test_rejects_bad_head_ratio_and_unequal_causal_lengths():
    q = torch.zeros((1, 3, 8, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not a multiple"):
        tf.flash_attention(q, k, k)
    k = torch.zeros((1, 3, 16, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="equal q/k lengths"):
        tf.flash_attention(q, k, k, causal=True)
    # non-causal cross-length attention is allowed
    assert tf.flash_attention(q, k, k, causal=False).shape == q.shape
    with pytest.raises(ValueError, match="not a multiple"):
        tf.flash_attn_fwd_ref(q[0], k[0, :2], k[0, :2], causal=False)


def test_cpu_wrappers_take_the_plain_versions_without_launching():
    q, k, v, do = (th(x) for x in case(2, 2, 16, 64, seed=4))
    before = (tf.flash_attn_fwd.launches, tf.flash_bwd_dq.launches,
              tf.flash_bwd_dkdv.launches)
    out, l2 = tf.flash_attn_fwd(q, k, v)
    want = tf.flash_attn_fwd_ref(q, k, v)
    assert torch.equal(out, want[0]) and torch.equal(l2, want[1])
    got = tf.flash_attn_bwd(q, k, v, out, l2, do)
    for g, w in zip(got, tf.flash_attn_bwd_ref(q, k, v, out, l2, do)):
        assert torch.equal(g, w)
    qs = tf._prescale(q)
    dd = (do.float() * out.float()).sum(-1, keepdim=True)
    assert torch.equal(tf.flash_bwd_dq(qs, k, v, do, l2, dd, True),
                       tf.flash_bwd_dq_ref(qs, k, v, do, l2, dd, True))
    for g, w in zip(tf.flash_bwd_dkdv(qs, k, v, do, l2, dd, True),
                    tf.flash_bwd_dkdv_ref(qs, k, v, do, l2, dd, True)):
        assert torch.equal(g, w)
    assert (tf.flash_attn_fwd.launches, tf.flash_bwd_dq.launches,
            tf.flash_bwd_dkdv.launches) == before
