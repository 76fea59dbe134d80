"""The port's zigzag ring attention (``zigzag_indices``,
``make_zigzag_ring_attention`` with the fp32 engine and the flash engine,
tpu_dra_torch/workloads/ring_attention.py) against the reference's on
host-device meshes: the gather order, outputs and the gradients of q, k
and v (``jax.grad``), at sp 2 and 4, dp 2 × sp 2 and with GQA.

Tolerances.  Outputs and gradients are bf16: held elementwise within
``flash.ELEM_TOL`` (2^-6, relative plus absolute), as the plain ring's
parity test holds them (tests/test_torch_ring_attention.py).  Against the
one-device attention the fp32 engine is held within 1e-4 (the
reference's own zigzag test's bound)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from torch_parity import CPU, f32

from tpu_dra.workloads import ring_attention as jra
from tpu_dra_torch.workloads import flash as tf
from tpu_dra_torch.workloads import ring_attention as tra
from tpu_dra_torch.workloads.mesh import Mesh

TOL = tf.ELEM_TOL
MESHES = {"sp2": {"sp": 2}, "sp4": {"sp": 4}, "dp2xsp2": {"dp": 2, "sp": 2}}


def jmesh(axes: dict):
    devs = np.array(jax.devices()[:int(np.prod(list(axes.values())))])
    return JMesh(devs.reshape(tuple(axes.values())), tuple(axes))


def bf16(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def tt_(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def close(got, want, tol=TOL):
    got, want = f32(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = tol + tol * np.abs(want)
    assert np.all(np.abs(got - want) <= bound), \
        float((np.abs(got - want) / bound).max())


@pytest.mark.parametrize("seq,n", [(32, 2), (32, 4), (64, 4), (48, 3),
                                   (16, 8)])
def test_zigzag_indices_equal_the_reference(seq, n):
    got = tra.zigzag_indices(seq, n)
    want = np.asarray(jra.zigzag_indices(seq, n))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tra.inverse_permutation(got).numpy(),
                                  np.asarray(jra.inverse_permutation(want)))


def test_zigzag_indices_refuse_a_ragged_sequence():
    with pytest.raises(ValueError, match="zigzag chunks"):
        tra.zigzag_indices(30, 4)


@pytest.mark.parametrize("hkv", [2, 1], ids=["mha", "gqa"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_zigzag_matches_the_reference(mesh, impl, hkv):
    """Outputs, and the gradients of a weighted sum, through both
    packages' zigzag wrappers on the same zigzag-ordered inputs."""
    axes = MESHES[mesh]
    B, H, S, D = 2, 2, 32, 16
    q, k, v = bf16(1, (B, H, S, D)), bf16(2, (B, hkv, S, D)), \
        bf16(3, (B, hkv, S, D))
    cot = bf16(4, (B, H, S, D))
    jfn = jra.make_zigzag_ring_attention(jmesh(axes), axis_name="sp",
                                         impl=impl)

    def jloss(q, k, v):
        return jnp.sum(jfn(q, k, v).astype(jnp.float32) * cot)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jax.jit(jfn)(jq, jk, jv)
    wgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jq, jk, jv)

    tfn = tra.make_zigzag_ring_attention(Mesh(axes, device=CPU),
                                         axis_name="sp", impl=impl)
    ins = [tt_(a).requires_grad_() for a in (q, k, v)]
    out = tfn(*ins)
    close(out, want)
    grads = torch.autograd.grad(out, ins, tt_(cot))
    for g, w in zip(grads, wgrads):
        close(g, w)


@pytest.mark.parametrize("n", [2, 4])
def test_zigzag_fp32_engine_equals_causal_attention(n):
    """Unpermuted, the fp32 engine is causal attention of the natural
    order (fp32 inputs, within 1e-4)."""
    B, H, S, D = 2, 2, 32, 16
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, S, D))
                                .astype(np.float32)) for _ in range(3))
    order = tra.zigzag_indices(S, n)
    inv = tra.inverse_permutation(order)
    fn = tra.make_zigzag_ring_attention(Mesh({"sp": n}, device=CPU))
    out = fn(q[:, :, order], k[:, :, order], v[:, :, order])[:, :, inv]
    s = (q @ k.transpose(-1, -2)) * D ** -0.5
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                      float("-inf"))
    want = torch.softmax(s, dim=-1) @ v
    assert float((out - want).abs().max()) < 1e-4


def test_zigzag_flash_launches_three_attends_a_step(monkeypatch):
    """The flash engine calls the flash forward 3n times a call (three
    rank subsets a step), and as many backward calls."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tf.flash_attn_fwd, tf.flash_attn_bwd

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(tf, "flash_attn_fwd", count("fwd", fwd))
    monkeypatch.setattr(tf, "flash_attn_bwd", count("bwd", bwd))
    n = 4
    fn = tra.make_zigzag_ring_attention(Mesh({"sp": n}, device=CPU),
                                        impl="flash")
    ins = [tt_(bf16(s, (1, 2, 32, 16))).requires_grad_() for s in (1, 2, 3)]
    fn(*ins).float().sum().backward()
    assert calls == {"fwd": 3 * n, "bwd": 3 * n}


def test_zigzag_refuses_an_unknown_impl():
    with pytest.raises(ValueError, match="unknown impl"):
        tra.make_zigzag_ring_attention(Mesh({"sp": 2}, device=CPU),
                                       impl="pallas")
