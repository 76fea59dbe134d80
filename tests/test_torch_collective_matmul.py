"""The port's ring kernels (tpu_dra_torch/workloads/collective_matmul.py)
and virtual mesh (mesh.py) against the reference's interpreted Pallas ring
kernels under ``shard_map`` on one-axis meshes of n = 1, 2 and 4 host
devices (the reference's own contract tests, tests/test_collective_
matmul.py): forward, VJP, the byte-exact gathered operand, odd shard rows
(the unidirectional ring) and the shift both ways.  On the CPU the port's
wrappers take their plain versions.

Tolerances.  y and the VJPs are bf16 results of fp32 sums taken in a
different order on each side, so they are held elementwise within
``collective_matmul.ELEM_TOL`` (2^-6, relative plus absolute: two to four
bf16 ulps at these magnitudes); the gap seen on the CPU is 0, as the
fp32 sums of 16 bf16 products here are exact in either order.  The
gathered operand and the shift are copies: byte-equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from torch_parity import CPU, f32

from tpu_dra.workloads.pallas_kernels import (_ag_matmul_call,
                                              all_gather_matmul,
                                              matmul_reduce_scatter,
                                              ring_shift)
from tpu_dra.workloads.ring_attention import shard_map
from tpu_dra_torch.workloads import collective_matmul as cm
from tpu_dra_torch.workloads import mesh as tmesh
from tpu_dra_torch.workloads.train import (ModelConfig, batch_sharding,
                                           param_shardings)

TOL = cm.ELEM_TOL


def jmesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("x",))


def bf16(seed, shape):
    """numpy values from a seed, rounded to bf16 (as a float32 array)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def tt(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def close(got, want):
    got, want = f32(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = TOL + TOL * np.abs(want)
    assert np.all(np.abs(got - want) <= bound), \
        float((np.abs(got - want) / bound).max())


def jax_ag(x, w, n):
    """Reference y [n, n·m, N] per device and gathered a [n, n·m, K]."""
    def f(xs, ws):
        y, a = _ag_matmul_call(xs, ws[0], "x", True)
        return y[None], a[None]
    return jax.jit(shard_map(f, mesh=jmesh(n),
                             in_specs=(P("x", None), P("x", None, None)),
                             out_specs=(P("x", None, None),) * 2))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))


@pytest.mark.parametrize("m", [4, 3], ids=["even-m", "odd-m"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_all_gather_matmul_matches_the_interpreted_ring(n, m):
    """y per rank and the gathered operand (byte-exact) for x [n·m, K]
    split into n row shards and one w shard per rank; odd m takes the
    reference's unidirectional ring."""
    K, N = 16, 8
    x = bf16(0, (n * m, K))
    w = bf16(1, (n, K, N))
    y_ref, a_ref = jax_ag(x, w, n)
    y, a = cm.all_gather_matmul(tt(x.reshape(1, n, m, K)),
                                tt(w.reshape(1, n, K, N)))
    close(y[0], y_ref)
    np.testing.assert_array_equal(
        f32(a[0]).reshape(n, n * m, K), np.asarray(a_ref, np.float32))
    np.testing.assert_array_equal(f32(a[0, 0]).reshape(n * m, K), x)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_all_gather_matmul_vjp_matches_the_reference(n):
    m, K, N = 4, 16, 8
    x, w = bf16(2, (n * m, K)), bf16(3, (n, K, N))
    cot = bf16(4, (n, n * m, N))

    def loss(x, w):
        def f(xs, ws, cs):
            y = all_gather_matmul(xs, ws[0], "x", True)
            return jnp.sum(y.astype(jnp.float32) * cs[0])[None]
        return jnp.sum(shard_map(
            f, mesh=jmesh(n), in_specs=(P("x", None), P("x", None, None),
                                        P("x", None, None)),
            out_specs=P("x"))(x, w, jnp.asarray(cot)))

    dx_ref, dw_ref = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    xt = tt(x.reshape(1, n, m, K)).requires_grad_()
    wt = tt(w.reshape(1, n, K, N)).requires_grad_()
    y = cm.AllGatherMatmul.apply(xt, wt)
    dx, dw = torch.autograd.grad(y, (xt, wt), tt(cot[None]))
    close(dx[0].reshape(n * m, K), dx_ref)
    close(dw[0], dw_ref)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_matmul_reduce_scatter_matches_the_interpreted_ring(n):
    m, K, N = 4, 16, 8
    x = np.stack([bf16(10 + d, (n * m, K)) for d in range(n)])
    w = bf16(9, (n, K, N))

    def f(xs, ws):
        return matmul_reduce_scatter(xs[0], ws[0], "x", True)
    y_ref = jax.jit(shard_map(f, mesh=jmesh(n),
                              in_specs=(P("x", None, None),) * 2,
                              out_specs=P("x", None)))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    y = cm.matmul_reduce_scatter(tt(x[None]), tt(w[None]))
    close(y[0].reshape(n * m, N), y_ref)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_matmul_reduce_scatter_vjp_matches_the_reference(n):
    m, K, N = 4, 16, 8
    x = np.stack([bf16(20 + d, (n * m, K)) for d in range(n)])
    w = bf16(19, (n, K, N))
    cot = bf16(18, (n * m, N))

    def loss(x, w):
        def f(xs, ws):
            return matmul_reduce_scatter(xs[0], ws[0], "x", True)
        y = shard_map(f, mesh=jmesh(n), in_specs=(P("x", None, None),) * 2,
                      out_specs=P("x", None))(x, w)
        return jnp.sum(y.astype(jnp.float32) * cot)

    dx_ref, dw_ref = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    xt, wt = tt(x[None]).requires_grad_(), tt(w[None]).requires_grad_()
    y = cm.MatmulReduceScatter.apply(xt, wt)
    dx, dw = torch.autograd.grad(y, (xt, wt), tt(cot.reshape(1, n, m, N)))
    close(dx[0], dx_ref)
    close(dw[0], dw_ref)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_ring_shift_matches_the_interpreted_ring(n, reverse):
    x = bf16(5, (2 * n, 4, 8))
    y_ref = jax.jit(shard_map(lambda v: ring_shift(v, "x", reverse, True),
                              mesh=jmesh(n), in_specs=P("x", None, None),
                              out_specs=P("x", None, None)))(
        jnp.asarray(x, jnp.bfloat16))
    y = cm.ring_shift(tt(x.reshape(1, n, 2, 4, 8)), reverse)
    np.testing.assert_array_equal(f32(y).reshape(x.shape),
                                  np.asarray(y_ref, np.float32))
    # and its cotangent shifts the other way
    xt = tt(x.reshape(1, n, 2, 4, 8)).requires_grad_()
    cot = tt(bf16(6, (1, n, 2, 4, 8)))
    (g,) = torch.autograd.grad(cm.RingShift.apply(xt, reverse), xt, cot)
    assert torch.equal(g, cm.ring_shift_ref(cot, not reverse))


def test_groups_are_separate_rings_sharing_one_weight():
    """Two groups (a dp axis) over one ring: each group gathers only its
    own shards, against the weight shard its rank holds in both."""
    G, n, m, K, N = 2, 4, 2, 8, 16
    x = tt(bf16(7, (G, n, m, K)))
    w = tt(bf16(8, (1, n, K, N)))
    y, a = cm.all_gather_matmul(x, w.expand(G, -1, -1, -1))
    for g in range(G):
        want, _ = cm.all_gather_matmul(x[g:g + 1], w)
        assert torch.equal(y[g:g + 1], want)
        assert torch.equal(a[g, 3].reshape(n * m, K), x[g].reshape(n * m, K))
    rs = cm.matmul_reduce_scatter(
        y, tt(bf16(9, (1, n, N, K))).expand(G, -1, -1, -1))
    assert rs.shape == (G, n, m, K)


def test_psum_scatter_adds_in_ring_order():
    """Chunk c sums from rank c + 1 around to rank c: with values whose
    fp32 sum depends on the order, the result is that order's."""
    n = 4
    vals = torch.tensor([1.0, 2.0 ** 24, -(2.0 ** 24), 1.0])   # per rank
    x = vals[:, None].repeat(1, n)[None]                 # [1, n, n·1]
    got = tmesh.psum_scatter(x, 1, 2)[0, :, 0]
    for c in range(n):
        acc = vals[(c + 1) % n]
        for t in range(1, n):
            acc = vals[(c + 1 + t) % n] + acc
        assert got[c] == acc, (c, got[c], acc)
    assert len(set(got.tolist())) > 1        # the order matters here


def test_mesh_shards_and_reassembles_every_parameter_leaf():
    """``param_shardings`` cuts the flagship-shaped tree into per-rank
    shards of a dp × tp mesh; every leaf comes back whole, replicated axes
    are views, and tp-split leaves hold their slice."""
    cfg = ModelConfig(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                      max_seq=16)
    mesh = tmesh.Mesh({"dp": 2, "tp": 4}, device=CPU)
    r = np.random.default_rng(0)
    specs = param_shardings(cfg, mesh)
    shapes = {"embed": (64, 32), "unembed": (32, 64), "pos": (16, 32),
              "ln_f": (32,)}
    for name, shape in shapes.items():
        t = torch.from_numpy(r.standard_normal(shape).astype(np.float32))
        s = mesh.shard(t, specs[name])
        assert s.shape[:2] == (2, 4)
        assert s.stride(0) == 0                          # replicated on dp
        assert torch.equal(mesh.unshard(s, specs[name]), t)
    wqkv = torch.arange(2 * 32 * 96, dtype=torch.float32).reshape(2, 32, 96)
    s = mesh.shard(wqkv, specs["blocks"]["wqkv"])
    assert s.shape == (2, 4, 2, 32, 24)
    assert torch.equal(s[1, 2], wqkv[:, :, 48:72])
    assert torch.equal(mesh.unshard(s, specs["blocks"]["wqkv"]), wqkv)
    tok = torch.arange(8 * 12).reshape(8, 12)
    st = mesh.shard(tok, (("dp", "tp"), None))          # both axes on rows
    assert torch.equal(st[1, 2], tok[6:7])
    assert torch.equal(mesh.unshard(st, (("dp", "tp"), None)), tok)


def test_mesh_refuses_what_it_cannot_cut(monkeypatch):
    mesh = tmesh.Mesh({"dp": 2, "tp": 4}, device=CPU)
    with pytest.raises(ValueError, match="split"):
        mesh.shard(torch.zeros(6, 3), ("tp", None))
    with pytest.raises(ValueError, match="not in mesh"):
        mesh.shard(torch.zeros(4, 4), ("sp", None))
    with pytest.raises(ValueError, match="last axis"):
        mesh.ring_groups("dp")
    assert mesh.ring_groups("tp") == (2, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.Mesh({"tp": 4})


@pytest.mark.parametrize("axes,want", [
    ({"dp": 2, "tp": 4}, "dp"), ({"dcn": 2, "dp": 2, "tp": 2}, ("dcn", "dp")),
    ({"sp": 4}, None)], ids=["dp", "dcn-dp", "none"])
def test_mesh_batch_axes_are_the_reference_batch_spec(axes, want):
    """One rule for the axes that carry the batch, read by
    ``batch_sharding``, the fused-collective specs and the ring entry
    points: "dcn" and "dp" where the mesh has them."""
    mesh = tmesh.Mesh(axes, device=CPU)
    assert mesh.batch_axes() == want
    assert batch_sharding(mesh) == (want, None)


def test_cpu_wrappers_take_the_plain_versions_without_launching():
    x = tt(bf16(11, (1, 4, 2, 8)))
    w = tt(bf16(12, (1, 4, 8, 8)))
    before = (cm.all_gather_matmul.launches,
              cm.matmul_reduce_scatter.launches, cm.ring_shift.launches)
    y, _ = cm.all_gather_matmul(x, w)
    assert torch.equal(y, cm.all_gather_matmul_ref(x, w)[0])
    cm.matmul_reduce_scatter(y, tt(bf16(13, (1, 4, 8, 8))))
    cm.ring_shift(x)
    assert (cm.all_gather_matmul.launches, cm.matmul_reduce_scatter.launches,
            cm.ring_shift.launches) == before
    with pytest.raises(ValueError, match="takes x"):
        cm.all_gather_matmul(x, w[:, :2])
