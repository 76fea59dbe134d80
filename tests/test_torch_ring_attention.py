"""The port's ring attention (tpu_dra_torch/workloads/ring_attention.py)
against the reference's on host-device meshes: both engines (the fp32
online softmax and the flash engine with logsumexp merges) with both kv
hops (``hop_impl="xla"``, the plain ``ppermute``; ``"pallas"``, the
ring-shift kernel, its plain version here and the interpreted Pallas
kernel there), forward and gradients; ``flash_attention_with_lse`` with its
l2 cotangent; and ``make_ring_train_step`` on a dp × sp = 2 × 2 mesh.

Tolerances.  Attention outputs and their gradients are bf16: held
elementwise within ``flash.ELEM_TOL`` (2^-6, relative plus absolute;
seen on the CPU: 0.24 of it).  The train step as in
test_torch_train_step.py: loss within 5e-3, every leaf's update within
3% relative L2 (seen: 1.1e-3 and 1.35%).  l2 is fp32: within 1e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from torch_parity import CPU, cfg_pair, f32, jax_params, to_torch

from tpu_dra.workloads import pallas_kernels as pk
from tpu_dra.workloads import ring_attention as jra
from tpu_dra.workloads import train as jt
from tpu_dra_torch.workloads import collective_matmul as cm
from tpu_dra_torch.workloads import flash as tf
from tpu_dra_torch.workloads import ring_attention as tra
from tpu_dra_torch.workloads import train as tt
from tpu_dra_torch.workloads.mesh import Mesh

TOL = tf.ELEM_TOL
LOSS_ATOL = 5e-3
LEAF_REL = 3e-2
MESHES = {"sp4": {"sp": 4}, "dp2xsp2": {"dp": 2, "sp": 2}}


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


ENGINES = {"xla": (jra.make_ring_attention, tra.make_ring_attention),
           "flash": (jra.make_ring_attention_flash,
                     tra.make_ring_attention_flash)}


@pytest.mark.parametrize("hkv", [2, 1], ids=["mha", "gqa"])
@pytest.mark.parametrize("hop", ["xla", "pallas"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ring_attention_matches_the_reference(mesh, engine, hop, hkv):
    """Outputs and the gradients of a weighted sum, causal."""
    axes = MESHES[mesh]
    B, H, S, D = 2, 2, 32, 16
    q, k, v = bf16(1, (B, H, S, D)), bf16(2, (B, hkv, S, D)), \
        bf16(3, (B, hkv, S, D))
    cot = bf16(4, (B, H, S, D))
    jmake, tmake = ENGINES[engine]
    jfn = jmake(jmesh(axes), axis_name="sp", hop_impl=hop)

    def jloss(q, k, v):
        return jnp.sum(jfn(q, k, v).astype(jnp.float32) * cot)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jax.jit(jfn)(jq, jk, jv)
    wgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jq, jk, jv)

    tfn = tmake(Mesh(axes, device=CPU), axis_name="sp", hop_impl=hop)
    ins = [tt_(a).requires_grad_() for a in (q, k, v)]
    out = tfn(*ins)
    close(out, want)
    grads = torch.autograd.grad(out, ins, tt_(cot))
    for g, w in zip(grads, wgrads):
        close(g, w)


def test_flash_attention_with_lse_matches_the_reference():
    """Both outputs, and the gradients with a cotangent on each (the l2
    cotangent folds into dd), against the interpreted Pallas kernels."""
    B, H, S, D = 2, 4, 64, 32
    q, k, v = (bf16(s, (B, H, S, D)) for s in (5, 6, 7))
    g_out, g_l2 = bf16(8, (B, H, S, D)), bf16(9, (B, H, S))

    def jf(q, k, v):
        return pk.flash_attention_with_lse(q, k, v, causal=True, bq=32,
                                           bk=32, interpret=True)

    def jloss(q, k, v):
        o, l2 = jf(q, k, v)
        return jnp.sum(o.astype(jnp.float32) * g_out) + jnp.sum(l2 * g_l2)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    w_out, w_l2 = jf(jq, jk, jv)
    wgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)

    ins = [tt_(a).requires_grad_() for a in (q, k, v)]
    out, l2 = tf.flash_attention_with_lse(*ins, causal=True)
    close(out, w_out)
    assert l2.dtype == torch.float32 and l2.shape == (B, H, S)
    np.testing.assert_allclose(f32(l2), np.asarray(w_l2), atol=1e-4)
    loss = (out.float() * torch.tensor(g_out)).sum() \
        + (l2 * torch.tensor(g_l2)).sum()
    for g, w in zip(torch.autograd.grad(loss, ins), wgrads):
        close(g, w)


def test_an_unused_output_leaves_the_flash_backward_as_it_is():
    """``FlashAttentionLse`` serves both front doors: with only ``out``
    used (``flash_attention``) the gradients are the flash backward's with
    no l2 cotangent, bit for bit, and with only ``l2`` used they are its
    backward with a zero dO."""
    B, H, S, D = 1, 2, 32, 16
    q, k, v = (tt_(bf16(s, (B, H, S, D))) for s in (10, 11, 12))
    g_out, g_l2 = tt_(bf16(13, (B, H, S, D))), torch.tensor(bf16(14, (B, H,
                                                                        S)))
    fold = [t.reshape(B * H, S, D) for t in (q, k, v)]
    out, l2 = tf.flash_attn_fwd(*fold, True)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(tf.flash_attention(*ins, bwd_impl="split"),
                              ins, g_out)
    want = tf.flash_attn_bwd(*fold, out, l2, g_out.reshape(B * H, S, D))
    for a, b in zip(got, want):
        assert torch.equal(a.reshape(b.shape), b)
    _, l2_only = tf.flash_attention_with_lse(*ins, bwd_impl="split")
    got = torch.autograd.grad(l2_only, ins, g_l2)
    want = tf.flash_attn_bwd(*fold, out, l2, torch.zeros_like(out),
                             g_l2=g_l2.reshape(B * H, S))
    for a, b in zip(got, want):
        assert torch.equal(a.reshape(b.shape), b)


def test_ring_entry_points_refuse_inputs_off_the_mesh_device():
    """A mesh's functions run on its device: CPU inputs to a mesh on
    another device raise rather than run where they lie."""
    mesh = Mesh({"dp": 1, "sp": 2}, device="meta")
    z = torch.zeros((1, 2, 8, 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="runs on meta"):
        tra.make_ring_attention_flash(mesh)(z, z, z)
    cfg = tt.ModelConfig(**RING_CFG)
    params = to_torch(jax_params(jt.ModelConfig(**RING_CFG)))
    step, _ = tra.make_ring_train_step(cfg, mesh)
    toks = torch.zeros((2, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="runs on meta"):
        step(params, toks, toks)


def test_ring_flash_folds_only_past_blocks_and_hops_exactly(monkeypatch):
    """At sp = 4 the flash engine runs the diagonal for every rank, then
    at step t the ranks t..3 only: n flash launches' worth of calls, and
    2·(n − 1) shifts forward and as many backward."""
    calls = {"fwd": [], "shift": 0}
    real_fwd, real_shift = tf.flash_attn_fwd, cm.ring_shift

    def fwd(q, *a, **kw):
        calls["fwd"].append(q.shape[0])
        return real_fwd(q, *a, **kw)

    def shift(*a, **kw):
        calls["shift"] += 1
        return real_shift(*a, **kw)
    monkeypatch.setattr(tf, "flash_attn_fwd", fwd)
    monkeypatch.setattr(cm, "ring_shift", shift)
    B, H, S, D, n = 1, 2, 32, 16, 4
    ins = [tt_(bf16(s, (B, H, S, D))).requires_grad_() for s in (1, 2, 3)]
    fn = tra.make_ring_attention_flash(Mesh({"sp": n}, device=CPU),
                                       hop_impl="pallas")
    out = fn(*ins)
    assert calls["fwd"] == [n * B * H, 3 * B * H, 2 * B * H, 1 * B * H]
    assert calls["shift"] == 2 * (n - 1)
    out.float().sum().backward()
    assert calls["shift"] == 4 * (n - 1)


def test_unknown_hop_and_ring_impls_raise():
    z = torch.zeros((1, 2, 1, 1, 4, 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="hop_impl"):
        tra.ring_attention(z, z, z, hop_impl="bogus")
    mesh = Mesh({"dp": 1, "sp": 2}, device=CPU)
    with pytest.raises(ValueError, match="ring_impl"):
        tra.make_ring_train_step(tt.ModelConfig(), mesh, ring_impl="zigzag")
    with pytest.raises(ValueError, match="batch axes"):
        tra.make_ring_train_step(tt.ModelConfig(),
                                 Mesh({"tp": 2, "sp": 2}, device=CPU))


RING_CFG = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                max_seq=32)


@pytest.mark.parametrize("hop", ["xla", "pallas"])
@pytest.mark.parametrize("ring", ["xla", "flash"])
def test_ring_train_step_matches_the_reference(ring, hop):
    """One DP×SP step on a 2 × 2 mesh: the loss and every leaf's update
    against the reference's (which carries the mesh's rank count, 4, over
    the gradient of the mean loss; so does the port's)."""
    jcfg, tcfg = cfg_pair(**RING_CFG)
    params = jax_params(jcfg)
    toks = np.random.default_rng(3).integers(0, 64, (4, 32)).astype(
        np.int32)
    tgts = np.roll(toks, -1, axis=1)
    jm = jmesh({"dp": 2, "sp": 2})
    jstep, sh = jra.make_ring_train_step(jcfg, jm, lr=1.0, ring_impl=ring,
                                         hop_impl=hop)
    want, want_loss = jstep(params, jax.device_put(jnp.asarray(toks), sh),
                            jax.device_put(jnp.asarray(tgts), sh))
    step, spec = tra.make_ring_train_step(
        tcfg, Mesh({"dp": 2, "sp": 2}, device=CPU), lr=1.0, ring_impl=ring,
        hop_impl=hop)
    assert spec == ("dp", "sp")
    got, got_loss = step(to_torch(params), torch.from_numpy(toks),
                         torch.from_numpy(tgts))
    assert abs(float(got_loss) - float(want_loss)) < LOSS_ATOL
    p0 = tt.tree_leaves(to_torch(params))
    for a, b, c in zip(p0, tt.tree_leaves(got),
                       jax.tree.leaves(want)):
        gw = f32(a) - np.asarray(c, np.float32)
        gg = f32(a) - f32(b)
        assert np.linalg.norm(gg - gw) / np.linalg.norm(gw) < LEAF_REL


def test_ring_step_is_the_one_device_step_scaled_by_the_rank_count():
    """The ring step's loss is the one-device mean loss on the same
    windows, and its update is lr · (dp · sp) · the one-device gradient."""
    _, tcfg = cfg_pair(**RING_CFG)
    params = to_torch(jax_params(jt.ModelConfig(**RING_CFG)))
    win = torch.from_numpy(np.random.default_rng(4).integers(
        0, 64, (4, 33)))
    loss1, g1 = tt.grads_fn(tcfg, params, win, attn_impl="flash")
    step, _ = tra.make_ring_train_step(
        tcfg, Mesh({"dp": 2, "sp": 2}, device=CPU), lr=1.0,
        ring_impl="flash", hop_impl="pallas")
    new, loss = step(params, win[:, :-1], win[:, 1:])
    assert abs(float(loss) - float(loss1)) < LOSS_ATOL
    for p, q, g in zip(tt.tree_leaves(params), tt.tree_leaves(new),
                       tt.tree_leaves(g1)):
        upd = (p - q) / 4
        assert float((upd - g).norm() / g.norm()) < LEAF_REL


def test_embedding_gradient_is_the_fp32_sum_of_its_rows_gradients():
    """A window whose tokens recur (a 64-token motif over 16 × 512
    tokens: each about 128 times): ``train.embed_rows`` gives each token's
    gradient as the fp32 sum of its rows' bf16 gradients, in any order of
    the tokens (the one-device order and the sequence-sharded rank-major
    one), and its forward is the reference's cast-then-gather bit for bit.
    The cast-then-gather backward adds into a bf16 table and is 1.4%
    (relative L2) off that sum here, and it was the layout-dependent 4.8%
    between the flagship's sharded and one-device steps on the card."""
    g = torch.Generator().manual_seed(0)
    table = torch.randn((512, 64), generator=g) * 0.125
    motif = torch.randint(0, 512, (64,), generator=g)
    toks = motif.repeat(16 * 512 // 64).reshape(16, 512)
    cot = torch.randn((16, 512, 64), generator=g).bfloat16()
    exact = torch.zeros(512, 64).index_add_(0, toks.reshape(-1),
                                            cot.float().reshape(-1, 64))

    def grad(order, rows):
        t = table.clone().requires_grad_()
        (d,) = torch.autograd.grad(rows(t, order(toks)), t, order(cot))
        return d

    def rank_major(t):            # [B, S, ...] -> [sp, B, S/sp, ...]
        return t.reshape(16, 4, 128, *t.shape[2:]).transpose(0, 1)

    def cast_first(t, idx):
        return t.to(torch.bfloat16)[idx]
    for order in (lambda t: t, rank_major):
        d = grad(order, tt.embed_rows)
        assert float((d - exact).norm() / exact.norm()) < 1e-6
    old = grad(lambda t: t, cast_first)
    assert float((old - exact).norm() / exact.norm()) > 1e-2
    assert torch.equal(tt.embed_rows(table, toks), cast_first(table, toks))
