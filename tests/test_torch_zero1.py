"""The optimizer step on a mesh and ZeRO-1 (tpu_dra_torch/workloads/
train.py ``opt_state_shardings``, ``make_optax_train_step``; optim.py
``MomentLayout``; fit.py on a mesh) against the reference on host-device
meshes: the moment specs, the reference's
``test_zero1_shards_moments_and_matches_plain`` case, the port's ZeRO-1
bit-equal to its replicated moments, and ``fit(mesh, zero1=True)``
resumed exactly, from its own step and by a replicated run.

Tolerances: ZeRO-1 against the replicated moments in the port bit for bit
(the reference's test holds its two runs within ``rtol`` 1e-4); the
port's losses against the reference's within 5e-3 a step, the
cross-framework bound of the one-device step."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from torch_parity import CPU, cfg_pair, jax_params, to_torch

from tpu_dra.workloads import train as jt
from tpu_dra_torch.workloads import fit as tfit
from tpu_dra_torch.workloads import train as tt
from tpu_dra_torch.workloads.mesh import Mesh
from test_torch_fit import motif_corpus

TINY = dict(vocab=32, d_model=32, n_heads=2, n_layers=4, d_ff=64,
            max_seq=16)
LOSS_ATOL = 5e-3


def jmesh(axes: dict):
    devs = np.array(jax.devices()[:int(np.prod(list(axes.values())))])
    return JMesh(devs.reshape(tuple(axes.values())), tuple(axes))


def padded(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("axes,pos", [({"dp": 4, "tp": 2}, "learned"),
                                      ({"dp": 2, "tp": 2}, "rope"),
                                      ({"dp": 1, "tp": 4}, "learned"),
                                      ({"dp": 8, "tp": 1}, "rope")],
                         ids=["dp4xtp2", "dp2xtp2", "tp4", "dp8"])
def test_opt_state_specs_equal_the_reference(axes, pos, zero1):
    """Every moment leaf's spec, entry for entry (a PartitionSpec padded
    to the leaf's rank), and the count replicated."""
    jcfg, tcfg = cfg_pair(**dict(TINY, pos_emb=pos))
    jm = jmesh(axes)
    jsh, _ = jt.opt_state_shardings(
        jt.default_optimizer(),
        lambda: jt.init_params(jcfg, jax.random.PRNGKey(0)),
        jt.param_shardings(jcfg, jm), jm, zero1=zero1)
    adam = jsh[1][0]
    mesh = Mesh(axes, device=CPU)
    shapes = tt.param_shapes(tcfg)
    sh, _ = tt.opt_state_shardings(None, shapes,
                                   tt.param_shardings(tcfg, mesh), mesh,
                                   zero1=zero1)
    assert sh["count"] == () and tuple(adam.count.spec) == ()
    for key in ("mu", "nu"):
        want = getattr(adam, key)
        for path in paths(shapes):
            ndim = len(get(shapes, path))
            assert padded(get(sh[key], path), ndim) == padded(
                get(want, path).spec, ndim), (key, path)


def test_zero1_shards_moments_and_matches_the_reference():
    """The reference's case (dp 4 x tp 2, 5 AdamW steps from the same
    weights and tokens): the port's ZeRO-1 losses within its test's rtol
    1e-4 of the port's replicated run (bit-equal in fact), as the
    reference holds its two runs; against the reference's ZeRO-1 run
    within LOSS_ATOL a step, the cross-framework bound of the one-device
    step (tests/test_torch_train_step.py): the two forwards round their
    bf16 products apart from step 0 (seen: 4.0e-4 at step 0, 1.3e-3 at
    step 5).  A rank's wqkv moment is a quarter of the replicated
    layout's, "dp" on its layer axis."""
    jcfg, tcfg = cfg_pair(**TINY)
    jm = jmesh({"dp": 4, "tp": 2})
    tokens = np.random.default_rng(1).integers(0, 32, (8, 16),
                                               dtype=np.int32)
    jstep, jinit, jps, jbs = jt.make_optax_train_step(jcfg, jm, zero1=True)
    jp = jax_params(jcfg)
    jparams = jax.device_put(jp, jps)
    jopt = jinit(jparams)
    jtok = jax.device_put(jnp.asarray(tokens), jbs)
    want = []
    for _ in range(5):
        jparams, jopt, loss = jstep(jparams, jopt, jtok)
        want.append(float(loss))

    mesh = Mesh({"dp": 4, "tp": 2}, device=CPU)

    def run(zero1):
        step, init_opt, p_shard, b_shard = tt.make_optax_train_step(
            tcfg, mesh, zero1=zero1)
        params = to_torch(jp)
        opt = init_opt(params)
        losses = []
        for _ in range(5):
            params, opt, loss = step(params, opt, torch.from_numpy(tokens))
            losses.append(float(loss))
        return losses, opt, p_shard, b_shard

    plain, _, _, _ = run(False)
    got, opt, p_shard, b_shard = run(True)
    np.testing.assert_allclose(got, plain, rtol=1e-4)
    assert np.max(np.abs(np.array(got) - np.array(want))) < LOSS_ATOL
    mu = opt.mu["blocks"]["wqkv"]
    assert tuple(mu.shape[:2]) == (4, 2)
    assert mu[0, 0].numel() * 4 * 2 == tcfg.n_layers * 32 * 96
    assert opt.layout.moment_specs["blocks"]["wqkv"] == ("dp", None, "tp")
    assert b_shard == ("dp", None) and p_shard["blocks"]["wo"] == (
        None, "tp", None)


@pytest.mark.parametrize("axes", [{"dp": 4, "tp": 2}, {"dp": 2, "tp": 1},
                                  {"dp": 3, "tp": 1}],
                         ids=["dp4xtp2", "dp2", "dp3"])
def test_zero1_is_bit_equal_to_replicated_moments(axes):
    """5 steps with ZeRO-1 against 5 with replicated moments: losses,
    parameters and (gathered) moments bit-equal; each rank's moment bytes
    1/dp of the replicated layout's for every leaf with a dp-divisible
    replicated dimension (dp 3 divides none of some leaves: those keep
    the parameter's spec)."""
    _, tcfg = cfg_pair(**dict(TINY, pos_emb="rope"))
    mesh = Mesh(axes, device=CPU)
    dp = axes["dp"]
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 32, (6 if dp == 3 else 8, 17), dtype=np.int32))

    def run(zero1):
        gen = torch.Generator()
        gen.manual_seed(0)
        params = tt.init_params(tcfg, gen)
        step, init_opt, _, _ = tt.make_optax_train_step(tcfg, mesh,
                                                        zero1=zero1)
        opt = init_opt(params)
        losses = []
        for _ in range(5):
            params, opt, loss = step(params, opt, tokens)
            losses.append(float(loss))
        return losses, params, opt

    a, b = run(False), run(True)
    assert a[0] == b[0]
    for x, y in zip(tt.tree_leaves(a[1]), tt.tree_leaves(b[1])):
        assert torch.equal(x, y)
    da, db = a[2].to_dict(), b[2].to_dict()
    assert da["count"] == db["count"] == 5
    for key in ("mu", "nu"):
        for x, y in zip(tt.tree_leaves(da[key]), tt.tree_leaves(db[key])):
            assert torch.equal(x, y)
    shapes = tt.param_shapes(tcfg)
    p_shard = tt.param_shardings(tcfg, mesh)
    for path in paths(shapes):
        shape = get(shapes, path)
        spec = get(b[2].layout.moment_specs, path)
        stacked = get(b[2].mu, path)
        rank = stacked[(0,) * len(mesh.axes)].numel()
        plain = int(np.prod(mesh.shard_shape(shape, get(p_shard, path))))
        divisible = any(e is None and s % dp == 0 for s, e in zip(
            shape, padded(get(p_shard, path), len(shape))))
        assert rank * (dp if divisible else 1) == plain, (path, spec)
    sh1, _ = tt.opt_state_shardings(None, shapes, p_shard, mesh, True)
    held = sum(2 * 4 * get(b[2].mu, path)[(0,) * len(mesh.axes)].numel()
               for path in paths(shapes))
    assert tt.opt_state_bytes_per_rank(sh1, shapes, mesh) == held


def test_fit_zero1_matches_and_resumes(tmp_path):
    """The reference's ``test_fit_zero1_matches_and_resumes`` on the port
    (dp 2 x tp 2, batch 2): ZeRO-1's losses equal the replicated run's;
    a ZeRO-1 run saved at 3 and resumed for 3 gives the uninterrupted
    losses and step-6 parameters and moments bit for bit; and a
    replicated run resumes the ZeRO-1 step 3 exactly (checkpoints hold
    the global moments)."""
    from tpu_dra_torch.workloads.checkpointing import restore_train_state
    path = motif_corpus(tmp_path / "t.bin", n=4000)
    cfg = tt.ModelConfig(vocab=64, d_model=32, n_heads=2, n_layers=2,
                         d_ff=64, max_seq=16)
    mesh = Mesh({"dp": 2, "tp": 2}, device=CPU)
    kw = dict(batch=2, log_every=1, mesh=mesh, log_fn=lambda s: None)
    plain = tfit.fit(cfg, path, steps=6, **kw)
    ck_full = str(tmp_path / "full")
    z = tfit.fit(cfg, path, steps=6, zero1=True, checkpoint_dir=ck_full,
                 checkpoint_every=6, **kw)
    assert plain.losses == z.losses

    ck = str(tmp_path / "ck-z1")
    tfit.fit(cfg, path, steps=3, zero1=True, checkpoint_dir=ck,
             checkpoint_every=3, **kw)
    resumed = tfit.fit(cfg, path, steps=3, zero1=True, checkpoint_dir=ck,
                       checkpoint_every=3, resume=True, **kw)
    assert resumed.step == 6 and resumed.losses == z.losses[3:]
    want = restore_train_state(ck_full, device=CPU)
    got = restore_train_state(ck, device=CPU)
    for key in ("mu", "nu"):
        for a, b in zip(tt.tree_leaves(want["extra"]["opt_state"][key]),
                        tt.tree_leaves(got["extra"]["opt_state"][key])):
            assert a.shape == b.shape and torch.equal(a, b)
    for a, b in zip(tt.tree_leaves(want["params"]),
                    tt.tree_leaves(got["params"])):
        assert torch.equal(a, b)

    ck_r = str(tmp_path / "ck-cross")
    tfit.fit(cfg, path, steps=3, zero1=True, checkpoint_dir=ck_r,
             checkpoint_every=3, **kw)
    crossed = tfit.fit(cfg, path, steps=3, checkpoint_dir=ck_r, resume=True,
                       **kw)
    assert crossed.losses == z.losses[3:]
