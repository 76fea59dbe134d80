"""The port's GPipe step (tpu_dra_torch/workloads/pipeline.py) against
the reference's ``make_pipeline_train_step`` on host-device meshes, with
the dense and the chunked head, and against the sequential loss; its two
``ValueError``s.

Tolerances, those of the sharded steps' parity tests
(tests/test_torch_sharded_train.py): the loss within 5e-3 and every
leaf's update within 3% relative L2.  Against the port's own one-device
step (the same arithmetic, microbatched) the loss within 1e-5 and every
leaf within 1e-2: a microbatch's bf16 weight gradients round before the
microbatches are summed (seen: 2.1e-3 at n_micro 2 and 4, 0 at 1)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from torch_parity import CPU, cfg_pair, f32, jax_params, to_torch

from tpu_dra.workloads import pipeline as jpipe
from tpu_dra_torch.workloads import pipeline as tpipe
from tpu_dra_torch.workloads import train as tt
from tpu_dra_torch.workloads.mesh import Mesh

LOSS_ATOL = 5e-3
LEAF_REL = 3e-2
TINY = dict(vocab=32, d_model=32, n_heads=2, n_layers=4, d_ff=64,
            max_seq=16)


def jmesh(axes: dict):
    devs = np.array(jax.devices()[:int(np.prod(list(axes.values())))])
    return JMesh(devs.reshape(tuple(axes.values())), tuple(axes))


def tokens(seed=1, shape=(8, 16), vocab=32):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def rel(got, want) -> float:
    got, want = f32(got), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def updates(old, new) -> list:
    return [np.asarray(o, np.float32) - np.asarray(n, np.float32)
            for o, n in zip(jax.tree.leaves(old), jax.tree.leaves(new))]


@pytest.mark.parametrize("head", ["dense", "chunked"])
@pytest.mark.parametrize("axes", [{"dp": 2, "pp": 2}, {"dp": 1, "pp": 4}],
                         ids=["dp2xpp2", "pp4"])
def test_pipeline_step_matches_the_reference(axes, head):
    """One SGD step at lr 1 from the same weights and tokens: the loss and
    every leaf's update (its gradient), leaf by leaf."""
    jcfg, tcfg = cfg_pair(**TINY)
    jp = jax_params(jcfg)
    toks = tokens()
    jstep, jps, jts = jpipe.make_pipeline_train_step(
        jcfg, jmesh(axes), n_micro=2, lr=1.0, head_impl=head)
    jnew, jloss = jstep(jax.device_put(jp, jps),
                        jax.device_put(jnp.asarray(toks), jts))
    tp = to_torch(jp)
    step, p_shard, t_shard = tpipe.make_pipeline_train_step(
        tcfg, Mesh(axes, device=CPU), n_micro=2, lr=1.0, head_impl=head)
    new, loss = step(tp, torch.from_numpy(toks))
    assert abs(float(loss) - float(jloss)) < LOSS_ATOL
    want = updates(jp, jnew)
    got = [f32(o) - f32(n) for o, n in zip(tt.tree_leaves(tp),
                                           tt.tree_leaves(new))]
    for g, w in zip(got, want):
        assert rel(g, w) < LEAF_REL, rel(g, w)
    assert t_shard == ("dp", None)
    assert p_shard["blocks"]["wqkv"] == ("pp",) and p_shard["embed"] == ()


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_pipeline_equals_the_one_device_step(n_micro):
    """The bubble is inert: the pipelined loss and gradients equal the
    one-device loss_fn's on the same tree (the microbatches only split
    the rows)."""
    _, tcfg = cfg_pair(**TINY)
    tp = to_torch(jax_params(cfg_pair(**TINY)[0]))
    toks = torch.from_numpy(tokens(2))
    want_loss, want = tt.value_and_grad(
        lambda p, t: tt.loss_fn(tcfg, p, t), tp, toks)
    step, _, _ = tpipe.make_pipeline_train_step(
        tcfg, Mesh({"dp": 2, "pp": 2}, device=CPU), n_micro=n_micro,
        lr=1.0)
    new, loss = step(tp, toks)
    assert abs(float(loss) - float(want_loss)) < 1e-5
    for o, n, g in zip(tt.tree_leaves(tp), tt.tree_leaves(new),
                       tt.tree_leaves(want)):
        assert rel(o - n, g) < 1e-2


def test_pipeline_matches_the_reference_sequential_loss():
    """The port's pipelined loss against the reference's plain forward on
    the same weights (the reference's own test's bound, 5e-2; seen far
    inside LOSS_ATOL)."""
    from tpu_dra.workloads.train import loss_fn
    jcfg, tcfg = cfg_pair(**TINY)
    jp = jax_params(jcfg)
    toks = tokens(3)
    ref = float(loss_fn(jcfg, jp, jnp.asarray(toks)))
    step, _, _ = tpipe.make_pipeline_train_step(
        tcfg, Mesh({"dp": 2, "pp": 4}, device=CPU), n_micro=1, lr=0.0)
    _, loss = step(to_torch(jp), torch.from_numpy(toks))
    assert abs(float(loss) - ref) < LOSS_ATOL


def test_pipeline_training_decreases_loss():
    _, tcfg = cfg_pair(**TINY)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = tt.init_params(tcfg, gen)
    step, _, _ = tpipe.make_pipeline_train_step(
        tcfg, Mesh({"dp": 2, "pp": 2}, device=CPU), n_micro=2, lr=0.5)
    toks = torch.from_numpy(tokens(4))
    losses = []
    for _ in range(5):
        params, loss = step(params, toks)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    assert all(torch.isfinite(p).all() for p in tt.tree_leaves(params))


def test_pipeline_refusals():
    _, tcfg = cfg_pair(**dict(TINY, n_layers=3))
    with pytest.raises(ValueError, match="not divisible by pp"):
        tpipe.make_pipeline_train_step(tcfg, Mesh({"dp": 2, "pp": 4},
                                                  device=CPU))
    _, tcfg = cfg_pair(**TINY)
    step, _, _ = tpipe.make_pipeline_train_step(
        tcfg, Mesh({"dp": 2, "pp": 2}, device=CPU), n_micro=4)
    gen = torch.Generator()
    gen.manual_seed(0)
    with pytest.raises(ValueError, match="dp\\*n_micro=8"):
        step(tt.init_params(tcfg, gen), torch.from_numpy(tokens(5, (6, 16))))
