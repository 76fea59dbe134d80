"""The port's DP×TP train step (``train.make_sharded_train_step`` on a
virtual ``mesh.Mesh``) against the reference's on a dp × tp = 2 × 2 mesh
of host devices: ``matmul_impl="fused_collective"`` (the ring kernels'
plain versions here, the interpreted XLA-emulated ring there) and
``"dense"``, with flash and dense attention, at windows of 32 tokens (the
trunk sees 31, which the fused path pads to 32) and 33.

Tolerances, as in test_torch_train_step.py: the loss within 5e-3 and each
gradient leaf within 3% relative L2; the gradients are read off one SGD
step at lr 1 as ``p − p'``.  Seen on the CPU: loss gaps up to 1.1e-3 and
leaves up to 1.6% (the reference's own sharded steps sit 1.3-1.7% from
its one-device step at these configs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from torch_parity import CPU, cfg_pair, f32, jax_params, to_torch

from tpu_dra.workloads import train as jt
from tpu_dra_torch.workloads import collective_matmul as cm
from tpu_dra_torch.workloads import train as tt
from tpu_dra_torch.workloads.mesh import Mesh

LOSS_ATOL = 5e-3
LEAF_REL = 3e-2


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = f32(v)
    return out


def spy(monkeypatch):
    """Count the ring wrappers' calls (the plain versions run here)."""
    calls = {"ag": 0, "rs": 0}

    def wrap(name, key):
        real = getattr(cm, name)

        def counted(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        monkeypatch.setattr(cm, name, counted)
    wrap("all_gather_matmul", "ag")
    wrap("matmul_reduce_scatter", "rs")
    return calls


@pytest.mark.parametrize("attn", ["dense", "flash"])
@pytest.mark.parametrize("impl", ["fused_collective", "dense"])
@pytest.mark.parametrize("seq", [32, 33])
def test_sharded_step_matches_the_reference(seq, impl, attn, monkeypatch):
    jcfg, tcfg = cfg_pair(vocab=64, d_model=32, n_heads=4, n_layers=2,
                          d_ff=64, max_seq=seq)
    params = jax_params(jcfg)
    toks = np.random.default_rng(1).integers(0, 64, (4, seq)) \
        .astype(np.int32)
    jmesh = JMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    jstep, p_sh, b_sh = jt.make_sharded_train_step(
        jcfg, jmesh, lr=1.0, attn_impl=attn, matmul_impl=impl)
    want, want_loss = jstep(jax.device_put(params, p_sh),
                            jax.device_put(jnp.asarray(toks), b_sh))

    mesh = Mesh({"dp": 2, "tp": 2}, device=CPU)
    step, p_shard, b_shard = tt.make_sharded_train_step(
        tcfg, mesh, lr=1.0, attn_impl=attn, matmul_impl=impl)
    assert b_shard == ("dp", None)
    assert p_shard["blocks"]["wqkv"] == (None, None, "tp")
    calls = spy(monkeypatch)
    tp0 = to_torch(params)
    got, got_loss = step(tp0, torch.from_numpy(toks))
    L = tcfg.n_layers
    # forward: wqkv, w1 through the gather, wo, w2 through the scatter;
    # each one's backward through the other
    assert calls == ({"ag": 4 * L, "rs": 4 * L} if impl != "dense"
                     else {"ag": 0, "rs": 0})
    assert abs(float(got_loss) - float(want_loss)) < LOSS_ATOL
    p0, want, got = flat(params), flat(want), flat(got)
    assert sorted(got) == sorted(want)
    for leaf in want:
        gw, gg = p0[leaf] - want[leaf], p0[leaf] - got[leaf]
        rel = np.linalg.norm(gg - gw) / np.linalg.norm(gw)
        assert rel < LEAF_REL, (leaf, rel)


def test_fused_step_falls_back_where_padding_would_pass_the_table(
        monkeypatch):
    """Windows of 32 with max_seq 31: the trunk's 31 rows would pad to 32,
    past the learned-position table, so every matmul keeps the plain path
    and the step is the dense one's."""
    _, tcfg = cfg_pair(vocab=64, d_model=32, n_heads=4, n_layers=1,
                       d_ff=64, max_seq=31)
    mesh = Mesh({"dp": 1, "tp": 2}, device=CPU)
    params = to_torch(jax_params(jt.ModelConfig(
        vocab=64, d_model=32, n_heads=4, n_layers=1, d_ff=64, max_seq=31)))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 64, (2, 32)))
    calls = spy(monkeypatch)
    fc, _, _ = tt.make_sharded_train_step(tcfg, mesh,
                                          matmul_impl="fused_collective")
    dense, _, _ = tt.make_sharded_train_step(tcfg, mesh)
    pf, lf = fc(params, toks)
    pd, ld = dense(params, toks)
    assert calls == {"ag": 0, "rs": 0}
    assert float(lf) == float(ld)
    for a, b in zip(tt.tree_leaves(pf), tt.tree_leaves(pd)):
        assert torch.equal(a, b)


def test_sharded_step_refuses_inputs_off_the_mesh_device():
    """The step runs on the mesh's device: CPU parameters and tokens given
    to a step on a mesh elsewhere raise rather than train on the CPU."""
    cfg = jt.ModelConfig(vocab=64, d_model=32, n_heads=4, n_layers=1,
                         d_ff=64, max_seq=16)
    _, tcfg = cfg_pair(vocab=64, d_model=32, n_heads=4, n_layers=1, d_ff=64,
                       max_seq=16)
    params = to_torch(jax_params(cfg))
    toks = torch.zeros((2, 17), dtype=torch.long)
    for impl in ("dense", "fused_collective"):
        step, _, _ = tt.make_sharded_train_step(
            tcfg, Mesh({"dp": 1, "tp": 2}, device="meta"), matmul_impl=impl)
        with pytest.raises(ValueError, match="runs on meta"):
            step(params, toks)


def test_make_sharded_train_step_rejects_unknown_matmul_impl():
    mesh = Mesh({"dp": 1, "tp": 2}, device=CPU)
    with pytest.raises(ValueError, match="matmul_impl"):
        tt.make_sharded_train_step(tt.ModelConfig(), mesh,
                                   matmul_impl="bogus")
