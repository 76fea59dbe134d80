"""The port's MoE model (tpu_dra_torch/workloads/moe.py) against the JAX
reference (tpu_dra/workloads/moe.py) on the CPU, on inputs drawn with
numpy from a seed: ``moe_ffn``'s routing masks equal, its output within
bf16 rounding and its aux loss within fp32 rounding, for top-1 and
top-2; the capacity drops and the choice-major priority; ``moe_loss_fn``
and its gradients against ``jax.grad``; flash against dense; the
remat's second forward; the refusals; and the optimizer step."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import f32, to_numpy_tree

from tpu_dra.workloads import moe as jmoe
from tpu_dra_torch.convert import params_from_numpy
from tpu_dra_torch.workloads import flash as tflash
from tpu_dra_torch.workloads import moe as tmoe
from tpu_dra_torch.workloads.mesh import Mesh
from tpu_dra_torch.workloads.train import tree_leaves

SMALL = dict(vocab=32, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_seq=16, n_experts=4)
# one bf16 rounding of a row's output, relative L2 (the expert matmuls
# return bf16, and the two frameworks may round a sum one ulp apart)
ROW_REL = 1e-2
AUX_REL = 1e-6
LOSS_ATOL = 5e-3
LEAF_REL = 3e-2


def cfg_pair(**kw):
    jcfg = jmoe.MoEConfig(**kw)
    return jcfg, tmoe.MoEConfig(**dataclasses.asdict(jcfg))


def ffn_inputs(seed, B, S, D, F, E, gate_scale=0.5):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, S, D)).astype(np.float32),
            (r.standard_normal((D, E)) * gate_scale).astype(np.float32),
            (r.standard_normal((E, D, F)) * 0.25).astype(np.float32),
            (r.standard_normal((E, F, D)) * 0.25).astype(np.float32))


def jax_route(cfg, flat, wg, capacity):
    """The reference's routing, ``moe_ffn`` lines 116-131 (its function
    returns only the output and the aux loss): ``(keep [KN, E], disp_k
    [K, N, E, C])``."""
    N, E, K = flat.shape[0], wg.shape[-1], cfg.router_top_k
    probs = jax.nn.softmax(jnp.asarray(flat) @ jnp.asarray(wg), axis=-1)
    _, topk_idx = jax.lax.top_k(probs, K)
    onehot_k = jax.nn.one_hot(topk_idx, E, dtype=jnp.float32)
    flat_oh = onehot_k.transpose(1, 0, 2).reshape(K * N, E)
    pos = (jnp.cumsum(flat_oh, axis=0) - 1.0) * flat_oh
    keep = flat_oh * (pos < capacity)
    slot = jax.nn.one_hot(pos.sum(-1).astype(jnp.int32), capacity,
                          dtype=jnp.float32)
    disp_k = (keep[:, :, None] * slot[:, None, :]).reshape(K, N, E,
                                                           capacity)
    return np.asarray(keep), np.asarray(disp_k)


def row_rel(got, want):
    g, w = f32(got).reshape(-1, got.shape[-1]), f32(want).reshape(
        -1, want.shape[-1])
    return np.linalg.norm(g - w, axis=-1) / np.maximum(
        np.linalg.norm(w, axis=-1), 1e-6)


@pytest.mark.parametrize("top_k,capacity", [(1, 16), (1, 3), (2, 32),
                                            (2, 5)])
def test_moe_ffn_matches_the_reference(top_k, capacity):
    """Masks equal exactly, output rows within one bf16 rounding, aux
    within fp32 rounding; ample and tight capacities."""
    jcfg, tcfg = cfg_pair(d_model=16, d_ff=32, n_experts=4,
                          router_top_k=top_k)
    x, wg, w1, w2 = ffn_inputs(top_k, 2, 8, 16, 32, 4)
    jout, jaux = jmoe.moe_ffn(jcfg, jnp.asarray(x), jnp.asarray(wg),
                              jnp.asarray(w1), jnp.asarray(w2),
                              capacity=capacity)
    t = [torch.from_numpy(a) for a in (x, wg, w1, w2)]
    out, aux = tmoe.moe_ffn(tcfg, *t, capacity=capacity)
    want_keep, want_disp = jax_route(jcfg, x.reshape(-1, 16), wg, capacity)
    _, _, _, disp_k = tmoe.route(tcfg, t[0].reshape(-1, 16), t[1],
                                 capacity)
    keep = disp_k.sum(-1).reshape(-1, 4)
    np.testing.assert_array_equal(disp_k.numpy(), want_disp)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert out.dtype == torch.float32 and out.shape == (2, 8, 16)
    assert row_rel(out, jout).max() <= ROW_REL
    assert abs(float(aux) - float(jaux)) <= AUX_REL * abs(float(jaux))
    assert float(aux) > 0


def test_moe_capacity_drops_overflow_tokens():
    """Capacity 1 per expert: most tokens overflow and contribute zero,
    rows the reference zeroes too."""
    jcfg, tcfg = cfg_pair(d_model=16, d_ff=32, n_experts=2)
    x, wg, w1, w2 = ffn_inputs(2, 1, 8, 16, 32, 2, gate_scale=1.0)
    out, _ = tmoe.moe_ffn(tcfg, *map(torch.from_numpy, (x, wg, w1, w2)),
                          capacity=1)
    jout, _ = jmoe.moe_ffn(jcfg, *map(jnp.asarray, (x, wg, w1, w2)),
                           capacity=1)
    zero = (out.reshape(-1, 16).abs() < 1e-6).all(-1).numpy()
    assert zero.sum() >= 6          # 8 tokens, at most 2 kept
    np.testing.assert_array_equal(
        zero, np.all(np.abs(np.asarray(jout).reshape(-1, 16)) < 1e-6, -1))
    assert torch.isfinite(out).all()


def test_moe_top2_capacity_prioritizes_first_choices():
    """Choice-major slots: with capacity equal to the largest first-choice
    load, every token's first choice is admitted, so no row is zero; a
    tighter capacity drops copies and changes the output."""
    _, tcfg = cfg_pair(d_model=16, d_ff=32, n_experts=2, router_top_k=2)
    x, wg, w1, w2 = map(torch.from_numpy,
                        ffn_inputs(6, 1, 8, 16, 32, 2, gate_scale=1.0))
    tight, _ = tmoe.moe_ffn(tcfg, x, wg, w1, w2, capacity=4)
    ample, _ = tmoe.moe_ffn(tcfg, x, wg, w1, w2, capacity=8)
    assert (tight - ample).abs().max() > 1e-6 and torch.isfinite(tight).all()
    first = torch.argmax(torch.softmax(x.reshape(-1, 16) @ wg, -1), -1)
    cap = int(torch.bincount(first, minlength=2).max())
    out, _ = tmoe.moe_ffn(tcfg, x, wg, w1, w2, capacity=cap)
    assert int((out.reshape(-1, 16).abs() < 1e-7).all(-1).sum()) == 0


def moe_trees(top_k, seed=0, **kw):
    jcfg, tcfg = cfg_pair(**dict(SMALL, router_top_k=top_k, **kw))
    jp = jmoe.init_moe_params(jcfg, jax.random.PRNGKey(seed))
    tokens = np.random.default_rng(seed + 1).integers(
        0, jcfg.vocab, (4, jcfg.max_seq + 1), dtype=np.int32)
    return jcfg, tcfg, jp, params_from_numpy(to_numpy_tree(jp), "cpu"), \
        tokens


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_loss_and_grads_match_jax_grad(top_k):
    jcfg, tcfg, jp, tp, tokens = moe_trees(top_k)
    jloss, jg = jax.value_and_grad(
        lambda p: jmoe.moe_loss_fn(jcfg, p, jnp.asarray(tokens)))(jp)
    from tpu_dra_torch.workloads.train import value_and_grad
    loss, g = value_and_grad(
        lambda p, t: tmoe.moe_loss_fn(tcfg, p, t), tp,
        torch.from_numpy(tokens))
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    jleaves = jax.tree.leaves(to_numpy_tree(jg))
    # jax.tree orders dict keys sorted; walk the port's tree the same way
    names = sorted(_paths(g))
    assert len(names) == len(jleaves)
    for name, want in zip(names, jleaves):
        got = f32(_get(g, name))
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= LEAF_REL, (name, rel)


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_moe_flash_and_chunked_match_dense():
    """``attn_impl="flash"`` (the plain versions here) with the chunked
    head: each engine within LOSS_ATOL of the reference's same engine,
    and flash within the reference test's 5e-2 of dense (the dense
    scores round to bf16, so a router choice may flip between the two,
    in the reference as in the port: 0.014 there, 0.016 here)."""
    jcfg, tcfg, jp, tp, tokens = moe_trees(1, pos_emb="rope")
    t, jt = torch.from_numpy(tokens), jnp.asarray(tokens)
    dense = float(tmoe.moe_loss_fn(tcfg, tp, t))
    fancy = float(tmoe.moe_loss_fn(tcfg, tp, t, attn_impl="flash",
                                   head_impl="chunked"))
    assert abs(dense - float(jmoe.moe_loss_fn(jcfg, jp, jt))) <= LOSS_ATOL
    assert abs(fancy - float(jmoe.moe_loss_fn(
        jcfg, jp, jt, attn_impl="flash", head_impl="chunked"))) <= LOSS_ATOL
    assert abs(dense - fancy) < 5e-2
    nll = float(tmoe.moe_eval_nll(tcfg, tp, t))
    assert abs(nll - float(jmoe.moe_eval_nll(jcfg, jp, jt))) <= LOSS_ATOL
    assert nll < dense


def test_each_block_runs_its_forward_again_in_the_backward(monkeypatch):
    """The block's remat: a training step calls the flash forward twice a
    layer and each backward once, the counts phase 19 of chip_smoke.py
    expects of the kernels."""
    _, tcfg, _, tp, tokens = moe_trees(2)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tflash.flash_attn_fwd, tflash.flash_attn_bwd

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(tflash, "flash_attn_fwd", count("fwd", fwd))
    monkeypatch.setattr(tflash, "flash_attn_bwd", count("bwd", bwd))
    step, init_opt, _, _ = tmoe.make_moe_optax_step(tcfg,
                                                    attn_impl="flash")
    step(tp, init_opt(tp), torch.from_numpy(tokens))
    assert calls == {"fwd": 2 * tcfg.n_layers, "bwd": tcfg.n_layers}


def test_moe_refusals():
    with pytest.raises(ValueError, match="router_top_k"):
        tmoe.MoEConfig(d_model=16, d_ff=32, n_experts=2, router_top_k=3)
    with pytest.raises(ValueError, match="router_top_k"):
        tmoe.MoEConfig(d_model=16, d_ff=32, n_experts=2, router_top_k=0)
    with pytest.raises(NotImplementedError, match="tied_embeddings"):
        tmoe.MoEConfig(**dict(SMALL, tied_embeddings=True))
    # the expert axis must split the experts, in both mesh steps
    cfg = tmoe.MoEConfig(**dict(SMALL, n_experts=3))
    for make in (tmoe.make_moe_train_step, tmoe.make_moe_optax_step):
        with pytest.raises(ValueError, match="not divisible by ep=2"):
            make(cfg, Mesh({"dp": 2, "ep": 2}, device="cpu"))
    # ZeRO-1, once refused here, runs on a dp x ep mesh
    _, tcfg, _, tp, tokens = moe_trees(1)
    step, init_opt, _, _ = tmoe.make_moe_optax_step(
        tcfg, Mesh({"dp": 2, "ep": 2}, device="cpu"), zero1=True)
    _, opt, loss = step(tp, init_opt(tp), torch.from_numpy(tokens))
    assert torch.isfinite(loss) and opt.layout is not None


def test_moe_init_shapes_match_the_reference():
    jcfg, tcfg = cfg_pair(**dict(SMALL, pos_emb="learned"))
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = tmoe.init_moe_params(tcfg, gen)
    jp = jmoe.init_moe_params(jcfg, jax.random.PRNGKey(0))
    assert sorted(_paths(tp)) == sorted(_paths(to_numpy_tree(jp)))
    for path in _paths(tp):
        assert tuple(_get(tp, path).shape) == _get(jp, path).shape, path
        assert _get(tp, path).dtype == torch.float32


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_optax_step_trains(top_k):
    """AdamW after clipping on one device: the loss descends on a fixed
    batch, as the reference's ep-mesh step does."""
    _, tcfg, _, tp, tokens = moe_trees(top_k, vocab=64)
    step, init_opt, _, _ = tmoe.make_moe_optax_step(tcfg)
    opt = init_opt(tp)
    t = torch.from_numpy(tokens)
    tp, opt, loss0 = step(tp, opt, t)
    for _ in range(8):
        tp, opt, loss = step(tp, opt, t)
    assert torch.isfinite(loss0) and float(loss) < float(loss0)
    assert opt.count == 9 and all(torch.isfinite(p).all()
                                  for p in tree_leaves(tp))


def test_moe_trees_cross_through_convert(tmp_path):
    """A reference ``init_moe_params`` tree (``[L, E, D, F]`` expert
    banks) crosses from numpy and through an npz bit for bit."""
    from tpu_dra_torch.convert import load_npz, save_npz
    jcfg, _ = cfg_pair(**dict(SMALL, pos_emb="learned"))
    jp = to_numpy_tree(jmoe.init_moe_params(jcfg, jax.random.PRNGKey(3)))
    tp = params_from_numpy(jp, "cpu")
    save_npz(tmp_path / "moe.npz", jp)
    back = load_npz(tmp_path / "moe.npz", "cpu")
    assert tp["blocks"]["w1"].shape == (2, 4, 32, 64)
    for path in _paths(tp):
        want = _get(jp, path)
        np.testing.assert_array_equal(_get(tp, path).numpy(), want)
        assert torch.equal(_get(back, path), _get(tp, path))


def test_pinned_choices_make_flash_and_dense_steps_comparable():
    """Unpinned, the flash and the dense step route some near-tie tokens
    to other experts (the reference does too), and the gradients part by
    more than a rounding; with the flash pass's choices replayed in the
    dense pass, every leaf is within LEAF_REL and the loss within
    LOSS_ATOL, and the router was called as often in both passes."""
    from tpu_dra_torch.workloads.train import value_and_grad
    _, tcfg, _, tp, tokens = moe_trees(2, vocab=64)
    t = torch.from_numpy(tokens)

    def grads(attn):
        return value_and_grad(
            lambda p, x: tmoe.moe_loss_fn(tcfg, p, x, attn), tp, t)
    with tmoe.PinnedChoices() as pin:
        lf, gf = grads("flash")
        pin.replay()
        ld, gd = grads("dense")
    assert len(pin.recorded) == pin.replayed == 2 * tcfg.n_layers
    assert abs(float(lf) - float(ld)) <= LOSS_ATOL
    for a, b in zip(tree_leaves(gf), tree_leaves(gd)):
        assert float((a - b).norm() / b.norm()) <= LEAF_REL
    assert tmoe._top_k.__name__ == "_top_k"        # restored on exit


def jmesh(axes: dict):
    from jax.sharding import Mesh as JMesh
    devs = np.array(jax.devices()[:int(np.prod(list(axes.values())))])
    return JMesh(devs.reshape(tuple(axes.values())), tuple(axes))


def _spec(entry) -> tuple:
    return tuple(entry)


def test_moe_param_shardings_equal_the_reference():
    """The banks over "ep" on the expert axis, the rest replicated: the
    reference's PartitionSpecs, entry for entry, for both position
    forms."""
    for pos in ("learned", "rope"):
        jcfg, tcfg = cfg_pair(**dict(SMALL, pos_emb=pos))
        want = jmoe.moe_param_shardings(jcfg, jmesh({"dp": 2, "ep": 2}))
        got = tmoe.moe_param_shardings(tcfg, Mesh({"dp": 2, "ep": 2},
                                                  device="cpu"))
        assert sorted(_paths(got)) == sorted(
            _paths(jax.tree.map(lambda s: 0, want,
                                is_leaf=lambda x: hasattr(x, "spec"))))
        for path in _paths(got):
            assert _get(got, path) == tuple(_get(want, path).spec), path


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("axes", [{"dp": 2, "ep": 2}, {"dp": 1, "ep": 4}],
                         ids=["dp2xep2", "ep4"])
def test_moe_ep_step_matches_the_reference(axes, top_k):
    """The SGD step on a dp x ep mesh at lr 1 (its update is the
    gradient) against the reference's ``make_moe_train_step`` on the same
    mesh shape: the loss within LOSS_ATOL, every leaf within LEAF_REL;
    and against the port's one-device gradients with the one-device
    pass's routing replayed (``PinnedChoices``), within LEAF_REL: the
    experts' partial outputs are summed over the ranks in another
    order."""
    from tpu_dra_torch.workloads.train import value_and_grad
    jcfg, tcfg, jp, tp, tokens = moe_trees(top_k)
    jstep, jps, jts = jmoe.make_moe_train_step(jcfg, jmesh(axes), lr=1.0)
    jnew, jloss = jstep(jax.device_put(jp, jps),
                        jax.device_put(jnp.asarray(tokens), jts))
    step, p_shard, t_shard = tmoe.make_moe_train_step(
        tcfg, Mesh(axes, device="cpu"), lr=1.0)
    t = torch.from_numpy(tokens)
    with tmoe.PinnedChoices() as pin:
        loss1, g1 = value_and_grad(
            lambda p, x: tmoe.moe_loss_fn(tcfg, p, x), tp, t)
        pin.replay()
        new, loss = step(tp, t)
    assert pin.replayed == len(pin.recorded)
    assert t_shard == ("dp", None)
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    assert abs(float(loss) - float(loss1)) <= LOSS_ATOL
    jold, jnew = to_numpy_tree(jp), to_numpy_tree(jnew)
    for path in _paths(tp):
        got = f32(_get(tp, path)) - f32(_get(new, path))
        want = np.asarray(_get(jold, path)) - np.asarray(_get(jnew, path))
        one = f32(_get(g1, path))
        for ref in (want, one):
            rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
            assert rel <= LEAF_REL, (path, rel)


def test_moe_zero1_is_bit_equal_to_replicated_moments():
    """AdamW on a dp x ep mesh, 3 steps: ZeRO-1's per-rank moment shards
    give the replicated run's losses, parameters and moments bit for
    bit; the expert banks' moments carry "ep", and ZeRO-1 adds "dp"."""
    _, tcfg, _, tp0, tokens = moe_trees(2, vocab=64)
    mesh = Mesh({"dp": 2, "ep": 2}, device="cpu")
    t = torch.from_numpy(tokens)

    def run(zero1):
        tp = {k: (v.clone() if torch.is_tensor(v) else
                  {kk: vv.clone() for kk, vv in v.items()})
              for k, v in tp0.items()}
        step, init_opt, _, _ = tmoe.make_moe_optax_step(tcfg, mesh,
                                                        zero1=zero1)
        opt = init_opt(tp)
        losses = []
        for _ in range(3):
            tp, opt, loss = step(tp, opt, t)
            losses.append(float(loss))
        return losses, tp, opt

    a, b = run(False), run(True)
    assert a[0] == b[0]
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a[1]),
                                                 tree_leaves(b[1])))
    da, db = a[2].to_dict(), b[2].to_dict()
    for key in ("mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(da[key]),
                                                     tree_leaves(db[key])))
    assert b[2].layout.moment_specs["blocks"]["w1"] == ("dp", "ep", None,
                                                        None)
