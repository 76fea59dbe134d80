"""LoRA of the port (tpu_dra_torch/workloads/lora.py) against the JAX
reference (tpu_dra/workloads/lora.py) on the CPU: exact at init, the
merge, the one-device step's loss and adapter gradients against the
reference's, only the adapters moving, merge then quantize serving, and
training through an int8 base."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (cfg_pair, f32, jax_params, logit_tol,
                          to_numpy_tree, to_torch)

from tpu_dra.workloads import lora as jlora
from tpu_dra.workloads import train as jtrain
from tpu_dra_torch.convert import params_from_numpy
from tpu_dra_torch.workloads import lora as tlora
from tpu_dra_torch.workloads.quant import quantize_params_int8
from tpu_dra_torch.workloads.train import forward, tree_leaves

JCFG, TCFG = cfg_pair(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                      max_seq=32)
GQA = cfg_pair(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
               d_ff=64, max_seq=32, pos_emb="rope")
LOSS_ATOL = 5e-3
LEAF_REL = 3e-2
MERGE_REL = 1e-6


def tokens(seed, shape, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def jax_lora_with_b(jp, lcfg, seed):
    """A reference adapter tree whose B is non-zero, so the merge and the
    gradient of A are not trivially zero."""
    lo = jlora.init_lora(jp, lcfg, jax.random.PRNGKey(seed))
    return jax.tree.map(lambda x: x + 0.01 * jax.random.normal(
        jax.random.PRNGKey(seed + 1), x.shape, x.dtype), lo)


def test_wrapped_equals_base_at_init():
    """B = 0 at init: the wrapped model is EXACTLY the base model."""
    params = to_torch(jax_params(JCFG))
    lcfg = tlora.LoRAConfig(rank=4)
    lora = tlora.init_lora(params, lcfg, gen(2))
    assert lora["blocks"]["wqkv"]["a"].shape == (2, 32, 4)
    assert float(lora["blocks"]["wqkv"]["a"].std()) == pytest.approx(
        4 ** -0.5, rel=0.2)
    t = torch.from_numpy(tokens(3, (2, 8)))
    assert torch.equal(forward(TCFG, params, t),
                       forward(TCFG, tlora.wrap_lora(params, lora, lcfg), t))


def test_merge_equals_the_reference_merge():
    jp = jax_params(JCFG)
    lcfg_j, lcfg_t = jlora.LoRAConfig(rank=4), tlora.LoRAConfig(rank=4)
    jl = jax_lora_with_b(jp, lcfg_j, 6)
    want = jlora.merge_lora(jp, jl, lcfg_j)
    got = tlora.merge_lora(to_torch(jp), params_from_numpy(
        to_numpy_tree(jl), "cpu"), lcfg_t)
    for name in lcfg_t.targets:
        w, g = np.asarray(want["blocks"][name]), f32(got["blocks"][name])
        assert got["blocks"][name].dtype == torch.float32
        assert np.linalg.norm(g - w) <= MERGE_REL * np.linalg.norm(w), name
    with pytest.raises(ValueError, match="plain base"):
        tlora.merge_lora(quantize_params_int8(to_torch(jp)),
                         params_from_numpy(to_numpy_tree(jl), "cpu"),
                         lcfg_t)


@pytest.mark.parametrize("pair", [(JCFG, TCFG), GQA], ids=["mha", "gqa"])
def test_step_loss_and_adapter_grads_match_the_reference(pair):
    """The port's loss and adapter gradients against ``jax.value_and_grad``
    of the reference's LoRA loss, and the first step of each side's
    ``make_lora_train_step`` (the reference's on a one-device mesh) from
    the same trees: the losses agree."""
    jcfg, tcfg = pair
    jp = jax_params(jcfg)
    lcfg_j, lcfg_t = jlora.LoRAConfig(), tlora.LoRAConfig()
    jl = jax_lora_with_b(jp, lcfg_j, 4)
    tok = tokens(5, (2, 17))
    jloss, jg = jax.value_and_grad(lambda lo: jtrain.loss_fn(
        jcfg, jlora.wrap_lora(jp, lo, lcfg_j), jnp.asarray(tok)))(jl)
    tp, tl = to_torch(jp), params_from_numpy(to_numpy_tree(jl), "cpu")
    loss, g = tlora.lora_value_and_grad(tcfg, tp, tl, lcfg_t,
                                        torch.from_numpy(tok))
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    for name in lcfg_t.targets:
        for ab in ("a", "b"):
            want = np.asarray(jg["blocks"][name][ab])
            got = f32(g["blocks"][name][ab])
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= LEAF_REL, (name, ab, rel)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("dp", "tp"))
    jstep, jinit, _, _ = jlora.make_lora_train_step(jcfg, mesh)
    _, _, jl0 = jstep(jp, jl, jinit(jl), jnp.asarray(tok))
    step, init_opt, _ = tlora.make_lora_train_step(tcfg)
    _, _, l0 = step(tp, tl, init_opt(tl), torch.from_numpy(tok))
    assert abs(float(l0) - float(jl0)) <= LOSS_ATOL


def test_default_optimizer_decays_as_optax_adamw():
    """The step's default optimizer is ``optax.adamw(1e-3)`` after
    clipping, whose decay is optax's own default, 1e-4 (fit's is 0.01):
    one update of a zero gradient is the decay alone."""
    import optax
    p = {"w": torch.full((3,), 2.0)}
    opt = tlora.AdamW(1e-3, weight_decay=tlora.LORA_WEIGHT_DECAY)
    opt.update(p, {"w": torch.zeros(3)}, opt.init(p))
    jp = {"w": jnp.full((3,), 2.0)}
    ox = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3))
    upd, _ = ox.update({"w": jnp.zeros(3)}, ox.init(jp), jp)
    want = np.asarray(optax.apply_updates(jp, upd)["w"])
    np.testing.assert_array_equal(p["w"].numpy(), want)
    assert want[0] == np.float32(2.0 - 1e-3 * 1e-4 * 2.0)


def test_lora_train_step_updates_only_adapters():
    params = to_torch(jax_params(JCFG))
    step, init_opt, lcfg = tlora.make_lora_train_step(TCFG)
    lora = tlora.init_lora(params, lcfg, gen(4))
    opt = init_opt(lora)
    t = torch.from_numpy(tokens(5, (2, 16)))
    before = [p.clone() for p in tree_leaves(params)]
    losses = []
    for _ in range(8):
        lora, opt, loss = step(params, lora, opt, t)
        losses.append(float(loss))
    assert float(lora["blocks"]["wqkv"]["b"].abs().max()) > 0
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 tree_leaves(params)))
    assert all(not p.requires_grad for p in tree_leaves(params))
    assert losses[-1] < losses[0], losses
    assert opt.count == 8 and set(opt.mu) == {"blocks"}
    with pytest.raises(NotImplementedError, match="9.5"):
        tlora.make_lora_train_step(TCFG, mesh=object())


def test_merge_then_quantize_serves():
    """adapt → merge → int8 → decode: the greedy tokens equal the
    reference's over the same merged, quantized tree."""
    from tpu_dra.workloads import decode as jdecode
    from tpu_dra.workloads.quant import quantize_params_int8 as jq8
    from tpu_dra_torch.workloads import decode as tdecode
    lcfg_j, lcfg_t = jlora.LoRAConfig(rank=4), tlora.LoRAConfig(rank=4)
    jp = jax_params(JCFG)
    jl = jax_lora_with_b(jp, lcfg_j, 9)
    served = quantize_params_int8(tlora.merge_lora(
        to_torch(jp), params_from_numpy(to_numpy_tree(jl), "cpu"), lcfg_t))
    prompt = tokens(10, (2, 6))
    got = tdecode.greedy_decode(TCFG, served, torch.from_numpy(prompt),
                                steps=4, cache_dtype="int8")
    want = jdecode.greedy_decode(JCFG, jq8(jlora.merge_lora(jp, jl, lcfg_j)),
                                 jnp.asarray(prompt), steps=4,
                                 cache_dtype="int8")
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_qlora_int8_base_training_gets_gradients():
    """Training THROUGH an int8 base: the straight-through backward gives
    the adapters gradients and the loss falls; B = 0 adapters over the
    int8 base equal the int8 base alone."""
    params = to_torch(jax_params(JCFG))
    step, init_opt, lcfg = tlora.make_lora_train_step(TCFG)
    qbase = quantize_params_int8(params)
    lora = tlora.init_lora(params, lcfg, gen(15))
    t = torch.from_numpy(tokens(16, (2, 16)))
    assert torch.equal(forward(TCFG, tlora.wrap_lora(qbase, lora, lcfg), t),
                       forward(TCFG, qbase, t))
    opt = init_opt(lora)
    losses = []
    for _ in range(8):
        lora, opt, loss = step(qbase, lora, opt, t)
        losses.append(float(loss))
    assert float(lora["blocks"]["wqkv"]["b"].abs().max()) > 0
    assert losses[-1] < losses[0], losses


def test_lora_trees_cross_through_convert(tmp_path):
    """A reference adapter tree, and a wrapped tree over an int8 base,
    cross from numpy and through an npz bit for bit; the wrapped tree's
    forward equals the reference's."""
    from tpu_dra.workloads.quant import quantize_params_int8 as jq8
    from tpu_dra_torch.convert import load_npz, save_npz
    jp = jax_params(JCFG)
    lcfg = jlora.LoRAConfig(rank=4)
    jl = jax_lora_with_b(jp, lcfg, 12)
    tl = params_from_numpy(to_numpy_tree(jl), "cpu")
    for name in lcfg.targets:
        for ab in ("a", "b"):
            np.testing.assert_array_equal(
                tl["blocks"][name][ab].numpy(),
                np.asarray(jl["blocks"][name][ab]))
    wrapped = to_numpy_tree(jlora.wrap_lora(jq8(jp), jl, lcfg))
    save_npz(tmp_path / "w.npz", wrapped)
    back = load_npz(tmp_path / "w.npz", "cpu")
    leaf = back["blocks"]["wqkv"]
    assert sorted(leaf) == ["a", "b", "base", "scale"]
    assert leaf["base"]["q8"].transpose(-1, -2).is_contiguous()
    assert tuple(leaf["scale"].shape) == (2, 1, 1)
    tok = tokens(13, (2, 8))
    want = jtrain.forward(JCFG, jlora.wrap_lora(jq8(jp), jl, lcfg),
                          jnp.asarray(tok))
    got = f32(forward(TCFG, back, torch.from_numpy(tok)))
    want = np.asarray(want)
    assert np.all(np.abs(got - want) <= logit_tol(want))
