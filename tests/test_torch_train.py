"""Model core of the PyTorch port (tpu_dra_torch/workloads/train.py)
against the JAX reference (tpu_dra/workloads/train.py) on the same
weights and inputs.

Where the point is the algorithm the comparison runs in fp32 and the
tolerance only absorbs summation order; where the reference path is bf16
both sides round at the same points and the tolerance is a few bf16 ulps
(bf16 keeps 8 significant bits: one ulp is 2^-8 relative).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import CPU, cfg_pair, f32, jax_params, to_torch

from tpu_dra.workloads import train as jtrain
from tpu_dra_torch.workloads import train as ttrain
from tpu_dra_torch.workloads.train import layer_params

# fp32 matmuls / reductions in another order: relative error ~1e-6 of
# the magnitudes summed
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
# one bf16 rounding of the result, taken after differently ordered fp32
# sums: the two sides may land one ulp (2^-8 relative) apart
BF16_ULP_TOL = dict(rtol=2 ** -7, atol=2 ** -7)

RNG_SEED = 1234


def rng():
    return np.random.default_rng(RNG_SEED)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    r = rng()
    x = r.standard_normal((2, 5, 64)).astype(np.float32) * 3.0
    g = (1.0 + 0.1 * r.standard_normal(64)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    want = jtrain._rmsnorm(jx, jnp.asarray(g))
    got = ttrain._rmsnorm(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(g))
    assert str(got.dtype).endswith(dtype)
    tol = FP32_TOL if dtype == "float32" else BF16_ULP_TOL
    np.testing.assert_allclose(f32(got), f32(want), **tol)


@pytest.mark.parametrize("per_sequence", [False, True],
                         ids=["positions[S]", "positions[B,S]"])
def test_apply_rope_matches_reference(per_sequence):
    r = rng()
    B, H, S, D = 2, 3, 7, 16
    x = r.standard_normal((B, H, S, D)).astype(np.float32)
    if per_sequence:
        pos = r.integers(0, 500, (B, S)).astype(np.int32)
    else:
        pos = np.arange(S, dtype=np.int32) + 40
    want = jtrain.apply_rope(jnp.asarray(x), jnp.asarray(pos))
    got = ttrain.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    # fp32 sin/cos of angles up to ~500 rad: the two libraries' argument
    # reductions differ by a few fp32 ulps of the angle
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hkv", [4, 2, 1], ids=["mha", "gqa", "mqa"])
def test_causal_dense_attention_matches_reference(hkv):
    r = rng()
    B, H, S, D = 2, 4, 9, 16
    q = r.standard_normal((B, H, S, D)).astype(np.float32)
    k = r.standard_normal((B, hkv, S, D)).astype(np.float32)
    v = r.standard_normal((B, hkv, S, D)).astype(np.float32)
    want = jtrain._causal_dense_attention(*map(jnp.asarray, (q, k, v)))
    got = ttrain._causal_dense_attention(
        *map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(f32(got), f32(want), **FP32_TOL)


BLOCK_CFGS = {
    "learned-mha": dict(vocab=64, d_model=64, n_heads=4, n_layers=2,
                        d_ff=128, max_seq=32),
    "rope-gqa": dict(vocab=64, d_model=64, n_heads=4, n_kv_heads=2,
                     n_layers=2, d_ff=128, max_seq=32, pos_emb="rope"),
}


@pytest.mark.parametrize("name", sorted(BLOCK_CFGS))
def test_block_matches_reference_fp32(name):
    jcfg, tcfg = cfg_pair(**BLOCK_CFGS[name])
    params = jax_params(jcfg)
    x = rng().standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    layer_j = {k: v[1] for k, v in params["blocks"].items()}
    want = jtrain._block(jcfg, jnp.asarray(x), layer_j)
    got = ttrain._block(tcfg, torch.from_numpy(x),
                        layer_params(to_torch(params["blocks"]), 1))
    # fp32 through two sublayers of matmuls: ~1e-6 relative per sum
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_head_logits_matches_reference(tied):
    jcfg, _ = cfg_pair(vocab=96, d_model=64, n_heads=4, n_layers=1,
                       d_ff=128, max_seq=16, tied_embeddings=tied)
    params = jax_params(jcfg)
    assert ("unembed" in params) != tied
    x = rng().standard_normal((2, 5, 64)).astype(np.float32)
    want = jtrain.head_logits(params, jnp.asarray(x, jnp.bfloat16))
    got = ttrain.head_logits(to_torch(params),
                             torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32 and got.shape == (2, 5, 96)
    np.testing.assert_allclose(f32(got), f32(want), **BF16_ULP_TOL)


FORWARD_CFGS = {
    # __graft_entry__.entry's model
    "entry": dict(vocab=256, d_model=128, n_heads=4, n_layers=2,
                  d_ff=512, max_seq=64),
    "rope-gqa-tied": dict(vocab=256, d_model=64, n_heads=4, n_kv_heads=2,
                          n_layers=2, d_ff=128, max_seq=64,
                          pos_emb="rope", tied_embeddings=True),
}


@pytest.mark.parametrize("name", sorted(FORWARD_CFGS))
def test_forward_logits_match_reference(name):
    jcfg, tcfg = cfg_pair(**FORWARD_CFGS[name])
    params = jax_params(jcfg)
    tokens = rng().integers(0, jcfg.vocab, (2, 64)).astype(np.int32)
    want = jtrain.forward(jcfg, params, jnp.asarray(tokens))
    got = ttrain.forward(tcfg, to_torch(params),
                         torch.from_numpy(tokens).long())
    assert got.shape == (2, 64, jcfg.vocab)
    # the trunk is bf16 (embeddings cast on use): every matmul output and
    # residual add rounds to 8 bits, and a one-ulp flip in one layer
    # propagates; over two layers that stays within a few ulps of the
    # logits' O(1) scale
    np.testing.assert_allclose(f32(got), f32(want), rtol=0.02, atol=0.05)


def test_init_params_shapes_match_reference():
    jcfg, tcfg = cfg_pair(**FORWARD_CFGS["rope-gqa-tied"])
    want = to_torch(jax_params(jcfg))
    gen = torch.Generator(device=CPU)
    gen.manual_seed(0)
    got = ttrain.init_params(tcfg, gen)

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else
                (tuple(v.shape), v.dtype) for k, v in t.items()}
    assert shapes(got) == shapes(want)
    # normal · d_model^-0.5: the sample std of 64·128 draws is within 5%
    std = float(got["blocks"]["wqkv"].std())
    assert abs(std - 64 ** -0.5) < 0.05 * 64 ** -0.5
