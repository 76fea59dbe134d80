"""The speculative-sampling commit of the PyTorch port
(tpu_dra_torch/workloads/spec_sample.py) against the JAX reference
(tpu_dra/workloads/spec_sample.py), and the reference's distribution
tests (tests/test_spec_sample.py) on the port.

The reference draws its randomness from per-slot PRNG keys inside the
commit; the port takes the same draws as tensors.  Fed the reference's
own draws — recreated here from the same keys with ``jax.random.split``,
``uniform`` and ``gumbel`` — the port must commit exactly what the
reference commits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dra.workloads.spec_sample import commit_sampled as jcommit
from tpu_dra_torch.workloads.spec_sample import commit_greedy, commit_sampled

V, K = 5, 3


def reference_draws(keys, k: int, V: int):
    """The draws the reference's commit makes from ``keys`` [slots]:
    (uniforms [slots, k-1], resample noise [slots, V], bonus noise
    [slots, V]) — ``categorical(key, logits)`` is ``argmax(gumbel(key,
    logits.shape) + logits)``."""
    ku, kr, kb = jax.vmap(lambda s: tuple(jax.random.split(s, 3)))(keys)
    u = jax.vmap(lambda s: jax.random.uniform(s, (k - 1,)))(ku)
    gr = jax.vmap(lambda s: jax.random.gumbel(s, (V,), jnp.float32))(kr)
    gb = jax.vmap(lambda s: jax.random.gumbel(s, (V,), jnp.float32))(kb)
    return [torch.from_numpy(np.array(a)) for a in (u, gr, gb)]


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", range(6))
def test_commit_equals_reference_under_its_draws(seed):
    """Many slots, sharp and flat logits, one draft equal to the target's
    distribution, frozen slots and eos ids: every output equal."""
    slots, k, v = 24, 5, 11
    kt, kq, kd, kk, ke = jax.random.split(jax.random.PRNGKey(seed), 5)
    scale = jnp.where(jnp.arange(slots) % 3 == 0, 4.0, 1.0)[:, None, None]
    t_logits = jax.random.normal(kt, (slots, k, v)) * scale
    q_logits = jax.random.normal(kq, (slots, k - 1, v)) * scale
    q_logits = q_logits.at[1].set(t_logits[1, :k - 1])      # p == q
    drafts = jax.random.randint(kd, (slots, k - 1), 0, v, jnp.int32)
    token = jnp.arange(slots, dtype=jnp.int32) % v
    pos = jnp.arange(slots, dtype=jnp.int32) * 3
    eos = jnp.where(jnp.arange(slots) % 4 == 1,
                    jax.random.randint(ke, (slots,), 0, v, jnp.int32), -1)
    done = jnp.arange(slots) % 5 == 2
    keys = jax.random.split(kk, slots)
    want = jcommit(token, pos, eos, done, drafts, t_logits, q_logits, keys)
    got = commit_sampled(t(token), t(pos), t(eos), t(done), t(drafts),
                         t(t_logits), t(q_logits),
                         *reference_draws(keys, k, v))
    names = ("token2", "pos2", "done2", "emit", "counts")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # the case has teeth: partial accepts, full accepts and frozen slots
    counts = np.asarray(want[4])
    assert {0, 1, k} <= set(counts.tolist())


def test_greedy_commit_is_the_longest_matching_prefix():
    preds = torch.tensor([[4, 2, 7, 1], [4, 2, 7, 1], [4, 2, 7, 1],
                          [4, 2, 7, 1]], dtype=torch.int32)
    drafts = torch.tensor([[4, 2, 7], [4, 9, 7], [0, 2, 7], [4, 2, 7]],
                          dtype=torch.int32)
    eos = torch.tensor([-1, -1, -1, 2], dtype=torch.int32)
    done = torch.tensor([False, False, False, False])
    token2, pos2, done2, emit, counts = commit_greedy(
        torch.zeros(4, dtype=torch.int32), torch.full((4,), 10,
                                                      dtype=torch.int32),
        eos, done, drafts, preds)
    assert counts.tolist() == [4, 2, 1, 4]
    assert emit.tolist() == [[4, 2, 7, 1], [4, 2, 0, 0], [4, 0, 0, 0],
                             [4, 2, 7, 1]]
    assert token2.tolist() == [1, 2, 4, 1] and pos2.tolist() == [14, 12,
                                                                  11, 14]
    assert done2.tolist() == [False, False, False, True]    # eos 2 emitted


# -------------------------------------------------------------------------
# The reference's distribution tests, on the port
# -------------------------------------------------------------------------


def gumbel(gen, shape):
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    tiny = torch.finfo(torch.float64).tiny
    return (-torch.log(-torch.log(u.clamp_min(tiny)))).float()


def run_passes(n, t_logits, q_logits, temp=1.0, eos=-1, done=False,
               seed=0):
    """``n`` single-slot commit passes batched as n slots, drafts honestly
    drawn from q (the property holds only for drafts from the claimed
    draft distribution); logits arrive final, pre-scaled by ``temp``."""
    gen = torch.Generator().manual_seed(seed)
    t_final = (t_logits / temp).expand(n, K, V)
    q_final = (q_logits / temp).expand(n, K - 1, V)
    drafts = torch.argmax(q_final + gumbel(gen, (n, K - 1, V)),
                          dim=-1).to(torch.int32)
    return commit_sampled(
        torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32),
        torch.full((n,), eos, dtype=torch.int32),
        torch.full((n,), done), drafts, t_final, q_final,
        torch.rand((n, K - 1), generator=gen), gumbel(gen, (n, V)),
        gumbel(gen, (n, V)))


def logits_pair(seed, scale):
    g = torch.Generator().manual_seed(100 + seed)
    return (torch.randn((1, K, V), generator=g) * scale,
            torch.randn((1, K - 1, V), generator=g) * scale)


@pytest.mark.parametrize("seed", [0, 7])
def test_first_token_marginal_matches_target(seed):
    """The first committed token's empirical distribution equals
    softmax(p_1) within 4 binomial standard errors (+1e-3) per bucket,
    for a draft distribution different from the target's."""
    t_logits, q_logits = logits_pair(seed, 1.5)
    n = 20000
    _, _, _, emit, counts = run_passes(n, t_logits, q_logits, seed=seed)
    assert int(counts.min()) >= 1
    got = np.bincount(emit[:, 0].numpy(), minlength=V) / n
    want = torch.softmax(t_logits[0, 0], -1).numpy()
    tol = 4 * np.sqrt(want * (1 - want) / n)
    assert np.all(np.abs(got - want) <= tol + 1e-3), (got, want)


@pytest.mark.parametrize("seed", [3])
def test_second_position_conditional_marginal(seed):
    """Rows that accepted their first draft commit a second token
    distributed as softmax(p_2) (within 4 standard errors + 2e-3): this
    pins the rejection row's and the bonus's gather indices."""
    t_logits, q_logits = logits_pair(100 + seed, 1.5)
    n = 40000
    _, _, _, emit, counts = run_passes(n, t_logits, q_logits, seed=seed)
    second = emit[counts >= 2, 1].numpy()
    assert len(second) > 3000              # acceptance isn't degenerate
    want = torch.softmax(t_logits[0, 1], -1).numpy()
    got = np.bincount(second, minlength=V) / len(second)
    tol = 4 * np.sqrt(want * (1 - want) / len(second))
    assert np.all(np.abs(got - want) <= tol + 2e-3), (got, want)


def test_greedyish_temperature_sharpens_to_argmax():
    t_logits, q_logits = logits_pair(3, 2.0)
    _, _, _, emit, _ = run_passes(500, t_logits, q_logits, temp=0.05,
                                  seed=4)
    am = int(torch.argmax(t_logits[0, 0]))
    assert (emit[:, 0] == am).float().mean() > 0.99


def test_identical_models_accept_everything():
    t_logits, _ = logits_pair(5, 1.0)
    _, _, _, _, counts = run_passes(300, t_logits, t_logits[:, :K - 1],
                                    seed=6)
    assert int(counts.min()) == K


def test_frozen_slot_holds():
    token2, pos2, done2, _, counts = run_passes(
        1, torch.zeros((1, K, V)), torch.zeros((1, K - 1, V)), done=True)
    assert int(counts[0]) == 0
    assert int(token2[0]) == 0 and int(pos2[0]) == 0
    assert bool(done2[0])


def test_eos_in_commit_freezes():
    t_logits = torch.full((1, K, V), -30.0)
    t_logits[:, :, 2] = 30.0
    _, _, done2, emit, _ = run_passes(1, t_logits, t_logits[:, :K - 1],
                                      eos=2, seed=1)
    assert bool(done2[0]) and int(emit[0, 0]) == 2


def test_multi_slot_batch_shapes():
    slots = 4
    g = torch.Generator().manual_seed(9)
    t_logits = torch.randn((slots, K, V), generator=g)
    q_logits = torch.randn((slots, K - 1, V), generator=g)
    drafts = torch.randint(0, V, (slots, K - 1), generator=g,
                           dtype=torch.int32)
    token2, pos2, done2, emit, counts = commit_sampled(
        torch.zeros(slots, dtype=torch.int32),
        torch.zeros(slots, dtype=torch.int32),
        torch.full((slots,), -1, dtype=torch.int32),
        torch.zeros(slots, dtype=torch.bool), drafts, t_logits, q_logits,
        torch.rand((slots, K - 1), generator=g), gumbel(g, (slots, V)),
        gumbel(g, (slots, V)))
    assert emit.shape == (slots, K) and counts.shape == (slots,)
    assert bool((counts >= 1).all()) and torch.equal(pos2, counts)
