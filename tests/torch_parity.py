"""Shared fixtures of the PyTorch-port parity tests: the same weights and
inputs through the JAX reference and the port.

Weights come from the reference's ``init_params`` and cross through
numpy (``tpu_dra_torch.convert``); inputs are drawn with numpy from a
fixed seed.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from tpu_dra.workloads import train as jtrain
from tpu_dra_torch.convert import params_from_numpy
from tpu_dra_torch.workloads import train as ttrain

# the port's tests run on the CPU: the plain PyTorch path
CPU = "cpu"

# The suite runs in several worker processes, and each imports this
# module.  torch's default of one thread per core in every worker
# oversubscribes the machine: on 8 cores with 4 workers the port's tests
# took 98 s and 712 CPU-seconds that way, 31 s and 114 with one thread
# each, and leave the cores to the timing-sensitive tests beside them.
torch.set_num_threads(1)


def cfg_pair(**kw):
    """(reference ModelConfig, port ModelConfig) with the same fields."""
    jcfg = jtrain.ModelConfig(**kw)
    return jcfg, ttrain.ModelConfig(**dataclasses.asdict(jcfg))


def jax_params(jcfg, seed: int = 0, embed_scale: float = 1.0):
    """Reference init; ``embed_scale`` spreads a tied model's logit gaps
    (random-init logits are nearly uniform — see
    tests/test_continuous_paged.py)."""
    p = jtrain.init_params(jcfg, jax.random.PRNGKey(seed))
    if embed_scale != 1.0:
        p = dict(p, embed=p["embed"] * embed_scale)
    return p


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(tree, device=CPU):
    """Reference params (JAX arrays) → the port's dict of tensors."""
    return params_from_numpy(to_numpy_tree(tree), device)


def f32(x) -> np.ndarray:
    """Any JAX array or tensor (bf16 included) → float32 numpy."""
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def top2_margin(logits: np.ndarray) -> np.ndarray:
    """Per row: top logit minus the runner-up."""
    part = np.sort(logits, axis=-1)
    return part[..., -1] - part[..., -2]


def logit_tol(top: np.ndarray | float) -> np.ndarray | float:
    """Tolerance on one decode step's fp32 logits from the bf16 path: four
    bf16 ulps at the top logit's magnitude (4·2^-8 relative, at least
    2^-4 absolute).  The head's output is rounded to bf16 (one ulp), and
    its input carries the one-ulp flips of every residual add and matmul
    of the layers below, taken in another summation order."""
    return np.maximum(2 ** -4, 2 ** -6 * np.abs(top))


def argmax_tol(logits: np.ndarray) -> np.ndarray:
    """Two implementations each within ``logit_tol`` of the truth can
    disagree on the argmax only where the top-2 margin is under twice
    that tolerance."""
    return 2 * logit_tol(np.max(logits, axis=-1))


def ragged_case(rows, steps: int, page_size: int, total_pages: int):
    """Right-padded prompt [B, S] (pad 0), lengths [B] and a block table
    [B, MP] allocated from a fresh pool (scrambled: pages handed out in
    reverse), all numpy."""
    from tpu_dra_torch.workloads.paged_kv import PagePool
    B = len(rows)
    S = max(len(r) for r in rows)
    prompt = np.zeros((B, S), np.int32)
    for i, r in enumerate(rows):
        prompt[i, :len(r)] = r
    lengths = np.asarray([len(r) for r in rows], np.int32)
    pool = PagePool(total_pages, page_size)
    pool._free = pool._free[::-1]
    need = [pool.pages_for(len(r) + steps) for r in rows]
    mp = max(need)
    table = np.stack([pool.table_row(pool.alloc(n), mp) for n in need])
    return prompt, lengths, table


def jax_stream(jcfg, params, prompt, lengths, table, steps: int, *,
               page_size: int, total_pages: int, cache_dtype="bf16",
               forced=None):
    """Reference greedy decode step by step: ``(tokens [B, steps],
    logits [steps, B, V])`` where ``logits[i]`` chose ``tokens[:, i]``.
    With ``forced`` [B, steps] the reference is fed those tokens instead
    of its own (teacher forcing); ``logits[i]`` then follow
    ``forced[:, :i]``."""
    from functools import partial

    import jax.numpy as jnp

    from tpu_dra.workloads import paged_kv as jpk
    pad = (-prompt.shape[1]) % page_size
    prompt = np.pad(prompt, ((0, 0), (0, pad)))
    cache = jpk.init_paged_cache(jcfg, total_pages, page_size, cache_dtype)
    ks, vs, xs = jpk._prefill_kv(jcfg, params, jnp.asarray(prompt))
    tab = jnp.asarray(table)
    cache = jpk.scatter_prefill(cache, ks, vs, tab)
    lens = jnp.asarray(lengths)
    last = xs[jnp.arange(len(lengths)), lens - 1][:, None]
    logits = np.asarray(jtrain.head_logits(params, last)[:, 0])
    step = jax.jit(partial(jpk._paged_step, jcfg, interpret=True))
    toks, outs = [], []
    for i in range(steps):
        outs.append(logits)
        tok = np.argmax(logits, -1).astype(np.int32)
        toks.append(tok)
        if i + 1 < steps:
            feed = tok if forced is None else forced[:, i]
            cache, lg, lens = step(params, cache, jnp.asarray(feed), lens,
                                   tab)
            logits = np.asarray(lg)
    return np.stack(toks, 1), np.stack(outs)


def port_forced_logits(tcfg, tparams, prompt, lengths, table, forced, *,
                       page_size: int, total_pages: int,
                       cache_dtype="bf16"):
    """The port's step logits ``[steps, B, V]`` when fed ``forced``
    [B, steps] (step i's logits follow tokens < i)."""
    from tpu_dra_torch.workloads import paged_kv as tpk
    cache = tpk.init_paged_cache(tcfg, total_pages, page_size, cache_dtype,
                                 device=CPU)
    tab = torch.from_numpy(table)
    lens = torch.from_numpy(lengths)
    logits = tpk.prefill_pages(tcfg, tparams, cache,
                               torch.from_numpy(prompt).long(), lens, tab)
    outs = []
    for i in range(forced.shape[1]):
        outs.append(f32(logits))
        if i + 1 < forced.shape[1]:
            cache, logits, lens = tpk._paged_step(
                tcfg, tparams, cache, torch.from_numpy(forced[:, i]), lens,
                tab)
    return np.stack(outs)


def assert_greedy_agrees(want_tokens, want_logits, got_tokens):
    """The margin rule for the greedy streams of two correct
    implementations: they agree up to the first step where they differ,
    and there the reference's top-2 margin must be within
    :func:`argmax_tol` (a bf16 near-tie that rounding may break either
    way).  ``want_logits[i]`` are the reference logits that chose
    ``want_tokens[i]``.  Returns the number of agreeing steps."""
    want_tokens = [int(t) for t in want_tokens]
    got_tokens = [int(t) for t in got_tokens]
    assert len(want_tokens) == len(got_tokens)
    for i, (w, g) in enumerate(zip(want_tokens, got_tokens)):
        if w != g:
            lg = np.asarray(want_logits[i])
            margin, tol = float(top2_margin(lg)), float(argmax_tol(lg))
            assert margin <= tol, (
                f"step {i}: tokens {g} != {w} with reference margin "
                f"{margin:.4f} > tolerance {tol:.4f}")
            return i
    return len(want_tokens)
