"""Beam search of the PyTorch port (``decode.beam_decode``) against the
reference's (tests/test_beam.py) on its tiny config, the same weights
through ``convert.py`` and the same prompts.

Hypotheses equal the reference's.  A beam's score is a sum of bf16-path
log-probabilities, and the two packages' sums part by at most 0.041 on
these fixtures (6 steps), so scores are held within ``SCORE_TOL``; two
hypotheses whose reference scores lie within 2 x ``SCORE_TOL`` of each
other are a near-tie that rounding may order either way, and may swap
places."""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import cfg_pair, to_torch

from tpu_dra.workloads import decode as jd
from tpu_dra.workloads.train import forward as jforward
from tpu_dra.workloads.train import init_params
from tpu_dra_torch.workloads import decode as td
from tpu_dra_torch.workloads.train import forward

JCFG, TCFG = cfg_pair(vocab=8, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                      max_seq=32)
JPARAMS = init_params(JCFG, jax.random.PRNGKey(0))
PARAMS = to_torch(JPARAMS)
SCORE_TOL = 0.05


def prompt_of(seed: int, shape) -> np.ndarray:
    """tests/test_beam.py's prompt for ``PRNGKey(seed)``."""
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), shape, 0,
                                        JCFG.vocab, dtype=jnp.int32))


def both(prompt, **kw):
    jh, js = jd.beam_decode(JCFG, JPARAMS, jnp.asarray(prompt), **kw)
    th, ts = td.beam_decode(TCFG, PARAMS, torch.from_numpy(prompt), **kw)
    return (np.asarray(jh), np.asarray(js)), (th.numpy(), ts.numpy())


def assert_beams_agree(want, got):
    """Per row: the same hypotheses with scores within SCORE_TOL, in the
    same order up to swaps of reference near-ties."""
    (wh, ws), (gh, gs) = want, got
    assert gh.shape == wh.shape and gs.shape == ws.shape
    assert gh.dtype == np.int32 and gs.dtype == np.float32
    for b in range(wh.shape[0]):
        ref = {tuple(h): float(s) for h, s in zip(wh[b], ws[b])}
        port = [tuple(h) for h in gh[b]]
        assert sorted(port) == sorted(ref), (port, list(ref))
        for w, h in enumerate(port):
            assert abs(gs[b, w] - ref[h]) <= SCORE_TOL, (h, gs[b, w], ref[h])
            want_h = tuple(wh[b, w])
            if h != want_h:
                assert abs(ref[h] - ref[want_h]) <= 2 * SCORE_TOL, (
                    h, want_h, ref[h], ref[want_h])
        assert (np.diff(gs[b]) <= 1e-6).all(), gs[b]


CASES = {  # tests/test_beam.py's calls: (prompt seed, shape, kwargs)
    "beam1": (1, (2, 5), dict(steps=6, beams=1)),
    "sorted": (3, (2, 4), dict(steps=4, beams=4)),
    "unconstrained": (4, (1, 4), dict(steps=6, beams=3)),
    "int8": (5, (2, 4), dict(steps=4, beams=2, cache_dtype="int8")),
    "full-width": (2, (1, 4), dict(steps=2, beams=8)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_beam_decode_follows_the_reference(name):
    seed, shape, kw = CASES[name]
    want, got = both(prompt_of(seed, shape), **kw)
    assert_beams_agree(want, got)
    assert np.isfinite(got[1]).all()


def test_beam1_equals_greedy():
    """:29: one beam is greedy decoding, bit for bit on the port."""
    prompt = torch.from_numpy(prompt_of(1, (2, 5)))
    hist, scores = td.beam_decode(TCFG, PARAMS, prompt, steps=6, beams=1)
    assert hist.shape == (2, 1, 6) and scores.shape == (2, 1)
    want = td.greedy_decode(TCFG, PARAMS, prompt, steps=6)
    assert torch.equal(hist[:, 0], want)


def test_full_width_beam_finds_optimum():
    """:40: beams == vocab and two steps keep every first token, so the
    best 2-token continuation by brute force (the port's plain forward)
    is beam 0; the score within SCORE_TOL of the brute-force one, which
    itself is within SCORE_TOL of the reference's brute force."""
    prompt = prompt_of(2, (1, 4))
    S = prompt.shape[1]
    hist, scores = td.beam_decode(TCFG, PARAMS, torch.from_numpy(prompt),
                                  steps=2, beams=TCFG.vocab)
    best, best_score, ref_score = None, -np.inf, None
    for t0, t1 in itertools.product(range(TCFG.vocab), repeat=2):
        seq = np.concatenate([prompt, [[t0, t1]]], axis=1).astype(np.int32)
        lp = torch.log_softmax(forward(TCFG, PARAMS, torch.from_numpy(seq))
                               .float(), dim=-1)
        sc = float(lp[0, S - 1, t0] + lp[0, S, t1])
        if sc > best_score:
            best, best_score = (t0, t1), sc
            jlp = jax.nn.log_softmax(jforward(JCFG, JPARAMS, jnp.asarray(
                seq)).astype(jnp.float32), axis=-1)
            ref_score = float(jlp[0, S - 1, t0] + jlp[0, S, t1])
    assert tuple(hist[0, 0].tolist()) == best
    assert abs(float(scores[0, 0]) - best_score) <= SCORE_TOL
    assert abs(best_score - ref_score) <= SCORE_TOL


def test_beam_eos_freezes_and_pads():
    """:62: with eos a finished beam pads with eos; the hypotheses and
    scores follow the reference's."""
    prompt = prompt_of(4, (1, 4))
    (ref, _), _ = both(prompt, steps=6, beams=3)
    eos = int(ref[0, 0, 2])
    want, got = both(prompt, steps=6, beams=3, eos_id=eos)
    assert_beams_agree(want, got)
    hit = 0
    for toks in got[0][0].tolist():
        if eos in toks:
            hit += 1
            assert all(t == eos for t in toks[toks.index(eos):]), toks
    assert hit > 0


def test_beam_length_penalty_normalizes_finished():
    """:104: length_penalty divides finished beams' scores by the GNMT
    norm and re-sorts: the normalized scores follow from the port's own
    raw run exactly, and the hypotheses follow the reference's."""
    prompt = prompt_of(6, (1, 4))
    eos_seed = int(jax.random.randint(jax.random.PRNGKey(7), (), 0,
                                      JCFG.vocab))
    (ref_hist, _), _ = both(prompt, steps=6, beams=3, eos_id=eos_seed)
    eos = int(ref_hist[0, 0, 1])
    _, (raw_h, raw_s) = both(prompt, steps=6, beams=3, eos_id=eos)
    want, got = both(prompt, steps=6, beams=3, eos_id=eos,
                     length_penalty=2.0)
    assert_beams_agree(want, got)
    expected = []
    for w in range(3):
        toks, sc = raw_h[0, w].tolist(), float(raw_s[0, w])
        if eos in toks:
            sc = sc / (((5.0 + toks.index(eos) + 1) / 6.0) ** 2.0)
        expected.append((sc, toks))
    expected.sort(key=lambda t: -t[0])
    got_pairs = [(float(got[1][0, w]), got[0][0, w].tolist())
                 for w in range(3)]
    for (es, et), (gs, gt) in zip(expected, got_pairs):
        assert gt == et and abs(es - gs) < 1e-5


def test_beam_reorders_the_cache_by_parent():
    """The cache after the last reorder holds, in each hypothesis' row,
    that hypothesis' own context: rerunning each best hypothesis alone
    through greedy forcing gives its score."""
    prompt = torch.from_numpy(prompt_of(3, (2, 4)))
    hist, scores = td.beam_decode(TCFG, PARAMS, prompt, steps=4, beams=4)
    for b in range(2):
        for w in range(4):
            seq = torch.cat([prompt[b], hist[b, w]])[None]
            lp = torch.log_softmax(forward(TCFG, PARAMS, seq).float(), -1)
            forced = sum(float(lp[0, 3 + i, hist[b, w, i]])
                         for i in range(4))
            assert abs(forced - float(scores[b, w])) <= SCORE_TOL


@pytest.mark.parametrize("kw,match", [
    (dict(beams=JCFG.vocab + 1), "beams"), (dict(beams=0), "beams"),
    (dict(beams=2, eos_id=JCFG.vocab), "eos_id"),
    (dict(beams=2, length_penalty=0.5), "length_penalty"),
    (dict(beams=2, eos_id=1, length_penalty=-1.0), "length_penalty"),
    (dict(beams=2, steps=40), "exceeds"),
], ids=["wide", "zero", "eos", "penalty-no-eos", "negative", "long"])
def test_beam_guards(kw, match):
    """:135, :164: the reference's guards, raised before any work."""
    kw = {"steps": 2, **kw}
    for cfg, params, prompt, decode in (
            (JCFG, JPARAMS, jnp.zeros((1, 4), jnp.int32), jd.beam_decode),
            (TCFG, PARAMS, torch.zeros((1, 4), dtype=torch.int32),
             td.beam_decode)):
        if decode is jd.beam_decode and match == "exceeds":
            continue           # the reference asserts (AssertionError)
        with pytest.raises(ValueError, match=match):
            decode(cfg, params, prompt, **kw)


def test_beam_learned_position_bound():
    jcfg, tcfg = cfg_pair(vocab=8, d_model=32, n_heads=2, n_layers=1,
                          d_ff=64, max_seq=8)
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    tp = to_torch(jp)
    with pytest.raises(ValueError, match="learned-position table"):
        td.beam_decode(tcfg, tp, torch.zeros((1, 6), dtype=torch.int32),
                       steps=4, beams=2, max_len=16)
    with pytest.raises(ValueError, match="learned-position table"):
        jd.beam_decode(jcfg, jp, jnp.zeros((1, 6), jnp.int32), steps=4,
                       beams=2, max_len=16)
