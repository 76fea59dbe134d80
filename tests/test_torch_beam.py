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


# --------------------------------------------------------------------------
# Where the int8 and tied beams part from the reference's
# --------------------------------------------------------------------------

# tests/test_torch_process_decode.py's beam fixtures, the smallest inputs
# on which the port's beams lay past SCORE_TOL from the reference's (int8
# at seeds 0 and 1: 0.118 and 0.085; tied, its embedding spread 4, at
# seeds 0-2: 0.070-0.156): 4 heads over 2, rope, 3 beams, 4 steps
GAP_CFG = dict(vocab=8, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
               d_ff=64, max_seq=32, pos_emb="rope")
GAP_CASES = [("int8", 0), ("int8", 1), ("tied", 0), ("tied", 1),
             ("tied", 2)]
GAP_RUN = dict(steps=4, beams=3, max_len=20)


def gap_case(form: str, seed: int):
    """(reference config, port config, reference serving tree, its port
    copy) of a gap case."""
    from torch_parity import jax_params

    from tpu_dra.workloads import quant as jq
    cfg = dict(GAP_CFG, tied_embeddings=form == "tied")
    jcfg, tcfg = cfg_pair(**cfg)
    jp = jax_params(jcfg, seed=seed,
                    embed_scale=4.0 if form == "tied" else 1.0)
    jp = jq.quantize_params_int8(jp) if form == "int8" \
        else jq.cast_params_bf16(jp)
    return jcfg, tcfg, jp, to_torch(jp)


def gap_prompt() -> np.ndarray:
    return np.random.default_rng(6).integers(0, 8, (4, 6), dtype=np.int32)


def gelu_bf16_steps(h):
    """``jax.nn.gelu``'s arithmetic on a bf16 array, op by op: its tanh
    formula with bf16 constants, every intermediate rounded to bf16 (the
    port's ``F.gelu(approximate="tanh")`` computes in fp32 and rounds
    once)."""
    def r(v):
        return v.to(torch.bfloat16).float()
    c = r(torch.tensor(np.sqrt(2 / np.pi)))
    k = r(torch.tensor(0.044715))
    x = h.float()
    cube = r(r(x * x) * x)
    t = r(torch.tanh(r(c * r(x + r(k * cube)))))
    return r(x * r(0.5 * r(1.0 + t))).to(h.dtype)


def test_the_reference_gelu_rounds_each_op_to_bf16():
    """The first tensor at which the gap cases part (int8, seed 0, row 3
    of the prompt, traced layer by layer) is layer 0's gelu output: the
    reference's ``jax.nn.gelu`` on the bf16 w1 product rounds each of its
    ops to bf16, bit for bit :func:`gelu_bf16_steps`, where the port's
    gelu rounds once (43% of the elements one or more bf16 ulps apart),
    while the attention sublayer, the rmsnorm and the int8 w1 product
    before it are bit-equal."""
    from tpu_dra.workloads import quant as jq
    from tpu_dra.workloads import train as jt
    from tpu_dra_torch.workloads import quant as tq
    from tpu_dra_torch.workloads import train as tt
    jcfg, tcfg, jp, tp = gap_case("int8", 0)
    x = jp["embed"].astype(jnp.bfloat16)[jnp.asarray(gap_prompt()[3:])]
    jl = jax.tree.map(lambda a: a[0], jp["blocks"])
    tl = tt.layer_params(tp["blocks"], 0)
    xa = jt._attn_sublayer(jcfg, x, jl)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    assert np.array_equal(np.asarray(xa, np.float32),
                          tt._attn_sublayer(tcfg, xt, tl).float().numpy())
    h = jq.matmul_any(jt._rmsnorm(xa, jl["ln2"]), jl["w1"], xa.dtype)
    ht = tq.matmul_any(tt._rmsnorm(torch.from_numpy(np.asarray(
        xa, np.float32)).to(torch.bfloat16), tl["ln2"]), tl["w1"],
        torch.bfloat16)
    want = np.asarray(h, np.float32)
    assert np.array_equal(want, ht.float().numpy())
    ref = np.asarray(jax.nn.gelu(h), np.float32)
    assert np.array_equal(ref, gelu_bf16_steps(ht).float().numpy())
    port = torch.nn.functional.gelu(ht, approximate="tanh").float().numpy()
    assert (port != ref).mean() > 0.3
    spread = jnp.asarray(np.linspace(-6, 6, 4097, dtype=np.float32)) \
        .astype(jnp.bfloat16)
    assert np.array_equal(
        np.asarray(jax.nn.gelu(spread), np.float32),
        gelu_bf16_steps(torch.from_numpy(np.asarray(spread, np.float32))
                        .to(torch.bfloat16)).float().numpy())


def test_the_reference_compiled_rounds_unlike_its_own_ops():
    """The reference as it runs (``beam_decode``'s prefill under
    ``lax.scan``, compiled by XLA) does not keep even its own op-by-op
    roundings: XLA fuses the gelu into the next int8 product's
    activation quantization and keeps excess precision there, and fuses
    the attention's scale and softmax.  Layer 0's block of the int8 gap
    case, jitted, parts from the same function run op by op on the same
    input, so no port of its ops can match the compiled reference's bits
    there."""
    from tpu_dra.workloads import train as jt
    jcfg, _, jp, _ = gap_case("int8", 0)
    x = jp["embed"].astype(jnp.bfloat16)[jnp.asarray(gap_prompt())]
    jl = jax.tree.map(lambda a: a[0], jp["blocks"])
    eager = np.asarray(jt._block(jcfg, x, jl), np.float32)
    jitted = np.asarray(jax.jit(lambda x, l: jt._block(jcfg, x, l))(x, jl),
                        np.float32)
    assert (eager != jitted).any()


@pytest.mark.parametrize("form,seed", GAP_CASES,
                         ids=[f"{f}-s{s}" for f, s in GAP_CASES])
def test_gap_beams_equal_the_reference_op_by_op(form, seed, monkeypatch):
    """The whole gap is those two roundings: with the reference run op
    by op (``jax.disable_jit``) and the port's gelu rounding each op as
    ``jax.nn.gelu`` does (:func:`gelu_bf16_steps`), the port's beams are
    the reference's, tokens equal and scores within 1e-6 (seen: 4.8e-7),
    at every gap case; with the port's own gelu they lie up to 0.094
    apart."""
    from tpu_dra_torch.workloads import train as tt
    jcfg, tcfg, jp, tp = gap_case(form, seed)
    p = gap_prompt()
    with jax.disable_jit():
        wh, ws = jd.beam_decode(jcfg, jp, jnp.asarray(p), **GAP_RUN)
    monkeypatch.setattr(tt.F, "gelu",
                        lambda h, approximate="tanh": gelu_bf16_steps(h))
    gh, gs = td.beam_decode(tcfg, tp, torch.from_numpy(p), **GAP_RUN)
    assert np.array_equal(gh.numpy(), np.asarray(wh))
    assert np.abs(gs.numpy() - np.asarray(ws)).max() <= 1e-6
