"""Speculative decoding in the PyTorch port: ``decode.speculative_decode``,
the draft models of ``spec_draft.py`` and their optimizer
(``optim.Adam``), the continuous engine's speculative passes and logit
bias in both KV layouts, and their serving and bench surfaces — on the
CPU, against the port's own plain paths and the JAX reference
(tests/test_decode.py, tests/test_spec_draft.py,
tests/test_continuous.py, tests/test_continuous_paged.py).

Greedy speculation commits the longest prefix of proposals equal to the
target's argmax over the verify chunk, so its tokens are the plain
path's as far as the chunk forward rounds like the one-token step: on
the CPU it does, and the tests hold them equal.
"""

from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import (
    assert_greedy_agrees,
    cfg_pair,
    f32,
    jax_params,
    jax_stream,
    ragged_case,
    to_torch,
)

from tpu_dra.workloads import decode as jd
from tpu_dra.workloads import spec_draft as jsd
from tpu_dra.workloads.continuous import ContinuousEngine as JaxEngine
from tpu_dra_torch import bench
from tpu_dra_torch.workloads import decode as td
from tpu_dra_torch.workloads import spec_draft as tsd
from tpu_dra_torch.workloads.continuous import ContinuousEngine
from tpu_dra_torch.workloads.optim import Adam
from tpu_dra_torch.workloads.train import tree_leaves

WAIT = 120

# -------------------------------------------------------------------------
# speculative_decode (tests/test_decode.py's configs)
# -------------------------------------------------------------------------


def decode_models(pos_emb: str):
    kw = dict(vocab=64, max_seq=64, pos_emb=pos_emb)
    jcfg, tcfg = cfg_pair(d_model=32, n_heads=2, n_layers=2, d_ff=64, **kw)
    jdcfg, tdcfg = cfg_pair(d_model=16, n_heads=2, n_layers=1, d_ff=32,
                            **kw)
    jp, jdp = jax_params(jcfg, seed=30), jax_params(jdcfg, seed=99)
    prompt = np.random.default_rng(31).integers(0, 64, (2, 5))
    return (jcfg, tcfg, jp, to_torch(jp), jdcfg, tdcfg, jdp, to_torch(jdp),
            prompt)


def jax_greedy_logits(jcfg, jp, prompt, tokens):
    """The reference's greedy-decode logits ``[steps, B, V]`` when fed
    ``tokens`` [B, steps] (step i's logits follow tokens < i)."""
    B, S = prompt.shape
    cache = jd.init_kv_cache(jcfg, B, jcfg.max_seq)
    cache, logits = jd.prefill(jcfg, jp, cache, jnp.asarray(prompt))
    outs = [np.asarray(logits)]
    for i in range(tokens.shape[1] - 1):
        logits, cache = jd._token_logits(jcfg, jp, cache, S + i,
                                         jnp.asarray(tokens[:, i]))
        outs.append(np.asarray(logits))
    return np.stack(outs)


@pytest.mark.parametrize("pos_emb", ["learned", "rope"])
def test_speculative_decode_equals_greedy(pos_emb):
    """For a perfect draft (the target) and an adversarial one (another
    init): the port's tokens equal its greedy_decode's, which follow the
    reference's greedy tokens up to a bf16 near-tie; the perfect draft
    needs ~steps/k target passes."""
    jcfg, tcfg, jp, tp, _, tdcfg, _, tdp, prompt = decode_models(pos_emb)
    steps = 9
    prompt_t = torch.from_numpy(prompt)
    want = td.greedy_decode(tcfg, tp, prompt_t, steps=steps)
    ref = np.asarray(jd.greedy_decode(jcfg, jp, jnp.asarray(prompt),
                                      steps=steps))
    ref_lg = jax_greedy_logits(jcfg, jp, prompt, ref)
    for b in range(2):
        assert_greedy_agrees(ref[b], ref_lg[:, b], want[b].tolist())
    passes = {}
    for name, dcfg, dp in (("perfect", tcfg, tp),
                           ("adversarial", tdcfg, tdp)):
        got, stats = td.speculative_decode(tcfg, tp, dcfg, dp, prompt_t,
                                           steps=steps, k=4,
                                           return_stats=True)
        assert torch.equal(got, want), (name, got.tolist(), want.tolist())
        passes[name] = stats["target_passes"]
    assert passes["perfect"] <= (steps + 3) // 4 + 1, passes
    assert passes["adversarial"] <= steps, passes


def test_speculative_decode_int8_cache_equals_greedy():
    _, tcfg, _, tp, _, tdcfg, _, tdp, prompt = decode_models("rope")
    prompt_t = torch.from_numpy(prompt)
    want = td.greedy_decode(tcfg, tp, prompt_t, steps=7, cache_dtype="int8")
    got = td.speculative_decode(tcfg, tp, tdcfg, tdp, prompt_t, steps=7,
                                k=3, cache_dtype="int8")
    assert torch.equal(got, want)


def test_speculative_decode_sampled():
    """Sampled speculation (the rejection scheme): valid tokens,
    reproducible per generator seed, seeds diverge, a perfect draft still
    commits up to k a pass, and a generator is required."""
    _, tcfg, _, tp, _, tdcfg, _, tdp, prompt = decode_models("learned")
    prompt_t, steps = torch.from_numpy(prompt), 9

    def run(seed, dcfg=tdcfg, dp=tdp):
        return td.speculative_decode(
            tcfg, tp, dcfg, dp, prompt_t, steps=steps, k=4, temperature=0.9,
            top_k=8, return_stats=True,
            generator=torch.Generator().manual_seed(seed))

    got, _ = run(1)
    assert got.shape == (2, steps) and bool(((got >= 0) & (got < 64)).all())
    assert torch.equal(run(1)[0], got)
    assert not torch.equal(run(2)[0], got)
    assert run(1, tcfg, tp)[1]["target_passes"] <= (steps + 3) // 4 + 1
    with pytest.raises(ValueError, match="generator"):
        td.speculative_decode(tcfg, tp, tdcfg, tdp, prompt_t, steps=steps,
                              temperature=0.5)


@pytest.mark.parametrize("kw,match", [
    (dict(k=1), "k must be >= 2"),
    (dict(steps=60), "exceeds max_len"),
], ids=["k", "max_len"])
def test_speculative_decode_guards(kw, match):
    _, tcfg, _, tp, _, tdcfg, _, tdp, prompt = decode_models("rope")
    kw = dict(dict(steps=4), **kw)
    with pytest.raises(ValueError, match=match):
        td.speculative_decode(tcfg, tp, tdcfg, tdp, torch.from_numpy(prompt),
                              **kw)
    bad = cfg_pair(vocab=32, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                   max_seq=64)[1]
    with pytest.raises(ValueError, match="vocab"):
        td.speculative_decode(tcfg, tp, bad, tdp, torch.from_numpy(prompt),
                              steps=4)


# -------------------------------------------------------------------------
# Draft models and their optimizer (tests/test_spec_draft.py's configs)
# -------------------------------------------------------------------------

DRAFT_KW = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                max_seq=64)
JD, TD = cfg_pair(**DRAFT_KW)
JDP = jax_params(JD, seed=0, embed_scale=4.0)
TDP = to_torch(JDP)
DRAFT_PROMPTS = [[3, 5, 7], [2, 4], [11, 12, 13], [9] * 6]


def test_truncate_shapes_and_validation():
    dcfg, dparams = tsd.truncate_draft(TD, TDP, 1)
    assert dcfg.n_layers == 1 and TD.n_layers == 2
    for leaf in dparams["blocks"].values():
        assert leaf.shape[0] == 1
    # embedding and final norm shared with the target (the same tensors)
    assert dparams["embed"] is TDP["embed"]
    assert dparams["ln_f"] is TDP["ln_f"]
    for bad in (0, 3):
        with pytest.raises(ValueError, match="draft depth"):
            tsd.truncate_draft(TD, TDP, bad)


def test_adam_matches_optax_adam():
    """Five updates from gradients of mixed magnitude (zeros, 1e-8 up to
    10): the parameters within 1e-6 of optax.adam's."""
    r = np.random.default_rng(0)
    p = {"w": r.standard_normal((6, 5)).astype(np.float32),
         "b": {"c": r.standard_normal(7).astype(np.float32)}}
    jopt, tp = optax.adam(3e-3), {"w": torch.tensor(p["w"]),
                                  "b": {"c": torch.tensor(p["b"]["c"])}}
    jstate, opt = jopt.init(p), Adam(3e-3)
    state = opt.init(tp)
    for i, scale in enumerate([10.0, 1.0, 1e-8, 0.0, 1e-3]):
        g = {"w": r.standard_normal((6, 5)).astype(np.float32) * scale,
             "b": {"c": r.standard_normal(7).astype(np.float32)}}
        upd, jstate = jopt.update(g, jstate, p)
        p = optax.apply_updates(p, upd)
        state = opt.update(tp, {"w": torch.tensor(g["w"]),
                                "b": {"c": torch.tensor(g["b"]["c"])}},
                           state)
        assert state.count == i + 1
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(p["w"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tp["b"]["c"].numpy(), np.asarray(p["b"]["c"]),
                               rtol=0, atol=1e-6)


def test_distill_loss_and_grads_match_reference():
    """KL(target ‖ draft) within 2% of the reference's on the same
    tokens, every gradient leaf within 3% relative L2 (the bf16 forward
    rounds in another order)."""
    jdcfg, jdp = jsd.truncate_draft(JD, JDP, 1)
    tdcfg, tdp = tsd.truncate_draft(TD, TDP, 1)
    tokens = np.random.default_rng(1).integers(0, 128, (4, 16))
    jloss, jgrads = jax.value_and_grad(
        lambda d: jsd._distill_loss(jdcfg, JD, JDP, d, jnp.asarray(tokens))
    )(jdp)
    live = [p.detach().clone().requires_grad_() for p in tree_leaves(tdp)]
    from tpu_dra_torch.workloads.train import tree_unflatten
    loss = tsd._distill_loss(tdcfg, TD, TDP, tree_unflatten(tdp, live),
                             torch.from_numpy(tokens))
    grads = torch.autograd.grad(loss, live)
    assert abs(loss.item() - float(jloss)) <= 2e-2 * float(jloss)
    want = _flat(jgrads)
    for (path, w), g in zip(_flat(tdp).items(), grads):
        w = np.asarray(want[path], np.float32)
        err = np.linalg.norm(f32(g) - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= 0.03, (path, err)


def _flat(tree, prefix=""):
    """``{path: leaf}`` of a nested dict, in its insertion order (the
    order of ``tree_leaves``)."""
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": v})
    return out


def test_one_distillation_step_matches_reference():
    """One Adam step on the same tokens, each side: the loss on a second
    batch falls on both sides and the two agree within 2%."""
    jdcfg, jdp = jsd.truncate_draft(JD, JDP, 1)
    tdcfg, tdp = tsd.truncate_draft(TD, TDP, 1)
    r = np.random.default_rng(2)
    tokens, held = r.integers(0, 128, (8, 16)), r.integers(0, 128, (8, 16))
    opt = optax.adam(3e-3)
    grads = jax.grad(lambda d: jsd._distill_loss(
        jdcfg, JD, JDP, d, jnp.asarray(tokens)))(jdp)
    upd, _ = opt.update(grads, opt.init(jdp), jdp)
    jdp2 = optax.apply_updates(jdp, upd)
    from tpu_dra_torch.workloads.train import tree_unflatten
    tdp2 = tree_unflatten(tdp, [p.clone() for p in tree_leaves(tdp)])
    topt = Adam(3e-3)
    tsd._distill_step(TD, TDP, tdcfg, tdp2, topt, topt.init(tdp2),
                      torch.from_numpy(tokens))

    def losses(jd_, td_):
        return (float(jsd._distill_loss(jdcfg, JD, JDP, jd_,
                                        jnp.asarray(held))),
                float(tsd._distill_loss(tdcfg, TD, TDP, td_,
                                        torch.from_numpy(held))))
    (j0, t0), (j1, t1) = losses(jdp, tdp), losses(jdp2, tdp2)
    assert j1 < j0 and t1 < t0
    assert abs(t1 - j1) <= 2e-2 * j1


@pytest.fixture(scope="module")
def drafts():
    """A truncated and a distilled draft, shared by the module."""
    dcfg, trunc = tsd.truncate_draft(TD, TDP, 1)
    before = [p.clone() for p in tree_leaves(TDP)]
    distilled = tsd.distill_draft(TD, TDP, dcfg, trunc, steps=300, batch=8,
                                  seq=32)
    # the inputs are untouched, the result shares nothing with the target
    for a, b in zip(before, tree_leaves(TDP)):
        assert torch.equal(a, b)
    assert distilled["embed"] is not TDP["embed"]
    return dcfg, trunc, distilled


def test_distillation_lifts_accept_rate(drafts):
    """Distillation must beat the zero-training truncation by a clear
    margin in the engine's accept rate, and keep its tokens."""
    dcfg, trunc, distilled = drafts
    kw = dict(prompts=DRAFT_PROMPTS, steps=24, max_len=40, chunk=4,
              device="cpu")
    r_trunc = tsd.measure_accept_rate(TD, TDP, dcfg, trunc, **kw)
    r_dist = tsd.measure_accept_rate(TD, TDP, dcfg, distilled, **kw)
    assert r_dist["outputs"] == r_trunc["outputs"]
    assert r_dist["accept_rate"] >= r_trunc["accept_rate"] + 0.05
    assert r_dist["accept_rate"] >= 0.25
    assert r_dist["tokens_per_pass"] > r_trunc["tokens_per_pass"]


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_real_draft_keeps_the_plain_engines_tokens(drafts, layout):
    dcfg, _, distilled = drafts
    kw = dict(slots=4, chunk=4, max_len=40, page_size=8, device="cpu",
              kv_layout=layout)
    plain = ContinuousEngine(TD, TDP, **kw)
    try:
        want = [plain.submit(p, 12, timeout=WAIT) for p in DRAFT_PROMPTS]
    finally:
        plain.shutdown()
    spec = ContinuousEngine(TD, TDP, draft=(dcfg, distilled), **kw)
    try:
        got = [spec.submit(p, 12, timeout=WAIT) for p in DRAFT_PROMPTS]
        st = spec.stats()
    finally:
        spec.shutdown()
    assert got == want
    assert 0.0 <= st["spec_accept_rate"] <= 1.0
    assert st["spec_tokens_per_pass"] >= 1.0


def test_make_draft_one_call():
    dcfg, dparams = tsd.make_draft(TD, TDP, distill_steps=3, batch=4, seq=16)
    assert dcfg.n_layers == 1                     # quarter depth, min 1
    for leaf in dparams["blocks"].values():
        assert leaf.shape[0] == 1 and leaf.dtype == torch.float32


# -------------------------------------------------------------------------
# The continuous engine's speculative passes, both layouts
# (tests/test_continuous.py and tests/test_continuous_paged.py)
# -------------------------------------------------------------------------

ENGINE_CFG = dict(vocab=128, d_model=64, n_heads=4, n_kv_heads=2,
                  n_layers=2, d_ff=128, max_seq=64, pos_emb="rope",
                  tied_embeddings=True)
JCFG, TCFG = cfg_pair(**ENGINE_CFG)
JPARAMS = jax_params(JCFG, seed=0, embed_scale=4.0)
PARAMS = to_torch(JPARAMS)
JDCFG, DCFG = cfg_pair(**dict(ENGINE_CFG, d_model=32, n_heads=2,
                              n_kv_heads=1, n_layers=1, d_ff=64))
DPARAMS = to_torch(jax_params(JDCFG, seed=9))
LAYOUTS = ["slab", "paged"]
REQS = [([1, 2, 3], 6), ([5, 6, 7, 8, 9, 10], 4), ([11, 12], 8),
        ([4] * 20, 3)]


def engine(layout, params=PARAMS, **kw):
    base = dict(slots=4, chunk=3, max_len=40, page_size=8, device="cpu",
                kv_layout=layout)
    return ContinuousEngine(TCFG, params, **dict(base, **kw))


def serve_all(eng, reqs, **kw):
    handles = [eng.submit_async(p, s, **kw) for p, s in reqs]
    for h in handles:
        assert h.done.wait(WAIT) and h.error is None, h.error
    return [h.tokens for h in handles]


@pytest.mark.parametrize("draft", ["small", "target"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_spec_engine_equals_plain_engine(layout, draft):
    """Concurrent greedy requests: every answer equals the plain engine's,
    for a random small draft and for the target itself (which accepts
    every proposal); the pool heals."""
    plain = engine(layout)
    try:
        want = serve_all(plain, REQS)
    finally:
        plain.shutdown()
    d = (DCFG, DPARAMS) if draft == "small" else (TCFG, PARAMS)
    spec = engine(layout, draft=d)
    try:
        got = serve_all(spec, REQS)
        st = spec.stats()
    finally:
        spec.shutdown()
    assert got == want
    assert st["spec_target_passes"] >= 1
    if draft == "target":
        assert st["spec_accept_rate"] == 1.0, st
    if layout == "paged":
        assert st["kv_pages_free"] == st["kv_pages_total"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spec_engine_perfect_draft_commits_the_chunk(layout):
    spec = engine(layout, slots=2, chunk=4, draft=(TCFG, PARAMS))
    try:
        toks = spec.submit([1, 2, 3], 9, timeout=WAIT)
        st = spec.stats()
    finally:
        spec.shutdown()
    want = td.greedy_decode(TCFG, PARAMS, torch.tensor([[1, 2, 3]]),
                            steps=9, max_len=40)[0].tolist()
    assert toks == want
    assert st["spec_tokens_per_pass"] == pytest.approx(4.0), st
    assert st["spec_target_passes"] == 2


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spec_engine_eos_stops_early(layout):
    spec = engine(layout, slots=2, draft=(TCFG, PARAMS))
    try:
        ref = spec.submit([1, 2, 3], 12, timeout=WAIT)
        eos = ref[4]
        toks = spec.submit([1, 2, 3], 12, eos_id=eos, timeout=WAIT)
        st = spec.stats()
    finally:
        spec.shutdown()
    assert toks == ref[:ref.index(eos) + 1]
    if layout == "paged":
        assert st["kv_pages_free"] == st["kv_pages_total"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spec_engine_int8_cache_equals_plain_int8(layout):
    reqs = [([3, 5, 7], 8), ([2, 4], 7)]
    plain = engine(layout, slots=2, chunk=2, cache_dtype="int8")
    try:
        want = serve_all(plain, reqs)
    finally:
        plain.shutdown()
    spec = engine(layout, slots=2, chunk=2, cache_dtype="int8",
                  draft=(DCFG, DPARAMS))
    try:
        got = serve_all(spec, reqs)
        sampled = spec.submit([4, 5], 6, temperature=0.8, seed=3,
                              timeout=WAIT)
    finally:
        spec.shutdown()
    assert got == want and len(sampled) == 6


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spec_engine_join_midflight_and_slot_reuse(layout):
    spec = engine(layout, slots=2, draft=(DCFG, DPARAMS))
    try:
        long_req = spec.submit_async([1, 2, 3], 18)
        time.sleep(0.3)
        short = spec.submit([7, 8], 4, timeout=WAIT)
        assert long_req.done.wait(WAIT) and not long_req.error
        again = spec.submit([9, 10, 11], 5, timeout=WAIT)
    finally:
        spec.shutdown()
    for prompt, steps, got in (([1, 2, 3], 18, long_req.tokens),
                               ([7, 8], 4, short), ([9, 10, 11], 5, again)):
        want = td.greedy_decode(TCFG, PARAMS, torch.tensor([prompt]),
                                steps=steps, max_len=40)[0].tolist()
        assert got == want, prompt


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spec_engine_sampled_requests(layout):
    """Sampled requests commit by the rejection scheme: right lengths,
    tokens in range, reproducible per seed across fresh engines, seeds
    diverge, and a greedy request in flight beside them keeps the plain
    engine's tokens."""
    # the unscaled init: flat enough that two seeds' samples part
    params = to_torch(jax_params(JCFG, seed=0))
    plain = engine(layout, slots=2, chunk=2, params=params)
    try:
        greedy_want = plain.submit([3, 5, 7], 10, timeout=WAIT)
    finally:
        plain.shutdown()

    def run():
        eng = engine(layout, slots=3, chunk=2, draft=(DCFG, DPARAMS),
                     params=params)
        try:
            out = {}

            def sampled(seed):
                out[seed] = eng.submit([1, 2], 10, temperature=0.9,
                                       seed=seed, timeout=WAIT)
            threads = [threading.Thread(target=sampled, args=(s,))
                       for s in (11, 12)]
            for t in threads:
                t.start()
            out["g"] = eng.submit([3, 5, 7], 10, timeout=WAIT)
            for t in threads:
                t.join(WAIT)
            st = eng.stats()
        finally:
            eng.shutdown()
        return out, st

    a, st = run()
    b, _ = run()
    assert a == b                              # reproducible per seed
    assert a[11] != a[12]                      # seeds diverge
    assert a["g"] == greedy_want               # greedy parity in the mix
    for s in (11, 12):
        assert len(a[s]) == 10 and all(0 <= t < 128 for t in a[s])
    assert 0.0 <= st["spec_accept_rate"] <= 1.0


def test_spec_engine_follows_the_jax_engine():
    """Same weights and requests: the port's paged speculative engine
    follows the JAX paged speculative engine's greedy tokens, up to a
    reference near-tie."""
    steps = 6
    reqs = [(p, steps) for p, _ in REQS]
    jeng = JaxEngine(JCFG, JPARAMS, kv_layout="paged", slots=4, chunk=3,
                     max_len=40, page_size=8,
                     draft=(JDCFG, jax_params(JDCFG, seed=9)))
    try:
        want = [jeng.submit(p, s, timeout=WAIT) for p, s in reqs]
    finally:
        jeng.shutdown()
    spec = engine("paged", draft=(DCFG, DPARAMS))
    try:
        got = serve_all(spec, reqs)
    finally:
        spec.shutdown()
    prompt, lengths, table = ragged_case([p for p, _ in reqs], steps, 8, 40)
    _, want_lg = jax_stream(JCFG, JPARAMS, prompt, lengths, table, steps,
                            page_size=8, total_pages=40,
                            forced=np.asarray(want, np.int32))
    agreed = [assert_greedy_agrees(w, want_lg[:, b], g)
              for b, (w, g) in enumerate(zip(want, got))]
    assert sum(agreed) >= len(reqs) * steps // 2


@pytest.mark.parametrize("layout", LAYOUTS)
def test_logit_bias_bans_in_every_mode(layout):
    """A -1e9 ban is never emitted (greedy, sampled, speculative greedy
    and sampled), the biased greedy answer differs from the unbiased one,
    and the speculative engine keeps the plain engine's tokens under the
    bias."""
    plain = engine(layout, slots=2, chunk=2)
    try:
        ref = plain.submit([3, 5, 7], 10, timeout=WAIT)
    finally:
        plain.shutdown()
    bias = {ref[0]: -1e9}
    outs = {}
    for name, kw in (("plain", {}), ("spec", dict(draft=(DCFG, DPARAMS)))):
        eng = engine(layout, slots=2, chunk=2, logit_bias=bias, **kw)
        try:
            outs[name] = eng.submit([3, 5, 7], 10, timeout=WAIT)
            outs[name + " sampled"] = eng.submit(
                [3, 5, 7], 10, temperature=0.9, seed=4, timeout=WAIT)
        finally:
            eng.shutdown()
    for name, toks in outs.items():
        assert ref[0] not in toks, name
    assert outs["plain"] != ref
    assert outs["spec"] == outs["plain"]


def test_engine_config_refusals():
    """What the reference's speculative engine refuses, the port refuses
    (tests/test_continuous.py
    test_speculative_engine_rejects_prefix_and_bad_configs), and a
    request reserves the chunk's overshoot."""
    spec = engine("slab", slots=2, chunk=2, draft=(DCFG, DPARAMS))
    try:
        with pytest.raises(ValueError, match="prefix"):
            spec.submit([1, 2], 2, prefix_id="abc")
        with pytest.raises(ValueError, match="speculative overshoot 2"):
            spec.submit([1] * 30, 9)               # 30 + 9 + 2 > 40
        assert len(spec.submit([1] * 30, 8, timeout=WAIT)) == 8
    finally:
        spec.shutdown()
    for layout in LAYOUTS:
        with pytest.raises(ValueError, match="chunk >= 2"):
            engine(layout, chunk=1, draft=(DCFG, DPARAMS))
        bad = cfg_pair(**dict(ENGINE_CFG, vocab=64))[1]
        with pytest.raises(ValueError, match="vocab"):
            engine(layout, draft=(bad, DPARAMS))
        with pytest.raises(ValueError, match="logit_bias token ids"):
            engine(layout, logit_bias={128: 1.0})


# -------------------------------------------------------------------------
# Serving and bench surfaces
# -------------------------------------------------------------------------


def test_serve_speculative_engine_over_http():
    import json
    import urllib.request

    from tpu_dra_torch.workloads.serve import serve
    srv = serve(TCFG, PARAMS, port=0, slots=2, chunk=3, page_size=8,
                kv_layout="paged", draft=(TCFG, PARAMS),
                speculative_engine=True, logit_bias={1: -1e9},
                device="cpu")
    try:
        host, port = srv.server_address[:2]
        req = urllib.request.Request(
            f"http://{host}:{port}/generate",
            data=json.dumps({"tokens": [[3, 5, 7], [2, 4]],
                             "steps": 6}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            out = json.loads(resp.read())["tokens"]
        with urllib.request.urlopen(f"http://{host}:{port}/stats",
                                    timeout=WAIT) as resp:
            st = json.loads(resp.read())
    finally:
        srv.shutdown()
    assert [len(r) for r in out] == [6, 6]
    assert all(1 not in r for r in out)
    assert st["spec_accept_rate"] == 1.0 and st["spec_target_passes"] >= 1
    with pytest.raises(ValueError, match="draft"):
        serve(TCFG, PARAMS, port=0, speculative_engine=True, device="cpu")


@pytest.mark.parametrize("argv,match", [
    (["--auto-draft-cache", "/nonexistent", "--draft-params-npz", "d.npz",
      "--speculative-continuous"], "pick one draft source"),
    (["--draft-checkpoint-dir", "/nonexistent", "--speculative-continuous",
      "--vocab", "64", "--d-model", "32", "--n-heads", "2", "--n-layers",
      "1", "--d-ff", "64"], "no checkpoints under /nonexistent"),
    (["--speculative-continuous"], "needs a draft"),
    # a draft without --speculative-continuous arms /speculative: the
    # flags pass, and the missing file is what is refused
    (["--draft-params-npz", "/nonexistent.npz"], "No such file"),
    (["--logit-bias", "1=2"], "id:val"),
], ids=["draft-cache", "draft-checkpoint", "no-draft", "no-spec",
        "bias"])
def test_serve_flags_refuse(argv, match, capsys):
    from tpu_dra_torch.workloads.serve import main
    with pytest.raises(SystemExit):
        main(["--continuous", "--init-seed", "0", "--device", "cpu"] + argv)
    assert match in capsys.readouterr().err


def test_build_auto_draft_takes_the_serving_form():
    from tpu_dra_torch.workloads.serve import build_auto_draft
    dcfg, dparams = build_auto_draft(TD, TDP, form="int8", steps=2, batch=2)
    assert dcfg.n_layers == 1
    assert set(dparams["blocks"]["wqkv"]) >= {"q8"}


def test_spec_load_serves_the_mixed_load():
    eng = engine("paged", draft=(TCFG, PARAMS))
    try:
        out = bench.spec_load(eng, n_req=5, lengths=[2, 5], steps=[3, 6],
                              timeout=WAIT)
    finally:
        eng.shutdown()
    assert "errors" not in out and out["tokens_per_s"] > 0
    assert out["accept_rate"] == 1.0 and out["tokens_per_pass"] > 1.0


@pytest.mark.parametrize("source", ["auto-draft", "draft-npz"])
def test_cli_serves_speculatively(tmp_path, source):
    """``python -m tpu_dra_torch.workloads.serve --continuous
    --speculative-continuous`` with ``--auto-draft`` (distilled at
    startup from the npz's fp32 tree, then int8) or ``--draft-params-npz``
    (a draft of its own, dimensions from ``--draft-*``): the answers equal
    the plain int8 engine's, and /stats counts speculative passes."""
    import json
    import re
    import subprocess
    import sys
    import urllib.request
    from pathlib import Path

    from tpu_dra_torch.convert import save_npz
    from tpu_dra_torch.workloads.quant import quantize_params_int8
    save_npz(tmp_path / "w.npz", PARAMS)
    cmd = [sys.executable, "-m", "tpu_dra_torch.workloads.serve",
           "--continuous", "--speculative-continuous",
           "--params-npz", str(tmp_path / "w.npz"), "--weights", "int8",
           "--device", "cpu", "--port", "0", "--host", "127.0.0.1",
           "--vocab", "128", "--d-model", "64", "--n-heads", "4",
           "--n-kv-heads", "2", "--n-layers", "2", "--d-ff", "128",
           "--max-seq", "64", "--slots", "2", "--chunk", "3",
           "--kv-layout", "paged", "--page-size", "8"]
    if source == "auto-draft":
        cmd += ["--auto-draft", "--auto-draft-steps", "2"]
    else:
        save_npz(tmp_path / "d.npz", DPARAMS)
        cmd += ["--draft-params-npz", str(tmp_path / "d.npz"),
                "--draft-d-model", "32", "--draft-n-heads", "2",
                "--draft-n-kv-heads", "1", "--draft-n-layers", "1",
                "--draft-d-ff", "64"]
    proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent.parent,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        line = ""
        while "serving on" not in line:
            line = proc.stdout.readline()
            assert line, "the server exited before serving"
        base = f"http://127.0.0.1:{re.search(r', (\d+)\)', line).group(1)}"
        req = urllib.request.Request(
            f"{base}/generate", headers={"Content-Type": "application/json"},
            data=json.dumps({"tokens": [[3, 1, 4], [1, 5]],
                             "steps": 7}).encode())
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            got = json.loads(resp.read())["tokens"]
        with urllib.request.urlopen(f"{base}/stats", timeout=WAIT) as resp:
            st = json.loads(resp.read())
    finally:
        proc.terminate()
        rc = proc.wait(timeout=60)
    assert rc == 0 and st["spec_target_passes"] >= 2
    plain = engine("paged", params=quantize_params_int8(PARAMS), slots=2)
    try:
        want = [plain.submit(p, 7, timeout=WAIT) for p in ([3, 1, 4], [1, 5])]
    finally:
        plain.shutdown()
    assert got == want
