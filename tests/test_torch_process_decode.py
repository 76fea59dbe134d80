"""Tensor-parallel decoding across processes: ``decode.greedy_decode``,
``paged_kv.paged_greedy_decode``, ``decode.beam_decode`` and
``decode.speculative_decode`` with ``mesh=`` a ``mesh.ProcessMesh`` of
dp 1 × tp 4 and dp 2 × tp 2, one gloo process a rank on the CPU
(tests/torch_process_child.py's ``decode`` mode, one group of four
started by ``launcher.run_local_group``).  Each process holds its serving
shards (``process_decode.local_tree``) of tests/test_torch_decode.py's
tiny configs, bf16, int8 and int4, the same numpy weights as the
reference's through ``convert.py``, and beam search on
tests/test_torch_beam.py's vocab-8 config with 4 heads; at tp 4 the 2 kv
heads do not split over the 4 ranks, and each rank holds a copy of the
one its q head reads.

Each decoder is held to the reference's own on the same prompt: greedy
and paged tokens equal (the paged reference on its gather path, as its
tests run it off the TPU), except for a row that parts where the
reference's top-2 margin lies within ``argmax_tol`` (a bf16 near-tie),
and no more such rows than the port's one-device decoders show; the
first step's logits within twice ``logit_tol`` of the top logit (tensor
parallelism adds its psums' summation order to the one-device path's
bf16 roundings); speculative tokens equal to the tensor-parallel greedy
ones.  Beams, at seeds 0-2, bf16, int8, int4, with eos and a length
penalty, and tied: the one-device port's beams (the same hypotheses,
scores within ``TP_SCORE_TOL``), and the reference's hypotheses with
scores within test_torch_beam.py's ``SCORE_TOL``, or a row that leaves
the reference's beams where the candidate it takes lies within
``SCORE_TOL`` of the reference's cut (:func:`beam_gaps`).  Every process
returns the same global tokens, and holds 1/tp of each leaf its spec
cuts over "tp".  A decoder given a virtual mesh raises.
"""

from __future__ import annotations

import json
import os
import sys
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_beam import SCORE_TOL
from test_torch_decode import jax_forced_logits
from torch_parity import (argmax_tol, cfg_pair, jax_params, logit_tol,
                          ragged_case, to_numpy_tree, top2_margin)

from tpu_dra.workloads import decode as jd
from tpu_dra.workloads import paged_kv as jpk
from tpu_dra.workloads import quant as jq
from tpu_dra_torch.convert import save_npz
from tpu_dra_torch.workloads.launcher import run_local_group

CHILD = Path(__file__).resolve().parent / "torch_process_child.py"
REPO = CHILD.parent.parent
WAIT = 300
MESHES = {"tp4": {"dp": 1, "tp": 4}, "dp2xtp2": {"dp": 2, "tp": 2}}
# tests/test_torch_decode.py's configs: rope GQA (4 heads over 2), and
# its learned-position MHA variant, untied and tied
GQA = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_seq=32, pos_emb="rope")
MHA = dict(GQA, pos_emb="learned", n_kv_heads=None)
TIED = dict(MHA, tied_embeddings=True)
# beam search: tests/test_torch_beam.py's vocab-8 config with 4 heads over
# 2 (so that they split over tp 4), rope, untied and tied, at seeds 0-2
BEAM = dict(vocab=8, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
            d_ff=64, max_seq=32, pos_emb="rope")
BEAM_TIED = dict(BEAM, tied_embeddings=True)
BEAM_SEEDS = (0, 1, 2)
# the tensor-parallel beams against the one-device port's on the same
# tree: the scores lay within 9.6e-7 of each other on every case (only
# fp32 summation orders differ)
TP_SCORE_TOL = 1e-4
# on these fixtures the one-device port's own beams lie within SCORE_TOL
# of the reference's but for int8 at seeds 0 and 1 (a row leaving at a
# candidate 0.118 below the reference's cut, scores 0.085 apart) and
# tied at seeds 0-2 (scores 0.070-0.156 apart): the gelu's rounding and
# the reference's compiled roundings, which tests/test_torch_beam.py's
# gap tests pin (with both matched the beams are equal)
# beam form: (config, serving form, int4 group, finishing options)
BEAM_FORMS = {"bf16": (BEAM, "bf16", 0, {}),
              "int8": (BEAM, "int8", 0, {}),
              "int4": (BEAM, "int4", 16, {}),
              "eos": (BEAM, "bf16", 0, {"eos_id": 3, "length_penalty": 0.6}),
              "tied": (BEAM_TIED, "bf16", 0, {})}
# name: (config, serving form, int4 group, cache dtype, seed)
CASES = {"gqa-bf16": (GQA, "bf16", 0, "bf16", 0),
         "gqa-int8": (GQA, "int8", 0, "bf16", 0),
         "gqa-int4": (GQA, "int4", 16, "bf16", 0),
         "gqa-int8-cache": (GQA, "bf16", 0, "int8", 0),
         "mha-bf16": (MHA, "bf16", 0, "bf16", 0),
         "tied-bf16": (TIED, "bf16", 0, "bf16", 0)}
CASES.update({f"beam-{form}-s{seed}": (cfg, q, group, "bf16", seed)
              for form, (cfg, q, group, _) in BEAM_FORMS.items()
              for seed in BEAM_SEEDS})
# beam search's finishing options, by case
BEAM_KW = {name: BEAM_FORMS[name.split("-")[1]][3] for name in CASES
           if name.startswith("beam-")}
DECODED = [c for c in CASES if c not in BEAM_KW]
BEAMED = list(BEAM_KW)
RUN = dict(steps=8, max_len=20, beams=3, beam_steps=4, k=3, page_size=8,
           total_pages=12, ties_w=5)
PROMPT_SHAPE = (4, 6)


def ties() -> np.ndarray:
    """Rows of 16 logits whose maxima and top-5 values recur in several
    of the tp ranks' column blocks (and one row all equal): the global
    argmax and top-w must take the lower global index first."""
    rows = np.random.default_rng(9).integers(0, 4, (6, 16)).astype(
        np.float32)
    rows[-1] = 1.0
    return rows


def prompt(vocab: int = 64) -> np.ndarray:
    """The prompt of the cases of a ``vocab``-token config."""
    return np.random.default_rng(6).integers(0, vocab, PROMPT_SHAPE,
                                             dtype=np.int32)


def table() -> np.ndarray:
    rows = [list(r) for r in prompt()]
    return ragged_case(rows, RUN["steps"], RUN["page_size"],
                       RUN["total_pages"])[2]


def tag(cfg: dict) -> str:
    return {id(GQA): "gqa", id(MHA): "mha", id(TIED): "tied",
            id(BEAM): "beam", id(BEAM_TIED): "beam-tied"}[id(cfg)]


def init(cfg: dict, seed: int):
    """The reference's init of a case's config (a tied model's embedding
    spread, as tests/torch_parity.py's ``jax_params`` allows)."""
    jcfg, _ = cfg_pair(**cfg)
    return jcfg, jax_params(jcfg, seed=seed,
                            embed_scale=4.0 if cfg.get("tied_embeddings")
                            else 1.0)


@lru_cache(maxsize=None)
def jtree(name: str):
    """(reference config, the reference's serving tree of the case)."""
    cfg, form, group, _, seed = CASES[name]
    jcfg, jp = init(cfg, seed)
    if form == "int8":
        return jcfg, jq.quantize_params_int8(jp)
    if form == "int4":
        return jcfg, jq.quantize_params_int4(jp, group)
    return jcfg, jq.cast_params_bf16(jp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per rank: the child's JSON and its saved arrays."""
    d = tmp_path_factory.mktemp("decode")
    cases = []
    for name, (cfg, form, group, cache, seed) in CASES.items():
        path = d / f"{tag(cfg)}-s{seed}.npz"
        if not path.exists():
            save_npz(path, to_numpy_tree(init(cfg, seed)[1]))
        cases.append({"name": name, "cfg": cfg, "params": path.name,
                      "form": form, "group": group, "cache": cache,
                      "beam": name in BEAM_KW,
                      "beam_kw": BEAM_KW.get(name, {})})
    (d / "decode_cases.json").write_text(json.dumps(
        {"cases": cases, "run": RUN}))
    np.savez(d / "decode_inputs.npz", prompt=prompt(),
             beam_prompt=prompt(BEAM["vocab"]), table=table(),
             ties=ties())
    run_local_group([sys.executable, str(CHILD), "decode", str(d),
                     json.dumps(list(MESHES.values())), "cpu"],
                    4, timeout=WAIT, cwd=str(REPO),
                    env=dict(os.environ, PYTHONPATH=str(REPO)))
    ranks = []
    for r in range(4):
        with np.load(d / f"rank{r}.npz") as npz:
            arrays = {k: npz[k] for k in npz.files}
        ranks.append((json.loads((d / f"rank{r}.json").read_text()), arrays))
    return ranks


@lru_cache(maxsize=None)
def reference(name: str) -> dict:
    """The reference's greedy tokens, their logits step by step and its
    paged tokens (gather path), or its beams (a beam case)."""
    jcfg, jp = jtree(name)
    cache = CASES[name][3]
    p = jnp.asarray(prompt())
    kw = dict(max_len=RUN["max_len"], cache_dtype=cache)
    if name in BEAMED:
        hist, scores = jd.beam_decode(jcfg, jp,
                                      jnp.asarray(prompt(BEAM["vocab"])),
                                      steps=RUN["beam_steps"],
                                      beams=RUN["beams"], **kw,
                                      **BEAM_KW.get(name, {}))
        return {"beam": (np.asarray(hist), np.asarray(scores))}
    greedy = np.asarray(jd.greedy_decode(jcfg, jp, p, steps=RUN["steps"],
                                         **kw))
    logits = jax_forced_logits(jcfg, jp, prompt(), greedy, **kw)
    paged = np.asarray(jpk.paged_greedy_decode(
        jcfg, jp, p, jnp.asarray(table()), steps=RUN["steps"],
        total_pages=RUN["total_pages"], page_size=RUN["page_size"],
        cache_dtype=cache, interpret=True))
    return {"greedy": greedy, "logits": logits, "paged": paged}


def departures(want: np.ndarray, logits: np.ndarray, got: np.ndarray) -> int:
    """Rows of ``got`` that part from ``want`` (each row's step-by-step
    reference logits in ``logits`` ``[steps, B, V]``); each must part at
    a near-tie under ``argmax_tol``."""
    n = 0
    for b in range(want.shape[0]):
        diff = np.flatnonzero(want[b] != got[b])
        if diff.size:
            lg = logits[diff[0], b]
            assert top2_margin(lg) <= argmax_tol(lg), (b, int(diff[0]))
            n += 1
    return n


def mine(runs, mesh: str, name: str, what: str) -> np.ndarray:
    """What every rank returned (the same global array on each)."""
    key = f"{'x'.join(f'{k}{v}' for k, v in MESHES[mesh].items())}/{name}"
    first = runs[0][1][f"{key}/{what}"]
    for _, arrays in runs[1:]:
        np.testing.assert_array_equal(arrays[f"{key}/{what}"], first)
    return first


def cases(names=DECODED):
    return [pytest.param(m, c, id=f"{m}-{c}") for m in MESHES for c in names]


@lru_cache(maxsize=None)
def one_device(name: str) -> dict:
    """The port's one-device greedy and paged tokens of the case."""
    import torch

    from torch_parity import to_torch
    from tpu_dra_torch.workloads import decode as td
    from tpu_dra_torch.workloads import paged_kv as tpk
    from tpu_dra_torch.workloads.train import ModelConfig
    cfg, tree = ModelConfig(**CASES[name][0]), to_torch(jtree(name)[1])
    p, cache = torch.from_numpy(prompt()), CASES[name][3]
    return {"greedy": td.greedy_decode(
                cfg, tree, p, steps=RUN["steps"], max_len=RUN["max_len"],
                cache_dtype=cache).numpy(),
            "paged": tpk.paged_greedy_decode(
                cfg, tree, p, torch.from_numpy(table()), steps=RUN["steps"],
                total_pages=RUN["total_pages"], page_size=RUN["page_size"],
                cache_dtype=cache).numpy()}


@pytest.mark.parametrize("what", ["greedy", "paged"])
@pytest.mark.parametrize("mesh,name", cases())
def test_process_decode_matches_the_reference(runs, mesh, name, what):
    """Every row equal to the reference's, or parting at a near-tie; and
    no more rows part than the port's one-device decoder's (on these
    fixtures one row, of gqa-int8's greedy and mha-bf16's paged decode,
    parts at a near-tie on one device and tensor-parallel alike)."""
    want = reference(name)
    got = mine(runs, mesh, name, what)
    assert got.shape == want[what].shape
    n = departures(want[what], want["logits"], got)
    assert n <= departures(want[what], want["logits"],
                           one_device(name)[what]), n


@pytest.mark.parametrize("mesh,name", cases())
def test_process_first_logits_match_the_reference(runs, mesh, name):
    """The first step's global logits within twice ``logit_tol`` of the
    reference's top logit."""
    want = reference(name)["logits"][0]
    got = mine(runs, mesh, name, "logits")
    assert got.shape == want.shape
    tol = 2 * logit_tol(np.abs(want).max())
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


@lru_cache(maxsize=None)
def reference_steps(name: str) -> tuple:
    """The reference's beams after each step ``i`` (``beam_decode`` of
    ``i + 1`` steps): per step the ``[B, W, i + 1]`` tokens and the raw
    ``[B, W]`` scores (no length penalty: only the finish reads it)."""
    jcfg, jp = jtree(name)
    kw = dict(BEAM_KW[name], length_penalty=0.0)
    out = []
    for i in range(RUN["beam_steps"]):
        hist, scores = jd.beam_decode(
            jcfg, jp, jnp.asarray(prompt(BEAM["vocab"])), steps=i + 1,
            beams=RUN["beams"], max_len=RUN["max_len"], **kw)
        out.append((np.asarray(hist), np.asarray(scores)))
    return tuple(out)


def candidate_score(name: str, b: int, prefix: tuple, parent: float) -> float:
    """The reference's score of the candidate ``prefix`` of row ``b``:
    its parent's score plus the log-probability of its last token after
    the prompt and the tokens before it (after an eos only eos
    continues, at 0)."""
    eos = BEAM_KW[name].get("eos_id")
    if eos is not None and eos in prefix[:-1]:
        return parent if prefix[-1] == eos else -1e30
    jcfg, jp = jtree(name)
    logits = jax_forced_logits(jcfg, jp, prompt(BEAM["vocab"])[b:b + 1],
                               np.array([prefix], np.int32),
                               max_len=RUN["max_len"], cache_dtype="bf16")
    logp = jax.nn.log_softmax(jnp.asarray(logits[-1, 0], jnp.float32))
    return parent + float(logp[prefix[-1]])


def beam_gaps(name: str, got: tuple) -> dict:
    """How far beams ``got`` (``[B, W, steps]`` tokens, ``[B, W]``
    scores) lie from the reference's, per row: a row with the reference's
    hypotheses gives its worst score gap (and half the reference's gap
    between two hypotheses it swapped); a row that leaves the reference's
    beams (``parted``) gives, at the first step where a hypothesis'
    prefix is not among the reference's beams, how far below the lowest
    score the reference kept the reference scores that candidate."""
    (wh, ws), (gh, gs) = reference(name)["beam"], got
    gaps, parted = [], []
    for b in range(wh.shape[0]):
        ref = {tuple(h): float(s) for h, s in zip(wh[b], ws[b])}
        port = [tuple(h) for h in gh[b]]
        if sorted(port) == sorted(ref):
            gaps.append(max(max(abs(gs[b, w] - ref[h]),
                                (ws[b, w] - ref[h]) / 2)
                            for w, h in enumerate(port)))
            continue
        parted.append(b)
        steps = reference_steps(name)
        for i, (hist, scores) in enumerate(steps):
            kept = {tuple(h): float(sc) for h, sc in zip(hist[b], scores[b])}
            out = [h[:i + 1] for h in port if h[:i + 1] not in kept]
            if out:
                prev = ({(): 0.0} if i == 0 else
                        {tuple(h): float(sc) for h, sc in
                         zip(steps[i - 1][0][b], steps[i - 1][1][b])})
                cut = min(kept.values())
                gaps.append(max(cut - candidate_score(name, b, p,
                                                      prev[p[:-1]])
                                for p in out))
                break
    return {"worst": max(gaps), "parted": parted}


@lru_cache(maxsize=None)
def one_device_beams(name: str) -> tuple:
    """The port's one-device beams of a beam case (tokens, scores)."""
    import torch

    from torch_parity import to_torch
    from tpu_dra_torch.workloads import decode as td
    from tpu_dra_torch.workloads.train import ModelConfig
    hist, scores = td.beam_decode(
        ModelConfig(**CASES[name][0]), to_torch(jtree(name)[1]),
        torch.from_numpy(prompt(BEAM["vocab"])), steps=RUN["beam_steps"],
        beams=RUN["beams"], max_len=RUN["max_len"], **BEAM_KW[name])
    return hist.numpy(), scores.numpy()


@lru_cache(maxsize=None)
def one_device_gaps(name: str) -> dict:
    return beam_gaps(name, one_device_beams(name))


@pytest.mark.parametrize("mesh,name", cases(BEAMED))
def test_process_beam_decode_matches_the_one_device_port(runs, mesh, name):
    """The one-device port's beams on the same tree: the same hypotheses
    in the same order, scores within ``TP_SCORE_TOL``."""
    oh, os_ = one_device_beams(name)
    gh = mine(runs, mesh, name, "beam").astype(np.int32)
    gs = mine(runs, mesh, name, "beam_scores")
    np.testing.assert_array_equal(gh, oh)
    assert np.abs(gs - os_).max() <= TP_SCORE_TOL, np.abs(gs - os_).max()


@pytest.mark.parametrize("mesh,name", cases(BEAMED))
def test_process_beam_decode_matches_the_reference(runs, mesh, name):
    """Per row the reference's hypotheses, scores within ``SCORE_TOL``, in
    its order up to swaps of near-tied scores; or a row that leaves the
    reference's beams at a near-tie, within ``SCORE_TOL``
    (:func:`beam_gaps`).  Where the one-device port's own beams lie
    further from the reference's (int8 and tied: the note above
    BEAM_FORMS), no further than they do.  No more rows part than part
    on one device."""
    wh, ws = reference(name)["beam"]
    gh = mine(runs, mesh, name, "beam").astype(np.int32)
    gs = mine(runs, mesh, name, "beam_scores")
    assert gh.shape == wh.shape and gs.shape == ws.shape
    got = beam_gaps(name, (gh, gs))
    one = one_device_gaps(name)
    assert got["worst"] <= max(SCORE_TOL, one["worst"]) + TP_SCORE_TOL, (
        got, one)
    assert len(got["parted"]) <= len(one["parted"]), (got, one)


@pytest.mark.parametrize("mesh,name", cases())
def test_process_speculative_decode_equals_greedy(runs, mesh, name):
    """Greedy acceptance gives the tensor-parallel greedy tokens; a
    one-layer draft takes between steps / k and steps target passes."""
    got = mine(runs, mesh, name, "spec")
    np.testing.assert_array_equal(got, mine(runs, mesh, name, "greedy"))
    key = f"{'x'.join(f'{k}{v}' for k, v in MESHES[mesh].items())}/{name}"
    for info, _ in runs:
        assert -(-RUN["steps"] // RUN["k"]) <= info[key]["passes"] \
            <= RUN["steps"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_process_argmax_and_top_w_break_ties_as_the_reference(runs, mesh):
    """``ProcessMesh.argmax`` over the tp ranks' column blocks is
    ``jnp.argmax`` (the first max), ``top_w`` is ``jax.lax.top_k`` (the
    lower index first among equal values), on every process."""
    x = ties()
    tag = "x".join(f"{k}{v}" for k, v in MESHES[mesh].items())
    vals, idx = jax.lax.top_k(jnp.asarray(x), RUN["ties_w"])
    for _, arrays in runs:
        np.testing.assert_array_equal(arrays[f"{tag}/argmax"],
                                      np.asarray(jnp.argmax(x, axis=-1)))
        np.testing.assert_array_equal(arrays[f"{tag}/top_vals"],
                                      np.asarray(vals))
        np.testing.assert_array_equal(arrays[f"{tag}/top_idx"],
                                      np.asarray(idx))


@pytest.mark.parametrize("mesh,name", cases(list(CASES)))
def test_process_holds_only_its_shards(runs, mesh, name):
    """Each leaf the serving specs cut over "tp" holds 1/tp of its bytes
    in every process; no other leaf holds more than its global bytes."""
    jcfg, jp = jtree(name)
    axes = MESHES[mesh]
    from jax.sharding import Mesh as JMesh
    jm = JMesh(np.array(jax.devices()[:4]).reshape(tuple(axes.values())),
               tuple(axes))
    specs = {k: tuple(v) for k, v in _flat(jax.tree.map(
        lambda s: tuple(s.spec), jq.serving_param_shardings(jcfg, jm, jp),
        is_leaf=lambda x: hasattr(x, "spec"))).items()}
    key = f"{'x'.join(f'{k}{v}' for k, v in axes.items())}/{name}"
    for info, _ in runs:
        held = info[key]["bytes"]
        assert sorted(held) == sorted(specs)
        for leaf, (local, whole) in held.items():
            if "tp" in specs[leaf]:
                assert local * axes["tp"] == whole, (leaf, local, whole)
            else:
                assert local <= whole, (leaf, local, whole)


def _flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("decoder", ["greedy", "paged", "beam",
                                     "speculative"])
def test_decoders_refuse_a_virtual_mesh(decoder):
    """``mesh=`` takes a ProcessMesh or None: a virtual mesh raises."""
    import torch

    from tpu_dra_torch.workloads import decode as td
    from tpu_dra_torch.workloads import paged_kv as tpk
    from tpu_dra_torch.workloads.mesh import Mesh
    from tpu_dra_torch.workloads.train import ModelConfig, init_params
    cfg = ModelConfig(**GQA)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    p = torch.from_numpy(prompt())
    mesh = Mesh({"dp": 1, "tp": 2}, device="cpu")
    calls = {
        "greedy": lambda: td.greedy_decode(cfg, params, p, steps=2,
                                           mesh=mesh),
        "paged": lambda: tpk.paged_greedy_decode(
            cfg, params, p, torch.from_numpy(table()), steps=2,
            total_pages=RUN["total_pages"], page_size=RUN["page_size"],
            mesh=mesh),
        "beam": lambda: td.beam_decode(cfg, params, p, steps=2, beams=2,
                                       mesh=mesh),
        "speculative": lambda: td.speculative_decode(
            cfg, params, cfg, params, p, steps=2, k=2, mesh=mesh)}
    with pytest.raises(TypeError, match="ProcessMesh"):
        calls[decoder]()
