"""The multi-chip dry run one process a rank, and what it brought across
processes: ``entry.dryrun_multichip(n, device="cpu", processes=True)``
(its n gloo ranks started by ``launcher.run_local_group``), the packed
loss on a dp 2 × tp 2 ``mesh.ProcessMesh`` and the multislice meshes
(tests/torch_process_child.py's ``slices`` mode, one group of four).

The dry run's last line is ``MULTICHIP_REPORT {json}`` with the
reference's seven strategy names, its mesh and no MFU on the CPU; every
lane asserts inside the ranks what the reference asserts (speculative
tokens equal to greedy ones, ZeRO-1 bit-equal to replicated moments).
``train.packed_loss_fn(..., mesh=)`` is held within ``PACK_LOSS_ATOL`` of
the reference's on the same packed rows, as the one-device port's is,
and within ``PACK_PORT_ATOL`` of the one-device port's, which rows that
drop the documents' positions or segments miss;
``make_sharded_train_step`` on ``collectives.make_multislice_mesh(...,
processes=True)`` ("dcn", "dp", "tp") and ``make_ring_train_step`` on ("dcn", "dp", "sp") take one lr-1
step each, held to the reference's on host devices of the same axes:
the loss within 5e-3 and each leaf's update within 3% relative L2, the
tolerances of the other process tests.  Each axis of a three-axis mesh
sums over its own line of ranks.
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
import torch
from jax.sharding import Mesh as JMesh

from test_torch_dryrun import reference_strategies
from torch_parity import cfg_pair, f32, jax_params, to_numpy_tree
from torch_process_child import flat_tree

from tpu_dra.workloads import collectives as jcoll
from tpu_dra.workloads import ring_attention as jra
from tpu_dra.workloads import train as jt
from tpu_dra.workloads.data import pack_documents
from tpu_dra_torch.convert import save_npz
from tpu_dra_torch.entry import dryrun_multichip
from tpu_dra_torch.workloads.launcher import run_local_group

# the packed loss against the reference's: tests/test_torch_packing.py's
# LOSS_ATOL, which holds the one-device port's packed loss (on these rows
# the one-device port's lies 1.4e-4 to 6.5e-4 from the reference's, so
# chip_smoke.py's PACK_LOSS_ATOL of 1e-4, packed against isolated
# documents on one card, would fail the one-device port too)
PACK_LOSS_ATOL = 5e-3
# the packed loss against the one-device port's on the same fp32 weights
# and rows, where only the summation order of the bf16 trunk differs: the
# process loss lay 1.53e-4 to 9.52e-4 from it, and the controls'
# (control_rows) 2.95e-3 to 1.33e-1, so the limit sits between the two
PACK_PORT_ATOL = 1.5e-3
LOSS_ATOL = 5e-3
LEAF_REL = 3e-2
CHILD = Path(__file__).resolve().parent / "torch_process_child.py"
REPO = CHILD.parent.parent
WAIT = 300
BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=32)
# name: (config, head_impl)
PACKED = {"learned": (BASE, "dense"),
          "rope-gqa": (dict(BASE, n_kv_heads=2, pos_emb="rope"), "dense"),
          "tied": (dict(BASE, tied_embeddings=True), "dense"),
          "chunked": (BASE, "chunked")}
MS_IMPLS = ("dense", "fused_collective")
RING_IMPLS = ("xla", "flash")
RING_CFG = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                max_seq=32)
MS_AXES = {"dcn": 2, "dp": 1, "tp": 2}
MSP_AXES = {"dcn": 2, "dp": 1, "sp": 2}


def packed_rows() -> tuple:
    """``data.pack_documents`` of documents of 3-20 tokens into rows of
    33, the first 4 rows (tokens, segment ids, positions)."""
    rng = np.random.default_rng(11)
    docs = [rng.integers(1, 64, n) for n in rng.integers(3, 21, 12)]
    return tuple(a[:4] for a in pack_documents(docs, seq=33))


def control_rows(control: str) -> tuple:
    """:func:`packed_rows` with one of the packing's two facts dropped, as
    a packed loss that ignored it would see them: ``"positions"`` the
    row's positions in place of each document's, ``"segments"`` every
    document of a row in one segment (no block-diagonal mask, and the
    loss taken across the boundaries too)."""
    toks, segs, pos = packed_rows()
    if control == "positions":
        return toks, segs, np.broadcast_to(
            np.arange(pos.shape[1], dtype=pos.dtype), pos.shape).copy()
    return toks, (segs > 0).astype(segs.dtype), pos


PACK_CONTROLS = ("positions", "segments")
# (case, control) pairs whose loss a packed loss that ignored the fact
# would change: rope is relative, so within a document's block of the
# mask the row's positions rotate q and k alike and give its loss (the
# rope-gqa case's lay 3.1e-5 from the one-device port's)
CONTROL_CASES = [(name, c) for name in sorted(PACKED) for c in PACK_CONTROLS
                 if c == "segments"
                 or PACKED[name][0].get("pos_emb", "learned") == "learned"]


def windows() -> dict:
    rng = np.random.default_rng(12)
    ring = rng.integers(0, 64, (4, 32)).astype(np.int32)
    return {"tokens": rng.integers(0, 64, (4, 33)).astype(np.int32),
            "ring_tokens": ring, "ring_targets": np.roll(ring, -1, axis=1)}


@lru_cache(maxsize=None)
def init(kw: str):
    """(reference config, reference params) of a config given as JSON."""
    jcfg, _ = cfg_pair(**json.loads(kw))
    return jcfg, jax_params(jcfg)


def key(cfg: dict) -> str:
    return json.dumps(cfg, sort_keys=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per rank: the child's JSON and its saved arrays."""
    d = tmp_path_factory.mktemp("slices")
    files = {}

    def npz(cfg: dict) -> str:
        if key(cfg) not in files:
            files[key(cfg)] = f"p{len(files)}.npz"
            save_npz(d / files[key(cfg)], to_numpy_tree(init(key(cfg))[1]))
        return files[key(cfg)]

    spec = {"packed": [{"name": n, "cfg": c, "params": npz(c), "head": h}
                       for n, (c, h) in PACKED.items()],
            "ms_cfg": BASE, "ms_params": npz(BASE), "ms_impls": MS_IMPLS,
            "ring_cfg": RING_CFG, "ring_params": npz(RING_CFG),
            "ring_impls": RING_IMPLS}
    (d / "slices.json").write_text(json.dumps(spec))
    sets = dict({"packed": packed_rows()},
                **{c: control_rows(c) for c in PACK_CONTROLS})
    np.savez(d / "packed.npz", **{
        f"{name}/{what}": a for name, rows in sets.items()
        for what, a in zip(("tokens", "segments", "positions"), rows)})
    np.savez(d / "window.npz", **windows())
    run_local_group([sys.executable, str(CHILD), "slices", str(d), "cpu"],
                    4, timeout=WAIT, cwd=str(REPO),
                    env=dict(os.environ, PYTHONPATH=str(REPO)))
    ranks = []
    for r in range(4):
        with np.load(d / f"rank{r}.npz") as data:
            arrays = {k: data[k] for k in data.files}
        ranks.append((json.loads((d / f"rank{r}.json").read_text()), arrays))
    return ranks


@pytest.mark.parametrize("n", [2, 4])
def test_process_dryrun_reports_the_reference_strategies(n, capsys):
    report, launches = dryrun_multichip(n, device="cpu", processes=True,
                                        return_launches=True)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("MULTICHIP_REPORT ")
    printed = json.loads(lines[-1][len("MULTICHIP_REPORT "):])
    assert printed == json.loads(json.dumps(report))
    assert set(printed["strategies"]) == reference_strategies()
    assert printed["n_devices"] == n and printed["platform"] == "cpu"
    assert printed["mesh"] == {"dp": 1, "tp": n}
    for entry in printed["strategies"].values():
        assert entry["step_ms"] > 0 and entry["tflops"] > 0
        assert "mfu_pct" not in entry
    # the ranks' DRYRUN_LAUNCHES lines summed: no kernel runs on the CPU
    counted = [json.loads(ln[len("DRYRUN_LAUNCHES "):]) for ln in lines
               if ln.startswith("DRYRUN_LAUNCHES ")]
    assert sorted(c.pop("rank") for c in counted) == list(range(n))
    assert launches == {k: 0 for k in counted[0]}


def test_process_dryrun_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(2, processes=True)


@pytest.mark.parametrize("name", sorted(PACKED))
def test_process_packed_loss_matches_the_reference(runs, name):
    cfg, head = PACKED[name]
    jcfg, jp = init(key(cfg))
    toks, segs, pos = (jnp.asarray(a) for a in packed_rows())
    want = float(jt.packed_loss_fn(jcfg, jp, toks, segs, pos,
                                   head_impl=head))
    for _, arrays in runs:
        got = float(arrays[f"packed/{name}/packed"])
        assert abs(got - want) <= PACK_LOSS_ATOL, (got, want)


@lru_cache(maxsize=None)
def one_device_packed(name: str) -> float:
    """The one-device port's packed loss of a case, on the reference's
    fp32 weights and :func:`packed_rows`."""
    from torch_parity import to_torch
    from tpu_dra_torch.workloads.train import ModelConfig, packed_loss_fn
    cfg, head = PACKED[name]
    rows = (torch.from_numpy(a) for a in packed_rows())
    return float(packed_loss_fn(ModelConfig(**cfg),
                                to_torch(init(key(cfg))[1]), *rows,
                                head_impl=head))


@pytest.mark.parametrize("name", sorted(PACKED))
def test_process_packed_loss_matches_the_one_device_port(runs, name):
    """Within PACK_PORT_ATOL of the one-device port's loss on the same
    weights and rows."""
    want = one_device_packed(name)
    for _, arrays in runs:
        got = float(arrays[f"packed/{name}/packed"])
        assert abs(got - want) <= PACK_PORT_ATOL, (got, want)


@pytest.mark.parametrize("name,control", CONTROL_CASES)
def test_packed_loss_controls_fail_the_one_device_limit(runs, name,
                                                         control):
    """The process loss of rows that drop the documents' positions or
    their segments lies more than PACK_PORT_ATOL from the one-device
    port's loss of the packed rows: the limit tells a packed loss that
    ignored either from the right one."""
    want = one_device_packed(name)
    for _, arrays in runs:
        got = float(arrays[f"packed/{name}/{control}"])
        assert abs(got - want) > PACK_PORT_ATOL, (got, want)


def hold(arrays: dict, tag: str, want_loss, want: dict, p0: dict) -> None:
    """The loss within LOSS_ATOL, each leaf's update (p0 − new) within
    LEAF_REL relative L2 of the wanted update."""
    assert abs(float(arrays[f"{tag}_loss"]) - float(want_loss)) < LOSS_ATOL
    new = {k[len(tag) + 1:]: v for k, v in arrays.items()
           if k.startswith(tag + "/")}
    assert sorted(new) == sorted(want)
    for leaf in want:
        gw, gg = p0[leaf] - want[leaf], p0[leaf] - new[leaf]
        rel = np.linalg.norm(gg - gw) / np.linalg.norm(gw)
        assert rel < LEAF_REL, (leaf, rel)


def jmesh(axes: dict):
    devs = np.array(jax.devices()[:4]).reshape(tuple(axes.values()))
    return JMesh(devs, tuple(axes))


def flat(tree) -> dict:
    return {k: f32(v).copy() for k, v in flat_tree(tree).items()}


@pytest.mark.parametrize("impl", MS_IMPLS)
def test_process_multislice_step_matches_the_reference(runs, impl):
    """One lr-1 DP×TP step on ("dcn", "dp", "tp") = (2, 1, 2), the batch
    cut over ("dcn", "dp"), against the reference's
    ``make_multislice_mesh`` mesh on host devices."""
    jcfg, jp = init(key(BASE))
    jm = jcoll.make_multislice_mesh(2, jax.devices()[:4], tp=2)
    assert dict(zip(jm.axis_names, jm.devices.shape)) == MS_AXES
    step, p_shard, b_shard = jt.make_sharded_train_step(jcfg, jm, lr=1.0)
    new, loss = step(jax.device_put(jp, p_shard),
                     jax.device_put(jnp.asarray(windows()["tokens"]),
                                    b_shard))
    for _, arrays in runs:
        hold(arrays, f"ms-{impl}", loss, flat(new), flat(jp))


@pytest.mark.parametrize("engine", RING_IMPLS)
def test_process_multislice_ring_step_matches_the_reference(runs, engine):
    """One lr-1 ring step on ("dcn", "dp", "sp") = (2, 1, 2) against the
    reference's on host devices of the same axes."""
    jcfg, jp = init(key(RING_CFG))
    w = windows()
    jstep, sh = jra.make_ring_train_step(jcfg, jmesh(MSP_AXES), lr=1.0,
                                         ring_impl=engine)
    new, loss = jstep(jp, jax.device_put(jnp.asarray(w["ring_tokens"]), sh),
                      jax.device_put(jnp.asarray(w["ring_targets"]), sh))
    for _, arrays in runs:
        hold(arrays, f"msp-{engine}", loss, flat(new), flat(jp))


@pytest.mark.parametrize("name,axes", [("ms", MS_AXES), ("msp", MSP_AXES)])
def test_three_axis_process_mesh_lines(runs, name, axes):
    """Group rank r sits at the row-major coordinates of r over the three
    axes, and each axis's psum of the group rank sums the ranks that
    differ from r only on that axis (so every process built every line
    in the same order)."""
    names = list(axes)
    for r, (info, _) in enumerate(runs):
        coords = np.unravel_index(r, tuple(axes.values()))
        assert info[name]["coords"] == dict(zip(names, map(int, coords)))
        for i, a in enumerate(names):
            line = []
            for c in range(axes[a]):
                at = list(coords)
                at[i] = c
                line.append(int(np.ravel_multi_index(at, tuple(
                    axes.values()))))
            assert info[name]["psums"][a] == float(sum(line)), (a, r)
