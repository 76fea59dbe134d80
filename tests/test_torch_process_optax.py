"""The AdamW step and ``fit`` across processes:
``train.make_optax_train_step`` and ``fit.fit`` on a ``mesh.ProcessMesh``
of dp 2 × tp 2, one gloo process a rank on the CPU
(tests/torch_process_child.py's ``optax`` mode, one group of four
started by ``launcher.run_local_group`` for every case), each process
holding its own shards of the parameters and of the moments.

Each AdamW case (both ``matmul_impl``, ``zero1`` False and True, 3 steps
of the default optimizer from the same numpy parameters and windows) is
held to the reference's ``make_optax_train_step`` on a host-device mesh
of the same axes and to the port's virtual ``Mesh`` step: the loss
within 5e-3 every step and each leaf's first moment after step 1 within
3% relative L2.  The first moment is (1 − b1) times the clipped
gradient; the update itself is not held, since AdamW's first step moves
each element by about ±lr, so a gradient that departs by a little flips
the sign of the near-zero elements' updates.  Bit-equality is asked
where the arithmetic is the same: ZeRO-1 against replicated moments on
the process mesh, and a resumed ``fit`` against the uninterrupted run.
Also: label smoothing with z-loss on the dense head, untied and tied
(losses within 5e-3); the chunked head, untied and tied, through one SGD
step (``make_sharded_train_step``, the loss within 5e-3 and each leaf's
update within 3%); the clip's norm from the shards; the moment bytes a
rank holds; the ring wrappers' calls; and ``fit``'s checkpoints read by
a virtual-mesh run and the other way round, within 5e-3.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from torch_parity import CPU, cfg_pair, f32, jax_params, to_torch
from torch_process_child import flat_tree
from test_torch_fit import motif_corpus

from tpu_dra.workloads import train as jt
from tpu_dra_torch.convert import save_npz
from tpu_dra_torch.workloads import fit as tfit
from tpu_dra_torch.workloads import train as tt
from tpu_dra_torch.workloads.checkpointing import restore_train_state
from tpu_dra_torch.workloads.launcher import run_local_group
from tpu_dra_torch.workloads.mesh import Mesh

LOSS_ATOL = 5e-3
LEAF_REL = 3e-2
CHILD = Path(__file__).resolve().parent / "torch_process_child.py"
REPO = CHILD.parent.parent
WAIT = 300
AXES = {"dp": 2, "tp": 2}
BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=32)
TIED = {"tied_embeddings": True}
STEPS = 3
# name: (config beyond BASE, kind, matmul_impl, attn_impl, zero1, head,
# label smoothing, z-loss, steps)
CASES = {
    "dense": ({}, "optax", "dense", "dense", False, "dense", 0.0, 0.0, 3),
    "dense-zero1": ({}, "optax", "dense", "dense", True, "dense", 0.0, 0.0,
                    3),
    "fused": ({}, "optax", "fused_collective", "flash", False, "dense", 0.0,
              0.0, 3),
    "fused-zero1": ({}, "optax", "fused_collective", "flash", True, "dense",
                    0.0, 0.0, 3),
    "smooth-z-untied": ({}, "optax", "fused_collective", "dense", False,
                        "dense", 0.1, 1e-4, 2),
    "smooth-z-tied": (TIED, "optax", "dense", "flash", True, "dense", 0.1,
                      1e-4, 2),
    **{f"chunked-{t}-{impl}": (TIED if t == "tied" else {}, "sgd",
                               "fused_collective" if impl == "fused"
                               else "dense", "dense", False, "chunked",
                               0.0, 0.0, 1)
       for t in ("untied", "tied") for impl in ("dense", "fused")},
}
OPTAX = sorted(k for k, v in CASES.items() if v[1] == "optax")
CHUNKED = sorted(k for k, v in CASES.items() if v[1] == "sgd")
FIT_CFG = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
               max_seq=16)


def case_cfg(name: str) -> dict:
    return dict(BASE, **CASES[name][0])


def windows() -> np.ndarray:
    """``[STEPS, 4, 33]``: one window batch a step."""
    return np.random.default_rng(21).integers(0, 64, (STEPS, 4, 33)).astype(
        np.int32)


def jmesh():
    devs = np.array(jax.devices()[:4])
    return JMesh(devs.reshape(tuple(AXES.values())), tuple(AXES))


def flat(tree) -> dict:
    """fp32 copies of a tree's leaves (an optimizer updates its moments
    in place)."""
    return {k: f32(v).copy() for k, v in flat_tree(tree).items()}


def vfit(data: str, **kw):
    """``fit`` of FIT_CFG on the virtual mesh of the same axes."""
    return tfit.fit(tt.ModelConfig(**FIT_CFG), data, batch=2, log_every=1,
                    mesh=Mesh(AXES, device=CPU), log_fn=lambda s: None,
                    **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per rank: the child's JSON and its saved arrays; and the directory
    holding the run's checkpoints."""
    d = tmp_path_factory.mktemp("optax")
    cases = []
    for name, (extra, kind, impl, attn, zero1, head, ls, z,
               steps) in CASES.items():
        jcfg, _ = cfg_pair(**case_cfg(name))
        tag = "tied" if extra else "untied"
        if not (d / f"{tag}.npz").exists():
            save_npz(d / f"{tag}.npz", to_torch(jax_params(jcfg)))
        cases.append({"name": name, "cfg": case_cfg(name), "kind": kind,
                      "params": f"{tag}.npz", "tokens": "tokens.npz",
                      "impl": impl, "attn": attn, "zero1": zero1,
                      "head": head, "ls": ls, "z": z, "steps": steps,
                      "norm": name in ("dense", "fused")})
    np.savez(d / "tokens.npz", tokens=windows())
    (d / "optax_cases.json").write_text(json.dumps(cases))
    data = motif_corpus(d / "t.bin", n=4000)
    virtual_losses = vfit(data, steps=6, zero1=True).losses
    vfit(data, steps=3, zero1=True, checkpoint_dir=str(d / "vck"),
         checkpoint_every=3)
    (d / "fit.json").write_text(json.dumps({"cfg": FIT_CFG, "data": data}))
    run_local_group([sys.executable, str(CHILD), "optax", str(d),
                     json.dumps(AXES), "cpu"], 4, timeout=WAIT,
                    cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO)))
    ranks = []
    for r in range(4):
        with np.load(d / f"rank{r}.npz") as npz:
            arrays = {k: npz[k] for k in npz.files}
        ranks.append((json.loads((d / f"rank{r}.json").read_text()), arrays))
    return {"ranks": ranks, "dir": d, "data": data,
            "virtual": virtual_losses}


def leaves(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def rel(got, want) -> float:
    return float(np.linalg.norm(f32(got) - f32(want))
                 / np.linalg.norm(f32(want)))


def hold(name: str, arrays: dict, losses, mu1: dict | None) -> None:
    """The process run's losses within LOSS_ATOL of ``losses`` every
    step, and each leaf's first moment after step 1 within LEAF_REL."""
    got = arrays[f"{name}_loss"]
    assert len(got) == len(losses)
    assert np.max(np.abs(got - np.asarray(losses))) < LOSS_ATOL, \
        (got, losses)
    if mu1 is None:
        return
    mine = leaves(arrays, f"{name}_mu1/")
    assert sorted(mine) == sorted(mu1)
    for leaf, want in mu1.items():
        assert rel(mine[leaf], want) < LEAF_REL, (leaf, rel(mine[leaf],
                                                            want))


@lru_cache(maxsize=None)
def reference(name: str) -> tuple:
    """The reference's ``make_optax_train_step`` on host devices of the
    same axes: the losses and the first moment after step 1 (its optax
    chain state's ``mu``)."""
    _, _, impl, attn, zero1, head, ls, z, steps = CASES[name]
    jcfg, _ = cfg_pair(**case_cfg(name))
    jstep, jinit, jps, jbs = jt.make_optax_train_step(
        jcfg, jmesh(), attn_impl=attn, head_impl=head, label_smoothing=ls,
        z_loss=z, zero1=zero1, matmul_impl=impl)
    params = jax.device_put(jax_params(jcfg), jps)
    opt = jinit(params)
    losses, mu1 = [], None
    for i in range(steps):
        params, opt, loss = jstep(params, opt, jax.device_put(
            jnp.asarray(windows()[i]), jbs))
        losses.append(float(loss))
        if i == 0:
            mu1 = flat(opt[1][0].mu)
    return losses, mu1


@lru_cache(maxsize=None)
def virtual(name: str) -> tuple:
    """The port's ``make_optax_train_step`` on the virtual mesh: the
    losses and the first moment after step 1."""
    _, _, impl, attn, zero1, head, ls, z, steps = CASES[name]
    jcfg, tcfg = cfg_pair(**case_cfg(name))
    step, init, _, _ = tt.make_optax_train_step(
        tcfg, Mesh(AXES, device=CPU), attn_impl=attn, head_impl=head,
        label_smoothing=ls, z_loss=z, zero1=zero1, matmul_impl=impl)
    params = to_torch(jax_params(jcfg))
    opt = init(params)
    losses, mu1 = [], None
    for i in range(steps):
        params, opt, loss = step(params, opt, torch.from_numpy(windows()[i]))
        losses.append(float(loss))
        if i == 0:
            mu1 = flat(opt.to_dict()["mu"])
    return losses, mu1


@pytest.mark.parametrize("name", OPTAX)
def test_optax_step_matches_the_reference(runs, name):
    losses, mu1 = reference(name)
    hold(name, runs["ranks"][0][1], losses, mu1)


@pytest.mark.parametrize("name", OPTAX)
def test_optax_step_matches_the_virtual_step(runs, name):
    losses, mu1 = virtual(name)
    hold(name, runs["ranks"][0][1], losses, mu1)


@pytest.mark.parametrize("impl", ["dense", "fused"])
def test_zero1_is_bit_equal_to_replicated_on_the_process_mesh(runs, impl):
    """After 3 steps: the losses, the gathered parameters and the
    gathered mu and nu of ZeRO-1 hold the replicated run's bits, on
    every process."""
    for _, arrays in runs["ranks"]:
        for prefix in ("_loss", "/", "_mu/", "_nu/", "_mu1/"):
            a = {k: v for k, v in arrays.items()
                 if k.startswith(impl + prefix)}
            assert a
            for k, v in a.items():
                np.testing.assert_array_equal(
                    arrays[k.replace(impl, f"{impl}-zero1", 1)], v,
                    err_msg=k)


@pytest.mark.parametrize("name", OPTAX)
def test_moment_bytes_are_what_a_rank_holds(runs, name):
    """``opt_state_bytes_per_rank`` equals the bytes of the moment shards
    each process holds; ZeRO-1 holds half the replicated layout's on dp
    2 (every leaf has a dimension dp divides)."""
    for info, _ in runs["ranks"]:
        held, said = info["cases"][name]["bytes"]
        assert held == said
        if name in ("dense-zero1", "fused-zero1"):
            plain = info["cases"][name.replace("-zero1", "")]["bytes"][0]
            assert 2 * held == plain


@pytest.mark.parametrize("name", ["dense", "fused"])
def test_clip_norm_counts_each_element_once(runs, name):
    """The clip's squared norm from the shards (the tp-cut leaves' sums
    gathered over tp, the leaves whole over tp once) is the gathered
    gradient tree's, within fp32 summation, and the same bits on every
    process."""
    said = [info["cases"][name]["norm"] for info, _ in runs["ranks"]]
    for shards, whole in said:
        assert abs(shards - whole) <= 1e-5 * whole, (shards, whole)
        assert shards == said[0][0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_wrappers_run_on_the_fused_path_only(runs, name):
    """4·L calls of each process ring wrapper a step on the fused path,
    none on the dense one; no kernel launch on the CPU."""
    _, _, impl, *_, steps = CASES[name]
    for info, _ in runs["ranks"]:
        got = info["cases"][name]
        want = 4 * BASE["n_layers"] * steps if impl != "dense" else 0
        assert got["calls"] == [want, want]
        assert got["launches"] == [0, 0]


@pytest.mark.parametrize("name", CHUNKED)
def test_chunked_head_matches_the_reference(runs, name):
    """One SGD step at lr 1 through the chunked head (each rank's vocab
    shard streamed, or the tied head's chunk partials psummed) against
    the reference's ``make_sharded_train_step(head_impl="chunked")``: the
    loss within LOSS_ATOL, each leaf's update within LEAF_REL."""
    _, _, impl, attn, *_ = CASES[name]
    jcfg, _ = cfg_pair(**case_cfg(name))
    jstep, jps, jbs = jt.make_sharded_train_step(
        jcfg, jmesh(), lr=1.0, attn_impl=attn, head_impl="chunked",
        matmul_impl=impl)
    params = jax_params(jcfg)
    want, want_loss = jstep(jax.device_put(params, jps), jax.device_put(
        jnp.asarray(windows()[0]), jbs))
    arrays = runs["ranks"][0][1]
    assert abs(float(arrays[f"{name}_loss"][0]) - float(want_loss)) \
        < LOSS_ATOL
    p0, new = flat(params), leaves(arrays, f"{name}/")
    for leaf, w in flat(want).items():
        assert rel(p0[leaf] - new[leaf], p0[leaf] - w) < LEAF_REL, leaf


def test_chunked_head_with_label_smoothing_raises():
    """As on one device, the chunked head takes no label smoothing or
    z-loss (``process_train.make_process_grads`` refuses before any
    collective)."""
    from tpu_dra_torch.workloads.process_train import make_process_grads
    for kw in ({"label_smoothing": 0.1}, {"z_loss": 1e-4}):
        with pytest.raises(NotImplementedError, match="dense head"):
            make_process_grads(tt.ModelConfig(**BASE), None, "dense",
                               "chunked", 1, "dense", "dense", **kw)


@pytest.mark.parametrize("key", ["_loss", "/", "_mu/", "_nu/"])
def test_every_process_ends_with_the_same_bits(runs, key):
    """Every case's losses and gathered trees are the same bits on every
    process."""
    first = runs["ranks"][0][1]
    for _, arrays in runs["ranks"][1:]:
        for name in CASES:
            for k, v in first.items():
                if k.startswith(name + key):
                    np.testing.assert_array_equal(arrays[k], v, err_msg=k)


def test_fit_zero1_equals_replicated_and_resumes_bit_for_bit(runs):
    """``fit`` on the process mesh: ZeRO-1's losses equal the replicated
    run's; a run saved at 3 and resumed for 3 gives the uninterrupted
    losses, and its step-6 parameters and moments, bit for bit."""
    for info, arrays in runs["ranks"]:
        assert arrays["fit_zero1"].tolist() == arrays["fit_plain"].tolist()
        assert arrays["fit_resumed"].tolist() == \
            arrays["fit_zero1"][3:].tolist()
        assert info["fit"]["resumed_step"] == 6
    want = restore_train_state(str(runs["dir"] / "ck-full"), device=CPU)
    got = restore_train_state(str(runs["dir"] / "ck"), device=CPU)
    assert want["extra"]["step"] == got["extra"]["step"] == 6
    for key in ("mu", "nu"):
        for a, b in zip(tt.tree_leaves(want["extra"]["opt_state"][key]),
                        tt.tree_leaves(got["extra"]["opt_state"][key])):
            assert a.shape == b.shape and torch.equal(a, b)
    for a, b in zip(tt.tree_leaves(want["params"]),
                    tt.tree_leaves(got["params"])):
        assert torch.equal(a, b)


def test_virtual_mesh_fit_resumes_the_process_checkpoint(runs, tmp_path):
    """A one-process ``fit`` on the virtual mesh resumes the process
    run's step-3 checkpoint for 3 steps within LOSS_ATOL of the process
    run's own steps 4-6."""
    ck = tmp_path / "ck3"
    shutil.copytree(runs["dir"] / "ck3", ck)
    got = vfit(runs["data"], steps=3, zero1=True, checkpoint_dir=str(ck),
               resume=True)
    want = runs["ranks"][0][1]["fit_zero1"][3:]
    assert got.step == 6
    assert np.max(np.abs(np.array(got.losses) - want)) < LOSS_ATOL


def test_process_fit_resumes_the_virtual_checkpoint(runs):
    """The process run resumed the virtual mesh's step-3 checkpoint for 3
    steps within LOSS_ATOL of the virtual run's uninterrupted steps
    4-6."""
    want = np.array(runs["virtual"][3:])
    for _, arrays in runs["ranks"]:
        assert np.max(np.abs(arrays["fit_crossed"] - want)) < LOSS_ATOL


def test_process_checkpoint_is_a_one_process_tree(runs):
    """The process run's checkpoint holds the tree, shapes and dtypes of
    a one-process run's: the global parameters and moments, the count
    and the step."""
    got = restore_train_state(str(runs["dir"] / "ck3"), device=CPU)
    want = restore_train_state(str(runs["dir"] / "vck"), step=3, device=CPU)
    assert flat_tree(got).keys() == flat_tree(want).keys()
    for k, v in flat_tree(want).items():
        g = flat_tree(got)[k]
        if torch.is_tensor(v):
            assert g.shape == v.shape and g.dtype == v.dtype, k
        else:
            assert g == v, k


def test_fit_refuses_a_moe_config_on_a_process_mesh(runs):
    """``fit`` of a ``MoEConfig`` no longer refuses a process mesh: on
    the same four processes as dp 2 × ep 2 it ran a step to a finite
    loss, the same on every process."""
    said = [info["fit"]["moe"] for info, _ in runs["ranks"]]
    for ran, loss, step in said:
        assert ran == "ran" and np.isfinite(loss) and step == 1
        assert loss == said[0][1]
