"""GPipe on a ``mesh.ProcessMesh``, one process a rank: groups of 4 gloo
processes on the CPU (tests/torch_process_child.py's ``pipe`` mode,
started by ``launcher.run_local_group``) on dp 1 × pp 4 and dp 2 × pp 2
take one ``make_pipeline_train_step`` step at lr 1, with the dense and
the chunked head, from this process's shards of the same parameters;
the gathered new tree is held to the reference's step on host devices
and to the port's virtual mesh, and the replicated leaves hold the same
bits on every process.  The same children run, one step each, the
strategies that once refused a process mesh.

Tolerances, those of tests/test_torch_pipeline.py: the loss within 5e-3
and every leaf's update within 3% relative L2.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from torch_parity import CPU, cfg_pair, f32, jax_params, to_torch
from torch_process_child import PORTED_LAST, flat_tree

from tpu_dra.workloads import pipeline as jpipe
from tpu_dra_torch.convert import save_npz
from tpu_dra_torch.workloads import pipeline as tpipe
from tpu_dra_torch.workloads.launcher import run_local_group
from tpu_dra_torch.workloads.mesh import Mesh

LOSS_ATOL = 5e-3
LEAF_REL = 3e-2
CHILD = Path(__file__).resolve().parent / "torch_process_child.py"
REPO = CHILD.parent.parent
WAIT = 240
TINY = dict(vocab=32, d_model=32, n_heads=2, n_layers=4, d_ff=64,
            max_seq=16)
N_MICRO = 2
HEADS = ("dense", "chunked")
MESHES = {"pp4": {"dp": 1, "pp": 4}, "dp2xpp2": {"dp": 2, "pp": 2}}
REPLICATED = ("embed", "ln_f", "pos", "unembed")


def tokens():
    return np.random.default_rng(1).integers(0, 32, (8, 16), dtype=np.int32)


def params_pair():
    jcfg, tcfg = cfg_pair(**TINY)
    jp = jax_params(jcfg)
    return jcfg, tcfg, jp, to_torch(jp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh's children: per rank, its JSON and its arrays."""
    _, tcfg, _, tp = params_pair()
    out = {}
    for name, axes in MESHES.items():
        d = tmp_path_factory.mktemp(name)
        save_npz(d / "params.npz", tp)
        np.savez(d / "tokens.npz", tokens=tokens())
        (d / "pipe_cases.json").write_text(json.dumps([
            dict(name=head, cfg=dataclasses.asdict(tcfg),
                 params="params.npz", tokens="tokens.npz", head=head,
                 n_micro=N_MICRO) for head in HEADS]))
        run_local_group([sys.executable, str(CHILD), "pipe", str(d),
                         json.dumps(axes), "cpu"], 4, timeout=WAIT,
                        cwd=str(REPO),
                        env=dict(os.environ, PYTHONPATH=str(REPO)))
        ranks = []
        for r in range(4):
            with np.load(d / f"rank{r}.npz") as data:
                arrays = {k: data[k] for k in data.files}
            ranks.append((json.loads((d / f"rank{r}.json").read_text()),
                          arrays))
        out[name] = ranks
    return out


def rel(got, want) -> float:
    got, want = f32(got), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def hold(arrays: dict, head: str, loss, new: dict, old: dict) -> None:
    """The loss within LOSS_ATOL, each leaf's update (old − new) within
    LEAF_REL relative L2 of the wanted one."""
    assert abs(float(arrays[f"{head}_loss"]) - float(loss)) < LOSS_ATOL
    for k, o in old.items():
        got = f32(o) - arrays[f"{head}/{k}"]
        want = f32(o) - f32(new[k])
        assert rel(got, want) < LEAF_REL, (k, rel(got, want))


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_process_pipeline_step_matches_the_reference(runs, mesh, head):
    """Every process's gathered new tree and loss against the reference's
    ``make_pipeline_train_step`` on a host-device mesh of the same axes."""
    jcfg, _, jp, tp = params_pair()
    axes = MESHES[mesh]
    devs = np.array(jax.devices()[:4]).reshape(tuple(axes.values()))
    jstep, jps, jts = jpipe.make_pipeline_train_step(
        jcfg, JMesh(devs, tuple(axes)), n_micro=N_MICRO, lr=1.0,
        head_impl=head)
    jnew, jloss = jstep(jax.device_put(jp, jps),
                        jax.device_put(jnp.asarray(tokens()), jts))
    new = flat_tree(jax.tree.map(np.asarray, jnew))
    for _, arrays in runs[mesh]:
        hold(arrays, head, jloss, new, flat_tree(tp))


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_process_pipeline_step_matches_the_virtual_mesh(runs, mesh, head):
    _, tcfg, _, tp = params_pair()
    step, _, _ = tpipe.make_pipeline_train_step(
        tcfg, Mesh(MESHES[mesh], device=CPU), n_micro=N_MICRO, lr=1.0,
        head_impl=head)
    new, loss = step(tp, torch.from_numpy(tokens()))
    for _, arrays in runs[mesh]:
        hold(arrays, head, loss, flat_tree(new), flat_tree(tp))


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_process_pipeline_replicated_leaves_are_the_same_bits(runs, mesh,
                                                              head):
    """Every process ends with the same bits in each replicated leaf and
    the same loss; a stage's block shards are the same on every dp
    group."""
    ranks = runs[mesh]
    first = ranks[0][1]
    pp = MESHES[mesh]["pp"]
    for info, arrays in ranks:
        np.testing.assert_array_equal(arrays[f"{head}_loss"],
                                      first[f"{head}_loss"])
        for k in arrays:
            if k.startswith(f"{head}_local/") and \
                    k.split("/")[1] in REPLICATED:
                np.testing.assert_array_equal(arrays[k], first[k])
        twin = ranks[info["coords"]["pp"]][1]
        for k in arrays:
            if k.startswith(f"{head}_local/blocks/"):
                np.testing.assert_array_equal(arrays[k], twin[k])
    assert sum(k.startswith(f"{head}_local/") and k.split("/")[1]
               in REPLICATED for k in first) >= 2
    assert pp == len({info["coords"]["pp"] for info, _ in ranks})


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_process_pipeline_holds_its_stage_slice(runs, mesh):
    """A process holds layers s·L/pp .. (s+1)·L/pp − 1 of the stacked
    blocks (its shard of the gathered tree) and the replicated leaves
    whole; the specs are ``pipeline_param_specs`` and ("dp", None)."""
    _, tcfg, _, _ = params_pair()
    pp = MESHES[mesh]["pp"]
    per = TINY["n_layers"] // pp
    want_specs = flat_tree(tpipe.pipeline_param_specs(tcfg))
    for info, arrays in runs[mesh]:
        s = info["coords"]["pp"]
        specs, t_spec = info["specs"]["dense"]
        assert {k: tuple(v) for k, v in specs.items()} == want_specs
        assert t_spec == ["dp", None]
        for k in arrays:
            if not k.startswith("dense_local/"):
                continue
            whole = arrays["dense/" + k.split("/", 1)[1]]
            if "/blocks/" in k:
                np.testing.assert_array_equal(
                    arrays[k], whole[s * per:(s + 1) * per])
            else:
                np.testing.assert_array_equal(arrays[k], whole)


@pytest.mark.parametrize("what", PORTED_LAST)
def test_remaining_strategies_still_refuse_a_process_mesh(runs, what):
    """None of the strategies that once refused a process mesh refuses it
    now: EP, LoRA, ``serving_param_shardings``, the MoE
    AdamW step and ``fit`` of a ``MoEConfig`` each ran (a finite loss, or
    the serving tree gathered back byte-equal) on every process of both
    meshes, on a mesh of the same dp whose other axis is "ep" or "tp"."""
    for name in MESHES:
        for info, _ in runs[name]:
            assert info["strategies"][what] == "ran", \
                info["strategies"][what]
