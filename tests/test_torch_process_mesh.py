"""A mesh whose ranks are processes (``mesh.ProcessMesh``) and the DP×SP
ring step on it, one process a rank: 2 and 4 gloo processes on the CPU
(tests/torch_process_child.py, started by ``launcher.run_local_group``)
cut and gather tensors, refuse what the process mesh does not run yet,
and take one ``make_ring_train_step`` step at lr 1 on dp 1 × sp 2 and
dp 2 × sp 2, held to the virtual mesh's step and to the reference's
``make_ring_train_step`` on host devices on the same parameters and
window.

Tolerances, as tests/test_torch_ring_attention.py holds the virtual
step: the loss within 5e-3, every leaf's update within 3% relative L2
(chip_smoke.py's STEP_LOSS_ATOL and STEP_LEAF_REL).  Every process ends
with the same bits, and on the CPU the two hops (the plain versions of
the shift kernel and of the send and receive) give bit-equal steps.
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
from torch_process_child import (ATTN_CASES, LR, STEPS, STILL_REFUSED,
                                 attn_inputs)

from tpu_dra.workloads import ring_attention as jra
from tpu_dra_torch.convert import save_npz
from tpu_dra_torch.workloads import flash as tf
from tpu_dra_torch.workloads import ring_attention as tra
from tpu_dra_torch.workloads import train as tt
from tpu_dra_torch.workloads.launcher import run_local_group
from tpu_dra_torch.workloads.mesh import Mesh

LOSS_ATOL = 5e-3
LEAF_REL = 3e-2
CHILD = Path(__file__).resolve().parent / "torch_process_child.py"
REPO = CHILD.parent.parent
WAIT = 300
RING_CFG = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                max_seq=32)
MESHES = {"dp1xsp2": {"dp": 1, "sp": 2}, "dp2xsp2": {"dp": 2, "sp": 2}}
# the strategies that still run on the virtual mesh only (the ring
# attention makers, zigzag and GPipe run on a process mesh:
# tests/test_torch_process_attention.py, test_torch_process_pipeline.py)
REFUSED = STILL_REFUSED


def window():
    toks = np.random.default_rng(3).integers(0, 64, (4, 32)).astype(
        np.int32)
    return toks, np.roll(toks, -1, axis=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh's children: per rank, the JSON of its checks and its
    steps' losses and leaves."""
    jcfg, tcfg = cfg_pair(**RING_CFG)
    params = to_torch(jax_params(jcfg))
    toks, tgts = window()
    out = {}
    for name, axes in MESHES.items():
        d = tmp_path_factory.mktemp(name)
        save_npz(d / "params.npz", params)
        np.savez(d / "tokens.npz", tokens=toks, targets=tgts)
        (d / "cfg.json").write_text(json.dumps(dataclasses.asdict(tcfg)))
        n = int(np.prod(list(axes.values())))
        run_local_group([sys.executable, str(CHILD), "mesh", str(d),
                         json.dumps(axes)], n, timeout=WAIT, cwd=str(REPO),
                        env=dict(os.environ, PYTHONPATH=str(REPO)))
        ranks = []
        for r in range(n):
            with np.load(d / f"rank{r}.npz") as data:
                arrays = {k: data[k] for k in data.files}
            ranks.append((json.loads((d / f"rank{r}.json").read_text()),
                          arrays))
        out[name] = ranks
    return out


def leaves_of(arrays: dict, tag: str) -> list:
    n = len([k for k in arrays if k.startswith(f"{tag}_leaf")])
    return [arrays[f"{tag}_leaf{i}"] for i in range(n)]


def hold(loss, leaves, want_loss, want_leaves, p0):
    """The loss within LOSS_ATOL, each leaf's update (p0 − new) within
    LEAF_REL relative L2 of the wanted update."""
    assert abs(float(loss) - float(want_loss)) < LOSS_ATOL
    for a, got, want in zip(p0, leaves, want_leaves):
        gw = f32(a) - f32(want)
        gg = f32(a) - np.asarray(got, np.float32)
        assert np.linalg.norm(gg - gw) / np.linalg.norm(gw) < LEAF_REL


@pytest.mark.parametrize("name", sorted(MESHES))
def test_process_mesh_shard_and_unshard_round_trip(runs, name):
    axes = MESHES[name]
    for r, (info, _) in enumerate(runs[name]):
        assert info["coords"] == {"dp": r // axes["sp"], "sp": r % axes["sp"]}
        assert info["round_trips"] == [True] * 4
        dp, sp = axes["dp"], axes["sp"]
        assert info["shard_shapes"] == [[4 // dp, 8 // sp, 12],
                                        [4, 8 // sp, 12],
                                        [4, 8, 12 // (dp * sp)], [4, 8, 12]]
        assert info["spec"] == ["dp", "sp"]


@pytest.mark.parametrize("name", sorted(MESHES))
def test_process_mesh_refuses_what_it_does_not_run_yet(runs, name):
    """Every other strategy raises NotImplementedError naming ROADMAP.md,
    and without CUDA a process mesh refuses unless given the CPU."""
    for info, _ in runs[name]:
        assert sorted(info["refusals"]) == sorted(REFUSED)
        for what, said in info["refusals"].items():
            assert what in said and "ROADMAP.md" in said, said
        assert "CUDA" in info["no_cuda"] and "device='cpu'" in \
            info["no_cuda"]


@pytest.mark.parametrize("name", sorted(MESHES))
def test_process_step_is_the_same_on_every_process(runs, name):
    """Every process ends with the same loss and parameters, and the
    shift kernel's plain version gives the send and receive's bits."""
    ranks = runs[name]
    for tag in (f"{a}_{b}" for a, b in STEPS):
        for _, arrays in ranks[1:]:
            for k in arrays:
                if k.startswith(tag):
                    np.testing.assert_array_equal(arrays[k], ranks[0][1][k])
    first = ranks[0][1]
    for k in first:
        if k.startswith("flash_pallas"):
            np.testing.assert_array_equal(
                first[k], first[k.replace("flash_pallas", "flash_xla")])
    for info, _ in ranks:
        assert info["launches"] == [0, 0]       # the CPU launches nothing


@pytest.mark.parametrize("step", [f"{a}_{b}" for a, b in STEPS])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_process_step_matches_the_virtual_step(runs, name, step):
    _, tcfg = cfg_pair(**RING_CFG)
    params = to_torch(jax_params(tt.ModelConfig(**RING_CFG)))
    toks, tgts = window()
    ring_impl, hop_impl = step.split("_")
    vstep, _ = tra.make_ring_train_step(
        tcfg, Mesh(MESHES[name], device=CPU), lr=LR, ring_impl=ring_impl,
        hop_impl=hop_impl)
    want, want_loss = vstep(params, torch.from_numpy(toks),
                            torch.from_numpy(tgts))
    arrays = runs[name][0][1]
    hold(arrays[f"{step}_loss"], leaves_of(arrays, step), want_loss,
         tt.tree_leaves(want), tt.tree_leaves(params))


@pytest.mark.parametrize("step", [f"{a}_{b}" for a, b in STEPS])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_process_step_matches_the_reference(runs, name, step):
    """The reference's ``make_ring_train_step`` on a host-device mesh of
    the same axes (which carries the mesh's rank count over the gradient
    of the mean loss; so does the process step)."""
    jcfg, _ = cfg_pair(**RING_CFG)
    params = jax_params(jcfg)
    toks, tgts = window()
    axes = MESHES[name]
    devs = np.array(jax.devices()[:int(np.prod(list(axes.values())))])
    jm = JMesh(devs.reshape(tuple(axes.values())), tuple(axes))
    ring_impl, hop_impl = step.split("_")
    jstep, sh = jra.make_ring_train_step(jcfg, jm, lr=LR,
                                         ring_impl=ring_impl,
                                         hop_impl=hop_impl)
    want, want_loss = jstep(params, jax.device_put(jnp.asarray(toks), sh),
                            jax.device_put(jnp.asarray(tgts), sh))
    arrays = runs[name][0][1]
    hold(arrays[f"{step}_loss"], leaves_of(arrays, step), want_loss,
         jax.tree.leaves(want), tt.tree_leaves(to_torch(params)))


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=[f"{e}-{h}-kv{kv}" for e, h, kv in ATTN_CASES])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_process_ring_attention_matches_the_virtual_engine(runs, name, case):
    """Each process's ``ring_attention_group`` /
    ``ring_attention_flash_group`` output and its q, k, v gradients (of
    the sum of every rank's output: each rank's k and v cotangents come
    back through the reverse shifts) against its shard of the virtual
    mesh's engine over the global q, k, v, MHA and GQA, within
    ``flash.ELEM_TOL``."""
    engine, hop_impl, kv = case
    axes = MESHES[name]
    make = tra.make_ring_attention_flash if engine == "flash" else \
        tra.make_ring_attention
    qkv = [t.clone().requires_grad_() for t in attn_inputs(kv)]
    out = make(Mesh(axes, device=CPU), hop_impl=hop_impl)(*qkv)
    grads = torch.autograd.grad(out.float().sum(), qkv)
    tag = f"attn_{engine}_{hop_impl}_kv{kv}"
    for r, (_, arrays) in enumerate(runs[name]):
        d, s_ = divmod(r, axes["sp"])
        b, t = 4 // axes["dp"], 16 // axes["sp"]

        def cut(x):
            return f32(x[d * b:(d + 1) * b, :, s_ * t:(s_ + 1) * t])
        for key, want in ((tag, out), *((f"{tag}_d{n}", g)
                                        for n, g in zip("qkv", grads))):
            got, w = arrays[key], cut(want)
            bound = tf.ELEM_TOL + tf.ELEM_TOL * np.abs(w)
            assert np.all(np.abs(got - w) <= bound), \
                (key, float((np.abs(got - w) / bound).max()))
