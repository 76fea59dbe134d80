"""Expert parallelism across processes: ``moe.make_moe_train_step``,
``moe.make_moe_optax_step`` and ``fit.fit`` of a ``MoEConfig`` on a
``mesh.ProcessMesh`` of dp 2 × ep 2 and dp 1 × ep 4, one gloo process a
rank on the CPU (tests/torch_process_child.py's ``moe`` mode, one group
of four a mesh, started by ``launcher.run_local_group``), each process
holding its dp rows of the batch and its E/ep experts of each bank.

The SGD step at lr 1 (its update is the gradient), top-1 and top-2, is
held to the reference's ``make_moe_train_step`` on host devices of the
same axes and, with the virtual step's router choices replayed on each
process's rows (``moe.PinnedChoices``), to the port's virtual ``Mesh``
step.  An overloaded router (capacity factor 0.5 on dp 2) shows that
the process claims the global slots: routing a dp shard alone would
dispatch otherwise, and the process's dispatch is the reference's.
The AdamW step (replicated and ZeRO-1, 3 steps) is held to the
reference's ``make_moe_optax_step`` by its first moments; ZeRO-1 and a
resumed ``fit`` are held bit for bit.

Tolerances, those of tests/test_torch_moe.py: the loss within 5e-3,
each leaf within 3% relative L2; the dispatch exactly.
"""

from __future__ import annotations

import dataclasses
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

from torch_parity import CPU, f32, to_numpy_tree
from torch_process_child import flat_tree
from test_torch_fit import motif_corpus
from test_torch_moe import SMALL, ffn_inputs, jax_route

from tpu_dra.workloads import moe as jmoe
from tpu_dra_torch.convert import params_from_numpy, save_npz
from tpu_dra_torch.workloads import fit as tfit
from tpu_dra_torch.workloads import moe as tmoe
from tpu_dra_torch.workloads.checkpointing import restore_train_state
from tpu_dra_torch.workloads.launcher import run_local_group
from tpu_dra_torch.workloads.mesh import Mesh

LOSS_ATOL = 5e-3
LEAF_REL = 3e-2
ROW_REL = 1e-2
AUX_REL = 1e-6
CHILD = Path(__file__).resolve().parent / "torch_process_child.py"
REPO = CHILD.parent.parent
WAIT = 300
MESHES = {"dp2xep2": {"dp": 2, "ep": 2}, "ep4": {"dp": 1, "ep": 4}}
# name: (router_top_k, capacity_factor, attn_impl)
SGD = {"top1": (1, 1.25, "dense"), "top2": (2, 1.25, "dense"),
       "overload": (2, 0.5, "dense"), "flash": (2, 1.25, "flash")}
SGD_ON = {"dp2xep2": ("top1", "top2", "overload", "flash"),
          "ep4": ("top1", "top2")}
OPTAX = ("adamw", "adamw-zero1")
OPTAX_STEPS = 3
ROUTE = dict(SMALL, router_top_k=2, capacity_factor=0.5)
ROUTE_SHAPE = (4, 8)                          # B, S of the routing check
FIT = dict(SMALL, vocab=64, router_top_k=2)


def cfg_of(name: str, **kw) -> dict:
    k, cf, _ = SGD.get(name, (2, 1.25, "dense"))
    return dict(SMALL, router_top_k=k, capacity_factor=cf, **kw)


def pair(cfg: dict) -> tuple:
    jcfg = jmoe.MoEConfig(**cfg)
    return jcfg, tmoe.MoEConfig(**dataclasses.asdict(jcfg))


@lru_cache(maxsize=None)
def jparams(top_k: int):
    return jmoe.init_moe_params(jmoe.MoEConfig(**cfg_of(
        {1: "top1", 2: "top2"}[top_k])), jax.random.PRNGKey(0))


def tparams(top_k: int) -> dict:
    return params_from_numpy(to_numpy_tree(jparams(top_k)), CPU)


def windows() -> np.ndarray:
    """``[OPTAX_STEPS, 4, 17]``: one window batch a step."""
    return np.random.default_rng(1).integers(
        0, SMALL["vocab"], (OPTAX_STEPS, 4, SMALL["max_seq"] + 1),
        dtype=np.int32)


def jmesh(axes: dict):
    devs = np.array(jax.devices()[:4])
    return JMesh(devs.reshape(tuple(axes.values())), tuple(axes))


def flat(tree) -> dict:
    return {k: f32(v).copy() for k, v in flat_tree(tree).items()}


def rel(got, want) -> float:
    return float(np.linalg.norm(f32(got) - f32(want))
                 / np.linalg.norm(f32(want)))


def leaves(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def virtual_sgd(name: str, axes: dict) -> tuple:
    """The virtual mesh's step of case ``name``: (new tree, loss, its
    router choices)."""
    _, tcfg = pair(cfg_of(name))
    step, _, _ = tmoe.make_moe_train_step(tcfg, Mesh(axes, device=CPU),
                                          lr=1.0, attn_impl=SGD[name][2])
    with tmoe.PinnedChoices() as pin:
        new, loss = step(tparams(tcfg.router_top_k),
                         torch.from_numpy(windows()[0]))
    return new, float(loss), pin.recorded


def route_inputs() -> dict:
    B, S = ROUTE_SHAPE
    x, wg, w1, w2 = ffn_inputs(5, B, S, ROUTE["d_model"], ROUTE["d_ff"],
                               ROUTE["n_experts"], gate_scale=1.0)
    return {"x": x, "wg": wg, "w1": w1, "w2": w2}


def vfit(data: str, **kw):
    """``fit`` of FIT on the virtual mesh of dp 2 × ep 2."""
    return tfit.fit(tmoe.MoEConfig(**FIT), data, batch=4, log_every=1,
                    mesh=Mesh(MESHES["dp2xep2"], device=CPU), zero1=True,
                    log_fn=lambda s: None, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh's children (per rank, its JSON and its arrays), the
    virtual steps, the fit directory and the virtual fit's losses."""
    out = {"virtual": {}}
    for mesh_name, axes in MESHES.items():
        d = tmp_path_factory.mktemp(mesh_name)
        np.savez(d / "tokens.npz", tokens=windows())
        for k in (1, 2):
            save_npz(d / f"top{k}.npz", tparams(k))
        cases = []
        for name in SGD_ON[mesh_name]:
            new, loss, recorded = virtual_sgd(name, axes)
            out["virtual"][mesh_name, name] = (new, loss)
            np.savez(d / f"{name}-pins.npz", **{
                f"pin{i}": t.numpy() for i, t in enumerate(recorded)})
            cases.append({"name": name, "cfg": cfg_of(name), "kind": "sgd",
                          "params": f"top{SGD[name][0]}.npz",
                          "tokens": "tokens.npz", "attn": SGD[name][2],
                          "pins": f"{name}-pins.npz"})
        if mesh_name == "dp2xep2":
            for name in OPTAX:
                cases.append({"name": name, "cfg": cfg_of(name),
                              "kind": "optax", "params": "top2.npz",
                              "tokens": "tokens.npz", "attn": "dense",
                              "zero1": name.endswith("zero1"),
                              "steps": OPTAX_STEPS,
                              "norm": not name.endswith("zero1")})
            (d / "route.json").write_text(json.dumps(ROUTE))
            np.savez(d / "route.npz", **route_inputs())
            data = motif_corpus(d / "t.bin", n=4000)
            out["fit_virtual"] = vfit(data, steps=4).losses
            vfit(data, steps=2, checkpoint_dir=str(d / "vck"),
                 checkpoint_every=2)
            (d / "moe_fit.json").write_text(json.dumps(
                {"cfg": FIT, "data": data, "attn": "dense"}))
            out["dir"], out["data"] = d, data
        (d / "moe_cases.json").write_text(json.dumps(cases))
        run_local_group([sys.executable, str(CHILD), "moe", str(d),
                         json.dumps(axes), "cpu"], 4, timeout=WAIT,
                        cwd=str(REPO),
                        env=dict(os.environ, PYTHONPATH=str(REPO)))
        ranks = []
        for r in range(4):
            with np.load(d / f"rank{r}.npz") as npz:
                arrays = {k: npz[k] for k in npz.files}
            ranks.append((json.loads((d / f"rank{r}.json").read_text()),
                          arrays))
        out[mesh_name] = ranks
    return out


SGD_CASES = [(m, n) for m in MESHES for n in SGD_ON[m]]
# the reference's flash kernels run in interpret mode on the CPU: the
# flash case is held to the virtual step's flash path instead
DENSE_CASES = [(m, n) for m, n in SGD_CASES if SGD[n][2] == "dense"]


@lru_cache(maxsize=None)
def reference_sgd(mesh_name: str, name: str) -> tuple:
    jcfg, _ = pair(cfg_of(name))
    jstep, jps, jts = jmoe.make_moe_train_step(jcfg, jmesh(MESHES[mesh_name]),
                                               lr=1.0)
    new, loss = jstep(jax.device_put(jparams(jcfg.router_top_k), jps),
                      jax.device_put(jnp.asarray(windows()[0]), jts))
    return flat(new), float(loss)


@pytest.mark.parametrize("mesh,name", DENSE_CASES)
def test_process_moe_step_matches_the_reference(runs, mesh, name):
    """One step at lr 1 against the reference's ``make_moe_train_step``
    on host devices of the same axes: the loss within LOSS_ATOL, every
    leaf's update within LEAF_REL (the router's ``wg`` too, so its
    gradient is not counted once an ep rank)."""
    want, want_loss = reference_sgd(mesh, name)
    p0 = flat(tparams(SGD[name][0]))
    for info, arrays in runs[mesh]:
        assert info["cases"][name]["t_shard"] == ["dp", None]
        assert abs(float(arrays[f"{name}_loss"][0]) - want_loss) < LOSS_ATOL
        new = leaves(arrays, f"{name}/")
        assert sorted(new) == sorted(want)
        for leaf in want:
            r = rel(p0[leaf] - new[leaf], p0[leaf] - want[leaf])
            assert r < LEAF_REL, (leaf, r)


@pytest.mark.parametrize("mesh,name", SGD_CASES)
def test_process_moe_step_matches_the_virtual_step(runs, mesh, name):
    """The same step with the virtual step's router choices replayed on
    each process's rows: every call replayed, the loss within LOSS_ATOL
    and every leaf's update within LEAF_REL of the virtual mesh's."""
    vnew, vloss = runs["virtual"][mesh, name]
    p0, want = flat(tparams(SGD[name][0])), flat(vnew)
    for info, arrays in runs[mesh]:
        replayed, recorded = info["cases"][name]["pins"]
        assert replayed == recorded == 2 * SMALL["n_layers"]
        assert abs(float(arrays[f"{name}_pin_loss"][0]) - vloss) < LOSS_ATOL
        new = leaves(arrays, f"{name}_pin/")
        for leaf in want:
            r = rel(p0[leaf] - new[leaf], p0[leaf] - want[leaf])
            assert r < LEAF_REL, (leaf, r)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_process_moe_step_is_the_same_on_every_process(runs, mesh):
    """The loss and the gathered tree are the same bits on every process;
    each leaf whole over "ep" (the router's ``wg`` among them) holds the
    same bits on every process, and each process holds its E/ep experts
    of the gathered banks."""
    ranks = runs[mesh]
    ep = MESHES[mesh]["ep"]
    first = ranks[0][1]
    for info, arrays in ranks:
        for name in SGD_ON[mesh]:
            for k, v in first.items():
                if k.startswith((f"{name}_loss", f"{name}/")):
                    np.testing.assert_array_equal(arrays[k], v, err_msg=k)
            local = leaves(arrays, f"{name}_local/")
            whole = leaves(arrays, f"{name}/")
            assert "blocks/wg" in local
            for leaf, v in local.items():
                if leaf in ("blocks/w1", "blocks/w2"):
                    e = info["coords"]["ep"]
                    el = SMALL["n_experts"] // ep
                    np.testing.assert_array_equal(
                        v, whole[leaf][:, e * el:(e + 1) * el])
                else:
                    np.testing.assert_array_equal(
                        v, first[f"{name}_local/{leaf}"], err_msg=leaf)


def test_each_block_runs_its_forward_again_in_the_backward(runs):
    """The MoE trunk's remat on a process: a flash step calls the flash
    forward 2·L times and its backward L times on every process (its
    dp rows, whole heads), and a dense step calls neither."""
    L = SMALL["n_layers"]
    for info, _ in runs["dp2xep2"]:
        assert info["cases"]["flash"]["flash"] == [2 * L, L]
        assert info["cases"]["top2"]["flash"] == [0, 0]


def test_overloaded_router_claims_the_global_slots(runs):
    """Capacity factor 0.5 on dp 2, top-2: routing each dp shard alone
    (its own capacity, its own slot counts) dispatches otherwise on this
    fixture, while each process's dispatch is the rows of the
    reference's global one exactly; its outputs are the reference's rows
    within ROW_REL, and the dp ranks' aux shares sum to the reference's
    aux within AUX_REL."""
    jcfg, tcfg = pair(ROUTE)
    ins = route_inputs()
    B, S = ROUTE_SHAPE
    N, D = B * S, ROUTE["d_model"]
    flat_x = ins["x"].reshape(N, D)
    C = tcfg.capacity(N)
    _, want = jax_route(jcfg, flat_x, ins["wg"], C)           # [K,N,E,C]
    jy, jaux = jmoe.moe_ffn(jcfg, jnp.asarray(ins["x"]), jnp.asarray(
        ins["wg"]), jnp.asarray(ins["w1"]), jnp.asarray(ins["w2"]))
    jy = np.asarray(jy, np.float32).reshape(N, D)
    half = N // 2
    alone_differs = []
    for d in range(2):
        rows = slice(d * half, (d + 1) * half)
        _, _, _, alone = tmoe.route(tcfg, torch.from_numpy(flat_x[rows]),
                                    torch.from_numpy(ins["wg"]),
                                    tcfg.capacity(half))
        glob = want[:, rows]
        alone = alone.numpy()
        alone_differs.append(
            alone.shape != glob.shape or not np.array_equal(alone, glob))
    assert any(alone_differs)
    aux = 0.0
    for info, arrays in runs["dp2xep2"]:
        d = info["coords"]["dp"]
        rows = slice(d * half, (d + 1) * half)
        np.testing.assert_array_equal(arrays["route_disp"], want[:, rows])
        got = arrays["route_out"].reshape(half, D)
        err = np.linalg.norm(got - jy[rows], axis=-1) / np.maximum(
            np.linalg.norm(jy[rows], axis=-1), 1e-6)
        assert err.max() <= ROW_REL
        if info["coords"]["ep"] == 0:
            aux += float(arrays["route_aux"])
    assert abs(aux - float(jaux)) <= AUX_REL * abs(float(jaux))


@lru_cache(maxsize=None)
def reference_optax() -> tuple:
    jcfg, _ = pair(cfg_of("adamw"))
    jstep, jinit, jps, jts = jmoe.make_moe_optax_step(
        jcfg, jmesh(MESHES["dp2xep2"]))
    params = jax.device_put(jparams(2), jps)
    opt = jinit(params)
    losses, mu1 = [], None
    for i in range(OPTAX_STEPS):
        params, opt, loss = jstep(params, opt, jax.device_put(
            jnp.asarray(windows()[i]), jts))
        losses.append(float(loss))
        if i == 0:
            mu1 = flat(opt[1][0].mu)
    return losses, mu1


@pytest.mark.parametrize("name", OPTAX)
def test_process_moe_adamw_matches_the_reference(runs, name):
    """3 AdamW steps against the reference's ``make_moe_optax_step``: the
    losses within LOSS_ATOL every step, each leaf's first moment after
    step 1 within LEAF_REL."""
    losses, mu1 = reference_optax()
    for _, arrays in runs["dp2xep2"]:
        got = arrays[f"{name}_loss"]
        assert np.max(np.abs(got - np.asarray(losses))) < LOSS_ATOL
        mine = leaves(arrays, f"{name}_mu1/")
        assert sorted(mine) == sorted(mu1)
        for leaf, want in mu1.items():
            assert rel(mine[leaf], want) < LEAF_REL, (leaf,
                                                       rel(mine[leaf], want))


def test_process_moe_zero1_is_bit_equal_to_replicated(runs):
    """After 3 steps: ZeRO-1's losses, gathered parameters and gathered
    moments hold the replicated run's bits on every process, and a
    process holds half the replicated moment bytes (the banks' moments
    cut over "dp" on the layer axis as well as over "ep")."""
    for info, arrays in runs["dp2xep2"]:
        for prefix in ("_loss", "/", "_mu/", "_nu/", "_mu1/"):
            a = {k: v for k, v in arrays.items()
                 if k.startswith("adamw" + prefix)}
            assert a
            for k, v in a.items():
                np.testing.assert_array_equal(
                    arrays[k.replace("adamw", "adamw-zero1", 1)], v,
                    err_msg=k)
        held, said = info["cases"]["adamw-zero1"]["bytes"]
        plain = info["cases"]["adamw"]["bytes"]
        assert held == said and plain[0] == plain[1]
        assert 2 * held == plain[0]


def test_clip_norm_from_ep_shards_counts_each_element_once(runs):
    """The clip's squared norm from the shards (the ep-cut banks' sums
    gathered over ep, the rest once) is the gathered gradients', within
    fp32 summation, and the same bits on every process."""
    said = [info["cases"]["adamw"]["norm"] for info, _ in runs["dp2xep2"]]
    for shards, whole in said:
        assert abs(shards - whole) <= 1e-5 * whole, (shards, whole)
        assert shards == said[0][0]


def test_process_moe_fit_resumes_bit_for_bit(runs):
    """``fit`` on dp 2 × ep 2: 2 steps saved and 2 resumed give the
    uninterrupted run's losses, and its step-4 parameters and moments,
    bit for bit; the checkpoint holds the global banks."""
    for info, arrays in runs["dp2xep2"]:
        assert arrays["fit_resumed"].tolist() == \
            arrays["fit_full"][2:].tolist()
        assert info["fit"]["resumed_step"] == 4
    d = runs["dir"]
    want = restore_train_state(str(d / "ck-full"), device=CPU)
    got = restore_train_state(str(d / "ck"), device=CPU)
    assert want["extra"]["step"] == got["extra"]["step"] == 4
    assert tuple(got["params"]["blocks"]["w1"].shape) == (
        FIT["n_layers"], FIT["n_experts"], FIT["d_model"], FIT["d_ff"])
    for a, b in zip(flat_tree(want).values(), flat_tree(got).values()):
        if torch.is_tensor(a):
            assert torch.equal(a, b)
        else:
            assert a == b


# A resumed step is held for one step: AdamW moves an element whose
# gradient is near zero by about ±lr whichever sign the gradient takes,
# so the two meshes' rounding parts their parameters by up to 2·lr
# after a step, and a later forward can route a near-tie to another
# expert (the routing near-ties of ROADMAP.md §3): on this corpus one
# of 128 token-layer routes differs after two steps, which moves the
# loss by up to 6.2e-3 where the dense model's stays within LOSS_ATOL.
def test_process_moe_fit_resumes_the_virtual_checkpoint(runs):
    """The process run resumed the virtual mesh's step-2 checkpoint:
    its first step's loss is the virtual run's step 3 within
    LOSS_ATOL."""
    want = runs["fit_virtual"][2]
    for _, arrays in runs["dp2xep2"]:
        assert len(arrays["fit_crossed"]) == 1
        assert abs(float(arrays["fit_crossed"][0]) - want) < LOSS_ATOL


def test_virtual_moe_fit_resumes_the_process_checkpoint(runs, tmp_path):
    """A one-process ``fit`` on the virtual mesh resumes the process run's
    step-2 checkpoint, a one-process run's tree: its first step's loss
    is the process run's step 3 within LOSS_ATOL."""
    import shutil
    ck = tmp_path / "ck2"
    shutil.copytree(runs["dir"] / "ck2", ck)
    mine = restore_train_state(str(ck), device=CPU)
    theirs = restore_train_state(str(runs["dir"] / "vck"), step=2,
                                 device=CPU)
    assert flat_tree(mine).keys() == flat_tree(theirs).keys()
    for k, v in flat_tree(theirs).items():
        if torch.is_tensor(v):
            assert flat_tree(mine)[k].shape == v.shape, k
    got = vfit(runs["data"], steps=1, checkpoint_dir=str(ck), resume=True)
    want = runs["dp2xep2"][0][1]["fit_full"][2]
    assert got.step == 3
    assert abs(got.losses[0] - float(want)) < LOSS_ATOL
