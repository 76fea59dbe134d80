"""LoRA and the serving shardings across processes:
``lora.make_lora_train_step`` and ``quant.serving_param_shardings`` on a
``mesh.ProcessMesh`` of dp 2 × tp 2, one gloo process a rank on the CPU
(tests/torch_process_child.py's ``lora`` mode, one group of four started
by ``launcher.run_local_group``).  Each process holds its
``serving_param_shardings`` shards of the frozen base, plain, int8 or
int4 (the int4 group count dividing tp and not), and the whole adapters,
which the step cuts to its shards' counterparts.

Each case takes 3 steps of the default LoRA optimizer from the same
numpy base, adapters and windows, held to the reference's
``make_lora_train_step`` on host devices of the same axes and to the
port's virtual ``Mesh`` step: the loss within 5e-3 every step, the
adapters after 3 steps and their first moments after step 1 within 3%
relative L2.  The first moment is (1 − b1) times the clipped gradient,
so it shows the adapter gradients summed over every axis: summed over
dp alone, a column-cut factor would hold only this rank's columns and a
whole one a partial sum.  Bits: the base is untouched, the adapters are
the same on every process, and a serving tree cut and gathered back is
byte-equal.  An int4 tree whose replicated group scales a process's rows
would straddle is refused with the shapes named.
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

from torch_parity import CPU, cfg_pair, f32, jax_params, to_numpy_tree
from torch_process_child import flat_tree
from test_torch_lora import jax_lora_with_b

from tpu_dra.workloads import lora as jlora
from tpu_dra.workloads import quant as jq
from tpu_dra_torch.convert import params_from_numpy, save_npz
from tpu_dra_torch.workloads import lora as tlora
from tpu_dra_torch.workloads import quant as tq
from tpu_dra_torch.workloads.launcher import run_local_group
from tpu_dra_torch.workloads.mesh import Mesh

LOSS_ATOL = 5e-3
LEAF_REL = 3e-2
CHILD = Path(__file__).resolve().parent / "torch_process_child.py"
REPO = CHILD.parent.parent
WAIT = 300
AXES = {"dp": 2, "tp": 2}
STEPS = 3
RANK = 8
# tests/test_torch_lora.py's configs
BASE = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            max_seq=32)
GQA = dict(BASE, n_heads=4, n_kv_heads=2, pos_emb="rope")
# name: (config, base form, int4 group, attn_impl); int4 at group 16
# cuts wo's 2 group scales over tp with its rows, at group 32 wo's one
# group count does not divide tp and its scales replicate
CASES = {
    "plain": (BASE, "plain", 0, "dense"),
    "gqa": (GQA, "plain", 0, "dense"),
    "gqa-flash": (GQA, "plain", 0, "flash"),
    "int8": (BASE, "int8", 0, "dense"),
    "int4-g16": (BASE, "int4", 16, "dense"),
    "int4-g32": (BASE, "int4", 32, "dense"),
}
# the reference's flash kernels run in interpret mode on the CPU: the
# flash case is held to the virtual step's flash path instead
REFERENCED = sorted(k for k, v in CASES.items() if v[3] == "dense")
# w2's K of 96 in 3 groups of 32: a process's 48 rows straddle them
STRADDLE = dict(BASE, d_ff=96)
STRADDLE_GROUP = 32


def windows() -> np.ndarray:
    """``[STEPS, 4, 17]``: one window batch a step."""
    return np.random.default_rng(7).integers(0, 64, (STEPS, 4, 17),
                                             dtype=np.int32)


def jmesh():
    devs = np.array(jax.devices()[:4])
    return JMesh(devs.reshape(tuple(AXES.values())), tuple(AXES))


def flat(tree) -> dict:
    return {k: f32(v).copy() for k, v in flat_tree(tree).items()}


def rel(got, want) -> float:
    return float(np.linalg.norm(f32(got) - f32(want))
                 / np.linalg.norm(f32(want)))


def leaves(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


@lru_cache(maxsize=None)
def trees(cfg_name: str) -> tuple:
    """(reference config, port config, reference base, reference
    adapters with a non-zero B)."""
    jcfg, tcfg = cfg_pair(**{"base": BASE, "gqa": GQA}[cfg_name])
    jp = jax_params(jcfg)
    return jcfg, tcfg, jp, jax_lora_with_b(jp, jlora.LoRAConfig(rank=RANK),
                                           6)


def cfg_name(name: str) -> str:
    return "gqa" if CASES[name][0] is GQA else "base"


def jserving(jp, form: str, group: int):
    if form == "int8":
        return jq.quantize_params_int8(jp)
    if form == "int4":
        return jq.quantize_params_int4(jp, group)
    return jp


def tserving(tp, form: str, group: int):
    if form == "int8":
        return tq.quantize_params_int8(tp)
    if form == "int4":
        return tq.quantize_params_int4(tp, group)
    return tp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per rank: the child's JSON and its saved arrays."""
    d = tmp_path_factory.mktemp("lora")
    cases = []
    for name, (cfg, form, group, attn) in CASES.items():
        _, _, jp, jl = trees(cfg_name(name))
        tag = cfg_name(name)
        if not (d / f"{tag}.npz").exists():
            save_npz(d / f"{tag}.npz", to_numpy_tree(jp))
            save_npz(d / f"{tag}-lora.npz", to_numpy_tree(jl))
        cases.append({"name": name, "cfg": cfg, "params": f"{tag}.npz",
                      "lora": f"{tag}-lora.npz", "tokens": "tokens.npz",
                      "form": form, "group": group, "attn": attn,
                      "steps": STEPS, "rank": RANK})
    np.savez(d / "tokens.npz", tokens=windows())
    (d / "lora_cases.json").write_text(json.dumps(cases))
    jcfg, _ = cfg_pair(**STRADDLE)
    save_npz(d / "straddle.npz", to_numpy_tree(jax_params(jcfg)))
    (d / "straddle.json").write_text(json.dumps(
        {"cfg": STRADDLE, "params": "straddle.npz",
         "group": STRADDLE_GROUP}))
    run_local_group([sys.executable, str(CHILD), "lora", str(d),
                     json.dumps(AXES), "cpu"], 4, timeout=WAIT,
                    cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO)))
    ranks = []
    for r in range(4):
        with np.load(d / f"rank{r}.npz") as npz:
            arrays = {k: npz[k] for k in npz.files}
        ranks.append((json.loads((d / f"rank{r}.json").read_text()), arrays))
    return ranks


@lru_cache(maxsize=None)
def reference(name: str) -> tuple:
    """The reference's ``make_lora_train_step`` on host devices of the
    same axes, the base in its serving form placed by
    ``serving_param_shardings``: (losses, first moments after step 1,
    adapters after the last step)."""
    _, form, group, attn = CASES[name]
    jcfg, _, jp, jl = trees(cfg_name(name))
    jm = jmesh()
    jstep, jinit, _, jsh = jlora.make_lora_train_step(
        jcfg, jm, jlora.LoRAConfig(rank=RANK), attn_impl=attn)
    base = jserving(jp, form, group)
    base = jax.device_put(base, jq.serving_param_shardings(jcfg, jm, base))
    lo = jax.device_put(jl, jsh["lora"](jl))
    opt = jinit(lo)
    losses, mu1 = [], None
    for i in range(STEPS):
        lo, opt, loss = jstep(base, lo, opt, jnp.asarray(windows()[i]))
        losses.append(float(loss))
        if i == 0:
            mu1 = flat(opt[1][0].mu)
    return losses, mu1, flat(lo)


@lru_cache(maxsize=None)
def virtual(name: str) -> tuple:
    """The port's ``make_lora_train_step`` on the virtual mesh: (losses,
    first moments after step 1, adapters after the last step)."""
    _, form, group, attn = CASES[name]
    _, tcfg, jp, jl = trees(cfg_name(name))
    step, init, _, _ = tlora.make_lora_train_step(
        tcfg, Mesh(AXES, device=CPU), tlora.LoRAConfig(rank=RANK),
        attn_impl=attn)
    base = tserving(params_from_numpy(to_numpy_tree(jp), CPU), form, group)
    lo = params_from_numpy(to_numpy_tree(jl), CPU)
    opt = init(lo)
    losses, mu1 = [], None
    for i in range(STEPS):
        lo, opt, loss = step(base, lo, opt, torch.from_numpy(windows()[i]))
        losses.append(float(loss))
        if i == 0:
            mu1 = flat(opt.mu)
    return losses, mu1, flat(lo)


def hold(name: str, arrays: dict, want: tuple) -> None:
    losses, mu1, adapters = want
    got = arrays[f"{name}_loss"]
    assert np.max(np.abs(got - np.asarray(losses))) < LOSS_ATOL, \
        (got, losses)
    for prefix, tree in ((f"{name}_mu1/", mu1), (f"{name}/", adapters)):
        mine = leaves(arrays, prefix)
        assert sorted(mine) == sorted(tree)
        for leaf, w in tree.items():
            assert rel(mine[leaf], w) < LEAF_REL, (prefix, leaf,
                                                    rel(mine[leaf], w))


@pytest.mark.parametrize("name", REFERENCED)
def test_process_lora_step_matches_the_reference(runs, name):
    hold(name, runs[0][1], reference(name))


@pytest.mark.parametrize("name", sorted(CASES))
def test_process_lora_step_matches_the_virtual_step(runs, name):
    hold(name, runs[0][1], virtual(name))


@pytest.mark.parametrize("name", sorted(CASES))
def test_process_lora_keeps_the_base_and_the_adapters_agree(runs, name):
    """The base shards hold their bits through the steps; the losses, the
    adapters and their moments are the same bits on every process."""
    first = runs[0][1]
    for info, arrays in runs:
        assert info["cases"][name]["base_same"]
        for k, v in first.items():
            if k.startswith((f"{name}_loss", f"{name}/", f"{name}_mu1/")):
                np.testing.assert_array_equal(arrays[k], v, err_msg=k)


def test_process_lora_flash_calls(runs):
    """The flash case calls the flash forward 2·L times a step (the
    attention core is rematerialized) and its backward L times, on
    every process; a dense case calls neither."""
    L = GQA["n_layers"]
    for info, _ in runs:
        assert info["cases"]["gqa-flash"]["flash"] == [2 * L * STEPS,
                                                       L * STEPS]
        assert info["cases"]["gqa"]["flash"] == [0, 0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_serving_param_shardings_on_a_process_mesh(runs, name):
    """``serving_param_shardings`` on the process mesh gives the
    reference's specs leaf for leaf, and its cut of the serving tree
    gathers back byte-equal on every process.  At int4 group 32 wo's
    one group count does not divide tp: its scales replicate while its
    rows are cut."""
    _, form, group, _ = CASES[name]
    jcfg, _, jp, _ = trees(cfg_name(name))
    jm = jmesh()
    want = {k: list(v) for k, v in flat_tree(jax.tree.map(
        lambda s: tuple(s.spec),
        jq.serving_param_shardings(jcfg, jm, jserving(jp, form, group)),
        is_leaf=lambda x: hasattr(x, "spec"))).items()}
    for info, _ in runs:
        got = info["cases"][name]
        specs = {k: [list(e) if isinstance(e, list) else e for e in v]
                 for k, v in got["specs"].items()}
        assert specs == {k: [list(e) if isinstance(e, tuple) else e
                             for e in v] for k, v in want.items()}
        assert got["gathered"]
    if name == "int4-g32":
        assert want["blocks/wo/s4"] == [None, None, None]
        assert want["blocks/wo/q4"] == [None, "tp", None]


def test_straddling_int4_rows_are_refused(runs):
    """w2's 96 rows in 3 groups of 32 over tp 2: the scales replicate
    (3 groups do not divide tp) and a process's 48 rows straddle two
    groups, so its product cannot read them by rows: the local view
    raises ``ValueError`` naming the shapes, on every process, while the
    tree still cuts and gathers back byte-equal."""
    for info, _ in runs:
        said = info["straddle"]["said"]
        assert "straddle" in said and "(2, 48, 32)" in said \
            and "(2, 3, 32)" in said, said
        assert info["straddle"]["gathered"]
