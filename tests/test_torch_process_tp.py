"""The DP×TP step across processes: ``train.make_sharded_train_step`` on
a ``mesh.ProcessMesh`` of dp 1 × tp 2 and dp 2 × tp 2, one gloo process a
rank on the CPU (tests/torch_process_child.py's ``tp`` mode, one group a
mesh started by ``launcher.run_local_group`` for every case), each
process holding its own shards.

Each case takes one SGD step at lr 1 from the same numpy parameters and
window and is held to the reference's ``make_sharded_train_step`` on a
host-device mesh of the same axes and to the port's virtual ``Mesh``
step: the loss within 5e-3 and each leaf's update within 3% relative L2,
as tests/test_torch_sharded_train.py holds the virtual step.  The cases:
both ``matmul_impl`` with dense and flash attention (the plain versions
here) on windows of 32 and 33 tokens (the trunk's 31 rows pad to 32 on
the fused path), GQA (2 kv heads), MQA (1 kv head: every rank reads the
one k/v head, the recut's duplicated columns), a tied-and-rope model on
both paths, ``accum_steps=2`` and the dense path with
``norm_impl="fused"`` (the RMSNorm-matmul's plain version on each rank's
column shard).  Also: every process ends with the
same bits in each leaf the specs leave whole over tp, the tree's cut
gathers back to itself, and the ring wrappers run 4·L times a
microbatch each on the fused path and never on the dense one.
"""

from __future__ import annotations

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
from torch_process_child import flat_tree

from tpu_dra.workloads import train as jt
from tpu_dra_torch.convert import save_npz
from tpu_dra_torch.workloads import train as tt
from tpu_dra_torch.workloads.launcher import run_local_group
from tpu_dra_torch.workloads.mesh import Mesh

LOSS_ATOL = 5e-3
LEAF_REL = 3e-2
CHILD = Path(__file__).resolve().parent / "torch_process_child.py"
REPO = CHILD.parent.parent
WAIT = 240
MESHES = {"dp1xtp2": {"dp": 1, "tp": 2}, "dp2xtp2": {"dp": 2, "tp": 2}}
BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
# name: (config beyond BASE, window length, matmul_impl, attn_impl, accum)
CASES = {
    **{f"{impl}-{attn}-{seq}": ({}, seq, impl, attn, 1)
       for impl in ("fused_collective", "dense")
       for attn in ("dense", "flash") for seq in (32, 33)},
    "gqa": ({"n_kv_heads": 2}, 33, "dense", "flash", 1),
    "mqa": ({"n_kv_heads": 1}, 32, "fused_collective", "dense", 1),
    "tied-rope-fused": ({"tied_embeddings": True, "pos_emb": "rope"}, 33,
                        "fused_collective", "flash", 1),
    "tied-rope-dense": ({"tied_embeddings": True, "pos_emb": "rope"}, 32,
                        "dense", "dense", 1),
    "accum2": ({}, 32, "fused_collective", "dense", 2),
    "dense-fused-norm": ({}, 32, "dense", "dense", 1),
}
# norm_impl where a case does not take the default
NORMS = {"dense-fused-norm": "fused"}


def case_cfg(name: str) -> dict:
    extra, seq = CASES[name][:2]
    return dict(BASE, max_seq=seq, **extra)


def window(seq: int) -> np.ndarray:
    return np.random.default_rng(seq).integers(0, 64, (4, seq)).astype(
        np.int32)


def flat(tree) -> dict:
    return {k: f32(v) for k, v in flat_tree(tree).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per mesh and rank: the child's JSON and its saved arrays."""
    d0 = tmp_path_factory.mktemp("tp")
    cases = []
    for name, (_, seq, impl, attn, accum) in CASES.items():
        jcfg, _ = cfg_pair(**case_cfg(name))
        save_npz(d0 / f"{name}.npz", to_torch(jax_params(jcfg)))
        np.savez(d0 / f"{name}_tokens.npz", tokens=window(seq))
        cases.append({"name": name, "cfg": case_cfg(name),
                      "params": f"{name}.npz",
                      "tokens": f"{name}_tokens.npz", "impl": impl,
                      "attn": attn, "accum": accum,
                      "norm": NORMS.get(name, "dense")})
    (d0 / "cases.json").write_text(json.dumps(cases))
    out = {}
    for mesh, axes in MESHES.items():
        d = tmp_path_factory.mktemp(mesh)
        for f in d0.iterdir():
            (d / f.name).symlink_to(f)
        n = int(np.prod(list(axes.values())))
        run_local_group([sys.executable, str(CHILD), "tp", str(d),
                         json.dumps(axes), "cpu"], n, timeout=WAIT,
                        cwd=str(REPO),
                        env=dict(os.environ, PYTHONPATH=str(REPO)))
        ranks = []
        for r in range(n):
            with np.load(d / f"rank{r}.npz") as data:
                arrays = {k: data[k] for k in data.files}
            ranks.append((json.loads((d / f"rank{r}.json").read_text()),
                          arrays))
        out[mesh] = ranks
    return out


def hold(loss, new: dict, want_loss, want: dict, p0: dict) -> None:
    """The loss within LOSS_ATOL, each leaf's update within LEAF_REL."""
    assert abs(float(loss) - float(want_loss)) < LOSS_ATOL, \
        (float(loss), float(want_loss))
    assert sorted(new) == sorted(want)
    for leaf in want:
        gw, gg = p0[leaf] - want[leaf], p0[leaf] - new[leaf]
        rel = np.linalg.norm(gg - gw) / np.linalg.norm(gw)
        assert rel < LEAF_REL, (leaf, rel)


def process_result(runs, mesh: str, name: str) -> tuple:
    arrays = runs[mesh][0][1]
    new = {k[len(name) + 1:]: v for k, v in arrays.items()
           if k.startswith(name + "/")}
    return arrays[f"{name}_loss"], new


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_process_step_matches_the_reference(runs, mesh, name):
    jcfg, _ = cfg_pair(**case_cfg(name))
    _, seq, impl, attn, accum = CASES[name]
    params = jax_params(jcfg)
    axes = MESHES[mesh]
    devs = np.array(jax.devices()[:int(np.prod(list(axes.values())))])
    jm = JMesh(devs.reshape(tuple(axes.values())), tuple(axes))
    jstep, p_sh, b_sh = jt.make_sharded_train_step(
        jcfg, jm, lr=1.0, attn_impl=attn, accum_steps=accum,
        norm_impl=NORMS.get(name, "dense"), matmul_impl=impl)
    want, want_loss = jstep(jax.device_put(params, p_sh),
                            jax.device_put(jnp.asarray(window(seq)), b_sh))
    loss, new = process_result(runs, mesh, name)
    hold(loss, new, want_loss, flat(want), flat(params))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_process_step_matches_the_virtual_step(runs, mesh, name):
    jcfg, tcfg = cfg_pair(**case_cfg(name))
    _, seq, impl, attn, accum = CASES[name]
    params = to_torch(jax_params(jcfg))
    step, _, _ = tt.make_sharded_train_step(
        tcfg, Mesh(MESHES[mesh], device=CPU), lr=1.0, attn_impl=attn,
        accum_steps=accum, norm_impl=NORMS.get(name, "dense"),
        matmul_impl=impl)
    want, want_loss = step(params, torch.from_numpy(window(seq)))
    loss, new = process_result(runs, mesh, name)
    hold(loss, new, want_loss, flat(want), flat(params))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_replicated_leaves_are_the_same_bits_on_every_process(runs, mesh):
    """Every leaf the specs leave whole over tp (the norm gains), and
    every shard on the ranks that share it over dp, holds the same bits
    on every process; so do the losses."""
    ranks = runs[mesh]
    for name in CASES:
        for r, (info, arrays) in enumerate(ranks):
            for leaf, spec in info["specs"][name].items():
                tp_cut = any("tp" in (e if isinstance(e, list) else [e])
                             for e in spec)
                for q, (other, theirs) in enumerate(ranks):
                    same_tp = other["coords"]["tp"] == info["coords"]["tp"]
                    if tp_cut and not same_tp:
                        continue
                    np.testing.assert_array_equal(
                        arrays[f"{name}_local/{leaf}"],
                        theirs[f"{name}_local/{leaf}"], err_msg=(name, leaf))
            np.testing.assert_array_equal(arrays[f"{name}_loss"],
                                          ranks[0][1][f"{name}_loss"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_process_tree_cut_gathers_back_and_specs(runs, mesh):
    """``shard_tree`` then ``unshard_tree`` gives each case's tree back;
    the specs are the reference's ``param_shardings``; each rank sits at
    its row-major coordinates; the chunked head with label smoothing
    raises, as on one device."""
    axes = MESHES[mesh]
    for r, (info, _) in enumerate(runs[mesh]):
        assert info["round_trips"] == dict.fromkeys(CASES, True)
        assert info["coords"] == {"dp": r // axes["tp"], "tp": r % axes["tp"]}
        for name, specs in info["specs"].items():
            _, tcfg = cfg_pair(**case_cfg(name))
            assert specs == {k: list(v) for k, v in flat_tree(
                tt.param_shardings(tcfg, None)).items()}
        assert info["b_shard"] == ["dp", None]
        assert "label_smoothing" in info["chunked"] and "dense head" in \
            info["chunked"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ring_wrappers_run_on_the_fused_path_only(runs, mesh):
    """4·L calls of each ring wrapper a microbatch on the fused path (the
    forward's two, each one's backward through the other), none on the
    dense path."""
    for info, _ in runs[mesh]:
        for name, (extra, seq, impl, attn, accum) in CASES.items():
            L = case_cfg(name)["n_layers"]
            want = [4 * L * accum] * 2 if impl == "fused_collective" \
                else [0, 0]
            assert info["calls"][name] == want, name
            assert info["launches"][name] == [0, 0]   # none on the CPU


def test_learned_table_past_the_pad_takes_the_dense_path():
    """On a process mesh the fused path keeps the reference's fallback:
    padding the trunk's rows to tp past a learned-position table leaves
    every product on the dense path (``process_train.fc_admitted``)."""
    from tpu_dra_torch.workloads.process_train import fc_admitted
    _, tcfg = cfg_pair(**dict(BASE, max_seq=31))
    assert not fc_admitted(tcfg, 31, 2)
    assert fc_admitted(tcfg, 30, 2) and fc_admitted(tcfg, 31, 1) is False
    _, rope = cfg_pair(**dict(BASE, max_seq=31, pos_emb="rope"))
    assert fc_admitted(rope, 31, 2)


def test_head_columns_give_each_rank_its_heads():
    """The fused projection's recut: each rank's q heads and the k/v
    heads they read, MHA, GQA, MQA and a grouping that does not split
    evenly (3 kv heads over 2 ranks: one k/v head a q head)."""
    from tpu_dra_torch.workloads.process_train import head_columns
    _, mha = cfg_pair(**dict(BASE, max_seq=16))
    src, dst, kv = head_columns(mha, 2)
    dh = mha.d_head
    assert kv == [[0, 1], [2, 3]]
    assert src[1] == list(range(48, 96))
    assert dst[1][:2 * dh] == list(range(16, 32))
    assert dst[1][2 * dh:3 * dh] == list(range(32 + 2 * dh, 32 + 3 * dh))
    assert head_columns(cfg_pair(**dict(BASE, max_seq=16,
                                        n_kv_heads=1))[1], 2)[2] == [[0], [0]]
    assert head_columns(cfg_pair(**dict(BASE, max_seq=16,
                                        n_kv_heads=2))[1], 2)[2] == [[0], [1]]
    _, odd = cfg_pair(vocab=64, d_model=48, n_heads=6, n_kv_heads=3,
                      n_layers=1, d_ff=64, max_seq=16)
    assert head_columns(odd, 2)[2] == [[0, 0, 1], [1, 2, 2]]
    with pytest.raises(ValueError, match="split over tp"):
        head_columns(odd, 4)
