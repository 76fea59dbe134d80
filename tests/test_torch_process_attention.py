"""Ring attention, zigzag ring attention and the KV handoff's
``ici_shift`` on a ``mesh.ProcessMesh``, one process a rank: groups of 2
and 4 gloo processes on the CPU (tests/torch_process_child.py's ``attn``
mode, started by ``launcher.run_local_group``) on sp 2, sp 4 and
dp 2 × sp 2.  Every process passes the same global q, k, v to
``make_zigzag_ring_attention`` (both engines), ``make_ring_attention``
and ``make_ring_attention_flash`` (both hops), MHA and GQA, and gets the
global output and the gradients of a fixed cotangent; each is held to
the reference's maker under ``shard_map`` on host devices (Pallas in
interpret mode, as the reference runs off the TPU) and to the port's
virtual mesh.  ``ici_shift`` moves a handoff's bf16, int8 and fp32
leaves one hop each way over the ring, byte-equal to the reference's
``ici_shift`` under ``shard_map``.

Tolerances, as tests/test_torch_zigzag.py and
tests/test_torch_ring_attention.py hold the virtual mesh: outputs and
gradients elementwise within ``flash.ELEM_TOL`` (2^-6, relative plus
absolute).  The shifts are copies: byte-equal.  On the CPU no kernel
launches; the plain versions' calls are counted instead.
"""

from __future__ import annotations

import functools
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
from jax.sharding import PartitionSpec as P

from torch_parity import CPU, f32
from torch_process_child import (MAKER_CASES, MAKER_SHAPE, ZIGZAG_CASES,
                                 handoff_tree, maker_inputs)

from tpu_dra.workloads import kv_handoff as jkv
from tpu_dra.workloads import ring_attention as jra
from tpu_dra.workloads.ring_attention import shard_map
from tpu_dra_torch.workloads import flash as tf
from tpu_dra_torch.workloads import ring_attention as tra
from tpu_dra_torch.workloads.launcher import run_local_group
from tpu_dra_torch.workloads.mesh import Mesh

TOL = tf.ELEM_TOL
CHILD = Path(__file__).resolve().parent / "torch_process_child.py"
REPO = CHILD.parent.parent
# seconds a group of children may take (each is a few seconds)
WAIT = 240
MESHES = {"sp2": {"sp": 2}, "sp4": {"sp": 4}, "dp2xsp2": {"dp": 2, "sp": 2}}
ZZ_IDS = [f"{impl}-kv{kv}" for impl, kv in ZIGZAG_CASES]
RING_IDS = [f"{e}-{h}-kv{kv}" for e, h, kv in MAKER_CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh's children: per rank, its JSON and its arrays."""
    out = {}
    for name, axes in MESHES.items():
        d = tmp_path_factory.mktemp(name)
        n = int(np.prod(list(axes.values())))
        run_local_group([sys.executable, str(CHILD), "attn", str(d),
                         json.dumps(axes), "cpu"], n, timeout=WAIT,
                        cwd=str(REPO),
                        env=dict(os.environ, PYTHONPATH=str(REPO)))
        ranks = []
        for r in range(n):
            with np.load(d / f"rank{r}.npz") as data:
                arrays = {k: data[k] for k in data.files}
            ranks.append((json.loads((d / f"rank{r}.json").read_text()),
                          arrays))
        out[name] = ranks
    return out


def close(got, want):
    got, want = f32(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = TOL + TOL * np.abs(want)
    assert np.all(np.abs(got - want) <= bound), \
        float((np.abs(got - want) / bound).max())


def jmesh(axes: dict):
    devs = np.array(jax.devices()[:int(np.prod(list(axes.values())))])
    return JMesh(devs.reshape(tuple(axes.values())), tuple(axes))


def jb(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


@functools.lru_cache(maxsize=None)
def reference(mesh: str, kind: str, case: tuple) -> list:
    """The reference maker's output and q, k, v gradients on the same
    global inputs and cotangent: ``kind`` "zz" (case ``(impl, kv)``) or
    "ring" (``(engine, hop, kv)``)."""
    axes = MESHES[mesh]
    if kind == "zz":
        impl, kv = case
        fn = jra.make_zigzag_ring_attention(jmesh(axes), axis_name="sp",
                                            impl=impl)
    else:
        engine, hop, kv = case
        make = jra.make_ring_attention_flash if engine == "flash" else \
            jra.make_ring_attention
        fn = make(jmesh(axes), axis_name="sp", hop_impl=hop)
    q, k, v, cot = (jb(t) for t in maker_inputs(kv))

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32)
                       * cot.astype(jnp.float32))
    out = jax.jit(fn)(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(t, np.float32) for t in (out, *grads)]


def virtual(mesh: str, kind: str, case: tuple) -> list:
    """The same on the port's virtual mesh of the same axes."""
    m = Mesh(MESHES[mesh], device=CPU)
    if kind == "zz":
        impl, kv = case
        fn = tra.make_zigzag_ring_attention(m, impl=impl)
    else:
        engine, hop, kv = case
        make = tra.make_ring_attention_flash if engine == "flash" else \
            tra.make_ring_attention
        fn = make(m, hop_impl=hop)
    q, k, v, cot = maker_inputs(kv)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*ins)
    return [f32(t) for t in (out.detach(),
                             *torch.autograd.grad(out, ins, cot))]


def got_of(arrays: dict, tag: str) -> list:
    return [arrays[tag], *(arrays[f"{tag}_d{n}"] for n in "qkv")]


def hold_all(runs, mesh: str, tag: str, want: list) -> None:
    for _, arrays in runs[mesh]:
        for got, w in zip(got_of(arrays, tag), want):
            close(got, w)


@pytest.mark.parametrize("case", ZIGZAG_CASES, ids=ZZ_IDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_process_zigzag_matches_the_reference(runs, mesh, case):
    """Every process's global output and q, k, v gradients against the
    reference's ``make_zigzag_ring_attention`` on host devices."""
    impl, kv = case
    hold_all(runs, mesh, f"zz_{impl}_kv{kv}", reference(mesh, "zz", case))


@pytest.mark.parametrize("case", ZIGZAG_CASES, ids=ZZ_IDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_process_zigzag_matches_the_virtual_mesh(runs, mesh, case):
    impl, kv = case
    hold_all(runs, mesh, f"zz_{impl}_kv{kv}", virtual(mesh, "zz", case))


@pytest.mark.parametrize("case", MAKER_CASES, ids=RING_IDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_process_ring_makers_match_the_reference(runs, mesh, case):
    """``make_ring_attention`` / ``make_ring_attention_flash``, both
    hops, against the reference's makers on host devices."""
    engine, hop, kv = case
    hold_all(runs, mesh, f"ring_{engine}_{hop}_kv{kv}",
             reference(mesh, "ring", case))


@pytest.mark.parametrize("case", MAKER_CASES, ids=RING_IDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_process_ring_makers_match_the_virtual_mesh(runs, mesh, case):
    engine, hop, kv = case
    hold_all(runs, mesh, f"ring_{engine}_{hop}_kv{kv}",
             virtual(mesh, "ring", case))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_process_attention_is_the_same_on_every_process(runs, mesh):
    """The gathered output and the gathered gradients hold the same bits
    on every process; on the CPU the shift kernel's plain version gives
    the send and receive's bits."""
    ranks = runs[mesh]
    first = ranks[0][1]
    for _, arrays in ranks[1:]:
        for k in first:
            if not k.startswith("shift_"):
                np.testing.assert_array_equal(arrays[k], first[k])
    for k in first:
        if k.startswith("ring_") and "_pallas_" in k:
            np.testing.assert_array_equal(
                first[k], first[k.replace("_pallas_", "_xla_")])
    assert first["zz_xla_kv2"].shape == MAKER_SHAPE


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_process_zigzag_attends_2n_plus_1_chunks(runs, mesh):
    """Each process runs its own branch only: 2n + 1 chunk-attends a
    call with the flash engine (as many backward calls), against the
    virtual mesh's 3n batched over rank subsets; the stacked kv hops
    n − 1 times forward and n − 1 back, through the plain send and
    receive."""
    n = MESHES[mesh]["sp"]
    for info, _ in runs[mesh]:
        for impl, kv in ZIGZAG_CASES:
            tag = f"zz_{impl}_kv{kv}"
            want = [2 * n + 1] * 2 if impl == "flash" else [0, 0]
            assert info["calls"][tag] == want, (tag, info["calls"][tag])
            assert info["hops"][tag] == [0, 2 * (n - 1)]
            assert info["launches"][tag] == [0, 0, 0, 0]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_process_ring_makers_fold_and_hop_exactly(runs, mesh):
    """Rank idx folds 1 + idx blocks with the flash engine (the
    reference's ``lax.cond``), forward and backward; k and v hop n − 1
    times each way, through the shift kernel's wrapper (``"pallas"``;
    its plain version here) or the send and receive (``"xla"``)."""
    n = MESHES[mesh]["sp"]
    for info, _ in runs[mesh]:
        idx = info["coords"]["sp"]
        for engine, hop, kv in MAKER_CASES:
            tag = f"ring_{engine}_{hop}_kv{kv}"
            want = [1 + idx] * 2 if engine == "flash" else [0, 0]
            assert info["calls"][tag] == want, (tag, info["calls"][tag])
            hops = 4 * (n - 1)
            assert info["hops"][tag] == [hops if hop == "pallas" else 0,
                                         hops]


def shifted(runs, mesh: str, way: str) -> tuple:
    """``(got, sent)``: each rank's shifted leaves (rank order along the
    ring) and the leaves every rank sent, ``[n, ...]`` as the reference
    sees them (bf16 as its int16 view)."""
    n = MESHES[mesh]["sp"]
    ranks = [arrays for info, arrays in runs[mesh]
             if info["coords"].get("dp", 0) == 0]
    assert len(ranks) == n
    tree = handoff_tree(n)
    sent = {k: (v.view(torch.int16) if v.dtype == torch.bfloat16 else v)
            .numpy() for k, v in tree.items()}
    got = {k: np.stack([a[f"shift_{way}/{k}"] for a in ranks])
           for k in tree}
    return got, sent


@pytest.mark.parametrize("reverse", [False, True], ids=["right", "left"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_process_ici_shift_is_the_neighbours_block(runs, mesh, reverse):
    """Each leaf lands on the ring neighbour with its bytes and dtype as
    they were; every dp group's ring does the same."""
    way = "left" if reverse else "right"
    got, sent = shifted(runs, mesh, way)
    for k, g in got.items():
        assert g.dtype == sent[k].dtype
        np.testing.assert_array_equal(
            g, np.roll(sent[k], -1 if reverse else 1, axis=0))
    for info, arrays in runs[mesh]:
        if info["coords"].get("dp", 0):
            twin = runs[mesh][info["coords"]["sp"]][1]
            for k in sent:
                np.testing.assert_array_equal(arrays[f"shift_{way}/{k}"],
                                              twin[f"shift_{way}/{k}"])
        assert info["launches"][f"shift_{way}"] == 0


@pytest.mark.parametrize("reverse", [False, True], ids=["right", "left"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_process_ici_shift_matches_the_reference(runs, mesh, reverse):
    """Byte-equal to the reference's ``ici_shift`` of the same tree under
    ``shard_map`` over a ring of the same size (interpret mode)."""
    n = MESHES[mesh]["sp"]
    way = "left" if reverse else "right"
    got, _ = shifted(runs, mesh, way)
    tree = handoff_tree(n)
    jtree = {k: jb(v) if v.dtype == torch.bfloat16 else jnp.asarray(
        v.numpy()) for k, v in tree.items()}
    flat = {k: v.reshape(n * v.shape[1], *v.shape[2:])
            for k, v in jtree.items()}
    m = JMesh(np.array(jax.devices()[:n]), ("h",))
    fn = shard_map(lambda t: jkv.ici_shift(t, "h", reverse=reverse,
                                           interpret=True),
                   mesh=m, in_specs=P("h"), out_specs=P("h"))
    want = jax.jit(fn)(flat)
    for k, v in want.items():
        w = np.asarray(v).reshape(jtree[k].shape)
        if w.dtype == jnp.bfloat16:
            w = w.view(np.int16)
        np.testing.assert_array_equal(got[k], w)
