"""The ring kernels across processes (``collective_matmul.ProcessRing``):
2 and 4 gloo processes on the CPU, started as ``launcher.run_local_group``
starts a group (each through ``resolve`` and
``RendezvousInfo.initialize``, the children in
tests/torch_process_child.py), run the group plain versions and the
group VJPs, forward and backward, on the same seeded global inputs; each
rank's results are held to rank r's slice of the virtual ring's plain
versions (``all_gather_matmul_ref``, ``matmul_reduce_scatter_ref``,
``ring_shift_ref`` and the virtual ``AllGatherMatmul``,
``MatmulReduceScatter``, ``RingShift``), and at n = 4 to the reference's
interpreted Pallas ring kernels under ``shard_map`` on host devices.

Tolerances.  Products within ``collective_matmul.ELEM_TOL`` (2^-6,
relative plus absolute: bf16 results of fp32 sums that may run in
another order); the gathered operand, the shift and the shift's
cotangent are copies: byte-equal.  On the CPU no kernel launches.
"""

from __future__ import annotations

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

from torch_parity import f32
from torch_process_child import AG_CASES, ring_inputs

from tpu_dra.workloads.pallas_kernels import (_ag_matmul_call,
                                              matmul_reduce_scatter,
                                              ring_shift)
from tpu_dra.workloads.ring_attention import shard_map
from tpu_dra_torch.workloads import collective_matmul as cm
from tpu_dra_torch.workloads.launcher import run_local_group

TOL = cm.ELEM_TOL
CHILD = Path(__file__).resolve().parent / "torch_process_child.py"
REPO = CHILD.parent.parent
# seconds a group of children may take (each is a few seconds)
WAIT = 240
SIZES = (2, 4)


def close(got, want):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = TOL + TOL * np.abs(want)
    assert np.all(np.abs(got - want) <= bound), \
        float((np.abs(got - want) / bound).max())


def same(got, want):
    np.testing.assert_array_equal(f32(got), f32(want))


def run_group(out: Path, n: int, device: str = "cpu") -> list:
    """The children's results, one dict a rank."""
    run_local_group([sys.executable, str(CHILD), "ring", str(out), device],
                    n, timeout=WAIT, cwd=str(REPO),
                    env=dict(os.environ, PYTHONPATH=str(REPO)))
    ranks = []
    for r in range(n):
        with np.load(out / f"rank{r}.npz") as data:
            ranks.append({k: data[k] for k in data.files})
    return ranks


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return {n: run_group(tmp_path_factory.mktemp(f"ring{n}"), n)
            for n in SIZES}


@pytest.mark.parametrize("case", sorted(AG_CASES))
@pytest.mark.parametrize("n", SIZES)
def test_group_all_gather_matmul_matches_the_virtual_ring(groups, n, case):
    """y within ELEM_TOL, the gathered operand byte-equal; the Function's
    y is the wrapper's."""
    g = ring_inputs(n)
    y, a = cm.all_gather_matmul_ref(g[f"ag_{case}_x"][None],
                                    g[f"ag_{case}_w"][None])
    for r, got in enumerate(groups[n]):
        close(got[f"ag_{case}_y"], y[0, r])
        same(got[f"ag_{case}_a"], a[0, r])
        same(got[f"ag_{case}_y_fn"], got[f"ag_{case}_y"])


@pytest.mark.parametrize("case", sorted(AG_CASES))
@pytest.mark.parametrize("n", SIZES)
def test_group_all_gather_matmul_vjp_matches_the_virtual_ring(groups, n,
                                                             case):
    g = ring_inputs(n)
    x = g[f"ag_{case}_x"][None].clone().requires_grad_()
    w = g[f"ag_{case}_w"][None].clone().requires_grad_()
    y = cm.AllGatherMatmul.apply(x, w)
    dx, dw = torch.autograd.grad(y, (x, w), g[f"ag_{case}_cot"][None])
    for r, got in enumerate(groups[n]):
        close(got[f"ag_{case}_dx"], dx[0, r])
        close(got[f"ag_{case}_dw"], dw[0, r])


@pytest.mark.parametrize("n", SIZES)
def test_group_matmul_reduce_scatter_matches_the_virtual_ring(groups, n):
    g = ring_inputs(n)
    y = cm.matmul_reduce_scatter_ref(g["rs_x"][None], g["rs_w"][None])
    x = g["rs_x"][None].clone().requires_grad_()
    w = g["rs_w"][None].clone().requires_grad_()
    dx, dw = torch.autograd.grad(cm.MatmulReduceScatter.apply(x, w), (x, w),
                                 g["rs_cot"][None])
    for r, got in enumerate(groups[n]):
        close(got["rs_y"], y[0, r])
        close(got["rs_dx"], dx[0, r])
        close(got["rs_dw"], dw[0, r])


@pytest.mark.parametrize("reverse", [False, True], ids=["right", "left"])
@pytest.mark.parametrize("n", SIZES)
def test_group_ring_shift_is_the_virtual_shift_byte_for_byte(groups, n,
                                                            reverse):
    """The shift and its cotangent (shifted the other way) are copies."""
    g = ring_inputs(n)
    tag = "left" if reverse else "right"
    y = cm.ring_shift_ref(g["shift_x"][None], reverse)
    x = g["shift_x"][None].float().requires_grad_()
    (dx,) = torch.autograd.grad(cm.RingShift.apply(x, reverse), x,
                                g["shift_cot"][None].float())
    for r, got in enumerate(groups[n]):
        same(got[f"shift_{tag}"], y[0, r])
        same(got[f"shift_{tag}_plain"], y[0, r])
        same(got[f"shift_{tag}_dx"], dx[0, r])


@pytest.mark.parametrize("n", SIZES)
def test_group_plain_versions_launch_no_kernel_on_the_cpu(groups, n):
    for got in groups[n]:
        assert got["launches"].tolist() == [0, 0, 0]


def jmesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("x",))


def jb(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("case", sorted(AG_CASES))
def test_group_gather_matches_the_interpreted_reference_kernel(groups, case):
    """n = 4: each rank's y and gathered a against the reference's
    ``_ag_matmul_call`` (odd m: its unidirectional ring; even m: the
    bidirectional one) under ``shard_map``."""
    n = 4
    g = ring_inputs(n)
    m, K, _ = AG_CASES[case]

    def f(xs, ws):
        y, a = _ag_matmul_call(xs, ws[0], "x", True)
        return y[None], a[None]
    y_ref, a_ref = jax.jit(shard_map(
        f, mesh=jmesh(n), in_specs=(P("x", None), P("x", None, None)),
        out_specs=(P("x", None, None),) * 2))(
        jb(g[f"ag_{case}_x"].reshape(n * m, K)), jb(g[f"ag_{case}_w"]))
    for r, got in enumerate(groups[n]):
        close(got[f"ag_{case}_y"], np.asarray(y_ref[r], np.float32))
        same(got[f"ag_{case}_a"].reshape(n * m, K),
             np.asarray(a_ref[r], np.float32))


def test_group_reduce_scatter_and_shift_match_the_interpreted_kernels(
        groups):
    n = 4
    g = ring_inputs(n)

    def f(xs, ws):
        return matmul_reduce_scatter(xs[0], ws[0], "x", True)
    y_ref = jax.jit(shard_map(f, mesh=jmesh(n),
                              in_specs=(P("x", None, None),) * 2,
                              out_specs=P("x", None)))(
        jb(g["rs_x"]), jb(g["rs_w"]))
    m = g["rs_x"].shape[1] // n
    for reverse in (False, True):
        x = g["shift_x"]
        s_ref = jax.jit(shard_map(
            lambda v: ring_shift(v, "x", reverse, True), mesh=jmesh(n),
            in_specs=P("x", None, None), out_specs=P("x", None, None)))(
            jb(x.reshape(n * x.shape[1], *x.shape[2:])))
        tag = "left" if reverse else "right"
        for r, got in enumerate(groups[n]):
            same(got[f"shift_{tag}"],
                 np.asarray(s_ref, np.float32).reshape(x.shape)[r])
    for r, got in enumerate(groups[n]):
        close(got["rs_y"], np.asarray(y_ref[r * m:(r + 1) * m], np.float32))
