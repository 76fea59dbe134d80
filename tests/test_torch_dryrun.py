"""The port's ``dryrun_multichip`` (tpu_dra_torch/entry.py) on the CPU, and
its mesh constructors (tpu_dra_torch/workloads/collectives.py) against
the reference's: the dry run runs every lane at 1, 2 and 4 ranks, its
last line is ``MULTICHIP_REPORT {json}`` with the reference's seven
strategy names (read from ``__graft_entry__.py``), no MFU on the CPU;
multislice meshes have the reference's axes and sizes, and refuse what
it refuses."""

from __future__ import annotations

import json
import re
from pathlib import Path

import jax
import pytest

from torch_parity import CPU

from tpu_dra.workloads import collectives as jcoll
from tpu_dra_torch.entry import dryrun_multichip
from tpu_dra_torch.workloads import collectives as tcoll

GRAFT = Path(__file__).resolve().parent.parent / "__graft_entry__.py"


def reference_strategies() -> set:
    """The names the reference's dry run times."""
    src = GRAFT.read_text()
    return set(re.findall(r'_time_strategy\(report, "(\w+)"', src))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_reports_the_reference_strategies(n, capsys):
    report = dryrun_multichip(n, device=CPU)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("MULTICHIP_REPORT ")
    printed = json.loads(lines[-1][len("MULTICHIP_REPORT "):])
    assert printed == json.loads(json.dumps(report))
    want = reference_strategies()
    assert len(want) == 7
    assert set(printed["strategies"]) == want
    assert printed["n_devices"] == n and printed["platform"] == "cpu"
    tp = max(c for c in range(1, min(n, 8) + 1) if n % c == 0)
    assert printed["mesh"] == {"dp": n // tp, "tp": tp}
    for entry in printed["strategies"].values():
        assert entry["step_ms"] > 0 and entry["tflops"] > 0
        assert "mfu_pct" not in entry


def test_dryrun_refuses_a_missing_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(4)


@pytest.mark.parametrize("slices,n,tp", [(2, 8, 2), (2, 4, 1), (4, 8, 2),
                                         (1, 8, 4)])
def test_multislice_mesh_matches_the_reference(slices, n, tp):
    want = jcoll.make_multislice_mesh(slices, jax.devices()[:n], tp=tp)
    got = tcoll.make_multislice_mesh(slices, n, tp=tp, device=CPU)
    assert got.axis_names == tuple(want.axis_names) == ("dcn", "dp", "tp")
    assert got.shape == tuple(want.devices.shape)
    assert got.batch_axes() == ("dcn", "dp")


def test_multislice_mesh_refusals_match_the_reference():
    for args, kw, match in (((3, 8), {}, "equal slices"),
                            ((2, 8), {"tp": 3}, "does not divide")):
        with pytest.raises(ValueError, match=match):
            jcoll.make_multislice_mesh(args[0], jax.devices()[:args[1]],
                                       **kw)
        with pytest.raises(ValueError, match=match):
            tcoll.make_multislice_mesh(*args, device=CPU, **kw)


def test_make_mesh_is_one_axis():
    want = jcoll.make_mesh(jax.devices()[:4], axis="sp")
    got = tcoll.make_mesh(4, axis="sp", device=CPU)
    assert got.axes == dict(zip(want.axis_names, want.devices.shape))
