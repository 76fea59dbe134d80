"""Rules of the PyTorch port that hold for every module: it imports
neither JAX, optax nor the JAX package, entry points default to the card and
refuse to run without CUDA unless the caller asks for the CPU, and
parameter trees cross between the two packages intact."""

from __future__ import annotations

import ast
import importlib
import pkgutil
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import tpu_dra_torch
from tpu_dra_torch.convert import load_npz, params_from_numpy, save_npz
from tpu_dra_torch.device import resolve_device

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "tpu_dra_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "optax", "tpu_dra")


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_jax_package(path):
    assert path.exists(), path
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_port_module_imports_without_cuda_or_nvcc():
    names = [m.name for m in pkgutil.walk_packages(
        tpu_dra_torch.__path__, "tpu_dra_torch.")]
    assert "tpu_dra_torch.workloads.paged_kv" in names
    for name in names:
        importlib.import_module(name)


def test_without_cuda_entry_points_refuse_unless_asked_for_cpu(
        monkeypatch):
    from tpu_dra_torch.workloads.continuous import ContinuousEngine
    from tpu_dra_torch.workloads.train import ModelConfig, init_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = ModelConfig(vocab=32, d_model=32, n_heads=2, n_layers=1, d_ff=64,
                      max_seq=16)
    params = init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousEngine(cfg, params, slots=1, page_size=8)
    # the sharded steps run on a mesh's device: the card unless asked
    from tpu_dra_torch.workloads.mesh import Mesh
    with pytest.raises(RuntimeError, match="CUDA"):
        Mesh({"dp": 1, "tp": 2})
    assert Mesh({"dp": 1, "sp": 2}, device="cpu").device == \
        torch.device("cpu")
    eng = ContinuousEngine(cfg, params, slots=1, page_size=8, device="cpu")
    try:
        assert len(eng.submit([1, 2], 2, timeout=60)) == 2
    finally:
        eng.shutdown()


def test_params_cross_from_numpy_and_through_npz(tmp_path):
    r = np.random.default_rng(0)
    bf = r.standard_normal((3, 4)).astype(ml_dtypes.bfloat16)
    tree = {"embed": r.standard_normal((5, 4)).astype(np.float32),
            "blocks": {"wqkv": bf, "ln1": np.ones((2, 4), np.float32)}}
    got = params_from_numpy(tree, "cpu")
    assert got["blocks"]["wqkv"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["blocks"]["wqkv"].float().numpy(), bf.astype(np.float32))
    np.testing.assert_array_equal(got["embed"].numpy(), tree["embed"])
    path = tmp_path / "w.npz"
    save_npz(path, tree)
    back = load_npz(path, "cpu")
    assert sorted(back) == ["blocks", "embed"]
    for name in ("wqkv", "ln1"):
        assert torch.equal(back["blocks"][name], got["blocks"][name])
    # a tree of tensors (bf16 included) writes the same file layout
    save_npz(tmp_path / "t.npz", got)
    again = load_npz(tmp_path / "t.npz", "cpu")
    assert torch.equal(again["blocks"]["wqkv"], got["blocks"]["wqkv"])
