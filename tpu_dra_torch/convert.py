"""Carry parameter trees between the JAX package and the port.

The JAX model's parameters are a nested dict of arrays.  As numpy (e.g.
``jax.tree.map(np.asarray, params)`` on a machine with JAX) the fp32
leaves are plain ``float32`` arrays and the bf16 leaves are ml_dtypes
``bfloat16`` arrays, which torch cannot read directly: they cross as an
``int16`` view and are reinterpreted as ``torch.bfloat16``.

Serving trees cross too (``quant.py``): int8 leaves ``{"q8", "s"}`` as
they are (``q8`` laid out column-major on arrival, the layout the card's
int8 product takes), int4 leaves ``{"q4", "s4"}`` with the reference's
ml_dtypes ``int4`` values widened to int8 (``astype`` needs no ml_dtypes
import), LoRA leaves ``{"base", "a", "b", "scale"}`` as nested dicts.  So
do the MoE model's trees (``moe.init_moe_params``: ``[L, E, D, F]``
expert banks) and LoRA adapter trees (``lora.init_lora``: ``{"blocks":
{name: {"a", "b"}}}``), leaf for leaf.

This is how a JAX checkpoint reaches the port: the port's checkpoints
(``workloads/checkpointing.py``) are its own format, and neither package
reads the other's directories.

``save_npz``/``load_npz`` store such a tree in one ``.npz`` with
``/``-joined keys (``blocks/wqkv``, ``blocks/wqkv/q8``), bf16 leaves
under a ``bf16:`` prefix as their raw 16-bit patterns — readable without
ml_dtypes.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_dra_torch.device import resolve_device
from tpu_dra_torch.workloads.quant import column_major

_BF16_TAG = "bf16:"


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def _widen_int4(a: np.ndarray) -> np.ndarray:
    """ml_dtypes ``int4`` values (the reference's ``q4``) as int8."""
    return a.astype(np.int8) if a.dtype.name == "int4" else a


def _placed(key: str, t: torch.Tensor, dev) -> torch.Tensor:
    t = t.to(dev)
    return column_major(t) if key == "q8" else t


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One numpy leaf → tensor on ``device`` (default: the card; see
    :func:`resolve_device`), bf16 via its 16-bit pattern, int4 widened to
    int8."""
    a = _widen_int4(np.array(a))    # a writable, contiguous copy
    if _is_bf16(a):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def params_from_numpy(tree, device=None):
    """Nested dict of numpy arrays (the JAX parameter tree, plain or
    serving) → nested dict of tensors on ``device`` (default: the
    card)."""
    dev = resolve_device(device)
    return {k: params_from_numpy(v, dev) if isinstance(v, dict)
            else _placed(k, tensor_from_numpy(v, dev), dev)
            for k, v in tree.items()}


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if "/" in k:
            raise ValueError(f"parameter name {k!r} contains '/'")
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, key + "/")
        else:
            yield key, v


def save_npz(path, tree) -> None:
    """Write a parameter tree (numpy arrays, ml_dtypes bf16 allowed, or
    tensors) to ``path`` as one npz with ``/``-joined keys."""
    flat = {}
    for key, leaf in _flatten(tree):
        if torch.is_tensor(leaf):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                flat[_BF16_TAG + key] = leaf.view(torch.int16).numpy()
                continue
            leaf = leaf.numpy()
        leaf = _widen_int4(np.asarray(leaf))
        if _is_bf16(leaf):
            flat[_BF16_TAG + key] = leaf.view(np.int16)
        else:
            flat[key] = leaf
    np.savez(path, **flat)


def load_npz(path, device=None) -> dict:
    """Read a tree written by :func:`save_npz` into tensors on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    tree: dict = {}
    with np.load(path) as data:
        for name in data.files:
            arr = data[name]
            bf16 = name.startswith(_BF16_TAG)
            key = name[len(_BF16_TAG):] if bf16 else name
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if bf16:
                t = t.view(torch.bfloat16)
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = _placed(leaf, t, dev)
    return tree
