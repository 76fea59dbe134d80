"""Checkpoints and resume of the port, ported from
``tpu_dra/workloads/checkpointing.py``: train-state persistence, so a
training job survives a preemption, and serving-tree caches, so a server
quantizes once at deploy rather than at every start.

The reference writes orbax directories, which need JAX.  The port writes
its own format and reads only its own: each step is a directory
``<directory>/<step>/`` holding ``state.pt``, a ``torch.save`` of
``{"params": ..., "extra": ...}``, and the commit marker, written last.
A save builds the step in a staging directory ``<step>.tmp-<ns>``,
fsyncs the state file, the marker and the staging directory, then moves
it into place with ``os.replace`` and fsyncs ``<directory>``.  Reads are
``torch.load(..., weights_only=True)``.  A JAX checkpoint crosses through
``tpu_dra_torch.convert.save_npz`` (an npz of its parameter tree), and
neither package reads the other's directories: a committed step without
``state.pt`` (an orbax step) is refused with that pointer.

The reference's rules, kept:

- readers (:func:`latest_step`, :func:`restore_train_state`) skip an
  unmarked step directory and never delete it; only the saver sweeps
  them, always before it writes;
- staging directories are never selected and never touched;
- ``max_to_keep`` (default 3) prunes the oldest committed steps;
- a serving re-save lands as step N+1 and keeps one step, with the
  ``serving_meta.json`` sidecar;
- a missing directory raises ``FileNotFoundError``, and a read never
  creates it.

Not ported: the reference's ``goodput.measure`` hooks around each save
and restore (they come with the port of ``goodput.py``, ROADMAP.md queue
1 item 7) and its restore ``template`` (there are no shardings to land
on; ``device`` says where the tensors go).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any

import torch

from tpu_dra_torch.device import resolve_device
from tpu_dra_torch.workloads.quant import column_major

# the commit marker, written last into a step directory (orbax's name: an
# orbax step is committed too, and is then refused for its missing
# STATE_FILE rather than swept as a crash artifact)
_COMMIT_MARKER = "_CHECKPOINT_METADATA"
STATE_FILE = "state.pt"
# staging directories: the port's "<step>.tmp-<ns>" and orbax's
# "<step>.orbax-checkpoint-tmp-<ts>"
_TMP_MARKERS = (".tmp-", ".orbax-checkpoint-tmp")
SERVING_META = "serving_meta.json"
_FOREIGN = (f"holds no {STATE_FILE} written by tpu_dra_torch.workloads."
            f"checkpointing (an orbax checkpoint of the JAX package?); the "
            f"port reads only its own checkpoints: carry a JAX parameter "
            f"tree across with tpu_dra_torch.convert.save_npz and serve or "
            f"load the npz (--params-npz, convert.load_npz)")


def _complete_steps(directory: str, *, clean: bool = False) -> list[int]:
    """Sorted step numbers whose directories carry the commit marker.

    With ``clean=True``, bare numeric step directories *without* the
    marker are removed: the saver's privilege, since on a non-atomic
    store an unmarked directory cannot be told from another writer's
    save in progress, so readers only skip them.  Staging directories
    are skipped and never touched either way."""
    steps: list[int] = []
    try:
        entries = os.listdir(directory)
    except FileNotFoundError:
        return steps
    for entry in entries:
        path = os.path.join(directory, entry)
        if any(m in entry for m in _TMP_MARKERS) or not entry.isdigit() \
                or not os.path.isdir(path):
            continue
        if os.path.exists(os.path.join(path, _COMMIT_MARKER)):
            steps.append(int(entry))
        elif clean:
            shutil.rmtree(path, ignore_errors=True)
    return sorted(steps)


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _storable(tree):
    """``tree`` with every tensor leaf holding only its own elements:
    ``torch.save`` writes a view's whole storage (a truncated draft's
    blocks are views of the target's), so such a leaf is cloned, strides
    kept."""
    if isinstance(tree, dict):
        return {k: _storable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_storable(v) for v in tree)
    if torch.is_tensor(tree):
        t = tree.detach()
        if t.untyped_storage().nbytes() != t.numel() * t.element_size():
            t = t.clone()
        return t
    return tree


def _foreign_check(directory: str, steps: list[int]) -> None:
    for s in steps:
        path = os.path.join(directory, str(s))
        if not os.path.exists(os.path.join(path, STATE_FILE)):
            raise ValueError(f"checkpoint step {path} {_FOREIGN}")


def _write_step(directory: str, step: int, state: dict,
                max_to_keep: int) -> None:
    """Sweep, stage, commit, move into place, prune."""
    if os.path.isdir(directory):
        _foreign_check(directory, _complete_steps(directory, clean=True))
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(step))
    if os.path.exists(final):
        raise FileExistsError(f"checkpoint step {final} already exists")
    staging = f"{final}.tmp-{time.time_ns()}"
    os.makedirs(staging)
    state_path = os.path.join(staging, STATE_FILE)
    torch.save(_storable(state), state_path)
    _fsync(state_path)
    marker = os.path.join(staging, _COMMIT_MARKER)
    with open(marker, "w") as f:
        json.dump({"step": step, "format": "tpu_dra_torch/1"}, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync(staging)
    os.replace(staging, final)
    _fsync(directory)
    for old in _complete_steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)), ignore_errors=True)


def save_train_state(directory: str, step: int, params: Any,
                     extra: Any = None, *, max_to_keep: int = 3) -> None:
    """Persist ``params`` (and ``extra``, e.g. the optimizer state and the
    step, as dicts, lists, numbers and tensors) under ``directory`` as
    checkpoint ``step``; durable on return.  Raises ``FileExistsError``
    for a step already committed, ``ValueError`` for a directory that
    holds steps of another format."""
    state = {"params": params}
    if extra is not None:
        state["extra"] = extra
    _write_step(directory, step, state, max_to_keep)


def latest_step(directory: str) -> int | None:
    """Newest COMMITTED step in ``directory``, or None if empty or
    missing; an unmarked step (a save a crash cut) is never selected.
    Read-only: cleaning belongs to the saver."""
    if not os.path.isdir(directory):
        return None
    steps = _complete_steps(directory)
    return steps[-1] if steps else None


def save_serving_state(directory: str, params: Any,
                       meta: dict | None = None) -> None:
    """Persist a SERVING tree (bf16, int8 or int4 leaves) so quantization
    runs once at deploy.  One snapshot: a re-save lands as step N+1 and
    the old one is pruned.  ``meta`` (the weight form and model dims)
    lands in the ``serving_meta.json`` sidecar so a restore can check it
    serves what the operator asked for."""
    latest = latest_step(directory)
    _write_step(directory, 0 if latest is None else latest + 1,
                {"params": params}, max_to_keep=1)
    if meta is not None:
        tmp = os.path.join(directory, f"{SERVING_META}.tmp-{time.time_ns()}")
        with open(tmp, "w") as f:
            json.dump(meta, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(directory, SERVING_META))


def serving_meta(directory: str) -> dict | None:
    """The sidecar written by :func:`save_serving_state`, or None (missing
    directory, or a cache saved without meta)."""
    try:
        with open(os.path.join(directory, SERVING_META)) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def restore_serving_state(directory: str, *, device=None) -> Any:
    """The serving tree saved by :func:`save_serving_state`, on
    ``device`` (default: the card)."""
    try:
        return restore_train_state(directory, device=device)["params"]
    except FileNotFoundError:
        raise FileNotFoundError(
            f"no serving checkpoint under {directory}") from None


def _placed(tree, key: str = ""):
    """``q8`` leaves laid out column-major again (``convert._placed``):
    the card's int8 product takes that layout, and ``map_location``
    promises nothing about strides."""
    if isinstance(tree, dict):
        return {k: _placed(v, k) for k, v in tree.items()}
    return column_major(tree) if key == "q8" else tree


def restore_train_state(directory: str, *, step: int | None = None,
                        device=None) -> dict[str, Any]:
    """``{params[, extra]}`` of step ``step`` (default: the newest
    committed one) under ``directory``, every tensor on ``device``
    (default: the card)."""
    if not os.path.isdir(directory):
        # read path: never create a mistyped directory as a side effect
        raise FileNotFoundError(f"no checkpoints under {directory}")
    complete = _complete_steps(directory)
    if step is None:
        if not complete:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        step = complete[-1]
    elif step not in complete:
        raise FileNotFoundError(f"no committed checkpoint step {step} "
                                f"under {directory} (committed: "
                                f"{complete})")
    path = os.path.join(directory, str(step), STATE_FILE)
    if not os.path.exists(path):
        raise ValueError(f"checkpoint step {os.path.dirname(path)} "
                         f"{_FOREIGN}")
    state = torch.load(path, map_location=resolve_device(device),
                       weights_only=True)
    state["params"] = _placed(state["params"])
    return state
