"""Token-stream data pipeline of the port, copied from
``tpu_dra/workloads/data.py`` (23-166) without JAX: a memmap dataset,
deterministic batches cut from (step, rank) alone, and a prefetcher that
keeps batches in flight to the device.

``TokenDataset``, ``encode_bytes``, ``batch_index``, ``batches`` and
``pack_documents`` are the reference's numpy code.  ``device_prefetch``
takes a torch device in place of a JAX sharding: batches go through
pinned host tensors and ``non_blocking`` copies, so the copy of the next
batch overlaps the running step.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Iterator

import numpy as np
import torch


class TokenDataset:
    """Flat binary token file (little-endian integer dtype) as a sequence
    source.  ``len(ds)`` is the token count; slicing returns np arrays."""

    def __init__(self, path: str, dtype: str = "uint16"):
        self.path = path
        self.dtype = np.dtype(dtype)
        size = os.path.getsize(path)
        if size % self.dtype.itemsize:
            raise ValueError(
                f"{path}: size {size} not a multiple of {self.dtype}")
        self.tokens = np.memmap(path, dtype=self.dtype, mode="r")

    def __len__(self) -> int:
        return len(self.tokens)

    @staticmethod
    def write(path: str, tokens: np.ndarray, dtype: str = "uint16") -> None:
        """Helper for tests/tools: persist a 1-D token array."""
        np.asarray(tokens, dtype=np.dtype(dtype)).tofile(path)


def encode_bytes(text_path: str, out_path: str,
                 chunk_bytes: int = 64 << 20) -> int:
    """Byte-level tokenization: UTF-8 bytes ARE the tokens (vocab 256),
    streamed in ``chunk_bytes`` pieces.  Returns the token count."""
    total = 0
    with open(text_path, "rb") as src, open(out_path, "wb") as dst:
        while True:
            buf = src.read(chunk_bytes)
            if not buf:
                break
            np.frombuffer(buf, dtype=np.uint8).astype(np.uint16).tofile(dst)
            total += len(buf)
    return total


def batch_index(step: int, rank: int, batch: int, seq: int,
                n_tokens: int, world: int = 1) -> np.ndarray:
    """Start offsets for (step, rank): deterministic and disjoint across
    ranks within a step.  [batch] int64.

    The stream is cut into ``n_windows`` non-overlapping (seq+1)-token
    windows; a global window counter g = step·B·W + rank·B + i walks them
    mod n_windows.  Requires batch·world ≤ n_windows (validated) so the
    windows of one global step are always distinct.
    """
    n_windows = (n_tokens - 1) // seq
    per_step = batch * world
    if per_step > n_windows:
        raise ValueError(
            f"global batch {per_step} windows/step exceeds the dataset's "
            f"{n_windows} windows of seq {seq} — ranks would collide")
    g = step * per_step + rank * batch + np.arange(batch, dtype=np.int64)
    return (g % n_windows) * seq


def batches(ds: TokenDataset, *, batch: int, seq: int, rank: int = 0,
            world: int = 1, start_step: int = 0) -> Iterator[np.ndarray]:
    """Infinite iterator of ``[batch, seq+1]`` int32 windows (inputs and
    shifted targets come from the same window; the +1 is the shift).
    Deterministic from (step, rank, world): a run that starts at
    ``start_step`` sees exactly the batches an uninterrupted run would."""
    n = len(ds)
    if n < seq + 2:
        raise ValueError(f"dataset has {n} tokens < seq+2 {seq + 2}")
    step = start_step
    idx = np.arange(seq + 1, dtype=np.int64)
    while True:
        starts = batch_index(step, rank, batch, seq, n, world)
        yield np.asarray(ds.tokens[starts[:, None] + idx], dtype=np.int32)
        step += 1


def device_prefetch(it: Iterator[np.ndarray], device,
                    depth: int = 2) -> Iterator[torch.Tensor]:
    """Keep ``depth`` batches in flight to ``device``.  On a CUDA device
    each batch is copied from pinned host memory with ``non_blocking``,
    so issuing the next copy before yielding the current batch overlaps
    the transfer (and the host slicing) with the running step."""
    device = torch.device(device)
    pin = device.type == "cuda"
    buf: deque = deque()
    try:
        for arr in it:
            host = torch.from_numpy(arr)
            if pin:
                host = host.pin_memory()
            buf.append(host.to(device, non_blocking=pin))
            if len(buf) >= depth:
                yield buf.popleft()
        while buf:
            yield buf.popleft()
    finally:
        buf.clear()


def pack_documents(docs, seq: int):
    """Greedy first-fit packing of variable-length token documents into
    fixed [N, seq] rows.

    Returns ``(tokens, segment_ids, positions)`` int32 arrays of equal
    shape: segment ids number the documents within a row from 1 (0 =
    padding), positions restart at 0 per document.  Documents longer than
    ``seq`` are truncated.  Padding token id is 0.  ``train.packed_loss_fn``
    trains on them.
    """
    if seq < 1:
        raise ValueError(f"seq must be >= 1, got {seq}")
    rows: list[list[np.ndarray]] = []
    free: list[int] = []                 # remaining space per row
    for doc in docs:
        d = np.asarray(doc, np.int32).ravel()[:seq]
        if not len(d):
            continue
        for r, room in enumerate(free):
            if len(d) <= room:
                rows[r].append(d)
                free[r] -= len(d)
                break
        else:
            rows.append([d])
            free.append(seq - len(d))
    N = max(len(rows), 1)
    tokens = np.zeros((N, seq), np.int32)
    segs = np.zeros((N, seq), np.int32)
    pos = np.zeros((N, seq), np.int32)
    for r, parts in enumerate(rows):
        at = 0
        for s_id, part in enumerate(parts, start=1):
            tokens[r, at: at + len(part)] = part
            segs[r, at: at + len(part)] = s_id
            pos[r, at: at + len(part)] = np.arange(len(part))
            at += len(part)
    return tokens, segs, pos
