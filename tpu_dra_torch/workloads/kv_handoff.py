"""KV handoff, ported from ``tpu_dra/workloads/kv_handoff.py``: one
prompt's paged KV moved from a prefill-pool engine to a decode-pool
engine (disaggregated serving).

A prefill replica's :class:`PrefillExporter` runs the engine's own paged
admission trunk once and packages the prompt's KV columns and its
last-position logits as a :class:`KVHandoff`; the wire form
(:func:`encode` / :func:`decode_blob`, schema ``tpu-kv-handoff/v1``)
travels over HTTP (serve.py ``/prefill`` → router → ``/decode_handoff``)
and a decode replica's ``ContinuousEngine.submit_handoff`` scatters the
columns into its own pages and selects the first token from the logits
with the request's own sampling state.  So a handoff decodes exactly the
tokens one engine would for the same request.

The wire format is the reference's, byte for byte: magic, a
length-prefixed JSON header, then the raw C-order arrays.  The port has
no ml_dtypes, so a bf16 array crosses as its ``int16`` view under the
wire name ``"bfloat16"`` (as ``tpu_dra_torch/convert.py`` carries bf16
leaves): a blob's bytes are the same whichever package wrote them, and
either package reads the other's.  KV travels bf16 whatever the pool
dtype; an int8 destination quantizes at page write, as its own prefill
does.

The reference's in-mesh fast path moves the page buffers one ICI hop
with its ``ring_shift``; here :func:`ici_shift` maps
``collective_matmul.ring_shift`` (the ring-shift kernel of
``csrc/ring.cu`` on the card, ``ring_shift_ref`` on the CPU) over
``[G, n, ...]`` blocks of the port's virtual ring, or, given a
``collective_matmul.ProcessRing``, over each process's own blocks (the
reference's per-device body, one process a rank).  Between engines
the handoff always crosses as its wire blob (:func:`transfer`, which
serializes on every ``via``, as the reference's does): no serving path
chooses the in-mesh hop.
"""

from __future__ import annotations

import base64
import binascii
import io
import json
import struct
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from tpu_dra_torch.device import resolve_device
from tpu_dra_torch.workloads.collective_matmul import ring_shift
from tpu_dra_torch.workloads.paged_kv import (
    last_position_logits,
    prefill_columns,
)
from tpu_dra_torch.workloads.train import ModelConfig

BLOB_SCHEMA = "tpu-kv-handoff/v1"
_MAGIC = b"TKVH"

# wire name -> the numpy dtype its bytes are read as (bf16 as its 16-bit
# pattern) and the torch dtype the array becomes
_DTYPES = {
    "bfloat16": (np.dtype(np.int16), torch.bfloat16),
    "float32": (np.dtype(np.float32), torch.float32),
    "int32": (np.dtype(np.int32), torch.int32),
}


def model_dims(cfg: ModelConfig) -> dict:
    """The model fingerprint a handoff carries: a decode engine refuses
    KV computed by another architecture (decoding it would be silent
    garbage, never an error)."""
    return {"vocab": cfg.vocab, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "n_layers": cfg.n_layers, "d_ff": cfg.d_ff,
            "pos_emb": cfg.pos_emb}


@dataclass
class KVHandoff:
    """One sequence's prefill result, addressed for page import.

    ``ks``/``vs``: ``[L, 1, Hkv, S_pad, Dh]`` bf16 CPU tensors, the
    page-granular KV columns a destination scatters into its pool
    (``S_pad`` is the prompt bucket padded to a page multiple; columns
    past ``length`` are causally dead).  ``last_logits``: the
    last-real-position logits ``[vocab]`` fp32, from which the decode
    engine selects the first token with its own sampling state."""

    prompt: list[int]
    length: int
    page_size: int
    model: dict
    ks: Any
    vs: Any
    last_logits: Any

    def pages(self) -> int:
        """Pages of KV content this handoff carries."""
        return -(-self.length // self.page_size)


def _shape(a) -> tuple:
    return tuple(a.shape) if torch.is_tensor(a) else np.asarray(a).shape


def as_cpu_tensor(a, dtype=None) -> torch.Tensor:
    """A tensor or numpy array as a CPU tensor (of ``dtype`` if given)."""
    t = a.detach().cpu() if torch.is_tensor(a) else torch.from_numpy(
        np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _to_wire(a, want: Optional[str] = None) -> tuple[str, np.ndarray]:
    """(wire dtype name, numpy array of the wire bytes) of a tensor or a
    numpy array; ``want`` casts first."""
    t = as_cpu_tensor(a, None if want is None else _DTYPES[want][1])
    for name, (np_dt, dt) in _DTYPES.items():
        if t.dtype == dt:
            if dt == torch.bfloat16:
                return name, t.contiguous().view(torch.int16).numpy()
            return name, t.contiguous().numpy()
    raise ValueError(f"unsupported handoff wire dtype {t.dtype}")


def encode(h: KVHandoff) -> bytes:
    """Serialize to the wire blob: magic + length-prefixed JSON header +
    raw C-order array bytes, self-describing (shapes and dtypes in the
    header)."""
    arrays = [("ks",) + _to_wire(h.ks), ("vs",) + _to_wire(h.vs),
              ("last_logits",) + _to_wire(h.last_logits, "float32")]
    header = {
        "schema": BLOB_SCHEMA,
        "prompt": list(h.prompt),
        "length": int(h.length),
        "page_size": int(h.page_size),
        "model": h.model,
        "arrays": [[name, list(a.shape), dt] for name, dt, a in arrays],
    }
    hdr = json.dumps(header).encode()
    buf = io.BytesIO()
    buf.write(_MAGIC)
    buf.write(struct.pack("<I", len(hdr)))
    buf.write(hdr)
    for _, _, a in arrays:
        buf.write(np.ascontiguousarray(a).tobytes())
    return buf.getvalue()


def decode_blob(data: bytes) -> KVHandoff:
    """Parse a wire blob back into a :class:`KVHandoff` of CPU tensors.
    Malformed input raises ``ValueError``: the HTTP layer turns it into
    a 400, never a crashed batcher."""
    if len(data) < 8 or data[:4] != _MAGIC:
        raise ValueError("not a KV-handoff blob (bad magic)")
    (hlen,) = struct.unpack("<I", data[4:8])
    if hlen <= 0 or 8 + hlen > len(data):
        raise ValueError("truncated KV-handoff header")
    try:
        header = json.loads(data[8:8 + hlen])
    except json.JSONDecodeError as exc:
        raise ValueError(f"bad KV-handoff header: {exc}") from None
    if not isinstance(header, dict):
        raise ValueError("bad KV-handoff header: not a JSON object")
    if header.get("schema") != BLOB_SCHEMA:
        raise ValueError(f"unknown handoff schema "
                         f"{header.get('schema')!r}")
    off = 8 + hlen
    out: dict[str, torch.Tensor] = {}
    for name, shape, dtype_name in header["arrays"]:
        dt = _DTYPES.get(dtype_name)
        if dt is None:
            raise ValueError(f"unknown wire dtype {dtype_name!r}")
        n = int(np.prod(shape)) * dt[0].itemsize
        if off + n > len(data):
            raise ValueError(f"truncated array {name!r}")
        a = np.frombuffer(data[off:off + n], dtype=dt[0]).reshape(shape)
        out[name] = torch.from_numpy(a.copy()).view(dt[1])
        off += n
    for need in ("ks", "vs", "last_logits"):
        if need not in out:
            raise ValueError(f"handoff blob missing array {need!r}")
    length = int(header["length"])
    prompt = [int(t) for t in header["prompt"]]
    if length != len(prompt) or length < 1:
        raise ValueError(f"handoff length {length} does not match "
                         f"prompt ({len(prompt)} tokens)")
    if out["ks"].shape != out["vs"].shape or out["ks"].dim() != 5:
        raise ValueError(f"handoff KV shapes disagree: "
                         f"{tuple(out['ks'].shape)} vs "
                         f"{tuple(out['vs'].shape)}")
    return KVHandoff(prompt=prompt, length=length,
                     page_size=int(header["page_size"]),
                     model=dict(header["model"]),
                     ks=out["ks"], vs=out["vs"],
                     last_logits=out["last_logits"])


def validate_handoff(handoff: Any, cfg: ModelConfig, pool: Any,
                     max_len: int, steps: int,
                     eos_id: Optional[int] = None) -> None:
    """Reject a handoff the target engine cannot decode: ``ValueError``
    with the message the HTTP layer turns into a 400.

    The trust boundary of a KV import: a malformed blob must fail here,
    on the submitting caller's thread, because past this point its pages
    reach the scatter on the batcher thread, where a shape lie fails
    every request of the engine (one crafted request would be a dead
    replica).  Checks: type, producing model, page geometry, the k/v
    shapes against the target model's layout, the logits' shape, the
    step and eos bounds, and the pool's capacity."""
    if not isinstance(handoff, KVHandoff):
        raise ValueError(f"handoff must be a KVHandoff, got "
                         f"{type(handoff).__name__}")
    mine = model_dims(cfg)
    if handoff.model != mine:
        raise ValueError(
            f"handoff was prefilled by a different model "
            f"({handoff.model} != {mine}); decoding its pages "
            f"would be silent garbage")
    if handoff.page_size != pool.page_size:
        raise ValueError(
            f"handoff page_size {handoff.page_size} != engine "
            f"page_size {pool.page_size}")
    ks_shape, vs_shape = _shape(handoff.ks), _shape(handoff.vs)
    if ks_shape != vs_shape:
        raise ValueError(
            f"handoff k/v shapes disagree: {ks_shape} vs {vs_shape}")
    want = (cfg.n_layers, 1, cfg.kv_heads)
    if len(ks_shape) != 5 or ks_shape[:3] != want or \
            ks_shape[4] != cfg.d_head:
        raise ValueError(
            f"handoff KV shape {ks_shape} does not match this "
            f"model's [L={cfg.n_layers}, 1, Hkv={cfg.kv_heads}, "
            f"S_pad, Dh={cfg.d_head}] layout")
    s_pad = ks_shape[3]
    if s_pad % handoff.page_size or s_pad < handoff.length:
        raise ValueError(
            f"handoff KV columns {s_pad} must be a page multiple "
            f"covering length {handoff.length}")
    logits_shape = _shape(handoff.last_logits)
    if logits_shape != (cfg.vocab,):
        raise ValueError(
            f"handoff last_logits shape {logits_shape} != "
            f"({cfg.vocab},)")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if eos_id is not None and not 0 <= eos_id < cfg.vocab:
        raise ValueError(f"eos_id must be in [0, {cfg.vocab})")
    if handoff.length + steps > max_len:
        raise ValueError(
            f"handoff length {handoff.length} + steps {steps} "
            f"exceeds the engine's max_len {max_len}")
    if pool.pages_for(handoff.length + steps) > pool.total_pages:
        raise ValueError(
            f"handoff needs "
            f"{pool.pages_for(handoff.length + steps)} KV "
            f"pages but the pool only has {pool.total_pages}")


def peek_prompt_len(blob_b64: str) -> Optional[int]:
    """The prompt length from a base64 wire blob without decoding the
    arrays: the admission gate prices /decode_handoff from the blob
    itself, never from a field the client asserts.  Decodes just enough
    base64 to read the length-prefixed JSON header.  ``None``: not a
    parseable blob (the request 400s downstream anyway); never raises."""
    try:
        head = base64.b64decode(blob_b64[:16], validate=True)
        if len(head) < 8 or head[:4] != _MAGIC:
            return None
        (hlen,) = struct.unpack("<I", head[4:8])
        if not 0 < hlen <= 1 << 20:
            return None
        need_chars = -(-(8 + hlen) // 3) * 4
        prefix = base64.b64decode(blob_b64[:need_chars + 4], validate=True)
        header = json.loads(prefix[8:8 + hlen])
        return max(1, int(header["length"]))
    except (binascii.Error, TypeError, ValueError, KeyError,
            json.JSONDecodeError):
        return None


# --------------------------------------------------------------------------
# Prefill side
# --------------------------------------------------------------------------


class PrefillExporter:
    """The prefill pool's half: one prompt's KV and last-position logits,
    packaged for export.

    Runs the engine's paged admission of one prompt through the same
    three pieces the engine uses: ``continuous.prompt_bucket`` (the
    prompt bucket clamped to ``max_len``), ``paged_kv.prefill_columns``
    (page padding and the trunk) and ``paged_kv.last_position_logits``
    (the head on the last real position), so the exported columns are
    the bits a local admission of the prompt writes.  Runs on ``device``
    (default: the card)."""

    def __init__(self, cfg: ModelConfig, params, *, page_size: int,
                 max_len: Optional[int] = None, device=None) -> None:
        if page_size < 1 or page_size & (page_size - 1):
            raise ValueError(f"page_size must be a power of two, got "
                             f"{page_size}")
        from tpu_dra_torch.workloads.continuous import _to_device
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.page_size = page_size
        self.max_len = max_len or cfg.max_seq
        self._dims = model_dims(cfg)

    def export(self, prompt: list[int]) -> KVHandoff:
        from tpu_dra_torch.workloads.continuous import (
            padded_prompts,
            prompt_bucket,
        )
        cfg = self.cfg
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if any(t < 0 or t >= cfg.vocab for t in prompt):
            raise ValueError(f"token ids must be in [0, {cfg.vocab})")
        if len(prompt) > self.max_len:
            raise ValueError(f"prompt {len(prompt)} exceeds max_len "
                             f"{self.max_len}")
        prompts, lengths = padded_prompts(
            [list(prompt)], prompt_bucket(len(prompt), self.max_len),
            self.device)
        with torch.no_grad():
            ks, vs, x = prefill_columns(cfg, self.params, prompts,
                                        self.page_size)
            logits = last_position_logits(self.params, x, lengths)
        return KVHandoff(prompt=list(prompt), length=len(prompt),
                         page_size=self.page_size, model=self._dims,
                         ks=ks.to(torch.bfloat16).cpu(),
                         vs=vs.to(torch.bfloat16).cpu(),
                         last_logits=logits[0].float().cpu())


# --------------------------------------------------------------------------
# The in-mesh path
# --------------------------------------------------------------------------


def ici_shift(tree, reverse: bool = False, ring=None):
    """Move KV buffers one ring hop: every tensor leaf of ``tree`` (a
    tensor, or a dict, list or tuple of them) lands at rank r + 1 of its
    ring (``reverse``: r − 1).  Without ``ring`` a leaf is a ``[G, n,
    ...]`` block of the virtual ring and goes through
    ``collective_matmul.ring_shift``; with ``ring`` (a
    ``collective_matmul.ProcessRing``) a leaf is this process's block, as
    in the reference's per-device body (353-368), and goes through
    ``ring.ring_shift``.  Either way: the ring-shift kernel on the card
    (one launch a leaf), its plain version on the CPU; any dtype, the
    bytes moved as they are."""
    if isinstance(tree, dict):
        return {k: ici_shift(v, reverse, ring) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(ici_shift(v, reverse, ring) for v in tree)
    return ring_shift(tree, reverse) if ring is None else \
        ring.ring_shift(tree, reverse)



def ici_supported() -> bool:
    """True when the in-mesh page hop can run between engines: CUDA with
    more than one card (the reference's gate, 342-351, asks for a TPU
    backend with more than one device).  On one card, or without CUDA,
    everything takes the wire path."""
    return torch.cuda.is_available() and torch.cuda.device_count() > 1


def transfer(h: KVHandoff, *, via: str = "auto") -> bytes:
    """The one entry point of the router and serve layers (the
    reference's ``transfer``, 371-385): ``via="wire"`` serializes;
    ``"ici"`` is reserved for engines that share a mesh, and ``"auto"``
    picks it where :func:`ici_supported`; until engines in different
    processes share the ring, every ``via`` serializes (:func:`encode`),
    as the reference does.  Any other ``via`` raises ``ValueError``."""
    if via not in ("wire", "ici", "auto"):
        raise ValueError(f"via must be wire|ici|auto, got {via!r}")
    return encode(h)
