"""``tpu_dra_torch.entry.entry`` against ``__graft_entry__.entry``: the
reference's parameters, carried across through ``convert.py``, give the
port's forward the reference's logits within the bf16 tolerance of
``torch_parity.logit_tol``; the port's own example arguments have the
reference's shapes and dtypes; and the entry runs on the card unless asked
for the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_parity import f32, logit_tol, to_torch

import __graft_entry__
from tpu_dra_torch.entry import entry


def test_entry_gives_the_reference_logits():
    jfn, (jparams, jtokens) = __graft_entry__.entry()
    fn, (params, tokens) = entry(device="cpu")
    want = np.asarray(jfn(jparams, jtokens), np.float32)
    got = f32(fn(to_torch(jparams), tokens))
    assert got.shape == want.shape == (2, 64, 256)
    assert np.all(np.abs(got - want) <= logit_tol(np.max(want, axis=-1))[
        ..., None])


def test_entry_arguments_have_the_reference_form():
    _, (jparams, jtokens) = __graft_entry__.entry()
    fn, (params, tokens) = entry(device="cpu")
    assert tuple(tokens.shape) == tuple(jtokens.shape)
    assert tokens.dtype == torch.int32 and not tokens.any()
    want = {k: v.shape for k, v in to_torch(jparams).items()
            if torch.is_tensor(v)}
    assert {k: v.shape for k, v in params.items()
            if torch.is_tensor(v)} == want
    assert np.isfinite(f32(fn(params, tokens))).all()


def test_entry_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
