"""Packed sequences in the port (``train.packed_loss_fn``, the segment mask
of ``train._causal_dense_attention``, ``data.pack_documents``) against the
JAX reference on the same weights and packed rows, and the reference's
own oracles (``tests/test_packing.py``) run on the port.

Tolerances, as in test_torch_train_step.py: the loss within 5e-3
absolute and each gradient leaf within 3% relative L2 of the reference's
(bf16 trunks summing in different orders).  The isolated-document
oracles keep the reference test's bounds: trunk activations within 5e-2
absolute and the packed loss within 5e-2 of the token-weighted mean of
the documents' own losses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import cfg_pair, f32, jax_params, to_torch

from tpu_dra.workloads import data as jdata
from tpu_dra.workloads import train as jt
from tpu_dra_torch.workloads import data as tdata
from tpu_dra_torch.workloads import train as tt

LOSS_ATOL = 5e-3
LEAF_REL = 3e-2
ORACLE_ATOL = 5e-2

CFGS = {
    "learned": dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                    max_seq=32),
    "rope": dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                 max_seq=32, pos_emb="rope"),
    "rope-gqa": dict(vocab=64, d_model=64, n_heads=4, n_kv_heads=2,
                     n_layers=2, d_ff=128, max_seq=32, pos_emb="rope"),
}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = f32(v)
    return out


def docs(seed: int, lengths, vocab: int) -> list:
    r = np.random.default_rng(seed)
    return [r.integers(1, vocab, n).astype(np.int32) for n in lengths]


def packed(seed: int, vocab: int, seq: int = 17):
    """Documents of 3-11 tokens packed first-fit into rows of ``seq``
    (the trunk reads seq − 1 of them)."""
    return jdata.pack_documents(
        docs(seed, [5, 11, 3, 7, 9, 4, 6, 10], vocab), seq=seq)


@pytest.mark.parametrize("head", ["dense", "chunked"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_packed_loss_and_grads_match_reference(name, head):
    jcfg, tcfg = cfg_pair(**CFGS[name])
    params = jax_params(jcfg)
    toks, segs, pos = packed(0, jcfg.vocab)
    want_loss, want = jax.value_and_grad(
        lambda p: jt.packed_loss_fn(jcfg, p, jnp.asarray(toks),
                                    jnp.asarray(segs), jnp.asarray(pos),
                                    head_impl=head))(params)
    got_loss, got = tt.value_and_grad(
        lambda p: tt.packed_loss_fn(tcfg, p, torch.from_numpy(toks),
                                    torch.from_numpy(segs),
                                    torch.from_numpy(pos), head_impl=head),
        to_torch(params))
    assert abs(float(got_loss) - float(want_loss)) < LOSS_ATOL
    want, got = flat(want), flat(got)
    assert sorted(got) == sorted(want)
    for leaf in want:
        rel = np.linalg.norm(got[leaf] - want[leaf]) / np.linalg.norm(
            want[leaf])
        assert rel < LEAF_REL, (leaf, rel)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_packed_trunk_matches_isolated_docs(name):
    """Activations at each document's positions inside a packed row equal
    the document run alone (the reference's oracle)."""
    jcfg, tcfg = cfg_pair(**CFGS[name])
    params = to_torch(jax_params(jcfg))
    a, b = docs(1, [6, 5], tcfg.vocab)
    toks, segs, pos = tdata.pack_documents([a, b], seq=16)
    with torch.no_grad():
        row = tt._trunk(tcfg, params, torch.from_numpy(toks),
                        segment_ids=torch.from_numpy(segs),
                        positions=torch.from_numpy(pos))
        for doc, at in ((a, 0), (b, len(a))):
            alone = tt._trunk(tcfg, params, torch.from_numpy(doc)[None])
            np.testing.assert_allclose(f32(row[0, at:at + len(doc)]),
                                       f32(alone[0]), atol=ORACLE_ATOL)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_packed_loss_matches_isolated_losses(name):
    """The packed mean NLL is the token-weighted mean of the documents'
    own losses (the reference's oracle)."""
    jcfg, tcfg = cfg_pair(**CFGS[name])
    params = to_torch(jax_params(jcfg))
    a, b = docs(3, [8, 6], tcfg.vocab)
    toks, segs, pos = tdata.pack_documents([a, b], seq=16)
    with torch.no_grad():
        got = float(tt.packed_loss_fn(tcfg, params, torch.from_numpy(toks),
                                      torch.from_numpy(segs),
                                      torch.from_numpy(pos)))
        la = float(tt.loss_fn(tcfg, params, torch.from_numpy(a)[None]))
        lb = float(tt.loss_fn(tcfg, params, torch.from_numpy(b)[None]))
    na, nb = len(a) - 1, len(b) - 1
    assert abs(got - (la * na + lb * nb) / (na + nb)) < ORACLE_ATOL


@pytest.mark.parametrize("lengths,seq", [
    ([4, 3, 6], 8), ([12, 8, 4, 8], 16), ([20, 1, 2, 30, 5, 5, 9], 16),
    ([], 4)])
def test_pack_documents_matches_reference(lengths, seq):
    d = docs(7, lengths, 50)
    for got, want in zip(tdata.pack_documents(d, seq),
                         jdata.pack_documents(d, seq)):
        np.testing.assert_array_equal(got, want)


def test_packed_trunk_refuses_flash():
    _, tcfg = cfg_pair(**CFGS["rope"])
    params = to_torch(jax_params(jt.ModelConfig(**CFGS["rope"])))
    toks, segs, pos = tdata.pack_documents([np.arange(1, 8)], seq=8)
    with pytest.raises(NotImplementedError, match="dense attention"):
        tt._trunk(tcfg, params, torch.from_numpy(toks),
                  attn_fn=tt.attn_impl_fn("flash"),
                  segment_ids=torch.from_numpy(segs),
                  positions=torch.from_numpy(pos))


def test_packed_learned_pos_overflow_raises():
    jcfg, tcfg = cfg_pair(vocab=64, d_model=32, n_heads=2, n_layers=1,
                          d_ff=64, max_seq=8)
    params = to_torch(jax_params(jcfg))
    toks, segs, pos = tdata.pack_documents(
        [np.arange(1, 8), np.arange(1, 8)], seq=16)
    with pytest.raises(ValueError, match="position table"):
        tt._trunk(tcfg, params, torch.from_numpy(toks),
                  segment_ids=torch.from_numpy(segs),
                  positions=torch.from_numpy(pos))


def test_packed_loss_trains():
    """SGD through the packed loss descends (the reference's test)."""
    jcfg, tcfg = cfg_pair(**CFGS["learned"])
    params = to_torch(jax_params(jcfg))
    toks, segs, pos = (torch.from_numpy(t) for t in tdata.pack_documents(
        docs(5, [7] * 6, tcfg.vocab), seq=16))
    losses = []
    for _ in range(6):
        loss, grads = tt.value_and_grad(
            lambda p: tt.packed_loss_fn(tcfg, p, toks, segs, pos), params)
        params = tt.tree_unflatten(params, [
            w - 0.5 * g for w, g in zip(tt.tree_leaves(params),
                                        tt.tree_leaves(grads))])
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
