"""The trunk's rematerialization (``train.remat``): on the one-device
and DP×TP trunks the stretches between the weight products (the
reference's selective policy, which keeps the products), full remat of
each block on the DP×SP ring step.

Counted on the CPU through the plain versions the kernel wrappers take
there: a training step runs the flash forward twice a layer (once more
when the backward recomputes the block) and each flash backward once;
the RMSNorm-matmul and the ring matmuls once per sublayer (their outputs
are kept); no weight product (``aten::mm``) runs again; the ring step
recomputes its kv hops.  Remat changes no value: a step's loss and
gradients are bit-equal to the same step with :func:`train.remat`
monkeypatched away, and the reference tests of the step
(test_torch_train_step.py, test_torch_sharded_train.py,
test_torch_ring_attention.py) hold it to the reference.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_parity import CPU, cfg_pair, jax_params, to_torch

from tpu_dra_torch.workloads import collective_matmul as cm
from tpu_dra_torch.workloads import flash as tf
from tpu_dra_torch.workloads import matmul as tm
from tpu_dra_torch.workloads import ring_attention as tra
from tpu_dra_torch.workloads import train as tt
from tpu_dra_torch.workloads.mesh import Mesh

CFG = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=256,
           max_seq=32)


def no_remat(fn, *args):
    return fn(*args)


def counting(monkeypatch, module, names) -> dict:
    """Wrap ``module.<name>`` for each name to count its calls."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        real = getattr(module, name)

        def counted(*a, _name=name, _real=real, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(module, name, counted)
    return calls


class CountMM(TorchDispatchMode):
    """Counts the ``aten::mm`` calls that run (a remat policy that hands
    back a kept output runs none)."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.name() == "aten::mm":
            self.mm += 1
        return func(*args, **(kwargs or {}))


def setup(seed: int = 0, batch: int = 2):
    jcfg, tcfg = cfg_pair(**CFG)
    params = to_torch(jax_params(jcfg))
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, tcfg.vocab, (batch, tcfg.max_seq + 1)))
    return tcfg, params, toks


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_flash_step_runs_the_forward_twice_a_layer(remat, monkeypatch):
    cfg, params, toks = setup()
    if not remat:
        monkeypatch.setattr(tt, "remat", no_remat)
    calls = counting(monkeypatch, tf, ["flash_attn_fwd_ref",
                                       "flash_bwd_dq_ref",
                                       "flash_bwd_dkdv_ref"])
    tt.grads_fn(cfg, params, toks, attn_impl="flash")
    L = cfg.n_layers
    assert calls == {"flash_attn_fwd_ref": (2 if remat else 1) * L,
                     "flash_bwd_dq_ref": L, "flash_bwd_dkdv_ref": L}


def test_fused_norm_forward_runs_once_per_sublayer(monkeypatch):
    cfg, params, toks = setup()        # m = 2 · 32 trunk rows: admitted
    calls = counting(monkeypatch, tm, ["fused_rmsnorm_matmul_ref"])
    tt.grads_fn(cfg, params, toks, attn_impl="flash", norm_impl="fused")
    assert calls == {"fused_rmsnorm_matmul_ref": 2 * cfg.n_layers}


@pytest.mark.parametrize("kw", [dict(attn_impl="dense"),
                                dict(attn_impl="flash"),
                                dict(attn_impl="flash", norm_impl="fused"),
                                dict(attn_impl="dense", head_impl="chunked")],
                         ids=["dense", "flash", "fused-norm", "chunked"])
def test_no_weight_product_runs_twice(kw, monkeypatch):
    cfg, params, toks = setup(1)
    counts = []
    for remat in (True, False):
        if not remat:
            monkeypatch.setattr(tt, "remat", no_remat)
        with CountMM() as mode:
            tt.grads_fn(cfg, params, toks, **kw)
        counts.append(mode.mm)
    assert counts[0] == counts[1] > 0


@pytest.mark.parametrize("kw", [dict(attn_impl="dense"),
                                dict(attn_impl="flash"),
                                dict(attn_impl="flash", norm_impl="fused"),
                                dict(attn_impl="dense", accum_steps=2)],
                         ids=["dense", "flash", "fused-norm", "accum2"])
def test_remat_changes_no_value(kw, monkeypatch):
    """Loss and every gradient leaf bit-equal with and without remat."""
    cfg, params, toks = setup(2, batch=4)
    loss, grads = tt.grads_fn(cfg, params, toks, **kw)
    monkeypatch.setattr(tt, "remat", no_remat)
    loss0, grads0 = tt.grads_fn(cfg, params, toks, **kw)
    assert torch.equal(loss, loss0)
    for a, b in zip(tt.tree_leaves(grads), tt.tree_leaves(grads0)):
        assert torch.equal(a, b)


def test_packed_loss_under_remat_changes_no_value(monkeypatch):
    cfg, params, _ = setup()
    from tpu_dra_torch.workloads.data import pack_documents
    r = np.random.default_rng(4)
    toks, segs, pos = (torch.from_numpy(t) for t in pack_documents(
        [r.integers(1, cfg.vocab, n) for n in (9, 20, 5, 14, 30)],
        seq=cfg.max_seq + 1))

    def run():
        return tt.value_and_grad(
            lambda p: tt.packed_loss_fn(cfg, p, toks, segs, pos), params)
    loss, grads = run()
    monkeypatch.setattr(tt, "remat", no_remat)
    loss0, grads0 = run()
    assert torch.equal(loss, loss0)
    for a, b in zip(tt.tree_leaves(grads), tt.tree_leaves(grads0)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_fused_collective_step_never_runs_a_ring_again(remat, monkeypatch):
    """DP×TP with the ring matmuls: each of the 4·L ring calls a step
    makes (forward two, each one's backward through the other) runs
    once, with or without remat, and the step's values are the same."""
    cfg, params, toks = setup(3)
    mesh = Mesh({"dp": 1, "tp": 2}, device=CPU)
    if not remat:
        monkeypatch.setattr(tt, "remat", no_remat)
    calls = counting(monkeypatch, cm, ["all_gather_matmul",
                                       "matmul_reduce_scatter"])
    step, _, _ = tt.make_sharded_train_step(cfg, mesh, lr=1.0,
                                            attn_impl="flash",
                                            matmul_impl="fused_collective")
    new, loss = step(params, toks)
    L = cfg.n_layers
    assert calls == {"all_gather_matmul": 4 * L,
                     "matmul_reduce_scatter": 4 * L}
    if remat:
        monkeypatch.setattr(tt, "remat", no_remat)
        new0, loss0 = step(params, toks)
        assert torch.equal(loss, loss0)
        for a, b in zip(tt.tree_leaves(new), tt.tree_leaves(new0)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_ring_step_recomputes_its_hops(remat, monkeypatch):
    """DP×SP at sp = 4: 2·(n − 1) kv shifts a layer forward and as many
    backward, and with remat as many again in the backward's recompute
    (the reference's ``jax.checkpoint(block)``); the flash forward runs n
    times a layer, twice under remat."""
    jcfg, cfg = cfg_pair(vocab=64, d_model=32, n_heads=4, n_layers=2,
                         d_ff=64, max_seq=32, pos_emb="rope")
    params = to_torch(jax_params(jcfg))
    n, L = 4, cfg.n_layers
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 33)))
    if not remat:
        monkeypatch.setattr(tt, "remat", no_remat)
    calls = counting(monkeypatch, cm, ["ring_shift"])
    fwd = counting(monkeypatch, tf, ["flash_attn_fwd_ref"])
    step, _ = tra.make_ring_train_step(cfg, Mesh({"dp": 1, "sp": n},
                                                 device=CPU),
                                       ring_impl="flash", hop_impl="pallas")
    step(params, toks[:, :-1], toks[:, 1:])
    k = 3 if remat else 2
    assert calls == {"ring_shift": 2 * k * (n - 1) * L}
    assert fwd == {"flash_attn_fwd_ref": (2 if remat else 1) * n * L}


def test_remat_steps_aside_without_autograd(monkeypatch):
    """Serving paths run the trunk under no_grad: remat is not entered.
    A training step enters it three times a block: the two rmsnorms and
    the attention between the projections."""
    cfg, params, toks = setup()
    entered = []
    real = tt.checkpoint
    monkeypatch.setattr(tt, "checkpoint",
                        lambda *a, **k: entered.append(1) or real(*a, **k))
    with torch.no_grad():
        tt.forward(cfg, params, toks[:, :-1])
    assert not entered
    tt.grads_fn(cfg, params, toks)
    assert len(entered) == 3 * cfg.n_layers
