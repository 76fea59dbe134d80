"""The port's training step (tpu_dra_torch/workloads/train.py, optim.py)
against the JAX reference on the same weights and tokens: ``loss_fn`` and
``grads_fn`` over dense and flash attention, dense and chunked heads,
label smoothing with z-loss and gradient accumulation, learned positions
with MHA and rope with GQA; the optimizer against the optax chain ``fit``
builds, on identical gradients; and whole AdamW steps against
``make_optax_train_step``.

Tolerances.  The trunk is bf16 (embeddings cast on use, every matmul
output and residual add rounded to 8 bits), so two correct
implementations that sum in different orders differ by bf16 noise that
grows through the layers: the reference's own dense and flash paths give
gradients 1.4% apart (relative L2, worst leaf, on the CPU at these
configs) and the port lands 1.2-1.3% from the reference.  Leaves are
held to 3% relative L2 and the mean loss to 5e-3 absolute (observed
1.4e-3).  The optimizer is fp32 elementwise math in the same order as
optax's, fed the same gradients: parameters agree to 1e-6 relative.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from torch_parity import cfg_pair, f32, jax_params, to_torch

from tpu_dra.workloads import train as jt
from tpu_dra_torch.workloads import optim
from tpu_dra_torch.workloads import train as tt

LOSS_ATOL = 5e-3
LEAF_REL = 3e-2

CFGS = {
    "learned-mha": dict(vocab=128, d_model=64, n_heads=4, n_layers=2,
                        d_ff=128, max_seq=32),
    "rope-gqa": dict(vocab=128, d_model=128, n_heads=4, n_kv_heads=2,
                     n_layers=2, d_ff=256, max_seq=64, pos_emb="rope"),
}
HEADS = {
    "dense": dict(head_impl="dense"),
    "chunked": dict(head_impl="chunked"),
    "smooth-zloss": dict(head_impl="dense", label_smoothing=0.1,
                         z_loss=1e-3),
    "accum2": dict(head_impl="dense", accum_steps=2),
}


def flat(tree, prefix=""):
    """Nested params/grads (JAX or torch) → {"blocks/wqkv": fp32 numpy}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = f32(v)
    return out


def tokens_for(jcfg, seed=0, batch=4):
    r = np.random.default_rng(seed)
    return r.integers(0, jcfg.vocab, (batch, jcfg.max_seq + 1)).astype(
        np.int32)


@pytest.mark.parametrize("head", sorted(HEADS))
@pytest.mark.parametrize("attn", ["dense", "flash"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_loss_and_grads_match_reference(name, attn, head):
    jcfg, tcfg = cfg_pair(**CFGS[name])
    params = jax_params(jcfg)
    toks = tokens_for(jcfg)
    kw = HEADS[head]
    want_loss, want = jt.grads_fn(jcfg, params, jnp.asarray(toks),
                                  attn_impl=attn, **kw)
    got_loss, got = tt.grads_fn(tcfg, to_torch(params),
                                torch.from_numpy(toks), attn_impl=attn, **kw)
    assert got_loss.dtype == torch.float32 and got_loss.dim() == 0
    assert abs(float(got_loss) - float(want_loss)) < LOSS_ATOL
    want, got = flat(want), flat(got)
    assert sorted(got) == sorted(want)
    for leaf in want:
        assert got[leaf].shape == want[leaf].shape, leaf
        rel = np.linalg.norm(got[leaf] - want[leaf]) / np.linalg.norm(
            want[leaf])
        assert rel < LEAF_REL, (leaf, rel)
    if head == "dense" and attn == "dense":
        # the mean loss itself, with no gradient taken
        loss = tt.loss_fn(tcfg, to_torch(params), torch.from_numpy(toks))
        assert abs(float(loss) - float(want_loss)) < LOSS_ATOL


def test_chunked_head_matches_full_vocab_fp32_nll():
    """The chunked NLL's forward and recomputing backward against the
    same NLL over the whole vocabulary at once, with the logits kept in
    fp32 (the dense head rounds them to bf16 first, the chunked one
    does not, as in the reference)."""
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.standard_normal((2, 8, 32), np.float32)).to(
        torch.bfloat16).requires_grad_()
    w = torch.from_numpy(r.standard_normal((32, 96), np.float32) * 0.3) \
        .requires_grad_()
    params = {"ln_f": torch.ones(32), "unembed": w}
    targets = torch.from_numpy(r.integers(0, 96, (2, 8)))
    chunked = tt.head_nll(params, x, targets, "chunked", n_chunks=5)
    logits = (tt._rmsnorm(x, params["ln_f"]).float()
              @ w.to(torch.bfloat16).float())
    full = (torch.logsumexp(logits, -1)
            - logits.gather(-1, targets[..., None])[..., 0])[..., None]
    np.testing.assert_allclose(f32(chunked), f32(full), rtol=1e-5,
                               atol=1e-5)
    gc = torch.autograd.grad(chunked.sum(), (x, w))
    gf = torch.autograd.grad(full.sum(), (x, w))
    # the chunked backward rounds its logit gradient to bf16 before both
    # products (as the reference's does): two bf16 ulps of the result
    for a, b in zip(gc, gf):
        np.testing.assert_allclose(f32(a), f32(b), rtol=2 ** -7,
                                   atol=2 ** -7)


def test_head_rejects_stats_on_the_chunked_head_and_unknown_impls():
    params = {"ln_f": torch.ones(8), "unembed": torch.zeros(8, 16)}
    x = torch.zeros(1, 2, 8, dtype=torch.bfloat16)
    t = torch.zeros(1, 2, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="dense head"):
        tt.head_nll(params, x, t, "chunked", label_smoothing=0.1)
    with pytest.raises(ValueError, match="head_impl"):
        tt.head_nll(params, x, t, "sparse")
    jcfg, tcfg = cfg_pair(**CFGS["learned-mha"])
    with pytest.raises(ValueError, match="attn_impl"):
        tt.loss_fn(tcfg, to_torch(jax_params(jcfg)),
                   torch.zeros(1, 5, dtype=torch.long), attn_impl="ring")
    with pytest.raises(ValueError, match="divisible"):
        tt.grads_fn(tcfg, to_torch(jax_params(jcfg)),
                    torch.zeros(3, 5, dtype=torch.long), accum_steps=2)


def test_sgd_train_step_matches_reference():
    jcfg, tcfg = cfg_pair(**CFGS["learned-mha"])
    params = jax_params(jcfg)
    toks = tokens_for(jcfg, seed=1)
    want, want_loss = jt.sgd_train_step(jcfg, 0.5, params,
                                        jnp.asarray(toks))
    got, got_loss = tt.sgd_train_step(tcfg, 0.5, to_torch(params),
                                      torch.from_numpy(toks))
    assert abs(float(got_loss) - float(want_loss)) < LOSS_ATOL
    # p - 0.5·g: the gradient noise scaled by lr on O(0.1) weights
    for leaf, w in flat(want).items():
        np.testing.assert_allclose(flat(got)[leaf], w, rtol=1e-3,
                                   atol=1e-3, err_msg=leaf)


def optax_chain(schedule):
    """The chain fit.py builds around a learning-rate schedule."""
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(schedule, weight_decay=0.01))


SCHEDULES = {
    # (port schedule, optax schedule), both as fit builds them
    "constant": (optim.make_schedule(1e-2, "constant", 0, 5), 1e-2),
    "warmup": (optim.make_schedule(1e-2, "constant", 2, 5),
               optax.linear_schedule(0.0, 1e-2, 2)),
    "cosine": (optim.make_schedule(1e-2, "cosine", 2, 5),
               optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 5)),
}


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_optimizer_matches_optax_chain_on_identical_grads(sched):
    """Five AdamW updates from the same parameters and the same gradient
    sequence; steps 2 and 4 have a global norm above 1, so the clip
    triggers there and not elsewhere."""
    r = np.random.default_rng(11)
    shapes = {"embed": (16, 8), "blocks": {"w": (2, 8, 8), "ln": (2, 8)},
              "ln_f": (8,)}

    def tree(fn, node=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in node.items()}
    p_np = tree(lambda s: r.standard_normal(s).astype(np.float32))
    grads = []
    for i in range(5):
        g = tree(lambda s: r.standard_normal(s).astype(np.float32))
        norm = np.sqrt(sum(np.square(x).sum()
                           for x in flat(g).values()))
        scale = 3.0 if i in (1, 3) else 0.5
        grads.append(jax.tree.map(lambda x: x * scale / norm, g))
    port_sched, optax_sched = SCHEDULES[sched]
    tx = optax_chain(optax_sched)
    jp = jax.tree.map(jnp.asarray, p_np)
    st = tx.init(jp)
    opt = optim.AdamW(port_sched)
    tp = jax.tree.map(torch.from_numpy, p_np)
    ts = opt.init(tp)
    for g in grads:
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        ts = opt.update(tp, jax.tree.map(torch.from_numpy, g), ts)
    assert ts.count == 5
    want, got = flat(jp), flat(tp)
    for leaf in want:
        np.testing.assert_allclose(got[leaf], want[leaf], rtol=1e-6,
                                   atol=1e-7, err_msg=leaf)


def test_schedules_match_optax_at_every_count():
    for name, (port, ref) in SCHEDULES.items():
        for count in range(8):
            want = float(ref(count)) if callable(ref) else ref
            assert port(count) == pytest.approx(want, rel=1e-6,
                                                abs=1e-9), (name, count)
    with pytest.raises(ValueError, match="lr_schedule"):
        optim.make_schedule(1e-3, "step", 0, 5)


def test_clip_is_optax_form_not_torch_form():
    """Below the threshold the gradient passes unchanged (torch's
    clip_grad_norm_ would scale by 1/(1+1e-6)); above it, by 1/g_norm."""
    opt = optim.AdamW(1e-3)
    g = [torch.full((4,), 0.25)]                     # norm 0.5
    assert torch.equal(opt.clip(g)[0], g[0])
    g = [torch.full((4,), 1.0)]                      # norm 2
    np.testing.assert_allclose(f32(opt.clip(g)[0]), np.full(4, 0.5))


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_three_adamw_steps_match_make_optax_train_step(attn):
    """Whole steps (grads, clip, AdamW 1e-3) from the same weights over
    three batches.  Adam's first update is ≈ lr·sign(g), so entries whose
    gradient is within bf16 noise of 0 may move apart by 2·lr; the loss
    stays within 1e-2 (observed 1.8e-3)."""
    jcfg, tcfg = cfg_pair(**CFGS["rope-gqa"])
    params = jax_params(jcfg)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    step, init, p_shard, _ = jt.make_optax_train_step(
        jcfg, mesh, optimizer=optax_chain(1e-3), attn_impl=attn)
    jp = jax.device_put(params, p_shard)
    js = init(jp)
    tstep, tinit = tt.make_train_step(
        tcfg, optim.AdamW(1e-3), attn_impl=attn)
    tp = to_torch(params)
    ts = tinit(tp)
    for i in range(3):
        toks = tokens_for(jcfg, seed=20 + i)
        jp, js, jl = step(jp, js, jnp.asarray(toks))
        tp2, ts, tl = tstep(tp, ts, torch.from_numpy(toks))
        assert tp2 is tp                     # updated in place
        assert abs(float(tl) - float(jl)) < 1e-2, (i, float(tl), float(jl))
    assert ts.count == 3


# the reference's fused-norm train-step config (tests/test_pallas.py):
# windows [2, 16], so m = 2·15 = 30 rows, admitted as its own block
FUSED_CFG = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                 max_seq=32)


def spy_fused(monkeypatch):
    """Record each call of the fused norm-matmul wrapper."""
    from tpu_dra_torch.workloads import matmul as tm
    calls = []
    real = tm.fused_rmsnorm_matmul

    def spy(*args, **kw):
        calls.append(tuple(args[2].shape))
        return real(*args, **kw)
    monkeypatch.setattr(tm, "fused_rmsnorm_matmul", spy)
    return calls


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_fused_norm_grads_match_reference(attn, monkeypatch):
    """``grads_fn(norm_impl="fused")`` against the reference's on the same
    weights and tokens (its Pallas kernel in interpret mode off the TPU):
    loss within LOSS_ATOL, every leaf within LEAF_REL; each layer's
    ln1→wqkv and ln2→w1 go through the fused kernel."""
    jcfg, tcfg = cfg_pair(**FUSED_CFG)
    params = jax_params(jcfg)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 16)) \
        .astype(np.int32)
    want_loss, want = jt.grads_fn(jcfg, params, jnp.asarray(toks),
                                  attn_impl=attn, norm_impl="fused")
    calls = spy_fused(monkeypatch)
    got_loss, got = tt.grads_fn(tcfg, to_torch(params),
                                torch.from_numpy(toks), attn_impl=attn,
                                norm_impl="fused")
    assert calls == [(64, 192), (64, 128)] * jcfg.n_layers
    assert abs(float(got_loss) - float(want_loss)) < LOSS_ATOL
    want, got = flat(want), flat(got)
    assert sorted(got) == sorted(want)
    for leaf in want:
        assert got[leaf].dtype == np.float32, leaf
        rel = np.linalg.norm(got[leaf] - want[leaf]) / np.linalg.norm(
            want[leaf])
        assert rel < LEAF_REL, (leaf, rel)


def test_fused_norm_sgd_step_matches_reference(monkeypatch):
    """``sgd_train_step(norm_impl="fused")`` (the reference test's step)
    against the reference's, and ``make_train_step`` threads
    ``norm_impl`` through to the kernel."""
    jcfg, tcfg = cfg_pair(**FUSED_CFG)
    params = jax_params(jcfg)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 16)) \
        .astype(np.int32)
    want, want_loss = jt.sgd_train_step(jcfg, 1e-2, params,
                                        jnp.asarray(toks),
                                        norm_impl="fused")
    calls = spy_fused(monkeypatch)
    got, got_loss = tt.sgd_train_step(tcfg, 1e-2, to_torch(params),
                                      torch.from_numpy(toks),
                                      norm_impl="fused")
    assert len(calls) == 2 * jcfg.n_layers
    assert abs(float(got_loss) - float(want_loss)) < LOSS_ATOL
    for leaf, w in flat(want).items():
        np.testing.assert_allclose(flat(got)[leaf], w, rtol=1e-3,
                                   atol=1e-3, err_msg=leaf)
    calls.clear()
    step, init = tt.make_train_step(tcfg, optim.AdamW(1e-3),
                                    norm_impl="fused")
    tp = to_torch(params)
    step(tp, init(tp), torch.from_numpy(toks))
    assert len(calls) == 2 * jcfg.n_layers
