"""The port's data pipeline and training loop
(tpu_dra_torch/workloads/data.py, fit.py) against the JAX reference:
batches equal the reference's exactly, from step 0 and from a later
start step; ``fit`` on the CPU descends on a small learnable corpus;
checkpoints and a bit-exact resume, the resumed schedule against optax's
at the restored horizon; the MoE model through ``fit``; the CLI's
argument errors; and what ``fit`` refuses, as the reference's does
(ZeRO-1 on a mesh: tests/test_torch_zero1.py).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tpu_dra.workloads import data as jdata
from tpu_dra_torch.workloads import data as tdata
from tpu_dra_torch.workloads import fit as tfit
from tpu_dra_torch.workloads.train import ModelConfig

TINY = dict(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
            max_seq=16)


def motif_corpus(path, n=20000, vocab=64, period=17, seed=0):
    """A learnable stream: a random motif repeated, 5% of tokens noise."""
    r = np.random.default_rng(seed)
    motif = r.integers(0, vocab, period)
    toks = np.resize(motif, n)
    noise = r.random(n) < 0.05
    toks[noise] = r.integers(0, vocab, int(noise.sum()))
    tdata.TokenDataset.write(str(path), toks)
    return str(path)


@pytest.mark.parametrize("start_step", [0, 3, 1000])
@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2)])
def test_batches_equal_the_reference(tmp_path, start_step, rank, world):
    path = motif_corpus(tmp_path / "t.bin", n=5000)
    want = jdata.batches(jdata.TokenDataset(path), batch=4, seq=32,
                         rank=rank, world=world, start_step=start_step)
    got = tdata.batches(tdata.TokenDataset(path), batch=4, seq=32,
                        rank=rank, world=world, start_step=start_step)
    for _ in range(5):
        w, g = next(want), next(got)
        assert g.dtype == np.int32 and g.shape == (4, 33)
        np.testing.assert_array_equal(g, w)


def test_batch_index_and_errors_match_the_reference():
    for step in (0, 7, 123):
        np.testing.assert_array_equal(
            tdata.batch_index(step, 1, 3, 16, 1000, world=2),
            jdata.batch_index(step, 1, 3, 16, 1000, world=2))
    with pytest.raises(ValueError, match="collide"):
        tdata.batch_index(0, 0, 100, 16, 1000)


def test_dataset_encode_and_pack_match_the_reference(tmp_path):
    text = tmp_path / "t.txt"
    text.write_text("héllo wörld\n" * 50, encoding="utf-8")
    n = tdata.encode_bytes(str(text), str(tmp_path / "p.bin"),
                           chunk_bytes=7)
    assert n == jdata.encode_bytes(str(text), str(tmp_path / "j.bin"))
    assert (tmp_path / "p.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    assert len(tdata.TokenDataset(str(tmp_path / "p.bin"))) == n
    (tmp_path / "odd.bin").write_bytes(b"abc")
    with pytest.raises(ValueError, match="multiple"):
        tdata.TokenDataset(str(tmp_path / "odd.bin"))
    docs = [np.arange(1, 1 + k) for k in (5, 9, 3, 12, 1, 0, 7)]
    for got, want in zip(tdata.pack_documents(docs, 12),
                         jdata.pack_documents(docs, 12)):
        np.testing.assert_array_equal(got, want)


def test_device_prefetch_keeps_order_and_moves_to_the_device():
    arrs = [np.full((2, 3), i, np.int32) for i in range(5)]
    out = list(tdata.device_prefetch(iter(arrs), "cpu", depth=2))
    assert [int(t[0, 0]) for t in out] == list(range(5))
    assert all(t.device.type == "cpu" and t.dtype == torch.int32
               for t in out)


def test_fit_descends_on_the_cpu(tmp_path):
    path = motif_corpus(tmp_path / "t.bin")
    cfg = ModelConfig(**TINY)
    lines = []
    res = tfit.fit(cfg, path, steps=30, batch=8, lr=1e-2, log_every=5,
                   device="cpu", log_fn=lines.append)
    assert res.step == 30 and len(res.losses) == 6
    assert lines[0].startswith("step 5: loss ")
    assert all(np.isfinite(res.losses))
    assert res.losses[-1] < res.losses[0] - 0.5, res.losses
    assert res.loss == pytest.approx(res.losses[-1], abs=1e-4)
    assert res.tokens_per_s > 0


def test_fit_with_flash_attention_and_cosine_on_the_cpu(tmp_path):
    """The flash path (plain versions on the CPU), chunked head,
    accumulation and a warmup-cosine schedule through fit."""
    path = motif_corpus(tmp_path / "t.bin")
    cfg = ModelConfig(**dict(TINY, n_heads=4, n_kv_heads=2,
                             pos_emb="rope"))
    res = tfit.fit(cfg, path, steps=12, batch=8, lr=1e-2,
                   lr_schedule="cosine", warmup_steps=2,
                   attn_impl="flash", head_impl="chunked", accum_steps=2,
                   log_every=4, device="cpu", log_fn=lambda s: None)
    assert all(np.isfinite(res.losses)) and res.losses[-1] < res.losses[0]
    gen = torch.Generator()
    gen.manual_seed(0)
    from tpu_dra_torch.workloads.train import init_params
    ev = tfit.evaluate(cfg, init_params(cfg, gen), path, batches_n=2,
                       batch=4, attn_impl="flash")
    assert np.isfinite(ev["nll"])
    assert ev["perplexity"] == pytest.approx(np.exp(ev["nll"]))


def test_fit_refuses_what_is_not_ported_yet(tmp_path):
    """What ``fit`` refuses, as the reference's does: the MoE model what
    its step cannot do, a MoE mesh without "dp" and "ep", a batch that
    does not split over dp x accum_steps.  ZeRO-1, once refused here, now
    runs: without a mesh the one device is dp 1, where it changes nothing,
    so the run equals the replicated one."""
    from tpu_dra_torch.workloads.mesh import Mesh
    from tpu_dra_torch.workloads.moe import MoEConfig
    path = motif_corpus(tmp_path / "t.bin", n=2000)
    cfg = ModelConfig(**TINY)
    kw = dict(steps=2, batch=2, log_every=1, device="cpu",
              log_fn=lambda s: None)
    assert (tfit.fit(cfg, path, zero1=True, **kw).losses
            == tfit.fit(cfg, path, **kw).losses)
    for kw in (dict(accum_steps=2), dict(label_smoothing=0.1),
               dict(z_loss=1e-4)):
        with pytest.raises(ValueError, match="MoE fit supports"):
            tfit.fit(MoEConfig(**TINY), path, steps=1, device="cpu", **kw)
    with pytest.raises(ValueError, match="'dp' and 'ep'"):
        tfit.fit(MoEConfig(**TINY), path, steps=1,
                 mesh=Mesh({"ep": 2}, device="cpu"))
    with pytest.raises(ValueError, match="dp x accum_steps"):
        tfit.fit(cfg, path, steps=1, batch=6,
                 mesh=Mesh({"dp": 4, "tp": 1}, device="cpu"))
    with pytest.raises(ValueError, match="accum_steps"):
        tfit.fit(cfg, path, steps=1, accum_steps=0, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        tfit.fit(cfg, path, steps=1, batch=6, accum_steps=4, device="cpu")
    with pytest.raises(ValueError, match="lr_schedule"):
        tfit.fit(cfg, path, steps=1, lr_schedule="step", device="cpu")


def fit_quiet(cfg, path, **kw):
    return tfit.fit(cfg, path, batch=4, lr=1e-2, log_every=1,
                    device="cpu", log_fn=lambda s: None, **kw)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_resume_is_bit_exact(tmp_path, moe):
    """6 steps saving at 3 and 6; step 6's commit marker removed (a
    preemption mid-save); a resume of 3 steps starts at 3, sweeps the
    unmarked step, and gives losses 4-6 and step 6's parameters and
    moments bit-equal to the uninterrupted run's."""
    from tpu_dra_torch.workloads.checkpointing import (
        _COMMIT_MARKER, latest_step, restore_train_state)
    from tpu_dra_torch.workloads.moe import MoEConfig
    path = motif_corpus(tmp_path / "t.bin", n=4000)
    cfg = (MoEConfig(**dict(TINY, n_experts=4, router_top_k=2)) if moe
           else ModelConfig(**TINY))
    ck = tmp_path / "ck"
    full = fit_quiet(cfg, path, steps=6, checkpoint_dir=str(ck),
                     checkpoint_every=3)
    assert latest_step(str(ck)) == 6 and sorted(os.listdir(ck)) == ["3",
                                                                     "6"]
    want = restore_train_state(str(ck), device="cpu")
    (ck / "6" / _COMMIT_MARKER).unlink()
    lines = []
    res = tfit.fit(cfg, path, steps=3, batch=4, lr=1e-2, log_every=1,
                   checkpoint_dir=str(ck), checkpoint_every=3, resume=True,
                   device="cpu", log_fn=lines.append)
    assert lines[0].startswith("resumed from step 3")
    assert res.step == 6 and res.losses == full.losses[3:]
    got = restore_train_state(str(ck), device="cpu")
    assert got["extra"]["step"] == 6
    assert got["extra"]["opt_state"]["count"] == 6
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        assert torch.equal(a, b)


def tree_leaves(state):
    from tpu_dra_torch.workloads.train import tree_leaves as leaves
    opt = state["extra"]["opt_state"]
    return leaves(state["params"]) + leaves(opt["mu"]) + leaves(opt["nu"])


def test_cosine_resume_keeps_learning(tmp_path, monkeypatch):
    """A resumed cosine run sizes its horizon from the restored step: its
    learning rates are optax's warmup-cosine at decay_steps = restored +
    steps, not the end value of the first run's schedule."""
    import optax
    from tpu_dra_torch.workloads import optim
    seen = []

    def make_schedule(*args):
        seen.append(optim.make_schedule(*args))
        return seen[-1]
    monkeypatch.setattr(tfit, "make_schedule", make_schedule)
    path = motif_corpus(tmp_path / "t.bin", n=4000)
    cfg = ModelConfig(**TINY)
    ck = str(tmp_path / "ck")
    fit_quiet(cfg, path, steps=4, lr_schedule="cosine", warmup_steps=1,
              checkpoint_dir=ck, checkpoint_every=4)
    res = fit_quiet(cfg, path, steps=4, lr_schedule="cosine",
                    warmup_steps=1, checkpoint_dir=ck, checkpoint_every=4,
                    resume=True)
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=1e-2, warmup_steps=1, decay_steps=8)
    for count in range(4, 8):
        assert seen[1](count) == pytest.approx(float(want(count)),
                                               rel=1e-6, abs=1e-12)
        assert seen[1](count) > 0
    assert seen[0](4) == 0.0                # where the old horizon ended
    assert res.step == 8 and all(np.isfinite(res.losses))


def test_moe_fit_descends_on_the_cpu(tmp_path):
    from tpu_dra_torch.workloads.moe import MoEConfig
    path = motif_corpus(tmp_path / "t.bin")
    for top_k in (1, 2):
        cfg = MoEConfig(**dict(TINY, n_experts=4, router_top_k=top_k))
        res = tfit.fit(cfg, path, steps=20, batch=8, lr=1e-2, log_every=5,
                       attn_impl="flash", device="cpu",
                       log_fn=lambda s: None)
        assert all(np.isfinite(res.losses))
        assert res.losses[-1] < res.losses[0] - 0.5, res.losses
        gen = torch.Generator()
        gen.manual_seed(0)
        from tpu_dra_torch.workloads.moe import init_moe_params
        ev = tfit.evaluate(cfg, init_moe_params(cfg, gen), path,
                           batches_n=2, batch=4)
        assert np.isfinite(ev["nll"])


def test_main_argument_errors(tmp_path, monkeypatch, capsys):
    with pytest.raises(SystemExit) as exc:
        tfit.main([])                                   # --data missing
    assert exc.value.code == 2
    path = motif_corpus(tmp_path / "t.bin", n=2000)
    for bad in (["--attn-impl", "ring"], ["--pos-emb", "alibi"],
                ["--lr-schedule", "step"], ["--steps", "many"],
                ["--device", "cpu"]):
        with pytest.raises(SystemExit) as exc:
            tfit.main(["--data", path, *bad])
        assert exc.value.code == 2, bad
    assert "usage" in capsys.readouterr().err
    # the checkpoint flags reach fit
    seen = {}
    monkeypatch.setattr(tfit, "fit", lambda cfg, data, **kw: (
        seen.update(kw), tfit.FitResult(1, 0.0, [], 1.0))[1])
    assert tfit.main(["--data", path, "--checkpoint-dir", str(tmp_path),
                      "--checkpoint-every", "5", "--resume"]) == 0
    assert (seen["checkpoint_dir"], seen["checkpoint_every"],
            seen["resume"]) == (str(tmp_path), 5, True)
    monkeypatch.undo()
    # no card: the CLI refuses instead of falling back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfit.main(["--data", path, "--steps", "1", "--vocab", "64",
                   "--d-model", "32", "--n-heads", "2", "--n-layers", "1",
                   "--d-ff", "64", "--max-seq", "16"])
