"""Checkpoints of the port (tpu_dra_torch/workloads/checkpointing.py):
the reference's tests of tests/test_workload_checkpoint.py, case for
case, on the port's own format; a JAX init carried across through
``convert`` and saved; the int8 weights' layout after a restore; and a
directory of another format refused with the pointer to
``convert.save_npz``."""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import cfg_pair, jax_params, to_numpy_tree

from tpu_dra_torch.convert import params_from_numpy
from tpu_dra_torch.workloads import checkpointing as ck
from tpu_dra_torch.workloads.checkpointing import (
    latest_step,
    restore_serving_state,
    restore_train_state,
    save_serving_state,
    save_train_state,
)
from tpu_dra_torch.workloads.train import (
    init_params,
    make_sharded_train_step,
    tree_leaves,
)

ROOT = Path(__file__).resolve().parent.parent
JCFG, TCFG = cfg_pair(vocab=32, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                      max_seq=16)


@pytest.fixture
def params():
    gen = torch.Generator()
    gen.manual_seed(0)
    return init_params(TCFG, gen)


def restore(d, **kw):
    return restore_train_state(d, device="cpu", **kw)


def assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_save_restore_roundtrip(params, tmp_path):
    d = str(tmp_path / "ckpt")
    save_train_state(d, 7, params, extra={"lr": torch.tensor(0.5)})
    assert latest_step(d) == 7
    out = restore(d)
    assert_trees_equal(params, out["params"])
    assert float(out["extra"]["lr"]) == 0.5


def test_resume_training_continues_exactly(params, tmp_path):
    """Train 3 steps → checkpoint → 2 more; a resumed run's 2 steps from
    the checkpoint give bit-identical losses."""
    from tpu_dra_torch.workloads.mesh import Mesh
    mesh = Mesh({"dp": 4, "tp": 2}, device="cpu")
    step, _, _ = make_sharded_train_step(TCFG, mesh, lr=0.1)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, 32, (4, 16), dtype=np.int32))
    for _ in range(3):
        params, _ = step(params, tokens)
    d = str(tmp_path / "ckpt")
    save_train_state(d, 3, params)
    cont = []
    for _ in range(2):
        params, loss = step(params, tokens)
        cont.append(float(loss))
    p = restore(d)["params"]
    resumed = []
    for _ in range(2):
        p, loss = step(p, tokens)
        resumed.append(float(loss))
    assert cont == resumed, (cont, resumed)


def test_max_to_keep_prunes(params, tmp_path):
    d = str(tmp_path / "ckpt")
    for s in (1, 2, 3, 4):
        save_train_state(d, s, params, max_to_keep=2)
    assert latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["3", "4"]
    with pytest.raises(FileNotFoundError):
        restore(d, step=1)   # pruned


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "nope"))
    assert not (tmp_path / "nope").exists()   # a read creates nothing


def test_serving_state_roundtrip_int4_exact(params, tmp_path):
    """A quantized tree (int4 values, group scales, bf16 leaves) round-
    trips exactly, so quantize-once-at-deploy serving equals quantize-at-
    start serving bit for bit."""
    from tpu_dra_torch.workloads.decode import greedy_decode
    from tpu_dra_torch.workloads.quant import quantize_params_int4
    qp = quantize_params_int4(params)
    d = str(tmp_path / "serving")
    save_serving_state(d, qp)
    back = restore_serving_state(d, device="cpu")
    assert_trees_equal(qp, back)
    prompt = torch.zeros((2, 4), dtype=torch.int32)
    assert torch.equal(greedy_decode(TCFG, back, prompt, steps=3),
                       greedy_decode(TCFG, qp, prompt, steps=3))


def test_serving_state_overwrites_in_place(params, tmp_path):
    from tpu_dra_torch.workloads.quant import (cast_params_bf16,
                                               quantize_params_int8)
    d = str(tmp_path / "serving")
    save_serving_state(d, cast_params_bf16(params), meta={"form": "bf16"})
    save_serving_state(d, quantize_params_int8(params),
                       meta={"form": "int8"})
    back = restore_serving_state(d, device="cpu")
    assert "q8" in back["blocks"]["wqkv"]
    assert latest_step(d) == 1 and ck._complete_steps(d) == [1]
    assert ck.serving_meta(d) == {"form": "int8"}


def test_restore_serving_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_serving_state(str(tmp_path / "nope"), device="cpu")
    assert ck.serving_meta(str(tmp_path / "nope")) is None


def test_latest_step_skips_partial_and_save_cleans_it(params, tmp_path):
    """A crash mid-save leaves a bare step directory without the commit
    marker: readers never select it and never delete it; the next save
    sweeps it and can re-save that step."""
    d = str(tmp_path / "ckpt")
    save_train_state(d, 3, params)
    os.makedirs(os.path.join(d, "4", "default"))
    with open(os.path.join(d, "4", "default", "junk"), "w") as f:
        f.write("partial")
    assert latest_step(d) == 3
    assert os.path.exists(os.path.join(d, "4"))   # read path: skip only
    assert restore(d)["params"] is not None
    assert os.path.exists(os.path.join(d, "4"))
    save_train_state(d, 4, params)
    assert latest_step(d) == 4
    restore(d, step=4)
    with pytest.raises(FileExistsError):
        save_train_state(d, 4, params)


def test_restore_ignores_partial_latest(params, tmp_path):
    d = str(tmp_path / "ckpt")
    save_train_state(d, 1, params)
    os.makedirs(os.path.join(d, "2"))
    assert_trees_equal(params, restore(d)["params"])  # step 1, not 2


def test_latest_step_leaves_tmp_dirs_alone(params, tmp_path):
    """Staging directories (the port's and orbax's) belong to a possibly
    concurrent saver: never selected, never deleted, by readers or by
    the saver's sweep."""
    d = str(tmp_path / "ckpt")
    save_train_state(d, 2, params)
    staging = [os.path.join(d, "5.tmp-1234567"),
               os.path.join(d, "6.orbax-checkpoint-tmp-1234567")]
    for s in staging:
        os.makedirs(s)
    assert latest_step(d) == 2
    save_train_state(d, 3, params)
    assert latest_step(d) == 3
    assert all(os.path.isdir(s) for s in staging)


def test_crash_sweep_mid_save_latest_always_restorable(tmp_path):
    """A child process saves checkpoints in a loop and is SIGKILLed
    mid-stream; whatever ``latest_step`` then selects restores."""
    d = str(tmp_path / "ckpt")
    child = (
        "import sys; sys.path.insert(0, %r)\n"
        "import torch\n"
        "from tpu_dra_torch.workloads.checkpointing import "
        "save_train_state\n"
        "for step in range(1, 400):\n"
        "    save_train_state(%r, step, {'w': torch.full((64,), "
        "float(step))})\n" % (str(ROOT), d))
    proc = subprocess.Popen([sys.executable, "-c", child])
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and latest_step(d) is None:
            time.sleep(0.02)
        time.sleep(0.05)   # land the kill inside a later save
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    step = latest_step(d)
    assert step is not None
    out = restore(d)
    assert torch.equal(out["params"]["w"], torch.full((64,), float(step)))


def test_a_jax_init_crosses_through_convert_and_back_bit_equal(tmp_path):
    """The reference's init → numpy → ``convert`` → save → restore: every
    leaf bit-equal to the JAX arrays."""
    jp = to_numpy_tree(jax_params(JCFG, seed=4))
    d = str(tmp_path / "ckpt")
    save_train_state(d, 0, params_from_numpy(jp, "cpu"))
    back = restore(d)["params"]

    def walk(j, t):
        for k, v in j.items():
            if isinstance(v, dict):
                walk(v, t[k])
            else:
                np.testing.assert_array_equal(t[k].numpy(), np.asarray(v))
    walk(jp, back)


def test_int8_weights_restore_column_major_and_multiply_alike(params,
                                                              tmp_path):
    """``q8`` comes back column-major (the card's int8 product's layout),
    and ``int8_matmul`` gives the same bits before and after."""
    from tpu_dra_torch.workloads.quant import (int8_matmul,
                                               quantize_params_int8)
    qp = quantize_params_int8(params)
    d = str(tmp_path / "serving")
    save_serving_state(d, qp)
    back = restore_serving_state(d, device="cpu")
    rng = np.random.default_rng(2)
    for name in ("wqkv", "wo", "w1", "w2"):
        q8 = back["blocks"][name]["q8"]
        assert q8.transpose(-1, -2).is_contiguous(), name
        w, wb = qp["blocks"][name], back["blocks"][name]
        x = torch.from_numpy(rng.standard_normal(
            (5, q8.shape[1])).astype(np.float32))
        assert torch.equal(int8_matmul(x, w["q8"][0], w["s"][0]),
                           int8_matmul(x, wb["q8"][0], wb["s"][0]))
    assert back["unembed"]["q8"].transpose(0, 1).is_contiguous()


def test_a_foreign_directory_is_refused_with_the_convert_pointer(
        params, tmp_path):
    """An orbax step (committed, no ``state.pt``) fails with a message
    naming ``convert.save_npz``, never a pickle traceback; the saver
    refuses to write beside it and deletes nothing."""
    d = tmp_path / "orbax"
    (d / "5" / "default").mkdir(parents=True)
    (d / "5" / ck._COMMIT_MARKER).write_text("{}")
    (d / "5" / "default" / "array_metadatas").write_text("{}")
    assert latest_step(str(d)) == 5
    with pytest.raises(ValueError, match="convert.save_npz"):
        restore(str(d))
    with pytest.raises(ValueError, match="convert.save_npz"):
        save_train_state(str(d), 6, params)
    assert sorted(os.listdir(d)) == ["5"]
