"""One rank of the process-group tests, started n times by
``launcher.run_local_group``: it resolves its triple, joins a gloo group
(``RendezvousInfo.initialize``) and writes what it computed to
``OUT/rank<r>.npz``, which the test reads back.

    python tests/torch_process_child.py ring OUT DEVICE
    python tests/torch_process_child.py mesh OUT AXES_JSON
    python tests/torch_process_child.py tp OUT AXES_JSON DEVICE
    python tests/torch_process_child.py optax OUT AXES_JSON DEVICE
    python tests/torch_process_child.py attn OUT AXES_JSON DEVICE
    python tests/torch_process_child.py pipe OUT AXES_JSON DEVICE

``ring``: the group ring's forward and VJP cases (:func:`ring_inputs`,
the same global inputs on every rank) on DEVICE ("cpu": the group plain
versions; "cuda": the kernels across processes).  ``mesh``: on a
``ProcessMesh`` of AXES over the CPU, shard and unshard round trips,
the refusals, and the DP×SP step of ``OUT/params.npz`` on
``OUT/tokens.npz`` for each (ring_impl, hop_impl) of :data:`STEPS`.
``tp``: on a ``ProcessMesh`` of AXES (dp × tp) over DEVICE, the DP×TP
step (``make_sharded_train_step``) of each case in ``OUT/cases.json``
(:func:`tp_main`).  ``optax``: on a ``ProcessMesh`` of AXES over DEVICE,
the AdamW step (``make_optax_train_step``, replicated and ZeRO-1) and
the chunked head's SGD step of each case in ``OUT/optax_cases.json``,
then ``fit`` on the mesh (:func:`optax_main`).  ``attn``: on a
``ProcessMesh`` of AXES over DEVICE, the zigzag and ring attention makers
of :data:`ZIGZAG_CASES` and :data:`MAKER_CASES` and ``kv_handoff.
ici_shift`` on the ring over "sp" (:func:`attn_main`).  ``pipe``: on a
``ProcessMesh`` of AXES (dp × pp) over DEVICE, the GPipe step of each
case in ``OUT/pipe_cases.json`` and the strategies that still refuse a
process mesh (:func:`pipe_main`).

It imports torch and the port only (no JAX), so the cuda case runs it
on a card machine as it is.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

# (m, K, N) of the gather cases: odd m (the unidirectional ring) and even
# m (bidirectional where n > 2); the reduce-scatter's m
AG_CASES = {"odd": (3, 16, 8), "even": (4, 16, 8)}
RS_CASE = (4, 16, 8)
SHIFT_SHAPE = (2, 3, 8)
STEPS = [("flash", "pallas"), ("flash", "xla"), ("xla", "xla")]
LR = 1.0
# the ring attention engines' cases: (engine, hop_impl, kv heads)
ATTN_CASES = [(e, h, kv) for e in ("xla", "flash") for h in ("xla", "pallas")
              for kv in (2, 1)]
# the makers on a process mesh, global [B, H, S, D] q and cotangent (k, v
# with kv heads): zigzag (impl, kv heads) and the plain ring (engine,
# hop_impl, kv heads)
ZIGZAG_CASES = [(impl, kv) for impl in ("xla", "flash") for kv in (2, 1)]
MAKER_CASES = ATTN_CASES
MAKER_SHAPE = (2, 2, 32, 16)
# the strategies a process mesh still refuses (ROADMAP.md §2, item 1)
STILL_REFUSED = ("make_moe_train_step", "make_moe_optax_step",
                 "make_lora_train_step", "serving_param_shardings",
                 "fit of a MoEConfig")


def bf16(seed: int, shape) -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


def ring_inputs(n: int) -> dict:
    """The global inputs, ``[n, ...]`` with rank r's own at ``[r]``."""
    out = {}
    for name, (m, K, N) in AG_CASES.items():
        out[f"ag_{name}_x"] = bf16(10 + m, (n, m, K))
        out[f"ag_{name}_w"] = bf16(20 + m, (n, K, N))
        out[f"ag_{name}_cot"] = bf16(30 + m, (n, n * m, N))
    m, K, N = RS_CASE
    out["rs_x"] = bf16(40, (n, n * m, K))
    out["rs_w"] = bf16(41, (n, K, N))
    out["rs_cot"] = bf16(42, (n, m, N))
    out["shift_x"] = bf16(50, (n, *SHIFT_SHAPE))
    out["shift_cot"] = bf16(51, (n, *SHIFT_SHAPE))
    return out


def attn_inputs(kv_heads: int) -> list:
    """Global bf16 q [4, 2, 16, 8] and k, v [4, kv_heads, 16, 8]."""
    return [bf16(60 + i, (4, 2 if i == 0 else kv_heads, 16, 8))
            for i in range(3)]


def maker_inputs(kv_heads: int, shape=MAKER_SHAPE) -> list:
    """Global bf16 q, k, v and the output's cotangent of the makers'
    cases, ``[B, H, S, D]`` = ``shape``."""
    B, H, S, D = shape
    return [bf16(70 + i, (B, kv_heads if i in (1, 2) else H, S, D))
            for i in range(4)]


def handoff_tree(n: int) -> dict:
    """A handoff's leaves as the int8 cache carries them, ``[n, ...]``
    with rank r's own at ``[r]``: bf16 pages, int8 pages and their fp32
    scales."""
    rng = np.random.default_rng(80)
    return {"ks": bf16(81, (n, 2, 2, 8, 16)),
            "vs_q8": torch.from_numpy(rng.integers(
                -128, 128, (n, 2, 2, 8, 16), dtype=np.int8)),
            "vs_scale": torch.from_numpy(rng.standard_normal(
                (n, 2, 2, 8)).astype(np.float32))}


def _join():
    from tpu_dra_torch.workloads.launcher import resolve
    torch.set_num_threads(1)
    resolve().initialize("gloo")


def _save(out: Path, rank: int, results: dict) -> None:
    np.savez(out / f"rank{rank}.npz", **{
        k: v.detach().float().cpu().numpy() if torch.is_tensor(v)
        else np.asarray(v) for k, v in results.items()})


def ring_main(out: Path, device: str) -> None:
    import torch.distributed as dist

    from tpu_dra_torch.workloads import collective_matmul as cm
    _join()
    ring = cm.ProcessRing()
    n, r = ring.n, ring.rank
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    g = {k: v[r].to(dev) for k, v in ring_inputs(n).items()}
    counters = (cm.all_gather_matmul, cm.matmul_reduce_scatter,
                cm.ring_shift)
    for fn in counters:
        fn.launches = 0
    res = {}
    for name in AG_CASES:
        y, a = ring.all_gather_matmul(g[f"ag_{name}_x"], g[f"ag_{name}_w"])
        x = g[f"ag_{name}_x"].clone().requires_grad_()
        w = g[f"ag_{name}_w"].clone().requires_grad_()
        yy = cm.ProcessAllGatherMatmul.apply(ring, x, w)
        dx, dw = torch.autograd.grad(yy, (x, w), g[f"ag_{name}_cot"])
        res.update({f"ag_{name}_y": y, f"ag_{name}_a": a,
                    f"ag_{name}_dx": dx, f"ag_{name}_dw": dw,
                    f"ag_{name}_y_fn": yy})
    res["rs_y"] = ring.matmul_reduce_scatter(g["rs_x"], g["rs_w"])
    x = g["rs_x"].clone().requires_grad_()
    w = g["rs_w"].clone().requires_grad_()
    yy = cm.ProcessMatmulReduceScatter.apply(ring, x, w)
    res["rs_dx"], res["rs_dw"] = torch.autograd.grad(yy, (x, w),
                                                     g["rs_cot"])
    for reverse in (False, True):
        tag = "left" if reverse else "right"
        res[f"shift_{tag}"] = ring.ring_shift(g["shift_x"], reverse)
        x = g["shift_x"].clone().float().requires_grad_()
        (yy,) = cm.ProcessRingShift.apply(ring, reverse, False, x)
        (res[f"shift_{tag}_dx"],) = torch.autograd.grad(
            yy, (x,), g["shift_cot"].float())
        res[f"shift_{tag}_plain"] = ring.ring_shift_ref(g["shift_x"],
                                                        reverse)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        res["plain_ag_even_y"], _ = ring.all_gather_matmul_ref(
            g["ag_even_x"], g["ag_even_w"])
        res["plain_rs_y"] = ring.matmul_reduce_scatter_ref(g["rs_x"],
                                                           g["rs_w"])
    res["launches"] = np.array([fn.launches for fn in counters])
    ring.close()
    _save(out, r, res)
    dist.destroy_process_group()


def _refusals(mesh, cfg) -> dict:
    """Each strategy the process mesh does not run yet
    (:data:`STILL_REFUSED`), and what it raised."""
    import dataclasses

    from tpu_dra_torch.workloads import fit, lora, moe, quant
    calls = {
        "make_moe_train_step": lambda: moe.make_moe_train_step(cfg, mesh),
        "make_moe_optax_step": lambda: moe.make_moe_optax_step(
            cfg, mesh, zero1=True),
        "make_lora_train_step": lambda: lora.make_lora_train_step(cfg, mesh),
        "serving_param_shardings": lambda: quant.serving_param_shardings(
            cfg, mesh, {}),
        "fit of a MoEConfig": lambda: fit.fit(
            moe.MoEConfig(**dataclasses.asdict(cfg), n_experts=2),
            "no-such-corpus.bin", steps=1, batch=2, mesh=mesh),
    }
    said = {}
    for name, call in calls.items():
        try:
            call()
            said[name] = "ran"
        except NotImplementedError as e:
            said[name] = str(e)
    return said


def mesh_main(out: Path, axes: dict) -> None:
    import torch.distributed as dist

    from tpu_dra_torch import convert
    from tpu_dra_torch.workloads import collective_matmul as cm
    from tpu_dra_torch.workloads import flash, ring_attention
    from tpu_dra_torch.workloads.mesh import ProcessMesh
    from tpu_dra_torch.workloads.ring_attention import make_ring_train_step
    from tpu_dra_torch.workloads.train import ModelConfig, tree_leaves
    _join()
    r = dist.get_rank()
    cuda_seen = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        ProcessMesh(axes)
        no_cuda = "built"
    except RuntimeError as e:
        no_cuda = str(e)
    torch.cuda.is_available = cuda_seen
    mesh = ProcessMesh(axes, device="cpu")
    info = {"no_cuda": no_cuda, "coords": mesh.coords}
    x = torch.arange(4 * 8 * 12, dtype=torch.float32).reshape(4, 8, 12)
    specs = [(mesh.batch_axes(), "sp"), (None, "sp"),
             (None, None, tuple(mesh.axes)), ()]
    info["round_trips"] = [bool(torch.equal(
        mesh.unshard(mesh.shard(x, spec), spec), x)) for spec in specs]
    info["shard_shapes"] = [list(mesh.shard(x, spec).shape)
                            for spec in specs]
    cfg = ModelConfig(**json.loads((out / "cfg.json").read_text()))
    info["refusals"] = _refusals(mesh, cfg)
    params = convert.load_npz(out / "params.npz", "cpu")
    with np.load(out / "tokens.npz") as data:
        tokens = torch.from_numpy(data["tokens"])
        targets = torch.from_numpy(data["targets"])
    res = {}
    ring = mesh.ring("sp")
    spec = (mesh.batch_axes(), None, "sp", None)
    for engine, hop_impl, kv in ATTN_CASES:
        fn = ring_attention.ring_attention_flash_group if engine == "flash" \
            else ring_attention.ring_attention_group
        local = [mesh.shard(t, spec).requires_grad_()
                 for t in attn_inputs(kv)]
        y = fn(*local, ring, causal=True, hop_impl=hop_impl)
        tag = f"attn_{engine}_{hop_impl}_kv{kv}"
        res[tag] = y
        grads = torch.autograd.grad(y.float().sum(), local)
        for name, g in zip("qkv", grads):
            res[f"{tag}_d{name}"] = g
    counters = (cm.ring_shift, flash.flash_attn_fwd)
    for ring_impl, hop_impl in STEPS:
        step, spec = make_ring_train_step(cfg, mesh, lr=LR,
                                          ring_impl=ring_impl,
                                          hop_impl=hop_impl)
        info["spec"] = list(spec)
        new, loss = step(params, tokens, targets)
        tag = f"{ring_impl}_{hop_impl}"
        res[f"{tag}_loss"] = loss
        for i, leaf in enumerate(tree_leaves(new)):
            res[f"{tag}_leaf{i}"] = leaf
    info["launches"] = [fn.launches for fn in counters]
    mesh.close()
    (out / f"rank{r}.json").write_text(json.dumps(info))
    _save(out, r, res)
    dist.destroy_process_group()


def flat_tree(tree: dict, prefix: str = "") -> dict:
    """A nested dict's leaves under ``/``-joined keys."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _count_calls(owner, names: list) -> dict:
    """``{name: 0}``, which every later call of ``owner.name`` adds one
    to (the function keeps running as before; a kernel wrapper's
    ``launches``, which it adds to through its module's name, moves to
    the counting function in its place)."""
    calls = dict.fromkeys(names, 0)

    def counted(name):
        real = getattr(owner, name)

        def call(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        if hasattr(real, "launches"):
            call.launches = real.launches
        setattr(owner, name, call)
    for name in names:
        counted(name)
    return calls


RING_CALLS = ["all_gather_matmul", "matmul_reduce_scatter"]


def _count_ring_calls() -> dict:
    """:func:`_count_calls` of the process ring's gather and
    reduce-scatter."""
    from tpu_dra_torch.workloads.collective_matmul import ProcessRing
    return _count_calls(ProcessRing, RING_CALLS)


def tp_main(out: Path, axes: dict, device: str) -> None:
    """Each case of ``OUT/cases.json`` (``name``, ``cfg``, ``params``: an
    npz in OUT, ``tokens``: an npz in OUT, ``impl``, ``attn``, ``accum``,
    optionally ``norm``):
    the global parameters cut by ``p_shard`` (``shard_tree``), one step at
    lr 1, and ``{name}_loss``, ``{name}/<leaf>`` (the new tree gathered
    back with ``unshard_tree``) and ``{name}_local/<leaf>`` (this rank's
    new shard) saved; ``rank<r>.json`` holds the mesh coordinates, the
    specs, whether every tree's cut gathers back to itself, the ring
    calls each case made and the ring kernels' launches (each ``[gather,
    reduce-scatter]``) and what the chunked head with label smoothing
    raised."""
    import torch.distributed as dist

    from tpu_dra_torch import convert
    from tpu_dra_torch.workloads import collective_matmul as cm
    from tpu_dra_torch.workloads.mesh import ProcessMesh
    from tpu_dra_torch.workloads.train import (ModelConfig,
                                               make_optax_train_step,
                                               make_sharded_train_step)
    _join()
    r = dist.get_rank()
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    calls = _count_ring_calls()
    # on the card the mesh's own device (cuda:{rank % device_count})
    mesh = ProcessMesh(axes, device=None if device == "cuda" else device)
    dev = mesh.device
    info = {"coords": mesh.coords, "calls": {}, "launches": {},
            "round_trips": {}, "specs": {}}
    kernels = (cm.all_gather_matmul, cm.matmul_reduce_scatter)
    res = {}
    for case in json.loads((out / "cases.json").read_text()):
        name, cfg = case["name"], ModelConfig(**case["cfg"])
        params = convert.load_npz(out / case["params"], "cpu")
        with np.load(out / case["tokens"]) as data:
            tokens = torch.from_numpy(data["tokens"]).to(dev)
        step, p_shard, b_shard = make_sharded_train_step(
            cfg, mesh, lr=1.0, attn_impl=case["attn"],
            accum_steps=case["accum"], norm_impl=case.get("norm", "dense"),
            matmul_impl=case["impl"])
        info["specs"][name] = flat_tree(p_shard)
        info["b_shard"] = list(b_shard)
        local = mesh.shard_tree(params, p_shard)
        back = mesh.unshard_tree(local, p_shard)
        info["round_trips"][name] = all(
            torch.equal(a, flat_tree(params)[k])
            for k, a in flat_tree(back).items())
        local = _to(local, dev)
        calls.update(dict.fromkeys(calls, 0))
        for fn in kernels:
            fn.launches = 0
        new, loss = step(local, tokens)
        info["calls"][name] = [calls[k] for k in RING_CALLS]
        info["launches"][name] = [fn.launches for fn in kernels]
        res[f"{name}_loss"] = loss
        for k, v in flat_tree(mesh.unshard_tree(new, p_shard)).items():
            res[f"{name}/{k}"] = v
        for k, v in flat_tree(new).items():
            res[f"{name}_local/{k}"] = v
    try:
        make_optax_train_step(cfg, mesh, head_impl="chunked",
                              label_smoothing=0.1)
        info["chunked"] = "ran"
    except NotImplementedError as e:
        info["chunked"] = str(e)
    mesh.close()
    (out / f"rank{r}.json").write_text(json.dumps(info))
    _save(out, r, res)
    dist.destroy_process_group()


def _optax_case(case: dict, out: Path, mesh, calls: dict) -> tuple:
    """One case of ``OUT/optax_cases.json`` on ``mesh``: ``kind`` "optax"
    (``make_optax_train_step`` with the case's ``zero1``, ``ls``, ``z``
    and ``head``, ``steps`` steps, one window of ``tokens`` each) or
    "sgd" (one ``make_sharded_train_step`` step at lr 1).  Returns the
    arrays to save (``{name}_loss`` each step; ``{name}/<leaf>`` the
    final tree gathered, and for "optax" ``{name}_mu1/<leaf>`` after
    step 1 and ``{name}_mu/``, ``{name}_nu/`` after the last, global)
    and the case's info (ring calls, launches, moment bytes held and
    ``opt_state_bytes_per_rank``, and the clip's squared norm from the
    shards against the gathered gradients')."""
    from tpu_dra_torch import convert
    from tpu_dra_torch.workloads import collective_matmul as cm
    from tpu_dra_torch.workloads import train
    from tpu_dra_torch.workloads.process_train import make_process_grads
    name, cfg = case["name"], train.ModelConfig(**case["cfg"])
    dev = mesh.device
    params = convert.load_npz(out / case["params"], "cpu")
    with np.load(out / case["tokens"]) as data:
        windows = torch.from_numpy(data["tokens"]).to(dev)
    kernels = (cm.all_gather_matmul, cm.matmul_reduce_scatter)
    calls.update(dict.fromkeys(calls, 0))
    for fn in kernels:
        fn.launches = 0
    res, info = {}, {}
    head = case.get("head", "dense")
    if case["kind"] == "sgd":
        step, p_shard, _ = train.make_sharded_train_step(
            cfg, mesh, lr=1.0, attn_impl=case["attn"], head_impl=head,
            matmul_impl=case["impl"])
        local = _to(mesh.shard_tree(params, p_shard), dev)
        local, loss = step(local, windows[0])
        res[f"{name}_loss"] = torch.stack([loss])
    else:
        step, init, p_shard, _ = train.make_optax_train_step(
            cfg, mesh, attn_impl=case["attn"], head_impl=head,
            label_smoothing=case.get("ls", 0.0), z_loss=case.get("z", 0.0),
            zero1=case["zero1"], matmul_impl=case["impl"])
        local = _to(mesh.shard_tree(params, p_shard), dev)
        if case.get("norm"):
            grads, _, _ = make_process_grads(
                cfg, mesh, case["attn"], head, 1, "dense", case["impl"])
            _, g = grads(local, windows[0])
            whole = mesh.unshard_tree(g, p_shard)
            info["norm"] = [float(init.layout.sum_squares(g)), float(sum(
                t.double().square().sum()
                for t in train.tree_leaves(whole)))]
            calls.update(dict.fromkeys(calls, 0))
            for fn in kernels:
                fn.launches = 0
        opt = init(local)
        losses = []
        for i in range(case["steps"]):
            local, opt, loss = step(local, opt, windows[i])
            losses.append(loss)
            if i == 0:
                for k, v in flat_tree(opt.to_dict()["mu"]).items():
                    res[f"{name}_mu1/{k}"] = v.clone()
        res[f"{name}_loss"] = torch.stack(losses)
        state = opt.to_dict()
        for key in ("mu", "nu"):
            for k, v in flat_tree(state[key]).items():
                res[f"{name}_{key}/{k}"] = v
        sh, _ = train.opt_state_shardings(None, train.param_shapes(cfg),
                                          p_shard, mesh, case["zero1"])
        info["bytes"] = [
            sum(4 * t.numel() for key in ("mu", "nu")
                for t in train.tree_leaves(getattr(opt, key))),
            train.opt_state_bytes_per_rank(sh, train.param_shapes(cfg),
                                           mesh)]
    info["calls"] = [calls[k] for k in RING_CALLS]
    info["launches"] = [fn.launches for fn in kernels]
    for k, v in flat_tree(mesh.unshard_tree(local, p_shard)).items():
        res[f"{name}/{k}"] = v
    return res, info


def _fit_runs(out: Path, mesh) -> tuple:
    """``fit`` on the process mesh with ``OUT/fit.json``'s config and
    corpus (batch 2): replicated and ZeRO-1 runs of 6 steps (the second
    saving at 6 in ``ck-full``), a ZeRO-1 run of 3 saving at 3 in ``ck``
    (copied to ``ck3`` before a second run resumes it for 3), a run
    resuming the virtual mesh's step-3 checkpoint in ``vck`` for 3, and
    what a ``MoEConfig`` raises."""
    import shutil

    import torch.distributed as dist

    from tpu_dra_torch.workloads import fit as tfit
    from tpu_dra_torch.workloads.moe import MoEConfig
    from tpu_dra_torch.workloads.train import ModelConfig
    spec = json.loads((out / "fit.json").read_text())
    cfg, data = ModelConfig(**spec["cfg"]), spec["data"]
    kw = dict(batch=2, log_every=1, mesh=mesh, log_fn=lambda s: None)
    losses = {"plain": tfit.fit(cfg, data, steps=6, **kw).losses,
              "zero1": tfit.fit(cfg, data, steps=6, zero1=True,
                                checkpoint_dir=str(out / "ck-full"),
                                checkpoint_every=6, **kw).losses}
    ck = str(out / "ck")
    tfit.fit(cfg, data, steps=3, zero1=True, checkpoint_dir=ck,
             checkpoint_every=3, **kw)
    if mesh.rank == 0:
        shutil.copytree(ck, out / "ck3")
    dist.barrier()
    resumed = tfit.fit(cfg, data, steps=3, zero1=True, checkpoint_dir=ck,
                       checkpoint_every=3, resume=True, **kw)
    losses["resumed"], info = resumed.losses, {"resumed_step": resumed.step}
    losses["crossed"] = tfit.fit(cfg, data, steps=3, zero1=True,
                                 checkpoint_dir=str(out / "vck"),
                                 resume=True, **kw).losses
    try:
        tfit.fit(MoEConfig(**spec["cfg"], n_experts=2), data, steps=1, **kw)
        info["moe"] = "ran"
    except NotImplementedError as e:
        info["moe"] = str(e)
    return {f"fit_{k}": torch.tensor(v) for k, v in losses.items()}, info


def optax_main(out: Path, axes: dict, device: str) -> None:
    """Each case of ``OUT/optax_cases.json`` (:func:`_optax_case`) on a
    ``ProcessMesh`` of AXES over DEVICE, then, where ``OUT/fit.json``
    exists, :func:`_fit_runs`; ``rank<r>.json`` holds each case's info
    and the fit runs'."""
    import torch.distributed as dist

    from tpu_dra_torch.workloads.mesh import ProcessMesh
    _join()
    r = dist.get_rank()
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    calls = _count_ring_calls()
    mesh = ProcessMesh(axes, device=None if device == "cuda" else device)
    res, info = {}, {"cases": {}}
    for case in json.loads((out / "optax_cases.json").read_text()):
        got, info["cases"][case["name"]] = _optax_case(case, out, mesh,
                                                        calls)
        res.update(got)
    if (out / "fit.json").exists():
        got, info["fit"] = _fit_runs(out, mesh)
        res.update(got)
    mesh.close()
    (out / f"rank{r}.json").write_text(json.dumps(info))
    _save(out, r, res)
    dist.destroy_process_group()


def attn_main(out: Path, axes: dict, device: str) -> None:
    """On a ``ProcessMesh`` of AXES over DEVICE: each zigzag case
    (``zz_{impl}_kv{kv}``) and maker case (``ring_{engine}_{hop}_kv{kv}``)
    on the global inputs of :func:`maker_inputs` (``OUT/attn.json``, where
    it exists, names the ``shape``, the ``zigzag`` and the ``makers``
    cases instead of the defaults), its global output and
    the q, k, v gradients of a fixed cotangent (``_dq``, ``_dk``,
    ``_dv``); ``kv_handoff.ici_shift`` of this rank's block of
    :func:`handoff_tree` one hop right and left over the ring of "sp"
    (``shift_right/<leaf>``, ``shift_left/<leaf>``, the leaf's bytes
    kept: int8 and fp32 as they are, bf16 as its int16 view).
    ``rank<r>.json`` holds each case's flash forward and backward calls,
    its shift calls (``[ring_shift, ring_shift_ref]``), and the kernels'
    launch counts."""
    import torch.distributed as dist

    from tpu_dra_torch.workloads import collective_matmul as cm
    from tpu_dra_torch.workloads import flash
    from tpu_dra_torch.workloads import ring_attention as tra
    from tpu_dra_torch.workloads.kv_handoff import ici_shift
    from tpu_dra_torch.workloads.mesh import ProcessMesh
    _join()
    r = dist.get_rank()
    if device == "cuda":
        torch.cuda.set_device(0)
    mesh = ProcessMesh(axes, device=None if device == "cuda" else device)
    dev = mesh.device
    fl = _count_calls(flash, ["flash_attn_fwd", "flash_attn_bwd"])
    hops = _count_calls(cm.ProcessRing, ["ring_shift", "ring_shift_ref"])
    kernels = (cm.ring_shift, flash.flash_attn_fwd, flash.flash_bwd_dq,
               flash.flash_bwd_dkdv)
    info = {"coords": mesh.coords, "calls": {}, "hops": {},
            "launches": {}}
    res = {}
    spec = json.loads((out / "attn.json").read_text()) \
        if (out / "attn.json").exists() else {}
    shape = tuple(spec.get("shape", MAKER_SHAPE))

    def run(tag, fn, kv):
        q, k, v, cot = (t.to(dev) for t in maker_inputs(kv, shape))
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        for c in (fl, hops):
            c.update(dict.fromkeys(c, 0))
        for fn_ in kernels:
            fn_.launches = 0
        y = fn(*ins)
        grads = torch.autograd.grad(y, ins, cot)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        info["calls"][tag] = [fl["flash_attn_fwd"], fl["flash_attn_bwd"]]
        info["hops"][tag] = [hops["ring_shift"], hops["ring_shift_ref"]]
        info["launches"][tag] = [getattr(f, "launches", 0) for f in kernels]
        res[tag] = y
        for name, g in zip("qkv", grads):
            res[f"{tag}_d{name}"] = g

    for impl, kv in spec.get("zigzag", ZIGZAG_CASES):
        run(f"zz_{impl}_kv{kv}",
            tra.make_zigzag_ring_attention(mesh, impl=impl), kv)
    for engine, hop, kv in spec.get("makers", MAKER_CASES):
        make = tra.make_ring_attention_flash if engine == "flash" else \
            tra.make_ring_attention
        run(f"ring_{engine}_{hop}_kv{kv}", make(mesh, hop_impl=hop), kv)
    ring = mesh.ring("sp")
    mine = {k: v[ring.rank].to(dev)
            for k, v in handoff_tree(ring.n).items()}
    for reverse in (False, True):
        cm.ring_shift.launches = 0
        got = ici_shift(mine, reverse=reverse, ring=ring)
        way = "left" if reverse else "right"
        info["launches"][f"shift_{way}"] = cm.ring_shift.launches
        for k, t in got.items():
            res[f"shift_{way}/{k}"] = t.view(torch.int16) \
                if t.dtype == torch.bfloat16 else t
    mesh.close()
    (out / f"rank{r}.json").write_text(json.dumps(info))
    np.savez(out / f"rank{r}.npz", **{
        k: v.detach().cpu().numpy() if v.dtype in (
            torch.int8, torch.int16) else v.detach().float().cpu().numpy()
        for k, v in res.items()})
    dist.destroy_process_group()


def pipe_main(out: Path, axes: dict, device: str) -> None:
    """Each case of ``OUT/pipe_cases.json`` (``name``, ``cfg``, ``params``
    and ``tokens`` npz files in OUT, ``head``, ``n_micro``) on a
    ``ProcessMesh`` of AXES (dp × pp) over DEVICE: the global parameters
    cut by ``p_shard``, one GPipe step at lr 1, ``{name}_loss``,
    ``{name}/<leaf>`` (the new tree gathered) and ``{name}_local/<leaf>``
    (this process's shards) saved; ``rank<r>.json`` holds the mesh
    coordinates, the specs and :func:`_refusals`."""
    import torch.distributed as dist

    from tpu_dra_torch import convert
    from tpu_dra_torch.workloads.mesh import ProcessMesh
    from tpu_dra_torch.workloads.pipeline import make_pipeline_train_step
    from tpu_dra_torch.workloads.train import ModelConfig
    _join()
    r = dist.get_rank()
    if device == "cuda":
        torch.cuda.set_device(0)
    mesh = ProcessMesh(axes, device=None if device == "cuda" else device)
    dev = mesh.device
    info = {"coords": mesh.coords, "specs": {}}
    res = {}
    for case in json.loads((out / "pipe_cases.json").read_text()):
        name, cfg = case["name"], ModelConfig(**case["cfg"])
        params = convert.load_npz(out / case["params"], "cpu")
        with np.load(out / case["tokens"]) as data:
            tokens = torch.from_numpy(data["tokens"]).to(dev)
        step, p_shard, t_shard = make_pipeline_train_step(
            cfg, mesh, n_micro=case["n_micro"], lr=1.0,
            head_impl=case["head"])
        info["specs"][name] = [flat_tree(p_shard), list(t_shard)]
        new, loss = step(_to(mesh.shard_tree(params, p_shard), dev), tokens)
        res[f"{name}_loss"] = loss
        for k, v in flat_tree(mesh.unshard_tree(new, p_shard)).items():
            res[f"{name}/{k}"] = v
        for k, v in flat_tree(new).items():
            res[f"{name}_local/{k}"] = v
    info["refusals"] = _refusals(mesh, cfg)
    mesh.close()
    (out / f"rank{r}.json").write_text(json.dumps(info))
    _save(out, r, res)
    dist.destroy_process_group()


def _to(tree: dict, dev) -> dict:
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


if __name__ == "__main__":
    what, out = sys.argv[1], Path(sys.argv[2])
    if what == "ring":
        ring_main(out, sys.argv[3])
    elif what == "tp":
        tp_main(out, json.loads(sys.argv[3]), sys.argv[4])
    elif what == "optax":
        optax_main(out, json.loads(sys.argv[3]), sys.argv[4])
    elif what == "attn":
        attn_main(out, json.loads(sys.argv[3]), sys.argv[4])
    elif what == "pipe":
        pipe_main(out, json.loads(sys.argv[3]), sys.argv[4])
    else:
        mesh_main(out, json.loads(sys.argv[3]))
