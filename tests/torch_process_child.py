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
    python tests/torch_process_child.py moe OUT AXES_JSON DEVICE
    python tests/torch_process_child.py lora OUT AXES_JSON DEVICE
    python tests/torch_process_child.py decode OUT MESHES_JSON DEVICE
    python tests/torch_process_child.py slices OUT DEVICE

``ring``: the group ring's forward and VJP cases (:func:`ring_inputs`,
the same global inputs on every rank) on DEVICE ("cpu": the group plain
versions; "cuda": the kernels across processes).  ``mesh``: on a
``ProcessMesh`` of AXES over the CPU, shard and unshard round trips,
the strategies that once refused a process mesh (:func:`_strategies`),
and the DP×SP step of ``OUT/params.npz`` on
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
case in ``OUT/pipe_cases.json`` and :func:`_strategies`
(:func:`pipe_main`).  ``moe``: on a ``ProcessMesh`` of AXES (dp × ep)
over DEVICE, the MoE SGD and AdamW steps of each case in
``OUT/moe_cases.json``, the router on its rows, and MoE ``fit``
(:func:`moe_main`).  ``lora``: on a ``ProcessMesh`` of AXES (dp × tp)
over DEVICE, the LoRA step over each case's plain, int8 or int4 base
cut by ``serving_param_shardings``, and the straddling int4 tree
(:func:`lora_main`).  ``decode``: on each process mesh of
MESHES_JSON (a list of axes) over DEVICE, the tensor-parallel decoders
of ``OUT/decode_cases.json``'s cases (:func:`decode_main`).
``slices``: the packed loss on dp 2 × tp 2 and the DP×TP and ring-SP
steps on three-axis meshes over DEVICE (:func:`slices_main`).

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
# the strategies the process mesh runs since it took the last of them:
# each runs on every process of the mesh and pipeline tests' groups, on a
# config whose heads and experts split over 4 ranks
PORTED_LAST = ("make_moe_train_step", "make_moe_optax_step",
               "make_lora_train_step", "serving_param_shardings",
               "fit of a MoEConfig")
STRATEGY_CFG = dict(vocab=32, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                    max_seq=16)


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


def _seeded(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _strategies(mesh, out: Path) -> dict:
    """Each strategy that once refused a process mesh
    (:data:`PORTED_LAST`), run on every process of ``mesh``'s group: on
    a process mesh of the same dp and of its other axis renamed "ep" (the
    MoE steps and ``fit``) or "tp" (LoRA and the serving shardings), one
    step of :data:`STRATEGY_CFG` from seeded parameters (a ``fit`` of one
    step on a corpus rank 0 writes), or the int8 serving tree cut and
    gathered back.  What each gave: ``"ran"`` with a finite loss or a
    byte-equal round trip, else what it raised or saw."""
    import torch.distributed as dist

    from tpu_dra_torch.workloads import fit, lora, moe, quant, train
    from tpu_dra_torch.workloads.mesh import ProcessMesh
    dp = mesh.axis_size("dp")
    other = mesh.size // dp
    dev = mesh.device
    cfg = train.ModelConfig(**STRATEGY_CFG)
    mcfg = moe.MoEConfig(**STRATEGY_CFG, n_experts=4, router_top_k=2)
    ep = ProcessMesh({"dp": dp, "ep": other}, device=dev)
    tp = ProcessMesh({"dp": dp, "tp": other}, device=dev)
    windows = torch.randint(0, cfg.vocab, (2 * dp, cfg.max_seq + 1),
                            generator=_seeded(9)).to(dev)
    corpus = out / "strategy-corpus.bin"
    if mesh.rank == 0:
        np.random.default_rng(9).integers(
            0, cfg.vocab, 4000, dtype=np.uint16).tofile(corpus)
    dist.barrier()

    def moe_step():
        step, p_shard, _ = moe.make_moe_train_step(mcfg, ep, lr=1.0)
        params = ep.shard_tree(moe.init_moe_params(mcfg, _seeded(1)),
                               p_shard)
        return step(_to(params, dev), windows)[1]

    def moe_optax():
        step, init, p_shard, _ = moe.make_moe_optax_step(mcfg, ep,
                                                         zero1=True)
        params = _to(ep.shard_tree(moe.init_moe_params(mcfg, _seeded(1)),
                                   p_shard), dev)
        return step(params, init(params), windows)[2]

    def lora_step():
        step, init, lcfg, sh = lora.make_lora_train_step(cfg, tp)
        base = train.init_params(cfg, _seeded(2))
        adapters = _to(lora.init_lora(base, lcfg, _seeded(3)), dev)
        base = _to(tp.shard_tree(base, sh["params"]), dev)
        return step(base, adapters, init(adapters), windows)[2]

    def serving():
        tree = quant.quantize_params_int8(train.init_params(cfg,
                                                            _seeded(4)))
        specs = quant.serving_param_shardings(cfg, tp, tree)
        back = tp.unshard_tree(tp.shard_tree(tree, specs), specs)
        same = all(torch.equal(a, b) for a, b in zip(
            train.tree_leaves(back), train.tree_leaves(tree)))
        return torch.tensor(0.0 if same else float("nan"))

    def moe_fit():
        return torch.tensor(fit.fit(
            mcfg, str(corpus), steps=1, batch=2 * dp,
            mesh=ep, log_fn=lambda s: None).loss)

    calls = {"make_moe_train_step": moe_step,
             "make_moe_optax_step": moe_optax,
             "make_lora_train_step": lora_step,
             "serving_param_shardings": serving,
             "fit of a MoEConfig": moe_fit}
    said = {}
    for name, call in calls.items():
        try:
            got = call()
            said[name] = "ran" if bool(torch.isfinite(got)) else \
                f"{name} gave {float(got)}"
        except (NotImplementedError, ValueError) as e:
            said[name] = str(e)
    ep.close()
    tp.close()
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
    info["strategies"] = _strategies(mesh, out)
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
    one step of a ``MoEConfig`` on a process mesh of the same dp whose
    other axis is "ep" (its loss and step)."""
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
    from tpu_dra_torch.workloads.mesh import ProcessMesh
    dp = mesh.axis_size("dp")
    ep = ProcessMesh({"dp": dp, "ep": mesh.size // dp}, device=mesh.device)
    moe = tfit.fit(MoEConfig(**spec["cfg"], n_experts=4), data, steps=1,
                   **dict(kw, mesh=ep))
    info["moe"] = ["ran", moe.loss, moe.step]
    ep.close()
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
    coordinates, the specs and :func:`_strategies`."""
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
    info["strategies"] = _strategies(mesh, out)
    mesh.close()
    (out / f"rank{r}.json").write_text(json.dumps(info))
    _save(out, r, res)
    dist.destroy_process_group()


def _moe_case(case: dict, out: Path, mesh, fl: dict) -> tuple:
    """One case of ``OUT/moe_cases.json`` on a ``{"dp", "ep"}`` mesh:
    ``kind`` "sgd" (one ``make_moe_train_step`` step at lr 1 from the
    case's parameters on window 0, and, where the case names ``pins``,
    the same step again with the virtual step's router choices replayed
    on this process's rows: ``{name}_pin...``) or "optax"
    (``make_moe_optax_step`` with the case's ``zero1`` for ``steps``
    steps, one window each, the first replaying ``pins`` where named).  Returns the arrays to save (as
    :func:`_optax_case` names them, plus ``{name}_local/<leaf>``, this
    process's new shards) and the case's info (the flash calls
    ``[forward, backward]`` of the first step, the clip's squared norm
    from the shards against the gathered gradients', the moment bytes,
    the pins replayed)."""
    from tpu_dra_torch import convert
    from tpu_dra_torch.workloads import moe, train
    name, cfg = case["name"], moe.MoEConfig(**case["cfg"])
    dev = mesh.device
    params = convert.load_npz(out / case["params"], "cpu")
    with np.load(out / case["tokens"]) as data:
        windows = torch.from_numpy(data["tokens"]).to(dev)
    res, info = {}, {}
    fl.update(dict.fromkeys(fl, 0))
    if case["kind"] == "sgd":
        step, p_shard, t_shard = moe.make_moe_train_step(
            cfg, mesh, lr=1.0, attn_impl=case["attn"])
        info["t_shard"] = list(t_shard)
        local = _to(mesh.shard_tree(params, p_shard), dev)
        new, loss = step(local, windows[0])
        info["flash"] = [fl["flash_attn_fwd"], fl["flash_attn_bwd"]]
        res[f"{name}_loss"] = torch.stack([loss])
        if case.get("pins"):
            recorded = _pins(out / case["pins"], mesh, windows[0])
            with moe.PinnedChoices.replaying(recorded) as pin:
                pinned, ploss = step(local, windows[0])
            info["pins"] = [pin.replayed, len(recorded)]
            res[f"{name}_pin_loss"] = torch.stack([ploss])
            for k, v in flat_tree(mesh.unshard_tree(pinned,
                                                    p_shard)).items():
                res[f"{name}_pin/{k}"] = v
    else:
        step, init, p_shard, _ = moe.make_moe_optax_step(
            cfg, mesh, attn_impl=case["attn"], zero1=case["zero1"])
        new = _to(mesh.shard_tree(params, p_shard), dev)
        if case.get("norm"):
            grads, _, _ = moe._process_grads(cfg, mesh, case["attn"],
                                             "dense")
            _, g = grads(new, windows[0])
            whole = mesh.unshard_tree(g, p_shard)
            info["norm"] = [float(init.layout.sum_squares(g)), float(sum(
                t.double().square().sum()
                for t in train.tree_leaves(whole)))]
        opt = init(new)
        losses = []
        for i in range(case["steps"]):
            if i == 0 and case.get("pins"):
                recorded = _pins(out / case["pins"], mesh, windows[0])
                with moe.PinnedChoices.replaying(recorded) as pin:
                    new, opt, loss = step(new, opt, windows[0])
                info["pins"] = [pin.replayed, len(recorded)]
            else:
                new, opt, loss = step(new, opt, windows[i])
            losses.append(loss)
            if i == 0:
                for k, v in flat_tree(opt.to_dict()["mu"]).items():
                    res[f"{name}_mu1/{k}"] = v.clone()
        res[f"{name}_loss"] = torch.stack(losses)
        state = opt.to_dict()
        for key in ("mu", "nu"):
            for k, v in flat_tree(state[key]).items():
                res[f"{name}_{key}/{k}"] = v
        shapes = train.param_shapes(cfg, moe.init_moe_params)
        sh, _ = train.opt_state_shardings(None, shapes, p_shard, mesh,
                                          case["zero1"])
        info["bytes"] = [
            sum(4 * t.numel() for key in ("mu", "nu")
                for t in train.tree_leaves(getattr(opt, key))),
            train.opt_state_bytes_per_rank(sh, shapes, mesh)]
    for k, v in flat_tree(mesh.unshard_tree(new, p_shard)).items():
        res[f"{name}/{k}"] = v
    for k, v in flat_tree(new).items():
        res[f"{name}_local/{k}"] = v
    return res, info


def _pins(path: Path, mesh, window) -> list:
    """The router choices of a virtual-mesh step on the global ``window``
    (``pin<i>`` in the npz at ``path``, one a router call), cut to this
    process's dp rows."""
    n = window.shape[0] // mesh.axis_size("dp") * (window.shape[1] - 1)
    lo = mesh.axis_index("dp") * n
    with np.load(path) as data:
        return [torch.from_numpy(data[f"pin{i}"][lo:lo + n]).to(
            mesh.device) for i in range(len(data.files))]


def _moe_route(out: Path, mesh) -> dict:
    """``moe.moe_ffn`` on this process's rows of ``OUT/route.npz``'s
    global ``x [B, S, D]`` (with its ``wg``, and its banks cut over
    "ep"), the config of ``OUT/route.json``: the output rows, the aux
    share and the dispatch ``[K, N_local, E, C]`` its router claimed."""
    from tpu_dra_torch.workloads import moe
    cfg = moe.MoEConfig(**json.loads((out / "route.json").read_text()))
    dev = mesh.device
    with np.load(out / "route.npz") as data:
        x, wg, w1, w2 = (torch.from_numpy(data[k]).to(dev)
                         for k in ("x", "wg", "w1", "w2"))
    seen = {}
    real = moe.process_route

    def record(*a, **k):
        got = real(*a, **k)
        seen["disp"] = got[3]
        return got
    moe.process_route = record
    try:
        y, aux = moe.moe_ffn(cfg, mesh.shard(x, ("dp", None, None)), wg,
                             mesh.shard(w1, ("ep", None, None)),
                             mesh.shard(w2, ("ep", None, None)), mesh=mesh)
    finally:
        moe.process_route = real
    return {"route_out": y, "route_aux": aux, "route_disp": seen["disp"]}


def _moe_fit_runs(out: Path, mesh) -> tuple:
    """``fit`` of ``OUT/moe_fit.json``'s MoE config and corpus on the
    process mesh (ZeRO-1, batch 4, flash attention): 4 steps saving at 4
    in ``ck-full``, 2 saving at 2 in ``ck`` (copied to ``ck2``), 2 more
    resumed from it saving at 4, and 1 resumed from the virtual mesh's
    step-2 checkpoint in ``vck``."""
    import shutil

    import torch.distributed as dist

    from tpu_dra_torch.workloads import fit as tfit
    from tpu_dra_torch.workloads.moe import MoEConfig
    spec = json.loads((out / "moe_fit.json").read_text())
    cfg, data = MoEConfig(**spec["cfg"]), spec["data"]
    kw = dict(batch=4, log_every=1, mesh=mesh, zero1=True,
              attn_impl=spec["attn"], log_fn=lambda s: None)
    losses = {"full": tfit.fit(cfg, data, steps=4,
                               checkpoint_dir=str(out / "ck-full"),
                               checkpoint_every=4, **kw).losses}
    ck = str(out / "ck")
    tfit.fit(cfg, data, steps=2, checkpoint_dir=ck, checkpoint_every=2,
             **kw)
    if mesh.rank == 0:
        shutil.copytree(ck, out / "ck2")
    dist.barrier()
    resumed = tfit.fit(cfg, data, steps=2, checkpoint_dir=ck,
                       checkpoint_every=2, resume=True, **kw)
    losses["resumed"], info = resumed.losses, {"resumed_step": resumed.step}
    losses["crossed"] = tfit.fit(cfg, data, steps=1,
                                 checkpoint_dir=str(out / "vck"),
                                 resume=True, **kw).losses
    return {f"fit_{k}": torch.tensor(v) for k, v in losses.items()}, info


def moe_main(out: Path, axes: dict, device: str) -> None:
    """On a ``ProcessMesh`` of AXES (dp × ep) over DEVICE: each case of
    ``OUT/moe_cases.json`` (:func:`_moe_case`), then :func:`_moe_route`
    and :func:`_moe_fit_runs` where their files exist.
    ``rank<r>.json`` holds the coordinates, each case's info and the fit
    runs'."""
    import torch.distributed as dist

    from tpu_dra_torch.workloads import flash
    from tpu_dra_torch.workloads.mesh import ProcessMesh
    _join()
    r = dist.get_rank()
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    fl = _count_calls(flash, ["flash_attn_fwd", "flash_attn_bwd"])
    mesh = ProcessMesh(axes, device=None if device == "cuda" else device)
    res, info = {}, {"coords": mesh.coords, "cases": {}}
    for case in json.loads((out / "moe_cases.json").read_text()):
        got, info["cases"][case["name"]] = _moe_case(case, out, mesh, fl)
        res.update(got)
    if (out / "route.json").exists():
        res.update(_moe_route(out, mesh))
    if (out / "moe_fit.json").exists():
        got, info["fit"] = _moe_fit_runs(out, mesh)
        res.update(got)
    mesh.close()
    (out / f"rank{r}.json").write_text(json.dumps(info))
    _save(out, r, res)
    dist.destroy_process_group()


def _serving_tree(params: dict, form: str, group: int) -> dict:
    from tpu_dra_torch.workloads import quant
    if form == "int8":
        return quant.quantize_params_int8(params)
    if form == "int4":
        return quant.quantize_params_int4(params, group)
    if form == "bf16":
        return quant.cast_params_bf16(params)
    return params


def lora_main(out: Path, axes: dict, device: str) -> None:
    """On a ``ProcessMesh`` of AXES (dp × tp) over DEVICE, each case of
    ``OUT/lora_cases.json`` (``name``, ``cfg``, the global ``params``
    and ``lora`` npz files and ``tokens`` ``[steps, B, S+1]`` in OUT,
    ``form`` "plain", "int8" or "int4" with its ``group``, ``attn``,
    ``steps``): the base in its serving form cut by
    ``serving_param_shardings`` (whose specs, gathered back tree and
    local view are checked here), then ``steps`` LoRA steps; saved
    ``{name}_loss`` and ``{name}/<leaf>`` (the adapters).  Then
    ``OUT/straddle.json``'s int4 tree (a group count that divides
    neither tp nor the rows a process holds), cut and gathered, and what
    ``quant.local_serving_tree`` raised on it.  ``rank<r>.json`` holds,
    each case, the specs, whether the gathered tree was byte-equal and
    the base shards unchanged by the steps, and the flash calls."""
    import torch.distributed as dist

    from tpu_dra_torch import convert
    from tpu_dra_torch.workloads import flash, lora, quant, train
    from tpu_dra_torch.workloads.mesh import ProcessMesh
    _join()
    r = dist.get_rank()
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    fl = _count_calls(flash, ["flash_attn_fwd", "flash_attn_bwd"])
    mesh = ProcessMesh(axes, device=None if device == "cuda" else device)
    dev = mesh.device
    res, info = {}, {"coords": mesh.coords, "cases": {}}

    def byte_equal(a: dict, b: dict) -> bool:
        fa, fb = flat_tree(a), flat_tree(b)
        return fa.keys() == fb.keys() and all(
            fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k])
            for k in fa)

    for case in json.loads((out / "lora_cases.json").read_text()):
        name, cfg = case["name"], train.ModelConfig(**case["cfg"])
        base = _serving_tree(convert.load_npz(out / case["params"], "cpu"),
                             case["form"], case.get("group", 128))
        adapters = _to(convert.load_npz(out / case["lora"], "cpu"), dev)
        with np.load(out / case["tokens"]) as data:
            windows = torch.from_numpy(data["tokens"]).to(dev)
        specs = quant.serving_param_shardings(cfg, mesh, base)
        local = mesh.shard_tree(base, specs)
        got = {"specs": {k: list(v) for k, v in flat_tree(specs).items()},
               "gathered": byte_equal(mesh.unshard_tree(local, specs),
                                      base)}
        local = _to(local, dev)
        before = {k: v.clone() for k, v in flat_tree(local).items()}
        step, init, lcfg, _ = lora.make_lora_train_step(
            cfg, mesh, lora.LoRAConfig(rank=case["rank"]),
            attn_impl=case["attn"])
        opt = init(adapters)
        fl.update(dict.fromkeys(fl, 0))
        losses = []
        for i in range(case["steps"]):
            adapters, opt, loss = step(local, adapters, opt, windows[i],
                                       base_specs=specs)
            losses.append(loss)
            if i == 0:
                for k, v in flat_tree(opt.mu).items():
                    res[f"{name}_mu1/{k}"] = v.clone()
        got["flash"] = [fl["flash_attn_fwd"], fl["flash_attn_bwd"]]
        got["base_same"] = byte_equal(local, _unflat(before))
        info["cases"][name] = got
        res[f"{name}_loss"] = torch.stack(losses)
        for k, v in flat_tree(adapters).items():
            res[f"{name}/{k}"] = v
    if (out / "straddle.json").exists():
        spec = json.loads((out / "straddle.json").read_text())
        cfg = train.ModelConfig(**spec["cfg"])
        tree = _serving_tree(convert.load_npz(out / spec["params"], "cpu"),
                             "int4", spec["group"])
        specs = quant.serving_param_shardings(cfg, mesh, tree)
        local = mesh.shard_tree(tree, specs)
        info["straddle"] = {"gathered": byte_equal(
            mesh.unshard_tree(local, specs), tree)}
        try:
            quant.local_serving_tree(mesh, local, specs)
            info["straddle"]["said"] = "ran"
        except ValueError as e:
            info["straddle"]["said"] = str(e)
    mesh.close()
    (out / f"rank{r}.json").write_text(json.dumps(info))
    _save(out, r, res)
    dist.destroy_process_group()


def _checked_paged_attention(paged_kv, seen: dict):
    """``paged_kv.paged_attention`` replaced by a call of it that also
    holds each output to the plain version on the same inputs: ``seen``
    gets the calls and the worst slot's relative L2 error
    (``paged_kv.slot_rel_err``).  The kernel's wrapper counts its
    launches on the module's name, so the stand-in carries
    ``launches``."""
    kernel = paged_kv.paged_attention

    def checked(*args, **kw):
        got = kernel(*args, **kw)
        want = paged_kv.paged_attention_ref(*args, **kw)
        seen["calls"] += 1
        seen["max_slot_rel"] = max(seen["max_slot_rel"], float(
            paged_kv.slot_rel_err(got, want).max()))
        return got
    checked.launches = 0
    paged_kv.paged_attention = checked


def decode_main(out: Path, meshes: list, device: str) -> None:
    """On each ``ProcessMesh`` of MESHES (dp × tp) over DEVICE, each case (``name``, ``cfg``, the global
    ``params`` npz in OUT, ``form`` "bf16", "int8" or "int4" with its
    ``group``, ``cache`` its cache dtype): the serving tree cut by
    ``process_decode.local_tree``, then beam search on
    ``OUT/decode_inputs.npz``'s ``beam_prompt`` (a ``beam`` case, with
    its ``beam_kw``), or on
    its ``prompt`` the tensor-parallel greedy decode, the paged one over
    its ``table``,
    speculative decoding with a one-layer ``truncate_draft`` and the
    first step's logits (the paged decode alone for a ``paged_only``
    case).
    Saved ``{mesh}/{name}/<what>``, and ``{mesh}/argmax`` and
    ``{mesh}/top_*`` of ``ProcessMesh.argmax`` and ``top_w`` over the
    vocab cut of ``OUT/decode_inputs.npz``'s ``ties`` where it has them;
    ``rank<r>.json`` holds each tree's
    local and global bytes a leaf, the target passes, and on the card
    each paged-attention launch held to its plain version
    (``paged_check``)."""
    import torch.distributed as dist

    from tpu_dra_torch import convert
    from tpu_dra_torch.workloads import decode, paged_kv, process_decode
    from tpu_dra_torch.workloads.mesh import ProcessMesh
    from tpu_dra_torch.workloads.spec_draft import truncate_draft
    from tpu_dra_torch.workloads.train import ModelConfig
    _join()
    r = dist.get_rank()
    seen = {"calls": 0, "max_slot_rel": 0.0}
    if device == "cuda":
        torch.cuda.set_device(0)
        _checked_paged_attention(paged_kv, seen)
    spec = json.loads((out / "decode_cases.json").read_text())
    with np.load(out / "decode_inputs.npz") as data:
        inputs = {k: torch.from_numpy(data[k]) for k in data.files}
    run = spec["run"]
    res, info = {}, {"paged_check": seen}
    for axes in meshes:
        mesh = ProcessMesh(axes, device=None if device == "cuda" else device)
        dev = mesh.device
        prompt, table = inputs["prompt"].to(dev), inputs["table"].to(dev)
        tag = "x".join(f"{k}{v}" for k, v in axes.items())
        if "ties" in inputs:
            cut = mesh.shard(inputs["ties"].to(dev), (None, "tp"))
            vl = cut.shape[-1]
            cols = torch.arange(vl, device=dev) + mesh.axis_index("tp") * vl
            res[f"{tag}/argmax"] = mesh.argmax(cut, "tp")
            res[f"{tag}/top_vals"], res[f"{tag}/top_idx"] = mesh.top_w(
                cut, cols, run["ties_w"], "tp")
        for case in spec["cases"]:
            name, cfg = case["name"], ModelConfig(**case["cfg"])
            tree = _serving_tree(convert.load_npz(out / case["params"],
                                                  "cpu"), case["form"],
                                 case.get("group", 128))
            local = _to(process_decode.local_tree(cfg, mesh, tree), dev)
            key = f"{tag}/{name}"
            kw = dict(max_len=run["max_len"], cache_dtype=case["cache"])
            whole = flat_tree(tree)
            info[key] = {"bytes": {
                k: [v.numel() * v.element_size(),
                    whole[k].numel() * whole[k].element_size()]
                for k, v in flat_tree(local).items() if torch.is_tensor(v)}}
            if case["beam"]:
                hist, scores = decode.beam_decode(
                    cfg, local, inputs["beam_prompt"].to(dev),
                    steps=run["beam_steps"],
                    beams=run["beams"], mesh=mesh, **kw, **case["beam_kw"])
                res[f"{key}/beam"], res[f"{key}/beam_scores"] = hist, scores
                continue
            res[f"{key}/paged"] = paged_kv.paged_greedy_decode(
                cfg, local, prompt, table, steps=run["steps"],
                total_pages=run["total_pages"], page_size=run["page_size"],
                cache_dtype=case["cache"], mesh=mesh)
            if case.get("paged_only"):
                continue
            res[f"{key}/greedy"] = decode.greedy_decode(
                cfg, local, prompt, steps=run["steps"], mesh=mesh, **kw)
            dcfg, dparams = truncate_draft(cfg, local, 1)
            res[f"{key}/spec"], stats = decode.speculative_decode(
                cfg, local, dcfg, dparams, prompt, steps=run["steps"],
                k=run["k"], return_stats=True, mesh=mesh, **kw)
            res[f"{key}/logits"] = process_decode.first_logits(
                cfg, local, prompt, mesh, **kw)
            info[key]["passes"] = stats["target_passes"]
        mesh.close()
    (out / f"rank{r}.json").write_text(json.dumps(info))
    _save(out, r, res)
    dist.destroy_process_group()


def slices_main(out: Path, device: str) -> None:
    """On ``ProcessMesh``es over DEVICE of the four processes:
    ``OUT/slices.json``'s ``packed`` cases (``train.packed_loss_fn`` on
    dp 2 × tp 2 of this process's shards of ``params``, each set of
    packed rows ``<set>/tokens``, ``<set>/segments`` and
    ``<set>/positions`` of ``OUT/packed.npz``, the case's ``head``), then
    on the multislice
    mesh ``("dcn", "dp", "tp")`` of ``collectives.make_multislice_mesh(2,
    4, tp=2, processes=True)`` one lr-1 DP×TP step (each ``matmul_impl``
    of ``ms_impls``) of ``ms_params`` on ``OUT/window.npz``'s ``tokens``,
    and on ``ProcessMesh({"dcn": 2, "dp": 1, "sp": 2})`` one lr-1 ring
    step (each engine of ``ring_impls``) of ``ring_params`` on its
    ``ring_tokens`` and ``ring_targets``.  Saved the losses and the
    gathered trees; ``rank<r>.json`` holds each three-axis mesh's coords
    and each axis's psum of the group rank."""
    import torch.distributed as dist

    from tpu_dra_torch import convert
    from tpu_dra_torch.workloads.collectives import make_multislice_mesh
    from tpu_dra_torch.workloads.mesh import ProcessMesh
    from tpu_dra_torch.workloads.ring_attention import make_ring_train_step
    from tpu_dra_torch.workloads.train import (ModelConfig,
                                               make_sharded_train_step,
                                               packed_loss_fn,
                                               param_shardings)
    _join()
    r = dist.get_rank()
    where = None if device == "cuda" else device
    spec = json.loads((out / "slices.json").read_text())
    res, info = {}, {}
    mesh = ProcessMesh({"dp": 2, "tp": 2}, device=where)
    dev = mesh.device
    with np.load(out / "packed.npz") as data:
        packed = {s: [torch.from_numpy(data[f"{s}/{k}"]).to(dev)
                      for k in ("tokens", "segments", "positions")]
                  for s in sorted({k.split("/")[0] for k in data.files})}
    for case in spec["packed"]:
        cfg = ModelConfig(**case["cfg"])
        params = convert.load_npz(out / case["params"], dev)
        local = mesh.shard_tree(params, param_shardings(cfg, mesh))
        for rows, batch in packed.items():
            res[f"packed/{case['name']}/{rows}"] = packed_loss_fn(
                cfg, local, *batch, head_impl=case["head"], mesh=mesh)
    mesh.close()
    with np.load(out / "window.npz") as data:
        win = {k: torch.from_numpy(data[k]).to(dev) for k in data.files}
    ms = make_multislice_mesh(2, 4, tp=2, device=where, processes=True)
    msp = ProcessMesh({"dcn": 2, "dp": 1, "sp": 2}, device=where)
    for name, m in (("ms", ms), ("msp", msp)):
        info[name] = {"coords": m.coords, "psums": {
            a: float(m.psum(torch.tensor(float(r), device=dev), [a]))
            for a in m.axis_names}}
    cfg = ModelConfig(**spec["ms_cfg"])
    params = convert.load_npz(out / spec["ms_params"], dev)
    for impl in spec["ms_impls"]:
        step, p_shard, _ = make_sharded_train_step(cfg, ms, lr=1.0,
                                                   matmul_impl=impl)
        new, loss = step(ms.shard_tree(params, p_shard), win["tokens"])
        res[f"ms-{impl}_loss"] = loss
        for k, v in flat_tree(ms.unshard_tree(new, p_shard)).items():
            res[f"ms-{impl}/{k}"] = v
    cfg = ModelConfig(**spec["ring_cfg"])
    params = convert.load_npz(out / spec["ring_params"], dev)
    for engine in spec["ring_impls"]:
        step, _ = make_ring_train_step(cfg, msp, lr=1.0, ring_impl=engine)
        new, loss = step(params, win["ring_tokens"], win["ring_targets"])
        res[f"msp-{engine}_loss"] = loss
        for k, v in flat_tree(new).items():
            res[f"msp-{engine}/{k}"] = v
    ms.close()
    msp.close()
    (out / f"rank{r}.json").write_text(json.dumps(info))
    _save(out, r, res)
    dist.destroy_process_group()


def _unflat(flat: dict) -> dict:
    """:func:`flat_tree`'s inverse."""
    out: dict = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _to(tree: dict, dev) -> dict:
    """Every tensor of ``tree`` on ``dev`` (an int8 leaf's ``row_max``
    kept as it is)."""
    return {k: _to(v, dev) if isinstance(v, dict)
            else v.to(dev) if torch.is_tensor(v) else v
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
    elif what == "moe":
        moe_main(out, json.loads(sys.argv[3]), sys.argv[4])
    elif what == "lora":
        lora_main(out, json.loads(sys.argv[3]), sys.argv[4])
    elif what == "decode":
        decode_main(out, json.loads(sys.argv[3]), sys.argv[4])
    elif what == "slices":
        slices_main(out, sys.argv[3])
    else:
        mesh_main(out, json.loads(sys.argv[3]))
