"""The port's counterparts of ``__graft_entry__``: ``entry``, the forward
step of the tiny flagship model with its example arguments, and
``dryrun_multichip``, every mesh strategy of the reference's dry run on
the virtual mesh (``workloads/mesh.py``).

    from tpu_dra_torch.entry import entry, dryrun_multichip
    fn, (params, tokens) = entry()          # on cuda:0
    logits = fn(params, tokens)             # [2, 64, 256] fp32
    dryrun_multichip(4)                     # last line: MULTICHIP_REPORT
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tpu_dra_torch.device import resolve_device
from tpu_dra_torch.workloads.train import ModelConfig, forward, init_params

# the reference's demo model (__graft_entry__.py:13)
CONFIG = dict(vocab=256, d_model=128, n_heads=4, n_layers=2, d_ff=512,
              max_seq=64)

# the dry run's tiny configs are the reference's (__graft_entry__.py:120,
# 336, 374, 404, 430) at d_model 256 where the reference has 64: four heads
# of 64, the smallest head dimension the port's flash and paged-attention
# kernels take (64 or 128), so the lanes that run them on the card do
DRYRUN_D_MODEL = 256
# the paged lane's page size: the reference's is 4; the paged-attention
# kernel takes multiples of 8
DRYRUN_PAGE_SIZE = 8


def entry(device=None):
    """``(fn, (params, tokens))``: ``fn(params, tokens)`` is
    ``train.forward`` of the demo model (vocab 256, d_model 128, 4 heads,
    2 layers, d_ff 512, max_seq 64), ``params`` its fp32 weights from the
    port's own init at seed 0 and ``tokens`` int32 zeros ``[2, 64]``, all
    on ``device``: the card unless the caller asks for the CPU
    (``RuntimeError`` without CUDA)."""
    dev = resolve_device(device)
    cfg = ModelConfig(**CONFIG)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    tokens = torch.zeros((2, cfg.max_seq), dtype=torch.int32, device=dev)

    def fn(params, tokens):
        return forward(cfg, params, tokens)

    return fn, (params, tokens)


# --------------------------------------------------------------------------
# The multi-chip dry run
# --------------------------------------------------------------------------


def _check(ok, msg: str) -> None:
    """The dry run's asserts (kept under ``python -O`` too)."""
    if not bool(ok):
        raise AssertionError(msg)


def _finite(label: str, loss) -> None:
    _check(torch.isfinite(torch.as_tensor(loss)).all(),
           f"non-finite {label} loss {loss}")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _count_params(params) -> int:
    from tpu_dra_torch.workloads.train import tree_leaves
    return sum(p.numel() for p in tree_leaves(params))


def _time_strategy(report: dict, name: str, dev, step_fn, *args,
                   tokens_per_step: int | None = None,
                   n_params: int | None = None, iters: int = 2,
                   group: bool = False) -> None:
    """Run ``step_fn`` ``iters`` more times (the lane's own check warmed
    it) and record the step time, and on the card TF/s and MFU
    (6·N·tokens a step) against 989 TF/s bf16 times the number of
    distinct cards the ranks use: one for the virtual mesh, whose ranks
    all run on the one card; the CPU records no MFU, as the reference's
    CPU dry run does.  ``group``: every process of the default process
    group times the step together, from a barrier, and the slowest
    process's time is recorded."""
    import torch.distributed as dist
    _sync(dev)
    if group:
        dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        step_fn(*args)
    _sync(dev)
    secs = (time.perf_counter() - t0) / iters
    cards = 1
    if group:
        from tpu_dra_torch.workloads.mesh import group_all_reduce
        secs = float(group_all_reduce(torch.tensor([secs], device=dev),
                                      op=dist.ReduceOp.MAX))
        if dev.type == "cuda":
            cards = min(dist.get_world_size(), torch.cuda.device_count())
    entry = {"step_ms": round(secs * 1e3, 3)}
    if n_params and tokens_per_step:
        flops = 6 * n_params * tokens_per_step
        entry["tflops"] = round(flops / secs / 1e12, 4)
        if dev.type == "cuda":
            from tpu_dra_torch.bench import H100_BF16_FLOPS
            entry["mfu_pct"] = round(
                100.0 * flops / secs / (H100_BF16_FLOPS * cards), 2)
    report["strategies"][name] = entry


def _seeded(dev, seed: int):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def _zeros(dev, rows: int, cols: int):
    return torch.zeros((rows, cols), dtype=torch.int32, device=dev)


def _page_table(prompt, steps: int) -> tuple:
    """The paged lane's ``(table [B, MP] int32, total pages)``: pages of
    :data:`DRYRUN_PAGE_SIZE` for each row's prompt and ``steps``, from a
    pool of 3 pages a row and 2 spare (the reference's lane)."""
    from tpu_dra_torch.workloads.paged_kv import PagePool
    pool = PagePool(total_pages=prompt.shape[0] * 3 + 2,
                    page_size=DRYRUN_PAGE_SIZE)
    need = pool.pages_for(prompt.shape[1] + steps)
    rows = [pool.table_row(pool.alloc(need), need)
            for _ in range(prompt.shape[0])]
    return (torch.as_tensor(np.stack(rows), dtype=torch.int32,
                            device=prompt.device), pool.total_pages)


def _packed_batch(vocab: int, rows: int, dev) -> tuple:
    """The packed lane's ``[rows, 16]`` tokens, segment ids and positions:
    the reference's four documents packed (``data.pack_documents``) and
    tiled to ``rows``."""
    from tpu_dra_torch.workloads.data import pack_documents
    docs = [np.arange(1, 1 + k) % vocab for k in (9, 7, 12, 5)]
    packed = pack_documents(docs, seq=16)
    reps = -(-rows // packed[0].shape[0])
    return tuple(torch.as_tensor(np.tile(a, (reps, 1))[:rows], device=dev)
                 for a in packed)


def _round_trip(mesh, params, specs):
    """``params`` cut into per-rank shards by ``specs`` (a spec tree like
    ``train.param_shardings`` or ``quant.serving_param_shardings``) and
    put back (``Mesh.shard``/``unshard``): the tree a sharded run
    reads."""
    if isinstance(params, dict):
        return {k: _round_trip(mesh, params[k], specs[k]) for k in params}
    return mesh.unshard(mesh.shard(params, specs), specs)


def dryrun_multichip(n_devices: int, device=None, processes: bool = False,
                     backend: str = "gloo", return_launches: bool = False):
    """Every mesh strategy of the reference's dry run
    (``__graft_entry__.dryrun_multichip``, 70-433) on a virtual mesh of
    ``n_devices`` ranks on one device: the card unless ``device="cpu"``
    (``RuntimeError`` without CUDA; never a fallback to the CPU).
    ``processes=True`` runs it one process a rank instead
    (:func:`_dryrun_processes`), over ``backend``; with
    ``return_launches`` it returns ``(report, launches)``, the ranks'
    kernel launches summed by kernel (``ValueError`` without
    ``processes``).

    The reference's factoring: tp the largest divisor of n up to 8, dp
    the rest; the ZeRO-1 lane dp n/2 × tp 2; sp = pp = ep = tp;
    multislice 2 slices where n ≥ 4 and even.  The lanes, in its order:
    dp_tp, the fused collective (flash attention on the card, dense on
    the CPU, as the reference chooses by platform) and the chunked head;
    greedy decode; int4 serving through ``serving_param_shardings``;
    paged decode; ZeRO-1; LoRA; the packed loss; beam; speculative; DP×SP
    ring with the fp32 and the flash engine (``hop_impl="pallas"`` on the
    card); GPipe; multislice DP×TP and ring SP; DP×EP MoE.  Each lane
    asserts what the reference asserts, and where the virtual mesh makes
    the sharded run the one-device computation it also holds the two
    equal: the decodes of trees cut by their specs and put back give the
    one-device tokens, and ZeRO-1 gives the replicated run's losses and
    parameters bit for bit.

    Strategies are timed as the reference's ``_time_strategy``; MFU is
    taken against one H100's 989 TF/s whatever n is (every rank runs on
    the one card), and left out on the CPU.  The tiny configs are the
    reference's at d_model :data:`DRYRUN_D_MODEL`, the paged lane's pages
    :data:`DRYRUN_PAGE_SIZE` tokens.  The last line printed is
    ``MULTICHIP_REPORT {json}``; the report is also returned."""
    if return_launches and not processes:
        raise ValueError("return_launches counts the ranks' launches of "
                         "processes=True")
    if processes:
        report, launches = _dryrun_processes(n_devices, device, backend)
        return (report, launches) if return_launches else report
    from tpu_dra_torch.workloads.collectives import make_multislice_mesh
    from tpu_dra_torch.workloads.decode import (beam_decode, greedy_decode,
                                                speculative_decode)
    from tpu_dra_torch.workloads.lora import init_lora, make_lora_train_step
    from tpu_dra_torch.workloads.mesh import Mesh
    from tpu_dra_torch.workloads.moe import (MoEConfig, init_moe_params,
                                             make_moe_train_step)
    from tpu_dra_torch.workloads.paged_kv import paged_greedy_decode
    from tpu_dra_torch.workloads.pipeline import make_pipeline_train_step
    from tpu_dra_torch.workloads.quant import (quantize_params_int4,
                                               serving_param_shardings)
    from tpu_dra_torch.workloads.ring_attention import make_ring_train_step
    from tpu_dra_torch.workloads.spec_draft import truncate_draft
    from tpu_dra_torch.workloads.train import (make_optax_train_step,
                                               make_sharded_train_step,
                                               packed_loss_fn, tree_leaves)

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    D = DRYRUN_D_MODEL

    def seeded(seed: int):
        return _seeded(dev, seed)

    def zeros(rows: int, cols: int):
        return _zeros(dev, rows, cols)

    n = n_devices
    tp = next(c for c in range(min(n, 8), 0, -1) if n % c == 0)
    dp = n // tp
    mesh = Mesh({"dp": dp, "tp": tp}, device=dev)
    cfg = ModelConfig(vocab=128, d_model=D, n_heads=4, n_layers=2,
                      d_ff=64 * tp, max_seq=32)
    params = init_params(cfg, seeded(0))
    step, p_shard, b_shard = make_sharded_train_step(cfg, mesh, lr=1e-2)
    tokens = zeros(max(2 * dp, dp), 32)
    params, loss = step(params, tokens)
    _finite("dp_tp", loss)

    report = {"n_devices": n, "platform": "gpu" if on_card else dev.type,
              "mesh": {"dp": dp, "tp": tp}, "strategies": {}}
    n_params = _count_params(params)
    toks_step = tokens.shape[0] * (tokens.shape[1] - 1)
    _time_strategy(report, "dp_tp", dev, step, params, tokens,
                   tokens_per_step=toks_step, n_params=n_params)

    attn_fc = "flash" if on_card else "dense"
    step_fc, _, _ = make_sharded_train_step(
        cfg, mesh, lr=1e-2, attn_impl=attn_fc,
        matmul_impl="fused_collective")
    _, loss_fc = step_fc(params, tokens)
    _finite("fused-collective", loss_fc)
    _time_strategy(report, "dp_tp_fused_collective", dev, step_fc, params,
                   tokens, tokens_per_step=toks_step, n_params=n_params)

    step_c, _, _ = make_sharded_train_step(cfg, mesh, lr=1e-2,
                                           head_impl="chunked")
    _, loss_c = step_c(params, tokens)
    _finite("chunked-head", loss_c)
    _time_strategy(report, "dp_tp_chunked", dev, step_c, params, tokens,
                   tokens_per_step=toks_step, n_params=n_params)

    # serving under the dp x tp shardings: the tree cut into its tp
    # shards and put back decodes as the one-device tree does
    prompt = zeros(max(2 * dp, dp), 8)
    sharded = _round_trip(mesh, params, p_shard)
    toks = greedy_decode(cfg, sharded, prompt, steps=2, max_len=32)
    _check(toks.shape[-1] == 2, f"decode shape {tuple(toks.shape)}")
    _check(torch.equal(toks, greedy_decode(cfg, params, prompt, steps=2,
                                           max_len=32)),
           "the sharded tree's greedy tokens differ from the one-device "
           "tree's")

    cfg_q = dataclasses.replace(cfg, n_kv_heads=2)
    params_q4 = quantize_params_int4(init_params(cfg_q, seeded(7)))
    q4_sharded = _round_trip(
        mesh, params_q4, serving_param_shardings(cfg_q, mesh, params_q4))
    toks4 = greedy_decode(cfg_q, q4_sharded, prompt, steps=2, max_len=32)
    _check(toks4.shape[-1] == 2, f"int4 decode shape {tuple(toks4.shape)}")
    _check(torch.equal(toks4, greedy_decode(cfg_q, params_q4, prompt,
                                            steps=2, max_len=32)),
           "the sharded int4 tree's tokens differ from the one-device "
           "tree's")

    ptable, total_pages = _page_table(prompt, 2)
    toks_paged = paged_greedy_decode(cfg, sharded, prompt, ptable, steps=2,
                                     total_pages=total_pages,
                                     page_size=DRYRUN_PAGE_SIZE)
    _check(toks_paged.shape[-1] == 2,
           f"paged decode shape {tuple(toks_paged.shape)}")

    # ZeRO-1 on a dp-major factoring of the same ranks, bit-equal to the
    # replicated moments
    zdp = n // (2 if n % 2 == 0 else 1)
    mesh_z = Mesh({"dp": zdp, "tp": n // zdp}, device=dev)
    ztokens = zeros(max(2 * zdp, zdp), 8)
    zrun = {}
    for zero1 in (False, True):
        zstep, zinit, _, _ = make_optax_train_step(cfg, mesh_z, zero1=zero1)
        zparams = init_params(cfg, seeded(0))
        zopt = zinit(zparams)
        if zero1 and zdp > 1:
            _check(zopt.layout.moment_specs["blocks"]["wqkv"][0] == "dp",
                   f"wqkv moment spec "
                   f"{zopt.layout.moment_specs['blocks']['wqkv']}")
        zparams, zopt, loss_z = zstep(zparams, zopt, ztokens)
        _finite("zero1" if zero1 else "replicated-moment", loss_z)
        zrun[zero1] = (loss_z, zparams)
    _check(torch.equal(zrun[False][0], zrun[True][0])
           and all(torch.equal(a, b) for a, b in zip(
               tree_leaves(zrun[False][1]), tree_leaves(zrun[True][1]))),
           "ZeRO-1 is not bit-equal to the replicated moments")

    lstep, init_opt, lcfg, lsh = make_lora_train_step(cfg, mesh)
    lora = init_lora(params, lcfg, seeded(3))
    _check(all(s == () for s in tree_leaves(lsh["lora"](lora))),
           "LoRA adapters must replicate")
    lora, _, loss_l = lstep(params, lora, init_opt(lora), tokens)
    _finite("lora", loss_l)

    loss_p = packed_loss_fn(cfg, params,
                            *_packed_batch(cfg.vocab, max(2 * dp, dp), dev))
    _finite("packed", loss_p)

    hist, _ = beam_decode(cfg, params, prompt, steps=2, beams=2, max_len=32)
    _check(hist.shape[-1] == 2, f"beam shape {tuple(hist.shape)}")

    dcfg_s, dparams_s = truncate_draft(cfg, params, 1)
    toks_spec = speculative_decode(cfg, params, dcfg_s, dparams_s, prompt,
                                   steps=2, k=2, max_len=32)
    _check(toks_spec.shape[-1] == 2, f"speculative shape "
           f"{tuple(toks_spec.shape)}")
    _check(torch.equal(toks_spec, toks), "speculative tokens differ from "
           "the sharded greedy decode's")

    sp = tp
    mesh_sp = Mesh({"dp": dp, "sp": sp}, device=dev)
    seq = 8 * sp
    cfg_sp = ModelConfig(vocab=128, d_model=D, n_heads=4, n_layers=2,
                         d_ff=128, max_seq=seq)
    params_sp = init_params(cfg_sp, seeded(1))
    ring_step, _ = make_ring_train_step(cfg_sp, mesh_sp)
    tokens_sp = zeros(max(2 * dp, dp), seq)
    params_sp, loss_sp = ring_step(params_sp, tokens_sp, tokens_sp)
    _finite("sp", loss_sp)
    n_params_sp = _count_params(params_sp)
    toks_sp = tokens_sp.shape[0] * tokens_sp.shape[1]
    _time_strategy(report, "dp_sp_ring", dev, ring_step, params_sp,
                   tokens_sp, tokens_sp, tokens_per_step=toks_sp,
                   n_params=n_params_sp)

    hop = "pallas" if on_card else "xla"
    ring_step_f, _ = make_ring_train_step(cfg_sp, mesh_sp, ring_impl="flash",
                                          hop_impl=hop)
    params_f, loss_f = ring_step_f(init_params(cfg_sp, seeded(4)),
                                   tokens_sp, tokens_sp)
    _finite("flash-sp", loss_f)
    _time_strategy(report, "dp_sp_ring_flash", dev, ring_step_f, params_f,
                   tokens_sp, tokens_sp, tokens_per_step=toks_sp,
                   n_params=n_params_sp)

    pp = tp
    mesh_pp = Mesh({"dp": dp, "pp": pp}, device=dev)
    cfg_pp = ModelConfig(vocab=128, d_model=D, n_heads=4, n_layers=2 * pp,
                         d_ff=128, max_seq=32)
    pipe_step, _, _ = make_pipeline_train_step(cfg_pp, mesh_pp, n_micro=2)
    params_pp = init_params(cfg_pp, seeded(2))
    tokens_pp = zeros(2 * dp, 32)
    params_pp, loss_pp = pipe_step(params_pp, tokens_pp)
    _finite("pp", loss_pp)
    _time_strategy(report, "dp_pp_gpipe", dev, pipe_step, params_pp,
                   tokens_pp,
                   tokens_per_step=tokens_pp.shape[0]
                   * (tokens_pp.shape[1] - 1),
                   n_params=_count_params(params_pp))

    if n >= 4 and n % 2 == 0:
        per_slice = n // 2
        tp_ms = max(d for d in range(1, per_slice + 1)
                    if per_slice % d == 0 and d <= 4)
        mesh_ms = make_multislice_mesh(2, n, tp=tp_ms, device=dev)
        cfg_ms = ModelConfig(vocab=128, d_model=D, n_heads=4, n_layers=2,
                             d_ff=64 * tp_ms, max_seq=32)
        dp_total = 2 * (per_slice // tp_ms)
        step_ms, _, _ = make_sharded_train_step(cfg_ms, mesh_ms, lr=1e-2)
        _, loss_ms = step_ms(init_params(cfg_ms, seeded(5)),
                             zeros(2 * dp_total, 32))
        _finite("multislice", loss_ms)

        sp_ms = tp_ms
        mesh_msp = Mesh({"dcn": 2, "dp": per_slice // sp_ms, "sp": sp_ms},
                        device=dev)
        seq_ms = 8 * sp_ms
        cfg_msp = ModelConfig(vocab=128, d_model=D, n_heads=4, n_layers=2,
                              d_ff=128, max_seq=seq_ms)
        ring_ms, _ = make_ring_train_step(cfg_msp, mesh_msp)
        toks_msp = zeros(2 * 2 * (per_slice // sp_ms), seq_ms)
        _, loss_msp = ring_ms(init_params(cfg_msp, seeded(6)), toks_msp,
                              toks_msp)
        _finite("multislice ring-sp", loss_msp)

    ep = tp
    mesh_ep = Mesh({"dp": dp, "ep": ep}, device=dev)
    cfg_ep = MoEConfig(vocab=128, d_model=D, n_heads=4, n_layers=2,
                       d_ff=128, max_seq=32, n_experts=max(2 * ep, 4))
    moe_step, _, _ = make_moe_train_step(cfg_ep, mesh_ep)
    params_ep = init_moe_params(cfg_ep, seeded(3))
    tokens_ep = zeros(2 * dp, 32)
    params_ep, loss_ep = moe_step(params_ep, tokens_ep)
    _finite("ep", loss_ep)
    _time_strategy(report, "dp_ep_moe", dev, moe_step, params_ep, tokens_ep,
                   tokens_per_step=tokens_ep.shape[0]
                   * (tokens_ep.shape[1] - 1),
                   n_params=_count_params(params_ep))

    print("MULTICHIP_REPORT " + json.dumps(report, sort_keys=True),
          flush=True)
    return report



# --------------------------------------------------------------------------
# The dry run one process a rank
# --------------------------------------------------------------------------

# seconds the group of ranks may take
PROCESS_WAIT = 900


def _kernels() -> dict:
    """The kernel wrappers the dry run's lanes launch on the card, by
    their names in ``chip_smoke.py``'s kernels line; each counts its
    launches in ``.launches``."""
    from tpu_dra_torch.workloads import collective_matmul as cm
    from tpu_dra_torch.workloads import flash, paged_kv
    return {"paged_attention": paged_kv.paged_attention,
            "flash_fwd": flash.flash_attn_fwd,
            "flash_bwd_dq": flash.flash_bwd_dq,
            "flash_bwd_dkdv": flash.flash_bwd_dkdv,
            "all_gather_matmul": cm.all_gather_matmul,
            "matmul_reduce_scatter": cm.matmul_reduce_scatter,
            "ring_shift": cm.ring_shift}


def _dryrun_processes(n: int, device, backend: str) -> tuple:
    """``dryrun_multichip(n, processes=True)``: starts the ``n`` ranks
    (``launcher.run_local_group``; each joins the group through
    ``RendezvousInfo.initialize(backend)`` and runs :func:`dryrun_rank`),
    prints each rank's ``DRYRUN_LAUNCHES`` line, then the
    ``MULTICHIP_REPORT`` line rank 0 made, and returns ``(report, the
    ranks' launches summed by kernel)``.  On the card unless
    ``device="cpu"`` (``RuntimeError`` without CUDA); a rank that fails
    fails the call, with every rank's output tail."""
    from tpu_dra_torch.workloads.launcher import run_local_group
    dev = resolve_device(device)
    if dev.type == "cuda":
        from tpu_dra_torch.kernels.build import build_all
        build_all()                  # once, before the ranks load them
    root = str(Path(__file__).resolve().parent.parent)
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                           if p)
    outs = run_local_group(
        [sys.executable, "-m", "tpu_dra_torch.entry", "dryrun-rank", str(n),
         dev.type, backend], n, timeout=PROCESS_WAIT, cwd=root,
        env=dict(os.environ, PYTHONPATH=path))
    total: dict = {}
    for out in outs:
        for ln in out.splitlines():
            if ln.startswith("DRYRUN_LAUNCHES "):
                print(ln, flush=True)
                counts = json.loads(ln[len("DRYRUN_LAUNCHES "):])
                counts.pop("rank")
                for name, k in counts.items():
                    total[name] = total.get(name, 0) + k
    line = [ln for ln in outs[0].splitlines()
            if ln.startswith("MULTICHIP_REPORT ")][-1]
    print(line, flush=True)
    return json.loads(line[len("MULTICHIP_REPORT "):]), total


def dryrun_rank(n: int, device: str, backend: str) -> dict:
    """One rank of the dry run one process a rank: every lane of the
    reference's dry run, in its order, on ``ProcessMesh``es of its
    factorings over the default group of ``n`` processes (joined here,
    and left at the end).  Each process holds its shards: the DP×TP
    steps, the fused collective (flash attention and the ring kernels
    across processes on the card), the chunked head; tensor-parallel
    greedy, int4 and paged decoding from its serving shards; ZeRO-1 on
    dp n/2 × tp 2, bit-equal to the replicated moments; LoRA; the packed
    loss; beam and speculative decoding (the latter equal to the greedy
    tokens); the DP×SP ring with both engines; GPipe; the multislice
    DP×TP and ring-SP steps on ``("dcn", "dp", "tp")`` and ``("dcn", "dp",
    "sp")``; DP×EP MoE.  The heads are the virtual run's four of 64 where
    tp ≤ 4, else tp of them (they split over tp).  Each timed lane is the
    slowest process's, MFU against the distinct cards the ranks use.
    Every rank prints ``DRYRUN_LAUNCHES {json}``, its launches of each
    kernel on the path (:func:`_kernels`), and rank 0 then
    ``MULTICHIP_REPORT {json}``; the report is returned.  Every mesh is
    closed at the end, on every rank."""
    import torch.distributed as dist

    from tpu_dra_torch.workloads.collectives import make_multislice_mesh
    from tpu_dra_torch.workloads.decode import (beam_decode, greedy_decode,
                                                speculative_decode)
    from tpu_dra_torch.workloads.launcher import resolve
    from tpu_dra_torch.workloads.lora import init_lora, make_lora_train_step
    from tpu_dra_torch.workloads.mesh import ProcessMesh, process_device
    from tpu_dra_torch.workloads.moe import (MoEConfig, init_moe_params,
                                             make_moe_train_step)
    from tpu_dra_torch.workloads.paged_kv import paged_greedy_decode
    from tpu_dra_torch.workloads.pipeline import make_pipeline_train_step
    from tpu_dra_torch.workloads.process_decode import local_tree
    from tpu_dra_torch.workloads.quant import quantize_params_int4
    from tpu_dra_torch.workloads.ring_attention import make_ring_train_step
    from tpu_dra_torch.workloads.spec_draft import truncate_draft
    from tpu_dra_torch.workloads.train import (make_optax_train_step,
                                               make_sharded_train_step,
                                               packed_loss_fn, tree_leaves)

    torch.set_num_threads(1)
    resolve().initialize(backend)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
        torch.backends.cuda.matmul.allow_tf32 = False
    where = None if on_card else "cpu"
    dev = process_device(where, dist.get_rank())
    meshes = []

    def pmesh(axes: dict):
        meshes.append(ProcessMesh(axes, device=where))
        return meshes[-1]

    def seeded(seed: int):
        return _seeded(dev, seed)

    def zeros(rows: int, cols: int):
        return _zeros(dev, rows, cols)

    def timed(name, step_fn, *args, **kw):
        _time_strategy(report, name, dev, step_fn, *args, group=True, **kw)

    tp = next(c for c in range(min(n, 8), 0, -1) if n % c == 0)
    dp = n // tp
    D = DRYRUN_D_MODEL
    heads = max(4, tp)
    mesh = pmesh({"dp": dp, "tp": tp})
    cfg = ModelConfig(vocab=128, d_model=D * heads // 4, n_heads=heads,
                      n_layers=2, d_ff=64 * tp, max_seq=32)
    params = init_params(cfg, seeded(0))
    n_params = _count_params(params)
    step, p_shard, _ = make_sharded_train_step(cfg, mesh, lr=1e-2)
    local = mesh.shard_tree(params, p_shard)
    tokens = zeros(max(2 * dp, dp), 32)
    local, loss = step(local, tokens)
    _finite("dp_tp", loss)

    report = {"n_devices": n, "platform": "gpu" if on_card else dev.type,
              "mesh": {"dp": dp, "tp": tp}, "strategies": {}}
    toks_step = tokens.shape[0] * (tokens.shape[1] - 1)
    timed("dp_tp", step, local, tokens, tokens_per_step=toks_step,
          n_params=n_params)

    step_fc, _, _ = make_sharded_train_step(
        cfg, mesh, lr=1e-2, attn_impl="flash" if on_card else "dense",
        matmul_impl="fused_collective")
    _finite("fused-collective", step_fc(local, tokens)[1])
    timed("dp_tp_fused_collective", step_fc, local, tokens,
          tokens_per_step=toks_step, n_params=n_params)

    step_c, _, _ = make_sharded_train_step(cfg, mesh, lr=1e-2,
                                           head_impl="chunked")
    _finite("chunked-head", step_c(local, tokens)[1])
    timed("dp_tp_chunked", step_c, local, tokens, tokens_per_step=toks_step,
          n_params=n_params)

    # serving from each process's tp shards: tensor-parallel decoding
    prompt = zeros(max(2 * dp, dp), 8)
    toks = greedy_decode(cfg, local, prompt, steps=2, max_len=32, mesh=mesh)
    _check(toks.shape == (prompt.shape[0], 2),
           f"decode shape {tuple(toks.shape)}")

    cfg_q = dataclasses.replace(cfg, n_kv_heads=2)
    params_q4 = quantize_params_int4(init_params(cfg_q, seeded(7)))
    toks4 = greedy_decode(cfg_q, local_tree(cfg_q, mesh, params_q4), prompt,
                          steps=2, max_len=32, mesh=mesh)
    _check(toks4.shape == (prompt.shape[0], 2),
           f"int4 decode shape {tuple(toks4.shape)}")

    ptable, total_pages = _page_table(prompt, 2)
    toks_paged = paged_greedy_decode(cfg, local, prompt, ptable, steps=2,
                                     total_pages=total_pages,
                                     page_size=DRYRUN_PAGE_SIZE, mesh=mesh)
    _check(toks_paged.shape == (prompt.shape[0], 2),
           f"paged decode shape {tuple(toks_paged.shape)}")

    # ZeRO-1 on a dp-major factoring of the same ranks, bit-equal to the
    # replicated moments
    zdp = n // (2 if n % 2 == 0 else 1)
    mesh_z = pmesh({"dp": zdp, "tp": n // zdp})
    ztokens = zeros(max(2 * zdp, zdp), 8)
    zrun = {}
    for zero1 in (False, True):
        zstep, zinit, zp_shard, _ = make_optax_train_step(cfg, mesh_z,
                                                          zero1=zero1)
        zparams = mesh_z.shard_tree(init_params(cfg, seeded(0)), zp_shard)
        zopt = zinit(zparams)
        spec = zopt.layout.moment_specs["blocks"]["wqkv"]
        if zero1 and zdp > 1:
            # the reference's check: "dp" somewhere in the moment's spec
            _check("dp" in spec, f"wqkv moment spec {spec}")
        zparams, zopt, loss_z = zstep(zparams, zopt, ztokens)
        _finite("zero1" if zero1 else "replicated-moment", loss_z)
        zrun[zero1] = (loss_z, zparams)
    _check(torch.equal(zrun[False][0], zrun[True][0])
           and all(torch.equal(a, b) for a, b in zip(
               tree_leaves(zrun[False][1]), tree_leaves(zrun[True][1]))),
           "ZeRO-1 is not bit-equal to the replicated moments")

    lstep, init_opt, lcfg, lsh = make_lora_train_step(cfg, mesh)
    lora = init_lora(mesh.unshard_tree(local, p_shard), lcfg, seeded(3))
    _check(all(s == () for s in tree_leaves(lsh["lora"](lora))),
           "LoRA adapters must replicate")
    _finite("lora", lstep(local, lora, init_opt(lora), tokens)[2])

    _finite("packed", packed_loss_fn(
        cfg, local, *_packed_batch(cfg.vocab, max(2 * dp, dp), dev),
        mesh=mesh))

    hist, _ = beam_decode(cfg, local, prompt, steps=2, beams=2, max_len=32,
                          mesh=mesh)
    _check(hist.shape == (prompt.shape[0], 2, 2),
           f"beam shape {tuple(hist.shape)}")

    dcfg_s, dparams_s = truncate_draft(cfg, local, 1)
    toks_spec = speculative_decode(cfg, local, dcfg_s, dparams_s, prompt,
                                   steps=2, k=2, max_len=32, mesh=mesh)
    _check(toks_spec.shape == toks.shape,
           f"speculative shape {tuple(toks_spec.shape)}")
    _check(torch.equal(toks_spec, toks), "speculative tokens differ from "
           "the tensor-parallel greedy decode's")

    sp = tp
    mesh_sp = pmesh({"dp": dp, "sp": sp})
    seq = 8 * sp
    cfg_sp = ModelConfig(vocab=128, d_model=D, n_heads=4, n_layers=2,
                         d_ff=128, max_seq=seq)
    ring_step, _ = make_ring_train_step(cfg_sp, mesh_sp)
    tokens_sp = zeros(max(2 * dp, dp), seq)
    params_sp, loss_sp = ring_step(init_params(cfg_sp, seeded(1)), tokens_sp,
                                   tokens_sp)
    _finite("sp", loss_sp)
    n_params_sp = _count_params(params_sp)
    toks_sp = tokens_sp.shape[0] * tokens_sp.shape[1]
    timed("dp_sp_ring", ring_step, params_sp, tokens_sp, tokens_sp,
          tokens_per_step=toks_sp, n_params=n_params_sp)

    ring_step_f, _ = make_ring_train_step(
        cfg_sp, mesh_sp, ring_impl="flash",
        hop_impl="pallas" if on_card else "xla")
    params_f, loss_f = ring_step_f(init_params(cfg_sp, seeded(4)),
                                   tokens_sp, tokens_sp)
    _finite("flash-sp", loss_f)
    timed("dp_sp_ring_flash", ring_step_f, params_f, tokens_sp, tokens_sp,
          tokens_per_step=toks_sp, n_params=n_params_sp)

    pp = tp
    mesh_pp = pmesh({"dp": dp, "pp": pp})
    cfg_pp = ModelConfig(vocab=128, d_model=D, n_heads=4, n_layers=2 * pp,
                         d_ff=128, max_seq=32)
    pipe_step, pp_shard, _ = make_pipeline_train_step(cfg_pp, mesh_pp,
                                                      n_micro=2)
    params_pp = init_params(cfg_pp, seeded(2))
    n_params_pp = _count_params(params_pp)
    tokens_pp = zeros(2 * dp, 32)
    local_pp, loss_pp = pipe_step(mesh_pp.shard_tree(params_pp, pp_shard),
                                  tokens_pp)
    _finite("pp", loss_pp)
    timed("dp_pp_gpipe", pipe_step, local_pp, tokens_pp,
          tokens_per_step=tokens_pp.shape[0] * (tokens_pp.shape[1] - 1),
          n_params=n_params_pp)

    if n >= 4 and n % 2 == 0:
        per_slice = n // 2
        tp_ms = max(d for d in range(1, per_slice + 1)
                    if per_slice % d == 0 and d <= 4)
        mesh_ms = make_multislice_mesh(2, n, tp=tp_ms, device=where,
                                       processes=True)
        meshes.append(mesh_ms)
        cfg_ms = ModelConfig(vocab=128, d_model=D, n_heads=4, n_layers=2,
                             d_ff=64 * tp_ms, max_seq=32)
        dp_total = 2 * (per_slice // tp_ms)
        step_ms, pms_shard, _ = make_sharded_train_step(cfg_ms, mesh_ms,
                                                        lr=1e-2)
        _, loss_ms = step_ms(mesh_ms.shard_tree(
            init_params(cfg_ms, seeded(5)), pms_shard),
            zeros(2 * dp_total, 32))
        _finite("multislice", loss_ms)

        sp_ms = tp_ms
        mesh_msp = pmesh({"dcn": 2, "dp": per_slice // sp_ms, "sp": sp_ms})
        seq_ms = 8 * sp_ms
        cfg_msp = ModelConfig(vocab=128, d_model=D, n_heads=4, n_layers=2,
                              d_ff=128, max_seq=seq_ms)
        ring_ms, _ = make_ring_train_step(cfg_msp, mesh_msp)
        toks_msp = zeros(2 * 2 * (per_slice // sp_ms), seq_ms)
        _, loss_msp = ring_ms(init_params(cfg_msp, seeded(6)), toks_msp,
                              toks_msp)
        _finite("multislice ring-sp", loss_msp)

    ep = tp
    mesh_ep = pmesh({"dp": dp, "ep": ep})
    cfg_ep = MoEConfig(vocab=128, d_model=D, n_heads=4, n_layers=2,
                       d_ff=128, max_seq=32, n_experts=max(2 * ep, 4))
    moe_step, ep_shard, _ = make_moe_train_step(cfg_ep, mesh_ep)
    params_ep = init_moe_params(cfg_ep, seeded(3))
    n_params_ep = _count_params(params_ep)
    tokens_ep = zeros(2 * dp, 32)
    local_ep, loss_ep = moe_step(mesh_ep.shard_tree(params_ep, ep_shard),
                                 tokens_ep)
    _finite("ep", loss_ep)
    timed("dp_ep_moe", moe_step, local_ep, tokens_ep,
          tokens_per_step=tokens_ep.shape[0] * (tokens_ep.shape[1] - 1),
          n_params=n_params_ep)

    for m in meshes:
        m.close()
    print("DRYRUN_LAUNCHES " + json.dumps(
        {"rank": dist.get_rank(),
         **{name: fn.launches for name, fn in _kernels().items()}}),
        flush=True)
    if dist.get_rank() == 0:
        print("MULTICHIP_REPORT " + json.dumps(report, sort_keys=True),
              flush=True)
    dist.destroy_process_group()
    return report


if __name__ == "__main__":
    if sys.argv[1:2] != ["dryrun-rank"] or len(sys.argv) != 5:
        sys.exit("usage: python -m tpu_dra_torch.entry dryrun-rank N "
                 "DEVICE BACKEND (one rank of dryrun_multichip(N, "
                 "processes=True), started by it)")
    dryrun_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
