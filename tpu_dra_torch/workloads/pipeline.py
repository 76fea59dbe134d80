"""Pipeline-parallel training (GPipe microbatching over a "pp" axis),
ported from ``tpu_dra/workloads/pipeline.py`` onto the virtual mesh
(``mesh.py``).

- The stacked blocks ``[L, ...]`` are cut over "pp" on the layer axis
  (:func:`pipeline_param_specs`), so stage s holds layers s·L/pp ..
  (s+1)·L/pp − 1 and runs them in turn, each rematerialized in the
  backward (``train.remat``, the reference's ``jax.checkpoint``).
- The schedule is a loop of ``n_micro + pp − 1`` ticks: at tick t stage 0
  takes microbatch t, every other stage what its predecessor handed on
  the tick before (``mesh.ppermute`` over the stacked stage axis), and
  the last stage finishes microbatch t − pp + 1.  Each stage's work at a
  tick is its own call of its layers, as a stage on its own device runs
  it; the dp groups' rows of a microbatch ride along in that call.
- The bubble is real work: (n_micro + pp − 1)·pp stage passes against
  n_micro·pp, a fraction (pp − 1)/(n_micro + pp − 1) of them on zeros or
  on microbatches already handed on.  Their outputs never reach the
  output buffer, so they add nothing to the loss or to a gradient.
- The head and the NLL run on the last stage's buffer only (the
  reference computes the head on every stage and masks all but the
  last); the loss value is the reference's, the mean over every token.
- The backward is autograd through the ticks: the transpose of the
  forward ``torch.roll`` is the reverse roll, as the reference's
  ``ppermute`` transposes to the reverse ``ppermute``.

On a ``mesh.ProcessMesh`` (one process a rank) each process is stage
``coords["pp"]`` of dp group ``coords["dp"]`` and runs the reference's
per-device body (:func:`_group_pipeline_step`): its ``[L/pp, ...]`` slice
of the blocks, its dp group's rows cut into microbatches, the same tick
loop with the activation hopping one stage on through
``collective_matmul.ProcessRingShift`` (the plain send and receive, the
reference's ``ppermute``), and the head on the last stage only.
"""

from __future__ import annotations

from typing import Any

import torch

from tpu_dra_torch.workloads.mesh import ProcessMesh, ppermute
from tpu_dra_torch.workloads.train import (
    ModelConfig,
    _block,
    embed_tokens,
    head_nll,
    layer_params,
    remat,
    tree_leaves,
    tree_like,
    tree_unflatten,
    value_and_grad,
)

_BLOCK_LEAVES = ("wqkv", "wo", "w1", "w2", "ln1", "ln2")


def pipeline_param_specs(cfg: ModelConfig) -> dict[str, Any]:
    """One ``Mesh.shard`` spec a leaf: the stacked blocks split over "pp"
    on the layer axis, everything else replicated on every stage."""
    out: dict[str, Any] = {
        "embed": (),
        "blocks": {k: ("pp",) for k in _BLOCK_LEAVES},
        "ln_f": (),
    }
    if not cfg.tied_embeddings:
        out["unembed"] = ()
    if cfg.pos_emb == "learned":
        out["pos"] = ()
    return out


def _local_stack(cfg: ModelConfig, blocks, x):
    """This stage's resident layers (its ``[L/pp, ...]`` slice of the
    stacked blocks) over ``x``, each rematerialized in the backward."""
    for i in range(next(iter(blocks.values())).shape[0]):
        x = remat(_block, cfg, x, layer_params(blocks, i))
    return x


def _stage_blocks(mesh, blocks) -> list:
    """Each stage's slice of the stacked blocks: the leaves cut by
    ``("pp",)`` into ``[pp, L/pp, ...]`` (views of the whole leaves, so
    the gradients land in them)."""
    local = {k: mesh.local(mesh.shard(v, ("pp",)), ("pp",))
             for k, v in blocks.items()}
    return [{k: v[s] for k, v in local.items()}
            for s in range(mesh.axis_size("pp"))]


def _pipeline_blocks(cfg: ModelConfig, mesh, blocks, x_micro):
    """Circulate microbatches through the stage ring.  ``x_micro``:
    ``[n_micro, R, S, D]`` (R rows a microbatch, the dp groups' side by
    side); returns the last stage's ``[n_micro, R, S, D]``."""
    pp = mesh.axis_size("pp")
    n_micro = x_micro.shape[0]
    stages = _stage_blocks(mesh, blocks)
    recv = x_micro.new_zeros((pp, *x_micro.shape[1:]))
    done = []
    for t in range(n_micro + pp - 1):
        feed = x_micro[min(t, n_micro - 1)]
        inp = torch.cat([feed[None], recv[1:]])
        out = torch.stack([_local_stack(cfg, stages[s], inp[s])
                           for s in range(pp)])
        if t >= pp - 1:                    # microbatch t - pp + 1 is done
            done.append(out[pp - 1])
        recv = ppermute(out, 0, 1)
    return torch.stack(done)


def _pipeline_loss(cfg: ModelConfig, mesh, n_micro: int, head_impl: str,
                   params, tokens):
    """Mean next-token NLL of a ``[B, S]`` batch through the pipeline:
    rows over "dp" (each dp group's B/dp rows cut into ``n_micro``
    microbatches), the head on the last stage's buffer."""
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    x = embed_tokens(cfg, params, inp)
    B, S, D = x.shape
    dp = mesh.axis_size("dp")
    mb = B // (dp * n_micro)

    def micro(t):                      # [B, ...] -> [n_micro, dp·mB, ...]
        return t.reshape(dp, n_micro, mb, *t.shape[1:]).transpose(0, 1) \
            .reshape(n_micro, dp * mb, *t.shape[1:])
    out = _pipeline_blocks(cfg, mesh, params["blocks"], micro(x))
    x = out.reshape(n_micro, dp, mb, S, D).transpose(0, 1).reshape(B, S, D)
    return head_nll(params, x, tgt.long(), head_impl).mean()


def _group_pipeline_loss(cfg: ModelConfig, mesh, n_micro: int,
                         head_impl: str, params, tokens):
    """This process's share of the mean next-token NLL, the reference's
    ``_pipeline_loss`` (76-98) in one process: ``tokens`` are its dp
    group's ``[B/dp, S+1]`` rows, ``params`` its shards.  Stage 0 embeds
    and feeds microbatch t at tick t; every stage runs its layers on what
    it takes at each of the ``n_micro + pp − 1`` ticks (the bubble's
    passes too) and hands the result on; the last stage's head takes the
    microbatches it finished.  Returns the last stage's NLL mean over
    dp (the reference's ``psum(nll·last) / psum(last)`` is the sum of
    these over the processes), zero on the other stages.

    Every process runs the backward of every hop, in the same order: the
    blocks a stage does not read (stage 0's ``recv``; the last tick's
    output on every stage but the last, which no hop carries) join the
    graph with a zero cotangent (``ring_attention._Keep``), as the
    reference's ``jnp.where(stage == 0, feed, recv)`` keeps ``recv``."""
    from tpu_dra_torch.workloads.collective_matmul import ProcessRingShift
    from tpu_dra_torch.workloads.ring_attention import _Keep
    pp, stage = mesh.axis_size("pp"), mesh.axis_index("pp")
    ring = mesh.ring("pp")
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    bl, s = inp.shape
    mb = bl // n_micro
    micro = embed_tokens(cfg, params, inp).reshape(n_micro, mb, s, -1) \
        if stage == 0 else None
    recv = torch.zeros((mb, s, cfg.d_model), dtype=torch.bfloat16,
                       device=tokens.device)
    ticks = n_micro + pp - 1
    done = []
    for t in range(ticks):
        x = recv
        if stage == 0:
            x = micro[min(t, n_micro - 1)]
            if t:
                x = _Keep.apply(x, recv)
        out = _local_stack(cfg, params["blocks"], x)
        if stage == pp - 1 and t >= pp - 1:   # microbatch t - pp + 1 is done
            done.append(out)
        if t < ticks - 1:                     # the last tick's hop is unread
            (recv,) = ProcessRingShift.apply(ring, False, True, out)
    if stage != pp - 1:
        return _Keep.apply(torch.zeros((), device=tokens.device), out)
    x = torch.stack(done).reshape(bl, s, -1)
    return head_nll(params, x, tgt.long(), head_impl).mean() \
        / mesh.axis_size("dp")


def _group_pipeline_step(cfg: ModelConfig, mesh, n_micro: int, lr: float,
                         head_impl: str):
    """:func:`make_pipeline_train_step` on a ``ProcessMesh``: ``step(params,
    tokens)`` takes this process's shards (cut by ``pipeline_param_specs``
    through ``ProcessMesh.shard_tree``) and the global ``[B, S+1]`` batch,
    the same on every process, and returns its new shards and the global
    mean loss.  Each process differentiates its share of the loss
    (:func:`_group_pipeline_loss`); the gradients follow the transpose of
    the reference's ``shard_map``: a block leaf's summed over "dp", a
    replicated leaf's over ("dp", "pp") (``process_train.psum_grads``), so
    every process ends with the same bits in each replicated leaf."""
    from tpu_dra_torch.workloads.process_train import psum_grads
    dp = mesh.axis_size("dp")
    p_shard, t_shard = pipeline_param_specs(cfg), ("dp", None)
    everywhere = tuple(mesh.axis_names)

    def step(params, tokens):
        if tokens.shape[0] % (dp * n_micro):
            raise ValueError(
                f"batch {tokens.shape[0]} not divisible by "
                f"dp*n_micro={dp * n_micro}")
        mesh.check_device(tokens, *tree_leaves(params))
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        share = _group_pipeline_loss(cfg, mesh, n_micro, head_impl,
                                     tree_unflatten(params, leaves),
                                     mesh.shard(tokens, t_shard))
        grads = torch.autograd.grad(share, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        over = [("dp",) if spec else everywhere
                for spec in tree_leaves(tree_like(params, p_shard))]
        grads = psum_grads(mesh, grads, leaves, over)
        new = [p.detach() - lr * g for p, g in zip(leaves, grads)]
        return tree_unflatten(params, new), mesh.psum(share.detach())

    return step, p_shard, t_shard


def make_pipeline_train_step(cfg: ModelConfig, mesh, n_micro: int = 4,
                             lr: float = 1e-2, head_impl: str = "dense"):
    """The pipeline-parallel SGD step over ``mesh`` (axes "dp", "pp";
    ``pipeline.make_pipeline_train_step``, 117-155): ``(step, p_shard,
    t_shard)`` with ``step(params, tokens) -> (params, loss)`` on the
    mesh's device (inputs anywhere else raise ``ValueError``).  Needs
    ``cfg.n_layers % pp == 0`` and a batch divisible by ``dp * n_micro``
    (``ValueError`` otherwise).  ``head_impl="chunked"`` streams the
    vocab in the last stage's NLL.  On a ``mesh.ProcessMesh`` the step
    takes and returns this process's shards (:func:`_group_pipeline_step`).
    """
    n_stages = mesh.axis_size("pp")
    if cfg.n_layers % n_stages:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by pp={n_stages}")
    if isinstance(mesh, ProcessMesh):
        return _group_pipeline_step(cfg, mesh, n_micro, lr, head_impl)
    dp = mesh.axis_size("dp")

    def step(params, tokens):
        if tokens.shape[0] % (dp * n_micro):
            raise ValueError(
                f"batch {tokens.shape[0]} not divisible by "
                f"dp*n_micro={dp * n_micro}")
        mesh.check_device(tokens, *tree_leaves(params))
        loss, grads = value_and_grad(
            lambda p, t: _pipeline_loss(cfg, mesh, n_micro, head_impl, p, t),
            params, tokens)
        new = [p.detach() - lr * g for p, g in zip(tree_leaves(params),
                                                   tree_leaves(grads))]
        return tree_unflatten(params, new), loss

    return step, pipeline_param_specs(cfg), ("dp", None)
