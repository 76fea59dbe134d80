"""LoRA fine-tuning, ported from ``tpu_dra/workloads/lora.py``: the
tenant's lifecycle pretrain (``fit``) → adapt → :func:`merge_lora` →
``quant.quantize_params_int8`` → serve.

The adapters ride the forward code of every weight form: :func:`wrap_lora`
turns each target leaf into a ``{"base", "a", "b", "scale"}`` dict, which
``quant.matmul_any`` runs as the base product plus the rank-r bypass, so
the base may be plain or int8 (QLoRA).  Only the adapters are
differentiated: the step takes gradients of the LoRA tree alone, and the
optimizer keeps moments for it alone.

Over a dp×tp mesh (``mesh.Mesh``) the base keeps its
``train.param_shardings`` layout and the adapters replicate
(:func:`lora_shardings`); as in the dense sharded step, GSPMD's
collectives are plain there, so the mesh step computes what the
one-device step computes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpu_dra_torch.workloads.mesh import refuse_process_mesh
from tpu_dra_torch.workloads.optim import AdamW
from tpu_dra_torch.workloads.train import (
    ModelConfig,
    loss_fn,
    tree_leaves,
    tree_unflatten,
    value_and_grad,
)

# optax.adamw's own default decay, which the reference's default LoRA
# optimizer (``optax.adamw(1e-3)``) takes; ``fit`` decays at 0.01
LORA_WEIGHT_DECAY = 1e-4


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    #: block-level matmul leaves to adapt ([L, K, N] stacks)
    targets: tuple[str, ...] = ("wqkv", "wo", "w1", "w2")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def init_lora(params: dict, lcfg: LoRAConfig,
              generator: torch.Generator) -> dict:
    """Adapter tree mirroring ``params["blocks"]``'s target leaves:
    ``{"blocks": {name: {"a": f32[L, K, r], "b": f32[L, r, N]}}}``, on the
    device of each base leaf.  A ~ N(0, 1/r) from ``generator``, B = 0,
    so the wrapped model starts EXACTLY equal to the base model."""
    blocks = {}
    for name in lcfg.targets:
        w = params["blocks"][name]
        L, K, N = w.shape
        a = torch.randn((L, K, lcfg.rank), generator=generator,
                        device=generator.device) * (lcfg.rank ** -0.5)
        blocks[name] = {
            "a": a.to(w.device),
            "b": torch.zeros((L, lcfg.rank, N), dtype=torch.float32,
                             device=w.device),
        }
    return {"blocks": blocks}


def wrap_lora(params: dict, lora: dict, lcfg: LoRAConfig) -> dict:
    """Base + adapters → a forward-ready tree whose target leaves are
    ``{"base", "a", "b", "scale"}`` dicts (``quant.matmul_any``);
    ``scale`` is ``[L, 1, 1]`` so each layer's slice stays a tensor."""
    out = dict(params)
    blocks = dict(params["blocks"])
    a0 = next(iter(lora["blocks"].values()))["a"]
    scale = torch.full((a0.shape[0], 1, 1), lcfg.scale, dtype=torch.float32,
                       device=a0.device)
    for name, ab in lora["blocks"].items():
        blocks[name] = {"base": blocks[name], "a": ab["a"], "b": ab["b"],
                        "scale": scale}
    out["blocks"] = blocks
    return out


def merge_lora(params: dict, lora: dict, lcfg: LoRAConfig) -> dict:
    """Fold the adapters into plain weights, ``W + scale·A·B`` in fp32
    then W's dtype: the serving artifact.  Only a plain-tensor base
    merges (merge before quantizing)."""
    out = dict(params)
    blocks = dict(params["blocks"])
    for name, ab in lora["blocks"].items():
        w = blocks[name]
        if not torch.is_tensor(w):
            raise ValueError(f"merge_lora needs a plain base for {name!r}; "
                             f"merge before quantizing or wrapping")
        delta = torch.einsum("lkr,lrn->lkn", ab["a"], ab["b"]) * lcfg.scale
        blocks[name] = (w.float() + delta).to(w.dtype)
    out["blocks"] = blocks
    return out


def lora_value_and_grad(cfg: ModelConfig, base: dict, lora: dict,
                        lcfg: LoRAConfig, tokens, attn_impl: str = "dense",
                        head_impl: str = "dense"):
    """``(loss, grads)`` of ``train.loss_fn`` over the wrapped model, the
    gradients taken of the adapters alone (a dict shaped like ``lora``)."""
    return value_and_grad(
        lambda lo, t: loss_fn(cfg, wrap_lora(base, lo, lcfg), t, attn_impl,
                              head_impl), lora, tokens)


def lora_shardings(lora: dict, mesh) -> dict:
    """Every adapter replicated (``lora.lora_shardings``, 110-114): at
    r = 8 the whole tree is a few MB, and every shard of a tp-split base
    needs the whole rank-r factors.  One spec (``()``) a leaf."""
    return tree_unflatten(lora, [() for _ in tree_leaves(lora)])


def make_lora_train_step(cfg: ModelConfig, mesh=None,
                         lcfg: LoRAConfig | None = None, optimizer=None,
                         attn_impl: str = "dense", head_impl: str = "dense"):
    """The LoRA fine-tuning step (``lora.make_lora_train_step``,
    117-160): ``(step, init_opt_state, lcfg, shardings)`` where
    ``step(base, lora, opt_state, tokens) -> (lora, opt_state, loss)``.
    The base is frozen: no gradients, no moments.  The default optimizer
    is the reference's ``optax.chain(clip_by_global_norm(1.0),
    optax.adamw(1e-3))``, whose decay is :data:`LORA_WEIGHT_DECAY`; it
    updates ``lora`` in place.  On a dp×tp ``mesh`` the inputs must lie
    on its device (else ``ValueError``) and ``shardings`` is
    ``{"params": train.param_shardings, "batch": train.batch_sharding,
    "lora": lora_shardings over the mesh}``; ``mesh=None`` is the one
    device, where ``shardings`` is None."""
    refuse_process_mesh(mesh, "make_lora_train_step")
    from tpu_dra_torch.workloads.train import batch_sharding, param_shardings
    lcfg = lcfg or LoRAConfig()
    if optimizer is None:
        optimizer = AdamW(1e-3, weight_decay=LORA_WEIGHT_DECAY)

    def step(base, lora, opt_state, tokens):
        if mesh is not None:
            mesh.check_device(tokens, *tree_leaves(base), *tree_leaves(lora))
        loss, grads = lora_value_and_grad(cfg, base, lora, lcfg, tokens,
                                          attn_impl, head_impl)
        opt_state = optimizer.update(lora, grads, opt_state)
        return lora, opt_state, loss

    shardings = None
    if mesh is not None:
        shardings = {"params": param_shardings(cfg, mesh),
                     "batch": batch_sharding(mesh),
                     "lora": lambda lora: lora_shardings(lora, mesh)}
    return step, optimizer.init, lcfg, shardings
