"""The port's counterpart of ``__graft_entry__.entry``: the forward step of
the tiny flagship model with its example arguments.

    from tpu_dra_torch.entry import entry
    fn, (params, tokens) = entry()          # on cuda:0
    logits = fn(params, tokens)             # [2, 64, 256] fp32

``dryrun_multichip`` stays with the reference (ROADMAP.md queue 1 item
9.6).
"""

from __future__ import annotations

import torch

from tpu_dra_torch.device import resolve_device
from tpu_dra_torch.workloads.train import ModelConfig, forward, init_params

# the reference's demo model (__graft_entry__.py:13)
CONFIG = dict(vocab=256, d_model=128, n_heads=4, n_layers=2, d_ff=512,
              max_seq=64)


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
