"""Workloads of the port.  Serving: model core (``train``), weight forms
(``quant``), decode helpers and beam search (``decode``), paged KV memory
and the paged attention kernel's wrapper (``paged_kv``), the continuous
engine (``continuous``) and the HTTP server with its bucketed decoder
pool (``serve``, with the admission gate ``admission`` and the SLO burn
rates ``slo``).  Training: the loop (``fit``, ``data``, ``optim``),
checkpoints and resume (``checkpointing``), goodput accounting
(``goodput``), LoRA adapters (``lora``), the MoE model (``moe``), and
the sharded steps (``mesh``, ``collective_matmul``, ``ring_attention``).
Start-up of both command lines: ``launcher``."""
