"""PyTorch/CUDA port of the serving workload in ``tpu_dra.workloads``.

The JAX package stays the reference; this package runs the same model and
the same paged continuous-serving path on one NVIDIA GPU.  It imports
torch, numpy and the standard library only — never ``jax`` and never
``tpu_dra`` — so a GPU host needs neither installed.

Layout mirrors the reference by name: ``tpu_dra_torch/workloads/<m>.py``
ports ``tpu_dra/workloads/<m>.py``.  Hand-written kernels live in
``csrc/`` and are built on first use by ``kernels/build.py``.
"""
