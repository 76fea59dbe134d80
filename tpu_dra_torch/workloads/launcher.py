"""Workload start-up of the port, the part of ``tpu_dra/workloads/
launcher.py``'s ``init_tpu_workload`` that one card needs: the
``launcher.init_tpu_workload`` span, a child of the span that placed the
container (``TPU_TRACEPARENT``), and goodput accounting when
``TPU_GOODPUT_FILE`` asks for it.

The reference's other contracts (the multiprocess slot, the HBM limit,
the scheduling priority, the health heartbeat) and its rendezvous come
with the port of the launcher for several cards (ROADMAP.md queue 1 item
9).  The command lines of ``fit`` and ``serve`` call
:func:`init_tpu_workload` first, as the reference's do.
"""

from __future__ import annotations

from typing import Optional

from tpu_dra_torch.trace import get_tracer
from tpu_dra_torch.trace.propagation import extract_env
from tpu_dra_torch.workloads import goodput


def init_tpu_workload(env: Optional[dict[str, str]] = None) -> dict:
    """Open the ``launcher.init_tpu_workload`` span parented on
    ``TPU_TRACEPARENT`` and start the default goodput tracker when
    ``TPU_GOODPUT_FILE`` is set (``env``: default ``os.environ``).
    Returns ``{"goodput": started}``."""
    with get_tracer().start_span("launcher.init_tpu_workload",
                                 parent=extract_env(env)) as span:
        started = goodput.start_from_env(env) is not None
        span.set_attribute("goodput", started)
    return {"goodput": started}
