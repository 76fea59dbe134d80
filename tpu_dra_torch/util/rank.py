"""Canonical node ordering for ``nodes_config.json`` consumers, a copy
of ``tpu_dra/util/rank.py``.

ONE implementation for the port's launcher (``workloads/launcher.py``,
settings-dir and coordination-service paths alike) and its elastic
supervisor (``workloads/elastic.py``), so two processes resolving the
same config can never disagree on rank assignment: a
``torch.distributed`` rendezvous hangs if they do.  It orders nodes
exactly as the reference's (and the driver's coordination service,
which serves the config) does.
"""

from __future__ import annotations


def rank_sorted(nodes: list[dict]) -> list[dict]:
    """Global process order over node dicts.

    Explicit ``rank`` when every entry carries it (multislice-aware,
    slice-major, as the slice daemon's ``write_nodes_config`` assigns
    them); legacy ``(workerID, name)`` otherwise, with a missing workerID
    sorting LAST and a missing name tolerated."""
    if all(isinstance(n.get("rank"), int) for n in nodes):
        return sorted(nodes, key=lambda n: n["rank"])
    return sorted(nodes, key=lambda n: (n.get("workerID", 1 << 30),
                                        n.get("name", "")))
