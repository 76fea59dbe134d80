"""Elastic workload supervision, ported from
``tpu_dra/workloads/elastic.py``: resume a multi-node train job across
slice-domain reconfigurations (docs/elastic-domains.md).

A process group is not re-formed inside a process that was in another
one (the reference's ``jax.distributed`` cannot re-initialize at all),
so "tear down and re-join the new membership" is a process boundary:
the **supervisor** (:func:`run_elastic`, no torch imported) waits until
this node is part of the active coordination config, spawns the train
process, and respawns it when the membership reconfigures; the **train
process** polls the config through a :class:`GenerationWatcher` between
steps and calls :func:`exit_for_reconfiguration` on a change, after
which the respawned process re-resolves the new membership
(``workloads/launcher.py``) and resumes from its last committed
checkpoint (``fit(resume=True)``, ``workloads/checkpointing.py``).
Bounded staleness: a reconfiguration loses at most the steps since the
last checkpoint.

The membership key is the rank-ordered ``(name, ip)`` tuple of the
config's nodes, not the bare generation number: a generation bump that
keeps the same mesh (e.g. the controller's first arbitration stamping
roles) must not restart training, while any change of members — loss,
spare promotion, shrink — must.  The generation still rides along for
fencing/attribution, and the config's ``traceparent`` is handed to the
respawned process as ``TPU_TRACEPARENT`` so its re-initialization joins
the recovery trace.
"""

from __future__ import annotations

import os
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from tpu_dra_torch.util.rank import rank_sorted
from tpu_dra_torch.workloads.launcher import load_nodes_config

# exit-code contract between the train process and the supervisor:
# "membership changed; re-resolve and respawn me" (EX_TEMPFAIL)
EXIT_RECONFIGURED = 75


@dataclass(frozen=True)
class Epoch:
    """One observed coordination-config state."""

    generation: int
    members: tuple[tuple[str, str], ...]   # rank-ordered (name, ip)
    traceparent: str = ""


def read_epoch(env: Optional[dict] = None) -> Optional[Epoch]:
    # contract: nodes-config[reader] — the elastic supervisor's view of
    # the same wire format _info_from_config parses
    """The current :class:`Epoch`, or None while no config is readable.
    Config resolution is the launcher's (``load_nodes_config``): the
    supervisor and the train process it spawns always read the same
    chain."""
    e = os.environ if env is None else env
    data = load_nodes_config(e)
    if data is None:
        return None
    nodes = rank_sorted(data.get("nodes", []))
    try:
        generation = int(data.get("generation", 0))
    except (TypeError, ValueError):
        generation = 0
    return Epoch(
        generation=generation,
        members=tuple((n.get("name", ""), n.get("ipAddress", ""))
                      for n in nodes),
        traceparent=str(data.get("traceparent", "")))


class GenerationWatcher:
    """Poll the coordination config from the train process; trip
    :attr:`reconfigured` when the membership changes.

    Check ``watcher.reconfigured.is_set()`` between train steps; on a
    trip, checkpoint cadence permitting, call
    :func:`exit_for_reconfiguration`.
    """

    def __init__(self, env: Optional[dict] = None,
                 poll_interval: float = 2.0,
                 baseline: Optional[Epoch] = None) -> None:
        self._env = dict(os.environ) if env is None else env
        self._poll = poll_interval
        self.reconfigured = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._mu = threading.Lock()
        self._baseline = baseline if baseline is not None \
            else read_epoch(self._env)          # guarded by self._mu
        self._latest = self._baseline           # guarded by self._mu

    @property
    def baseline(self) -> Optional[Epoch]:
        with self._mu:
            return self._baseline

    @property
    def latest(self) -> Optional[Epoch]:
        with self._mu:
            return self._latest

    def check_now(self) -> bool:
        """One synchronous poll; True when the membership changed."""
        epoch = read_epoch(self._env)
        if epoch is None:
            return self.reconfigured.is_set()
        with self._mu:
            base = self._baseline
            if base is None:
                self._baseline = epoch
            self._latest = epoch
        if base is not None and epoch.members != base.members:
            self.reconfigured.set()
        return self.reconfigured.is_set()

    def start(self) -> "GenerationWatcher":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="generation-watcher")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self._poll):
            self.check_now()


def exit_for_reconfiguration(code: int = EXIT_RECONFIGURED) -> None:
    """Tear down the ``torch.distributed`` group (bounded: peers may be
    dead) and exit so the elastic supervisor re-resolves the new
    membership and respawns.  Call from the train loop's main thread:
    ``sys.exit`` runs atexit hooks (health-heartbeat unlink, trace flush)
    on the way out."""
    import sys

    def _shutdown() -> None:
        # the group may be absent, already torn down, or wedged on dead
        # peers; the process exit is the real teardown
        try:
            import torch.distributed as dist
            if dist.is_available() and dist.is_initialized():
                dist.destroy_process_group()
        except (ImportError, RuntimeError, OSError, ValueError):
            pass

    t = threading.Thread(target=_shutdown, daemon=True,
                         name="torch-distributed-shutdown")
    t.start()
    t.join(timeout=5.0)
    sys.exit(code)


def wait_until_member(env: Optional[dict] = None, poll: float = 0.5,
                      timeout: Optional[float] = None,
                      stop: Optional[threading.Event] = None
                      ) -> Optional[Epoch]:
    """Block until this node's ``POD_IP`` appears in the active
    coordination config — a spare node's supervisor parks here until the
    controller promotes it.  Returns the epoch, None when ``stop`` was
    set, or raises TimeoutError."""
    e = os.environ if env is None else env
    my_ip = e.get("POD_IP", "")
    waiter = stop if stop is not None else threading.Event()
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        epoch = read_epoch(e)
        if epoch is not None and any(ip == my_ip
                                     for _, ip in epoch.members):
            return epoch
        if deadline is not None and time.monotonic() > deadline:
            raise TimeoutError(
                f"node {my_ip} never became an active member")
        if waiter.wait(poll) and stop is not None:
            return None   # interrupted: supervisor shutting down


def run_elastic(argv: list[str], env: Optional[dict] = None,
                max_reconfigurations: int = 32, poll: float = 0.5,
                member_timeout: Optional[float] = None,
                reconfigure_grace: float = 60.0,
                stop: Optional[threading.Event] = None,
                on_spawn: Optional[Callable] = None,
                goodput_tracker=None) -> int:
    """Supervise an elastic train process (no torch in THIS process).

    Each round waits until this node is an active member, then spawns
    ``argv`` with ``TPU_ELASTIC_GENERATION`` (fencing) and
    ``TPU_TRACEPARENT`` (recovery-trace continuation) injected.  Exit
    codes: 0 → done; :data:`EXIT_RECONFIGURED` → respawn into the new
    membership; any other failure is respawned only when the membership
    changed around it (a collective aborting because a peer died is
    reconfiguration collateral, observable up to ``reconfigure_grace``
    seconds later), otherwise propagated.

    ``reconfigure_grace`` must exceed the controller's detection latency
    — lease duration + sweep period + config propagation (defaults
    30s + 10s) — or a crash caused by a dying peer is propagated as a
    real failure before the membership change that explains it becomes
    visible.  The 60s default covers the controller defaults; lower it
    in lockstep when the domain runs with shorter leases.

    ``goodput_tracker`` (a ``workloads/goodput.GoodputTracker`` of the port): the
    supervisor is the only process that can SEE reconfiguration downtime
    — the worker is dead for all of it — so the worker-exit → respawn
    interval is recorded here, attributed to the ``reconfiguration``
    segment and stamped with the recovery traceparent from the new
    coordination config.  When the tracker carries a state file its path
    is injected as ``TPU_GOODPUT_FILE`` so the spawned worker's own
    segments (steps, compile, checkpoints) merge into the same ledger.
    """
    e = dict(os.environ) if env is None else dict(env)
    reconfigurations = 0
    downtime_from: Optional[float] = None
    while True:
        epoch = wait_until_member(e, poll=poll, timeout=member_timeout,
                                  stop=stop)
        if epoch is None:
            return 130   # stopped while parked
        if goodput_tracker is not None and downtime_from is not None:
            # downtime closes HERE — membership re-resolved, about to
            # respawn — so the segment covers detection + arbitration +
            # config propagation, the whole recovery the workload felt
            goodput_tracker.record_downtime(
                time.monotonic() - downtime_from,
                traceparent=epoch.traceparent,
                generation=epoch.generation)
        downtime_from = None
        child_env = dict(e)
        child_env["TPU_ELASTIC_GENERATION"] = str(epoch.generation)
        if epoch.traceparent:
            child_env["TPU_TRACEPARENT"] = epoch.traceparent
        if goodput_tracker is not None and goodput_tracker.state_path:
            from tpu_dra_torch.workloads.goodput import STATE_ENV
            child_env[STATE_ENV] = goodput_tracker.state_path
        proc = subprocess.Popen(argv, env=child_env)
        if on_spawn is not None:
            on_spawn(proc, epoch)
        rc = proc.wait()
        if rc == 0:
            return 0
        downtime_from = time.monotonic()
        changed = rc == EXIT_RECONFIGURED
        waiter = stop if stop is not None else threading.Event()
        deadline = time.monotonic() + reconfigure_grace
        while not changed and time.monotonic() < deadline:
            cur = read_epoch(e)
            if cur is not None and cur.members != epoch.members:
                changed = True
                break
            if waiter.wait(poll) and stop is not None:
                return rc   # interrupted: supervisor shutting down
        if not changed:
            return rc
        reconfigurations += 1
        if reconfigurations > max_reconfigurations:
            return rc or 1
