"""Workload start-up of the port: the one-card half of
``tpu_dra/workloads/launcher.py``'s ``init_tpu_workload``.

The driver's kubelet plugin gives every claimed container four resource
contracts through its environment (MultiProcess sharing and shared
tenancy, ``tpu_dra/plugins/tpu/sharing.py`` and ``tenancy.py``: several
tenants packed onto one chip, the analog of MPS).  This module enforces
them on the workload's side, under the reference's variable names and
rules, since the driver that writes them is the same:

- a process-slot pool (``TPU_MULTIPROCESS_SLOT_DIR``,
  ``TPU_MULTIPROCESS_MAX``): one ``flock``'d slot file per process,
  held for the process's life, and a process past ``maxProcesses`` is
  refused (:func:`acquire_multiprocess_slot`);
- a per-chip memory budget (``TPU_HBM_LIMIT_BYTES_<minor>``), installed
  as the CUDA caching allocator's cap on the process's device
  (:func:`apply_hbm_limits`);
- a scheduling priority (``TPU_PROCESS_PRIORITY``) as OS niceness
  (:func:`apply_scheduling_priority`);
- a health heartbeat (``TPU_HEALTH_HEARTBEAT_DIR`` / ``_FILE``) touched
  from a daemon thread (:func:`start_health_heartbeat`), and the ``oom``
  sentinel beside it that asks the driver to evict this tenant alone
  (:func:`report_hbm_oom`).

:func:`init_tpu_workload` applies them in the reference's order, opens
the ``launcher.init_tpu_workload`` span (a child of ``TPU_TRACEPARENT``)
and starts goodput accounting when ``TPU_GOODPUT_FILE`` asks for it.  The
command lines of ``fit`` and ``serve`` call it first, as the reference's
do.

The rendezvous half (the reference's :34-103, :467-610): :func:`resolve`
turns the slice-domain claim's environment (``SLICE_DOMAIN_UUID``, the
``SLICE_SETTINGS_DIR`` mount's ``nodes_config.json``, the node's
coordination service on ``SLICE_COORDINATOR_PORT``, or explicit
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
overrides; ``POD_IP`` names this process) into a :class:`RendezvousInfo`
under the reference's names, since the driver that writes them is the
same; :meth:`RendezvousInfo.initialize` applies the contracts above and
calls ``torch.distributed.init_process_group`` where the reference calls
``jax.distributed.initialize``.  :func:`run_local_group` starts a command
as the n ranks of one group on this host through that rendezvous (the
port's own: one process a rank on one machine, several of them sharing
one card over gloo).
"""

from __future__ import annotations

import atexit
import fcntl
import http.client
import json
import os
import re
import threading
import urllib.request
from dataclasses import dataclass
from typing import Optional

from tpu_dra_torch.resilience import failpoint
from tpu_dra_torch.trace import get_tracer
from tpu_dra_torch.trace.propagation import extract_env
from tpu_dra_torch.util.rank import rank_sorted
from tpu_dra_torch.workloads import goodput

failpoint.register(
    "launcher.init",
    "top of init_tpu_workload, before any resource contract is applied")
failpoint.register(
    "launcher.resolve",
    "top of rendezvous resolution (error/sleep here simulates a slow or "
    "failed settings-mount/coordservice)")

_HBM_LIMIT = re.compile(r"^TPU_HBM_LIMIT_BYTES_(\d+)$")


def apply_hbm_limits(env: Optional[dict[str, str]] = None,
                     install: bool = True, device=None) -> Optional[int]:
    """The driver's memory budget for the chips this process opens: the
    tightest ``TPU_HBM_LIMIT_BYTES_<minor>`` among the minors of
    ``TPU_VISIBLE_CHIPS`` (or ``TPU_VISIBLE_DEVICES``; every budget when
    neither names a minor; path-form entries are not minors and are
    skipped).  Returns the budget in bytes, or None when none applies;
    ``RuntimeError`` on a malformed value.

    With ``install``, the budget becomes the cap of the CUDA caching
    allocator on ``device`` (default ``cuda:0``; a CPU device, or no
    CUDA, installs nothing):
    ``torch.cuda.set_per_process_memory_fraction(limit / total)``, after
    which an allocation past it raises ``torch.cuda.OutOfMemoryError``.
    The cap covers what the allocator reserves, not the CUDA context
    itself.  Installing initializes CUDA, so ask for it only where the
    process uses the card anyway."""
    e = os.environ if env is None else env
    limits: dict[int, int] = {}
    for key, val in list(e.items()):
        m = _HBM_LIMIT.match(key)
        if m:
            try:
                limits[int(m.group(1))] = int(val)
            except ValueError:
                raise RuntimeError(f"malformed HBM limit {key}={val!r}")
    if not limits:
        return None
    visible = e.get("TPU_VISIBLE_CHIPS") or e.get("TPU_VISIBLE_DEVICES")
    scoped = list(limits.values())
    if visible:
        minors = [int(v) for v in visible.split(",")
                  if v.strip().lstrip("-").isdigit()]
        if minors:
            scoped = [limits[mn] for mn in minors if mn in limits]
    limit = min(scoped) if scoped else None
    if limit is None or not install:
        return limit
    import torch
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        total = torch.cuda.get_device_properties(dev).total_memory
        torch.cuda.set_per_process_memory_fraction(min(1.0, limit / total),
                                                   dev)
    return limit


# ---------------------------------------------------------------------------
# The process-slot gate
# ---------------------------------------------------------------------------

# the marker the driver-injected sitecustomize shim keeps of the slots this
# process holds (tpu_dra/plugins/tpu/_shim_sitecustomize.py): read and
# written here too, so a slot taken through the shim is not taken twice
_MARKER_ENV = "TPU_DRA_SLOTS_HELD"

# process-lifetime holds: the open slot fds (the lock lives with the fd)
# and the pools this process holds a slot in (re-entry takes no second)
_HELD_SLOTS: list[int] = []
_ACQUIRED_POOLS: dict[str, int] = {}   # pool realpath -> slot index


def _verify_held(pool_dir: str, slot: int) -> bool:
    """Does this process hold ``slot-<slot>.lock``?  True when the lock
    is held by someone (a fresh fd's flock conflicts) and the holder
    wrote this process's pid into the file."""
    path = os.path.join(pool_dir, f"slot-{slot}.lock")
    try:
        fd = os.open(path, os.O_RDWR)
    except OSError:
        return False
    try:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            pid = os.read(fd, 64).decode(errors="replace").strip()
            return pid == str(os.getpid())
        fcntl.flock(fd, fcntl.LOCK_UN)   # nobody holds it: marker stale
        return False
    finally:
        os.close(fd)


def _parse_marker(env) -> dict[str, int]:
    """{pool realpath: slot} that this process verifiably holds, from the
    marker; a pid mismatch or a failed lock check drops the entry."""
    raw = env.get(_MARKER_ENV, "")
    if not raw:
        return {}
    parts = raw.split(";")
    if parts[0] != f"pid={os.getpid()}":
        return {}
    held = {}
    for part in parts[1:]:
        pool, _, slot = part.rpartition("=")
        if pool and slot.isdigit() and _verify_held(pool, int(slot)):
            held[pool] = int(slot)
    return held


def _write_marker(env, held: dict[str, int]) -> None:
    env[_MARKER_ENV] = ";".join(
        [f"pid={os.getpid()}"] + [f"{p}={s}" for p, s in sorted(held.items())])


def _acquire_in_pool(pool_dir: str, fallback_max: int, env=None) -> int:
    """One slot of ``pool_dir`` for this process: the first
    ``slot-<i>.lock`` of ``max`` (its file, else ``fallback_max``) that
    ``flock`` grants, stamped with the pid and kept open (inheritable, so
    the hold survives ``exec``).  A pool this process already holds a
    slot in, through this module or the shim, gives that slot back."""
    e = os.environ if env is None else env
    key = os.path.realpath(pool_dir)
    if key in _ACQUIRED_POOLS:
        return _ACQUIRED_POOLS[key]
    marker = _parse_marker(e)
    if key in marker:
        _ACQUIRED_POOLS[key] = marker[key]
        return marker[key]
    try:
        with open(os.path.join(pool_dir, "max")) as f:
            max_procs = int(f.read().strip())
    except (FileNotFoundError, ValueError):
        max_procs = fallback_max
    for slot in range(max_procs):
        fd = os.open(os.path.join(pool_dir, f"slot-{slot}.lock"),
                     os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            continue
        try:
            os.ftruncate(fd, 0)   # a crashed holder's longer pid
            os.write(fd, f"{os.getpid()}\n".encode())
            os.set_inheritable(fd, True)
        except OSError:
            os.close(fd)          # closing releases the lock too
            raise
        _HELD_SLOTS.append(fd)
        _ACQUIRED_POOLS[key] = slot
        marker = _parse_marker(e)
        marker[key] = slot
        _write_marker(e, marker)
        return slot
    raise RuntimeError(
        f"all {max_procs} process slots of pool {pool_dir!r} are held "
        f"(maxProcesses={max_procs}); refusing to oversubscribe the chip")


def acquire_multiprocess_slot(env: Optional[dict[str, str]] = None
                              ) -> Optional[dict[str, int]]:
    """Hold one process slot in every pool of this container's claims:
    ``TPU_MULTIPROCESS_SLOT_DIR`` itself when it holds a ``max`` file,
    and each subdirectory that does.  The kernel releases the locks when
    the process exits, crash included, so slots never leak.  Past
    ``maxProcesses`` raises ``RuntimeError`` instead of oversubscribing
    the chip.  Returns ``{pool name: slot}`` (name "" for the directory
    itself), or None when the claim is not slot-managed."""
    e = os.environ if env is None else env
    base = e.get("TPU_MULTIPROCESS_SLOT_DIR", "")
    if not base or not os.path.isdir(base):
        return None
    fallback_max = int(e.get("TPU_MULTIPROCESS_MAX", "1"))
    acquired: dict[str, int] = {}
    if os.path.exists(os.path.join(base, "max")):
        acquired[""] = _acquire_in_pool(base, fallback_max, e)
    for name in sorted(os.listdir(base)):
        pool = os.path.join(base, name)
        if os.path.isdir(pool) and os.path.exists(os.path.join(pool, "max")):
            acquired[name] = _acquire_in_pool(pool, fallback_max, e)
    return acquired or None


# ---------------------------------------------------------------------------
# Priority, heartbeat, OOM sentinel
# ---------------------------------------------------------------------------

_PRIORITY_NICE = {"Low": 10, "Normal": 0, "High": -5}
_PRIORITY_APPLIED = False   # renice once per process


def apply_scheduling_priority(env: Optional[dict[str, str]] = None
                              ) -> Optional[int]:
    """The driver's ``TPU_PROCESS_PRIORITY`` hint as OS niceness: tenants
    of one card contend on the host's launch path, which the scheduler
    can favour.  Raising priority needs CAP_SYS_NICE; without it the
    hint is a no-op.  Returns the applied increment, or None (unset,
    Normal, unknown, refused, or already applied)."""
    global _PRIORITY_APPLIED
    e = os.environ if env is None else env
    delta = _PRIORITY_NICE.get(e.get("TPU_PROCESS_PRIORITY", ""))
    if not delta or _PRIORITY_APPLIED:
        return None
    try:
        os.nice(delta)
    except OSError:
        return None
    _PRIORITY_APPLIED = True
    return delta


# one heartbeat thread a process (a second start is a no-op)
_HEARTBEAT_THREAD: Optional[threading.Thread] = None
_HEARTBEAT_STOP: Optional[threading.Event] = None
_HEARTBEAT_PATHS: list[str] = []


def _touch_heartbeat(path: str) -> bool:
    try:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "a"):
            pass
        os.utime(path, None)
        return True
    except OSError:
        return False   # advisory: never kill the workload


def _heartbeat_paths(e) -> list[str]:
    """Beat files: ``TPU_HEALTH_HEARTBEAT_FILE`` when set, else a ``beat``
    in every claim subdirectory of ``TPU_HEALTH_HEARTBEAT_DIR``."""
    path = e.get("TPU_HEALTH_HEARTBEAT_FILE", "")
    if path:
        return [path]
    base = e.get("TPU_HEALTH_HEARTBEAT_DIR", "")
    if not base or not os.path.isdir(base):
        return []
    return [os.path.join(base, sub, "beat")
            for sub in sorted(os.listdir(base))
            if os.path.isdir(os.path.join(base, sub))]


def start_health_heartbeat(env: Optional[dict[str, str]] = None,
                           interval: float = 30.0) -> Optional[list[str]]:
    """Touch every beat file now and then every ``interval`` seconds from
    a daemon thread; the node's heartbeat probe flags a claim's chips
    when its beat exists but goes stale.  The files are unlinked at
    interpreter exit, so an exited workload reads as "no heartbeat", not
    as a wedged one.  Opt-in and advisory.  Returns the beat paths, or
    None."""
    global _HEARTBEAT_THREAD, _HEARTBEAT_STOP, _HEARTBEAT_PATHS
    e = os.environ if env is None else env
    paths = _heartbeat_paths(e)
    if not paths:
        return None
    if _HEARTBEAT_THREAD is not None and _HEARTBEAT_THREAD.is_alive():
        return list(_HEARTBEAT_PATHS)
    paths = [p for p in paths if _touch_heartbeat(p)]
    if not paths:
        return None
    stop = threading.Event()

    def beat() -> None:
        while not stop.wait(interval):
            for p in paths:
                _touch_heartbeat(p)

    _HEARTBEAT_STOP = stop
    _HEARTBEAT_PATHS = list(paths)
    _HEARTBEAT_THREAD = threading.Thread(target=beat, daemon=True,
                                         name="health-heartbeat")
    _HEARTBEAT_THREAD.start()
    atexit.register(stop_health_heartbeat)
    return list(paths)


def stop_health_heartbeat() -> None:
    """Stop the heartbeat thread and unlink its beat files."""
    global _HEARTBEAT_THREAD, _HEARTBEAT_STOP, _HEARTBEAT_PATHS
    if _HEARTBEAT_STOP is not None:
        _HEARTBEAT_STOP.set()
    if _HEARTBEAT_THREAD is not None:
        _HEARTBEAT_THREAD.join(timeout=5)
    for p in _HEARTBEAT_PATHS:
        try:
            os.unlink(p)
        except OSError:
            pass
    _HEARTBEAT_THREAD = None
    _HEARTBEAT_STOP = None
    _HEARTBEAT_PATHS = []


def report_hbm_oom(env: Optional[dict[str, str]] = None,
                   detail: str = "") -> list[str]:
    """After catching its budget's ``torch.cuda.OutOfMemoryError``, a
    tenant drops an ``oom`` sentinel beside each of its beat files; the
    driver's tenant sweep then evicts this tenant alone while the card's
    other tenants keep running.  Advisory: returns the sentinels
    written, never raises."""
    e = os.environ if env is None else env
    written = []
    for beat in _heartbeat_paths(e):
        path = os.path.join(os.path.dirname(beat), "oom")
        try:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(path, "w") as f:
                f.write(detail or "workload reported HBM budget exceeded")
            written.append(path)
        except OSError:
            continue
    return written


def init_tpu_workload(env: Optional[dict[str, str]] = None,
                      dry_run: bool = False, *, device=None) -> dict:
    """Apply every resource contract of the environment (``env``, default
    ``os.environ``) in dependency order: the slot gate (fail fast, before
    any device work), the memory budget (installed on ``device``, default
    the card, unless it is the CPU), the priority, the heartbeat, then
    goodput accounting; inside the
    ``launcher.init_tpu_workload`` span parented on ``TPU_TRACEPARENT``.
    Returns what was applied: ``{"slot", "hbm_limit_bytes", "nice",
    "heartbeat", "goodput"}``.

    ``dry_run=True`` computes without side effects: no slot is locked,
    CUDA is not touched, the process is not reniced, no heartbeat starts
    and no span or tracker either."""
    failpoint.hit("launcher.init")
    if dry_run:
        e = dict(os.environ) if env is None else env
        return {
            "slot": None,
            "hbm_limit_bytes": apply_hbm_limits(e, install=False),
            "nice": _PRIORITY_NICE.get(
                e.get("TPU_PROCESS_PRIORITY", ""), 0) or None,
            "heartbeat": _heartbeat_paths(e) or None,
        }
    with get_tracer().start_span("launcher.init_tpu_workload",
                                 parent=extract_env(env)) as span:
        applied = {
            "slot": acquire_multiprocess_slot(env),
            "hbm_limit_bytes": apply_hbm_limits(env, device=device),
            "nice": apply_scheduling_priority(env),
            "heartbeat": start_health_heartbeat(env),
            "goodput": goodput.start_from_env(env) is not None,
        }
        span.set_attribute("slot", bool(applied["slot"]))
        span.set_attribute("hbm_limited",
                           applied["hbm_limit_bytes"] is not None)
        span.set_attribute("goodput", applied["goodput"])
    return applied


# ---------------------------------------------------------------------------
# Rendezvous: the driver's environment to torch.distributed
# ---------------------------------------------------------------------------

JAX_COORDINATOR_PORT = 8476
MEGASCALE_COORDINATOR_PORT = 8080   # the reference's libtpu megascale default
BACKENDS = ("nccl", "gloo")


@dataclass
class RendezvousInfo:
    coordinator_address: str     # "ip:port" of rank 0's TCP store
    num_processes: int
    process_id: int
    domain_uid: str = ""
    # membership generation the coordination config was derived from
    # (elastic domains): 0 for legacy configs; the elastic supervisor
    # (workloads/elastic.py) fences re-initialization on it
    generation: int = 0
    # multislice rendezvous: set when the domain spans more than one
    # partition; slice_id/num_slices mirror MEGASCALE_SLICE_ID /
    # MEGASCALE_NUM_SLICES, megascale_coordinator is the slice-0 rank-0
    # host
    num_slices: int = 1
    slice_id: int = 0
    megascale_coordinator: str = ""

    def megascale_env(self, env: Optional[dict[str, str]] = None
                      ) -> dict[str, str]:
        """The MEGASCALE_* env for this process, as the reference emits
        it on multislice domains; empty for single-slice domains.  The
        port's collectives do not read it: it is exported for whatever
        else in the container does (the reference's contract)."""
        if self.num_slices <= 1:
            return {}
        e = os.environ if env is None else env
        out = {
            "MEGASCALE_NUM_SLICES": str(self.num_slices),
            "MEGASCALE_SLICE_ID": str(self.slice_id),
        }
        if self.megascale_coordinator:
            # an explicit host:port is kept verbatim; a bare host gets the
            # default (overridable) megascale port appended
            addr = self.megascale_coordinator
            if ":" not in addr:
                port = e.get("MEGASCALE_COORDINATOR_PORT",
                             str(MEGASCALE_COORDINATOR_PORT))
                addr = f"{addr}:{port}"
            out["MEGASCALE_COORDINATOR_ADDRESS"] = addr
        return out

    def initialize(self, backend: str = "nccl") -> None:
        """Join the process group of the resolved triple.  Every
        driver-injected contract is applied first, in the reference's
        order: the slot gate (fail fast, before any device work), the
        memory budget, the priority, the heartbeat and, on multislice
        domains, the MEGASCALE_* env (an explicit user value wins).
        Then ``torch.distributed.init_process_group(backend,
        init_method="tcp://<coordinator_address>", world_size,
        rank)``; with ``"nccl"`` the process's device is the first card
        it can see.  ``backend`` is explicit: ``"gloo"`` is for the CPU
        and for several processes on one card, which NCCL refuses.  The
        whole init is one ``launcher.initialize`` span, a child of the
        prepare that placed the container (``TPU_TRACEPARENT``)."""
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        with get_tracer().start_span(
                "launcher.initialize", parent=extract_env(),
                attributes={"coordinator": self.coordinator_address,
                            "num_processes": self.num_processes,
                            "process_id": self.process_id,
                            "backend": backend}):
            acquire_multiprocess_slot()
            apply_hbm_limits()
            apply_scheduling_priority()
            start_health_heartbeat()
            for key, val in self.megascale_env().items():
                os.environ.setdefault(key, val)   # explicit user env wins
            import torch
            import torch.distributed as dist
            if backend == "nccl":
                torch.cuda.set_device(0)
            with get_tracer().start_span("launcher.torch_distributed_init"):
                dist.init_process_group(
                    backend,
                    init_method=f"tcp://{self.coordinator_address}",
                    world_size=self.num_processes, rank=self.process_id)


def _coordinator_port(env: Optional[dict] = None) -> int:
    """Coordinator port, overridable via ``JAX_COORDINATOR_PORT`` (the
    slice plugin may inject it; tests use it to stay parallel-safe)."""
    e = os.environ if env is None else env
    return int(e.get("JAX_COORDINATOR_PORT", JAX_COORDINATOR_PORT))


def _info_from_config(data: dict, my_ip: str,
                      env: Optional[dict] = None
                      ) -> Optional[RendezvousInfo]:
    """This process's triple from a nodes config: rank 0's address on
    the coordinator port, the node count, and this node's rank (None
    when ``my_ip`` is not a member)."""
    nodes = data.get("nodes", [])
    if not nodes:
        return None
    nodes = rank_sorted(nodes)
    coordinator = f"{nodes[0]['ipAddress']}:{_coordinator_port(env)}"
    pid = next((i for i, n in enumerate(nodes)
                if n.get("ipAddress") == my_ip), -1)
    if pid < 0:
        return None
    info = RendezvousInfo(coordinator, len(nodes), pid)
    try:
        info.generation = int(data.get("generation", 0))
    except (TypeError, ValueError):
        info.generation = 0
    ms = data.get("multislice")
    if ms:
        info.num_slices = int(ms.get("numSlices", 1))
        # this PROCESS's slice is its own node's, not the config writer's
        info.slice_id = int(nodes[pid].get("sliceID",
                                           ms.get("sliceID", 0)))
        info.megascale_coordinator = ms.get("megascaleCoordinator", "")
    return info


def _read_config_file(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            data = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None
    return data if data.get("nodes") else None


def _fetch_config_http(port: int) -> Optional[dict]:
    """The node-local coordination service's ``/nodes`` (the full nodes
    config: rank order, generation and the multislice block, so this
    path and the settings dir resolve alike), or None."""
    try:
        data = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/nodes", timeout=5).read())
    # HTTPException (e.g. IncompleteRead mid-body) is not an OSError
    except (OSError, ValueError, http.client.HTTPException):
        return None
    return data if isinstance(data, dict) and data.get("nodes") else None


def load_nodes_config(env: Optional[dict] = None) -> Optional[dict]:
    """The raw coordination config from the driver-injected env: the
    mounted settings dir first, then the node-local coordination
    service.  :func:`resolve` and the elastic supervisor
    (``workloads/elastic.py``) both read it through here."""
    e = os.environ if env is None else env
    settings = e.get("SLICE_SETTINGS_DIR", "/etc/tpu-slice")
    data = _read_config_file(os.path.join(settings, "nodes_config.json"))
    if data is None:
        data = _fetch_config_http(
            int(e.get("SLICE_COORDINATOR_PORT", "51000")))
    return data


def _from_settings_dir(settings_dir: str, my_ip: str,
                       env: Optional[dict] = None
                       ) -> Optional[RendezvousInfo]:
    data = _read_config_file(
        os.path.join(settings_dir, "nodes_config.json"))
    return None if data is None else _info_from_config(data, my_ip, env)


def _from_coordservice(port: int, my_ip: str,
                       env: Optional[dict] = None
                       ) -> Optional[RendezvousInfo]:
    data = _fetch_config_http(port)
    return None if data is None else _info_from_config(data, my_ip, env)


def resolve(env: Optional[dict[str, str]] = None) -> RendezvousInfo:
    """Resolve the rendezvous from the driver-injected environment.

    Order: explicit JAX_* overrides, then the mounted settings dir, then
    the local coordination service.  ``RuntimeError`` when the claim env
    is absent (the pod was not given a slice-domain channel claim) or
    nothing resolves."""
    env = dict(os.environ) if env is None else env
    with get_tracer().start_span("launcher.resolve_rendezvous",
                                 parent=extract_env(env)):
        return _resolve(env)


def _resolve(env: dict[str, str]) -> RendezvousInfo:
    failpoint.hit("launcher.resolve")
    if env.get("JAX_COORDINATOR_ADDRESS"):
        return RendezvousInfo(
            coordinator_address=env["JAX_COORDINATOR_ADDRESS"],
            num_processes=int(env.get("JAX_NUM_PROCESSES", "1")),
            process_id=int(env.get("JAX_PROCESS_ID", "0")),
            domain_uid=env.get("SLICE_DOMAIN_UUID", ""),
            num_slices=int(env.get("MEGASCALE_NUM_SLICES", "1")),
            slice_id=int(env.get("MEGASCALE_SLICE_ID", "0")),
            megascale_coordinator=env.get(
                "MEGASCALE_COORDINATOR_ADDRESS", ""))
    domain_uid = env.get("SLICE_DOMAIN_UUID", "")
    if not domain_uid:
        raise RuntimeError(
            "no slice-domain claim env present "
            "(SLICE_DOMAIN_UUID unset): give the pod a channel claim from "
            "the domain's ResourceClaimTemplate")
    my_ip = env.get("POD_IP", "")
    settings = env.get("SLICE_SETTINGS_DIR", "/etc/tpu-slice")
    info = _from_settings_dir(settings, my_ip, env)
    if info is None:
        port = int(env.get("SLICE_COORDINATOR_PORT", "51000"))
        info = _from_coordservice(port, my_ip, env)
    if info is None:
        raise RuntimeError(
            f"slice domain {domain_uid}: could not resolve rendezvous "
            f"(settings dir {settings!r} empty and coordination service "
            f"unreachable)")
    info.domain_uid = domain_uid
    return info


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_local_group(argv: list, n: int, *, timeout: float,
                    env: Optional[dict[str, str]] = None,
                    cwd: Optional[str] = None) -> list[str]:
    """Start ``argv`` as the ``n`` ranks of one process group on this
    host and wait for all of them; return each rank's output (stdout and
    stderr together), in rank order.

    Each rank finds its triple through :func:`resolve`: the explicit
    ``JAX_COORDINATOR_ADDRESS`` (127.0.0.1 on a free port),
    ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``, which it then joins
    with ``RendezvousInfo.initialize(backend)``; the rest of the
    environment is ``env`` (default: this process's) without the
    ``TPU_``, ``JAX_``, ``SLICE_`` and ``MEGASCALE_`` variables.  A rank
    that exits non-zero, or a group that outlives ``timeout`` seconds,
    ends every other rank and raises ``RuntimeError`` with each rank's
    output tail: no rank's failure goes unnoticed."""
    import subprocess
    import tempfile
    import time
    base = {k: v for k, v in (os.environ if env is None else env).items()
            if not k.startswith(("TPU_", "JAX_", "SLICE_", "MEGASCALE_"))}
    address = f"127.0.0.1:{_free_port()}"
    with tempfile.TemporaryDirectory(prefix="local-group-") as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(n)]
        procs = [subprocess.Popen(
            argv, cwd=cwd, stdout=logs[r], stderr=subprocess.STDOUT,
            env=dict(base, JAX_COORDINATOR_ADDRESS=address,
                     JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(r)))
            for r in range(n)]
        deadline = time.monotonic() + timeout
        failed = ""
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.returncode not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                    break
                if time.monotonic() > deadline:
                    failed = f"the group outlived {timeout} s"
                    break
                time.sleep(0.05)
            bad = [r for r, p in enumerate(procs) if p.returncode not in
                   (None, 0)]
            if not failed and bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    if failed:
        tails = "\n".join(f"--- rank {r} (exit {p.returncode}):\n"
                          f"{out[-3000:]}"
                          for r, (p, out) in enumerate(zip(procs, outs)))
        raise RuntimeError(f"local group of {n}: {failed}\n{tails}")
    return outs
