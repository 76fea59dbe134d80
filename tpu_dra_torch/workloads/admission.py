"""Admission control for the serving data plane, copied from
``tpu_dra/workloads/admission.py`` (the port imports nothing of the JAX
package).

- **bounded cost**: each request carries a token cost (prompt tokens +
  max new tokens); the controller bounds total outstanding cost and
  sheds the excess with a typed :class:`ShedError` that the HTTP layer
  turns into an immediate 503 + ``Retry-After`` — never a silent queue.
- **tenant fair share**: per-tenant outstanding cost is capped at
  ``capacity / n_active_tenants``; a lone tenant may burst past its
  share up to ``burst_fraction`` of capacity, but the reserve above the
  burst line only admits tenants still under their fair share.
- **Retry-After from the live drain rate**: completions feed an
  exponentially-decayed cost-per-second estimate; a rejection's
  Retry-After is the time the backlog needs to drain at that rate
  (clamped to [1, ``retry_after_max_s``], rounded up).
- **graceful drain**: :meth:`AdmissionController.begin_drain` flips a
  terminal DRAINING state — admission closes (503 + Retry-After sized
  to the drain grace), readiness goes not-ready, and
  :meth:`AdmissionController.wait_idle` blocks until every admitted
  request has released its ticket.

The idle check costs one disarmed-failpoint flag read and a handful of
integer compares under one uncontended lock.  Admission sheds the newest
work, never admitted-and-decoding work; deadline expiry (``X-Deadline-Ms``,
propagated into the engine) is the one case where in-flight work is
aborted.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Optional

from tpu_dra_torch.resilience import failpoint

failpoint.register("serve.admission.stall",
                   "inside the admission check, decision not yet made — "
                   "stall to widen the shed/drain race windows")

# typed rejection reasons — label values of tpu_serve_shed_total and the
# "reason" field of the 503 body; the drive harnesses and the SLO tests
# assert on these exact strings
REASON_QUEUE_FULL = "queue_full"
REASON_TENANT_QUOTA = "tenant_quota"
REASON_DRAINING = "draining"
REASON_COST = "cost_too_large"
REASON_DEADLINE = "deadline_expired"

SHED_REASONS = (REASON_QUEUE_FULL, REASON_TENANT_QUOTA, REASON_DRAINING,
                REASON_COST, REASON_DEADLINE)


class ShedError(Exception):
    """Typed admission rejection → fast 503 with ``Retry-After``.

    Raised instead of queuing: the client gets an immediate, honest
    "come back in N seconds" while zero chip time has been spent."""

    def __init__(self, reason: str, retry_after_s: int,
                 detail: str = "") -> None:
        super().__init__(detail or reason)
        self.reason = reason
        self.retry_after_s = max(1, int(retry_after_s))


class DeadlineExceeded(Exception):
    """The request's client deadline expired before completion → 504.

    Distinct from :class:`ShedError`: the server did not refuse the
    work, the client stopped waiting for it — SLO attribution differs
    (tests/test_slo.py)."""


@dataclass
class Ticket:
    """One admitted request's claim on queue capacity; release exactly
    once (the controller tolerates double release for crash-path
    robustness, but the cost accounting assumes discipline)."""

    tenant: str
    cost: int
    admitted_at: float
    released: bool = False


class DrainRate:
    """Exponentially-decayed completions-per-second estimate in cost
    units — the live denominator of Retry-After.  Decay keeps the
    estimate honest across load changes without a sample ring."""

    def __init__(self, halflife_s: float = 10.0) -> None:
        self._halflife = halflife_s
        self._value = 0.0            # cost units per second
        self._at = time.monotonic()

    def observe(self, cost: float, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        dt = max(now - self._at, 1e-6)
        # fold the completed cost in as an instantaneous rate sample,
        # blended by the elapsed-time decay factor
        alpha = 1.0 - math.exp(-dt * math.log(2) / self._halflife)
        self._value = (1 - alpha) * self._value + alpha * (cost / dt)
        self._at = now

    def per_second(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        dt = max(now - self._at, 0.0)
        return self._value * math.exp(-dt * math.log(2) / self._halflife)


class AdmissionController:
    """Bounded, tenant-fair admission gate for the serving data plane.

    ``max_cost`` is the total outstanding token cost (prompt + max new
    tokens across every admitted-but-unfinished request) this process
    will carry; size it to a few multiples of what the engine can hold
    in flight so queuing delay stays bounded (docs/resilience.md).
    """

    STATE_RUNNING = "running"
    STATE_DRAINING = "draining"

    def __init__(self, max_cost: int, *,
                 burst_fraction: float = 0.7,
                 retry_after_max_s: int = 30,
                 drain_grace_s: float = 25.0,
                 rate_halflife_s: float = 10.0) -> None:
        if max_cost < 1:
            raise ValueError(f"max_cost must be >= 1, got {max_cost}")
        if not 0.0 < burst_fraction <= 1.0:
            raise ValueError(f"burst_fraction must be in (0, 1], got "
                             f"{burst_fraction}")
        self.max_cost = max_cost
        self.burst_fraction = burst_fraction
        self.retry_after_max_s = retry_after_max_s
        self.drain_grace_s = drain_grace_s
        self._mu = threading.Condition()
        self._outstanding = 0                 # guarded by _mu
        self._by_tenant: dict[str, int] = {}  # guarded by _mu
        self._draining = False                # guarded by _mu
        self._rate = DrainRate(rate_halflife_s)   # guarded by _mu
        self._shed: dict[str, int] = {r: 0 for r in SHED_REASONS}
        self.admitted_total = 0
        self.released_total = 0

    # -- the hot path -------------------------------------------------------

    def acquire(self, tenant: str, cost: int) -> Ticket:
        """Admit or shed.  Idle path: one disarmed-failpoint flag read,
        one uncontended lock, a few integer compares.  Raises :class:`ShedError` on rejection;
        on admission returns the ticket the caller MUST release."""
        failpoint.hit("serve.admission.stall")
        if cost < 1:
            cost = 1
        with self._mu:
            if self._draining:
                # size the retry to the drain grace: by then the
                # replacement instance is answering
                raise ShedError(
                    REASON_DRAINING,
                    min(self.retry_after_max_s,
                        max(1, int(math.ceil(self.drain_grace_s)))),
                    "server is draining for restart; retry against the "
                    "replacement instance")
            if cost > self.max_cost:
                # no amount of waiting makes this request admittable
                raise ShedError(
                    REASON_COST, 1,
                    f"request cost {cost} exceeds the admission "
                    f"capacity {self.max_cost}; shrink the prompt or "
                    f"max_new_tokens")
            total_after = self._outstanding + cost
            if total_after > self.max_cost:
                raise ShedError(
                    REASON_QUEUE_FULL, self._retry_after_locked(cost),
                    f"admission queue full ({self._outstanding}/"
                    f"{self.max_cost} cost outstanding)")
            mine = self._by_tenant.get(tenant, 0)
            n_active = len(self._by_tenant) + (0 if mine else 1)
            fair = self.max_cost / n_active
            cap = self.max_cost * self.burst_fraction
            # two quota rules (docs/resilience.md):
            # - hard accumulation cap: no tenant STACKS past the burst
            #   line, even alone — the remainder is the standing reserve
            #   a newcomer's first request always finds.  A tenant's
            #   FIRST outstanding request is exempt (a single big
            #   request within max_cost must not need multiple tenants'
            #   worth of quota);
            # - soft fair share: above max_cost/n_active, a tenant only
            #   admits while the total stays under the burst line.
            over_cap = mine > 0 and mine + cost > cap
            over_fair = mine + cost > fair and total_after > cap
            if over_cap or over_fair:
                raise ShedError(
                    REASON_TENANT_QUOTA, self._retry_after_locked(cost),
                    f"tenant {tenant!r} holds {mine} of {fair:.0f} "
                    f"fair-share cost and the burst headroom "
                    f"({cap:.0f}) is exhausted")
            self._outstanding = total_after
            self._by_tenant[tenant] = mine + cost
            self.admitted_total += 1
        return Ticket(tenant=tenant, cost=cost,
                      admitted_at=time.monotonic())

    def release(self, ticket: Ticket, *, completed: bool = True) -> None:
        """Return a ticket's cost to the pool; feeds the drain-rate
        estimate when the request actually completed (a shed or error
        drains nothing through the engine)."""
        with self._mu:
            if ticket.released:
                return
            ticket.released = True
            self._outstanding = max(0, self._outstanding - ticket.cost)
            left = self._by_tenant.get(ticket.tenant, 0) - ticket.cost
            if left > 0:
                self._by_tenant[ticket.tenant] = left
            else:
                self._by_tenant.pop(ticket.tenant, None)
            if completed:
                self._rate.observe(ticket.cost)
            self.released_total += 1
            self._mu.notify_all()

    def record_shed(self, reason: str) -> None:
        """Count a shed decision (the controller's own rejections call
        this via the HTTP layer so the counter and the 503 share one
        code path; deadline expiries observed elsewhere report here
        too)."""
        with self._mu:
            self._shed[reason] = self._shed.get(reason, 0) + 1

    def _retry_after_locked(self, cost: int) -> int:
        """Seconds until the backlog plausibly has room for ``cost``
        more units, from the live drain rate.  Cold start (no
        completions yet) answers 1s — optimistic but valid; the client's
        second attempt meets a warmer estimate."""
        rate = self._rate.per_second()
        if rate <= 0.0:
            return 1
        need = self._outstanding + cost - self.max_cost
        secs = int(math.ceil(max(need, cost) / rate))
        return max(1, min(self.retry_after_max_s, secs))

    # -- drain state machine ------------------------------------------------

    @property
    def draining(self) -> bool:
        with self._mu:
            return self._draining

    def begin_drain(self) -> None:
        """Terminal: admission closes with 503 + Retry-After, readiness
        goes not-ready (serve.py ANDs this into /healthz).  Idempotent."""
        with self._mu:
            self._draining = True
            self._mu.notify_all()

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted request has released its ticket
        (the zero-in-flight-losses half of graceful drain).  True when
        idle, False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._mu:
            while self._outstanding > 0:
                remaining = None if deadline is None else \
                    deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._mu.wait(0.05 if remaining is None
                              else min(0.05, remaining))
            return True

    # -- observability ------------------------------------------------------

    def snapshot(self) -> dict:
        """The /debug/overload payload's admission half: live outstanding
        cost (total and per tenant), drain state, shed counts, and the
        Retry-After a rejection issued right now would carry."""
        with self._mu:
            return {
                "state": (self.STATE_DRAINING if self._draining
                          else self.STATE_RUNNING),
                "max_cost": self.max_cost,
                "outstanding_cost": self._outstanding,
                "outstanding_by_tenant": dict(self._by_tenant),
                "burst_fraction": self.burst_fraction,
                "drain_rate_cost_per_s": round(
                    self._rate.per_second(), 3),
                "retry_after_s": self._retry_after_locked(1),
                "admitted_total": self.admitted_total,
                "released_total": self.released_total,
                "shed_total": dict(self._shed),
            }


def request_cost(rows, steps: int) -> int:
    """The admission cost of one /generate-shaped request: prompt tokens
    plus max new tokens across every row — the unit slot residency
    actually scales with.  Tolerant of malformed input (validation
    happens downstream; a garbage request should shed or 400, never
    crash the gate)."""
    try:
        prompt = sum(len(r) for r in rows)
        return max(1, int(prompt) + max(1, int(steps)) * len(rows))
    except TypeError:
        return 1


def parse_deadline_ms(raw: Optional[str]) -> Optional[float]:
    """``X-Deadline-Ms`` header → relative seconds budget, or None.
    Invalid values are ignored (an attacker-controlled header must
    never 500 the request or install a absurd deadline): non-numeric,
    non-positive, infinite, and NaN all read as "no deadline"."""
    if not raw:
        return None
    try:
        ms = float(raw)
    except ValueError:
        return None
    if not math.isfinite(ms) or ms <= 0:
        return None
    return ms / 1e3
