"""The serving mesh's one shared front queue (the port of
``code2vec_tpu/serving/frontqueue.py``).

A mesh of N engine replicas must not queue per replica: a queue behind a
slow or broken replica strands work while its siblings idle. This is the
one admission surface every replica pulls from:

- **Fleet-wide admission.** The queue bound and the drain estimate move
  up from the engine: the drain rate is the fleet's service rate (the
  mesh's sliding window over every replica's completions), so a
  deadline is shed only when the whole fleet cannot meet it. Sheds and
  expiries are typed as the engine's (``EngineOverloaded`` /
  ``DeadlineExceeded``) and counted by reason (``mesh/shed_bound_total``
  / ``mesh/shed_deadline_total``).
- **Shared degradation ladder.** The engine's hysteresis ladder
  (``serving/engine.py::overload_tier``) driven by the shared queue's
  fill, so under fleet-wide overload every replica serves the downgraded
  tier.
- **Coalescing pop with continuous insert.** ``pop_coalesced`` is a
  replica puller's claim: it picks the tier whose head request has
  waited longest, then keeps folding newly arriving requests of that
  tier into the gathering micro-batch until the coalescing deadline
  passes or the bucket fills. Pullers pop under one lock, so a request
  is dispatched once, by whichever free replica claims it.
- **Claim tokens.** A request redispatched after its worker died
  excludes the incarnation that crashed with it (``_Request.exclude``),
  so that incarnation's puller, whose death may not be noticed yet,
  never claims it again.

Thread-safe; nothing here touches the card.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.serving.engine import (_Request, bound_rejects,
                                               overload_tier)
from code2vec_tpu_torch.serving.errors import EngineClosed, EngineOverloaded
from code2vec_tpu_torch.serving.steps import PREDICT_TIERS
from code2vec_tpu_torch.telemetry import core as tele_core
from code2vec_tpu_torch.telemetry.core import Counter, Gauge

#: an idle puller's wait quantum: what it waits on (a breaker's cooldown,
#: a retirement) can change without a queue notification
_IDLE_WAIT_S = 0.05


class FrontQueue:
    """Bounded, admission-controlled request queue shared by the replicas
    of one ``ServingMesh``. Submitters admit and enqueue; replica pullers
    ``pop_coalesced``; the mesh owns close and abandon."""

    # submitters, the pullers and close() share the state below under
    # _lock (_cond wraps it)
    # graftlint: guard FrontQueue._queues,_pending_rows by _lock|_cond
    # graftlint: guard FrontQueue._reserved_rows,_closed,_drain by _lock|_cond
    # graftlint: guard FrontQueue._overload_level,_peak_rows by _lock|_cond
    def __init__(self, tiers: Tuple[str, ...], bound: Optional[int],
                 fleet_rate: Callable[[], float], log=None):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues: Dict[str, collections.deque] = {
            tier: collections.deque() for tier in PREDICT_TIERS}
        self._pending_rows: Dict[str, int] = {t: 0 for t in PREDICT_TIERS}
        self._reserved_rows = 0
        self._closed = False
        self._drain = False
        self._overload_level = 0
        self._peak_rows = 0
        #: admission bound in queued rows across the tiers; None: none
        self.queue_bound = bound
        #: the warmed tiers: the ladder never downgrades onto a cold one
        self.tiers = tiers
        #: the fleet's service rate in rows/s, the drain estimate's divisor
        self._fleet_rate = fleet_rate
        self.log = log if log is not None else (lambda msg: None)
        # standalone instruments (mesh.stats() reads them), mirrored into
        # the process-global registry when telemetry is on
        self.queue_depth = Gauge('mesh/queue_depth')
        self.queue_rows = Gauge('mesh/queue_rows')
        self.shed_total = Counter('mesh/shed_total')
        self.shed_bound_total = Counter('mesh/shed_bound_total')
        self.shed_deadline_total = Counter('mesh/shed_deadline_total')
        self.expired_total = Counter('mesh/expired_total')
        self.degraded_total = Counter('mesh/degraded_total')

    # ------------------------------------------------------- admission
    def _admitted_rows_locked(self) -> int:
        return sum(self._pending_rows.values()) + self._reserved_rows

    def _shed_locked(self, rows: int, why: str, reason: str) -> None:
        self.shed_total.inc()
        by_reason = {'bound': self.shed_bound_total,
                     'deadline': self.shed_deadline_total}.get(reason)
        if by_reason is not None:
            by_reason.inc()
        if tele_core.enabled():
            reg = tele_core.registry()
            reg.counter('mesh/shed_total').inc()
            if reason == 'bound':
                reg.counter('mesh/shed_bound_total').inc()
            elif reason == 'deadline':
                reg.counter('mesh/shed_deadline_total').inc()
        raise EngineOverloaded(
            'request shed at mesh admission (%s): %d rows, %d rows '
            'queued fleet-wide, bound %s — back off and retry'
            % (why, rows, self._admitted_rows_locked(), self.queue_bound))

    def admit(self, rows: int, tier: str,
              deadline_s: Optional[float]) -> str:
        """Fleet-wide admission of one submission: the shared bound, the
        fleet's drain estimate against the deadline, the shared ladder.
        Reserves ``rows`` against the bound (released at ``enqueue`` or
        ``release_reservation``) and returns the tier to serve."""
        with self._cond:
            if self._closed:
                raise EngineClosed('ServingMesh is closed')
            if faults.maybe_fire('reject_all'):
                self._shed_locked(rows, 'reject_all drill', 'drill')
            admitted = self._admitted_rows_locked()
            bound = self.queue_bound
            if bound_rejects(admitted, rows, bound):
                self._shed_locked(rows, 'queue bound', 'bound')
            if deadline_s is not None:
                rate = self._fleet_rate()
                if rate > 0 and (admitted + rows) / rate > deadline_s:
                    self._shed_locked(
                        rows,
                        'fleet drain estimate %.0fms > deadline %.0fms'
                        % (1e3 * (admitted + rows) / rate,
                           1e3 * deadline_s), 'deadline')
            self._overload_level, effective = overload_tier(
                admitted, rows, bound, self._overload_level, tier,
                self.tiers)
            if effective != tier:
                self.degraded_total.inc()
                if tele_core.enabled():
                    tele_core.registry().counter(
                        'mesh/degraded_total').inc()
            self._reserved_rows += rows
            self._peak_rows = max(self._peak_rows,
                                  self._admitted_rows_locked())
        return effective

    def release_reservation(self, rows: int) -> None:
        """Back out an admission whose tokenize failed before enqueue."""
        with self._cond:
            self._reserved_rows -= rows

    def enqueue(self, tier: str, requests: List[_Request],
                rows: int) -> None:
        """Move ``rows`` admitted rows from reservation into the queue.
        Raises ``EngineClosed`` (reservation released, nothing queued)
        when the mesh closed between admission and enqueue."""
        with self._cond:
            self._reserved_rows -= rows
            if self._closed:
                raise EngineClosed('ServingMesh is closed')
            for request in requests:
                self._queues[tier].append(request)
                self._pending_rows[tier] += request.rows
            self._set_depth_locked()
            self._cond.notify_all()

    # ------------------------------------------------------------- pop
    def _set_depth_locked(self) -> None:
        depth = sum(len(q) for q in self._queues.values())
        rows = sum(self._pending_rows.values())
        self.queue_depth.set(depth)
        self.queue_rows.set(rows)
        if tele_core.enabled():
            reg = tele_core.registry()
            reg.gauge('mesh/queue_depth').set(depth)
            reg.gauge('mesh/queue_rows').set(rows)

    def pop_coalesced(self, max_rows: int, max_delay_s: float,
                      alive: Callable[[], bool], claim=None
                      ) -> Optional[Tuple[str, List[_Request], int,
                                          List[_Request]]]:
        """One replica puller's claim on the shared queue.

        Blocks until work exists, picks the tier whose head request has
        waited longest, then holds the gathering micro-batch open
        (folding in newly arriving requests of that tier) until the
        coalescing deadline passes or ``max_rows`` fill. Returns ``(tier,
        taken, rows, expired)``; ``expired`` are requests past their
        deadline, for the caller to fail typed. Returns None when the
        queue is closed (and drained, on a draining close) or when
        ``alive()`` turns false: a breaker-open or retired replica leaves
        without taking work, so the queue never wedges on it.

        ``claim`` names the puller's replica incarnation: a request whose
        ``exclude`` is that incarnation (it crashed with it once) is
        skipped and keeps its place at the front, for a sibling or the
        supervised restart, a new incarnation."""
        with self._cond:
            while True:
                if not alive():
                    return None
                if self._closed and (not self._drain
                                     or not self._any_queued_locked()):
                    return None
                if self._any_queued_locked():
                    break
                self._cond.wait(_IDLE_WAIT_S)
            tier = min((t for t in PREDICT_TIERS if self._queues[t]),
                       key=lambda t: self._queues[t][0].t_enqueue)
            deadline = self._queues[tier][0].t_enqueue + max_delay_s
            while not self._closed:
                if not alive():
                    return None
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or self._pending_rows[tier] >= max_rows:
                    break
                self._cond.wait(min(remaining, _IDLE_WAIT_S))
            if self._closed and not self._drain:
                return None
            taken: List[_Request] = []
            expired: List[_Request] = []
            skipped: List[_Request] = []
            rows = 0
            now = time.perf_counter()
            queue = self._queues[tier]
            while queue and rows + queue[0].rows <= max_rows:
                request = queue.popleft()
                if request.t_deadline is not None \
                        and now >= request.t_deadline:
                    expired.append(request)
                    self._pending_rows[tier] -= request.rows
                    continue
                if claim is not None and request.exclude is claim:
                    skipped.append(request)
                    continue
                taken.append(request)
                rows += request.rows
            if skipped:
                # excluded members keep their place at the front
                queue.extendleft(reversed(skipped))
            self._pending_rows[tier] -= rows
            self._set_depth_locked()
        for _request in expired:
            self.expired_total.inc()
            if tele_core.enabled():
                tele_core.registry().counter('mesh/expired_total').inc()
        return tier, taken, rows, expired

    def _any_queued_locked(self) -> bool:
        return any(self._queues[t] for t in PREDICT_TIERS)

    def requeue_front(self, tier: str, requests: List[_Request]) -> bool:
        """Crash-safe redispatch: put the members of a batch that died
        with its worker back at the front of their tier's queue, in their
        order and with their deadlines (an expired one still sheds typed
        at the next pop); no admission check runs, the rows were admitted
        before. The mesh allows it once a request
        (``_Request.redispatched``). Returns False on a fail-fast-closed queue: the
        caller fails them typed instead."""
        with self._cond:
            if self._closed and not self._drain:
                return False
            self._queues[tier].extendleft(reversed(requests))
            for request in requests:
                self._pending_rows[tier] += request.rows
            self._set_depth_locked()
            self._cond.notify_all()
        return True

    # ------------------------------------------------------- lifecycle
    def kick(self) -> None:
        """Wake every waiting puller (a replica's state changed: breaker,
        retirement, rollover)."""
        with self._cond:
            self._cond.notify_all()

    def depth_rows(self) -> int:
        with self._lock:
            return sum(self._pending_rows.values())

    def drain_seconds(self) -> Tuple[float, int, float]:
        """Seconds to drain everything admitted (queued and reserved
        rows) at the fleet's current service rate: ``(drain_s, rows,
        rate)``; a zero rate with rows admitted reads ``inf``."""
        with self._lock:
            rows = sum(self._pending_rows.values()) + self._reserved_rows
        rate = self._fleet_rate()
        if rows <= 0:
            return 0.0, 0, rate
        if rate <= 0:
            return float('inf'), rows, rate
        return rows / rate, rows, rate

    def peak_rows(self) -> int:
        with self._lock:
            return self._peak_rows

    def overload_level(self) -> int:
        with self._lock:
            return self._overload_level

    def close(self, drain: bool = False) -> None:
        with self._cond:
            if not self._closed:
                self._closed = True
                self._drain = drain
            self._cond.notify_all()

    def abandon(self) -> List[_Request]:
        """Take every still-queued request out, for the caller to fail
        typed (the fail-fast close; ``close(drain=True)`` lets the
        pullers serve the queue down instead)."""
        abandoned: List[_Request] = []
        with self._cond:
            for tier in PREDICT_TIERS:
                abandoned.extend(self._queues[tier])
                self._queues[tier].clear()
                self._pending_rows[tier] = 0
            self._set_depth_locked()
            self._cond.notify_all()
        return abandoned

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                'queue_depth': self.queue_depth.snapshot(),
                'queue_rows': sum(self._pending_rows.values()),
                'queue_peak_rows': self._peak_rows,
                'queue_bound': self.queue_bound,
                'overload_level': self._overload_level,
                'shed_total': self.shed_total.snapshot(),
                'shed_bound_total': self.shed_bound_total.snapshot(),
                'shed_deadline_total': self.shed_deadline_total.snapshot(),
                'expired_total': self.expired_total.snapshot(),
                'degraded_total': self.degraded_total.snapshot(),
            }
