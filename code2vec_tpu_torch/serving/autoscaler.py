"""The serving mesh's autoscaler (the port of
``code2vec_tpu/serving/autoscaler.py``): the control loop that sizes the
fleet against its backlog and its SLO budget.

**Signals.** Two scale-up triggers, read every
``AUTOSCALE_INTERVAL_SECS``:

- the front queue's drain estimate (``FrontQueue.drain_seconds``: queued
  rows over the fleet's served rows/s) above ``AUTOSCALE_UP_QUEUE_SECS``;
  a stalled fleet with a backlog (rate 0) reads as an infinite drain;
- the SLO monitor's burn (``serving/slo.py``; ``AUTOSCALE_UP_BURN`` > 0
  arms this leg): both burn windows of any SLO above the threshold.

Scale-down is timid: the fleet must look over-provisioned for
``AUTOSCALE_DOWN_IDLE_SECS`` without a break (the drain estimate with
one fewer replica under ``AUTOSCALE_DOWN_UTILIZATION x
AUTOSCALE_UP_QUEUE_SECS``, no SLO burning, no fast burn above 1) before
one replica drains out.

**Actions.** A scale-up is ``mesh.add_replica()`` (a thread replica: a
new engine with its own ladder, warmed; a worker: spawned, cold-started,
on the fleet's step), or, with a ``spawn`` hook, a request to an
orchestrator for capacity, which arrives later as an adoption dial-in. A
scale-down is ``mesh.retire(rid, reason='autoscale')``: a drain, never a
kill, so no admitted request is lost. The victim is the newest replica
that is not adopted (its orchestrator owns it), canarying, dead or
retired.

**Guard rails.** ``AUTOSCALE_MIN_REPLICAS`` and ``AUTOSCALE_MAX_REPLICAS``
bound the fleet; a cooldown per direction keeps one signal from
storming; the flap guard freezes all scaling for
``AUTOSCALE_FLAP_WINDOW_SECS`` once ``AUTOSCALE_FLAP_LIMIT`` direction
reversals fall inside that window. Every transition is traced
(``autoscale.transition``), counted (``autoscale/*``) and logged with
its signals.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional

from code2vec_tpu_torch.telemetry import core as tele_core
from code2vec_tpu_torch.telemetry.core import Counter, Gauge


class Autoscaler:
    """One ticker thread reading the queue's drain estimate and the SLO
    burns and deciding up, down or hold under the bounds, the cooldowns
    and the flap guard. ``ServingMesh`` builds and owns it when
    ``AUTOSCALE_MAX_REPLICAS > 0``; ``tick()`` is public, so a drill can
    step the loop without waiting out the interval.

    It reads the mesh's replica table under the mesh's ``_lock`` and
    calls only ``add_replica`` and ``retire``, which take the mesh's
    locks themselves."""

    # the ticker mutates the fields below while stats() and close() read
    # them from other threads: all under _lock
    # graftlint: guard Autoscaler._transitions,_last_up,_last_down by _lock
    # graftlint: guard Autoscaler._idle_since,_frozen_until by _lock
    # graftlint: guard Autoscaler._last_decision,_closed by _lock
    def __init__(self, mesh, config, spawn=None, tracer=None, log=None):
        self.mesh = mesh
        self.min_replicas = max(1, int(config.AUTOSCALE_MIN_REPLICAS))
        self.max_replicas = int(config.AUTOSCALE_MAX_REPLICAS)
        self.interval_s = float(config.AUTOSCALE_INTERVAL_SECS)
        self.up_queue_s = float(config.AUTOSCALE_UP_QUEUE_SECS)
        self.up_burn = float(config.AUTOSCALE_UP_BURN)
        self.down_idle_s = float(config.AUTOSCALE_DOWN_IDLE_SECS)
        self.down_utilization = float(config.AUTOSCALE_DOWN_UTILIZATION)
        self.up_cooldown_s = float(config.AUTOSCALE_UP_COOLDOWN_SECS)
        self.down_cooldown_s = float(config.AUTOSCALE_DOWN_COOLDOWN_SECS)
        self.flap_window_s = float(config.AUTOSCALE_FLAP_WINDOW_SECS)
        self.flap_limit = max(1, int(config.AUTOSCALE_FLAP_LIMIT))
        #: the orchestrator hook: a scale-up asks it for a worker instead
        #: of spawning one here (the worker dials in to be adopted)
        self.spawn = spawn
        self.tracer = tracer
        self.log = log if log is not None else (lambda msg: None)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        #: (t_mono, direction) of the recent transitions: the flap
        #: guard's reversal window
        self._transitions: collections.deque = collections.deque()
        self._last_up = -float('inf')
        self._last_down = -float('inf')
        #: when the fleet began to look over-provisioned (None: it does
        #: not now)
        self._idle_since: Optional[float] = None
        self._frozen_until = 0.0
        self._last_decision = 'hold'
        self.scale_up_total = Counter('autoscale/scale_up_total')
        self.scale_down_total = Counter('autoscale/scale_down_total')
        self.scale_up_failed_total = Counter(
            'autoscale/scale_up_failed_total')
        self.flap_freezes_total = Counter('autoscale/flap_freezes_total')
        self.target_gauge = Gauge('autoscale/replicas_target')

    # ------------------------------------------------------- lifecycle
    def start(self) -> 'Autoscaler':
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name='mesh-autoscale')
            self._thread.start()
        return self

    def close(self) -> None:
        with self._lock:
            self._closed = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=180.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as exc:   # the loop survives a failed tick
                self.log('autoscale: tick failed: %r' % exc)

    # -------------------------------------------------------- signals
    def _fleet_size(self) -> int:
        """Serving replicas (neither retired nor dead), what a decision
        is sized against."""
        mesh = self.mesh
        with mesh._lock:
            return sum(1 for s in mesh._replicas
                       if not s.retired and not s.dead)

    def _burning(self) -> bool:
        """Any SLO burning above the scale-up threshold on both of its
        windows (a blip never scales)."""
        slo = self.mesh._slo
        if slo is None or self.up_burn <= 0:
            return False
        return any(fast > self.up_burn and slow > self.up_burn
                   for fast, slow in slo.burns().values())

    def _over_budget(self) -> bool:
        """Any SLO burning its budget faster than allowed (fast burn
        above 1): a scale-down is vetoed meanwhile."""
        slo = self.mesh._slo
        if slo is None:
            return False
        return any(fast > 1.0 for fast, _slow in slo.burns().values())

    # ------------------------------------------------------- decision
    def tick(self) -> str:
        """One evaluation of the loop; returns its decision, 'up',
        'down', 'hold' or 'frozen'. A scale-up blocks until the new
        replica is seated (or its spawn hook returned)."""
        now = time.monotonic()
        with self._lock:
            if self._closed:
                return 'hold'
            frozen = now < self._frozen_until
        if frozen:
            self._note_decision('frozen')
            return 'frozen'
        n = self._fleet_size()
        drain_s, rows, rate = self.mesh._queue.drain_seconds()
        burning = self._burning()
        if n < self.min_replicas or \
                ((drain_s > self.up_queue_s or burning)
                 and n < self.max_replicas):
            with self._lock:
                in_cooldown = now - self._last_up < self.up_cooldown_s
            if not in_cooldown:
                self._scale_up(n, drain_s, rows, rate, burning, now)
                return 'up'
            self._note_decision('hold')
            return 'hold'
        # the scale-down leg: sustained low pressure only
        down_ok = False
        if n > self.min_replicas and not burning \
                and not self._over_budget():
            # the drain with one fewer replica: each serves rate / n
            if rows <= 0:
                projected = 0.0
            elif rate <= 0:
                projected = float('inf')
            else:
                projected = rows / (rate * (n - 1) / n)
            down_ok = projected < self.down_utilization * self.up_queue_s
        with self._lock:
            if not down_ok:
                self._idle_since = None
                self._last_decision = 'hold'
                return 'hold'
            if self._idle_since is None:
                self._idle_since = now
            sustained = now - self._idle_since >= self.down_idle_s
            in_cooldown = now - self._last_down < self.down_cooldown_s
        if sustained and not in_cooldown:
            if self._scale_down(n, drain_s, rows, rate, now):
                return 'down'
        self._note_decision('hold')
        return 'hold'

    def _note_decision(self, decision: str) -> None:
        with self._lock:
            self._last_decision = decision

    def _note_transition(self, direction: str, now: float) -> bool:
        """Record a transition; False (and a freeze) when the reversals
        inside the flap window reach the limit."""
        with self._lock:
            horizon = now - self.flap_window_s
            while self._transitions and self._transitions[0][0] < horizon:
                self._transitions.popleft()
            reversals = sum(
                1 for (_, a), (_, b) in zip(self._transitions,
                                            list(self._transitions)[1:])
                if a != b)
            if self._transitions and self._transitions[-1][1] != direction:
                reversals += 1
            if reversals < self.flap_limit:
                self._transitions.append((now, direction))
                return True
            self._frozen_until = now + self.flap_window_s
            self._last_decision = 'frozen'
        self.flap_freezes_total.inc()
        if tele_core.enabled():
            tele_core.registry().counter(
                'autoscale/flap_freezes_total').inc()
        self.log('autoscale: flap guard: %d direction reversals inside '
                 '%.0f s (limit %d); all scaling frozen for %.0f s'
                 % (self.flap_limit, self.flap_window_s, self.flap_limit,
                    self.flap_window_s))
        return False

    # -------------------------------------------------------- actions
    def _trace(self, direction: str, attrs: Dict[str, object]):
        if self.tracer is None:
            return None
        attrs = dict(attrs)
        attrs['direction'] = direction
        return self.tracer.begin('autoscale.transition', attrs=attrs)

    def _set_target(self, target: int) -> None:
        self.target_gauge.set(target)
        if tele_core.enabled():
            tele_core.registry().gauge('autoscale/replicas_target').set(
                target)

    def _scale_up(self, n: int, drain_s: float, rows: int, rate: float,
                  burning: bool, now: float) -> None:
        if not self._note_transition('up', now):
            return
        with self._lock:
            self._last_up = now
            self._idle_since = None
            self._last_decision = 'up'
        reason = ('slo_burn' if burning and drain_s <= self.up_queue_s
                  else 'queue_drain' if not burning
                  else 'queue_drain+slo_burn')
        self._set_target(n + 1)
        trace = self._trace('up', {
            'from': n, 'to': n + 1, 'reason': reason,
            'drain_s': None if drain_s == float('inf') else drain_s,
            'queue_rows': rows, 'fleet_rows_per_s': rate})
        self.log('autoscale: scaling up %d -> %d (%s: drain %.1f s against '
                 '%.1f s, %d rows queued, fleet %.0f rows/s%s)'
                 % (n, n + 1, reason,
                    drain_s if drain_s != float('inf') else -1.0,
                    self.up_queue_s, rows, rate,
                    ', an SLO burning' if burning else ''))
        try:
            if self.spawn is not None:
                # capacity the orchestrator owns: it dials in later
                self.spawn(self.mesh)
            else:
                self.mesh.add_replica()
        except Exception as exc:
            self.scale_up_failed_total.inc()
            if tele_core.enabled():
                tele_core.registry().counter(
                    'autoscale/scale_up_failed_total').inc()
            self.log('autoscale: scale-up failed (%r); the cooldown applies '
                     'before the next attempt' % exc)
            if trace is not None:
                trace.finish(status='error', reason=repr(exc))
            return
        self.scale_up_total.inc()
        if tele_core.enabled():
            tele_core.registry().counter('autoscale/scale_up_total').inc()
        if trace is not None:
            trace.finish(status='ok')

    def _pick_victim(self) -> Optional[str]:
        """The newest eligible replica drains first (the longest-warm
        ladders keep serving); never an adopted worker (its orchestrator
        owns it), the canary (a rollover must conclude) or a dead slot
        (the supervisor owns it)."""
        mesh = self.mesh
        with mesh._lock:
            for slot in reversed(mesh._replicas):
                if slot.retired or slot.dead or slot.canarying \
                        or slot.adopted:
                    continue
                return slot.rid
        return None

    def _scale_down(self, n: int, drain_s: float, rows: int, rate: float,
                    now: float) -> bool:
        victim = self._pick_victim()
        if victim is None:
            self._note_decision('hold')
            return False
        if not self._note_transition('down', now):
            return False
        with self._lock:
            self._last_down = now
            self._idle_since = None
            self._last_decision = 'down'
        self._set_target(n - 1)
        trace = self._trace('down', {
            'from': n, 'to': n - 1, 'replica': victim,
            'drain_s': None if drain_s == float('inf') else drain_s,
            'queue_rows': rows, 'fleet_rows_per_s': rate})
        self.log('autoscale: scaling down %d -> %d, draining replica %s '
                 '(drain %.2f s, %d rows queued, fleet %.0f rows/s; under '
                 'the utilization floor for %.0f s)'
                 % (n, n - 1, victim,
                    drain_s if drain_s != float('inf') else -1.0,
                    rows, rate, self.down_idle_s))
        try:
            # a drain: in-flight batches deliver and the queue goes to the
            # siblings before the replica closes
            self.mesh.retire(victim, reason='autoscale')
        except Exception as exc:
            self.log('autoscale: scale-down of %s failed (%r)'
                     % (victim, exc))
            if trace is not None:
                trace.finish(status='error', reason=repr(exc))
            return False
        self.scale_down_total.inc()
        if tele_core.enabled():
            tele_core.registry().counter('autoscale/scale_down_total').inc()
        if trace is not None:
            trace.finish(status='ok')
        return True

    # --------------------------------------------------------- report
    def stats(self) -> Dict[str, object]:
        with self._lock:
            frozen_for = max(0.0, self._frozen_until - time.monotonic())
            decision = self._last_decision
            transitions = len(self._transitions)
        return {
            'min_replicas': self.min_replicas,
            'max_replicas': self.max_replicas,
            'scale_up_total': self.scale_up_total.snapshot(),
            'scale_down_total': self.scale_down_total.snapshot(),
            'scale_up_failed_total': self.scale_up_failed_total.snapshot(),
            'flap_freezes_total': self.flap_freezes_total.snapshot(),
            'replicas_target': self.target_gauge.snapshot(),
            'last_decision': decision,
            'recent_transitions': transitions,
            'frozen_for_s': frozen_for,
        }
