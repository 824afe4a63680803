"""The SLO burn-rate monitor of the serving mesh (the port of
``code2vec_tpu/serving/slo.py``).

The span log keeps anomalous traces, but tells nobody when the fleet
starts eating its error budget. This is the alarm, the multiwindow
burn-rate rule:

- **Two SLOs.** Availability (``SERVING_SLO_AVAILABILITY``, e.g. 0.99:
  a shed, expired or failed request burns the ``1 - target`` budget)
  and p99 latency (``SERVING_SLO_P99_MS``: a delivered request slower
  than the target burns a fixed 1% budget).
- **Fast and slow windows.** The burn rate over a window is
  ``bad_fraction / budget_fraction`` (1.0: spending the budget exactly
  as fast as the SLO allows). An alert needs both windows over
  ``SERVING_SLO_BURN_THRESHOLD``: the fast window detects, the slow one
  keeps a blip from paging.
- **The alarm leaves forensics.** A crossing counts ``slo/alerts_total``
  and dumps the tracer's flight recorder to ``flight_slo_burn.jsonl``.
  The alert re-arms only once the fast burn drops back under the
  threshold (latched: a sustained burn fires once).

The mesh feeds it submit-time sheds, pop-time expiries and per-request
completions; the monitor itself needs no mesh, so a test drives it
directly.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional

from code2vec_tpu_torch.telemetry import catalog
from code2vec_tpu_torch.telemetry import core as tele_core
from code2vec_tpu_torch.telemetry.core import Counter

#: latency SLOs are phrased as percentiles; p99 means 1% of requests
#: may exceed the bound — that 1% IS the latency error budget
P99_BUDGET = 0.01

#: a burn rate computed over fewer events than this is noise (one lone
#: failure at startup is a 100% bad fraction): windows below the floor
#: never alert
MIN_EVENTS = 20


#: window tallies are binned, not per-event: a 600s slow window at
#: 1k req/s would otherwise retain ~600k live tuples.  64 bins bound
#: the memory to ~65 entries per window at an eviction granularity of
#: span/64 — far finer than any sane burn threshold cares about.
_WINDOW_BINS = 64


class _Window:
    """One sliding event window with running tallies, binned by time
    bucket so memory is bounded by ``_WINDOW_BINS`` regardless of
    request rate.  Mutated only under the monitor's lock."""

    __slots__ = ('span_s', 'bin_s', 'bins', 'n', 'bad', 'slow')

    def __init__(self, span_s: float):
        self.span_s = float(span_s)
        self.bin_s = self.span_s / _WINDOW_BINS
        #: deque of [bin_start, n, bad, slow]
        self.bins: collections.deque = collections.deque()
        self.n = 0
        self.bad = 0
        self.slow = 0

    def add(self, now: float, bad: bool, slow: bool) -> None:
        start = (now // self.bin_s) * self.bin_s
        if self.bins and self.bins[-1][0] == start:
            tally = self.bins[-1]
            tally[1] += 1
            tally[2] += bad
            tally[3] += slow
        else:
            self.bins.append([start, 1, int(bad), int(slow)])
        self.n += 1
        self.bad += bad
        self.slow += slow
        self.evict(now)

    def evict(self, now: float) -> None:
        horizon = now - self.span_s
        bins = self.bins
        # a bin leaves once its whole span is past the horizon: the
        # window over-retains by at most one bin width (span/64)
        while bins and bins[0][0] + self.bin_s <= horizon:
            _start, n, bad, slow = bins.popleft()
            self.n -= n
            self.bad -= bad
            self.slow -= slow

    def burn(self, count: int, budget: float) -> float:
        if self.n == 0 or budget <= 0:
            return 0.0
        return (count / self.n) / budget


class SloMonitor:
    """Availability + p99-latency SLO burn tracking over fast/slow
    windows, with a latched flight-recorder alarm."""

    # the completion stream feeds from submitter threads, replica
    # pullers and decode workers concurrently, under _lock
    def __init__(self, availability: float = 0.0, p99_ms: float = 0.0,
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 600.0,
                 burn_threshold: float = 10.0,
                 min_events: int = MIN_EVENTS,
                 tracer=None, log=None):
        self.availability = float(availability)
        self.p99_s = float(p99_ms) / 1e3
        self.avail_budget = max(0.0, 1.0 - self.availability)
        self.burn_threshold = float(burn_threshold)
        self.min_events = max(1, int(min_events))
        self.tracer = tracer
        self.log = log if log is not None else (lambda msg: None)
        self._lock = threading.Lock()
        self._fast = _Window(fast_window_s)
        self._slow = _Window(slow_window_s)
        #: latched alert state per SLO key ('availability' / 'p99')
        self._alerting: Dict[str, bool] = {}
        #: scenario -> [good, bad, slow] lifetime tallies — the
        #: per-scenario error-budget burn attribution (scenario labels
        #: ride in from the mesh submit paths)
        self._scenarios: Dict[str, list] = {}
        self.good_total = Counter('slo/good_total')
        self.bad_total = Counter('slo/bad_total')
        self.slow_total = Counter('slo/slow_total')
        self.alerts_total = Counter('slo/alerts_total')

    @property
    def enabled(self) -> bool:
        return self.availability > 0 or self.p99_s > 0

    # ------------------------------------------------------- the stream
    def observe_good(self, latency_s: Optional[float] = None,
                     scenario: Optional[str] = None) -> None:
        """One delivered request (its latency decides the p99 leg).
        ``scenario`` attributes it to a workload."""
        slow = (self.p99_s > 0 and latency_s is not None
                and latency_s > self.p99_s)
        self.good_total.inc()
        if slow:
            self.slow_total.inc()
        if tele_core.enabled():
            reg = tele_core.registry()
            reg.counter('slo/good_total').inc()
            if slow:
                reg.counter('slo/slow_total').inc()
            if scenario:
                reg.counter(catalog.labeled(
                    'slo/good_total', 'scenario', scenario)).inc()
                if slow:
                    reg.counter(catalog.labeled(
                        'slo/slow_total', 'scenario', scenario)).inc()
        self._observe(bad=False, slow=slow, scenario=scenario)

    def observe_bad(self, reason: str = 'failed',
                    scenario: Optional[str] = None) -> None:
        """One request the caller did NOT get an answer for — shed,
        expired, or failed typed — against the availability budget."""
        del reason  # reasons live in the trace log; the budget is one
        self.bad_total.inc()
        if tele_core.enabled():
            tele_core.registry().counter('slo/bad_total').inc()
            if scenario:
                tele_core.registry().counter(catalog.labeled(
                    'slo/bad_total', 'scenario', scenario)).inc()
        self._observe(bad=True, slow=False, scenario=scenario)

    def _observe(self, bad: bool, slow: bool,
                 scenario: Optional[str] = None) -> None:
        now = time.monotonic()
        fired = []
        with self._lock:
            if scenario:
                tally = self._scenarios.setdefault(scenario, [0, 0, 0])
                tally[0] += not bad
                tally[1] += bad
                tally[2] += slow
            self._fast.add(now, bad, slow)
            self._slow.add(now, bad, slow)
            burns = self._burns_locked()
            for key in self._active_keys():
                fast_burn, slow_burn = burns[key]
                over = (self._fast.n >= self.min_events
                        and fast_burn > self.burn_threshold
                        and slow_burn > self.burn_threshold)
                if over and not self._alerting.get(key):
                    self._alerting[key] = True
                    fired.append((key, fast_burn, slow_burn))
                elif not over and fast_burn <= self.burn_threshold:
                    self._alerting[key] = False  # re-arm
        for key, fast_burn, slow_burn in fired:
            self._fire(key, fast_burn, slow_burn)
        self._export_burns(burns)

    def _export_burns(self, burns: Dict[str, tuple]) -> None:
        if not tele_core.enabled():
            return
        reg = tele_core.registry()
        if self.availability > 0:
            reg.gauge('slo/availability_burn_fast').set(
                burns['availability'][0])
            reg.gauge('slo/availability_burn_slow').set(
                burns['availability'][1])
        if self.p99_s > 0:
            reg.gauge('slo/p99_burn_fast').set(burns['p99'][0])
            reg.gauge('slo/p99_burn_slow').set(burns['p99'][1])

    def refresh(self) -> None:
        """Recompute (evicting) and re-export the burn gauges with NO
        new observation, so exported burns decay to zero after traffic
        stops instead of freezing at the last burst's value."""
        with self._lock:
            burns = self._burns_locked()
        self._export_burns(burns)

    def burns(self) -> Dict[str, tuple]:
        """Current ``(fast_burn, slow_burn)`` per ACTIVE SLO key.
        Evicts at read time, so a burn decays after traffic stops."""
        with self._lock:
            all_burns = self._burns_locked()
            return {key: all_burns[key] for key in self._active_keys()}

    def _active_keys(self):
        if self.availability > 0:
            yield 'availability'
        if self.p99_s > 0:
            yield 'p99'

    def _burns_locked(self) -> Dict[str, tuple]:
        # evict at READ time too: with traffic stopped, a stats() call
        # an hour after a burst must report the burn as over, not
        # replay the burst-time value forever
        now = time.monotonic()
        self._fast.evict(now)
        self._slow.evict(now)
        return {
            'availability': (
                self._fast.burn(self._fast.bad, self.avail_budget),
                self._slow.burn(self._slow.bad, self.avail_budget)),
            'p99': (
                self._fast.burn(self._fast.slow, P99_BUDGET),
                self._slow.burn(self._slow.slow, P99_BUDGET)),
        }

    def _fire(self, key: str, fast_burn: float,
              slow_burn: float) -> None:
        self.alerts_total.inc()
        if tele_core.enabled():
            tele_core.registry().counter('slo/alerts_total').inc()
        target = ('%.3f availability' % self.availability
                  if key == 'availability'
                  else 'p99 <= %.0fms' % (self.p99_s * 1e3))
        self.log('slo: %s BURN ALERT — burn rate %.1fx fast / %.1fx '
                 'slow (threshold %.1fx) against the %s SLO; flight '
                 'recorder dumping to flight_slo_burn.jsonl'
                 % (key, fast_burn, slow_burn, self.burn_threshold,
                    target))
        if self.tracer is not None:
            self.tracer.dump_flight('slo_burn')

    # ------------------------------------------------------------ report
    def stats(self) -> Dict[str, object]:
        with self._lock:
            burns = self._burns_locked()
            fast_n, slow_n = self._fast.n, self._slow.n
            alerting = dict(self._alerting)
            scenarios = {name: list(tally) for name, tally
                         in self._scenarios.items()}
        self._export_burns(burns)  # a stats poll refreshes the export
        total_bad = sum(tally[1] for tally in scenarios.values())
        total_slow = sum(tally[2] for tally in scenarios.values())
        scenario_out = {}
        for name, (good, bad, slow) in sorted(scenarios.items()):
            scenario_out[name] = {
                'good': good, 'bad': bad, 'slow': slow,
                # which workload is eating the budget: this scenario's
                # share of all scenario-attributed bad/slow events
                'availability_burn_share': (bad / total_bad
                                            if total_bad else 0.0),
                'p99_burn_share': (slow / total_slow
                                   if total_slow else 0.0),
            }
        out = {
            'availability_target': self.availability,
            'p99_target_ms': self.p99_s * 1e3,
            'burn_threshold': self.burn_threshold,
            'fast_window_events': fast_n,
            'slow_window_events': slow_n,
            'good_total': self.good_total.snapshot(),
            'bad_total': self.bad_total.snapshot(),
            'slow_total': self.slow_total.snapshot(),
            'alerts_total': self.alerts_total.snapshot(),
            # latched flags re-arm on the next OBSERVATION (a read
            # never mutates alert state); burns above are current
            'alerting': alerting,
            # per-scenario error-budget attribution — empty until a
            # caller labels its submits with a scenario
            'scenarios': scenario_out,
        }
        if self.availability > 0:
            out['availability_burn_fast'] = burns['availability'][0]
            out['availability_burn_slow'] = burns['availability'][1]
        if self.p99_s > 0:
            out['p99_burn_fast'] = burns['p99'][0]
            out['p99_burn_slow'] = burns['p99'][1]
        return out
