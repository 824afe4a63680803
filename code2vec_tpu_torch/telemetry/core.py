"""Telemetry core: counters, gauges, windowed timers and the
process-global registry (the port of ``code2vec_tpu/telemetry/core.py``).

- **Stdlib only**, importable from the data layer and the scripts
  without torch.
- **Thread-safe**: the input pipeline records from its prefetch thread
  while the training thread records step phases, and the serving engine
  from its dispatcher and decode workers. Each instrument guards its
  state with one lock; the registry guards get-or-create.
- **Near-zero cost when disabled**: call sites gate on ``enabled()`` (one
  module-global bool read); nothing here reads a clock until a site
  records.

Instruments are named from the port's catalog (``telemetry/catalog.py``).
The serving engine keeps standalone instruments for its ``stats()`` and
mirrors them into the registry when telemetry is on.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, Iterator, Optional, Tuple

__all__ = ['Counter', 'Gauge', 'Timer', 'MirrorTimer', 'Registry',
           'ScopedRegistry', 'registry', 'reset', 'enable', 'disable',
           'enabled']

# Module-global enablement: one bool read is the whole disabled-path
# cost of an instrumented call site.
_ENABLED = False


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


class Counter:
    """Monotonic counter."""

    __slots__ = ('name', '_value', '_lock')

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def snapshot(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins scalar (queue depth, fill rate, levels)."""

    __slots__ = ('name', '_value', '_lock')

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> float:
        return self._value


class _TimerContext:
    """``with timer.time():`` — a fresh object per entry keeps the timer
    re-entrant across threads."""

    __slots__ = ('_timer', '_t0')

    def __init__(self, timer: 'Timer'):
        self._timer = timer
        self._t0 = 0.0

    def __enter__(self) -> '_TimerContext':
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._timer.record(time.perf_counter() - self._t0)


class Timer:
    """Windowed duration statistics.

    Records durations in seconds; snapshots report milliseconds. Keeps a
    cumulative ``count`` and ``total`` plus a bounded window of recent
    samples; the mean, the percentiles and the max are over the window,
    so they track the current regime."""

    __slots__ = ('name', 'window', '_samples', '_count', '_total',
                 '_last', '_lock')

    def __init__(self, name: str = '', window: int = 512):
        self.name = name
        self.window = window
        self._samples: Deque[float] = collections.deque(maxlen=window)
        self._count = 0
        self._total = 0.0
        self._last = 0.0
        self._lock = threading.Lock()

    def time(self) -> _TimerContext:
        return _TimerContext(self)

    def record(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(seconds)
            self._count += 1
            self._total += seconds
            self._last = seconds

    @property
    def count(self) -> int:
        return self._count

    @property
    def total(self) -> float:
        """Cumulative seconds over all samples (not just the window)."""
        return self._total

    @property
    def last(self) -> float:
        return self._last

    def snapshot(self) -> Dict[str, float]:
        """{count, mean_ms, p50_ms, p95_ms, p99_ms, max_ms, last_ms,
        total_s}: the mean, percentiles (nearest rank) and max over the
        recent window, count and total cumulative. ``p99_ms`` is the
        port's addition to the reference's snapshot."""
        with self._lock:
            samples = sorted(self._samples)
            count, total = self._count, self._total
            last = self._last
        if not samples:
            return {'count': 0, 'mean_ms': 0.0, 'p50_ms': 0.0, 'p95_ms': 0.0,
                    'p99_ms': 0.0, 'max_ms': 0.0, 'last_ms': 0.0,
                    'total_s': 0.0}

        def pct(q: float) -> float:
            idx = min(len(samples) - 1, max(0, int(q * len(samples))))
            return samples[idx] * 1e3

        return {'count': count,
                'mean_ms': sum(samples) / len(samples) * 1e3,
                'p50_ms': pct(0.50), 'p95_ms': pct(0.95),
                'p99_ms': pct(0.99), 'max_ms': samples[-1] * 1e3,
                'last_ms': last * 1e3, 'total_s': total}


class MirrorTimer(Timer):
    """A Timer fed by a remote registry snapshot instead of local
    ``record`` calls: how a worker replica's timer statistics join the
    parent's fleet export (the serving mesh's telemetry backhaul).

    The worker ships its timer's stat dict on each heartbeat; ``adopt``
    stores it whole and ``snapshot`` replays it, so the exporters render
    the remote series as a local one (it is a ``Timer`` for their
    ``isinstance`` dispatch). The window is the worker's: the statistics
    were computed over its samples."""

    __slots__ = ('_stats',)

    def __init__(self, name: str = '', window: int = 512):
        super().__init__(name, window=window)
        self._stats: Optional[Dict[str, float]] = None

    def adopt(self, stats: Dict[str, float]) -> None:
        with self._lock:
            self._stats = dict(stats)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            stats = self._stats
        if stats is None:
            return super().snapshot()
        return dict(stats)


class Registry:
    """Thread-safe name -> instrument map with get-or-create accessors.
    One process-global instance (``registry()``): the input pipeline,
    the trainer, the engine and the exporters see the same instruments
    without a handle threaded through every layer."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get_or_create(self, name: str, cls, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, **kwargs)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    'metric %r is already registered as %s, not %s'
                    % (name, type(inst).__name__, cls.__name__))
            return inst

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def timer(self, name: str, window: int = 512) -> Timer:
        return self._get_or_create(name, Timer, window=window)

    def mirror_timer(self, name: str) -> MirrorTimer:
        """Get-or-create a remote-fed timer (the fleet merge only: the
        name carries a replica label, so it never collides with a timer
        recorded here)."""
        return self._get_or_create(name, MirrorTimer)

    def items(self) -> Iterator[Tuple[str, object]]:
        with self._lock:
            return iter(sorted(self._instruments.items()))

    def get(self, name: str) -> Optional[object]:
        with self._lock:
            return self._instruments.get(name)

    def snapshot(self) -> Dict[str, object]:
        """{name: scalar | timer-stat dict} for every instrument, in name
        order — the exporters' input."""
        return {name: inst.snapshot() for name, inst in self.items()}

    def reset(self) -> None:
        """Drop every instrument (test isolation)."""
        with self._lock:
            self._instruments.clear()


class ScopedRegistry:
    """Registry view that stamps every name with an instance label:
    ``counter('serving/shed_total')`` on ``ScopedRegistry(reg, 'replica',
    'r1')`` creates ``serving/shed_total{replica=r1}``, so coexisting
    engines mirror into the one registry without double-counting."""

    __slots__ = ('_registry', '_suffix')

    def __init__(self, registry: 'Registry', key: str, value: str):
        from code2vec_tpu_torch.telemetry import catalog
        self._registry = registry
        self._suffix = catalog.label_suffix(key, value)

    def counter(self, name: str) -> Counter:
        return self._registry.counter(name + self._suffix)

    def gauge(self, name: str) -> Gauge:
        return self._registry.gauge(name + self._suffix)

    def timer(self, name: str, window: int = 512) -> Timer:
        return self._registry.timer(name + self._suffix, window=window)


_REGISTRY = Registry()


def registry() -> Registry:
    """The process-global registry."""
    return _REGISTRY


def reset() -> None:
    """Clear the process-global registry (between tests)."""
    _REGISTRY.reset()
