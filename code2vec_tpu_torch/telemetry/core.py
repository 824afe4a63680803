"""Standalone instruments: counters, gauges and windowed timers (the
``Counter``, ``Gauge`` and ``Timer`` of ``code2vec_tpu/telemetry/
core.py``). The serving engine's ``stats()`` reads them.

Stdlib only and thread-safe: each instrument guards its state with one
lock. The process-global registry, its mirrors, tracing and the memory
ledger are not ported yet (ROADMAP A10).
"""
from __future__ import annotations

import collections
import threading
from typing import Deque, Dict

__all__ = ['Counter', 'Gauge', 'Timer']


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

    def snapshot(self) -> float:
        return self._value


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

    def record(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(seconds)
            self._count += 1
            self._total += seconds
            self._last = seconds

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
