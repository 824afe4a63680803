"""Telemetry exporters: JSONL sink, rate-limited console line and
Prometheus textfile, in the formats of ``code2vec_tpu/telemetry/
exporters.py``.

All three consume the registry: one walk of the instruments per flush,
not per record. The trainer flushes every TELEMETRY_FLUSH_EVERY_STEPS
steps, so the hot loop never touches a file.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

from code2vec_tpu_torch.telemetry import catalog
from code2vec_tpu_torch.telemetry.core import Counter, Gauge, Registry, Timer


class JsonlExporter:
    """Append registry snapshots to ``<dir>/metrics.jsonl`` in the
    ``{tag, value, step, time}`` schema of ``MetricsWriter`` (timers add
    their stat fields), so one plotting script reads both streams. The
    file is opened per flush, in append mode, under a lock: the trainer
    and an engine may flush one exporter concurrently."""

    def __init__(self, logdir: str, filename: str = 'metrics.jsonl'):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._lock = threading.Lock()
        self.path = os.path.join(logdir, filename)

    def flush(self, registry: Registry, step: int) -> None:
        now = time.time()
        lines = []
        for name, inst in registry.items():
            record = {'tag': name, 'step': int(step), 'time': now}
            if isinstance(inst, Timer):
                stats = inst.snapshot()
                if not stats['count']:
                    continue
                record['value'] = stats['mean_ms']
                record.update(stats)
            else:
                record['value'] = inst.snapshot()
            lines.append(json.dumps(record))
        if not lines:
            return
        payload = '\n'.join(lines) + '\n'
        with self._lock:
            with open(self.path, 'a') as f:
                f.write(payload)


class PrometheusExporter:
    """Textfile export for scraping: the current state, rewritten
    atomically each flush. Samples are grouped per metric family under
    one HELP/TYPE header (labeled series of one family stay contiguous);
    a timer is per-stat gauge families plus a ``_count`` counter."""

    def __init__(self, logdir: str, filename: str = 'metrics.prom'):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, filename)

    def flush(self, registry: Registry, step: int) -> None:
        families: Dict[str, dict] = {}

        def fam(prom: str, mtype: Optional[str],
                help_text: Optional[str] = None) -> list:
            entry = families.get(prom)
            if entry is None:
                entry = families[prom] = {'type': mtype,
                                          'help': help_text,
                                          'samples': []}
            return entry['samples']

        for name, inst in registry.items():
            base, label = catalog.split_label(name)
            prom = catalog.prometheus_name(base)
            labels = '' if label is None else '{%s="%s"}' % label
            meta = catalog.CATALOG.get(base)
            help_text = meta['help'] if meta is not None else None
            if isinstance(inst, Counter):
                fam(prom, 'counter', help_text).append(
                    '%s%s %d' % (prom, labels, inst.snapshot()))
            elif isinstance(inst, Gauge):
                fam(prom, 'gauge', help_text).append(
                    '%s%s %.17g' % (prom, labels, inst.snapshot()))
            elif isinstance(inst, Timer):
                stats = inst.snapshot()
                if help_text is not None:
                    fam(prom, None, help_text)  # HELP-only family line
                for stat in ('mean_ms', 'p50_ms', 'p95_ms', 'max_ms'):
                    fam('%s_%s' % (prom, stat), 'gauge').append(
                        '%s_%s%s %.17g'
                        % (prom, stat, labels, stats[stat]))
                fam('%s_count' % prom, 'counter').append(
                    '%s_count%s %d' % (prom, labels, stats['count']))
        out = []
        for prom, entry in families.items():  # first-seen (name) order
            if entry['help'] is not None:
                out.append('# HELP %s %s' % (prom, entry['help']))
            if entry['type'] is not None:
                out.append('# TYPE %s %s' % (prom, entry['type']))
            out.extend(entry['samples'])
        tmp = self.path + '.tmp'
        with open(tmp, 'w') as f:
            f.write('\n'.join(out) + '\n')
        os.replace(tmp, self.path)  # scrapers never see a torn file


class ConsoleExporter:
    """One compact progress line through the run logger, rate-limited so
    a fast step loop cannot flood the console."""

    def __init__(self, log, min_interval_s: float = 30.0):
        self.log = log
        self.min_interval_s = min_interval_s
        # None, not 0.0: a fresh boot's monotonic clock starts near zero
        self._last_emit = None

    @staticmethod
    def _ms(registry: Registry, name: str) -> float:
        inst = registry.get(name)
        return inst.snapshot()['mean_ms'] if isinstance(inst, Timer) else 0.0

    def flush(self, registry: Registry, step: int) -> None:
        now = time.monotonic()
        if self._last_emit is not None \
                and now - self._last_emit < self.min_interval_s:
            return
        self._last_emit = now

        def gauge(name: str) -> float:
            inst = registry.get(name)
            return inst.snapshot() if isinstance(inst, Gauge) else 0.0

        def count(name: str) -> int:
            inst = registry.get(name)
            return inst.snapshot() if isinstance(inst, Counter) else 0

        self.log('telemetry step %d | %.0f ex/s | wait %.1f h2d %.1f '
                 'dispatch %.1f sync %.1f ms | ring %d | %d compiles'
                 % (step, gauge('train/examples_per_sec'),
                    self._ms(registry, 'step/batch_wait_ms'),
                    self._ms(registry, 'step/h2d_ms'),
                    self._ms(registry, 'step/dispatch_ms'),
                    self._ms(registry, 'step/sync_ms'),
                    int(gauge('staging/ring_occupancy')),
                    count('jit/compiles_total')))
