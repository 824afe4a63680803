"""Device-memory ledger: per-subsystem attribution of live device bytes
(the port of ``code2vec_tpu/telemetry/memory.py``, over ``torch.cuda``).

Every owner of device memory — the trainer's state, a checkpoint restore,
the staging ring, the embedding index, the serving engine's parameter
slots and its CUDA-graph pool — registers its allocations here, so the process can say who holds
how many bytes, diff two moments for leaks, refuse an allocation that
would cross the HBM budget before it happens, and dump a forensic ledger
when the card runs out of memory.

- **Stdlib at import**: torch is imported inside the functions that need
  it.
- **Thread-safe**: the staging ring registers from the loop while the
  engine's decode workers and ``load_params`` swap slots; one lock.
- **No host syncs**: bookkeeping reads tensor metadata (``numel``,
  ``element_size``); reconciliation reads the caching allocator's
  counters (``torch.cuda.memory_allocated`` and friends), which never
  wait for the card.

Accounting is in bytes of tensors, the basis of
``torch.cuda.memory_allocated`` on the current device, which is the
reconciliation's ``live_bytes``. The reserve the caching allocator keeps,
and the free and total bytes of the card, ride along in snapshots. On the
CPU the backend reports no device bytes: reconciliation is skipped, not
faked (a snapshot then has no ``backend`` and no ``unattributed_bytes``).

Buckets:

- ``params``      — model parameter sets, one entry per set: the
                    trainer's fp32 masters, each serving engine
                    parameter slot (compute dtype).
- ``opt_state``   — Adam moments.
- ``staging``     — batches resident in the staging ring
                    (``Trainer.stage_batches``).
- ``index``       — embedding-index residents (``index/``): the exact
                    tier's store rows, the IVF tier's sorted rows and
                    centroids, the quantized tier's base codes and each
                    append segment under its own key.
- ``executables`` — the serving engine's shared CUDA-graph pool, measured
                    at warm-up (``GraphLadder.pool_bytes``).
                    kind='executable': reported, excluded from the array
                    reconciliation, as the reference excludes its
                    compiled programs.
- ``memo``        — the serving memoization tier's cached results
                    (``serving/memo.py``): host bytes, the one
                    host-resident bucket. kind='host': reported beside
                    the card's residents it spares, excluded from the
                    reconciliation.

Everything live on the card but in no bucket is the residual
``unattributed_bytes`` (the cuBLAS workspace, the kernels' scratch, the
loss window's scalars).
"""
from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

from code2vec_tpu_torch.telemetry import core as tele_core

logger = logging.getLogger(__name__)

ENV_BUDGET = 'HBM_BUDGET_BYTES'
TOUCH_FILE_NAME = 'MEM_NOW'
OOM_DUMP_NAME = 'oom_ledger.json'

#: the ledger's bucket taxonomy: registration validates against it
BUCKETS = ('params', 'opt_state', 'staging', 'index', 'executables',
           'memo')

#: bucket -> catalog gauge mirrored into the telemetry registry
_BUCKET_GAUGE = {
    'params': 'mem/params_bytes',
    'opt_state': 'mem/opt_state_bytes',
    'staging': 'mem/staging_bytes',
    'index': 'mem/index_bytes',
    'executables': 'mem/executables_bytes',
    'memo': 'mem/memo_bytes',
}

_EVENT_RING = 128


class MemoryBudgetExceeded(RuntimeError):
    """An allocation would cross ``HBM_BUDGET_BYTES``: raised before the
    allocation happens (the trainer's state, a serving slot), so the
    caller fails typed instead of the card failing mid-step."""


# ------------------------------------------------------------- helpers
def tree_nbytes(tree) -> int:
    """Total bytes of a nest (tuples, lists, named tuples, dicts) of
    tensors or numpy arrays; other leaves (step counters, None) count 0.
    Metadata only: never waits for the card."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    element_size = getattr(tree, 'element_size', None)
    if element_size is not None and hasattr(tree, 'numel'):
        return int(tree.numel()) * int(element_size())
    nbytes = getattr(tree, 'nbytes', None)
    if isinstance(nbytes, int):
        return nbytes
    return 0


def _allocated_bytes() -> Optional[int]:
    """``torch.cuda.memory_allocated`` of the current device, or None on
    the CPU or before the process has touched the card."""
    try:
        import torch
    except ImportError:
        return None
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return int(torch.cuda.memory_allocated())


def backend_memory() -> Optional[Dict[str, Any]]:
    """The caching allocator's view of the current CUDA device:
    ``live_bytes`` (``memory_allocated``, the reconciliation basis),
    ``reserved_bytes``, ``peak_bytes`` (``max_memory_allocated``) and the
    card's ``free_bytes`` / ``total_bytes`` (``mem_get_info``). None on
    the CPU, or before the process has touched the card."""
    try:
        import torch
    except ImportError:
        return None
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    device = torch.cuda.current_device()
    free, total = torch.cuda.mem_get_info(device)
    reserved = int(torch.cuda.memory_reserved(device))
    return {'live_bytes': int(torch.cuda.memory_allocated(device)),
            'reserved_bytes': reserved,
            'peak_bytes': int(torch.cuda.max_memory_allocated(device)),
            'free_bytes': int(free), 'total_bytes': int(total),
            'source': 'torch.cuda.memory_allocated',
            'devices': [{'id': int(device), 'bytes_in_use': reserved,
                         'peak_bytes_in_use': int(
                             torch.cuda.max_memory_reserved(device))}]}


def is_oom_error(exc: BaseException) -> bool:
    """Whether ``exc`` is a device out-of-memory:
    ``torch.cuda.OutOfMemoryError``, or an error whose text says so (a
    kernel wrapper's allocation, the reference's RESOURCE_EXHAUSTED)."""
    try:
        import torch
        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
    except (ImportError, AttributeError):
        pass
    text = str(exc)
    return ('RESOURCE_EXHAUSTED' in text
            or 'out of memory' in text.lower())


def _atomic_write_json(path: str, payload: dict) -> None:
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


class _Entry:
    __slots__ = ('bucket', 'key', 'nbytes', 'kind', 'attrs', 't',
                 'finalizer')

    def __init__(self, bucket: str, key: str, nbytes: int, kind: str,
                 attrs: Optional[dict]):
        self.bucket = bucket
        self.key = key
        self.nbytes = int(nbytes)
        self.kind = kind
        self.attrs = attrs or {}
        self.t = time.time()
        self.finalizer = None

    def record(self) -> Dict[str, Any]:
        out = {'key': self.key, 'bytes': self.nbytes, 'kind': self.kind}
        if self.attrs:
            out['attrs'] = self.attrs
        return out


# --------------------------------------------------------------- ledger
class MemoryLedger:
    """The process-global device-memory ledger.

    ``register`` replaces an existing entry under the same ``(bucket,
    key)``, so owners re-registering across restores and rollovers never
    double-count; ``owner=`` attaches a ``weakref.finalize`` that
    releases the entry when the owner is collected."""

    def __init__(self):
        # re-entrant: a finalizer (owner collected) calls release(), and
        # the cyclic GC can run it on this thread inside register()
        self._lock = threading.RLock()
        self._entries: Dict[Tuple[str, str], _Entry] = {}
        self._events: collections.deque = collections.deque(
            maxlen=_EVENT_RING)
        self._watermarks: Dict[str, int] = {}
        self._budget: Optional[int] = None  # None: the env var decides
        self._dump_dir: Optional[str] = None
        # the process's file suffix ('.proc<r>' on rank r > 0 of a mesh)
        self._suffix = ''
        self._oom_dumps = 0

    # ------------------------------------------------------ configure
    def configure(self, budget_bytes: Optional[int] = None,
                  dump_dir: Optional[str] = None,
                  suffix: Optional[str] = None) -> None:
        """Pin the budget (overriding ``HBM_BUDGET_BYTES``; 0 =
        unlimited), the directory forensic dumps land in (default: the
        working directory) and/or the suffix of this process's file names
        (``file_name``)."""
        with self._lock:
            if budget_bytes is not None:
                self._budget = int(budget_bytes)
            if dump_dir is not None:
                self._dump_dir = dump_dir
            if suffix is not None:
                self._suffix = suffix

    def file_name(self, name: str) -> str:
        """``name`` ('oom_ledger.json') as this process writes it: rank r
        > 0 of a mesh inserts its ``.proc<r>`` before the extension, as
        ``metrics.proc<r>.jsonl``, so no two ranks write one path."""
        with self._lock:
            suffix = self._suffix
        stem, ext = os.path.splitext(name)
        return stem + suffix + ext

    def budget_bytes(self) -> int:
        """The configured budget, else ``HBM_BUDGET_BYTES``, else 0."""
        with self._lock:
            budget = self._budget
        if budget is not None:
            return budget
        try:
            return int(os.environ.get(ENV_BUDGET, '0') or 0)
        except ValueError:
            raise ValueError('%s must be an integer byte count, got %r'
                             % (ENV_BUDGET, os.environ.get(ENV_BUDGET)))

    def dump_dir(self) -> str:
        with self._lock:
            return self._dump_dir or '.'

    # ------------------------------------------------------- mutation
    def register(self, bucket: str, key: str, source,
                 kind: str = 'array', owner=None,
                 attrs: Optional[dict] = None) -> int:
        """Attribute ``source`` (a nest of tensors, or a byte count) to
        ``(bucket, key)``. Returns the registered bytes."""
        if bucket not in BUCKETS:
            raise ValueError('unknown ledger bucket %r (taxonomy: %s)'
                             % (bucket, list(BUCKETS)))
        nbytes = (int(source) if isinstance(source, (int, float))
                  else tree_nbytes(source))
        entry = _Entry(bucket, key, nbytes, kind, attrs)
        if owner is not None:
            entry.finalizer = weakref.finalize(
                owner, self.release, bucket, key)
        with self._lock:
            old = self._entries.get((bucket, key))
            if old is not None and old.finalizer is not None:
                old.finalizer.detach()
            self._entries[(bucket, key)] = entry
            self._events.append({'t': entry.t, 'op': 'register',
                                 'bucket': bucket, 'key': key,
                                 'bytes': nbytes})
            self._update_watermarks_locked()
            self._export_locked()
        return nbytes

    def release(self, bucket: str, key: str) -> int:
        """Drop an entry (no-op when absent). Returns its bytes."""
        with self._lock:
            entry = self._entries.pop((bucket, key), None)
            if entry is None:
                return 0
            if entry.finalizer is not None:
                entry.finalizer.detach()
            self._events.append({'t': time.time(), 'op': 'release',
                                 'bucket': bucket, 'key': key,
                                 'bytes': entry.nbytes})
            self._export_locked()
            return entry.nbytes

    # ------------------------------------------------------- accounting
    def _values_locked(self) -> List[_Entry]:
        """The entries as a list: an allocation inside a loop over the
        dict can run the cyclic GC, whose finalizers release entries on
        this thread (the lock is re-entrant) and resize the dict."""
        return list(self._entries.values())

    def _totals_locked(self) -> Dict[str, int]:
        totals = {bucket: 0 for bucket in BUCKETS}
        for entry in self._values_locked():
            totals[entry.bucket] += entry.nbytes
        return totals

    def _attributed_locked(self) -> int:
        return sum(entry.nbytes for entry in self._values_locked()
                   if entry.kind == 'array')

    def _update_watermarks_locked(self) -> None:
        for bucket, value in self._totals_locked().items():
            if value > self._watermarks.get(bucket, 0):
                self._watermarks[bucket] = value
        attributed = self._attributed_locked()
        if attributed > self._watermarks.get('total', 0):
            self._watermarks['total'] = attributed

    def _export_locked(self) -> None:
        """Mirror the bucket totals into the registry (a bool read when
        telemetry is off)."""
        if not tele_core.enabled():
            return
        reg = tele_core.registry()
        totals = self._totals_locked()
        for bucket, metric in _BUCKET_GAUGE.items():
            reg.gauge(metric).set(totals[bucket])
        reg.gauge('mem/attributed_bytes').set(self._attributed_locked())
        reg.gauge('mem/watermark_bytes').set(
            self._watermarks.get('total', 0))

    def attributed_bytes(self) -> int:
        with self._lock:
            return self._attributed_locked()

    def bucket_bytes(self, bucket: str) -> int:
        with self._lock:
            return self._totals_locked().get(bucket, 0)

    def export_gauges(self) -> None:
        """Refresh the ``mem/*`` gauges (telemetry flush cadence)."""
        budget = self.budget_bytes()
        with self._lock:
            self._export_locked()
        if tele_core.enabled():
            tele_core.registry().gauge('mem/budget_bytes').set(budget)

    def reconcile(self) -> Optional[int]:
        """Set ``mem/backend_live_bytes`` and ``mem/unattributed_bytes``
        from the caching allocator's live bytes alone (the telemetry
        flush's reconciliation, without ``mem_get_info``); returns the
        unattributed bytes, None without a card."""
        live = _allocated_bytes()
        if live is None:
            return None
        unattributed = live - self.attributed_bytes()
        if tele_core.enabled():
            reg = tele_core.registry()
            reg.gauge('mem/backend_live_bytes').set(live)
            reg.gauge('mem/unattributed_bytes').set(unattributed)
        return unattributed

    # -------------------------------------------------------- snapshot
    def snapshot(self, reconcile: bool = True,
                 reason: str = 'snapshot') -> Dict[str, Any]:
        """The ledger's state; with ``reconcile`` (and a card) also the
        backend's bytes and the unattributed residual."""
        backend = backend_memory() if reconcile else None
        budget = self.budget_bytes()
        with self._lock:
            totals = self._totals_locked()
            attributed = self._attributed_locked()
            buckets = {}
            for bucket in BUCKETS:
                entries = sorted(
                    (e.record() for e in self._values_locked()
                     if e.bucket == bucket),
                    key=lambda r: -r['bytes'])
                buckets[bucket] = {'bytes': totals[bucket],
                                   'entries': entries}
            snap = {
                'time': time.time(),
                'reason': reason,
                'budget_bytes': budget,
                'attributed_bytes': attributed,
                'executables_bytes': totals['executables'],
                'buckets': buckets,
                'watermarks': dict(self._watermarks),
                'events': list(self._events),
            }
        if backend is not None:
            snap['backend'] = backend
            snap['unattributed_bytes'] = backend['live_bytes'] - attributed
            if tele_core.enabled():
                reg = tele_core.registry()
                reg.gauge('mem/backend_live_bytes').set(
                    backend['live_bytes'])
                reg.gauge('mem/unattributed_bytes').set(
                    snap['unattributed_bytes'])
        return snap

    @staticmethod
    def diff(before: Dict[str, Any], after: Dict[str, Any]
             ) -> Dict[str, Any]:
        """Delta of two snapshots (the leak check): per-bucket byte
        deltas, per-entry changes, and the attributed / backend /
        unattributed deltas."""
        out: Dict[str, Any] = {
            'attributed_delta': (after['attributed_bytes']
                                 - before['attributed_bytes']),
            'buckets': {},
        }
        if 'backend' in before and 'backend' in after:
            out['backend_live_delta'] = (
                after['backend']['live_bytes']
                - before['backend']['live_bytes'])
            out['unattributed_delta'] = (
                after['unattributed_bytes']
                - before['unattributed_bytes'])
        for bucket in BUCKETS:
            b_entries = {e['key']: e['bytes'] for e in
                         before['buckets'][bucket]['entries']}
            a_entries = {e['key']: e['bytes'] for e in
                         after['buckets'][bucket]['entries']}
            changed = {}
            for key in sorted(set(b_entries) | set(a_entries)):
                delta = a_entries.get(key, 0) - b_entries.get(key, 0)
                if delta:
                    changed[key] = delta
            out['buckets'][bucket] = {
                'bytes_delta': (after['buckets'][bucket]['bytes']
                                - before['buckets'][bucket]['bytes']),
                'entries': changed,
            }
        return out

    # ------------------------------------------------ budget/forensics
    def check_budget(self, incoming_bytes: int, what: str) -> None:
        """Refuse an allocation that would cross the budget: dumps the
        ledger and raises ``MemoryBudgetExceeded`` before any device
        memory moves. A budget of 0 admits everything."""
        budget = self.budget_bytes()
        if budget <= 0:
            return
        attributed = self.attributed_bytes()
        if attributed + incoming_bytes <= budget:
            return
        path = self.dump(reason='budget: %s' % what)
        raise MemoryBudgetExceeded(
            '%s needs %d bytes but only %d of the %d-byte HBM budget '
            'remain (%d attributed; %s). Nothing was allocated. Ledger '
            'dumped to `%s` — render with scripts/memory_report.py.'
            % (what, incoming_bytes, max(0, budget - attributed),
               budget, attributed, ENV_BUDGET, path))

    def note_oom(self, exc: BaseException, context: str
                 ) -> Optional[str]:
        """OOM forensics at the step and dispatch boundaries: when
        ``exc`` is a device out-of-memory, dump ``oom_ledger.json``.
        Callers re-raise either way."""
        if not is_oom_error(exc):
            return None
        with self._lock:
            self._oom_dumps += 1
        if tele_core.enabled():
            tele_core.registry().counter('mem/oom_dumps_total').inc()
        return self.dump(
            path=os.path.join(self.dump_dir(),
                              self.file_name(OOM_DUMP_NAME)),
            reason='oom: %s: %s' % (context, exc))

    def dump(self, path: Optional[str] = None,
             reason: str = 'dump') -> str:
        """Write a reconciled snapshot as JSON (atomic), by default
        ``<dump_dir>/oom_ledger.json``."""
        if path is None:
            path = os.path.join(self.dump_dir(),
                                self.file_name(OOM_DUMP_NAME))
        out_dir = os.path.dirname(path)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        try:
            snap = self.snapshot(reason=reason)
        except Exception:
            # forensics must not mask the original failure
            snap = self.snapshot(reconcile=False, reason=reason)
        _atomic_write_json(path, snap)
        if tele_core.enabled():
            tele_core.registry().counter('mem/snapshots_total').inc()
        return path

    def reset(self) -> None:
        """Drop every entry and watermark (test isolation)."""
        with self._lock:
            for entry in self._values_locked():
                if entry.finalizer is not None:
                    entry.finalizer.detach()
            self._entries.clear()
            self._events.clear()
            self._watermarks.clear()
            self._budget = None
            self._dump_dir = None
            self._suffix = ''
            self._oom_dumps = 0


_LEDGER = MemoryLedger()


def ledger() -> MemoryLedger:
    """The process-global ledger."""
    return _LEDGER


def configure(budget_bytes: Optional[int] = None,
              dump_dir: Optional[str] = None,
              suffix: Optional[str] = None) -> None:
    _LEDGER.configure(budget_bytes=budget_bytes, dump_dir=dump_dir,
                      suffix=suffix)


def reset() -> None:
    _LEDGER.reset()


# ------------------------------------------------------- MEM_NOW trigger
class MemoryReportController:
    """Touch-file ledger snapshots from a live run: ``touch
    <telemetry_dir>/MEM_NOW`` and the next telemetry flush consumes it and
    writes ``memory_step<N>.json``. Repeatable."""

    def __init__(self, out_dir: str, log=None):
        self.out_dir = out_dir
        self.touch_path = os.path.join(out_dir,
                                       _LEDGER.file_name(TOUCH_FILE_NAME))
        self._log = log or (lambda msg: None)

    def poll(self, step: int) -> Optional[str]:
        """Called at the flush cadence: one ``stat`` per flush."""
        if not os.path.exists(self.touch_path):
            return None
        try:
            os.remove(self.touch_path)  # consume: one snapshot per touch
        except OSError:
            pass
        path = os.path.join(self.out_dir, _LEDGER.file_name(
            'memory_step%d.json' % step))
        _LEDGER.dump(path, reason='MEM_NOW at step %d' % step)
        self._log('memory: ledger snapshot written to `%s` (render: '
                  'python scripts/memory_report.py %s)' % (path, path))
        return path


def write_report(config) -> str:
    """``--memory-report``: a reconciled ledger snapshot,
    ``memory_report.json`` in the run's telemetry directory."""
    out_dir = config.telemetry_dir
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, _LEDGER.file_name('memory_report.json'))
    _LEDGER.dump(path, reason='--memory-report')
    logger.info('memory: ledger report written to `%s` (render: python '
                'scripts/memory_report.py %s)', path, path)
    return path
