"""The request memoization tier (the port of
``code2vec_tpu/serving/memo.py``): repeated code traffic served from a
cache at mesh admission, before it reaches the queue or the card.

Code traffic repeats: the same methods and near-clones arrive again and
again, and each repeat pays the tokenize, the queue and the device. The
mesh checks this cache before ``FrontQueue.admit``; a hit resolves the
caller's future at once.

Two tiers:

- **Exact** (``MEMO_CACHE_BYTES > 0``): results keyed by
  ``request_key``, a hash of the canonical path-context bag
  (``data/reader.py::canonicalize_contexts`` truncates each line to
  ``MAX_CONTEXTS`` in extraction order, then sorts its ``(source, path,
  target)`` triples, duplicates kept), scoped per tier and per neighbors
  ``k``; the same bytes as the reference's key on the same lines. A
  bounded LRU with byte accounting, registered in the memory ledger
  (bucket ``memo``, ``kind='host'``: host bytes, outside the card's
  reconciliation).
- **Semantic** (``MEMO_SEMANTIC_EPSILON > 0``; off by default): a
  one-row neighbor query whose code vector lies within cosine distance
  epsilon of a cached query's is served that query's result. Every N-th
  would-be hit runs live instead and its top-1 neighbor is compared with
  the cached one (``memo/semantic_agreement``).

Correctness:

- **Generations.** Every entry records the cache generation at insert.
  A fleet rollover that swapped bumps it (``ServingMesh.load_params`` ->
  ``bump_generation``), which drops every entry at once; a rolled-back
  canary never calls it, so the cache stays warm. An insert whose
  request was in flight across the swap carries the old generation and
  is refused.
- **Two axes.** Neighbor results depend on the parameters and on the
  index, so their entries also record the index generation;
  ``bump_index_generation`` drops them and the whole semantic tier and
  keeps the predict entries. (The mesh's index rollover, which calls it,
  comes with ROADMAP A17.)
- **Delivered results only.** The mesh inserts from a done-callback on
  the caller's future, after an oversize request is joined: errors and
  cancellations insert nothing.
- **A degraded tier cannot poison.** The insert key uses the effective
  (possibly degraded) tier, the lookup key the requested one.
- **Caller mutation cannot poison.** Inserts store a private copy
  (``copy_results``) and every hit gets a fresh one.
"""
from __future__ import annotations

import collections
import hashlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from code2vec_tpu_torch.telemetry import catalog
from code2vec_tpu_torch.telemetry import core as tele_core
from code2vec_tpu_torch.telemetry import memory as memory_lib
from code2vec_tpu_torch.telemetry.core import Counter, Gauge

__all__ = ['MemoCache', 'copy_results', 'request_key', 'results_nbytes']

#: ledger entry key for the cache's host bytes (bucket ``memo``)
LEDGER_KEY = 'serving_memo'

#: nominal per-entry bookkeeping overhead charged on top of the
#: measured result bytes (key digest + OrderedDict slot + entry object)
ENTRY_OVERHEAD = 128


def request_key(canonical_lines: Sequence[str], tier: str,
                k: Optional[int] = None) -> bytes:
    """Content address of one request: a hash over the canonicalized
    path-context bag, scoped per tier and per neighbors ``k``.
    ``canonical_lines`` MUST already be canonical
    (``canonicalize_contexts``): the per-line sort of the parsed
    ``(source, path, target)`` triples is what makes the hash
    order-independent over each line's context bag.  Line ORDER across
    the request stays part of the identity — results are positional."""
    digest = hashlib.sha256()
    digest.update(('%s|%s' % (tier, k)).encode('utf-8'))
    for line in canonical_lines:
        digest.update(b'\x1e')
        digest.update(line.encode('utf-8', 'surrogatepass'))
    return digest.digest()


def results_nbytes(obj) -> int:
    """Approximate host bytes of a cached result tree
    (``ModelPredictionResults`` / ``NeighborResult`` rows: numpy
    arrays, strings, dicts, tuples).  Metadata and string lengths only
    — never copies, never touches a device."""
    total = 0
    stack = [obj]
    while stack:
        item = stack.pop()
        if isinstance(item, np.ndarray) or isinstance(item, np.generic):
            total += int(item.nbytes)
        elif isinstance(item, (str, bytes)):
            total += len(item)
        elif isinstance(item, dict):
            stack.extend(item.keys())
            stack.extend(item.values())
        elif isinstance(item, (list, tuple)):
            stack.extend(item)
        elif item is None or isinstance(item, (bool, int, float)):
            total += 8
        else:
            total += 64  # opaque object: nominal charge
    return total


def copy_results(obj):
    """Deep-ish copy of a result tree: numpy arrays are copied,
    containers (lists, dicts, tuples — NamedTuple rows like
    ``ModelPredictionResults``/``NeighborResult`` included) are
    rebuilt; immutable leaves (str/bytes/numbers/None) are shared.
    The cache stores a snapshot at insert and serves a fresh copy per
    hit, so a caller mutating what it was handed can never poison what
    every subsequent requester of the same key receives."""
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, list):
        return [copy_results(item) for item in obj]
    if isinstance(obj, tuple):
        copied = [copy_results(item) for item in obj]
        if hasattr(obj, '_fields'):  # NamedTuple: rebuild as its type
            return type(obj)(*copied)
        return tuple(copied)
    if isinstance(obj, dict):
        return {key: copy_results(value) for key, value in obj.items()}
    return obj


class _Entry:
    __slots__ = ('results', 'nbytes', 'generation', 'index_generation')

    def __init__(self, results, nbytes: int, generation: int,
                 index_generation: Optional[int] = None):
        self.results = results
        self.nbytes = nbytes
        self.generation = generation
        #: None = index-independent (predict tiers); an int pins the
        #: entry to the index version its result was computed against
        self.index_generation = index_generation


class _SemRow:
    """One cached semantic-tier query: the unit query vector and the
    single-row neighbor result it produced."""

    __slots__ = ('unit', 'result', 'nbytes', 'generation')

    def __init__(self, unit: np.ndarray, result, nbytes: int,
                 generation: int):
        self.unit = unit
        self.result = result
        self.nbytes = nbytes
        self.generation = generation


class MemoCache:
    """The mesh's request memoization cache (exact + semantic tiers).

    Thread contract: ``lookup`` runs on submitter threads, ``insert``
    on decode-completion callbacks, ``bump_generation`` on the rollover
    conclude callback, ``stats`` on monitors — one lock guards all
    cache state.
    """

    def __init__(self, capacity_bytes: int,
                 semantic_epsilon: float = 0.0,
                 semantic_max_rows: int = 512,
                 semantic_shadow_every: int = 8,
                 params_step: Optional[int] = None,
                 log=None):
        if capacity_bytes <= 0:
            raise ValueError('MemoCache needs capacity_bytes > 0 (got '
                             '%r); a disabled memo tier is no cache, '
                             'not an empty one' % capacity_bytes)
        self.capacity_bytes = int(capacity_bytes)
        self.semantic_epsilon = float(semantic_epsilon)
        self.semantic_max_rows = max(1, int(semantic_max_rows))
        self.semantic_shadow_every = max(2, int(semantic_shadow_every))
        self.log = log if log is not None else (lambda msg: None)
        self._lock = threading.Lock()
        self._entries: 'collections.OrderedDict[bytes, _Entry]' = \
            collections.OrderedDict()
        self._bytes = 0
        self._generation = 0
        self._index_generation = 0
        self._params_step = params_step
        # semantic tier: per-k row store (a neighbor result is only
        # reusable at the same k)
        self._sem: Dict[int, collections.deque] = {}
        self._sem_bytes = 0
        self._sem_rows_total = 0
        self._sem_serves = 0   # candidate hits, for shadow sampling
        self._sem_samples = 0  # shadow comparisons run
        self._sem_agree = 0    # ... that agreed on top-1
        # instruments (catalog family memo/*)
        self.hits_total = Counter('memo/hits_total')
        self.misses_total = Counter('memo/misses_total')
        self.inserts_total = Counter('memo/inserts_total')
        self.evictions_total = Counter('memo/evictions_total')
        self.semantic_hits_total = Counter('memo/semantic_hits_total')
        self.bytes_gauge = Gauge('memo/bytes')
        self.entries_gauge = Gauge('memo/entries')
        self.agreement_gauge = Gauge('memo/semantic_agreement')
        # host-bucket ledger sibling: memo bytes are HOST memory, so
        # kind='host' keeps them out of the device live-array
        # reconciliation while still visible in the taxonomy
        memory_lib.ledger().register('memo', LEDGER_KEY, 0, kind='host')

    # ------------------------------------------------------- exact tier
    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    @property
    def index_generation(self) -> int:
        with self._lock:
            return self._index_generation

    def lookup(self, key: bytes, scenario: Optional[str] = None):
        """A fresh copy of the cached result list for ``key``
        (``copy_results`` — hits never share rows or arrays), or None.
        A hit touches LRU recency; entries from a previous params OR
        index generation never serve (defensive — the bump calls
        already cleared them; an eviction here re-exports the gauges
        and the ledger so they cannot sit stale until the next
        insert).  ``scenario`` additionally mirrors the hit/miss into
        scenario-labeled counter instances, so per-scenario hit-rate
        falls out of the existing ``memo/*`` family."""
        stale_total = None
        stale_entries = 0
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and (
                    entry.generation != self._generation
                    or (entry.index_generation is not None
                        and entry.index_generation
                        != self._index_generation)):
                self._entries.pop(key, None)
                self._bytes -= entry.nbytes
                entry = None
                stale_total = self._bytes + self._sem_bytes
                stale_entries = len(self._entries)
            if entry is not None:
                self._entries.move_to_end(key)
        if stale_total is not None:
            self._export(stale_total, stale_entries)
        if entry is None:
            self.misses_total.inc()
            if tele_core.enabled():
                reg = tele_core.registry()
                reg.counter('memo/misses_total').inc()
                if scenario:
                    reg.counter(catalog.labeled(
                        'memo/misses_total', 'scenario',
                        scenario)).inc()
            return None
        self.hits_total.inc()
        if tele_core.enabled():
            reg = tele_core.registry()
            reg.counter('memo/hits_total').inc()
            if scenario:
                reg.counter(catalog.labeled(
                    'memo/hits_total', 'scenario', scenario)).inc()
        # outside the lock: the snapshot stored at insert is never
        # mutated, so the reference read above stays safe to copy
        return copy_results(entry.results)

    def insert(self, key: bytes, results, generation: int,
               index_generation: Optional[int] = None) -> bool:
        """Insert a delivered-good result under the generation(s)
        captured at SUBMIT time — a result in flight across a params
        OR index rollover carries the old generation and is refused
        (stale results can never enter the post-swap cache).
        ``index_generation`` is None for index-independent results
        (predict tiers — they survive an index swap) and the submit
        time ``index_generation`` for neighbor results.  Stores a
        private snapshot (``copy_results``) — the delivering caller
        keeps the original.  Evicts LRU entries to fit; a result
        larger than the whole budget is skipped."""
        nbytes = results_nbytes(results) + len(key) + ENTRY_OVERHEAD
        if nbytes > self.capacity_bytes:
            return False
        results = copy_results(results)
        evicted = 0
        with self._lock:
            if generation != self._generation:
                return False
            if index_generation is not None and \
                    index_generation != self._index_generation:
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            while self._bytes + nbytes > self.capacity_bytes \
                    and self._entries:
                _, victim = self._entries.popitem(last=False)
                self._bytes -= victim.nbytes
                evicted += 1
            self._entries[key] = _Entry(results, nbytes, generation,
                                        index_generation)
            self._bytes += nbytes
            total = self._bytes + self._sem_bytes
            entries = len(self._entries)
        self.inserts_total.inc()
        if evicted:
            self.evictions_total.inc(evicted)
        if tele_core.enabled():
            reg = tele_core.registry()
            reg.counter('memo/inserts_total').inc()
            if evicted:
                reg.counter('memo/evictions_total').inc(evicted)
        self._export(total, entries)
        return True

    # ---------------------------------------------------- semantic tier
    def semantic_lookup(self, vector, k: int
                        ) -> Optional[Tuple[object, bool]]:
        """Nearest cached query within cosine distance epsilon at this
        ``k``: returns ``(cached_row_result, shadow)`` or None.
        ``shadow=True`` marks a sampled agreement check — the caller
        must run the request LIVE and feed both results to
        ``note_semantic_agreement`` instead of serving the cache.  A
        served row is a fresh copy (``copy_results``); a shadow row is
        the cached reference, read only for the top-1 comparison."""
        if self.semantic_epsilon <= 0:
            return None
        unit = np.asarray(vector, np.float32).reshape(-1)
        norm = float(np.linalg.norm(unit))
        if not np.isfinite(norm) or norm == 0.0:
            return None
        unit = unit / norm
        with self._lock:
            rows = self._sem.get(int(k))
            if not rows:
                return None
            stacked = np.stack([row.unit for row in rows])
            sims = stacked @ unit
            best = int(np.argmax(sims))
            if 1.0 - float(sims[best]) > self.semantic_epsilon:
                return None
            result = rows[best].result
            self._sem_serves += 1
            shadow = (self._sem_serves % self.semantic_shadow_every) == 0
        if not shadow:
            self.semantic_hits_total.inc()
            if tele_core.enabled():
                tele_core.registry().counter(
                    'memo/semantic_hits_total').inc()
            result = copy_results(result)
        return result, shadow

    def semantic_insert(self, vectors, results, k: int,
                        generation: int,
                        index_generation: Optional[int] = None) -> int:
        """Remember each query row's code vector + its neighbor result
        for within-epsilon reuse.  FIFO-bounded at
        ``semantic_max_rows`` across all ``k``.  Semantic rows cache
        INDEX lookups, so a row in flight across an index rollover
        (``index_generation`` captured at submit) is refused exactly
        like a params-rollover straggler.  No-op while the semantic
        tier is OFF (epsilon == 0) — a disabled tier stores nothing
        and costs nothing."""
        if self.semantic_epsilon <= 0:
            return 0
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        inserted = 0
        with self._lock:
            if generation != self._generation:
                return 0
            if index_generation is not None and \
                    index_generation != self._index_generation:
                return 0
            rows = self._sem.setdefault(
                int(k), collections.deque())
            for vec, result in zip(vectors, results):
                norm = float(np.linalg.norm(vec))
                if not np.isfinite(norm) or norm == 0.0:
                    continue
                nbytes = (results_nbytes(result) + int(vec.nbytes)
                          + ENTRY_OVERHEAD)
                # private snapshot: the delivering caller keeps the
                # original row (same isolation contract as insert())
                rows.append(_SemRow(vec / norm, copy_results(result),
                                    nbytes, generation))
                self._sem_bytes += nbytes
                self._sem_rows_total += 1
                inserted += 1
                while self._sem_rows_total > self.semantic_max_rows:
                    self._evict_sem_row_locked()
            total = self._bytes + self._sem_bytes
            entries = len(self._entries)
        if inserted:
            self._export(total, entries)
        return inserted

    def _evict_sem_row_locked(self) -> None:
        """Drop the oldest semantic row across every k (FIFO)."""
        for k, rows in self._sem.items():
            if rows:
                victim = rows.popleft()
                self._sem_bytes -= victim.nbytes
                self._sem_rows_total -= 1
                if not rows:
                    del self._sem[k]
                return

    @staticmethod
    def _top1(row) -> Optional[object]:
        labels = getattr(row, 'labels', None)
        if labels:
            return labels[0]
        indices = getattr(row, 'indices', None)
        if indices is not None and len(indices):
            return int(indices[0])
        return None

    def note_semantic_agreement(self, cached_row, live_row) -> None:
        """One shadow sample concluded: compare the cached top-1
        neighbor against the live top-1 (the canary machinery's
        agreement statistic) and export the running agreement rate —
        the epsilon-aggressiveness dial."""
        cached_top = self._top1(cached_row)
        live_top = self._top1(live_row)
        agree = cached_top is not None and cached_top == live_top
        with self._lock:
            self._sem_samples += 1
            self._sem_agree += 1 if agree else 0
            rate = self._sem_agree / self._sem_samples
        self.agreement_gauge.set(rate)
        if tele_core.enabled():
            tele_core.registry().gauge(
                'memo/semantic_agreement').set(rate)

    # ------------------------------------------------------ invalidation
    def bump_generation(self, params_step: Optional[int] = None) -> int:
        """A fleet rollover SWAPPED: one atomic version bump invalidates
        every pre-swap entry (exact and semantic) — not a per-entry
        eviction walk, and not counted as evictions.  A rolled-back
        canary never calls this, so the cache stays warm.  Returns the
        new generation."""
        with self._lock:
            self._generation += 1
            self._params_step = (params_step if params_step is not None
                                 else self._params_step)
            dropped = len(self._entries)
            self._entries.clear()
            self._bytes = 0
            self._sem.clear()
            self._sem_bytes = 0
            self._sem_rows_total = 0
            generation = self._generation
        self._export(0, 0)
        self.log('memo: generation -> %d (params step %s); %d cached '
                 'entr%s invalidated atomically'
                 % (generation, params_step, dropped,
                    'y' if dropped == 1 else 'ies'))
        return generation

    def bump_index_generation(self) -> int:
        """An INDEX rollover swapped: invalidate every index-dependent
        entry (neighbor results — ``index_generation`` is not None —
        and the whole semantic tier, which only ever caches index
        lookups) while index-independent predict entries SURVIVE —
        the model didn't change, so their results are still good.
        A rolled-back index canary never calls this.  Returns the new
        index generation."""
        with self._lock:
            self._index_generation += 1
            dropped = 0
            for key in [key for key, entry in self._entries.items()
                        if entry.index_generation is not None]:
                victim = self._entries.pop(key)
                self._bytes -= victim.nbytes
                dropped += 1
            sem_dropped = self._sem_rows_total
            self._sem.clear()
            self._sem_bytes = 0
            self._sem_rows_total = 0
            generation = self._index_generation
            total = self._bytes + self._sem_bytes
            entries = len(self._entries)
        self._export(total, entries)
        self.log('memo: index generation -> %d; %d neighbor entr%s + '
                 '%d semantic row(s) invalidated, %d predict entr%s '
                 'kept'
                 % (generation, dropped,
                    'y' if dropped == 1 else 'ies', sem_dropped,
                    entries, 'y' if entries == 1 else 'ies'))
        return generation

    # --------------------------------------------------------- plumbing
    def _export(self, total_bytes: int, entries: int) -> None:
        self.bytes_gauge.set(total_bytes)
        self.entries_gauge.set(entries)
        if tele_core.enabled():
            reg = tele_core.registry()
            reg.gauge('memo/bytes').set(total_bytes)
            reg.gauge('memo/entries').set(entries)
        # re-register replaces the previous ledger entry: replacing IS
        # the release of the previous size (telemetry/memory.py)
        memory_lib.ledger().register('memo', LEDGER_KEY, total_bytes,
                                     kind='host')

    def stats(self) -> Dict[str, object]:
        with self._lock:
            out = {
                'entries': len(self._entries),
                'bytes': self._bytes + self._sem_bytes,
                'capacity_bytes': self.capacity_bytes,
                'generation': self._generation,
                'index_generation': self._index_generation,
                'params_step': self._params_step,
                'semantic': {
                    'epsilon': self.semantic_epsilon,
                    'rows': self._sem_rows_total,
                    'serves': self._sem_serves,
                    'samples': self._sem_samples,
                    'agreement': (self._sem_agree / self._sem_samples
                                  if self._sem_samples else None),
                },
            }
        hits = self.hits_total.snapshot()
        misses = self.misses_total.snapshot()
        out.update({
            'hits': hits,
            'misses': misses,
            'hit_rate': hits / (hits + misses) if hits + misses else 0.0,
            'inserts': self.inserts_total.snapshot(),
            'evictions': self.evictions_total.snapshot(),
            'semantic_hits': self.semantic_hits_total.snapshot(),
        })
        return out

    def close(self) -> None:
        """Release the ledger entry (idempotent)."""
        memory_lib.ledger().release('memo', LEDGER_KEY)
