"""The serving engine: dynamic micro-batching over a warm ladder of CUDA
graphs (the port of ``code2vec_tpu/serving/engine.py``).

- **Bucket ladder.** Batch buckets (``Config.SERVING_BATCH_BUCKETS``) x
  packed-capacity rungs (``data/packed.py::capacity_ladder``) x output
  tiers (``serving/steps.py::PREDICT_TIERS``) x parameter slots.
  ``warmup()`` captures one CUDA graph per key at load
  (``serving/graphs.py``), so steady-state serving never captures.
- **Micro-batcher.** ``submit()`` tokenizes on the caller's thread and
  enqueues; a dispatcher thread coalesces concurrent requests under
  ``SERVING_MAX_DELAY_MS`` into the smallest covering bucket, packs them
  onto the wire on the host, copies them into the graph's static inputs
  through pinned buffers and replays the graph, with the outputs' copy to
  pinned host buffers enqueued behind it.
- **Decode offload.** A worker pool (``SERVING_DECODE_WORKERS``) waits
  for each batch's copy, looks the top-k words up and parses the
  attention, so the dispatcher never waits on the card or on Python.

Admission control: the queue is bounded (``SERVING_QUEUE_BOUND`` rows);
a submission past it, or whose SLO deadline (``SERVING_DEADLINE_MS`` /
``deadline_ms=``) the drain estimate already exceeds, is shed with a
typed ``EngineOverloaded``; a queued request whose deadline passes is
expired with ``DeadlineExceeded``; a degradation ladder serves 'full' as
'attention' and then 'topk' while the queue runs hot.

Canaried rollover: ``load_params(step|path|params)`` copies the candidate
into the idle parameter slot, shadow-scores live batches on both slots
(the idle slot's graphs, captured at warm-up: no capture), and swaps the
serving slot when the top-1 agreement clears
``SERVING_CANARY_AGREEMENT``, else rolls back. ``follow_checkpoints``
polls the model's checkpoints and rolls newer steps in.

Left out for now: per-request tracing spans and the memory ledger
(ROADMAP A10), the index hooks (``attach_index`` and the neighbor
queries raise, ROADMAP A8), the serving mesh that seats engines in
external-dispatch mode (ROADMAP A16; ``dispatch_external`` is here).

Typical use::

    engine = model.serving_engine()          # captures the ladder
    future = engine.submit(context_lines)    # -> Future[list[results]]
    results = engine.predict(context_lines)  # sync convenience
    engine.close()
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from code2vec_tpu_torch.data import packed as packed_lib
from code2vec_tpu_torch.data.reader import (Batch, PathContextReader,
                                            canonicalize_contexts,
                                            parse_c2v_line)
from code2vec_tpu_torch.device import resolve_device
from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.serving.errors import (DeadlineExceeded, EngineClosed,
                                               EngineOverloaded)
from code2vec_tpu_torch.serving.graphs import Fetch, GraphLadder
from code2vec_tpu_torch.serving.steps import PREDICT_TIERS
from code2vec_tpu_torch.telemetry.core import Counter, Gauge, Timer

#: overload degradation ladder: the tier served at each level (missing
#: keys keep the requested tier); 'vectors' is never remapped
_DEGRADE_LADDER = {
    1: {'full': 'attention'},
    2: {'full': 'topk', 'attention': 'topk'},
}
#: queue-fill fractions of the admission bound: enter level 2 / enter
#: level 1 / drop back to 0 (the wide exit gap is the hysteresis)
_OVERLOAD_ENTER_2 = 0.75
_OVERLOAD_ENTER_1 = 0.50
_OVERLOAD_EXIT = 0.25

#: sliding window of the drain estimate's throughput, and the span it
#: must cover before it overrides the sojourn seed
_SERVICE_WINDOW_S = 2.0
_SERVICE_MIN_SPAN_S = 0.05

#: orders the enqueues of coexisting engines: a dispatch reads its
#: parameter slot and enqueues its replay under it, and a rollover's copy
#: into the idle slot is enqueued under it, so a copy never lands between
#: a slot's choice and its replay
_DISPATCH_ENQUEUE_LOCK = threading.Lock()


# --------------------------------------------------------------- ladder
def batch_ladder(buckets: Sequence[int], data_axis: int) -> Tuple[int, ...]:
    """Sorted, deduplicated batch buckets, each rounded up to a multiple
    of ``data_axis``."""
    if data_axis < 1:
        raise ValueError('data_axis must be >= 1, got %d' % data_axis)
    out = set()
    for bucket in buckets:
        bucket = int(bucket)
        if bucket < 1:
            raise ValueError('batch buckets must be >= 1, got %d' % bucket)
        out.add(-(-bucket // data_axis) * data_axis)
    return tuple(sorted(out))


def pick_bucket(n: int, ladder: Sequence[int]) -> Optional[int]:
    """Smallest bucket covering ``n`` rows, or None past the ladder."""
    for bucket in ladder:
        if bucket >= n:
            return bucket
    return None


def attention_per_context(source_strings, path_strings, target_strings,
                          attention_weights) -> Dict[Tuple[str, str, str],
                                                     float]:
    """Per-context attention dict, skipping padding contexts."""
    out: Dict[Tuple[str, str, str], float] = {}
    for source, path, target, weight in zip(
            source_strings, path_strings, target_strings,
            attention_weights):
        if not source and not path and not target:
            continue
        out[(str(source), str(path), str(target))] = float(weight)
    return out


def decode_results(fetched: Dict[str, np.ndarray], batch, n_rows: int,
                   decode_table: np.ndarray) -> list:
    """Host numpy outputs + the string-bearing batch -> one
    ``ModelPredictionResults`` per row; outputs the tier did not produce
    decode to empty/None."""
    from code2vec_tpu_torch.model_api import ModelPredictionResults
    topk_indices = fetched.get('topk_indices')
    topk_scores = fetched.get('topk_scores')
    attention = fetched.get('attention')
    code_vectors = fetched.get('code_vectors')
    results = []
    for r in range(n_rows):
        attn = {}
        if attention is not None and batch.source_strings is not None:
            attn = attention_per_context(
                batch.source_strings[r], batch.path_strings[r],
                batch.target_strings[r], attention[r])
        results.append(ModelPredictionResults(
            original_name=(str(batch.label_strings[r])
                           if batch.label_strings is not None else ''),
            topk_predicted_words=(list(decode_table[topk_indices[r]])
                                  if topk_indices is not None else []),
            topk_predicted_words_scores=(topk_scores[r]
                                         if topk_scores is not None
                                         else None),
            attention_per_context=attn,
            code_vector=(code_vectors[r]
                         if code_vectors is not None else None)))
    return results


# ------------------------------------------------------------- requests
def _resolve(future: Future, results: list) -> None:
    """``set_result`` tolerating a future the caller cancelled: its own
    result is dropped, the other requests of the batch still deliver."""
    if not future.done():
        try:
            future.set_result(results)
        except Exception:
            pass  # lost the race to a concurrent cancel


class _Aggregate:
    """Joins the chunk results of one oversize request back into its
    caller's future, in row order."""

    def __init__(self, future: Future, n_chunks: int):
        self.future = future
        self.parts: List[Optional[list]] = [None] * n_chunks
        self.left = n_chunks
        self.lock = threading.Lock()

    def deliver(self, idx: int, results: list) -> None:
        with self.lock:
            self.parts[idx] = results
            self.left -= 1
            done = list(self.parts) if self.left == 0 else None
        if done is not None:
            merged: list = []
            for part in done:
                merged.extend(part)
            _resolve(self.future, merged)

    def fail(self, exc: BaseException) -> None:
        if not self.future.done():
            try:
                self.future.set_exception(exc)
            except Exception:
                pass


class _Request:
    """One queue entry: a tokenized chunk of at most the top bucket's
    rows."""

    __slots__ = ('batch', 'rows', 'tier', 'future', 'aggregate',
                 'chunk_idx', 't_enqueue', 't_deadline')

    def __init__(self, batch: Batch, tier: str,
                 future: Optional[Future] = None,
                 aggregate: Optional[_Aggregate] = None,
                 chunk_idx: int = 0,
                 deadline_s: Optional[float] = None):
        self.batch = batch
        self.rows = int(batch.label.shape[0])
        self.tier = tier
        self.future = future
        self.aggregate = aggregate
        self.chunk_idx = chunk_idx
        self.t_enqueue = time.perf_counter()
        # absolute expiry instant on the t_enqueue clock; None = no SLO
        self.t_deadline = (self.t_enqueue + deadline_s
                           if deadline_s else None)

    def deliver(self, results: list) -> None:
        if self.aggregate is not None:
            self.aggregate.deliver(self.chunk_idx, results)
        else:
            _resolve(self.future, results)

    def fail(self, exc: BaseException) -> None:
        if self.aggregate is not None:
            self.aggregate.fail(exc)
        elif not self.future.done():
            try:
                self.future.set_exception(exc)
            except Exception:
                pass


def bound_rejects(admitted: int, rows: int,
                  bound: Optional[int]) -> bool:
    """The admission bound rejects pile-up, not size: a request larger
    than the whole bound is admitted alone on an idle queue, and then
    everything behind it sheds until it drains."""
    if bound is None or admitted + rows <= bound:
        return False
    return rows <= bound or admitted > 0


def overload_tier(admitted: int, rows: int, bound: Optional[int],
                  level: int, tier: str,
                  warm_tiers: Sequence[str]) -> Tuple[int, str]:
    """One hysteresis step of the degradation ladder: ``(new_level,
    effective_tier)``; a downgrade never lands on a tier not warmed."""
    if bound is not None:
        fill = (admitted + rows) / bound
        if fill >= _OVERLOAD_ENTER_2:
            level = 2
        elif fill >= _OVERLOAD_ENTER_1:
            level = max(level, 1)
        elif fill < _OVERLOAD_EXIT:
            level = 0
    effective = _DEGRADE_LADDER.get(level, {}).get(tier, tier)
    if effective != tier and effective not in warm_tiers:
        effective = tier
    return level, effective


def note_service_window(window: collections.deque, window_rows: int,
                        rate: float, rows: int,
                        oldest_enqueue: Optional[float]
                        ) -> Tuple[int, float]:
    """One completion's update of the sliding served-rows/s window (the
    drain estimate); mutates ``window`` and returns ``(window_rows,
    rate)``. Until the window spans ``_SERVICE_MIN_SPAN_S`` the rate seeds
    from the batch's sojourn, biased low: a shed too many, never a
    deadline promised and missed."""
    now = time.perf_counter()
    window.append((now, rows))
    window_rows += rows
    horizon = now - _SERVICE_WINDOW_S
    while len(window) > 1 and window[0][0] < horizon:
        _t, evicted = window.popleft()
        window_rows -= evicted
    anchor_t, anchor_rows = window[0]
    span = now - anchor_t
    if span >= _SERVICE_MIN_SPAN_S:
        # the anchor's rows completed at the span's start
        rate = (window_rows - anchor_rows) / span
    elif rate <= 0 and oldest_enqueue is not None:
        rate = rows / max(1e-6, now - oldest_enqueue)
    return window_rows, rate


# every byte but the space and the comma, deleted by ``_long_context``
_NOT_SEPARATOR = bytes(b for b in range(256) if b not in b' ,')


def _long_context(lines: Sequence[str]) -> bool:
    """Whether canonical lines hold a context of more than three comma
    parts (``s,p,t,extra``), whose target the native tokenizer and the
    Python one read differently: three commas in a row once all but the
    separators are gone, in one scan of the request (in UTF-8 no
    multi-byte character holds either byte). A comma-holding label can
    only add a false positive, which costs the Python route and no
    result."""
    return b',,,' in ' '.join(lines).encode().translate(None,
                                                        _NOT_SEPARATOR)


def tokenize_and_chunk(reader: PathContextReader, lines: Sequence[str],
                       tier: str, future: Future,
                       deadline_s: Optional[float],
                       max_bucket: int) -> List[_Request]:
    """Caller-thread tokenize of canonical lines (``canonicalize_contexts``
    already ran) and oversize chunking: a request of at most the top
    bucket stays whole; a larger one splits into chunks joined back in
    order through an ``_Aggregate``.

    The tiers whose decode reads the context strings (attention, full)
    tokenize in Python, keeping them; topk and vectors keep the label
    strings only, through the native tokenizer under READER_USE_NATIVE
    (the same arrays; ctypes releases the GIL, so concurrent callers
    tokenize in parallel). A request with a context of more than three
    comma parts goes through Python on every tier: the native tokenizer
    reads ``t,extra`` as that context's target word where the Python one
    (and every predict surface of the reference) reads ``t``."""
    if tier in ('attention', 'full') or _long_context(lines):
        max_contexts = reader.config.MAX_CONTEXTS
        batch = reader.tokenize_rows([parse_c2v_line(line, max_contexts)
                                      for line in lines])
    else:
        batch = reader.tokenize_lines(lines, keep_labels=True)
    n = int(batch.label.shape[0])
    if n <= max_bucket:
        return [_Request(batch, tier, future=future, deadline_s=deadline_s)]
    n_chunks = -(-n // max_bucket)
    aggregate = _Aggregate(future, n_chunks)
    return [_Request(PathContextReader._take_rows(
        batch, slice(i * max_bucket, (i + 1) * max_bucket)), tier,
        aggregate=aggregate, chunk_idx=i, deadline_s=deadline_s)
        for i in range(n_chunks)]


class _Rollover:
    """One armed canaried rollover: the parameter slot holding the
    candidate and the canary's tallies (mutated under the engine's
    ``_cond``)."""

    __slots__ = ('slot', 'step', 'handle', 'target_batches',
                 'min_agreement', 't_armed', 'batches', 'rows',
                 'agree_rows', 'primary_fetch_s', 'shadow_fetch_s')

    def __init__(self, slot: int, step: Optional[int], handle: Future,
                 target_batches: int, min_agreement: float):
        self.slot = slot
        self.step = step
        self.handle = handle
        self.target_batches = target_batches
        self.min_agreement = min_agreement
        self.t_armed = time.perf_counter()
        self.batches = 0
        self.rows = 0
        self.agree_rows = 0
        self.primary_fetch_s = 0.0
        self.shadow_fetch_s = 0.0

    def report(self, swapped: bool, reason: str) -> Dict[str, object]:
        return {
            'swapped': swapped,
            'reason': reason,
            'step': self.step,
            'agreement': (self.agree_rows / self.rows if self.rows
                          else None),
            'batches': self.batches,
            'rows': self.rows,
            'primary_fetch_ms': 1e3 * self.primary_fetch_s
            / max(1, self.batches),
            'shadow_fetch_ms': 1e3 * self.shadow_fetch_s
            / max(1, self.batches),
        }


# --------------------------------------------------------------- engine
class ServingEngine:
    """Micro-batching inference engine over a backend's weights and a
    ladder of CUDA graphs. Build it with ``Code2VecModel.serving_engine()``.

    Thread-safe: ``submit`` may be called from any number of threads; one
    dispatcher thread coalesces, ``decode_workers`` threads decode.

    An engine with a ``param_source`` captures two parameter slots at
    warm-up, so every rollover is capture-free; one built from bare
    parameters captures one, and its first ``load_params`` captures the
    second slot's graphs (``slot_captures``, and in ``stats()``)."""

    def __init__(self, config, backend, params, vocabs,
                 decode_table: np.ndarray,
                 tiers: Optional[Sequence[str]] = None,
                 max_delay_ms: Optional[float] = None,
                 decode_workers: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 queue_bound: Optional[int] = None,
                 canary_batches: Optional[int] = None,
                 canary_agreement: Optional[float] = None,
                 param_source=None,
                 params_step: Optional[int] = None,
                 external_dispatch: bool = False,
                 log=None):
        self.config = config
        # external-dispatch mode: no queue and no dispatcher thread; a
        # mesh feeds dispatch_external() (the mesh is ROADMAP A16)
        self._external = bool(external_dispatch)
        self.backend = backend
        self.device = resolve_device(backend.device)
        self.decode_table = decode_table
        self.log = log if log is not None else (lambda msg: None)
        # predict semantics: rows are never filtered; strings ride along
        # for the attention tiers' decode
        self.reader = PathContextReader(vocabs, config)
        self.wire = config.BATCH_WIRE_FORMAT
        # one device: a data axis of 1
        self.buckets = batch_ladder(config.serving_batch_buckets, 1)
        # capacity rungs per bucket: a bucket's stream holds at most
        # bucket * MAX_CONTEXTS retained slots
        self.capacities: Dict[int, Tuple[int, ...]] = {
            bucket: packed_lib.capacity_ladder(bucket * config.MAX_CONTEXTS)
            for bucket in self.buckets}
        tiers = tuple(tiers if tiers is not None
                      else config.serving_warm_tiers)
        for tier in tiers:
            if tier not in PREDICT_TIERS:
                raise ValueError('unknown tier %r; expected a subset of %s'
                                 % (tier, PREDICT_TIERS))
        self.tiers = tiers
        self.max_delay_s = (max_delay_ms if max_delay_ms is not None
                            else config.SERVING_MAX_DELAY_MS) / 1e3
        deadline_ms = (deadline_ms if deadline_ms is not None
                       else config.SERVING_DEADLINE_MS)
        self.deadline_s = deadline_ms / 1e3 if deadline_ms > 0 else None
        bound = (queue_bound if queue_bound is not None
                 else config.SERVING_QUEUE_BOUND)
        # admission bound in queued rows; None = unbounded (-1), auto (0)
        # = a few fills of the top bucket
        self.queue_bound: Optional[int] = (
            None if bound < 0 else
            8 * self.buckets[-1] if bound == 0 else bound)
        self.canary_batches = (canary_batches
                               if canary_batches is not None
                               else config.SERVING_CANARY_BATCHES)
        self.canary_agreement = (canary_agreement
                                 if canary_agreement is not None
                                 else config.SERVING_CANARY_AGREEMENT)
        self.canary_timeout_s = config.SERVING_CANARY_TIMEOUT_SECS
        # resolves load_params(step|path) and newest_step() polls; None
        # on engines built from bare parameters
        self._param_source = param_source
        # parameter slots captured at warm-up: an engine that can roll
        # over to checkpoints keeps the idle slot warm from the start
        self.param_slots = 2 if param_source is not None else 1
        workers = (decode_workers if decode_workers is not None
                   else config.SERVING_DECODE_WORKERS)
        self.ladder = GraphLadder(backend, self.wire, self.buckets,
                                  self.capacities, self.tiers,
                                  backend.to_compute(params),
                                  ring_depth=max(1, workers) + 2)
        self.latency = Timer('serving/latency_ms')
        self.dispatch_timer = Timer('serving/dispatch_ms')
        self.decode_timer = Timer('serving/decode_ms')
        self.requests_total = Counter('serving/requests_total')
        self.batches_total = Counter('serving/batches_total')
        self.rows_total = Counter('serving/rows_total')
        self.queue_depth = Gauge('serving/queue_depth')
        self.fill_rate = Gauge('serving/batch_fill_rate')
        self.shed_total = Counter('serving/shed_total')
        self.expired_total = Counter('serving/expired_total')
        self.degraded_total = Counter('serving/degraded_total')
        self.overload_level_gauge = Gauge('serving/overload_level')
        self.rollover_total = Counter('serving/rollover_total')
        self.rollover_rollbacks_total = Counter(
            'serving/rollover_rollbacks_total')
        self.rollover_agreement = Gauge('serving/rollover_agreement')
        self.last_dispatch: Optional[Dict[str, int]] = None
        self.warmup_s: Optional[float] = None
        # graphs captured by warmup(), and by a one-slot engine's first
        # load_params
        self.warm_captures = 0
        self.slot_captures = 0
        # submitters, the dispatcher, decode workers, load_params and
        # close() share the queue / rollover / overload state; _cond wraps
        # _lock
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues: Dict[str, collections.deque] = {
            tier: collections.deque() for tier in PREDICT_TIERS}
        self._pending_rows: Dict[str, int] = {t: 0 for t in PREDICT_TIERS}
        # rows admitted but not yet enqueued (tokenizing on the caller's
        # thread), counted against the bound
        self._reserved_rows = 0
        self._closed = False
        self._drain = False
        self._serving_slot = 0
        self._rollover: Optional[_Rollover] = None
        self._loading = False   # a load_params is filling the idle slot
        # the retained step the serving parameters came from: the
        # follow-checkpoints baseline
        self._params_step: Optional[int] = params_step
        self._overload_level = 0
        self._peak_rows = 0
        self._service_rows_per_s = 0.0
        self._service_window: collections.deque = collections.deque()
        self._service_window_rows = 0
        self._warm = False
        self._warm_lock = threading.Lock()
        self._follow_thread: Optional[threading.Thread] = None
        self._follow_stop = threading.Event()
        self._decode_pool = ThreadPoolExecutor(
            max_workers=max(1, workers),
            thread_name_prefix='serving-decode')
        if self._external:
            self._dispatcher: Optional[threading.Thread] = None
        else:
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, daemon=True,
                name='serving-dispatch')
            self._dispatcher.start()

    @property
    def params(self):
        """The serving slot's compute-dtype parameters."""
        with self._lock:
            slot = self._serving_slot
        return self.ladder.slots[slot]

    # ---------------------------------------------------------- warmup
    def warmup(self) -> 'ServingEngine':
        """Capture every (bucket x rung x tier) graph of the ladder for
        each parameter slot, so steady-state ``submit`` traffic and every
        rollover capture nothing. On the CPU the same keys are planned and
        nothing is captured. Idempotent; the first ``submit`` calls it if
        it was skipped."""
        with self._warm_lock:
            if self._warm:
                return self
            t0 = time.perf_counter()
            if set(self.tiers) & {'topk', 'vectors'}:
                # built and loaded here, not at the first request (a
                # failed build raises, naming READER_USE_NATIVE)
                self.reader.native_tokenizer()
            slots = max(self.param_slots, len(self.ladder.slots))
            self.warm_captures = self.ladder.warm(slots)
            self.warmup_s = time.perf_counter() - t0
            self.log('serving: %d ladder keys (buckets %s x tiers %s, %s '
                     'wire) x %d parameter slots: %d graphs captured in '
                     '%.1fs'
                     % (len(self.ladder.keys()), list(self.buckets),
                        list(self.tiers), self.wire, slots,
                        self.warm_captures, self.warmup_s))
            self._warm = True
        return self

    # ------------------------------------------------------- admission
    def _shed_locked(self, rows: int, why: str) -> None:
        """Reject one submission at admission (typed, nothing enqueued)."""
        self.shed_total.inc()
        raise EngineOverloaded(
            'request shed at admission (%s): %d rows, %d rows queued, '
            'bound %s — retry against another replica or back off'
            % (why, rows, self._admitted_rows_locked(), self.queue_bound))

    def _admitted_rows_locked(self) -> int:
        return sum(self._pending_rows.values()) + self._reserved_rows

    def _admit(self, rows: int, tier: str,
               deadline_s: Optional[float]) -> str:
        """Admission control for one submission: the bound, the drain
        estimate against the deadline, the degradation ladder. Reserves
        ``rows`` against the bound and returns the tier to serve."""
        with self._cond:
            if self._closed:
                raise EngineClosed('ServingEngine is closed')
            if faults.maybe_fire('reject_all'):
                self._shed_locked(rows, 'reject_all drill')
            admitted = self._admitted_rows_locked()
            bound = self.queue_bound
            if bound_rejects(admitted, rows, bound):
                self._shed_locked(rows, 'queue bound')
            if deadline_s is not None and self._service_rows_per_s > 0:
                drain_s = (admitted + rows) / self._service_rows_per_s
                if drain_s > deadline_s:
                    self._shed_locked(
                        rows, 'drain estimate %.0fms > deadline %.0fms'
                        % (1e3 * drain_s, 1e3 * deadline_s))
            level, effective = overload_tier(
                admitted, rows, bound, self._overload_level, tier,
                self.tiers)
            if level != self._overload_level:
                self._overload_level = level
                self.overload_level_gauge.set(level)
            if effective != tier:
                self.degraded_total.inc()
            self._reserved_rows += rows
            self._peak_rows = max(self._peak_rows,
                                  self._admitted_rows_locked())
        return effective

    # ---------------------------------------------------------- submit
    def submit(self, context_lines: Sequence[str], tier: str = 'topk',
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one prediction request (raw ``.c2v`` context lines, as
        ``Code2VecModel.predict`` takes). Returns a Future of one
        ``ModelPredictionResults`` per line, in order; requests larger
        than the top bucket are split. ``deadline_ms`` overrides the
        default SLO deadline (0 = none)."""
        if self._external:
            raise RuntimeError(
                'this engine is in external-dispatch mode; feed it '
                'through dispatch_external()')
        if tier not in self.tiers:
            raise ValueError('tier %r is not warmed on this engine '
                             '(tiers=%s)' % (tier, list(self.tiers)))
        if self._closed:
            raise EngineClosed('ServingEngine is closed')
        lines = canonicalize_contexts(context_lines,
                                      self.config.MAX_CONTEXTS)
        future: Future = Future()
        if not lines:
            future.set_result([])
            return future
        if not self._warm:
            self.warmup()
        n = len(lines)
        if deadline_ms is None:
            deadline_s = self.deadline_s
        else:
            deadline_s = deadline_ms / 1e3 if deadline_ms > 0 else None
        self.requests_total.inc()
        tier = self._admit(n, tier, deadline_s)  # raises typed on shed
        try:
            requests = tokenize_and_chunk(self.reader, lines, tier, future,
                                          deadline_s, self.buckets[-1])
        except BaseException:
            with self._cond:
                self._reserved_rows -= n
            raise
        with self._cond:
            self._reserved_rows -= n
            if self._closed:
                raise EngineClosed('ServingEngine is closed')
            for request in requests:
                self._queues[tier].append(request)
                self._pending_rows[tier] += request.rows
            self._set_queue_depth_locked()
            self._cond.notify_all()
        return future

    def predict(self, context_lines: Sequence[str], tier: str = 'topk',
                timeout: Optional[float] = None) -> list:
        """Synchronous ``submit().result()``."""
        return self.submit(context_lines, tier).result(timeout)

    # -------------------------------------------------------- neighbors
    def attach_index(self, index) -> 'ServingEngine':
        raise NotImplementedError(
            'the embedding index is not ported yet (ROADMAP A8)')

    def submit_neighbors(self, context_or_vectors, k: Optional[int] = None
                         ) -> Future:
        raise NotImplementedError(
            'the embedding index is not ported yet (ROADMAP A8)')

    def predict_neighbors(self, context_or_vectors,
                          k: Optional[int] = None,
                          timeout: Optional[float] = None) -> list:
        raise NotImplementedError(
            'the embedding index is not ported yet (ROADMAP A8)')

    # -------------------------------------------------------- rollover
    def _check_rollover_clear_locked(self) -> None:
        if self._closed:
            raise EngineClosed('ServingEngine is closed')
        if self._rollover is not None or self._loading:
            raise RuntimeError(
                'a rollover is already in flight (step %s); await '
                'its handle first'
                % (self._rollover.step if self._rollover else '?'))

    def _fill_idle_slot(self, params) -> int:
        """Copy ``params`` into the idle parameter slot (the caller set
        ``_loading``); a one-slot engine allocates its second slot here
        and, once warm, captures that slot's graphs. Returns the slot."""
        candidate = self.backend.to_compute(params)
        with _DISPATCH_ENQUEUE_LOCK:
            with self._lock:
                idle = 1 - self._serving_slot
            created, done = self.ladder.load_slot(idle, candidate)
        if done is not None:
            done.synchronize()
        if created and self._warm:
            captured = self.ladder.warm(2)
            self.slot_captures += captured
            if captured:
                self.log('serving: captured %d graphs for a second '
                         'parameter slot (engine built with one)'
                         % captured)
        return idle

    def load_params(self, source, canary_batches: Optional[int] = None,
                    min_agreement: Optional[float] = None) -> Future:
        """Canaried rollover. ``source`` is a retained checkpoint step
        (int) or a model path (str), both resolved through the engine's
        param source, or a parameter set (``Code2VecParams``). The
        candidate is copied into the idle parameter slot; with
        ``canary_batches > 0`` (default SERVING_CANARY_BATCHES) the next
        live batches are replayed on both slots, and the serving slot
        flips once top-1 agreement over the canaried rows clears
        ``min_agreement`` (default SERVING_CANARY_AGREEMENT), else the
        candidate is dropped; 0 swaps at once. Returns a Future of the
        report (``{'swapped': bool, 'agreement': ..., ...}``)."""
        handle: Future = Future()
        step: Optional[int] = None
        n_canary = (canary_batches if canary_batches is not None
                    else self.canary_batches)
        floor = (min_agreement if min_agreement is not None
                 else self.canary_agreement)
        with self._cond:
            self._check_rollover_clear_locked()
            self._loading = True
        try:
            if isinstance(source, (int, str)) and \
                    not isinstance(source, bool):
                if self._param_source is None:
                    raise RuntimeError(
                        'load_params(%r): this engine has no param source '
                        '— build it via model.serving_engine(), or pass '
                        'a parameter set' % (source,))
                if isinstance(source, int):
                    step = source
                params = self._param_source.load(source)
            else:
                params = source
            if n_canary > 0 and all(t == 'vectors' for t in self.tiers):
                # the canary compares top-1 predictions, which the
                # vectors tier does not produce
                raise RuntimeError(
                    'canaried rollover needs a top-k-producing tier warmed '
                    '(tiers=%s are vectors-only); pass canary_batches=0 to '
                    'swap without a canary, or warm a topk tier'
                    % list(self.tiers))
            slot = self._fill_idle_slot(params)
            report = None
            with self._cond:
                if self._closed:
                    raise EngineClosed('ServingEngine is closed')
                rollover = _Rollover(slot, step, handle, n_canary, floor)
                if n_canary <= 0:
                    # counted with the swap: a reader of stats() never
                    # sees the new step without its rollover
                    self._serving_slot = slot
                    if step is not None:
                        self._params_step = step
                    self.rollover_total.inc()
                    report = rollover.report(True, 'no canary configured')
                else:
                    self._rollover = rollover
        finally:
            with self._cond:
                self._loading = False
        if report is not None:
            self.log('serving: params swapped without canary (step %s)'
                     % step)
            handle.set_result(report)
        else:
            self.log('serving: rollover armed (step %s): canarying %d '
                     'live batches, agreement floor %.2f'
                     % (step, n_canary, floor))
        return handle

    def adopt_params(self, params, step: Optional[int] = None) -> None:
        """Swap the serving parameters with no canary: the fleet-swap leg
        of a coordinated rollover, whose canary ran elsewhere. Refuses
        while a rollover is in flight."""
        with self._cond:
            self._check_rollover_clear_locked()
            self._loading = True
        try:
            slot = self._fill_idle_slot(params)
            with self._cond:
                if self._closed:
                    raise EngineClosed('ServingEngine is closed')
                self._serving_slot = slot
                if step is not None:
                    self._params_step = step
        finally:
            with self._cond:
                self._loading = False

    def _count_rollover(self, swapped: bool,
                        agreement: Optional[float]) -> None:
        if swapped:
            self.rollover_total.inc()
        else:
            self.rollover_rollbacks_total.inc()
        if agreement is not None:
            self.rollover_agreement.set(agreement)

    def _observe_canary(self, rollover: _Rollover, agree_rows: int,
                        rows: int, primary_s: float,
                        shadow_s: float) -> None:
        """Tally one shadow-scored batch; decide once the canary target is
        reached (decode worker)."""
        decided = None
        with self._cond:
            if self._rollover is not rollover:
                return  # already decided (or cleared by close)
            rollover.batches += 1
            rollover.rows += rows
            rollover.agree_rows += agree_rows
            rollover.primary_fetch_s += primary_s
            rollover.shadow_fetch_s += shadow_s
            if rollover.batches >= rollover.target_batches:
                agreement = rollover.agree_rows / max(1, rollover.rows)
                swapped = agreement >= rollover.min_agreement
                if swapped:
                    self._serving_slot = rollover.slot
                    if rollover.step is not None:
                        self._params_step = rollover.step
                self._rollover = None
                self._count_rollover(swapped, agreement)
                decided = (swapped, agreement)
        if decided is not None:
            swapped, agreement = decided
            reason = ('canary passed' if swapped else
                      'agreement %.3f below floor %.2f'
                      % (agreement, rollover.min_agreement))
            self.log('serving: rollover %s (step %s): top-1 agreement '
                     '%.3f over %d rows in %d batches'
                     % ('SWAPPED' if swapped else 'ROLLED BACK',
                        rollover.step, agreement, rollover.rows,
                        rollover.batches))
            _resolve(rollover.handle, rollover.report(swapped, reason))

    def _fail_rollover(self, rollover: Optional[_Rollover],
                       exc: BaseException) -> None:
        if rollover is None:
            return
        with self._cond:
            if self._rollover is rollover:
                self._rollover = None
            elif rollover.handle.done():
                return
        if not rollover.handle.done():
            try:
                rollover.handle.set_exception(exc)
            except Exception:
                pass

    def follow_checkpoints(self, poll_secs: Optional[float] = None
                           ) -> 'ServingEngine':
        """Poll the checkpoint store for a newer retained step and roll it
        in through the canary (``--serve-follow-checkpoints``). Needs the
        engine's param source; idempotent."""
        if self._external:
            raise RuntimeError(
                'this engine is in external-dispatch mode; its feeder '
                'follows the checkpoints')
        if self._param_source is None:
            raise RuntimeError('follow_checkpoints needs a param source '
                               '(build the engine via '
                               'model.serving_engine())')
        poll = (poll_secs if poll_secs is not None
                else self.config.SERVE_FOLLOW_CHECKPOINTS_SECS)
        if poll <= 0:
            raise ValueError('follow_checkpoints needs poll_secs > 0 '
                             '(got %r)' % poll)
        with self._lock:
            if self._closed:
                raise EngineClosed('ServingEngine is closed')
            if self._follow_thread is not None:
                return self
            self._follow_thread = threading.Thread(
                target=self._follow_loop, args=(poll,), daemon=True,
                name='serving-follow')
            self._follow_thread.start()
        return self

    def _follow_loop(self, poll_secs: float) -> None:
        attempted: Optional[int] = None  # this thread's memory only
        while not self._follow_stop.wait(poll_secs):
            try:
                newest = self._param_source.newest_step()
                with self._cond:
                    if self._closed:
                        return
                    busy = self._rollover is not None or self._loading
                    current = self._params_step
                if newest is None or busy:
                    continue
                if attempted is not None and newest <= attempted:
                    continue  # don't hot-loop a rolled-back step
                if current is not None and newest <= current:
                    continue
                self.log('serving: follow-checkpoints found step %d; '
                         'starting canaried rollover' % newest)
                self.load_params(newest)
                # marked once the restore and arm succeeded: a transient
                # load failure leaves the step eligible for the next poll
                attempted = newest
            except EngineClosed:
                return
            except Exception as exc:  # the poller survives blips
                self.log('serving: follow-checkpoints poll failed: %s'
                         % exc)

    def _set_queue_depth_locked(self) -> None:
        self.queue_depth.set(sum(len(q) for q in self._queues.values()))

    # ------------------------------------------------------ dispatcher
    def _dispatch_loop(self) -> None:
        while True:
            abandoned: List[_Request] = []
            with self._cond:
                while not self._closed and \
                        not any(self._queues[t] for t in PREDICT_TIERS):
                    self._cond.wait()
                if self._closed and not self._drain:
                    # fail-fast close: every queued future fails typed
                    for t in PREDICT_TIERS:
                        abandoned.extend(self._queues[t])
                        self._queues[t].clear()
                        self._pending_rows[t] = 0
                    self._set_queue_depth_locked()
                done = self._closed and \
                    not any(self._queues[t] for t in PREDICT_TIERS)
            if abandoned or done:
                for request in abandoned:
                    request.fail(EngineClosed(
                        'ServingEngine closed with the request still '
                        'queued (close(drain=True) serves the queue '
                        'first)'))
                if done:
                    return
                continue
            with self._cond:
                if not any(self._queues[t] for t in PREDICT_TIERS):
                    continue  # raced a drain-close or expiry
                # serve the tier whose head request has waited longest
                tier = min(
                    (t for t in PREDICT_TIERS if self._queues[t]),
                    key=lambda t: self._queues[t][0].t_enqueue)
                deadline = (self._queues[tier][0].t_enqueue
                            + self.max_delay_s)
                max_bucket = self.buckets[-1]
                while not self._closed:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0 or \
                            self._pending_rows[tier] >= max_bucket:
                        break
                    self._cond.wait(remaining)
                if self._closed and not self._drain:
                    continue  # the requests fail typed at the loop's top
                taken: List[_Request] = []
                expired: List[_Request] = []
                rows = 0
                now = time.perf_counter()
                queue = self._queues[tier]
                while queue and rows + queue[0].rows <= max_bucket:
                    request = queue.popleft()
                    if request.t_deadline is not None \
                            and now >= request.t_deadline:
                        # the client's SLO passed while it queued
                        expired.append(request)
                        self._pending_rows[tier] -= request.rows
                        continue
                    taken.append(request)
                    rows += request.rows
                self._pending_rows[tier] -= rows
                self._set_queue_depth_locked()
            for request in expired:
                self.expired_total.inc()
                request.fail(DeadlineExceeded(
                    'request expired after %.0fms in queue (SLO '
                    'deadline %.0fms)'
                    % (1e3 * (now - request.t_enqueue),
                       1e3 * (request.t_deadline - request.t_enqueue))))
            if taken:
                try:
                    self._dispatch_batch(tier, taken, rows)
                except BaseException as exc:  # keep the dispatcher alive
                    for request in taken:
                        request.fail(exc)

    def dispatch_external(self, tier: str, taken: List[_Request],
                          rows: int) -> None:
        """External-dispatch hook: ship one coalesced micro-batch popped
        from a queue outside the engine. A failure fails every member
        request typed and is raised again for the caller's breaker."""
        try:
            self._dispatch_batch(tier, taken, rows)
        except BaseException as exc:
            for request in taken:
                request.fail(exc)
            raise

    def _pad_planes(self, batches: Sequence[Batch], bucket: int) -> Batch:
        """The numeric planes of ``batches`` back to back, padded to
        ``bucket`` rows with zero-weight all-PAD rows (the host arrays
        ``reader.pad_batch_to`` of their concatenation gives, without the
        strings: each request decodes from its own batch)."""
        contexts = self.config.MAX_CONTEXTS
        token_pad = self.backend.token_pad_index
        out = Batch(
            source=np.full((bucket, contexts), token_pad, np.int32),
            path=np.full((bucket, contexts), self.backend.path_pad_index,
                         np.int32),
            target=np.full((bucket, contexts), token_pad, np.int32),
            mask=np.zeros((bucket, contexts), np.float32),
            label=np.zeros((bucket,), np.int32),
            weight=np.zeros((bucket,), np.float32))
        row = 0
        for batch in batches:
            n = batch.label.shape[0]
            for dst, src in zip(out, batch[:6]):
                dst[row:row + n] = src
            row += n
        return out

    def _pack_padded(self, padded: Batch, bucket: int
                     ) -> Tuple[tuple, int]:
        """Pad-complete plane batch -> packed wire arrays on a capacity
        rung of the ladder: ``(arrays, capacity)``."""
        ctx_rows, lengths = packed_lib.ragged_from_planes(
            padded.source, padded.path, padded.target, padded.mask)
        capacity = pick_bucket(int(lengths.sum()), self.capacities[bucket])
        ctx = packed_lib.pack_ragged(
            ctx_rows, lengths, self.backend.token_pad_index,
            self.backend.path_pad_index, capacity_minimum=capacity)
        return (ctx, lengths, np.ascontiguousarray(padded.label),
                np.ascontiguousarray(padded.weight)), capacity

    def _dispatch_batch(self, tier: str, taken: List[_Request],
                        rows: int) -> None:
        t0 = time.perf_counter()
        if faults.maybe_fire('slow_dispatch'):
            # deterministic overload: the queue fills while the
            # dispatcher stalls here
            time.sleep(faults.SLOW_DISPATCH_SECONDS)
        bucket = pick_bucket(rows, self.buckets)
        padded = self._pad_planes([r.batch for r in taken], bucket)
        if self.wire == 'packed':
            host_arrays, capacity = self._pack_padded(padded, bucket)
        else:
            host_arrays, capacity = padded.device_arrays(), 0
        staged = self.ladder.stage(bucket, capacity, tier, host_arrays,
                                   shadow=(self._rollover is not None
                                           and tier != 'vectors'))
        stale = None
        try:
            with _DISPATCH_ENQUEUE_LOCK:
                with self._lock:
                    slot = self._serving_slot
                    rollover = self._rollover
                    if rollover is not None and self.canary_timeout_s > 0 \
                            and time.perf_counter() - rollover.t_armed \
                            >= self.canary_timeout_s:
                        # checked on every tier's dispatches: traffic of
                        # the vectors tier alone scores no top-1, and the
                        # canary would wedge every later rollover
                        self._rollover = None
                        self._count_rollover(False, None)
                        stale, rollover = rollover, None
                if tier == 'vectors':
                    rollover = None
                fetch, shadow = self.ladder.launch(
                    staged, slot,
                    rollover.slot if rollover is not None else None)
        except BaseException:
            self.ladder.abandon(staged)
            raise
        if shadow is None:
            rollover = None
        if stale is not None:
            self.log('serving: rollover ROLLED BACK (step %s): canary '
                     'timed out after %.0fs with %d/%d batches scored'
                     % (stale.step, self.canary_timeout_s,
                        stale.batches, stale.target_batches))
            _resolve(stale.handle, stale.report(
                False, 'canary timed out after %.0fs'
                % self.canary_timeout_s))
        t_disp = time.perf_counter()
        self.dispatch_timer.record(t_disp - t0)
        self.batches_total.inc()
        self.rows_total.inc(rows)
        self.fill_rate.set(rows / bucket)
        self.last_dispatch = {'bucket': bucket, 'rows': rows,
                              'capacity': capacity,
                              'requests': len(taken)}
        self._decode_pool.submit(self._decode, fetch, shadow, rollover,
                                 taken)

    # ----------------------------------------------------------- decode
    def _decode(self, fetch: Fetch, shadow: Optional[Fetch],
                rollover: Optional[_Rollover],
                taken: List[_Request]) -> None:
        n_rows = sum(request.rows for request in taken)
        try:
            t0 = time.perf_counter()
            # waits for the batch's copy to the host (the worker's job,
            # never the dispatcher's)
            fetched = fetch.result()
            fetch_s = time.perf_counter() - t0
            results, row = [], 0
            for request in taken:
                # each request decodes from its own batch (its strings)
                results.append(decode_results(
                    {key: value[row:row + request.rows]
                     for key, value in fetched.items()},
                    request.batch, request.rows, self.decode_table))
                row += request.rows
            self.decode_timer.record(time.perf_counter() - t0)
            now = time.perf_counter()
            for request, result in zip(taken, results):
                request.deliver(result)
                self.latency.record(now - request.t_enqueue)
            self._note_service(n_rows, taken)
        except BaseException as exc:
            fetch.release()
            if shadow is not None:
                shadow.release()
            for request in taken:
                request.fail(exc)
            return
        if shadow is not None:
            # the canary's tally after the callers got their answers
            try:
                t1 = time.perf_counter()
                shadow_top = shadow.result()['topk_indices']
                shadow_s = time.perf_counter() - t1
                agree = int(np.sum(fetched['topk_indices'][:n_rows, 0]
                                   == shadow_top[:n_rows, 0]))
                self._observe_canary(rollover, agree, n_rows, fetch_s,
                                     shadow_s)
            except BaseException as exc:
                self._fail_rollover(rollover, exc)

    def _note_service(self, rows: int, taken: List[_Request]) -> None:
        """Feed the drain estimate with the rows delivered over a sliding
        window of batch completions (``note_service_window``)."""
        oldest = min(request.t_enqueue for request in taken)
        with self._lock:
            self._service_window_rows, self._service_rows_per_s = \
                note_service_window(
                    self._service_window, self._service_window_rows,
                    self._service_rows_per_s, rows, oldest)

    # -------------------------------------------------------- lifecycle
    def stats(self) -> Dict[str, object]:
        """Snapshot of the engine's instruments (latency percentiles over
        the timers' windows) and of its ladder: graph captures (at
        warm-up, for a second slot, and after warm-up) and replays."""
        with self._lock:
            peak_rows = self._peak_rows
            params_step = self._params_step
            serving_slot = self._serving_slot
        ladder = self.ladder.stats()
        return {
            'requests_total': self.requests_total.snapshot(),
            'batches_total': self.batches_total.snapshot(),
            'rows_total': self.rows_total.snapshot(),
            'queue_depth': self.queue_depth.snapshot(),
            'batch_fill_rate': self.fill_rate.snapshot(),
            'latency_ms': self.latency.snapshot(),
            'dispatch_ms': self.dispatch_timer.snapshot(),
            'decode_ms': self.decode_timer.snapshot(),
            'last_dispatch': self.last_dispatch,
            'shed_total': self.shed_total.snapshot(),
            'expired_total': self.expired_total.snapshot(),
            'degraded_total': self.degraded_total.snapshot(),
            'overload_level': self.overload_level_gauge.snapshot(),
            'queue_peak_rows': peak_rows,
            'rollover_total': self.rollover_total.snapshot(),
            'rollover_rollbacks_total':
                self.rollover_rollbacks_total.snapshot(),
            'params_step': params_step,
            'serving_slot': serving_slot,
            'warmup_s': self.warmup_s,
            'graph_captures': ladder['captures_total'],
            'graph_captures_after_warmup': (ladder['captures_total']
                                            - self.warm_captures),
            'graph_replays': ladder['replays_total'],
            'ladder': ladder,
        }

    def close(self, drain: bool = False) -> None:
        """Stop the engine: new ``submit`` calls raise ``EngineClosed``.

        The default close fails every still-queued request's future with
        a typed ``EngineClosed`` (batches already dispatched still
        deliver); ``close(drain=True)`` serves everything admitted first.
        An armed rollover's handle fails with ``EngineClosed`` either way.
        Idempotent; every caller waits for the shutdown, after which the
        ladder's graphs, slots and buffers are released."""
        with self._cond:
            already = self._closed
            if not already:
                self._closed = True
                self._drain = drain
            rollover, self._rollover = self._rollover, None
            self._cond.notify_all()
        self._follow_stop.set()
        if rollover is not None and not rollover.handle.done():
            try:
                rollover.handle.set_exception(EngineClosed(
                    'ServingEngine closed mid-canary (step %s)'
                    % rollover.step))
            except Exception:
                pass
        follow = self._follow_thread
        if follow is not None:
            follow.join()
        if self._dispatcher is not None:
            self._dispatcher.join()
        self._decode_pool.shutdown(wait=True)
        self.ladder.close()

    def __enter__(self) -> 'ServingEngine':
        return self

    def __exit__(self, *exc) -> None:
        self.close()
