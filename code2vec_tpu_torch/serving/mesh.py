"""The serving mesh in thread mode: N ``ServingEngine`` replicas on the
one card behind one shared front queue (the port of
``code2vec_tpu/serving/mesh.py``'s thread mode).

- **One shared front queue** (``serving/frontqueue.py``): admission (the
  bound, the deadline against the fleet's drain estimate, the
  degradation ladder) happens once for the fleet, so one slow replica
  never strands its share of the traffic.
- **Replica pullers.** Each replica runs one puller thread that claims
  a coalesced micro-batch from the shared queue whenever the replica has
  a free in-flight slot, and dispatches it through its own engine
  (``dispatch_external``): the engine packs it onto the smallest
  covering (bucket x rung x tier) key and replays that key's CUDA graph.
  Predict tiers and ``submit_neighbors``' vectors traffic ride one
  stream of dispatches.
- **Replica-aware weighting.** The replica table keeps each replica's
  in-flight window, a dispatch breaker (``MESH_BREAKER_THRESHOLD``
  consecutive failures open it; after the cooldown one half-open probe
  batch decides) and retirement: a breaker-open or retired replica stops
  pulling and the queue goes to its siblings. The replica canarying a
  rollover pulls with half its window.
- **Memo and SLO tiers.** The exact and semantic memo tiers
  (``serving/memo.py``) are checked at submit, before admission; the
  SLO monitor (``serving/slo.py``) watches the fleet's completions.
- **Coordinated rollover.** ``load_params(step|path|params)`` canaries
  on one replica (the engine's shadow scoring), then on agreement every
  other replica adopts the same parameters (``engine.adopt_params``),
  or the canary rolls back and every replica keeps the old ones.
  ``follow_checkpoints`` runs here, once for the fleet.

Where the port differs from the JAX design: a JAX thread replica shares
the trainer's jit cache and adopts a swap by pointing at the canary's
pytree. A CUDA graph reads fixed addresses from one pool on one stream
(``serving/graphs.py``), and two threads replaying the same graphs would
race on their static inputs and their pool. So each replica here is an
engine with its own ``GraphLadder``: its own stream, its own graph pool
and its own two parameter slots, captured at its warm-up. A fleet swap
copies the canary's parameters into each sibling's idle slot
(``adopt_params``: a ``copy_`` on the sibling's stream, enqueued after
its in-flight replays; no capture). Replicas overlap on the card only
through their streams; nothing on the dispatch path synchronizes.

The worker modes (``'process'``, ``'socket'``: ``transport.py``, the
supervisor, liveness, adoption, placement), the autoscaler,
``submit_blended``, ``rollover_index`` and ``record_traffic`` are not
here (ROADMAP A16b); ``mode`` accepts ``'thread'`` only.
"""
from __future__ import annotations

import collections
import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

from code2vec_tpu_torch.data.reader import (PathContextReader,
                                            canonicalize_contexts)
from code2vec_tpu_torch.serving import engine as engine_lib
from code2vec_tpu_torch.serving import memo as memo_lib
from code2vec_tpu_torch.serving import slo as slo_lib
from code2vec_tpu_torch.serving.engine import (ServingEngine, _Request,
                                               _resolve)
from code2vec_tpu_torch.serving.errors import (DeadlineExceeded, EngineClosed,
                                               EngineOverloaded, ReplicaDead)
from code2vec_tpu_torch.serving.frontqueue import FrontQueue
from code2vec_tpu_torch.serving.steps import PREDICT_TIERS
from code2vec_tpu_torch.telemetry import catalog
from code2vec_tpu_torch.telemetry import core as tele_core
from code2vec_tpu_torch.telemetry import tracing as tracing_lib
from code2vec_tpu_torch.telemetry.core import Counter, Gauge

logger = logging.getLogger(__name__)

#: replica dispatch-breaker states (the reference's numbering)
_BREAKER_CLOSED = 0
_BREAKER_HALF_OPEN = 1
_BREAKER_OPEN = 2


class _ReplicaSlot:
    """One row of the replica table: the replica, its puller and the
    dispatch accounting the weighting reads. Every mutable field is
    guarded by the mesh's ``_cond`` (the puller, the decode-completion
    hook, rollover and retirement all touch them)."""

    __slots__ = ('rid', 'transport', 'thread', 'retired', 'retired_reason',
                 'inflight', 'rows_dispatched', 'batches', 'breaker_fails',
                 'breaker_state', 'breaker_open_until', 'canarying')

    def __init__(self, rid: str, transport: '_ThreadReplica'):
        self.rid = rid
        self.transport = transport
        self.thread: Optional[threading.Thread] = None
        self.retired = False
        self.retired_reason: Optional[str] = None
        self.inflight = 0
        self.rows_dispatched = 0
        self.batches = 0
        self.breaker_fails = 0
        self.breaker_state = _BREAKER_CLOSED
        self.breaker_open_until = 0.0
        self.canarying = False


class _ThreadReplica:
    """An in-process replica: a ``ServingEngine`` in external-dispatch
    mode over its own ladder of CUDA graphs, called directly."""

    mode = 'thread'

    def __init__(self, engine: ServingEngine):
        self.engine = engine

    def dispatch(self, tier: str, taken: List[_Request], rows: int) -> None:
        self.engine.dispatch_external(tier, taken, rows)

    def warmup(self) -> None:
        self.engine.warmup()

    def load_params(self, source, canary_batches: int,
                    min_agreement: float) -> Future:
        return self.engine.load_params(source,
                                       canary_batches=canary_batches,
                                       min_agreement=min_agreement)

    def adopt(self, params, step: Optional[int]) -> None:
        # the canary's validated parameters copied into this replica's
        # idle slot, then served (its graphs read its own slots)
        self.engine.adopt_params(params, step=step)

    def stats(self) -> Dict[str, object]:
        return self.engine.stats()

    def close(self) -> None:
        self.engine.close()


class ServingMesh:
    """N engine replicas behind one shared front queue. Build it with
    ``Code2VecModel.serving_mesh()``. Thread-safe, with the single
    engine's surface (``submit`` / ``predict`` / ``submit_neighbors`` /
    ``load_params`` / ``follow_checkpoints`` / ``close``)."""

    # the replica table, the fleet's service window, the rollover slot and
    # the close flags are shared by submitters, the pullers, the decode
    # hooks and control calls under _lock (_cond wraps it). Lock order:
    # the queue's lock, then the mesh's (admit and pop_coalesced call back
    # into the mesh); the mesh's lock is never held while taking the
    # queue's
    def __init__(self, model, replicas: Optional[int] = None,
                 tiers: Optional[Sequence[str]] = None,
                 mode: Optional[str] = None,
                 max_delay_ms: Optional[float] = None,
                 deadline_ms: Optional[float] = None,
                 queue_bound: Optional[int] = None,
                 max_inflight: Optional[int] = None,
                 breaker_threshold: Optional[int] = None,
                 breaker_cooldown_secs: Optional[float] = None,
                 canary_batches: Optional[int] = None,
                 canary_agreement: Optional[float] = None,
                 params_step: Optional[int] = None,
                 param_source=None,
                 memo_cache_bytes: Optional[int] = None,
                 memo_semantic_epsilon: Optional[float] = None,
                 tracer: Optional[tracing_lib.Tracer] = None,
                 tracing_sample_rate: Optional[float] = None,
                 log=None):
        config = model.config
        self.config = config
        self.log = log if log is not None else logger.info
        n = int(replicas if replicas is not None else config.MESH_REPLICAS)
        if n < 1:
            raise ValueError('a mesh needs >= 1 replica, got %d' % n)
        self.mode = mode if mode is not None else 'thread'
        if self.mode != 'thread':
            raise ValueError(
                'the port serves the mesh in thread mode only (got mode '
                '%r); the worker modes come with ROADMAP A16b'
                % (self.mode,))
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
        self.max_inflight = max(1, int(max_inflight if max_inflight
                                       is not None
                                       else config.MESH_MAX_INFLIGHT))
        self.breaker_threshold = max(1, int(
            breaker_threshold if breaker_threshold is not None
            else config.MESH_BREAKER_THRESHOLD))
        self.breaker_cooldown_s = float(
            breaker_cooldown_secs if breaker_cooldown_secs is not None
            else config.MESH_BREAKER_COOLDOWN_SECS)
        self.canary_batches = (canary_batches if canary_batches is not None
                               else config.SERVING_CANARY_BATCHES)
        self.canary_agreement = (canary_agreement
                                 if canary_agreement is not None
                                 else config.SERVING_CANARY_AGREEMENT)
        # the submit-side tokenizer and ladder geometry, the replicas'
        # own: what makes a result through the mesh bit-identical to a
        # single engine's
        self._reader = PathContextReader(model.vocabs, config)
        self.buckets = engine_lib.batch_ladder(config.serving_batch_buckets,
                                               1)
        bound = (queue_bound if queue_bound is not None
                 else config.MESH_QUEUE_BOUND)
        # the auto bound grows with the fleet
        self.queue_bound: Optional[int] = (
            None if bound < 0 else
            n * 8 * self.buckets[-1] if bound == 0 else bound)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self._drain = False
        self._rollover: Optional[Dict[str, object]] = None
        self._rows_total = 0
        # the fleet's service window: the engine's estimator, fed by every
        # replica's completions
        self._service_rows_per_s = 0.0
        self._service_window: collections.deque = collections.deque()
        self._service_window_rows = 0
        # resolves load_params(step|path) and the follow poller: the
        # model's checkpoints unless the caller brings its own
        self._param_source = (param_source if param_source is not None
                              else model._serving_param_source())
        if params_step is not None:
            self._params_step: Optional[int] = params_step
        elif model.state is not None:
            self._params_step = int(model.state.step)
        elif self._param_source is not None:
            self._params_step = self._param_source.newest_step()
        else:
            self._params_step = None
        # whether a fleet swap moved the replicas off the model's
        # parameters (a replica added later then adopts the fleet's)
        self._fleet_swapped = False
        self._follow_thread: Optional[threading.Thread] = None
        self._follow_stop = threading.Event()
        self._model = model
        self._next_rid = n
        self.requests_total = Counter('mesh/requests_total')
        self.rollover_total = Counter('mesh/rollover_total')
        self.rollover_rollbacks_total = Counter(
            'mesh/rollover_rollbacks_total')
        self.breaker_open_total = Counter('mesh/replica_breaker_open_total')
        self.replicas_gauge = Gauge('mesh/replicas')
        self.serving_gauge = Gauge('mesh/replicas_serving')
        self.live_gauge = Gauge('mesh/replicas_live')
        self.retired_total = Counter('mesh/retired_total')
        # one tracer shared with every replica: the flight recorder and the
        # span log see the whole fleet; an injected tracer is its owner's
        rate = (tracing_sample_rate if tracing_sample_rate is not None
                else config.tracing_sample_rate)
        self._owns_tracer = tracer is None
        if tracer is not None:
            self._tracer: Optional[tracing_lib.Tracer] = tracer
        elif rate > 0:
            out_dir = (config.telemetry_dir
                       if config.TELEMETRY_DIR or config.is_saving
                       or config.is_loading else None)
            self._tracer = tracing_lib.Tracer(
                out_dir, sample_rate=rate, slow_ms=config.TRACING_SLOW_MS,
                flight_traces=config.TRACING_FLIGHT_TRACES, log=self.log)
        else:
            self._tracer = None
        self._slo: Optional[slo_lib.SloMonitor] = None
        if config.SERVING_SLO_AVAILABILITY > 0 or \
                config.SERVING_SLO_P99_MS > 0:
            self._slo = slo_lib.SloMonitor(
                availability=config.SERVING_SLO_AVAILABILITY,
                p99_ms=config.SERVING_SLO_P99_MS,
                fast_window_s=config.SERVING_SLO_FAST_WINDOW_SECS,
                slow_window_s=config.SERVING_SLO_SLOW_WINDOW_SECS,
                burn_threshold=config.SERVING_SLO_BURN_THRESHOLD,
                tracer=self._tracer, log=self.log)
        self._queue = FrontQueue(tiers, self.queue_bound,
                                 fleet_rate=self._fleet_rate, log=self.log)
        self._index = None
        # runs the searches of vector-array neighbor queries
        self._aux_pool = ThreadPoolExecutor(max_workers=2,
                                            thread_name_prefix='mesh-aux')
        # the memo tier: built once here and never reassigned
        memo_bytes = int(memo_cache_bytes if memo_cache_bytes is not None
                         else config.MEMO_CACHE_BYTES)
        epsilon = float(memo_semantic_epsilon
                        if memo_semantic_epsilon is not None
                        else config.MEMO_SEMANTIC_EPSILON)
        self._memo: Optional[memo_lib.MemoCache] = (
            memo_lib.MemoCache(memo_bytes, semantic_epsilon=epsilon,
                               params_step=self._params_step, log=self.log)
            if memo_bytes > 0 else None)
        self._replicas: List[_ReplicaSlot] = []
        try:
            for i in range(n):
                rid = 'r%d' % i
                self._replicas.append(
                    _ReplicaSlot(rid, self._build_replica(
                        rid, self._params_step)))
        except BaseException:
            # no replica is left behind: a mesh never runs with fewer
            # replicas than asked for
            self._queue.close()
            for slot in self._replicas:
                try:
                    slot.transport.close()
                except BaseException:
                    pass
            self._aux_pool.shutdown(wait=False)
            if self._memo is not None:
                self._memo.close()
            if self._tracer is not None and self._owns_tracer:
                self._tracer.close()
            raise
        self.replicas_gauge.set(n)
        if tele_core.enabled():
            tele_core.registry().gauge('mesh/replicas').set(n)
        self._set_replica_gauges()
        for slot in self._replicas:
            self._start_puller(slot)

    def _build_replica(self, rid: str,
                       params_step: Optional[int]) -> _ThreadReplica:
        model = self._model
        engine = ServingEngine(
            self.config, model.backend, model.backend.params, model.vocabs,
            decode_table=model._target_index_to_word, tiers=self.tiers,
            deadline_ms=0.0, queue_bound=-1,
            canary_batches=self.canary_batches,
            canary_agreement=self.canary_agreement,
            param_source=self._param_source, params_step=params_step,
            external_dispatch=True, tracer=self._tracer,
            tracing_sample_rate=0.0 if self._tracer is None else None,
            replica_id=rid, on_batch_done=self._on_batch_done, log=self.log)
        return _ThreadReplica(engine)

    def _start_puller(self, slot: _ReplicaSlot) -> None:
        slot.thread = threading.Thread(target=self._pull_loop, args=(slot,),
                                       daemon=True,
                                       name='mesh-pull-%s' % slot.rid)
        slot.thread.start()

    # ----------------------------------------------------- fleet rate
    def _fleet_rate(self) -> float:
        with self._lock:
            return self._service_rows_per_s

    def _note_service_locked(self, rows: int,
                             taken: List[_Request]) -> None:
        """The engine's windowed throughput estimator fed by every
        replica's completions: the fleet's served rows/s, which the shared
        admission divides deadlines by."""
        oldest = (min(request.t_enqueue for request in taken)
                  if taken else None)
        self._service_window_rows, self._service_rows_per_s = \
            engine_lib.note_service_window(
                self._service_window, self._service_window_rows,
                self._service_rows_per_s, rows, oldest)

    # ------------------------------------------------ replica weighting
    def _slot_cap_locked(self, slot: _ReplicaSlot) -> int:
        """A replica's in-flight window: halved while it canaries (it
        still needs live traffic for the canary), one batch while its
        breaker is half-open."""
        if slot.breaker_state == _BREAKER_HALF_OPEN:
            return 1
        if slot.canarying:
            return max(1, self.max_inflight // 2)
        return self.max_inflight

    def _slot_ready_locked(self, slot: _ReplicaSlot) -> str:
        """'ready' | 'wait' | 'exit' for one puller iteration."""
        if slot.retired or (self._closed and not self._drain):
            return 'exit'
        if slot.breaker_state == _BREAKER_OPEN:
            if time.perf_counter() >= slot.breaker_open_until:
                slot.breaker_state = _BREAKER_HALF_OPEN
                self.log('mesh: replica %s breaker half-open (probing one '
                         'batch)' % slot.rid)
            else:
                return 'wait'
        if slot.inflight >= self._slot_cap_locked(slot):
            return 'wait'
        return 'ready'

    def _slot_alive(self, slot: _ReplicaSlot) -> bool:
        """The puller's claim check inside ``pop_coalesced``: a replica
        that retired or tripped its breaker while waiting leaves without
        taking work."""
        with self._lock:
            return not (slot.retired
                        or slot.breaker_state == _BREAKER_OPEN
                        or (self._closed and not self._drain))

    def _set_replica_gauges(self) -> None:
        # advisory counts read outside the lock: both callers follow a
        # locked change
        serving = sum(1 for slot in self._replicas
                      if not slot.retired
                      and slot.breaker_state != _BREAKER_OPEN)
        live = sum(1 for slot in self._replicas if not slot.retired)
        self.serving_gauge.set(serving)
        self.live_gauge.set(live)
        if tele_core.enabled():
            reg = tele_core.registry()
            reg.gauge('mesh/replicas_serving').set(serving)
            reg.gauge('mesh/replicas_live').set(live)

    # -------------------------------------------------------- pull loop
    def _pull_loop(self, slot: _ReplicaSlot) -> None:
        while True:
            with self._cond:
                while True:
                    state = self._slot_ready_locked(slot)
                    if state == 'exit':
                        return
                    if state == 'ready':
                        break
                    # a breaker's cooldown ends on the clock, not on a
                    # notification
                    self._cond.wait(0.05)
            popped = self._queue.pop_coalesced(
                self.buckets[-1], self.max_delay_s,
                alive=lambda: self._slot_alive(slot))
            if popped is None:
                # the depth is read before the mesh's lock is taken:
                # pop_coalesced holds the queue's lock while it calls
                # alive() (queue, then mesh), so the mesh's lock never
                # waits for the queue's
                depth = self._queue.depth_rows()
                with self._lock:
                    if slot.retired or (self._closed and not self._drain):
                        return
                    if self._closed and depth == 0:
                        return
                continue
            tier, taken, rows, expired = popped
            for request in expired:
                request.fail(DeadlineExceeded(
                    'request expired after %.0fms in the mesh queue (SLO '
                    'deadline %.0fms)'
                    % (1e3 * (time.perf_counter() - request.t_enqueue),
                       1e3 * (request.t_deadline - request.t_enqueue))))
            if not taken:
                continue  # a sibling drained the tier while it coalesced
            with self._cond:
                slot.inflight += 1
            try:
                slot.transport.dispatch(tier, taken, rows)
            except BaseException as exc:
                # dispatch_external failed the requests typed; the breaker
                # counts the replica's failure
                self._dispatch_failed(slot, exc)
            # the completion arrives on the engine's decode worker
            # (_on_batch_done)

    def _dispatch_failed(self, slot: _ReplicaSlot,
                         exc: BaseException) -> None:
        with self._cond:
            slot.inflight = max(0, slot.inflight - 1)
            self._breaker_failure_locked(slot)
            fails = slot.breaker_fails
            self._cond.notify_all()
        self._queue.kick()
        self.log('mesh: replica %s dispatch failed (%s): %d consecutive'
                 % (slot.rid, exc, fails))

    def _breaker_failure_locked(self, slot: _ReplicaSlot) -> None:
        slot.breaker_fails += 1
        if slot.breaker_state == _BREAKER_HALF_OPEN or \
                slot.breaker_fails >= self.breaker_threshold:
            if slot.breaker_state != _BREAKER_OPEN:
                self.breaker_open_total.inc()
                if tele_core.enabled():
                    tele_core.registry().counter(
                        'mesh/replica_breaker_open_total').inc()
                self.log('mesh: replica %s dispatch breaker OPEN for %.0fs '
                         '(%d consecutive failures); the queue goes to the '
                         'other replicas'
                         % (slot.rid, self.breaker_cooldown_s,
                            slot.breaker_fails))
            slot.breaker_state = _BREAKER_OPEN
            slot.breaker_open_until = (time.perf_counter()
                                       + self.breaker_cooldown_s)
        self._set_replica_gauges()

    def _on_batch_done(self, engine: ServingEngine, rows: int,
                       taken: List[_Request], ok: bool) -> None:
        """The replicas' completion hook (on the engine's decode worker):
        the in-flight window, the breaker and the fleet's service
        window."""
        slot = next(s for s in self._replicas if s.transport.engine is engine)
        with self._cond:
            slot.inflight = max(0, slot.inflight - 1)
            if ok:
                slot.breaker_fails = 0
                if slot.breaker_state != _BREAKER_CLOSED:
                    slot.breaker_state = _BREAKER_CLOSED
                    self.log('mesh: replica %s breaker closed (probe '
                             'succeeded)' % slot.rid)
                    self._set_replica_gauges()
                slot.rows_dispatched += rows
                slot.batches += 1
                self._rows_total += rows
                self._note_service_locked(rows, taken)
                if tele_core.enabled():
                    tele_core.registry().gauge(catalog.labeled(
                        'mesh/dispatch_share', 'replica', slot.rid)).set(
                            slot.rows_dispatched / self._rows_total)
            else:
                self._breaker_failure_locked(slot)
            self._cond.notify_all()
        self._queue.kick()

    def _note_retired(self, reason: str) -> None:
        self.retired_total.inc()
        if tele_core.enabled():
            reg = tele_core.registry()
            reg.counter('mesh/retired_total').inc()
            reg.counter(catalog.labeled('mesh/retired_total', 'reason',
                                        reason)).inc()

    def _fail_queue_if_fleet_empty(self) -> None:
        """Every replica retired: nothing can serve the admitted work, so
        the queue closes and its requests fail typed (``ReplicaDead``)
        instead of hanging. Closing also turns away a submitter that
        passed submit's check before the last retirement: its enqueue
        raises typed."""
        with self._cond:
            if not all(s.retired for s in self._replicas):
                return
            self._closed = True
            self._cond.notify_all()
        self.log('mesh: no serving replica remains; failing the queue '
                 'typed')
        self._queue.close()
        for request in self._queue.abandon():
            request.fail(ReplicaDead(
                'every mesh replica has retired; the queue cannot drain'))

    # ----------------------------------------------------------- submit
    def submit(self, context_lines: Sequence[str], tier: str = 'topk',
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one prediction request on the shared front queue;
        whichever free replica claims it serves it. The single engine's
        contract (typed sheds, oversize split, a Future of one result per
        line, in order)."""
        if tier not in self.tiers:
            raise ValueError('tier %r is not warmed on this mesh (tiers=%s)'
                             % (tier, list(self.tiers)))
        # retirement is final, so this unlocked scan can only be stale on
        # the safe side
        if all(slot.retired for slot in self._replicas):
            raise EngineClosed('every mesh replica has retired; the mesh '
                               'cannot serve')
        if self._closed:
            raise EngineClosed('ServingMesh is closed')
        t_submit0 = time.perf_counter()
        # one definition of a request's identity across the engine, the
        # mesh and the memo key (MAX_CONTEXTS truncates before the sort)
        lines = canonicalize_contexts(context_lines,
                                      self.config.MAX_CONTEXTS)
        future: Future = Future()
        if not lines:
            future.set_result([])
            return future
        n = len(lines)
        if deadline_ms is None:
            deadline_s = self.deadline_s
        else:
            deadline_s = deadline_ms / 1e3 if deadline_ms > 0 else None
        self.requests_total.inc()
        if tele_core.enabled():
            tele_core.registry().counter('mesh/requests_total').inc()
        trace = None
        if self._tracer is not None:
            trace = self._tracer.begin(
                'serving.request',
                attrs={'tier': tier, 'rows': n, 'mesh': True,
                       'deadline_ms': (1e3 * deadline_s
                                       if deadline_s else None)})
        requested_tier = tier
        memo = self._memo
        memo_key = None
        if memo is not None:
            memo_key = memo_lib.request_key(lines, tier)
            # the exact tier stands down while a canary is in flight:
            # repeats served from the cache would starve the canary of
            # batches (inserts still happen; the generation keeps a result
            # in flight across the swap out)
            rolling = self._rollover is not None
            cached = None if rolling else memo.lookup(memo_key)
            if cached is not None:
                if trace is not None:
                    trace.event('serving.memo_hit',
                                attrs={'tier': tier, 'rows': n,
                                       'memo': 'exact'})
                    trace.finish(status='ok')
                if self._slo is not None:
                    self._slo.observe_good(time.perf_counter() - t_submit0)
                future.set_result(cached)  # a fresh copy
                return future
        t_admit0 = time.perf_counter()
        try:
            tier = self._queue.admit(n, tier, deadline_s)
        except EngineOverloaded as exc:
            if trace is not None:
                trace.event('serving.shed', attrs={'reason': str(exc)})
                trace.finish(status='shed')
                self._tracer.note_shed()
            if self._slo is not None:
                self._slo.observe_bad('shed')
            raise
        except EngineClosed as exc:
            if trace is not None:
                trace.event('serving.closed', attrs={'reason': str(exc)})
                trace.finish(status='closed')
            raise
        t_admit1 = time.perf_counter()
        if trace is not None:
            trace.span_at('serving.admission', t_admit0, t_admit1)
            if tier != requested_tier:
                trace.event('serving.degraded',
                            attrs={'requested': requested_tier,
                                   'effective': tier})
        try:
            requests = engine_lib.tokenize_and_chunk(
                self._reader, lines, tier, future, deadline_s,
                self.buckets[-1], trace=trace, t_tokenize0=t_admit1)
        except BaseException as exc:
            self._queue.release_reservation(n)
            if trace is not None:
                trace.finish(status='error', reason=repr(exc))
            raise
        for request in requests:
            if request.trace is not None:
                request.queue_span = request.trace.span(
                    'serving.queue_wait', parent=request.span_parent,
                    t0=request.t_enqueue)
        try:
            self._queue.enqueue(tier, requests, n)
        except EngineClosed:
            if trace is not None:
                trace.event('serving.closed',
                            attrs={'reason': 'ServingMesh is closed'})
                trace.finish(status='closed')
            raise
        if self._slo is not None:
            # one SLO event per caller-visible request, at its future: an
            # oversize request's chunks count once; a close's EngineClosed
            # is shutdown, not a violation
            slo = self._slo

            def _slo_observe(done: Future) -> None:
                try:
                    exc = done.exception()
                except BaseException:
                    return  # the caller cancelled
                if exc is None:
                    slo.observe_good(time.perf_counter() - t_admit0)
                elif not isinstance(exc, EngineClosed):
                    slo.observe_bad(type(exc).__name__)

            future.add_done_callback(_slo_observe)
        if memo is not None:
            # insert on delivery (after an oversize join), keyed on the
            # effective tier: a degraded answer never lands under the
            # requested tier's key
            insert_key = (memo_key if tier == requested_tier
                          else memo_lib.request_key(lines, tier))
            generation = memo.generation

            def _memo_insert(done: Future) -> None:
                try:
                    exc = done.exception()
                except BaseException:
                    return  # the caller cancelled: nothing delivered
                if exc is None:
                    memo.insert(insert_key, done.result(), generation)

            future.add_done_callback(_memo_insert)
        return future

    def predict(self, context_lines: Sequence[str], tier: str = 'topk',
                timeout: Optional[float] = None) -> list:
        """Synchronous ``submit().result()``."""
        return self.submit(context_lines, tier).result(timeout)

    # -------------------------------------------------------- neighbors
    def attach_index(self, index) -> 'ServingMesh':
        """Arm ``submit_neighbors``: neighbor queries ride the fleet's
        'vectors' tier, then the one attached index (``index/``), which
        every replica shares."""
        if 'vectors' not in self.tiers:
            raise ValueError(
                "submit_neighbors needs the 'vectors' tier warmed on this "
                'mesh (tiers=%s)' % list(self.tiers))
        self._index = index
        return self

    def _memo_served(self, rows: int, memo: str, t_submit0: float) -> None:
        """The trace and SLO bookkeeping of a neighbor query answered from
        the memo."""
        if self._tracer is not None:
            trace = self._tracer.begin(
                'serving.request',
                attrs={'tier': 'neighbors', 'rows': rows, 'mesh': True})
            trace.event('serving.memo_hit',
                        attrs={'tier': 'neighbors', 'rows': rows,
                               'memo': memo})
            trace.finish(status='ok')
        # answers from the cache stay in the SLO's good count
        if self._slo is not None:
            self._slo.observe_good(time.perf_counter() - t_submit0)

    def submit_neighbors(self, context_or_vectors, k: Optional[int] = None
                         ) -> Future:
        """The engine's ``submit_neighbors`` across the fleet: context
        lines ride the micro-batched 'vectors' tier, their code vectors
        search the attached index; an ``(n, D)`` vector array skips the
        predict leg. Both memo tiers apply (exact per ``k``; the
        semantic tier to one-row vector queries) and stand down during a
        canary."""
        index = self._index
        if index is None:
            raise RuntimeError('no index attached — call '
                               'attach_index(load_index(...)) first')
        k = k if k is not None else self.config.INDEX_NEIGHBORS_K
        from code2vec_tpu_torch.index.service import neighbors_from_search
        t_submit0 = time.perf_counter()
        outer: Future = Future()
        memo = self._memo
        rolling = self._rollover is not None
        if isinstance(context_or_vectors, np.ndarray):
            vectors = np.atleast_2d(context_or_vectors)
            shadow_row = None
            if memo is not None and not rolling and vectors.shape[0] == 1:
                sem = memo.semantic_lookup(vectors[0], k)
                if sem is not None:
                    sem_row, shadow = sem
                    if not shadow:
                        self._memo_served(1, 'semantic', t_submit0)
                        outer.set_result([sem_row])
                        return outer
                    # a shadow sample: run live, then score the cached
                    # row's top-1 against the live one
                    shadow_row = sem_row
            sem_gen = memo.generation if memo is not None else None
            sem_igen = memo.index_generation if memo is not None else None
            # read after the generations: an index swapped in between
            # pairs the old generation with the new index, a refused
            # insert, never the reverse
            index = self._index

            def lookup() -> None:
                try:
                    values, indices = index.search(vectors, k)
                    results = neighbors_from_search(values, indices,
                                                    index.labels)
                    if memo is not None:
                        if shadow_row is not None and results:
                            memo.note_semantic_agreement(shadow_row,
                                                         results[0])
                        memo.semantic_insert(vectors, results, k, sem_gen,
                                             index_generation=sem_igen)
                    _resolve(outer, results)
                except BaseException as exc:
                    if not outer.done():
                        outer.set_exception(exc)
            self._aux_pool.submit(lookup)
            return outer
        lines = canonicalize_contexts(context_or_vectors,
                                      self.config.MAX_CONTEXTS)
        nkey = gen = igen = None
        if memo is not None:
            # keyed per k: a k=5 answer never serves a k=10 ask
            nkey = memo_lib.request_key(lines, 'neighbors', k=k)
            cached = None if rolling else memo.lookup(nkey)
            if cached is not None:
                self._memo_served(len(lines), 'exact', t_submit0)
                outer.set_result(cached)
                return outer
            gen = memo.generation
            igen = memo.index_generation
            index = self._index
        inner = self.submit(lines, tier='vectors')

        def chain(done: Future) -> None:
            try:
                results = done.result()
                if not results:
                    _resolve(outer, [])
                    return
                vectors = np.stack([r.code_vector for r in results])
                values, indices = index.search(vectors, k)
                out_results = neighbors_from_search(values, indices,
                                                    index.labels)
                if memo is not None:
                    memo.insert(nkey, out_results, gen,
                                index_generation=igen)
                    memo.semantic_insert(vectors, out_results, k, gen,
                                         index_generation=igen)
                _resolve(outer, out_results)
            except BaseException as exc:
                if not outer.done():
                    outer.set_exception(exc)
        inner.add_done_callback(chain)
        return outer

    # --------------------------------------------------------- rollover
    def load_params(self, source, canary_batches: Optional[int] = None,
                    min_agreement: Optional[float] = None) -> Future:
        """Coordinated fleet rollover: canary on one replica (the engine's
        shadow scoring, no capture), then on agreement every other
        replica adopts the same parameters; on disagreement the canary
        rolls back and every replica keeps the old ones. Returns a Future
        of the fleet's report."""
        n_canary = (canary_batches if canary_batches is not None
                    else self.canary_batches)
        floor = (min_agreement if min_agreement is not None
                 else self.canary_agreement)
        handle: Future = Future()
        with self._cond:
            if self._closed:
                raise EngineClosed('ServingMesh is closed')
            if self._rollover is not None:
                raise RuntimeError(
                    'a fleet rollover is already in flight (replica %s); '
                    'await its handle first'
                    % self._rollover['replica'].rid)
            canary_slot = next(
                (slot for slot in self._replicas
                 if not slot.retired
                 and slot.breaker_state != _BREAKER_OPEN), None)
            if canary_slot is None:
                raise RuntimeError('no serving replica available to canary '
                                   'the rollover on')
            self._rollover = {'replica': canary_slot, 'handle': handle}
            canary_slot.canarying = True
        step = (source if isinstance(source, int)
                and not isinstance(source, bool) else None)
        try:
            canary_handle = canary_slot.transport.load_params(
                source, n_canary, floor)
        except BaseException:
            with self._cond:
                self._rollover = None
                canary_slot.canarying = False
            raise
        self.log('mesh: rollover armed — canarying on replica %s (%d '
                 'batches, agreement floor %.2f)'
                 % (canary_slot.rid, n_canary, floor))

        def conclude(done: Future) -> None:
            swapped = 0
            try:
                report = done.result()
            except BaseException as exc:
                self._finish_rollover(canary_slot)
                if not handle.done():
                    handle.set_exception(exc)
                return
            if report.get('swapped'):
                resolved_step = (report.get('step')
                                 if report.get('step') is not None
                                 else step)
                params = canary_slot.transport.engine.params
                try:
                    for slot in list(self._replicas):
                        if slot is canary_slot or slot.retired:
                            continue
                        slot.transport.adopt(params, resolved_step)
                        swapped += 1
                except BaseException as exc:
                    # a sibling failed its adopt (its engine closed): the
                    # rollover still concludes, or every later load_params
                    # and the follow poller would wedge; the caller sees
                    # the partial swap typed
                    self._finish_rollover(canary_slot)
                    self.log('mesh: fleet swap FAILED on a sibling after '
                             'the canary passed (%r); %d sibling(s) '
                             'adopted' % (exc, swapped))
                    if not handle.done():
                        handle.set_exception(exc)
                    return
                with self._cond:
                    if resolved_step is not None:
                        self._params_step = resolved_step
                    self._fleet_swapped = True
                if self._memo is not None:
                    # on every swap, a parameter set with no step too: one
                    # generation bump drops every cached result; a
                    # rollback never comes here, so the cache stays warm
                    self._memo.bump_generation(resolved_step)
                self.rollover_total.inc()
                if tele_core.enabled():
                    tele_core.registry().counter(
                        'mesh/rollover_total').inc()
                self.log('mesh: fleet rollover SWAPPED (step %s): canary '
                         'agreement %.3f on replica %s, %d sibling(s) '
                         'adopted'
                         % (resolved_step, report.get('agreement') or 0,
                            canary_slot.rid, swapped))
            else:
                self.rollover_rollbacks_total.inc()
                if tele_core.enabled():
                    tele_core.registry().counter(
                        'mesh/rollover_rollbacks_total').inc()
                if self._tracer is not None:
                    self._tracer.dump_flight('rollover_rollback')
                self.log('mesh: fleet rollover ROLLED BACK on the canary '
                         'replica %s (%s); every replica keeps the old '
                         'params' % (canary_slot.rid, report.get('reason')))
            self._finish_rollover(canary_slot)
            fleet_report = dict(report)
            fleet_report['canary_replica'] = canary_slot.rid
            fleet_report['replicas_swapped'] = (
                swapped + 1 if report.get('swapped') else 0)
            _resolve(handle, fleet_report)

        canary_handle.add_done_callback(conclude)
        return handle

    def _finish_rollover(self, canary_slot: _ReplicaSlot) -> None:
        with self._cond:
            canary_slot.canarying = False
            self._rollover = None
            self._cond.notify_all()
        self._queue.kick()

    def follow_checkpoints(self, poll_secs: Optional[float] = None
                           ) -> 'ServingMesh':
        """``--serve-follow-checkpoints`` for the fleet: one poller rolls
        newer retained steps through the coordinated canary, so the fleet
        moves as a unit."""
        if self._param_source is None:
            raise RuntimeError('follow_checkpoints needs a checkpointed '
                               'model (a load or save path)')
        poll = (poll_secs if poll_secs is not None
                else self.config.SERVE_FOLLOW_CHECKPOINTS_SECS)
        if poll <= 0:
            raise ValueError('follow_checkpoints needs poll_secs > 0 (got '
                             '%r)' % poll)
        with self._lock:
            if self._closed:
                raise EngineClosed('ServingMesh is closed')
            if self._follow_thread is not None:
                return self
            self._follow_thread = threading.Thread(
                target=self._follow_loop, args=(poll,), daemon=True,
                name='mesh-follow')
            self._follow_thread.start()
        return self

    def _follow_loop(self, poll_secs: float) -> None:
        attempted: Optional[int] = None
        while not self._follow_stop.wait(poll_secs):
            try:
                newest = self._param_source.newest_step()
                with self._cond:
                    if self._closed:
                        return
                    busy = self._rollover is not None
                    current = self._params_step
                if newest is None or busy:
                    continue
                if attempted is not None and newest <= attempted:
                    continue  # don't hot-loop a rolled-back step
                if current is not None and newest <= current:
                    continue
                self.log('mesh: follow-checkpoints found step %d; starting '
                         'coordinated rollover' % newest)
                self.load_params(newest)
                attempted = newest
            except EngineClosed:
                return
            except Exception as exc:  # the poller survives blips
                self.log('mesh: follow-checkpoints poll failed: %s' % exc)

    # ----------------------------------------------------------- fleet
    def add_replica(self) -> str:
        """Grow the fleet by one replica: a new engine with its own
        ladder, warmed (its captures are its own), serving the fleet's
        current parameters before its puller starts. Returns its id."""
        with self._cond:
            if self._closed:
                raise EngineClosed('ServingMesh is closed')
            rid = 'r%d' % self._next_rid
            self._next_rid += 1
            step = self._params_step
        transport = self._build_replica(rid, step)
        try:
            transport.warmup()
            with self._cond:
                # a rollover in flight concludes first: the new replica
                # then adopts what the fleet settled on
                while self._rollover is not None and not self._closed:
                    self._cond.wait(0.1)
                donor = next((s for s in self._replicas if not s.retired),
                             None)
                swapped, step = self._fleet_swapped, self._params_step
            if swapped and donor is not None:
                transport.adopt(donor.transport.engine.params, step)
        except BaseException:
            transport.close()
            raise
        with self._cond:
            closed = self._closed
            if not closed:
                slot = _ReplicaSlot(rid, transport)
                self._replicas.append(slot)
                self._start_puller(slot)
                self._cond.notify_all()
        if closed:
            transport.close()
            raise EngineClosed('ServingMesh closed while a replica was '
                               'added')
        self.replicas_gauge.set(len(self._replicas))
        if tele_core.enabled():
            tele_core.registry().gauge('mesh/replicas').set(
                len(self._replicas))
        self._set_replica_gauges()
        self._queue.kick()
        self.log('mesh: replica %s joined the fleet' % rid)
        return rid

    def retire(self, replica_id: str, timeout: float = 120.0,
               reason: str = 'drain') -> None:
        """Drain one replica out of the fleet: it stops pulling, its
        in-flight batches deliver, its engine closes; the shared queue
        goes to the remaining replicas throughout. Retiring the last
        replica fails the queue typed (``ReplicaDead``)."""
        with self._cond:
            slot = next((s for s in self._replicas if s.rid == replica_id),
                        None)
            if slot is None:
                raise ValueError('no replica %r in this mesh (%s)'
                                 % (replica_id,
                                    [s.rid for s in self._replicas]))
            if slot.retired:
                return
            slot.retired = True
            slot.retired_reason = reason
            self._cond.notify_all()
        self._note_retired(reason)
        self._queue.kick()
        if slot.thread is not None:
            slot.thread.join(timeout)
        deadline = time.perf_counter() + timeout
        with self._cond:
            while slot.inflight > 0:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cond.wait(min(remaining, 0.1))
        slot.transport.close()
        self._set_replica_gauges()
        self.log('mesh: replica %s retired (served %d rows in %d batches)'
                 % (slot.rid, slot.rows_dispatched, slot.batches))
        self._fail_queue_if_fleet_empty()

    # -------------------------------------------------------- lifecycle
    def warmup(self) -> 'ServingMesh':
        """Warm every replica's ladder: each captures its own graphs
        (N x the single engine's captures), and the submit side's native
        tokenizer is built here, not at the first request."""
        if set(self.tiers) & {'topk', 'vectors'}:
            self._reader.native_tokenizer()
        for slot in self._replicas:
            slot.transport.warmup()
        return self

    def stats(self) -> Dict[str, object]:
        with self._lock:
            rows_total = self._rows_total
            replicas = [{
                'replica': slot.rid,
                'retired': slot.retired,
                'retired_reason': slot.retired_reason,
                'breaker_state': slot.breaker_state,
                'inflight': slot.inflight,
                'batches': slot.batches,
                'rows_dispatched': slot.rows_dispatched,
                'dispatch_share': (slot.rows_dispatched / rows_total
                                   if rows_total else 0.0),
            } for slot in self._replicas]
            params_step = self._params_step
            fleet_rate = self._service_rows_per_s
        out = {
            'replicas': replicas,
            'mode': self.mode,
            'requests_total': self.requests_total.snapshot(),
            'rows_dispatched': rows_total,
            'fleet_rows_per_s': fleet_rate,
            'params_step': params_step,
            'rollover_total': self.rollover_total.snapshot(),
            'rollover_rollbacks_total':
                self.rollover_rollbacks_total.snapshot(),
            'replica_breaker_open_total':
                self.breaker_open_total.snapshot(),
            'retired_total': self.retired_total.snapshot(),
            'replicas_live': self.live_gauge.snapshot(),
            'replicas_serving': self.serving_gauge.snapshot(),
            'slo': self._slo.stats() if self._slo is not None else None,
            'memo': self._memo.stats() if self._memo is not None else None,
            'tracing': (self._tracer.stats()
                        if self._tracer is not None else None),
        }
        out.update(self._queue.stats())
        return out

    def replica_stats(self) -> List[Dict[str, object]]:
        """Each replica's engine ``stats()`` (fill, latency, captures,
        replays); a retired replica's row says so."""
        return [{'replica': slot.rid, 'retired': True} if slot.retired
                else slot.transport.stats() for slot in self._replicas]

    def close(self, drain: bool = False) -> None:
        """Stop the fleet. Fail-fast (the default): still-queued requests
        fail typed ``EngineClosed``, dispatched batches deliver.
        ``drain=True`` serves everything admitted first. An armed
        rollover's handle fails ``EngineClosed``. Idempotent."""
        with self._cond:
            if not self._closed:
                self._closed = True
                self._drain = drain
            rollover, self._rollover = self._rollover, None
            self._cond.notify_all()
        self._follow_stop.set()
        self._queue.close(drain)
        if not drain:
            for request in self._queue.abandon():
                request.fail(EngineClosed(
                    'ServingMesh closed with the request still queued '
                    '(close(drain=True) serves the queue first)'))
        if rollover is not None:
            handle = rollover['handle']
            if isinstance(handle, Future) and not handle.done():
                try:
                    handle.set_exception(EngineClosed(
                        'ServingMesh closed mid-rollover'))
                except Exception:
                    pass
        follow = self._follow_thread
        if follow is not None:
            follow.join()
        for slot in self._replicas:
            if slot.thread is not None:
                slot.thread.join()
        for slot in self._replicas:
            if not slot.retired:
                slot.transport.close()
        self._aux_pool.shutdown(wait=True)
        if self._memo is not None:
            self._memo.close()
        if self._tracer is not None and self._owns_tracer:
            self._tracer.close()

    def __enter__(self) -> 'ServingMesh':
        return self

    def __exit__(self, *exc) -> None:
        self.close()
