"""The serving mesh: N ``ServingEngine`` replicas on the one card behind
one shared front queue (the port of ``code2vec_tpu/serving/mesh.py``).

- **One shared front queue** (``serving/frontqueue.py``): admission (the
  bound, the deadline against the fleet's drain estimate, the
  degradation ladder) happens once for the fleet, so one slow replica
  never strands its share of the traffic.
- **Replica pullers.** Each replica runs one puller thread that claims
  a coalesced micro-batch from the shared queue whenever the replica has
  a free in-flight slot, and dispatches it to its replica, whose engine
  (``dispatch_external``) packs it onto the smallest covering (bucket x
  rung x tier) key and replays that key's CUDA graph. Predict tiers and
  ``submit_neighbors``' vectors traffic ride one stream of dispatches.
- **Replica-aware weighting.** The replica table keeps each replica's
  in-flight window, a dispatch breaker (``MESH_BREAKER_THRESHOLD``
  consecutive failures open it; after the cooldown one half-open probe
  batch decides) and retirement: a breaker-open, dead or retired replica
  stops pulling and the queue goes to its siblings. The replica
  canarying a rollover pulls with half its window.
- **Memo and SLO tiers.** The exact and semantic memo tiers
  (``serving/memo.py``) are checked at submit, before admission; the
  SLO monitor (``serving/slo.py``) watches the fleet's completions.
- **Coordinated rollover.** ``load_params(step|path|params)`` canaries
  on one replica (the engine's shadow scoring), then on agreement every
  other replica adopts the same parameters, or the canary rolls back and
  every replica keeps the old ones. ``follow_checkpoints`` runs here,
  once for the fleet.

**Replica modes** (``MESH_REPLICA_MODE``). ``'thread'``: each replica is
an engine of this process. ``'process'``: each replica is a spawned
worker process of the port with its own CUDA context, its own model
restored from the model's checkpoint path and its own external-dispatch
engine and ladder, fed tokenized batches over the framed wire
(``serving/transport.py``) through a pipe, answering with decoded
results (numpy arrays and Python values; nothing from the card crosses
the wire). ``'socket'`` carries the same protocol over TCP: the mesh
opens a listener and each worker dials in with its rid. Worker
replicas roll over from checkpoint references only (a step or a model
path): parameters on the card do not cross processes.

**Self-healing, in the worker modes.**

- **Liveness apart from dispatch health.** Workers heartbeat every
  ``MESH_HEARTBEAT_SECS``; one that misses more than
  ``MESH_HEARTBEAT_MISSES`` intervals is killed, which catches a hung or
  partitioned worker the breaker cannot see.
- **Crash-safe redispatch.** The members of a batch that dies with its
  worker are re-admitted once at the front of the shared queue with the
  dead incarnation excluded and their deadlines intact; a second crash
  fails them typed (``ReplicaDead``). The parent never serves a request
  itself.
- **Supervised restart.** A supervisor thread restarts a dead worker
  with exponential backoff under a budget per window
  (``MESH_RESTART_LIMIT`` per ``MESH_RESTART_WINDOW_SECS``; a flapping
  worker retires for good), and adopts the fleet's current step into
  it before its puller touches the queue.

Where the port differs from the JAX design: a JAX thread replica shares
the trainer's jit cache and adopts a swap by pointing at the canary's
pytree. A CUDA graph reads fixed addresses from one pool on one stream
(``serving/graphs.py``), and two threads replaying the same graphs would
race on their static inputs and their pool. So each thread replica here
is an engine with its own ``GraphLadder``: its own stream, its own graph
pool and its own two parameter slots, captured at its warm-up. A fleet
swap copies the canary's parameters into each sibling's idle slot
(``adopt_params``: a ``copy_`` on the sibling's stream, enqueued after
its in-flight replays; no capture). Replicas overlap on the card only
through their streams (thread mode) or the card's time slicing between
contexts (the worker modes); nothing on the dispatch path synchronizes.

**The elastic fleet.**

- **The autoscaler** (``serving/autoscaler.py``, armed by
  ``AUTOSCALE_MAX_REPLICAS > 0``): the mesh builds it and closes it;
  scale-up is ``add_replica`` (or its ``spawn`` hook, which asks an
  orchestrator for a worker), scale-down is ``retire(rid,
  reason='autoscale')``, a drain.
- **Adoption** (socket mode). A worker started outside the mesh
  (``python -m code2vec_tpu_torch.serving.mesh_worker``) dials the
  listener with a rid the mesh never spawned. The adoption thread waits
  for its ready frame (``adopt_ready_timeout_s``, its cold start
  included), checks its wire protocol, batch wire format and warm tiers,
  waits out a rollover in flight, moves it to the fleet's step by
  checkpoint reference and seats it, or refuses it with a typed
  ``adopt_rejected`` frame. Its orchestrator owns its restarts: its
  death retires its slot (``'adopted_worker_exit'``) without charging
  the local restart budget, and the autoscaler never drains it. The
  ``devices`` it reports are its slice (``device_indices``), as the
  reference records an adopted worker's.

**Placement** (the reference's per-replica device slices).
``MESH_DEVICES_PER_REPLICA=1`` in 'process' or 'socket' mode gives every
worker a card of its own: the host's cards are partitioned into slices
(``parallel/mesh.py::partition_device_indices``) for the larger of the
fleet and ``AUTOSCALE_MAX_REPLICAS``, so a scale-up never finds its card
unreserved; a spawn ships its slice as MESH_DEVICE_INDICES; a retired
slot's slice is free for the next scale-up, a restart keeps its own, and
a scale-up with every slice held raises ``PlacementError``. Too few
cards for the table refuses the mesh at build, and thread replicas
refuse placement (they share this process's card). A worker pins itself
to its slice before its first CUDA call (``CUDA_VISIBLE_DEVICES``: every
thread and kernel launch of it sees its card as device 0) and reports
the slice and its card's UUID; a worker whose report is not its slice,
or whose card's UUID is not the one this process sees at that index,
fails its cold start with ``PlacementError``. A slice is one card: a
port engine is one card (ROADMAP C15), so the submit side's ladder
keeps a data axis of 1.

**Fleet observability, in the worker modes.** A worker's spans, metrics
and memory ledger live in its own process; the wire carries them home.
A dispatch frame ships one trace context per member, and the worker
sends back its members' finished spans (``serving.remote`` and the
engine's phases under it) on the result frame, or on a heartbeat when
they miss it; the receiver grafts them into the live traces under the
incarnation's clock-offset estimate before it delivers. With
``MESH_TELEMETRY_BACKHAUL`` on (AUTO: on when telemetry is enabled here
as the worker is spawned), each heartbeat also carries the worker's
registry snapshot and memory-ledger rollup: the snapshot merges into
this process's registry under ``{replica=<rid>}``, the rollup is
``worker_memory`` in ``stats()``. The port's switch gates the spans as
well: with it off a beat carries liveness and the clock stamp only, and
a worker's phases stay out of the parent's traces.

**The scenario traffic plane** (``workloads/``). ``submit`` and
``submit_neighbors`` take a ``scenario`` and a ``language``: the scenario
rides the trace root's attrs (and from there every worker's dispatch
context) and labels the memo's hit and miss mirrors and the SLO's
observations. ``record_traffic(ProfileRecorder)`` arms the admission tap
that records every caller-visible request for a later replay.
``submit_blended`` is retrieval-augmented naming: the softmax head's
top-k blended with the attached index's neighbor votes
(``workloads/blend.py``), over the two warmed legs ``submit(tier='topk')``
and ``submit_neighbors``, so a blend captures nothing new; at weight 0 it
wraps the plain submit's untouched rows, and with no index it is the
typed softmax fallback. ``rollover_index(candidate)`` canaries an index
swap: live neighbor queries are replayed against the candidate in the aux
pool (on this thread's stream, never a replica's), scored for top-k id
agreement, and the candidate swaps in (the memo's index generation bumps:
neighbor entries go, predict entries stay) or rolls back.
"""
from __future__ import annotations

import collections
import logging
import multiprocessing
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from code2vec_tpu_torch.data.reader import (PathContextReader,
                                            canonicalize_contexts)
from code2vec_tpu_torch.parallel import mesh as parallel_mesh
from code2vec_tpu_torch.parallel.mesh import PlacementError
from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.serving import engine as engine_lib
from code2vec_tpu_torch.serving import memo as memo_lib
from code2vec_tpu_torch.serving import slo as slo_lib
from code2vec_tpu_torch.serving import transport as transport_lib
from code2vec_tpu_torch.serving.autoscaler import Autoscaler
from code2vec_tpu_torch.serving.engine import (ServingEngine, _Request,
                                               _resolve)
from code2vec_tpu_torch.serving.errors import (AdoptionRejected,
                                               DeadlineExceeded, EngineClosed,
                                               EngineOverloaded, ReplicaDead,
                                               WireError)
from code2vec_tpu_torch.serving.frontqueue import FrontQueue
from code2vec_tpu_torch.serving.steps import PREDICT_TIERS
from code2vec_tpu_torch.telemetry import catalog
from code2vec_tpu_torch.telemetry import core as tele_core
from code2vec_tpu_torch.telemetry import tracing as tracing_lib
from code2vec_tpu_torch.telemetry.core import Counter, Gauge
from code2vec_tpu_torch.workloads import blend as blend_lib

logger = logging.getLogger(__name__)

#: replica dispatch-breaker states (the reference's numbering)
_BREAKER_CLOSED = 0
_BREAKER_HALF_OPEN = 1
_BREAKER_OPEN = 2

#: the modes a mesh seats its replicas in
REPLICA_MODES = ('thread', 'process', 'socket')

#: how long a worker's cold start (spawn, model build, warm-up) may take
_WORKER_START_TIMEOUT_S = 600.0


class _ReplicaSlot:
    """One row of the replica table: the replica, its puller and the
    dispatch accounting the weighting reads. Every mutable field is
    guarded by the mesh's ``_cond`` (the puller, the completion hooks,
    the liveness monitor, the supervisor, rollover and retirement all
    touch them).

    ``dead`` is the liveness verdict on a worker (it exited, its wire
    broke or it missed its heartbeats): a dead slot stops pulling and
    waits for the supervisor, which restarts it (``transport`` is
    replaced; the old transport is the incarnation token crash-safe
    redispatch excludes) or retires it once the restart budget is
    spent.

    ``adopted`` marks a worker started outside the mesh: its
    orchestrator owns its restarts, so its death retires the slot
    (``'adopted_worker_exit'``) instead of charging the restart budget,
    and the autoscaler never drains it. ``devices`` is the card list the
    worker reported (none for a thread replica), ``device_indices`` its
    placement slice: the one the mesh gave it, or an adopted worker's
    report (the reference's placement view); a slice held by a slot that
    is not retired is taken."""

    __slots__ = ('rid', 'transport', 'thread', 'retired', 'retired_reason',
                 'adopted', 'devices', 'device_indices', 'inflight',
                 'rows_dispatched',
                 'batches', 'breaker_fails', 'breaker_state',
                 'breaker_open_until', 'canarying', 'dead', 'restarting',
                 'restart_times', 'restarts')

    def __init__(self, rid: str, transport):
        self.rid = rid
        self.transport = transport
        self.thread: Optional[threading.Thread] = None
        self.retired = False
        #: 'drain' | 'autoscale' | 'restart_budget' | 'adopted_worker_exit'
        self.retired_reason: Optional[str] = None
        self.adopted = False
        self.devices: Optional[List[int]] = None
        self.device_indices: Optional[List[int]] = None
        self.inflight = 0
        self.rows_dispatched = 0
        self.batches = 0
        self.breaker_fails = 0
        self.breaker_state = _BREAKER_CLOSED
        self.breaker_open_until = 0.0
        self.canarying = False
        self.dead = False
        self.restarting = False
        self.restart_times: collections.deque = collections.deque()
        self.restarts = 0


class _ThreadReplica:
    """An in-process replica: a ``ServingEngine`` in external-dispatch
    mode over its own ladder of CUDA graphs, called directly."""

    mode = 'thread'

    def __init__(self, engine: ServingEngine):
        self.engine = engine

    @property
    def pid(self) -> int:
        return os.getpid()

    @property
    def params_step(self) -> Optional[int]:
        return self.engine.params_step

    def dispatch(self, tier: str, taken: List[_Request], rows: int) -> None:
        self.engine.dispatch_external(tier, taken, rows)

    def wait_ready(self) -> None:
        pass  # built ready

    def warmup(self) -> None:
        self.engine.warmup()

    def load_params(self, source, canary_batches: int,
                    min_agreement: float) -> Future:
        return self.engine.load_params(source,
                                       canary_batches=canary_batches,
                                       min_agreement=min_agreement)

    def adopt(self, params, source, step: Optional[int]) -> None:
        # the canary's validated parameters copied into this replica's
        # idle slot, then served (its graphs read its own slots)
        del source
        self.engine.adopt_params(params, step=step)

    def stats(self) -> Dict[str, object]:
        return self.engine.stats()

    def close(self) -> None:
        self.engine.close()


class _WorkerReplica:
    """A worker replica: a spawned process of the port hosting its own
    model and external-dispatch engine (its own CUDA context and ladder
    on the card), fed tokenized ``Batch`` payloads over the framed wire
    (``serving/transport.py``) and answering with decoded results. The
    carrier is a pipe (``mode='process'``) or TCP (``mode='socket'``: the
    worker dials the mesh's listener and introduces itself).

    The parent-side receiver thread resolves in-flight dispatches and
    feeds the mesh's completion hook; the worker serves dispatches one at
    a time (its engine decodes on its own pool) and heartbeats on its own
    thread, so a busy worker still proves it is alive. A worker's death
    (EOF, a corrupt frame, a liveness kill) is reported once through
    ``on_worker_dead`` with the in-flight batches attached, so the mesh
    can redispatch them instead of failing the callers.

    An adopted worker comes with its ``channel`` already dialed in (and
    its hello's pid): there is no local process to spawn, join or
    restart, and a kill shuts its socket.

    The fleet observability backhaul rides the same wire: a dispatch
    frame carries one trace context per member, the worker ships its
    members' finished spans on the result frame (or, when they miss it,
    on a heartbeat), and the receiver grafts them into the live traces
    (``Trace.adopt_spans``) under this incarnation's clock offset before
    it delivers. A heartbeat's registry snapshot and ledger rollup go to
    ``on_telemetry``, the mesh's fleet merge; ``on_spans`` counts the
    spans stitched and dropped."""

    # the pending map, the control map, the sequence counter and the send
    # side of the wire are shared by the puller, the receiver thread, the
    # liveness monitor and control calls: all under _lock
    def __init__(self, rid: str, mode: str,
                 config_overrides: Dict[str, object], on_batch_done,
                 on_worker_dead, on_telemetry=None, on_spans=None,
                 listener: Optional[transport_lib.SocketListener] = None,
                 start_timeout_s: float = _WORKER_START_TIMEOUT_S,
                 channel: Optional[transport_lib.SocketTransport] = None,
                 hello: Optional[Dict[str, object]] = None):
        self.rid = rid
        self.mode = mode
        self._on_batch_done = on_batch_done
        self._on_worker_dead = on_worker_dead
        #: the fleet merge: (transport, registry snapshot, ledger rollup)
        #: per heartbeat that carries a snapshot
        self._on_telemetry = on_telemetry
        #: the stitching accounting: (spans adopted, spans dropped)
        self._on_spans = on_spans
        self._listener = listener
        self._start_timeout_s = start_timeout_s
        #: an adopted worker's hello as the listener took it: its pid and
        #: when it dialed in (``t_hello``, this process's perf_counter)
        self.hello: Dict[str, object] = dict(hello or {})
        self._cancel = threading.Event()
        #: stamped by the receiver on every frame (heartbeats included);
        #: the mesh's liveness monitor reads it
        self.last_heartbeat = time.perf_counter()
        #: the worker's last self-reported {'inflight'}
        self.heartbeat_info: Dict[str, object] = {}
        #: this incarnation's clock offset (the ready frame and the beats);
        #: the worker's span stamps shift by it when they are stitched
        self.clock = transport_lib.ClockOffset()
        #: the worker's last memory-ledger rollup ({'attributed_bytes',
        #: 'budget_bytes', 'buckets'}): ``worker_memory`` in stats()
        self.ledger_info: Dict[str, object] = {}
        #: the receiver's own: the last merged value of each counter, for
        #: the fleet merge's deltas (one map an incarnation, so the fleet
        #: series keeps accumulating across a restart)
        self._merge_last: Dict[str, float] = {}
        #: the ready handshake's {'params_step', 't_mono', 'capabilities'}
        self.ready_info: Dict[str, object] = {}
        #: the step the worker serves: its ready frame's, then each swap's
        self.params_step: Optional[int] = None
        # spawn, never fork: the parent holds a CUDA context a forked
        # child could not use; the child imports this module alone
        ctx = multiprocessing.get_context('spawn')
        self._conn = None
        self._proc = None
        if channel is not None:
            # adopted: the worker dialed in on its own
            self._channel = channel
        elif mode == 'socket':
            self._channel = None   # claimed from the listener at ready
            self._proc = ctx.Process(
                target=_replica_worker_main,
                args=(rid, config_overrides, None, listener.address),
                daemon=True)
            self._proc.start()
        else:
            self._conn, child = ctx.Pipe()
            self._proc = ctx.Process(
                target=_replica_worker_main,
                args=(rid, config_overrides, child, None), daemon=True)
            # start only: the mesh starts every worker first and then
            # waits for each, so N cold starts overlap
            self._proc.start()
            child.close()
            self._channel = transport_lib.PipeTransport(self._conn)
        self._lock = threading.Lock()
        self._pending: Dict[int, Tuple[List[_Request], int]] = {}
        self._seq = 0
        self._control: Dict[int, Future] = {}
        self._receiver: Optional[threading.Thread] = None

    def _reap_on_start_failure(self) -> None:
        """A spawned worker that failed its start is reaped; an adopted
        one keeps its wire open, since the adoption still owes it a typed
        ``adopt_rejected`` frame before the close."""
        if self._proc is not None:
            self.reap()

    def wait_ready(self) -> None:
        """Block until the worker reported ready, then start the
        receiver. Runs before the first dispatch or control call;
        ``cancel()`` interrupts it (the mesh closing mid-start)."""
        if self._receiver is not None:
            return
        deadline = time.perf_counter() + self._start_timeout_s
        if self._channel is None:
            # socket mode: claim the worker's validated hello, pinned to
            # this incarnation's pid (a reaped predecessor's late hello
            # is never handed to the restart)
            try:
                self._channel, _hello = self._listener.claim(
                    self.rid, self._start_timeout_s, cancel=self._cancel,
                    pid=self._proc.pid)
            except Exception as exc:
                self.reap()
                raise RuntimeError('mesh replica %s worker never dialed '
                                   'in: %r' % (self.rid, exc))
        while not self._channel.poll(0.25):
            if self._cancel.is_set():
                self._reap_on_start_failure()
                raise RuntimeError('mesh replica %s startup cancelled '
                                   '(mesh closing)' % self.rid)
            if time.perf_counter() >= deadline:
                self._reap_on_start_failure()
                raise RuntimeError(
                    'mesh replica %s worker did not come up within %.0fs'
                    % (self.rid, self._start_timeout_s))
        try:
            msg = self._channel.recv()
        except (EOFError, OSError, WireError) as exc:
            # the worker died before it could report why
            self._reap_on_start_failure()
            raise RuntimeError(
                'mesh replica %s worker exited during startup (%r); '
                'worker replicas need a checkpointed model with a '
                'retained step' % (self.rid, exc))
        if msg[0] == 'failed':
            self._reap_on_start_failure()
            error = (PlacementError if str(msg[1]).startswith(
                'PlacementError') else RuntimeError)
            raise error('mesh replica %s worker failed to start: %s'
                        % (self.rid, msg[1]))
        if msg[0] != 'ready':
            self._reap_on_start_failure()
            raise RuntimeError('mesh replica %s worker failed to start: %r'
                               % (self.rid, msg))
        self.ready_info = (msg[1] if len(msg) > 1
                           and isinstance(msg[1], dict) else {})
        self.params_step = self.ready_info.get('params_step')
        self.last_heartbeat = time.perf_counter()
        self.clock.observe(self.ready_info.get('t_mono'),
                           self.last_heartbeat)
        self._receiver = threading.Thread(target=self._recv_loop,
                                          daemon=True,
                                          name='mesh-recv-%s' % self.rid)
        self._receiver.start()

    def _control_call(self, kind: str, *payload,
                      timeout: Optional[float] = 600.0):
        future: Future = Future()
        with self._lock:
            seq = self._seq
            self._seq += 1
            self._control[seq] = future
            self._channel.send((kind, seq) + payload)
        return future.result(timeout)

    def dispatch(self, tier: str, taken: List[_Request], rows: int) -> None:
        batches = [request.batch for request in taken]
        # one trace context a member (None for an untraced one): the
        # worker runs its engine's spans under it and ships them back;
        # they are re-parented here, under the member's span, at
        # adoption, so the context stays small. The scenario rides along
        # so the worker's envelope stays attributable per workload
        ctxs = [None if request.trace is None else
                {'trace_id': request.trace.trace_id,
                 'sampled': request.trace.sampled,
                 'scenario': (request.trace.root.attrs
                              or {}).get('scenario')}
                for request in taken]
        seq = None
        try:
            with self._lock:
                seq = self._seq
                self._seq += 1
                self._pending[seq] = (taken, rows)
                self._channel.send(('dispatch', seq, tier, batches, ctxs))
        except BaseException as exc:
            entry = None
            if seq is not None:
                with self._lock:
                    entry = self._pending.pop(seq, None)
            # a dead wire at send time is a worker death with this batch
            # in flight: its members go to the mesh's crash-safe
            # redispatch, then the raise lets the puller's breaker count
            # the failure. The receiver's EOF path may race this; whoever
            # pops the pending entry owns the requests.
            if entry is not None:
                try:
                    self._on_worker_dead(
                        self, [entry],
                        WireError('mesh replica %s wire send failed: %r'
                                  % (self.rid, exc)))
                except Exception:
                    for request in entry[0]:
                        request.fail(EngineClosed(
                            'mesh replica %s wire send failed: %r'
                            % (self.rid, exc)))
            raise
        # the worker's queue wait is not this process's: close the span
        # at the hand-off
        now = time.perf_counter()
        for request in taken:
            if request.queue_span is not None:
                request.trace.end(request.queue_span, now)
                request.queue_span = None

    def _recv_loop(self) -> None:
        while True:
            try:
                msg = self._channel.recv()
                # a partition loses frames while both ends stay up:
                # results and heartbeats vanish, and the liveness
                # monitor is what notices
                if faults.maybe_fire('partition'):
                    continue
                if msg[0] == 'heartbeat':
                    transport_lib.check_heartbeat(msg[2])
            except (EOFError, OSError, WireError) as exc:
                # the worker died (EOF) or its stream is poisoned: drain
                # the in-flight state once and report the death
                with self._lock:
                    pending = list(self._pending.values())
                    self._pending.clear()
                    control = list(self._control.values())
                    self._control.clear()
                dead = ReplicaDead(
                    'mesh replica %s worker died (%r) with %d dispatch(es) '
                    'in flight' % (self.rid, exc, len(pending)))
                for future in control:
                    if not future.done():
                        future.set_exception(dead)
                try:
                    self._on_worker_dead(self, pending, dead)
                except Exception:
                    # the death path must not strand a caller
                    for taken, _rows in pending:
                        for request in taken:
                            request.fail(dead)
                return
            self.last_heartbeat = time.perf_counter()
            kind, seq = msg[0], msg[1]
            if kind == 'heartbeat':
                beat = msg[2]
                self.clock.observe(beat.t_mono, self.last_heartbeat)
                self.heartbeat_info = {'inflight': beat.inflight}
                if beat.ledger:
                    self.ledger_info = beat.ledger
                # spans that missed their result frame (they finished
                # late, or a crash is about to orphan them) ride the beat
                # and are stitched while their dispatch is still pending
                self._adopt_pending_bundles(beat.spans)
                if beat.telemetry is not None and \
                        self._on_telemetry is not None:
                    try:
                        self._on_telemetry(self, beat.telemetry,
                                           beat.ledger)
                    except Exception:
                        # a failed merge never kills the receiver
                        logger.exception('mesh: replica %s telemetry merge '
                                         'failed', self.rid)
                continue
            if kind in ('result', 'error'):
                with self._lock:
                    entry = self._pending.pop(seq, None)
                    ctrl = self._control.pop(seq, None)
                if entry is not None:
                    taken, rows = entry
                    if kind == 'result':
                        # the worker's spans are grafted before the
                        # delivery finishes the traces: a finished trace
                        # is written and can no longer be stitched
                        self._adopt_member_bundles(
                            seq, taken, msg[3] if len(msg) > 3 else None)
                        for request, results in zip(taken, msg[2]):
                            request.deliver(results)
                            request.finish_trace()
                        self._on_batch_done(self, rows, taken, True)
                    else:
                        for request in taken:
                            request.fail(msg[2])
                        self._on_batch_done(self, rows, taken, False)
                elif ctrl is not None:
                    if kind == 'result':
                        _resolve(ctrl, msg[2])
                    elif not ctrl.done():
                        ctrl.set_exception(msg[2])
            elif kind == 'closed':
                with self._lock:
                    ctrl = self._control.pop(seq, None)
                if ctrl is not None:
                    _resolve(ctrl, None)
                return

    # ------------------------------------------------ trace stitching
    def _adopt_one(self, request: Optional[_Request],
                   spans: List[dict]) -> Tuple[int, int]:
        """Graft one bundle's records into its member's live trace:
        (adopted, dropped)."""
        if request is None or request.trace is None:
            return 0, len(spans)
        adopted = request.trace.adopt_spans(
            spans, self.clock.offset, parent=request.span_parent)
        return adopted, len(spans) - adopted

    def _note_spans(self, adopted: int, dropped: int) -> None:
        if (adopted or dropped) and self._on_spans is not None:
            self._on_spans(adopted, dropped)

    def _adopt_member_bundles(self, seq: int, taken: List[_Request],
                              bundles) -> None:
        """The result frame's stitching. The worker collects the bundles
        of this dispatch alone (``sink.collect(seq)``), so a bundle's
        member index names its request; one whose seq or member does not
        match is dropped and counted, never grafted onto another
        request."""
        if not bundles:
            return
        adopted = dropped = 0
        for bundle in bundles:
            member = bundle.get('member')
            request = (taken[member]
                       if bundle.get('seq') == seq
                       and isinstance(member, int)
                       and 0 <= member < len(taken) else None)
            got, lost = self._adopt_one(request, bundle.get('spans') or [])
            adopted += got
            dropped += lost
        self._note_spans(adopted, dropped)

    def _adopt_pending_bundles(self, bundles) -> None:
        """A heartbeat's stitching: each bundle names its dispatch seq;
        one whose dispatch has concluded (its traces finished and
        written) is counted as dropped, never grafted."""
        if not bundles:
            return
        adopted = dropped = 0
        for bundle in bundles:
            with self._lock:
                entry = self._pending.get(bundle.get('seq'))
            request = None
            if entry is not None:
                member = bundle.get('member')
                taken = entry[0]
                if isinstance(member, int) and 0 <= member < len(taken):
                    request = taken[member]
            got, lost = self._adopt_one(request, bundle.get('spans') or [])
            adopted += got
            dropped += lost
        self._note_spans(adopted, dropped)

    @property
    def pid(self) -> Optional[int]:
        """The worker's process id (an adopted worker's as its hello
        gave it: the process is not this one's child)."""
        return (self._proc.pid if self._proc is not None
                else self.hello.get('pid'))

    def cancel(self) -> None:
        """Abort a ``wait_ready`` in flight (the mesh closing
        mid-start)."""
        self._cancel.set()
        self.kill()

    def kill(self) -> None:
        """Hard-stop a hung or partitioned worker. A spawned one gets
        SIGKILL only: its end of the wire closes with it, so the blocked
        receiver sees EOF and runs the death path there, once; the pipe
        is never closed under a running receiver, since
        ``multiprocessing``'s reader re-reads a closed connection's
        handle and fails with a ``TypeError`` no death path would catch.
        An adopted one is no child of this process: its socket is shut
        down, which the receiver reads as EOF."""
        if self._proc is None:
            if self._channel is not None:
                self._channel.close()
            return
        try:
            if self._proc.is_alive():
                self._proc.kill()
        except Exception:
            pass

    def reap(self) -> None:
        """Kill and join a worker that is dead or being abandoned, wait
        for its receiver to finish, then close the wire; no close
        handshake."""
        self.kill()
        if self._proc is not None:
            try:
                self._proc.join(timeout=30.0)
            except Exception:
                pass
        self.join()
        for end in (self._channel, self._conn):
            if end is not None:
                try:
                    end.close()
                except OSError:
                    pass

    def join(self, timeout: float = 30.0) -> None:
        """Wait for the receiver to end (after a worker's death it runs
        the redispatch and the reap)."""
        receiver = self._receiver
        if receiver is not None and \
                receiver is not threading.current_thread():
            receiver.join(timeout)

    def warmup(self) -> None:
        pass  # the worker warms before it reports ready

    def load_params(self, source, canary_batches: int,
                    min_agreement: float) -> Future:
        """Arm a canaried rollover in the worker; the returned future
        resolves with its report (a parent-side waiter polls: the canary
        concludes on the worker's live traffic)."""
        if not isinstance(source, (int, str)) or isinstance(source, bool):
            raise RuntimeError(
                'worker-mode replicas roll over from checkpoint refs (a '
                'step or a model path), not parameter sets: parameters '
                'on the card do not cross processes')
        self._control_call('load_params', source, canary_batches,
                           min_agreement)
        handle: Future = Future()

        def wait() -> None:
            try:
                while True:
                    report = self._control_call('poll_rollover')
                    if report is not None:
                        if report.get('swapped'):
                            self.params_step = report.get('step')
                        _resolve(handle, report)
                        return
                    time.sleep(0.05)
            except Exception as exc:
                if not handle.done():
                    handle.set_exception(exc)

        threading.Thread(target=wait, daemon=True,
                         name='mesh-canary-%s' % self.rid).start()
        return handle

    def adopt(self, params, source, step: Optional[int]) -> None:
        # the fleet swap ships the checkpoint reference: the worker
        # restores it (the canary validated it on live traffic;
        # canary_batches=0 swaps without a second canary)
        del params   # parameters on the card do not cross processes
        self._control_call('load_params', source, 0, 0.0)
        while True:
            report = self._control_call('poll_rollover')
            if report is not None:
                break
            time.sleep(0.02)
        if not report.get('swapped'):
            raise RuntimeError('mesh replica %s did not adopt %r: %s'
                               % (self.rid, source, report.get('reason')))
        self.params_step = report.get('step', step)

    def stats(self) -> Dict[str, object]:
        return self._control_call('stats')

    def close(self) -> None:
        """The close handshake (the worker closes its engine and exits),
        then the reap; a worker that never became ready is reaped at
        once."""
        if self._receiver is not None:
            try:
                self._control_call('close', timeout=60.0)
                if self._proc is not None:
                    self._proc.join(timeout=60.0)
            except Exception:
                pass   # a dead worker's wire refuses the handshake
        self.reap()


def _worker_stats(engine: ServingEngine, device) -> Dict[str, object]:
    """A worker's ``stats`` answer: its engine's, with the process id,
    the kernel wrappers' launches in this process (the warm-up runs and
    captures; replays run inside the graphs) and the card's memory as
    this process holds it."""
    import torch
    from code2vec_tpu_torch.ops import encode, ragged
    out = engine.stats()
    out['pid'] = os.getpid()
    out['kernel_launches'] = {'ragged_fwd': ragged.launches,
                              'encode': encode.launches}
    out['device_memory'] = (
        {'allocated': torch.cuda.memory_allocated(device),
         'reserved': torch.cuda.memory_reserved(device)}
        if device.type == 'cuda' else None)
    return out


def _worker_ledger_rollup() -> Dict[str, object]:
    """A compact view of this worker's memory ledger for the heartbeat:
    enough for the mesh's view of each worker's card memory (pressure
    visible before the worker runs out), small enough for every beat."""
    from code2vec_tpu_torch.telemetry import memory as memory_lib
    ledger = memory_lib.ledger()
    return {'attributed_bytes': ledger.attributed_bytes(),
            'budget_bytes': ledger.budget_bytes(),
            'buckets': {bucket: ledger.bucket_bytes(bucket)
                        for bucket in memory_lib.BUCKETS}}


def _device_indices(device) -> List[int]:
    """The indices of the cards an unplaced worker serves on: its one
    card's, none on the CPU."""
    if device.type != 'cuda':
        return []
    import torch
    return [device.index if device.index is not None
            else torch.cuda.current_device()]


def _replica_worker_main(rid: str, config_overrides: Dict[str, object],
                         conn, address, pinned=None) -> None:
    """A worker replica's entry point (spawned by the mesh, or run by
    ``serving/mesh_worker.py`` outside it): build the model from the
    shipped config on its DEVICE, warm one external-dispatch engine, and
    serve the framed wire, a pipe (``conn``) in process mode or a dial to
    the mesh's listener (``address``) in socket mode.

    Under placement (MESH_DEVICE_INDICES in the overrides) it pins itself
    to its slice first, before any CUDA call (``parallel/mesh.py::
    pin_to_slice``), and reports the slice and its card's UUID in its
    ready frame; a pin that fails is its cold start's typed failure
    (``PlacementError``), never a run on another card. ``pinned`` is
    ``(slice, UUIDs)`` of a caller that pinned the process itself
    (``serving/mesh_worker.py``, before its own first CUDA call)."""
    import signal
    pin_error = None
    indices = str(config_overrides.get('MESH_DEVICE_INDICES') or '')
    if indices and pinned is None:
        try:
            slice_ = parallel_mesh.parse_device_indices(indices)
            pinned = (slice_, parallel_mesh.pin_to_slice(slice_))
        except Exception as exc:
            pin_error = PlacementError('worker %s could not pin to cards '
                                       '%s: %s' % (rid, indices, exc))
    # pinned: the card is this process's device 0, its numbering's own
    config_overrides = dict(config_overrides, MESH_DEVICE_INDICES='')
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    if conn is not None:
        channel = transport_lib.PipeTransport(conn)
    else:
        channel = transport_lib.dial(address, rid, os.getpid())
    # the beat thread and the serve loop share the send side
    send_lock = threading.Lock()

    def send(message) -> None:
        with send_lock:
            channel.send(message)

    try:
        if pin_error is not None:
            raise pin_error
        config = Config(**config_overrides)
        # the mesh resolved the backhaul when it spawned this worker; an
        # adopted worker takes it from its config, and AUTO there is off
        backhaul = config.MESH_TELEMETRY_BACKHAUL == 1
        if backhaul:
            # before the model and the engine: the ladder's captures and
            # the kernels' loads count in this worker's jit/* series, so
            # the fleet export shows a capture after warm-up per replica
            tele_core.enable()
        model = Code2VecModel(config, device=config.DEVICE)
        # the engine's own tracer stays off: the spans it records go into
        # the members' traces, which the span sink below ships home
        engine = model.serving_engine(
            tiers=config.serving_warm_tiers, external_dispatch=True,
            replica_id=rid, tracing_sample_rate=0.0)
        if engine.device.type == 'cuda':
            # the warm-up's eager runs leave freed blocks in this
            # process's cache, which no other process could use: a worker
            # keeps what it serves (its tables, slots and graph pool)
            import torch
            torch.cuda.empty_cache()
    except BaseException as exc:
        # the parent learns why this replica died, not just an EOF (no
        # GPU, a kernel that did not build, no retained step, ...)
        try:
            send(('failed', repr(exc)))
        except Exception:
            pass
        raise
    rollover: Dict[str, object] = {'handle': None}
    inflight = [0]
    stop_beats = threading.Event()
    # the worker's half of the stitching: each traced member runs under
    # the parent's context, and its finished spans go home on the result
    # frame or a heartbeat
    sink = tracing_lib.RemoteSpanSink(rid)

    def beat_loop() -> None:
        """Liveness apart from dispatch: a busy worker still beats; a
        hung or drilled one goes silent and the mesh's liveness monitor,
        not the breaker, declares it dead. With the backhaul on, a beat
        also carries the spans that missed their result frame, the
        registry snapshot and the ledger rollup; with it off, liveness
        and the clock stamp only."""
        period = float(config.MESH_HEARTBEAT_SECS)
        if period <= 0:
            return
        while not stop_beats.wait(period):
            if faults.maybe_fire('drop_heartbeat'):
                continue   # the drilled shape of a hung worker
            spans, telemetry, ledger = [], None, None
            if backhaul:
                try:
                    telemetry = tele_core.registry().snapshot()
                    ledger = _worker_ledger_rollup()
                except Exception:
                    telemetry, ledger = None, None
                # a bundle younger than half a beat is left to its own
                # result frame
                spans = sink.drain(min_age_s=period / 2)
            try:
                send(('heartbeat', -1, transport_lib.Heartbeat(
                    inflight=inflight[0], t_mono=time.perf_counter(),
                    spans=spans, telemetry=telemetry, ledger=ledger)))
            except Exception:
                return   # the wire is gone: the serve loop exits too

    if faults.maybe_fire('adopt_stall'):
        # a worker wedged between its dial-in and its ready frame: the
        # mesh's bounded wait (the adoption's or the cold start's) drops
        # it typed instead of hanging
        time.sleep(faults.ADOPT_STALL_SECONDS)
    # 'devices': the cards this worker serves on, in the numbering of the
    # process that placed it (its slice when pinned; none on the CPU), and
    # their UUIDs: the mesh checks a placed worker's against its slice
    if pinned is not None:
        devices, uuids = list(pinned[0]), list(pinned[1])
    else:
        devices = _device_indices(engine.device)
        uuids = [parallel_mesh.card_uuid(i) for i in devices]
    send(('ready', {
        'params_step': engine.params_step,
        't_mono': time.perf_counter(),
        'capabilities': {'tiers': list(engine.tiers),
                         'wire': config.BATCH_WIRE_FORMAT,
                         'proto': transport_lib.WIRE_PROTO,
                         'device': str(engine.device),
                         'devices': devices, 'device_uuids': uuids},
    }))
    beats = threading.Thread(target=beat_loop, daemon=True,
                             name='mesh-beat-%s' % rid)
    beats.start()
    try:
        while True:
            msg = channel.recv()
            kind, seq = msg[0], msg[1]
            if kind == 'adopt_rejected':
                # a worker started outside the mesh was turned away: it
                # exits with the mesh's reason
                raise AdoptionRejected('the mesh refused replica %s: %s'
                                       % (rid, seq))
            try:
                if kind == 'dispatch':
                    if faults.maybe_fire('kill_worker'):
                        # SIGKILL mid-batch: the parent holds this
                        # dispatch in flight, so the drill runs the
                        # crash-safe redispatch
                        os.kill(os.getpid(), signal.SIGKILL)
                    tier, batches = msg[2], msg[3]
                    ctxs = (msg[4] if len(msg) > 4 and backhaul
                            else [None] * len(batches))
                    requests = [
                        _Request(batch, tier, future=Future(),
                                 trace=(sink.begin('serving.remote', ctx,
                                                   seq, member)
                                        if ctx is not None else None))
                        for member, (batch, ctx) in enumerate(
                            zip(batches, ctxs))]
                    rows = sum(request.rows for request in requests)
                    inflight[0] += 1
                    try:
                        engine.dispatch_external(tier, requests, rows)
                        results = [request.future.result(timeout=600)
                                   for request in requests]
                    finally:
                        inflight[0] -= 1
                    # the members' traces finish on the decode threads
                    # just after their futures resolve: wait for them, so
                    # the result frame carries the whole bundle set (a
                    # late one rides the next heartbeat)
                    sink.wait_finished([r.trace for r in requests],
                                       timeout=5.0)
                    if faults.maybe_fire('kill_worker_after_execute'):
                        # die after the device work, before the result
                        # frame: the work is done and lost. The sleep lets
                        # a heartbeat carry the finished spans home first,
                        # so the redispatched request shows both
                        # incarnations' device work
                        time.sleep(max(0.5, 3 * config.MESH_HEARTBEAT_SECS))
                        os.kill(os.getpid(), signal.SIGKILL)
                    send(('result', seq, results, sink.collect(seq)))
                elif kind == 'load_params':
                    source, n_canary, floor = msg[2], msg[3], msg[4]
                    rollover['handle'] = engine.load_params(
                        source, canary_batches=n_canary,
                        min_agreement=floor)
                    send(('result', seq, True))
                elif kind == 'poll_rollover':
                    handle = rollover['handle']
                    if handle is not None and handle.done():
                        rollover['handle'] = None
                        send(('result', seq, handle.result()))
                    else:
                        send(('result', seq, None))
                elif kind == 'stats':
                    send(('result', seq, _worker_stats(engine,
                                                       engine.device)))
                elif kind == 'close':
                    engine.close()
                    send(('closed', seq))
                    return
                else:
                    raise RuntimeError('unknown mesh wire message %r'
                                       % (kind,))
            except Exception as exc:
                try:
                    send(('error', seq, exc))
                except Exception:
                    send(('error', seq, RuntimeError(repr(exc))))
    finally:
        stop_beats.set()
        engine.close()


class ServingMesh:
    """N engine replicas behind one shared front queue. Build it with
    ``Code2VecModel.serving_mesh()``. Thread-safe, with the single
    engine's surface (``submit`` / ``predict`` / ``submit_neighbors`` /
    ``load_params`` / ``follow_checkpoints`` / ``close``)."""

    # the replica table, the fleet's service window, the rollover slot,
    # the restart hand-off and the close flags are shared by submitters,
    # the pullers, the completion hooks, the supervisor, the liveness
    # monitor and control calls under _lock (_cond wraps it). Lock order:
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
                 heartbeat_secs: Optional[float] = None,
                 heartbeat_misses: Optional[int] = None,
                 restart_limit: Optional[int] = None,
                 restart_window_secs: Optional[float] = None,
                 restart_backoff_secs: Optional[float] = None,
                 tracer: Optional[tracing_lib.Tracer] = None,
                 tracing_sample_rate: Optional[float] = None,
                 log=None):
        config = model.config
        self.config = config
        self.log = log if log is not None else logger.info
        n = int(replicas if replicas is not None else config.MESH_REPLICAS)
        if n < 1:
            raise ValueError('a mesh needs >= 1 replica, got %d' % n)
        self.mode = mode if mode is not None else config.MESH_REPLICA_MODE
        if self.mode not in REPLICA_MODES:
            raise ValueError("MESH_REPLICA_MODE must be 'thread', "
                             "'process' or 'socket', got %r" % (self.mode,))
        if self.mode != 'thread' and param_source is not None:
            raise ValueError(
                'a %s-mode mesh takes no param_source: its workers restore '
                "from the model's checkpoint path" % self.mode)
        # self-healing knobs (the worker modes)
        self.heartbeat_secs = float(
            heartbeat_secs if heartbeat_secs is not None
            else config.MESH_HEARTBEAT_SECS)
        self.heartbeat_misses = max(1, int(
            heartbeat_misses if heartbeat_misses is not None
            else config.MESH_HEARTBEAT_MISSES))
        self.restart_limit = max(0, int(
            restart_limit if restart_limit is not None
            else config.MESH_RESTART_LIMIT))
        self.restart_window_s = float(
            restart_window_secs if restart_window_secs is not None
            else config.MESH_RESTART_WINDOW_SECS)
        self.restart_backoff_s = float(
            restart_backoff_secs if restart_backoff_secs is not None
            else config.MESH_RESTART_BACKOFF_SECS)
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
        # placement: the host's cards in disjoint slices, one a worker,
        # reserved up to the autoscaler's ceiling so that a scale-up never
        # fails on a card the mesh could have reserved at build
        self.devices_per_replica = max(
            0, int(config.MESH_DEVICES_PER_REPLICA))
        self._placement: Optional[List[List[int]]] = None
        # slices handed to workers still in their cold start
        self._slices_starting: List[List[int]] = []
        if self.devices_per_replica > 0:
            if self.mode == 'thread':
                raise ValueError(
                    'MESH_DEVICES_PER_REPLICA needs a worker mode '
                    "(MESH_REPLICA_MODE 'process' or 'socket'): thread "
                    "replicas dispatch through the parent trainer's "
                    'programs, which are compiled over the FULL parent '
                    'mesh and cannot be re-placed per replica')
            n_slices = n
            if config.AUTOSCALE_MAX_REPLICAS > 0:
                n_slices = max(n, int(config.AUTOSCALE_MAX_REPLICAS))
            self._placement = parallel_mesh.partition_device_indices(
                n_slices, self.devices_per_replica)
        # the submit-side tokenizer and ladder geometry, the replicas'
        # own: what makes a result through the mesh bit-identical to a
        # single engine's (a slice is one card: its data axis is 1)
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
        # the canaried index swap in flight, and the serving index's version
        self._index_rollover: Optional[Dict[str, object]] = None
        self._index_version = 0
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
        # self-healing state: the close event interrupts the supervisor's
        # backoffs; _starting holds the workers in their cold start (a
        # restart, a scale-up, an adoption waiting for its ready frame),
        # which close() cancels, so a fail-fast close never waits out or
        # leaks one
        self._close_event = threading.Event()
        self._starting: set = set()
        self._supervisor: Optional[threading.Thread] = None
        self._liveness_thread: Optional[threading.Thread] = None
        self._listener: Optional[transport_lib.SocketListener] = None
        self._worker_overrides: Optional[Dict[str, object]] = None
        # the elastic fleet: the model builds new replicas; rids stay
        # unique across scale-downs and scale-ups; the adoption thread
        # seats workers started outside the mesh (socket mode)
        self._model = model
        self._next_rid = n
        self._adopt_thread: Optional[threading.Thread] = None
        #: an adopted worker's wait from its dial-in to its ready frame,
        #: its cold start included (it dials first, then builds and warms)
        self.adopt_ready_timeout_s = _WORKER_START_TIMEOUT_S
        self._autoscaler = None
        self.requests_total = Counter('mesh/requests_total')
        self.rollover_total = Counter('mesh/rollover_total')
        self.rollover_rollbacks_total = Counter(
            'mesh/rollover_rollbacks_total')
        self.breaker_open_total = Counter('mesh/replica_breaker_open_total')
        self.replicas_gauge = Gauge('mesh/replicas')
        self.serving_gauge = Gauge('mesh/replicas_serving')
        self.live_gauge = Gauge('mesh/replicas_live')
        self.retired_total = Counter('mesh/retired_total')
        self.restarts_total = Counter('mesh/restarts_total')
        self.redispatched_total = Counter('mesh/redispatched_total')
        self.heartbeat_misses_total = Counter('mesh/heartbeat_misses_total')
        # workers started outside the mesh, adopted and turned away
        self.adopted_total = Counter('mesh/adopted_total')
        self.adoption_rejected_total = Counter(
            'mesh/adoption_rejected_total')
        # the fleet observability backhaul: spans stitched and dropped,
        # worker snapshots merged
        self.adopted_spans_total = Counter('tracing/adopted_spans_total')
        self.remote_spans_dropped_total = Counter(
            'tracing/remote_spans_dropped_total')
        self.worker_snapshots_total = Counter('mesh/worker_snapshots_total')
        self.index_rollover_total = Counter('index/rollovers_total')
        self.index_rollover_rollbacks_total = Counter(
            'index/rollover_rollbacks_total')
        self.index_rollover_agreement = Gauge('index/rollover_agreement')
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
        # the admission traffic tap (workloads/profile.py), armed by
        # record_traffic; a racy read of None skips one record
        self._traffic_recorder = None
        # runs the searches of vector-array neighbor queries and an index
        # rollover's shadow searches
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
            if self.mode == 'socket':
                # the workers dial in: the listener is up before the first
                # spawn (MESH_SOCKET_HOST is its bind address)
                self._listener = transport_lib.SocketListener(
                    config.MESH_SOCKET_HOST)
            if self.mode != 'thread':
                self._worker_overrides = self._process_config_overrides(
                    model)
            for i in range(n):
                rid = 'r%d' % i
                device_indices = None
                if self.mode == 'thread':
                    transport = self._build_replica(rid, self._params_step)
                else:
                    with self._lock:
                        device_indices = self._allocate_slice_locked()
                    transport = self._spawn_worker(rid, device_indices)
                slot = _ReplicaSlot(rid, transport)
                slot.device_indices = device_indices
                self._replicas.append(slot)
            for slot in self._replicas:
                # the workers started above cold-start in parallel; this
                # collects their ready handshakes
                slot.transport.wait_ready()
                slot.devices = self._check_placement(slot.transport,
                                                     slot.device_indices)
            with self._lock:
                self._slices_starting.clear()
        except BaseException:
            # no replica is left behind: a mesh never runs with fewer
            # replicas than asked for
            self._queue.close()
            for slot in self._replicas:
                try:
                    slot.transport.close()
                except BaseException:
                    pass
            if self._listener is not None:
                self._listener.close()
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
        if self.mode != 'thread':
            # the self-healing layer: the supervisor restarts dead workers
            # under the budget; the liveness monitor catches the hung or
            # partitioned ones the breaker cannot see
            self._supervisor = threading.Thread(
                target=self._supervise_loop, daemon=True,
                name='mesh-supervisor')
            self._supervisor.start()
            if self.heartbeat_secs > 0:
                self._liveness_thread = threading.Thread(
                    target=self._liveness_loop, daemon=True,
                    name='mesh-liveness')
                self._liveness_thread.start()
        if self.mode == 'socket':
            # dial-ins with a rid the mesh never spawned: workers started
            # outside it, asking to join
            self._adopt_thread = threading.Thread(
                target=self._adoption_loop, daemon=True, name='mesh-adopt')
            self._adopt_thread.start()
        if config.AUTOSCALE_MAX_REPLICAS > 0:
            self._autoscaler = Autoscaler(self, config, tracer=self._tracer,
                                          log=self.log).start()

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

    def _allocate_slice_locked(self) -> Optional[List[int]]:
        """The first free slice of the placement table (None with
        placement off). Slices of slots that are not retired, and of
        workers still in their cold start, are taken: a retired slot's
        slice is free for the next scale-up; a restart reuses its own
        slot's slice without coming here. Every slice held raises."""
        if self._placement is None:
            return None
        used = {tuple(s.device_indices) for s in self._replicas
                if s.device_indices is not None and not s.retired}
        used.update(tuple(indices) for indices in self._slices_starting)
        for indices in self._placement:
            if tuple(indices) not in used:
                self._slices_starting.append(list(indices))
                return list(indices)
        raise PlacementError(
            'no free device slice: %d slices of %d device(s) are all '
            'held by serving replicas (raise AUTOSCALE_MAX_REPLICAS/'
            'MESH_REPLICAS only as far as the placement table allows)'
            % (len(self._placement), self.devices_per_replica))

    def _release_starting_slice(self, indices: Optional[List[int]]) -> None:
        """A cold start's slice handed back (seated, or failed)."""
        if indices is None:
            return
        with self._lock:
            if indices in self._slices_starting:
                self._slices_starting.remove(indices)

    def _check_placement(self, transport: _WorkerReplica,
                         device_indices: Optional[List[int]]
                         ) -> Optional[List[int]]:
        """A ready worker's reported cards, checked against its slice: the
        same indices, and on the card the UUIDs this process sees at them.
        A worker elsewhere is reaped and raises ``PlacementError``. A
        thread replica reports none."""
        if self.mode == 'thread':
            return None
        caps = transport.ready_info.get('capabilities') or {}
        devices = caps.get('devices')
        if device_indices is None:
            return list(devices) if devices else None
        problem = None
        if list(devices or ()) != list(device_indices):
            problem = 'it reports cards %s' % (devices,)
        elif self._model.device.type == 'cuda':
            want = [parallel_mesh.card_uuid(i) for i in device_indices]
            if list(caps.get('device_uuids') or ()) != want:
                problem = ('its card has UUID %s, card %s here is %s'
                           % (caps.get('device_uuids'), device_indices,
                              want))
        if problem is not None:
            transport.reap()
            raise PlacementError('mesh replica %s was placed on cards %s, '
                                 'but %s' % (transport.rid, device_indices,
                                             problem))
        return list(devices)

    def _spawn_worker(self, rid: str,
                      device_indices: Optional[List[int]] = None
                      ) -> _WorkerReplica:
        """One worker (the fleet's build, a supervised restart, a
        scale-up): it cold-starts from the checkpoint store, on its slice
        under placement, and reports ready over the framed wire."""
        if faults.maybe_fire('spawn_fail'):
            raise RuntimeError('FAULT_INJECT spawn_fail: worker %s spawn '
                               'refused before process start' % rid)
        overrides = dict(self._worker_overrides)
        if device_indices:
            # placement: the worker pins itself to exactly this slice
            overrides['MESH_DEVICE_INDICES'] = ','.join(
                str(i) for i in device_indices)
        if overrides.get('MESH_TELEMETRY_BACKHAUL', -1) == -1:
            # AUTO is resolved here, at each spawn, not when the mesh was
            # built: telemetry enabled later reaches every restarted or
            # added worker, so the fleet merge never stays partial
            overrides['MESH_TELEMETRY_BACKHAUL'] = (
                1 if tele_core.enabled() else 0)
        if self._listener is not None:
            # registered before the process exists: its dial-in lands in
            # the claim table
            self._listener.expect(rid)
        return _WorkerReplica(
            rid, self.mode, overrides,
            on_batch_done=self._on_worker_batch_done,
            on_worker_dead=self._on_worker_dead,
            on_telemetry=self._on_worker_telemetry,
            on_spans=self._note_stitched, listener=self._listener)

    def _process_config_overrides(self, model) -> Dict[str, object]:
        """The config a worker rebuilds its model from: the parent's
        plain fields, pointed at the parent's checkpoint path (parameters
        on the card do not cross processes; the store does), on the
        parent model's device."""
        import dataclasses
        config = model.config
        load_path = (config.MODEL_LOAD_PATH if config.is_loading
                     else config.MODEL_SAVE_PATH
                     if config.is_saving else None)
        if load_path is None:
            raise RuntimeError(
                "MESH_REPLICA_MODE='%s' needs a checkpointed model (a "
                '--save or --load path with at least one retained step): '
                'worker processes restore params from the store, they '
                'cannot share the parent\'s arrays' % self.mode)
        overrides = {}
        for field in dataclasses.fields(type(config)):
            value = getattr(config, field.name, None)
            if isinstance(value, (bool, int, float, str, type(None))):
                overrides[field.name] = value
        overrides['MODEL_LOAD_PATH'] = load_path
        overrides['MODEL_SAVE_PATH'] = ''
        overrides['TRAIN_DATA_PATH_PREFIX'] = ''
        overrides['SERVE_FOLLOW_CHECKPOINTS_SECS'] = 0.0
        # the worker runs where the parent model runs: 'cpu' in the tests,
        # the card otherwise (and with no card it fails its cold start);
        # on its slice under placement (set at each spawn), else on the
        # default card
        overrides['DEVICE'] = model.device.type
        overrides['MESH_DEVICE_INDICES'] = ''
        # the worker beats at the mesh's period, which the liveness
        # monitor divides by
        overrides['MESH_HEARTBEAT_SECS'] = self.heartbeat_secs
        # the worker warms the mesh's tiers, not the config's default
        overrides['SERVING_WARM_TIERS'] = ','.join(self.tiers)
        return overrides

    def _begin_start(self, transport: _WorkerReplica) -> None:
        """Register a worker in its cold start, so that close() can
        cancel it. A close that came first cancels it here: close() sets
        its event before it reads the set, and this reads the event after
        the add, so one of the two sees the other."""
        with self._lock:
            self._starting.add(transport)
        if self._close_event.is_set():
            transport.cancel()

    def _end_start(self, transport: _WorkerReplica) -> None:
        with self._lock:
            self._starting.discard(transport)

    def _start_puller(self, slot: _ReplicaSlot) -> None:
        # the puller is pinned to the slot's current incarnation
        slot.thread = threading.Thread(
            target=self._pull_loop, args=(slot, slot.transport),
            daemon=True, name='mesh-pull-%s' % slot.rid)
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

    def _slot_ready_locked(self, slot: _ReplicaSlot, transport) -> str:
        """'ready' | 'wait' | 'exit' for one puller iteration."""
        if slot.retired or slot.dead or slot.transport is not transport:
            return 'exit'   # a dead or replaced incarnation: its puller ends
        if self._closed and not self._drain:
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

    def _slot_alive(self, slot: _ReplicaSlot, transport) -> bool:
        """The puller's claim check inside ``pop_coalesced``: a replica
        that retired, died, was replaced or tripped its breaker while
        waiting leaves without taking work."""
        with self._lock:
            return not (slot.retired or slot.dead
                        or slot.transport is not transport
                        or slot.breaker_state == _BREAKER_OPEN
                        or (self._closed and not self._drain))

    def _set_replica_gauges(self) -> None:
        # advisory counts read outside the lock: every caller follows a
        # locked change. Live is the liveness verdict (a breaker-open
        # replica is live, a dead worker is not)
        serving = sum(1 for slot in self._replicas
                      if not slot.retired and not slot.dead
                      and slot.breaker_state != _BREAKER_OPEN)
        live = sum(1 for slot in self._replicas
                   if not slot.retired and not slot.dead)
        self.serving_gauge.set(serving)
        self.live_gauge.set(live)
        if tele_core.enabled():
            reg = tele_core.registry()
            reg.gauge('mesh/replicas_serving').set(serving)
            reg.gauge('mesh/replicas_live').set(live)

    # -------------------------------------------------------- pull loop
    def _pull_loop(self, slot: _ReplicaSlot, transport) -> None:
        # `transport` pins this puller to one incarnation: after a
        # supervised restart the slot has a new transport and a new
        # puller, and this one exits instead of dispatching onto a wire
        # it no longer owns
        while True:
            with self._cond:
                while True:
                    state = self._slot_ready_locked(slot, transport)
                    if state == 'exit':
                        return
                    if state == 'ready':
                        break
                    # a breaker's cooldown ends on the clock, not on a
                    # notification
                    self._cond.wait(0.05)
            popped = self._queue.pop_coalesced(
                self.buckets[-1], self.max_delay_s,
                alive=lambda: self._slot_alive(slot, transport),
                claim=transport)
            if popped is None:
                # the depth is read before the mesh's lock is taken:
                # pop_coalesced holds the queue's lock while it calls
                # alive() (queue, then mesh), so the mesh's lock never
                # waits for the queue's
                depth = self._queue.depth_rows()
                with self._lock:
                    if slot.retired or slot.dead or \
                            slot.transport is not transport or \
                            (self._closed and not self._drain):
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
                transport.dispatch(tier, taken, rows)
            except BaseException as exc:
                # the requests are handled (a thread replica failed them
                # typed; a worker's dead wire sent them to the crash-safe
                # redispatch); the breaker counts the replica's failure
                self._dispatch_failed(slot, exc)
            # the completion arrives on the engine's decode worker
            # (_on_batch_done) or a worker's receiver thread
            # (_on_worker_batch_done)

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
        """The thread replicas' completion hook (on the engine's decode
        worker)."""
        slot = next(s for s in self._replicas
                    if isinstance(s.transport, _ThreadReplica)
                    and s.transport.engine is engine)
        self._complete(slot, rows, taken, ok)

    def _on_worker_batch_done(self, transport: _WorkerReplica, rows: int,
                              taken: List[_Request], ok: bool) -> None:
        """The worker replicas' completion hook (on the receiver
        thread)."""
        slot = next((s for s in self._replicas
                     if s.transport is transport), None)
        if slot is None:
            return   # a late completion of a replaced incarnation
        self._complete(slot, rows, taken, ok)

    def _complete(self, slot: _ReplicaSlot, rows: int,
                  taken: List[_Request], ok: bool) -> None:
        """One dispatched batch delivered or failed: the in-flight
        window, the breaker, the fleet's service window and every
        replica's dispatch share."""
        with self._cond:
            # clamp: a partitioned worker's late delivery can land after
            # its death handler zeroed the window
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
                    # every replica's share moves with the total: each
                    # series is refreshed (0.0 for a replica that has
                    # dispatched nothing), so none goes stale
                    reg = tele_core.registry()
                    for each in self._replicas:
                        reg.gauge(catalog.labeled(
                            'mesh/dispatch_share', 'replica',
                            each.rid)).set(
                                each.rows_dispatched / self._rows_total)
            else:
                self._breaker_failure_locked(slot)
            self._cond.notify_all()
        self._queue.kick()

    # ------------------------------------------- fleet observability
    def _note_stitched(self, adopted: int, dropped: int) -> None:
        """The stitching's accounting (receiver threads): worker spans
        grafted into live traces, and those that came too late."""
        if adopted:
            self.adopted_spans_total.inc(adopted)
        if dropped:
            self.remote_spans_dropped_total.inc(dropped)
        if tele_core.enabled():
            reg = tele_core.registry()
            if adopted:
                reg.counter('tracing/adopted_spans_total').inc(adopted)
            if dropped:
                reg.counter('tracing/remote_spans_dropped_total').inc(
                    dropped)

    def _on_worker_telemetry(self, transport, snapshot, ledger) -> None:
        """The fleet merge of one worker heartbeat: the worker's registry
        snapshot, labeled with its replica id, folds into this process's
        registry, so the exporters write one fleet export, with a worker's
        series where a thread replica's labeled mirror would put them. A
        name the worker already labeled keeps its label; the others get
        ``{replica=<rid>}``. Counters merge by their delta (a restarted
        incarnation counts from 0 again and the fleet series keeps
        accumulating), gauges by the last write, timers as ``MirrorTimer``
        adoptions; a name outside the catalog is skipped."""
        del ledger   # kept on the transport for stats(); the mem/* gauges
        #              come in the snapshot
        self.worker_snapshots_total.inc()
        if not tele_core.enabled():
            return
        reg = tele_core.registry()
        reg.counter('mesh/worker_snapshots_total').inc()
        reg.gauge(catalog.labeled('mesh/clock_offset_ms', 'replica',
                                  transport.rid)).set(
            transport.clock.offset * 1e3)
        for name, value in (snapshot or {}).items():
            base, label = catalog.split_label(name)
            meta = catalog.CATALOG.get(base)
            if meta is None:
                continue
            target = (name if label is not None else
                      catalog.labeled(name, 'replica', transport.rid))
            if isinstance(value, dict):
                reg.mirror_timer(target).adopt(value)
            elif meta['type'] == catalog.COUNTER:
                last = transport._merge_last.get(target, 0)
                delta = value if value < last else value - last
                transport._merge_last[target] = value
                if delta:
                    reg.counter(target).inc(int(delta))
            else:
                try:
                    reg.gauge(target).set(float(value))
                except (TypeError, ValueError):
                    continue

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

    # ------------------------------------------------------ self-healing
    def _on_worker_dead(self, transport: _WorkerReplica,
                        pending: List[Tuple[List[_Request], int]],
                        reason: BaseException) -> None:
        """A worker died: EOF, a corrupt frame, a failed send or a
        liveness kill. Mark its slot dead (the supervisor restarts it
        under the budget), then redispatch the batches that died with
        it: their members go back once to the front of the shared queue
        with this incarnation excluded and their deadlines intact, so the
        crash costs latency, not answers."""
        adopted_exit = False
        with self._cond:
            slot = next((s for s in self._replicas
                         if s.transport is transport), None)
            if slot is not None and not slot.retired and not slot.dead:
                slot.dead = True
                slot.inflight = 0
                if slot.adopted:
                    # its orchestrator owns its restarts: the slot retires
                    # and the local budget is not charged (a redial is a
                    # fresh adoption); its batches still redispatch below
                    slot.retired = True
                    slot.retired_reason = 'adopted_worker_exit'
                    adopted_exit = True
                self._cond.notify_all()   # its puller exits, the
                #                           supervisor wakes
        if slot is None and not pending:
            # a wire that never served: an adoption refused after its
            # ready frame, or a replaced incarnation's late EOF
            transport.reap()
            return
        requeued = failed = 0
        for taken, _rows in pending:
            got = self._redispatch_batch(transport, slot, taken, reason)
            requeued += got
            failed += len(taken) - got
        if adopted_exit:
            self._note_retired('adopted_worker_exit')
        self._set_replica_gauges()
        self._queue.kick()
        if adopted_exit:
            self.log('mesh: adopted replica %s worker exited (%s): %d '
                     'request(s) redispatched, %d failed typed; its '
                     'orchestrator owns the restart, the local budget is '
                     'not charged' % (slot.rid, reason, requeued, failed))
            self._fail_queue_if_fleet_empty()
        else:
            self.log('mesh: replica %s worker DEAD (%s): %d request(s) '
                     'redispatched to the front of the queue, %d failed '
                     'typed; the supervisor restarts it within the budget'
                     % (slot.rid if slot is not None else transport.rid,
                        reason, requeued, failed))
        try:
            transport.reap()   # SIGKILL and join, no handshake
        except Exception:
            pass

    def _redispatch_batch(self, token, slot: Optional[_ReplicaSlot],
                          taken: List[_Request],
                          reason: BaseException) -> int:
        """Re-admit the members of one crashed batch at the front of
        their tier's queue, once a request (a second crash fails it
        typed ``ReplicaDead``). Returns how many were re-admitted."""
        survivors: List[_Request] = []
        for request in taken:
            if request.trace is not None and request.queue_span is not None:
                # a failed send reaches here with the first queue wait
                # still open
                request.trace.end(request.queue_span)
                request.queue_span = None
            if request.redispatched:
                request.fail(ReplicaDead(
                    'request lost its replica twice (%s); failing typed '
                    'instead of bouncing forever' % reason))
                continue
            request.redispatched = True
            request.exclude = token
            if request.trace is not None:
                # the trace shows both attempts: the first queue wait and
                # dispatch, this event, a second queue wait
                request.trace.event(
                    'serving.redispatch', parent=request.span_parent,
                    attrs={'replica': slot.rid if slot else '?',
                           'reason': str(reason)})
                request.queue_span = request.trace.span(
                    'serving.queue_wait', parent=request.span_parent)
            survivors.append(request)
        if not survivors:
            return 0
        if not self._queue.requeue_front(survivors[0].tier, survivors):
            # the mesh closed fail-fast between the death and now
            for request in survivors:
                request.fail(EngineClosed(
                    'ServingMesh closed before the crashed batch could be '
                    'redispatched'))
            return 0
        self.redispatched_total.inc(len(survivors))
        if tele_core.enabled():
            tele_core.registry().counter(
                'mesh/redispatched_total').inc(len(survivors))
        return len(survivors)

    def _liveness_loop(self) -> None:
        """The heartbeat monitor: liveness apart from dispatch health. A
        hung or partitioned worker with nothing in flight looks healthy
        to the breaker; its missing beats betray it. Past the budget the
        worker is killed, and the receiver's EOF runs the one death path
        (redispatch, then supervised restart)."""
        period = self.heartbeat_secs
        while not self._close_event.wait(period):
            if self._slo is not None:
                # the exported burns decay after traffic stops
                self._slo.refresh()
            now = time.perf_counter()
            with self._cond:
                watched = [(s, s.transport) for s in self._replicas
                           if not s.retired and not s.dead
                           and not s.restarting
                           and isinstance(s.transport, _WorkerReplica)]
            for slot, transport in watched:
                missed = (now - transport.last_heartbeat) / period
                if missed < 1.0:
                    continue
                self.heartbeat_misses_total.inc()
                if tele_core.enabled():
                    tele_core.registry().counter(
                        'mesh/heartbeat_misses_total').inc()
                if missed > self.heartbeat_misses:
                    self.log('mesh: replica %s missed %d heartbeats (budget '
                             '%d): hung or partitioned; killing the worker'
                             % (slot.rid, int(missed),
                                self.heartbeat_misses))
                    transport.kill()

    def _supervise_loop(self) -> None:
        """Supervised restart: a dead worker comes back on its own, with
        exponential backoff under a budget per window (a flapping worker
        retires for good), a cold start from the checkpoint store, and
        the fleet's current step adopted before its puller touches the
        queue."""
        while True:
            retire = False
            with self._cond:
                slot = None
                while slot is None:
                    if self._closed:
                        return
                    slot = next((s for s in self._replicas
                                 if s.dead and not s.retired
                                 and not s.restarting), None)
                    if slot is None:
                        self._cond.wait(0.2)
                now = time.perf_counter()
                while slot.restart_times and \
                        now - slot.restart_times[0] > self.restart_window_s:
                    slot.restart_times.popleft()
                if len(slot.restart_times) >= self.restart_limit:
                    slot.retired = True
                    slot.retired_reason = 'restart_budget'
                    retire = True
                else:
                    slot.restarting = True
                    slot.restart_times.append(now)
                attempt = len(slot.restart_times)
                self._cond.notify_all()
            if retire:
                self.log('mesh: replica %s spent its restart budget (%d in '
                         '%.0fs); retiring it, the queue serves through the '
                         'other replicas'
                         % (slot.rid, self.restart_limit,
                            self.restart_window_s))
                self._note_retired('restart_budget')
                self._set_replica_gauges()
                self._fail_queue_if_fleet_empty()
                continue
            backoff = self.restart_backoff_s * (2 ** (attempt - 1))
            if backoff > 0 and self._close_event.wait(min(backoff, 30.0)):
                with self._cond:
                    slot.restarting = False
                return
            self.log('mesh: restarting replica %s (attempt %d in the '
                     'window, backoff %.2fs)' % (slot.rid, attempt, backoff))
            transport = None
            fleet_step = None
            try:
                transport = self._spawn_worker(slot.rid,
                                               slot.device_indices)
                self._begin_start(transport)
                transport.wait_ready()
                devices = self._check_placement(transport,
                                                slot.device_indices)
                fleet_step = self._join_fleet_step(transport)
            except Exception as exc:
                if transport is not None:
                    self._end_start(transport)
                    try:
                        transport.reap()
                    except Exception:
                        pass
                with self._cond:
                    slot.restarting = False   # still dead: retry or budget
                if self._close_event.is_set():
                    return
                self.log('mesh: replica %s restart failed (%r); retrying '
                         'under the budget' % (slot.rid, exc))
                continue
            self._end_start(transport)
            with self._cond:
                closed = self._closed
                if not closed:
                    slot.transport = transport
                    slot.devices = devices
                    slot.dead = False
                    slot.restarting = False
                    slot.inflight = 0
                    slot.breaker_fails = 0
                    slot.breaker_state = _BREAKER_CLOSED
                    slot.restarts += 1
                    self._start_puller(slot)
                    self._cond.notify_all()
            if closed:
                transport.close()
                return
            self.restarts_total.inc()
            if tele_core.enabled():
                tele_core.registry().counter('mesh/restarts_total').inc()
            self._set_replica_gauges()
            self._queue.kick()
            self.log('mesh: replica %s restarted and rejoined the fleet '
                     '(serving step %s)' % (slot.rid, transport.params_step))

    def _join_fleet_step(self, transport: _WorkerReplica) -> Optional[int]:
        """A ready worker cold-started from the newest retained step;
        adopt the fleet's current step into it, which may have rolled
        while it was down. A rollover in flight concludes first, so the
        step read is the one the fleet settled on."""
        with self._cond:
            while self._rollover is not None and not self._closed:
                self._cond.wait(0.1)
            fleet_step = self._params_step
        if fleet_step is not None and transport.params_step != fleet_step:
            self.log("mesh: replica %s came up at step %s; adopting the "
                     "fleet's step %d"
                     % (transport.rid, transport.params_step, fleet_step))
            transport.adopt(None, fleet_step, fleet_step)
        return fleet_step

    # ----------------------------------------------------------- submit
    def submit(self, context_lines: Sequence[str], tier: str = 'topk',
               deadline_ms: Optional[float] = None,
               scenario: Optional[str] = None,
               language: Optional[str] = None,
               record: bool = True, observe: bool = True) -> Future:
        """Enqueue one prediction request on the shared front queue;
        whichever free replica claims it serves it. The single engine's
        contract (typed sheds, oversize split, a Future of one result per
        line, in order).

        ``scenario`` and ``language`` tag the request for the traffic
        plane: the scenario rides the trace root's attrs (and the dispatch
        context) and labels the memo's mirrors and the SLO's
        observations. ``record=False`` skips the traffic tap and
        ``observe=False`` the SLO observation, for the composing entry
        points (``submit_neighbors``, ``submit_blended``), which tap and
        observe once at their own future."""
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
        if record:
            self._record_traffic(scenario or 'softmax_naming', lines,
                                 language=language, tier=tier)
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
            attrs = {'tier': tier, 'rows': n, 'mesh': True,
                     'deadline_ms': 1e3 * deadline_s if deadline_s else None}
            if scenario is not None:
                attrs['scenario'] = scenario
            trace = self._tracer.begin('serving.request', attrs=attrs)
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
            cached = (None if rolling
                      else memo.lookup(memo_key, scenario=scenario))
            if cached is not None:
                if trace is not None:
                    trace.event('serving.memo_hit',
                                attrs={'tier': tier, 'rows': n,
                                       'memo': 'exact'})
                    trace.finish(status='ok')
                if observe and self._slo is not None:
                    self._slo.observe_good(time.perf_counter() - t_submit0,
                                           scenario=scenario)
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
            if observe and self._slo is not None:
                self._slo.observe_bad('shed', scenario=scenario)
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
        if observe and self._slo is not None:
            # one SLO event per caller-visible request, at its future: an
            # oversize request's chunks count once
            self._observe_at(future, t_admit0, scenario)
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

    def _observe_at(self, future: Future, t0: float,
                    scenario: Optional[str]) -> None:
        """Observe ``future``'s outcome in the SLO monitor once it is done:
        good with its latency from ``t0``, or bad by its error's type (a
        close's EngineClosed is shutdown, not a violation; a cancel is no
        verdict)."""
        slo = self._slo

        def _observe(done: Future) -> None:
            try:
                exc = done.exception()
            except BaseException:
                return  # the caller cancelled
            if exc is None:
                slo.observe_good(time.perf_counter() - t0, scenario=scenario)
            elif not isinstance(exc, EngineClosed):
                slo.observe_bad(type(exc).__name__, scenario=scenario)

        future.add_done_callback(_observe)

    def predict(self, context_lines: Sequence[str], tier: str = 'topk',
                timeout: Optional[float] = None) -> list:
        """Synchronous ``submit().result()``."""
        return self.submit(context_lines, tier).result(timeout)

    # ------------------------------------------- scenario traffic plane
    def record_traffic(self, recorder) -> 'ServingMesh':
        """Arm (or, with None, disarm) the admission traffic tap: a
        ``workloads.profile.ProfileRecorder`` that sees every
        caller-visible submit, submit_neighbors and submit_blended with
        its scenario, for a later save and replay."""
        self._traffic_recorder = recorder
        return self

    def _record_traffic(self, scenario: str, lines=None, vector=None,
                        language: Optional[str] = None,
                        tier: Optional[str] = None,
                        k: Optional[int] = None,
                        weight: Optional[float] = None) -> None:
        recorder = self._traffic_recorder
        if recorder is None:
            return
        # the recorded label is the method's true name, the head of its
        # context line (the extractor's output contract)
        label = lines[0].split(' ', 1)[0] or None if lines else None
        try:
            recorder.record(scenario, language=language, lines=lines,
                            vector=vector, label=label, tier=tier, k=k,
                            weight=weight)
        except Exception as exc:  # the tap never fails a request
            self.log('traffic tap dropped a record: %r' % (exc,))

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

    def _memo_served(self, tier: str, rows: int, memo: str,
                     t_submit0: float, scenario: Optional[str],
                     observe: bool) -> None:
        """The trace and SLO bookkeeping of a neighbor or blend request
        answered from the memo."""
        if self._tracer is not None:
            attrs = {'tier': tier, 'rows': rows, 'mesh': True}
            if scenario is not None:
                attrs['scenario'] = scenario
            trace = self._tracer.begin('serving.request', attrs=attrs)
            trace.event('serving.memo_hit',
                        attrs={'tier': tier, 'rows': rows, 'memo': memo})
            trace.finish(status='ok')
        # answers from the cache stay in the SLO's good count
        if observe and self._slo is not None:
            self._slo.observe_good(time.perf_counter() - t_submit0,
                                   scenario=scenario)

    def submit_neighbors(self, context_or_vectors, k: Optional[int] = None,
                         scenario: Optional[str] = None,
                         language: Optional[str] = None,
                         record: bool = True,
                         observe: bool = True) -> Future:
        """The engine's ``submit_neighbors`` across the fleet: context
        lines ride the micro-batched 'vectors' tier, their code vectors
        search the attached index; an ``(n, D)`` vector array skips the
        predict leg. Both memo tiers apply (exact per ``k``; the
        semantic tier to one-row vector queries) and stand down during a
        canary or an index rollover (whose shadow rides live neighbor
        traffic). Scenario plumbing as in ``submit``; the inner 'vectors'
        leg never taps on its own."""
        index = self._index
        if index is None:
            raise RuntimeError('no index attached — call '
                               'attach_index(load_index(...)) first')
        k = k if k is not None else self.config.INDEX_NEIGHBORS_K
        from code2vec_tpu_torch.index.service import neighbors_from_search
        t_submit0 = time.perf_counter()
        outer: Future = Future()
        memo = self._memo
        scenario_name = scenario or 'neighbor_search'
        rolling = (self._rollover is not None
                   or self._index_rollover is not None)
        if isinstance(context_or_vectors, np.ndarray):
            vectors = np.atleast_2d(context_or_vectors)
            if record:
                for row in vectors:
                    self._record_traffic(scenario_name, vector=row,
                                         language=language, k=k)
            shadow_row = None
            if memo is not None and not rolling and vectors.shape[0] == 1:
                sem = memo.semantic_lookup(vectors[0], k)
                if sem is not None:
                    sem_row, shadow = sem
                    if not shadow:
                        self._memo_served('neighbors', 1, 'semantic',
                                          t_submit0, scenario, observe)
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
                    self._note_index_shadow(vectors, indices, k)
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
        if record:
            self._record_traffic(scenario_name, lines, language=language,
                                 k=k)
        nkey = gen = igen = None
        if memo is not None:
            # keyed per k: a k=5 answer never serves a k=10 ask
            nkey = memo_lib.request_key(lines, 'neighbors', k=k)
            cached = (None if rolling
                      else memo.lookup(nkey, scenario=scenario))
            if cached is not None:
                self._memo_served('neighbors', len(lines), 'exact',
                                  t_submit0, scenario, observe)
                outer.set_result(cached)
                return outer
            gen = memo.generation
            igen = memo.index_generation
            index = self._index
        inner = self.submit(lines, tier='vectors', scenario=scenario,
                            record=False, observe=observe)

        def chain(done: Future) -> None:
            try:
                results = done.result()
                if not results:
                    _resolve(outer, [])
                    return
                vectors = np.stack([r.code_vector for r in results])
                values, indices = index.search(vectors, k)
                self._note_index_shadow(vectors, indices, k)
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

    # ------------------------------------------- retrieval-augmented
    def submit_blended(self, context_lines: Sequence[str],
                       weight: Optional[float] = None,
                       k: Optional[int] = None,
                       deadline_ms: Optional[float] = None,
                       scenario: Optional[str] = None,
                       language: Optional[str] = None,
                       record: bool = True) -> Future:
        """Retrieval-augmented naming: the softmax head's top-k
        distribution blended with similarity votes of the attached
        index's top-k neighbor labels (``workloads/blend.py``). A Future
        of one ``BlendResult`` per method.

        It composes the two warmed paths, ``submit(tier='topk')`` and
        ``submit_neighbors``, so it captures nothing new; the legs run
        with ``record=False, observe=False`` and the blend is one tap
        record and one SLO observation at its own future. ``weight <= 0``
        wraps the plain submit's untouched rows (``source='softmax'``);
        with no index attached it is the typed fallback
        (``source='softmax_fallback'``), not an error. Blends are memoized
        under a key of the weight and k, with both generations taken
        before the legs launch, so a params or an index swap concluding
        in flight refuses the insert."""
        if weight is None:
            weight = self.config.BLEND_NEIGHBOR_WEIGHT
        weight = float(weight)
        if not 0.0 <= weight <= 1.0:
            raise ValueError('blend weight must be in [0, 1], got %r'
                             % (weight,))
        k = k if k is not None else self.config.INDEX_NEIGHBORS_K
        t_submit0 = time.perf_counter()
        lines = canonicalize_contexts(context_lines,
                                      self.config.MAX_CONTEXTS)
        outer: Future = Future()
        if not lines:
            outer.set_result([])
            return outer
        if tele_core.enabled():
            tele_core.registry().counter('mesh/blend_requests_total').inc()
        if record:
            self._record_traffic(scenario or 'retrieval_naming', lines,
                                 language=language, k=k, weight=weight)

        def observe_outer() -> None:
            if self._slo is not None:
                self._observe_at(outer, t_submit0, scenario)

        def submit_leg(submit, *args, **kwargs) -> Future:
            try:
                return submit(*args, scenario=scenario, record=False,
                              observe=False, **kwargs)
            except EngineOverloaded:
                if self._slo is not None:
                    self._slo.observe_bad('shed', scenario=scenario)
                raise

        def fail(exc: BaseException) -> None:
            if not outer.done():
                outer.set_exception(exc)

        def passthrough(source: str) -> Future:
            # one warmed leg, its rows untouched
            inner = submit_leg(self.submit, lines, tier='topk',
                               deadline_ms=deadline_ms)

            def chain(done: Future) -> None:
                try:
                    _resolve(outer, [blend_lib.BlendResult(
                        original_name=row.original_name,
                        predicted_words=list(row.topk_predicted_words),
                        predicted_scores=row.topk_predicted_words_scores,
                        source=source, weight=weight, base=row,
                        neighbors=None) for row in done.result()])
                except BaseException as exc:
                    fail(exc)

            inner.add_done_callback(chain)
            observe_outer()
            return outer

        if self._index is None:
            # the typed fallback: a blend scenario replays against a mesh
            # with no index and still answers, visibly degraded
            if tele_core.enabled():
                tele_core.registry().counter(
                    'mesh/blend_fallback_total').inc()
            return passthrough(blend_lib.SOURCE_FALLBACK)
        if weight <= 0.0:
            return passthrough(blend_lib.SOURCE_SOFTMAX)
        memo = self._memo
        bkey = gen = igen = None
        if memo is not None:
            # keyed on the weight and k: a 0.3 blend never serves a 0.7
            # ask; stands down during a params or an index rollover
            bkey = memo_lib.request_key(lines, 'blend@%g' % weight, k=k)
            rolling = (self._rollover is not None
                       or self._index_rollover is not None)
            cached = (None if rolling
                      else memo.lookup(bkey, scenario=scenario))
            if cached is not None:
                self._memo_served('blend', len(lines), 'exact', t_submit0,
                                  scenario, True)
                outer.set_result(cached)
                return outer
            gen = memo.generation
            igen = memo.index_generation
        base_future = submit_leg(self.submit, lines, tier='topk',
                                 deadline_ms=deadline_ms)
        nbr_future = submit_leg(self.submit_neighbors, lines, k=k)
        legs: Dict[str, list] = {}
        legs_lock = threading.Lock()

        def finish() -> None:
            try:
                base_rows, nbr_rows = legs['base'], legs['nbr']
                results = [blend_lib.blend_row(
                    row, nbr_rows[i] if i < len(nbr_rows) else None, weight)
                    for i, row in enumerate(base_rows)]
                if memo is not None:
                    memo.insert(bkey, results, gen, index_generation=igen)
                _resolve(outer, results)
            except BaseException as exc:
                fail(exc)

        def arm(name: str):
            def done_cb(done: Future) -> None:
                try:
                    value = done.result()
                except BaseException as exc:
                    fail(exc)
                    return
                with legs_lock:
                    legs[name] = value
                    ready = len(legs) == 2
                if ready:
                    finish()
            return done_cb

        base_future.add_done_callback(arm('base'))
        nbr_future.add_done_callback(arm('nbr'))
        observe_outer()
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
                 if not slot.retired and not slot.dead
                 and not slot.restarting
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
                # a thread canary's validated parameters; a worker's stay
                # in its process, and its siblings restore the source
                params = (canary_slot.transport.engine.params
                          if isinstance(canary_slot.transport,
                                        _ThreadReplica) else None)
                try:
                    for slot in list(self._replicas):
                        if slot is canary_slot or slot.retired or \
                                slot.dead or slot.restarting:
                            # a dead or restarting sibling adopts the
                            # fleet's step when it rejoins
                            continue
                        slot.transport.adopt(params, source, resolved_step)
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

    # --------------------------------------------------- index rollover
    def rollover_index(self, candidate,
                       shadow_queries: Optional[int] = None,
                       min_agreement: Optional[float] = None) -> Future:
        """Canaried index swap. The candidate (a rebuilt, compacted or
        requantized tier over the same corpus) attaches in shadow: live
        ``submit_neighbors`` traffic goes on being served by the current
        index while each of its searches is replayed against the
        candidate in the aux pool and scored for top-k id agreement.
        After ``shadow_queries`` scored queries (32 by default) an
        agreement at or above the floor swaps the candidate in (a new
        index version; the memo's index generation bumps, so every cached
        neighbor result goes and the predict entries stay); below it the
        candidate rolls back without having served a request, and a
        candidate that raises fails the handle. A Future of the report."""
        n_shadow = int(shadow_queries) if shadow_queries is not None else 32
        floor = (float(min_agreement) if min_agreement is not None
                 else self.canary_agreement)
        if n_shadow < 1:
            raise ValueError('rollover_index needs shadow_queries >= 1 '
                             '(got %r)' % shadow_queries)
        if candidate is None or not hasattr(candidate, 'search'):
            raise ValueError('rollover_index needs a candidate index '
                             'with .search (got %r)' % (candidate,))
        handle: Future = Future()
        with self._cond:
            if self._closed:
                raise EngineClosed('ServingMesh is closed')
            if self._index is None:
                raise RuntimeError('no index attached — nothing to roll '
                                   'over; use attach_index for the first '
                                   'attach')
            if self._index_rollover is not None:
                raise RuntimeError('an index rollover is already in '
                                   'flight; await its handle first')
            self._index_rollover = {
                'candidate': candidate, 'handle': handle,
                'needed': n_shadow, 'floor': floor,
                'agree_sum': 0.0, 'count': 0, 'concluding': False,
            }
        self.log('mesh: index rollover armed — shadow-querying the '
                 'candidate on live traffic (%d queries, agreement floor '
                 '%.2f)' % (n_shadow, floor))
        return handle

    def _note_index_shadow(self, vectors: np.ndarray,
                           live_indices: np.ndarray, k: int) -> None:
        """One live neighbor search finished while an index rollover is
        armed: replay it against the candidate in the aux pool and add
        its top-k id agreement. With no rollover armed, one racy read of
        None."""
        if self._index_rollover is None:
            return
        with self._cond:
            state = self._index_rollover
            if state is None or state['concluding']:
                return
        vectors = np.array(vectors, np.float32)
        live_indices = np.array(live_indices)

        def shadow() -> None:
            try:
                _, cand_idx = state['candidate'].search(vectors, k)
            except BaseException as exc:
                self._conclude_index_rollover(state, error=exc)
                return
            per_row: List[float] = []
            for row in range(live_indices.shape[0]):
                live = set(int(i) for i in live_indices[row] if i >= 0)
                if live:
                    got = set(int(i) for i in cand_idx[row] if i >= 0)
                    per_row.append(len(live & got) / len(live))
            with self._cond:
                if self._index_rollover is not state or state['concluding']:
                    return
                state['agree_sum'] += sum(per_row)
                state['count'] += len(per_row)
                running = (state['agree_sum'] / state['count']
                           if state['count'] else 0.0)
                done = state['count'] >= state['needed']
                if done:
                    state['concluding'] = True
            self.index_rollover_agreement.set(running)
            if tele_core.enabled():
                tele_core.registry().gauge(
                    'index/rollover_agreement').set(running)
            if done:
                self._conclude_index_rollover(state)
        self._aux_pool.submit(shadow)

    def _conclude_index_rollover(self, state: Dict[str, object],
                                 error=None) -> None:
        """Swap or roll back once the shadow sample is full, or the
        candidate raised (an index that cannot answer is never swapped
        in)."""
        handle: Future = state['handle']
        with self._cond:
            if self._index_rollover is not state:
                return
            agreement = (state['agree_sum'] / state['count']
                         if state['count'] else 0.0)
            swapped = error is None and agreement >= state['floor']
            if swapped:
                self._index = state['candidate']
                self._index_version += 1
                version = self._index_version
            self._index_rollover = None
            self._cond.notify_all()
        if swapped:
            if self._memo is not None:
                # neighbor results depend on the index: the generation
                # bump drops them at once; predict entries stay
                self._memo.bump_index_generation()
            self.index_rollover_total.inc()
            if tele_core.enabled():
                tele_core.registry().counter('index/rollovers_total').inc()
            self.log('mesh: index rollover SWAPPED (version %d): shadow '
                     'agreement %.3f over %d queries'
                     % (version, agreement, state['count']))
        else:
            self.index_rollover_rollbacks_total.inc()
            if tele_core.enabled():
                tele_core.registry().counter(
                    'index/rollover_rollbacks_total').inc()
            self.log('mesh: index rollover ROLLED BACK (%s); the serving '
                     'index and every cached neighbor result stay live'
                     % ('candidate error: %r' % error if error is not None
                        else 'shadow agreement %.3f < floor %.2f over %d '
                        'queries' % (agreement, state['floor'],
                                     state['count'])))
        report = {'swapped': swapped, 'agreement': agreement,
                  'queries': state['count'],
                  'reason': ('candidate error: %r' % error
                             if error is not None else None)}
        if swapped:
            report['index_version'] = version
        if error is not None:
            if not handle.done():
                handle.set_exception(
                    error if isinstance(error, Exception)
                    else RuntimeError(repr(error)))
            return
        _resolve(handle, report)

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
        """Grow the fleet by one replica, serving the fleet's current
        parameters before its puller starts (the autoscaler's scale-up,
        and an operator's verb). A thread replica is a new engine with its
        own ladder, warmed (its captures are its own); a worker is
        spawned, cold-starts and adopts the fleet's current step. Returns
        its id."""
        with self._cond:
            if self._closed:
                raise EngineClosed('ServingMesh is closed')
            rid = 'r%d' % self._next_rid
            self._next_rid += 1
            step = self._params_step
            device_indices = (None if self.mode == 'thread'
                              else self._allocate_slice_locked())
        devices = None
        if self.mode == 'thread':
            transport = self._build_replica(rid, step)
            try:
                transport.warmup()
                with self._cond:
                    # a rollover in flight concludes first: the new
                    # replica then adopts what the fleet settled on
                    while self._rollover is not None and not self._closed:
                        self._cond.wait(0.1)
                    donor = next((s for s in self._replicas
                                  if not s.retired), None)
                    swapped, step = self._fleet_swapped, self._params_step
                if swapped and donor is not None:
                    transport.adopt(donor.transport.engine.params, None,
                                    step)
            except BaseException:
                transport.close()
                raise
        else:
            try:
                transport = self._spawn_worker(rid, device_indices)
            except BaseException:
                self._release_starting_slice(device_indices)
                raise
            self._begin_start(transport)
            try:
                transport.wait_ready()
                devices = self._check_placement(transport, device_indices)
                self._join_fleet_step(transport)
            except BaseException:
                self._release_starting_slice(device_indices)
                transport.reap()
                raise
            finally:
                self._end_start(transport)
        try:
            self._seat_replica(rid, transport, devices=devices,
                               device_indices=device_indices)
        finally:
            self._release_starting_slice(device_indices)
        self.log('mesh: replica %s joined the fleet%s'
                 % (rid, ' on cards %s' % (device_indices,)
                    if device_indices else ''))
        return rid

    def _seat_replica(self, rid: str, transport, adopted: bool = False,
                      devices: Optional[List[int]] = None,
                      device_indices: Optional[List[int]] = None) -> None:
        """Append a ready replica to the table and start its puller (the
        tail of a scale-up and of an adoption); a mesh that closed
        meanwhile closes it and raises ``EngineClosed``."""
        with self._cond:
            closed = self._closed
            if not closed:
                slot = _ReplicaSlot(rid, transport)
                slot.adopted = adopted
                slot.devices = devices
                slot.device_indices = device_indices
                self._replicas.append(slot)
                self._start_puller(slot)
                self._cond.notify_all()
        if closed:
            transport.close()
            raise EngineClosed('ServingMesh closed while replica %s was '
                               'seated' % rid)
        self.replicas_gauge.set(len(self._replicas))
        if tele_core.enabled():
            tele_core.registry().gauge('mesh/replicas').set(
                len(self._replicas))
        self._set_replica_gauges()
        self._queue.kick()

    def _adoption_loop(self) -> None:
        """Socket mode: seat the workers started outside the mesh, or
        turn them away typed (``adopt_rejected``) and count them."""
        while not self._close_event.is_set():
            got = self._listener.wait_adoptable(0.25,
                                                cancel=self._close_event)
            if got is None:
                continue
            rid, channel, hello = got
            try:
                self._adopt_dialin(rid, channel, hello)
            except EngineClosed:
                channel.close()
                return
            except Exception as exc:
                self.adoption_rejected_total.inc()
                if tele_core.enabled():
                    tele_core.registry().counter(
                        'mesh/adoption_rejected_total').inc()
                self.log('mesh: adoption of dial-in %r rejected: %s'
                         % (rid, exc))
                # the typed answer before the close: the worker and its
                # orchestrator's logs learn why
                try:
                    channel.send(('adopt_rejected', str(exc)))
                except (OSError, WireError):
                    pass
                channel.close()

    def _adopt_dialin(self, rid: str, channel,
                      hello: Dict[str, object]) -> None:
        """Validate and seat one dial-in, or raise ``AdoptionRejected``:
        a rid already serving, no ready frame within
        ``adopt_ready_timeout_s``, another wire protocol or batch wire
        format, a tier this mesh serves that the worker did not warm."""
        with self._lock:
            if self._closed:
                raise EngineClosed('ServingMesh is closed')
            if any(s.rid == rid and not s.retired for s in self._replicas):
                raise AdoptionRejected(
                    'rid %r already names a serving replica in this fleet; '
                    'external workers need unique --rid values' % rid)
        transport = _WorkerReplica(
            rid, 'socket', {}, on_batch_done=self._on_worker_batch_done,
            on_worker_dead=self._on_worker_dead,
            on_telemetry=self._on_worker_telemetry,
            on_spans=self._note_stitched,
            start_timeout_s=self.adopt_ready_timeout_s, channel=channel,
            hello=hello)
        # a refusal leaves the wire open: the adoption loop sends the typed
        # frame, then closes it, which also ends a running receiver
        self._begin_start(transport)
        try:
            try:
                transport.wait_ready()
            except Exception as exc:
                if self._close_event.is_set():
                    raise EngineClosed('ServingMesh closed while %r was '
                                       'adopted' % rid)
                raise AdoptionRejected(
                    'worker %r dialed in but did not report ready within '
                    '%.0f s: %r' % (rid, self.adopt_ready_timeout_s, exc))
            caps = transport.ready_info.get('capabilities') or {}
            if caps.get('proto') != transport_lib.WIRE_PROTO:
                raise AdoptionRejected(
                    'worker %r speaks wire proto %r, this mesh speaks %d'
                    % (rid, caps.get('proto'), transport_lib.WIRE_PROTO))
            if caps.get('wire') != self.config.BATCH_WIRE_FORMAT:
                raise AdoptionRejected(
                    'worker %r ships batches as %r, this mesh expects %r'
                    % (rid, caps.get('wire'),
                       self.config.BATCH_WIRE_FORMAT))
            missing = set(self.tiers) - set(caps.get('tiers') or ())
            if missing:
                raise AdoptionRejected(
                    'worker %r did not warm tier(s) %s this mesh serves: '
                    'its first dispatch there would capture on the '
                    'serving path' % (rid, sorted(missing)))
            # a rollover in flight concludes first: the worker then moves
            # to the step the fleet settled on
            self._join_fleet_step(transport)
        finally:
            self._end_start(transport)
        devices = list(caps.get('devices') or ()) or None
        # an adopted worker's reported cards are its slice (the reference's
        # placement view): held while it serves
        self._seat_replica(rid, transport, adopted=True, devices=devices,
                           device_indices=devices)
        self.adopted_total.inc()
        if tele_core.enabled():
            tele_core.registry().counter('mesh/adopted_total').inc()
        self.log('mesh: adopted worker %s started outside the mesh (pid %s, '
                 'step %s, devices %s); its orchestrator owns its restarts'
                 % (rid, transport.pid, transport.params_step, devices))

    def retire(self, replica_id: str, timeout: float = 120.0,
               reason: str = 'drain') -> None:
        """Drain one replica out of the fleet: it stops pulling, its
        in-flight batches deliver, its engine (or worker) closes; the
        shared queue goes to the remaining replicas throughout. Retiring
        the last replica fails the queue typed (``ReplicaDead``)."""
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
            was_dead = slot.dead
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
        if not was_dead:
            slot.transport.close()   # a dead worker was reaped already
        self._set_replica_gauges()
        self.log('mesh: replica %s retired (served %d rows in %d batches)'
                 % (slot.rid, slot.rows_dispatched, slot.batches))
        self._fail_queue_if_fleet_empty()

    # -------------------------------------------------------- lifecycle
    def warmup(self) -> 'ServingMesh':
        """Warm every thread replica's ladder (each captures its own
        graphs: N x the single engine's captures; a worker warms before
        it reports ready), and build the submit side's native tokenizer
        here, not at the first request."""
        if set(self.tiers) & {'topk', 'vectors'}:
            self._reader.native_tokenizer()
        for slot in self._replicas:
            slot.transport.warmup()
        return self

    def stats(self) -> Dict[str, object]:
        # read before the mesh's lock: a thread replica's step sits under
        # its engine's lock, which is never taken inside the mesh's
        serving = {slot.rid: (slot.transport.pid, slot.transport.params_step)
                   for slot in list(self._replicas)}
        with self._lock:
            rows_total = self._rows_total
            replicas = [{
                'replica': slot.rid,
                'pid': serving.get(slot.rid, (None, None))[0],
                'params_step': serving.get(slot.rid, (None, None))[1],
                'retired': slot.retired,
                'retired_reason': slot.retired_reason,
                'adopted': slot.adopted,
                'devices': slot.devices,
                'device_indices': slot.device_indices,
                'dead': slot.dead,
                'restarts': slot.restarts,
                'breaker_state': slot.breaker_state,
                'inflight': slot.inflight,
                'worker_reported_inflight': (
                    slot.transport.heartbeat_info.get('inflight')
                    if isinstance(slot.transport, _WorkerReplica)
                    else None),
                # the worker's memory ledger rollup off its beats (None
                # before the first, or with the backhaul off)
                'worker_memory': (
                    dict(slot.transport.ledger_info)
                    if isinstance(slot.transport, _WorkerReplica)
                    and slot.transport.ledger_info else None),
                'clock_offset_ms': (
                    slot.transport.clock.offset * 1e3
                    if isinstance(slot.transport, _WorkerReplica)
                    and slot.transport.clock.samples else None),
                'batches': slot.batches,
                'rows_dispatched': slot.rows_dispatched,
                'dispatch_share': (slot.rows_dispatched / rows_total
                                   if rows_total else 0.0),
            } for slot in self._replicas]
            params_step = self._params_step
            fleet_rate = self._service_rows_per_s
            index_version = self._index_version
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
            'index_version': index_version,
            'index_rollover_total': self.index_rollover_total.snapshot(),
            'index_rollover_rollbacks_total':
                self.index_rollover_rollbacks_total.snapshot(),
            'replica_breaker_open_total':
                self.breaker_open_total.snapshot(),
            'restarts_total': self.restarts_total.snapshot(),
            'redispatched_total': self.redispatched_total.snapshot(),
            'heartbeat_misses_total': self.heartbeat_misses_total.snapshot(),
            'retired_total': self.retired_total.snapshot(),
            'proto_rejected_total': (self._listener.rejected_total
                                     if self._listener is not None else 0),
            'adopted_total': self.adopted_total.snapshot(),
            'adoption_rejected_total':
                self.adoption_rejected_total.snapshot(),
            'adopted_spans_total': self.adopted_spans_total.snapshot(),
            'remote_spans_dropped_total':
                self.remote_spans_dropped_total.snapshot(),
            'worker_snapshots_total': self.worker_snapshots_total.snapshot(),
            'placement': (
                {'devices_per_replica': self.devices_per_replica,
                 'slices': len(self._placement), 'data_axis': 1}
                if self._placement is not None else None),
            'autoscaler': (self._autoscaler.stats()
                           if self._autoscaler is not None else None),
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
        replays; a worker's over the wire); a dead or retired replica has
        no engine to ask, and its row says so."""
        with self._lock:
            slots = [(slot.rid, slot.transport, slot.dead, slot.retired)
                     for slot in self._replicas]
        return [{'replica': rid, 'dead': dead, 'retired': retired}
                if dead or retired else transport.stats()
                for rid, transport, dead, retired in slots]

    def close(self, drain: bool = False) -> None:
        """Stop the fleet. Fail-fast (the default): still-queued requests
        fail typed ``EngineClosed``, dispatched batches deliver.
        ``drain=True`` serves everything admitted first. An armed
        rollover's handle, of the parameters or of the index, fails
        ``EngineClosed``. Idempotent.

        Nothing is left behind: the autoscaler stops deciding first, the
        supervisor, the liveness monitor and the adoption thread are
        joined, a cold start in flight (a restart, a scale-up, an
        adoption) is cancelled, every worker closes and is joined, and
        the socket listener closes."""
        with self._cond:
            if not self._closed:
                self._closed = True
                self._drain = drain
            rollover, self._rollover = self._rollover, None
            index_rollover, self._index_rollover = self._index_rollover, None
            self._cond.notify_all()
        self._follow_stop.set()
        self._close_event.set()
        with self._lock:
            starting = list(self._starting)
        for transport in starting:
            transport.cancel()
        if self._autoscaler is not None:
            # a scale-up in its tick fails fast on the cancel above
            self._autoscaler.close()
        self._queue.close(drain)
        if not drain:
            for request in self._queue.abandon():
                request.fail(EngineClosed(
                    'ServingMesh closed with the request still queued '
                    '(close(drain=True) serves the queue first)'))
        for armed in (rollover, index_rollover):
            handle = armed['handle'] if armed is not None else None
            if isinstance(handle, Future) and not handle.done():
                try:
                    handle.set_exception(EngineClosed(
                        'ServingMesh closed mid-rollover'))
                except Exception:
                    pass
        follow = self._follow_thread
        if follow is not None:
            follow.join()
        if self._supervisor is not None:
            self._supervisor.join(timeout=60.0)
        if self._liveness_thread is not None:
            self._liveness_thread.join(timeout=60.0)
        if self._adopt_thread is not None:
            self._adopt_thread.join(timeout=60.0)
        for slot in self._replicas:
            if slot.thread is not None:
                slot.thread.join()
        for slot in self._replicas:
            if not slot.retired and not slot.dead:
                slot.transport.close()
            elif slot.dead:
                slot.transport.join()   # reaped on its receiver
        if self._listener is not None:
            self._listener.close()
        self._aux_pool.shutdown(wait=True)
        if self._memo is not None:
            self._memo.close()
        if self._tracer is not None and self._owns_tracer:
            self._tracer.close()

    def __enter__(self) -> 'ServingMesh':
        return self

    def __exit__(self, *exc) -> None:
        self.close()
