"""Per-request tracing for the serving engine (the port of
``code2vec_tpu/telemetry/tracing.py``).

- **Span contexts.** A ``Trace`` is one request's tree of ``Span``s
  (trace id, span id, parent, host monotonic start and end, attributes),
  begun at ``ServingEngine.submit()`` and carried through admission,
  tokenize, queue wait, coalesce, pack, h2d, dispatch, device execute,
  fetch, decode and deliver, with child spans for an oversize split and
  re-join and the canary's shadow scoring. Stamps are host
  ``time.perf_counter`` reads only; ``serving.device_execute`` ends where
  the decode worker finds the pinned outputs ready (the wait it does
  anyway), so tracing adds no device synchronize.
- **Head sampling and tail retention.** ``sample_rate``
  (``TRACING_SAMPLE_RATE``) decides at trace creation whether the trace
  goes to ``spans.jsonl``; a trace that is shed, expired, degraded,
  split, closed mid-flight, failed, or slower than ``slow_ms``
  (``TRACING_SLOW_MS``) is kept regardless.
- **Flight recorder.** A ring of the last ``flight_traces`` completed
  traces, dumped to ``flight_<event>.jsonl`` on overload bursts, a canary
  rollback and engine close.
- **Cross-process stitching.** A mesh worker records its members'
  phases into traces of its ``RemoteSpanSink`` under the parent's trace
  contexts; the finished span records ride the wire home, and the parent
  grafts them into the live traces with ``Trace.adopt_spans`` (ids
  remapped, stamps shifted by the worker's clock offset).

Span names are cataloged in ``SPAN_CATALOG``. ``scripts/latency_report.py``
reads the span log (per-phase percentiles per bucket and tier, the
queue-wait vs device-time split, Chrome-trace export).

Stdlib only and thread-safe: spans come from submitter threads, the
dispatcher and the decode workers.
"""
from __future__ import annotations

import collections
import json
import os
import random
import threading
import time
from typing import Deque, Dict, List, Optional

from code2vec_tpu_torch.telemetry import core as tele_core
from code2vec_tpu_torch.telemetry.core import Counter

#: every span name the engine's ``begin``/``span``/``span_at``/``event``/
#: ``single`` sites use, with what the span covers
SPAN_CATALOG: Dict[str, str] = {
    'serving.request': 'Root span of one submit(): creation to delivery '
                       '(or the typed terminal reason).',
    'serving.admission': 'Admission control: bound check, drain estimate '
                         'vs deadline, degradation ladder, reservation.',
    'serving.tokenize': 'Caller-thread tokenize of the raw context lines '
                        'into a plane batch.',
    'serving.queue_wait': 'Enqueue to dispatcher pop (includes the '
                          'coalescing window the batch head opened).',
    'serving.coalesce': 'Batch-level: head-request enqueue to pop — the '
                        'micro-batcher gathering window (overlaps the '
                        'member requests\' queue_wait; excluded from '
                        'phase sums).',
    'serving.stall': 'Injected slow_dispatch fault stall (drills only).',
    'serving.pack': 'Pad to bucket + packed-wire pack of the coalesced '
                    'micro-batch.',
    'serving.h2d': 'Write of the padded arrays into the pinned input '
                   'buffers of the graph\'s (bucket, rung).',
    'serving.dispatch': 'Enqueue of the input copy and the warm CUDA '
                        'graph\'s replay (plus the canary shadow replay '
                        'when armed).',
    'serving.device_execute': 'Dispatch return to the pinned outputs '
                              'being ready in the decode worker: device '
                              'execute + D2H + decode-worker handoff, '
                              'with NO added sync.',
    'serving.fetch': 'The decode worker\'s wait on the outputs\' copy '
                     'event and the copy out of the pinned buffers, '
                     'nested inside device_execute.',
    'serving.decode': 'Host-side top-k word lookup / attention parsing '
                      'of the fetched arrays.',
    'serving.deliver': 'Resolving one request\'s future with its rows.',
    'serving.shed': 'Terminal: shed at admission with EngineOverloaded '
                    '(attrs carry the reason).',
    'serving.expired': 'Terminal: SLO deadline passed while queued '
                       '(DeadlineExceeded, never dispatched).',
    'serving.degraded': 'Admitted at a downgraded tier by the overload '
                        'ladder (attrs: requested/effective tier).',
    'serving.closed': 'Terminal: engine closed with the request still '
                      'queued (EngineClosed).',
    'serving.chunk': 'One oversize-split chunk; its phases nest here '
                     'instead of under the root.',
    'serving.join': 'Oversize re-join: the last chunk merged the '
                    'ordered rows back into the caller future.',
    'serving.canary_shadow': 'One shadow-scored canary micro-batch '
                             '(attrs: step, rows, agreement tally).',
    'serving.redispatch': 'The request\'s batch died with its mesh '
                          'replica: re-admitted ONCE at the queue '
                          'front with the dead incarnation excluded '
                          '(attrs: replica, reason); a second '
                          'queue_wait span follows, so the trace '
                          'shows both attempts.',
    'serving.remote': 'Remote-worker envelope: one dispatched member\'s '
                      'worker-side execution (receipt to finish), '
                      'recorded in the worker process and grafted into '
                      'the parent trace by adopt_spans (attrs: replica, '
                      'pid).  A redispatched request shows one per '
                      'incarnation that did device work.',
    'serving.memo_hit': 'Terminal: the request was served from the '
                        'memoization tier at mesh admission — zero '
                        'device-seconds, no queue slot (attrs: tier, '
                        'rows, memo=exact|semantic); '
                        'latency_report.py --fleet attributes the '
                        'saved work off these.',
}

#: span names that originate in a worker process and reach the parent's
#: span log only through ``Trace.adopt_spans`` (the mesh wire's backhaul)
REMOTE_ORIGIN_SPANS = frozenset(('serving.remote',))

#: span names whose presence marks a trace for tail retention even when
#: head sampling skipped it
TAIL_SPANS = frozenset((
    'serving.shed', 'serving.expired', 'serving.degraded',
    'serving.closed', 'serving.chunk', 'serving.stall',
    'serving.redispatch',
))

#: flight-recorder dump debounce: repeated same-event dumps inside this
#: window are skipped (a shed storm must not rewrite the file per shed)
DUMP_MIN_INTERVAL_S = 30.0
#: overload burst detector: this many sheds inside the window dump the
#: flight recorder once (debounced above)
SHED_BURST = 8
SHED_WINDOW_S = 1.0


class Span:
    """One timed phase. ``t0``/``t1`` are ``time.perf_counter`` seconds
    (host monotonic — comparable only within one process)."""

    __slots__ = ('span_id', 'parent_id', 'name', 't0', 't1', 'attrs')

    def __init__(self, span_id: int, parent_id: Optional[int], name: str,
                 t0: float, t1: Optional[float] = None,
                 attrs: Optional[dict] = None):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs

    def record(self, trace_id: str) -> dict:
        t1 = self.t1 if self.t1 is not None else self.t0
        rec = {'trace': trace_id, 'span': self.span_id,
               'parent': self.parent_id, 'name': self.name,
               't0': self.t0, 't1': t1,
               'dur_ms': (t1 - self.t0) * 1e3}
        if self.attrs:
            rec['attrs'] = self.attrs
        return rec


class Trace:
    """One request's span tree.  ``finish`` is idempotent; spans added
    after it are dropped (a racing close cannot corrupt the log)."""

    # spans are appended from the submitter thread, the dispatcher and
    # the decode workers; finish() races close(): _lock guards them
    __slots__ = ('tracer', 'trace_id', 'sampled', 'root', '_spans',
                 '_span_seq', '_finished', '_lock')

    def __init__(self, tracer: 'Tracer', trace_id: str, sampled: bool,
                 root_name: str, t0: float, attrs: Optional[dict]):
        self.tracer = tracer
        self.trace_id = trace_id
        self.sampled = sampled
        self._lock = threading.Lock()
        self._span_seq = 1
        self._finished = False
        self.root = Span(0, None, root_name, t0, attrs=attrs)
        self._spans: List[Span] = [self.root]

    def _add(self, name: str, t0: float, t1: Optional[float],
             parent: Optional[Span], attrs: Optional[dict]) -> Span:
        parent_id = parent.span_id if parent is not None else 0
        with self._lock:
            if self._finished:
                # orphan: never recorded (delivery raced a close/finish)
                return Span(-1, parent_id, name, t0, t1, attrs)
            span = Span(self._span_seq, parent_id, name, t0, t1, attrs)
            self._span_seq += 1
            self._spans.append(span)
        return span

    def span(self, name: str, parent: Optional[Span] = None,
             t0: Optional[float] = None,
             attrs: Optional[dict] = None) -> Span:
        """Open a span (end it with ``end``; ``finish`` closes leftovers
        at the trace end so shutdown never truncates one)."""
        return self._add(name, time.perf_counter() if t0 is None else t0,
                         None, parent, attrs)

    def span_at(self, name: str, t0: float, t1: float,
                parent: Optional[Span] = None,
                attrs: Optional[dict] = None) -> Span:
        """Record an already-measured (closed) span."""
        return self._add(name, t0, t1, parent, attrs)

    def event(self, name: str, parent: Optional[Span] = None,
              attrs: Optional[dict] = None) -> Span:
        """Zero-duration marker span (shed/expired/degraded reasons)."""
        now = time.perf_counter()
        return self._add(name, now, now, parent, attrs)

    def end(self, span: Span, t1: Optional[float] = None) -> None:
        t1 = time.perf_counter() if t1 is None else t1
        with self._lock:
            if self._finished:
                # finish() already closed leftovers and serialized the
                # trace (the aggregate-completing chunk ends its deliver
                # and chunk spans after the join finished the shared
                # trace); re-stamping would diverge from the written log
                return
            span.t1 = t1

    def adopt_spans(self, records: List[dict], offset_s: float = 0.0,
                    parent: Optional[Span] = None) -> int:
        """Graft remote span records (a worker-side trace's spans,
        shipped back over the mesh wire) into this live trace.

        Remote span ids are remapped onto this trace's id sequence (two
        incarnations' subtrees never collide), parent links inside the
        remote records survive the remap, a remote root (parent None)
        is re-parented under ``parent`` (the member's chunk span, else
        this trace's root), and every stamp is shifted by ``offset_s``,
        the worker's clock-offset estimate, so stamps from another
        process order correctly. Returns how many spans were adopted: 0
        once the trace has finished (its record is written; the caller
        counts a late arrival as dropped)."""
        if not records:
            return 0
        parent_id = parent.span_id if parent is not None else 0
        with self._lock:
            if self._finished:
                return 0
            idmap: Dict[int, int] = {}
            for rec in records:
                new_id = self._span_seq
                self._span_seq += 1
                idmap[rec['span']] = new_id
                remote_parent = rec.get('parent')
                self._spans.append(Span(
                    new_id,
                    idmap.get(remote_parent, parent_id)
                    if remote_parent is not None else parent_id,
                    rec['name'],
                    float(rec['t0']) + offset_s,
                    float(rec['t1']) + offset_s,
                    rec.get('attrs')))
            return len(records)

    def finish(self, status: str = 'ok',
               reason: Optional[str] = None) -> None:
        """Close the trace exactly once: stamp the root end, close any
        still-open spans at the same instant (no span is ever truncated
        by shutdown), and hand the trace to the tracer for the
        retention decision."""
        now = time.perf_counter()
        with self._lock:
            if self._finished:
                return
            self._finished = True
            # a pre-stamped root end (Tracer.single) is preserved
            for span in self._spans:
                if span.t1 is None:
                    span.t1 = now
            spans = list(self._spans)
        self.tracer._finish_trace(self, status, reason, spans)


class Tracer:
    """Span-log writer + flight recorder for one serving engine.

    ``out_dir=None`` runs memory-only: spans are recorded and the ring
    works (tests, engines with no artifact directory), but nothing is
    written and flight dumps are skipped.
    """

    # the ring, burst window, dump debounce and id sequence are shared
    # by submitters, the dispatcher and the decode workers, under _lock
    def __init__(self, out_dir: Optional[str], sample_rate: float = 0.01,
                 slow_ms: float = 250.0, flight_traces: int = 256,
                 shed_burst: int = SHED_BURST,
                 shed_window_s: float = SHED_WINDOW_S,
                 dump_min_interval_s: float = DUMP_MIN_INTERVAL_S,
                 instance: Optional[str] = None,
                 log=None):
        self.out_dir = out_dir
        # namespaces the flight dumps (flight_<event>_<instance>.jsonl),
        # so two tracers sharing one directory never overwrite each
        # other's postmortem
        self.instance = instance
        self.spans_path = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self.spans_path = os.path.join(out_dir, 'spans.jsonl')
        self.sample_rate = float(sample_rate)
        # <= 0 disables tail-retention-by-latency (0 would retain all)
        self.slow_s = slow_ms / 1e3 if slow_ms > 0 else float('inf')
        self.shed_burst = max(1, shed_burst)
        self.shed_window_s = shed_window_s
        self.dump_min_interval_s = dump_min_interval_s
        self.log = log if log is not None else (lambda msg: None)
        self.traces_total = Counter('tracing/traces_total')
        self.retained_total = Counter('tracing/retained_total')
        self.flight_dumps_total = Counter('tracing/flight_dumps_total')
        self._lock = threading.Lock()
        self._write_lock = threading.Lock()
        self._ring: Deque = collections.deque(maxlen=max(1, flight_traces))
        self._shed_times: Deque[float] = collections.deque()
        self._last_dump: Dict[str, float] = {}
        self._trace_seq = 0
        self._closed = False
        self._id_prefix = '%08x' % random.getrandbits(32)
        self._rng = random.Random()

    # ------------------------------------------------------------ traces
    def begin(self, name: str, attrs: Optional[dict] = None) -> Trace:
        """Start one trace whose root span is ``name``; the head-based
        sampling decision is taken here."""
        with self._lock:
            seq = self._trace_seq
            self._trace_seq += 1
        sampled = self._rng.random() < self.sample_rate
        return Trace(self, '%s-%06d' % (self._id_prefix, seq), sampled,
                     name, time.perf_counter(), attrs)

    def single(self, name: str, attrs: Optional[dict] = None,
               t0: Optional[float] = None,
               t1: Optional[float] = None) -> None:
        """One-shot single-span trace for engine-level events that
        outlive their request traces (canary shadow scoring)."""
        trace = self.begin(name, attrs=attrs)
        if t0 is not None:
            trace.root.t0 = t0
        trace.sampled = True  # engine events are rare: always retained
        if t1 is not None:
            trace.root.t1 = t1
        trace.finish(status='ok')

    @staticmethod
    def _serialize(trace: Trace, status: str, wall: float,
                   spans: List[Span]) -> List[str]:
        lines = []
        for span in spans:
            rec = span.record(trace.trace_id)
            if span is trace.root:
                rec['status'] = status
                rec['sampled'] = trace.sampled
                rec['wall'] = wall
            lines.append(json.dumps(rec))
        return lines

    def _finish_trace(self, trace: Trace, status: str,
                      reason: Optional[str], spans: List[Span]) -> None:
        root = trace.root
        if reason is not None:
            root.attrs = dict(root.attrs or ())
            root.attrs['reason'] = reason
        dur_s = root.t1 - root.t0
        retained = (trace.sampled or status != 'ok'
                    or dur_s >= self.slow_s
                    or any(span.name in TAIL_SPANS for span in spans))
        self.traces_total.inc()
        if retained:
            self.retained_total.inc()
        if tele_core.enabled():
            reg = tele_core.registry()
            reg.counter('tracing/traces_total').inc()
            if retained:
                reg.counter('tracing/retained_total').inc()
        wall = time.time()
        # the ring keeps the SPANS, not serialized lines: the unsampled
        # fast path (the overwhelming majority at the default rate) pays
        # object appends only; json costs land on the rare retained
        # write or an actual flight dump
        with self._lock:
            self._ring.append((trace, status, wall, spans))
        if retained and self.spans_path is not None:
            payload = '\n'.join(self._serialize(trace, status, wall,
                                                spans)) + '\n'
            # one serialized append per trace: concurrent finishers
            # cannot tear each other's records
            with self._write_lock:
                with open(self.spans_path, 'a') as f:
                    f.write(payload)

    # --------------------------------------------------- flight recorder
    def note_shed(self) -> None:
        """Feed the overload burst detector with one shed; a burst dumps
        the flight recorder (debounced)."""
        now = time.monotonic()
        with self._lock:
            self._shed_times.append(now)
            while self._shed_times and \
                    now - self._shed_times[0] > self.shed_window_s:
                self._shed_times.popleft()
            burst = len(self._shed_times) >= self.shed_burst
        if burst:
            self.dump_flight('overload')

    def dump_flight(self, event: str,
                    force: bool = False) -> Optional[str]:
        """Dump the ring of recent traces to ``flight_<event>.jsonl``
        (atomic rewrite; debounced per event unless ``force``). Returns
        the path, or None when skipped/memory-only."""
        if self.out_dir is None:
            return None
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(event)
            if not force and last is not None and \
                    now - last < self.dump_min_interval_s:
                return None
            self._last_dump[event] = now
            ring = list(self._ring)
        suffix = '' if not self.instance else '_%s' % self.instance
        path = os.path.join(self.out_dir,
                            'flight_%s%s.jsonl' % (event, suffix))
        tmp = path + '.tmp'
        with open(tmp, 'w') as f:
            f.write(json.dumps({'flight': event, 'time': time.time(),
                                'traces': len(ring)}) + '\n')
            for trace, status, wall, spans in ring:
                f.write('\n'.join(self._serialize(trace, status, wall,
                                                  spans)) + '\n')
        os.replace(tmp, path)  # postmortem readers never see a torn file
        self.flight_dumps_total.inc()
        if tele_core.enabled():
            tele_core.registry().counter(
                'tracing/flight_dumps_total').inc()
        self.log('tracing: flight recorder dumped %d trace(s) -> %s '
                 '(event: %s)' % (len(ring), path, event))
        return path

    # --------------------------------------------------------- lifecycle
    def stats(self) -> Dict[str, object]:
        return {
            'traces_total': self.traces_total.snapshot(),
            'retained_total': self.retained_total.snapshot(),
            'flight_dumps_total': self.flight_dumps_total.snapshot(),
            'sample_rate': self.sample_rate,
            'spans_path': self.spans_path,
        }

    def close(self) -> None:
        """Final flight dump (``flight_close.jsonl``) — the engine calls
        this after the dispatcher and decode pool drained, so every
        in-flight trace has already been finished (delivered or typed-
        failed), never truncated.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.dump_flight('close', force=True)


class RemoteSpanSink:
    """The worker side of cross-process trace stitching.

    A worker replica runs the engine's span sites in its own process,
    where the parent's span log cannot see them. The worker's serve loop
    ``begin``s one trace per dispatched member under the parent's
    shipped trace context, the engine records its phases into it as it
    would locally, and when the trace finishes this sink turns its spans
    into plain record dicts, bundled with their (dispatch seq, member
    index); nothing is written in the worker. The serve loop
    ``collect``s the bundles onto the result frame; a bundle still in
    the outbox when a heartbeat fires rides the heartbeat (spans that
    finished after their result frame, or that a crash is about to
    orphan). The parent grafts them with ``Trace.adopt_spans``.

    The outbox is bounded (``max_bundles``): with heartbeats off
    (``MESH_HEARTBEAT_SECS=0``) nothing sweeps orphans, and a failed
    dispatch's bundles get no result frame, so past the cap the oldest
    bundles drop (``dropped_bundles``) instead of growing the worker.
    """

    # traces finish on the worker engine's decode threads while the serve
    # loop collects and the heartbeat thread drains: _outbox, _open and
    # dropped_bundles are guarded by _lock (_cond wraps it)
    def __init__(self, replica: str, max_bundles: int = 512):
        self.replica = replica
        self.max_bundles = max(1, int(max_bundles))
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._outbox: List[tuple] = []
        #: bundles evicted past the cap (never shipped)
        self.dropped_bundles = 0
        #: id(trace) -> (seq, member) for traces not yet finished
        self._open: Dict[int, tuple] = {}

    def begin(self, name: str, ctx: dict, seq: int,
              member: int) -> Trace:
        """One member's worker-side trace under the parent's context:
        its root span (``name``, ``serving.remote`` in the mesh) becomes
        a child of the parent's member span at adoption."""
        attrs = {'replica': self.replica, 'pid': os.getpid()}
        # the context carries the request's workload scenario, stamped
        # here so the envelope stays attributable after stitching
        if ctx.get('scenario') is not None:
            attrs['scenario'] = ctx['scenario']
        trace = Trace(self, str(ctx.get('trace_id', '?')),
                      bool(ctx.get('sampled')), name,
                      time.perf_counter(), attrs=attrs)
        with self._lock:
            self._open[id(trace)] = (seq, member)
        return trace

    def _finish_trace(self, trace: Trace, status: str,
                      reason: Optional[str], spans: List[Span]) -> None:
        root = trace.root
        if reason is not None:
            root.attrs = dict(root.attrs or ())
            root.attrs['reason'] = reason
        records = [span.record(trace.trace_id) for span in spans]
        with self._cond:
            seq, member = self._open.pop(id(trace), (None, None))
            self._outbox.append((time.perf_counter(),
                                 {'seq': seq, 'member': member,
                                  'trace': trace.trace_id,
                                  'status': status, 'spans': records}))
            overflow = len(self._outbox) - self.max_bundles
            if overflow > 0:
                del self._outbox[:overflow]
                self.dropped_bundles += overflow
            self._cond.notify_all()

    def wait_finished(self, traces: List[Optional[Trace]],
                      timeout: float) -> None:
        """Block, at most ``timeout`` seconds, until every given trace
        has finished. They finish on the engine's decode threads just
        after the member futures resolve, so the result frame almost
        always carries the whole bundle set."""
        pending = {id(t) for t in traces if t is not None}
        deadline = time.perf_counter() + timeout
        with self._cond:
            while pending & set(self._open):
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return
                self._cond.wait(min(remaining, 0.05))

    def collect(self, seq: int) -> List[dict]:
        """Pop the bundles of dispatch ``seq``: the result frame's
        rider. Keyed by seq, so a heartbeat firing meanwhile never takes
        the result frame's bundles."""
        with self._lock:
            take = [bundle for _born, bundle in self._outbox
                    if bundle['seq'] == seq]
            self._outbox = [(born, bundle)
                            for born, bundle in self._outbox
                            if bundle['seq'] != seq]
        return take

    def drain(self, min_age_s: float = 0.0) -> List[dict]:
        """Pop the bundles older than ``min_age_s``: the heartbeat's
        orphan sweep. The age gate leaves a just-finished bundle to its
        own result frame; one still here after half a beat has missed it
        (the serve loop is stalled or about to die with the result
        unsent) and ships now."""
        if min_age_s <= 0:
            with self._lock:
                taken, self._outbox = self._outbox, []
            return [bundle for _born, bundle in taken]
        now = time.perf_counter()
        with self._lock:
            take = [bundle for born, bundle in self._outbox
                    if now - born >= min_age_s]
            self._outbox = [(born, bundle)
                            for born, bundle in self._outbox
                            if now - born < min_age_s]
        return take
