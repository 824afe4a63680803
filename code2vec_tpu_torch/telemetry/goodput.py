"""Training goodput plane: badput ledger, MFU accounting and step-time
anomaly watchdog (the port of ``code2vec_tpu/telemetry/goodput.py``).

Goodput, the fraction of wall time spent on productive train steps, is
the fleet-level training metric. This module classifies every second of
wall time inside ``Trainer.fit`` into productive step time or typed
badput:

- ``compile``       CUDA-graph captures and kernel builds or loads (fed
                    by ``telemetry/jit_tracker.py`` through
                    :func:`on_compile`);
- ``input_wait``    host blocked on the input pipeline beyond
                    ``INPUT_WAIT_THRESHOLD_S``;
- ``checkpoint``    snapshot saves (interval, epoch-end, preemption);
- ``eval``          in-training evaluation passes;
- ``rewind``        divergence-guard checkpoint restores;
- ``rewind_replay`` the steps re-trained after a rewind;
- ``preempt``       the preemption-exit snapshot path;
- ``warmup``        the first hot-loop iteration's non-compile remainder.

Everything else a step pays (the kernels' enqueue, device execution, the
log-window sync that drains real device work) is productive. Totals are
exported as ``goodput/*`` gauges at the telemetry flush and appended to
``intervals.jsonl`` (``intervals.procN.jsonl`` per extra process), which
``scripts/goodput_report.py`` reads.

**MFU.** The train step's FLOPs and bytes per dispatch shape are an
analytic count of the shapes the step was dispatched at
(``telemetry/stepcost.py``; the port has no compiler to ask), set once
per new shape by the trainer:

    MFU = window_flops / (window_seconds * peak_flops_per_device
                          * devices)

``peak_flops_per_device`` resolves from ``Config.DEVICE_PEAK_FLOPS`` /
``--device-peak-flops``, the ``DEVICE_PEAK_FLOPS`` environment variable,
or :data:`KNOWN_DEVICE_PEAK_FLOPS` by device name (longest prefix first).

**Anomaly watchdog.** :class:`StepAnomalyWatchdog` keeps a rolling
median/MAD of clean step seconds per dispatch shape; a sustained
regression past ``GOODPUT_ANOMALY_SIGMA`` robust deviations fires
``goodput/anomalies_total``, dumps ``flight_step_anomaly.jsonl`` and, at
most once per ``GOODPUT_AUTOCAPTURE_COOLDOWN_SECS``, arms the on-demand
profiler capture.

Stdlib only: the report script and the tests import it without torch.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Callable, Deque, Dict, Optional, Tuple

from code2vec_tpu_torch.telemetry import core

# ---------------------------------------------------------------- taxonomy
KIND_COMPILE = 'compile'
KIND_INPUT_WAIT = 'input_wait'
KIND_CHECKPOINT = 'checkpoint'
KIND_EVAL = 'eval'
KIND_REWIND = 'rewind'
KIND_REWIND_REPLAY = 'rewind_replay'
KIND_PREEMPT = 'preempt'
KIND_WARMUP = 'warmup'

BADPUT_KINDS = (KIND_COMPILE, KIND_INPUT_WAIT, KIND_CHECKPOINT, KIND_EVAL,
                KIND_REWIND, KIND_REWIND_REPLAY, KIND_PREEMPT, KIND_WARMUP)

#: interval kinds excluded from the stepwatch throughput window
#: (train/examples_per_sec measures train steps, not eval/save wall):
RATE_EXCLUDED_KINDS = frozenset({KIND_CHECKPOINT, KIND_EVAL, KIND_REWIND,
                                 KIND_PREEMPT})

#: per-step input wait under this is the pipeline's steady poll cost,
#: not starvation — only the excess is badput
INPUT_WAIT_THRESHOLD_S = 0.005

#: flight-recorder dump the anomaly watchdog writes (telemetry dir,
#: process-suffixed like the other flight_<event>.jsonl dumps)
FLIGHT_DUMP_NAME = 'flight_step_anomaly'

#: per-device dense peak FLOP/s by device-name prefix (the dense bf16
#: figures the MFU literature normalizes against): the JAX package's TPU
#: rows, NVIDIA's data-sheet figures for the H100 by
#: ``torch.cuda.get_device_name()`` (the SXM part prints as ``NVIDIA
#: H100 80GB HBM3``), and a nominal CPU row so CPU runs report a finite
#: MFU (absolute CPU MFU is not meaningful). Matched longest prefix
#: first.
KNOWN_DEVICE_PEAK_FLOPS: Dict[str, float] = {
    'TPU v2': 45e12,
    'TPU v3': 123e12,
    'TPU v4': 275e12,
    'TPU v5 lite': 197e12,
    'TPU v5e': 197e12,
    'TPU v5p': 459e12,
    'TPU v6 lite': 918e12,
    'TPU v6e': 918e12,
    'NVIDIA H100 PCIe': 756e12,
    'NVIDIA H100': 989e12,
    'cpu': 50e9,
}

#: fallback when the device kind is unknown and no knob is set
DEFAULT_PEAK_FLOPS = 50e9

ENV_DEVICE_PEAK_FLOPS = 'DEVICE_PEAK_FLOPS'


def resolve_peak_flops(configured: float = -1.0,
                       device_kind: Optional[str] = None) -> float:
    """Per-device peak FLOP/s: ``Config.DEVICE_PEAK_FLOPS`` when set
    (> 0), else the ``DEVICE_PEAK_FLOPS`` environment variable, else the
    known-device table by ``device_kind`` prefix (the longest matching
    prefix), else :data:`DEFAULT_PEAK_FLOPS`."""
    if configured and configured > 0:
        return float(configured)
    env = os.environ.get(ENV_DEVICE_PEAK_FLOPS)
    if env:
        try:
            value = float(env)
            if value > 0:
                return value
        except ValueError:
            pass
    if device_kind:
        kind = device_kind.lower()
        for known in sorted(KNOWN_DEVICE_PEAK_FLOPS, key=len, reverse=True):
            if kind.startswith(known.lower()):
                return KNOWN_DEVICE_PEAK_FLOPS[known]
    return DEFAULT_PEAK_FLOPS


def mfu(window_flops: float, window_seconds: float,
        peak_flops_per_device: float, num_devices: int = 1) -> float:
    """Model FLOP utilization of one window: logical FLOPs executed /
    (seconds * aggregate peak).  Pure math, unit-testable against
    hand-computed FLOPs."""
    denom = (max(window_seconds, 1e-9) * max(peak_flops_per_device, 1e-9)
             * max(num_devices, 1))
    return window_flops / denom


class GoodputLedger:
    """The badput ledger: typed wall-time accounting for one trainer.

    The hot loop reports iterations (:meth:`note_input_wait`,
    :meth:`step_done`); slow-path sites mark typed intervals
    (:meth:`interval`); the jit_tracker compile listener feeds
    :meth:`on_compile` — from whatever thread captures a graph or loads
    a kernel, hence the lock.  Nested ``interval`` marks absorb into the
    outermost (model_api's eval funnel runs inside the trainer's eval
    callback wrap; the wall seconds must count once).
    """

    # the hot-loop thread, compile events from any thread, and the
    # model_api callback marks share every field below under _lock
    # graftlint: guard GoodputLedger._badput_s,_productive_s by _lock
    # graftlint: guard GoodputLedger._rate_excluded_s,_accrued_s by _lock
    # graftlint: guard GoodputLedger._interval_depth,_interval_kind by _lock
    # graftlint: guard GoodputLedger._interval_t0,_compile_in_step by _lock
    # graftlint: guard GoodputLedger._replay_left,_steps by _lock
    # graftlint: guard GoodputLedger._first_step_done,_window_flops by _lock
    # graftlint: guard GoodputLedger._window_bytes,_window_steps by _lock
    # graftlint: guard GoodputLedger._harvested,_step_cost by _lock
    # graftlint: guard GoodputLedger._current_cost,_run_open,_t0 by _lock
    def __init__(self, path: Optional[str] = None, log=None,
                 input_wait_threshold_s: float = INPUT_WAIT_THRESHOLD_S,
                 clock: Callable[[], float] = time.monotonic):
        self._path = path
        self._log = log or (lambda msg: None)
        self._clock = clock
        self._threshold = input_wait_threshold_s
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        self._badput_s: Dict[str, float] = {k: 0.0 for k in BADPUT_KINDS}
        self._productive_s = 0.0
        self._rate_excluded_s = 0.0
        self._accrued_s = 0.0        # badput accrued inside the current
        self._interval_depth = 0     # hot-loop iteration (subtracted in
        self._interval_kind = None   # step_done so seconds count once)
        self._interval_t0 = 0.0
        self._compile_in_step = False
        self._replay_left = 0
        self._steps = 0
        self._first_step_done = False
        # MFU window state, harvested at each telemetry flush
        self._window_flops = 0.0
        self._window_bytes = 0.0
        self._window_steps = 0
        self._harvested: Dict[str, float] = {}
        self._step_cost: Dict[str, Tuple[float, float]] = {}
        self._current_cost: Tuple[float, float] = (0.0, 0.0)
        self._run_open = False

    # ------------------------------------------------------------- run span
    def run_start(self, step: int = 0) -> None:
        """Fit entry: open the wall-time span.  Repeated fits on one
        trainer keep accumulating (totals are per-ledger, spans per
        run record)."""
        with self._lock:
            if self._t0 is None:
                self._t0 = self._clock()
            self._run_open = True
        self._append({'kind': 'run_start', 'wall': time.time(),
                      'step': int(step)})

    def run_end(self, step: int = 0, reason: str = 'done') -> None:
        """Fit teardown: durable totals record (the report's primary
        source — windows/intervals reconstruct the same numbers when a
        crash loses this line).  Idempotent per run span: the preempt
        exit writes it with its reason, the fit-finally shutdown must
        not write a second."""
        with self._lock:
            if not self._run_open:
                return
            self._run_open = False
            wall = self._wall_locked()
            totals = dict(self._badput_s)
            productive = self._productive_s
            steps = self._steps
        self._append({'kind': 'run_end', 'wall': time.time(),
                      'step': int(step), 'reason': reason,
                      'wall_s': wall, 'productive_s': productive,
                      'steps': steps, 'badput_s': totals})

    def _wall_locked(self) -> float:
        return 0.0 if self._t0 is None else max(0.0,
                                                self._clock() - self._t0)

    # --------------------------------------------------------- hot loop
    def note_input_wait(self, seconds: float) -> None:
        """Top of a hot-loop iteration: host wait for the staged batch.
        Doubles as the iteration-start mark — badput accrued between
        iterations (epoch-end eval/save) is wall time OUTSIDE any
        iteration and must not be subtracted from one."""
        excess = max(0.0, seconds - self._threshold)
        with self._lock:
            self._accrued_s = 0.0
            self._compile_in_step = False
            if excess > 0.0:
                self._badput_s[KIND_INPUT_WAIT] += excess
                self._accrued_s += excess

    def on_compile(self, seconds: float) -> None:
        """A capture or kernel build completed (jit_tracker's
        ``note_compile``) — compile wall is badput, and the step it landed in
        is excluded from the anomaly baseline.  A compile that lands
        inside an open typed interval (the eval program compiling
        during an eval mark) is absorbed by that interval: its wall is
        already being accrued under the interval's kind, and billing it
        twice would push the badput sum past wall time."""
        with self._lock:
            self._compile_in_step = True
            if self._interval_depth > 0:
                return
            self._badput_s[KIND_COMPILE] += seconds
            self._accrued_s += seconds

    def step_done(self, step: int, seconds: float,
                  shape: Optional[str] = None) -> Tuple[float, bool]:
        """Bottom of a hot-loop iteration: classify its wall time.
        ``seconds`` minus the badput accrued inside the iteration is the
        clean step time — billed to warmup (first iteration), to
        rewind_replay (re-trained steps after a rewind), else counted
        productive.  Returns ``(clean_seconds, had_compile)`` so the
        caller can feed the anomaly watchdog with compile-free samples.
        """
        with self._lock:
            clean = max(0.0, seconds - self._accrued_s)
            self._accrued_s = 0.0
            had_compile = self._compile_in_step
            self._compile_in_step = False
            if not self._first_step_done:
                self._first_step_done = True
                self._badput_s[KIND_WARMUP] += clean
            elif self._replay_left > 0:
                self._replay_left -= 1
                self._badput_s[KIND_REWIND_REPLAY] += clean
            else:
                self._productive_s += clean
            self._steps += 1
            if shape is not None:
                self._current_cost = self._step_cost.get(shape,
                                                         self._current_cost)
            flops, byts = self._current_cost
            self._window_flops += flops
            self._window_bytes += byts
            self._window_steps += 1
            return clean, had_compile

    def note_productive(self, seconds: float) -> None:
        """Wall time outside iterations that drains real device work
        (the epoch-end window sync)."""
        with self._lock:
            self._productive_s += seconds

    # --------------------------------------------------------- intervals
    @contextlib.contextmanager
    def interval(self, kind: str):
        """Mark a typed badput interval.  Re-entrant: only the OUTERMOST
        mark accrues seconds and writes a durable record (nested marks —
        model_api's eval funnel inside the trainer's eval-callback wrap
        — are absorbed)."""
        assert kind in BADPUT_KINDS, kind
        t0 = self._clock()
        with self._lock:
            self._interval_depth += 1
            outermost = self._interval_depth == 1
            if outermost:
                self._interval_kind = kind
                self._interval_t0 = t0
        wall0 = time.time()
        try:
            yield
        finally:
            with self._lock:
                self._interval_depth -= 1
                record = None
                if outermost:
                    now = self._clock()
                    # accrue from the (possibly harvest-rebased) start —
                    # the pre-rebase portion was billed by the flush that
                    # crossed this interval; the record keeps the full span
                    dur = max(0.0, now - self._interval_t0)
                    self._badput_s[kind] += dur
                    self._accrued_s += dur
                    if kind in RATE_EXCLUDED_KINDS:
                        self._rate_excluded_s += dur
                    self._interval_kind = None
                    record = {'kind': 'interval', 'type': kind,
                              'wall': wall0,
                              'dur_s': max(0.0, now - t0)}
            if record is not None:
                self._append(record)

    def mark_replay(self, n_steps: int) -> None:
        """After a divergence rewind: the next ``n_steps`` clean steps
        re-train lost progress — work done twice, billed to
        ``rewind_replay``."""
        if n_steps > 0:
            with self._lock:
                self._replay_left += int(n_steps)

    # ---------------------------------------------------------- MFU costs
    def set_step_cost(self, shape: str, flops: float, bytes_accessed: float
                      ) -> None:
        """Analytic cost of the train step for one dispatch shape
        (trainer captures it at first sight, alongside the capacity
        tracker's specialization accounting)."""
        with self._lock:
            self._step_cost[shape] = (float(flops), float(bytes_accessed))
            self._current_cost = self._step_cost[shape]

    def arithmetic_intensity(self) -> Optional[float]:
        """FLOPs per byte accessed of the current step program (from the
        port's analytic count, telemetry/stepcost.py)."""
        with self._lock:
            flops, byts = self._current_cost
        if flops <= 0 or byts <= 0:
            return None
        return flops / byts

    def current_cost(self) -> Tuple[float, float]:
        with self._lock:
            return self._current_cost

    # ------------------------------------------------------------- flush
    def rate_excluded_total(self) -> float:
        """Cumulative seconds of eval/checkpoint/rewind/preempt
        intervals — the stepwatch subtracts the per-window delta from
        its throughput window (train/examples_per_sec measures train
        steps, not the flush window's wall clock)."""
        with self._lock:
            return self._rate_excluded_s

    def harvest_window(self) -> Dict[str, float]:
        """Per-flush-window deltas: productive/badput seconds since the
        last harvest, plus the window's executed FLOPs.  Resets the
        window accumulators."""
        with self._lock:
            # an interval open across the flush boundary: bill what has
            # elapsed so far to THIS window (and rebase its start), so a
            # long eval cannot hide a whole window's badput
            if self._interval_depth > 0 and self._interval_kind is not None:
                now = self._clock()
                dur = max(0.0, now - self._interval_t0)
                self._badput_s[self._interval_kind] += dur
                self._accrued_s += dur
                if self._interval_kind in RATE_EXCLUDED_KINDS:
                    self._rate_excluded_s += dur
                self._interval_t0 = now
            out = {'productive_s': self._productive_s
                   - self._harvested.get('productive_s', 0.0),
                   'flops': self._window_flops,
                   'bytes': self._window_bytes,
                   'steps': self._window_steps}
            for kind in BADPUT_KINDS:
                key = 'badput/' + kind
                out[key] = self._badput_s[kind] \
                    - self._harvested.get(key, 0.0)
            self._harvested = {'productive_s': self._productive_s}
            for kind in BADPUT_KINDS:
                self._harvested['badput/' + kind] = self._badput_s[kind]
            self._window_flops = 0.0
            self._window_bytes = 0.0
            self._window_steps = 0
            return out

    def export_gauges(self, registry=None) -> None:
        """Cumulative totals -> ``goodput/*`` gauges (flush cadence)."""
        reg = registry if registry is not None else core.registry()
        with self._lock:
            wall = self._wall_locked()
            productive = self._productive_s
            badput = dict(self._badput_s)
        reg.gauge('goodput/productive_s').set(productive)
        for kind, secs in badput.items():
            reg.gauge('goodput/badput_s{kind=%s}' % kind).set(secs)
        if wall > 0:
            reg.gauge('goodput/fraction').set(
                max(0.0, min(1.0, productive / wall)))

    def write_window(self, step: int, window: Dict[str, float],
                     window_seconds: float, mfu_value: Optional[float]
                     ) -> None:
        """Durable per-flush-window record (the report's MFU timeline
        and the crash-safe basis of the totals)."""
        badput = {kind: round(window['badput/' + kind], 6)
                  for kind in BADPUT_KINDS if window['badput/' + kind] > 0}
        self._append({'kind': 'window', 'wall': time.time(),
                      'step': int(step),
                      'elapsed_s': round(window_seconds, 6),
                      'productive_s': round(window['productive_s'], 6),
                      'steps': int(window['steps']),
                      'flops': window['flops'],
                      'mfu': mfu_value, 'badput_s': badput})

    def note_anomaly(self, record: Dict) -> None:
        """Anomaly watchdog fire -> durable record in intervals.jsonl
        (the report's anomaly list)."""
        rec = {'kind': 'anomaly', 'wall': time.time()}
        rec.update(record)
        self._append(rec)

    # ------------------------------------------------------------ plumbing
    def _append(self, record: Dict) -> None:
        """Best-effort durable append; ledger accounting must survive an
        unwritable telemetry dir."""
        if self._path is None:
            return
        try:
            os.makedirs(os.path.dirname(self._path) or '.', exist_ok=True)
            with open(self._path, 'a') as f:
                f.write(json.dumps(record) + '\n')
        except (OSError, ValueError) as exc:
            self._log('goodput: could not append to `%s`: %s'
                      % (self._path, exc))

    def snapshot(self) -> Dict:
        """Current totals (tests, report drills)."""
        with self._lock:
            return {'wall_s': self._wall_locked(),
                    'productive_s': self._productive_s,
                    'steps': self._steps,
                    'badput_s': dict(self._badput_s)}


class StepAnomalyWatchdog:
    """Rolling median/MAD step-time regression detector per dispatch
    shape.  Single-threaded by design (hot loop only, like
    CapacityTracker); the monkeypatchable ``clock`` drives the
    auto-capture cooldown.

    A sample past ``median + sigma * 1.4826 * MAD`` (MAD floored at 5%
    of the median so a perfectly flat window cannot hair-trigger)
    extends the current streak; ``sustain`` consecutive outliers fire:
    ``goodput/anomalies_total``, a ``flight_step_anomaly.jsonl`` dump,
    and — at most once per ``cooldown_s`` — the on-demand profiler
    capture via ``on_capture(step)``.
    """

    def __init__(self, sigma: float, cooldown_s: float,
                 dump_dir: Optional[str] = None,
                 on_capture: Optional[Callable[[int], None]] = None,
                 on_record: Optional[Callable[[Dict], None]] = None,
                 window: int = 64, min_samples: int = 16, sustain: int = 3,
                 suffix: str = '', log=None,
                 clock: Callable[[], float] = time.monotonic):
        self.sigma = float(sigma)
        self.cooldown_s = float(cooldown_s)
        self.dump_dir = dump_dir
        self.on_capture = on_capture
        self.on_record = on_record
        self.window = max(8, window)
        self.min_samples = max(4, min_samples)
        self.sustain = max(1, sustain)
        self.suffix = suffix
        self._log = log or (lambda msg: None)
        self._clock = clock
        self._samples: Dict[str, Deque[float]] = {}
        self._streaks: Dict[str, int] = {}
        self._last_capture = float('-inf')

    @property
    def enabled(self) -> bool:
        return self.sigma > 0

    def observe(self, shape: str, seconds: float, step: int) -> bool:
        """Feed one clean (compile-free) step sample; True iff an
        anomaly fired."""
        if not self.enabled:
            return False
        window = self._samples.setdefault(
            shape, collections.deque(maxlen=self.window))
        fired = False
        if len(window) >= self.min_samples:
            ordered = sorted(window)
            median = ordered[len(ordered) // 2]
            mad = sorted(abs(x - median) for x in ordered)[len(ordered) // 2]
            scale = max(1.4826 * mad, 0.05 * median, 1e-5)
            if seconds > median + self.sigma * scale:
                streak = self._streaks.get(shape, 0) + 1
                self._streaks[shape] = streak
                if streak >= self.sustain:
                    self._fire(shape, seconds, median, scale, step, window)
                    self._streaks[shape] = 0
                    fired = True
            else:
                self._streaks[shape] = 0
        window.append(seconds)
        return fired

    def _fire(self, shape: str, seconds: float, median: float, scale: float,
              step: int, window) -> None:
        reg = core.registry()
        reg.counter('goodput/anomalies_total').inc()
        deviation = (seconds - median) / scale
        captured = False
        now = self._clock()
        if self.on_capture is not None and self.cooldown_s > 0 and \
                now - self._last_capture >= self.cooldown_s:
            self._last_capture = now
            self.on_capture(step)
            reg.counter('goodput/autocaptures_total').inc()
            captured = True
        record = {'step': int(step), 'shape': shape,
                  'step_ms': seconds * 1e3, 'median_ms': median * 1e3,
                  'mad_scale_ms': scale * 1e3,
                  'sigma': round(deviation, 2), 'autocapture': captured}
        self._dump_flight(record, window)
        if self.on_record is not None:
            self.on_record(record)
        self._log('goodput: step-time anomaly at step %d (shape %s): '
                  '%.1fms vs median %.1fms (%.1f robust sigmas)%s — see '
                  'flight_step_anomaly%s.jsonl'
                  % (step, shape, seconds * 1e3, median * 1e3, deviation,
                     '; profiler auto-capture armed' if captured else '',
                     self.suffix))

    def _dump_flight(self, record: Dict, window) -> None:
        """``flight_step_anomaly.jsonl``: the fire record + the shape's
        recent step-time window, the forensic context the runbook
        starts from.  Overwritten per fire (latest anomaly wins), like
        the tracing flight dumps."""
        if self.dump_dir is None:
            return
        path = os.path.join(self.dump_dir, '%s%s.jsonl'
                            % (FLIGHT_DUMP_NAME, self.suffix))
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            tmp = path + '.tmp'
            with open(tmp, 'w') as f:
                f.write(json.dumps(dict(record, kind='anomaly',
                                        wall=time.time())) + '\n')
                for sample in window:
                    f.write(json.dumps({'kind': 'sample',
                                        'step_ms': sample * 1e3}) + '\n')
            os.replace(tmp, path)
        except OSError as exc:
            self._log('goodput: could not write %s: %s' % (path, exc))


# Process-global active ledger, like the fault plan (resilience/faults.py):
# interval marks live in layers with no trainer handle (model_api's
# eval/save funnels).  None (telemetry off) keeps every mark site at a
# single attribute read — the zero-overhead guarantee.
_ACTIVE: Optional[GoodputLedger] = None


def activate(ledger: GoodputLedger) -> None:
    global _ACTIVE
    _ACTIVE = ledger


def deactivate(ledger: Optional[GoodputLedger] = None) -> None:
    global _ACTIVE
    if ledger is None or _ACTIVE is ledger:
        _ACTIVE = None


def active() -> Optional[GoodputLedger]:
    return _ACTIVE


def on_compile(seconds: float) -> None:
    """jit_tracker's ``note_compile`` forwards capture and build
    durations here; no-op with no active ledger."""
    ledger = _ACTIVE
    if ledger is not None:
        ledger.on_compile(seconds)


@contextlib.contextmanager
def interval(kind: str):
    """Module-level typed-interval mark against the active ledger
    (model_api's eval/save/preempt funnels) — a no-op nullcontext when
    telemetry is off."""
    ledger = _ACTIVE
    if ledger is None:
        yield
        return
    with ledger.interval(kind):
        yield
