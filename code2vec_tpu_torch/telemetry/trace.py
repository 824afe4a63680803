"""On-demand ``torch.profiler`` captures from a live run (the port of
``code2vec_tpu/telemetry/trace.py``).

``Config.PROFILE_DIR`` (``--profile``) captures one fixed window near the
start of a run; this controller adds captures that need no restart:

- ``TELEMETRY_TRACE_AT_STEP`` (config field, ``--trace-at-step``, or the
  environment variable of that name): capture
  ``TELEMETRY_TRACE_NUM_STEPS`` steps once that global step is reached;
- ``touch <telemetry_dir>/TRACE_NOW`` in a live run: the trainer polls
  for it every ``poll_every`` steps (one ``stat`` a poll), consumes it and
  captures the next window; repeatable;
- ``request(step)``: the anomaly watchdog's auto-capture.

Each capture lands in ``<telemetry_dir>/traces/step<N>/trace.json``
(``step<N>.proc<r>`` on rank r > 0 of a mesh, which polls
``TRACE_NOW.proc<r>``), a
Chrome trace (Perfetto, ``chrome://tracing``) with the host scopes
(``host/batch_wait``, ``host/h2d_place``, ``host/sync``, one ``train``
scope a step) and, on the card, every kernel by name. The profiler
cannot nest, so the trainer keeps the controller inert while the fixed
``--profile`` window holds it. A capture the user asked for that cannot
start or be written raises: a run never goes on as if it had traced.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

from code2vec_tpu_torch.telemetry import core

ENV_TRACE_AT_STEP = 'TELEMETRY_TRACE_AT_STEP'
TOUCH_FILE_NAME = 'TRACE_NOW'
TRACE_FILE_NAME = 'trace.json'


class ProfilerCapture:
    """One ``torch.profiler`` window written as a Chrome trace into
    ``out_dir``: host activity, and the card's kernels once the process
    has initialized CUDA."""

    def __init__(self, out_dir: str):
        import torch
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._profile = torch.profiler.profile(activities=activities)
        self._profile.__enter__()

    def stop(self) -> str:
        """End the window and write ``trace.json``; returns its path."""
        profile, self._profile = self._profile, None
        profile.__exit__(None, None, None)
        path = os.path.join(self.out_dir, TRACE_FILE_NAME)
        profile.export_chrome_trace(path)
        return path


class TraceController:
    def __init__(self, trace_root: str, trace_at_step: int = -1,
                 num_steps: int = 5, poll_every: int = 25,
                 log=None, suffix: str = ''):
        self.trace_root = trace_root
        self.suffix = suffix
        # config < 0 means unset: the environment variable takes over
        if trace_at_step < 0:
            trace_at_step = int(os.environ.get(ENV_TRACE_AT_STEP, -1))
        self.trace_at_step = trace_at_step
        self.num_steps = max(1, num_steps)
        self.poll_every = max(1, poll_every)
        self.touch_path = os.path.join(trace_root, TOUCH_FILE_NAME + suffix)
        self._log = log or (lambda msg: None)
        self._capture: Optional[ProfilerCapture] = None
        self._stop_at = -1
        self._armed_at = -1   # step an armed capture starts at (-1: none)

    @property
    def active(self) -> bool:
        return self._capture is not None

    def request(self, step: int) -> None:
        """Arm a one-shot capture to start at step ``step`` (the anomaly
        watchdog's auto-capture). No-op while one is active or armed."""
        if self._capture is None and self._armed_at < 0:
            self._armed_at = step

    def _should_start(self, step: int) -> bool:
        if step == self.trace_at_step or step == self._armed_at:
            return True
        if step % self.poll_every == 0 and os.path.exists(self.touch_path):
            try:
                os.remove(self.touch_path)  # consume: one capture per touch
            except OSError:
                pass
            return True
        return False

    def maybe_update(self, step: int,
                     sync: Optional[Callable[[], None]] = None) -> None:
        """Advance the capture state machine at the top of step ``step``.
        ``sync`` (a device synchronize) runs before a capture stops, so
        the window holds finished device work, not just launches."""
        if self._capture is None:
            if not self._should_start(step):
                return
            trace_dir = os.path.join(self.trace_root, 'traces',
                                     'step%d%s' % (step, self.suffix))
            self._armed_at = -1
            self._capture = ProfilerCapture(trace_dir)
            self._stop_at = step + self.num_steps
            self._log('telemetry: profiler capture started at step %d '
                      '(%d steps) -> %s' % (step, self.num_steps, trace_dir))
        elif step >= self._stop_at:
            if sync is not None:
                sync()
            path = self._capture.stop()
            self._capture = None
            self._stop_at = -1
            core.registry().counter('trace/captures_total').inc()
            self._log('telemetry: profiler capture written to `%s`' % path)

    def shutdown(self) -> None:
        """Stop a capture left active (fit teardown), writing what it
        holds."""
        if self._capture is not None:
            capture, self._capture = self._capture, None
            self._stop_at = -1
            capture.stop()
            core.registry().counter('trace/captures_total').inc()
