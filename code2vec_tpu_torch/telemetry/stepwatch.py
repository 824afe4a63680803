"""``StepTelemetry``: the trainer-facing telemetry bundle (the port of
``code2vec_tpu/telemetry/stepwatch.py``).

Owns the hot loop's instruments (phase timers, throughput counters), the
exporters, the capacity tracker, the on-demand trace controller, the
goodput ledger and its anomaly watchdog. The trainer creates one when
``Config.TELEMETRY`` is on, records into its attributes and calls
``after_step`` / ``flush_now``; with telemetry off it holds ``None`` and
every instrumented site is one ``is None`` check.
"""
from __future__ import annotations

import os
import time
from typing import Optional

from code2vec_tpu_torch.telemetry import core
from code2vec_tpu_torch.telemetry import goodput as goodput_lib
from code2vec_tpu_torch.telemetry import memory as memory_lib
from code2vec_tpu_torch.telemetry.exporters import (ConsoleExporter,
                                                    JsonlExporter,
                                                    PrometheusExporter)
from code2vec_tpu_torch.telemetry.jit_tracker import CapacityTracker
from code2vec_tpu_torch.telemetry.trace import TraceController


def process_suffix(process_index: int) -> str:
    """The suffix of process ``process_index``'s file names: '' for 0,
    '.proc<N>' for N > 0, as ``log.txt.proc<N>``."""
    return '' if process_index == 0 else '.proc%d' % process_index


def device_kind(device) -> str:
    """The name the peak table is keyed on: the card's
    ``torch.cuda.get_device_name`` on CUDA, else the device type."""
    device_type = getattr(device, 'type', str(device))
    if device_type == 'cuda':
        import torch
        return torch.cuda.get_device_name(device)
    return device_type


class StepTelemetry:
    def __init__(self, config, log=None, process_index: int = 0,
                 device_kind: Optional[str] = None):
        core.enable()
        self.log = log or (lambda msg: None)
        # Config.telemetry_dir: TELEMETRY_DIR, else beside the model
        self.dir = config.telemetry_dir
        # each process exports its own files, like log.txt: rank r > 0
        # of a mesh inserts '.proc<r>' (metrics, .prom, intervals, flight
        # dumps, the memory ledger's files, traces)
        suffix = process_suffix(process_index)
        reg = core.registry()
        self.registry = reg
        self.batch_wait = reg.timer('step/batch_wait_ms')
        self.h2d = reg.timer('step/h2d_ms')
        self.dispatch = reg.timer('step/dispatch_ms')
        self.sync = reg.timer('step/sync_ms')
        self.step_total = reg.timer('step/total_ms')
        self.steps = reg.counter('train/steps_total')
        self.examples = reg.counter('train/examples_total')
        self.contexts = reg.counter('train/contexts_total')
        self.ring_occupancy = reg.gauge('staging/ring_occupancy')
        self.capacity = CapacityTracker(log=self.log)
        self.suffix = suffix
        self.trace = TraceController(
            self.dir, trace_at_step=config.TELEMETRY_TRACE_AT_STEP,
            num_steps=config.TELEMETRY_TRACE_NUM_STEPS, log=self.log,
            suffix=suffix)
        # the ledger's forensic dumps land beside the other artifacts,
        # under this process's names; MEM_NOW snapshots at the flush
        # cadence
        memory_lib.configure(dump_dir=self.dir, suffix=suffix)
        self.memwatch = memory_lib.MemoryReportController(self.dir,
                                                          log=self.log)
        self.flush_every = max(1, config.TELEMETRY_FLUSH_EVERY_STEPS)
        # ---- training goodput plane (telemetry/goodput.py) ----
        self.goodput = goodput_lib.GoodputLedger(
            os.path.join(self.dir, 'intervals%s.jsonl' % suffix),
            log=self.log)
        self.device_kind = device_kind
        self.peak_flops = goodput_lib.resolve_peak_flops(
            config.DEVICE_PEAK_FLOPS, device_kind)
        self.anomaly = goodput_lib.StepAnomalyWatchdog(
            config.GOODPUT_ANOMALY_SIGMA,
            config.GOODPUT_AUTOCAPTURE_COOLDOWN_SECS, dump_dir=self.dir,
            on_capture=self.trace.request,
            on_record=self.goodput.note_anomaly,
            suffix=suffix, log=self.log)
        self._window_excluded = 0.0
        self.exporters = [
            JsonlExporter(self.dir, filename='metrics%s.jsonl' % suffix),
            PrometheusExporter(self.dir, filename='metrics%s.prom' % suffix),
            ConsoleExporter(self.log, min_interval_s=(
                config.TELEMETRY_CONSOLE_EVERY_SECS)),
        ]
        # rates are computed per flush window
        self._window_t0 = time.monotonic()
        self._window_examples = 0
        self._window_contexts = 0

    # ------------------------------------------------------------ recording
    def count_batch(self, num_examples: int, num_contexts: int) -> None:
        self.steps.inc()
        self.examples.inc(num_examples)
        self.contexts.inc(num_contexts)
        self._window_examples += num_examples
        self._window_contexts += num_contexts

    def after_step(self, step: int) -> None:
        """Every ``flush_every`` steps: rate gauges and the exporters."""
        if step % self.flush_every:
            return
        self.flush_now(step)

    def flush_now(self, step: int) -> None:
        now = time.monotonic()
        elapsed = max(now - self._window_t0, 1e-9)
        reg = self.registry
        # train/examples_per_sec measures train steps: the window's
        # eval/checkpoint/rewind/preempt seconds come off the wall window
        excluded = self.goodput.rate_excluded_total()
        excluded_delta = min(max(excluded - self._window_excluded, 0.0),
                             elapsed - 1e-9)
        self._window_excluded = excluded
        train_elapsed = max(elapsed - excluded_delta, 1e-9)
        reg.gauge('train/examples_per_sec').set(
            self._window_examples / train_elapsed)
        reg.gauge('train/contexts_per_sec').set(
            self._window_contexts / train_elapsed)
        self._window_t0 = now
        self._window_examples = 0
        self._window_contexts = 0
        # goodput/* totals and the window's MFU off the harvested FLOPs
        self.goodput.export_gauges(reg)
        window = self.goodput.harvest_window()
        mfu_value = None
        if window['flops'] > 0:
            mfu_value = goodput_lib.mfu(window['flops'], train_elapsed,
                                        self.peak_flops)
            reg.gauge('train/mfu').set(mfu_value)
            flops, byts = self.goodput.current_cost()
            reg.gauge('train/step_flops').set(flops)
            reg.gauge('train/step_bytes').set(byts)
            intensity = self.goodput.arithmetic_intensity()
            if intensity is not None:
                reg.gauge('train/arithmetic_intensity').set(intensity)
        if window['steps'] or window['productive_s'] > 0:
            self.goodput.write_window(step, window, train_elapsed, mfu_value)
        # the mem/* gauges, reconciled against the card's live bytes,
        # with every flush
        led = memory_lib.ledger()
        led.export_gauges()
        led.reconcile()
        for exporter in self.exporters:
            exporter.flush(reg, step)
        self.memwatch.poll(step)

    def resume(self) -> None:
        """Re-arm recording at fit entry (shutdown() disables), so fit
        can run repeatedly on one trainer. The first flush window starts
        here, not at construction, so its rates and MFU leave out what
        ran before the fit (the model's build, the token cache)."""
        core.enable()
        goodput_lib.activate(self.goodput)
        self.goodput.run_start()
        self._window_t0 = time.monotonic()
        self._window_examples = 0
        self._window_contexts = 0

    def shutdown(self, step: int) -> None:
        """Stop a live capture, flush once more, close the run span, then
        drop the process-global enable flag so later trainers and readers
        in this process do not record into an unexported registry."""
        self.trace.shutdown()
        # the last window before run_end, so every window record sits
        # inside its run span
        self.flush_now(step)
        self.goodput.run_end(step)
        goodput_lib.deactivate(self.goodput)
        core.disable()
