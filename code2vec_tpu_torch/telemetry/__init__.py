"""Telemetry (the port of ``code2vec_tpu/telemetry/``): instruments and
the process-global registry (``core``), the metric catalog
(``catalog``), exporters (``exporters``), compile accounting
(``jit_tracker``), the goodput ledger and MFU (``goodput``, with the
analytic step cost in ``stepcost``), the device-memory ledger
(``memory``), ``torch.profiler`` captures (``trace``), the trainer's
bundle (``stepwatch``) and per-request serving traces (``tracing``).

One process-global ``enabled()`` flag: off (the default), an
instrumented site costs one ``is None`` or bool check.
"""
from __future__ import annotations

from code2vec_tpu_torch.telemetry.core import (Counter, Gauge, Registry,
                                               Timer, disable, enable,
                                               enabled, registry, reset)
from code2vec_tpu_torch.telemetry.stepwatch import StepTelemetry

__all__ = ['Counter', 'Gauge', 'Registry', 'Timer', 'StepTelemetry',
           'disable', 'enable', 'enabled', 'registry', 'reset']
