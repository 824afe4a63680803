"""Training resilience (the counterpart of ``code2vec_tpu/resilience/``):

- ``guard``    — a non-finite loss window rewinds to the last good
                 checkpoint, within a budget, else aborts with a dump;
- ``preempt``  — SIGTERM/SIGINT end the run at a step boundary after one
                 final snapshot;
- ``watchdog`` — a hang in the loop's two blocking waits dumps every
                 thread's stack and aborts;
- ``faults``   — the deterministic fault injection that drills them.

Stdlib (and numpy) only at import.
"""
from __future__ import annotations

from code2vec_tpu_torch.resilience.guard import (DivergenceError,
                                                 DivergenceGuard)
from code2vec_tpu_torch.resilience.preempt import PreemptionHandler
from code2vec_tpu_torch.resilience.watchdog import HangWatchdog

__all__ = ['DivergenceError', 'DivergenceGuard', 'PreemptionHandler',
           'HangWatchdog']
