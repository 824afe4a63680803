"""Compilation accounting (the port of ``code2vec_tpu/telemetry/
jit_tracker.py``).

The JAX package counts XLA backend compiles off ``jax.monitoring``. The
port has no XLA compile; its counterparts are the events that cost wall
time once and then never again:

- each CUDA-graph capture of the serving engine's ladder
  (``serving/graphs.py::GraphLadder._capture``);
- each build or first load of a hand-written kernel's library
  (``ops/_build.py::load``) and each g++ build of a host program
  (``hostbuild.py::build``).

Each calls :func:`note_compile`, which feeds ``jit/compiles_total``,
``jit/compile_ms`` and the active goodput ledger. With telemetry off it
is one bool read.

``CapacityTracker`` watches the packed-wire capacity feeding the step, as
the reference's does: every new capacity after the first is counted in
``jit/respecializations_total`` and logged.
"""
from __future__ import annotations

from code2vec_tpu_torch.telemetry import core
from code2vec_tpu_torch.telemetry import goodput


def note_compile(seconds: float) -> None:
    """One capture or kernel build/load took ``seconds``."""
    if not core.enabled():
        return
    reg = core.registry()
    reg.counter('jit/compiles_total').inc()
    reg.timer('jit/compile_ms').record(seconds)
    goodput.on_compile(seconds)


class CapacityTracker:
    """Counts and logs packed-capacity changes of the step's shapes. One
    instance per trainer; single-threaded (hot loop only)."""

    def __init__(self, log=None):
        self._log = log
        self._seen = set()

    def observe(self, capacity: int, step: int) -> None:
        reg = core.registry()
        reg.gauge('jit/packed_capacity').set(capacity)
        if capacity in self._seen:
            return
        first = not self._seen
        self._seen.add(capacity)
        if not first:
            reg.counter('jit/respecializations_total').inc()
        if self._log is not None:
            self._log('telemetry: packed-capacity %s at step %d '
                      '(bucket %d; %d seen) — new step shape'
                      % ('re-specialization' if not first else
                         'specialization', step, capacity, len(self._seen)))
