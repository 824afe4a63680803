"""Divergence guard: detect a non-finite loss window, rewind to the last
good checkpoint, retry with a bounded budget (a copy of
``code2vec_tpu/resilience/guard.py``).

Detection rides on the loss-window sync the training loop already does
(``Trainer.fit``): the window's losses come to the host there anyway, and
their sum is non-finite exactly when one of them is, so the check adds no
device sync.

On detection the guard:

1. dumps diagnostics (the window's losses, the last batch's array
   statistics and a snapshot of the telemetry registry) to
   ``<dump_dir>/divergence_step<k>.json``, and flushes the telemetry
   exporters when the trainer has them;
2. while the rewind budget (MAX_DIVERGENCE_REWINDS) lasts, restores the
   newest checkpoint no newer than the window's FIRST non-finite step
   through the caller's ``restore(last_good_step)`` (``model_api``
   restores across the epoch and step-snapshot stores under that
   ceiling): a snapshot saved between the first NaN and its detection may
   already hold poisoned weights. The loop keeps consuming the same epoch
   iterator, so the bad window is skipped, not replayed;
3. otherwise raises ``DivergenceError`` naming the dump.

A restore counts ``resilience/rewinds_total`` (telemetry on). Stdlib
and numpy only.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, List, Optional

import numpy as np

from code2vec_tpu_torch.telemetry import core as tele_core

logger = logging.getLogger(__name__)


class DivergenceError(RuntimeError):
    """A non-finite loss the guard could not (or may no longer) rewind
    past."""


def batch_stats(host_batch: Any) -> dict:
    """Shape, dtype, min and max of each array field of a ``Batch`` or
    ``PackedBatch`` (any tuple of arrays); other fields are skipped."""
    stats = {}
    fields = getattr(host_batch, '_asdict', None)
    items = fields().items() if fields else enumerate(host_batch or ())
    for name, value in items:
        if isinstance(value, np.ndarray) and value.size \
                and value.dtype != object:
            stats[str(name)] = {
                'shape': list(value.shape),
                'dtype': str(value.dtype),
                'min': float(value.min()),
                'max': float(value.max()),
            }
    return stats


class DivergenceGuard:
    def __init__(self, max_rewinds: int,
                 restore: Optional[Callable[[int], Optional[Any]]],
                 dump_dir: str, telemetry=None, suffix: str = ''):
        self.max_rewinds = max_rewinds
        self.restore = restore
        self.dump_dir = dump_dir
        # this process's file suffix ('.proc<r>' on rank r > 0 of a mesh)
        self.suffix = suffix
        # the trainer's StepTelemetry (None with telemetry off)
        self.telemetry = telemetry
        self.rewinds = 0

    def handle(self, batch_num: int, losses: List[float],
               host_batch: Any, step_now: Optional[int] = None) -> Any:
        """Called when a window's losses are non-finite. ``step_now`` is
        the state's current step (after an earlier rewind it lags the
        loop's batch counter; checkpoints are keyed by steps). Returns the
        rewound state, or raises ``DivergenceError``."""
        dump_path = self._dump(batch_num, losses, host_batch)
        self.rewinds += 1
        if self.rewinds > self.max_rewinds:
            raise DivergenceError(
                'Non-finite training loss at batch %d and the rewind '
                'budget (MAX_DIVERGENCE_REWINDS=%d) is exhausted — this '
                'run diverges systematically, not from one bad window. '
                'Diagnostics: %s'
                % (batch_num, self.max_rewinds, dump_path))
        # every step before the window's first non-finite loss updated the
        # weights from finite gradients: checkpoints up to there are clean
        first_bad = next((i for i, x in enumerate(losses)
                          if not np.isfinite(x)), len(losses))
        base = step_now if step_now is not None else batch_num
        last_good_step = max(0, base - len(losses) + first_bad)
        state = (self.restore(last_good_step)
                 if self.restore is not None else None)
        if state is None:
            raise DivergenceError(
                'Non-finite training loss at batch %d and no checkpoint '
                'at or before the last known-finite step %d to rewind to '
                '— enable step-interval snapshots (SAVE_EVERY_N_STEPS) '
                'so the guard has a rewind target. Diagnostics: %s'
                % (batch_num, last_good_step, dump_path))
        if tele_core.enabled():
            # counted only on an actual restore, not on the aborts above
            tele_core.registry().counter('resilience/rewinds_total').inc()
        logger.warning(
            'Divergence guard: non-finite loss window at batch %d; '
            'rewound to checkpoint step %d and skipping the offending '
            'window (rewind %d of %d). Diagnostics: %s', batch_num,
            int(state.step), self.rewinds, self.max_rewinds, dump_path)
        return state

    def _dump(self, batch_num: int, losses: List[float],
              host_batch: Any) -> str:
        """Best effort: a failed write never masks the divergence."""
        record = {
            'batch_num': batch_num,
            'time': time.time(),
            'window_losses': [float(x) for x in losses],
            'last_batch': batch_stats(host_batch),
            'telemetry': tele_core.registry().snapshot(),
            'rewinds_so_far': self.rewinds,
        }
        path = os.path.join(self.dump_dir,
                            'divergence_step%d%s.json'
                            % (batch_num, self.suffix))
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            with open(path, 'w') as f:
                json.dump(record, f, indent=1, default=str)
        except OSError as exc:
            logger.warning('Divergence guard: could not write diagnostics '
                           'to `%s`: %s', path, exc)
            return '<unwritable: %s>' % path
        if self.telemetry is not None:
            # the exporters' view of the run up to the divergence
            self.telemetry.flush_now(batch_num)
        return path
