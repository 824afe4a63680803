"""Training-metric summaries for ``-tb/--tensorboard`` (a copy of
``code2vec_tpu/metrics_writer.py``).

Scalars are appended as JSON lines to ``<logdir>/metrics.jsonl``
(``{'tag', 'value', 'step', 'time'}``, the reference's record), and to a
TensorBoard event file through ``torch.utils.tensorboard`` when it
imports.

Writes are buffered (one append per ``BUFFER_RECORDS`` scalars) and the
file is open only inside a flush, so nothing leaks when ``close()`` is
never reached; an ``atexit`` hook flushes what a crashing caller left
buffered. Usable as a context manager.
"""
from __future__ import annotations

import atexit
import json
import logging
import os
import threading
import time
from typing import List, Optional

logger = logging.getLogger(__name__)

# one disk append per this many scalars: the loop writes 2 per log window,
# and eval scalars are flushed at once (model_api)
BUFFER_RECORDS = 8


class MetricsWriter:
    # graftlint: guard MetricsWriter._buffer by _lock
    def __init__(self, logdir: str, buffer_records: int = BUFFER_RECORDS):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._path = os.path.join(logdir, 'metrics.jsonl')
        # the training thread and the atexit/close path both flush
        self._buffer: List[str] = []
        self._buffer_records = max(1, buffer_records)
        self._lock = threading.Lock()
        self._closed = False
        # a read-only or full disk neither stops training nor passes
        # silently: the first failure is logged, the rest counted
        self._write_failures = 0
        self._dropped_records = 0
        atexit.register(self._atexit_flush)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir=logdir)
        except Exception:     # no tensorboard package: the JSONL alone
            self._tb = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        record = {'tag': tag, 'value': float(value), 'step': int(step),
                  'time': time.time()}
        with self._lock:
            self._buffer.append(json.dumps(record))
            if len(self._buffer) >= self._buffer_records:
                self._flush_locked()
        if self._tb is not None:
            try:
                self._tb.add_scalar(tag, value, step)
            except Exception as exc:
                logger.warning('metrics writer: tensorboard mirror failed '
                               '(%s); disabling it for this writer', exc)
                self._tb = None

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()
        if self._tb is not None:
            self._tb.flush()

    def _flush_locked(self) -> None:
        if not self._buffer:
            return
        try:
            # append mode keeps a resumed run's streams whole
            with open(self._path, 'a') as f:
                f.write('\n'.join(self._buffer) + '\n')
        except OSError as exc:
            self._write_failures += 1
            self._dropped_records += len(self._buffer)
            if self._write_failures == 1:
                logger.warning(
                    'metrics writer: appending to `%s` failed (%s) — '
                    'metric records will be DROPPED until writes recover; '
                    'further failures are logged once at close', self._path,
                    exc)
        self._buffer = []

    def _atexit_flush(self) -> None:
        try:
            if not self._closed:
                self.flush()
        except Exception:
            pass      # interpreter teardown: never mask the real exit

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        if self._dropped_records:
            logger.warning(
                'metrics writer: %d record(s) dropped across %d failed '
                'append(s) to `%s` (read-only or full disk?)',
                self._dropped_records, self._write_failures, self._path)
        self._closed = True
        atexit.unregister(self._atexit_flush)
        if self._tb is not None:
            self._tb.close()

    def __enter__(self) -> 'MetricsWriter':
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def maybe_create(config) -> Optional[MetricsWriter]:
    """A writer under USE_TENSORBOARD, in ``summaries/`` beside the model
    saved or loaded, else in the working directory."""
    if not config.USE_TENSORBOARD:
        return None
    if config.is_saving:
        logdir = os.path.join(os.path.dirname(config.MODEL_SAVE_PATH),
                              'summaries')
    elif config.is_loading:
        logdir = os.path.join(config.model_load_dir, 'summaries')
    else:
        logdir = 'summaries'
    return MetricsWriter(logdir)
