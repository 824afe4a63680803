"""Preemption-safe shutdown: SIGTERM and SIGINT become a flag the training
loop polls at each step boundary (a copy of
``code2vec_tpu/resilience/preempt.py``).

A spot preemption delivers SIGTERM with a short grace window; Ctrl-C is
SIGINT. On the flag the loop saves one final snapshot (``model_api``'s
``on_preempt``) and returns, so the run loses at most the current step. A
second SIGINT raises ``KeyboardInterrupt`` at once.

Installed as a context manager. Outside the main thread it installs
nothing (``signal.signal`` raises there) and the flag is only polled; on
exit the previous handlers come back.
"""
from __future__ import annotations

import logging
import signal
import threading
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class PreemptionHandler:
    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self._requested = False
        self._signum: Optional[int] = None
        self._sigint_count = 0
        self._previous: Dict[int, object] = {}

    def _handle(self, signum, frame) -> None:
        if signum == signal.SIGINT:
            self._sigint_count += 1
            if self._sigint_count > 1:
                raise KeyboardInterrupt
        self._requested = True
        self._signum = signum
        logger.warning('Received %s: finishing the current step, then '
                       'saving a snapshot and exiting cleanly (press Ctrl-C '
                       'again to abort immediately).',
                       signal.Signals(signum).name)

    @property
    def requested(self) -> bool:
        return self._requested

    @property
    def signal_name(self) -> str:
        return (signal.Signals(self._signum).name
                if self._signum is not None else '')

    def install(self) -> 'PreemptionHandler':
        if threading.current_thread() is not threading.main_thread():
            return self
        for signum in self.SIGNALS:
            try:
                self._previous[signum] = signal.signal(signum, self._handle)
            except (ValueError, OSError):
                self._previous.pop(signum, None)
        return self

    def uninstall(self) -> None:
        for signum, previous in self._previous.items():
            try:
                signal.signal(signum, previous)
            except (ValueError, OSError):
                pass
        self._previous.clear()

    def __enter__(self) -> 'PreemptionHandler':
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
