"""Hang watchdog: a wedged run fails loud instead of holding the card (a
copy of ``code2vec_tpu/resilience/watchdog.py``).

The training loop arms it around its two blocking waits: the next staged
batch (a wedged prefetch thread, a hung filesystem) and the loss-window
sync with the card. Past the deadline a daemon monitor thread

1. dumps every Python thread's stack to ``<dump_dir>/watchdog_stacks.txt``
   (``faulthandler``, safe while the main thread sits in a C call);
2. runs ``on_expire`` (the metrics writer's flush);
3. sends the process SIGABRT: a thread blocked in C takes no exception.

With telemetry on, ``watchdog/armed`` is 1 inside a watched wait and an
expiry counts ``watchdog/expired_total``. ``abort`` can be injected for
tests in the same process.
"""
from __future__ import annotations

import contextlib
import faulthandler
import logging
import os
import signal
import threading
import time
from typing import Callable, Optional

from code2vec_tpu_torch.telemetry import core as tele_core

logger = logging.getLogger(__name__)

STACKS_FILE_NAME = 'watchdog_stacks.txt'


def _default_abort() -> None:
    # a signal, not sys.exit: the hung wait is in another (often C) frame
    os.kill(os.getpid(), signal.SIGABRT)


class HangWatchdog:
    def __init__(self, deadline_s: float, dump_dir: str,
                 on_expire: Optional[Callable[[], None]] = None,
                 abort: Optional[Callable[[], None]] = None,
                 poll_s: Optional[float] = None, suffix: str = ''):
        self.deadline_s = float(deadline_s)
        self.dump_dir = dump_dir
        # this process's file suffix ('.proc<r>' on rank r > 0 of a mesh)
        self.suffix = suffix
        self.on_expire = on_expire
        self.abort = abort or _default_abort
        # fires within ~10% of the deadline, bounded below for sub-second
        # test deadlines
        self.poll_s = poll_s if poll_s is not None else max(
            0.05, self.deadline_s / 10.0)
        # the training thread arms and disarms while the monitor polls
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._armed_at: Optional[float] = None
        self._label = ''
        self._stop = False
        self._expired = False
        self._thread: Optional[threading.Thread] = None

    def arm(self, label: str) -> None:
        with self._cond:
            self._armed_at = time.monotonic()
            self._label = label
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._monitor, name='hang-watchdog', daemon=True)
                self._thread.start()
            self._cond.notify()
        if tele_core.enabled():
            tele_core.registry().gauge('watchdog/armed').set(1)

    def disarm(self) -> None:
        with self._cond:
            self._armed_at = None
            self._label = ''
        if tele_core.enabled():
            tele_core.registry().gauge('watchdog/armed').set(0)

    @contextlib.contextmanager
    def watch(self, label: str):
        """Armed around one blocking wait; disarmed even when the wait
        raises."""
        self.arm(label)
        try:
            yield
        finally:
            self.disarm()

    def _monitor(self) -> None:
        while True:
            with self._cond:
                if self._stop:
                    return
                armed_at, label = self._armed_at, self._label
                if armed_at is None:
                    self._cond.wait(timeout=self.poll_s)
                    continue
            overdue = time.monotonic() - armed_at - self.deadline_s
            if overdue >= 0:
                self._expire(label)
                return
            time.sleep(min(self.poll_s, -overdue))

    def _expire(self, label: str) -> None:
        self._expired = True
        if tele_core.enabled():
            tele_core.registry().counter('watchdog/expired_total').inc()
        stem, ext = os.path.splitext(STACKS_FILE_NAME)
        stacks_path = os.path.join(self.dump_dir, stem + self.suffix + ext)
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            with open(stacks_path, 'w') as f:
                f.write('hang watchdog expired after %.1fs waiting on: '
                        '%s\n\n' % (self.deadline_s, label))
                f.flush()
                faulthandler.dump_traceback(file=f, all_threads=True)
        except OSError:
            stacks_path = '<unwritable: %s>' % stacks_path
        logger.error('HANG WATCHDOG: `%s` exceeded the %.1fs deadline — '
                     'thread stacks dumped to `%s`; aborting.', label,
                     self.deadline_s, stacks_path)
        if self.on_expire is not None:
            try:
                self.on_expire()
            except Exception:
                logger.exception('hang watchdog: on_expire failed')
        self.abort()

    @property
    def expired(self) -> bool:
        return self._expired

    def shutdown(self) -> None:
        """Stop the monitor thread (the end of ``fit``)."""
        with self._cond:
            self._stop = True
            self._armed_at = None
            self._cond.notify()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
