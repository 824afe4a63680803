"""Bridge to the out-of-process path-context extractor (a copy of
``code2vec_tpu/serving/extractor_bridge.py``).

``Extractor`` runs the extractor on one source file, head-truncates each
method to MAX_CONTEXTS contexts and hashes every path with Java's
``String#hashCode`` (``common.java_string_hashcode``), keeping the
hash -> path dictionary that un-hashes the attention display. The
extractor is the checkout's own C++ one (``extractor/src/main.cpp``),
built with g++ at first use into the gitignored ``build/extractor/``
(``hostbuild.py``), or any command with the same flags.

Every run has a timeout (EXTRACTOR_TIMEOUT_SECS, ``--extractor-timeout``)
and a failure carries the child's stderr. A failure of the infrastructure
(the process could not start, exited non-zero, timed out) raises the
typed ``ExtractorCrash``; an input with no method raises a plain
``ValueError``, and only the former is retried. ``ExtractorPool`` runs
calls on worker threads with retries and exponential backoff and a
circuit breaker that fails fast (``ExtractorUnavailable``) while the
extractor keeps crashing.

The pool's counters are plain attributes, mirrored into the telemetry
registry when it is on (``serving/extractor_retries_total``,
``serving/breaker_open_total``, ``serving/breaker_state``). Left out: the
reference's ``extractor.call`` tracing span.
"""
from __future__ import annotations

import os
import subprocess
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

from code2vec_tpu_torch import common, hostbuild
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.serving.errors import (ExtractorCrash,
                                               ExtractorUnavailable)
from code2vec_tpu_torch.telemetry import core as tele_core

EXTRACTOR_SOURCES = os.path.join(hostbuild.REPO_ROOT, 'extractor', 'src')
EXTRACTOR_BINARY = os.path.join(hostbuild.BUILD_DIR, 'extractor',
                                'c2v-extract')
GXX_FLAGS = ('-O2', '-std=c++17', '-pthread')


def build_extractor(binary: Optional[str] = None) -> str:
    """The extractor built from ``extractor/src`` (when missing or older
    than a source). Raises ``hostbuild.BuildError`` with g++'s output."""
    binary = binary or EXTRACTOR_BINARY
    headers = sorted(os.path.join(EXTRACTOR_SOURCES, name)
                     for name in os.listdir(EXTRACTOR_SOURCES)
                     if name.endswith('.h'))
    hostbuild.build(binary, os.path.join(EXTRACTOR_SOURCES, 'main.cpp'),
                    GXX_FLAGS, headers)
    return binary


def find_default_extractor() -> List[str]:
    """The command of the checkout's extractor, built first when needed;
    a reference-compatible JAR named by CODE2VEC_EXTRACTOR_JAR when the
    build fails."""
    try:
        return [build_extractor()]
    except hostbuild.BuildError:
        jar = os.environ.get('CODE2VEC_EXTRACTOR_JAR')
        if jar and os.path.isfile(jar):
            return ['java', '-cp', jar, 'JavaExtractor.App']
        raise


#: language by file extension, the default everywhere
_EXT_LANGS = {'.java': 'java', '.cs': 'csharp'}


def infer_language(path: str) -> Optional[str]:
    """'java' or 'csharp' from the file extension; None when unknown (the
    extractor then uses its default frontend)."""
    return _EXT_LANGS.get(os.path.splitext(path)[1].lower())


def _stderr_of(proc_or_exc) -> str:
    """stderr text of a CompletedProcess or a TimeoutExpired."""
    stderr = getattr(proc_or_exc, 'stderr', None)
    if isinstance(stderr, bytes):
        stderr = stderr.decode('utf-8', 'replace')
    return (stderr or '').strip()


class Extractor:
    def __init__(self, config: Config,
                 extractor_command: Optional[List[str]] = None,
                 max_path_length: int = 8, max_path_width: int = 2,
                 timeout_secs: Optional[float] = None):
        self.config = config
        self.max_path_length = max_path_length
        self.max_path_width = max_path_width
        # 0 disables the bound
        self.timeout_secs = (timeout_secs if timeout_secs is not None
                             else config.EXTRACTOR_TIMEOUT_SECS)
        self.command = extractor_command or find_default_extractor()

    def extract_paths(self, input_path: str
                      ) -> Tuple[List[str], Dict[str, str]]:
        """Run the extractor on one source file -> (one line per method,
        its paths hashed and space-padded to MAX_CONTEXTS contexts; the
        hash -> path string dictionary, keyed by the hash's decimal
        string). Raises ``ExtractorCrash`` when the run fails, a plain
        ``ValueError`` when the input yields no path."""
        command = self.command + [
            '--max_path_length', str(self.max_path_length),
            '--max_path_width', str(self.max_path_width),
            '--file', input_path, '--no_hash']
        # only a language other than Java is named: a reference JAR
        # rejects --lang, and Java is every frontend's default
        lang = infer_language(input_path)
        if lang is not None and lang != 'java':
            command += ['--lang', lang]
        timeout = self.timeout_secs if self.timeout_secs > 0 else None
        try:
            proc = subprocess.run(command, capture_output=True, text=True,
                                  timeout=timeout)
        except subprocess.TimeoutExpired as e:
            stderr = _stderr_of(e)
            raise ExtractorCrash(
                'extractor %r timed out after %gs on `%s`%s'
                % (self.command, timeout, input_path,
                   ': ' + stderr if stderr else ''))
        except OSError as e:
            raise ExtractorCrash('failed to run extractor %r: %s'
                                 % (self.command, e))
        if proc.returncode != 0:
            stderr = _stderr_of(proc)
            raise ExtractorCrash(
                stderr or 'extractor failed with code %d' % proc.returncode)
        output_lines = [line for line in proc.stdout.splitlines()
                        if line.strip()]
        if not output_lines:
            # a clean run without a method is the input's fault: not
            # retried, not counted against the breaker
            raise ValueError('cannot extract any paths from the input file'
                             + (': ' + _stderr_of(proc)
                                if _stderr_of(proc) else ''))

        hash_to_string: Dict[str, str] = {}
        result: List[str] = []
        for line in output_lines:
            parts = line.rstrip().split(' ')
            method_name = parts[0]
            contexts = parts[1:self.config.MAX_CONTEXTS + 1]
            hashed_contexts = []
            for context in contexts:
                pieces = context.split(',')
                if len(pieces) != 3:
                    continue
                source, path_string, target = pieces
                hashed_path = str(common.java_string_hashcode(path_string))
                hash_to_string[hashed_path] = path_string
                hashed_contexts.append(
                    '%s,%s,%s' % (source, hashed_path, target))
            padding = ' ' * (self.config.MAX_CONTEXTS - len(hashed_contexts))
            result.append(method_name + ' ' + ' '.join(hashed_contexts)
                          + padding)
        return result, hash_to_string


_CLOSED, _HALF_OPEN, _OPEN = 0, 1, 2
_STATE_NAMES = {_CLOSED: 'closed', _HALF_OPEN: 'half-open', _OPEN: 'open'}


class ExtractorPool:
    """Extractor calls on persistent worker threads: bounded concurrency,
    the per-call timeout of ``Extractor``, retries with backoff after a
    crash, and a circuit breaker.

    - **closed**: calls run; EXTRACTOR_BREAKER_THRESHOLD crashed calls in
      a row (each already retried EXTRACTOR_RETRIES times) open it;
    - **open**: every call fails fast with ``ExtractorUnavailable`` until
      EXTRACTOR_BREAKER_COOLDOWN_SECS have passed;
    - **half-open**: one probe call runs (others still fail fast); its
      success closes the breaker, its crash opens it again.

    ``clock`` and ``sleep`` (``time.monotonic`` and ``time.sleep``) time
    the cooldown and the backoff. Thread-safe; ``submit`` returns a
    Future, ``extract_paths`` waits for it. Close it, or use it as a
    context manager."""

    # graftlint: guard ExtractorPool._state,_failures,_opened_at by _lock
    # graftlint: guard ExtractorPool._probing by _lock
    def __init__(self, config: Config,
                 extractor_command: Optional[List[str]] = None,
                 workers: Optional[int] = None, log=None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 **extractor_kw):
        self.config = config
        self.log = log if log is not None else (lambda msg: None)
        self.clock = clock
        self.sleep = sleep
        self.extractor = Extractor(config, extractor_command,
                                   **extractor_kw)
        self.retries = config.EXTRACTOR_RETRIES
        self.backoff_secs = config.EXTRACTOR_BACKOFF_SECS
        self.breaker_threshold = config.EXTRACTOR_BREAKER_THRESHOLD
        self.breaker_cooldown_secs = config.EXTRACTOR_BREAKER_COOLDOWN_SECS
        self._lock = threading.Lock()
        self.retries_total = 0
        self.breaker_open_total = 0
        self._state = _CLOSED
        self._failures = 0        # crashed calls in a row
        self._opened_at = 0.0
        self._probing = False     # a half-open probe is running
        workers = (workers if workers is not None
                   else config.EXTRACTOR_POOL_WORKERS)
        self._pool = ThreadPoolExecutor(max_workers=max(1, workers),
                                        thread_name_prefix='extractor')

    # ------------------------------------------------------------ breaker
    def state(self) -> str:
        """'closed', 'half-open' or 'open'."""
        with self._lock:
            return _STATE_NAMES[self._state]

    def _admit(self) -> Optional[bool]:
        """The breaker's gate for one call: None fails it fast, False
        admits a normal call, True admits the call that holds the one
        half-open probe slot (so a straggler admitted while the breaker
        was closed can never release or be judged as the probe)."""
        with self._lock:
            if self._state == _CLOSED:
                return False
            if self._state == _OPEN:
                if self.clock() - self._opened_at \
                        < self.breaker_cooldown_secs:
                    return None
                self._state = _HALF_OPEN
                self._probing = True
                self._export_state_locked()
                return True
            if self._probing:
                return None
            self._probing = True
            return True

    def _on_success(self, probe: bool) -> None:
        with self._lock:
            self._failures = 0
            recovered = False
            if probe:
                self._probing = False
                if self._state != _CLOSED:
                    recovered = True
                    self._state = _CLOSED
                    self._export_state_locked()
        if recovered:
            self.log('extractor breaker: probe succeeded, closed')

    def _on_crash(self, probe: bool) -> None:
        with self._lock:
            self._failures += 1
            if probe:
                self._probing = False
            trip = (probe and self._state == _HALF_OPEN) or \
                self._failures >= self.breaker_threshold
            if trip and self._state != _OPEN:
                self._state = _OPEN
                self._opened_at = self.clock()
                self.breaker_open_total += 1
                self._export_state_locked()
                if tele_core.enabled():
                    tele_core.registry().counter(
                        'serving/breaker_open_total').inc()
            else:
                trip = False
        if trip:
            self.log('extractor breaker: OPEN after %d consecutive '
                     'crashes (cooldown %gs)'
                     % (self.breaker_threshold, self.breaker_cooldown_secs))

    def _export_state_locked(self) -> None:
        if tele_core.enabled():
            tele_core.registry().gauge('serving/breaker_state').set(
                self._state)

    def _release_probe(self, probe: bool) -> None:
        """After an exception outside the crash / content taxonomy: give
        the probe slot back without judging the extractor."""
        if probe:
            with self._lock:
                self._probing = False

    # -------------------------------------------------------------- calls
    def _call(self, input_path: str) -> Tuple[List[str], Dict[str, str]]:
        probe = self._admit()
        if probe is None:
            raise ExtractorUnavailable(
                'extractor circuit breaker is %s (cooldown %gs after %d '
                'consecutive crashes); failing fast'
                % (self.state(), self.breaker_cooldown_secs,
                   self.breaker_threshold))
        last_crash: Optional[ExtractorCrash] = None
        try:
            for attempt in range(self.retries + 1):
                if attempt:
                    with self._lock:
                        self.retries_total += 1
                    if tele_core.enabled():
                        tele_core.registry().counter(
                            'serving/extractor_retries_total').inc()
                    self.sleep(self.backoff_secs * (2 ** (attempt - 1)))
                try:
                    if faults.maybe_fire('extractor_crash'):
                        raise ExtractorCrash(
                            'FAULT_INJECT: injected extractor crash')
                    out = self.extractor.extract_paths(input_path)
                except ExtractorCrash as crash:
                    last_crash = crash
                    continue
                except ValueError:
                    # the input's fault: the extractor itself is healthy
                    self._on_success(probe)
                    raise
                self._on_success(probe)
                return out
        except (ExtractorCrash, ValueError):
            raise
        except BaseException:
            self._release_probe(probe)
            raise
        self._on_crash(probe)
        raise last_crash

    def submit(self, input_path: str) -> Future:
        """Extract on a pool worker: a Future of (lines, hash -> path)."""
        return self._pool.submit(self._call, input_path)

    def extract_paths(self, input_path: str,
                      timeout: Optional[float] = None
                      ) -> Tuple[List[str], Dict[str, str]]:
        """``submit(input_path).result(timeout)``: ``Extractor``'s call
        with the pool's retries and breaker."""
        return self.submit(input_path).result(timeout)

    # ---------------------------------------------------------- lifecycle
    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self) -> 'ExtractorPool':
        return self

    def __exit__(self, *exc) -> None:
        self.close()
