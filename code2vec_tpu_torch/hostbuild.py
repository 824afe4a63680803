"""Host programs the port builds from the checkout with g++ at first
use: the native tokenizer's library (``data/native.py``) and the
path-context extractor (``serving/extractor_bridge.py``). Outputs go into
the gitignored ``build/`` at the root of the checkout; a build writes a
temporary file and renames it, under a file lock, so concurrent or killed
builds never leave a torn output, and an output older than any of its
sources is rebuilt. A compile counts as one compile of the telemetry
(``telemetry/jit_tracker.py``)."""
from __future__ import annotations

import fcntl
import os
import subprocess
import time
from typing import Sequence

from code2vec_tpu_torch.telemetry import jit_tracker

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(REPO_ROOT, 'build')


class BuildError(RuntimeError):
    """g++ failed (its output is in the message) or could not run."""


def is_stale(output: str, sources: Sequence[str]) -> bool:
    if not os.path.isfile(output):
        return True
    built = os.path.getmtime(output)
    return any(os.path.getmtime(source) > built for source in sources)


def build(output: str, main_source: str, flags: Sequence[str],
          depends: Sequence[str] = ()) -> bool:
    """``g++ flags main_source -o output`` when ``output`` is missing or
    older than ``main_source`` or one of ``depends``. Returns whether it
    compiled."""
    sources = [main_source, *depends]
    missing = [s for s in sources if not os.path.isfile(s)]
    if missing:
        raise BuildError('missing source files: %s' % ', '.join(missing))
    if not is_stale(output, sources):
        return False
    os.makedirs(os.path.dirname(output), exist_ok=True)
    with open(output + '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        # another process may have built it while this one waited
        if not is_stale(output, sources):
            return False
        tmp = '%s.%d.tmp' % (output, os.getpid())
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(['g++', *flags, main_source, '-o', tmp],
                                  capture_output=True, text=True)
        except OSError as exc:
            raise BuildError('g++ could not run: %s' % exc)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise BuildError('g++ exit %d building %s:\n%s'
                             % (proc.returncode, output,
                                proc.stderr.strip()))
        os.replace(tmp, output)
    jit_tracker.note_compile(time.perf_counter() - t0)
    return True
