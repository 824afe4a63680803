"""Builds the hand-written CUDA kernels at first use and loads them with
``ctypes``.

Each source under ``ops/csrc/`` has a plain C interface and is compiled
alone by ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the root of
the checkout (git ignores it); the sources share the device helpers of
``csrc/common.cuh``. The library's name carries a digest of the source,
the headers and the flags, so an edited source or header is rebuilt and
a stale library is never loaded. Several sources build in parallel, one ``nvcc``
each. Nothing here runs at import time. A library's first load in the
process (its build included) counts as one compile of the telemetry
(``telemetry/jit_tracker.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

from code2vec_tpu_torch.telemetry import jit_tracker

_CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')
SOURCES = {'ragged_fwd': 'ragged_fwd.cu', 'ragged_bwd': 'ragged_bwd.cu',
           'ce': 'ce.cu', 'encode': 'encode.cu', 'adam': 'adam.cu'}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found is None and os.path.exists('/usr/local/cuda/bin/nvcc'):
        found = '/usr/local/cuda/bin/nvcc'
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                           'toolkit to build')
    return found


def library_path(name: str) -> Path:
    hasher = hashlib.sha256((_CSRC / SOURCES[name]).read_bytes())
    for header in sorted(_CSRC.glob('*.cuh')):
        hasher.update(header.read_bytes())
    hasher.update(' '.join(NVCC_FLAGS).encode())
    digest = hasher.hexdigest()[:16]
    return BUILD_DIR / ('lib%s-%s.so' % (name, digest))


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, dict]:
    """Compile every named kernel whose library is missing, all ``nvcc``
    processes started together. Returns ``{name: {'seconds', 'log'}}``
    (``log`` holds ptxas's register and shared-memory report); raises
    with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix('.so.tmp%d' % os.getpid())
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
               str(_CSRC / SOURCES[name])]
        running[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    report = {}
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        report[name] = {'seconds': time.perf_counter() - t0, 'log': log}
        if proc.returncode != 0:
            failed.append('%s (exit %d):\n%s' % (name, proc.returncode, log))
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError('kernel build failed: ' + '\n'.join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The named kernel's library, built first if it is missing."""
    lib = _LIBS.get(name)
    if lib is None:
        t0 = time.perf_counter()
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
        jit_tracker.note_compile(time.perf_counter() - t0)
    return lib
