"""Shared harness pieces for the port's timed runs (``chip_smoke.py`` now,
the port's benchmark later) — the counterpart of
``code2vec_tpu/benchlib.py``: one definition of the java14m headline
configuration (the reference's config.py:47-70), the synthetic batches,
the timers, the step counts, the device-memory record and the kernels'
launch counts, so a change to the benchmark configuration cannot apply
to some harnesses and not others.

The reference's ``honor_env_platforms`` has no counterpart: the port
picks its device explicitly (``device.py::resolve_device``), so each
``build_*`` function here takes a ``device`` ('cuda' by default, which
raises with no GPU; the CPU only when asked for). ``mosaic_engaged`` (a
Pallas call in the compiled program) becomes ``kernels_engaged``: the
launch counts of the hand-written kernels that one call caused.
"""
from __future__ import annotations

import os
import statistics
import time
from typing import NamedTuple

from code2vec_tpu_torch.telemetry.core import Timer

V100_BASELINE_EXAMPLES_PER_SEC = 4700.0  # reference README.md:69,127


class BenchShapes(NamedTuple):
    token_vocab: int
    path_vocab: int
    target_vocab: int
    batch_size: int
    max_contexts: int


JAVA14M = BenchShapes(token_vocab=1301136, path_vocab=911417,
                      target_vocab=261245, batch_size=1024, max_contexts=200)
# Fraction of the 200 context slots a real java14m example fills
# (contexts a method: median 28 with a long tail), the shape for wire
# measurements. The compute measurements keep full batches (fill 1.0).
JAVA14M_FILL = 0.25
# Tiny shapes so a harness can be validated on the CPU; a caller renames
# its metrics so a smoke line is never mistaken for a real one.
SMOKE_SHAPES = BenchShapes(token_vocab=1000, path_vocab=1000,
                           target_vocab=500, batch_size=64, max_contexts=16)


def smoke_requested() -> bool:
    return os.environ.get('BENCH_SMOKE', '') not in ('', '0', 'false')


def bench_steps(smoke: bool):
    """(warmup_steps, measure_steps) shared by every timed harness."""
    return (2, 5) if smoke else (10, 60)


# ------------------------------------------------------------- timers
def _sync_card() -> None:
    """Wait for the card's queued work, when this process has touched
    the card (nothing to wait for otherwise)."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _SyncedRegion:
    __slots__ = ('_timer', '_t0')

    def __init__(self, timer: 'BenchTimer'):
        self._timer = timer
        self._t0 = 0.0

    def __enter__(self) -> '_SyncedRegion':
        _sync_card()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        _sync_card()
        self._timer.record(time.perf_counter() - self._t0)


class BenchTimer(Timer):
    """The telemetry ``Timer`` whose timed region ends when the card's
    work does: ``time()`` synchronizes the card at both ends (launches
    return before the card finishes)."""

    __slots__ = ()

    def time(self) -> _SyncedRegion:
        return _SyncedRegion(self)


def bench_timer(name: str = 'bench', window: int = 1024):
    """A telemetry ``Timer`` (``telemetry/core.py``) for timed loops::

        sw = benchlib.bench_timer()
        with sw.time():
            <timed region>
        seconds = sw.last          # or .total / .snapshot() for stats

    On the card the region ends in ``torch.cuda.synchronize()`` inside
    the timer. Not registered in the process-global registry: a
    harness's timings never leak into a live run's exported metrics."""
    return BenchTimer(name, window=window)


def bench_timer_wall(fn) -> float:
    """Seconds of one call of ``fn`` through ``bench_timer`` (the card's
    work included)."""
    sw = bench_timer()
    with sw.time():
        fn()
    return sw.last


def bench_cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device milliseconds of ``fn()`` on the card: warmed on a side
    stream, captured once in a CUDA graph and replayed ``reps`` times
    between CUDA events, so the Python around a kernel does not leave
    the card idle inside the timed window. Raises with no GPU."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError('bench_cuda_ms times the card: no CUDA device '
                           'is available')
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_memory_record() -> dict:
    """The card's footprint for a harness's records:
    ``peak_hbm_bytes`` / ``hbm_bytes_in_use`` from the caching
    allocator (``telemetry/memory.py::backend_memory``; reserved bytes,
    as the reference reads its runtime's). On the CPU, or before the
    process touched the card, both are an explicit None."""
    from code2vec_tpu_torch.telemetry.memory import backend_memory
    mem = backend_memory()
    devices = mem['devices'] if mem is not None else ()
    if not devices:
        return {'peak_hbm_bytes': None, 'hbm_bytes_in_use': None}
    return {'peak_hbm_bytes': sum(d['peak_bytes_in_use'] for d in devices),
            'hbm_bytes_in_use': sum(d['bytes_in_use'] for d in devices)}


def kernels_engaged(fn, *args) -> dict:
    """Run ``fn(*args)`` once; returns the launches of each hand-written
    kernel it caused (``ops.launch_counts`` after less before; 0 where
    a wrapper ran its plain version, as on the CPU)."""
    from code2vec_tpu_torch.ops import launch_counts
    before = launch_counts()
    fn(*args)
    after = launch_counts()
    return {name: after[name] - before[name] for name in after}


# ---------------------------------------------------- config, trainers
def headline_config(shapes: BenchShapes, device: str = 'cuda',
                    **overrides):
    """The java14m benchmark Config (bfloat16 compute) on ``device``."""
    from code2vec_tpu_torch.config import Config
    kwargs = dict(
        TRAIN_DATA_PATH_PREFIX='bench', DEVICE=str(device),
        COMPUTE_DTYPE='bfloat16', VERBOSE_MODE=0, READER_USE_NATIVE=False,
        TRAIN_BATCH_SIZE=shapes.batch_size, TEST_BATCH_SIZE=shapes.batch_size,
        MAX_CONTEXTS=shapes.max_contexts,
        MAX_TOKEN_VOCAB_SIZE=shapes.token_vocab,
        MAX_PATH_VOCAB_SIZE=shapes.path_vocab,
        MAX_TARGET_VOCAB_SIZE=shapes.target_vocab)
    kwargs.update(overrides)
    return Config(**kwargs)


def _make_trainer(config, shapes: BenchShapes, device, seed: int):
    from code2vec_tpu_torch.device import resolve_device
    from code2vec_tpu_torch.models.backends import TorchBackend
    from code2vec_tpu_torch.training.trainer import Trainer
    from code2vec_tpu_torch.vocab import SizeOnlyVocabs
    backend = TorchBackend(
        config, SizeOnlyVocabs(shapes.token_vocab, shapes.path_vocab,
                               shapes.target_vocab),
        resolve_device(device if device is not None else config.DEVICE),
        seed=seed)
    return Trainer(config, backend)


def build_trainer(config, shapes: BenchShapes, device=None, seed: int = 0):
    """(trainer, initial training state) for the benchmark Config: weights
    drawn from ``seed`` on ``device`` (``config.DEVICE`` by default) and
    zero moments."""
    trainer = _make_trainer(config, shapes, device, seed)
    return trainer, trainer.state_from_params(seed=seed)


def build_eval_trainer(config, shapes: BenchShapes, device=None,
                       seed: int = 0):
    """(trainer, params) WITHOUT optimizer state: eval-only harnesses
    allocate none of the moments they never read. The parameters are
    registered with the memory ledger (``params`` bucket) alone."""
    trainer = _make_trainer(config, shapes, device, seed)
    params = trainer.backend.trainable_params
    trainer.register_state_memory(params)
    return trainer, params


# ------------------------------------------------------------ batches
def random_batches(shapes: BenchShapes, n: int, seed: int = 0,
                   fill: float = 1.0):
    """``n`` synthetic host batches of uniform random indices, the same
    draws from the same seed as the reference's.

    ``fill`` < 1.0 gives each example a random effective length around
    ``fill * max_contexts`` (PAD-filled tail, mask zeroed), the shape for
    wire measurements (JAVA14M_FILL); the default keeps full batches."""
    import numpy as np

    from code2vec_tpu_torch.data.reader import Batch
    rng = np.random.default_rng(seed)
    batch, contexts = shapes.batch_size, shapes.max_contexts
    out = []
    for _ in range(n):
        source = rng.integers(1, shapes.token_vocab,
                              (batch, contexts)).astype(np.int32)
        path = rng.integers(1, shapes.path_vocab,
                            (batch, contexts)).astype(np.int32)
        target = rng.integers(1, shapes.token_vocab,
                              (batch, contexts)).astype(np.int32)
        mask = np.ones((batch, contexts), np.float32)
        if fill < 1.0:
            lengths = rng.integers(
                max(1, int(fill * contexts * 0.5)),
                max(2, int(fill * contexts * 1.5)) + 1, (batch,))
            dead = np.arange(contexts)[None, :] >= lengths[:, None]
            source[dead] = 0
            path[dead] = 0
            target[dead] = 0
            mask[dead] = 0.0
        out.append(Batch(
            source=source, path=path, target=target, mask=mask,
            label=rng.integers(1, shapes.target_vocab,
                               (batch,)).astype(np.int32),
            weight=np.ones((batch,), np.float32)))
    return out


def pack_batches(batches, trainer):
    """Plane batches -> PackedBatch list for the trainer (packed per data
    shard of its mesh, PAD indices from its backend). Every batch gets ONE
    capacity, so a timed loop runs one shape throughout."""
    from code2vec_tpu_torch.data import packed as packed_lib
    shards = trainer.mesh.data if trainer.mesh is not None else 1
    backend = trainer.backend

    def pack_all(minimum):
        return [packed_lib.pack_batch(
            batch, backend.token_pad_index, backend.path_pad_index,
            data_shards=shards, capacity_minimum=minimum)
            for batch in batches]

    packed = pack_all(packed_lib.MIN_CAPACITY)
    caps = {p.ctx.shape[1] for p in packed}
    if len(caps) > 1:
        packed = pack_all(max(caps))
    return packed


def wire_bytes(batch) -> int:
    """Bytes a batch puts on the host-to-device wire (either format)."""
    from code2vec_tpu_torch.data import packed as packed_lib
    return packed_lib.wire_bytes(batch)


def staged(trainer, host_batches):
    """The batches on the trainer's device through its own staging ring
    (``Trainer.stage_batches``: pinned buffers, side stream, events); on
    a mesh of ranks each batch is first cut to the rank's data shard."""
    if trainer.mesh is not None:
        host_batches = [trainer.mesh.shard_batch(
            b.device_arrays() if hasattr(b, 'device_arrays') else b)
            for b in host_batches]
    return [arrays for arrays, _ in
            trainer.stage_batches(iter(host_batches))]
