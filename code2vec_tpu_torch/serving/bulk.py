"""Corpus-scale offline serving: whole ``.c2v`` files and streams of raw
lines in TEST_BATCH_SIZE batches — the port of
``code2vec_tpu/serving/bulk.py``.

Batches go up through the trainer's staging ring
(``Trainer.stage_batches``: pinned buffers and a side stream on the
card) and through ``serving/steps.py::predict_step``; batch k + 1 is
dispatched before batch k is fetched, so the host's decode overlaps the
device.

- ``iter_code_vector_batches`` runs the 'vectors' tier (the (B, V)
  logits product and top-k are skipped) and yields each batch's kept
  rows — the feed of the index build (``index/service.py``);
- ``export_code_vectors`` writes them as text, one vector per line;
- ``bulk_predict`` streams predictions (any tier) for raw context
  lines, in order, never filtered.

On a (data, model) mesh of ranks (``parallel/``; the counterpart of the
reference's one-process mesh of one host's devices) every rank runs them
together on the same input. Every rank reads the whole corpus into the
same global batches of TEST_BATCH_SIZE rows, so every rank runs the same
number of steps; data index d takes rows [d B / D, (d + 1) B / D) of
each (the reference's ``batch_spec``) and packs only its shard, at its
own sticky capacity. The step runs through the B7 routes (the model
axis's gather and sum of rows, ``ops/ragged.py``); each batch's outputs
are gathered over the data axis in shard order (``gather_outputs``), so
every rank yields the one-rank output in corpus order, and the chief
writes the files. A shard of padding rows has weight 0 and counts
nowhere. A world whose ranks span hosts is refused typed, as the
reference's single-host guard refuses a multi-host run.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from code2vec_tpu_torch.data import packed as packed_lib
from code2vec_tpu_torch.data.reader import (Batch, PathContextReader,
                                            prefetch_iterator)
from code2vec_tpu_torch.parallel import mesh as mesh_lib
from code2vec_tpu_torch.serving.engine import decode_results
from code2vec_tpu_torch.serving.steps import predict_step
from code2vec_tpu_torch.telemetry import core as tele_core

logger = logging.getLogger(__name__)


def _record_throughput(examples: int, seconds: float) -> float:
    rate = examples / max(seconds, 1e-9)
    if tele_core.enabled():
        tele_core.registry().gauge('serving/bulk_examples_per_sec').set(rate)
    return rate


class _Shard:
    """This rank's shard of a global batch on the wire (``wire``), with
    the global batch it came from (``whole``: the strings, the weights
    the decode reads)."""

    def __init__(self, wire, whole):
        self.wire = wire
        self.whole = whole

    def device_arrays(self):
        return self.wire.device_arrays()


def shard_batch(model, batch: Batch) -> Batch:
    """This rank's data shard of a global plane batch: rows [d B / D,
    (d + 1) B / D) of every field (the batch itself without a mesh)."""
    if model.mesh is None or model.mesh.data == 1:
        return batch
    rows = batch.label.shape[0]
    if rows % model.mesh.data:
        raise ValueError('a batch of %d rows does not split over the data '
                         'axis (%d)' % (rows, model.mesh.data))
    per = rows // model.mesh.data
    part = slice(model.mesh.data_index * per,
                 (model.mesh.data_index + 1) * per)
    return Batch(*[None if field is None else field[part]
                   for field in batch])


def wire_shards(model, batches: Iterable[Batch], sticky: bool = True
                ) -> Iterator[_Shard]:
    """Global plane batches -> this rank's shard of each on
    BATCH_WIRE_FORMAT's wire (packed under one ``StickyPacker``, or at
    each shard's own capacity without ``sticky``)."""
    packer = None
    if model.config.BATCH_WIRE_FORMAT == 'packed' and sticky:
        packer = packed_lib.StickyPacker(model.backend.token_pad_index,
                                         model.backend.path_pad_index)
    for batch in batches:
        shard = shard_batch(model, batch)
        if model.config.BATCH_WIRE_FORMAT == 'packed':
            shard = (packer.pack_batch(shard) if packer is not None
                     else packed_lib.pack_batch(
                         shard, model.backend.token_pad_index,
                         model.backend.path_pad_index, data_shards=1))
        yield _Shard(shard, batch)


def gather_outputs(model, out: Dict[str, object]) -> Dict[str, np.ndarray]:
    """A step's outputs on the host: each gathered over the data axis in
    shard order on a mesh (every rank of a model column then holds the
    global batch's rows; every rank calls it)."""
    fetched = {}
    for key, value in out.items():
        if model.mesh is not None:
            value = model.mesh.gather_rows(value, mesh_lib.DATA_AXIS)
        if value.dtype == torch.bfloat16:
            value = value.float()
        fetched[key] = value.cpu().numpy()
    return fetched


def _one_step_ahead(model, shards: Iterable[_Shard], tier: str) -> Iterator:
    """``(host outputs, global batch)`` per batch, each fetched once the
    next batch's step is dispatched (the last at the end)."""
    pending = None
    with contextlib.closing(model.trainer.stage_batches(shards)) as staged:
        for arrays, shard in staged:
            out = predict_step(model.backend, arrays, tier=tier)
            if pending is not None:
                yield gather_outputs(model, pending[0]), pending[1]
            pending = (out, shard.whole)
    if pending is not None:
        yield gather_outputs(model, pending[0]), pending[1]


def iter_code_vector_batches(model, corpus_path: str,
                             with_labels: bool = False):
    """Stream a ``.c2v`` corpus through the 'vectors' tier and yield
    ``(vectors, labels)`` per batch — ``vectors`` a ``(n_i, D)`` float32
    array of the batch's kept rows, ``labels`` the matching object array
    of method names (None unless ``with_labels``).

    ORDER GUARANTEE: concatenated across batches, row i is the i-th KEPT
    example of the corpus, in file order — rows with no valid context are
    dropped (the evaluate-path filter) and the last batch's zero-weight
    padding rows are excluded. The index build and the ``.vectors`` text
    export both depend on it (tests/test_torch_bulk.py). On a mesh every
    rank runs it and yields the same (module docstring)."""
    mesh_lib.require_one_host(model.mesh, 'iter_code_vector_batches')
    # a reader of its own over the whole corpus, on the plane wire: the
    # shards go onto the wire after the split, on the prefetch thread
    reader = PathContextReader(model.vocabs, model.config)
    shards = prefetch_iterator(
        lambda: wire_shards(model, reader.iter_epoch(
            evaluate=True, data_path=corpus_path, wire_format='planes')),
        model.config.READER_PREFETCH_BATCHES)
    total = 0
    t0 = time.perf_counter()
    for fetched, batch in _one_step_ahead(model, shards, 'vectors'):
        valid = batch.weight > 0
        vectors = fetched['code_vectors'].astype(np.float32)[valid]
        total += vectors.shape[0]
        yield vectors, (batch.label_strings[valid] if with_labels
                        else None)
    _record_throughput(total, time.perf_counter() - t0)


def export_code_vectors(model, corpus_path: str,
                        output_path: Optional[str] = None,
                        dtype: Optional[str] = None) -> Tuple[int, str]:
    """Embed every example of ``corpus_path`` with at least one valid
    context into ``output_path`` (default ``<corpus>.vectors``): one
    space-separated code vector per line, in corpus order (the
    ``iter_code_vector_batches`` guarantee), narrowed to ``dtype``
    (default ``VECTORS_DTYPE``; 'float16' keeps fewer digits). On a mesh
    every rank runs it and the chief writes the file.
    Returns ``(n_vectors, output_path)``."""
    out_path = output_path if output_path is not None \
        else corpus_path + '.vectors'
    out_dtype = np.dtype(dtype or model.config.VECTORS_DTYPE)
    chief = model.mesh is None or model.is_chief
    total = 0
    t0 = time.perf_counter()
    with open(out_path if chief else os.devnull, 'w') as out_file:
        for vectors, _labels in iter_code_vector_batches(model,
                                                         corpus_path):
            if chief:
                for vec in vectors.astype(out_dtype):
                    out_file.write(' '.join(map(str, vec)) + '\n')
            total += vectors.shape[0]
    rate = _record_throughput(total, time.perf_counter() - t0)
    if chief:
        logger.info('Exported %d code vectors (%s) to `%s` (%d '
                    'examples/sec).', total, out_dtype.name, out_path,
                    int(rate))
    return total, out_path


def bulk_predict(model, context_lines: Iterable[str], tier: str = 'topk',
                 batch_size: Optional[int] = None) -> Iterator:
    """Stream predictions for raw context lines (predict semantics: never
    filtered) through TEST_BATCH_SIZE batches (or ``batch_size``),
    yielding one ``ModelPredictionResults`` per input line, in order.
    ``tier`` selects the outputs ('topk' | 'attention' | 'full' |
    'vectors'); the packed wire packs under one ``StickyPacker``. On a
    mesh every rank passes the same lines and yields the same results."""
    mesh_lib.require_one_host(model.mesh, 'bulk_predict')
    config = model.config
    reader = model.reader
    size = batch_size if batch_size is not None else config.TEST_BATCH_SIZE

    def batches():
        chunk = []
        for line in context_lines:
            chunk.append(line)
            if len(chunk) == size:
                yield reader.process_input_rows(chunk)
                chunk = []
        if chunk:
            yield reader.pad_batch_to(reader.process_input_rows(chunk),
                                      size)

    total = 0
    t0 = time.perf_counter()
    for fetched, batch in _one_step_ahead(model, wire_shards(model,
                                                             batches()),
                                          tier):
        results = decode_results(fetched, batch, int((batch.weight > 0).sum()),
                                 model._target_index_to_word)
        total += len(results)
        yield from results
    _record_throughput(total, time.perf_counter() - t0)
