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

The reference's single-host guard has no counterpart here: the bulk
feed runs on one rank (a training mesh of ranks, ``parallel/``, refuses
it typed); its multi-process export is ROADMAP A9b.
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

from code2vec_tpu_torch.data import packed as packed_lib
from code2vec_tpu_torch.data.reader import PathContextReader
from code2vec_tpu_torch.serving.engine import decode_results
from code2vec_tpu_torch.serving.steps import predict_step
from code2vec_tpu_torch.telemetry import core as tele_core

logger = logging.getLogger(__name__)


def _record_throughput(examples: int, seconds: float) -> float:
    rate = examples / max(seconds, 1e-9)
    if tele_core.enabled():
        tele_core.registry().gauge('serving/bulk_examples_per_sec').set(rate)
    return rate


def _one_step_ahead(model, batches: Iterable, tier: str) -> Iterator:
    """``(outputs, host batch)`` per batch, each yielded once the next
    batch's step is dispatched (the last at the end)."""
    pending = None
    with contextlib.closing(model.trainer.stage_batches(batches)) as staged:
        for arrays, batch in staged:
            out = predict_step(model.backend, arrays, tier=tier)
            if pending is not None:
                yield pending
            pending = (out, batch)
    if pending is not None:
        yield pending


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
    export both depend on it (tests/test_torch_bulk.py)."""
    # a reader of its own: the corpus's sticky packed capacity
    reader = PathContextReader(model.vocabs, model.config)
    total = 0
    t0 = time.perf_counter()
    for out, batch in _one_step_ahead(
            model, reader.iter_epoch_prefetched(evaluate=True,
                                                data_path=corpus_path),
            'vectors'):
        valid = batch.weight > 0
        vectors = out['code_vectors'].float().cpu().numpy()[valid]
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
    (default ``VECTORS_DTYPE``; 'float16' keeps fewer digits).
    Returns ``(n_vectors, output_path)``."""
    out_path = output_path if output_path is not None \
        else corpus_path + '.vectors'
    out_dtype = np.dtype(dtype or model.config.VECTORS_DTYPE)
    total = 0
    t0 = time.perf_counter()
    with open(out_path, 'w') as out_file:
        for vectors, _labels in iter_code_vector_batches(model,
                                                         corpus_path):
            for vec in vectors.astype(out_dtype):
                out_file.write(' '.join(map(str, vec)) + '\n')
            total += vectors.shape[0]
    rate = _record_throughput(total, time.perf_counter() - t0)
    logger.info('Exported %d code vectors (%s) to `%s` (%d examples/sec).',
                total, out_dtype.name, out_path, int(rate))
    return total, out_path


def bulk_predict(model, context_lines: Iterable[str], tier: str = 'topk',
                 batch_size: Optional[int] = None) -> Iterator:
    """Stream predictions for raw context lines (predict semantics: never
    filtered) through TEST_BATCH_SIZE batches (or ``batch_size``),
    yielding one ``ModelPredictionResults`` per input line, in order.
    ``tier`` selects the outputs ('topk' | 'attention' | 'full' |
    'vectors'); the packed wire packs under one ``StickyPacker``."""
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

    def wire_batches():
        if config.BATCH_WIRE_FORMAT != 'packed':
            yield from batches()
            return
        # sticky capacity across the run: a few packed shapes per stream
        packer = packed_lib.StickyPacker(model.backend.token_pad_index,
                                         model.backend.path_pad_index)
        for batch in batches():
            yield packer.pack_batch(batch)

    total = 0
    t0 = time.perf_counter()
    for out, batch in _one_step_ahead(model, wire_batches(), tier):
        fetched = {key: value.cpu().numpy() for key, value in out.items()}
        results = decode_results(fetched, batch, int((batch.weight > 0).sum()),
                                 model._target_index_to_word)
        total += len(results)
        yield from results
    _record_throughput(total, time.perf_counter() - t0)
