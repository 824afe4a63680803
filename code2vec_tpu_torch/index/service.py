"""Neighbor queries as a serving workload: build, load and query — the port
of ``code2vec_tpu/index/service.py``.

- ``build_index(model, config)`` — ``--build-index SOURCE``: a store
  (+ the IVF or quantized sidecars) from a ``.c2v`` corpus (streamed
  through ``serving/bulk.py::iter_code_vector_batches``, no text round
  trip), a ``.vectors`` text export, or a word2vec text file.
- ``load_index(path, config, model)`` — open a built index at the
  configured tier.
- ``query_neighbors_file(model, config)`` — ``--query-neighbors
  FILE.c2v``: every kept example through the vectors tier and the index,
  one JSONL record per query in ``FILE.neighbors.jsonl`` (the
  reference's record).

The interactive composition lives on the serving engine:
``ServingEngine.attach_index`` + ``submit_neighbors``.

The index runs where the model runs (``model.device``), else on
``config.DEVICE``.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import List, NamedTuple, Optional

import numpy as np

from code2vec_tpu_torch.index import store as store_lib
from code2vec_tpu_torch.index.exact import ExactIndex
from code2vec_tpu_torch.index.ivf import (DEFAULT_NPROBE, IVF_NAME, IVFIndex,
                                          measure_recall)
from code2vec_tpu_torch.telemetry import core as tele_core

logger = logging.getLogger(__name__)


class NeighborResult(NamedTuple):
    """Neighbors of ONE query, rank order. ``indices`` are store row ids
    (-1 sentinels when the probed lists held fewer than k candidates);
    ``labels`` aligns with ``indices`` when the store has labels, else
    None."""
    indices: np.ndarray          # (k,) int
    scores: np.ndarray           # (k,) float32
    labels: Optional[List[str]] = None


def neighbors_from_search(values: np.ndarray, indices: np.ndarray,
                          labels) -> List[NeighborResult]:
    """Per-query ``NeighborResult`` rows from a batched search output."""
    out = []
    for row_values, row_indices in zip(values, indices):
        row_labels = None
        if labels is not None:
            row_labels = [str(labels[i]) if i >= 0 else ''
                          for i in row_indices]
        out.append(NeighborResult(indices=row_indices,
                                  scores=row_values,
                                  labels=row_labels))
    return out


def _looks_like_word2vec(path: str) -> bool:
    """A word2vec text export starts with a `count dim` header."""
    try:
        with open(path, 'r', encoding='utf-8', errors='replace') as f:
            parts = f.readline().split()
        return len(parts) == 2 and all(p.isdigit() for p in parts)
    except OSError:
        return False


def _device_of(model, config):
    return model.device if model is not None else config.DEVICE


def build_index(model, config, source: Optional[str] = None,
                out_dir: Optional[str] = None):
    """Build a store at ``out_dir`` (default ``<source>.vecindex``) from
    ``source``, add the IVF or quantized sidecars at the configured tier
    (logging measured recall@10 against the exact tier on a held-out
    sample of store rows), and return the loaded index."""
    source = source if source is not None else config.BUILD_INDEX_FROM
    out_dir = (out_dir if out_dir is not None
               else (config.INDEX_PATH
                     or source + store_lib.STORE_SUFFIX))
    log = logger.info
    kwargs = dict(dtype=config.VECTORS_DTYPE, metric=config.INDEX_METRIC,
                  log=log)
    if source.endswith('.c2v'):
        if model is None:
            raise ValueError('building an index from a .c2v corpus needs '
                             'a model (the vectors tier embeds it)')
        from code2vec_tpu_torch.serving import bulk
        labels: List[str] = []

        def chunks():
            for vectors, batch_labels in bulk.iter_code_vector_batches(
                    model, source, with_labels=True):
                labels.extend(str(label) for label in batch_labels)
                yield vectors

        # the builder writes every chunk before it reads the labels, so
        # `labels` is complete by then
        store = store_lib.build(out_dir, chunks(), labels=labels,
                                **kwargs)
    elif _looks_like_word2vec(source):
        store = store_lib.build_from_word2vec(source, out_dir, **kwargs)
    else:
        store = store_lib.build_from_vectors_file(source, out_dir,
                                                  **kwargs)
    index = _open_tier(store, config, model)
    if isinstance(index, IVFIndex) or config.INDEX_QUANT:
        sample = min(256, store.count)
        rng = np.random.default_rng(0)
        queries = np.asarray(
            store.all_rows()[rng.choice(store.count, sample,
                                        replace=False)], np.float32)
        exact = ExactIndex(store, device=_device_of(model, config))
        recall = measure_recall(index, exact, queries, k=10)
        tier = config.INDEX_QUANT or 'IVF'
        log('index: %s recall@10 = %.3f vs exact on %d held-out store '
            'rows (nprobe=%d of %d lists)'
            % (tier, recall, sample, index.nprobe, index.n_clusters))
        if config.INDEX_QUANT:
            log('index: quantized tier serves %d bytes/vector on '
                'device (f16 rows would be %d)'
                % (index.bytes_per_vector, 2 * store.dim))
    log('index: ready at `%s` (%s, %d vectors, metric=%s, dtype=%s)'
        % (out_dir, config.INDEX_QUANT or config.INDEX_KIND,
           store.count, store.metric, store.dtype.name))
    return index


def _open_tier(store, config, model=None):
    """Store -> index at the configured tier. IVF and the quantized tier
    reuse their persisted sidecars when present, else build (and
    persist) them; exact never silently upgrades."""
    device = _device_of(model, config)
    if config.INDEX_QUANT:
        from code2vec_tpu_torch.index.quant import (QUANT_NAME,
                                                    QuantizedIVFIndex)
        nprobe = config.INDEX_NPROBE or DEFAULT_NPROBE
        kwargs = dict(nprobe=nprobe, rerank=config.INDEX_RERANK,
                      segment_rows=config.INDEX_SEGMENT_ROWS,
                      compact_segments=config.INDEX_COMPACT_SEGMENTS,
                      device=device)
        if os.path.isfile(os.path.join(store.path, QUANT_NAME)):
            index = QuantizedIVFIndex(store, kind=config.INDEX_QUANT,
                                      **kwargs)
        else:
            index = QuantizedIVFIndex.build(
                store, kind=config.INDEX_QUANT,
                n_clusters=config.INDEX_CLUSTERS or None,
                pq_m=config.INDEX_PQ_M, log=logger.info, **kwargs)
        index.warmup(config.INDEX_NEIGHBORS_K)
        return index
    if config.INDEX_KIND == 'ivf':
        nprobe = config.INDEX_NPROBE or DEFAULT_NPROBE
        if os.path.isfile(os.path.join(store.path, IVF_NAME)):
            return IVFIndex(store, nprobe=nprobe, device=device)
        return IVFIndex.build(
            store, n_clusters=config.INDEX_CLUSTERS or None,
            nprobe=nprobe, log=logger.info, device=device)
    return ExactIndex(store, device=device).warmup(config.INDEX_NEIGHBORS_K)


def load_index(path: str, config, model=None):
    """Open a built index directory at the configured tier (IVF builds
    and persists its sidecar on first open; exact warms at
    ``INDEX_NEIGHBORS_K``)."""
    return _open_tier(store_lib.VectorStore(path), config, model)


def query_neighbors_file(model, config, index=None,
                         corpus_path: Optional[str] = None,
                         output_path: Optional[str] = None):
    """Batch neighbor queries: stream ``corpus_path`` (default
    ``QUERY_NEIGHBORS_PATH``) through the vectors tier and the index,
    writing one JSONL record per kept example to ``output_path``
    (default ``<corpus>.neighbors.jsonl``)::

        {"name": "do|thing", "neighbors":
            [{"rank": 0, "row": 17, "score": 0.93, "label": "do|other"},
             ...]}

    Returns ``(n_queries, output_path)``."""
    from code2vec_tpu_torch.serving import bulk
    corpus_path = (corpus_path if corpus_path is not None
                   else config.QUERY_NEIGHBORS_PATH)
    output_path = (output_path if output_path is not None
                   else corpus_path + '.neighbors.jsonl')
    if index is None:
        index = load_index(config.INDEX_PATH, config, model)
    k = config.INDEX_NEIGHBORS_K
    total = 0
    t0 = time.perf_counter()
    with open(output_path, 'w') as out:
        for vectors, batch_labels in bulk.iter_code_vector_batches(
                model, corpus_path, with_labels=True):
            values, indices = index.search(vectors, k)
            results = neighbors_from_search(values, indices, index.labels)
            for r, result in enumerate(results):
                record = {
                    'name': str(batch_labels[r]),
                    'neighbors': [
                        {'rank': rank, 'row': int(row),
                         'score': float(score),
                         **({'label': result.labels[rank]}
                            if result.labels is not None else {})}
                        for rank, (row, score) in enumerate(
                            zip(result.indices, result.scores))
                        if row >= 0]}
                out.write(json.dumps(record) + '\n')
            total += len(results)
    elapsed = time.perf_counter() - t0
    if tele_core.enabled():
        tele_core.registry().gauge('index/queries_per_sec').set(
            total / max(elapsed, 1e-9))
    logger.info('index: %d neighbor queries -> `%s` (%d queries/sec)',
                total, output_path, int(total / max(elapsed, 1e-9)))
    return total, output_path
