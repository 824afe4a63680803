"""Serving helpers: the batch-bucket ladder and the decode of predict
outputs (the subset of ``code2vec_tpu/serving/engine.py`` that
``Code2VecModel.predict`` uses; the micro-batching engine comes later)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def batch_ladder(buckets: Sequence[int], data_axis: int) -> Tuple[int, ...]:
    """Sorted, deduplicated batch buckets, each rounded up to a multiple
    of ``data_axis``."""
    if data_axis < 1:
        raise ValueError('data_axis must be >= 1, got %d' % data_axis)
    out = set()
    for bucket in buckets:
        bucket = int(bucket)
        if bucket < 1:
            raise ValueError('batch buckets must be >= 1, got %d' % bucket)
        out.add(-(-bucket // data_axis) * data_axis)
    return tuple(sorted(out))


def pick_bucket(n: int, ladder: Sequence[int]) -> Optional[int]:
    """Smallest bucket covering ``n`` rows, or None past the ladder."""
    for bucket in ladder:
        if bucket >= n:
            return bucket
    return None


def attention_per_context(source_strings, path_strings, target_strings,
                          attention_weights) -> Dict[Tuple[str, str, str],
                                                     float]:
    """Per-context attention dict, skipping padding contexts."""
    out: Dict[Tuple[str, str, str], float] = {}
    for source, path, target, weight in zip(
            source_strings, path_strings, target_strings,
            attention_weights):
        if not source and not path and not target:
            continue
        out[(str(source), str(path), str(target))] = float(weight)
    return out


def decode_results(fetched: Dict[str, np.ndarray], batch, n_rows: int,
                   decode_table: np.ndarray) -> list:
    """Host numpy outputs + the string-bearing batch -> one
    ``ModelPredictionResults`` per row; outputs the tier did not produce
    decode to empty/None."""
    from code2vec_tpu_torch.model_api import ModelPredictionResults
    topk_indices = fetched.get('topk_indices')
    topk_scores = fetched.get('topk_scores')
    attention = fetched.get('attention')
    code_vectors = fetched.get('code_vectors')
    results = []
    for r in range(n_rows):
        attn = {}
        if attention is not None and batch.source_strings is not None:
            attn = attention_per_context(
                batch.source_strings[r], batch.path_strings[r],
                batch.target_strings[r], attention[r])
        results.append(ModelPredictionResults(
            original_name=(str(batch.label_strings[r])
                           if batch.label_strings is not None else ''),
            topk_predicted_words=(list(decode_table[topk_indices[r]])
                                  if topk_indices is not None else []),
            topk_predicted_words_scores=(topk_scores[r]
                                         if topk_scores is not None
                                         else None),
            attention_per_context=attn,
            code_vector=(code_vectors[r]
                         if code_vectors is not None else None)))
    return results
