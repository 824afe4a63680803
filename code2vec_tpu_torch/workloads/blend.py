"""Retrieval-augmented naming: the blend math (the port of
``code2vec_tpu/workloads/blend.py``, pure numpy).

``ServingMesh.submit_blended`` fetches the attached index's top-k
neighbor labels and mixes their similarity votes with the softmax head's
top-k distribution; the math lives here so it is testable without a
mesh or a model, and so ``serving/mesh.py`` imports it without a cycle
(this module never imports the serving package).

- the softmax head's ``topk_predicted_words_scores`` are already a
  distribution over its top-k candidates (the softmax of the top-k
  logits) and are used as they are;
- neighbor similarity scores become votes through a stable softmax over
  the returned neighbors, summed per label (a label retrieved twice
  votes twice);
- a candidate label scores ``(1 - weight) * softmax_p + weight *
  neighbor_vote``; the candidates are the union of both sources, ranked
  descending, ties broken by softmax rank, then by label, so runs agree
  bit for bit;
- ``weight=0`` never reaches this module: the mesh serves the plain
  submit path and wraps its untouched result.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

__all__ = ['BlendResult', 'blend_row', 'neighbor_votes',
           'SOURCE_BLEND', 'SOURCE_SOFTMAX', 'SOURCE_FALLBACK']

#: BlendResult.source: a real blend, the weight <= 0 passthrough, and the
#: typed no-index fallback (softmax only: there was nothing to retrieve)
SOURCE_BLEND = 'blend'
SOURCE_SOFTMAX = 'softmax'
SOURCE_FALLBACK = 'softmax_fallback'


class BlendResult(NamedTuple):
    """One blended prediction row. ``base`` is the untouched softmax
    ``ModelPredictionResults`` row; ``predicted_words`` and
    ``predicted_scores`` are the blended ranking. The memo caches it:
    ``memo.copy_results`` rebuilds NamedTuples, nested rows included."""
    original_name: str
    predicted_words: List[str]
    predicted_scores: np.ndarray
    source: str
    weight: float
    base: object              # ModelPredictionResults
    neighbors: object = None  # NeighborResult | None


def neighbor_votes(labels: Sequence[str],
                   scores: Sequence[float]) -> dict:
    """label -> vote mass: a stable softmax over the neighbors'
    similarity scores, summed per label. No neighbors vote for nothing
    (the blend is then the scaled softmax)."""
    if len(labels) == 0:
        return {}
    arr = np.asarray(scores, dtype=np.float64)
    with np.errstate(invalid='ignore'):  # all -inf -> NaN -> uniform
        arr = np.exp(arr - arr.max())
    total = float(arr.sum())
    if total <= 0 or not np.isfinite(total):
        # degenerate scores (all -inf, NaN): uniform votes keep the blend
        # defined instead of carrying NaN into the ranking
        arr = np.ones_like(arr)
        total = float(arr.sum())
    votes: dict = {}
    for label, mass in zip(labels, arr / total):
        votes[str(label)] = votes.get(str(label), 0.0) + float(mass)
    return votes


def blend_row(base, neighbors, weight: float,
              top_k: Optional[int] = None) -> BlendResult:
    """Blend one softmax prediction row (``ModelPredictionResults``) with
    one neighbor row (``NeighborResult``: ``.labels``, ``.scores``; None
    is the typed fallback). ``top_k`` bounds the blended candidates (by
    default the base row's k)."""
    words = list(base.topk_predicted_words)
    base_scores = (np.asarray(base.topk_predicted_words_scores,
                              dtype=np.float64)
                   if base.topk_predicted_words_scores is not None
                   else np.zeros(len(words)))
    if neighbors is None:
        return BlendResult(
            original_name=base.original_name, predicted_words=words,
            predicted_scores=base_scores.astype(np.float32),
            source=SOURCE_FALLBACK, weight=float(weight), base=base,
            neighbors=None)
    votes = neighbor_votes(list(neighbors.labels),
                           list(np.asarray(neighbors.scores).ravel()))
    weight = float(min(1.0, max(0.0, weight)))
    #: softmax rank for the tie break; labels softmax did not rank go last
    base_rank = {word: rank for rank, word in enumerate(words)}
    candidates = list(dict.fromkeys(words + sorted(votes)))
    blended: List[Tuple[float, int, str]] = []
    for label in candidates:
        rank = base_rank.get(label, len(words))
        p = float(base_scores[rank]) if rank < len(words) else 0.0
        score = (1.0 - weight) * p + weight * votes.get(label, 0.0)
        blended.append((-score, rank, label))
    blended.sort()
    k = top_k if top_k is not None else len(words)
    top = blended[:max(1, k)] if blended else []
    return BlendResult(
        original_name=base.original_name,
        predicted_words=[label for _neg, _rank, label in top],
        predicted_scores=np.asarray(
            [-neg for neg, _rank, _label in top], dtype=np.float32),
        source=SOURCE_BLEND, weight=weight, base=base,
        neighbors=neighbors)
