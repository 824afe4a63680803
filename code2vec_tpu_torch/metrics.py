"""Evaluation metrics — a copy of ``code2vec_tpu/metrics.py``. On a mesh
of ranks each rank counts its own data shard's examples, and
``count_vector`` / ``set_count_vector`` carry the raw counts through an
exact sum over the ranks (``model_api.py``'s ``evaluate``).

The device computes the top-k indices per batch; the host decodes the
words and updates these streaming counters.

- **Top-k accuracy**: an example scores a hit at ranks >= r, where r is
  the index of the first *legal* prediction whose normalized form equals
  the normalized original name; the rank counts only legal predictions.
- **Subtoken precision/recall/F1**: per example the FIRST legal
  prediction of the top-k and the original name are split on ``|`` into
  multisets of subtokens, which accumulate TP/FP/FN counts. An example
  with no legal prediction counts as an empty prediction.
"""
from __future__ import annotations

from collections import Counter
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from code2vec_tpu_torch import common


class SubtokensEvaluationMetric:
    """Streaming subtoken TP/FP/FN counts."""

    def __init__(self, oov_word: str):
        self.oov_word = oov_word
        self.nr_true_positives = 0
        self.nr_false_positives = 0
        self.nr_false_negatives = 0
        self.nr_predictions = 0

    def update_batch(self,
                     results: Iterable[Tuple[str, Sequence[str]]]) -> None:
        for original_name, top_words in results:
            legal = common.filter_impossible_names(self.oov_word, top_words)
            prediction = legal[0] if legal else ''
            original_subtokens = Counter(common.get_subtokens(original_name))
            predicted_subtokens = Counter(common.get_subtokens(prediction))
            self.nr_true_positives += sum(
                count for element, count in predicted_subtokens.items()
                if element in original_subtokens)
            self.nr_false_positives += sum(
                count for element, count in predicted_subtokens.items()
                if element not in original_subtokens)
            self.nr_false_negatives += sum(
                count for element, count in original_subtokens.items()
                if element not in predicted_subtokens)
            self.nr_predictions += 1

    def count_vector(self) -> np.ndarray:
        """The raw counts, for an exact merge over ranks (summed, then
        ``set_count_vector``)."""
        return np.array([self.nr_true_positives, self.nr_false_positives,
                         self.nr_false_negatives, self.nr_predictions],
                        dtype=np.int64)

    def set_count_vector(self, counts: np.ndarray) -> None:
        (self.nr_true_positives, self.nr_false_positives,
         self.nr_false_negatives, self.nr_predictions) = (
            int(c) for c in counts)

    @property
    def precision(self) -> float:
        denom = self.nr_true_positives + self.nr_false_positives
        return self.nr_true_positives / denom if denom else 0.0

    @property
    def recall(self) -> float:
        denom = self.nr_true_positives + self.nr_false_negatives
        return self.nr_true_positives / denom if denom else 0.0

    @property
    def f1(self) -> float:
        if self.precision + self.recall == 0:
            return 0.0
        return (2 * self.precision * self.recall
                / (self.precision + self.recall))


class TopKAccuracyEvaluationMetric:
    """Normalized first-match rank accuracy."""

    def __init__(self, top_k: int, oov_word: str):
        self.top_k = top_k
        self.oov_word = oov_word
        self.nr_correct_predictions = np.zeros(top_k)
        self.nr_predictions = 0

    def update_batch(self,
                     results: Iterable[Tuple[str, Sequence[str]]]) -> None:
        for original_name, top_predicted_words in results:
            self.nr_predictions += 1
            found_match = common.get_first_match_word_from_top_predictions(
                self.oov_word, original_name, top_predicted_words)
            if found_match is not None:
                suggestion_idx, _ = found_match
                self.nr_correct_predictions[suggestion_idx:self.top_k] += 1

    def count_vector(self) -> np.ndarray:
        """The raw counts, for an exact merge over ranks."""
        return np.concatenate([[self.nr_predictions],
                               self.nr_correct_predictions]).astype(np.int64)

    def set_count_vector(self, counts: np.ndarray) -> None:
        self.nr_predictions = int(counts[0])
        self.nr_correct_predictions = counts[1:].astype(np.float64)

    @property
    def topk_correct_predictions(self) -> np.ndarray:
        if self.nr_predictions == 0:
            return np.zeros(self.top_k)
        return self.nr_correct_predictions / self.nr_predictions


def decode_topk_batch(topk_indices: np.ndarray, index_to_word: np.ndarray,
                      label_strings: Sequence[str],
                      weights: np.ndarray) -> List[Tuple[str, List[str]]]:
    """(B, k) top-k indices + the label strings -> [(original_name, [top
    words...])] for the rows of weight > 0 (padding rows drop out)."""
    words = index_to_word[topk_indices]          # (B, k) object array
    return [(label_strings[r], list(words[r]))
            for r in range(topk_indices.shape[0]) if weights[r] > 0]
