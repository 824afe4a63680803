"""Host-side helpers for decoding predictions (a copy of the part of
``code2vec_tpu/common.py`` the serving slice uses)."""
from __future__ import annotations

from collections import OrderedDict
from typing import Iterable, List


def get_subtokens(word: str) -> List[str]:
    """Subtokens are joined by ``|`` by the extractor."""
    return word.split('|')


def get_unique_list(items: Iterable) -> list:
    return list(OrderedDict((item, 0) for item in items).keys())


class MethodPredictionResults:
    """Pretty-printable per-method prediction bundle for the REPL."""

    def __init__(self, original_name: str):
        self.original_name = original_name
        self.predictions: List[dict] = []
        self.attention_paths: List[dict] = []

    def append_prediction(self, name: List[str], probability: float) -> None:
        self.predictions.append({'name': name, 'probability': probability})

    def append_attention_path(self, attention_score: float, token1: str,
                              path: str, token2: str) -> None:
        self.attention_paths.append({'score': attention_score, 'path': path,
                                     'token1': token1, 'token2': token2})


def parse_prediction_results(raw_prediction_results, unhash_dict,
                             oov_word: str, topk: int = 5
                             ) -> List[MethodPredictionResults]:
    """Raw model predictions -> display-ready results: drop OOV, split
    subtokens, un-hash the top-k attended paths."""
    results = []
    for raw in raw_prediction_results:
        method_result = MethodPredictionResults(raw.original_name)
        for i, predicted in enumerate(raw.topk_predicted_words):
            if predicted == oov_word:
                continue
            method_result.append_prediction(
                get_subtokens(predicted),
                float(raw.topk_predicted_words_scores[i]))
        sorted_contexts = sorted(raw.attention_per_context.items(),
                                 key=lambda kv: kv[1], reverse=True)[:topk]
        for (token1, hashed_path, token2), attention in sorted_contexts:
            if hashed_path in unhash_dict:
                method_result.append_attention_path(
                    float(attention), token1=token1,
                    path=unhash_dict[hashed_path], token2=token2)
        results.append(method_result)
    return results
