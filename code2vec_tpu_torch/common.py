"""Host-side helpers for decoding predictions, scoring them, writing
word2vec text and un-hashing extracted paths (a copy of the part of
``code2vec_tpu/common.py`` the port uses)."""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

_NON_ALPHA_RE = re.compile(r'[^a-zA-Z]')
_LEGAL_NAME_RE = re.compile(r'^[a-zA-Z|]+$')


def normalize_word(word: str) -> str:
    """Strip non-alphabetic chars and lowercase; fall back to plain
    lowercase for fully non-alpha words."""
    stripped = _NON_ALPHA_RE.sub('', word)
    if not stripped:
        return word.lower()
    return stripped.lower()


def truncate_histogram_to_max_size(word_to_count: Dict[str, int],
                                   max_size: int) -> Dict[str, int]:
    """Keep the words counted at least one more than the ``max_size``-th
    most frequent (the reference's histogram cutoff)."""
    if len(word_to_count) <= max_size:
        return dict(word_to_count)
    cutoff = sorted(word_to_count.values(), reverse=True)[max_size] + 1
    return {w: c for w, c in word_to_count.items() if c >= cutoff}


def load_histogram(path: str, min_count: int = 0,
                   max_size: Optional[int] = None) -> Dict[str, int]:
    """A ``word count`` histogram file as a dict, cut to ``max_size``
    words by ``truncate_histogram_to_max_size``."""
    word_to_count: Dict[str, int] = {}
    with open(path, 'r') as file:
        for line in file:
            parts = line.rstrip().split(' ')
            if len(parts) != 2:
                continue
            word, count_str = parts
            count = int(count_str)
            if count < min_count or word in word_to_count:
                continue
            word_to_count[word] = count
    if max_size is not None:
        word_to_count = truncate_histogram_to_max_size(word_to_count,
                                                       max_size)
    return word_to_count


def get_subtokens(word: str) -> List[str]:
    """Subtokens are joined by ``|`` by the extractor."""
    return word.split('|')


def get_unique_list(items: Iterable) -> list:
    return list(OrderedDict((item, 0) for item in items).keys())


def legal_method_name(oov_word: str, name: str) -> bool:
    """A prediction is legal iff it is not OOV and holds only letters and
    ``|`` separators."""
    return name != oov_word and bool(_LEGAL_NAME_RE.match(name))


def filter_impossible_names(oov_word: str,
                            top_words: Iterable[str]) -> List[str]:
    return [word for word in top_words if legal_method_name(oov_word, word)]


def get_first_match_word_from_top_predictions(
        oov_word: str, original_name: str,
        top_predicted_words: Iterable[str]) -> Optional[Tuple[int, str]]:
    """Rank (within the legal predictions) of the first prediction
    matching the normalized original name, and that prediction."""
    normalized_original = normalize_word(original_name)
    for idx, predicted in enumerate(
            filter_impossible_names(oov_word, top_predicted_words)):
        if normalized_original == normalize_word(predicted):
            return idx, predicted
    return None


def save_word2vec_file(output_file, index_to_word: Dict[int, str],
                       embedding_matrix: np.ndarray) -> None:
    """Textual word2vec format: header line then ``word v0 v1 ...`` rows
    (the reference's text, byte for byte, from the same matrix)."""
    assert embedding_matrix.ndim == 2
    vocab_size, dim = embedding_matrix.shape
    output_file.write('%d %d\n' % (vocab_size, dim))
    for word_idx in range(vocab_size):
        assert word_idx in index_to_word
        output_file.write(index_to_word[word_idx] + ' ')
        output_file.write(' '.join(map(str, embedding_matrix[word_idx])) + '\n')


def java_string_hashcode(s: str) -> int:
    """Java's ``String#hashCode``: the extractor's hashed paths are
    un-hashed for display by hashing the path strings the same way."""
    h = 0
    for ch in s:
        h = (31 * h + ord(ch)) & 0xFFFFFFFF
    if h > 0x7FFFFFFF:
        h -= 0x100000000
    return h


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
