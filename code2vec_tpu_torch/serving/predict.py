"""Prediction reports: one batched ``model.predict`` call over extracted
path contexts, and the per-method text report (the display contract of
the reference REPL, as in ``code2vec_tpu/serving/predict.py``)."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from code2vec_tpu_torch import common

SHOW_TOP_CONTEXTS = 10


def predict_contexts(model, context_lines, path_unhash,
                     topk: int = SHOW_TOP_CONTEXTS) -> List[Tuple[object, object]]:
    """Predict every method in one batched ``model.predict`` call.
    Returns ``[(method_result, raw_result), ...]``."""
    raw_results = model.predict(context_lines)
    parsed = common.parse_prediction_results(
        raw_results, path_unhash,
        model.vocabs.target_vocab.special_words.OOV, topk=topk)
    return list(zip(parsed, raw_results))


def render_method_report(method_result,
                         code_vector: Optional[Sequence[float]] = None) -> str:
    """Pure text rendering of one method's prediction."""
    lines = [f'Original name:\t{method_result.original_name}']
    lines.extend(
        f"\t({candidate['probability']:f}) predicted: {candidate['name']}"
        for candidate in method_result.predictions)
    lines.append('Attention:')
    lines.extend(
        f"{ctx['score']:f}\tcontext: {ctx['token1']},{ctx['path']},{ctx['token2']}"
        for ctx in method_result.attention_paths)
    if code_vector is not None:
        lines.append('Code vector:')
        lines.append(' '.join(map(str, code_vector)))
    return '\n'.join(lines)
