"""The interactive prediction shell and its reports (the port's copy of
``code2vec_tpu/serving/predict.py``): read a source file, extract its
methods' path contexts (``serving/extractor_bridge.py``), predict every
method in one batched ``model.predict`` call, and print a report per
method in the reference REPL's format ("Original name:", the predictions,
"Attention:" and the attended contexts, un-hashed).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

from code2vec_tpu_torch import common
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.serving.extractor_bridge import (Extractor,
                                                         infer_language)

SHOW_TOP_CONTEXTS = 10
DEFAULT_INPUT_FILENAME = Config.PREDICT_INPUT_PATH
QUIT_WORDS = frozenset({'exit', 'quit', 'q'})


def resolve_input_path(input_filename: str) -> str:
    """The file to predict over: ``input_filename`` when it exists; else
    its one sibling with another known source extension (``Input.cs``
    beside a missing ``Input.java``), whose extension then picks the
    extractor's frontend; else ``input_filename`` unchanged."""
    if os.path.exists(input_filename):
        return input_filename
    stem = os.path.splitext(input_filename)[0]
    candidates = [stem + ext for ext in ('.java', '.cs')
                  if infer_language(stem + ext) is not None
                  and os.path.exists(stem + ext)]
    if len(candidates) == 1:
        return candidates[0]
    return input_filename


def predict_contexts(model, context_lines, path_unhash,
                     topk: int = SHOW_TOP_CONTEXTS) -> List[Tuple[object, object]]:
    """Predict every method in one batched ``model.predict`` call.
    Returns ``[(method_result, raw_result), ...]``."""
    raw_results = model.predict(context_lines)
    parsed = common.parse_prediction_results(
        raw_results, path_unhash,
        model.vocabs.target_vocab.special_words.OOV, topk=topk)
    return list(zip(parsed, raw_results))


def predict_file(model, extractor: Extractor, source_path: str,
                 topk: int = SHOW_TOP_CONTEXTS) -> List[Tuple[object, object]]:
    """Extract ``source_path``'s path contexts, then ``predict_contexts``.
    Raises ``ValueError`` when the extractor finds no method."""
    context_lines, path_unhash = extractor.extract_paths(source_path)
    return predict_contexts(model, context_lines, path_unhash, topk)


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


class InteractivePredictor:
    """The shell: each turn reads PREDICT_INPUT_PATH (or
    ``input_filename``) anew and prints a report per method; "q",
    "quit" or "exit" ends it. An extraction error (a ``ValueError``:
    no method in the file, a crashed or unavailable extractor) is
    printed and the shell prompts again; an error of the model ends
    it."""

    def __init__(self, config: Config, model,
                 extractor: Optional[Extractor] = None,
                 input_filename: Optional[str] = None):
        self.config = config
        self.model = model
        self.path_extractor = extractor or Extractor(config)
        self.input_filename = input_filename or config.PREDICT_INPUT_PATH

    def predict(self) -> None:
        print('Starting interactive prediction...')
        prompt = (f'Modify the file: "{self.input_filename}" and press any '
                  'key when ready, or "q" / "quit" / "exit" to exit')
        while True:
            print(prompt)
            if input().lower() in QUIT_WORDS:
                print('Exiting...')
                return
            try:
                # resolved every turn: an Input.cs made mid-session
                # switches the shell to the C# frontend
                context_lines, path_unhash = \
                    self.path_extractor.extract_paths(
                        resolve_input_path(self.input_filename))
            except ValueError as e:
                print(e)
                continue
            reports = predict_contexts(self.model, context_lines,
                                       path_unhash)
            for method_result, raw_result in reports:
                vector = (raw_result.code_vector
                          if self.config.EXPORT_CODE_VECTORS else None)
                print(render_method_report(method_result, vector))
