"""The predict step and its output tiers — the counterpart of the predict
programs of ``code2vec_tpu/training/trainer.py``.

    'topk'      — softmaxed top-k scores + indices only
    'attention' — topk + per-context attention weights (the REPL contract)
    'full'      — topk + attention + code vectors
    'vectors'   — code vectors only; the (B, V) logits product is skipped
"""
from __future__ import annotations

from typing import Dict

import torch

from code2vec_tpu_torch.ops.topk import top_k

PREDICT_TIERS = ('topk', 'attention', 'full', 'vectors')


@torch.no_grad()
def predict_step(backend, arrays, tier: str = 'full'
                 ) -> Dict[str, torch.Tensor]:
    """One batch on the backend's device -> the tier's outputs, still on
    that device. ``arrays`` is either wire, told apart by arity: 4 =
    packed ``(ctx, count, label, weight)``, 6 = planes ``(source, path,
    target, mask, label, weight)`` (``TorchBackend.encode_arrays``)."""
    if tier not in PREDICT_TIERS:
        raise ValueError('unknown predict tier %r (one of %s)'
                         % (tier, PREDICT_TIERS))
    code_vectors, attention = backend.encode_arrays(arrays)
    out = {}
    if tier != 'vectors':
        topk_scores, topk_indices = top_k(
            backend.logits(code_vectors),
            backend.config.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION)
        out['topk_indices'] = topk_indices
        # the reference normalizes the top-k scores with a softmax
        out['topk_scores'] = torch.softmax(topk_scores, dim=-1)
    if tier in ('attention', 'full'):
        out['attention'] = attention
    if tier in ('vectors', 'full'):
        out['code_vectors'] = code_vectors
    return out
