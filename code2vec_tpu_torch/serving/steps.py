"""The predict step and its output tiers — the counterpart of the predict
programs of ``code2vec_tpu/training/trainer.py``.

    'topk'      — softmaxed top-k scores + indices only
    'attention' — topk + per-context attention weights (the REPL contract)
    'full'      — topk + attention + code vectors
    'vectors'   — code vectors only; the (B, V) logits product is skipped
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from code2vec_tpu_torch.models.functional import Code2VecParams
from code2vec_tpu_torch.ops.topk import sharded_top_k

PREDICT_TIERS = ('topk', 'attention', 'full', 'vectors')


@torch.no_grad()
def predict_step(backend, arrays, tier: str = 'full',
                 params: Optional[Code2VecParams] = None
                 ) -> Dict[str, torch.Tensor]:
    """One batch on the backend's device -> the tier's outputs, still on
    that device. ``arrays`` is either wire, told apart by arity: 4 =
    packed ``(ctx, count, label, weight)``, 6 = planes ``(source, path,
    target, mask, label, weight)`` (``TorchBackend.encode_arrays``).

    ``params`` is the compute-dtype parameter set to read, as the
    reference's ``Trainer.predict_step_placed(params, arrays, tier)``
    takes it: the serving engine passes its parameter slots, whose
    addresses its CUDA graphs keep (``serving/graphs.py``). None reads
    ``backend.compute_params``. The step makes no host sync, so it can
    be captured. On a backend's mesh of ranks (predict and the bulk feed)
    ``arrays`` is this rank's data shard, and every rank of the mesh
    runs the step."""
    if tier not in PREDICT_TIERS:
        raise ValueError('unknown predict tier %r (one of %s)'
                         % (tier, PREDICT_TIERS))
    code_vectors, attention = backend.encode_arrays(arrays, params=params)
    out = {}
    if tier != 'vectors':
        # on a mesh the logits are this rank's target columns: the top k
        # merged over the model axis, equal on every rank of the data row
        topk_scores, topk_indices = sharded_top_k(
            backend.logits(code_vectors, params=params),
            backend.config.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION,
            backend.mesh)
        out['topk_indices'] = topk_indices
        # the reference normalizes the top-k scores with a softmax
        out['topk_scores'] = torch.softmax(topk_scores, dim=-1)
    if tier in ('attention', 'full'):
        out['attention'] = attention
    if tier in ('vectors', 'full'):
        out['code_vectors'] = code_vectors
    return out
