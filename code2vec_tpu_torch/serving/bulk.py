"""Corpus-scale offline embedding: a whole ``.c2v`` file through the
'vectors' tier in TEST_BATCH_SIZE batches — the counterpart of
``export_code_vectors`` in ``code2vec_tpu/serving/bulk.py``.

The vectors tier skips the (B, V) logits product and top-k, so the
export pays for the encoder only. Batch k + 1 is on the device while the
host writes batch k, as in ``Code2VecModel.evaluate``.
"""
from __future__ import annotations

import logging
import time
from typing import Optional, Tuple

import numpy as np
import torch

from code2vec_tpu_torch.data.reader import PathContextReader
from code2vec_tpu_torch.serving.steps import predict_step
from code2vec_tpu_torch.telemetry import core as tele_core

logger = logging.getLogger(__name__)


def export_code_vectors(model, corpus_path: str,
                        output_path: Optional[str] = None,
                        dtype: Optional[str] = None) -> Tuple[int, str]:
    """Embed every example of ``corpus_path`` with at least one valid
    context into ``output_path`` (default ``<corpus>.vectors``): one
    space-separated code vector per line, in corpus order, narrowed to
    ``dtype`` (default ``VECTORS_DTYPE``; 'float16' keeps fewer digits).
    Returns ``(n_vectors, output_path)``."""
    config = model.config
    out_path = output_path if output_path is not None \
        else corpus_path + '.vectors'
    out_dtype = np.dtype(dtype or config.VECTORS_DTYPE)
    # a reader of its own: the corpus's sticky packed capacity
    reader = PathContextReader(model.vocabs, config)
    total = 0
    t0 = time.perf_counter()
    with open(out_path, 'w') as out_file:

        def write(out, batch) -> int:
            vectors = out['code_vectors'].float().cpu().numpy()
            kept = vectors[batch.weight > 0].astype(out_dtype)
            for vec in kept:
                out_file.write(' '.join(map(str, vec)) + '\n')
            return kept.shape[0]

        pending = None
        for batch in reader.iter_epoch(evaluate=True, data_path=corpus_path):
            arrays = tuple(torch.from_numpy(a).to(model.device)
                           for a in batch.device_arrays())
            out = predict_step(model.backend, arrays, tier='vectors')
            if pending is not None:
                total += write(*pending)
            pending = (out, batch)
        if pending is not None:
            total += write(*pending)
    rate = total / max(time.perf_counter() - t0, 1e-9)
    if tele_core.enabled():
        tele_core.registry().gauge('serving/bulk_examples_per_sec').set(rate)
    logger.info('Exported %d code vectors (%s) to `%s` (%d examples/sec).',
                total, out_dtype.name, out_path, int(rate))
    return total, out_path
