"""Configuration of the port's serving slice.

The fields the slice reads, with the names and defaults of the
reference ``code2vec_tpu/config.py`` so one set of values configures
both packages. Knobs of paths the port does not have yet (training,
checkpoints, the serving engine, the mesh) are left out.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class Config:
    TOP_K_WORDS_CONSIDERED_DURING_PREDICTION: int = 10

    # ---- model hyper-params (reference config.py:39-49) ----
    MAX_CONTEXTS: int = 200
    MAX_TOKEN_VOCAB_SIZE: int = 1301136
    MAX_TARGET_VOCAB_SIZE: int = 261245
    MAX_PATH_VOCAB_SIZE: int = 911417
    TOKEN_EMBEDDINGS_SIZE: int = 128
    PATH_EMBEDDINGS_SIZE: int = 128
    CODE_VECTOR_SIZE: int = 384
    SEPARATE_OOV_AND_PAD: bool = False

    # 'bfloat16': gathered embeddings and both products in bf16 with fp32
    # accumulation; softmax and everything after it in fp32. 'float32'
    # matches the reference to fp32 rounding.
    COMPUTE_DTYPE: str = 'bfloat16'
    # tables are padded to a multiple of this many rows (same padded
    # shapes as the reference, so weights convert one to one)
    PARAM_ROW_ALIGNMENT: int = 128
    # predict pads each call to the smallest of these batch sizes
    SERVING_BATCH_BUCKETS: str = '8,64,512,1024'

    TRAIN_DATA_PATH_PREFIX: Optional[str] = None
    EXPORT_CODE_VECTORS: bool = False

    @property
    def word_freq_dict_path(self) -> Optional[str]:
        if not self.TRAIN_DATA_PATH_PREFIX:
            return None
        return '{}.dict.c2v'.format(self.TRAIN_DATA_PATH_PREFIX)

    @property
    def serving_batch_buckets(self) -> Tuple[int, ...]:
        try:
            buckets = tuple(sorted(
                int(part) for part in
                str(self.SERVING_BATCH_BUCKETS).split(',') if part.strip()))
        except ValueError:
            raise ValueError(
                'SERVING_BATCH_BUCKETS must be comma-separated ints, got '
                '%r' % self.SERVING_BATCH_BUCKETS)
        if not buckets or any(bucket < 1 for bucket in buckets):
            raise ValueError(
                'SERVING_BATCH_BUCKETS needs at least one bucket >= 1, '
                'got %r' % self.SERVING_BATCH_BUCKETS)
        return buckets

    def verify(self) -> None:
        if self.COMPUTE_DTYPE not in {'bfloat16', 'float32'}:
            raise ValueError("config.COMPUTE_DTYPE must be in "
                             "{'bfloat16', 'float32'}, got %r"
                             % self.COMPUTE_DTYPE)
        if not self.TRAIN_DATA_PATH_PREFIX:
            raise ValueError('TRAIN_DATA_PATH_PREFIX must name the '
                             'dataset whose .dict.c2v holds the vocabularies')
        _ = self.serving_batch_buckets
