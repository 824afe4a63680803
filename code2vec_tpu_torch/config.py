"""Configuration of the port's serving, training and evaluation slices.

The fields the slices read, with the names and defaults of the
reference ``code2vec_tpu/config.py`` so one set of values configures
both packages. Knobs of paths the port does not have yet (checkpoints,
the serving engine, the mesh, the token cache) and the training knobs it
leaves out (GRADS_DTYPE, LAZY_EMBEDDING_ADAM, EMBED_GRAD_IMPL,
REMAT_ENCODE; RAGGED_TRAIN_KERNEL, which only gates a TPU kernel: the
port's train path always goes through its kernels on the card) are not
here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


_DTYPES = {'bfloat16', 'float32'}


@dataclasses.dataclass
class Config:
    # ---- training schedule (reference config.py:22-35) ----
    NUM_TRAIN_EPOCHS: int = 20
    TRAIN_BATCH_SIZE: int = 1024
    TEST_BATCH_SIZE: int = 1024
    TOP_K_WORDS_CONSIDERED_DURING_PREDICTION: int = 10
    NUM_BATCHES_TO_LOG_PROGRESS: int = 100
    SHUFFLE_BUFFER_SIZE: int = 10000

    # ---- model hyper-params (reference config.py:39-49) ----
    MAX_CONTEXTS: int = 200
    MAX_TOKEN_VOCAB_SIZE: int = 1301136
    MAX_TARGET_VOCAB_SIZE: int = 261245
    MAX_PATH_VOCAB_SIZE: int = 911417
    TOKEN_EMBEDDINGS_SIZE: int = 128
    PATH_EMBEDDINGS_SIZE: int = 128
    CODE_VECTOR_SIZE: int = 384
    DROPOUT_KEEP_RATE: float = 0.75
    SEPARATE_OOV_AND_PAD: bool = False

    # 'bfloat16': gathered embeddings and both products in bf16 with fp32
    # accumulation; softmax and everything after it in fp32. 'float32'
    # matches the reference to fp32 rounding.
    COMPUTE_DTYPE: str = 'bfloat16'
    # tables are padded to a multiple of this many rows (same padded
    # shapes as the reference, so weights convert one to one)
    PARAM_ROW_ALIGNMENT: int = 128
    # Adam (the reference's tf.train.AdamOptimizer defaults: lr 1e-3,
    # b1 0.9, b2 0.999, eps 1e-8); the moments are STORED in these dtypes
    # and all moment math runs in fp32 (training/adam_dtypes.py)
    LEARNING_RATE: float = 0.001
    ADAM_MU_DTYPE: str = 'bfloat16'
    ADAM_NU_DTYPE: str = 'bfloat16'
    # the training cross-entropy through the streamed kernels (ops/ce.py):
    # no (B, target_vocab) logits in device memory in either direction.
    # False (the reference's default) materializes the logits.
    USE_PALLAS_FUSED_CE: bool = False
    # the batch wire: 'packed' ships each example's leading contexts
    # back to back (data/packed.py), 'planes' the dense (B, C) index
    # planes and mask. Training runs on the packed wire only.
    BATCH_WIRE_FORMAT: str = 'packed'
    # the dense forward of the plane wire (and of the packed wire with
    # the ragged fusion off) through the fused context-transform kernel
    # (ops/encode.py); False computes it in plain torch, as the
    # reference does outside its TPU kernel
    USE_PALLAS_FUSED_ENCODE: bool = False
    # the packed wire's forward and training straight off the packed
    # stream through the ragged kernels (ops/ragged.py); False unpacks
    # the stream to planes for the dense forward (predict and eval only)
    USE_PALLAS_RAGGED_FUSION: bool = True
    # predict pads each call to the smallest of these batch sizes
    SERVING_BATCH_BUCKETS: str = '8,64,512,1024'

    TRAIN_DATA_PATH_PREFIX: Optional[str] = None
    TEST_DATA_PATH: str = ''
    EXPORT_CODE_VECTORS: bool = False

    @property
    def is_testing(self) -> bool:
        return bool(self.TEST_DATA_PATH)

    def data_path(self, is_evaluating: bool = False) -> Optional[str]:
        return self.TEST_DATA_PATH if is_evaluating else self.train_data_path

    def batch_size(self, is_evaluating: bool = False) -> int:
        return (self.TEST_BATCH_SIZE if is_evaluating
                else self.TRAIN_BATCH_SIZE)

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

    @property
    def train_data_path(self) -> Optional[str]:
        if not self.TRAIN_DATA_PATH_PREFIX:
            return None
        return '{}.train.c2v'.format(self.TRAIN_DATA_PATH_PREFIX)

    def verify(self) -> None:
        for name in ('COMPUTE_DTYPE', 'ADAM_MU_DTYPE', 'ADAM_NU_DTYPE'):
            if getattr(self, name) not in _DTYPES:
                raise ValueError("config.%s must be in {'bfloat16', "
                                 "'float32'}, got %r"
                                 % (name, getattr(self, name)))
        for name in ('NUM_TRAIN_EPOCHS', 'TRAIN_BATCH_SIZE',
                     'TEST_BATCH_SIZE', 'SHUFFLE_BUFFER_SIZE',
                     'NUM_BATCHES_TO_LOG_PROGRESS'):
            if getattr(self, name) < 1:
                raise ValueError('config.%s must be >= 1, got %r'
                                 % (name, getattr(self, name)))
        if not 0.0 < self.DROPOUT_KEEP_RATE <= 1.0:
            raise ValueError('config.DROPOUT_KEEP_RATE must be in (0, 1], '
                             'got %r' % self.DROPOUT_KEEP_RATE)
        if not self.LEARNING_RATE > 0.0:
            raise ValueError('config.LEARNING_RATE must be > 0, got %r'
                             % self.LEARNING_RATE)
        if self.BATCH_WIRE_FORMAT not in {'planes', 'packed'}:
            raise ValueError("config.BATCH_WIRE_FORMAT must be in "
                             "{'planes', 'packed'}, got %r"
                             % (self.BATCH_WIRE_FORMAT,))
        if not self.TRAIN_DATA_PATH_PREFIX:
            raise ValueError('TRAIN_DATA_PATH_PREFIX must name the '
                             'dataset whose .dict.c2v holds the vocabularies')
        _ = self.serving_batch_buckets
