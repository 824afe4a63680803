"""Configuration of the port: serving, training, evaluation, checkpoints
and the CLI.

The fields the port reads, with the names and defaults of the reference
``code2vec_tpu/config.py`` so one set of values configures both
packages, and ``load_from_args`` over the subset of the reference's
flags that the port serves (``cli.py``). The serving engine's knobs
(``serving/engine.py``: the micro-batcher, admission control and the
canaried rollover) are here with the reference's defaults and rules.
Knobs of paths the port does not have yet (the index, the mesh,
telemetry and tracing, step snapshots and the other resilience knobs,
FAULT_INJECT among them: the port's drills arm ``resilience/faults.py``
directly) and RAGGED_TRAIN_KERNEL, which
only gates a TPU kernel (the port's train path always goes through its
kernels on the card), are not here; their flags are argparse errors.
The optimizer and table-gradient knobs (LAZY_EMBEDDING_ADAM, GRADS_DTYPE,
EMBED_GRAD_IMPL, REMAT_ENCODE) are, with the reference's defaults and
``verify`` rules. DONATE_STAGED_BATCHES is XLA's
buffer donation and has no counterpart: the staging ring's buffers go
back to the caching allocator when the step that read them is done
(``training/trainer.py::Trainer.stage_batches``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Tuple


_DTYPES = {'bfloat16', 'float32'}


@dataclasses.dataclass
class Config:
    # ---- training schedule (reference config.py:22-36) ----
    NUM_TRAIN_EPOCHS: int = 20
    SAVE_EVERY_EPOCHS: int = 1
    TRAIN_BATCH_SIZE: int = 1024
    TEST_BATCH_SIZE: int = 1024
    TOP_K_WORDS_CONSIDERED_DURING_PREDICTION: int = 10
    NUM_BATCHES_TO_LOG_PROGRESS: int = 100
    # mid-epoch evaluation every this many train steps (0: only after
    # each epoch), when TEST_DATA_PATH is set
    NUM_TRAIN_BATCHES_TO_EVALUATE: int = 1800
    SHUFFLE_BUFFER_SIZE: int = 10000
    # ---- host input pipeline (reference config.py:33, 192-221) ----
    # tokenizer threads of the native reader (data/native.py)
    READER_NUM_PARALLEL_BATCHES: int = 6
    # batches a background thread reads ahead of the consumer
    # (data/reader.py::prefetch_iterator)
    READER_PREFETCH_BATCHES: int = 8
    # batches staged on the card ahead of the step consuming them, in
    # pinned host buffers copied on a side stream (0: copy, then step)
    DEVICE_PREFETCH_BATCHES: int = 2
    # the C++ tokenizer (native/tokenizer.cpp, built with g++ at first
    # use) for train, evaluate and the serving engine's topk and vectors
    # tiers; a failed build raises. False is the one way to get the
    # Python tokenizer. Predict and the engine's attention and full tiers
    # keep the Python path (it keeps every context's strings).
    READER_USE_NATIVE: bool = True
    # tokenize the train split once into <data>.train.c2v.tokcache/
    # (data/cache.py) and read every later epoch from it
    TRAIN_DATA_CACHE: bool = True
    # retained full-state checkpoints under <MODEL_SAVE_PATH>__entire-model
    MAX_TO_KEEP: int = 10

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
    # lazy (sparse-row) Adam for the token and path tables: moments decay
    # and rows move only where a batch touches them (ops/lazy_adam.py, a
    # semantics trade-off, not the reference's dense Adam); the dense
    # parameters keep Adam with fp32 moments, and the moments' dtype knobs
    # above do not apply (the trainer warns)
    LAZY_EMBEDDING_ADAM: bool = False
    # dtype the gradients come back in: 'bfloat16' differentiates with
    # respect to bf16 copies of the fp32 masters (needs bf16 compute, where
    # the forward is unchanged); the fused Adam upcasts them
    GRADS_DTYPE: str = 'float32'
    # the token/path table gradients' strategy (ops/embed_grad.py):
    # 'dense', 'sorted' or 'dedup'
    EMBED_GRAD_IMPL: str = 'dense'
    # recompute the ragged encode in the backward
    # (torch.utils.checkpoint); the encode saves no per-slot tensor
    # already, so the numbers stay equal
    REMAT_ENCODE: bool = False
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
    # predict pads each call to the smallest of these batch sizes; the
    # serving engine's ladder of CUDA graphs has one rung per bucket
    SERVING_BATCH_BUCKETS: str = '8,64,512,1024'
    # ---- serving engine (reference config.py:377-423) ----
    # how long the dispatcher may hold the oldest queued request while
    # coalescing followers into one bucket (0: dispatch at once)
    SERVING_MAX_DELAY_MS: float = 5.0
    # host decode threads (waiting for a batch's copy to the host, top-k
    # word lookup, attention parsing)
    SERVING_DECODE_WORKERS: int = 2
    # output tiers warmed (captured) at engine load, a comma-separated
    # subset of {topk, attention, full, vectors}
    SERVING_WARM_TIERS: str = 'topk,attention,full'
    # default per-request SLO deadline (0: none): shed at admission when
    # the drain estimate exceeds it, expired if still queued past it
    SERVING_DEADLINE_MS: float = 0.0
    # admission bound in rows queued across the tiers (0: 8x the top
    # bucket, -1: unbounded)
    SERVING_QUEUE_BOUND: int = 0
    # canaried rollover: live batches shadow-scored against both
    # parameter sets before the swap (0: swap at once), the top-1
    # agreement the swap needs, and the seconds after which an armed
    # canary that has not concluded rolls back (0: never)
    SERVING_CANARY_BATCHES: int = 8
    SERVING_CANARY_AGREEMENT: float = 0.9
    SERVING_CANARY_TIMEOUT_SECS: float = 300.0
    # poll the model's checkpoints every this many seconds and roll newer
    # steps in through the canary (--serve-follow-checkpoints; 0: off)
    SERVE_FOLLOW_CHECKPOINTS_SECS: float = 0.0
    # ---- extractor bridge (reference config.py:574-592) ----
    # per-invocation timeout of the extractor (0: none)
    EXTRACTOR_TIMEOUT_SECS: float = 30.0
    # ExtractorPool's retries of a crashed call, with exponential backoff
    EXTRACTOR_RETRIES: int = 2
    EXTRACTOR_BACKOFF_SECS: float = 0.1
    EXTRACTOR_POOL_WORKERS: int = 2
    # consecutive crashed calls that open the circuit breaker, and how
    # long it stays open before a half-open probe
    EXTRACTOR_BREAKER_THRESHOLD: int = 3
    EXTRACTOR_BREAKER_COOLDOWN_SECS: float = 30.0

    # the interactive prediction shell (--predict) and the source file it
    # reads every turn (.java or .cs)
    PREDICT: bool = False
    PREDICT_INPUT_PATH: str = 'Input.java'
    MODEL_SAVE_PATH: Optional[str] = None
    MODEL_LOAD_PATH: Optional[str] = None
    TRAIN_DATA_PATH_PREFIX: Optional[str] = None
    TEST_DATA_PATH: str = ''
    RELEASE: bool = False
    EXPORT_CODE_VECTORS: bool = False
    # offline corpus embedding (serving/bulk.py): this .c2v file through
    # the 'vectors' tier into <file>.vectors, narrowed to VECTORS_DTYPE
    BULK_VECTORS_PATH: Optional[str] = None
    VECTORS_DTYPE: str = 'float32'
    # word2vec text exports of the token / target tables, and of both as
    # <prefix>.tokens.txt + <prefix>.targets.txt
    SAVE_W2V: Optional[str] = None
    SAVE_T2V: Optional[str] = None
    EXPORT_VOCAB_VECTORS: Optional[str] = None
    VERBOSE_MODE: int = 1
    # where the model's entry points run: 'cuda' (the card) or 'cpu' (the
    # kernels' plain versions); the port's counterpart of JAX_PLATFORMS
    DEVICE: str = 'cuda'

    # ------------------------------------------------------------------ CLI
    # flags of the reference that name a path the port does not have yet:
    # each is an argparse error saying so (every other flag the reference
    # has and the port lacks is an "unrecognized arguments" error)
    NOT_PORTED_FLAGS = {
        '--build-index': 'the embedding index (ROADMAP A8)',
        '--query-neighbors': 'the embedding index (ROADMAP A8)',
        '--memory-report': 'device telemetry (ROADMAP A10)',
    }

    @classmethod
    def arguments_parser(cls) -> argparse.ArgumentParser:
        """The reference's flags (config.py:686-1031) that the port
        serves, with their names and meanings, plus ``--device``."""
        parser = argparse.ArgumentParser(prog='code2vec_tpu_torch',
                                         allow_abbrev=False)
        parser.add_argument('-d', '--data', dest='data_path',
                            help='path prefix of the preprocessed dataset')
        parser.add_argument('-te', '--test', dest='test_path',
                            metavar='FILE', default='',
                            help='path to the test/validation .c2v file')
        parser.add_argument('-s', '--save', dest='save_path', metavar='FILE',
                            help='path to save the model to')
        parser.add_argument('-w2v', '--save_word2v', dest='save_w2v',
                            metavar='FILE',
                            help='save token embeddings in word2vec format')
        parser.add_argument('-t2v', '--save_target2v', dest='save_t2v',
                            metavar='FILE',
                            help='save target embeddings in word2vec format')
        parser.add_argument('-l', '--load', dest='load_path', metavar='FILE',
                            help='path to load the model from')
        parser.add_argument('--export_code_vectors', action='store_true',
                            help='export code vectors for the given examples')
        parser.add_argument('--release', action='store_true',
                            help='strip optimizer state from a loaded model '
                                 'for a smaller artifact')
        parser.add_argument('--predict', action='store_true',
                            help='run the interactive prediction shell')
        parser.add_argument('--input-file', dest='predict_input_path',
                            default=None, metavar='PATH',
                            help='source file the prediction shell reads '
                                 '(.java or .cs; default Input.java)')
        parser.add_argument('--extractor-timeout',
                            dest='extractor_timeout_secs', type=float,
                            default=None, metavar='SECS',
                            help='per-invocation extractor timeout (0 '
                                 'disables)')
        parser.add_argument('-v', '--verbose', dest='verbose_mode', type=int,
                            default=1, help='verbosity in {0,1,2}')
        parser.add_argument('--dtype', dest='compute_dtype',
                            choices=sorted(_DTYPES),
                            help='compute dtype of the forward and backward')
        parser.add_argument('--batch-size', dest='batch_size', type=int,
                            help='override TRAIN_BATCH_SIZE and '
                                 'TEST_BATCH_SIZE')
        parser.add_argument('--epochs', dest='epochs', type=int,
                            help='override NUM_TRAIN_EPOCHS')
        parser.add_argument('--no-data-cache', dest='no_data_cache',
                            action='store_true',
                            help='disable the binary token cache for the '
                                 'train split')
        parser.add_argument('--device-prefetch', dest='device_prefetch',
                            type=int, default=None, metavar='N',
                            help='staging-ring depth: batches placed on '
                                 'the card ahead of the consuming step '
                                 '(DEVICE_PREFETCH_BATCHES; 0 disables)')
        parser.add_argument('--adam-mu-dtype', dest='adam_mu_dtype',
                            choices=sorted(_DTYPES),
                            help='storage dtype of Adam\'s first moment')
        parser.add_argument('--adam-nu-dtype', dest='adam_nu_dtype',
                            choices=sorted(_DTYPES),
                            help='storage dtype of Adam\'s second moment')
        parser.add_argument('--grads-dtype', dest='grads_dtype',
                            choices=['float32', 'bfloat16'], default=None,
                            help='dtype the gradients come back in '
                                 '(GRADS_DTYPE; bfloat16 needs bf16 '
                                 'compute)')
        parser.add_argument('--embed-grad', dest='embed_grad_impl',
                            choices=['dense', 'sorted', 'dedup'],
                            default=None,
                            help='token/path table gradient strategy '
                                 '(EMBED_GRAD_IMPL, ops/embed_grad.py)')
        parser.add_argument('--remat-encode', dest='remat_encode',
                            action='store_true',
                            help='recompute the encode in the backward '
                                 '(REMAT_ENCODE)')
        parser.add_argument('--fused-ce', dest='fused_ce',
                            action='store_true',
                            help='the training cross-entropy through the '
                                 'streamed kernels (USE_PALLAS_FUSED_CE)')
        parser.add_argument('--no-ragged-fusion', dest='no_ragged_fusion',
                            action='store_true',
                            help='unpack the packed wire to planes for the '
                                 'dense forward (predict and eval only)')
        parser.add_argument('--wire-format', dest='wire_format',
                            choices=['packed', 'planes'],
                            help='the batch wire (BATCH_WIRE_FORMAT)')
        parser.add_argument('--bulk-vectors', dest='bulk_vectors',
                            metavar='FILE.c2v',
                            help='stream a .c2v corpus through the vectors '
                                 'tier and write FILE.c2v.vectors')
        parser.add_argument('--vectors-dtype', dest='vectors_dtype',
                            choices=['float32', 'float16'],
                            help='dtype of exported code vectors')
        parser.add_argument('--export_vocab_vectors',
                            dest='export_vocab_vectors', metavar='PREFIX',
                            help='write both vocab embedding tables in '
                                 'word2vec text format: PREFIX.tokens.txt '
                                 '+ PREFIX.targets.txt')
        parser.add_argument('--serving-buckets', dest='serving_buckets',
                            default=None, metavar='B1,B2,...',
                            help='batch buckets of the serving engine\'s '
                                 'warm ladder (SERVING_BATCH_BUCKETS)')
        parser.add_argument('--serving-max-delay-ms',
                            dest='serving_max_delay_ms', type=float,
                            default=None, metavar='MS',
                            help='micro-batcher coalescing deadline: max '
                                 'added latency while batching concurrent '
                                 'requests (0 = dispatch immediately)')
        parser.add_argument('--serving-deadline-ms',
                            dest='serving_deadline_ms', type=float,
                            default=None, metavar='MS',
                            help='default per-request SLO deadline: '
                                 'requests are shed at admission when '
                                 'the queue cannot drain in time, and '
                                 'expired instead of dispatched once '
                                 'past it (0 = none)')
        parser.add_argument('--serving-queue-bound',
                            dest='serving_queue_bound', type=int,
                            default=None, metavar='ROWS',
                            help='admission-controlled front-queue '
                                 'bound in rows; excess submissions '
                                 'are shed with a typed error (0 = '
                                 'auto, -1 = unbounded)')
        parser.add_argument('--serve-follow-checkpoints',
                            dest='serve_follow_checkpoints', type=float,
                            default=None, metavar='SECS',
                            help='poll the checkpoint store every SECS '
                                 'for newer steps and roll them into '
                                 'the live serving engine through the '
                                 'canary')
        parser.add_argument('--device', dest='device',
                            choices=['cuda', 'cpu'], default='cuda',
                            help="where to run: 'cuda' (default) or 'cpu' "
                                 '(the kernels\' plain versions)')

        class NotPorted(argparse.Action):
            def __call__(self, parser, namespace, values, option_string=None):
                parser.error('%s is not ported yet: %s'
                             % (option_string,
                                cls.NOT_PORTED_FLAGS[option_string]))

        for flag in cls.NOT_PORTED_FLAGS:
            parser.add_argument(flag, action=NotPorted, nargs='?',
                                help=argparse.SUPPRESS)
        return parser

    def load_from_args(self, args=None) -> 'Config':
        parsed = self.arguments_parser().parse_args(args)
        self.PREDICT = parsed.predict
        if parsed.predict_input_path:
            self.PREDICT_INPUT_PATH = parsed.predict_input_path
        if parsed.extractor_timeout_secs is not None:
            self.EXTRACTOR_TIMEOUT_SECS = parsed.extractor_timeout_secs
        if parsed.no_data_cache:
            self.TRAIN_DATA_CACHE = False
        if parsed.device_prefetch is not None:
            self.DEVICE_PREFETCH_BATCHES = parsed.device_prefetch
        self.MODEL_SAVE_PATH = parsed.save_path
        self.MODEL_LOAD_PATH = parsed.load_path
        self.TRAIN_DATA_PATH_PREFIX = parsed.data_path
        self.TEST_DATA_PATH = parsed.test_path or ''
        self.RELEASE = parsed.release
        self.EXPORT_CODE_VECTORS = parsed.export_code_vectors
        self.SAVE_W2V = parsed.save_w2v
        self.SAVE_T2V = parsed.save_t2v
        self.VERBOSE_MODE = parsed.verbose_mode
        self.DEVICE = parsed.device
        if parsed.compute_dtype:
            self.COMPUTE_DTYPE = parsed.compute_dtype
        if parsed.batch_size:
            self.TRAIN_BATCH_SIZE = parsed.batch_size
            self.TEST_BATCH_SIZE = parsed.batch_size
        if parsed.epochs:
            self.NUM_TRAIN_EPOCHS = parsed.epochs
        if parsed.adam_mu_dtype:
            self.ADAM_MU_DTYPE = parsed.adam_mu_dtype
        if parsed.adam_nu_dtype:
            self.ADAM_NU_DTYPE = parsed.adam_nu_dtype
        if parsed.grads_dtype:
            self.GRADS_DTYPE = parsed.grads_dtype
        if parsed.embed_grad_impl:
            self.EMBED_GRAD_IMPL = parsed.embed_grad_impl
        if parsed.remat_encode:
            self.REMAT_ENCODE = True
        if parsed.fused_ce:
            self.USE_PALLAS_FUSED_CE = True
        if parsed.no_ragged_fusion:
            self.USE_PALLAS_RAGGED_FUSION = False
        if parsed.wire_format:
            self.BATCH_WIRE_FORMAT = parsed.wire_format
        if parsed.bulk_vectors:
            self.BULK_VECTORS_PATH = parsed.bulk_vectors
        if parsed.vectors_dtype:
            self.VECTORS_DTYPE = parsed.vectors_dtype
        if parsed.export_vocab_vectors:
            self.EXPORT_VOCAB_VECTORS = parsed.export_vocab_vectors
        if parsed.serving_buckets:
            self.SERVING_BATCH_BUCKETS = parsed.serving_buckets
        if parsed.serving_max_delay_ms is not None:
            self.SERVING_MAX_DELAY_MS = parsed.serving_max_delay_ms
        if parsed.serving_deadline_ms is not None:
            self.SERVING_DEADLINE_MS = parsed.serving_deadline_ms
        if parsed.serving_queue_bound is not None:
            self.SERVING_QUEUE_BOUND = parsed.serving_queue_bound
        if parsed.serve_follow_checkpoints is not None:
            self.SERVE_FOLLOW_CHECKPOINTS_SECS = \
                parsed.serve_follow_checkpoints
        return self

    # ------------------------------------------------------- derived props
    @property
    def is_training(self) -> bool:
        return bool(self.TRAIN_DATA_PATH_PREFIX)

    @property
    def is_loading(self) -> bool:
        return bool(self.MODEL_LOAD_PATH)

    @property
    def is_saving(self) -> bool:
        return bool(self.MODEL_SAVE_PATH)

    @property
    def is_testing(self) -> bool:
        return bool(self.TEST_DATA_PATH)

    @property
    def model_load_dir(self) -> str:
        return os.path.dirname(self.MODEL_LOAD_PATH)

    # -------------------------------------- file-naming contract (parity)
    @classmethod
    def get_vocabularies_path_from_model_path(cls, model_file_path: str
                                              ) -> str:
        """The ``dictionaries.bin`` sidecar next to the model."""
        return os.path.join(os.path.dirname(model_file_path),
                            'dictionaries.bin')

    @classmethod
    def get_entire_model_path(cls, model_path: str) -> str:
        return model_path + '__entire-model'

    @classmethod
    def get_model_weights_path(cls, model_path: str) -> str:
        return model_path + '__only-weights'

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
    def serving_warm_tiers(self) -> Tuple[str, ...]:
        """Parsed SERVING_WARM_TIERS (validated in ``verify`` and at
        engine construction)."""
        return tuple(part.strip()
                     for part in str(self.SERVING_WARM_TIERS).split(',')
                     if part.strip())

    @property
    def train_data_path(self) -> Optional[str]:
        if not self.TRAIN_DATA_PATH_PREFIX:
            return None
        return '{}.train.c2v'.format(self.TRAIN_DATA_PATH_PREFIX)

    def verify(self) -> None:
        for name in ('COMPUTE_DTYPE', 'ADAM_MU_DTYPE', 'ADAM_NU_DTYPE',
                     'GRADS_DTYPE'):
            if getattr(self, name) not in _DTYPES:
                raise ValueError("config.%s must be in {'bfloat16', "
                                 "'float32'}, got %r"
                                 % (name, getattr(self, name)))
        for name in ('NUM_TRAIN_EPOCHS', 'SAVE_EVERY_EPOCHS', 'MAX_TO_KEEP',
                     'TRAIN_BATCH_SIZE', 'TEST_BATCH_SIZE',
                     'SHUFFLE_BUFFER_SIZE', 'NUM_BATCHES_TO_LOG_PROGRESS',
                     'READER_NUM_PARALLEL_BATCHES', 'READER_PREFETCH_BATCHES',
                     'EXTRACTOR_POOL_WORKERS',
                     'EXTRACTOR_BREAKER_THRESHOLD'):
            if getattr(self, name) < 1:
                raise ValueError('config.%s must be >= 1, got %r'
                                 % (name, getattr(self, name)))
        for name in ('DEVICE_PREFETCH_BATCHES', 'EXTRACTOR_TIMEOUT_SECS',
                     'EXTRACTOR_RETRIES', 'EXTRACTOR_BACKOFF_SECS',
                     'EXTRACTOR_BREAKER_COOLDOWN_SECS'):
            if getattr(self, name) < 0:
                raise ValueError('config.%s must be >= 0, got %r'
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
        if self.NUM_TRAIN_BATCHES_TO_EVALUATE < 0:
            raise ValueError('config.NUM_TRAIN_BATCHES_TO_EVALUATE must be '
                             '>= 0, got %r'
                             % self.NUM_TRAIN_BATCHES_TO_EVALUATE)
        if self.VECTORS_DTYPE not in {'float32', 'float16'}:
            raise ValueError("config.VECTORS_DTYPE must be in {'float32', "
                             "'float16'}, got %r" % (self.VECTORS_DTYPE,))
        if self.EMBED_GRAD_IMPL not in {'dense', 'sorted', 'dedup'}:
            raise ValueError("config.EMBED_GRAD_IMPL must be in "
                             "{'dense', 'sorted', 'dedup'}.")
        if self.GRADS_DTYPE == 'bfloat16' and self.LAZY_EMBEDDING_ADAM:
            raise ValueError(
                'GRADS_DTYPE=\'bfloat16\' requires the dense Adam path: '
                'LAZY_EMBEDDING_ADAM\'s sparse-row update consumes raw '
                'fp32 gradients.')
        if self.GRADS_DTYPE == 'bfloat16' \
                and self.COMPUTE_DTYPE != 'bfloat16':
            # the bf16 copies change the forward only where the compute
            # cast would not round anyway
            raise ValueError(
                "GRADS_DTYPE='bfloat16' requires "
                "COMPUTE_DTYPE='bfloat16' (the bf16 pre-cast must round "
                "exactly where the compute cast already would).")
        if self.SERVING_MAX_DELAY_MS < 0:
            raise ValueError('config.SERVING_MAX_DELAY_MS must be >= 0.')
        if self.SERVING_DECODE_WORKERS < 1:
            raise ValueError('config.SERVING_DECODE_WORKERS must be >= 1.')
        if self.SERVING_DEADLINE_MS < 0:
            raise ValueError('config.SERVING_DEADLINE_MS must be >= 0 '
                             '(0 = no deadline).')
        if self.SERVING_QUEUE_BOUND < -1:
            raise ValueError('config.SERVING_QUEUE_BOUND must be >= -1 '
                             '(0 = auto, -1 = unbounded).')
        if self.SERVING_CANARY_BATCHES < 0:
            raise ValueError('config.SERVING_CANARY_BATCHES must be >= 0 '
                             '(0 = swap without canary).')
        if not 0.0 <= self.SERVING_CANARY_AGREEMENT <= 1.0:
            raise ValueError('config.SERVING_CANARY_AGREEMENT must be in '
                             '[0, 1].')
        if self.SERVING_CANARY_TIMEOUT_SECS < 0:
            raise ValueError('config.SERVING_CANARY_TIMEOUT_SECS must be '
                             '>= 0 (0 disables the canary timeout).')
        if self.SERVE_FOLLOW_CHECKPOINTS_SECS < 0:
            raise ValueError('config.SERVE_FOLLOW_CHECKPOINTS_SECS must '
                             'be >= 0 (0 disables).')
        valid_tiers = {'topk', 'attention', 'full', 'vectors'}
        tiers = self.serving_warm_tiers
        if not tiers or not set(tiers) <= valid_tiers:
            raise ValueError(
                'config.SERVING_WARM_TIERS must be a non-empty '
                'comma-separated subset of %s, got %r'
                % (sorted(valid_tiers), self.SERVING_WARM_TIERS))
        if self.DEVICE not in {'cuda', 'cpu'}:
            raise ValueError("config.DEVICE must be in {'cuda', 'cpu'}, "
                             'got %r' % (self.DEVICE,))
        # the vocabularies come from the dataset's .dict.c2v or from the
        # dictionaries.bin beside a loaded model
        if not self.is_training and not self.is_loading:
            raise ValueError('Must train or load a model.')
        if self.is_loading and not os.path.isdir(self.model_load_dir):
            raise ValueError('Model load dir `{}` does not exist.'.format(
                self.model_load_dir))
        _ = self.serving_batch_buckets
