"""Configuration of the port: serving, training, evaluation, checkpoints
and the CLI.

The fields the port reads, with the names and defaults of the reference
``code2vec_tpu/config.py`` so one set of values configures both
packages, and ``load_from_args`` over the subset of the reference's
flags that the port serves (``cli.py``). The serving engine's knobs
(``serving/engine.py``: the micro-batcher, admission control and the
canaried rollover) are here with the reference's defaults and rules.
The training resilience knobs (step snapshots, the divergence guard,
the hang watchdog, preemption signals, FAULT_INJECT) and the metric
summaries and log mirror (USE_TENSORBOARD, LOGS_PATH) are, with the
reference's defaults, flags and rules, and so are the telemetry knobs
(TELEMETRY, the trace and profile windows, per-request tracing, the HBM
budget and the memory report, the MFU's peak, the anomaly watchdog), and
the embedding index's (BUILD_INDEX_FROM, INDEX_*, QUERY_NEIGHBORS_PATH).
The serving mesh's knobs (MESH_REPLICAS, MESH_QUEUE_BOUND,
MESH_MAX_INFLIGHT, the replica breaker's, the worker modes'
MESH_REPLICA_MODE and their heartbeat, restart and socket keys, the memo
tier's MEMO_* and the SLO monitor's SERVING_SLO_*) are, with the
reference's defaults, flags and rules, and so are the autoscaler's
AUTOSCALE_* and the worker telemetry backhaul's MESH_TELEMETRY_BACKHAUL
(the reference's defaults and rules; it has no flags for them), and the
scenario traffic plane's BLEND_NEIGHBOR_WEIGHT (``workloads/``, the
mesh's ``submit_blended``; its flag and rule as the reference's). The
training mesh's shape MESH_DATA_AXIS_SIZE x MESH_MODEL_AXIS_SIZE (the
``--mesh DxM`` flag, the reference's defaults) lays the ranks of a
``torch.distributed`` world out as the reference lays out its devices
(``parallel/mesh.py``); the Trainer's divisibility checks hold the batch
sizes to the data axis and PARAM_ROW_ALIGNMENT to the model axis. One
difference: the reference forces multi-host runs onto the plane wire
(its ``wire_format_for``), because hosts cannot agree on one packed
capacity; here each rank packs and consumes only its own shard, so
BATCH_WIRE_FORMAT holds at any world size. LAZY_EMBEDDING_ADAM is read
(one rank: as the reference) but on a mesh of more than one rank raises
``MeshUnsupported`` (ROADMAP A9b), as TELEMETRY does (its files are one
process's). Knobs of paths the port does not have yet (ROADMAP A9b:
SHARD_CONTEXTS, OPTIMIZER_STATE_SHARDING and its --opt-state-sharding,
the serving placement keys MESH_DEVICES_PER_REPLICA and
MESH_DEVICE_INDICES) and RAGGED_TRAIN_KERNEL, which only gates a TPU
kernel (the port's packed train path always goes through its kernels on
the card), are not here; their flags are "unrecognized arguments"
errors.
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
    # also snapshot every this many steps, into
    # <MODEL_SAVE_PATH>__step-snapshots (2 kept; 0: epoch saves only): it
    # bounds what a preemption loses and gives the divergence guard a
    # rewind target
    SAVE_EVERY_N_STEPS: int = 0
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
    # shapes as the reference, so weights convert one to one); it must be
    # divisible by the mesh's model axis (even table sharding)
    PARAM_ROW_ALIGNMENT: int = 128
    # the (data, model) mesh of the torch.distributed world's ranks
    # (parallel/mesh.py, --mesh DxM): -1 data = the ranks the model axis
    # leaves; the three tables row-sharded over 'model', the batch split
    # over 'data'
    MESH_DATA_AXIS_SIZE: int = -1
    MESH_MODEL_AXIS_SIZE: int = 1
    # the torch.distributed backend of a world of ranks (--dist-backend):
    # 'nccl' (one card a rank) or 'gloo' (ranks sharing a card, or the
    # CPU); parallel/distributed.py
    DIST_BACKEND: str = 'nccl'
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
    # planes and mask
    BATCH_WIRE_FORMAT: str = 'packed'
    # the dense forward of the plane wire (and of the packed wire with
    # the ragged fusion off) through the fused context-transform kernel
    # (ops/encode.py); False computes it in plain torch, as the
    # reference does outside its TPU kernel
    USE_PALLAS_FUSED_ENCODE: bool = False
    # the packed wire's forward and training straight off the packed
    # stream through the ragged kernels (ops/ragged.py); False unpacks
    # the stream to planes on the device for the dense encode
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
    # ---- serving mesh (reference config.py:424-443; serving/mesh.py) ----
    # engine replicas behind the one shared front queue (--mesh-replicas),
    # threads of this process on the one card
    MESH_REPLICAS: int = 1
    # the shared queue's admission bound in rows across the tiers and
    # replicas (--mesh-queue-bound; 0: replicas x 8 x the top bucket,
    # -1: unbounded)
    MESH_QUEUE_BOUND: int = 0
    # dispatched, undecoded micro-batches a replica may hold before its
    # puller stops claiming work (a canarying replica runs at half, a
    # half-open breaker probes with one)
    MESH_MAX_INFLIGHT: int = 2
    # a replica's dispatch breaker: consecutive failures that weight it
    # out of pulling, and the seconds before its one half-open probe
    MESH_BREAKER_THRESHOLD: int = 3
    MESH_BREAKER_COOLDOWN_SECS: float = 10.0
    # where the replicas run (--mesh-replica-mode; reference
    # config.py:444-475): 'thread' = engines in this process; 'process' =
    # one spawned worker process per replica on the framed wire over a
    # pipe; 'socket' = the same wire over TCP, the workers dialing the
    # mesh's listener. The worker modes need a checkpointed model: a
    # worker restores its weights from the store.
    MESH_REPLICA_MODE: str = 'thread'
    # worker heartbeat period in seconds (0: no liveness monitor), and the
    # intervals a worker may miss before the mesh kills it, redispatches
    # its batches and restarts it
    MESH_HEARTBEAT_SECS: float = 2.0
    MESH_HEARTBEAT_MISSES: int = 3
    # supervised restarts one replica may spend inside the window before
    # it retires for good (0: the first death retires), and the first
    # restart's backoff, doubled per attempt inside the window (at most
    # 30 s)
    MESH_RESTART_LIMIT: int = 3
    MESH_RESTART_WINDOW_SECS: float = 300.0
    MESH_RESTART_BACKOFF_SECS: float = 0.5
    # bind address of the socket mode's listener (127.0.0.1: loopback)
    MESH_SOCKET_HOST: str = '127.0.0.1'
    # the worker modes' telemetry backhaul (reference config.py:528-534):
    # -1 = auto (a worker enables telemetry iff the parent had it enabled
    # when it spawned the worker), 1 = on, 0 = off. With it on, each
    # heartbeat ships the worker's registry snapshot and memory-ledger
    # rollup for the replica-labeled fleet merge
    MESH_TELEMETRY_BACKHAUL: int = -1
    # ---- autoscaler (reference config.py:493-527; serving/autoscaler.py)
    # fleet-size bounds: MAX 0 keeps the autoscaler off (the fleet keeps
    # the size it was built with); MAX > 0 arms the loop, which adds
    # replicas (or asks its spawn hook for them) up to MAX and drains them
    # with retire() (never a kill) down to MIN
    AUTOSCALE_MIN_REPLICAS: int = 1
    AUTOSCALE_MAX_REPLICAS: int = 0
    # seconds between two evaluations of the control loop
    AUTOSCALE_INTERVAL_SECS: float = 5.0
    # scale up when the front queue's drain estimate (queued rows over
    # the fleet's served rows/s) exceeds this many seconds
    AUTOSCALE_UP_QUEUE_SECS: float = 2.0
    # scale up too when an SLO burns above this on both its windows (0:
    # the queue leg only)
    AUTOSCALE_UP_BURN: float = 0.0
    # scale down after the fleet looked over-provisioned for this many
    # consecutive seconds: the drain estimate with one fewer replica
    # under AUTOSCALE_DOWN_UTILIZATION x AUTOSCALE_UP_QUEUE_SECS, no SLO
    # burning
    AUTOSCALE_DOWN_IDLE_SECS: float = 30.0
    AUTOSCALE_DOWN_UTILIZATION: float = 0.5
    # seconds after a scale-up (a scale-down) before the next one
    AUTOSCALE_UP_COOLDOWN_SECS: float = 10.0
    AUTOSCALE_DOWN_COOLDOWN_SECS: float = 60.0
    # the flap guard: AUTOSCALE_FLAP_LIMIT direction reversals inside the
    # window freeze all scaling for one window
    AUTOSCALE_FLAP_WINDOW_SECS: float = 120.0
    AUTOSCALE_FLAP_LIMIT: int = 2
    # ---- SLO burn-rate monitor (reference config.py:535-551;
    # serving/slo.py) ----
    # availability target (sheds, expiries and failures burn 1 - target;
    # 0: off) and p99 latency target in ms (a slower delivered request
    # burns the fixed 1% budget; 0: off)
    SERVING_SLO_AVAILABILITY: float = 0.0
    SERVING_SLO_P99_MS: float = 0.0
    # an alert needs the burn over both windows above the threshold
    SERVING_SLO_FAST_WINDOW_SECS: float = 60.0
    SERVING_SLO_SLOW_WINDOW_SECS: float = 600.0
    SERVING_SLO_BURN_THRESHOLD: float = 10.0
    # ---- memoization tier (reference config.py:552-565; serving/memo.py)
    # exact-tier result cache in bytes, checked at mesh admission
    # (--memo-cache-bytes; 0: off)
    MEMO_CACHE_BYTES: int = 0
    # semantic tier: serve a one-row neighbor query from a cached query
    # within this cosine distance (0: off)
    MEMO_SEMANTIC_EPSILON: float = 0.0
    # ---- scenario traffic plane (reference config.py:566-573; workloads/)
    # submit_blended scores a candidate label (1 - w) * softmax_p +
    # w * neighbor_vote (--blend-neighbor-weight; 0: the plain softmax
    # path, bit for bit; 1: retrieval votes only). In [0, 1]
    BLEND_NEIGHBOR_WEIGHT: float = 0.5
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

    # ---- training resilience (resilience/, reference config.py:340-370)
    # check each loss window for NaN/Inf at the sync the loop does anyway;
    # on a hit rewind to the newest checkpoint no newer than the first bad
    # step and skip the window (no checkpoint: abort with a dump)
    DIVERGENCE_GUARD: bool = True
    # rewinds before the run is declared divergent and aborted
    MAX_DIVERGENCE_REWINDS: int = 3
    # deadline in seconds of the loop's two blocking waits (the next staged
    # batch, the loss-window sync); past it every thread's stack is dumped
    # and the process aborts with SIGABRT (0: off)
    HANG_WATCHDOG_SECS: float = 0.0
    # SIGTERM/SIGINT end train() at the next step boundary after one
    # final snapshot (no-op outside the main thread)
    HANDLE_PREEMPTION_SIGNALS: bool = True
    # fault injection spec (resilience/faults.py), e.g.
    # 'nan_loss@step=120,sigterm@step=50'; None: the FAULT_INJECT
    # environment variable fills in; '': off, whatever the variable says
    FAULT_INJECT: Optional[str] = None

    # ---- telemetry (telemetry/, reference config.py:261-339) ----
    # a torch.profiler trace of PROFILE_NUM_STEPS train steps from
    # PROFILE_START_STEP (counted from the run's first step) into
    # PROFILE_DIR/trace.json (--profile)
    PROFILE_DIR: Optional[str] = None
    PROFILE_START_STEP: int = 10
    PROFILE_NUM_STEPS: int = 5
    # the telemetry layer: step-phase timers, throughput counters, the
    # staging ring's occupancy, compile accounting, the goodput ledger
    # and MFU, the exporters (metrics.jsonl, metrics.prom, a console
    # line); off, the hot loop carries only `is None` checks
    TELEMETRY: bool = False
    # where telemetry artifacts go (metrics.*, intervals.jsonl, traces/,
    # spans.jsonl, memory and OOM dumps), and the guard's divergence dumps
    # and the watchdog's stacks (None: telemetry/ beside the model saved
    # or loaded, else the working directory's telemetry/)
    TELEMETRY_DIR: Optional[str] = None
    # exporter flush cadence in train steps (rates are per flush window)
    TELEMETRY_FLUSH_EVERY_STEPS: int = 50
    # minimum seconds between telemetry console lines
    TELEMETRY_CONSOLE_EVERY_SECS: float = 30.0
    # a torch.profiler capture of TELEMETRY_TRACE_NUM_STEPS steps from this
    # global step (-1: unset, the TELEMETRY_TRACE_AT_STEP environment
    # variable fills in; `touch <telemetry_dir>/TRACE_NOW` captures from a
    # live run)
    TELEMETRY_TRACE_AT_STEP: int = -1
    TELEMETRY_TRACE_NUM_STEPS: int = 5
    # head sample rate of the serving engine's per-request span log in
    # [0, 1]; 0 disables tracing; shed/expired/degraded/split/closed
    # requests and those slower than TRACING_SLOW_MS are kept regardless;
    # -1: unset, the TRACING_SAMPLE_RATE environment variable, else 0.01
    TRACING_SAMPLE_RATE: float = -1.0
    TRACING_SLOW_MS: float = 250.0
    # the flight recorder's ring of recent traces
    TRACING_FLIGHT_TRACES: int = 256
    # HBM budget in bytes of the memory ledger's checks: the trainer's
    # state or a serving slot that would cross it fails typed
    # (MemoryBudgetExceeded) before allocating; -1: unset, the
    # HBM_BUDGET_BYTES environment variable, else 0 = unlimited
    HBM_BUDGET_BYTES: int = -1
    # a reconciled memory-ledger snapshot (memory_report.json) when the
    # CLI's work completes (--memory-report)
    MEMORY_REPORT: bool = False
    # per-device peak FLOP/s, the MFU's denominator; -1: unset, the
    # DEVICE_PEAK_FLOPS environment variable, else the device-name table
    # of telemetry/goodput.py, else a conservative default
    DEVICE_PEAK_FLOPS: float = -1.0
    # the step-time anomaly watchdog's threshold in robust deviations
    # above the shape's rolling median (0 disables), and the minimum
    # seconds between the profiler captures it triggers
    GOODPUT_ANOMALY_SIGMA: float = 6.0
    GOODPUT_AUTOCAPTURE_COOLDOWN_SECS: float = 600.0
    # ---- logs and metric summaries (reference config.py:671-672) ----
    # mirror the log into this file (the CLI's -lp)
    LOGS_PATH: Optional[str] = None
    # train/loss, train/examples_per_sec, train/epoch_wall_time_s and the
    # eval scalars into summaries/metrics.jsonl beside the model (and a
    # TensorBoard event file where torch.utils.tensorboard imports)
    USE_TENSORBOARD: bool = False

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
    # the embedding index (index/, INDEX.md): --build-index SOURCE (a .c2v
    # corpus, a .vectors export or a word2vec text file) into INDEX_PATH
    # (default <source>.vecindex), and --query-neighbors FILE.c2v through
    # the vectors tier and the index into FILE.neighbors.jsonl
    BUILD_INDEX_FROM: Optional[str] = None
    INDEX_PATH: Optional[str] = None
    QUERY_NEIGHBORS_PATH: Optional[str] = None
    # the tier: 'exact' (brute force, bit for rank) or 'ivf' (k-means
    # lists, nprobe of INDEX_CLUSTERS probed; 0 = the defaults: nprobe 8,
    # sqrt(N) clusters); 'cosine' normalizes the store rows at build
    INDEX_KIND: str = 'exact'
    INDEX_METRIC: str = 'cosine'
    INDEX_NPROBE: int = 8
    INDEX_CLUSTERS: int = 0
    # the quantized IVF tier: '' (off), 'int8' or 'pq' device codes with an
    # exact re-rank of the top INDEX_RERANK from the store (0 = off); PQ
    # subspaces (0 = dim/4); live inserts in segments of INDEX_SEGMENT_ROWS,
    # compacted after INDEX_COMPACT_SEGMENTS of them (0 = manual only)
    INDEX_QUANT: str = ''
    INDEX_RERANK: int = 128
    INDEX_PQ_M: int = 0
    INDEX_SEGMENT_ROWS: int = 4096
    INDEX_COMPACT_SEGMENTS: int = 8
    # neighbors per query on the serving and CLI paths, and the k the
    # index warms at load
    INDEX_NEIGHBORS_K: int = 10
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
        parser.add_argument('-lp', '--logs-path', dest='logs_path',
                            metavar='FILE', required=False,
                            help='file to mirror logs into')
        parser.add_argument('-tb', '--tensorboard', dest='use_tensorboard',
                            action='store_true',
                            help='write metric summaries during training')
        parser.add_argument('--dtype', dest='compute_dtype',
                            choices=sorted(_DTYPES),
                            help='compute dtype of the forward and backward')
        parser.add_argument('--mesh', dest='mesh', default=None,
                            help='mesh shape as DATAxMODEL, e.g. 2x2 (the '
                                 'ranks torchrun started)')
        parser.add_argument('--dist-backend', dest='dist_backend',
                            choices=['nccl', 'gloo'], default=None,
                            help='torch.distributed backend of the ranks '
                                 '(DIST_BACKEND; default nccl)')
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
        parser.add_argument('--ragged-fusion', dest='ragged_fusion',
                            action='store_true',
                            help='encode straight off the packed wire '
                                 'through the ragged kernels (the '
                                 'default)')
        parser.add_argument('--no-ragged-fusion', dest='no_ragged_fusion',
                            action='store_true',
                            help='unpack the packed wire to planes for the '
                                 'dense encode')
        parser.add_argument('--save-every-steps', dest='save_every_steps',
                            type=int, default=None, metavar='N',
                            help='also snapshot every N train steps, '
                                 'bounding what a preemption loses')
        parser.add_argument('--fault-inject', dest='fault_inject',
                            default=None, metavar='SPEC',
                            help='deterministic fault injection, e.g. '
                                 'nan_loss@step=120,sigterm@step=50 '
                                 '(resilience/faults.py); default: the '
                                 'FAULT_INJECT environment variable')
        parser.add_argument('--watchdog-secs', dest='watchdog_secs',
                            type=float, default=None, metavar='SECS',
                            help='hang watchdog deadline of the training '
                                 'loop\'s blocking waits (0 disables)')
        parser.add_argument('--max-divergence-rewinds',
                            dest='max_divergence_rewinds', type=int,
                            default=None, metavar='N',
                            help='rewinds the divergence guard attempts '
                                 'before aborting the run')
        parser.add_argument('--no-divergence-guard',
                            dest='no_divergence_guard', action='store_true',
                            help='train on through a non-finite loss')
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
        parser.add_argument('--build-index', dest='build_index',
                            default=None, metavar='SOURCE',
                            help='build a k-NN index from SOURCE: a .c2v '
                                 'corpus (streamed through the vectors '
                                 'tier), a .vectors export, or a word2vec '
                                 'text file (index/, INDEX.md)')
        parser.add_argument('--index-path', dest='index_path',
                            default=None, metavar='DIR',
                            help='index directory (default on build: '
                                 '<source>.vecindex; required for '
                                 '--query-neighbors)')
        parser.add_argument('--query-neighbors', dest='query_neighbors',
                            default=None, metavar='FILE.c2v',
                            help='stream a .c2v file through the vectors '
                                 'tier + index lookup and write '
                                 'FILE.neighbors.jsonl (one query per '
                                 'kept example)')
        parser.add_argument('--index-kind', dest='index_kind',
                            choices=['exact', 'ivf'], default=None,
                            help='index tier: exact brute-force or IVF '
                                 'approximate (INDEX.md)')
        parser.add_argument('--index-metric', dest='index_metric',
                            choices=['cosine', 'dot'], default=None,
                            help='similarity metric of the index store')
        parser.add_argument('--nprobe', dest='index_nprobe', type=int,
                            default=None, metavar='N',
                            help='IVF inverted lists probed per query '
                                 '(the recall/latency dial)')
        parser.add_argument('--index-clusters', dest='index_clusters',
                            type=int, default=None, metavar='C',
                            help='IVF k-means cluster count (0 = sqrt(N))')
        parser.add_argument('--neighbors-k', dest='index_neighbors_k',
                            type=int, default=None, metavar='K',
                            help='neighbors returned per query')
        parser.add_argument('--index-quant', dest='index_quant',
                            choices=['off', 'int8', 'pq'], default=None,
                            help='quantized IVF tier: int8 or product-'
                                 'quantized device codes + exact '
                                 're-rank (INDEX.md "Quantized tier")')
        parser.add_argument('--index-rerank', dest='index_rerank',
                            type=int, default=None, metavar='R',
                            help='exact re-rank depth of the quantized '
                                 'tier (0 = quantized order only)')
        parser.add_argument('--index-pq-m', dest='index_pq_m',
                            type=int, default=None, metavar='M',
                            help='PQ subspaces per vector (0 = dim/4)')
        parser.add_argument('--index-segment-rows',
                            dest='index_segment_rows', type=int,
                            default=None, metavar='N',
                            help='append-segment page size (rows) for '
                                 'live index inserts')
        parser.add_argument('--index-compact-segments',
                            dest='index_compact_segments', type=int,
                            default=None, metavar='S',
                            help='auto-compact after S append segments '
                                 '(0 = manual compaction only)')
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
        parser.add_argument('--mesh-replicas', dest='mesh_replicas',
                            type=int, default=None, metavar='N',
                            help='serving-engine replicas behind the '
                                 'shared mesh front queue (MESH_REPLICAS)')
        parser.add_argument('--mesh-queue-bound', dest='mesh_queue_bound',
                            type=int, default=None, metavar='ROWS',
                            help='shared mesh front-queue admission '
                                 'bound in rows across all replicas '
                                 '(0 = auto: replicas x 8 x top '
                                 'bucket, -1 = unbounded)')
        parser.add_argument('--mesh-replica-mode',
                            dest='mesh_replica_mode',
                            choices=['thread', 'process', 'socket'],
                            default=None,
                            help='replica placement: engine threads of '
                                 'this process, one worker process per '
                                 'replica on the framed dispatch wire '
                                 'over a pipe, or the same wire over TCP '
                                 '(workers dial the mesh listener); the '
                                 'worker modes need a checkpointed model '
                                 '(MESH_REPLICA_MODE)')
        parser.add_argument('--memo-cache-bytes', dest='memo_cache_bytes',
                            type=int, default=None, metavar='BYTES',
                            help='exact-tier memoization cache budget '
                                 'in bytes: repeated requests are '
                                 'served before the queue and the '
                                 'card (MEMO_CACHE_BYTES; 0 disables)')
        parser.add_argument('--blend-neighbor-weight',
                            dest='blend_neighbor_weight', type=float,
                            default=None, metavar='W',
                            help='retrieval-augmented naming blend '
                                 'weight in [0, 1]: the neighbor votes\' '
                                 'share in submit_blended scoring '
                                 '(BLEND_NEIGHBOR_WEIGHT; 0 = pure '
                                 'softmax)')
        parser.add_argument('--serve-follow-checkpoints',
                            dest='serve_follow_checkpoints', type=float,
                            default=None, metavar='SECS',
                            help='poll the checkpoint store every SECS '
                                 'for newer steps and roll them into '
                                 'the live serving engine through the '
                                 'canary')
        parser.add_argument('--profile', dest='profile_dir', default=None,
                            metavar='DIR',
                            help='capture a torch.profiler trace of a few '
                                 'train steps into DIR')
        parser.add_argument('--telemetry', dest='telemetry',
                            action='store_true',
                            help='enable the telemetry layer: step-phase '
                                 'timers, throughput counters, goodput '
                                 'and MFU, JSONL + Prometheus exporters')
        parser.add_argument('--telemetry-dir', dest='telemetry_dir',
                            default=None, metavar='DIR',
                            help='directory for telemetry artifacts '
                                 '(default: next to the model artifacts)')
        parser.add_argument('--trace-at-step', dest='trace_at_step',
                            type=int, default=None, metavar='N',
                            help='capture a torch.profiler trace when '
                                 'global step N is reached (implies '
                                 '--telemetry; live runs can instead touch '
                                 '<telemetry_dir>/TRACE_NOW)')
        parser.add_argument('--device-peak-flops',
                            dest='device_peak_flops',
                            type=float, default=None, metavar='FLOPS',
                            help='per-device peak FLOP/s used as the '
                                 'MFU denominator (train/mfu); unset '
                                 'falls back to the DEVICE_PEAK_FLOPS '
                                 'env var, then a device-name table '
                                 '(telemetry/goodput.py)')
        parser.add_argument('--memory-report', dest='memory_report',
                            action='store_true',
                            help='write a reconciled device-memory '
                                 'ledger snapshot (memory_report.json) '
                                 'when the run completes; render with '
                                 'scripts/memory_report.py')
        parser.add_argument('--hbm-budget-bytes', dest='hbm_budget_bytes',
                            type=int, default=None, metavar='BYTES',
                            help='HBM budget of the memory ledger\'s '
                                 'checks: a training state or serving '
                                 'slot that would cross it fails typed '
                                 'before allocating (0 = unlimited; the '
                                 'HBM_BUDGET_BYTES env var fills in '
                                 'when unset)')
        parser.add_argument('--device', dest='device',
                            choices=['cuda', 'cpu'], default='cuda',
                            help="where to run: 'cuda' (default) or 'cpu' "
                                 '(the kernels\' plain versions)')

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
        self.LOGS_PATH = parsed.logs_path
        self.USE_TENSORBOARD = parsed.use_tensorboard
        self.DEVICE = parsed.device
        if parsed.compute_dtype:
            self.COMPUTE_DTYPE = parsed.compute_dtype
        if parsed.dist_backend:
            self.DIST_BACKEND = parsed.dist_backend
        if parsed.mesh:
            try:
                data_sz, model_sz = parsed.mesh.lower().split('x')
                self.MESH_DATA_AXIS_SIZE = int(data_sz)
                self.MESH_MODEL_AXIS_SIZE = int(model_sz)
            except ValueError:
                raise ValueError(
                    "--mesh must look like DATAxMODEL (e.g. '4x2'), got %r"
                    % parsed.mesh)
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
        if parsed.ragged_fusion:
            self.USE_PALLAS_RAGGED_FUSION = True
        if parsed.no_ragged_fusion:
            self.USE_PALLAS_RAGGED_FUSION = False
        if parsed.save_every_steps is not None:
            self.SAVE_EVERY_N_STEPS = parsed.save_every_steps
        if parsed.fault_inject is not None:
            # an explicit --fault-inject '' turns injection off even when
            # the environment variable is set (a drill's control arm)
            self.FAULT_INJECT = parsed.fault_inject
        elif self.FAULT_INJECT is None:
            self.FAULT_INJECT = os.environ.get('FAULT_INJECT')
        if parsed.watchdog_secs is not None:
            self.HANG_WATCHDOG_SECS = parsed.watchdog_secs
        if parsed.max_divergence_rewinds is not None:
            self.MAX_DIVERGENCE_REWINDS = parsed.max_divergence_rewinds
        if parsed.no_divergence_guard:
            self.DIVERGENCE_GUARD = False
        if parsed.wire_format:
            self.BATCH_WIRE_FORMAT = parsed.wire_format
        if parsed.bulk_vectors:
            self.BULK_VECTORS_PATH = parsed.bulk_vectors
        if parsed.vectors_dtype:
            self.VECTORS_DTYPE = parsed.vectors_dtype
        if parsed.export_vocab_vectors:
            self.EXPORT_VOCAB_VECTORS = parsed.export_vocab_vectors
        if parsed.build_index:
            self.BUILD_INDEX_FROM = parsed.build_index
        if parsed.index_path:
            self.INDEX_PATH = parsed.index_path
        if parsed.query_neighbors:
            self.QUERY_NEIGHBORS_PATH = parsed.query_neighbors
        if parsed.index_kind:
            self.INDEX_KIND = parsed.index_kind
        if parsed.index_metric:
            self.INDEX_METRIC = parsed.index_metric
        if parsed.index_nprobe is not None:
            self.INDEX_NPROBE = parsed.index_nprobe
        if parsed.index_clusters is not None:
            self.INDEX_CLUSTERS = parsed.index_clusters
        if parsed.index_neighbors_k is not None:
            self.INDEX_NEIGHBORS_K = parsed.index_neighbors_k
        if parsed.index_quant is not None:
            self.INDEX_QUANT = ('' if parsed.index_quant == 'off'
                                else parsed.index_quant)
        if parsed.index_rerank is not None:
            self.INDEX_RERANK = parsed.index_rerank
        if parsed.index_pq_m is not None:
            self.INDEX_PQ_M = parsed.index_pq_m
        if parsed.index_segment_rows is not None:
            self.INDEX_SEGMENT_ROWS = parsed.index_segment_rows
        if parsed.index_compact_segments is not None:
            self.INDEX_COMPACT_SEGMENTS = parsed.index_compact_segments
        if parsed.serving_buckets:
            self.SERVING_BATCH_BUCKETS = parsed.serving_buckets
        if parsed.serving_max_delay_ms is not None:
            self.SERVING_MAX_DELAY_MS = parsed.serving_max_delay_ms
        if parsed.serving_deadline_ms is not None:
            self.SERVING_DEADLINE_MS = parsed.serving_deadline_ms
        if parsed.serving_queue_bound is not None:
            self.SERVING_QUEUE_BOUND = parsed.serving_queue_bound
        if parsed.mesh_replicas is not None:
            self.MESH_REPLICAS = parsed.mesh_replicas
        if parsed.mesh_queue_bound is not None:
            self.MESH_QUEUE_BOUND = parsed.mesh_queue_bound
        if parsed.memo_cache_bytes is not None:
            self.MEMO_CACHE_BYTES = parsed.memo_cache_bytes
        if parsed.blend_neighbor_weight is not None:
            self.BLEND_NEIGHBOR_WEIGHT = parsed.blend_neighbor_weight
        if parsed.mesh_replica_mode:
            self.MESH_REPLICA_MODE = parsed.mesh_replica_mode
        if parsed.serve_follow_checkpoints is not None:
            self.SERVE_FOLLOW_CHECKPOINTS_SECS = \
                parsed.serve_follow_checkpoints
        if parsed.profile_dir:
            self.PROFILE_DIR = parsed.profile_dir
        if parsed.telemetry:
            self.TELEMETRY = True
        if parsed.telemetry_dir:
            self.TELEMETRY_DIR = parsed.telemetry_dir
        if parsed.trace_at_step is not None:
            self.TELEMETRY_TRACE_AT_STEP = parsed.trace_at_step
            self.TELEMETRY = True  # a trace request implies the layer
        elif self.TELEMETRY_TRACE_AT_STEP < 0:
            # the variable is for runs whose launch scripts cannot be
            # edited, so it implies the layer as the flag does
            try:
                env_step = int(os.environ.get('TELEMETRY_TRACE_AT_STEP',
                                              '-1'))
            except ValueError:
                env_step = -1
            if env_step >= 0:
                self.TELEMETRY_TRACE_AT_STEP = env_step
                self.TELEMETRY = True
        if parsed.device_peak_flops is not None:
            self.DEVICE_PEAK_FLOPS = parsed.device_peak_flops
        if parsed.memory_report:
            self.MEMORY_REPORT = True
        if parsed.hbm_budget_bytes is not None:
            self.HBM_BUDGET_BYTES = parsed.hbm_budget_bytes
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

    @classmethod
    def get_step_snapshots_path(cls, model_path: str) -> str:
        """The step-interval snapshots (SAVE_EVERY_N_STEPS)."""
        return model_path + '__step-snapshots'

    @property
    def telemetry_dir(self) -> str:
        """Where telemetry artifacts, the divergence dumps and the
        watchdog's stacks go: TELEMETRY_DIR, else ``telemetry/`` beside
        the model saved or loaded, else in the working directory."""
        if self.TELEMETRY_DIR:
            return self.TELEMETRY_DIR
        if self.is_saving:
            return os.path.join(os.path.dirname(self.MODEL_SAVE_PATH),
                                'telemetry')
        if self.is_loading:
            return os.path.join(self.model_load_dir, 'telemetry')
        return 'telemetry'

    @property
    def tracing_sample_rate(self) -> float:
        """The serving engine's head-sampling rate: TRACING_SAMPLE_RATE
        when set (>= 0), else the environment variable of that name, else
        0.01; clamped to [0, 1]."""
        rate = self.TRACING_SAMPLE_RATE
        if rate < 0:
            try:
                rate = float(os.environ.get('TRACING_SAMPLE_RATE', 0.01))
            except ValueError:
                raise ValueError(
                    'TRACING_SAMPLE_RATE env var must be a float, got %r'
                    % os.environ.get('TRACING_SAMPLE_RATE'))
        return max(0.0, min(1.0, rate))

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
        if self.INDEX_KIND not in {'exact', 'ivf'}:
            raise ValueError("config.INDEX_KIND must be in "
                             "{'exact', 'ivf'}.")
        if self.INDEX_METRIC not in {'cosine', 'dot'}:
            raise ValueError("config.INDEX_METRIC must be in "
                             "{'cosine', 'dot'}.")
        if self.INDEX_NPROBE < 0:
            raise ValueError('config.INDEX_NPROBE must be >= 0 '
                             '(0 = default).')
        if self.INDEX_CLUSTERS < 0:
            raise ValueError('config.INDEX_CLUSTERS must be >= 0 '
                             '(0 = sqrt(N)).')
        if self.INDEX_NEIGHBORS_K < 1:
            raise ValueError('config.INDEX_NEIGHBORS_K must be >= 1.')
        if self.INDEX_QUANT not in {'', 'int8', 'pq'}:
            raise ValueError("config.INDEX_QUANT must be in "
                             "{'', 'int8', 'pq'} ('' = full-precision "
                             "tier).")
        if self.INDEX_RERANK < 0:
            raise ValueError('config.INDEX_RERANK must be >= 0 '
                             '(0 disables the exact re-rank).')
        if self.INDEX_PQ_M < 0:
            raise ValueError('config.INDEX_PQ_M must be >= 0 '
                             '(0 = dim/4).')
        if self.INDEX_SEGMENT_ROWS < 1:
            raise ValueError('config.INDEX_SEGMENT_ROWS must be >= 1.')
        if self.INDEX_COMPACT_SEGMENTS < 0:
            raise ValueError('config.INDEX_COMPACT_SEGMENTS must be '
                             '>= 0 (0 = manual compaction only).')
        if self.QUERY_NEIGHBORS_PATH and not (self.INDEX_PATH
                                              or self.BUILD_INDEX_FROM):
            raise ValueError(
                '--query-neighbors needs an index: pass --index-path '
                'DIR (an existing index) or --build-index SOURCE '
                '(build one first).')
        if self.DIST_BACKEND not in {'nccl', 'gloo'}:
            raise ValueError("config.DIST_BACKEND must be in "
                             "{'nccl', 'gloo'}.")
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
        if self.MESH_REPLICAS < 1:
            raise ValueError('config.MESH_REPLICAS must be >= 1.')
        if self.MESH_QUEUE_BOUND < -1:
            raise ValueError('config.MESH_QUEUE_BOUND must be >= -1 '
                             '(0 = auto, -1 = unbounded).')
        if self.MEMO_CACHE_BYTES < 0:
            raise ValueError('config.MEMO_CACHE_BYTES must be >= 0 '
                             '(0 disables the memoization tier).')
        if not 0.0 <= self.MEMO_SEMANTIC_EPSILON <= 1.0:
            raise ValueError('config.MEMO_SEMANTIC_EPSILON must be in '
                             '[0, 1] (0 keeps the semantic tier off).')
        if not 0.0 <= self.BLEND_NEIGHBOR_WEIGHT <= 1.0:
            raise ValueError('config.BLEND_NEIGHBOR_WEIGHT must be in '
                             '[0, 1] (0 = pure softmax ranking).')
        if self.MESH_MAX_INFLIGHT < 1:
            raise ValueError('config.MESH_MAX_INFLIGHT must be >= 1.')
        if self.MESH_BREAKER_THRESHOLD < 1:
            raise ValueError('config.MESH_BREAKER_THRESHOLD must be '
                             '>= 1.')
        if self.MESH_BREAKER_COOLDOWN_SECS < 0:
            raise ValueError('config.MESH_BREAKER_COOLDOWN_SECS must '
                             'be >= 0.')
        if self.MESH_REPLICA_MODE not in ('thread', 'process', 'socket'):
            raise ValueError("config.MESH_REPLICA_MODE must be 'thread', "
                             "'process' or 'socket'.")
        if self.MESH_HEARTBEAT_SECS < 0:
            raise ValueError('config.MESH_HEARTBEAT_SECS must be >= 0 '
                             '(0 disables the liveness monitor).')
        if self.MESH_HEARTBEAT_MISSES < 1:
            raise ValueError('config.MESH_HEARTBEAT_MISSES must be '
                             '>= 1.')
        if self.MESH_RESTART_LIMIT < 0:
            raise ValueError('config.MESH_RESTART_LIMIT must be >= 0 '
                             '(0 = never restart).')
        if self.MESH_RESTART_WINDOW_SECS <= 0:
            raise ValueError('config.MESH_RESTART_WINDOW_SECS must be '
                             '> 0 (the restart budget is window-'
                             'scoped).')
        if self.MESH_RESTART_BACKOFF_SECS < 0:
            raise ValueError('config.MESH_RESTART_BACKOFF_SECS must be '
                             '>= 0.')
        if self.MESH_TELEMETRY_BACKHAUL not in (-1, 0, 1):
            raise ValueError('config.MESH_TELEMETRY_BACKHAUL must be '
                             '-1 (auto), 0 (off) or 1 (on).')
        if self.AUTOSCALE_MIN_REPLICAS < 1:
            raise ValueError('config.AUTOSCALE_MIN_REPLICAS must be '
                             '>= 1.')
        if self.AUTOSCALE_MAX_REPLICAS < 0:
            raise ValueError('config.AUTOSCALE_MAX_REPLICAS must be >= 0 '
                             '(0 keeps the autoscaler off).')
        if self.AUTOSCALE_MAX_REPLICAS > 0 and \
                self.AUTOSCALE_MAX_REPLICAS < self.AUTOSCALE_MIN_REPLICAS:
            raise ValueError('config.AUTOSCALE_MAX_REPLICAS must be >= '
                             'AUTOSCALE_MIN_REPLICAS when armed.')
        if self.AUTOSCALE_INTERVAL_SECS <= 0:
            raise ValueError('config.AUTOSCALE_INTERVAL_SECS must be '
                             '> 0.')
        if self.AUTOSCALE_UP_QUEUE_SECS <= 0:
            raise ValueError('config.AUTOSCALE_UP_QUEUE_SECS must be '
                             '> 0.')
        if self.AUTOSCALE_UP_BURN < 0:
            raise ValueError('config.AUTOSCALE_UP_BURN must be >= 0 '
                             '(0 disables the burn leg).')
        if self.AUTOSCALE_DOWN_IDLE_SECS < 0:
            raise ValueError('config.AUTOSCALE_DOWN_IDLE_SECS must be '
                             '>= 0.')
        if not 0.0 < self.AUTOSCALE_DOWN_UTILIZATION <= 1.0:
            raise ValueError('config.AUTOSCALE_DOWN_UTILIZATION must be '
                             'in (0, 1].')
        if self.AUTOSCALE_UP_COOLDOWN_SECS < 0 or \
                self.AUTOSCALE_DOWN_COOLDOWN_SECS < 0:
            raise ValueError('config.AUTOSCALE_*_COOLDOWN_SECS must be '
                             '>= 0.')
        if self.AUTOSCALE_FLAP_WINDOW_SECS <= 0:
            raise ValueError('config.AUTOSCALE_FLAP_WINDOW_SECS must be '
                             '> 0.')
        if self.AUTOSCALE_FLAP_LIMIT < 1:
            raise ValueError('config.AUTOSCALE_FLAP_LIMIT must be >= 1.')
        if not 0.0 <= self.SERVING_SLO_AVAILABILITY < 1.0:
            raise ValueError('config.SERVING_SLO_AVAILABILITY must be '
                             'in [0, 1) (0 disables; 1.0 would leave '
                             'no error budget to burn).')
        if self.SERVING_SLO_P99_MS < 0:
            raise ValueError('config.SERVING_SLO_P99_MS must be >= 0 '
                             '(0 disables the latency leg).')
        if self.SERVING_SLO_FAST_WINDOW_SECS <= 0 or \
                self.SERVING_SLO_SLOW_WINDOW_SECS <= 0:
            raise ValueError('config.SERVING_SLO_*_WINDOW_SECS must be '
                             '> 0.')
        if self.SERVING_SLO_FAST_WINDOW_SECS > \
                self.SERVING_SLO_SLOW_WINDOW_SECS:
            raise ValueError('config.SERVING_SLO_FAST_WINDOW_SECS must '
                             'not exceed SERVING_SLO_SLOW_WINDOW_SECS '
                             '(the fast window detects, the slow one '
                             'confirms).')
        if self.SERVING_SLO_BURN_THRESHOLD <= 0:
            raise ValueError('config.SERVING_SLO_BURN_THRESHOLD must '
                             'be > 0.')
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
        if self.MAX_DIVERGENCE_REWINDS < 0:
            raise ValueError('config.MAX_DIVERGENCE_REWINDS must be >= 0.')
        if self.HANG_WATCHDOG_SECS < 0:
            raise ValueError('config.HANG_WATCHDOG_SECS must be >= 0 '
                             '(0 disables the watchdog).')
        if self.FAULT_INJECT:
            # a typo'd spec fails at startup, naming the entry
            from code2vec_tpu_torch.resilience.faults import parse_spec
            parse_spec(self.FAULT_INJECT)
        if self.TELEMETRY_FLUSH_EVERY_STEPS < 1:
            raise ValueError(
                'config.TELEMETRY_FLUSH_EVERY_STEPS must be >= 1.')
        if self.TELEMETRY_TRACE_NUM_STEPS < 1:
            raise ValueError(
                'config.TELEMETRY_TRACE_NUM_STEPS must be >= 1.')
        if self.TRACING_SAMPLE_RATE > 1.0:
            raise ValueError('config.TRACING_SAMPLE_RATE must be in '
                             '[0, 1] (or < 0 for env/default fallback).')
        if self.TRACING_SLOW_MS < 0:
            raise ValueError('config.TRACING_SLOW_MS must be >= 0 '
                             '(0 disables latency tail retention).')
        if self.TRACING_FLIGHT_TRACES < 1:
            raise ValueError('config.TRACING_FLIGHT_TRACES must be >= 1.')
        if self.HBM_BUDGET_BYTES < -1:
            raise ValueError('config.HBM_BUDGET_BYTES must be >= -1 '
                             '(-1 = env fallback, 0 = unlimited).')
        if self.DEVICE_PEAK_FLOPS != -1.0 and self.DEVICE_PEAK_FLOPS <= 0:
            raise ValueError('config.DEVICE_PEAK_FLOPS must be > 0 '
                             '(-1 = env/device-table fallback).')
        if self.GOODPUT_ANOMALY_SIGMA < 0:
            raise ValueError('config.GOODPUT_ANOMALY_SIGMA must be >= 0 '
                             '(0 disables the anomaly watchdog).')
        if self.GOODPUT_AUTOCAPTURE_COOLDOWN_SECS < 0:
            raise ValueError(
                'config.GOODPUT_AUTOCAPTURE_COOLDOWN_SECS must be >= 0.')
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
