"""graftlint catalogs of the port: the reviewed invariants its rules check
the tree against — the counterpart of ``code2vec_tpu/analysis/catalog.py``.

Like ``telemetry/catalog.py`` and ``resilience/faults.py::FAULT_POINTS``,
each catalog is the single source of truth its rule lints the tree
against: adding a host sync, a graph capture, a kernel build or a pinned
buffer means adding an entry (with its reason) in the same diff, where
reviewers see it. README.md (the port's section) lists the rules.
"""
from __future__ import annotations

# --------------------------------------------------------- host syncs
# Sanctioned host-synchronization sites (rule ``host-sync``).  Keyed by
# (file, enclosing function qualname, kind); ``count`` pins the number
# of sites inside that function, so a NEW sync slipped into an already-
# sanctioned function still fails.  Kinds:
#   item        — x.item()
#   tolist      — x.tolist()
#   cpu         — x.cpu() / x.to('cpu'): a copy to the host that waits
#                 for the card
#   synchronize — torch.cuda.synchronize(), Event/Stream.synchronize()
#   fetch       — float/int/bool/np.asarray/.numpy() over a result on
#                 the card (a step's output, .cuda(), device=)
#
# Every entry carries the WHY: the contract that makes the wait right at
# that site.
SANCTIONED_SYNCS = (
    {'file': 'code2vec_tpu_torch/training/trainer.py',
     'func': 'Trainer._fit_loop.<locals>.sync', 'kind': 'cpu', 'count': 1,
     'reason': "the one sync a log window: the window's device losses "
               'come to the host together (its log line, the divergence '
               'guard and the epoch means read them), not one a step'},
    {'file': 'code2vec_tpu_torch/training/trainer.py',
     'func': 'Trainer._fit_loop.<locals>.preempt_now',
     'kind': 'item', 'count': 1,
     'reason': 'on a mesh of ranks, once a log window: the ranks agree on '
               'a pending preemption signal (an all_reduce MAX of one flag) '
               'so that all stop at one step'},
    {'file': 'code2vec_tpu_torch/training/trainer.py',
     'func': 'Trainer._fit_loop.<locals>.device_sync',
     'kind': 'synchronize', 'count': 1,
     'reason': 'profiler window close (--profile): the capture must hold '
               'the completed device work before it stops'},
    {'file': 'code2vec_tpu_torch/training/trainer.py',
     'func': 'PinnedPool.take', 'kind': 'synchronize', 'count': 1,
     'reason': 'the staging ring reuses a pinned buffer only after the '
               'event of the copy that read it completed (pinned-reuse); '
               'it waits only past `size` buffers in flight'},
    {'file': 'code2vec_tpu_torch/model_api.py',
     'func': 'Code2VecModel._agreed_steps', 'kind': 'item', 'count': 1,
     'reason': 'once an epoch on a mesh of ranks: the step count every '
               'rank can run (an all_reduce MIN), before the loop'},
    {'file': 'code2vec_tpu_torch/model_api.py',
     'func': 'Code2VecModel.get_vocab_embedding_as_np_array',
     'kind': 'cpu', 'count': 1,
     'reason': 'export path: a table to host numpy by contract (--save_w2v, '
               '--save_t2v), once'},
    {'file': 'code2vec_tpu_torch/model_api.py',
     'func': 'Code2VecModel.evaluate', 'kind': 'cpu', 'count': 1,
     'reason': 'once an evaluate() on a mesh: the metric counts summed over '
               'the data axis come to the host after the last batch'},
    {'file': 'code2vec_tpu_torch/checkpoints.py',
     'func': '_host', 'kind': 'cpu', 'count': 1,
     'reason': 'a save copies the state to the host by contract '
               '(torch.save of host tensors), once a checkpoint'},
    {'file': 'code2vec_tpu_torch/convert.py',
     'func': 'params_to_numpy', 'kind': 'cpu', 'count': 1,
     'reason': 'conversion to host numpy by contract (tests, exports, '
               'the index build), never on a step'},
    {'file': 'code2vec_tpu_torch/parallel/mesh.py',
     'func': 'Mesh.broadcast_object', 'kind': 'item', 'count': 1,
     'reason': "the broadcast object's byte length, needed on the host to "
               "size the receive buffer (the shell's turn on a mesh)"},
    {'file': 'code2vec_tpu_torch/parallel/mesh.py',
     'func': 'Mesh.broadcast_object', 'kind': 'cpu', 'count': 1,
     'reason': 'the broadcast bytes unpickled on the host, by contract'},
    {'file': 'code2vec_tpu_torch/parallel/mesh.py',
     'func': 'local_rows', 'kind': 'cpu', 'count': 1,
     'reason': "evaluate()'s per-batch outputs to the host for the metrics "
               'and log.txt, as the reference fetches them; the prefetch '
               'thread and the staging ring keep the next batch queued'},
    {'file': 'code2vec_tpu_torch/serving/bulk.py',
     'func': 'gather_outputs', 'kind': 'cpu', 'count': 1,
     'reason': 'the bulk feed returns host numpy (code vectors, top-k) by '
               'contract, one fetch a batch'},
    {'file': 'code2vec_tpu_torch/serving/engine.py',
     'func': 'ServingEngine._fill_idle_slot',
     'kind': 'synchronize', 'count': 1,
     'reason': "rollover: the idle slot's weights must be on the card "
               'before its graphs are captured or its canary replays; '
               'off the dispatch path'},
    {'file': 'code2vec_tpu_torch/serving/graphs.py',
     'func': 'GraphLadder.__init__', 'kind': 'synchronize', 'count': 1,
     'reason': "construction: slot 0's weights on the card before any "
               'capture'},
    {'file': 'code2vec_tpu_torch/serving/graphs.py',
     'func': 'GraphLadder.warm', 'kind': 'synchronize', 'count': 3,
     'reason': "warm-up, blocking by design: a new slot's copy, the card "
               'idle before the first capture, and the eager step that '
               'builds the kernels before it'},
    {'file': 'code2vec_tpu_torch/serving/graphs.py',
     'func': 'GraphLadder.launch', 'kind': 'fetch', 'count': 2,
     'reason': 'the CPU route only (not on_card): predict_step ran eagerly '
               'on the host, so .numpy() reads host tensors'},
    {'file': 'code2vec_tpu_torch/serving/graphs.py',
     'func': 'GraphLadder.replay_ms', 'kind': 'synchronize', 'count': 1,
     'reason': 'a measurement (CUDA events around replays), not a '
               'serving path'},
    {'file': 'code2vec_tpu_torch/serving/graphs.py',
     'func': 'GraphLadder.close', 'kind': 'synchronize', 'count': 1,
     'reason': 'close: the stream drained before the graphs and pools '
               'are dropped'},
    {'file': 'code2vec_tpu_torch/serving/graphs.py',
     'func': 'PinnedRing.acquire', 'kind': 'synchronize', 'count': 1,
     'reason': 'a pinned set is rewritten only after the event of its '
               'last copy completed (pinned-reuse); the dispatcher stages '
               'outside every lock'},
    {'file': 'code2vec_tpu_torch/serving/graphs.py',
     'func': 'Fetch.result', 'kind': 'synchronize', 'count': 1,
     'reason': "a decode worker waits for its dispatch's output copy, off "
               "the dispatcher thread: the engine's decode pool owns the "
               'blocking read'},
    {'file': 'code2vec_tpu_torch/index/exact.py',
     'func': 'ExactIndex.warmup', 'kind': 'cpu', 'count': 1,
     'reason': 'warm-up: each query bucket run once to its end'},
    {'file': 'code2vec_tpu_torch/index/exact.py',
     'func': 'ExactIndex.search', 'kind': 'cpu', 'count': 2,
     'reason': 'search returns host numpy (scores, indices) by contract; '
               'one round trip a query batch'},
    {'file': 'code2vec_tpu_torch/index/exact.py',
     'func': 'search_streamed', 'kind': 'cpu', 'count': 2,
     'reason': 'per-shard candidates to the exact host-side merge: the '
               'streamed tier merges on the host by design'},
    {'file': 'code2vec_tpu_torch/index/ivf.py',
     'func': 'kmeans', 'kind': 'cpu', 'count': 2,
     'reason': 'build path: centroids and assignments to host numpy after '
               'the Lloyd iterations, once an index build'},
    {'file': 'code2vec_tpu_torch/index/ivf.py',
     'func': 'IVFIndex.search', 'kind': 'cpu', 'count': 2,
     'reason': 'search returns host numpy (scores, ids) by contract; the '
               'probe map back through list_ids is host-side'},
    {'file': 'code2vec_tpu_torch/index/quant.py',
     'func': '_assign_chunks', 'kind': 'cpu', 'count': 1,
     'reason': 'build/insert path: the codes of one fixed-shape chunk land '
               'in a host CSR; queries never take this path'},
    {'file': 'code2vec_tpu_torch/index/quant.py',
     'func': 'train_pq', 'kind': 'cpu', 'count': 1,
     'reason': 'build path: the codebooks after each Lloyd iteration, once '
               'a PQ training pass'},
    {'file': 'code2vec_tpu_torch/index/quant.py',
     'func': 'QuantizedIVFIndex.search', 'kind': 'cpu', 'count': 2,
     'reason': 'search returns host numpy (scores, ids) by contract; the '
               'LUT top-k positions map back through list_ids and the '
               "segments' row ids host-side"},
    {'file': 'code2vec_tpu_torch/benchlib.py',
     'func': '_sync_card', 'kind': 'synchronize', 'count': 1,
     'reason': "the benchmark timer ends its region when the card's work "
               'does: a measurement, not a serving or training path'},
    {'file': 'code2vec_tpu_torch/benchlib.py',
     'func': 'bench_cuda_ms', 'kind': 'synchronize', 'count': 1,
     'reason': "a measurement: each replay's end event is waited on to "
               'read its elapsed time'},
)

# ------------------------------------------------- results on the card
# Calls whose RESULT lives on the card (taint sources of the 'fetch'
# kind): the steps.
DEVICE_ENTRY_POINTS = frozenset((
    'train_step', 'train_step_placed', 'eval_step', 'eval_step_placed',
    'predict_step',
))

# ----------------------------------------------------- warm shape sources
# Calls that launder a raw size into a warm-ladder shape (rule
# ``capture-hazard``): values returned here are sanctioned shape sources.
WARM_SHAPE_SOURCES = frozenset((
    'pick_bucket', '_pick_bucket', 'capacity_ladder', 'batch_ladder',
    'bucketed_capacity', 'pad_batch_to',
))

# Calls that pick a captured CUDA graph by its (bucket, rung) shape key
# (rule ``capture-hazard``): their shape arguments must be warm.
GRAPH_KEYED_CALLS = frozenset(('GraphKey', 'stage'))

# ------------------------------------------------------- warm-up sites
# Where a CUDA graph is captured (kind 'capture': ``capture_begin``,
# ``with torch.cuda.graph(...)``, ``make_graphed_callables``) or a kernel
# library is built (kind 'build': ``ops/_build.py::build``) — the port's
# compiles (rule ``capture-hazard``).  Both cost seconds and belong to a
# warm-up, never to a steady-state request or step.  ``count`` pins the
# sites in the function.
WARMUP_SITES = (
    {'file': 'code2vec_tpu_torch/serving/graphs.py',
     'func': 'GraphLadder._capture', 'kind': 'capture', 'count': 1,
     'reason': 'the serving ladder\'s capture, called only by '
               'GraphLadder.warm (the engine\'s warmup, and a second '
               'slot\'s capture at the first rollover of a one-slot '
               'engine); captures after warm-up are counted and '
               'checked to stay 0'},
    {'file': 'code2vec_tpu_torch/ops/_build.py',
     'func': 'load', 'kind': 'build', 'count': 1,
     'reason': 'a kernel library\'s first use in a process builds it when '
               'it is missing (the engine\'s warm-up step and the first '
               'train step reach it; chip_smoke.py builds every kernel '
               'before its phases); later uses load nothing'},
    {'file': 'code2vec_tpu_torch/benchlib.py',
     'func': 'bench_cuda_ms', 'kind': 'capture', 'count': 1,
     'reason': 'a measurement: the timed function captured once and '
               'replayed between CUDA events; never on a serving or '
               'training path'},
)

# ------------------------------------------------------ pinned buffers
# Functions that allocate pinned host memory (rule ``pinned-reuse``):
# each is a pool that hands its buffers out again only after the event
# of the copy that last read them completed.  ``count`` pins the sites.
PINNED_ALLOCATORS = (
    {'file': 'code2vec_tpu_torch/training/trainer.py',
     'func': 'PinnedPool.take', 'count': 1,
     'reason': 'the staging ring\'s buffers, one ring a (slot, shape, '
               'dtype); reused by take() after their copy\'s event'},
    {'file': 'code2vec_tpu_torch/serving/graphs.py',
     'func': 'PinnedRing.make', 'count': 1,
     'reason': 'the serving ladder\'s input and output sets, depth a key; '
               'reused by acquire() after their last copy\'s event'},
)

# Functions that hand a REUSED pinned buffer out (rule ``pinned-reuse``):
# each must wait (``.synchronize()``) on the event of the buffer's last
# copy before returning it, or the host rewrites the buffer under an
# asynchronous copy still reading it.
PINNED_REUSERS = (
    {'file': 'code2vec_tpu_torch/training/trainer.py',
     'func': 'PinnedPool.take',
     'reason': 'the staging ring: the oldest buffer of a ring comes back '
               'after its copy\'s event'},
    {'file': 'code2vec_tpu_torch/serving/graphs.py',
     'func': 'PinnedRing.acquire',
     'reason': 'the serving ladder: a free set comes back after its last '
               'copy\'s event'},
)
