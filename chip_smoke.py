#!/usr/bin/env python3
"""Smoke run of the PyTorch port (code2vec_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. device — requires ``torch.cuda.is_available()``; prints the card's name
   and power limit (nvidia-smi);
2. build — compiles every hand-written kernel from the sources in this
   checkout into build/kernels/ (one nvcc per source, in parallel);
3. kernels — at the java14m width (d 128/128, D 384, B 1024, context counts
   with median ~28 and max 200, empty rows and interior holes), holds each
   kernel against its plain PyTorch version on the card, fp32 and bf16,
   and times both with CUDA events; the ragged forward also at the edges
   of its 64-slot tiles (examples of 0, 1, 63, 64, 65 and 200 slots, some
   starting at a tile edge, a partial last tile, interior holes, a tile
   whose every slot is invalid, two shards with slots past a shard's
   total, fp32 masters and bf16 tables with and without the keep mask, K
   and D of 128 and 256), its plan kernel's pair map against ``_pair_map``;
4. serving — ``Code2VecModel(device='cuda')`` at the java14m width (vocab
   1,301,136 / 911,417 / 261,245 synthetic words, weights from a seed, bf16
   compute) answers ``predict`` at batch buckets 8, 64 and 1024 on the
   topk, attention and vectors tiers. Launch counts are zeroed just before
   and read just after; every call must go through the ragged kernel and
   no other, and no operation of the path may run on the CPU; then
   ``ops/topk.py::top_k`` on tied logits against a numpy rule of
   ``lax.top_k``'s order, and what it costs the predict step at each
   bucket against ``torch.topk``;
5. reference — a small model on the card against the same weights on the
   CPU (plain versions): same top-k words, close scores and attention;
   then ``Code2VecModel.evaluate()`` over a 4,096-line synthetic
   ``.test.c2v`` (4 batches of 1024, working directory build/smoke/,
   where its log.txt lands): one ragged launch per batch;
6. plane wire — the same weights with ``BATCH_WIRE_FORMAT='planes'`` and
   ``USE_PALLAS_FUSED_ENCODE``: the fused context-transform kernel against
   its plain version at B 1024 x 200 contexts (rows without a valid
   context, all-PAD slots, row counts ending inside a tile or under one
   tile, and the other code dims on small inputs), fp32 and bf16, timed
   beside the plain version and the cuBLAS route; predict at
   the three buckets and tiers and ``evaluate()``, each call or batch one
   encode launch and no other kernel, no CPU op; predict on the packed
   wire with ``USE_PALLAS_RAGGED_FUSION=False`` (unpacked on the card,
   then one encode launch); a small model evaluated in fp32 on the card
   and on the CPU: equal metrics and log.txt, close loss;
7. train kernels — at the java14m training shape (B 1024, fp32 master
   tables, dropout keep 0.75, target table 262,144 rows) holds the ragged
   forward in training mode, the ragged backward, and the CE forward and
   backward against their plain versions, fp32 and bf16, each part of a
   gradient on its own scale (the CE backward's label rows, other rows and
   softmax-only dcode; the ragged backward's de per example, and its de and
   dW against a float64 reference fed the kernel's own du), each also at
   the edges of its tiling: the ragged backward on streams with examples
   of 0, 1, 63, 64 and 65 slots, a partial last 64-slot tile, interior
   holes, bf16 tables without a mask over two shards, and K, D of 128 and
   256; the CE forward and backward at B 1000, labels at and past
   num_valid, num_valid inside a block, code dims 128 and 256. Times them
   beside the materialized-logits route (cuBLAS) for the CE rows, and the
   ragged forward at the training shape beside its own bound;
7b. optimizer kernels — the fused Adam kernel (``ops/csrc/adam.cu``)
   against its plain version on the card, bit for bit over every element
   of every java14m parameter, for each of the eight gradient x mu x nu
   dtype combinations, and on edge inputs (a length that is not a multiple
   of 8, streams one element past alignment and at offsets that never
   align together, steps 1 and 2, zero, +-3e38 and NaN gradients, updates
   that round to a signed zero); timed beside its bound, the plain version
   and, for fp32 moments, ``torch.optim.Adam(fused=True)``; lazy Adam's row
   kernel against its plain version over the token rows of a real packed
   batch plus one row listed 20,000 times (untouched rows keep their
   bits), timed beside ``torch.optim.SparseAdam``;
8. train — a ``Trainer`` at java14m width (USE_PALLAS_FUSED_CE, bf16, keep
   0.75) takes 20 steps on one pre-packed batch plus one under the CPU-op
   watch: the loss falls, every step launches each of the four kernels
   once and the Adam kernel once a parameter, no operation runs on the
   CPU; then a few steps with materialized logits, a step-time breakdown
   (forward, backward, Adam); then one short java14m phase per optimizer
   knob (LAZY_EMBEDDING_ADAM, GRADS_DTYPE='bfloat16', EMBED_GRAD_IMPL
   'sorted' and 'dedup', REMAT_ENCODE): the loss falls, no CPU op and no
   host sync on the steps, the expected launches (lazy: Adam once for each
   of the three dense parameters, the row kernel once a table), the step
   ms, whether the table gradients repeat bit for bit from one state, and
   under lazy Adam the PAD rows move on a batch whose only route to them is
   ``packed_rows``' append;
9. train entry — ``Code2VecModel(device='cuda').train()`` over a synthetic
   ``.train.c2v`` at java14m width, then a predict with the trained weights;
10. train reference — a small-vocabulary model at full width trains three
   steps on the card and on the CPU (plain versions) from the same weights
   and batches at keep 1.0, in fp32 and in bf16 (three draws of batches,
   each from its own generator): losses, Adam moments and weights agree;
11. checkpoints — at java14m width and vocabulary with the fused CE,
   ``Code2VecModel.train()`` saves after each of three short epochs
   (MAX_TO_KEEP=2, the oldest step removed), in a temporary directory under
   build/smoke/ that it removes: the newest step restores equal to the
   trained state, a params-only reload evaluates and predicts bit for bit
   as the model in memory, the release holds no moments and loads under the
   plain route's 261,248 target rows, and a resumed model's next epoch
   agrees with the model continued in memory within the bf16 train
   reference's limits (the table gradients' atomic adds differ in order);
   prints the save, restore and release times with GB and GB/s;
12. CLI — ``code2vec_tpu_torch.cli.main`` in process on the card: train
   with --fused-ce and --save, --load --test, --release, --save_word2v, at
   full width over a 5,000 / 3,000 / 1,000-word vocabulary;
13. host pipeline (after phase 5's evaluate) — the native tokenizer built
   with g++ (timed) and held equal to the Python reader on the 4,096 test
   lines; each reader's host ms per batch of 1024; ``evaluate()`` with the
   native reader and the staging ring against READER_USE_NATIVE=False:
   equal metrics and log.txt; for each the seconds, host read, device
   step, decode and the card's idle share; the staging ring at depths 0,
   2 and 4 over the same batches: each batch as the step's stream reads
   it equals its host arrays, the eval outputs are equal across depths;
14. train pipeline (after phase 9) — ``train()`` at java14m width and
   vocabulary (fused CE, bf16, keep 0.75) over a 32,768-line split: two
   epochs from the token cache, one with TRAIN_DATA_CACHE=False (native
   tokenizer and prefetch thread); the cache's build seconds and bytes,
   each epoch's median step interval (CUDA events) and median wait for the
   next staged batch beside a repeated-batch step; every step launches
   the four training kernels once; the staged host buffers are pinned;
15. source to shell (last) — the extractor built from extractor/src,
   Java files from scripts/gen_java_corpus.py, data/extract_driver.py and
   data/preprocess.py as subprocesses, then ``cli.main`` on the card: train
   one epoch at full width over the preprocessed vocabulary, ``--load
   --test``, and ``--predict`` with the shell's input scripted (one file,
   then exit): the turn launches the ragged forward once and no other
   kernel; prints the predicted names.

14b. dense routes (after phase 14, over its split and token cache) —
   ``Code2VecModel.train()`` at java14m width and vocabulary (fused CE,
   bf16, keep 0.75) on the plane wire (``--wire-format planes``, 64
   steps) and on the packed wire unpacked on the card
   (``--no-ragged-fusion``, 32 steps): every step launches ``ce_fwd`` and
   ``ce_bwd`` once and Adam once a parameter, no ragged or encode kernel;
   the plane wire's loss falls; each route's step interval, and its step
   on one repeated batch beside the packed ragged route's (CUDA events);
   the CE kernels' device ms as the plane step launches them
   (torch.profiler); one plane step at keep 1.0 through the CE kernels
   against the same step with the CE's plain versions (loss and every
   gradient part, the bf16 train reference's limits); a java14m step
   snapshot's save and rewind seconds;
12b. resilience drills (after phase 12) — full width over a 5,000 /
   3,000 / 1,000-word vocabulary, 4 steps an epoch, on the packed wire's
   kernels: ``nan_loss`` with step snapshots (one rewind, finite losses
   after), ``sigterm`` (a snapshot and PREEMPTED.json, a resume that goes
   on from its step, ``metrics.jsonl`` with ``train/loss`` under -tb),
   ``corrupt_snapshot`` (the restore falls back a step and quarantines
   the corrupt one), and ``hang_input`` under ``--watchdog-secs`` in a CLI
   subprocess, which ends by SIGABRT with ``watchdog_stacks.txt`` naming
   the hung frame;

16. serving engine (after phase 13, on phase 4's model; the plane-wire
   engine after phase 6's evaluate) — two checkpoints of the weights
   saved under build/smoke/ (removed after) for the engine's param source;
   ``model.serving_engine()`` captures the default ladder (buckets 8, 64,
   512, 1024 x their capacity rungs x tiers topk, attention, full x two
   parameter slots: 138 CUDA graphs; warm seconds, the shared pool's
   bytes); the engine against ``Code2VecModel.predict`` bit for bit at
   each bucket and tier on light, java14m and heavy rows with count-0
   and all-PAD rows, then the same cases in a shuffled key order; one
   bucket-8 request's p50 through both; 8 caller threads for 5 s (topk,
   then mixed tiers): requests/s, rows/s, p50/p99, mean fill, the card's
   idle share, no capture after warm-up, beside the naive ``predict``
   loop over the same requests (the engine must not be slower); a
   torch.profiler trace of dispatches naming the ragged forward's
   kernels; rollover to a saved step (swap), to a perturbed set
   (rollback) and a vectors-only canary on a second engine (timeout), no
   capture, results during each canary equal the serving slot's; the
   overload drill (``slow_dispatch``, bound 8 rows, 60 ms deadline:
   typed sheds and expiries, admitted results bit for bit); and
   ``close(drain=True)``. On the plane wire: one slot, the same parity,
   2 s of load and a trace naming the encode kernel.

Phase 5's and the later ``evaluate()`` and ``train()`` calls read through
the native tokenizer (and ``train()`` from the token cache), the defaults.

Prints a JSON line with each kernel's numbers (``launches_by_path``: its
launches on each main path, the checkpoint, CLI, host data path
(``eval_native``, ``train_cache``, ``train_native``), source and shell
(``repl``) paths among them, ``train_<knob>`` for the optimizer knobs, and
``train_planes``/``train_unpack`` the dense routes', ``resilience`` the
drills', ``engine``/``engine_planes``: the engine's warm-up runs and
captures;
``graph_replays_by_path``: the engine's replays of graphs that hold the
kernel, which no launch counter sees), the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import pickle
import re
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SMOKE_DIR = ROOT / 'build' / 'smoke'
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
PEAK_FLOPS = {'bfloat16': 989e12,   # dense tensor cores
              'float32': 67e12}     # fp32 outside the tensor cores
BUCKETS = ((8, 5), (64, 50), (1024, 1000))   # (bucket, lines sent)
TIERS = ('topk', 'attention', 'vectors')
TRAIN_STEPS = 20


def check(condition: bool, message: str) -> None:
    if not condition:
        raise RuntimeError('chip_smoke: ' + message)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device milliseconds of ``fn()``: captured once in a CUDA graph
    and replayed, so the Python of the wrapper around a kernel does not
    leave the card idle inside the timed window."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def eager_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of one eager call, host work included."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


SUBTOKENS = ('get', 'set', 'is', 'to', 'add', 'run', 'make', 'read')


def target_word(i: int) -> str:
    """Synthetic method name i: letters only, two subtokens joined by
    ``|`` (a legal prediction, with subtokens that other names share)."""
    j, letters = i // len(SUBTOKENS), ''
    while True:
        j, r = divmod(j, 26)
        letters = chr(ord('a') + r) + letters
        if j == 0:
            return SUBTOKENS[i % len(SUBTOKENS)] + '|' + letters


def write_dict(path: Path, n_tokens: int, n_paths: int,
               n_targets: int) -> None:
    """A ``.dict.c2v`` of synthetic words t<i>, p<i> and target_word(i),
    counts descending so the vocab order is the index order."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, 'wb') as f:
        for words in (['t%d' % i for i in range(n_tokens)],
                      ['p%d' % i for i in range(n_paths)],
                      [target_word(i) for i in range(n_targets)]):
            pickle.dump({w: len(words) - i for i, w in enumerate(words)}, f)
        pickle.dump(0, f)


def context_counts(rng, batch: int, max_contexts: int) -> np.ndarray:
    """java14m-like fill: median ~28, a tail up to max_contexts."""
    counts = np.exp(rng.normal(math.log(28.0), 0.8, batch))
    counts = np.clip(np.rint(counts), 1, max_contexts).astype(np.int64)
    counts[rng.choice(batch, 4, replace=False)] = max_contexts
    return counts


def make_lines(rng, n: int, vocab_sizes, max_contexts: int,
               counts=None) -> list:
    """``n`` lines of random words at the java14m fill, or with the given
    context ``counts``."""
    n_tok, n_path, n_tgt = vocab_sizes
    lines = []
    if counts is None:
        counts = context_counts(rng, n, max_contexts)
    for count in counts:
        src = rng.integers(0, n_tok, count)
        pth = rng.integers(0, n_path, count)
        tgt = rng.integers(0, n_tok, count)
        ctxs = ' '.join('t%d,p%d,t%d' % triple
                        for triple in zip(src, pth, tgt))
        lines.append('%s %s' % (target_word(int(rng.integers(0, n_tgt))),
                                ctxs))
    return lines


def plane_batch(rng, batch: int, max_contexts: int, token_rows: int,
                path_rows: int, token_pad: int, path_pad: int, counts=None):
    """One plane batch at the serving shape: random indices, a few empty
    rows (no valid context), ~3% interior all-PAD holes; or the given
    per-example ``counts`` (with the same holes)."""
    from code2vec_tpu_torch.data.reader import Batch, context_valid_mask
    if counts is None:
        counts = context_counts(rng, batch, max_contexts)
        counts[rng.choice(batch, 8, replace=False)] = 0
    source = rng.integers(1, token_rows, (batch, max_contexts))
    path = rng.integers(1, path_rows, (batch, max_contexts))
    target = rng.integers(1, token_rows, (batch, max_contexts))
    cols = np.arange(max_contexts)[None, :]
    dead = cols >= counts[:, None]
    dead |= (rng.random((batch, max_contexts)) < 0.03) & (
        cols < counts[:, None] - 1)
    source[dead] = token_pad
    target[dead] = token_pad
    path[dead] = path_pad
    source, path, target = (a.astype(np.int32) for a in (source, path,
                                                         target))
    mask = context_valid_mask(source, path, target, token_pad, path_pad)
    return Batch(source=source, path=path, target=target, mask=mask,
                 label=np.zeros(batch, np.int32),
                 weight=np.ones(batch, np.float32))


def kernel_batch(rng, batch: int, max_contexts: int, token_rows: int,
                 path_rows: int, token_pad: int, path_pad: int):
    """``plane_batch`` packed onto the wire."""
    from code2vec_tpu_torch.data import packed as packed_lib
    return packed_lib.pack_batch(
        plane_batch(rng, batch, max_contexts, token_rows, path_rows,
                    token_pad, path_pad), token_pad, path_pad)


def worst(*values) -> float:
    """The largest of ``values``, NaN if any is NaN (Python's ``max``
    drops a NaN that is not first)."""
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def max_err(got, want) -> float:
    return worst(*(float((g - w).abs().max()) for g, w in zip(got, want)))


def kernel_phase(model, rng, gpu: str) -> dict:
    """Hold the ragged kernel against its plain version at the serving
    shape; returns the kernel's JSON record (launches filled in later)."""
    import torch
    from code2vec_tpu_torch.ops import ragged
    backend = model.backend
    config = model.config
    tpad, ppad = backend.token_pad_index, backend.path_pad_index
    packed = kernel_batch(rng, 1024, config.MAX_CONTEXTS,
                          model.vocabs.token_vocab.size,
                          model.vocabs.path_vocab.size, tpad, ppad)
    ctx = torch.from_numpy(packed.ctx).cuda()
    count = torch.from_numpy(packed.count).cuda()
    retained = int(packed.count.sum())
    segs = ragged._segment_inputs(ctx, count, tpad, ppad)
    fwd_record = None
    for dtype, params in (('float32', backend.params),
                          ('bfloat16', backend.compute_params)):
        tdtype = getattr(torch, dtype)
        args = (params.token_embedding, params.path_embedding,
                params.transform, params.attention.reshape(-1))
        kernel_stats = ragged._stats_kernel(*args, segs, tpad, ppad)
        plain_stats = ragged._stats_plain(*args, segs, tpad, ppad)
        kw = dict(max_contexts=config.MAX_CONTEXTS, token_pad=tpad,
                  path_pad=ppad, dtype=tdtype)
        full_args = (params.token_embedding, params.path_embedding,
                     params.transform, params.attention, ctx, count)
        kernel_out = ragged.ragged_encode(*full_args, **kw)
        plain_out = ragged.ragged_encode(*full_args, plain=True, **kw)
        torch.cuda.synchronize()
        for name, g, w in zip(('scores', 'm', 'z', 'acc'), kernel_stats,
                              plain_stats):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5,
                                       msg=lambda m, n=name: '%s %s: %s' % (
                                           dtype, n, m))
        if dtype == 'float32':
            torch.testing.assert_close(kernel_out, plain_out, rtol=1e-4,
                                       atol=1e-5)
        else:
            torch.testing.assert_close(kernel_out, plain_out, rtol=0,
                                       atol=1e-2)
        for t in kernel_out:
            check(bool(torch.isfinite(t).all()), 'non-finite kernel output')
        err = max_err(kernel_out, plain_out)
        edge_errs = ragged_fwd_edge_cases(backend.params, dtype, tpad, ppad)
        print('kernel ragged_fwd %s edge cases (scores, m, z, acc within '
              'rtol 1e-4, atol 1e-5): max |diff| %s [%s]'
              % (dtype, {k: float('%.3g' % v) for k, v in edge_errs.items()},
                 gpu))
        run_kernel = lambda: ragged._stats_kernel(*args, segs, tpad, ppad)
        run_plain = lambda: ragged._stats_plain(*args, segs, tpad, ppad)
        ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_plain)
        # second reading in the other order: the spread of the two
        plain_ms2, ms2 = cuda_ms(run_plain), cuda_ms(run_kernel)
        eager = eager_ms(run_kernel)
        # least work: each input read once, each output written once
        elt = 2 if dtype == 'bfloat16' else 4
        k_dim, d_code = params.transform.shape
        batch = count.numel()
        bytes_moved = (retained * (k_dim * elt + 12)       # rows + triples
                       + (k_dim + 1) * d_code * elt        # W, attention
                       + ctx.shape[1] * 4                  # scores
                       + batch * (2 + d_code) * 4)         # m, z, acc
        flops = retained * (2 * k_dim * d_code + 4 * d_code)
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        print('kernel ragged_fwd %s: B=%d slots=%d max_abs_err=%.3g '
              'kernel %.4f/%.4f ms, plain %.4f/%.4f ms (device, graph '
              'replay, two readings), kernel eager call %.4f ms, bound '
              '%.4f ms (%s) [%s]'
              % (dtype, batch, retained, err, ms, ms2, plain_ms, plain_ms2,
                 eager, max(t_bytes, t_ops),
                 'bytes' if t_bytes >= t_ops else 'operations', gpu))
        if dtype == 'bfloat16':    # the serving path's compute dtype
            fwd_record = record(
                'ragged_fwd', 'code2vec_tpu_torch/ops/csrc/ragged_fwd.cu',
                'code2vec_tpu/ops/pallas_ragged.py:150', err, ms, plain_ms,
                max(t_bytes, t_ops),
                'bytes' if t_bytes >= t_ops else 'operations', None)
    return fwd_record


def library_encode(src, pth, tgt, w, attn):
    """One cuBLAS route over the concatenated rows, in the compute dtype:
    what the reference computes outside its TPU kernel."""
    import torch
    x = torch.tanh(torch.cat([src, pth, tgt], dim=1) @ w)
    return x, x @ attn


# encode kernel against its plain version, each output on its own scale
# (max |diff| over max |plain|). Both sum exact products of the same
# inputs in fp32 (the bf16 products are exact in fp32, the plain version
# runs fp32 cuBLAS with TF32 off), so they differ only in the order of a
# 384-term sum, ~1e-6 of the scale; a wrong tile, chunk or tail row reads
# at the full scale.
ENCODE_LIMIT = 1e-4


def encode_kernel_phase(model, rng, gpu: str) -> dict:
    """Holds the fused context-transform kernel against its plain version
    at the plane wire's shape (B 1024 x 200 contexts, every slot: rows
    with no valid context, all-PAD slots, holes), fp32 and bf16, plus row
    counts that end inside a tile or stay under one and the kernel's
    other code dims (128, 256) on small inputs; times it beside the plain
    version and the library route. Returns the bf16 (main path) JSON record."""
    import torch
    from code2vec_tpu_torch.ops import encode
    backend = model.backend
    config = model.config
    tpad, ppad = backend.token_pad_index, backend.path_pad_index
    batch = plane_batch(rng, config.TEST_BATCH_SIZE, config.MAX_CONTEXTS,
                        model.vocabs.token_vocab.size,
                        model.vocabs.path_vocab.size, tpad, ppad)
    check(int((batch.mask.sum(axis=1) == 0).sum()) == 8,
          'the kernel batch has no row without a valid context')
    planes = [torch.from_numpy(a).cuda().long().reshape(-1)
              for a in (batch.source, batch.path, batch.target)]
    n = planes[0].numel()
    record_out = None
    for dtype, params in (('float32', backend.params),
                          ('bfloat16', backend.compute_params)):
        tdtype = getattr(torch, dtype)
        rows = (params.token_embedding[planes[0]].to(tdtype),
                params.path_embedding[planes[1]].to(tdtype),
                params.token_embedding[planes[2]].to(tdtype))
        w = params.transform.to(tdtype)
        attn = params.attention.to(tdtype)
        args = rows + (w, attn)
        errs = {}
        # row counts ending inside the bf16 kernel's 128-row tile: in the
        # second consumer's 64 rows (n - 13 = 1,599 x 128 + 115), in the
        # first consumer's (1,000 x 128 + 37: the second has no row), and
        # fewer rows than one tile
        for label, cut in (('all rows', n), ('tail', n - 13),
                           ('first half of a tile', 128 * 1000 + 37),
                           ('under one tile', 100)):
            part = tuple(r[:cut] for r in rows) + (w, attn)
            got = encode._transform_kernel(*part)
            want = encode._transform_plain(*part)
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(t).all()) for t in got),
                  'non-finite encode kernel output')
            for name, g, v in zip(('x', 'scores'), got, want):
                check(g.shape == v.shape and g.dtype == torch.float32,
                      'encode %s %s: shape %s dtype %s'
                      % (dtype, name, tuple(g.shape), g.dtype))
                errs['%s %s' % (label, name)] = scaled_err([g], [v])
            if label == 'all rows':
                abs_err = max_err(got, want)
            del got, want
        # the kernel's other instantiations (code dims 128 and 256), at a
        # row count ending inside a tile
        for d_code in (128, 256):
            small = [torch.from_numpy(rng.uniform(-0.3, 0.3, shape).astype(
                np.float32)).cuda().to(tdtype) for shape in (
                    (1000, 64), (1000, 32), (1000, 64), (160, d_code),
                    (d_code, 1))]
            got = encode._transform_kernel(*small)
            want = encode._transform_plain(*small)
            torch.cuda.synchronize()
            for name, g, v in zip(('x', 'scores'), got, want):
                errs['D=%d %s' % (d_code, name)] = scaled_err([g], [v])
        err = worst(*errs.values())
        check(err <= ENCODE_LIMIT, 'encode %s disagrees with its plain '
              'version: scaled errors %s, limit %.3g'
              % (dtype, errs, ENCODE_LIMIT))
        run_kernel = lambda: encode._transform_kernel(*args)
        run_plain = lambda: encode._transform_plain(*args)
        run_library = lambda: library_encode(*rows, w, attn)
        ms, plain_ms, lib_ms = (cuda_ms(run_kernel), cuda_ms(run_plain),
                                cuda_ms(run_library))
        # second reading in the other order: the spread
        lib_ms2, plain_ms2, ms2 = (cuda_ms(run_library), cuda_ms(run_plain),
                                   cuda_ms(run_kernel))
        elt = 2 if dtype == 'bfloat16' else 4
        k_dim, d_code = w.shape
        b_ms, b_by = bound(n * k_dim * elt                  # the three rows
                           + (k_dim + 1) * d_code * elt     # W, attention
                           + n * (d_code + 1) * 4,          # x, scores
                           2.0 * n * (k_dim + 1) * d_code, dtype)
        print('kernel encode %s: N=%d rows (B=%d x C=%d, %d rows without a '
              'valid context) K=%d D=%d max_abs_err=%.3g, scaled errors %s '
              '(limit %.3g) kernel %.4f/%.4f ms, plain %.4f/%.4f ms, library '
              '(cat + cuBLAS + tanh + score) %.4f/%.4f ms (device, graph '
              'replay, two readings), bound %.4f ms (%s) [%s]'
              % (dtype, n, batch.source.shape[0], batch.source.shape[1],
                 int((batch.mask.sum(axis=1) == 0).sum()), k_dim, d_code,
                 abs_err, {k: float('%.3g' % v) for k, v in errs.items()},
                 ENCODE_LIMIT, ms, ms2, plain_ms, plain_ms2, lib_ms, lib_ms2,
                 b_ms, b_by, gpu))
        if dtype == 'bfloat16':     # the serving and eval compute dtype
            record_out = record(
                'encode', 'code2vec_tpu_torch/ops/csrc/encode.cu',
                'code2vec_tpu/ops/pallas_encode.py:49', abs_err, ms,
                plain_ms, b_ms, b_by, lib_ms)
        del rows, args
        torch.cuda.empty_cache()
    return record_out


class CpuOpWatch:
    """Records every tensor operation that computes on the CPU: all its
    tensor outputs on the CPU, a CPU tensor among its inputs or no inputs
    at all, and an output that is not a view of an input (wrapping a
    host array, as ``torch.from_numpy`` does, computes nothing) and holds
    an element (``torch.utils.checkpoint`` makes a 0-element CPU tensor as
    an autograd anchor: nothing is computed). Copies to and from the card
    pass."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves
        watch = self
        self.cpu_ops = []

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                import torch
                ins = [t for t in tree_leaves((args, kwargs or {}))
                       if isinstance(t, torch.Tensor)]
                outs = [t for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor)]
                in_storages = {t.untyped_storage().data_ptr() for t in ins}
                if outs and all(t.device.type == 'cpu' for t in outs) and (
                        not ins or any(t.device.type == 'cpu' for t in ins)
                ) and not all(t.untyped_storage().data_ptr() in in_storages
                              for t in outs) and any(t.numel() for t in outs):
                    watch.cpu_ops.append(str(func))
                return out

        self.mode = _Mode()


def serving_phase(model, rng, gpu: str, kernel: str = 'ragged_fwd',
                  buckets=BUCKETS) -> int:
    """The main path: predict at each bucket on three tiers; every call
    must launch ``kernel`` once and no other kernel. Returns ``kernel``'s
    launches in this run."""
    import torch
    config = model.config
    route = '%s wire, %s' % (config.BATCH_WIRE_FORMAT, kernel)
    sizes = (model.vocabs.token_vocab.size - 1,
             model.vocabs.path_vocab.size - 1,
             model.vocabs.target_vocab.size - 1)
    k = config.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION
    zero_counts()
    calls = 0

    def predict(lines, tier):
        nonlocal calls
        before = launch_counts()
        results = model.predict(lines, tier=tier)
        after = launch_counts()
        calls += 1
        launched = {name: after[name] - before[name] for name in after}
        check(launched == {name: int(name == kernel) for name in after},
              'predict(%s, %d lines) on the %s route launched %s'
              % (tier, len(lines), route, launched))
        return results

    for bucket, n_lines in buckets:
        lines = make_lines(rng, n_lines, sizes, config.MAX_CONTEXTS)
        for tier in TIERS:
            for rep in range(2):
                t0 = time.perf_counter()
                results = predict(lines, tier)
                latency = (time.perf_counter() - t0) * 1e3
                check(len(results) == n_lines, 'wrong result count')
                for r in results:
                    if tier == 'vectors':
                        check(r.code_vector.shape == (config.CODE_VECTOR_SIZE,)
                              and np.isfinite(r.code_vector).all(),
                              'bad code vector')
                        continue
                    check(len(r.topk_predicted_words) == k
                          and r.topk_predicted_words_scores.shape == (k,)
                          and np.isfinite(r.topk_predicted_words_scores).all(),
                          'bad top-k')
                    check(abs(float(r.topk_predicted_words_scores.sum())
                              - 1.0) < 1e-3, 'top-k scores do not sum to 1')
                    if tier == 'attention':
                        values = list(r.attention_per_context.values())
                        check(values and np.isfinite(values).all(),
                              'bad attention')
                if rep == 1:
                    print('serving (%s) predict tier=%s bucket=%d lines=%d: '
                          '%.3f ms [%s]' % (route, tier, bucket, n_lines,
                                            latency, gpu))
        if bucket == 64:
            watch = CpuOpWatch()
            with torch.no_grad(), watch.mode:
                for tier in TIERS:
                    predict(lines, tier)
            check(not watch.cpu_ops,
                  'CPU operations on the serving path (%s): %s'
                  % (route, sorted(set(watch.cpu_ops))))
    launches = launch_counts()[kernel]
    check(launches == calls, '%s launched %d times in %d predict calls'
          % (kernel, launches, calls))
    print('serving (%s): %d predict calls, %d %s launches (1 per predict, '
          'every bucket; no other kernel; no CPU op at bucket 64) [%s]'
          % (route, calls, launches, kernel, gpu))
    return launches


def breakdown_phase(model, rng, gpu: str) -> None:
    """Where a bucket-1024 predict call spends its time: host tokenize,
    host pack (packed wire), device predict step per tier (graph replay),
    host decode."""
    import torch
    from code2vec_tpu_torch.data import packed as packed_lib
    from code2vec_tpu_torch.serving import engine as engine_lib
    from code2vec_tpu_torch.serving.steps import predict_step
    wire_format = model.config.BATCH_WIRE_FORMAT
    sizes = (model.vocabs.token_vocab.size - 1,
             model.vocabs.path_vocab.size - 1,
             model.vocabs.target_vocab.size - 1)
    lines = make_lines(rng, 1000, sizes, model.config.MAX_CONTEXTS)
    t0 = time.perf_counter()
    batch = model.reader.pad_batch_to(model.reader.process_input_rows(lines),
                                      1024)
    t1 = time.perf_counter()
    wire = batch
    if wire_format == 'packed':
        wire = packed_lib.pack_batch(batch, model.backend.token_pad_index,
                                     model.backend.path_pad_index)
    t2 = time.perf_counter()
    arrays = tuple(torch.from_numpy(a).cuda() for a in wire.device_arrays())
    device_ms = {tier: cuda_ms(lambda tier=tier: predict_step(
        model.backend, arrays, tier=tier)) for tier in TIERS}
    out = predict_step(model.backend, arrays, tier='attention')
    fetched = {key: value.cpu().numpy() for key, value in out.items()}
    t3 = time.perf_counter()
    engine_lib.decode_results(fetched, batch, len(lines),
                              model._target_index_to_word)
    t4 = time.perf_counter()
    print('breakdown (%s wire) bucket=1024 lines=1000 valid contexts=%d: '
          'host tokenize+pad %.1f ms, host pack %.1f ms, device predict '
          'step %s, host decode (attention) %.1f ms [%s]'
          % (wire_format, int(batch.mask.sum()), (t1 - t0) * 1e3,
             (t2 - t1) * 1e3,
             ', '.join('%s %.4f ms' % kv for kv in device_ms.items()),
             (t4 - t3) * 1e3, gpu))


def topk_reference(x: np.ndarray, k: int) -> np.ndarray:
    """lax.top_k's indices in plain numpy: IEEE total order (+0.0 above
    -0.0; the fp32 bits as an int, the magnitude bits flipped when
    negative), descending, the lower index first among equal values (a
    stable sort)."""
    bits = x.astype(np.float32).view(np.int32).astype(np.int64)
    key = np.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return np.argsort(-key, axis=-1, kind='stable')[..., :k]


def topk_phase(model, rng, gpu: str) -> None:
    """``ops/topk.py::top_k`` on the card against topk_reference (the
    card has no JAX): bf16-rounded logits at the java14m target width
    (ties in the top ten of most rows), k above the valid vocabulary over
    -1e9 padding, and +-0.0. Then what it costs: the predict step's device
    time (topk tier, graph replay) at buckets 8, 64 and 1024 with top_k
    and with torch.topk (no tie order) in its place, in the order
    torch.topk, top_k, top_k, torch.topk, and the two alone on the step's
    logits."""
    import torch
    from code2vec_tpu_torch.data import packed as packed_lib
    from code2vec_tpu_torch.ops.topk import top_k
    from code2vec_tpu_torch.serving import steps
    width = model.backend.compute_params.target_embedding.shape[0]
    k = model.config.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION
    padded = np.full((32, 1000), -1e9, np.float32)
    padded[:, :40] = rng.normal(0.0, 1.0, (32, 40))
    cases = {
        'java14m width': (rng.normal(0.0, 1.0, (64, width)), k),
        'k above the valid vocabulary': (padded, 64),
        'signed zeros': (rng.choice(np.array([0.0, -0.0, 1.0, -1.0],
                                             np.float32), (16, 300)), 100),
    }
    tie_rows = {}
    for name, (x, kk) in cases.items():
        x = torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()
        values, indices = top_k(torch.from_numpy(x).cuda(), kk)
        got = indices.cpu().numpy()
        want = topk_reference(x, kk)
        check(np.array_equal(got, want), 'top_k on the card (%s) breaks ties '
              'otherwise than lax.top_k: %d rows differ'
              % (name, int((got != want).any(axis=-1).sum())))
        check(np.array_equal(values.cpu().numpy().view(np.int32),
                             np.take_along_axis(x, want, -1).view(np.int32)),
              'top_k on the card (%s): values are not the logits' % name)
        plain = torch.topk(torch.from_numpy(x).cuda(), kk).indices
        tie_rows[name] = int((plain.cpu().numpy() != want).any(-1).sum())
    print('top_k on the card: lax.top_k order on %s (rows where torch.topk '
          'alone orders otherwise: %s) [%s]'
          % (sorted(cases), tie_rows, gpu))

    sizes = (model.vocabs.token_vocab.size - 1,
             model.vocabs.path_vocab.size - 1,
             model.vocabs.target_vocab.size - 1)
    plain_top_k = lambda logits, kk: torch.topk(
        logits, min(kk, logits.shape[-1]), dim=-1, sorted=True)
    for bucket, n_lines in BUCKETS:
        lines = make_lines(rng, n_lines, sizes, model.config.MAX_CONTEXTS)
        batch = model.reader.pad_batch_to(
            model.reader.process_input_rows(lines), bucket)
        wire = packed_lib.pack_batch(batch, model.backend.token_pad_index,
                                     model.backend.path_pad_index)
        arrays = tuple(torch.from_numpy(a).cuda()
                       for a in wire.device_arrays())
        run = lambda: steps.predict_step(model.backend, arrays, tier='topk')
        readings = []
        for use in (plain_top_k, top_k, top_k, plain_top_k):
            steps.top_k = use
            try:
                readings.append(cuda_ms(run))
            finally:
                steps.top_k = top_k
        code = model.backend.encode_arrays(arrays)[0]
        logits = model.backend.logits(code)
        alone = (cuda_ms(lambda: plain_top_k(logits, k)),
                 cuda_ms(lambda: top_k(logits, k)))
        print('top_k cost, bucket %d (logits %d x %d): predict step (topk '
              'tier) with torch.topk %.4f/%.4f ms, with top_k %.4f/%.4f ms '
              '(device, graph replay, order torch.topk, top_k, top_k, '
              'torch.topk); alone torch.topk %.4f ms, top_k %.4f ms [%s]'
              % (bucket, logits.shape[0], logits.shape[1], readings[0],
                 readings[3], readings[1], readings[2], alone[0], alone[1],
                 gpu))
        del logits, code


EVAL_LINES = 4096


def evaluate_phase(model, gpu: str, kernel: str) -> int:
    """``Code2VecModel.evaluate()`` over the synthetic test split at
    java14m width, in the working directory build/smoke/ (its log.txt
    lands there): every batch launches ``kernel`` once and no other
    kernel. Then where one batch's time goes. Returns the launches."""
    import contextlib
    import torch
    from code2vec_tpu_torch.data.reader import PathContextReader
    from code2vec_tpu_torch.metrics import (SubtokensEvaluationMetric,
                                            TopKAccuracyEvaluationMetric,
                                            decode_topk_batch)
    config = model.config
    route = '%s wire, %s' % (config.BATCH_WIRE_FORMAT, kernel)
    k = config.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION
    batches = -(-EVAL_LINES // config.TEST_BATCH_SIZE)
    if config.READER_USE_NATIVE:
        # once per vocabulary object, before the timed call
        t0 = time.perf_counter()
        PathContextReader(model.vocabs, config).native_tokenizer()
        print('evaluate (%s): native tokenizer loaded and its vocabulary '
              'uploaded in %.2f s, before the call [%s]'
              % (route, time.perf_counter() - t0, gpu))
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.chdir(SMOKE_DIR):
        results = model.evaluate()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    check(counts == {name: batches * int(name == kernel) for name in counts},
          'evaluate() on the %s route in %d batches launched %s'
          % (route, batches, counts))
    check(results.topk_acc.shape == (k,)
          and bool(np.all(np.diff(results.topk_acc) >= 0))
          and 0 <= results.topk_acc[-1] <= 1
          and all(0 <= v <= 1 for v in (results.subtoken_precision,
                                        results.subtoken_recall,
                                        results.subtoken_f1))
          and results.loss is not None and math.isfinite(results.loss),
          'bad evaluation results: %s' % (results,))
    log_lines = (SMOKE_DIR / 'log.txt').read_text().count('\n')
    check(log_lines == EVAL_LINES, 'log.txt holds %d lines for %d examples'
          % (log_lines, EVAL_LINES))
    print('evaluate (%s): %d lines, %d batches of %d: top-1 acc %.6f, '
          'top-%d acc %.6f, precision %.6f, recall %.6f, F1 %.6f, loss %.6f, '
          '%.2f s (%.0f examples/s, host clock); launches %s [%s]'
          % (route, EVAL_LINES, batches, config.TEST_BATCH_SIZE,
             results.topk_acc[0], k, results.topk_acc[-1],
             results.subtoken_precision, results.subtoken_recall,
             results.subtoken_f1, results.loss, seconds,
             EVAL_LINES / seconds, counts, gpu))

    # one batch cut at its phase boundaries
    reader = PathContextReader(model.vocabs, config)
    t0 = time.perf_counter()
    host_batches = list(reader.iter_epoch(evaluate=True))
    read_ms = (time.perf_counter() - t0) * 1e3 / len(host_batches)
    batch = host_batches[0]
    arrays = tuple(torch.from_numpy(a).cuda() for a in batch.device_arrays())
    step_ms = cuda_ms(lambda: model.trainer.eval_step(arrays))
    out = model.trainer.eval_step(arrays)
    t0 = time.perf_counter()
    fetched = {key: value.cpu().numpy() for key, value in out.items()}
    decoded = decode_topk_batch(fetched['topk_indices'],
                                model._target_index_to_word,
                                batch.label_strings, batch.weight)
    oov = model.vocabs.target_vocab.special_words.OOV
    TopKAccuracyEvaluationMetric(k, oov).update_batch(decoded)
    SubtokensEvaluationMetric(oov).update_batch(decoded)
    with open(SMOKE_DIR / 'log_breakdown.txt', 'w') as f:
        model._log_predictions_during_evaluation(decoded, f)
    decode_ms = (time.perf_counter() - t0) * 1e3
    print('evaluate breakdown (%s), per batch of %d: host read+tokenize+'
          'filter%s %.1f ms, device eval step %.4f ms (graph replay), host '
          'fetch+decode+metrics+log %.1f ms [%s]'
          % (route, config.TEST_BATCH_SIZE,
             '+pack' if config.BATCH_WIRE_FORMAT == 'packed' else '',
             read_ms, step_ms, decode_ms, gpu))
    return counts[kernel]


def evaluate_reference_phase(rng) -> None:
    """A small-vocabulary model at full width evaluates the same test
    split on the card (plane wire, encode kernel) and on the CPU (plain
    versions) from the same weights, fp32: equal metrics and log."""
    import contextlib
    from code2vec_tpu_torch import convert
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    prefix = SMOKE_DIR / 'small'
    test_path = SMOKE_DIR / 'small.test.c2v'
    lines = make_lines(rng, 300, (299, 199, 49), 200)
    test_path.write_text('\n'.join(lines) + '\n')
    config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                    TEST_DATA_PATH=str(test_path), TEST_BATCH_SIZE=128,
                    COMPUTE_DTYPE='float32', BATCH_WIRE_FORMAT='planes',
                    USE_PALLAS_FUSED_ENCODE=True)
    cpu = Code2VecModel(config, device='cpu', seed=4)
    card = Code2VecModel(config, device='cuda',
                         params=convert.params_from_numpy(
                             convert.params_to_numpy(cpu.backend.params),
                             'cuda'))
    logs = []
    with contextlib.chdir(SMOKE_DIR):
        want = cpu.evaluate()
        logs.append((SMOKE_DIR / 'log.txt').read_text())
        zero_counts()
        got = card.evaluate()
        launched = launch_counts()
        logs.append((SMOKE_DIR / 'log.txt').read_text())
    check(launched['encode'] == 3 and launched['ragged_fwd'] == 0,
          'card evaluate() launched %s in 3 batches' % launched)
    check(bool(np.array_equal(got.topk_acc, want.topk_acc))
          and (got.subtoken_precision, got.subtoken_recall, got.subtoken_f1)
          == (want.subtoken_precision, want.subtoken_recall,
              want.subtoken_f1), 'evaluate() on the card %s vs the CPU %s'
          % (got, want))
    check(logs[0] == logs[1], 'log.txt differs between the card and the CPU')
    loss_err = abs(got.loss - want.loss) / abs(want.loss)
    # fp32 on both sides: the card's kernel and cuBLAS sum in another
    # order than the CPU, ~1e-7 of the loss
    check(loss_err <= 1e-5, 'evaluate() loss on the card %.8f vs the CPU '
          '%.8f' % (got.loss, want.loss))
    check(want.topk_acc[-1] > 0 and want.subtoken_f1 > 0,
          'the reference evaluation scored nothing: %s' % (want,))
    print('evaluate reference: 300 lines, a 300/200/50-word model at full '
          'width, fp32, plane wire + encode kernel on the card vs the CPU '
          'plain path: top-k acc %s, precision %.6f, recall %.6f, F1 %.6f '
          'equal, log.txt equal; loss %.8f vs %.8f (rel err %.3g, limit '
          '1e-5)' % (np.array2string(got.topk_acc, precision=4),
                     got.subtoken_precision, got.subtoken_recall,
                     got.subtoken_f1, got.loss, want.loss, loss_err))


def train_batch(rng, batch: int, max_contexts: int, vocab_sizes,
                token_pad: int, path_pad: int):
    """One packed training batch: kernel_batch's slots, labels over the
    real targets, weight 0 on the empty rows."""
    n_tok, n_path, n_tgt = vocab_sizes
    packed = kernel_batch(rng, batch, max_contexts, n_tok, n_path, token_pad,
                          path_pad)
    return packed._replace(
        label=rng.integers(1, n_tgt, batch).astype(np.int32),
        weight=(packed.count > 0).astype(np.float32))


def device_arrays(packed):
    import torch
    return tuple(torch.from_numpy(a).cuda() for a in (
        packed.ctx, packed.count, packed.label, packed.weight))


def scaled_err(got, want) -> float:
    """max |got - want| over the largest |want|, each tensor on its own
    scale; the largest across tensors."""
    return worst(*(float((g.float() - w.float()).abs().max())
                     / max(float(w.float().abs().max()), 1e-30)
                     for g, w in zip(got, want)))


def per_example_err(got_de, want_de, segs) -> float:
    """The ragged backward's ``de`` with each valid slot held on the scale
    of its own example (the largest |want| among the example's slots):
    ``de`` carries the attention weight p/z, so an example of 200 contexts
    sits ~200x below one of a single context, and one scale for the whole
    tensor would hide an error in the long examples."""
    import torch
    valid = segs.slot_valid
    row_max = torch.where(valid, want_de.abs().amax(-1), 0.0)
    ex_max = torch.zeros(segs.count2.shape, device=row_max.device
                         ).scatter_reduce(1, segs.seg, row_max, 'amax')
    scale = torch.gather(ex_max, 1, segs.seg).clamp_min(1e-30)
    err = (got_de - want_de).abs().amax(-1) / scale
    return float(torch.where(valid, err, 0.0).max())


# Limit on the ragged backward's de (per example) and dW against a float64
# reference fed the kernel's own du (own_du_reference): both sides take
# the same rounded du, so only the fp32 sums' order and rounding remain,
# where a flipped bf16 ulp of du reads ~1e-3 against the plain version.
# On an H100 (PERF.md) the largest readings were 1.7e-6 here (dW, bf16,
# training batch) and 9.0e-7 in scripts/torch_kernel_checks.py
# rounding-noise (six draws of weights, K, D in {128, 256, 384}); the
# limit sits ~12x above them and 50x below the 1e-3 check.
OWN_DU_LIMIT = 2e-5


def own_du_reference(args, segs, keep, rate, du):
    """de = du W^T (times the keep mask / keep rate) and dW = e^T du in
    float64 from the kernel's own du stream and the rows rounded (and
    masked) as the kernel rounds them."""
    from code2vec_tpu_torch.ops import ragged
    tok, path, w, _attn = args
    e = ragged._gather(tok, path, segs, w.dtype, keep, rate).double()
    du = du.double()
    de = du @ w.double().T
    if keep is not None:
        de = ragged.apply_keep(de, keep, rate)
    return de, (e.reshape(-1, e.shape[-1]).T
                @ du.reshape(-1, du.shape[-1]))


def ragged_bwd_parts(args, segs, m, z, gc, g2, keep, rate, tpad: int,
                     ppad: int):
    """The ragged backward kernel against its plain version, each part on
    its own scale (``de`` also per example), and its de and dW against
    own_du_reference. Returns (scaled errors by part, max |diff|, the
    kernel's and the plain version's calls)."""
    import torch
    from code2vec_tpu_torch.ops import ragged
    bwd_args = args + (segs, m, z, gc, g2, keep, rate)
    run_kernel = lambda: ragged._grads_kernel(
        *bwd_args, token_pad=tpad, path_pad=ppad)
    run_plain = lambda: ragged._grads_plain(*bwd_args)
    *got, du = ragged._grads_kernel_du(*bwd_args, token_pad=tpad,
                                       path_pad=ppad)
    want = run_plain()
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(t).all()) for t in got),
          'non-finite ragged_bwd output')
    parts = {'de (per example)': per_example_err(got[0], want[0], segs),
             'de': scaled_err(got[:1], want[:1]),
             'dW': scaled_err(got[1:2], want[1:2]),
             'd_attn': scaled_err(got[2:], want[2:])}
    own = own_du_reference(args, segs, keep, rate, du)
    own_parts = {'de vs own du (per example)': per_example_err(
                     got[0], own[0].float(), segs),
                 'dW vs own du': scaled_err(got[1:2], own[1:])}
    check(worst(*own_parts.values()) <= OWN_DU_LIMIT,
          'ragged_bwd against the float64 reference fed its own du: %s, '
          'limit %.3g' % (own_parts, OWN_DU_LIMIT))
    parts.update(own_parts)
    return parts, max_err(got, want), run_kernel, run_plain


# counts that put examples on the edges of the backward's 64-slot tiles:
# slots 0 (one slot), 1-63 (63), 64-127 (exactly one tile), 128-192 (one
# slot past a tile), two empty examples, one slot, then random counts
EDGE_COUNTS = (1, 63, 64, 65, 0, 0, 1)


def edge_segments(rng, token_rows: int, path_rows: int, tpad: int,
                  ppad: int, shards: int = 1, tail: int = 37,
                  head=EDGE_COUNTS, dead_tile: bool = False):
    """A packed stream at the edges of the slot tiles: ``head`` counts
    then random counts (200 examples per shard), interior all-PAD holes,
    and (one shard) a capacity of 64 k + ``tail`` slots, so the last tile
    is partial; with ``dead_tile``, every slot of the third tile (slots
    128-191, inside examples) all-PAD. Returns the device segment
    inputs."""
    import torch
    from code2vec_tpu_torch.data import packed as packed_lib
    from code2vec_tpu_torch.ops import ragged
    batch = 200 * shards
    counts = context_counts(rng, batch, 200)
    counts[:len(head)] = head
    packed = packed_lib.pack_batch(
        plane_batch(rng, batch, 200, token_rows, path_rows, tpad, ppad,
                    counts=counts), tpad, ppad, data_shards=shards)
    ctx = packed.ctx
    if dead_tile:
        ctx[0, 128:192] = (tpad, ppad, tpad)
    if shards == 1:
        total = int(packed.count.sum())
        cap = -(-(total + 1) // 64) * 64 + tail
        trimmed = np.empty((1, cap, 3), np.int32)
        trimmed[..., 0] = tpad
        trimmed[..., 1] = ppad
        trimmed[..., 2] = tpad
        keep_n = min(cap, ctx.shape[1])
        trimmed[:, :keep_n] = ctx[:, :keep_n]
        ctx = trimmed
    segs = ragged._segment_inputs(torch.from_numpy(ctx).cuda(),
                                  torch.from_numpy(packed.count).cuda(),
                                  tpad, ppad)
    holes = ~segs.slot_valid & (segs.pos < torch.gather(
        segs.count2, 1, segs.seg).to(segs.pos.dtype))
    check(bool(holes.any()), 'the edge stream has no interior hole')
    return segs


def small_encoder(gen, dt: int, dp: int, d_code: int):
    """fp32 tables (2,000 and 1,000 rows), W (2 dt + dp, d_code) and the
    attention vector (d_code,) drawn as the model initialises them
    (models/functional.py::init_params): tables U(+-sqrt(3 / dim)), W and
    attention glorot-uniform."""
    import torch
    k_dim = 2 * dt + dp

    def uniform(shape, limit):
        return torch.from_numpy(gen.uniform(-limit, limit, shape).astype(
            np.float32)).cuda()
    return (uniform((2000, dt), math.sqrt(3.0 / dt)),
            uniform((1000, dp), math.sqrt(3.0 / dp)),
            uniform((k_dim, d_code), math.sqrt(6.0 / (k_dim + d_code))),
            uniform((d_code,), math.sqrt(6.0 / (d_code + 1))))


# the forward's edge counts: EDGE_COUNTS (examples of 1, 63, 64 and 65
# slots; the 64- and 65-slot ones start exactly at tile edges 64 and 128;
# two empty examples) and one of 200 slots across four tiles
FWD_EDGE_COUNTS = EDGE_COUNTS + (200,)


def ragged_fwd_check(args, segs, keep, rate: float, tpad: int, ppad: int,
                     tag: str) -> float:
    """The forward kernel against its plain version on one stream: scores,
    m, z and acc within rtol 1e-4, atol 1e-5 (the limits of the serving
    and training checks). Returns max |diff|."""
    import torch
    from code2vec_tpu_torch.ops import ragged
    plan, plan_plain = ragged._pair_map_kernel(segs), ragged._pair_map(segs)
    torch.cuda.synchronize()
    check(all(bool(torch.equal(g, w)) for g, w in zip(plan[:3],
                                                      plan_plain[:3])),
          'ragged_fwd %s: the plan kernel\'s pair map differs from '
          '_pair_map' % tag)
    got = ragged._stats_kernel(*args, segs, tpad, ppad, keep, rate)
    want = ragged._stats_plain(*args, segs, tpad, ppad, keep, rate)
    torch.cuda.synchronize()
    for name, g, w in zip(('scores', 'm', 'z', 'acc'), got, want):
        check(g.shape == w.shape and bool(torch.isfinite(g).all()),
              'ragged_fwd %s %s: shape %s or non-finite'
              % (tag, name, tuple(g.shape)))
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5,
                                   msg=lambda m, n=name: 'ragged_fwd %s %s: '
                                   '%s' % (tag, n, m))
    return max_err(got, want)


def ragged_fwd_edge_cases(params, dtype: str, tpad: int, ppad: int) -> dict:
    """The forward kernel at the edges of its 64-slot tiles, ``dtype``
    compute: examples of 0, 1, 63, 64, 65 and 200 slots, examples starting
    exactly at a tile edge, a partial last tile, interior holes, a tile
    whose every slot is invalid and a tile past the stream's total, fp32
    masters with the keep mask (training) and without, bf16 tables with
    and without it (bf16 only), two shards with slots past a shard's
    total, and K, D in {128, 256} on small tables. Returns max |diff| by
    case."""
    import torch
    from code2vec_tpu_torch.ops import ragged
    tdtype = getattr(torch, dtype)
    gen = np.random.default_rng(31)
    rate = 0.75
    w_c = params.transform.to(tdtype)
    a_c = params.attention.to(tdtype).reshape(-1)
    masters = (params.token_embedding, params.path_embedding)
    tables = {'fp32 tables': masters}
    if dtype == 'bfloat16':
        tables['bf16 tables'] = tuple(t.to(tdtype) for t in masters)
    rows = (masters[0].shape[0], masters[1].shape[0])
    segs = edge_segments(gen, *rows, tpad, ppad, head=FWD_EDGE_COUNTS,
                         dead_tile=True)
    check(not bool(segs.slot_valid[0, 128:192].any()),
          'the forward edge stream has no all-invalid tile')
    segs2 = edge_segments(gen, *rows, tpad, ppad, shards=2,
                          head=FWD_EDGE_COUNTS)
    keep = ragged._draw_keep(37, segs, w_c.shape[0], rate)
    keep2 = ragged._draw_keep(41, segs2, w_c.shape[0], rate)
    errs = {}
    for name, (tok, path) in tables.items():
        args = (tok, path, w_c, a_c)
        for tag, sg, kp in (('edges', segs, None), ('edges, keep', segs, keep),
                            ('2 shards', segs2, None),
                            ('2 shards, keep', segs2, keep2)):
            label = '%s %s' % (name, tag)
            errs[label] = ragged_fwd_check(args, sg, kp, rate, tpad, ppad,
                                           '%s %s' % (dtype, label))
    for k_dim, d_code in ((128, 128), (256, 256), (128, 256), (256, 128)):
        dt, dp = (32, 64) if k_dim == 128 else (64, 128)
        tok, path, w, attn = small_encoder(gen, dt, dp, d_code)
        segs_s = edge_segments(gen, 2000, 1000, tpad, ppad, tail=5,
                               head=FWD_EDGE_COUNTS, dead_tile=True)
        keep_s = ragged._draw_keep(43, segs_s, k_dim, rate)
        label = 'K=%d D=%d' % (k_dim, d_code)
        errs[label] = ragged_fwd_check(
            (tok, path, w.to(tdtype), attn.to(tdtype)), segs_s, keep_s,
            rate, tpad, ppad, '%s %s' % (dtype, label))
    return errs


def ragged_bwd_edge_cases(params, dtype: str, rate: float, tpad: int,
                          ppad: int) -> dict:
    """The ragged backward at the edges of its slot tiles, each part as in
    ragged_bwd_parts: examples of 0, 1, 63, 64 (one whole tile) and 65
    slots, a partial last tile and interior holes, at the training widths
    (fp32 tables with the keep mask; bf16 tables without one, on a stream
    of two shards); and the other widths K, D in {128, 256} on small
    tables."""
    import torch
    from code2vec_tpu_torch.ops import ragged
    tdtype = getattr(torch, dtype)
    gen = np.random.default_rng(17)
    parts = {}

    def run(tag, tok, path, w, attn, segs, keep, keep_rate):
        args = (tok, path, w, attn)
        _s, m, z, acc = ragged._stats_plain(*args, segs, tpad, ppad, keep,
                                            keep_rate)
        batch = segs.count2.numel()
        code = (acc / torch.where(z > 0, z, 1.0)[..., None]).reshape(
            batch, -1)
        g2 = torch.from_numpy(gen.normal(0.0, 1.0, (1, batch, w.shape[1]))
                              .astype(np.float32)).cuda().reshape(
            segs.count2.shape + (w.shape[1],))
        gc = (g2 * code.reshape(g2.shape)).sum(dim=-1)
        got = ragged_bwd_parts(args, segs, m, z, gc, g2, keep, keep_rate,
                               tpad, ppad)[0]
        parts.update({'%s %s' % (tag, k): v for k, v in got.items()})

    w_c = params.transform.to(tdtype)
    a_c = params.attention.to(tdtype).reshape(-1)
    tok_rows, path_rows = (params.token_embedding.shape[0],
                           params.path_embedding.shape[0])
    segs = edge_segments(gen, tok_rows, path_rows, tpad, ppad)
    keep = ragged._draw_keep(23, segs, w_c.shape[0], rate)
    run('edges', params.token_embedding, params.path_embedding, w_c, a_c,
        segs, keep, rate)
    segs2 = edge_segments(gen, tok_rows, path_rows, tpad, ppad, shards=2)
    tables = ((params.token_embedding.to(tdtype),
               params.path_embedding.to(tdtype)) if dtype == 'bfloat16'
              else (params.token_embedding, params.path_embedding))
    run('2 shards, %s tables, no mask' % dtype, *tables, w_c, a_c, segs2,
        None, 1.0)
    for k_dim, d_code in ((128, 128), (256, 256), (128, 256), (256, 128)):
        dt, dp = (32, 64) if k_dim == 128 else (64, 128)
        tok, path, w, attn = small_encoder(gen, dt, dp, d_code)
        w, attn = w.to(tdtype), attn.to(tdtype)
        segs_s = edge_segments(gen, 2000, 1000, tpad, ppad, tail=5)
        keep_s = ragged._draw_keep(29, segs_s, k_dim, rate)
        run('K=%d D=%d' % (k_dim, d_code), tok, path, w, attn, segs_s,
            keep_s, rate)
    return parts


def ce_fwd_check(code, w, label, n_valid: int, tag: str) -> float:
    """The CE forward kernel against its plain version (lse and picked,
    rtol and atol 1e-4); returns max |diff|."""
    import torch
    from code2vec_tpu_torch.ops import ce
    got = ce._lse_pick_kernel(code, w, label, n_valid)
    want = ce._lse_pick_plain(code, w, label, n_valid)
    torch.cuda.synchronize()
    for name, g, v in zip(('lse', 'picked'), got, want):
        check(g.shape == v.shape and bool(torch.isfinite(g).all()),
              'ce_fwd %s %s: shape %s or non-finite' % (tag, name,
                                                       tuple(g.shape)))
        torch.testing.assert_close(g, v, rtol=1e-4, atol=1e-4,
                                   msg=lambda m, n=name: 'ce_fwd %s %s: %s'
                                   % (tag, n, m))
    return max_err(got, want)


def ce_fwd_edge_cases(code, w, label, n_valid: int, tdtype) -> dict:
    """The CE forward at the edges of its tiling: a 1,024-row table with
    51 and with 3 valid rows at B = 64, B = 1000 (the last 128-row tile
    partial) over the full table with labels at and past num_valid, and
    code dims 128 and 256 on a 4,096-row table whose
    num_valid (4,000) ends inside a 128-row block, 333 rows, labels over
    every row of the table. num_valid of the main case already ends
    inside a block (261,245 = 2,040 x 128 + 125)."""
    import torch
    errs = {}
    vocab = w.shape[0]
    # the train reference's shape: a 1,024-row table with 51 valid rows
    # (then 3): most vocabulary splits, and some threads' columns, hold
    # masked columns only
    small_w = w[:1024].clone()
    for n_small in (51, 3):
        lab = label[:64] % 64
        errs['V=1024 num_valid=%d' % n_small] = ce_fwd_check(
            code[:64], small_w, lab, n_small, 'V=1024 num_valid=%d'
            % n_small)
    lab = label[:1000].clone()
    lab[:5] = n_valid
    lab[5:9] = vocab - 1
    lab[9] = n_valid - 1
    errs['B=1000'] = ce_fwd_check(code[:1000], w, lab, n_valid, 'B=1000')
    gen = np.random.default_rng(7)
    for d_code in (128, 256):
        code_s, w_s = (torch.from_numpy(gen.normal(0.0, 0.3, shape).astype(
            np.float32)).cuda().to(tdtype) for shape in ((333, d_code),
                                                        (4096, d_code)))
        lab = torch.from_numpy(gen.integers(0, 4096, 333).astype(
            np.int32)).cuda()
        errs['D=%d' % d_code] = ce_fwd_check(code_s, w_s, lab, 4000,
                                             'D=%d' % d_code)
    return errs


def library_ce_fwd(code, w, label, num_valid):
    """The materialized-logits route's forward: one cuBLAS product in the
    compute dtype, then logsumexp and a gather."""
    import torch
    logits = torch.matmul(code, w.T).float()
    logits[:, num_valid:] = -1e9
    return logits, torch.logsumexp(logits, dim=1), torch.gather(
        logits, 1, label.long()[:, None])[:, 0]


def library_ce_bwd(logits, code, w, label, lse, dlse, dpicked):
    """The materialized route's backward from its stored logits: dlogits,
    then two cuBLAS products in the compute dtype."""
    import torch
    dl = dlse[:, None] * torch.exp(logits - lse[:, None])
    dl.scatter_add_(1, label.long()[:, None], dpicked[:, None])
    dl = dl.to(code.dtype)
    return torch.matmul(dl.T, code), torch.matmul(dl, w)


def bound(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def record(name: str, source: str, replaces: str, err: float, ms: float,
           plain_ms: float, bound_ms: float, bound_by: str,
           library_ms) -> dict:
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': 0, 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': library_ms}


def ce_bwd_parts(code, w, label, weight, n_valid: int, lse=None):
    """The CE backward kernel against its plain version at the loss's own
    cotangents (dlse = weight / sum, dpicked = -dlse). The label term of
    dlogits (dpicked, one column per row) is ~|V| times the softmax term,
    so dw's label rows and its other rows are held apart, each on its own
    scale, and a second pass with dpicked = 0 holds the softmax term of
    dcode on its own. Returns (scaled errors by part, max |diff|, the other
    rows' scale over the label rows', the loss pass's arguments)."""
    import torch
    from code2vec_tpu_torch.ops import ce
    if lse is None:
        lse = ce._lse_pick_plain(code, w, label, n_valid)[0]
    dlse = weight / weight.sum()
    dpicked = -dlse
    is_label = torch.zeros(w.shape[0], dtype=torch.bool, device=w.device)
    is_label[label[(weight > 0) & (label < n_valid)].long()] = True
    parts = {}
    for cot, dp in (('loss', dpicked), ('softmax', torch.zeros_like(
            dpicked))):
        args_c = (code, w, label, lse, dlse, dp, n_valid)
        got = ce._ce_grads_kernel(*args_c)
        want = ce._ce_grads_plain(*args_c)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in got),
              'non-finite ce_bwd output')
        parts[cot + ' dw label rows'] = scaled_err(
            [got[0][is_label]], [want[0][is_label]])
        parts[cot + ' dw other rows'] = scaled_err(
            [got[0][~is_label]], [want[0][~is_label]])
        parts[cot + ' dcode'] = scaled_err(got[1:], want[1:])
        if cot == 'loss':
            grad_args = args_c
            abs_err = max_err(got, want)
            other_scale = (float(want[0][~is_label].abs().max())
                           / float(want[0][is_label].abs().max()))
        del got, want
    return parts, abs_err, other_scale, grad_args


def ce_bwd_edge_cases(code, w, label, weight, n_valid: int, tdtype) -> dict:
    """The CE backward at the edges of its tiling, each part as in
    ce_bwd_parts: B = 1000 (the last 64-row tile partial) over the full
    table with labels at and past num_valid (masked columns: no label
    term), and code dims 128 and 256 on a 4,096-row table whose num_valid
    (4,000) ends inside a 64-row block. num_valid of the main case already
    ends inside a block (261,245 = 4,081 x 64 + 61)."""
    import torch
    vocab = w.shape[0]
    parts = {}
    lab = label[:1000].clone()
    lab[:5] = n_valid
    lab[5:9] = vocab - 1
    got = ce_bwd_parts(code[:1000], w, lab, weight[:1000], n_valid)[0]
    parts.update({'B=1000 ' + k: v for k, v in got.items()})
    gen = np.random.default_rng(7)
    for d_code in (128, 256):
        code_s, w_s = (torch.from_numpy(gen.normal(0.0, 0.3, shape).astype(
            np.float32)).cuda().to(tdtype) for shape in ((333, d_code),
                                                        (4096, d_code)))
        lab = torch.from_numpy(gen.integers(0, 4096, 333).astype(
            np.int32)).cuda()
        got = ce_bwd_parts(code_s, w_s, lab, torch.ones(333, device='cuda'),
                           4000)[0]
        parts.update({'D=%d %s' % (d_code, k): v for k, v in got.items()})
    return parts


def train_kernel_phase(backend, rng, gpu: str):
    """Holds the three training kernels (and the forward kernel in its
    training mode) against their plain versions at the java14m training
    shape, fp32 and bf16; returns the bf16 (main path) JSON records and
    the bf16 forward's training-shape numbers."""
    import torch
    from code2vec_tpu_torch.ops import ce, ragged
    config = backend.config
    tpad, ppad = backend.token_pad_index, backend.path_pad_index
    sizes = (backend.sizes['token_vocab_size'],
             backend.sizes['path_vocab_size'], backend.num_valid_targets)
    packed = train_batch(rng, config.TRAIN_BATCH_SIZE, config.MAX_CONTEXTS,
                         sizes, tpad, ppad)
    ctx, count, label, weight = device_arrays(packed)
    retained = int(packed.count.sum())
    batch = count.numel()
    segs = ragged._segment_inputs(ctx, count, tpad, ppad)
    params = backend.params                    # the fp32 masters
    k_dim, d_code = params.transform.shape
    rate = config.DROPOUT_KEEP_RATE
    keep = ragged._draw_keep(11, segs, k_dim, rate)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(3)
    g2 = torch.randn((1, batch, d_code), generator=gen, device='cuda')
    table = params.target_embedding
    n_valid = backend.num_valid_targets
    dlse = weight / weight.sum()
    dpicked = -dlse
    records = []
    for dtype in ('float32', 'bfloat16'):
        tdtype = getattr(torch, dtype)
        # Limit on each gradient part's scaled error. In bf16 the kernels
        # and the plain versions round the same fp32 values (du, dlogits)
        # to bf16, and a value that sits on a rounding boundary may go
        # either way: one flipped ulp of a dlogit moves a dw row by up to
        # 2^-7 of one term, and the softmax dlogits of a row are all within
        # ~1% of each other, so such flips read up to ~7e-4 of dw's other
        # rows on this data (the CE backward's exponent on the SFU, ~1e-6
        # relative, flips more of them than an accurate expf, ~4e-4).
        # 1e-3 passes them and fails a rounding rule that is off by half
        # an ulp everywhere (~2^-9).
        tol = 1e-4 if dtype == 'float32' else 1e-3
        args = (params.token_embedding, params.path_embedding,
                params.transform.to(tdtype),
                params.attention.to(tdtype).reshape(-1), segs)
        # the forward kernel in training mode: fp32 tables, keep mask
        fwd_kernel = ragged._stats_kernel(*args, tpad, ppad, keep, rate)
        fwd_plain = ragged._stats_plain(*args, tpad, ppad, keep, rate)
        torch.cuda.synchronize()
        for name, g, w in zip(('scores', 'm', 'z', 'acc'), fwd_kernel,
                              fwd_plain):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5,
                                       msg=lambda m, n=name: 'train %s %s: %s'
                                       % (dtype, n, m))
        if dtype == 'bfloat16':
            # its time at the training shape, beside its own bound: fp32
            # rows, the mask and the triples in; W and attention (bf16);
            # scores, m, z, acc out
            fwd_err = max_err(fwd_kernel, fwd_plain)
            run_fwd = lambda: ragged._stats_kernel(*args, tpad, ppad, keep,
                                                   rate)
            run_fwd_plain = lambda: ragged._stats_plain(*args, tpad, ppad,
                                                        keep, rate)
            fwd_ms, fwd_plain_ms = cuda_ms(run_fwd), cuda_ms(run_fwd_plain)
            fwd_ms2 = cuda_ms(run_fwd)
            b_ms, b_by = bound(
                retained * (k_dim * 4 + k_dim + 12)
                + (k_dim + 1) * d_code * 2 + ctx.numel() // 3 * 4
                + batch * (2 + d_code) * 4,
                retained * (2 * k_dim * d_code + 4 * d_code), dtype)
            print('kernel ragged_fwd bfloat16, training shape (fp32 masters, '
                  'keep %.2f): B=%d slots=%d max_abs_err=%.3g kernel '
                  '%.4f/%.4f ms, plain %.4f ms (device, graph replay), bound '
                  '%.4f ms (%s) [%s]' % (rate, batch, retained, fwd_err,
                                         fwd_ms, fwd_ms2, fwd_plain_ms, b_ms,
                                         b_by, gpu))
            train_fwd = {'train_shape_ms': fwd_ms,
                         'train_shape_plain_ms': fwd_plain_ms,
                         'train_shape_bound_ms': b_ms,
                         'train_shape_bound_by': b_by,
                         'train_shape_max_abs_err': fwd_err}
        del fwd_kernel
        _scores, m, z, acc = fwd_plain
        code = (acc / torch.where(z > 0, z, 1.0)[..., None]).reshape(
            batch, d_code)
        gc = (g2 * code[None]).sum(dim=-1)
        parts, abs_err, run_kernel, run_plain = ragged_bwd_parts(
            args[:4], segs, m, z, gc, g2, keep, rate, tpad, ppad)
        parts.update(ragged_bwd_edge_cases(params, dtype, rate, tpad, ppad))
        err = worst(*parts.values())
        check(err <= tol, 'ragged_bwd %s disagrees with its plain version: '
              'scaled errors %s, limit %.3g' % (dtype, parts, tol))
        ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_plain)
        w_elt = 2 if dtype == 'bfloat16' else 4
        b_ms, b_by = bound(
            retained * (k_dim * 4 + 12 + k_dim)         # fp32 rows, triples,
            + (k_dim + 1) * d_code * w_elt              # mask; W, attention
            + batch * (3 + d_code) * 4                  # m, z, gc, g
            + retained * k_dim * 4                      # de
            + (k_dim + 1) * d_code * 4,                 # dW, d_attn
            retained * (6 * k_dim * d_code + 12 * d_code), dtype)
        print('kernel ragged_bwd %s: B=%d slots=%d keep=%.2f '
              'max_abs_err=%.3g, scaled errors %s (limit %.3g) kernel '
              '%.4f ms, plain %.4f ms (device, graph replay), bound %.4f ms '
              '(%s) [%s]'
              % (dtype, batch, retained, rate, abs_err,
                 {k: float('%.3g' % v) for k, v in parts.items()}, tol, ms,
                 plain_ms, b_ms, b_by, gpu))
        bwd_record = record(
            'ragged_bwd', 'code2vec_tpu_torch/ops/csrc/ragged_bwd.cu',
            'code2vec_tpu/ops/pallas_ragged.py:486', abs_err, ms, plain_ms,
            b_ms, b_by, None)

        # the streamed CE, at the loss's own cotangents
        code_c = code.to(tdtype)
        w_c = table.to(tdtype)
        vocab = w_c.shape[0]
        abs_err = ce_fwd_check(code_c, w_c, label, n_valid, dtype)
        edge_errs = ce_fwd_edge_cases(code_c, w_c, label, n_valid, tdtype)
        lse = ce._lse_pick_plain(code_c, w_c, label, n_valid)[0]
        ms = cuda_ms(lambda: ce._lse_pick_kernel(code_c, w_c, label,
                                                 n_valid))
        plain_ms = cuda_ms(lambda: ce._lse_pick_plain(code_c, w_c, label,
                                                      n_valid))
        lib_ms = cuda_ms(lambda: library_ce_fwd(code_c, w_c, label, n_valid))
        elt = 2 if dtype == 'bfloat16' else 4
        b_ms, b_by = bound((batch + vocab) * d_code * elt + batch * 12,
                           2.0 * batch * vocab * d_code, dtype)
        print('kernel ce_fwd %s: B=%d V=%d D=%d max_abs_err=%.3g (edges, '
              'rtol/atol 1e-4 held: %s) kernel %.4f ms, plain %.4f ms, '
              'materialized logits (cuBLAS) %.4f ms (device, graph replay), '
              'bound %.4f ms (%s) [%s]'
              % (dtype, batch, vocab, d_code, abs_err,
                 {k: float('%.3g' % v) for k, v in edge_errs.items()}, ms,
                 plain_ms, lib_ms, b_ms, b_by, gpu))
        fwd_record = record(
            'ce_fwd', 'code2vec_tpu_torch/ops/csrc/ce.cu',
            'code2vec_tpu/ops/pallas_ce.py:103', abs_err, ms, plain_ms,
            b_ms, b_by, lib_ms)

        parts, abs_err, other_scale, grad_args = ce_bwd_parts(
            code_c, w_c, label, weight, n_valid, lse)
        parts.update(ce_bwd_edge_cases(code_c, w_c, label, weight, n_valid,
                                       tdtype))
        err = worst(*parts.values())
        check(err <= tol, 'ce_bwd %s disagrees with its plain version: '
              'scaled errors %s, limit %.3g' % (dtype, parts, tol))
        ms = cuda_ms(lambda: ce._ce_grads_kernel(*grad_args))
        plain_ms = cuda_ms(lambda: ce._ce_grads_plain(*grad_args))
        logits = library_ce_fwd(code_c, w_c, label, n_valid)[0]
        lib_ms = cuda_ms(lambda: library_ce_bwd(logits, code_c, w_c, label,
                                                lse, dlse, dpicked))
        del logits
        b_ms, b_by = bound((batch + vocab) * d_code * elt + batch * 16
                           + (batch + vocab) * d_code * 4,
                           6.0 * batch * vocab * d_code, dtype)
        print('kernel ce_bwd %s: B=%d V=%d D=%d max_abs_err=%.3g, scaled '
              'errors %s (limit %.3g; dw other rows at %.3g of the label '
              'rows\' scale) kernel %.4f ms, plain %.4f ms, '
              'materialized-logits backward (cuBLAS) %.4f ms (device, graph '
              'replay), bound %.4f ms (%s) [%s]'
              % (dtype, batch, vocab, d_code, abs_err,
                 {k: float('%.3g' % v) for k, v in parts.items()}, tol,
                 other_scale, ms, plain_ms, lib_ms, b_ms, b_by, gpu))
        bwd_ce_record = record(
            'ce_bwd', 'code2vec_tpu_torch/ops/csrc/ce.cu',
            'code2vec_tpu/ops/pallas_ce.py:142', abs_err, ms, plain_ms,
            b_ms, b_by, lib_ms)
        if dtype == 'bfloat16':    # the training path's compute dtype
            records = [bwd_record, fwd_record, bwd_ce_record]
        torch.cuda.empty_cache()
    return records, train_fwd


TRAIN_KERNELS = ('ragged_fwd', 'ragged_bwd', 'ce_fwd', 'ce_bwd')
# the kernels of every train step: the four above once, Adam once a
# parameter
STEP_KERNELS = TRAIN_KERNELS + ('adam_update',)
PARAMS_PER_STEP = 5


def launch_counts() -> dict:
    """Every kernel wrapper's launch count."""
    from code2vec_tpu_torch.ops import adam, ce, encode, ragged
    return {'ragged_fwd': ragged.launches, 'ragged_bwd': ragged.bwd_launches,
            'ce_fwd': ce.fwd_launches, 'ce_bwd': ce.bwd_launches,
            'encode': encode.launches, 'adam_update': adam.launches,
            'adam_rows': adam.row_launches}


def train_counts() -> dict:
    counts = launch_counts()
    check(counts['encode'] == 0 and counts['adam_rows'] == 0,
          'a training path launched the encode or the row-Adam kernel')
    return {name: counts[name] for name in STEP_KERNELS}


def check_step_launches(counts: dict, steps: int, what: str) -> None:
    """Each training kernel once a step, Adam once a parameter."""
    check(all(counts[n] == steps for n in TRAIN_KERNELS)
          and counts['adam_update'] == PARAMS_PER_STEP * steps,
          '%s: kernel launches %s in %d train steps' % (what, counts, steps))


def zero_counts() -> None:
    from code2vec_tpu_torch.ops import adam, ce, encode, ragged
    ragged.launches = ragged.bwd_launches = 0
    ce.fwd_launches = ce.bwd_launches = 0
    encode.launches = 0
    adam.launches = adam.row_launches = 0


def train_phase(backend, rng, gpu: str) -> dict:
    """The training main path at java14m width: TRAIN_STEPS steps on one
    pre-packed batch plus one under the CPU-op watch. Returns the launch
    counts of the run."""
    import torch
    from code2vec_tpu_torch.training.trainer import Trainer
    config = backend.config
    trainer = Trainer(config, backend)
    state = trainer.state_from_params()
    sizes = (backend.sizes['token_vocab_size'],
             backend.sizes['path_vocab_size'], backend.num_valid_targets)
    packed = train_batch(rng, config.TRAIN_BATCH_SIZE, config.MAX_CONTEXTS,
                         sizes, backend.token_pad_index,
                         backend.path_pad_index)
    arrays = device_arrays(packed)
    examples = int((packed.weight > 0).sum())
    zero_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, arrays)
        losses.append(float(loss))
        times.append((time.perf_counter() - t0) * 1e3)
    watch = CpuOpWatch()
    with watch.mode:
        state, loss = trainer.train_step(state, arrays)
    losses.append(float(loss))
    counts = train_counts()
    steps = TRAIN_STEPS + 1
    check(all(math.isfinite(x) for x in losses), 'non-finite train loss')
    check(losses[-1] < losses[0], 'the loss did not fall on a repeated '
          'batch: %s' % losses)
    check_step_launches(counts, steps, 'train')
    check(not watch.cpu_ops, 'CPU operations on the train step: %s'
          % sorted(set(watch.cpu_ops)))
    step_ms = statistics.median(times[5:])
    print('train: java14m width, B=%d (%d examples), %d slots, bf16, keep '
          '%.2f, fused CE: %d steps, loss %.4f -> %.4f, step %.3f ms (host '
          'clock to synchronize, median of steps 6-%d), %.0f examples/s; '
          'launches %s; no CPU operation on the step [%s]'
          % (config.TRAIN_BATCH_SIZE, examples, int(packed.count.sum()),
             config.DROPOUT_KEEP_RATE, steps, losses[0], losses[-1], step_ms,
             TRAIN_STEPS, examples / step_ms * 1e3, counts, gpu))
    breakdown(trainer, state, arrays, gpu)
    return counts


def breakdown(trainer, state, arrays, gpu: str) -> None:
    """One train step cut at its phase boundaries (host clock, each ending
    in a synchronize): loss forward, backward, Adam."""
    import torch
    from code2vec_tpu_torch.training import adam_dtypes
    from code2vec_tpu_torch.training.trainer import dropout_seed
    params = state.params
    marks = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _aux = trainer.backend.loss_fn_packed(
            params, arrays, dropout_seed(state.seed, state.step))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        adam_dtypes.update_(params, [p.grad for p in params],
                            state.opt_state, trainer.config.LEARNING_RATE)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for p in params:
            p.grad = None
        marks.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
    fwd, bwd, adam = (statistics.median(m[i] for m in marks)
                      for i in range(3))
    print('train breakdown (median of 3 steps, host clock): forward+loss '
          '%.3f ms, backward %.3f ms, Adam %.3f ms [%s]'
          % (fwd, bwd, adam, gpu))


def unfused_phase(backend, rng, gpu: str) -> None:
    """A few steps with USE_PALLAS_FUSED_CE off: the ragged kernels run,
    the CE goes through materialized logits."""
    import torch
    from code2vec_tpu_torch.training.trainer import Trainer
    trainer = Trainer(backend.config, backend)
    state = trainer.state_from_params()
    sizes = (backend.sizes['token_vocab_size'],
             backend.sizes['path_vocab_size'], backend.num_valid_targets)
    arrays = device_arrays(train_batch(
        rng, backend.config.TRAIN_BATCH_SIZE, backend.config.MAX_CONTEXTS,
        sizes, backend.token_pad_index, backend.path_pad_index))
    zero_counts()
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, arrays)
        check(math.isfinite(float(loss)), 'non-finite loss (unfused CE)')
        times.append((time.perf_counter() - t0) * 1e3)
    counts = train_counts()
    check(counts == {'ragged_fwd': 4, 'ragged_bwd': 4, 'ce_fwd': 0,
                     'ce_bwd': 0, 'adam_update': 4 * PARAMS_PER_STEP},
          'launches %s with the unfused CE' % counts)
    print('train, USE_PALLAS_FUSED_CE=False (materialized logits): 4 steps, '
          'step %.3f ms (host clock, median of steps 2-4), launches %s [%s]'
          % (statistics.median(times[1:]), counts, gpu))


ADAM_DTYPES = ('float32', 'bfloat16')
# (gradient, mu, nu) of the main path: fp32 gradients, bf16-stored moments
ADAM_MAIN = ('float32', 'bfloat16', 'bfloat16')
ADAM_EDGE_LAYOUTS = ('aligned', 'offset', 'mixed')


def torch_dtype(name: str):
    import torch
    return {'float32': torch.float32, 'bfloat16': torch.bfloat16}[name]


def bit_mismatches(got, want) -> int:
    """Elements whose bits differ, a NaN on both sides counting as equal
    (a NaN's payload is not part of the function)."""
    import torch
    int_type = torch.int32 if got.dtype == torch.float32 else torch.int16
    differ = got.view(int_type) != want.view(int_type)
    return int((differ & ~(torch.isnan(got) & torch.isnan(want))).sum())


def adam_edge_inputs(rng, combo, layout: str):
    """(p, g, mu, nu) of 1,003 elements (not a multiple of 8) in the
    combo's dtypes: zero, +-3e38 and NaN gradients, +-1e-45 gradients over
    zero moments (m rounds to a signed zero), the rest ordinary. Each
    stream starts 16-byte aligned ('aligned'), one element past it
    ('offset': the kernel's vectors after a scalar prologue), or at
    offsets that never align together ('mixed': scalar throughout)."""
    import torch
    n = 1003
    g = (rng.normal(size=n) * 1e-2).astype(np.float32)
    g[:16] = 0.0
    g[16:32] = rng.choice([-1.0, 1.0], 16) * 3e38
    g[32] = np.nan
    g[33:35] = (1e-45, -1e-45)
    m = (rng.normal(size=n) * 1e-3).astype(np.float32)
    m[33:35] = 0.0
    v = np.abs(rng.normal(size=n) * 1e-5).astype(np.float32)
    p = rng.normal(size=n).astype(np.float32)
    offsets = {'aligned': (0, 0, 0, 0), 'offset': (1, 1, 1, 1),
               'mixed': (1, 3, 2, 5)}[layout]
    out = []
    for values, dtype, offset in zip((p, g, m, v), ('float32',) + combo,
                                     offsets):
        backing = torch.zeros(n + offset, dtype=torch_dtype(dtype),
                              device='cuda')
        backing[offset:] = torch.from_numpy(values).cuda()
        out.append(backing[offset:])
    return out


def adam_param_inputs(gen, shape, combo):
    import torch
    g_dt, mu_dt, nu_dt = (torch_dtype(d) for d in combo)
    kw = dict(generator=gen, device='cuda')
    return [torch.randn(shape, **kw),
            (torch.randn(shape, **kw) * 1e-2).to(g_dt),
            (torch.randn(shape, **kw) * 1e-3).to(mu_dt),
            (torch.rand(shape, **kw) * 1e-5).to(nu_dt)]


def adam_compare(inputs, counts, lr: float) -> tuple:
    """The kernel on ``inputs`` and the plain version on copies, one step
    per count: (bit mismatches of p, mu, nu; max |p diff|)."""
    from code2vec_tpu_torch.ops import adam as adam_ops
    from code2vec_tpu_torch.training import adam_dtypes
    copies = [t.clone() for t in inputs]
    for count in counts:
        s = adam_dtypes.adam_scalars(count, lr)
        adam_ops.adam_update(*inputs, s)
        adam_ops.adam_update_plain(*copies, s)
    mismatches = sum(bit_mismatches(inputs[i], copies[i]) for i in (0, 2, 3))
    diff = (inputs[0] - copies[0]).abs()
    err = float(diff[~diff.isnan()].max()) if diff.numel() else 0.0
    return mismatches, err


def adam_kernel_phase(backend, gpu: str) -> dict:
    """The fused Adam kernel against its plain version on the card, bit
    for bit over every element of every java14m parameter, for every
    gradient x mu x nu dtype, and on the edge inputs (adam_edge_inputs,
    at step 1 then 2); times each dtype combination over the five
    parameters (CUDA graph replay) beside its bound, the plain version and,
    for fp32 moments, ``torch.optim.Adam(fused=True)``. Returns the main
    path's record."""
    import torch
    from code2vec_tpu_torch.ops import adam as adam_ops
    from code2vec_tpu_torch.training import adam_dtypes
    shapes = backend.param_shapes()
    lr = backend.config.LEARNING_RATE
    gen = torch.Generator(device='cuda')
    gen.manual_seed(11)
    rng = np.random.default_rng(11)
    main = None
    for combo in [(g, m, v) for g in ADAM_DTYPES for m in ADAM_DTYPES
                  for v in ADAM_DTYPES]:
        mismatches, elements, err = 0, 0, 0.0
        for layout in ADAM_EDGE_LAYOUTS:
            bad, e = adam_compare(adam_edge_inputs(rng, combo, layout),
                                  (1, 2), lr)
            mismatches += bad
            err = worst(err, e)
            elements += 3 * 1003
        tensors = {name: adam_param_inputs(gen, shape, combo)
                   for name, shape in shapes.items()}
        for name, inputs in tensors.items():
            bad, e = adam_compare([t.clone() for t in inputs], (3,), lr)
            mismatches += bad
            err = worst(err, e)
            elements += 3 * inputs[0].numel()
        check(mismatches == 0, 'adam_update %s: %d of %d elements differ '
              'from the plain version in their bits (max |p diff| %.3g)'
              % (combo, mismatches, elements, err))
        s = adam_dtypes.adam_scalars(3, lr)

        def kernel():
            for p, g, mu, nu in tensors.values():
                adam_ops.adam_update(p, g, mu, nu, s)

        def plain():
            for p, g, mu, nu in tensors.values():
                adam_ops.adam_update_plain(p, g, mu, nu, s)
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain)
        n_params = sum(t[0].numel() for t in tensors.values())
        per_element = 8 + sum(2 * torch_dtype(d).itemsize
                              for d in combo[1:]) + torch_dtype(
                                  combo[0]).itemsize
        b_ms, b_by = bound(n_params * per_element, 0.0, 'float32')
        lib_ms = None
        if combo == ('float32', 'float32', 'float32'):
            params = [t[0].requires_grad_() for t in tensors.values()]
            for p, t in zip(params, tensors.values()):
                p.grad = t[1]
            opt = torch.optim.Adam(params, lr=lr, fused=True)
            opt.step()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                opt.step()
            end.record()
            end.synchronize()
            lib_ms = start.elapsed_time(end) / 10
            del opt, params
        print('kernel adam_update grads %s, mu %s, nu %s: bit-equal to the '
              'plain version over %d elements (every element of the five '
              'java14m parameters, %d values, and the edge inputs at steps '
              '1 and 2); kernel %.4f ms, plain %.4f ms, bound %.4f ms (%s, '
              '%d bytes an element)%s (device, graph replay) [%s]'
              % (combo + (elements, n_params, ms, plain_ms, b_ms, b_by,
                          per_element,
                          '' if lib_ms is None else
                          ', torch.optim.Adam(fused=True) %.4f ms (events)'
                          % lib_ms, gpu)))
        if combo == ADAM_MAIN:
            main = record('adam_update', 'code2vec_tpu_torch/ops/csrc/adam.cu',
                          'code2vec_tpu/training/adam_dtypes.py:78', err,
                          ms, plain_ms, b_ms, b_by, None)
        del tensors
        torch.cuda.empty_cache()
    return main


def library_sparse_adam(table, grad, rows, lr: float):
    """``torch.optim.SparseAdam`` over the touched rows' coalesced sparse
    gradient: its step, timed with CUDA events (the yardstick of
    adam_rows; a fresh optimizer per step, so its step count is 1)."""
    import torch
    unique = torch.unique(rows)
    param = table.clone().requires_grad_()
    param.grad = torch.sparse_coo_tensor(unique[None, :], grad[unique],
                                         table.shape,
                                         check_invariants=False).coalesce()
    times = []
    for _ in range(5):
        opt = torch.optim.SparseAdam([param], lr=lr)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        opt.step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


ROWS_REPEATED = 20000


def adam_rows_phase(backend, rng, gpu: str) -> dict:
    """Lazy Adam's row kernel against its plain version on the card: the
    token table at java14m size (random fp32 table, moments and gradient)
    over the rows of a real packed batch (``packed_rows``: source, target
    and the PAD row) plus one row listed ROWS_REPEATED times (warps that
    updated it twice would race); touched rows equal
    the plain version's bit for bit, untouched rows keep their bits.
    Returns the record."""
    import torch
    from code2vec_tpu_torch.ops import lazy_adam
    from code2vec_tpu_torch.training.trainer import packed_rows
    config = backend.config
    tpad, ppad = backend.token_pad_index, backend.path_pad_index
    sizes = (backend.sizes['token_vocab_size'],
             backend.sizes['path_vocab_size'], backend.num_valid_targets)
    packed = train_batch(rng, config.TRAIN_BATCH_SIZE, config.MAX_CONTEXTS,
                         sizes, tpad, ppad)
    ctx = torch.from_numpy(packed.ctx).cuda()
    source, _path, target = packed_rows(ctx, tpad, ppad)
    rows = torch.cat([source, target, torch.full(
        (ROWS_REPEATED,), 4321, dtype=source.dtype, device='cuda')]).long()
    shape = backend.param_shapes()['token_embedding']
    gen = torch.Generator(device='cuda')
    gen.manual_seed(12)
    kw = dict(generator=gen, device='cuda')
    start = [torch.randn(shape, **kw), torch.randn(shape, **kw) * 1e-3,
             torch.rand(shape, **kw) * 1e-5]
    grad = torch.randn(shape, **kw) * 1e-2
    lr, step = config.LEARNING_RATE, 3
    got = [t.clone() for t in start]
    lazy_adam.sparse_row_adam(*got, grad, rows, learning_rate=lr, step=step)
    want = [t.clone() for t in start]
    lazy_adam.sparse_row_adam_plain(
        *want, grad, rows, lazy_adam.lazy_rate(lr, step))
    touched = torch.zeros(shape[0], dtype=torch.bool, device='cuda')
    touched[rows] = True
    unique = int(touched.sum())
    mismatches = sum(bit_mismatches(g, w) for g, w in zip(got, want))
    moved = sum(bit_mismatches(g[~touched], s[~touched])
                for g, s in zip(got, start))
    err = max_err(got, want)
    check(mismatches == 0 and moved == 0, 'adam_rows: %d elements differ '
          'from the plain version, %d untouched elements changed (max err '
          '%.3g)' % (mismatches, moved, err))
    ms = cuda_ms(lambda: lazy_adam.sparse_row_adam(
        *got, grad, rows, learning_rate=lr, step=step))
    plain_ms = cuda_ms(lambda: lazy_adam.sparse_row_adam_plain(
        *want, grad, rows, lazy_adam.lazy_rate(lr, step)))
    lib_ms = library_sparse_adam(start[0], grad, rows, lr)
    b_ms, b_by = bound(unique * shape[1] * 28 + rows.numel() * 8, 0.0,
                       'float32')
    print('kernel adam_rows: token table %s fp32, %d listed rows (%d '
          'distinct; one row %d times) of a packed batch: bit-equal to '
          'the plain version, untouched rows unchanged; kernel (with the '
          'sort) %.4f ms, plain %.4f ms (graph replay), '
          'torch.optim.SparseAdam step %.4f ms (events), bound %.4f ms (%s) '
          '[%s]' % (tuple(shape), rows.numel(), unique, ROWS_REPEATED, ms,
                    plain_ms, lib_ms, b_ms, b_by, gpu))
    del got, want, start, grad
    torch.cuda.empty_cache()
    return record('adam_rows', 'code2vec_tpu_torch/ops/csrc/adam.cu',
                  'code2vec_tpu/ops/lazy_adam.py:65', err, ms, plain_ms,
                  b_ms, b_by, lib_ms)


class SyncWatch:
    """Raises at any host synchronization of the card's stream inside the
    block (``torch.cuda.set_sync_debug_mode('error')``)."""

    def __enter__(self):
        import torch
        self.before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode('error')
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode(self.before)
        return False


KNOB_STEPS = 6
KNOB_TIMED_STEPS = 10
# (name, Config knobs, adam_update and adam_rows launches a step, ragged
# forward launches a step); 'default' is the same phase with no knob, the
# step time the others compare with
KNOBS = (('default', {}, 5, 0, 1),
         ('lazy', dict(LAZY_EMBEDDING_ADAM=True), 3, 2, 1),
         ('grads_bf16', dict(GRADS_DTYPE='bfloat16'), 5, 0, 1),
         ('sorted', dict(EMBED_GRAD_IMPL='sorted'), 5, 0, 1),
         ('dedup', dict(EMBED_GRAD_IMPL='dedup'), 5, 0, 1),
         ('remat', dict(REMAT_ENCODE=True), 5, 0, 2))


def table_grads(trainer, state, arrays):
    """The token and path tables' gradients of one step's loss (the
    trainer's route: bf16 copies under GRADS_DTYPE='bfloat16')."""
    import torch
    from code2vec_tpu_torch.models.functional import Code2VecParams
    from code2vec_tpu_torch.training.trainer import dropout_seed
    params = state.params
    if trainer.grads_bf16:
        params = Code2VecParams(*[p.detach().to(torch.bfloat16)
                                  .requires_grad_() for p in params])
    for p in params:
        p.grad = None
    loss, _aux = trainer.backend.loss_fn_packed(
        params, arrays, dropout_seed(state.seed, state.step))
    loss.backward()
    grads = [params[i].grad.clone() for i in (0, 1)]
    for p in params:
        p.grad = None
    return grads


def empty_example_arrays(backend, rng):
    """A packed batch with no PAD slot in its stream (every context drawn
    off the PAD rows, capacity exactly the total) and one empty example of
    weight 1, whose code vector x_pad sends a gradient to the PAD rows."""
    import torch
    batch = backend.config.TRAIN_BATCH_SIZE
    count = context_counts(rng, batch, backend.config.MAX_CONTEXTS)
    count[7] = 0
    total = int(count.sum())

    def draw(rows, pad):
        x = rng.integers(0, rows - 1, total)
        return np.where(x >= pad, x + 1, x)
    tok_rows = backend.sizes['token_vocab_size']
    ctx = np.stack([draw(tok_rows, backend.token_pad_index),
                    draw(backend.sizes['path_vocab_size'],
                         backend.path_pad_index),
                    draw(tok_rows, backend.token_pad_index)],
                   axis=-1).astype(np.int32)[None]
    label = rng.integers(1, backend.num_valid_targets, batch)
    return tuple(torch.from_numpy(a).cuda() for a in (
        ctx, count.astype(np.int32), label.astype(np.int32),
        np.ones(batch, np.float32)))


def knob_phase(name: str, knobs: dict, vocabs, prefix: Path, rng,
               gpu: str) -> dict:
    """One optimizer or table-gradient knob at java14m width (fused CE,
    bf16, keep 0.75): KNOB_STEPS steps on one batch under the CPU-op watch
    and the sync watch; the loss falls, each step launches the expected
    kernels, and the step time (CUDA events between steps' ends, queued
    back to back) is printed, with whether the table gradients repeat bit
    for bit from the same state. Lazy Adam also takes a step on a batch
    whose stream holds no PAD slot but an empty example of weight 1: the
    PAD rows, touched only through ``packed_rows``' append, must move.
    Returns the launch counts."""
    import torch
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.backends import TorchBackend
    from code2vec_tpu_torch.training.trainer import Trainer
    _name, _knobs, adam_n, rows_n, fwd_n = next(k for k in KNOBS
                                                if k[0] == name)
    config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                    USE_PALLAS_FUSED_CE=True, **knobs)
    backend = TorchBackend(config, vocabs, torch.device('cuda'), seed=1)
    trainer = Trainer(config, backend)
    state = trainer.state_from_params()
    sizes = (backend.sizes['token_vocab_size'],
             backend.sizes['path_vocab_size'], backend.num_valid_targets)
    arrays = device_arrays(train_batch(
        rng, config.TRAIN_BATCH_SIZE, config.MAX_CONTEXTS, sizes,
        backend.token_pad_index, backend.path_pad_index))
    first = table_grads(trainer, state, arrays)
    second = table_grads(trainer, state, arrays)
    repeat = [bool(torch.equal(a, b)) for a, b in zip(first, second)]
    dtypes = [str(g.dtype).replace('torch.', '') for g in first]
    del first, second
    state, loss = trainer.train_step(state, arrays)     # warm
    losses = [loss]
    watch = CpuOpWatch()
    zero_counts()
    with SyncWatch(), watch.mode:
        for _ in range(KNOB_STEPS):
            state, loss = trainer.train_step(state, arrays)
            losses.append(loss)
    counts = launch_counts()
    # the device time of a step, outside the watches (whose per-op Python
    # would set the pace): steps queued back to back, events at their ends
    ends = []
    for _ in range(KNOB_TIMED_STEPS):
        state, loss = trainer.train_step(state, arrays)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
    losses.append(loss)
    torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    step_ms = statistics.median(a.elapsed_time(b)
                                for a, b in zip(ends[1:], ends[2:]))
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          'knob %s: losses %s' % (name, losses))
    check(not watch.cpu_ops, 'knob %s: CPU operations on the step: %s'
          % (name, sorted(set(watch.cpu_ops))))
    expected = dict({k: 0 for k in counts}, ragged_fwd=fwd_n * KNOB_STEPS,
                    ragged_bwd=KNOB_STEPS, ce_fwd=KNOB_STEPS,
                    ce_bwd=KNOB_STEPS, adam_update=adam_n * KNOB_STEPS,
                    adam_rows=rows_n * KNOB_STEPS)
    check(counts == expected, 'knob %s: launches %s, expected %s'
          % (name, counts, expected))
    pad_text = ''
    if name == 'lazy':
        empty = empty_example_arrays(backend, rng)
        tables = ('token_embedding', 'path_embedding')
        pads = (backend.token_pad_index, backend.path_pad_index)
        before = [float(state.opt_state.mu[t][pad].abs().sum())
                  for t, pad in zip(tables, pads)]
        state, _loss = trainer.train_step(state, empty)
        after = [float(state.opt_state.mu[t][pad].abs().sum())
                 for t, pad in zip(tables, pads)]
        check(before == [0.0, 0.0] and all(a > 0 for a in after),
              'lazy Adam: the PAD rows\' first moments %s -> %s on a batch '
              'with an empty example of weight 1 and no PAD slot'
              % (before, after))
        pad_text = ('; an empty example of weight 1 moved both PAD rows '
                    '(|mu| sums %s)' % ['%.3g' % a for a in after])
    print('knob %s %s: java14m width, fused CE, bf16, keep %.2f: %d steps '
          'on one batch, loss %.4f -> %.4f, step %.3f ms (median of %d, CUDA '
          'events between steps\' ends, queued back to back); no CPU op and '
          'no host sync on %d watched steps; launches %s; table gradients '
          '(%s) repeat bit for bit from the same state: token %s, path %s%s '
          '[%s]' % (name, knobs, config.DROPOUT_KEEP_RATE,
                    1 + KNOB_STEPS + KNOB_TIMED_STEPS, losses[0], losses[-1],
                    step_ms, KNOB_TIMED_STEPS - 2, KNOB_STEPS, counts,
                    '/'.join(dtypes), repeat[0], repeat[1], pad_text, gpu))
    del backend, trainer, state, arrays
    torch.cuda.empty_cache()
    return counts


def knob_phases(vocabs, prefix: Path, gpu: str) -> dict:
    """Every knob of KNOBS (knob_phase), each on batches of its own
    generator; returns {'train_<knob>': launch counts}."""
    return {'train_' + name: knob_phase(name, knobs, vocabs, prefix,
                                        np.random.default_rng(20 + i), gpu)
            for i, (name, knobs, *_n) in enumerate(KNOBS)}


def train_entry_phase(prefix: Path, vocab_sizes, rng, gpu: str) -> dict:
    """``Code2VecModel(device='cuda').train()`` over a synthetic train
    split at java14m width, then a predict with the trained weights."""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    lines = make_lines(rng, 2100, vocab_sizes, 200)
    with open(str(prefix) + '.train.c2v', 'w') as f:
        f.write('\n'.join(lines) + '\n')
    config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix), NUM_TRAIN_EPOCHS=1,
                    USE_PALLAS_FUSED_CE=True, NUM_BATCHES_TO_LOG_PROGRESS=1)
    model = Code2VecModel(config, device='cuda', seed=5)
    zero_counts()
    t0 = time.perf_counter()
    losses = model.train()
    seconds = time.perf_counter() - t0
    counts = train_counts()
    steps = model.state.step
    check(steps == 3 and all(math.isfinite(x) for x in losses),
          'train() took %d steps, losses %s' % (steps, losses))
    check_step_launches(counts, steps, 'train()')
    results = model.predict(lines[:8])
    check(all(np.isfinite(r.topk_predicted_words_scores).all()
              for r in results), 'bad predict after train()')
    print('train entry: Code2VecModel.train() over %d lines, %d steps, mean '
          'loss %.4f, %.1f s with host tokenization; launches %s; predict '
          'after train() ok [%s]' % (len(lines), steps, losses[0], seconds,
                                     counts, gpu))
    return counts


def moment_readings(got: dict, want: dict) -> dict:
    """The card's Adam moments against the CPU's, per moment, the worst
    over the parameters: ``scaled`` (max |got - want| over max |want|),
    ``rel`` (||got - want|| / ||want||) and ``scale`` (|<got, want> /
    <want, want> - 1|). Adam's update m / sqrt(v) does not change when
    every gradient is off by one factor; the moments carry that factor."""
    out = {}
    for moment in ('mu', 'nu'):
        readings = {'scaled': 0.0, 'rel': 0.0, 'scale': 0.0}
        for name, w in want[moment].items():
            g = got[moment][name].astype(np.float64)
            w = w.astype(np.float64)
            w_sq = max(float((w * w).sum()), 1e-300)
            readings['scaled'] = worst(readings['scaled'], float(
                np.abs(g - w).max() / max(np.abs(w).max(), 1e-300)))
            readings['rel'] = worst(readings['rel'], math.sqrt(
                float(((g - w) ** 2).sum()) / w_sq))
            readings['scale'] = worst(readings['scale'], abs(
                float((g * w).sum()) / w_sq - 1.0))
        out[moment] = readings
    return out


# card-vs-CPU train reference limits per compute dtype. fp32: one bf16 ulp
# of the stored moments (2^-7 of the largest) may flip where the two
# gradients straddle a rounding boundary, and nothing else differs by more
# than the fp32 summation order, so the norm error and the scale are held
# tight; the weights elementwise to a tenth of one Adam step (lr 1e-3).
# bf16: the kernels and the plain versions round the same values to bf16,
# so the gradients differ where one bf16 ulp flips (up to two ulps of the
# stored moments, 2^-6), and an element whose gradient is near zero on
# both sides may take Adam steps of the other sign (m / sqrt(v) ~ sign(g)
# over three steps), so the weights' update is held in norm, not per
# element, and that norm moves with the draw of batches. The bf16 limits
# come from ten draws of batches (generators seeded 101-110) on an H100
# (PERF.md), whose largest readings were: Adam moments scaled 6.5e-3,
# rel 1.23e-3, scale 1.49e-4; update norm 2.04e-3; loss 3.6e-7. The rel,
# scale and update-norm limits sit ~3x above their largest readings; the
# scaled and loss limits stay as they were (2.4x and ~300x above). Every
# gradient on the card x1.01 reads ~1.0e-2 on mu's scale and rel and
# ~2.0e-2 on nu's, 20x and 2.5x above those limits; the scaled error (one
# bf16 ulp, 2^-6) and the update norm do not see such a fault (Adam's
# m / sqrt(v) does not change).
TRAIN_REF_LIMITS = {
    'float32': {'loss': 1e-5, 'scaled': 2.0 ** -7, 'rel': 5e-4,
                'scale': 1e-5, 'weights': 1e-4},
    'bfloat16': {'loss': 1e-4, 'scaled': 2.0 ** -6, 'rel': 4e-3,
                 'scale': 5e-4, 'weights': 6e-3},
}
TRAIN_REF_DRAWS = (101, 102, 103)   # bf16: the seed of each draw's generator


def train_reference_readings(dtype: str, rng) -> dict:
    """A small-vocabulary model at full width trains three steps on the
    card and on the CPU (plain versions) from the same weights and the
    same batches (drawn from ``rng``) at keep 1.0. Returns the card's
    readings against the CPU: loss (relative, worst step), the Adam
    moments (moment_readings) and the weights (fp32: max |diff|; bf16:
    ||diff|| / ||update||)."""
    import torch
    from code2vec_tpu_torch import convert
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.backends import TorchBackend
    from code2vec_tpu_torch.training.trainer import Trainer
    from code2vec_tpu_torch.vocab import Code2VecVocabs
    prefix = SMOKE_DIR / 'small'
    config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix), COMPUTE_DTYPE=dtype,
                    DROPOUT_KEEP_RATE=1.0, USE_PALLAS_FUSED_CE=True,
                    TRAIN_BATCH_SIZE=64)
    vocabs = Code2VecVocabs(config)
    cpu = TorchBackend(config, vocabs, torch.device('cpu'), seed=3)
    start = {name: a.copy() for name, a in
             convert.params_to_numpy(cpu.params).items()}
    gpu_backend = TorchBackend(config, vocabs, torch.device('cuda'),
                               params=convert.params_from_numpy(start, 'cuda'))
    trainers = (Trainer(config, cpu), Trainer(config, gpu_backend))
    states = [t.state_from_params() for t in trainers]
    sizes = (vocabs.token_vocab.size, vocabs.path_vocab.size,
             vocabs.target_vocab.size)
    loss_err = 0.0
    for _ in range(3):
        packed = train_batch(rng, 64, config.MAX_CONTEXTS, sizes,
                             cpu.token_pad_index, cpu.path_pad_index)
        losses = []
        for i, trainer in enumerate(trainers):
            states[i], loss = trainer.train_step(states[i], packed)
            losses.append(float(loss))
        loss_err = worst(loss_err,
                         abs(losses[0] - losses[1]) / abs(losses[0]))
    moments = moment_readings(
        convert.opt_state_to_numpy(states[1].opt_state),
        convert.opt_state_to_numpy(states[0].opt_state))
    want = convert.params_to_numpy(states[0].params)
    got = convert.params_to_numpy(states[1].params)
    if dtype == 'float32':
        weights = worst(*(float(np.abs(got[n] - want[n]).max())
                          for n in want))
    else:
        weights = worst(*(math.sqrt(
            float(((got[n].astype(np.float64) - want[n]) ** 2).sum())
            / max(float(((want[n].astype(np.float64) - start[n]) ** 2
                         ).sum()), 1e-300)) for n in want))
    return {'loss': loss_err, 'moments': moments, 'weights': weights,
            'got': got, 'want': want}


def train_reference_phase(rng) -> None:
    """The train reference (train_reference_readings) in fp32 on batches
    from ``rng`` and in bf16 on TRAIN_REF_DRAWS draws, each from its own
    generator: losses, Adam moments and weights agree within
    TRAIN_REF_LIMITS."""
    runs = [('float32', 'shared', rng)] + [
        ('bfloat16', seed, np.random.default_rng(seed))
        for seed in TRAIN_REF_DRAWS]
    for dtype, draw, gen in runs:
        limits = TRAIN_REF_LIMITS[dtype]
        r = train_reference_readings(dtype, gen)
        check(r['loss'] <= limits['loss'], '%s (draw %s) loss on the card '
              'vs the CPU: relative error %.3g > %.3g'
              % (dtype, draw, r['loss'], limits['loss']))
        for moment, readings in r['moments'].items():
            for key, value in readings.items():
                check(value <= limits[key], '%s (draw %s) Adam %s on the '
                      'card vs the CPU: %s %.3g > %.3g (all: %s)'
                      % (dtype, draw, moment, key, value, limits[key],
                         r['moments']))
        if dtype == 'float32':
            for name in r['want']:
                np.testing.assert_allclose(r['got'][name], r['want'][name],
                                           rtol=limits['weights'],
                                           atol=limits['weights'],
                                           err_msg=name)
            weights_text = 'max |diff| %.3g (limit rtol/atol %.3g)' % (
                r['weights'], limits['weights'])
        else:
            check(r['weights'] <= limits['weights'], 'bf16 (draw %s) weight '
                  'updates on the card vs the CPU: relative error %.3g > '
                  '%.3g' % (draw, r['weights'], limits['weights']))
            weights_text = ('update ||diff||/||update|| %.3g (limit %.3g)'
                            % (r['weights'], limits['weights']))
        print('train reference %s (draw %s): 3 steps of a 300/200/50-word '
              'model at full width, fused CE, keep 1.0, card vs CPU plain '
              'path: loss rel err %.3g (limit %.3g); Adam moments %s '
              '(limits %s); weights %s' % (
                  dtype, draw, r['loss'], limits['loss'],
                  {m: {k: float('%.3g' % v) for k, v in rd.items()}
                   for m, rd in r['moments'].items()},
                  {k: limits[k] for k in ('scaled', 'rel', 'scale')},
                  weights_text))


# the resumed run against the run continued in memory: the same bf16
# kernels on the same card, apart in the order of the table gradients'
# atomic adds (index_add_), held to the card-vs-CPU bf16 limits, which
# also cover gradients that differ by flipped bf16 ulps
RESUME_LIMITS = TRAIN_REF_LIMITS['bfloat16']
CKPT_EPOCHS = 3


def state_equal(a, b) -> bool:
    """Two training states (or a state and a restored one, as {name:
    tensor} dicts) hold equal tensors in equal dtypes."""
    import torch
    from code2vec_tpu_torch.models.functional import Code2VecParams
    names = Code2VecParams._fields

    def named(state, field):
        if hasattr(state, 'opt_state'):
            if field == 'params':
                return dict(zip(names, state.params))
            return dict(zip(names, getattr(state.opt_state, field)))
        return state[field]

    for field in ('params', 'mu', 'nu'):
        x, y = named(a, field), named(b, field)
        for name in names:
            u, v = x[name].detach(), y[name].detach()
            if u.dtype != v.dtype or not torch.equal(u, v.to(u.device)):
                return False
    return True


def resume_readings(got, want, start) -> dict:
    """A resumed state against the one continued in memory, on the card in
    float64: the Adam moments (``moment_readings``' keys) and the weights'
    update (||got - want|| / ||want - start||, the worst parameter)."""
    import torch
    out = {'mu': {'scaled': 0.0, 'rel': 0.0, 'scale': 0.0},
           'nu': {'scaled': 0.0, 'rel': 0.0, 'scale': 0.0}}
    for moment in ('mu', 'nu'):
        readings = out[moment]
        for g, w in zip(getattr(got.opt_state, moment),
                        getattr(want.opt_state, moment)):
            g, w = g.double(), w.double()
            w_sq = max(float((w * w).sum()), 1e-300)
            readings['scaled'] = worst(readings['scaled'], float(
                (g - w).abs().max() / max(float(w.abs().max()), 1e-300)))
            readings['rel'] = worst(readings['rel'], math.sqrt(
                float(((g - w) ** 2).sum()) / w_sq))
            readings['scale'] = worst(readings['scale'], abs(
                float((g * w).sum()) / w_sq - 1.0))
    update = 0.0
    with torch.no_grad():
        for g, w, s in zip(got.params, want.params, start):
            diff = float(((g.double() - w.double()) ** 2).sum())
            moved = max(float(((w.double() - s.double()) ** 2).sum()),
                        1e-300)
            update = worst(update, math.sqrt(diff / moved))
    out['weights'] = update
    return out


def checkpoint_phase(prefix: Path, test_path: Path, gpu: str) -> dict:
    """Saves, a reload, the release and a resume at java14m width and
    vocabulary with the fused CE, in a temporary directory under
    build/smoke/ that it removes. ``Code2VecModel.train()`` runs
    CKPT_EPOCHS epochs of three steps over train entry's split, saving
    each epoch (MAX_TO_KEEP=2) and evaluating after it; a params-only
    reload evaluates and predicts bit for bit as the model in memory; the
    newest step restores equal to the trained state; the release has no
    moments and loads under the plain route's 261,248 target rows; a
    resumed model trains the next epoch within RESUME_LIMITS of the model
    continued in memory. Times the saves and the restore. Returns the
    launches per path."""
    import torch
    from code2vec_tpu_torch import checkpoints
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.data.cache import TokenCache
    from code2vec_tpu_torch.data.reader import PathContextReader
    from code2vec_tpu_torch.model_api import Code2VecModel
    root = Path(tempfile.mkdtemp(prefix='checkpoints_', dir=SMOKE_DIR))
    save = root / 'm' / 'saved_model'
    train = dict(TRAIN_DATA_PATH_PREFIX=str(prefix), USE_PALLAS_FUSED_CE=True)
    by_path = {}
    try:
        model = Code2VecModel(Config(
            TEST_DATA_PATH=str(test_path), NUM_TRAIN_EPOCHS=CKPT_EPOCHS,
            MAX_TO_KEEP=2, MODEL_SAVE_PATH=str(save), **train),
            device='cuda', seed=7)
        zero_counts()
        t0 = time.perf_counter()
        model.train()
        train_s = time.perf_counter() - t0
        by_path['checkpoint_train'] = launch_counts()
        steps = model.state.step
        store = model._store_for(str(save))
        check(store.steps() == [steps - 3, steps] and steps == 3 * CKPT_EPOCHS,
              'retained steps %s after %d steps (MAX_TO_KEEP=2)'
              % (store.steps(), steps))
        entire = Path(store.entire_dir) / str(steps) / \
            checkpoints.CHECKPOINT_FILE
        # a timed save of the same state (replaces the newest step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.save(epoch=CKPT_EPOCHS - 1)
        save_s = time.perf_counter() - t0
        save_gb = entire.stat().st_size / 1e9
        # where a save's time goes: the card -> host copy, then torch.save
        state = model.state
        tensors = (list(state.params) + list(state.opt_state.mu)
                   + list(state.opt_state.nu))
        t0 = time.perf_counter()
        host = [t.detach().cpu() for t in tensors]
        d2h_s = time.perf_counter() - t0
        probe = root / 'probe.pt'
        t0 = time.perf_counter()
        torch.save(host, probe)
        write_s = time.perf_counter() - t0
        probe.unlink()
        del host, tensors, state
        # disk (page cache) -> host -> card
        t0 = time.perf_counter()
        restored = store.restore_training()
        on_card = {field: {name: t.to('cuda') for name, t in named.items()}
                   for field, named in (('params', restored.params),
                                        ('mu', restored.opt_state['mu']),
                                        ('nu', restored.opt_state['nu']))}
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(state_equal(model.state, on_card)
              and restored.opt_state['count'] == model.state.opt_state.count
              and restored.step == steps
              and restored.epoch == CKPT_EPOCHS - 1,
              'the restored training state differs from the saved one')
        del restored, on_card
        lines = test_path.read_text().splitlines()[:64]
        want_predict = model.predict(lines)
        want_eval = model.eval_history[-1]

        t0 = time.perf_counter()
        reload = Code2VecModel(Config(
            MODEL_LOAD_PATH=str(save), TEST_DATA_PATH=str(test_path),
            USE_PALLAS_FUSED_CE=True), device='cuda')
        reload_s = time.perf_counter() - t0
        check(reload.state is None, 'a params-only reload holds moments')
        zero_counts()
        got = reload.evaluate()
        got_predict = reload.predict(lines)
        by_path['reload_eval'] = launch_counts()
        check([float(x) for x in got.topk_acc] == want_eval['topk_acc']
              and (got.subtoken_precision, got.subtoken_recall,
                   got.subtoken_f1, got.loss)
              == (want_eval['precision'], want_eval['recall'],
                  want_eval['f1'], want_eval['loss']),
              'the reload evaluates %s, the model in memory %s'
              % (got, want_eval))
        for g, w in zip(got_predict, want_predict):
            check(g.topk_predicted_words == w.topk_predicted_words
                  and np.array_equal(g.topk_predicted_words_scores,
                                     w.topk_predicted_words_scores),
                  'the reload predicts otherwise than the model in memory')
        t0 = time.perf_counter()
        reload.release_model()
        release_s = time.perf_counter() - t0
        released = Path(store.weights_dir) / checkpoints.CHECKPOINT_FILE
        release_gb = released.stat().st_size / 1e9
        check(set(torch.load(released, weights_only=True, mmap=True))
              == {'params'}, 'the release holds more than the params')
        del reload
        plain = Code2VecModel(Config(MODEL_LOAD_PATH=str(save)),
                              device='cuda')
        rows = plain.backend.sizes['target_vocab_size']
        check(rows == 261248 and plain.state is None and all(
            torch.equal(got_t, want_t[:got_t.shape[0]].detach())
            for got_t, want_t in zip(plain.backend.params,
                                     model.state.params)),
              'the release under the plain route (%d target rows) differs '
              'from the trained weights' % rows)
        del plain
        torch.cuda.empty_cache()

        resumed = Code2VecModel(Config(
            MODEL_LOAD_PATH=str(save), TEST_DATA_PATH=str(test_path),
            NUM_TRAIN_EPOCHS=CKPT_EPOCHS + 1, **train), device='cuda')
        check(resumed._start_epoch == CKPT_EPOCHS
              and resumed.state.step == steps
              and state_equal(resumed.state, model.state),
              'the resumed state differs from the saved one')
        start = [p.detach().clone() for p in model.state.params]
        zero_counts()
        resumed_losses = resumed.train()
        by_path['resume_train'] = launch_counts()
        # the epoch the resumed model's train() read: the token cache's,
        # through a fresh cache object as the resumed model's: the same
        # sticky packed capacities, so the same dropout masks
        losses = []
        cache = TokenCache.build_or_load(model.config, model.vocabs,
                                         model.reader)
        for packed in cache.iter_epoch(model.config.TRAIN_BATCH_SIZE,
                                       seed=CKPT_EPOCHS,
                                       wire_format='packed'):
            model.state, loss = model.trainer.train_step(model.state, packed)
            losses.append(float(loss))
        check(resumed.state.step == model.state.step == steps + 3,
              'resumed %d steps, continued %d' % (resumed.state.step,
                                                  model.state.step))
        r = resume_readings(resumed.state, model.state, start)
        loss_err = abs(resumed_losses[0] - statistics.mean(losses)) / abs(
            statistics.mean(losses))
        check(loss_err <= RESUME_LIMITS['loss'], 'resumed loss %.6g vs %.6g'
              % (resumed_losses[0], statistics.mean(losses)))
        for moment in ('mu', 'nu'):
            for key, value in r[moment].items():
                check(value <= RESUME_LIMITS[key], 'resumed Adam %s: %s '
                      '%.3g > %.3g' % (moment, key, value,
                                       RESUME_LIMITS[key]))
        check(r['weights'] <= RESUME_LIMITS['weights'], 'resumed weights: '
              'update ||diff||/||update|| %.3g > %.3g'
              % (r['weights'], RESUME_LIMITS['weights']))
        del resumed, model, start
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    expected = {'checkpoint_train': STEP_KERNELS,
                'reload_eval': ('ragged_fwd',),
                'resume_train': STEP_KERNELS}
    for path, kernels in expected.items():
        counts = by_path[path]
        check(all(counts[k] > 0 for k in kernels) and all(
            counts[k] == 0 for k in counts if k not in kernels),
            'launches on the %s path: %s' % (path, counts))
    print('checkpoint: java14m width and vocabulary, fused CE: train() %d '
          'epochs of 3 steps with a save and an evaluation after each, '
          '%.1f s; entire-model save %.3f GB in %.3f s (%.3f GB/s; apart: '
          'card -> host %.3f s, torch.save of the host tensors %.3f s); '
          'restore of the newest step %.3f GB in %.3f s '
          '(%.3f GB/s: torch.load from the page cache -> card); release '
          '%.3f GB in %.3f s (%.3f GB/s); params-only reload (vocab + '
          'params) %.2f s; reload evaluate() and 64 predictions equal to '
          'the model in memory bit for bit; restored state equal; release '
          'loads at 261,248 target rows; resumed epoch vs continued in '
          'memory: loss rel err %.3g, Adam %s, update ||diff||/||update|| '
          '%.3g (limits %s); launches %s [%s]'
          % (CKPT_EPOCHS, train_s, save_gb, save_s, save_gb / save_s,
             d2h_s, write_s, save_gb, restore_s, save_gb / restore_s, release_gb, release_s,
             release_gb / release_s, reload_s, loss_err,
             {m: {k: float('%.3g' % v) for k, v in r[m].items()}
              for m in ('mu', 'nu')}, r['weights'], RESUME_LIMITS, by_path,
             gpu))
    return by_path


def cli_phase(rng, gpu: str) -> dict:
    """``code2vec_tpu_torch.cli.main`` in process on the card: train with
    --fused-ce and --save (one epoch, evaluated), ``--load --test`` (the
    plain route's target rows, sliced from the fused CE's), ``--release``,
    ``--save_word2v``; full width (dims 128/128/384, 200 contexts, B 1024)
    over a 5,000 / 3,000 / 1,000-word vocabulary, so the word2vec text
    stays small. Returns the launches."""
    import torch
    from code2vec_tpu_torch import cli
    root = Path(tempfile.mkdtemp(prefix='cli_', dir=SMOKE_DIR))
    try:
        prefix = root / 'cli'
        write_dict(Path(str(prefix) + '.dict.c2v'), 5000, 3000, 1000)
        sizes = (4999, 2999, 999)
        (root / 'cli.train.c2v').write_text(
            '\n'.join(make_lines(rng, 2100, sizes, 200)) + '\n')
        test = root / 'cli.test.c2v'
        test.write_text('\n'.join(make_lines(rng, 1024, sizes, 200)) + '\n')
        save = root / 'models' / 'saved_model'
        w2v = root / 'tokens.w2v'
        quiet = ['-v', '0']
        zero_counts()
        t0 = time.perf_counter()
        trained = cli.main(['--data', str(prefix), '--test', str(test),
                            '--save', str(save), '--epochs', '1',
                            '--fused-ce'] + quiet)
        loaded = cli.main(['--load', str(save), '--test', str(test)] + quiet)
        cli.main(['--load', str(save), '--release'] + quiet)
        cli.main(['--load', str(save), '--save_word2v', str(w2v)] + quiet)
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        check(trained.device.type == 'cuda' and loaded.device.type == 'cuda',
              'the CLI ran off the card')
        check(trained.state.step == 3 and math.isfinite(
            trained.eval_history[-1]['loss']),
            'CLI train: %d steps, evaluation %s'
            % (trained.state.step, trained.eval_history))
        check(loaded.backend.sizes['target_vocab_size'] == 1024
              and trained.backend.sizes['target_vocab_size'] == 1024,
              'target rows %d / %d' % (trained.backend.sizes[
                  'target_vocab_size'], loaded.backend.sizes[
                  'target_vocab_size']))
        log_lines = (save.parent / 'log.txt').read_text().splitlines()
        check(len(log_lines) >= 1024, 'log.txt has %d lines' % len(log_lines))
        check((Path(str(save) + '__only-weights') / 'checkpoint.pt').is_file(),
              'no release')
        w2v_lines = w2v.read_text().splitlines()
        n_tokens = trained.vocabs.token_vocab.size
        check(w2v_lines[0] == '%d 128' % n_tokens
              and len(w2v_lines) == n_tokens + 1
              and all(math.isfinite(float(v))
                      for v in w2v_lines[1].split()[1:]),
              'word2vec export: header %r, %d lines'
              % (w2v_lines[0], len(w2v_lines)))
        expected = {'ragged_fwd': 5, 'ragged_bwd': 3, 'ce_fwd': 3,
                    'ce_bwd': 3, 'encode': 0,
                    'adam_update': 3 * PARAMS_PER_STEP, 'adam_rows': 0}
        check(counts == expected, 'CLI launches %s, expected %s'
              % (counts, expected))
        print('cli: train (3 steps, --fused-ce) + save, --load --test, '
              '--release, --save_word2v (%d tokens x 128) in process on the '
              'card, %.1f s; loss after the epoch %.4f; launches %s [%s]'
              % (n_tokens, seconds, trained.eval_history[-1]['loss'], counts,
                 gpu))
        del trained, loaded
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {name: counts[name] for name in STEP_KERNELS}


# where the host data path's phases run: the card; a rehearsal on the CPU
# sets it to 'cpu' (the kernels' plain versions, counted as launches)
DEVICE = 'cuda'
PIPELINE_LINES = 32768          # 32 steps of 1024 per epoch


def median_or_nan(values) -> float:
    return statistics.median(values) if values else math.nan


def host_pipeline_phase(model, test_path: Path, gpu: str) -> int:
    """The host data path at java14m width on the smoke's vocabulary and
    4,096-line test split: the native tokenizer built (timed, into a
    fresh path) and its arrays held equal to the Python reader's on the
    test lines; each reader's host time per batch of 1024 (read,
    tokenize, filter, pack); ``evaluate()`` with the native reader and
    the staging ring against ``READER_USE_NATIVE=False`` on the same
    weights: metrics and log.txt equal; for each, the seconds, the host
    read, the device eval step, the decode and the card's idle share of
    the call. Returns the ragged forward's launches in the native
    ``evaluate()``."""
    import contextlib
    from code2vec_tpu_torch import hostbuild
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.data import native
    from code2vec_tpu_torch.data.reader import PathContextReader
    from code2vec_tpu_torch.metrics import (SubtokensEvaluationMetric,
                                            TopKAccuracyEvaluationMetric,
                                            decode_topk_batch)
    from code2vec_tpu_torch.model_api import Code2VecModel
    config = model.config
    check(config.READER_USE_NATIVE, 'the native reader is not the default')
    fresh = SMOKE_DIR / 'native_build' / 'libc2vtok.so'
    shutil.rmtree(fresh.parent, ignore_errors=True)
    t0 = time.perf_counter()
    hostbuild.build(str(fresh), native.SOURCE, native.GXX_FLAGS)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokenizer = native.NativeTokenizer(model.vocabs, config)
    upload_s = time.perf_counter() - t0
    lines = test_path.read_text().splitlines(keepends=True)
    python_config = Config(**dict(vars(config), READER_USE_NATIVE=False))
    python_reader = PathContextReader(model.vocabs, python_config)
    got = tokenizer.tokenize_lines(lines)
    want = python_reader.tokenize_lines(lines)
    for field in ('source', 'path', 'target', 'mask', 'label', 'weight'):
        check(np.array_equal(getattr(got, field), getattr(want, field)),
              'native tokenizer: %s differs from the Python reader' % field)
    print('native tokenizer: g++ build %.1f s, vocabulary upload %.2f s '
          '(%d words), %d test lines tokenized equal to the Python reader'
          % (build_s, upload_s, sum(v.size for v in (
              model.vocabs.token_vocab, model.vocabs.path_vocab,
              model.vocabs.target_vocab)), len(lines)))

    k = config.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION
    oov = model.vocabs.target_vocab.special_words.OOV
    runs = {}
    python_model = Code2VecModel(python_config, device=DEVICE,
                                 params=model.backend.params)
    for name, m in (('native', model), ('python', python_model)):
        reader = PathContextReader(m.vocabs, m.config)
        list(reader.iter_epoch(evaluate=True))      # tokenizer warm
        t0 = time.perf_counter()
        batches = list(reader.iter_epoch(evaluate=True))
        read_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
        arrays = m.trainer.place(batches[0])
        step_ms = (cuda_ms(lambda: m.trainer.eval_step_placed(arrays))
                   if DEVICE == 'cuda' else math.nan)
        out = m.trainer.eval_step_placed(arrays)
        t0 = time.perf_counter()
        fetched = {key: value.cpu().numpy() for key, value in out.items()}
        decoded = decode_topk_batch(fetched['topk_indices'],
                                    m._target_index_to_word,
                                    batches[0].label_strings,
                                    batches[0].weight)
        TopKAccuracyEvaluationMetric(k, oov).update_batch(decoded)
        SubtokensEvaluationMetric(oov).update_batch(decoded)
        with open(SMOKE_DIR / 'log_breakdown.txt', 'w') as f:
            m._log_predictions_during_evaluation(decoded, f)
        decode_ms = (time.perf_counter() - t0) * 1e3
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.chdir(SMOKE_DIR):
            results = m.evaluate()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        check(counts == {n: len(batches) * int(n == 'ragged_fwd')
                         for n in counts},
              'evaluate() (%s reader) in %d batches launched %s'
              % (name, len(batches), counts))
        log = (SMOKE_DIR / 'log.txt').read_text()
        idle = 1.0 - len(batches) * step_ms / (seconds * 1e3)
        runs[name] = (results, log, counts['ragged_fwd'])
        print('evaluate (%s reader, staging ring depth %d): %d batches in '
              '%.3f s (host clock); per batch: host read+tokenize+filter+'
              'pack %.1f ms, device eval step %.4f ms (graph replay), host '
              'fetch+decode+metrics+log %.1f ms; card idle ~%.1f%% of the '
              'call (1 - batches x step / seconds) [%s]'
              % (name, m.config.DEVICE_PREFETCH_BATCHES, len(batches),
                 seconds, read_ms, step_ms, decode_ms, 100 * idle, gpu))
    staging_check(model, list(PathContextReader(
        model.vocabs, config).iter_epoch(evaluate=True)), gpu)
    (got, got_log, launches), (want, want_log, _) = (runs['native'],
                                                    runs['python'])
    check(np.array_equal(got.topk_acc, want.topk_acc)
          and (got.subtoken_precision, got.subtoken_recall,
               got.subtoken_f1) == (want.subtoken_precision,
                                    want.subtoken_recall, want.subtoken_f1)
          and got.loss == want.loss and got_log == want_log,
          'evaluate() differs across readers: %s vs %s' % (got, want))
    print('evaluate: native and Python readers give equal metrics, loss and '
          'log.txt (%d lines)' % got_log.count('\n'))
    del python_model
    return launches


STAGING_DEPTHS = (0, 2, 4)


def staging_check(model, batches, gpu: str) -> None:
    """``Trainer.stage_batches`` at depths 0, 2 and 4 over the same host
    batches (each given four times, so the pinned buffers are refilled
    while earlier copies and steps are in flight): every batch as the
    step's stream reads it equals its host arrays (sums taken on that
    stream), and the eval step's outputs are equal bit for bit at every
    depth."""
    import torch
    trainer = model.trainer
    stream = batches * 4
    seen = {}
    for depth in STAGING_DEPTHS:
        sums, outs = [], []
        for arrays, _batch in trainer.stage_batches(iter(stream),
                                                    depth=depth):
            sums.append(torch.stack([a.double().sum() for a in arrays]))
            out = trainer.eval_step_placed(arrays)
            outs.append(torch.cat([out['topk_indices'].double().ravel(),
                                   out['loss_sum'].double().reshape(1)]))
        seen[depth] = (torch.stack(sums).cpu().numpy(),
                       torch.stack(outs).cpu().numpy())
    want_sums = np.array([[float(np.asarray(a, np.float64).sum())
                           for a in b.device_arrays()] for b in stream])
    for depth, (sums, outs) in seen.items():
        check(np.array_equal(sums, want_sums),
              'staging depth %d: a batch as the step read it differs from '
              'its host arrays' % depth)
        check(np.array_equal(outs, seen[0][1]),
              'staging depth %d: eval outputs differ from depth 0' % depth)
    pinned = trainer._pinned.buffers
    check(pinned and all(b.is_pinned() for b in pinned) or DEVICE != 'cuda',
          'staged host buffers are not pinned')
    print('staging ring: %d batches at depths %s, each as the step read it '
          'equal to its host arrays, eval outputs equal across depths; %d '
          'pinned host buffers [%s]' % (len(stream), STAGING_DEPTHS,
                                        len(pinned), gpu))


def write_pipeline_split(prefix: Path, vocab_sizes, rng) -> None:
    """``prefix.train.c2v`` of PIPELINE_LINES synthetic java14m lines,
    beside the java14m vocabulary (linked)."""
    java14m = SMOKE_DIR / 'java14m.dict.c2v'
    link = Path(str(prefix) + '.dict.c2v')
    if not link.exists():
        link.symlink_to(java14m.name)
    with open(str(prefix) + '.train.c2v', 'w') as f:
        for start in range(0, PIPELINE_LINES, 4096):
            n = min(4096, PIPELINE_LINES - start)
            f.write('\n'.join(make_lines(rng, n, vocab_sizes, 200)) + '\n')


def train_epochs_report(name: str, timings, step_ms: float, gpu: str
                        ) -> None:
    for t in timings:
        wall_ms = t['seconds'] * 1e3
        intervals = t['interval_ms']
        print('train (%s) epoch %d: %d steps in %.3f s; step interval '
              'median %.3f ms, mean %.3f ms (CUDA events between steps\' '
              'ends); wait for the next staged batch: first %.1f ms, '
              'median %.3f ms, total %.1f ms (host clock); a step on one '
              'repeated batch %.3f ms (CUDA events, steps back to back); '
              'card idle ~%.1f%% of the epoch (1 - steps x that step / '
              'wall) [%s]'
              % (name, t['epoch'] + 1, t['steps'], t['seconds'],
                 median_or_nan(intervals),
                 statistics.mean(intervals) if intervals else math.nan,
                 t['wait_s'][0] * 1e3, median_or_nan(t['wait_s']) * 1e3,
                 sum(t['wait_s']) * 1e3, step_ms,
                 100 * (1 - t['steps'] * step_ms / wall_ms), gpu))


def repeated_step_ms(model, batch) -> float:
    """Device ms of a train step on one staged batch, steps queued back to
    back (CUDA events between their ends, median of 8; nan off the
    card). The model's state moves on with the steps."""
    import torch
    arrays = model.trainer.place(batch)
    state = model.state
    ends = []
    for _ in range(12):
        state, loss = model.trainer.train_step_placed(state, arrays)
        if DEVICE == 'cuda':
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
    float(loss)
    model.state = state
    return median_or_nan([a.elapsed_time(b) for a, b in
                          zip(ends[3:], ends[4:])])


def train_pipeline_phase(vocab_sizes, rng, gpu: str) -> dict:
    """``train()`` fed by the host data path at java14m width and
    vocabulary (fused CE, bf16, keep 0.75) over a synthetic split of
    PIPELINE_LINES lines: two epochs from the token cache (built before
    the first), then one with TRAIN_DATA_CACHE=False (the native
    tokenizer behind the prefetch thread). Prints the cache build's
    seconds and bytes, each epoch's step interval and wait for the next
    staged batch, beside the device time of a step on one repeated batch
    (steps queued back to back); checks each step launched the four training kernels once, the
    losses are finite and the staging ring's host buffers are pinned.
    Returns the launches per path."""
    import torch
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.data.cache import TokenCache
    from code2vec_tpu_torch.model_api import Code2VecModel
    prefix = SMOKE_DIR / 'pipeline'
    t0 = time.perf_counter()
    write_pipeline_split(prefix, vocab_sizes, rng)
    shutil.rmtree(str(prefix) + '.train.c2v.tokcache', ignore_errors=True)
    print('train pipeline: wrote %d lines (%.1f MB) in %.1f s'
          % (PIPELINE_LINES, Path(str(prefix) + '.train.c2v').stat().st_size
             / 1e6, time.perf_counter() - t0))
    launches = {}
    steps = PIPELINE_LINES // 1024
    for name, cache, epochs in (('train_cache', True, 2),
                                ('train_native', False, 1)):
        config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                        USE_PALLAS_FUSED_CE=True, NUM_TRAIN_EPOCHS=epochs,
                        TRAIN_DATA_CACHE=cache)
        model = Code2VecModel(config, device=DEVICE, seed=7)
        # the tokenizer (built in train() for the cache, else on the
        # prefetch thread at the first batch) loaded before the epochs
        t0 = time.perf_counter()
        model.reader.native_tokenizer()
        print('train (%s): native tokenizer loaded and its vocabulary '
              'uploaded in %.2f s, before train()' % (
                  name, time.perf_counter() - t0))
        timings = []
        zero_counts()
        losses = model.train(timings=timings)
        counts = train_counts()
        check(model.state.step == epochs * steps
              and all(math.isfinite(x) for x in losses),
              '%s: %d steps, losses %s' % (name, model.state.step, losses))
        check_step_launches(counts, model.state.step, name)
        pinned = model.trainer._pinned.buffers
        check(DEVICE != 'cuda' or (pinned and all(b.is_pinned()
                                                   for b in pinned)),
              '%s: staged host buffers not pinned' % name)
        launches[name] = counts
        # one batch of the split, staged once, stepped repeatedly
        if cache:
            cache_dir = str(prefix) + '.train.c2v.tokcache'
            print('train (%s): token cache built in %.2f s, %d bytes '
                  '(%.2f MB) for %d rows; %d pinned host buffers'
                  % (name, timings[0]['cache_build_s'],
                     timings[0]['cache_bytes'],
                     timings[0]['cache_bytes'] / 1e6,
                     TokenCache(cache_dir, config, model.vocabs).num_rows,
                     len(pinned)))
            batch = next(TokenCache(cache_dir, config, model.vocabs)
                         .iter_epoch(1024, seed=9, wire_format='packed'))
        else:
            batch = next(model.reader.iter_epoch(seed=9))
        step_ms = repeated_step_ms(model, batch)
        train_epochs_report(name, timings, step_ms, gpu)
        print('train (%s): mean losses %s; launches %s (each kernel once a '
              'step) [%s]' % (name, ['%.4f' % x for x in losses], counts,
                              gpu))
        del model
        if DEVICE == 'cuda':
            torch.cuda.empty_cache()
    return launches


DENSE_ROUTES = (('train_planes', ['--wire-format', 'planes'], 2),
                ('train_unpack', ['--no-ragged-fusion'], 1))
# the CE kernels' device work in a profiled step, by kernel name (``\b``:
# not inside another name, such as a device_reduce)
CE_FWD_KERNELS = r'\bce_(fwd|merge)_'
CE_BWD_KERNELS = r'\bce_(bwd|reduce)_'




def profiled_ce_ms(model, batch, gpu: str, steps: int = 4) -> dict:
    """The CE kernels' device ms per step as the dense route launches them
    (torch.profiler over ``steps`` train steps on one batch), by pass;
    None where the trace holds no device time. Prints the step's eight
    largest kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    arrays = model.trainer.place(batch)
    state, _loss = model.trainer.train_step_placed(model.state, arrays)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _loss = model.trainer.train_step_placed(state, arrays)
        torch.cuda.synchronize()
    model.state = state
    out = {'fwd': 0.0, 'bwd': 0.0}
    by_kernel = []
    for event in prof.key_averages():
        total_us = getattr(event, 'device_time_total', None)
        if total_us is None:
            total_us = getattr(event, 'cuda_time_total', 0.0)
        if total_us:
            by_kernel.append((total_us / steps / 1e3, event.key[:60]))
        for part, pattern in (('fwd', CE_FWD_KERNELS),
                              ('bwd', CE_BWD_KERNELS)):
            if re.search(pattern, event.key):
                out[part] += total_us / steps / 1e3
    by_kernel.sort(reverse=True)
    print('train (train_planes) step by kernel (torch.profiler, device ms '
          'per step, the 8 largest of %.3f): %s [%s]'
          % (sum(ms for ms, _ in by_kernel),
             '; '.join('%s %.3f' % (name, ms) for ms, name in by_kernel[:8]),
             gpu))
    return {part: (ms if ms > 0 else None) for part, ms in out.items()}


def plane_step_reference(model) -> dict:
    """One plane-wire step at keep 1.0 on the card through the CE kernels,
    against the same step with the CE's plain versions: the loss's
    relative difference and each gradient's scaled error (the target
    table's label rows and other rows apart)."""
    import torch
    from code2vec_tpu_torch.data.cache import TokenCache
    from code2vec_tpu_torch.models import functional
    from code2vec_tpu_torch.models.functional import Code2VecParams
    from code2vec_tpu_torch.ops import ce
    backend = model.backend
    cache = model.config.train_data_path + '.tokcache'
    batch = next(TokenCache(cache, model.config, model.vocabs).iter_epoch(
        1024, seed=11, wire_format='planes'))
    arrays = model.trainer.place(batch)

    def step():
        params = Code2VecParams(*[p.detach().clone().requires_grad_()
                                  for p in backend.params])
        loss, _aux = functional.loss_and_aux(
            params, *arrays, dtype=backend.dtype, keep_rate=1.0,
            num_valid_targets=backend.num_valid_targets, use_fused_ce=True)
        loss.backward()
        return float(loss.detach()), [p.grad for p in params]

    loss, grads = step()
    kernels = (ce._lse_pick_kernel, ce._ce_grads_kernel)
    ce._lse_pick_kernel = ce._lse_pick_plain
    ce._ce_grads_kernel = ce._ce_grads_plain
    try:
        plain_loss, plain_grads = step()
    finally:
        ce._lse_pick_kernel, ce._ce_grads_kernel = kernels
    label = arrays[4][arrays[5] > 0].long()
    is_label = torch.zeros(grads[2].shape[0], dtype=torch.bool,
                           device=label.device)
    is_label[label] = True
    errs = {name: scaled_err([g], [w]) for name, g, w in zip(
        Code2VecParams._fields, grads, plain_grads)
        if name != 'target_embedding'}
    errs['target label rows'] = scaled_err([grads[2][is_label]],
                                           [plain_grads[2][is_label]])
    errs['target other rows'] = scaled_err([grads[2][~is_label]],
                                           [plain_grads[2][~is_label]])
    errs['loss'] = abs(loss - plain_loss) / abs(plain_loss)
    return errs


def snapshot_and_rewind_s(model) -> tuple:
    """A step snapshot of the model's java14m state (seconds, GB) and the
    divergence guard's rewind from it (restore under the step ceiling and
    the state made on the card, seconds), in a directory under
    build/smoke/ that it removes."""
    import torch
    root = Path(tempfile.mkdtemp(prefix='snapshot_', dir=SMOKE_DIR))
    try:
        path = str(root / 'm' / 'saved_model')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.save(path, epoch=0, snapshot=True)
        save_s = time.perf_counter() - t0
        store = model._store_for(path)
        step = int(model.state.step)
        files = Path(store.snapshot_dir) / str(step)
        gb = sum(f.stat().st_size for f in files.iterdir()) / 1e9
        check(store.steps() == [] and store.has_step(step),
              'the snapshot did not land in the snapshot directory')
        t0 = time.perf_counter()
        restored = store.restore_training(max_step=step)
        state = model.trainer.state_from_restored(
            restored.params, restored.opt_state, restored.step)
        torch.cuda.synchronize()
        rewind_s = time.perf_counter() - t0
        check(state.step == step and restored.epoch == 0,
              'rewound to step %d' % state.step)
        model.state = state
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return save_s, gb, rewind_s


def dense_route_phase(gpu: str) -> dict:
    """``Code2VecModel.train()`` on the dense routes at java14m width and
    vocabulary (fused CE, bf16, keep 0.75) over the train pipeline's
    split and token cache: the plane wire (``--wire-format planes``) two
    epochs, the packed wire unpacked on the card (``--no-ragged-fusion``)
    one. Each step launches ``ce_fwd`` and ``ce_bwd`` once and Adam once a
    parameter, no ragged and no encode kernel; the plane wire's loss
    falls. Prints each route's step interval (CUDA events) and, on one
    repeated batch, its device step beside the packed ragged route's, the
    CE kernels' device ms per step as the plane step launches them
    (torch.profiler), one plane step at keep 1.0 against the same step
    with the CE's plain versions, and a java14m step snapshot's save and
    rewind seconds. Returns the launches per path."""
    import torch
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.data.cache import TokenCache
    from code2vec_tpu_torch.model_api import Code2VecModel
    prefix = SMOKE_DIR / 'pipeline'
    steps_per_epoch = PIPELINE_LINES // 1024
    launches, step_ms = {}, {}
    for name, flags, epochs in DENSE_ROUTES:
        config = Config().load_from_args(
            ['--data', str(prefix), '--fused-ce', '--epochs', str(epochs),
             '-v', '0'] + flags)
        model = Code2VecModel(config, device=DEVICE, seed=7)
        timings = []
        zero_counts()
        losses = model.train(timings=timings)
        counts = launch_counts()
        steps = model.state.step
        check(steps == epochs * steps_per_epoch
              and all(math.isfinite(x) for x in losses),
              '%s: %d steps, losses %s' % (name, steps, losses))
        expected = {'ragged_fwd': 0, 'ragged_bwd': 0, 'ce_fwd': steps,
                    'ce_bwd': steps, 'encode': 0,
                    'adam_update': PARAMS_PER_STEP * steps, 'adam_rows': 0}
        check(counts == expected, '%s: launches %s, expected %s'
              % (name, counts, expected))
        if epochs > 1:
            check(losses[-1] < losses[0], '%s: the loss did not fall: %s'
                  % (name, losses))
        launches[name] = {k: counts[k] for k in STEP_KERNELS}
        wire = 'planes' if config.BATCH_WIRE_FORMAT == 'planes' else 'packed'
        batch = next(TokenCache(str(prefix) + '.train.c2v.tokcache', config,
                                model.vocabs).iter_epoch(
            1024, seed=9, wire_format=wire))
        step_ms[name] = repeated_step_ms(model, batch)
        train_epochs_report(name, timings, step_ms[name], gpu)
        print('train (%s): %d steps through Code2VecModel.train() (%s), '
              'mean losses %s; launches %s (ce_fwd and ce_bwd once a step, '
              'no ragged or encode kernel) [%s]'
              % (name, steps, ' '.join(flags), ['%.4f' % x for x in losses],
                 counts, gpu))
        if name == 'train_planes':
            ce_ms = profiled_ce_ms(model, batch, gpu)
            errs = plane_step_reference(model)
            limit = TRAIN_REF_LIMITS['bfloat16']
            check(errs['loss'] <= limit['loss']
                  and all(v <= limit['scaled'] for k, v in errs.items()
                          if k != 'loss'),
                  'plane step: CE kernels against their plain versions %s '
                  '(limits loss %.3g, scaled %.3g)'
                  % (errs, limit['loss'], limit['scaled']))
            shown = {part: 'not measured' if ms is None else '%.4f ms' % ms
                     for part, ms in ce_ms.items()}
            print('train (train_planes): CE kernels as the plane step '
                  'launches them (torch.profiler, per step): ce_fwd %s, '
                  'ce_bwd %s; one plane step at keep 1.0, CE kernels '
                  'against the CE\'s plain versions: %s (limits: loss %.3g, '
                  'each gradient part %.3g of its scale) [%s]'
                  % (shown['fwd'], shown['bwd'],
                     {k: float('%.3g' % v) for k, v in errs.items()},
                     limit['loss'], limit['scaled'], gpu))
            save_s, gb, rewind_s = snapshot_and_rewind_s(model)
            print('step snapshot (java14m state, %.3f GB): save %.3f s '
                  '(%.2f GB/s); rewind (restore under the step ceiling, '
                  'state on the card) %.3f s [%s]'
                  % (gb, save_s, gb / save_s, rewind_s, gpu))
        del model
        torch.cuda.empty_cache()
    # the packed wire's ragged route on the same rows, for comparison
    config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                    USE_PALLAS_FUSED_CE=True)
    model = Code2VecModel(config, device=DEVICE, seed=7)
    model.state = model.trainer.state_from_params()
    batch = next(TokenCache(str(prefix) + '.train.c2v.tokcache', config,
                            model.vocabs).iter_epoch(1024, seed=9,
                                                     wire_format='packed'))
    step_ms['train_packed'] = repeated_step_ms(model, batch)
    del model
    torch.cuda.empty_cache()
    print('train step on one repeated batch (device ms, CUDA events): plane '
          'wire %.3f, packed unpacked %.3f, packed ragged %.3f [%s]'
          % (step_ms['train_planes'], step_ms['train_unpack'],
             step_ms['train_packed'], gpu))
    return launches


DRILL_LINES = 4096              # 4 steps of 1024 an epoch


def drill_model(prefix: Path, root: Path, load: bool = False, **knobs):
    """A model of the drills' small vocabulary at full width, saving (or
    loading) under ``root``."""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    save = str(root / 'm' / 'saved_model')
    knobs = dict(dict(TRAIN_DATA_PATH_PREFIX=str(prefix),
                      USE_PALLAS_FUSED_CE=True, SAVE_EVERY_EPOCHS=1000,
                      TELEMETRY_DIR=str(root / 'tele'), FAULT_INJECT=''),
                 **knobs)
    knobs['MODEL_LOAD_PATH' if load else 'MODEL_SAVE_PATH'] = save
    return Code2VecModel(Config(**knobs), device=DEVICE, seed=9)


def drill_counts(steps: int, what: str) -> dict:
    counts = train_counts()
    check_step_launches(counts, steps, what)
    return counts


def resilience_phase(rng, gpu: str) -> dict:
    """The training resilience drills on the card, on the packed wire's
    kernels, at full width over a 5,000 / 3,000 / 1,000-word vocabulary
    and a 4,096-line split (4 steps an epoch), each under a directory of
    build/smoke/ that it removes: ``nan_loss`` with step snapshots (one
    rewind, finite losses after), ``sigterm`` (a snapshot and
    PREEMPTED.json, a resume that goes on from its step, metrics.jsonl
    under -tb with train/loss on a monotonic step axis),
    ``corrupt_snapshot`` (the restore falls back a step and quarantines
    the corrupt one), and ``hang_input`` under ``--watchdog-secs`` in a
    subprocess of the CLI, which ends by SIGABRT with watchdog_stacks.txt
    naming the hung frame. Returns the drills' launches."""
    import signal
    import subprocess
    import torch
    prefix = SMOKE_DIR / 'drills'
    write_dict(Path(str(prefix) + '.dict.c2v'), 5000, 3000, 1000)
    Path(str(prefix) + '.train.c2v').write_text('\n'.join(make_lines(
        rng, DRILL_LINES, (4999, 2999, 999), 200)) + '\n')
    total = {name: 0 for name in STEP_KERNELS}

    def add(counts):
        for name in STEP_KERNELS:
            total[name] += counts[name]

    roots = []

    def new_root(name):
        roots.append(Path(tempfile.mkdtemp(prefix=name + '_',
                                           dir=SMOKE_DIR)))
        return roots[-1]
    try:
        # nan_loss: the window of batches 4-5, synced at 6, rewinds to the
        # step-4 snapshot; 12 batches end at step 10
        root = new_root('nan')
        model = drill_model(prefix, root, NUM_TRAIN_EPOCHS=3,
                            SAVE_EVERY_N_STEPS=2,
                            NUM_BATCHES_TO_LOG_PROGRESS=2,
                            FAULT_INJECT='nan_loss@step=5')
        zero_counts()
        t0 = time.perf_counter()
        losses = model.train()
        nan_s = time.perf_counter() - t0
        add(drill_counts(12, 'nan_loss drill'))
        dump = json.loads((root / 'tele' / 'divergence_step6.json')
                          .read_text())
        check(model.state.step == 10 and all(math.isfinite(x)
                                             for x in losses)
              and not all(math.isfinite(x) for x in dump['window_losses']),
              'nan_loss drill: step %d, epoch losses %s, dump %s'
              % (model.state.step, losses, dump['window_losses']))
        print('drill nan_loss@step=5 (SAVE_EVERY_N_STEPS=2): one rewind to '
              'step 4, 12 batches end at step %d, epoch losses %s (finite), '
              'dump window %s; train() %.2f s [%s]'
              % (model.state.step, ['%.4f' % x for x in losses],
                 dump['window_losses'], nan_s, gpu))
        del model

        # sigterm: the snapshot at step 5 and the marker, then a resume
        root = new_root('sigterm')
        knobs = dict(NUM_TRAIN_EPOCHS=3, NUM_BATCHES_TO_LOG_PROGRESS=2,
                     USE_TENSORBOARD=True)
        model = drill_model(prefix, root, FAULT_INJECT='sigterm@step=5',
                            **knobs)
        zero_counts()
        model.train()
        add(drill_counts(5, 'sigterm drill'))
        snapshots = root / 'm' / 'saved_model__step-snapshots'
        marker = json.loads((snapshots / 'PREEMPTED.json').read_text())
        check(model.state.step == 5 and (snapshots / '5').is_dir()
              and marker['step'] == 5
              and marker['last_complete_epoch'] == 0,
              'sigterm drill: step %d, marker %s'
              % (model.state.step, marker))
        del model
        resumed = drill_model(prefix, root, load=True, **knobs)
        check(resumed.state.step == 5 and resumed._start_epoch == 1
              and not (snapshots / 'PREEMPTED.json').exists(),
              'resume after sigterm: step %d, epoch %d'
              % (resumed.state.step, resumed._start_epoch))
        zero_counts()
        resumed.train()
        add(drill_counts(8, 'resume after sigterm'))
        check(resumed.state.step == 13, 'resumed to step %d'
              % resumed.state.step)
        by_tag = {}
        for line in (root / 'm' / 'summaries' / 'metrics.jsonl'
                     ).read_text().splitlines():
            entry = json.loads(line)
            by_tag.setdefault(entry['tag'], []).append(entry['step'])
        check('train/loss' in by_tag and all(
            steps == sorted(steps) for steps in by_tag.values()),
            'metrics.jsonl: %s' % by_tag)
        print('drill sigterm@step=5: snapshot and PREEMPTED.json at step 5, '
              'resumed at epoch 2 to step %d; metrics.jsonl train/loss at '
              'steps %s [%s]' % (resumed.state.step, by_tag['train/loss'],
                                 gpu))
        del resumed

        # corrupt_snapshot: snapshots 2, 4, 6 (two kept), 6 corrupted
        root = new_root('corrupt')
        model = drill_model(prefix, root, NUM_TRAIN_EPOCHS=2,
                            SAVE_EVERY_N_STEPS=2,
                            FAULT_INJECT='corrupt_snapshot@save=2')
        zero_counts()
        model.train()
        add(drill_counts(8, 'corrupt_snapshot drill'))
        del model
        resumed = drill_model(prefix, root, load=True, NUM_TRAIN_EPOCHS=2)
        snapshots = root / 'm' / 'saved_model__step-snapshots'
        check(resumed.state.step == 4 and (snapshots / '6.corrupt').is_dir()
              and not (snapshots / '6').exists(),
              'corrupt_snapshot drill: resumed at step %d, snapshots %s'
              % (resumed.state.step, sorted(p.name for p in
                                            snapshots.iterdir())))
        print('drill corrupt_snapshot@save=2: the restore fell back from '
              'step 6 to 4, quarantined %s [%s]'
              % (sorted(p.name for p in snapshots.iterdir()), gpu))
        del resumed
        torch.cuda.empty_cache()

        # hang_input: a CLI process on the card, aborted by the watchdog
        root = new_root('hang')
        env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
                   + os.environ.get('PYTHONPATH', ''))
        env.pop('FAULT_INJECT', None)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-m', 'code2vec_tpu_torch.cli', '--data',
             str(prefix), '--epochs', '1', '--fused-ce', '--no-data-cache',
             '--fault-inject', 'hang_input@step=1', '--watchdog-secs', '10',
             '--device', DEVICE, '-v', '0'], cwd=str(root), env=env,
            capture_output=True,
            text=True, timeout=300)
        hang_s = time.perf_counter() - t0
        stacks_path = root / 'telemetry' / 'watchdog_stacks.txt'
        stacks = stacks_path.read_text() if stacks_path.exists() else ''
        # the label names the batch the loop waits for: the staging ring
        # reads DEVICE_PREFETCH_BATCHES (2) ahead, so on the card the hang
        # at the reader's second batch holds up the first handout
        check(proc.returncode == -signal.SIGABRT
              and 'waiting on: next staged batch (batch 0)' in stacks
              and 'fault_site_batches' in stacks,
              'hang_input drill: exit %s, stacks %r, stderr %s'
              % (proc.returncode, stacks[:300], proc.stderr[-2000:]))
        print('drill hang_input@step=1 (--watchdog-secs 10): the CLI process '
              'ended by SIGABRT after %.1f s; watchdog_stacks.txt names the '
              'wait (%s) and the hung frame (fault_site_batches) [%s]'
              % (hang_s, stacks.splitlines()[0], gpu))
    finally:
        for root in roots:
            shutil.rmtree(root, ignore_errors=True)
    return {'resilience': total}


def source_to_repl_phase(rng, gpu: str) -> dict:
    """The README's path from source, on the card: the extractor built
    from extractor/src (timed); Java files from scripts/gen_java_corpus.py
    (a subprocess); data/extract_driver.py and data/preprocess.py (each a
    subprocess); then ``cli.main`` in process: train one epoch at full
    width (dims 128/128/384, 200 contexts, B 1024) over the preprocessed
    vocabulary, ``--load --test``, and ``--predict`` with the shell's
    input scripted (one file, then exit): each turn launches the ragged
    forward once and no other kernel. Prints the predicted names.
    Returns the launches per path."""
    import builtins
    import contextlib
    import io
    import subprocess
    from code2vec_tpu_torch import cli, hostbuild
    from code2vec_tpu_torch.serving import extractor_bridge
    from code2vec_tpu_torch.vocab import VocabType
    root = Path(tempfile.mkdtemp(prefix='source_', dir=SMOKE_DIR))
    try:
        fresh = root / 'bin' / 'c2v-extract'
        t0 = time.perf_counter()
        hostbuild.build(str(fresh), str(Path(
            extractor_bridge.EXTRACTOR_SOURCES) / 'main.cpp'),
            extractor_bridge.GXX_FLAGS)
        build_s = time.perf_counter() - t0
        binary = extractor_bridge.build_extractor()
        env = dict(os.environ, PYTHONPATH=str(ROOT))

        def run(*args):
            proc = subprocess.run([sys.executable, *args], cwd=root,
                                  env=env, capture_output=True, text=True,
                                  timeout=600)
            check(proc.returncode == 0, '%s failed: %s'
                  % (' '.join(args), proc.stderr[-2000:]))
            return proc

        t0 = time.perf_counter()
        run(str(ROOT / 'scripts' / 'gen_java_corpus.py'), '-o', 'java',
            '--classes', '1200', '--seed', '7')
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for split in ('train', 'val', 'test'):
            run('-m', 'code2vec_tpu_torch.data.extract_driver', '--dir',
                'java/' + split, '--output', split + '.raw', '--workers',
                '4', '--extractor', binary)
        extract_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run('-m', 'code2vec_tpu_torch.data.preprocess', '-trd', 'train.raw',
            '-vd', 'val.raw', '-ted', 'test.raw', '-o', 'ds', '--seed', '0')
        preprocess_s = time.perf_counter() - t0
        rows = {split: (root / ('ds.%s.c2v' % split)).read_text().count('\n')
                for split in ('train', 'val', 'test')}
        print('source: extractor g++ build %.1f s; gen_java_corpus %.1f s, '
              '%d files; extract_driver %.1f s; preprocess %.1f s; rows %s'
              % (build_s, gen_s, len(list((root / 'java').rglob('*.java'))),
                 extract_s, preprocess_s, rows))

        save = root / 'models' / 'saved_model'
        device = ['--device', DEVICE, '-v', '0']
        zero_counts()
        t0 = time.perf_counter()
        trained = cli.main(['--data', str(root / 'ds'), '--test',
                            str(root / 'ds.val.c2v'), '--save', str(save),
                            '--epochs', '1'] + device)
        loaded = cli.main(['--load', str(save), '--test',
                           str(root / 'ds.test.c2v')] + device)
        train_eval = launch_counts()
        steps = -(-rows['train'] // 1024)
        check(trained.state.step == steps
              and math.isfinite(trained.eval_history[-1]['loss']),
              'source train: %d steps, %s' % (trained.state.step,
                                             trained.eval_history))
        sizes = [trained.vocabs.get(t).size for t in
                 (VocabType.Token, VocabType.Path, VocabType.Target)]
        print('source cli: train 1 epoch (%d steps) + evaluate + --load '
              '--test in %.1f s, vocab %s; after the epoch %s; launches %s '
              '[%s]' % (steps, time.perf_counter() - t0, sizes,
                        {k: trained.eval_history[-1][k]
                         for k in ('loss', 'f1')}, train_eval, gpu))
        del trained, loaded

        source = sorted((root / 'java' / 'test').rglob('*.java'))[0]
        turns = []
        replies = iter(['', 'exit'])

        def scripted_input():
            turns.append(launch_counts())
            return next(replies)

        out = io.StringIO()
        real_input = builtins.input
        builtins.input = scripted_input
        try:
            with contextlib.redirect_stdout(out):
                cli.main(['--load', str(save), '--predict', '--input-file',
                          str(source)] + device)
        finally:
            builtins.input = real_input
        report = out.getvalue()
        turn = {n: turns[1][n] - turns[0][n] for n in turns[0]}
        check(turn == {n: int(n == 'ragged_fwd') for n in turn},
              'a shell turn launched %s' % turn)
        # each method's name and its first prediction
        names, predicted = [], []
        for line in report.splitlines():
            if line.startswith('Original name:'):
                names.append(line.split('\t', 1)[1])
            elif 'predicted: ' in line and len(predicted) < len(names):
                predicted.append(line.split('predicted: ', 1)[1])
        check(names and 'Attention:' in report
              and report.rstrip().endswith('Exiting...'),
              'shell report: %r' % report[-2000:])
        print('repl: %s, %d methods; (name, first prediction) %s; one turn '
              'launched %s [%s]' % (source.name, len(names),
                                    list(zip(names, predicted)), turn, gpu))
        return {'source': {n: train_eval[n] for n in STEP_KERNELS},
                'repl': {'ragged_fwd': turn['ragged_fwd']}}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------ serving engine
ENGINE_BUCKETS = ((8, 5), (64, 50), (512, 400), (1024, 1000))
ENGINE_TIERS = ('topk', 'attention', 'full')
LOAD_THREADS = 8
LOAD_SECONDS = 5.0
# the engine against Code2VecModel.predict is held bit for bit: predict
# packs at bucketed_capacity and the engine at a ladder rung, but the bf16
# forward's tiles follow the examples' starts, not the capacity, and a
# capacity's extra slots are PAD that adds 0.0


def engine_lines(rng, n: int, sizes, max_contexts: int, draw: int) -> list:
    """``n`` lines, two of them with no valid context (one with none at
    all, one whose every context is the all-PAD triple: count 0 on the
    wire); the rest at the java14m fill (draw 1), at 1-3 contexts (draw
    0) or at 100-200 (draw 2), so one bucket lands on several capacity
    rungs."""
    counts = (rng.integers(1, 4, n - 2) if draw == 0 else
              rng.integers(100, max_contexts + 1, n - 2) if draw == 2
              else context_counts(rng, max(n - 2, 4), max_contexts)[:n - 2])
    return make_lines(rng, n - 2, sizes, max_contexts, counts) + [
        target_word(1) + ' ', target_word(2) + ' ,, ,,']


def tile_lines(rng, n: int, sizes) -> list:
    """``n`` lines of exactly 64 contexts: coalesced, each row fills one
    64-slot tile of the bf16 ragged forward whatever its position in the
    batch, so a row's arithmetic does not depend on its batchmates."""
    return make_lines(rng, n, sizes, 64, np.full(n, 64))


def result_diff(got, want, what: str) -> float:
    """Largest |difference| of the scores, attention and code vectors of
    two result lists; names, top-k words and attention keys must be
    equal."""
    check(len(got) == len(want), '%s: %d results for %d'
          % (what, len(got), len(want)))
    diff = 0.0
    for g, w in zip(got, want):
        check(g.original_name == w.original_name
              and g.topk_predicted_words == w.topk_predicted_words,
              '%s: top-k words differ' % what)
        check(g.attention_per_context.keys() == w.attention_per_context.keys(),
              '%s: attention contexts differ' % what)
        for a, b in ((g.topk_predicted_words_scores,
                      w.topk_predicted_words_scores),
                     (g.code_vector, w.code_vector),
                     (np.array(list(g.attention_per_context.values())),
                      np.array(list(w.attention_per_context.values())))):
            check((a is None) == (b is None), '%s: outputs differ' % what)
            if a is not None and np.size(a):
                diff = worst(diff, float(np.abs(
                    np.asarray(a, np.float64) - np.asarray(b, np.float64)
                ).max()))
    return diff


def engine_parity(engine, model, rng, gpu: str, buckets=ENGINE_BUCKETS
                  ) -> list:
    """The engine against ``Code2VecModel.predict`` at each bucket and
    tier (lines with count-0 and all-PAD rows), then the same cases
    again with the graph keys in a shuffled order. Returns the cases
    ``(lines, tier, want)``."""
    config = model.config
    sizes = tuple(v.size - 1 for v in (model.vocabs.token_vocab,
                                       model.vocabs.path_vocab,
                                       model.vocabs.target_vocab))
    cases, rungs = [], []
    for bucket, n in buckets:
        for draw in range(3):
            lines = engine_lines(rng, n, sizes, config.MAX_CONTEXTS, draw)
            for tier in ENGINE_TIERS:
                want = model.predict(lines, tier=tier)
                got = engine.predict(lines, tier=tier, timeout=300)
                dispatch = engine.last_dispatch
                check(dispatch['bucket'] == bucket,
                      'engine bucket %r for %d lines' % (dispatch, n))
                diff = result_diff(got, want, 'engine vs predict b%d %s'
                                   % (bucket, tier))
                check(diff == 0, 'engine vs predict at bucket %d tier %s: '
                      'max |diff| %.3g' % (bucket, tier, diff))
                cases.append((lines, tier, want))
                rungs.append(dispatch['capacity'])
    order = rng.permutation(len(cases))
    for i in order:
        lines, tier, want = cases[i]
        check(result_diff(engine.predict(lines, tier=tier, timeout=300),
                          want, 'shuffled replay') == 0,
              'a replay in shuffled key order differs')
    print('engine parity (%s wire): %d cases (buckets %s x tiers %s, '
          'rungs %s, count-0 and all-PAD rows) then again in shuffled key '
          'order: top-k, scores, attention and code vectors bit-equal to '
          'Code2VecModel.predict [%s]'
          % (engine.wire, len(cases), [b for b, _ in buckets],
             list(ENGINE_TIERS), sorted(set(rungs)), gpu))
    return cases


def small_call_latency(engine, model, lines, gpu: str, reps: int = 30
                       ) -> tuple:
    """p50 ms of one request of ``lines`` (bucket 8) alone: through the
    engine, and through ``Code2VecModel.predict`` (eager)."""
    def p50(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)
    engine_ms = p50(lambda: engine.predict(lines, tier='topk', timeout=300))
    eager_ms_ = p50(lambda: model.predict(lines, tier='topk'))
    print('engine latency, one request of %d lines (bucket 8, topk), p50 '
          'of %d: engine %.2f ms, eager predict %.2f ms [%s]'
          % (len(lines), reps, engine_ms, eager_ms_, gpu))
    return engine_ms, eager_ms_


def replay_device_ms(engine, keys, cache: dict) -> dict:
    """Each graph's device ms (one replay, CUDA events), cached."""
    for key in keys:
        if key not in cache:
            cache[key] = engine.ladder.replay_ms(key)
    return cache


def engine_load(engine, pool_lines, mix, seconds: float, gpu: str,
                tag: str, ms_cache: dict) -> dict:
    """LOAD_THREADS caller threads submit requests of 1-64 lines from
    ``pool_lines`` at tiers from ``mix`` for ``seconds`` each: requests/s,
    rows/s, p50/p99 latency, the mean batch fill and the card's idle
    share (1 - replays x each graph's device ms / wall). No kernel
    wrapper may launch meanwhile: every batch is a graph replay."""
    import threading
    zero_counts()
    before = engine.stats()
    replays0 = engine.ladder.counts()[1]
    done, errors = [], []
    lock = threading.Lock()

    def caller(seed):
        r = np.random.default_rng(seed)
        end = time.perf_counter() + seconds
        mine = []
        try:
            while time.perf_counter() < end:
                n = int(r.integers(1, 65))
                start = int(r.integers(0, len(pool_lines) - n))
                tier = mix[int(r.integers(len(mix)))]
                t0 = time.perf_counter()
                results = engine.predict(pool_lines[start:start + n],
                                         tier=tier, timeout=300)
                mine.append((start, n, tier, time.perf_counter() - t0))
                check(len(results) == n, 'wrong result count under load')
        except BaseException as exc:
            errors.append(exc)
        with lock:
            done.extend(mine)

    threads = [threading.Thread(target=caller, args=(100 + i,))
               for i in range(LOAD_THREADS)]
    t0 = time.perf_counter()
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    wall = time.perf_counter() - t0
    check(not errors, 'load: %r' % errors[:3])
    launched = {k: n for k, n in launch_counts().items() if n}
    check(not launched, 'kernel wrappers launched under load (no graph '
          'replay): %s' % launched)
    after = engine.stats()
    delta = {k: n - replays0.get(k, 0)
             for k, n in engine.ladder.counts()[1].items()
             if n > replays0.get(k, 0)}
    replay_device_ms(engine, delta, ms_cache)
    rows = after['rows_total'] - before['rows_total']
    padded = sum(n * k.bucket for k, n in delta.items())
    device_ms = sum(n * ms_cache[k] for k, n in delta.items())
    check(after['graph_captures_after_warmup'] == 0,
          'graph captures after warm-up: %d'
          % after['graph_captures_after_warmup'])
    lat = sorted(d[3] for d in done)
    report = {
        'requests': len(done), 'rows': rows, 'seconds': wall,
        'requests_per_s': len(done) / wall, 'rows_per_s': rows / wall,
        'p50_ms': after['latency_ms']['p50_ms'],
        'p99_ms': after['latency_ms']['p99_ms'],
        'client_p50_ms': 1e3 * lat[len(lat) // 2],
        'client_p99_ms': 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        'batches': after['batches_total'] - before['batches_total'],
        'fill': rows / max(padded, 1), 'replays': sum(delta.values()),
        'device_ms': device_ms, 'idle': 1 - device_ms / (1e3 * wall),
        'requests_done': done}
    print('engine load (%s, %s wire, %d threads x %.0f s, tiers %s): '
          '%d requests, %.1f requests/s, %.0f rows/s, latency p50 %.2f ms '
          'p99 %.2f ms (stats(), last 512; all requests: p50 %.2f p99 '
          '%.2f), %d batches, mean fill %.3f, %d replays, device %.1f ms '
          'of %.2f s wall: idle %.1f%%, captures after warm-up 0, no '
          'wrapper launch [%s]'
          % (tag, engine.wire, LOAD_THREADS, seconds, list(mix),
             len(done), report['requests_per_s'], report['rows_per_s'],
             report['p50_ms'], report['p99_ms'], report['client_p50_ms'],
             report['client_p99_ms'], report['batches'], report['fill'],
             report['replays'], device_ms, wall, 100 * report['idle'], gpu))
    return report


def naive_loop(model, pool_lines, requests, seconds: float, gpu: str
               ) -> float:
    """The same requests through ``Code2VecModel.predict``, one at a time,
    for at most ``seconds``: rows/s."""
    rows, t0 = 0, time.perf_counter()
    for start, n, tier, _lat in requests:
        model.predict(pool_lines[start:start + n], tier=tier)
        rows += n
        if time.perf_counter() - t0 > seconds:
            break
    rate = rows / (time.perf_counter() - t0)
    print('naive predict loop: %d rows in %.2f s, %.0f rows/s [%s]'
          % (rows, time.perf_counter() - t0, rate, gpu))
    return rate


def kernel_trace(engine, lines, tier: str, names, gpu: str,
                 calls: int = 4) -> dict:
    """A torch.profiler trace of ``calls`` engine dispatches: the device
    kernels named ``names`` must have run in their graph replays."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    replays0 = engine.stats()['graph_replays']
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            engine.predict(lines, tier=tier, timeout=300)
        torch.cuda.synchronize()
    replays = engine.stats()['graph_replays'] - replays0
    counts = {name: 0 for name in names}
    for event in prof.events():
        for name in names:
            if name in event.name:
                counts[name] += 1
    check(all(n >= replays for n in counts.values()),
          'profiler: kernels %s in %d graph replays' % (counts, replays))
    print('engine trace (%s wire): %d dispatches, %d graph replays; '
          'kernels in the trace: %s [%s]'
          % (engine.wire, calls, replays, counts, gpu))
    return counts


def engine_rollover(engine, vectors_engine, model, lines, gpu: str) -> None:
    """Swap to a saved step that agrees, roll a perturbed set back, time a
    vectors-only canary out: no capture, and every result served during
    a canary equals the serving slot's."""
    captures = (engine.stats()['graph_captures'],
                vectors_engine.stats()['graph_captures'])
    baseline = engine.predict(lines, tier='topk', timeout=300)

    def feed(handle, what):
        served = 0
        while not handle.done() and served < 200:
            got = engine.predict(lines, tier='topk', timeout=300)
            check(result_diff(got, baseline, what) == 0,
                  '%s: a result served during the canary differs' % what)
            served += 1
        return handle.result(timeout=300), served

    t0 = time.perf_counter()
    handle = engine.load_params(1)
    load_s = time.perf_counter() - t0
    report, fed = feed(handle, 'canary of step 1')
    check(report['swapped'] and report['agreement'] == 1.0,
          'rollover to an agreeing step: %r' % report)
    check(engine.stats()['serving_slot'] == 1, 'serving slot after swap')
    check(result_diff(engine.predict(lines, tier='topk', timeout=300),
                      baseline, 'after swap') == 0,
          'results after the swap differ')
    params = engine.params
    perturbed = params._replace(target_embedding=-params.target_embedding)
    report2, fed2 = feed(engine.load_params(perturbed), 'perturbed canary')
    del perturbed
    check(not report2['swapped'] and report2['agreement'] < 0.9,
          'rollover of a perturbed set: %r' % report2)
    handle = vectors_engine.load_params(1, canary_batches=2)
    vectors_engine.canary_timeout_s = 0.05
    time.sleep(0.1)
    vectors_engine.predict(lines, tier='vectors', timeout=300)
    report3 = handle.result(timeout=60)
    check(not report3['swapped'] and 'timed out' in report3['reason'],
          'vectors-only canary: %r' % report3)
    after = (engine.stats()['graph_captures'],
             vectors_engine.stats()['graph_captures'])
    check(after == captures, 'captures during rollover: %s -> %s'
          % (captures, after))
    print('engine rollover: load_params(step 1) restored + copied into '
          'the idle slot in %.2f s, swapped at agreement %.3f after %d '
          'batches (%d calls fed); perturbed set rolled back at agreement '
          '%.3f (%d calls); vectors-only canary %s; results during each '
          'canary equal the serving slot\'s; 0 captures [%s]'
          % (load_s, report['agreement'], report['batches'], fed,
             report2['agreement'], fed2, report3['reason'], gpu))


def engine_overload(engine, line: str, filler: str, gpu: str) -> None:
    """``slow_dispatch`` with a bound of 8 rows and a 60 ms deadline:
    typed sheds and expiries, admitted results bit-equal to the line
    served alone (``line`` fills one tile, so its coalesced copies keep
    its arithmetic); and how far a row moves when a batchmate
    (``filler``) shifts it off a tile edge."""
    from code2vec_tpu_torch.resilience import faults
    from code2vec_tpu_torch.serving.errors import (DeadlineExceeded,
                                                   EngineOverloaded)
    unloaded = engine.predict([line], tier='topk', timeout=300)
    (shifted,) = engine.predict([filler, line], tier='topk',
                                timeout=300)[1:]
    offset_words = (shifted.topk_predicted_words
                    == unloaded[0].topk_predicted_words)
    offset_diff = float(np.abs(
        shifted.topk_predicted_words_scores.astype(np.float64)
        - unloaded[0].topk_predicted_words_scores).max())
    bound, engine.queue_bound = engine.queue_bound, 8
    try:
        faults.configure('slow_dispatch@req=0..63')
        plug = engine.submit([line], tier='topk')
        t_end = time.perf_counter() + 10
        while engine.queue_depth.snapshot() != 0 and \
                time.perf_counter() < t_end:
            time.sleep(0.001)
        doomed = [engine.submit([line], tier='topk', deadline_ms=60.0)
                  for _ in range(4)]
        admitted, shed = [], 0
        for _ in range(10):
            try:
                admitted.append(engine.submit([line], tier='topk'))
            except EngineOverloaded:
                shed += 1
        check(shed == 6 and len(admitted) == 4,
              'overload: %d shed, %d admitted' % (shed, len(admitted)))
        check(all(isinstance(f.exception(timeout=60), DeadlineExceeded)
                  for f in doomed), 'overload: deadlined requests')
        for future in admitted + [plug]:
            check(result_diff(future.result(timeout=60), unloaded,
                              'overload') == 0,
                  'a result served under overload differs')
    finally:
        faults.configure('')
        engine.queue_bound = bound
    print('engine overload: slow_dispatch, bound 8 rows: 6 shed '
          '(EngineOverloaded), 4 expired (DeadlineExceeded), 5 served bit '
          'for bit; the line behind a batchmate off the tile edge: top-k '
          'words %s, scores max |diff| %.3g [%s]'
          % ('equal' if offset_words else 'DIFFER', offset_diff, gpu))


def engine_close_drain(engine, lines, gpu: str) -> None:
    """Requests parked in the coalescing window are all served by
    ``close(drain=True)``."""
    want = [engine.predict([line], tier='topk', timeout=300)
            for line in lines]
    engine.max_delay_s = 30.0
    futures = [engine.submit([line], tier='topk') for line in lines]
    engine.close(drain=True)
    for future, expected in zip(futures, want):
        check(result_diff(future.result(timeout=60), expected,
                          'drain') == 0, 'close(drain=True) result differs')
    print('engine close(drain=True): %d parked requests served [%s]'
          % (len(lines), gpu))


def engine_phase(model, rng, gpu: str) -> dict:
    """The serving engine at java14m width on the packed wire: warm-up,
    parity, load, kernel evidence, rollover, overload, drain. Returns the
    ragged forward's wrapper launches in the engine's warm-up (an eager
    pass per key, a capture per key and slot) and the replays of the
    graphs that hold it."""
    import dataclasses
    import torch
    from code2vec_tpu_torch.model_api import ServingParamSource
    from code2vec_tpu_torch.models.functional import Code2VecParams
    from code2vec_tpu_torch.serving.engine import ServingEngine
    ckpt_dir = SMOKE_DIR / 'engine_checkpoints'
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    store = model._store_for(str(ckpt_dir / 'model'))
    names = Code2VecParams._fields
    t0 = time.perf_counter()
    for step in (0, 1):
        store.save_training(params=dict(zip(names, model.backend.params)),
                            opt_state={}, step=step, epoch=0)
    save_s = time.perf_counter() - t0
    source = ServingParamSource(model, store)
    zero_counts()
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    engine = model.serving_engine(param_source=source, params_step=0,
                                  max_delay_ms=2.0)
    stats = engine.stats()
    keys = engine.ladder.keys()
    check(engine.warm_captures == 2 * len(keys) == stats['graph_captures'],
          'warm-up captured %d graphs for %d keys x 2 slots'
          % (engine.warm_captures, len(keys)))
    # one eager pass a key, then one capture a key and slot
    launches = launch_counts()['ragged_fwd']
    check(launches == 3 * len(keys), 'the ragged forward\'s wrapper ran %d '
          'times in the warm-up of %d keys' % (launches, len(keys)))
    pool = engine.ladder.pool_bytes()
    slot_bytes = engine.ladder.slot_bytes() // 2
    print('engine warm-up (packed wire): %d keys (buckets %s, rungs %s, '
          'tiers %s) x 2 parameter slots = %d graphs captured in %.1f s; '
          'shared pool %s bytes, reserved +%d bytes, %d bytes a slot '
          '(bf16), pinned %d bytes; 2 checkpoints saved in %.1f s [%s]'
          % (len(keys), list(engine.buckets),
             {b: list(r) for b, r in engine.capacities.items()},
             list(engine.tiers), engine.warm_captures, engine.warmup_s,
             pool, torch.cuda.memory_reserved() - reserved0, slot_bytes,
             stats['ladder']['pinned_bytes'], save_s, gpu))
    sizes = tuple(v.size - 1 for v in (model.vocabs.token_vocab,
                                       model.vocabs.path_vocab,
                                       model.vocabs.target_vocab))
    cases = engine_parity(engine, model, rng, gpu)
    b8 = small_call_latency(engine, model,
                            next(c[0] for c in cases if len(c[0]) == 5
                                 and c[1] == 'topk'), gpu)
    pool_lines = make_lines(rng, 4096, sizes, model.config.MAX_CONTEXTS)
    ms_cache = {}
    topk = engine_load(engine, pool_lines, ('topk',), LOAD_SECONDS, gpu,
                       'topk', ms_cache)
    mixed = engine_load(engine, pool_lines, ENGINE_TIERS, LOAD_SECONDS, gpu,
                        'mixed tiers', ms_cache)
    naive = naive_loop(model, pool_lines, topk['requests_done'],
                       LOAD_SECONDS, gpu)
    check(topk['rows_per_s'] >= naive,
          'engine %.0f rows/s below the naive loop\'s %.0f'
          % (topk['rows_per_s'], naive))
    print('engine graph device ms (one replay): %s [%s]'
          % (', '.join('b%d/c%d/%s %.4f' % (k.bucket, k.rung, k.tier,
                                            ms_cache[k])
                       for k in sorted(ms_cache)), gpu))
    trace = kernel_trace(engine, next(c[0] for c in cases
                                      if len(c[0]) == 50), 'topk',
                         ('ragged_fwd_plan_kernel', 'ragged_fwd_tile_kernel',
                          'ragged_merge_kernel'), gpu)
    small = dataclasses.replace(model.config, SERVING_BATCH_BUCKETS='8,64')
    vectors_engine = ServingEngine(
        small, model.backend, model.backend.params, model.vocabs,
        decode_table=model._target_index_to_word, tiers=('vectors', 'topk'),
        param_source=source, max_delay_ms=0.0).warmup()
    try:
        engine_rollover(engine, vectors_engine, model, cases[0][0], gpu)
    finally:
        vectors_engine.close()
    tiles = tile_lines(rng, 5, sizes)
    engine_overload(engine, tiles[0], cases[0][0][0], gpu)
    replays = engine.stats()['graph_replays']
    engine_close_drain(engine, tiles, gpu)
    del engine, vectors_engine
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {'launches': launches, 'replays': replays,
            'rows_per_s': topk['rows_per_s'], 'naive_rows_per_s': naive,
            'trace': trace, 'b8_p50_ms': b8}


def engine_planes_phase(model, rng, gpu: str) -> dict:
    """The engine on the plane wire (encode kernel): one parameter slot,
    parity at each bucket and tier, a short load, kernel evidence."""
    import torch
    zero_counts()
    engine = model.serving_engine(max_delay_ms=2.0)
    try:
        keys = engine.ladder.keys()
        launches = launch_counts()['encode']
        check(engine.warm_captures == len(keys) and launches == 2 * len(keys),
              'plane warm-up: %d captures, %d encode launches for %d keys'
              % (engine.warm_captures, launches, len(keys)))
        print('engine warm-up (planes wire): %d graphs in %.1f s, shared '
              'pool %s bytes [%s]' % (engine.warm_captures, engine.warmup_s,
                                      engine.ladder.pool_bytes(), gpu))
        sizes = tuple(v.size - 1 for v in (model.vocabs.token_vocab,
                                           model.vocabs.path_vocab,
                                           model.vocabs.target_vocab))
        cases = engine_parity(engine, model, rng, gpu)
        pool_lines = make_lines(rng, 2048, sizes, model.config.MAX_CONTEXTS)
        load = engine_load(engine, pool_lines, ('topk',), 2.0, gpu, 'topk',
                           {})
        trace = kernel_trace(engine, next(c[0] for c in cases
                                          if len(c[0]) == 50), 'topk',
                             ('encode_bf16_kernel',), gpu)
        replays = engine.stats()['graph_replays']
    finally:
        engine.close()
    del engine
    torch.cuda.empty_cache()
    return {'launches': launches, 'replays': replays,
            'rows_per_s': load['rows_per_s'], 'trace': trace}


def reference_phase(rng) -> None:
    """A small model on the card vs the same weights on the CPU."""
    from code2vec_tpu_torch import convert
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    prefix = SMOKE_DIR / 'small'
    write_dict(Path(str(prefix) + '.dict.c2v'), 300, 200, 50)
    config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                    COMPUTE_DTYPE='float32')
    cpu = Code2VecModel(config, device='cpu', seed=3)
    weights = convert.params_to_numpy(cpu.backend.params)
    gpu = Code2VecModel(config, device='cuda',
                        params=convert.params_from_numpy(weights, 'cuda'))
    lines = make_lines(rng, 20, (299, 199, 49), config.MAX_CONTEXTS)
    want = cpu.predict(lines)
    got = gpu.predict(lines)
    for g, w in zip(got, want):
        check(g.topk_predicted_words == w.topk_predicted_words,
              'top-k words differ from the CPU reference')
        np.testing.assert_allclose(g.topk_predicted_words_scores,
                                   w.topk_predicted_words_scores,
                                   rtol=1e-4, atol=1e-5)
        check(g.attention_per_context.keys() == w.attention_per_context.keys(),
              'attention contexts differ')
        for key, value in w.attention_per_context.items():
            np.testing.assert_allclose(g.attention_per_context[key], value,
                                       rtol=1e-4, atol=1e-5)
    print('reference: %d predictions on the card match the CPU plain path '
          '(fp32, rtol 1e-4, atol 1e-5)' % len(lines))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'false)', file=sys.stderr)
        return 1
    from code2vec_tpu_torch import device as device_lib
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    from code2vec_tpu_torch.ops import _build

    started = time.perf_counter()
    gpu = device_lib.gpu_name_and_power_limit()
    print('gpu: %s; torch %s, CUDA %s' % (gpu, torch.__version__,
                                          torch.version.cuda))
    device_lib.disable_tf32()

    t0 = time.perf_counter()
    report = _build.build()
    print('build: %.1f s for %s' % (time.perf_counter() - t0,
                                    sorted(report) or 'nothing (up to date)'))
    for name, info in report.items():
        for line in info['log'].splitlines():
            if any(k in line for k in ('registers', 'spill', 'warning')):
                print('  %s: %s' % (name, line.strip()))
    if 'ragged_fwd' in report:
        # the ragged forward's kernels: no spill, no serialized wgmma
        log = report['ragged_fwd']['log']
        check('C7514' not in log and all(
            line.strip().startswith('0 bytes stack frame')
            for line in log.splitlines() if 'bytes stack frame' in line),
            'ptxas reports a spill or a serialized wgmma in ragged_fwd.cu')

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    base = Config()
    prefix = SMOKE_DIR / 'java14m'
    write_dict(Path(str(prefix) + '.dict.c2v'), base.MAX_TOKEN_VOCAB_SIZE,
               base.MAX_PATH_VOCAB_SIZE, base.MAX_TARGET_VOCAB_SIZE)
    test_path = Path(str(prefix) + '.test.c2v')
    serving = dict(TRAIN_DATA_PATH_PREFIX=str(prefix),
                   TEST_DATA_PATH=str(test_path))
    model = Code2VecModel(Config(**serving), device='cuda', seed=0)
    table_bytes = sum(t.numel() * 4 for t in model.backend.params)
    print('model: java14m width, vocab %d/%d/%d, %.2f GB fp32 tables, '
          'bf16 compute, built in %.1f s'
          % (model.vocabs.token_vocab.size, model.vocabs.path_vocab.size,
             model.vocabs.target_vocab.size, table_bytes / 1e9,
             time.perf_counter() - t0))
    # the words in vocabulary (one index is the joined PAD/OOV word)
    vocab_sizes = (model.vocabs.token_vocab.size - 1,
                   model.vocabs.path_vocab.size - 1,
                   model.vocabs.target_vocab.size - 1)
    # the plane-wire and evaluation phases draw from their own generator,
    # so the other phases see the same data as before those phases existed
    rng_eval = np.random.default_rng(1)
    test_path.write_text('\n'.join(make_lines(
        rng_eval, EVAL_LINES, vocab_sizes, base.MAX_CONTEXTS)) + '\n')

    # the packed wire through the ragged kernel (the defaults)
    record = kernel_phase(model, rng, gpu)
    serving_launches = serving_phase(model, rng, gpu)
    breakdown_phase(model, rng, gpu)
    topk_phase(model, np.random.default_rng(2), gpu)
    reference_phase(rng)
    eval_ragged = evaluate_phase(model, gpu, 'ragged_fwd')
    eval_native = host_pipeline_phase(model, test_path, gpu)
    # the serving engine over the ladder of CUDA graphs, same weights
    engine_report = engine_phase(model, np.random.default_rng(7), gpu)

    # the plane wire through the encode kernel, same weights
    planes = Code2VecModel(
        Config(BATCH_WIRE_FORMAT='planes', USE_PALLAS_FUSED_ENCODE=True,
               **serving), device='cuda', params=model.backend.params)
    encode_record = encode_kernel_phase(planes, rng_eval, gpu)
    planes_launches = serving_phase(planes, rng_eval, gpu,
                                    kernel='encode')
    breakdown_phase(planes, rng_eval, gpu)
    eval_encode = evaluate_phase(planes, gpu, 'encode')
    planes_engine = engine_planes_phase(planes, np.random.default_rng(8), gpu)
    del planes
    torch.cuda.empty_cache()
    # the packed wire unpacked on the card, then the encode kernel
    unpack = Code2VecModel(
        Config(USE_PALLAS_RAGGED_FUSION=False, USE_PALLAS_FUSED_ENCODE=True,
               **serving), device='cuda', params=model.backend.params)
    unpack_launches = serving_phase(unpack, rng_eval, gpu, kernel='encode',
                                    buckets=BUCKETS[1:])
    del unpack
    torch.cuda.empty_cache()
    evaluate_reference_phase(rng_eval)
    vocabs = model.vocabs
    del model
    torch.cuda.empty_cache()

    from code2vec_tpu_torch.models.backends import TorchBackend
    train_config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                          USE_PALLAS_FUSED_CE=True)
    backend = TorchBackend(train_config, vocabs, torch.device('cuda'), seed=1)
    check(backend.sizes['target_vocab_size'] == 262144,
          'fused-CE target rows %d' % backend.sizes['target_vocab_size'])
    train_records, train_fwd = train_kernel_phase(backend, rng, gpu)
    record.update(train_fwd)
    # the optimizer's kernels, on data of their own generators
    adam_record = adam_kernel_phase(backend, gpu)
    rows_record = adam_rows_phase(backend, np.random.default_rng(6), gpu)
    records = [record, encode_record] + train_records + [adam_record,
                                                         rows_record]
    train_launches = train_phase(backend, rng, gpu)
    del backend
    torch.cuda.empty_cache()
    unfused = TorchBackend(Config(TRAIN_DATA_PATH_PREFIX=str(prefix)), vocabs,
                           torch.device('cuda'), seed=2)
    unfused_phase(unfused, rng, gpu)
    del unfused
    torch.cuda.empty_cache()
    knob_launches = knob_phases(vocabs, prefix, gpu)
    del vocabs
    torch.cuda.empty_cache()
    entry_launches = train_entry_phase(prefix, vocab_sizes, rng, gpu)
    pipeline_launches = train_pipeline_phase(
        vocab_sizes, np.random.default_rng(4), gpu)
    train_reference_phase(rng)
    dense_launches = dense_route_phase(gpu)
    checkpoint_launches = checkpoint_phase(prefix, test_path, gpu)
    cli_launches = cli_phase(np.random.default_rng(3), gpu)
    drill_launches = resilience_phase(np.random.default_rng(9), gpu)
    source_launches = source_to_repl_phase(np.random.default_rng(5), gpu)

    # launches on the main paths, each counted from zero: serving
    # (predict) and evaluate on each route, and training (train_step,
    # then Code2VecModel.train())
    by_path = {'ragged_fwd': {'serving': serving_launches,
                              'eval': eval_ragged},
               'encode': {'serving_planes': planes_launches,
                          'serving_unpack': unpack_launches,
                          'eval_planes': eval_encode}}
    for counts in (train_launches, entry_launches):
        for name, n in counts.items():
            paths = by_path.setdefault(name, {})
            paths['train'] = paths.get('train', 0) + n
    # the checkpoint paths (train with saves, the reload's evaluate and
    # predict, the resumed train) and the CLI, each counted from zero
    # and the host data path's: evaluate() with the native reader, train()
    # from the token cache and from the native reader, the path from
    # source (train and evaluate through the CLI) and one shell turn
    by_path['ragged_fwd']['eval_native'] = eval_native
    # and the optimizer knobs' (train_lazy, train_grads_bf16, ...)
    for path, counts in dict(checkpoint_launches, cli=cli_launches,
                             **pipeline_launches, **dense_launches,
                             **drill_launches, **source_launches,
                             **knob_launches).items():
        for name in STEP_KERNELS + ('adam_rows',):
            if counts.get(name):
                by_path.setdefault(name, {})[path] = counts[name]
    # the engine paths: wrapper launches of their warm-up runs and
    # captures; their graph replays, which the counters cannot see
    by_path['ragged_fwd']['engine'] = engine_report['launches']
    by_path['encode']['engine_planes'] = planes_engine['launches']
    replays = {'ragged_fwd': {'engine': engine_report['replays']},
               'encode': {'engine_planes': planes_engine['replays']}}
    for rec in records:
        rec['launches'] = sum(by_path[rec['name']].values())
        rec['launches_by_path'] = by_path[rec['name']]
        rec['graph_replays_by_path'] = replays.get(rec['name'], {})
    print('smoke: every phase passed in %.1f s' % (time.perf_counter()
                                                   - started))
    print(json.dumps({'kernels': records}))
    print(gpu)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
