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
   and times both with CUDA events;
4. serving — ``Code2VecModel(device='cuda')`` at the java14m width (vocab
   1,301,136 / 911,417 / 261,245 synthetic words, weights from a seed, bf16
   compute) answers ``predict`` at batch buckets 8, 64 and 1024 on the
   topk, attention and vectors tiers. Launch counts are zeroed just before
   and read just after; every call must go through the ragged kernel, and
   no operation of the path may run on the CPU;
5. reference — a small model on the card against the same weights on the
   CPU (plain versions): same top-k words, close scores and attention.

Prints a JSON line with each kernel's numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import pickle
import statistics
import sys
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


def write_dict(path: Path, n_tokens: int, n_paths: int,
               n_targets: int) -> None:
    """A ``.dict.c2v`` of synthetic words t<i>, p<i>, n<i>, counts
    descending so the vocab order is the index order."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, 'wb') as f:
        for prefix, n in (('t', n_tokens), ('p', n_paths),
                          ('n', n_targets)):
            pickle.dump({'%s%d' % (prefix, i): n - i for i in range(n)}, f)
        pickle.dump(0, f)


def context_counts(rng, batch: int, max_contexts: int) -> np.ndarray:
    """java14m-like fill: median ~28, a tail up to max_contexts."""
    counts = np.exp(rng.normal(math.log(28.0), 0.8, batch))
    counts = np.clip(np.rint(counts), 1, max_contexts).astype(np.int64)
    counts[rng.choice(batch, 4, replace=False)] = max_contexts
    return counts


def make_lines(rng, n: int, vocab_sizes, max_contexts: int) -> list:
    n_tok, n_path, n_tgt = vocab_sizes
    lines = []
    for count in context_counts(rng, n, max_contexts):
        src = rng.integers(0, n_tok, count)
        pth = rng.integers(0, n_path, count)
        tgt = rng.integers(0, n_tok, count)
        ctxs = ' '.join('t%d,p%d,t%d' % triple
                        for triple in zip(src, pth, tgt))
        lines.append('n%d %s' % (rng.integers(0, n_tgt), ctxs))
    return lines


def kernel_batch(rng, batch: int, max_contexts: int, token_rows: int,
                 path_rows: int, token_pad: int, path_pad: int):
    """One packed batch at the serving shape: random indices, a few empty
    rows, ~3% interior all-PAD holes."""
    from code2vec_tpu_torch.data import packed as packed_lib
    from code2vec_tpu_torch.data.reader import Batch, context_valid_mask
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
    plane = Batch(source=source, path=path, target=target, mask=mask,
                  label=np.zeros(batch, np.int32),
                  weight=np.ones(batch, np.float32))
    return packed_lib.pack_batch(plane, token_pad, path_pad)


def max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


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
    record = None
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
            record = {
                'name': 'ragged_fwd', 'route': 'cuda',
                'source': 'code2vec_tpu_torch/ops/csrc/ragged_fwd.cu',
                'replaces': 'code2vec_tpu/ops/pallas_ragged.py:150',
                'launches': 0, 'max_abs_err': err, 'ms': ms,
                'plain_ms': plain_ms, 'bound_ms': max(t_bytes, t_ops),
                'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
                'library_ms': None}
    return record


class CpuOpWatch:
    """Records every tensor operation that computes on the CPU: all its
    tensor outputs on the CPU, a CPU tensor among its inputs or no inputs
    at all, and an output that is not a view of an input (wrapping a
    host array, as ``torch.from_numpy`` does, computes nothing). Copies to
    and from the card pass."""

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
                              for t in outs):
                    watch.cpu_ops.append(str(func))
                return out

        self.mode = _Mode()


def serving_phase(model, rng, gpu: str) -> int:
    """The main path: predict at buckets 8/64/1024 on three tiers. Returns
    the ragged kernel's launches in this run."""
    import torch
    from code2vec_tpu_torch.ops import ragged
    config = model.config
    sizes = (model.vocabs.token_vocab.size - 1,
             model.vocabs.path_vocab.size - 1,
             model.vocabs.target_vocab.size - 1)
    k = config.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION
    ragged.launches = 0
    calls = 0
    for bucket, n_lines in BUCKETS:
        lines = make_lines(rng, n_lines, sizes, config.MAX_CONTEXTS)
        for tier in TIERS:
            for rep in range(2):
                before = ragged.launches
                t0 = time.perf_counter()
                results = model.predict(lines, tier=tier)
                latency = (time.perf_counter() - t0) * 1e3
                calls += 1
                check(ragged.launches == before + 1,
                      'predict(%s, %d) did not launch the ragged kernel once'
                      % (tier, bucket))
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
                    print('serving predict tier=%s bucket=%d lines=%d: '
                          '%.3f ms [%s]' % (tier, bucket, n_lines, latency,
                                            gpu))
        if bucket == 64:
            watch = CpuOpWatch()
            with torch.no_grad(), watch.mode:
                for tier in TIERS:
                    model.predict(lines, tier=tier)
                    calls += 1
            check(not watch.cpu_ops,
                  'CPU operations on the serving path: %s'
                  % sorted(set(watch.cpu_ops)))
    launches = ragged.launches
    check(launches == calls, 'ragged kernel launched %d times in %d predict '
          'calls' % (launches, calls))
    print('serving: %d predict calls, %d ragged kernel launches '
          '(1 per predict, bucket 1024 included) [%s]'
          % (calls, launches, gpu))
    return launches


def breakdown_phase(model, rng, gpu: str) -> None:
    """Where a bucket-1024 predict call spends its time: host tokenize,
    host pack, device predict step per tier (graph replay), host decode."""
    import torch
    from code2vec_tpu_torch.data import packed as packed_lib
    from code2vec_tpu_torch.serving import engine as engine_lib
    from code2vec_tpu_torch.serving.steps import predict_step
    sizes = (model.vocabs.token_vocab.size - 1,
             model.vocabs.path_vocab.size - 1,
             model.vocabs.target_vocab.size - 1)
    lines = make_lines(rng, 1000, sizes, model.config.MAX_CONTEXTS)
    t0 = time.perf_counter()
    batch = model.reader.pad_batch_to(model.reader.process_input_rows(lines),
                                      1024)
    t1 = time.perf_counter()
    packed = packed_lib.pack_batch(batch, model.backend.token_pad_index,
                                   model.backend.path_pad_index)
    t2 = time.perf_counter()
    ctx = torch.from_numpy(packed.ctx).cuda()
    count = torch.from_numpy(packed.count).cuda()
    device_ms = {tier: cuda_ms(lambda tier=tier: predict_step(
        model.backend, ctx, count, tier=tier)) for tier in TIERS}
    out = predict_step(model.backend, ctx, count, tier='attention')
    fetched = {key: value.cpu().numpy() for key, value in out.items()}
    t3 = time.perf_counter()
    engine_lib.decode_results(fetched, batch, len(lines),
                              model._target_index_to_word)
    t4 = time.perf_counter()
    print('breakdown bucket=1024 lines=1000 slots=%d: host tokenize+pad '
          '%.1f ms, host pack %.1f ms, device predict step %s, host decode '
          '(attention) %.1f ms [%s]'
          % (int(packed.count.sum()), (t1 - t0) * 1e3, (t2 - t1) * 1e3,
             ', '.join('%s %.4f ms' % kv for kv in device_ms.items()),
             (t4 - t3) * 1e3, gpu))


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
            if 'registers' in line or 'spill' in line:
                print('  %s: %s' % (name, line.strip()))

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    base = Config()
    prefix = SMOKE_DIR / 'java14m'
    write_dict(Path(str(prefix) + '.dict.c2v'), base.MAX_TOKEN_VOCAB_SIZE,
               base.MAX_PATH_VOCAB_SIZE, base.MAX_TARGET_VOCAB_SIZE)
    model = Code2VecModel(Config(TRAIN_DATA_PATH_PREFIX=str(prefix)),
                          device='cuda', seed=0)
    table_bytes = sum(t.numel() * 4 for t in model.backend.params)
    print('model: java14m width, vocab %d/%d/%d, %.2f GB fp32 tables, '
          'bf16 compute, built in %.1f s'
          % (model.vocabs.token_vocab.size, model.vocabs.path_vocab.size,
             model.vocabs.target_vocab.size, table_bytes / 1e9,
             time.perf_counter() - t0))

    record = kernel_phase(model, rng, gpu)
    record['launches'] = serving_phase(model, rng, gpu)
    breakdown_phase(model, rng, gpu)
    reference_phase(rng)

    print(json.dumps({'kernels': [record]}))
    print(gpu)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
