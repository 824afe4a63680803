#!/usr/bin/env python3
"""Checks of chip_smoke.py's own checks, run by hand on one CUDA card:

    python3 scripts/torch_kernel_checks.py mutations [FAULT ...]
    python3 scripts/torch_kernel_checks.py train-ref-draws [N]
    python3 scripts/torch_kernel_checks.py profile
    python3 scripts/torch_kernel_checks.py ablate [ragged_fwd|ragged_bwd|ce_fwd|ce_bwd ...]
    python3 scripts/torch_kernel_checks.py compare PARENT_CHECKOUT
    python3 scripts/torch_kernel_checks.py engine-compare PARENT_CHECKOUT
    python3 scripts/torch_kernel_checks.py gather-ablate
    python3 scripts/torch_kernel_checks.py scan-ablate
    python3 scripts/torch_kernel_checks.py rounding-noise
    python3 scripts/torch_kernel_checks.py trace

``mutations`` applies one fault at a time (each of FAULTS, or the named
ones) to a copy of the kernel sources
(under build/mutations/ in this checkout), builds the copy and runs the
chip_smoke phase that must catch it, each in a process of its own (a
fault on the card ends its process's CUDA context); it prints one line
per fault, ``caught`` or ``NOT CAUGHT``, and exits non-zero if any fault
went through. The faults: the CE backward without its softmax term, with
every dlogit x1.01, with the wgmma descriptor's two strides swapped and
with the fixed tile's K slices swapped; the encode kernel with W's K
slices swapped, with its descriptor strides swapped and with another
swizzle mode in the descriptor; the ragged backward without the ds a term
of du, with the x product's descriptor strides swapped and with the last
slot of every 64-slot tile given the next example; the CE forward without
the online rescale of s and with the label's column taken from the next
block; the ragged forward with the last slot of every 64-slot tile given
the next pair (example) and with its merge taking no rescale; and every
gradient of a train step x1.01 before Adam, held by the bf16 train
reference; the fused Adam kernel with b1c and b2c swapped, without eps,
with mu truncated instead of rounded before its store, and with the tail
past the last 8-element chunk skipped (chip_smoke's adam phase); the row
kernel updating a duplicated row once per listing (its rows phase); and
``packed_rows`` without the PAD rows (the lazy knob phase).

``train-ref-draws`` prints chip_smoke's bf16 train-reference readings for
N draws of batches (generators seeded 101 ...), then for three draws with
every gradient on the card x1.01: the data the bf16 limits are set from.

``profile`` times the CUDA kernels of the bf16 ragged forward (serving
and training shapes), ragged backward, CE forward, CE backward and encode
at the main paths' shapes with torch.profiler, by kernel name, and the
forward's pair map built by its plan kernel against its torch-op plain
version.

``ablate`` times the bf16 ragged forward (serving shape), ragged backward,
CE forward and CE backward with one part of their work taken out at a
time (results wrong, times only), each built from a copy of the sources
under build/ablations/: where their time goes.

``compare DIR`` times the bf16 ragged forward (serving shape: bf16
tables; training shape: fp32 masters and the keep mask), ragged backward
and CE forward (the same inputs from the same seeds) with the kernels of
the checkout at DIR (an unpacked archive of another commit, whose
package has the same wrapper functions) and of this one, in the order
DIR, this, this, DIR, each in a process of its own on the same card.

``engine-compare DIR`` drives the serving engine of the checkout at DIR
and of this one, in the order DIR, this, this, DIR, this, DIR, DIR, this,
each in a process of its own: java14m width and vocabulary, random weights, a topk-only
ladder, two chip_smoke ``engine_load`` runs of 8 threads x 5 s over the
same 4,096 lines (rows/s, p50/p99, idle share).

``scan-ablate`` runs ``engine-compare``'s load on this checkout with the
engine's long-context scan (C7) as shipped and with it taken out (every
request to the native tokenizer), in the same order, with first: what
the scan costs the native route.

``gather-ablate`` times the plane-wire train step (java14m, bf16, keep
0.75, fused CE, one repeated batch, chip_smoke's ``repeated_step_ms``)
with the dense encode as shipped, source and target rows in one token
gather, against the same encode with a gather each (two token-table
gradients summed), in the order one, two, two, one, one, two.

``rounding-noise`` holds the bf16 ragged backward's kernel and its plain
version each against a float64 reference that rounds du to bf16 from its
float64 value, on chip_smoke's edge streams at K, D in {128, 256, 384},
for two draws of the weights: how far apart two correct roundings of du
can read under chip_smoke's per-part limits; and the kernel's de and dW
against chip_smoke.own_du_reference (float64 from the kernel's own du),
the readings chip_smoke.OWN_DU_LIMIT is set from.

``trace`` builds a copy of the bf16 ragged forward with clock64 marks in
its tile kernel (under build/trace/) and prints, per tile (the median over
the CTAs' first four live tiles), how long the producer's gather (bf16
tables) and the consumers' phases take: waiting for e, the x product
(with its waits for W), tanh and the score, the scans, the stores; at the
serving shape (bf16 tables, rows gathered in the kernel) and at the
training shape (fp32 masters and the keep mask, e from the gather kernel).
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# name: (source file, text, replacement, chip_smoke phase that must fail)
FAULTS = {
    'ce_no_softmax': (
        'ce.cu', 'v[e] = q_dlse[k] * p + q_dp[k] * onehot;',
        'v[e] = q_dp[k] * onehot;', 'train'),
    'ce_dl_x1.01': (
        'ce.cu', 'v[e] = q_dlse[k] * p + q_dp[k] * onehot;',
        'v[e] = 1.01f * (q_dlse[k] * p + q_dp[k] * onehot);', 'train'),
    'ce_strides_swapped': (
        'ce.cu', '            kBoxBytes, 1024);',
        '            1024, kBoxBytes);', 'train'),
    'ce_k_slices_swapped': (
        'ce.cu', 'const unsigned char*>(sm.fixed[b]) + k_bytes,',
        'const unsigned char*>(sm.fixed[b ^ 1]) + k_bytes,', 'train'),
    'encode_k_slices_swapped': (
        'encode.cu', 'sm.w[0] + q * kBox', 'sm.w[0] + (q ^ 1) * kBox',
        'encode'),
    'encode_strides_swapped': (
        'encode.cu', '              kWStride, 1024);',
        '              1024, kWStride);', 'encode'),
    'encode_other_swizzle': (
        'hopper.cuh', 'd |= static_cast<uint64_t>(1) << 62;',
        'd |= static_cast<uint64_t>(2) << 62;', 'encode'),
    'ragged_no_ds_attn': (
        'ragged_bwd.cu',
        '(1.f - x0 * x0) * fmaf(ds[h], a0, wt[h] * gv.x),\n'
        '              (1.f - x1 * x1) * fmaf(ds[h], a1, wt[h] * gv.y));',
        '(1.f - x0 * x0) * (wt[h] * gv.x),\n'
        '              (1.f - x1 * x1) * (wt[h] * gv.y));', 'train'),
    'ragged_strides_swapped': (
        'ragged_bwd.cu',
        '              reinterpret_cast<const unsigned char*>(sm.w[st][xc0 / 64])\n'
        '                  + kk * 2048,\n'
        '              kBoxBytes, 1024);',
        '              reinterpret_cast<const unsigned char*>(sm.w[st][xc0 / 64])\n'
        '                  + kk * 2048,\n'
        '              1024, kBoxBytes);', 'train'),
    'ragged_next_example_at_tile_edge': (
        'ragged_bwd.cu', 'ex[h] = in ? seg[slot] : 0;',
        'ex[h] = in ? (row0 + 8 * h == kTileSlots - 1\n'
        '                     ? min(seg[slot] + 1, seg[n_slots - 1])\n'
        '                     : seg[slot]) : 0;', 'train'),
    'ce_fwd_no_rescale': (
        'ce.cu',
        's_run[h] = s_run[h] * exp2_approx((m_run[h] - m_new) * kLog2e) + bs;',
        's_run[h] = s_run[h] + bs;', 'train'),
    'ce_fwd_label_wrong_block': (
        'ce.cu', 'const int jj = lab[h] - v0;',
        'const int jj = lab[h] - v0 + kFwdBlock;', 'train'),
    'ragged_fwd_next_pair_at_tile_edge': (
        'ragged_fwd.cu', 'sm.pid[buf][t] = p;',
        'sm.pid[buf][t] = p + (t == kTile - 1 && p >= 0);', 'train'),
    'ragged_fwd_merge_no_rescale': (
        'ragged_fwd.cu', '  return expf(m_i - m);', '  return 1.f;',
        'train'),
    'train_grads_x1.01': (None, None, None, 'train_ref'),
    'adam_bias_corrections_swapped': (
        'adam.cu', 'const float u = __fdiv_rn(__fdiv_rn(m, s.b1c),\n'
        '                            __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.b2c)),',
        'const float u = __fdiv_rn(__fdiv_rn(m, s.b2c),\n'
        '                            __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.b1c)),',
        'adam'),
    'adam_no_eps': (
        'adam.cu', '__fsqrt_rn(__fdiv_rn(v, s.b2c)), s.eps));',
        '__fsqrt_rn(__fdiv_rn(v, s.b2c)), 0.f));', 'adam'),
    'adam_mu_truncated': (
        'adam.cu', '    store8(mu + i, m);',
        '    for (int k = 0; k < 8; ++k) {\n'
        '      m[k] = __uint_as_float(__float_as_uint(m[k]) & 0xffff0000u);\n'
        '    }\n'
        '    store8(mu + i, m);', 'adam'),
    'adam_tail_skipped': (
        'adam.cu', 'const long long n_scalar = head + (n - tail0);',
        'const long long n_scalar = head;', 'adam'),
    'adam_rows_duplicates_twice': (
        'adam.cu', 'if (entry > 0 && rows[entry - 1] == r) return;', '',
        'adam_rows'),
    'lazy_no_pad_row': (None, None, None, 'lazy'),
}


# kernel: {name: (source file, text, replacement)}; each kernel with one
# part of its work taken out
ABLATIONS = {
    'ragged_fwd': {
        'as is': None,
        'no fused gather (bf16 tables: e not written)': (
            'ragged_fwd.cu', 'gather_tile<D>(sm, sm.e[es], tok,',
            'if (n_tiles < 0) gather_tile<D>(sm, sm.e[es], tok,'),
        'no gather kernel (fp32 masters: e not written)': (
            'ragged_fwd.cu',
            'ragged_fwd_gather_kernel<TT><<<n_tiles, kGatherCta, 0, s>>>(',
            'if (n_tiles < 0) ragged_fwd_gather_kernel<TT>'
            '<<<n_tiles, kGatherCta, 0, s>>>('),
        'no x product': (
            'ragged_fwd.cu',
            'hop::wgmma<kN, 1>(acc, da, db, q > 0 || kk > 0);', ''),
        'no tanh': (
            'ragged_fwd.cu', 'const float x0 = tanhf(acc[4 * j + 2 * h]);\n'
            '          const float x1 = tanhf(acc[4 * j + 2 * h + 1]);',
            'const float x0 = acc[4 * j + 2 * h];\n'
            '          const float x1 = acc[4 * j + 2 * h + 1];'),
        'no pair sums of acc (shuffles)': (
            'ragged_fwd.cu',
            'const float o0 = __shfl_up_sync(kFull, v0, 4 << i);\n'
            '            const float o1 = __shfl_up_sync(kFull, v1, 4 << i);',
            'const float o0 = v0, o1 = v1;'),
        'no merge': (
            'ragged_fwd.cu', '  if (batch == 0) return 0;\n'
            '  ragged_merge_kernel<<<batch, 128, 0, s>>>(pair_start',
            '  if (batch >= 0) return 0;\n'
            '  ragged_merge_kernel<<<batch, 128, 0, s>>>(pair_start'),
    },
    'ce_bwd': {
        'as is': None,
        'no exponent in dl': (
            'ce.cu', 'valid ? exp2_approx(fmaf(', 'valid ? (fmaf('),
        'no logits product': (
            'ce.cu', 'hop::wgmma<32, 0>(lg, da, db);', ''),
        'no dW/dcode product': (
            'ce.cu', 'hop::wgmma<kHalf, 1>(acc, da, db);', ''),
        'no named barrier': (
            'ce.cu', 'hop::named_sync(1, 256);       // both halves', '//'),
        'no row parameters': (
            'ce.cu', 'if (DW) load_block_params(unit.b0 + k + 1);', ''),
    },
    'ragged_bwd': {
        'as is': None,
        'no gather (e not written)': (
            'ragged_bwd.cu', 'c2v::gather_rows<TT, bf16>(',
            'if (n_slots < 0) c2v::gather_rows<TT, bf16>('),
        'no x product': (
            'ragged_bwd.cu', 'hop::wgmma<kXN, 1>(acc, da, db);', ''),
        'no tanh': (
            'ragged_bwd.cu', 'const float x0 = tanhf(acc[4 * j + 2 * h]);\n'
            '          const float x1 = tanhf(acc[4 * j + 2 * h + 1]);',
            'const float x0 = acc[4 * j + 2 * h];\n'
            '          const float x1 = acc[4 * j + 2 * h + 1];'),
        'no de product': (
            'ragged_bwd.cu', 'hop::wgmma<kDeN, 0>(acc2, da, db);', ''),
        'no de stores': (
            'ragged_bwd.cu', '          if (slot < n_slots) {\n'
            '            float v0 = acc2',
            '          if (slot < 0) {\n            float v0 = acc2'),
        'no dW product': (
            'ragged_bwd.cu',
            'hop::wgmma<kN, 1, 1>(acc, da, db, g > 0 || kk > 0);', ''),
    },
    'ce_fwd': {
        'as is': None,
        'no logits product': (
            'ce.cu',
            'hop::wgmma<kFwdBlock, 0>(acc, da, db, q > 0 || kk > 0);', ''),
        'no exponent': (
            'ce.cu',
            'bs += exp2_approx(fmaf(acc[4 * j + 2 * h], kLog2e, -m2))\n'
            '                + exp2_approx(fmaf(acc[4 * j + 2 * h + 1], '
            'kLog2e, -m2));',
            'bs += acc[4 * j + 2 * h] + acc[4 * j + 2 * h + 1];'),
        'no statistics': (
            'ce.cu', '      const int v0 = blk * kFwdBlock;\n',
            '      const int v0 = blk * kFwdBlock;\n'
            '      if (v0 >= 0) continue;\n'),
    },
}


def copy_sources(root: Path, source: str, text: str,
                 replacement: str) -> None:
    """The kernel sources copied under ``root`` with one edit, made the
    ones _build compiles."""
    from code2vec_tpu_torch.ops import _build
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build._CSRC, root / 'csrc')
    path = root / 'csrc' / source
    original = path.read_text()
    if text not in original:
        raise SystemExit('%r not in %s' % (text, source))
    path.write_text(original.replace(text, replacement))
    _build._CSRC = root / 'csrc'
    _build.BUILD_DIR = root / 'lib'


def training_inputs(seed: int = 0) -> dict:
    """bf16 inputs of the ragged backward and the CE forward and backward
    at the java14m training shape, drawn on the card from ``seed``:
    tables of the java14m vocabulary sizes drawn as the model initialises
    them (fp32 masters), a packed batch of 1,024 examples (chip_smoke's
    counts), the keep mask at 0.75, the forward's statistics and random
    cotangents; the target table of 262,144 rows."""
    import math
    import torch
    from code2vec_tpu_torch.ops import ragged
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)

    def uniform(shape, limit):
        return (torch.rand(*shape, device='cuda', generator=gen) * 2 - 1
                ) * limit
    tok = uniform((1301136, 128), math.sqrt(3 / 128))
    path = uniform((911417, 128), math.sqrt(3 / 128))
    w = uniform((384, 384), math.sqrt(6 / 768)).bfloat16()
    attn = uniform((384,), math.sqrt(6 / 385)).bfloat16()
    packed = cs.kernel_batch(np.random.default_rng(seed), 1024, 200,
                             tok.shape[0], path.shape[0], 0, 0)
    segs = ragged._segment_inputs(torch.from_numpy(packed.ctx).cuda(),
                                  torch.from_numpy(packed.count).cuda(), 0, 0)
    keep = ragged._draw_keep(11, segs, 384, 0.75)
    _s, m, z, acc = ragged._stats_plain(tok, path, w, attn, segs, 0, 0, keep,
                                        0.75)
    code = acc / torch.where(z > 0, z, 1.0)[..., None]
    g2 = torch.randn(code.shape, device='cuda', generator=gen)
    gc = (g2 * code).sum(dim=-1)
    n_valid = 261245
    table = uniform((262144, 384), math.sqrt(3 / 384)).bfloat16()
    code_c = code.reshape(1024, 384).bfloat16()
    label = torch.randint(0, n_valid, (1024,), device='cuda', generator=gen,
                          dtype=torch.int32)
    return {'ragged': (tok, path, w, attn, segs, m, z, gc, g2, keep, 0.75),
            'serving': (tok.bfloat16(), path.bfloat16(), w, attn, segs),
            'retained': int(packed.count.sum()),
            'ce': (code_c, table, label, n_valid)}


def kernel_calls(inputs: dict) -> dict:
    """The bf16 kernels' wrappers on ``inputs``: the ragged forward at the
    serving shape (bf16 tables) and at the training shape (fp32 masters,
    the keep mask), and the three training kernels."""
    import torch
    from code2vec_tpu_torch.ops import ce, ragged
    code, table, label, n_valid = inputs['ce']
    lse = ce._lse_pick_plain(code, table, label, n_valid)[0]
    dlse = torch.full((code.shape[0],), 1.0 / code.shape[0], device='cuda')
    tok, path, w, attn, segs, *_rest, keep, rate = inputs['ragged']
    return {
        'ragged_fwd': lambda: ragged._stats_kernel(*inputs['serving'], 0, 0),
        'ragged_fwd_train': lambda: ragged._stats_kernel(
            tok, path, w, attn, segs, 0, 0, keep, rate),
        'ragged_bwd': lambda: ragged._grads_kernel(
            *inputs['ragged'], token_pad=0, path_pad=0),
        'ce_fwd': lambda: ce._lse_pick_kernel(code, table, label, n_valid),
        'ce_bwd': lambda: ce._ce_grads_kernel(code, table, label, lse, dlse,
                                              -dlse, n_valid)}


def run_ablation(kernel: str, name: str) -> None:
    from code2vec_tpu_torch import device as device_lib
    from code2vec_tpu_torch.ops import _build
    device_lib.disable_tf32()
    gpu = device_lib.gpu_name_and_power_limit()
    edit = ABLATIONS[kernel][name]
    if edit is not None:
        copy_sources(ROOT / 'build' / 'ablations' / kernel
                     / name.replace(' ', '_').replace('/', '_'), *edit)
    _build.build([kernel if kernel.startswith('ragged') else 'ce'])
    calls = kernel_calls(training_inputs())
    ms = cs.cuda_ms(calls[kernel])
    if kernel == 'ragged_fwd':
        print('ablate %s bf16, %s: serving shape %.4f ms, training shape '
              '%.4f ms [%s]' % (kernel, name, ms,
                                cs.cuda_ms(calls['ragged_fwd_train']), gpu))
        return
    print('ablate %s bf16, %s: %.4f ms [%s]' % (kernel, name, ms, gpu))


def ablate(kernels=None) -> int:
    for kernel, cases in ABLATIONS.items():
        if kernels and kernel not in kernels:
            continue
        for name in cases:
            proc = subprocess.run([sys.executable, __file__, 'ablation',
                                   kernel, name], capture_output=True,
                                  text=True, timeout=600)
            lines = (proc.stdout.strip() or proc.stderr.strip()).splitlines()
            print(lines[-1] if lines else '%s %s: exit %d'
                  % (kernel, name, proc.returncode))
            sys.stdout.flush()
    return 0


COMPARED = ('ragged_fwd', 'ragged_fwd_train', 'ragged_bwd', 'ce_fwd')


def time_at(root: str) -> None:
    """Times the bf16 kernels of COMPARED with the package of the
    checkout at ``root`` (imported from there, built there)."""
    sys.path.insert(0, str(Path(root).resolve()))
    import code2vec_tpu_torch
    from code2vec_tpu_torch import device as device_lib
    device_lib.disable_tf32()
    gpu = device_lib.gpu_name_and_power_limit()
    calls = kernel_calls(training_inputs())
    times = {name: cs.cuda_ms(calls[name]) for name in COMPARED}
    print('compare %s: %s (bf16, ms) [%s]'
          % (Path(code2vec_tpu_torch.__file__).resolve().parents[1],
             ', '.join('%s %.4f' % kv for kv in times.items()), gpu))


def compare(parent: str) -> int:
    for root in (parent, str(ROOT), str(ROOT), parent):
        proc = subprocess.run([sys.executable, __file__, 'time-at', root],
                              capture_output=True, text=True, timeout=900)
        lines = (proc.stdout.strip() or proc.stderr.strip()).splitlines()
        print(lines[-1] if lines else '%s: exit %d' % (root,
                                                       proc.returncode))
        sys.stdout.flush()
        if proc.returncode != 0:
            return 1
    return 0


def engine_at(root: str, scan: bool = True) -> None:
    """chip_smoke's topk load, twice, on an engine of the package of the
    checkout at ``root`` (imported from there, built there); ``scan``
    False takes the engine's long-context scan out."""
    sys.path.insert(0, str(Path(root).resolve()))
    import code2vec_tpu_torch
    from code2vec_tpu_torch import device as device_lib
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    from code2vec_tpu_torch.ops import _build
    if not scan:
        from code2vec_tpu_torch.serving import engine as engine_lib
        engine_lib._long_context = lambda lines: False
    device_lib.disable_tf32()
    gpu = device_lib.gpu_name_and_power_limit()
    _build.build()
    prefix = java14m_prefix()
    model = Code2VecModel(Config(TRAIN_DATA_PATH_PREFIX=str(prefix)),
                          device='cuda', seed=0)
    sizes = tuple(v.size - 1 for v in (model.vocabs.token_vocab,
                                       model.vocabs.path_vocab,
                                       model.vocabs.target_vocab))
    pool = cs.make_lines(np.random.default_rng(7), 4096, sizes, 200)
    print('engine-compare %s%s:' % (Path(
        code2vec_tpu_torch.__file__).resolve().parents[1],
        '' if scan else ' without the long-context scan'))
    with model.serving_engine(tiers=('topk',), max_delay_ms=2.0) as engine:
        cache = {}
        for _ in range(2):
            cs.engine_load(engine, pool, ('topk',), 5.0, gpu, 'topk', cache)


def java14m_prefix() -> Path:
    """chip_smoke's java14m vocabulary (random words at the default
    sizes), written under its SMOKE_DIR."""
    from code2vec_tpu_torch.config import Config
    base = Config()
    cs.SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    prefix = cs.SMOKE_DIR / 'java14m'
    cs.write_dict(Path(str(prefix) + '.dict.c2v'), base.MAX_TOKEN_VOCAB_SIZE,
                  base.MAX_PATH_VOCAB_SIZE, base.MAX_TARGET_VOCAB_SIZE)
    return prefix


def engine_compare(parent: str | None = None) -> int:
    """``engine-at`` of DIR and this checkout, or, without DIR, of this
    one with and without the scan. The order, A B B A B A A B, balances
    a drift over the call and a dip in its middle: on the card the same
    code read 10–20% lower in the middle processes of a call."""
    if parent is None:
        runs = [[str(ROOT)] + ([] if scan else ['no-scan']) for scan in
                (True, False, False, True, False, True, True, False)]
    else:
        runs = [[parent if a else str(ROOT)] for a in
                (True, False, False, True, False, True, True, False)]
    for args in runs:
        proc = subprocess.run([sys.executable, __file__, 'engine-at', *args],
                              capture_output=True, text=True, timeout=600)
        lines = [line for line in proc.stdout.splitlines()
                 if line.startswith(('engine-compare', 'engine load'))]
        print('\n'.join(lines) or '%s: exit %d %s'
              % (args, proc.returncode, proc.stderr[-2000:]))
        sys.stdout.flush()
        if proc.returncode != 0:
            return 1
    return 0


# the dense encode's gathers before source and target shared one
TWO_GATHERS = """    source_embed = _TakeRows.apply(params.token_embedding, source,
                                   embed_grad_impl).to(dtype)
    path_embed = _TakeRows.apply(params.path_embedding, path,
                                 embed_grad_impl).to(dtype)
    target_embed = _TakeRows.apply(params.token_embedding, target,
                                   embed_grad_impl).to(dtype)
"""


def gather_ablate() -> int:
    import inspect
    from code2vec_tpu_torch import device as device_lib
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    from code2vec_tpu_torch.models import functional
    device_lib.disable_tf32()
    gpu = device_lib.gpu_name_and_power_limit()
    text = inspect.getsource(functional.encode)
    start = text.index('    # source and target rows in one gather')
    end = text.index('    if use_pallas:')
    namespace = dict(vars(functional))
    exec(text[:start] + TWO_GATHERS + text[end:], namespace)
    variants = {'one gather': functional.encode,
                'two gathers': namespace['encode']}
    model = Code2VecModel(Config(TRAIN_DATA_PATH_PREFIX=str(java14m_prefix()),
                                 BATCH_WIRE_FORMAT='planes',
                                 USE_PALLAS_FUSED_CE=True),
                          device='cuda', seed=7)
    model.state = model.trainer.state_from_params()
    backend, vocabs = model.backend, model.vocabs
    rng = np.random.default_rng(9)
    batch = cs.plane_batch(rng, 1024, 200, vocabs.token_vocab.size,
                           vocabs.path_vocab.size, backend.token_pad_index,
                           backend.path_pad_index)
    batch = batch._replace(label=rng.integers(
        0, vocabs.target_vocab.size - 1, 1024).astype(np.int32))
    times = {name: [] for name in variants}
    try:
        for name in ('one gather', 'two gathers', 'two gathers',
                     'one gather', 'one gather', 'two gathers'):
            functional.encode = variants[name]
            times[name].append(cs.repeated_step_ms(model, batch))
    finally:
        functional.encode = variants['one gather']
    print('gather-ablate: plane-wire train step on one repeated batch '
          '(java14m, bf16, keep 0.75, fused CE; device ms, CUDA events): %s '
          '[%s]' % ('; '.join('%s %s' % (name, ' / '.join(
              '%.3f' % t for t in ts)) for name, ts in times.items()), gpu))
    return 0


def scale_card_grads(factor: float) -> None:
    """Every gradient on the card times ``factor`` before Adam."""
    from code2vec_tpu_torch.training import adam_dtypes
    update = adam_dtypes.update_

    def scaled(params, grads, *args, **kwargs):
        if grads and grads[0].is_cuda:
            grads = [g * factor for g in grads]
        return update(params, grads, *args, **kwargs)
    adam_dtypes.update_ = scaled


def run_fault(name: str) -> None:
    """One fault, in this process: raises if the check caught it."""
    import torch
    from code2vec_tpu_torch import device as device_lib
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    from code2vec_tpu_torch.models.backends import TorchBackend
    from code2vec_tpu_torch.ops import _build
    from code2vec_tpu_torch.vocab import Code2VecVocabs
    device_lib.disable_tf32()
    gpu = device_lib.gpu_name_and_power_limit()
    source, text, replacement, phase = FAULTS[name]
    if source is not None:
        copy_sources(ROOT / 'build' / 'mutations' / name, source, text,
                     replacement)
    _build.build()
    if name == 'lazy_no_pad_row':
        from code2vec_tpu_torch.training import trainer as trainer_lib

        def rows_without_pad(ctx, token_pad, path_pad):
            return (ctx[..., 0].reshape(-1), ctx[..., 1].reshape(-1),
                    ctx[..., 2].reshape(-1))
        trainer_lib.packed_rows = rows_without_pad
    if phase == 'train_ref':
        scale_card_grads(1.01)
        cs.write_dict(Path(str(cs.SMOKE_DIR / 'small') + '.dict.c2v'), 300,
                      200, 50)
        # fp32 reads the fault too: its limits are opened so that the bf16
        # draws are what is held
        cs.TRAIN_REF_LIMITS['float32'] = {
            key: 1.0 for key in cs.TRAIN_REF_LIMITS['float32']}
        cs.train_reference_phase(np.random.default_rng(0))
        return
    base = Config()
    prefix = cs.SMOKE_DIR / 'java14m'
    cs.write_dict(Path(str(prefix) + '.dict.c2v'), base.MAX_TOKEN_VOCAB_SIZE,
                  base.MAX_PATH_VOCAB_SIZE, base.MAX_TARGET_VOCAB_SIZE)
    if phase in ('train', 'adam', 'adam_rows', 'lazy'):
        config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                        USE_PALLAS_FUSED_CE=True)
        vocabs = Code2VecVocabs(config)
        if phase == 'lazy':
            cs.knob_phase('lazy', dict(LAZY_EMBEDDING_ADAM=True), vocabs,
                          prefix, np.random.default_rng(20), gpu)
            return
        backend = TorchBackend(config, vocabs, torch.device('cuda'), seed=1)
        if phase == 'train':
            cs.train_kernel_phase(backend, np.random.default_rng(0), gpu)
        elif phase == 'adam':
            cs.adam_kernel_phase(backend, gpu)
        else:
            cs.adam_rows_phase(backend, np.random.default_rng(6), gpu)
    else:
        model = Code2VecModel(Config(
            TRAIN_DATA_PATH_PREFIX=str(prefix), BATCH_WIRE_FORMAT='planes',
            USE_PALLAS_FUSED_ENCODE=True), device='cuda', seed=0)
        cs.encode_kernel_phase(model, np.random.default_rng(1), gpu)


def mutations(names=()) -> int:
    missed = []
    for name in names or FAULTS:
        proc = subprocess.run([sys.executable, __file__, 'fault', name],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode == 0:
            missed.append(name)
            print('fault %s: NOT CAUGHT (the check passed)' % name)
        else:
            lines = (proc.stderr.strip() or proc.stdout.strip()).splitlines()
            print('fault %s: caught: %s' % (name, lines[-1][:1500]
                                            if lines else 'exit %d'
                                            % proc.returncode))
        sys.stdout.flush()
    return 1 if missed else 0


def train_ref_draws(n: int) -> int:
    from code2vec_tpu_torch import device as device_lib
    device_lib.disable_tf32()
    cs.write_dict(Path(str(cs.SMOKE_DIR / 'small') + '.dict.c2v'), 300, 200,
                  50)

    def show(tag, seed, r):
        print('train reference %s, draw %d: loss %.3g; moments %s; update '
              'norm %.3g' % (tag, seed, r['loss'], {
                  m: {k: float('%.3g' % v) for k, v in rd.items()}
                  for m, rd in r['moments'].items()}, r['weights']))
        sys.stdout.flush()
    for seed in range(101, 101 + n):
        show('bf16', seed, cs.train_reference_readings(
            'bfloat16', np.random.default_rng(seed)))
    scale_card_grads(1.01)
    for seed in range(101, 104):
        show('bf16, card gradients x1.01', seed, cs.train_reference_readings(
            'bfloat16', np.random.default_rng(seed)))
    return 0


def grads_float64(args, segs, m, z, gc, g2, keep, rate):
    """_grads_plain in float64, du rounded to bf16 from its float64 value:
    the reference both the kernel and the plain version round towards."""
    import torch
    from code2vec_tpu_torch.ops import ragged
    tok, path, w, attn = args
    e = ragged._gather(tok, path, segs, w.dtype, keep, rate).double()
    w64, a64 = w.double(), attn.double().reshape(-1)
    x = torch.tanh(e @ w64)
    m_s = torch.gather(m.double(), 1, segs.seg)
    z_s = torch.gather(z.double(), 1, segs.seg)
    p = torch.where(segs.slot_valid, torch.exp(x @ a64 - m_s), 0.0)
    wt = p / torch.where(z_s > 0, z_s, 1.0)
    g_s = torch.gather(g2.double(), 1, segs.seg[..., None].expand(
        -1, -1, g2.shape[-1]))
    ds = wt * ((x * g_s).sum(-1) - torch.gather(gc.double(), 1, segs.seg))
    du = (1 - x * x) * (wt[..., None] * g_s + ds[..., None] * a64)
    du = du.to(torch.bfloat16).double()
    de = du @ w64.T
    if keep is not None:
        de = ragged.apply_keep(de, keep, rate)
    return (de, e.reshape(-1, e.shape[-1]).T @ du.reshape(-1, du.shape[-1]),
            torch.einsum('sc,scd->d', ds, x))


def rounding_noise() -> int:
    """The bf16 ragged backward's kernel and its plain version, each
    against grads_float64, at the widths K, D in {128, 256, 384} on
    chip_smoke's edge streams, for two draws of the weights: N(0, 0.3)
    tables, N(0, 0.15) W, N(0, 0.3) attention ('normal'), and the model's
    own initialisation ('init', chip_smoke.small_encoder)."""
    import torch
    from code2vec_tpu_torch import device as device_lib
    from code2vec_tpu_torch.ops import ragged
    device_lib.disable_tf32()
    gpu = device_lib.gpu_name_and_power_limit()

    def normal(gen, dt, dp, d_code):
        def draw(shape, std):
            return torch.from_numpy(gen.normal(0.0, std, shape).astype(
                np.float32)).cuda()
        return (draw((2000, dt), 0.3), draw((1000, dp), 0.3),
                draw((2 * dt + dp, d_code), 0.15), draw((d_code,), 0.3))
    for dist, make in (('normal', normal), ('init', cs.small_encoder)):
        worst_part = {'kernel': 0.0, 'plain': 0.0, 'own du': 0.0}
        for seed in (17, 18, 19):
            gen = np.random.default_rng(seed)
            for k_dim, d_code in ((128, 128), (256, 256), (384, 384),
                                  (128, 256), (256, 128)):
                dt, dp = {128: (32, 64), 256: (64, 128),
                          384: (128, 128)}[k_dim]
                tok, path, w, attn = make(gen, dt, dp, d_code)
                args = (tok, path, w.bfloat16(), attn.bfloat16())
                segs = cs.edge_segments(gen, 2000, 1000, 0, 0, tail=5)
                keep = ragged._draw_keep(29, segs, k_dim, 0.75)
                _s, m, z, acc = ragged._stats_plain(*args, segs, 0, 0, keep,
                                                    0.75)
                code = acc / torch.where(z > 0, z, 1.0)[..., None]
                g2 = torch.from_numpy(gen.normal(0.0, 1.0, code.shape)
                                      .astype(np.float32)).cuda()
                gc = (g2 * code).sum(-1)
                ref = grads_float64(args, segs, m, z, gc, g2, keep, 0.75)
                bwd = args + (segs, m, z, gc, g2, keep, 0.75)
                *kernel, du = ragged._grads_kernel_du(*bwd, token_pad=0,
                                                      path_pad=0)
                outs = {'kernel': kernel, 'plain': ragged._grads_plain(*bwd)}
                own = cs.own_du_reference(args, segs, keep, 0.75, du)
                own_err = (cs.per_example_err(kernel[0], own[0].float(),
                                              segs),
                           cs.scaled_err(kernel[1:2], own[1:]))
                worst_part['own du'] = cs.worst(worst_part['own du'],
                                                *own_err)
                print('rounding-noise %s seed %d K=%d D=%d kernel vs float64 '
                      'from its own du: de per example %.3g, dW %.3g'
                      % (dist, seed, k_dim, d_code, *own_err))
                for tag, o in outs.items():
                    per_ex = cs.per_example_err(o[0], ref[0].float(), segs)
                    worst_part[tag] = cs.worst(worst_part[tag], per_ex)
                    print('rounding-noise %s seed %d K=%d D=%d %s vs float64:'
                          ' de per example %.3g, de %.3g, dW %.3g, d_attn '
                          '%.3g' % (dist, seed, k_dim, d_code, tag, per_ex,
                                    cs.scaled_err(o[:1], ref[:1]),
                                    cs.scaled_err(o[1:2], ref[1:2]),
                                    cs.scaled_err(o[2:], ref[2:])))
                print('rounding-noise %s seed %d K=%d D=%d kernel vs plain: '
                      'de per example %.3g' % (
                          dist, seed, k_dim, d_code, cs.per_example_err(
                              outs['kernel'][0], outs['plain'][0], segs)))
        print('rounding-noise %s: largest de per example against float64: '
              'kernel %.3g, plain %.3g; kernel against float64 from its own '
              'du (de per example, dW): %.3g (chip_smoke limit %.3g) [%s]'
              % (dist, worst_part['kernel'], worst_part['plain'],
                 worst_part['own du'], cs.OWN_DU_LIMIT, gpu))
        sys.stdout.flush()
    return 0


# (anchor in ragged_fwd.cu, text put before it); mark k records clock64
TRACE_MARKS = (
    ('      hop::mbar_wait(&sm.e_empty[es], ((it / kEStages) & 1) ^ 1);\n'
     '      hop::named_sync(4, kGatherThreads);',
     '      if (gt == 0) trace_mark(it, 0);\n'),
    ('      hop::fence_proxy_async();       // the rows, to wgmma',
     '      if (gt == 0) trace_mark(it, 1);\n'),
    ('      hop::mbar_wait(&sm.e_full[st], (it / kEStages) & 1);\n',
     '      if (cw == 0 && t == 0) trace_mark(it, 2);\n'),
    ('      int prev = -1;\n      for (int q = 0; q < n_slices; ++q) {',
     '      if (cw == 0 && t == 0) trace_mark(it, 3);\n'),
    ('      // x = tanh in place;', '      if (cw == 0 && t == 0) '
     'trace_mark(it, 4);\n'),
    ('      hop::named_sync(1, 256);     // both halves',
     '      if (cw == 0 && t == 0) trace_mark(it, 5);\n'),
    ('      hop::named_sync(2 + cw, 128);   // this consumer',
     '      if (cw == 0 && t == 0) trace_mark(it, 6);\n'),
    ('      ++it;\n    }\n  }\n}\n',
     '      if (cw == 0 && t == 0) trace_mark(it, 7);\n'),
)
TRACE_HEADER = (
    'namespace {\n__device__ long long g_trace[256][8][8];\n'
    '__device__ long long g_ns[256][2];\n'
    '__device__ __forceinline__ void trace_mark(int it, int k) {\n'
    '  if (it < 8 && blockIdx.x < 256) {\n'
    '    g_trace[blockIdx.x][it][k] = clock64();\n'
    '    unsigned long long ns;\n'
    '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));\n'
    '    if (k == 2 && it == 0) g_ns[blockIdx.x][0] = ns;\n'
    '    if (k == 7) g_ns[blockIdx.x][1] = ns;\n'
    '  }\n}\n')


def trace() -> int:
    import ctypes
    from code2vec_tpu_torch import device as device_lib
    from code2vec_tpu_torch.ops import _build, ragged
    device_lib.disable_tf32()
    gpu = device_lib.gpu_name_and_power_limit()
    root = ROOT / 'build' / 'trace'
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build._CSRC, root / 'csrc')
    path = root / 'csrc' / 'ragged_fwd.cu'
    src = path.read_text()
    for anchor, mark in TRACE_MARKS:
        if anchor not in src:
            raise SystemExit('trace anchor %r not in ragged_fwd.cu' % anchor)
        src = src.replace(anchor, mark + anchor, 1)
    src = src.replace('namespace {\n', TRACE_HEADER, 1)
    src += ('\nextern "C" int ragged_fwd_trace(void* marks, void* ns) {\n'
            '  cudaError_t e = cudaMemcpyFromSymbol(marks, g_trace, '
            'sizeof(g_trace));\n'
            '  if (e != cudaSuccess) return static_cast<int>(e);\n'
            '  return static_cast<int>(cudaMemcpyFromSymbol(ns, g_ns, '
            'sizeof(g_ns)));\n}\n')
    path.write_text(src)
    _build._CSRC = root / 'csrc'
    _build.BUILD_DIR = root / 'lib'
    _build.build(['ragged_fwd'])
    lib = _build.load('ragged_fwd')
    lib.ragged_fwd_trace.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    inputs = training_inputs()
    calls = kernel_calls(inputs)
    for label, name in (('serving shape, bf16 tables', 'ragged_fwd'),
                        ('training shape, fp32 masters + keep',
                         'ragged_fwd_train')):
        fn = calls[name]
        ms = cs.cuda_ms(fn)
        marks = np.zeros((256, 8, 8), np.int64)
        ns = np.zeros((256, 2), np.int64)
        for _ in range(2):
            marks[:] = 0
            fn()
            import torch
            torch.cuda.synchronize()
            if lib.ragged_fwd_trace(marks.ctypes.data, ns.ctypes.data):
                raise SystemExit('trace read failed')
        used = marks[:, :4, 2] > 0
        ctas = used.all(axis=1)
        # cycles per microsecond from each CTA's span on both clocks
        span = marks[ctas, :, 7].max(axis=1) - marks[ctas, 0, 2]
        mhz = float(np.median(span / ((ns[ctas, 1] - ns[ctas, 0]) / 1e3)))
        m = marks[ctas, :4].astype(np.float64) / mhz   # microseconds

        def phase(a, b):
            return float(np.median(m[..., b] - m[..., a]))
        period = float(np.median(m[:, 1:, 2] - m[:, :-1, 2]))
        gather = (phase(0, 1) if name == 'ragged_fwd'
                  else float('nan'))
        print('trace ragged_fwd bf16, %s: %.4f ms; per tile (us, median of '
              '%d CTAs x 4 tiles, %.0f MHz): producer gather %.2f; consumer '
              'wait for e %.2f, x product (its W waits included) %.2f, tanh '
              '+ score %.2f, scans %.2f, stores %.2f, tile period %.2f [%s]'
              % (label, ms, int(ctas.sum()), mhz, gather, phase(2, 3),
                 phase(3, 4), phase(4, 5), phase(5, 6), phase(6, 7),
                 period, gpu))
        sys.stdout.flush()
    return 0


def profile() -> int:
    import torch
    from code2vec_tpu_torch import device as device_lib
    from code2vec_tpu_torch.ops import encode
    device_lib.disable_tf32()
    gpu = device_lib.gpu_name_and_power_limit()
    inputs = training_inputs()
    calls = kernel_calls(inputs)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    rows = 1024 * 200
    enc = [(torch.rand(*s, device='cuda', generator=gen) * 0.6 - 0.3
            ).bfloat16() for s in ((rows, 128), (rows, 128), (rows, 128),
                                   (384, 384), (384, 1))]
    calls['encode'] = lambda: encode._transform_kernel(*enc)
    from torch.profiler import ProfilerActivity, profile as torch_profile
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        for event in prof.key_averages():
            total_us = getattr(event, 'device_time_total', None)
            if total_us is None:
                total_us = getattr(event, 'cuda_time_total', 0.0)
            if event.count and total_us:
                print('profile %s: %s x%d, %.4f ms per call [%s]' % (
                    name, event.key[:90], event.count, total_us / 10 / 1e3,
                    gpu))
    # the forward's pair map from torch ops (its plain version) on the
    # card, against the plan kernel that builds it
    from code2vec_tpu_torch.ops import ragged
    segs = inputs['serving'][4]
    print('profile ragged_fwd pair map: plan kernel %.4f ms, the same map '
          'from torch ops (ragged._pair_map) %.4f ms (graph replay) [%s]'
          % (cs.cuda_ms(lambda: ragged._pair_map_kernel(segs)),
             cs.cuda_ms(lambda: ragged._pair_map(segs)), gpu))
    return 0


def main(argv) -> int:
    if argv[:1] == ['mutations']:
        return mutations(argv[1:])
    if argv[:1] == ['fault']:
        run_fault(argv[1])
        return 0
    if argv[:1] == ['train-ref-draws']:
        return train_ref_draws(int(argv[1]) if len(argv) > 1 else 10)
    if argv[:1] == ['profile']:
        return profile()
    if argv[:1] == ['ablate']:
        return ablate(argv[1:])
    if argv[:1] == ['ablation']:
        run_ablation(argv[1], argv[2])
        return 0
    if argv[:1] == ['compare']:
        return compare(argv[1])
    if argv[:1] == ['engine-compare']:
        return engine_compare(argv[1])
    if argv[:1] == ['engine-at']:
        engine_at(argv[1], scan=argv[2:] != ['no-scan'])
        return 0
    if argv[:1] == ['scan-ablate']:
        return engine_compare()
    if argv[:1] == ['gather-ablate']:
        return gather_ablate()
    if argv[:1] == ['rounding-noise']:
        return rounding_noise()
    if argv[:1] == ['trace']:
        return trace()
    if argv[:1] == ['time-at']:
        time_at(argv[1])
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
