#!/usr/bin/env python3
"""Checks of chip_smoke.py's own checks, run by hand on one CUDA card:

    python3 scripts/torch_kernel_checks.py mutations
    python3 scripts/torch_kernel_checks.py train-ref-draws [N]
    python3 scripts/torch_kernel_checks.py profile
    python3 scripts/torch_kernel_checks.py ablate

``mutations`` applies one fault at a time to a copy of the kernel sources
(under build/mutations/ in this checkout), builds the copy and runs the
chip_smoke phase that must catch it, each in a process of its own (a
fault on the card ends its process's CUDA context); it prints one line
per fault, ``caught`` or ``NOT CAUGHT``, and exits non-zero if any fault
went through. The faults: the CE backward without its softmax term, with
every dlogit x1.01, with the wgmma descriptor's two strides swapped and
with the fixed tile's K slices swapped; the encode kernel with W's K
slices swapped, with its descriptor strides swapped and with another
swizzle mode in the descriptor; and every gradient of a train step x1.01
before Adam, held by the bf16 train reference.

``train-ref-draws`` prints chip_smoke's bf16 train-reference readings for
N draws of batches (generators seeded 101 ...), then for three draws with
every gradient on the card x1.01: the data the bf16 limits are set from.

``profile`` times the CUDA kernels of the bf16 CE backward and the bf16
encode at the main paths' shapes with torch.profiler, by kernel name.

``ablate`` times the bf16 CE backward at the training shape with one part
of its work taken out at a time (results wrong, times only), each built
from a copy of the sources under build/ablations/: where its time goes.
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
    'train_grads_x1.01': (None, None, None, 'train_ref'),
}


# name: (source file, text, replacement); the CE backward with one part
# of its work taken out
ABLATIONS = {
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


def run_ablation(name: str) -> None:
    import torch
    from code2vec_tpu_torch import device as device_lib
    from code2vec_tpu_torch.ops import _build, ce
    device_lib.disable_tf32()
    gpu = device_lib.gpu_name_and_power_limit()
    edit = ABLATIONS[name]
    if edit is not None:
        copy_sources(ROOT / 'build' / 'ablations' / name.replace(' ', '_'),
                     *edit)
    _build.build(['ce'])
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    batch, vocab, dim, n_valid = 1024, 262144, 384, 261245
    code = (torch.randn(batch, dim, device='cuda', generator=gen) * 0.1
            ).bfloat16()
    w = (torch.randn(vocab, dim, device='cuda', generator=gen) * 0.1
         ).bfloat16()
    label = torch.randint(0, n_valid, (batch,), device='cuda',
                          generator=gen, dtype=torch.int32)
    lse = ce._lse_pick_plain(code, w, label, n_valid)[0]
    dlse = torch.full((batch,), 1.0 / batch, device='cuda')
    ms = cs.cuda_ms(lambda: ce._ce_grads_kernel(code, w, label, lse, dlse,
                                                -dlse, n_valid))
    print('ablate ce_bwd bf16, %s: %.4f ms [%s]' % (name, ms, gpu))


def ablate() -> int:
    for name in ABLATIONS:
        proc = subprocess.run([sys.executable, __file__, 'ablation', name],
                              capture_output=True, text=True, timeout=600)
        lines = (proc.stdout.strip() or proc.stderr.strip()).splitlines()
        print(lines[-1] if lines else '%s: exit %d' % (name,
                                                       proc.returncode))
        sys.stdout.flush()
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
    if phase == 'train':
        config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                        USE_PALLAS_FUSED_CE=True)
        backend = TorchBackend(config, Code2VecVocabs(config),
                               torch.device('cuda'), seed=1)
        cs.train_kernel_phase(backend, np.random.default_rng(0), gpu)
    else:
        model = Code2VecModel(Config(
            TRAIN_DATA_PATH_PREFIX=str(prefix), BATCH_WIRE_FORMAT='planes',
            USE_PALLAS_FUSED_ENCODE=True), device='cuda', seed=0)
        cs.encode_kernel_phase(model, np.random.default_rng(1), gpu)


def mutations() -> int:
    missed = []
    for name in FAULTS:
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


def profile() -> int:
    import torch
    from code2vec_tpu_torch import device as device_lib
    from code2vec_tpu_torch.ops import ce, encode
    device_lib.disable_tf32()
    gpu = device_lib.gpu_name_and_power_limit()
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    batch, vocab, dim, n_valid = 1024, 262144, 384, 261245
    code = (torch.randn(batch, dim, device='cuda', generator=gen) * 0.1
            ).bfloat16()
    w = (torch.randn(vocab, dim, device='cuda', generator=gen) * 0.1
         ).bfloat16()
    label = torch.randint(0, n_valid, (batch,), device='cuda',
                          generator=gen, dtype=torch.int32)
    lse = ce._lse_pick_plain(code, w, label, n_valid)[0]
    dlse = torch.full((batch,), 1.0 / batch, device='cuda')
    rows = 1024 * 200
    enc = [(torch.rand(*s, device='cuda', generator=gen) * 0.6 - 0.3
            ).bfloat16() for s in ((rows, 128), (rows, 128), (rows, 128),
                                   (384, 384), (384, 1))]
    calls = {'ce_bwd': lambda: ce._ce_grads_kernel(
        code, w, label, lse, dlse, -dlse, n_valid),
        'encode': lambda: encode._transform_kernel(*enc)}
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
    return 0


def main(argv) -> int:
    if argv[:1] == ['mutations']:
        return mutations()
    if argv[:1] == ['fault']:
        run_fault(argv[1])
        return 0
    if argv[:1] == ['train-ref-draws']:
        return train_ref_draws(int(argv[1]) if len(argv) > 1 else 10)
    if argv[:1] == ['profile']:
        return profile()
    if argv[:1] == ['ablate']:
        return ablate()
    if argv[:1] == ['ablation']:
        run_ablation(argv[1])
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
