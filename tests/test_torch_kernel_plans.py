"""Host side of the Hopper kernels (wgmma fed by TMA), on the CPU: how the
CE backward cuts its work and sizes its scratch, how the encode kernel
cuts K, and which shapes and alignments the wrappers' checks accept or
reject before a launch. Nothing here needs a card."""
from __future__ import annotations

import pytest
import torch

from code2vec_tpu_torch.ops import ce, encode

H100_SMS = 132


@pytest.mark.parametrize('batch,vocab,dim,sms', [
    (1024, 262144, 384, H100_SMS),     # the java14m training shape
    (1000, 262144, 384, H100_SMS),     # a partial last row tile
    (333, 4096, 128, H100_SMS),
    (200, 2048, 256, H100_SMS),
    (64, 1024, 128, H100_SMS),
    (1, 64, 384, H100_SMS),            # one row, one block
    (8192, 262144, 384, H100_SMS),     # more row tiles than SMs
    (1024, 262144, 384, 114),          # another card
])
def test_bwd_plan_covers_every_block_once(batch, vocab, dim, sms):
    plan = ce._bwd_plan(batch, vocab, dim, sms)
    n_blocks = vocab // 64
    assert plan['n_blocks'] == n_blocks
    assert plan['row_tiles'] == -(-batch // 64)
    assert 1 <= plan['n_splits'] <= n_blocks
    # the splits tile the blocks: none past the table, none missing
    assert plan['per_split'] * plan['n_splits'] >= n_blocks
    assert plan['per_split'] * (plan['n_splits'] - 1) < n_blocks
    assert plan['units'] == plan['row_tiles'] * plan['n_splits']
    assert plan['scratch'] == (plan['n_splits'], batch, dim)


def test_bwd_plan_at_the_training_shape():
    plan = ce._bwd_plan(1024, 262144, 384, H100_SMS)
    # 16 row tiles x 33 splits = 528 units: four per SM of an H100
    assert plan['n_splits'] == 33
    assert plan['units'] == 4 * H100_SMS
    assert plan['per_split'] == 125
    assert plan['scratch'] == (33, 1024, 384)


@pytest.mark.parametrize('batch', [1, 64, 1000, 1024, 4096])
def test_splits_give_about_four_units_per_sm(batch):
    n_blocks = 4096
    n_splits = ce._splits(H100_SMS, batch, n_blocks)
    units = -(-batch // 64) * n_splits
    assert units >= min(4 * H100_SMS, -(-batch // 64) * n_blocks)
    assert units < 4 * H100_SMS + -(-batch // 64)


def _ce_inputs(batch, vocab, dim, dtype):
    return (torch.zeros(batch, dim, dtype=dtype),
            torch.zeros(vocab, dim, dtype=dtype),
            torch.zeros(batch, dtype=torch.int32))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('dim', [128, 256, 384])
def test_ce_check_accepts_the_kernel_shapes(dtype, dim):
    code, w, label = _ce_inputs(1000, 4096, dim, dtype)
    assert ce._check(code, w, label) == ce._DTYPE_CODES[dtype]


@pytest.mark.parametrize('batch,vocab,dim,error', [
    (64, 4096, 192, ValueError),     # D not a multiple of 128
    (64, 4096, 512, ValueError),     # D above 384
    (64, 4000, 128, ValueError),     # V not a multiple of the 64-row block
])
def test_ce_check_rejects_shapes(batch, vocab, dim, error):
    code, w, label = _ce_inputs(batch, vocab, dim, torch.bfloat16)
    with pytest.raises(error):
        ce._check(code, w, label)


def test_ce_check_rejects_mixed_dtypes():
    code, w, label = _ce_inputs(64, 1024, 128, torch.bfloat16)
    with pytest.raises(TypeError):
        ce._check(code, w.float(), label)


def test_ce_check_rejects_a_misaligned_bf16_operand():
    # TMA reads the bf16 operands: a base 2 bytes off a 16-byte boundary
    # is refused before any launch; fp32 (CUDA cores) takes it
    flat = torch.zeros(64 * 128 + 1, dtype=torch.bfloat16)
    code = flat[1:].view(64, 128)
    w = torch.zeros(1024, 128, dtype=torch.bfloat16)
    label = torch.zeros(64, dtype=torch.int32)
    assert code.data_ptr() % 16
    with pytest.raises(ValueError, match='16-byte'):
        ce._check(code, w, label)
    flat32 = torch.zeros(64 * 128 + 1)
    assert ce._check(flat32[1:].view(64, 128), w.float(), label) == 0


@pytest.mark.parametrize('token_dim,path_dim,slices', [
    (128, 128, 6),      # java14m: src 2 + path 2 + tgt 2
    (64, 32, 3),        # the path slice padded from 32 to 64 columns
    (96, 32, 5),        # 96 = 64 + a padded 32
    (32, 64, 3),
    (160, 128, 8),      # beyond the six slices of W shared memory holds
])
def test_encode_k_slices(token_dim, path_dim, slices):
    assert encode._k_slices(token_dim, path_dim) == slices


def _encode_inputs(n, token_dim, path_dim, code_dim, dtype):
    k = 2 * token_dim + path_dim
    return (torch.zeros(n, token_dim, dtype=dtype),
            torch.zeros(n, path_dim, dtype=dtype),
            torch.zeros(n, token_dim, dtype=dtype),
            torch.zeros(k, code_dim, dtype=dtype),
            torch.zeros(code_dim, 1, dtype=dtype))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('dims', [(128, 128, 384), (64, 32, 128),
                                  (64, 32, 256), (96, 32, 384)])
def test_encode_check_accepts_the_kernel_shapes(dtype, dims):
    args = _encode_inputs(100, *dims, dtype)
    assert encode._check_kernel_args(*args) == encode._DTYPE_CODES[dtype]


def test_encode_check_rejects_too_many_bf16_slices():
    args = _encode_inputs(10, 160, 128, 384, torch.bfloat16)
    with pytest.raises(ValueError, match='K slices'):
        encode._check_kernel_args(*args)
    # fp32 streams K through the CUDA cores and takes it
    args = _encode_inputs(10, 160, 128, 384, torch.float32)
    assert encode._check_kernel_args(*args) == 0


@pytest.mark.parametrize('dims', [(48, 128, 384), (128, 128, 192)])
def test_encode_check_rejects_shapes(dims):
    args = _encode_inputs(10, *dims, torch.bfloat16)
    with pytest.raises(ValueError):
        encode._check_kernel_args(*args)


def test_encode_check_rejects_a_misaligned_bf16_input():
    src, pth, tgt, w, attn = _encode_inputs(10, 128, 128, 384,
                                            torch.bfloat16)
    flat = torch.zeros(10 * 128 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(10, 128)
    with pytest.raises(ValueError, match='16-byte'):
        encode._check_kernel_args(shifted, pth, tgt, w, attn)


def test_encode_check_rejects_non_contiguous_rows():
    src, pth, tgt, w, attn = _encode_inputs(10, 128, 128, 384,
                                            torch.bfloat16)
    wide = torch.zeros(10, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='contiguous'):
        encode._check_kernel_args(wide[:, :128], pth, tgt, w, attn)
