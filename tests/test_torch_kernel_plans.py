"""Host side of the Hopper kernels (wgmma fed by TMA), on the CPU: how the
CE forward and backward and the ragged backward cut their work and size
their scratch, the ragged backward's per-slot example ids, how the encode
kernel cuts K, and which shapes and alignments the wrappers' checks accept
or reject before a launch. Nothing here needs a card."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from code2vec_tpu_torch.data.packed import segment_structure
from code2vec_tpu_torch.ops import ce, encode, ragged

H100_SMS = 132


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
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
def test_bwd_plan_covers_every_block_once(batch, vocab, dim, sms, dtype):
    plan = ce._bwd_plan(batch, vocab, dim, sms, dtype)
    # pass 2 streams 64-row table blocks in bf16, 32-row ones in fp32
    block = 32 if dtype == torch.float32 else 64
    n_blocks = vocab // block
    assert plan['block'] == block
    assert plan['n_blocks'] == n_blocks
    assert plan['row_tiles'] == -(-batch // 64)
    assert 1 <= plan['n_splits'] <= n_blocks
    # the splits tile the blocks: none past the table, none missing
    assert plan['per_split'] * plan['n_splits'] >= n_blocks
    assert plan['per_split'] * (plan['n_splits'] - 1) < n_blocks
    assert plan['units'] == plan['row_tiles'] * plan['n_splits']
    # pass 1: every 64-row table block once, over every block of code rows
    assert plan['dw_units'] * 64 == vocab
    assert plan['dw_blocks'] * block >= batch > (plan['dw_blocks'] - 1) * block
    assert plan['scratch'] == (plan['n_splits'], batch, dim)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_bwd_plan_at_the_training_shape(dtype):
    plan = ce._bwd_plan(1024, 262144, 384, H100_SMS, dtype)
    # 16 row tiles x 33 splits = 528 units: four per SM of an H100
    assert plan['n_splits'] == 33
    assert plan['units'] == 4 * H100_SMS
    assert plan['scratch'] == (33, 1024, 384)
    if dtype == torch.bfloat16:
        assert plan['per_split'] == 125
        assert (plan['dw_units'], plan['dw_blocks']) == (4096, 16)
    else:
        # 8,192 blocks of 32 rows: 32 splits of 249 and a last of 224
        assert plan['per_split'] == 249
        assert (plan['dw_units'], plan['dw_blocks']) == (4096, 32)


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
    # is refused before any launch; fp32 (16-byte cp.async) refuses a base
    # 4 bytes off too
    flat = torch.zeros(64 * 128 + 1, dtype=torch.bfloat16)
    code = flat[1:].view(64, 128)
    w = torch.zeros(1024, 128, dtype=torch.bfloat16)
    label = torch.zeros(64, dtype=torch.int32)
    assert code.data_ptr() % 16
    with pytest.raises(ValueError, match='16-byte'):
        ce._check(code, w, label)
    flat32 = torch.zeros(64 * 128 + 1)
    with pytest.raises(ValueError, match='16-byte'):
        ce._check(flat32[1:].view(64, 128), w.float(), label)


@pytest.mark.parametrize('which', ['code', 'table'])
@pytest.mark.parametrize('offset', [1, 2, 3])
def test_ce_check_rejects_a_misaligned_fp32_operand(which, offset):
    # the fp32 kernels stage both operands by 16-byte cp.async: a base 4,
    # 8 or 12 bytes off a 16-byte boundary is refused before any launch
    code = torch.zeros(64, 128)
    w = torch.zeros(1024, 128)
    label = torch.zeros(64, dtype=torch.int32)
    assert ce._check(code, w, label) == 0
    src = code if which == 'code' else w
    shifted = torch.zeros(src.numel() + offset)[offset:].view(src.shape)
    assert shifted.data_ptr() % 16 == 4 * offset
    args = (shifted, w) if which == 'code' else (code, shifted)
    with pytest.raises(ValueError, match='16-byte'):
        ce._check(*args, label)


@pytest.mark.parametrize('batch,vocab,dim,error', [
    (64, 4096, 64, ValueError),      # D under the fp32 kernels' 128
    (64, 4096, 192, ValueError),     # D not a multiple of 128
    (64, 4096, 512, ValueError),     # D above 384: acc past 96 registers
    (64, 4032 + 32, 128, ValueError),  # V a multiple of 32, not of 64
    (64, 4000, 128, ValueError),     # V not a multiple of the 64-row block
])
def test_ce_check_rejects_fp32_shapes(batch, vocab, dim, error):
    code, w, label = _ce_inputs(batch, vocab, dim, torch.float32)
    with pytest.raises(error):
        ce._check(code, w, label)


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


# ------------------------------------------------ the ragged backward
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('n_slots,k_dim,d_code,sms', [
    (40960, 384, 384, H100_SMS),      # the java14m training stream
    (38879, 384, 384, H100_SMS),      # a last tile that is partial
    (64, 384, 384, H100_SMS),         # one tile
    (65, 128, 256, H100_SMS),         # one slot past a tile
    (1, 256, 128, H100_SMS),
    (300000, 128, 128, H100_SMS),     # more tiles than SMs per split
    (40960, 384, 384, 114),           # another card
])
def test_ragged_bwd_plan_covers_the_stream_once(n_slots, k_dim, d_code,
                                                sms, dtype):
    plan = ragged._bwd_plan(n_slots, k_dim, d_code, sms, dtype)
    tile, n_tiles = plan['tile'], plan['n_tiles']
    assert tile == 64
    # tile t holds slots [64 t, min(64 t + 64, n_slots)): every slot once,
    # none past the stream
    covered = np.zeros(n_slots, np.int64)
    for t in range(n_tiles):
        lo, hi = tile * t, min(tile * t + tile, n_slots)
        assert lo < hi <= n_slots
        covered[lo:hi] += 1
    assert (covered == 1).all()
    if dtype == torch.float32:
        # one CTA a tile, each writing its d_attn partial
        assert plan['n_parts'] == n_tiles
    else:
        assert 1 <= plan['n_parts'] <= min(n_tiles, sms)
    # the dW product's slot ranges: every tile in exactly one range
    chunks, n_splits = plan['chunks_per_split'], plan['n_splits']
    owners = np.zeros(n_tiles, np.int64)
    for split in range(n_splits):
        lo = split * chunks
        hi = min(n_tiles, lo + chunks)
        assert lo < hi                       # no empty range
        owners[lo:hi] += 1
    assert (owners == 1).all()
    # bf16: 128-row blocks of dW x two column halves; fp32: 128 x 128
    # tiles of dW
    per_split = ((k_dim // 128) * (d_code // 128) if dtype == torch.float32
                 else 2 * (k_dim // 128))
    assert plan['per_split'] == per_split
    assert plan['dw_units'] == n_splits * per_split
    assert plan['dw_units'] <= max(sms, per_split)
    scratch = plan['scratch']
    assert scratch['e'] == (n_slots, k_dim)
    assert scratch['du'] == (n_slots, d_code)
    assert scratch['live'] == (n_tiles,)
    assert scratch['part_dattn'] == (plan['n_parts'], d_code)
    assert scratch['part_dw'] == (n_splits, k_dim, d_code)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_ragged_bwd_plan_at_the_training_shape(dtype):
    plan = ragged._bwd_plan(40960, 384, 384, H100_SMS, dtype)
    if dtype == torch.bfloat16:
        # 640 tiles on 132 persistent CTAs; dW: 22 ranges of 30 tiles,
        # each in 6 units (3 row blocks of 128 x 2 column halves) = 132
        assert (plan['n_tiles'], plan['n_parts']) == (640, 132)
        assert (plan['n_splits'], plan['chunks_per_split']) == (22, 30)
        assert plan['dw_units'] == 132
    else:
        # 640 tiles, a CTA each; dW: 14 ranges of 46 tiles (the last 42),
        # each in 9 units (3 x 3 tiles of 128 x 128) = 126
        assert (plan['n_tiles'], plan['n_parts']) == (640, 640)
        assert (plan['n_splits'], plan['chunks_per_split']) == (14, 46)
        assert plan['dw_units'] == 126


def _segments(counts, shards, cap, seed=0):
    rng = np.random.default_rng(seed)
    ctx = torch.from_numpy(rng.integers(1, 50, (shards, cap, 3)).astype(
        np.int32))
    return ragged._segment_inputs(ctx, torch.tensor(counts), 0, 0)


@pytest.mark.parametrize('counts,shards,cap', [
    ([1, 63, 64, 65, 0, 0, 1, 28, 7], 1, 300),
    ([0, 5, 70, 0, 3, 200, 1, 64], 2, 320),      # two shards, each a tail
    ([0, 0, 0], 1, 64),                           # no valid slot
])
def test_kernel_slots_follow_segment_structure(counts, shards, cap):
    segs = _segments(counts, shards, cap)
    seg, valid = ragged._kernel_slots(segs)
    assert seg.dtype == torch.int32 and valid.dtype == torch.uint8
    assert seg.shape == valid.shape == (shards * cap,)
    per_shard = len(counts) // shards
    count2 = np.array(counts).reshape(shards, per_shard)
    want_seg, _pos, in_range = segment_structure(
        torch.from_numpy(count2).to(torch.int32), cap)
    base = (np.arange(shards) * per_shard)[:, None]
    assert np.array_equal(seg.numpy().reshape(shards, cap),
                          want_seg.numpy() + base)
    # the slots in range, independently: each example's count slots in
    # order, flat example ids shard after shard
    for d in range(shards):
        ids = np.repeat(np.arange(per_shard) + d * per_shard, count2[d])
        got = seg.numpy().reshape(shards, cap)[d, :len(ids)]
        assert np.array_equal(got, ids)
        assert not in_range[d, len(ids):].any()
    assert np.array_equal(valid.numpy().astype(bool),
                          segs.slot_valid.reshape(-1).numpy())


def _grads_inputs(token_dim, path_dim, code_dim, dtype, table_dtype=None):
    segs = _segments([3, 1, 0, 5], 1, 64)
    k_dim = 2 * token_dim + path_dim
    table_dtype = table_dtype or dtype
    return (torch.zeros(50, token_dim, dtype=table_dtype),
            torch.zeros(50, path_dim, dtype=table_dtype),
            torch.zeros(k_dim, code_dim, dtype=dtype),
            torch.zeros(code_dim, dtype=dtype), segs)


@pytest.mark.parametrize('dtype,table_dtype', [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize('dims', [(32, 64, 128), (64, 128, 256),
                                  (128, 128, 384), (32, 64, 384),
                                  (128, 128, 128)])
def test_ragged_bwd_check_accepts_the_kernel_shapes(dtype, table_dtype,
                                                    dims):
    args = _grads_inputs(*dims, dtype, table_dtype)
    codes = ragged._check_grads_args(*args, None)
    assert codes == (ragged._DTYPE_CODES[dtype],
                     0 if table_dtype == torch.float32 else 1)


@pytest.mark.parametrize('dims', [
    (32, 128, 384),       # K = 192: not a multiple of 128
    (128, 256, 384),      # K = 512: above 384
    (128, 128, 192),      # D not a multiple of 128
    (128, 128, 512),      # D above 384
    (30, 68, 128),        # K = 128, but dims not multiples of 4
])
def test_ragged_bwd_check_rejects_shapes(dims):
    args = _grads_inputs(*dims, torch.bfloat16, torch.float32)
    with pytest.raises(ValueError):
        ragged._check_grads_args(*args, None)


def test_ragged_bwd_check_rejects_fp32_weights_on_bf16_tables():
    args = _grads_inputs(128, 128, 384, torch.float32, torch.bfloat16)
    with pytest.raises(TypeError):
        ragged._check_grads_args(*args, None)


def test_ragged_bwd_check_rejects_a_misaligned_bf16_transform():
    # TMA reads W: a base 2 bytes off a 16-byte boundary is refused
    tok, path, w, attn, segs = _grads_inputs(128, 128, 384, torch.bfloat16,
                                             torch.float32)
    flat = torch.zeros(w.numel() + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(w.shape)
    assert shifted.data_ptr() % 16
    with pytest.raises(ValueError, match='16-byte'):
        ragged._check_grads_args(tok, path, shifted, attn, segs, None)
    # fp32 takes it: the wrapper stages a copy of a misaligned W
    flat32 = torch.zeros(w.numel() + 1)
    assert ragged._check_grads_args(tok, path, flat32[1:].view(w.shape),
                                    attn.float(), segs, None) == (0, 0)


def test_ragged_bwd_check_rejects_a_keep_mask_of_another_shape():
    args = _grads_inputs(128, 128, 384, torch.bfloat16, torch.float32)
    keep = torch.ones(1, 64, 128, dtype=torch.bool)
    with pytest.raises(ValueError, match='keep mask'):
        ragged._check_grads_args(*args, keep)
    good = torch.ones(1, 64, 384, dtype=torch.bool)
    assert ragged._check_grads_args(*args, good) == (1, 0)


# ------------------------------------------------------ the CE forward
@pytest.mark.parametrize('batch,vocab,dim', [
    (1024, 262144, 384), (1000, 262144, 384), (333, 4096, 128),
    (333, 4096, 256), (1, 64, 384), (64, 4032, 128), (20000, 262144, 384)])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_fwd_plan_covers_every_block_once(batch, vocab, dim, dtype):
    plan = ce._fwd_plan(batch, vocab, dtype, H100_SMS)
    rows, block = plan['row_tile'], plan['block']
    # both dtypes: 128 code rows x 128-row blocks; fp32 stages both
    # operands in 32-column slices through 4 stages
    assert (rows, block) == (128, 128)
    assert (plan['k_slice'], plan['stages']) == (
        (32, 4) if dtype == torch.float32 else (64, 6))
    assert dim % plan['k_slice'] == 0
    assert plan['row_tiles'] == -(-batch // rows)
    # the blocks reach the last table row and start inside the table
    assert plan['n_blocks'] * block >= vocab
    assert (plan['n_blocks'] - 1) * block < vocab
    assert 1 <= plan['n_splits'] <= plan['n_blocks']
    assert plan['per_split'] * plan['n_splits'] >= plan['n_blocks']
    assert plan['per_split'] * (plan['n_splits'] - 1) < plan['n_blocks']
    assert plan['units'] == plan['row_tiles'] * plan['n_splits']
    assert plan['scratch'] == (3, plan['n_splits'], batch)


def test_fwd_plan_at_the_training_shape():
    plan = ce._fwd_plan(1024, 262144, torch.bfloat16, H100_SMS)
    # 8 row tiles of 128 x 16 splits of 128 blocks: one wave of 128 units
    assert (plan['row_tiles'], plan['n_splits'], plan['per_split']) == (
        8, 16, 128)
    assert plan['units'] == 128 <= H100_SMS
    # fp32 takes the same cut: one wave, 12 slices of 32 columns a block
    plan32 = ce._fwd_plan(1024, 262144, torch.float32, H100_SMS)
    assert plan32['units'] == 128 <= H100_SMS
    assert (plan32['n_splits'], plan32['per_split']) == (16, 128)
    assert 384 // plan32['k_slice'] == 12


# ------------------------------------------------ the ragged forward (bf16)
def _rung_segments(shards, seed):
    """A java14m-like fill of 96 examples per shard packed at its capacity
    rung (bucketed_capacity), with empty examples."""
    from code2vec_tpu_torch.data import packed as packed_lib
    from code2vec_tpu_torch.data.reader import Batch
    rng = np.random.default_rng(seed)
    batch = 96 * shards
    counts = np.clip(np.rint(np.exp(rng.normal(np.log(28.0), 0.8, batch))),
                     1, 200).astype(np.int64)
    counts[rng.choice(batch, 6, replace=False)] = 0
    counts[rng.choice(batch, 2, replace=False)] = 200
    cols = np.arange(200)[None, :]
    planes = [np.where(cols < counts[:, None],
                       rng.integers(1, 50, (batch, 200)), 0).astype(np.int32)
              for _ in range(3)]
    mask = (cols < counts[:, None]).astype(np.float32)
    packed = packed_lib.pack_batch(
        Batch(source=planes[0], path=planes[1], target=planes[2], mask=mask,
              label=np.zeros(batch, np.int32),
              weight=np.ones(batch, np.float32)), 0, 0, data_shards=shards)
    assert packed.ctx.shape[1] == packed_lib.bucketed_capacity(
        int(packed.count.reshape(shards, -1).sum(axis=1).max()))
    return ragged._segment_inputs(torch.from_numpy(packed.ctx),
                                  torch.from_numpy(packed.count), 0, 0)


PAIR_CASES = {
    # examples of 1, 63, 64, 65 and 200 slots, empty ones, a partial last
    # tile
    'tile edges': ([1, 63, 64, 65, 0, 0, 1, 28, 7, 200], 1, 500),
    # examples that start exactly at a tile edge (slots 64, 128, 192)
    'starts at edges': ([64, 64, 0, 64, 3], 1, 256),
    # two shards, slots past each shard's total
    'two shards': ([0, 5, 70, 0, 3, 200, 1, 64], 2, 320),
    # shards shorter than a tile: one tile spans both
    'short shards': ([3, 0, 5, 2, 0, 7], 2, 40),
    'no slot in any example': ([0, 0, 0], 1, 64),
    'capacity rung, one shard': (None, 1, 0),
    'capacity rung, two shards': (None, 2, 1),
}


def _pair_case(case):
    counts, shards, cap = PAIR_CASES[case]
    if counts is None:
        return _rung_segments(shards, seed=cap)
    return _segments(counts, shards, cap)


@pytest.mark.parametrize('case', sorted(PAIR_CASES))
def test_pair_map_covers_every_slot_once(case):
    segs = _pair_case(case)
    pm = ragged._pair_map(segs)
    shards, cap, _ = segs.ctx.shape
    n_slots = shards * cap
    n_tiles = -(-n_slots // 64)
    count2 = segs.count2.numpy()
    counts = count2.reshape(-1)
    batch = counts.size
    pair, n_pairs = pm.pair.numpy(), pm.n_pairs.numpy()
    pair_start = pm.pair_start.numpy()
    assert pm.pair.dtype == pm.pair_start.dtype == torch.int32
    assert pair.shape == (n_slots,) and n_pairs.shape == (batch,)
    # pairs in example order: each example's run starts where the last
    # ended; examples of 0 slots have none; at most batch + n_tiles
    assert np.array_equal(pair_start, np.cumsum(n_pairs) - n_pairs)
    assert np.array_equal(n_pairs == 0, counts == 0)
    assert pm.bound == batch + n_tiles >= n_pairs.sum()
    # independently: example b's segment [start, start + count) of the
    # flat stream, its slot t in the pair of tile t // 64
    want = np.full(n_slots, -1)
    for d in range(shards):
        starts = d * cap + np.cumsum(count2[d]) - count2[d]
        for i, (start, count) in enumerate(zip(starts, count2[d])):
            b = d * count2.shape[1] + i
            slots = np.arange(start, start + count)
            want[slots] = pair_start[b] + slots // 64 - start // 64
            if count:
                assert n_pairs[b] == (start + count - 1) // 64 - start // 64 + 1
    assert np.array_equal(pair, want)
    # every valid slot has a pair; each pair lies in one tile, its slots
    # contiguous, and every pair index up to the total has a slot
    assert (pair[segs.slot_valid.reshape(-1).numpy()] >= 0).all()
    for p in range(int(n_pairs.sum())):
        slots = np.flatnonzero(pair == p)
        assert slots.size and slots[-1] - slots[0] == slots.size - 1
        assert slots[0] // 64 == slots[-1] // 64


def _emulated_stats(tok, path, w, attn, segs, keep, keep_rate):
    """The bf16 forward's decomposition in plain torch: each pair's
    statistics over its own slots (the kernel's tile statistics), then
    each example's pairs folded with the rescale (its merge)."""
    pm = ragged._pair_map(segs)
    e = ragged._gather(tok, path, segs, w.dtype, keep, keep_rate).float()
    x = torch.tanh(e @ w.float()).reshape(-1, w.shape[1])
    s = x @ attn.float().reshape(-1)
    valid = segs.slot_valid.reshape(-1)
    pair = pm.pair.long()
    n = int(pm.n_pairs.sum())
    part_m = torch.full((n,), ragged._NEG)
    part_z = torch.zeros(n)
    part_acc = torch.zeros(n, w.shape[1])
    for p in range(n):
        rows = (pair == p) & valid
        if rows.any():
            part_m[p] = s[rows].max()
            prob = torch.exp(s[rows] - part_m[p])
            part_z[p] = prob.sum()
            part_acc[p] = (prob[:, None] * x[rows]).sum(0)
    batch = pm.n_pairs.numel()
    m = torch.full((batch,), ragged._NEG)
    z = torch.zeros(batch)
    acc = torch.zeros(batch, w.shape[1])
    for b in range(batch):
        lo = int(pm.pair_start[b])
        hi = lo + int(pm.n_pairs[b])
        if hi > lo:
            m[b] = part_m[lo:hi].max()
            scale = torch.exp(part_m[lo:hi] - m[b])
            z[b] = (part_z[lo:hi] * scale).sum()
            acc[b] = (part_acc[lo:hi] * scale[:, None]).sum(0)
    return s, m, z, acc, part_m, part_z


@pytest.mark.parametrize('keep_rate', [1.0, 0.75])
@pytest.mark.parametrize('case', ['tile edges', 'two shards',
                                  'short shards', 'capacity rung, one shard'])
def test_pair_decomposition_equals_plain_stats(case, keep_rate):
    segs = _pair_case(case)
    shards, cap, _ = segs.ctx.shape
    # interior holes, and one pair whose every slot is one: the 65-slot
    # example of 'tile edges' holds slots 128-192, its last alone in tile 3
    ctx = segs.ctx.clone()
    rng = np.random.default_rng(5)
    holes = torch.from_numpy(rng.random((shards, cap)) < 0.05)
    if case == 'tile edges':
        holes[0, 192] = True
    ctx[holes] = 0
    segs = ragged._segment_inputs(ctx, segs.count2.reshape(-1), 0, 0)
    gen = torch.Generator().manual_seed(3)
    tok = torch.rand(50, 16, generator=gen) - 0.5
    path = torch.rand(50, 32, generator=gen) - 0.5
    w = ((torch.rand(64, 128, generator=gen) - 0.5) * 0.4).bfloat16()
    attn = (torch.rand(128, generator=gen) - 0.5).bfloat16()
    keep = (ragged._draw_keep(9, segs, 64, keep_rate) if keep_rate < 1
            else None)
    s, m, z, acc, part_m, part_z = _emulated_stats(tok, path, w, attn, segs,
                                                   keep, keep_rate)
    scores, m_p, z_p, acc_p = ragged._stats_plain(tok, path, w, attn, segs,
                                                  0, 0, keep, keep_rate)
    valid = segs.slot_valid.reshape(-1)
    torch.testing.assert_close(torch.where(valid, s, ragged._NEG),
                               scores.reshape(-1), rtol=1e-5, atol=1e-6)
    for got, want in ((m, m_p), (z, z_p), (acc, acc_p)):
        torch.testing.assert_close(got, want.reshape(got.shape), rtol=1e-5,
                                   atol=1e-6)
    # a pair whose slots are all invalid: m = -1e30, z = 0, not exp(0)
    pm = ragged._pair_map(segs)
    valid = segs.slot_valid.reshape(-1)
    empty = [p for p in range(int(pm.n_pairs.sum()))
             if not bool(valid[pm.pair == p].any())]
    if case == 'tile edges':
        assert empty
    for p in empty:
        assert float(part_m[p]) == float(np.float32(ragged._NEG))
        assert float(part_z[p]) == 0.0


def _fwd_inputs(token_dim, path_dim, code_dim, dtype, table_dtype=None):
    segs = _segments([3, 1, 0, 5], 1, 64)
    k_dim = 2 * token_dim + path_dim
    table_dtype = table_dtype or dtype
    return (torch.zeros(50, token_dim, dtype=table_dtype),
            torch.zeros(50, path_dim, dtype=table_dtype),
            torch.zeros(k_dim, code_dim, dtype=dtype),
            torch.zeros(code_dim, dtype=dtype), segs)


@pytest.mark.parametrize('dtype,table_dtype', [
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize('dims', [(128, 128, 384), (32, 64, 128),
                                  (64, 128, 256), (64, 64, 384),
                                  (128, 128, 128)])
def test_ragged_fwd_check_accepts_the_kernel_shapes(dtype, table_dtype,
                                                    dims):
    args = _fwd_inputs(*dims, dtype, table_dtype)
    assert ragged._check_fwd_args(*args, None) == (
        1, 0 if table_dtype == torch.float32 else 1)


@pytest.mark.parametrize('dims,dtype', [
    ((128, 128, 192), torch.bfloat16),   # D not 128, 256 or 384
    ((128, 256, 384), torch.bfloat16),   # K = 512: above 384
    ((36, 56, 384), torch.bfloat16),     # K = 128, token dim not % 8
    ((32, 32, 384), torch.bfloat16),     # K = 96: not a multiple of 64
    ((30, 68, 128), torch.float32),      # dims not multiples of 4
])
def test_ragged_fwd_check_rejects_shapes(dims, dtype):
    args = _fwd_inputs(*dims, dtype)
    with pytest.raises(ValueError):
        ragged._check_fwd_args(*args, None)


def test_ragged_fwd_check_takes_fp32_shapes_bf16_refuses():
    # fp32 runs on the CUDA cores: code dim 192 and K = 96 pass
    args = _fwd_inputs(32, 32, 192, torch.float32)
    assert ragged._check_fwd_args(*args, None) == (0, 0)


@pytest.mark.parametrize('what', ['W', 'bf16 table', 'keep mask'])
def test_ragged_fwd_check_rejects_misaligned_operands(what):
    tok, path, w, attn, segs = _fwd_inputs(128, 128, 384, torch.bfloat16,
                                           torch.bfloat16)
    keep = None

    def shifted(t):
        flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
        out = flat[1:].view(t.shape)
        assert out.data_ptr() % 16
        return out
    if what == 'W':
        w = shifted(w)
    elif what == 'bf16 table':
        tok = shifted(tok)
    else:
        keep = shifted(torch.ones(1, 64, 384, dtype=torch.bool))
    with pytest.raises(ValueError, match='16-byte'):
        ragged._check_fwd_args(tok, path, w, attn, segs, keep)
