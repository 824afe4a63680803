"""The fp32 ragged forward as its Hopper kernel computes it, on the CPU:
x = e W in three TF32 terms (``ops/ragged.py::_stats_tf32x3``, over
``ops/ce.py::_mm_tf32x3``) against float64 beside the fp32 product's own
error, and against the JAX package (the reference's ``_stats_jnp`` at
``Precision.HIGHEST`` and its Pallas kernel interpreted) on the same
numpy-seeded inputs, with examples on the edges of the 64-slot tiles; the
fp32 route's scratch (the bf16 route's pair-map bound); W as the fp32
kernel reads it; and lazy Adam's touched-row mask (the row kernel's mark
step) against ``torch.unique``. Nothing here needs a card: on the card
``chip_smoke.py`` holds the kernel itself against float64 and its plain
version."""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.ops import pallas_ragged
from code2vec_tpu_torch.ops import lazy_adam, ragged

CODE_DIM = 384          # java14m code width
TOKEN_DIM, PATH_DIM = 64, 128
CONTEXT_DIM = 2 * TOKEN_DIM + PATH_DIM
# examples on the edges of the 64-slot tiles (1, 63, 64 and 65 slots), two
# empty ones, one across four tiles, then a partial last tile
EDGE_COUNTS = [1, 63, 64, 65, 0, 0, 200, 28]
STATS = ('scores', 'm', 'z', 'acc')


def uniform(rng, shape, limit) -> np.ndarray:
    return rng.uniform(-limit, limit, shape).astype(np.float32)


def encoder(rng, token_rows: int = 300, path_rows: int = 200):
    """Tables U(+-sqrt(3 / dim)), W and attention glorot-uniform, as the
    model initialises them (models/functional.py::init_params)."""
    return (uniform(rng, (token_rows, TOKEN_DIM), math.sqrt(3 / TOKEN_DIM)),
            uniform(rng, (path_rows, PATH_DIM), math.sqrt(3 / PATH_DIM)),
            uniform(rng, (CONTEXT_DIM, CODE_DIM),
                    math.sqrt(6 / (CONTEXT_DIM + CODE_DIM))),
            uniform(rng, (CODE_DIM,), math.sqrt(6 / (CODE_DIM + 1))))


def packed_segments(rng, counts, cap: int, token_rows: int, path_rows: int):
    """One shard of a packed stream (PAD 0): examples of ``counts`` slots,
    then PAD slots to ``cap``, an interior all-PAD hole in the longest."""
    ctx = np.empty((1, cap, 3), np.int32)
    ctx[..., 0] = rng.integers(1, token_rows, cap)
    ctx[..., 1] = rng.integers(1, path_rows, cap)
    ctx[..., 2] = rng.integers(1, token_rows, cap)
    total = int(sum(counts))
    ctx[0, total:] = 0
    longest = int(np.argmax(counts))
    ctx[0, int(sum(counts[:longest])) + 1] = 0
    return ragged._segment_inputs(torch.from_numpy(ctx),
                                  torch.tensor(counts, dtype=torch.int32),
                                  0, 0)


def edge_case(seed: int, keep_rate: float = 1.0):
    rng = np.random.default_rng(seed)
    arrays = encoder(rng)
    tok, path, w, attn = (torch.from_numpy(a) for a in arrays)
    segs = packed_segments(rng, EDGE_COUNTS, 64 * 8 + 37, tok.shape[0],
                           path.shape[0])
    keep = (ragged._draw_keep(seed, segs, CONTEXT_DIM, keep_rate)
            if keep_rate < 1.0 else None)
    return (tok, path, w, attn, segs, 0, 0, keep, keep_rate)


def stats_float64(tok, path, w, attn, segs, _tpad, _ppad, keep, keep_rate):
    """The statistics in float64 from the fp32 rows the kernel gathers."""
    e = ragged._gather(tok, path, segs, torch.float32, keep,
                       keep_rate).double()
    x = torch.tanh(e @ w.double())
    scores = torch.where(segs.slot_valid, x @ attn.double(), ragged._NEG)
    seg = segs.seg.reshape(-1)
    n_seg = segs.count2.numel()
    m = torch.full((n_seg,), ragged._NEG, dtype=torch.float64).scatter_reduce(
        0, seg, scores.reshape(-1), reduce='amax')
    p = torch.where(segs.slot_valid.reshape(-1),
                    torch.exp(scores.reshape(-1) - m[seg]), 0.0)
    z = torch.zeros(n_seg, dtype=torch.float64).index_add(0, seg, p)
    acc = torch.zeros((n_seg, x.shape[-1]), dtype=torch.float64).index_add(
        0, seg, p[:, None] * x.reshape(-1, x.shape[-1]))
    return scores, m.reshape(1, -1), z.reshape(1, -1), acc.reshape(
        1, n_seg, -1)


def kept(name: str, t: torch.Tensor, segs) -> torch.Tensor:
    """The entries of a statistic that carry a value: valid slots' scores,
    non-empty examples' m, z and acc."""
    if name == 'scores':
        return t[segs.slot_valid]
    return t[segs.count2 > 0]


def scaled_error(got, want) -> float:
    got = torch.as_tensor(np.asarray(got)).double()
    want = torch.as_tensor(np.asarray(want)).double()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize('keep_rate', [1.0, 0.75])
def test_three_term_stats_are_within_4x_of_fp32(keep_rate):
    args = edge_case(0, keep_rate)
    segs = args[4]
    want = stats_float64(*args)
    plain = ragged._stats_plain(*args)
    emulated = ragged._stats_tf32x3(*args)
    for name, p, e, v in zip(STATS, plain, emulated, want):
        assert p.shape == e.shape == v.shape and e.dtype == torch.float32
        fp32_err = scaled_error(kept(name, p, segs), kept(name, v, segs))
        tf32x3_err = scaled_error(kept(name, e, segs), kept(name, v, segs))
        assert fp32_err > 0.0, name
        assert tf32x3_err <= 4.0 * fp32_err, (name, tf32x3_err, fp32_err)
    # one TF32 term (hi . hi, the product with TF32 on) misses by far more
    one_term = ragged._stats_plain(
        *args, matmul=lambda a, b: ragged_tf32(a) @ ragged_tf32(b))
    assert scaled_error(kept('acc', one_term[3], segs),
                        kept('acc', want[3], segs)) > 4.0 * scaled_error(
        kept('acc', plain[3], segs), kept('acc', want[3], segs))


def ragged_tf32(t: torch.Tensor) -> torch.Tensor:
    from code2vec_tpu_torch.ops import ce
    return ce._tf32_rna(t)


def reference_stats(route: str, args):
    """The JAX package's statistics on the same rows: the jnp twin or the
    interpreted Pallas kernel, at Precision.HIGHEST (fp32)."""
    tok, path, w, attn, segs, _tp, _pp, keep, keep_rate = args
    e = ragged._gather(tok, path, segs, torch.float32, keep,
                       keep_rate).numpy()
    cuts = (TOKEN_DIM, TOKEN_DIM + PATH_DIM)
    src_e, pth_e, tgt_e = np.split(e, cuts, axis=-1)
    w_src, w_path, w_tgt = np.split(w.numpy(), cuts, axis=0)
    seg = segs.seg.numpy().astype(np.int32)
    valid = segs.slot_valid.numpy()
    attn_vec = attn.numpy()[:, None]
    per_shard = segs.count2.shape[1]
    highest = jax.lax.Precision.HIGHEST
    if route == 'jnp':
        out = pallas_ragged._stats_jnp(
            *(jnp.asarray(a) for a in (src_e, pth_e, tgt_e, seg, valid,
                                       w_src, w_path, w_tgt, attn_vec)),
            per_shard, highest)
        return [np.asarray(a) for a in out]
    out = pallas_ragged._stats_pallas(
        *(jnp.asarray(a) for a in (src_e[0], pth_e[0], tgt_e[0], seg[0],
                                   valid[0], w_src, w_path, w_tgt,
                                   attn_vec)),
        per_shard, True, highest)
    return [np.asarray(a)[None] for a in out]


@pytest.mark.parametrize('route', ['jnp', 'interpreted kernel'])
def test_emulated_fp32_stats_match_the_jax_reference(route):
    # the JAX side sums exact fp32 products on the CPU; three TF32 terms sit
    # ~1e-6 of the scale from them: the port's fp32 tolerance (rtol 1e-4,
    # atol 1e-6) holds on every statistic
    args = edge_case(1, 0.75)
    segs = args[4]
    got = ragged._stats_tf32x3(*args)
    want = reference_stats(route, args)
    f64 = stats_float64(*args)
    plain = ragged._stats_plain(*args)
    for name, g, v, w64, p in zip(STATS, got, want, f64, plain):
        assert g.shape == v.shape, (name, g.shape, v.shape)
        np.testing.assert_allclose(g.numpy(), v, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
        # and within 4x of the plain fp32 version's distance to float64
        assert scaled_error(kept(name, g, segs), kept(name, w64, segs)) <= \
            4.0 * scaled_error(kept(name, p, segs), kept(name, w64, segs)), \
            name


def _segments(counts, shards: int, cap: int):
    ctx = np.ones((shards, cap, 3), np.int32)
    return ragged._segment_inputs(torch.from_numpy(ctx),
                                  torch.tensor(counts, dtype=torch.int32),
                                  0, 0)


@pytest.mark.parametrize('counts,shards,cap', [
    ([1, 63, 64, 65, 0, 0, 200, 28], 1, 64 * 8 + 37),   # tile edges
    ([3, 0, 5, 7], 2, 64),                               # past a shard's total
    ([0, 0], 1, 5),                                      # no slot at all
    ([200] * 1024, 1, 204800),                           # java14m's cap
])
def test_fp32_route_scratch_uses_the_pair_map_bound(counts, shards, cap):
    # both routes allocate the partials from one plan: batch + n_tiles
    segs = _segments(counts, shards, cap)
    per_shard = len(counts) // shards
    plan = ragged._fwd_plan(shards, per_shard, cap, CODE_DIM)
    bound = ragged._pair_map(segs).bound
    assert plan['bound'] == bound == len(counts) + -(-shards * cap // 64)
    assert plan['scratch']['part_acc'] == (bound, CODE_DIM)
    assert plan['scratch']['part_m'] == plan['scratch']['part_z'] == (bound,)
    assert plan['scratch']['pair'] == (shards * cap,)
    pairs = ragged._pair_map(segs)
    assert int(pairs.n_pairs.sum()) <= bound


@pytest.mark.parametrize('code_dim,offset,ldw', [
    (384, 0, 384),      # read as it is: no copy
    (100, 0, 100),
    (102, 0, 104),      # rows padded to a multiple of 4
    (384, 1, 384),      # off a 16-byte boundary: copied
])
def test_f32_transform_is_read_in_16_byte_rows(code_dim, offset, ldw):
    flat = torch.arange(CONTEXT_DIM * code_dim + offset, dtype=torch.float32)
    w = flat[offset:].view(CONTEXT_DIM, code_dim)
    got, got_ldw = ragged._f32_transform(w)
    assert got_ldw == ldw and got.shape == (CONTEXT_DIM, ldw)
    assert got.data_ptr() % 16 == 0
    assert (got.data_ptr() == w.data_ptr()) == (offset == 0
                                                and ldw == code_dim)
    assert torch.equal(got[:, :code_dim], w)
    assert not got[:, code_dim:].any()


@pytest.mark.parametrize('rows', [
    [3, 7, 3, 0, 7, 7, 11],              # repeats
    [5, -1, 0, 0, 9, 12, -1, 40, 2],     # -1 and rows past the table
    [-1, -1],                            # nothing inside
    [],
])
def test_touched_mask_matches_unique(rows):
    n_rows = 12
    rows = torch.tensor(rows, dtype=torch.int64)
    mask = lazy_adam.touched_mask(rows, n_rows)
    assert mask.dtype == torch.bool and mask.shape == (n_rows,)
    inside = rows[(rows >= 0) & (rows < n_rows)]
    assert torch.equal(torch.nonzero(mask).reshape(-1), torch.unique(inside))


def test_sparse_row_adam_takes_the_mask_as_the_list():
    # a mesh hands the row update its mask: the same bits as the list
    rng = np.random.default_rng(2)
    start = [torch.from_numpy(rng.normal(size=(12, 5)).astype(np.float32))
             for _ in range(3)]
    start[2] = start[2].abs()
    grad = torch.from_numpy(rng.normal(size=(12, 5)).astype(np.float32))
    rows = torch.tensor([3, 7, 3, 0, 7, 7, 11])
    by_list = [t.clone() for t in start]
    by_mask = [t.clone() for t in start]
    lazy_adam.sparse_row_adam(*by_list, grad, rows, learning_rate=0.01,
                              step=3)
    lazy_adam.sparse_row_adam(*by_mask, grad,
                              lazy_adam.touched_mask(rows, 12),
                              learning_rate=0.01, step=3)
    for a, b, s in zip(by_list, by_mask, start):
        assert torch.equal(a, b)
        assert torch.equal(a[[1, 2, 4, 5, 6, 8, 9, 10]],
                           s[[1, 2, 4, 5, 6, 8, 9, 10]])
