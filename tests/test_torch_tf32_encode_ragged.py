"""The fp32 encode and the fp32 ragged backward as their Hopper kernels
compute them, on the CPU: every product in three TF32 terms
(``ops/ce.py::_mm_tf32x3``; the encode's ``_transform_tf32x3``, the
backward's ``_grads_tf32x3``), against float64 beside the fp32 products'
own error, and against the JAX package (the interpreted encode kernel, the
reference's ``_grads_jnp`` at ``Precision.HIGHEST``) on the same
numpy-seeded inputs; the fp32 encode's alignment rule; the fp32 route's
backward plan. Nothing here needs a card: on the card ``chip_smoke.py``
holds the kernels themselves against float64 and their plain versions."""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.ops import pallas_encode, pallas_ragged
from code2vec_tpu_torch.ops import ce, encode, ragged

CODE_DIM = 384          # java14m code width
TOKEN_DIM, PATH_DIM = 64, 128
CONTEXT_DIM = 2 * TOKEN_DIM + PATH_DIM
H100_SMS = 132


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


def scaled_error(got, want: np.ndarray) -> float:
    got = np.asarray(got.double() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def rows(rng, n: int):
    tok, path, w, attn = encoder(rng)
    src = tok[rng.integers(0, tok.shape[0], n)]
    pth = path[rng.integers(0, path.shape[0], n)]
    tgt = tok[rng.integers(0, tok.shape[0], n)]
    return src, pth, tgt, w, attn


# ------------------------------------------------------------ the encode
def test_encode_three_term_product_is_within_4x_of_fp32():
    src, pth, tgt, w, attn = rows(np.random.default_rng(0), 2048)
    e64 = np.concatenate([src, pth, tgt], axis=1).astype(np.float64)
    want = e64 @ w.astype(np.float64)
    t = [torch.from_numpy(a) for a in (src, pth, tgt, w)]
    cuts = (0, TOKEN_DIM, TOKEN_DIM + PATH_DIM, CONTEXT_DIM)
    parts = [(t[i], t[3][cuts[i]:cuts[i + 1]]) for i in range(3)]
    fp32 = sum(a @ b for a, b in parts)
    tf32x3 = sum(ce._mm_tf32x3(a, b) for a, b in parts)
    fp32_err, tf32x3_err = scaled_error(fp32, want), scaled_error(tf32x3,
                                                                  want)
    assert fp32_err > 0.0
    assert tf32x3_err <= 4.0 * fp32_err, (tf32x3_err, fp32_err)
    # one TF32 term (hi . hi, the product with TF32 on) misses by far more
    hi = sum(ce._tf32_rna(a) @ ce._tf32_rna(b) for a, b in parts)
    assert scaled_error(hi, want) > 4.0 * fp32_err


def test_encode_emulation_is_within_4x_of_fp32_on_x_and_scores():
    src, pth, tgt, w, attn = rows(np.random.default_rng(1), 2048)
    x64 = np.tanh(np.concatenate([src, pth, tgt], axis=1).astype(np.float64)
                  @ w.astype(np.float64))
    want = (x64, x64 @ attn.astype(np.float64)[:, None])
    args = [torch.from_numpy(a) for a in (src, pth, tgt, w, attn)]
    plain = encode._transform_plain(*args)
    emulated = encode._transform_tf32x3(*args)
    for name, p, e, v in zip(('x', 'scores'), plain, emulated, want):
        assert p.shape == e.shape == v.shape and e.dtype == torch.float32
        fp32_err, tf32x3_err = scaled_error(p, v), scaled_error(e, v)
        assert tf32x3_err <= 4.0 * fp32_err, (name, tf32x3_err, fp32_err)


@pytest.mark.parametrize('n', [1, 127, 1000])
def test_encode_emulation_matches_the_interpreted_kernel(n):
    # the JAX kernel sums exact fp32 products on the CPU; three TF32 terms
    # sit ~1e-6 of the scale from them: the port's fp32 encode limit
    # (chip_smoke.ENCODE_LIMIT, 1e-4 of each output's scale) holds
    src, pth, tgt, w, attn = rows(np.random.default_rng(2 + n), n)
    want = pallas_encode.fused_context_transform(
        *(jnp.asarray(a) for a in (src, pth, tgt, w, attn[:, None])),
        interpret=True)
    got = encode._transform_tf32x3(
        *(torch.from_numpy(a) for a in (src, pth, tgt, w, attn)))
    for g, v in zip(got, want):
        v = np.asarray(v)
        assert g.shape == v.shape
        assert scaled_error(g, v.astype(np.float64)) <= 1e-4


def _fp32_encode_inputs(n: int = 10):
    return tuple(torch.zeros(shape) for shape in (
        (n, TOKEN_DIM), (n, PATH_DIM), (n, TOKEN_DIM),
        (CONTEXT_DIM, CODE_DIM), (CODE_DIM, 1)))


@pytest.mark.parametrize('which', [0, 1, 2])
@pytest.mark.parametrize('offset', [1, 2, 3])
def test_encode_check_rejects_a_misaligned_fp32_row_input(which, offset):
    # the fp32 kernel stages the rows by 16-byte cp.async: a base 4, 8 or
    # 12 bytes off a 16-byte boundary is refused before any launch
    args = list(_fp32_encode_inputs())
    assert encode._check_kernel_args(*args) == 0
    src = args[which]
    shifted = torch.zeros(src.numel() + offset)[offset:].view(src.shape)
    assert shifted.data_ptr() % 16 == 4 * offset
    args[which] = shifted
    with pytest.raises(ValueError, match='16-byte'):
        encode._check_kernel_args(*args)


def test_encode_check_takes_a_misaligned_fp32_transform():
    # fp32 reads W^T, a fresh copy the wrapper makes: W itself may start
    # anywhere
    src, pth, tgt, w, attn = _fp32_encode_inputs()
    shifted = torch.zeros(w.numel() + 1)[1:].view(w.shape)
    assert shifted.data_ptr() % 16
    assert encode._check_kernel_args(src, pth, tgt, shifted, attn) == 0


# ---------------------------------------------------- the ragged backward
def one_example_backward(rng, n: int = 256):
    """e, W and du of one example of n slots, du formed in float64 from
    the softmax backward (w = softmax(s), ds = w (x.g - sum w x.g), du =
    (1 - x^2)(w g + ds a)) and rounded to fp32 as the kernel holds it."""
    tok, path, w, attn = encoder(rng)
    e = np.concatenate([tok[rng.integers(0, tok.shape[0], n)],
                        path[rng.integers(0, path.shape[0], n)],
                        tok[rng.integers(0, tok.shape[0], n)]], axis=1)
    x = np.tanh(e.astype(np.float64) @ w.astype(np.float64))
    s = x @ attn.astype(np.float64)
    p = np.exp(s - s.max())
    p /= p.sum()
    g = rng.normal(0.0, 1.0, CODE_DIM)
    gd = x @ g
    ds = p * (gd - p @ gd)
    du = (1.0 - x * x) * (p[:, None] * g + ds[:, None] * attn)
    return e, w, du.astype(np.float32)


BWD_PRODUCTS = {
    # name: (a, b) of the product as the kernel forms it
    'x = e W': lambda e, w, du: (e, w),                 # K = context dim
    'de = du W^T': lambda e, w, du: (du, w.T),          # K = code dim
    'dW = e^T du': lambda e, w, du: (e.T, du),          # K = slots
}


@pytest.mark.parametrize('product', sorted(BWD_PRODUCTS))
def test_ragged_bwd_three_term_products_are_within_4x_of_fp32(product):
    a, b = BWD_PRODUCTS[product](*one_example_backward(
        np.random.default_rng(3)))
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    want = a.astype(np.float64) @ b.astype(np.float64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    fp32_err = scaled_error(ta @ tb, want)
    tf32x3_err = scaled_error(ce._mm_tf32x3(ta, tb), want)
    assert fp32_err > 0.0
    assert tf32x3_err <= 4.0 * fp32_err, (product, tf32x3_err, fp32_err)
    hi_err = scaled_error(ce._tf32_rna(ta) @ ce._tf32_rna(tb), want)
    assert hi_err > 4.0 * fp32_err, (product, hi_err, fp32_err)


def packed_segments(rng, counts, cap: int, token_rows: int, path_rows: int,
                    tpad: int = 0, ppad: int = 0):
    """One shard of a packed stream: examples of ``counts`` slots, then
    PAD slots to ``cap``, an interior all-PAD hole in the longest one."""
    ctx = np.empty((1, cap, 3), np.int32)
    ctx[..., 0] = rng.integers(1, token_rows, cap)
    ctx[..., 1] = rng.integers(1, path_rows, cap)
    ctx[..., 2] = rng.integers(1, token_rows, cap)
    total = int(sum(counts))
    ctx[0, total:] = (tpad, ppad, tpad)
    longest = int(np.argmax(counts))
    hole = int(sum(counts[:longest])) + 1
    ctx[0, hole] = (tpad, ppad, tpad)
    return ragged._segment_inputs(torch.from_numpy(ctx),
                                  torch.tensor(counts, dtype=torch.int32),
                                  tpad, ppad)


def test_emulated_fp32_backward_matches_the_jax_reference():
    # examples on the edges of the 64-slot tiles (1, 63, 64, 65 slots), two
    # empty ones, a long one, a partial last tile; keep rate 1.0
    rng = np.random.default_rng(4)
    tok, path, w, attn = encoder(rng)
    counts = [1, 63, 64, 65, 0, 0, 200, 28]
    segs = packed_segments(rng, counts, 64 * 8 + 37, tok.shape[0],
                           path.shape[0])
    t_tok, t_path, t_w, t_attn = (torch.from_numpy(a)
                                  for a in (tok, path, w, attn))
    _s, m, z, acc = ragged._stats_plain(t_tok, t_path, t_w, t_attn, segs, 0,
                                        0)
    code = acc / torch.where(z > 0, z, 1.0)[..., None]
    g2 = torch.from_numpy(rng.normal(0.0, 1.0, code.shape).astype(
        np.float32))
    gc = (g2 * code).sum(dim=-1)
    got = ragged._grads_tf32x3(t_tok, t_path, t_w, t_attn, segs, m, z, gc,
                               g2)
    e = ragged._gather(t_tok, t_path, segs, torch.float32, None,
                       1.0).numpy()
    cuts = (TOKEN_DIM, TOKEN_DIM + PATH_DIM)
    src_e, pth_e, tgt_e = np.split(e, cuts, axis=-1)
    w_src, w_path, w_tgt = np.split(w, cuts, axis=0)
    want = pallas_ragged._grads_jnp(
        *(jnp.asarray(a) for a in (
            src_e, pth_e, tgt_e, segs.seg.numpy().astype(np.int32),
            segs.slot_valid.numpy(), w_src, w_path, w_tgt, attn[:, None],
            m.numpy(), z.numpy(), gc.numpy(), g2.numpy())),
        jax.lax.Precision.HIGHEST)
    want = (np.concatenate([np.asarray(a) for a in want[:3]], axis=-1),
            np.concatenate([np.asarray(a) for a in want[3:6]], axis=0),
            np.asarray(want[6])[:, 0])
    # the port's fp32 gradient tolerance (tests/test_torch_ragged_grad.py,
    # rtol 1e-4, atol 1e-6): the JAX side sums exact fp32 products on the
    # CPU, three TF32 terms sit ~1e-6 of the scale from them
    for name, g, v in zip(('de', 'dW', 'd_attn'), got, want):
        assert g.shape == v.shape, (name, g.shape, v.shape)
        np.testing.assert_allclose(g.numpy(), v, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    # and the emulation stays within 4x of the plain fp32 version's own
    # distance to the JAX reference on each output's scale (or 1e-6)
    plain = ragged._grads_plain(t_tok, t_path, t_w, t_attn, segs, m, z, gc,
                                g2)
    for name, g, p, v in zip(('de', 'dW', 'd_attn'), got, plain, want):
        v = v.astype(np.float64)
        assert scaled_error(g, v) <= max(4.0 * scaled_error(p, v), 1e-6), \
            name


@pytest.mark.parametrize('n_slots,k_dim,d_code', [
    (38879, 384, 384),       # the java14m training stream, a partial tile
    (64, 384, 384),          # one tile
    (65, 128, 256),          # one slot past a tile
    (1, 256, 128),
    (300000, 128, 128),
])
def test_fp32_plan_has_one_d_attn_partial_a_tile(n_slots, k_dim, d_code):
    plan = ragged._bwd_plan(n_slots, k_dim, d_code, H100_SMS, torch.float32)
    assert plan['n_parts'] == plan['n_tiles'] == -(-n_slots // 64)
    # dW: 128 x 128 output tiles a slot range, at most a wave of CTAs
    assert plan['per_split'] == (k_dim // 128) * (d_code // 128)
    assert plan['dw_units'] <= max(H100_SMS, plan['per_split'])
    assert plan['scratch']['part_dattn'] == (plan['n_tiles'], d_code)
