"""The fp32 CE kernels' arithmetic, on the CPU: every product in three TF32
terms (``ops/ce.py::_mm_tf32x3``, the plain emulation of ``csrc/ce.cu``'s
split), its rounding (``cvt.rna.tf32.f32``: to nearest, ties away from
zero), and its accuracy against float64 beside the fp32 product's own, at
the java14m code width. Nothing here needs a card: on the card
``chip_smoke.py`` holds the kernels themselves against float64."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from code2vec_tpu_torch.ops import ce

DIM = 384          # java14m code width
ROWS = 4096        # table rows of the slice
BATCH = 512
NUM_VALID = 4000


def tf32_reference(x: float) -> float:
    """x rounded to 10 explicit mantissa bits, to nearest, ties away from
    zero (float64 arithmetic, independent of the bit trick under test)."""
    if x == 0.0:
        return x
    m, e = math.frexp(abs(x))           # abs(x) = m 2^e, m in [0.5, 1)
    scaled = m * 2.0 ** 11              # 11 significant bits
    low = math.floor(scaled)
    up = low + 1 if scaled - low >= 0.5 else low
    return math.copysign(math.ldexp(up / 2.0 ** 11, e), x)


def test_tf32_rounding_is_to_nearest_ties_away():
    one_ulp = 2.0 ** -10                # TF32 spacing in [1, 2)
    values = [0.0, -0.0, 1.0, -1.0, 1.0 + one_ulp,
              1.0 + one_ulp / 2,        # a tie: away from zero
              -(1.0 + one_ulp / 2),
              1.0 + 3 * one_ulp / 2,    # a tie above an odd value
              1.0 + one_ulp / 2 - 2.0 ** -23,   # just under the tie
              1.0 + one_ulp / 2 + 2.0 ** -23,   # just over it
              2.0 - 2.0 ** -23,         # rounds up into the next binade
              3.14159265, -2.718281828, 1e-30, -7.5e20]   # normal values
    rng = np.random.default_rng(0)
    values += list(rng.normal(0.0, 1.0, 200).astype(np.float32))
    x = torch.tensor(values, dtype=torch.float32)
    got = ce._tf32_rna(x)
    want = torch.tensor([tf32_reference(float(v)) for v in x],
                        dtype=torch.float32)
    assert torch.equal(got.view(torch.int32) & 0x1FFF,
                       torch.zeros_like(x, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # the sign of zero survives
    assert math.copysign(1.0, float(got[1])) == -1.0


def test_split_recovers_the_value():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0.0, 3.0, 10000).astype(np.float32))
    hi, lo = ce._split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    # lo keeps the next 11 bits: hi + lo is x within 2^-22 of |x|
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    assert bool((lo.abs() <= 2.0 ** -11 * x.abs()).all())


def slice_inputs(seed: int = 0):
    """A seeded slice of the training CE at java14m width: code vectors,
    a 4,096-row target table drawn as the model draws it, and dlogits
    formed in float64 from the float64 logits (loss cotangents: dlse =
    1/B, dpicked = -1/B), then rounded to fp32 as the kernels hold them."""
    rng = np.random.default_rng(seed)
    code = rng.normal(0.0, 0.3, (BATCH, DIM)).astype(np.float32)
    limit = math.sqrt(3.0 / DIM)
    table = rng.uniform(-limit, limit, (ROWS, DIM)).astype(np.float32)
    label = rng.integers(0, NUM_VALID, BATCH)
    logits = code.astype(np.float64) @ table.astype(np.float64).T
    logits[:, NUM_VALID:] = -np.inf
    top = logits.max(axis=1, keepdims=True)
    softmax = np.exp(logits - top)
    softmax /= softmax.sum(axis=1, keepdims=True)
    dl = softmax / BATCH
    dl[np.arange(BATCH), label] -= 1.0 / BATCH
    return code, table, dl.astype(np.float32)


def scaled_error(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.abs(got.double().numpy() - want).max()
                 / np.abs(want).max())


PRODUCTS = {
    # name: (a, b) of the product as the kernels form it
    'logits': lambda code, table, dl: (code, table.T),      # K = D
    'dW': lambda code, table, dl: (dl.T, code),             # K = batch
    'dcode': lambda code, table, dl: (dl, table),           # K = vocab
}


@pytest.mark.parametrize('product', sorted(PRODUCTS))
def test_three_term_product_is_within_4x_of_fp32(product):
    a, b = PRODUCTS[product](*slice_inputs())
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    want = a.astype(np.float64) @ b.astype(np.float64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    fp32_err = scaled_error(ta @ tb, want)
    tf32x3_err = scaled_error(ce._mm_tf32x3(ta, tb), want)
    assert fp32_err > 0.0
    assert tf32x3_err <= 4.0 * fp32_err, (product, tf32x3_err, fp32_err)
    # one TF32 term (hi . hi, the product with TF32 on) misses by far more
    hi_err = scaled_error(ce._tf32_rna(ta) @ ce._tf32_rna(tb), want)
    assert hi_err > 4.0 * fp32_err, (product, hi_err, fp32_err)
