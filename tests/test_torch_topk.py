"""The port's top-k (code2vec_tpu_torch/ops/topk.py) against the
reference's ``jax.lax.top_k`` on the CPU, on the same logits: values and
indices equal, ties broken by the lower index, +0.0 above -0.0.

Logits are drawn with numpy from a seed and rounded to bf16 before the
cast to fp32, as both packages round them, so the top ten of a row over
the java14m target vocabulary hold ties in most rows."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu_torch.ops.topk import top_k

JAVA14M_WIDTH = 261248       # 261,245 targets padded to a multiple of 64


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()


def _java14m_rows(rng):
    # code . target rows at java14m width: ~N(0, 1) before the rounding
    return _bf16(rng.normal(0.0, 1.0, (24, JAVA14M_WIDTH)))


def _padded(rng):
    # 40 valid targets of a 96-column table, the rest at the reference's
    # -1e9: k = 64 reaches into the padding, whose ties go by index
    x = _bf16(rng.normal(0.0, 1.0, (6, 96)))
    x[:, 40:] = -1e9
    return x


def _many_ties(rng):
    # five distinct values over 300 columns
    return rng.integers(-2, 3, (16, 300)).astype(np.float32)


def _signed_zeros(rng):
    # only +0.0, -0.0 and a few +-1: IEEE total order puts +0.0 first
    x = rng.choice(np.array([0.0, -0.0, 0.0, -0.0, 1.0, -1.0],
                            np.float32), (16, 40))
    return x.astype(np.float32)


def _batched(rng):
    # leading axes beyond the batch
    return _bf16(rng.normal(0.0, 1.0, (2, 3, 500)))


CASES = {
    'java14m width': (_java14m_rows, 10),
    'k above the valid vocabulary': (_padded, 64),
    'many exact ties': (_many_ties, 10),
    'signed zeros': (_signed_zeros, 30),
    'leading axes': (_batched, 10),
    'k above the width': (_many_ties, 400),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_top_k_matches_lax_top_k(case):
    make, k = CASES[case]
    logits = make(np.random.default_rng(7))
    got_values, got_indices = top_k(torch.from_numpy(logits), k)
    want_values, want_indices = jax.lax.top_k(
        jnp.asarray(logits), min(k, logits.shape[-1]))
    want_values = np.asarray(want_values)
    np.testing.assert_array_equal(got_indices.numpy(),
                                  np.asarray(want_indices))
    np.testing.assert_array_equal(got_values.numpy(), want_values)
    # the signs of zeros too (assert_array_equal takes -0.0 == +0.0)
    np.testing.assert_array_equal(np.signbit(got_values.numpy()),
                                  np.signbit(want_values))
    assert got_indices.dtype == torch.int64
    # the case holds ties inside the top k: equal neighbours
    assert (want_values[..., 1:] == want_values[..., :-1]).any()


def test_top_k_matches_a_numpy_lowest_index_rule():
    """The rule in plain numpy (a stable sort on the negated value), the
    reference the card's check uses where there is no JAX."""
    logits = _java14m_rows(np.random.default_rng(3))[:8]
    got = top_k(torch.from_numpy(logits), 10)[1].numpy()
    want = np.argsort(-logits, axis=-1, kind='stable')[:, :10]
    np.testing.assert_array_equal(got, want)
