"""The port's streamed cross-entropy (code2vec_tpu_torch/ops/ce.py, the
plain versions on the CPU) against the reference's
``pallas_ce.fused_weighted_ce_sums(..., interpret=True)`` on the same
numpy-seeded code vectors and target table: the (CE sum, weight sum)
values and the gradients of the table and the code vectors. The table
spans three of the reference's 1024-column vocab blocks, with
``num_valid`` short of its rows and labels inside the masked range.

Tolerances: fp32 values at rtol 2e-5 / atol 1e-6, fp32 gradients at
rtol 1e-4 / atol 1e-6. bf16: both packages round code, table and
dlogits to bf16 at the same places and accumulate in fp32, so values
hold at rtol 2e-5 and gradients at rtol 1e-4 plus one bf16 rounding of
the gradient itself (the reference returns them in the compute dtype):
atol 2^-8 * max |gradient|, with the table's label rows and its other
rows each taken on their own scale."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.ops import pallas_ce
from code2vec_tpu_torch.ops import ce

BATCH, DIM, VOCAB, NUM_VALID = 12, 16, 2500, 2300


def inputs(seed=3):
    rng = np.random.default_rng(seed)
    code = rng.normal(size=(BATCH, DIM)).astype(np.float32)
    table = (0.3 * rng.normal(size=(VOCAB, DIM))).astype(np.float32)
    label = rng.integers(0, NUM_VALID, BATCH).astype(np.int32)
    label[:2] = [NUM_VALID + 5, VOCAB - 1]          # masked columns
    weight = (rng.random(BATCH) > 0.2).astype(np.float32)
    weight[:2] = 0.0
    return code, table, label, weight


def port_sums_and_grads(code, table, label, weight, dtype):
    table_t = torch.from_numpy(table).requires_grad_()
    code_t = torch.from_numpy(code).requires_grad_()
    ce_sum, weight_sum = ce.fused_weighted_ce_sums(
        table_t, code_t, torch.from_numpy(label), torch.from_numpy(weight),
        NUM_VALID, dtype=dtype)
    ce_sum.backward()
    return (float(ce_sum.detach()), float(weight_sum), table_t.grad.numpy(),
            code_t.grad.numpy())


def jax_sums_and_grads(code, table, label, weight, dtype):
    def loss(table_, code_):
        return pallas_ce.fused_weighted_ce_sums(
            table_, code_, jnp.asarray(label), jnp.asarray(weight),
            NUM_VALID, dtype=dtype, interpret=True)

    table_j, code_j = jnp.asarray(table), jnp.asarray(code)
    ce_sum, weight_sum = loss(table_j, code_j)
    d_table, d_code = jax.grad(lambda t, c: loss(t, c)[0],
                               argnums=(0, 1))(table_j, code_j)
    return (float(ce_sum), float(weight_sum), np.asarray(d_table),
            np.asarray(d_code))


@pytest.mark.parametrize('dtypes', [(torch.float32, jnp.float32),
                                    (torch.bfloat16, jnp.bfloat16)],
                         ids=['fp32', 'bf16'])
def test_matches_reference_kernel(dtypes):
    port_dtype, jax_dtype = dtypes
    args = inputs()
    got = port_sums_and_grads(*args, port_dtype)
    want = jax_sums_and_grads(*args, jax_dtype)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=1e-6)
    assert got[1] == want[1]
    # the table's label rows carry the one-hot term and sit far above its
    # other rows (softmax term only): each part is held on its own scale
    is_label = np.zeros(VOCAB, bool)
    is_label[args[2][args[3] > 0]] = True
    parts = {'d_table label rows': (got[2][is_label], want[2][is_label]),
             'd_table other rows': (got[2][~is_label], want[2][~is_label]),
             'd_code': (got[3], want[3])}
    for name, (g, w) in parts.items():
        assert np.isfinite(g).all()
        atol = 1e-6 if port_dtype == torch.float32 else \
            2.0 ** -8 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol, err_msg=name)
    # masked rows of the table get no gradient
    assert not got[2][NUM_VALID:].any()


def test_lse_and_pick_match_materialized_logits():
    """The plain forward against logsumexp and a gather over the masked
    logits; a label in the masked range picks 0."""
    code, table, label, _weight = inputs(seed=7)
    lse, picked = ce.fused_lse_and_pick(
        torch.from_numpy(code), torch.from_numpy(table),
        torch.from_numpy(label), NUM_VALID)
    logits = code.astype(np.float64) @ table[:NUM_VALID].T.astype(np.float64)
    top = logits.max(axis=1)
    want_lse = top + np.log(np.exp(logits - top[:, None]).sum(axis=1))
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=2e-5, atol=1e-5)
    want_picked = np.where(label < NUM_VALID,
                           logits[np.arange(BATCH),
                                  np.minimum(label, NUM_VALID - 1)], 0.0)
    np.testing.assert_allclose(picked.numpy(), want_picked, rtol=2e-5,
                               atol=1e-5)
    assert picked[0] == 0 and picked[1] == 0


def test_pad_vocab_and_wrappers_count_no_launch_on_cpu():
    assert ce._pad_vocab(torch.zeros(2048, 4)).shape == (2048, 4)
    padded = ce._pad_vocab(torch.ones(1500, 4))
    assert padded.shape == (2048, 4) and not padded[1500:].any()
    before = (ce.fwd_launches, ce.bwd_launches)
    port_sums_and_grads(*inputs(seed=11), torch.float32)
    assert (ce.fwd_launches, ce.bwd_launches) == before
