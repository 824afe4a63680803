"""The port's table-gradient strategies (``code2vec_tpu_torch/ops/
embed_grad.py``, EMBED_GRAD_IMPL) against the reference's, on the CPU:

- ``table_grad`` for 'dense', 'sorted' and 'dedup' against the
  reference's ``table_grad`` with the same impl on the same numpy inputs:
  heavy duplication, all indices equal, all unique, a single row;
- one packed train step for each impl against the reference's step with
  the same impl (keep 1.0, fp32; weights carried by convert.py);
- 'dedup' is sync-free: the scatter writes each row once (no duplicate
  index reaches ``index_add_``).

Tolerances: ``table_grad`` in fp32 at rtol 1e-5 / atol 1e-6 (the sums run
in another order: 'dedup' sums a run in fp64, the reference in fp32 by a
log-depth scan; 'dense' and 'sorted' add in index order on both sides);
the train step as tests/test_torch_train.py holds it (loss rtol 2e-5,
parameters rtol 1e-5 / atol 1e-6, bf16-stored moments within one bf16
rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.ops import embed_grad as jax_embed_grad
from code2vec_tpu_torch.ops import embed_grad
from tests.test_torch_optim_knobs import (assert_step_matches, jax_trainer,
                                          port_trainer, reference_batch)

IMPLS = ('dense', 'sorted', 'dedup')


def _case(name, rng):
    d = 8
    if name == 'duplicates':
        idx = rng.integers(0, 50, (6, 17))
    elif name == 'all_same':
        idx = np.full((31,), 7)
    elif name == 'all_unique':
        idx = rng.permutation(50)[:40]
    else:                                  # one cotangent row
        idx = np.array([13])
    g = rng.normal(size=idx.shape + (d,)).astype(np.float32)
    return g, idx.astype(np.int32), 50


@pytest.mark.parametrize('impl', IMPLS)
@pytest.mark.parametrize('case', ['duplicates', 'all_same', 'all_unique',
                                  'single_row'])
def test_table_grad_matches_reference(impl, case):
    g, idx, rows = _case(case, np.random.default_rng(len(case)))
    want = np.asarray(jax_embed_grad.table_grad(
        jnp.asarray(g), jnp.asarray(idx), rows, jnp.float32, impl))
    got = embed_grad.table_grad(torch.from_numpy(g), torch.from_numpy(idx),
                                rows, torch.float32, impl)
    assert got.shape == (rows, g.shape[-1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    untouched = np.setdiff1d(np.arange(rows), idx)
    assert not got.numpy()[untouched].any()


def test_dedup_writes_each_row_once(monkeypatch):
    """The scatter that 'dedup' sends to ``index_add_`` has no repeated
    index: non-final rows of a run go to scratch rows past the table."""
    seen = []
    original = torch.Tensor.index_add_

    def spy(self, dim, index, source, **kwargs):
        seen.append(index.clone())
        return original(self, dim, index, source, **kwargs)
    monkeypatch.setattr(torch.Tensor, 'index_add_', spy)
    g, idx, rows = _case('duplicates', np.random.default_rng(0))
    embed_grad.table_grad(torch.from_numpy(g), torch.from_numpy(idx), rows,
                          torch.float32, 'dedup')
    (index,) = seen
    assert index.unique().numel() == index.numel() == idx.size


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match='embed grad impl'):
        embed_grad.table_grad(torch.zeros(2, 4), torch.zeros(2, dtype=torch.int32),
                              4, torch.float32, 'scatter')


@pytest.mark.parametrize('impl', IMPLS)
def test_train_step_matches_reference_per_impl(impl):
    knobs = dict(EMBED_GRAD_IMPL=impl, DROPOUT_KEEP_RATE=1.0)
    reference = jax_trainer(**knobs)
    state = reference.init_state()
    packed = reference_batch(np.random.default_rng(8))
    port, port_state = port_trainer(state, **knobs)
    new_state, loss = reference.train_step(state, packed)
    port_state, port_loss = port.train_step(port_state, packed)
    assert_step_matches(port_state, port_loss, new_state, loss)
