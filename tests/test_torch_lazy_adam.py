"""Lazy (sparse-row) Adam in the port (``code2vec_tpu_torch/ops/
lazy_adam.py``, LAZY_EMBEDDING_ADAM) against the reference, on the CPU:

- ``sparse_row_adam`` against the reference's on the same numpy inputs,
  with duplicate rows and with the PAD rows in the list; rows off the list
  are bit-identical in the table and both moments;
- three ``Trainer`` steps of both packages at keep 1.0 and fp32 on the
  packed wire, from the same weights: the weights, the dense keys' Adam
  moments and the tables' lazy moments;
- ``packed_rows`` appends the PAD rows: a batch whose stream holds no PAD
  slot but an empty example of weight 1 (its code vector is x_pad, whose
  gradient lands on the PAD rows) moves the PAD rows;
- checkpoints: the lazy state round-trips through ``CheckpointStore``
  under the reference's field names (``dense``, ``mu``, ``nu``), a
  resumed run's next step equals the run continued in memory, and a lazy
  checkpoint written by the reference restores in the port and resumes
  one step as the reference's.

Tolerances: ``sparse_row_adam`` at rtol 1e-6 / atol 1e-9 (lr_t's powers
come from numpy here and XLA there); the train steps at rtol 1e-5 / atol
1e-6 for the weights and rtol 1e-5 / atol 1e-9 for the fp32 moments (the
gradients' fp32 sums run in another order) plus, for the moments, 1e-6
of each tensor's largest (a moment can cancel to far below its tensor's
scale); the resumed step bit for bit (the same CPU code on the same
state); the reference's checkpoint restored bit for bit.
"""
import logging

import jax
import numpy as np
import pytest
import torch

from code2vec_tpu.config import Config
from code2vec_tpu.data import packed as jax_packed
from code2vec_tpu.model_api import Code2VecModel
from code2vec_tpu.ops import lazy_adam as jax_lazy
from code2vec_tpu.parallel import mesh as mesh_lib
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.checkpoints import CheckpointStore
from code2vec_tpu_torch.config import Config as PortConfig
from code2vec_tpu_torch.model_api import Code2VecModel as PortModel
from code2vec_tpu_torch.ops import lazy_adam
from code2vec_tpu_torch.training import trainer as trainer_lib
from tests.test_torch_optim_knobs import (jax_trainer, port_trainer,
                                          reference_batch)
from tests.test_train_overfit import make_dataset

LAZY = dict(LAZY_EMBEDDING_ADAM=True, DROPOUT_KEEP_RATE=1.0)
DENSE_KEYS = lazy_adam.LazyEmbeddingAdam.DENSE_KEYS
TABLES = lazy_adam.LazyEmbeddingAdam.SPARSE_KEYS
MOMENT_SCALE_ATOL = 1e-6


def _table_case(rng, rows):
    v, d = 12, 5
    table = rng.normal(size=(v, d)).astype(np.float32)
    mu = (rng.normal(size=(v, d)) * 0.1).astype(np.float32)
    nu = np.abs(rng.normal(size=(v, d)) * 0.01).astype(np.float32)
    grad = rng.normal(size=(v, d)).astype(np.float32)
    grad[[r for r in range(v) if r not in rows]] = 0.0
    return table, mu, nu, grad


@pytest.mark.parametrize('rows', [[3, 7, 3, 0, 7, 7, 11],      # duplicates
                                  [5, 0, 0, 9, 5, 0, 2, 0]],   # + PAD rows
                         ids=['duplicates', 'pad_rows'])
def test_sparse_row_adam_matches_reference(rows):
    rows = np.asarray(rows, np.int32)
    table, mu, nu, grad = _table_case(np.random.default_rng(0), rows)
    want = jax_lazy.sparse_row_adam(
        *(jax.numpy.asarray(a) for a in (table, mu, nu, grad, rows)),
        learning_rate=0.01, step=jax.numpy.asarray(3))
    got = [torch.from_numpy(a.copy()) for a in (table, mu, nu)]
    lazy_adam.sparse_row_adam(*got, torch.from_numpy(grad),
                              torch.from_numpy(rows), learning_rate=0.01,
                              step=3)
    untouched = [r for r in range(table.shape[0]) if r not in rows]
    for name, g, w, start in zip(('table', 'mu', 'nu'), got, want,
                                 (table, mu, nu)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-9, err_msg=name)
        np.testing.assert_array_equal(g.numpy()[untouched],
                                      start[untouched], err_msg=name)


def _assert_lazy_states_match(port_state, jax_state):
    got = convert.params_to_numpy(port_state.params)
    for name, want in jax_state.params._asdict().items():
        np.testing.assert_allclose(got[name], np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    got_opt = convert.opt_state_to_numpy(port_state.opt_state)
    want_opt = jax_state.opt_state
    want_dense = want_opt.dense[0]
    assert got_opt['dense']['count'] == int(want_dense.count)
    pairs = [(got_opt['dense'][f][k], getattr(want_dense, f)[k], f + ' ' + k)
             for f in ('mu', 'nu') for k in DENSE_KEYS]
    pairs += [(got_opt[f][k], getattr(want_opt, f)[k], 'lazy %s %s' % (f, k))
              for f in ('mu', 'nu') for k in TABLES]
    for got_m, want_m, what in pairs:
        want_m = np.asarray(want_m, np.float32)
        assert got_m.dtype == np.float32
        np.testing.assert_allclose(
            got_m, want_m, rtol=1e-5,
            atol=1e-9 + MOMENT_SCALE_ATOL * float(np.abs(want_m).max()),
            err_msg=what)


def test_three_lazy_steps_match_reference():
    reference = jax_trainer(**LAZY)
    state = reference.init_state()
    port, port_state = port_trainer(state, **LAZY)
    assert isinstance(port_state.opt_state, lazy_adam.LazyAdamState)
    start = {name: a.copy() for name, a in
             convert.params_to_numpy(port_state.params).items()}
    rng = np.random.default_rng(21)
    touched = {'token_embedding': set(), 'path_embedding': set()}
    for _step in range(3):
        packed = reference_batch(rng)
        source, path, target = trainer_lib.packed_rows(
            torch.from_numpy(packed.ctx), 0, 0)
        touched['token_embedding'].update(source.tolist() + target.tolist())
        touched['path_embedding'].update(path.tolist())
        state, loss = reference.train_step(state, packed)
        port_state, port_loss = port.train_step(port_state, packed)
        np.testing.assert_allclose(float(port_loss), float(loss), rtol=2e-5)
    assert port_state.step == 3 and port_state.opt_state.dense.count == 3
    _assert_lazy_states_match(port_state, state)
    got = convert.params_to_numpy(port_state.params)
    got_opt = convert.opt_state_to_numpy(port_state.opt_state)
    for name, rows in touched.items():
        off = np.setdiff1d(np.arange(got[name].shape[0]), sorted(rows))
        assert off.size
        np.testing.assert_array_equal(got[name][off], start[name][off])
        assert not got_opt['mu'][name][off].any()
        assert not got_opt['nu'][name][off].any()


def test_packed_rows_append_the_pad_rows():
    ctx = torch.tensor([[[3, 4, 5], [6, 7, 8]]], dtype=torch.int32)
    source, path, target = trainer_lib.packed_rows(ctx, 1, 2)
    assert source.tolist() == [3, 6, 1]
    assert path.tolist() == [4, 7, 2]
    assert target.tolist() == [5, 8]


def test_empty_example_moves_the_pad_rows():
    """No PAD slot in the stream, one empty example of weight 1: its code
    vector is x_pad, so the PAD rows get a gradient, and lazy Adam must
    update them (they are touched only through ``packed_rows``' append)."""
    reference = jax_trainer(**LAZY)
    port, port_state = port_trainer(reference.init_state(), **LAZY)
    rng = np.random.default_rng(4)
    count = np.array([4, 4, 0, 4, 4, 4, 4, 4], np.int32)
    ctx = np.stack([rng.integers(1, 32, 28), rng.integers(1, 16, 28),
                    rng.integers(1, 32, 28)], axis=-1).astype(np.int32)
    arrays = (torch.from_numpy(ctx[None]), torch.from_numpy(count),
              torch.from_numpy(rng.integers(1, 16, 8).astype(np.int32)),
              torch.ones(8))
    pad_before = [port_state.params[i][0].clone() for i in (0, 1)]
    port_state, _loss = port.train_step_placed(port_state, arrays)
    for i, name in enumerate(TABLES):
        assert port_state.opt_state.mu[name][0].abs().sum() > 0, name
        assert not torch.equal(port_state.params[i][0], pad_before[i]), name


def test_lazy_ignores_moment_dtypes_with_a_warning(caplog):
    reference = jax_trainer(**LAZY)
    with caplog.at_level(logging.WARNING,
                         logger='code2vec_tpu_torch.training.trainer'):
        port, port_state = port_trainer(reference.init_state(),
                                        ADAM_MU_DTYPE='bfloat16', **LAZY)
    assert any('ignored' in r.getMessage() for r in caplog.records)
    opt = port_state.opt_state
    assert all(t.dtype == torch.float32 for t in
               opt.dense.mu + opt.dense.nu + tuple(opt.mu.values())
               + tuple(opt.nu.values()))


# ------------------------------------------------------------ checkpoints
SHARED = dict(MAX_CONTEXTS=6, COMPUTE_DTYPE='float32', TRAIN_BATCH_SIZE=16,
              TEST_BATCH_SIZE=16, SHUFFLE_BUFFER_SIZE=64,
              LAZY_EMBEDDING_ADAM=True)


def test_lazy_state_round_trips_and_resumes(tmp_path):
    prefix = make_dataset(tmp_path, n_train=48)
    save = tmp_path / 'p' / 'saved_model'
    model = PortModel(PortConfig(
        TRAIN_DATA_PATH_PREFIX=str(prefix), NUM_TRAIN_EPOCHS=1,
        MODEL_SAVE_PATH=str(save), **SHARED), device='cpu')
    model.train()
    store = CheckpointStore(str(save))
    restored = store.restore_training()
    assert sorted(restored.opt_state) == ['dense', 'mu', 'nu']
    assert sorted(restored.opt_state['mu']) == sorted(TABLES)
    assert sorted(restored.opt_state['dense']['mu']) == sorted(DENSE_KEYS)
    named = lazy_adam.named_state(model.state.opt_state)
    assert restored.opt_state['dense']['count'] == named['dense']['count']
    for field in ('mu', 'nu'):
        for key, tensor in named['dense'][field].items():
            assert torch.equal(restored.opt_state['dense'][field][key],
                               tensor)
        for key, tensor in named[field].items():
            assert torch.equal(restored.opt_state[field][key], tensor)

    resumed = PortModel(PortConfig(
        TRAIN_DATA_PATH_PREFIX=str(prefix), MODEL_LOAD_PATH=str(save),
        NUM_TRAIN_EPOCHS=2, **SHARED), device='cpu')
    assert resumed._start_epoch == 1
    assert resumed.state.step == model.state.step
    lines = (tmp_path / 'tiny.train.c2v').read_text().splitlines()
    packed = jax_packed.pack_batch(
        model.reader.tokenize_lines(lines[:16]),
        model.backend.token_pad_index, model.backend.path_pad_index)
    continued, loss_a = model.trainer.train_step(model.state, packed)
    again, loss_b = resumed.trainer.train_step(resumed.state, packed)
    assert torch.equal(loss_a, loss_b)
    a = convert.opt_state_to_numpy(continued.opt_state)
    b = convert.opt_state_to_numpy(again.opt_state)
    for x, y in zip(continued.params, again.params):
        assert torch.equal(x, y)
    for field in ('mu', 'nu'):
        for key in TABLES:
            np.testing.assert_array_equal(a[field][key], b[field][key])
        for key in DENSE_KEYS:
            np.testing.assert_array_equal(a['dense'][field][key],
                                          b['dense'][field][key])


def test_reference_lazy_checkpoint_resumes_in_port(tmp_path):
    """The reference trains one lazy epoch and saves (orbax); the port
    restores it (tensorstore) and takes the reference's next step."""
    prefix = make_dataset(tmp_path, n_train=48)
    save = tmp_path / 'models' / 'saved_model'
    jax_only = dict(DL_FRAMEWORK='jax', VERBOSE_MODE=0,
                    READER_USE_NATIVE=False)
    Code2VecModel(Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                         NUM_TRAIN_EPOCHS=1, MODEL_SAVE_PATH=str(save),
                         **SHARED, **jax_only)).train()
    common = dict(TRAIN_DATA_PATH_PREFIX=str(prefix),
                  MODEL_LOAD_PATH=str(save), NUM_TRAIN_EPOCHS=2,
                  DROPOUT_KEEP_RATE=1.0, **SHARED)
    jax_model = Code2VecModel(Config(**common, **jax_only))
    port = PortModel(PortConfig(**common), device='cpu')
    assert port._start_epoch == jax_model._start_epoch == 1
    assert port.state.step == int(jax_model.state.step)
    jax_state = jax_model.state
    got_opt = convert.opt_state_to_numpy(port.state.opt_state)
    assert got_opt['dense']['count'] == int(jax_state.opt_state.dense[0].count)
    for field in ('mu', 'nu'):
        for key in TABLES:
            np.testing.assert_array_equal(
                got_opt[field][key],
                np.asarray(getattr(jax_state.opt_state, field)[key]))
        for key in DENSE_KEYS:
            np.testing.assert_array_equal(
                got_opt['dense'][field][key],
                np.asarray(getattr(jax_state.opt_state.dense[0], field)[key]))
    lines = (tmp_path / 'tiny.train.c2v').read_text().splitlines()
    packed = jax_packed.pack_batch(
        port.reader.tokenize_lines(lines[:16]), port.backend.token_pad_index,
        port.backend.path_pad_index,
        data_shards=jax_model.mesh.shape[mesh_lib.DATA_AXIS],
        capacity_minimum=4)
    new_state, loss = jax_model.trainer.train_step(jax_state, packed)
    port_state, port_loss = port.trainer.train_step(port.state, packed)
    np.testing.assert_allclose(float(port_loss), float(loss), rtol=2e-5)
    _assert_lazy_states_match(port_state, new_state)
