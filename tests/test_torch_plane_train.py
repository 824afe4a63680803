"""The port's plane-wire training (``functional.loss_and_aux``,
``Trainer.train_step`` on the plane wire and on the packed wire with the
ragged fusion off, and ``Code2VecModel.train()`` on both) against the
reference on the CPU, same weights and batches (carried across by
code2vec_tpu_torch/convert.py):

- the loss and every gradient against ``code2vec_tpu.models.functional.
  loss_and_aux`` (autograd of each package), with materialized logits and
  with the streamed CE (the reference interpreted), per EMBED_GRAD_IMPL
  and under REMAT_ENCODE: fp32 at keep 1.0, fp32 at keep 0.75 with the
  reference's keep mask fed in, and bf16;
- three Trainer steps on each route against the reference trainer's
  steps, with dense Adam (fp32 moments) and with lazy Adam, and one under
  GRADS_DTYPE='bfloat16';
- ``train()`` on both routes: the loss falls over the tiny corpus, and a
  saved model resumes at the next epoch on the same route.

Tolerances: fp32 at the reference's ``assert_encode_close`` (rtol 2e-5 /
atol 1e-6); bf16 each gradient within 2^-6 of its own scale (the largest
magnitude of the reference's), the loss at rtol 2^-7: bf16 keeps 8
significant bits and each product and the tanh round once; parameters
after Adam steps at rtol 1e-5 / atol 1e-6 (a step moves each weight by
about the learning rate), the first moment at the gradients' tolerance
x (1 - b1)."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.data import packed as jax_packed
from code2vec_tpu.models import functional as jax_functional
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.config import Config as PortConfig
from code2vec_tpu_torch.model_api import Code2VecModel as PortModel
from code2vec_tpu_torch.models import functional
from code2vec_tpu_torch.models.backends import TorchBackend
from code2vec_tpu_torch.models.functional import Code2VecParams
from code2vec_tpu_torch.training.trainer import Trainer
from tests.test_packed import random_plane_batch
from tests.test_train_overfit import make_dataset

RTOL, ATOL = 2e-5, 1e-6
BF16_SCALE = 2.0 ** -6
NUM_VALID = 10
SIZES = dict(token=32, path=16, target=16, dt=8, dp=8, d=24)


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    context_dim = 2 * SIZES['dt'] + SIZES['dp']
    shapes = dict(token_embedding=(SIZES['token'], SIZES['dt']),
                  path_embedding=(SIZES['path'], SIZES['dp']),
                  target_embedding=(SIZES['target'], SIZES['d']),
                  transform=(context_dim, SIZES['d']),
                  attention=(SIZES['d'], 1))
    return {name: (rng.normal(size=shape) * 0.4).astype(np.float32)
            for name, shape in shapes.items()}


def _batch(seed=8):
    batch = random_plane_batch(np.random.default_rng(seed), 8, 4,
                               pad_row_rate=0.25)
    return batch._replace(label=(batch.label % NUM_VALID).astype(np.int32))


def _reference_loss(weights, batch, dtype, keep, rng, fused_ce,
                    embed_grad_impl):
    params = jax_functional.Code2VecParams(
        **{k: jnp.asarray(v) for k, v in weights.items()})
    arrays = [jnp.asarray(a) for a in batch.device_arrays()]

    def loss_fn(p):
        return jax_functional.loss_and_aux(
            p, *arrays, dropout_rng=rng, dropout_keep_rate=keep,
            dtype=dtype, num_valid_targets=NUM_VALID,
            embed_grad_impl=embed_grad_impl, use_fused_ce=fused_ce)[0]

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), {k: np.asarray(v, np.float32)
                         for k, v in grads._asdict().items()}


def _port_loss(weights, batch, dtype, keep, keep_mask, fused_ce,
               embed_grad_impl, remat):
    params = Code2VecParams(*[
        torch.from_numpy(weights[name].copy()).requires_grad_()
        for name in Code2VecParams._fields])
    arrays = [torch.from_numpy(a) for a in batch.device_arrays()]
    loss, _aux = functional.loss_and_aux(
        params, *arrays, dtype=dtype, keep_rate=keep, keep_mask=keep_mask,
        num_valid_targets=NUM_VALID, use_fused_ce=fused_ce,
        embed_grad_impl=embed_grad_impl, remat_encode=remat)
    loss.backward()
    return float(loss), {name: getattr(params, name).grad.float().numpy()
                         for name in Code2VecParams._fields}


def _assert_grads(got, want, bf16):
    for name in Code2VecParams._fields:
        if bf16:
            scale = float(np.abs(want[name]).max())
            err = float(np.abs(got[name] - want[name]).max())
            assert err <= BF16_SCALE * scale, (name, err, scale)
        else:
            np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                       atol=ATOL, err_msg=name)


@pytest.mark.parametrize('fused_ce', [False, True])
@pytest.mark.parametrize('dtype, keep', [('float32', 1.0),
                                         ('float32', 0.75),
                                         ('bfloat16', 1.0),
                                         ('bfloat16', 0.75)])
def test_loss_and_grads_match_reference(dtype, keep, fused_ce):
    weights = _weights()
    batch = _batch()
    rng = jax.random.PRNGKey(5)
    context_dim = 2 * SIZES['dt'] + SIZES['dp']
    jax_keep = jax_functional.dropout_keep_mask(
        rng, keep, batch.source.shape + (context_dim,), 'threefry2x32')
    keep_mask = (torch.from_numpy(np.array(jax_keep)) if keep < 1
                 else None)
    want_loss, want = _reference_loss(
        weights, batch, jnp.dtype(dtype), keep, rng, fused_ce, 'dense')
    got_loss, got = _port_loss(weights, batch, getattr(torch, dtype), keep,
                               keep_mask, fused_ce, 'dense', False)
    bf16 = dtype == 'bfloat16'
    np.testing.assert_allclose(got_loss, want_loss,
                               rtol=2.0 ** -7 if bf16 else RTOL)
    _assert_grads(got, want, bf16)


@pytest.mark.parametrize('impl', ['sorted', 'dedup'])
@pytest.mark.parametrize('remat', [False, True])
def test_embed_grad_impls_and_remat_match_reference(impl, remat):
    """Every table-gradient strategy, and the recompute, keep the
    reference's gradients (fp32, keep 0.75 with its mask)."""
    weights = _weights(1)
    batch = _batch(9)
    rng = jax.random.PRNGKey(6)
    context_dim = 2 * SIZES['dt'] + SIZES['dp']
    keep_mask = torch.from_numpy(np.array(jax_functional.dropout_keep_mask(
        rng, 0.75, batch.source.shape + (context_dim,), 'threefry2x32')))
    want_loss, want = _reference_loss(weights, batch, jnp.float32, 0.75,
                                      rng, False, impl)
    got_loss, got = _port_loss(weights, batch, torch.float32, 0.75,
                               keep_mask, False, impl, remat)
    np.testing.assert_allclose(got_loss, want_loss, rtol=RTOL)
    _assert_grads(got, want, False)


def test_seeded_dropout_replays_under_remat():
    """The port's own seeded mask: the same seed gives the same loss and
    gradients with and without the recompute, another seed another
    loss."""
    weights = _weights(2)
    arrays = [torch.from_numpy(a) for a in _batch(10).device_arrays()]

    def run(seed, remat):
        params = Code2VecParams(*[
            torch.from_numpy(weights[name].copy()).requires_grad_()
            for name in Code2VecParams._fields])
        loss, _ = functional.loss_and_aux(
            params, *arrays, keep_rate=0.75, dropout_seed=seed,
            num_valid_targets=NUM_VALID, remat_encode=remat)
        loss.backward()
        return float(loss), [p.grad.clone() for p in params]

    loss_a, grads_a = run(3, False)
    loss_b, grads_b = run(3, True)
    assert loss_a == loss_b
    for a, b in zip(grads_a, grads_b):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert run(4, False)[0] != loss_a


def _vocab(size):
    return SimpleNamespace(size=size, pad_index=0)


def _reference_trainer(**knobs):
    """tests/test_stage_batches.py's reference trainer, in ``knobs``'
    compute dtype."""
    from code2vec_tpu.config import Config
    from code2vec_tpu.models.backends import create_backend
    from code2vec_tpu.training.trainer import Trainer as JaxTrainer
    from code2vec_tpu.vocab import SizeOnlyVocabs
    knobs = dict(dict(COMPUTE_DTYPE='float32'), **knobs)
    config = Config(
        TRAIN_DATA_PATH_PREFIX='unused', DL_FRAMEWORK='jax',
        VERBOSE_MODE=0, READER_USE_NATIVE=False, MAX_CONTEXTS=4,
        TRAIN_BATCH_SIZE=8, TEST_BATCH_SIZE=8, MAX_TOKEN_VOCAB_SIZE=32,
        MAX_PATH_VOCAB_SIZE=16, MAX_TARGET_VOCAB_SIZE=16,
        TOKEN_EMBEDDINGS_SIZE=8, PATH_EMBEDDINGS_SIZE=8,
        CODE_VECTOR_SIZE=24, TARGET_EMBEDDINGS_SIZE=24,
        DROPOUT_KEEP_RATE=1.0, **knobs)
    return JaxTrainer(config, create_backend(config,
                                             SizeOnlyVocabs(32, 16, 16)))


def _port_trainer(**knobs):
    knobs = dict(dict(COMPUTE_DTYPE='float32'), **knobs)
    config = PortConfig(
        TRAIN_DATA_PATH_PREFIX='unused', MAX_CONTEXTS=4,
        TOKEN_EMBEDDINGS_SIZE=8, PATH_EMBEDDINGS_SIZE=8,
        CODE_VECTOR_SIZE=24, DROPOUT_KEEP_RATE=1.0, **knobs)
    vocabs = SimpleNamespace(token_vocab=_vocab(32), path_vocab=_vocab(16),
                             target_vocab=_vocab(16))
    return Trainer(config, TorchBackend(config, vocabs, torch.device('cpu')))


# (the port's knobs, the reference's, the wire each is fed)
ROUTES = {'planes': (dict(BATCH_WIRE_FORMAT='planes'), 'planes'),
          'unpack': (dict(USE_PALLAS_RAGGED_FUSION=False), 'packed')}
OPTIMIZERS = {
    'adam': dict(ADAM_MU_DTYPE='float32', ADAM_NU_DTYPE='float32'),
    'lazy': dict(LAZY_EMBEDDING_ADAM=True),
    'adam_bf16_moments': {},
}


@pytest.mark.parametrize('optimizer', sorted(OPTIMIZERS))
@pytest.mark.parametrize('route', sorted(ROUTES))
def test_train_steps_match_reference(route, optimizer):
    """Three steps of each route against the reference trainer's, fp32 at
    keep 1.0: losses, parameters and (fp32) moments."""
    knobs, wire = ROUTES[route]
    knobs = dict(knobs, **OPTIMIZERS[optimizer])
    jax_trainer = _reference_trainer(**knobs)
    state = jax_trainer.init_state()
    weights = {k: np.asarray(v, np.float32)
               for k, v in state.params._asdict().items()}
    trainer = _port_trainer(**knobs)
    port_state = trainer.state_from_params(
        convert.params_from_numpy(weights))
    for seed in (8, 9, 10):
        batch = _batch(seed)
        if wire == 'packed':
            # one shard per device of the reference's 8-device CPU mesh
            batch = jax_packed.pack_batch(batch, 0, 0, data_shards=8,
                                          capacity_minimum=4)
        state, loss = jax_trainer.train_step(state, batch)
        port_state, port_loss = trainer.train_step(port_state, batch)
        np.testing.assert_allclose(float(port_loss), float(loss),
                                   rtol=RTOL)
    assert port_state.step == 3
    got = convert.params_to_numpy(port_state.params)
    for name in Code2VecParams._fields:
        np.testing.assert_allclose(got[name],
                                   np.asarray(getattr(state.params, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    if optimizer == 'adam':
        got_opt = convert.opt_state_to_numpy(port_state.opt_state)
        want_opt = state.opt_state[0]
        for name in Code2VecParams._fields:
            # mu sums (1 - b1) x the gradients: their tolerance x 0.1
            np.testing.assert_allclose(
                got_opt['mu'][name],
                np.asarray(getattr(want_opt.mu, name)), rtol=RTOL,
                atol=0.1 * ATOL, err_msg='mu ' + name)


@pytest.mark.parametrize('route', sorted(ROUTES))
def test_grads_bf16_step_matches_reference(route):
    """GRADS_DTYPE='bfloat16' on the dense routes: one step against the
    reference's (bf16 compute, bf16 gradients)."""
    knobs, wire = ROUTES[route]
    knobs = dict(knobs, COMPUTE_DTYPE='bfloat16', GRADS_DTYPE='bfloat16')
    jax_trainer = _reference_trainer(**knobs)
    state = jax_trainer.init_state()
    weights = {k: np.asarray(v, np.float32)
               for k, v in state.params._asdict().items()}
    trainer = _port_trainer(**knobs)
    port_state = trainer.state_from_params(
        convert.params_from_numpy(weights))
    batch = _batch(11)
    if wire == 'packed':
        batch = jax_packed.pack_batch(batch, 0, 0, data_shards=8,
                                      capacity_minimum=4)
    state, loss = jax_trainer.train_step(state, batch)
    port_state, port_loss = trainer.train_step(port_state, batch)
    np.testing.assert_allclose(float(port_loss), float(loss),
                               rtol=2.0 ** -7)
    # from zero moments the first step leaves mu = (1 - b1) g: the bf16
    # gradients handed to Adam, each within 2^-6 of its leaf's scale
    got_mu = convert.opt_state_to_numpy(port_state.opt_state)['mu']
    want_mu = state.opt_state[0].mu
    for name in Code2VecParams._fields:
        want = np.asarray(getattr(want_mu, name), np.float32)
        scale = float(np.abs(want).max())
        err = float(np.abs(got_mu[name].astype(np.float32) - want).max())
        assert scale > 0 and err <= BF16_SCALE * scale, (name, err, scale)


@pytest.mark.parametrize('route', sorted(ROUTES))
def test_model_train_on_dense_routes_learns_and_resumes(tmp_path, route):
    prefix = make_dataset(tmp_path)
    save = tmp_path / 'models' / 'saved_model'
    shared = dict(TRAIN_DATA_PATH_PREFIX=str(prefix), MAX_CONTEXTS=6,
                  TRAIN_BATCH_SIZE=16, COMPUTE_DTYPE='float32',
                  LEARNING_RATE=0.01, **ROUTES[route][0])
    model = PortModel(PortConfig(NUM_TRAIN_EPOCHS=6,
                                 MODEL_SAVE_PATH=str(save), **shared),
                      device='cpu')
    losses = model.train()
    assert len(losses) == 6 and losses[-1] < losses[0] * 0.8, losses
    resumed = PortModel(PortConfig(NUM_TRAIN_EPOCHS=7,
                                   MODEL_LOAD_PATH=str(save), **shared),
                        device='cpu')
    assert resumed._start_epoch == 6
    assert resumed.state.step == model.state.step
    assert len(resumed.train()) == 1
    assert resumed.state.step > model.state.step
