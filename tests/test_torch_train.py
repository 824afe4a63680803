"""The port's training slice against the reference on the CPU, same
weights and batches (carried across by code2vec_tpu_torch/convert.py):

- one ``Trainer.train_step`` at keep 1.0 against the reference's packed
  train step (``USE_PALLAS_RAGGED_FUSION``): loss, updated parameters and
  the bf16-stored Adam moments, with materialized logits and with the
  streamed CE (``USE_PALLAS_FUSED_CE``, the reference interpreted);
- ``adam_dtypes.update_`` against the reference's transform over a few
  steps, fp32 and bf16 moment storage;
- ``Code2VecModel.train()`` overfits the tiny corpus of
  tests/test_train_overfit.py and serves the trained weights;
- the target table's rows under USE_PALLAS_FUSED_CE (aligned to the
  fused-CE vocab tile, as the reference aligns them).

Tolerances: the loss at rtol 2e-5; parameters at rtol 1e-5 / atol 1e-6
after a step of lr 1e-3 (Adam's first step moves each weight by about
lr); fp32 moments at rtol 1e-5 / atol 1e-9; bf16-stored moments within
one bf16 rounding of the reference's (rtol 2^-7: an fp32 difference at
a rounding boundary can move the stored value by one bf16 step)."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.data import packed as jax_packed
from code2vec_tpu.training import adam_dtypes as jax_adam
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.config import Config as PortConfig
from code2vec_tpu_torch.model_api import Code2VecModel as PortModel
from code2vec_tpu_torch.models.backends import TorchBackend
from code2vec_tpu_torch.models.functional import Code2VecParams
from code2vec_tpu_torch.training import adam_dtypes
from code2vec_tpu_torch.training.trainer import Trainer
from tests.test_packed import random_plane_batch
from tests.test_stage_batches import make_trainer
from tests.test_train_overfit import make_dataset

BF16_STEP = dict(rtol=2.0 ** -7, atol=1e-12)


def _vocab(size):
    return SimpleNamespace(size=size, pad_index=0)


def port_backend(config, params=None):
    vocabs = SimpleNamespace(token_vocab=_vocab(32), path_vocab=_vocab(16),
                             target_vocab=_vocab(16))
    return TorchBackend(config, vocabs, torch.device('cpu'), params=params)


def to_numpy(tree):
    return {k: np.asarray(v, dtype=np.float32)
            for k, v in tree._asdict().items()}


@pytest.mark.parametrize('fused_ce', [False, True])
def test_train_step_matches_reference(fused_ce):
    jax_trainer = make_trainer(DROPOUT_KEEP_RATE=1.0,
                               USE_PALLAS_FUSED_CE=fused_ce)
    state = jax_trainer.init_state()
    weights = to_numpy(state.params)
    batch = random_plane_batch(np.random.default_rng(8), 8, 4,
                               pad_row_rate=0.25)
    batch = batch._replace(label=(batch.label % 16).astype(np.int32))
    # one shard per device of the reference's 8-device CPU mesh
    packed = jax_packed.pack_batch(batch, 0, 0, data_shards=8,
                                   capacity_minimum=4)
    new_state, loss = jax_trainer.train_step(state, packed)
    want_params = to_numpy(new_state.params)
    want_opt = new_state.opt_state[0]

    config = PortConfig(
        TRAIN_DATA_PATH_PREFIX='unused', MAX_CONTEXTS=4,
        TOKEN_EMBEDDINGS_SIZE=8, PATH_EMBEDDINGS_SIZE=8,
        CODE_VECTOR_SIZE=24, COMPUTE_DTYPE='float32', DROPOUT_KEEP_RATE=1.0,
        USE_PALLAS_FUSED_CE=fused_ce)
    trainer = Trainer(config, port_backend(config))
    port_state = trainer.state_from_params(convert.params_from_numpy(weights))
    port_state, port_loss = trainer.train_step(port_state, packed)
    assert port_state.step == 1 and port_state.opt_state.count == 1
    np.testing.assert_allclose(float(port_loss), float(loss), rtol=2e-5)
    got_params = convert.params_to_numpy(port_state.params)
    got_opt = convert.opt_state_to_numpy(port_state.opt_state)
    assert port_state.opt_state.mu[0].dtype == torch.bfloat16
    for name in Code2VecParams._fields:
        np.testing.assert_allclose(got_params[name], want_params[name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got_opt['mu'][name],
                                   np.asarray(getattr(want_opt.mu, name),
                                              np.float32),
                                   err_msg='mu ' + name, **BF16_STEP)
        np.testing.assert_allclose(got_opt['nu'][name],
                                   np.asarray(getattr(want_opt.nu, name),
                                              np.float32),
                                   err_msg='nu ' + name, **BF16_STEP)


@pytest.mark.parametrize('storage', [None, 'bfloat16'])
def test_adam_matches_reference_transform(storage):
    rng = np.random.default_rng(3)
    shapes = [(16, 4), (6,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jax_dtype = jnp.bfloat16 if storage else None
    torch_dtype = torch.bfloat16 if storage else None
    tx = jax_adam.adam(1e-2, mu_dtype=jax_dtype, nu_dtype=jax_dtype)
    jax_params = [jnp.asarray(p) for p in params]
    jax_state = tx.init(jax_params)
    port_params = [torch.from_numpy(p.copy()) for p in params]
    port_state = adam_dtypes.init(port_params, torch_dtype, torch_dtype)
    tol = BF16_STEP if storage else dict(rtol=1e-5, atol=1e-9)
    for _step in range(4):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        updates, jax_state = tx.update([jnp.asarray(g) for g in grads],
                                       jax_state, jax_params)
        jax_params = [p + u for p, u in zip(jax_params, updates)]
        port_state = adam_dtypes.update_(
            port_params, [torch.from_numpy(g) for g in grads], port_state,
            1e-2)
        for got, want in zip(port_params, jax_params):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
        adam_state = jax_state[0]
        assert port_state.count == int(adam_state.count)
        for field in ('mu', 'nu'):
            for got, want in zip(getattr(port_state, field),
                                 getattr(adam_state, field)):
                assert got.dtype == (torch_dtype or torch.float32)
                np.testing.assert_allclose(got.float().numpy(),
                                           np.asarray(want, np.float32),
                                           err_msg=field, **tol)


def test_opt_state_round_trip():
    params = [torch.ones(3, 2), torch.ones(4)] * 2 + [torch.ones(2, 1)]
    state = adam_dtypes.init(params, torch.bfloat16, None)
    state = adam_dtypes.update_(params, [0.5 * p for p in params], state,
                                1e-3)
    arrays = convert.opt_state_to_numpy(state)
    back = convert.opt_state_from_numpy(arrays, 'cpu', torch.bfloat16, None)
    assert back.count == 1
    for a, b in zip(state.mu + state.nu, back.mu + back.nu):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_model_train_overfits_tiny_corpus(tmp_path):
    prefix = make_dataset(tmp_path)
    config = PortConfig(
        TRAIN_DATA_PATH_PREFIX=str(prefix), MAX_CONTEXTS=6,
        TRAIN_BATCH_SIZE=16, NUM_TRAIN_EPOCHS=20, SHUFFLE_BUFFER_SIZE=64,
        COMPUTE_DTYPE='float32', LEARNING_RATE=0.01,
        SERVING_BATCH_BUCKETS='64')
    model = PortModel(config, device='cpu', seed=1)
    losses = model.train()
    assert len(losses) == 20 and model.state.step == 20 * 4
    assert losses[-1] < 0.2 * losses[0], losses
    lines = (tmp_path / 'tiny.train.c2v').read_text().splitlines()
    results = model.predict(lines)
    hits = sum(r.topk_predicted_words[0] == r.original_name
               for r in results)
    assert hits >= 0.9 * len(lines), hits


@pytest.mark.parametrize('fused_ce', [False, True])
def test_target_rows_match_reference_under_fused_ce(fused_ce):
    """java14m's 261,245 targets: 261,248 rows at the 128-row alignment,
    262,144 (the 1024-column vocab tile) under USE_PALLAS_FUSED_CE, in
    both packages."""
    from code2vec_tpu.config import Config
    from code2vec_tpu.models.backends import JaxBackend
    from code2vec_tpu.vocab import SizeOnlyVocabs
    dims = dict(TOKEN_EMBEDDINGS_SIZE=4, PATH_EMBEDDINGS_SIZE=4,
                CODE_VECTOR_SIZE=8, USE_PALLAS_FUSED_CE=fused_ce)
    reference = JaxBackend(Config(TRAIN_DATA_PATH_PREFIX='unused',
                                  DL_FRAMEWORK='jax', TARGET_EMBEDDINGS_SIZE=8,
                                  **dims),
                           SizeOnlyVocabs(40, 30, 261245))
    vocabs = SimpleNamespace(token_vocab=_vocab(40), path_vocab=_vocab(30),
                             target_vocab=_vocab(261245))
    port = TorchBackend(PortConfig(TRAIN_DATA_PATH_PREFIX='unused', **dims),
                        vocabs, torch.device('cpu'))
    assert port.sizes == reference.sizes
    rows = port.params.target_embedding.shape[0]
    assert rows == (262144 if fused_ce else 261248)
