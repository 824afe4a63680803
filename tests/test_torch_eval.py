"""The port's plane-wire forward and its evaluation against the reference,
fp32 on the CPU with the same weights (carried across by
code2vec_tpu_torch/convert.py):

- ``predict_step`` on the plane wire and on the packed wire with the
  ragged fusion off (unpack, then the dense encode), every tier, against
  the reference ``Trainer.predict_step`` configured the same way;
- the eval step of either new route against the reference
  ``Trainer.eval_step``;
- ``Code2VecModel.evaluate()`` against the reference's over the tiny
  corpus of tests/test_train_overfit.py on all three routes (packed +
  ragged, planes + fused encode, packed unpacked + fused encode), with the
  code-vector export; metrics equal, loss close;
- ``train()`` and ``train_step`` on the plane wire and on the packed
  wire without the ragged fusion, and ``train()`` evaluates after each
  epoch when TEST_DATA_PATH is set.

The reference takes its fused-encode kernel route only on a TPU; here its
TPU predicate and kernel (interpreted) are pointed at that route, so both
packages run the kernel's arithmetic. Every test runs with the working
directory in ``tmp_path``: ``evaluate()`` writes ``log.txt`` there.

Tolerance: the reference's ``assert_encode_close`` (rtol 2e-5, atol
1e-6); top-k indices and the metrics must be identical.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from code2vec_tpu.data import packed as jax_packed
from code2vec_tpu.ops import pallas_encode
from code2vec_tpu_torch.config import Config as PortConfig
from code2vec_tpu_torch.data import packed as port_packed
from code2vec_tpu_torch.model_api import Code2VecModel as PortModel
from code2vec_tpu_torch.models.backends import TorchBackend
from code2vec_tpu_torch.serving.steps import PREDICT_TIERS, predict_step
from code2vec_tpu_torch.training.trainer import Trainer
from tests.test_stage_batches import make_trainer
from tests.test_torch_model import _tier_batch, to_port
from tests.test_train_overfit import make_dataset

RTOL, ATOL = 2e-5, 1e-6

# (BATCH_WIRE_FORMAT, USE_PALLAS_RAGGED_FUSION, USE_PALLAS_FUSED_ENCODE)
ROUTES = {'packed_ragged': ('packed', True, False),
          'planes_encode': ('planes', True, True),
          'packed_unpack_encode': ('packed', False, True)}
NEW_ROUTES = ('planes_encode', 'packed_unpack_encode')


def _route_knobs(route):
    wire, ragged, fused = ROUTES[route]
    return dict(BATCH_WIRE_FORMAT=wire, USE_PALLAS_RAGGED_FUSION=ragged,
                USE_PALLAS_FUSED_ENCODE=fused)


@pytest.fixture(autouse=True)
def reference_kernel_route(monkeypatch, tmp_path):
    """The reference's fused-encode kernel route on the CPU (interpreted),
    and the working directory in tmp_path."""
    monkeypatch.setattr(pallas_encode, 'tpu_backend_active', lambda: True)
    monkeypatch.setattr(pallas_encode, 'fused_context_transform',
                        functools.partial(
                            pallas_encode.fused_context_transform,
                            interpret=True))
    monkeypatch.chdir(tmp_path)


def _vocab(size):
    return SimpleNamespace(size=size, pad_index=0)


def _step_pair(route):
    """The reference trainer of tests/test_stage_batches.py configured for
    ``route``, and the port's trainer over the same weights."""
    knobs = _route_knobs(route)
    jax_trainer = make_trainer(**knobs)
    jax_params = jax_trainer.init_state().params
    config = PortConfig(
        TRAIN_DATA_PATH_PREFIX='unused', MAX_CONTEXTS=4,
        TOKEN_EMBEDDINGS_SIZE=8, PATH_EMBEDDINGS_SIZE=8,
        CODE_VECTOR_SIZE=24, COMPUTE_DTYPE='float32', **knobs)
    vocabs = SimpleNamespace(token_vocab=_vocab(32), path_vocab=_vocab(16),
                             target_vocab=_vocab(16))
    backend = TorchBackend(config, vocabs, torch.device('cpu'),
                           params=to_port(jax_params))
    return jax_trainer, jax_params, Trainer(config, backend)


def _port_arrays(route, batch):
    """The batch on the route's wire, as the port's step takes it."""
    wire = batch
    if ROUTES[route][0] == 'packed':
        wire = port_packed.pack_batch(batch, 0, 0, capacity_minimum=4)
    return tuple(torch.from_numpy(a) for a in wire.device_arrays())


def _assert_outputs_close(got, want):
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    assert set(got) == set(want)
    for key in got:
        if key == 'topk_indices':
            np.testing.assert_array_equal(got[key], want[key])
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       atol=ATOL, err_msg=key)


@pytest.mark.parametrize('route', NEW_ROUTES)
def test_predict_and_eval_steps_match_reference(route):
    jax_trainer, jax_params, trainer = _step_pair(route)
    batch = _tier_batch()
    rng = np.random.default_rng(5)
    batch = batch._replace(
        label=rng.integers(0, 16, (16,)).astype(np.int32),
        weight=(rng.random(16) > 0.25).astype(np.float32))
    arrays = _port_arrays(route, batch)
    for tier in PREDICT_TIERS:
        _assert_outputs_close(
            predict_step(trainer.backend, arrays, tier=tier),
            jax_trainer.predict_step(jax_params, batch, tier=tier))
    want_batch = batch
    if ROUTES[route][0] == 'packed':
        # one shard per device of the reference's 8-device CPU mesh
        want_batch = jax_packed.pack_batch(batch, 0, 0, data_shards=8,
                                           capacity_minimum=4)
    want = jax_trainer.eval_step(jax_params, want_batch)
    got = trainer.eval_step(arrays)
    assert set(got) == set(want) == {'topk_indices', 'topk_scores',
                                     'loss_sum', 'weight_sum'}
    _assert_outputs_close(got, want)
    # the eval step's top-k scores are the raw logits, not softmaxed
    logits = trainer.backend.forward(*_port_arrays('planes_encode',
                                                   batch)[:4])[2]
    np.testing.assert_allclose(got['topk_scores'].numpy(),
                               torch.topk(logits, 10).values.numpy(),
                               rtol=RTOL, atol=ATOL)


def _tied_logits(batch: int, vocab: int) -> np.ndarray:
    """bf16-rounded logits with ties in every row's top ten: four
    distinct values (+-0.0 among them) over the first 12 columns, the
    rest at the reference's -1e9 padding."""
    rng = np.random.default_rng(11)
    values = np.array([1.5, 0.25, 0.0, -0.0], np.float32)
    logits = rng.choice(values, (batch, vocab)).astype(np.float32)
    logits[:, 12:] = -1e9
    return torch.from_numpy(logits).bfloat16().float().numpy()


@pytest.mark.parametrize('step', ['predict', 'eval'])
def test_bf16_steps_break_ties_as_the_reference(step, monkeypatch):
    """Both packages in bf16 fed the same tied logits (their logits
    functions replaced by one array): the steps' top-k indices are equal,
    ties broken by the lower index (lax.top_k)."""
    import jax.numpy as jnp
    from code2vec_tpu.config import Config as JaxConfig
    from code2vec_tpu.models import functional as jax_functional
    from code2vec_tpu.models.backends import create_backend
    from code2vec_tpu.training.trainer import Trainer as JaxTrainer
    from code2vec_tpu.vocab import SizeOnlyVocabs
    from code2vec_tpu_torch.models import functional as port_functional
    knobs = dict(_route_knobs('planes_encode'), MAX_CONTEXTS=4,
                 TOKEN_EMBEDDINGS_SIZE=8, PATH_EMBEDDINGS_SIZE=8,
                 CODE_VECTOR_SIZE=24, COMPUTE_DTYPE='bfloat16')
    jax_config = JaxConfig(
        TRAIN_DATA_PATH_PREFIX='unused', DL_FRAMEWORK='jax', VERBOSE_MODE=0,
        READER_USE_NATIVE=False, TRAIN_BATCH_SIZE=16, TEST_BATCH_SIZE=16,
        MAX_TOKEN_VOCAB_SIZE=32, MAX_PATH_VOCAB_SIZE=16,
        MAX_TARGET_VOCAB_SIZE=16, TARGET_EMBEDDINGS_SIZE=24, **knobs)
    jax_trainer = JaxTrainer(jax_config, create_backend(
        jax_config, SizeOnlyVocabs(32, 16, 16)))
    jax_params = jax_trainer.init_state().params
    vocabs = SimpleNamespace(token_vocab=_vocab(32), path_vocab=_vocab(16),
                             target_vocab=_vocab(16))
    trainer = Trainer(PortConfig(TRAIN_DATA_PATH_PREFIX='unused', **knobs),
                      TorchBackend(PortConfig(TRAIN_DATA_PATH_PREFIX='unused',
                                              **knobs), vocabs,
                                   torch.device('cpu'),
                                   params=to_port(jax_params)))
    batch = _tier_batch()
    # the width of the target table (16 targets padded to 128 rows)
    logits = _tied_logits(16, jax_params.target_embedding.shape[0])
    monkeypatch.setattr(jax_functional, 'compute_logits',
                        lambda *a, **kw: jnp.asarray(logits))
    monkeypatch.setattr(port_functional, 'compute_logits',
                        lambda *a, **kw: torch.from_numpy(logits))
    arrays = _port_arrays('planes_encode', batch)
    if step == 'predict':
        want = jax_trainer.predict_step(jax_params, batch, tier='topk')
        got = predict_step(trainer.backend, arrays, tier='topk')
    else:
        want = jax_trainer.eval_step(jax_params, batch)
        got = trainer.eval_step(arrays)
    want_indices = np.asarray(want['topk_indices'])
    np.testing.assert_array_equal(got['topk_indices'].numpy(), want_indices)
    np.testing.assert_allclose(got['topk_scores'].numpy(),
                               np.asarray(want['topk_scores']), rtol=RTOL,
                               atol=ATOL)
    # the rows do tie inside the top ten
    top = np.take_along_axis(logits, want_indices, axis=-1)
    assert (top[:, 1:] == top[:, :-1]).any(axis=-1).all()


def _model_pair(data_dir, route, **extra):
    from code2vec_tpu.config import Config
    from code2vec_tpu.model_api import Code2VecModel
    shared = dict(TRAIN_DATA_PATH_PREFIX=str(data_dir / 'tiny'),
                  TEST_DATA_PATH=str(data_dir / 'tiny.val.c2v'),
                  MAX_CONTEXTS=6, COMPUTE_DTYPE='float32',
                  TEST_BATCH_SIZE=8, **_route_knobs(route), **extra)
    reference = Code2VecModel(Config(
        DL_FRAMEWORK='jax', VERBOSE_MODE=0, TRAIN_BATCH_SIZE=16,
        NUM_TRAIN_EPOCHS=1, READER_USE_NATIVE=False, **shared))
    port = PortModel(PortConfig(**shared), device='cpu',
                     params=to_port(reference.params))
    return reference, port


def _read_vectors(path):
    return np.array([[float(v) for v in line.split()]
                     for line in path.read_text().splitlines()])


@pytest.mark.parametrize('route', sorted(ROUTES))
def test_evaluate_matches_reference(route, tmp_path):
    data_dir = tmp_path / 'data'
    data_dir.mkdir()
    make_dataset(data_dir)
    vectors = data_dir / 'tiny.val.c2v.vectors'
    reference, port = _model_pair(data_dir, route, EXPORT_CODE_VECTORS=True)
    want = reference.evaluate()
    want_log = (tmp_path / 'log.txt').read_text()
    want_vectors = _read_vectors(vectors)
    (tmp_path / 'log.txt').unlink()
    got = port.evaluate()
    np.testing.assert_array_equal(got.topk_acc, want.topk_acc)
    assert (got.subtoken_precision, got.subtoken_recall, got.subtoken_f1) \
        == (want.subtoken_precision, want.subtoken_recall, want.subtoken_f1)
    np.testing.assert_allclose(got.loss, want.loss, rtol=RTOL)
    assert (tmp_path / 'log.txt').read_text() == want_log
    got_vectors = _read_vectors(vectors)
    assert got_vectors.shape == want_vectors.shape == (
        16, port.config.CODE_VECTOR_SIZE)
    np.testing.assert_allclose(got_vectors, want_vectors, rtol=RTOL,
                               atol=ATOL)
    # random weights still rank the four names apart
    assert 0 < got.topk_acc[0] < got.topk_acc[-1] <= 1


def test_evaluate_keeps_oov_labels_and_drops_rows_without_contexts(
        tmp_path):
    """The eval filter keeps rows whose label is out of vocabulary and
    drops rows with no valid context; the last batch is padded."""
    data_dir = tmp_path / 'data'
    data_dir.mkdir()
    prefix = make_dataset(data_dir)
    test = data_dir / 'oov.test.c2v'
    test.write_text('unseen|name tokc0,pA,tokc1\n'
                    'get|a nope,nope,nope\n'
                    'get|a toka0,pB,toka2\n')
    config = PortConfig(TRAIN_DATA_PATH_PREFIX=str(prefix),
                        TEST_DATA_PATH=str(test), MAX_CONTEXTS=6,
                        TEST_BATCH_SIZE=4, BATCH_WIRE_FORMAT='planes')
    port = PortModel(config, device='cpu')
    batches = list(port.reader.iter_epoch(evaluate=True))
    assert len(batches) == 1
    assert list(batches[0].label_strings) == ['unseen|name', 'get|a', '',
                                              '']
    np.testing.assert_array_equal(batches[0].weight, [1, 1, 0, 0])
    assert batches[0].source.shape == (4, 6)
    results = port.evaluate()
    assert results.topk_acc.shape == (10,)
    assert (tmp_path / 'log.txt').read_text().count('\n') == 2


def test_train_refuses_untrained_routes_and_evaluates_per_epoch(tmp_path):
    """The routes that once refused to train (the plane wire, the packed
    wire without the ragged fusion) train now, through ``train()`` and
    ``train_step``; ``train()`` evaluates after each epoch."""
    data_dir = tmp_path / 'data'
    data_dir.mkdir()
    prefix = make_dataset(data_dir)
    shared = dict(TRAIN_DATA_PATH_PREFIX=str(prefix), MAX_CONTEXTS=6,
                  TRAIN_BATCH_SIZE=16, TEST_BATCH_SIZE=8,
                  COMPUTE_DTYPE='float32', NUM_TRAIN_EPOCHS=2)
    for knobs in (dict(BATCH_WIRE_FORMAT='planes'),
                  dict(USE_PALLAS_RAGGED_FUSION=False)):
        model = PortModel(PortConfig(**shared, **knobs), device='cpu')
        losses = model.train()
        assert len(losses) == 2 and model.state.step == 8
        assert all(np.isfinite(losses))
        batch = next(model.reader.iter_epoch(seed=0))
        state, loss = model.trainer.train_step(model.state, batch)
        assert state.step == 9 and np.isfinite(float(loss))
    model = PortModel(PortConfig(
        **shared, TEST_DATA_PATH=str(data_dir / 'tiny.val.c2v')),
        device='cpu')
    model.train()
    assert [e['label'] for e in model.eval_history] == ['epoch 1',
                                                        'epoch 2']
    assert [e['step'] for e in model.eval_history] == [4, 8]
    assert all(np.isfinite(e['loss']) and len(e['topk_acc']) == 10
               for e in model.eval_history)
    assert (tmp_path / 'log.txt').exists()
