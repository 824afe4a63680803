"""The port's serving slice as a whole against the reference, fp32 on the
CPU with the same weights (carried across by code2vec_tpu_torch/
convert.py):

- the four predict tiers against the reference ``Trainer.predict_step``;
- ``Code2VecModel.predict`` end to end against the reference model over
  the same ``.dict.c2v``;
- the device rule: no CUDA and no ``device='cpu'`` raises;
- the import rule: no module of the port, and not ``chip_smoke.py``,
  imports ``jax`` or ``code2vec_tpu`` (AST scan).

Tolerance: the reference's ``assert_encode_close`` (rtol 2e-5, atol
1e-6); top-k indices and words must be identical."""
import ast
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from code2vec_tpu.data.reader import Batch
from code2vec_tpu_torch import convert
from code2vec_tpu_torch import device as device_lib
from code2vec_tpu_torch.config import Config as PortConfig
from code2vec_tpu_torch.data import packed as port_packed
from code2vec_tpu_torch.model_api import Code2VecModel as PortModel
from code2vec_tpu_torch.models.backends import TorchBackend
from code2vec_tpu_torch.serving import predict as port_predict
from code2vec_tpu_torch.serving.steps import PREDICT_TIERS, predict_step
from tests.test_serving_engine import PREDICT_LINES
from tests.test_stage_batches import make_trainer
from tests.test_train_overfit import make_dataset

RTOL, ATOL = 2e-5, 1e-6
REPO = Path(__file__).resolve().parents[1]


def to_port(jax_params, device='cpu'):
    return convert.params_from_numpy(
        {k: np.asarray(v) for k, v in jax_params._asdict().items()}, device)


def _vocab(size):
    return SimpleNamespace(size=size, pad_index=0)


@pytest.fixture(scope='module')
def tier_pair():
    """The reference trainer of tests/test_stage_batches.py (vocab
    32/16/16, dims 8/8/24, 4 contexts, fp32) and the port's backend over
    the same weights."""
    trainer = make_trainer()
    jax_params = trainer.init_state().params
    config = PortConfig(
        TRAIN_DATA_PATH_PREFIX='unused', MAX_CONTEXTS=4,
        TOKEN_EMBEDDINGS_SIZE=8, PATH_EMBEDDINGS_SIZE=8,
        CODE_VECTOR_SIZE=24, COMPUTE_DTYPE='float32')
    vocabs = SimpleNamespace(token_vocab=_vocab(32), path_vocab=_vocab(16),
                             target_vocab=_vocab(16))
    backend = TorchBackend(config, vocabs, torch.device('cpu'),
                           params=to_port(jax_params))
    return trainer, jax_params, backend


def _tier_batch():
    rng = np.random.default_rng(4)
    source = rng.integers(1, 32, (16, 4)).astype(np.int32)
    path = rng.integers(1, 16, (16, 4)).astype(np.int32)
    target = rng.integers(1, 32, (16, 4)).astype(np.int32)
    lengths = rng.integers(0, 5, (16,))
    dead = np.arange(4)[None, :] >= lengths[:, None]
    dead |= rng.random((16, 4)) < 0.2                       # interior holes
    for plane in (source, path, target):
        plane[dead] = 0
    mask = ((source != 0) | (path != 0) | (target != 0)).astype(np.float32)
    return Batch(source=source, path=path, target=target, mask=mask,
                 label=np.zeros((16,), np.int32),
                 weight=np.ones((16,), np.float32))


@pytest.mark.parametrize('tier', PREDICT_TIERS)
def test_predict_tiers_match_reference(tier_pair, tier):
    trainer, jax_params, backend = tier_pair
    batch = _tier_batch()
    want = {k: np.asarray(v) for k, v in
            trainer.predict_step(jax_params, batch, tier=tier).items()}
    packed = port_packed.pack_batch(batch, 0, 0)
    got = predict_step(backend, tuple(torch.from_numpy(a)
                                      for a in packed.device_arrays()),
                       tier=tier)
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    for key in got:
        if key == 'topk_indices':
            np.testing.assert_array_equal(got[key], want[key])
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       atol=ATOL, err_msg=key)


@pytest.fixture(scope='module')
def model_pair(tmp_path_factory):
    from code2vec_tpu.config import Config
    from code2vec_tpu.model_api import Code2VecModel
    prefix = make_dataset(tmp_path_factory.mktemp('torch_serving'))
    shared = dict(TRAIN_DATA_PATH_PREFIX=str(prefix), MAX_CONTEXTS=6,
                  COMPUTE_DTYPE='float32', SERVING_BATCH_BUCKETS='8,16')
    reference = Code2VecModel(Config(
        DL_FRAMEWORK='jax', VERBOSE_MODE=0, TRAIN_BATCH_SIZE=16,
        TEST_BATCH_SIZE=16, NUM_TRAIN_EPOCHS=1, SHUFFLE_BUFFER_SIZE=64,
        READER_USE_NATIVE=False, **shared))
    port = PortModel(PortConfig(**shared), device='cpu',
                     params=to_port(reference.params))
    return reference, port


def test_predict_end_to_end_matches_reference(model_pair):
    reference, port = model_pair
    lines = PREDICT_LINES + ['run|c tokc0,pC,tokc1 ,, unknown,pZ,tokc2']
    want = reference.predict(lines)
    got = port.predict(lines)
    assert len(got) == len(want) == len(lines)
    for g, w in zip(got, want):
        assert g.original_name == w.original_name
        assert g.topk_predicted_words == w.topk_predicted_words
        np.testing.assert_allclose(g.topk_predicted_words_scores,
                                   w.topk_predicted_words_scores,
                                   rtol=RTOL, atol=ATOL)
        assert g.attention_per_context.keys() == w.attention_per_context.keys()
        for key, value in w.attention_per_context.items():
            np.testing.assert_allclose(g.attention_per_context[key], value,
                                       rtol=RTOL, atol=ATOL)
        assert g.code_vector is None and w.code_vector is None


def test_predict_report_and_params_round_trip(model_pair, tmp_path):
    _reference, port = model_pair
    reports = port_predict.predict_contexts(port, PREDICT_LINES[:1],
                                            {'pA': 'A', 'pB': 'B'})
    text = port_predict.render_method_report(reports[0][0])
    assert text.startswith('Original name:\tget|a')
    path = str(tmp_path / 'weights.npz')
    convert.save_npz(path, port.backend.params)
    before = port.predict(PREDICT_LINES)
    after = PortModel(port.config, device='cpu',
                      params=convert.load_npz(path)).predict(PREDICT_LINES)
    for b, a in zip(before, after):
        assert b.topk_predicted_words == a.topk_predicted_words
        np.testing.assert_array_equal(b.topk_predicted_words_scores,
                                      a.topk_predicted_words_scores)


def test_model_without_cpu_request_raises_without_cuda(model_pair,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PortModel(model_pair[1].config)
    with pytest.raises(RuntimeError):
        device_lib.resolve_device('cuda')
    assert device_lib.resolve_device('cpu').type == 'cpu'


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference_package():
    files = sorted((REPO / 'code2vec_tpu_torch').rglob('*.py'))
    files.append(REPO / 'chip_smoke.py')
    assert len(files) > 10
    # the host data path's modules among them
    names = {str(f.relative_to(REPO)) for f in files}
    assert {'code2vec_tpu_torch/%s.py' % m for m in (
        'hostbuild', 'data/native', 'data/cache', 'data/preprocess',
        'data/extract_driver', 'serving/errors', 'serving/extractor_bridge',
        'serving/predict')} <= names
    for path in files:
        for module in _imported_modules(path):
            root = module.split('.')[0]
            assert root not in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',
                                'code2vec_tpu'), (path, module)


def test_dense_forward_and_ce_match_reference(tier_pair):
    """The dense plane forward (the ground truth the packed path is held
    to) and ``weighted_ce_sums``, against the reference backend."""
    from code2vec_tpu.models import functional as jax_functional
    from code2vec_tpu_torch.models import functional
    trainer, jax_params, backend = tier_pair
    batch = _tier_batch()
    arrays = (batch.source, batch.path, batch.target, batch.mask)
    want = [np.asarray(t)
            for t in trainer.backend.forward(jax_params, arrays)]
    got = [t.numpy() for t in backend.forward(
        *(torch.from_numpy(a) for a in arrays))]
    for name, g, w in zip(('code', 'attention', 'logits'), got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)
    rng = np.random.default_rng(2)
    label = rng.integers(0, 16, (16,)).astype(np.int32)
    weight = (rng.random(16) > 0.3).astype(np.float32)
    want_ce = jax_functional.weighted_ce_sums(want[2], label, weight)
    got_ce = functional.weighted_ce_sums(torch.from_numpy(got[2]),
                                         torch.from_numpy(label),
                                         torch.from_numpy(weight))
    for g, w in zip(got_ce, want_ce):
        np.testing.assert_allclose(g.item(), float(w), rtol=RTOL)


def test_init_params_shapes_and_ranges(tier_pair):
    """Seeded init: the reference's padded shapes, and values inside the
    fan-out / glorot uniform limits, spread over them."""
    import math
    _trainer, jax_params, backend = tier_pair
    generator = torch.Generator().manual_seed(0)
    from code2vec_tpu_torch.models import functional
    params = functional.init_params(generator, device=torch.device('cpu'),
                                    **backend.sizes)
    limits = {'token_embedding': math.sqrt(3 / 8),
              'path_embedding': math.sqrt(3 / 8),
              'target_embedding': math.sqrt(3 / 24),
              'transform': math.sqrt(6 / (24 + 24)),
              'attention': math.sqrt(6 / (24 + 1))}
    for name, limit in limits.items():
        tensor = getattr(params, name)
        assert tuple(tensor.shape) == np.asarray(
            getattr(jax_params, name)).shape, name
        assert float(tensor.abs().max()) <= limit, name
        if tensor.numel() >= 1000:
            assert float(tensor.abs().max()) > 0.95 * limit, name
