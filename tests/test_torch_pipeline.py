"""The port's host data path on the CPU:

- ``reader.py::prefetch_iterator``: order, an error raised in the
  consumer after the items before it, and a consumer that stops early
  stopping the producer thread;
- ``Trainer.stage_batches`` at depth 0 on the CPU (both wires, tensors
  passed through) and ``place``;
- ``Code2VecModel.train()`` on the tiny corpus of
  tests/test_train_overfit.py, from the token cache and without it (the
  native tokenizer behind the prefetch thread), against the reference's
  ``Code2VecModel.train()`` from the same weights at keep 1.0: per-epoch
  mean losses at test_torch_train.py's loss tolerance (rtol 2e-5);
- ``Code2VecModel.evaluate()`` with the native reader against the
  reference's (native too) and the port's Python reader: metrics and
  ``log.txt`` equal, the loss at rtol 2e-5.
"""
import itertools
import threading

import numpy as np
import pytest
import torch

from code2vec_tpu.config import Config as JaxConfig
from code2vec_tpu.model_api import Code2VecModel as JaxModel
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data import packed as packed_lib
from code2vec_tpu_torch.data.cache import TokenCache
from code2vec_tpu_torch.data.reader import prefetch_iterator
from code2vec_tpu_torch.model_api import Code2VecModel
from code2vec_tpu_torch.training.trainer import Trainer
from tests.test_stage_batches import make_batches
from tests.test_torch_model import to_port
from tests.test_torch_train import port_backend
from tests.test_train_overfit import make_dataset

LOSS_RTOL = 2e-5


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == 'c2v-prefetch'
            and t.is_alive()]


@pytest.mark.parametrize('depth', [1, 3, 64])
def test_prefetch_keeps_order(depth):
    assert list(prefetch_iterator(lambda: iter(range(50)), depth)) == \
        list(range(50))
    assert not _prefetch_threads()


def test_prefetch_raises_the_producers_error_after_its_items():
    def produce():
        yield from range(3)
        raise KeyError('bad line')

    got = []
    with pytest.raises(KeyError, match='bad line'):
        for item in prefetch_iterator(produce, 2):
            got.append(item)
    assert got == [0, 1, 2]
    assert not _prefetch_threads()


def test_abandoned_consumer_stops_the_producer():
    produced = []
    closed = threading.Event()

    def produce():
        try:
            for i in itertools.count():
                produced.append(i)
                yield i
        finally:
            closed.set()

    stream = prefetch_iterator(produce, 2)
    assert [next(stream) for _ in range(3)] == [0, 1, 2]
    stream.close()              # joins the producer thread
    assert closed.is_set() and not _prefetch_threads()
    # the bounded queue held the producer back: at most the queue's two,
    # the one blocked on a full queue and the three taken
    assert len(produced) <= 6


@pytest.mark.parametrize('wire', ['planes', 'packed'])
def test_stage_batches_on_the_cpu(wire):
    config = Config(TRAIN_DATA_PATH_PREFIX='unused', MAX_CONTEXTS=4,
                    DEVICE_PREFETCH_BATCHES=2)
    trainer = Trainer(config, port_backend(config))
    batches = make_batches(5)
    if wire == 'packed':
        batches = [packed_lib.pack_batch(b, 0, 0) for b in batches]
    staged = list(trainer.stage_batches(iter(batches)))
    assert [batch for _, batch in staged] == batches
    for arrays, batch in staged:
        host = batch.device_arrays()
        assert len(arrays) == len(host) == (4 if wire == 'packed' else 6)
        for got, want in zip(arrays, host):
            assert isinstance(got, torch.Tensor) and got.device.type == 'cpu'
            np.testing.assert_array_equal(got.numpy(), want)
    # tensors pass as they are; place() stages one batch
    tensors = tuple(torch.from_numpy(a) for a in batches[0].device_arrays())
    assert all(a is b for a, b in zip(trainer.place(tensors), tensors))
    assert not trainer._pinned.buffers       # nothing pinned on the CPU


def test_train_step_is_staged_then_placed():
    config = Config(TRAIN_DATA_PATH_PREFIX='unused', MAX_CONTEXTS=4,
                    COMPUTE_DTYPE='float32', DROPOUT_KEEP_RATE=1.0)
    batch = packed_lib.pack_batch(make_batches(1)[0], 0, 0)
    losses = []
    for placed in (False, True):
        trainer = Trainer(config, port_backend(config))
        state = trainer.state_from_params()
        if placed:
            state, loss = trainer.train_step_placed(state,
                                                    trainer.place(batch))
        else:
            state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
        out = trainer.eval_step_placed(trainer.place(batch))
        assert out['topk_indices'].shape == (8, 10)
    assert losses[0] == losses[1]


def _train_pair(tmp_path, cache, epochs=3):
    prefix = make_dataset(tmp_path)
    shared = dict(TRAIN_DATA_PATH_PREFIX=str(prefix), MAX_CONTEXTS=6,
                  TRAIN_BATCH_SIZE=16, NUM_TRAIN_EPOCHS=epochs,
                  SHUFFLE_BUFFER_SIZE=64, COMPUTE_DTYPE='float32',
                  DROPOUT_KEEP_RATE=1.0, LEARNING_RATE=0.01,
                  ADAM_MU_DTYPE='float32', ADAM_NU_DTYPE='float32',
                  TRAIN_DATA_CACHE=cache, READER_USE_NATIVE=True)
    reference = JaxModel(JaxConfig(DL_FRAMEWORK='jax', VERBOSE_MODE=0,
                                   **shared))
    port = Code2VecModel(Config(**shared), device='cpu',
                         params=to_port(reference.params))
    return prefix, reference, port


def _reference_epoch_losses(reference, steps_per_epoch):
    """Runs the reference's train() and returns its per-epoch mean losses
    (its steps' losses, recorded as they come)."""
    losses = []
    step = reference.trainer.train_step_placed

    def recorded(state, arrays):
        state, loss = step(state, arrays)
        losses.append(float(loss))
        return state, loss

    reference.trainer.train_step_placed = recorded
    reference.train()
    per_epoch = np.asarray(losses).reshape(-1, steps_per_epoch)
    return per_epoch.mean(axis=1)


@pytest.mark.parametrize('cache', [True, False],
                         ids=['token_cache', 'native_prefetch'])
def test_train_matches_reference(tmp_path, cache):
    prefix, reference, port = _train_pair(tmp_path, cache)
    timings = []
    got = port.train(timings=timings)
    want = _reference_epoch_losses(reference, 4)      # 60 rows / 16
    assert len(got) == len(want) == 3 and port.state.step == 12
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]
    cache_dir = tmp_path / 'tiny.train.c2v.tokcache'
    assert cache_dir.is_dir() == cache
    assert [t['steps'] for t in timings] == [4, 4, 4]
    assert all(len(t['wait_s']) == 4 and t['interval_ms'] == []
               for t in timings)       # step intervals: on the card only
    assert ('cache_bytes' in timings[0]) == cache
    if cache:
        assert timings[0]['cache_bytes'] == sum(
            f.stat().st_size for f in cache_dir.iterdir())


def test_train_from_cache_takes_the_caches_batches(tmp_path):
    """The epochs' batches are the cache's, in order, ``seed=epoch``."""
    prefix, _reference, port = _train_pair(tmp_path, True, epochs=2)
    seen = []
    step = port.trainer.train_step_placed

    def recorded(state, arrays):
        seen.append(tuple(a.clone() for a in arrays))
        return step(state, arrays)

    port.trainer.train_step_placed = recorded
    port.train()
    cache = TokenCache(str(prefix) + '.train.c2v.tokcache', port.config,
                       port.vocabs)
    want = [batch for epoch in range(2) for batch in cache.iter_epoch(
        16, shuffle=True, seed=epoch, wire_format='packed')]
    assert len(seen) == len(want) == 8
    for got, batch in zip(seen, want):
        for g, w in zip(got, batch.device_arrays()):
            np.testing.assert_array_equal(g.numpy(), w)


def _eval_models(tmp_path, native):
    data_dir = tmp_path / 'data'
    data_dir.mkdir(exist_ok=True)
    prefix = make_dataset(data_dir)
    shared = dict(TRAIN_DATA_PATH_PREFIX=str(prefix),
                  TEST_DATA_PATH=str(data_dir / 'tiny.val.c2v'),
                  MAX_CONTEXTS=6, COMPUTE_DTYPE='float32',
                  TEST_BATCH_SIZE=8)
    reference = JaxModel(JaxConfig(DL_FRAMEWORK='jax', VERBOSE_MODE=0,
                                   READER_USE_NATIVE=True, **shared))
    port = Code2VecModel(Config(READER_USE_NATIVE=native, **shared),
                         device='cpu', params=to_port(reference.params))
    return reference, port


@pytest.mark.parametrize('native', [True, False])
def test_evaluate_with_the_native_reader_matches_reference(
        tmp_path, monkeypatch, native):
    monkeypatch.chdir(tmp_path)
    reference, port = _eval_models(tmp_path, native)
    want = reference.evaluate()
    want_log = (tmp_path / 'log.txt').read_text()
    (tmp_path / 'log.txt').unlink()
    got = port.evaluate()
    np.testing.assert_array_equal(got.topk_acc, want.topk_acc)
    assert (got.subtoken_precision, got.subtoken_recall, got.subtoken_f1) \
        == (want.subtoken_precision, want.subtoken_recall, want.subtoken_f1)
    np.testing.assert_allclose(got.loss, want.loss, rtol=LOSS_RTOL)
    assert (tmp_path / 'log.txt').read_text() == want_log
    assert want_log.count('\n') == 16
    assert (port.reader._native is None) and not _prefetch_threads()


def test_pipeline_flags():
    args = ['--data', 'ds', '--no-data-cache', '--device-prefetch', '0',
            '--predict', '--input-file', 'X.cs', '--extractor-timeout', '7']
    got = Config().load_from_args(args)
    want = JaxConfig().load_from_args(args)
    for name in ('TRAIN_DATA_CACHE', 'DEVICE_PREFETCH_BATCHES', 'PREDICT',
                 'PREDICT_INPUT_PATH', 'EXTRACTOR_TIMEOUT_SECS',
                 'READER_USE_NATIVE', 'READER_NUM_PARALLEL_BATCHES',
                 'READER_PREFETCH_BATCHES', 'EXTRACTOR_RETRIES',
                 'EXTRACTOR_BACKOFF_SECS', 'EXTRACTOR_POOL_WORKERS',
                 'EXTRACTOR_BREAKER_THRESHOLD',
                 'EXTRACTOR_BREAKER_COOLDOWN_SECS'):
        assert getattr(got, name) == getattr(want, name), name
    assert (got.TRAIN_DATA_CACHE, got.DEVICE_PREFETCH_BATCHES,
            got.PREDICT_INPUT_PATH) == (False, 0, 'X.cs')
    defaults = Config()
    assert (defaults.TRAIN_DATA_CACHE, defaults.READER_USE_NATIVE,
            defaults.DEVICE_PREFETCH_BATCHES) == (True, True, 2)


@pytest.mark.parametrize('name, value', [
    ('READER_PREFETCH_BATCHES', 0), ('READER_NUM_PARALLEL_BATCHES', 0),
    ('DEVICE_PREFETCH_BATCHES', -1), ('EXTRACTOR_TIMEOUT_SECS', -1.0),
    ('EXTRACTOR_RETRIES', -1), ('EXTRACTOR_POOL_WORKERS', 0),
    ('EXTRACTOR_BREAKER_THRESHOLD', 0)])
def test_pipeline_knobs_are_checked(name, value):
    with pytest.raises(ValueError, match=name):
        Config(TRAIN_DATA_PATH_PREFIX='x', **{name: value}).verify()
