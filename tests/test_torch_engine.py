"""The port's serving engine (code2vec_tpu_torch/serving/engine.py and
graphs.py) against the reference's (code2vec_tpu/serving/engine.py), on
the CPU, where the engine runs the eager predict step with the kernels'
plain versions and captures no graph:

- the ladder: ``capacity_ladder`` and the planned (bucket, rung, tier)
  keys equal the reference's, on both wires;
- parity: one set of weights (carried across by ``convert.py``) in both
  packages' engines, fp32: equal top-k indices, and scores, attention
  and code vectors within rtol 2e-5 / atol 1e-6, on the packed and the
  plane wire; the port's engine against its own ``predict`` bit for bit;
- behaviour, case by case as tests/test_serving_engine.py: coalescing,
  the smallest covering bucket, tiers, oversize split and rejoin, a
  cancelled request, empty submit and close;
- the serving config keys, flags and rules against the reference's.

The card-side checks (captures, replays, the shared pool) live in
chip_smoke.py's engine phase.
"""
import threading

import numpy as np
import pytest
import torch

from code2vec_tpu_torch.config import Config as PortConfig
from code2vec_tpu_torch.data import packed as port_packed
from code2vec_tpu_torch.model_api import Code2VecModel as PortModel
from code2vec_tpu_torch.serving import engine as port_engine
from tests.test_serving_engine import PREDICT_LINES
from tests.test_torch_model import to_port
from tests.test_train_overfit import make_dataset

RTOL, ATOL = 2e-5, 1e-6
SHARED = dict(MAX_CONTEXTS=6, COMPUTE_DTYPE='float32',
              SERVING_BATCH_BUCKETS='8,16')
# lines with an unknown word, an empty context slot and a context-free row
PARITY_LINES = PREDICT_LINES + ['run|c tokc0,pC,tokc1 ,, unknown,pZ,tokc2',
                                'close|d']
# ROADMAP C7's probe: a context of four comma parts, whose target the
# native tokenizer would read as 'toka1,extra' (OOV) where the reference
# reads 'toka1'
C7_LINES = PARITY_LINES + ['get|a toka0,pA,toka1,extra toka2,pB,toka1']


@pytest.fixture(scope='module')
def prefix(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp('torch_engine'))


def _reference(prefix, **extra):
    from code2vec_tpu.config import Config
    from code2vec_tpu.model_api import Code2VecModel
    # one device on the data axis, as the port runs
    return Code2VecModel(Config(
        TRAIN_DATA_PATH_PREFIX=str(prefix), DL_FRAMEWORK='jax',
        MESH_DEVICE_INDICES='0',
        TRAIN_BATCH_SIZE=16, TEST_BATCH_SIZE=16, NUM_TRAIN_EPOCHS=1,
        SHUFFLE_BUFFER_SIZE=64, VERBOSE_MODE=0, READER_USE_NATIVE=False,
        **SHARED, **extra))


@pytest.fixture(scope='module')
def pair(prefix):
    """The reference model and the port's model over its weights, per
    wire."""
    out = {}
    for wire in ('packed', 'planes'):
        reference = _reference(prefix, BATCH_WIRE_FORMAT=wire)
        port = PortModel(PortConfig(TRAIN_DATA_PATH_PREFIX=str(prefix),
                                    BATCH_WIRE_FORMAT=wire, **SHARED),
                         device='cpu', params=to_port(reference.params))
        out[wire] = (reference, port)
    return out


@pytest.fixture(scope='module')
def model(pair):
    return pair['packed'][1]


# ------------------------------------------------------------ the ladder
def test_batch_ladder_rounds_to_data_axis():
    assert port_engine.batch_ladder([8, 64], 8) == (8, 64)
    assert port_engine.batch_ladder([1, 8, 10, 60], 8) == (8, 16, 64)
    with pytest.raises(ValueError):
        port_engine.batch_ladder([0], 8)


def test_pick_bucket_smallest_cover():
    ladder = (8, 16, 64)
    assert [port_engine.pick_bucket(n, ladder)
            for n in (1, 8, 9, 64, 65)] == [8, 8, 16, 64, None]


@pytest.mark.parametrize('max_total', [1, 6, 64, 65, 1600, 12800, 25600,
                                       102400, 204800])
def test_capacity_ladder_equals_reference(max_total):
    from code2vec_tpu.data import packed as jax_packed
    assert port_packed.capacity_ladder(max_total) == \
        jax_packed.capacity_ladder(max_total)


def test_capacity_ladder_rungs_at_the_default_buckets():
    # MIN_CAPACITY 64, growth 4, 200 contexts a row
    assert [len(port_packed.capacity_ladder(bucket * 200))
            for bucket in (8, 64, 512, 1024)] == [4, 5, 7, 7]
    assert port_packed.capacity_ladder(1600) == (64, 256, 1024, 1600)
    with pytest.raises(ValueError):
        port_packed.capacity_ladder(0)


def test_capacity_rungs_are_exact_pack_targets():
    rng = np.random.default_rng(0)
    for rung in port_packed.capacity_ladder(1600):
        count = np.array([3, 0, 5, 1], np.int32)
        ctx_rows = rng.integers(
            1, 100, (int(count.sum()), 3)).astype(np.int32)
        ctx = port_packed.pack_ragged(ctx_rows, count, 0, 0,
                                      capacity_minimum=rung)
        assert ctx.shape == (1, rung, 3)


@pytest.mark.parametrize('wire', ['packed', 'planes'])
def test_ladder_keys_equal_reference_warm_programs(pair, wire):
    """The port plans one graph per program the reference engine warms
    (``ServingEngine._warm_batches`` x tiers), in the same order."""
    reference, port = pair[wire]
    tiers = ('topk', 'attention', 'full')
    jax_engine = reference.serving_engine(tiers=tiers, warmup=False)
    try:
        want = [(bucket, (int(arrays[0].shape[1]) if wire == 'packed'
                          else 0), tier)
                for bucket in jax_engine.buckets
                for arrays in jax_engine._warm_batches(bucket)
                for tier in jax_engine.tiers]
    finally:
        jax_engine.close()
    with port.serving_engine(tiers=tiers) as engine:
        assert engine.ladder.keys() == want
        assert engine.stats()['graph_captures'] == 0   # the CPU captures
        assert engine.ladder.warm_slots == 1


# --------------------------------------------------------------- parity
@pytest.mark.parametrize('wire', ['packed', 'planes'])
@pytest.mark.parametrize('tier, native, lines', [
    pytest.param('full', True, PARITY_LINES, id='full-True'),
    pytest.param('topk', True, PARITY_LINES, id='topk-True'),
    pytest.param('topk', False, PARITY_LINES, id='topk-False'),
    pytest.param('vectors', True, PARITY_LINES, id='vectors-True'),
    pytest.param('topk', True, C7_LINES, id='topk-True-c7'),
    pytest.param('vectors', True, C7_LINES, id='vectors-True-c7')])
def test_engine_matches_reference_engine(pair, wire, tier, native, lines,
                                         monkeypatch):
    """'full' tokenizes in Python (it keeps the context strings); topk and
    vectors through the native tokenizer under READER_USE_NATIVE, else in
    Python: the same results either way. A request with a context of four
    comma parts reads that context's target as the reference does on
    every tier (C7)."""
    reference, port = pair[wire]
    monkeypatch.setattr(port.config, 'READER_USE_NATIVE', native)
    with reference.serving_engine(tiers=(tier,),
                                  max_delay_ms=0.0) as engine:
        want = engine.predict(lines, tier=tier, timeout=60)
    with port.serving_engine(tiers=(tier,), max_delay_ms=0.0) as engine:
        got = engine.predict(lines, tier=tier, timeout=60)
        if lines is PARITY_LINES:
            assert (engine.reader._native is not None) == (
                native and tier != 'full')
    assert len(got) == len(want) == len(lines)
    for g, w in zip(got, want):
        assert g.original_name == w.original_name
        assert g.topk_predicted_words == w.topk_predicted_words
        if tier == 'vectors':
            assert g.topk_predicted_words_scores is None
        else:
            np.testing.assert_allclose(g.topk_predicted_words_scores,
                                       w.topk_predicted_words_scores,
                                       rtol=RTOL, atol=ATOL)
        assert g.attention_per_context.keys() == \
            w.attention_per_context.keys()
        for key, value in w.attention_per_context.items():
            np.testing.assert_allclose(g.attention_per_context[key], value,
                                       rtol=RTOL, atol=ATOL)
        if tier == 'topk':
            assert g.code_vector is None
        else:
            np.testing.assert_allclose(g.code_vector, w.code_vector,
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('line, long', [
    ('get|a toka0,pA,toka1 toka2,pB,toka1', False),
    (C7_LINES[-1], True),
    ('get x,y,z,', True),                        # an empty fourth part
    ('get a,b c,d,e,f', True),    # a short context beside a long one
    ('get a,b c,d e,f,g', False),
    ('ünï a,b,ç d,é,f,ĝ', True),
    ('ünï a,b,ç d,é,f', False),
    ('get', False)])
def test_long_context_scan(line, long):
    """The caller-thread test that sends a request through the Python
    tokenizer: a context of more than three comma parts, whatever the
    other contexts or lines hold and in any script."""
    assert port_engine._long_context([line]) is long
    assert port_engine._long_context(PARITY_LINES + [line]) is long
    assert port_engine._long_context([line] + PARITY_LINES) is long


@pytest.mark.parametrize('wire', ['packed', 'planes'])
def test_engine_matches_model_predict_exactly(pair, wire):
    port = pair[wire][1]
    direct = port.predict(PREDICT_LINES)
    with port.serving_engine(tiers=('attention',),
                             max_delay_ms=0.0) as engine:
        served = engine.predict(PREDICT_LINES, tier='attention', timeout=60)
    assert len(served) == len(direct) == len(PREDICT_LINES)
    for s, d in zip(served, direct):
        assert s.original_name == d.original_name
        assert s.topk_predicted_words == d.topk_predicted_words
        np.testing.assert_array_equal(s.topk_predicted_words_scores,
                                      d.topk_predicted_words_scores)
        assert s.attention_per_context == d.attention_per_context
        assert s.code_vector is None and d.code_vector is None


# ------------------------------------------------------------ behaviour
def test_deadline_coalescing_batches_concurrent_requests(model):
    with model.serving_engine(tiers=('topk',),
                              max_delay_ms=500.0) as engine:
        futures = [engine.submit([line], tier='topk')
                   for line in PREDICT_LINES]
        results = [f.result(timeout=60) for f in futures]
        stats = engine.stats()
    assert stats['batches_total'] == 1
    assert stats['requests_total'] == len(PREDICT_LINES)
    assert stats['last_dispatch']['requests'] == len(PREDICT_LINES)
    assert stats['last_dispatch']['rows'] == len(PREDICT_LINES)
    direct = model.predict(PREDICT_LINES)
    for (res,), d in zip(results, direct):
        assert res.original_name == d.original_name
        assert res.topk_predicted_words == d.topk_predicted_words


def test_bucket_selection_smallest_cover(model):
    with model.serving_engine(tiers=('topk',),
                              max_delay_ms=0.0) as engine:
        engine.predict([PREDICT_LINES[0]], tier='topk', timeout=60)
        first = dict(engine.stats()['last_dispatch'])
        nine = [PREDICT_LINES[i % 3] for i in range(9)]
        engine.predict(nine, tier='topk', timeout=60)
        second = dict(engine.stats()['last_dispatch'])
        assert engine.stats()['batch_fill_rate'] == pytest.approx(9 / 16)
    assert first == {'bucket': 8, 'rows': 1, 'capacity': 64,
                     'requests': 1}
    assert second['bucket'] == 16 and second['rows'] == 9


def test_topk_tier_is_attention_and_vector_free(model):
    direct = model.predict(PREDICT_LINES)
    with model.serving_engine(tiers=('topk',),
                              max_delay_ms=0.0) as engine:
        served = engine.predict(PREDICT_LINES, tier='topk', timeout=60)
    for s, d in zip(served, direct):
        assert s.topk_predicted_words == d.topk_predicted_words
        np.testing.assert_array_equal(s.topk_predicted_words_scores,
                                      d.topk_predicted_words_scores)
        assert s.attention_per_context == {}
        assert s.code_vector is None


def test_oversize_request_splits_across_buckets(model):
    lines = [PREDICT_LINES[i % 3] for i in range(20)]
    with model.serving_engine(tiers=('topk',),
                              max_delay_ms=0.0) as engine:
        served = engine.predict(lines, tier='topk', timeout=60)
        stats = engine.stats()
    assert len(served) == 20
    assert stats['batches_total'] == 2  # 16-row chunk + 4-row chunk
    direct = model.predict(lines)
    for s, d in zip(served, direct):
        assert s.original_name == d.original_name
        assert s.topk_predicted_words == d.topk_predicted_words
        np.testing.assert_allclose(s.topk_predicted_words_scores,
                                   d.topk_predicted_words_scores,
                                   rtol=1e-5, atol=1e-7)


def test_cancelled_request_does_not_poison_batchmates(model):
    with model.serving_engine(tiers=('topk',),
                              max_delay_ms=300.0) as engine:
        doomed = engine.submit([PREDICT_LINES[0]], tier='topk')
        survivor = engine.submit([PREDICT_LINES[1]], tier='topk')
        assert doomed.cancel()
        results = survivor.result(timeout=60)
        stats = engine.stats()
    assert stats['batches_total'] == 1  # same micro-batch
    assert results[0].topk_predicted_words == \
        model.predict([PREDICT_LINES[1]])[0].topk_predicted_words


def test_engine_empty_submit_and_close_semantics(model):
    engine = model.serving_engine(tiers=('topk',), warmup=False,
                                  max_delay_ms=0.0)
    assert engine.submit([], tier='topk').result(timeout=5) == []
    with pytest.raises(ValueError):
        engine.submit(PREDICT_LINES, tier='vectors')  # not warmed
    engine.close()
    engine.close()  # idempotent
    with pytest.raises(RuntimeError):
        engine.submit(PREDICT_LINES, tier='topk')
    assert not engine._dispatcher.is_alive()
    assert not any(t.name.startswith('serving-dispatch')
                   and t is engine._dispatcher
                   for t in threading.enumerate())


def test_engine_on_cuda_without_a_gpu_raises(model, monkeypatch):
    from code2vec_tpu_torch.serving.engine import ServingEngine
    backend = model.backend
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setattr(backend, 'device', torch.device('cuda'))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ServingEngine(model.config, backend, backend.params, model.vocabs,
                      decode_table=model._target_index_to_word)


def test_external_dispatch_engine_refuses_submit(model):
    with model.serving_engine(tiers=('topk',), external_dispatch=True,
                              max_delay_ms=0.0) as engine:
        assert engine._dispatcher is None
        with pytest.raises(RuntimeError, match='external-dispatch'):
            engine.submit(PREDICT_LINES, tier='topk')
        requests = port_engine.tokenize_and_chunk(
            engine.reader, PREDICT_LINES, 'topk',
            port_engine.Future(), None, engine.buckets[-1])
        engine.dispatch_external('topk', requests, len(PREDICT_LINES))
        (results,) = [r.future.result(timeout=60) for r in requests]
    assert [r.topk_predicted_words for r in results] == \
        [d.topk_predicted_words for d in model.predict(PREDICT_LINES)]


# --------------------------------------------------------------- config
SERVING_KEYS = ('SERVING_BATCH_BUCKETS', 'SERVING_MAX_DELAY_MS',
                'SERVING_DECODE_WORKERS', 'SERVING_WARM_TIERS',
                'SERVING_DEADLINE_MS', 'SERVING_QUEUE_BOUND',
                'SERVING_CANARY_BATCHES', 'SERVING_CANARY_AGREEMENT',
                'SERVING_CANARY_TIMEOUT_SECS',
                'SERVE_FOLLOW_CHECKPOINTS_SECS')


@pytest.mark.parametrize('key', SERVING_KEYS)
def test_serving_defaults_equal_reference(key):
    from code2vec_tpu.config import Config
    assert getattr(PortConfig(), key) == getattr(Config(), key)


def test_serving_flags_parse_as_reference():
    from code2vec_tpu.config import Config
    flags = ['--data', 'x', '--serving-buckets', '4,32',
             '--serving-max-delay-ms', '2.5', '--serving-deadline-ms', '40',
             '--serving-queue-bound', '-1',
             '--serve-follow-checkpoints', '0.5']
    port = PortConfig().load_from_args(flags)
    reference = Config().load_from_args(flags)
    for key in SERVING_KEYS:
        assert getattr(port, key) == getattr(reference, key), key
    assert port.serving_warm_tiers == reference.serving_warm_tiers


@pytest.mark.parametrize('key, value', [
    ('SERVING_MAX_DELAY_MS', -1.0), ('SERVING_DECODE_WORKERS', 0),
    ('SERVING_DEADLINE_MS', -1.0), ('SERVING_QUEUE_BOUND', -2),
    ('SERVING_CANARY_BATCHES', -1), ('SERVING_CANARY_AGREEMENT', 1.5),
    ('SERVING_CANARY_TIMEOUT_SECS', -1.0),
    ('SERVE_FOLLOW_CHECKPOINTS_SECS', -0.5),
    ('SERVING_WARM_TIERS', 'topk,logits'), ('SERVING_WARM_TIERS', ''),
])
def test_serving_verify_rules_as_reference(key, value):
    from code2vec_tpu.config import Config
    with pytest.raises(ValueError, match=key):
        PortConfig(TRAIN_DATA_PATH_PREFIX='x', **{key: value}).verify()
    with pytest.raises(ValueError, match=key):
        Config(TRAIN_DATA_PATH_PREFIX='x', **{key: value}).verify()
