"""The rest of the port's ``serving/bulk.py``, the index service, the
engine's neighbor queries and the CLI's index flags, against the JAX
package on the CPU over one set of weights (carried across by
``convert.py``), fp32:

- ``iter_code_vector_batches``: rows align with the kept examples in file
  order (a context-free row dropped, the last batch's padding left out)
  and equal the JAX package's vectors and ``predict``'s vectors tier
  (rtol 2e-5 / atol 1e-6); ``export_code_vectors`` text equals the
  stream; ``bulk_predict`` equals ``predict`` for each tier;
- ``query_neighbors_file``: the JSONL equals the JAX one's (names, rows;
  scores within 1e-6), on the exact and the IVF tier;
- the engine: ``submit_neighbors`` on raw vectors and on context lines
  equals the index's search of ``predict``'s vectors; it refuses without
  the vectors tier or without an index;
- the CLI: the index flags map to config as the JAX package's, and
  ``--build-index`` + ``--query-neighbors`` write what a direct
  ``query_neighbors_file`` writes.
"""
import json

import numpy as np
import pytest

from code2vec_tpu_torch.cli import main
from code2vec_tpu_torch.config import Config as PortConfig
from code2vec_tpu_torch.index import service
from code2vec_tpu_torch.index import store as store_lib
from code2vec_tpu_torch.index.exact import ExactIndex
from code2vec_tpu_torch.model_api import Code2VecModel as PortModel
from code2vec_tpu_torch.serving import bulk
from code2vec_tpu_torch.telemetry import memory
from tests.test_serving_engine import PREDICT_LINES
from tests.test_torch_model import to_port
from tests.test_train_overfit import make_dataset

RTOL, ATOL = 2e-5, 1e-6
CPU = ['--device', 'cpu', '-v', '0']
SHARED = dict(MAX_CONTEXTS=6, COMPUTE_DTYPE='float32', TEST_BATCH_SIZE=16,
              SERVING_BATCH_BUCKETS='8,16')


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    from code2vec_tpu.config import Config
    from code2vec_tpu.model_api import Code2VecModel
    tmp_path = tmp_path_factory.mktemp('torch_bulk')
    prefix = make_dataset(tmp_path)
    reference = Code2VecModel(Config(
        TRAIN_DATA_PATH_PREFIX=str(prefix), DL_FRAMEWORK='jax',
        MESH_DEVICE_INDICES='0', TRAIN_BATCH_SIZE=16, NUM_TRAIN_EPOCHS=1,
        SHUFFLE_BUFFER_SIZE=64, VERBOSE_MODE=0, READER_USE_NATIVE=False,
        **SHARED))
    port = PortModel(PortConfig(TRAIN_DATA_PATH_PREFIX=str(prefix),
                                **SHARED),
                     device='cpu', params=to_port(reference.params))
    lines = (tmp_path / 'tiny.train.c2v').read_text().splitlines()[:35]
    # a row with no valid context: the evaluate-path filter drops it
    lines.insert(10, 'orphan|label ' + ' ' * 5)
    corpus = tmp_path / 'order.c2v'
    corpus.write_text('\n'.join(lines) + '\n')
    yield tmp_path, reference, port, corpus, lines
    memory.reset()


def _stream(model, corpus):
    chunks = list(bulk.iter_code_vector_batches(model, str(corpus),
                                                with_labels=True))
    return (np.concatenate([v for v, _l in chunks]),
            [str(label) for _v, labels in chunks for label in labels],
            chunks)


def test_code_vector_rows_align_and_match_reference(pair):
    from code2vec_tpu.serving import bulk as jax_bulk
    _tmp, reference, port, corpus, lines = pair
    kept = [line for i, line in enumerate(lines) if i != 10]
    vectors, labels, chunks = _stream(port, corpus)
    assert [v.shape[0] for v, _l in chunks] == [16, 16, 3]
    assert vectors.shape == (35, 384) and vectors.dtype == np.float32
    assert labels == [line.split()[0] for line in kept]
    want = np.concatenate([v for v, _l in jax_bulk.iter_code_vector_batches(
        reference, str(corpus))])
    np.testing.assert_allclose(vectors, want, rtol=RTOL, atol=ATOL)
    predicted = np.stack([r.code_vector for r in port.predict(
        kept, tier='vectors')])
    np.testing.assert_allclose(vectors, predicted, rtol=RTOL, atol=ATOL)
    assert all(lab is None for _v, lab in bulk.iter_code_vector_batches(
        port, str(corpus)))


@pytest.mark.parametrize('dtype', ['float32', 'float16'])
def test_export_text_equals_the_stream(pair, tmp_path, dtype):
    _tmp, _reference, port, corpus, _lines = pair
    out = tmp_path / 'out.vectors'
    n, path = bulk.export_code_vectors(port, str(corpus), str(out),
                                       dtype=dtype)
    vectors, _labels, _chunks = _stream(port, corpus)
    want = ''.join(' '.join(map(str, vec)) + '\n'
                   for vec in vectors.astype(dtype))
    assert (n, path) == (35, str(out))
    assert out.read_text() == want


@pytest.mark.parametrize('tier', ['topk', 'attention', 'full', 'vectors'])
def test_bulk_predict_equals_predict(pair, tier):
    from code2vec_tpu.serving import bulk as jax_bulk
    _tmp, reference, port, _corpus, lines = pair
    stream = lines[:13] + PREDICT_LINES
    got = list(bulk.bulk_predict(port, iter(stream), tier=tier,
                                 batch_size=8))
    want = port.predict(stream, tier=tier)
    ref = list(jax_bulk.bulk_predict(reference, stream, tier=tier,
                                     batch_size=8))
    assert len(got) == len(want) == len(ref) == len(stream)
    for g, w, r in zip(got, want, ref):
        assert g.original_name == w.original_name == r.original_name
        assert g.topk_predicted_words == w.topk_predicted_words == \
            r.topk_predicted_words
        assert g.attention_per_context.keys() == \
            r.attention_per_context.keys()
        for key, value in g.attention_per_context.items():
            assert abs(value - r.attention_per_context[key]) <= 1e-5
        for name in ('topk_predicted_words_scores', 'code_vector'):
            if getattr(r, name) is None:
                assert getattr(g, name) is None
                continue
            np.testing.assert_allclose(getattr(g, name), getattr(w, name),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(getattr(g, name), getattr(r, name),
                                       rtol=RTOL, atol=ATOL)


def _records(path):
    return [json.loads(line) for line in open(path)]


@pytest.mark.parametrize('kind', ['exact', 'ivf'])
def test_query_neighbors_file_matches_reference(pair, tmp_path, kind):
    from code2vec_tpu.config import Config
    from code2vec_tpu.index import service as jax_service
    tmp, reference, port, corpus, _lines = pair
    query = tmp / 'tiny.val.c2v'
    knobs = dict(INDEX_KIND=kind, INDEX_CLUSTERS=4, INDEX_NEIGHBORS_K=5)
    port_config = PortConfig(**knobs)
    ref_config = Config(VERBOSE_MODE=0, **knobs)
    port_index = service.build_index(
        port, port_config, source=str(corpus),
        out_dir=str(tmp_path / 'port.vecindex'))
    ref_index = jax_service.build_index(
        reference, ref_config, source=str(corpus),
        out_dir=str(tmp_path / 'ref.vecindex'))
    assert port_index.count == ref_index.count == 35
    np.testing.assert_allclose(
        store_lib.VectorStore(str(tmp_path / 'port.vecindex')).all_rows(),
        store_lib.VectorStore(str(tmp_path / 'ref.vecindex')).all_rows(),
        rtol=RTOL, atol=ATOL)
    got_n, got_path = service.query_neighbors_file(
        port, port_config, index=port_index, corpus_path=str(query),
        output_path=str(tmp_path / 'port.jsonl'))
    want_n, want_path = jax_service.query_neighbors_file(
        reference, ref_config, index=ref_index, corpus_path=str(query),
        output_path=str(tmp_path / 'ref.jsonl'))
    assert got_n == want_n == 16
    got, want = _records(got_path), _records(want_path)
    for g, w in zip(got, want):
        assert g['name'] == w['name']
        assert [(n['rank'], n['row'], n['label']) for n in g['neighbors']] \
            == [(n['rank'], n['row'], n['label']) for n in w['neighbors']]
        for gn, wn in zip(g['neighbors'], w['neighbors']):
            assert abs(gn['score'] - wn['score']) <= 1e-6


def test_build_index_from_vectors_and_word2vec(pair, tmp_path):
    _tmp, _reference, port, corpus, _lines = pair
    vectors_path = tmp_path / 'c.vectors'
    bulk.export_code_vectors(port, str(corpus), str(vectors_path))
    config = PortConfig(INDEX_QUANT='int8', INDEX_CLUSTERS=3,
                        INDEX_NEIGHBORS_K=3)
    index = service.build_index(port, config, source=str(vectors_path))
    assert index.kind == 'int8' and index.count == 35
    reopened = service.load_index(str(vectors_path) + '.vecindex', config,
                                  port)
    np.testing.assert_array_equal(reopened.search(index.store.take([4]),
                                                  3)[1][:, 0], [4])
    w2v = tmp_path / 'targets.txt'
    from code2vec_tpu_torch.vocab import VocabType
    port.save_word2vec_format(str(w2v), VocabType.Target)
    names = service.build_index(None, PortConfig(DEVICE='cpu'),
                                source=str(w2v))
    assert isinstance(names, ExactIndex)
    assert names.count == port.vocabs.target_vocab.size
    with pytest.raises(ValueError, match='needs a model'):
        service.build_index(None, PortConfig(DEVICE='cpu'),
                            source=str(corpus))


# ----------------------------------------------------------------- engine
@pytest.fixture(scope='module')
def engine_index(pair):
    tmp, _reference, port, corpus, _lines = pair
    index = service.build_index(port, PortConfig(INDEX_NEIGHBORS_K=4),
                                source=str(corpus),
                                out_dir=str(tmp / 'engine.vecindex'))
    return port, index


def test_submit_neighbors_on_vectors_and_context_lines(engine_index):
    port, index = engine_index
    with port.serving_engine(tiers=('topk', 'vectors'),
                             max_delay_ms=0.0) as engine:
        assert engine.attach_index(index) is engine
        vectors = np.stack([r.code_vector for r in port.predict(
            PREDICT_LINES, tier='vectors')])
        # k defaults to the engine's INDEX_NEIGHBORS_K
        want_v, want_i = index.search(vectors,
                                      port.config.INDEX_NEIGHBORS_K)
        by_lines = engine.predict_neighbors(PREDICT_LINES, timeout=30)
        by_vectors = engine.submit_neighbors(vectors).result(30)
        for results in (by_lines, by_vectors):
            assert len(results) == 3
            for result, v, i in zip(results, want_v, want_i):
                np.testing.assert_array_equal(result.indices, i)
                np.testing.assert_allclose(result.scores, v, rtol=RTOL,
                                           atol=ATOL)
                assert result.labels == [str(index.labels[j]) for j in i]
        assert engine.predict_neighbors([], timeout=30) == []
        assert len(engine.predict_neighbors(vectors[:1], k=2,
                                            timeout=30)[0].indices) == 2


def test_submit_neighbors_refuses_without_vectors_tier_or_index(
        engine_index):
    port, index = engine_index
    with port.serving_engine(tiers=('topk',), warmup=False) as engine:
        with pytest.raises(ValueError, match="'vectors' tier"):
            engine.attach_index(index)
    with port.serving_engine(tiers=('vectors',), warmup=False) as engine:
        with pytest.raises(RuntimeError, match='no index attached'):
            engine.submit_neighbors(PREDICT_LINES)


# -------------------------------------------------------------------- CLI
def test_cli_flags_map_to_config():
    from code2vec_tpu.config import Config
    args = ['--load', 'm/s', '--build-index', 'corpus.c2v',
            '--index-path', 'idx.vecindex', '--query-neighbors', 'q.c2v',
            '--index-kind', 'ivf', '--index-metric', 'dot',
            '--nprobe', '4', '--index-clusters', '32', '--neighbors-k', '7',
            '--vectors-dtype', 'float16', '--export_vocab_vectors', 'vocab',
            '--index-quant', 'off', '--index-rerank', '5', '--index-pq-m',
            '3', '--index-segment-rows', '9', '--index-compact-segments', '2']
    port = PortConfig().load_from_args(args)
    reference = Config().load_from_args(args)
    for name in ('BUILD_INDEX_FROM', 'INDEX_PATH', 'QUERY_NEIGHBORS_PATH',
                 'INDEX_KIND', 'INDEX_METRIC', 'INDEX_NPROBE',
                 'INDEX_CLUSTERS', 'INDEX_NEIGHBORS_K', 'VECTORS_DTYPE',
                 'EXPORT_VOCAB_VECTORS', 'INDEX_QUANT', 'INDEX_RERANK',
                 'INDEX_PQ_M', 'INDEX_SEGMENT_ROWS',
                 'INDEX_COMPACT_SEGMENTS'):
        assert getattr(port, name) == getattr(reference, name), name
    assert port.INDEX_QUANT == '' and port.INDEX_NPROBE == 4
    assert PortConfig().load_from_args(['--index-quant', 'pq']).INDEX_QUANT \
        == 'pq'


@pytest.mark.parametrize('field, value, message', [
    ('INDEX_KIND', 'flat', 'INDEX_KIND'),
    ('INDEX_METRIC', 'l2', 'INDEX_METRIC'),
    ('INDEX_NPROBE', -1, 'INDEX_NPROBE'),
    ('INDEX_NEIGHBORS_K', 0, 'INDEX_NEIGHBORS_K'),
    ('INDEX_QUANT', 'int4', 'INDEX_QUANT'),
    ('INDEX_SEGMENT_ROWS', 0, 'INDEX_SEGMENT_ROWS'),
    ('QUERY_NEIGHBORS_PATH', 'q.c2v', 'query-neighbors'),
])
def test_index_config_rules_match_reference(pair, field, value, message):
    from code2vec_tpu.config import Config
    tmp, _reference, _port, _corpus, _lines = pair
    prefix = str(tmp / 'tiny')
    for config in (PortConfig(TRAIN_DATA_PATH_PREFIX=prefix),
                   Config(TRAIN_DATA_PATH_PREFIX=prefix)):
        setattr(config, field, value)
        with pytest.raises(ValueError, match=message):
            config.verify()


def test_cli_builds_and_queries_an_index(pair, tmp_path):
    tmp, _reference, _port, corpus, _lines = pair
    save = tmp_path / 'm' / 'saved_model'
    main(['--data', str(tmp / 'tiny'), '--dtype', 'float32',
          '--batch-size', '16', '--epochs', '1', '--save', str(save)] + CPU)
    query = tmp_path / 'q.c2v'
    query.write_text((tmp / 'tiny.val.c2v').read_text())
    model = main(['--load', str(save), '--build-index', str(corpus),
                  '--index-path', str(tmp_path / 'cli.vecindex'),
                  '--query-neighbors', str(query), '--neighbors-k', '3',
                  '--dtype', 'float32', '--batch-size', '16'] + CPU)
    got = _records(str(query) + '.neighbors.jsonl')
    assert len(got) == 16 and all(len(r['neighbors']) == 3 for r in got)
    direct = service.query_neighbors_file(
        model, model.config, corpus_path=str(query),
        output_path=str(tmp_path / 'direct.jsonl'))[1]
    assert _records(direct) == got
