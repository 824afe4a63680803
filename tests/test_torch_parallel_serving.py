"""Serving placement, and predict, the bulk feed and the index across a
(data, model) mesh of ranks, against the reference on the CPU:

- the placement math (``partition_device_indices``, ``device_slice``)
  against the reference's on the conftest's 8 virtual devices, messages
  included;
- the serving mesh's placement table with the card count injected and
  worker transports stubbed (no process spawned): every worker's
  overrides carry its slice, a retired slot's slice goes to the next
  scale-up, a restart keeps its own, a full table raises
  ``PlacementError``, too few cards and thread mode are refused, and a
  worker reporting another card fails its cold start;
- one world of four gloo ranks on a (2, 2) mesh, same weights as the
  reference (``convert.py``), fp32: ``ExactIndex(mesh=)`` (cosine, dot,
  a count that is not a multiple of the data axis, k above a shard's
  rows, exact ties) against the reference's ``ExactIndex(mesh=)`` on 8
  virtual devices and the port's one-rank index (indices equal, scores
  at atol 2e-6); the bulk export of a corpus with a short final batch
  (a data shard of padding only) and rows without a valid context,
  against the reference's export on a (2, 2) mesh of virtual devices and
  the port's one-rank export (the same rows in corpus order, rtol 2e-5 /
  atol 1e-6), every rank yielding the same stream; ``predict`` on every
  rank against the one-rank results; ``build_index`` with the IVF tier's
  recall check (the chief's) and ``query_neighbors_file`` on both tiers,
  the chief's JSONL against the one-rank run's; the shell (``--predict``)
  with scripted input, the chief's report against one rank's, an end of
  input ending every rank; the CLI's ``--bulk-vectors``,
  ``--build-index`` and ``--query-neighbors`` on ``--mesh 2x2`` against
  a one-rank CLI run.
"""
import json
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest

from code2vec_tpu_torch import convert
from code2vec_tpu_torch.config import Config as PortConfig
from code2vec_tpu_torch.parallel import mesh as pmesh
from tests.test_serving_engine import PREDICT_LINES
from tests.test_torch_parallel import run_world
from tests.test_train_overfit import make_dataset

RTOL, ATOL = 2e-5, 1e-6
SCORE_ATOL = 2e-6
KNOBS = dict(MAX_CONTEXTS=6, COMPUTE_DTYPE='float32', TEST_BATCH_SIZE=8,
             SERVING_BATCH_BUCKETS='8,16', TOKEN_EMBEDDINGS_SIZE=8,
             PATH_EMBEDDINGS_SIZE=8, CODE_VECTOR_SIZE=24,
             READER_USE_NATIVE=False)
MESH = dict(MESH_DATA_AXIS_SIZE=2, MESH_MODEL_AXIS_SIZE=2)
INDEX_KNOBS = dict(INDEX_CLUSTERS=3, INDEX_NEIGHBORS_K=5)
# the CLI's model: the default widths (no flags set them), fp32
CLI = ['--dtype', 'float32', '--batch-size', '8', '--neighbors-k', '4',
       '--device', 'cpu', '-v', '0']
# (name, metric, rows, dim, k): 37 rows split 19 + 18 over the data axis,
# k above a shard's rows; integer rows with many exact ties
INDEX_CASES = (('cosine', 'cosine', 37, 24, 10), ('dot', 'dot', 37, 24, 25),
               ('ties', 'dot', 95, 8, 12))


# ------------------------------------------------------- placement math
def test_placement_math_matches_reference():
    from code2vec_tpu.parallel import mesh as jax_mesh
    for n, per in ((4, 2), (8, 1), (3, 1), (1, 8)):
        assert pmesh.partition_device_indices(n, per, total=8) == \
            jax_mesh.partition_device_indices(n, per)
    for spec in ('4,5', '0', '7,0,3'):
        assert pmesh.device_slice(spec, total=8) == \
            [d.id for d in jax_mesh.device_slice(spec)]
    for call in (lambda m, **kw: m.partition_device_indices(5, 2, **kw),
                 lambda m, **kw: m.device_slice('4,99', **kw),
                 lambda m, **kw: m.device_slice('1,1', **kw),
                 lambda m, **kw: m.device_slice('a,b', **kw),
                 lambda m, **kw: m.device_slice(' , ', **kw)):
        with pytest.raises(ValueError) as port:
            call(pmesh, total=8)
        with pytest.raises(ValueError) as reference:
            call(jax_mesh)
        assert str(port.value) == str(reference.value)


def test_bulk_paths_refuse_a_world_that_spans_hosts(monkeypatch):
    from code2vec_tpu_torch.parallel import distributed
    monkeypatch.setattr(distributed, 'spans_hosts', lambda: True)
    with pytest.raises(NotImplementedError, match='one host'):
        pmesh.require_one_host(SimpleNamespace(size=4), 'predict')
    pmesh.require_one_host(None, 'predict')


# ---------------------------------------------- the placement table
class StubWorker:
    """A worker transport that starts nothing: ready at once, reporting
    the slice its overrides name (or ``report``'s cards)."""
    spawned = []
    report = None

    def __init__(self, rid, mode, overrides, **_kwargs):
        self.rid, self.overrides = rid, dict(overrides)
        indices = overrides.get('MESH_DEVICE_INDICES') or ''
        cards = (StubWorker.report if StubWorker.report is not None
                 else [int(i) for i in indices.split(',') if i])
        self.ready_info = {'capabilities': {'devices': cards}}
        self.params_step = None
        self.pid = 0
        self.heartbeat_info, self.ledger_info = {}, {}
        self.clock = SimpleNamespace(offset=0.0, samples=0)
        self.reaped = self.closed = False
        StubWorker.spawned.append(self)

    def wait_ready(self):
        pass

    def warmup(self):
        pass

    def cancel(self):
        pass

    def reap(self):
        self.reaped = True

    kill = reap

    def close(self):
        self.closed = True


@pytest.fixture
def placed(tmp_path, monkeypatch):
    """A CPU model with a save path, four injected cards and stub
    workers."""
    from code2vec_tpu_torch.model_api import Code2VecModel
    from code2vec_tpu_torch.serving import mesh as mesh_lib
    prefix = make_dataset(tmp_path)
    monkeypatch.setattr(pmesh, 'visible_cards', lambda: 4)
    monkeypatch.setattr(mesh_lib, '_WorkerReplica', StubWorker)
    StubWorker.spawned, StubWorker.report = [], None

    def build(**knobs):
        config = PortConfig(TRAIN_DATA_PATH_PREFIX=str(prefix),
                            MODEL_SAVE_PATH=str(tmp_path / 'm' / 's'),
                            MESH_HEARTBEAT_SECS=0.0,
                            AUTOSCALE_INTERVAL_SECS=3600.0,
                            MAX_CONTEXTS=6, TOKEN_EMBEDDINGS_SIZE=8,
                            PATH_EMBEDDINGS_SIZE=8, CODE_VECTOR_SIZE=24,
                            **knobs)
        return Code2VecModel(config, device='cpu')
    return build


def _slices(mesh):
    return {s.rid: s.device_indices for s in mesh._replicas if not s.retired}


def test_placement_table_allocates_frees_and_refuses(placed):
    from code2vec_tpu_torch.serving.mesh import ServingMesh
    model = placed(MESH_DEVICES_PER_REPLICA=1, AUTOSCALE_MAX_REPLICAS=3,
                   AUTOSCALE_MIN_REPLICAS=1)
    mesh = ServingMesh(model, replicas=2, mode='process', tiers=('topk',))
    try:
        assert _slices(mesh) == {'r0': [0], 'r1': [1]}
        assert [w.overrides['MESH_DEVICE_INDICES']
                for w in StubWorker.spawned] == ['0', '1']
        stats = mesh.stats()
        assert stats['placement'] == {'devices_per_replica': 1,
                                      'slices': 3, 'data_axis': 1}
        assert [(r['devices'], r['device_indices'])
                for r in stats['replicas']] == [([0], [0]), ([1], [1])]
        # a retired slot's slice goes to the next scale-up
        mesh.retire('r0')
        assert mesh.add_replica() == 'r2'
        assert _slices(mesh) == {'r1': [1], 'r2': [0]}
        assert mesh.add_replica() == 'r3'
        assert _slices(mesh)['r3'] == [2]
        # the table (3 slices, up to AUTOSCALE_MAX_REPLICAS) is full
        with pytest.raises(pmesh.PlacementError, match='no free device'):
            mesh.add_replica()
        # a restart keeps its own slot's slice
        slot = next(s for s in mesh._replicas if s.rid == 'r3')
        spawned = len(StubWorker.spawned)
        with mesh._cond:
            slot.dead = True
            mesh._cond.notify_all()
        for _ in range(200):
            if slot.restarts:
                break
            import time
            time.sleep(0.05)
        assert slot.restarts == 1 and slot.device_indices == [2]
        assert StubWorker.spawned[spawned].overrides[
            'MESH_DEVICE_INDICES'] == '2'
    finally:
        mesh.close()


def test_placement_refusals(placed):
    from code2vec_tpu_torch.serving.mesh import ServingMesh
    model = placed(MESH_DEVICES_PER_REPLICA=1)
    # thread replicas share this process's card (the reference's message)
    with pytest.raises(ValueError, match='worker mode'):
        ServingMesh(model, replicas=1, mode='thread', tiers=('topk',))
    # more slices than cards, at build
    with pytest.raises(ValueError, match='Placement wants 5 slices x 1 '
                                         'devices but only 4 are visible'):
        ServingMesh(model, replicas=5, mode='socket', tiers=('topk',))
    # a worker that reports another card fails its cold start typed
    StubWorker.report = [3]
    with pytest.raises(pmesh.PlacementError, match='reports cards'):
        ServingMesh(model, replicas=1, mode='process', tiers=('topk',))
    assert StubWorker.spawned[-1].reaped
    # placement off: no slice shipped, none recorded
    StubWorker.report = None
    mesh = ServingMesh(placed(), replicas=1, mode='process',
                       tiers=('topk',))
    try:
        assert StubWorker.spawned[-1].overrides['MESH_DEVICE_INDICES'] == ''
        assert mesh.stats()['placement'] is None
        assert _slices(mesh) == {'r0': None}
    finally:
        mesh.close()


def test_a_worker_whose_pin_fails_fails_its_cold_start(placed):
    """A real spawned worker on a host with no card to pin to: the cold
    start fails with ``PlacementError``, it never runs elsewhere."""
    from code2vec_tpu_torch.serving import mesh as mesh_lib
    worker = mesh_lib._replica_worker_main
    import multiprocessing
    ctx = multiprocessing.get_context('spawn')
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=worker, args=(
        'r0', {'MESH_DEVICE_INDICES': '0', 'DEVICE': 'cpu'}, child, None))
    proc.start()
    child.close()
    from code2vec_tpu_torch.serving import transport as transport_lib
    channel = transport_lib.PipeTransport(parent)
    assert channel.poll(120)
    kind, reason = channel.recv()
    proc.join(60)
    assert kind == 'failed' and reason.startswith('PlacementError')
    assert 'could not pin to cards 0' in reason


# ------------------------------------------------------------- the world
def world_rank(rank, data_dir, weights, corpus, index_cases, shell_lines,
               save_path):
    import builtins
    import contextlib
    import io

    from code2vec_tpu_torch.cli import main
    from code2vec_tpu_torch.index import service
    from code2vec_tpu_torch.index.exact import ExactIndex
    from code2vec_tpu_torch.model_api import Code2VecModel
    from code2vec_tpu_torch.serving import bulk
    from code2vec_tpu_torch.serving.predict import InteractivePredictor
    prefix = os.path.join(data_dir, 'tiny')
    model = Code2VecModel(PortConfig(TRAIN_DATA_PATH_PREFIX=prefix, **MESH,
                                     **KNOBS),
                          device='cpu',
                          params=convert.params_from_numpy(weights))
    out = {'coords': (model.mesh.data_index, model.mesh.model_index),
           'chief': model.is_chief}
    out['index'], out['layout'] = {}, {}
    for name, (metric, rows, queries, k) in index_cases.items():
        index = ExactIndex(rows, mesh=model.mesh, metric=metric,
                           device='cpu', block_rows=8)
        out['index'][name] = index.search(queries, k)
        out['layout'][name] = (index.row_offset, index.shard_rows,
                               index.padded_rows,
                               tuple(index._matrix.shape),
                               index.device_nbytes)
    out['predict'] = model.predict(PREDICT_LINES + shell_lines, tier='full')
    out['stream'] = list(bulk.iter_code_vector_batches(model, corpus,
                                                       with_labels=True))
    out['export'] = bulk.export_code_vectors(
        model, corpus, os.path.join(data_dir, 'world.vectors'))
    # the IVF tier's build with its recall check (the chief's), then the
    # queries on both tiers
    for kind in ('ivf', 'exact'):
        config = PortConfig(INDEX_KIND=kind, **INDEX_KNOBS)
        path = os.path.join(data_dir, 'world.%s' % kind)
        index = service.build_index(model, config, source=corpus,
                                    out_dir=path + '.vecindex')
        out['%s_index' % kind] = type(index).__name__
        out['%s_queries' % kind] = service.query_neighbors_file(
            model, config, index=index, corpus_path=corpus,
            output_path=path + '.jsonl')[0]
    # the shell: the chief reads two turns and the end of the input
    answers = iter(['', ''])

    def scripted():
        try:
            return next(answers)
        except StopIteration:
            raise EOFError
    extractor = SimpleNamespace(extract_paths=lambda _path: (
        shell_lines, {}))
    printed = io.StringIO()
    old_input = builtins.input
    builtins.input = scripted
    try:
        with contextlib.redirect_stdout(printed):
            InteractivePredictor(model.config, model,
                                 extractor=extractor if model.is_chief
                                 else None).predict()
    finally:
        builtins.input = old_input
    out['shell'] = printed.getvalue()
    # the CLI's bulk and index flags over the joined world
    cli_corpus = os.path.join(data_dir, 'cli', 'corpus.c2v')
    main(['--load', save_path, '--mesh', '2x2'] + CLI + [
        '--bulk-vectors', cli_corpus, '--build-index', cli_corpus,
        '--query-neighbors', cli_corpus])
    return out


def _records(path):
    return [json.loads(line) for line in open(path)]


def _same_records(got_path, want_path):
    got, want = _records(got_path), _records(want_path)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g['name'] == w['name']
        assert [(n['rank'], n['row'], n.get('label'))
                for n in g['neighbors']] == \
            [(n['rank'], n['row'], n.get('label')) for n in w['neighbors']]
        for gn, wn in zip(g['neighbors'], w['neighbors']):
            assert abs(gn['score'] - wn['score']) <= SCORE_ATOL


def _index_cases():
    cases = {}
    for i, (name, metric, rows, dim, k) in enumerate(INDEX_CASES):
        rng = np.random.default_rng(40 + i)
        if name == 'ties':
            vecs = rng.integers(0, 2, (rows, dim)).astype(np.float32)
            queries = rng.integers(0, 2, (6, dim)).astype(np.float32)
        else:
            vecs = rng.normal(size=(rows, dim)).astype(np.float32)
            queries = rng.normal(size=(13, dim)).astype(np.float32)
        cases[name] = (metric, vecs, queries, k)
    return cases


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The reference on a (2, 2) mesh of virtual devices, the port on one
    rank with its weights, and the port's (2, 2) world of gloo ranks."""
    from code2vec_tpu.config import Config
    from code2vec_tpu.model_api import Code2VecModel as JaxModel
    from code2vec_tpu_torch.model_api import Code2VecModel
    tmp = tmp_path_factory.mktemp('parallel_serving')
    prefix = make_dataset(tmp)
    reference = JaxModel(Config(
        TRAIN_DATA_PATH_PREFIX=str(prefix), DL_FRAMEWORK='jax',
        MESH_DEVICE_INDICES='0,1,2,3', TRAIN_BATCH_SIZE=16,
        NUM_TRAIN_EPOCHS=1, SHUFFLE_BUFFER_SIZE=64, VERBOSE_MODE=0,
        **MESH, **KNOBS))
    assert reference.mesh.shape == {'data': 2, 'model': 2}
    weights = {k: np.array(v) for k, v in reference.params._asdict().items()}
    one = Code2VecModel(PortConfig(TRAIN_DATA_PATH_PREFIX=str(prefix),
                                   **KNOBS),
                        device='cpu', params=convert.params_from_numpy(
                            {k: v.copy() for k, v in weights.items()}))
    # 27 kept rows and two without a valid context: batches of 8, 8, 8
    # and 3, whose second data shard is padding only
    lines = (tmp / 'tiny.train.c2v').read_text().splitlines()[:27]
    lines.insert(4, 'orphan|label ' + ' ' * 5)
    lines.insert(20, 'lost|label ' + ' ' * 5)
    corpus = tmp / 'order.c2v'
    corpus.write_text('\n'.join(lines) + '\n')
    shell_lines = (tmp / 'tiny.val.c2v').read_text().splitlines()[:5]
    # the checkpoint the CLI loads (the default widths), and its corpus
    save = tmp / 'model' / 'saved'
    saver = Code2VecModel(PortConfig(
        TRAIN_DATA_PATH_PREFIX=str(prefix), MODEL_SAVE_PATH=str(save),
        COMPUTE_DTYPE='float32'), device='cpu', seed=3)
    saver.state = saver.trainer.state_from_params()
    saver.save()
    for name in ('cli', 'one'):
        (tmp / name).mkdir()
        (tmp / name / 'corpus.c2v').write_text(corpus.read_text())
    index_cases = _index_cases()
    ranks = run_world(
        'tests.test_torch_parallel_serving:world_rank', 4, tmp,
        kwargs=dict(data_dir=str(tmp), weights=weights, corpus=str(corpus),
                    index_cases=index_cases, shell_lines=shell_lines,
                    save_path=str(save)))
    yield SimpleNamespace(tmp=tmp, reference=reference, one=one,
                          corpus=corpus, lines=lines, ranks=ranks,
                          index_cases=index_cases, shell_lines=shell_lines,
                          save=save)
    from code2vec_tpu_torch.telemetry import memory
    memory.reset()


@pytest.mark.parametrize('case', [name for name, *_rest in INDEX_CASES])
def test_exact_index_on_the_world_matches_reference(world, case):
    from code2vec_tpu.config import Config
    from code2vec_tpu.index.exact import ExactIndex as JaxExactIndex
    from code2vec_tpu.parallel import mesh as jax_mesh
    from code2vec_tpu_torch.index.exact import ExactIndex
    metric, rows, queries, k = world.index_cases[case]
    sharded = jax_mesh.create_mesh(Config(MODEL_LOAD_PATH='unused'))
    assert sharded.shape['data'] == 8
    want_v, want_i = JaxExactIndex(rows, mesh=sharded, metric=metric).search(
        queries, k)
    one_v, one_i = ExactIndex(rows, metric=metric, device='cpu',
                              block_rows=8).search(queries, k)
    np.testing.assert_array_equal(one_i, want_i)
    for out in world.ranks:
        got_v, got_i = out['index'][case]
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_v, want_v, rtol=0, atol=SCORE_ATOL)
        np.testing.assert_allclose(got_v, one_v, rtol=0, atol=SCORE_ATOL)


def test_exact_index_shards_rows_over_the_data_axis(world):
    """Rank (d, m) holds rows [d N_pad / D, (d + 1) N_pad / D) of the
    padded store, the padding unplaced, and is charged for its shard."""
    for out in world.ranks:
        d = out['coords'][0]
        for name, (rows, per, lo, n) in (('dot', (37, 19, 19 * d,
                                                  19 - d)),
                                         ('ties', (95, 48, 48 * d,
                                                   48 - d))):
            dim = world.index_cases[name][1].shape[1]
            assert out['layout'][name] == (lo, per, 2 * per, (n, dim),
                                           n * dim * 4)


def test_bulk_export_on_the_world_matches_reference_and_one_rank(world):
    from code2vec_tpu.serving import bulk as jax_bulk
    from code2vec_tpu_torch.serving import bulk
    kept = [line for line in world.lines if 'orphan' not in line
            and 'lost' not in line]
    want_path = world.tmp / 'reference.vectors'
    jax_bulk.export_code_vectors(world.reference, str(world.corpus),
                                 output_path=str(want_path))
    one_path = world.tmp / 'one.vectors'
    assert bulk.export_code_vectors(world.one, str(world.corpus),
                                    str(one_path))[0] == 27
    got = np.loadtxt(world.tmp / 'world.vectors', dtype=np.float32)
    assert got.shape == (27, 24)
    np.testing.assert_allclose(got, np.loadtxt(want_path, dtype=np.float32),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.loadtxt(one_path, dtype=np.float32),
                               rtol=RTOL, atol=ATOL)
    # every rank yields the same stream, in corpus order, the short final
    # batch's padding left out
    stream = world.ranks[0]['stream']
    assert [v.shape[0] for v, _l in stream] == [8, 8, 8, 3]
    assert [str(label) for _v, labels in stream for label in labels] == \
        [line.split()[0] for line in kept]
    for out in world.ranks:
        assert out['export'] == (27, str(world.tmp / 'world.vectors'))
        for (v, labels), (v0, labels0) in zip(out['stream'], stream):
            np.testing.assert_array_equal(v, v0)
            assert list(labels) == list(labels0)


def test_predict_on_the_world_returns_the_one_rank_results(world):
    lines = PREDICT_LINES + world.shell_lines
    want = world.one.predict(lines, tier='full')
    for out in world.ranks:
        got = out['predict']
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            assert g.original_name == w.original_name
            assert g.topk_predicted_words == w.topk_predicted_words
            assert g.attention_per_context.keys() == \
                w.attention_per_context.keys()
            for key, value in g.attention_per_context.items():
                assert abs(value - w.attention_per_context[key]) <= 1e-5
            np.testing.assert_allclose(g.topk_predicted_words_scores,
                                       w.topk_predicted_words_scores,
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(g.code_vector, w.code_vector,
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('kind', ['ivf', 'exact'])
def test_index_build_and_queries_on_the_world_match_one_rank(world, kind):
    from code2vec_tpu_torch.index import service
    config = PortConfig(INDEX_KIND=kind, **INDEX_KNOBS)
    path = world.tmp / ('one.%s' % kind)
    index = service.build_index(world.one, config,
                                source=str(world.corpus),
                                out_dir=str(path) + '.vecindex')
    service.query_neighbors_file(world.one, config, index=index,
                                 corpus_path=str(world.corpus),
                                 output_path=str(path) + '.jsonl')
    _same_records(str(world.tmp / ('world.%s.jsonl' % kind)),
                  str(path) + '.jsonl')
    names = {'ivf': 'IVFIndex', 'exact': 'ExactIndex'}
    for out in world.ranks:
        assert out['%s_queries' % kind] == 27
        assert out['%s_index' % kind] == (
            names[kind] if out['chief'] or kind == 'exact' else '_ChiefOnly')


def test_shell_on_the_world_prints_the_one_rank_report(world):
    import builtins
    import contextlib
    import io

    from code2vec_tpu_torch.serving.predict import InteractivePredictor
    answers = iter(['', '', 'q'])
    printed = io.StringIO()
    old = builtins.input
    builtins.input = lambda: next(answers)
    try:
        with contextlib.redirect_stdout(printed):
            InteractivePredictor(world.one.config, world.one,
                                 extractor=SimpleNamespace(
                                     extract_paths=lambda _p: (
                                         world.shell_lines, {}))).predict()
    finally:
        builtins.input = old
    chief = next(out for out in world.ranks if out['chief'])
    # the end of the input ended the world's shell where 'q' ends this one
    got, want = chief['shell'].splitlines(), printed.getvalue().splitlines()
    assert len(got) == len(want) and chief['shell'].count(
        'Original name:') == 10
    number = re.compile(r'-?\d+\.\d+')
    for g, w in zip(got, want):
        assert number.sub('#', g) == number.sub('#', w)
        np.testing.assert_allclose(
            [float(x) for x in number.findall(g)],
            [float(x) for x in number.findall(w)], rtol=0, atol=2e-6)
    assert all(out['shell'] == '' for out in world.ranks if not out['chief'])


def test_cli_bulk_and_index_flags_on_the_world_match_one_rank(world):
    from code2vec_tpu_torch.cli import main
    one = world.tmp / 'one' / 'corpus.c2v'
    main(['--load', str(world.save)] + CLI + [
        '--bulk-vectors', str(one), '--build-index', str(one),
        '--query-neighbors', str(one)])
    cli = world.tmp / 'cli' / 'corpus.c2v'
    np.testing.assert_allclose(
        np.loadtxt(str(cli) + '.vectors', dtype=np.float32),
        np.loadtxt(str(one) + '.vectors', dtype=np.float32),
        rtol=RTOL, atol=ATOL)
    _same_records(str(cli) + '.neighbors.jsonl',
                  str(one) + '.neighbors.jsonl')
