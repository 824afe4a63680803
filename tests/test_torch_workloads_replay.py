"""The port's scenario traffic plane, mesh half (code2vec_tpu_torch/
serving/mesh.py's ``submit_blended``, ``record_traffic`` and
``rollover_index`` with code2vec_tpu_torch/workloads/), against the
reference's mesh (code2vec_tpu/serving/mesh.py) on the same weights
(``convert.py``), on the CPU:

- retrieval-blended naming: the typed no-index fallback, weight 0 bit for
  bit the port's ``topk``, weight 0.5 within rtol 2e-5 / atol 1e-6 of the
  reference's blend with the same ranking, and bit for bit ``blend_row``
  over the mesh's own legs;
- the traffic tap, a save and a replay: the report's admitted set,
  deliveries, exact match and F1 equal to the reference's on the same
  profile; replay determinism; a mixed stream with no capture after
  warm-up; the port's timeline of the open loop; the scenario on the
  port's spans as latency_report.py reads it;
- the canaried index rollover: tests/test_serving_memo.py's swap,
  rollback, candidate-error and validation cases and the memo's
  stand-down, each run on both meshes with the same outcome and
  ``index/*`` metrics.

The full synthetic paced drill is marked slow, as the reference's.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

from code2vec_tpu.config import Config as RefConfig
from code2vec_tpu.telemetry import core as ref_core
from code2vec_tpu.workloads import profile as ref_profile
from code2vec_tpu.workloads import replay as ref_replay
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.index.service import neighbors_from_search
from code2vec_tpu_torch.model_api import Code2VecModel as PortModel
from code2vec_tpu_torch.telemetry import core
from code2vec_tpu_torch.telemetry import tracing as tracing_lib
from code2vec_tpu_torch.workloads import blend as blend_lib
from code2vec_tpu_torch.workloads import profile as profile_lib
from code2vec_tpu_torch.workloads import replay as replay_lib
from tests.test_torch_memo import FakeIndex, assert_rows_identical
from tests.test_serving_memo import (_BoomIndex as BoomIndex,
                                     _CountingIndex as CountingIndex,
                                     _WorstIndex as WorstIndex)
from tests.test_torch_model import to_port
from tests.test_train_overfit import make_dataset

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-5, 1e-6
JAVA_LINES = [
    'get|a toka0,pA,toka1 toka1,pB,toka2',
    'run|c tokc0,pC,tokc1 tokc2,pA,tokc0',
]
CSHARP_LINES = [
    'set|b tokb0,pA,tokb1',
    'read|d tokd0,pB,tokd1 tokd1,pC,tokd2',
]
PREDICT_LINES = JAVA_LINES[:1] + CSHARP_LINES[:1] + [
    'run|c tokc0,pC,tokc1 tokc2,pA,tokc0 tokc1,pB,tokc2']
#: the fields of a replay cell that do not depend on timing or the memo
CELL_FIELDS = ('requests', 'delivered', 'shed', 'errors', 'scored',
               'exact_match', 'f1', 'precision', 'recall')
SHARED = dict(COMPUTE_DTYPE='float32', MAX_CONTEXTS=6,
              SERVING_BATCH_BUCKETS='8',
              # SLO targets on, generous: the report carries the burn per
              # scenario
              SERVING_SLO_AVAILABILITY=0.5, SERVING_SLO_P99_MS=60_000.0)


def _mixed_records():
    """A mixed Java and C# profile over the predict and blend entry
    points, its labels the line heads."""
    records = []
    t = 0.0
    for name, language, lines in (('java_naming', 'java', JAVA_LINES),
                                  ('csharp_naming', 'csharp', CSHARP_LINES)):
        for line in lines:
            records.append({'t': t, 'scenario': name, 'language': language,
                            'lines': [line], 'label': line.split(' ', 1)[0]})
            t += 0.001
    for line, language in ((JAVA_LINES[0], 'java'),
                           (CSHARP_LINES[0], 'csharp')):
        records.append({'t': t, 'scenario': 'retrieval_naming',
                        'language': language, 'lines': [line],
                        'label': line.split(' ', 1)[0], 'weight': 0.5,
                        'k': 4})
        t += 0.001
    return records


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    """The reference model and the port's model over its weights."""
    from code2vec_tpu.model_api import Code2VecModel
    prefix = make_dataset(tmp_path_factory.mktemp('torch_workloads'))
    reference = Code2VecModel(RefConfig(
        TRAIN_DATA_PATH_PREFIX=str(prefix), DL_FRAMEWORK='jax',
        MESH_DEVICE_INDICES='0', TRAIN_BATCH_SIZE=16, TEST_BATCH_SIZE=16,
        NUM_TRAIN_EPOCHS=1, SHUFFLE_BUFFER_SIZE=64, VERBOSE_MODE=0,
        READER_USE_NATIVE=False, **SHARED))
    port = PortModel(Config(TRAIN_DATA_PATH_PREFIX=str(prefix), **SHARED),
                     device='cpu', params=to_port(reference.params))
    return port, reference


@pytest.fixture
def telemetry():
    """Both packages' registries on, fresh, for one test."""
    for lib in (core, ref_core):
        lib.reset()
        lib.enable()
    yield
    for lib in (core, ref_core):
        lib.disable()
        lib.reset()


@pytest.fixture(scope='module')
def meshes(pair):
    """One warmed mesh per package with an index attached, shared by the
    drills (the memo's answers are bit for bit the live ones)."""
    port_model, ref_model = pair
    out = []
    try:
        for model in (port_model, ref_model):
            mesh = model.serving_mesh(replicas=1, tiers=('topk', 'vectors'),
                                      memo_cache_bytes=8 << 20)
            out.append(mesh)
            dim = mesh.predict([JAVA_LINES[0]], tier='vectors',
                               timeout=60)[0].code_vector.shape[0]
            mesh.attach_index(FakeIndex(dim=dim))
        yield tuple(out)
    finally:
        for mesh in out:
            mesh.close()


def _fresh_meshes(pair, **kwargs):
    """A port mesh and a reference mesh of one replica, topk and vectors,
    no batching delay, a 32 MiB memo."""
    return [model.serving_mesh(replicas=1, tiers=('topk', 'vectors'),
                               max_delay_ms=0.0, memo_cache_bytes=32 << 20,
                               **kwargs) for model in pair]


def _close_blends(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.original_name, g.source, g.weight) == \
            (w.original_name, w.source, w.weight)
        assert g.predicted_words == w.predicted_words
        np.testing.assert_allclose(g.predicted_scores, w.predicted_scores,
                                   rtol=RTOL, atol=ATOL)


# ------------------------------------------------------ blended naming
def test_blend_fallback_without_index(pair, telemetry):
    """No attached index degrades typed (``softmax_fallback`` and its
    counter), as the reference's, never an error."""
    port_model, ref_model = pair
    rows = {}
    for model, lib in ((port_model, core), (ref_model, ref_core)):
        mesh = model.serving_mesh(replicas=1, tiers=('topk',),
                                  memo_cache_bytes=4 << 20)
        try:
            rows[lib] = mesh.submit_blended(JAVA_LINES).result(60)
            snap = lib.registry().snapshot()
            assert snap.get('mesh/blend_fallback_total', 0) == 1
            assert snap.get('mesh/blend_requests_total', 0) == 1
            with pytest.raises(ValueError) as err:
                mesh.submit_blended(JAVA_LINES, weight=1.5)
            rows[lib, 'error'] = str(err.value)
        finally:
            mesh.close()
    got = rows[core]
    assert [r.source for r in got] == [blend_lib.SOURCE_FALLBACK] * 2
    for row in got:
        # the softmax row untouched
        np.testing.assert_array_equal(row.predicted_scores,
                                      row.base.topk_predicted_words_scores)
        assert row.neighbors is None
    _close_blends(got, rows[ref_core])
    assert rows[core, 'error'] == rows[ref_core, 'error']


def test_blend_weight_zero_is_bit_identical_to_topk(meshes):
    mesh = meshes[0]
    plain = mesh.submit(CSHARP_LINES).result(60)
    wrapped = mesh.submit_blended(CSHARP_LINES, weight=0.0).result(60)
    assert_rows_identical([r.base for r in wrapped], plain)
    for row, base in zip(wrapped, plain):
        # the index is attached: the passthrough, not the fallback
        assert row.source == blend_lib.SOURCE_SOFTMAX
        assert row.predicted_words == list(base.topk_predicted_words)
        np.testing.assert_array_equal(row.predicted_scores,
                                      base.topk_predicted_words_scores)
    # a blend served from the memo is bit for bit the live one
    live = mesh.submit_blended(CSHARP_LINES, weight=0.25, k=4).result(60)
    memo_hits = mesh.stats()['memo']['hits']
    cached = mesh.submit_blended(CSHARP_LINES, weight=0.25, k=4).result(60)
    assert mesh.stats()['memo']['hits'] == memo_hits + 1
    for a, b in zip(cached, live):
        assert a.predicted_words == b.predicted_words
        np.testing.assert_array_equal(a.predicted_scores, b.predicted_scores)
        assert_rows_identical([a.base], [b.base])


def test_blend_half_weight_matches_reference_and_blend_row(meshes):
    port, reference = meshes
    lines = JAVA_LINES + CSHARP_LINES
    got = port.submit_blended(lines, weight=0.5, k=4).result(60)
    want = reference.submit_blended(lines, weight=0.5, k=4).result(60)
    assert all(r.source == blend_lib.SOURCE_BLEND for r in got)
    _close_blends(got, want)
    for g, w in zip(got, want):
        assert list(g.neighbors.labels) == list(w.neighbors.labels)
    # bit for bit the blend of the mesh's own legs, searched on the host
    base = port.submit(lines, tier='topk').result(60)
    vectors = np.stack([r.code_vector for r in port.submit(
        lines, tier='vectors').result(60)])
    values, indices = port._index.search(vectors, 4)
    nbrs = neighbors_from_search(values, indices, port._index.labels)
    for row, b, n in zip(got, base, nbrs):
        want_row = blend_lib.blend_row(b, n, 0.5)
        assert row.predicted_words == want_row.predicted_words
        np.testing.assert_array_equal(row.predicted_scores,
                                      want_row.predicted_scores)


# ------------------------------------------- record, save and replay
def test_record_then_replay_round_trip(meshes, tmp_path, telemetry):
    """Live traffic -> the admission tap -> a durable profile -> a replay
    on both meshes, joined per scenario and language."""
    port, reference = meshes
    recorder = profile_lib.ProfileRecorder()
    port.record_traffic(recorder)
    try:
        futures = [
            port.submit([JAVA_LINES[0]], scenario='java_naming',
                        language='java'),
            port.submit([CSHARP_LINES[0]], scenario='csharp_naming',
                        language='csharp'),
            port.submit_blended([JAVA_LINES[1]], weight=0.5, k=4,
                                scenario='retrieval_naming',
                                language='java'),
            port.submit([CSHARP_LINES[1]]),  # unlabeled: the default name
            port.submit_neighbors([CSHARP_LINES[1]], k=3),
        ]
        for future in futures:
            future.result(60)
    finally:
        port.record_traffic(None)
    records = recorder.records()
    # one record per caller-visible request: the blend's legs and the
    # neighbor query's vectors leg never record on their own
    assert [r['scenario'] for r in records] == [
        'java_naming', 'csharp_naming', 'retrieval_naming',
        'softmax_naming', 'neighbor_search']
    assert records[2]['weight'] == 0.5 and records[2]['k'] == 4
    assert records[4]['k'] == 3 and 'tier' not in records[4]
    assert records[0]['label'] == 'get|a' and records[3]['tier'] == 'topk'
    path = str(tmp_path / 'recorded.jsonl')
    assert recorder.save(path) == 5
    header, loaded = ref_profile.read_profile(path)   # the reference reads it
    assert header['source'] == 'recorded' and loaded == records
    report = replay_lib.replay(port, loaded, pace=False)
    want = ref_replay.replay(reference, loaded, pace=False)
    assert report['admitted'] == want['admitted'] == 5
    assert report['fingerprint'] == want['fingerprint']
    assert report['scenarios'].keys() == want['scenarios'].keys()
    for name, cells in report['scenarios'].items():
        assert cells.keys() == want['scenarios'][name].keys()
        for language, cell in cells.items():
            other = want['scenarios'][name][language]
            assert cell['delivered'] == cell['requests'] == 1
            for key in CELL_FIELDS:
                assert cell[key] == other[key], (name, language, key)
    # the requests were served live once already: the replay is memo
    # traffic, seen in the hit rate per scenario
    assert report['scenarios']['java_naming']['java']['memo_hit_rate'] == 1.0
    assert report['slo']['scenarios']['java_naming']['good'] >= 1
    assert core.registry().counter('workloads/replayed_total').value == 5
    assert core.registry().counter('workloads/recorded_total').value == 5


def test_replay_determinism_bit_identical_results(meshes):
    """The same profile and seed: the reference's admitted set and, run
    twice, bit for bit the same results."""
    port = meshes[0]
    records = _mixed_records()
    plan = replay_lib.plan_replay(records, rate_scale=4.0, seed=11)
    assert replay_lib.admitted_fingerprint(plan) == \
        ref_replay.admitted_fingerprint(
            ref_replay.plan_replay(records, rate_scale=4.0, seed=11))

    def run():
        out = []
        for _t, record in plan:
            if record['scenario'] == 'retrieval_naming':
                row = port.submit_blended(
                    record['lines'], weight=record['weight'], k=record['k'],
                    scenario='retrieval_naming',
                    language=record['language']).result(60)[0]
                out.append((row.predicted_words, row.predicted_scores))
            else:
                row = port.submit(record['lines'],
                                  scenario=record['scenario'],
                                  language=record['language']).result(60)[0]
                out.append((row.topk_predicted_words,
                            row.topk_predicted_words_scores))
        return out

    for (words_a, scores_a), (words_b, scores_b) in zip(run(), run()):
        assert list(words_a) == list(words_b)
        np.testing.assert_array_equal(scores_a, scores_b)
    rep_a = replay_lib.replay(port, records, rate_scale=4.0, seed=11,
                              pace=False)
    rep_b = replay_lib.replay(port, records, rate_scale=4.0, seed=11,
                              pace=False)
    assert rep_a['fingerprint'] == rep_b['fingerprint'] == \
        replay_lib.admitted_fingerprint(plan)
    for name, cells in rep_a['scenarios'].items():
        for language, cell in cells.items():
            for key in CELL_FIELDS:
                assert cell[key] == rep_b['scenarios'][name][language][key]


def test_mixed_stream_no_capture_after_warmup(meshes, telemetry):
    """Java and C# records ride the same warmed keys: a replay of the
    mixed stream, paced, captures and builds nothing."""
    port = meshes[0]
    compiles = core.registry().counter('jit/compiles_total')
    port.submit([JAVA_LINES[0]]).result(60)
    port.submit_blended([JAVA_LINES[0]], weight=0.5, k=4).result(60)
    warm = compiles.value
    report = replay_lib.replay(port, _mixed_records(), rate_scale=2.0)
    assert compiles.value == warm
    for stats in port.replica_stats():
        assert stats['graph_captures_after_warmup'] == 0
    assert report['admitted'] == 6
    cells = report['scenarios']
    assert cells['java_naming']['java']['delivered'] == 2
    assert cells['csharp_naming']['csharp']['delivered'] == 2
    assert cells['retrieval_naming']['java']['delivered'] == 1
    assert cells['retrieval_naming']['csharp']['delivered'] == 1
    for cell in (c for langs in cells.values() for c in langs.values()):
        assert cell['p99_ms'] >= cell['p50_ms'] >= 0.0


def test_replay_timeline_counts_the_open_loop(meshes):
    """The report's timeline on a live mesh (the reference's report has
    none): every admitted request sent and answered, the rates the counts
    over the submission window, nothing left once the drain ends."""
    port = meshes[0]
    records = _mixed_records()
    report = replay_lib.replay(port, records, rate_scale=0.5, seed=3)
    line = report['timeline']
    assert line['sent'] == report['admitted'] == 6
    assert line['planned_s'] == pytest.approx(records[-1]['t'] / 0.5)
    assert line['window_s'] >= line['planned_s']
    assert line['offered_rps'] == pytest.approx(6 / line['window_s'])
    assert line['delivered_rps'] == pytest.approx(
        line['delivered_in_window'] / line['window_s'])
    delivered = sum(cell['delivered'] for langs in
                    report['scenarios'].values() for cell in langs.values())
    assert delivered == 6
    # nothing failed: the backlog at the window's end is what it left
    # to the drain
    assert line['backlog_end'] == 6 - line['delivered_in_window']
    assert 0 <= line['backlog_mid'] <= 6 and line['drain_s'] >= 0.0


def test_scenario_on_the_port_spans(pair, tmp_path):
    """The scenario rides the trace root of each entry point, where
    scripts/latency_report.py finds it."""
    sys.path.insert(0, str(REPO / 'scripts'))
    try:
        import latency_report
    finally:
        sys.path.remove(str(REPO / 'scripts'))
    tracer = tracing_lib.Tracer(str(tmp_path), sample_rate=1.0)
    mesh = pair[0].serving_mesh(replicas=1, tiers=('topk', 'vectors'),
                                tracer=tracer)
    try:
        mesh.attach_index(FakeIndex(dim=pair[0].backend.params
                                    .transform.shape[1]))
        mesh.submit([JAVA_LINES[0]], scenario='java_naming').result(60)
        mesh.submit_neighbors([JAVA_LINES[1]],
                              scenario='neighbor_search').result(60)
        mesh.submit_blended([CSHARP_LINES[0]], scenario='retrieval_naming',
                            k=4).result(60)
        mesh.submit([CSHARP_LINES[1]]).result(60)
    finally:
        mesh.close()
        tracer.close()
    traces = latency_report.group_traces(
        latency_report.load_spans(str(tmp_path / 'spans.jsonl')))
    found = sorted(latency_report.trace_scenario(t) for t in traces.values())
    # the blend's two legs are traced requests of its scenario
    assert found == ['-', 'java_naming', 'neighbor_search',
                     'retrieval_naming', 'retrieval_naming']


# ------------------------------------------------------ index rollover
def _drive(mesh, handle, lines):
    for _ in range(12):
        if handle.done():
            break
        mesh.submit_neighbors(lines, k=4).result(60)
    return handle


def _swap_drill(mesh):
    vec = mesh.predict([PREDICT_LINES[0]], tier='vectors',
                       timeout=60)[0].code_vector
    live = CountingIndex(FakeIndex(dim=vec.shape[0]))
    mesh.attach_index(live)
    mesh.submit_neighbors(PREDICT_LINES, k=4).result(60)
    searches = live.searches
    mesh.submit_neighbors(PREDICT_LINES, k=4).result(60)
    assert live.searches == searches            # served from the memo
    mesh.predict(PREDICT_LINES, tier='topk', timeout=60)
    blend = mesh.submit_blended(PREDICT_LINES, weight=0.5, k=4).result(60)
    before = mesh.stats()
    # the same seed: the same store, agreement 1.0
    cand = CountingIndex(FakeIndex(dim=vec.shape[0]))
    handle = mesh.rollover_index(cand, shadow_queries=1, min_agreement=0.9)
    # a blend during the rollover runs live (its neighbor leg feeds the
    # shadow), bit for bit the memo's answer from before
    during = mesh.submit_blended(PREDICT_LINES, weight=0.5, k=4).result(60)
    for a, b in zip(during, blend):
        assert a.predicted_words == b.predicted_words
    # the shadow driven by another query than the probe's key
    report = _drive(mesh, handle, [PREDICT_LINES[0]]).result(timeout=60)
    after = mesh.stats()
    # the pre-swap neighbor entry never serves again; the predict entry
    # stays
    searches = cand.searches
    mesh.submit_neighbors(PREDICT_LINES, k=4).result(60)
    assert cand.searches > searches
    assert mesh.submit(PREDICT_LINES, tier='topk').done()
    assert mesh._index is cand
    return report, before, after


def _rollback_drill(mesh):
    vec = mesh.predict([PREDICT_LINES[0]], tier='vectors',
                       timeout=60)[0].code_vector
    live = CountingIndex(FakeIndex(dim=vec.shape[0]))
    mesh.attach_index(live)
    first = mesh.submit_neighbors(PREDICT_LINES, k=4).result(60)
    before = mesh.stats()
    handle = mesh.rollover_index(WorstIndex(dim=vec.shape[0]),
                                 shadow_queries=1, min_agreement=0.9)
    report = _drive(mesh, handle, PREDICT_LINES).result(timeout=60)
    after = mesh.stats()
    # the neighbor memo stays warm: the duplicate searches nothing
    searches = live.searches
    warm = mesh.submit_neighbors(PREDICT_LINES, k=4).result(60)
    assert live.searches == searches and mesh._index is live
    assert [r.labels for r in warm] == [r.labels for r in first]
    return report, before, after


def _error_drill(mesh):
    messages = []
    with pytest.raises(RuntimeError) as err:
        mesh.rollover_index(FakeIndex(dim=4))   # nothing attached yet
    messages.append(str(err.value))
    vec = mesh.predict([PREDICT_LINES[0]], tier='vectors',
                       timeout=60)[0].code_vector
    mesh.attach_index(FakeIndex(dim=vec.shape[0]))
    for kwargs in ({'candidate': FakeIndex(dim=vec.shape[0]),
                    'shadow_queries': 0},
                   {'candidate': None}, {'candidate': 3}):
        with pytest.raises(ValueError) as err:
            mesh.rollover_index(**kwargs)
        messages.append(str(err.value))
    first = mesh.submit_neighbors(PREDICT_LINES, k=4).result(60)
    handle = mesh.rollover_index(BoomIndex(), shadow_queries=1)
    with pytest.raises(RuntimeError) as err:
        mesh.rollover_index(FakeIndex(dim=vec.shape[0]))   # one at a time
    messages.append(str(err.value))
    _drive(mesh, handle, PREDICT_LINES)
    with pytest.raises(RuntimeError, match='cannot answer'):
        handle.result(timeout=60)
    after = mesh.stats()
    again = mesh.submit_neighbors(PREDICT_LINES, k=4).result(60)
    assert [r.labels for r in again] == [r.labels for r in first]
    return messages, after


def _index_stats(stats):
    return {key: stats[key] for key in (
        'index_version', 'index_rollover_total',
        'index_rollover_rollbacks_total')}


@pytest.mark.parametrize('drill', ['swap', 'rollback', 'error'])
def test_index_rollover_as_reference(pair, drill, telemetry):
    """Each drill on the port's mesh and on the reference's: the same
    report, index version, counters and memo generations."""
    outcomes = []
    for mesh in _fresh_meshes(pair):
        try:
            if drill == 'swap':
                report, before, after = _swap_drill(mesh)
                assert report['swapped'] is True
                assert report['index_version'] == \
                    before['index_version'] + 1
                assert after['memo']['index_generation'] == \
                    before['memo']['index_generation'] + 1
                assert after['memo']['generation'] == \
                    before['memo']['generation']
                outcomes.append((report, _index_stats(after)))
            elif drill == 'rollback':
                report, before, after = _rollback_drill(mesh)
                assert report['swapped'] is False
                assert report['agreement'] == pytest.approx(0.0)
                assert after['memo']['index_generation'] == \
                    before['memo']['index_generation']
                outcomes.append((report, _index_stats(after)))
            else:
                messages, after = _error_drill(mesh)
                outcomes.append((messages, _index_stats(after)))
        finally:
            mesh.close()
    assert outcomes[0] == outcomes[1]
    snaps = [lib.registry().snapshot() for lib in (core, ref_core)]
    names = ('index/rollovers_total', 'index/rollover_rollbacks_total',
             'index/rollover_agreement')
    assert [{n: s.get(n) for n in names} for s in snaps][0] == \
        [{n: s.get(n) for n in names} for s in snaps][1]
    if drill == 'swap':
        assert snaps[0]['index/rollovers_total'] == 1
    else:
        assert snaps[0]['index/rollover_rollbacks_total'] == 1


def test_memo_stands_down_during_index_rollover(pair):
    """While an index rollover is armed, neighbor duplicates (exact and
    semantic tiers) and blends run live on both meshes: answers from the
    cache would starve the shadow."""
    counts = []
    for mesh in _fresh_meshes(pair, memo_semantic_epsilon=0.05):
        try:
            vec = mesh.predict([PREDICT_LINES[0]], tier='vectors',
                               timeout=60)[0].code_vector
            live = CountingIndex(FakeIndex(dim=vec.shape[0]))
            mesh.attach_index(live)
            mesh.submit_neighbors(PREDICT_LINES, k=4).result(60)
            mesh.submit_neighbors(vec, k=4).result(60)
            mesh.submit_blended(PREDICT_LINES, k=4).result(60)
            searches = live.searches
            mesh.submit_neighbors(PREDICT_LINES, k=4).result(60)
            mesh.submit_blended(PREDICT_LINES, k=4).result(60)
            assert live.searches == searches    # warm: from the cache
            serves = mesh.stats()['memo']['semantic']['serves']
            # an armed state that never concludes ('concluding')
            mesh._index_rollover = {'concluding': True}
            try:
                mesh.submit_neighbors(PREDICT_LINES, k=4).result(60)
                mesh.submit_neighbors(vec * np.float32(1.00001),
                                      k=4).result(60)
                mesh.submit_blended(PREDICT_LINES, k=4).result(60)
                assert live.searches == searches + 3
                assert mesh.stats()['memo']['semantic']['serves'] == serves
            finally:
                mesh._index_rollover = None
            searches = live.searches
            mesh.submit_neighbors(PREDICT_LINES, k=4).result(60)
            assert live.searches == searches    # from the cache again
            counts.append(mesh.stats()['memo']['hits'])
        finally:
            mesh.close()
    assert counts[0] == counts[1]


# ------------------------------------------------ full drill (slow-mark)
@pytest.mark.slow
@pytest.mark.skipif(
    not (REPO / 'extractor' / 'build' / 'c2v-extract').exists(),
    reason='native extractor not built')
def test_full_synthetic_replay_drill(pair, tmp_path, telemetry):
    """The synthetic mixed-corpus profile -> a durable file -> a paced
    replay at a rate scale on a fresh mesh, reporting quality, hit rate,
    shed, p99 and the SLO burn per scenario and language."""
    model = pair[0]
    records = profile_lib.build_synthetic_profile(
        model.config, str(tmp_path / 'corpus'), classes_per_language=2,
        seed=5, rate_rps=40.0)
    assert {r['language'] for r in records} == {'java', 'csharp'}
    path = str(tmp_path / 'synthetic.jsonl')
    profile_lib.write_profile(path, records, meta={'source': 'synthetic'})
    _header, loaded = profile_lib.read_profile(path)
    mesh = model.serving_mesh(replicas=1, tiers=('topk', 'vectors'),
                              memo_cache_bytes=8 << 20)
    try:
        vec = mesh.predict([loaded[0]['lines'][0]], tier='vectors',
                           timeout=60)[0].code_vector
        mesh.attach_index(FakeIndex(dim=vec.shape[0]))
        report = replay_lib.replay(mesh, loaded, rate_scale=8.0, seed=5,
                                   pace=True, timeout_s=120.0)
        assert report['admitted'] == len(loaded)
        for name in ('java_naming', 'csharp_naming'):
            cell = next(iter(report['scenarios'][name].values()))
            assert cell['delivered'] + cell['shed'] + cell['errors'] == \
                cell['requests']
            assert cell['p99_ms'] >= cell['p50_ms'] >= 0.0
        assert report['slo']['good_total'] > 0
        again = replay_lib.plan_replay(loaded, rate_scale=8.0, seed=5)
        assert replay_lib.admitted_fingerprint(again) == \
            report['fingerprint']
    finally:
        mesh.close()
