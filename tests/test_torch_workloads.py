"""The port's scenario traffic plane, pure half (code2vec_tpu_torch/
workloads/), against the reference's (code2vec_tpu/workloads/), on the
CPU:

- the registry: the built-in scenarios equal, its typed errors and
  re-registration rules with the reference's messages;
- the durable profile: files written by either package read by the
  other, byte for byte the same file from the same records, the same
  malformed records and non-profiles refused; the recorder's bounds;
- the replay plan: ``plan_replay`` and ``admitted_fingerprint`` equal on
  seeded records, with and without a limit; the port's timeline of the
  open loop on a fixed clock;
- the blend math: ``neighbor_votes`` and ``blend_row`` bit for bit the
  reference's on seeded inputs, the tie break and the typed fallback;
- the SLO monitor's scenario attribution as the reference's;
- ``build_synthetic_profile``: the reference's records on the same seed
  (where the native extractor is built).

The mesh half is tests/test_torch_workloads_replay.py.
"""
import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest

from code2vec_tpu.serving import slo as ref_slo
from code2vec_tpu.workloads import blend as ref_blend
from code2vec_tpu.workloads import profile as ref_profile
from code2vec_tpu.workloads import replay as ref_replay
from code2vec_tpu.workloads import scenario as ref_scenario
from code2vec_tpu_torch.serving import slo as slo_lib
from code2vec_tpu_torch.workloads import (Scenario, UnknownScenario,
                                          get_scenario, register_scenario,
                                          scenario_names)
from code2vec_tpu_torch.workloads import blend as blend_lib
from code2vec_tpu_torch.workloads import profile as profile_lib
from code2vec_tpu_torch.workloads import replay as replay_lib
from code2vec_tpu_torch.workloads import scenario as scenario_lib

REPO = Path(__file__).resolve().parents[1]
BUILTINS = ('java_naming', 'csharp_naming', 'softmax_naming',
            'retrieval_naming', 'neighbor_search')


# ------------------------------------------------------------ registry
@pytest.mark.parametrize('name', BUILTINS)
def test_builtin_scenario_equals_reference(name):
    assert name in scenario_names()
    assert dataclasses.asdict(get_scenario(name)) == \
        dataclasses.asdict(ref_scenario.get_scenario(name))
    assert scenario_lib.KINDS == ref_scenario.KINDS


def test_registry_semantics_as_reference():
    with pytest.raises(UnknownScenario) as port:
        get_scenario('no_such_workload')
    with pytest.raises(ref_scenario.UnknownScenario) as ref:
        ref_scenario.get_scenario('no_such_workload')
    assert isinstance(port.value, KeyError)
    # the typed error names what is registered
    assert 'java_naming' in str(port.value)
    assert str(port.value).split(' (registered')[0] == \
        str(ref.value).split(' (registered')[0]
    for lib, cls in ((scenario_lib, Scenario),
                     (ref_scenario, ref_scenario.Scenario)):
        s = cls('wl_torch_scn', kind='predict')
        assert lib.register_scenario(s) is s
        # an identical definition again is a no-op, a different one raises
        lib.register_scenario(cls('wl_torch_scn', kind='predict'))
        with pytest.raises(ValueError) as err:
            lib.register_scenario(cls('wl_torch_scn', kind='neighbors'))
        assert 'already registered' in str(err.value)
        lib.register_scenario(cls('wl_torch_scn', kind='neighbors'),
                              replace=True)
        assert lib.get_scenario('wl_torch_scn').kind == 'neighbors'
    assert register_scenario is scenario_lib.register_scenario


@pytest.mark.parametrize('kwargs', [{'kind': 'stream'}, {'languages': ()}])
def test_scenario_validation_as_reference(kwargs):
    with pytest.raises(ValueError) as port:
        Scenario('bad', **kwargs)
    with pytest.raises(ValueError) as ref:
        ref_scenario.Scenario('bad', **kwargs)
    assert str(port.value) == str(ref.value)


# ------------------------------------------------------- profile format
def _records():
    return [
        {'t': 0.0, 'scenario': 'java_naming', 'language': 'java',
         'lines': ['get|a x,p,y'], 'label': 'get|a'},
        {'t': 0.25, 'scenario': 'neighbor_search',
         'vector': [0.5, -1.0], 'k': 3},
        {'t': 0.5, 'scenario': 'retrieval_naming', 'language': 'csharp',
         'lines': ['set|b u,q,v'], 'label': 'set|b', 'weight': 0.5},
        {'t': 0.75, 'scenario': 'softmax_naming', 'lines': ['run|c a,b,c'],
         'tier': 'topk'},
    ]


@pytest.mark.parametrize('writer, reader', [
    (profile_lib, ref_profile), (ref_profile, profile_lib)],
    ids=['port_to_reference', 'reference_to_port'])
def test_profiles_cross_read(tmp_path, writer, reader):
    path = str(tmp_path / 'p.jsonl')
    writer.write_profile(path, _records(), meta={'source': 'test'})
    header, records = reader.read_profile(path)
    assert header == {'workload_profile': 1, 'records': 4,
                      'source': 'test'}
    assert records == _records()
    assert not os.path.exists(path + '.tmp')   # the write is atomic
    # both writers give the same bytes
    other = str(tmp_path / 'q.jsonl')
    reader.write_profile(other, _records(), meta={'source': 'test'})
    assert Path(other).read_bytes() == Path(path).read_bytes()


@pytest.mark.parametrize('bad', [
    {'t': 0.0, 'lines': ['l a,b,c']},                     # no scenario
    {'t': -1.0, 'scenario': 's', 'lines': ['l a,b,c']},   # negative t
    {'scenario': 's', 'lines': ['l a,b,c']},              # missing t
    {'t': 0.0, 'scenario': 's'},                  # neither lines/vector
    {'t': 0.0, 'scenario': 's', 'lines': ['l'], 'qps': 9},  # drifted key
    ['not', 'an', 'object'],
])
def test_profile_rejects_malformed_records_as_reference(tmp_path, bad):
    path = str(tmp_path / 'bad.jsonl')
    for lib in (profile_lib, ref_profile):
        with pytest.raises(lib.ProfileError):
            lib.write_profile(path, [bad])
    # the strict readers refuse the same record written past the writers,
    # with the same message
    with open(path, 'w') as f:
        f.write(json.dumps({'workload_profile': 1, 'records': 1}) + '\n')
        f.write(json.dumps(bad) + '\n')
    with pytest.raises(profile_lib.ProfileError) as port:
        profile_lib.read_profile(path)
    with pytest.raises(ref_profile.ProfileError) as ref:
        ref_profile.read_profile(path)
    assert isinstance(port.value, ValueError)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize('text', ['{"stage": "soak"}\n', 'not json\n',
                                  '{"workload_profile": 2}\n'])
def test_profile_rejects_non_profiles_as_reference(tmp_path, text):
    path = tmp_path / 'notes.jsonl'
    path.write_text(text)
    with pytest.raises(profile_lib.ProfileError) as port:
        profile_lib.read_profile(str(path))
    with pytest.raises(ref_profile.ProfileError) as ref:
        ref_profile.read_profile(str(path))
    assert str(port.value) == str(ref.value)


def test_recorder_bounds_and_save_as_reference(tmp_path):
    got = []
    for lib in (profile_lib, ref_profile):
        rec = lib.ProfileRecorder(max_records=2)
        rec.record('java_naming', lines=['get|a x,p,y'], language='java',
                   label='get|a')
        rec.record('neighbor_search', vector=np.array([[1.0, 2.0]]), k=4)
        rec.record('java_naming', lines=['run|c z,p,w'])  # past the bound
        assert len(rec) == 2 and rec.dropped == 1
        assert rec.recorded_total.snapshot() == 2
        records = rec.records()
        # times from the first record, never negative
        assert records[0]['t'] == 0.0 and records[1]['t'] >= 0.0
        path = str(tmp_path / ('%s.jsonl' % lib.__name__))
        assert rec.save(path, meta={'run': 1}) == 2
        header, loaded = lib.read_profile(path)
        assert header == {'workload_profile': 1, 'records': 2,
                          'source': 'recorded', 'run': 1}
        assert loaded == records
        got.append([{k: v for k, v in r.items() if k != 't'}
                    for r in records])
    # the same records, the array flattened to plain floats
    assert got[0] == got[1]
    assert got[0][1] == {'scenario': 'neighbor_search',
                         'vector': [1.0, 2.0], 'k': 4}


# -------------------------------------------------- replay plan + hash
def _seeded_records(seed: int, n: int = 40):
    """A seeded mixed profile with tied timestamps."""
    rng = np.random.default_rng(seed)
    records = []
    for i in range(n):
        name = BUILTINS[int(rng.integers(len(BUILTINS)))]
        record = {'t': float(rng.integers(0, 10)) / 4.0, 'scenario': name,
                  'language': ('java', 'csharp')[i % 2],
                  'lines': ['m%d|x a%d,p,b' % (i, int(rng.integers(99)))],
                  'label': 'm%d|x' % i}
        if name == 'retrieval_naming':
            record['weight'] = float(rng.integers(0, 5)) / 4.0
            record['k'] = int(rng.integers(1, 8))
        records.append(record)
    return records


@pytest.mark.parametrize('rate_scale, seed, limit', [
    (1.0, 0, None), (2.0, 1, None), (0.5, 7, 13), (4.0, 8, 13),
    (1.0, 3, 39)])
def test_plan_and_fingerprint_equal_reference(rate_scale, seed, limit):
    records = _seeded_records(seed)
    plan = replay_lib.plan_replay(records, rate_scale=rate_scale, seed=seed,
                                  limit=limit)
    want = ref_replay.plan_replay(records, rate_scale=rate_scale, seed=seed,
                                  limit=limit)
    assert plan == want
    assert replay_lib.admitted_fingerprint(plan) == \
        ref_replay.admitted_fingerprint(want)
    assert len(plan) == (limit if limit is not None else len(records))
    # paced at t / rate_scale, ties kept in profile order
    assert [t for t, _r in plan] == sorted(t for t, _r in plan)


def test_plan_seed_scope_and_fingerprint_content():
    records = _seeded_records(5)
    full_a = replay_lib.plan_replay(records, seed=1)
    full_b = replay_lib.plan_replay(records, seed=99)
    # with no limit the plan does not depend on the seed
    assert replay_lib.admitted_fingerprint(full_a) == \
        replay_lib.admitted_fingerprint(full_b)
    lim_a = replay_lib.plan_replay(records, seed=7, limit=5)
    lim_c = replay_lib.plan_replay(records, seed=8, limit=5)
    assert replay_lib.admitted_fingerprint(lim_a) != \
        replay_lib.admitted_fingerprint(lim_c)
    mutated = [dict(r) for r in records]
    mutated[0]['label'] = 'other|name'
    assert replay_lib.admitted_fingerprint(
        replay_lib.plan_replay(mutated)) != \
        replay_lib.admitted_fingerprint(full_a)
    for lib in (replay_lib, ref_replay):
        with pytest.raises(ValueError) as err:
            lib.plan_replay(records, rate_scale=0.0)
    assert 'rate_scale' in str(err.value)


def test_replay_timeline_on_a_fixed_clock():
    """The open loop's timeline (the port's addition to the report): the
    offer and the deliveries over the submission window, the backlog at
    its middle and end (a failure answers, a timed-out request never
    does), the drain after it."""
    plan = [(0.0, {}), (1.0, {}), (2.0, {}), (3.0, {}), (3.5, {})]
    sent = [10.0, 11.0, 12.0, 13.0, 13.5]
    # delivered, delivered, failed, delivered after the window; the fifth
    # timed out
    finished = [(10.5, True), (12.5, True), (13.5, False), (15.0, True)]
    assert replay_lib._timeline(plan, sent, finished, 10.0, 14.0) == {
        'planned_s': 3.5, 'window_s': 4.0, 'sent': 5, 'offered_rps': 1.25,
        'delivered_in_window': 2, 'delivered_rps': 0.5,
        'backlog_mid': 2, 'backlog_end': 2, 'drain_s': 1.0}
    assert replay_lib._timeline([], [], [], 5.0, 5.0) == {
        'planned_s': 0.0, 'window_s': 0.0, 'sent': 0, 'offered_rps': 0.0,
        'delivered_in_window': 0, 'delivered_rps': 0.0,
        'backlog_mid': 0, 'backlog_end': 0, 'drain_s': 0.0}


# ----------------------------------------------------------- blend math
class _Row:
    """A duck-typed ModelPredictionResults row."""

    def __init__(self, words, scores, name='q|uery'):
        self.original_name = name
        self.topk_predicted_words = list(words)
        self.topk_predicted_words_scores = (
            None if scores is None else np.asarray(scores, np.float32))


class _Nbrs:
    def __init__(self, labels, scores):
        self.labels = list(labels)
        self.scores = np.asarray(scores, dtype=np.float32)


def _assert_blend_equal(got, want):
    assert got.original_name == want.original_name
    assert got.predicted_words == want.predicted_words
    assert got.predicted_scores.dtype == want.predicted_scores.dtype
    np.testing.assert_array_equal(got.predicted_scores,
                                  want.predicted_scores)
    assert (got.source, got.weight) == (want.source, want.weight)
    assert got._fields == want._fields


def _seeded_blend_inputs(seed: int):
    """A softmax row over 10 candidates and 8 neighbors whose labels
    overlap it, with repeated labels and tied scores."""
    rng = np.random.default_rng(seed)
    vocab = ['w%d|x' % i for i in range(14)]
    words = list(rng.choice(vocab, 10, replace=False))
    logits = rng.normal(size=10)
    if seed % 2:
        logits[3] = logits[4]                         # a tied pair
    scores = np.exp(logits) / np.exp(logits).sum()
    labels = list(rng.choice(vocab, 8, replace=True))
    sims = rng.uniform(-1, 1, size=8).astype(np.float32)
    sims[2] = sims[5]
    return _Row(words, scores), _Nbrs(labels, sims)


@pytest.mark.parametrize('seed', range(4))
@pytest.mark.parametrize('weight', [0.0, 0.3, 0.5, 1.0, 2.5])
def test_blend_row_bit_identical_to_reference(seed, weight):
    base, nbrs = _seeded_blend_inputs(seed)
    got = blend_lib.blend_row(base, nbrs, weight)
    want = ref_blend.blend_row(base, nbrs, weight)
    _assert_blend_equal(got, want)
    assert got.source == blend_lib.SOURCE_BLEND
    assert len(got.predicted_words) == 10
    narrow = blend_lib.blend_row(base, nbrs, weight, top_k=3)
    _assert_blend_equal(narrow, ref_blend.blend_row(base, nbrs, weight,
                                                    top_k=3))
    assert narrow.predicted_words == got.predicted_words[:3]


@pytest.mark.parametrize('labels, scores', [
    (['get|a', 'set|b', 'get|a'], [2.0, 2.0, 2.0]),
    ([], []),
    (['a', 'b'], [float('-inf'), float('-inf')]),
    (['a', 'b', 'c'], [float('nan'), 1.0, 0.0]),
    (['a', 'b', 'a'], [0.3, -0.7, 0.9]),
])
def test_neighbor_votes_equal_reference(labels, scores):
    got = blend_lib.neighbor_votes(labels, scores)
    assert got == ref_blend.neighbor_votes(labels, scores)
    # degenerate scores vote uniformly instead of carrying NaN
    assert not labels or abs(sum(got.values()) - 1.0) < 1e-9


def test_blend_row_tie_break_and_fallback_as_reference():
    # tied blended scores: softmax's rank, then the label
    base = _Row(['b|x', 'a|y'], [0.5, 0.5])
    for nbrs in (_Nbrs([], []), _Nbrs(['d|z', 'c|z'], [1.0, 1.0])):
        got = blend_lib.blend_row(base, nbrs, 0.5)
        _assert_blend_equal(got, ref_blend.blend_row(base, nbrs, 0.5))
    assert blend_lib.blend_row(base, _Nbrs([], []), 0.0).predicted_words \
        == ['b|x', 'a|y']
    assert blend_lib.blend_row(base, _Nbrs(['d|z', 'c|z'], [1.0, 1.0]),
                               1.0).predicted_words == ['c|z', 'd|z']
    # no neighbors: the typed fallback, the softmax row untouched
    row = _Row(['get|a', 'set|b'], [0.7, 0.3])
    out = blend_lib.blend_row(row, None, 0.5)
    _assert_blend_equal(out, ref_blend.blend_row(row, None, 0.5))
    assert out.source == blend_lib.SOURCE_FALLBACK == \
        ref_blend.SOURCE_FALLBACK
    assert out.base is row and out.neighbors is None
    # a row with no scores blends from zeros
    bare = _Row(['get|a'], None)
    _assert_blend_equal(blend_lib.blend_row(bare, _Nbrs(['x'], [1.0]), 0.5),
                        ref_blend.blend_row(bare, _Nbrs(['x'], [1.0]), 0.5))
    assert (blend_lib.SOURCE_BLEND, blend_lib.SOURCE_SOFTMAX) == \
        (ref_blend.SOURCE_BLEND, ref_blend.SOURCE_SOFTMAX)
    assert blend_lib.BlendResult._fields == ref_blend.BlendResult._fields


# ------------------------------------------- SLO burn attribution
def test_slo_scenario_attribution_as_reference():
    stats = []
    for lib in (slo_lib, ref_slo):
        mon = lib.SloMonitor(availability=0.99, p99_ms=50.0)
        for _ in range(3):
            mon.observe_good(latency_s=0.001, scenario='java_naming')
        mon.observe_bad('shed', scenario='retrieval_naming')
        mon.observe_bad('failed', scenario='retrieval_naming')
        mon.observe_bad('shed', scenario='java_naming')
        mon.observe_good(latency_s=9.0, scenario='retrieval_naming')  # slow
        mon.observe_good(latency_s=0.001)  # unlabeled: no scenario row
        stats.append(mon.stats()['scenarios'])
    assert stats[0] == stats[1]
    assert set(stats[0]) == {'java_naming', 'retrieval_naming'}
    assert stats[0]['retrieval_naming']['p99_burn_share'] == 1.0


# ------------------------------------------- synthetic profile builder
@pytest.mark.skipif(
    not (REPO / 'extractor' / 'build' / 'c2v-extract').exists(),
    reason='native extractor not built')
def test_build_synthetic_profile_equals_reference(tmp_path):
    from code2vec_tpu.config import Config as RefConfig
    from code2vec_tpu_torch.config import Config
    kwargs = dict(classes_per_language=1, seed=3, rate_rps=100.0,
                  methods_per_class=(2, 2))
    got = profile_lib.build_synthetic_profile(
        Config(MAX_CONTEXTS=200), str(tmp_path / 'port'), **kwargs)
    want = ref_profile.build_synthetic_profile(
        RefConfig(MAX_CONTEXTS=200), str(tmp_path / 'ref'), **kwargs)
    assert got == want and got
    assert {r['language'] for r in got} == {'java', 'csharp'}
    assert {r['scenario'] for r in got} == {'java_naming', 'csharp_naming'}
    for r in got:
        assert r['label'] == r['lines'][0].split(' ', 1)[0]
    ts = [r['t'] for r in got]
    assert ts[0] == 0.0 and ts == sorted(ts)
    # the generated sources are the same files
    for lang, ext in (('java', 'java'), ('csharp', 'cs')):
        assert (tmp_path / 'port' / lang / ('W00000.' + ext)).read_text() \
            == (tmp_path / 'ref' / lang / ('W00000.' + ext)).read_text()
    # and the durable file, written by the port, reads in the reference
    path = str(tmp_path / 'syn.jsonl')
    profile_lib.write_profile(path, got, meta={'source': 'synthetic'})
    assert ref_profile.read_profile(path)[1] == want


# ------------------------------------------------- the scenario on spans
def test_trace_scenario_on_a_stitched_worker_span(tmp_path):
    """A worker replica's envelope carries the scenario of its dispatch
    context; stitched under a root without one, latency_report.py still
    attributes the trace to it."""
    import sys
    from code2vec_tpu_torch.telemetry import tracing
    sys.path.insert(0, str(REPO / 'scripts'))
    try:
        import latency_report
    finally:
        sys.path.remove(str(REPO / 'scripts'))
    tracer = tracing.Tracer(str(tmp_path), sample_rate=1.0)
    trace = tracer.begin('serving.request', attrs={'tier': 'topk'})
    sink = tracing.RemoteSpanSink('r1')
    remote = sink.begin('serving.remote', {
        'trace_id': trace.trace_id, 'sampled': True,
        'scenario': 'retrieval_naming'}, seq=0, member=0)
    remote.finish(status='ok')
    assert trace.adopt_spans(sink.collect(0)[0]['spans']) == 1
    trace.finish(status='ok')
    plain = tracer.begin('serving.request', attrs={'tier': 'topk'})
    plain.finish(status='ok')
    tracer.close()
    traces = latency_report.group_traces(
        latency_report.load_spans(str(tmp_path / 'spans.jsonl')))
    assert sorted(latency_report.trace_scenario(t)
                  for t in traces.values()) == ['-', 'retrieval_naming']
