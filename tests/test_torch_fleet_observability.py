"""The serving mesh's fleet observability for worker replicas
(code2vec_tpu_torch/telemetry/tracing.py, telemetry/core.py,
serving/mesh.py) on the CPU, held against the reference package on the
same inputs, as tests/test_fleet_observability.py drills the reference:

- ``Trace.adopt_spans``: the same records grafted into a trace of each
  package give the same span tree (ids remapped, internal parent links
  kept, the remote root under the given parent, stamps shifted), and two
  incarnations never collide;
- ``RemoteSpanSink``: the same begin / finish / collect / drain sequence
  under one fake clock gives the same bundles from both, and the outbox
  is bounded the same way;
- ``MirrorTimer`` and the fleet merge: the same worker snapshots, a
  counter reset by a restart included, merged into a thread-mode mesh of
  each package give equal registry snapshots and Prometheus samples,
  one contiguous group per family;
- the stitched kill drill in socket mode (``device='cpu'``): a worker
  SIGKILLed after its device work, before its result frame; the
  delivered trace holds both incarnations' ``serving.remote`` with a
  ``serving.device_execute`` under each, no delivered trace is
  unstitched, and the answers match the reference mesh's within rtol
  2e-5 / atol 1e-6 on the same weights;
- ``MESH_TELEMETRY_BACKHAUL``: at 0 the beats carry no riders and the
  parent's traces no ``serving.remote``; AUTO is resolved at each spawn.
"""
import itertools
import json
import os
import sys
import time
import types

import numpy as np
import pytest

from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.serving import mesh as mesh_lib
from code2vec_tpu_torch.serving import transport as transport_lib
from code2vec_tpu_torch.telemetry import catalog, core, exporters, tracing
from tests.test_torch_mesh import ATOL, PREDICT_LINES, RTOL, _wait_until
from tests.test_torch_mesh_workers import (bit_equal, checkpointed_pair,
                                           config_fields)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SCRIPTS = os.path.join(REPO, 'scripts')
if _SCRIPTS not in sys.path:
    sys.path.insert(0, _SCRIPTS)

import latency_report  # noqa: E402


@pytest.fixture(autouse=True)
def clean_state():
    from code2vec_tpu.telemetry import core as jax_core
    faults.configure('')
    yield
    faults.configure('')
    for module in (core, jax_core):
        module.disable()
        module.reset()


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    """The reference model and a port model over its weights, saved at
    step 0 (the workers restore from there)."""
    return checkpointed_pair(tmp_path_factory, 'fleet')


def _tree(trace):
    """A trace's spans as comparable tuples."""
    return [(s.span_id, s.parent_id, s.name, s.t0, s.t1, s.attrs)
            for s in trace._spans]


def _records(pid=111):
    return [
        {'trace': 'x', 'span': 0, 'parent': None,
         'name': 'serving.remote', 't0': 10.0, 't1': 12.0,
         'attrs': {'replica': 'r0', 'pid': pid}},
        {'trace': 'x', 'span': 1, 'parent': 0,
         'name': 'serving.device_execute', 't0': 10.5, 't1': 11.5},
        {'trace': 'x', 'span': 2, 'parent': 1,
         'name': 'serving.fetch', 't0': 11.0, 't1': 11.4},
    ]


class _Clock:
    """A ``time.perf_counter`` that ticks 0.25 s a read, so both
    packages' stamps are equal when they read it in the same order."""

    def __init__(self):
        self._ticks = itertools.count()

    def __call__(self):
        return 100.0 + 0.25 * next(self._ticks)


# ---------------------------------------------------------- adopt_spans
@pytest.mark.parametrize('offset, chunked', [(-7.0, True), (0.0, False),
                                             (0.125, True)])
def test_adopt_spans_equals_reference(offset, chunked, monkeypatch):
    from code2vec_tpu.telemetry import tracing as jax_tracing
    trees = []
    for module in (tracing, jax_tracing):
        monkeypatch.setattr(time, 'perf_counter', _Clock())
        trace = module.Tracer(None, sample_rate=1.0).begin('serving.request')
        parent = trace.span('serving.chunk') if chunked else None
        trace.span_at('serving.pack', 1.0, 2.0, parent=parent)
        assert trace.adopt_spans(_records(), offset_s=offset,
                                 parent=parent) == 3
        trees.append(_tree(trace))
        by_name = {s.name: s for s in trace._spans}
        remote = by_name['serving.remote']
        assert remote.parent_id == (parent.span_id if chunked else 0)
        assert by_name['serving.device_execute'].parent_id == remote.span_id
        assert by_name['serving.fetch'].parent_id == \
            by_name['serving.device_execute'].span_id
        assert remote.t0 == 10.0 + offset
        trace.finish()
        # a finished trace is written: a late graft is refused
        assert trace.adopt_spans(_records()) == 0
    assert trees[0] == trees[1]


def test_adopt_spans_two_incarnations_never_collide(monkeypatch):
    from code2vec_tpu.telemetry import tracing as jax_tracing
    trees = []
    for module in (tracing, jax_tracing):
        monkeypatch.setattr(time, 'perf_counter', _Clock())
        trace = module.Tracer(None, sample_rate=1.0).begin('serving.request')
        assert trace.adopt_spans(_records(111), 0.0) == 3
        trace.event('serving.redispatch')
        assert trace.adopt_spans(_records(222), 0.5) == 3
        trees.append(_tree(trace))
        ids = [s.span_id for s in trace._spans]
        assert len(ids) == len(set(ids))
        remotes = [s for s in trace._spans if s.name == 'serving.remote']
        assert {s.attrs['pid'] for s in remotes} == {111, 222}
        devs = [s for s in trace._spans
                if s.name == 'serving.device_execute']
        assert {d.parent_id for d in devs} == \
            {r.span_id for r in remotes}
    assert trees[0] == trees[1]


# ------------------------------------------------------ RemoteSpanSink
def _sink_run(module):
    """One sequence of begin, spans, finish, wait, collect and drain."""
    sink = module.RemoteSpanSink('r1')
    ctx = {'trace_id': 'abc', 'sampled': True}
    t_a = sink.begin('serving.remote', ctx, seq=4, member=0)
    t_b = sink.begin('serving.remote', dict(ctx, scenario='ide'), seq=5,
                     member=1)
    t_c = sink.begin('serving.remote', {'trace_id': 'def'}, seq=4,
                     member=1)
    t_a.span_at('serving.device_execute', 1.0, 2.0)
    dev = t_b.span('serving.device_execute')
    t_b.span_at('serving.fetch', 1.5, 1.75, parent=dev)
    t_a.finish()
    t_b.finish(status='error', reason='boom')
    t_c.finish()
    sink.wait_finished([t_a, t_b, None, t_c], timeout=2.0)
    out = {'fresh': sink.drain(min_age_s=60.0), 'seq4': sink.collect(4)}
    out['old'] = sink.drain(min_age_s=0.5)
    out['rest'] = sink.drain()
    out['empty'] = sink.drain()
    return out


def test_remote_sink_bundles_equal_reference(monkeypatch):
    from code2vec_tpu.telemetry import tracing as jax_tracing
    runs = []
    for module in (tracing, jax_tracing):
        monkeypatch.setattr(time, 'perf_counter', _Clock())
        runs.append(_sink_run(module))
    assert runs[0] == runs[1]
    got = runs[0]
    # the age gate leaves fresh bundles to their result frame; collect is
    # keyed by seq; the leftover is the heartbeat's
    assert got['fresh'] == [] and got['empty'] == []
    assert [(b['seq'], b['member']) for b in got['seq4']] == [(4, 0), (4, 1)]
    assert [b['seq'] for b in got['old'] + got['rest']] == [5]
    bundle = (got['old'] + got['rest'])[0]
    assert bundle['status'] == 'error'
    root = bundle['spans'][0]
    assert root['name'] == 'serving.remote' and root['parent'] is None
    assert root['attrs'] == {'replica': 'r1', 'pid': os.getpid(),
                             'scenario': 'ide', 'reason': 'boom'}
    assert [r['name'] for r in got['seq4'][0]['spans']] == [
        'serving.remote', 'serving.device_execute']


@pytest.mark.parametrize('cap, n', [(2, 5), (1, 3), (4, 4)])
def test_remote_sink_outbox_bounded_as_reference(cap, n):
    from code2vec_tpu.telemetry import tracing as jax_tracing
    outs = []
    for module in (tracing, jax_tracing):
        sink = module.RemoteSpanSink('r1', max_bundles=cap)
        for seq in range(n):
            sink.begin('serving.remote', {'trace_id': 't', 'sampled': True},
                       seq=seq, member=0).finish()
        outs.append((sink.dropped_bundles,
                     [b['seq'] for b in sink.drain()]))
    assert outs[0] == outs[1] == (max(0, n - cap),
                                  list(range(max(0, n - cap), n)))


# --------------------------------------------------------- MirrorTimer
def test_mirror_timer_as_reference():
    from code2vec_tpu.telemetry import core as jax_core
    stats = {'count': 4, 'mean_ms': 2.0, 'p50_ms': 2.0, 'p95_ms': 3.0,
             'max_ms': 3.5, 'last_ms': 1.5, 'total_s': 0.008}
    for module in (core, jax_core):
        reg = module.Registry()
        timer = reg.mirror_timer('serving/latency_ms{replica=r7}')
        assert isinstance(timer, module.Timer)
        # before an adoption it is the Timer's own (empty) snapshot
        assert timer.snapshot()['count'] == 0
        timer.adopt(stats)
        stats_copy = timer.snapshot()
        assert stats_copy == stats and stats_copy is not stats
        # the same name as a timer is the same mirror
        assert reg.timer('serving/latency_ms{replica=r7}') is timer
        reg.timer('serving/decode_ms')
        with pytest.raises(TypeError):
            reg.mirror_timer('serving/decode_ms')
    assert 'MirrorTimer' in core.__all__


# --------------------------------------------------------- fleet merge
@pytest.fixture(scope='module')
def meshes(pair):
    """A thread-mode mesh of each package over the same weights."""
    reference, port = pair
    got = (port.serving_mesh(replicas=1, tiers=('topk',), mode='thread',
                             max_delay_ms=0.0),
           reference.serving_mesh(replicas=1, tiers=('topk',), mode='thread',
                                  max_delay_ms=0.0))
    yield got
    for mesh in got:
        mesh.close()


def _fake_worker(module, rid):
    clock = module.ClockOffset()
    clock.observe(0.0, 0.0015)
    return types.SimpleNamespace(rid=rid, clock=clock, _merge_last={})


def _families_contiguous(lines):
    seen, last = set(), None
    for line in lines:
        if line.startswith('#'):
            continue
        family = line.split('{')[0].split(' ')[0]
        assert family == last or family not in seen, \
            'family %r split in the fleet export' % family
        seen.add(family)
        last = family


def test_fleet_merge_equals_reference(meshes, tmp_path):
    from code2vec_tpu.serving import transport as jax_transport
    from code2vec_tpu.telemetry import core as jax_core
    from code2vec_tpu.telemetry import exporters as jax_exporters
    timer_stats = {'count': 4, 'mean_ms': 2.0, 'p50_ms': 2.0,
                   'p95_ms': 3.0, 'max_ms': 3.5, 'last_ms': 1.5,
                   'total_s': 0.008}
    beats = [
        ('r7', 0, {'serving/batches_total{replica=r7}': 5,
                   'serving/latency_ms{replica=r7}': timer_stats,
                   'serving/batch_fill_rate{replica=r7}': 0.25,
                   'jit/compiles_total': 12,
                   'mem/attributed_bytes': 4096.0,
                   'not/cataloged': 1.0}),
        ('r8', 0, {'jit/compiles_total': 3,
                   'serving/batches_total{replica=r8}': 2}),
        ('r7', 0, {'jit/compiles_total': 15,
                   'serving/batches_total{replica=r7}': 9}),
        # r7 restarted: its new incarnation counts from 0 again
        ('r7', 1, {'jit/compiles_total': 2,
                   'serving/batches_total{replica=r7}': 1,
                   'mem/attributed_bytes': 2048.0}),
        # r8's counter went back within one incarnation: taken as a reset
        ('r8', 0, {'jit/compiles_total': 1}),
    ]
    texts, snaps = [], []
    for mesh, module, tele, exp in (
            (meshes[0], transport_lib, core, exporters),
            (meshes[1], jax_transport, jax_core, jax_exporters)):
        tele.reset()
        tele.enable()
        workers = {}
        for rid, incarnation, snapshot in beats:
            worker = workers.setdefault((rid, incarnation),
                                        _fake_worker(module, rid))
            mesh._on_worker_telemetry(worker, dict(snapshot), None)
        reg = tele.registry()
        snaps.append(reg.snapshot())
        exporter = exp.PrometheusExporter(str(tmp_path / module.__name__))
        exporter.flush(reg, step=0)
        texts.append(open(exporter.path).read().splitlines())
        assert mesh.stats()['worker_snapshots_total'] == len(beats)
        tele.disable()
        tele.reset()
    assert snaps[0] == snaps[1]
    snap = snaps[0]
    # labeled names keep their label, the others gain the replica's;
    # deltas accumulate across the restart's reset
    assert snap['jit/compiles_total{replica=r7}'] == 17
    assert snap['jit/compiles_total{replica=r8}'] == 4
    assert snap['serving/batches_total{replica=r7}'] == 10
    assert snap['mem/attributed_bytes{replica=r7}'] == 2048.0
    assert snap['serving/latency_ms{replica=r7}'] == timer_stats
    assert snap['mesh/clock_offset_ms{replica=r7}'] == pytest.approx(1.5)
    assert snap['mesh/worker_snapshots_total'] == len(beats)
    assert 'not/cataloged' not in snap and 'jit/compiles_total' not in snap
    port_text, ref_text = texts
    assert [l for l in port_text if not l.startswith('# HELP')] == \
        [l for l in ref_text if not l.startswith('# HELP')]
    assert len(port_text) == len(ref_text)
    _families_contiguous(port_text)
    assert any(l.startswith(catalog.prometheus_name('serving/latency_ms'))
               and 'replica="r7"' in l for l in port_text)


def test_new_catalog_entries_are_the_references():
    from code2vec_tpu.telemetry import catalog as jax_catalog
    from code2vec_tpu.telemetry import tracing as jax_tracing
    for name in ('mesh/clock_offset_ms', 'mesh/worker_snapshots_total',
                 'tracing/adopted_spans_total',
                 'tracing/remote_spans_dropped_total'):
        assert catalog.CATALOG[name] == jax_catalog.CATALOG[name], name
    assert tracing.REMOTE_ORIGIN_SPANS == jax_tracing.REMOTE_ORIGIN_SPANS
    for name in tracing.REMOTE_ORIGIN_SPANS:
        assert tracing.SPAN_CATALOG[name] == jax_tracing.SPAN_CATALOG[name]


# ------------------------------------------------- AUTO at each spawn
@pytest.mark.parametrize('configured, enabled, resolved', [
    (-1, True, 1), (-1, False, 0), (0, True, 0), (1, False, 1)])
def test_backhaul_auto_resolved_at_spawn(configured, enabled, resolved,
                                         monkeypatch):
    spawned = []

    class Recorder:
        def __init__(self, rid, mode, overrides, **hooks):
            spawned.append((rid, overrides, hooks))

    monkeypatch.setattr(mesh_lib, '_WorkerReplica', Recorder)
    stub = types.SimpleNamespace(
        _worker_overrides={'MESH_TELEMETRY_BACKHAUL': configured},
        _listener=None, mode='process',
        _on_worker_batch_done=None, _on_worker_dead=None,
        _on_worker_telemetry='merge', _note_stitched='count')
    (core.enable if enabled else core.disable)()
    mesh_lib.ServingMesh._spawn_worker(stub, 'r3')
    rid, overrides, hooks = spawned[0]
    assert rid == 'r3' and overrides['MESH_TELEMETRY_BACKHAUL'] == resolved
    # the mesh's own map keeps AUTO for the next spawn
    assert stub._worker_overrides['MESH_TELEMETRY_BACKHAUL'] == configured
    assert hooks['on_telemetry'] == 'merge' and hooks['on_spans'] == 'count'


# -------------------------------------------- the stitched kill drill
def _delivered(traces):
    return {tid: e for tid, e in traces.items()
            if e['root'] is not None
            and e['root'].get('status') in (None, 'ok')
            and (e['root'].get('attrs') or {}).get('mesh')}


def test_socket_stitched_kill_drill_both_incarnations(pair, meshes,
                                                      tmp_path):
    """A socket worker runs a batch, its spans ride a heartbeat home, and
    it is SIGKILLed before the result frame; the redispatched request is
    served by the restarted incarnation, and its delivered tree holds
    both incarnations' envelopes with their device work."""
    reference, model = pair
    core.reset()
    core.enable()
    telemetry_dir = tmp_path / 'telemetry'
    with config_fields(model,
                       # counted from 0: fires on the worker's second
                       # dispatch
                       FAULT_INJECT='kill_worker_after_execute@dispatch=1',
                       TRACING_SAMPLE_RATE=1.0,
                       TELEMETRY_DIR=str(telemetry_dir),
                       MESH_HEARTBEAT_SECS=0.25, MESH_HEARTBEAT_MISSES=8,
                       MESH_RESTART_BACKOFF_SECS=0.05, MESH_RESTART_LIMIT=5):
        mesh = model.serving_mesh(replicas=1, tiers=('topk',), mode='socket',
                                  max_delay_ms=0.0)
    try:
        first_pid = mesh._replicas[0].transport.pid
        clean = mesh.submit([PREDICT_LINES[0]], tier='topk')
        got_clean = clean.result(timeout=120)
        doomed = mesh.submit([PREDICT_LINES[1]], tier='topk')
        got_doomed = doomed.result(timeout=300)
        _wait_until(lambda: mesh.stats()['restarts_total'] >= 1
                    and not mesh._replicas[0].dead, timeout=120.0,
                    what='the supervised restart')
        assert mesh._replicas[0].transport.pid != first_pid
        stats = mesh.stats()
        assert stats['redispatched_total'] >= 1
        assert stats['adopted_spans_total'] > 0
        # the backhaul: the ledger rollup, the clock offset, the merge
        _wait_until(lambda: mesh.stats()['replicas'][0]['worker_memory']
                    is not None, timeout=60.0, what='the ledger rollup')
        row = mesh.stats()['replicas'][0]
        assert set(row['worker_memory']) == {'attributed_bytes',
                                             'budget_bytes', 'buckets'}
        assert row['worker_memory']['buckets']['params'] > 0
        assert row['clock_offset_ms'] is not None
        reg = core.registry()
        _wait_until(lambda: reg.get('serving/batches_total{replica=r0}')
                    is not None, timeout=60.0, what='the fleet merge')
        assert reg.get('serving/batches_total{replica=r0}').value >= 1
        assert reg.get('mesh/clock_offset_ms{replica=r0}') is not None
        assert reg.get('tracing/adopted_spans_total').value == \
            stats['adopted_spans_total']
    finally:
        mesh.close()
    # the answers: bit for bit the port's predict, close to the reference
    # mesh's on the same weights
    for got, lines in ((got_clean, [PREDICT_LINES[0]]),
                       (got_doomed, [PREDICT_LINES[1]])):
        bit_equal(got, model.predict(lines))
        want = meshes[1].predict(lines, tier='topk', timeout=120)
        for g, w in zip(got, want):
            assert g.topk_predicted_words == w.topk_predicted_words
            np.testing.assert_allclose(g.topk_predicted_words_scores,
                                       w.topk_predicted_words_scores,
                                       rtol=RTOL, atol=ATOL)
    traces = latency_report.group_traces(latency_report.load_spans(
        str(telemetry_dir / 'spans.jsonl')))
    delivered = _delivered(traces)
    assert len(delivered) == 2
    assert not [t for t in latency_report.unstitched_traces(traces)
                if t in delivered]
    both = [e for e in delivered.values()
            if [r['name'] for r in e['spans']].count('serving.remote') == 2]
    assert len(both) == 1, 'no delivered trace carries both incarnations'
    spans = both[0]['spans']
    assert 'serving.redispatch' in [r['name'] for r in spans]
    remotes = sorted((r for r in spans if r['name'] == 'serving.remote'),
                     key=lambda r: r['t0'])
    assert len({r['attrs']['pid'] for r in remotes}) == 2
    assert remotes[0]['attrs']['pid'] == first_pid
    # stamps ordered under the clock offsets: the first incarnation's
    # envelope ends before the second's begins, both inside the root
    assert remotes[0]['t1'] <= remotes[1]['t0']
    root = both[0]['root']
    for rec in spans:
        assert rec['t0'] >= root['t0'] - 0.05
        assert rec['t1'] <= root['t1'] + 0.05
    devs = [r for r in spans if r['name'] == 'serving.device_execute']
    assert {r['span'] for r in remotes} <= {d['parent'] for d in devs}
    # every delivered tree: an envelope with the device work under it
    for entry in delivered.values():
        envelopes = {r['span'] for r in entry['spans']
                     if r['name'] == 'serving.remote'}
        assert envelopes and envelopes <= {
            r['parent'] for r in entry['spans']
            if r['name'] == 'serving.device_execute'}
    # the fleet report reads the port's span log
    fleet = latency_report.fleet_decomposition(traces)
    assert any(key[0] == 'r0' for key in fleet)


def test_backhaul_off_then_auto_on_at_restart(pair, tmp_path, monkeypatch):
    """AUTO with telemetry off: the worker's beats carry liveness and
    the clock stamp only, and the parent's traces hold no
    ``serving.remote``. Telemetry enabled, then the worker killed: its
    restart resolves AUTO again, on, and the riders arrive."""
    reference, model = pair
    del reference
    beats = []
    real_decode = transport_lib.decode_frame

    def decode(data):
        message = real_decode(data)
        if message[0] == 'heartbeat':
            beats.append(message[2])
        return message

    monkeypatch.setattr(transport_lib, 'decode_frame', decode)
    telemetry_dir = tmp_path / 'telemetry'
    with config_fields(model, TRACING_SAMPLE_RATE=1.0,
                       TELEMETRY_DIR=str(telemetry_dir),
                       MESH_HEARTBEAT_SECS=0.2, MESH_HEARTBEAT_MISSES=10,
                       MESH_RESTART_BACKOFF_SECS=0.05):
        mesh = model.serving_mesh(replicas=1, tiers=('topk',), mode='socket',
                                  max_delay_ms=0.0)
    try:
        assert mesh._worker_overrides['MESH_TELEMETRY_BACKHAUL'] == -1
        for lines in (PREDICT_LINES[:1], PREDICT_LINES):
            bit_equal(mesh.predict(lines, tier='topk', timeout=120),
                      model.predict(lines))
        _wait_until(lambda: len(beats) >= 4, timeout=30.0, what='beats')
        off = list(beats)
        assert all(b.spans == [] and b.telemetry is None and b.ledger is None
                   for b in off)
        stats = mesh.stats()
        assert stats['replicas'][0]['worker_memory'] is None
        assert stats['adopted_spans_total'] == 0
        assert stats['remote_spans_dropped_total'] == 0
        assert stats['worker_snapshots_total'] == 0
        # telemetry on, then a restart: AUTO is resolved at that spawn
        core.reset()
        core.enable()
        slot = mesh._replicas[0]
        slot.transport.kill()
        _wait_until(lambda: mesh.stats()['restarts_total'] >= 1
                    and not slot.dead, timeout=120.0, what='the restart')
        del beats[:]
        bit_equal(mesh.predict(PREDICT_LINES[2:], tier='topk', timeout=120),
                  model.predict(PREDICT_LINES[2:]))
        _wait_until(lambda: mesh.stats()['worker_snapshots_total'] >= 2,
                    timeout=60.0, what='the snapshots')
        assert any(b.telemetry for b in beats)
        assert all(b.ledger is not None for b in beats if b.telemetry)
        assert mesh.stats()['replicas'][0]['worker_memory'] is not None
        assert core.registry().get(
            'mesh/clock_offset_ms{replica=r0}') is not None
    finally:
        mesh.close()
    traces = latency_report.group_traces(latency_report.load_spans(
        str(telemetry_dir / 'spans.jsonl')))
    delivered = sorted(_delivered(traces).values(),
                       key=lambda e: e['root']['t0'])
    assert len(delivered) == 3
    names = [[r['name'] for r in e['spans']] for e in delivered]
    # the two served with the backhaul off hold no worker spans, the one
    # after the restart does
    assert all('serving.remote' not in n for n in names[:2])
    assert 'serving.remote' in names[2]
    assert 'serving.device_execute' in names[2]
    # the log is JSON lines a reader can load whole
    for line in open(telemetry_dir / 'spans.jsonl'):
        json.loads(line)
