"""The port's SLO burn-rate monitor (code2vec_tpu_torch/serving/slo.py)
against the reference's (code2vec_tpu/serving/slo.py), on the CPU:

- one event stream (good, slow, bad, clock advances) fed to both
  monitors under one fake clock gives the same burns, window counts,
  latched alerts and per-scenario tallies;
- the reference's unit tests (tests/test_fleet_observability.py): quiet
  at baseline, fires latched on a burn and dumps flight_slo_burn.jsonl,
  the p99 leg, burns evicted at read time, disabled legs; flight dumps
  namespaced by a tracer's instance;
- through the port's mesh: a ``reject_all`` drill burns the availability
  budget and fires the monitor after a quiet healthy stream.
"""
import dataclasses
import json
import os

import pytest

from code2vec_tpu.serving import slo as ref_slo
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.model_api import Code2VecModel
from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.serving import slo as slo_lib
from code2vec_tpu_torch.serving.errors import EngineOverloaded
from code2vec_tpu_torch.telemetry import core as tele_core
from code2vec_tpu_torch.telemetry import tracing as tracing_lib
from tests.test_train_overfit import make_dataset


class FakeTime:
    def __init__(self):
        self.now = 5000.0

    def monotonic(self):
        return self.now

    def perf_counter(self):
        return self.now


# each stream: (monitor kwargs, events); an event is ('good', latency_s,
# scenario), ('bad', scenario) or ('advance', seconds)
STREAMS = {
    'availability-burn': (
        dict(availability=0.99, fast_window_s=30.0, slow_window_s=60.0,
             burn_threshold=5.0, min_events=10),
        [('good', 0.005, None)] * 50 + [('bad', None)] * 30),
    'p99-burn': (
        dict(p99_ms=50.0, fast_window_s=30.0, slow_window_s=60.0,
             burn_threshold=5.0, min_events=10),
        [('good', 0.005, None)] * 20 + [('good', 0.5, None)] * 40),
    'rearm-after-recovery': (
        dict(availability=0.9, fast_window_s=1.0, slow_window_s=10.0,
             burn_threshold=2.0, min_events=5),
        [('bad', None)] * 10 + [('advance', 1.5)] + [('good', 0.0, None)]
        * 30 + [('advance', 0.5)] + [('bad', None)] * 30),
    'both-legs-and-scenarios': (
        dict(availability=0.95, p99_ms=10.0, fast_window_s=5.0,
             slow_window_s=20.0, burn_threshold=1.5, min_events=20),
        [('good', 0.001, 'naming')] * 15 + [('good', 0.2, 'search')] * 10
        + [('advance', 2.0)] + [('bad', 'naming')] * 5
        + [('bad', 'search')] * 15 + [('advance', 6.0)]
        + [('good', 0.001, None)] * 5),
    'min-events-floor': (
        dict(availability=0.99, burn_threshold=1.0, min_events=20),
        [('bad', None)] * 19),
    'disabled': (dict(), [('good', 10.0, None), ('bad', None)] * 5),
}


def drive(slo_mod, kwargs, events, monkeypatch):
    clock = FakeTime()
    monkeypatch.setattr(slo_mod, 'time', clock)
    monitor = slo_mod.SloMonitor(**kwargs)
    out = []
    for event in events:
        if event[0] == 'advance':
            clock.now += event[1]
            out.append(('burns', monitor.burns()))
        elif event[0] == 'good':
            monitor.observe_good(event[1], scenario=event[2])
        else:
            monitor.observe_bad('shed', scenario=event[1])
        out.append(monitor.alerts_total.snapshot())
    out.append(monitor.stats())
    out.append(monitor.enabled)
    return out


@pytest.mark.parametrize('stream', sorted(STREAMS))
def test_slo_outcomes_equal_reference(stream, monkeypatch):
    kwargs, events = STREAMS[stream]
    got = drive(slo_lib, kwargs, events, monkeypatch)
    want = drive(ref_slo, kwargs, events, monkeypatch)
    assert got == want


def test_slo_streams_fire_as_named(monkeypatch):
    kwargs, events = STREAMS['rearm-after-recovery']
    stats = drive(slo_lib, kwargs, events, monkeypatch)[-2]
    assert stats['alerts_total'] == 2        # fired, re-armed, fired
    kwargs, events = STREAMS['min-events-floor']
    assert drive(slo_lib, kwargs, events, monkeypatch)[-2][
        'alerts_total'] == 0
    kwargs, events = STREAMS['both-legs-and-scenarios']
    scenarios = drive(slo_lib, kwargs, events, monkeypatch)[-2]['scenarios']
    assert scenarios['search']['availability_burn_share'] == 0.75


def test_slo_monitor_quiet_at_baseline_fires_on_burn_latched(tmp_path):
    tracer = tracing_lib.Tracer(str(tmp_path), sample_rate=1.0)
    monitor = slo_lib.SloMonitor(
        availability=0.99, p99_ms=50.0, fast_window_s=30.0,
        slow_window_s=60.0, burn_threshold=5.0, min_events=10,
        tracer=tracer)
    assert monitor.enabled
    for _ in range(50):
        monitor.observe_good(0.005)
    assert monitor.alerts_total.value == 0
    assert monitor.stats()['availability_burn_fast'] == 0.0
    for _ in range(30):
        monitor.observe_bad('shed')
    assert monitor.alerts_total.value == 1
    assert monitor.stats()['alerting']['availability'] is True
    path = tmp_path / 'flight_slo_burn.jsonl'
    assert json.loads(path.read_text().splitlines()[0])['flight'] == \
        'slo_burn'
    for _ in range(40):
        monitor.observe_good(0.500)
    assert monitor.stats()['alerting']['p99'] is True
    assert monitor.alerts_total.value == 2
    assert monitor.slow_total.value == 40
    tracer.close()


def test_slo_burns_evict_at_read_time(monkeypatch):
    clock = FakeTime()
    monkeypatch.setattr(slo_lib, 'time', clock)
    monitor = slo_lib.SloMonitor(availability=0.9, fast_window_s=0.2,
                                 slow_window_s=0.3, burn_threshold=2.0,
                                 min_events=5)
    for _ in range(10):
        monitor.observe_bad('shed')
    assert monitor.stats()['availability_burn_fast'] > 2.0
    clock.now += 0.4
    stale = monitor.stats()
    assert stale['availability_burn_fast'] == 0.0
    assert stale['fast_window_events'] == 0


def test_slo_exports_burn_gauges():
    tele_core.reset()
    tele_core.enable()
    try:
        monitor = slo_lib.SloMonitor(availability=0.9, p99_ms=10.0,
                                     min_events=1)
        monitor.observe_good(1.0)
        monitor.observe_bad('shed')
        snap = tele_core.registry().snapshot()
        assert snap['slo/good_total'] == snap['slo/bad_total'] == 1
        assert snap['slo/slow_total'] == 1
        assert snap['slo/availability_burn_fast'] == pytest.approx(5.0)
        assert snap['slo/p99_burn_fast'] == pytest.approx(50.0)
    finally:
        tele_core.disable()
        tele_core.reset()


def test_flight_dumps_namespaced_by_instance(tmp_path):
    out = str(tmp_path)
    parent = tracing_lib.Tracer(out, sample_rate=1.0)
    replica = tracing_lib.Tracer(out, sample_rate=1.0, instance='r1')
    for tracer in (parent, replica):
        trace = tracer.begin('serving.request', attrs={'tier': 'topk'})
        trace.finish()
    assert parent.dump_flight('overload', force=True).endswith(
        'flight_overload.jsonl')
    assert replica.dump_flight('overload', force=True).endswith(
        'flight_overload_r1.jsonl')
    assert os.path.exists(os.path.join(out, 'flight_overload.jsonl'))
    assert os.path.exists(os.path.join(out, 'flight_overload_r1.jsonl'))
    parent.close()
    replica.close()


@pytest.fixture(scope='module')
def model(tmp_path_factory):
    prefix = make_dataset(tmp_path_factory.mktemp('torch_slo'))
    return Code2VecModel(Config(
        TRAIN_DATA_PATH_PREFIX=str(prefix), COMPUTE_DTYPE='float32',
        MAX_CONTEXTS=6, SERVING_BATCH_BUCKETS='8,16'), device='cpu')


def test_mesh_slo_monitor_fires_on_reject_all_burn(model, monkeypatch):
    line = 'get|a toka0,pA,toka1 toka1,pB,toka2'
    monkeypatch.setattr(model, 'config', dataclasses.replace(
        model.config, SERVING_SLO_AVAILABILITY=0.5,
        SERVING_SLO_FAST_WINDOW_SECS=30.0,
        SERVING_SLO_SLOW_WINDOW_SECS=60.0, SERVING_SLO_BURN_THRESHOLD=1.5))
    mesh = model.serving_mesh(replicas=1, tiers=('topk',), mode='thread',
                              max_delay_ms=0.0)
    try:
        assert mesh._slo is not None and mesh._slo.enabled
        for _ in range(8):
            mesh.predict([line], tier='topk', timeout=120)
        assert mesh.stats()['slo']['alerts_total'] == 0
        faults.configure('reject_all@req=0..9999')
        shed = 0
        for _ in range(40):
            try:
                mesh.submit([line], tier='topk')
            except EngineOverloaded:
                shed += 1
        assert shed == 40
        stats = mesh.stats()['slo']
        assert stats['alerts_total'] >= 1
        assert stats['alerting']['availability'] is True
        assert stats['availability_burn_fast'] > 1.5
        assert stats['bad_total'] == 40
        assert mesh.stats()['shed_total'] == 40
    finally:
        faults.configure('')
        mesh.close()


def test_mesh_without_targets_has_no_monitor(model):
    with model.serving_mesh(replicas=1, tiers=('topk',),
                            max_delay_ms=0.0) as mesh:
        assert mesh._slo is None and mesh.stats()['slo'] is None
