"""The serving mesh's autoscaler (code2vec_tpu_torch/serving/autoscaler.py)
against the reference's (code2vec_tpu/serving/autoscaler.py): both driven
through the same scripted signals over one stub mesh shape (the replica
table under ``_lock``, the front queue's drain estimate, the SLO burns,
``add_replica`` and ``retire``) on one fake clock, as
tests/test_serving_mesh.py drives the reference's. Each scenario asserts
the reference's decisions and the port's equal, and equal ``stats()``,
victims, spawn-hook calls, ``add_replica`` calls, transition traces and
``autoscale/*`` metrics; then the decisions the reference's tests pin.
The ``AUTOSCALE_*`` keys: the reference's defaults, and each invalid
value refused by both configs with the same message.
"""
import threading
import types

import pytest

from code2vec_tpu.config import Config as RefConfig
from code2vec_tpu.serving import autoscaler as ref_autoscaler
from code2vec_tpu.telemetry import core as ref_core
from code2vec_tpu_torch.config import Config as PortConfig
from code2vec_tpu_torch.serving import autoscaler as port_autoscaler
from code2vec_tpu_torch.telemetry import core as port_core

BACKLOG = (10.0, 80, 8.0)        # drain 10 s, past the 2 s threshold
IDLE = (0.0, 0, 8.0)
STALLED = (float('inf'), 40, 0.0)
LIGHT = (0.5, 4, 8.0)            # under the threshold, not idle enough


class _Slot:
    def __init__(self, rid):
        self.rid = rid
        self.retired = False
        self.retired_reason = None
        self.dead = False
        self.canarying = False
        self.adopted = False


class _Queue:
    def __init__(self):
        self.next = IDLE

    def drain_seconds(self):
        return self.next


class _Slo:
    def __init__(self):
        self.next = {}

    def burns(self):
        return dict(self.next)


class _Mesh:
    """Just enough mesh for both autoscalers: a replica table under
    _lock, a drain estimate, SLO burns and the two verbs, recording every
    call."""

    def __init__(self, n, fail_add=False):
        self._lock = threading.Lock()
        self._queue = _Queue()
        self._slo = _Slo()
        self._replicas = [_Slot('r%d' % i) for i in range(n)]
        self.fail_add = fail_add
        self.added = []
        self.retired = []

    def add_replica(self):
        if self.fail_add:
            raise RuntimeError('spawn refused')
        rid = 'r%d' % len(self._replicas)
        self._replicas.append(_Slot(rid))
        self.added.append(rid)
        return rid

    def retire(self, rid, timeout=120.0, reason='drain'):
        for slot in self._replicas:
            if slot.rid == rid:
                slot.retired = True
                slot.retired_reason = reason
        self.retired.append((rid, reason))


class _Tracer:
    def __init__(self):
        self.traces = []

    def begin(self, name, attrs=None):
        record = {'name': name, 'attrs': dict(attrs or {})}
        self.traces.append(record)

        def finish(status='ok', reason=None):
            record['status'] = status
            record['reason'] = reason is not None
        return types.SimpleNamespace(finish=finish)


def _cfg(**overrides):
    fields = dict(AUTOSCALE_MIN_REPLICAS=1, AUTOSCALE_MAX_REPLICAS=3,
                  AUTOSCALE_INTERVAL_SECS=3600.0,
                  AUTOSCALE_UP_QUEUE_SECS=2.0, AUTOSCALE_UP_BURN=0.0,
                  AUTOSCALE_DOWN_IDLE_SECS=0.0,
                  AUTOSCALE_DOWN_UTILIZATION=0.5,
                  AUTOSCALE_UP_COOLDOWN_SECS=0.0,
                  AUTOSCALE_DOWN_COOLDOWN_SECS=0.0,
                  AUTOSCALE_FLAP_WINDOW_SECS=120.0,
                  AUTOSCALE_FLAP_LIMIT=2)
    fields.update(overrides)
    return types.SimpleNamespace(**fields)


# a scenario: the fleet, its knobs, and steps of (seconds to advance the
# clock, the drain estimate, the SLO burns, a change to the table)
SCENARIOS = {
    # backlog scales up; the same backlog inside the up-cooldown holds;
    # past the cooldown it scales up to the max bound, then holds
    'backlog_cooldown_max': dict(
        n=1, cfg=dict(AUTOSCALE_UP_COOLDOWN_SECS=30.0),
        steps=[(0, BACKLOG), (1, BACKLOG), (30, BACKLOG), (31, BACKLOG)],
        want=['up', 'hold', 'up', 'hold']),
    # an empty queue scales down only once it stayed idle for the window,
    # then the down-cooldown holds, and a light load resets the clock
    'sustained_idle': dict(
        n=3, cfg=dict(AUTOSCALE_DOWN_IDLE_SECS=10.0,
                      AUTOSCALE_DOWN_COOLDOWN_SECS=60.0),
        steps=[(0, IDLE), (5, IDLE), (5, IDLE), (5, IDLE), (20, LIGHT),
               (60, IDLE), (10, IDLE)],
        want=['hold', 'hold', 'down', 'hold', 'hold', 'hold', 'down']),
    # never below the min bound; a fleet under the min scales up at once
    'min_bound': dict(
        n=2, cfg=dict(AUTOSCALE_MIN_REPLICAS=2),
        steps=[(0, IDLE), (1, IDLE), (1, IDLE, None, 'kill_r1'),
               (1, IDLE)],
        want=['hold', 'hold', 'up', 'hold']),
    # the victim is the newest replica that is neither adopted, canarying,
    # dead nor retired
    'adopted_victim_skipped': dict(
        n=4, adopted=('r3',), canarying=('r2',),
        steps=[(0, IDLE), (1, IDLE), (1, IDLE)],
        want=['down', 'down', 'hold']),
    # up, down, then the up that would be the second reversal freezes all
    # scaling for the window; past it the loop decides again
    'flap_freeze': dict(
        n=1, cfg=dict(AUTOSCALE_FLAP_LIMIT=2,
                      AUTOSCALE_FLAP_WINDOW_SECS=60.0),
        steps=[(0, BACKLOG), (1, IDLE), (1, BACKLOG), (1, BACKLOG),
               (30, IDLE), (61, BACKLOG)],
        want=['up', 'down', 'up', 'frozen', 'frozen', 'up']),
    # the spawn hook asks for capacity instead of spawning here, also for
    # a stalled fleet (rate 0 reads as an infinite drain)
    'spawn_hook': dict(
        n=1, spawn=True, steps=[(0, STALLED), (1, BACKLOG)],
        want=['up', 'up']),
    # a failing add_replica is counted and survived; the cooldown applies
    'failing_add_replica': dict(
        n=1, fail_add=True, cfg=dict(AUTOSCALE_UP_COOLDOWN_SECS=5.0),
        steps=[(0, BACKLOG), (1, BACKLOG), (5, BACKLOG)],
        want=['up', 'hold', 'up']),
    # the SLO leg: both windows burning scales up with a shallow queue; a
    # fast burn above 1 vetoes the scale-down
    'slo_burn_and_veto': dict(
        n=2, cfg=dict(AUTOSCALE_UP_BURN=5.0),
        steps=[(0, LIGHT, {'p99': (6.0, 6.0)}),
               (1, LIGHT, {'p99': (6.0, 2.0)}),
               (1, IDLE, {'p99': (1.5, 0.1)}),
               (1, IDLE, {'p99': (0.5, 0.1)})],
        want=['up', 'hold', 'hold', 'down']),
}


def _run(module, scenario, monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr(module, 'time',
                        types.SimpleNamespace(monotonic=lambda: clock[0]))
    mesh = _Mesh(scenario['n'], fail_add=scenario.get('fail_add', False))
    for rid in scenario.get('adopted', ()):
        next(s for s in mesh._replicas if s.rid == rid).adopted = True
    for rid in scenario.get('canarying', ()):
        next(s for s in mesh._replicas if s.rid == rid).canarying = True
    spawned = []
    tracer = _Tracer()
    spawn = ((lambda m: spawned.append(len(m._replicas)))
             if scenario.get('spawn') else None)
    asc = module.Autoscaler(mesh, _cfg(**scenario.get('cfg', {})),
                            spawn=spawn, tracer=tracer)
    decisions, stats = [], []
    for step in scenario['steps']:
        advance, drain = step[0], step[1]
        burns = step[2] if len(step) > 2 else None
        change = step[3] if len(step) > 3 else None
        clock[0] += advance
        mesh._queue.next = drain
        mesh._slo.next = burns or {}
        if change == 'kill_r1':
            mesh._replicas[1].dead = True
        decisions.append(asc.tick())
        stats.append(asc.stats())
    return {'decisions': decisions, 'stats': stats, 'retired': mesh.retired,
            'added': mesh.added, 'spawned': spawned,
            'traces': tracer.traces}


@pytest.fixture
def registries():
    for core in (port_core, ref_core):
        core.reset()
        core.enable()
    yield
    for core in (port_core, ref_core):
        core.disable()
        core.reset()


def _autoscale_metrics(core) -> dict:
    return {name: value for name, value in core.registry().snapshot().items()
            if name.startswith('autoscale/')}


@pytest.mark.parametrize('name', sorted(SCENARIOS))
def test_port_decides_as_reference(name, monkeypatch, registries):
    scenario = SCENARIOS[name]
    got = _run(port_autoscaler, scenario, monkeypatch)
    want = _run(ref_autoscaler, scenario, monkeypatch)
    assert got == want
    assert _autoscale_metrics(port_core) == _autoscale_metrics(ref_core)
    # the decisions the reference's own drills pin
    assert got['decisions'] == scenario['want']


def test_scenarios_reach_every_edge(monkeypatch):
    """What the scenarios above hold the port to, read off the port's
    runs: the min bound, the LIFO victim past an adopted and a canarying
    replica, one flap freeze, the spawn hook instead of add_replica, a
    counted failed scale-up, the burn leg's reason."""
    runs = {name: _run(port_autoscaler, scenario, monkeypatch)
            for name, scenario in SCENARIOS.items()}
    assert runs['backlog_cooldown_max']['added'] == ['r1', 'r2']
    assert runs['backlog_cooldown_max']['stats'][-1]['replicas_target'] == 3
    assert runs['sustained_idle']['retired'] == [('r2', 'autoscale'),
                                                 ('r1', 'autoscale')]
    assert runs['min_bound']['retired'] == []
    assert runs['adopted_victim_skipped']['retired'] == [
        ('r1', 'autoscale'), ('r0', 'autoscale')]
    flap = runs['flap_freeze']['stats']
    assert flap[2]['flap_freezes_total'] == 1
    assert flap[3]['frozen_for_s'] == 59.0
    assert runs['spawn_hook']['spawned'] == [1, 1]
    assert runs['spawn_hook']['added'] == []
    failed = runs['failing_add_replica']['stats'][-1]
    assert (failed['scale_up_failed_total'], failed['scale_up_total']) == \
        (2, 0)
    assert [t['status'] for t in runs['failing_add_replica']['traces']] == \
        ['error', 'error']
    burn = runs['slo_burn_and_veto']['traces']
    assert burn[0]['name'] == 'autoscale.transition'
    assert burn[0]['attrs']['reason'] == 'slo_burn'


def test_autoscale_keys_are_the_reference_defaults():
    port, ref = PortConfig(), RefConfig()
    keys = [k for k in vars(ref) if k.startswith('AUTOSCALE_')]
    assert len(keys) == 11
    for key in keys:
        assert getattr(port, key) == getattr(ref, key), key
    assert port.AUTOSCALE_MAX_REPLICAS == 0   # off by default


@pytest.mark.parametrize('overrides', [
    dict(AUTOSCALE_MIN_REPLICAS=0), dict(AUTOSCALE_MAX_REPLICAS=-1),
    dict(AUTOSCALE_MAX_REPLICAS=2, AUTOSCALE_MIN_REPLICAS=3),
    dict(AUTOSCALE_INTERVAL_SECS=0.0), dict(AUTOSCALE_UP_QUEUE_SECS=0.0),
    dict(AUTOSCALE_UP_BURN=-1.0), dict(AUTOSCALE_DOWN_IDLE_SECS=-1.0),
    dict(AUTOSCALE_DOWN_UTILIZATION=0.0),
    dict(AUTOSCALE_DOWN_UTILIZATION=1.5),
    dict(AUTOSCALE_UP_COOLDOWN_SECS=-1.0),
    dict(AUTOSCALE_DOWN_COOLDOWN_SECS=-1.0),
    dict(AUTOSCALE_FLAP_WINDOW_SECS=0.0), dict(AUTOSCALE_FLAP_LIMIT=0),
], ids=lambda o: ','.join('%s=%s' % kv for kv in o.items()))
def test_invalid_autoscale_values_refused_as_reference(overrides):
    with pytest.raises(ValueError) as port:
        PortConfig(TRAIN_DATA_PATH_PREFIX='x', **overrides).verify()
    with pytest.raises(ValueError) as ref:
        RefConfig(TRAIN_DATA_PATH_PREFIX='x', **overrides).verify()
    assert str(port.value) == str(ref.value)
    assert 'AUTOSCALE_' in str(port.value)


def test_armed_bounds_pass_verify():
    for config in (PortConfig(TRAIN_DATA_PATH_PREFIX='x',
                              AUTOSCALE_MAX_REPLICAS=3,
                              AUTOSCALE_MIN_REPLICAS=2),
                   RefConfig(TRAIN_DATA_PATH_PREFIX='x',
                             AUTOSCALE_MAX_REPLICAS=3,
                             AUTOSCALE_MIN_REPLICAS=2)):
        config.verify()
