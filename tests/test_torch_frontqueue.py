"""The port's shared front queue (code2vec_tpu_torch/serving/frontqueue.py)
against the reference's (code2vec_tpu/serving/frontqueue.py), on the CPU.

One script of admits, enqueues, pops, requeues, clock advances, fault
drills and closes runs against both queues, with a fake clock and fake
requests; the outcomes must be equal: the tier each admit returns, the
sheds by reason, the degradations, the coalesced batches (which requests,
in which order), the expiries, the requeue order, the drain estimate and
the counters. The reference's unit tests (tests/test_serving_mesh.py)
each have a script here, and so does the worker modes' crash-safe
redispatch: ``requeue_front`` of a crashed batch whose members exclude
the incarnation that crashed with them, and pops that claim as that
incarnation, as a sibling, or as no one. The continuous insert into a
gathering batch runs on real threads, as there.
"""
import collections
import threading
import time
import types
from concurrent.futures import Future

import numpy as np
import pytest

from code2vec_tpu.resilience import faults as ref_faults
from code2vec_tpu.serving import engine as ref_engine
from code2vec_tpu.serving import errors as ref_errors
from code2vec_tpu.serving import frontqueue as ref_frontqueue
from code2vec_tpu_torch.resilience import faults as port_faults
from code2vec_tpu_torch.serving import engine as port_engine
from code2vec_tpu_torch.serving import errors as port_errors
from code2vec_tpu_torch.serving import frontqueue as port_frontqueue

PORT = (port_frontqueue, port_engine, port_errors, port_faults)
REFERENCE = (ref_frontqueue, ref_engine, ref_errors, ref_faults)


class FakeTime:
    """A clock that moves only when the script says so."""

    def __init__(self):
        self.now = 1000.0

    def perf_counter(self):
        return self.now

    def monotonic(self):
        return self.now


@pytest.fixture(autouse=True)
def disarmed():
    for faults in (port_faults, ref_faults):
        faults.configure('')
    yield
    for faults in (port_faults, ref_faults):
        faults.configure('')


def _request(engine_mod, rows, tier='topk', deadline_s=None):
    batch = types.SimpleNamespace(label=np.zeros((rows,), np.int32))
    return engine_mod._Request(batch, tier, future=Future(),
                               deadline_s=deadline_s)


def run_script(modules, script, monkeypatch, tiers=('topk',), bound=None):
    """Drive one package's FrontQueue through ``script``; returns the
    outcome log."""
    fq_mod, engine_mod, errors_mod, faults_mod = modules
    clock = FakeTime()
    monkeypatch.setattr(fq_mod, 'time', clock)
    monkeypatch.setattr(engine_mod, 'time', clock)
    rate = [0.0]
    queue = fq_mod.FrontQueue(tiers, bound, fleet_rate=lambda: rate[0])
    by_id, ids = {}, {}
    # claim tokens by name: one object per replica incarnation
    tokens = collections.defaultdict(object)
    log = []

    def name(request):
        return ids[id(request)]

    for op, *args in script:
        if op == 'rate':
            rate[0] = args[0]
        elif op == 'advance':
            clock.now += args[0]
        elif op == 'faults':
            faults_mod.configure(args[0])
        elif op == 'admit':
            rows, tier, deadline_s = args
            try:
                log.append(('admit', queue.admit(rows, tier, deadline_s)))
            except errors_mod.EngineOverloaded as exc:
                log.append(('shed', str(exc).split(':')[0]))
            except errors_mod.EngineClosed:
                log.append(('closed',))
        elif op == 'release':
            queue.release_reservation(args[0])
        elif op == 'enqueue':
            tier, requests = args
            made = []
            for rid, rows, deadline_s in requests:
                request = _request(engine_mod, rows, tier, deadline_s)
                by_id[rid] = request
                ids[id(request)] = rid
                made.append(request)
            try:
                queue.enqueue(tier, made, sum(r[1] for r in requests))
                log.append(('enqueued', [r[0] for r in requests]))
            except errors_mod.EngineClosed:
                log.append(('closed',))
        elif op in ('pop', 'claim_pop'):
            max_rows, alive = args[:2]
            claim = tokens[args[2]] if op == 'claim_pop' else None
            popped = queue.pop_coalesced(max_rows, 0.0,
                                         alive=lambda: alive, claim=claim)
            if popped is None:
                log.append(('pop', None))
            else:
                tier, taken, rows, expired = popped
                log.append(('pop', tier, [name(r) for r in taken], rows,
                            [name(r) for r in expired]))
        elif op == 'exclude':
            # what the mesh marks on a crashed batch's members
            token, rids = args
            for rid in rids:
                by_id[rid].redispatched = True
                by_id[rid].exclude = tokens[token]
        elif op == 'requeue':
            tier, rids = args
            log.append(('requeue', queue.requeue_front(
                tier, [by_id[rid] for rid in rids])))
        elif op == 'close':
            queue.close(args[0])
        elif op == 'abandon':
            log.append(('abandon', [name(r) for r in queue.abandon()]))
        elif op == 'drain_seconds':
            log.append(('drain_seconds', queue.drain_seconds()))
        elif op == 'depth':
            log.append(('depth', queue.depth_rows(), queue.peak_rows(),
                        queue.overload_level()))
        else:
            raise ValueError(op)
    log.append(('stats', queue.stats()))
    return log


# each script: (tiers, bound, ops)
SCRIPTS = {
    'bound-sheds-typed': (('topk',), 8, [
        ('admit', 4, 'topk', None), ('enqueue', 'topk', [('a', 4, None)]),
        ('admit', 8, 'topk', None), ('admit', 4, 'topk', None),
        ('admit', 1, 'topk', None), ('depth',)]),
    'fleet-drain-estimate': (('topk',), 1024, [
        ('rate', 1.0), ('admit', 100, 'topk', 0.1),
        ('admit', 100, 'topk', None), ('rate', 1000.0),
        ('admit', 100, 'topk', 0.5), ('admit', 500, 'topk', 0.5),
        ('drain_seconds',)]),
    'oversize-alone-then-bounds': (('topk',), 4, [
        ('admit', 10, 'topk', None), ('admit', 1, 'topk', None),
        ('release', 10), ('admit', 1, 'topk', None), ('depth',)]),
    'degrades-under-shared-fill': (('topk', 'full'), 8, [
        ('admit', 6, 'topk', None), ('admit', 1, 'full', None),
        ('release', 7), ('admit', 1, 'full', None), ('depth',)]),
    'never-degrades-onto-a-cold-tier': (('full',), 8, [
        ('admit', 6, 'full', None), ('admit', 1, 'full', None)]),
    'ladder-hysteresis': (('topk', 'attention', 'full'), 16, [
        ('admit', 8, 'topk', None), ('admit', 1, 'full', None),
        ('admit', 4, 'full', None), ('release', 9),
        ('admit', 1, 'full', None), ('admit', 1, 'attention', None),
        ('release', 5), ('admit', 1, 'full', None), ('depth',)]),
    'coalesces-oldest-tier-first': (('topk', 'attention'), None, [
        ('admit', 3, 'attention', None),
        ('enqueue', 'attention', [('a1', 3, None)]), ('advance', 0.001),
        ('admit', 9, 'topk', None),
        ('enqueue', 'topk', [('t1', 2, None), ('t2', 3, None),
                             ('t3', 4, None)]),
        ('advance', 0.001), ('admit', 2, 'attention', None),
        ('enqueue', 'attention', [('a2', 2, None)]),
        ('pop', 16, True), ('pop', 5, True), ('pop', 16, True),
        ('depth',)]),
    'expires-at-pop': (('topk',), None, [
        ('admit', 3, 'topk', None),
        ('enqueue', 'topk', [('d1', 1, 0.01), ('k1', 1, None),
                             ('d2', 1, 0.5)]),
        ('advance', 0.05), ('pop', 16, True), ('advance', 1.0),
        ('admit', 1, 'topk', None), ('enqueue', 'topk', [('d3', 1, 0.01)]),
        ('advance', 0.05), ('pop', 16, True)]),
    'requeue-front-in-order': (('topk',), None, [
        ('admit', 1, 'topk', None), ('enqueue', 'topk', [('w', 1, None)]),
        ('admit', 5, 'topk', None),
        ('enqueue', 'topk', [('c1', 2, None), ('c2', 3, 0.01)]),
        ('pop', 1, True), ('pop', 16, True),
        ('requeue', 'topk', ['c1', 'c2']), ('depth',), ('advance', 0.05),
        ('pop', 16, True), ('close', False), ('requeue', 'topk', ['c1'])]),
    'close-fail-fast': (('topk',), None, [
        ('admit', 2, 'topk', None),
        ('enqueue', 'topk', [('q1', 1, None), ('q2', 1, None)]),
        ('admit', 1, 'topk', None), ('close', False), ('pop', 16, True),
        ('enqueue', 'topk', [('late', 1, None)]), ('admit', 1, 'topk', None),
        ('abandon',), ('depth',)]),
    'close-drain': (('topk',), None, [
        ('admit', 2, 'topk', None),
        ('enqueue', 'topk', [('q1', 1, None), ('q2', 1, None)]),
        ('close', True), ('pop', 1, True), ('requeue', 'topk', ['q1']),
        ('pop', 16, True), ('pop', 16, True), ('abandon',)]),
    'drain-seconds': (('topk',), None, [
        ('drain_seconds',), ('rate', 4.0), ('drain_seconds',),
        ('admit', 8, 'topk', None), ('enqueue', 'topk', [('a', 8, None)]),
        ('drain_seconds',), ('admit', 2, 'topk', None), ('drain_seconds',),
        ('rate', 0.0), ('drain_seconds',)]),
    'reject-all-drill': (('topk',), 64, [
        ('faults', 'reject_all@req=0..1'), ('admit', 1, 'topk', None),
        ('admit', 1, 'topk', None), ('admit', 1, 'topk', None),
        ('faults', ''), ('admit', 1, 'topk', None)]),
    'claim-skips-the-crashed-incarnation': (('topk',), None, [
        ('admit', 3, 'topk', None),
        ('enqueue', 'topk', [('c1', 1, None), ('c2', 1, None)]),
        ('claim_pop', 16, True, 'r0#1'), ('admit', 1, 'topk', None),
        ('enqueue', 'topk', [('o1', 1, None)]),
        ('exclude', 'r0#1', ['c1', 'c2']), ('requeue', 'topk', ['c1', 'c2']),
        ('depth',), ('claim_pop', 16, True, 'r0#1'), ('depth',),
        ('claim_pop', 1, True, 'r1#1'), ('claim_pop', 16, True, 'r1#1'),
        ('depth',)]),
    'claim-excluded-only-then-restart': (('topk',), None, [
        ('admit', 3, 'topk', None),
        ('enqueue', 'topk', [('c1', 1, None), ('c2', 1, 0.01),
                             ('c3', 1, None)]),
        ('claim_pop', 16, True, 'r0#1'),
        ('exclude', 'r0#1', ['c1', 'c2', 'c3']),
        ('requeue', 'topk', ['c1', 'c2', 'c3']),
        ('claim_pop', 16, True, 'r0#1'), ('depth',), ('advance', 0.05),
        ('claim_pop', 16, True, 'r0#2'), ('depth',)]),
    'claim-none-takes-excluded': (('topk', 'attention'), None, [
        ('admit', 3, 'topk', None),
        ('enqueue', 'topk', [('c1', 2, None), ('c2', 1, None)]),
        ('claim_pop', 16, True, 'r0#1'), ('exclude', 'r0#1', ['c1']),
        ('requeue', 'topk', ['c1']), ('close', True),
        ('claim_pop', 16, True, 'r0#1'), ('pop', 16, True),
        ('requeue', 'topk', ['c2']), ('pop', 16, True)]),
    'dead-puller-takes-nothing': (('topk',), None, [
        ('admit', 1, 'topk', None), ('enqueue', 'topk', [('a', 1, None)]),
        ('pop', 16, False), ('depth',), ('pop', 16, True), ('depth',)]),
}


@pytest.mark.parametrize('script', sorted(SCRIPTS))
def test_frontqueue_outcomes_equal_reference(script, monkeypatch):
    tiers, bound, ops = SCRIPTS[script]
    got = run_script(PORT, ops, monkeypatch, tiers=tiers, bound=bound)
    want = run_script(REFERENCE, ops, monkeypatch, tiers=tiers, bound=bound)
    assert got == want
    # the script exercised what it is named for
    outcomes = [entry[0] for entry in got]
    assert outcomes[-1] == 'stats'


def test_frontqueue_shed_counters_by_reason(monkeypatch):
    tiers, bound, ops = SCRIPTS['bound-sheds-typed']
    stats = run_script(PORT, ops, monkeypatch, tiers, bound)[-1][1]
    assert (stats['shed_total'], stats['shed_bound_total'],
            stats['shed_deadline_total']) == (2, 2, 0)
    tiers, bound, ops = SCRIPTS['fleet-drain-estimate']
    log = run_script(PORT, ops, monkeypatch, tiers, bound)
    assert log[0] == ('shed', 'request shed at mesh admission '
                              '(fleet drain estimate 100000ms > deadline '
                              '100ms)')
    assert log[-1][1]['shed_deadline_total'] == 2


def test_frontqueue_pop_coalesces_a_late_arrival():
    """Continuous insert: a request arriving inside the coalescing window
    joins the gathering batch (real threads and clock)."""
    queue = port_frontqueue.FrontQueue(('topk',), bound=None,
                                       fleet_rate=lambda: 0.0)
    first = _request(port_engine, 2)
    queue.admit(2, 'topk', None)
    queue.enqueue('topk', [first], 2)
    late = _request(port_engine, 3)

    def arrive_late():
        time.sleep(0.05)
        queue.admit(3, 'topk', None)
        queue.enqueue('topk', [late], 3)

    thread = threading.Thread(target=arrive_late)
    thread.start()
    tier, taken, rows, expired = queue.pop_coalesced(
        16, max_delay_s=0.4, alive=lambda: True)
    thread.join()
    assert tier == 'topk' and rows == 5 and not expired
    assert taken == [first, late]


def test_frontqueue_waiting_puller_leaves_when_it_dies():
    """A puller blocked on an empty queue returns None once its replica is
    no longer alive, and one blocked in the coalescing window too."""
    queue = port_frontqueue.FrontQueue(('topk',), bound=None,
                                       fleet_rate=lambda: 0.0)
    alive = [True]
    out = []
    thread = threading.Thread(target=lambda: out.append(
        queue.pop_coalesced(16, 10.0, alive=lambda: alive[0])))
    thread.start()
    time.sleep(0.1)
    alive[0] = False
    queue.kick()
    thread.join(5)
    assert out == [None]
    queue.admit(1, 'topk', None)
    queue.enqueue('topk', [_request(port_engine, 1)], 1)
    alive[0] = True
    thread = threading.Thread(target=lambda: out.append(
        queue.pop_coalesced(16, 10.0, alive=lambda: alive[0])))
    thread.start()
    time.sleep(0.1)
    alive[0] = False
    thread.join(5)
    assert out == [None, None] and queue.depth_rows() == 1


def test_frontqueue_mirrors_into_the_registry():
    from code2vec_tpu_torch.telemetry import core
    core.reset()
    core.enable()
    try:
        queue = port_frontqueue.FrontQueue(('topk',), bound=4,
                                           fleet_rate=lambda: 0.0)
        queue.admit(3, 'topk', None)
        queue.enqueue('topk', [_request(port_engine, 3)], 3)
        with pytest.raises(port_errors.EngineOverloaded):
            queue.admit(2, 'topk', None)
        snap = core.registry().snapshot()
        assert snap['mesh/shed_total'] == snap['mesh/shed_bound_total'] == 1
        assert snap['mesh/queue_rows'] == 3
        assert snap['mesh/queue_depth'] == 1
    finally:
        core.disable()
        core.reset()
