"""The port's serving mesh in thread mode (code2vec_tpu_torch/serving/
mesh.py) against its own single engine and the reference's mesh
(code2vec_tpu/serving/mesh.py), on the CPU, where each replica runs the
eager predict step with the kernels' plain versions:

- parity: through a 2-replica mesh the port is bit for bit its single
  engine at the same bucket, on both wires, and within rtol 2e-5 /
  atol 1e-6 of the reference's mesh on the same weights (``convert.py``);
- the mixed-tier stream with ``submit_neighbors``: nothing captured or
  built after warm-up (``telemetry/jit_tracker.py``), every replica
  served, its instruments mirrored replica-labeled;
- faults and rollover, case by case as tests/test_serving_mesh.py: the
  breaker's trip and recovery without a wedge, a coordinated swap and a
  rollback, the rollover guards, retirement with redirect, the fleet
  overload drill, close fail-fast and with drain, ``ReplicaDead`` once
  every replica retired, ``add_replica``, the fleet's
  ``follow_checkpoints``;
- the dispatch-share gauges: every replica's series refreshed at each
  completion (none stale, a replica with nothing dispatched at 0.0);
- the port's rules: a replica that fails to warm fails the mesh, the
  model's device; the worker modes (tests/test_torch_mesh_workers*.py)
  refuse a model with no checkpoint and a param_source;
- the mesh's config keys, flags and rules against the reference's, the
  worker modes' included.

The card-side checks (per-replica graph ladders, captures after warm-up,
the ragged and encode kernels under the mesh) live in chip_smoke.py's
mesh phase.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from code2vec_tpu_torch.config import Config as PortConfig
from code2vec_tpu_torch.model_api import Code2VecModel as PortModel
from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.serving import engine as port_engine
from code2vec_tpu_torch.serving import mesh as mesh_lib
from code2vec_tpu_torch.serving.errors import (DeadlineExceeded,
                                               EngineClosed,
                                               EngineOverloaded, ReplicaDead)
from code2vec_tpu_torch.telemetry import core
from tests.test_torch_engine import C7_LINES, SHARED, _reference
from tests.test_torch_memo import FakeIndex, assert_rows_identical
from tests.test_torch_model import to_port
from tests.test_train_overfit import make_dataset

RTOL, ATOL = 2e-5, 1e-6
PREDICT_LINES = [
    'get|a toka0,pA,toka1 toka1,pB,toka2',
    'set|b tokb0,pA,tokb1',
    'run|c tokc0,pC,tokc1 tokc2,pA,tokc0 tokc1,pB,tokc2',
]


@pytest.fixture(autouse=True)
def clear_fault_plan():
    faults.configure('')
    yield
    faults.configure('')


@pytest.fixture(scope='module')
def prefix(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp('torch_mesh'))


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


def _wait_until(predicate, timeout=15.0, what='condition'):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if predicate():
            return
        time.sleep(0.002)
    raise AssertionError('timed out waiting for %s' % what)


def _close(got, want):
    """Port results against the reference's: equal words and attention
    keys, scores, attention and code vectors within tolerance."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.original_name == w.original_name
        assert g.topk_predicted_words == w.topk_predicted_words
        for a, b in ((g.topk_predicted_words_scores,
                      w.topk_predicted_words_scores),
                     (g.code_vector, w.code_vector)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        assert g.attention_per_context.keys() == \
            w.attention_per_context.keys()
        for key, value in g.attention_per_context.items():
            np.testing.assert_allclose(value, w.attention_per_context[key],
                                       rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------- parity
@pytest.mark.parametrize('wire', ['packed', 'planes'])
def test_mesh_matches_single_engine_bit_identical(pair, wire):
    port = pair[wire][1]
    tiers = ('topk', 'attention', 'vectors')
    lines = [PREDICT_LINES[i % 3] for i in range(20)]
    with port.serving_engine(tiers=tiers, max_delay_ms=0.0) as engine:
        single = {tier: [engine.predict([line], tier=tier, timeout=60)
                         for line in C7_LINES] for tier in tiers}
        wide_single = engine.predict(lines, tier='topk', timeout=60)
    with port.serving_mesh(replicas=2, tiers=tiers,
                           max_delay_ms=0.0) as mesh:
        meshed = {tier: [mesh.predict([line], tier=tier, timeout=60)
                         for line in C7_LINES] for tier in tiers}
        # the oversize split joins through the shared queue too
        wide = mesh.predict(lines, tier='topk', timeout=60)
    for tier in tiers:
        for got, want in zip(meshed[tier], single[tier]):
            assert_rows_identical(got, want)
    assert_rows_identical(wide, wide_single)


@pytest.mark.parametrize('wire', ['packed', 'planes'])
def test_mesh_matches_reference_mesh(pair, wire):
    reference, port = pair[wire]
    tiers = ('topk', 'attention')
    with reference.serving_mesh(replicas=2, tiers=tiers,
                                max_delay_ms=0.0) as ref_mesh:
        want = {tier: [ref_mesh.predict([line], tier=tier, timeout=120)
                       for line in C7_LINES] for tier in tiers}
        want_wide = ref_mesh.predict(C7_LINES * 3, tier='topk', timeout=120)
    with port.serving_mesh(replicas=2, tiers=tiers,
                           max_delay_ms=0.0) as mesh:
        got = {tier: [mesh.predict([line], tier=tier, timeout=60)
                      for line in C7_LINES] for tier in tiers}
        got_wide = mesh.predict(C7_LINES * 3, tier='topk', timeout=60)
    for tier in tiers:
        for g, w in zip(got[tier], want[tier]):
            _close(g, w)
    _close(got_wide, want_wide)


# ------------------------------------ mixed tiers, builds, metrics
def test_mesh_mixed_tier_stream_builds_nothing_and_labels_metrics(
        model, monkeypatch):
    core.reset()
    core.enable()
    mesh = model.serving_mesh(replicas=2,
                              tiers=('topk', 'attention', 'vectors'),
                              max_delay_ms=1.0)
    # both replicas take work by construction: the first dispatched batch
    # is held until the sibling has dispatched one of its own (nothing in
    # the mesh's policy makes two pullers share 24 requests)
    order, lock = [], threading.Lock()
    sibling_dispatched = threading.Event()
    real_dispatch = mesh_lib._ThreadReplica.dispatch

    def dispatch(self, tier, taken, rows):
        with lock:
            order.append(self.engine.replica_id)
            first = order[0]
        if self.engine.replica_id != first:
            sibling_dispatched.set()
        elif len(order) == 1:
            assert sibling_dispatched.wait(60)
        return real_dispatch(self, tier, taken, rows)

    monkeypatch.setattr(mesh_lib._ThreadReplica, 'dispatch', dispatch)
    try:
        compiles = core.registry().counter('jit/compiles_total')
        mesh.attach_index(FakeIndex(dim=model.backend.params
                                    .transform.shape[1]))
        warm = compiles.value
        futures = []
        for i in range(24):
            kind = ('topk', 'attention', 'neighbors')[i % 3]
            lines = [PREDICT_LINES[i % 3]]
            futures.append(mesh.submit_neighbors(lines) if kind == 'neighbors'
                           else mesh.submit(lines, tier=kind))
        for future in futures:
            assert future.result(timeout=60)
        # a future resolves before its batch's completion hook runs: read
        # the books once every dispatched batch has completed
        _wait_until(lambda: all(r['inflight'] == 0
                                for r in mesh.stats()['replicas']),
                    what='the last completion hooks')
        assert compiles.value == warm
        for stats in mesh.replica_stats():
            assert stats['graph_captures_after_warmup'] == 0
        stats = mesh.stats()
        assert all(r['batches'] > 0 for r in stats['replicas'])
        reg = core.registry()
        for rid in ('r0', 'r1'):
            labeled = reg.get('serving/batches_total{replica=%s}' % rid)
            assert labeled is not None and labeled.snapshot() > 0
            share = reg.get('mesh/dispatch_share{replica=%s}' % rid)
            assert 0 < share.snapshot() < 1
        assert reg.get('serving/batches_total') is None
        assert sum(reg.get('serving/batches_total{replica=%s}' % rid)
                   .snapshot() for rid in ('r0', 'r1')) == \
            sum(r['batches'] for r in stats['replicas'])
        assert reg.get('mesh/requests_total').snapshot() == 24
        assert reg.get('mesh/replicas').snapshot() == 2
    finally:
        mesh.close()
        core.disable()
        core.reset()


def test_dispatch_share_gauges_refresh_every_replica(model):
    """Each completion refreshes every replica's ``mesh/dispatch_share``
    (the catalog's "share of all rows the mesh has dispatched"): after
    r0, r0, r1 the shares sum to 1 each time, r1's series exists at 0.0
    before it dispatched, and r0's moves when r1 completes."""
    core.reset()
    core.enable()
    try:
        with model.serving_mesh(replicas=2, tiers=('topk',),
                                warmup=False) as mesh:
            reg = core.registry()
            engines = {slot.rid: slot.transport.engine
                       for slot in mesh._replicas}

            def shares():
                return {rid: reg.get('mesh/dispatch_share{replica=%s}'
                                     % rid).snapshot()
                        for rid in ('r0', 'r1')}

            for rid, rows, want in (('r0', 3, {'r0': 1.0, 'r1': 0.0}),
                                    ('r0', 1, {'r0': 1.0, 'r1': 0.0}),
                                    ('r1', 4, {'r0': 0.5, 'r1': 0.5})):
                mesh._on_batch_done(engines[rid], rows, [], True)
                got = shares()
                assert got == want and sum(got.values()) == 1.0
                assert got == {r['replica']: r['dispatch_share']
                               for r in mesh.stats()['replicas']}
    finally:
        core.disable()
        core.reset()


def test_mesh_traces_queue_wait_and_replica_spans(model):
    tracer_rate = dict(tracing_sample_rate=1.0)
    with model.serving_mesh(replicas=2, tiers=('topk',), max_delay_ms=0.0,
                            **tracer_rate) as mesh:
        tracer = mesh._tracer
        seen = []
        tracer._finish_trace = (lambda orig: lambda trace, status, reason,
                                spans: (seen.append((status, spans)),
                                        orig(trace, status, reason,
                                             spans)))(tracer._finish_trace)
        mesh.predict(PREDICT_LINES, tier='topk', timeout=60)
        ((status, spans),) = seen
        names = [span.name for span in spans]
        assert status == 'ok'
        for name in ('serving.admission', 'serving.tokenize',
                     'serving.queue_wait', 'serving.pack',
                     'serving.device_execute', 'serving.deliver'):
            assert name in names, name
        (pack,) = [s for s in spans if s.name == 'serving.pack']
        assert pack.attrs['replica'] in ('r0', 'r1')


# ------------------------------------------------------- the breaker
def test_breaker_trips_replica_out_without_queue_wedge(model):
    mesh = model.serving_mesh(replicas=2, tiers=('topk',), max_delay_ms=0.0,
                              breaker_threshold=2,
                              breaker_cooldown_secs=60.0)
    try:
        slot0 = mesh._replicas[0]
        engine0 = slot0.transport.engine
        real_dispatch = engine0.dispatch_external

        def boom(tier, taken, rows):
            exc = RuntimeError('injected replica-0 dispatch failure')
            for request in taken:
                request.fail(exc)
            raise exc

        engine0.dispatch_external = boom
        sacrificed = 0
        deadline = time.perf_counter() + 20.0
        while slot0.breaker_state != mesh_lib._BREAKER_OPEN:
            assert time.perf_counter() < deadline, 'breaker never tripped'
            try:
                mesh.submit([PREDICT_LINES[0]],
                            tier='topk').result(timeout=60)
            except RuntimeError:
                sacrificed += 1
        assert sacrificed >= 2
        assert mesh.stats()['replica_breaker_open_total'] >= 1
        assert mesh.stats()['replicas_serving'] == 1
        before = slot0.batches
        results = [mesh.predict([PREDICT_LINES[i % 3]], tier='topk',
                                timeout=60) for i in range(10)]
        assert all(r[0].topk_predicted_words for r in results)
        assert slot0.batches == before
        engine0.dispatch_external = real_dispatch
        with mesh._lock:
            slot0.breaker_open_until = time.perf_counter() - 1.0
        _wait_until(
            lambda: (mesh.predict([PREDICT_LINES[0]], tier='topk',
                                  timeout=60)
                     and slot0.breaker_state == mesh_lib._BREAKER_CLOSED),
            timeout=20.0, what='the half-open probe to close the breaker')
        assert slot0.batches > before
        assert mesh.stats()['replicas_serving'] == 2
    finally:
        mesh.close()


def test_decode_failure_counts_against_the_breaker(model):
    with model.serving_mesh(replicas=1, tiers=('topk',), max_delay_ms=0.0,
                            breaker_threshold=1,
                            breaker_cooldown_secs=60.0) as mesh:
        engine = mesh._replicas[0].transport.engine
        real = port_engine.decode_results

        def broken(*args, **kwargs):
            raise ValueError('injected decode failure')

        port_engine.decode_results = broken
        try:
            with pytest.raises(ValueError, match='injected'):
                mesh.predict([PREDICT_LINES[0]], tier='topk', timeout=60)
        finally:
            port_engine.decode_results = real
        _wait_until(lambda: mesh._replicas[0].breaker_state
                    == mesh_lib._BREAKER_OPEN, what='breaker open')
        assert mesh._replicas[0].inflight == 0
        assert engine.stats()['batches_total'] == 1


# ------------------------------------------------------- rollover
def _feed(mesh, handle, lines=PREDICT_LINES):
    """Traffic until the canary concludes: nothing in the mesh's policy
    sends a given request to the canary replica, so a fixed number of
    requests could all land on its sibling (more so on a loaded host)."""
    deadline = time.perf_counter() + 60.0
    while not handle.done() and time.perf_counter() < deadline:
        mesh.predict(lines, tier='topk', timeout=60)
    return handle.result(timeout=60)


def test_coordinated_rollover_swap_and_rollback_no_capture(model):
    """A canary on one replica, every replica swapping on agreement with
    nothing captured or built; a failed canary rolls back and every
    replica keeps the old parameters."""
    core.reset()
    core.enable()
    params = model.backend.params
    # the same values as a new set: a swap the canary agrees with
    same = params._replace(**{name: getattr(params, name).clone()
                              for name in params._fields})
    broken = params._replace(target_embedding=-params.target_embedding)
    mesh = model.serving_mesh(replicas=2, tiers=('topk',), max_delay_ms=0.0)
    try:
        compiles = core.registry().counter('jit/compiles_total')
        baseline = mesh.predict(PREDICT_LINES, tier='topk', timeout=60)
        warm = compiles.value
        handle = mesh.load_params(same, canary_batches=2, min_agreement=0.9)
        canary_rid = mesh._rollover['replica'].rid
        report = _feed(mesh, handle)
        assert report['swapped'] is True
        assert report['canary_replica'] == canary_rid
        assert report['replicas_swapped'] == 2
        slots = [s.transport.engine.stats()['serving_slot']
                 for s in mesh._replicas]
        assert slots == [1, 1]
        for slot in mesh._replicas:
            for got, want in zip(slot.transport.engine.params, same):
                assert torch.equal(got, want)
        assert_rows_identical(mesh.predict(PREDICT_LINES, tier='topk',
                                           timeout=60), baseline)
        report = _feed(mesh, mesh.load_params(broken, canary_batches=2,
                                              min_agreement=0.9))
        assert report['swapped'] is False
        assert report['replicas_swapped'] == 0
        assert [s.transport.engine.stats()['serving_slot']
                for s in mesh._replicas] == slots
        for slot in mesh._replicas:
            for got, want in zip(slot.transport.engine.params, same):
                assert torch.equal(got, want)
        stats = mesh.stats()
        assert stats['rollover_total'] == 1
        assert stats['rollover_rollbacks_total'] == 1
        assert compiles.value == warm
        for replica in mesh.replica_stats():
            assert replica['graph_captures_after_warmup'] == 0
        snap = core.registry().snapshot()
        assert snap['mesh/rollover_total'] == 1
        assert snap['mesh/rollover_rollbacks_total'] == 1
        # concluded: a fresh rollover arms cleanly
        assert mesh.load_params(same, canary_batches=0).result(
            60)['swapped'] is True
    finally:
        mesh.close()
        core.disable()
        core.reset()


def test_rollover_guards(model):
    params = model.backend.params
    mesh = model.serving_mesh(replicas=2, tiers=('topk',), max_delay_ms=0.0)
    try:
        armed = mesh.load_params(params, canary_batches=50)
        with pytest.raises(RuntimeError, match='already in flight'):
            mesh.load_params(params, canary_batches=1)
        engine0 = mesh._replicas[0].transport.engine
        with pytest.raises(RuntimeError, match='mesh replica'):
            engine0.submit(PREDICT_LINES, tier='topk')
        with pytest.raises(RuntimeError, match='mesh replica'):
            engine0.follow_checkpoints(poll_secs=1.0)
        with pytest.raises(RuntimeError, match='checkpointed model'):
            mesh.follow_checkpoints(poll_secs=1.0)
    finally:
        mesh.close()
    assert isinstance(armed.exception(timeout=10), EngineClosed)
    with pytest.raises(EngineClosed):
        mesh.load_params(params, canary_batches=0)


def _saving_model(prefix, tmp_path, **extra):
    model = PortModel(PortConfig(
        TRAIN_DATA_PATH_PREFIX=str(prefix),
        MODEL_SAVE_PATH=str(tmp_path / 'model'), SERVING_CANARY_BATCHES=0,
        **dict(SHARED, SERVING_BATCH_BUCKETS='8'), **extra), device='cpu')
    model.state = model.trainer.state_from_params()
    model.save(epoch=0)   # step 0
    return model


def test_follow_checkpoints_rolls_the_fleet(prefix, tmp_path):
    model = _saving_model(prefix, tmp_path)
    mesh = model.serving_mesh(replicas=2, tiers=('topk',), max_delay_ms=0.0)
    try:
        assert mesh.stats()['params_step'] == 0
        mesh.follow_checkpoints(poll_secs=0.05)
        time.sleep(0.3)
        assert mesh.stats()['rollover_total'] == 0
        model.state = model.state._replace(step=4)
        model.save(epoch=0)
        _wait_until(lambda: mesh.stats()['params_step'] == 4, timeout=30.0,
                    what='the fleet rollover to step 4')
        assert mesh.stats()['rollover_total'] == 1
        assert [r['params_step'] for r in mesh.replica_stats()] == [4, 4]
        # two parameter slots each, warmed: no capture at the swap
        assert all(r['ladder']['warm_slots'] == 2
                   for r in mesh.replica_stats())
    finally:
        mesh.close()


def test_follow_checkpoints_flag_starts_the_fleet_poller(prefix, tmp_path):
    model = _saving_model(prefix, tmp_path,
                          SERVE_FOLLOW_CHECKPOINTS_SECS=0.05)
    mesh = model.serving_mesh(replicas=2, tiers=('topk',), max_delay_ms=0.0)
    try:
        assert mesh._follow_thread is not None
        assert all(s.transport.engine._follow_thread is None
                   for s in mesh._replicas)
    finally:
        mesh.close()


# --------------------------------------------------- retirement
def test_replica_retirement_drains_and_queue_redirects(model):
    with model.serving_mesh(replicas=2, tiers=('topk',),
                            max_delay_ms=0.0) as mesh:
        core.reset()
        core.enable()
        try:
            inflight = [mesh.submit([PREDICT_LINES[i % 3]], tier='topk')
                        for i in range(12)]
            mesh.retire('r0')
            for future in inflight:
                assert future.result(timeout=60)
            retired = mesh._replicas[0]
            assert retired.retired and not retired.thread.is_alive()
            assert retired.transport.engine._closed
            before = mesh._replicas[1].batches
            results = [mesh.predict([line], tier='topk', timeout=60)
                       for line in PREDICT_LINES]
            assert all(r[0].topk_predicted_words for r in results)
            assert mesh._replicas[1].batches > before
            assert mesh._replicas[0].batches + mesh._replicas[1].batches \
                >= len(results)
            stats = mesh.stats()
            assert stats['replicas'][0]['retired'] is True
            assert stats['replicas'][0]['retired_reason'] == 'drain'
            assert stats['retired_total'] == 1
            assert stats['replicas_live'] == 1
            assert core.registry().snapshot()[
                'mesh/retired_total{reason=drain}'] == 1
            assert mesh.replica_stats()[0] == {'replica': 'r0',
                                               'dead': False,
                                               'retired': True}
            mesh.retire('r0')  # idempotent
            with pytest.raises(ValueError, match='no replica'):
                mesh.retire('r9')
        finally:
            core.disable()
            core.reset()


def test_replica_dead_when_every_replica_retired(model):
    mesh = model.serving_mesh(replicas=1, tiers=('topk',),
                              max_delay_ms=10_000.0)
    try:
        slot = mesh._replicas[0]
        # hold the puller out of the queue, so requests stay queued
        with mesh._lock:
            slot.breaker_state = mesh_lib._BREAKER_OPEN
            slot.breaker_open_until = time.perf_counter() + 60.0
        queued = [mesh.submit([line], tier='topk') for line in PREDICT_LINES]
        mesh.retire('r0')
        for future in queued:
            assert isinstance(future.exception(timeout=10), ReplicaDead)
        with pytest.raises(EngineClosed, match='retired'):
            mesh.submit(PREDICT_LINES, tier='topk')
    finally:
        mesh.close()


def test_add_replica_joins_and_serves_the_fleet_params(model):
    params = model.backend.params
    same = params._replace(**{name: getattr(params, name).clone()
                              for name in params._fields})
    with model.serving_mesh(replicas=1, tiers=('topk',),
                            max_delay_ms=0.0) as mesh:
        want = mesh.predict(PREDICT_LINES, tier='topk', timeout=60)
        assert mesh.load_params(same, canary_batches=0).result(
            60)['swapped']
        rid = mesh.add_replica()
        assert rid == 'r1' and len(mesh._replicas) == 2
        added = mesh._replicas[1].transport.engine
        for got, value in zip(added.params, same):
            assert torch.equal(got, value)
        mesh.retire('r0')
        assert_rows_identical(mesh.predict(PREDICT_LINES, tier='topk',
                                           timeout=60), want)
        assert mesh._replicas[1].batches >= 1
        assert mesh.stats()['replicas_live'] == 1


# -------------------------------------------------- the overload drill
def test_fleet_overload_drill_typed_shed_and_expiry(model):
    line = PREDICT_LINES[0]
    unloaded = model.predict([line], tier='topk')[0]
    with model.serving_mesh(replicas=2, tiers=('topk',), max_delay_ms=0.0,
                            queue_bound=64) as mesh:
        faults.configure('reject_all@req=0..1')
        for _ in range(2):
            with pytest.raises(EngineOverloaded):
                mesh.submit([line], tier='topk')
        faults.configure('')
        (result,) = mesh.predict([line], tier='topk', timeout=60)
        assert result.topk_predicted_words == unloaded.topk_predicted_words
        assert mesh.stats()['shed_total'] == 2
    mesh = model.serving_mesh(replicas=2, tiers=('topk',), max_delay_ms=0.0,
                              queue_bound=8, max_inflight=1)
    try:
        faults.configure('slow_dispatch@req=0..255')
        plugs = []
        for _ in range(2):
            plugs.append(mesh.submit([line], tier='topk'))
            _wait_until(lambda: mesh._queue.depth_rows() == 0,
                        what='a replica to claim the plug')
        _wait_until(lambda: all(s.inflight >= 1 for s in mesh._replicas),
                    what='both replicas to hold a stalled batch')
        doomed = [mesh.submit([line], tier='topk', deadline_ms=50.0)
                  for _ in range(4)]
        shed, admitted = 0, []
        for _ in range(12):
            try:
                admitted.append(mesh.submit([line], tier='topk'))
            except EngineOverloaded:
                shed += 1
        assert shed > 0
        assert mesh._queue.peak_rows() <= 8
        for future in doomed:
            assert isinstance(future.exception(timeout=60),
                              DeadlineExceeded)
        faults.configure('')
        for future in admitted + plugs:
            (result,) = future.result(timeout=60)
            assert result.topk_predicted_words == \
                unloaded.topk_predicted_words
            np.testing.assert_allclose(result.topk_predicted_words_scores,
                                       unloaded.topk_predicted_words_scores,
                                       rtol=RTOL, atol=ATOL)
        stats = mesh.stats()
        assert stats['shed_total'] == shed
        assert stats['expired_total'] == 4
    finally:
        faults.configure('')
        mesh.close()


# ---------------------------------------------------------- close
def test_mesh_close_failfast_and_drain(model):
    line = PREDICT_LINES[0]
    mesh = model.serving_mesh(replicas=1, tiers=('topk',), max_delay_ms=0.0)
    faults.configure('slow_dispatch@req=0..63')
    plug = mesh.submit([line], tier='topk')
    _wait_until(lambda: mesh._queue.depth_rows() == 0,
                what='the puller to claim the plug')
    queued = [mesh.submit([line], tier='topk') for _ in range(3)]
    mesh.close()
    faults.configure('')
    assert plug.result(timeout=60)[0].topk_predicted_words
    for future in queued:
        assert isinstance(future.exception(timeout=10), EngineClosed)
    with pytest.raises(EngineClosed):
        mesh.submit([line], tier='topk')
    mesh.close()   # idempotent

    mesh = model.serving_mesh(replicas=2, tiers=('topk',),
                              max_delay_ms=10_000.0)
    futures = [mesh.submit([ln], tier='topk') for ln in PREDICT_LINES]
    mesh.close(drain=True)
    for future, ln in zip(futures, PREDICT_LINES):
        (result,) = future.result(timeout=60)
        assert result.topk_predicted_words == \
            model.predict([ln])[0].topk_predicted_words
    assert not any(s.thread.is_alive() for s in mesh._replicas)
    assert all(s.transport.engine._closed for s in mesh._replicas)


# ------------------------------------------------ the port's rules
@pytest.mark.parametrize('mode', ['process', 'socket'])
def test_worker_modes_need_a_checkpointed_model(model, mode):
    """A worker restores its weights from the store: a model with no load
    or save path is refused before anything is spawned, as the
    reference refuses it; so is a param_source, and an unknown mode."""
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match='checkpointed model'):
        model.serving_mesh(replicas=1, tiers=('topk',), mode=mode,
                           warmup=False)
    with pytest.raises(ValueError, match='param_source'):
        model.serving_mesh(replicas=1, tiers=('topk',), mode=mode,
                           param_source=object(), warmup=False)
    with pytest.raises(ValueError, match='MESH_REPLICA_MODE'):
        model.serving_mesh(replicas=1, tiers=('topk',), mode=mode + 's',
                           warmup=False)
    _wait_until(lambda: threading.active_count() <= threads,
                what='the mesh threads to stop')


def test_a_replica_that_fails_to_warm_fails_the_mesh(model, monkeypatch):
    """No fallback: a replica whose warm-up fails makes serving_mesh()
    raise, and every replica built so far is closed."""
    built = []
    real_warmup = port_engine.ServingEngine.warmup

    def warmup(self):
        built.append(self)
        if self.replica_id == 'r1':
            raise RuntimeError('injected capture failure')
        return real_warmup(self)

    monkeypatch.setattr(port_engine.ServingEngine, 'warmup', warmup)
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match='injected capture failure'):
        model.serving_mesh(replicas=2, tiers=('topk',), max_delay_ms=0.0)
    assert [e.replica_id for e in built] == ['r0', 'r1']
    assert all(e._closed for e in built)
    _wait_until(lambda: threading.active_count() <= threads,
                what='the mesh threads to stop')


def test_mesh_replicas_run_on_the_model_device(model, monkeypatch):
    with model.serving_mesh(replicas=2, tiers=('topk',),
                            warmup=False) as mesh:
        assert mesh.mode == 'thread'
        for slot in mesh._replicas:
            engine = slot.transport.engine
            assert engine.device == torch.device('cpu')
            assert engine._external and engine.replica_id == slot.rid
    # the default device is the card, and there is none here: no silent
    # fall back to the CPU
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        PortModel(dataclasses.replace(model.config))


def test_mesh_auto_queue_bound_scales_with_the_fleet(model):
    with model.serving_mesh(replicas=3, tiers=('topk',),
                            warmup=False) as mesh:
        assert mesh.queue_bound == 3 * 8 * 16
        assert mesh.stats()['queue_bound'] == 3 * 8 * 16
    with model.serving_mesh(replicas=1, tiers=('topk',), queue_bound=-1,
                            warmup=False) as mesh:
        assert mesh.queue_bound is None
    with pytest.raises(ValueError, match='unknown tier'):
        model.serving_mesh(replicas=1, tiers=('logits',), warmup=False)


# --------------------------------------------------------------- config
MESH_KEYS = ('MESH_REPLICAS', 'MESH_QUEUE_BOUND', 'MESH_MAX_INFLIGHT',
             'MESH_BREAKER_THRESHOLD', 'MESH_BREAKER_COOLDOWN_SECS',
             'MESH_REPLICA_MODE', 'MESH_HEARTBEAT_SECS',
             'MESH_HEARTBEAT_MISSES', 'MESH_RESTART_LIMIT',
             'MESH_RESTART_WINDOW_SECS', 'MESH_RESTART_BACKOFF_SECS',
             'MESH_SOCKET_HOST', 'MESH_TELEMETRY_BACKHAUL',
             'MEMO_CACHE_BYTES', 'MEMO_SEMANTIC_EPSILON',
             'SERVING_SLO_AVAILABILITY', 'SERVING_SLO_P99_MS',
             'SERVING_SLO_FAST_WINDOW_SECS', 'SERVING_SLO_SLOW_WINDOW_SECS',
             'SERVING_SLO_BURN_THRESHOLD', 'BLEND_NEIGHBOR_WEIGHT')


@pytest.mark.parametrize('key', MESH_KEYS)
def test_mesh_defaults_equal_reference(key):
    from code2vec_tpu.config import Config
    assert getattr(PortConfig(), key) == getattr(Config(), key)


def test_mesh_flags_parse_as_reference():
    from code2vec_tpu.config import Config
    flags = ['--data', 'x', '--mesh-replicas', '3', '--mesh-queue-bound',
             '-1', '--memo-cache-bytes', '65536', '--mesh-replica-mode',
             'socket']
    port = PortConfig().load_from_args(flags)
    reference = Config().load_from_args(flags)
    for key in MESH_KEYS:
        assert getattr(port, key) == getattr(reference, key), key
    assert (port.MESH_REPLICAS, port.MESH_QUEUE_BOUND,
            port.MEMO_CACHE_BYTES, port.MESH_REPLICA_MODE) == (
        3, -1, 65536, 'socket')


@pytest.mark.parametrize('mode', ['thread', 'process', 'socket', 'fork'])
def test_mesh_replica_mode_flag_choices_as_reference(mode, capsys):
    from code2vec_tpu.config import Config
    flags = ['--data', 'x', '--mesh-replica-mode', mode]
    if mode == 'fork':
        for config in (PortConfig(), Config()):
            with pytest.raises(SystemExit):
                config.load_from_args(flags)
            assert 'invalid choice' in capsys.readouterr().err
    else:
        assert PortConfig().load_from_args(flags).MESH_REPLICA_MODE == \
            Config().load_from_args(flags).MESH_REPLICA_MODE == mode


@pytest.mark.parametrize('key, value', [
    ('MESH_REPLICAS', 0), ('MESH_QUEUE_BOUND', -2),
    ('MEMO_CACHE_BYTES', -1), ('MEMO_SEMANTIC_EPSILON', 1.5),
    ('MESH_MAX_INFLIGHT', 0), ('MESH_BREAKER_THRESHOLD', 0),
    ('MESH_BREAKER_COOLDOWN_SECS', -1.0), ('SERVING_SLO_AVAILABILITY', 1.0),
    ('SERVING_SLO_P99_MS', -1.0), ('SERVING_SLO_FAST_WINDOW_SECS', 0.0),
    ('SERVING_SLO_FAST_WINDOW_SECS', 900.0),
    ('SERVING_SLO_BURN_THRESHOLD', 0.0),
    ('MESH_REPLICA_MODE', 'fork'), ('MESH_HEARTBEAT_SECS', -0.5),
    ('MESH_HEARTBEAT_MISSES', 0), ('MESH_RESTART_LIMIT', -1),
    ('MESH_RESTART_WINDOW_SECS', 0.0), ('MESH_RESTART_BACKOFF_SECS', -0.1),
    ('MESH_TELEMETRY_BACKHAUL', 2), ('BLEND_NEIGHBOR_WEIGHT', 1.5),
])
def test_mesh_verify_rules_as_reference(key, value):
    from code2vec_tpu.config import Config
    with pytest.raises(ValueError) as port:
        PortConfig(TRAIN_DATA_PATH_PREFIX='x', **{key: value}).verify()
    with pytest.raises(ValueError) as reference:
        Config(TRAIN_DATA_PATH_PREFIX='x', **{key: value}).verify()
    assert str(port.value) == str(reference.value)
    assert key.split('_')[0] in str(port.value)


@pytest.mark.parametrize('flags', [
    ['--autoscale-max-replicas', '4'], ['--blend-neighbor-weight', '0.25']])
def test_worker_mode_flags_stay_unrecognized(flags, capsys):
    """The autoscaler's keys, the telemetry backhaul's and the placement
    keys are ported with the reference's defaults and rules, and have no
    flag, as in the reference; the blend weight is ported with its flag,
    which parses to the reference's value. The port's own placement rule:
    MESH_DEVICES_PER_REPLICA above 1 is refused, naming C15."""
    from code2vec_tpu.config import Config
    if flags[0] == '--blend-neighbor-weight':
        port = PortConfig().load_from_args(['--data', 'x'] + flags)
        reference = Config().load_from_args(['--data', 'x'] + flags)
        assert port.BLEND_NEIGHBOR_WEIGHT == \
            reference.BLEND_NEIGHBOR_WEIGHT == 0.25
    else:
        with pytest.raises(SystemExit):
            PortConfig().load_from_args(['--data', 'x'] + flags)
        assert 'unrecognized arguments' in capsys.readouterr().err
    for key in ('MESH_DEVICES_PER_REPLICA', 'MESH_DEVICE_INDICES'):
        assert getattr(PortConfig(), key) == getattr(Config(), key)
    for value, model in ((-1, 1), (3, 2)):
        knobs = dict(MESH_DEVICES_PER_REPLICA=value,
                     MESH_MODEL_AXIS_SIZE=model)
        with pytest.raises(ValueError) as reference:
            Config(TRAIN_DATA_PATH_PREFIX='x', **knobs).verify()
        with pytest.raises(ValueError) as port:
            PortConfig(TRAIN_DATA_PATH_PREFIX='x', **knobs).verify()
        assert str(port.value) == str(reference.value)
    Config(TRAIN_DATA_PATH_PREFIX='x', MESH_DEVICES_PER_REPLICA=2).verify()
    with pytest.raises(ValueError, match='0 or 1 in the port.*C15'):
        PortConfig(TRAIN_DATA_PATH_PREFIX='x',
                   MESH_DEVICES_PER_REPLICA=2).verify()
    PortConfig(TRAIN_DATA_PATH_PREFIX='x', MESH_DEVICES_PER_REPLICA=1,
               MESH_DEVICE_INDICES='0').verify()
    for key in ('AUTOSCALE_MAX_REPLICAS', 'AUTOSCALE_MIN_REPLICAS',
                'MESH_TELEMETRY_BACKHAUL', 'BLEND_NEIGHBOR_WEIGHT'):
        assert hasattr(PortConfig(), key)
