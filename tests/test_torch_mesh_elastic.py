"""The serving mesh's elastic fleet (code2vec_tpu_torch/serving/mesh.py with
serving/autoscaler.py and serving/mesh_worker.py) on the CPU, as
tests/test_serving_mesh.py drills the reference's:

- the adoption edges on a socket mesh, with hand-rolled dial-ins: a
  wrong wire protocol, a dial-in that never reports ready
  (``adopt_ready_timeout_s`` 1 s: the ``adopt_stall`` shape) and one
  missing a tier are refused typed and counted; a well-formed one is
  adopted with its ``devices``; a duplicate rid is refused; the adopted
  worker's death retires it without charging a restart;
- an adoption landing mid-rollover waits it out and moves to the step
  the fleet settled on;
- a failed scale-up (``spawn_fail``) is counted and not fatal, and every
  admitted request is answered;
- thread mode 1 -> 2 -> 1 through the autoscaler's ``tick()`` under
  submits: answers bit for bit the port's ``predict`` and within rtol
  2e-5 / atol 1e-6 of the reference's on the same weights;
- the socket drill: a scale-up from real backlog, a SIGKILL mid-batch,
  ``python -m code2vec_tpu_torch.serving.mesh_worker --device cpu``
  adopted and serving bit for bit, then killed, and a scale-down by
  drain; nothing left behind;
- the worker module: its import chain holds no JAX and nothing of the
  reference package, and with no card and no ``--device cpu`` it exits
  non-zero with its reason before it dials.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.serving import transport as transport_lib
from code2vec_tpu_torch.telemetry import core
from tests.test_torch_mesh import PREDICT_LINES, _wait_until
from tests.test_torch_mesh_workers import (_alive, assert_nothing_left,
                                           bit_equal, checkpointed_pair,
                                           close_to_reference, config_fields,
                                           worker_pids)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the autoscaler driven by tick(): a long interval, a short up-queue
#: threshold, no cooldowns, a short idle window
DRILL_AUTOSCALE = dict(
    AUTOSCALE_MAX_REPLICAS=2, AUTOSCALE_MIN_REPLICAS=1,
    AUTOSCALE_INTERVAL_SECS=3600.0, AUTOSCALE_UP_QUEUE_SECS=0.05,
    AUTOSCALE_UP_COOLDOWN_SECS=0.0, AUTOSCALE_DOWN_COOLDOWN_SECS=0.0,
    AUTOSCALE_DOWN_IDLE_SECS=0.3, AUTOSCALE_DOWN_UTILIZATION=0.9,
    AUTOSCALE_FLAP_LIMIT=10)


@pytest.fixture(autouse=True)
def clear_fault_plan():
    faults.configure('')
    yield
    faults.configure('')


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    return checkpointed_pair(tmp_path_factory, 'elastic')


def waves(n: int):
    """``n`` requests of 3 rows over 8-row batches: several batches."""
    return [[PREDICT_LINES[(i + j) % 3] for j in range(3)] for i in range(n)]


def assert_elastic_reaped(mesh, pids):
    """close() also joined the adoption thread and the autoscaler."""
    assert_nothing_left(mesh, pids)
    if mesh._adopt_thread is not None:
        assert not mesh._adopt_thread.is_alive()
    if mesh._autoscaler is not None and \
            mesh._autoscaler._thread is not None:
        assert not mesh._autoscaler._thread.is_alive()


def dial_raw(mesh, rid, proto=None):
    """A hand-rolled dial-in: the wire an orchestrator's worker speaks."""
    conn = socket.create_connection(tuple(mesh._listener.address),
                                    timeout=30.0)
    channel = transport_lib.SocketTransport(conn)
    channel.send(('hello', rid,
                  transport_lib.WIRE_PROTO if proto is None else proto, 4242))
    return channel


def ready_frame(model, step, tiers=('topk',), devices=None):
    caps = {'tiers': list(tiers), 'wire': model.config.BATCH_WIRE_FORMAT,
            'proto': transport_lib.WIRE_PROTO}
    if devices is not None:
        caps['devices'] = list(devices)
    return ('ready', {'params_step': step, 't_mono': time.perf_counter(),
                      'capabilities': caps})


def fake_worker_loop(channel, calls):
    """A worker's control protocol, enough for an adoption: the move to
    the fleet's step (load_params, poll_rollover), stats and the close."""
    try:
        while True:
            msg = channel.recv()
            kind, seq = msg[0], msg[1]
            if kind == 'load_params':
                calls.append(('load_params', msg[2]))
                channel.send(('result', seq, True))
            elif kind == 'poll_rollover':
                channel.send(('result', seq, {'swapped': True}))
            elif kind == 'stats':
                channel.send(('result', seq, {'replica': 'fake'}))
            elif kind == 'close':
                channel.send(('closed', seq))
                return
    except (EOFError, OSError, transport_lib.WireError):
        return


# ------------------------------------------------------------- adoption
def test_adoption_edges_refused_typed_and_adopted_death_budget_free(pair):
    _reference, model = pair
    with config_fields(model, MESH_HEARTBEAT_SECS=30.0,
                       MESH_HEARTBEAT_MISSES=2,
                       MESH_RESTART_BACKOFF_SECS=0.05, MESH_RESTART_LIMIT=5):
        mesh = model.serving_mesh(replicas=1, tiers=('topk',), mode='socket',
                                  max_delay_ms=0.0)
    mesh.adopt_ready_timeout_s = 1.0
    pids = worker_pids(mesh)
    channels = []
    try:
        assert mesh.stats()['autoscaler'] is None   # MAX 0: off
        # (a) a wrong wire protocol: refused typed at the listener
        bad = dial_raw(mesh, 'ext-proto', proto=1)
        channels.append(bad)
        kind, why = bad.recv()[:2]
        assert kind == 'adopt_rejected' and 'proto' in why
        _wait_until(lambda: mesh.stats()['proto_rejected_total'] >= 1,
                    what='the listener\'s proto refusal')
        # (b) dialed in, never ready: dropped typed after the bounded wait
        ghost = dial_raw(mesh, 'ext-ghost')
        channels.append(ghost)
        kind, why = ghost.recv()[:2]
        assert kind == 'adopt_rejected' and 'ready' in why
        _wait_until(lambda: mesh.stats()['adoption_rejected_total'] == 1,
                    what='the never-ready refusal')
        # (c) ready, but missing a tier the mesh serves
        cold = dial_raw(mesh, 'ext-cold')
        channels.append(cold)
        cold.send(ready_frame(model, 0, tiers=()))
        kind, why = cold.recv()[:2]
        assert kind == 'adopt_rejected' and 'tier' in why
        _wait_until(lambda: mesh.stats()['adoption_rejected_total'] == 2,
                    what='the missing-tier refusal')
        # (d) a well-formed dial-in is adopted and seated with its devices
        good = dial_raw(mesh, 'ext-fake')
        channels.append(good)
        good.send(ready_frame(model, mesh.stats()['params_step'],
                              devices=(6, 7)))
        _wait_until(lambda: mesh.stats()['adopted_total'] == 1,
                    timeout=30.0, what='the adoption of ext-fake')
        rows = {r['replica']: r for r in mesh.stats()['replicas']}
        assert rows['ext-fake']['adopted'] is True
        assert rows['ext-fake']['devices'] == [6, 7]
        assert rows['ext-fake']['pid'] == 4242
        assert rows['ext-fake']['retired'] is False
        assert rows['r0']['adopted'] is False and rows['r0']['devices'] is None
        # (e) a duplicate rid while the first serves
        dupe = dial_raw(mesh, 'ext-fake')
        channels.append(dupe)
        kind, why = dupe.recv()[:2]
        assert kind == 'adopt_rejected' and 'unique' in why
        _wait_until(lambda: mesh.stats()['adoption_rejected_total'] == 3,
                    what='the duplicate-rid refusal')
        # (f) the adopted worker dies: retired typed, no restart charged
        restarts = mesh.stats()['restarts_total']
        good.close()
        slot = next(s for s in mesh._replicas if s.rid == 'ext-fake')
        _wait_until(lambda: slot.retired, timeout=30.0,
                    what='the adopted worker\'s retirement')
        assert slot.retired_reason == 'adopted_worker_exit'
        time.sleep(0.3)   # a wrong supervised restart would act by now
        stats = mesh.stats()
        assert stats['restarts_total'] == restarts
        assert stats['retired_total'] == 1
        rows = {r['replica']: r for r in stats['replicas']}
        assert rows['ext-fake']['retired_reason'] == 'adopted_worker_exit'
        # the fleet it joined still serves
        bit_equal(mesh.predict([PREDICT_LINES[0]], tier='topk', timeout=120),
                  model.predict([PREDICT_LINES[0]]))
    finally:
        for channel in channels:
            channel.close()
        mesh.close()
    assert_elastic_reaped(mesh, pids)


def test_adoption_mid_rollover_waits_then_serves_the_fleet_step(pair):
    _reference, model = pair
    with config_fields(model, MESH_HEARTBEAT_SECS=30.0,
                       MESH_HEARTBEAT_MISSES=2):
        mesh = model.serving_mesh(replicas=1, tiers=('topk',), mode='socket',
                                  max_delay_ms=0.0)
    pids = worker_pids(mesh)
    try:
        with mesh._cond:
            mesh._rollover = {'drill': 'held open'}
        channel = dial_raw(mesh, 'ext-roll')
        calls = []
        threading.Thread(target=fake_worker_loop, args=(channel, calls),
                         daemon=True, name='fake-ext-roll').start()
        channel.send(ready_frame(model, 123))   # a stale cold-start step
        time.sleep(0.8)   # checked by now, parked on the rollover
        assert mesh.stats()['adopted_total'] == 0
        assert calls == []
        with mesh._cond:
            mesh._params_step = 5   # the step the rollover settled on
            mesh._rollover = None
            mesh._cond.notify_all()
        _wait_until(lambda: mesh.stats()['adopted_total'] == 1,
                    timeout=30.0, what='the adoption after the rollover')
        assert calls == [('load_params', 5)]
        rows = {r['replica']: r for r in mesh.stats()['replicas']}
        assert rows['ext-roll']['adopted'] is True
        assert rows['ext-roll']['params_step'] == 5
    finally:
        mesh.close()
    assert_elastic_reaped(mesh, pids)


# ------------------------------------------------------------ autoscaler
def test_failed_scale_up_is_counted_not_fatal(pair):
    _reference, model = pair
    with config_fields(model, FAULT_INJECT='slow_dispatch@req=0..63',
                       MESH_HEARTBEAT_SECS=0.25, MESH_HEARTBEAT_MISSES=4,
                       MESH_RESTART_BACKOFF_SECS=0.05, MESH_RESTART_LIMIT=5,
                       **DRILL_AUTOSCALE):
        mesh = model.serving_mesh(replicas=1, tiers=('topk',),
                                  mode='process', max_delay_ms=0.0)
    pids = worker_pids(mesh)
    try:
        asc = mesh._autoscaler
        assert asc is not None and asc._thread.is_alive()
        mesh.predict([PREDICT_LINES[0]], tier='topk', timeout=120)
        admitted = [(lines, mesh.submit(lines, tier='topk'))
                    for lines in waves(20)]
        faults.configure('spawn_fail@spawn=0')   # the parent's plan
        assert asc.tick() == 'up'
        stats = mesh.stats()
        assert stats['autoscaler']['scale_up_failed_total'] == 1
        assert stats['autoscaler']['scale_up_total'] == 0
        assert stats['replicas_live'] == 1 and len(stats['replicas']) == 1
        faults.configure('')
        for lines, future in admitted:   # no admitted request lost
            bit_equal(future.result(timeout=120), model.predict(lines))
    finally:
        mesh.close()
    assert_elastic_reaped(mesh, pids)


def test_thread_mode_scales_one_two_one_under_submits(pair):
    reference, model = pair
    with config_fields(model, **DRILL_AUTOSCALE):
        mesh = model.serving_mesh(replicas=1, tiers=('topk',),
                                  max_delay_ms=0.0)
    try:
        asc = mesh._autoscaler
        unloaded = {line: model.predict([line])[0] for line in PREDICT_LINES}
        # the replicas stall every batch 250 ms: a real backlog
        faults.configure('slow_dispatch@req=0..63')
        admitted = [(lines, mesh.submit(lines, tier='topk'))
                    for lines in waves(20)]
        drain_s, rows, _rate = mesh._queue.drain_seconds()
        assert rows > 0 and drain_s > 0.05
        assert asc.tick() == 'up'
        stats = mesh.stats()
        assert [r['replica'] for r in stats['replicas']] == ['r0', 'r1']
        assert stats['autoscaler']['scale_up_total'] == 1
        assert stats['autoscaler']['replicas_target'] == 2
        for lines, future in admitted:
            served = future.result(timeout=120)
            bit_equal(served, [unloaded[line] for line in lines])
            close_to_reference(served, reference.predict(lines))
        slot1 = mesh._replicas[1]
        deadline = time.perf_counter() + 60.0
        while slot1.batches == 0:   # until the new replica served too
            assert time.perf_counter() < deadline, 'r1 never served'
            futures = [mesh.submit(lines, tier='topk') for lines in waves(4)]
            for lines, future in zip(waves(4), futures):
                bit_equal(future.result(timeout=120),
                          [unloaded[line] for line in lines])
        faults.configure('')
        _wait_until(lambda: all(r['inflight'] == 0
                                for r in mesh.stats()['replicas']),
                    what='the last completions')
        # the scale-down: sustained idleness drains r1 (LIFO)
        assert asc.tick() == 'hold'   # the idle clock starts
        time.sleep(0.35)
        assert asc.tick() == 'down'
        stats = mesh.stats()
        rows = {r['replica']: r for r in stats['replicas']}
        assert rows['r1']['retired'] is True
        assert rows['r1']['retired_reason'] == 'autoscale'
        assert stats['replicas_live'] == 1
        assert stats['autoscaler']['scale_down_total'] == 1
        # a fleet at its minimum holds
        time.sleep(0.35)
        assert asc.tick() == 'hold'
        served = mesh.predict(PREDICT_LINES, tier='topk', timeout=120)
        bit_equal(served, model.predict(PREDICT_LINES))
        close_to_reference(served, reference.predict(PREDICT_LINES))
        # every replica's captures are its own warm-up's (none on the CPU)
        assert mesh._replicas[0].transport.engine.stats()[
            'graph_captures_after_warmup'] == 0
    finally:
        mesh.close()
    assert not mesh._autoscaler._thread.is_alive()


def test_elastic_drill_with_an_external_port_worker(tmp_path_factory,
                                                     tmp_path):
    """The reference's acceptance drill without placement: a socket fleet
    under slow workers scales 1 -> 2 from the autoscaler's own reading of
    the backlog, loses r0 to a SIGKILL mid-batch without losing a request,
    adopts a worker started outside the mesh (the port's mesh_worker
    module) at the fleet's step, retires it when it dies without charging
    a restart, and drains r1 out once idle; answers bit for bit
    ``predict``; nothing built in the parent."""
    reference, model = checkpointed_pair(tmp_path_factory, 'drill')
    core.reset()
    core.enable()
    mesh = ext = None
    pids = []
    try:
        compiles = core.registry().counter('jit/compiles_total')
        with config_fields(model, FAULT_INJECT='slow_dispatch@req=0..63',
                           MESH_HEARTBEAT_SECS=0.25, MESH_HEARTBEAT_MISSES=4,
                           MESH_RESTART_BACKOFF_SECS=0.05,
                           MESH_RESTART_LIMIT=5, **DRILL_AUTOSCALE):
            mesh = model.serving_mesh(replicas=1, tiers=('topk',),
                                      mode='socket', max_delay_ms=0.0)
        asc = mesh._autoscaler
        expected = {line: model.predict([line])[0] for line in PREDICT_LINES}
        (first,) = mesh.predict([PREDICT_LINES[0]], tier='topk', timeout=120)
        bit_equal([first], [expected[PREDICT_LINES[0]]])
        close_to_reference([first], reference.predict([PREDICT_LINES[0]]))
        warm = compiles.value
        pids += worker_pids(mesh)
        # the orchestrator's worker: the mesh's own overrides, on the CPU;
        # it cold-starts while the load below runs
        config_path = tmp_path / 'ext_worker.json'
        config_path.write_text(json.dumps(mesh._worker_overrides))
        host, port = mesh._listener.address
        ext = subprocess.Popen(
            [sys.executable, '-m', 'code2vec_tpu_torch.serving.mesh_worker',
             '--address', '%s:%d' % (host, port), '--rid', 'ext-drill',
             '--config-json', str(config_path), '--device', 'cpu'],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        pids.append(ext.pid)
        # the scale-up: the backlog outruns one slow worker
        admitted = [(lines, mesh.submit(lines, tier='topk'))
                    for lines in waves(20)]
        t0 = time.perf_counter()
        assert asc.tick() == 'up'   # blocks through the worker's spawn
        assert time.perf_counter() - t0 < 150.0
        assert mesh.stats()['autoscaler']['scale_up_total'] == 1
        pids += [mesh._replicas[1].transport.pid]
        # the kill: SIGKILL r0 while it holds a batch (the queue's bound
        # is 64 rows, what is left of the first wave included)
        admitted += [(lines, mesh.submit(lines, tier='topk'))
                     for lines in waves(10)]
        slot0 = mesh._replicas[0]
        _wait_until(lambda: slot0.inflight >= 1, timeout=60.0,
                    what='r0 to hold a batch')
        os.kill(slot0.transport.pid, signal.SIGKILL)
        for lines, future in admitted:
            bit_equal(future.result(timeout=180),
                      [expected[line] for line in lines])
        _wait_until(lambda: mesh.stats()['restarts_total'] >= 1,
                    timeout=120.0, what='the restart of r0')
        pids += [slot0.transport.pid]
        assert mesh.stats()['redispatched_total'] >= 1
        # the adoption
        _wait_until(lambda: mesh.stats()['adopted_total'] >= 1,
                    timeout=120.0, what='the adoption of ext-drill')
        rows = {r['replica']: r for r in mesh.stats()['replicas']}
        assert rows['ext-drill']['adopted'] is True
        assert rows['ext-drill']['pid'] == ext.pid
        ext_slot = next(s for s in mesh._replicas if s.rid == 'ext-drill')
        deadline = time.perf_counter() + 120.0
        while ext_slot.batches == 0:   # until the adopted worker served
            assert time.perf_counter() < deadline, 'ext-drill never served'
            for line in PREDICT_LINES:
                bit_equal(mesh.predict([line], tier='topk', timeout=180),
                          [expected[line]])
        per = {r['replica']: r for r in mesh.replica_stats()}
        assert per['ext-drill']['params_step'] == \
            mesh.stats()['params_step'] == 0
        assert per['ext-drill']['graph_captures_after_warmup'] == 0
        # its death: retired, no restart charged here
        restarts = mesh.stats()['restarts_total']
        ext.kill()
        ext.wait(timeout=60)
        _wait_until(lambda: ext_slot.retired, timeout=60.0,
                    what='the adopted worker\'s retirement')
        assert ext_slot.retired_reason == 'adopted_worker_exit'
        time.sleep(0.6)
        assert mesh.stats()['restarts_total'] == restarts
        # the scale-down: sustained idleness drains r1
        _wait_until(lambda: all(r['inflight'] == 0
                                for r in mesh.stats()['replicas']),
                    what='the last completions')
        assert asc.tick() in ('hold', 'down')
        time.sleep(0.4)
        _wait_until(lambda: asc.tick() in ('down', 'hold')
                    and mesh.stats()['autoscaler']['scale_down_total'] >= 1,
                    timeout=60.0, what='the scale-down')
        stats = mesh.stats()
        rows = {r['replica']: r for r in stats['replicas']}
        assert rows['r1']['retired'] is True
        assert rows['r1']['retired_reason'] == 'autoscale'
        assert stats['replicas_live'] == 1
        bit_equal(mesh.predict([PREDICT_LINES[1]], tier='topk', timeout=180),
                  [expected[PREDICT_LINES[1]]])
        assert compiles.value == warm
    finally:
        if ext is not None and ext.poll() is None:
            ext.kill()
            ext.wait(timeout=60)
        if mesh is not None:
            mesh.close()
        core.disable()
        core.reset()
    assert_elastic_reaped(mesh, pids)
    assert not any(_alive(pid) for pid in pids)


# ---------------------------------------------------------- the worker
def test_worker_module_import_chain_is_free_of_jax():
    code = ('import sys; import code2vec_tpu_torch.serving.mesh_worker as w; '
            'import code2vec_tpu_torch.serving.mesh as m; '
            'import code2vec_tpu_torch.serving.autoscaler as a; '
            'w.main; m._replica_worker_main; a.Autoscaler; '
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'code2vec_tpu')); "
            'print(bad); sys.exit(1 if bad else 0)')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr


def test_worker_without_a_card_exits_with_its_reason(tmp_path):
    """No card and no ``--device cpu``: a non-zero exit that says why,
    before the worker dials the mesh (nothing runs on the CPU)."""
    listener = transport_lib.SocketListener('127.0.0.1')
    try:
        host, port = listener.address
        out = subprocess.run(
            [sys.executable, '-m', 'code2vec_tpu_torch.serving.mesh_worker',
             '--address', '%s:%d' % (host, port), '--rid', 'ext-nocard',
             '--load', str(tmp_path / 'model')],
            capture_output=True, text=True, timeout=120, cwd=REPO,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
        assert out.returncode == 2, out.stdout + out.stderr
        assert 'no CUDA device' in out.stderr
        assert listener.wait_adoptable(0.5) is None
    finally:
        listener.close()
    # and a worker with no checkpoint to restore is an argparse error
    out = subprocess.run(
        [sys.executable, '-m', 'code2vec_tpu_torch.serving.mesh_worker',
         '--address', '127.0.0.1:1', '--device', 'cpu'],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 2 and '--load' in out.stderr
