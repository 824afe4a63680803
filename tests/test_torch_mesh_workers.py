"""The serving mesh's worker modes (code2vec_tpu_torch/serving/mesh.py,
``mode='process'`` and ``'socket'``) on the CPU, against the port's own
``predict`` and the reference model, as tests/test_serving_mesh.py drills
them:

- process mode serves through spawned port workers (each its own model
  restored from the checkpoint path, on ``DEVICE='cpu'``, which the
  workers inherit from the model): answers bit for bit the port's
  ``predict`` and within rtol 2e-5 / atol 1e-6 of the reference's on the
  same weights (``convert.py``); stats over the wire; a fleet rollover by
  checkpoint reference; a parameter set refused typed; the result frames
  hold no ``torch.Tensor``; ``close()`` leaves no thread, socket or
  worker process behind;
- the socket kill drill: SIGKILL a worker mid-batch under traffic, every
  admitted request answered (crash-safe redispatch), the supervisor's
  restart rejoining at the step the fleet rolled to while it was down,
  nothing built in the parent;
- the refusals: ``spawn_fail``, and a worker asked for the card on a
  machine without one fails ``serving_mesh()`` with its reason (no
  fallback to the CPU);
- the worker's import chain under spawn holds no JAX and nothing of the
  reference package.

The liveness drills (a missed heartbeat, a partition) are in
tests/test_torch_mesh_workers_heal.py.
"""
import contextlib
import multiprocessing
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from code2vec_tpu_torch.config import Config as PortConfig
from code2vec_tpu_torch.model_api import Code2VecModel as PortModel
from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.serving import transport as transport_lib
from code2vec_tpu_torch.telemetry import core
from tests.test_torch_engine import SHARED, _reference
from tests.test_torch_mesh import ATOL, PREDICT_LINES, RTOL, _wait_until
from tests.test_torch_model import to_port
from tests.test_train_overfit import make_dataset

# a request of several lines, one line repeated, and the single lines
REQUESTS = [PREDICT_LINES, [PREDICT_LINES[2], PREDICT_LINES[0]]] + \
    [[line] for line in PREDICT_LINES]


@pytest.fixture(autouse=True)
def clear_fault_plan():
    faults.configure('')
    yield
    faults.configure('')


def checkpointed_pair(tmp_path_factory, tag):
    """The reference model and a port model over its weights, saved at
    step 0 under the port model's MODEL_SAVE_PATH (the workers restore
    from there)."""
    prefix = make_dataset(tmp_path_factory.mktemp('workers_%s' % tag))
    reference = _reference(prefix)
    save = str(tmp_path_factory.mktemp('workers_%s_model' % tag) / 'model')
    # 8-row batches, as the reference's drills: 3-row requests spread
    # over several batches, so one claim cannot take the whole queue
    port = PortModel(PortConfig(TRAIN_DATA_PATH_PREFIX=str(prefix),
                                MODEL_SAVE_PATH=save,
                                **dict(SHARED, SERVING_BATCH_BUCKETS='8')),
                     device='cpu', params=to_port(reference.params))
    port.state = port.trainer.state_from_params()
    port.save(epoch=0)
    return reference, port


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    return checkpointed_pair(tmp_path_factory, 'serve')


@contextlib.contextmanager
def config_fields(model, **fields):
    """Override config fields for a mesh built inside the block: the
    workers rebuild their Config from the fields the mesh ships."""
    old = {name: getattr(model.config, name) for name in fields}
    for name, value in fields.items():
        setattr(model.config, name, value)
    try:
        yield
    finally:
        for name, value in old.items():
            setattr(model.config, name, value)


def bit_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.original_name == w.original_name
        assert g.topk_predicted_words == w.topk_predicted_words
        np.testing.assert_array_equal(g.topk_predicted_words_scores,
                                      w.topk_predicted_words_scores)


def close_to_reference(got, want):
    """The topk tier against the reference's predict: equal words, scores
    within rtol 2e-5 / atol 1e-6."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.original_name == w.original_name
        assert g.topk_predicted_words == w.topk_predicted_words
        np.testing.assert_allclose(g.topk_predicted_words_scores,
                                   w.topk_predicted_words_scores,
                                   rtol=RTOL, atol=ATOL)


def tensors_in(value) -> int:
    """``torch.Tensor`` objects anywhere inside ``value``."""
    if isinstance(value, torch.Tensor):
        return 1
    if isinstance(value, dict):
        return sum(tensors_in(k) + tensors_in(v) for k, v in value.items())
    if isinstance(value, (list, tuple)):
        return sum(tensors_in(v) for v in value)
    return 0


def worker_pids(mesh):
    return [slot.transport.pid for slot in mesh._replicas]


def assert_nothing_left(mesh, pids):
    """close() reaped the supervisor, the liveness monitor, the
    listener, every puller and receiver, and every worker process."""
    assert not mesh._supervisor.is_alive()
    if mesh._liveness_thread is not None:
        assert not mesh._liveness_thread.is_alive()
    if mesh._listener is not None:
        assert mesh._listener.closed
    for slot in mesh._replicas:
        assert slot.thread is None or not slot.thread.is_alive()
        receiver = getattr(slot.transport, '_receiver', None)
        assert receiver is None or not receiver.is_alive()
    for pid in pids:
        _wait_until(lambda: not _alive(pid), timeout=30.0,
                    what='worker %d to exit' % pid)
    assert not multiprocessing.active_children()


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie the parent has not waited for counts as gone
    try:
        with open('/proc/%d/stat' % pid) as f:
            return f.read().split(') ')[1].split()[0] != 'Z'
    except OSError:
        return False


# ------------------------------------------------------- process mode
def test_process_mode_serves_rolls_and_matches(pair, monkeypatch):
    reference, model = pair
    frames = []
    real_decode = transport_lib.decode_frame

    def decode(data):
        message = real_decode(data)
        frames.append(message)
        return message

    monkeypatch.setattr(transport_lib, 'decode_frame', decode)
    threads = threading.active_count()
    mesh = model.serving_mesh(replicas=2, tiers=('topk',), mode='process',
                              max_delay_ms=0.0)
    pids = worker_pids(mesh)
    try:
        assert len(set(pids)) == 2 and os.getpid() not in pids
        for lines in REQUESTS:
            served = mesh.predict(lines, tier='topk', timeout=120)
            bit_equal(served, model.predict(lines))
            close_to_reference(served, reference.predict(lines))
        # the requests in flight together
        futures = [mesh.submit(lines, tier='topk') for lines in REQUESTS]
        for lines, future in zip(REQUESTS, futures):
            bit_equal(future.result(timeout=120), model.predict(lines))
        # a future resolves before its batch's completion hook runs
        _wait_until(lambda: all(r['inflight'] == 0
                                for r in mesh.stats()['replicas']),
                    what='the last completion hooks')
        stats = mesh.stats()
        assert stats['mode'] == 'process'
        assert [r['pid'] for r in stats['replicas']] == pids
        assert [r['params_step'] for r in stats['replicas']] == [0, 0]
        assert stats['replicas_live'] == 2 and stats['redispatched_total'] \
            == stats['restarts_total'] == stats['heartbeat_misses_total'] == 0
        per_replica = mesh.replica_stats()
        assert [r['replica'] for r in per_replica] == ['r0', 'r1']
        assert [r['pid'] for r in per_replica] == pids
        for row in per_replica:
            assert row['graph_captures_after_warmup'] == 0
            assert row['params_step'] == 0 and row['device_memory'] is None
            assert set(row['kernel_launches']) == {'ragged_fwd', 'encode'}
        assert sum(r['batches_total'] for r in per_replica) == \
            sum(r['batches'] for r in mesh.stats()['replicas'])
        # a rollover by checkpoint reference: the workers restore it
        report = mesh.load_params(0, canary_batches=0).result(timeout=120)
        assert report['swapped'] is True and report['replicas_swapped'] == 2
        assert [r['params_step'] for r in mesh.replica_stats()] == [0, 0]
        bit_equal(mesh.predict(PREDICT_LINES, timeout=120),
                  model.predict(PREDICT_LINES))
        # parameters on the card do not cross the wire: typed refusal
        with pytest.raises(RuntimeError, match='checkpoint refs'):
            mesh.load_params(model.backend.params, canary_batches=0)
        # a third worker joins at the fleet's step; the first two retire
        # (their workers close and exit) and it serves alone
        assert mesh.add_replica() == 'r2'
        pids.append(mesh.stats()['replicas'][2]['pid'])
        for rid in ('r0', 'r1'):
            mesh.retire(rid)
        _wait_until(lambda: not any(_alive(pid) for pid in pids[:2]),
                    timeout=30.0, what='the retired workers to exit')
        bit_equal(mesh.predict(PREDICT_LINES, timeout=120),
                  model.predict(PREDICT_LINES))
        stats = mesh.stats()
        assert [r['retired'] for r in stats['replicas']] == \
            [True, True, False]
        assert stats['replicas'][2]['params_step'] == 0
        assert stats['replicas'][2]['batches'] >= 1
        assert stats['replicas_live'] == 1
        # nothing from the card crossed the wire
        results = [m for m in frames if m[0] == 'result']
        assert results and all(tensors_in(m) == 0 for m in results)
        assert any(isinstance(m[2], list) and m[2]
                   and isinstance(m[2][0], list) for m in results)
    finally:
        mesh.close()
    assert_nothing_left(mesh, pids)
    _wait_until(lambda: threading.active_count() <= threads,
                what='the mesh threads to stop')


# ---------------------------------------------- socket kill drill
def test_socket_kill_drill_redispatch_restart_rejoin(tmp_path_factory):
    """SIGKILL a worker mid-batch: every admitted request still completes
    (crash-safe redispatch onto the sibling), the supervisor restores
    the fleet, and the restarted worker rejoins at the step the fleet
    rolled to while it was down: it cold-starts at a newer step saved
    meanwhile and adopts the fleet's before it pulls. Nothing is built in
    the parent."""
    reference, model = checkpointed_pair(tmp_path_factory, 'kill')
    core.reset()
    core.enable()
    mesh = None
    try:
        compiles = core.registry().counter('jit/compiles_total')
        # the workers' slow_dispatch holds every batch 250 ms, so the
        # SIGKILL lands mid-batch; the restart waits 5 s, while the fleet
        # rolls and a newer step is saved
        with config_fields(model, FAULT_INJECT='slow_dispatch@req=0..63',
                           MESH_HEARTBEAT_SECS=0.25,
                           MESH_HEARTBEAT_MISSES=4,
                           MESH_RESTART_BACKOFF_SECS=5.0,
                           MESH_RESTART_LIMIT=5):
            mesh = model.serving_mesh(replicas=2, tiers=('topk',),
                                      mode='socket', max_delay_ms=0.0)
        assert mesh.stats()['mode'] == 'socket'
        unloaded = {line: model.predict([line])[0] for line in PREDICT_LINES}
        (first,) = mesh.predict([PREDICT_LINES[0]], tier='topk', timeout=120)
        bit_equal([first], [unloaded[PREDICT_LINES[0]]])
        close_to_reference([first], reference.predict([PREDICT_LINES[0]]))
        warm = compiles.value
        slot0 = mesh._replicas[0]
        first_pid = slot0.transport.pid
        # 10 requests of 3 rows over 8-row batches: several batches in
        # flight at once, on both replicas
        batches_lines = [[PREDICT_LINES[(i + j) % 3] for j in range(3)]
                         for i in range(10)]
        admitted = [mesh.submit(lines, tier='topk')
                    for lines in batches_lines]
        _wait_until(lambda: slot0.inflight >= 1, timeout=30.0,
                    what='r0 to hold a batch in flight')
        os.kill(first_pid, signal.SIGKILL)
        for lines, future in zip(batches_lines, admitted):
            bit_equal(future.result(timeout=120),
                      [unloaded[line] for line in lines])
        _wait_until(lambda: slot0.dead or slot0.restarts >= 1,
                    timeout=30.0, what='the death verdict on r0')
        assert mesh.stats()['redispatched_total'] >= 1
        # roll the fleet while r0 is down, then save a newer step: r0
        # must rejoin at the rolled step, not at its cold start's
        model.save(state=model.state._replace(step=7), epoch=0)
        report = mesh.load_params(7, canary_batches=0).result(timeout=120)
        assert report['swapped'] is True
        model.save(state=model.state._replace(step=9), epoch=0)
        assert slot0.dead
        _wait_until(lambda: mesh.stats()['restarts_total'] >= 1
                    and not slot0.dead, timeout=120.0,
                    what='the supervised restart of r0')
        assert slot0.transport.pid != first_pid
        before = slot0.batches
        deadline = time.perf_counter() + 60.0
        while slot0.batches == before:
            assert time.perf_counter() < deadline, 'restarted r0 never served'
            mesh.predict([PREDICT_LINES[0]], tier='topk', timeout=120)
        assert slot0.transport.ready_info['params_step'] == 9
        per_replica = {r['replica']: r for r in mesh.replica_stats()}
        assert per_replica['r0']['params_step'] == 7
        assert per_replica['r1']['params_step'] == 7
        stats = mesh.stats()
        assert stats['params_step'] == 7 and stats['replicas_live'] == 2
        assert [r['params_step'] for r in stats['replicas']] == [7, 7]
        assert compiles.value == warm
        pids = worker_pids(mesh)
    finally:
        if mesh is not None:
            mesh.close()
        core.disable()
        core.reset()
    assert_nothing_left(mesh, pids + [first_pid])


# ------------------------------------------------------ the refusals
def test_spawn_fail_fails_the_mesh_typed(pair):
    _reference_model, model = pair
    threads = threading.active_count()
    faults.configure('spawn_fail@spawn=0')
    with pytest.raises(RuntimeError, match='spawn_fail'):
        model.serving_mesh(replicas=1, tiers=('topk',), mode='process')
    assert not multiprocessing.active_children()
    _wait_until(lambda: threading.active_count() <= threads,
                what='the mesh threads to stop')


@pytest.mark.parametrize('mode', ['process', 'socket'])
def test_worker_on_a_missing_card_fails_with_its_reason(pair, monkeypatch,
                                                        mode):
    """The workers run where the parent model runs: a model on the card
    ships DEVICE='cuda', and a worker on a machine with no GPU fails its
    cold start and says why. Nothing falls back to the CPU."""
    _reference_model, model = pair
    monkeypatch.setattr(model, 'device', torch.device('cuda'))
    with pytest.raises(RuntimeError, match='failed to start.*no CUDA device'):
        model.serving_mesh(replicas=2, tiers=('topk',), mode=mode)
    _wait_until(lambda: not multiprocessing.active_children(),
                what='the failed workers to be reaped')


def test_worker_import_chain_is_free_of_jax():
    """A spawned worker imports serving/mesh.py to reach its entry point,
    and nothing of JAX or of the reference package comes with it."""
    code = ('import sys; import code2vec_tpu_torch.serving.mesh as m; '
            'm._replica_worker_main; '
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'code2vec_tpu')); "
            'print(bad); sys.exit(1 if bad else 0)')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stdout + out.stderr
