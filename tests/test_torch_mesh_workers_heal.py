"""The serving mesh's liveness drills in the worker modes
(code2vec_tpu_torch/serving/mesh.py) on the CPU, as the reference's
tests/test_serving_mesh.py drills them:

- a worker that stays connected but stops heartbeating (``drop_heartbeat``;
  nothing in flight, so the breaker sees nothing) is killed and
  restarted; when the restarted worker goes silent the same way, the
  restart budget retires the replica and the mesh refuses new work
  typed;
- a partition (every frame to the parent dropped while both ends stay
  up) is caught by the liveness monitor; the blackholed batch is
  redispatched and answered, bit for bit the port's ``predict``, once
  the restarted worker serves.

Short heartbeats, as the reference's drills use.
"""
import pytest

from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.serving.errors import EngineClosed
from tests.test_torch_mesh import PREDICT_LINES, _wait_until
from tests.test_torch_mesh_workers import (assert_nothing_left, bit_equal,
                                           checkpointed_pair, config_fields,
                                           worker_pids)


@pytest.fixture(autouse=True)
def clear_fault_plan():
    faults.configure('')
    yield
    faults.configure('')


@pytest.fixture(scope='module')
def model(tmp_path_factory):
    return checkpointed_pair(tmp_path_factory, 'heal')[1]


def test_heartbeat_miss_restarts_then_budget_retires_typed(model):
    with config_fields(model, FAULT_INJECT='drop_heartbeat@beat=2..9999',
                       MESH_HEARTBEAT_SECS=0.2, MESH_HEARTBEAT_MISSES=2,
                       MESH_RESTART_BACKOFF_SECS=0.05, MESH_RESTART_LIMIT=1,
                       MESH_RESTART_WINDOW_SECS=300.0):
        mesh = model.serving_mesh(replicas=1, tiers=('topk',),
                                  mode='process', max_delay_ms=0.0)
    pids = worker_pids(mesh)
    try:
        # the worker serves: it is connected and healthy, only its
        # liveness signal is gone
        bit_equal(mesh.predict([PREDICT_LINES[0]], tier='topk', timeout=120),
                  model.predict([PREDICT_LINES[0]]))
        _wait_until(lambda: mesh.stats()['restarts_total'] >= 1,
                    timeout=90.0, what='the liveness kill and the restart')
        assert mesh.stats()['heartbeat_misses_total'] >= 1
        pids += worker_pids(mesh)
        # the restarted worker goes silent too: the budget (1 a window)
        # is spent and the replica retires for good
        _wait_until(lambda: mesh._replicas[0].retired, timeout=90.0,
                    what='the restart budget to retire the replica')
        with pytest.raises(EngineClosed, match='retired'):
            mesh.submit([PREDICT_LINES[0]], tier='topk')
        stats = mesh.stats()
        row = stats['replicas'][0]
        assert row['retired'] is True and row['dead'] is True
        assert row['retired_reason'] == 'restart_budget'
        assert row['restarts'] == 1 and stats['replicas_live'] == 0
        assert mesh.replica_stats() == [{'replica': 'r0', 'dead': True,
                                         'retired': True}]
    finally:
        mesh.close()
    assert_nothing_left(mesh, pids)


def test_partition_liveness_detects_and_redispatches(model):
    with config_fields(model, MESH_HEARTBEAT_SECS=0.2,
                       MESH_HEARTBEAT_MISSES=2,
                       MESH_RESTART_BACKOFF_SECS=0.05, MESH_RESTART_LIMIT=5,
                       MESH_RESTART_WINDOW_SECS=300.0):
        mesh = model.serving_mesh(replicas=1, tiers=('topk',),
                                  mode='process', max_delay_ms=0.0)
    pids = worker_pids(mesh)
    try:
        want = model.predict([PREDICT_LINES[1]])
        bit_equal(mesh.predict([PREDICT_LINES[1]], tier='topk', timeout=120),
                  want)
        # blackhole every frame the parent receives: the worker computes
        # and beats into the void
        faults.configure('partition@frame=0..99999')
        doomed = mesh.submit([PREDICT_LINES[1]], tier='topk')
        _wait_until(lambda: mesh._replicas[0].dead
                    or mesh.stats()['restarts_total'] >= 1, timeout=90.0,
                    what='liveness to declare the partition')
        assert mesh.stats()['heartbeat_misses_total'] >= 1
        # the partition heals; the restarted worker's frames pass
        faults.configure('')
        bit_equal(doomed.result(timeout=120), want)
        _wait_until(lambda: mesh.stats()['restarts_total'] >= 1,
                    timeout=120.0, what='the restart after the partition')
        stats = mesh.stats()
        assert stats['redispatched_total'] >= 1
        assert stats['replicas'][0]['restarts'] >= 1
        pids += worker_pids(mesh)
    finally:
        faults.configure('')
        mesh.close()
    assert_nothing_left(mesh, pids)
