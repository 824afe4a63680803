"""The port's parallel layer (code2vec_tpu_torch/parallel/) on the CPU, and
the harness the other ``test_torch_parallel_*`` files run their worlds
with.

A world is N spawned Python processes of the port (no JAX imported in
them), joined over gloo through a ``FileStore`` in ``tmp_path`` (no TCP
port), each with a timeout on its collectives; the parent waits for all
of them with a deadline, and one rank's exception fails the test with
its traceback while the parent kills the rest (``run_world``). A rank
runs ``<module>:<function>(rank, **kwargs)`` and sends its picklable
result back through a file.

Here: the mesh's layout, shard/gather round trips and collectives (a
gather brings every bit, -0.0 and bf16 included); the table gradient of
a row range; ``maybe_initialize_distributed``'s refusals (no quiet
switch between nccl and gloo); ``--mesh`` and ``--dist-backend`` against
the JAX CLI's parse; the Trainer's divisibility checks, LAZY_EMBEDDING_ADAM
refused typed on a mesh and A9b's other knobs absent; the target table's rows against the reference's
``target_row_alignment`` for model axes 1, 2 and 4.
"""
import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD_DEADLINE_S = 240.0


# ------------------------------------------------------------ the harness
def run_world(target: str, world: int, tmp_path: Path, kwargs=None,
              deadline_s: float = WORLD_DEADLINE_S) -> list:
    """Run ``target`` ('module:function') on ``world`` gloo ranks, each a
    process of its own; returns each rank's result, in rank order. A rank
    that fails fails the call with its stderr; a world that outlives
    ``deadline_s`` is killed."""
    root = Path(tmp_path) / ('world-%d' % time.monotonic_ns())
    root.mkdir(parents=True)
    (root / 'kwargs.pkl').write_bytes(pickle.dumps(kwargs or {}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get('PYTHONPATH', '').split(
            os.pathsep) if p]), OMP_NUM_THREADS='2')
    procs = []
    for rank in range(world):
        err = open(root / ('rank%d.err' % rank), 'w')
        procs.append((subprocess.Popen(
            [sys.executable, '-m', 'tests.test_torch_parallel', target,
             str(rank), str(world), str(root)], cwd=str(REPO), env=env,
            stdout=err, stderr=subprocess.STDOUT), err))
    end = time.monotonic() + deadline_s
    failed = []
    try:
        while True:
            codes = [p.poll() for p, _ in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                break
            if time.monotonic() > end:
                failed = [r for r, c in enumerate(codes) if c is None]
                break
            time.sleep(0.05)
    finally:
        for p, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
    if failed:
        logs = '\n'.join('--- rank %d ---\n%s' % (
            r, (root / ('rank%d.err' % r)).read_text()[-6000:])
            for r in failed)
        raise AssertionError('world of %d failed (%s) at ranks %s:\n%s'
                             % (world, target, failed, logs))
    return [pickle.loads((root / ('rank%d.out' % r)).read_bytes())
            for r in range(world)]


def _rank_main(target: str, rank: int, world: int, root: Path) -> int:
    import importlib

    import torch.distributed as dist

    from code2vec_tpu_torch.parallel import distributed
    torch.set_num_threads(2)
    store = dist.FileStore(str(root / 'store'), world)
    distributed.maybe_initialize_distributed(
        world_size=world, rank=rank, backend='gloo', store=store,
        timeout_s=120)
    module, name = target.split(':')
    kwargs = pickle.loads((root / 'kwargs.pkl').read_bytes())
    result = getattr(importlib.import_module(module), name)(rank, **kwargs)
    (root / ('rank%d.out' % rank)).write_bytes(pickle.dumps(result))
    distributed.shutdown()
    return 0


def mesh_config(data: int, model: int, **overrides):
    from code2vec_tpu_torch.config import Config
    return Config(MESH_DATA_AXIS_SIZE=data, MESH_MODEL_AXIS_SIZE=model,
                  **overrides)


def sub_mesh(data: int, model: int):
    """The (data, model) mesh over ranks [0, data * model) of the world
    (every rank of the world calls it)."""
    from code2vec_tpu_torch.parallel.mesh import create_mesh
    return create_mesh(mesh_config(data, model), ranks=range(data * model))


# ----------------------------------------------------- rank-side programs
def collectives_rank(rank: int) -> dict:
    from code2vec_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                  create_mesh)
    mesh = create_mesh(mesh_config(2, 2))
    out = {'coords': (mesh.data_index, mesh.model_index),
           'model_ranks': mesh.model_ranks, 'data_ranks': mesh.data_ranks}
    # a gather brings every bit: -0.0 and bf16 values as they left
    local = torch.tensor([[-0.0, 1.5 + rank], [rank * 1e-30, -2.0]],
                         dtype=torch.bfloat16)
    out['gathered'] = mesh.gather_rows(local).view(torch.int16).numpy()
    full = {'token_embedding': torch.arange(16.).reshape(8, 2),
            'path_embedding': torch.arange(8.).reshape(4, 2),
            'target_embedding': torch.arange(12.).reshape(4, 3),
            'transform': torch.ones(6, 3), 'attention': torch.ones(3, 1)}
    shard = mesh.shard_params(full)
    out['shard_rows'] = shard['token_embedding'][:, 0].tolist()
    back = mesh.gather_params(shard)
    out['round_trip'] = all(torch.equal(back[k], full[k]) for k in full)
    out['batch'] = mesh.shard_batch((np.arange(8),))[0].tolist()
    summed = mesh.all_reduce(torch.tensor([float(rank)]), DATA_AXIS)
    out['data_sum'] = float(summed)
    out['model_sum'] = float(mesh.all_reduce(torch.tensor([float(rank)]),
                                             MODEL_AXIS))
    # a (1, 2) sub-mesh of the first two ranks; the others stay out
    sub = create_mesh(mesh_config(1, 2), ranks=[0, 1])
    out['sub_member'] = sub.member
    if sub.member:
        out['sub_sum'] = float(sub.all_reduce(torch.tensor([1.0]), None))
    return out


# ------------------------------------------------------------------ tests
def test_world_layout_and_collectives(tmp_path):
    results = run_world('tests.test_torch_parallel:collectives_rank', 4,
                        tmp_path)
    for rank, out in enumerate(results):
        d, m = divmod(rank, 2)
        assert out['coords'] == (d, m)
        assert out['model_ranks'] == (2 * d, 2 * d + 1)
        assert out['data_ranks'] == (m, m + 2)
        want = torch.cat([torch.tensor(
            [[-0.0, 1.5 + r], [r * 1e-30, -2.0]], dtype=torch.bfloat16)
            for r in (2 * d, 2 * d + 1)]).view(torch.int16).numpy()
        np.testing.assert_array_equal(out['gathered'], want)
        assert out['shard_rows'] == [0.0, 2.0, 4.0, 6.0] if m == 0 else \
            out['shard_rows'] == [8.0, 10.0, 12.0, 14.0]
        assert out['round_trip']
        assert out['batch'] == list(range(4 * d, 4 * d + 4))
        assert out['data_sum'] == m + (m + 2)
        assert out['model_sum'] == 4 * d + 1
        assert out['sub_member'] == (rank < 2)
        if rank < 2:
            assert out['sub_sum'] == 2.0


def test_failing_rank_fails_the_world(tmp_path):
    with pytest.raises(AssertionError, match='ZeroDivisionError'):
        run_world('tests.test_torch_parallel:failing_rank', 2, tmp_path,
                  deadline_s=60)


def failing_rank(rank: int):
    if rank == 1:
        return 1 / 0
    # rank 0 waits on a collective its peer never joins: the parent must
    # kill it rather than wait for the store's timeout
    import torch.distributed as dist
    dist.barrier()
    return None


@pytest.mark.parametrize('impl', ['dense', 'sorted', 'dedup'])
def test_table_grad_row_range(impl):
    """A rank's rows of the table gradient: the indices in its range land
    at idx - lo, the rest nowhere; the slices of all ranks are the whole
    gradient."""
    from code2vec_tpu_torch.ops.embed_grad import table_grad
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 16, 40))
    whole = table_grad(g, idx, 16, torch.float32, impl)
    parts = [table_grad(g, idx, 4, torch.float32, impl,
                        row_range=(4 * m, 4 * m + 4)) for m in range(4)]
    np.testing.assert_allclose(torch.cat(parts).numpy(), whole.numpy(),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match='not 4 rows'):
        table_grad(g, idx, 4, torch.float32, impl, row_range=(0, 5))


def test_initialize_is_a_no_op_on_one_rank_and_refuses_quiet_switches(
        monkeypatch):
    from code2vec_tpu_torch.parallel import distributed
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    assert distributed.maybe_initialize_distributed() is False
    assert distributed.world_size() == 1 and distributed.rank() == 0
    with pytest.raises(ValueError, match='backend must be one of'):
        distributed.maybe_initialize_distributed(world_size=2, rank=0,
                                                 backend='mpi')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='name backend="gloo"'):
        distributed.maybe_initialize_distributed(world_size=2, rank=0)
    # two nccl ranks on one card: refused before NCCL sees them
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(RuntimeError, match='one card per rank'):
        distributed.maybe_initialize_distributed(world_size=2, rank=1,
                                                 local_rank=1)
    monkeypatch.setenv('LOCAL_WORLD_SIZE', '4')
    with pytest.raises(RuntimeError, match='Duplicate GPU'):
        distributed.maybe_initialize_distributed(world_size=4, rank=0,
                                                 local_rank=0)
    monkeypatch.setenv('WORLD_SIZE', '2')
    monkeypatch.delenv('RANK', raising=False)
    with pytest.raises(ValueError, match='no RANK'):
        distributed.maybe_initialize_distributed(backend='gloo')


def test_mesh_flags_match_the_reference_cli():
    from code2vec_tpu.config import Config as JaxConfig
    from code2vec_tpu_torch.config import Config
    for flag in ('2x2', '4X1', '1x2'):
        want = JaxConfig().load_from_args(['--data', 'd', '--mesh', flag])
        got = Config().load_from_args(['--data', 'd', '--mesh', flag])
        assert (got.MESH_DATA_AXIS_SIZE, got.MESH_MODEL_AXIS_SIZE) == (
            want.MESH_DATA_AXIS_SIZE, want.MESH_MODEL_AXIS_SIZE)
    assert (Config().MESH_DATA_AXIS_SIZE, Config().MESH_MODEL_AXIS_SIZE) \
        == (JaxConfig().MESH_DATA_AXIS_SIZE, JaxConfig().MESH_MODEL_AXIS_SIZE)
    with pytest.raises(ValueError, match='DATAxMODEL'):
        Config().load_from_args(['--data', 'd', '--mesh', '2by2'])
    assert Config().DIST_BACKEND == 'nccl'
    got = Config().load_from_args(['--data', 'd', '--dist-backend', 'gloo'])
    assert got.DIST_BACKEND == 'gloo'
    # A9b's flag is not served yet: an argparse error, not a quiet no-op
    with pytest.raises(SystemExit):
        Config().load_from_args(['--data', 'd', '--opt-state-sharding',
                                 'zero'])


def test_trainer_checks_and_a9b_refusals():
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.parallel.mesh import (MeshUnsupported,
                                                  check_trainer_config,
                                                  create_mesh)
    mesh22 = SimpleNamespace(data=2, model=2, size=4)
    check_trainer_config(Config(), mesh22)
    with pytest.raises(ValueError, match='TRAIN_BATCH_SIZE=1023'):
        check_trainer_config(Config(TRAIN_BATCH_SIZE=1023), mesh22)
    with pytest.raises(ValueError, match='TEST_BATCH_SIZE=7'):
        check_trainer_config(Config(TEST_BATCH_SIZE=7), mesh22)
    with pytest.raises(ValueError, match='PARAM_ROW_ALIGNMENT=6'):
        check_trainer_config(Config(PARAM_ROW_ALIGNMENT=6),
                             SimpleNamespace(data=1, model=4, size=4))
    # A9b's knobs of paths not ported are no config keys yet
    for name in ('SHARD_CONTEXTS', 'OPTIMIZER_STATE_SHARDING'):
        with pytest.raises(TypeError, match=name):
            Config(**{name: True})
    for knobs, name in ((dict(LAZY_EMBEDDING_ADAM=True),
                         'LAZY_EMBEDDING_ADAM'),
                        (dict(TELEMETRY=True), 'TELEMETRY')):
        with pytest.raises(MeshUnsupported, match=name + '.*A9b'):
            check_trainer_config(Config(**knobs), mesh22)
        # one rank: read as the reference reads them
        check_trainer_config(Config(**knobs), None)
    # the mesh's size against the world's (one rank here)
    with pytest.raises(ValueError, match='Mesh 0x2 does not match 1 ranks'):
        create_mesh(mesh_config(-1, 2))
    assert create_mesh(mesh_config(-1, 1)).size == 1


def test_cli_mesh_that_the_world_does_not_hold_raises():
    """``--mesh 4x2`` on one rank: the shape against the world's ranks,
    before anything is read or allocated."""
    from code2vec_tpu_torch.cli import main
    with pytest.raises(ValueError, match='Mesh 4x2 does not match 1 ranks'):
        main(['--data', 'no-such-prefix', '--mesh', '4x2', '--device',
              'cpu'])


@pytest.mark.parametrize('model_axis', [1, 2, 4])
def test_target_rows_follow_the_reference_alignment(model_axis):
    """java14m's 261,245 targets under the fused CE: lcm(128, 1024 x
    model) rows, as the reference's ``target_row_alignment``."""
    from code2vec_tpu.config import Config as JaxConfig
    from code2vec_tpu.models.backends import \
        target_row_alignment as jax_alignment
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.backends import (table_sizes,
                                                   target_row_alignment)
    knobs = dict(USE_PALLAS_FUSED_CE=True, MESH_MODEL_AXIS_SIZE=model_axis)
    assert target_row_alignment(Config(**knobs)) == jax_alignment(
        JaxConfig(**knobs))
    vocab = SimpleNamespace(size=261245, pad_index=0)
    sizes = table_sizes(Config(**knobs), SimpleNamespace(
        token_vocab=vocab, path_vocab=vocab, target_vocab=vocab))
    assert sizes['target_vocab_size'] % (1024 * model_axis) == 0


if __name__ == '__main__':
    try:
        code = _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                          Path(sys.argv[4]))
    except Exception:
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
