"""The training knobs of the port on a (data, model) mesh of gloo ranks on
the CPU, against the reference on the conftest's virtual devices, same
weights (code2vec_tpu_torch/convert.py) and batches, keep 1.0:

- SHARD_CONTEXTS on the plane wire: one ``Trainer.train_step`` on (2, 2)
  against the reference ``Trainer`` on a (2, 2) mesh with
  SHARD_CONTEXTS=True (materialized logits and the streamed CE), and one
  at a long bag (C = 64) whose second context slice holds padding
  alone: the loss and every parameter slice; the dense weights bit for
  bit equal on the four ranks; REMAT_ENCODE equal bit for bit;
  ``evaluate()`` with the fused encode's plain version against the
  single-device reference ``evaluate()``;
- OPTIMIZER_STATE_SHARDING='zero': three steps against the reference
  ``Trainer`` with 'zero' on (2, 2), the parameters and the gathered
  moments; the port's 'zero' equal to its 'mirror' bit for bit, each
  rank holding a quarter of every table's moment rows;
- LAZY_EMBEDDING_ADAM on (2, 2): one step against the single-device
  reference lazy step, with a token row that only data shard 1 touches;
  untouched rows and their moments bit for bit as they were;
- TELEMETRY on (2, 2): ``train()`` writes rank 0's files unsuffixed and
  rank r's with ``.proc<r>``, no two ranks one path, ``train/mfu``
  finite on each;
- checkpoints across layouts: a 'zero' checkpoint of (2, 2) restored
  under 'mirror' on one rank, and a one-rank checkpoint restored under
  'zero' on (2, 2).

Tolerances (tests/test_torch_parallel_train.py): the loss at rtol 2e-5;
fp32 parameters at rtol 2e-5 / atol 1e-6; bf16-stored moments within one
bf16 rounding. One world of four ranks runs every case.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest

from code2vec_tpu_torch import convert
from tests.test_packed import random_plane_batch
from tests.test_torch_parallel import run_world
from tests.test_torch_parallel_train import (BF16_STEP, NAMES, STEP_KNOBS,
                                             _gather, assert_rows_equal,
                                             model_knobs, step_batch,
                                             to_numpy)
from tests.test_train_overfit import make_dataset

FP32 = dict(rtol=2e-5, atol=1e-6)
LONG_C = 64
# (name, fused CE) of the SHARD_CONTEXTS steps
SHARD_ROUTES = (('logits', False), ('fused_ce', True))
ZERO_STEPS = 3
ONLY_SHARD1_ROW = 31     # a token row only data shard 1's examples touch


def long_batch():
    """8 examples of 64 contexts, each with at most 24 valid: the second
    model slice (contexts 32-63) holds padding alone."""
    batch = random_plane_batch(np.random.default_rng(11), 8, LONG_C,
                               pad_row_rate=0.0)
    dead = np.arange(LONG_C)[None, :] >= 24
    for plane in (batch.source, batch.path, batch.target):
        plane[np.broadcast_to(dead, plane.shape)] = 0
    mask = batch.mask * ~dead
    return batch._replace(mask=mask.astype(np.float32),
                          label=(batch.label % 16).astype(np.int32))


def lazy_batch():
    """``step_batch`` with token row 31 in the first slot of one weighted
    example of data shard 1 (rows 4-7) and nowhere else."""
    batch = step_batch()
    source, target, path = (batch.source.copy(), batch.target.copy(),
                            batch.path.copy())
    for plane in (source, target):
        plane[plane == ONLY_SHARD1_ROW] = 30
    row = 4 + int(np.argmax(batch.weight[4:] > 0))
    assert batch.weight[row] > 0
    source[row, 0] = ONLY_SHARD1_ROW
    path[row, 0] = max(int(path[row, 0]), 1)
    mask = batch.mask.copy()
    mask[row, 0] = 1.0
    return batch._replace(source=source, target=target, path=path,
                          mask=mask)


def zero_batches():
    rng = np.random.default_rng(3)
    out = []
    for _ in range(ZERO_STEPS):
        batch = random_plane_batch(rng, 8, 4, pad_row_rate=0.25)
        out.append(batch._replace(label=(batch.label % 16).astype(np.int32)))
    return out


def sized_vocabs():
    vocab = lambda size: SimpleNamespace(size=size, pad_index=0)  # noqa
    return SimpleNamespace(token_vocab=vocab(32), path_vocab=vocab(16),
                           target_vocab=vocab(16))


def mesh_weights(model_weights, rows=2048):
    """The tiny model's weights at a (2, 2) mesh's allocation: the fused
    CE's target rows grow with the model axis (masked padding)."""
    target = model_weights['target_embedding']
    return dict(model_weights, target_embedding=np.concatenate([
        target, np.zeros((rows - target.shape[0], target.shape[1]),
                         np.float32)]))


# ------------------------------------------------------------- the ranks
def arrays_of(batch):
    return tuple(np.asarray(a) for a in batch.device_arrays())


def knobs_rank(rank, shard_steps, long_step, zero_weights, zero_steps,
               lazy_weights, lazy_step, data_dir, model_weights,
               one_rank_ckpt):
    import torch
    import torch.distributed as dist

    from code2vec_tpu_torch.checkpoints import map_opt_state
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    from code2vec_tpu_torch.models.backends import TorchBackend
    from code2vec_tpu_torch.parallel.mesh import create_mesh
    from code2vec_tpu_torch.training.trainer import Trainer
    mesh = create_mesh(Config(MESH_DATA_AXIS_SIZE=2, MESH_MODEL_AXIS_SIZE=2))
    shape = dict(MESH_DATA_AXIS_SIZE=2, MESH_MODEL_AXIS_SIZE=2)
    vocabs = sized_vocabs()
    coords = (mesh.data_index, mesh.model_index)
    out = {'coords': coords}

    def trainer_for(weights, **knobs):
        config = Config(TRAIN_DATA_PATH_PREFIX='unused', **shape,
                        **dict(STEP_KNOBS, **knobs))
        backend = TorchBackend(config, vocabs, torch.device('cpu'),
                               params=convert.params_from_numpy(weights),
                               mesh=mesh)
        trainer = Trainer(config, backend, mesh=mesh)
        return trainer, trainer.state_from_params()

    def record(trainer, state, loss):
        return dict(coords=coords, loss=float(loss),
                    params=convert.params_to_numpy(state.params),
                    opt=map_opt_state(
                        trainer.named_opt_state(state.opt_state),
                        lambda named: {k: t.detach().float().numpy().copy()
                                       for k, t in named.items()}))

    def step(trainer, state, batch):
        local = tuple(np.ascontiguousarray(a) for a in
                      mesh.shard_batch(batch))
        return trainer.train_step(state, local)

    # SHARD_CONTEXTS on the plane wire, and REMAT_ENCODE with it
    out['shard'] = {}
    for (name, fused), (weights, batch) in zip(SHARD_ROUTES, shard_steps):
        for remat in (False, True):
            trainer, state = trainer_for(
                weights, BATCH_WIRE_FORMAT='planes', SHARD_CONTEXTS=True,
                USE_PALLAS_FUSED_CE=fused, REMAT_ENCODE=remat)
            state, loss = step(trainer, state, batch)
            out['shard'][name + ('_remat' if remat else '')] = record(
                trainer, state, loss)
    weights, batch = long_step
    trainer, state = trainer_for(weights, BATCH_WIRE_FORMAT='planes',
                                 SHARD_CONTEXTS=True, MAX_CONTEXTS=LONG_C)
    state, loss = step(trainer, state, batch)
    out['shard']['long'] = record(trainer, state, loss)

    # 'zero' and 'mirror': three steps each, from the same weights
    out['zero'] = {}
    for layout in ('zero', 'mirror'):
        trainer, state = trainer_for(zero_weights, BATCH_WIRE_FORMAT='planes',
                                     OPTIMIZER_STATE_SHARDING=layout)
        held = sum(t.numel() for t in state.opt_state.mu)
        for batch in zero_steps:
            state, loss = step(trainer, state, batch)
        rec = record(trainer, state, loss)
        rec['held_mu'] = held
        out['zero'][layout] = rec

    # lazy Adam
    trainer, state = trainer_for(lazy_weights, BATCH_WIRE_FORMAT='planes',
                                 LAZY_EMBEDDING_ADAM=True,
                                 ADAM_MU_DTYPE='float32',
                                 ADAM_NU_DTYPE='float32',
                                 LEARNING_RATE=0.01)
    state, loss = step(trainer, state, lazy_step)
    out['lazy'] = record(trainer, state, loss)

    # evaluate() with SHARD_CONTEXTS on the plane wire, the fused encode
    os.chdir(data_dir)
    knobs = dict(model_knobs(data_dir), BATCH_WIRE_FORMAT='planes',
                 SHARD_CONTEXTS=True, USE_PALLAS_FUSED_ENCODE=True)
    model = Code2VecModel(Config(**shape, **knobs), device='cpu', mesh=mesh,
                          params=convert.params_from_numpy(
                              mesh_weights(model_weights)))
    out['eval'] = model.evaluate()

    # train() under 'zero' with telemetry on, saving its last epoch
    tele_dir = data_dir / 'tele'
    model = Code2VecModel(Config(
        **shape, **dict(model_knobs(data_dir), TEST_DATA_PATH=None),
        MODEL_SAVE_PATH=str(data_dir / 'zero' / 'saved'),
        OPTIMIZER_STATE_SHARDING='zero', TELEMETRY=True,
        TELEMETRY_DIR=str(tele_dir), TELEMETRY_TRACE_AT_STEP=1,
        TELEMETRY_TRACE_NUM_STEPS=1, TELEMETRY_FLUSH_EVERY_STEPS=1),
        device='cpu', mesh=mesh, seed=6)
    model.train()
    from code2vec_tpu_torch.telemetry import core
    mfu = core.registry().snapshot().get('train/mfu')
    out['mfu'] = None if mfu is None else float(mfu)
    out['trained'] = {
        'coords': coords,
        'params': convert.params_to_numpy(model.backend.gathered_params()),
        'opt': map_opt_state(
            model.trainer.named_opt_state(model.state.opt_state),
            lambda named: {k: t.detach().float().numpy().copy()
                           for k, t in named.items()}),
        'step': model.state.step}
    core.disable()
    mesh.barrier()
    out['tele_files'] = sorted(
        os.path.relpath(os.path.join(d, f), tele_dir)
        for d, _dirs, files in os.walk(tele_dir) for f in files)
    out['trace_dirs'] = sorted(os.listdir(tele_dir / 'traces'))

    # a one-rank checkpoint restored under 'zero' on (2, 2)
    restored = Code2VecModel(Config(
        **shape, **model_knobs(data_dir), MODEL_LOAD_PATH=one_rank_ckpt,
        OPTIMIZER_STATE_SHARDING='zero'), device='cpu', mesh=mesh)
    out['restored'] = {
        'coords': coords,
        'params': convert.params_to_numpy(restored.backend.params),
        'opt': convert.opt_state_to_numpy(restored.state.opt_state),
        'step': restored.state.step}
    dist.barrier()
    return out


# ----------------------------------------------------- the reference side
def jax_trainer(wire, fused, mesh=(2, 2), **knobs):
    from code2vec_tpu.config import Config
    from code2vec_tpu.models.backends import create_backend
    from code2vec_tpu.training.trainer import Trainer
    from code2vec_tpu.vocab import SizeOnlyVocabs
    data, model = mesh
    config = Config(
        TRAIN_DATA_PATH_PREFIX='unused', DL_FRAMEWORK='jax', VERBOSE_MODE=0,
        READER_USE_NATIVE=False, MAX_TOKEN_VOCAB_SIZE=32,
        MAX_PATH_VOCAB_SIZE=16, MAX_TARGET_VOCAB_SIZE=16,
        TARGET_EMBEDDINGS_SIZE=24, MESH_DATA_AXIS_SIZE=data,
        MESH_MODEL_AXIS_SIZE=model,
        MESH_DEVICE_INDICES=','.join(str(i) for i in range(data * model)),
        BATCH_WIRE_FORMAT=wire, USE_PALLAS_FUSED_CE=fused,
        **dict(STEP_KNOBS, **knobs))
    return Trainer(config, create_backend(config, SizeOnlyVocabs(32, 16, 16)))


def jax_steps(trainer, batches, moments=True):
    state = trainer.init_state()
    weights = to_numpy(state.params)
    for batch in batches:
        state, loss = trainer.train_step(state, batch)
    want = dict(loss=float(loss), params=to_numpy(state.params))
    if moments:
        want.update(mu=to_numpy(state.opt_state[0].mu),
                    nu=to_numpy(state.opt_state[0].nu))
    return weights, want


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The reference's steps and model, then the world of four ranks."""
    from code2vec_tpu.config import Config
    from code2vec_tpu.model_api import Code2VecModel
    from code2vec_tpu_torch.config import Config as PortConfig
    from code2vec_tpu_torch.model_api import Code2VecModel as PortModel
    from tests.test_torch_model import to_port
    root = tmp_path_factory.mktemp('knobs-world')
    wants = SimpleNamespace(shard={})
    shard_steps = []
    for name, fused in SHARD_ROUTES:
        weights, want = jax_steps(
            jax_trainer('planes', fused, SHARD_CONTEXTS=True), [step_batch()])
        shard_steps.append((weights, arrays_of(step_batch())))
        wants.shard[name] = want
    weights, wants.shard['long'] = jax_steps(
        jax_trainer('planes', False, SHARD_CONTEXTS=True,
                    MAX_CONTEXTS=LONG_C), [long_batch()])
    long_step = (weights, arrays_of(long_batch()))
    zero_weights, wants.zero = jax_steps(
        jax_trainer('planes', False, OPTIMIZER_STATE_SHARDING='zero'),
        zero_batches())
    lazy_weights, wants.lazy = jax_steps(
        jax_trainer('planes', False, mesh=(1, 1), LAZY_EMBEDDING_ADAM=True,
                    LEARNING_RATE=0.01), [lazy_batch()], moments=False)
    data_dir = root / 'data'
    data_dir.mkdir()
    make_dataset(data_dir)
    knobs = model_knobs(data_dir)
    reference = Code2VecModel(Config(
        DL_FRAMEWORK='jax', VERBOSE_MODE=0, MESH_DEVICE_INDICES='0',
        **knobs))
    cwd = os.getcwd()
    os.chdir(root)     # its log.txt lands here
    try:
        wants.eval = reference.evaluate()
    finally:
        os.chdir(cwd)
    model_weights = convert.params_to_numpy(to_port(reference.params))
    # a one-rank checkpoint, for the world to restore under 'zero'
    one = PortModel(PortConfig(MODEL_SAVE_PATH=str(root / 'one' / 'saved'),
                               **knobs), device='cpu', seed=4)
    one.train()
    one_state = {'params': convert.params_to_numpy(one.backend.params),
                 'opt': convert.opt_state_to_numpy(one.state.opt_state),
                 'step': one.state.step}
    results = run_world(
        'tests.test_torch_parallel_knobs:knobs_rank', 4, root / 'ranks',
        dict(shard_steps=shard_steps, long_step=long_step,
             zero_weights=zero_weights,
             zero_steps=[arrays_of(b) for b in zero_batches()],
             lazy_weights=lazy_weights, lazy_step=arrays_of(lazy_batch()),
             data_dir=data_dir, model_weights=model_weights,
             one_rank_ckpt=str(root / 'one' / 'saved')))
    return SimpleNamespace(results=results, wants=wants, data_dir=data_dir,
                           knobs=knobs, one_state=one_state,
                           lazy_weights=lazy_weights)


def assert_step_matches(parts, want, moments=True):
    for part in parts:
        np.testing.assert_allclose(part['loss'], want['loss'], rtol=2e-5)
        # the replicated weights stayed equal on every rank, bit for bit
        for name in ('transform', 'attention'):
            np.testing.assert_array_equal(part['params'][name],
                                          parts[0]['params'][name])
    got = _gather(parts, lambda p: p['params'])
    for name in NAMES:
        np.testing.assert_allclose(got[name], want['params'][name],
                                   err_msg=name, **FP32)
    if not moments:
        return
    mu = _gather(parts, lambda p: p['opt']['mu'])
    nu = _gather(parts, lambda p: p['opt']['nu'])
    for name in NAMES:
        np.testing.assert_allclose(mu[name], want['mu'][name],
                                   err_msg='mu ' + name, **BF16_STEP)
        np.testing.assert_allclose(nu[name], want['nu'][name],
                                   err_msg='nu ' + name, **BF16_STEP)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize('route', [name for name, _ in SHARD_ROUTES]
                         + ['long'])
def test_shard_contexts_step_on_2x2_matches_reference(world, route):
    parts = [r['shard'][route] for r in world.results]
    assert_step_matches(parts, world.wants.shard[route])


@pytest.mark.parametrize('route', [name for name, _ in SHARD_ROUTES])
def test_shard_contexts_composes_with_remat_bit_for_bit(world, route):
    for r in world.results:
        plain, remat = r['shard'][route], r['shard'][route + '_remat']
        assert plain['loss'] == remat['loss']
        for name in NAMES:
            np.testing.assert_array_equal(plain['params'][name],
                                          remat['params'][name])


def test_shard_contexts_evaluate_matches_single_device_reference(world):
    want = world.wants.eval
    for r in world.results:
        got = r['eval']
        np.testing.assert_array_equal(got.topk_acc, want.topk_acc)
        assert (got.subtoken_precision, got.subtoken_recall,
                got.subtoken_f1) == (want.subtoken_precision,
                                     want.subtoken_recall, want.subtoken_f1)
        np.testing.assert_allclose(got.loss, want.loss, rtol=2e-5)


def test_zero_matches_reference_and_mirror_bit_for_bit(world):
    parts = [r['zero']['zero'] for r in world.results]
    assert_step_matches(parts, world.wants.zero)
    for r in world.results:
        zero, mirror = r['zero']['zero'], r['zero']['mirror']
        assert zero['loss'] == mirror['loss']
        for name in NAMES:
            np.testing.assert_array_equal(zero['params'][name],
                                          mirror['params'][name])
            for key in ('mu', 'nu'):
                np.testing.assert_array_equal(zero['opt'][key][name],
                                              mirror['opt'][key][name])
        # each rank holds half of its table slices' moment rows
        tables = sum(zero['params'][n].size for n in NAMES[:3])
        dense = sum(zero['params'][n].size for n in NAMES[3:])
        assert zero['held_mu'] == tables // 2 + dense
        assert mirror['held_mu'] == tables + dense


def test_lazy_adam_on_2x2_matches_single_device_reference(world):
    parts = [r['lazy'] for r in world.results]
    assert_step_matches(parts, world.wants.lazy, moments=False)
    start = world.lazy_weights
    got = _gather(parts, lambda p: p['params'])
    mu = _gather(parts, lambda p: p['opt']['mu'])
    batch = lazy_batch()
    touched = np.zeros(got['token_embedding'].shape[0], bool)
    touched[np.concatenate([batch.source.ravel(), batch.target.ravel()])] = 1
    # the row only data shard 1 touched moved, by the same bits on both
    # data ranks of its model column
    assert not np.array_equal(got['token_embedding'][ONLY_SHARD1_ROW],
                              start['token_embedding'][ONLY_SHARD1_ROW])
    column = [p for p in parts if p['coords'][1] == 1]
    np.testing.assert_array_equal(column[0]['params']['token_embedding'],
                                  column[1]['params']['token_embedding'])
    # untouched rows and their moments bit for bit as they were
    np.testing.assert_array_equal(got['token_embedding'][~touched],
                                  start['token_embedding'][~touched])
    assert not mu['token_embedding'][~touched].any()
    assert mu['token_embedding'][touched].any(axis=1).all()


def test_telemetry_on_2x2_writes_one_path_per_rank(world):
    files = world.results[0]['tele_files']
    for base in ('metrics.jsonl', 'metrics.prom', 'intervals.jsonl'):
        stem, ext = os.path.splitext(base)
        assert base in files
        for r in (1, 2, 3):
            assert '%s.proc%d%s' % (stem, r, ext) in files, (base, files)
    assert world.results[0]['trace_dirs'] == [
        'step1', 'step1.proc1', 'step1.proc2', 'step1.proc3']
    # no file of rank r > 0 without its suffix: each path is one rank's
    for path in files:
        if path.startswith('traces'):
            continue
        owners = [r for r in (1, 2, 3) if '.proc%d' % r in path]
        assert len(owners) <= 1, path
    for r in world.results:
        assert r['mfu'] is not None and np.isfinite(r['mfu']) and \
            r['mfu'] > 0


def test_zero_checkpoint_restores_under_mirror_on_one_rank(world):
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    trained = world.results[0]['trained']
    for r in world.results:
        assert r['trained']['step'] == trained['step']
    one = Code2VecModel(Config(
        MODEL_LOAD_PATH=str(world.data_dir / 'zero' / 'saved'),
        **world.knobs), device='cpu')
    assert one.state.step == trained['step']
    got = convert.params_to_numpy(one.backend.params)
    moments = convert.opt_state_to_numpy(one.state.opt_state)
    want_mu = _gather(world.results, lambda p: p['trained']['opt']['mu'])
    want_nu = _gather(world.results, lambda p: p['trained']['opt']['nu'])
    for name in NAMES:
        assert_rows_equal(got[name], trained['params'][name], name)
        assert_rows_equal(moments['mu'][name], want_mu[name], 'mu ' + name)
        assert_rows_equal(moments['nu'][name], want_nu[name], 'nu ' + name)


def test_one_rank_checkpoint_restores_under_zero_on_2x2(world):
    want = world.one_state
    for r in world.results:
        assert r['restored']['step'] == want['step']
        d, m = r['coords']
        for name in NAMES:
            moment = r['restored']['opt']['mu'][name]
            if name in NAMES[:3]:
                # rows [m V/2 + d V/4, ...) of the whole table
                rows = r['restored']['params'][name].shape[0]
                lo = m * rows + d * rows // 2
                whole = want['opt']['mu'][name]
                expect = np.zeros((rows // 2,) + whole.shape[1:], np.float32)
                held = whole[lo:lo + rows // 2]
                expect[:held.shape[0]] = held
                assert moment.shape[0] == rows // 2
                np.testing.assert_array_equal(moment, expect, err_msg=name)
            else:
                np.testing.assert_array_equal(moment, want['opt']['mu'][name])
    got = _gather(world.results, lambda p: p['restored']['params'])
    for name in NAMES:
        assert_rows_equal(got[name], want['params'][name], name)


def test_rank_file_names_take_the_proc_suffix(tmp_path):
    """Every file a rank r > 0 writes beside the others' takes its
    ``.proc<r>`` suffix: the memory ledger's OOM dump, MEM_NOW snapshots
    and ``--memory-report``, the trace controller's touch file and
    captures, the divergence and watchdog dumps; rank 0's names are the
    one-rank ones."""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.resilience.guard import DivergenceGuard
    from code2vec_tpu_torch.resilience.watchdog import HangWatchdog
    from code2vec_tpu_torch.telemetry import memory as memory_lib
    from code2vec_tpu_torch.telemetry.stepwatch import process_suffix
    from code2vec_tpu_torch.telemetry.trace import TraceController
    assert (process_suffix(0), process_suffix(3)) == ('', '.proc3')
    try:
        for rank in (0, 2):
            suffix = process_suffix(rank)
            out = tmp_path / ('rank%d' % rank)
            memory_lib.reset()
            memory_lib.configure(dump_dir=str(out), suffix=suffix)
            names = [os.path.basename(memory_lib.ledger().dump()),
                     os.path.basename(memory_lib.write_report(
                         Config(TELEMETRY_DIR=str(out)))),
                     os.path.basename(memory_lib.MemoryReportController(
                         str(out)).touch_path),
                     os.path.basename(TraceController(
                         str(out), suffix=suffix).touch_path)]
            guard = DivergenceGuard(0, None, str(out), suffix=suffix)
            with pytest.raises(Exception):
                guard.handle(4, [float('nan')], None)
            watchdog = HangWatchdog(60.0, str(out), abort=lambda: None,
                                    suffix=suffix)
            watchdog._expire('a test')
            names += sorted(p.name for p in out.iterdir()
                            if p.name.startswith(('divergence', 'watchdog')))
            assert names == [
                'oom_ledger%s.json' % suffix, 'memory_report%s.json' % suffix,
                'MEM_NOW%s' % suffix, 'TRACE_NOW%s' % suffix,
                'divergence_step4%s.json' % suffix,
                'watchdog_stacks%s.txt' % suffix], names
    finally:
        memory_lib.reset()
