"""Training, evaluation and checkpoints of the port on a (data, model) mesh
of gloo ranks on the CPU, against the reference on the conftest's
virtual devices, same weights (code2vec_tpu_torch/convert.py) and
batches:

- one ``Trainer.train_step`` at keep 1.0 on (2, 2) against the reference
  ``Trainer`` on a (2, 2) mesh of devices 0-3: on the packed wire with
  the streamed CE (the ragged encode's mesh routes, the sharded CE) and
  on the plane wire with materialized logits (the sharded gathers, the
  logits' shards, the merged logsumexp): the loss, every parameter slice
  and the bf16-stored Adam moments; the dense weights bit for bit equal
  on the four ranks;
- ``Code2VecModel.evaluate()`` on two ranks (2, 1) and on (2, 2) against
  the single-device reference ``evaluate()``: top-k accuracy and subtoken
  counts exactly, the loss close, ``log.txt`` written by rank 0;
- a checkpoint saved by ``train()`` on (2, 2) restored on one rank: the
  parameters and moments equal to the ranks' gathered state; and a
  one-rank checkpoint restored on (2, 2): each rank's slices equal;
- a preemption signal to one rank of (2, 2): every rank stops at the
  same step and the snapshot is saved once.

Tolerances (tests/test_torch_train.py): the loss at rtol 2e-5;
parameters at rtol 1e-5 / atol 1e-6 after a step of lr 1e-3;
bf16-stored moments within one bf16 rounding (rtol 2^-7). One world of
four ranks runs every case.
"""
from types import SimpleNamespace

import numpy as np
import pytest

from code2vec_tpu.data import packed as jax_packed
from code2vec_tpu_torch import convert
from tests.test_packed import random_plane_batch
from tests.test_torch_parallel import run_world
from tests.test_train_overfit import make_dataset

BF16_STEP = dict(rtol=2.0 ** -7, atol=1e-12)
NAMES = ('token_embedding', 'path_embedding', 'target_embedding',
         'transform', 'attention')
STEP_KNOBS = dict(MAX_CONTEXTS=4, TRAIN_BATCH_SIZE=8, TEST_BATCH_SIZE=8,
                  COMPUTE_DTYPE='float32', TOKEN_EMBEDDINGS_SIZE=8,
                  PATH_EMBEDDINGS_SIZE=8, CODE_VECTOR_SIZE=24,
                  DROPOUT_KEEP_RATE=1.0)
# (wire, fused CE): the packed wire's kernel routes; the plane wire's
# gathers and materialized logits
STEP_ROUTES = (('packed', True), ('planes', False))


def step_batch():
    batch = random_plane_batch(np.random.default_rng(8), 8, 4,
                               pad_row_rate=0.25)
    return batch._replace(label=(batch.label % 16).astype(np.int32))


def model_knobs(data_dir):
    return dict(TRAIN_DATA_PATH_PREFIX=str(data_dir / 'tiny'),
                TEST_DATA_PATH=str(data_dir / 'tiny.val.c2v'),
                MAX_CONTEXTS=6, COMPUTE_DTYPE='float32', TEST_BATCH_SIZE=8,
                TRAIN_BATCH_SIZE=16, NUM_TRAIN_EPOCHS=1,
                READER_USE_NATIVE=False, USE_PALLAS_FUSED_CE=True)


# ------------------------------------------------------------- the ranks
def world_rank(rank, steps, data_dir, model_weights, one_rank_ckpt):
    import json
    import os

    import torch

    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    from code2vec_tpu_torch.models.backends import TorchBackend
    from code2vec_tpu_torch.parallel.mesh import create_mesh
    from code2vec_tpu_torch.training.trainer import Trainer
    from tests.test_torch_parallel import sub_mesh
    out = {'steps': []}
    mesh = create_mesh(Config(MESH_DATA_AXIS_SIZE=2, MESH_MODEL_AXIS_SIZE=2))
    vocab = lambda size: SimpleNamespace(size=size, pad_index=0)  # noqa
    vocabs = SimpleNamespace(token_vocab=vocab(32), path_vocab=vocab(16),
                             target_vocab=vocab(16))
    for (wire, fused), (weights, batch) in zip(STEP_ROUTES, steps):
        config = Config(TRAIN_DATA_PATH_PREFIX='unused',
                        MESH_DATA_AXIS_SIZE=2, MESH_MODEL_AXIS_SIZE=2,
                        BATCH_WIRE_FORMAT=wire, USE_PALLAS_FUSED_CE=fused,
                        **STEP_KNOBS)
        backend = TorchBackend(config, vocabs, torch.device('cpu'),
                               params=convert.params_from_numpy(weights),
                               mesh=mesh)
        trainer = Trainer(config, backend, mesh=mesh)
        state = trainer.state_from_params()
        if wire == 'packed':
            d = mesh.data_index
            local = (batch['ctx'][d:d + 1],) + mesh.shard_batch(
                (batch['count'], batch['label'], batch['weight']))
        else:
            local = mesh.shard_batch(batch)
        state, loss = trainer.train_step(state, tuple(
            np.ascontiguousarray(a) for a in local))
        out['steps'].append(dict(
            coords=(mesh.data_index, mesh.model_index), loss=float(loss),
            params=convert.params_to_numpy(state.params),
            opt=convert.opt_state_to_numpy(state.opt_state)))

    # evaluate() on (2, 1) of ranks 0 and 1, then on (2, 2)
    os.chdir(data_dir)
    knobs = model_knobs(data_dir)
    sub = sub_mesh(2, 1)
    if sub.member:
        model = Code2VecModel(Config(MESH_DATA_AXIS_SIZE=2, **knobs),
                              device='cpu', mesh=sub,
                              params=convert.params_from_numpy(model_weights))
        out['eval_2x1'] = model.evaluate()
    config = Config(MESH_DATA_AXIS_SIZE=2, MESH_MODEL_AXIS_SIZE=2,
                    MODEL_SAVE_PATH=str(data_dir / 'mesh' / 'saved'), **knobs)
    # the target table's allocation grows with the model axis under the
    # fused CE: its extra rows are masked padding
    rows = 2048
    weights = dict(model_weights, target_embedding=np.concatenate([
        model_weights['target_embedding'], np.zeros(
            (rows - model_weights['target_embedding'].shape[0],
             model_weights['target_embedding'].shape[1]), np.float32)]))
    model = Code2VecModel(config, device='cpu', mesh=mesh,
                          params=convert.params_from_numpy(weights))
    out['eval_2x2'] = model.evaluate()
    mesh.barrier()
    out['log_files'] = sorted(f for f in os.listdir(data_dir / 'mesh')
                              if f.startswith('log.txt'))
    # train() saves the (2, 2) state whole (rank 0), for one rank to load
    model.train()
    out['trained'] = {
        'params': convert.params_to_numpy(model.backend.gathered_params()),
        'opt': convert.opt_state_to_numpy(model.state.opt_state),
        'step': model.state.step}
    # a one-rank checkpoint restored on (2, 2)
    restored = Code2VecModel(Config(
        MESH_DATA_AXIS_SIZE=2, MESH_MODEL_AXIS_SIZE=2,
        MODEL_LOAD_PATH=one_rank_ckpt, **knobs), device='cpu', mesh=mesh)
    out['restored'] = {
        'params': convert.params_to_numpy(restored.backend.params),
        'opt': convert.opt_state_to_numpy(restored.state.opt_state),
        'step': restored.state.step}
    # a preemption signal to rank 3 alone (after step 1): every rank stops
    # at the end of the log window (step 2) and saves one snapshot
    preempt_dir = data_dir / 'preempt'
    model = Code2VecModel(Config(
        MESH_DATA_AXIS_SIZE=2, MESH_MODEL_AXIS_SIZE=2,
        MODEL_SAVE_PATH=str(preempt_dir / 'saved'),
        **dict(knobs, NUM_TRAIN_EPOCHS=2, NUM_BATCHES_TO_LOG_PROGRESS=2,
               HANDLE_PREEMPTION_SIGNALS=True,
               FAULT_INJECT='sigterm@step=1' if rank == 3 else '')),
        device='cpu', mesh=mesh, seed=5)
    model.train()
    from code2vec_tpu_torch.resilience import faults
    faults.configure('')
    mesh.barrier()
    out['preempt'] = {
        'step': model.state.step,
        'markers': [json.loads(p.read_text())['step']
                    for p in sorted(preempt_dir.rglob('PREEMPTED.json'))]}
    out['coords'] = (mesh.data_index, mesh.model_index)
    return out


# ----------------------------------------------------- the reference side
def jax_trainer(wire, fused):
    from code2vec_tpu.config import Config
    from code2vec_tpu.models.backends import create_backend
    from code2vec_tpu.training.trainer import Trainer
    from code2vec_tpu.vocab import SizeOnlyVocabs
    config = Config(
        TRAIN_DATA_PATH_PREFIX='unused', DL_FRAMEWORK='jax', VERBOSE_MODE=0,
        READER_USE_NATIVE=False, MAX_TOKEN_VOCAB_SIZE=32,
        MAX_PATH_VOCAB_SIZE=16, MAX_TARGET_VOCAB_SIZE=16,
        TARGET_EMBEDDINGS_SIZE=24, MESH_DATA_AXIS_SIZE=2,
        MESH_MODEL_AXIS_SIZE=2, MESH_DEVICE_INDICES='0,1,2,3',
        BATCH_WIRE_FORMAT=wire, USE_PALLAS_FUSED_CE=fused, **STEP_KNOBS)
    return Trainer(config, create_backend(config, SizeOnlyVocabs(32, 16, 16)))


def to_numpy(tree):
    return {k: np.asarray(v, dtype=np.float32)
            for k, v in tree._asdict().items()}


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The reference's steps and models, then the world of four ranks."""
    from code2vec_tpu.config import Config
    from code2vec_tpu.model_api import Code2VecModel
    from code2vec_tpu_torch.config import Config as PortConfig
    from code2vec_tpu_torch.model_api import Code2VecModel as PortModel
    from tests.test_torch_model import to_port
    root = tmp_path_factory.mktemp('train-world')
    steps, wants = [], []
    batch = step_batch()
    for wire, fused in STEP_ROUTES:
        trainer = jax_trainer(wire, fused)
        state = trainer.init_state()
        weights = to_numpy(state.params)
        if wire == 'packed':
            feed = jax_packed.pack_batch(batch, 0, 0, data_shards=2,
                                         capacity_minimum=4)
            arrays = {'ctx': np.asarray(feed.ctx),
                      'count': np.asarray(feed.count),
                      'label': np.asarray(feed.label),
                      'weight': np.asarray(feed.weight)}
        else:
            feed = batch
            arrays = tuple(np.asarray(a) for a in batch.device_arrays())
        new_state, loss = trainer.train_step(state, feed)
        steps.append((weights, arrays))
        wants.append(dict(loss=float(loss),
                          params=to_numpy(new_state.params),
                          mu=to_numpy(new_state.opt_state[0].mu),
                          nu=to_numpy(new_state.opt_state[0].nu)))
    data_dir = root / 'data'
    data_dir.mkdir()
    make_dataset(data_dir)
    knobs = model_knobs(data_dir)
    reference = Code2VecModel(Config(
        DL_FRAMEWORK='jax', VERBOSE_MODE=0, MESH_DEVICE_INDICES='0',
        **knobs))
    import os
    cwd = os.getcwd()
    os.chdir(root)     # its log.txt lands here
    try:
        want_eval = reference.evaluate()
    finally:
        os.chdir(cwd)
    model_weights = convert.params_to_numpy(to_port(reference.params))
    # a one-rank checkpoint, for the world to restore on (2, 2)
    one = PortModel(PortConfig(MODEL_SAVE_PATH=str(root / 'one' / 'saved'),
                               **knobs), device='cpu', seed=4)
    one.train()
    one_state = {'params': convert.params_to_numpy(one.backend.params),
                 'opt': convert.opt_state_to_numpy(one.state.opt_state),
                 'step': one.state.step}
    results = run_world(
        'tests.test_torch_parallel_train:world_rank', 4, root / 'ranks',
        dict(steps=steps, data_dir=data_dir, model_weights=model_weights,
             one_rank_ckpt=str(root / 'one' / 'saved')))
    return SimpleNamespace(results=results, wants=wants, data_dir=data_dir,
                           want_eval=want_eval, one_state=one_state,
                           knobs=knobs)


def assert_rows_equal(got, want, name):
    """Bit for bit over the rows both allocations hold (the target
    table's rows past the smaller are masked padding)."""
    rows = min(got.shape[0], want.shape[0])
    np.testing.assert_array_equal(got[:rows], want[:rows], err_msg=name)


def _gather(parts, pick):
    """Whole tables from the (2, 2) ranks' slices: rows by model index
    from the first data row; dense weights from rank 0."""
    by_model = {p['coords'][1]: pick(p) for p in parts
                if p['coords'][0] == 0}
    out = {}
    for name in by_model[0]:
        if name in NAMES[:3]:
            out[name] = np.concatenate([by_model[m][name] for m in (0, 1)])
        else:
            out[name] = by_model[0][name]
    return out


@pytest.mark.parametrize('route', range(len(STEP_ROUTES)),
                         ids=['%s-%s' % (w, 'fused_ce' if f else 'logits')
                              for w, f in STEP_ROUTES])
def test_train_step_on_2x2_matches_reference_trainer(world, route):
    want = world.wants[route]
    parts = [r['steps'][route] for r in world.results]
    for part in parts:
        np.testing.assert_allclose(part['loss'], want['loss'], rtol=2e-5)
        # the replicated weights stayed equal on every rank, bit for bit
        for name in ('transform', 'attention'):
            np.testing.assert_array_equal(part['params'][name],
                                          parts[0]['params'][name])
    got = _gather(parts, lambda p: p['params'])
    mu = _gather(parts, lambda p: p['opt']['mu'])
    nu = _gather(parts, lambda p: p['opt']['nu'])
    for name in NAMES:
        np.testing.assert_allclose(got[name], want['params'][name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(mu[name], want['mu'][name],
                                   err_msg='mu ' + name, **BF16_STEP)
        np.testing.assert_allclose(nu[name], want['nu'][name],
                                   err_msg='nu ' + name, **BF16_STEP)


@pytest.mark.parametrize('shape', ['eval_2x1', 'eval_2x2'])
def test_evaluate_on_the_mesh_matches_single_device_reference(world, shape):
    want = world.want_eval
    members = [r[shape] for r in world.results if shape in r]
    assert len(members) == (2 if shape == 'eval_2x1' else 4)
    for got in members:
        np.testing.assert_array_equal(got.topk_acc, want.topk_acc)
        assert (got.subtoken_precision, got.subtoken_recall,
                got.subtoken_f1) == (want.subtoken_precision,
                                     want.subtoken_recall, want.subtoken_f1)
        np.testing.assert_allclose(got.loss, want.loss, rtol=2e-5)
    # rank 0 writes log.txt, the others their .proc<r> shards
    assert world.results[0]['log_files'] == [
        'log.txt', 'log.txt.proc1', 'log.txt.proc2', 'log.txt.proc3']
    assert 0 < want.topk_acc[-1]


def test_checkpoint_from_2x2_restores_on_one_rank(world):
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    trained = world.results[0]['trained']
    for r in world.results:
        assert r['trained']['step'] == trained['step'] == 3
        for name in NAMES:
            np.testing.assert_array_equal(r['trained']['params'][name],
                                          trained['params'][name])
    one = Code2VecModel(Config(
        MODEL_LOAD_PATH=str(world.data_dir / 'mesh' / 'saved'),
        **world.knobs), device='cpu')
    assert one.state.step == 3
    got = convert.params_to_numpy(one.backend.params)
    moments = convert.opt_state_to_numpy(one.state.opt_state)
    want_mu = _gather(world.results, lambda p: p['trained']['opt']['mu'])
    want_nu = _gather(world.results, lambda p: p['trained']['opt']['nu'])
    for name in NAMES:
        assert_rows_equal(got[name], trained['params'][name], name)
        assert_rows_equal(moments['mu'][name], want_mu[name], 'mu ' + name)
        assert_rows_equal(moments['nu'][name], want_nu[name], 'nu ' + name)


def test_preemption_of_one_rank_stops_every_rank_at_one_step(world):
    """SIGTERM to rank 3 alone after step 1: the ranks agree on it at the
    end of the log window, so all four leave the loop at step 2 (not rank
    3 at step 1 with its siblings running on) and the snapshot's
    collective save completes, its marker written once."""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    for r in world.results:
        assert r['preempt']['step'] == 2
        assert r['preempt']['markers'] == [2]
    resumed = Code2VecModel(Config(
        MODEL_LOAD_PATH=str(world.data_dir / 'preempt' / 'saved'),
        **world.knobs), device='cpu')
    assert resumed.state.step == 2


def test_one_rank_checkpoint_restores_on_2x2(world):
    want = world.one_state
    for r in world.results:
        assert r['restored']['step'] == want['step']
    got = _gather(world.results, lambda p: p['restored']['params'])
    mu = _gather(world.results, lambda p: p['restored']['opt']['mu'])
    nu = _gather(world.results, lambda p: p['restored']['opt']['nu'])
    for name in NAMES:
        assert_rows_equal(got[name], want['params'][name], name)
        assert_rows_equal(mu[name], want['opt']['mu'][name], 'mu ' + name)
        assert_rows_equal(nu[name], want['opt']['nu'][name], 'nu ' + name)
    # the rows the mesh's allocation adds are zero padding
    np.testing.assert_array_equal(
        got['target_embedding'][want['params']['target_embedding'].shape[0]:],
        0.0)
