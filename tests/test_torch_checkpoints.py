"""The port's checkpoints (code2vec_tpu_torch/checkpoints.py, model_api.py)
against the reference's, fp32 on the CPU over the tiny corpus of
tests/test_train_overfit.py:

- the bridge: the reference's orbax checkpoints (``__entire-model`` and
  ``__only-weights``, read through tensorstore) evaluate and predict in
  the port as in the reference, and one port step resumed from them
  matches the reference's next step;
- the port's own store: an exact round trip, retention at MAX_TO_KEEP,
  strict metadata, target rows padded or sliced, moments cast across
  storage dtypes, the release;
- the ``dictionaries.bin`` sidecar read by either package from the
  other's, the word2vec exports byte for byte, mid-epoch evaluation at the
  reference's steps, and the error without tensorstore.

The reference trains once per module (MODEL_SAVE_PATH set, two epochs of
six steps, an evaluation every four steps) and its evaluation, predictions
and word2vec files are taken once from that checkpoint.

Tolerances: metrics equal and the loss within rtol 1e-5; predict scores
rtol 1e-5; a resumed step at test_torch_train.py's (loss rtol 2e-5,
parameters rtol 1e-5 / atol 1e-6, bf16-stored moments within one bf16
rounding), the moments with an absolute term of 1e-6 of each tensor's
largest moment as well: from a resumed state a moment can cancel to far
below its tensor's scale (``MOMENT_SCALE_ATOL``).
"""
import ast
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from code2vec_tpu.config import Config
from code2vec_tpu.data import packed as jax_packed
from code2vec_tpu.model_api import Code2VecModel
from code2vec_tpu.parallel import mesh as mesh_lib
from code2vec_tpu.vocab import Code2VecVocabs, VocabType
from code2vec_tpu_torch import checkpoints, convert
from code2vec_tpu_torch.checkpoints import CheckpointStore
from code2vec_tpu_torch.config import Config as PortConfig
from code2vec_tpu_torch.model_api import Code2VecModel as PortModel
from code2vec_tpu_torch.models.functional import Code2VecParams
from code2vec_tpu_torch.vocab import Code2VecVocabs as PortVocabs
from code2vec_tpu_torch.vocab import VocabType as PortVocabType
from tests.test_train_overfit import make_dataset

REPO = Path(__file__).resolve().parent.parent
BF16_STEP = dict(rtol=2.0 ** -7, atol=1e-12)
# a resumed moment m = b1 m' + (1 - b1) g can cancel to far below its
# tensor's scale, where the fp32 gradients' sum order shows: measured up
# to 4.8e-9 of the tensor's largest moment past one bf16 rounding
MOMENT_SCALE_ATOL = 1e-6
SHARED = dict(MAX_CONTEXTS=6, COMPUTE_DTYPE='float32', TRAIN_BATCH_SIZE=16,
              TEST_BATCH_SIZE=16, SHUFFLE_BUFFER_SIZE=64)
JAX_ONLY = dict(DL_FRAMEWORK='jax', VERBOSE_MODE=0, READER_USE_NATIVE=False)
TRAIN = dict(NUM_TRAIN_EPOCHS=2, NUM_TRAIN_BATCHES_TO_EVALUATE=4)


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
    """The reference trained with saves into ``a/``; ``b/`` holds only
    its release; its evaluation, log, predictions and word2vec files from
    ``a/``."""
    root = tmp_path_factory.mktemp('reference')
    prefix = make_dataset(root, n_train=96)
    val = root / 'tiny.val.c2v'
    save_a = root / 'a' / 'saved_model'
    model = Code2VecModel(Config(
        TRAIN_DATA_PATH_PREFIX=str(prefix), TEST_DATA_PATH=str(val),
        MODEL_SAVE_PATH=str(save_a), **TRAIN, **SHARED, **JAX_ONLY))
    model.train()
    labels = [entry['label'] for entry in model.eval_history]
    shutil.copytree(root / 'a', root / 'b')
    save_b = root / 'b' / 'saved_model'
    Code2VecModel(Config(MODEL_LOAD_PATH=str(save_b), RELEASE=True,
                         **SHARED, **JAX_ONLY)).release_model()
    shutil.rmtree(str(save_b) + '__entire-model')
    loaded = Code2VecModel(Config(MODEL_LOAD_PATH=str(save_a),
                                  TEST_DATA_PATH=str(val), **SHARED,
                                  **JAX_ONLY))
    results = loaded.evaluate()
    log = (root / 'a' / 'log.txt').read_text()
    lines = val.read_text().splitlines()
    predictions = loaded.predict(lines)
    w2v = {}
    for vocab_type in VocabType:
        w2v[vocab_type.name] = root / ('ref.%s.txt' % vocab_type.name)
        loaded.save_word2vec_format(str(w2v[vocab_type.name]), vocab_type)
    return dict(root=root, prefix=prefix, val=val, save_a=save_a,
                save_b=save_b, eval_labels=labels, results=results, log=log,
                lines=lines, predictions=predictions, w2v=w2v)


@pytest.fixture(scope='module')
def port_run(tmp_path_factory, reference):
    """The port trained for three epochs of six steps with saves into
    ``p/``, keeping two."""
    root = tmp_path_factory.mktemp('port')
    save = root / 'p' / 'saved_model'
    model = PortModel(PortConfig(
        TRAIN_DATA_PATH_PREFIX=str(reference['prefix']), NUM_TRAIN_EPOCHS=3,
        MAX_TO_KEEP=2, MODEL_SAVE_PATH=str(save), **SHARED), device='cpu')
    model.train()
    return dict(root=root, save=save, model=model)


def port_eval_model(path, **extra):
    return PortModel(PortConfig(MODEL_LOAD_PATH=str(path), **SHARED,
                                **extra), device='cpu')


def assert_state_equal(state, restored):
    """A ``TrainerState`` and a ``RestoredTraining``: every tensor
    ``torch.equal`` in its dtype, count and step equal."""
    names = Code2VecParams._fields
    for name, tensor in zip(names, state.params):
        assert torch.equal(tensor.detach(), restored.params[name]), name
    for field in ('mu', 'nu'):
        for name, tensor in zip(names, getattr(state.opt_state, field)):
            got = restored.opt_state[field][name]
            assert got.dtype == tensor.dtype and torch.equal(tensor, got), \
                (field, name)
    assert restored.opt_state['count'] == state.opt_state.count
    assert restored.step == state.step


# ------------------------------------------------------------- the bridge
@pytest.mark.parametrize('artifact', ['entire-model', 'only-weights',
                                      'entire-model-fused-ce'])
def test_reference_checkpoint_evaluates_and_predicts_in_port(reference,
                                                             artifact):
    """(a) params only, from either artifact; under USE_PALLAS_FUSED_CE
    the target table's 128 stored rows are padded to 1,024."""
    fused = artifact.endswith('fused-ce')
    save = reference['save_b' if artifact == 'only-weights' else 'save_a']
    model = port_eval_model(save, TEST_DATA_PATH=str(reference['val']),
                            USE_PALLAS_FUSED_CE=fused)
    assert model.backend.params.target_embedding.shape[0] == (
        1024 if fused else 128)
    assert model.state is None
    want = reference['results']
    got = model.evaluate()
    np.testing.assert_array_equal(got.topk_acc, want.topk_acc)
    assert (got.subtoken_precision, got.subtoken_recall, got.subtoken_f1) \
        == (want.subtoken_precision, want.subtoken_recall, want.subtoken_f1)
    np.testing.assert_allclose(got.loss, want.loss, rtol=1e-5)
    assert (save.parent / 'log.txt').read_text() == reference['log']
    got_predictions = model.predict(reference['lines'])
    for g, w in zip(got_predictions, reference['predictions']):
        assert g.topk_predicted_words == w.topk_predicted_words
        np.testing.assert_allclose(g.topk_predicted_words_scores,
                                   w.topk_predicted_words_scores, rtol=1e-5)


def test_reference_checkpoint_resumes_in_port(reference):
    """(b) the full state from the reference's orbax checkpoint: count,
    step and start epoch as the reference restores them, and one step at
    keep 1.0 as the reference's next step."""
    common = dict(MODEL_LOAD_PATH=str(reference['save_a']),
                  TRAIN_DATA_PATH_PREFIX=str(reference['prefix']),
                  DROPOUT_KEEP_RATE=1.0, **SHARED)
    jax_model = Code2VecModel(Config(**common, **JAX_ONLY))
    port = PortModel(PortConfig(**common), device='cpu')
    jax_state = jax_model.state
    assert port.state.step == int(jax_state.step) == 12
    assert port.state.opt_state.count == int(jax_state.opt_state[0].count)
    assert port._start_epoch == jax_model._start_epoch == 2
    assert port.state.opt_state.mu[0].dtype == torch.bfloat16
    lines = (reference['root'] / 'tiny.train.c2v').read_text().splitlines()
    batch = port.reader.tokenize_lines(lines[:16])
    packed = jax_packed.pack_batch(
        batch, port.backend.token_pad_index, port.backend.path_pad_index,
        data_shards=jax_model.mesh.shape[mesh_lib.DATA_AXIS],
        capacity_minimum=4)
    new_state, loss = jax_model.trainer.train_step(jax_state, packed)
    port_state, port_loss = port.trainer.train_step(port.state, packed)
    np.testing.assert_allclose(float(port_loss), float(loss), rtol=2e-5)
    got_params = convert.params_to_numpy(port_state.params)
    got_opt = convert.opt_state_to_numpy(port_state.opt_state)
    want_opt = new_state.opt_state[0]
    assert got_opt['count'] == int(want_opt.count)
    for name in Code2VecParams._fields:
        np.testing.assert_allclose(
            got_params[name], np.asarray(getattr(new_state.params, name)),
            rtol=1e-5, atol=1e-6, err_msg=name)
        for field in ('mu', 'nu'):
            want = np.asarray(getattr(getattr(want_opt, field), name),
                              np.float32)
            np.testing.assert_allclose(
                got_opt[field][name], want, rtol=BF16_STEP['rtol'],
                atol=MOMENT_SCALE_ATOL * float(np.abs(want).max()),
                err_msg='%s %s' % (field, name))


def test_missing_tensorstore_is_named(reference, monkeypatch):
    """(l) without tensorstore the bridge says what it needs."""
    monkeypatch.setitem(sys.modules, 'tensorstore', None)
    with pytest.raises(ImportError, match='tensorstore'):
        port_eval_model(reference['save_a'])


def test_tensorstore_is_imported_only_inside_the_bridge():
    for path in sorted((REPO / 'code2vec_tpu_torch').rglob('*.py')):
        tree = ast.parse(path.read_text(), filename=str(path))
        inside = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and \
                    node.name == 'read_orbax_checkpoint':
                inside.update(id(n) for n in ast.walk(node))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or '']
            else:
                continue
            if any(name.split('.')[0] in ('tensorstore', 'orbax')
                   for name in names):
                assert id(node) in inside, (path, names)


# ------------------------------------------------------ the port's store
def test_port_round_trip_is_exact(port_run):
    """(c) the newest save restores equal to the state it saved, through
    the store and through a model that resumes from it."""
    model, save = port_run['model'], port_run['save']
    restored = model._store_for(str(save)).restore_training()
    assert restored.epoch == 2
    assert_state_equal(model.state, restored)
    resumed = PortModel(PortConfig(
        MODEL_LOAD_PATH=str(save), TRAIN_DATA_PATH_PREFIX=str(
            model.config.TRAIN_DATA_PATH_PREFIX), **SHARED), device='cpu')
    assert resumed._start_epoch == 3
    names = Code2VecParams._fields
    assert_state_equal(resumed.state, checkpoints.RestoredTraining(
        params=dict(zip(names, model.state.params)),
        opt_state={'count': model.state.opt_state.count,
                   'mu': dict(zip(names, model.state.opt_state.mu)),
                   'nu': dict(zip(names, model.state.opt_state.nu))},
        step=model.state.step, epoch=2))
    meta = json.loads(Path(str(save) + '.meta.json').read_text())
    assert meta['framework'] == 'torch'
    assert meta['checkpoint_layout'] == checkpoints.LAYOUT


def test_retention_and_uncommitted_steps(port_run):
    """(d) three saves, MAX_TO_KEEP=2: the last two; a save in flight
    (a non-digit directory) is not a step."""
    store = port_run['model']._store_for(str(port_run['save']))
    assert store.steps() == [12, 18]
    in_flight = Path(store.entire_dir) / '24.tmp-1'
    in_flight.mkdir()
    try:
        assert store.steps() == [12, 18]
        assert store.restore_training().step == 18
    finally:
        in_flight.rmdir()


@pytest.mark.parametrize('key', ['param_row_alignment', 'token_dim',
                                 'path_dim', 'code_dim'])
def test_strict_metadata_names_the_key(port_run, key):
    """(e) a shape setting that differs refuses the restore."""
    store = port_run['model']._store_for(str(port_run['save']))
    other = CheckpointStore(str(port_run['save']),
                            metadata=dict(store.metadata,
                                          **{key: store.metadata[key] * 2}))
    with pytest.raises(ValueError, match=key):
        other.restore_training()
    with pytest.raises(ValueError, match=key):
        other.restore_params()


def test_framework_is_informational_and_first_writer_kept(reference,
                                                          tmp_path):
    """A store the reference wrote, resumed and re-saved by the port:
    'framework' stays 'jax', and the port's step replaces the orbax one."""
    shutil.copytree(reference['save_a'].parent, tmp_path / 'c')
    save = tmp_path / 'c' / 'saved_model'
    model = PortModel(PortConfig(
        MODEL_LOAD_PATH=str(save), MODEL_SAVE_PATH=str(save),
        TRAIN_DATA_PATH_PREFIX=str(reference['prefix']), **SHARED),
        device='cpu')
    model.save(epoch=1)
    meta = json.loads(Path(str(save) + '.meta.json').read_text())
    assert meta['framework'] == 'jax'
    assert (Path(str(save) + '__entire-model') / '12'
            / checkpoints.CHECKPOINT_FILE).is_file()
    assert_state_equal(model.state,
                       model._store_for(str(save)).restore_training())


@pytest.mark.parametrize('stored_rows, current_rows', [(128, 1024),
                                                       (1024, 128)])
def test_target_rows_pad_and_slice(tmp_path, stored_rows, current_rows):
    """(f) the plain route's rows <-> the fused CE's, params and moments:
    the stored rows kept, the padding zero."""
    gen = torch.Generator().manual_seed(0)
    shapes = {'token_embedding': (128, 8), 'path_embedding': (128, 8),
              'target_embedding': (stored_rows, 24), 'transform': (24, 24),
              'attention': (24, 1)}
    valid = 100
    tables = {}
    for kind in ('params', 'mu', 'nu'):
        tables[kind] = {n: torch.randn(s, generator=gen)
                        for n, s in shapes.items()}
        tables[kind]['target_embedding'][valid:] = 0   # masked padding
    meta = dict(param_row_alignment=128, token_dim=8, path_dim=8,
                code_dim=24)
    path = str(tmp_path / 'm' / 'saved_model')
    CheckpointStore(path, metadata=dict(
        meta, target_vocab_rows=stored_rows)).save_training(
        params=tables['params'], opt_state={'count': 3, 'mu': tables['mu'],
                                            'nu': tables['nu']},
        step=3, epoch=0)
    store = CheckpointStore(path, metadata=dict(
        meta, target_vocab_rows=current_rows))
    restored = store.restore_training()
    for kind, named in (('params', restored.params),
                        ('mu', restored.opt_state['mu']),
                        ('nu', restored.opt_state['nu'])):
        got = named['target_embedding']
        assert got.shape == (current_rows, 24), kind
        assert torch.equal(got[:valid], tables[kind]['target_embedding']
                           [:valid]), kind
        assert not got[valid:].any(), kind
        assert torch.equal(named['transform'], tables[kind]['transform'])
    assert store.restore_params()['target_embedding'].shape == (
        current_rows, 24)


@pytest.mark.parametrize('saved, configured', [('float32', 'bfloat16'),
                                               ('bfloat16', 'float32')])
def test_moments_cast_across_storage_dtypes(reference, tmp_path, saved,
                                            configured):
    """(g) a resume under other ADAM_MU_DTYPE / ADAM_NU_DTYPE casts the
    moments: fp32 -> bf16 rounds, bf16 -> fp32 is exact."""
    save = tmp_path / 'm' / 'saved_model'
    train = dict(TRAIN_DATA_PATH_PREFIX=str(reference['prefix']), **SHARED)
    model = PortModel(PortConfig(
        NUM_TRAIN_EPOCHS=1, MODEL_SAVE_PATH=str(save), ADAM_MU_DTYPE=saved,
        ADAM_NU_DTYPE=saved, **train), device='cpu')
    model.train()
    resumed = PortModel(PortConfig(
        MODEL_LOAD_PATH=str(save), ADAM_MU_DTYPE=configured,
        ADAM_NU_DTYPE=configured, **train), device='cpu')
    want_dtype = getattr(torch, configured)
    for field in ('mu', 'nu'):
        for got, stored in zip(getattr(resumed.state.opt_state, field),
                               getattr(model.state.opt_state, field)):
            assert got.dtype == want_dtype
            assert torch.equal(got, stored.to(want_dtype))
    assert resumed.state.opt_state.count == model.state.opt_state.count


def test_release_has_no_moments_and_loads(port_run, tmp_path):
    """(h) ``release_model`` writes params only; a params-only load
    prefers it."""
    shutil.copytree(port_run['save'].parent, tmp_path / 'r')
    save = tmp_path / 'r' / 'saved_model'
    port_eval_model(save, RELEASE=True).release_model()
    artifact = Path(str(save) + '__only-weights') / checkpoints.CHECKPOINT_FILE
    payload = torch.load(artifact, weights_only=True)
    assert set(payload) == {'params'}
    shutil.rmtree(str(save) + '__entire-model')
    released = port_eval_model(save, TEST_DATA_PATH=str(
        Path(port_run['model'].config.TRAIN_DATA_PATH_PREFIX + '.val.c2v')))
    for name, tensor in zip(Code2VecParams._fields,
                            port_run['model'].state.params):
        assert torch.equal(getattr(released.backend.params, name),
                           tensor.detach()), name
    assert released.evaluate().loss is not None


def test_missing_checkpoint_is_a_value_error(reference, tmp_path):
    (tmp_path / 'empty').mkdir()
    shutil.copy(reference['save_a'].parent / 'dictionaries.bin',
                tmp_path / 'empty')
    with pytest.raises(ValueError, match='No checkpoint found'):
        port_eval_model(tmp_path / 'empty' / 'saved_model')


# ------------------------------------------- sidecar, exports, evaluation
@pytest.mark.parametrize('writer', ['port', 'reference'])
def test_vocab_sidecar_loads_in_the_other_package(reference, port_run,
                                                  writer):
    """(i) ``dictionaries.bin``: the port's in the reference, the
    reference's in the port, with equal maps."""
    save = port_run['save'] if writer == 'port' else reference['save_a']
    jax_vocabs = Code2VecVocabs(Config(MODEL_LOAD_PATH=str(save),
                                       VERBOSE_MODE=0))
    port_vocabs = PortVocabs(PortConfig(MODEL_LOAD_PATH=str(save)))
    created = PortVocabs(PortConfig(
        TRAIN_DATA_PATH_PREFIX=str(reference['prefix'])))
    for attr in ('token_vocab', 'path_vocab', 'target_vocab'):
        want = getattr(jax_vocabs, attr)
        for got in (getattr(port_vocabs, attr), getattr(created, attr)):
            assert got.word_to_index == want.word_to_index, attr
            assert got.index_to_word == want.index_to_word, attr
            assert got.size == want.size, attr


@pytest.mark.parametrize('vocab_type', [t.name for t in VocabType])
def test_word2vec_export_is_byte_identical(reference, tmp_path, vocab_type):
    """(j) the same parameters give the reference's word2vec text."""
    model = port_eval_model(reference['save_a'])
    out = tmp_path / 'port.txt'
    model.save_word2vec_format(str(out), PortVocabType[vocab_type])
    assert out.read_bytes() == reference['w2v'][vocab_type].read_bytes()
    rows = int(out.read_text().split('\n', 1)[0].split()[0])
    assert rows == model.vocabs.get(PortVocabType[vocab_type]).size


def test_mid_epoch_evaluation_at_reference_steps(reference, tmp_path,
                                                 monkeypatch):
    """(k) NUM_TRAIN_BATCHES_TO_EVALUATE=4 over two epochs of six steps:
    the reference evaluates after steps 4, 6 (epoch 1), 8 and 12 (the
    epoch-2 evaluation is the step-12 one)."""
    monkeypatch.chdir(tmp_path)
    model = PortModel(PortConfig(
        TRAIN_DATA_PATH_PREFIX=str(reference['prefix']),
        TEST_DATA_PATH=str(reference['val']), **TRAIN, **SHARED),
        device='cpu')
    model.train()
    labels = [entry['label'] for entry in model.eval_history]
    assert labels == reference['eval_labels'] == [
        'batch 4', 'epoch 1', 'batch 8', 'batch 12']
