"""The port's command line (``code2vec_tpu_torch/cli.py``) end to end on the
CPU (``--device cpu``), following tests/test_cli.py: train with per-epoch
evaluation and saves, evaluate a loaded model, release it, the word2vec
exports, the bulk code-vector export against the reference's
``export_code_vectors`` on the same weights (rtol 1e-5), and the errors:
neither data nor a model, and the reference's flags the port does not
serve yet.

One model is trained once per module and shared by the other tests.
"""
import json

import numpy as np
import pytest

from code2vec_tpu_torch import convert
from code2vec_tpu_torch.cli import main
from tests.test_train_overfit import make_dataset

CPU = ['--device', 'cpu', '-v', '0']


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp('cli')
    prefix = make_dataset(tmp_path)
    save = tmp_path / 'models' / 'm' / 'saved_model'
    model = main(['--data', str(prefix), '--test',
                  str(tmp_path / 'tiny.val.c2v'), '--dtype', 'float32',
                  '--batch-size', '16', '--epochs', '2', '--save', str(save)]
                 + CPU)
    return tmp_path, prefix, save, model


def test_cli_train_eval_save(trained):
    tmp_path, _prefix, save, model = trained
    assert model.device.type == 'cpu'
    assert [entry['label'] for entry in model.eval_history] == [
        'epoch 1', 'epoch 2']
    assert (tmp_path / 'models' / 'm' / 'dictionaries.bin').exists()
    assert (tmp_path / 'models' / 'm' / 'log.txt').exists()
    steps = sorted(p.name for p in
                   (tmp_path / 'models' / 'm' / 'saved_model__entire-model')
                   .iterdir())
    assert steps == ['4', '8']
    meta = json.loads((tmp_path / 'models' / 'm' / 'saved_model.meta.json')
                      .read_text())
    assert meta['framework'] == 'torch' and meta['code_dim'] == 384


def test_cli_eval_only_and_release(trained):
    tmp_path, _prefix, save, model = trained
    loaded = main(['--load', str(save), '--test',
                   str(tmp_path / 'tiny.val.c2v'), '--dtype', 'float32',
                   '--batch-size', '16'] + CPU)
    assert loaded.state is None
    for got, want in zip(loaded.backend.params, model.backend.params):
        assert np.array_equal(got.numpy(), want.numpy())
    main(['--load', str(save), '--release', '--dtype', 'float32'] + CPU)
    assert (tmp_path / 'models' / 'm' / 'saved_model__only-weights'
            / 'checkpoint.pt').is_file()


def test_cli_word2vec_exports(trained):
    tmp_path, _prefix, save, model = trained
    w2v, t2v = tmp_path / 'tokens.w2v', tmp_path / 'targets.w2v'
    main(['--load', str(save), '--save_word2v', str(w2v),
          '--save_target2v', str(t2v), '--export_vocab_vectors',
          str(tmp_path / 'vocab')] + CPU)
    for path, size, dim in (
            (w2v, model.vocabs.token_vocab.size, 128),
            (t2v, model.vocabs.target_vocab.size, 384),
            (tmp_path / 'vocab.tokens.txt', model.vocabs.token_vocab.size,
             128),
            (tmp_path / 'vocab.targets.txt', model.vocabs.target_vocab.size,
             384)):
        lines = path.read_text().splitlines()
        assert lines[0] == '%d %d' % (size, dim)
        assert len(lines) == size + 1
        assert len(lines[1].split()) == dim + 1
    assert (tmp_path / 'vocab.tokens.txt').read_text() == w2v.read_text()


def test_cli_bulk_vectors_match_reference(trained):
    """``--bulk-vectors``: every valid example in corpus order, as the
    reference's ``export_code_vectors`` writes them from the same
    weights."""
    import shutil

    import jax.numpy as jnp

    from code2vec_tpu.config import Config
    from code2vec_tpu.model_api import Code2VecModel
    from code2vec_tpu.serving.bulk import export_code_vectors
    tmp_path, prefix, save, model = trained
    corpus = tmp_path / 'bulk.c2v'
    shutil.copyfile(tmp_path / 'tiny.val.c2v', corpus)
    main(['--load', str(save), '--bulk-vectors', str(corpus), '--dtype',
          'float32', '--batch-size', '16'] + CPU)
    got = np.loadtxt(str(corpus) + '.vectors', ndmin=2)
    reference = Code2VecModel(Config(
        TRAIN_DATA_PATH_PREFIX=str(prefix), DL_FRAMEWORK='jax',
        COMPUTE_DTYPE='float32', TEST_BATCH_SIZE=16, VERBOSE_MODE=0,
        READER_USE_NATIVE=False))
    reference.params = reference.backend.from_canonical({
        name: jnp.asarray(array) for name, array in
        convert.params_to_numpy(model.backend.params).items()})
    want_path = tmp_path / 'reference.vectors'
    export_code_vectors(reference, str(corpus), str(want_path))
    want = np.loadtxt(str(want_path), ndmin=2)
    assert got.shape == want.shape == (16, 384)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cli_runs_on_cuda_unless_asked_for_the_cpu(trained, monkeypatch):
    """Without ``--device cpu`` the CLI asks for the card, and without one
    it raises instead of falling back."""
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    _tmp_path, _prefix, save, _model = trained
    with pytest.raises(RuntimeError, match='no CUDA device'):
        main(['--load', str(save), '-v', '0'])


def test_cli_requires_train_or_load():
    with pytest.raises(ValueError, match='Must train or load'):
        main(CPU)


@pytest.mark.parametrize('flags, named', [
    (['--telemetry'], 'unrecognized arguments: --telemetry'),
    (['--build-index', 'corpus.c2v'], '--build-index is not ported yet'),
    (['--query-neighbors', 'q.c2v'], '--query-neighbors is not ported yet'),
    (['--memory-report'], '--memory-report is not ported yet'),
    (['--mesh', '4x2'], 'unrecognized arguments: --mesh 4x2'),
])
def test_cli_unserved_flag_is_a_clear_error(flags, named, capsys):
    with pytest.raises(SystemExit) as exc:
        main(['--data', 'x'] + flags + CPU)
    assert exc.value.code == 2
    assert named in capsys.readouterr().err


def test_cli_resilience_and_logging_flags(tmp_path):
    """The JAX CLI's resilience flags, ``-tb`` and ``-lp`` drive one
    training run: the log mirrored into the file, the scalars in
    ``summaries/``, step snapshots beside the epoch saves."""
    prefix = make_dataset(tmp_path)
    save = tmp_path / 'models' / 'saved_model'
    log_path = tmp_path / 'train.log'
    model = main(['--data', str(prefix), '--dtype', 'float32',
                  '--batch-size', '16', '--epochs', '2', '--save', str(save),
                  '-tb', '-lp', str(log_path), '--save-every-steps', '3',
                  '--watchdog-secs', '60', '--max-divergence-rewinds', '2',
                  '--no-divergence-guard', '--fault-inject', '',
                  '--ragged-fusion'] + CPU)
    config = model.config
    assert (config.SAVE_EVERY_N_STEPS, config.HANG_WATCHDOG_SECS,
            config.MAX_DIVERGENCE_REWINDS, config.DIVERGENCE_GUARD,
            config.FAULT_INJECT, config.USE_PALLAS_RAGGED_FUSION) == (
                3, 60.0, 2, False, '', True)
    log = log_path.read_text()
    assert 'epoch 2: 4 steps' in log and 'Saved snapshot step 3' in log
    tags = {json.loads(line)['tag'] for line in
            (tmp_path / 'models' / 'summaries' / 'metrics.jsonl')
            .read_text().splitlines()}
    assert tags == {'train/epoch_wall_time_s'}   # no 100-step window ended
    snapshots = tmp_path / 'models' / 'saved_model__step-snapshots'
    assert sorted(p.name for p in snapshots.iterdir()) == ['3', '6']
    # the log file takes the next run's lines, at -v 0 too
    main(['--load', str(save), '--dtype', 'float32', '--release', '-lp',
          str(log_path)] + CPU)
    assert 'Released model saved' in log_path.read_text()


@pytest.mark.parametrize('flags, message', [
    (['--max-divergence-rewinds', '-1'], 'MAX_DIVERGENCE_REWINDS'),
    (['--watchdog-secs', '-1'], 'HANG_WATCHDOG_SECS'),
    (['--fault-inject', 'bogus@step=1'], 'unknown fault point'),
    (['--fault-inject', 'nan_loss=3'], 'not <point>@<trigger>'),
])
def test_cli_rejects_what_the_reference_rejects(tmp_path, flags, message):
    """The bad values the JAX ``Config.verify`` rejects fail the port's
    run before it starts, with the same message."""
    from code2vec_tpu.config import Config as JaxConfig
    prefix = make_dataset(tmp_path)
    args = ['--data', str(prefix)] + flags
    with pytest.raises(ValueError, match=message):
        JaxConfig().load_from_args(args).verify()
    with pytest.raises(ValueError, match=message):
        main(args + CPU)
