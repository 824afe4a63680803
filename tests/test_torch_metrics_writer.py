"""The port's metrics writer (code2vec_tpu_torch/metrics_writer.py),
case by case as tests/test_metrics_writer.py holds the reference's:
JSONL records, the -tb switch and log directory, append mode across
writers, buffering, the context manager, idempotent close, the atexit
flush and a failing disk; then the records the port's ``train()`` writes
against the reference's ``train()`` on the same corpus: the same tags on
the same global-step axis."""
import json

from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.metrics_writer import MetricsWriter, maybe_create


def test_scalars_append_jsonl(tmp_path):
    writer = MetricsWriter(str(tmp_path / 'logs'))
    writer.scalar('train/loss', 1.5, 10)
    writer.scalar('eval/f1', 0.25, 1)
    writer.close()
    lines = (tmp_path / 'logs' / 'metrics.jsonl').read_text().splitlines()
    records = [json.loads(line) for line in lines]
    assert records[0]['tag'] == 'train/loss'
    assert records[0]['value'] == 1.5
    assert records[0]['step'] == 10
    assert records[1]['tag'] == 'eval/f1'


def test_maybe_create_respects_flag(tmp_path):
    config = Config(TRAIN_DATA_PATH_PREFIX='x', USE_TENSORBOARD=False)
    assert maybe_create(config) is None
    config2 = Config(TRAIN_DATA_PATH_PREFIX='x', USE_TENSORBOARD=True,
                     MODEL_SAVE_PATH=str(tmp_path / 'm' / 'saved'))
    writer = maybe_create(config2)
    assert writer is not None
    assert writer.logdir == str(tmp_path / 'm' / 'summaries')
    writer.close()


def test_append_mode_survives_reopen(tmp_path):
    logdir = str(tmp_path / 'logs')
    w1 = MetricsWriter(logdir)
    w1.scalar('a', 1.0, 1)
    w1.close()
    w2 = MetricsWriter(logdir)
    w2.scalar('a', 2.0, 2)
    w2.close()
    lines = (tmp_path / 'logs' / 'metrics.jsonl').read_text().splitlines()
    assert len(lines) == 2


def test_writes_are_buffered_until_threshold_or_flush(tmp_path):
    path = tmp_path / 'logs' / 'metrics.jsonl'
    writer = MetricsWriter(str(tmp_path / 'logs'), buffer_records=3)
    writer.scalar('a', 1.0, 1)
    writer.scalar('a', 2.0, 2)
    assert not path.exists()          # buffered: no per-scalar I/O
    writer.scalar('a', 3.0, 3)        # hits the threshold
    assert len(path.read_text().splitlines()) == 3
    writer.scalar('a', 4.0, 4)
    writer.flush()                    # explicit flush drains the tail
    assert len(path.read_text().splitlines()) == 4
    writer.close()


def test_context_manager_flushes_on_exit(tmp_path):
    path = tmp_path / 'logs' / 'metrics.jsonl'
    with MetricsWriter(str(tmp_path / 'logs')) as writer:
        writer.scalar('a', 1.0, 1)
        assert not path.exists()
    assert len(path.read_text().splitlines()) == 1


def test_close_is_idempotent(tmp_path):
    writer = MetricsWriter(str(tmp_path / 'logs'))
    writer.scalar('a', 1.0, 1)
    writer.close()
    writer.close()
    lines = (tmp_path / 'logs' / 'metrics.jsonl').read_text().splitlines()
    assert len(lines) == 1


def test_atexit_flush_covers_unclosed_writers(tmp_path):
    path = tmp_path / 'logs' / 'metrics.jsonl'
    writer = MetricsWriter(str(tmp_path / 'logs'))
    writer.scalar('a', 1.0, 1)
    assert not path.exists()
    writer._atexit_flush()            # what interpreter exit would run
    assert len(path.read_text().splitlines()) == 1
    writer.close()


def test_write_failure_is_logged_once_not_fatal(tmp_path):
    """A failing metrics append (read-only or full disk) neither stops
    the training run nor passes silently: the first failure warns,
    close() reports the dropped total. Records are captured with a
    handler on the module logger itself, whatever the CLI made of the
    package logger."""
    import logging

    records = []
    handler = logging.Handler()
    handler.emit = records.append
    module_logger = logging.getLogger('code2vec_tpu_torch.metrics_writer')
    module_logger.addHandler(handler)
    old_level = module_logger.level
    module_logger.setLevel(logging.WARNING)
    try:
        writer = MetricsWriter(str(tmp_path / 'logs'), buffer_records=1)
        # point the stream at a DIRECTORY: every append raises OSError
        writer._path = str(tmp_path / 'logs')
        writer.scalar('a', 1.0, 1)   # must not raise
        writer.scalar('a', 2.0, 2)   # second failure: silent
        warnings = [r for r in records if 'DROPPED' in r.getMessage()]
        assert len(warnings) == 1
        records.clear()
        writer.close()
        assert any('2 record(s) dropped' in r.getMessage()
                   for r in records)
    finally:
        module_logger.removeHandler(handler)
        module_logger.setLevel(old_level)


def test_train_writes_the_reference_tags_on_the_step_axis(tmp_path):
    """``-tb``'s records from the port's ``train()`` and the reference's
    over the same corpus and schedule: the same (tag, step) sequence of
    the training scalars."""
    from code2vec_tpu.config import Config as JaxConfig
    from code2vec_tpu.model_api import Code2VecModel as JaxModel
    from code2vec_tpu_torch.model_api import Code2VecModel
    from tests.test_train_overfit import make_dataset
    prefix = make_dataset(tmp_path)
    shared = dict(TRAIN_DATA_PATH_PREFIX=str(prefix), MAX_CONTEXTS=6,
                  TRAIN_BATCH_SIZE=16, NUM_TRAIN_EPOCHS=2,
                  SAVE_EVERY_EPOCHS=1000, COMPUTE_DTYPE='float32',
                  NUM_BATCHES_TO_LOG_PROGRESS=2, USE_TENSORBOARD=True,
                  READER_USE_NATIVE=False)

    def records(root):
        lines = (root / 'summaries' / 'metrics.jsonl').read_text()
        return [(r['tag'], r['step']) for r in map(json.loads,
                                                    lines.splitlines())]

    JaxModel(JaxConfig(DL_FRAMEWORK='jax', VERBOSE_MODE=0,
                       MODEL_SAVE_PATH=str(tmp_path / 'jax' / 'm'),
                       **shared)).train()
    Code2VecModel(Config(MODEL_SAVE_PATH=str(tmp_path / 'port' / 'm'),
                         **shared), device='cpu').train()
    want = records(tmp_path / 'jax')
    assert records(tmp_path / 'port') == want
    assert {tag for tag, _ in want} == {
        'train/loss', 'train/examples_per_sec', 'train/epoch_wall_time_s'}
