"""The port's training resilience (code2vec_tpu_torch/resilience/,
``Trainer.fit``, ``checkpoints.py``'s step snapshots), case by case as
tests/test_resilience.py holds the reference's, on the CPU: the fault
spec's grammar and plan, the config and CLI knobs, the watchdog, the
preemption handler and the guard as units, and the drills end to end on
the tiny corpus of tests/test_train_overfit.py — a NaN loss rewound to
the prior snapshot and recovered (on both wires), the poisoned window's
snapshots purged, an abort with diagnostics when there is nothing to
rewind to, SIGTERM's snapshot and a resume whose step axis stays
monotonic, a corrupt snapshot's fallback and quarantine, and the hang
watchdog's abort of a real training process. The port's fault sites
outside the loop (``extractor_crash``) and the handler's second SIGINT
and thread rules are held here too."""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.model_api import Code2VecModel
from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.resilience.guard import (DivergenceError,
                                                 DivergenceGuard,
                                                 batch_stats)
from code2vec_tpu_torch.resilience.preempt import PreemptionHandler
from code2vec_tpu_torch.resilience.watchdog import (STACKS_FILE_NAME,
                                                    HangWatchdog)
from tests.test_train_overfit import make_dataset

WIRES = {'packed': {}, 'planes': dict(BATCH_WIRE_FORMAT='planes')}


@pytest.fixture(autouse=True)
def clear_fault_plan():
    """The plan is process-global: every test starts and ends disarmed."""
    faults.configure('')
    yield
    faults.configure('')


def _train_config(tmp_path, prefix, **overrides):
    defaults = dict(
        TRAIN_DATA_PATH_PREFIX=str(prefix), COMPUTE_DTYPE='float32',
        MAX_CONTEXTS=6, TRAIN_BATCH_SIZE=16, TEST_BATCH_SIZE=16,
        NUM_TRAIN_EPOCHS=2, SAVE_EVERY_EPOCHS=1000, SHUFFLE_BUFFER_SIZE=64,
        VERBOSE_MODE=0, READER_USE_NATIVE=False,
        MODEL_SAVE_PATH=str(tmp_path / 'models' / 'saved_model'),
        TELEMETRY_DIR=str(tmp_path / 'tele'))
    defaults.update(overrides)
    return Config(**defaults)


def _model(config):
    return Code2VecModel(config, device='cpu')


# ------------------------------------------------------------- fault plan
def test_parse_spec_grammar():
    assert faults.parse_spec('') == {}
    assert faults.parse_spec('nan_loss@step=120') == {'nan_loss': 120}
    assert faults.parse_spec('nan_loss@step=120, sigterm@step=50') == \
        {'nan_loss': 120, 'sigterm': 50}
    assert faults.parse_spec('corrupt_snapshot@save=2') == \
        {'corrupt_snapshot': 2}
    with pytest.raises(ValueError, match='unknown fault point'):
        faults.parse_spec('definitely_not_a_point@step=1')
    with pytest.raises(ValueError, match='not <point>@<trigger>'):
        faults.parse_spec('nan_loss=3')
    with pytest.raises(ValueError, match='not <point>@<trigger>'):
        faults.parse_spec('nan_loss@step=abc')


def test_config_verify_rejects_bad_fault_spec():
    config = Config(TRAIN_DATA_PATH_PREFIX='x', FAULT_INJECT='bogus@step=1')
    with pytest.raises(ValueError, match='unknown fault point'):
        config.verify()


def test_cli_flags_fill_resilience_knobs(monkeypatch):
    monkeypatch.delenv('FAULT_INJECT', raising=False)
    config = Config().load_from_args(
        ['--data', 'x', '--fault-inject', 'nan_loss@step=3',
         '--watchdog-secs', '5.5', '--max-divergence-rewinds', '7',
         '--no-divergence-guard'])
    assert config.FAULT_INJECT == 'nan_loss@step=3'
    assert config.HANG_WATCHDOG_SECS == 5.5
    assert config.MAX_DIVERGENCE_REWINDS == 7
    assert not config.DIVERGENCE_GUARD
    # the environment variable fills an unset flag
    monkeypatch.setenv('FAULT_INJECT', 'sigterm@step=9')
    assert Config().load_from_args(['--data', 'x']).FAULT_INJECT == \
        'sigterm@step=9'
    # the flag wins over it
    config3 = Config().load_from_args(
        ['--data', 'x', '--fault-inject', 'sigterm@step=2'])
    assert config3.FAULT_INJECT == 'sigterm@step=2'
    # and an explicit '' turns injection off (a drill's control arm)
    config4 = Config().load_from_args(['--data', 'x', '--fault-inject', ''])
    assert config4.FAULT_INJECT == ''


def test_fault_plan_fires_once_at_step():
    faults.configure('nan_loss@step=3')
    assert not faults.maybe_fire('nan_loss', step=2)
    assert faults.maybe_fire('nan_loss', step=3)
    assert not faults.maybe_fire('nan_loss', step=4)  # single shot
    assert not faults.maybe_fire('sigterm', step=3)   # not in the plan


def test_fault_plan_fires_late_when_exact_step_was_skipped():
    """A resumed run can start past the trigger: it still fires once."""
    faults.configure('nan_loss@step=3')
    assert faults.maybe_fire('nan_loss', step=10)


def test_fault_plan_site_counter_mode():
    """Sites with no step of their own count their calls."""
    faults.configure('hang_input@step=2')
    assert not faults.maybe_fire('hang_input')   # call 0
    assert not faults.maybe_fire('hang_input')   # call 1
    assert faults.maybe_fire('hang_input')       # call 2
    assert not faults.maybe_fire('hang_input')   # single shot


def test_disarmed_plan_is_inert():
    faults.configure('')
    assert not faults.active()
    assert not faults.maybe_fire('nan_loss', step=0)


# --------------------------------------------------------------- watchdog
def test_watchdog_expires_dumps_stacks_and_aborts(tmp_path):
    aborted = threading.Event()
    expired = []
    wd = HangWatchdog(0.2, str(tmp_path), abort=aborted.set, poll_s=0.02,
                      on_expire=lambda: expired.append(True))
    wd.arm('unit-test wait')
    assert aborted.wait(timeout=5.0), 'watchdog never fired'
    wd.shutdown()
    assert expired == [True] and wd.expired
    stacks = (tmp_path / STACKS_FILE_NAME).read_text()
    assert 'unit-test wait' in stacks
    # every thread's frames, this test's among them
    assert 'test_torch_resilience' in stacks


def test_watchdog_disarm_prevents_expiry(tmp_path):
    fired = threading.Event()
    wd = HangWatchdog(0.1, str(tmp_path), abort=fired.set, poll_s=0.02)
    with wd.watch('quick wait'):
        pass
    time.sleep(0.3)
    wd.shutdown()
    assert not fired.is_set()
    assert not (tmp_path / STACKS_FILE_NAME).exists()


def test_watchdog_rearm_resets_deadline(tmp_path):
    fired = threading.Event()
    wd = HangWatchdog(0.25, str(tmp_path), abort=fired.set, poll_s=0.02)
    for _ in range(4):  # 0.4 s of short watched waits: never overdue
        with wd.watch('short wait'):
            time.sleep(0.1)
    assert not fired.is_set()
    wd.shutdown()


# -------------------------------------------------------------- preempt
def _wait_for(predicate, timeout=1.0):
    deadline = time.time() + timeout
    while not predicate() and time.time() < deadline:
        time.sleep(0.01)
    return predicate()


def test_preemption_handler_flag_and_restore():
    previous = signal.getsignal(signal.SIGTERM)
    with PreemptionHandler() as handler:
        assert not handler.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert _wait_for(lambda: handler.requested)
        assert handler.signal_name == 'SIGTERM'
    assert signal.getsignal(signal.SIGTERM) is previous


def test_second_sigint_raises_keyboard_interrupt():
    previous = signal.getsignal(signal.SIGINT)
    with PreemptionHandler() as handler:
        os.kill(os.getpid(), signal.SIGINT)
        assert _wait_for(lambda: handler.requested)
        assert handler.signal_name == 'SIGINT'
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)
            time.sleep(1.0)
    assert signal.getsignal(signal.SIGINT) is previous


def test_preemption_handler_off_the_main_thread_only_polls():
    previous = signal.getsignal(signal.SIGTERM)
    seen = []

    def run():
        with PreemptionHandler() as handler:
            seen.append(signal.getsignal(signal.SIGTERM))
            seen.append(handler.requested)

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert seen == [previous, False]
    assert signal.getsignal(signal.SIGTERM) is previous


# ----------------------------------------------------------------- guard
class _FakeState:
    step = 7


def test_guard_aborts_without_restore_target(tmp_path):
    guard = DivergenceGuard(3, restore=None, dump_dir=str(tmp_path))
    with pytest.raises(DivergenceError, match='no checkpoint'):
        guard.handle(4, [float('nan')], None)
    dump = json.loads((tmp_path / 'divergence_step4.json').read_text())
    assert dump['batch_num'] == 4


def test_guard_budget_exhaustion(tmp_path):
    guard = DivergenceGuard(1, restore=lambda b: _FakeState(),
                            dump_dir=str(tmp_path))
    state = guard.handle(2, [float('inf')], None)
    assert state.step == 7
    with pytest.raises(DivergenceError, match='budget'):
        guard.handle(4, [float('nan')], None)


def test_guard_ceiling_is_the_first_bad_step(tmp_path):
    asked = []
    guard = DivergenceGuard(3, restore=lambda s: asked.append(s) or
                            _FakeState(), dump_dir=str(tmp_path))
    guard.handle(10, [1.0, 2.0, float('nan'), float('nan')], None,
                 step_now=8)
    assert asked == [6]     # steps 4, 5 finite: the weights at 6 are clean


def test_batch_stats_tolerates_batch_types():
    from code2vec_tpu_torch.data.packed import PackedBatch
    from code2vec_tpu_torch.data.reader import Batch
    batch = Batch(source=np.ones((2, 3), np.int32),
                  path=np.zeros((2, 3), np.int32),
                  target=np.ones((2, 3), np.int32),
                  mask=np.ones((2, 3), np.float32),
                  label=np.arange(2, dtype=np.int32),
                  weight=np.ones((2,), np.float32))
    stats = batch_stats(batch)
    assert stats['label'] == {'shape': [2], 'dtype': 'int32',
                              'min': 0.0, 'max': 1.0}
    packed = PackedBatch(ctx=np.ones((1, 4, 3), np.int32),
                         count=np.array([2, 2], np.int32),
                         label=np.arange(2, dtype=np.int32),
                         weight=np.ones((2,), np.float32))
    assert batch_stats(packed)['ctx']['shape'] == [1, 4, 3]
    assert batch_stats(None) == {}


def test_quarantine_picks_unique_destination(tmp_path):
    """A repeat rewind can quarantine the same step number twice (the
    step was saved again after the first purge): the second rename must
    not fail against the existing `.rewound` directory."""
    from code2vec_tpu_torch.checkpoints import CheckpointStore
    store = CheckpointStore(str(tmp_path / 'm'))
    for _ in range(2):
        (tmp_path / '6').mkdir()
        (tmp_path / '6' / 'x').write_text('data')
        store._quarantine(str(tmp_path), 6, suffix='.rewound')
    assert (tmp_path / '6.rewound').is_dir()
    assert (tmp_path / '6.rewound.2').is_dir()
    assert not (tmp_path / '6').exists()


# ---------------------------------------------------------- e2e: drills
@pytest.mark.parametrize('wire', sorted(WIRES))
def test_nan_loss_rewinds_and_recovers(tmp_path, wire):
    """nan_loss@step=k rewinds to the prior snapshot, skips the poisoned
    window and finishes healthy (finite eval loss, a step counter short by
    exactly the rewound window), on either wire."""
    prefix = make_dataset(tmp_path)
    kwargs = dict(NUM_TRAIN_EPOCHS=8, LEARNING_RATE=0.01,
                  TEST_DATA_PATH=str(tmp_path / 'tiny.val.c2v'),
                  SAVE_EVERY_N_STEPS=2, NUM_BATCHES_TO_LOG_PROGRESS=2,
                  **WIRES[wire])
    model = _model(_train_config(tmp_path, prefix,
                                 FAULT_INJECT='nan_loss@step=5', **kwargs))
    model.train()
    # 8 epochs x 4 steps = 32 batches; the poisoned window (batches 4 and
    # 5, synced at 6) rewound to the step-4 snapshot: 32 - 2
    assert int(model.state.step) == 30
    results = model.evaluate()
    assert results.loss is not None and np.isfinite(results.loss)

    # the uninjected twin (same seeds, same batch order, 2 more steps)
    twin = _model(_train_config(
        tmp_path, prefix,
        MODEL_SAVE_PATH=str(tmp_path / 'models_twin' / 'saved_model'),
        **kwargs))
    twin.train()
    twin_results = twin.evaluate()
    assert results.loss < twin_results.loss * 1.5 + 0.1, \
        (results.loss, twin_results.loss)
    dump = json.loads((tmp_path / 'tele' /
                       'divergence_step6.json').read_text())
    assert dump['batch_num'] == 6
    assert any(not np.isfinite(x) for x in dump['window_losses'])
    assert ('ctx' if wire == 'packed' else 'label') in dump['last_batch']


def test_rewind_purges_poisoned_window_snapshots(tmp_path):
    """A snapshot saved between the first NaN and its detection holds
    suspect weights: the rewind moves it aside (`<step>.rewound`), so a
    later resume does not take it for the newest state, and the
    re-trained step is saved again."""
    prefix = make_dataset(tmp_path)
    model = _model(_train_config(
        tmp_path, prefix, NUM_TRAIN_EPOCHS=3, SAVE_EVERY_N_STEPS=2,
        NUM_BATCHES_TO_LOG_PROGRESS=4, FAULT_INJECT='nan_loss@step=5'))
    model.train()
    # NaN at batch 5 -> the step-6 snapshot lands inside the poisoned
    # window -> the batch-8 sync rewinds to step 4 (first bad step 5) and
    # purges step 6; 12 batches minus 4 rewound steps end at step 8
    assert int(model.state.step) == 8
    snapshot_dir = tmp_path / 'models' / 'saved_model__step-snapshots'
    assert (snapshot_dir / '6.rewound').is_dir()
    assert (snapshot_dir / '6').is_dir()
    model2 = _model(_train_config(
        tmp_path, prefix, NUM_TRAIN_EPOCHS=3,
        MODEL_LOAD_PATH=str(tmp_path / 'models' / 'saved_model')))
    assert int(model2.state.step) == 6


def test_nan_loss_without_snapshot_aborts_with_diagnostics(tmp_path):
    """No checkpoint to rewind to: the guard fails loud with the dump
    instead of training on NaN."""
    prefix = make_dataset(tmp_path)
    model = _model(_train_config(
        tmp_path, prefix, NUM_TRAIN_EPOCHS=1, MODEL_SAVE_PATH=None,
        NUM_BATCHES_TO_LOG_PROGRESS=2, FAULT_INJECT='nan_loss@step=1'))
    with pytest.raises(DivergenceError, match='no checkpoint'):
        model.train()
    assert (tmp_path / 'tele' / 'divergence_step2.json').exists()


def test_nan_in_an_epochs_partial_window_is_caught(tmp_path):
    """An epoch shorter than the log window ends no window: its partial
    window is checked at the epoch's end."""
    prefix = make_dataset(tmp_path)
    model = _model(_train_config(
        tmp_path, prefix, NUM_TRAIN_EPOCHS=1, MODEL_SAVE_PATH=None,
        NUM_BATCHES_TO_LOG_PROGRESS=100, FAULT_INJECT='nan_loss@step=2'))
    with pytest.raises(DivergenceError, match='no checkpoint'):
        model.train()
    assert (tmp_path / 'tele' / 'divergence_step4.json').exists()


def test_divergence_guard_off_trains_on(tmp_path):
    prefix = make_dataset(tmp_path)
    model = _model(_train_config(
        tmp_path, prefix, NUM_TRAIN_EPOCHS=1, MODEL_SAVE_PATH=None,
        DIVERGENCE_GUARD=False, NUM_BATCHES_TO_LOG_PROGRESS=2,
        FAULT_INJECT='nan_loss@step=1'))
    losses = model.train()
    assert int(model.state.step) == 4 and not np.isfinite(losses[0])
    assert not (tmp_path / 'tele').exists()


def test_sigterm_preempts_saves_and_resumes_monotonically(tmp_path):
    """sigterm@step=k ends the run cleanly with a snapshot at exactly step
    k; a --load resume restarts the interrupted epoch from it, and the
    metric stream's step axis stays monotonic across the boundary."""
    prefix = make_dataset(tmp_path)
    kwargs = dict(NUM_TRAIN_EPOCHS=4, SAVE_EVERY_EPOCHS=1,
                  TEST_DATA_PATH=str(tmp_path / 'tiny.val.c2v'),
                  NUM_BATCHES_TO_LOG_PROGRESS=2, USE_TENSORBOARD=True)
    model = _model(_train_config(tmp_path, prefix,
                                 FAULT_INJECT='sigterm@step=5', **kwargs))
    previous = signal.getsignal(signal.SIGTERM)
    model.train()    # returns early, after the preemption save
    assert int(model.state.step) == 5
    snapshot_dir = tmp_path / 'models' / 'saved_model__step-snapshots'
    assert (snapshot_dir / '5').is_dir()
    marker = json.loads((snapshot_dir / 'PREEMPTED.json').read_text())
    assert marker['step'] == 5
    # step 5 is inside epoch 1 (4 steps an epoch): the last complete is 0
    assert marker['last_complete_epoch'] == 0
    assert signal.getsignal(signal.SIGTERM) is previous   # restored

    model2 = _model(_train_config(
        tmp_path, prefix,
        MODEL_LOAD_PATH=str(tmp_path / 'models' / 'saved_model'),
        **kwargs))
    assert int(model2.state.step) == 5
    assert model2._start_epoch == 1     # restarts the interrupted epoch
    assert not (snapshot_dir / 'PREEMPTED.json').exists()   # consumed
    model2.train()                      # epochs 1..3
    assert int(model2.state.step) > 5
    assert model2.eval_history, 'the resumed run ran no evaluation'

    metrics_path = tmp_path / 'models' / 'summaries' / 'metrics.jsonl'
    by_tag = {}
    for line in metrics_path.read_text().splitlines():
        record = json.loads(line)
        by_tag.setdefault(record['tag'], []).append(record['step'])
    assert {'train/loss', 'train/examples_per_sec',
            'train/epoch_wall_time_s', 'eval/top1_acc'} <= set(by_tag)
    for tag, steps in by_tag.items():
        assert steps == sorted(steps), (tag, steps)


def test_preempted_before_the_first_step_saves_nothing(tmp_path):
    prefix = make_dataset(tmp_path)
    model = _model(_train_config(tmp_path, prefix))
    real_fit = model.trainer.fit

    def fit_after_signal(*args, **kwargs):
        os.kill(os.getpid(), signal.SIGTERM)
        return real_fit(*args, **kwargs)

    model.trainer.fit = fit_after_signal
    model.train()
    assert int(model.state.step) == 0
    snapshot_dir = tmp_path / 'models' / 'saved_model__step-snapshots'
    assert not (snapshot_dir / 'PREEMPTED.json').exists()
    assert not (snapshot_dir / '0').exists()


def test_corrupt_snapshot_restore_falls_back_and_quarantines(tmp_path):
    """The newest snapshot truncated on disk: restore logs, quarantines
    that step and falls back to the next older one."""
    prefix = make_dataset(tmp_path)
    _model(_train_config(
        tmp_path, prefix, NUM_TRAIN_EPOCHS=2, SAVE_EVERY_N_STEPS=2,
        FAULT_INJECT='corrupt_snapshot@save=2')).train()
    snapshot_dir = tmp_path / 'models' / 'saved_model__step-snapshots'
    # snapshots at steps 2, 4, 6 (two kept); the third (step 6) corrupted
    assert (snapshot_dir / '6').is_dir()
    assert not (snapshot_dir / '2').exists()

    model2 = _model(_train_config(
        tmp_path, prefix, NUM_TRAIN_EPOCHS=2,
        MODEL_LOAD_PATH=str(tmp_path / 'models' / 'saved_model')))
    assert int(model2.state.step) == 4   # fell back past the corrupt 6
    assert (snapshot_dir / '6.corrupt').is_dir()   # quarantined, kept
    assert not (snapshot_dir / '6').exists()
    model2.train()    # the fallback state trains on


def test_all_snapshots_corrupt_raises_clearly(tmp_path):
    prefix = make_dataset(tmp_path)
    _model(_train_config(tmp_path, prefix, NUM_TRAIN_EPOCHS=1,
                         SAVE_EVERY_N_STEPS=2)).train()
    snapshot_dir = tmp_path / 'models' / 'saved_model__step-snapshots'
    for step_dir in snapshot_dir.iterdir():
        if step_dir.is_dir():
            faults.corrupt_directory(str(step_dir))
    with pytest.raises(ValueError, match='could be restored'):
        _model(_train_config(
            tmp_path, prefix, NUM_TRAIN_EPOCHS=1,
            MODEL_LOAD_PATH=str(tmp_path / 'models' / 'saved_model')))
    # nothing was quarantined: a failure every step shares is no corruption
    assert sorted(p.name for p in snapshot_dir.iterdir()) == ['2']


def test_extractor_crash_site_retries_then_opens_the_breaker():
    from code2vec_tpu_torch.serving.errors import ExtractorCrash
    from code2vec_tpu_torch.serving.extractor_bridge import ExtractorPool

    class Healthy:
        calls = 0

        def extract_paths(self, path):
            Healthy.calls += 1
            return ['m a,b,c'], {}

    config = Config(EXTRACTOR_RETRIES=1, EXTRACTOR_BACKOFF_SECS=0.0,
                    EXTRACTOR_BREAKER_THRESHOLD=1)
    faults.configure('extractor_crash@call=0..1')
    with ExtractorPool(config, extractor_command=[sys.executable],
                       sleep=lambda s: None) as pool:
        pool.extractor = Healthy()
        with pytest.raises(ExtractorCrash, match='FAULT_INJECT'):
            pool.extract_paths('A.java')
        assert Healthy.calls == 0 and pool.state() == 'open'


def test_hang_input_watchdog_aborts_subprocess(tmp_path):
    """hang_input@step=1 wedges the input stream; the watchdog dumps every
    thread's stack to disk and aborts the process past its deadline —
    a real training process, since SIGABRT cannot be faked in one."""
    from code2vec_tpu_torch.data import native
    native.load()     # built before the deadline starts, not inside it
    prefix = make_dataset(tmp_path)
    cmd = [sys.executable, '-m', 'code2vec_tpu_torch.cli',
           '--data', str(prefix), '--epochs', '1', '--batch-size', '16',
           '--dtype', 'float32', '--no-data-cache', '--device', 'cpu',
           '--fault-inject', 'hang_input@step=1', '--watchdog-secs', '5',
           '-v', '0']
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ,
           'PYTHONPATH': repo + os.pathsep + os.environ.get('PYTHONPATH',
                                                            '')}
    result = subprocess.run(cmd, capture_output=True, text=True, env=env,
                            timeout=240, cwd=str(tmp_path))
    assert result.returncode == -signal.SIGABRT, (result.stdout,
                                                  result.stderr)
    stacks = (tmp_path / 'telemetry' / STACKS_FILE_NAME).read_text()
    assert 'next staged batch (batch 1)' in stacks   # the wait that expired
    assert 'fault_site_batches' in stacks            # the hung frame
    assert 'Thread' in stacks                        # every thread's
