"""The port's serving engine under overload and across rollovers, case by
case as tests/test_serving_resilience.py, on the CPU: the fault-window
grammar of ``resilience/faults.py`` against the reference's; admission
(``reject_all``, the drain-estimate shed, the service rate over parallel
completions, the oversize request admitted alone, the overload drill with
typed errors and bit-identical results, the degradation ladder); close
semantics; the canaried rollover between the two parameter slots (swap,
rollback, no capture after warm-up, the vectors-only guard and timeout,
the API guards); the param source (steps, ``follow_checkpoints``, its
single poller, retry and baseline); and the one-slot engine's second
slot."""
import threading
import time

import numpy as np
import pytest
import torch

from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.model_api import Code2VecModel
from code2vec_tpu_torch.models.functional import Code2VecParams
from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.serving.errors import (DeadlineExceeded, EngineClosed,
                                               EngineOverloaded, ServingError)
from tests.test_serving_engine import PREDICT_LINES
from tests.test_train_overfit import make_dataset

MODEL = dict(COMPUTE_DTYPE='float32', MAX_CONTEXTS=6)


@pytest.fixture(autouse=True)
def clear_fault_plan():
    """The plan is process-global: every test starts and ends
    disarmed."""
    faults.configure('')
    yield
    faults.configure('')


@pytest.fixture(scope='module')
def model(tmp_path_factory):
    prefix = make_dataset(tmp_path_factory.mktemp('torch_engine_res'))
    return Code2VecModel(Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                                SERVING_BATCH_BUCKETS='8,16', **MODEL),
                         device='cpu')


def _saving_model(tmp_path_factory, name):
    """A model with a save path (its param source), saved at step 0,
    with the canary off for determinism."""
    prefix = make_dataset(tmp_path_factory.mktemp(name))
    save_path = str(tmp_path_factory.mktemp(name + '_model') / 'model')
    model = Code2VecModel(Config(
        TRAIN_DATA_PATH_PREFIX=str(prefix), MODEL_SAVE_PATH=save_path,
        SERVING_BATCH_BUCKETS='8', SERVING_CANARY_BATCHES=0, **MODEL),
        device='cpu')
    model.state = model.trainer.state_from_params()
    model.save(epoch=0)   # step 0
    return model


def _save_step(model, step):
    model.state = model.state._replace(step=step)
    model.save(epoch=0)


def _wait_until(predicate, timeout=10.0, what='condition'):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if predicate():
            return
        time.sleep(0.001)
    raise AssertionError('timed out waiting for %s' % what)


def _stall_dispatcher(engine, line):
    """Submit one plug request and wait until the dispatcher popped it:
    it is then inside the injected ``slow_dispatch`` stall and everything
    submitted next queues behind it. Returns the plug's future."""
    plug = engine.submit([line], tier='topk')
    _wait_until(lambda: engine.queue_depth.snapshot() == 0,
                what='dispatcher to pop the plug batch')
    return plug


def _copy(params):
    return Code2VecParams(*[t.clone() for t in params])


def _same_results(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.topk_predicted_words == y.topk_predicted_words
        np.testing.assert_array_equal(x.topk_predicted_words_scores,
                                      y.topk_predicted_words_scores)


# ----------------------------------------------------- fault-window grammar
@pytest.mark.parametrize('spec', [
    'extractor_crash@call=0..2', 'slow_dispatch@req=1..1,nan_loss@step=7',
    'reject_all@req=0..1', ''])
def test_fault_window_parse(spec):
    from code2vec_tpu.resilience import faults as jax_faults
    assert faults.parse_spec(spec) == jax_faults.parse_spec(spec)


@pytest.mark.parametrize('spec', [
    'slow_dispatch@req=3..1', 'slow_dispatch@req=-1..2',
    'no_such_point@call=0..1', 'slow_dispatch', 'slow_dispatch@req=x'])
def test_fault_window_parse_rejects_as_reference(spec):
    from code2vec_tpu.resilience import faults as jax_faults
    with pytest.raises(ValueError):
        faults.parse_spec(spec)
    with pytest.raises(ValueError):
        jax_faults.parse_spec(spec)


def test_fault_catalog_names_the_reference_points():
    from code2vec_tpu.resilience import faults as jax_faults
    assert set(faults.FAULT_POINTS) == set(jax_faults.FAULT_POINTS)
    assert faults.SLOW_DISPATCH_SECONDS == jax_faults.SLOW_DISPATCH_SECONDS


def test_fault_window_fires_every_count_inside_then_disarms():
    faults.configure('slow_dispatch@req=1..2')
    fired = [faults.maybe_fire('slow_dispatch') for _ in range(5)]
    assert fired == [False, True, True, False, False]


def test_fault_single_shot_still_single_shot():
    faults.configure('slow_dispatch@req=1')
    fired = [faults.maybe_fire('slow_dispatch') for _ in range(4)]
    assert fired == [False, True, False, False]
    assert faults.active()
    faults.configure('')
    assert not faults.active()


# ---------------------------------------------------------- admission drills
def test_reject_all_drill_sheds_typed(model):
    with model.serving_engine(tiers=('topk',), max_delay_ms=0.0,
                              queue_bound=64) as engine:
        faults.configure('reject_all@req=0..1')
        for _ in range(2):
            with pytest.raises(EngineOverloaded):
                engine.submit(PREDICT_LINES[:1], tier='topk')
        results = engine.predict(PREDICT_LINES[:1], tier='topk',
                                 timeout=60)
        assert results[0].topk_predicted_words
        assert engine.stats()['shed_total'] == 2


def test_drain_estimate_sheds_undeliverable_deadline(model):
    with model.serving_engine(tiers=('topk',), max_delay_ms=0.0,
                              queue_bound=64) as engine:
        engine.predict(PREDICT_LINES[:1], tier='topk', timeout=60)
        with engine._lock:
            engine._service_rows_per_s = 1.0
        with pytest.raises(EngineOverloaded, match='drain estimate'):
            engine.submit(PREDICT_LINES, tier='topk', deadline_ms=100.0)
        assert len(engine.predict(PREDICT_LINES, tier='topk',
                                  timeout=60)) == 3


def test_service_rate_aggregates_parallel_completions(model):
    import types
    engine = model.serving_engine(tiers=('topk',), max_delay_ms=0.0,
                                  warmup=False)
    try:
        req = types.SimpleNamespace(t_enqueue=time.perf_counter() - 1.0)
        engine._note_service(100, [req])  # seeds ~100 rows/s (sojourn)
        for _ in range(8):                # a burst microseconds apart
            engine._note_service(100, [req])
        rate = engine._service_rows_per_s
        assert rate < 1000, 'burst inflated the service rate: %r' % rate
        time.sleep(0.06)
        engine._note_service(100, [req])
        assert engine._service_rows_per_s > rate
    finally:
        engine.close()


def test_oversize_request_admitted_alone_then_bounds_queue(model):
    lines = PREDICT_LINES * 2  # 6 rows > bound
    engine = model.serving_engine(tiers=('topk',), max_delay_ms=0.0,
                                  queue_bound=4)
    try:
        faults.configure('slow_dispatch@req=0..63')
        plug = _stall_dispatcher(engine, PREDICT_LINES[0])
        oversize = engine.submit(lines, tier='topk')
        with pytest.raises(EngineOverloaded):
            engine.submit(PREDICT_LINES[:1], tier='topk')
        faults.configure('')
        results = oversize.result(timeout=60)
        assert [r.original_name for r in results] == \
            [model.predict([line])[0].original_name for line in lines]
        plug.result(timeout=60)
        assert engine.stats()['shed_total'] == 1
    finally:
        faults.configure('')
        engine.close()


def test_overload_drill_sheds_expires_and_results_bit_identical(model):
    """Bounded queue + injected ``slow_dispatch``: the burst sheds at
    admission, deadlined queued work expires, both typed; the queue never
    passes its bound and every admitted request's results equal the
    unloaded path's bit for bit."""
    line = PREDICT_LINES[0]
    unloaded = model.predict([line])[0]
    bound = 8
    engine = model.serving_engine(tiers=('topk',), max_delay_ms=0.0,
                                  queue_bound=bound)
    try:
        faults.configure('slow_dispatch@req=0..63')
        plug = _stall_dispatcher(engine, line)
        doomed = [engine.submit([line], tier='topk', deadline_ms=60.0)
                  for _ in range(4)]
        admitted, shed = [], 0
        for _ in range(10):
            try:
                admitted.append(engine.submit([line], tier='topk'))
            except EngineOverloaded:
                shed += 1
        assert shed == 6 and len(admitted) == 4
        assert engine.stats()['queue_peak_rows'] <= bound
        for future in doomed:
            assert isinstance(future.exception(timeout=60),
                              DeadlineExceeded)
        for future in admitted + [plug]:
            (result,) = future.result(timeout=60)
            assert result.original_name == unloaded.original_name
            assert result.topk_predicted_words == \
                unloaded.topk_predicted_words
            np.testing.assert_array_equal(
                result.topk_predicted_words_scores,
                unloaded.topk_predicted_words_scores)
        stats = engine.stats()
        assert stats['shed_total'] == 6
        assert stats['expired_total'] == 4
    finally:
        faults.configure('')
        engine.close()


def test_degradation_ladder_downgrades_full_under_sustained_load(model):
    line = PREDICT_LINES[0]
    engine = model.serving_engine(
        tiers=('topk', 'attention', 'full'), max_delay_ms=0.0,
        queue_bound=8)
    try:
        faults.configure('slow_dispatch@req=0..63')
        plug = _stall_dispatcher(engine, line)
        backlog = [engine.submit([line], tier='topk') for _ in range(6)]
        # 6 queued + 1 reserved = 7/8 fill >= 0.75: overload level 2
        degraded = engine.submit([line], tier='full')
        assert engine.stats()['overload_level'] == 2
        assert engine.stats()['degraded_total'] == 1
        (result,) = degraded.result(timeout=60)
        assert result.attention_per_context == {}
        assert result.code_vector is None
        for future in backlog + [plug]:
            future.result(timeout=60)
    finally:
        faults.configure('')
        engine.close()
    with model.serving_engine(tiers=('topk', 'full'),
                              max_delay_ms=0.0) as calm:
        (result,) = calm.predict([line], tier='full', timeout=60)
        assert result.attention_per_context != {}
        assert result.code_vector is not None


# ------------------------------------------------------------ close semantics
def test_default_close_fails_queued_futures_typed(model):
    line = PREDICT_LINES[0]
    engine = model.serving_engine(tiers=('topk',), max_delay_ms=0.0)
    faults.configure('slow_dispatch@req=0..63')
    plug = _stall_dispatcher(engine, line)
    queued = [engine.submit([line], tier='topk') for _ in range(3)]
    engine.close()
    assert plug.result(timeout=60)[0].topk_predicted_words
    for future in queued:
        assert isinstance(future.exception(timeout=10), EngineClosed)
    with pytest.raises(EngineClosed):
        engine.submit([line], tier='topk')
    assert not engine._dispatcher.is_alive()


def test_close_drain_serves_everything_admitted(model):
    engine = model.serving_engine(tiers=('topk',), max_delay_ms=10_000.0)
    futures = [engine.submit([line], tier='topk')
               for line in PREDICT_LINES]
    engine.close(drain=True)
    for future, line in zip(futures, PREDICT_LINES):
        (result,) = future.result(timeout=60)
        assert result.topk_predicted_words == \
            model.predict([line])[0].topk_predicted_words
    assert not engine._dispatcher.is_alive()


def test_concurrent_submit_close_stress(model):
    """Racing submit() and close() (and load_params) resolve every
    returned future, with a result or a typed ServingError, and leak no
    dispatcher thread."""
    engine = model.serving_engine(tiers=('topk',), max_delay_ms=1.0)
    futures = []
    futures_lock = threading.Lock()
    begun = threading.Barrier(6)  # 4 submitters + loader + main
    same = _copy(engine.params)

    def submitter(i):
        begun.wait()
        while True:
            try:
                future = engine.submit(
                    [PREDICT_LINES[i % len(PREDICT_LINES)]], tier='topk')
            except EngineClosed:
                return
            except EngineOverloaded:
                continue
            with futures_lock:
                futures.append(future)

    def loader():
        begun.wait()
        for _ in range(20):
            try:
                engine.load_params(same, canary_batches=0).result(10)
            except (EngineClosed, RuntimeError):
                pass
            time.sleep(0.001)

    threads = [threading.Thread(target=submitter, args=(i,))
               for i in range(4)] + [threading.Thread(target=loader)]
    for thread in threads:
        thread.start()
    begun.wait()
    time.sleep(0.25)
    engine.close()
    for thread in threads:
        thread.join(timeout=60)
        assert not thread.is_alive()
    assert futures, 'stress produced no traffic'
    unresolved = [f for f in futures if not f.done()]
    assert not unresolved, '%d futures left unresolved' % len(unresolved)
    for future in futures:
        exc = future.exception()
        assert exc is None or isinstance(exc, ServingError), repr(exc)
    assert not engine._dispatcher.is_alive()


# ------------------------------------------------------------------ rollover
def test_rollover_canary_swap_rollback_and_zero_captures(model):
    """A live rollover (canary pass -> swap to the other slot, canary fail
    -> rollback) captures nothing after warm-up and keeps serving the
    same answers."""
    lines = PREDICT_LINES
    engine = model.serving_engine(tiers=('topk',), max_delay_ms=0.0)
    try:
        same = _copy(model.backend.params)
        broken = Code2VecParams(*[-t for t in model.backend.params])
        before = engine.predict(lines, tier='topk', timeout=60)
        warm = engine.stats()['graph_captures']

        handle = engine.load_params(same, canary_batches=2,
                                    min_agreement=0.9)
        for _ in range(3):
            engine.predict(lines, tier='topk', timeout=60)
        report = handle.result(timeout=60)
        assert report['swapped'] is True
        assert report['agreement'] == pytest.approx(1.0)
        assert report['rows'] >= 2 * len(lines)
        assert engine.stats()['serving_slot'] == 1
        for got, want in zip(engine.params, same):
            assert torch.equal(got, want)

        handle = engine.load_params(broken, canary_batches=2,
                                    min_agreement=0.9)
        for _ in range(3):
            engine.predict(lines, tier='topk', timeout=60)
        report = handle.result(timeout=60)
        assert report['swapped'] is False
        assert report['agreement'] < 0.9
        stats = engine.stats()
        assert stats['serving_slot'] == 1   # rollback kept the serving set
        assert stats['rollover_total'] == 1
        assert stats['rollover_rollbacks_total'] == 1
        assert stats['graph_captures'] - warm == 0
        assert stats['graph_captures_after_warmup'] == 0
        assert engine.slot_captures == 0
        _same_results(before, engine.predict(lines, tier='topk',
                                             timeout=60))
    finally:
        engine.close()


def test_one_slot_engine_allocates_its_second_slot_at_first_load(model):
    engine = model.serving_engine(tiers=('topk',), max_delay_ms=0.0)
    try:
        assert engine.param_slots == 1 and len(engine.ladder.slots) == 1
        before = engine.predict(PREDICT_LINES, tier='topk', timeout=60)
        report = engine.load_params(_copy(model.backend.params),
                                    canary_batches=0).result(10)
        assert report['swapped'] is True
        assert len(engine.ladder.slots) == 2
        assert engine.stats()['serving_slot'] == 1
        # the CPU captures nothing; the card would capture slot 1's keys
        assert engine.slot_captures == 0
        _same_results(before, engine.predict(PREDICT_LINES, tier='topk',
                                             timeout=60))
    finally:
        engine.close()


def test_canary_rejected_on_vectors_only_engine(model):
    engine = model.serving_engine(tiers=('vectors',), max_delay_ms=0.0,
                                  warmup=False)
    try:
        same = _copy(model.backend.params)
        with pytest.raises(RuntimeError, match='vectors-only'):
            engine.load_params(same, canary_batches=2)
        report = engine.load_params(same, canary_batches=0).result(10)
        assert report['swapped'] is True
    finally:
        engine.close()


def test_rollover_api_guards(model):
    engine = model.serving_engine(tiers=('topk',), max_delay_ms=0.0,
                                  warmup=False)
    same = _copy(model.backend.params)
    assert engine._param_source is None   # neither a load nor a save path
    with pytest.raises(RuntimeError, match='param source'):
        engine.load_params(7)
    with pytest.raises(RuntimeError, match='param source'):
        engine.follow_checkpoints(poll_secs=1.0)
    armed = engine.load_params(same, canary_batches=5)
    with pytest.raises(RuntimeError, match='already in flight'):
        engine.load_params(same, canary_batches=5)
    with pytest.raises(RuntimeError, match='already in flight'):
        engine.adopt_params(same)
    engine.close()
    assert isinstance(armed.exception(timeout=10), EngineClosed)
    with pytest.raises(EngineClosed):
        engine.load_params(same, canary_batches=0)


def test_adopt_params_swaps_without_canary(model):
    with model.serving_engine(tiers=('topk',), max_delay_ms=0.0) as engine:
        before = engine.predict(PREDICT_LINES, tier='topk', timeout=60)
        engine.adopt_params(_copy(model.backend.params), step=4)
        stats = engine.stats()
        assert stats['serving_slot'] == 1 and stats['params_step'] == 4
        _same_results(before, engine.predict(PREDICT_LINES, tier='topk',
                                             timeout=60))


def test_param_source_step_rollover_and_follow(tmp_path_factory):
    model = _saving_model(tmp_path_factory, 'rollsrc')
    engine = model.serving_engine(tiers=('topk',), max_delay_ms=0.0)
    try:
        source = engine._param_source
        assert source is not None and engine.param_slots == 2
        assert source.newest_step() == 0
        report = engine.load_params(0).result(timeout=60)
        assert report['swapped'] is True and report['step'] == 0
        assert engine.stats()['params_step'] == 0
        with pytest.raises(ValueError, match='step 7'):
            engine.load_params(7).result(timeout=60)
        _save_step(model, 9)
        assert source.newest_step() == 9
        engine.follow_checkpoints(poll_secs=0.05)
        _wait_until(lambda: engine.stats()['params_step'] == 9,
                    timeout=30.0, what='follow-checkpoints rollover')
        assert engine.stats()['graph_captures_after_warmup'] == 0
    finally:
        engine.close()


def test_follow_single_poller_and_transient_load_retry(tmp_path_factory):
    model = _saving_model(tmp_path_factory, 'followretry')
    engine = model.serving_engine(tiers=('topk',), max_delay_ms=0.0)
    try:
        source = engine._param_source
        real_load = source.load
        blips = {'left': 2}

        def flaky_load(ref):
            if blips['left'] > 0:
                blips['left'] -= 1
                raise IOError('transient restore blip')
            return real_load(ref)

        source.load = flaky_load
        _save_step(model, 9)
        barrier = threading.Barrier(8)

        def race():
            barrier.wait()
            engine.follow_checkpoints(poll_secs=0.05)

        workers = [threading.Thread(target=race) for _ in range(8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        pollers = [t for t in threading.enumerate()
                   if t.name == 'serving-follow' and t.is_alive()]
        assert len(pollers) == 1, 'duplicate follow pollers: %r' % pollers
        _wait_until(lambda: engine.stats()['params_step'] == 9,
                    timeout=30.0, what='retry after transient load blip')
        assert blips['left'] == 0
    finally:
        engine.close()
    assert not any(t.name == 'serving-follow' and t.is_alive()
                   for t in threading.enumerate())
    with pytest.raises(EngineClosed):
        engine.follow_checkpoints(poll_secs=1.0)


def test_canary_timeout_rolls_back_on_vectors_only_traffic(model):
    engine = model.serving_engine(tiers=('vectors', 'topk'),
                                  max_delay_ms=0.0, warmup=False)
    try:
        same = _copy(model.backend.params)
        handle = engine.load_params(same, canary_batches=2)
        engine.canary_timeout_s = 0.05
        time.sleep(0.1)
        # vectors dispatches shadow-score nothing, but check the age
        engine.predict(PREDICT_LINES, tier='vectors', timeout=60)
        report = handle.result(timeout=10)
        assert report['swapped'] is False
        assert 'timed out' in report['reason']
        assert engine.rollover_rollbacks_total.value == 1
        assert engine.load_params(
            same, canary_batches=0).result(10)['swapped'] is True
    finally:
        engine.close()


def test_follow_baseline_skips_already_serving_step(tmp_path_factory):
    model = _saving_model(tmp_path_factory, 'followbase')
    engine = model.serving_engine(tiers=('topk',), max_delay_ms=0.0)
    try:
        assert engine.stats()['params_step'] == 0  # wired baseline
        engine.follow_checkpoints(poll_secs=0.05)
        time.sleep(0.5)  # several polls over the already-serving step
        assert engine.rollover_total.value == 0, \
            'first poll re-rolled the already-serving step'
        _save_step(model, 3)
        _wait_until(lambda: engine.stats()['params_step'] == 3,
                    timeout=30.0, what='follow rollover of newer step')
        assert engine.rollover_total.value == 1
    finally:
        engine.close()


def test_follow_checkpoints_flag_starts_the_poller(tmp_path_factory):
    model = _saving_model(tmp_path_factory, 'followflag')
    model.config.SERVE_FOLLOW_CHECKPOINTS_SECS = 0.05
    engine = model.serving_engine(tiers=('topk',), max_delay_ms=0.0)
    try:
        assert engine._follow_thread is not None
        _save_step(model, 5)
        _wait_until(lambda: engine.stats()['params_step'] == 5,
                    timeout=30.0, what='flag-started follow rollover')
    finally:
        engine.close()


def test_slot_made_during_warmup_is_captured(model):
    """C18: a one-slot engine's rollover makes its second parameter slot
    while ``warmup()`` is capturing the slots it planned before that slot
    existed; the new slot's graphs must still be captured (else the swap
    or its canary finds no graph for the slot). Warm-up is held inside
    its ladder capture while the rollover fills the idle slot."""
    engine = model.serving_engine(tiers=('topk',), warmup=False,
                                  max_delay_ms=0.0)
    try:
        assert len(engine.ladder.slots) == 1 and engine.ladder.warm_slots == 0
        entered, release = threading.Event(), threading.Event()
        real_warm = engine.ladder.warm

        def held_warm(n_slots):
            entered.set()
            assert release.wait(10)
            return real_warm(n_slots)

        engine.ladder.warm = held_warm
        warming = threading.Thread(target=engine.warmup)
        warming.start()
        assert entered.wait(10)
        filling = threading.Thread(target=engine._fill_idle_slot,
                                   args=(model.backend.params,))
        filling.start()
        filling.join(1.0)
        release.set()
        warming.join(10)
        filling.join(10)
        assert not warming.is_alive() and not filling.is_alive()
        assert len(engine.ladder.slots) == 2
        assert engine.ladder.warm_slots == 2
    finally:
        engine.close()
