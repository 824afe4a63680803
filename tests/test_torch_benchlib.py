"""The port's benchmark harness (``code2vec_tpu_torch/benchlib.py``)
against the reference's (``code2vec_tpu/benchlib.py``) on the CPU, at
SMOKE_SHAPES:

- ``random_batches`` bit for bit, at fills 1.0 and 0.25 and two seeds;
- ``wire_bytes`` of a plane batch and of the same batch packed by each
  package;
- the headline config's shared fields, ``bench_steps``, and
  ``pack_batches``' single capacity;
- one ``train_step`` of ``build_trainer`` (fp32, keep 1.0) against the
  reference's, the reference's initial weights carried across
  (``convert.params_from_numpy``): loss and updated parameters at rtol
  2e-5 / atol 1e-6 (Adam's first step moves each weight by about lr);
- ``build_eval_trainer`` holds no optimizer state; on the CPU
  ``kernels_engaged`` counts no launch and ``device_memory_record`` is
  the explicit None pair.
"""
import numpy as np
import pytest

from code2vec_tpu import benchlib as jax_benchlib
from code2vec_tpu.data import packed as jax_packed
from code2vec_tpu_torch import benchlib, convert
from code2vec_tpu_torch.data import packed as port_packed
from code2vec_tpu_torch.models.functional import Code2VecParams
from code2vec_tpu_torch.telemetry import memory as memory_lib

SMOKE = benchlib.SMOKE_SHAPES


def test_constants_equal_reference():
    assert benchlib.SMOKE_SHAPES == tuple(jax_benchlib.SMOKE_SHAPES)
    assert benchlib.JAVA14M == tuple(jax_benchlib.JAVA14M)
    assert benchlib.BenchShapes._fields == jax_benchlib.BenchShapes._fields
    assert benchlib.JAVA14M_FILL == jax_benchlib.JAVA14M_FILL
    assert (benchlib.V100_BASELINE_EXAMPLES_PER_SEC
            == jax_benchlib.V100_BASELINE_EXAMPLES_PER_SEC)
    for smoke in (False, True):
        assert benchlib.bench_steps(smoke) == jax_benchlib.bench_steps(smoke)


def test_smoke_requested_reads_the_same_variable(monkeypatch):
    for value, want in (('', False), ('0', False), ('false', False),
                        ('1', True)):
        monkeypatch.setenv('BENCH_SMOKE', value)
        assert benchlib.smoke_requested() is want
        assert jax_benchlib.smoke_requested() is want


@pytest.mark.parametrize('fill', [1.0, 0.25])
@pytest.mark.parametrize('seed', [0, 7])
def test_random_batches_bit_for_bit(seed, fill):
    got = benchlib.random_batches(SMOKE, 3, seed=seed, fill=fill)
    want = jax_benchlib.random_batches(jax_benchlib.SMOKE_SHAPES, 3,
                                       seed=seed, fill=fill)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g.device_arrays(), w.device_arrays()):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    if fill < 1.0:
        assert got[0].mask.mean() < 0.5


def test_wire_bytes_equal_reference():
    batch = benchlib.random_batches(SMOKE, 1, seed=3,
                                    fill=benchlib.JAVA14M_FILL)[0]
    jax_batch = jax_benchlib.random_batches(
        jax_benchlib.SMOKE_SHAPES, 1, seed=3,
        fill=jax_benchlib.JAVA14M_FILL)[0]
    assert benchlib.wire_bytes(batch) == jax_benchlib.wire_bytes(jax_batch)
    port_pack = port_packed.pack_batch(batch, 0, 0, data_shards=2)
    jax_pack = jax_packed.pack_batch(jax_batch, 0, 0, data_shards=2)
    want = jax_benchlib.wire_bytes(jax_pack)
    assert benchlib.wire_bytes(port_pack) == want
    assert port_packed.wire_bytes(jax_pack) == want
    # the packed wire ships less than the planes at the java14m fill
    assert want < benchlib.wire_bytes(batch)


def test_headline_config_shared_fields_equal_reference():
    port = benchlib.headline_config(benchlib.JAVA14M, device='cpu',
                                    DROPOUT_KEEP_RATE=0.5)
    ref = jax_benchlib.headline_config(jax_benchlib.JAVA14M,
                                       DROPOUT_KEEP_RATE=0.5)
    assert port.DEVICE == 'cpu'
    assert not hasattr(port, 'DL_FRAMEWORK')
    assert not hasattr(port, 'DONATE_STAGED_BATCHES')
    shared = [name for name in vars(ref) if not name.startswith('_')
              and hasattr(port, name)]
    assert len(shared) > 50
    for name in ('TRAIN_DATA_PATH_PREFIX', 'COMPUTE_DTYPE', 'VERBOSE_MODE',
                 'READER_USE_NATIVE', 'TRAIN_BATCH_SIZE', 'TEST_BATCH_SIZE',
                 'MAX_CONTEXTS', 'MAX_TOKEN_VOCAB_SIZE',
                 'MAX_PATH_VOCAB_SIZE', 'MAX_TARGET_VOCAB_SIZE',
                 'DROPOUT_KEEP_RATE'):
        assert name in shared, name
    for name in shared:
        assert getattr(port, name) == getattr(ref, name), name


def fp32_configs():
    """The port's and the reference's fp32 keep-1.0 configs with fp32
    moments; the reference on one device (``MESH_DEVICE_INDICES='0'``),
    one data shard as the port's one rank."""
    knobs = dict(COMPUTE_DTYPE='float32', ADAM_MU_DTYPE='float32',
                 ADAM_NU_DTYPE='float32', DROPOUT_KEEP_RATE=1.0)
    return (benchlib.headline_config(SMOKE, device='cpu', **knobs),
            jax_benchlib.headline_config(jax_benchlib.SMOKE_SHAPES,
                                         MESH_DEVICE_INDICES='0', **knobs))


def test_pack_batches_one_capacity_as_reference():
    port_config, jax_config = fp32_configs()
    trainer, _state = benchlib.build_trainer(port_config, SMOKE,
                                             device='cpu')
    jax_trainer = jax_benchlib._make_trainer(jax_config,
                                             jax_benchlib.SMOKE_SHAPES)
    batches = benchlib.random_batches(SMOKE, 4, seed=1, fill=0.6)
    jax_batches = jax_benchlib.random_batches(jax_benchlib.SMOKE_SHAPES, 4,
                                              seed=1, fill=0.6)
    got = benchlib.pack_batches(batches, trainer)
    want = jax_benchlib.pack_batches(jax_batches, jax_trainer)
    assert len({p.ctx.shape[1] for p in got}) == 1
    for g, w in zip(got, want):
        for a, b in zip(g.device_arrays(), w.device_arrays()):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_train_step_matches_reference():
    """Adam's first step moves a weight by ``lr * g / (|g| + eps)``: where
    ``|g|`` is near eps (1e-8) that quotient turns a gradient's last-digit
    difference into up to ~1e-5 of the weight. So the gradients (the
    first moments, ``(1 - b1) g``) are held at rtol 2e-5 / atol 1e-5 of
    their scale, the parameters at rtol 2e-5 / atol 1e-6 wherever ``|g|``
    is at least 10 eps, and every parameter's move equals Adam's step
    on the port's own gradient to within fp32 rounding (atol 2e-8).
    Rows no context touched have a zero gradient and do not move."""
    port_config, jax_config = fp32_configs()
    jax_trainer, jax_state = jax_benchlib.build_trainer(
        jax_config, jax_benchlib.SMOKE_SHAPES)
    weights = {k: np.asarray(v, np.float32)
               for k, v in jax_state.params._asdict().items()}
    jax_batch = jax_benchlib.pack_batches(
        jax_benchlib.random_batches(jax_benchlib.SMOKE_SHAPES, 1, seed=5),
        jax_trainer)[0]
    new_state, loss = jax_trainer.train_step(jax_state, jax_batch)
    want = {k: np.asarray(v, np.float32)
            for k, v in new_state.params._asdict().items()}
    want_mu = new_state.opt_state[0].mu

    trainer, state = benchlib.build_trainer(port_config, SMOKE,
                                            device='cpu')
    state = trainer.state_from_params(convert.params_from_numpy(
        {k: v.copy() for k, v in weights.items()}))
    batch = benchlib.pack_batches(
        benchlib.random_batches(SMOKE, 1, seed=5), trainer)[0]
    (arrays,) = benchlib.staged(trainer, [batch])
    state, port_loss = trainer.train_step_placed(state, arrays)
    np.testing.assert_allclose(float(port_loss), float(loss), rtol=2e-5)
    got = convert.params_to_numpy(state.params)
    got_mu = convert.opt_state_to_numpy(state.opt_state)['mu']
    lr, b1, eps = port_config.LEARNING_RATE, 0.9, 1e-8
    conditioned = moved = 0
    for name in Code2VecParams._fields:
        ref_mu = np.asarray(getattr(want_mu, name), np.float32)
        scale = float(np.abs(ref_mu).max())
        np.testing.assert_allclose(got_mu[name], ref_mu, rtol=2e-5,
                                   atol=1e-5 * scale, err_msg='mu ' + name)
        ok = np.abs(ref_mu / (1 - b1)) >= 10 * eps
        conditioned += int(ok.sum())
        moved += int((ref_mu != 0).sum())
        np.testing.assert_allclose(got[name][ok], want[name][ok],
                                   rtol=2e-5, atol=1e-6, err_msg=name)
        g = got_mu[name].astype(np.float64) / (1 - b1)
        np.testing.assert_allclose(
            got[name] - weights[name], -lr * g / (np.abs(g) + eps),
            rtol=0, atol=2e-8, err_msg='Adam step of ' + name)
    # all but a few of the weights a gradient reaches
    assert conditioned > 0.99 * moved, (conditioned, moved)


def test_build_trainer_draws_from_its_seed():
    config, _ = fp32_configs()
    _t, a = benchlib.build_trainer(config, SMOKE, device='cpu', seed=3)
    _t, b = benchlib.build_trainer(config, SMOKE, device='cpu', seed=3)
    _t, c = benchlib.build_trainer(config, SMOKE, device='cpu', seed=4)
    assert a.step == 0 and a.opt_state is not None
    assert bool((a.params.token_embedding == b.params.token_embedding).all())
    assert not bool((a.params.token_embedding
                     == c.params.token_embedding).all())


def test_build_eval_trainer_holds_no_optimizer_state():
    config, _ = fp32_configs()
    led = memory_lib.ledger()
    led.reset()
    try:
        trainer, params = benchlib.build_eval_trainer(config, SMOKE,
                                                      device='cpu', seed=3)
        assert isinstance(params, Code2VecParams)
        assert led.bucket_bytes('opt_state') == 0
        assert led.bucket_bytes('params') == sum(
            p.numel() * p.element_size() for p in params)
        # the eval step needs no state
        batch = benchlib.random_batches(SMOKE, 1, seed=2)[0]
        out = trainer.eval_step(benchlib.pack_batches([batch], trainer)[0])
        assert out['topk_indices'].shape[0] == SMOKE.batch_size
        # a training build registers its moments
        trainer2, _state = benchlib.build_trainer(config, SMOKE,
                                                  device='cpu')
        assert led.bucket_bytes('opt_state') > 0
        del trainer2, _state
    finally:
        led.reset()


def test_cpu_reports_no_launch_and_no_device_memory():
    config, _ = fp32_configs()
    trainer, state = benchlib.build_trainer(config, SMOKE, device='cpu')
    batch = benchlib.pack_batches(benchlib.random_batches(SMOKE, 1),
                                  trainer)[0]
    counts = benchlib.kernels_engaged(trainer.train_step, state, batch)
    assert set(counts) == {'ragged_fwd', 'ragged_bwd', 'ce_fwd', 'ce_bwd',
                           'encode', 'adam_update', 'adam_rows'}
    assert not any(counts.values()), counts
    assert benchlib.device_memory_record() == {'peak_hbm_bytes': None,
                                               'hbm_bytes_in_use': None}


def test_timers_record_unregistered():
    from code2vec_tpu_torch.telemetry import core
    sw = benchlib.bench_timer('bench_test_timer')
    with sw.time():
        sum(range(1000))
    assert sw.count == 1 and sw.last > 0
    assert benchlib.bench_timer_wall(lambda: None) >= 0
    assert 'bench_test_timer' not in core.registry().snapshot()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        benchlib.bench_cuda_ms(lambda: None)
