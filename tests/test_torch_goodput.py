"""The port's goodput plane (code2vec_tpu_torch/telemetry/goodput.py,
stepcost.py) against the JAX package's (code2vec_tpu/telemetry/
goodput.py, ``Trainer.train_program_cost``) on the CPU:

- one event sequence under a fake clock into both ``GoodputLedger``s
  writes equal ``intervals.jsonl`` records (apart from the ``wall``
  timestamps) and equal snapshots, window harvests and gauges;
- the anomaly watchdog fires at the same samples with the same records;
- ``resolve_peak_flops``: the reference's order (config, environment,
  table, default) and rows, plus the H100 rows by
  ``torch.cuda.get_device_name()``, the longer prefix first; ``mfu``;
- the step cost on the plane wire against XLA's count of the JAX train
  step (``train_program_cost``, Pallas flags off, fp32) at widths where
  the products dominate, within 3% (the port counts the elementwise
  passes by rule; XLA's cost analysis of the unoptimized module counts
  converts and broadcasts the rule leaves out: 0.6-0.7% on these shapes);
- the step cost of the ragged route against a count by hand;
- a CPU ``train()`` with a rewind: the report reconstructs the run, the
  rewind and its replay attributed, within 2% unattributed.
"""
import json
import math
import os
import pathlib
import sys

import numpy as np
import pytest

from code2vec_tpu.telemetry import core as jax_core
from code2vec_tpu.telemetry import goodput as jax_goodput
from code2vec_tpu_torch.telemetry import core, goodput, stepcost
from code2vec_tpu_torch.telemetry import memory as memory_lib
from tests.test_train_overfit import make_dataset

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def fresh_registries():
    for module in (core, jax_core):
        module.reset()
        module.enable()
    goodput.deactivate()
    jax_goodput.deactivate()
    yield
    for module in (core, jax_core):
        module.reset()
        module.disable()
    goodput.deactivate()
    jax_goodput.deactivate()
    memory_lib.reset()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, seconds):
        self.t += seconds


def _drive(module, path):
    """One event sequence: warm-up, compiles, waits, typed intervals
    (nested and across a harvest), a rewind's replay, costs per shape,
    an anomaly record, a preempt run end."""
    clock = FakeClock()
    ledger = module.GoodputLedger(str(path), clock=clock)
    ledger.run_start(0)
    ledger.set_step_cost('packed:64', 1e9, 2e8)
    windows = []
    for step in range(1, 13):
        ledger.note_input_wait(0.002 if step % 3 else 0.050)
        clock.advance(0.010)
        if step == 1:
            ledger.on_compile(0.5)
        if step == 5:
            with ledger.interval(module.KIND_EVAL):
                clock.advance(0.2)
                with ledger.interval(module.KIND_CHECKPOINT):
                    clock.advance(0.1)
        if step == 7:
            with ledger.interval(module.KIND_REWIND):
                clock.advance(0.3)
            ledger.mark_replay(2)
        if step == 8:
            ledger.set_step_cost('packed:128', 3e9, 5e8)
        shape = 'packed:128' if step >= 8 else 'packed:64'
        ledger.step_done(step, 0.010 + (0.55 if step == 1 else 0.0), shape)
        if step % 4 == 0:
            windows.append(ledger.harvest_window())
            ledger.write_window(step, windows[-1], 0.05, 0.25)
    with ledger.interval(module.KIND_CHECKPOINT):
        clock.advance(0.05)
        windows.append(ledger.harvest_window())
    ledger.note_anomaly({'step': 9, 'shape': 'packed:128', 'step_ms': 12.0})
    ledger.note_productive(0.02)
    ledger.run_end(12, reason='preempt')
    ledger.run_end(12)                  # idempotent per span
    return ledger, windows


def _records(path):
    out = []
    for line in open(path):
        record = json.loads(line)
        record.pop('wall')
        out.append(record)
    return out


def test_ledger_writes_the_reference_records(tmp_path):
    port, port_windows = _drive(goodput, tmp_path / 'port.jsonl')
    ref, ref_windows = _drive(jax_goodput, tmp_path / 'ref.jsonl')
    assert _records(tmp_path / 'port.jsonl') == \
        _records(tmp_path / 'ref.jsonl')
    assert port.snapshot() == ref.snapshot()
    assert port_windows == ref_windows
    assert port.current_cost() == ref.current_cost()
    assert port.arithmetic_intensity() == ref.arithmetic_intensity()
    assert port.rate_excluded_total() == ref.rate_excluded_total()
    port.export_gauges()
    ref.export_gauges()
    assert core.registry().snapshot() == jax_core.registry().snapshot()


def test_module_interval_marks_are_noops_when_inactive():
    with goodput.interval(goodput.KIND_EVAL):
        pass
    goodput.on_compile(1.0)
    assert goodput.active() is None
    ledger = goodput.GoodputLedger()
    goodput.activate(ledger)
    with goodput.interval(goodput.KIND_EVAL):
        pass
    goodput.deactivate(goodput.GoodputLedger())     # another: kept
    assert goodput.active() is ledger
    goodput.deactivate(ledger)
    assert goodput.active() is None


@pytest.mark.parametrize('samples', [
    [10.0] * 20 + [50.0] * 4 + [10.0] * 3 + [60.0] * 3,
    [10.0, 10.5, 9.5] * 8 + [30.0, 10.0, 30.0, 30.0, 30.0],
])
def test_anomaly_watchdog_fires_as_the_reference(samples, tmp_path):
    fired = {}
    for name, module in (('port', goodput), ('ref', jax_goodput)):
        clock = FakeClock()
        captures, records = [], []
        watchdog = module.StepAnomalyWatchdog(
            6.0, 100.0, dump_dir=str(tmp_path / name),
            on_capture=captures.append, on_record=records.append,
            clock=clock)
        steps = [step for step, ms in enumerate(samples)
                 if watchdog.observe('packed:64', ms / 1e3, step)]
        fired[name] = (steps, captures, records)
    assert fired['port'] == fired['ref']
    assert fired['port'][0]
    assert core.registry().snapshot() == jax_core.registry().snapshot()
    dump = [json.loads(l) for l in
            open(tmp_path / 'port' / 'flight_step_anomaly.jsonl')]
    assert dump[0]['kind'] == 'anomaly'


@pytest.mark.parametrize('kind', [
    'TPU v4', 'TPU v5 lite', 'TPU v5e', 'TPU v6e', 'cpu', None, 'Unknown'])
def test_peak_resolution_equals_reference_on_its_rows(kind, monkeypatch):
    monkeypatch.delenv('DEVICE_PEAK_FLOPS', raising=False)
    assert goodput.resolve_peak_flops(-1.0, kind) == \
        jax_goodput.resolve_peak_flops(-1.0, kind)
    assert goodput.resolve_peak_flops(7e12, kind) == 7e12
    monkeypatch.setenv('DEVICE_PEAK_FLOPS', '3e12')
    assert goodput.resolve_peak_flops(-1.0, kind) == \
        jax_goodput.resolve_peak_flops(-1.0, kind) == 3e12
    monkeypatch.setenv('DEVICE_PEAK_FLOPS', 'nonsense')
    assert goodput.resolve_peak_flops(-1.0, kind) == \
        jax_goodput.resolve_peak_flops(-1.0, kind)


@pytest.mark.parametrize('name, peak', [
    ('NVIDIA H100 80GB HBM3', 989e12),      # SXM
    ('NVIDIA H100', 989e12),
    ('NVIDIA H100 PCIe', 756e12),
    ('nvidia h100 pcie', 756e12),
    ('NVIDIA A100-SXM4-80GB', goodput.DEFAULT_PEAK_FLOPS),
])
def test_peak_resolution_h100_rows(name, peak, monkeypatch):
    monkeypatch.delenv('DEVICE_PEAK_FLOPS', raising=False)
    assert goodput.resolve_peak_flops(-1.0, name) == peak


def test_mfu_equals_reference():
    for args in ((1e12, 2.0, 989e12, 1), (6.5e11, 0.008, 989e12, 1),
                 (1.0, 0.0, 0.0, 0)):
        assert goodput.mfu(*args) == jax_goodput.mfu(*args)
    # the java14m step of the chip check: ~0.65 TFLOP in 8 ms
    assert 0.05 < goodput.mfu(6.5e11, 0.008, 989e12) < 0.1


# ------------------------------------------------------------ step cost
def _jax_plane_cost(b, c, dt, dp, d, tv, pv, v):
    from code2vec_tpu.config import Config
    from code2vec_tpu.models.backends import create_backend
    from code2vec_tpu.parallel import mesh as mesh_lib
    from code2vec_tpu.training.trainer import Trainer as JaxTrainer
    from code2vec_tpu.vocab import SizeOnlyVocabs
    from tests.test_packed import random_plane_batch
    config = Config(
        TRAIN_DATA_PATH_PREFIX='unused', DL_FRAMEWORK='jax', VERBOSE_MODE=0,
        READER_USE_NATIVE=False, MAX_CONTEXTS=c, TRAIN_BATCH_SIZE=b,
        TEST_BATCH_SIZE=b, MAX_TOKEN_VOCAB_SIZE=tv, MAX_PATH_VOCAB_SIZE=pv,
        MAX_TARGET_VOCAB_SIZE=v, TOKEN_EMBEDDINGS_SIZE=dt,
        PATH_EMBEDDINGS_SIZE=dp, CODE_VECTOR_SIZE=d,
        TARGET_EMBEDDINGS_SIZE=d, DROPOUT_KEEP_RATE=1.0,
        COMPUTE_DTYPE='float32', BATCH_WIRE_FORMAT='planes',
        ADAM_MU_DTYPE='float32', ADAM_NU_DTYPE='float32',
        USE_PALLAS_FUSED_CE=False, USE_PALLAS_RAGGED_FUSION=False,
        USE_PALLAS_FUSED_ENCODE=False)
    trainer = JaxTrainer(config, create_backend(
        config, SizeOnlyVocabs(tv, pv, v)))
    state = trainer.init_state()
    batch = random_plane_batch(np.random.default_rng(0), b, c)
    batch = batch._replace(label=(batch.label % 10).astype(np.int32))
    arrays = mesh_lib.shard_batch(batch.device_arrays(), trainer.mesh,
                                  config.SHARD_CONTEXTS)
    return trainer.train_program_cost(state, arrays), batch


def _port_trainer(c, dt, dp, d, tv, pv, v, **knobs):
    from types import SimpleNamespace

    import torch

    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.backends import TorchBackend
    from code2vec_tpu_torch.training.trainer import Trainer

    def vocab(size):
        return SimpleNamespace(size=size, pad_index=0)
    config = Config(**dict(dict(
        TRAIN_DATA_PATH_PREFIX='unused', MAX_CONTEXTS=c,
        TOKEN_EMBEDDINGS_SIZE=dt, PATH_EMBEDDINGS_SIZE=dp,
        CODE_VECTOR_SIZE=d, DROPOUT_KEEP_RATE=1.0, COMPUTE_DTYPE='float32',
        ADAM_MU_DTYPE='float32', ADAM_NU_DTYPE='float32'), **knobs))
    vocabs = SimpleNamespace(token_vocab=vocab(tv), path_vocab=vocab(pv),
                             target_vocab=vocab(v))
    return Trainer(config, TorchBackend(config, vocabs,
                                        torch.device('cpu')))


STEP_COST_TOLERANCE = 0.03


@pytest.mark.parametrize('shape', [
    (32, 16, 32, 32, 96, 256, 128, 512),
    (64, 16, 32, 32, 96, 256, 128, 512),
    (32, 16, 32, 32, 192, 256, 128, 1024),
])
def test_plane_step_cost_matches_xla(shape):
    b, c, dt, dp, d, tv, pv, v = shape
    want, batch = _jax_plane_cost(*shape)
    trainer = _port_trainer(c, dt, dp, d, tv, pv, v,
                            BATCH_WIRE_FORMAT='planes')
    flops, nbytes = trainer.step_cost(batch.device_arrays())
    assert abs(flops / want['flops'] - 1) < STEP_COST_TOLERANCE, \
        (flops, want['flops'])
    assert nbytes > 0
    # the products are most of it at these widths
    d0 = 2 * dt + dp
    products = 3 * 2 * b * c * d0 * d + 3 * 2 * b * d * v
    assert products / flops > 0.9


def test_ragged_step_cost_by_hand():
    """The packed ragged route: the encode over the packed capacity, the
    CE over the valid rows under the streamed kernels, Adam over every
    parameter; counted by hand from the shapes."""
    import torch
    trainer = _port_trainer(200, 32, 16, 48, 1000, 300, 700,
                            USE_PALLAS_FUSED_CE=True,
                            ADAM_MU_DTYPE='bfloat16')
    sizes = trainer.backend.sizes
    ctx = torch.zeros((1, 2560, 3), dtype=torch.int32)
    count = torch.zeros((64,), dtype=torch.int32)
    arrays = (ctx, count, count, count.float())
    flops, nbytes = trainer.step_cost(arrays)
    s, b, d0, d, v = 2560, 64, 80, 48, 700
    params = (sizes['token_vocab_size'] * 32 + sizes['path_vocab_size'] * 16
              + sizes['target_vocab_size'] * 48 + 80 * 48 + 48)
    assert params == sum(t.numel() for t in trainer.backend.params)
    want = (6 * s * d0 * d + 8 * s * d + 2 * s * d0 + 3 * s * d + 9 * s
            + 6 * b * d * v + 6 * b * v + 14 * params)
    assert flops == float(want)
    # Adam: fp32 params read+written, bf16 mu + fp32 nu read+written,
    # fp32 gradients written+read; contexts (fp32 compute here, the
    # int32 triples) and the target table read twice
    want_bytes = (params * (8 + 2 * 6 + 8) + 2 * s * (d0 * 4 + 12)
                  + 2 * v * d * 4)
    assert nbytes == float(want_bytes)


def test_java14m_step_cost():
    """At java14m width (B 1024, ~40K packed slots, the fused CE over
    261,245 valid rows, 384M parameters): about 0.65 TFLOP, nearly all
    the CE's products."""
    shape = stepcost.StepShape(
        batch=1024, slots=40960, token_dim=128, path_dim=128, code_dim=384,
        vocab_rows=261245, params=384_000_000, materialized_logits=False)
    flops = stepcost.train_step_flops(shape)
    assert 6.4e11 < flops < 6.7e11
    assert 6 * 1024 * 384 * 261245 / flops > 0.9


def test_step_shape_by_route():
    import torch

    from code2vec_tpu_torch.config import Config
    sizes = dict(token_dim=8, path_dim=8, code_dim=24,
                 target_vocab_size=128)
    packed = (torch.zeros((1, 256, 3)), torch.zeros((16,)),
              torch.zeros((16,)), torch.zeros((16,)))
    planes = (torch.zeros((16, 6)),) * 4 + (torch.zeros((16,)),) * 2
    ragged = stepcost.step_shape(Config(MAX_CONTEXTS=6), sizes, 100,
                                 packed, 1000)
    unpack = stepcost.step_shape(
        Config(MAX_CONTEXTS=6, USE_PALLAS_RAGGED_FUSION=False), sizes, 100,
        packed, 1000)
    dense = stepcost.step_shape(Config(MAX_CONTEXTS=6,
                                       USE_PALLAS_FUSED_CE=True),
                                sizes, 100, planes, 1000)
    assert (ragged.slots, ragged.vocab_rows, ragged.materialized_logits) \
        == (256, 128, True)
    assert (unpack.slots, unpack.batch) == (96, 16)
    assert (dense.slots, dense.vocab_rows, dense.materialized_logits) \
        == (96, 100, False)


# ------------------------------------------------------------ acceptance
def test_rewind_run_reconstructs(tmp_path, capsys):
    """A CPU fit with evaluations, step snapshots and one injected
    divergence: the report's buckets sum to wall within 2% unattributed,
    the rewind and its replay attributed, a finite MFU in every window,
    no compile after the first steps."""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    prefix = make_dataset(tmp_path, n_train=128)
    tele = tmp_path / 'tele'
    config = Config(
        TRAIN_DATA_PATH_PREFIX=str(prefix),
        TEST_DATA_PATH=str(prefix) + '.val.c2v',
        MODEL_SAVE_PATH=str(tmp_path / 'models' / 'saved_model'),
        NUM_TRAIN_EPOCHS=6, TRAIN_BATCH_SIZE=16, TEST_BATCH_SIZE=16,
        MAX_CONTEXTS=6, LEARNING_RATE=0.01, SAVE_EVERY_N_STEPS=2,
        NUM_BATCHES_TO_LOG_PROGRESS=2, TELEMETRY=True,
        TELEMETRY_DIR=str(tele),
        FAULT_INJECT='nan_loss@step=5', VERBOSE_MODE=0)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        Code2VecModel(config, device='cpu').train()
    finally:
        os.chdir(cwd)
    scripts = str(REPO / 'scripts')
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import goodput_report
    spans = goodput_report.split_spans(goodput_report.load_records(
        str(tele / 'intervals.jsonl')))
    assert len(spans) == 1
    summary = goodput_report.summarize(spans)
    assert summary['badput_s']['unattributed'] / summary['wall_s'] < 0.02
    assert summary['badput_s']['rewind'] > 0
    assert summary['badput_s']['rewind_replay'] > 0
    assert summary['badput_s']['checkpoint'] > 0
    assert 0 < summary['goodput_fraction'] < 1
    windows = [json.loads(l) for l in open(tele / 'intervals.jsonl')]
    mfus = [w['mfu'] for w in windows
            if w['kind'] == 'window' and w['steps']]
    assert mfus and all(math.isfinite(m) and m > 0 for m in mfus)
    tags = {}
    for line in open(tele / 'metrics.jsonl'):
        record = json.loads(line)
        tags.setdefault(record['tag'], []).append(record['value'])
    assert tags['resilience/rewinds_total'][-1] == 1
    assert tags['resilience/faults_fired_total'][-1] == 1
    dump = json.loads(open(next(tele.glob('divergence_step*.json'))).read())
    assert 'train/steps_total' in dump['telemetry']
