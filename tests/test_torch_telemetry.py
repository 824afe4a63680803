"""The port's telemetry core (code2vec_tpu_torch/telemetry/core.py,
catalog.py, exporters.py, jit_tracker.py, the CLI flags) against the JAX
package's on the CPU, and a CPU ``train()`` with telemetry on:

- the registry: one sequence of records (counters, gauges, timers,
  replica-labeled series) into both packages' registries gives equal
  snapshots — the port's timer snapshot carries one key more, ``p99_ms``
  (its documented addition), and nothing else differs;
- the exporters: equal ``metrics.jsonl`` records apart from ``time`` and
  that key, equal ``metrics.prom`` sample and TYPE lines (and HELP lines
  wherever the port kept the reference's help text), the same console
  line;
- the catalog: every name in the port's exists in the reference's with
  the same type and unit, and an AST scan of code2vec_tpu_torch/ finds
  no emitted name outside the port's catalog;
- compile accounting: ``note_compile`` and the capacity tracker count as
  the reference's listener and tracker do;
- the CLI: the telemetry flags fill the same Config fields as the JAX
  CLI for the same argv, and the environment fill-ins agree;
- artifacts: ``train()`` with ``--telemetry --trace-at-step 2`` leaves
  metrics.jsonl, metrics.prom, intervals.jsonl and traces/step2/ (a
  Chrome trace with the host scopes), and ``scripts/goodput_report.py
  --json`` and ``scripts/memory_report.py`` read them; with telemetry
  off nothing is written and no instrument exists.

Every comparison here is exact (equality of records and lines); the
numbers in them come from the same inputs.
"""
import ast
import json
import os
import pathlib
import sys

import pytest

from code2vec_tpu.telemetry import catalog as jax_catalog
from code2vec_tpu.telemetry import core as jax_core
from code2vec_tpu.telemetry import exporters as jax_exporters
from code2vec_tpu.telemetry import jit_tracker as jax_jit
from code2vec_tpu_torch.telemetry import catalog, core, exporters, goodput
from code2vec_tpu_torch.telemetry import jit_tracker
from code2vec_tpu_torch.telemetry import memory as memory_lib
from tests.test_train_overfit import make_dataset

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_ONLY_TIMER_KEYS = ('p99_ms',)


@pytest.fixture(autouse=True)
def fresh_registries():
    """Both packages' registries and enable flags are process-global:
    every test starts and ends with them empty and off."""
    for module in (core, jax_core):
        module.reset()
        module.disable()
    goodput.deactivate()
    memory_lib.reset()
    yield
    for module in (core, jax_core):
        module.reset()
        module.disable()
    goodput.deactivate()
    memory_lib.reset()


def _scripts_import(name):
    scripts_dir = str(REPO / 'scripts')
    if scripts_dir not in sys.path:
        sys.path.insert(0, scripts_dir)
    return __import__(name)


def _record(registry, scoped):
    """One fixed sequence of records into a registry and a replica view
    of it."""
    registry.counter('train/steps_total').inc()
    registry.counter('train/steps_total').inc(4)
    registry.gauge('staging/ring_occupancy').set(2)
    registry.gauge('train/mfu').set(0.125)
    for seconds in (0.003, 0.001, 0.002, 0.010, 0.004):
        registry.timer('step/dispatch_ms').record(seconds)
    registry.timer('step/sync_ms')          # created, never recorded
    scoped.counter('serving/shed_total').inc(3)
    scoped.gauge('serving/queue_depth').set(7)
    scoped.timer('serving/latency_ms').record(0.0125)
    registry.gauge('goodput/badput_s{kind=compile}').set(1.5)


def _both():
    port, ref = core.Registry(), jax_core.Registry()
    _record(port, core.ScopedRegistry(port, 'replica', 'r1'))
    _record(ref, jax_core.ScopedRegistry(ref, 'replica', 'r1'))
    return port, ref


def _strip(value):
    if isinstance(value, dict):
        return {k: v for k, v in value.items()
                if k not in PORT_ONLY_TIMER_KEYS}
    return value


def test_registry_snapshot_equals_reference():
    port, ref = _both()
    got = {name: _strip(value) for name, value in port.snapshot().items()}
    assert got == ref.snapshot()
    # the port's one extra timer key, and only where timers are
    assert all(set(v) - set(ref.snapshot()[k]) == {'p99_ms'}
               for k, v in port.snapshot().items() if isinstance(v, dict))
    assert port.get('train/steps_total').value == 5
    with pytest.raises(TypeError):
        port.gauge('train/steps_total')
    port.reset()
    assert port.snapshot() == {}


def test_enable_flag_and_process_registry():
    assert not core.enabled()
    core.enable()
    assert core.enabled()
    core.registry().counter('train/steps_total').inc()
    assert core.registry().snapshot() == {'train/steps_total': 1}
    core.reset()
    assert core.registry().snapshot() == {}
    core.disable()
    assert not core.enabled()


def test_timer_context_and_totals():
    timer = core.Timer('step/total_ms')
    with timer.time():
        pass
    timer.record(0.5)
    assert timer.count == 2 and timer.last == 0.5
    assert timer.total >= 0.5
    assert timer.snapshot()['max_ms'] == 500.0


def test_jsonl_exporter_equals_reference(tmp_path):
    port, ref = _both()
    exporters.JsonlExporter(str(tmp_path / 'port')).flush(port, 7)
    jax_exporters.JsonlExporter(str(tmp_path / 'ref')).flush(ref, 7)

    def records(path):
        out = []
        for line in open(path):
            record = json.loads(line)
            del record['time']
            out.append(_strip(record))
        return out

    got = records(tmp_path / 'port' / 'metrics.jsonl')
    want = records(tmp_path / 'ref' / 'metrics.jsonl')
    assert got == want
    # a timer never recorded writes no record
    assert 'step/sync_ms' not in {r['tag'] for r in got}


def test_prometheus_exporter_equals_reference(tmp_path):
    port, ref = _both()
    exporters.PrometheusExporter(str(tmp_path / 'port')).flush(port, 7)
    jax_exporters.PrometheusExporter(str(tmp_path / 'ref')).flush(ref, 7)
    got = (tmp_path / 'port' / 'metrics.prom').read_text().splitlines()
    want = (tmp_path / 'ref' / 'metrics.prom').read_text().splitlines()
    # the same families in the same order with the same samples
    assert [l for l in got if not l.startswith('# HELP')] == \
        [l for l in want if not l.startswith('# HELP')]
    got_help = [l for l in got if l.startswith('# HELP')]
    want_help = [l for l in want if l.startswith('# HELP')]
    assert len(got_help) == len(want_help)
    for name in ('train/steps_total', 'staging/ring_occupancy',
                 'serving/shed_total', 'serving/queue_depth',
                 'serving/latency_ms', 'goodput/badput_s'):
        prom = catalog.prometheus_name(name)
        kept = catalog.CATALOG[name]['help'] == \
            jax_catalog.CATALOG[name]['help']
        line = [l for l in got_help if l.split()[2] == prom]
        ref_line = [l for l in want_help if l.split()[2] == prom]
        assert len(line) == len(ref_line) == 1
        assert (line == ref_line) == kept, name


def test_console_exporter_equals_reference():
    port, ref = _both()
    lines = []
    exporters.ConsoleExporter(lines.append, min_interval_s=0.0).flush(
        port, 3)
    jax_exporters.ConsoleExporter(lines.append, min_interval_s=0.0).flush(
        ref, 3)
    assert len(lines) == 2 and lines[0] == lines[1]
    # rate-limited: a second flush inside the interval writes nothing
    limited = exporters.ConsoleExporter(lines.append, min_interval_s=60.0)
    limited.flush(port, 4)
    limited.flush(port, 5)
    assert len(lines) == 3


# ------------------------------------------------------------- catalog
def test_catalog_entries_exist_in_reference_with_type_and_unit():
    for name, meta in catalog.CATALOG.items():
        assert name in jax_catalog.CATALOG, name
        ref = jax_catalog.CATALOG[name]
        assert (meta['type'], meta['unit']) == (ref['type'], ref['unit']), \
            name
        assert meta['help']


@pytest.mark.parametrize('name', [
    'serving/shed_total', 'serving/shed_total{replica=r1}',
    'goodput/badput_s{kind=compile}', 'mem/params_bytes'])
def test_label_helpers_equal_reference(name):
    assert catalog.base_name(name) == jax_catalog.base_name(name)
    assert catalog.split_label(name) == jax_catalog.split_label(name)
    assert catalog.prometheus_name(name) == \
        jax_catalog.prometheus_name(name)
    assert catalog.labeled('a/b', 'replica', 'r2') == \
        jax_catalog.labeled('a/b', 'replica', 'r2')


EMIT_METHODS = {'counter', 'gauge', 'timer', 'scalar', 'get'}


def _emitted_names():
    """(file, line, name) of every metric-shaped string literal passed to
    an emission method in code2vec_tpu_torch/."""
    import re
    shape = re.compile(r'^[a-z_]+/[a-z0-9_]+(\{[^}]*\})?$')
    found = []
    for path in sorted((REPO / 'code2vec_tpu_torch').rglob('*.py')):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and node.args
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in EMIT_METHODS):
                continue
            for sub in ast.walk(node.args[0]):
                if isinstance(sub, ast.Constant) and \
                        isinstance(sub.value, str) and \
                        shape.match(sub.value.replace('%s', 'x')):
                    found.append((path.relative_to(REPO), sub.lineno,
                                  sub.value))
    return found


def test_every_emitted_name_is_cataloged():
    emitted = _emitted_names()
    # the scan sees the layers it should: trainer, engine, data, ledger
    files = {str(f) for f, _line, _name in emitted}
    for part in ('training/trainer.py', 'serving/engine.py',
                 'data/packed.py', 'telemetry/memory.py',
                 'resilience/guard.py', 'model_api.py'):
        assert any(f.endswith(part) for f in files), part
    unknown = [(str(f), line, name) for f, line, name in emitted
               if catalog.base_name(name.replace('%s', 'x'))
               not in catalog.CATALOG]
    assert unknown == []
    # names emitted through a table rather than a literal
    for name in memory_lib._BUCKET_GAUGE.values():
        assert name in catalog.CATALOG


# ------------------------------------------------------------- compiles
def test_note_compile_counts_as_the_reference_listener():
    jax_core.enable()
    jax_jit._on_event_duration('/jax/core/compile/backend_compile_duration',
                               0.25)
    core.enable()
    jit_tracker.note_compile(0.25)
    assert core.registry().snapshot()['jit/compiles_total'] == \
        jax_core.registry().snapshot()['jit/compiles_total'] == 1
    assert _strip(core.registry().snapshot()['jit/compile_ms']) == \
        jax_core.registry().snapshot()['jit/compile_ms']
    # off: nothing recorded
    core.disable()
    jit_tracker.note_compile(1.0)
    assert core.registry().get('jit/compiles_total').value == 1


def test_note_compile_feeds_the_active_goodput_ledger():
    core.enable()
    ledger = goodput.GoodputLedger()
    goodput.activate(ledger)
    jit_tracker.note_compile(0.5)
    assert ledger.snapshot()['badput_s']['compile'] == 0.5


def test_capacity_tracker_equals_reference():
    core.enable()
    jax_core.enable()
    logs, ref_logs = [], []
    tracker = jit_tracker.CapacityTracker(log=logs.append)
    ref = jax_jit.CapacityTracker(log=ref_logs.append)
    for step, capacity in enumerate((64, 64, 128, 64, 256)):
        tracker.observe(capacity, step)
        ref.observe(capacity, step)
    assert core.registry().snapshot() == jax_core.registry().snapshot()
    assert len(logs) == len(ref_logs) == 3


# ------------------------------------------------------------------- CLI
TELEMETRY_FIELDS = ('TELEMETRY', 'TELEMETRY_DIR',
                    'TELEMETRY_FLUSH_EVERY_STEPS',
                    'TELEMETRY_CONSOLE_EVERY_SECS', 'TELEMETRY_TRACE_AT_STEP',
                    'TELEMETRY_TRACE_NUM_STEPS', 'TRACING_SAMPLE_RATE',
                    'TRACING_SLOW_MS', 'TRACING_FLIGHT_TRACES',
                    'HBM_BUDGET_BYTES', 'MEMORY_REPORT', 'DEVICE_PEAK_FLOPS',
                    'GOODPUT_ANOMALY_SIGMA',
                    'GOODPUT_AUTOCAPTURE_COOLDOWN_SECS', 'PROFILE_DIR',
                    'PROFILE_START_STEP', 'PROFILE_NUM_STEPS')


@pytest.mark.parametrize('argv', [
    [],
    ['--telemetry'],
    ['--telemetry', '--telemetry-dir', 'tele'],
    ['--trace-at-step', '12'],
    ['--device-peak-flops', '9.89e14', '--hbm-budget-bytes', '123456'],
    ['--memory-report', '--profile', 'prof'],
    ['--telemetry', '--trace-at-step', '2', '--memory-report',
     '--hbm-budget-bytes', '0', '--telemetry-dir', 't', '--profile', 'p',
     '--device-peak-flops', '5e10'],
])
def test_cli_flags_fill_the_reference_fields(argv, monkeypatch):
    from code2vec_tpu.config import Config as JaxConfig
    from code2vec_tpu_torch.config import Config
    for name in ('TELEMETRY_TRACE_AT_STEP', 'TRACING_SAMPLE_RATE',
                 'HBM_BUDGET_BYTES', 'DEVICE_PEAK_FLOPS'):
        monkeypatch.delenv(name, raising=False)
    base = ['--data', 'x']
    port = Config().load_from_args(base + argv + ['--device', 'cpu'])
    ref = JaxConfig().load_from_args(base + argv)
    for field in TELEMETRY_FIELDS:
        assert getattr(port, field) == getattr(ref, field), field
    assert port.tracing_sample_rate == ref.tracing_sample_rate


@pytest.mark.parametrize('env, value', [
    ('TELEMETRY_TRACE_AT_STEP', '7'), ('TRACING_SAMPLE_RATE', '0.5'),
    ('TRACING_SAMPLE_RATE', '3'), ('TELEMETRY_TRACE_AT_STEP', 'x')])
def test_environment_fill_ins_equal_reference(env, value, monkeypatch):
    from code2vec_tpu.config import Config as JaxConfig
    from code2vec_tpu_torch.config import Config
    monkeypatch.setenv(env, value)
    port = Config().load_from_args(['--data', 'x', '--device', 'cpu'])
    ref = JaxConfig().load_from_args(['--data', 'x'])
    assert (port.TELEMETRY, port.TELEMETRY_TRACE_AT_STEP,
            port.tracing_sample_rate) == \
        (ref.TELEMETRY, ref.TELEMETRY_TRACE_AT_STEP, ref.tracing_sample_rate)


@pytest.mark.parametrize('field, value', [
    ('TELEMETRY_FLUSH_EVERY_STEPS', 0), ('TELEMETRY_TRACE_NUM_STEPS', 0),
    ('TRACING_SAMPLE_RATE', 1.5), ('TRACING_SLOW_MS', -1.0),
    ('TRACING_FLIGHT_TRACES', 0), ('HBM_BUDGET_BYTES', -2),
    ('DEVICE_PEAK_FLOPS', 0.0), ('GOODPUT_ANOMALY_SIGMA', -1.0),
    ('GOODPUT_AUTOCAPTURE_COOLDOWN_SECS', -1.0)])
def test_verify_rejects_what_the_reference_rejects(field, value):
    from code2vec_tpu.config import Config as JaxConfig
    from code2vec_tpu_torch.config import Config
    port = Config(TRAIN_DATA_PATH_PREFIX='x', **{field: value})
    ref = JaxConfig(TRAIN_DATA_PATH_PREFIX='x', **{field: value})
    with pytest.raises(ValueError, match=field):
        port.verify()
    with pytest.raises(ValueError, match=field):
        ref.verify()


# ------------------------------------------------------------ artifacts
@pytest.fixture(scope='module')
def telemetry_run(tmp_path_factory):
    """One CPU train() through the CLI with telemetry, a trace at step 2
    and the memory report; returns the telemetry directory."""
    from code2vec_tpu_torch import cli
    tmp = tmp_path_factory.mktemp('torch_telemetry')
    prefix = make_dataset(tmp, n_train=96)
    save = tmp / 'models' / 'saved_model'
    cwd = os.getcwd()
    os.chdir(tmp)       # evaluate() writes its log.txt here
    try:
        cli.main(['--data', str(prefix), '--test',
                  str(prefix) + '.val.c2v', '--save', str(save),
                  '--epochs', '2', '--batch-size', '16', '--telemetry',
                  '--trace-at-step', '2', '--memory-report', '-v', '0',
                  '--device', 'cpu'])
    finally:
        os.chdir(cwd)
        core.reset()
        memory_lib.reset()
    return save.parent / 'telemetry'


def _tags(path):
    by_tag = {}
    for line in open(path):
        record = json.loads(line)
        by_tag.setdefault(record['tag'], []).append(record)
    return by_tag


def test_train_leaves_the_telemetry_artifacts(telemetry_run):
    tele = telemetry_run
    for name in ('metrics.jsonl', 'metrics.prom', 'intervals.jsonl',
                 'memory_report.json'):
        assert (tele / name).is_file(), name
    trace = tele / 'traces' / 'step2' / 'trace.json'
    events = json.loads(trace.read_text())['traceEvents']
    names = {event.get('name') for event in events}
    assert {'train', 'host/batch_wait', 'host/h2d_place'} <= names
    by_tag = _tags(tele / 'metrics.jsonl')
    for tag in ('step/batch_wait_ms', 'step/dispatch_ms', 'step/sync_ms',
                'train/steps_total', 'train/mfu', 'train/step_flops',
                'goodput/fraction', 'mem/params_bytes',
                'mem/opt_state_bytes', 'trace/captures_total',
                'input/batches_total', 'jit/packed_capacity'):
        assert tag in by_tag, tag
    assert by_tag['trace/captures_total'][-1]['value'] == 1
    assert by_tag['train/steps_total'][-1]['value'] == 12
    assert all(0 < r['value'] < 10 for r in by_tag['train/mfu'])
    # nothing emitted outside the catalog
    assert all(catalog.base_name(tag) in catalog.CATALOG for tag in by_tag)


def test_goodput_report_reads_the_port_run(telemetry_run, capsys):
    goodput_report = _scripts_import('goodput_report')
    assert goodput_report.main([str(telemetry_run), '--json']) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1          # one process, one run span
    payload = json.loads(lines[0])
    wall = payload['wall_s']
    total = payload['productive_s'] + sum(payload['badput_s'].values())
    assert total == pytest.approx(wall, rel=1e-9)
    assert payload['badput_s']['unattributed'] / wall < 0.02
    assert payload['badput_s']['eval'] > 0
    assert payload['badput_s']['checkpoint'] > 0
    records = [json.loads(l) for l in open(telemetry_run / 'intervals.jsonl')]
    assert [r['kind'] for r in records].count('run_start') == 1
    assert records[-1]['kind'] == 'run_end'


def test_memory_report_renders_the_port_snapshot(telemetry_run, capsys):
    memory_report = _scripts_import('memory_report')
    path = str(telemetry_run / 'memory_report.json')
    assert memory_report.main([path]) == 0
    out = capsys.readouterr().out
    assert 'params' in out and 'opt_state' in out
    # the CPU reports no device bytes: nothing to reconcile
    assert 'not reconciled' in out
    snap = json.loads(open(path).read())
    assert snap['buckets']['params']['bytes'] > 0
    assert snap['buckets']['opt_state']['bytes'] > 0
    assert 'backend' not in snap


def test_telemetry_off_writes_nothing(tmp_path):
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.model_api import Code2VecModel
    prefix = make_dataset(tmp_path, n_train=32)
    model = Code2VecModel(Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                                 NUM_TRAIN_EPOCHS=1, TRAIN_BATCH_SIZE=16,
                                 MAX_CONTEXTS=6, VERBOSE_MODE=0),
                          device='cpu')
    assert model.trainer._telemetry is None
    model.train()
    assert not (tmp_path / 'telemetry').exists()
    assert not pathlib.Path('telemetry').exists() or \
        not (pathlib.Path('telemetry') / 'metrics.jsonl').exists()
    assert core.registry().snapshot() == {}
