"""The port's per-request tracing (code2vec_tpu_torch/telemetry/
tracing.py) and the serving engine's spans and registry mirrors against
the JAX package's on the CPU:

- ``Tracer``: one sequence of traces (head-sampled, tail-retained by a
  terminal span, by a failure and by latency, dropped) into both
  packages' tracers writes the same ``spans.jsonl`` records and flight
  dumps, apart from the clock stamps and the random trace-id prefix;
- the span catalog: every name the port emits is the reference's;
- the engine at sample rate 1.0: the same requests (a shed one, a whole
  one, an oversize one split in two chunks) through the reference engine
  and the port's give, trace by trace, the same span names under the
  same parents; ``scripts/latency_report.py`` reads the port's span log;
- the registry mirrors: with telemetry on, the engine's counters in the
  registry equal its ``stats()``; with the rate at 0 there is no tracer.

The comparisons are exact on names, statuses, attributes that carry no
clock reading, and tree shape.
"""
import json
import pathlib
import sys

import pytest

from code2vec_tpu.resilience import faults as jax_faults
from code2vec_tpu.telemetry import core as jax_core
from code2vec_tpu.telemetry import tracing as jax_tracing
from code2vec_tpu_torch.config import Config as PortConfig
from code2vec_tpu_torch.model_api import Code2VecModel as PortModel
from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.serving.errors import EngineOverloaded
from code2vec_tpu_torch.telemetry import core, tracing
from tests.test_serving_engine import PREDICT_LINES
from tests.test_torch_model import to_port
from tests.test_train_overfit import make_dataset

REPO = pathlib.Path(__file__).resolve().parents[1]
SHARED = dict(MAX_CONTEXTS=6, COMPUTE_DTYPE='float32',
              SERVING_BATCH_BUCKETS='8,16')
CLOCK_KEYS = ('t0', 't1', 'dur_ms', 'wall', 'trace', 'time',
              'shadow_fetch_ms')


@pytest.fixture(autouse=True)
def fresh_state():
    for module in (core, jax_core):
        module.reset()
        module.disable()
    yield
    for module in (core, jax_core):
        module.reset()
        module.disable()
    faults.configure('')
    jax_faults.configure('')


def _clean(record):
    out = {k: v for k, v in record.items() if k not in CLOCK_KEYS}
    if isinstance(out.get('attrs'), dict):
        out['attrs'] = {k: v for k, v in out['attrs'].items()
                        if k not in CLOCK_KEYS}
    return out


def _drive_tracer(module, out_dir):
    tracer = module.Tracer(str(out_dir), sample_rate=0.0, slow_ms=50.0,
                           flight_traces=3, shed_burst=2,
                           dump_min_interval_s=0.0)
    # dropped: unsampled, ok, fast
    trace = tracer.begin('serving.request', attrs={'tier': 'topk'})
    span = trace.span('serving.queue_wait')
    trace.end(span)
    trace.finish()
    # tail-retained: a terminal span
    trace = tracer.begin('serving.request', attrs={'tier': 'full'})
    trace.event('serving.shed', attrs={'reason': 'queue bound'})
    trace.finish(status='shed')
    tracer.note_shed()
    tracer.note_shed()          # a burst: one overload dump
    # tail-retained: slow
    trace = tracer.begin('serving.request')
    trace.root.t0 -= 1.0
    chunk = trace.span('serving.chunk', attrs={'chunk': 0, 'of': 2})
    trace.span_at('serving.pack', 0.0, 0.001, parent=chunk,
                  attrs={'bucket': 8})
    trace.event('serving.join', attrs={'chunks': 2})
    trace.finish()
    # tail-retained: a failure; a span after finish is dropped
    trace = tracer.begin('serving.request')
    trace.finish(status='error', reason='RuntimeError()')
    orphan = trace.span('serving.decode')
    assert orphan.span_id == -1
    tracer.single('serving.canary_shadow', attrs={'rows': 4})
    tracer.close()
    stats = tracer.stats()
    stats.pop('spans_path')
    return stats


def test_tracer_writes_the_reference_records(tmp_path):
    stats = {}
    for name, module in (('port', tracing), ('ref', jax_tracing)):
        stats[name] = _drive_tracer(module, tmp_path / name)
    assert stats['port'] == stats['ref']
    for log in ('spans.jsonl', 'flight_overload.jsonl',
                'flight_close.jsonl'):
        got = [_clean(json.loads(l)) for l in open(tmp_path / 'port' / log)]
        want = [_clean(json.loads(l)) for l in open(tmp_path / 'ref' / log)]
        assert got == want, log
    spans = [json.loads(l) for l in open(tmp_path / 'port' / 'spans.jsonl')]
    roots = [s for s in spans if s['parent'] is None]
    assert [r['status'] for r in roots] == ['shed', 'ok', 'error', 'ok']


def test_span_catalog_is_the_references():
    for name, text in tracing.SPAN_CATALOG.items():
        assert name in jax_tracing.SPAN_CATALOG, name
        assert text
    assert tracing.TAIL_SPANS <= jax_tracing.TAIL_SPANS


# ------------------------------------------------------------- the engine
@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    from code2vec_tpu.config import Config
    from code2vec_tpu.model_api import Code2VecModel
    prefix = make_dataset(tmp_path_factory.mktemp('torch_tracing'))
    reference = Code2VecModel(Config(
        TRAIN_DATA_PATH_PREFIX=str(prefix), DL_FRAMEWORK='jax',
        MESH_DEVICE_INDICES='0', TRAIN_BATCH_SIZE=16, TEST_BATCH_SIZE=16,
        NUM_TRAIN_EPOCHS=1, SHUFFLE_BUFFER_SIZE=64, VERBOSE_MODE=0,
        READER_USE_NATIVE=False, BATCH_WIRE_FORMAT='packed', **SHARED))
    port = PortModel(PortConfig(TRAIN_DATA_PATH_PREFIX=str(prefix),
                                **SHARED),
                     device='cpu', params=to_port(reference.params))
    return reference, port


def _trees(path):
    """Per trace, in file order: the root's status and the sorted
    (span name, parent name) edges."""
    traces = {}
    for line in open(path):
        record = json.loads(line)
        traces.setdefault(record['trace'], []).append(record)
    out = []
    for records in traces.values():
        names = {r['span']: r['name'] for r in records}
        root = [r for r in records if r['parent'] is None][0]
        edges = sorted((r['name'], names.get(r['parent']))
                       for r in records if r['parent'] is not None)
        out.append((root['name'], root['status'], edges))
    return out


def _serve(model, module_faults, tracer_module, out_dir):
    tracer = tracer_module.Tracer(str(out_dir), sample_rate=1.0)
    engine = model.serving_engine(tiers=('topk',), max_delay_ms=0.0,
                                  tracer=tracer, param_source=None)
    try:
        module_faults.configure('reject_all@req=0')
        with pytest.raises(Exception) as shed:
            engine.predict(PREDICT_LINES, tier='topk')
        assert 'shed' in str(shed.value)
        module_faults.configure('')
        whole = engine.predict(PREDICT_LINES, tier='topk')
        oversize = (PREDICT_LINES * 8)[:20]     # past bucket 16: 2 chunks
        split = engine.predict(oversize, tier='topk')
    finally:
        engine.close()
    tracer.close()
    return whole, split


def test_engine_spans_equal_reference(pair, tmp_path):
    reference, port = pair
    want = _serve(reference, jax_faults, jax_tracing, tmp_path / 'ref')
    got = _serve(port, faults, tracing, tmp_path / 'port')
    for g, w in zip(got, want):
        assert [r.topk_predicted_words for r in g] == \
            [r.topk_predicted_words for r in w]
    port_trees = _trees(tmp_path / 'port' / 'spans.jsonl')
    ref_trees = _trees(tmp_path / 'ref' / 'spans.jsonl')
    assert [t[:2] for t in port_trees] == [
        ('serving.request', 'shed'), ('serving.request', 'ok'),
        ('serving.request', 'ok')]
    assert port_trees == ref_trees
    # the split request: two chunks, each with its phases under it
    edges = port_trees[2][2]
    assert edges.count(('serving.chunk', 'serving.request')) == 2
    assert edges.count(('serving.pack', 'serving.chunk')) == 2
    assert ('serving.fetch', 'serving.device_execute') in edges
    assert ('serving.join', 'serving.request') in edges
    for name, _parent in edges:
        assert name in tracing.SPAN_CATALOG


def test_latency_report_reads_the_port_span_log(pair, tmp_path, capsys):
    _serve(pair[1], faults, tracing, tmp_path)
    scripts = str(REPO / 'scripts')
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import latency_report
    path = str(tmp_path / 'spans.jsonl')
    assert latency_report.main(['--spans', path, '--json']) == 0
    rows = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    statuses = [r for r in rows if r['measure'] == 'trace_statuses'][0]
    assert statuses['value'] == {'shed': 1, 'ok': 2}
    phases = {r['phase'] for r in rows
              if r['measure'] == 'phase_latency_ms'}
    assert {'serving.queue_wait', 'serving.pack', 'serving.dispatch',
            'serving.device_execute', 'serving.decode'} <= phases
    assert latency_report.main(['--spans', path, '--top', '1']) == 0


def test_engine_mirrors_equal_its_stats(pair):
    port = pair[1]
    core.enable()
    with port.serving_engine(tiers=('topk',), max_delay_ms=0.0,
                             tracing_sample_rate=0.0,
                             param_source=None) as engine:
        assert engine._tracer is None
        for _ in range(3):
            engine.predict(PREDICT_LINES, tier='topk')
        stats = engine.stats()
    assert stats['tracing'] is None
    snap = core.registry().snapshot()
    assert snap['serving/requests_total'] == stats['requests_total'] == 3
    assert snap['serving/batches_total'] == stats['batches_total'] == 3
    assert snap['serving/latency_ms']['count'] == 3
    assert snap['serving/batch_fill_rate'] == stats['batch_fill_rate']
    assert snap['serving/programs_warm'] == 0   # the CPU captures none


def test_engine_shed_feeds_the_flight_recorder(pair, tmp_path):
    """Sheds feed the overload detector; a burst dumps
    flight_overload.jsonl with the shed traces."""
    tracer = tracing.Tracer(str(tmp_path), sample_rate=0.0, shed_burst=2)
    engine = pair[1].serving_engine(tiers=('topk',), max_delay_ms=0.0,
                                    tracer=tracer, param_source=None)
    try:
        faults.configure('reject_all@req=0..1')
        for _ in range(2):
            with pytest.raises(EngineOverloaded):
                engine.predict(PREDICT_LINES, tier='topk')
    finally:
        engine.close()
    dump = [json.loads(l) for l in open(tmp_path / 'flight_overload.jsonl')]
    assert dump[0]['flight'] == 'overload'
    assert [r['status'] for r in dump[1:] if r['parent'] is None] == \
        ['shed', 'shed']
    # an injected tracer is its owner's: the engine did not close it
    assert not (tmp_path / 'flight_close.jsonl').exists()
