"""The port's static analysis (``code2vec_tpu_torch/analysis/``).

Three layers, as ``tests/test_graftlint.py`` has for the JAX package:

1. **per rule**: each of the port's rules fires on a seeded torch
   violation and stays quiet on the fixed snippet;
2. **mechanics against the JAX engine**: both engines run over the same
   synthetic trees and give equal ``(rule, file, line, message)``
   findings for ``lock-discipline``, ``config-knob-docs``, the
   suppression rules and the baseline rules; both ``Baseline.load`` read
   a baseline file to the same entries;
3. **guard**: one full pass over the port's tree (a module-scoped
   fixture) gives zero unbaselined findings well inside 20 s, and the
   command line exits 0.
"""
import json
import os

import pytest

from code2vec_tpu.analysis import baseline as jax_baseline
from code2vec_tpu.analysis import engine as jax_engine
from code2vec_tpu.analysis import rules as _jax_rules  # noqa: F401
from code2vec_tpu.analysis.walker import SourceTree as JaxSourceTree
from code2vec_tpu_torch.analysis import baseline as port_baseline
from code2vec_tpu_torch.analysis import catalog, engine
from code2vec_tpu_torch.analysis import rules as _rules  # noqa: F401
from code2vec_tpu_torch.analysis.core import all_rules
from code2vec_tpu_torch.analysis.walker import SourceTree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_tree(tmp_path, code, extra_files=None):
    pkg = tmp_path / 'pkg'
    pkg.mkdir(exist_ok=True)
    (pkg / 'mod.py').write_text(code)
    for name, text in (extra_files or {}).items():
        path = tmp_path / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)


def lint(tmp_path, code, rule_names, extra_files=None, baseline=''):
    """The port's rules over one synthetic module in a tmp tree."""
    write_tree(tmp_path, code, extra_files)
    tree = SourceTree(str(tmp_path), scan_dirs=('pkg',), scan_files=(),
                      package_dirs=('pkg',))
    return engine.run(root=str(tmp_path), rule_names=rule_names,
                      baseline_path=baseline, tree=tree)


def jax_lint(tmp_path, rule_names, baseline=''):
    """The JAX engine over the same tree (written by ``lint``)."""
    tree = JaxSourceTree(str(tmp_path), scan_dirs=('pkg',), scan_files=(),
                         package_dirs=('pkg',))
    return jax_engine.run(root=str(tmp_path), rule_names=rule_names,
                          baseline_path=baseline, tree=tree)


def by_rule(report, rule):
    return [f for f in report.findings if f.rule == rule]


def rows(report):
    return [(f.rule, f.file, f.line, f.message) for f in report.findings]


def in_pkg(report, rule):
    return [f for f in by_rule(report, rule) if f.file.startswith('pkg')]


# ------------------------------------------------------------- host-sync
SEEDED_SYNC = '''
import numpy as np
import torch


def hot(trainer, state, arrays):
    state, loss = trainer.train_step_placed(state, arrays)
    return state, float(loss)


def scalar(x):
    return x.item()


def listed(x):
    return x.tolist()


def fetched(x):
    return x.cpu()


def drained(event):
    torch.cuda.synchronize()
    event.synchronize()
'''

FIXED_SYNC = '''
import numpy as np


def hot(trainer, state, arrays):
    state, loss = trainer.train_step_placed(state, arrays)
    return state, loss   # stays on the card; the log window syncs later


def host_only(batch):
    return [float(np.asarray(a).sum()) for a in batch]
'''


def test_host_sync_fires_on_every_kind(tmp_path):
    report = lint(tmp_path, SEEDED_SYNC, ['host-sync'])
    kinds = sorted(f.message.split('(')[1].split(')')[0]
                   for f in by_rule(report, 'host-sync'))
    assert kinds == ['cpu', 'fetch', 'item', 'synchronize', 'synchronize',
                     'tolist'], report.findings


def test_host_sync_quiet_when_values_stay_on_the_card(tmp_path):
    report = lint(tmp_path, FIXED_SYNC, ['host-sync'])
    assert not by_rule(report, 'host-sync'), report.findings


def test_host_sync_counts_a_chain_after_cpu_once(tmp_path):
    # .cpu().numpy() / .cpu().tolist(): the copy is the one sync
    code = ('def fetch(x, y):\n'
            '    a = x.detach().cpu().numpy()\n'
            '    b = y.cpu().tolist()\n'
            '    return a, b, a.tolist()\n')
    report = lint(tmp_path, code, ['host-sync'])
    kinds = [f.message.split('(')[1].split(')')[0]
             for f in by_rule(report, 'host-sync')]
    assert kinds == ['cpu', 'cpu'], report.findings


def test_host_sync_fetch_needs_a_result_on_the_card(tmp_path):
    code = ('import torch\n'
            'def f(host, dev):\n'
            '    a = float(host.sum())\n'
            '    t = torch.zeros(4, device=dev)\n'
            '    return a, int(t.sum()), host.numpy()\n')
    report = lint(tmp_path, code, ['host-sync'])
    found = by_rule(report, 'host-sync')
    assert len(found) == 1 and '(fetch)' in found[0].message, found


def test_sanctioned_syncs_carry_reasons_and_counts():
    assert len(catalog.SANCTIONED_SYNCS) >= 20
    for entry in (catalog.SANCTIONED_SYNCS + catalog.WARMUP_SITES
                  + catalog.PINNED_ALLOCATORS + catalog.PINNED_REUSERS):
        assert entry['reason'].strip(), entry
        assert entry.get('count', 1) >= 1


# -------------------------------------------------------- capture-purity
STEP_MODULE = '''
import time


def predict_step(backend, arrays):
    return _encode(backend, arrays)


def _encode(backend, arrays):
    t0 = time.perf_counter()
    out = backend.encode(arrays)
    return out, out.sum().item(), t0
'''

CAPTURING_MODULE = '''
import torch

from pkg.steps import predict_step


class Ladder:
    def capture(self, backend, inputs, pool):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=pool)
        try:
            out = predict_step(backend, inputs)
        finally:
            graph.capture_end()
        return graph, out
'''


def test_capture_purity_follows_the_captured_call_across_files(tmp_path):
    report = lint(tmp_path, CAPTURING_MODULE, ['capture-purity'],
                  extra_files={'pkg/steps.py': STEP_MODULE})
    found = by_rule(report, 'capture-purity')
    messages = sorted(f.message for f in found)
    assert len(found) == 2, found
    assert all(f.file == os.path.join('pkg', 'steps.py') for f in found)
    assert 'time.perf_counter' in messages[1] and '_encode' in messages[1]
    assert '.item' in messages[0] and 'fails the capture' in messages[0]


def test_capture_purity_quiet_on_a_pure_body(tmp_path):
    pure = ('def predict_step(backend, arrays):\n'
            '    out = backend.encode(arrays)\n'
            '    return {"code": out, "norm": out.norm(dim=-1)}\n')
    report = lint(tmp_path, CAPTURING_MODULE, ['capture-purity'],
                  extra_files={'pkg/steps.py': pure})
    assert not by_rule(report, 'capture-purity'), report.findings


def test_capture_purity_checks_a_graph_context_body(tmp_path):
    code = ('import torch\n'
            'def measure(fn, graph):\n'
            '    with torch.cuda.graph(graph):\n'
            '        print("capturing")\n'
            '        fn()\n')
    report = lint(tmp_path, code, ['capture-purity'])
    found = by_rule(report, 'capture-purity')
    assert len(found) == 1 and '`print(...)`' in found[0].message


# -------------------------------------------------------- capture-hazard
SEEDED_HAZARD = '''
import torch

from code2vec_tpu_torch.ops import _build
from pkg.graphs import GraphKey


def serve(ladder, rows, tier):
    key = GraphKey(len(rows), 64, tier, 0)
    return ladder.replay(key)


def lazy_capture(fn):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    _build.build(['ce'])
    return graph
'''

FIXED_HAZARD = '''
from pkg.graphs import GraphKey


def serve(ladder, rows, tier, buckets):
    bucket = pick_bucket(len(rows), buckets)
    key = GraphKey(bucket, 64, tier, 0)
    return ladder.replay(key)
'''


def test_capture_hazard_fires_on_capture_build_and_raw_key(tmp_path):
    report = lint(tmp_path, SEEDED_HAZARD, ['capture-hazard'])
    messages = sorted(f.message for f in by_rule(report, 'capture-hazard'))
    assert len(messages) == 3, messages
    assert 'graph capture outside a warm-up site' in messages[0]
    assert 'graph key `GraphKey(...)`' in messages[1] and 'len()' in \
        messages[1]
    assert 'kernel build outside a warm-up site' in messages[2]


def test_capture_hazard_quiet_on_warm_ladder_keys(tmp_path):
    report = lint(tmp_path, FIXED_HAZARD, ['capture-hazard'])
    assert not by_rule(report, 'capture-hazard'), report.findings


def test_capture_hazard_cataloged_warmup_site_is_quiet(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(catalog, 'WARMUP_SITES', (
        {'file': os.path.join('pkg', 'mod.py'), 'func': 'lazy_capture',
         'kind': 'capture', 'count': 1, 'reason': 'test: a warm-up'},
        {'file': os.path.join('pkg', 'mod.py'), 'func': 'lazy_capture',
         'kind': 'build', 'count': 1, 'reason': 'test: a warm-up'},
        {'file': os.path.join('pkg', 'mod.py'), 'func': 'gone',
         'kind': 'build', 'count': 1, 'reason': 'test: stale'}))
    report = lint(tmp_path, SEEDED_HAZARD, ['capture-hazard'])
    messages = [f.message for f in by_rule(report, 'capture-hazard')]
    assert len(messages) == 2, messages
    assert any('stale WARMUP_SITES entry' in m for m in messages)
    assert any('graph key' in m for m in messages)


# ---------------------------------------------------------- pinned-reuse
SEEDED_PINNED = '''
import torch


class Pool:
    def take(self, shape):
        return torch.empty(shape, pin_memory=True)


def send(buffer, device):
    return buffer.to(device, non_blocking=True)
'''

FIXED_PINNED = '''
import torch


def send(buffer, device, stream):
    out = buffer.to(device, non_blocking=True)
    event = torch.cuda.Event()
    event.record(stream)
    return out, event
'''


def test_pinned_reuse_fires_on_stray_pinning_and_unrecorded_copy(tmp_path):
    report = lint(tmp_path, SEEDED_PINNED, ['pinned-reuse'])
    messages = sorted(f.message for f in by_rule(report, 'pinned-reuse'))
    assert len(messages) == 2, messages
    assert 'no event recorded' in messages[0]
    assert 'outside a cataloged pool' in messages[1]


def test_pinned_reuse_quiet_when_the_copy_records_its_event(tmp_path):
    report = lint(tmp_path, FIXED_PINNED, ['pinned-reuse'])
    assert not by_rule(report, 'pinned-reuse'), report.findings


def test_pinned_reuse_pool_must_wait_before_reuse(tmp_path, monkeypatch):
    pool = os.path.join('pkg', 'mod.py')
    monkeypatch.setattr(catalog, 'PINNED_ALLOCATORS', (
        {'file': pool, 'func': 'Pool.take', 'count': 1,
         'reason': 'test: the pool'},))
    monkeypatch.setattr(catalog, 'PINNED_REUSERS', (
        {'file': pool, 'func': 'Pool.take', 'reason': 'test: the pool'},))
    code = SEEDED_PINNED.replace(
        '        return torch.empty(shape, pin_memory=True)',
        '        if self.free:\n'
        '            return self.free.pop()\n'
        '        return torch.empty(shape, pin_memory=True)')
    report = lint(tmp_path, code, ['pinned-reuse'])
    messages = [f.message for f in by_rule(report, 'pinned-reuse')]
    assert any('without waiting on its last copy' in m for m in messages)
    fixed = code.replace('            return self.free.pop()',
                         '            buffer, event = self.free.pop()\n'
                         '            event.synchronize()\n'
                         '            return buffer')
    report = lint(tmp_path, fixed, ['pinned-reuse'])
    messages = [f.message for f in by_rule(report, 'pinned-reuse')]
    assert not any('without waiting' in m or 'cataloged pool' in m
                   for m in messages), messages


def test_donation_has_no_counterpart_and_says_why():
    """The port donates no buffer (no DONATE_STAGED_BATCHES), so the JAX
    ``donation-safety`` has no counterpart; ``pinned-reuse`` checks the
    dual hazard, and the rule's docstring and the README say so."""
    from code2vec_tpu_torch.analysis.rules import pinned_reuse
    from code2vec_tpu_torch.config import Config
    names = {rule.name for rule in all_rules()}
    assert 'donation-safety' not in names and 'pinned-reuse' in names
    assert not hasattr(Config(), 'DONATE_STAGED_BATCHES')
    doc = pinned_reuse.__doc__
    assert 'donation-safety' in doc and 'DONATE_STAGED_BATCHES' in doc
    with open(os.path.join(REPO, 'README.md')) as f:
        readme = f.read()
    assert 'DONATE_STAGED_BATCHES' in readme.split(
        "### The port's static analysis")[1].split('## Static analysis')[0]


# ---------------------------------------------------------- alloc-catalog
SEEDED_ALLOC = '''
import torch


def place(x, device):
    out = torch.zeros(4, device=device)
    host = torch.zeros(4, device='cpu')
    return x.to(device), x.to(torch.float32), x.to(x.dtype), out, host


def lift(x):
    return x.cuda()
'''


def test_alloc_catalog_fires_and_pins_counts(tmp_path, monkeypatch):
    from code2vec_tpu_torch.telemetry import memory
    mod = os.path.join('pkg', 'mod.py')
    monkeypatch.setattr(memory, 'ALLOC_OWNER_FILES', (mod,))
    monkeypatch.setattr(memory, 'ALLOC_CATALOG', (
        {'file': mod, 'func': 'place', 'count': 1,
         'reason': 'test: registered'},))
    report = lint(tmp_path, SEEDED_ALLOC, ['alloc-catalog'])
    messages = sorted(f.message for f in by_rule(report, 'alloc-catalog'))
    assert len(messages) == 2, messages
    assert 'pins 1 allocation site(s) in place but found 2' in messages[0]
    assert 'allocation site .cuda in lift' in messages[1]
    monkeypatch.setattr(memory, 'ALLOC_CATALOG', (
        {'file': mod, 'func': 'place', 'count': 2, 'reason': 'test'},
        {'file': mod, 'func': 'lift', 'count': 1, 'reason': 'test'}))
    report = lint(tmp_path, SEEDED_ALLOC, ['alloc-catalog'])
    assert not by_rule(report, 'alloc-catalog'), report.findings


# --------------------------------------------------- catalog-drift rules
def test_metrics_schema_fires_on_uncataloged_metric(tmp_path):
    code = ('def f(reg):\n'
            "    reg.counter('serving/bogus_total').inc()\n"
            "    reg.counter('serving/requests_total').inc()\n")
    report = lint(tmp_path, code, ['metrics-schema'])
    found = in_pkg(report, 'metrics-schema')
    assert len(found) == 1 and 'serving/bogus_total' in found[0].message


def test_fault_points_fires_on_uncataloged_point(tmp_path):
    from code2vec_tpu_torch.resilience.faults import FAULT_POINTS
    real = sorted(FAULT_POINTS)[0]
    code = ('def f(faults):\n'
            "    faults.maybe_fire('bogus_point')\n"
            "    faults.maybe_fire('%s')\n" % real)
    report = lint(tmp_path, code, ['fault-points'])
    found = in_pkg(report, 'fault-points')
    assert len(found) == 1 and 'bogus_point' in found[0].message
    # every other cataloged point is unwired in this tree
    assert any('no maybe_fire site' in f.message
               for f in by_rule(report, 'fault-points'))


def test_span_catalog_fires_on_uncataloged_span(tmp_path):
    code = ('def f(tracer):\n'
            "    tracer.begin('serving.bogus_phase')\n"
            "    tracer.begin('autoscale.transition')\n")
    report = lint(tmp_path, code, ['span-catalog'])
    found = in_pkg(report, 'span-catalog')
    assert len(found) == 1 and 'serving.bogus_phase' in found[0].message


def test_autoscaler_span_is_cataloged_as_in_the_reference():
    """C17: the autoscaler traces ``autoscale.transition``; the port's
    catalog lacked it."""
    from code2vec_tpu.telemetry import tracing as jax_tracing
    from code2vec_tpu_torch.telemetry import tracing
    assert (tracing.SPAN_CATALOG['autoscale.transition']
            == jax_tracing.SPAN_CATALOG['autoscale.transition'])


# --------------------------------------- mechanics, against the JAX engine
UNGUARDED = '''
import threading


class Engine:
    # graftlint: guard Engine._queue by _lock
    def __init__(self):
        self._lock = threading.Lock()
        self._queue = []

    def put(self, item):
        self._queue.append(item)

    def depth_locked(self):
        return len(self._queue)

    def get(self):
        with self._lock:
            return self._queue.pop()
'''

PUT = '''    def put(self, item):
        self._queue.append(item)
'''

KNOB = ("import os\n"
        "LIMIT = os.environ.get('PKG_SECRET_LIMIT', '8')\n"
        "def flags(parser):\n"
        "    parser.add_argument('-s', '--secret-flag')\n")

MECHANICS = {
    'unguarded': (UNGUARDED, ['lock-discipline'], None),
    'guarded': (UNGUARDED.replace(PUT, '''    def put(self, item):
        with self._lock:
            self._queue.append(item)
'''), ['lock-discipline'], None),
    'stale-guard': ('import threading\n'
                    'class Thing:\n'
                    '    # graftlint: guard Thing._ghost by _lock\n'
                    '    def __init__(self):\n'
                    '        self._lock = threading.Lock()\n',
                    ['lock-discipline'], None),
    'wrong-lock': ('import threading\n'
                   'class E:\n'
                   '    # graftlint: guard E._queue by _lock\n'
                   '    # graftlint: guard E._warm by _warm_lock\n'
                   '    def __init__(self):\n'
                   '        self._lock = threading.Lock()\n'
                   '        self._warm_lock = threading.Lock()\n'
                   '        self._warm = False\n'
                   '    def bad(self):\n'
                   '        with self._lock:\n'
                   '            self._warm = True\n'
                   '        self._queue = []\n',
                   ['lock-discipline'], None),
    'condition-alias': ('import threading\n'
                        'class W:\n'
                        '    # graftlint: guard W._stop by _lock|_cond\n'
                        '    def __init__(self):\n'
                        '        self._lock = threading.Lock()\n'
                        '        self._cond = threading.Condition(\n'
                        '            self._lock)\n'
                        '    def shutdown(self):\n'
                        '        with self._cond:\n'
                        '            self._stop = True\n',
                        ['lock-discipline'], None),
    'unknown-class': ('# graftlint: guard Nobody._x by _lock\n',
                      ['lock-discipline'], None),
    'knob-undocumented': (KNOB, ['config-knob-docs'],
                          {'README.md': '# docs\nnothing here\n'}),
    'knob-documented': (KNOB, ['config-knob-docs'],
                        {'README.md': '`PKG_SECRET_LIMIT`, '
                                      '`--secret-flag`\n'}),
    'knob-changelog-only': (KNOB, ['config-knob-docs'],
                            {'CHANGES.md': 'PKG_SECRET_LIMIT '
                                           '--secret-flag\n',
                             'README.md': 'real docs, knob absent\n'}),
    'suppressed': (UNGUARDED.replace(PUT, '''    def put(self, item):
        # graftlint: disable=lock-discipline -- test: sanctioned
        self._queue.append(item)
'''), ['lock-discipline'], None),
    'suppression-no-reason': (UNGUARDED.replace(PUT, '''    def put(self, item):
        # graftlint: disable=lock-discipline
        self._queue.append(item)
'''), ['lock-discipline'], None),
    'suppression-all': ('# graftlint: disable-file=all -- lazy\n'
                        + UNGUARDED, ['lock-discipline'], None),
    'suppression-malformed': ('# graftlint: disable lock-discipline\n'
                              + UNGUARDED, ['lock-discipline'], None),
    'suppression-stale': (UNGUARDED.replace(PUT, '''    def put(self, item):
        # graftlint: disable=lock-discipline -- obsolete: fixed below
        with self._lock:
            self._queue.append(item)
'''), ['lock-discipline'], None),
    'suppression-unrun-rule': ('# graftlint: disable=span-catalog -- not '
                               'run\nX = 1\n', ['lock-discipline'], None),
    'suppression-in-docstring': ('"""Use `# graftlint: disable='
                                 'lock-discipline -- why`."""\n'
                                 + UNGUARDED, ['lock-discipline'], None),
    'parse-error': (UNGUARDED, ['lock-discipline'],
                    {'pkg/broken.py': 'def broken(:\n    pass\n'}),
}


@pytest.mark.parametrize('case', sorted(MECHANICS))
def test_mechanics_match_the_jax_engine(tmp_path, case):
    code, rule_names, extra = MECHANICS[case]
    report = lint(tmp_path, code, rule_names, extra_files=extra)
    want = jax_lint(tmp_path, rule_names)
    assert rows(report) == rows(want)
    assert len(report.suppressed) == len(want.suppressed)
    if case in ('unguarded', 'stale-guard', 'wrong-lock', 'unknown-class',
                'knob-undocumented', 'knob-changelog-only',
                'suppression-no-reason', 'suppression-all',
                'suppression-malformed', 'suppression-stale',
                'suppression-in-docstring', 'parse-error'):
        assert report.findings, case
    else:
        assert not report.findings, (case, report.findings)


UNGUARDED_MSG = ('unguarded access to `Engine._queue` in `put` — declared '
                 'guarded by _lock; wrap in `with self._lock:` (or '
                 'suppress with the why if the race is benign)')

BASELINES = {
    'absorbs': (UNGUARDED, [{'rule': 'lock-discipline',
                             'file': os.path.join('pkg', 'mod.py'),
                             'message': UNGUARDED_MSG,
                             'reason': 'test: accepted'}]),
    'bare': (UNGUARDED, [{'rule': 'lock-discipline',
                          'file': os.path.join('pkg', 'mod.py'),
                          'message': UNGUARDED_MSG, 'reason': 'TODO'}]),
    'stale': (UNGUARDED.replace(PUT, '''    def put(self, item):
        with self._lock:
            self._queue.append(item)
'''), [{'rule': 'lock-discipline', 'file': os.path.join('pkg', 'mod.py'),
        'message': UNGUARDED_MSG, 'reason': 'test: accepted'}]),
    'duplicate': (UNGUARDED, [{'rule': 'lock-discipline',
                               'file': os.path.join('pkg', 'mod.py'),
                               'message': UNGUARDED_MSG,
                               'reason': 'test: accepted'}] * 2),
    'missing-key': (UNGUARDED, [{'rule': 'lock-discipline',
                                 'reason': 'test: no file'}]),
    'other-rule': (UNGUARDED, [{'rule': 'span-catalog',
                                'file': os.path.join('pkg', 'mod.py'),
                                'message': 'x', 'reason': 'not run'}]),
}


@pytest.mark.parametrize('case', sorted(BASELINES))
def test_baseline_matches_the_jax_engine(tmp_path, case):
    code, entries = BASELINES[case]
    path = tmp_path / 'baseline.json'
    path.write_text(json.dumps({'entries': entries}))
    report = lint(tmp_path, code, ['lock-discipline'],
                  baseline=str(path))
    want = jax_lint(tmp_path, ['lock-discipline'], baseline=str(path))
    assert rows(report) == rows(want)
    assert len(report.baselined) == len(want.baselined)
    if case == 'absorbs':
        assert not report.findings and len(report.baselined) == 1
    elif case == 'other-rule':
        assert len(report.findings) == 1   # the finding, no stale entry
    else:
        assert any(f.rule == 'graftlint' for f in report.findings), case


def test_baselines_read_the_same_in_both_engines(tmp_path):
    for path in (os.path.join(REPO, 'graftlint_baseline.json'),
                 os.path.join(REPO, port_baseline.BASELINE_PATH)):
        port = port_baseline.Baseline.load(path)
        ref = jax_baseline.Baseline.load(path)
        assert port.entries == ref.entries and port.path == ref.path
    # a file written by one engine reads back the same in the other
    findings = lint(tmp_path, UNGUARDED, ['lock-discipline']).findings
    port_baseline.write(str(tmp_path / 'port.json'), findings)
    jax_baseline.write(str(tmp_path / 'jax.json'),
                       jax_lint(tmp_path, ['lock-discipline']).findings)
    assert (tmp_path / 'port.json').read_text() == \
        (tmp_path / 'jax.json').read_text()


# ---------------------------------------------------------------- guard
@pytest.fixture(scope='module')
def port_report():
    return engine.run()


def test_port_tree_is_clean(port_report):
    assert port_report.clean, 'graftlint findings:\n%s' % '\n'.join(
        f.format() for f in port_report.findings)
    assert len(port_report.rules_run) == len(all_rules()) == 10
    assert port_report.suppressed, 'expected the reasoned suppressions'
    assert port_report.elapsed_s < 20, port_report.elapsed_s


def test_every_rule_has_its_readme_row():
    with open(os.path.join(REPO, 'README.md')) as f:
        section = f.read().split("### The port's static analysis")[1]
    section = section.split('\n## ')[0]
    for rule in all_rules():
        assert '| `%s` |' % rule.name in section, rule.name


def test_every_port_rule_names_its_jax_counterpart():
    from code2vec_tpu.analysis.core import all_rules as jax_rules
    jax_names = {rule.name for rule in jax_rules()}
    import sys
    for rule in all_rules():
        doc = sys.modules[type(rule).__module__].__doc__
        assert any(name in doc for name in jax_names), rule.name


def test_cli_exits_zero_on_the_checkout(capsys):
    from code2vec_tpu_torch.analysis.__main__ import main
    assert main(['--rules', 'lock-discipline,host-sync']) == 0
    assert '0 finding(s)' in capsys.readouterr().out
    assert main(['--list-rules']) == 0
    listed = capsys.readouterr().out
    assert all(rule.name in listed for rule in all_rules())
