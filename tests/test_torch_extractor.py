"""The port's extractor bridge and prediction shell against the
reference's:

- ``Extractor`` on Java and C# sources: the same context lines (hashed
  paths, head-truncated and padded to MAX_CONTEXTS) and the same
  hash -> path dictionaries as ``code2vec_tpu/serving/extractor_bridge.py``
  (both run the port's extractor, built from ``extractor/src``);
- ``ExtractorPool``'s timeout, retries with backoff and circuit breaker,
  with fake extractor commands and an injected clock (no test waits on
  the breaker's cooldown or the backoff);
- ``InteractivePredictor`` with scripted input, against the reference's
  shell on the same weights: the same report, text equal and the printed
  probabilities and attention scores within 1e-5 (fp32 on two
  frameworks);
- ``cli.main([... '--predict', '--device', 'cpu'])``.
"""
import re
import sys

import pytest

from code2vec_tpu import common as jax_common
from code2vec_tpu.config import Config as JaxConfig
from code2vec_tpu.model_api import Code2VecModel as JaxModel
from code2vec_tpu.serving import extractor_bridge as jax_bridge
from code2vec_tpu.serving.predict import \
    InteractivePredictor as JaxPredictor
from code2vec_tpu_torch import cli, common
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.model_api import Code2VecModel
from code2vec_tpu_torch.serving.errors import (ExtractorCrash,
                                               ExtractorError,
                                               ExtractorUnavailable)
from code2vec_tpu_torch.serving.extractor_bridge import (Extractor,
                                                         ExtractorPool,
                                                         build_extractor,
                                                         infer_language)
from code2vec_tpu_torch.serving.predict import (InteractivePredictor,
                                                resolve_input_path)
from tests.test_torch_model import to_port
from tests.test_train_overfit import make_dataset

JAVA = '''class Shapes {
    int getSquare(int x) { return x * x; }
    boolean isEmpty(java.util.List<String> items) {
        if (items == null) { return true; }
        for (String item : items) { if (item.length() > 0) return false; }
        return items.size() == 0;
    }
    void setName(String name) { this.name = name.trim(); }
}
'''
CSHARP = '''class Shapes {
    int GetSquare(int x) { return x * x; }
    bool IsEmpty(List<string> items) { return items == null || items.Count == 0; }
}
'''
OK_BODY = "print('get|name a,somePath,b c,otherPath,d')\n"


@pytest.fixture(scope='module')
def binary():
    return build_extractor()


@pytest.mark.parametrize('source, name, max_contexts', [
    (JAVA, 'Input.java', 200), (JAVA, 'Input.java', 5),
    (CSHARP, 'Input.cs', 200), (CSHARP, 'Input.cs', 3)])
def test_extractor_matches_reference(tmp_path, binary, source, name,
                                     max_contexts):
    path = tmp_path / name
    path.write_text(source)
    got = Extractor(Config(MAX_CONTEXTS=max_contexts),
                    extractor_command=[binary]).extract_paths(str(path))
    want = jax_bridge.Extractor(
        JaxConfig(MAX_CONTEXTS=max_contexts),
        extractor_command=[binary]).extract_paths(str(path))
    assert got == want
    lines, unhash = got
    assert len(lines) == (3 if name.endswith('.java') else 2)
    for line in lines:
        parts = line.split(' ')
        assert len(parts) == max_contexts + 1
        for context in filter(None, parts[1:]):
            _s, hashed, _t = context.split(',')
            assert str(common.java_string_hashcode(unhash[hashed])) == hashed
    assert infer_language(name) == ('java' if name.endswith('.java')
                                    else 'csharp')


def test_default_extractor_is_the_built_one(tmp_path, binary):
    (tmp_path / 'A.java').write_text(JAVA)
    extractor = Extractor(Config())
    assert extractor.command == [binary]
    assert extractor.extract_paths(str(tmp_path / 'A.java'))[0]


@pytest.mark.parametrize('text', ['', 'a', 'getSquare', '(Name)^(Call)',
                                  'ümlaut|ß', 'x' * 300])
def test_java_hashcode_matches_reference(text):
    assert common.java_string_hashcode(text) == \
        jax_common.java_string_hashcode(text)


# ------------------------------------------------------------ fake commands
def _script(tmp_path, name, body):
    path = tmp_path / name
    path.write_text(body)
    return [sys.executable, str(path)]


def _flaky(tmp_path, failures):
    marker = tmp_path / 'attempts'
    return marker, _script(
        tmp_path, 'flaky.py',
        "import os, sys\n"
        "path = %r\n"
        "n = int(open(path).read()) if os.path.exists(path) else 0\n"
        "open(path, 'w').write(str(n + 1))\n"
        "if n < %d:\n"
        "    sys.stderr.write('transient')\n"
        "    sys.exit(1)\n"
        "%s" % (str(marker), failures, OK_BODY))


class FakeClock:
    def __init__(self):
        self.now = 100.0
        self.slept = []

    def __call__(self):
        return self.now

    def sleep(self, seconds):
        self.slept.append(seconds)


def _pool(command, clock=None, **knobs):
    clock = clock or FakeClock()
    config = Config(MAX_CONTEXTS=6, **knobs)
    return ExtractorPool(config, extractor_command=command, clock=clock,
                         sleep=clock.sleep)


def test_wedged_extractor_times_out_typed(tmp_path):
    command = _script(tmp_path, 'wedge.py',
                      "import sys, time\n"
                      "sys.stderr.write('stuck in a loop')\n"
                      "sys.stderr.flush()\n"
                      "time.sleep(600)\n")
    extractor = Extractor(Config(EXTRACTOR_TIMEOUT_SECS=0.5),
                          extractor_command=command)
    with pytest.raises(ExtractorCrash, match='timed out'):
        extractor.extract_paths(str(tmp_path / 'T.java'))


@pytest.mark.parametrize('body, error, match', [
    ("import sys\nsys.stderr.write('parse table corrupt')\nsys.exit(3)\n",
     ExtractorCrash, 'parse table corrupt'),
    ("pass\n", ValueError, 'cannot extract any paths'),
])
def test_crash_and_content_errors_are_typed(tmp_path, body, error, match):
    extractor = Extractor(Config(), extractor_command=_script(
        tmp_path, 'x.py', body))
    with pytest.raises(error, match=match) as info:
        extractor.extract_paths(str(tmp_path / 'T.java'))
    assert isinstance(info.value, ExtractorCrash) == (error is ExtractorCrash)


def test_spawn_failure_is_a_crash_and_timeout_zero_is_unbounded(tmp_path):
    missing = Extractor(Config(), extractor_command=[str(tmp_path / 'no')])
    with pytest.raises(ExtractorCrash, match='failed to run'):
        missing.extract_paths(str(tmp_path / 'T.java'))
    ok = Extractor(Config(EXTRACTOR_TIMEOUT_SECS=0.0),
                   extractor_command=_script(tmp_path, 'ok.py', OK_BODY))
    lines, unhash = ok.extract_paths(str(tmp_path / 'T.java'))
    assert len(lines) == 1 and set(unhash.values()) == {'somePath',
                                                          'otherPath'}


def test_pool_retries_with_backoff(tmp_path):
    marker, command = _flaky(tmp_path, 2)
    clock = FakeClock()
    with _pool(command, clock, EXTRACTOR_RETRIES=2,
               EXTRACTOR_BACKOFF_SECS=0.5) as pool:
        lines, _ = pool.extract_paths(str(tmp_path / 'T.java'))
    assert len(lines) == 1 and marker.read_text() == '3'
    assert pool.retries_total == 2 and clock.slept == [0.5, 1.0]
    assert pool.state() == 'closed'


def test_pool_raises_the_last_crash_and_does_not_retry_content(tmp_path):
    crash = _script(tmp_path, 'crash.py', "import sys\n"
                    "sys.stderr.write('always down')\nsys.exit(1)\n")
    with _pool(crash, EXTRACTOR_RETRIES=1,
               EXTRACTOR_BREAKER_THRESHOLD=99) as pool:
        with pytest.raises(ExtractorCrash, match='always down'):
            pool.extract_paths(str(tmp_path / 'T.java'))
        assert pool.retries_total == 1
    with _pool(_script(tmp_path, 'empty.py', 'pass\n'),
               EXTRACTOR_RETRIES=3) as pool:
        with pytest.raises(ValueError) as info:
            pool.extract_paths(str(tmp_path / 'T.java'))
        assert not isinstance(info.value, ExtractorError)
        assert pool.retries_total == 0 and pool.state() == 'closed'


def test_breaker_opens_fails_fast_and_recovers(tmp_path):
    marker, command = _flaky(tmp_path, 2)
    clock = FakeClock()
    with _pool(command, clock, EXTRACTOR_RETRIES=0,
               EXTRACTOR_BREAKER_THRESHOLD=2,
               EXTRACTOR_BREAKER_COOLDOWN_SECS=30.0) as pool:
        for _ in range(2):
            with pytest.raises(ExtractorCrash, match='transient'):
                pool.extract_paths(str(tmp_path / 'T.java'))
        assert pool.state() == 'open' and pool.breaker_open_total == 1
        with pytest.raises(ExtractorUnavailable):
            pool.extract_paths(str(tmp_path / 'T.java'))
        assert marker.read_text() == '2'          # no process started
        clock.now += 29.0
        with pytest.raises(ExtractorUnavailable):
            pool.extract_paths(str(tmp_path / 'T.java'))
        clock.now += 1.0                          # the cooldown is over
        lines, _ = pool.extract_paths(str(tmp_path / 'T.java'))
        assert len(lines) == 1 and pool.state() == 'closed'
        pool.extract_paths(str(tmp_path / 'T.java'))
        assert marker.read_text() == '4'


def test_half_open_probe_crash_reopens(tmp_path):
    marker, command = _flaky(tmp_path, 2)
    clock = FakeClock()
    with _pool(command, clock, EXTRACTOR_RETRIES=0,
               EXTRACTOR_BREAKER_THRESHOLD=1,
               EXTRACTOR_BREAKER_COOLDOWN_SECS=5.0) as pool:
        with pytest.raises(ExtractorCrash):
            pool.extract_paths(str(tmp_path / 'T.java'))
        assert pool.state() == 'open'
        clock.now += 5.0
        with pytest.raises(ExtractorCrash):      # the probe crashes
            pool.extract_paths(str(tmp_path / 'T.java'))
        assert pool.state() == 'open' and pool.breaker_open_total == 2
        clock.now += 5.0
        pool.extract_paths(str(tmp_path / 'T.java'))
        assert pool.state() == 'closed'


def test_unexpected_probe_error_releases_the_slot(tmp_path):
    marker, command = _flaky(tmp_path, 1)
    clock = FakeClock()
    with _pool(command, clock, EXTRACTOR_RETRIES=0,
               EXTRACTOR_BREAKER_THRESHOLD=1,
               EXTRACTOR_BREAKER_COOLDOWN_SECS=1.0) as pool:
        with pytest.raises(ExtractorCrash):
            pool.extract_paths(str(tmp_path / 'T.java'))
        clock.now += 1.0
        real = pool.extractor.extract_paths
        pool.extractor.extract_paths = lambda path: (_ for _ in ()).throw(
            RuntimeError('weird'))
        with pytest.raises(RuntimeError, match='weird'):
            pool.extract_paths(str(tmp_path / 'T.java'))
        pool.extractor.extract_paths = real
        pool.extract_paths(str(tmp_path / 'T.java'))
        assert pool.state() == 'closed'


# -------------------------------------------------------------------- shell
def _numbers_and_text(report):
    """The report's text with numbers cut out, and the numbers."""
    number = r'-?\d+\.\d+'
    return re.sub(number, '#', report), [float(x) for x in
                                         re.findall(number, report)]


def _run_shell(predictor, monkeypatch, capsys, answers):
    replies = iter(answers)
    monkeypatch.setattr('builtins.input', lambda: next(replies))
    predictor.predict()
    return capsys.readouterr().out


@pytest.mark.parametrize('name', ['Input.java', 'Input.cs'])
def test_shell_report_matches_reference(tmp_path, binary, monkeypatch,
                                        capsys, name):
    prefix = make_dataset(tmp_path)
    shared = dict(TRAIN_DATA_PATH_PREFIX=str(prefix), MAX_CONTEXTS=6,
                  COMPUTE_DTYPE='float32')
    reference = JaxModel(JaxConfig(DL_FRAMEWORK='jax', VERBOSE_MODE=0,
                                   READER_USE_NATIVE=False, **shared))
    port = Code2VecModel(Config(**shared), device='cpu',
                         params=to_port(reference.params))
    source = tmp_path / name
    source.write_text(JAVA if name.endswith('.java') else CSHARP)
    # a missing Input.java resolves to its one sibling, Input.cs
    asked = str(tmp_path / 'Input.java')
    assert resolve_input_path(asked) == str(source)
    answers = ['', 'go', 'exit']
    want = _run_shell(JaxPredictor(
        reference.config, reference, extractor=jax_bridge.Extractor(
            reference.config, extractor_command=[binary]),
        input_filename=asked), monkeypatch, capsys, answers)
    got = _run_shell(InteractivePredictor(
        port.config, port, extractor=Extractor(port.config,
                                               extractor_command=[binary]),
        input_filename=asked), monkeypatch, capsys, answers)
    got_text, got_numbers = _numbers_and_text(got)
    want_text, want_numbers = _numbers_and_text(want)
    assert got_text == want_text
    assert got_numbers == pytest.approx(want_numbers, abs=1e-5)
    assert got.count('Original name:') == (6 if name.endswith('.java')
                                           else 4)
    assert 'Attention:' in got and got.endswith('Exiting...\n')


def test_shell_prompts_again_after_an_extraction_error(tmp_path, binary,
                                                       monkeypatch, capsys):
    prefix = make_dataset(tmp_path)
    port = Code2VecModel(Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                                MAX_CONTEXTS=6), device='cpu')
    source = tmp_path / 'Empty.java'
    source.write_text('interface I { }\n')      # no method
    out = _run_shell(InteractivePredictor(
        port.config, port, extractor=Extractor(port.config, [binary]),
        input_filename=str(source)), monkeypatch, capsys, ['', 'q'])
    assert 'cannot extract any paths' in out and out.endswith('Exiting...\n')


def test_cli_predict(tmp_path, binary, monkeypatch, capsys):
    prefix = make_dataset(tmp_path)
    save = tmp_path / 'models' / 'saved_model'
    cpu = ['--device', 'cpu', '-v', '0']
    cli.main(['--data', str(prefix), '--save', str(save), '--epochs', '1']
             + cpu)
    source = tmp_path / 'Input.java'
    source.write_text(JAVA)
    replies = iter(['', 'quit'])
    monkeypatch.setattr('builtins.input', lambda: next(replies))
    model = cli.main(['--load', str(save), '--predict', '--input-file',
                      str(source), '--extractor-timeout', '20'] + cpu)
    assert model.config.PREDICT and model.config.EXTRACTOR_TIMEOUT_SECS == 20
    out = capsys.readouterr().out
    assert out.startswith('Starting interactive prediction...')
    assert out.count('Original name:') == 3
    assert 'Original name:\tget|square' in out
