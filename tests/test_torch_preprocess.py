"""The port's offline tools against the reference's: ``data/preprocess.py``
writes ``.c2v`` splits and ``.dict.c2v`` byte for byte as
``code2vec_tpu/data/preprocess.py`` does with the same seed (tiered
sampling of rows past MAX_CONTEXTS, empty rows dropped, histograms built
or read), and ``data/extract_driver.py`` writes what the reference's
driver writes, both running the port's extractor (built from
``extractor/src`` into ``build/extractor/``), on a tree with a poison
file that recursion isolates."""
import io
import random
import sys

import pytest

from code2vec_tpu import common as jax_common
from code2vec_tpu.data import extract_driver as jax_driver
from code2vec_tpu.data import preprocess as jax_preprocess
from code2vec_tpu_torch import common
from code2vec_tpu_torch.data import extract_driver, preprocess
from code2vec_tpu_torch.serving.extractor_bridge import build_extractor


def write_raw(path, n, seed):
    """Raw extractor output: rows of 0 to 14 contexts over a Zipf-ish
    vocabulary, so MAX_CONTEXTS=6 samples by tier."""
    rng = random.Random(seed)

    def word(kind, n_words):
        return '%s%d' % (kind, int(rng.paretovariate(1.2)) % n_words)

    lines = []
    for _ in range(n):
        contexts = ['%s,%s,%s' % (word('t', 40), word('p', 30),
                                  word('t', 40))
                    for _ in range(rng.randrange(0, 15))]
        lines.append(' '.join([word('name', 12)] + contexts))
    path.write_text('\n'.join(lines) + '\n')


def _outputs(prefix):
    return {role: open('%s.%s' % (prefix, role), 'rb').read()
            for role in ('train.c2v', 'val.c2v', 'test.c2v', 'dict.c2v')}


@pytest.mark.parametrize('seed', [0, 1, 17])
@pytest.mark.parametrize('histograms', [False, True])
def test_preprocess_is_byte_equal_to_reference(tmp_path, seed, histograms):
    raws = {}
    for i, role in enumerate(('train', 'val', 'test')):
        raws[role] = tmp_path / ('%s.raw' % role)
        write_raw(raws[role], (300, 40, 40)[i], seed * 10 + i)
    extra = []
    if histograms:
        tokens, paths, targets = preprocess.build_histograms(
            str(raws['train']))
        for flag, name, counts in (('-wh', 'w', tokens), ('-ph', 'p', paths),
                                   ('-th', 't', targets)):
            preprocess.save_histogram(counts, str(tmp_path / name))
            extra += [flag, str(tmp_path / name)]
    args = ['-trd', str(raws['train']), '-vd', str(raws['val']),
            '-ted', str(raws['test']), '-mc', '6', '-wvs', '25', '-pvs',
            '20', '-tvs', '8', '--seed', str(seed)] + extra
    jax_preprocess.main(args + ['-o', str(tmp_path / 'want')])
    preprocess.main(args + ['-o', str(tmp_path / 'got')])
    got, want = _outputs(tmp_path / 'got'), _outputs(tmp_path / 'want')
    assert got == want
    # the sampling ran: rows were cut to MAX_CONTEXTS and some dropped
    train = got['train.c2v'].decode().splitlines()
    assert all(len(line.split(' ')) == 7 for line in train)
    assert len(train) < 300


def test_histogram_helpers_match_reference(tmp_path):
    counts = {'a': 10, 'b': 8, 'c': 8, 'd': 5, 'e': 1}
    for size in (1, 2, 3, 5, 9):
        assert common.truncate_histogram_to_max_size(counts, size) == \
            jax_preprocess.truncate_to_max_size(counts, size)
    path = tmp_path / 'hist'
    path.write_text('a 10\nb 8\nbad line here\nc 8\na 3\nd 5\n')
    for kwargs in ({}, {'max_size': 2}, {'min_count': 6}):
        assert common.load_histogram(str(path), **kwargs) == \
            jax_common.load_histogram(str(path), **kwargs)


@pytest.fixture(scope='module')
def extractor():
    return build_extractor()


def _tree(root):
    good = root / 'projA' / 'src'
    good.mkdir(parents=True)
    (good / 'Good.java').write_text(
        'class G { int add(int a, int b) { return a + b; } }')
    (good / 'Also.java').write_text(
        'class H { int sub(int a, int b) { if (a > b) { return a - b; } '
        'return b - a; } }')
    (root / 'Loose.java').write_text('class L { int one() { return 1; } }')
    bad = root / 'projB'
    bad.mkdir()
    (bad / 'Bad.java').write_text('class B { int f() { return 2; } }')
    (bad / 'Fine.java').write_text(
        'class F { String g(String s) { return s.trim(); } }')


def _poison_wrapper(tmp_path, binary):
    """Fails on ``--dir projB`` and on the Bad file, so the driver must
    recurse into projB to keep Fine.java."""
    wrapper = tmp_path / 'wrapper.py'
    wrapper.write_text(
        'import subprocess, sys\n'
        'args = sys.argv[1:]\n'
        'if any(a.endswith("projB") or "Bad" in a for a in args):\n'
        '    sys.exit(1)\n'
        'r = subprocess.run([%r] + args, capture_output=True, text=True)\n'
        'sys.stdout.write(r.stdout)\n'
        'sys.exit(r.returncode)\n' % binary)
    return [sys.executable, str(wrapper)]


@pytest.mark.parametrize('poison', [False, True])
def test_extract_driver_matches_reference(tmp_path, extractor, poison):
    root = tmp_path / 'src'
    _tree(root)
    runs = {}
    for name, module in (('got', extract_driver), ('want', jax_driver)):
        command = (_poison_wrapper(tmp_path, extractor) if poison
                   else [extractor])
        logs = []
        driver = module.ExtractionDriver(command, timeout_seconds=60,
                                         log=logs.append)
        out = io.StringIO()
        driver.extract(str(root), out, workers=1)
        # the extractor's threads write a directory's methods in any
        # order: the lines are compared as a multiset
        runs[name] = (sorted(out.getvalue().splitlines()),
                      driver.nr_failed_files, driver.nr_extracted_dirs,
                      sorted(logs))
    assert runs['got'] == runs['want']
    lines, failed, _dirs, logs = runs['got']
    labels = sorted(line.split(' ')[0] for line in lines)
    if poison:
        assert labels == ['add', 'g', 'one', 'sub'] and failed == 1
        assert any('poison' in m for m in logs)
    else:
        assert labels == ['add', 'f', 'g', 'one', 'sub'] and failed == 0


def test_extract_driver_cli_writes_the_file(tmp_path, extractor):
    root = tmp_path / 'src'
    _tree(root)
    out = tmp_path / 'raw.txt'
    extract_driver.main(['--dir', str(root), '--output', str(out),
                         '--workers', '2'])
    labels = sorted(line.split(' ')[0]
                    for line in out.read_text().splitlines())
    assert labels == ['add', 'f', 'g', 'one', 'sub']
