"""The port's native tokenizer (``code2vec_tpu_torch/data/native.py``, the
top-level ``native/tokenizer.cpp`` built into ``build/native/``) against
the reference's ``code2vec_tpu/data/native.py`` and against the port's
Python tokenizer, on the edge cases of tests/test_native_tokenizer.py and
more: missing and empty parts, OOV words and labels, rows past
MAX_CONTEXTS, ``\\r\\n`` endings, non-ASCII words, both PAD/OOV
policies, the multithreaded large batch. Arrays bit-equal. A tokenizer
that does not build raises and names READER_USE_NATIVE."""
import os
import pickle

import numpy as np
import pytest

from code2vec_tpu.config import Config as JaxConfig
from code2vec_tpu.data import native as jax_native
from code2vec_tpu.vocab import Code2VecVocabs as JaxVocabs
from code2vec_tpu_torch import hostbuild
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data import native
from code2vec_tpu_torch.data.reader import PathContextReader
from code2vec_tpu_torch.vocab import Code2VecVocabs

FIELDS = ('source', 'path', 'target', 'mask', 'label', 'weight')

LINES = [
    'lbl1 s1,p1,t1 zzz,p2,t1 s2,qqq,qq  ',
    ' s1,p1,t1',                  # empty label
    'unknownlbl s1,p1,t1',
    'lbl2 zz,zz,zz',              # every part OOV
    'lbl2 s2,p2,t1 s1,p1',        # a context of two parts
    'lbl1 ,, s1,p1,t1',           # empty parts
    'onlylabel',
    'lbl1 s1',                    # a context of one part
    'lbl1 s1,p1,t1\r\n',          # CRLF
    'lbl2 s2,p2,t1\n',
    'lbl1 s1,p1,t1 s2,p2,t1 s1,p2,t1 s2,p1,t1 s1,p1,t1 s2,p2,t1',  # > 4
    'ñame|ü é,pé,t1 s1,p1,é',     # non-ASCII label and words
    'lbl1  s1,p1,t1',             # a doubled space holds a slot
]
# a context of more than three parts: the C++ tokenizer (the reference's
# as well) reads 't1,extra' as the target, the Python one 't1'; no
# extractor writes one, so it is held only between the native tokenizers
FOUR_PARTS = ['lbl2 s1,p1,t1,extra s2,,t1']


@pytest.fixture(params=[False, True], ids=['joined', 'separate'])
def setup(tmp_path, request):
    prefix = tmp_path / 'ds'
    with open(str(prefix) + '.dict.c2v', 'wb') as f:
        pickle.dump({'s1': 10, 's2': 9, 't1': 8, 'é': 7}, f)
        pickle.dump({'p1': 7, 'p2': 6, 'pé': 5}, f)
        pickle.dump({'lbl1': 5, 'lbl2': 4, 'ñame|ü': 3}, f)
        pickle.dump(4, f)
    knobs = dict(TRAIN_DATA_PATH_PREFIX=str(prefix), MAX_CONTEXTS=4,
                 TRAIN_BATCH_SIZE=3, TEST_BATCH_SIZE=3,
                 SEPARATE_OOV_AND_PAD=request.param)
    jax_config = JaxConfig(VERBOSE_MODE=0, **knobs)
    config = Config(**knobs)
    return (prefix, jax_config, JaxVocabs(jax_config), config,
            Code2VecVocabs(config))


def _assert_equal(got, want, fields=FIELDS):
    for field in fields:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize('lines', [LINES, LINES * 40],
                         ids=['edge_cases', 'multithreaded'])
def test_native_matches_reference_and_python(setup, lines):
    _, jax_config, jax_vocabs, config, vocabs = setup
    tokenizer = native.get_tokenizer(vocabs, config)
    assert tokenizer.num_threads == config.READER_NUM_PARALLEL_BATCHES > 1
    reference = jax_native.get_tokenizer(jax_vocabs, jax_config)
    _assert_equal(tokenizer.tokenize_lines(lines + FOUR_PARTS),
                  reference.tokenize_lines(lines + FOUR_PARTS))
    got = tokenizer.tokenize_lines(lines)
    python = PathContextReader(
        vocabs, Config(**dict(vars(config), READER_USE_NATIVE=False)))
    _assert_equal(python.tokenize_lines(lines), got)
    assert got.source.shape == (len(lines), config.MAX_CONTEXTS)


def test_tokenizer_is_cached_per_vocabs_and_max_contexts(setup):
    _, _, _, config, vocabs = setup
    first = native.get_tokenizer(vocabs, config)
    assert native.get_tokenizer(vocabs, config) is first
    wider = Config(**dict(vars(config), MAX_CONTEXTS=6))
    other = native.get_tokenizer(vocabs, wider)
    assert other is not first
    assert other.tokenize_lines(LINES).source.shape == (len(LINES), 6)


@pytest.mark.parametrize('evaluate', [False, True])
@pytest.mark.parametrize('wire', ['planes', 'packed'])
def test_reader_epochs_equal_across_tokenizers(setup, evaluate, wire):
    """Whole epochs of the train split (shuffled) and of the test split
    (with its label strings) through each tokenizer."""
    prefix, _, _, config, vocabs = setup
    for role in ('train', 'val'):
        with open('%s.%s.c2v' % (prefix, role), 'w') as f:
            f.write('\n'.join(LINES * 3) + '\n')
    knobs = dict(vars(config), BATCH_WIRE_FORMAT=wire,
                 TEST_DATA_PATH=str(prefix) + '.val.c2v')
    native_reader = PathContextReader(vocabs, Config(**knobs))
    python_reader = PathContextReader(
        vocabs, Config(**dict(knobs, READER_USE_NATIVE=False)))
    got = list(native_reader.iter_epoch(seed=3, evaluate=evaluate))
    want = list(python_reader.iter_epoch(seed=3, evaluate=evaluate))
    assert native_reader._native is not None
    assert python_reader._native is None
    assert len(got) == len(want) > 3
    fields = (('ctx', 'count', 'label', 'weight') if wire == 'packed'
              else FIELDS)
    for g, w in zip(got, want):
        _assert_equal(g, w, fields)
        if evaluate:
            assert list(g.label_strings) == list(w.label_strings)
        else:
            assert g.label_strings is None
        assert g.source_strings is None


def test_predict_keeps_the_python_tokenizer(setup):
    _, _, _, config, vocabs = setup
    reader = PathContextReader(vocabs, config)
    batch = reader.process_input_rows(['lbl1 s1,p1,t1'])
    assert reader._native is None
    assert batch.source_strings[0, 0] == 's1'


def test_failed_build_raises_and_names_the_knob(setup, tmp_path,
                                                monkeypatch):
    _, _, _, config, _ = setup
    broken = tmp_path / 'tokenizer.cpp'
    broken.write_text('this is not C++;\n')
    monkeypatch.setattr(native, 'SOURCE', str(broken))
    monkeypatch.setattr(native, 'LIBRARY', str(tmp_path / 'lib' / 'tok.so'))
    vocabs = Code2VecVocabs(config)      # no tokenizer cached on it yet
    reader = PathContextReader(vocabs, config)
    with pytest.raises(RuntimeError, match='READER_USE_NATIVE') as exc:
        reader.tokenize_lines(LINES)
    assert 'error' in str(exc.value)     # g++'s own message
    assert not (tmp_path / 'lib' / 'tok.so').exists()
    # the Python tokenizer is the explicit way round it
    python = PathContextReader(
        vocabs, Config(**dict(vars(config), READER_USE_NATIVE=False)))
    assert python.tokenize_lines(LINES).source.shape == (len(LINES), 4)


def test_stale_library_is_rebuilt(tmp_path):
    source = tmp_path / 'tokenizer.cpp'
    source.write_text(open(native.SOURCE).read())
    library = tmp_path / 'build' / 'libtok.so'
    assert hostbuild.build(str(library), str(source), native.GXX_FLAGS)
    assert not hostbuild.build(str(library), str(source), native.GXX_FLAGS)
    stat = os.stat(library)
    os.utime(source, ns=(stat.st_atime_ns, stat.st_mtime_ns + 10 ** 9))
    assert hostbuild.build(str(library), str(source), native.GXX_FLAGS)
    assert not list((tmp_path / 'build').glob('*.tmp'))
