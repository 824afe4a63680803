"""The port's token cache (``code2vec_tpu_torch/data/cache.py``) against
the reference's ``code2vec_tpu/data/cache.py`` on the same split: the
files on disk byte for byte, ``meta.json`` equal, every epoch's batches
equal in order on both wires (several seeds, batch sizes and chunk
sizes, the padded tail included), a cache either package built served
by the other without a rebuild, a v1 cache read, truncated and corrupt
shards refused, a stale fingerprint rebuilt. Exact equality throughout:
the cache moves int32 indices only."""
import json
import os
import pickle
import random

import numpy as np
import pytest

from code2vec_tpu.config import Config as JaxConfig
from code2vec_tpu.data.cache import TokenCache as JaxCache
from code2vec_tpu.data.reader import EstimatorAction
from code2vec_tpu.data.reader import PathContextReader as JaxReader
from code2vec_tpu.vocab import Code2VecVocabs as JaxVocabs
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data import packed as packed_lib
from code2vec_tpu_torch.data.cache import TokenCache
from code2vec_tpu_torch.data.reader import PathContextReader
from code2vec_tpu_torch.vocab import Code2VecVocabs

from tests.test_cache import _write_v1_cache

FILES = ('ctx.bin', 'count.bin', 'label.bin', 'meta.json')


def write_corpus(prefix, n_lines=90, seed=0, max_contexts=4):
    """A split with OOV labels and parts, rows past MAX_CONTEXTS, rows
    with no valid context and empty slots; its ``.dict.c2v`` counts the
    in-vocabulary words."""
    rng = random.Random(seed)
    with open(str(prefix) + '.dict.c2v', 'wb') as f:
        pickle.dump({'s%d' % i: 20 - i for i in range(10)}, f)
        pickle.dump({'p%d' % i: 10 - i for i in range(6)}, f)
        pickle.dump({'l%d' % i: 9 - i for i in range(5)}, f)
        pickle.dump(n_lines, f)

    def part(kind, n):
        return ('%s%d' % (kind, rng.randrange(n)) if rng.random() < 0.85
                else 'oov%d' % rng.randrange(3))

    lines = []
    for _ in range(n_lines):
        contexts = ['%s,%s,%s' % (part('s', 10), part('p', 6), part('s', 10))
                    for _ in range(rng.randrange(0, 2 * max_contexts))]
        if contexts and rng.random() < 0.1:
            contexts[rng.randrange(len(contexts))] = ''
        if rng.random() < 0.08:
            contexts = ['x,y,z']
        label = 'l%d' % rng.randrange(5) if rng.random() < 0.9 else 'unk'
        lines.append(' '.join([label] + contexts))
    with open(str(prefix) + '.train.c2v', 'w') as f:
        f.write('\n'.join(lines) + '\n')


def pair(prefix, batch_size=8, native=True):
    knobs = dict(TRAIN_DATA_PATH_PREFIX=str(prefix), MAX_CONTEXTS=4,
                 TRAIN_BATCH_SIZE=batch_size, READER_USE_NATIVE=native)
    jax_config = JaxConfig(VERBOSE_MODE=0, **knobs)
    jax_vocabs = JaxVocabs(jax_config)
    config = Config(**knobs)
    vocabs = Code2VecVocabs(config)
    return (jax_config, jax_vocabs,
            JaxReader(jax_vocabs, jax_config, EstimatorAction.Train),
            config, vocabs, PathContextReader(vocabs, config))


@pytest.fixture
def corpus(tmp_path):
    prefix = tmp_path / 'ds'
    write_corpus(prefix)
    return prefix


def _read_files(cache_dir):
    return {name: open(os.path.join(cache_dir, name), 'rb').read()
            for name in FILES}


@pytest.mark.parametrize('native', [True, False])
def test_cache_files_byte_equal_to_reference(corpus, native):
    jax_config, jax_vocabs, jax_reader, config, vocabs, reader = pair(
        corpus, native=native)
    assert vocabs.content_hash() == jax_vocabs.content_hash()
    want = JaxCache.build_or_load(jax_config, jax_vocabs, jax_reader)
    want_files = _read_files(want.cache_dir)
    os.rename(want.cache_dir, want.cache_dir + '.reference')
    got = TokenCache.build_or_load(config, vocabs, reader)
    assert got.cache_dir == want.cache_dir
    assert sorted(os.listdir(got.cache_dir)) == sorted(FILES[:3] + (
        'meta.json',))
    assert _read_files(got.cache_dir) == want_files
    assert got.meta == want.meta
    assert (got.num_rows, got.num_contexts, got.version) == (
        want.num_rows, want.num_contexts, 2)
    assert got.nbytes == sum(len(b) for b in want_files.values())


def _assert_batches_equal(got, want, wire):
    assert len(got) == len(want)
    fields = (('ctx', 'count', 'label', 'weight') if wire == 'packed'
              else ('source', 'path', 'target', 'mask', 'label', 'weight'))
    for k, (g, w) in enumerate(zip(got, want)):
        if wire == 'packed':
            assert isinstance(g, packed_lib.PackedBatch)
            assert w.ctx.shape[0] == 1
        for field in fields:
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.shape == b.shape, (k, field)
            np.testing.assert_array_equal(a, b, err_msg='%d %s' % (k, field))
            assert a.flags.writeable and a.flags.c_contiguous, (k, field)


@pytest.mark.parametrize('wire', ['planes', 'packed'])
@pytest.mark.parametrize('batch_size, seed, chunk_rows, shuffle', [
    (8, 0, 1 << 16, True), (8, 1, 16, True), (5, 2, 7, True),
    (16, 3, 32, True), (8, None, 16, False), (64, 4, 16, True)])
def test_iter_epoch_matches_reference(corpus, wire, batch_size, seed,
                                      chunk_rows, shuffle):
    jax_config, jax_vocabs, jax_reader, config, vocabs, reader = pair(
        corpus, batch_size)
    want_cache = JaxCache.build_or_load(jax_config, jax_vocabs, jax_reader)
    got_cache = TokenCache(want_cache.cache_dir, config, vocabs)
    for epoch in range(2):       # the sticky capacity carries over
        kwargs = dict(shuffle=shuffle, chunk_rows=chunk_rows,
                      wire_format=wire,
                      seed=None if seed is None else seed + epoch)
        want = list(want_cache.iter_epoch(batch_size, **kwargs))
        got = list(got_cache.iter_epoch(batch_size, **kwargs))
        _assert_batches_equal(got, want, wire)
        # the padded tail
        assert got[-1].weight.shape == (batch_size,)
        assert got[-1].weight.sum() == (got_cache.num_rows % batch_size
                                        or batch_size)


def _mtimes(cache_dir):
    return {name: os.stat(os.path.join(cache_dir, name)).st_mtime_ns
            for name in FILES}


@pytest.mark.parametrize('first', ['reference', 'port'])
def test_cache_built_by_either_package_serves_the_other(corpus, first):
    jax_config, jax_vocabs, jax_reader, config, vocabs, reader = pair(
        corpus)
    if first == 'reference':
        built = JaxCache.build_or_load(jax_config, jax_vocabs, jax_reader)
    else:
        built = TokenCache.build_or_load(config, vocabs, reader)
    stamps = _mtimes(built.cache_dir)
    got = TokenCache.build_or_load(config, vocabs, reader)
    want = JaxCache.build_or_load(jax_config, jax_vocabs, jax_reader)
    assert _mtimes(built.cache_dir) == stamps        # no rebuild
    for wire in ('planes', 'packed'):
        _assert_batches_equal(
            list(got.iter_epoch(8, seed=5, chunk_rows=16, wire_format=wire)),
            list(want.iter_epoch(8, seed=5, chunk_rows=16,
                                 wire_format=wire)), wire)


def test_v1_cache_is_read_and_not_rebuilt(corpus):
    jax_config, jax_vocabs, jax_reader, config, vocabs, reader = pair(
        corpus)
    cache_dir = str(corpus) + '.train.c2v.tokcache'
    _write_v1_cache(cache_dir, jax_config, jax_vocabs, jax_reader)
    got = TokenCache.build_or_load(config, vocabs, reader)
    want = JaxCache.build_or_load(jax_config, jax_vocabs, jax_reader)
    assert got.version == want.version == 1
    assert not os.path.exists(os.path.join(cache_dir, 'ctx.bin'))
    for wire in ('planes', 'packed'):
        _assert_batches_equal(
            list(got.iter_epoch(8, seed=7, chunk_rows=16, wire_format=wire)),
            list(want.iter_epoch(8, seed=7, chunk_rows=16,
                                 wire_format=wire)), wire)


def _truncate_ctx(cache_dir):
    path = os.path.join(cache_dir, 'ctx.bin')
    with open(path, 'r+b') as f:
        f.truncate(os.path.getsize(path) - 4)


def _break_counts(cache_dir):
    path = os.path.join(cache_dir, 'count.bin')
    counts = np.fromfile(path, dtype=np.int32).copy()
    counts[0] += 1          # the same size, offsets that do not add up
    counts.tofile(path)


def _truncate_label(cache_dir):
    path = os.path.join(cache_dir, 'label.bin')
    with open(path, 'r+b') as f:
        f.truncate(os.path.getsize(path) - 8)


@pytest.mark.parametrize('damage', [_truncate_ctx, _break_counts,
                                    _truncate_label])
def test_damaged_shard_raises(corpus, damage):
    _, _, _, config, vocabs, reader = pair(corpus)
    cache = TokenCache.build_or_load(config, vocabs, reader)
    damage(cache.cache_dir)
    with pytest.raises(ValueError, match='rebuild'):
        TokenCache(cache.cache_dir, config, vocabs)


def _set_mtime(path, delta):
    stat = os.stat(path)
    os.utime(path, ns=(stat.st_atime_ns, stat.st_mtime_ns + delta))


@pytest.mark.parametrize('change', ['rows', 'same_size', 'vocab'])
def test_stale_fingerprint_rebuilds(tmp_path, change):
    prefix = tmp_path / 'ds'
    write_corpus(prefix, seed=1)
    _, _, _, config, vocabs, reader = pair(prefix)
    first = TokenCache.build_or_load(config, vocabs, reader)
    train = str(prefix) + '.train.c2v'
    lines = open(train).read().splitlines()
    if change == 'rows':
        write_corpus(prefix, n_lines=60, seed=2)
    elif change == 'same_size':
        # a rewrite within one mtime tick keeps size and mtime: the
        # fingerprint cannot see it, so the test moves the mtime on
        stat = os.stat(train)
        with open(train, 'w') as f:
            f.write('\n'.join(lines[::-1]) + '\n')
        os.utime(train, ns=(stat.st_atime_ns, stat.st_mtime_ns))
        assert TokenCache.build_or_load(config, vocabs, reader).meta == \
            first.meta
        _set_mtime(train, 10 ** 9)
    else:
        with open(str(prefix) + '.dict.c2v', 'wb') as f:
            # the same sizes, other words at the indices
            pickle.dump({'s%d' % i: 10 + i for i in range(10)}, f)
            pickle.dump({'p%d' % i: 10 - i for i in range(6)}, f)
            pickle.dump({'l%d' % i: 9 - i for i in range(5)}, f)
            pickle.dump(90, f)
        vocabs = Code2VecVocabs(config)
        reader = PathContextReader(vocabs, config)
    second = TokenCache.build_or_load(config, vocabs, reader)
    assert second.meta != first.meta
    fresh = list(reader.iter_epoch(shuffle=False, wire_format='planes'))
    rows = sum(int(b.weight.sum()) for b in fresh)
    assert second.num_rows == rows
    want = json.load(open(os.path.join(second.cache_dir, 'meta.json')))
    assert want['data_mtime'] == os.stat(train).st_mtime
    assert want['vocab_content_hash'] == vocabs.content_hash()
