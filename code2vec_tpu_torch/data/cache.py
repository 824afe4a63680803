"""The binary token cache of the train split: tokenized once, then every
later epoch reads int32 arrays from disk with a chunk shuffle (a copy of
``code2vec_tpu/data/cache.py``, format v2, written byte for byte as the
reference writes it, so a cache either package built serves the other).

Layout of ``<data>.train.c2v.tokcache/``:

  ctx.bin    int32 (num_contexts, 3) — (source, path, target) triples
  count.bin  int32 (N,) — per-example effective lengths
  label.bin  int32 (N,)
  meta.json  version, row and context counts, max_contexts, and the
             fingerprint of the data file and the vocabularies

Format v1 (padded ``source.bin``/``path.bin``/``target.bin`` planes) is
read as it is and never rebuilt while its fingerprint holds. The mask is
not stored: a context is valid iff a part is not PAD. A build takes an
``fcntl`` lock beside the directory, writes into a temporary directory
and publishes it with ``os.replace``; a shard whose size disagrees with
``meta.json``, or counts that do not add up to the contexts, raise.
The reader of one data shard of D on a mesh (``parallel/mesh.py``)
caches its own line stride in ``<data>.train.c2v.tokcache.p<d>of<D>/``,
its index and count in the fingerprint, as the reference's processes do.

With telemetry on, each open counts ``input/cache_hit_total`` or
``input/cache_miss_total``, as the reference's does.
"""
from __future__ import annotations

import contextlib
import fcntl
import json
import logging
import os
import shutil
from typing import Iterator, Optional

import numpy as np

from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data import packed as packed_lib
from code2vec_tpu_torch.data.reader import (Batch, PathContextReader,
                                            context_valid_mask,
                                            fault_site_batches)
from code2vec_tpu_torch.telemetry import core as tele_core
from code2vec_tpu_torch.vocab import Code2VecVocabs

logger = logging.getLogger(__name__)

CACHE_FORMAT_VERSION = 2
_FILES_V2 = ('ctx.bin', 'count.bin', 'label.bin')


@contextlib.contextmanager
def _build_lock(lock_path: str):
    """Inter-process exclusion of a build: trainers sharing a dataset
    directory must not race its check, build and publish."""
    with open(lock_path, 'w') as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)


def fingerprint(config: Config, vocabs: Code2VecVocabs,
                data_path: str) -> dict:
    """What a cache must match to be served: the data file's size and
    mtime, MAX_CONTEXTS, and the vocabularies' sizes and content (sizes
    alone are often pinned at the MAX_*_VOCAB_SIZE caps)."""
    stat = os.stat(data_path)
    return {
        'data_size': stat.st_size,
        'data_mtime': stat.st_mtime,
        'max_contexts': config.MAX_CONTEXTS,
        'token_vocab': vocabs.token_vocab.size,
        'path_vocab': vocabs.path_vocab.size,
        'target_vocab': vocabs.target_vocab.size,
        'vocab_content_hash': vocabs.content_hash(),
    }


class TokenCache:
    def __init__(self, cache_dir: str, config: Config,
                 vocabs: Code2VecVocabs):
        self.cache_dir = cache_dir
        self.config = config
        self.vocabs = vocabs
        with open(os.path.join(cache_dir, 'meta.json'), 'r') as f:
            self.meta = json.load(f)
        self.num_rows = self.meta['num_rows']
        # a meta without a version key is v1's
        self.version = int(self.meta.get('version', 1))
        max_contexts = self.meta['max_contexts']
        if self.version >= 2:
            self.num_contexts = self.meta['num_contexts']
            self._check_shard_size('ctx.bin', self.num_contexts * 3 * 4)
            self._check_shard_size('count.bin', self.num_rows * 4)
            self.ctx = self._map('ctx.bin', (self.num_contexts, 3))
            self.count = self._map('count.bin', (self.num_rows,))
            # the counts are the offsets every epoch slices ctx.bin by
            total = int(np.asarray(self.count).sum(dtype=np.int64))
            if total != self.num_contexts:
                raise ValueError(
                    'Token cache at `%s` is corrupt: count.bin totals %d '
                    'contexts but meta.json/ctx.bin hold %d — delete the '
                    'cache directory to rebuild it.'
                    % (cache_dir, total, self.num_contexts))
        else:
            shape = (self.num_rows, max_contexts)
            for name in ('source.bin', 'path.bin', 'target.bin'):
                self._check_shard_size(name, self.num_rows * max_contexts
                                       * 4)
            self.source = self._map('source.bin', shape)
            self.path = self._map('path.bin', shape)
            self.target = self._map('target.bin', shape)
        self._check_shard_size('label.bin', self.num_rows * 4)
        self.label = self._map('label.bin', (self.num_rows,))
        # sticky packed capacity across batches and epochs
        self._packer = packed_lib.StickyPacker(
            vocabs.token_vocab.pad_index, vocabs.path_vocab.pad_index)

    def _map(self, name: str, shape) -> np.memmap:
        return np.memmap(os.path.join(self.cache_dir, name), dtype=np.int32,
                         mode='r', shape=shape)

    def _check_shard_size(self, name: str, expected_bytes: int) -> None:
        path = os.path.join(self.cache_dir, name)
        actual = os.path.getsize(path) if os.path.isfile(path) else -1
        if actual != expected_bytes:
            raise ValueError(
                'Token cache at `%s` is truncated or corrupt: %s is %d '
                'bytes but meta.json implies %d (disk-full or killed '
                'build?) — delete the cache directory to rebuild it.'
                % (self.cache_dir, name, actual, expected_bytes))

    @property
    def nbytes(self) -> int:
        """Bytes of the cache's files on disk."""
        return sum(entry.stat().st_size
                   for entry in os.scandir(self.cache_dir))

    # ------------------------------------------------------------ building
    @classmethod
    def build_or_load(cls, config: Config, vocabs: Code2VecVocabs,
                      reader: PathContextReader,
                      data_path: Optional[str] = None) -> 'TokenCache':
        """The cache of ``data_path`` (the train split by default): read
        when its fingerprint holds, else built from one unshuffled pass of
        ``reader`` under the build lock."""
        data_path = data_path or config.train_data_path
        # a reader of one data shard of several (a mesh) caches its own
        # line stride, in a directory of its own (the reference's
        # code2vec_tpu/data/cache.py:171-180)
        count = getattr(reader, 'data_count', 1)
        index = getattr(reader, 'data_index', 0)
        cache_dir = data_path + ('.tokcache' if count <= 1 else
                                 '.tokcache.p%dof%d' % (index, count))
        expected = fingerprint(config, vocabs, data_path)
        if count > 1:
            expected['process_index'] = index
            expected['process_count'] = count
        meta_path = os.path.join(cache_dir, 'meta.json')

        def is_fresh() -> bool:
            # the format version is not compared: a fresh v1 cache serves
            if not os.path.isfile(meta_path):
                return False
            with open(meta_path, 'r') as f:
                meta = json.load(f)
            return all(meta.get(k) == v for k, v in expected.items())

        if is_fresh():
            if tele_core.enabled():
                tele_core.registry().counter('input/cache_hit_total').inc()
            return cls(cache_dir, config, vocabs)
        with _build_lock(cache_dir + '.lock'):
            # another process may have built it while this one waited
            if not is_fresh():
                if tele_core.enabled():
                    tele_core.registry().counter(
                        'input/cache_miss_total').inc()
                cls._build(reader, data_path, cache_dir, expected)
            elif tele_core.enabled():
                tele_core.registry().counter('input/cache_hit_total').inc()
            return cls(cache_dir, config, vocabs)

    @classmethod
    def _build(cls, reader: PathContextReader, data_path: str,
               cache_dir: str, fingerprint_: dict) -> None:
        tmp_dir = cache_dir + '.building.%d' % os.getpid()
        os.makedirs(tmp_dir, exist_ok=True)
        logger.info('Building token cache at `%s` (format v%d) ...',
                    cache_dir, CACHE_FORMAT_VERSION)
        num_rows = 0
        num_contexts = 0
        handles = {name: open(os.path.join(tmp_dir, name), 'wb')
                   for name in _FILES_V2}
        try:
            # one filtered, unshuffled pass of plane batches; the padded
            # tail's zero-weight rows are dropped
            for batch in reader.iter_epoch(data_path=data_path,
                                           shuffle=False,
                                           wire_format='planes'):
                valid = batch.weight > 0
                triples, lengths = packed_lib.ragged_from_planes(
                    np.ascontiguousarray(batch.source[valid]),
                    np.ascontiguousarray(batch.path[valid]),
                    np.ascontiguousarray(batch.target[valid]),
                    batch.mask[valid])
                handles['ctx.bin'].write(
                    np.ascontiguousarray(triples).tobytes())
                handles['count.bin'].write(lengths.tobytes())
                handles['label.bin'].write(
                    np.ascontiguousarray(batch.label[valid]).tobytes())
                num_rows += int(valid.sum())
                num_contexts += int(lengths.sum())
        finally:
            for handle in handles.values():
                handle.close()
        if num_rows == 0:
            shutil.rmtree(tmp_dir, ignore_errors=True)
            raise ValueError(
                'No training examples survived filtering in `%s` — every '
                'row has an out-of-vocab target or no valid contexts.'
                % data_path)
        meta = dict(fingerprint_)
        meta['num_rows'] = num_rows
        meta['num_contexts'] = num_contexts
        meta['version'] = CACHE_FORMAT_VERSION
        with open(os.path.join(tmp_dir, 'meta.json'), 'w') as f:
            json.dump(meta, f)
        if os.path.isdir(cache_dir):
            shutil.rmtree(cache_dir)
        os.replace(tmp_dir, cache_dir)
        logger.info('Token cache built: %d rows, %d contexts (%.1f avg).',
                    num_rows, num_contexts, num_contexts / num_rows)

    # ----------------------------------------------------------- iteration
    def iter_epoch(self, batch_size: int, shuffle: bool = True,
                   seed: Optional[int] = None, chunk_rows: int = 1 << 16,
                   wire_format: Optional[str] = None) -> Iterator:
        """Fixed-shape batches from the cache: with ``shuffle``, the chunks
        of ``chunk_rows`` rows in a permuted order and the rows permuted
        within each chunk (``np.random.default_rng(seed)``, as the
        reference draws them, so both packages give the same batches in
        the same order). ``wire_format`` ('planes' by default, or
        'packed': one shard, sticky capacity) is independent of the
        on-disk version. The last batch is padded with zero-weight rows.
        Every array a batch holds is its own, writable and contiguous."""
        wire_format = wire_format or 'planes'
        if self.version >= 2:
            batches = self._iter_epoch_v2(batch_size, shuffle, seed,
                                          chunk_rows, wire_format)
        else:
            batches = self._iter_epoch_v1(batch_size, shuffle, seed,
                                          chunk_rows)
            if wire_format == 'packed':
                batches = (self._packer.pack_batch(batch)
                           for batch in batches)
        yield from fault_site_batches(batches)

    def _emit_v2(self, ctx_rows: np.ndarray, count: np.ndarray,
                 label: np.ndarray, weight: Optional[np.ndarray],
                 wire_format: str):
        token_pad = self.vocabs.token_vocab.pad_index
        path_pad = self.vocabs.path_vocab.pad_index
        if weight is None:
            weight = np.ones((count.shape[0],), np.float32)
        count = np.array(count, np.int32)     # own copies, not memmap views
        label = np.array(label, np.int32)
        if wire_format == 'packed':
            ctx = self._packer.pack_ragged(ctx_rows, count)
            return packed_lib.PackedBatch(ctx=ctx, count=count, label=label,
                                          weight=weight)
        source, path, target = packed_lib.unpack_ragged_np(
            ctx_rows, count, self.meta['max_contexts'], token_pad, path_pad)
        mask = context_valid_mask(source, path, target, token_pad, path_pad)
        return Batch(source=source, path=path, target=target, mask=mask,
                     label=label, weight=weight)

    def _iter_epoch_v2(self, batch_size: int, shuffle: bool,
                       seed: Optional[int], chunk_rows: int,
                       wire_format: str):
        rng = np.random.default_rng(seed)
        num_chunks = max(1, -(-self.num_rows // chunk_rows))
        # the context-row offset of each chunk boundary
        chunk_ctx_bounds = np.zeros(num_chunks + 1, np.int64)
        for i in range(num_chunks):
            begin = i * chunk_rows
            end = min(self.num_rows, begin + chunk_rows)
            chunk_ctx_bounds[i + 1] = chunk_ctx_bounds[i] + \
                np.asarray(self.count[begin:end]).sum(dtype=np.int64)
        chunk_order = np.arange(num_chunks)
        if shuffle:
            rng.shuffle(chunk_order)

        pend_ctx = np.zeros((0, 3), np.int32)
        pend_count = np.zeros((0,), np.int32)
        pend_label = np.zeros((0,), np.int32)
        for chunk_idx in chunk_order:
            begin = int(chunk_idx) * chunk_rows
            end = min(self.num_rows, begin + chunk_rows)
            count = np.asarray(self.count[begin:end])
            label = np.asarray(self.label[begin:end])
            ctx_rows = np.asarray(
                self.ctx[chunk_ctx_bounds[chunk_idx]:
                         chunk_ctx_bounds[chunk_idx + 1]])
            if shuffle:
                perm = rng.permutation(end - begin)
                starts = np.cumsum(count) - count
                sel = np.repeat(starts[perm], count[perm]) + \
                    (np.arange(count[perm].sum(), dtype=np.int64)
                     - np.repeat(np.cumsum(count[perm]) - count[perm],
                                 count[perm]))
                ctx_rows = ctx_rows[sel]
                count, label = count[perm], label[perm]
            if pend_count.shape[0]:
                ctx_rows = np.concatenate([pend_ctx, ctx_rows])
                count = np.concatenate([pend_count, count])
                label = np.concatenate([pend_label, label])
            bounds = np.concatenate([[0], np.cumsum(count, dtype=np.int64)])
            n_full = (count.shape[0] // batch_size) * batch_size
            for start in range(0, n_full, batch_size):
                stop = start + batch_size
                yield self._emit_v2(ctx_rows[bounds[start]:bounds[stop]],
                                    count[start:stop], label[start:stop],
                                    None, wire_format)
            pend_ctx = ctx_rows[bounds[n_full]:]
            pend_count = count[n_full:]
            pend_label = label[n_full:]

        if pend_count.shape[0]:
            pad = batch_size - pend_count.shape[0]
            yield self._emit_v2(
                pend_ctx,
                np.concatenate([pend_count, np.zeros((pad,), np.int32)]),
                np.concatenate([pend_label, np.zeros((pad,), np.int32)]),
                np.concatenate([np.ones((pend_count.shape[0],), np.float32),
                                np.zeros((pad,), np.float32)]),
                wire_format)

    def _iter_epoch_v1(self, batch_size: int, shuffle: bool,
                       seed: Optional[int], chunk_rows: int
                       ) -> Iterator[Batch]:
        rng = np.random.default_rng(seed)
        token_pad = self.vocabs.token_vocab.pad_index
        path_pad = self.vocabs.path_vocab.pad_index
        num_chunks = max(1, -(-self.num_rows // chunk_rows))
        chunk_order = np.arange(num_chunks)
        if shuffle:
            rng.shuffle(chunk_order)

        def emit(source, path, target, label, weight=None) -> Batch:
            source, path, target, label = (
                np.array(a, np.int32) for a in (source, path, target, label))
            mask = context_valid_mask(source, path, target, token_pad,
                                      path_pad)
            if weight is None:
                weight = np.ones((source.shape[0],), np.float32)
            return Batch(source=source, path=path, target=target, mask=mask,
                         label=label, weight=weight)

        pending = []      # the rows short of a batch, as arrays
        for chunk_idx in chunk_order:
            begin = int(chunk_idx) * chunk_rows
            end = min(self.num_rows, begin + chunk_rows)
            arrays = [np.asarray(a[begin:end]) for a in
                      (self.source, self.path, self.target, self.label)]
            if shuffle:
                perm = rng.permutation(end - begin)
                arrays = [a[perm] for a in arrays]
            if pending:
                arrays = [np.concatenate([p, a])
                          for p, a in zip(pending, arrays)]
                pending = []
            n_rows = arrays[0].shape[0]
            n_full = (n_rows // batch_size) * batch_size
            for start in range(0, n_full, batch_size):
                yield emit(*(a[start:start + batch_size] for a in arrays))
            if n_full < n_rows:
                pending = [a[n_full:] for a in arrays]

        if pending:
            rows = pending[0].shape[0]
            pad = batch_size - rows
            fills = (token_pad, path_pad, token_pad)
            planes = [np.concatenate([p, np.full((pad, p.shape[1]), fill,
                                                 np.int32)])
                      for p, fill in zip(pending[:3], fills)]
            yield emit(*planes,
                       np.concatenate([pending[3], np.zeros((pad,),
                                                            np.int32)]),
                       weight=np.concatenate([np.ones((rows,), np.float32),
                                              np.zeros((pad,), np.float32)]))
