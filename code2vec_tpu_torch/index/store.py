"""On-disk vector store: memory-mapped shards + ``meta.json`` — the port's
copy of ``code2vec_tpu/index/store.py``, byte for byte on disk: a store
that either package builds opens in the other.

Layout of ``<name>.vecindex/``::

    meta.json        {"count", "dim", "dtype", "metric", "normalized",
                      "shard_rows", "shards": [rows per shard]}
    shard_00000.bin  row-major (rows, dim) of meta's dtype
    shard_00001.bin  ...
    labels.txt       optional, one UTF-8 label per row (method names /
                     vocab words) — what a neighbor result displays
    ivf.npz          optional, written by index/ivf.py (centroids +
                     inverted lists); absent for exact-only stores

Shards are a DISK/streaming concept (bounded build memory, and the unit
of the exact tier's streamed host-merge search); the DEVICE layout is
separate — ``index/exact.py`` loads the whole store as one tensor.

Builders accept any iterable of ``(n_i, dim)`` float chunks, so the
index can be built straight from ``serving/bulk.iter_code_vector_batches``
without a round-trip through the ``.vectors`` text format, from an
existing ``.vectors`` file, or from a word2vec text export
(``--export_vocab_vectors``) whose words become the labels.

``dtype='float16'`` halves both disk and device-resident (HBM) footprint
(``Config.VECTORS_DTYPE``); scores are always accumulated in float32 on
the device, and the recall impact is parity-tested
(tests/test_torch_index.py).

``metric='cosine'`` normalizes rows AT BUILD TIME (recorded as
``normalized`` in meta), so search never renormalizes the corpus side;
zero vectors stay zero and can never win a query.
"""
from __future__ import annotations

import json
import os
import time
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from code2vec_tpu_torch.telemetry import core as tele_core

META_NAME = 'meta.json'
LABELS_NAME = 'labels.txt'
SHARD_PATTERN = 'shard_%05d.bin'
STORE_SUFFIX = '.vecindex'

METRICS = ('cosine', 'dot')
DTYPES = ('float32', 'float16')

# Rows per on-disk shard file: bounds build memory (one shard buffered
# at a time) and sizes the streamed search's per-shard device chunks.
DEFAULT_SHARD_ROWS = 1 << 18


def normalize_rows(vectors: np.ndarray) -> np.ndarray:
    """L2-normalize rows in float32; all-zero rows stay zero (a dropped
    example's vector must never be the nearest anything)."""
    vectors = np.asarray(vectors, np.float32)
    norms = np.linalg.norm(vectors, axis=-1, keepdims=True)
    return vectors / np.where(norms > 0, norms, 1.0)


class VectorStore:
    """Read view over a built store directory: memory-mapped shards,
    lazily opened, plus the meta fields as attributes."""

    def __init__(self, path: str):
        self.path = path
        meta_path = os.path.join(path, META_NAME)
        if not os.path.isfile(meta_path):
            raise FileNotFoundError(
                'no vector store at `%s` (missing %s)' % (path, META_NAME))
        with open(meta_path, 'r') as f:
            meta = json.load(f)
        self.count = int(meta['count'])
        self.dim = int(meta['dim'])
        self.dtype = np.dtype(meta['dtype'])
        self.metric = str(meta['metric'])
        self.normalized = bool(meta['normalized'])
        self.shard_rows = int(meta['shard_rows'])
        self.shards: List[int] = [int(n) for n in meta['shards']]
        if sum(self.shards) != self.count:
            raise ValueError(
                'corrupt store `%s`: shard rows %r do not sum to count %d'
                % (path, self.shards, self.count))
        self._labels: Optional[np.ndarray] = None
        self._mmaps: List[Optional[np.memmap]] = [None] * len(self.shards)

    # ------------------------------------------------------------ reading
    def shard(self, i: int) -> np.memmap:
        """Memory-mapped (rows_i, dim) view of shard ``i``."""
        if self._mmaps[i] is None:
            self._mmaps[i] = np.memmap(
                os.path.join(self.path, SHARD_PATTERN % i), mode='r',
                dtype=self.dtype, shape=(self.shards[i], self.dim))
        return self._mmaps[i]

    def iter_shards(self) -> Iterable[Tuple[int, np.memmap]]:
        """(global row offset, mmap rows) per shard, in row order."""
        offset = 0
        for i, rows in enumerate(self.shards):
            yield offset, self.shard(i)
            offset += rows

    def all_rows(self) -> np.ndarray:
        """The whole store as one (count, dim) array (device loading;
        copies out of the mmaps)."""
        if len(self.shards) == 1:
            return np.asarray(self.shard(0))
        return np.concatenate([np.asarray(s)
                               for _off, s in self.iter_shards()])

    @property
    def labels(self) -> Optional[np.ndarray]:
        """(count,) object array of per-row labels, or None."""
        if self._labels is None:
            labels_path = os.path.join(self.path, LABELS_NAME)
            if not os.path.isfile(labels_path):
                return None
            with open(labels_path, 'r', encoding='utf-8') as f:
                self._labels = np.array(
                    [line.rstrip('\n') for line in f], dtype=object)
            if self._labels.shape[0] != self.count:
                raise ValueError(
                    'corrupt store `%s`: %d labels for %d vectors'
                    % (self.path, self._labels.shape[0], self.count))
        return self._labels

    def label_of(self, row: int) -> Optional[str]:
        labels = self.labels
        return None if labels is None else str(labels[row])

    def take(self, rows: np.ndarray) -> np.ndarray:
        """Gather arbitrary global row ids out of the mmapped shards:
        ``(n,)`` int ids -> ``(n, dim)`` in the store dtype. The exact
        re-rank path of the quantized tier (index/quant.py) — candidate
        sets are tiny (top-R per query), so a per-shard fancy-index over
        the mmaps beats materializing ``all_rows()``."""
        rows = np.asarray(rows, np.int64).ravel()
        out = np.empty((rows.shape[0], self.dim), self.dtype)
        if rows.shape[0] == 0:
            return out
        if rows.min() < 0 or rows.max() >= self.count:
            raise IndexError(
                'row ids out of range [0, %d) for store `%s`'
                % (self.count, self.path))
        bounds = np.concatenate([[0], np.cumsum(self.shards)])
        shard_idx = np.searchsorted(bounds, rows, side='right') - 1
        for s in np.unique(shard_idx):
            mask = shard_idx == s
            out[mask] = self.shard(int(s))[rows[mask] - bounds[s]]
        return out

    # ---------------------------------------------------------- appending
    def append_rows(self, vectors: np.ndarray,
                    labels: Optional[Sequence[str]] = None,
                    canonical: bool = False) -> Tuple[int, int]:
        """Append rows as NEW shard files + an atomic meta update — the
        quantized tier's compaction path: segment truth folds into the
        store without rewriting existing shards. Returns the
        ``(start, end)`` global row id range of the appended rows.

        Normalization parity with build(): rows are L2-normalized here
        iff the store records ``normalized`` (cosine builds). With
        ``canonical`` the rows are written verbatim — the compaction
        path, whose segment vectors were already normalized and cast at
        insert time; re-normalizing would shift last-ulp bytes and break
        the pre/post-compaction bit-for-rank contract. A labeled store
        keeps its labels file row-aligned — appends without labels write
        blank lines; an unlabeled store refuses labels (labeling could
        not be backfilled for the existing rows)."""
        vectors = np.asarray(vectors)
        if vectors.ndim != 2 or (vectors.shape[0] > 0
                                 and vectors.shape[1] != self.dim):
            raise ValueError('appended vectors must be (n, %d), got %r'
                             % (self.dim, vectors.shape))
        n = int(vectors.shape[0])
        if n == 0:
            return (self.count, self.count)
        if self.normalized and not canonical:
            vectors = normalize_rows(vectors)
        vectors = np.ascontiguousarray(vectors, dtype=self.dtype)
        has_labels = self.labels is not None
        if labels is not None and not has_labels:
            raise ValueError(
                'store `%s` has no labels file — appended labels would '
                'mis-align with the existing unlabeled rows' % self.path)
        row_labels: List[str] = []
        if has_labels:
            row_labels = ([str(item) for item in labels]
                          if labels is not None else [''] * n)
            if len(row_labels) != n:
                raise ValueError(
                    '%d labels for %d appended vectors — the label '
                    'stream must align row-for-row' % (len(row_labels), n))
        start = self.count
        new_counts: List[int] = []
        written = 0
        while written < n:
            rows_here = min(self.shard_rows, n - written)
            shard_path = os.path.join(
                self.path, SHARD_PATTERN % (len(self.shards)
                                            + len(new_counts)))
            with open(shard_path, 'wb') as f:
                f.write(vectors[written:written + rows_here].tobytes())
            new_counts.append(rows_here)
            written += rows_here
        if has_labels:
            with open(os.path.join(self.path, LABELS_NAME), 'a',
                      encoding='utf-8') as f:
                for item in row_labels:
                    f.write(str(item).replace('\n', ' ') + '\n')
        meta = {'count': self.count + n, 'dim': self.dim,
                'dtype': self.dtype.name, 'metric': self.metric,
                'normalized': self.normalized,
                'shard_rows': self.shard_rows,
                'shards': self.shards + new_counts}
        # same atomic-ish discipline as build(): shard bytes land first,
        # meta last — a crash leaves orphan .bin files, never a store
        # whose meta points past the data
        meta_tmp = os.path.join(self.path, META_NAME + '.tmp')
        with open(meta_tmp, 'w') as f:
            json.dump(meta, f)
        os.replace(meta_tmp, os.path.join(self.path, META_NAME))
        self.count += n
        self.shards.extend(new_counts)
        self._mmaps.extend([None] * len(new_counts))
        self._labels = None
        if tele_core.enabled():
            tele_core.registry().gauge('index/vectors_total').set(
                self.count)
        return (start, self.count)


# ---------------------------------------------------------------- builders
def build(out_dir: str, chunks: Iterable[np.ndarray],
          dtype: str = 'float32', metric: str = 'cosine',
          labels: Optional[Iterable[str]] = None,
          shard_rows: int = DEFAULT_SHARD_ROWS,
          log=None) -> VectorStore:
    """Stream ``(n_i, dim)`` float chunks into a store directory.

    ``labels`` (optional) must yield exactly one string per row, aligned
    with the chunk stream — the builder depends on the bulk export's
    row i ↔ example i order guarantee (serving/bulk.py). It is consumed
    only AFTER the chunk iterable is exhausted, so a caller may pass a
    list its chunk generator is still appending to (late binding — how
    service.build_index streams a corpus without materializing it)."""
    if metric not in METRICS:
        raise ValueError('metric must be one of %s, got %r'
                         % (METRICS, metric))
    if np.dtype(dtype).name not in DTYPES:
        raise ValueError('dtype must be one of %s, got %r'
                         % (DTYPES, dtype))
    if shard_rows < 1:
        raise ValueError('shard_rows must be >= 1, got %d' % shard_rows)
    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    out_dtype = np.dtype(dtype)
    normalize = metric == 'cosine'
    dim = None
    count = 0
    shard_counts: List[int] = []
    shard_file = None

    def open_shard():
        return open(os.path.join(out_dir,
                                 SHARD_PATTERN % len(shard_counts)), 'wb')

    try:
        for chunk in chunks:
            chunk = np.asarray(chunk)
            if chunk.ndim != 2:
                raise ValueError('chunks must be (n, dim), got shape %r'
                                 % (chunk.shape,))
            if chunk.shape[0] == 0:
                continue
            if dim is None:
                dim = int(chunk.shape[1])
            elif chunk.shape[1] != dim:
                raise ValueError('chunk dim %d != first chunk dim %d'
                                 % (chunk.shape[1], dim))
            if normalize:
                chunk = normalize_rows(chunk)
            chunk = np.ascontiguousarray(chunk, dtype=out_dtype)
            written = 0
            while written < chunk.shape[0]:
                if shard_file is None:
                    shard_file = open_shard()
                    shard_counts.append(0)
                room = shard_rows - shard_counts[-1]
                take = min(room, chunk.shape[0] - written)
                shard_file.write(chunk[written:written + take].tobytes())
                shard_counts[-1] += take
                written += take
                count += take
                if shard_counts[-1] == shard_rows:
                    shard_file.close()
                    shard_file = None
    finally:
        if shard_file is not None:
            shard_file.close()
    if count == 0:
        raise ValueError('no vectors to index (empty chunk stream)')

    n_labels = 0
    if labels is not None:
        with open(os.path.join(out_dir, LABELS_NAME), 'w',
                  encoding='utf-8') as f:
            for label in labels:
                f.write(str(label).replace('\n', ' ') + '\n')
                n_labels += 1
        if n_labels != count:
            raise ValueError(
                '%d labels for %d vectors — the label stream must align '
                'row-for-row with the vector stream' % (n_labels, count))

    meta = {'count': count, 'dim': dim, 'dtype': out_dtype.name,
            'metric': metric, 'normalized': normalize,
            'shard_rows': shard_rows, 'shards': shard_counts}
    # atomic-ish: meta lands last, so a crashed build is an unopenable
    # directory rather than a silently short store
    meta_tmp = os.path.join(out_dir, META_NAME + '.tmp')
    with open(meta_tmp, 'w') as f:
        json.dump(meta, f)
    os.replace(meta_tmp, os.path.join(out_dir, META_NAME))
    build_s = time.perf_counter() - t0
    if tele_core.enabled():
        reg = tele_core.registry()
        reg.gauge('index/build_s').set(build_s)
        reg.gauge('index/vectors_total').set(count)
    if log is not None:
        log('index: built store `%s` (%d vectors x %d dims, %s, %s, %d '
            'shard(s), %.1fs)' % (out_dir, count, dim, out_dtype.name,
                                  metric, len(shard_counts), build_s))
    return VectorStore(out_dir)


def _text_vector_chunks(path: str, chunk_rows: int = 4096
                        ) -> Iterable[np.ndarray]:
    """Parse a ``.vectors`` text file (one space-separated vector per
    line — the evaluate/bulk export format) into float32 chunks."""
    with open(path, 'r') as f:
        rows: List[np.ndarray] = []
        for line in f:
            if not line.strip():
                continue
            rows.append(np.fromiter(line.split(), np.float32))
            if len(rows) == chunk_rows:
                yield np.stack(rows)
                rows = []
        if rows:
            yield np.stack(rows)


def build_from_vectors_file(vectors_path: str,
                            out_dir: Optional[str] = None,
                            labels: Optional[Sequence[str]] = None,
                            **kwargs) -> VectorStore:
    """Build from a ``.vectors`` text export (evaluate's
    ``--export_code_vectors`` / ``--bulk-vectors`` output). Default
    ``out_dir`` is ``<vectors_path>.vecindex``."""
    out_dir = out_dir if out_dir is not None \
        else vectors_path + STORE_SUFFIX
    return build(out_dir, _text_vector_chunks(vectors_path),
                 labels=labels, **kwargs)


def build_from_word2vec(w2v_path: str, out_dir: Optional[str] = None,
                        **kwargs) -> VectorStore:
    """Build from a word2vec TEXT export (``--export_vocab_vectors`` /
    ``--save_word2v``): header ``count dim``, then ``word v1 .. vdim``
    per line. The words become the store labels, so the index serves
    "nearest method-name" queries over the target vocab."""
    out_dir = out_dir if out_dir is not None else w2v_path + STORE_SUFFIX
    words: List[str] = []

    def chunks() -> Iterable[np.ndarray]:
        with open(w2v_path, 'r', encoding='utf-8') as f:
            header = f.readline().split()
            if len(header) != 2:
                raise ValueError(
                    '`%s` is not a word2vec text file (header must be '
                    '"count dim", got %r)' % (w2v_path, header))
            dim = int(header[1])
            rows: List[np.ndarray] = []
            for line in f:
                parts = line.rstrip('\n').split(' ')
                if len(parts) < dim + 1:
                    continue
                # the word may not contain spaces (vocab words never do);
                # the last `dim` fields are the vector
                words.append(' '.join(parts[:-dim]))
                rows.append(np.asarray(parts[-dim:], np.float32))
                if len(rows) == 4096:
                    yield np.stack(rows)
                    rows = []
            if rows:
                yield np.stack(rows)

    # `words` is late-bound: build() exhausts the chunk stream before
    # consuming the labels iterable (see build's docstring)
    return build(out_dir, chunks(), labels=words, **kwargs)
