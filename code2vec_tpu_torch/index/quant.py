"""Quantized IVF tier: int8/PQ inverted lists, append segments, compaction
— the port of ``code2vec_tpu/index/quant.py``, with its sidecars.

- **int8** — per-dimension symmetric scales (``scale = maxabs / 127``);
  the query is pre-scaled once per batch and the probe scores the
  gathered codes in fp32 (1 byte/dim, half of f16).
- **pq** — product quantization of the RESIDUALS against the coarse
  centroids (IVFADC): ``M`` subspaces with 256 codewords each, trained
  by the coarse k-means' substrate (chunked assignment, then one update
  over all subspaces: a batched one-hot product whose order does not
  change between runs). Scoring is
  asymmetric: ``q.row ~ q.centroid + q.residual`` — the coarse term
  comes from the host's coarse scores per candidate, the residual term
  from a per-query ``(Q, M, 256)`` LUT built on the device and one
  gather-accumulate over the candidate codes. The M terms are summed in
  torch's order, not XLA's, so quantized scores agree with the
  reference's within tolerance, not bit for bit.
- **re-rank** — the top-R candidates are re-scored exactly from the mmap
  store (``VectorStore.take``) and sorted by ``(-score, id)`` on the
  host; with R covering the candidates the order is bit for rank.

**Inserts** land in append segments (``segment_%05d.npz`` under
``segments.json``) and one padded device buffer probed with the base
lists; ``compact()`` folds them into the store (``append_rows``) and
rebuilds the CSR from the existing assignments, bumping the version.
Inserts, compaction and the search's snapshot of the ``(base, segment)``
buffers hold ``_lock``; a search reads the buffers it took under the
lock, on its own thread's current stream, and its host copy waits on
that stream only.

Persistence: ``ivf.npz``, ``quant.npz`` (kind, row-order codes, scales
or codebooks, version), ``segments.json`` + per-segment npz sidecars —
the reference's files: a quantized index either package builds serves
in the other.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from code2vec_tpu_torch.data.packed import bucketed_capacity
from code2vec_tpu_torch.device import resolve_device
from code2vec_tpu_torch.index.exact import (DEFAULT_QUERY_BUCKETS,
                                            _pick_bucket, place,
                                            prepare_queries)
from code2vec_tpu_torch.index.ivf import (DEFAULT_ITERS, DEFAULT_NPROBE,
                                          IVF_NAME, KMEANS_CHUNK_BYTES,
                                          MIN_PROBE_CAPACITY,
                                          csr_lists, default_clusters,
                                          kmeans, query_chunk)
from code2vec_tpu_torch.index.store import VectorStore, normalize_rows
from code2vec_tpu_torch.ops.topk import padded_local_topk
from code2vec_tpu_torch.telemetry import core as tele_core
from code2vec_tpu_torch.telemetry import memory as memory_lib

QUANT_NAME = 'quant.npz'
SEGMENTS_NAME = 'segments.json'
SEGMENT_PATTERN = 'segment_%05d.npz'

QUANT_KINDS = ('int8', 'pq')
PQ_CODEBOOK = 256        # codewords per subspace — codes stay uint8
DEFAULT_PQ_SUBDIM = 4    # dims per subspace when --index-pq-m is 0
DEFAULT_RERANK = 128
DEFAULT_SEGMENT_ROWS = 4096
DEFAULT_COMPACT_SEGMENTS = 8
TRAIN_SAMPLE = 1 << 16   # codebook/scale training sample cap
_ENCODE_CHUNK = 8192     # bounds the (chunk, M, 256) distance tensor


def resolve_pq_m(dim: int, m: int = 0) -> int:
    """Subspace count: the requested ``m`` clamped down to a divisor of
    ``dim``; 0 means the default ``dim // 4`` — 1/8 the bytes of f16."""
    if m <= 0:
        m = max(1, dim // DEFAULT_PQ_SUBDIM)
    m = min(m, dim)
    while dim % m:
        m -= 1
    return m


# ------------------------------------------------------------ int8 codec
def train_int8(sample: np.ndarray) -> np.ndarray:
    """Per-dimension symmetric scales: ``scale[d] = maxabs[d] / 127``
    (floored so all-zero dims stay finite)."""
    sample = np.asarray(sample, np.float32)
    return np.maximum(np.abs(sample).max(axis=0), 1e-12) / 127.0


def encode_int8(vectors: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """(N, D) float -> (N, D) int8 codes (round-to-nearest, clipped)."""
    vectors = np.asarray(vectors, np.float32)
    return np.clip(np.rint(vectors / scale[None, :]),
                   -127, 127).astype(np.int8)


# -------------------------------------------------------------- pq codec
def _pq_assign(x: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """(B, M, dsub) x (M, K, dsub) -> (B, M) nearest codeword per
    subspace (min-L2 via the max of ``x.c - 0.5*|c|^2``)."""
    scores = (torch.einsum('bmd,mkd->bmk', x, books)
              - 0.5 * torch.sum(books * books, dim=-1)[None])
    return torch.argmax(scores, dim=-1)


def _assign_chunks(vectors: np.ndarray, codebooks: np.ndarray,
                   device: torch.device) -> np.ndarray:
    """(N, D) -> (N, M) int32 codeword assignments, in chunks of
    ``_ENCODE_CHUNK`` rows that bound the (chunk, M, 256) scores."""
    vectors = np.asarray(vectors, np.float32)
    n = vectors.shape[0]
    m, _k, dsub = codebooks.shape
    books = place(np.asarray(codebooks, np.float32), device)
    out = np.empty((n, m), np.int32)
    for start in range(0, n, _ENCODE_CHUNK):
        block = place(vectors[start:start + _ENCODE_CHUNK], device)
        out[start:start + block.shape[0]] = _pq_assign(
            block.reshape(block.shape[0], m, dsub), books).cpu().numpy()
    return out


def _pq_update(x: torch.Tensor, assign: torch.Tensor,
               codebooks: torch.Tensor) -> torch.Tensor:
    """One Lloyd update over ALL subspaces: the reference's segment sum
    over flattened ids, here a batched one-hot ``(M, K, chunk)`` product
    per fixed chunk of rows (an order that does not change between
    runs). Empty codewords keep their previous centroid (the coarse
    k-means' contract)."""
    n, m, dsub = x.shape
    k_codebook = codebooks.shape[1]
    chunk = max(1, KMEANS_CHUNK_BYTES // (4 * m * k_codebook))
    words = torch.arange(k_codebook, device=x.device)
    sums = x.new_zeros((m, k_codebook, dsub))
    for start in range(0, n, chunk):
        onehot = (assign[start:start + chunk].T[:, :, None]
                  == words).to(x.dtype)                # (M, chunk, K)
        sums += onehot.transpose(1, 2) @ x[start:start + chunk].transpose(
            0, 1)
    offs = (torch.arange(m, device=x.device) * k_codebook)[None, :]
    counts = torch.bincount((assign + offs).reshape(-1),
                            minlength=m * k_codebook).float().reshape(
                                m, k_codebook)
    means = sums / torch.clamp(counts, min=1.0)[..., None]
    return torch.where((counts > 0)[..., None], means, codebooks)


def train_pq(sample: np.ndarray, m: int, iters: int = DEFAULT_ITERS,
             seed: int = 0, device=None) -> np.ndarray:
    """Per-subspace codebooks ``(M, K, dsub)`` float32: batched Lloyd —
    chunked assignment + one update across all subspaces per
    iteration."""
    device = resolve_device(device)
    sample = np.asarray(sample, np.float32)
    n, dim = sample.shape
    dsub = dim // m
    k_codebook = min(PQ_CODEBOOK, n)
    rng = np.random.default_rng(seed)
    rows = sample[rng.choice(n, size=k_codebook, replace=False)]
    codebooks = np.ascontiguousarray(
        rows.reshape(k_codebook, m, dsub).transpose(1, 0, 2))
    x = place(sample.reshape(n, m, dsub), device)
    for _ in range(max(1, iters)):
        assign = place(_assign_chunks(sample, codebooks, device), device)
        codebooks = _pq_update(x, assign.long(),
                               place(codebooks, device)).cpu().numpy()
    return codebooks.astype(np.float32)


def encode_pq(vectors: np.ndarray, codebooks: np.ndarray,
              device=None) -> np.ndarray:
    """(N, D) float -> (N, M) uint8 codes (nearest codeword per
    subspace, frozen codebooks)."""
    return _assign_chunks(vectors, codebooks,
                          resolve_device(device)).astype(np.uint8)


def coarse_probe(centroids: np.ndarray, queries: np.ndarray,
                 nprobe: int, metric: str) -> np.ndarray:
    """Top-``nprobe`` cluster ids per query (host numpy; the contract of
    ``IVFIndex._coarse``)."""
    q = np.asarray(queries, np.float32)
    if metric == 'cosine':
        q = normalize_rows(q)
    scores = q @ centroids.T
    return np.argsort(-scores, axis=-1, kind='stable')[:, :nprobe]


class QuantizedIVFIndex:
    """nprobe-bounded approximate k-NN over int8/PQ codes, with live
    inserts and host-exact re-rank.

    Build with ``QuantizedIVFIndex.build(store, kind=...)`` (persists the
    sidecars) or reopen with ``QuantizedIVFIndex(store)`` when
    ``quant.npz`` exists. ``insert`` appends live vectors (queryable at
    once); ``compact`` folds segments into the base CSR + store."""

    # graftlint: guard QuantizedIVFIndex._segments,_append_vectors by _lock
    # graftlint: guard QuantizedIVFIndex._append_codes,_append_assign by _lock
    # graftlint: guard QuantizedIVFIndex._append_row_ids by _lock
    # graftlint: guard QuantizedIVFIndex._append_labels,_append_dev by _lock
    # graftlint: guard QuantizedIVFIndex._append_capacity by _lock
    # graftlint: guard QuantizedIVFIndex._base_codes_dev,_base_rows by _lock
    # graftlint: guard QuantizedIVFIndex._store_rows,version,list_ids by _lock
    # graftlint: guard QuantizedIVFIndex.offsets,list_lengths by _lock
    # graftlint: guard QuantizedIVFIndex.compactions by _lock
    def __init__(self, store: VectorStore, kind: Optional[str] = None,
                 nprobe: int = DEFAULT_NPROBE,
                 rerank: int = DEFAULT_RERANK,
                 segment_rows: int = DEFAULT_SEGMENT_ROWS,
                 compact_segments: int = DEFAULT_COMPACT_SEGMENTS,
                 centroids: Optional[np.ndarray] = None,
                 list_ids: Optional[np.ndarray] = None,
                 offsets: Optional[np.ndarray] = None,
                 codes: Optional[np.ndarray] = None,
                 quant_const: Optional[np.ndarray] = None,
                 version: int = 0, device=None):
        self.device = resolve_device(device)
        self.store = store
        self.metric = store.metric
        self.dim = store.dim
        self.nprobe = nprobe
        self.rerank = max(0, int(rerank))
        self.segment_rows = max(1, int(segment_rows))
        self.compact_segments = max(0, int(compact_segments))
        self._lock = threading.RLock()
        # arrays handed in = a fresh build (build() resets the sidecars);
        # arrays absent = reopen: sidecars + live segments load
        fresh_build = codes is not None
        if centroids is None:
            centroids, list_ids, offsets = self._load_coarse(store.path)
        if codes is None:
            kind, codes, quant_const, version = self._load_quant(
                store.path, kind)
        if kind not in QUANT_KINDS:
            raise ValueError('index quant kind must be one of %s, got %r'
                             % (QUANT_KINDS, kind))
        self.kind = kind
        self.version = int(version)
        self.centroids = np.asarray(centroids, np.float32)
        self.n_clusters = self.centroids.shape[0]
        self.list_ids = np.asarray(list_ids, np.int64)
        self.offsets = np.asarray(offsets, np.int64)
        self.list_lengths = np.diff(self.offsets)
        self._quant_const = np.asarray(quant_const, np.float32)
        if kind == 'pq':
            self.pq_m, self.pq_k, self.pq_dsub = self._quant_const.shape
            if self.pq_m * self.pq_dsub != self.dim:
                raise ValueError(
                    'pq codebooks (%d subspaces x %d dims) do not tile '
                    'dim %d' % (self.pq_m, self.pq_dsub, self.dim))
        else:
            self.pq_m = self.pq_k = self.pq_dsub = 0
        codes = np.asarray(codes)
        self._code_width = int(codes.shape[1])  # bytes/vector on device
        self._base_rows = int(codes.shape[0])
        self._store_rows = store.count
        if self._base_rows != self._store_rows:
            raise ValueError(
                'quant sidecar covers %d rows but store `%s` holds %d — '
                'rebuild or compact before reopening'
                % (self._base_rows, store.path, self._store_rows))
        # empty append state (segments reload below)
        self._segments: List[dict] = []
        self._append_vectors = np.empty((0, self.dim), store.dtype)
        self._append_codes = np.empty((0, self._code_width), codes.dtype)
        self._append_assign = np.empty((0,), np.int32)
        self._append_row_ids = np.empty((0,), np.int64)
        self._append_labels: List[str] = []
        self._append_dev = None
        self._append_capacity = 0
        self._seg_entries = 0
        self.compactions = 0
        #: host seconds of the last search's candidate fill
        self.last_fill_s = 0.0
        sorted_codes = codes[self.list_ids]
        memory_lib.ledger().check_budget(
            int(sorted_codes.nbytes + self._quant_const.nbytes),
            'index attach (quantized tier: %s, %d vectors x %d '
            'code bytes, %d clusters)'
            % (kind, self._base_rows, self._code_width, self.n_clusters))
        self.device_nbytes = 0
        with self._lock:
            self._install_base_locked(sorted_codes)
        if not fresh_build:
            self._reload_segments()

    # --------------------------------------------------------- sidecars
    @staticmethod
    def _load_coarse(path: str):
        sidecar = os.path.join(path, IVF_NAME)
        if not os.path.isfile(sidecar):
            raise FileNotFoundError(
                'no IVF sidecar at `%s` — build the quantized tier with '
                'QuantizedIVFIndex.build(store, kind=...) or '
                '--build-index --index-quant int8|pq' % sidecar)
        data = np.load(sidecar)
        return data['centroids'], data['list_ids'], data['offsets']

    @staticmethod
    def _load_quant(path: str, kind: Optional[str]):
        sidecar = os.path.join(path, QUANT_NAME)
        if not os.path.isfile(sidecar):
            raise FileNotFoundError(
                'no quantized sidecar at `%s` — build one with '
                'QuantizedIVFIndex.build(store, kind=...)' % sidecar)
        data = np.load(sidecar)
        disk_kind = str(data['kind'])
        if kind is not None and kind != disk_kind:
            raise ValueError(
                'store `%s` holds %s codes but %s was requested — '
                'rebuild with --index-quant %s'
                % (path, disk_kind, kind, kind))
        return (disk_kind, data['codes'], data['const'],
                int(data['version']))

    def _persist_quant_locked(self, codes_row_order: np.ndarray) -> None:
        """quant.npz: ROW-ORDER codes + the frozen scales/codebooks + the
        version; tmp-then-replace like the store meta."""
        path = os.path.join(self.store.path, QUANT_NAME)
        tmp = path + '.tmp.npz'
        np.savez(tmp, kind=np.asarray(self.kind),
                 codes=codes_row_order, const=self._quant_const,
                 version=np.asarray(self.version))
        os.replace(tmp, path)

    def _load_row_codes(self) -> np.ndarray:
        data = np.load(os.path.join(self.store.path, QUANT_NAME))
        return np.asarray(data['codes'])

    def _persist_manifest_locked(self) -> None:
        manifest = {'version': self.version,
                    'base_count': self._store_rows,
                    'segments': [dict(seg) for seg in self._segments]}
        path = os.path.join(self.store.path, SEGMENTS_NAME)
        tmp = path + '.tmp'
        with open(tmp, 'w') as f:
            json.dump(manifest, f)
        os.replace(tmp, path)

    def _reload_segments(self) -> None:
        """Rehydrate append state from the versioned segment sidecars: a
        reopened index serves inserts that never compacted."""
        path = os.path.join(self.store.path, SEGMENTS_NAME)
        if not os.path.isfile(path):
            return
        with open(path, 'r') as f:
            manifest = json.load(f)
        with self._lock:
            version = self.version
        if int(manifest.get('version', 0)) != version:
            raise ValueError(
                'segment manifest version %s does not match quant '
                'sidecar version %d in `%s` — interrupted compaction; '
                'rebuild the index'
                % (manifest.get('version'), version, self.store.path))
        segments = list(manifest.get('segments', []))
        if not segments:
            return
        vec_parts, code_parts, assign_parts, id_parts = [], [], [], []
        labels: List[str] = []
        for seg in segments:
            data = np.load(os.path.join(self.store.path, seg['file']),
                           allow_pickle=False)
            vec_parts.append(np.asarray(data['vectors'],
                                        self.store.dtype))
            code_parts.append(np.asarray(data['codes']))
            assign_parts.append(np.asarray(data['assign'], np.int32))
            id_parts.append(np.asarray(data['row_ids'], np.int64))
            labels.extend(str(s) for s in data['labels'])
        with self._lock:
            self._segments = segments
            self._append_vectors = np.concatenate(vec_parts)
            self._append_codes = np.concatenate(code_parts)
            self._append_assign = np.concatenate(assign_parts)
            self._append_row_ids = np.concatenate(id_parts)
            self._append_labels = labels
            self._refresh_append_device_locked()

    # ------------------------------------------------------------- build
    @classmethod
    def build(cls, store: VectorStore, kind: str = 'pq',
              n_clusters: Optional[int] = None,
              iters: int = DEFAULT_ITERS, seed: int = 0,
              nprobe: int = DEFAULT_NPROBE,
              rerank: int = DEFAULT_RERANK, pq_m: int = 0,
              segment_rows: int = DEFAULT_SEGMENT_ROWS,
              compact_segments: int = DEFAULT_COMPACT_SEGMENTS,
              persist: bool = True, log=None,
              device=None) -> 'QuantizedIVFIndex':
        if kind not in QUANT_KINDS:
            raise ValueError('index quant kind must be one of %s, got %r'
                             % (QUANT_KINDS, kind))
        device = resolve_device(device)
        t0 = time.perf_counter()
        n_clusters = (n_clusters if n_clusters
                      else default_clusters(store.count))
        vectors = np.asarray(store.all_rows(), np.float32)
        centroids, assign = kmeans(vectors, n_clusters, iters=iters,
                                   seed=seed, device=device)
        n_clusters = centroids.shape[0]
        list_ids, offsets = csr_lists(assign, n_clusters)
        rng = np.random.default_rng(seed)
        pick = None
        if store.count > TRAIN_SAMPLE:
            pick = rng.choice(store.count, size=TRAIN_SAMPLE,
                              replace=False)
        if kind == 'int8':
            sample = vectors if pick is None else vectors[pick]
            quant_const = train_int8(sample)
            codes = encode_int8(vectors, quant_const)
        else:
            # IVFADC: codebooks train on (and codes describe) the
            # residuals against each row's assigned coarse centroid
            m = resolve_pq_m(store.dim, pq_m)
            residuals = vectors - centroids[assign]
            sample = residuals if pick is None else residuals[pick]
            quant_const = train_pq(sample, m, iters=iters, seed=seed,
                                   device=device)
            codes = encode_pq(residuals, quant_const, device=device)
        build_s = time.perf_counter() - t0
        if persist:
            np.savez(os.path.join(store.path, IVF_NAME),
                     centroids=centroids, list_ids=list_ids,
                     offsets=offsets)
        index = cls(store, kind=kind, nprobe=nprobe, rerank=rerank,
                    segment_rows=segment_rows,
                    compact_segments=compact_segments,
                    centroids=centroids, list_ids=list_ids,
                    offsets=offsets, codes=codes,
                    quant_const=quant_const, version=0, device=device)
        if persist:
            with index._lock:
                index._persist_quant_locked(codes)
                # a rebuild over a previously-live store resets any stale
                # segment sidecars along with the manifest
                for name in sorted(os.listdir(store.path)):
                    if name.startswith('segment_') and name.endswith('.npz'):
                        os.unlink(os.path.join(store.path, name))
                index._persist_manifest_locked()
        if tele_core.enabled():
            tele_core.registry().gauge('index/build_s').set(build_s)
        if log is not None:
            log('index: quantized tier built — %s codes, %d bytes/'
                'vector (f16 would be %d), %d clusters over %d vectors '
                'in %.1fs'
                % (kind, index.bytes_per_vector,
                   2 * store.dim, n_clusters, store.count, build_s))
        return index

    # ----------------------------------------------------------- device
    def _install_base_locked(self, sorted_codes: np.ndarray) -> None:
        """Place the cluster-sorted codes + codec constants, and account
        them in the `index` bucket (base codes and each segment register
        apart)."""
        ledger = memory_lib.ledger()
        nbytes = int(sorted_codes.nbytes + self._quant_const.nbytes)
        try:
            self._base_codes_dev = place(sorted_codes, self.device)
            self._quant_dev = place(self._quant_const, self.device)
        except Exception as exc:
            ledger.note_oom(exc, 'index.attach')
            raise
        ledger.register(
            'index', 'quant:%x:base' % id(self), nbytes, owner=self,
            attrs={'tier': 'quant', 'kind': self.kind,
                   'vectors': self._base_rows,
                   'code_bytes': self._code_width,
                   'clusters': self.n_clusters,
                   'version': self.version})
        self.device_nbytes += nbytes

    def _refresh_append_device_locked(self) -> None:
        """Rebuild the padded append buffer after an insert or
        compaction: codes padded to a ``bucketed_capacity`` rung,
        budget-checked before placement, registered per segment."""
        ledger = memory_lib.ledger()
        used = int(self._append_codes.shape[0])
        old_capacity = self._append_capacity
        for i in range(self._seg_entries):
            ledger.release('index', 'quant:%x:seg%05d' % (id(self), i))
        ledger.release('index', 'quant:%x:segslack' % id(self))
        self._seg_entries = 0
        if used == 0:
            self._append_dev = None
            self._append_capacity = 0
            self.device_nbytes -= old_capacity * self._code_width
            self._export_segment_gauges_locked()
            return
        capacity = bucketed_capacity(used, self.segment_rows)
        padded = self._append_codes
        if capacity > used:
            padded = np.concatenate(
                [padded, np.zeros((capacity - used, self._code_width),
                                  padded.dtype)])
        delta = (capacity - old_capacity) * self._code_width
        if delta > 0:
            ledger.check_budget(
                delta, 'index append segment (quantized tier: %d rows '
                       'x %d code bytes)' % (capacity, self._code_width))
        try:
            self._append_dev = place(padded, self.device)
        except Exception as exc:
            ledger.note_oom(exc, 'index.insert')
            raise
        self._append_capacity = capacity
        self.device_nbytes += delta
        for i, seg in enumerate(self._segments):
            ledger.register(
                'index', 'quant:%x:seg%05d' % (id(self), i),
                int(seg['rows']) * self._code_width, owner=self,
                attrs={'tier': 'quant', 'segment': seg['file'],
                       'rows': int(seg['rows']),
                       'version': self.version})
        self._seg_entries = len(self._segments)
        slack = capacity - used
        if slack:
            ledger.register(
                'index', 'quant:%x:segslack' % id(self),
                slack * self._code_width, owner=self,
                attrs={'tier': 'quant', 'rows': slack,
                       'reason': 'append buffer capacity rung padding'})
        self._export_segment_gauges_locked()

    def _export_segment_gauges_locked(self) -> None:
        if not tele_core.enabled():
            return
        reg = tele_core.registry()
        reg.gauge('index/segments').set(float(len(self._segments)))
        reg.gauge('index/append_rows').set(
            float(self._append_codes.shape[0]))

    # ------------------------------------------------------- properties
    @property
    def count(self) -> int:
        """Total queryable rows: base + uncompacted appends."""
        with self._lock:
            return self._base_rows + int(self._append_codes.shape[0])

    @property
    def bytes_per_vector(self) -> int:
        """Device-resident code bytes per vector (int8: dim; pq: M)."""
        return self._code_width

    @property
    def segment_count(self) -> int:
        with self._lock:
            return len(self._segments)

    @property
    def labels(self) -> Optional[np.ndarray]:
        base = self.store.labels
        if base is None:
            return None
        with self._lock:
            if not self._append_labels:
                return base
            return np.concatenate(
                [base, np.array(self._append_labels, dtype=object)])

    # ----------------------------------------------------------- search
    def _probe(self, queries: np.ndarray, cand: np.ndarray,
               cand_offsets: np.ndarray, r_depth: int, buffers
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device half of a search over one consistent ``(base, segment)``
        snapshot: gather the candidates' codes, score them, top-R per
        query, in query chunks that bound the gather."""
        base_rows, seg_capacity, base_codes, seg_codes, quant = buffers
        q = prepare_queries(queries, self.metric == 'cosine', self.device)
        cand_dev = place(cand.astype(np.int32), self.device).long()
        offsets_dev = place(cand_offsets, self.device)
        capacity = cand.shape[1]
        row_bytes = (4 * self._code_width if self.kind == 'int8'
                     else 8 * self.pq_m)
        chunk = query_chunk(capacity, row_bytes)
        values, positions = [], []
        for s in range(0, q.shape[0], chunk):
            c = cand_dev[s:s + chunk]
            qc = q[s:s + chunk]
            rows = base_codes[torch.clamp(c, 0, base_rows - 1)]
            if seg_capacity:
                seg_part = seg_codes[torch.clamp(c - base_rows, 0,
                                                 seg_capacity - 1)]
                rows = torch.where((c >= base_rows)[..., None], seg_part,
                                   rows)                 # (Qc, cap, W)
            if self.kind == 'int8':
                scores = torch.bmm(rows.float(),
                                   (qc * quant[None, :])[:, :, None])[..., 0]
            else:
                # asymmetric distance over residual codes: the coarse
                # term per candidate (host-filled), the residual term a
                # per-query LUT (Qc, M, 256) + a flat gather-accumulate
                lut = torch.einsum(
                    'qmd,mkd->qmk',
                    qc.reshape(qc.shape[0], self.pq_m, self.pq_dsub), quant)
                flat_lut = lut.reshape(qc.shape[0], self.pq_m * self.pq_k)
                idx = (rows.long() + (torch.arange(
                    self.pq_m, device=self.device) * self.pq_k)[None, None])
                gathered = torch.gather(
                    flat_lut, 1, idx.reshape(qc.shape[0], -1)).reshape(
                        idx.shape)
                scores = offsets_dev[s:s + chunk] + gathered.sum(dim=-1)
            scores = torch.where(c >= 0, scores,
                                 scores.new_full((), float('-inf')))
            v, p = padded_local_topk(scores, r_depth)
            values.append(v)
            positions.append(p)
        return torch.cat(values), torch.cat(positions)

    def search(self, queries: np.ndarray, k: int,
               nprobe: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, D) queries -> ((Q, k) scores, (Q, k) ORIGINAL row ids).
        Candidates come from the probed base lists PLUS any append
        segments; scores are quantized unless ``rerank > 0``, in which
        case the top-R candidates are re-scored exactly from the mmap
        store. -inf/-1 sentinels pad queries with fewer than ``k``
        candidates."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        n = queries.shape[0]
        t0 = time.perf_counter()
        with self._lock:
            base_rows = self._base_rows
            list_ids = self.list_ids
            offsets = self.offsets
            lengths = self.list_lengths
            append_assign = self._append_assign
            append_row_ids = self._append_row_ids
            append_used = int(append_assign.shape[0])
            seg_capacity = self._append_capacity if append_used else 0
            buffers = (base_rows, seg_capacity, self._base_codes_dev,
                       self._append_dev if seg_capacity else None,
                       self._quant_dev)
        nprobe = min(self.n_clusters,
                     nprobe if nprobe is not None else self.nprobe)
        qn = queries
        if self.metric == 'cosine':
            qn = normalize_rows(queries)
        # coarse scores serve double duty: probe selection AND (pq) the
        # per-candidate q.centroid offset of the residual decomposition
        coarse = qn @ self.centroids.T                   # (Q, C)
        probe = np.argsort(-coarse, axis=-1,
                           kind='stable')[:, :nprobe]
        starts = offsets[probe]
        lens = lengths[probe]
        totals = lens.sum(axis=1)
        matches: List[np.ndarray] = []
        if append_used:
            for row in range(n):
                matches.append(
                    np.nonzero(np.isin(append_assign, probe[row]))[0])
            totals = totals + np.array([m.shape[0] for m in matches],
                                       totals.dtype)
        capacity = bucketed_capacity(int(totals.max(initial=1)),
                                     MIN_PROBE_CAPACITY)
        cand = np.full((n, capacity), -1, np.int64)
        cand_offsets = np.zeros((n, capacity), np.float32)
        for row in range(n):
            pos = 0
            for cluster, start, length in zip(probe[row], starts[row],
                                              lens[row]):
                cand[row, pos:pos + length] = np.arange(start,
                                                        start + length)
                cand_offsets[row, pos:pos + length] = coarse[row,
                                                             cluster]
                pos += length
            if append_used and matches[row].shape[0]:
                hit = matches[row]
                cand[row, pos:pos + hit.shape[0]] = base_rows + hit
                cand_offsets[row, pos:pos + hit.shape[0]] = \
                    coarse[row, append_assign[hit]]
        self.last_fill_s = time.perf_counter() - t0
        r_depth = min(capacity,
                      max(k, self.rerank) if self.rerank else k)
        q_bucket = _pick_bucket(n, DEFAULT_QUERY_BUCKETS)
        queries_in = queries
        if q_bucket != n:
            queries_in = np.concatenate(
                [queries,
                 np.zeros((q_bucket - n, self.dim), np.float32)])
            cand = np.concatenate(
                [cand, np.full((q_bucket - n, capacity), -1, np.int64)])
            cand_offsets = np.concatenate(
                [cand_offsets,
                 np.zeros((q_bucket - n, capacity), np.float32)])
        values, positions = self._probe(queries_in, cand, cand_offsets,
                                        r_depth, buffers)
        values = values[:n].cpu().numpy()
        positions = positions[:n].cpu().numpy()
        # positions index the (Q, capacity) candidate axis -> combined
        # position space: [0, base_rows) is the cluster-sorted base,
        # [base_rows, base_rows+append) the insert-ordered segments
        comb = np.take_along_axis(cand[:n], np.maximum(positions, 0),
                                  axis=-1)
        base_ids = list_ids[np.clip(comb, 0, base_rows - 1)]
        if append_used:
            app_ids = append_row_ids[
                np.clip(comb - base_rows, 0, append_used - 1)]
            ids = np.where(comb >= base_rows, app_ids, base_ids)
        else:
            ids = base_ids
        ids = np.where((positions >= 0) & (comb >= 0), ids, -1)
        if self.rerank:
            values, ids = self._rerank_exact(queries, values, ids, k)
        else:
            values, ids = values[:, :k], ids[:, :k]
        if values.shape[1] < k:
            pad = k - values.shape[1]
            values = np.concatenate(
                [values, np.full((n, pad), -np.inf, values.dtype)],
                axis=1)
            ids = np.concatenate(
                [ids, np.full((n, pad), -1, ids.dtype)], axis=1)
        if tele_core.enabled():
            reg = tele_core.registry()
            reg.counter('index/queries_total').inc(n)
            reg.timer('index/query_latency_ms').record(
                time.perf_counter() - t0)
            reg.gauge('index/probe_fanout').set(float(totals.mean()))
        return values, ids

    def _rerank_exact(self, queries: np.ndarray, values: np.ndarray,
                      ids: np.ndarray, k: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact re-scoring of the quantized top-R on the host: rows come
        back from the mmap store or the host segment copies, scores
        recompute in f32, and the order is the ``(-score, id)`` sort —
        bit for rank whenever R covers the candidate set."""
        q = np.asarray(queries, np.float32)
        if self.metric == 'cosine':
            q = normalize_rows(q)
        n, r_depth = ids.shape
        with self._lock:
            store_rows = self._store_rows
            append_vectors = self._append_vectors
        flat = ids.ravel()
        vecs = np.zeros((flat.shape[0], self.dim), np.float32)
        base_sel = (flat >= 0) & (flat < store_rows)
        app_sel = flat >= store_rows
        if base_sel.any():
            vecs[base_sel] = np.asarray(self.store.take(flat[base_sel]),
                                        np.float32)
        if app_sel.any():
            vecs[app_sel] = np.asarray(
                append_vectors[flat[app_sel] - store_rows], np.float32)
        scores = np.einsum('qd,qrd->qr', q,
                           vecs.reshape(n, r_depth, self.dim))
        scores = np.where(ids >= 0, scores, -np.inf)
        order = np.lexsort((ids, -scores), axis=-1)[:, :k]
        return (np.take_along_axis(scores, order, axis=-1),
                np.take_along_axis(ids, order, axis=-1))

    def warmup(self, k: int, nprobe: Optional[int] = None) -> int:
        """Run one search per query bucket at the current capacity rungs
        (nothing to compile). Returns the number of buckets run."""
        warmed = 0
        for bucket in DEFAULT_QUERY_BUCKETS:
            self.search(np.zeros((bucket, self.dim), np.float32), k,
                        nprobe=nprobe)
            warmed += 1
        return warmed

    # ---------------------------------------------------------- inserts
    def insert(self, vectors: np.ndarray,
               labels: Optional[Sequence[str]] = None) -> np.ndarray:
        """Append live vectors: encoded with the FROZEN codecs, assigned
        to the existing coarse lists, persisted as versioned segment
        sidecars, and queryable at once (no rebuild). Returns the
        assigned global row ids. An empty batch records an empty segment
        and allocates nothing. Triggers ``compact()`` when the segment
        count passes ``compact_segments`` (0 disables it)."""
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        if vectors.size and vectors.shape[1] != self.dim:
            raise ValueError('inserted vectors must be (n, %d), got %r'
                             % (self.dim, vectors.shape))
        n_new = int(vectors.shape[0])
        if self.store.normalized:
            vectors = normalize_rows(vectors)
        canonical = np.ascontiguousarray(vectors, self.store.dtype)
        # encode from the canonical (store-dtype) rows so pre- and
        # post-compaction scoring see bit-identical inputs
        encode_from = np.asarray(canonical, np.float32)
        if n_new:
            assign = np.argmax(
                encode_from @ self.centroids.T, axis=-1).astype(np.int32)
            if self.kind == 'int8':
                codes = encode_int8(encode_from, self._quant_const)
            else:
                codes = encode_pq(
                    encode_from - self.centroids[assign],
                    self._quant_const, device=self.device)
        else:
            assign = np.empty((0,), np.int32)
            codes = np.empty((0, self._code_width),
                             np.int8 if self.kind == 'int8' else np.uint8)
        row_labels = ([str(item) for item in labels]
                      if labels is not None else [''] * n_new)
        if len(row_labels) != n_new:
            raise ValueError('%d labels for %d inserted vectors'
                             % (len(row_labels), n_new))
        with self._lock:
            next_id = self._store_rows + self._append_row_ids.shape[0]
            row_ids = np.arange(next_id, next_id + n_new, dtype=np.int64)
            # page the batch into segments of segment_rows; an empty batch
            # is one empty segment
            cursor = 0
            while True:
                rows_here = min(self.segment_rows, n_new - cursor)
                seg_file = SEGMENT_PATTERN % len(self._segments)
                seg_path = os.path.join(self.store.path, seg_file)
                tmp = seg_path + '.tmp.npz'
                sl = slice(cursor, cursor + rows_here)
                np.savez(tmp, vectors=canonical[sl], codes=codes[sl],
                         assign=assign[sl], row_ids=row_ids[sl],
                         labels=np.asarray(row_labels[sl], dtype=str))
                os.replace(tmp, seg_path)
                self._segments.append({'file': seg_file,
                                       'rows': rows_here})
                cursor += rows_here
                if cursor >= n_new:
                    break
            self._persist_manifest_locked()
            self._append_vectors = np.concatenate(
                [self._append_vectors, canonical])
            self._append_codes = np.concatenate(
                [self._append_codes, codes])
            self._append_assign = np.concatenate(
                [self._append_assign, assign])
            self._append_row_ids = np.concatenate(
                [self._append_row_ids, row_ids])
            self._append_labels.extend(row_labels)
            self._refresh_append_device_locked()
            if tele_core.enabled():
                tele_core.registry().counter(
                    'index/inserts_total').inc(n_new)
            if (self.compact_segments
                    and len(self._segments) > self.compact_segments):
                self.compact()
        return row_ids

    def compact(self) -> int:
        """Fold append segments into the base CSR + store: appended
        vectors land as new store shards (``append_rows``), the inverted
        lists rebuild by a stable re-sort of the EXISTING assignments (no
        k-means rebuild), the sidecar version bumps, and the segment
        files retire. Returns the rows compacted. Holds the index lock
        throughout: concurrent inserts and searches wait and land against
        the compacted index."""
        t0 = time.perf_counter()
        with self._lock:
            compacted = int(self._append_codes.shape[0])
            ledger = memory_lib.ledger()
            if compacted:
                has_labels = self.store.labels is not None
                self.store.append_rows(
                    self._append_vectors,
                    labels=(self._append_labels if has_labels
                            else None),
                    canonical=True)
                row_codes = np.concatenate(
                    [self._load_row_codes(), self._append_codes])
                base_assign = np.empty((self._base_rows,), np.int64)
                base_assign[self.list_ids] = np.repeat(
                    np.arange(self.n_clusters), self.list_lengths)
                assign_all = np.concatenate(
                    [base_assign,
                     self._append_assign.astype(np.int64)])
                self.list_ids, self.offsets = csr_lists(assign_all,
                                                        self.n_clusters)
                self.list_lengths = np.diff(self.offsets)
                self._base_rows = int(row_codes.shape[0])
                self._store_rows = self.store.count
            else:
                row_codes = None
            self.version += 1
            if row_codes is not None:
                self._persist_quant_locked(row_codes)
                np.savez(os.path.join(self.store.path, IVF_NAME),
                         centroids=self.centroids,
                         list_ids=self.list_ids, offsets=self.offsets)
            for seg in self._segments:
                try:
                    os.unlink(os.path.join(self.store.path,
                                           seg['file']))
                except OSError:
                    pass
            self._segments = []
            self._persist_manifest_locked()
            self._append_vectors = np.empty((0, self.dim),
                                            self.store.dtype)
            self._append_codes = np.empty(
                (0, self._code_width), self._append_codes.dtype)
            self._append_assign = np.empty((0,), np.int32)
            self._append_row_ids = np.empty((0,), np.int64)
            self._append_labels = []
            if row_codes is not None:
                sorted_codes = row_codes[self.list_ids]
                ledger.release('index', 'quant:%x:base' % id(self))
                self.device_nbytes = 0
                ledger.check_budget(
                    int(sorted_codes.nbytes + self._quant_const.nbytes),
                    'index compaction (quantized tier: %d vectors x %d '
                    'code bytes)'
                    % (self._base_rows, self._code_width))
                self._install_base_locked(sorted_codes)
            self._refresh_append_device_locked()
            self.compactions += 1
            if tele_core.enabled():
                reg = tele_core.registry()
                reg.counter('index/compactions_total').inc()
                reg.gauge('index/compact_s').set(
                    time.perf_counter() - t0)
        return compacted
