"""IVF approximate tier: k-means coarse quantizer + inverted lists — the
port of ``code2vec_tpu/index/ivf.py``.

1. **Build** — k-means on the device (Lloyd iterations: the assignment is
   an ``(N, D) @ (D, C)`` product + argmax, the first maximum on ties as
   ``jnp.argmax``), then the store rows are reordered into cluster-sorted
   order so each inverted list is a contiguous slice (CSR offsets).
   The reference's update is a ``segment_sum``; its counterpart,
   ``index_add_``, is an atomic sum on the card whose order changes from
   run to run, so here the update is a one-hot product summed over fixed
   row chunks (``segment_sum``): two builds of one store write the same
   ``ivf.npz``.
2. **Query** — score the C centroids on the host (C is tiny), take the
   top ``nprobe`` lists, fill the candidate positions on the host (the
   reference's per-query loop, faithfully: ROADMAP lists it as speed
   work), gather their rows on the device, score them in fp32 and take
   ``padded_local_topk``. The capacity rides
   ``data/packed.py::bucketed_capacity``. The gather is ``(Q, cap, D)``:
   eager torch does not fuse it into the product as XLA does, so the
   queries go through in chunks that bound it to ``GATHER_BYTES``.

Persistence: ``ivf.npz`` (centroids, cluster-sorted row ids, CSR
offsets) inside the store directory, the reference's format.
"""
from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from code2vec_tpu_torch.data.packed import bucketed_capacity
from code2vec_tpu_torch.device import resolve_device
from code2vec_tpu_torch.index.exact import (DEFAULT_QUERY_BUCKETS,
                                            _pick_bucket, place,
                                            prepare_queries)
from code2vec_tpu_torch.index.store import VectorStore
from code2vec_tpu_torch.ops.topk import padded_local_topk
from code2vec_tpu_torch.telemetry import core as tele_core
from code2vec_tpu_torch.telemetry import memory as memory_lib

IVF_NAME = 'ivf.npz'

DEFAULT_ITERS = 10
DEFAULT_NPROBE = 8
# probe-gather capacity floor (bucketed_capacity minimum): small enough
# that tiny test corpora stay cheap
MIN_PROBE_CAPACITY = 64
#: bound on the fp32 (chunk, cap, D) candidate gather of one query chunk
GATHER_BYTES = 1 << 29
#: bound on a k-means chunk's (rows, C) scores and one-hot
KMEANS_CHUNK_BYTES = 1 << 28


def default_clusters(count: int) -> int:
    """The classic sqrt(N) heuristic, floored at 1."""
    return max(1, int(np.sqrt(count)))


def segment_sum(data: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` of ``(N, D)`` rows by ``(N,)`` ids, in an
    order that does not change between runs: a one-hot ``(S, chunk)``
    product per fixed chunk of rows, summed chunk after chunk."""
    n = data.shape[0]
    chunk = max(1, KMEANS_CHUNK_BYTES // (4 * max(num_segments, 1)))
    segments = torch.arange(num_segments, device=data.device)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    for start in range(0, n, chunk):
        onehot = (ids[start:start + chunk, None] == segments).to(data.dtype)
        out += onehot.T @ data[start:start + chunk]
    return out


def nearest(data: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(N,) int64 argmax of ``data @ centroids.T`` (first maximum), in row
    chunks that bound the (rows, C) scores."""
    chunk = max(1, KMEANS_CHUNK_BYTES // (4 * centroids.shape[0]))
    return torch.cat([torch.argmax(data[s:s + chunk] @ centroids.T, dim=-1)
                      for s in range(0, data.shape[0], chunk)])


def kmeans(vectors: np.ndarray, n_clusters: int,
           iters: int = DEFAULT_ITERS, seed: int = 0, device=None
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd iterations on ``device``; returns (centroids (C, D) float32,
    assignment (N,) int32). Assignment maximizes the dot product —
    equivalent to min-L2 for the normalized rows of a cosine store.
    Empty clusters keep their previous centroid."""
    device = resolve_device(device)
    vectors = np.asarray(vectors, np.float32)
    n, _dim = vectors.shape
    n_clusters = min(n_clusters, n)
    rng = np.random.default_rng(seed)
    init = vectors[rng.choice(n, size=n_clusters, replace=False)]
    data = place(vectors, device)
    centroids = place(init, device)
    assign = None
    for _ in range(max(1, iters)):
        assign = nearest(data, centroids)
        sums = segment_sum(data, assign, n_clusters)
        counts = torch.bincount(assign, minlength=n_clusters).float()
        means = sums / torch.clamp(counts, min=1.0)[:, None]
        # empty cluster: keep the old centroid instead of collapsing to 0
        centroids = torch.where((counts > 0)[:, None], means, centroids)
    return (centroids.cpu().numpy().astype(np.float32),
            assign.cpu().numpy().astype(np.int32))


def csr_lists(assign: np.ndarray, n_clusters: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(list_ids, offsets): a stable sort keeps ascending row ids inside
    each list (deterministic probe order)."""
    list_ids = np.argsort(assign, kind='stable').astype(np.int64)
    counts = np.bincount(assign, minlength=n_clusters)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return list_ids, offsets


def fill_candidates(starts: np.ndarray, lengths: np.ndarray,
                    capacity: int) -> np.ndarray:
    """(Q, capacity) int64 positions in the cluster-sorted matrix: the
    ``[start, start + length)`` runs of each query's probed lists, -1
    after them (the reference's per-query loop)."""
    n = starts.shape[0]
    cand = np.full((n, capacity), -1, np.int64)
    for r in range(n):
        pos = 0
        for start, length in zip(starts[r], lengths[r]):
            cand[r, pos:pos + length] = np.arange(start, start + length)
            pos += length
    return cand


def query_chunk(capacity: int, row_bytes: int) -> int:
    """Queries per chunk so that one chunk's ``(chunk, capacity)``
    candidate rows of ``row_bytes`` each stay under ``GATHER_BYTES``."""
    return max(1, GATHER_BYTES // max(1, capacity * row_bytes))


class IVFIndex:
    """nprobe-bounded approximate k-NN over a built store.

    Build with ``IVFIndex.build(store, ...)`` (persists ``ivf.npz``) or
    reopen with ``IVFIndex(store)`` when the sidecar exists."""

    def __init__(self, store: VectorStore, centroids: np.ndarray = None,
                 list_ids: np.ndarray = None, offsets: np.ndarray = None,
                 nprobe: int = DEFAULT_NPROBE,
                 vectors: Optional[np.ndarray] = None, device=None):
        self.device = resolve_device(device)
        self.store = store
        self.metric = store.metric
        self.labels = store.labels
        self.count = store.count
        self.dim = store.dim
        self.nprobe = nprobe
        if centroids is None:
            sidecar = os.path.join(store.path, IVF_NAME)
            if not os.path.isfile(sidecar):
                raise FileNotFoundError(
                    'no IVF sidecar at `%s` — build one with '
                    'IVFIndex.build(store) or --build-index '
                    '--index-kind ivf' % sidecar)
            data = np.load(sidecar)
            centroids = data['centroids']
            list_ids = data['list_ids']
            offsets = data['offsets']
        self.centroids = np.asarray(centroids, np.float32)
        self.n_clusters = self.centroids.shape[0]
        self.list_ids = np.asarray(list_ids, np.int64)
        self.offsets = np.asarray(offsets, np.int64)
        self.list_lengths = np.diff(self.offsets)
        # cluster-sorted rows on the device in the STORE dtype (float16
        # stores stay halved); build() hands over its loaded array
        rows = (np.asarray(vectors, store.dtype) if vectors is not None
                else store.all_rows())[self.list_ids]
        self.device_nbytes = int(rows.nbytes) + int(self.centroids.nbytes)
        memory_lib.ledger().check_budget(
            self.device_nbytes,
            'index attach (IVF tier: %d vectors x %d dims, %d clusters)'
            % (self.count, self.dim, self.n_clusters))
        try:
            self._sorted_rows = place(rows, self.device)
            self._centroids_dev = place(self.centroids, self.device)
        except Exception as exc:
            memory_lib.ledger().note_oom(exc, 'index.attach')
            raise
        memory_lib.ledger().register(
            'index', 'ivf:%x' % id(self), self.device_nbytes,
            owner=self, attrs={'tier': 'ivf', 'vectors': self.count,
                               'dim': self.dim,
                               'clusters': self.n_clusters})
        #: host seconds of the last search's candidate fill
        self.last_fill_s = 0.0

    # ------------------------------------------------------------- build
    @classmethod
    def build(cls, store: VectorStore, n_clusters: Optional[int] = None,
              iters: int = DEFAULT_ITERS, seed: int = 0,
              nprobe: int = DEFAULT_NPROBE, persist: bool = True,
              log=None, device=None) -> 'IVFIndex':
        t0 = time.perf_counter()
        n_clusters = (n_clusters if n_clusters
                      else default_clusters(store.count))
        vectors = np.asarray(store.all_rows(), np.float32)
        centroids, assign = kmeans(vectors, n_clusters, iters=iters,
                                   seed=seed, device=device)
        n_clusters = centroids.shape[0]
        list_ids, offsets = csr_lists(assign, n_clusters)
        counts = np.diff(offsets)
        if persist:
            np.savez(os.path.join(store.path, IVF_NAME),
                     centroids=centroids, list_ids=list_ids,
                     offsets=offsets)
        build_s = time.perf_counter() - t0
        if tele_core.enabled():
            tele_core.registry().gauge('index/build_s').set(build_s)
        if log is not None:
            occupied = int((counts > 0).sum())
            log('index: IVF built — %d clusters (%d occupied, p50 list '
                '%d rows) over %d vectors in %.1fs'
                % (n_clusters, occupied,
                   int(np.median(counts[counts > 0])) if occupied else 0,
                   store.count, build_s))
        return cls(store, centroids=centroids, list_ids=list_ids,
                   offsets=offsets, nprobe=nprobe, vectors=vectors,
                   device=device)

    # ------------------------------------------------------------ search
    def _coarse(self, queries: np.ndarray, nprobe: int) -> np.ndarray:
        """Top-``nprobe`` cluster ids per query (host numpy)."""
        q = queries
        if self.metric == 'cosine':
            norms = np.linalg.norm(q, axis=-1, keepdims=True)
            q = q / np.where(norms > 0, norms, 1.0)
        scores = q @ self.centroids.T
        return np.argsort(-scores, axis=-1, kind='stable')[:, :nprobe]

    def _probe(self, queries: np.ndarray, cand: np.ndarray, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device half of a search: gather, fp32 scores, top-k per query,
        in query chunks that bound the gather."""
        q = prepare_queries(queries, self.metric == 'cosine', self.device)
        cand_dev = place(cand.astype(np.int32), self.device).long()
        chunk = query_chunk(cand.shape[1], 4 * self.dim)
        values, positions = [], []
        for s in range(0, q.shape[0], chunk):
            c = cand_dev[s:s + chunk]
            rows = self._sorted_rows[torch.clamp(c, min=0)].float()
            scores = torch.bmm(rows, q[s:s + chunk, :, None])[..., 0]
            scores = torch.where(c >= 0, scores,
                                 scores.new_full((), float('-inf')))
            v, p = padded_local_topk(scores, k)
            values.append(v)
            positions.append(p)
        return torch.cat(values), torch.cat(positions)

    def search(self, queries: np.ndarray, k: int,
               nprobe: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, D) queries -> ((Q, k) scores, (Q, k) ORIGINAL row ids).
        Approximate: only the ``nprobe`` best inverted lists per query
        are scored. Queries with fewer than ``k`` candidates in their
        probed lists pad the tail with -inf/-1 sentinels."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        n = queries.shape[0]
        nprobe = min(self.n_clusters,
                     nprobe if nprobe is not None else self.nprobe)
        t0 = time.perf_counter()
        probe = self._coarse(queries, nprobe)            # (Q, nprobe)
        starts = self.offsets[probe]
        lengths = self.list_lengths[probe]
        totals = lengths.sum(axis=1)
        capacity = bucketed_capacity(int(totals.max(initial=1)),
                                     MIN_PROBE_CAPACITY)
        cand = fill_candidates(starts, lengths, capacity)
        self.last_fill_s = time.perf_counter() - t0
        q_bucket = _pick_bucket(n, DEFAULT_QUERY_BUCKETS)
        if q_bucket != n:
            queries = np.concatenate(
                [queries, np.zeros((q_bucket - n, self.dim), np.float32)])
            cand = np.concatenate(
                [cand, np.full((q_bucket - n, capacity), -1, np.int64)])
        values, positions = self._probe(queries, cand, k)
        values = values[:n].cpu().numpy()
        positions = positions[:n].cpu().numpy()
        # positions index the (Q, capacity) candidate axis -> map back to
        # cluster-sorted positions, then through list_ids to row ids
        sorted_pos = np.take_along_axis(
            cand[:n], np.maximum(positions, 0), axis=-1)
        indices = np.where((positions >= 0) & (sorted_pos >= 0),
                           self.list_ids[np.maximum(sorted_pos, 0)], -1)
        if tele_core.enabled():
            reg = tele_core.registry()
            reg.counter('index/queries_total').inc(n)
            reg.timer('index/query_latency_ms').record(
                time.perf_counter() - t0)
            reg.gauge('index/probe_fanout').set(float(totals.mean()))
        return values, indices


def measure_recall(approx_index, exact_index, queries: np.ndarray,
                   k: int = 10, nprobe: Optional[int] = None) -> float:
    """recall@k of the approximate tier against the exact tier on a
    query sample: |approx ∩ exact| / k, averaged over queries."""
    _val_a, idx_a = approx_index.search(queries, k, nprobe=nprobe)
    _val_e, idx_e = exact_index.search(queries, k)
    hits = 0
    for row_a, row_e in zip(idx_a, idx_e):
        hits += len(set(int(i) for i in row_a if i >= 0)
                    & set(int(i) for i in row_e))
    recall = hits / float(idx_e.shape[0] * idx_e.shape[1])
    if tele_core.enabled():
        tele_core.registry().gauge('index/recall_at10').set(recall)
    return recall
