"""Brute-force exact k-NN over a device-resident store — the port of
``code2vec_tpu/index/exact.py``.

The search is a ``(Q, D) @ (D, N)`` product in float32 accumulation
whatever the store dtype (a float16 store's rows are upcast block by
block; the queries are first rounded to the store dtype, as the
reference casts them) and a top-k in ``lax.top_k``'s order. The product
is ``torch.matmul``: the reference computes it outside any Pallas
kernel. TF32 is off (``device.py``), so it is a true fp32 product.

The reference materializes the ``(Q, N)`` scores; here the store is
searched in column blocks of ``block_rows``: one product and one
``padded_local_topk`` per block, then an exact merge (``merge_topk``) in
the same order, so the transient memory is that of one block — it is
charged to the budget check with the store. The blocked search is equal,
bit for rank, to the unblocked one (tests/test_torch_index.py).

Query batches ride the bucket ladder ``DEFAULT_QUERY_BUCKETS``
(``serving/engine.py::pick_bucket``); ``warmup(k)`` runs each bucket
once. Nothing is compiled and nothing is captured.

Two tiers:

- ``ExactIndex`` — the whole store resident on the device;
- ``search_streamed`` — stores larger than device memory: each mmap
  shard goes up on its own, its ``padded_local_topk`` comes back (a
  shard may hold fewer than k rows: -inf/-1 sentinels), and
  ``merge_topk_host`` merges them on the host.

The sharded route (``mesh=`` a (data, model) mesh of ranks,
``parallel/mesh.py``, whose data axis is above 1; the reference's
``P(DATA_AXIS, None)`` store): the N rows are padded to N_pad, a multiple
of the data axis D, and rank (d, m) holds rows [d N_pad / D, (d + 1)
N_pad / D) (model-axis siblings hold the same shard, as the reference's
spec replicates it over 'model'). The padding is never placed: a shard
holds its real rows only (the last ones may hold fewer, or none), so a
padding row never ranks; its blocked search pads its candidates with
-inf/-1 sentinels instead of the reference's -inf row mask. Each rank
takes its shard's top k with global row ids, and
``ops/topk.py::merge_shard_candidates`` merges them over the data column
(``sharded_top_k(..., shard_axis='data')``): equal results on every
rank, in ``lax.top_k``'s order. The budget check, the ledger and
``device_nbytes`` charge a rank's shard; ``index/shard_rows`` is N_pad /
D. A search is a collective: every rank of the mesh calls it, with the
same queries.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from code2vec_tpu_torch.device import resolve_device
from code2vec_tpu_torch.index.store import VectorStore, normalize_rows
from code2vec_tpu_torch.ops.topk import (PAD_INDEX, merge_shard_candidates,
                                         merge_topk, merge_topk_host,
                                         padded_local_topk)
from code2vec_tpu_torch.parallel import mesh as mesh_lib
from code2vec_tpu_torch.serving.engine import pick_bucket
from code2vec_tpu_torch.telemetry import core as tele_core
from code2vec_tpu_torch.telemetry import memory as memory_lib

DEFAULT_QUERY_BUCKETS = (1, 8, 64, 512)

#: store rows scored per block: a (512, 262144) fp32 block of scores is
#: 512 MiB, and the top-k over it makes a few more tensors of its shape
DEFAULT_BLOCK_ROWS = 1 << 18
#: tensors of a block's shape alive at once in the top-k: the scores, the
#: int32 tie key, its masks and selections (ops/topk.py::top_k)
_TOPK_TRANSIENTS = 5


def _pick_bucket(n: int, ladder: Sequence[int]) -> int:
    """Smallest ladder bucket covering ``n`` queries; past the ladder,
    the next multiple of the top bucket."""
    bucket = pick_bucket(n, ladder)
    if bucket is None:
        top = ladder[-1]
        bucket = -(-n // top) * top
    return bucket


def place(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` (a read-only mmap view is copied first:
    torch shares a host array's memory on the CPU)."""
    array = np.ascontiguousarray(array)
    if not array.flags.writeable:
        array = array.copy()
    return torch.from_numpy(array).to(device)


def prepare_queries(queries: np.ndarray, cosine: bool,
                    device: torch.device) -> torch.Tensor:
    """(Q, D) float32 queries on ``device``, L2-normalized for cosine
    (all-zero rows stay zero), as the reference's programs do."""
    q = place(np.asarray(queries, np.float32), device)
    if cosine:
        norms = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        q = q / torch.where(norms > 0, norms, torch.ones_like(norms))
    return q


def block_topk(q: torch.Tensor, rows: torch.Tensor, k: int,
               block_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``q @ rows.T`` (fp32 accumulation) over column
    blocks of ``block_rows``: each block's ``padded_local_topk`` with
    global indices, then ``merge_topk``. ``q`` is rounded to the rows'
    dtype first (the reference's ``q.astype(matrix.dtype)``). Fewer
    than ``k`` rows (none included) pad with -inf/-1 sentinels."""
    q = q.to(rows.dtype).float()
    count = rows.shape[0]
    if count == 0:
        return (q.new_full((q.shape[0], k), float('-inf')),
                torch.full((q.shape[0], k), PAD_INDEX, dtype=torch.int64,
                           device=q.device))
    values, indices = [], []
    for start in range(0, count, block_rows):
        block = rows[start:start + block_rows].float()
        v, i = padded_local_topk(q @ block.T, k)
        values.append(v)
        indices.append(torch.where(i >= 0, i + start, i))
    if len(values) == 1:
        return values[0], indices[0]
    return merge_topk(torch.cat(values, dim=-1),
                      torch.cat(indices, dim=-1), k)


class ExactIndex:
    """Device-resident exact-nearest-neighbor index over a store (or a
    raw ``(N, D)`` array for tests and benchmarks).

    ``device`` is ``cuda`` unless the caller passes 'cpu'; without a GPU
    and without that request the constructor raises. ``mesh`` (a
    ``parallel/mesh.py`` mesh of ranks; None: one rank) shards the rows
    over its data axis (the module docstring): every rank of it then
    builds the index, and calls ``warmup`` and ``search`` with the same
    queries."""

    def __init__(self, store, mesh=None,
                 metric: Optional[str] = None,
                 query_buckets: Sequence[int] = DEFAULT_QUERY_BUCKETS,
                 labels: Optional[np.ndarray] = None,
                 device=None, block_rows: int = DEFAULT_BLOCK_ROWS):
        if mesh is not None and not isinstance(mesh, mesh_lib.Mesh):
            raise TypeError(
                'mesh must be a (data, model) Mesh of ranks '
                '(code2vec_tpu_torch/parallel/mesh.py) or None, got %r'
                % (type(mesh).__name__,))
        self.device = resolve_device(device)
        if isinstance(store, VectorStore):
            vectors = store.all_rows()
            self.metric = store.metric if metric is None else metric
            normalized = store.normalized
            self.labels = store.labels if labels is None else labels
        else:
            vectors = np.asarray(store)
            self.metric = 'cosine' if metric is None else metric
            normalized = False
            self.labels = labels
        if vectors.ndim != 2:
            raise ValueError('store must be (N, D), got %r'
                             % (vectors.shape,))
        if self.metric == 'cosine' and not normalized:
            vectors = normalize_rows(vectors).astype(vectors.dtype)
        self.count = int(vectors.shape[0])
        self.dim = int(vectors.shape[1])
        self.query_buckets = tuple(sorted(set(int(b)
                                              for b in query_buckets)))
        self.block_rows = max(1, int(block_rows))
        # the sharded route: this rank's rows of the padded store (the
        # padding itself is never placed)
        self.mesh = mesh if mesh is not None and mesh.data > 1 else None
        data = self.mesh.data if self.mesh is not None else 1
        self.padded_rows = -(-self.count // data) * data
        self.shard_rows = self.padded_rows // data
        self.row_offset = (self.mesh.data_index * self.shard_rows
                           if self.mesh is not None else 0)
        vectors = vectors[self.row_offset:self.row_offset + self.shard_rows]
        # the budget gate sees the shard and the search's transient: one
        # block's scores and top-k tensors at the top bucket, and a
        # float16 block's upcast
        block = min(self.block_rows, self.shard_rows)
        transient = block * 4 * (_TOPK_TRANSIENTS * self.query_buckets[-1]
                                 + (self.dim if vectors.dtype != np.float32
                                    else 0))
        self.device_nbytes = int(vectors.nbytes)
        memory_lib.ledger().check_budget(
            self.device_nbytes + transient,
            'index attach (exact tier: %d of %d vectors x %d dims, %s, with '
            'a %d-row search block)' % (vectors.shape[0], self.count,
                                        self.dim,
                                        np.dtype(vectors.dtype).name, block))
        try:
            self._matrix = place(vectors, self.device)
        except Exception as exc:
            memory_lib.ledger().note_oom(exc, 'index.attach')
            raise
        memory_lib.ledger().register(
            'index', 'exact:%x' % id(self), self._matrix, owner=self,
            attrs={'tier': 'exact', 'vectors': self.count,
                   'dim': self.dim})
        if tele_core.enabled():
            reg = tele_core.registry()
            reg.gauge('index/vectors_total').set(self.count)
            reg.gauge('index/shard_rows').set(self.shard_rows)

    def warmup(self, k: int) -> 'ExactIndex':
        """Run every query bucket once at ``k`` (nothing to compile; the
        allocator's blocks for each shape are cached afterwards)."""
        t0 = time.perf_counter()
        for bucket in self.query_buckets:
            values, _indices = self.search_placed(
                torch.zeros((bucket, self.dim), device=self.device), k)
            values.cpu()
        if tele_core.enabled():
            tele_core.registry().gauge('index/warmup_s').set(
                time.perf_counter() - t0)
        return self

    def search_placed(self, q: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(Q, D) float32 queries already on the device and normalized ->
        ((Q, k) scores, (Q, k) int64 row ids), still on the device; on a
        mesh this rank's shard's candidates merged over the data column
        (every rank calls it with the same queries)."""
        k = min(k, self.count)
        values, indices = block_topk(q, self._matrix, k, self.block_rows)
        if self.mesh is None:
            return values, indices
        indices = torch.where(indices >= 0, indices + self.row_offset,
                              indices)
        return merge_shard_candidates(values, indices, k, self.mesh,
                                      mesh_lib.DATA_AXIS)

    def search(self, queries: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, D) queries -> ((Q, k) scores, (Q, k) row indices), exact,
        ranked by score then lowest index. ``k`` is capped at the store
        size. A single (D,) query is treated as Q=1. On a mesh every
        rank calls it with the same queries and gets the same answer."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if queries.shape[1] != self.dim:
            raise ValueError('queries have dim %d, store has %d'
                             % (queries.shape[1], self.dim))
        n = queries.shape[0]
        bucket = _pick_bucket(n, self.query_buckets)
        if bucket != n:
            queries = np.concatenate(
                [queries, np.zeros((bucket - n, self.dim), np.float32)])
        t0 = time.perf_counter()
        values, indices = self.search_placed(
            prepare_queries(queries, self.metric == 'cosine', self.device),
            k)
        # the copies wait on this thread's current stream only
        values = values[:n].cpu().numpy()
        indices = indices[:n].cpu().numpy()
        if tele_core.enabled():
            reg = tele_core.registry()
            reg.counter('index/queries_total').inc(n)
            reg.timer('index/query_latency_ms').record(
                time.perf_counter() - t0)
        return values, indices


def search_streamed(store: VectorStore, queries: np.ndarray, k: int,
                    device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-NN without keeping the store on the device: each mmap shard
    goes up padded to one chunk shape, its ``padded_local_topk`` comes
    back, and ``merge_topk_host`` merges the shards' candidates (index
    tie-breaking). Bit for rank equal to ``ExactIndex.search``."""
    device = resolve_device(device)
    queries = np.atleast_2d(np.asarray(queries, np.float32))
    k = min(k, store.count)
    n = queries.shape[0]
    q_bucket = _pick_bucket(n, DEFAULT_QUERY_BUCKETS)
    if q_bucket != n:
        queries = np.concatenate(
            [queries, np.zeros((q_bucket - n, store.dim), np.float32)])
    q = prepare_queries(queries, store.metric == 'cosine', device)
    if store.dtype == np.float16:
        q = q.half().float()     # the resident search's rounding of q
    chunk_rows = min(store.shard_rows, max(k, max(store.shards)))

    cand_values = []
    cand_indices = []
    for offset, rows in store.iter_shards():
        rows = np.asarray(rows)
        pad = chunk_rows - rows.shape[0]
        neg_mask = np.zeros((chunk_rows,), np.float32)
        if pad:
            rows = np.concatenate(
                [rows, np.zeros((pad, store.dim), rows.dtype)])
            neg_mask[-pad:] = -np.inf
        chunk = place(rows, device).float()
        scores = q @ chunk.T + place(neg_mask, device)
        values, indices = padded_local_topk(scores, k)
        values = values.cpu().numpy()
        indices = indices.cpu().numpy()
        # anything -inf (k-padding sentinels and chunk-padding rows)
        # becomes the -1 sentinel, so a padding row's local index never
        # aliases a later shard's global index
        indices = np.where(np.isfinite(values), indices + offset, -1)
        cand_values.append(values)
        cand_indices.append(indices)
    values, indices = merge_topk_host(
        np.concatenate(cand_values, axis=-1),
        np.concatenate(cand_indices, axis=-1), k)
    return values[:n], indices[:n]
