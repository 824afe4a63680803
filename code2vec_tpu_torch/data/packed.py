"""The packed wire format ("packed", format v2) — a copy of the host half
of ``code2vec_tpu/data/packed.py`` (with the sticky-capacity packer the
readers use) plus its segment arithmetic and the device unpack in torch.

Each batch ships as per-shard dense ``(data_shards, capacity, 3)`` int32
context triples plus per-example ``count``s: every example's leading
``count`` slots (``count`` = index of its last valid context + 1),
back to back, the tail of each shard filled with the PAD triple. An
interior all-PAD hole stays in the stream at its position.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from code2vec_tpu_torch.telemetry import core as tele_core

# floor for the bucketed capacity
MIN_CAPACITY = 64


class PackedBatch(NamedTuple):
    """One batch in the packed wire format; the host-only strings of the
    plane batch ride along for decoding."""
    ctx: np.ndarray                  # (D, cap, 3) int32
    count: np.ndarray                # (B,) int32 — effective lengths
    label: np.ndarray                # (B,) int32
    weight: np.ndarray               # (B,) float32
    label_strings: Optional[np.ndarray] = None     # (B,) object
    source_strings: Optional[np.ndarray] = None    # (B, C) object
    path_strings: Optional[np.ndarray] = None      # (B, C) object
    target_strings: Optional[np.ndarray] = None    # (B, C) object

    def device_arrays(self):
        """The arrays a step takes: ``(ctx, count, label, weight)``."""
        return self.ctx, self.count, self.label, self.weight


def bucketed_capacity(total: int, minimum: int = MIN_CAPACITY) -> int:
    """Round a context total up to a bucket of ~total/8 (power of two)."""
    cap = max(int(total), minimum)
    bucket = max(minimum, 1 << max(cap.bit_length() - 3, 0))
    return -(-cap // bucket) * bucket


def capacity_ladder(max_total: int, minimum: int = MIN_CAPACITY,
                    growth: int = 4) -> Tuple[int, ...]:
    """Fixed geometric ladder of packed capacities covering ``max_total``:
    ``minimum``, ``minimum * growth``, ... below ``max_total``, then
    ``max_total`` itself. The serving engine captures one CUDA graph per
    rung at load (``serving/graphs.py``), so packing always lands on a
    warm capacity. Every rung is exact under ``pack_ragged(...,
    capacity_minimum=rung)`` for totals <= rung (``bucketed_capacity``
    returns its minimum unchanged)."""
    if max_total < 1:
        raise ValueError('max_total must be >= 1, got %d' % max_total)
    if growth < 2:
        raise ValueError('growth must be >= 2, got %d' % growth)
    rungs = []
    cap = minimum
    while cap < max_total:
        rungs.append(cap)
        cap *= growth
    rungs.append(max(max_total, minimum))
    return tuple(rungs)


def shard_totals(count: np.ndarray, data_shards: int) -> np.ndarray:
    """(data_shards,) int64 retained-context totals per shard."""
    n = count.shape[0]
    if n % data_shards:
        raise ValueError('batch size %d not divisible by data_shards %d'
                         % (n, data_shards))
    return count.reshape(data_shards, n // data_shards).sum(
        axis=1, dtype=np.int64)


def effective_lengths(mask: np.ndarray) -> np.ndarray:
    """(B,) int32: index of the last mask-valid slot + 1, or 0."""
    valid = mask > 0
    any_valid = valid.any(axis=1)
    last = mask.shape[1] - np.argmax(valid[:, ::-1], axis=1)
    return np.where(any_valid, last, 0).astype(np.int32)


def ragged_gather_indices(lengths: np.ndarray, stride: int) -> np.ndarray:
    """Flat indices selecting slots [0, lengths[r]) of each row r of a
    row-major (B, stride) array."""
    total = int(lengths.sum())
    starts = np.cumsum(lengths) - lengths
    intra = np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)
    return np.repeat(np.arange(lengths.shape[0], dtype=np.int64) * stride,
                     lengths) + intra


def pack_ragged(ctx_rows: np.ndarray, count: np.ndarray, token_pad: int,
                path_pad: int, data_shards: int = 1,
                capacity_minimum: int = MIN_CAPACITY) -> np.ndarray:
    """(total, 3) ragged triple stream + per-example counts -> the
    rectangular (data_shards, capacity, 3) wire array."""
    totals = shard_totals(count, data_shards)
    cap = bucketed_capacity(int(totals.max(initial=0)), capacity_minimum)
    ctx = np.empty((data_shards, cap, 3), np.int32)
    ctx[..., 0] = token_pad
    ctx[..., 1] = path_pad
    ctx[..., 2] = token_pad
    bounds = np.concatenate([[0], np.cumsum(totals)])
    for d in range(data_shards):
        ctx[d, :totals[d]] = ctx_rows[bounds[d]:bounds[d + 1]]
    return ctx


def ragged_from_planes(source: np.ndarray, path: np.ndarray,
                       target: np.ndarray, mask: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Plane arrays -> ((total, 3) int32 triple stream, (B,) lengths)."""
    lengths = effective_lengths(mask)
    flat = ragged_gather_indices(lengths, source.shape[1])
    return np.stack([source.ravel()[flat], path.ravel()[flat],
                     target.ravel()[flat]],
                    axis=1).astype(np.int32, copy=False), lengths


def pack_batch(batch, token_pad: int, path_pad: int, data_shards: int = 1,
               capacity_minimum: int = MIN_CAPACITY) -> PackedBatch:
    """reader.Batch (plane format) -> PackedBatch."""
    ctx_rows, lengths = ragged_from_planes(batch.source, batch.path,
                                           batch.target, batch.mask)
    ctx = pack_ragged(ctx_rows, lengths, token_pad, path_pad, data_shards,
                      capacity_minimum)
    return PackedBatch(ctx=ctx, count=lengths,
                       label=np.ascontiguousarray(batch.label),
                       weight=np.ascontiguousarray(batch.weight),
                       label_strings=batch.label_strings,
                       source_strings=batch.source_strings,
                       path_strings=batch.path_strings,
                       target_strings=batch.target_strings)


class StickyPacker:
    """Packs a stream of batches under a capacity that only grows: totals
    that straddle a bucket boundary reuse the larger capacity instead of
    ping-ponging between two. One instance per data source, living across
    epochs (the reference's ``StickyPacker``).

    With telemetry on it records the pack time (``step/pack_ms``, from
    whichever reader or prefetch thread packs) and the packed fill rate
    (retained slots / wire capacity); off, one bool read a batch."""

    def __init__(self, token_pad: int, path_pad: int,
                 minimum: int = MIN_CAPACITY):
        self.token_pad = token_pad
        self.path_pad = path_pad
        self.capacity = minimum

    @staticmethod
    def _record(seconds: float, ctx: np.ndarray, retained: int) -> None:
        reg = tele_core.registry()
        reg.timer('step/pack_ms').record(seconds)
        slots = int(ctx.shape[0]) * int(ctx.shape[1])
        reg.gauge('input/packed_fill_rate').set(retained / max(slots, 1))

    def pack_batch(self, batch) -> PackedBatch:
        """One shard (the port trains on one device)."""
        t0 = time.perf_counter() if tele_core.enabled() else 0.0
        packed = pack_batch(batch, self.token_pad, self.path_pad,
                            capacity_minimum=self.capacity)
        self.capacity = max(self.capacity, packed.ctx.shape[1])
        if tele_core.enabled():
            self._record(time.perf_counter() - t0, packed.ctx,
                         int(packed.count.sum()))
        return packed

    def pack_ragged(self, ctx_rows: np.ndarray,
                    count: np.ndarray) -> np.ndarray:
        """A ragged triple stream (the token cache's rows) onto the wire,
        one shard."""
        t0 = time.perf_counter() if tele_core.enabled() else 0.0
        ctx = pack_ragged(ctx_rows, count, self.token_pad, self.path_pad,
                          capacity_minimum=self.capacity)
        self.capacity = max(self.capacity, ctx.shape[1])
        if tele_core.enabled():
            self._record(time.perf_counter() - t0, ctx, int(count.sum()))
        return ctx


def unpack_ragged_np(ctx_rows: np.ndarray, count: np.ndarray,
                     max_contexts: int, token_pad: int, path_pad: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(total, 3) triple stream + counts -> PAD-filled (B, C) planes."""
    n = count.shape[0]
    flat = ragged_gather_indices(count.astype(np.int64), max_contexts)
    planes = []
    for column, fill in ((0, token_pad), (1, path_pad), (2, token_pad)):
        plane = np.full((n * max_contexts,), fill, np.int32)
        plane[flat] = ctx_rows[:, column]
        planes.append(plane.reshape(n, max_contexts))
    return planes[0], planes[1], planes[2]


def segment_starts(count2: torch.Tensor) -> torch.Tensor:
    """(D, Bs) offset of each example's first slot within its shard —
    the CSR row pointer of the packed stream."""
    return torch.cumsum(count2, dim=1) - count2


def segment_structure(count2: torch.Tensor, cap: int):
    """Segment structure of the packed stream, per shard: ``(seg, pos,
    in_range)``, each ``(D, cap)``, equal to the reference's
    (``code2vec_tpu/data/packed.py::segment_structure``).

    - ``seg``: the example a slot belongs to. Segments are contiguous and
      nondecreasing, so it is the number of examples after the first
      whose start is <= the slot: zero-length examples share a start and
      the slot goes to the last of them, a start >= cap never matches,
      and slots past the shard total all map to the last example.
    - ``pos``: the slot's position within its example.
    - ``in_range``: slot < the shard's retained total.
    """
    shards, _ = count2.shape
    starts = segment_starts(count2)
    slots = torch.arange(cap, dtype=count2.dtype, device=count2.device)
    seg = torch.searchsorted(starts[:, 1:].contiguous(),
                             slots.expand(shards, cap).contiguous(),
                             right=True)
    pos = slots[None, :] - torch.gather(starts, 1, seg)
    in_range = slots[None, :] < count2.sum(dim=1, keepdim=True)
    return seg, pos, in_range     # seg int64: torch's index type


def unpack_device(ctx: torch.Tensor, count: torch.Tensor, max_contexts: int,
                  token_pad: int, path_pad: int):
    """The inverse of ``pack_batch`` on the device: scatter the packed
    triples back to the ``(B, C)`` int32 index planes and the float32
    mask, bit for bit (the reference's ``unpack_device``).

    A slot lands at (its example, its position); capacity padding holds
    the PAD triple and lands either past the last example's count on a
    slot whose fill is PAD already, or past ``max_contexts``, where it is
    dropped (into a spare element cut off at the end)."""
    shards, cap, _ = ctx.shape
    batch = count.shape[0]
    per_shard = batch // shards
    seg, pos, _in_range = segment_structure(
        count.reshape(shards, per_shard), cap)
    shard_base = torch.arange(shards, device=ctx.device)[:, None] * per_shard
    flat = (shard_base + seg) * max_contexts + pos
    size = batch * max_contexts
    flat = torch.where(pos < max_contexts, flat, size).reshape(-1)

    def scatter(values: torch.Tensor, fill: int) -> torch.Tensor:
        out = torch.full((size + 1,), fill, dtype=torch.int32,
                         device=ctx.device)
        out[flat] = values.reshape(-1).to(torch.int32)
        return out[:size].reshape(batch, max_contexts)

    source = scatter(ctx[..., 0], token_pad)
    path = scatter(ctx[..., 1], path_pad)
    target = scatter(ctx[..., 2], token_pad)
    mask = ((source != token_pad) | (target != token_pad)
            | (path != path_pad)).float()
    return source, path, target, mask
