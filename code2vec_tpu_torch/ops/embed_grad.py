"""Embedding-table gradient strategies for the token and path tables — the
counterpart of ``code2vec_tpu/ops/embed_grad.py``'s ``table_grad``, which
the ragged backward (``ops/ragged.py``) calls for both tables, as the
reference's ``pallas_ragged.py`` does (``Config.EMBED_GRAD_IMPL``):

- ``'dense'``  — ``index_add_`` of the cotangent rows into a zero table
  (the default);
- ``'sorted'`` — a stable argsort of the indices first, then ``index_add_``
  of the permuted rows: duplicate hits on a row are adjacent;
- ``'dedup'``  — as ``'sorted'``, then each run of equal indices summed
  before the scatter, so each table row is written by one update. A run's
  sum is the difference of a column's fp64 prefix sums at the run's end
  and before its start, rounded once to the table's dtype; every
  non-final row of a run is sent to a row of its own past the table (a
  scratch block of one row per cotangent row, sliced off), so the scatter
  has no duplicate index at all. Nothing waits for the device (no
  ``torch.unique``, whose output size needs a host sync). The prefix sums
  run along the innermost dimension in two levels (``_column_prefix``):
  torch's scan along a leading dimension gives each column one thread.

All three agree up to the summation order (``'dedup'`` sums a run in
fp64, the reference in the table's dtype). The cotangent is cast to the
table's dtype before the scatter, as the reference casts it, so under
GRADS_DTYPE='bfloat16' the table gradient is bf16 throughout.
"""
from __future__ import annotations

import torch

IMPLS = ('dense', 'sorted', 'dedup')
_SCAN_CHUNK = 256


def _column_prefix(values: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums down each column of ``values`` (n, d), as a
    (d, n) tensor: each column cut into chunks of _SCAN_CHUNK rows scanned
    along the innermost dimension, then the chunks' totals scanned and
    added back."""
    n, d = values.shape
    chunks = -(-n // _SCAN_CHUNK)
    padded = torch.nn.functional.pad(values.T, (0, chunks * _SCAN_CHUNK - n))
    part = padded.reshape(d, chunks, _SCAN_CHUNK).cumsum(2)
    totals = part[:, :, -1]
    offsets = totals.cumsum(1) - totals
    return (part + offsets[:, :, None]).reshape(d, -1)[:, :n]


def table_grad(g: torch.Tensor, idx: torch.Tensor, num_rows: int,
               dtype: torch.dtype, impl: str = 'dense') -> torch.Tensor:
    """Accumulate cotangent rows ``g`` (..., d) at ``idx`` (...) into a
    dense (num_rows, d) table gradient of ``dtype`` by the chosen
    strategy."""
    if impl not in IMPLS:
        raise ValueError('embed grad impl must be one of %s, got %r'
                         % (IMPLS, impl))
    d = g.shape[-1]
    flat_g = g.reshape(-1, d).to(dtype)
    flat_idx = idx.reshape(-1).long()
    if impl == 'dense':
        out = torch.zeros((num_rows, d), dtype=dtype, device=g.device)
        return out.index_add_(0, flat_idx, flat_g)
    order = torch.argsort(flat_idx, stable=True)
    sorted_idx = flat_idx[order]
    sorted_g = flat_g[order]
    if impl == 'sorted':
        out = torch.zeros((num_rows, d), dtype=dtype, device=g.device)
        return out.index_add_(0, sorted_idx, sorted_g)
    n = sorted_idx.shape[0]
    if n == 0:
        return torch.zeros((num_rows, d), dtype=dtype, device=g.device)
    position = torch.arange(n, device=g.device)
    ends = torch.ones(n, dtype=torch.bool, device=g.device)
    ends[:-1] = sorted_idx[1:] != sorted_idx[:-1]
    # each position's run start (the first position of its index), then
    # the run's sum at its last position
    run_start = torch.searchsorted(sorted_idx, sorted_idx)
    total = _column_prefix(sorted_g.double())                     # (d, n)
    before = torch.where(run_start > 0,
                         total[:, (run_start - 1).clamp(min=0)], 0.0)
    summed = (total - before).T.to(dtype)
    scatter_idx = torch.where(ends, sorted_idx, num_rows + position)
    out = torch.zeros((num_rows + n, d), dtype=dtype, device=g.device)
    out.index_add_(0, scatter_idx, summed)
    return out[:num_rows]
