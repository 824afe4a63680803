"""Top-k over the target logits, in ``jax.lax.top_k``'s order.

``lax.top_k`` was never a Pallas kernel in the reference, so the port
computes it in plain PyTorch. Its order is the reference's: values
descending in IEEE total order (+0.0 above -0.0), and among equal values
the lower index first. ``torch.topk`` promises no order among ties, and
logits rounded to bf16 tie often (two of the top ten of 261K targets
share a value in most rows), so ``top_k`` settles them itself:

1. ``torch.topk`` gives the k-th largest value t of each row. Every
   value above t is in the top k, whichever ties it broke.
2. The rest of the k are the lowest-index entries equal to t (+0.0
   before -0.0 when t is zero): one more ``torch.topk``, over an int32
   key that is the reversed index where the row equals t and -1
   elsewhere.
3. The at most 2k candidates are sorted on an int64 key (the value's
   total-order bits, then the reversed index).

The logits must be free of NaN (the model's are). The reference's
``grouped_top_k`` stays unported: on a TPU it lost to the monolithic
top-k by 4.8x and nothing routed to it (code2vec_tpu/ops/topk.py).

``sharded_top_k`` is the reference's over a (data, model) mesh of ranks
(``parallel/mesh.py``): each rank holds V/M columns of the logits, takes
its local ``top_k`` and offsets the indices to global ones; the k
candidates of every rank of its data row are gathered (a broadcast from
each, so every bit arrives as it left) in shard order and merged by
``top_k`` again, whose position order is then (value descending, global
index ascending): ``lax.top_k``'s order over the whole row. The index's
sharded route over the data axis (the reference's ``index/exact.py``)
is still to come (ROADMAP A9b).

The embedding index (``index/``) takes per-block candidates with
``padded_local_topk`` (sentinel-padded when a block holds fewer than k
columns) and merges them exactly: on the card with ``merge_topk``, or on
the host with ``merge_topk_host``; both break ties by the lowest index,
as ``lax.top_k`` over the whole row does.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_LOW32 = (1 << 32) - 1

#: index of a sentinel slot (its value is -inf)
PAD_INDEX = -1


def _total_order(values: torch.Tensor) -> torch.Tensor:
    """int64 keys of fp32 ``values`` that order as IEEE total order:
    the bits as a signed int, the magnitude bits flipped when negative."""
    bits = values.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest logits along the last axis,
    in ``lax.top_k``'s order (module docstring); ``k`` is capped at the
    vocab width. Indices are int64."""
    width = logits.shape[-1]
    k = min(k, width)
    logits = logits.float()
    values, indices = torch.topk(logits, k, dim=-1, sorted=True)
    kth = values[..., -1:]
    # the ties at the k-th value: the reversed index as the key, raised by
    # `width` where the sign bit is clear, so +0.0 ranks above -0.0
    rev = torch.arange(width - 1, -1, -1, dtype=torch.int32,
                       device=logits.device)
    tie_key = torch.where(logits == kth,
                          torch.where(torch.signbit(logits), rev,
                                      rev + width), -1)
    tie_top = torch.topk(tie_key, k, dim=-1, sorted=True).values
    tie_idx = (width - 1) - tie_top % width
    need = k - (values > kth).sum(dim=-1, keepdim=True)
    slot = torch.arange(k, device=logits.device)
    cand_idx = torch.cat([indices, tie_idx.long()], dim=-1)
    cand_ok = torch.cat([values > kth, slot < need], dim=-1)
    cand_val = torch.gather(logits, -1, cand_idx)
    key = (_total_order(cand_val) << 32) | (_LOW32 - cand_idx)
    key = torch.where(cand_ok, key, torch.iinfo(torch.int64).min)
    top = torch.topk(key, k, dim=-1, sorted=True).values
    out_idx = _LOW32 - (top & _LOW32)
    return torch.gather(logits, -1, out_idx), out_idx


def sharded_top_k(logits: torch.Tensor, k: int, mesh
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis of ``logits``, this rank's V/M columns of
    a row split over the mesh's model axis (the reference's
    ``sharded_top_k``, code2vec_tpu/ops/topk.py:90-134): (values,
    global indices), equal on every rank of the data row. ``k`` may
    exceed V/M (as long as k <= V): each rank then offers all of its
    columns. Plain ``top_k`` when the model axis is 1 (or no mesh)."""
    from code2vec_tpu_torch.parallel.mesh import MODEL_AXIS
    shards = 1 if mesh is None else mesh.model
    width = logits.shape[-1]
    k = min(k, width * shards)
    if shards == 1:
        return top_k(logits, k)
    local_k = min(k, width)
    values, indices = top_k(logits, local_k)
    indices = indices + mesh.model_index * width
    # (M, B, local_k) in shard order -> (B, M * local_k)
    all_values = mesh.gather_rows(values[None], MODEL_AXIS)
    all_indices = mesh.gather_rows(indices[None], MODEL_AXIS)
    batch = logits.shape[0]
    all_values = all_values.permute(1, 0, 2).reshape(batch, -1)
    all_indices = all_indices.permute(1, 0, 2).reshape(batch, -1)
    merged, positions = top_k(all_values, k)
    return merged, torch.gather(all_indices, -1, positions)


def padded_local_topk(x: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``top_k`` over the last axis where ``k`` may exceed its length: the
    result is padded to exactly ``k`` slots with ``-inf`` values and
    ``PAD_INDEX`` indices (code2vec_tpu/ops/topk.py:140)."""
    local_k = min(k, x.shape[-1])
    values, indices = top_k(x, local_k)
    if local_k < k:
        pad = x.shape[:-1] + (k - local_k,)
        values = torch.cat([values, values.new_full(pad, float('-inf'))],
                           dim=-1)
        indices = torch.cat([indices, indices.new_full(pad, PAD_INDEX)],
                            dim=-1)
    return values, indices


def merge_topk(values: torch.Tensor, indices: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact merge of per-block candidates on the tensors' device.

    ``values``/``indices`` concatenate each block's ``padded_local_topk``
    output, blocks in ascending order of their global indices. Among
    equal values a lower candidate position then means a lower global
    index, so ``top_k``'s position order is ``lax.top_k``'s order over
    the whole row; sentinels sort last unless real values are -inf."""
    values, positions = top_k(values, k)
    return values, torch.gather(indices, -1, positions)


def merge_topk_host(values: np.ndarray, indices: np.ndarray, k: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Host merge of per-shard candidates (``values``/``indices`` are
    ``(..., m)`` with global indices; sentinels ``-inf``/``PAD_INDEX``):
    value descending, then lowest index (code2vec_tpu/ops/topk.py:158)."""
    values = np.asarray(values)
    indices = np.asarray(indices)
    if values.shape != indices.shape:
        raise ValueError('values %r and indices %r must agree in shape'
                         % (values.shape, indices.shape))
    k = min(k, values.shape[-1])
    # lexsort's last key is primary; -(-inf) = +inf sorts sentinels last
    order = np.lexsort((indices, -values), axis=-1)[..., :k]
    return (np.take_along_axis(values, order, axis=-1),
            np.take_along_axis(indices, order, axis=-1))
