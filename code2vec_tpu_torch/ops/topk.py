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
"""
from __future__ import annotations

from typing import Tuple

import torch

_LOW32 = (1 << 32) - 1


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
