"""Top-k over the target logits.

``lax.top_k`` was never a Pallas kernel in the reference, so the port
uses ``torch.topk``. The reference's ``grouped_top_k`` stays unported: on
a TPU it lost to the monolithic top-k by 4.8x and nothing routed to it
(code2vec_tpu/ops/topk.py).
"""
from __future__ import annotations

from typing import Tuple

import torch


def top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest logits along the last axis,
    in descending order; ``k`` is capped at the vocab width."""
    return torch.topk(logits, min(k, logits.shape[-1]), dim=-1,
                      sorted=True)
