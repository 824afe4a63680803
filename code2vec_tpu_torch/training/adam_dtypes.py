"""Adam with reduced-precision moment STORAGE — the counterpart of
``code2vec_tpu/training/adam_dtypes.py``.

The moments are stored in ``mu_dtype`` / ``nu_dtype`` (bf16 by default,
``Config.ADAM_MU_DTYPE`` / ``ADAM_NU_DTYPE``) and every step upcasts them
to fp32 before any arithmetic, so the EMA never accumulates in bf16. The
update is optax's:

    mu = b1 mu + (1 - b1) g,   nu = b2 nu + (1 - b2) g^2
    p -= lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

``torch.optim.Adam`` cannot store bf16 moments under fp32 parameters,
hence this module. The update is in place: parameters and stored moments
are overwritten (the reference returns new arrays and donates the old).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState`` fields: the step count and one stored
    moment per parameter, in parameter order."""
    count: int
    mu: Tuple[torch.Tensor, ...]
    nu: Tuple[torch.Tensor, ...]


def init(params: Sequence[torch.Tensor],
         mu_dtype: Optional[torch.dtype] = None,
         nu_dtype: Optional[torch.dtype] = None) -> AdamState:
    """Zero moments; a dtype of None keeps the parameter's."""
    return AdamState(
        count=0,
        mu=tuple(torch.zeros_like(p, dtype=mu_dtype or p.dtype,
                                  memory_format=torch.contiguous_format)
                 for p in params),
        nu=tuple(torch.zeros_like(p, dtype=nu_dtype or p.dtype,
                                  memory_format=torch.contiguous_format)
                 for p in params))


def _bias_correction(beta: float, count: int) -> float:
    """1 - beta^count in fp32, as the reference computes it."""
    one = np.float32(1.0)
    return float(one - np.float32(beta) ** np.float32(count))


@torch.no_grad()
def update_(params: Sequence[torch.Tensor],
            grads: Sequence[torch.Tensor], state: AdamState,
            learning_rate: float, b1: float = 0.9, b2: float = 0.999,
            eps: float = 1e-8) -> AdamState:
    """One Adam step in place on ``params`` and the stored moments;
    returns the state with the count advanced."""
    count = state.count + 1
    b1c = _bias_correction(b1, count)
    b2c = _bias_correction(b2, count)
    for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
        g = g.float()
        # fp32 moments (the stored tensors themselves when fp32-stored)
        m = mu.float().mul_(b1).add_(g, alpha=1.0 - b1)
        v = nu.float().mul_(b2).addcmul_(g, g, value=1.0 - b2)
        mu.copy_(m)
        nu.copy_(v)
        denom = (v / b2c).sqrt_().add_(eps)
        p.add_((m / b1c).div_(denom), alpha=-learning_rate)
    return AdamState(count, state.mu, state.nu)
