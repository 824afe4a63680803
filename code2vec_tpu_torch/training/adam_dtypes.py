"""Adam with reduced-precision moment STORAGE — the counterpart of
``code2vec_tpu/training/adam_dtypes.py``.

The moments are stored in ``mu_dtype`` / ``nu_dtype`` (bf16 by default,
``Config.ADAM_MU_DTYPE`` / ``ADAM_NU_DTYPE``) and every step upcasts them
to fp32 before any arithmetic, so the EMA never accumulates in bf16. The
update is optax's, in the order of the reference's expression:

    mu = b1 mu + (1 - b1) g,   nu = b2 nu + (1 - b2) g^2
    p += -lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

Gradients may be fp32 or bf16 (GRADS_DTYPE) and are upcast first. Each
parameter is one call of ``ops/adam.py::adam_update``: one launch of the
fused kernel on the card, the plain version (one rounding per operation)
on the CPU. ``torch.optim.Adam`` cannot store bf16 moments under fp32
parameters, hence this module. The update is in place: parameters and
stored moments are overwritten (the reference returns new arrays and
donates the old).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from code2vec_tpu_torch.ops import adam as adam_ops


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


def adam_scalars(count: int, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8
                 ) -> adam_ops.AdamScalars:
    """The float32 scalars of step ``count`` (1-based)."""
    return adam_ops.AdamScalars.make(
        learning_rate, b1, b2, eps, _bias_correction(b1, count),
        _bias_correction(b2, count))


@torch.no_grad()
def update_(params: Sequence[torch.Tensor],
            grads: Sequence[torch.Tensor], state: AdamState,
            learning_rate: float, b1: float = 0.9, b2: float = 0.999,
            eps: float = 1e-8,
            row_ranges: Optional[Sequence[Optional[Tuple[int, int]]]] = None
            ) -> AdamState:
    """One Adam step in place on ``params`` and the stored moments, one
    ``adam_update`` per parameter; returns the state with the count
    advanced. ``row_ranges`` (ZeRO, ``training/trainer.py``): per
    parameter None, or the rows [lo, hi) its moments hold, the only rows
    of the parameter (and its gradient) that step updates."""
    count = state.count + 1
    scalars = adam_scalars(count, learning_rate, b1, b2, eps)
    if row_ranges is None:
        row_ranges = [None] * len(state.mu)
    for p, g, mu, nu, rows in zip(params, grads, state.mu, state.nu,
                                  row_ranges):
        if rows is not None:
            p, g = p.detach()[rows[0]:rows[1]], g[rows[0]:rows[1]]
        adam_ops.adam_update(p, g, mu, nu, scalars)
    return AdamState(count, state.mu, state.nu)
