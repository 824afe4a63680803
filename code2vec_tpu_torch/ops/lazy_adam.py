"""Lazy (sparse-row) Adam for the token and path tables — the counterpart
of ``code2vec_tpu/ops/lazy_adam.py`` (``Config.LAZY_EMBEDDING_ADAM``).

``tf.contrib.opt.LazyAdamOptimizer``'s semantics: the moments decay and
the rows move only where the batch touches them, with bias correction
from the GLOBAL step t:

    lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
    m    = b1 * m + (1 - b1) * g          (touched rows only)
    v    = b2 * v + (1 - b2) * g^2        (touched rows only)
    p    = p - lr_t * m / (sqrt(v) + eps)

(the reference's own expression, not optax's). The dense parameters
(target table, transform, attention) take the ordinary Adam update with
fp32 moments, as the reference's ``optax.adam`` does, through the fused
kernel (``training/adam_dtypes.py``). The moments of the tables are fp32;
ADAM_MU_DTYPE / ADAM_NU_DTYPE do not apply here (the trainer warns).

``sparse_row_adam`` updates in place. On the card the touched-row list is
sorted (``torch.sort``, a fixed size, no host sync) and the row kernel
(``ops/adam.py::adam_rows``) updates each row once from its old values:
the reference's functional update reads every duplicate from the old row
too. On the CPU the plain version gathers every listed row, computes the
update and writes it back: duplicates write the same values. Rows not in
the list stay bit-identical in the table and both moments.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from code2vec_tpu_torch.ops import adam as adam_ops
from code2vec_tpu_torch.training import adam_dtypes


def lazy_rate(learning_rate: float, step: int, b1: float = 0.9,
              b2: float = 0.999) -> float:
    """``lr_t`` of the 1-based global ``step``, in float32 as the
    reference computes it."""
    one = np.float32(1.0)
    t = np.float32(step)
    lr_t = (np.float32(learning_rate)
            * np.sqrt(one - np.float32(b2) ** t)
            / (one - np.float32(b1) ** t))
    return float(np.float32(lr_t))


@torch.no_grad()
def sparse_row_adam_plain(table: torch.Tensor, mu: torch.Tensor,
                          nu: torch.Tensor, dense_grad: torch.Tensor,
                          rows: torch.Tensor, lr_t: float, b1: float = 0.9,
                          b2: float = 0.999, eps: float = 1e-8) -> None:
    """The row update in plain torch, one op per rounding, in place."""
    rows = rows.reshape(-1).long()
    g = dense_grad[rows]
    m = torch.add(torch.mul(mu[rows], adam_ops.f32(b1)),
                  torch.mul(g, adam_ops.f32(1.0 - b1)))
    v = torch.add(torch.mul(nu[rows], adam_ops.f32(b2)),
                  torch.mul(torch.mul(g, g), adam_ops.f32(1.0 - b2)))
    step = torch.div(torch.mul(m, adam_ops.f32(lr_t)),
                     torch.add(torch.sqrt(v), adam_ops.f32(eps)))
    table[rows] = torch.sub(table[rows], step)
    mu[rows] = m
    nu[rows] = v


@torch.no_grad()
def sparse_row_adam(table: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                    dense_grad: torch.Tensor, rows: torch.Tensor, *,
                    learning_rate: float, step: int, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One lazy-Adam update of ``table`` at ``rows`` (may repeat), in
    place. ``step`` is the 1-based global step; ``dense_grad`` is the
    full-shape gradient (only its touched rows are read). Returns
    ``(table, mu, nu)``; untouched rows of all three are unchanged."""
    lr_t = lazy_rate(learning_rate, step, b1, b2)
    if table.device.type == 'cpu':
        sparse_row_adam_plain(table, mu, nu, dense_grad, rows, lr_t, b1, b2,
                              eps)
    else:
        sorted_rows = torch.sort(rows.reshape(-1).long()).values
        adam_ops.adam_rows(table, mu, nu, dense_grad, sorted_rows, lr_t, b1,
                           b2, eps)
    return table, mu, nu


class LazyAdamState(NamedTuple):
    """The reference's field names: ``dense`` is the Adam state of the
    dense keys (fp32 moments); ``mu`` / ``nu`` are keyed by the tables'
    canonical names."""
    dense: adam_dtypes.AdamState
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class LazyEmbeddingAdam:
    """Sparse-row Adam for the token and path tables, fused dense Adam
    for the rest (module docstring). Parameters and gradients come as the
    five tensors in ``Code2VecParams`` order."""

    FIELDS = ('token_embedding', 'path_embedding', 'target_embedding',
              'transform', 'attention')
    DENSE_KEYS = ('target_embedding', 'transform', 'attention')
    SPARSE_KEYS = ('token_embedding', 'path_embedding')

    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps

    def _named(self, tensors: Sequence[torch.Tensor]) -> dict:
        return dict(zip(self.FIELDS, tensors))

    def init(self, params: Sequence[torch.Tensor]) -> LazyAdamState:
        named = self._named(params)
        dense = adam_dtypes.init([named[k] for k in self.DENSE_KEYS])
        return LazyAdamState(
            dense=dense,
            mu={k: torch.zeros_like(named[k], dtype=torch.float32)
                for k in self.SPARSE_KEYS},
            nu={k: torch.zeros_like(named[k], dtype=torch.float32)
                for k in self.SPARSE_KEYS})

    @torch.no_grad()
    def update_(self, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], state: LazyAdamState,
                step: int, source: torch.Tensor, path: torch.Tensor,
                target: torch.Tensor) -> LazyAdamState:
        """One optimizer step in place. ``step`` is the completed-steps
        counter (0-based; bias correction uses step + 1);
        ``source``/``path``/``target`` are the index streams that define
        the touched rows (``trainer.packed_rows``)."""
        named_p = self._named(params)
        named_g = self._named(grads)
        dense = adam_dtypes.update_(
            [named_p[k] for k in self.DENSE_KEYS],
            [named_g[k] for k in self.DENSE_KEYS], state.dense,
            self.learning_rate, self.b1, self.b2, self.eps)
        token_rows = torch.cat([source.reshape(-1), target.reshape(-1)])
        for key, rows in (('token_embedding', token_rows),
                          ('path_embedding', path.reshape(-1))):
            sparse_row_adam(named_p[key], state.mu[key], state.nu[key],
                            named_g[key], rows,
                            learning_rate=self.learning_rate, step=step + 1,
                            b1=self.b1, b2=self.b2, eps=self.eps)
        return LazyAdamState(dense, state.mu, state.nu)


def named_state(opt_state) -> dict:
    """An optimizer state under the reference's field names, as the
    checkpoints store it: ``{'count', 'mu': {name}, 'nu': {name}}`` for
    Adam (``adam_dtypes.AdamState`` over the five parameters), ``{'dense':
    that over DENSE_KEYS, 'mu': {table}, 'nu': {table}}`` for lazy Adam."""
    def adam(state, names):
        return {'count': state.count, 'mu': dict(zip(names, state.mu)),
                'nu': dict(zip(names, state.nu))}
    if isinstance(opt_state, LazyAdamState):
        return {'dense': adam(opt_state.dense, LazyEmbeddingAdam.DENSE_KEYS),
                'mu': dict(opt_state.mu), 'nu': dict(opt_state.nu)}
    return adam(opt_state, LazyEmbeddingAdam.FIELDS)
