"""The train step's cost, the MFU's numerator: logical FLOPs and the bytes
one step must move, counted from the shapes it was dispatched at.

The JAX package asks XLA (``Lowered.cost_analysis()`` of the train-step
program, ``code2vec_tpu/training/trainer.py::Trainer._program_cost``).
The port has no compiler to ask, so it counts as XLA's cost analysis
does: a matrix product is 2·M·N·K, a non-transcendental elementwise op or
a reduction one FLOP per element, a transcendental (tanh, exp, log) none.
``tests/test_torch_goodput.py`` holds the count against the JAX
program's on the plane wire.

Counted per step, with S the slots the encode runs over (B·C on the
planes and on the packed wire unpacked on the card; the packed capacity
on the ragged route), D0 = 2·token_dim + path_dim, D the code dim, V the
CE's vocabulary rows (the valid rows under the streamed CE kernels,
which skip the padding; every row of the table with materialized
logits) and P the parameters Adam updates:

- the encode: the context transform forward and its two backward
  products (3 · 2·S·D0·D), the attention scores and the weighted sum
  with their backward (8·S·D), elementwise passes (2·S·D0 + 3·S·D + 9·S);
- the CE tail: logits forward and the two backward products
  (3 · 2·B·D·V), softmax and CE elementwise (6·B·V);
- Adam: 14 FLOPs a parameter.

The recompute the ragged and CE backward kernels do (the forward's
products again) is not counted: MFU does not reward it.

On a (data, model) mesh of ranks the count is the rank's shard of the
step (``training/trainer.py::Trainer.step_cost``): its data shard's B
and S (S / M under SHARD_CONTEXTS on the dense encode), its V / M target
rows (the valid ones among them under the streamed CE) and the
parameters whose moments it holds (a table's 1 / D of them under
ZeRO). ``train/mfu`` is that count over the rank's window seconds and
one card's peak, the rank's own MFU.

Bytes, the port's own estimate (XLA's figure for an unoptimized module
counts every op's operands and is not comparable): Adam's pass (the
parameters read and written in fp32, the moments in their storage
dtypes, the gradients written and read), the gathered context rows in
the forward and the backward, the target table read by the forward and
the backward, and the logits, written and read twice, when they are
materialized.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

ADAM_FLOPS_PER_PARAM = 14


class StepShape(NamedTuple):
    batch: int          # B
    slots: int          # S
    token_dim: int
    path_dim: int
    code_dim: int       # D
    vocab_rows: int     # V
    params: int         # P
    materialized_logits: bool


def step_shape(config, sizes: dict, num_valid_targets: int,
               arrays: Sequence, params: int) -> StepShape:
    """The shape a train step runs at, from its dispatched arrays (4
    packed or 6 plane arrays), the backend's table ``sizes``
    (``models/backends.py::table_sizes``) and the count of parameters
    Adam updates."""
    if len(arrays) == 4:
        ctx, count = arrays[0], arrays[1]
        batch = int(count.shape[0])
        if config.USE_PALLAS_RAGGED_FUSION:
            slots = int(ctx.shape[0]) * int(ctx.shape[1])
        else:   # unpacked on the card to (B, C) planes
            slots = batch * config.MAX_CONTEXTS
    else:
        batch, contexts = (int(d) for d in arrays[0].shape)
        slots = batch * contexts
    fused = config.USE_PALLAS_FUSED_CE
    return StepShape(
        batch=batch, slots=slots, token_dim=sizes['token_dim'],
        path_dim=sizes['path_dim'], code_dim=sizes['code_dim'],
        vocab_rows=(num_valid_targets if fused
                    else sizes['target_vocab_size']),
        params=int(params), materialized_logits=not fused)


def train_step_flops(shape: StepShape) -> float:
    s, b, d, v = shape.slots, shape.batch, shape.code_dim, shape.vocab_rows
    d0 = 2 * shape.token_dim + shape.path_dim
    encode = 3 * 2 * s * d0 * d + 8 * s * d + 2 * s * d0 + 3 * s * d + 9 * s
    ce = 3 * 2 * b * d * v + 6 * b * v
    return float(encode + ce + ADAM_FLOPS_PER_PARAM * shape.params)


def train_step_bytes(shape: StepShape, compute_bytes: int,
                     moment_bytes: int, grad_bytes: int) -> float:
    """``moment_bytes``: the two moments' storage bytes a parameter
    (8 for fp32 moments, 4 for bf16)."""
    s, b, d, v = shape.slots, shape.batch, shape.code_dim, shape.vocab_rows
    d0 = 2 * shape.token_dim + shape.path_dim
    adam = shape.params * (2 * 4 + 2 * moment_bytes + 2 * grad_bytes)
    contexts = 2 * s * (d0 * compute_bytes + 3 * 4)
    table = 2 * v * d * compute_bytes
    logits = 3 * b * v * 4 if shape.materialized_logits else 0
    return float(adam + contexts + table + logits)


def train_step_cost(shape: StepShape, compute_bytes: int, moment_bytes: int,
                    grad_bytes: int) -> Tuple[float, float]:
    """``(flops, bytes)`` of one train step at ``shape``."""
    return (train_step_flops(shape),
            train_step_bytes(shape, compute_bytes, moment_bytes,
                             grad_bytes))
