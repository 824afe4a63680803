"""The (data, model) mesh of ranks — the counterpart of
``code2vec_tpu/parallel/mesh.py``.

The JAX package lays its devices out as ``np.asarray(devices).reshape(
data, model)`` and places arrays with ``NamedSharding``s; XLA inserts
the collectives. Here every device is a process (``parallel/
distributed.py``), so rank r = d * model + m holds what device (d, m)
holds there, and the collectives are written out:

- ``model`` — the three embedding tables are row-sharded: rank (d, m)
  holds rows [m V / M, (m + 1) V / M) of each (``row_range``), the
  place of ``param_specs``; ``transform`` and ``attention`` are
  replicated. Ranks of one data row (``model_group``) merge what their
  rows contribute: the gathered context rows, the softmax statistics,
  the top-k candidates.
- ``data`` — the batch is split: ranks with data index d read the same
  local batch (``shard_batch`` of a global one, or the reader's line
  stride d of D), and the ranks of one model column (``data_group``)
  sum their gradients.

``shard_params`` / ``gather_params`` convert between full tables and a
rank's slices (``convert.py``, checkpoints). ``take_row_range`` is a
rank's part of a gather from a sharded table (the kernels' wrappers and
the model's plane wire). ``local_rows`` is the eval output's local rows:
each rank's outputs already are its own rows.

``ops/_shard_map.py`` has no counterpart: it only bridges JAX versions'
``shard_map`` spellings. Collectives are ``all_reduce`` and
``broadcast``, the two that gloo runs on CUDA tensors as well (the
one-card phase of ``chip_smoke.py``), and exact for any dtype where it
matters: a gather is a broadcast from each owner, never a sum.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = 'data'
MODEL_AXIS = 'model'
# the row-sharded parameters (the rest are replicated)
TABLES = ('token_embedding', 'path_embedding', 'target_embedding')


class MeshUnsupported(NotImplementedError):
    """A knob or a path that runs on one rank only so far: on a mesh of
    more than one rank it raises this, naming ROADMAP A9b."""

    def __init__(self, what: str):
        super().__init__(
            '%s is not supported on a mesh of more than one rank yet '
            '(ROADMAP A9b); run it on one rank' % what)


def check_trainer_config(config, mesh: Optional['Mesh']) -> None:
    """The reference Trainer's checks of a config against its mesh (None:
    one rank) (code2vec_tpu/training/trainer.py:70-92): the batch sizes
    divisible by the data axis, PARAM_ROW_ALIGNMENT by the model axis;
    then, on a mesh of more than one rank, LAZY_EMBEDDING_ADAM (A9b)
    refused typed, and TELEMETRY, whose files are one process's. (A9b's
    SHARD_CONTEXTS and OPTIMIZER_STATE_SHARDING are not config keys yet:
    ``Config`` refuses them as unknown.)"""
    data, model = (1, 1) if mesh is None else (mesh.data, mesh.model)
    for attr in ('TRAIN_BATCH_SIZE', 'TEST_BATCH_SIZE'):
        if getattr(config, attr) % data:
            raise ValueError(
                '%s=%d must be divisible by the mesh data axis (%d).'
                % (attr, getattr(config, attr), data))
    if config.PARAM_ROW_ALIGNMENT % model:
        raise ValueError(
            'PARAM_ROW_ALIGNMENT=%d must be divisible by the mesh model '
            'axis (%d) for even table sharding.'
            % (config.PARAM_ROW_ALIGNMENT, model))
    if data * model > 1:
        for attr, refused in (
                ('LAZY_EMBEDDING_ADAM', config.LAZY_EMBEDDING_ADAM),
                # every rank's exporters would write one directory's files
                ('TELEMETRY', config.TELEMETRY)):
            if refused:
                raise MeshUnsupported(attr)


class Mesh:
    """A (data, model) grid over ``ranks`` (global ranks, row-major), with
    one process group per data row and per model column. Built by every
    rank of the world (``create_mesh``), member or not; a rank outside
    ``ranks`` takes no part in its collectives."""

    def __init__(self, data: int, model: int, ranks: Sequence[int]):
        self.data = data
        self.model = model
        self.ranks = tuple(ranks)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        grid = np.asarray(self.ranks).reshape(data, model)
        self.member = self.rank in self.ranks
        index = self.ranks.index(self.rank) if self.member else 0
        self.data_index, self.model_index = divmod(index, model)
        self.model_ranks = tuple(int(r) for r in grid[self.data_index])
        self.data_ranks = tuple(int(r) for r in grid[:, self.model_index])
        self.group = self.model_group = self.data_group = None
        if dist.is_initialized():
            # every rank of the world enters every new_group, in one order
            self.group = dist.new_group(list(self.ranks))
            for d in range(data):
                group = dist.new_group([int(r) for r in grid[d]])
                if d == self.data_index:
                    self.model_group = group
            for m in range(model):
                group = dist.new_group([int(r) for r in grid[:, m]])
                if m == self.model_index:
                    self.data_group = group

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    def __repr__(self) -> str:
        return 'Mesh(%dx%d, rank %d = (%d, %d))' % (
            self.data, self.model, self.rank, self.data_index,
            self.model_index)

    # ------------------------------------------------------------- layout
    def row_range(self, rows: int) -> Tuple[int, int]:
        """This rank's rows [lo, hi) of a model-sharded table of ``rows``."""
        if rows % self.model:
            raise ValueError('%d table rows do not shard evenly over the '
                             'model axis (%d)' % (rows, self.model))
        per = rows // self.model
        return self.model_index * per, (self.model_index + 1) * per

    def shard_params(self, named: Dict[str, object]) -> Dict[str, object]:
        """Full parameters ({name: array or tensor}) -> this rank's: the
        tables' row slices, the dense weights as they are."""
        out = {}
        for name, value in named.items():
            if name in TABLES:
                lo, hi = self.row_range(value.shape[0])
                value = value[lo:hi]
            out[name] = value
        return out

    def shard_batch(self, arrays: Sequence[object]) -> tuple:
        """This rank's data shard of per-example arrays: rows [d B / D,
        (d + 1) B / D) of each (the JAX package's ``batch_spec``)."""
        out = []
        for a in arrays:
            batch = a.shape[0]
            if batch % self.data:
                raise ValueError('a batch of %d rows does not split over the '
                                 'data axis (%d)' % (batch, self.data))
            per = batch // self.data
            out.append(a[self.data_index * per:(self.data_index + 1) * per])
        return tuple(out)

    # -------------------------------------------------------- collectives
    def _group(self, axis: Optional[str]):
        return {None: self.group, DATA_AXIS: self.data_group,
                MODEL_AXIS: self.model_group}[axis]

    def axis_size(self, axis: Optional[str]) -> int:
        return {None: self.size, DATA_AXIS: self.data,
                MODEL_AXIS: self.model}[axis]

    def all_reduce(self, tensor: torch.Tensor, axis: Optional[str],
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``tensor`` reduced in place over ``axis`` (None: the whole
        mesh); a no-op on an axis of one rank."""
        if self.axis_size(axis) > 1:
            dist.all_reduce(tensor, op=op, group=self._group(axis))
        return tensor

    def gather_rows(self, local: torch.Tensor, axis: str = MODEL_AXIS
                    ) -> torch.Tensor:
        """The concatenation over ``axis`` of every rank's ``local`` (equal
        shapes), in rank order: one broadcast from each owner, so every
        bit arrives as it left."""
        ranks = self.model_ranks if axis == MODEL_AXIS else self.data_ranks
        if len(ranks) == 1:
            return local
        local = local.detach().contiguous()
        parts = []
        for src in ranks:
            buffer = local if src == self.rank else torch.empty_like(local)
            dist.broadcast(buffer, src, group=self._group(axis))
            parts.append(buffer)
        return torch.cat(parts)

    def gather_params(self, named: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """This rank's parameters (or moments) -> the full ones, on every
        rank of its data row: the tables gathered over the model axis, the
        replicated weights as they are."""
        return {name: (self.gather_rows(value) if name in TABLES else value)
                for name, value in named.items()}

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)


def create_mesh(config=None, ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The (data, model) mesh over ``ranks`` (default: the whole world),
    ``MESH_DATA_AXIS_SIZE == -1`` meaning the ranks the model axis leaves;
    a size that does not match the ranks raises, as the JAX package's
    ``create_mesh`` does. Every rank of the world must call it, in the
    same order as the other ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world)) if ranks is None else list(ranks)
    model = config.MESH_MODEL_AXIS_SIZE if config is not None else 1
    data = config.MESH_DATA_AXIS_SIZE if config is not None else -1
    if model <= 0:
        model = 1
    if data <= 0:
        data = len(ranks) // model
    if data * model != len(ranks) or data < 1:
        raise ValueError('Mesh {}x{} does not match {} ranks.'.format(
            data, model, len(ranks)))
    return Mesh(data, model, ranks)


def take_row_range(table: torch.Tensor, idx: torch.Tensor, lo: int
                   ) -> torch.Tensor:
    """``table`` holds rows [lo, lo + len) of a model-sharded table: the
    rows of the global ``idx`` it holds, zero for the rest, so that the
    sum over the model axis is the whole table's ``table[idx]``."""
    local = idx - lo
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(mine, local, 0)]
    return torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype))


def local_rows(tensor: torch.Tensor) -> np.ndarray:
    """The eval output's local rows on the host: each rank's outputs are
    the rows of its own data shard already (the JAX package stitches
    them out of a global array's addressable shards)."""
    return tensor.detach().cpu().numpy()


# ------------------------------------------------- collectives in autograd
class _GradSum(torch.autograd.Function):
    """Identity forward; the gradient summed over an axis: a replicated
    input whose uses on each rank saw only that rank's share (the dense
    weights over the data axis, the code vectors over the model axis)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.axis), None, None


class _ForwardSum(torch.autograd.Function):
    """Sum over an axis forward; the gradient passes as it is: the summed
    value is replicated, and each rank's loss counts it once."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _MergeLse(torch.autograd.Function):
    """The global logsumexp from each model shard's: m = max, m +
    log(sum exp(lse_shard - m)); the gradient of a shard's lse is
    exp(lse_shard - lse)."""

    @staticmethod
    def forward(ctx, lse_shard, mesh):
        m = mesh.all_reduce(lse_shard.clone(), MODEL_AXIS,
                            op=dist.ReduceOp.MAX)
        total = mesh.all_reduce(torch.exp(lse_shard - m), MODEL_AXIS)
        lse = m + torch.log(total)
        ctx.save_for_backward(lse_shard, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        lse_shard, lse = ctx.saved_tensors
        return g * torch.exp(lse_shard - lse), None


def grad_sum(x: torch.Tensor, mesh: Optional['Mesh'], axis: str
             ) -> torch.Tensor:
    """``x``, whose gradient is summed over ``axis`` (a no-op without a
    mesh or on an axis of one rank)."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    return _GradSum.apply(x, mesh, axis)


def forward_sum(x: torch.Tensor, mesh: Optional['Mesh'], axis: str
                ) -> torch.Tensor:
    """``x`` summed over ``axis``, differentiable (the gradient passes)."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    return _ForwardSum.apply(x, mesh, axis)


def merge_lse(lse_shard: torch.Tensor, mesh: Optional['Mesh']
              ) -> torch.Tensor:
    """The global logsumexp over the model axis, differentiable; a shard
    with no valid column (lse at or below -1e9) adds exactly 0."""
    if mesh is None or mesh.model == 1:
        return lse_shard
    return _MergeLse.apply(lse_shard, mesh)
