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

SHARD_CONTEXTS splits the dense encode's contexts over the model axis:
``context_slice`` is rank (d, m)'s contexts [m C / M, (m + 1) C / M),
and ``reduce_scatter`` (an all_reduce, then the rank's slice) leaves it
its contexts' gathered rows.

OPTIMIZER_STATE_SHARDING='zero' (ZeRO-1) splits each table's Adam
moments over the data axis too: rank (d, m) holds sub-slice d of its
table slice m, rows ``zero_range`` = [m V / M + d V / (M D), ...) of the
whole table, and updates only those rows of its parameters; ``sync_rows_``
then broadcasts each sub-slice from its owner over the data column, so
every rank of it holds the same slice bit for bit. The JAX package's
``P((data, model), None)`` gives device (d, m) moment block d M + m of
the whole table instead, which in general lies outside the rows that
device's parameters hold (XLA moves the rows); here a rank's moment rows
lie inside its own parameter rows, so the update and the broadcasts stay
within one data column. Both layouts hold the same bytes a rank and give
the same numbers; checkpoints store whole tables
(``zero_shard``/``zero_gather``), so neither layout shows there.

Placement (the reference's ``device_slice`` and
``partition_device_indices``): the host's cards, numbered as
``torch.cuda`` numbers them, split into disjoint contiguous slices, one
a serving worker (``serving/mesh.py``); MESH_DEVICE_INDICES is the slice
a process runs on. A worker pins itself to its slice before its first
CUDA call (``pin_to_slice``: ``CUDA_VISIBLE_DEVICES``, so that every
thread of it, every kernel launch and ``mem_get_info`` see its one card
as device 0) and proves the pin by the card's UUID. On a world of ranks
local rank r takes card ``indices[r]`` (``slice_card``).

``ops/_shard_map.py`` has no counterpart: it only bridges JAX versions'
``shard_map`` spellings. Collectives are ``all_reduce`` and
``broadcast``, the two that gloo runs on CUDA tensors as well (the
one-card phase of ``chip_smoke.py``), and exact for any dtype where it
matters: a gather is a broadcast from each owner, never a sum.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = 'data'
MODEL_AXIS = 'model'
# the row-sharded parameters (the rest are replicated)
TABLES = ('token_embedding', 'path_embedding', 'target_embedding')


class MeshUnsupported(NotImplementedError):
    """The serving engine and the serving mesh run on one rank: a port
    engine replays CUDA graphs on one card, and one spanning ranks would
    need a collective inside every replay and a coordinator agreeing on
    each batch. They serve on several cards by placement instead, one
    worker a card (MESH_DEVICES_PER_REPLICA). On a mesh of more than one
    rank they raise this, naming ROADMAP C15."""

    def __init__(self, what: str):
        super().__init__(
            '%s runs on one rank: a mesh of ranks does not serve it (ROADMAP '
            'C15); serve on several cards by placement, one worker replica a '
            'card (MESH_DEVICES_PER_REPLICA=1)' % what)


class PlacementError(RuntimeError):
    """A worker that is not on the card of its slice (its pin failed), or
    a scale-up that finds every slice held: typed, and never a fallback
    onto another card."""


# ------------------------------------------------------------- placement
def visible_cards() -> int:
    """The cards this process sees (0 without CUDA)."""
    return torch.cuda.device_count()


def parse_device_indices(indices: str) -> List[int]:
    """A comma-separated index spec ('0,1,2') as a list, with the
    reference's checks and messages: malformed, empty or duplicate
    indices raise."""
    try:
        idx = [int(tok) for tok in indices.split(',') if tok.strip()]
    except ValueError:
        raise ValueError(
            'MESH_DEVICE_INDICES must be comma-separated integers, got '
            '{!r}.'.format(indices))
    if not idx:
        raise ValueError('MESH_DEVICE_INDICES resolved to an empty '
                         'device slice: {!r}.'.format(indices))
    if len(set(idx)) != len(idx):
        raise ValueError('MESH_DEVICE_INDICES has duplicate indices: '
                         '{!r}.'.format(indices))
    return idx


def device_slice(indices: str, total: Optional[int] = None) -> List[int]:
    """A comma-separated index spec ('0,1,2') resolved against the
    ``total`` cards (default ``visible_cards()``), with the reference's
    checks and messages: malformed, empty, duplicate or out-of-range
    indices raise, so a misplaced worker fails typed instead of running
    on another card."""
    idx = parse_device_indices(indices)
    total = visible_cards() if total is None else total
    bad = [i for i in idx if i < 0 or i >= total]
    if bad:
        raise ValueError(
            'MESH_DEVICE_INDICES {!r} out of range for {} visible '
            'devices.'.format(bad, total))
    return idx


def partition_device_indices(n_slices: int, per_slice: int,
                             total: Optional[int] = None) -> List[List[int]]:
    """The ``total`` cards (default ``visible_cards()``) as ``n_slices``
    disjoint contiguous slices of ``per_slice`` each: the serving mesh's
    placement table, one slice a replica. Raises, with the reference's
    message, when the host has too few."""
    total = visible_cards() if total is None else total
    if n_slices * per_slice > total:
        raise ValueError(
            'Placement wants {} slices x {} devices but only {} are '
            'visible (MESH_DEVICES_PER_REPLICA too big for the '
            'replica count).'.format(n_slices, per_slice, total))
    return [list(range(s * per_slice, (s + 1) * per_slice))
            for s in range(n_slices)]


def card_uuid(index: int) -> str:
    """The UUID of card ``index`` as this process numbers it."""
    return str(torch.cuda.get_device_properties(index).uuid)


def pin_to_slice(indices: Sequence[int]) -> List[str]:
    """Pin this process to the cards ``indices`` (this process's
    numbering, which a spawned worker inherits from its parent) before
    its first CUDA call: ``CUDA_VISIBLE_DEVICES`` names them, through
    the variable's value this process inherited when it has one. Every
    thread then sees them as devices 0.., the kernels' launches and the
    allocator included. Returns the pinned cards' UUIDs; raises
    ``PlacementError`` when CUDA was initialized before the pin, or the
    process sees another count of cards after it."""
    if torch.cuda.is_initialized():
        raise PlacementError(
            'cannot pin to cards %s: CUDA was initialized in this process '
            'before its placement' % (list(indices),))
    inherited = os.environ.get('CUDA_VISIBLE_DEVICES')
    names = ([tok.strip() for tok in inherited.split(',') if tok.strip()]
             if inherited is not None else None)
    if names is not None and any(i >= len(names) for i in indices):
        raise PlacementError(
            'cards %s are out of range of the inherited '
            'CUDA_VISIBLE_DEVICES=%r' % (list(indices), inherited))
    os.environ['CUDA_VISIBLE_DEVICES'] = ','.join(
        names[i] if names is not None else str(i) for i in indices)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() != len(indices):
        raise PlacementError(
            'pinned to cards %s (CUDA_VISIBLE_DEVICES=%s), this process '
            'sees %d card(s)' % (list(indices),
                                 os.environ['CUDA_VISIBLE_DEVICES'],
                                 torch.cuda.device_count()))
    return [card_uuid(i) for i in range(len(indices))]


def slice_card(config) -> Optional[int]:
    """This process's card under MESH_DEVICE_INDICES (None when unset):
    local rank r's entry of the slice, whose length must equal the local
    ranks (one on a process of its own)."""
    indices = getattr(config, 'MESH_DEVICE_INDICES', '')
    if not indices:
        return None
    from code2vec_tpu_torch.parallel import distributed
    cards = device_slice(indices)
    local_rank, local_world = distributed.local_rank_and_world()
    if len(cards) != local_world:
        raise ValueError(
            'MESH_DEVICE_INDICES %r names %d card(s) for %d local rank(s): '
            'a rank runs on one card, so the slice holds one a local rank'
            % (indices, len(cards), local_world))
    return cards[local_rank]


def check_trainer_config(config, mesh: Optional['Mesh']) -> None:
    """The reference Trainer's checks of a config against its mesh (None:
    one rank) (code2vec_tpu/training/trainer.py:70-92), with its
    messages: the batch sizes divisible by the data axis, MAX_CONTEXTS by
    the model axis under SHARD_CONTEXTS, PARAM_ROW_ALIGNMENT by the model
    axis, and under OPTIMIZER_STATE_SHARDING='zero' by data x model."""
    data, model = (1, 1) if mesh is None else (mesh.data, mesh.model)
    for attr in ('TRAIN_BATCH_SIZE', 'TEST_BATCH_SIZE'):
        if getattr(config, attr) % data:
            raise ValueError(
                '%s=%d must be divisible by the mesh data axis (%d).'
                % (attr, getattr(config, attr), data))
    if config.SHARD_CONTEXTS and config.MAX_CONTEXTS % model:
        raise ValueError(
            'SHARD_CONTEXTS requires MAX_CONTEXTS=%d divisible by the '
            'mesh model axis (%d).' % (config.MAX_CONTEXTS, model))
    if config.PARAM_ROW_ALIGNMENT % model:
        raise ValueError(
            'PARAM_ROW_ALIGNMENT=%d must be divisible by the mesh model '
            'axis (%d) for even table sharding.'
            % (config.PARAM_ROW_ALIGNMENT, model))
    if config.OPTIMIZER_STATE_SHARDING == 'zero' and \
            config.PARAM_ROW_ALIGNMENT % (data * model):
        raise ValueError(
            "OPTIMIZER_STATE_SHARDING='zero' shards moment-table rows "
            'over the WHOLE mesh: PARAM_ROW_ALIGNMENT=%d must be '
            'divisible by data*model = %d.'
            % (config.PARAM_ROW_ALIGNMENT, data * model))


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

    def context_slice(self, contexts: int) -> slice:
        """This rank's contexts [m C / M, (m + 1) C / M) under
        SHARD_CONTEXTS."""
        if contexts % self.model:
            raise ValueError('%d contexts do not split over the model axis '
                             '(%d)' % (contexts, self.model))
        per = contexts // self.model
        return slice(self.model_index * per, (self.model_index + 1) * per)

    def zero_range(self, rows: int) -> Tuple[int, int]:
        """This rank's ZeRO rows [lo, hi) of its table slice of ``rows``
        rows: sub-slice d of D (module docstring)."""
        if rows % self.data:
            raise ValueError('%d table rows do not shard evenly over the '
                             'data axis (%d)' % (rows, self.data))
        per = rows // self.data
        return self.data_index * per, (self.data_index + 1) * per

    def zero_shard(self, named: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """This rank's table slices (or their moments) -> its ZeRO
        sub-slices; the dense weights' as they are."""
        out = {}
        for name, value in named.items():
            if name in TABLES:
                lo, hi = self.zero_range(value.shape[0])
                value = value[lo:hi]
            out[name] = value
        return out

    def zero_gather(self, named: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """``zero_shard``'s inverse over the data column (every rank of it
        must call it): the tables' sub-slices gathered into the rank's
        table slices, bit for bit."""
        return {name: (self.gather_rows(value, DATA_AXIS)
                       if name in TABLES else value)
                for name, value in named.items()}

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

    def _ranks(self, axis: str) -> Tuple[int, ...]:
        return self.model_ranks if axis == MODEL_AXIS else self.data_ranks

    def gather_rows(self, local: torch.Tensor, axis: str = MODEL_AXIS,
                    dim: int = 0) -> torch.Tensor:
        """The concatenation along ``dim`` over ``axis`` of every rank's
        ``local`` (equal shapes), in rank order: one broadcast from each
        owner, so every bit arrives as it left."""
        ranks = self._ranks(axis)
        if len(ranks) == 1:
            return local
        local = local.detach().contiguous()
        parts = []
        for src in ranks:
            buffer = local if src == self.rank else torch.empty_like(local)
            dist.broadcast(buffer, src, group=self._group(axis))
            parts.append(buffer)
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, tensor: torch.Tensor, axis: str,
                       dim: int = 0) -> torch.Tensor:
        """This rank's 1/n slice along ``dim`` of ``tensor`` summed over
        ``axis`` (n ranks): an all_reduce, then the slice (gloo runs no
        reduce-scatter on CUDA tensors; the sum is the all_reduce's on
        either backend)."""
        n = self.axis_size(axis)
        if n == 1:
            return tensor
        summed = self.all_reduce(tensor.contiguous(), axis)
        per = summed.shape[dim] // n
        index = self._ranks(axis).index(self.rank)
        return summed.narrow(dim, index * per, per)

    def sync_rows_(self, tensor: torch.Tensor) -> torch.Tensor:
        """ZeRO's all-gather of updated rows, in place over the data
        column: each ``zero_range`` sub-slice of ``tensor`` (a table
        slice, contiguous) broadcast from the rank that owns it, so that
        every rank of the column holds the same rows bit for bit."""
        if self.data == 1:
            return tensor
        tensor = tensor.detach()
        per = tensor.shape[0] // self.data
        for d, src in enumerate(self.data_ranks):
            dist.broadcast(tensor[d * per:(d + 1) * per], src,
                           group=self.data_group)
        return tensor

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

    def broadcast_object(self, obj, device) -> object:
        """The chief's (rank ``ranks[0]``) picklable ``obj`` on every rank
        of the mesh, through two broadcasts on ``device`` (its length,
        then its bytes); every rank calls it, the others with None."""
        src = self.ranks[0]
        payload = None
        size = torch.zeros(1, dtype=torch.int64)
        if self.rank == src:
            payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                       dtype=torch.uint8)
            size[0] = payload.numel()
        size = size.to(device)
        dist.broadcast(size, src, group=self.group)
        if payload is None:
            payload = torch.empty(int(size.item()), dtype=torch.uint8,
                                  device=device)
        else:
            payload = payload.to(device)
        dist.broadcast(payload, src, group=self.group)
        return pickle.loads(payload.cpu().numpy().tobytes())


def create_mesh(config=None, ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The (data, model) mesh over ``ranks`` (default: the whole world),
    ``MESH_DATA_AXIS_SIZE == -1`` meaning the ranks the model axis leaves;
    a size that does not match the ranks raises, as the JAX package's
    ``create_mesh`` does, and so does a MESH_DEVICE_INDICES slice that is
    malformed or does not hold one card a local rank (``slice_card``).
    Every rank of the world must call it, in the same order as the other
    ranks."""
    if config is not None:
        slice_card(config)
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


def require_one_host(mesh: Optional[Mesh], what: str) -> None:
    """Predict, the bulk paths and the index run on the ranks of one host
    (the counterpart of the reference's one-process mesh of one host's
    devices): a world whose ranks span hosts is refused, as the
    reference's single-host guard refuses a multi-host run."""
    from code2vec_tpu_torch.parallel import distributed
    if mesh is not None and distributed.spans_hosts():
        raise NotImplementedError(
            '%s runs on the ranks of one host; this world spans hosts (%d '
            'local ranks of %d): run it on one host, or use evaluate() with '
            '--export_code_vectors for a multi-host vector export'
            % (what, distributed.local_rank_and_world()[1],
               distributed.world_size()))


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
