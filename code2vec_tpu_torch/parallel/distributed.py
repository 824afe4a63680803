"""Joining a world of ranks — the counterpart of
``code2vec_tpu/parallel/distributed.py``.

The JAX package joins ``jax.distributed`` once per host and lets XLA
compile the collectives over every device it then sees. PyTorch's idiom
is one process per card: a run of N ranks is N processes, started by
``torchrun --nproc-per-node N -m code2vec_tpu_torch.cli ...``, each of
which calls ``maybe_initialize_distributed`` before anything touches the
card. Rank r stands for device r of the JAX package's (data, model)
mesh (``parallel/mesh.py``).

The world comes from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``)
or from the arguments. One process is a no-op, as the JAX function is,
so the CLI calls it unconditionally.

Backends: ``nccl`` by default, which needs a card for every rank of a
host: asked to seat two NCCL ranks on one card it raises (NCCL refuses
that itself with "Duplicate GPU detected"). ``gloo`` runs only when the
caller names it (the CPU tests, the one-card phase of ``chip_smoke.py``,
whose four ranks share one card); the chosen backend is logged. Nothing
switches from one backend to the other by itself.

MESH_DEVICE_INDICES (``device_indices``) names the host's cards the local
ranks run on: local rank r takes card ``indices[r]`` in place of card r
(``parallel/mesh.py::slice_card``).
"""
from __future__ import annotations

import datetime
import os
from types import SimpleNamespace
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ('nccl', 'gloo')
# seconds a collective waits for its peers before it raises
DEFAULT_TIMEOUT_S = 600.0

# this rank's card (local_device)
_card = 0
# this process's (local rank, local world size) once a world was joined
_local: Optional[tuple] = None


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, '') else None


def world_size() -> int:
    """Ranks of the joined world (1 when none was joined)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 when no world was joined)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank_and_world() -> tuple:
    """(local rank, ranks on this host): the joined world's, else
    torchrun's environment, else (0, 1)."""
    if _local is not None:
        return _local
    return (_env_int('LOCAL_RANK') or 0,
            _env_int('LOCAL_WORLD_SIZE') or _env_int('WORLD_SIZE') or 1)


def spans_hosts() -> bool:
    """Whether the joined world holds ranks of more than one host (fewer
    local ranks than ranks)."""
    return local_rank_and_world()[1] < world_size()


def maybe_initialize_distributed(
        init_method: Optional[str] = None,
        world_size: Optional[int] = None,
        rank: Optional[int] = None,
        local_rank: Optional[int] = None,
        backend: Optional[str] = None,
        store: Optional[dist.Store] = None,
        timeout_s: float = DEFAULT_TIMEOUT_S,
        log=None, device_indices: str = '') -> bool:
    """Join the ``torch.distributed`` world when more than one rank is
    configured; returns True if it joined (or had joined before).

    ``init_method`` (``tcp://host:port``) or ``store`` (a ``FileStore``:
    the tests) name the rendezvous; without either it is torchrun's
    ``env://`` (MASTER_ADDR/MASTER_PORT). ``backend`` is 'nccl' unless
    the caller names 'gloo'. Under NCCL each rank takes
    ``torch.device('cuda', local_rank)`` as its current device, or card
    ``indices[local_rank]`` of ``device_indices`` (MESH_DEVICE_INDICES)
    when that is set."""
    global _card, _local
    if dist.is_initialized():
        return True
    if world_size is None:
        world_size = _env_int('WORLD_SIZE') or 1
    if world_size <= 1:
        return False
    if rank is None:
        rank = _env_int('RANK')
        if rank is None:
            raise ValueError('WORLD_SIZE=%d but no RANK: start the ranks '
                             'with torchrun or pass rank=' % world_size)
    if local_rank is None:
        local_rank = _env_int('LOCAL_RANK')
        if local_rank is None:
            local_rank = rank
    backend = backend or 'nccl'
    if backend not in BACKENDS:
        raise ValueError('backend must be one of %s, got %r'
                         % (BACKENDS, backend))
    _local = (local_rank, _env_int('LOCAL_WORLD_SIZE') or world_size)
    card = None
    if device_indices:
        from code2vec_tpu_torch.parallel.mesh import slice_card
        card = slice_card(SimpleNamespace(MESH_DEVICE_INDICES=device_indices))
    if backend == 'nccl':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'the nccl backend needs a CUDA card for every rank and '
                'none is available; name backend="gloo" to run the ranks '
                'on the CPU')
        cards = torch.cuda.device_count()
        local_world = _env_int('LOCAL_WORLD_SIZE') or min(world_size, cards)
        if local_rank >= cards or local_world > cards:
            raise RuntimeError(
                'the nccl backend would seat %d ranks on %d card(s) of '
                'this host (local rank %d): NCCL needs one card per rank '
                '(it refuses two ranks on one card, "Duplicate GPU '
                'detected"); name backend="gloo" to share a card'
                % (local_world, cards, local_rank))
        torch.cuda.set_device(local_rank if card is None else card)
    kwargs = dict(backend=backend, rank=rank, world_size=world_size,
                  timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None:
        kwargs['store'] = store
    else:
        kwargs['init_method'] = init_method or 'env://'
    dist.init_process_group(**kwargs)
    # gloo ranks share the host's cards round robin (one card: all of
    # them on it); nccl ranks have one each
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 1
    _card = (card if card is not None else local_rank if backend == 'nccl'
             else local_rank % max(cards, 1))
    if log is not None:
        log('torch.distributed: rank %d of %d (local rank %d), backend %s'
            % (rank, world_size, local_rank, backend))
    return True


def local_device(device_type: str = 'cuda') -> torch.device:
    """This rank's device: ``cuda:<local rank>`` under nccl, the host's
    cards round robin under gloo (every rank on the one card of a
    one-card host), or the CPU."""
    if device_type == 'cpu':
        return torch.device('cpu')
    return torch.device('cuda', _card)


def shutdown() -> None:
    """Leave the world (a no-op when none was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()
