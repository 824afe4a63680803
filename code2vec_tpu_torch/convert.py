"""Weights and Adam state across packages: ``{name: np.ndarray}`` keyed
by the ``Code2VecParams`` field names, to and from the port's tensors,
and a ``.npz`` of that layout on disk.

The reference's ``Code2VecParams`` has the same five field names, so
``{k: np.asarray(v) for k, v in jax_params._asdict().items()}`` feeds
the port the reference's weights (the tests do exactly that). Adam state
travels as ``{'count': int, 'mu': {name: array}, 'nu': {name: array}}``,
the fields of the reference's ``ScaleByAdamState`` with its moment trees
as name -> array dicts; lazy Adam's state as ``{'dense': <that layout over
the dense keys>, 'mu': {table}, 'nu': {table}}``, the reference's
``LazyAdamState`` fields.

Given a ``mesh`` (``parallel/mesh.py``), the arrays are whole and the
tensors made of them this rank's: rows [m V / M, (m + 1) V / M) of each
table, the dense weights whole.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from code2vec_tpu_torch.checkpoints import map_opt_state
from code2vec_tpu_torch.models.functional import Code2VecParams
from code2vec_tpu_torch.ops.lazy_adam import LazyAdamState, named_state
from code2vec_tpu_torch.training.adam_dtypes import AdamState


def params_from_numpy(arrays: Dict[str, np.ndarray],
                      device: Union[str, torch.device] = 'cpu',
                      mesh=None) -> Code2VecParams:
    """{name: array} -> fp32 ``Code2VecParams`` on ``device`` (this rank's
    slices on a ``mesh``)."""
    missing = set(Code2VecParams._fields) - set(arrays)
    if missing:
        raise KeyError('missing parameters: %s' % sorted(missing))
    if mesh is not None:
        arrays = mesh.shard_params(arrays)
    return Code2VecParams(**{
        name: torch.from_numpy(
            np.array(arrays[name], dtype=np.float32)).to(device)
        for name in Code2VecParams._fields})


def params_to_numpy(params: Code2VecParams) -> Dict[str, np.ndarray]:
    """``Code2VecParams`` -> {name: fp32 numpy array} on the host."""
    return {name: getattr(params, name).detach().float().cpu().numpy()
            for name in Code2VecParams._fields}


def save_npz(path: str, params: Code2VecParams) -> None:
    np.savez(path, **params_to_numpy(params))


def load_npz(path: str, device: Union[str, torch.device] = 'cpu'
             ) -> Code2VecParams:
    with np.load(path) as data:
        return params_from_numpy({name: data[name] for name in data.files},
                                 device)


def opt_state_to_numpy(state: Union[AdamState, LazyAdamState]) -> dict:
    """An optimizer state in ``lazy_adam.named_state``'s layout with fp32
    numpy moments."""
    return map_opt_state(
        named_state(state),
        lambda named: {name: t.detach().float().cpu().numpy()
                       for name, t in named.items()})


def opt_state_from_numpy(arrays: dict,
                         device: Union[str, torch.device] = 'cpu',
                         mu_dtype: Optional[torch.dtype] = None,
                         nu_dtype: Optional[torch.dtype] = None,
                         mesh=None) -> AdamState:
    """{'count', 'mu', 'nu'} -> AdamState on ``device``, the moments
    stored in ``mu_dtype`` / ``nu_dtype`` (None: fp32; this rank's slices
    on a ``mesh``). Moments arriving in bf16 (numpy's ml_dtypes) pass
    through fp32 exactly."""
    if mesh is not None:
        arrays = map_opt_state(arrays, mesh.shard_params)

    def moments(named, dtype):
        return tuple(
            torch.from_numpy(np.array(named[name], dtype=np.float32)).to(
                device, dtype or torch.float32)
            for name in Code2VecParams._fields)
    return AdamState(count=int(arrays['count']),
                     mu=moments(arrays['mu'], mu_dtype),
                     nu=moments(arrays['nu'], nu_dtype))
