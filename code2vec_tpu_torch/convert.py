"""Weights across packages: ``{name: np.ndarray}`` keyed by the
``Code2VecParams`` field names, to and from the port's tensors, and a
``.npz`` of that layout on disk.

The reference's ``Code2VecParams`` has the same five field names, so
``{k: np.asarray(v) for k, v in jax_params._asdict().items()}`` feeds
the port the reference's weights (the tests do exactly that).
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from code2vec_tpu_torch.models.functional import Code2VecParams


def params_from_numpy(arrays: Dict[str, np.ndarray],
                      device: Union[str, torch.device] = 'cpu'
                      ) -> Code2VecParams:
    """{name: array} -> fp32 ``Code2VecParams`` on ``device``."""
    missing = set(Code2VecParams._fields) - set(arrays)
    if missing:
        raise KeyError('missing parameters: %s' % sorted(missing))
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
