"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU with
``device='cpu'``. With no GPU and no explicit CPU request they raise:
nothing falls back to the CPU silently.

TF32 is switched off for matrix products and cuDNN, so a float32
product on the card is a true float32 product — the counterpart of the
reference's ``Precision.HIGHEST`` (code2vec_tpu/models/functional.py).
"""
from __future__ import annotations

import shutil
import subprocess
from typing import Optional, Union

import torch


def disable_tf32() -> None:
    """fp32 products in full fp32 on the card (TF32 keeps ~3 digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a GPU raises."""
    resolved = torch.device('cuda' if device is None else device)
    if resolved.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device is available; pass device="cpu" to run '
                'the plain PyTorch versions on the CPU')
        disable_tf32()
    elif resolved.type != 'cpu':
        raise ValueError('unsupported device %r (cuda or cpu)' % (device,))
    return resolved


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them — printed
    beside every number measured on the card."""
    smi = shutil.which('nvidia-smi')
    if smi is None:
        raise RuntimeError('nvidia-smi not found')
    out = subprocess.run(
        [smi, '--query-gpu=name,power.limit', '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
