"""code2vec in PyTorch for one NVIDIA H100 — the port of ``code2vec_tpu``.

The JAX package beside this one is the reference; this package imports
none of it (it keeps its own copies of the host modules it needs) and
never imports ``jax``. Entry points run on ``cuda`` unless the caller
passes ``device='cpu'`` (``device.py``); on the CPU every kernel wrapper
runs its kernel's plain PyTorch version, on the card the hand-written
Hopper kernel (``ops/csrc/``).

This slice covers the serving path: raw path-context lines ->
``Code2VecModel.predict`` -> the packed wire -> the ragged encode kernel
-> logits, top-k and decode.
"""
from code2vec_tpu_torch.config import Config

__all__ = ['Config']
