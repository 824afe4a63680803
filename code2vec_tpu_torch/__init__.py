"""code2vec in PyTorch for one NVIDIA H100 — the port of ``code2vec_tpu``.

The JAX package beside this one is the reference; this package imports
none of it (it keeps its own copies of the host modules it needs) and
never imports ``jax``. Entry points run on ``cuda`` unless the caller
passes ``device='cpu'`` (``device.py``); on the CPU every kernel wrapper
runs its kernel's plain PyTorch version, on the card the hand-written
Hopper kernel (``ops/csrc/``).

It trains, evaluates and serves predictions (``model_api.py``), saves,
restores and releases models and reads the JAX package's checkpoints
(``checkpoints.py``), and runs from its own command line (``cli.py``).
"""
from code2vec_tpu_torch.config import Config

__all__ = ['Config']
