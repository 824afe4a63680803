"""Adam's two parameter updates on the card: the dense fused pass
(``adam_update``) and lazy Adam's row update (``adam_rows``), the
wrappers of ``csrc/adam.cu``.

The JAX package has no Pallas kernel here: XLA fuses optax's update
(``code2vec_tpu/training/adam_dtypes.py``) into one streaming pass per
parameter. ``adam_update`` is that pass, in place:

    m = b1 m + (1 - b1) g,   v = b2 v + (1 - b2) (g g)
    u = (m / b1c) / (sqrt(v / b2c) + eps),   p = p + (-lr) u

in the order of the JAX package's expression with one float32 rounding
per operation; ``g`` and the stored moments are fp32 or bf16 (the
moments stored back rounded to nearest even), ``p`` fp32. The plain
version (``adam_update_plain``) runs the same operations one torch op at
a time, dividing by 0-dim tensors (torch's CUDA division by a Python
scalar multiplies by its reciprocal, another rounding), so the kernel and
the plain version agree bit for bit on the card; on the CPU the plain
version equals a numpy float32 evaluation.

``adam_rows`` is lazy Adam's update of the touched rows of a table
(``ops/lazy_adam.py::sparse_row_adam``) from a uint8 mask over the
table's rows (a row list is first set into one, repeats setting the same
byte, so each row is updated once from its old values; no sort): a warp
ballots the flags of 32 rows and updates the flagged ones, no warp spent
on an untouched or repeated row.

Each wrapper runs the plain version for CPU tensors only; for CUDA
tensors it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCKS_PER_SM = 8               # 256-thread blocks: a full SM's threads

# kernel launches made by adam_update (launches) and adam_rows
# (row_launches); callers reset and read them to show that a path went
# through the kernels
launches = 0
row_launches = 0

_LIB = None
_SMS = {}


def f32(value: float) -> float:
    """``value`` rounded to float32 (a Python float that holds it)."""
    return float(np.float32(value))


class AdamScalars(NamedTuple):
    """The update's scalars, each a float32 value: JAX's weak-typed
    constants round ``b1``, ``1 - b1`` (taken in doubles), ``b2``,
    ``1 - b2``, ``eps`` and ``-lr`` to float32; ``b1c`` and ``b2c`` are
    the bias corrections computed in float32."""
    b1: float
    omb1: float
    b2: float
    omb2: float
    b1c: float
    b2c: float
    eps: float
    neg_lr: float

    @classmethod
    def make(cls, learning_rate: float, b1: float, b2: float, eps: float,
             b1c: float, b2c: float) -> 'AdamScalars':
        return cls(f32(b1), f32(1.0 - b1), f32(b2), f32(1.0 - b2), f32(b1c),
                   f32(b2c), f32(eps), f32(-learning_rate))


def _scalar(value: float, device: torch.device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


@torch.no_grad()
def adam_update_plain(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                      nu: torch.Tensor, s: AdamScalars) -> None:
    """The update in place, one torch op per rounding (module docstring);
    no ``alpha=`` or ``addcmul`` forms, which may fuse into an FMA."""
    g = g.float()
    m = torch.add(torch.mul(mu.float(), s.b1), torch.mul(g, s.omb1))
    v = torch.add(torch.mul(nu.float(), s.b2),
                  torch.mul(torch.mul(g, g), s.omb2))
    b1c = _scalar(s.b1c, p.device)
    b2c = _scalar(s.b2c, p.device)
    u = torch.div(torch.div(m, b1c),
                  torch.add(torch.sqrt(torch.div(v, b2c)), s.eps))
    p.add_(torch.mul(u, s.neg_lr))
    mu.copy_(m)
    nu.copy_(v)


def _load():
    global _LIB
    if _LIB is None:
        from code2vec_tpu_torch.ops import _build
        lib = _build.load('adam')
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f = ctypes.c_float
        lib.adam_update.argtypes = [i32, i32, i32, ptr, ptr, ptr, ptr, i64,
                                    f, f, f, f, f, f, f, f, i32, ptr]
        lib.adam_update.restype = i32
        lib.adam_rows_mark.argtypes = [ptr, i64, ptr, i64, i32, ptr]
        lib.adam_rows_mark.restype = i32
        lib.adam_rows.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, f, f, f,
                                  f, f, f, i32, ptr]
        lib.adam_rows.restype = i32
        lib.adam_error_string.argtypes = [i32]
        lib.adam_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def _check_update_args(p, g, mu, nu) -> tuple:
    if p.dtype != torch.float32:
        raise TypeError('Adam kernel: parameters must be float32, got %s'
                        % p.dtype)
    for name, t in (('gradient', g), ('mu', mu), ('nu', nu)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError('Adam kernel: the %s must be float32 or '
                            'bfloat16, got %s' % (name, t.dtype))
        if t.shape != p.shape or t.device != p.device:
            raise ValueError('Adam kernel: the %s has shape %s on %s, the '
                             'parameter %s on %s'
                             % (name, tuple(t.shape), t.device,
                                tuple(p.shape), p.device))
    for name, t in (('parameter', p), ('gradient', g), ('mu', mu),
                    ('nu', nu)):
        if not t.is_contiguous():
            raise ValueError('Adam kernel: the %s must be contiguous' % name)
    return _DTYPE_CODES[g.dtype], _DTYPE_CODES[mu.dtype], _DTYPE_CODES[
        nu.dtype]


@torch.no_grad()
def adam_update(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                nu: torch.Tensor, s: AdamScalars) -> None:
    """One Adam step in place on ``p`` and the stored moments: the kernel
    (one launch on the current stream, no host sync) for CUDA tensors,
    the plain version for CPU tensors."""
    if p.device.type == 'cpu':
        adam_update_plain(p, g, mu, nu, s)
        return
    if p.device.type != 'cuda':
        raise ValueError('Adam kernel: unsupported device %s' % p.device)
    global launches
    codes = _check_update_args(p, g, mu, nu)
    lib = _load()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = lib.adam_update(*codes, p.data_ptr(), g.data_ptr(),
                             mu.data_ptr(), nu.data_ptr(), p.numel(), *s,
                             _BLOCKS_PER_SM * _sms(p.device), stream)
    if rc != 0:
        raise RuntimeError('Adam kernel launch failed: %s'
                           % lib.adam_error_string(rc).decode())
    launches += 1


def _row_mask(rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The row kernel's mask: ``rows`` itself when it is a (V,) bool or
    uint8 mask (as uint8), else the int64 list set into a fresh one by the
    mark kernel (CUDA tensors; ``ops/lazy_adam.py::touched_mask`` is its
    plain version)."""
    device = rows.device
    if rows.dtype in (torch.bool, torch.uint8):
        if rows.shape != (n_rows,) or not rows.is_contiguous():
            raise ValueError('Adam row kernel: a row mask must be a '
                             'contiguous (%d,) vector, got %s'
                             % (n_rows, tuple(rows.shape)))
        return rows.view(torch.uint8)
    if rows.dtype != torch.int64 or rows.dim() != 1 or \
            not rows.is_contiguous():
        raise ValueError('Adam row kernel: the rows must be a contiguous '
                         'int64 vector or a (V,) mask on %s' % device)
    touched = torch.empty((n_rows,), dtype=torch.uint8, device=device)
    lib = _load()
    with torch.cuda.device(device):
        rc = lib.adam_rows_mark(rows.data_ptr(), rows.numel(),
                                touched.data_ptr(), n_rows,
                                _BLOCKS_PER_SM * _sms(device),
                                torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError('Adam row mark kernel launch failed: %s'
                           % lib.adam_error_string(rc).decode())
    return touched


@torch.no_grad()
def adam_rows(table: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
              grad: torch.Tensor, rows: torch.Tensor, lr_t: float,
              b1: float, b2: float, eps: float) -> None:
    """Lazy Adam's row update through the kernel (CUDA tensors only; the
    plain version is ``ops/lazy_adam.py::sparse_row_adam_plain``):
    ``table``, ``mu``, ``nu``, ``grad`` (V, d) fp32 contiguous on one
    card; ``rows`` the touched rows, an (n,) int64 list (repeats allowed;
    an entry outside [0, V) is skipped) or a (V,) bool or uint8 mask (a
    mesh's, ``mesh_touched_rows``); ``lr_t`` is lazy Adam's
    bias-corrected rate (float32)."""
    device = table.device
    if device.type != 'cuda':
        raise ValueError('Adam row kernel: unsupported device %s' % device)
    global row_launches
    for name, t in (('table', table), ('mu', mu), ('nu', nu),
                    ('gradient', grad)):
        if t.dtype != torch.float32 or t.shape != table.shape or \
                t.device != device or not t.is_contiguous() or t.dim() != 2:
            raise ValueError('Adam row kernel: the %s must be a contiguous '
                             'float32 (V, d) tensor shaped and placed as the '
                             'table %s on %s, got %s %s on %s'
                             % (name, tuple(table.shape), device, t.dtype,
                                tuple(t.shape), t.device))
    if rows.device != device:
        raise ValueError('Adam row kernel: the rows must be on %s' % device)
    touched = _row_mask(rows, table.shape[0])
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.adam_rows(table.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                           grad.data_ptr(), touched.data_ptr(),
                           table.shape[0], table.shape[1], f32(b1),
                           f32(1.0 - b1), f32(b2), f32(1.0 - b2), f32(lr_t),
                           f32(eps), _BLOCKS_PER_SM * _sms(device), stream)
    if rc != 0:
        raise RuntimeError('Adam row kernel launch failed: %s'
                           % lib.adam_error_string(rc).decode())
    row_launches += 1
