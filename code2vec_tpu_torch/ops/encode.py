"""Fused context transform over dense context rows — the counterpart of
``code2vec_tpu/ops/pallas_encode.py``, the dense forward of the plane
wire:

    x      = tanh(src_e W_src + path_e W_path + tgt_e W_tgt)    (N, D) fp32
    scores = x . attention                                      (N, 1) fp32

``W_src``, ``W_path``, ``W_tgt`` are the row slices of the full TRANSFORM,
so the (N, 3d) concatenation is never built. Inputs and weights arrive in
the compute dtype (bf16 or fp32); products accumulate in fp32 and ``x``
stays fp32, also in bf16, as in the TPU kernel.

Two versions compute it: ``_transform_plain`` (plain PyTorch, what the
CPU runs and what the kernel is held against on the card) and
``_transform_kernel`` (the wrapper of ``csrc/encode.cu``), which runs the
plain version for CPU tensors only; for CUDA tensors it launches the
kernel or raises. In fp32 the kernel forms every product in three TF32
terms on the tensor cores (``csrc/tf32.cuh``); ``_transform_tf32x3``
emulates that arithmetic for the tests.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CODE_DIMS = (128, 256, 384)     # D of the kernel's instantiations
_K_CHUNK = 32                    # dt and dp must be multiples of it
_K_SLICE = 64                    # bf16: K columns per TMA slice
_MAX_K_SLICES = 6                # bf16: W's slices kept in shared memory
_ALIGN = 16                      # bytes: bf16 inputs are read by TMA,
                                 # fp32 rows by 16-byte cp.async

# kernel launches made by _transform_kernel; callers reset and read it to
# show that a path went through the kernel
launches = 0


def _transform_plain(src_e: torch.Tensor, path_e: torch.Tensor,
                     tgt_e: torch.Tensor, transform: torch.Tensor,
                     attention: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch: three row-split products on the inputs' fp32 values
    (exact for bf16 values) with fp32 accumulation, ``tanh``, the score
    product."""
    token_dim, path_dim = src_e.shape[1], path_e.shape[1]
    w = transform.float()
    x = torch.tanh(src_e.float() @ w[:token_dim]
                   + path_e.float() @ w[token_dim:token_dim + path_dim]
                   + tgt_e.float() @ w[token_dim + path_dim:])
    return x, x @ attention.float().reshape(-1, 1)


def _transform_tf32x3(src_e: torch.Tensor, path_e: torch.Tensor,
                      tgt_e: torch.Tensor, transform: torch.Tensor,
                      attention: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_transform_plain`` in fp32 with the three row-split products as
    the fp32 kernel forms them, each in three TF32 terms
    (``ops/ce.py::_mm_tf32x3``); the score stays an fp32 product, as the
    kernel's epilogue sums it. Used by the tests only, to hold the split's
    accuracy against float64; the kernel's sums run in another order."""
    from code2vec_tpu_torch.ops.ce import _mm_tf32x3
    token_dim, path_dim = src_e.shape[1], path_e.shape[1]
    w = transform.float()
    x = torch.tanh(_mm_tf32x3(src_e.float(), w[:token_dim])
                   + _mm_tf32x3(path_e.float(),
                                w[token_dim:token_dim + path_dim])
                   + _mm_tf32x3(tgt_e.float(), w[token_dim + path_dim:]))
    return x, x @ attention.float().reshape(-1, 1)


def _k_slices(token_dim: int, path_dim: int) -> int:
    """64-wide K slices of the bf16 kernel: each input is cut on its own,
    its last slice padded with zeros (TMA bounds)."""
    per = lambda d: -(-d // _K_SLICE)
    return 2 * per(token_dim) + per(path_dim)


def _check_kernel_args(src_e, path_e, tgt_e, transform, attention) -> int:
    """Validates what the kernel takes; returns its dtype code."""
    tensors = (src_e, path_e, tgt_e, transform, attention)
    dtype = transform.dtype
    if dtype not in _DTYPE_CODES or any(t.dtype != dtype for t in tensors):
        raise TypeError('encode kernel: inputs and weights must share one '
                        'dtype, float32 or bfloat16; got %s'
                        % [t.dtype for t in tensors])
    if any(t.device != src_e.device for t in tensors):
        raise TypeError('encode kernel: every tensor must be on %s'
                        % src_e.device)
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError('encode kernel: the row inputs and weights must be '
                         'contiguous')
    token_dim, path_dim = src_e.shape[1], path_e.shape[1]
    code_dim = transform.shape[1]
    if token_dim % _K_CHUNK or path_dim % _K_CHUNK \
            or code_dim not in _CODE_DIMS:
        raise ValueError('encode kernel: needs embedding dims that are '
                         'multiples of %d and a code dim in %s, got %d, %d '
                         'and %d' % (_K_CHUNK, _CODE_DIMS, token_dim,
                                     path_dim, code_dim))
    if dtype == torch.bfloat16:
        slices = _k_slices(token_dim, path_dim)
        if slices > _MAX_K_SLICES:
            raise ValueError('encode kernel: bf16 keeps at most %d K slices '
                             'of %d columns of W in shared memory; dims %d, '
                             '%d need %d' % (_MAX_K_SLICES, _K_SLICE,
                                             token_dim, path_dim, slices))
        read, what = (src_e, path_e, tgt_e, transform), 'bf16 rows and ' \
            'weights must start on a %d-byte boundary (TMA)'
    else:
        # fp32 takes W transposed, a fresh copy made by the wrapper
        read, what = (src_e, path_e, tgt_e), 'fp32 rows must start on a ' \
            '%d-byte boundary (16-byte cp.async)'
    offsets = [t.data_ptr() % _ALIGN for t in read]
    if any(offsets):
        raise ValueError('encode kernel: ' + what % _ALIGN
                         + ', got offsets %s' % offsets)
    return _DTYPE_CODES[dtype]


def _transform_kernel(src_e: torch.Tensor, path_e: torch.Tensor,
                      tgt_e: torch.Tensor, transform: torch.Tensor,
                      attention: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x, scores)`` through the Hopper kernel (``csrc/encode.cu``); the
    plain version for CPU tensors. Same contract as ``_transform_plain``."""
    device = src_e.device
    if device.type == 'cpu':
        return _transform_plain(src_e, path_e, tgt_e, transform, attention)
    if device.type != 'cuda':
        raise ValueError('encode kernel: unsupported device %s' % device)
    global launches
    transform = transform.contiguous()
    attention = attention.contiguous()
    dtype_code = _check_kernel_args(src_e, path_e, tgt_e, transform,
                                    attention)
    n, token_dim = src_e.shape
    path_dim = path_e.shape[1]
    code_dim = transform.shape[1]
    x = torch.empty((n, code_dim), dtype=torch.float32, device=device)
    scores = torch.empty((n, 1), dtype=torch.float32, device=device)
    if n == 0:
        return x, scores
    # fp32 reads W^T (D, K), K contiguous: both operands K-major
    w = transform.t().contiguous() if dtype_code == 0 else transform

    from code2vec_tpu_torch.ops import _build
    lib = _build.load('encode')
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.encode_fwd.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, i64, i32, i32,
                               i32, ptr, ptr, ptr]
    lib.encode_fwd.restype = i32
    lib.encode_error_string.argtypes = [i32]
    lib.encode_error_string.restype = ctypes.c_char_p
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.encode_fwd(
            dtype_code, src_e.data_ptr(), path_e.data_ptr(),
            tgt_e.data_ptr(), w.data_ptr(), attention.data_ptr(), n,
            token_dim, path_dim, code_dim, x.data_ptr(), scores.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError('encode kernel launch failed: %s' % (
            lib.encode_error_string(rc).decode(),))
    launches += 1
    return x, scores


def fused_context_transform(src_e: torch.Tensor, path_e: torch.Tensor,
                            tgt_e: torch.Tensor, transform: torch.Tensor,
                            attention: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, d)-shaped gathered embeddings -> ``(x (N, D) fp32, scores (N, 1)
    fp32)``, the TPU kernel's contract. ``transform`` is the full
    (2 d_tok + d_path, D) TRANSFORM, row-split here; ``attention`` is
    (D, 1). Goes through the kernel wrapper: the Hopper kernel for CUDA
    tensors, the plain version for CPU tensors. N is any row count: B·C
    on one rank, a rank's (B/D)·(C/M) under SHARD_CONTEXTS."""
    n, token_dim = src_e.shape
    path_dim = path_e.shape[1]
    if path_e.shape[0] != n or tgt_e.shape != (n, token_dim):
        raise ValueError('fused_context_transform: row inputs of shapes %s, '
                         '%s, %s' % (tuple(src_e.shape), tuple(path_e.shape),
                                     tuple(tgt_e.shape)))
    context_dim, code_dim = transform.shape
    if context_dim != 2 * token_dim + path_dim or \
            attention.numel() != code_dim:
        raise ValueError('fused_context_transform: transform %s and '
                         'attention %s do not fit dims %d/%d'
                         % (tuple(transform.shape), tuple(attention.shape),
                            token_dim, path_dim))
    return _transform_kernel(src_e, path_e, tgt_e, transform,
                             attention.reshape(code_dim, 1))
