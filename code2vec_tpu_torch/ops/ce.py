"""Streamed softmax cross-entropy over the target vocabulary — the
counterpart of ``code2vec_tpu/ops/pallas_ce.py`` (single device).

The training loss needs only ``logsumexp(logits)`` and
``logits[label]`` per example. ``fused_lse_and_pick`` gets both, and
their gradients, without the ``(B, V)`` logits in device memory: the
forward and backward kernels (``csrc/ce.cu``) stream the target table in
blocks and recompute the logits block by block. Two versions of each:

- ``_lse_pick_plain`` / ``_ce_grads_plain``: plain PyTorch over
  materialized logits, what the CPU runs and what the kernels are held
  against on the card;
- ``_lse_pick_kernel`` / ``_ce_grads_kernel``: the kernel wrappers. They
  run the plain version for CPU tensors only; for CUDA tensors they
  launch the kernel or raise.

Columns at or past ``num_valid`` are masked; a label outside the valid
columns picks 0 (such rows carry weight 0). In bf16 the products run on
bf16 values with fp32 accumulation, and ``dlogits`` is rounded to bf16
before both backward products, as in the TPU kernel.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

# vocabulary alignment of the target table under USE_PALLAS_FUSED_CE (the
# reference kernel's vocab tile), so both packages allocate the same rows
VOCAB_TILE = 1024
_NEG = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VOCAB_BLOCK = 64     # table rows per block of the kernels (csrc/ce.cu)
_ROW_TILE = 64        # batch rows per tile of the kernels
_FWD_ROWS = 128       # batch rows per unit of the bf16 forward
_FWD_BLOCK = 128      # table rows per block of the bf16 forward
_TMA_ALIGN = 16       # bytes: the bf16 kernels read code and table by TMA

# kernel launches made by the forward (fwd_launches) and backward
# (bwd_launches) wrappers
fwd_launches = 0
bwd_launches = 0


def _pad_vocab(w: torch.Tensor) -> torch.Tensor:
    """Rows padded with zeros to a VOCAB_TILE multiple (a no-op for tables
    the backend aligned; the padded columns are masked)."""
    v = w.shape[0]
    padded = -(-v // VOCAB_TILE) * VOCAB_TILE
    if padded == v:
        return w
    return torch.nn.functional.pad(w, (0, 0, 0, padded - v))


def _masked_logits(code: torch.Tensor, w: torch.Tensor, num_valid: int):
    logits = code.float() @ w.float().T                      # (B, V) f32
    col = torch.arange(w.shape[0], device=code.device)
    valid = col < num_valid
    return torch.where(valid, logits, _NEG), col, valid


def _lse_pick_plain(code: torch.Tensor, w: torch.Tensor,
                    label: torch.Tensor, num_valid: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse (B,), picked (B,)) fp32 over materialized logits."""
    logits, col, valid = _masked_logits(code, w, num_valid)
    lse = torch.logsumexp(logits, dim=1)
    onehot = (col[None, :] == label.long()[:, None]) & valid[None, :]
    picked = torch.where(onehot, logits, 0.0).sum(dim=1)
    return lse, picked


def _ce_grads_plain(code: torch.Tensor, w: torch.Tensor,
                    label: torch.Tensor, lse: torch.Tensor,
                    dlse: torch.Tensor, dpicked: torch.Tensor,
                    num_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dw (V, D) f32, dcode (B, D) f32) from the saved lse."""
    logits, col, valid = _masked_logits(code, w, num_valid)
    softmax = torch.where(valid[None, :], torch.exp(logits - lse[:, None]),
                          0.0)
    onehot = (col[None, :] == label.long()[:, None]) & valid[None, :]
    dlogits = dlse[:, None] * softmax + dpicked[:, None] * onehot
    dlogits = dlogits.to(code.dtype).float()
    return dlogits.T @ code.float(), dlogits @ w.float()


def _check(code: torch.Tensor, w: torch.Tensor, label: torch.Tensor
           ) -> int:
    """Validates what the kernels take (contiguous code and table); returns
    the dtype code."""
    dtype = code.dtype
    if dtype not in _DTYPE_CODES or w.dtype != dtype:
        raise TypeError('CE kernel: code and table must share float32 or '
                        'bfloat16, got %s and %s' % (dtype, w.dtype))
    if w.device != code.device or label.device != code.device:
        raise TypeError('CE kernel: code, table and label must share the '
                        'device %s' % code.device)
    dim = code.shape[1]
    if w.shape[1] != dim or dim % 128 or dim > 384:
        raise ValueError('CE kernel: needs a code dim that is a multiple of '
                         '128 and at most 384, shared by the table; got %d '
                         'and %d' % (dim, w.shape[1]))
    if w.shape[0] % _VOCAB_BLOCK:
        raise ValueError('CE kernel: the table rows %d must be a multiple '
                         'of %d' % (w.shape[0], _VOCAB_BLOCK))
    if dtype == torch.bfloat16 and any(
            t.data_ptr() % _TMA_ALIGN for t in (code, w)):
        raise ValueError('CE kernel: bf16 code and table must start on a '
                         '%d-byte boundary (TMA), got offsets %d and %d'
                         % (_TMA_ALIGN, code.data_ptr() % _TMA_ALIGN,
                            w.data_ptr() % _TMA_ALIGN))
    return _DTYPE_CODES[dtype]


def _load():
    from code2vec_tpu_torch.ops import _build
    lib = _build.load('ce')
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ce_vocab_block.argtypes = []
    lib.ce_vocab_block.restype = i32
    if lib.ce_vocab_block() != _VOCAB_BLOCK:
        raise RuntimeError('CE kernel: the library\'s vocabulary block %d '
                           'is not %d' % (lib.ce_vocab_block(), _VOCAB_BLOCK))
    lib.ce_fwd.argtypes = [i32, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr,
                           ptr, ptr, ptr, ptr, ptr]
    lib.ce_fwd.restype = i32
    lib.ce_bwd.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                           i32, i32, ptr, ptr, ptr, ptr]
    lib.ce_bwd.restype = i32
    lib.ce_error_string.argtypes = [i32]
    lib.ce_error_string.restype = ctypes.c_char_p
    return lib


def _splits(sms: int, batch: int, n_blocks: int) -> int:
    """Vocabulary splits: about four units of (row tile, split) per SM."""
    row_tiles = -(-batch // _ROW_TILE)
    return max(1, min(n_blocks, -(-4 * sms // row_tiles)))


def _fwd_plan(batch: int, vocab: int, dtype: torch.dtype, sms: int) -> dict:
    """How the forward cuts its work (``csrc/ce.cu``): units of (row tile,
    vocabulary split), each split ``per_split`` blocks of the table. bf16:
    128-row tiles and 128-row blocks (the last block may end past the
    table: TMA reads zeros there, and those columns are masked), about one
    unit per SM; fp32: 64 x 64, about four units per SM. ``scratch``: the
    partial (m, s, picked) of every split and row."""
    if dtype == torch.bfloat16:
        rows, block = _FWD_ROWS, _FWD_BLOCK
        n_blocks = -(-vocab // block)
        row_tiles = -(-batch // rows)
        n_splits = max(1, min(n_blocks, sms // row_tiles))
    else:
        rows, block = _ROW_TILE, _VOCAB_BLOCK
        n_blocks = vocab // block
        row_tiles = -(-batch // rows)
        n_splits = _splits(sms, batch, n_blocks)
    return {'row_tile': rows, 'block': block, 'n_blocks': n_blocks,
            'row_tiles': row_tiles, 'n_splits': n_splits,
            'per_split': -(-n_blocks // n_splits),
            'units': row_tiles * n_splits,
            'scratch': (3, n_splits, batch)}


def _bwd_plan(batch: int, vocab: int, dim: int, sms: int) -> dict:
    """How the backward cuts its work (``csrc/ce.cu``): pass 1 (dW) walks
    the ``vocab // 64`` table blocks, each over every row tile; pass 2
    (dcode) walks ``row_tiles x n_splits`` units, each over its split's
    ``per_split`` blocks. ``scratch``: the fp32 dcode partials, one
    (batch, dim) slab per split, summed in split order."""
    n_blocks = vocab // _VOCAB_BLOCK
    row_tiles = -(-batch // _ROW_TILE)
    n_splits = _splits(sms, batch, n_blocks)
    return {'n_blocks': n_blocks, 'row_tiles': row_tiles,
            'n_splits': n_splits, 'per_split': -(-n_blocks // n_splits),
            'units': row_tiles * n_splits,
            'scratch': (n_splits, batch, dim)}


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _lse_pick_kernel(code: torch.Tensor, w: torch.Tensor,
                     label: torch.Tensor, num_valid: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse, picked) through the forward kernel (``csrc/ce.cu``); the
    plain version for CPU tensors."""
    device = code.device
    if device.type == 'cpu':
        return _lse_pick_plain(code, w, label, num_valid)
    if device.type != 'cuda':
        raise ValueError('CE kernel: unsupported device %s' % device)
    global fwd_launches
    lib = _load()
    code = code.contiguous()
    w = w.contiguous()
    dtype_code = _check(code, w, label)
    batch, dim = code.shape
    vocab = w.shape[0]
    label = label.to(torch.int32).contiguous()
    plan = _fwd_plan(batch, vocab, code.dtype, _sms(device))
    n_splits = plan['n_splits']
    f32 = dict(dtype=torch.float32, device=device)
    part = torch.empty(plan['scratch'], **f32)
    lse = torch.empty((batch,), **f32)
    picked = torch.empty((batch,), **f32)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ce_fwd(dtype_code, code.data_ptr(), w.data_ptr(),
                        label.data_ptr(), batch, vocab, dim,
                        min(int(num_valid), vocab), n_splits,
                        part[0].data_ptr(), part[1].data_ptr(),
                        part[2].data_ptr(), lse.data_ptr(),
                        picked.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError('CE forward kernel launch failed: %s'
                           % lib.ce_error_string(rc).decode())
    fwd_launches += 1
    return lse, picked


def _ce_grads_kernel(code: torch.Tensor, w: torch.Tensor,
                     label: torch.Tensor, lse: torch.Tensor,
                     dlse: torch.Tensor, dpicked: torch.Tensor,
                     num_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dw, dcode) through the backward kernel (``csrc/ce.cu``); the
    plain version for CPU tensors."""
    device = code.device
    if device.type == 'cpu':
        return _ce_grads_plain(code, w, label, lse, dlse, dpicked,
                               num_valid)
    if device.type != 'cuda':
        raise ValueError('CE kernel: unsupported device %s' % device)
    global bwd_launches
    lib = _load()
    code = code.contiguous()
    w = w.contiguous()
    dtype_code = _check(code, w, label)
    batch, dim = code.shape
    vocab = w.shape[0]
    label = label.to(torch.int32).contiguous()
    lse = lse.float().contiguous()
    dlse = dlse.float().contiguous()
    dpicked = dpicked.float().contiguous()
    plan = _bwd_plan(batch, vocab, dim, _sms(device))
    n_splits = plan['n_splits']
    f32 = dict(dtype=torch.float32, device=device)
    # every row of all three is written by the kernels
    dw = torch.empty((vocab, dim), **f32)
    dcode = torch.empty((batch, dim), **f32)
    part = torch.empty(plan['scratch'], **f32)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ce_bwd(dtype_code, code.data_ptr(), w.data_ptr(),
                        label.data_ptr(), lse.data_ptr(), dlse.data_ptr(),
                        dpicked.data_ptr(), batch, vocab, dim,
                        min(int(num_valid), vocab), n_splits, dw.data_ptr(),
                        part.data_ptr(), dcode.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError('CE backward kernel launch failed: %s'
                           % lib.ce_error_string(rc).decode())
    bwd_launches += 1
    return dw, dcode


class _FusedLsePick(torch.autograd.Function):
    """(lse, picked) with the streamed backward; saves code, the table,
    the labels and lse — never the logits."""

    @staticmethod
    def forward(ctx, code, w, label, num_valid: int):
        w_padded = _pad_vocab(w)
        lse, picked = _lse_pick_kernel(code, w_padded, label, num_valid)
        ctx.save_for_backward(code, w_padded, label, lse)
        ctx.num_valid = num_valid
        ctx.vocab = w.shape[0]
        return lse, picked

    @staticmethod
    def backward(ctx, dlse, dpicked):
        code, w_padded, label, lse = ctx.saved_tensors
        dw, dcode = _ce_grads_kernel(code, w_padded, label, lse, dlse,
                                     dpicked, ctx.num_valid)
        return (dcode.to(code.dtype), dw[:ctx.vocab].to(w_padded.dtype),
                None, None)


def fused_lse_and_pick(code: torch.Tensor, w: torch.Tensor,
                       label: torch.Tensor, num_valid: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse (B,), picked (B,)) of ``code @ w.T`` without the (B, V) logits
    in device memory (plain versions for CPU tensors)."""
    return _FusedLsePick.apply(code, w, label, int(num_valid))


def fused_weighted_ce_sums(params_target: torch.Tensor,
                           code_vectors: torch.Tensor, label: torch.Tensor,
                           weight: torch.Tensor, num_valid_targets: int,
                           dtype: torch.dtype = torch.float32
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weighted CE sum, weight sum) for the training loss; the products
    run in ``dtype`` with fp32 accumulation, reductions in fp32."""
    lse, picked = fused_lse_and_pick(code_vectors.to(dtype),
                                     params_target.to(dtype), label,
                                     num_valid_targets)
    ce = lse - picked
    return (ce * weight).sum(), weight.sum()
