"""Ragged fused encode + attention straight off the packed wire — the
forward of ``code2vec_tpu/ops/pallas_ragged.py``.

Per slot t of the packed stream (slots past a shard's total and interior
all-PAD holes are masked out):

    x_t = tanh(tok[src_t] W_src + path[pth_t] W_path + tok[tgt_t] W_tgt)
    s_t = x_t . ATTENTION

per example i (a segment of the stream, delimited by ``count``):

    m_i = max_t s_t,  z_i = sum_t exp(s_t - m_i),
    acc_i = sum_t exp(s_t - m_i) x_t,  code_i = acc_i / z_i

Two versions compute the same ``(scores, m, z, acc)`` statistics:

- ``_stats_plain``: plain PyTorch segment ops on any device; what the
  CPU runs, and what the kernel is held against on the card;
- ``_stats_kernel``: the wrapper of the hand-written Hopper kernel
  ``csrc/ragged_fwd.cu``. It runs the plain version for CPU tensors only;
  for CUDA tensors it launches the kernel or raises.

Both keep ``x`` in fp32 for the score and the weighted sum, as the TPU
kernel does. (The reference's jnp twin ``_stats_jnp`` rounds ``x`` to
bf16 in bf16 mode; the TPU kernel does not, and the port follows the
kernel.) ``_finish`` turns the statistics into code vectors and
attention planes with the count == 0 fixups (``code = x_pad``, uniform
``1/C`` attention) that match the dense path.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from code2vec_tpu_torch.data.packed import segment_starts, segment_structure

_NEG = -1e30        # finite -inf stand-in, as in the TPU kernel
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by _stats_kernel; callers reset and read it to
# show that a path went through the kernel
launches = 0


class SegmentInputs(NamedTuple):
    """The segment structure of one packed batch."""
    ctx: torch.Tensor          # (D, cap, 3) int32 triples
    count2: torch.Tensor       # (D, Bs) int32 per-example lengths
    seg: torch.Tensor          # (D, cap) int64 example of each slot
    pos: torch.Tensor          # (D, cap) position within the example
    slot_valid: torch.Tensor   # (D, cap) bool


def _segment_inputs(ctx: torch.Tensor, count: torch.Tensor, token_pad: int,
                    path_pad: int) -> SegmentInputs:
    shards, cap, _ = ctx.shape
    per_shard = count.shape[0] // shards
    count2 = count.reshape(shards, per_shard).to(torch.int32)
    seg, pos, in_range = segment_structure(count2, cap)
    src, pth, tgt = ctx[..., 0], ctx[..., 1], ctx[..., 2]
    # reader.context_valid_mask on the packed stream: interior holes
    # drop out here as the dense path's log-mask drops them
    slot_valid = in_range & ((src != token_pad) | (tgt != token_pad)
                             | (pth != path_pad))
    return SegmentInputs(ctx, count2, seg, pos, slot_valid)


def _split_weights(transform: torch.Tensor, token_dim: int, path_dim: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return (transform[:token_dim], transform[token_dim:token_dim + path_dim],
            transform[token_dim + path_dim:])


def _stats_plain(token_embedding: torch.Tensor,
                 path_embedding: torch.Tensor, transform: torch.Tensor,
                 attention: torch.Tensor, segs: SegmentInputs,
                 token_pad: int, path_pad: int):
    """Plain PyTorch statistics: ``(scores (D, cap), m (D, Bs), z (D, Bs),
    acc (D, Bs, Dc))``, all fp32. Weights and tables arrive in the
    compute dtype; products run on their fp32 values with fp32
    accumulation, as the kernel does. ``token_pad``/``path_pad`` are
    already folded into ``segs.slot_valid``."""
    del token_pad, path_pad
    shards, cap, _ = segs.ctx.shape
    per_shard = segs.count2.shape[1]
    token_dim = token_embedding.shape[1]
    path_dim = path_embedding.shape[1]
    ctx = segs.ctx.long()
    src_e = token_embedding[ctx[..., 0]].float()             # (D, cap, d)
    pth_e = path_embedding[ctx[..., 1]].float()
    tgt_e = token_embedding[ctx[..., 2]].float()
    w_src, w_path, w_tgt = _split_weights(transform.float(), token_dim,
                                          path_dim)
    x = torch.tanh(src_e @ w_src + pth_e @ w_path + tgt_e @ w_tgt)
    scores = (x @ attention.float().reshape(-1, 1))[..., 0]  # (D, cap)
    valid = segs.slot_valid
    scores = torch.where(valid, scores, _NEG)
    # flat example id of every slot; every seg lies in [0, per_shard)
    shard_base = (torch.arange(shards, device=scores.device)
                  * per_shard)[:, None]
    flat_seg = (segs.seg + shard_base).reshape(-1)
    n_seg = shards * per_shard
    m = torch.full((n_seg,), _NEG, dtype=torch.float32,
                   device=scores.device)
    m = m.scatter_reduce(0, flat_seg, scores.reshape(-1), reduce='amax')
    p = torch.where(valid.reshape(-1),
                    torch.exp(scores.reshape(-1) - m[flat_seg]), 0.0)
    z = torch.zeros((n_seg,), dtype=torch.float32, device=scores.device)
    z = z.index_add(0, flat_seg, p)
    code_dim = x.shape[-1]
    acc = torch.zeros((n_seg, code_dim), dtype=torch.float32,
                      device=scores.device)
    acc = acc.index_add(0, flat_seg, p[:, None] * x.reshape(-1, code_dim))
    return (scores, m.reshape(shards, per_shard),
            z.reshape(shards, per_shard),
            acc.reshape(shards, per_shard, code_dim))


def _stats_kernel(token_embedding: torch.Tensor,
                  path_embedding: torch.Tensor, transform: torch.Tensor,
                  attention: torch.Tensor, segs: SegmentInputs,
                  token_pad: int, path_pad: int):
    """The statistics through the Hopper kernel (``csrc/ragged_fwd.cu``);
    the plain version for CPU tensors. Same contract as
    ``_stats_plain``."""
    device = segs.ctx.device
    if device.type == 'cpu':
        return _stats_plain(token_embedding, path_embedding, transform,
                            attention, segs, token_pad, path_pad)
    if device.type != 'cuda':
        raise ValueError('ragged kernel: unsupported device %s' % device)
    global launches
    dtype = transform.dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError('ragged kernel takes float32 or bfloat16, got %s'
                        % dtype)
    tensors = (token_embedding, path_embedding, transform, attention)
    if any(t.dtype != dtype or t.device != device for t in tensors):
        raise TypeError('ragged kernel: tables and weights must share the '
                        'dtype %s and the device %s' % (dtype, device))
    token_dim = token_embedding.shape[1]
    path_dim = path_embedding.shape[1]
    context_dim, code_dim = transform.shape
    if (context_dim != 2 * token_dim + path_dim or token_dim % 4
            or path_dim % 4):
        raise ValueError('ragged kernel: transform rows %d must be '
                         '2*%d+%d, embedding dims multiples of 4'
                         % (context_dim, token_dim, path_dim))
    if not 16 <= code_dim <= 1024 or attention.numel() != code_dim:
        raise ValueError('ragged kernel: code dim %d outside [16, 1024] or '
                         'attention of %d values'
                         % (code_dim, attention.numel()))
    if dtype == torch.bfloat16 and (code_dim % 32 or context_dim % 16):
        raise ValueError('ragged kernel: the bf16 tensor-core route needs '
                         'code dim %% 32 == 0 and context dim %% 16 == 0, '
                         'got %d and %d' % (code_dim, context_dim))
    shards, cap, _ = segs.ctx.shape
    per_shard = segs.count2.shape[1]
    batch = shards * per_shard
    token_embedding = token_embedding.contiguous()
    path_embedding = path_embedding.contiguous()
    transform = transform.contiguous()
    attention = attention.contiguous()
    ctx = segs.ctx.to(torch.int32).contiguous()
    # CSR row pointer into the flat (shards * cap) stream
    shard_base = (torch.arange(shards, device=device, dtype=torch.int32)
                  * cap)[:, None]
    starts = (segment_starts(segs.count2) + shard_base).reshape(-1)
    starts = starts.to(torch.int32).contiguous()
    counts = segs.count2.reshape(-1).to(torch.int32).contiguous()

    from code2vec_tpu_torch.ops import _build
    lib = _build.load('ragged_fwd')
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ragged_fwd_tile.argtypes = [i32]
    lib.ragged_fwd_tile.restype = i32
    lib.ragged_fwd.argtypes = [i32, ptr, i64, ptr, i64, ptr, ptr, ptr, ptr,
                               ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                               i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.ragged_fwd.restype = i32
    lib.ragged_fwd_error_string.argtypes = [i32]
    lib.ragged_fwd_error_string.restype = ctypes.c_char_p
    # work items: one tile of one example each. item_ex maps an item to
    # its example (the segment_structure arithmetic over item starts);
    # n_items bounds sum(ceil(count / tile)) from the shapes, so nothing
    # waits for the device, and the items past the last do nothing
    tile = lib.ragged_fwd_tile(_DTYPE_CODES[dtype])
    n_chunks = (counts + (tile - 1)) // tile
    item_start = torch.cumsum(n_chunks, 0, dtype=torch.int32) - n_chunks
    n_items = batch + -(-shards * cap // tile)
    item_ex = torch.searchsorted(
        item_start[1:].contiguous(),
        torch.arange(n_items, dtype=torch.int32, device=device),
        right=True, out_int32=True)
    scores = torch.full((shards * cap,), _NEG, dtype=torch.float32,
                        device=device)
    part_m = torch.empty((n_items,), dtype=torch.float32, device=device)
    part_z = torch.empty((n_items,), dtype=torch.float32, device=device)
    part_acc = torch.empty((n_items, code_dim), dtype=torch.float32,
                           device=device)
    m = torch.empty((batch,), dtype=torch.float32, device=device)
    z = torch.empty((batch,), dtype=torch.float32, device=device)
    acc = torch.empty((batch, code_dim), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ragged_fwd(
            _DTYPE_CODES[dtype], token_embedding.data_ptr(),
            token_embedding.shape[0], path_embedding.data_ptr(),
            path_embedding.shape[0], transform.data_ptr(),
            attention.data_ptr(), ctx.data_ptr(), starts.data_ptr(),
            counts.data_ptr(), item_ex.data_ptr(), item_start.data_ptr(),
            batch, n_items, token_dim, path_dim, code_dim, token_pad,
            path_pad, scores.data_ptr(), part_m.data_ptr(),
            part_z.data_ptr(), part_acc.data_ptr(), m.data_ptr(),
            z.data_ptr(), acc.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError('ragged kernel launch failed: %s' % (
            lib.ragged_fwd_error_string(rc).decode(),))
    launches += 1
    return (scores.reshape(shards, cap), m.reshape(shards, per_shard),
            z.reshape(shards, per_shard),
            acc.reshape(shards, per_shard, code_dim))


def _code_from_stats(z: torch.Tensor, acc: torch.Tensor,
                     count2: torch.Tensor, x_pad: torch.Tensor
                     ) -> torch.Tensor:
    """(z, acc) -> (D, Bs, Dc) fp32 code vectors; count == 0 rows take
    ``x_pad``. ``where`` and not ``max`` guards empty segments' 0/0: a
    one-slot segment has z == 1 exactly."""
    nonempty = count2 > 0
    z_safe = torch.where(nonempty, z, 1.0)
    code = acc / z_safe[..., None]
    return torch.where(nonempty[..., None], code, x_pad.float())


def _finish(scores, m, z, acc, segs: SegmentInputs, x_pad: torch.Tensor,
            max_contexts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Statistics -> (code_vectors (B, D) fp32, attention planes (B, C)
    fp32); count == 0 rows get the dense path's uniform 1/C attention."""
    shards, per_shard = segs.count2.shape
    nonempty = segs.count2 > 0
    z_safe = torch.where(nonempty, z, 1.0)
    code = _code_from_stats(z, acc, segs.count2, x_pad)
    valid = segs.slot_valid
    p = torch.exp(scores - torch.gather(m, 1, segs.seg))
    w = torch.where(valid, p / torch.gather(z_safe, 1, segs.seg), 0.0)
    shard_idx = torch.arange(shards, device=scores.device)[:, None]
    # a valid slot has pos < count <= C; the rest add 0 onto element 0
    flat = ((shard_idx * per_shard + segs.seg) * max_contexts
            + segs.pos.long())
    flat = torch.where(valid, flat, 0)
    attn = torch.zeros((shards * per_shard * max_contexts,),
                       dtype=torch.float32, device=scores.device)
    attn = attn.index_add(0, flat.reshape(-1), w.reshape(-1))
    attn = attn.reshape(shards, per_shard, max_contexts)
    attn = torch.where(nonempty[..., None], attn, 1.0 / max_contexts)
    batch = shards * per_shard
    return code.reshape(batch, -1), attn.reshape(batch, max_contexts)


def _pad_forward(token_embedding: torch.Tensor,
                 path_embedding: torch.Tensor, transform: torch.Tensor,
                 token_pad: int, path_pad: int, dtype: torch.dtype
                 ) -> torch.Tensor:
    """x_pad (Dc,): the dense path's value for an all-PAD slot, the
    stand-in for count == 0 rows."""
    pad_ctx = torch.cat([token_embedding[token_pad],
                         path_embedding[path_pad],
                         token_embedding[token_pad]]).to(dtype)
    return torch.tanh(pad_ctx[None, :] @ transform.to(dtype))[0]


def ragged_encode(token_embedding: torch.Tensor,
                  path_embedding: torch.Tensor, transform: torch.Tensor,
                  attention: torch.Tensor, ctx: torch.Tensor,
                  count: torch.Tensor, *, max_contexts: int, token_pad: int,
                  path_pad: int, dtype: torch.dtype = torch.float32,
                  plain: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed wire tensors ``ctx (D, cap, 3)``, ``count (B,)`` ->
    ``(code_vectors (B, D) fp32, attention planes (B, C) fp32)``, with no
    ``(B, C, .)`` intermediate.

    Tables and weights are cast to ``dtype`` (a no-op when the caller
    keeps compute-dtype copies). The statistics go through the kernel
    wrapper, which launches the Hopper kernel for CUDA tensors and runs
    the plain version for CPU tensors; ``plain=True`` asks for the plain
    version on any device, to hold the kernel against it."""
    segs = _segment_inputs(ctx, count, token_pad, path_pad)
    tok = token_embedding.to(dtype)
    path = path_embedding.to(dtype)
    trans = transform.to(dtype)
    attn = attention.to(dtype).reshape(-1)
    stats = _stats_plain if plain else _stats_kernel
    scores, m, z, acc = stats(tok, path, trans, attn, segs, token_pad,
                              path_pad)
    x_pad = _pad_forward(tok, path, trans, token_pad, path_pad, dtype)
    return _finish(scores, m, z, acc, segs, x_pad, max_contexts)
