"""Ragged fused encode + attention straight off the packed wire — the
counterpart of ``code2vec_tpu/ops/pallas_ragged.py``, forward and
recompute backward.

Per slot t of the packed stream (slots past a shard's total and interior
all-PAD holes are masked out):

    e_t = [tok[src_t]; path[pth_t]; tok[tgt_t]]  (dropout applied in training)
    x_t = tanh(e_t W),  s_t = x_t . ATTENTION

per example i (a segment of the stream, delimited by ``count``):

    m_i = max_t s_t,  z_i = sum_t exp(s_t - m_i),
    acc_i = sum_t exp(s_t - m_i) x_t,  code_i = acc_i / z_i

Forward: two versions compute the same ``(scores, m, z, acc)``
statistics, ``_stats_plain`` (plain PyTorch segment ops, what the CPU
runs and what the kernel is held against on the card) and
``_stats_kernel`` (the wrapper of ``csrc/ragged_fwd.cu``). Both keep
``x`` in fp32 for the score and the weighted sum, as the TPU kernel does.
``_finish`` turns the statistics into code vectors and attention planes
with the count == 0 fixups (``code = x_pad``, uniform ``1/C`` attention).

Training (``ragged_encode_code``, a ``torch.autograd.Function``): the
forward saves only its inputs, the per-example ``(m, z)``, the ``(B, D)``
code vectors and the dropout seed; the backward re-gathers the rows,
re-draws the same keep mask from the seed, recomputes the per-slot state
and emits exact softmax-backward gradients: ``_grads_plain`` or
``_grads_kernel`` (``csrc/ragged_bwd.cu``) give the per-slot ``de``, the
dense ``dW`` and ``d_attn``; the PAD-row terms of count == 0 rows are
added here, and the token/path table gradients are scatter-adds over
the packed index stream (``ops/embed_grad.py::table_grad``, by
EMBED_GRAD_IMPL). In bf16 both versions round
``du`` to bf16 before the two products that use it (the TPU's DEFAULT
matmul precision does the same); everything else stays fp32.

Every kernel wrapper runs the plain version for CPU tensors only; for
CUDA tensors it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from code2vec_tpu_torch.data.packed import segment_starts, segment_structure
from code2vec_tpu_torch.ops.embed_grad import table_grad
from code2vec_tpu_torch.models.functional import (apply_keep,
                                                  dropout_keep_mask)
from code2vec_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                              take_row_range)

_NEG = -1e30        # finite -inf stand-in, as in the TPU kernel
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by _stats_kernel (launches), _grads_kernel
# (bwd_launches) and the mesh's gather (gather_launches), the mesh routes'
# included; callers reset and read them to show that a path went through
# the kernels
launches = 0
bwd_launches = 0
gather_launches = 0


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


def _draw_keep(seed: int, segs: SegmentInputs, context_dim: int,
               keep_rate: float) -> torch.Tensor:
    """The (D, cap, 3d) keep mask of the packed layout, drawn from a
    generator seeded with ``seed``: the forward and the backward draw the
    same mask."""
    shards, cap, _ = segs.ctx.shape
    generator = torch.Generator(device=segs.ctx.device)
    generator.manual_seed(seed)
    return dropout_keep_mask(generator, keep_rate,
                             (shards, cap, context_dim), segs.ctx.device)


def _gather(token_embedding: torch.Tensor, path_embedding: torch.Tensor,
            segs: SegmentInputs, dtype: torch.dtype,
            keep: Optional[torch.Tensor], keep_rate: float) -> torch.Tensor:
    """(D, cap, 3d) context rows in ``dtype``, the keep mask applied: the
    reference's take, astype, then ``apply_keep``."""
    ctx = segs.ctx.long()
    e = torch.cat([token_embedding[ctx[..., 0]],
                   path_embedding[ctx[..., 1]],
                   token_embedding[ctx[..., 2]]], dim=-1).to(dtype)
    if keep is not None:
        e = apply_keep(e, keep, keep_rate)
    return e


# ------------------------------------------------------- the mesh's gather
def _shards_tables(mesh) -> bool:
    """The mesh's model axis shards the tables: rows must be gathered
    across its data row."""
    return mesh is not None and mesh.model > 1


def _gather_range_plain(token_embedding: torch.Tensor,
                        path_embedding: torch.Tensor, segs: SegmentInputs,
                        dtype: torch.dtype, keep: Optional[torch.Tensor],
                        keep_rate: float, tok_lo: int, path_lo: int
                        ) -> torch.Tensor:
    """``_gather`` from this rank's table slices (rows from ``tok_lo`` and
    ``path_lo`` of the sharded tables): zero where another rank holds the
    row, so the sum over the model axis is ``_gather``'s stream exactly
    (the cast and the keep mask keep zeros zero)."""
    ctx = segs.ctx.long()
    e = torch.cat([take_row_range(token_embedding, ctx[..., 0], tok_lo),
                   take_row_range(path_embedding, ctx[..., 1], path_lo),
                   take_row_range(token_embedding, ctx[..., 2], tok_lo)],
                  dim=-1).to(dtype)
    if keep is not None:
        e = apply_keep(e, keep, keep_rate)
    return e


def _gather_range_kernel(token_embedding: torch.Tensor,
                         path_embedding: torch.Tensor, segs: SegmentInputs,
                         dtype: torch.dtype, keep: Optional[torch.Tensor],
                         keep_rate: float, tok_lo: int, path_lo: int
                         ) -> torch.Tensor:
    """``_gather_range_plain`` through the gather kernel
    (``csrc/ragged_fwd.cu::ragged_fwd_gather_rows``, every tile, the row
    range applied) into a (D, cap, 3d) bf16 stream; the plain version for
    CPU tensors."""
    device = segs.ctx.device
    if device.type == 'cpu':
        return _gather_range_plain(token_embedding, path_embedding, segs,
                                   dtype, keep, keep_rate, tok_lo, path_lo)
    if device.type != 'cuda':
        raise ValueError('ragged gather kernel: unsupported device %s'
                         % device)
    if dtype != torch.bfloat16:
        raise ValueError('ragged gather kernel: the mesh\'s gather writes '
                         'the bf16 stream (COMPUTE_DTYPE bfloat16 on the '
                         'card), got %s' % dtype)
    global gather_launches
    table_dtype = token_embedding.dtype
    if table_dtype not in (torch.float32, torch.bfloat16) or \
            path_embedding.dtype != table_dtype:
        raise TypeError('ragged gather kernel: tables must both be float32 '
                        'or bfloat16, got %s and %s'
                        % (table_dtype, path_embedding.dtype))
    token_embedding = token_embedding.contiguous()
    path_embedding = path_embedding.contiguous()
    token_dim = token_embedding.shape[1]
    path_dim = path_embedding.shape[1]
    context_dim = 2 * token_dim + path_dim
    shards, cap, _ = segs.ctx.shape
    n_slots = shards * cap
    if keep is not None and (keep.dtype != torch.bool or keep.device != device
                             or keep.shape != (shards, cap, context_dim)):
        raise ValueError('ragged gather kernel: the keep mask must be a '
                         '(D, cap, %d) bool tensor on %s'
                         % (context_dim, device))
    keep_u8 = _keep_bytes(keep)
    ctx = segs.ctx.to(torch.int32).contiguous()
    e = torch.empty((max(n_slots, 1), context_dim), dtype=torch.bfloat16,
                    device=device)
    lib = _fwd_lib()
    with torch.cuda.device(device):
        rc = lib.ragged_fwd_gather_rows(
            0 if table_dtype == torch.float32 else 1,
            token_embedding.data_ptr(), tok_lo, token_embedding.shape[0],
            path_embedding.data_ptr(), path_lo, path_embedding.shape[0],
            token_dim, path_dim, ctx.data_ptr(), n_slots,
            None if keep_u8 is None else keep_u8.data_ptr(), keep_rate,
            e.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError('ragged gather kernel launch failed: %s' % (
            lib.ragged_fwd_error_string(rc).decode(),))
    gather_launches += 1
    return e[:n_slots].reshape(shards, cap, context_dim)


def _gather_mesh(token_embedding: torch.Tensor, path_embedding: torch.Tensor,
                 segs: SegmentInputs, dtype: torch.dtype,
                 keep: Optional[torch.Tensor], keep_rate: float, mesh,
                 plain: bool = False) -> torch.Tensor:
    """The (D, cap, 3d) stream of a data shard on a mesh whose model axis
    shards the tables: each rank gathers the rows it holds (zeros
    elsewhere) and the streams are summed over its data row; every rank
    of the row then holds the whole stream."""
    gather = _gather_range_plain if plain else _gather_range_kernel
    e = gather(token_embedding, path_embedding, segs, dtype, keep, keep_rate,
               mesh.model_index * token_embedding.shape[0],
               mesh.model_index * path_embedding.shape[0])
    return mesh.all_reduce(e, MODEL_AXIS)


def _pad_context_mesh(token_embedding: torch.Tensor,
                      path_embedding: torch.Tensor, token_pad: int,
                      path_pad: int, dtype: torch.dtype, mesh
                      ) -> torch.Tensor:
    """``_pad_context`` on a mesh whose model axis shards the tables."""
    device = token_embedding.device
    tok_lo = mesh.model_index * token_embedding.shape[0]
    path_lo = mesh.model_index * path_embedding.shape[0]
    tpad = torch.tensor([token_pad], device=device)
    ppad = torch.tensor([path_pad], device=device)
    pad_ctx = torch.cat([take_row_range(token_embedding, tpad, tok_lo)[0],
                         take_row_range(path_embedding, ppad, path_lo)[0],
                         take_row_range(token_embedding, tpad, tok_lo)[0]]
                        ).to(dtype)
    return mesh.all_reduce(pad_ctx, MODEL_AXIS)


def _stats_mesh(tok: torch.Tensor, path: torch.Tensor, trans: torch.Tensor,
                attn: torch.Tensor, segs: SegmentInputs,
                keep: Optional[torch.Tensor], keep_rate: float,
                token_pad: int, path_pad: int, dtype: torch.dtype, mesh,
                plain: bool = False):
    """The statistics of a data shard on a mesh whose model axis shards
    the tables (the reference's ``_stats_kernel_path``): the stream of
    ``_gather_mesh``, the tile kernel over it (or the plain version), and
    the all-PAD slot's row gathered the same way. ``trans`` and ``attn``
    (flat) in ``dtype``. -> (scores, m, z, acc, e, pad_ctx, x_pad)."""
    e = _gather_mesh(tok, path, segs, dtype, keep, keep_rate, mesh, plain)
    if plain:
        scores, m, z, acc = _stats_from_e_plain(e, trans, attn, segs)
    else:
        scores, m, z, acc = _stats_kernel(tok, path, trans, attn, segs,
                                          token_pad, path_pad, e=e)
    pad_ctx = _pad_context_mesh(tok, path, token_pad, path_pad, dtype, mesh)
    x_pad = torch.tanh(pad_ctx[None, :] @ trans)[0]
    return scores, m, z, acc, e, pad_ctx, x_pad


def _stats_plain(token_embedding: torch.Tensor,
                 path_embedding: torch.Tensor, transform: torch.Tensor,
                 attention: torch.Tensor, segs: SegmentInputs,
                 token_pad: int, path_pad: int,
                 keep: Optional[torch.Tensor] = None,
                 keep_rate: float = 1.0):
    """Plain PyTorch statistics: ``(scores (D, cap), m (D, Bs), z (D, Bs),
    acc (D, Bs, Dc))``, all fp32. Weights arrive in the compute dtype;
    table rows are rounded to it as they are gathered; products run on
    their fp32 values with fp32 accumulation, as the kernel does.
    ``token_pad``/``path_pad`` are already folded into
    ``segs.slot_valid``."""
    del token_pad, path_pad
    e = _gather(token_embedding, path_embedding, segs, transform.dtype,
                keep, keep_rate)
    return _stats_from_e_plain(e, transform, attention, segs)


def _stats_from_e_plain(e: torch.Tensor, transform: torch.Tensor,
                        attention: torch.Tensor, segs: SegmentInputs):
    """``_stats_plain`` from the gathered (D, cap, 3d) rows in the compute
    dtype (the keep mask applied): a mesh's stream, summed over the model
    axis."""
    shards, cap, _ = segs.ctx.shape
    per_shard = segs.count2.shape[1]
    e = e.float()
    x = torch.tanh(e @ transform.float())                     # (D, cap, Dc)
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


def _check_kernel_args(token_embedding, path_embedding, transform,
                       attention, segs, keep, name: str) -> Tuple[int, int]:
    """Validates what the kernels take; returns (dtype code, table code)."""
    device = segs.ctx.device
    dtype = transform.dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError('%s: weights must be float32 or bfloat16, got %s'
                        % (name, dtype))
    tables = (token_embedding, path_embedding)
    table_dtype = token_embedding.dtype
    if table_dtype not in (torch.float32, dtype) or \
            path_embedding.dtype != table_dtype:
        raise TypeError('%s: tables must both be float32 or %s, got %s and '
                        '%s' % (name, dtype, table_dtype,
                                path_embedding.dtype))
    if attention.dtype != dtype or any(
            t.device != device for t in tables + (transform, attention)):
        raise TypeError('%s: weights must share the dtype %s, and every '
                        'tensor the device %s' % (name, dtype, device))
    if keep is not None and (keep.dtype != torch.bool or keep.device != device
                             or keep.shape != segs.ctx.shape[:2]
                             + (transform.shape[0],)):
        raise ValueError('%s: the keep mask must be a (D, cap, %d) bool '
                         'tensor on %s' % (name, transform.shape[0], device))
    return _DTYPE_CODES[dtype], (0 if table_dtype == torch.float32 else 1)


def _kernel_segments(segs: SegmentInputs, tile: int):
    """The fp32 kernels' view of the segments: int32 triples, the CSR row
    pointer and counts over the flat (shards * cap) stream, and the work
    items (one tile of one example each). item_ex maps an item to its
    example (the segment_structure arithmetic over item starts), n_chunks
    gives each example's items; n_items bounds sum(ceil(count / tile))
    from the shapes, so nothing waits for the device, and the items past
    the last do nothing."""
    device = segs.ctx.device
    shards, cap, _ = segs.ctx.shape
    batch = segs.count2.numel()
    ctx = segs.ctx.to(torch.int32).contiguous()
    shard_base = (torch.arange(shards, device=device, dtype=torch.int32)
                  * cap)[:, None]
    starts = (segment_starts(segs.count2) + shard_base).reshape(-1)
    starts = starts.to(torch.int32).contiguous()
    counts = segs.count2.reshape(-1).to(torch.int32).contiguous()
    n_chunks = ((counts + (tile - 1)) // tile).contiguous()
    item_start = torch.cumsum(n_chunks, 0, dtype=torch.int32) - n_chunks
    n_items = batch + -(-shards * cap // tile)
    item_ex = torch.searchsorted(
        item_start[1:].contiguous(),
        torch.arange(n_items, dtype=torch.int32, device=device),
        right=True, out_int32=True)
    return ctx, starts, counts, item_start, item_ex, n_items, n_chunks


def _keep_bytes(keep: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The bool keep mask as the kernels read it: contiguous uint8."""
    return None if keep is None else keep.contiguous().view(torch.uint8)


_SLOT_TILE = 64      # slots per tile of the bf16 kernels (one wgmma M)
_TMA_ALIGN = 16      # bytes: the bf16 kernels read W and the mask by TMA


class PairMap(NamedTuple):
    """How the bf16 forward cuts the flat (shards * cap) stream: 64-slot
    tiles, a tile spanning examples, and one partial per (tile, example)
    pair, numbered in example order."""
    pair: torch.Tensor         # (N,) int32 each slot's pair, -1 outside
    pair_start: torch.Tensor   # (B,) int32 each example's first pair
    n_pairs: torch.Tensor      # (B,) int32 its pairs (0 for count == 0)
    bound: int                 # batch + n_tiles >= the pairs: scratch rows


def _pair_map(segs: SegmentInputs) -> PairMap:
    """The bf16 forward's pair map: the plain version of its plan kernel
    (``csrc/ragged_fwd.cu::ragged_fwd_plan_kernel``). Example b's segment
    [start_b, start_b + count_b) of the flat stream touches the tiles
    start_b // 64 .. (start_b + count_b - 1) // 64, one pair each; a slot
    in the segment takes the pair of its tile, a slot outside every
    segment (past its shard's total) -1."""
    shards, cap, _ = segs.ctx.shape
    device = segs.ctx.device
    n_slots = shards * cap
    seg, _valid = _kernel_slots(segs)
    counts = segs.count2.reshape(-1).long()
    base = (torch.arange(shards, device=device) * cap)[:, None]
    starts = (segment_starts(segs.count2).long() + base).reshape(-1)
    first = starts // _SLOT_TILE
    last = (starts + counts - 1) // _SLOT_TILE
    n_pairs = torch.where(counts > 0, last - first + 1, 0)
    pair_start = torch.cumsum(n_pairs, 0) - n_pairs
    slot = torch.arange(n_slots, device=device)
    ex = seg.long()
    in_segment = slot < starts[ex] + counts[ex]
    pair = torch.where(in_segment,
                       pair_start[ex] + slot // _SLOT_TILE - first[ex], -1)
    return PairMap(pair.to(torch.int32), pair_start.to(torch.int32),
                   n_pairs.to(torch.int32),
                   counts.numel() + -(-n_slots // _SLOT_TILE))


def _check_fwd_args(token_embedding, path_embedding, transform, attention,
                    segs, keep) -> Tuple[int, int]:
    """Validates what the forward kernels take; returns (dtype code,
    table code)."""
    dtype_code, table_code = _check_kernel_args(
        token_embedding, path_embedding, transform, attention, segs, keep,
        'ragged kernel')
    if dtype_code == 0 and table_code != 0:
        raise TypeError('ragged kernel: fp32 weights need fp32 tables')
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
    if dtype_code == 1:
        if (context_dim % 64 or context_dim > 384 or token_dim % 8
                or path_dim % 8 or code_dim not in (128, 256, 384)):
            raise ValueError('ragged kernel: the bf16 route needs a context '
                             'dim that is a multiple of 64 and at most 384 '
                             '(embedding dims multiples of 8) and a code '
                             'dim of 128, 256 or 384, got %d and %d'
                             % (context_dim, code_dim))
        aligned = [('W', transform), ('the token table', token_embedding),
                   ('the path table', path_embedding)]
        if keep is not None:
            aligned.append(('the keep mask', keep))
        for name, t in aligned:
            if t.data_ptr() % _TMA_ALIGN:
                raise ValueError('ragged kernel: %s must start on a %d-byte '
                                 'boundary (TMA, 16-byte loads), got offset '
                                 '%d'
                                 % (name, _TMA_ALIGN,
                                    t.data_ptr() % _TMA_ALIGN))
    return dtype_code, table_code


def _fwd_lib():
    """The forward kernels' library, its C interface declared."""
    from code2vec_tpu_torch.ops import _build
    lib = _build.load('ragged_fwd')
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ragged_fwd_f32_tile.argtypes = []
    lib.ragged_fwd_f32_tile.restype = i32
    lib.ragged_fwd_slot_tile.argtypes = []
    lib.ragged_fwd_slot_tile.restype = i32
    if lib.ragged_fwd_slot_tile() != _SLOT_TILE:
        raise RuntimeError('ragged kernel: the library\'s slot tile %d is '
                           'not %d' % (lib.ragged_fwd_slot_tile(),
                                       _SLOT_TILE))
    lib.ragged_fwd_f32.argtypes = [ptr, i64, ptr, i64, ptr, ptr, ptr, ptr,
                                   ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                   i32, i32, i32, ptr, ctypes.c_float, ptr,
                                   ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.ragged_fwd_f32.restype = i32
    lib.ragged_fwd_plan.argtypes = [ptr, i32, i32, i32, ptr, ptr, ptr, ptr]
    lib.ragged_fwd_plan.restype = i32
    lib.ragged_fwd_bf16.argtypes = [i32, ptr, i64, ptr, i64, ptr, ptr, ptr,
                                    ptr, i32, i32, i32, i32, i32, i32, i32,
                                    i32, ptr, ctypes.c_float, ptr, i32, i32,
                                    ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                    ptr, ptr, ptr]
    lib.ragged_fwd_bf16.restype = i32
    lib.ragged_fwd_gather_rows.argtypes = [i32, ptr, i64, i64, ptr, i64, i64,
                                           i32, i32, ptr, i64, ptr,
                                           ctypes.c_float, ptr, ptr]
    lib.ragged_fwd_gather_rows.restype = i32
    lib.ragged_fwd_error_string.argtypes = [i32]
    lib.ragged_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _stats_kernel(token_embedding: torch.Tensor,
                  path_embedding: torch.Tensor, transform: torch.Tensor,
                  attention: torch.Tensor, segs: SegmentInputs,
                  token_pad: int, path_pad: int,
                  keep: Optional[torch.Tensor] = None,
                  keep_rate: float = 1.0, e: Optional[torch.Tensor] = None):
    """The statistics through the Hopper kernels (``csrc/ragged_fwd.cu``);
    the plain version for CPU tensors. Same contract as ``_stats_plain``:
    the tables may be fp32 under bf16 weights (rounded as loaded). bf16
    walks the flat stream in 64-slot tiles (``_pair_map``, built on the
    card by the plan kernel); fp32 in one-example work items
    (``_kernel_segments``). ``e`` (a mesh's stream, ``_gather_mesh``)
    gives the gathered rows, keep mask applied: the tile kernel reads it
    and no gather runs (bf16 only on the card)."""
    device = segs.ctx.device
    if device.type == 'cpu':
        if e is not None:
            return _stats_from_e_plain(e, transform, attention, segs)
        return _stats_plain(token_embedding, path_embedding, transform,
                            attention, segs, token_pad, path_pad, keep,
                            keep_rate)
    if device.type != 'cuda':
        raise ValueError('ragged kernel: unsupported device %s' % device)
    if e is not None:
        keep = None       # applied in the stream already
        if transform.dtype != torch.bfloat16:
            raise ValueError('ragged kernel: a given e stream (the mesh) '
                             'runs the bf16 route only')
    global launches
    token_embedding = token_embedding.contiguous()
    path_embedding = path_embedding.contiguous()
    transform = transform.contiguous()
    attention = attention.contiguous()
    keep = None if keep is None else keep.contiguous()
    dtype_code, table_code = _check_fwd_args(
        token_embedding, path_embedding, transform, attention, segs, keep)
    keep_u8 = _keep_bytes(keep)
    token_dim = token_embedding.shape[1]
    path_dim = path_embedding.shape[1]
    code_dim = transform.shape[1]
    shards, cap, _ = segs.ctx.shape
    per_shard = segs.count2.shape[1]
    batch = shards * per_shard
    n_slots = shards * cap
    f32 = dict(dtype=torch.float32, device=device)
    m = torch.empty((batch,), **f32)
    z = torch.empty((batch,), **f32)
    acc = torch.empty((batch, code_dim), **f32)
    lib = _fwd_lib()
    keep_ptr = None if keep_u8 is None else keep_u8.data_ptr()
    tables = (token_embedding.data_ptr(), token_embedding.shape[0],
              path_embedding.data_ptr(), path_embedding.shape[0])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if dtype_code == 0:
            ctx, starts, counts, item_start, item_ex, n_items, n_chunks = \
                _kernel_segments(segs, lib.ragged_fwd_f32_tile())
            scores = torch.full((n_slots,), _NEG, **f32)
            part_m = torch.empty((n_items,), **f32)
            part_z = torch.empty((n_items,), **f32)
            part_acc = torch.empty((n_items, code_dim), **f32)
            rc = lib.ragged_fwd_f32(
                *tables, transform.data_ptr(), attention.data_ptr(),
                ctx.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                item_ex.data_ptr(), item_start.data_ptr(),
                n_chunks.data_ptr(), batch, n_items, token_dim, path_dim,
                code_dim, token_pad, path_pad, keep_ptr, keep_rate,
                scores.data_ptr(), part_m.data_ptr(), part_z.data_ptr(),
                part_acc.data_ptr(), m.data_ptr(), z.data_ptr(),
                acc.data_ptr(), stream)
        else:
            ctx = segs.ctx.to(torch.int32).contiguous()
            count = segs.count2.reshape(-1).to(torch.int32).contiguous()
            sms = torch.cuda.get_device_properties(
                device).multi_processor_count
            n_tiles = -(-n_slots // _SLOT_TILE)
            bound = batch + n_tiles
            i32 = dict(dtype=torch.int32, device=device)
            pair_start = torch.empty((batch,), **i32)
            n_pairs = torch.empty((batch,), **i32)
            pair = torch.empty((n_slots,), **i32)
            # the gathered rows' stream: given (a mesh), or fp32 masters or
            # a mask (bf16 tables without one are gathered inside the tile
            # kernel)
            e_given = e is not None
            if e_given:
                e = e.reshape(n_slots, transform.shape[0]).contiguous()
                if e.dtype != torch.bfloat16 or e.data_ptr() % _TMA_ALIGN:
                    raise ValueError('ragged kernel: a given e stream must '
                                     'be bf16 on a %d-byte boundary'
                                     % _TMA_ALIGN)
            else:
                e_rows = (max(n_slots, 1)
                          if table_code == 0 or keep is not None else 1)
                e = torch.empty((e_rows, transform.shape[0]),
                                dtype=torch.bfloat16, device=device)
            scores = torch.empty((n_slots,), **f32)
            part_m = torch.empty((bound,), **f32)
            part_z = torch.empty((bound,), **f32)
            part_acc = torch.empty((bound, code_dim), **f32)
            rc = lib.ragged_fwd_bf16(
                table_code, *tables, transform.data_ptr(),
                attention.data_ptr(), ctx.data_ptr(), count.data_ptr(),
                shards, per_shard, cap, token_dim, path_dim, code_dim,
                token_pad, path_pad, keep_ptr, keep_rate, e.data_ptr(),
                int(e_given), max(1, min(sms, n_tiles)),
                pair_start.data_ptr(),
                n_pairs.data_ptr(), pair.data_ptr(),
                scores.data_ptr(), part_m.data_ptr(), part_z.data_ptr(),
                part_acc.data_ptr(), m.data_ptr(), z.data_ptr(),
                acc.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError('ragged kernel launch failed: %s' % (
            lib.ragged_fwd_error_string(rc).decode(),))
    launches += 1
    return (scores.reshape(shards, cap), m.reshape(shards, per_shard),
            z.reshape(shards, per_shard),
            acc.reshape(shards, per_shard, code_dim))


def _pair_map_kernel(segs: SegmentInputs) -> PairMap:
    """The bf16 forward's pair map as its plan kernel builds it on the card
    (``_pair_map`` is its plain version), for the checks."""
    shards, cap, _ = segs.ctx.shape
    per_shard = segs.count2.shape[1]
    batch = shards * per_shard
    device = segs.ctx.device
    count = segs.count2.reshape(-1).to(torch.int32).contiguous()
    i32 = dict(dtype=torch.int32, device=device)
    pair_start = torch.empty((batch,), **i32)
    n_pairs = torch.empty((batch,), **i32)
    pair = torch.empty((shards * cap,), **i32)
    lib = _fwd_lib()
    with torch.cuda.device(device):
        rc = lib.ragged_fwd_plan(
            count.data_ptr(), shards, per_shard, cap, pair_start.data_ptr(),
            n_pairs.data_ptr(), pair.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError('ragged plan kernel launch failed: %s' % (
            lib.ragged_fwd_error_string(rc).decode(),))
    return PairMap(pair, pair_start, n_pairs, batch + -(-shards * cap
                                                         // _SLOT_TILE))


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


def _pad_context(token_embedding: torch.Tensor,
                 path_embedding: torch.Tensor, token_pad: int,
                 path_pad: int, dtype: torch.dtype) -> torch.Tensor:
    """pad_ctx (3d,): the all-PAD slot's context row in ``dtype``."""
    return torch.cat([token_embedding[token_pad], path_embedding[path_pad],
                      token_embedding[token_pad]]).to(dtype)


def _pad_forward(token_embedding: torch.Tensor,
                 path_embedding: torch.Tensor, transform: torch.Tensor,
                 token_pad: int, path_pad: int, dtype: torch.dtype
                 ) -> torch.Tensor:
    """x_pad (Dc,): the dense path's value for an all-PAD slot, the
    stand-in for count == 0 rows."""
    pad_ctx = _pad_context(token_embedding, path_embedding, token_pad,
                           path_pad, dtype)
    return torch.tanh(pad_ctx[None, :] @ transform.to(dtype))[0]


def ragged_encode(token_embedding: torch.Tensor,
                  path_embedding: torch.Tensor, transform: torch.Tensor,
                  attention: torch.Tensor, ctx: torch.Tensor,
                  count: torch.Tensor, *, max_contexts: int, token_pad: int,
                  path_pad: int, dtype: torch.dtype = torch.float32,
                  plain: bool = False, mesh=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed wire tensors ``ctx (D, cap, 3)``, ``count (B,)`` ->
    ``(code_vectors (B, D) fp32, attention planes (B, C) fp32)``, with no
    ``(B, C, .)`` intermediate.

    Tables and weights are cast to ``dtype`` (a no-op when the caller
    keeps compute-dtype copies). The statistics go through the kernel
    wrapper, which launches the Hopper kernel for CUDA tensors and runs
    the plain version for CPU tensors; ``plain=True`` asks for the plain
    version on any device, to hold the kernel against it. On a ``mesh``
    (``parallel/mesh.py``) the batch is this rank's data shard; where its
    model axis shards the tables, the rows come from ``_gather_mesh``
    and the tile kernel reads that stream (the route of the reference's
    ``_stats_kernel_path`` over a mesh)."""
    segs = _segment_inputs(ctx, count, token_pad, path_pad)
    tok = token_embedding.to(dtype)
    path = path_embedding.to(dtype)
    trans = transform.to(dtype)
    attn = attention.to(dtype).reshape(-1)
    if _shards_tables(mesh):
        scores, m, z, acc, _e, _pad_ctx, x_pad = _stats_mesh(
            tok, path, trans, attn, segs, None, 1.0, token_pad, path_pad,
            dtype, mesh, plain)
    else:
        stats = _stats_plain if plain else _stats_kernel
        scores, m, z, acc = stats(tok, path, trans, attn, segs, token_pad,
                                  path_pad)
        x_pad = _pad_forward(tok, path, trans, token_pad, path_pad, dtype)
    return _finish(scores, m, z, acc, segs, x_pad, max_contexts)


# ------------------------------------------------- recompute backward
def _grads_plain(token_embedding: torch.Tensor,
                 path_embedding: torch.Tensor, transform: torch.Tensor,
                 attention: torch.Tensor, segs: SegmentInputs,
                 m: torch.Tensor, z: torch.Tensor, gc: torch.Tensor,
                 g2: torch.Tensor, keep: Optional[torch.Tensor] = None,
                 keep_rate: float = 1.0, e: Optional[torch.Tensor] = None):
    """Plain recompute backward — the counterpart of the reference's
    ``_grads_jnp``. ``m, z, gc (D, Bs)`` and ``g2 (D, Bs, Dc)`` fp32;
    weights in the compute dtype. Returns ``(de (D, cap, 3d) f32 with the
    keep mask applied, dW (3d, Dc) f32, d_attn (Dc,) f32)``. The per-slot
    tensors are transients of this function, never saved state. ``e``
    (a mesh's stream) gives the gathered rows instead of the tables."""
    dtype = transform.dtype
    if e is None:
        e = _gather(token_embedding, path_embedding, segs, dtype, keep,
                    keep_rate)
    e = e.float()
    w_mat = transform.float()
    attn = attention.float().reshape(-1)
    x = torch.tanh(e @ w_mat)                                 # (D, cap, Dc)
    scores = x @ attn                                         # (D, cap)
    m_slot = torch.gather(m, 1, segs.seg)
    z_slot = torch.gather(z, 1, segs.seg)
    p = torch.where(segs.slot_valid, torch.exp(scores - m_slot), 0.0)
    w = p / torch.where(z_slot > 0.0, z_slot, 1.0)            # (D, cap)
    code_dim = g2.shape[-1]
    g_slot = torch.gather(g2, 1, segs.seg[..., None].expand(
        -1, -1, code_dim))                                    # (D, cap, Dc)
    gc_slot = torch.gather(gc, 1, segs.seg)
    gdot = (x * g_slot).sum(dim=-1)
    ds = w * (gdot - gc_slot)
    du = (1.0 - x * x) * (w[..., None] * g_slot + ds[..., None] * attn)
    d_attn = torch.einsum('sc,scd->d', ds, x)
    # du in the compute dtype for the two products, like the kernel
    du = du.to(dtype).float()
    context_dim = e.shape[-1]
    d_w = e.reshape(-1, context_dim).T @ du.reshape(-1, code_dim)
    de = du @ w_mat.T
    if keep is not None:
        de = apply_keep(de, keep, keep_rate)
    return de, d_w, d_attn


def _check_grads_args(token_embedding, path_embedding, transform, attention,
                      segs, keep) -> Tuple[int, int]:
    """Validates what the backward kernel takes; returns (dtype code,
    table code)."""
    dtype_code, table_code = _check_kernel_args(
        token_embedding, path_embedding, transform, attention, segs, keep,
        'ragged backward kernel')
    if dtype_code == 0 and table_code != 0:
        raise TypeError('ragged backward kernel: fp32 weights need fp32 '
                        'tables')
    token_dim = token_embedding.shape[1]
    path_dim = path_embedding.shape[1]
    context_dim, code_dim = transform.shape
    if (context_dim != 2 * token_dim + path_dim or token_dim % 4
            or path_dim % 4 or context_dim % 128 or code_dim % 128
            or context_dim > 384 or code_dim > 384):
        raise ValueError('ragged backward kernel: needs context and code '
                         'dims that are multiples of 128 and at most 384 '
                         '(and embedding dims multiples of 4), got %d, %d'
                         % (context_dim, code_dim))
    if dtype_code == 1 and transform.data_ptr() % _TMA_ALIGN:
        raise ValueError('ragged backward kernel: bf16 W must start on a '
                         '%d-byte boundary (TMA), got offset %d'
                         % (_TMA_ALIGN, transform.data_ptr() % _TMA_ALIGN))
    return dtype_code, table_code


def _bwd_plan(n_slots: int, context_dim: int, code_dim: int,
              sms: int) -> dict:
    """How the bf16 backward cuts its work (``csrc/ragged_bwd.cu``): the
    flat stream in ``n_tiles`` tiles of 64 slots (tile t holds slots
    [64 t, min(64 t + 64, n_slots))); the per-slot kernel's ``n_parts``
    persistent CTAs (each writes one d_attn partial); the dW product's
    ``n_splits`` slot ranges of ``chunks_per_split`` tiles, each range
    cut into ``2 * context_dim / 128`` units. ``scratch``: the shapes of
    the e stream (bf16), the tiles' live flags, and the fp32 partials of
    d_attn and dW."""
    n_tiles = -(-n_slots // _SLOT_TILE)
    per_split = 2 * (context_dim // 128)
    n_splits = max(1, min(n_tiles, sms // per_split))
    chunks = max(1, -(-n_tiles // n_splits))
    n_splits = max(1, -(-n_tiles // chunks))
    n_parts = max(1, min(n_tiles, sms))
    return {'tile': _SLOT_TILE, 'n_tiles': n_tiles, 'n_parts': n_parts,
            'n_splits': n_splits, 'chunks_per_split': chunks,
            'dw_units': n_splits * per_split,
            'scratch': {'e': (max(n_slots, 1), context_dim),
                        'du': (max(n_slots, 1), code_dim),
                        'live': (max(n_tiles, 1),),
                        'part_dattn': (n_parts, code_dim),
                        'part_dw': (n_splits, context_dim, code_dim)}}


def _kernel_slots(segs: SegmentInputs) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 backward's view of the stream: each slot's example as an
    int32 index into the flat (shards * per-shard) batch, and the slot's
    validity as uint8."""
    shards, per_shard = segs.count2.shape
    base = (torch.arange(shards, device=segs.seg.device)
            * per_shard)[:, None]
    seg = (segs.seg + base).reshape(-1).to(torch.int32).contiguous()
    valid = segs.slot_valid.reshape(-1).contiguous().view(torch.uint8)
    return seg, valid


def _grads_kernel(token_embedding: torch.Tensor,
                  path_embedding: torch.Tensor, transform: torch.Tensor,
                  attention: torch.Tensor, segs: SegmentInputs,
                  m: torch.Tensor, z: torch.Tensor, gc: torch.Tensor,
                  g2: torch.Tensor, keep: Optional[torch.Tensor] = None,
                  keep_rate: float = 1.0, *, token_pad: int, path_pad: int,
                  e: Optional[torch.Tensor] = None):
    """The recompute backward through the Hopper kernel
    (``csrc/ragged_bwd.cu``); the plain version for CPU tensors. Same
    contract as ``_grads_plain``. bf16 walks the flat stream in 64-slot
    tiles (``_bwd_plan``, each slot's example from ``_kernel_slots``) and
    writes every row of ``de``; fp32 walks the forward's one-tile work
    items and needs ``de`` zeroed first. ``e`` (a mesh's stream) is read
    instead of a gather (bf16 only on the card)."""
    if segs.ctx.device.type == 'cpu':
        return _grads_plain(token_embedding, path_embedding, transform,
                            attention, segs, m, z, gc, g2, keep, keep_rate,
                            e=e)
    return _grads_kernel_du(token_embedding, path_embedding, transform,
                            attention, segs, m, z, gc, g2, keep, keep_rate,
                            token_pad=token_pad, path_pad=path_pad, e=e)[:3]


def _grads_kernel_du(token_embedding: torch.Tensor,
                     path_embedding: torch.Tensor, transform: torch.Tensor,
                     attention: torch.Tensor, segs: SegmentInputs,
                     m: torch.Tensor, z: torch.Tensor, gc: torch.Tensor,
                     g2: torch.Tensor, keep: Optional[torch.Tensor] = None,
                     keep_rate: float = 1.0, *, token_pad: int,
                     path_pad: int, e: Optional[torch.Tensor] = None):
    """``_grads_kernel`` on CUDA tensors, with the kernel's own du stream
    ((D, cap, Dc) in the compute dtype, zero on invalid slots) after the
    three gradients: the checks hold de and dW against du W^T and e^T du
    computed from it in float64."""
    device = segs.ctx.device
    if device.type != 'cuda':
        raise ValueError('ragged backward kernel: unsupported device %s'
                         % device)
    if e is not None and transform.dtype != torch.bfloat16:
        raise ValueError('ragged backward kernel: a given e stream (the '
                         'mesh) runs the bf16 route only')
    global bwd_launches
    transform = transform.contiguous()
    dtype_code, table_code = _check_grads_args(
        token_embedding, path_embedding, transform, attention, segs, keep)
    token_dim = token_embedding.shape[1]
    path_dim = path_embedding.shape[1]
    context_dim, code_dim = transform.shape
    shards, cap, _ = segs.ctx.shape
    n_slots = shards * cap
    token_embedding = token_embedding.contiguous()
    path_embedding = path_embedding.contiguous()
    attention = attention.contiguous()
    m = m.reshape(-1).float().contiguous()
    z = z.reshape(-1).float().contiguous()
    gc = gc.reshape(-1).float().contiguous()
    g = g2.reshape(-1, code_dim).float().contiguous()

    from code2vec_tpu_torch.ops import _build
    lib = _build.load('ragged_bwd')
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ragged_bwd_tile.argtypes = []
    lib.ragged_bwd_tile.restype = i32
    lib.ragged_bwd_slot_tile.argtypes = []
    lib.ragged_bwd_slot_tile.restype = i32
    if lib.ragged_bwd_slot_tile() != _SLOT_TILE:
        raise RuntimeError('ragged backward kernel: the library\'s slot '
                           'tile %d is not %d'
                           % (lib.ragged_bwd_slot_tile(), _SLOT_TILE))
    lib.ragged_bwd.argtypes = [i32, i32, ptr, i64, ptr, i64, ptr, ptr, ptr,
                               ptr, ptr, ptr, ptr, ptr, ptr, i64, i32, i32,
                               i32, i32, i32, ptr, ctypes.c_float, ptr, ptr,
                               ptr, ptr, ptr, ptr, ptr, i32, ptr, ptr, i32,
                               i32, i32, ptr, ptr, ptr, ptr]
    lib.ragged_bwd.restype = i32
    lib.ragged_bwd_error_string.argtypes = [i32]
    lib.ragged_bwd_error_string.restype = ctypes.c_char_p
    keep_u8 = _keep_bytes(keep)
    if dtype_code == 1 and keep_u8 is not None and \
            keep_u8.data_ptr() % _TMA_ALIGN:
        raise ValueError('ragged backward kernel: the keep mask must start '
                         'on a %d-byte boundary (TMA)' % _TMA_ALIGN)
    f32 = dict(dtype=torch.float32, device=device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    d_w = torch.empty((context_dim, code_dim), **f32)
    d_attn = torch.empty((code_dim,), **f32)
    if dtype_code == 0:
        # fp32 route: one-tile work items of each example, du and de
        # zero on entry (slots outside every item are not written)
        tile = lib.ragged_bwd_tile()
        ctx, starts, counts, item_start, item_ex, n_parts, _n = \
            _kernel_segments(segs, tile)
        # slot ranges of the dW product: about four CTAs per SM over the
        # (3d / 64) x (Dc / 128) output tiles
        tiles = (context_dim // 64) * (code_dim // 128)
        n_splits = max(1, min(-(-n_slots // tile), -(-4 * sms // tiles)))
        chunks = 0
        du = torch.zeros((n_slots, code_dim), dtype=transform.dtype,
                         device=device)
        de = torch.zeros((n_slots, context_dim), **f32)
        seg = valid = e = live = None
        e_given = 0
        part_dattn = torch.empty((n_parts, code_dim), **f32)
        part_dw = torch.empty((n_splits, context_dim, code_dim), **f32)
        items = tuple(t.data_ptr() for t in (starts, counts, item_ex,
                                             item_start))
    else:
        # bf16 route: 64-slot tiles; every row of du and de is written
        ctx = segs.ctx.to(torch.int32).contiguous()
        seg, valid = _kernel_slots(segs)
        plan = _bwd_plan(n_slots, context_dim, code_dim, sms)
        n_parts, n_splits = plan['n_parts'], plan['n_splits']
        chunks = plan['chunks_per_split']
        scratch = plan['scratch']
        bf16 = dict(dtype=torch.bfloat16, device=device)
        du = torch.empty(scratch['du'], **bf16)
        de = torch.empty((n_slots, context_dim), **f32)
        if e is None:
            e = torch.empty(scratch['e'], **bf16)
            e_given = 0
        else:
            e = e.reshape(-1, context_dim).contiguous()
            if e.dtype != torch.bfloat16 or e.data_ptr() % _TMA_ALIGN:
                raise ValueError('ragged backward kernel: a given e stream '
                                 'must be bf16 on a %d-byte boundary'
                                 % _TMA_ALIGN)
            e_given = 1
        live = torch.empty(scratch['live'], dtype=torch.int32, device=device)
        part_dattn = torch.empty(scratch['part_dattn'], **f32)
        part_dw = torch.empty(scratch['part_dw'], **f32)
        items = (None,) * 4
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ragged_bwd(
            dtype_code, table_code, token_embedding.data_ptr(),
            token_embedding.shape[0], path_embedding.data_ptr(),
            path_embedding.shape[0], transform.data_ptr(),
            attention.data_ptr(), ctx.data_ptr(), *items,
            None if seg is None else seg.data_ptr(),
            None if valid is None else valid.data_ptr(), n_slots, token_dim,
            path_dim, code_dim, token_pad, path_pad,
            None if keep_u8 is None else keep_u8.data_ptr(), keep_rate,
            m.data_ptr(), z.data_ptr(), gc.data_ptr(), g.data_ptr(),
            du.data_ptr(), de.data_ptr(),
            None if e is None else e.data_ptr(), e_given,
            None if live is None else live.data_ptr(),
            part_dattn.data_ptr(), n_parts, n_splits, chunks,
            part_dw.data_ptr(), d_w.data_ptr(), d_attn.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError('ragged backward kernel launch failed: %s' % (
            lib.ragged_bwd_error_string(rc).decode(),))
    bwd_launches += 1
    return (de.reshape(shards, cap, context_dim), d_w, d_attn,
            du[:n_slots].reshape(shards, cap, code_dim))


class _Options(NamedTuple):
    token_pad: int
    path_pad: int
    dtype: torch.dtype
    keep_rate: float
    seed: Optional[int]      # dropout seed; None: no dropout or a given mask
    embed_grad_impl: str = 'dense'   # ops/embed_grad.py, EMBED_GRAD_IMPL
    mesh: object = None      # parallel/mesh.py: the batch is a data shard


def _forward_code(tok, path, trans, attn, segs, keep, opts: _Options):
    """The training forward: (code (B, Dc) fp32, m, z (D, Bs), and on a
    mesh whose model axis shards the tables the summed e stream and the
    pad context, else None, None)."""
    w_c = trans.to(opts.dtype)
    a_c = attn.to(opts.dtype).reshape(-1)
    e = pad_ctx = None
    if _shards_tables(opts.mesh):
        _scores, m, z, acc, e, pad_ctx, x_pad = _stats_mesh(
            tok, path, w_c, a_c, segs, keep, opts.keep_rate, opts.token_pad,
            opts.path_pad, opts.dtype, opts.mesh)
    else:
        _scores, m, z, acc = _stats_kernel(
            tok, path, w_c, a_c, segs, opts.token_pad, opts.path_pad, keep,
            opts.keep_rate)
        x_pad = _pad_forward(tok, path, trans, opts.token_pad,
                             opts.path_pad, opts.dtype)
    code = _code_from_stats(z, acc, segs.count2, x_pad)
    return code.reshape(segs.count2.numel(), -1), m, z, e, pad_ctx


class _EncodeCode(torch.autograd.Function):
    """Code vectors with a recompute backward: the forward saves its
    inputs, ``(m, z)``, the code vectors and the dropout seed — no
    per-slot tensor, except on a mesh whose model axis shards the tables,
    where the gathered stream (already summed over the data row) is kept
    for the backward instead of being gathered and summed again.

    On a mesh (``opts.mesh``) the batch is this rank's data shard: the
    backward scatters only the table rows the rank holds and sums the
    four gradients over its model column (the reference's
    ``_grads_kernel_path``: dW and d_attn summed over the data axis)."""

    @staticmethod
    def forward(ctx, tok, path, trans, attn, wire_ctx, count, keep_mask,
                opts: _Options):
        segs = _segment_inputs(wire_ctx, count, opts.token_pad,
                               opts.path_pad)
        keep = keep_mask
        if keep is None and opts.seed is not None:
            keep = _draw_keep(opts.seed, segs, trans.shape[0],
                              opts.keep_rate)
        code, m, z, e, pad_ctx = _forward_code(tok, path, trans, attn, segs,
                                               keep, opts)
        saved = [tok, path, trans, attn, wire_ctx, count, m, z, code]
        if e is not None:
            saved += [e, pad_ctx]
        if keep_mask is not None:
            saved.append(keep_mask)
        ctx.save_for_backward(*saved)
        ctx.opts = opts
        return code

    @staticmethod
    def backward(ctx, g):
        opts = ctx.opts
        mesh = opts.mesh
        sharded = _shards_tables(mesh)
        (tok, path, trans, attn, wire_ctx, count, m, z, code,
         *rest) = ctx.saved_tensors
        e = pad_ctx = None
        if sharded:
            e, pad_ctx, *rest = rest
        segs = _segment_inputs(wire_ctx, count, opts.token_pad,
                               opts.path_pad)
        context_dim = trans.shape[0]
        keep = rest[0] if rest else None
        if keep is None and opts.seed is not None:
            keep = _draw_keep(opts.seed, segs, context_dim, opts.keep_rate)
        shards, per_shard = segs.count2.shape
        g2 = g.float().reshape(shards, per_shard, -1)
        gc = (g2 * code.reshape(shards, per_shard, -1)).sum(dim=-1)
        w_c = trans.to(opts.dtype)
        a_c = attn.to(opts.dtype).reshape(-1)
        de, d_w, d_attn = _grads_kernel(
            tok, path, w_c, a_c, segs, m, z, gc, g2, keep, opts.keep_rate,
            token_pad=opts.token_pad, path_pad=opts.path_pad, e=e)
        # count == 0 rows took code = x_pad = tanh(pad_ctx W): route their
        # cotangent through that expression (zero in training, where such
        # rows carry weight 0, but exact for any caller)
        nonempty = segs.count2 > 0
        g_empty = torch.where(nonempty[..., None], 0.0, g2).sum(dim=(0, 1))
        if pad_ctx is None:
            pad_ctx = _pad_context(tok, path, opts.token_pad, opts.path_pad,
                                   opts.dtype)
        x_pad = torch.tanh(pad_ctx[None, :] @ w_c)[0].float()
        du_pad = (1.0 - x_pad * x_pad) * g_empty
        d_trans = d_w + pad_ctx.float()[:, None] * du_pad[None, :]
        de_pad = trans.float() @ du_pad                      # (3d,)
        # table gradients: scatter-adds over the packed index stream, by
        # the EMBED_GRAD_IMPL strategy (ops/embed_grad.py), the token
        # table's source and target rows in one stream as the reference's
        token_dim = tok.shape[1]
        path_dim = path.shape[1]
        idx = wire_ctx.reshape(-1, 3).long()
        de = de.reshape(-1, context_dim)
        # on a mesh whose model axis shards the tables: this rank's rows
        tok_lo = path_lo = 0
        tok_range = path_range = None
        if sharded:
            tok_lo = mesh.model_index * tok.shape[0]
            path_lo = mesh.model_index * path.shape[0]
            tok_range = (tok_lo, tok_lo + tok.shape[0])
            path_range = (path_lo, path_lo + path.shape[0])
        d_tok = table_grad(
            torch.cat([de[:, :token_dim], de[:, token_dim + path_dim:]]),
            torch.cat([idx[:, 0], idx[:, 2]]), tok.shape[0], tok.dtype,
            opts.embed_grad_impl, row_range=tok_range)
        if 0 <= opts.token_pad - tok_lo < tok.shape[0]:
            d_tok[opts.token_pad - tok_lo] += (
                de_pad[:token_dim] + de_pad[token_dim + path_dim:]
            ).to(tok.dtype)
        d_path = table_grad(de[:, token_dim:token_dim + path_dim],
                            idx[:, 1], path.shape[0], path.dtype,
                            opts.embed_grad_impl, row_range=path_range)
        if 0 <= opts.path_pad - path_lo < path.shape[0]:
            d_path[opts.path_pad - path_lo] += \
                de_pad[token_dim:token_dim + path_dim].to(path.dtype)
        d_attn = d_attn.reshape(attn.shape)
        if mesh is not None:
            # each rank's parts saw its data shard only: summed over the
            # model column (dW and d_attn in fp32, before the cast)
            for part in (d_tok, d_path, d_trans, d_attn):
                mesh.all_reduce(part, DATA_AXIS)
        return (d_tok, d_path, d_trans.to(trans.dtype),
                d_attn.to(attn.dtype), None, None, None, None)


def ragged_encode_code(token_embedding: torch.Tensor,
                       path_embedding: torch.Tensor, transform: torch.Tensor,
                       attention: torch.Tensor, ctx: torch.Tensor,
                       count: torch.Tensor, *, token_pad: int, path_pad: int,
                       dtype: torch.dtype = torch.float32,
                       keep_rate: float = 1.0,
                       dropout_seed: Optional[int] = None,
                       keep_mask: Optional[torch.Tensor] = None,
                       embed_grad_impl: str = 'dense',
                       mesh=None) -> torch.Tensor:
    """The training encode: packed wire tensors -> code vectors ``(B, D)``
    fp32, differentiable in the four encoder weights through a recompute
    backward (module docstring).

    Dropout applies when ``keep_rate < 1`` and either ``dropout_seed``
    (the mask is drawn over the packed ``(D, cap, 3d)`` layout from a
    generator seeded with it, in the forward and again in the backward)
    or an explicit bool ``keep_mask`` of that shape is given. The tables
    stay in their own dtype (fp32 masters, or bf16 copies under
    GRADS_DTYPE='bfloat16'): rows are rounded to ``dtype`` as they are
    gathered, and the table gradients come back in the tables' dtype,
    accumulated by ``embed_grad_impl`` (``ops/embed_grad.py``). Both
    passes go through the kernel wrappers (plain versions for CPU
    tensors).

    On a ``mesh`` (``parallel/mesh.py``) the packed batch is this rank's
    data shard and the tables its row slices where the model axis shards
    them: the rows come from ``_gather_mesh``, and the gradients come
    back summed over the model column, the tables' for the rank's rows
    (``_EncodeCode``)."""
    apply_dropout = keep_rate < 1.0 and (dropout_seed is not None
                                         or keep_mask is not None)
    opts = _Options(token_pad, path_pad, dtype, float(keep_rate),
                    dropout_seed if apply_dropout and keep_mask is None
                    else None, embed_grad_impl, mesh)
    return _EncodeCode.apply(token_embedding, path_embedding, transform,
                             attention, ctx, count,
                             keep_mask if apply_dropout else None, opts)
