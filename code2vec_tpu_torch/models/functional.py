"""The code2vec model math as plain tensor functions — the counterpart of
``code2vec_tpu/models/functional.py``.

    ctx   = concat(tok[source], path[path], tok[target])      (B, C, 3d)
    x     = tanh(ctx @ TRANSFORM)                             (B, C, D)
    score = x @ ATTENTION + log(mask)                         (B, C)
    attn  = softmax(score, axis=contexts)
    code  = sum(attn * x, axis=contexts)                      (B, D)
    logit = code @ TARGET_EMB.T                               (B, Vy)

The packed wire encodes through the ragged kernels (``ops/ragged.py``);
the dense ``encode`` here is the plane wire's forward (and the packed
wire's with the ragged fusion off), through the fused context-transform
kernel under ``use_pallas``. The training losses are weighted mean
cross-entropy through materialized logits or the streamed kernels
(``ops/ce.py``): ``loss_and_aux_packed`` off the ragged encode,
``loss_and_aux`` off the dense one (autograd through it, dropout on the
gathered contexts as the reference applies it).

Every function that takes ``mesh`` (``parallel/mesh.py``) runs on this
rank's data shard with its row slices of the tables where the model axis
shards them: the gathers bring the other ranks' rows (``_TakeRows``),
the logits are the rank's V/M columns (``compute_logits`` with
``mesh``), the CE merges over the data row (``sharded_weighted_ce_sums``
or the streamed kernels' sharded route), and every gradient comes back
summed over the model column. The loss is the global CE sum over the
global weight sum, so the summed gradients are the global loss's, as
the reference's GSPMD program computes them (a mean over ranks would
differ wherever the shards' weight sums differ).

SHARD_CONTEXTS (``shard_contexts``, on a mesh whose model axis is more
than one rank) splits the dense encode's contexts over the model axis,
as the reference's ``batch_spec(2, shard_contexts=True)`` places the
(B, C) planes: rank (d, m) gathers the rows it holds for every context
of its data shard, and a reduce-scatter over its data row leaves it the
rows of its contexts [m C / M, (m + 1) C / M); it runs the transform and
the scores (the fused kernel in eval) on that slice alone; the softmax
is merged over the data row (the max by an all_reduce MAX, detached:
the softmax does not depend on it; the normalizer and the weighted sum
summed, differentiable); the backward all-gathers the gathered rows'
gradient over the data row before the table gradient, and sums the
dense weights' gradients over the whole mesh. The keep mask is drawn
whole and sliced, so a sharded step equals the unsharded one. The
packed wire's stream is never split (the reference never splits the 3-D
packed buffer, its ``batch_spec``): the ragged routes ignore the knob,
and the packed wire unpacked on the card reaches the dense encode as
planes.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from code2vec_tpu_torch.ops.embed_grad import table_grad

# floor of the additive log-mask: fully masked rows stay finite, and an
# invalid context gets attention ~e-30 (zero at fp32 resolution)
_MASK_MIN = 1e-30


class Code2VecParams(NamedTuple):
    """The five weight tensors; ``attention`` keeps the (D, 1) shape."""
    token_embedding: torch.Tensor    # (Vt, d_tok)
    path_embedding: torch.Tensor     # (Vp, d_path)
    target_embedding: torch.Tensor   # (Vy, D)
    transform: torch.Tensor          # (2*d_tok+d_path, D)
    attention: torch.Tensor          # (D, 1)


def _uniform(shape, limit: float, generator: torch.Generator,
             device: torch.device) -> torch.Tensor:
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return out.uniform_(-limit, limit, generator=generator)


def init_params(generator: torch.Generator, *, token_vocab_size: int,
                path_vocab_size: int, target_vocab_size: int,
                token_dim: int, path_dim: int, code_dim: int,
                device: torch.device) -> Code2VecParams:
    """The reference's distributions: embeddings variance_scaling(1.0,
    fan_out, uniform), i.e. U(+-sqrt(3 / dim)); TRANSFORM and ATTENTION
    glorot_uniform, U(+-sqrt(6 / (fan_in + fan_out))). The numbers differ
    from JAX's for the same seed; tests feed both packages one set of
    weights through ``convert.py``."""
    context_dim = 2 * token_dim + path_dim
    return Code2VecParams(
        token_embedding=_uniform((token_vocab_size, token_dim),
                                 math.sqrt(3.0 / token_dim), generator,
                                 device),
        path_embedding=_uniform((path_vocab_size, path_dim),
                                math.sqrt(3.0 / path_dim), generator, device),
        target_embedding=_uniform((target_vocab_size, code_dim),
                                  math.sqrt(3.0 / code_dim), generator,
                                  device),
        transform=_uniform((context_dim, code_dim),
                           math.sqrt(6.0 / (context_dim + code_dim)),
                           generator, device),
        attention=_uniform((code_dim, 1), math.sqrt(6.0 / (code_dim + 1)),
                           generator, device))


def dropout_keep_mask(generator: torch.Generator, keep_rate: float, shape,
                      device: torch.device) -> torch.Tensor:
    """Bernoulli(keep_rate) keep mask for inverted dropout, drawn from
    ``generator`` (the reference draws from a jax key: same keep
    probability, another stream)."""
    return torch.rand(shape, generator=generator, device=device) < keep_rate


def round_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` as a ``dtype`` scalar holds it (fp32, or bf16 rounded to
    nearest even), computed on the host without a tensor."""
    bits = int(np.array(value, dtype=np.float32).view(np.uint32))
    if dtype == torch.bfloat16:
        bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    return float(np.array(bits, dtype=np.uint32).view(np.float32))


def apply_keep(e: torch.Tensor, keep: torch.Tensor,
               keep_rate: float) -> torch.Tensor:
    """Inverted dropout: kept values divided by the keep rate (as a scalar
    of ``e``'s dtype, as the reference's weakly typed scalar), dropped
    ones zero."""
    return torch.where(keep, e / round_scalar(keep_rate, e.dtype), 0.0)


class _TakeRows(torch.autograd.Function):
    """``table[idx]``, whose backward accumulates the table gradient by
    EMBED_GRAD_IMPL (``ops/embed_grad.py``), as the reference's
    ``take_rows``: the gradient comes back in the table's dtype.

    On a mesh ``table`` is this rank's slice: where the model axis shards
    the tables, each rank takes the rows it holds (zeros elsewhere) and
    the rows are summed over the data row; the backward scatters only the
    rank's rows; the table gradient is summed over the model column.
    ``context_sharded`` (SHARD_CONTEXTS; ``idx`` (N, C)): the sum is a
    reduce-scatter along the contexts, leaving the rank its C/M, and the
    backward first all-gathers the slices' gradient over the data row, so
    that each rank's rows take every context's contribution."""

    @staticmethod
    def forward(ctx, table, idx, impl: str, mesh=None,
                context_sharded: bool = False):
        ctx.save_for_backward(idx)
        ctx.rows, ctx.impl, ctx.mesh = table.shape[0], impl, mesh
        ctx.table_dtype = table.dtype
        ctx.context_sharded = False
        if mesh is None or mesh.model == 1:
            return table[idx.long()]
        from code2vec_tpu_torch.parallel.mesh import (MODEL_AXIS,
                                                      take_row_range)
        rows = take_row_range(table, idx.long(),
                              mesh.model_index * table.shape[0])
        if context_sharded:
            ctx.context_sharded = True
            return mesh.reduce_scatter(rows, MODEL_AXIS, dim=1).contiguous()
        return mesh.all_reduce(rows, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        mesh = ctx.mesh
        row_range = None
        if mesh is not None and mesh.model > 1:
            from code2vec_tpu_torch.parallel.mesh import MODEL_AXIS
            lo = mesh.model_index * ctx.rows
            row_range = (lo, lo + ctx.rows)
            if ctx.context_sharded:
                g = mesh.gather_rows(g, MODEL_AXIS, dim=1)
        grad = table_grad(g, idx, ctx.rows, ctx.table_dtype, ctx.impl,
                          row_range=row_range)
        if mesh is not None:
            from code2vec_tpu_torch.parallel.mesh import DATA_AXIS
            mesh.all_reduce(grad, DATA_AXIS)
        return grad, None, None, None, None


def encode(params: Code2VecParams, source: torch.Tensor, path: torch.Tensor,
           target: torch.Tensor, mask: torch.Tensor, *,
           dtype: torch.dtype = torch.float32, use_pallas: bool = False,
           keep_mask: Optional[torch.Tensor] = None, keep_rate: float = 1.0,
           embed_grad_impl: str = 'dense', mesh=None,
           shard_contexts: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense bag-of-contexts encode -> (code_vectors (B, D) fp32,
    attention (B, C) fp32). ``dtype`` is the product dtype; the softmax
    runs in fp32. Differentiable in the weights: the table gradients are
    accumulated by ``embed_grad_impl``.

    ``keep_mask`` (bool, (B, C, 3d)) applies inverted dropout at
    ``keep_rate`` to the gathered contexts, where the reference applies
    it; it excludes ``use_pallas``, as the reference takes its kernel
    route only without dropout.

    ``use_pallas`` routes the transform and the scores through the fused
    context-transform kernel wrapper (``ops/encode.py``; its plain version
    on CPU tensors), whose ``x`` is fp32 also in bf16: the weighted sum
    then takes the fp32 branch, as the reference's kernel route does.
    Otherwise ``x`` is in ``dtype`` and, in bf16, so are the weights of
    the weighted sum. ``mesh`` and ``shard_contexts``: the module
    docstring (the attention comes back whole, gathered over the data
    row)."""
    if use_pallas and keep_mask is not None:
        raise ValueError('the fused context-transform kernel takes no '
                         'dropout: pass keep_mask or use_pallas, not both')
    sharded = shard_contexts and mesh is not None and mesh.model > 1
    if mesh is not None:
        from code2vec_tpu_torch.parallel.mesh import DATA_AXIS, grad_sum
        # under SHARD_CONTEXTS each rank's uses saw its contexts only
        axis = None if sharded else DATA_AXIS
        params = params._replace(
            transform=grad_sum(params.transform, mesh, axis),
            attention=grad_sum(params.attention, mesh, axis))
    if sharded:
        mine = mesh.context_slice(source.shape[1])
        mask = mask[:, mine]
        if keep_mask is not None:
            keep_mask = keep_mask[:, mine]
    # source and target rows in one gather: one token-table gradient
    token_embed = _TakeRows.apply(params.token_embedding,
                                  torch.cat([source, target]),
                                  embed_grad_impl, mesh, sharded).to(dtype)
    source_embed, target_embed = token_embed.split(source.shape[0])
    path_embed = _TakeRows.apply(params.path_embedding, path,
                                 embed_grad_impl, mesh, sharded).to(dtype)
    if use_pallas:
        from code2vec_tpu_torch.ops.encode import fused_context_transform
        batch, contexts = mask.shape
        x_flat, scores_flat = fused_context_transform(
            source_embed.reshape(batch * contexts, -1),
            path_embed.reshape(batch * contexts, -1),
            target_embed.reshape(batch * contexts, -1),
            params.transform.to(dtype), params.attention.to(dtype))
        x = x_flat.reshape(batch, contexts, -1)
        scores = scores_flat.reshape(batch, contexts)
    else:
        context_embed = torch.cat([source_embed, path_embed, target_embed],
                                  dim=-1)
        if keep_mask is not None:
            context_embed = apply_keep(context_embed, keep_mask, keep_rate)
        x = torch.tanh(context_embed @ params.transform.to(dtype))  # (B, C, D)
        scores = (x @ params.attention.to(dtype))[..., 0]
    scores = scores.float() + torch.log(
        torch.clamp(mask.float(), min=_MASK_MIN))
    if sharded:
        return _merged_attention(scores, x, mesh)
    attention_weights = torch.softmax(scores, dim=1)              # (B, C)
    code_vectors = torch.einsum(
        'bc,bcd->bd', attention_weights.to(x.dtype).float(), x.float())
    return code_vectors, attention_weights


def _merged_attention(scores: torch.Tensor, x: torch.Tensor, mesh
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The softmax and the weighted sum of a rank's context slice, merged
    over its data row (SHARD_CONTEXTS): m = the all_reduce MAX of the
    slices' maxima, detached; z = the sum of exp(s - m) over the row,
    whose gradient is summed over it (each rank's weights use z); the
    weights exp(s - m) / z rounded to x's dtype as the unsharded route
    rounds them; the code the sum of the slices' weighted sums (its
    gradient arrives whole on every rank). A slice of padding alone has
    its maximum at the floored log-mask and adds ~0."""
    import torch.distributed as dist

    from code2vec_tpu_torch.parallel.mesh import (MODEL_AXIS, forward_sum,
                                                  grad_sum)
    top = mesh.all_reduce(scores.detach().amax(dim=1, keepdim=True),
                          MODEL_AXIS, op=dist.ReduceOp.MAX)
    p = torch.exp(scores - top)
    z = grad_sum(forward_sum(p.sum(dim=1, keepdim=True), mesh, MODEL_AXIS),
                 mesh, MODEL_AXIS)
    weights = p / z                                               # (B, C/M)
    code_vectors = forward_sum(torch.einsum(
        'bc,bcd->bd', weights.to(x.dtype).float(), x.float()), mesh,
        MODEL_AXIS)
    return code_vectors, mesh.gather_rows(weights, MODEL_AXIS, dim=1)


def compute_logits(target_embedding: torch.Tensor,
                   code_vectors: torch.Tensor,
                   dtype: torch.dtype = torch.float32,
                   num_valid_targets: Optional[int] = None,
                   mesh=None) -> torch.Tensor:
    """code vectors -> target-vocab logits, fp32 out. Columns past
    ``num_valid_targets`` (row padding of the table) are set to -1e9 so
    they drop out of the softmax and top-k. On a ``mesh`` the table is
    this rank's V/M rows and the logits its columns (global column
    indices from m V / M): the code vectors' gradient is summed over the
    data row, the table's over the model column."""
    if mesh is not None:
        from code2vec_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                      grad_sum)
        code_vectors = grad_sum(code_vectors, mesh, MODEL_AXIS)
        target_embedding = grad_sum(target_embedding, mesh, DATA_AXIS)
        if num_valid_targets is not None:
            width = target_embedding.shape[0]
            num_valid_targets = min(max(
                num_valid_targets - mesh.model_index * width, 0), width)
    logits = (code_vectors.to(dtype)
              @ target_embedding.to(dtype).T).float()
    if num_valid_targets is not None and \
            num_valid_targets < target_embedding.shape[0]:
        logits[:, num_valid_targets:] = -1e9
    return logits


def weighted_ce_sums(logits: torch.Tensor, label: torch.Tensor,
                     weight: torch.Tensor, mesh=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weighted CE sum, weight sum), as ``logsumexp - picked``. On a
    ``mesh`` the logits are this rank's columns (``compute_logits``):
    the shards' logsumexps merge over the data row, and each label is
    picked by the rank that holds its column."""
    if mesh is None:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, 1, label.long()[:, None])[:, 0]
        return ((lse - picked) * weight).sum(), weight.sum()
    from code2vec_tpu_torch.parallel.mesh import (MODEL_AXIS, forward_sum,
                                                  merge_lse)
    width = logits.shape[-1]
    lse = merge_lse(torch.logsumexp(logits, dim=-1), mesh)
    local = label.long() - mesh.model_index * width
    mine = (local >= 0) & (local < width)
    picked = torch.gather(logits, 1, local.clamp(0, width - 1)[:, None])[:, 0]
    picked = forward_sum(torch.where(mine, picked, 0.0), mesh, MODEL_AXIS)
    return ((lse - picked) * weight).sum(), weight.sum()


def _loss_from_code(params: Code2VecParams, code_vectors: torch.Tensor,
                    label: torch.Tensor, weight: torch.Tensor,
                    dtype: torch.dtype, num_valid_targets: Optional[int],
                    use_fused_ce: bool, mesh=None):
    """Code vectors -> weighted mean CE, through materialized logits or
    the streamed CE kernels; padded rows carry weight 0. On a ``mesh``
    the rank's loss is its data shard's CE sum over the global weight
    sum, whose gradients, summed over the model column, are the global
    loss's; ``aux['loss']`` is the global loss (equal on every rank)."""
    from code2vec_tpu_torch.ops import ce
    if mesh is not None:
        from code2vec_tpu_torch.parallel.mesh import DATA_AXIS
    if use_fused_ce:
        num_valid = (num_valid_targets if num_valid_targets is not None
                     else params.target_embedding.shape[0] * (
                         1 if mesh is None else mesh.model))
        if mesh is None:
            ce_sum, weight_sum = ce.fused_weighted_ce_sums(
                params.target_embedding, code_vectors, label, weight,
                num_valid, dtype=dtype)
        else:
            ce_sum, weight_sum = ce.sharded_fused_weighted_ce_sums(
                params.target_embedding, code_vectors, label, weight,
                num_valid, mesh, dtype=dtype)
    else:
        logits = compute_logits(params.target_embedding, code_vectors,
                                dtype=dtype,
                                num_valid_targets=num_valid_targets,
                                mesh=mesh)
        ce_sum, weight_sum = weighted_ce_sums(logits, label, weight, mesh)
    aux = {'code_vectors': code_vectors}
    if mesh is not None:
        weight_sum = mesh.all_reduce(weight_sum.detach().clone(), DATA_AXIS)
    loss = ce_sum / torch.clamp(weight_sum, min=1.0)
    aux['num_valid'] = weight_sum
    if mesh is not None:
        aux['loss'] = mesh.all_reduce(loss.detach().clone(), DATA_AXIS)
    return loss, aux


def loss_and_aux_packed(params: Code2VecParams, ctx: torch.Tensor,
                        count: torch.Tensor, label: torch.Tensor,
                        weight: torch.Tensor, *, token_pad: int,
                        path_pad: int, dtype: torch.dtype = torch.float32,
                        keep_rate: float = 1.0,
                        dropout_seed: Optional[int] = None,
                        num_valid_targets: Optional[int] = None,
                        use_fused_ce: bool = False,
                        embed_grad_impl: str = 'dense',
                        remat_encode: bool = False, mesh=None):
    """The training loss straight off the packed wire: the ragged encode
    with its recompute backward (``ops/ragged.py::ragged_encode_code``;
    the table gradients by ``embed_grad_impl``), then the CE tail.
    ``remat_encode`` wraps the encode in
    ``torch.utils.checkpoint.checkpoint`` (REMAT_ENCODE, the reference's
    ``jax.checkpoint``): the backward runs the encode's forward again. The
    encode already saves no per-slot tensor, so this changes what runs,
    not a number. Returns ``(loss, {'code_vectors', 'num_valid'})``."""
    from code2vec_tpu_torch.ops import ragged

    def encode(tok, path, trans, attn, ctx_, count_):
        return ragged.ragged_encode_code(
            tok, path, trans, attn, ctx_, count_, token_pad=token_pad,
            path_pad=path_pad, dtype=dtype, keep_rate=keep_rate,
            dropout_seed=dropout_seed, embed_grad_impl=embed_grad_impl,
            mesh=mesh)

    args = (params.token_embedding, params.path_embedding, params.transform,
            params.attention, ctx, count)
    if remat_encode:
        from torch.utils.checkpoint import checkpoint
        # the dropout mask comes from its own seeded generator, so the
        # global RNG state need not be stashed (a host-side copy)
        code_vectors = checkpoint(encode, *args, use_reentrant=False,
                                  preserve_rng_state=False)
    else:
        code_vectors = encode(*args)
    return _loss_from_code(params, code_vectors, label, weight, dtype,
                           num_valid_targets, use_fused_ce, mesh)


def loss_and_aux(params: Code2VecParams, source: torch.Tensor,
                 path: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                 label: torch.Tensor, weight: torch.Tensor, *,
                 dtype: torch.dtype = torch.float32, keep_rate: float = 1.0,
                 dropout_seed: Optional[int] = None,
                 keep_mask: Optional[torch.Tensor] = None,
                 num_valid_targets: Optional[int] = None,
                 use_fused_ce: bool = False, embed_grad_impl: str = 'dense',
                 remat_encode: bool = False, mesh=None,
                 shard_contexts: bool = False):
    """The training loss of the plane wire (the reference's
    ``loss_and_aux``): autograd through the dense encode, then the CE
    tail. Dropout applies when ``keep_rate < 1`` and either
    ``dropout_seed`` (the (B, C, 3d) keep mask drawn from a generator
    seeded with it, so a recompute draws the same) or ``keep_mask`` is
    given. ``remat_encode`` wraps the encode in
    ``torch.utils.checkpoint.checkpoint`` (REMAT_ENCODE): the gathered
    contexts and activations are recomputed in the backward, under the
    same keep mask. ``shard_contexts``: SHARD_CONTEXTS on a ``mesh``
    (the module docstring; the keep mask is drawn whole). Returns
    ``(loss, {'code_vectors', 'num_valid'})``."""
    apply_dropout = keep_rate < 1.0 and (dropout_seed is not None
                                         or keep_mask is not None)

    def encode_code(token_embedding, path_embedding, transform, attention):
        keep = keep_mask if apply_dropout else None
        if apply_dropout and keep is None:
            generator = torch.Generator(device=source.device)
            generator.manual_seed(dropout_seed)
            context_dim = (2 * token_embedding.shape[1]
                           + path_embedding.shape[1])
            keep = dropout_keep_mask(generator, keep_rate,
                                     tuple(source.shape) + (context_dim,),
                                     source.device)
        encoder = params._replace(token_embedding=token_embedding,
                                  path_embedding=path_embedding,
                                  transform=transform, attention=attention)
        return encode(encoder, source, path, target, mask, dtype=dtype,
                      keep_mask=keep, keep_rate=keep_rate,
                      embed_grad_impl=embed_grad_impl, mesh=mesh,
                      shard_contexts=shard_contexts)[0]

    args = (params.token_embedding, params.path_embedding, params.transform,
            params.attention)
    if remat_encode:
        from torch.utils.checkpoint import checkpoint
        # the keep mask comes from its own seeded generator, so the global
        # RNG state need not be stashed
        code_vectors = checkpoint(encode_code, *args, use_reentrant=False,
                                  preserve_rng_state=False)
    else:
        code_vectors = encode_code(*args)
    return _loss_from_code(params, code_vectors, label, weight, dtype,
                           num_valid_targets, use_fused_ce, mesh)
