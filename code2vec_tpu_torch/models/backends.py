"""The module that holds the model's weights — the counterpart of the
reference's ``JaxBackend`` (code2vec_tpu/models/backends.py).

The five tables have the reference's padded sizes (rows rounded up to
``PARAM_ROW_ALIGNMENT``, the target table to the fused-CE vocab tile too
under ``USE_PALLAS_FUSED_CE``), so weights convert one to one, and
padded target columns are masked by ``num_valid_targets``. The weights
are trainable fp32 ``nn.Parameter``s, updated in place by the trainer.
In bf16 compute serving reads a bf16 copy of them: the reference casts
the ~400 MB target table on every call, and the copy gives the same
values. It is made at the first use after a load or an update.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data import packed as packed_lib
from code2vec_tpu_torch.models import functional
from code2vec_tpu_torch.models.functional import Code2VecParams
from code2vec_tpu_torch.ops import ragged


def compute_dtype(config: Config) -> torch.dtype:
    return (torch.bfloat16 if config.COMPUTE_DTYPE == 'bfloat16'
            else torch.float32)


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def target_row_alignment(config: Config) -> int:
    """Row alignment of the target table: under USE_PALLAS_FUSED_CE it
    folds in the fused-CE vocab tile, as the reference does, so the
    kernel's own pad is a no-op and both packages allocate the same rows
    (one device: the reference's model axis is 1)."""
    align = max(config.PARAM_ROW_ALIGNMENT, 1)
    if config.USE_PALLAS_FUSED_CE:
        from code2vec_tpu_torch.ops.ce import VOCAB_TILE
        align = math.lcm(align, VOCAB_TILE)
    return align


def table_sizes(config: Config, vocabs) -> dict:
    """The tables' padded row counts and the dims (``init_params``'s
    keyword arguments)."""
    align = max(config.PARAM_ROW_ALIGNMENT, 1)
    return dict(
        token_vocab_size=_round_up(vocabs.token_vocab.size, align),
        path_vocab_size=_round_up(vocabs.path_vocab.size, align),
        target_vocab_size=_round_up(vocabs.target_vocab.size,
                                    target_row_alignment(config)),
        token_dim=config.TOKEN_EMBEDDINGS_SIZE,
        path_dim=config.PATH_EMBEDDINGS_SIZE,
        code_dim=config.CODE_VECTOR_SIZE)


class TorchBackend(nn.Module):
    """The five weights, the forward of either wire (the ragged encode off
    the packed wire, the dense encode off the planes), and the training
    loss of either."""

    def __init__(self, config: Config, vocabs, device: torch.device,
                 params: Optional[Code2VecParams] = None, seed: int = 0):
        super().__init__()
        self.config = config
        self.device = device
        self.num_valid_targets = vocabs.target_vocab.size
        self.token_pad_index = vocabs.token_vocab.pad_index
        self.path_pad_index = vocabs.path_vocab.pad_index
        self.sizes = table_sizes(config, vocabs)
        self.dtype = compute_dtype(config)
        self._compute_params: Optional[Code2VecParams] = None
        if params is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(seed)
            params = functional.init_params(generator, device=device,
                                            **self.sizes)
        self.load_params(params)

    def load_params(self, params: Code2VecParams) -> None:
        shapes = self.param_shapes()
        for name in Code2VecParams._fields:
            tensor = getattr(params, name)
            if tuple(tensor.shape) != shapes[name]:
                raise ValueError('parameter %s has shape %s, expected %s'
                                 % (name, tuple(tensor.shape), shapes[name]))
            # a copy: training updates it in place
            setattr(self, name, nn.Parameter(
                tensor.detach().to(self.device, torch.float32,
                                   copy=True)))
        self.mark_updated()

    def mark_updated(self) -> None:
        """The weights changed (a load or an optimizer step): the compute
        copies are remade at their next use."""
        self._compute_params = None

    @property
    def compute_params(self) -> Code2VecParams:
        """The weights in the compute dtype (the same tensors in fp32).
        ``mark_updated`` drops them and the next use makes new tensors,
        so a captured CUDA graph never reads them: the serving engine
        copies the weights into parameter slots of its own
        (``serving/graphs.py``)."""
        if self._compute_params is None:
            self._compute_params = self.to_compute(self.params)
        return self._compute_params

    def to_compute(self, params: Code2VecParams) -> Code2VecParams:
        """``params`` (any dtype, any device) as compute-dtype tensors on
        the backend's device, checked against the tables' shapes; tensors
        that already are so are returned as they are."""
        shapes = self.param_shapes()
        out = []
        for name in Code2VecParams._fields:
            tensor = getattr(params, name)
            if tuple(tensor.shape) != shapes[name]:
                raise ValueError('parameter %s has shape %s, expected %s'
                                 % (name, tuple(tensor.shape), shapes[name]))
            out.append(tensor.detach().to(self.device, self.dtype))
        return Code2VecParams(*out)

    def param_shapes(self) -> dict:
        s = self.sizes
        return {
            'token_embedding': (s['token_vocab_size'], s['token_dim']),
            'path_embedding': (s['path_vocab_size'], s['path_dim']),
            'target_embedding': (s['target_vocab_size'], s['code_dim']),
            'transform': (2 * s['token_dim'] + s['path_dim'],
                          s['code_dim']),
            'attention': (s['code_dim'], 1)}

    @property
    def params(self) -> Code2VecParams:
        return Code2VecParams(*[getattr(self, name).data
                                for name in Code2VecParams._fields])

    @property
    def trainable_params(self) -> Code2VecParams:
        """The ``nn.Parameter``s themselves, for autograd and the
        optimizer."""
        return Code2VecParams(*[getattr(self, name)
                                for name in Code2VecParams._fields])

    def loss_fn_packed(self, params: Code2VecParams, packed_arrays,
                       dropout_seed: Optional[int] = None):
        """Weighted mean CE of one packed batch ``(ctx, count, label,
        weight)`` -> ``(loss, aux)``: the ragged encode with its recompute
        backward, then materialized logits or, under USE_PALLAS_FUSED_CE,
        the streamed CE kernels. Dropout draws from ``dropout_seed`` at
        DROPOUT_KEEP_RATE; None turns it off. EMBED_GRAD_IMPL picks the
        table gradients' strategy and REMAT_ENCODE recomputes the encode
        in the backward. ``params`` are the fp32 masters, or their bf16
        copies under GRADS_DTYPE='bfloat16' (the trainer's), whose
        gradients then come back in bf16."""
        ctx, count, label, weight = packed_arrays
        return functional.loss_and_aux_packed(
            params, ctx, count, label, weight,
            token_pad=self.token_pad_index, path_pad=self.path_pad_index,
            dtype=self.dtype, keep_rate=self.config.DROPOUT_KEEP_RATE,
            dropout_seed=dropout_seed,
            num_valid_targets=self.num_valid_targets,
            use_fused_ce=self.config.USE_PALLAS_FUSED_CE,
            embed_grad_impl=self.config.EMBED_GRAD_IMPL,
            remat_encode=self.config.REMAT_ENCODE)

    def loss_fn(self, params: Code2VecParams, plane_arrays,
                dropout_seed: Optional[int] = None):
        """Weighted mean CE of one plane batch ``(source, path, target,
        mask, label, weight)`` -> ``(loss, aux)``: autograd through the
        dense encode (no kernel: the reference's plane train step runs no
        encode kernel either), then the CE tail of ``loss_fn_packed``.
        Dropout draws from ``dropout_seed`` at DROPOUT_KEEP_RATE; None
        turns it off. EMBED_GRAD_IMPL and REMAT_ENCODE as in
        ``loss_fn_packed``."""
        return functional.loss_and_aux(
            params, *plane_arrays, dtype=self.dtype,
            keep_rate=self.config.DROPOUT_KEEP_RATE,
            dropout_seed=dropout_seed,
            num_valid_targets=self.num_valid_targets,
            use_fused_ce=self.config.USE_PALLAS_FUSED_CE,
            embed_grad_impl=self.config.EMBED_GRAD_IMPL,
            remat_encode=self.config.REMAT_ENCODE)

    def unpack(self, ctx: torch.Tensor, count: torch.Tensor):
        """The packed stream as the (B, C) planes and mask, on its
        device."""
        return packed_lib.unpack_device(ctx, count, self.config.MAX_CONTEXTS,
                                        self.token_pad_index,
                                        self.path_pad_index)

    def encode(self, source: torch.Tensor, path: torch.Tensor,
               target: torch.Tensor, mask: torch.Tensor,
               params: Optional[Code2VecParams] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Plane wire -> (code_vectors (B, D), attention (B, C)): the dense
        encode, through the fused context-transform kernel under
        USE_PALLAS_FUSED_ENCODE. ``params`` is the compute-dtype set to
        read (the serving engine's parameter slots); None reads
        ``compute_params``, as every ``params`` argument below."""
        return functional.encode(
            self.compute_params if params is None else params,
            source, path, target, mask,
            dtype=self.dtype, use_pallas=self.config.USE_PALLAS_FUSED_ENCODE)

    def encode_packed(self, ctx: torch.Tensor, count: torch.Tensor,
                      params: Optional[Code2VecParams] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Packed wire -> (code_vectors (B, D), attention (B, C)) through
        the ragged kernel wrapper; with USE_PALLAS_RAGGED_FUSION off, the
        stream is unpacked to planes for the dense encode."""
        if not self.config.USE_PALLAS_RAGGED_FUSION:
            return self.encode(*self.unpack(ctx, count), params=params)
        p = self.compute_params if params is None else params
        return ragged.ragged_encode(
            p.token_embedding, p.path_embedding, p.transform, p.attention,
            ctx, count, max_contexts=self.config.MAX_CONTEXTS,
            token_pad=self.token_pad_index, path_pad=self.path_pad_index,
            dtype=self.dtype)

    def encode_arrays(self, arrays, params: Optional[Code2VecParams] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Either wire, told apart by the arrays' arity as the reference's
        ``*_placed`` steps do: 4 = packed ``(ctx, count, label, weight)``,
        6 = planes ``(source, path, target, mask, label, weight)``."""
        if len(arrays) == 4:
            return self.encode_packed(arrays[0], arrays[1], params=params)
        if len(arrays) == 6:
            return self.encode(*arrays[:4], params=params)
        raise ValueError('a batch is 4 packed or 6 plane arrays, got %d'
                         % len(arrays))

    def logits(self, code_vectors: torch.Tensor,
               params: Optional[Code2VecParams] = None) -> torch.Tensor:
        p = self.compute_params if params is None else params
        return functional.compute_logits(
            p.target_embedding, code_vectors,
            dtype=self.dtype, num_valid_targets=self.num_valid_targets)

    def forward(self, source: torch.Tensor, path: torch.Tensor,
                target: torch.Tensor, mask: torch.Tensor):
        """Dense plane forward -> (code_vectors, attention, logits)."""
        code_vectors, attention = self.encode(source, path, target, mask)
        return code_vectors, attention, self.logits(code_vectors)
