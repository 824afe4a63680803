"""The train and eval steps — the counterparts of the packed-wire train
step and the eval step of ``code2vec_tpu/training/trainer.py``. A train
step takes the loss and gradients of one packed batch through the backend
(the ragged encode kernels, then materialized logits or the streamed CE
kernels), then the Adam update; the plane wire and the unpack-then-dense
route do not train yet. The eval step runs the forward of either wire.

State lives on the backend's device. The parameters are the backend's
``nn.Parameter``s and are updated in place, with the stored moments: a
step returns a new ``TrainerState`` over the same tensors (the reference
returns new arrays and donates the old ones). The per-step dropout seed
is derived from ``(seed, step)``, as the reference folds the step into
its key.

The optimizer is the reference's choice (trainer.py:106-140): Adam with
the moments stored in ADAM_MU_DTYPE / ADAM_NU_DTYPE, one fused kernel
launch per parameter on the card (``training/adam_dtypes.py``), or under
LAZY_EMBEDDING_ADAM sparse-row Adam for the token and path tables over
the rows the packed stream touches (``packed_rows``) and fused Adam with
fp32 moments for the rest (``ops/lazy_adam.py``). Under
GRADS_DTYPE='bfloat16' the loss is differentiated with respect to
detached bf16 copies of the fp32 masters, so every gradient, the table
gradients included, comes back in bf16; the fused Adam upcasts them.

``stage_batches`` is the staging ring between the host reader and the
steps (the reference's ``Trainer.stage_batches``): each batch is copied
into pinned host buffers, sent to the card with ``non_blocking`` copies
on a side stream, and handed to the step with a CUDA event that the
step's stream waits on, DEVICE_PREFETCH_BATCHES batches ahead of the
step consuming them. ``train_step`` / ``eval_step`` stage one batch,
then run ``train_step_placed`` / ``eval_step_placed``.
"""
from __future__ import annotations

import collections
import logging
from typing import (Dict, Iterable, Iterator, NamedTuple, Optional, Tuple,
                    Union)

import numpy as np
import torch

from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.models import functional
from code2vec_tpu_torch.models.functional import Code2VecParams
from code2vec_tpu_torch.ops import lazy_adam
from code2vec_tpu_torch.ops.topk import top_k
from code2vec_tpu_torch.training import adam_dtypes

logger = logging.getLogger(__name__)

_STORAGE_DTYPES = {'bfloat16': torch.bfloat16, 'float32': None}


class TrainerState(NamedTuple):
    params: Code2VecParams       # the backend's nn.Parameters
    # AdamState, or LazyAdamState under LAZY_EMBEDDING_ADAM
    opt_state: Union[adam_dtypes.AdamState, lazy_adam.LazyAdamState]
    step: int
    seed: int                    # dropout seed root


def packed_rows(ctx: torch.Tensor, token_pad: int, path_pad: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lazy Adam's touched rows off the packed wire ``(source, path,
    target)``: the ctx stream holds every slot up to each example's
    effective length (capacity padding carries the PAD triple), and the
    PAD rows are appended, so the gradient that count == 0 rows send to
    them is applied even when a batch packs with no padding (the
    reference's trainer.py:363-377)."""
    def with_pad(column: torch.Tensor, pad: int) -> torch.Tensor:
        return torch.cat([column.reshape(-1),
                          torch.full((1,), pad, dtype=column.dtype,
                                     device=column.device)])
    return (with_pad(ctx[..., 0], token_pad), with_pad(ctx[..., 1], path_pad),
            ctx[..., 2].reshape(-1))


def dropout_seed(seed: int, step: int) -> int:
    """The dropout seed of one step: distinct for every (seed, step)."""
    return ((seed & 0x7FFFFFFF) << 32) | (step & 0xFFFFFFFF)


class PinnedPool:
    """Pinned host buffers for the staging ring, one ring per array slot,
    shape and dtype (a packed batch's capacity steps up as the sticky
    packer grows). A buffer is refilled only after the event of the copy
    that read it has completed: past ``size`` buffers in one ring the host
    waits for the oldest copy."""

    _PENDING = object()     # taken, its copy not yet recorded

    def __init__(self, size: int):
        self.size = size
        self.rings: Dict[tuple, collections.deque] = {}

    def take(self, key: int, shape, dtype: torch.dtype) -> torch.Tensor:
        ring = self.rings.setdefault((key, tuple(shape), dtype),
                                     collections.deque())
        if ring and ring[0][1] is not self._PENDING and (
                ring[0][1].query() or len(ring) >= self.size):
            buffer, event = ring.popleft()
            event.synchronize()
        else:
            buffer = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
        ring.append([buffer, self._PENDING])
        return buffer

    def copied(self, key: int, buffer: torch.Tensor, event) -> None:
        """Mark ``buffer``'s copy to the card as ending at ``event``."""
        ring = self.rings[(key, tuple(buffer.shape), buffer.dtype)]
        for entry in ring:
            if entry[0] is buffer:
                entry[1] = event
                return

    @property
    def buffers(self) -> list:
        return [entry[0] for ring in self.rings.values() for entry in ring]


class Trainer:
    def __init__(self, config: Config, backend):
        self.config = config
        self.backend = backend
        self.mu_dtype = _STORAGE_DTYPES[config.ADAM_MU_DTYPE]
        self.nu_dtype = _STORAGE_DTYPES[config.ADAM_NU_DTYPE]
        self.lazy = None
        if config.LAZY_EMBEDDING_ADAM:
            if (config.ADAM_MU_DTYPE != 'float32'
                    or config.ADAM_NU_DTYPE != 'float32'):
                # bf16 moments are the default; lazy Adam keeps fp32
                # moments and reads neither knob, so this warns
                logger.warning(
                    'ADAM_MU_DTYPE=%r / ADAM_NU_DTYPE=%r are ignored: '
                    'they apply to the dense Adam only; '
                    'LAZY_EMBEDDING_ADAM keeps fp32 moments.',
                    config.ADAM_MU_DTYPE, config.ADAM_NU_DTYPE)
            self.lazy = lazy_adam.LazyEmbeddingAdam(config.LEARNING_RATE)
        self.grads_bf16 = config.GRADS_DTYPE == 'bfloat16'
        # the staging ring's side stream and pinned buffers (on the card)
        self._copy_stream = None
        self._pinned = PinnedPool(max(0, config.DEVICE_PREFETCH_BATCHES) + 2)

    def init_state(self, seed: int = 42) -> TrainerState:
        """Fresh weights drawn from ``seed`` and zero moments."""
        generator = torch.Generator(device=self.backend.device)
        generator.manual_seed(seed)
        params = functional.init_params(generator, device=self.backend.device,
                                        **self.backend.sizes)
        return self.state_from_params(params, seed=seed)

    def state_from_params(self, params: Optional[Code2VecParams] = None,
                          step: int = 0, seed: int = 42) -> TrainerState:
        """Training state over ``params`` (loaded into the backend; None
        keeps the backend's current weights) with zero moments."""
        if params is not None:
            self.backend.load_params(params)
        tensors = self.backend.trainable_params
        if self.lazy is not None:
            opt_state = self.lazy.init(tensors)
        else:
            opt_state = adam_dtypes.init(tensors, self.mu_dtype,
                                         self.nu_dtype)
        return TrainerState(params=tensors, opt_state=opt_state, step=step,
                            seed=seed)

    def state_from_restored(self, params: Optional[Dict[str, torch.Tensor]],
                            opt_state: dict, step: int,
                            seed: int = 42) -> TrainerState:
        """Training state from a checkpoint (``checkpoints.py``):
        ``params`` ({name: tensor}; None keeps the backend's weights)
        loaded into the backend, and ``opt_state`` (the layout of
        ``lazy_adam.named_state``, each moment {name: tensor}) copied to the device in the
        configured storage dtypes (ADAM_MU_DTYPE / ADAM_NU_DTYPE: bf16 ->
        fp32 is exact, fp32 -> bf16 rounds as every step's store does;
        lazy Adam's moments fp32). The reference resumes the same way
        (model_api.py:202-253)."""
        if params is not None:
            self.backend.load_params(Code2VecParams(**params))
        tensors = self.backend.trainable_params
        device = self.backend.device
        shapes = dict(zip(Code2VecParams._fields, tensors))

        def moments(named, names, dtype):
            out = []
            for name in names:
                moment = named[name]
                if moment.shape != shapes[name].shape:
                    raise ValueError('Adam moment %s has shape %s, expected '
                                     '%s' % (name, tuple(moment.shape),
                                             tuple(shapes[name].shape)))
                out.append(moment.to(device, dtype or torch.float32,
                                     copy=True))
            return tuple(out)

        if ('dense' in opt_state) != (self.lazy is not None):
            raise ValueError(
                'the checkpoint holds %s state but LAZY_EMBEDDING_ADAM is '
                '%s' % ('lazy Adam' if 'dense' in opt_state else 'Adam',
                        self.lazy is not None))
        if self.lazy is not None:
            dense = opt_state['dense']
            keys = lazy_adam.LazyEmbeddingAdam.DENSE_KEYS
            tables = lazy_adam.LazyEmbeddingAdam.SPARSE_KEYS
            state = lazy_adam.LazyAdamState(
                dense=adam_dtypes.AdamState(
                    count=int(dense['count']),
                    mu=moments(dense['mu'], keys, None),
                    nu=moments(dense['nu'], keys, None)),
                mu=dict(zip(tables, moments(opt_state['mu'], tables, None))),
                nu=dict(zip(tables, moments(opt_state['nu'], tables, None))))
        else:
            names = Code2VecParams._fields
            state = adam_dtypes.AdamState(
                count=int(opt_state['count']),
                mu=moments(opt_state['mu'], names, self.mu_dtype),
                nu=moments(opt_state['nu'], names, self.nu_dtype))
        return TrainerState(params=tensors, opt_state=state, step=int(step),
                            seed=seed)

    @staticmethod
    def _host_arrays(batch) -> tuple:
        """A batch of either wire (``PackedBatch`` or ``Batch`` of numpy
        arrays, or a tuple of arrays or tensors: 4 packed, 6 planes)."""
        if hasattr(batch, 'device_arrays'):
            batch = batch.device_arrays()
        return tuple(batch)

    def stage_batches(self, batches: Iterable, depth: Optional[int] = None
                      ) -> Iterator[Tuple[Tuple[torch.Tensor, ...], object]]:
        """Place batches on the backend's device ahead of the step that
        consumes them; yields ``(arrays, batch)`` in order (the host batch
        rides along for its label strings and weights).

        On the card each array is copied into a pinned host buffer and sent
        up with a ``non_blocking`` copy on a side stream; an event recorded
        after the copies goes with the batch, and when the batch is handed
        out the current stream waits on it (no host synchronize) and the
        arrays are recorded on that stream, so the caching allocator keeps
        their memory until the step that reads them is done. ``depth``
        (DEVICE_PREFETCH_BATCHES by default) batches are in flight beside
        the one being consumed. On the CPU the depth is 0 and the arrays
        are the host's, as the reference stages on its CPU platform."""
        device = self.backend.device
        if device.type != 'cuda':
            for batch in batches:
                yield tuple(torch.from_numpy(np.ascontiguousarray(a))
                            if isinstance(a, np.ndarray) else a.to(device)
                            for a in self._host_arrays(batch)), batch
            return
        if depth is None:
            depth = self.config.DEVICE_PREFETCH_BATCHES
        depth = max(0, depth)
        staged = collections.deque()

        def hand_out():
            arrays, event, batch = staged.popleft()
            if event is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                for array in arrays:
                    array.record_stream(stream)
            return arrays, batch

        for batch in batches:
            staged.append(self._stage(batch))
            if len(staged) > depth:
                yield hand_out()
        while staged:
            yield hand_out()

    def _stage(self, batch):
        """One batch onto the card: ``(arrays, event, batch)``. Host arrays
        go through pinned buffers and the side stream; tensors already on
        the card pass as they are (the event is None when every array was
        there, so a step captured in a CUDA graph stages nothing)."""
        device = self.backend.device
        host = self._host_arrays(batch)
        if all(isinstance(a, torch.Tensor) and a.is_cuda for a in host):
            return host, None, batch
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device)
        stream = self._copy_stream
        arrays = []
        taken = []
        with torch.cuda.stream(stream):
            for slot, a in enumerate(host):
                if isinstance(a, torch.Tensor) and a.is_cuda:
                    arrays.append(a)
                    continue
                a = a.numpy() if isinstance(a, torch.Tensor) else a
                buffer = self._pinned.take(
                    slot, a.shape,
                    torch.from_numpy(np.empty(0, a.dtype)).dtype)
                np.copyto(buffer.numpy(), a)
                arrays.append(buffer.to(device, non_blocking=True))
                taken.append((slot, buffer))
        event = torch.cuda.Event()
        event.record(stream)
        for slot, buffer in taken:
            self._pinned.copied(slot, buffer, event)
        return tuple(arrays), event, batch

    def place(self, batch) -> Tuple[torch.Tensor, ...]:
        """One batch on the device, staged at depth 0."""
        arrays, _batch = next(self.stage_batches((batch,), depth=0))
        return arrays

    def train_step(self, state: TrainerState, batch
                   ) -> Tuple[TrainerState, torch.Tensor]:
        """One step on a packed batch -> (new state, loss as a device
        scalar; reading it waits for the step)."""
        return self.train_step_placed(state, self.place(batch))

    def train_step_placed(self, state: TrainerState,
                          arrays: Tuple[torch.Tensor, ...]
                          ) -> Tuple[TrainerState, torch.Tensor]:
        """``train_step`` on arrays already on the device
        (``stage_batches``)."""
        if len(arrays) != 4 or not self.config.USE_PALLAS_RAGGED_FUSION:
            raise NotImplementedError(
                'training runs on the packed wire with '
                'USE_PALLAS_RAGGED_FUSION only: the plane-wire train step '
                'and the unpack-then-dense route are not ported yet')
        params = state.params
        if self.grads_bf16:
            # the forward is unchanged (bf16 compute rounds the masters
            # to these values anyway); the gradients come back in bf16
            diff = Code2VecParams(*[p.detach().to(torch.bfloat16)
                                    .requires_grad_() for p in params])
        else:
            diff = params
            for p in params:
                p.grad = None
        loss, _aux = self.backend.loss_fn_packed(
            diff, arrays, dropout_seed=dropout_seed(state.seed, state.step))
        loss.backward()
        grads = [p.grad for p in diff]
        if self.lazy is not None:
            source, path, target = packed_rows(
                arrays[0], self.backend.token_pad_index,
                self.backend.path_pad_index)
            opt_state = self.lazy.update_(params, grads, state.opt_state,
                                          state.step, source, path, target)
        else:
            opt_state = adam_dtypes.update_(params, grads, state.opt_state,
                                            self.config.LEARNING_RATE)
        del grads
        for p in diff:
            p.grad = None      # the ~1.5 GB of gradients go before the next
        self.backend.mark_updated()
        return (TrainerState(params, opt_state, state.step + 1, state.seed),
                loss.detach())

    def eval_step(self, batch) -> dict:
        """The forward of one batch of either wire -> ``{'topk_indices',
        'topk_scores', 'loss_sum', 'weight_sum'}`` (+ ``'code_vectors'``
        under EXPORT_CODE_VECTORS), on the device. The top-k scores are
        the raw logits, not softmaxed; the CE comes as sums, so batches
        add up exactly and padded rows (weight 0) drop out."""
        return self.eval_step_placed(self.place(batch))

    @torch.no_grad()
    def eval_step_placed(self, arrays: Tuple[torch.Tensor, ...]) -> dict:
        """``eval_step`` on arrays already on the device
        (``stage_batches``)."""
        code_vectors, _attention = self.backend.encode_arrays(arrays)
        logits = self.backend.logits(code_vectors)
        topk_scores, topk_indices = top_k(
            logits, self.config.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION)
        loss_sum, weight_sum = functional.weighted_ce_sums(
            logits, arrays[-2], arrays[-1])
        out = {'topk_indices': topk_indices, 'topk_scores': topk_scores,
               'loss_sum': loss_sum, 'weight_sum': weight_sum}
        if self.config.EXPORT_CODE_VECTORS:
            out['code_vectors'] = code_vectors
        return out
