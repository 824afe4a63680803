"""The train and eval steps and the training loop — the counterparts of
``code2vec_tpu/training/trainer.py``. A train step takes the loss and
gradients of one batch through the backend, then the Adam update: a
packed batch through the ragged encode kernels under
USE_PALLAS_RAGGED_FUSION, else unpacked on the device to planes; a plane
batch through autograd of the dense encode; either way then materialized
logits or the streamed CE kernels. The eval step runs the forward of
either wire. ``fit`` is the epoch loop with its resilience hooks.

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

On a (data, model) mesh of ranks (``parallel/mesh.py``; ``Trainer(...,
mesh=)``, else the one ``create_mesh`` makes of the config and the
world) each rank steps on its data shard of the batch and its slices of
the tables: the loss is the global CE sum over the global weight sum,
every gradient comes back summed over the model column from the kernels'
sharded routes (never averaged: the reference's GSPMD program sums), and
Adam runs on the rank's slices with the same kernel. The dropout seed is
keyed on (seed, step, data index), so the ranks of a data row draw one
mask. ``eval_step`` takes the top k through ``sharded_top_k``.

Telemetry (TELEMETRY; ``telemetry/``): the trainer holds a
``StepTelemetry`` or None, and every instrumented site below is one ``is
None`` check when it is off. The state registers with the memory ledger
under one key a trainer (a restore replaces it), the staging ring's
batches under the ``staging`` bucket from placement to hand-out.
"""
from __future__ import annotations

import collections
import contextlib
import logging
import os
import signal
import time
from typing import (Callable, Dict, Iterable, Iterator, List, NamedTuple,
                    Optional, Tuple, Union)

import numpy as np
import torch
import torch.distributed as dist

from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.models import functional
from code2vec_tpu_torch.models.functional import Code2VecParams
from code2vec_tpu_torch.ops import lazy_adam
from code2vec_tpu_torch.ops.topk import sharded_top_k
from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.resilience.guard import DivergenceGuard
from code2vec_tpu_torch.resilience.watchdog import HangWatchdog
from code2vec_tpu_torch.telemetry import goodput as goodput_lib
from code2vec_tpu_torch.telemetry import memory as memory_lib
from code2vec_tpu_torch.telemetry import stepcost
from code2vec_tpu_torch.telemetry.stepwatch import StepTelemetry, device_kind
from code2vec_tpu_torch.telemetry.trace import ProfilerCapture
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


def moment_bytes(config: Config) -> int:
    """Bytes of Adam's two moments a parameter: their storage dtypes, or
    fp32 under lazy Adam."""
    if config.LAZY_EMBEDDING_ADAM:
        return 8
    return sum(2 if _STORAGE_DTYPES[name] is not None else 4
               for name in (config.ADAM_MU_DTYPE, config.ADAM_NU_DTYPE))


def state_bytes(config: Config, shapes: dict, with_moments: bool) -> int:
    """Device bytes of the fp32 masters of ``shapes`` ({name: shape}) and,
    ``with_moments``, of their Adam moments: the memory ledger's budget
    check before any of them is allocated."""
    elements = sum(int(np.prod(shape)) for shape in shapes.values())
    return elements * (4 + (moment_bytes(config) if with_moments else 0))


def dropout_seed(seed: int, step: int, data_index: int = 0) -> int:
    """The dropout seed of one step: distinct for every (seed, step) and,
    on a mesh, data index (the ranks of one data row share it; data
    index 0 keeps the one-rank seed)."""
    seed = (seed + data_index * 0x9E3779B1) & 0x7FFFFFFF
    return (seed << 32) | (step & 0xFFFFFFFF)


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
    def __init__(self, config: Config, backend, mesh=None):
        from code2vec_tpu_torch.parallel import mesh as mesh_lib
        self.config = config
        self.backend = backend
        if mesh is None:
            mesh = getattr(backend, 'mesh', None)
        mesh_lib.check_trainer_config(config, mesh)
        # None on one rank
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if getattr(backend, 'mesh', None) is not self.mesh:
            raise ValueError('the backend\'s mesh %r is not the trainer\'s '
                             '%r' % (getattr(backend, 'mesh', None),
                                     self.mesh))
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
        # telemetry: None when off; the dispatch shapes whose step cost
        # the goodput ledger has (first sight of each)
        self._telemetry: Optional[StepTelemetry] = None
        self._cost_keys: set = set()
        if config.TELEMETRY:
            self._telemetry = StepTelemetry(
                config, log=logger.info,
                device_kind=device_kind(backend.device))
        # the memory ledger's key of this trainer's state: a restore
        # replaces the entries, a collected trainer releases them
        self._mem_key = 'trainer:%x' % id(self)
        self._last_batch_num = 0
        # arm the process-global fault plan: None leaves it to the
        # FAULT_INJECT environment variable, '' turns it off; re-arming
        # resets what has fired, so each run's injections repeat
        faults.configure(config.FAULT_INJECT
                         if config.FAULT_INJECT is not None
                         else os.environ.get('FAULT_INJECT', ''))

    def init_state(self, seed: int = 42) -> TrainerState:
        """Fresh weights drawn from ``seed`` and zero moments."""
        return self.state_from_params(self.backend.init_params(seed),
                                      seed=seed)

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
        self.register_state_memory(tensors, opt_state)
        return TrainerState(params=tensors, opt_state=opt_state, step=step,
                            seed=seed)

    def register_state_memory(self, params, opt_state=None) -> None:
        """Attribute this trainer's state to the memory ledger
        (``telemetry/memory.py``) under one key, so a restore replaces the
        entries instead of double-counting. Metadata only."""
        led = memory_lib.ledger()
        led.register('params', self._mem_key, params, owner=self)
        if opt_state is not None:
            led.register('opt_state', self._mem_key, opt_state, owner=self)

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
        if self.mesh is not None:
            # a checkpoint holds whole tables: this rank's rows of them
            from code2vec_tpu_torch.checkpoints import map_opt_state
            full = self.backend.global_param_shapes()

            def local(named):
                return {name: (self.mesh.shard_params({name: t})[name]
                               if tuple(t.shape) == full.get(name)
                               and tuple(t.shape) != tuple(
                                   shapes[name].shape) else t)
                        for name, t in named.items()}
            opt_state = map_opt_state(opt_state, local)

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
        # a restore (resume, rewind) replaces the trainer's entries
        self.register_state_memory(tensors, state)
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
        tele = self._telemetry
        if device.type != 'cuda':
            depth = 0
        elif depth is None:
            depth = max(0, self.config.DEVICE_PREFETCH_BATCHES)
        else:
            depth = max(0, depth)
        staged = collections.deque()
        # with telemetry on: the h2d timer and the ring's occupancy, and
        # each staged batch in the ledger's staging bucket from placement
        # to hand-out (metadata only); off, nothing is recorded
        led = None
        mem_keys: collections.deque = collections.deque()
        mem_seq = 0
        if tele is not None:
            led = memory_lib.ledger()
            tele.registry.gauge('staging/ring_depth').set(depth)

        def hand_out():
            arrays, event, batch = staged.popleft()
            if led is not None:
                tele.ring_occupancy.set(len(staged))
                led.release('staging', mem_keys.popleft())
            if event is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                for array in arrays:
                    array.record_stream(stream)
            return arrays, batch

        try:
            for batch in batches:
                if tele is None:
                    staged.append(self._stage(batch))
                else:
                    with torch.profiler.record_function('host/h2d_place'), \
                            tele.h2d.time():
                        item = self._stage(batch)
                    staged.append(item)
                    tele.ring_occupancy.set(len(staged))
                    key = '%s/%d' % (self._mem_key, mem_seq)
                    mem_seq += 1
                    led.register('staging', key, item[0])
                    mem_keys.append(key)
                if len(staged) > depth:
                    yield hand_out()
            while staged:
                yield hand_out()
        finally:
            # an abandoned generator leaves no staging entry behind
            while mem_keys:
                led.release('staging', mem_keys.popleft())

    def _stage(self, batch):
        """One batch onto the card: ``(arrays, event, batch)``. Host arrays
        go through pinned buffers and the side stream; tensors already on
        the card pass as they are (the event is None when every array was
        there, so a step captured in a CUDA graph stages nothing)."""
        device = self.backend.device
        host = self._host_arrays(batch)
        if device.type != 'cuda':
            return tuple(torch.from_numpy(np.ascontiguousarray(a))
                         if isinstance(a, np.ndarray) else a.to(device)
                         for a in host), None, batch
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
        """One step on a batch of either wire -> (new state, loss as a device
        scalar; reading it waits for the step)."""
        return self.train_step_placed(state, self.place(batch))

    def train_step_placed(self, state: TrainerState,
                          arrays: Tuple[torch.Tensor, ...]
                          ) -> Tuple[TrainerState, torch.Tensor]:
        """``train_step`` on arrays already on the device
        (``stage_batches``): 4 packed arrays ``(ctx, count, label,
        weight)`` or 6 plane arrays ``(source, path, target, mask, label,
        weight)``."""
        if len(arrays) not in (4, 6):
            raise ValueError('a batch is 4 packed or 6 plane arrays, got %d'
                             % len(arrays))
        ragged = len(arrays) == 4 and self.config.USE_PALLAS_RAGGED_FUSION
        if len(arrays) == 4 and not ragged:
            # the reference's unpack-then-dense route: bit-equal planes
            arrays = (*self.backend.unpack(arrays[0], arrays[1]),
                      arrays[2], arrays[3])
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
        seed = dropout_seed(state.seed, state.step,
                            0 if self.mesh is None else self.mesh.data_index)
        if ragged:
            loss, aux = self.backend.loss_fn_packed(diff, arrays,
                                                    dropout_seed=seed)
        else:
            loss, aux = self.backend.loss_fn(diff, arrays,
                                             dropout_seed=seed)
        loss.backward()
        # on a mesh: the global loss, equal on every rank
        loss = aux.get('loss', loss)
        grads = [p.grad for p in diff]
        if self.lazy is not None:
            if ragged:
                source, path, target = packed_rows(
                    arrays[0], self.backend.token_pad_index,
                    self.backend.path_pad_index)
            else:
                # the planes' every slot (the reference's plane_rows)
                source, path, target = arrays[:3]
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
        add up exactly and padded rows (weight 0) drop out. On a mesh:
        the rank's data shard's rows and sums (global top-k indices)."""
        return self.eval_step_placed(self.place(batch))

    @torch.no_grad()
    def eval_step_placed(self, arrays: Tuple[torch.Tensor, ...]) -> dict:
        """``eval_step`` on arrays already on the device
        (``stage_batches``)."""
        code_vectors, _attention = self.backend.encode_arrays(arrays)
        logits = self.backend.logits(code_vectors)
        topk_scores, topk_indices = sharded_top_k(
            logits, self.config.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION,
            self.mesh)
        loss_sum, weight_sum = functional.weighted_ce_sums(
            logits, arrays[-2], arrays[-1], self.mesh)
        out = {'topk_indices': topk_indices, 'topk_scores': topk_scores,
               'loss_sum': loss_sum, 'weight_sum': weight_sum}
        if self.config.EXPORT_CODE_VECTORS:
            out['code_vectors'] = code_vectors
        return out

    # ------------------------------------------------------------ the loop
    def fit(self, state: TrainerState,
            epoch_batches: Callable[[int], Iterable],
            start_epoch: int = 0,
            on_epoch_end: Optional[Callable[[int, TrainerState, int],
                                            None]] = None,
            on_log: Optional[Callable[[int, float, float], None]] = None,
            on_eval_interval: Optional[Callable[[int, TrainerState],
                                                None]] = None,
            on_save_interval: Optional[Callable[[int, int, TrainerState],
                                                None]] = None,
            on_epoch_time: Optional[Callable[[int, int, float],
                                             None]] = None,
            preemption=None,
            on_preempt: Optional[Callable[[int, int, TrainerState],
                                          None]] = None,
            on_divergence: Optional[Callable[[int],
                                             Optional[TrainerState]]] = None,
            on_hang: Optional[Callable[[], None]] = None,
            timings: Optional[list] = None
            ) -> Tuple[TrainerState, List[float]]:
        """Epochs ``start_epoch`` .. NUM_TRAIN_EPOCHS - 1 over
        ``epoch_batches(epoch)``, staged on the device ahead of the steps
        (the reference's ``Trainer.fit``) -> (state, each finished epoch's
        mean loss).

        The losses stay on the device until a log window of
        NUM_BATCHES_TO_LOG_PROGRESS steps ends; its one sync logs the mean
        and throughput (``on_log(batch, loss, examples/s)``) and, under
        DIVERGENCE_GUARD, checks the window for a non-finite loss, as the
        epoch's end checks its partial window and a mid-epoch evaluation
        the window it would discard. On one the guard rewinds through
        ``on_divergence(last_good_step)`` and the loop goes on with the
        same epoch's next batch. ``on_save_interval(epoch, batch, state)``
        runs at the top of the iteration after every SAVE_EVERY_N_STEPS
        steps, ``on_eval_interval(batch, state)`` every
        NUM_TRAIN_BATCHES_TO_EVALUATE, ``on_epoch_time(epoch, batch, s)``
        and ``on_epoch_end(epoch, state, batch)`` after each epoch. When
        ``preemption`` (a ``PreemptionHandler``) has a signal at a step
        boundary, ``on_preempt(epoch, batch, state)`` runs and the loop
        returns. On a mesh the ranks agree first: at the step boundaries
        that end a log window each rank's flag is all_reduced (MAX) over
        the mesh, so a signal that reached one rank stops every rank at
        the same step, where ``on_preempt``'s collective save can pair
        (a signal waits at most one window). HANG_WATCHDOG_SECS arms the watchdog around the wait for
        the next staged batch and around the window syncs; ``on_hang`` runs
        before its abort. The batch counter starts at the state's step.

        ``timings``, when given a list, gets one dict per finished epoch:
        its ``steps``, ``seconds``, the host seconds the loop waited for
        each next staged batch (``wait_s``) and, on the card, the device
        milliseconds between consecutive steps' ends (``interval_ms``,
        CUDA events)."""
        config = self.config
        tele = self._telemetry
        guard = watchdog = None
        if config.DIVERGENCE_GUARD:
            guard = DivergenceGuard(config.MAX_DIVERGENCE_REWINDS,
                                    restore=on_divergence,
                                    dump_dir=config.telemetry_dir,
                                    telemetry=tele)
        if config.HANG_WATCHDOG_SECS > 0:
            def on_expire():
                # metrics.jsonl records the run's last healthy state
                # before the abort
                if tele is not None:
                    tele.flush_now(self._last_batch_num)
                if on_hang is not None:
                    on_hang()
            watchdog = HangWatchdog(config.HANG_WATCHDOG_SECS,
                                    dump_dir=config.telemetry_dir,
                                    on_expire=on_expire)
        self._profile = None
        try:
            return self._fit_loop(
                state, epoch_batches, start_epoch, on_epoch_end, on_log,
                on_eval_interval, on_save_interval, on_epoch_time,
                preemption, on_preempt, guard, watchdog, timings)
        except Exception as exc:
            # OOM forensics: a device out-of-memory anywhere in the loop
            # (a step, a window sync) dumps the ledger before the run dies
            memory_lib.ledger().note_oom(exc, 'trainer.fit')
            raise
        finally:
            if watchdog is not None:
                watchdog.shutdown()
            if self._profile is not None:
                # the fixed window cut short: write what it holds
                profile, self._profile = self._profile, None
                profile.stop()
            if tele is not None:
                # stop a live capture and flush, so a failing run still
                # leaves metrics.jsonl current
                tele.shutdown(self._last_batch_num)

    @staticmethod
    def _num_valid_contexts(host_batch) -> int:
        """Contexts a batch feeds the step: the retained slots of a packed
        batch (its counts), the mask-valid slots of a plane batch."""
        count = getattr(host_batch, 'count', None)
        if isinstance(count, np.ndarray):
            return int(count.sum())
        return int(np.count_nonzero(host_batch.mask))

    def step_cost(self, arrays) -> Tuple[float, float]:
        """``(flops, bytes)`` of one train step on ``arrays``' shapes
        (``telemetry/stepcost.py``): the MFU's numerator, as the
        reference's ``train_program_cost``."""
        backend = self.backend
        shapes = backend.param_shapes()
        if self.lazy is None:
            params = sum(int(np.prod(shape)) for shape in shapes.values())
        else:
            # the dense keys whole, the tables over the rows listed
            params = sum(int(np.prod(shapes[key]))
                         for key in lazy_adam.LazyEmbeddingAdam.DENSE_KEYS)
            if len(arrays) == 4 and self.config.USE_PALLAS_RAGGED_FUSION:
                slots = int(arrays[0].shape[0]) * int(arrays[0].shape[1])
                listed = (2 * slots + 1, slots + 1)
            else:
                slots = int(arrays[-1].shape[0]) * self.config.MAX_CONTEXTS
                listed = (2 * slots, slots)
            params += (listed[0] * backend.sizes['token_dim']
                       + listed[1] * backend.sizes['path_dim'])
        shape = stepcost.step_shape(self.config, backend.sizes,
                                    backend.num_valid_targets, arrays,
                                    params)
        return stepcost.train_step_cost(
            shape, compute_bytes=torch.finfo(backend.dtype).bits // 8,
            moment_bytes=moment_bytes(self.config),
            grad_bytes=2 if self.grads_bf16 else 4)

    def _maybe_record_step_cost(self, shape_key: str, arrays) -> None:
        """First sight of a dispatch shape: its step cost into the goodput
        ledger."""
        if shape_key in self._cost_keys:
            return
        self._cost_keys.add(shape_key)
        flops, byts = self.step_cost(arrays)
        self._telemetry.goodput.set_step_cost(shape_key, flops, byts)

    def _fit_loop(self, state, epoch_batches, start_epoch, on_epoch_end,
                  on_log, on_eval_interval, on_save_interval, on_epoch_time,
                  preemption, on_preempt, guard, watchdog, timings):
        config = self.config
        tele = self._telemetry
        on_card = self.backend.device.type == 'cuda'
        log_every = config.NUM_BATCHES_TO_LOG_PROGRESS
        eval_every = config.NUM_TRAIN_BATCHES_TO_EVALUATE
        save_every = config.SAVE_EVERY_N_STEPS
        record_steps = timings is not None and on_card
        if watchdog is None:
            null_ctx = contextlib.nullcontext()

            def watched(label_fmt, batch):
                return null_ctx
        else:
            def watched(label_fmt, batch):
                return watchdog.watch(label_fmt % batch)

        def device_sync() -> None:
            if on_card:
                torch.cuda.synchronize(self.backend.device)

        def preempt_now() -> bool:
            """A pending signal at this step boundary; on a mesh agreed
            over its ranks at the ends of log windows only (fit's
            docstring), where every rank reaches the same batch."""
            if preemption is None:
                return False
            if self.mesh is None:
                return preemption.requested
            if batch_num % log_every:
                return False
            flag = torch.tensor([float(preemption.requested)],
                                device=self.backend.device)
            self.mesh.all_reduce(flag, None, op=dist.ReduceOp.MAX)
            return bool(flag.item())

        batch_num = int(state.step)
        # device scalars: the host waits once a window, not once a step
        window: List[torch.Tensor] = []
        window_examples = 0
        window_start = time.time()
        epoch_means: List[float] = []
        host_batch = None

        def sync(label_fmt) -> List[float]:
            with watched(label_fmt, batch_num):
                return torch.stack(window).float().cpu().tolist()

        def timed_sync(label_fmt) -> List[float]:
            """``sync`` with the ``step/sync_ms`` timer and the
            ``host/sync`` scope (telemetry on)."""
            if tele is None:
                return sync(label_fmt)
            t0 = time.perf_counter()
            with torch.profiler.record_function('host/sync'):
                losses = sync(label_fmt)
            tele.sync.record(time.perf_counter() - t0)
            return losses

        def rewind(losses) -> TrainerState:
            """The guard's rewind of the current window: the new state,
            or DivergenceError. ``step_now`` is in state steps, which lag
            the batch counter after an earlier rewind."""
            del epoch_losses[-min(len(losses), len(epoch_losses)):]
            step_before = int(state.step)
            with goodput_lib.interval(goodput_lib.KIND_REWIND):
                new_state = guard.handle(batch_num, losses, host_batch,
                                         step_now=step_before)
            if tele is not None:
                # the steps back to the rewind point re-train lost
                # progress: badput, billed as they run
                tele.goodput.mark_replay(step_before - int(new_state.step))
            return new_state

        def end_iteration(t_start: float, shape_key: str) -> None:
            """Close one iteration for the goodput ledger (a rewound one
            too: its seconds are attributed, the rewind's to the rewind):
            clean step seconds = the iteration less the badput inside it;
            compile-free ones feed the anomaly watchdog."""
            iter_s = time.perf_counter() - t_start
            tele.step_total.record(iter_s)
            clean_s, had_compile = tele.goodput.step_done(
                batch_num, iter_s, shape_key)
            if not had_compile:
                tele.anomaly.observe(shape_key, clean_s, batch_num)
            tele.after_step(batch_num)
            self._last_batch_num = batch_num

        if tele is not None:
            tele.resume()   # shutdown() in fit's finally disables
        # the fixed --profile window, relative to this run's first step
        profile_start = batch_num + config.PROFILE_START_STEP
        profile_stop = profile_start + config.PROFILE_NUM_STEPS
        profile_done = not config.PROFILE_DIR
        for epoch in range(start_epoch, config.NUM_TRAIN_EPOCHS):
            epoch_start = time.time()
            epoch_losses: List[torch.Tensor] = []
            steps = 0
            waits, step_ends = [], []
            with contextlib.closing(
                    self.stage_batches(epoch_batches(epoch))) as staged:
                staged = iter(staged)
                while True:
                    t_wait = time.perf_counter()
                    if tele is None:
                        with watched('next staged batch (batch %d)',
                                     batch_num):
                            item = next(staged, None)
                    else:
                        # the wait for the input pipeline, without the
                        # h2d placement that runs inside this next()
                        h2d_before = tele.h2d.total
                        with torch.profiler.record_function(
                                'host/batch_wait'), \
                                watched('next staged batch (batch %d)',
                                        batch_num):
                            item = next(staged, None)
                        wait_s = max(0.0, (time.perf_counter() - t_wait)
                                     - (tele.h2d.total - h2d_before))
                        tele.batch_wait.record(wait_s)
                        # the iteration's start for the goodput ledger
                        tele.goodput.note_input_wait(wait_s)
                    if item is None:
                        break
                    waits.append(time.perf_counter() - t_wait)
                    # a signal only set the flag: the run leaves here, at a
                    # step boundary, with a completed step's state
                    if preempt_now():
                        logger.info(
                            'Preemption (%s): leaving the fit loop at step '
                            'boundary %d for a final snapshot save.',
                            preemption.signal_name or 'a sibling rank',
                            batch_num)
                        if on_preempt is not None:
                            with goodput_lib.interval(
                                    goodput_lib.KIND_PREEMPT):
                                on_preempt(epoch, batch_num, state)
                        if tele is not None:
                            tele.goodput.run_end(batch_num, reason='preempt')
                        return state, epoch_means
                    arrays, host_batch = item
                    # the interval save fires at the top of the next
                    # iteration, so one on an epoch's last step does not
                    # take the place of the epoch-end save
                    if on_save_interval is not None and batch_num > 0 and \
                            save_every > 0 and batch_num % save_every == 0:
                        with goodput_lib.interval(
                                goodput_lib.KIND_CHECKPOINT):
                            on_save_interval(epoch, batch_num, state)
                    if not profile_done:
                        # the profiler does not nest: the fixed window
                        # yields to a live on-demand capture, and the
                        # controller stays inert while the window runs
                        if self._profile is None and \
                                batch_num >= profile_start and not (
                                    tele is not None and tele.trace.active):
                            self._profile = ProfilerCapture(config.PROFILE_DIR)
                        elif self._profile is not None and \
                                batch_num >= profile_stop:
                            device_sync()
                            path = self._profile.stop()
                            self._profile = None
                            profile_done = True
                            logger.info('Profiler trace written to `%s`.',
                                        path)
                    if tele is None:
                        state, loss = self.train_step_placed(state, arrays)
                    else:
                        if self._profile is None:
                            tele.trace.maybe_update(batch_num,
                                                    sync=device_sync)
                        if len(arrays) == 4:
                            capacity = int(arrays[0].shape[1])
                            shape_key = 'packed:%d' % capacity
                            tele.capacity.observe(capacity, batch_num)
                        else:
                            shape_key = 'planes:%d' % int(arrays[0].shape[0])
                        self._maybe_record_step_cost(shape_key, arrays)
                        # a launch time: the step's kernels are enqueued,
                        # not waited for
                        with torch.profiler.record_function('train'), \
                                tele.dispatch.time():
                            state, loss = self.train_step_placed(state,
                                                                 arrays)
                    steps += 1
                    if record_steps:
                        step_ends.append(torch.cuda.Event(
                            enable_timing=True))
                        step_ends[-1].record()
                    if faults.maybe_fire('slow_step', step=batch_num):
                        time.sleep(faults.SLOW_STEP_SECONDS)
                    if faults.maybe_fire('nan_loss', step=batch_num):
                        # on the device, as a real divergence would come
                        loss = loss + float('nan')
                    batch_num += 1
                    if faults.maybe_fire('sigterm', step=batch_num):
                        os.kill(os.getpid(), signal.SIGTERM)
                    window.append(loss)
                    epoch_losses.append(loss)
                    n_valid = int(np.count_nonzero(host_batch.weight))
                    window_examples += n_valid
                    if tele is not None:
                        tele.count_batch(n_valid,
                                         self._num_valid_contexts(host_batch))
                    if batch_num % log_every == 0:
                        losses = timed_sync(
                            'log-window device sync (batch %d)')
                        total = float(np.sum(losses))
                        # the sum is non-finite iff one loss is
                        if guard is not None and not np.isfinite(total):
                            state = rewind(losses)
                            window, window_examples = [], 0
                            window_start = time.time()
                            if tele is not None:
                                end_iteration(t_wait, shape_key)
                            continue
                        throughput = window_examples / max(
                            time.time() - window_start, 1e-9)
                        logger.info('Average loss at batch %d: %f, '
                                    '\tthroughput: %d samples/sec',
                                    batch_num, total / len(losses),
                                    throughput)
                        if on_log is not None:
                            on_log(batch_num, total / len(losses),
                                   throughput)
                        window, window_examples = [], 0
                        window_start = time.time()
                    if on_eval_interval is not None and eval_every and \
                            batch_num % eval_every == 0:
                        # the window is dropped below: check it first, or
                        # a NaN between log boundaries goes unexamined
                        if guard is not None and window:
                            losses = sync('eval-interval window sync '
                                          '(batch %d)')
                            if not np.isfinite(float(np.sum(losses))):
                                state = rewind(losses)
                                window, window_examples = [], 0
                                window_start = time.time()
                                if tele is not None:
                                    end_iteration(t_wait, shape_key)
                                continue
                        with goodput_lib.interval(goodput_lib.KIND_EVAL):
                            on_eval_interval(batch_num, state)
                        window, window_examples = [], 0
                        window_start = time.time()
                    if tele is not None:
                        end_iteration(t_wait, shape_key)
            if steps == 0:
                raise ValueError('no training batches in epoch %d'
                                 % (epoch + 1))
            if (tele is not None or guard is not None) and window:
                # a short epoch may end no log window: check its partial
                # one (which stays in the window, unconsumed), so the
                # guard sees every epoch and step/sync_ms is recorded
                t0 = time.perf_counter()
                losses = timed_sync('epoch-end window sync (batch %d)')
                if tele is not None:
                    # this sync drains dispatched device work: real
                    # progress outside any iteration's seconds
                    tele.goodput.note_productive(time.perf_counter() - t0)
                if guard is not None and \
                        not np.isfinite(float(np.sum(losses))):
                    state = rewind(losses)
                    window, window_examples = [], 0
            mean = (float(torch.stack(epoch_losses).float().mean())
                    if epoch_losses else float('nan'))
            epoch_means.append(mean)
            epoch_wall = time.time() - epoch_start
            logger.info('epoch %d: %d steps, mean loss %.5f, %.1f s',
                        epoch + 1, steps, mean, epoch_wall)
            if tele is not None:
                tele.registry.gauge('train/epoch_wall_time_s').set(
                    epoch_wall)
            if timings is not None:
                timings.append(dict(
                    epoch=epoch, steps=steps, seconds=epoch_wall,
                    wait_s=waits,
                    interval_ms=[a.elapsed_time(b) for a, b in
                                 zip(step_ends, step_ends[1:])]))
            if on_epoch_time is not None:
                on_epoch_time(epoch, batch_num, epoch_wall)
            if on_epoch_end is not None:
                on_epoch_end(epoch, state, batch_num)
                window_start = time.time()
        return state, epoch_means
