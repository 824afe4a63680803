"""``Code2VecModel``: the port's user-facing model for training,
evaluation, serving predictions and its checkpoints (the paths of
``code2vec_tpu/model_api.py``).

    model = Code2VecModel(config)                 # on config.DEVICE (cuda)
    model = Code2VecModel(config, device='cpu')   # plain versions, CPU
    model.train()                                 # epochs over .train.c2v
    results = model.evaluate()                    # over TEST_DATA_PATH
    results = model.predict(lines)                # raw path-context lines
    engine = model.serving_engine()               # micro-batching, CUDA graphs
    mesh = model.serving_mesh(replicas=2)         # replicas, one front queue
    model.save()                                  # MODEL_SAVE_PATH
    model.release_model()                         # MODEL_LOAD_PATH, params only

Construction loads or creates the weights: with MODEL_LOAD_PATH the
vocabularies come from the ``dictionaries.bin`` beside it and the
weights from its checkpoints (``checkpoints.py``; the reference's orbax
checkpoints too) — the full training state when TRAIN_DATA_PATH_PREFIX
is set as well (training resumes at the epoch after the saved one),
params only otherwise; without it, from ``params`` or drawn from
``seed``.

``train`` reads ``TRAIN_DATA_PATH_PREFIX.train.c2v`` as shuffled
batches on BATCH_WIRE_FORMAT's wire (from the token cache under
TRAIN_DATA_CACHE, else tokenized each epoch; a prefetch thread either
way) and runs ``Trainer.fit``, which stages them on the device ahead of
the steps and trains up to NUM_TRAIN_EPOCHS; ``train`` wires its hooks:
the loss log and the metric summaries (USE_TENSORBOARD), saves every
SAVE_EVERY_EPOCHS epochs and step snapshots every SAVE_EVERY_N_STEPS
under MODEL_SAVE_PATH, evaluations every NUM_TRAIN_BATCHES_TO_EVALUATE
steps and after each epoch under TEST_DATA_PATH, the divergence guard's
rewind and the preemption's final snapshot. ``evaluate`` runs the eval
step over the test split on BATCH_WIRE_FORMAT's wire (read on a prefetch
thread and staged ahead of the steps) and scores the top-k words on the
host; like the reference it writes a per-example ``log.txt`` beside the model
it saves or loads, else into the working directory. ``predict``
tokenizes the lines, pads the batch to the serving bucket ladder, packs
it onto the wire (one shard) under 'packed', runs the predict step on
the model's device and decodes the result on the host. ``serving_engine``
builds the micro-batching engine over a warm ladder of CUDA graphs
(``serving/engine.py``) for concurrent request traffic, armed for
canaried rollover to the model's checkpoints; ``serving_mesh`` seats
several such engines behind one shared front queue (``serving/mesh.py``).

Over a world of ranks (``torchrun ... -m code2vec_tpu_torch.cli --mesh
DxM``; ``parallel/``) every rank builds the model with the same config:
it joins the (data, model) mesh, holds its rows of the tables, and
``train`` and ``evaluate`` run on every rank together, each on its line
stride of the split, for a number of steps the ranks agree on
(``fixed_step_iterator``); ``evaluate`` sums the metrics' raw counts
over the ranks, exactly. Only rank 0 writes checkpoints (whole tables,
gathered: a checkpoint does not depend on the topology and restores on
any), ``log.txt`` and the summaries; rank r's per-example log is
``log.txt.proc<r>``. The training knobs hold across ranks as on one:
SHARD_CONTEXTS, OPTIMIZER_STATE_SHARDING='zero' (a checkpoint still
holds whole moments, so it restores under either layout on any
topology), lazy Adam and TELEMETRY (rank r > 0's files named
``.proc<r>``: ``metrics.proc<r>.jsonl``, ``intervals.proc<r>.jsonl``,
``traces/step<N>.proc<r>/``, ...). ``predict``, the bulk feed
(``serving/bulk.py``) and the index (``index/``) run on the mesh of one
host's ranks as the reference runs them on one host's devices: every
rank passes the same input, runs its data shard, and gets the one-rank
result (gathered over the data axis); the chief writes the files. The
serving engine and the serving mesh run on one rank (a mesh raises
``MeshUnsupported``, ROADMAP C15): they serve on several cards by
placement, one worker replica a card (MESH_DEVICES_PER_REPLICA).

Telemetry (TELEMETRY, ``telemetry/``): construction pins the memory
ledger's HBM budget (HBM_BUDGET_BYTES) and dump directory and refuses a
model whose weights (and, when it trains, moments) would cross the
budget before anything is allocated; ``train`` marks its evaluations and
saves as typed badput of the goodput ledger.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from code2vec_tpu_torch import common, metrics_writer
from code2vec_tpu_torch.checkpoints import CheckpointStore, map_opt_state
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data.cache import TokenCache
from code2vec_tpu_torch.data.reader import (PathContextReader,
                                            prefetch_iterator)
from code2vec_tpu_torch.device import resolve_device
from code2vec_tpu_torch.metrics import (SubtokensEvaluationMetric,
                                        TopKAccuracyEvaluationMetric,
                                        decode_topk_batch)
from code2vec_tpu_torch.models.backends import (TorchBackend, param_shapes,
                                               table_sizes)
from code2vec_tpu_torch.models.functional import Code2VecParams
from code2vec_tpu_torch.parallel import distributed
from code2vec_tpu_torch.parallel import mesh as mesh_lib
from code2vec_tpu_torch.resilience.preempt import PreemptionHandler
from code2vec_tpu_torch.serving import engine as engine_lib
from code2vec_tpu_torch.serving.steps import predict_step
from code2vec_tpu_torch.telemetry import core as tele_core
from code2vec_tpu_torch.telemetry import goodput as goodput_lib
from code2vec_tpu_torch.telemetry import memory as memory_lib
from code2vec_tpu_torch.telemetry.stepwatch import process_suffix
from code2vec_tpu_torch.training.trainer import (Trainer, TrainerState,
                                                 state_bytes)
from code2vec_tpu_torch.vocab import Code2VecVocabs, VocabType

logger = logging.getLogger(__name__)

# beside the step snapshots: the run ended on a preemption signal
PREEMPTED_MARKER = 'PREEMPTED.json'


def fixed_step_iterator(make_local_batches, steps_per_epoch: int,
                        rank: int, log):
    """Exactly ``steps_per_epoch`` local batches for one epoch on a mesh
    (the reference's ``fixed_step_iterator``, model_api.py:39-71): every
    rank must run the same number of steps, or the collectives pair
    mismatched steps and hang; a shard that runs short cycles its own
    data, with a warning when it cycles by more than one batch."""
    import itertools

    def cycled():
        passes = 0
        while True:
            produced = 0
            for batch in make_local_batches():
                produced += 1
                yield batch
            if not produced:
                raise ValueError('Rank %d has no training batches in its '
                                 'shard.' % rank)
            passes += 1
            if passes == 1 and produced < steps_per_epoch - 1:
                log('WARNING: rank %d exhausted its shard after %d of %d '
                    'fixed steps and is cycling its local data to keep the '
                    'mesh in step; a skewed data split over-weights this '
                    'shard\'s examples.' % (rank, produced, steps_per_epoch))
    return itertools.islice(cycled(), steps_per_epoch)


def count_lines(path: str) -> int:
    with open(path, 'rb') as f:
        return sum(1 for _ in f)


class ModelEvaluationResults(NamedTuple):
    """(reference model_base.py:11-26)"""
    topk_acc: np.ndarray
    subtoken_precision: float
    subtoken_recall: float
    subtoken_f1: float
    loss: Optional[float] = None

    def __str__(self) -> str:
        res = 'topk_acc: {}, precision: {}, recall: {}, F1: {}'.format(
            self.topk_acc, self.subtoken_precision, self.subtoken_recall,
            self.subtoken_f1)
        if self.loss is not None:
            res = 'loss: {}, '.format(self.loss) + res
        return res


class ModelPredictionResults(NamedTuple):
    """(reference model_base.py:29-34)"""
    original_name: str
    topk_predicted_words: List[str]
    topk_predicted_words_scores: np.ndarray
    attention_per_context: Dict[Tuple[str, str, str], float]
    code_vector: Optional[np.ndarray] = None


class Code2VecModel:
    def __init__(self, config: Config,
                 device: Optional[Union[str, torch.device]] = None,
                 params: Optional[Code2VecParams] = None, seed: int = 0,
                 mesh=None):
        """Vocabularies and weights as the module docstring says;
        ``params`` (``convert.py`` carries a set across; whole tables) or
        ``seed`` make the weights of a model that loads none. ``device``
        defaults to ``config.DEVICE`` ('cuda'; this rank's card in a world
        of ranks) and raises without a GPU. ``mesh`` (``parallel/
        mesh.py``) defaults to the config's over the joined world (held
        as None on one rank)."""
        config.verify()
        self.config = config
        world = distributed.world_size()
        if device is None:
            # a MESH_DEVICE_INDICES slice's card, else this rank's
            card = mesh_lib.slice_card(config)
            if card is not None and config.DEVICE == 'cuda':
                device = torch.device('cuda', card)
            elif world > 1:
                device = distributed.local_device(config.DEVICE)
        self.device = resolve_device(device if device is not None
                                     else config.DEVICE)
        if mesh is None:
            # the config's shape against the world's ranks (one rank: a
            # 1 x 1 mesh, or a shape that does not match it raises)
            mesh = mesh_lib.create_mesh(config)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.vocabs = Code2VecVocabs(config)
        # the memory ledger: the budget from the config (the environment
        # variable otherwise), forensic dumps beside the run's artifacts;
        # a state that cannot fit is refused before anything is allocated
        memory_lib.configure(
            budget_bytes=(config.HBM_BUDGET_BYTES
                          if config.HBM_BUDGET_BYTES >= 0 else None),
            dump_dir=config.telemetry_dir,
            suffix=process_suffix(self.rank))
        shapes = param_shapes(table_sizes(config, self.vocabs))
        if self.mesh is not None:
            for name in mesh_lib.TABLES:
                rows, dim = shapes[name]
                shapes[name] = (rows // self.mesh.model, dim)
        zero_data = (self.mesh.data if self.mesh is not None and
                     config.OPTIMIZER_STATE_SHARDING == 'zero' else 1)
        memory_lib.ledger().check_budget(
            state_bytes(config, shapes, with_moments=config.is_training,
                        zero_data=zero_data),
            'the model\'s %s' % ('training state' if config.is_training
                                  else 'weights'))
        self._stores: Dict[str, CheckpointStore] = {}
        # training state over the backend's weights: restored here, or
        # made by train()
        self.state: Optional[TrainerState] = None
        self._start_epoch = 0
        restored = None
        if config.is_loading:
            if params is not None:
                raise ValueError('params and MODEL_LOAD_PATH both give the '
                                 'weights; pass one')
            store = self._store_for(config.MODEL_LOAD_PATH)
            if config.is_training:
                restored = store.restore_training()
                loaded = restored.params if restored is not None else None
            else:
                loaded = store.restore_params()
            if loaded is None:
                raise ValueError('No checkpoint found under `%s`.'
                                 % config.MODEL_LOAD_PATH)
            params = Code2VecParams(**loaded)
        # the reference Trainer's checks of the config against the mesh
        # come before any allocation
        mesh_lib.check_trainer_config(config, self.mesh)
        self.backend = TorchBackend(config, self.vocabs, self.device,
                                    params=params, seed=seed, mesh=self.mesh)
        self.reader = self._data_reader()
        self.trainer = Trainer(config, self.backend, mesh=self.mesh)
        if restored is not None:
            # registers the restored state with the memory ledger
            self.state = self.trainer.state_from_restored(
                None, restored.opt_state, restored.step)
            self._start_epoch = restored.epoch + 1
            logger.info('Resumed from `%s` at epoch %d (step %d)',
                        config.MODEL_LOAD_PATH, restored.epoch,
                        restored.step)
            # a run that ended on a preemption signal left a marker:
            # consumed here, so a later unclean crash is not read as one
            marker = os.path.join(store.snapshot_dir, PREEMPTED_MARKER)
            if os.path.isfile(marker):
                logger.info('Previous run exited on a preemption signal '
                            '(marker `%s`); continuing from its final '
                            'snapshot.', marker)
                try:
                    os.remove(marker)
                except OSError:
                    pass
        else:
            # the weights alone until train() makes the state
            self.trainer.register_state_memory(
                self.backend.trainable_params)
        # the evaluations train() ran, in order
        self.eval_history: List[dict] = []
        # decode table padded to the table size: padded indices surface
        # only when the vocab is smaller than k, and decode as OOV
        true_decode = self.vocabs.target_vocab.index_to_word_array()
        self._target_index_to_word = np.full(
            self.backend.sizes['target_vocab_size'],
            self.vocabs.target_vocab.special_words.OOV, dtype=object)
        self._target_index_to_word[:true_decode.shape[0]] = true_decode

    def _data_reader(self) -> PathContextReader:
        """A reader of this rank's line stride (the whole split on one
        rank)."""
        if self.mesh is None:
            return PathContextReader(self.vocabs, self.config)
        return PathContextReader(self.vocabs, self.config,
                                 data_index=self.mesh.data_index,
                                 data_count=self.mesh.data)

    @property
    def rank(self) -> int:
        """This process's rank (0 on one rank)."""
        return 0 if self.mesh is None else self.mesh.rank

    @property
    def is_chief(self) -> bool:
        """The rank that writes checkpoints, ``log.txt`` and summaries."""
        return self.mesh is None or self.mesh.rank == self.mesh.ranks[0]

    def _one_rank(self, what: str) -> None:
        if self.mesh is not None:
            raise mesh_lib.MeshUnsupported(what)

    def _agreed_steps(self, steps: int) -> int:
        """``steps`` agreed over the mesh: the least any rank computed."""
        if self.mesh is None:
            return steps
        agreed = torch.tensor([steps], dtype=torch.int64, device=self.device)
        self.mesh.all_reduce(agreed, None, op=torch.distributed.ReduceOp.MIN)
        return int(agreed.item())

    def _store_for(self, path: str) -> CheckpointStore:
        store = self._stores.get(path)
        if store is None:
            config = self.config
            metadata = {
                'param_row_alignment': config.PARAM_ROW_ALIGNMENT,
                # the allocated rows (the fused CE's tile folded in):
                # adapted on restore, not compared
                'target_vocab_rows': table_sizes(
                    config, self.vocabs)['target_vocab_size'],
                'token_dim': config.TOKEN_EMBEDDINGS_SIZE,
                'path_dim': config.PATH_EMBEDDINGS_SIZE,
                'code_dim': config.CODE_VECTOR_SIZE,
                'framework': 'torch'}
            store = CheckpointStore(path, max_to_keep=config.MAX_TO_KEEP,
                                    metadata=metadata)
            self._stores[path] = store
        return store

    def train(self, timings: Optional[list] = None) -> List[float]:
        """Epochs from the one after a restored checkpoint's (else from
        the first) up to NUM_TRAIN_EPOCHS over the train split, from the
        current weights and moments, on BATCH_WIRE_FORMAT's wire. Each
        epoch reads its shuffled batches (``seed=epoch``) from the token
        cache under TRAIN_DATA_CACHE, else through the reader (native
        tokenizer under READER_USE_NATIVE), on a prefetch thread, and
        stages them on the device DEVICE_PREFETCH_BATCHES ahead of the
        step; ``Trainer.fit`` runs the loop. Logs the mean loss every
        NUM_BATCHES_TO_LOG_PROGRESS steps and per epoch; saves every
        SAVE_EVERY_EPOCHS epochs, and a step snapshot every
        SAVE_EVERY_N_STEPS steps, under MODEL_SAVE_PATH; with
        TEST_DATA_PATH evaluates every NUM_TRAIN_BATCHES_TO_EVALUATE steps
        and after each epoch not just evaluated (the results go to
        ``eval_history``); under USE_TENSORBOARD writes the scalars to
        ``summaries/`` beside the model (``metrics_writer.py``). Returns
        the per-epoch mean losses.

        Resilience, as the reference's ``train``: under DIVERGENCE_GUARD
        a non-finite loss window rewinds to the newest checkpoint no newer
        than its first bad step (purging the newer ones) and skips the
        window, or raises ``DivergenceError`` with a dump under
        TELEMETRY_DIR; under HANDLE_PREEMPTION_SIGNALS SIGTERM/SIGINT end
        the run at the next step boundary with one final snapshot and a
        ``PREEMPTED.json`` marker, from which MODEL_LOAD_PATH resumes (on a
        mesh at the next log window's end, agreed by every rank, a signal
        to one rank being enough);
        HANG_WATCHDOG_SECS aborts a hung wait with every thread's stack.

        ``timings``, when given a list, gets ``Trainer.fit``'s dict per
        epoch, the cache build's ``cache_build_s`` and ``cache_bytes`` in
        the first."""
        config = self.config
        if not config.train_data_path:
            raise ValueError('train() needs TRAIN_DATA_PATH_PREFIX')
        if self.state is None:
            self.state = self.trainer.state_from_params()
        cache_info = {}
        local_batch = self.reader.local_batch_size()
        if config.TRAIN_DATA_CACHE:
            t0 = time.perf_counter()
            cache = TokenCache.build_or_load(config, self.vocabs,
                                             self.reader)
            cache_info = {'cache_build_s': time.perf_counter() - t0,
                          'cache_bytes': cache.nbytes}

            def local_batches(epoch: int):
                return cache.iter_epoch(
                    local_batch, shuffle=True, seed=epoch,
                    wire_format=config.BATCH_WIRE_FORMAT)
        else:
            def local_batches(epoch: int):
                return self.reader.iter_epoch(seed=epoch)
        if self.mesh is None:
            def epoch_batches(epoch: int):
                return prefetch_iterator(lambda: local_batches(epoch),
                                         config.READER_PREFETCH_BATCHES)
        else:
            # every rank runs the same number of steps: the whole split's
            # lines over the global batch, agreed over the mesh
            steps_per_epoch = self._agreed_steps(max(
                1, count_lines(config.train_data_path)
                // config.TRAIN_BATCH_SIZE))

            def epoch_batches(epoch: int):
                return prefetch_iterator(
                    lambda: fixed_step_iterator(
                        lambda: local_batches(epoch), steps_per_epoch,
                        self.rank, logger.warning),
                    config.READER_PREFETCH_BATCHES)
        save_store = (self._store_for(config.MODEL_SAVE_PATH)
                      if config.is_saving else None)
        writer = (metrics_writer.maybe_create(config) if self.is_chief
                  else None)

        def on_log(step: int, avg_loss: float, throughput: float) -> None:
            if writer is not None:
                writer.scalar('train/loss', avg_loss, step)
                writer.scalar('train/examples_per_sec', throughput, step)

        def on_epoch_time(epoch: int, batch_num: int, seconds: float
                          ) -> None:
            # on the global step axis, as every other scalar
            if writer is not None:
                writer.scalar('train/epoch_wall_time_s', seconds, batch_num)

        self.eval_history = []
        last_eval_batch = [-1]

        def evaluate_and_log(label: str, step: int) -> None:
            t0 = time.time()
            # a typed badput mark (absorbed into the trainer's own around
            # an interval evaluation)
            with goodput_lib.interval(goodput_lib.KIND_EVAL):
                results = self._evaluate_and_log(label, step)
            if writer is not None:
                writer.scalar('eval/top1_acc', float(results.topk_acc[0]),
                              step)
                writer.scalar('eval/subtoken_f1', results.subtoken_f1, step)
                writer.scalar('eval/subtoken_precision',
                              results.subtoken_precision, step)
                writer.scalar('eval/subtoken_recall',
                              results.subtoken_recall, step)
                writer.scalar('eval/wall_time_s', time.time() - t0, step)
                writer.flush()

        # both save cadences go through one dedupe: an epoch-end save is
        # not repeated by the interval firing at the next epoch's first
        # iteration; a resumed run's restored step counts as saved
        last_saved_step = [int(self.state.step)]

        def save_at(state: TrainerState, last_complete_epoch: int,
                    snapshot: bool = False) -> None:
            if int(state.step) == last_saved_step[0]:
                return
            last_saved_step[0] = int(state.step)
            with goodput_lib.interval(goodput_lib.KIND_CHECKPOINT):
                self.save(state=state, epoch=last_complete_epoch,
                          snapshot=snapshot)

        def on_save_interval(epoch: int, batch_num: int,
                             state: TrainerState) -> None:
            # at the top of an iteration of `epoch`: the last finished
            # epoch is epoch - 1, and a resume restarts this one
            save_at(state, epoch - 1, snapshot=True)

        def on_epoch_end(epoch: int, state: TrainerState,
                         batch_num: int) -> None:
            if save_store is not None and \
                    (epoch + 1) % config.SAVE_EVERY_EPOCHS == 0:
                save_at(state, epoch)
            if config.is_testing and last_eval_batch[0] != batch_num:
                last_eval_batch[0] = batch_num
                evaluate_and_log('epoch %d' % (epoch + 1), batch_num)

        def on_eval_interval(batch_num: int, state: TrainerState) -> None:
            last_eval_batch[0] = batch_num
            evaluate_and_log('batch %d' % batch_num, batch_num)

        preemption = (PreemptionHandler()
                      if config.HANDLE_PREEMPTION_SIGNALS else None)
        # the fit loop stopped on a signal (on a mesh: agreed by its ranks)
        preempted = [False]

        def on_preempt(epoch: int, batch_num: int,
                       state: TrainerState) -> None:
            preempted[0] = True
            if writer is not None:
                writer.flush()
            if save_store is None:
                logger.info('Preemption: no MODEL_SAVE_PATH, exiting '
                            'without a snapshot.')
                return
            t0 = time.time()
            save_at(state, epoch - 1, snapshot=True)
            save_s = time.time() - t0
            if tele_core.enabled():
                tele_core.registry().gauge(
                    'resilience/preempt_save_s').set(save_s)
            # a fresh run preempted before its first step saved nothing:
            # no marker, or --load would fail
            step = int(state.step)
            if not save_store.has_step(step):
                logger.info('Preemption at step %d: no completed step to '
                            'snapshot (nothing newer than the run\'s '
                            'start); exiting without a resume marker.',
                            step)
                return
            if not self.is_chief:
                return
            marker = os.path.join(save_store.snapshot_dir,
                                  PREEMPTED_MARKER)
            try:
                os.makedirs(save_store.snapshot_dir, exist_ok=True)
                with open(marker, 'w') as f:
                    json.dump({'step': step,
                               'last_complete_epoch': epoch - 1,
                               'time': time.time()}, f)
            except OSError as exc:
                logger.warning('Preemption: could not write `%s` (%s)',
                               marker, exc)
            logger.info('Preemption save complete at step %d (%.2fs); '
                        'resume with --load %s', step, save_s,
                        config.MODEL_SAVE_PATH)

        def on_divergence(last_good_step: int) -> Optional[TrainerState]:
            """The newest restorable checkpoint across the epoch saves and
            the step snapshots, no newer than the guard's last finite
            step."""
            if save_store is None:
                return None
            try:
                restored = save_store.restore_training(
                    max_step=last_good_step)
            except Exception as exc:    # no readable step: the guard raises
                logger.warning('Divergence rewind: no checkpoint '
                               'restorable (%s).', exc)
                return None
            if restored is None:
                return None
            # steps newer than the target were saved inside the poisoned
            # window; the re-trained ones are saved again (by rank 0, once
            # every rank has read its state)
            if self.mesh is not None:
                self.mesh.barrier()
            if self.is_chief:
                save_store.purge_steps_newer_than(restored.step)
            if self.mesh is not None:
                self.mesh.barrier()
            last_saved_step[0] = restored.step
            return self.trainer.state_from_restored(
                restored.params, restored.opt_state, restored.step)

        start = len(timings) if timings is not None else 0
        try:
            with (preemption if preemption is not None
                  else contextlib.nullcontext()):
                self.state, epoch_losses = self.trainer.fit(
                    self.state, epoch_batches, start_epoch=self._start_epoch,
                    on_epoch_end=on_epoch_end, on_log=on_log,
                    on_eval_interval=(on_eval_interval
                                      if config.is_testing else None),
                    on_save_interval=(on_save_interval
                                      if save_store is not None else None),
                    on_epoch_time=on_epoch_time, preemption=preemption,
                    on_preempt=on_preempt, on_divergence=on_divergence,
                    on_hang=writer.flush if writer is not None else None,
                    timings=timings)
        finally:
            if writer is not None:
                writer.close()
        if timings is not None and len(timings) > start:
            timings[start].update(cache_info)
        if preempted[0]:
            logger.info('Training stopped early by %s after a '
                        'preemption-safe snapshot; remaining epochs were '
                        'skipped.', preemption.signal_name or 'a sibling '
                        'rank\'s signal')
        return epoch_losses

    def save(self, model_save_path: Optional[str] = None,
             epoch: int = 0, state: Optional[TrainerState] = None,
             snapshot: bool = False) -> None:
        """The vocabulary sidecar and the full training state (the
        reference's model_api.py:548-568): ``state``, by default the
        model's; ``epoch`` is the last completed epoch, where a resume
        continues after. ``snapshot`` saves into the step-snapshot
        directory (SAVE_EVERY_N_STEPS' short retention)."""
        path = model_save_path or self.config.MODEL_SAVE_PATH
        if not path:
            raise ValueError('save() needs a path or MODEL_SAVE_PATH')
        state = state if state is not None else self.state
        if state is None:
            raise ValueError('save() needs a training state: train() first, '
                             'or load with TRAIN_DATA_PATH_PREFIX as well')
        names = Code2VecParams._fields
        t0 = time.perf_counter()
        params = dict(zip(names, state.params))
        # under ZeRO the moments' sub-slices gathered over each data
        # column first (every rank)
        opt_state = self.trainer.named_opt_state(state.opt_state)
        if self.mesh is not None:
            # whole tables, gathered by the first data row and written by
            # rank 0 alone: a checkpoint does not depend on the topology
            # or the moments' layout
            if self.mesh.data_index == 0:
                params = self.mesh.gather_params(params)
                opt_state = map_opt_state(opt_state,
                                          self.mesh.gather_params)
            if not self.is_chief:
                self.mesh.barrier()
                return
        save_dir = os.path.dirname(path)
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
        self.vocabs.save(Config.get_vocabularies_path_from_model_path(path))
        self._store_for(path).save_training(
            params=params, opt_state=opt_state, step=state.step,
            epoch=epoch, snapshot=snapshot)
        if self.mesh is not None:
            self.mesh.barrier()
        logger.info('Saved %s step %d (epoch %d) under `%s` in %.2f s',
                    'snapshot' if snapshot else 'checkpoint', state.step,
                    epoch + 1, path, time.perf_counter() - t0)

    def release_model(self) -> None:
        """The params-only artifact ``<MODEL_LOAD_PATH>__only-weights``
        (the reference's model_api.py:570-578)."""
        if not self.config.is_loading:
            raise ValueError('release_model() needs MODEL_LOAD_PATH')
        params = self.backend.gathered_params()._asdict()
        if self.is_chief:
            self._store_for(self.config.MODEL_LOAD_PATH).save_release(params)
        if self.mesh is not None:
            self.mesh.barrier()
        logger.info('Released model saved under `%s__only-weights`.',
                    self.config.MODEL_LOAD_PATH)

    def get_vocab_embedding_as_np_array(self, vocab_type: VocabType
                                        ) -> np.ndarray:
        """The vocabulary's embedding table on the host, exactly
        ``vocab.size`` rows (the alignment padding sliced off); on a mesh
        gathered whole (every rank of a data row calls it)."""
        params = self.backend.gathered_params()
        table = {VocabType.Token: params.token_embedding,
                 VocabType.Target: params.target_embedding,
                 VocabType.Path: params.path_embedding}[vocab_type]
        size = self.vocabs.get(vocab_type).size
        return table[:size].detach().float().cpu().numpy()

    def save_word2vec_format(self, dest_save_path: str,
                             vocab_type: VocabType) -> None:
        """The table in word2vec text format (the reference's
        model_api.py:866-891, byte for byte from the same weights)."""
        matrix = self.get_vocab_embedding_as_np_array(vocab_type)
        if not self.is_chief:
            return
        index_to_word = self.vocabs.get(vocab_type).index_to_word
        with open(dest_save_path, 'w') as words_file:
            common.save_word2vec_file(words_file, index_to_word, matrix)
        logger.info('Saved %s embeddings to `%s`.', vocab_type.name,
                    dest_save_path)

    def _evaluate_and_log(self, label: str, step: int
                          ) -> 'ModelEvaluationResults':
        results = self.evaluate()
        self.eval_history.append({
            'label': label, 'step': step,
            'topk_acc': [float(x) for x in results.topk_acc],
            'precision': results.subtoken_precision,
            'recall': results.subtoken_recall,
            'f1': results.subtoken_f1, 'loss': results.loss})
        logger.info('After %s: %s', label, results)
        return results

    def evaluate(self) -> ModelEvaluationResults:
        """The test split (TEST_DATA_PATH) through the eval step, in file
        order, in batches of TEST_BATCH_SIZE on BATCH_WIRE_FORMAT's wire:
        top-k accuracy and subtoken precision/recall/F1 of the decoded
        top-k words, and the mean CE (``loss_sum / weight_sum``). Writes a
        per-example ``log.txt`` where the reference does (beside the model
        saved or loaded, else into the working directory), and the code
        vectors to ``TEST_DATA_PATH.vectors`` under EXPORT_CODE_VECTORS."""
        config = self.config
        if not config.is_testing:
            raise ValueError('evaluate() needs TEST_DATA_PATH')
        # a reader of its own: the test split's sticky packed capacity
        reader = self._data_reader()
        oov = self.vocabs.target_vocab.special_words.OOV
        topk_metric = TopKAccuracyEvaluationMetric(
            config.TOP_K_WORDS_CONSIDERED_DURING_PREDICTION, oov)
        subtoken_metric = SubtokensEvaluationMetric(oov)
        vectors_path = config.TEST_DATA_PATH + '.vectors'
        # the per-example log beside the model saved or loaded, as the
        # reference writes it; else in the working directory
        if config.is_saving:
            log_dir = os.path.dirname(config.MODEL_SAVE_PATH)
        elif config.is_loading:
            log_dir = config.model_load_dir
        else:
            log_dir = ''
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        # rank r > 0 of a mesh logs its own shard beside rank 0's
        suffix = '' if self.is_chief else '.proc%d' % self.rank
        vectors_path += suffix
        batches = reader.iter_epoch_prefetched(evaluate=True)
        if self.mesh is not None:
            # every rank runs the agreed number of steps; a short shard
            # pads with zero-weight batches, which count nowhere
            fixed_steps = self._agreed_steps(-(-count_lines(
                config.TEST_DATA_PATH) // config.TEST_BATCH_SIZE))
            batches = self._fixed_eval_batches(reader, batches, fixed_steps)
        total = 0
        loss_sum = 0.0
        weight_sum = 0.0
        start_time = time.time()
        with contextlib.ExitStack() as files:
            log_file = files.enter_context(
                open(os.path.join(log_dir, 'log.txt' + suffix), 'w'))
            vectors_file = (files.enter_context(open(vectors_path, 'w'))
                            if config.EXPORT_CODE_VECTORS else None)

            def consume(out, batch) -> None:
                nonlocal total, loss_sum, weight_sum
                fetched = {key: mesh_lib.local_rows(value)
                           for key, value in out.items()}
                loss_sum += float(fetched['loss_sum'])
                weight_sum += float(fetched['weight_sum'])
                results = decode_topk_batch(
                    fetched['topk_indices'], self._target_index_to_word,
                    batch.label_strings, batch.weight)
                topk_metric.update_batch(results)
                subtoken_metric.update_batch(results)
                self._log_predictions_during_evaluation(results, log_file)
                if vectors_file is not None:
                    valid = batch.weight > 0
                    for vec in fetched['code_vectors'][valid]:
                        vectors_file.write(' '.join(map(str, vec)) + '\n')
                total += len(results)
                if total and total % (
                        config.NUM_BATCHES_TO_LOG_PROGRESS
                        * config.TEST_BATCH_SIZE) < config.TEST_BATCH_SIZE:
                    elapsed = time.time() - start_time
                    logger.info('Evaluated %d examples... (%d samples/sec)',
                                total, int(total / max(elapsed, 1e-9)))

            # one step ahead: batch k + 1 is on the device while the host
            # decodes batch k; the reader runs on its prefetch thread and
            # the staging ring copies the next batches up meanwhile
            pending = None
            with contextlib.closing(
                    self.trainer.stage_batches(batches)) as staged:
                for arrays, batch in staged:
                    out = self.trainer.eval_step_placed(arrays)
                    if pending is not None:
                        consume(*pending)
                    pending = (out, batch)
            if pending is not None:
                consume(*pending)
        if vectors_file is not None:
            logger.info('Code vectors written to `%s`.', vectors_path)
        if self.mesh is not None:
            # each data shard counted its own examples: the raw counts and
            # the CE sums summed over the model column, exactly (the
            # ranks of a data row hold the same counts)
            topk_len = topk_metric.count_vector().shape[0]
            merged = torch.tensor(np.concatenate([
                [loss_sum, weight_sum], topk_metric.count_vector(),
                subtoken_metric.count_vector()]), dtype=torch.float64,
                device=self.device)
            merged = self.mesh.all_reduce(
                merged, mesh_lib.DATA_AXIS).cpu().numpy()
            loss_sum, weight_sum = float(merged[0]), float(merged[1])
            counts = np.rint(merged[2:]).astype(np.int64)
            topk_metric.set_count_vector(counts[:topk_len])
            subtoken_metric.set_count_vector(counts[topk_len:])
        return ModelEvaluationResults(
            topk_acc=topk_metric.topk_correct_predictions,
            subtoken_precision=subtoken_metric.precision,
            subtoken_recall=subtoken_metric.recall,
            subtoken_f1=subtoken_metric.f1,
            loss=(loss_sum / weight_sum) if weight_sum > 0 else None)

    def _fixed_eval_batches(self, reader: PathContextReader, batches,
                            fixed_steps: int):
        """``batches`` then zero-weight ones up to ``fixed_steps`` (the
        reference's multi-process evaluation): a shard that filtered down
        shorter than its peers still takes every step."""
        steps = 0
        for batch in batches:
            steps += 1
            if steps > fixed_steps:
                raise RuntimeError(
                    'Rank %d produced more eval batches (%d) than the agreed '
                    'step count (%d); filtering only shrinks shards, so the '
                    'test file changed meanwhile.'
                    % (self.rank, steps, fixed_steps))
            yield batch
        pad = reader.empty_batch(reader.local_batch_size(evaluate=True))
        for _ in range(fixed_steps - steps):
            yield pad

    def _log_predictions_during_evaluation(self, results,
                                           output_file) -> None:
        """Per-example prediction log (reference
        tensorflow_model.py:411-422)."""
        oov = self.vocabs.target_vocab.special_words.OOV
        for original_name, top_words in results:
            found_match = common.get_first_match_word_from_top_predictions(
                oov, original_name, top_words)
            if found_match is not None:
                prediction_idx, predicted_word = found_match
                if prediction_idx == 0:
                    output_file.write('Original: ' + original_name
                                      + ', predicted 1st: ' + predicted_word
                                      + '\n')
                else:
                    output_file.write('\t\t predicted correctly at rank: '
                                      + str(prediction_idx + 1) + '\n')
            else:
                output_file.write('No results for predicting: '
                                  + original_name + '\n')

    def predict(self, predict_data_lines: Iterable[str],
                tier: Optional[str] = None) -> List[ModelPredictionResults]:
        """Raw ``label src,path,tgt ...`` lines -> one result per line.
        ``tier`` picks the outputs (serving/steps.py); by default
        'attention', or 'full' when EXPORT_CODE_VECTORS is set. The batch
        pads to the serving ladder's bucket (rounded to the data axis).
        On a mesh every rank passes the same lines, runs its data shard
        (packed at its own capacity) and returns the same results."""
        from code2vec_tpu_torch.serving import bulk
        mesh_lib.require_one_host(self.mesh, 'predict')
        lines = list(predict_data_lines)
        if not lines:
            return []
        batch = self.reader.process_input_rows(lines)
        data = 1 if self.mesh is None else self.mesh.data
        ladder = engine_lib.batch_ladder(self.config.serving_batch_buckets,
                                         data)
        padded_size = engine_lib.pick_bucket(len(lines), ladder)
        batch = self.reader.pad_batch_to(
            batch, padded_size or -(-len(lines) // data) * data)
        (shard,) = bulk.wire_shards(self, [batch], sticky=False)
        arrays = tuple(torch.from_numpy(a).to(self.device)
                       for a in shard.device_arrays())
        if tier is None:
            tier = 'full' if self.config.EXPORT_CODE_VECTORS else 'attention'
        out = predict_step(self.backend, arrays, tier=tier)
        return engine_lib.decode_results(bulk.gather_outputs(self, out),
                                         batch, len(lines),
                                         self._target_index_to_word)

    def _serving_param_source(self) -> Optional['ServingParamSource']:
        """The serving engine's checkpoint-backed parameter source (its
        ``load_params(step|path)`` and ``follow_checkpoints``): the
        model's load path, or the save path of a model that saves; None
        for a model with neither."""
        path = (self.config.MODEL_LOAD_PATH if self.config.is_loading
                else self.config.MODEL_SAVE_PATH
                if self.config.is_saving else None)
        if path is None:
            return None
        return ServingParamSource(self, self._store_for(path))

    def serving_engine(self, tiers=None, warmup: bool = True, **overrides):
        """A ``ServingEngine`` over this model's weights: micro-batching
        over the ladder of CUDA graphs (``serving/engine.py``).
        ``warmup=False`` defers the captures to the first ``submit``.
        ``overrides`` are the engine's keyword arguments (``max_delay_ms``,
        ``queue_bound``, ``param_slots``, ...).

        The engine is armed for canaried rollover against the model's
        checkpoint path (two parameter slots captured); with
        SERVE_FOLLOW_CHECKPOINTS_SECS > 0 it also polls that path and
        rolls newer steps in."""
        from code2vec_tpu_torch.serving.engine import ServingEngine
        self._one_rank('the serving engine')
        if 'param_source' in overrides:
            param_source = overrides.pop('param_source')
        else:
            param_source = self._serving_param_source()
        if 'params_step' not in overrides:
            # the follow poller's baseline: the step the weights came from
            if self.state is not None:
                overrides['params_step'] = int(self.state.step)
            elif param_source is not None:
                overrides['params_step'] = param_source.newest_step()
        engine = ServingEngine(
            self.config, self.backend, self.backend.params, self.vocabs,
            decode_table=self._target_index_to_word, tiers=tiers,
            param_source=param_source, log=logger.info, **overrides)
        try:
            if warmup:
                engine.warmup()
            if self.config.SERVE_FOLLOW_CHECKPOINTS_SECS > 0:
                engine.follow_checkpoints()
        except BaseException:
            # the caller gets the exception, not the engine: stop it here
            engine.close()
            raise
        return engine

    def serving_mesh(self, replicas=None, tiers=None, warmup: bool = True,
                     **overrides):
        """A ``ServingMesh`` over this model (``serving/mesh.py``):
        ``replicas`` (default MESH_REPLICAS) engine replicas on the model's
        device behind one shared front queue, each with its own ladder of
        CUDA graphs, with the memo and SLO tiers and coordinated canaried
        rollover. ``overrides`` are the mesh's keyword arguments
        (``max_delay_ms``, ``queue_bound``, ``memo_cache_bytes``, the
        heartbeat and restart knobs, ...). With SERVE_FOLLOW_CHECKPOINTS_SECS
        > 0 the mesh polls the checkpoints and rolls the fleet as a unit.

        ``mode`` (default MESH_REPLICA_MODE) seats the replicas: 'thread',
        engines of this process; 'process', one spawned worker process per
        replica on the framed wire over a pipe; 'socket', the same wire
        over TCP. A worker is a process of the port with its own CUDA
        context, model and ladder, on this model's device; it restores
        the weights from this model's checkpoint path, so the worker modes
        need a model with a load or save path and a retained step, and
        roll over from steps or paths only. They heartbeat, redispatch a
        crashed worker's batches once and restart it under a budget.

        A replica that fails to build, start or warm fails the call with
        its reason (a worker's cold start included): the mesh never runs
        with fewer replicas than asked for. AUTOSCALE_MAX_REPLICAS > 0 arms
        the autoscaler (``serving/autoscaler.py``); in socket mode the mesh
        adopts workers started outside it
        (``python -m code2vec_tpu_torch.serving.mesh_worker``)."""
        from code2vec_tpu_torch.serving.mesh import ServingMesh
        self._one_rank('the serving mesh')
        mesh = ServingMesh(self, replicas=replicas, tiers=tiers,
                           log=logger.info, **overrides)
        try:
            if warmup:
                mesh.warmup()
            if self.config.SERVE_FOLLOW_CHECKPOINTS_SECS > 0:
                mesh.follow_checkpoints()
        except BaseException:
            # the caller gets the exception, not the mesh: stop it here
            mesh.close()
            raise
        return mesh


class ServingParamSource:
    """Resolves ``ServingEngine.load_params(step|path)`` and
    ``newest_step()`` polls against a model's checkpoints: a retained
    step of the model's own store, or another model path, restored
    through ``checkpoints.py`` and returned on the model's device in the
    compute dtype (the shapes of the engine's parameter slots)."""

    def __init__(self, model: Code2VecModel, store: CheckpointStore):
        self._model = model
        self._store = store

    def load(self, source) -> Code2VecParams:
        if isinstance(source, int) and not isinstance(source, bool):
            params = self._store.restore_params_step(source)
        else:
            params = self._model._store_for(str(source)).restore_params()
            if params is None:
                raise ValueError('No checkpoint found under `%s`.'
                                 % source)
        return self._model.backend.to_compute(Code2VecParams(**params))

    def newest_step(self) -> Optional[int]:
        return self._store.newest_step()
