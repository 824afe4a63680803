"""``Code2VecModel``: the port's user-facing model for training,
evaluation, serving predictions and its checkpoints (the paths of
``code2vec_tpu/model_api.py``).

    model = Code2VecModel(config)                 # on config.DEVICE (cuda)
    model = Code2VecModel(config, device='cpu')   # plain versions, CPU
    model.train()                                 # epochs over .train.c2v
    results = model.evaluate()                    # over TEST_DATA_PATH
    results = model.predict(lines)                # raw path-context lines
    model.save()                                  # MODEL_SAVE_PATH
    model.release_model()                         # MODEL_LOAD_PATH, params only

Construction loads or creates the weights: with MODEL_LOAD_PATH the
vocabularies come from the ``dictionaries.bin`` beside it and the
weights from its checkpoints (``checkpoints.py``; the reference's orbax
checkpoints too) — the full training state when TRAIN_DATA_PATH_PREFIX
is set as well (training resumes at the epoch after the saved one),
params only otherwise; without it, from ``params`` or drawn from
``seed``.

``train`` reads ``TRAIN_DATA_PATH_PREFIX.train.c2v`` as shuffled packed
batches (from the token cache under TRAIN_DATA_CACHE, else tokenized
each epoch; a prefetch thread either way), stages them on the device
ahead of the steps (``Trainer.stage_batches``) and trains up to
NUM_TRAIN_EPOCHS, logs the loss, saves
every SAVE_EVERY_EPOCHS epochs when MODEL_SAVE_PATH is set and, when
TEST_DATA_PATH is set, evaluates every NUM_TRAIN_BATCHES_TO_EVALUATE
steps and after each epoch. ``evaluate`` runs the eval step over the test
split on BATCH_WIRE_FORMAT's wire (read on a prefetch thread and staged
ahead of the steps) and scores the top-k words on the host;
like the reference it writes a per-example ``log.txt`` beside the model
it saves or loads, else into the working directory. ``predict``
tokenizes the lines, pads the batch to the serving bucket ladder, packs
it onto the wire (one shard) under 'packed', runs the predict step on
the model's device and decodes the result on the host.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from code2vec_tpu_torch import common
from code2vec_tpu_torch.checkpoints import CheckpointStore
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data import packed as packed_lib
from code2vec_tpu_torch.data.cache import TokenCache
from code2vec_tpu_torch.data.reader import (PathContextReader,
                                            prefetch_iterator)
from code2vec_tpu_torch.device import resolve_device
from code2vec_tpu_torch.metrics import (SubtokensEvaluationMetric,
                                        TopKAccuracyEvaluationMetric,
                                        decode_topk_batch)
from code2vec_tpu_torch.models.backends import TorchBackend, table_sizes
from code2vec_tpu_torch.models.functional import Code2VecParams
from code2vec_tpu_torch.ops import lazy_adam
from code2vec_tpu_torch.serving import engine as engine_lib
from code2vec_tpu_torch.serving.steps import predict_step
from code2vec_tpu_torch.training.trainer import Trainer, TrainerState
from code2vec_tpu_torch.vocab import Code2VecVocabs, VocabType

logger = logging.getLogger(__name__)


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
                 params: Optional[Code2VecParams] = None, seed: int = 0):
        """Vocabularies and weights as the module docstring says;
        ``params`` (``convert.py`` carries a set across) or ``seed`` make
        the weights of a model that loads none. ``device`` defaults to
        ``config.DEVICE`` ('cuda') and raises without a GPU."""
        config.verify()
        self.config = config
        self.device = resolve_device(device if device is not None
                                     else config.DEVICE)
        self.vocabs = Code2VecVocabs(config)
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
        self.backend = TorchBackend(config, self.vocabs, self.device,
                                    params=params, seed=seed)
        self.reader = PathContextReader(self.vocabs, config)
        self.trainer = Trainer(config, self.backend)
        if restored is not None:
            self.state = self.trainer.state_from_restored(
                None, restored.opt_state, restored.step)
            self._start_epoch = restored.epoch + 1
            logger.info('Resumed from `%s` at epoch %d (step %d)',
                        config.MODEL_LOAD_PATH, restored.epoch,
                        restored.step)
        # the evaluations train() ran, in order
        self.eval_history: List[dict] = []
        # decode table padded to the table size: padded indices surface
        # only when the vocab is smaller than k, and decode as OOV
        true_decode = self.vocabs.target_vocab.index_to_word_array()
        self._target_index_to_word = np.full(
            self.backend.sizes['target_vocab_size'],
            self.vocabs.target_vocab.special_words.OOV, dtype=object)
        self._target_index_to_word[:true_decode.shape[0]] = true_decode

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
        current weights and moments. Each epoch reads its shuffled packed
        batches (``seed=epoch``) from the token cache under
        TRAIN_DATA_CACHE, else through the reader (native tokenizer under
        READER_USE_NATIVE), on a prefetch thread, and stages them on the
        device DEVICE_PREFETCH_BATCHES ahead of the step. Logs the mean
        loss every NUM_BATCHES_TO_LOG_PROGRESS steps and per epoch; saves
        every SAVE_EVERY_EPOCHS epochs under MODEL_SAVE_PATH; with
        TEST_DATA_PATH evaluates every NUM_TRAIN_BATCHES_TO_EVALUATE steps
        and after each epoch not just evaluated (the results go to
        ``eval_history``). Returns the per-epoch mean losses. Trains on the
        packed wire with USE_PALLAS_RAGGED_FUSION only.

        ``timings``, when given a list, gets one dict per epoch: its
        ``seconds``, the host seconds the training thread waited for each
        next staged batch (``wait_s``) and, on the card, the device
        milliseconds between consecutive steps' ends (``interval_ms``,
        CUDA events) and the cache build's ``cache_build_s`` and
        ``cache_bytes`` in the first."""
        config = self.config
        if not config.train_data_path:
            raise ValueError('train() needs TRAIN_DATA_PATH_PREFIX')
        if config.BATCH_WIRE_FORMAT != 'packed' or \
                not config.USE_PALLAS_RAGGED_FUSION:
            raise NotImplementedError(
                "train() runs on BATCH_WIRE_FORMAT='packed' with "
                'USE_PALLAS_RAGGED_FUSION=True only: the plane-wire train '
                'step and the unpack-then-dense route are not ported yet '
                '(got %r, %r)' % (config.BATCH_WIRE_FORMAT,
                                  config.USE_PALLAS_RAGGED_FUSION))
        if self.state is None:
            self.state = self.trainer.state_from_params()
        cache_info = {}
        if config.TRAIN_DATA_CACHE:
            t0 = time.perf_counter()
            cache = TokenCache.build_or_load(config, self.vocabs,
                                             self.reader)
            cache_info = {'cache_build_s': time.perf_counter() - t0,
                          'cache_bytes': cache.nbytes}

            def epoch_batches(epoch: int):
                return prefetch_iterator(
                    lambda: cache.iter_epoch(config.TRAIN_BATCH_SIZE,
                                             shuffle=True, seed=epoch,
                                             wire_format='packed'),
                    config.READER_PREFETCH_BATCHES)
        else:
            def epoch_batches(epoch: int):
                return self.reader.iter_epoch_prefetched(seed=epoch)
        record_steps = timings is not None and self.device.type == 'cuda'
        every = config.NUM_BATCHES_TO_LOG_PROGRESS
        eval_every = config.NUM_TRAIN_BATCHES_TO_EVALUATE
        epoch_losses = []
        self.eval_history = []
        last_eval_step = -1
        for epoch in range(self._start_epoch, config.NUM_TRAIN_EPOCHS):
            t0 = time.perf_counter()
            losses, waits, step_ends = [], [], []
            with contextlib.closing(self.trainer.stage_batches(
                    epoch_batches(epoch))) as staged:
                t_wait = time.perf_counter()
                for arrays, _batch in staged:
                    waits.append(time.perf_counter() - t_wait)
                    self.state, loss = self.trainer.train_step_placed(
                        self.state, arrays)
                    if record_steps:
                        step_ends.append(torch.cuda.Event(
                            enable_timing=True))
                        step_ends[-1].record()
                    losses.append(loss)
                    step = self.state.step
                    if len(losses) % every == 0:
                        recent = float(torch.stack(losses[-every:]).mean())
                        logger.info('epoch %d step %d: loss %.5f',
                                    epoch + 1, step, recent)
                    # mid-epoch evaluation (the reference's
                    # ModelEvaluationCallback, keras_model.py:326-345)
                    if config.is_testing and eval_every and \
                            step % eval_every == 0:
                        last_eval_step = step
                        self._evaluate_and_log('batch %d' % step, step)
                    t_wait = time.perf_counter()
            if not losses:
                raise ValueError('no training examples in %s'
                                 % config.train_data_path)
            mean = float(torch.stack(losses).mean())
            epoch_losses.append(mean)
            seconds = time.perf_counter() - t0
            logger.info('epoch %d: %d steps, mean loss %.5f, %.1f s',
                        epoch + 1, len(losses), mean, seconds)
            if timings is not None:
                timings.append(dict(
                    cache_info, epoch=epoch, steps=len(losses),
                    seconds=seconds, wait_s=waits,
                    interval_ms=[a.elapsed_time(b) for a, b in
                                 zip(step_ends, step_ends[1:])]))
                cache_info = {}
            if config.is_saving and \
                    (epoch + 1) % config.SAVE_EVERY_EPOCHS == 0:
                self.save(epoch=epoch)
            if config.is_testing and last_eval_step != self.state.step:
                last_eval_step = self.state.step
                self._evaluate_and_log('epoch %d' % (epoch + 1),
                                       self.state.step)
        return epoch_losses

    def save(self, model_save_path: Optional[str] = None,
             epoch: int = 0) -> None:
        """The vocabulary sidecar and the full training state (the
        reference's model_api.py:548-568); ``epoch`` is the last completed
        epoch, where a resume continues after."""
        path = model_save_path or self.config.MODEL_SAVE_PATH
        if not path:
            raise ValueError('save() needs a path or MODEL_SAVE_PATH')
        if self.state is None:
            raise ValueError('save() needs a training state: train() first, '
                             'or load with TRAIN_DATA_PATH_PREFIX as well')
        save_dir = os.path.dirname(path)
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
        self.vocabs.save(Config.get_vocabularies_path_from_model_path(path))
        state = self.state
        names = Code2VecParams._fields
        t0 = time.perf_counter()
        self._store_for(path).save_training(
            params=dict(zip(names, state.params)),
            opt_state=lazy_adam.named_state(state.opt_state),
            step=state.step, epoch=epoch)
        logger.info('Saved step %d (epoch %d) under `%s` in %.2f s',
                    state.step, epoch + 1, path, time.perf_counter() - t0)

    def release_model(self) -> None:
        """The params-only artifact ``<MODEL_LOAD_PATH>__only-weights``
        (the reference's model_api.py:570-578)."""
        if not self.config.is_loading:
            raise ValueError('release_model() needs MODEL_LOAD_PATH')
        self._store_for(self.config.MODEL_LOAD_PATH).save_release(
            self.backend.params._asdict())
        logger.info('Released model saved under `%s__only-weights`.',
                    self.config.MODEL_LOAD_PATH)

    def get_vocab_embedding_as_np_array(self, vocab_type: VocabType
                                        ) -> np.ndarray:
        """The vocabulary's embedding table on the host, exactly
        ``vocab.size`` rows (the alignment padding sliced off)."""
        params = self.backend.params
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
        index_to_word = self.vocabs.get(vocab_type).index_to_word
        with open(dest_save_path, 'w') as words_file:
            common.save_word2vec_file(words_file, index_to_word, matrix)
        logger.info('Saved %s embeddings to `%s`.', vocab_type.name,
                    dest_save_path)

    def _evaluate_and_log(self, label: str, step: int) -> None:
        results = self.evaluate()
        self.eval_history.append({
            'label': label, 'step': step,
            'topk_acc': [float(x) for x in results.topk_acc],
            'precision': results.subtoken_precision,
            'recall': results.subtoken_recall,
            'f1': results.subtoken_f1, 'loss': results.loss})
        logger.info('After %s: %s', label, results)

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
        reader = PathContextReader(self.vocabs, config)
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
        total = 0
        loss_sum = 0.0
        weight_sum = 0.0
        start_time = time.time()
        with contextlib.ExitStack() as files:
            log_file = files.enter_context(
                open(os.path.join(log_dir, 'log.txt'), 'w'))
            vectors_file = (files.enter_context(open(vectors_path, 'w'))
                            if config.EXPORT_CODE_VECTORS else None)

            def consume(out, batch) -> None:
                nonlocal total, loss_sum, weight_sum
                fetched = {key: value.cpu().numpy()
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
            with contextlib.closing(self.trainer.stage_batches(
                    reader.iter_epoch_prefetched(evaluate=True))) as staged:
                for arrays, batch in staged:
                    out = self.trainer.eval_step_placed(arrays)
                    if pending is not None:
                        consume(*pending)
                    pending = (out, batch)
            if pending is not None:
                consume(*pending)
        if vectors_file is not None:
            logger.info('Code vectors written to `%s`.', vectors_path)
        return ModelEvaluationResults(
            topk_acc=topk_metric.topk_correct_predictions,
            subtoken_precision=subtoken_metric.precision,
            subtoken_recall=subtoken_metric.recall,
            subtoken_f1=subtoken_metric.f1,
            loss=(loss_sum / weight_sum) if weight_sum > 0 else None)

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
        'attention', or 'full' when EXPORT_CODE_VECTORS is set."""
        lines = list(predict_data_lines)
        if not lines:
            return []
        batch = self.reader.process_input_rows(lines)
        ladder = engine_lib.batch_ladder(self.config.serving_batch_buckets,
                                         1)
        padded_size = engine_lib.pick_bucket(len(lines), ladder)
        batch = self.reader.pad_batch_to(batch, padded_size or len(lines))
        wire = batch
        if self.config.BATCH_WIRE_FORMAT == 'packed':
            wire = packed_lib.pack_batch(batch, self.backend.token_pad_index,
                                         self.backend.path_pad_index,
                                         data_shards=1)
        arrays = tuple(torch.from_numpy(a).to(self.device)
                       for a in wire.device_arrays())
        if tier is None:
            tier = 'full' if self.config.EXPORT_CODE_VECTORS else 'attention'
        out = predict_step(self.backend, arrays, tier=tier)
        fetched = {key: value.cpu().numpy() for key, value in out.items()}
        return engine_lib.decode_results(fetched, batch, len(lines),
                                         self._target_index_to_word)
