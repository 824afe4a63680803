"""``Code2VecModel``: the port's user-facing model for training,
evaluation and serving predictions (the train, evaluate and predict paths
of ``code2vec_tpu/model_api.py``).

    model = Code2VecModel(config)                 # on cuda
    model = Code2VecModel(config, device='cpu')   # plain versions, CPU
    model.train()                                 # epochs over .train.c2v
    results = model.evaluate()                    # over TEST_DATA_PATH
    results = model.predict(lines)                # raw path-context lines

``train`` streams ``TRAIN_DATA_PATH_PREFIX.train.c2v`` as shuffled packed
batches through the trainer for NUM_TRAIN_EPOCHS, logs the loss and,
when TEST_DATA_PATH is set, evaluates after each epoch (no checkpoints
yet). ``evaluate`` runs the eval step over the test split on
BATCH_WIRE_FORMAT's wire and scores the top-k words on the host; like the
reference it writes a per-example ``log.txt`` into the working
directory. ``predict`` tokenizes the lines, pads the batch to the serving
bucket ladder, packs it onto the wire (one shard) under 'packed', runs
the predict step on the model's device and decodes the result on the
host.
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from code2vec_tpu_torch import common
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data import packed as packed_lib
from code2vec_tpu_torch.data.reader import PathContextReader
from code2vec_tpu_torch.device import resolve_device
from code2vec_tpu_torch.metrics import (SubtokensEvaluationMetric,
                                        TopKAccuracyEvaluationMetric,
                                        decode_topk_batch)
from code2vec_tpu_torch.models.backends import TorchBackend
from code2vec_tpu_torch.models.functional import Code2VecParams
from code2vec_tpu_torch.serving import engine as engine_lib
from code2vec_tpu_torch.serving.steps import predict_step
from code2vec_tpu_torch.training.trainer import Trainer, TrainerState
from code2vec_tpu_torch.vocab import Code2VecVocabs

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
        """Vocabularies from ``config``'s ``.dict.c2v``; weights from
        ``params`` (``convert.load_npz`` reads a saved set) or drawn from
        ``seed``. ``device`` defaults to ``cuda`` and raises without a
        GPU."""
        config.verify()
        self.config = config
        self.device = resolve_device(device)
        self.vocabs = Code2VecVocabs(config)
        self.backend = TorchBackend(config, self.vocabs, self.device,
                                    params=params, seed=seed)
        self.reader = PathContextReader(self.vocabs, config)
        self.trainer = Trainer(config, self.backend)
        # training state over the backend's weights, made by train()
        self.state: Optional[TrainerState] = None
        # the evaluations train() ran after each epoch, in order
        self.eval_history: List[dict] = []
        # decode table padded to the table size: padded indices surface
        # only when the vocab is smaller than k, and decode as OOV
        true_decode = self.vocabs.target_vocab.index_to_word_array()
        self._target_index_to_word = np.full(
            self.backend.sizes['target_vocab_size'],
            self.vocabs.target_vocab.special_words.OOV, dtype=object)
        self._target_index_to_word[:true_decode.shape[0]] = true_decode

    def train(self) -> List[float]:
        """NUM_TRAIN_EPOCHS epochs over the train split, from the current
        weights (and moments, if an earlier call trained). Logs the mean
        loss every NUM_BATCHES_TO_LOG_PROGRESS steps and per epoch, and
        evaluates after each epoch when TEST_DATA_PATH is set (the
        results go to ``eval_history``); returns the per-epoch mean
        losses. Trains on the packed wire with USE_PALLAS_RAGGED_FUSION
        only."""
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
        every = config.NUM_BATCHES_TO_LOG_PROGRESS
        epoch_losses = []
        self.eval_history = []
        for epoch in range(config.NUM_TRAIN_EPOCHS):
            t0 = time.perf_counter()
            losses = []
            for packed in self.reader.iter_epoch(seed=epoch):
                self.state, loss = self.trainer.train_step(self.state,
                                                           packed)
                losses.append(loss)
                if len(losses) % every == 0:
                    recent = float(torch.stack(losses[-every:]).mean())
                    logger.info('epoch %d step %d: loss %.5f', epoch + 1,
                                self.state.step, recent)
            if not losses:
                raise ValueError('no training examples in %s'
                                 % config.train_data_path)
            mean = float(torch.stack(losses).mean())
            epoch_losses.append(mean)
            logger.info('epoch %d: %d steps, mean loss %.5f, %.1f s',
                        epoch + 1, len(losses), mean,
                        time.perf_counter() - t0)
            if config.is_testing:
                self._evaluate_and_log('epoch %d' % (epoch + 1),
                                       self.state.step)
        return epoch_losses

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
        per-example ``log.txt`` into the working directory, as the
        reference does for a model that neither saves nor loads, and the
        code vectors to ``TEST_DATA_PATH.vectors`` under
        EXPORT_CODE_VECTORS."""
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
        total = 0
        loss_sum = 0.0
        weight_sum = 0.0
        start_time = time.time()
        with contextlib.ExitStack() as files:
            log_file = files.enter_context(open('log.txt', 'w'))
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
            # decodes batch k
            pending = None
            for batch in reader.iter_epoch(evaluate=True):
                out = self.trainer.eval_step(batch)
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
