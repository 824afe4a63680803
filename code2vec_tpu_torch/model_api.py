"""``Code2VecModel``: the port's user-facing model for training and
serving predictions (the train and predict paths of
``code2vec_tpu/model_api.py``).

    model = Code2VecModel(config)                 # on cuda
    model = Code2VecModel(config, device='cpu')   # plain versions, CPU
    model.train()                                 # epochs over .train.c2v
    results = model.predict(lines)                # raw path-context lines

``train`` streams ``TRAIN_DATA_PATH_PREFIX.train.c2v`` as shuffled packed
batches through the trainer for NUM_TRAIN_EPOCHS and logs the loss (no
evaluation and no checkpoints yet). ``predict`` tokenizes the lines,
pads the batch to the serving bucket ladder, packs it onto the wire (one
shard), runs the predict step on the model's device and decodes the
result on the host.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data import packed as packed_lib
from code2vec_tpu_torch.data.reader import PathContextReader
from code2vec_tpu_torch.device import resolve_device
from code2vec_tpu_torch.models.backends import TorchBackend
from code2vec_tpu_torch.models.functional import Code2VecParams
from code2vec_tpu_torch.serving import engine as engine_lib
from code2vec_tpu_torch.serving.steps import predict_step
from code2vec_tpu_torch.training.trainer import Trainer, TrainerState
from code2vec_tpu_torch.vocab import Code2VecVocabs

logger = logging.getLogger(__name__)


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
        loss every NUM_BATCHES_TO_LOG_PROGRESS steps and per epoch;
        returns the per-epoch mean losses."""
        config = self.config
        if not config.train_data_path:
            raise ValueError('train() needs TRAIN_DATA_PATH_PREFIX')
        if self.state is None:
            self.state = self.trainer.state_from_params()
        every = config.NUM_BATCHES_TO_LOG_PROGRESS
        epoch_losses = []
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
        return epoch_losses

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
        packed = packed_lib.pack_batch(batch, self.backend.token_pad_index,
                                       self.backend.path_pad_index,
                                       data_shards=1)
        ctx = torch.from_numpy(packed.ctx).to(self.device)
        count = torch.from_numpy(packed.count).to(self.device)
        if tier is None:
            tier = 'full' if self.config.EXPORT_CODE_VECTORS else 'attention'
        out = predict_step(self.backend, ctx, count, tier=tier)
        fetched = {key: value.cpu().numpy() for key, value in out.items()}
        return engine_lib.decode_results(fetched, batch, len(lines),
                                         self._target_index_to_word)
