"""``Code2VecModel``: the port's user-facing model for serving
predictions (the predict path of ``code2vec_tpu/model_api.py``).

    model = Code2VecModel(config)                 # on cuda
    model = Code2VecModel(config, device='cpu')   # plain versions, CPU
    results = model.predict(lines)                # raw path-context lines

``predict`` tokenizes the lines, pads the batch to the serving bucket
ladder, packs it onto the wire (one shard), runs the predict step on the
model's device and decodes the result on the host.
"""
from __future__ import annotations

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
from code2vec_tpu_torch.vocab import Code2VecVocabs


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
        # decode table padded to the table size: padded indices surface
        # only when the vocab is smaller than k, and decode as OOV
        true_decode = self.vocabs.target_vocab.index_to_word_array()
        self._target_index_to_word = np.full(
            self.backend.sizes['target_vocab_size'],
            self.vocabs.target_vocab.special_words.OOV, dtype=object)
        self._target_index_to_word[:true_decode.shape[0]] = true_decode

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
