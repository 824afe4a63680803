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
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.models import functional
from code2vec_tpu_torch.models.functional import Code2VecParams
from code2vec_tpu_torch.ops.topk import top_k
from code2vec_tpu_torch.training import adam_dtypes

_STORAGE_DTYPES = {'bfloat16': torch.bfloat16, 'float32': None}


class TrainerState(NamedTuple):
    params: Code2VecParams       # the backend's nn.Parameters
    opt_state: adam_dtypes.AdamState
    step: int
    seed: int                    # dropout seed root


def dropout_seed(seed: int, step: int) -> int:
    """The dropout seed of one step: distinct for every (seed, step)."""
    return ((seed & 0x7FFFFFFF) << 32) | (step & 0xFFFFFFFF)


class Trainer:
    def __init__(self, config: Config, backend):
        self.config = config
        self.backend = backend
        self.mu_dtype = _STORAGE_DTYPES[config.ADAM_MU_DTYPE]
        self.nu_dtype = _STORAGE_DTYPES[config.ADAM_NU_DTYPE]

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
        opt_state = adam_dtypes.init(tensors, self.mu_dtype, self.nu_dtype)
        return TrainerState(params=tensors, opt_state=opt_state, step=step,
                            seed=seed)

    def state_from_restored(self, params: Optional[Dict[str, torch.Tensor]],
                            opt_state: dict, step: int,
                            seed: int = 42) -> TrainerState:
        """Training state from a checkpoint (``checkpoints.py``):
        ``params`` ({name: tensor}; None keeps the backend's weights)
        loaded into the backend, and ``opt_state`` ({'count', 'mu',
        'nu'}, each moment {name: tensor}) copied to the device in the
        configured storage dtypes (ADAM_MU_DTYPE / ADAM_NU_DTYPE: bf16 ->
        fp32 is exact, fp32 -> bf16 rounds as every step's store does).
        The reference resumes the same way (model_api.py:202-253)."""
        if params is not None:
            self.backend.load_params(Code2VecParams(**params))
        tensors = self.backend.trainable_params
        device = self.backend.device

        def moments(named, dtype):
            out = []
            for name, p in zip(Code2VecParams._fields, tensors):
                moment = named[name]
                if moment.shape != p.shape:
                    raise ValueError('Adam moment %s has shape %s, expected '
                                     '%s' % (name, tuple(moment.shape),
                                             tuple(p.shape)))
                out.append(moment.to(device, dtype or torch.float32,
                                     copy=True))
            return tuple(out)

        adam = adam_dtypes.AdamState(
            count=int(opt_state['count']),
            mu=moments(opt_state['mu'], self.mu_dtype),
            nu=moments(opt_state['nu'], self.nu_dtype))
        return TrainerState(params=tensors, opt_state=adam, step=int(step),
                            seed=seed)

    def _device_arrays(self, batch) -> Tuple[torch.Tensor, ...]:
        """A batch of either wire (``PackedBatch`` or ``Batch`` of numpy
        arrays, or a tuple of arrays or tensors: 4 packed, 6 planes) on
        the backend's device."""
        if hasattr(batch, 'device_arrays'):
            batch = batch.device_arrays()
        device = self.backend.device
        return tuple((torch.from_numpy(np.ascontiguousarray(a))
                      if isinstance(a, np.ndarray) else a).to(device)
                     for a in batch)

    def train_step(self, state: TrainerState, batch
                   ) -> Tuple[TrainerState, torch.Tensor]:
        """One step on a packed batch -> (new state, loss as a device
        scalar; reading it waits for the step)."""
        arrays = self._device_arrays(batch)
        if len(arrays) != 4 or not self.config.USE_PALLAS_RAGGED_FUSION:
            raise NotImplementedError(
                'training runs on the packed wire with '
                'USE_PALLAS_RAGGED_FUSION only: the plane-wire train step '
                'and the unpack-then-dense route are not ported yet')
        params = state.params
        for p in params:
            p.grad = None
        loss, _aux = self.backend.loss_fn_packed(
            params, arrays, dropout_seed=dropout_seed(state.seed,
                                                       state.step))
        loss.backward()
        opt_state = adam_dtypes.update_(
            params, [p.grad for p in params], state.opt_state,
            self.config.LEARNING_RATE)
        for p in params:
            p.grad = None      # the ~1.5 GB of gradients go before the next
        self.backend.mark_updated()
        return (TrainerState(params, opt_state, state.step + 1, state.seed),
                loss.detach())

    @torch.no_grad()
    def eval_step(self, batch) -> dict:
        """The forward of one batch of either wire -> ``{'topk_indices',
        'topk_scores', 'loss_sum', 'weight_sum'}`` (+ ``'code_vectors'``
        under EXPORT_CODE_VECTORS), on the device. The top-k scores are
        the raw logits, not softmaxed; the CE comes as sums, so batches
        add up exactly and padded rows (weight 0) drop out."""
        arrays = self._device_arrays(batch)
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
