"""The optimizer layer's knobs in the port against the reference, on the
CPU:

- the plain Adam update (``ops/adam.py::adam_update_plain``, what
  ``adam_dtypes.update_`` runs on CPU tensors) is bit-equal to a numpy
  float32 evaluation of the reference's expression in its order, for
  every gradient x mu x nu storage dtype, at step 1 and later, with zero,
  very large, NaN and +-0-rounding gradients, on a length that is not a
  multiple of 8 and on a view at an odd offset;
- GRADS_DTYPE='bfloat16': a packed train step against the reference's
  (bf16 compute, keep 1.0): the gradients come back in bf16, the loss and
  the weights agree;
- REMAT_ENCODE: the loss and every gradient are equal with and without
  it, and the encode's forward runs again in the backward;
- Config.verify raises where the reference's raises, and the flags
  --grads-dtype, --embed-grad and --remat-encode parse as the
  reference's do.

Tolerances: the plain Adam bit for bit (NaN where numpy has NaN); fp32
train steps as tests/test_torch_train.py (loss rtol 2e-5, parameters rtol
1e-5 / atol 1e-6, bf16-stored moments within one bf16 rounding, rtol
2^-7). GRADS_DTYPE='bfloat16': the loss at rtol 1e-3 (both forwards run
in bf16, rounding at different places); the bf16 gradients within four
bf16 steps of each tensor's largest (atol 2^-6 of the scale: the two
packages' bf16 products and table scatters round at different places);
the weights after the step within 2e-4 of an Adam step of lr 1e-3 where
the reference's gradient is above 1% of its tensor's scale (there the two
gradients share their sign, and the first Adam step moves each weight by
lr * sign(g)), and within one full step (1.01e-3 * 2) everywhere.
REMAT_ENCODE bit for bit.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.config import Config
from code2vec_tpu.data import packed as jax_packed
from code2vec_tpu.models.backends import create_backend
from code2vec_tpu.training.trainer import Trainer as JaxTrainer
from code2vec_tpu.vocab import SizeOnlyVocabs
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.config import Config as PortConfig
from code2vec_tpu_torch.models.backends import TorchBackend
from code2vec_tpu_torch.models.functional import Code2VecParams
from code2vec_tpu_torch.ops import adam as adam_ops
from code2vec_tpu_torch.ops import ragged
from code2vec_tpu_torch.training import adam_dtypes
from code2vec_tpu_torch.training.trainer import Trainer
from tests.test_packed import random_plane_batch

BF16_STEP = dict(rtol=2.0 ** -7, atol=1e-12)
DIMS = dict(MAX_CONTEXTS=4, TOKEN_EMBEDDINGS_SIZE=8, PATH_EMBEDDINGS_SIZE=8,
            CODE_VECTOR_SIZE=24)
VOCAB = (32, 16, 16)


# ------------------------------------------------------------- harness
def jax_trainer(**knobs):
    """The reference's trainer at the sizes of tests/test_stage_batches.py
    (fp32 compute unless ``knobs`` say otherwise)."""
    knobs.setdefault('COMPUTE_DTYPE', 'float32')
    config = Config(
        TRAIN_DATA_PATH_PREFIX='unused', DL_FRAMEWORK='jax',
        VERBOSE_MODE=0, READER_USE_NATIVE=False, TRAIN_BATCH_SIZE=8,
        TEST_BATCH_SIZE=8, MAX_TOKEN_VOCAB_SIZE=VOCAB[0],
        MAX_PATH_VOCAB_SIZE=VOCAB[1], MAX_TARGET_VOCAB_SIZE=VOCAB[2],
        TARGET_EMBEDDINGS_SIZE=24, **DIMS, **knobs)
    return JaxTrainer(config, create_backend(config, SizeOnlyVocabs(*VOCAB)))


def _vocab(size):
    return SimpleNamespace(size=size, pad_index=0)


def port_trainer(jax_state, **knobs):
    """The port's trainer with the same knobs over the reference state's
    weights: ``(trainer, state)``."""
    knobs.setdefault('COMPUTE_DTYPE', 'float32')
    config = PortConfig(TRAIN_DATA_PATH_PREFIX='unused', **DIMS, **knobs)
    vocabs = SimpleNamespace(token_vocab=_vocab(VOCAB[0]),
                             path_vocab=_vocab(VOCAB[1]),
                             target_vocab=_vocab(VOCAB[2]))
    trainer = Trainer(config, TorchBackend(config, vocabs,
                                           torch.device('cpu')))
    weights = {k: np.asarray(v, np.float32)
               for k, v in jax_state.params._asdict().items()}
    return trainer, trainer.state_from_params(
        convert.params_from_numpy(weights))


def reference_batch(rng, batch=8, contexts=4):
    """A packed batch with every structural corner (empty rows, holes,
    zero-weight rows), one shard per device of the reference's 8-device
    CPU mesh."""
    plane = random_plane_batch(rng, batch, contexts, pad_row_rate=0.25)
    plane = plane._replace(label=(plane.label % VOCAB[2]).astype(np.int32))
    return jax_packed.pack_batch(plane, 0, 0, data_shards=8,
                                 capacity_minimum=4)


def assert_step_matches(port_state, port_loss, jax_state, jax_loss):
    """One fp32 step of Adam with bf16-stored moments, both packages."""
    np.testing.assert_allclose(float(port_loss), float(jax_loss), rtol=2e-5)
    got = convert.params_to_numpy(port_state.params)
    got_opt = convert.opt_state_to_numpy(port_state.opt_state)
    want_opt = jax_state.opt_state[0]
    for name in Code2VecParams._fields:
        np.testing.assert_allclose(
            got[name], np.asarray(getattr(jax_state.params, name)),
            rtol=1e-5, atol=1e-6, err_msg=name)
        for field in ('mu', 'nu'):
            np.testing.assert_allclose(
                got_opt[field][name],
                np.asarray(getattr(getattr(want_opt, field), name),
                           np.float32), err_msg='%s %s' % (field, name),
                **BF16_STEP)


# ------------------------------------------------------------ plain Adam
def _numpy_adam(p, g, m, v, s: adam_ops.AdamScalars):
    """The reference's expression (training/adam_dtypes.py) in numpy
    float32, one rounding per operation."""
    f = np.float32
    with np.errstate(invalid='ignore', over='ignore'):
        m = f(s.b1) * m + f(s.omb1) * g
        v = f(s.b2) * v + f(s.omb2) * (g * g)
        u = (m / f(s.b1c)) / (np.sqrt(v / f(s.b2c)) + f(s.eps))
        return p + f(s.neg_lr) * u, m, v


def _bits_equal(got: torch.Tensor, want: np.ndarray) -> bool:
    got = got.float().numpy()
    nan = np.isnan(want)
    return bool((np.isnan(got) == nan).all() and np.array_equal(
        got[~nan].view(np.uint32), want[~nan].view(np.uint32)))


DTYPES = (torch.float32, torch.bfloat16)


@pytest.mark.parametrize('nu_dtype', DTYPES)
@pytest.mark.parametrize('mu_dtype', DTYPES)
@pytest.mark.parametrize('grad_dtype', DTYPES)
def test_plain_adam_is_numpy_float32_bit_for_bit(grad_dtype, mu_dtype,
                                                 nu_dtype):
    rng = np.random.default_rng(7)
    n = 1003                           # not a multiple of 8
    backing = torch.from_numpy(rng.normal(size=n + 1).astype(np.float32))
    p = backing[1:]                    # a view at an odd offset
    g = rng.normal(size=n).astype(np.float32)
    g[:16] = 0.0
    g[16:32] = rng.choice([-1.0, 1.0], 16) * 3e38
    g[32] = np.nan
    # +-0 ties: the update of these rounds to a signed zero in bf16
    g[33:35] = [1e-45, -1e-45]
    m = (rng.normal(size=n) * 0.1).astype(np.float32)
    m[33:35] = 0.0
    v = np.abs(rng.normal(size=n) * 0.01).astype(np.float32)
    params, grads = [p], [torch.from_numpy(g).to(grad_dtype)]
    state = adam_dtypes.AdamState(
        0, (torch.from_numpy(m).to(mu_dtype),),
        (torch.from_numpy(v).to(nu_dtype),))
    for _step in range(2):                  # step 1, then step 2
        want_p = params[0].numpy().copy()
        want_m = state.mu[0].float().numpy().copy()
        want_v = state.nu[0].float().numpy().copy()
        gf = grads[0].float().numpy().copy()
        count = state.count + 1
        s = adam_dtypes.adam_scalars(count, 1e-3)
        want_p, want_m, want_v = _numpy_adam(want_p, gf, want_m, want_v, s)
        state = adam_dtypes.update_(params, grads, state, 1e-3)
        assert state.count == count
        assert _bits_equal(params[0], want_p)
        assert _bits_equal(state.mu[0], torch.from_numpy(want_m).to(
            mu_dtype).float().numpy())
        assert _bits_equal(state.nu[0], torch.from_numpy(want_v).to(
            nu_dtype).float().numpy())
    assert torch.isnan(params[0][32])      # a NaN gradient is not skipped
    assert torch.equal(backing[:1], torch.from_numpy(
        np.random.default_rng(7).normal(size=n + 1).astype(np.float32)[:1]))


def test_adam_update_checks_its_arguments():
    p = torch.zeros(6)
    with pytest.raises(TypeError, match='float32'):
        adam_ops._check_update_args(p.double(), p, p, p)
    with pytest.raises(ValueError, match='shape'):
        adam_ops._check_update_args(p, torch.zeros(5), p, p)
    with pytest.raises(ValueError, match='contiguous'):
        adam_ops._check_update_args(p, torch.zeros(12)[::2], p, p)
    with pytest.raises(ValueError, match='unsupported device'):
        adam_ops.adam_rows(p.reshape(2, 3), p.reshape(2, 3), p.reshape(2, 3),
                           p.reshape(2, 3), torch.zeros(1, dtype=torch.int64),
                           1e-3, 0.9, 0.999, 1e-8)


# -------------------------------------------------------- GRADS_DTYPE bf16
def test_grads_bf16_step_matches_reference():
    knobs = dict(COMPUTE_DTYPE='bfloat16', GRADS_DTYPE='bfloat16',
                 DROPOUT_KEEP_RATE=1.0)
    reference = jax_trainer(**knobs)
    state = reference.init_state()
    packed = reference_batch(np.random.default_rng(8))
    port, port_state = port_trainer(state, **knobs)
    start = {name: a.copy() for name, a in
             convert.params_to_numpy(port_state.params).items()}

    # the gradients, each package's own way
    arrays = tuple(jnp.asarray(a) for a in packed.device_arrays())
    cast = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16),
                                  state.params)
    want_grads = jax.grad(lambda params: reference.backend.loss_fn_packed(
        params, arrays, None)[0])(cast)
    diff = Code2VecParams(*[p.detach().to(torch.bfloat16).requires_grad_()
                            for p in port_state.params])
    loss, _aux = port.backend.loss_fn_packed(
        diff, tuple(torch.from_numpy(a) for a in packed.device_arrays()))
    loss.backward()
    for name, tensor in zip(Code2VecParams._fields, diff):
        assert tensor.grad.dtype == torch.bfloat16, name
        want = np.asarray(getattr(want_grads, name), np.float32)
        np.testing.assert_allclose(
            tensor.grad.float().numpy(), want, rtol=0,
            atol=2.0 ** -6 * max(float(np.abs(want).max()), 1e-30),
            err_msg=name)

    new_state, jax_loss = reference.train_step(state, packed)
    port_state, port_loss = port.train_step(port_state, packed)
    np.testing.assert_allclose(float(port_loss), float(jax_loss), rtol=1e-3)
    got = convert.params_to_numpy(port_state.params)
    for name in Code2VecParams._fields:
        want = np.asarray(getattr(new_state.params, name), np.float32)
        grad = np.abs(np.asarray(getattr(want_grads, name), np.float32))
        clear = grad > 0.01 * grad.max()
        np.testing.assert_allclose(got[name][clear], want[clear], rtol=0,
                                   atol=2e-4 * 1e-3, err_msg=name)
        np.testing.assert_allclose(got[name], want, rtol=0,
                                   atol=2 * 1.01e-3, err_msg=name)
        assert not np.array_equal(got[name][clear], start[name][clear])


# --------------------------------------------------------------- REMAT
def test_remat_encode_keeps_loss_and_gradients(monkeypatch):
    reference = jax_trainer(DROPOUT_KEEP_RATE=1.0)
    state = reference.init_state()
    packed = reference_batch(np.random.default_rng(9))
    arrays = tuple(torch.from_numpy(a) for a in packed.device_arrays())
    forwards = []
    stats = ragged._stats_kernel

    def counted(*args, **kwargs):
        forwards.append(1)
        return stats(*args, **kwargs)
    monkeypatch.setattr(ragged, '_stats_kernel', counted)
    results = []
    for remat in (False, True):
        port, port_state = port_trainer(state, REMAT_ENCODE=remat,
                                        DROPOUT_KEEP_RATE=0.75)
        params = port_state.params
        forwards.clear()
        loss, _aux = port.backend.loss_fn_packed(params, arrays,
                                                 dropout_seed=11)
        loss.backward()
        results.append((loss.detach(), [p.grad.clone() for p in params],
                        len(forwards)))
    (loss_a, grads_a, runs_a), (loss_b, grads_b, runs_b) = results
    assert (runs_a, runs_b) == (1, 2)
    assert torch.equal(loss_a, loss_b)
    for name, a, b in zip(Code2VecParams._fields, grads_a, grads_b):
        assert torch.equal(a, b), name


# ------------------------------------------------------- config and CLI
@pytest.mark.parametrize('knobs', [
    dict(EMBED_GRAD_IMPL='scatter'),
    dict(GRADS_DTYPE='float16'),
    dict(GRADS_DTYPE='bfloat16', LAZY_EMBEDDING_ADAM=True),
    dict(GRADS_DTYPE='bfloat16', COMPUTE_DTYPE='float32'),
    dict(GRADS_DTYPE='bfloat16'),
    dict(LAZY_EMBEDDING_ADAM=True),
    dict(EMBED_GRAD_IMPL='dedup', REMAT_ENCODE=True),
])
def test_verify_rules_match_reference(knobs):
    def outcome(config):
        try:
            config.verify()
        except ValueError:
            return 'raises'
        return 'passes'
    want = outcome(Config(TRAIN_DATA_PATH_PREFIX='unused', **knobs))
    got = outcome(PortConfig(TRAIN_DATA_PATH_PREFIX='unused', **knobs))
    assert got == want


def test_knob_defaults_match_reference():
    reference, port = Config(), PortConfig()
    for name in ('LAZY_EMBEDDING_ADAM', 'GRADS_DTYPE', 'EMBED_GRAD_IMPL',
                 'REMAT_ENCODE'):
        assert getattr(port, name) == getattr(reference, name), name


@pytest.mark.parametrize('flags', [
    [], ['--grads-dtype', 'bfloat16'], ['--grads-dtype', 'float32'],
    ['--embed-grad', 'sorted'], ['--embed-grad', 'dedup'],
    ['--remat-encode'],
    ['--grads-dtype', 'bfloat16', '--embed-grad', 'dense',
     '--remat-encode'],
])
def test_flags_parse_as_reference(flags):
    args = ['--data', 'ds'] + flags
    reference = Config().load_from_args(args)
    port = PortConfig().load_from_args(args)
    for name in ('GRADS_DTYPE', 'EMBED_GRAD_IMPL', 'REMAT_ENCODE'):
        assert getattr(port, name) == getattr(reference, name), name


@pytest.mark.parametrize('flags', [['--embed-grad', 'scatter'],
                                   ['--grads-dtype', 'float16']])
def test_bad_flag_values_are_errors(flags):
    for config in (Config(), PortConfig()):
        with pytest.raises(SystemExit):
            config.load_from_args(['--data', 'ds'] + flags)
