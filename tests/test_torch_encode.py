"""The port's dense forward of the plane wire against the reference, on
the CPU with the same inputs:

- ``ops/encode.py::fused_context_transform`` (its plain version on CPU
  tensors) against the reference's Pallas kernel
  ``pallas_encode.fused_context_transform`` run by the interpreter, fp32
  and bf16 inputs, at a row count that is and one that is not a multiple
  of the TPU's 512-row tile, and once at the java14m width;
- ``functional.encode(use_pallas=True)`` against the reference's kernel
  route of ``functional.encode``, fp32 and bf16. On the CPU the reference
  takes its jnp route even with the flag, so the test points its TPU
  predicate and its kernel (interpreted) at the kernel route;
- ``data/packed.py::unpack_device`` against the reference's, bit for bit.

Tolerances: fp32 at the reference's ``assert_encode_close`` (rtol 2e-5,
atol 1e-6). The bf16 inputs hold the same values in both packages and
both accumulate their products in fp32, so they differ only in the order
of the sums: the same tolerance holds. Measured on these inputs, fp32
and bf16 alike: x within 4e-7 and scores (up to ~13) within 3e-6 at
widths 16/16/48; code vectors and attention of the encode within 1.2e-7.
At the java14m width the scores (up to ~45) sum 384 products and differ
by up to 8e-6: atol 1e-5 there.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.data import packed as jax_packed
from code2vec_tpu.models import functional as jax_functional
from code2vec_tpu.ops import pallas_encode
from code2vec_tpu_torch.data import packed as torch_packed
from code2vec_tpu_torch.models import functional
from code2vec_tpu_torch.models.functional import Code2VecParams
from code2vec_tpu_torch.ops import encode
from tests.test_packed import random_plane_batch

RTOL, ATOL = 2e-5, 1e-6
DTYPES = {'float32': (torch.float32, jnp.float32),
          'bfloat16': (torch.bfloat16, jnp.bfloat16)}


def _rows(rng, n, token_dim, path_dim, code_dim, dtype):
    """Row inputs and weights as torch tensors of ``dtype`` and as jnp
    arrays holding the same values."""
    torch_dtype, jax_dtype = DTYPES[dtype]
    arrays = [rng.standard_normal((n, token_dim)),
              rng.standard_normal((n, path_dim)),
              rng.standard_normal((n, token_dim)),
              rng.standard_normal((2 * token_dim + path_dim, code_dim)) * 0.1,
              rng.standard_normal((code_dim, 1))]
    tensors = [torch.from_numpy(a.astype(np.float32)).to(torch_dtype)
               for a in arrays]
    jax_arrays = [jnp.asarray(t.float().numpy()).astype(jax_dtype)
                  for t in tensors]
    return tensors, jax_arrays


def _assert_transform_close(got, want, atol):
    x, scores = got
    assert x.dtype == scores.dtype == torch.float32
    assert tuple(scores.shape) == np.asarray(want[1]).shape
    np.testing.assert_allclose(x.numpy(), np.asarray(want[0]), rtol=RTOL,
                               atol=ATOL, err_msg='x')
    np.testing.assert_allclose(scores.numpy(), np.asarray(want[1]),
                               rtol=RTOL, atol=atol, err_msg='scores')


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('n', [512, 700])
def test_transform_matches_interpreted_kernel(n, dtype):
    tensors, jax_arrays = _rows(np.random.default_rng(n), n, 16, 16, 48,
                                dtype)
    want = pallas_encode.fused_context_transform(*jax_arrays,
                                                 interpret=True)
    _assert_transform_close(encode.fused_context_transform(*tensors), want,
                            ATOL)


def test_transform_matches_interpreted_kernel_java14m_width():
    tensors, jax_arrays = _rows(np.random.default_rng(1), 200, 128, 128,
                                384, 'bfloat16')
    tensors[3] = tensors[3] * 0.5
    jax_arrays[3] = jax_arrays[3] * 0.5
    want = pallas_encode.fused_context_transform(*jax_arrays,
                                                 interpret=True)
    _assert_transform_close(encode.fused_context_transform(*tensors), want,
                            1e-5)


def test_transform_wrapper_runs_the_plain_version_on_cpu():
    tensors, _ = _rows(np.random.default_rng(2), 40, 32, 32, 128, 'float32')
    before = encode.launches
    got = encode._transform_kernel(*tensors)
    want = encode._transform_plain(*tensors)
    assert encode.launches == before     # no kernel on CPU tensors
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match='dims'):
        encode.fused_context_transform(tensors[0], tensors[1], tensors[2],
                                       tensors[3][1:], tensors[4])


def _small_model(rng):
    token_vocab, path_vocab, token_dim, path_dim, code_dim = 40, 30, 16, 16, 48
    arrays = {
        'token_embedding': rng.uniform(-0.4, 0.4, (token_vocab, token_dim)),
        'path_embedding': rng.uniform(-0.4, 0.4, (path_vocab, path_dim)),
        'target_embedding': rng.uniform(-0.2, 0.2, (8, code_dim)),
        'transform': rng.uniform(-0.3, 0.3, (2 * token_dim + path_dim,
                                             code_dim)),
        'attention': rng.uniform(-0.3, 0.3, (code_dim, 1))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    batch = random_plane_batch(rng, 6, 8)
    # random_plane_batch draws indices below 30/14; one row with no valid
    # context, whose code vector is the mean of its PAD-slot x
    for plane in (batch.source, batch.path, batch.target):
        plane[2] = 0
    batch = batch._replace(mask=((batch.source != 0) | (batch.path != 0)
                                 | (batch.target != 0)).astype(np.float32))
    return arrays, batch


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_encode_kernel_route_matches_reference_kernel_route(dtype,
                                                            monkeypatch):
    arrays, batch = _small_model(np.random.default_rng(7))
    torch_dtype, jax_dtype = DTYPES[dtype]
    monkeypatch.setattr(pallas_encode, 'tpu_backend_active', lambda: True)
    monkeypatch.setattr(pallas_encode, 'fused_context_transform',
                        functools.partial(
                            pallas_encode.fused_context_transform,
                            interpret=True))
    planes = (batch.source, batch.path, batch.target, batch.mask)
    want = jax_functional.encode(
        jax_functional.Code2VecParams(**{k: jnp.asarray(v)
                                         for k, v in arrays.items()}),
        *planes, dtype=jax_dtype, use_pallas=True)
    got = functional.encode(
        Code2VecParams(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
        *(torch.from_numpy(a) for a in planes), dtype=torch_dtype,
        use_pallas=True)
    for name, g, w in zip(('code_vectors', 'attention'), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    # the row without a valid context: uniform attention over its slots
    np.testing.assert_allclose(got[1][2].numpy(), 1.0 / 8, rtol=1e-6)


def _assert_unpack_equal(packed, contexts, token_pad, path_pad):
    want = jax_packed.unpack_device(jnp.asarray(packed.ctx),
                                    jnp.asarray(packed.count), contexts,
                                    token_pad, path_pad)
    got = torch_packed.unpack_device(torch.from_numpy(packed.ctx),
                                     torch.from_numpy(packed.count),
                                     contexts, token_pad, path_pad)
    for name, g, w in zip(('source', 'path', 'target', 'mask'), got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize('token_pad,path_pad', [(0, 0), (1, 2)])
@pytest.mark.parametrize('data_shards', [1, 4])
def test_unpack_device_bit_equal(token_pad, path_pad, data_shards):
    """Random counts with zero-length rows and interior holes; capacity
    minimum 4, so the capacity padding lands on tail slots."""
    rng = np.random.default_rng(11)
    for _trial in range(6):
        contexts = int(rng.choice([3, 6, 13]))
        batch = random_plane_batch(rng, 8, contexts, token_pad, path_pad)
        packed = torch_packed.pack_batch(batch, token_pad, path_pad,
                                         data_shards=data_shards,
                                         capacity_minimum=4)
        _assert_unpack_equal(packed, contexts, token_pad, path_pad)
        got = torch_packed.unpack_device(
            torch.from_numpy(packed.ctx), torch.from_numpy(packed.count),
            contexts, token_pad, path_pad)
        np.testing.assert_array_equal(got[0].numpy(), batch.source)
        np.testing.assert_array_equal(got[3].numpy(), batch.mask)


def test_unpack_device_capacity_below_batch():
    """More examples than slots, most rows empty."""
    rng = np.random.default_rng(2)
    batch = random_plane_batch(rng, 64, 6)
    lengths = np.zeros((64,), np.int64)
    lengths[:4] = [1, 2, 0, 3]
    dead = np.arange(6)[None, :] >= lengths[:, None]
    for plane in (batch.source, batch.path, batch.target):
        plane[dead] = 0
    batch = batch._replace(mask=((batch.source != 0) | (batch.path != 0)
                                 | (batch.target != 0)).astype(np.float32))
    packed = torch_packed.pack_batch(batch, 0, 0, capacity_minimum=4)
    assert packed.ctx.shape[1] < 64
    _assert_unpack_equal(packed, 6, 0, 0)
