"""The port's ragged encode (code2vec_tpu_torch/ops/ragged.py) against
three references on the same inputs and weights:

(a) the reference's jnp twin, ``pallas_ragged.ragged_encode(use_kernel=
    False)``;
(b) the reference's Pallas kernel in interpret mode
    (``use_kernel=True, interpret=True``);
(c) the dense ``functional.encode`` (the unpack-then-dense ground truth).

On the CPU the port's kernel wrapper runs its plain version. fp32 holds
at the reference's ``assert_encode_close`` tolerance (rtol 2e-5, atol
1e-6). In bf16 the port follows the TPU kernel, which keeps ``x`` in fp32
for the score and the weighted sum, so it holds at atol 1e-2 against (b);
the jnp twin rounds ``x`` to bf16, so (a) holds only at the looser
atol 5e-2 (an x rounded to bf16 moves by up to ~4e-3 relative)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.data import packed as jax_packed
from code2vec_tpu.ops import pallas_ragged
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.ops import ragged
from tests.test_packed import random_plane_batch
from tests.test_pallas_ragged import (assert_encode_close, dense_reference,
                                      small_params)


def to_port(jax_params):
    return convert.params_from_numpy(
        {k: np.asarray(v) for k, v in jax_params._asdict().items()})


def port_encode(params, packed, max_contexts, token_pad, path_pad,
                dtype=torch.float32):
    return ragged.ragged_encode(
        params.token_embedding, params.path_embedding, params.transform,
        params.attention, torch.from_numpy(packed.ctx),
        torch.from_numpy(packed.count), max_contexts=max_contexts,
        token_pad=token_pad, path_pad=path_pad, dtype=dtype)


def jax_encode(params, packed, max_contexts, token_pad, path_pad,
               dtype=jnp.float32, **kw):
    return pallas_ragged.ragged_encode(
        params.token_embedding, params.path_embedding, params.transform,
        params.attention, jnp.asarray(packed.ctx),
        jnp.asarray(packed.count), max_contexts=max_contexts,
        token_pad=token_pad, path_pad=path_pad, dtype=dtype, **kw)


def as_numpy(pair):
    return tuple(np.asarray(t) for t in pair)


@pytest.mark.parametrize('token_pad,path_pad', [(0, 0), (1, 2)])
@pytest.mark.parametrize('data_shards', [1, 4])
def test_fp32_matches_twin_and_dense(token_pad, path_pad, data_shards):
    rng = np.random.default_rng(21)
    jax_params = small_params()
    params = to_port(jax_params)
    for contexts in (3, 8):
        batch = random_plane_batch(rng, 8, contexts, token_pad, path_pad)
        packed = jax_packed.pack_batch(batch, token_pad, path_pad,
                                       data_shards=data_shards,
                                       capacity_minimum=4)
        got = as_numpy(port_encode(params, packed, contexts, token_pad,
                                   path_pad))
        assert_encode_close(got, jax_encode(jax_params, packed, contexts,
                                            token_pad, path_pad,
                                            use_kernel=False))
        assert_encode_close(got, dense_reference(jax_params, batch))


@pytest.mark.parametrize('data_shards', [1, 2])
def test_fp32_matches_pallas_kernel_interpret(data_shards):
    rng = np.random.default_rng(23)
    jax_params = small_params()
    params = to_port(jax_params)
    for contexts in (3, 8):
        batch = random_plane_batch(rng, 8, contexts, 1, 2)
        packed = jax_packed.pack_batch(batch, 1, 2, data_shards=data_shards,
                                       capacity_minimum=4)
        got = as_numpy(port_encode(params, packed, contexts, 1, 2))
        assert_encode_close(got, jax_encode(jax_params, packed, contexts,
                                            1, 2, use_kernel=True,
                                            interpret=True))


def test_bf16_tight_to_kernel_loose_to_twin():
    rng = np.random.default_rng(29)
    jax_params = small_params()
    params = to_port(jax_params)
    contexts = 8
    batch = random_plane_batch(rng, 8, contexts, hole_rate=0.3)
    packed = jax_packed.pack_batch(batch, 0, 0, capacity_minimum=4)
    got = as_numpy(port_encode(params, packed, contexts, 0, 0,
                               dtype=torch.bfloat16))
    kernel = jax_encode(jax_params, packed, contexts, 0, 0,
                        dtype=jnp.bfloat16, use_kernel=True, interpret=True)
    twin = jax_encode(jax_params, packed, contexts, 0, 0,
                      dtype=jnp.bfloat16, use_kernel=False)
    assert_encode_close(got, kernel, rtol=0, atol=1e-2)
    assert_encode_close(got, twin, rtol=0, atol=5e-2)
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()


def test_capacity_rungs_agree():
    """Capacity padding is inert: every rung gives the dense result."""
    rng = np.random.default_rng(3)
    jax_params = small_params()
    params = to_port(jax_params)
    batch = random_plane_batch(rng, 8, 6)
    want = dense_reference(jax_params, batch)
    for rung in (4, 16, 64, 256):
        packed = jax_packed.pack_batch(batch, 0, 0, capacity_minimum=rung)
        assert packed.ctx.shape[1] >= rung
        assert_encode_close(as_numpy(port_encode(params, packed, 6, 0, 0)),
                            want)


def test_all_padding_rows_match_dense_uniform():
    """count == 0 rows: uniform 1/C attention and code = x_pad."""
    from code2vec_tpu.data.reader import Batch
    contexts = 5
    zero = Batch(source=np.zeros((4, contexts), np.int32),
                 path=np.zeros((4, contexts), np.int32),
                 target=np.zeros((4, contexts), np.int32),
                 mask=np.zeros((4, contexts), np.float32),
                 label=np.zeros((4,), np.int32),
                 weight=np.zeros((4,), np.float32))
    jax_params = small_params()
    packed = jax_packed.pack_batch(zero, 0, 0, capacity_minimum=4)
    got = as_numpy(port_encode(to_port(jax_params), packed, contexts, 0, 0))
    assert_encode_close(got, dense_reference(jax_params, zero))
    np.testing.assert_allclose(got[1], np.full((4, contexts), 1 / contexts))


def test_stats_match_reference_twin():
    """The statistics themselves — (scores, m, z, acc) of the plain
    version against the reference's ``_stats_jnp``, fp32."""
    rng = np.random.default_rng(31)
    jax_params = small_params()
    params = to_port(jax_params)
    batch = random_plane_batch(rng, 12, 7, 1, 2, hole_rate=0.4)
    packed = jax_packed.pack_batch(batch, 1, 2, data_shards=2,
                                   capacity_minimum=4)
    ctx, count = jnp.asarray(packed.ctx), jnp.asarray(packed.count)
    count2, seg, _pos, valid, src, pth, tgt = pallas_ragged._segment_inputs(
        ctx, count, 1, 2)
    w_src, w_path, w_tgt, attn = pallas_ragged._split_weights(
        jax_params.transform, jax_params.attention, 8, 6, jnp.float32)
    want = pallas_ragged._stats_jnp(
        jax_params.token_embedding[src], jax_params.path_embedding[pth],
        jax_params.token_embedding[tgt], seg, valid, w_src, w_path, w_tgt,
        attn, count2.shape[1], pallas_ragged._precision(jnp.float32))
    segs = ragged._segment_inputs(torch.from_numpy(packed.ctx),
                                  torch.from_numpy(packed.count), 1, 2)
    got = ragged._stats_kernel(params.token_embedding, params.path_embedding,
                               params.transform, params.attention.reshape(-1),
                               segs, 1, 2)
    for name, g, w in zip(('scores', 'm', 'z', 'acc'), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=1e-6, err_msg=name)


def test_kernel_wrapper_counts_no_launch_on_cpu():
    rng = np.random.default_rng(1)
    params = to_port(small_params())
    packed = jax_packed.pack_batch(random_plane_batch(rng, 8, 5), 0, 0,
                                   capacity_minimum=4)
    before = ragged.launches
    port_encode(params, packed, 5, 0, 0)
    assert ragged.launches == before

