"""The port's training encode (code2vec_tpu_torch/ops/ragged.py::
ragged_encode_code, its recompute backward on the CPU's plain versions)
against the reference's ``pallas_ragged.ragged_encode_code`` on the same
inputs, weights and cotangents: the jnp twin (``use_kernel=False``) and
the Pallas kernel pair in interpret mode (``use_kernel=True,
interpret=True``). Compared: the code vectors and the gradients of all
four encoder weights.

Tolerances: fp32 code vectors at rtol 2e-5 / atol 1e-6, fp32 gradients
at rtol 1e-4 / atol 1e-6. In bf16 the port follows the TPU kernel: x
stays fp32 (the reference's jnp twin rounds it, so the twin is not the
bf16 yardstick) and du is rounded to bf16 before the de and dW products,
as the TPU's DEFAULT precision rounds it for the MXU, where the CPU
interpreter keeps it fp32. That rounding moves each product term by at
most 2^-9 relative, so a bf16 gradient holds within 2^-8 of its own
scale (atol = 2^-8 * max |gradient|; measured up to 2.3e-3 of it)
against the interpreted kernel, and the code vectors at PR 1's atol
1e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.data import packed as jax_packed
from code2vec_tpu.ops import pallas_ragged
from code2vec_tpu_torch import convert
from code2vec_tpu_torch.ops import ragged
from tests.test_packed import random_plane_batch
from tests.test_pallas_ragged import small_params

NAMES = ('token_embedding', 'path_embedding', 'transform', 'attention')
FP32 = dict(rtol=1e-4, atol=1e-6)


def cotangent(batch_size, code_dim, seed=5):
    return np.random.default_rng(seed).normal(
        size=(batch_size, code_dim)).astype(np.float32)


def port_value_and_grads(jax_params, packed, g, token_pad, path_pad,
                         dtype=torch.float32, **kw):
    params = convert.params_from_numpy(
        {k: np.asarray(v) for k, v in jax_params._asdict().items()})
    leaves = [getattr(params, n).requires_grad_() for n in NAMES]
    code = ragged.ragged_encode_code(
        *leaves, torch.from_numpy(packed.ctx),
        torch.from_numpy(packed.count), token_pad=token_pad,
        path_pad=path_pad, dtype=dtype, **kw)
    (code * torch.from_numpy(g)).sum().backward()
    return code.detach().numpy(), [t.grad.numpy() for t in leaves]


def jax_value_and_grads(jax_params, packed, g, token_pad, path_pad,
                        dtype=jnp.float32, **kw):
    def loss(tok, path, trans, attn):
        code = pallas_ragged.ragged_encode_code(
            tok, path, trans, attn, jnp.asarray(packed.ctx),
            jnp.asarray(packed.count), token_pad=token_pad,
            path_pad=path_pad, dtype=dtype, **kw)
        return (code * g).sum(), code

    (_, code), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                          has_aux=True)(
        *[getattr(jax_params, n) for n in NAMES])
    return np.asarray(code), [np.asarray(t) for t in grads]


def assert_close(got, want, code_tol, grad_tol):
    """``grad_tol`` None: the bf16 bound, 2^-8 of each gradient's scale."""
    np.testing.assert_allclose(got[0], want[0], err_msg='code', **code_tol)
    for name, g, w in zip(NAMES, got[1], want[1]):
        tol = grad_tol or dict(rtol=0, atol=2.0 ** -8 * np.abs(w).max())
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


@pytest.mark.parametrize('use_kernel', [False, True])
@pytest.mark.parametrize('token_pad,path_pad,data_shards',
                         [(0, 0, 1), (1, 2, 2)])
def test_fp32_matches_reference(use_kernel, token_pad, path_pad,
                                data_shards):
    """Empty rows (count == 0, which take x_pad and route their cotangent
    through it), interior holes and several shards."""
    rng = np.random.default_rng(41)
    jax_params = small_params()
    batch = random_plane_batch(rng, 8, 7, token_pad, path_pad,
                               hole_rate=0.3, pad_row_rate=0.3)
    assert (batch.mask.sum(axis=1) == 0).any()
    packed = jax_packed.pack_batch(batch, token_pad, path_pad,
                                   data_shards=data_shards,
                                   capacity_minimum=4)
    g = cotangent(8, 24)
    kw = dict(use_kernel=True, interpret=True) if use_kernel else dict(
        use_kernel=False)
    assert_close(port_value_and_grads(jax_params, packed, g, token_pad,
                                      path_pad),
                 jax_value_and_grads(jax_params, packed, g, token_pad,
                                     path_pad, **kw),
                 dict(rtol=2e-5, atol=1e-6), FP32)


def test_capacity_rungs_give_the_same_gradients():
    rng = np.random.default_rng(43)
    jax_params = small_params()
    batch = random_plane_batch(rng, 8, 6)
    g = cotangent(8, 24)
    want = jax_value_and_grads(
        jax_params, jax_packed.pack_batch(batch, 0, 0, capacity_minimum=4),
        g, 0, 0, use_kernel=False)
    for rung in (4, 64):
        packed = jax_packed.pack_batch(batch, 0, 0, capacity_minimum=rung)
        assert packed.ctx.shape[1] >= rung
        assert_close(port_value_and_grads(jax_params, packed, g, 0, 0),
                     want, dict(rtol=2e-5, atol=1e-6), FP32)


def test_dropout_with_the_reference_keep_mask():
    """The reference's own keep mask (``_dropout_parts``, threefry) fed to
    the port: the same dropped values in the forward and the backward."""
    rng = np.random.default_rng(47)
    jax_params = small_params()
    batch = random_plane_batch(rng, 8, 7, 1, 2)
    packed = jax_packed.pack_batch(batch, 1, 2, data_shards=2,
                                   capacity_minimum=4)
    g = cotangent(8, 24)
    key = jax.random.PRNGKey(9)
    shards, cap, _ = packed.ctx.shape
    parts = pallas_ragged._dropout_parts(key, 0.75, 'threefry2x32', shards,
                                         cap, 8, 6)
    keep = torch.from_numpy(np.concatenate([np.asarray(p) for p in parts],
                                           axis=-1))
    assert 0.6 < float(keep.float().mean()) < 0.9
    want = jax_value_and_grads(jax_params, packed, g, 1, 2, use_kernel=True,
                               interpret=True, dropout_rng=key,
                               dropout_keep_rate=0.75,
                               dropout_prng_impl='threefry2x32')
    got = port_value_and_grads(jax_params, packed, g, 1, 2, keep_rate=0.75,
                               keep_mask=keep)
    assert_close(got, want, dict(rtol=2e-5, atol=1e-6), FP32)
    no_dropout = port_value_and_grads(jax_params, packed, g, 1, 2)
    assert not np.allclose(got[0], no_dropout[0])


def test_bf16_matches_the_interpreted_kernel():
    rng = np.random.default_rng(53)
    jax_params = small_params()
    batch = random_plane_batch(rng, 8, 8, hole_rate=0.3)
    packed = jax_packed.pack_batch(batch, 0, 0, capacity_minimum=4)
    g = cotangent(8, 24)
    got = port_value_and_grads(jax_params, packed, g, 0, 0,
                               dtype=torch.bfloat16)
    want = jax_value_and_grads(jax_params, packed, g, 0, 0,
                               dtype=jnp.bfloat16, use_kernel=True,
                               interpret=True)
    assert_close(got, want, dict(rtol=0, atol=1e-2), None)
    assert all(np.isfinite(t).all() for t in got[1])


def test_seeded_dropout_redraws_the_same_mask():
    """A dropout seed instead of a mask: the backward re-draws the mask of
    the forward (the gradients equal those of the explicit mask)."""
    rng = np.random.default_rng(59)
    jax_params = small_params()
    packed = jax_packed.pack_batch(random_plane_batch(rng, 8, 6), 0, 0,
                                   capacity_minimum=4)
    g = cotangent(8, 24)
    segs = ragged._segment_inputs(torch.from_numpy(packed.ctx),
                                  torch.from_numpy(packed.count), 0, 0)
    mask = ragged._draw_keep(1234, segs, 22, 0.75)
    seeded = port_value_and_grads(jax_params, packed, g, 0, 0,
                                  keep_rate=0.75, dropout_seed=1234)
    explicit = port_value_and_grads(jax_params, packed, g, 0, 0,
                                    keep_rate=0.75, keep_mask=mask)
    assert_close(seeded, explicit, dict(rtol=0, atol=0),
                 dict(rtol=0, atol=0))


def test_forward_saves_no_per_slot_tensor():
    rng = np.random.default_rng(61)
    params = convert.params_from_numpy(
        {k: np.asarray(v) for k, v in small_params()._asdict().items()})
    packed = jax_packed.pack_batch(random_plane_batch(rng, 8, 6), 0, 0,
                                   data_shards=2, capacity_minimum=4)
    leaves = [getattr(params, n).requires_grad_() for n in NAMES]
    ctx = torch.from_numpy(packed.ctx)
    count = torch.from_numpy(packed.count)
    code = ragged.ragged_encode_code(*leaves, ctx, count, token_pad=0,
                                     path_pad=0, keep_rate=0.75,
                                     dropout_seed=7)
    inputs = {t.data_ptr() for t in leaves + [ctx, count]}
    saved = code.grad_fn.saved_tensors
    assert len(saved) == 9
    for t in saved:
        if t.data_ptr() in inputs:
            continue
        # per example: (m, z) (D, Bs) and the (B, D) code vectors
        assert tuple(t.shape) in {(2, 4), (8, 24)}, tuple(t.shape)


def test_backward_wrapper_counts_no_launch_on_cpu():
    rng = np.random.default_rng(67)
    packed = jax_packed.pack_batch(random_plane_batch(rng, 8, 5), 0, 0,
                                   capacity_minimum=4)
    before = (ragged.launches, ragged.bwd_launches)
    port_value_and_grads(small_params(), packed, cotangent(8, 24), 0, 0)
    assert (ragged.launches, ragged.bwd_launches) == before
