"""The port's packed wire (code2vec_tpu_torch/data/packed.py) against the
reference's (code2vec_tpu/data/packed.py): the host packer bit for bit,
and the torch segment structure equal to the JAX one, over the
tests/test_packed.py property regime — zero-length rows, interior holes,
capacity < batch, 1 and 4 data shards, nonzero PAD."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.data import packed as jax_packed
from code2vec_tpu_torch.data import packed as torch_packed
from tests.test_packed import random_plane_batch


@pytest.mark.parametrize('token_pad,path_pad', [(0, 0), (1, 2)])
@pytest.mark.parametrize('data_shards', [1, 4])
@pytest.mark.parametrize('capacity_minimum', [4, 64])
def test_pack_batch_bit_equal(token_pad, path_pad, data_shards,
                              capacity_minimum):
    rng = np.random.default_rng(5)
    for _trial in range(6):
        contexts = int(rng.choice([3, 6, 13]))
        batch = random_plane_batch(rng, 8, contexts, token_pad, path_pad)
        want = jax_packed.pack_batch(batch, token_pad, path_pad,
                                     data_shards=data_shards,
                                     capacity_minimum=capacity_minimum)
        got = torch_packed.pack_batch(batch, token_pad, path_pad,
                                      data_shards=data_shards,
                                      capacity_minimum=capacity_minimum)
        for name in ('ctx', 'count', 'label', 'weight'):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_bucketed_capacity_equal():
    for total in [0, 1, 63, 64, 65, 200, 1000, 28_700, 204_800]:
        assert (torch_packed.bucketed_capacity(total)
                == jax_packed.bucketed_capacity(total))


def _assert_segments_equal(count2: np.ndarray, cap: int):
    want = jax_packed.segment_structure(jnp.asarray(count2), cap)
    got = torch_packed.segment_structure(torch.from_numpy(count2), cap)
    for name, g, w in zip(('seg', 'pos', 'in_range'), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize('token_pad,path_pad', [(0, 0), (1, 2)])
@pytest.mark.parametrize('data_shards', [1, 4])
def test_segment_structure_matches_reference(token_pad, path_pad,
                                             data_shards):
    rng = np.random.default_rng(9)
    for _trial in range(6):
        contexts = int(rng.choice([3, 5, 8]))
        batch = random_plane_batch(rng, 8, contexts, token_pad, path_pad)
        packed = jax_packed.pack_batch(batch, token_pad, path_pad,
                                       data_shards=data_shards,
                                       capacity_minimum=4)
        count2 = packed.count.reshape(data_shards, -1)
        _assert_segments_equal(count2, packed.ctx.shape[1])


def test_segment_structure_capacity_below_batch():
    """More examples than slots, zero-length rows whose starts stack at
    and past the capacity (the reference's mode='drop' scatter)."""
    count2 = np.zeros((2, 12), np.int32)
    count2[0, :4] = [1, 2, 0, 3]
    count2[1, [0, 5, 11]] = [2, 1, 1]
    _assert_segments_equal(count2, 6)
    _assert_segments_equal(count2, 8)


def test_segment_structure_single_example_and_empty():
    _assert_segments_equal(np.array([[5]], np.int32), 8)
    _assert_segments_equal(np.zeros((1, 4), np.int32), 4)
