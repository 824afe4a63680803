"""The port's embedding index (code2vec_tpu_torch/index/: store, exact,
IVF) against the JAX package's (code2vec_tpu/index/) on the CPU, the
same seeded numpy inputs through both:

- the store: a store built by either package opens in the other with
  equal rows, labels and meta;
- exact: ``ExactIndex`` against the JAX one (mesh None), cosine and dot:
  equal indices, scores within 2e-6; a tie-heavy integer grid bit for
  rank; k capped at the store size; ``search_streamed`` with k above
  the shard rows; the column-blocked search equal to the unblocked one
  with a block narrower than k and ties across block edges;
- IVF: ``kmeans`` on separated clusters (assignments equal, centroids
  within 1e-5), the port's ``IVFIndex`` opened on a JAX-built
  ``ivf.npz`` answering as the JAX one, full probe equal to exact,
  sentinels when the lists run dry;
- each tier's constructor raises without a GPU unless asked for the CPU,
  and a budget refusal is typed before anything is placed.

The card-side checks (the 4M-row store, recall, latency) live in
chip_smoke.py's index phase.
"""
import numpy as np
import pytest
import torch

from code2vec_tpu.index import exact as jax_exact
from code2vec_tpu.index import ivf as jax_ivf
from code2vec_tpu.index import store as jax_store
from code2vec_tpu.ops import topk as jax_topk
from code2vec_tpu_torch.index import exact, ivf
from code2vec_tpu_torch.index import store as store_lib
from code2vec_tpu_torch.ops import topk as port_topk
from code2vec_tpu_torch.telemetry import core, memory
from code2vec_tpu_torch.telemetry.memory import MemoryBudgetExceeded
from tests.test_index import clustered_corpus, reference_search

CPU = 'cpu'
ATOL = 2e-6


@pytest.fixture(autouse=True)
def fresh_state():
    memory.reset()
    core.reset()
    yield
    memory.reset()
    core.reset()


def _labels(n):
    return ['m%d' % i for i in range(n)]


# ------------------------------------------------------------------ store
@pytest.mark.parametrize('builder, reader', [
    (jax_store, store_lib), (store_lib, jax_store)],
    ids=['jax-built', 'port-built'])
@pytest.mark.parametrize('dtype', ['float32', 'float16'])
def test_store_opens_in_the_other_package(tmp_path, builder, reader, dtype):
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(300, 12)).astype(np.float32)
    built = builder.build(str(tmp_path / 's.vecindex'),
                          [vecs[:100], vecs[100:]], dtype=dtype,
                          metric='cosine', labels=_labels(300),
                          shard_rows=128)
    opened = reader.VectorStore(built.path)
    assert (opened.count, opened.dim, opened.dtype, opened.metric,
            opened.normalized, opened.shards) == (
                300, 12, np.dtype(dtype), 'cosine', True, [128, 128, 44])
    np.testing.assert_array_equal(opened.all_rows(), built.all_rows())
    assert list(opened.labels) == _labels(300)
    np.testing.assert_array_equal(opened.take([5, 140, 299]),
                                  built.take([5, 140, 299]))


def test_store_files_are_byte_identical(tmp_path):
    rng = np.random.default_rng(1)
    vecs = rng.normal(size=(50, 8)).astype(np.float32)
    for module, name in ((jax_store, 'a'), (store_lib, 'b')):
        store = module.build(str(tmp_path / name), [vecs], dtype='float16',
                             labels=_labels(50), shard_rows=32)
        store.append_rows(vecs[:3], labels=['x', 'y', 'z'])
    for fname in ('meta.json', 'labels.txt', 'shard_00000.bin',
                  'shard_00001.bin', 'shard_00002.bin'):
        assert (tmp_path / 'a' / fname).read_bytes() == \
            (tmp_path / 'b' / fname).read_bytes(), fname


# --------------------------------------------------------------- top-k
def test_padded_local_topk_and_host_merge_match_reference():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 4, (3, 5)).astype(np.float32)
    got_v, got_i = port_topk.padded_local_topk(torch.from_numpy(x), 8)
    want_v, want_i = jax_topk.padded_local_topk(x, 8)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    vals = rng.integers(0, 3, (4, 12)).astype(np.float32)
    idx = rng.permutation(48).reshape(4, 12)
    vals[0, :3] = -np.inf
    idx[0, :3] = port_topk.PAD_INDEX
    for got, want in zip(port_topk.merge_topk_host(vals, idx, 6),
                         jax_topk.merge_topk_host(vals, idx, 6)):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ exact
def _both_exact(store_or_vectors, **kwargs):
    """The port's index and the JAX one over the same store (each package
    opens it with its own ``VectorStore``) or array."""
    ref_source = store_or_vectors
    if isinstance(store_or_vectors, store_lib.VectorStore):
        ref_source = jax_store.VectorStore(store_or_vectors.path)
    return (exact.ExactIndex(store_or_vectors, device=CPU, **kwargs),
            jax_exact.ExactIndex(ref_source, **kwargs))


@pytest.mark.parametrize('metric', ['cosine', 'dot'])
@pytest.mark.parametrize('dtype', ['float32', 'float16'])
def test_exact_matches_reference(tmp_path, metric, dtype):
    vecs = clustered_corpus(900, 24, centers=9, seed=3)
    queries = clustered_corpus(70, 24, centers=9, seed=4)
    store = store_lib.build(str(tmp_path / 'e.vecindex'), [vecs],
                            dtype=dtype, metric=metric, shard_rows=256)
    port, ref = _both_exact(store)
    got_v, got_i = port.search(queries, 10)
    want_v, want_i = ref.search(queries, 10)
    assert got_i.shape == (70, 10)
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    np.testing.assert_allclose(got_v, np.asarray(want_v), rtol=0, atol=ATOL)


def test_exact_tie_heavy_grid_is_bit_for_rank(tmp_path):
    rng = np.random.default_rng(5)
    vecs = rng.integers(-2, 3, (500, 6)).astype(np.float32)
    queries = rng.integers(-2, 3, (20, 6)).astype(np.float32)
    port, ref = _both_exact(vecs, metric='dot')
    got_v, got_i = port.search(queries, 25)
    want_v, want_i = ref.search(queries, 25)
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    np.testing.assert_array_equal(got_v, np.asarray(want_v))
    _np_v, np_i = reference_search(vecs, queries, 25, metric='dot')
    np.testing.assert_array_equal(got_i, np_i)


@pytest.mark.parametrize('block_rows', [3, 7, 64])
def test_blocked_search_equals_unblocked(block_rows):
    """Blocks narrower than k, and equal scores straddling block edges
    (every other row repeats its neighbour), merge to the unblocked
    top-k bit for rank."""
    rng = np.random.default_rng(6)
    base = rng.integers(-3, 4, (100, 5)).astype(np.float32)
    vecs = np.repeat(base, 2, axis=0)
    queries = torch.from_numpy(
        rng.integers(-3, 4, (9, 5)).astype(np.float32))
    rows = torch.from_numpy(vecs)
    k = 10
    want_v, want_i = port_topk.top_k(queries @ rows.T, k)
    got_v, got_i = exact.block_topk(queries, rows, k, block_rows)
    assert torch.equal(got_i, want_i) and torch.equal(got_v, want_v)
    index = exact.ExactIndex(vecs, metric='dot', device=CPU,
                             block_rows=block_rows)
    values, indices = index.search(queries.numpy(), k)
    np.testing.assert_array_equal(indices, want_i.numpy())
    ref_v, ref_i = jax_exact.ExactIndex(vecs, metric='dot').search(
        queries.numpy(), k)
    np.testing.assert_array_equal(indices, np.asarray(ref_i))
    np.testing.assert_array_equal(values, np.asarray(ref_v))


def test_exact_caps_k_and_takes_one_query(tmp_path):
    vecs = clustered_corpus(7, 8, centers=2, seed=7)
    port, ref = _both_exact(vecs)
    got_v, got_i = port.search(vecs[0], 50)
    want_v, want_i = ref.search(vecs[0], 50)
    assert got_i.shape == (1, 7)
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    np.testing.assert_allclose(got_v, np.asarray(want_v), atol=ATOL)
    with pytest.raises(ValueError, match='dim'):
        port.search(np.zeros((1, 9), np.float32), 3)


def test_streamed_matches_exact_with_k_above_shard_rows(tmp_path):
    vecs = clustered_corpus(330, 16, centers=6, seed=8)
    queries = clustered_corpus(9, 16, centers=6, seed=9)
    store = store_lib.build(str(tmp_path / 's.vecindex'), [vecs],
                            shard_rows=40)
    got_v, got_i = exact.search_streamed(store, queries, 64, device=CPU)
    want_v, want_i = jax_exact.search_streamed(
        jax_store.VectorStore(store.path), queries, 64)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_v, want_v, atol=ATOL)
    dev_v, dev_i = exact.ExactIndex(store, device=CPU).search(queries, 64)
    np.testing.assert_array_equal(got_i, dev_i)
    np.testing.assert_allclose(got_v, dev_v, atol=ATOL)


def test_exact_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match='A9'):
        exact.ExactIndex(np.ones((4, 2), np.float32), mesh=object(),
                         device=CPU)


# -------------------------------------------------------------------- IVF
def test_kmeans_matches_reference_on_separated_clusters():
    vecs = store_lib.normalize_rows(
        clustered_corpus(600, 16, centers=8, seed=10, spread=0.05))
    got_c, got_a = ivf.kmeans(vecs, 8, iters=6, seed=3, device=CPU)
    want_c, want_a = jax_ivf.kmeans(vecs, 8, iters=6, seed=3)
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-5)
    assert got_a.dtype == np.int32 and got_c.dtype == np.float32


def test_segment_sum_equals_index_add():
    rng = np.random.default_rng(11)
    data = torch.from_numpy(rng.normal(size=(1000, 5)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 7, 1000))
    want = torch.zeros(7, 5).index_add_(0, ids, data)
    torch.testing.assert_close(ivf.segment_sum(data, ids, 7), want,
                               rtol=1e-5, atol=1e-5)


@pytest.fixture
def ivf_store(tmp_path):
    vecs = clustered_corpus(1200, 16, centers=20, seed=12)
    store = store_lib.build(str(tmp_path / 'ivf.vecindex'), [vecs],
                            labels=_labels(1200))
    return store, vecs


def test_ivf_serves_a_reference_sidecar_as_the_reference(ivf_store):
    store, vecs = ivf_store
    ref = jax_ivf.IVFIndex.build(jax_store.VectorStore(store.path),
                                 n_clusters=24, seed=1, nprobe=3)
    port = ivf.IVFIndex(store_lib.VectorStore(store.path), nprobe=3,
                        device=CPU)
    np.testing.assert_array_equal(port.list_ids, ref.list_ids)
    queries = clustered_corpus(40, 16, centers=20, seed=13)
    for nprobe in (1, 3, 24):
        got_v, got_i = port.search(queries, 10, nprobe=nprobe)
        want_v, want_i = ref.search(queries, 10, nprobe=nprobe)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_v, np.asarray(want_v), atol=ATOL)
    assert port.last_fill_s >= 0.0


def test_ivf_build_writes_the_reference_sidecar(ivf_store, tmp_path):
    store, _vecs = ivf_store
    port = ivf.IVFIndex.build(store, n_clusters=16, seed=2, device=CPU)
    ref = jax_ivf.IVFIndex(jax_store.VectorStore(store.path))
    np.testing.assert_array_equal(ref.list_ids, port.list_ids)
    np.testing.assert_array_equal(ref.offsets, port.offsets)
    np.testing.assert_array_equal(ref.centroids, port.centroids)


def test_ivf_full_probe_equals_exact_and_recall(ivf_store):
    store, vecs = ivf_store
    index = ivf.IVFIndex.build(store, n_clusters=16, seed=0, device=CPU)
    dense = exact.ExactIndex(store, device=CPU)
    queries = vecs[::97]
    got_v, got_i = index.search(queries, 10, nprobe=16)
    want_v, want_i = dense.search(queries, 10)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_v, want_v, atol=ATOL)
    recall = ivf.measure_recall(index, dense, queries, k=10, nprobe=4)
    ref_recall = jax_ivf.measure_recall(
        jax_ivf.IVFIndex(jax_store.VectorStore(store.path)),
        jax_exact.ExactIndex(jax_store.VectorStore(store.path)),
        queries, k=10, nprobe=4)
    assert recall == ref_recall and recall > 0.8


def test_ivf_pads_with_sentinels_when_lists_run_dry(tmp_path):
    vecs = clustered_corpus(40, 8, centers=4, seed=14, spread=0.02)
    store = store_lib.build(str(tmp_path / 'dry.vecindex'), [vecs])
    index = ivf.IVFIndex.build(store, n_clusters=8, seed=0, device=CPU)
    values, indices = index.search(vecs[:3], 30, nprobe=1)
    assert indices.shape == (3, 30)
    dry = indices < 0
    assert dry.any(axis=1).all()
    assert np.isneginf(values[dry]).all()
    assert np.isfinite(values[~dry]).all()


# ------------------------------------------------- device and the budget
@pytest.mark.parametrize('tier', ['exact', 'ivf', 'quant'])
def test_tier_constructors_need_a_gpu_unless_asked_for_the_cpu(
        ivf_store, monkeypatch, tier):
    from code2vec_tpu_torch.index.quant import QuantizedIVFIndex
    store, _vecs = ivf_store
    ivf.IVFIndex.build(store, n_clusters=8, seed=0, device=CPU)
    if tier == 'quant':
        QuantizedIVFIndex.build(store, kind='int8', seed=0, device=CPU)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    build = {'exact': lambda: exact.ExactIndex(store),
             'ivf': lambda: ivf.IVFIndex(store),
             'quant': lambda: QuantizedIVFIndex(store)}[tier]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build()


def test_exact_budget_refusal_is_typed_and_places_nothing(
        tmp_path, monkeypatch):
    placed = []
    real_place = exact.place
    monkeypatch.setattr(exact, 'place',
                        lambda *a: placed.append(1) or real_place(*a))
    memory.ledger().configure(budget_bytes=1024, dump_dir=str(tmp_path))
    with pytest.raises(MemoryBudgetExceeded, match='exact tier'):
        exact.ExactIndex(np.ones((64, 8), np.float32), device=CPU)
    assert placed == []
    assert memory.ledger().bucket_bytes('index') == 0
    memory.ledger().configure(budget_bytes=0)
    index = exact.ExactIndex(np.ones((64, 8), np.float32), device=CPU)
    assert memory.ledger().bucket_bytes('index') == 64 * 8 * 4
    del index
    assert memory.ledger().bucket_bytes('index') == 0
