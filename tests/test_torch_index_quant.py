"""The port's quantized IVF tier (code2vec_tpu_torch/index/quant.py)
against the JAX package's (code2vec_tpu/index/quant.py) on the CPU:

- the codecs: int8 codes equal; PQ codes equal on separated data, one
  codebook update within 1e-5, and ``train_pq`` deterministic and as
  good as the reference's;
- a JAX-built ``quant.npz`` plus live segments serves in the port as in
  the JAX package (indices equal; scores within 2e-6 under the exact
  re-rank, within 1e-5 for PQ's quantized order without it);
- full probe with full re-rank equals exact; append-then-compact equals
  a fresh build bit for rank; an insert that lands mid-compaction is
  kept; a budget refusal is typed and places nothing; the ledger holds
  an ``index`` entry per segment.
"""
import threading

import numpy as np
import pytest

from code2vec_tpu.index import quant as jax_quant
from code2vec_tpu.index import store as jax_store
from code2vec_tpu_torch.index import exact, quant
from code2vec_tpu_torch.index import store as store_lib
from code2vec_tpu_torch.index.quant import QuantizedIVFIndex
from code2vec_tpu_torch.telemetry import core, memory
from code2vec_tpu_torch.telemetry.memory import MemoryBudgetExceeded
from tests.test_index import clustered_corpus

CPU = 'cpu'
ATOL = 2e-6


@pytest.fixture(autouse=True)
def fresh_state():
    memory.reset()
    core.reset()
    yield
    memory.reset()
    core.reset()


def small_store(tmp_path, n=800, dim=16, centers=12, seed=0,
                labels=True, name='q.vecindex'):
    vecs = clustered_corpus(n, dim, centers=centers, seed=seed)
    return store_lib.build(
        str(tmp_path / name), [vecs],
        labels=(['m%d' % i for i in range(n)] if labels else None)), vecs


def _search_all(index, queries, k):
    """Full probe, full re-rank: the exact re-rank decides the order."""
    index.rerank = 10 ** 6
    return index.search(queries, k, nprobe=index.n_clusters)


# ----------------------------------------------------------------- codecs
def test_int8_codes_equal_reference():
    vecs = clustered_corpus(300, 16, centers=5, seed=1)
    scale = quant.train_int8(vecs)
    np.testing.assert_array_equal(scale, jax_quant.train_int8(vecs))
    np.testing.assert_array_equal(quant.encode_int8(vecs, scale),
                                  jax_quant.encode_int8(vecs, scale))


def test_pq_update_and_codes_match_reference():
    """One Lloyd update of the codebooks from the same assignments within
    1e-5 of the reference's, and the codes equal on separated data (the
    rows' subspaces near distinct codewords). Whole ``train_pq`` runs
    differ where near-tied rows pick other codewords, so they are held
    to the reference's quantization error and to themselves."""
    import torch
    rng = np.random.default_rng(2)
    x = rng.normal(size=(500, 4, 2)).astype(np.float32)
    assign = rng.integers(0, 256, (500, 4)).astype(np.int32)
    books = rng.normal(size=(4, 256, 2)).astype(np.float32)
    got = quant._pq_update(torch.from_numpy(x),
                           torch.from_numpy(assign).long(),
                           torch.from_numpy(books)).numpy()
    want = np.asarray(jax_quant._pq_update(x, assign, books))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert quant.resolve_pq_m(8, 0) == jax_quant.resolve_pq_m(8, 0) == 2
    assert quant.resolve_pq_m(384, 96) == 96
    picks = rng.integers(0, 256, (400, 4))
    words = np.stack([books[m, picks[:, m]] for m in range(4)], axis=1)
    vecs = (words.reshape(400, 8)
            + 1e-6 * rng.normal(size=(400, 8))).astype(np.float32)
    np.testing.assert_array_equal(quant.encode_pq(vecs, books, device=CPU),
                                  jax_quant.encode_pq(vecs, books))
    sample = clustered_corpus(600, 8, centers=6, seed=3)
    trained = quant.train_pq(sample, 2, iters=4, seed=0, device=CPU)
    np.testing.assert_array_equal(
        trained, quant.train_pq(sample, 2, iters=4, seed=0, device=CPU))

    def error(codebooks, codes):
        rebuilt = np.take_along_axis(
            codebooks, codes.T.astype(np.int64)[:, :, None], axis=1)
        return float(np.mean((rebuilt.transpose(1, 0, 2).reshape(600, 8)
                              - sample) ** 2))

    ref = jax_quant.train_pq(sample, 2, iters=4, seed=0)
    got_err = error(trained, quant.encode_pq(sample, trained, device=CPU))
    want_err = error(ref, jax_quant.encode_pq(sample, ref))
    assert got_err <= 1.05 * want_err


# ------------------------------------------------ sidecars across packages
@pytest.mark.parametrize('kind', ['int8', 'pq'])
def test_reference_sidecars_serve_as_in_the_reference(tmp_path, kind):
    store, vecs = small_store(tmp_path)
    ref_store = jax_store.VectorStore(store.path)
    ref = jax_quant.QuantizedIVFIndex.build(
        ref_store, kind=kind, seed=0, nprobe=3, segment_rows=16,
        compact_segments=0)
    ref.insert(vecs[37:60] + 0.001, labels=['n%d' % i for i in range(23)])
    port = QuantizedIVFIndex(store_lib.VectorStore(store.path), nprobe=3,
                             device=CPU)
    assert (port.kind, port.version, port.segment_count, port.count) == (
        kind, 0, 2, 823)
    assert list(port.labels[-2:]) == ['n21', 'n22']
    queries = np.concatenate([vecs[::53], vecs[37:40] + 0.001])
    got_v, got_i = port.search(queries, 10)
    want_v, want_i = ref.search(queries, 10)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=ATOL)
    # the quantized order itself, without the re-rank
    port.rerank = ref.rerank = 0
    got_v, got_i = port.search(queries, 10)
    want_v, want_i = ref.search(queries, 10)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_v, np.asarray(want_v), rtol=0,
                               atol=1e-5 if kind == 'pq' else ATOL)


@pytest.mark.parametrize('kind', ['int8', 'pq'])
def test_port_build_writes_sidecars_the_reference_serves(tmp_path, kind):
    store, vecs = small_store(tmp_path, n=500, centers=8)
    port = QuantizedIVFIndex.build(store, kind=kind, seed=0, nprobe=2,
                                   device=CPU)
    port.insert(vecs[:5] + 0.002)
    ref = jax_quant.QuantizedIVFIndex(jax_store.VectorStore(store.path),
                                      nprobe=2)
    assert ref.segment_count == 1 and ref.bytes_per_vector == \
        port.bytes_per_vector == (16 if kind == 'int8' else 4)
    got_v, got_i = port.search(vecs[::41], 5)
    want_v, want_i = ref.search(vecs[::41], 5)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=ATOL)


@pytest.mark.parametrize('kind', ['int8', 'pq'])
def test_full_probe_full_rerank_equals_exact(tmp_path, kind):
    store, vecs = small_store(tmp_path, n=600)
    index = QuantizedIVFIndex.build(store, kind=kind, seed=0, device=CPU)
    queries = vecs[::67]
    got_v, got_i = _search_all(index, queries, 10)
    want_v, want_i = exact.ExactIndex(store, device=CPU).search(queries, 10)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=ATOL)


# ------------------------------------------------- inserts and compaction
@pytest.mark.parametrize('kind', ['int8', 'pq'])
def test_append_then_compact_equals_fresh_build(tmp_path, kind):
    base = clustered_corpus(600, 16, centers=10, seed=4)
    extra1 = clustered_corpus(40, 16, centers=10, seed=5)
    dupes = base[100:110].copy()
    extra2 = clustered_corpus(25, 16, centers=10, seed=6)
    store, _ = small_store(tmp_path, n=600, centers=10, seed=4,
                           labels=False)
    index = QuantizedIVFIndex.build(store, kind=kind, seed=0,
                                    segment_rows=16, compact_segments=0,
                                    device=CPU)
    index.insert(extra1)
    index.insert(np.empty((0, 16), np.float32))
    index.insert(dupes)
    index.insert(extra2)
    queries = np.concatenate([base[::151][:4], extra1[:2], dupes[:2]])
    pre_v, pre_i = _search_all(index, queries, 10)
    assert index.compact() == 75 and index.version == 1
    post_v, post_i = _search_all(index, queries, 10)
    np.testing.assert_array_equal(pre_i, post_i)
    np.testing.assert_array_equal(pre_v, post_v)
    full = np.concatenate([base, extra1, dupes, extra2])
    fresh_store = store_lib.build(str(tmp_path / 'fresh.vecindex'),
                                  [full])
    fresh = QuantizedIVFIndex.build(fresh_store, kind=kind, seed=0,
                                    device=CPU)
    fresh_v, fresh_i = _search_all(fresh, queries, 10)
    np.testing.assert_array_equal(post_i, fresh_i)
    np.testing.assert_array_equal(post_v, fresh_v)


def test_auto_compaction_and_reopen(tmp_path):
    store, vecs = small_store(tmp_path)
    index = QuantizedIVFIndex.build(store, kind='int8', seed=0,
                                    segment_rows=4, compact_segments=2,
                                    device=CPU)
    index.insert(vecs[:4] + 0.001)
    index.insert(vecs[4:8] + 0.001)
    assert index.segment_count == 2 and index.compactions == 0
    index.insert(vecs[8:12] + 0.001)      # the third segment compacts
    assert (index.segment_count, index.compactions, index.store.count,
            index.version) == (0, 1, 812, 1)
    ids = index.insert(vecs[20:22] + 0.003)
    reopened = QuantizedIVFIndex(store_lib.VectorStore(store.path),
                                 device=CPU)
    assert (reopened.segment_count, reopened.count) == (1, 814)
    assert ids[0] in reopened.search(vecs[20:21] + 0.003, 5)[1][0]


def test_insert_landing_mid_compaction_is_kept(tmp_path):
    store, vecs = small_store(tmp_path, n=400)
    index = QuantizedIVFIndex.build(store, kind='int8', seed=0,
                                    compact_segments=0, device=CPU)
    index.insert(vecs[:6] + 0.001)
    racer_ids = []
    entered = threading.Event()
    real_append = index.store.append_rows

    def slow_append(*args, **kwargs):
        # the racer starts while compaction holds the lock
        entered.set()
        thread.join(0.2)
        return real_append(*args, **kwargs)

    index.store.append_rows = slow_append

    def racer():
        entered.wait()
        racer_ids.append(index.insert(vecs[6:9] + 0.002))

    thread = threading.Thread(target=racer)
    thread.start()
    index.compact()
    thread.join()
    assert len(racer_ids) == 1 and index.count == 409
    assert index.segment_count == 1
    _values, got = index.search(vecs[6:9] + 0.002, 5)
    for j, rid in enumerate(racer_ids[0]):
        assert rid in got[j]


# ------------------------------------------------------ budget and ledger
def test_budget_refusal_is_typed_and_places_nothing(tmp_path, monkeypatch):
    store, _vecs = small_store(tmp_path)
    QuantizedIVFIndex.build(store, kind='int8', seed=0, device=CPU)
    memory.reset()
    placed = []
    real_place = quant.place
    monkeypatch.setattr(quant, 'place',
                        lambda *a: placed.append(1) or real_place(*a))
    memory.ledger().configure(budget_bytes=64, dump_dir=str(tmp_path))
    with pytest.raises(MemoryBudgetExceeded, match='index attach'):
        QuantizedIVFIndex(store_lib.VectorStore(store.path), device=CPU)
    assert placed == []
    assert memory.ledger().bucket_bytes('index') == 0


def test_ledger_keys_index_bucket_per_segment(tmp_path):
    store, vecs = small_store(tmp_path)
    index = QuantizedIVFIndex.build(store, kind='pq', seed=0,
                                    segment_rows=8, compact_segments=0,
                                    device=CPU)
    index.insert(vecs[:20])     # 3 segments (8 + 8 + 4)
    snapshot = memory.ledger().snapshot(reconcile=False)
    keys = [entry['key'] for entry
            in snapshot['buckets']['index']['entries']]
    assert len([key for key in keys if ':seg0' in key]) == 3
    assert any(key.endswith(':base') for key in keys)
    assert memory.ledger().bucket_bytes('index') == index.device_nbytes
