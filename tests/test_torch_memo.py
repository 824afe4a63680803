"""The port's memo tier (code2vec_tpu_torch/serving/memo.py) against the
reference's (code2vec_tpu/serving/memo.py), and through the port's mesh,
on the CPU:

- identity: ``canonicalize_contexts`` and ``request_key`` give the
  reference's lines and sha256 bytes on the same requests, so the port's
  cache hits on the reference's keys;
- the cache: one sequence of inserts and lookups into both caches gives
  the same LRU survivors, byte totals, counters and ledger bytes (the
  ``memo`` bucket, kind='host'); generation and index-generation
  invalidation, the semantic tier with shadow sampling and its agreement,
  isolation from caller mutation — as the reference's unit tests;
- the mesh (tests/test_serving_memo.py's mesh cases): an exact hit
  resolved at submit, bit for bit the live answer through the same mesh
  and within rtol 2e-5 / atol 1e-6 of ``predict`` (another batch shape:
  ROADMAP C4 — the reference's own test compares across batch shapes
  bit for bit and fails by one ulp); the memo off by default; the
  oversize split and join; a degraded tier that cannot poison the full
  tier; the rollover invalidation drill; the neighbor exact and semantic
  tiers; the stand-down during a canary.
"""
import time

import numpy as np
import pytest

from code2vec_tpu.data.reader import canonicalize_contexts as ref_canon
from code2vec_tpu.serving import memo as ref_memo
from code2vec_tpu.telemetry import memory as ref_memory
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data.reader import canonicalize_contexts
from code2vec_tpu_torch.index.service import (NeighborResult,
                                              neighbors_from_search)
from code2vec_tpu_torch.model_api import Code2VecModel
from code2vec_tpu_torch.serving import memo as memo_lib
from code2vec_tpu_torch.telemetry import memory as memory_lib
from tests.test_train_overfit import make_dataset

RTOL, ATOL = 2e-5, 1e-6
PREDICT_LINES = [
    'get|a toka0,pA,toka1 toka1,pB,toka2',
    'set|b tokb0,pA,tokb1',
    'run|c tokc0,pC,tokc1 tokc2,pA,tokc0 tokc1,pB,tokc2',
]
# the same requests with each line's contexts permuted (and a stray
# space): the same canonical lines, so the same keys
PERMUTED_LINES = [
    'get|a toka1,pB,toka2 toka0,pA,toka1',
    'set|b  tokb0,pA,tokb1',
    'run|c tokc1,pB,tokc2 tokc0,pC,tokc1 tokc2,pA,tokc0',
]


@pytest.fixture(autouse=True)
def fresh_ledgers():
    memory_lib.reset()
    ref_memory.reset()
    yield
    memory_lib.reset()
    ref_memory.reset()


@pytest.fixture(scope='module')
def model(tmp_path_factory):
    prefix = make_dataset(tmp_path_factory.mktemp('torch_memo'))
    return Code2VecModel(Config(
        TRAIN_DATA_PATH_PREFIX=str(prefix), COMPUTE_DTYPE='float32',
        MAX_CONTEXTS=6, SERVING_BATCH_BUCKETS='8,16'), device='cpu')


def assert_rows_identical(a_rows, b_rows):
    """Bit identity of two result lists."""
    assert len(a_rows) == len(b_rows)
    for a, b in zip(a_rows, b_rows):
        assert a.original_name == b.original_name
        assert a.topk_predicted_words == b.topk_predicted_words
        if a.topk_predicted_words_scores is None:
            assert b.topk_predicted_words_scores is None
        else:
            np.testing.assert_array_equal(a.topk_predicted_words_scores,
                                          b.topk_predicted_words_scores)
        assert a.attention_per_context == b.attention_per_context
        if a.code_vector is None:
            assert b.code_vector is None
        else:
            np.testing.assert_array_equal(a.code_vector, b.code_vector)


def assert_rows_close(got, want):
    """The tier's outputs within rtol 2e-5 / atol 1e-6, words equal."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.original_name == w.original_name
        assert g.topk_predicted_words == w.topk_predicted_words
        np.testing.assert_allclose(g.topk_predicted_words_scores,
                                   w.topk_predicted_words_scores,
                                   rtol=RTOL, atol=ATOL)


# --------------------------------------------------- canonical identity
KEY_CASES = [
    (PREDICT_LINES, 'topk', None), (PERMUTED_LINES, 'topk', None),
    (PREDICT_LINES, 'full', None), (PREDICT_LINES, 'neighbors', 5),
    (PREDICT_LINES, 'neighbors', 10),
    (['lab c,p,3 a,p,1 b,p,2', '', 'l2 a,b,c  x,y,z '], 'attention', None),
    (['mé|thode ünï,cödé,pâth a,p,b a,p,b'], 'vectors', None),
]


@pytest.mark.parametrize('case', range(len(KEY_CASES)))
@pytest.mark.parametrize('max_contexts', [None, 2, 6])
def test_request_key_bytes_equal_reference(case, max_contexts):
    lines, tier, k = KEY_CASES[case]
    canon = canonicalize_contexts(lines, max_contexts)
    assert canon == ref_canon(lines, max_contexts)
    key = memo_lib.request_key(canon, tier, k=k)
    assert key == ref_memo.request_key(canon, tier, k=k)
    assert len(key) == 32


def test_request_key_scopes_tier_k_and_line_order():
    canon = canonicalize_contexts(PREDICT_LINES)
    assert memo_lib.request_key(canon, 'topk') == memo_lib.request_key(
        canonicalize_contexts(PERMUTED_LINES), 'topk')
    assert memo_lib.request_key(canon, 'topk') != \
        memo_lib.request_key(canon, 'full')
    assert memo_lib.request_key(canon, 'neighbors', k=5) != \
        memo_lib.request_key(canon, 'neighbors', k=10)
    assert memo_lib.request_key(canon, 'topk') != memo_lib.request_key(
        [canon[1], canon[0], canon[2]], 'topk')


# ------------------------------------------------------ MemoCache units
def _rows(i, n=128):
    return [{'scores': np.full(n, i, np.float64), 'name': 'r%d' % i}]


def _drive_lru(memo_mod, ledger):
    """One sequence of inserts and lookups; returns what the cache says
    along the way."""
    cache = memo_mod.MemoCache(4096)
    out = []
    try:
        keys = [memo_mod.request_key(['l%d a,b,c' % i], 'topk')
                for i in range(8)]
        for i, key in enumerate(keys):
            out.append(cache.insert(key, _rows(i), cache.generation))
            if i == 2:
                out.append(cache.lookup(keys[0]) is not None)  # recency
        out.append([cache.lookup(key) is not None for key in keys])
        out.append(cache.insert(keys[0], _rows(0, 4096), cache.generation))
        stats = cache.stats()
        out.append({k: v for k, v in stats.items() if k != 'semantic'})
        out.append(ledger.bucket_bytes('memo'))
        old = cache.generation
        cache.bump_generation(3)
        out.append(cache.insert(keys[0], _rows(0), old))
        out.append(cache.lookup(keys[-1]))
        out.append(cache.stats()['params_step'])
    finally:
        cache.close()
    out.append(ledger.bucket_bytes('memo'))
    return out


def test_lru_eviction_order_and_bytes_equal_reference():
    got = _drive_lru(memo_lib, memory_lib.ledger())
    want = _drive_lru(ref_memo, ref_memory.ledger())
    assert got == want
    stats = got[-6]
    assert stats['evictions'] > 0 and stats['bytes'] <= 4096
    assert got[-5] == stats['bytes']          # the ledger's memo bucket
    assert got[-1] == 0                       # released at close


def test_results_nbytes_and_copy_equal_reference():
    tree = [NeighborResult(indices=np.array([2, 0]),
                           scores=np.array([0.9, 0.5], np.float32),
                           labels=['c', 'a']),
            {'x': (1, 2.0, None, 'abc'), 'y': [np.zeros(3), b'xy']},
            object()]
    assert memo_lib.results_nbytes(tree) == ref_memo.results_nbytes(tree)
    copied = memo_lib.copy_results(tree)
    assert type(copied[0]) is NeighborResult
    assert copied[0].scores is not tree[0].scores
    assert copied[2] is tree[2]


def test_generation_bump_is_not_eviction():
    cache = memo_lib.MemoCache(1 << 20)
    try:
        key = memo_lib.request_key(['l a,b,c'], 'topk')
        cache.insert(key, [{'s': np.zeros(8)}], cache.generation)
        before = cache.stats()
        cache.bump_generation()
        after = cache.stats()
        assert after['generation'] == before['generation'] + 1
        assert after['entries'] == 0 and after['bytes'] == 0
        assert after['evictions'] == before['evictions'] == 0
        assert cache.lookup(key) is None
    finally:
        cache.close()


def test_stale_generation_eviction_reexports_gauges():
    cache = memo_lib.MemoCache(1 << 20)
    try:
        key = memo_lib.request_key(['l a,b,c'], 'topk')
        cache.insert(key, [{'s': np.zeros(64)}], cache.generation)
        assert cache.bytes_gauge.snapshot() > 0
        assert memory_lib.ledger().bucket_bytes('memo') > 0
        cache._entries[key].generation += 1
        assert cache.lookup(key) is None
        assert cache.bytes_gauge.snapshot() == 0
        assert cache.entries_gauge.snapshot() == 0
        assert memory_lib.ledger().bucket_bytes('memo') == 0
    finally:
        cache.close()


def test_memo_bucket_is_host_kind_outside_reconciliation():
    cache = memo_lib.MemoCache(1 << 20)
    try:
        cache.insert(memo_lib.request_key(['l a,b,c'], 'topk'),
                     [{'s': np.zeros(64)}], cache.generation)
        snap = memory_lib.ledger().snapshot(reconcile=False)
        (entry,) = snap['buckets']['memo']['entries']
        assert entry['kind'] == 'host' and entry['bytes'] > 0
        assert snap['attributed_bytes'] == 0
    finally:
        cache.close()


def test_hits_isolated_from_caller_mutation():
    cache = memo_lib.MemoCache(1 << 20)
    try:
        key = memo_lib.request_key(['l a,b,c'], 'neighbors', k=2)
        live = [NeighborResult(indices=np.array([2, 0]),
                               scores=np.array([0.9, 0.5], np.float32),
                               labels=['c', 'a'])]
        cache.insert(key, live, cache.generation)
        live[0].scores[:] = -1.0
        live[0].labels.append('poison')
        hit = cache.lookup(key)
        assert type(hit[0]) is NeighborResult
        np.testing.assert_array_equal(hit[0].scores,
                                      np.array([0.9, 0.5], np.float32))
        assert hit[0].labels == ['c', 'a']
        hit[0].scores[:] = 7.0
        hit[0].labels.clear()
        again = cache.lookup(key)
        assert again[0] is not hit[0]
        np.testing.assert_array_equal(again[0].scores,
                                      np.array([0.9, 0.5], np.float32))
        assert again[0].labels == ['c', 'a']
    finally:
        cache.close()


def _drive_semantic(memo_mod, search_mod):
    cache = memo_mod.MemoCache(1 << 20, semantic_epsilon=0.05,
                               semantic_shadow_every=2)
    out = []
    try:
        vec = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
        rows = search_mod(np.array([[0.9, 0.5]]), np.array([[2, 0]]),
                          ['a', 'b', 'c'])
        out.append(cache.semantic_insert(vec[None, :], rows, 10,
                                         cache.generation))
        near = vec * 1.001 + np.array([0.0, 1e-3, 0.0, 0.0], np.float32)
        for _ in range(3):
            hit = cache.semantic_lookup(near, 10)
            out.append(None if hit is None else (hit[0].labels, hit[1]))
        far = np.array([0.0, 1.0, 0.0, 0.0], np.float32)
        out.append(cache.semantic_lookup(far, 10))
        out.append(cache.semantic_lookup(near, 5))
        other = search_mod(np.array([[0.8, 0.1]]), np.array([[1, 0]]),
                           ['a', 'b', 'c'])
        cache.note_semantic_agreement(rows[0], rows[0])
        cache.note_semantic_agreement(rows[0], other[0])
        out.append(cache.stats()['semantic'])
        out.append(cache.agreement_gauge.snapshot())
        cache.bump_index_generation()
        out.append(cache.semantic_lookup(vec, 10))
        out.append(cache.semantic_insert(
            vec[None, :], rows, 10, cache.generation,
            index_generation=cache.index_generation - 1))
    finally:
        cache.close()
    return out


def test_semantic_tier_equals_reference():
    from code2vec_tpu.index.service import \
        neighbors_from_search as ref_search
    got = _drive_semantic(memo_lib, neighbors_from_search)
    want = _drive_semantic(ref_memo, ref_search)
    assert got == want
    assert got[1:4] == [(['c', 'a'], False), (['c', 'a'], True),
                        (['c', 'a'], False)]
    assert got[6]['samples'] == 2
    assert got[6]['agreement'] == pytest.approx(0.5)


def test_semantic_serves_isolated_copies():
    cache = memo_lib.MemoCache(1 << 20, semantic_epsilon=0.05,
                               semantic_shadow_every=100)
    try:
        vec = np.array([1.0, 0.0, 0.0], np.float32)
        rows = neighbors_from_search(np.array([[0.9, 0.5]]),
                                     np.array([[2, 0]]), ['a', 'b', 'c'])
        cache.semantic_insert(vec[None, :], rows, 4, cache.generation)
        rows[0].scores[:] = -1.0
        served, shadow = cache.semantic_lookup(vec, 4)
        assert not shadow
        np.testing.assert_array_almost_equal(served.scores, [0.9, 0.5])
        served.scores[:] = 5.0
        served2, _ = cache.semantic_lookup(vec, 4)
        assert served2 is not served
        np.testing.assert_array_almost_equal(served2.scores, [0.9, 0.5])
    finally:
        cache.close()


def test_semantic_off_by_default_stores_nothing():
    cache = memo_lib.MemoCache(1 << 20)
    try:
        vec = np.ones((1, 4), np.float32)
        assert cache.semantic_insert(vec, [object()], 10,
                                     cache.generation) == 0
        assert cache.semantic_lookup(vec[0], 10) is None
        assert cache.stats()['semantic']['rows'] == 0
    finally:
        cache.close()


def test_index_generation_two_axes():
    cache = memo_lib.MemoCache(1 << 20)
    try:
        pkey = memo_lib.request_key(['l a,b,c'], 'topk')
        nkey = memo_lib.request_key(['l a,b,c'], 'neighbors', k=4)
        row = [{'s': np.zeros(8)}]
        assert cache.insert(pkey, row, cache.generation)
        assert cache.insert(nkey, row, cache.generation,
                            index_generation=cache.index_generation)
        before = cache.stats()
        cache.bump_index_generation()
        after = cache.stats()
        assert after['index_generation'] == before['index_generation'] + 1
        assert after['generation'] == before['generation']
        assert cache.lookup(nkey) is None
        assert cache.lookup(pkey) is not None
        assert after['entries'] == 1 and after['evictions'] == 0
        assert memory_lib.ledger().bucket_bytes('memo') == \
            cache.stats()['bytes'] > 0
        assert not cache.insert(
            nkey, row, cache.generation,
            index_generation=after['index_generation'] - 1)
        assert cache.insert(nkey, row, cache.generation,
                            index_generation=cache.index_generation)
        cache.bump_generation()
        assert cache.lookup(pkey) is None and cache.lookup(nkey) is None
    finally:
        cache.close()


def test_cache_refuses_a_zero_budget():
    with pytest.raises(ValueError, match='capacity_bytes'):
        memo_lib.MemoCache(0)


# ------------------------------------------------- through the mesh
def test_mesh_exact_hit_at_submit_bit_identical_to_live(model):
    with model.serving_mesh(replicas=1, tiers=('topk', 'attention'),
                            max_delay_ms=0.0,
                            memo_cache_bytes=32 << 20) as mesh:
        live = mesh.predict(PREDICT_LINES, tier='attention', timeout=60)
        handle = mesh.submit(PERMUTED_LINES, tier='attention')
        assert handle.done()   # served at submit: no tokenize, no queue
        cached = handle.result()
        assert_rows_identical(cached, live)
        assert_rows_close(cached, model.predict(PREDICT_LINES))
        stats = mesh.stats()['memo']
        assert stats['hits'] == 1 and stats['entries'] >= 1
        assert stats['bytes'] > 0
        assert memory_lib.ledger().bucket_bytes('memo') == stats['bytes']
    assert memory_lib.ledger().bucket_bytes('memo') == 0


def test_mesh_memo_off_by_default(model):
    with model.serving_mesh(replicas=1, tiers=('topk',),
                            max_delay_ms=0.0) as mesh:
        assert mesh.stats()['memo'] is None
        first = mesh.predict(PREDICT_LINES, tier='topk', timeout=60)
        again = mesh.submit(PREDICT_LINES, tier='topk').result(timeout=60)
        assert_rows_identical(again, first)
        assert sum(r['batches'] for r in mesh.stats()['replicas']) == 2


def test_mesh_oversize_split_rejoin_memo_bit_identity(model):
    """A request wider than the top bucket (16) splits and joins; the
    insert fires on the caller's future after the join. The cached answer
    is bit for bit the live answer through the same mesh, and within
    tolerance of ``predict``, which runs another batch shape."""
    lines = [PREDICT_LINES[i % 3] for i in range(20)]
    permuted = [PERMUTED_LINES[i % 3] for i in range(20)]
    with model.serving_mesh(replicas=2, tiers=('topk',), max_delay_ms=0.0,
                            memo_cache_bytes=32 << 20) as mesh:
        live = mesh.predict(lines, tier='topk', timeout=120)
        assert len(live) == 20
        handle = mesh.submit(permuted, tier='topk')
        assert handle.done()
        assert_rows_identical(handle.result(), live)
        assert_rows_close(handle.result(), model.predict(lines))


def test_mesh_degraded_tier_cannot_poison_full_key(model, monkeypatch):
    with model.serving_mesh(replicas=1, tiers=('topk', 'full'),
                            max_delay_ms=0.0,
                            memo_cache_bytes=32 << 20) as mesh:
        orig_admit = mesh._queue.admit

        def degrading_admit(n, tier, deadline_s):
            return orig_admit(n, 'topk' if tier == 'full' else tier,
                              deadline_s)

        monkeypatch.setattr(mesh._queue, 'admit', degrading_admit)
        degraded = mesh.predict(PREDICT_LINES, tier='full', timeout=60)
        assert all(not r.attention_per_context for r in degraded)
        monkeypatch.undo()
        handle = mesh.submit(PREDICT_LINES, tier='full')
        assert not handle.done()
        full = handle.result(timeout=60)
        assert all(r.attention_per_context for r in full)
        topk_handle = mesh.submit(PREDICT_LINES, tier='topk')
        assert topk_handle.done()
        assert_rows_identical(topk_handle.result(), degraded)


def _feed_until(mesh, handle, lines):
    """Traffic until the canary concludes (nothing sends a given request
    to the canary replica, so a fixed number could all land on its
    sibling)."""
    deadline = time.perf_counter() + 60.0
    while not handle.done() and time.perf_counter() < deadline:
        mesh.predict(lines, tier='topk', timeout=60)
    return handle.result(timeout=60)


def test_rollover_invalidation_drill(model):
    """A fleet swap turns every cached entry into a miss by one
    generation bump (no eviction counted); a rolled-back canary leaves
    the cache warm."""
    params = model.backend.params
    broken = params._replace(target_embedding=-params.target_embedding)
    with model.serving_mesh(replicas=2, tiers=('topk',), max_delay_ms=0.0,
                            memo_cache_bytes=32 << 20) as mesh:
        mesh.predict(PREDICT_LINES, tier='topk', timeout=60)
        assert mesh.submit(PREDICT_LINES, tier='topk').done()
        gen_before = mesh.stats()['memo']['generation']
        report = _feed_until(mesh, mesh.load_params(
            params, canary_batches=2, min_agreement=0.9), PREDICT_LINES)
        assert report['swapped'] is True
        stats = mesh.stats()['memo']
        assert stats['generation'] == gen_before + 1
        assert stats['entries'] == 0 and stats['bytes'] == 0
        assert stats['evictions'] == 0
        stale = mesh.submit(PREDICT_LINES, tier='topk')
        assert not stale.done()
        stale.result(timeout=60)
        assert mesh.submit(PREDICT_LINES, tier='topk').done()
        report = _feed_until(mesh, mesh.load_params(
            broken, canary_batches=2, min_agreement=0.9),
            [PREDICT_LINES[0]])
        assert report['swapped'] is False
        assert mesh.stats()['memo']['generation'] == gen_before + 1
        assert mesh.submit(PREDICT_LINES, tier='topk').done()


class FakeIndex:
    """A deterministic stand-in for a loaded index (``index/``)."""

    def __init__(self, dim, n=8, seed=0):
        rng = np.random.default_rng(seed)
        store = rng.normal(size=(n, dim)).astype(np.float32)
        self._store = store / np.linalg.norm(store, axis=1, keepdims=True)
        self.labels = ['lab%d' % i for i in range(n)]
        self.searches = 0

    def search(self, vectors, k):
        self.searches += 1
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        sims = vectors @ self._store.T
        idx = np.argsort(-sims, axis=1)[:, :k]
        return np.take_along_axis(sims, idx, axis=1), idx


def test_mesh_neighbors_exact_and_semantic_tiers(model):
    with model.serving_mesh(replicas=1, tiers=('topk', 'vectors'),
                            max_delay_ms=0.0, memo_cache_bytes=32 << 20,
                            memo_semantic_epsilon=0.05) as mesh:
        vec = mesh.predict([PREDICT_LINES[0]], tier='vectors',
                           timeout=60)[0].code_vector
        index = FakeIndex(dim=vec.shape[0])
        mesh.attach_index(index)
        first = mesh.submit_neighbors(PREDICT_LINES, k=4).result(60)
        searches = index.searches
        again = mesh.submit_neighbors(list(PERMUTED_LINES), k=4)
        assert again.done() and index.searches == searches
        assert [r.labels for r in again.result()] == \
            [r.labels for r in first]
        # keyed per k: the k=6 ask searches (its vectors leg is a hit)
        hits_before = mesh.stats()['memo']['hits']
        other_k = mesh.submit_neighbors(PREDICT_LINES, k=6).result(60)
        assert len(other_k[0].labels) == 6
        assert mesh.stats()['memo']['hits'] == hits_before + 1
        live = mesh.submit_neighbors(vec, k=4).result(60)
        for i in range(10):
            near = vec * np.float32(1.0 + 1e-5 * (i + 1))
            out = mesh.submit_neighbors(near, k=4).result(60)
            assert out[0].labels == live[0].labels
        stats = mesh.stats()['memo']
        assert stats['semantic']['serves'] >= 8
        assert stats['semantic']['samples'] >= 1
        assert stats['semantic']['agreement'] == pytest.approx(1.0)
        assert stats['semantic_hits'] >= 1


class SloStub:
    def __init__(self):
        self.good = self.bad = 0

    def observe_good(self, latency_s=None, scenario=None):
        self.good += 1

    def observe_bad(self, reason='failed', scenario=None):
        self.bad += 1

    def stats(self):
        return {'good': self.good, 'bad': self.bad}


def test_mesh_memo_stands_down_during_a_canary(model):
    """While a rollover is in flight both neighbor memo tiers and the
    predict memo run live, so the canary gets its batches; answers from
    the cache count as good in the SLO."""
    with model.serving_mesh(replicas=1, tiers=('topk', 'vectors'),
                            max_delay_ms=0.0, memo_cache_bytes=32 << 20,
                            memo_semantic_epsilon=0.05) as mesh:
        slo = SloStub()
        mesh._slo = slo
        vec = mesh.predict([PREDICT_LINES[0]], tier='vectors',
                           timeout=60)[0].code_vector
        index = FakeIndex(dim=vec.shape[0])
        mesh.attach_index(index)
        mesh.submit_neighbors(PREDICT_LINES, k=4).result(60)
        mesh.submit_neighbors(vec, k=4).result(60)
        mesh.predict(PREDICT_LINES, tier='topk', timeout=60)
        good_before = slo.good
        assert mesh.submit_neighbors(PREDICT_LINES, k=4).done()
        assert slo.good == good_before + 1
        near = vec * np.float32(1.00001)
        assert mesh.submit_neighbors(near, k=4).done()
        assert slo.good == good_before + 2
        serves_before = mesh.stats()['memo']['semantic']['serves']
        hits_before = mesh.stats()['memo']['hits']
        mesh._rollover = {'replica': None, 'handle': None}
        try:
            searches = index.searches
            mesh.submit_neighbors(PREDICT_LINES, k=4).result(60)
            mesh.submit_neighbors(near, k=4).result(60)
            assert index.searches == searches + 2
            mesh.submit(PREDICT_LINES, tier='topk').result(60)
            stats = mesh.stats()['memo']
            assert stats['hits'] == hits_before
            assert stats['semantic']['serves'] == serves_before
        finally:
            mesh._rollover = None
        assert mesh.submit_neighbors(PREDICT_LINES, k=4).done()
        assert mesh.submit(PREDICT_LINES, tier='topk').done()


def test_mesh_canary_replica_pulls_with_half_its_window(model):
    with model.serving_mesh(replicas=2, tiers=('topk',), max_delay_ms=0.0,
                            max_inflight=4) as mesh:
        slot = mesh._replicas[0]
        with mesh._lock:
            assert mesh._slot_cap_locked(slot) == 4
            slot.canarying = True
            assert mesh._slot_cap_locked(slot) == 2
            slot.canarying = False
        handle = mesh.load_params(model.backend.params, canary_batches=50)
        with mesh._lock:
            canary = mesh._rollover['replica']
            assert canary.canarying and mesh._slot_cap_locked(canary) == 2
    assert handle.exception(timeout=10) is not None
