"""The port's device-memory ledger (code2vec_tpu_torch/telemetry/
memory.py) against the JAX package's (code2vec_tpu/telemetry/memory.py)
on the CPU, and its owners in the port:

- bookkeeping: one sequence of registrations, replacements and releases
  (byte counts) into both ledgers gives equal bucket totals, attributed
  bytes, watermarks, events and ``diff``s; ``check_budget`` refuses and
  admits the same requests and dumps; the dump's fields are the
  reference's, and so are the buckets, ``memo`` (the mesh's memoization
  tier, kind='host') included;
- on the CPU the port reports no backend bytes, so a reconciled snapshot
  has no ``backend`` and no ``unattributed_bytes`` (skipped, not faked);
- ``is_oom_error`` accepts a constructed ``torch.cuda.OutOfMemoryError``
  and ``note_oom`` writes ``oom_ledger.json`` for it only;
- the owners: the trainer's state (fp32 masters, moments in their
  storage dtypes) under one key, the staging ring's batches released by
  the end of a fit, a model whose state would cross HBM_BUDGET_BYTES
  refused before it allocates, the engine's parameter slots registered
  and released at close, MEM_NOW and ``write_report``.

All comparisons are exact: the ledgers count integer bytes.
"""
import json
import types

import numpy as np
import pytest
import torch

from code2vec_tpu.telemetry import memory as jax_memory
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.telemetry import core
from code2vec_tpu_torch.telemetry import memory as memory_lib
from tests.test_train_overfit import make_dataset


@pytest.fixture(autouse=True)
def fresh_ledgers(monkeypatch):
    monkeypatch.delenv('HBM_BUDGET_BYTES', raising=False)
    memory_lib.reset()
    jax_memory.reset()
    core.reset()
    core.disable()
    yield
    memory_lib.reset()
    jax_memory.reset()
    core.reset()
    core.disable()


class Owner:
    """Something a weakref can point at."""


def _drive(ledger, budget=None):
    """One sequence of ledger operations; returns the snapshots taken
    along the way (unreconciled: bookkeeping only)."""
    ledger.configure(budget_bytes=budget)
    snaps = []
    ledger.register('params', 'trainer:a', 1000)
    ledger.register('opt_state', 'trainer:a', 2000)
    ledger.register('staging', 'trainer:a/0', 64)
    ledger.register('staging', 'trainer:a/1', 64)
    snaps.append(ledger.snapshot(reconcile=False, reason='one'))
    ledger.release('staging', 'trainer:a/0')
    ledger.register('params', 'trainer:a', 1500)        # a restore
    ledger.register('executables', 'engine:x/pool', 4096,
                    kind='executable', attrs={'graphs': 3})
    ledger.release('staging', 'missing')                 # no-op
    snaps.append(ledger.snapshot(reconcile=False, reason='two'))
    owner = Owner()
    ledger.register('params', 'engine:x/slot0', 500, owner=owner)
    snaps.append(ledger.snapshot(reconcile=False, reason='three'))
    del owner                                            # collected
    snaps.append(ledger.snapshot(reconcile=False, reason='four'))
    return snaps


def _comparable(snap):
    snap = dict(snap)
    snap.pop('time')
    snap['events'] = [{k: v for k, v in e.items() if k != 't'}
                      for e in snap['events']]
    return snap


def test_bookkeeping_equals_reference():
    port = _drive(memory_lib.ledger())
    ref = _drive(jax_memory.ledger())
    assert len(port) == len(ref)
    for got, want in zip(port, ref):
        got, want = _comparable(got), _comparable(want)
        # every bucket of the reference, the memo tier's too (empty here)
        assert set(got['buckets']) == set(want['buckets'])
        assert got['buckets']['memo'] == {'bytes': 0, 'entries': []}
        assert set(got) == set(want)
        assert got == want
    assert port[-1]['attributed_bytes'] == 1500 + 2000 + 64
    assert port[-1]['executables_bytes'] == 4096
    assert memory_lib.ledger().bucket_bytes('params') == 1500
    assert port[2]['watermarks']['total'] == 1500 + 2000 + 64 + 500


def test_diff_equals_reference():
    port = _drive(memory_lib.ledger())
    ref = _drive(jax_memory.ledger())
    got = memory_lib.MemoryLedger.diff(port[0], port[1])
    want = jax_memory.MemoryLedger.diff(ref[0], ref[1])
    assert got['buckets']['memo']['bytes_delta'] == 0
    assert got == want
    assert got['buckets']['params'] == {'bytes_delta': 500,
                                        'entries': {'trainer:a': 500}}


@pytest.mark.parametrize('budget, incoming, refused', [
    (0, 10 ** 12, False), (4000, 500, False), (4000, 501, True),
    (3000, 1, True)])
def test_check_budget_equals_reference(budget, incoming, refused, tmp_path):
    outcomes = []
    for module in (memory_lib, jax_memory):
        ledger = module.ledger()
        ledger.configure(budget_bytes=budget,
                         dump_dir=str(tmp_path / module.__name__))
        ledger.register('params', 'trainer:a', 1500)
        ledger.register('opt_state', 'trainer:a', 2000)
        try:
            ledger.check_budget(incoming, 'a test allocation')
            outcomes.append(None)
        except module.MemoryBudgetExceeded as exc:
            outcomes.append(str(exc).split(' Ledger dumped')[0])
            dumped = json.load(open(tmp_path / module.__name__
                                    / 'oom_ledger.json'))
            assert dumped['reason'] == 'budget: a test allocation'
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is not None) == refused


def test_budget_from_environment(monkeypatch):
    monkeypatch.setenv('HBM_BUDGET_BYTES', '1234')
    assert memory_lib.ledger().budget_bytes() == \
        jax_memory.ledger().budget_bytes() == 1234
    memory_lib.configure(budget_bytes=0)
    assert memory_lib.ledger().budget_bytes() == 0
    monkeypatch.setenv('HBM_BUDGET_BYTES', 'lots')
    memory_lib.reset()
    with pytest.raises(ValueError, match='HBM_BUDGET_BYTES'):
        memory_lib.ledger().budget_bytes()


def test_dump_fields_equal_reference(tmp_path):
    _drive(memory_lib.ledger())
    _drive(jax_memory.ledger())
    port = json.load(open(memory_lib.ledger().dump(
        str(tmp_path / 'port.json'), reason='test')))
    ref = json.load(open(jax_memory.ledger().dump(
        str(tmp_path / 'ref.json'), reason='test')))
    # the CPU: the port reconciles nothing; the reference counts its
    # live jax arrays
    assert 'backend' not in port and 'unattributed_bytes' not in port
    assert set(ref) - set(port) == {'backend', 'unattributed_bytes'}
    assert set(port) == set(ref) - {'backend', 'unattributed_bytes'}
    assert port['reason'] == ref['reason'] == 'test'


def test_backend_memory_is_none_without_a_card():
    assert memory_lib.backend_memory() is None
    snap = memory_lib.ledger().snapshot()
    assert 'backend' not in snap


def test_is_oom_error_and_note_oom(tmp_path):
    oom = torch.cuda.OutOfMemoryError('CUDA out of memory. Tried to '
                                      'allocate 2.00 GiB')
    assert memory_lib.is_oom_error(oom)
    assert memory_lib.is_oom_error(torch.cuda.OutOfMemoryError('x'))
    assert memory_lib.is_oom_error(RuntimeError('RESOURCE_EXHAUSTED: hbm'))
    assert not memory_lib.is_oom_error(ValueError('shape mismatch'))
    for text in ('CUDA out of memory', 'RESOURCE_EXHAUSTED: x', 'boom'):
        assert memory_lib.is_oom_error(RuntimeError(text)) == \
            jax_memory.is_oom_error(RuntimeError(text))
    core.enable()
    memory_lib.configure(dump_dir=str(tmp_path))
    memory_lib.ledger().register('params', 'trainer:a', 10)
    assert memory_lib.ledger().note_oom(ValueError('no'), 'ctx') is None
    assert not (tmp_path / 'oom_ledger.json').exists()
    path = memory_lib.ledger().note_oom(oom, 'trainer.fit')
    assert path == str(tmp_path / 'oom_ledger.json')
    dumped = json.load(open(path))
    assert dumped['reason'].startswith('oom: trainer.fit: CUDA out of')
    assert dumped['buckets']['params']['bytes'] == 10
    snap = core.registry().snapshot()
    assert snap['mem/oom_dumps_total'] == 1
    assert snap['mem/snapshots_total'] == 1


def test_tree_nbytes():
    tree = {'a': torch.zeros((3, 4), dtype=torch.bfloat16),
            'b': (np.zeros((5,), np.float32), [torch.zeros(2)]),
            'step': 7, 'none': None}
    assert memory_lib.tree_nbytes(tree) == 3 * 4 * 2 + 5 * 4 + 2 * 4


def test_finalizers_inside_the_accounting_leave_it_whole():
    """The cyclic GC can run an owner's finalizer on this thread while the
    ledger sums its entries (a collection an allocation asked for runs at
    the interpreter's next check, inside a loop over the entries, and the
    lock is re-entrant): the release must not break the sum."""
    import gc

    class Owner:
        pass
    ledger = memory_lib.MemoryLedger()
    for i in range(32):
        ledger.register('params', 'live%d' % i, 8)
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        for i in range(400):
            owner = Owner()
            owner.cycle = owner          # collected by the cyclic GC only
            ledger.register('params', 'dead%d' % i, 8, owner=owner)
            del owner
            ledger.snapshot()
    finally:
        gc.set_threshold(*threshold)
    gc.collect()
    assert ledger.bucket_bytes('params') == 32 * 8


def test_gauges_mirror_the_buckets():
    core.enable()
    ledger = memory_lib.ledger()
    ledger.register('params', 'k', 100)
    ledger.register('executables', 'e', 50, kind='executable')
    ledger.export_gauges()
    snap = core.registry().snapshot()
    assert snap['mem/params_bytes'] == 100
    assert snap['mem/executables_bytes'] == 50
    assert snap['mem/attributed_bytes'] == 100   # executables excluded
    assert snap['mem/budget_bytes'] == 0


def test_mem_now_and_write_report(tmp_path):
    memory_lib.ledger().register('params', 'k', 100)
    controller = memory_lib.MemoryReportController(str(tmp_path))
    assert controller.poll(3) is None
    (tmp_path / 'MEM_NOW').write_text('')
    path = controller.poll(3)
    assert path.endswith('memory_step3.json')
    assert not (tmp_path / 'MEM_NOW').exists()
    assert json.load(open(path))['reason'] == 'MEM_NOW at step 3'
    config = types.SimpleNamespace(telemetry_dir=str(tmp_path / 'tele'))
    report = memory_lib.write_report(config)
    assert json.load(open(report))['reason'] == '--memory-report'


# ---------------------------------------------------------------- owners
def _model(prefix, **knobs):
    from code2vec_tpu_torch.model_api import Code2VecModel
    return Code2VecModel(Config(TRAIN_DATA_PATH_PREFIX=str(prefix),
                                MAX_CONTEXTS=6, TRAIN_BATCH_SIZE=16,
                                NUM_TRAIN_EPOCHS=1, VERBOSE_MODE=0,
                                **knobs), device='cpu')


@pytest.mark.parametrize('knobs', [
    {}, dict(ADAM_MU_DTYPE='float32', ADAM_NU_DTYPE='float32'),
    dict(LAZY_EMBEDDING_ADAM=True)])
def test_trainer_state_is_attributed(knobs, tmp_path):
    from code2vec_tpu_torch.training.trainer import state_bytes
    prefix = make_dataset(tmp_path)
    model = _model(prefix, **knobs)
    ledger = memory_lib.ledger()
    param_bytes = sum(t.numel() * 4 for t in model.backend.params)
    # before train(): the weights alone
    assert ledger.bucket_bytes('params') == param_bytes
    assert ledger.bucket_bytes('opt_state') == 0
    model.train()
    assert ledger.bucket_bytes('params') == param_bytes
    moments = memory_lib.tree_nbytes(model.state.opt_state)
    assert moments > 0
    assert ledger.bucket_bytes('opt_state') == moments
    assert param_bytes + moments == state_bytes(
        model.config, model.backend.param_shapes(), with_moments=True)
    # every staged batch was released by the end of the fit
    assert ledger.bucket_bytes('staging') == 0
    # one entry per bucket for the trainer
    snap = ledger.snapshot(reconcile=False)
    assert [e['key'] for e in snap['buckets']['params']['entries']] == \
        [model.trainer._mem_key]


def test_budget_refuses_the_state_before_allocating(tmp_path):
    from code2vec_tpu_torch.training.trainer import state_bytes
    from code2vec_tpu_torch.models.backends import param_shapes, table_sizes
    from code2vec_tpu_torch.vocab import Code2VecVocabs
    prefix = make_dataset(tmp_path)
    config = Config(TRAIN_DATA_PATH_PREFIX=str(prefix), MAX_CONTEXTS=6,
                    TELEMETRY_DIR=str(tmp_path / 'tele'))
    need = state_bytes(config, param_shapes(table_sizes(
        config, Code2VecVocabs(config))), with_moments=True)
    with pytest.raises(memory_lib.MemoryBudgetExceeded,
                       match='training state'):
        _model(prefix, HBM_BUDGET_BYTES=need - 1,
               TELEMETRY_DIR=str(tmp_path / 'tele'))
    assert memory_lib.ledger().attributed_bytes() == 0
    dumped = json.load(open(tmp_path / 'tele' / 'oom_ledger.json'))
    assert dumped['reason'].startswith('budget: ')
    memory_lib.reset()
    _model(prefix, HBM_BUDGET_BYTES=need)        # exactly fits


def test_engine_slots_are_attributed_and_released(tmp_path):
    prefix = make_dataset(tmp_path)
    model = _model(prefix, COMPUTE_DTYPE='float32',
                   SERVING_BATCH_BUCKETS='8',
                   MODEL_SAVE_PATH=str(tmp_path / 'm' / 'saved_model'))
    ledger = memory_lib.ledger()
    before = ledger.bucket_bytes('params')
    slot = sum(t.numel() * 4 for t in model.backend.params)
    engine = model.serving_engine(tiers=('topk',), max_delay_ms=0.0)
    try:
        # a model with a save path: two slots captured at warm-up
        assert ledger.bucket_bytes('params') == before + 2 * slot
        keys = {e['key'] for e in ledger.snapshot(
            reconcile=False)['buckets']['params']['entries']}
        assert {'%s/slot0' % engine._mem_prefix,
                '%s/slot1' % engine._mem_prefix} <= keys
        # the CPU captures nothing: no pool
        assert ledger.bucket_bytes('executables') == 0
        engine.predict(['get|a toka0,pA,toka1'])
    finally:
        engine.close()
    assert ledger.bucket_bytes('params') == before


def test_engine_slot_budget(tmp_path):
    prefix = make_dataset(tmp_path)
    model = _model(prefix, COMPUTE_DTYPE='float32',
                   SERVING_BATCH_BUCKETS='8')
    attributed = memory_lib.ledger().attributed_bytes()
    memory_lib.configure(budget_bytes=attributed + 10,
                         dump_dir=str(tmp_path))
    with pytest.raises(memory_lib.MemoryBudgetExceeded,
                       match='parameter slot 0'):
        model.serving_engine(tiers=('topk',), max_delay_ms=0.0)
    assert memory_lib.ledger().attributed_bytes() == attributed
