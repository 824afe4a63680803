"""The port's sharded kernel routes on gloo worlds on the CPU (the kernels'
plain versions) against the reference's ``shard_map`` routes on the
conftest's virtual devices (interpreted Pallas), same numpy inputs:

- the streamed CE over a (data, model) mesh (``ops/ce.py::
  sharded_fused_weighted_ce_sums``; the reference's ``_sharded_forward``,
  ``_sharded_vjp_bwd`` and ``sharded_fused_weighted_ce_sums``) on (2, 2),
  (1, 2) and (2, 1), with num_valid cutting a shard and with a shard of
  allocation padding alone (num_valid 20 < V/M = 32), fp32, and bf16 on
  (2, 2): the CE and weight sums, the code vectors' and the table's
  gradients of the loss CE sum / weight sum;
- ``ops/topk.py::sharded_top_k`` against the reference's on logits with
  ties across the shards' edges, k inside one shard's width and past it:
  values and indices, index for index;
- the ragged encode's mesh routes (``ops/ragged.py``; the reference's
  ``_stats_kernel_path`` and ``_grads_kernel_path``, reached through its
  ``ragged_encode_code(use_kernel=True, mesh=...)``) on (2, 2), where the
  model axis shards the tables (the gather into the stream, summed over
  the data row), and (2, 1): the code vectors and the four encoder
  gradients of sum(code * G); the forward-only ``ragged_encode`` on the
  mesh equal to the training route's code vectors.

One world of four ranks runs every case (the (1, 2) and (2, 1) cases on
sub-meshes of ranks 0 and 1). Tolerances: fp32 values and gradients at
rtol 2e-5 / atol 1e-6; bf16 (tests/test_torch_ce.py) values at rtol
2e-5, gradients at rtol 1e-4 plus one bf16 rounding of the largest
(atol 2^-8 max |gradient|, each gradient on its own scale); top-k
values and indices exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from code2vec_tpu.data import packed as jax_packed
from code2vec_tpu.ops import pallas_ce, pallas_ragged
from code2vec_tpu.ops.topk import sharded_top_k as jax_sharded_top_k
from tests.test_packed import random_plane_batch
from tests.test_torch_parallel import run_world

CE_BATCH, CE_DIM, CE_VOCAB = 16, 16, 64
CE_CASES = [((2, 2), 50, 'float32'), ((2, 2), 20, 'float32'),
            ((1, 2), 50, 'float32'), ((1, 2), 20, 'float32'),
            ((2, 1), 50, 'float32'), ((2, 2), 20, 'bfloat16')]
TOPK_CASES = [((2, 2), 5), ((2, 2), 10), ((1, 2), 12), ((2, 1), 5)]
RAGGED_CASES = [(2, 2), (2, 1)]
R_BATCH, R_CONTEXTS, R_TOK, R_PATH, R_DT, R_DP, R_DC = 8, 6, 32, 16, 8, 8, 16


def ce_inputs(num_valid, seed=5):
    rng = np.random.default_rng(seed)
    code = rng.normal(size=(CE_BATCH, CE_DIM)).astype(np.float32)
    w = (0.3 * rng.normal(size=(CE_VOCAB, CE_DIM))).astype(np.float32)
    label = rng.integers(0, num_valid, CE_BATCH).astype(np.int32)
    # a label in the padding (weight 0) and one per shard edge
    label[:3] = [CE_VOCAB - 1, 31, 32]
    weight = (rng.random(CE_BATCH) > 0.2).astype(np.float32)
    weight[0] = 0.0
    return code, w, label, weight


def topk_logits(seed=9):
    rng = np.random.default_rng(seed)
    # few distinct values: ties inside and across the shards' columns
    logits = rng.integers(0, 4, (8, 16)).astype(np.float32)
    logits[:, 7:9] = 3.0           # a tie across the edge of (.., 2) shards
    logits[0, 0] = -0.0
    logits[0, 8] = 0.0
    return logits


def ragged_inputs(seed=11):
    rng = np.random.default_rng(seed)
    batch = random_plane_batch(rng, R_BATCH, R_CONTEXTS)
    params = {
        'token_embedding': rng.normal(size=(R_TOK, R_DT)),
        'path_embedding': rng.normal(size=(R_PATH, R_DP)),
        'transform': 0.3 * rng.normal(size=(2 * R_DT + R_DP, R_DC)),
        'attention': 0.3 * rng.normal(size=(R_DC, 1))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    g = rng.normal(size=(R_BATCH, R_DC)).astype(np.float32)
    return batch, params, g


# ------------------------------------------------------------- the ranks
def ops_rank(rank, ce_cases, topk_cases, ragged_cases, topk_x, ragged):
    import torch

    from code2vec_tpu_torch.ops import ce, ragged as port_ragged
    from code2vec_tpu_torch.ops.topk import sharded_top_k
    from code2vec_tpu_torch.parallel.mesh import DATA_AXIS
    from tests.test_torch_parallel import sub_mesh
    out = {'ce': [], 'topk': [], 'ragged': []}
    dtypes = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
    for shape, num_valid, dtype in ce_cases:
        mesh = sub_mesh(*shape)
        if not mesh.member:
            out['ce'].append(None)
            continue
        code, w, label, weight = ce_inputs(num_valid)
        code, label, weight = mesh.shard_batch((code, label, weight))
        w = mesh.shard_params({'target_embedding': w})['target_embedding']
        code_t = torch.from_numpy(code.copy()).requires_grad_()
        w_t = torch.from_numpy(w.copy()).requires_grad_()
        ce_sum, w_sum = ce.sharded_fused_weighted_ce_sums(
            w_t, code_t, torch.from_numpy(label), torch.from_numpy(weight),
            num_valid, mesh, dtype=dtypes[dtype])
        total = mesh.all_reduce(w_sum.detach().clone(), DATA_AXIS)
        (ce_sum / torch.clamp(total, min=1.0)).backward()
        out['ce'].append(dict(coords=(mesh.data_index, mesh.model_index),
                              ce=float(ce_sum), w=float(w_sum),
                              dcode=code_t.grad.numpy(),
                              dw=w_t.grad.numpy()))
    for shape, k in topk_cases:
        mesh = sub_mesh(*shape)
        if not mesh.member:
            out['topk'].append(None)
            continue
        rows = mesh.shard_batch((topk_x,))[0]
        width = rows.shape[1] // mesh.model
        cols = rows[:, mesh.model_index * width:(mesh.model_index + 1) * width]
        values, indices = sharded_top_k(torch.from_numpy(cols.copy()), k,
                                        mesh)
        out['topk'].append(dict(coords=(mesh.data_index, mesh.model_index),
                                values=values.numpy(),
                                indices=indices.numpy()))
    batch, params, g = ragged['batch'], ragged['params'], ragged['g']
    for shape in ragged_cases:
        mesh = sub_mesh(*shape)
        if not mesh.member:
            out['ragged'].append(None)
            continue
        packed = ragged['packed'][shape[0]]
        d = mesh.data_index
        ctx = torch.from_numpy(packed['ctx'][d:d + 1].copy())
        count = torch.from_numpy(mesh.shard_batch((packed['count'],))[0])
        local = mesh.shard_params(dict(params, target_embedding=np.zeros(
            (2, 1), np.float32)))
        tensors = {name: torch.from_numpy(local[name].copy()).requires_grad_()
                   for name in ('token_embedding', 'path_embedding',
                                'transform', 'attention')}
        code = port_ragged.ragged_encode_code(
            tensors['token_embedding'], tensors['path_embedding'],
            tensors['transform'], tensors['attention'], ctx, count,
            token_pad=0, path_pad=0, mesh=mesh)
        (code * torch.from_numpy(mesh.shard_batch((g,))[0])).sum().backward()
        with torch.no_grad():
            forward, attention = port_ragged.ragged_encode(
                tensors['token_embedding'], tensors['path_embedding'],
                tensors['transform'], tensors['attention'], ctx, count,
                max_contexts=R_CONTEXTS, token_pad=0, path_pad=0, mesh=mesh)
        out['ragged'].append(dict(
            coords=(mesh.data_index, mesh.model_index),
            code=code.detach().numpy(), forward=forward.numpy(),
            grads={name: t.grad.numpy() for name, t in tensors.items()}))
    return out


# ----------------------------------------------------- the reference side
def jax_mesh(shape):
    devices = np.asarray(jax.devices()[:shape[0] * shape[1]])
    return Mesh(devices.reshape(shape), ('data', 'model'))


def jax_ce(shape, num_valid, dtype, monkeypatch):
    monkeypatch.setattr(pallas_ce, 'VOCAB_TILE', 8)
    code, w, label, weight = [jnp.asarray(a) for a in ce_inputs(num_valid)]
    mesh = jax_mesh(shape)
    jdtype = {'float32': jnp.float32, 'bfloat16': jnp.bfloat16}[dtype]

    def loss(c, t):
        ce_sum, w_sum = pallas_ce.sharded_fused_weighted_ce_sums(
            t, c, label, weight, num_valid, mesh, dtype=jdtype,
            interpret=True)
        return ce_sum / jnp.maximum(w_sum, 1.0), (ce_sum, w_sum)

    (_loss, (ce_sum, w_sum)), (dcode, dw) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(code, w)
    return (float(ce_sum), float(w_sum), np.asarray(dcode, np.float32),
            np.asarray(dw, np.float32))


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    batch, params, g = ragged_inputs()
    packed = {}
    for data in sorted({s[0] for s in RAGGED_CASES}):
        p = jax_packed.pack_batch(batch, 0, 0, data_shards=data,
                                  capacity_minimum=4)
        packed[data] = {'ctx': np.asarray(p.ctx), 'count': np.asarray(p.count)}
    ragged = dict(batch=None, params=params, g=g, packed=packed)
    results = run_world(
        'tests.test_torch_parallel_ops:ops_rank', 4,
        tmp_path_factory.mktemp('ops-world'),
        dict(ce_cases=CE_CASES, topk_cases=TOPK_CASES,
             ragged_cases=RAGGED_CASES, topk_x=topk_logits(),
             ragged=ragged))
    return results


def _members(results, key, i):
    return [r[key][i] for r in results if r[key][i] is not None]


@pytest.mark.parametrize('case', range(len(CE_CASES)),
                         ids=['%dx%d-nv%d-%s' % (s + (n, d))
                              for s, n, d in CE_CASES])
def test_sharded_ce_matches_reference(world, case, monkeypatch):
    shape, num_valid, dtype = CE_CASES[case]
    want_ce, want_w, want_dcode, want_dw = jax_ce(shape, num_valid, dtype,
                                                  monkeypatch)
    parts = _members(world, 'ce', case)
    assert len(parts) == shape[0] * shape[1]
    data, model = shape
    # each data row's ranks agree on its sums and code gradient
    rows = {}
    for part in parts:
        d, m = part['coords']
        if d in rows:
            assert part['ce'] == rows[d]['ce']
            np.testing.assert_array_equal(part['dcode'], rows[d]['dcode'])
        else:
            rows[d] = part
    got_ce = sum(rows[d]['ce'] for d in range(data))
    got_w = sum(rows[d]['w'] for d in range(data))
    got_dcode = np.concatenate([rows[d]['dcode'] for d in range(data)])
    by_model = {p['coords'][1]: p['dw'] for p in parts if p['coords'][0] == 0}
    got_dw = np.concatenate([by_model[m] for m in range(model)])
    # the model column's ranks hold the same (data-summed) table rows
    for part in parts:
        np.testing.assert_array_equal(part['dw'], by_model[part['coords'][1]])
    np.testing.assert_allclose(got_ce, want_ce, rtol=2e-5, atol=1e-6)
    assert got_w == want_w
    for got, want, name in ((got_dcode, want_dcode, 'dcode'),
                            (got_dw, want_dw, 'dw')):
        if dtype == 'float32':
            tol = dict(rtol=2e-5, atol=1e-6)
        else:
            tol = dict(rtol=1e-4, atol=2.0 ** -8 * float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, err_msg=name, **tol)
    if num_valid == 20 and model == 2:
        # shard 1 is padding alone: every row of its table gradient is 0
        np.testing.assert_array_equal(by_model[1], 0.0)


@pytest.mark.parametrize('case', range(len(TOPK_CASES)),
                         ids=['%dx%d-k%d' % (s + (k,)) for s, k in TOPK_CASES])
def test_sharded_top_k_matches_reference_index_for_index(world, case):
    shape, k = TOPK_CASES[case]
    x = topk_logits()
    want_v, want_i = jax_sharded_top_k(jnp.asarray(x), k, jax_mesh(shape))
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    parts = _members(world, 'topk', case)
    rows = {}
    for part in parts:
        d = part['coords'][0]
        if d in rows:
            np.testing.assert_array_equal(part['indices'], rows[d]['indices'])
        rows[d] = part
    got_i = np.concatenate([rows[d]['indices'] for d in sorted(rows)])
    got_v = np.concatenate([rows[d]['values'] for d in sorted(rows)])
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_v.view(np.int32),
                                  want_v.astype(np.float32).view(np.int32))


@pytest.mark.parametrize('case', range(len(RAGGED_CASES)),
                         ids=['%dx%d' % s for s in RAGGED_CASES])
def test_ragged_mesh_routes_match_reference(world, case):
    shape = RAGGED_CASES[case]
    data, model = shape
    batch, params, g = ragged_inputs()
    packed = jax_packed.pack_batch(batch, 0, 0, data_shards=data,
                                   capacity_minimum=4)
    names = ('token_embedding', 'path_embedding', 'transform', 'attention')

    def code_of(tok, path, trans, attn):
        return pallas_ragged.ragged_encode_code(
            tok, path, trans, attn, jnp.asarray(packed.ctx),
            jnp.asarray(packed.count), token_pad=0, path_pad=0,
            use_kernel=True, interpret=True, mesh=jax_mesh(shape))

    args = [jnp.asarray(params[n]) for n in names]
    want_code, vjp = jax.vjp(code_of, *args)
    want_code = np.asarray(want_code)
    want_grads = vjp(jnp.asarray(g))
    parts = _members(world, 'ragged', case)
    assert len(parts) == data * model
    rows = {}
    for part in parts:
        rows.setdefault(part['coords'][0], part)
        np.testing.assert_array_equal(part['forward'], part['code'])
    got_code = np.concatenate([rows[d]['code'] for d in range(data)])
    np.testing.assert_allclose(got_code, want_code, rtol=2e-5, atol=1e-6)
    for name, want in zip(names, want_grads):
        want = np.asarray(want)
        if name in ('token_embedding', 'path_embedding'):
            by_model = {p['coords'][1]: p['grads'][name] for p in parts
                        if p['coords'][0] == 0}
            got = np.concatenate([by_model[m] for m in range(model)])
        else:
            got = parts[0]['grads'][name]
            for part in parts[1:]:
                np.testing.assert_array_equal(part['grads'][name], got)
        np.testing.assert_allclose(got, want.reshape(got.shape), rtol=2e-5,
                                   atol=1e-6, err_msg=name)
