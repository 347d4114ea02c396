"""The port's ALS recommender (capital_tpu_torch.apps.als), dense and
sparse, against the JAX package's, on a one-device grid, and against the
bounds of the JAX package's own tests (tests/test_als.py,
tests/test_als_sparse.py).

Parity: the JAX package's random draws (jax.random, split as its
generators split them) are patched into the port's draw helpers, so both
build the same data and start from the same V0. The data agree to 1e-6
(the planted products' rounding), the index buckets exactly; after 8
iterations U and V agree to 1e-4 relative Frobenius and the RMSE to 1e-5.
The sparse data's noise is an integer hash of (user, item): the port's
equals val - <ut_u, vt_i> of the JAX package's data within 1e-6 on every
edge of both views.

Own draws (torch.Generator): the index structures describe one edge set
with exact degrees and one value per edge (tests/test_als_sparse.py:10-36),
five iterations fit no worse than one (tests/test_als.py), and the bench
benches' fits reach RMSE < 0.08 (the planted noise floor is 0.05).
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.apps import als as jals
from capital_tpu.grid import Grid as JGrid
from capital_tpu_torch import Grid, interop
from capital_tpu_torch.apps import als
from capital_tpu_torch.bench import als as bench_als
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(60, setup=120)

torch.set_num_threads(1)

DENSE = dict(users=512, items=256, true_rank=8, density=0.3, seed=0,
             cfg=(16, 0.05, 8))
SPARSE = dict(users=512, items=128, s=24, true_rank=6, seed=2,
              cfg=(12, 0.05, 8))


def _grid():
    return Grid.square(device="cpu")


def _jgrid():
    return JGrid.square(c=1, d=1, devices=jax.devices("cpu")[:1])


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _jax_ratings_draws(grid, users, items, rank, key, dtype):
    """synthetic_ratings' draws as the JAX package makes them from
    jax.random.key(key)."""
    ku, kv, km, kn = jax.random.split(jax.random.key(key), 4)
    return (_t(jax.random.normal(ku, (users, rank))),
            _t(jax.random.normal(kv, (items, rank))),
            _t(jax.random.normal(kn, (users, items))),
            _t(jax.random.uniform(km, (users, items))))


def _jax_regular_draws(grid, users, items, s, rank, key, dtype):
    """synthetic_regular's draws as the JAX package makes them from
    jax.random.key(key)."""
    kperm, kshift, ku, kv, _ = jax.random.split(jax.random.key(key), 5)
    perms = jnp.stack([jax.random.permutation(k, items)
                       for k in jax.random.split(kperm, s)])
    return (_t(perms).long(),
            _t(jax.random.randint(kshift, (s,), 0, items)).long(),
            _t(jax.random.normal(ku, (users, rank))),
            _t(jax.random.normal(kv, (items, rank))))


def _jax_initial_v(items, rank, dtype, device, key=0):
    return _t(jax.random.normal(jax.random.key(key), (items, rank)))


def _cfgs(rank, lam, iters):
    cfg = jals.Config(rank=rank, lam=lam, num_iters=iters)
    return cfg, interop.als_config_from_dict(dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def _jax_dense():
    d = DENSE
    grid = _jgrid()
    r, m = jax.jit(lambda key: jals.synthetic_ratings(
        grid, d["users"], d["items"], key, rank=d["true_rank"],
        density=d["density"]))(jax.random.key(d["seed"]))
    cfg, _ = _cfgs(*d["cfg"])
    u, v, err = jax.jit(lambda rr, mm: jals.fit(grid, rr, mm, cfg))(r, m)
    return tuple(np.asarray(x) for x in (r, m, u, v, err))


@functools.lru_cache(maxsize=None)
def _jax_sparse():
    d = SPARSE
    grid = _jgrid()
    data = jax.jit(lambda key: jals.synthetic_regular(
        grid, d["users"], d["items"], d["s"], key, rank=d["true_rank"]))(
            jax.random.key(d["seed"]))
    cfg, _ = _cfgs(*d["cfg"])
    u, v, err = jax.jit(lambda x: jals.fit_sparse(
        grid, x, cfg, items=d["items"]))(data)
    return (tuple(np.asarray(x) for x in data),
            tuple(np.asarray(x) for x in (u, v, err)))


def test_dense_matches_jax():
    d = DENSE
    r_j, m_j, u_j, v_j, err_j = _jax_dense()
    with mock.patch.object(als, "_ratings_draws", _jax_ratings_draws):
        r, m = als.synthetic_ratings(_grid(), d["users"], d["items"],
                                     d["seed"], rank=d["true_rank"],
                                     density=d["density"])
    np.testing.assert_array_equal(m.numpy(), m_j)
    assert np.max(np.abs(r.numpy() - r_j)) < 1e-6
    _, cfg = _cfgs(*d["cfg"])
    with mock.patch.object(als, "_initial_v", _jax_initial_v):
        u, v, err = als.fit(_grid(), _t(r_j), _t(m_j), cfg)
    assert err.shape == ()
    assert _rel(u, u_j) < 1e-4, _rel(u, u_j)
    assert _rel(v, v_j) < 1e-4, _rel(v, v_j)
    assert abs(float(err) - float(err_j)) < 1e-5 * float(err_j)
    assert float(err) < 0.08


def test_sparse_matches_jax():
    d = SPARSE
    (idx_j, val_j, idxt_j, valt_j), (u_j, v_j, err_j) = _jax_sparse()
    with mock.patch.object(als, "_regular_draws", _jax_regular_draws):
        data = als.synthetic_regular(_grid(), d["users"], d["items"], d["s"],
                                     d["seed"], rank=d["true_rank"])
    np.testing.assert_array_equal(data.idx.numpy(), idx_j)
    np.testing.assert_array_equal(data.idx_t.numpy(), idxt_j)
    assert np.max(np.abs(data.val.numpy() - val_j)) < 1e-6
    assert np.max(np.abs(data.val_t.numpy() - valt_j)) < 1e-6
    jdata = interop.sparse_ratings_from_numpy(idx_j, val_j, idxt_j, valt_j,
                                              device="cpu")
    _, cfg = _cfgs(*d["cfg"])
    with mock.patch.object(als, "_initial_v", _jax_initial_v):
        u, v, err = als.fit_sparse(_grid(), jdata, cfg, items=d["items"])
    assert err.shape == ()
    assert _rel(u, u_j) < 1e-4, _rel(u, u_j)
    assert _rel(v, v_j) < 1e-4, _rel(v, v_j)
    assert abs(float(err) - float(err_j)) < 1e-5 * float(err_j)
    assert float(err) < 0.08


def test_edge_hash_matches_jax():
    """val - <ut_u, vt_i> of the JAX package's data, from its own draws of
    ut and vt, is the port's hash of (u, i), in both views."""
    users, items, s, rank = 64, 16, 4, 16
    key = jax.random.key(0)
    data = jax.jit(lambda k: jals.synthetic_regular(
        _jgrid(), users, items, s, k, rank=rank))(key)
    _, _, ku, kv, _ = jax.random.split(key, 5)
    ut = np.asarray(jax.random.normal(ku, (users, rank))) / np.sqrt(rank)
    vt = np.asarray(jax.random.normal(kv, (items, rank))) / np.sqrt(rank)
    idx, idx_t = np.array(data.idx), np.array(data.idx_t)
    u_ids = np.arange(users)[:, None]
    i_ids = np.arange(items)[:, None]
    noise_u = np.asarray(data.val) - np.einsum("uk,usk->us", ut, vt[idx])
    noise_i = np.asarray(data.val_t) - np.einsum("ik,isk->is", vt, ut[idx_t])
    got_u = als._noise(torch.from_numpy(u_ids), torch.from_numpy(idx),
                       torch.float32)
    got_i = als._noise(torch.from_numpy(idx_t), torch.from_numpy(i_ids),
                       torch.float32)
    assert np.max(np.abs(got_u.numpy() - noise_u)) < 1e-6
    assert np.max(np.abs(got_i.numpy() - noise_i)) < 1e-6
    assert float(got_u.abs().max()) <= 0.05


def test_synthetic_regular_structure():
    """tests/test_als_sparse.py's checks on the port's own draws: both views
    describe one edge set with exact degrees, and agree on its values."""
    users, items, s = 64, 16, 4
    data = als.synthetic_regular(_grid(), users, items, s, 0)
    idx, idx_t = data.idx.numpy(), data.idx_t.numpy()
    edges_u = {(u, int(i)) for u in range(users) for i in idx[u]}
    edges_i = {(int(u), i) for i in range(items) for u in idx_t[i]}
    assert edges_u == edges_i
    assert idx.shape == (users, s)
    assert idx_t.shape == (items, s * users // items)
    vals_u = {(u, int(idx[u, j])): float(data.val[u, j])
              for u in range(users) for j in range(s)}
    for i in range(items):
        for t in range(idx_t.shape[1]):
            key = (int(idx_t[i, t]), i)
            np.testing.assert_allclose(float(data.val_t[i, t]), vals_u[key],
                                       rtol=1e-5)
    with pytest.raises(ValueError, match="items | users"):
        als.synthetic_regular(_grid(), 10, 4, 2, 0)


def test_dense_progress():
    """tests/test_als.py::test_als_progress on the port's own draws; an
    operand off the grid's device is refused."""
    grid = _grid()
    r, m = als.synthetic_ratings(grid, 256, 128, 1, rank=4, density=0.5)
    _, _, e1 = als.fit(grid, r, m, als.Config(rank=8, lam=0.05, num_iters=1))
    _, _, e5 = als.fit(grid, r, m, als.Config(rank=8, lam=0.05, num_iters=5))
    assert float(e5) <= float(e1) + 1e-6
    with pytest.raises(ValueError, match="grid on cuda:0"):
        als.fit(Grid(device=torch.device("cuda", 0)), r, m)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_bench_als(sparse):
    """bench.als on the CPU at the JAX tests' sizes: its fit reaches the
    noise floor, and it counts the JAX bench's flops."""
    users, items, k, iters = (512, 128, 16, 8) if sparse else (512, 256, 16,
                                                               8)
    argv = ["--device", "cpu", "--users", str(users), "--items", str(items),
            "--rank", str(k), "--iters", str(iters), "--num-iter", "1",
            "--json"]
    argv += ["--sparse", "--obs-per-user", "24"] if sparse else [
        "--density", "0.3"]
    rec = bench_als.main(argv)
    assert rec["rmse"] < 0.08, rec["rmse"]
    work = 4.0 * (users * 24 if sparse else users * items) * k**2
    flops = iters * (work + (users + items) * k**3 / 3)
    want = flops / (min(rec["ms"]) / 1e3) / 1e9
    assert abs(rec["gflops"] - want) <= 0.01 + 1e-6 * want
