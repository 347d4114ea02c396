"""The port's apps across ranks against the JAX package's on its 8
virtual CPU devices: one 8-rank gloo world (tests/torch_mesh_ranks.py)
runs rsvd of a planted 2048 x 256 operand (k = 24, oversample 8, one
power iteration) with A's rows over every rank of the 1D grid of 8 and of
the rect grid, pca of 2048 x 128 data (k = 8) on the 1D grid, and ALS on
the 1D grid: synthetic_ratings with 509 users (padded to 512, the padding
rows unobserved), fit and rmse on them, and synthetic_regular with
fit_sparse (grid-agnostic in both packages).

Both packages run on the same numbers: the JAX package's draws (Omega,
the generators' normals, uniforms, permutations and shifts, ALS's initial
V) are made here and patched into the port's draw helpers in every rank.
Tolerances are tests/test_torch_rsvd.py's and tests/test_torch_als.py's:
s within 1e-5 relative, U diag(s) V^T within 1e-5 relative Frobenius,
the singular vectors up to sign within 1e-4; PCA's variances and mean
within 1e-5, its components within 1e-4; the ratings' mask exact and
values within 1e-6; after 8 iterations U and V within 1e-4 relative
Frobenius and the RMSE within 1e-5 relative; the sparse structure exact,
its values within 1e-6. The per-rank cost records of rsvd and pca equal
the JAX package's per-device ones; U comes back as rows over every rank,
and every rank holds the same V and RMSE."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as R
from capital_tpu import tracing as jtracing
from capital_tpu.apps import als as jals
from capital_tpu.apps import rsvd as jrsvd
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(60, setup=180)

TOL = 1e-5
ROWS = jax.sharding.PartitionSpec(("z", "y", "x"), None)
OMEGA_SEED = 0x5EED


def _np(x):
    return np.asarray(x)


@functools.lru_cache(maxsize=None)
def _draws():
    """The JAX package's draws of every call the world makes."""
    out = {"rsvd_a": R.planted(*R.RSVD_RUN[:2], R.RSVD_RUN[2]),
           "pca_a": R.pca_data()}
    for n, k, os_ in ((R.RSVD_RUN[1], *R.RSVD_RUN[2:]),
                      (R.PCA_RUN[1], *R.PCA_RUN[2:])):
        out[f"omega_{n}_{k + os_}"] = _np(jax.random.normal(
            jax.random.key(OMEGA_SEED), (n, k + os_), jnp.float32))
    d = R.ALS_DENSE
    pu = -(-d["users"] // R.RANKS) * R.RANKS
    ku, kv, km, kn = jax.random.split(jax.random.key(d["seed"]), 4)
    out.update(dense_ut=_np(jax.random.normal(ku, (pu, d["true_rank"]))),
               dense_vt=_np(jax.random.normal(kv, (d["items"],
                                                   d["true_rank"]))),
               dense_noise=_np(jax.random.normal(kn, (pu, d["items"]))),
               dense_unif=_np(jax.random.uniform(km, (pu, d["items"]))),
               v0_dense=_np(jax.random.normal(jax.random.key(0), (
                   d["items"], d["cfg"][0]))))
    sp = R.ALS_SPARSE
    kperm, kshift, ku, kv, _ = jax.random.split(jax.random.key(sp["seed"]),
                                                5)
    out.update(
        sparse_perms=_np(jnp.stack([jax.random.permutation(k, sp["items"])
                                    for k in jax.random.split(kperm,
                                                              sp["s"])])),
        sparse_shifts=_np(jax.random.randint(kshift, (sp["s"],), 0,
                                             sp["items"])),
        sparse_ut=_np(jax.random.normal(ku, (sp["users"],
                                             sp["true_rank"]))),
        sparse_vt=_np(jax.random.normal(kv, (sp["items"],
                                             sp["true_rank"]))),
        v0_sparse=_np(jax.random.normal(jax.random.key(0), (
            sp["items"], sp["cfg"][0]))))
    return out


@pytest.fixture(scope="module")
def port():
    return R.world(R.apps_world, _draws())


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _columns_up_to_sign(got, want, axis):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if axis == 1:
        got, want = got.T, want.T
    sign = np.sign(np.sum(got * want, axis=0))
    err = np.linalg.norm(got * sign - want, axis=0)
    return float(np.max(err / np.linalg.norm(want, axis=0)))


def _same_costs(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        assert got[k][0] == want[k][0] and got[k][3] == want[k][3], k
        np.testing.assert_allclose(got[k][1:3], want[k][1:3], rtol=1e-12,
                                   err_msg=k)


def _jax_app(g, op, x, k, os_):
    cfg = jrsvd.Config(k=k, oversample=os_, power_iters=1)
    with jtracing.trace() as t:
        out = jax.jit(lambda a: getattr(jrsvd, op)(g, a, cfg))(
            jax.device_put(jnp.asarray(x), g.sharding(ROWS)))
    return tuple(np.asarray(o) for o in out), R.costs(t)


def test_rsvd_on_the_1d_grid_matches_jax(port, grid1d8):
    _check_rsvd(port, grid1d8, "1d8")


def test_rsvd_on_the_rect_grid_matches_jax(port, grid_rect):
    _check_rsvd(port, grid_rect, "rect")


def _check_rsvd(port, g, gname):
    m, n, k, os_ = R.RSVD_RUN
    (ju, js, jvt), jcosts = _jax_app(g, "rsvd", _draws()["rsvd_a"], k, os_)
    u, s, vt = port["rsvd"][gname]
    assert u.shape == (m, k) and vt.shape == (k, n)
    assert port["spec"][gname] == (("z", "y", "x"), None)
    assert _rel(s, js) < TOL, _rel(s, js)
    assert _rel((u * s) @ vt, (ju * js) @ jvt) < TOL
    assert _columns_up_to_sign(u, ju, 0) < 10 * TOL
    assert _columns_up_to_sign(vt, jvt, 1) < 10 * TOL
    _same_costs(port["costs"][gname], jcosts)


def test_pca_matches_jax(port, grid1d8):
    _, _, k, os_ = R.PCA_RUN
    (jc, jvar, jmean), jcosts = _jax_app(grid1d8, "pca", _draws()["pca_a"],
                                         k, os_)
    comps, var, mean = port["pca"]
    assert _rel(var, jvar) < TOL
    assert _rel(mean, jmean) < TOL
    assert _columns_up_to_sign(comps, jc, 1) < 10 * TOL
    _same_costs(port["costs"]["pca"], jcosts)


@functools.lru_cache(maxsize=None)
def _jax_dense(g):
    d = R.ALS_DENSE
    r, m = jals.synthetic_ratings(g, d["users"], d["items"],
                                  jax.random.key(d["seed"]),
                                  rank=d["true_rank"], density=d["density"])
    rank, lam, iters = d["cfg"]
    cfg = jals.Config(rank=rank, lam=lam, num_iters=iters)
    u, v, err = jax.jit(lambda rr, mm: jals.fit(g, rr, mm, cfg))(r, m)
    return tuple(np.asarray(x) for x in (r, m, u, v, err))


def test_synthetic_ratings_pad_users_as_jax(port, grid1d8):
    """509 users on 8 ranks: 512 rows, the last 3 unobserved."""
    r_j, m_j = _jax_dense(grid1d8)[:2]
    r, m, spec = port["ratings"]
    assert r.shape == m.shape == (512, R.ALS_DENSE["items"])
    assert spec == (("z", "y", "x"), None)
    np.testing.assert_array_equal(m, m_j)
    assert not m[R.ALS_DENSE["users"]:].any()
    assert np.max(np.abs(r - r_j)) < 1e-6


def test_dense_fit_matches_jax(port, grid1d8):
    _, _, u_j, v_j, err_j = _jax_dense(grid1d8)
    u, v, err, spec = port["fit"]
    assert spec == (("z", "y", "x"), None)
    assert _rel(u, u_j) < 1e-4, _rel(u, u_j)
    assert _rel(v, v_j) < 1e-4, _rel(v, v_j)
    assert abs(err - float(err_j)) < 1e-5 * float(err_j)
    assert err < 0.08
    for rank in port["ranks"]:
        np.testing.assert_array_equal(rank["v"], v)
        assert rank["err"] == err


def test_rmse_counts_observed_entries_only(port, grid1d8):
    """rmse over the padded rows equals the JAX package's and the RMSE of
    the 509 real users alone."""
    r, m, _ = port["ratings"]
    u, v, err, _ = port["fit"]
    want = float(jals.rmse(grid1d8, *(jnp.asarray(x) for x in (r, m, u,
                                                                 v))))
    assert abs(port["rmse"] - want) < 1e-5 * want
    users = R.ALS_DENSE["users"]
    r64, m64 = r[:users].astype(np.float64), m[:users].astype(np.float64)
    pred = u[:users].astype(np.float64) @ v.astype(np.float64).T
    own = np.sqrt(np.sum(((pred - r64) * m64) ** 2) / np.sum(m64))
    assert abs(port["rmse"] - own) < 1e-5 * own
    assert port["rmse"] == err


def test_sparse_matches_jax(port, grid1d8):
    sp = R.ALS_SPARSE
    data = jax.jit(lambda key: jals.synthetic_regular(
        grid1d8, sp["users"], sp["items"], sp["s"], key,
        rank=sp["true_rank"]))(jax.random.key(sp["seed"]))
    rank, lam, iters = sp["cfg"]
    cfg = jals.Config(rank=rank, lam=lam, num_iters=iters)
    u_j, v_j, err_j = jax.jit(lambda x: jals.fit_sparse(
        grid1d8, x, cfg, items=sp["items"]))(data)
    idx, val, idx_t, val_t = port["regular"]
    np.testing.assert_array_equal(idx, np.asarray(data.idx))
    np.testing.assert_array_equal(idx_t, np.asarray(data.idx_t))
    assert np.max(np.abs(val - np.asarray(data.val))) < 1e-6
    assert np.max(np.abs(val_t - np.asarray(data.val_t))) < 1e-6
    u, v, err = port["fit_sparse"]
    assert _rel(u, u_j) < 1e-4, _rel(u, u_j)
    assert _rel(v, v_j) < 1e-4, _rel(v, v_j)
    assert abs(err - float(err_j)) < 1e-5 * float(err_j)
    assert err < 0.08
