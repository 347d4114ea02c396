"""The port's solver layer (capital_tpu_torch/linalg.py) against the JAX
package's capital_tpu/linalg.py, on a one-device grid, from the same
numpy operands, at 'highest'.

Each result agrees with the JAX package's to relative Frobenius 1e-5
(slogdet's log|det| to relative 1e-6); each package's residual, taken in
f64 with numpy, is below 1e-5 and within 2x of the other's. expm is also
held to scipy.linalg.expm in f64 (1e-5). A 1-D b gives a 1-D x. The
entry points that need the QDWH eigensolver or SVD raise
NotImplementedError naming their ROADMAP items.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from capital_tpu import linalg as jlinalg
from capital_tpu.algs import cacqr as jcacqr
from capital_tpu.algs import cholinv as jcholinv
from capital_tpu.grid import Grid as JGrid
from capital_tpu_torch import Grid, interop, linalg
from capital_tpu_torch.algs import cacqr, cholinv

torch.set_num_threads(1)

TOL = 1e-5
ERR_RATIO = 2.0
N, K = 128, 4
M_TALL = 1024


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("CAPITAL_TRMM_METHOD", "CAPITAL_SYRK_METHOD",
                "CAPITAL_CHOL_METHOD", "CAPITAL_LU_LOOKAHEAD",
                "CAPITAL_LU_PANEL", "CAPITAL_LU_LEAF"):
        monkeypatch.delenv(var, raising=False)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@functools.lru_cache(maxsize=None)
def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.5, 0.5, (n, n))
    return ((u + u.T) / 2 + n * np.eye(n)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _general(n, cond, seed=1):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((n, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((u * np.geomspace(1.0, 1.0 / cond, n)) @ v.T).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tall(m, n, seed=2):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.5, 0.5, (m, n)) * np.linspace(1.0, 2.0, n)
    return a.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rhs(rows, k, seed=3):
    return np.random.default_rng(seed).uniform(
        -0.5, 0.5, (rows, k)).astype(np.float32)


def _jgrid():
    return JGrid.square(c=1, d=1, devices=jax.devices("cpu")[:1])


def _grid():
    return Grid.square(device="cpu")


def _jax(fn, *arrays):
    with jax.default_matmul_precision("highest"):
        out = jax.jit(fn)(*(jnp.asarray(x) for x in arrays))
    return jax.tree.map(np.asarray, out)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _solve_res(a, x, b):
    a, x, b = (np.asarray(v, np.float64) for v in (a, x, b))
    return np.linalg.norm(a @ x - b) / np.linalg.norm(b)


def _close_residuals(r, r_j):
    assert max(r, r_j) < TOL, (r, r_j)
    assert max(r, r_j) <= ERR_RATIO * min(r, r_j), (r, r_j)


@pytest.mark.parametrize("refine", [0, 2])
def test_spd_solve_matches_jax(refine):
    a, b = _spd(N), _rhs(N, K)
    g = _jgrid()
    x_j = _jax(lambda p, q: jlinalg.spd_solve(g, p, q, refine=refine), a, b)
    x = linalg.spd_solve(_grid(), _t(a), _t(b), refine=refine).numpy()
    assert _rel(x, x_j) < TOL, _rel(x, x_j)
    _close_residuals(_solve_res(a, x, b), _solve_res(a, x_j, b))


def test_spd_solve_factor_reuse_and_vector_rhs():
    a, b = _spd(N), _rhs(N, K)
    grid = _grid()
    fac = cholinv.factor(grid, _t(a), cholinv.Config(summa_impl="gspmd"))
    x = linalg.spd_solve(grid, _t(a), _t(b), factor=fac)
    x1 = linalg.spd_solve(grid, _t(a), _t(b[:, 0]))
    assert x1.shape == (N,)
    np.testing.assert_allclose(x1.numpy(), x[:, 0].numpy(), rtol=0,
                               atol=1e-6)
    g = _jgrid()
    x1_j = _jax(lambda p, q: jlinalg.spd_solve(g, p, q), a, b[:, 0])
    assert x1_j.shape == (N,)
    assert _rel(x1.numpy(), x1_j) < TOL


def test_inv_and_slogdet_spd_match_jax():
    a = _spd(N)
    g = _jgrid()
    inv_j = _jax(lambda p: jlinalg.inv(g, p), a)
    sign_j, ld_j = _jax(lambda p: jlinalg.slogdet_spd(g, p), a)
    grid = _grid()
    inv = linalg.inv(grid, _t(a)).numpy()
    sign, ld = linalg.slogdet_spd(grid, _t(a))
    assert _rel(inv, inv_j) < TOL
    res = [np.linalg.norm(np.asarray(a, np.float64) @ x - np.eye(N))
           / np.sqrt(N) for x in (inv, inv_j)]
    _close_residuals(*res)
    assert float(sign) == float(sign_j) == 1.0
    assert abs(float(ld) - float(ld_j)) <= 1e-6 * abs(float(ld_j))
    want = np.linalg.slogdet(np.asarray(a, np.float64))[1]
    assert abs(float(ld) - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("method", ["normal", "lu", "polar", "auto"])
def test_solve_matches_jax(method):
    a, b = _general(N, 100.0), _rhs(N, K)
    g = _jgrid()
    x_j = _jax(lambda p, q: jlinalg.solve(g, p, q, method=method), a, b)
    x = linalg.solve(_grid(), _t(a), _t(b), method=method).numpy()
    assert _rel(x, x_j) < TOL, _rel(x, x_j)
    _close_residuals(_solve_res(a, x, b), _solve_res(a, x_j, b))


def test_solve_lu_bf16_factor_and_vector_rhs():
    """factor_dtype=bf16 factors a downcast copy and refines against A;
    a 1-D b gives a 1-D x."""
    a, b = _general(N, 10.0), _rhs(N, 1)[:, 0]
    g = _jgrid()
    x_j = _jax(lambda p, q: jlinalg.solve(g, p, q, method="lu",
                                          factor_dtype=jnp.bfloat16), a, b)
    x = linalg.solve(_grid(), _t(a), _t(b), method="lu",
                     factor_dtype=torch.bfloat16).numpy()
    assert x.shape == x_j.shape == (N,)
    assert _rel(x, x_j) < TOL, _rel(x, x_j)
    _close_residuals(_solve_res(a, x, b), _solve_res(a, x_j, b))


def test_solve_rejects_unknown_method():
    with pytest.raises(ValueError, match="unknown solve method"):
        linalg.solve(_grid(), _t(_spd(N)), _t(_rhs(N, K)), method="qr")


@pytest.mark.parametrize("scale", [0.02, 8.0])
def test_expm_matches_jax_and_scipy(scale):
    """scale 0.02: ||A||_1 below theta13 (no squaring); 8.0: squarings."""
    rng = np.random.default_rng(4)
    a = (rng.uniform(-0.5, 0.5, (N, N)) * scale / np.sqrt(N)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):  # eager: a host read
        e_j = np.asarray(jlinalg.expm(_jgrid(), jnp.asarray(a)))
    e = linalg.expm(_grid(), _t(a)).numpy()
    want = scipy.linalg.expm(np.asarray(a, np.float64))
    assert _rel(e, e_j) < TOL, _rel(e, e_j)
    assert _rel(e, want) < 1e-5, _rel(e, want)
    with pytest.raises(ValueError, match="square"):
        linalg.expm(_grid(), _t(a[:, :64]))


@pytest.mark.parametrize("method,refine", [("cqr2", 0), ("cqr2", 1),
                                           ("tsqr", 0), ("tsqr", 1)])
def test_lstsq_matches_jax(method, refine):
    a, b = _tall(M_TALL, N), _rhs(M_TALL, K)
    g = _jgrid()
    x_j = _jax(lambda p, q: jlinalg.lstsq(g, p, q, refine=refine,
                                          method=method), a, b)
    cfg = interop.cacqr_config_from_dict(
        dataclasses.asdict(jcacqr.Config(num_iter=2)))
    x = linalg.lstsq(_grid(), _t(a), _t(b), cfg, refine=refine,
                     method=method).numpy()
    assert _rel(x, x_j) < TOL, _rel(x, x_j)
    a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
    res = [np.linalg.norm(a64.T @ (a64 @ np.asarray(v, np.float64) - b64))
           / np.linalg.norm(b64) for v in (x, x_j)]
    _close_residuals(*res)


def test_lstsq_vector_rhs_and_unknown_method():
    a, b = _tall(M_TALL, N), _rhs(M_TALL, 1)[:, 0]
    grid = _grid()
    x = linalg.lstsq(grid, _t(a), _t(b), cacqr.Config(num_iter=2))
    assert x.shape == (N,)
    with pytest.raises(ValueError, match="unknown lstsq method"):
        linalg.lstsq(grid, _t(a), _t(b), method="svd")


@pytest.mark.parametrize("name,args", [
    ("pinv", ()), ("cond", ()), ("funm_spd", (np.sqrt,)),
    ("spd_sqrt", ()), ("logm_spd", ()), ("powm_spd", (0.5,))])
def test_spectral_entry_points_raise_until_ported(name, args):
    with pytest.raises(NotImplementedError, match="M18.*M19"):
        getattr(linalg, name)(_grid(), _t(_spd(N)), *args)


def test_default_cholinv_config_is_the_jax_one():
    """The solvers' default cholinv.Config (gspmd) equals the JAX
    package's field for field."""
    want = interop.config_from_dict(dataclasses.asdict(
        jcholinv.Config(summa_impl="gspmd")))
    assert want == cholinv.Config(summa_impl="gspmd")
