"""The port's Newton-Schulz inversion (algs/newton.py) and TSQR
(algs/tsqr.py) against the JAX package's, on a one-device grid, from the
same numpy operands, at 'highest'.

Newton: both starts (SPD I/||A||_inf, general A^T/(||A||_1 ||A||_inf))
take the JAX package's iteration count exactly; X agrees to relative
Frobenius 1e-5 and the two final residuals lie within 2x of each other.
TSQR on an ill-conditioned operand (singular values s_j from 1 down to
1e-6): R to relative Frobenius 1e-5; Q column by column, where
Householder QR carries ~eps / s_j of rounding that two LAPACK builds
place differently, to ||q_j - q_j'|| * s_j < 1e-6; diag(R) >= 0 in both;
both Q's orthogonal and Q R = A in f64 to 1e-6, the two packages'
figures within 2x of each other.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.algs import newton as jnewton
from capital_tpu.algs import tsqr as jtsqr
from capital_tpu.grid import Grid as JGrid
from capital_tpu_torch import Grid, interop, tracing
from capital_tpu_torch.algs import newton, tsqr

torch.set_num_threads(1)

TOL = 1e-5
ERR_RATIO = 2.0
N = 128
M, COND = 1024, 1e6
Q_COL_TOL = 1e-6   # on ||q_j - q_j'|| * s_j


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _jgrid():
    return JGrid.square(c=1, d=1, devices=jax.devices("cpu")[:1])


def _grid():
    return Grid.square(device="cpu")


@functools.lru_cache(maxsize=None)
def _operand(kind):
    rng = np.random.default_rng(7)
    u = rng.uniform(-0.5, 0.5, (N, N))
    if kind == "spd":
        a = (u + u.T) / 2 + N * np.eye(N)
    else:  # general nonsymmetric, diagonally weighted
        a = u + np.sqrt(N) * np.eye(N)
    return a.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _controlled(m, n, cond, seed=0):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((u * np.geomspace(1.0, 1.0 / cond, n)) @ v.T).astype(np.float32)


@pytest.mark.parametrize("kind", ["spd", "general"])
def test_newton_matches_jax_iteration_for_iteration(kind):
    a = _operand(kind)
    jcfg = jnewton.Config(spd=kind == "spd")
    grid = _jgrid()
    with jax.default_matmul_precision("highest"):
        x_j, it_j, res_j = jax.jit(lambda p: jnewton.invert(grid, p, jcfg))(
            jnp.asarray(a))
    cfg = interop.newton_config_from_dict(dataclasses.asdict(jcfg))
    with tracing.trace() as t:
        x, it, res = newton.invert(_grid(), torch.from_numpy(a), cfg)
    assert isinstance(it, int) and it == int(it_j) > 1
    assert _rel(x.numpy(), x_j) < TOL, _rel(x.numpy(), x_j)
    res, res_j = float(res), float(res_j)
    assert max(res, res_j) <= cfg.tol
    assert max(res, res_j) <= ERR_RATIO * min(res, res_j), (res, res_j)
    # one residual gemm up front, then an update and a residual a sweep
    assert t.totals().calls == 1 + 2 * it


def test_newton_stops_at_max_iter():
    a = _operand("general")
    x, it, res = newton.invert(_grid(), torch.from_numpy(a),
                               newton.Config(max_iter=2))
    assert it == 2 and float(res) > newton.Config().tol


@functools.lru_cache(maxsize=None)
def _jax_tsqr():
    grid = _jgrid()
    q, r = jax.jit(lambda p: jtsqr.factor(grid, p))(
        jnp.asarray(_controlled(M, N, COND)))
    return np.asarray(q), np.asarray(r)


def test_tsqr_matches_jax_on_an_ill_conditioned_operand():
    a = _controlled(M, N, COND)
    q_j, r_j = _jax_tsqr()
    q, r = tsqr.factor(_grid(), torch.from_numpy(a))
    q, r = q.numpy(), r.numpy()
    assert _rel(r, r_j) < TOL, _rel(r, r_j)
    s = np.geomspace(1.0, 1.0 / COND, N)
    col = np.linalg.norm(np.asarray(q, np.float64) - q_j, axis=0) * s
    assert col.max() < Q_COL_TOL, col.max()
    a64 = np.asarray(a, np.float64)
    figures = []
    for qq, rr in ((q, r), (q_j, r_j)):
        assert np.array_equal(rr, np.triu(rr))
        assert np.all(np.diag(rr) >= 0)
        q64, r64 = np.asarray(qq, np.float64), np.asarray(rr, np.float64)
        orth = np.linalg.norm(q64.T @ q64 - np.eye(N)) / np.sqrt(N)
        rec = np.linalg.norm(q64 @ r64 - a64) / np.linalg.norm(a64)
        assert orth < 1e-6 and rec < 1e-6, (orth, rec)
        figures.append((orth, rec))
    for e, e_j in zip(*figures):
        assert max(e, e_j) <= ERR_RATIO * min(e, e_j), (e, e_j)


def test_tsqr_sign_canonicalization():
    """canonical=False keeps LAPACK's signs (some diag(R) < 0 here);
    canonical flips both factors by the same diagonal."""
    a = torch.from_numpy(_controlled(M, N, COND))
    q0, r0 = tsqr.factor(_grid(), a, tsqr.Config(canonical=False))
    q1, r1 = tsqr.factor(_grid(), a)
    s = torch.where(torch.diagonal(r0) < 0, -1.0, 1.0)
    assert bool((s < 0).any())
    assert torch.equal(q1, q0 * s[None, :])
    assert torch.equal(r1, torch.triu(r0 * s[:, None]))
    jcfg = jtsqr.Config(canonical=False)
    assert interop.tsqr_config_from_dict(
        dataclasses.asdict(jcfg)) == tsqr.Config(canonical=False)


def test_tsqr_shape_check_tree_and_unknown_fields():
    with pytest.raises(ValueError, match="local rows >= n"):
        tsqr.factor(_grid(), torch.zeros(64, 128))
    with pytest.raises(NotImplementedError, match="M9 and M10"):
        tsqr._kern_tree(_grid(), torch.zeros(8, 2), tsqr.Config(), 2)
    with pytest.raises(ValueError, match="unknown"):
        interop.tsqr_config_from_dict({"canonical": True, "tree": 2})
    with pytest.raises(ValueError, match="unknown"):
        interop.newton_config_from_dict({"tol": 1e-6, "bogus": 0})
