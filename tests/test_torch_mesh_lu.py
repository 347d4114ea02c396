"""The port's LU across ranks against the JAX package's on its 8 virtual
CPU devices: one 8-rank gloo world (tests/torch_mesh_ranks.py) factors
the same numpy operand (general, n = 256, nb = 64) on the 2 x 2 x 2 grid
and on the flat 2 x 2 view (the JAX package's grid122), with lookahead
(CAPITAL_LU_LOOKAHEAD=1), and with the recursive panel
(CAPITAL_LU_PANEL=jax: the port's getrf_leaf through its plain version,
the JAX package's masked fori_loop leaf; CAPITAL_LU_IB=16 on the 2 x 2 x
2 grid for four leaves a panel); solves with and without two refinement
sweeps and a 1-D right-hand side; and takes slogdet.

Tolerances (tests/test_torch_lu.py's): perm and sign identical; w's L
part (|l| <= 1) to 2e-4 and its U part to 1e-4 x max|w|, since U's
entries grow with n and f32 rounding in another summation order grows
with them; both residuals ||PA - LU|| / ||A|| below 5e-6. Every rank
returns the same perm, sign and panel pivots (the panel is factored on
every rank, so they must be bitwise the same). Solutions are held to
numpy's f64 solve: the operand's condition number is ~4.9e3, so f32
rounding in another order moves x by up to ~cond x 2^-24 = 2.9e-4 (the
JAX package's grid1 and grid122 solves differ by 2.6e-4). Unrefined (and
the 1-D right-hand side): the port's error to f64 at most twice the JAX
package's, both below 5e-4. Refined: both within 1e-4 of f64 and of
each other; the residual ||Ax - b|| / ||b|| of the port's at most twice
the JAX package's, both below 5e-5 (the JAX package's refined solve
reads 2.0e-5 on this operand, f64's solution rounded to f32 4.1e-6).
slogdet's sign equal
and log|det| to 1e-5 relative of the JAX package's and numpy's; the JAX
package's slogdet takes the factor that `jax_side` jitted on the 2 x 2 x
2 grid (its own `factor` call, same operand and Config): jitted whole,
XLA:CPU's thunk executor may enter the diagonal's two-device all-gathers
and the factor's last collective permute in different orders on
different virtual devices, and under load (xdist workers beside gloo
worlds) it aborts the process at its 40 s rendezvous timeout. The
per-rank cost
records (LU::panel, swap, trsm, schur) equal the JAX package's
per-device ones."""

import contextlib
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as R
from capital_tpu import tracing as jtracing
from capital_tpu.algs import lu as jlu
from capital_tpu.parallel import summa as jsumma
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(120, setup=180)

COND_TOL, REFINED_TOL, RES_TOL = 5e-4, 1e-4, 5e-5


@contextlib.contextmanager
def _isolated_state():
    """No CAPITAL_LU_* and the JAX package's default matmul precision
    inside; os.environ and jax.config restored after (the JAX package's
    drivers set both and leave them set: bench/lu.py --lookahead,
    bench/common.apply_precision). Yields the MonkeyPatch, to set more."""
    prec = jax.config.jax_default_matmul_precision
    with pytest.MonkeyPatch.context() as mp:
        for k in [k for k in os.environ if k.startswith("CAPITAL_LU")]:
            mp.delenv(k)
        jax.config.update("jax_default_matmul_precision", None)
        try:
            yield mp
        finally:
            jax.config.update("jax_default_matmul_precision", prec)


@pytest.fixture(autouse=True)
def _isolated():
    """Each test in _isolated_state (the module-scoped jax_side, set up
    before it, enters it too)."""
    with _isolated_state():
        yield


@pytest.fixture(scope="module")
def port():
    return R.world(R.lu_world)


@pytest.fixture(scope="module")
def grids(grid222, grid122):
    return {"222": grid222, "flat": grid122}


def _slice(g, x):
    return jax.device_put(jnp.asarray(x), g.sharding(g.slice_spec))


@pytest.fixture(scope="module")
def jax_side(grids):
    """name -> (w, perm, sign, cost records) of the JAX package, each
    factor jitted in _isolated_state with the case's CAPITAL_* switches
    set while it traces (its trace records the costs once, as an eager
    call does)."""
    a_np = R.general(R.LU_N, 1)
    out = {}
    for name, (gname, env) in R.LU_CASES.items():
        g = grids[gname]
        with _isolated_state() as mp:
            R.setenv(mp, **env)
            with jtracing.trace() as t:
                w, perm, sign = jax.jit(lambda x: jlu.factor(
                    g, x, jlu.Config(nb=R.LU_NB)))(_slice(g, a_np))
        out[name] = (np.asarray(w), np.asarray(perm), float(sign),
                     R.costs(t))
    return out


def _residual(a, w, perm):
    w = np.asarray(w, np.float64)
    n = w.shape[0]
    l = np.tril(w, -1) + np.eye(n)
    pa = np.asarray(a, np.float64)[np.asarray(perm)]
    return np.linalg.norm(pa - l @ np.triu(w)) / np.linalg.norm(a)


def _close(w, w_j):
    w, w_j = np.asarray(w, np.float64), np.asarray(w_j, np.float64)
    d = np.abs(w - w_j)
    return (np.tril(d, -1).max(initial=0) <= 2e-4
            and np.triu(d).max() <= 1e-4 * np.abs(w_j).max())


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _check(port, jax_side, name):
    a = R.general(R.LU_N, 1)
    w, perm, sign = port["factor"][name]
    w_j, perm_j, sign_j, _ = jax_side[name]
    np.testing.assert_array_equal(perm, perm_j, err_msg=name)
    assert sign == sign_j, name
    assert _close(w, w_j), name
    assert _residual(a, w, perm) < 5e-6 and _residual(a, w_j, perm_j) < 5e-6


def test_factor_on_222_and_flat_match_jax(port, jax_side):
    """CAPITAL_LU_PANEL=auto: every panel by LAPACK in both packages
    (torch.linalg.lu_factor / lax.linalg.lu), gathered whole first."""
    _check(port, jax_side, "222")
    _check(port, jax_side, "flat")


def test_lookahead_matches_jax(port, jax_side):
    _check(port, jax_side, "lookahead")
    # the same pivots as the monolithic schedule
    np.testing.assert_array_equal(port["factor"]["lookahead"][1],
                                  port["factor"]["222"][1])


def test_recursive_panel_route_matches_jax(port, jax_side):
    """CAPITAL_LU_PANEL=jax: the port's recursive panel with the
    getrf_leaf wrapper (its plain version on a CPU tensor) against the
    JAX package's recursive panel with its fori_loop leaf."""
    _check(port, jax_side, "panel_jax")
    _check(port, jax_side, "panel_jax_lookahead")


def test_solve_and_refine_match_jax(port, grid122):
    g = grid122
    a_np, b_np = R.general(R.LU_N, 1), R.operand(R.LU_N, R.LU_K, 7)
    a, b = _slice(g, a_np), _slice(g, b_np)
    cfg = jlu.Config(nb=R.LU_NB)
    x_j = jax.jit(lambda a, b: jlu.solve(g, a, b, cfg))(a, b)

    def refined(a, b):
        w, perm, _ = jlu.factor(g, a, cfg)
        x = jlu.solve_factored(g, w, perm, b)
        for _ in range(2):
            with jax.default_matmul_precision("highest"):
                res = b - jsumma.gemm(g, a, x)
            x = x + jlu.solve_factored(g, w, perm, res)
        return x, jlu.solve_factored(g, w, perm, b[:, 0])

    xr_j, xv_j = jax.jit(refined)(a, b)
    got = port["solve"]
    a64 = a_np.astype(np.float64)
    x64 = np.linalg.solve(a64, b_np)
    for mine, theirs, want in ((got["plain"], x_j, x64),
                               (got["vector"], xv_j, x64[:, 0])):
        e, e_j = _rel(mine, want), _rel(theirs, want)
        assert e <= 2 * e_j and max(e, e_j) < COND_TOL, (e, e_j)
    assert got["vector"].shape == (R.LU_N,) == xv_j.shape
    assert _rel(got["refined"], x64) < REFINED_TOL
    assert _rel(xr_j, x64) < REFINED_TOL
    assert _rel(got["refined"], xr_j) < REFINED_TOL
    res, res_j = (np.linalg.norm(a64 @ x - b_np) / np.linalg.norm(b_np)
                  for x in (got["refined"], np.asarray(xr_j)))
    assert res <= 2 * res_j and max(res, res_j) < RES_TOL, (res, res_j)


def test_slogdet_matches_jax_and_numpy(port, jax_side, grid222):
    a_np = R.general(R.LU_N, 1)
    w, perm, psign, _ = jax_side["222"]
    factored = (jnp.asarray(w), jnp.asarray(perm), jnp.float32(psign))
    with mock.patch.object(jlu, "factor", lambda *args: factored):
        s_j, ld_j = jlu.slogdet(grid222, _slice(grid222, a_np),
                                jlu.Config(nb=R.LU_NB))
    s_np, ld_np = np.linalg.slogdet(a_np.astype(np.float64))
    sign, logdet = port["slogdet"]
    assert sign == float(s_j) == s_np
    assert abs(logdet - float(ld_j)) <= 1e-5 * abs(float(ld_j))
    assert abs(logdet - ld_np) <= 1e-5 * abs(ld_np)


def test_every_rank_holds_the_same_pivots(port):
    """perm, sign, each panel's local permutation and pivots and slogdet:
    identical on all 8 ranks (the replicated panel factored on each)."""
    first = port["ranks"][0]
    assert sorted(r["rank"] for r in port["ranks"]) == list(range(R.RANKS))
    for row in port["ranks"][1:]:
        for name in R.LU_CASES:
            np.testing.assert_array_equal(row["perm"][name],
                                          first["perm"][name])
            assert row["sign"][name] == first["sign"][name]
            assert len(row["panels"][name]) == R.LU_N // R.LU_NB
            for (p, v), (p0, v0) in zip(row["panels"][name],
                                        first["panels"][name]):
                np.testing.assert_array_equal(p, p0)
                np.testing.assert_array_equal(v, v0)
        assert row["slogdet"] == first["slogdet"]


def test_costs_match_jax(port, jax_side):
    """The per-rank analytic records (lu.panel, lu.swap, summa.gemm of the
    U row and Schur slabs) equal the JAX package's per-device ones."""
    for name in R.LU_CASES:
        want, got = jax_side[name][3], port["costs"][name]
        assert set(got) == set(want), name
        for k in want:
            assert got[k][0] == want[k][0] and got[k][3] == want[k][3], \
                (name, k)
            np.testing.assert_allclose(got[k][1:3], want[k][1:3],
                                       rtol=1e-12, err_msg=f"{name} {k}")
