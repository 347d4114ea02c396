"""The port's triangular layer across ranks against the JAX package's on
its 8 virtual CPU devices: one 8-rank gloo world (tests/torch_mesh_ranks.py)
runs rectri.invert (lower and upper, n = 256, base case 64), trsm.solve
(left lower and upper, right lower and upper, the packed LU workspace with
unit_diag and its upper triangle, nb = 64) on the 2 x 2 x 2 grid, a
single right-hand side on the 2 x 2 x 2 grid and on the flat 2 x 2 view
(d = 2: padded to the d*c unit and cut back), and newton.invert (SPD on
the 2 x 2 x 2 grid, general on the flat view, 'gspmd', 'highest').

Tolerances (tests/test_torch_trsm.py's and test_torch_newton_tsqr.py's):
relative Frobenius 1e-5 to the JAX package's result (the operands are
well conditioned; the gap is f32 rounding in another summation order),
and each result solves its system (or inverts its triangle) to 1e-5;
Newton takes the JAX package's iteration count exactly on every rank, X
to 1e-5, both final residuals below tol and within 2x of each other. Its
tol is 1e-5 (tests/test_inverse.py's bound on the result): at the
default 1e-6 the stopping test reads the f32 rounding floor of
||I - X A||_F / sqrt(n), and the count follows the summation order (the
JAX package's own SPD count at n = 128 is 4 on one device and on the
flat 2 x 2 grid, 3 on the 2 x 2 x 2 grid). The
per-rank cost records equal the JAX package's per-device ones, with two
known differences: the JAX package's trsm scan records its body's two
summa.gemm calls once at trace time, which the port's loop does not (its
`trsm.substitute` record states the whole substitution, in both
packages); and the JAX package's Newton while_loop records its body once,
where the port's loop records every iteration (the same record each
time)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as R
from capital_tpu import tracing as jtracing
from capital_tpu.algs import newton as jnewton
from capital_tpu.algs import rectri as jrectri
from capital_tpu.algs import trsm as jtrsm
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(60, setup=180)

TOL = 1e-5
ERR_RATIO = 2.0


@pytest.fixture(scope="module")
def port():
    return R.world(R.tri_world)


def _slice(g, x):
    return jax.device_put(jnp.asarray(x), g.sharding(g.slice_spec))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _jtri():
    return jrectri.Config(min_bc=64, base_method="xla")


def _jtrsm():
    return jtrsm.Config(nb=64, tri=_jtri())


def _same_costs(got, want, skip=()):
    if skip:  # the totals then differ by what is skipped
        skip = skip + ("<total>",)
        got = {k: v for k, v in got.items() if k != "<total>"}
    want = {k: v for k, v in want.items()
            if not any(k.startswith(s) for s in skip)}
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        assert got[k][0] == want[k][0] and got[k][3] == want[k][3], k
        np.testing.assert_allclose(got[k][1:3], want[k][1:3], rtol=1e-12,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_trsm(grid222):
    """case -> (X, cost records) of the JAX package's trsm, jitted."""
    out = {}
    for name, c in R.TRSM_CASES.items():
        a, b = R.trsm_operands(name)
        kw = dict(side=c["side"], lower=c["lower"], unit_diag=c["unit_diag"])
        with jtracing.trace() as t:
            x = jax.jit(lambda x, y: jtrsm.solve(
                grid222, x, y, cfg=_jtrsm(), **kw))(_slice(grid222, a),
                                                    _slice(grid222, b))
        out[name] = (np.asarray(x), R.costs(t))
    return out


def test_rectri_lower_and_upper_match_jax(port, grid222):
    t_np = R.spd(R.TRI_N, 2)
    for lower in (True, False):
        t = np.tril(t_np) if lower else np.triu(t_np)
        with jtracing.trace() as jt:
            want = jax.jit(lambda x: jrectri.invert(
                grid222, x, lower=lower, cfg=_jtri()))(_slice(grid222, t))
        got = port["rectri"][lower]
        assert _rel(got, want) <= TOL, (lower, _rel(got, want))
        err = np.linalg.norm(t.astype(np.float64) @ got - np.eye(R.TRI_N))
        assert err / np.sqrt(R.TRI_N) < TOL
        off = np.triu(got, 1) if lower else np.tril(got, -1)
        assert not off.any()
        _same_costs(port["costs"][f"rectri {lower}"], R.costs(jt))


def _check_trsm(port, jax_trsm, name):
    c = R.TRSM_CASES[name]
    a, b = R.trsm_operands(name)
    got, want = port["trsm"][name], jax_trsm[name][0]
    assert got.shape == want.shape == b.shape
    assert _rel(got, want) <= TOL, (name, _rel(got, want))
    t = a.astype(np.float64)
    if c["unit_diag"]:
        t = np.tril(t, -1) + np.eye(R.TRI_N)
    else:
        t = np.tril(t) if c["lower"] else np.triu(t)
    r = t @ got - b if c["side"] == "L" else got @ t - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < TOL, name


def test_trsm_left_matches_jax(port, jax_trsm):
    for name in ("lower", "upper"):
        _check_trsm(port, jax_trsm, name)


def test_trsm_right_and_packed_unit_diag_match_jax(port, jax_trsm):
    for name in ("right_lower", "right_upper", "packed_unit_lower",
                 "packed_upper"):
        _check_trsm(port, jax_trsm, name)


def test_single_rhs_on_d2_matches_jax(port, grid222, grid122):
    """One right-hand side: padded to d*c = 4 (2 x 2 x 2) or 2 (flat)
    columns for the panel gemms, cut back to one column, which Grid.
    constrain leaves replicated (1 does not split over 'x')."""
    a, _ = R.trsm_operands("lower")
    b1 = R.operand(R.TRI_N, 1, 4)
    for gname, g in (("222", grid222), ("flat", grid122)):
        want = jax.jit(lambda x, y: jtrsm.solve(g, x, y, cfg=_jtrsm()))(
            _slice(g, a), jnp.asarray(b1))
        got, shape, spec = port["trsm"][f"one_column {gname}"]
        assert shape == (R.TRI_N, 1) and spec == ("y", None), (shape, spec)
        assert _rel(got, want) <= TOL, (gname, _rel(got, want))
        r = np.tril(a).astype(np.float64) @ got - b1
        assert np.linalg.norm(r) / np.linalg.norm(b1) < TOL


def _check_newton(port, kind, g):
    jcfg = jnewton.Config(spd=kind == "spd", tol=R.NEWTON_TOL)
    a = R.newton_operand(kind)
    with jax.default_matmul_precision("highest"), \
            jtracing.trace() as jt:
        x_j, it_j, res_j = jax.jit(lambda p: jnewton.invert(
            g, p, jcfg))(_slice(g, a))
    x, it, res = port["newton"][kind]
    assert it == int(it_j) > 1, (kind, it, int(it_j))
    for row in port["ranks"]:
        assert row["iters"][kind] == it
    assert _rel(x, x_j) < TOL, (kind, _rel(x, x_j))
    res_j = float(res_j)
    assert max(res, res_j) <= jcfg.tol
    assert max(res, res_j) <= ERR_RATIO * min(res, res_j), (res, res_j)
    # the JAX package's trace records its loop body once
    got, want = port["costs"][f"newton {kind}"], R.costs(jt)
    assert set(got) == set(want) == {"NS::iterate/summa.gemm", "<total>"}
    (c, f, b, m), (cj, fj, bj, mj) = got[
        "NS::iterate/summa.gemm"], want["NS::iterate/summa.gemm"]
    assert c == 1 + 2 * it and cj == 3
    np.testing.assert_allclose((f / c, b / c, m / c),
                               (fj / cj, bj / cj, mj / cj), rtol=1e-12)


def test_newton_spd_on_222_matches_jax_iteration_count(port, grid222):
    """The I / ||A||_inf start on the 2 x 2 x 2 grid."""
    _check_newton(port, "spd", grid222)


def test_newton_general_on_flat_matches_jax_iteration_count(port, grid122):
    """The A^T / (||A||_1 ||A||_inf) start on the flat 2 x 2 view."""
    _check_newton(port, "general", grid122)


def test_costs_match_jax(port, jax_trsm):
    """trsm's records (TRSM::diaginvert/*, trsm.substitute, the side='R'
    transposes) equal the JAX package's but for its scan body's gemms."""
    for name in R.TRSM_CASES:
        _same_costs(port["costs"][f"trsm {name}"], jax_trsm[name][1],
                    skip=("TRSM::substitute/summa.gemm",))
