"""The port's TSQR tree and QDWH polar across ranks against the JAX
package's on its 8 virtual CPU devices: one 8-rank gloo world
(tests/torch_mesh_ranks.py) factors, on the 1D grid of 8 ranks, a
well-conditioned 2048 x 96 operand and a 4096 x 64 one of condition 1e7
(where CholeskyQR2's Gram is unfactorable in f32; tests/test_tsqr.py's);
takes the polar decomposition of a 128 x 128 operand in the '2d' layout
on the flat 2 x 2 view (with H) and on the 2 x 2 x 2 grid (U only), and
of a 1024 x 64 operand in the '1d' layout on the 1D grid (with and
without H); resolves layout 'auto'; and runs nearest_orthogonal (both
layouts) and nearest_psd; and checks on the flat 2 x 2 view, against the
construction's numpy oracle alone, tests/test_polar.py's five properties
of the '2d' polar (square, ill-conditioned, f64, U only, the symmetric
involution), with its operands, seeds and bars.

Tolerances (the one-device files'): TSQR's R to relative Frobenius 1e-5
of the JAX package's, Q column by column as tests/test_torch_newton_tsqr
holds it (||q_j - q_j'|| s_j < 1e-6, s_j the j-th singular value: the
Householder factor carries ~eps / s_j of rounding that two LAPACK builds
place differently), diag(R) >= 0, Q orthogonal and Q R = A in f64 (5e-7
and 1e-6 well conditioned, 1e-6 at 1e7, tests/test_tsqr.py's bounds).
Polar's U and H to 1e-5, orthogonality and reconstruction in f64 below
1e-5 and within 2x of the JAX package's, H bitwise symmetric. Every rank
holds the same R, and the same Z factor in every '1d' step (each factors
the summed Gram, so they must be bitwise the same). The per-rank cost
records equal the JAX package's per-device ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as R
from capital_tpu import linalg as jlinalg
from capital_tpu import tracing as jtracing
from capital_tpu.algs import cholinv as jcholinv
from capital_tpu.algs import polar as jpolar
from capital_tpu.algs import tsqr as jtsqr
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(120, setup=180)

TOL = 1e-5
ERR_RATIO = 2.0
Q_COL_TOL = 1e-6
ROWS = jax.sharding.PartitionSpec(("z", "y", "x"), None)
TSQR_ORTH = {"well": 5e-7, "extreme": 1e-6}


@pytest.fixture(scope="module")
def port():
    return R.world(R.qr_polar_world, R.qr_polar_operands())


def _rows(g, x):
    return jax.device_put(jnp.asarray(x), g.sharding(ROWS))


def _slice(g, x):
    return jax.device_put(jnp.asarray(x), g.sharding(g.slice_spec))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _same_costs(got, want, key):
    assert set(got) == set(want), key
    for k in want:
        assert got[k][0] == want[k][0] and got[k][3] == want[k][3], (key, k)
        np.testing.assert_allclose(got[k][1:3], want[k][1:3], rtol=1e-12,
                                   err_msg=f"{key} {k}")


def _jcfg(compute_h=True):
    return jpolar.Config(compute_h=compute_h, chol=jcholinv.Config(
        min_bc=64, base_method="xla"))


@pytest.fixture(scope="module")
def jax_tsqr(grid1d8):
    out = {}
    for name, (m, n, cond, seed) in R.TSQR_CASES.items():
        with jtracing.trace() as t:
            q, r = jax.jit(lambda x: jtsqr.factor(grid1d8, x))(
                _rows(grid1d8, R.controlled(m, n, cond, seed)))
        out[name] = (np.asarray(q), np.asarray(r), R.costs(t))
    return out


@pytest.fixture(scope="module")
def jax_polar(grid122, grid222, grid1d8):
    sq, tall = R.polar_operands()
    out = {}
    for name, g, a, put, layout, h in (
            ("2d flat", grid122, sq, _slice, "2d", True),
            ("2d 222 u", grid222, sq, _slice, "2d", False),
            ("1d", grid1d8, tall, _rows, "1d", True),
            ("1d u", grid1d8, tall, _rows, "1d", False)):
        with jax.default_matmul_precision("highest"), \
                jtracing.trace() as t:
            res = jax.jit(lambda x: jpolar.polar(
                g, x, _jcfg(h), layout=layout))(put(g, a))
        u, hh = res if h else (res, None)
        out[name] = (np.asarray(u), None if hh is None else np.asarray(hh),
                     R.costs(t))
    return out


def _check_tsqr(port, jax_tsqr, name):
    m, n, cond, seed = R.TSQR_CASES[name]
    a = R.controlled(m, n, cond, seed)
    q, r, spec = port["tsqr"][name]
    q_j, r_j, _ = jax_tsqr[name]
    assert spec == (("z", "y", "x"), None)
    assert q.shape == (m, n) and r.shape == (n, n)
    assert _rel(r, r_j) < TOL, _rel(r, r_j)
    s = np.geomspace(1.0, 1.0 / cond, n)
    col = np.linalg.norm(np.asarray(q, np.float64) - q_j, axis=0) * s
    assert col.max() < Q_COL_TOL, col.max()
    a64 = a.astype(np.float64)
    for qq, rr in ((q, r), (q_j, r_j)):
        assert np.array_equal(rr, np.triu(rr))
        assert np.all(np.diag(rr) >= 0)
        q64, r64 = np.asarray(qq, np.float64), np.asarray(rr, np.float64)
        orth = np.linalg.norm(q64.T @ q64 - np.eye(n)) / np.sqrt(n)
        rec = np.linalg.norm(q64 @ r64 - a64) / np.linalg.norm(a64)
        assert orth < TSQR_ORTH[name] and rec < 1e-6, (name, orth, rec)


def test_tsqr_tree_well_conditioned_matches_jax(port, jax_tsqr):
    _check_tsqr(port, jax_tsqr, "well")


def test_tsqr_tree_extreme_cond_matches_jax(port, jax_tsqr):
    """cond 1e7: the Gram's condition 1e14 defeats CholeskyQR2 in f32;
    the tree keeps Householder orthogonality."""
    _check_tsqr(port, jax_tsqr, "extreme")


def test_tsqr_tree_r_on_every_rank_and_costs(port, jax_tsqr):
    for name in R.TSQR_CASES:
        r0 = port["ranks"][0]["r"][name]
        for row in port["ranks"][1:]:
            np.testing.assert_array_equal(row["r"][name], r0)
        _same_costs(port["costs"][f"tsqr {name}"], jax_tsqr[name][2],
                    f"tsqr {name}")


def _errors(a, u, h):
    a, u = np.asarray(a, np.float64), np.asarray(u, np.float64)
    n = u.shape[1]
    orth = np.linalg.norm(u.T @ u - np.eye(n)) / np.sqrt(n)
    if h is None:
        return (orth,)
    rec = np.linalg.norm(u @ np.asarray(h, np.float64) - a) / np.linalg.norm(a)
    return orth, rec


def _check_polar(port, jax_polar, name, a):
    u, h, _ = port["polar"][name]
    u_j, h_j, costs_j = jax_polar[name]
    assert _rel(u, u_j) < TOL, (name, _rel(u, u_j))
    if h_j is not None:
        assert _rel(h, h_j) < TOL, (name, _rel(h, h_j))
        assert np.array_equal(h, h.T), name
    else:
        assert h is None
    for e, e_j in zip(_errors(a, u, h), _errors(a, u_j, h_j)):
        assert max(e, e_j) < TOL, (name, e, e_j)
        assert max(e, e_j) <= ERR_RATIO * min(e, e_j), (name, e, e_j)
    _same_costs(port["costs"][f"polar {name}"], costs_j, f"polar {name}")


def test_polar_2d_matches_jax(port, jax_polar):
    """'2d': the Gram by summa.syrk, Z by the distributed cholinv, the
    updates by summa.trmm, H = U^T A by summa.syrk2, with and without
    H; U laid out on the slice."""
    sq, _ = R.polar_operands()
    _check_polar(port, jax_polar, "2d flat", sq)
    _check_polar(port, jax_polar, "2d 222 u", sq)
    assert port["polar"]["2d flat"][2] == ("y", "x")


def test_polar_1d_matches_jax(port, jax_polar):
    """'1d': the Gram summed over the ranks, Z factored on every rank,
    the updates local TRMMs on each rank's rows, with and without H."""
    _, tall = R.polar_operands()
    _check_polar(port, jax_polar, "1d", tall)
    _check_polar(port, jax_polar, "1d u", tall)
    assert port["polar"]["1d"][2] == (("z", "y", "x"), None)
    for name in ("1d", "1d u"):
        z0 = port["ranks"][0]["zinv"][name]
        assert len(z0) >= 4  # one a QDWH step, two in the QR-variant step
        for row in port["ranks"][1:]:
            for z, zz in zip(row["zinv"][name], z0):
                np.testing.assert_array_equal(z, zz)


def test_layout_auto_follows_jax(port, grid122, grid1d8):
    """layout 'auto' on more than one rank: a DArray of rows, or any
    m >= 4n, is '1d', else '2d' (the JAX package's rule; it reads a
    committed sharding where the port reads the DArray's spec, and
    refuses an uncommitted array outside jit)."""
    sq, tall = R.polar_operands()
    assert port["layout"] == {"rows": "1d", "tall tensor": "1d",
                              "square": "2d"}
    assert jpolar._resolve_layout(grid1d8, _rows(grid1d8, tall),
                                  "auto") == "1d"
    assert jpolar._resolve_layout(grid122, _slice(grid122, sq),
                                  "auto") == "2d"


def test_nearest_orthogonal_and_psd_match_jax(port, grid122, grid1d8):
    """nearest_orthogonal in both layouts ('auto') and nearest_psd, each
    against the JAX package's."""
    _, tall = R.polar_operands()
    near = R.nearest_operand()
    with jax.default_matmul_precision("highest"):
        q2 = jlinalg.nearest_orthogonal(grid122, _slice(grid122, near),
                                        _jcfg())
        q1 = jlinalg.nearest_orthogonal(grid1d8, _rows(grid1d8, tall),
                                        _jcfg())
        p = jax.jit(lambda x: jlinalg.nearest_psd(grid122, x, _jcfg()))(
            _slice(grid122, near))
    got = port["nearest"]
    for key, want in (("orthogonal 2d", q2), ("orthogonal 1d", q1),
                      ("psd", p)):
        assert _rel(got[key], want) < TOL, (key, _rel(got[key], want))
    assert np.array_equal(got["psd"], got["psd"].T)
    assert np.linalg.eigvalsh(got["psd"].astype(np.float64)).min() > -1e-5


def _controlled(n, cond, seed):
    """tests/test_polar.py's A = U diag(s) V^T (f64) and its exact polar
    factor U V^T."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((n, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (u * np.geomspace(1.0, 1.0 / cond, n)) @ v.T, u @ v.T


def _symmetric(n, seed):
    s = np.random.default_rng(seed).standard_normal((n, n))
    return (s + s.T) / 2 + np.diag(np.linspace(-2, 2, n)), None


# name: (operand, dtype, compute_h, bars): orthogonality, reconstruction,
# max |U - U_exact|, H's least eigenvalue (> -bar), U^2 = I for symmetric A
POLAR_2X2 = {
    "square": (lambda: _controlled(256, 50.0, 0), np.float32, True,
               {"orth": 5e-6, "rec": 1e-5, "exact": 1e-4, "psd": 1e-5}),
    "illconditioned": (lambda: _controlled(192, 1e4, 1), np.float32, True,
                       {"orth": 5e-6, "rec": 2e-5, "exact": 5e-3}),
    "f64": (lambda: _controlled(128, 1e7, 4), np.float64, True,
            {"orth": 1e-13, "rec": 1e-12, "exact": 1e-8}),
    "u_only": (lambda: _controlled(128, 10.0, 3), np.float32, False,
               {"orth": 5e-6}),
    "symmetric_involution": (lambda: _symmetric(128, 5), np.float32, False,
                             {"involution": 1e-5}),
}


@pytest.mark.parametrize("name", list(POLAR_2X2))
def test_polar_2x2_properties(name):
    """tests/test_polar.py's '2d' checks on grid122's layout: U
    orthogonal, U H = A, U against the exact factor, H symmetric PSD; for
    symmetric A, U a symmetric involution."""
    make, dtype, compute_h, bars = POLAR_2X2[name]
    a_np, u_true = make()
    got = R.world(R.polar_2x2_world, a_np.astype(dtype), compute_h)
    assert got["u"].dtype == dtype and (got["h"] is None) != compute_h
    u = np.asarray(got["u"], np.float64)
    h = None if got["h"] is None else np.asarray(got["h"], np.float64)
    errors = _errors(a_np, u, h)
    if "orth" in bars:
        assert errors[0] < bars["orth"], errors
    if "rec" in bars:
        assert errors[1] < bars["rec"], errors
    if "exact" in bars:
        assert np.abs(u - u_true).max() < bars["exact"]
    if "psd" in bars:
        np.testing.assert_allclose(h, h.T, atol=1e-6)
        assert np.linalg.eigvalsh(h).min() > -bars["psd"]
    if "involution" in bars:
        n = u.shape[1]
        np.testing.assert_allclose(u, u.T, atol=bars["involution"])
        assert np.linalg.norm(u @ u - np.eye(n)) / np.sqrt(n) \
            < bars["involution"]
