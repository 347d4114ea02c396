"""The port's distributed cholinv against the JAX package's on its 8
virtual CPU devices: one 8-rank gloo world (tests/torch_mesh_ranks.py)
factors the same numpy SPD operand (n = 256, base case 64, the
torch.linalg / XLA leaf) on the 2 x 2 x 2 grid with each leaf placement,
each SUMMA engine and knob, `lower`, `complete_inv=False`, split 2 and a
negative bc_mult, and on the flat 2 x 2 view. R and Rinv agree with the
JAX package's to relative Frobenius 1e-5; both packages' validator
residuals are below 5e-6; the placements agree with REPLICATED bitwise
(GATHER_OVERLAP, a potrf then a trtri, to 1e-5); the leaf is factored
only where the placement says; the per-rank cost records equal the JAX
package's per-device ones."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as R
from capital_tpu import tracing as jtracing
from capital_tpu import validate as jvalidate
from capital_tpu.algs import cholinv as jcholinv
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(180, setup=180)

TOL, RES_TOL = 1e-5, 5e-6


@pytest.fixture(scope="module")
def port():
    return R.world(R.cholinv_world)


def _jcfg(**kw):
    base = dict(min_bc=64, base_method="xla")
    base.update(kw)
    return jcholinv.Config(**base)


@functools.lru_cache(maxsize=None)
def _residual_fn(g):
    """The JAX package's two residuals on grid g, jitted once a grid."""
    return jax.jit(lambda a, r, ri: (jvalidate.cholesky_residual(g, a, r),
                                     jvalidate.inverse_residual(g, r, ri)))


def _residuals(g, a, r, ri):
    return tuple(float(x) for x in _residual_fn(g)(a, r, ri))


@pytest.fixture(scope="module")
def jax_side(grid222):
    """name -> (R, Rinv, cost records, residuals) of the JAX package,
    each factor jitted (its trace records the costs once, as an eager
    call does)."""
    g = grid222
    a = jax.device_put(jnp.asarray(R.spd(R.CHOL_N, 13)),
                       g.sharding(g.slice_spec))
    out = {}
    for name, kw in R.CHOL_CASES.items():
        cfg = _jcfg(**kw)
        with jtracing.trace() as t:
            r, ri = jax.jit(lambda x: jcholinv.factor(g, x, cfg))(a)
        res = None if cfg.lower else _residuals(g, a, r, ri)
        out[name] = (np.asarray(r), np.asarray(ri), R.costs(t), res)
    flat = g.view(z=None, y="y", x="x")
    r, ri = jax.jit(lambda x: jcholinv.factor(flat, x, _jcfg()))(a)
    out["flat"] = (np.asarray(r), np.asarray(ri), None,
                   _residuals(flat, a, r, ri))
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _check(port, jax_side, names):
    for name in names:
        r, ri = port["factor"][name]
        jr, jri, _, _ = jax_side[name]
        assert _rel(r, jr) < TOL, (name, _rel(r, jr))
        assert _rel(ri, jri) < TOL, (name, _rel(ri, jri))


def test_each_leaf_placement_matches_jax(port, jax_side):
    names = [f"policy {p}" for p in R.POLICIES]
    _check(port, jax_side, names)
    r0, ri0 = port["factor"]["policy replicated"]
    for p in ("layer", "gather"):  # the same leaf, broadcast
        r, ri = port["factor"][f"policy {p}"]
        np.testing.assert_array_equal(r, r0)
        np.testing.assert_array_equal(ri, ri0)
    r, ri = port["factor"]["policy gather_overlap"]
    assert _rel(r, r0) < TOL and _rel(ri, ri0) < TOL


def test_leaf_runs_where_the_placement_says(port):
    """Leaves factored on each rank (torch.linalg's leaf, counted by
    lapack.chol_inv): every rank (REPLICATED), the z == 0 layer (LAYER),
    rank (0, 0, 0) (GATHER), none of the fused leaf (GATHER_OVERLAP)."""
    leaves = 4  # n = 256 at base case 64
    for row in port["ranks"]:
        z, y, x = row["coord"]
        got = row["leaves"]
        assert got["policy replicated"] == leaves
        assert got["policy layer"] == (leaves if z == 0 else 0)
        assert got["policy gather"] == (leaves if (z, y, x) == (0, 0, 0)
                                        else 0)
        assert got["policy gather_overlap"] == 0


def test_each_engine_and_knob_matches_jax(port, jax_side):
    _check(port, jax_side, ("ring", "gspmd", "chunks", "flat"))


def test_lower_and_partial_inverse_match_jax(port, jax_side):
    _check(port, jax_side, ("lower", "gspmd lower", "partial"))
    r, _ = port["factor"]["lower"]
    assert np.allclose(r, np.tril(r))
    # complete_inv=False leaves the top level's off-diagonal block empty
    _, ri = port["factor"]["partial"]
    assert not ri[:128, 128:].any()


def test_split_and_bc_mult_match_jax(port, jax_side):
    _check(port, jax_side, ("split2", "bc_mult"))


def test_validators_match_jax(port, jax_side):
    """cholesky_residual and inverse_residual across ranks (the SUMMA
    syrk and trmm) in both packages, below 5e-6 and within a factor 4 of
    each other; with complete_inv=False the top level's R12inv is not
    assembled, so the inverse residual is large in both, and equal."""
    for name, got in port["residuals"].items():
        want = jax_side[name][3]
        if name == "partial":
            np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
            got, want = got[:1], want[:1]
        for g, w in zip(got, want):
            assert g < RES_TOL and w < RES_TOL, (name, got, want)
            assert g < 4 * w + 1e-7 and w < 4 * g + 1e-7, (name, got, want)


def test_costs_match_jax(port, jax_side):
    """The per-rank analytic records (phases CI::factor_diag, CI::trsm,
    CI::tmu, CI::inv; kinds base_case, summa.gemm, summa.transpose) equal
    the JAX package's per-device records."""
    for name in R.CHOL_CASES:
        want, got = jax_side[name][2], port["costs"][name]
        assert set(got) == set(want), name
        for k in want:
            assert got[k][0] == want[k][0] and got[k][3] == want[k][3], \
                (name, k)
            np.testing.assert_allclose(got[k][1:3], want[k][1:3],
                                       rtol=1e-12, err_msg=f"{name} {k}")
