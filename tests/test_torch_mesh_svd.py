"""The port's QDWH-SVD and linalg's spectral functions across ranks
against the JAX package's on its 8 virtual CPU devices: one 8-rank gloo
world (tests/torch_mesh_ranks.py) runs svd '2d' of a 256 x 256 operand
on the flat 2 x 2 view (the JAX package's grid122 shape; H's eigensolver
splits at base 128) and of a 128 x 128 one on the 2 x 2 x 2 grid, svd
'1d' of a 512 x 128 one on the 1D grid of 8, svd_partial (k = 8) on the
flat view, singular_values '1d', pinv (square on the 2 x 2 x 2 grid, tall
'1d' on the 1D grid) and cond with the svd cases' config, and funm_spd
(exp), spd_sqrt both ways, logm_spd and powm_spd on the flat view and the
2 x 2 x 2 grid, each from the same numpy operand in both packages.

Tolerances are tests/test_torch_svd.py's: singular values within S_TOL *
s_max of the JAX package's; each package's orthogonality of U and V and
reconstruction in f64 below ERR_TOL; on the separated spectra every right
singular vector agrees with the JAX package's column by column within
V_TOL * s_max over its gap; the funm_spd family within relative
Frobenius TOL of the JAX package's, symmetric exactly; pinv and cond
within COND_TOL * cond(A) of the JAX package's and of f64. U keeps the
polar iterate's layout (the slice, or rows over every rank for '1d'), V
is a DArray of the slice, a tall pinv is laid out over columns, and
every rank decides alike."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as R
from capital_tpu import linalg as jlinalg
from capital_tpu.algs import cholinv as jcholinv
from capital_tpu.algs import eigh as jeigh
from capital_tpu.algs import polar as jpolar
from capital_tpu.algs import svd as jsvd
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(210, setup=180)

S_TOL, ERR_TOL, V_TOL, TOL = 1e-6, 1e-5, 1e-6, 1e-5
COND_TOL = 4 * float(np.finfo(np.float32).eps)
ROWS = jax.sharding.PartitionSpec(("z", "y", "x"), None)


@functools.lru_cache(maxsize=None)
def _ops():
    return R.svd_operands()


@pytest.fixture(scope="module")
def port():
    return R.world(R.svd_world, _ops())


@pytest.fixture(scope="module")
def grids(grid122, grid222, grid1d8):
    return {"flat": grid122, "222": grid222, "1d8": grid1d8}


def _jcfg():
    chol = jcholinv.Config(base_method="xla")
    return jsvd.Config(polar=jpolar.Config(chol=chol),
                       eig=jeigh.Config(base_n=128, polar=jpolar.Config(
                           compute_h=False, chol=chol)))


def _put(g, x, layout="2d"):
    spec = ROWS if layout == "1d" else g.slice_spec
    return jax.device_put(jnp.asarray(x), g.sharding(spec))


def _errors(a, u, s, v):
    a = np.asarray(a, np.float64)
    u, s, v = (np.asarray(x, np.float64) for x in (u, s, v))
    k = u.shape[1]
    ou = np.linalg.norm(u.T @ u - np.eye(k)) / np.sqrt(k)
    ov = np.linalg.norm(v.T @ v - np.eye(k)) / np.sqrt(k)
    rec = np.linalg.norm((u * s) @ v.T - a) / np.linalg.norm(a)
    return ou, ov, rec


def _columns_agree(s_true, v, v_j):
    v, v_j = np.asarray(v, np.float64), np.asarray(v_j, np.float64)
    gap = np.minimum(np.abs(np.diff(s_true, prepend=np.inf)),
                     np.abs(np.diff(s_true, append=-np.inf)))
    sign = np.sign(np.sum(v * v_j, axis=0))
    return float(np.max(np.linalg.norm(v * sign - v_j, axis=0) * gap)
                 / s_true[0])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_svd_2d_matches_jax(port, grids):
    """'2d' on the flat view (H split at base 128) and on the 2 x 2 x 2
    grid."""
    for name in ("wide", "square"):
        _check_svd(port, grids, name)


def test_svd_1d_matches_jax(port, grids):
    """'1d' on the 1D grid of 8: U as rows over every rank."""
    _check_svd(port, grids, "tall")


def _check_svd(port, grids, name):
    _, _, s_true, _, layout, gname = R.SVD_CASES[name]
    g = grids[gname]
    a = _ops()[name]
    with jax.default_matmul_precision("highest"):
        ju, js, jv = (np.asarray(x) for x in jsvd.svd(
            g, _put(g, a, layout), _jcfg(), layout=layout))
    u, s, v = port["svd"][name]
    assert u.shape == a.shape and v.shape == (a.shape[1],) * 2
    assert np.max(np.abs(s - js)) <= S_TOL * js[0]
    for e, e_j in zip(_errors(a, u, s, v), _errors(a, ju, js, jv)):
        assert max(e, e_j) < ERR_TOL, (e, e_j)
    assert _columns_agree(np.asarray(s_true, np.float64), v, jv) < V_TOL
    rows = (("z", "y", "x"), None)
    assert port["spec"][name] == ((rows if layout == "1d" else ("y", "x")),
                                  ("y", "x"))


def test_svd_partial_and_singular_values_match_jax(port, grid122, grid1d8):
    a = _ops()["wide"]
    k = R.SVD_PARTIAL_K
    with jax.default_matmul_precision("highest"):
        ju, js, jv = (np.asarray(x) for x in jsvd.svd_partial(
            grid122, _put(grid122, a), k, _jcfg(), layout="2d"))
        jvals = np.asarray(jsvd.singular_values(
            grid1d8, _put(grid1d8, _ops()["tall"], "1d"), _jcfg(),
            layout="1d"))
    u, s, v = port["partial"]
    assert u.shape == (256, k) and v.shape == (256, k)
    assert np.max(np.abs(s - js)) <= S_TOL * js[0]
    a64 = a.astype(np.float64)
    for uu, ss, vv in ((u, s, v), (ju, js, jv)):
        res = (np.linalg.norm(a64 @ vv - uu * ss)
               / np.linalg.norm(a64))
        assert res < ERR_TOL, res
    assert np.max(np.abs(port["values"] - jvals)) <= S_TOL * jvals[0]
    s_true = np.linalg.svd(_ops()["tall"].astype(np.float64),
                           compute_uv=False)
    assert np.max(np.abs(port["values"] - s_true)) <= S_TOL * s_true[0]


def _jax_linalg(g, case):
    fn, which, _, kw = R.SVD_LINALG[case]
    kw = dict(kw)
    if "fn" in kw:
        kw["fn"] = jnp.exp
    if "cfg" in kw:
        kw["cfg"] = _jcfg()
    layout = kw.get("layout", "2d")
    with jax.default_matmul_precision("highest"):
        return np.asarray(getattr(jlinalg, fn)(
            g, _put(g, _ops()[which], layout), **kw))


def test_pinv_square_and_tall_match_jax(port, grids):
    for case in ("pinv_square", "pinv_tall"):
        _, which, gname, _ = R.SVD_LINALG[case]
        want = _jax_linalg(grids[gname], case)
        got = port["linalg"][case]
        a64 = _ops()[which].astype(np.float64)
        assert got.shape == want.shape == a64.shape[::-1]
        tol = COND_TOL * np.linalg.cond(a64)
        true = np.linalg.pinv(a64)
        for err in (_rel(got, want), _rel(got, true), _rel(want, true)):
            assert err < tol, (case, err, tol)
    assert port["spec"]["pinv_square"] == ("y", "x")
    assert port["spec"]["pinv_tall"] == (None, ("z", "y", "x"))


def test_cond_matches_jax(port, grids):
    want = _jax_linalg(grids["222"], "cond")
    a64 = _ops()["square"].astype(np.float64)
    true = np.linalg.cond(a64)
    got = port["linalg"]["cond"]
    assert got.shape == ()
    tol = COND_TOL * true
    for err in (_rel(got, want), _rel(got, true), _rel(want, true)):
        assert err < tol, (err, tol)


def test_funm_family_matches_jax(port, grids):
    """funm_spd (exp), spd_sqrt both ways, logm_spd, powm_spd."""
    for case in ("funm_spd", "spd_sqrt", "spd_sqrt_inverse", "logm_spd",
                 "powm_spd"):
        gname = R.SVD_LINALG[case][2]
        want = _jax_linalg(grids[gname], case)
        got = port["linalg"][case]
        assert _rel(got, want) < TOL, (case, _rel(got, want))
        assert np.array_equal(got, got.T), case
        assert port["spec"][case] == ("y", "x"), case


def test_every_rank_decides_alike(port):
    ranks = port["ranks"]
    assert len(ranks) == R.RANKS
    for r in ranks[1:]:
        assert r["seen"] == ranks[0]["seen"]
    assert any(kind == "split" for kind, *_ in ranks[0]["seen"]["wide"])
