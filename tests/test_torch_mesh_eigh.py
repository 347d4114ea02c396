"""The port's QDWH eigensolver across ranks against the JAX package's on
its 8 virtual CPU devices: one 8-rank gloo world (tests/torch_mesh_ranks.py)
runs eigh of a separated n = 256 spectrum (base 128) on the flat 2 x 2
view (the JAX package's grid122 shape) and on the 2 x 2 x 2 grid, eigh of
an n = 202 operand (the blkdiag padding, and children of 101 rows, which
do not divide the mesh and stay replicated along it), count_above at three
shifts, eigvalsh, eigh_partial (top and bottom 16) and eigh_gen (n =
128, its eigenproblem one base case); every rank records its decisions
(each sign's n, shift and trace, each split's n, k and coupling). Each
cholinv inside is one leaf (min_bc 512), which keeps the JAX package's
compiles short.

The splitting Gaussians differ from jax.random's (on a world grid the
counter-based hash of `matrix`), so, as tests/test_torch_eigh.py holds
the one-device port:
  * the top level's (sigma, k) equals the JAX package's;
  * eigenvalues within W_TOL * ||A||_F of the JAX package's;
  * each package's residual and orthogonality in f64 below ERR_TOL;
  * on the separated spectrum every eigenvector agrees with the JAX
    package's column by column within V_TOL * ||A||_F over its gap;
  * count_above is exact; eigh_partial's values within 3 W_TOL ||A||_F;
    eigh_gen's within 10 W_TOL of the exact ones, X^T B X = I and the
    residual below ERR_TOL;
  * every rank's decision list is the same, and so is the world
    Gaussian.
The JAX references are computed once per module, their stages jitted."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as R
from capital_tpu.algs import cholinv as jcholinv
from capital_tpu.algs import eigh as jeigh
from capital_tpu.algs import polar as jpolar
from capital_tpu.parallel import summa as jsumma
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(120, setup=180)

W_TOL, ERR_TOL, V_TOL = 1e-6, 1e-5, 1e-6


@functools.lru_cache(maxsize=None)
def _ops():
    return R.eigh_operands()


@pytest.fixture(scope="module")
def port():
    return R.world(R.eigh_world, _ops())


def _jcfg(base_n):
    return jeigh.Config(base_n=base_n, polar=jpolar.Config(
        compute_h=False, chol=jcholinv.Config(min_bc=512,
                                              base_method="xla")))


def _put(g, x):
    return jax.device_put(jnp.asarray(x), g.sharding(g.slice_spec))


def _record(out):
    """Record the JAX package's signs (n, sigma) and splits (n, k)."""
    sign, split = jeigh._stage_sign, jeigh._stage_split

    def rec_sign(grid, a, sigma, cfg):
        out.append(("sign", a.shape[0], float(sigma)))
        return sign(grid, a, sigma, cfg)

    def rec_split(grid, a, u, key, cfg, k):
        out.append(("split", a.shape[0], k))
        return split(grid, a, u, key, cfg, k)

    return rec_sign, rec_split


@functools.lru_cache(maxsize=None)
def _jax_eigh(g, case):
    """(w, V, decisions) of the JAX package's eigh on grid g."""
    from unittest import mock

    seen = []
    rec_sign, rec_split = _record(seen)
    with mock.patch.object(jeigh, "_stage_sign", rec_sign), \
            mock.patch.object(jeigh, "_stage_split", rec_split), \
            jax.default_matmul_precision("highest"):
        w, v = jeigh.eigh(g, _put(g, _ops()[case]),
                          _jcfg(R.EIGH_CASES[case][3]))
    return np.asarray(w), np.asarray(v), seen


def _errors(a, w, v):
    a, w, v = (np.asarray(x, np.float64) for x in (a, w, v))
    res = np.linalg.norm(a @ v - v * w) / np.linalg.norm(a)
    orth = np.linalg.norm(v.T @ v - np.eye(v.shape[1])) / np.sqrt(
        v.shape[1])
    return res, orth


def _columns_agree(a, v, v_j):
    v, v_j = np.asarray(v, np.float64), np.asarray(v_j, np.float64)
    w = np.linalg.eigvalsh(np.asarray(a, np.float64))
    gap = np.minimum(np.diff(w, prepend=-np.inf), np.diff(w, append=np.inf))
    s = np.sign(np.sum(v * v_j, axis=0))
    return float(np.max(np.linalg.norm(v * s - v_j, axis=0) * gap)
                 / np.linalg.norm(a))


def _top(seen):
    """The top level's accepted (sigma, k)."""
    i = next(i for i, s in enumerate(seen) if s[0] == "split")
    return seen[i - 1][2], seen[i][2]


def _check_eigh(port, name, case, g, separated):
    a = _ops()[case]
    w_j, v_j, seen_j = _jax_eigh(g, case)
    w, v = port["eigh"][name]
    scale = np.linalg.norm(a)
    assert port["spec"][name] == ("y", "x")
    (s, k), (s_j, k_j) = _top(port["seen"][name]), _top(seen_j)
    assert k == k_j and abs(s - s_j) <= 1e-6 * scale, (s, k, s_j, k_j)
    assert np.all(np.diff(w.astype(np.float64)) >= -1e-6 * scale)
    assert np.max(np.abs(w.astype(np.float64) - w_j)) <= W_TOL * scale
    for e, e_j in zip(_errors(a, w, v), _errors(a, w_j, v_j)):
        assert max(e, e_j) < ERR_TOL, (e, e_j)
    if separated:
        assert _columns_agree(a, v, v_j) < V_TOL


def test_eigh_on_the_flat_view_matches_jax(port, grid122):
    _check_eigh(port, "flat", "separated", grid122, True)


def test_eigh_on_the_25d_grid_matches_jax(port, grid222):
    _check_eigh(port, "222", "separated", grid222, True)


def test_eigh_with_ragged_blocks_matches_jax(port, grid122):
    """n = 202: the padded sign and orthonormalization, and children of
    odd size (101)."""
    _check_eigh(port, "ragged", "ragged", grid122, True)
    splits = [(n, k) for kind, n, k, *_ in port["seen"]["ragged"]
              if kind == "split"]
    assert splits[0] == (202, 101), splits


def test_count_above_and_eigvalsh_match_jax(port, grid122):
    a = _ops()["separated"]
    w_true = np.linalg.eigvalsh(a.astype(np.float64))
    with jax.default_matmul_precision("highest"):
        for sigma, got in port["count"].items():
            want = jeigh.count_above(grid122, _put(grid122, a), sigma,
                                     _jcfg(128))
            assert got == want == int(np.sum(w_true > sigma)), sigma
    w_j = _jax_eigh(grid122, "separated")[0]
    assert np.max(np.abs(port["eigvalsh"] - w_j)) <= W_TOL * np.linalg.norm(
        a)


@functools.lru_cache(maxsize=None)
def _jax_partial(g, which):
    with jax.default_matmul_precision("highest"):
        w, x = jeigh.eigh_partial(g, _put(g, _ops()["separated"]),
                                  R.PARTIAL_K, _jcfg(128), which=which)
    return np.asarray(w), np.asarray(x)


def test_eigh_partial_matches_jax(port, grid122):
    """The top and the bottom 16 pairs."""
    for which in ("top", "bottom"):
        _check_partial(port, grid122, which)


def _check_partial(port, grid122, which):
    a = _ops()["separated"]
    k = R.PARTIAL_K
    w_j, x_j = _jax_partial(grid122, which)
    w, x = port["partial"][which]
    assert w.shape == (k,) and x.shape == (a.shape[0], k)
    assert port["spec"][which] == ("y", "x")
    w_true = np.linalg.eigvalsh(a.astype(np.float64))
    w_true = w_true[-k:] if which == "top" else w_true[:k]
    scale = np.linalg.norm(a)
    assert np.max(np.abs(w - w_j)) <= 3 * W_TOL * scale
    assert np.max(np.abs(w - w_true)) <= 3 * W_TOL * scale
    for e, e_j in zip(_errors(a, w, x), _errors(a, w_j, x_j)):
        assert max(e, e_j) < ERR_TOL, (e, e_j)


def _jax_eigh_gen(g, a, b, cfg):
    """The JAX package's eigh_gen (capital_tpu/algs/eigh.py:761-793) with
    its reduction and back-transformation jitted (eager shard_map
    compiles every call): cholinv of B, C = Rinv^T A Rinv symmetrized,
    eigh, X = Rinv Y."""
    impl = cfg.polar.chol.summa_impl

    def reduce(a, b):
        _, rinv = jcholinv.factor(g, b, cfg.polar.chol)
        ar = jsumma.trmm(g, rinv, a, side="R", uplo="U", impl=impl)
        c = jsumma.trmm(g, rinv, ar, side="L", uplo="U", trans_a=True,
                        impl=impl)
        return g.constrain(0.5 * (c + c.T), g.slice_spec), rinv

    with jax.default_matmul_precision("highest"):
        c, rinv = jax.jit(reduce)(_put(g, a), _put(g, b))
        w, y = jeigh.eigh(g, c, cfg)
        x = jax.jit(lambda r, y: jsumma.trmm(g, r, y, side="L", uplo="U",
                                             impl=impl))(rinv, y)
    return np.asarray(w), np.asarray(x)


def test_eigh_gen_matches_jax(port, grid122):
    n = R.EIGH_GEN_N
    a = _ops()["separated"][:n, :n]
    b = _ops()["gen_b"]
    w_j, x_j = _jax_eigh_gen(grid122, a, b, _jcfg(n))
    w, x = port["gen"]
    assert port["spec"]["gen"] == ("y", "x")
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    lo = np.linalg.cholesky(b64)
    li = np.linalg.inv(lo)
    w_true = np.linalg.eigvalsh(li @ a64 @ li.T)
    wmax = np.max(np.abs(w_true))
    for got in (w, np.asarray(w_j)):
        assert np.max(np.abs(got - w_true)) <= 10 * W_TOL * wmax
    for xx, ww in ((x, w), (np.asarray(x_j), np.asarray(w_j))):
        x64 = np.asarray(xx, np.float64)
        btb = x64.T @ b64 @ x64
        assert np.linalg.norm(btb - np.eye(n)) / np.sqrt(n) < ERR_TOL
        res = (np.linalg.norm(a64 @ x64 - b64 @ x64 * ww)
               / np.linalg.norm(a64))
        assert res < ERR_TOL


def test_every_rank_decides_alike(port):
    """Every rank's list of decision inputs (signs' shifts and traces,
    splits' k and coupling) is the same, bit for bit, as is the world
    Gaussian; its moments are a standard normal's."""
    ranks = port["ranks"]
    assert len(ranks) == R.RANKS
    for r in ranks[1:]:
        assert r["seen"] == ranks[0]["seen"]
        np.testing.assert_array_equal(r["normal"], ranks[0]["normal"])
    for name, seen in ranks[0]["seen"].items():
        assert any(kind == "split" for kind, *_ in seen), name
    g = ranks[0]["normal"].astype(np.float64)
    assert abs(g.mean()) < 0.05 and abs(g.std() - 1.0) < 0.05
