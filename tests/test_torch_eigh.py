"""The port's QDWH eigensolver (capital_tpu_torch/algs/eigh.py) and
validate.eig_residual against the JAX package's, on a one-device grid,
from the same numpy operands and config, at 'highest'.

The splitting Gaussians differ (a torch.Generator against jax.random), so
only the top level's decision is the same computation in both packages:
its (sigma, k) must be equal. Below it the child blocks are different
orthogonal similarities of the same block, so V is compared by what
holds for any right answer:
  * eigenvalues agree with the JAX package's within W_TOL * ||A||_F;
  * each package's residual ||A V - V diag(w)||_F / ||A||_F and
    orthogonality ||V^T V - I||_F / sqrt(n), in f64 with numpy, lie
    below ERR_TOL;
  * on separated spectra every eigenvector agrees with the JAX
    package's, column by column after fixing its sign, within V_TOL *
    ||A||_F over its eigenvalue's gap.
Each JAX reference is computed once per module (lru_cache): its stages
are jitted per shape, and the compiles are most of this file's time.
"""

import contextlib
import dataclasses
import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu import validate as jvalidate
from capital_tpu.algs import cholinv as jcholinv
from capital_tpu.algs import eigh as jeigh
from capital_tpu.algs import polar as jpolar
from capital_tpu.grid import Grid as JGrid
from capital_tpu.ops import pallas_chol, pallas_syrk, pallas_trmm
from capital_tpu_torch import Grid, interop, validate
from capital_tpu_torch.algs import eigh
from capital_tpu_torch.ops import counters, reset_counters
from capital_tpu_torch.ops.precision import default_matmul_precision
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(90, setup=120)

torch.set_num_threads(1)

ENV = ("CAPITAL_TRMM_METHOD", "CAPITAL_SYRK_METHOD", "CAPITAL_CHOL_METHOD",
       "CAPITAL_EIGH_DEBUG")
KERNEL_ENV = {"CAPITAL_TRMM_METHOD": "tri", "CAPITAL_SYRK_METHOD": "tri",
              "CAPITAL_CHOL_METHOD": "pallas"}
W_TOL = 1e-6        # eigenvalues against the JAX package's, times ||A||_F
ERR_TOL = 1e-5      # residual and orthogonality of each package, in f64
V_TOL = 1e-6        # an eigenvector against the JAX package's, times its
                    # gap over ||A||_F (separated spectra; Davis-Kahan: a
                    # vector moves by its residual over its gap)
SIGMA_TOL = 1e-6    # the top-level shift, relative to ||A||_F


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


def _sym(n, vals, seed=0):
    """A = Q diag(vals) Q^T with a Haar-ish Q (f64 construction)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * np.asarray(vals)) @ q.T


# name -> (the operand's maker, base_n, separated spectrum)
CASES = {
    "separated": (lambda: _sym(256, np.linspace(-1.0, 1.0, 256), 0), 128,
                  True),
    # n = 320 is no multiple of the 128 alignment: the sign and the
    # orthonormalization run on the blkdiag padding
    "unaligned": (lambda: _sym(320, np.linspace(0.1, 3.0, 320), 1), 128,
                  True),
    # two tight clusters and spread tails: repeated eigenvalues
    "clustered": (lambda: _sym(256, np.concatenate(
        [np.linspace(-3.0, -2.0, 32), np.full(96, -1.0), np.full(96, 1.0),
         np.linspace(2.0, 3.0, 32)]), 2), 128, False),
}


@functools.lru_cache(maxsize=None)
def _operand(name):
    if name == "early_out":
        # sigma I + tiny noise: the Gershgorin cluster test fires (no polar)
        rng = np.random.default_rng(3)
        e = rng.standard_normal((256, 256)) * 1e-9
        return (2.5 * np.eye(256) + (e + e.T) / 2)
    return CASES[name][0]()


def _base_n(name):
    return 64 if name == "early_out" else CASES[name][1]


def _jcfg(base_n, route="dot", **kw):
    """The eigh config of both packages. The kernels' route leaves the leaf
    to CAPITAL_CHOL_METHOD ('auto'); the plain route pins 'xla'. The two
    configs differ, so the JAX package's jitted stages trace each route
    anew."""
    chol = jcholinv.Config(base_method="auto" if route == "tri" else "xla")
    return jeigh.Config(base_n=base_n, polar=jpolar.Config(
        compute_h=False, chol=chol), **kw)


def _cfg(base_n, route="dot", **kw):
    return interop.eigh_config_from_dict(dataclasses.asdict(
        _jcfg(base_n, route, **kw)))


def _jgrid():
    return JGrid.square(c=1, d=1, devices=jax.devices("cpu")[:1])


def _grid():
    return Grid.square(device="cpu")


@contextlib.contextmanager
def _decisions(mod, out: list):
    """Record every sign's (n, sigma) and every split's (n, k)."""
    sign, split = mod._stage_sign, mod._stage_split

    def rec_sign(grid, a, sigma, cfg):
        out.append(("sign", a.shape[0], float(sigma)))
        return sign(grid, a, sigma, cfg)

    def rec_split(grid, a, u, key, cfg, k):
        out.append(("split", a.shape[0], k))
        return split(grid, a, u, key, cfg, k)

    with mock.patch.object(mod, "_stage_sign", rec_sign), \
            mock.patch.object(mod, "_stage_split", rec_split):
        yield


@functools.lru_cache(maxsize=None)
def _jax_eigh(name, route="dot"):
    a = jnp.asarray(_operand(name).astype(np.float32))
    seen = []
    with _route(route), jax.default_matmul_precision("highest"), \
            _decisions(jeigh, seen):
        w, v = jeigh.eigh(_jgrid(), a, _jcfg(_base_n(name), route))
    return np.asarray(w), np.asarray(v), seen


def _port_eigh(name, route="dot"):
    a = torch.from_numpy(_operand(name).astype(np.float32))
    seen = []
    with _route(route), default_matmul_precision("highest"), \
            _decisions(eigh, seen):
        reset_counters()
        w, v = eigh.eigh(_grid(), a, _cfg(_base_n(name), route))
        used = counters()
    return w.numpy(), v.numpy(), seen, used


@contextlib.contextmanager
def _route(route):
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.dict(
            os.environ, KERNEL_ENV if route == "tri" else {}))
        if route == "tri":
            for mod, name in ((pallas_syrk, "syrk_upper"),
                              (pallas_trmm, "trmm_upper"),
                              (pallas_chol, "chol_inv_pallas")):
                stack.enter_context(mock.patch.object(
                    mod, name, functools.partial(getattr(mod, name),
                                                 interpret=True)))
        yield


def _errors(a, w, v):
    """(residual, orthogonality) in f64."""
    a = np.asarray(a, np.float64)
    w, v = np.asarray(w, np.float64), np.asarray(v, np.float64)
    res = np.linalg.norm(a @ v - v * w) / np.linalg.norm(a)
    orth = np.linalg.norm(v.T @ v - np.eye(v.shape[1])) / np.sqrt(v.shape[1])
    return res, orth


def _top(seen):
    """The top level's accepted (sigma, k): the first split and the sign
    that fed it."""
    i = next(i for i, s in enumerate(seen) if s[0] == "split")
    return seen[i - 1][2], seen[i][2], seen[i][1]


def _columns_agree(a, v, v_j):
    """Largest ||v_i - sign * v_j,i|| * gap_i / ||A||_F over the columns,
    gap_i the distance of the i-th eigenvalue (f64) to its neighbours."""
    v, v_j = np.asarray(v, np.float64), np.asarray(v_j, np.float64)
    w = np.linalg.eigvalsh(a)
    gap = np.minimum(np.diff(w, prepend=-np.inf), np.diff(w, append=np.inf))
    s = np.sign(np.sum(v * v_j, axis=0))
    return float(np.max(np.linalg.norm(v * s - v_j, axis=0) * gap)
                 / np.linalg.norm(a))


def _check_pairs(a, w, v, w_j, v_j, separated=False):
    scale = np.linalg.norm(a)
    assert np.all(np.diff(np.asarray(w, np.float64)) >= -1e-6 * scale)
    dw = np.max(np.abs(np.asarray(w, np.float64) - w_j)) / scale
    assert dw <= W_TOL, dw
    for e, e_j in zip(_errors(a, w, v), _errors(a, w_j, v_j)):
        assert max(e, e_j) < ERR_TOL, (e, e_j)
    if separated:
        dv = _columns_agree(a, v, v_j)
        assert dv < V_TOL, dv


def test_config_matches_jax():
    """Defaults, the resolved fields and the sign's polar config equal the
    JAX package's; the interop reader refuses unknown fields."""
    jcfg, cfg = jeigh.Config(), eigh.Config()
    assert interop.eigh_config_from_dict(dataclasses.asdict(jcfg)) == cfg
    jgrid, grid = _jgrid(), _grid()
    assert grid.platform == jgrid.platform == "cpu"
    assert cfg.resolve_base_n(grid) == jcfg.resolve_base_n(jgrid) == 256
    assert cfg.resolved(grid).base_n == 256
    assert eigh.Config(base_n=64).resolved(grid).base_n == 64
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.float64, jnp.float64),
                     (torch.bfloat16, jnp.bfloat16)):
        assert cfg.resolve_cluster_rel(tdt) == jcfg.resolve_cluster_rel(jdt)
        got = dataclasses.asdict(cfg.sign_polar_cfg(tdt))
        want = dataclasses.asdict(jcfg.sign_polar_cfg(jdt))
        want["chol"]["base_policy"] = want["chol"]["base_policy"].value
        got["chol"]["base_policy"] = got["chol"]["base_policy"].value
        assert got == want
    assert eigh._split_align(grid) == jeigh._split_align(jgrid) == 128
    with pytest.raises(ValueError, match="unknown"):
        interop.eigh_config_from_dict({"base_n": 64, "bogus": 1})
    with pytest.raises(ValueError, match="unknown"):
        interop.eigh_config_from_dict({"polar": {"chol": {"bogus": 1}}})


@pytest.mark.parametrize("n", [255, 256])
def test_median_and_embed_match_jax(n):
    """The shift is jnp.median of the diagonal (the two middle values
    averaged at even n); the padding is jnp's blkdiag, bit for bit."""
    d = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    assert eigh._median(torch.from_numpy(d)) == float(jnp.median(d))
    a = np.random.default_rng(1).standard_normal((n, n)).astype(np.float32)
    got = eigh._embed(_grid(), torch.from_numpy(a), 384, 1.0).numpy()
    want = np.asarray(jeigh._embed(_jgrid(), jnp.asarray(a), 384, 1.0))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["separated", "unaligned", "clustered"])
def test_eigh_matches_jax(name):
    """Eigenpairs and the top-level (sigma, k), both packages."""
    a = _operand(name)
    w_j, v_j, seen_j = _jax_eigh(name)
    w, v, seen, used = _port_eigh(name)
    s_j, k_j, n_j = _top(seen_j)
    s, k, n = _top(seen)
    assert (k, n) == (k_j, n_j), (seen, seen_j)
    assert abs(s - s_j) <= SIGMA_TOL * np.linalg.norm(a), (s, s_j)
    _check_pairs(a, w, v, w_j, v_j, separated=CASES[name][2])


def test_eigh_cluster_early_out_matches_jax():
    """sigma I + 1e-9 noise: no sign at all; values = the diagonal and
    vectors = I in both packages."""
    w_j, v_j, seen_j = _jax_eigh("early_out")
    w, v, seen, _ = _port_eigh("early_out")
    assert seen == seen_j == []
    np.testing.assert_array_equal(v, np.eye(256, dtype=np.float32))
    assert np.max(np.abs(w.astype(np.float64) - w_j)) <= 1e-6
    np.testing.assert_allclose(w, 2.5, atol=1e-5)


def test_eigh_is_repeatable_and_keeps_a():
    """Two calls agree bit for bit (the generator is seeded from
    cfg.seed); A is left as it was; another seed takes another basis."""
    a = torch.from_numpy(_operand("separated").astype(np.float32))
    before = a.clone()
    cfg = _cfg(128)
    w1, v1 = eigh.eigh(_grid(), a, cfg)
    w2, v2 = eigh.eigh(_grid(), a, cfg)
    assert torch.equal(a, before)
    assert torch.equal(w1, w2) and torch.equal(v1, v2)
    assert eigh._split(7, 4) == eigh._split(7, 4)
    assert eigh._split(7, 4) != eigh._split(8, 4)
    with pytest.raises(ValueError, match="square"):
        eigh.eigh(_grid(), torch.zeros(8, 4))


@functools.lru_cache(maxsize=None)
def _jax_count_and_sigma():
    a = _operand("separated")
    w_true = np.linalg.eigvalsh(a)
    sigma = float(0.5 * (w_true[200] + w_true[201]))
    with jax.default_matmul_precision("highest"):
        got = jeigh.count_above(_jgrid(), jnp.asarray(a.astype(np.float32)),
                                sigma, _jcfg(128))
    return sigma, got


def test_count_above_and_eigvalsh_match_jax():
    """count_above between two separated eigenvalues is exact in both;
    eigvalsh equals the JAX package's eigenvalues (its eigh's: the
    correction that eigvalsh skips moves vectors only)."""
    a = _operand("separated")
    sigma, got_j = _jax_count_and_sigma()
    t = torch.from_numpy(a.astype(np.float32))
    with default_matmul_precision("highest"):
        got = eigh.count_above(_grid(), t, sigma, _cfg(128))
        w = eigh.eigvalsh(_grid(), t, _cfg(128))
    assert got == got_j == 256 - 201
    w_j = _jax_eigh("separated")[0]
    assert np.max(np.abs(w.numpy().astype(np.float64) - w_j)) \
        <= W_TOL * np.linalg.norm(a)


@functools.lru_cache(maxsize=None)
def _gen_operands():
    """B SPD (cond 4) and A = R^T C R with B = R^T R and C the separated
    operand, so A x = lambda B x has C's eigenvalues, linspace(-1, 1)."""
    n = 256
    rng = np.random.default_rng(9)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    b = (q * np.linspace(0.5, 2.0, n)) @ q.T
    r = np.linalg.cholesky(b).T
    a = r.T @ _operand("separated") @ r
    return (a + a.T) / 2, b


@functools.lru_cache(maxsize=None)
def _jax_gen():
    a, b = (jnp.asarray(x.astype(np.float32)) for x in _gen_operands())
    with jax.default_matmul_precision("highest"):
        w, x = jeigh.eigh_gen(_jgrid(), a, b, _jcfg(128))
    return np.asarray(w), np.asarray(x)


def test_eigh_gen_matches_jax():
    """A x = lambda B x: eigenvalues against the JAX package's and the
    exact ones (within 10 W_TOL * max |w|); each package's X
    B-orthonormal and its generalized residual small."""
    a, b = _gen_operands()
    w_j, x_j = _jax_gen()
    ta, tb = (torch.from_numpy(x.astype(np.float32)) for x in (a, b))
    with default_matmul_precision("highest"):
        w, x = eigh.eigh_gen(_grid(), ta, tb, _cfg(128))
    w, x = w.numpy().astype(np.float64), x.numpy().astype(np.float64)
    w_true = np.linspace(-1.0, 1.0, 256)
    for got in (w, w_j):
        assert np.max(np.abs(got - w_true)) <= W_TOL * 10
    assert np.max(np.abs(w - w_j)) <= W_TOL * 10
    for ww, xx in ((w, x), (w_j, np.asarray(x_j, np.float64))):
        btb = xx.T @ b @ xx
        assert np.linalg.norm(btb - np.eye(256)) / 16 < ERR_TOL
        res = np.linalg.norm(a @ xx - (b @ xx) * ww) / np.linalg.norm(a)
        assert res < ERR_TOL
    with pytest.raises(ValueError, match="same-shape"):
        eigh.eigh_gen(_grid(), ta, tb[:128, :128])


# eigh_partial cases: (operand, k, which, extra config)
PARTIAL = {
    "top": ("separated", 16, "top", {}),
    "bottom": ("separated", 16, "bottom", {}),
    "k_eq_n": ("separated", 256, "top", {}),
    "k_beyond_half": ("separated", 200, "top", {}),
    # one device divides every n; the JAX test's indivisible n (302 on 8
    # devices) is here an n that is no multiple of the 128 alignment
    "unaligned": ("unaligned", 12, "top", {}),
    "bf16_probes": ("separated", 16, "top", {"probe_dtype": "bfloat16"}),
}


@functools.lru_cache(maxsize=None)
def _jax_partial(case):
    name, k, which, kw = PARTIAL[case]
    a = jnp.asarray(_operand(name).astype(np.float32))
    with jax.default_matmul_precision("highest"):
        w, x = jeigh.eigh_partial(_jgrid(), a, k,
                                  _jcfg(_base_n(name), **kw), which=which)
    return np.asarray(w), np.asarray(x)


@pytest.mark.parametrize("case", list(PARTIAL))
def test_eigh_partial_matches_jax(case):
    """The k extremal eigenpairs: values against the JAX package's (and
    numpy's), each package's residual and orthogonality."""
    name, k, which, kw = PARTIAL[case]
    a = _operand(name)
    w_j, x_j = _jax_partial(case)
    with default_matmul_precision("highest"):
        w, x = eigh.eigh_partial(_grid(), torch.from_numpy(
            a.astype(np.float32)), k, _cfg(_base_n(name), **kw),
            which=which)
    assert tuple(w.shape) == (k,) and tuple(x.shape) == (a.shape[0], k)
    w_true = np.linalg.eigvalsh(a)
    w_true = w_true[-k:] if which == "top" else w_true[:k]
    scale = np.linalg.norm(a)
    w = w.numpy().astype(np.float64)
    assert np.max(np.abs(w - w_j)) <= 3 * W_TOL * scale
    assert np.max(np.abs(w - w_true)) <= 3 * W_TOL * scale
    for e, e_j in zip(_errors(a, w, x.numpy()), _errors(a, w_j, x_j)):
        assert max(e, e_j) < ERR_TOL, (e, e_j)


def test_eigh_partial_rejects_bad_arguments():
    t = torch.from_numpy(_operand("separated").astype(np.float32))
    with pytest.raises(ValueError, match="1 <= k"):
        eigh.eigh_partial(_grid(), t, 0)
    with pytest.raises(ValueError, match="which"):
        eigh.eigh_partial(_grid(), t, 4, which="middle")
    with pytest.raises(ValueError, match="square"):
        eigh.eigh_partial(_grid(), t[:, :8], 4)


@pytest.mark.parametrize("chunks", [1, 4])
def test_eig_residual_matches_hand_written_and_jax(chunks):
    """validate.eig_residual against ||A V - V diag(w)||_F / ||A||_F
    written out in f64 and against the JAX package's validator."""
    rng = np.random.default_rng(5)
    a = _operand("separated").astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    v = rng.standard_normal((256, 32)).astype(np.float32)
    a64, w64, v64 = (x.astype(np.float64) for x in (a, w, v))
    want = np.linalg.norm(a64 @ v64 - v64 * w64) / np.linalg.norm(a64)
    with default_matmul_precision("highest"):
        got = float(validate.eig_residual(_grid(), torch.from_numpy(a),
                                          torch.from_numpy(w),
                                          torch.from_numpy(v), chunks))
    with jax.default_matmul_precision("highest"):
        got_j = float(jvalidate.eig_residual(_jgrid(), jnp.asarray(a),
                                             jnp.asarray(w), jnp.asarray(v),
                                             chunks))
    assert abs(got - want) <= 1e-6 * want
    assert abs(got - got_j) <= 1e-6 * want


def test_eigh_kernels_route_matches_jax_interpret():
    """n = 256, base 128, through the kernels' route in both packages
    (the JAX package's Pallas SYRK, TRMM and Cholesky leaf in interpret
    mode; the port's kernels as their plain versions): no plain fallback
    in the port's run."""
    a = _operand("separated")
    w_j, v_j, seen_j = _jax_eigh("separated", route="tri")
    w, v, seen, used = _port_eigh("separated", route="tri")
    assert _top(seen)[1:] == _top(seen_j)[1:]
    assert (used["trmm_dot"], used["syrk_dot"], used["chol_xla"]) == (
        0, 0, 0), used
    _check_pairs(a, w, v, w_j, v_j, separated=True)
