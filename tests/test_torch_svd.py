"""The port's QDWH-SVD (capital_tpu_torch/algs/svd.py) and the spectral
entry points of linalg.py (pinv, cond, funm_spd, spd_sqrt, logm_spd,
powm_spd) against the JAX package's, on a one-device grid, from the same
numpy operands and config, at 'highest'.

The eigensolver's splitting Gaussians differ between the packages, so
singular vectors are compared by what holds for any right answer:
  * singular values agree with the JAX package's within S_TOL * s_max;
  * each package's ||U^T U - I||_F / sqrt(n), ||V^T V - I||_F / sqrt(n)
    and ||U diag(s) V^T - A||_F / ||A||_F, in f64 with numpy, lie below
    ERR_TOL;
  * every right singular vector agrees with the JAX package's, column by
    column after fixing its sign, within V_TOL * s_max over its gap.
The funm_spd family agrees with the JAX package's to relative Frobenius
TOL. pinv and cond move with the operand's conditioning (a first-order
perturbation of A by f32 rounding moves A^+ by up to cond(A) times as
much), so each package's result is held to the f64 one, and the two to
each other, within COND_TOL * cond(A). Each JAX reference is computed
once per module (lru_cache).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu import linalg as jlinalg
from capital_tpu.algs import cholinv as jcholinv
from capital_tpu.algs import eigh as jeigh
from capital_tpu.algs import polar as jpolar
from capital_tpu.algs import svd as jsvd
from capital_tpu.grid import Grid as JGrid
from capital_tpu_torch import Grid, interop, linalg
from capital_tpu_torch.algs import svd
from capital_tpu_torch.ops.precision import default_matmul_precision
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(90, setup=120)

torch.set_num_threads(1)

S_TOL = 1e-6        # singular values against the JAX package's, times s_max
ERR_TOL = 1e-5      # orthogonality and reconstruction of each package, f64
V_TOL = 1e-6        # a right singular vector, times its gap over s_max
TOL = 1e-5          # the funm_spd family against the JAX package's
COND_TOL = 4 * float(np.finfo(np.float32).eps)  # pinv, cond: times cond(A)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("CAPITAL_TRMM_METHOD", "CAPITAL_SYRK_METHOD",
                "CAPITAL_CHOL_METHOD", "CAPITAL_EIGH_DEBUG"):
        monkeypatch.delenv(var, raising=False)


def _factored(m, n, s, seed=0):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (u * np.asarray(s)) @ v.T


# name -> (m, n, singular values, seed, layout)
OPERANDS = {
    "square": (128, 128, np.geomspace(1.0, 1e-2, 128), 0, "2d"),
    # the eigensolver splits H: n > base_n
    "wide_spectrum": (256, 256, np.linspace(3.0, 0.5, 256), 1, "2d"),
    "tall": (512, 128, np.geomspace(2.0, 1e-2, 128), 2, "1d"),
}


@functools.lru_cache(maxsize=None)
def _operand(name):
    m, n, s, seed, _ = OPERANDS[name]
    return _factored(m, n, s, seed).astype(np.float32)


def _jcfg():
    chol = jcholinv.Config(base_method="xla")
    return jsvd.Config(
        polar=jpolar.Config(chol=chol),
        eig=jeigh.Config(base_n=128,
                         polar=jpolar.Config(compute_h=False, chol=chol)))


def _cfg():
    return interop.svd_config_from_dict(dataclasses.asdict(_jcfg()))


def _jgrid():
    return JGrid.square(c=1, d=1, devices=jax.devices("cpu")[:1])


def _grid():
    return Grid.square(device="cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@functools.lru_cache(maxsize=None)
def _jax_svd(name):
    layout = OPERANDS[name][4]
    with jax.default_matmul_precision("highest"):
        out = jsvd.svd(_jgrid(), jnp.asarray(_operand(name)), _jcfg(),
                       layout=layout)
    return tuple(np.asarray(o) for o in out)


def _errors(a, u, s, v):
    """(U orthogonality, V orthogonality, reconstruction) in f64."""
    a = np.asarray(a, np.float64)
    u, s, v = (np.asarray(x, np.float64) for x in (u, s, v))
    k = u.shape[1]
    ou = np.linalg.norm(u.T @ u - np.eye(k)) / np.sqrt(k)
    ov = np.linalg.norm(v.T @ v - np.eye(k)) / np.sqrt(k)
    rec = np.linalg.norm((u * s) @ v.T - a) / np.linalg.norm(a)
    return ou, ov, rec


def _columns_agree(s_true, v, v_j):
    """Largest ||v_i - sign * v_j,i|| * gap_i / s_max over the columns."""
    v, v_j = np.asarray(v, np.float64), np.asarray(v_j, np.float64)
    gap = np.minimum(np.abs(np.diff(s_true, prepend=np.inf)),
                     np.abs(np.diff(s_true, append=-np.inf)))
    sign = np.sign(np.sum(v * v_j, axis=0))
    return float(np.max(np.linalg.norm(v * sign - v_j, axis=0) * gap)
                 / s_true[0])


def test_config_matches_jax():
    assert interop.svd_config_from_dict(
        dataclasses.asdict(jsvd.Config())) == svd.Config()
    assert _cfg().eig.base_n == 128 and not _cfg().eig.polar.compute_h
    with pytest.raises(ValueError, match="unknown"):
        interop.svd_config_from_dict({"eig": {"bogus": 1}})


@pytest.mark.parametrize("name", list(OPERANDS))
def test_svd_matches_jax(name):
    """Square '2d', a wide spectrum '2d' (H's eigenproblem splits) and
    tall-skinny '1d'."""
    a = _operand(name)
    layout = OPERANDS[name][4]
    u_j, s_j, v_j = _jax_svd(name)
    with default_matmul_precision("highest"):
        u, s, v = svd.svd(_grid(), _t(a), _cfg(), layout=layout)
    u, s, v = u.numpy(), s.numpy(), v.numpy()
    m, n = a.shape
    assert u.shape == (m, n) and s.shape == (n,) and v.shape == (n, n)
    s_true = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    assert np.all(np.diff(s.astype(np.float64)) <= 0) and np.all(s >= 0)
    ds = np.max(np.abs(s.astype(np.float64) - s_j)) / s_true[0]
    assert ds <= S_TOL, ds
    assert np.max(np.abs(s - s_true)) <= S_TOL * 10 * s_true[0]
    for e, e_j in zip(_errors(a, u, s, v), _errors(a, u_j, s_j, v_j)):
        assert max(e, e_j) < ERR_TOL, (e, e_j)
    dv = _columns_agree(s_true, v, v_j)
    assert dv <= V_TOL, dv


def test_singular_values_match_jax():
    a = _operand("tall")
    with jax.default_matmul_precision("highest"):
        s_j = np.asarray(jsvd.singular_values(_jgrid(), jnp.asarray(a),
                                              _jcfg(), layout="1d"))
    with default_matmul_precision("highest"):
        s = svd.singular_values(_grid(), _t(a), _cfg(), layout="1d").numpy()
    assert s.shape == (128,)
    s_true = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    assert np.max(np.abs(s.astype(np.float64) - s_j)) <= S_TOL * s_true[0]
    assert np.max(np.abs(s - s_true)) <= S_TOL * 10 * s_true[0]


@functools.lru_cache(maxsize=None)
def _jax_svd_partial(k):
    with jax.default_matmul_precision("highest"):
        out = jsvd.svd_partial(_jgrid(), jnp.asarray(
            _operand("wide_spectrum")), k, _jcfg(), layout="2d")
    return tuple(np.asarray(o) for o in out)


def test_svd_partial_matches_jax():
    """Top 16 of the wide spectrum (H's partial solve runs its probes):
    values against the JAX package's and numpy's, each package's
    subspace residual ||A V - U s|| / ||A|| and orthonormal columns."""
    a, k = _operand("wide_spectrum"), 16
    u_j, s_j, v_j = _jax_svd_partial(k)
    with default_matmul_precision("highest"):
        u, s, v = svd.svd_partial(_grid(), _t(a), k, _cfg(), layout="2d")
    u, s, v = u.numpy(), s.numpy(), v.numpy()
    assert u.shape == (256, k) and s.shape == (k,) and v.shape == (256, k)
    s_true = np.linalg.svd(a.astype(np.float64), compute_uv=False)[:k]
    assert np.max(np.abs(s.astype(np.float64) - s_j)) <= 3 * S_TOL * s_true[0]
    assert np.max(np.abs(s - s_true)) <= 3 * S_TOL * s_true[0]
    a64 = a.astype(np.float64)
    for uu, ss, vv in ((u, s, v), (u_j, s_j, v_j)):
        uu, ss, vv = (np.asarray(x, np.float64) for x in (uu, ss, vv))
        res = np.linalg.norm(a64 @ vv - uu * ss) / np.linalg.norm(a64)
        assert res < ERR_TOL, res
        for q in (uu, vv):
            assert np.linalg.norm(q.T @ q - np.eye(k)) / np.sqrt(k) < ERR_TOL


def test_svd_rejects_wide():
    wide = torch.zeros(4, 8)
    for fn, args in ((svd.svd, ()), (svd.svd_partial, (2,))):
        with pytest.raises(ValueError, match="m >= n"):
            fn(_grid(), wide, *args)
    with pytest.raises(ValueError, match="1 <= k"):
        svd.svd_partial(_grid(), torch.zeros(8, 4), 5)


@functools.lru_cache(maxsize=None)
def _linalg_operands():
    rng = np.random.default_rng(11)
    q, _ = np.linalg.qr(rng.standard_normal((128, 128)))
    spd = (q * np.linspace(0.5, 4.0, 128)) @ q.T
    general = _factored(128, 128, np.geomspace(1.0, 1e-2, 128), seed=12)
    return spd.astype(np.float32), general.astype(np.float32)


# name -> (linalg function, operand, extra arguments); default configs
LINALG = {
    "pinv_square": ("pinv", "general", {}),
    "pinv_tall": ("pinv", "tall", {"layout": "1d"}),
    "cond": ("cond", "general", {}),
    "funm_spd": ("funm_spd", "spd", {"fn": "exp"}),
    "spd_sqrt": ("spd_sqrt", "spd", {}),
    "spd_sqrt_inverse": ("spd_sqrt", "spd", {"inverse": True}),
    "logm_spd": ("logm_spd", "spd", {}),
    "powm_spd": ("powm_spd", "spd", {"p": -0.75}),
}


def _linalg_args(case, exp):
    fn, which, kw = LINALG[case]
    spd, general = _linalg_operands()
    a = {"spd": spd, "general": general, "tall": _operand("tall")}[which]
    kw = dict(kw)
    if "fn" in kw:
        kw["fn"] = exp
    return fn, a, kw


@functools.lru_cache(maxsize=None)
def _jax_linalg(case):
    fn, a, kw = _linalg_args(case, jnp.exp)
    with jax.default_matmul_precision("highest"):
        return np.asarray(getattr(jlinalg, fn)(_jgrid(), jnp.asarray(a),
                                               **kw))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("case", list(LINALG))
def test_spectral_linalg_matches_jax(case):
    """pinv (square and tall), cond and the funm_spd family, default
    configs (eigh's base_n 256 on the CPU: these n = 128 operands are
    base-case blocks), against the JAX package's."""
    fn, a, kw = _linalg_args(case, torch.exp)
    want = _jax_linalg(case)
    with default_matmul_precision("highest"):
        got = getattr(linalg, fn)(_grid(), _t(a), **kw).numpy()
    assert got.shape == want.shape
    if fn in ("pinv", "cond"):
        a64 = a.astype(np.float64)
        true = np.linalg.pinv(a64) if fn == "pinv" else np.linalg.cond(a64)
        tol = COND_TOL * np.linalg.cond(a64)
        for err in (_rel(got, want), _rel(got, true), _rel(want, true)):
            assert err < tol, (err, tol)
        return
    assert _rel(got, want) < TOL, _rel(got, want)
    assert np.array_equal(got, got.T)  # symmetrized exactly


@pytest.mark.parametrize("op", ["eigh", "partial", "svd", "svd_partial"])
def test_bench_eigh_runs_each_op_on_the_cpu(op):
    """bench.eigh end to end at a small size: its f64 residual and
    orthogonality and the library comparison are reported."""
    from capital_tpu_torch.bench import eigh as beigh

    rec = beigh.main(["--device", "cpu", "--op", op, "--n", "256", "--m",
                      "384", "--k", "8", "--base-n", "128", "--num-iter",
                      "1", "--json"])
    assert rec["residual"] < ERR_TOL and rec["orthogonality"] < ERR_TOL
    assert rec["library_ms"] > 0 and rec["device"] == "cpu"
