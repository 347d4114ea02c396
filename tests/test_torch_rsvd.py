"""The port's randomized SVD / PCA (capital_tpu_torch.apps.rsvd) against the
JAX package's, on a one-device grid, and against the bounds of the JAX
package's own tests (tests/test_rsvd.py).

Parity: the JAX package's test matrix Omega (jax.random.key(0x5EED)) is
patched into the port's `_omega`, so both run the same algorithm on the
same numbers. f32: s within 1e-5 relative, U diag(s) V^T within 1e-5
relative Frobenius, U and V^T column by column up to sign within 1e-4
(each column's error is rounding over its singular-value gap, >= 0.04 s_i
on this spectrum; measured 4.0e-6); PCA's variances and mean within 1e-5,
its components within 1e-4. bf16 storage: s and U diag(s) V^T within
1e-3, the columns within 1e-2 (measured 9.6e-4 for U: each package
rounds the sketch to bf16, and an element whose f32 sum differs in its
last bit may round to the other bf16 neighbour). Both packages' configs
cross through interop.rsvd_config_from_dict.

Own draws (the port's Omega, a torch.Generator seeded 0x5EED): the JAX
tests' bounds on the JAX tests' planted inputs: singular values within
5e-3 (bf16 storage 3e-2), the rank-k reconstruction within 1.5x the
optimum, ||U^T U - I||_F < 1e-5 (f64), power iterations sharpening a
slowly-decaying spectrum, PCA variances within 1e-2 of numpy's, mean
within 1e-4. The planted case runs the kernels' route (gram_kernel='tri',
CAPITAL_TRMM_METHOD=tri: the SYRK and TRMM plain versions).
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from capital_tpu.apps import rsvd as jrsvd
from capital_tpu.grid import Grid as JGrid
from capital_tpu_torch import Grid, interop
from capital_tpu_torch.algs import cacqr
from capital_tpu_torch.apps import rsvd
from capital_tpu_torch.bench import rsvd as bench_rsvd
from capital_tpu_torch.ops import counters, reset_counters
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(60, setup=120)

torch.set_num_threads(1)

ENV = ("CAPITAL_TRMM_METHOD", "CAPITAL_SYRK_METHOD", "CAPITAL_CHOL_METHOD")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


def _planted(m, n, rank, noise=1e-3, seed=0):
    """tests/test_rsvd.py's A = U diag(s) V^T + noise, s geometric in
    [1, 10]."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, rank)))
    v, _ = np.linalg.qr(rng.standard_normal((n, rank)))
    s = np.geomspace(10.0, 1.0, rank)
    a = (u * s) @ v.T + noise * rng.standard_normal((m, n))
    return np.asarray(a, np.float32), s


def _pca_data(m=2048, n=128, k=8, seed=11):
    rng = np.random.default_rng(seed)
    return np.asarray(
        rng.standard_normal((m, k)) @ rng.standard_normal((k, n))
        + 0.01 * rng.standard_normal((m, n)) + rng.standard_normal(n),
        np.float32)


def _grid():
    return Grid.square(device="cpu")


def _jgrid():
    return JGrid.square(c=1, d=1, devices=jax.devices("cpu")[:1])


def _jax_omega(n, l, device):
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.key(rsvd.OMEGA_SEED), (n, l), jnp.float32))).to(device)


def _f64(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def _rel(got, want):
    got, want = _f64(got), _f64(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _orth(u):
    u = _f64(u)
    return np.linalg.norm(u.T @ u - np.eye(u.shape[1]))


@functools.lru_cache(maxsize=None)
def _jax(op, dtype, k, oversample):
    """The JAX package's rsvd (U, s, Vt) or pca (components, variance,
    mean) on the parity inputs, jitted, as numpy."""
    grid = _jgrid()
    cfg = jrsvd.Config(k=k, oversample=oversample, power_iters=1)
    x = _pca_data() if op == "pca" else _planted(2048, 256, k)[0]
    fn = jax.jit(lambda a: getattr(jrsvd, op)(grid, a, cfg))
    return tuple(np.asarray(o.astype(jnp.float32))
                 for o in fn(jnp.asarray(x, dtype)))


def _port(op, dtype, k, oversample):
    cfg = interop.rsvd_config_from_dict(dataclasses.asdict(
        jrsvd.Config(k=k, oversample=oversample, power_iters=1)))
    x = _pca_data() if op == "pca" else _planted(2048, 256, k)[0]
    with mock.patch.object(rsvd, "_omega", _jax_omega):
        out = getattr(rsvd, op)(_grid(),
                                torch.from_numpy(x).to(getattr(torch, dtype)),
                                cfg)
    return tuple(o.float().numpy() for o in out)


def _columns_up_to_sign(got, want, axis):
    """The largest error of a singular vector (axis 0: a column, as in U;
    axis 1: a row, as in V^T) after matching its sign, relative to its
    norm."""
    got, want = _f64(got), _f64(want)
    if axis == 1:
        got, want = got.T, want.T
    sign = np.sign(np.sum(got * want, axis=0))
    err = np.linalg.norm(got * sign - want, axis=0)
    return float(np.max(err / np.linalg.norm(want, axis=0)))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-3)])
def test_rsvd_matches_jax(dtype, tol):
    k, os_ = 24, 8
    u, s, vt = _port("rsvd", dtype, k, os_)
    ju, js, jvt = _jax("rsvd", dtype, k, os_)
    assert _rel(s, js) < tol, _rel(s, js)
    assert _rel((u * s) @ vt, (ju * js) @ jvt) < tol
    col_tol = 10 * tol
    assert _columns_up_to_sign(u, ju, 0) < col_tol
    assert _columns_up_to_sign(vt, jvt, 1) < col_tol
    if dtype == "float32":  # PCA on the same route
        comps, var, mean = _port("pca", dtype, 8, 8)
        jcomps, jvar, jmean = _jax("pca", dtype, 8, 8)
        assert _rel(var, jvar) < tol
        assert _rel(mean, jmean) < tol
        assert _columns_up_to_sign(comps, jcomps, 1) < col_tol


def _own_planted():
    """test_rsvd_recovers_planted_spectrum, on the kernels' route."""
    m, n, rank = 2048, 256, 24
    a_np, s_true = _planted(m, n, rank)
    cfg = rsvd.Config(k=rank, oversample=8, power_iters=1,
                      qr=cacqr.Config(num_iter=2, gram_kernel="tri"))
    with pytest.MonkeyPatch.context() as mp:
        R.setenv(mp, CAPITAL_TRMM_METHOD="tri")
        reset_counters()
        u, s, vt = rsvd.rsvd(_grid(), torch.from_numpy(a_np), cfg)
        used = counters()
    # l = 32 is no multiple of 128: the Gram Cholesky is the library's
    # (4 = two CholeskyQR2 factors); no plain fallback for SYRK or TRMM
    assert (used["chol_xla"], used["trmm_dot"], used["gram_dot"],
            used["syrk_dot"]) == (4, 0, 0, 0), used
    np.testing.assert_allclose(s.numpy(), s_true, rtol=5e-3)
    rec = _f64(u) @ np.diag(_f64(s)) @ _f64(vt)
    rel = np.linalg.norm(a_np - rec) / np.linalg.norm(a_np)
    s_full = np.linalg.svd(a_np.astype(np.float64), compute_uv=False)
    opt = np.linalg.norm(s_full[rank:]) / np.linalg.norm(s_full)
    assert rel < 1.5 * opt + 1e-6
    assert _orth(u) < 1e-5


def _own_power_iters():
    """test_rsvd_power_iters_sharpen: q = 2 beats q = 0 on a slowly
    decaying spectrum."""
    m, n, rank = 2048, 192, 16
    rng = np.random.default_rng(3)
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = 1.0 / np.arange(1, n + 1) ** 0.5
    a = torch.from_numpy(np.asarray((u * s) @ v.T, np.float32))
    errs = {}
    for q in (0, 2):
        _, sk, _ = rsvd.rsvd(_grid(), a, rsvd.Config(k=rank, oversample=6,
                                                     power_iters=q))
        errs[q] = np.abs(sk.numpy() - s[:rank]).max()
    assert errs[2] < errs[0]


def _own_bf16():
    """test_rsvd_bf16_storage: f32 factors, bf16-class accuracy."""
    a_np, s_true = _planted(2048, 256, 16, noise=1e-3, seed=5)
    u, s, vt = rsvd.rsvd(_grid(), torch.from_numpy(a_np).bfloat16(),
                         rsvd.Config(k=16, oversample=8))
    assert u.dtype == s.dtype == vt.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), s_true, rtol=3e-2)


def _own_pca():
    """test_pca_matches_numpy."""
    m, k = 2048, 8
    a_np = _pca_data(m, 128, k)
    comps, var, mean = rsvd.pca(_grid(), torch.from_numpy(a_np),
                                rsvd.Config(k=k, oversample=8,
                                            power_iters=1))
    c = a_np - a_np.mean(0)
    s_full = np.linalg.svd(c.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(var.numpy(), s_full[:k] ** 2 / (m - 1),
                               rtol=1e-2)
    np.testing.assert_allclose(mean.numpy(), a_np.mean(0), atol=1e-4)
    cc = _f64(comps)
    assert np.linalg.norm(cc @ cc.T - np.eye(k)) < 1e-5


@pytest.mark.parametrize("case", ["planted", "power_iters", "bf16", "pca"])
def test_rsvd_own_draw_meets_the_jax_tests_bounds(case):
    {"planted": _own_planted, "power_iters": _own_power_iters,
     "bf16": _own_bf16, "pca": _own_pca}[case]()


def test_bench_rsvd():
    """bench.rsvd on the CPU at a small size: its planted values
    recovered, its subspace residual at f32 level, its flop count and the
    library ratio reported."""
    m, n, k, os_ = 4096, 256, 24, 8
    rec = bench_rsvd.main(["--device", "cpu", "--m", str(m), "--n", str(n),
                           "--k", str(k), "--oversample", str(os_),
                           "--num-iter", "1", "--json"])
    l = k + os_
    flops = 2.0 * m * n * l * 4 + 2 * 8.0 * m * l * l
    assert rec["sv_rel_err"] < 5e-3
    assert rec["subspace_residual"] < 1e-4
    want = flops / (min(rec["ms"]) / 1e3) / 1e9
    assert abs(rec["gflops"] - want) <= 0.01 + 1e-6 * want
    assert rec["library_ms"] > 0 and rec["vs_library"] > 0
    with pytest.raises(ValueError, match="exceeds"):
        rsvd.rsvd(_grid(), torch.zeros(64, 8), rsvd.Config(k=9))
    # a CPU operand on a CUDA grid would run the plain versions on the CPU
    with pytest.raises(ValueError, match="grid on cuda:0"):
        rsvd.rsvd(Grid(device=torch.device("cuda", 0)), torch.zeros(64, 8))
