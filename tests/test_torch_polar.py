"""The port's QDWH polar decomposition (capital_tpu_torch/algs/polar.py)
against the JAX package's, on a one-device grid, from the same numpy
operand and config.

The schedule (qdwh_weights) is pure Python in both and must agree float
for float; _gram_eps must agree at every precision level. U and H agree
to relative Frobenius 1e-5 at 'highest', both layouts, square and tall,
with and without H. Both packages' orthogonality ||U^T U - I||_F / sqrt(n)
and reconstruction ||U H - A||_F / ||A||_F, taken in f64 with numpy, lie
within 2x of each other and below 1e-5. One shape runs the kernels'
route in both packages (CAPITAL_TRMM_METHOD=tri, CAPITAL_SYRK_METHOD=tri,
CAPITAL_CHOL_METHOD=pallas; the JAX package's Pallas kernels in
interpret mode, the port's kernels as their plain versions).
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

from capital_tpu import linalg as jlinalg
from capital_tpu.algs import polar as jpolar
from capital_tpu.grid import Grid as JGrid
from capital_tpu.ops import pallas_chol, pallas_syrk, pallas_trmm
from capital_tpu_torch import Grid, interop, linalg
from capital_tpu_torch.algs import polar
from capital_tpu_torch.ops import counters, reset_counters
from capital_tpu_torch.ops.precision import default_matmul_precision
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(60, setup=120)

torch.set_num_threads(1)

ENV = ("CAPITAL_TRMM_METHOD", "CAPITAL_SYRK_METHOD", "CAPITAL_CHOL_METHOD")
KERNEL_ENV = {"CAPITAL_TRMM_METHOD": "tri", "CAPITAL_SYRK_METHOD": "tri",
              "CAPITAL_CHOL_METHOD": "pallas"}
TOL = 1e-5          # U and H against the JAX package's, at 'highest'
ERR_TOL = 1e-5      # orthogonality and reconstruction of each package
ERR_RATIO = 2.0     # the two packages' figures lie within this factor


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


@functools.lru_cache(maxsize=None)
def _controlled(m, n, cond, seed=0):
    """A = U diag(s) V^T with condition number `cond`, f32."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.geomspace(1.0, 1.0 / cond, n)
    return ((u * s) @ v.T).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _errors(a, u, h):
    """(orthogonality, reconstruction) in f64."""
    a, u = np.asarray(a, np.float64), np.asarray(u, np.float64)
    n = u.shape[1]
    orth = np.linalg.norm(u.T @ u - np.eye(n)) / np.sqrt(n)
    if h is None:
        return orth, None
    rec = np.linalg.norm(u @ np.asarray(h, np.float64) - a) / np.linalg.norm(a)
    return orth, rec


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


def _jgrid():
    return JGrid.square(c=1, d=1, devices=jax.devices("cpu")[:1])


def _jcfg(compute_h=True, min_bc=512):
    return jpolar.Config(compute_h=compute_h,
                         chol=jpolar._cholinv.Config(min_bc=min_bc))


@functools.lru_cache(maxsize=None)
def _jax_polar(m, n, cond, layout, compute_h, route="dot"):
    grid = _jgrid()
    cfg = _jcfg(compute_h)
    a = jnp.asarray(_controlled(m, n, cond))
    with _route(route), jax.default_matmul_precision("highest"):
        out = jax.jit(lambda x: jpolar.polar(grid, x, cfg,
                                             layout=layout))(a)
    return tuple(np.asarray(o) for o in out) if compute_h else (
        np.asarray(out), None)


def _port_polar(m, n, cond, layout, compute_h, route="dot"):
    grid = Grid.square(device="cpu")
    cfg = interop.polar_config_from_dict(
        dataclasses.asdict(_jcfg(compute_h)))
    a = torch.from_numpy(_controlled(m, n, cond))
    with _route(route), default_matmul_precision("highest"):
        reset_counters()
        out = polar.polar(grid, a, cfg, layout=layout)
        used = counters()
    if compute_h:
        return out[0].numpy(), out[1].numpy(), used
    return out.numpy(), None, used


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("l0", [1e-3, 1e-5, 1e-12])
def test_qdwh_weights_equal_jax_float_for_float(l0, dtype):
    want = jpolar.qdwh_weights(l0, getattr(jnp, dtype))
    got = polar.qdwh_weights(l0, getattr(torch, dtype))
    assert got == want
    assert (polar.qdwh_weights(l0, getattr(torch, dtype), max_iter=3)
            == jpolar.qdwh_weights(l0, getattr(jnp, dtype), max_iter=3))


@pytest.mark.parametrize("level", [None, "highest", "high", "default"])
def test_gram_eps_matches_jax_at_each_level(level):
    ctx_j = (jax.default_matmul_precision(level) if level
             else contextlib.nullcontext())
    ctx_t = (default_matmul_precision(level) if level
             else contextlib.nullcontext())
    with ctx_j:
        want = [jpolar._gram_eps(d) for d in (jnp.float32, jnp.float64,
                                             jnp.bfloat16)]
    with ctx_t:
        got = [polar._gram_eps(d) for d in (torch.float32, torch.float64,
                                           torch.bfloat16)]
    assert got == want


def test_config_defaults_and_l0():
    cfg = polar.Config()
    assert interop.polar_config_from_dict(
        dataclasses.asdict(jpolar.Config())) == cfg
    assert cfg.resolve_l0(torch.float32) == jpolar.Config().resolve_l0(
        jnp.float32) == 1e-5
    assert cfg.resolve_l0(torch.float64) == 1e-12
    assert polar.Config(l0=1e-3).resolve_l0(torch.float32) == 1e-3
    with pytest.raises(ValueError, match="unknown"):
        interop.polar_config_from_dict({"l0": 1e-5, "bogus": 1})
    with pytest.raises(ValueError, match="unknown"):
        interop.polar_config_from_dict({"chol": {"bogus": 1}})


@pytest.mark.parametrize("layout", ["2d", "1d"])
@pytest.mark.parametrize("m,n,compute_h", [(128, 128, True),
                                           (512, 128, True),
                                           (512, 128, False)])
def test_polar_matches_jax(layout, m, n, compute_h):
    u_j, h_j = _jax_polar(m, n, 100.0, layout, compute_h)
    u, h, _ = _port_polar(m, n, 100.0, layout, compute_h)
    assert _rel(u, u_j) < TOL, _rel(u, u_j)
    a = _controlled(m, n, 100.0)
    errs, errs_j = _errors(a, u, h), _errors(a, u_j, h_j)
    if compute_h:
        assert _rel(h, h_j) < TOL, _rel(h, h_j)
        assert np.array_equal(h, h.T)  # symmetrized exactly
    for e, e_j in zip(errs, errs_j):
        if e is None:
            continue
        assert max(e, e_j) < ERR_TOL, (e, e_j)
        assert max(e, e_j) <= ERR_RATIO * min(e, e_j), (e, e_j)


def test_polar_kernels_route_matches_jax_interpret():
    """2d, 256 x 128: Gram, Z factor and updates through the kernels'
    route in both packages; the port's run counts no plain fallback."""
    u_j, h_j = _jax_polar(256, 128, 100.0, "2d", True, route="tri")
    u, h, used = _port_polar(256, 128, 100.0, "2d", True, route="tri")
    assert _rel(u, u_j) < TOL, _rel(u, u_j)
    assert _rel(h, h_j) < TOL, _rel(h, h_j)
    assert (used["trmm_dot"], used["syrk_dot"], used["chol_xla"]) == (
        0, 0, 0), used
    orth, rec = _errors(_controlled(256, 128, 100.0), u, h)
    assert max(orth, rec) < ERR_TOL


def test_polar_rejects_wide_and_keeps_a():
    grid = Grid.square(device="cpu")
    with pytest.raises(ValueError, match="m >= n"):
        polar.polar(grid, torch.zeros(4, 8))
    a = torch.from_numpy(_controlled(256, 128, 10.0))
    before = a.clone()
    u = polar.polar_jit(grid, a, polar.Config(compute_h=False))
    assert torch.equal(a, before)
    assert polar._resolve_layout(grid, a, "auto") == "2d"
    assert u.shape == a.shape


def _jax_nearest():
    grid = _jgrid()
    a = jnp.asarray(_controlled(128, 128, 50.0, seed=3))
    with jax.default_matmul_precision("highest"):
        q = jax.jit(lambda x: jlinalg.nearest_orthogonal(
            grid, x, layout="2d"))(a)
        p = jax.jit(lambda x: jlinalg.nearest_psd(grid, x))(a)
    return np.asarray(q), np.asarray(p)


def test_nearest_orthogonal_and_psd_match_jax():
    q_j, p_j = _jax_nearest()
    grid = Grid.square(device="cpu")
    a = torch.from_numpy(_controlled(128, 128, 50.0, seed=3))
    q = linalg.nearest_orthogonal(grid, a).numpy()
    p = linalg.nearest_psd(grid, a).numpy()
    assert _rel(q, q_j) < TOL, _rel(q, q_j)
    assert _rel(p, p_j) < TOL, _rel(p, p_j)
    assert np.array_equal(p, p.T)
    assert np.linalg.eigvalsh(p.astype(np.float64)).min() > -1e-5
