"""Triangular inverse and triangular solve: capital_tpu_torch's rectri and
trsm against the JAX package's on a one-device grid, from the same numpy
operands. Relative Frobenius 1e-5: both run the same block schedule, and
the operands are well conditioned (triangles of a diagonally dominant
matrix, and the packed LU workspace of one), so the gap is f32 rounding
in another summation order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.algs import lu as jlu
from capital_tpu.algs import rectri as jrectri
from capital_tpu.algs import trsm as jtrsm
from capital_tpu.grid import Grid as JGrid
from capital_tpu_torch import Grid, tracing
from capital_tpu_torch.algs import rectri, trsm

torch.set_num_threads(1)

N = 256


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("CAPITAL_LU_PANEL", "CAPITAL_LU_LEAF", "CAPITAL_LU_IB",
                "CAPITAL_LU_WIDE_LEAF", "CAPITAL_LU_SCHUR_MB",
                "CAPITAL_LU_LOOKAHEAD"):
        monkeypatch.delenv(var, raising=False)


def _grids():
    return (JGrid.square(c=1, d=1, devices=jax.devices("cpu")[:1]),
            Grid.square(device="cpu"))


def _dominant(n, seed):
    u = np.random.default_rng(seed).uniform(-0.5, 0.5, (n, n))
    return ((u + u.T) / 2 + n * np.eye(n)).astype(np.float32)


def _rhs(rows, cols, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (rows, cols)).astype(
        np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("lower", [True, False])
def test_rectri_matches_jax(lower):
    jg, g = _grids()
    t = np.tril(_dominant(N, 2)) if lower else np.triu(_dominant(N, 2))
    jcfg = jrectri.Config(min_bc=64, base_method="xla")
    cfg = rectri.Config(min_bc=64, base_method="xla")
    want = np.asarray(jax.jit(lambda x: jrectri.invert(
        jg, x, lower=lower, cfg=jcfg))(jnp.asarray(t)))
    with tracing.trace() as tr:
        got = rectri.invert(g, torch.from_numpy(t), lower=lower, cfg=cfg)
    assert _rel(got.numpy(), want) <= 1e-5
    err = np.linalg.norm(t.astype(np.float64) @ got.double().numpy()
                         - np.eye(N)) / np.sqrt(N)
    assert err < 1e-5
    off = np.triu(got.numpy(), 1) if lower else np.tril(got.numpy(), -1)
    assert not off.any()
    phases = {k.split("/")[0] for k in tr.by_phase}
    assert {"RT::base", "RT::combine"} <= phases


@functools.lru_cache(maxsize=None)
def _packed_lu():
    """The JAX package's packed LU workspace of a diagonally dominant
    nonsymmetric matrix: L strict-lower, U on and above the diagonal."""
    jg, _ = _grids()
    a = _dominant(N, 9) + np.triu(_rhs(N, N, 10), 1)
    w, _, _ = jax.jit(lambda x: jlu.factor(jg, x, jlu.Config(nb=64)))(
        jnp.asarray(a))
    return np.array(w)


CASES = {
    "lower": dict(side="L", lower=True, unit_diag=False, m=128),
    "upper": dict(side="L", lower=False, unit_diag=False, m=128),
    "right_lower": dict(side="R", lower=True, unit_diag=False, m=96),
    "right_upper": dict(side="R", lower=False, unit_diag=False, m=96),
    "one_column": dict(side="L", lower=True, unit_diag=False, m=1),
    "packed_lu_unit_lower": dict(side="L", lower=True, unit_diag=True, m=8),
    "packed_lu_upper": dict(side="L", lower=False, unit_diag=False, m=8),
}


@pytest.mark.parametrize("name", list(CASES))
def test_trsm_matches_jax(name):
    c = CASES[name]
    jg, g = _grids()
    if name.startswith("packed_lu"):
        a = _packed_lu()
    else:
        a = _dominant(N, 3)
        a = np.tril(a) if c["lower"] else np.triu(a)
    shape = (N, c["m"]) if c["side"] == "L" else (c["m"], N)
    b = _rhs(*shape, 4)
    jcfg = jtrsm.Config(nb=64, tri=jrectri.Config(min_bc=64,
                                                  base_method="xla"))
    cfg = trsm.Config(nb=64, tri=rectri.Config(min_bc=64, base_method="xla"))
    kw = dict(side=c["side"], lower=c["lower"], unit_diag=c["unit_diag"])
    want = np.asarray(jax.jit(lambda x, y: jtrsm.solve(
        jg, x, y, cfg=jcfg, **kw))(jnp.asarray(a), jnp.asarray(b)))
    got = trsm.solve(g, torch.from_numpy(a.copy()), torch.from_numpy(b),
                     cfg=cfg, **kw)
    assert got.shape == want.shape == shape
    assert _rel(got.numpy(), want) <= 1e-5
    # and it solves the system it was given
    t = a.astype(np.float64)
    if c["unit_diag"]:
        t = np.tril(t, -1) + np.eye(N)
    else:
        t = np.tril(t) if c["lower"] else np.triu(t)
    x = got.double().numpy()
    r = t @ x - b if c["side"] == "L" else x @ t - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-5


def test_trsm_cost_record_matches_jax():
    """The substitution's cost record (trsm.substitute) and the rectri
    phases are the JAX package's; JAX additionally records the two gemms
    of its traced scan body once, which the port's loop does not."""
    from capital_tpu import tracing as jtracing

    jg, g = _grids()
    a = np.tril(_dominant(N, 3))
    b = _rhs(N, 16, 4)
    jcfg = jtrsm.Config(nb=64, tri=jrectri.Config(min_bc=64))
    cfg = trsm.Config(nb=64, tri=rectri.Config(min_bc=64))
    with jtracing.trace() as jt:
        jax.eval_shape(lambda x, y: jtrsm.solve(jg, x, y, cfg=jcfg),
                       jnp.asarray(a), jnp.asarray(b))
    with tracing.trace() as t:
        trsm.solve(g, torch.from_numpy(a), torch.from_numpy(b), cfg=cfg)
    want = {k: (v.flops, v.comm_bytes, v.msgs, v.calls)
            for k, v in jt.by_phase.items()
            if k != "<total>" and not k.startswith("TRSM::substitute/")}
    got = {k: (v.flops, v.comm_bytes, v.msgs, v.calls)
           for k, v in t.by_phase.items() if k != "<total>"}
    assert got == want
