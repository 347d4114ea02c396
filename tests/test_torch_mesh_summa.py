"""The port's SUMMA engines across ranks against the JAX package's on its
8 virtual CPU devices: one 8-rank gloo world (tests/torch_mesh_ranks.py)
runs every case on the 2 x 2 x 2 grid and on its flat 2 x 2 view, from
the same numpy operands the JAX package's shard_map engines take on
grid222. Products agree to relative Frobenius 1e-5 (f32 products at the
framework default 'highest' in both; the sums' order differs); a
transpose is exact; the analytic per-rank costs equal the JAX package's
per-device records. Also: 'shard_map' is the default impl wherever it is
in the JAX package."""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as R
from capital_tpu import tracing as jtracing
from capital_tpu import validate as jvalidate
from capital_tpu.parallel import summa as jsumma
from capital_tpu_torch import validate
from capital_tpu_torch.parallel import summa
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(60, setup=180)

TOL = 1e-5


@pytest.fixture(scope="module")
def port():
    return R.world(R.summa_world)


@pytest.fixture(scope="module")
def grids(grid222):
    return {"222": grid222, "flat": grid222.view(z=None, y="y", x="x")}


def _put(grid, x):
    return jax.device_put(jnp.asarray(x), grid.sharding(grid.slice_spec))


def _j(name, g, *arrays, **kw):
    """jsumma.<name>(g, *arrays, **kw), jitted (an eager shard_map
    compiles each call; the trace records the costs once, as an eager
    call does)."""
    return jax.jit(functools.partial(getattr(jsumma, name), g, **kw))(
        *arrays)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_gemm_every_engine_and_knob_matches_jax(port, grids):
    a, b = R.operand(*R.SUMMA_A, 0), R.operand(*R.SUMMA_B, 1)
    seen = 0
    for key, got in port["gemm"].items():
        gname, impl, case = key.split(" ", 2)
        if case in ("alpha_beta", "transpose"):
            continue
        g = grids[gname]
        want = _j("gemm", g, _put(g, a), _put(g, b), impl=impl,
                           **R.KNOBS[case])
        assert got.shape == want.shape, key
        assert _rel(got, want) < TOL, (key, _rel(got, want))
        seen += 1
    assert seen == 2 * (len(R.KNOBS) + 2 + 1)


def test_alpha_beta_and_transpose_match_jax(port, grids):
    a, b = R.operand(*R.SUMMA_A, 0), R.operand(*R.SUMMA_B, 1)
    c = R.operand(R.SUMMA_A[0], R.SUMMA_B[1], 4)
    for gname, g in grids.items():
        for impl in summa.IMPLS:
            want = _j("gemm", g, _put(g, a), _put(g, b), c=_put(g, c),
                               alpha=0.5, beta=-2.0, impl=impl)
            got = port["gemm"][f"{gname} {impl} alpha_beta"]
            assert _rel(got, want) < TOL, (gname, impl)
            np.testing.assert_array_equal(
                port["gemm"][f"{gname} {impl} transpose"],
                np.asarray(_j("transpose", g, _put(g, a), impl=impl)))


def test_trmm_every_case_matches_jax(port, grids):
    u, bb = R.operand(64, 64, 2), R.operand(64, 48, 3)
    for key, got in port["trmm"].items():
        gname, impl, side, tr = (key + " -").split(" ")[:4]
        g = grids[gname]
        if side == "windows":
            want = _j("trmm", g, _put(g, u), _put(g, bb), side="L",
                               trans_a=True, impl=impl,
                               a_window=(16, 16, 32, 32),
                               b_window=(16, 8, 32, 32))
        else:
            bx = bb if side == "L" else bb.T.copy()
            want = _j("trmm", g, _put(g, u), _put(g, bx), side=side,
                               trans_a=tr == "True", alpha=1.5, impl=impl)
        assert _rel(got, want) < TOL, (key, _rel(got, want))


def test_syrk_and_syrk2_match_jax(port, grids):
    a, u = R.operand(*R.SUMMA_A, 0), R.operand(64, 64, 2)
    c, b2 = R.operand(96, 96, 5), R.operand(64, 32, 6)
    for gname, g in grids.items():
        for impl in summa.IMPLS:
            pre = f"{gname} {impl}"
            cases = {
                pre: _j("syrk", g, _put(g, a), impl=impl),
                f"{pre} c": _j("syrk", g, _put(g, a), c=_put(g, c),
                                        alpha=-1.0, beta=1.0, impl=impl),
                f"{pre} window": _j("syrk", g, _put(g, u), impl=impl,
                                             a_window=(0, 32, 32, 32)),
                f"{pre} syrk2": _j("syrk2", g, _put(g, a), _put(g, b2),
                                             impl=impl)}
            for key, want in cases.items():
                got = port["syrk"][key]
                assert _rel(got, want) < TOL, (key, _rel(got, want))


def test_divisibility_and_impl_errors_match_jax(port, grid222):
    for impl in ("shard_map", "ring"):
        with pytest.raises(ValueError, match="summa needs"):
            _j("gemm", grid222, jnp.zeros((8, 6)), jnp.zeros((6, 4)),
                        impl=impl)
        kind, msg = port["errors"][impl]
        assert kind == "ValueError" and "summa needs" in msg, msg
    with pytest.raises(ValueError, match="unknown summa impl"):
        _j("gemm", grid222, jnp.zeros((8, 8)), jnp.zeros((8, 8)),
                    impl="cannon")
    assert port["errors"]["unknown"][0] == "ValueError"


def test_costs_match_jax(port, grid222):
    """Per-rank analytic costs (flops, link bytes, messages, calls by
    phase and kind) equal the JAX package's per-device records."""
    a, b = R.operand(*R.SUMMA_A, 0), R.operand(*R.SUMMA_B, 1)
    u, bb = R.operand(64, 64, 2), R.operand(64, 48, 3)
    g = grid222
    for impl in ("shard_map", "gspmd"):
        with jtracing.trace() as t:
            _j("gemm", g, _put(g, a), _put(g, b), impl=impl,
                        collect_chunks=2)
            _j("trmm", g, _put(g, u), _put(g, bb), trans_a=True, impl=impl)
            _j("syrk", g, _put(g, a), impl=impl)
        want = R.costs(t)
        got = port["costs"][impl]
        assert set(got) == set(want), impl
        for k in want:
            assert got[k][0] == want[k][0] and got[k][3] == want[k][3], k
            np.testing.assert_allclose(got[k][1:3], want[k][1:3],
                                       rtol=1e-12, err_msg=k)


IMPL_DEFAULTS = (
    (jsumma.gemm, summa.gemm), (jsumma.transpose, summa.transpose),
    (jsumma.trmm, summa.trmm), (jsumma.syrk, summa.syrk),
    (jsumma.syrk2, summa.syrk2),
    (jvalidate.cholesky_residual, validate.cholesky_residual),
    (jvalidate.inverse_residual, validate.inverse_residual),
    (jvalidate.qr_orthogonality, validate.qr_orthogonality),
    (jvalidate.qr_residual, validate.qr_residual))


def test_default_impl_is_the_jax_packages():
    """Every port function with an `impl` takes the JAX package's default
    ('shard_map'): on one device every impl computes the same product,
    across ranks they are different schedules."""
    for jfn, fn in IMPL_DEFAULTS:
        want = inspect.signature(jfn).parameters["impl"].default
        got = inspect.signature(fn).parameters["impl"].default
        assert want == "shard_map", jfn.__name__
        assert got == want, (fn.__module__, fn.__name__, got)
