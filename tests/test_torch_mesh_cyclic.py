"""The port's block-cyclic workspace (parallel/cyclic.py) and the
cyclic-workspace cholinv (algs/cholinv_cyclic.py) across ranks against
the JAX package's on its 8 virtual CPU devices: one 8-rank gloo world
(tests/torch_mesh_ranks.py) lays integer-valued operands out cyclically
on the 2 x 2 x 2 grid (tile 16), reads, writes and masks windows, and
multiplies windows (gemm_window whole, interior and mixed, in one and
two K chunks; trmm_window and syrk_window); and factors one SPD operand
(n = 256, base case 64) by cholinv_cyclic on the 2 x 2 x 2 grid
(summa_chunks 2) and on the flat 2 x 2 view.

Tolerances: the layout, the windows and the window products are exact
against the JAX package's (integer operands: every product and sum is
exact in f32, whatever the summation order); R and Rinv within relative
Frobenius 1e-5 of the JAX package's (tests/test_cholinv_cyclic.py's
bound), both packages' residuals below 5e-6; the errors (d not dividing
the base case, a non-square slice, an unaligned window) are the JAX
package's, type and message; the per-rank cost records equal the JAX
package's per-device ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as R
from capital_tpu import tracing as jtracing
from capital_tpu import validate as jvalidate
from capital_tpu.algs import cholinv as jcholinv
from capital_tpu.algs import cholinv_cyclic as jcyc
from capital_tpu.parallel import cyclic as jcyclic
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(60, setup=180)

TB = R.CYC_TB
TOL, RES_TOL = 1e-5, 5e-6


@pytest.fixture(scope="module")
def port():
    return R.world(R.cyclic_world)


def _put(g, x):
    return jax.device_put(jnp.asarray(x), g.sharding(g.slice_spec))


@pytest.fixture(scope="module")
def jax_side(grid222):
    g = grid222
    to = jax.jit(lambda x: jcyclic.to_cyclic(g, x, tb=TB))
    return (g, to(_put(g, R.integers(R.CYC_N, R.CYC_N, 0))),
            to(_put(g, R.integers(R.CYC_N, 128, 1))))


def _jcfg(**kw):
    base = dict(min_bc=64, base_method="xla")
    base.update(kw)
    return jcholinv.Config(**base)


def _jit(fn, *args):
    """fn(*args) jitted (eager shard_map compiles every call: ~10x
    slower)."""
    return np.asarray(jax.jit(fn)(*args))


def _catch(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - the error is the result
        return (type(exc).__name__, str(exc))
    return ("ok", None)


def test_layout_round_trip_matches_jax(port, jax_side):
    """to_cyclic gives the JAX package's physical array, each rank holds
    its block of it, and from_cyclic gives the operand back."""
    g, pa, _ = jax_side
    np.testing.assert_array_equal(port["phys"], np.asarray(pa))
    assert port["spec"] == ("y", "x")
    np.testing.assert_array_equal(port["back"],
                                  R.integers(R.CYC_N, R.CYC_N, 0))
    phys = np.asarray(pa)
    for rank in port["ranks"]:
        _, y, x = rank["coord"]
        np.testing.assert_array_equal(
            rank["block"], phys[y * 128:(y + 1) * 128, x * 128:(x + 1) * 128])


def test_read_and_update_window_match_jax(port, jax_side):
    g, pa, _ = jax_side
    win = (64, 128, 128, 64)

    def read_update(p):
        rd = jcyclic.read_window(g, p, win, tb=TB)
        up = jcyclic.update_window(g, p, 2.0 * rd, win, tb=TB)
        return rd, jcyclic.from_cyclic(g, up, tb=TB)

    rd, up = jax.jit(read_update)(pa)
    np.testing.assert_array_equal(port["read"], np.asarray(rd))
    np.testing.assert_array_equal(port["update"], np.asarray(up))


def test_read_window_tri_matches_jax(port, jax_side):
    """The triangle masks in global coordinates on the permuted layout,
    each rank with its own coordinates."""
    g, pa, _ = jax_side
    for uplo in "UL":
        want = _jit(lambda p: jcyclic.read_window_tri(
            g, p, (64, 64, 128, 128), uplo=uplo, tb=TB), pa)
        np.testing.assert_array_equal(port["tri"][uplo], want)


def test_gemm_window_matches_jax(port, jax_side):
    g, pa, pb = jax_side
    for name, (aw, bw) in R.CYC_WINDOWS.items():
        for chunks in (1, 2):
            want = _jit(lambda x, y: jcyclic.gemm_window(
                g, x, y, a_window=aw, b_window=bw, num_chunks=chunks,
                tb=TB), pa, pb)
            np.testing.assert_array_equal(port["gemm"][f"{name} {chunks}"],
                                          want, err_msg=name)


def test_trmm_and_syrk_window_match_jax(port, jax_side):
    g, pa, _ = jax_side
    def products(p):
        c = jcyclic.read_window(g, p, (128, 128, 128, 128), tb=TB)
        return {
            "L trans": jcyclic.trmm_window(
                g, p, p, side="L", trans_a=True, a_window=(0, 0, 128, 128),
                b_window=(0, 128, 128, 128), tb=TB),
            "R": jcyclic.trmm_window(
                g, p, p, side="R", alpha=-1.0,
                a_window=(128, 128, 128, 128), b_window=(0, 128, 128, 128),
                num_chunks=2, tb=TB),
            "syrk": jcyclic.syrk_window(g, p, c=c, alpha=-1.0, beta=1.0,
                                        a_window=(0, 128, 128, 128), tb=TB)}

    want = jax.jit(products)(pa)
    for case in ("L trans", "R"):
        np.testing.assert_array_equal(port["trmm"][case],
                                      np.asarray(want[case]), err_msg=case)
    np.testing.assert_array_equal(port["syrk"], np.asarray(want["syrk"]))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_cholinv_cyclic_matches_jax(port, grid222):
    """cholinv_cyclic on the 2 x 2 x 2 grid and on the flat 2 x 2 view
    (the JAX package's grid122 shape): R and Rinv against the JAX
    package's, both packages' residuals, the slice layout, the cost
    records."""
    for name in ("222", "flat"):
        _check_cholinv_cyclic(port, grid222, name)


def _check_cholinv_cyclic(port, grid222, name):
    g = grid222 if name == "222" else grid222.view(z=None, y="y", x="x")
    cfg = _jcfg(summa_chunks=2) if name == "222" else _jcfg()
    a = _put(g, R.spd(R.CYC_N, 21))
    with jtracing.trace() as t:
        jr, jri = jax.jit(lambda x: jcyc.factor(g, x, cfg))(a)
    r, ri, spec = port["chol"][name]
    assert spec == ("y", "x")
    assert _rel(r, jr) < TOL, _rel(r, jr)
    assert _rel(ri, jri) < TOL, _rel(ri, jri)
    for rr, rri in ((r, ri), (jr, jri)):
        res = jax.jit(lambda a, r, ri: (
            jvalidate.cholesky_residual(g, a, r),
            jvalidate.inverse_residual(g, r, ri)))(a, _put(g, rr),
                                                   _put(g, rri))
        assert max(float(x) for x in res) < RES_TOL, res
    got, want = port["costs"][name], R.costs(t)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        assert got[k][0] == want[k][0] and got[k][3] == want[k][3], k
        np.testing.assert_allclose(got[k][1:3], want[k][1:3], rtol=1e-12,
                                   err_msg=k)


def test_errors_are_the_jax_packages(port, grid222, grid1d8):
    a = _put(grid222, R.spd(R.CYC_N, 21))
    a8 = jax.device_put(jnp.asarray(R.spd(R.CYC_N, 21)),
                        grid1d8.sharding(grid1d8.slice_spec))
    pa = jax.jit(lambda x: jcyclic.to_cyclic(grid222, x, tb=TB))(a)
    want = {
        "d not dividing bc": _catch(lambda: jcyc.factor(
            grid222, a, _jcfg(min_bc=63))),
        "non-square slice": _catch(lambda: jcyc.factor(grid1d8, a8,
                                                       _jcfg())),
        "unaligned window": _catch(lambda: jcyclic.read_window(
            grid222, pa, (8, 0, 64, 64), tb=TB))}
    assert port["errors"] == want
