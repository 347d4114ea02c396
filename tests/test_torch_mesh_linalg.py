"""The port's linalg solvers across ranks against the JAX package's on
its 8 virtual CPU devices: one 8-rank gloo world (tests/torch_mesh_ranks.py)
runs, on the flat 2 x 2 view (the JAX package's grid122, d = 2),
spd_solve with two refinement sweeps and with a reused factor, inv,
slogdet_spd (also on the 2 x 2 x 2 grid), solve by 'normal', 'polar' and
'lu' (and 'lu' from bf16 factors, factor_dtype), and expm; lstsq by 'cqr2' on the rect grid and by 'tsqr' on the 1D
grid of 8, with and without a refinement sweep; and the 1-D
right-hand-side convention of every solve on d = 2.

Tolerances (tests/test_torch_linalg.py's): relative Frobenius 1e-5 to
the JAX package's result at 'highest' (the operands are well conditioned:
SPD (U + U^T)/2 + n I, general U + 10 I, a tall operand of condition 100);
expm also within 1e-5 of scipy's in f64; a 1-D b gives a 1-D x whose
residual ||Ax - b|| / ||b|| is below 1e-5 (lstsq: within 1e-5 of the
JAX package's x, and the normal-equations residual ||A^T (Ax - b)||
below 1e-4 ||A^T b|| in both packages: the JAX package's own reads
3.6e-6 of ||A^T b|| = 0.31 here, f32 rounding of a condition-100
operand); the per-rank cost records of spd_solve and of each solve
method equal the JAX package's per-device ones ('lu' but for the JAX
trsm scan's body gemms, recorded once at trace time, which the port's
substitution loop does not record: tests/test_torch_mesh_tri.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

import torch_mesh_ranks as R
from capital_tpu import linalg as jlinalg
from capital_tpu import tracing as jtracing
from capital_tpu.algs import cacqr as jcacqr
from capital_tpu.algs import cholinv as jcholinv
from capital_tpu.algs import polar as jpolar
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(120, setup=180)

TOL = 1e-5
NORMAL_TOL = 1e-4
ROWS = jax.sharding.PartitionSpec(("z", "y", "x"), None)


@pytest.fixture(scope="module")
def port():
    return R.world(R.linalg_world, R.linalg_operands())


def _slice(g, x):
    return jax.device_put(jnp.asarray(x), g.sharding(g.slice_spec))


def _rows(g, x):
    return jax.device_put(jnp.asarray(x), g.sharding(ROWS))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _ccfg():
    return jcholinv.Config(min_bc=64, base_method="xla", summa_impl="gspmd")


def _pcfg():
    return jpolar.Config(chol=_ccfg())


def _qcfg():
    return jcacqr.Config(base_method="xla", gram_kernel="dot",
                         chol=jcholinv.Config(min_bc=64, base_method="xla"))


def _same_costs(got, want, key, skip=()):
    if skip:  # the totals then differ by what is skipped
        skip = skip + ("<total>",)
        got = {k: v for k, v in got.items() if k != "<total>"}
        want = {k: v for k, v in want.items()
                if not any(k.startswith(s) for s in skip)}
    assert set(got) == set(want), key
    for k in want:
        assert got[k][0] == want[k][0] and got[k][3] == want[k][3], (key, k)
        np.testing.assert_allclose(got[k][1:3], want[k][1:3], rtol=1e-12,
                                   err_msg=f"{key} {k}")


def _operands():
    a_spd = R.spd(R.LIN_N, 30)
    gen = (R.operand(R.LIN_N, R.LIN_N, 33)
           + 10.0 * np.eye(R.LIN_N, dtype=np.float32)).astype(np.float32)
    return a_spd, gen, R.operand(R.LIN_N, R.LIN_K, 31)


def test_spd_solve_refined_and_reused_factor_match_jax(port, grid122):
    g = grid122
    a_spd, _, b_np = _operands()
    a, b = _slice(g, a_spd), _slice(g, b_np)
    with jax.default_matmul_precision("highest"), jtracing.trace() as t:
        x = jax.jit(lambda a, b: jlinalg.spd_solve(g, a, b, _ccfg(),
                                                   refine=2))(a, b)
    assert _rel(port["spd"]["refine2"], x) < TOL
    _same_costs(port["costs"]["spd_solve"], R.costs(t), "spd_solve")
    b2 = _slice(g, R.operand(R.LIN_N, R.LIN_K, 32))
    with jax.default_matmul_precision("highest"):
        x2 = jax.jit(lambda a, b: jlinalg.spd_solve(
            g, a, b, _ccfg(), factor=jcholinv.factor(g, a, _ccfg())))(a, b2)
    assert _rel(port["spd"]["factor_reuse"], x2) < TOL
    r = a_spd.astype(np.float64) @ port["spd"]["refine2"] - b_np
    assert np.linalg.norm(r) / np.linalg.norm(b_np) < TOL


def test_inv_and_slogdet_spd_match_jax(port, grid122, grid222):
    a_spd, _, _ = _operands()
    with jax.default_matmul_precision("highest"):
        inv = jax.jit(lambda a: jlinalg.inv(grid122, a, _ccfg()))(
            _slice(grid122, a_spd))
        _, ld = jax.jit(lambda a: jlinalg.slogdet_spd(grid122, a, _ccfg()))(
            _slice(grid122, a_spd))
    assert _rel(port["spd"]["inv"], inv) < TOL
    _, ld_np = np.linalg.slogdet(a_spd.astype(np.float64))
    for key in ("slogdet", "slogdet_222"):
        sign, logdet = port["spd"][key]
        assert sign == 1.0
        assert abs(logdet - float(ld)) <= TOL * abs(float(ld)), key
        assert abs(logdet - ld_np) <= TOL * abs(ld_np), key


def test_solve_each_method_matches_jax(port, grid122):
    g = grid122
    _, gen, b_np = _operands()
    for method in ("normal", "polar", "lu"):
        with jax.default_matmul_precision("highest"), \
                jtracing.trace() as t:
            x = jax.jit(lambda a, b: jlinalg.solve(
                g, a, b, method=method, cfg=_ccfg(), polar_cfg=_pcfg()))(
                _slice(g, gen), _slice(g, b_np))
        got = port["solve"][method]
        assert _rel(got, x) < TOL, (method, _rel(got, x))
        r = gen.astype(np.float64) @ got - b_np
        assert np.linalg.norm(r) / np.linalg.norm(b_np) < TOL, method
        _same_costs(port["costs"][f"solve {method}"], R.costs(t),
                    f"solve {method}",
                    skip=("TRSM::substitute/summa.gemm",) if method == "lu"
                    else ())
    # 'lu' with factor_dtype: bf16 factors of a downcast copy, refined
    # against A at the operand's precision
    with jax.default_matmul_precision("highest"):
        x = jax.jit(lambda a, b: jlinalg.solve(
            g, a, b, method="lu", cfg=_ccfg(), factor_dtype=jnp.bfloat16))(
            _slice(g, gen), _slice(g, b_np))
    got = port["solve"]["lu bf16"]
    assert _rel(got, x) < TOL, _rel(got, x)


def test_lstsq_cqr2_and_tsqr_match_jax(port, grid_rect, grid1d8):
    m, n, k = R.LSTSQ
    a_np = R.controlled(m, n, 100.0, 34)
    b_np = R.operand(m, k, 35)
    for method, gname, g in (("cqr2", "rect", grid_rect),
                             ("tsqr", "1d8", grid1d8)):
        for refine in (0, 1):
            with jax.default_matmul_precision("highest"):
                x = jax.jit(lambda a, b: jlinalg.lstsq(
                    g, a, b, _qcfg(), refine=refine, method=method))(
                    _rows(g, a_np), _rows(g, b_np))
            got = port["lstsq"][f"{method} {gname} {refine}"]
            assert got.shape == (n, k)
            assert _rel(got, x) < TOL, (method, refine, _rel(got, x))


def test_expm_matches_jax_and_scipy(port, grid122):
    e_np = (R.operand(R.EXPM_N, R.EXPM_N, 36)
            * (4.0 / R.EXPM_N**0.5)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jlinalg.expm(grid122, _slice(grid122, e_np), _ccfg())
    assert _rel(port["expm"], want) < TOL
    assert _rel(port["expm"], scipy.linalg.expm(e_np.astype(np.float64))) \
        < TOL


def test_vector_rhs_convention_on_d2(port, grid122):
    """1-D b in, 1-D x out, for every solve on the flat d = 2 view (the
    single column is replicated along 'x', which it does not divide),
    each within 1e-5 of the JAX package's."""
    g = grid122
    a_spd, gen, b_np = _operands()
    b1 = b_np[:, 0].copy()
    got = port["vector"]
    with jax.default_matmul_precision("highest"):
        for method in ("normal", "lu", "polar"):
            x = jlinalg.solve(g, _slice(g, gen), jnp.asarray(b1),
                              method=method, cfg=_ccfg(), polar_cfg=_pcfg())
            mine = got[f"solve {method}"]
            assert mine.shape == (R.LIN_N,) == x.shape, method
            assert _rel(mine, x) < TOL, method
            r = gen.astype(np.float64) @ mine - b1
            assert np.linalg.norm(r) / np.linalg.norm(b1) < TOL, method
        x = jlinalg.spd_solve(g, _slice(g, a_spd), jnp.asarray(b1), _ccfg())
    assert got["spd_solve"].shape == (R.LIN_N,)
    assert _rel(got["spd_solve"], x) < TOL
    m, n, _ = R.LSTSQ
    at = R.controlled(m, n, 100.0, 34)
    bt = R.operand(*R.LSTSQ[::2], 35)[:, 0].copy()
    with jax.default_matmul_precision("highest"):
        x = jlinalg.lstsq(g, jnp.asarray(at), jnp.asarray(bt), _qcfg())
    xt = got["lstsq"]
    assert xt.shape == (n,) == x.shape
    assert _rel(xt, x) < TOL
    a64, b64 = at.astype(np.float64), bt.astype(np.float64)
    for xx in (xt, x):
        ng = np.linalg.norm(a64.T @ (a64 @ np.asarray(xx, np.float64) - b64))
        assert ng < NORMAL_TOL * np.linalg.norm(a64.T @ b64), ng
