"""The port's slice end to end: capital_tpu_torch's cholinv.factor vs the
JAX package's on a one-device grid, from the same operand and config.

The operand is the JAX package's matrix.symmetric, handed over as numpy
(interop.dist_matrix_from_numpy), and the config is
`dataclasses.asdict` of the JAX Config (interop.config_from_dict). The
JAX reference runs on the CPU, where it takes its dot/xla paths. The port
runs twice: with 'auto' (its dot/xla counterparts) and with
CAPITAL_TRMM_METHOD=tri CAPITAL_SYRK_METHOD=tri CAPITAL_CHOL_METHOD=pallas,
so the plain versions of the three kernels carry the whole recursion.

At 'highest', R and Rinv agree to relative Frobenius 1e-5; the port's own
validators agree with JAX's within 10x and stay below 1e-5. The fused
leaf's inverse residual is 10-30x that of LAPACK's potrf + trsm at these
sizes (tests/test_pallas_chol.py allows the Pallas leaf 20x), so for the
run on the kernels' plain versions the JAX reference also factors its
leaves with its fused Pallas kernel, in interpret mode as its own tests
run it.
"""

import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch

from capital_tpu import matrix as jmatrix
from capital_tpu import validate as jvalidate
from capital_tpu.algs import cholinv as jcholinv
from capital_tpu.grid import Grid as JGrid
from capital_tpu.ops import pallas_chol
from capital_tpu_torch import Grid, interop, matrix, validate
from capital_tpu_torch.algs import cholinv
from capital_tpu_torch.bench import cholinv as bench_cholinv
from capital_tpu_torch.ops import counters, reset_counters

torch.set_num_threads(1)

ENV = ("CAPITAL_TRMM_METHOD", "CAPITAL_SYRK_METHOD", "CAPITAL_CHOL_METHOD")
KERNELS = {"CAPITAL_TRMM_METHOD": "tri", "CAPITAL_SYRK_METHOD": "tri",
           "CAPITAL_CHOL_METHOD": "pallas"}
# (n, min_bc, split, lower)
CASES = ([(256, bc, s, lo) for bc in (128, 512) for s in (1, 2)
          for lo in (False, True)]
         + [(1024, 128, 1, False), (1024, 512, 2, True)])


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


@functools.lru_cache(maxsize=None)
def _jax_case(n, min_bc, split, lower, leaf="auto"):
    """(A, shape, cfg dict, R, Rinv, residual, inverse residual) from the
    JAX package (R/Rinv are (L, Linv) when lower). leaf='pallas' factors
    the leaves with the fused Pallas kernel in interpret mode."""
    grid = JGrid.square(c=1, d=1, devices=jax.devices("cpu")[:1])
    a = jmatrix.symmetric(grid, n, jax.random.key(n + min_bc), align=128)
    cfg = jcholinv.Config(min_bc=min_bc, split=split, lower=lower,
                          base_method=leaf)
    kernel = pallas_chol.chol_inv_pallas
    pallas_chol.chol_inv_pallas = functools.partial(kernel, interpret=True)
    try:
        r, rinv = jcholinv.factor(grid, a, cfg)
    finally:
        pallas_chol.chol_inv_pallas = kernel
    ru, riu = (r.T, rinv.T) if lower else (r, rinv)
    res = float(jvalidate.cholesky_residual(grid, a.data, ru))
    inv = float(jvalidate.inverse_residual(grid, ru, riu))
    d = dataclasses.asdict(cfg)
    d["base_policy"] = cfg.base_policy.value
    return (np.asarray(a.data), a.shape, d, np.asarray(r), np.asarray(rinv),
            res, inv)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("kernels", [False, True],
                         ids=["auto", "kernel_plain"])
@pytest.mark.parametrize("n,min_bc,split,lower", CASES)
def test_factor_matches_jax(n, min_bc, split, lower, kernels, monkeypatch):
    a_np, shape, cfg_d, r_j, ri_j, res_j, inv_j = _jax_case(
        n, min_bc, split, lower, "pallas" if kernels else "auto")
    if kernels:
        for var, val in KERNELS.items():
            monkeypatch.setenv(var, val)
    grid = Grid.square(c=1, d=1, device="cpu")
    a = interop.dist_matrix_from_numpy(a_np, shape, "rect", device="cpu")
    cfg = interop.config_from_dict(cfg_d)
    assert (cfg.min_bc, cfg.split, cfg.lower) == (min_bc, split, lower)
    reset_counters()
    r, rinv = cholinv.factor(grid, a, cfg)
    used = counters()
    fallbacks = used["trmm_dot"] + used["syrk_dot"] + used["chol_xla"]
    assert (fallbacks == 0) == kernels, used
    assert _rel(r.numpy(), r_j) < 1e-5
    assert _rel(rinv.numpy(), ri_j) < 1e-5
    ru, riu = (r.T, rinv.T) if lower else (r, rinv)
    res = float(validate.cholesky_residual(grid, a.data, ru))
    inv = float(validate.inverse_residual(grid, ru, riu))
    assert res < 1e-5 and res <= 10 * res_j, (res, res_j)
    assert inv < 1e-5 and inv <= 10 * inv_j, (inv, inv_j)


def test_chunked_validators_match_dense():
    a_np, shape, cfg_d, *_ = _jax_case(256, 128, 1, False)
    grid = Grid.square(device="cpu")
    a = interop.dist_matrix_from_numpy(a_np, shape, device="cpu")
    r, rinv = cholinv.factor(grid, a, interop.config_from_dict(cfg_d))
    for dense, chunked in (
            (validate.cholesky_residual(grid, a.data, r),
             validate.cholesky_residual(grid, a.data, r, chunks=4,
                                        masked=True)),
            (validate.inverse_residual(grid, r, rinv),
             validate.inverse_residual(grid, r, rinv, chunks=4,
                                       masked=True))):
        assert float(chunked) == pytest.approx(float(dense), rel=1e-3)


def test_policies_and_remat_are_one_schedule_on_one_device():
    grid = Grid.square(device="cpu")
    a = matrix.symmetric(grid, 256, 0, align=128)
    ref = cholinv.factor(grid, a, cholinv.Config(min_bc=128))
    for cfg in [cholinv.Config(min_bc=128, base_policy=p)
                for p in ("layer", "gather", "gather_overlap")] + [
                    cholinv.Config(min_bc=128, remat=True)]:
        r, rinv = cholinv.factor(grid, a, cfg)
        assert torch.equal(r, ref[0]) and torch.equal(rinv, ref[1])
    assert torch.equal(a.data, a.data.T)  # factor leaves A as it was


def test_complete_inv_false_leaves_top_block_zero():
    grid = Grid.square(device="cpu")
    a = matrix.symmetric(grid, 256, 1)
    r, rinv = cholinv.factor(grid, a, cholinv.Config(min_bc=128,
                                                     complete_inv=False))
    assert torch.count_nonzero(rinv[:128, 128:]) == 0
    eye = torch.eye(128)
    assert torch.allclose(r[:128, :128] @ rinv[:128, :128], eye, atol=1e-5)
    assert torch.allclose(r[128:, 128:] @ rinv[128:, 128:], eye, atol=1e-5)


def test_symmetric_padding_matches_jax():
    """Values differ (torch.Generator vs jax.random); the padding does not:
    an identity block outside the logical n x n, zeros off it."""
    n = 200
    jgrid = JGrid.square(c=1, d=1, devices=jax.devices("cpu")[:1])
    want = np.asarray(jmatrix.symmetric(jgrid, n, jax.random.key(0),
                                        align=128).data)
    got = matrix.symmetric(Grid.square(device="cpu"), n, 0, align=128)
    assert got.data.shape == want.shape == (256, 256)
    assert got.shape == (n, n)
    g = got.data.numpy()
    assert np.array_equal(g[n:, :], want[n:, :])
    assert np.array_equal(g[:, n:], want[:, n:])
    assert np.array_equal(g, g.T)
    assert np.array_equal(np.diag(g)[:n] >= n - 1, np.ones(n, bool))
    u = matrix.rand(Grid.square(device="cpu"), 100, 60, 3, row_tile=128,
                    col_tile=128)
    assert u.data.shape == (128, 128) and u.to_global().shape == (100, 60)
    assert torch.count_nonzero(u.data[100:]) == 0


@pytest.mark.parametrize("lower", [False, True])
def test_cost_trace_matches_jax(lower):
    """The analytic cost table (phases CI::factor_diag/trsm/tmu/inv) is the
    JAX package's, phase by phase."""
    from capital_tpu import tracing as jtracing
    from capital_tpu_torch import tracing

    jgrid = JGrid.square(c=1, d=1, devices=jax.devices("cpu")[:1])
    ja = jmatrix.symmetric(jgrid, 1024, jax.random.key(0), align=128)
    jcfg = jcholinv.Config(min_bc=128, lower=lower)
    with jtracing.trace() as jt:
        jax.eval_shape(lambda x: jcholinv.factor(jgrid, x, jcfg), ja.data)
    grid = Grid.square(device="cpu")
    a = matrix.symmetric(grid, 1024, 0, align=128)
    with tracing.trace() as t:
        cholinv.factor(grid, a, cholinv.Config(min_bc=128, lower=lower))
    want = {k: dataclasses.astuple(v) for k, v in jt.by_phase.items()}
    got = {k: dataclasses.astuple(v) for k, v in t.by_phase.items()}
    assert got == want
    assert {k.split("/")[0] for k in got} >= {
        "CI::factor_diag", "CI::trsm", "CI::tmu", "CI::inv"}


def test_device_busy_counts_work_once_and_skips_phase_ranges():
    from capital_tpu_torch.tracing import device_busy_ms

    events = [
        {"cat": "kernel", "ph": "X", "ts": 0, "dur": 10},
        {"cat": "kernel", "ph": "X", "ts": 5, "dur": 10},     # overlaps
        {"cat": "gpu_memcpy", "ph": "X", "ts": 30, "dur": 5},
        {"cat": "gpu_user_annotation", "ph": "X", "ts": 0, "dur": 100},
        {"cat": "cpu_op", "ph": "X", "ts": 0, "dur": 100},
    ]
    assert device_busy_ms(events) == pytest.approx(0.020)
    assert device_busy_ms([]) == 0.0


def test_config_from_dict_rejects_unknown_fields():
    with pytest.raises(ValueError):
        interop.config_from_dict({"min_bc": 128, "no_such_knob": 1})


def test_bench_driver_on_cpu(capsys):
    rec = bench_cholinv.main(["--device", "cpu", "--n", "256",
                              "--num-iter", "1", "--json",
                              "--precision", "high"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["bench"] == "cholinv" and out["device"] == "cpu"
    assert rec["residual"] < 1e-5 and rec["inv_residual"] < 1e-5


@pytest.mark.parametrize("flag", [["--layout", "1"], ["--summa-impl", "ring"],
                                  ["--summa-chunks", "2"],
                                  ["--summa-throttle"],
                                  ["--base-policy", "layer"], ["--remat"],
                                  ["--donate"]])
def test_bench_driver_refuses_flags_without_effect(flag, capsys):
    """The JAX driver's multi-device flags change nothing on one device, so
    a value other than the default is refused, not silently ignored."""
    with pytest.raises(SystemExit) as exc:
        bench_cholinv.main(["--device", "cpu", "--n", "256"] + flag)
    assert exc.value.code == 2
    assert flag[0] in capsys.readouterr().err
