"""The port's one-device drivers against the JAX package's, on the CPU:

  * bench.summa_gemm and bench.scaling (every --alg): the same GFLOP and
    link MiB (the JAX drivers' ICI MiB) on a one-device grid, the tile
    check of summa_gemm below 1e-5; scaling on cards that are not there
    raises;
  * entry(): its step's R and Rinv against the JAX package's cholinv on
    the same operand (relative Frobenius 1e-5) and both residuals;
  * the four examples at their own sizes, each held to its bounds;
  * the transport operator equal to examples/steady_state_transport.py's
    (both are numpy).
"""

import importlib.util
import os
import re
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.algs import cholinv as jcholinv
from capital_tpu.bench import scaling as jscaling
from capital_tpu.bench import summa_gemm as jsumma_gemm
from capital_tpu.grid import Grid as JGrid
from capital_tpu_torch import Grid, validate
from capital_tpu_torch.bench import scaling, summa_gemm
from capital_tpu_torch.entry import entry
from capital_tpu_torch.examples import (
    bounds_held, gp_regression, orthogonalize_embeddings, spectral_analysis,
    steady_state_transport)
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(60, setup=120)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in [v for v in os.environ if v.startswith("CAPITAL_")]:
        monkeypatch.delenv(var)


def _total_row(text: str) -> list[float]:
    """GFLOP, link (ICI) MiB and msgs of a cost table's <total> row."""
    line = next(x for x in text.splitlines() if x.startswith("<total>"))
    return [float(v) for v in line.split()[1:4]]


def test_summa_gemm_matches_jax(capsys):
    argv = ["--m", "256", "--k", "256", "--n", "128", "--num-iter", "1",
            "--costs"]
    one = jax.devices("cpu")[:1]
    with mock.patch.object(jax, "devices", lambda *a, **k: one):
        jrec = jsumma_gemm.main(argv)
    jtable = capsys.readouterr().out
    rec = summa_gemm.main(argv + ["--device", "cpu"])
    table = capsys.readouterr().out
    assert jrec["grid"] == rec["grid"] == (1, 1, 1)
    assert "link MiB" in table and "ICI MiB" in jtable
    assert _total_row(table) == _total_row(jtable)
    assert _total_row(table)[0] == pytest.approx(2 * 256 * 256 * 128 / 1e9,
                                                 abs=1e-3)
    assert max(rec["tile_rel_err"], jrec["tile_rel_err"]) < 1e-5


def test_scaling_matches_jax():
    for alg in ("cholinv", "cacqr", "summa", "polar"):
        argv = ["--alg", alg, "--n", "256" if alg != "cacqr" else "64",
                "--m", "4096"]
        (jrow,) = jscaling.main(argv + ["--devices", "1"])
        (row,) = scaling.main(argv + ["--device", "cpu"])
        assert row["grid"] == jrow["grid"] == [1, 1, 1]
        for key in ("gflop_per_dev", "total_gflop", "devices"):
            assert row[key] == jrow[key], (alg, key)
        assert row["link_mib_per_dev"] == jrow["ici_mib_per_dev"] == 0.0
        assert row["gflop_per_dev"] > 0 and row["model_s"] > 0
    # more devices than one: gloo ranks (tests/test_torch_mesh_tune.py);
    # cards that are not there raise, never moving to the CPU
    with pytest.raises(RuntimeError, match="no CUDA"):
        scaling.main(argv + ["--devices", "4"])


def test_entry_matches_jax():
    fn, (a,) = entry("cpu")
    assert a.shape == (512, 512) and a.device.type == "cpu"
    r, rinv = fn(a)
    jgrid = JGrid.square(c=1, d=1, devices=jax.devices("cpu")[:1])
    jr, jrinv = jax.jit(lambda x: jcholinv.factor(
        jgrid, x, jcholinv.Config(base_method="auto",
                                  summa_impl="gspmd")))(jnp.asarray(a.numpy()))
    for got, want in ((r, jr), (rinv, jrinv)):
        want = np.triu(np.asarray(want, np.float64))
        got = np.triu(got.double().numpy())
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5
    grid = Grid.square(device="cpu")
    assert float(validate.cholesky_residual(grid, a, r)) < 1e-5
    assert float(validate.inverse_residual(grid, r, rinv)) < 1e-5


@pytest.mark.parametrize("mod", [gp_regression, orthogonalize_embeddings,
                                 spectral_analysis, steady_state_transport],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_example_holds_its_bounds(mod, capsys):
    out = mod.main("cpu")
    printed = capsys.readouterr().out
    assert re.search(r"grid|mesh", printed)
    held = bounds_held(out)
    assert held and all(ok for _, _, _, ok in held), held
    if mod is orthogonalize_embeddings:
        assert out["top5"].shape == (8, 5)
    elif mod is spectral_analysis:
        assert np.all(np.diff(out["top_eigenvalues"]) <= 0)
    elif mod is steady_state_transport:
        assert out["sign"] == 1.0
        _check_transport_operator()


def _check_transport_operator():
    """The operator equals examples/steady_state_transport.py's (both
    numpy), at the example's and another grid."""
    spec = importlib.util.spec_from_file_location(
        "jax_transport_example",
        ROOT / "examples" / "steady_state_transport.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    for g, nu, bx, by in ((16, 0.05, 1.0, 0.5), (5, 0.1, 0.3, 2.0)):
        a, h = steady_state_transport.transport_operator(g, nu, bx, by)
        ja, jh = jmod.transport_operator(g, nu, bx, by)
        assert h == jh and a.dtype == ja.dtype
        np.testing.assert_array_equal(a, ja)
