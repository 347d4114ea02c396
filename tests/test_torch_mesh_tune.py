"""The tuner's grid shapes, the scaling sweep and the multi-device dry run
on gloo CPU ranks against the JAX package on its 8 virtual CPU devices:

  * grid_candidates equals the JAX package's for P = 1, 2, 4, 8, 16, 32;
  * sweep_grids of cholinv at n = 128 with tests/test_autotune.py's space
    (its own world of 8 ranks) and of cacqr on the rect shape, 1024 x 64
    (tests/torch_mesh_ranks.py's world): the same candidates, grid tags
    and device counts, and each candidate's GFLOP, link MiB (the JAX
    tuner's ICI MiB) and messages to relative 1e-12;
  * tune.main --cpu on that world: the sweep, --grid square:1:2 and
    rect:2 (no grid column, the tagged sweep's costs) and the LU sweep
    (eigh and LU skip the rect shape), each writing its tables, rank 0
    alone returning candidates;
  * bench.scaling --cpu --n 256 of cholinv and summa: every row's grid,
    GFLOP and link MiB per device equal to the JAX rows' (ICI MiB);
  * dryrun_multichip(8, device='cpu') holds each step to the JAX dry
    run's bound; its algorithm calls, in order, and its bounds are those
    of __graft_entry__.dryrun_multichip (read from its source: the JAX dry
    run is not run here) and _grid_shape is the JAX module's;
  * more cards than are visible raise, and a grid a device list cannot
    hold is refused, never moved to the CPU.
"""

import ast
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import torch_mesh_ranks as R
from capital_tpu.autotune import tune as jtune
from capital_tpu.bench import scaling as jscaling
from capital_tpu_torch import entry
from capital_tpu_torch.autotune import tune
from capital_tpu_torch.bench import scaling
from capital_tpu_torch.parallel import launch
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(210, setup=180)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
TABLES = ("_cp_times.txt", "_cp_costs.txt", "_cross_times.txt",
          "_cross_costs.txt", ".jsonl")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in [v for v in os.environ if v.startswith("CAPITAL_")]:
        monkeypatch.delenv(var)


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tune") / "t_")


@pytest.fixture(scope="module")
def port(prefix):
    return R.world(R.tune_world, prefix)


@pytest.fixture(scope="module")
def jax_cholinv(cpus):
    jax.clear_caches()
    return jtune.sweep_grids("cholinv", n=R.TUNE_N, space=R.TUNE_SPACE,
                             num_iter=1, devices=cpus)


def _same(got, want):
    """Port records (params, costs, error, time) against JAX candidates."""
    assert [g[0] for g in got] == [j.params for j in want]
    for (params, costs, error, secs), j in zip(got, want):
        assert error is None and j.error is None, (params, error, j.error)
        assert 0 < secs < float("inf")
        for mine, theirs in (("gflop", "gflop"), ("link_mib", "ici_mib"),
                             ("msgs", "msgs")):
            np.testing.assert_allclose(costs[mine], j.costs[theirs],
                                       rtol=1e-12, atol=0,
                                       err_msg=f"{params} {mine}")


def test_grid_candidates_match_jax():
    for p in (1, 2, 4, 8, 16, 32):
        assert tune.grid_candidates(["cpu"] * p) == \
            jtune.grid_candidates(list(range(p))), p
    assert tune.grid_candidates(["cpu"] * 8) == [
        ("square", 1, 1), ("square", 1, 2), ("square", 2, 2),
        ("rect", 2, 2)]


def test_sweep_grids_cholinv_matches_jax(jax_cholinv):
    """The port's sweep launches its own world of 8 gloo ranks."""
    cands = tune.sweep_grids("cholinv", n=R.TUNE_N, space=R.TUNE_SPACE,
                             num_iter=1, devices=["cpu"] * R.RANKS)
    assert [c.params["grid"] for c in cands] == [
        "square-c1x1x1", "square-c1x2x2", "square-c2x2x2", "rect-c2x2x2"]
    assert [c.params["devices"] for c in cands] == [1, 4, 8, 8]
    _same([(c.params, c.costs, c.error, c.time_s) for c in cands],
          jax_cholinv)


def test_sweep_grids_cacqr_rect_matches_jax(port, cpus):
    jax.clear_caches()
    want = jtune.sweep_grids("cacqr", n=R.QR_N, m=R.QR_M,
                             shapes=[("rect", 2, 2)], space=R.QR_SPACE,
                             num_iter=1, devices=cpus)
    assert {j.params["path"] for j in want} == {"1d", "3d", "hybrid"}
    _same(port["cacqr"], want)
    assert [r["cacqr"] for r in port["ranks"]] == [len(want)] + [0] * 7


def test_main_on_cpu_ranks(port, prefix, jax_cholinv, cpus):
    """tune.main --cpu: the auto grid is the sweep (the tagged JAX
    candidates); one --grid shape runs on its own ranks and carries no
    grid column; the LU sweep (n = 128 padded to 256 on the 2 x 2
    slices: a singular operand, factored as lax.linalg.lu factors it)
    leaves the rect shape out, as the JAX sweep's; every run writes
    the five tables, and only rank 0 returns candidates. Inside a world,
    launch.run_on runs its function here on every rank, also over a
    device list that names one card for every rank (torchrun's)."""
    main = port["main"]
    _same(main["sweep"], jax_cholinv)
    for name, tag in (("square:1:2", "square-c1x2x2"),
                      ("rect:2", "rect-c2x2x2")):
        want = [jtune.Candidate(
            params={k: v for k, v in j.params.items()
                    if k not in ("grid", "devices")}, costs=j.costs)
            for j in jax_cholinv if j.params["grid"] == tag]
        _same(main[name], want)
    jax.clear_caches()
    want = jtune.sweep_grids("lu", n=R.TUNE_N, space=R.MAIN_SPACES["lu"],
                             num_iter=1, devices=cpus)
    assert [j.params["grid"] for j in want] == [
        "square-c1x1x1", "square-c1x2x2", "square-c2x2x2"]
    _same(main["lu sweep"], want)
    for name in R.MAIN_RUNS:
        for suffix in TABLES:
            assert os.path.exists(f"{prefix}{name}{suffix}"), (name, suffix)
        with open(f"{prefix}{name}_cp_times.txt") as f:
            head = f.readline().split()
        assert ("grid" in head) == name.endswith("sweep"), (name, head)
        counts = [r["main"][name] for r in port["ranks"]]
        assert counts[0] == len(main[name]) > 0 and counts[1:] == [0] * 7
    assert [r["run_on"] for r in port["ranks"]] == [(None, 7)] * R.RANKS


def test_scaling_cpu_matches_jax(port):
    for alg in ("cholinv", "summa"):
        jrows = jscaling.main(["--cpu", "--n", str(R.SCALING_N), "--alg",
                               alg])
        rows = port["scaling"][alg]
        assert [r["grid"] for r in rows] == [r["grid"] for r in jrows] == [
            [1, 1, 1], [1, 2, 2], [2, 1, 1], [2, 2, 2]]
        for row, jrow in zip(rows, jrows):
            for key in ("devices", "gflop_per_dev", "total_gflop"):
                assert row[key] == jrow[key], (alg, row["grid"], key)
            assert row["link_mib_per_dev"] == jrow["ici_mib_per_dev"], row
            assert row["wall_s"] > 0 and row["model_s"] > 0
        assert [r["scaling"][alg] for r in port["ranks"]] == [4] + [0] * 7


def _jax_dryrun():
    src = (ROOT / "__graft_entry__.py").read_text()
    return next(f for f in ast.parse(src).body
                if isinstance(f, ast.FunctionDef)
                and f.name == "dryrun_multichip")


def _port_dryrun():
    src = (ROOT / "capital_tpu_torch" / "entry.py").read_text()
    return next(f for f in ast.parse(src).body
                if isinstance(f, ast.FunctionDef) and f.name == "_dryrun")


ALGS = {"cholinv", "cholinv_cyclic", "cacqr", "trsm", "lu", "tsqr", "polar",
        "eigh", "svd", "_svd", "newton", "rectri"}


def _alg_calls(fn) -> list:
    """(module, function) of each algorithm call in source order, the
    Config constructors left out."""
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute)
             and isinstance(n.func.value, ast.Name)
             and n.func.value.id in ALGS and n.func.attr != "Config"]
    calls.sort(key=lambda n: (n.lineno, n.col_offset))
    return [(n.func.value.id.lstrip("_"), n.func.attr) for n in calls]


def _jax_bounds(fn) -> list:
    """The constant each assert of the JAX dry run compares against."""
    out = []
    for node in sorted((n for n in ast.walk(fn) if isinstance(n, ast.Assert)),
                       key=lambda n: n.lineno):
        cmp = next(n for n in ast.walk(node.test)
                   if isinstance(n, ast.Compare))
        out.append(ast.literal_eval(cmp.comparators[0]))
    return out


def test_dryrun_multichip_on_cpu_ranks():
    """Every step on 8 gloo CPU ranks within the JAX dry run's bound."""
    figs = entry.dryrun_multichip(R.RANKS, device="cpu")
    assert list(figs) == [s for s, _, _ in entry.STEPS]
    for step, what, bound in entry.STEPS:
        fig = figs[step]
        assert fig["what"] == what and fig["bound"] == bound and fig["held"]
        v = fig["value"]
        assert np.isfinite(v), step
        if bound is not None:
            assert v >= bound if step == "svd_partial" else v < bound, \
                (step, v, bound)
    assert _alg_calls(_port_dryrun()) == _alg_calls(_jax_dryrun()) == [
        ("cholinv", "factor"), ("cholinv", "factor"),
        ("cholinv_cyclic", "factor"), ("cacqr", "factor_1d"),
        ("cacqr", "factor_hybrid"), ("trsm", "solve"), ("lu", "factor"),
        ("lu", "solve_factored"), ("tsqr", "factor"), ("polar", "polar"),
        ("eigh", "eigh_partial"), ("svd", "svd_partial"),
        ("newton", "invert")]
    assert [b for _, _, b in entry.STEPS if b is not None] == \
        _jax_bounds(_jax_dryrun())
    for p in range(1, 65):
        assert entry._grid_shape(p) == graft._grid_shape(p), p


def test_more_devices_than_visible_raise(monkeypatch):
    """No card here: every entry point that asks for cards raises, and
    a grid that the device list cannot hold is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="visible"):
        entry.dryrun_multichip(8)
    with pytest.raises(RuntimeError, match="visible"):
        launch.world_of(["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="twice"):
        launch.world_of(["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="one kind"):
        launch.world_of(["cpu", "cuda:0"])
    with pytest.raises(RuntimeError, match="no CUDA"):
        tune.main(["--grid", "square:1:2"])
    with pytest.raises(RuntimeError, match="no CUDA"):
        scaling.main(["--devices", "4"])
    for grid in ("square:1:2", "square:2:1"):
        with pytest.raises(ValueError, match="needs"):
            tune.main(["--device", "cpu", "--n", "128", "--grid", grid])
    with pytest.raises(ValueError, match="c\\^2 \\| P"):
        tune.main(["--device", "cpu", "--n", "128", "--grid", "rect:2"])
