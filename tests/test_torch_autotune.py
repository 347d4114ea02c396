"""The port's autotuner (capital_tpu_torch.autotune.tune) against the JAX
package's, both on a one-device CPU grid and the same numpy operands:

  * the same reduced space into both sweeps (cholinv n = 256, cacqr 1024 x
    64 on the 1d and hybrid paths, LU n = 256 with and without lookahead,
    eigh n = 256 split once) and one default-space cholinv sweep: the
    candidates' params in the same order, the same candidates carry an
    error, and each candidate's GFLOP, link MiB (the JAX tuner's ICI MiB)
    and message count agree to relative 1e-9;
  * the five table files: the JAX tuner's headers with the link column in
    the ICI column's place, one row a candidate;
  * `best` is one of the candidates; `main` on the CPU; a grid shape one
    device cannot hold raises (tests/test_torch_mesh_tune.py runs them on
    gloo ranks).

The JAX tuner records costs while tracing (jax.eval_shape; for eigh,
while its jitted stages trace during the run), the port's while its
warm-up call runs; the records are the same. A JAX stage traced before
(by another test in the process) records nothing, so each JAX sweep here
starts from cleared jit caches.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.autotune import tune as jtune
from capital_tpu.grid import Grid as JGrid
from capital_tpu_torch import Grid
from capital_tpu_torch.autotune import tune
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(60, setup=120)

torch.set_num_threads(1)

TABLES = ("_cp_times.txt", "_cp_costs.txt", "_cross_times.txt",
          "_cross_costs.txt", ".jsonl")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in [v for v in os.environ if v.startswith("CAPITAL_")]:
        monkeypatch.delenv(var)


def _jgrid():
    return JGrid.square(c=1, d=1, devices=jax.devices("cpu")[:1])


def _grid():
    return Grid.square(device="cpu")


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.5, 0.5, (n, n))
    return ((u + u.T) / 2 + n * np.eye(n)).astype(np.float32)


def _two_clusters(n, seed):
    """Eigenvalues in [1, 2] and [5, 6], half each: the top split's shift
    (the diagonal's median) falls in the gap, so both halves have n/2
    rows and no deeper level splits."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = np.concatenate([np.linspace(1, 2, n // 2), np.linspace(5, 6, n // 2)])
    return ((q * w) @ q.T).astype(np.float32)


def _operands():
    rng = np.random.default_rng(3)
    tall = rng.uniform(-0.5, 0.5, (1024, 64)) * np.linspace(1, 2, 64)
    return {"cholinv": _spd(256, 1), "cacqr": tall.astype(np.float32),
            "lu": rng.uniform(-0.5, 0.5, (256, 256)).astype(np.float32),
            "eigh": _two_clusters(256, 2)}


SPACES = {
    # the leaf method 'bogus' is refused by both packages: an error each
    "cholinv": {"bc_mult": [0, 1], "min_bc": [128],
                "base_method": ["xla", "bogus"],
                "precision": ["highest", "high"]},
    "cacqr": {"path": ["1d", "hybrid"], "num_iter": [2],
              "gram_policy": ["allreduce", "two_stage", "packed"],
              "formq_chunks": [1, 4], "base_method": ["xla"]},
    "lu": {"nb": [128], "summa_impl": ["gspmd"], "precision": ["highest"],
           "lookahead": [False, True]},
    "eigh": {"base_n": [128], "summa_impl": ["gspmd"], "sign_l0": [None],
             "precision": ["highest"]},
}


def _check_same(cands, jcands):
    assert [c.params for c in cands] == [c.params for c in jcands]
    assert [c.error is None for c in cands] == \
        [c.error is None for c in jcands], (
            [c.error for c in cands], [c.error for c in jcands])
    for c, j in zip(cands, jcands):
        if j.error is not None:
            continue
        for mine, theirs in (("gflop", "gflop"), ("link_mib", "ici_mib"),
                             ("msgs", "msgs")):
            np.testing.assert_allclose(c.costs[mine], j.costs[theirs],
                                       rtol=1e-9, atol=0, err_msg=mine)
        assert 0 < c.time_s < float("inf")
        assert c.model_time_s > 0
    assert tune.best(cands) in cands


@pytest.mark.parametrize("alg", ["cholinv", "cacqr", "lu", "eigh"])
def test_sweep_matches_jax(alg):
    a = _operands()[alg]
    sweep, jsweep = getattr(tune, f"sweep_{alg}"), getattr(jtune,
                                                           f"sweep_{alg}")
    jax.clear_caches()
    jcands = jsweep(_jgrid(), jnp.asarray(a), SPACES[alg], num_iter=1)
    cands = sweep(_grid(), torch.from_numpy(a), SPACES[alg], num_iter=1)
    errors = [c.error for c in cands if c.error]
    if alg == "cholinv":
        assert len(errors) == 4 and all("bogus" in e for e in errors)
    else:
        assert not errors
    _check_same(cands, jcands)
    if alg == "eigh":
        for c, j in zip(cands, jcands):
            assert max(c.costs["residual"], j.costs["residual"]) < 1e-5


def test_default_space_matches_jax(tmp_path):
    """The default cholinv space (bc_mult 0-2 at both precisions), and the
    tables it writes against the JAX tuner's."""
    a = _spd(256, 4)
    jax.clear_caches()
    jcands = jtune.sweep_cholinv(_jgrid(), jnp.asarray(a), num_iter=1)
    cands = tune.sweep_cholinv(_grid(), torch.from_numpy(a), num_iter=1)
    assert len(cands) == 6
    _check_same(cands, jcands)

    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    tune.write_tables(cands, mine)
    jtune.write_tables(jcands, theirs)
    for suffix in TABLES:
        with open(mine + suffix) as f:
            lines = f.read().splitlines()
        assert len(lines) == len(cands) + (suffix != ".jsonl"), suffix
        if suffix == ".jsonl":
            rec = [json.loads(x) for x in lines]
            assert [r["params"] for r in rec] == [c.params for c in cands]
            assert {"gflop", "link_mib", "msgs", "time_s",
                    "model_time_s"} <= set(rec[0])
            continue
        with open(theirs + suffix) as f:
            head_j = f.readline().split()
        assert lines[0].split() == [h.replace("ICI", "link")
                                    for h in head_j], suffix
        assert all(len(x.split()) == len(head_j) for x in lines[1:]), suffix


def test_main_on_the_cpu(tmp_path, capsys, monkeypatch):
    """main on one CPU device writes the five tables and prints the best
    candidate; a grid shape of more devices than one raises ValueError
    (it is never moved elsewhere); one device sweeps the (square, 1, 1)
    grid alone, as the JAX package's grid_candidates gives it; the
    command line prints each candidate error and exits 1 when any
    candidate failed."""
    import runpy
    import sys
    import warnings

    from capital_tpu_torch.algs import cholinv

    prefix = str(tmp_path / "cholinv")
    cands = tune.main(["--device", "cpu", "--n", "256", "--num-iter", "1",
                       "--prefix", prefix])
    assert len(cands) == 6 and not [c.error for c in cands if c.error]
    best = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert best["best"] == tune.best(cands).params
    assert (best["candidates"], best["errors"]) == (6, 0)
    for suffix in TABLES:
        assert os.path.exists(prefix + suffix), suffix
    for argv in (["--grid", "square:1:2"], ["--grid", "square:2:1"],
                 ["--grid", "rect:2"]):
        with pytest.raises(ValueError, match="needs"):
            tune.main(["--device", "cpu", "--n", "128"] + argv)

    for p in (1, 2, 3):
        assert tune.grid_candidates(["cpu"] * p) == [("square", 1, 1)] == \
            jtune.grid_candidates(jax.devices("cpu")[:p])
    cands = tune.sweep_grids("cholinv", n=128, num_iter=1, devices=["cpu"],
                             space={"bc_mult": [0], "precision": ["highest"]})
    assert [c.params for c in cands] == [
        {"grid": "square-c1x1x1", "devices": 1, "bc_mult": 0,
         "precision": "highest"}]
    assert cands[0].error is None and cands[0].time_s > 0

    def refuse(*args, **kwargs):
        raise ValueError("refused")

    monkeypatch.setattr(cholinv, "Config", refuse)
    monkeypatch.setattr(sys, "argv", [
        "tune", "--device", "cpu", "--n", "128", "--num-iter", "1",
        "--prefix", prefix])
    with warnings.catch_warnings(), pytest.raises(SystemExit) as ex:
        warnings.simplefilter("ignore", RuntimeWarning)
        runpy.run_module("capital_tpu_torch.autotune.tune",
                         run_name="__main__")
    assert ex.value.code == 1
    out = capsys.readouterr()
    assert json.loads(out.out.splitlines()[-1])["errors"] == 6
    assert out.err.count("ValueError: refused") == 6


def test_gram_kernel_axis_on_gpu(monkeypatch):
    """On a 'gpu' grid the cacqr space sweeps both Gram kernels ('dot' and
    the SYRK kernel 'tri'), on 'cpu' 'auto' alone; one device has only the
    1d path. (Here the CPU operand is refused by the card's grid: every
    candidate carries that error.) A candidate records only the errors of
    a config the shape, grid or card's memory cannot take; a fault (a
    kernel that fails to build or launch) propagates out of the sweep
    instead of letting another candidate win."""
    a = torch.zeros(256, 128)
    cands = tune.sweep_cacqr(Grid(device=torch.device("cuda", 0)), a,
                             num_iter=1)
    assert {c.params["gram_kernel"] for c in cands} == {"dot", "tri"}
    assert {c.params["path"] for c in cands} == {"1d"}
    assert len(cands) == 2 * 3 * 2 * 2
    assert all("grid on cuda:0" in c.error for c in cands)
    cands = tune.sweep_cacqr(_grid(), torch.from_numpy(
        _operands()["cacqr"]), num_iter=1)
    assert {c.params["gram_kernel"] for c in cands} == {"auto"}
    assert len(cands) == 3 * 2 * 2
    assert not [c.error for c in cands if c.error]

    from capital_tpu_torch.algs import cholinv

    spd = torch.from_numpy(_spd(128, 5))
    space = {"bc_mult": [0], "precision": ["highest"]}
    for exc, recorded in (
            (ValueError("bad bc"), True), (TypeError("bad dtype"), True),
            (NotImplementedError("M9b"), True),
            (torch.cuda.OutOfMemoryError("out of memory"), True),
            (RuntimeError("CUDA error 700: an illegal memory access"), False)):
        def fail(*args, exc=exc, **kwargs):
            raise exc

        monkeypatch.setattr(cholinv, "factor", fail)
        if recorded:
            (cand,) = tune.sweep_cholinv(_grid(), spd, space, num_iter=1)
            assert cand.error == f"{type(exc).__name__}: {exc}"
        else:
            with pytest.raises(RuntimeError, match="illegal memory access"):
                tune.sweep_cholinv(_grid(), spd, space, num_iter=1)
