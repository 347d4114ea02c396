"""The port's block-cyclic workspace (parallel/cyclic.py) and the
cyclic-workspace cholinv (algs/cholinv_cyclic.py) against the JAX
package's, on a one-device grid:

  * `_perm` for d = 1, 2, 4 (pure numpy in both);
  * the layout round trip, the window reads, writes and masks, the
    window products on the same numpy operands (each against numpy, and
    the layout, a mask and the products also against the JAX package's),
    and the window checks;
  * cholinv_cyclic.factor at n = 512, base case 128: R and Rinv within
    relative Frobenius 1e-5 of the JAX package's, both packages'
    cholesky_residual and inverse_residual below 1e-5, the same cost
    table.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu import tracing as jtracing
from capital_tpu import validate as jvalidate
from capital_tpu.algs import cholinv as jcholinv
from capital_tpu.algs import cholinv_cyclic as jcholinv_cyclic
from capital_tpu.grid import Grid as JGrid
from capital_tpu.parallel import cyclic as jcyclic
from capital_tpu_torch import Grid, tracing, validate
from capital_tpu_torch.algs import cholinv, cholinv_cyclic
from capital_tpu_torch.parallel import cyclic
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(60, setup=120)

torch.set_num_threads(1)
TB = 128


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in [v for v in os.environ if v.startswith("CAPITAL_")]:
        monkeypatch.delenv(var)


def _jgrid():
    return JGrid.square(c=1, d=1, devices=jax.devices("cpu")[:1])


def _grid():
    return Grid.square(device="cpu")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_perm_matches_jax():
    for d in (1, 2, 4):
        for n, tb in ((512, 128), (1024, 128), (768, 64), (256, 32)):
            got = cyclic._perm(n, d, tb)
            np.testing.assert_array_equal(got, jcyclic._perm(n, d, tb))
            assert sorted(got) == list(range(n))  # a permutation
            if d == 1:
                np.testing.assert_array_equal(got, np.arange(n))


def test_layout_and_windows():
    """The layout round trip and the window reads, masks and writes: on
    one device the layout is the standard one, so each is its numpy
    counterpart (to_cyclic and the triangle mask also against the JAX
    package's)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((512, 384)).astype(np.float32)
    jg, g = _jgrid(), _grid()
    jx, tx = jnp.asarray(x), torch.from_numpy(x)

    phys = cyclic.to_cyclic(g, tx, tb=TB)
    np.testing.assert_array_equal(phys.numpy(),
                                  np.asarray(jcyclic.to_cyclic(jg, jx, TB)))
    np.testing.assert_array_equal(cyclic.from_cyclic(g, phys, tb=TB).numpy(),
                                  x)
    assert phys.data_ptr() != tx.data_ptr()
    np.testing.assert_array_equal(cyclic.global_rows(g, 512, TB),
                                  jcyclic.global_rows(jg, 512, TB))
    np.testing.assert_array_equal(cyclic.global_cols(g, 384, TB),
                                  np.arange(384))

    got = cyclic.read_window(g, phys, (128, 256, 256, 128), tb=TB)
    np.testing.assert_array_equal(got.numpy(), x[128:384, 256:384])
    got[:] = 0  # a tensor of its own: the workspace is untouched
    np.testing.assert_array_equal(phys.numpy(), x)

    win = (128, 128, 256, 256)
    np.testing.assert_array_equal(
        cyclic.read_window_tri(g, phys, win, uplo="U", tb=TB).numpy(),
        np.asarray(jcyclic.read_window_tri(jg, jx, win, "U", TB)))
    np.testing.assert_array_equal(
        cyclic.read_window_tri(g, phys, win, uplo="L", tb=TB).numpy(),
        np.tril(x[128:384, 128:384]))

    val = rng.standard_normal((128, 256)).astype(np.float32)
    out = cyclic.update_window(g, phys, torch.from_numpy(val),
                               (256, 128, 128, 256), tb=TB)
    assert out is phys  # written in place
    want = x.copy()
    want[256:384, 128:384] = val
    np.testing.assert_array_equal(out.numpy(), want)


def test_window_products_match_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((512, 512)).astype(np.float32)
    jg, g = _jgrid(), _grid()
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    w64 = w.astype(np.float64)
    for chunks in (1, 3):  # 256 is no multiple of 3: 2 chunks
        got = cyclic.gemm_window(g, tw, tw, a_window=(0, 128, 256, 256),
                                 b_window=(128, 0, 256, 256),
                                 num_chunks=chunks, tb=TB)
        want = w64[0:256, 128:384] @ w64[128:384, 0:256]
        assert got.shape == (256, 256) and _rel(got, want) < 1e-6
    u11, a12 = np.triu(w64[:256, :256]), w64[:256, 256:]
    u22 = np.triu(w64[256:, 256:])
    for side, trans, want in (("L", True, -u11.T @ a12),
                              ("R", False, -a12 @ u22)):
        kw = dict(side=side, uplo="U", trans_a=trans, alpha=-1.0,
                  a_window=(0, 0, 256, 256) if side == "L"
                  else (256, 256, 256, 256),
                  b_window=(0, 256, 256, 256), tb=TB)
        got = cyclic.trmm_window(g, tw, tw, **kw)
        assert _rel(got, want) < 1e-6, (side, trans)
        if side == "L":  # the JAX package's on the same windows
            assert _rel(got, jcyclic.trmm_window(jg, jw, jw, **kw)) < 1e-6
    c = rng.standard_normal((256, 256)).astype(np.float32)
    kw = dict(alpha=-1.0, beta=1.0, a_window=(128, 256, 128, 256), tb=TB)
    got = cyclic.syrk_window(g, tw, c=torch.from_numpy(c), **kw)
    want = jcyclic.syrk_window(jg, jw, c=jnp.asarray(c), **kw)
    assert _rel(got, want) < 1e-6
    blk = w64[128:256, 256:]
    assert _rel(got, c - blk.T @ blk) < 1e-6


def test_window_checks_raise_as_in_jax():
    jg, g = _jgrid(), _grid()
    x = np.zeros((512, 512), np.float32)
    for call in (lambda mod, grid, a: mod.read_window(grid, a,
                                                      (64, 0, 128, 128), TB),
                 lambda mod, grid, a: mod.read_window(grid, a,
                                                      (0, 0, 640, 128), TB),
                 lambda mod, grid, a: mod.gemm_window(
                     grid, a, a, a_window=(0, 0, 128, 256),
                     b_window=(0, 0, 128, 128), tb=TB),
                 lambda mod, grid, a: mod.to_cyclic(grid, a[:, :320], TB)):
        with pytest.raises(ValueError):
            call(jcyclic, jg, jnp.asarray(x))
        with pytest.raises(ValueError):
            call(cyclic, g, torch.from_numpy(x))


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.5, 0.5, (n, n))
    return ((u + u.T) / 2 + n * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("complete_inv", [True, False])
def test_cholinv_cyclic_matches_jax(complete_inv):
    n, bc = 512, 128
    a = _spd(n, 5)
    jcfg = jcholinv.Config(min_bc=bc, base_method="xla",
                           complete_inv=complete_inv)
    cfg = cholinv.Config(**{f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(jcfg)
                            if f.name != "base_policy"})
    jg, g = _jgrid(), _grid()
    jax.clear_caches()  # a cold trace records every cost
    with jtracing.trace() as jt:
        jax.eval_shape(lambda x: jcholinv_cyclic.factor(jg, x, jcfg),
                       jnp.asarray(a))
    jr, jrinv = jax.jit(lambda x: jcholinv_cyclic.factor(jg, x, jcfg))(
        jnp.asarray(a))
    ta = torch.from_numpy(a)
    with tracing.trace() as t:
        r, rinv = cholinv_cyclic.factor(g, ta, cfg)
    assert np.array_equal(a, ta.numpy())  # A is left as it was
    assert _rel(r, jr) < 1e-5 and _rel(rinv, jrinv) < 1e-5
    want = {k: dataclasses.astuple(v) for k, v in jt.by_phase.items()}
    got = {k: dataclasses.astuple(v) for k, v in t.by_phase.items()}
    assert got == want
    # the same factor as the block workspace's recursion
    rb, rinvb = cholinv.factor(g, ta, cfg)
    assert _rel(r, rb) < 1e-6
    if complete_inv:
        assert _rel(rinv, rinvb) < 1e-6
        res = [float(validate.cholesky_residual(g, ta, r)),
               float(validate.inverse_residual(g, r, rinv)),
               float(jvalidate.cholesky_residual(jg, jnp.asarray(a), jr)),
               float(jvalidate.inverse_residual(jg, jr, jrinv))]
        assert max(res) < 1e-5, res


def test_cholinv_cyclic_checks():
    g = _grid()
    a = torch.from_numpy(_spd(256, 6))
    with pytest.raises(ValueError, match="grid on cuda:0"):
        cholinv_cyclic.factor(Grid(device=torch.device("cuda", 0)), a)
    # 384 rows on 256-row tiles: the layout cannot hold them
    with pytest.raises(ValueError, match="cyclic layout needs"):
        cholinv_cyclic.factor(g, torch.from_numpy(_spd(384, 7)),
                              cholinv.Config(min_bc=256))
