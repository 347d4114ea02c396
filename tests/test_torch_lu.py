"""The port's LU slice end to end: capital_tpu_torch's lu.factor /
solve / slogdet against the JAX package's on a one-device grid, from the
same numpy operand, with the CAPITAL_LU_* switches set the same in both.

On the CPU, CAPITAL_LU_PANEL=auto factors each panel with LAPACK in both
packages (lax.linalg.lu / torch.linalg.lu_factor); =jax runs the
recursive panel, whose leaves are the JAX package's masked fori_loop and
the port's getrf_leaf (its plain version on the CPU).

Tolerances. perm and sign must be identical. w: the L part (|l| <= 1) to
atol 2e-4, the JAX package's own tolerance between two of its schedules
(tests/test_lu.py); the U part to 1e-4 x max|w|, because U's entries grow
with n (|U| ~ 50 at n = 384) and an f32 rounding gap in another summation
order grows with them: on the 384 case the JAX package's two panel routes
differ from each other by 1.4e-3 (2.7e-5 x max|w|), the port from either
by at most 1.35e-3. Both residuals ||PA - LU|| / ||A|| < 5e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from capital_tpu import tracing as jtracing
from capital_tpu.algs import lu as jlu
from capital_tpu.bench import lu as jbench
from capital_tpu.grid import Grid as JGrid
from capital_tpu_torch import Grid, tracing
from capital_tpu_torch.algs import lu
from capital_tpu_torch.bench import lu as bench_lu
from capital_tpu_torch.ops import counters, reset_counters
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(60, setup=120)

torch.set_num_threads(1)

ENV = ("CAPITAL_LU_PANEL", "CAPITAL_LU_LEAF", "CAPITAL_LU_IB",
       "CAPITAL_LU_WIDE_LEAF", "CAPITAL_LU_SCHUR_MB", "CAPITAL_LU_LOOKAHEAD")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


def _jgrid():
    return JGrid.square(c=1, d=1, devices=jax.devices("cpu")[:1])


def _jit_factor(nb):
    """The JAX package's lu.factor, jitted (its eager recursion dispatches
    op by op and takes several times longer on the CPU); CAPITAL_LU_* are
    read while it traces."""
    return jax.jit(lambda x: jlu.factor(_jgrid(), x, jlu.Config(nb=nb)))


def _cpu():
    return Grid.square(device="cpu")


def _operand(n, seed, zero_pivot=False):
    a = np.random.default_rng(seed).standard_normal((n, n)).astype(
        np.float32)
    if zero_pivot:
        a[0, 0] = 0.0
    return a


def _residual(a, w, perm):
    w = np.asarray(w, np.float64)
    n = w.shape[0]
    l = np.tril(w, -1) + np.eye(n)
    pa = np.asarray(a, np.float64)[np.asarray(perm)]
    return np.linalg.norm(pa - l @ np.triu(w)) / np.linalg.norm(a)


def _close(w, w_j):
    w, w_j = np.asarray(w, np.float64), np.asarray(w_j, np.float64)
    d = np.abs(w - w_j)
    return (np.tril(d, -1).max(initial=0) <= 2e-4
            and np.triu(d).max() <= 1e-4 * np.abs(w_j).max())


# (n, nb, seed, zero_pivot, env); CAPITAL_LU_IB=16 gives eight leaves per
# 128-wide panel, so the recursion's takes and composed permutations run
# several levels deep
CASES = {
    f"{n}_{nb}_{panel}_la{la}": (n, nb, n, False,
                                 {"CAPITAL_LU_PANEL": panel,
                                  "CAPITAL_LU_LOOKAHEAD": la})
    for n, nb in ((384, 128), (192, 64)) for panel in ("auto", "jax")
    for la in ("0", "1")}
CASES.update({
    "zero_pivot_auto": (128, 32, 3, True, {}),
    "zero_pivot_jax": (128, 32, 3, True, {"CAPITAL_LU_PANEL": "jax"}),
    "single_panel_auto": (128, 512, 6, False, {}),
    "single_panel_jax": (128, 512, 6, False, {"CAPITAL_LU_PANEL": "jax"}),
    "deep_recursion": (256, 128, 8, False, {"CAPITAL_LU_PANEL": "jax",
                                            "CAPITAL_LU_IB": "16"}),
})


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    n, nb, seed, zp, env = CASES[name]
    a = _operand(n, seed, zp)
    with pytest.MonkeyPatch.context() as mp:
        R.setenv(mp, **env)
        w, perm, sign = _jit_factor(nb)(jnp.asarray(a))
    return a, np.asarray(w), np.asarray(perm), float(sign)


@pytest.mark.parametrize("name", list(CASES))
def test_factor_matches_jax(name, monkeypatch):
    n, nb, _, zp, env = CASES[name]
    a, w_j, perm_j, sign_j = _jax_case(name)
    R.setenv(monkeypatch, **env)
    at = torch.from_numpy(a.copy())
    reset_counters()
    w, perm, sign = lu.factor(_cpu(), at, lu.Config(nb=nb))
    used = counters()
    assert torch.equal(at, torch.from_numpy(a))  # A is left as it was
    np.testing.assert_array_equal(perm.numpy(), perm_j)
    assert float(sign) == sign_j
    assert _close(w.numpy(), w_j)
    assert _residual(a, w, perm) < 5e-6 and _residual(a, w_j, perm_j) < 5e-6
    num_p = n // lu.Config(nb=nb).panel(_cpu(), n)
    if env.get("CAPITAL_LU_PANEL") == "jax":
        assert used["lu_library"] == 0
    else:
        assert used["lu_library"] == num_p
    assert used["getrf_leaf"] == used["leaf_plain"] == 0  # CPU tensors
    if zp:
        assert int(perm[0]) != 0


def test_plain_leaf_on_request_is_counted(monkeypatch):
    """CAPITAL_LU_LEAF=jax sends every leaf to the plain version and counts
    it; the count is the recursion's leaf count (lu.leaves), which
    chip_smoke.py holds the kernel's launches to on the card."""
    R.setenv(monkeypatch, CAPITAL_LU_PANEL="jax")
    n, nb = 256, 128
    a = torch.from_numpy(_operand(n, 1))
    w0, p0, _ = lu.factor(_cpu(), a, lu.Config(nb=nb))
    R.setenv(monkeypatch, CAPITAL_LU_LEAF="jax")
    reset_counters()
    w1, p1, _ = lu.factor(_cpu(), a, lu.Config(nb=nb))
    lw = lu.leaf_width(on_card=False)
    assert lw == 64
    assert counters()["leaf_plain"] == (n // nb) * lu.leaves(nb, lw) == 4
    assert torch.equal(p0, p1) and torch.equal(w0, w1)


def test_leaf_width_on_the_card():
    assert lu.leaf_width(on_card=True) == 128
    assert lu.leaves(2048, 128) == 16 and lu.leaves(1024, 128) == 8
    assert lu.leaves(192, 64) == 3 and lu.leaves(64, 64) == 1


def test_leaf_width_switches(monkeypatch):
    R.setenv(monkeypatch, CAPITAL_LU_WIDE_LEAF="0")
    assert lu.leaf_width(on_card=True) == 64
    R.setenv(monkeypatch, CAPITAL_LU_IB="32")
    assert lu.leaf_width(on_card=True) == 32
    assert lu.leaf_width(on_card=False) == 32


@pytest.mark.parametrize("panel", ["auto", "jax"])
def test_bf16_factors_in_f32(panel, monkeypatch):
    R.setenv(monkeypatch, CAPITAL_LU_PANEL=panel)
    a = _operand(128, 2)
    w, perm, _ = lu.factor(_cpu(), torch.from_numpy(a).bfloat16(),
                           lu.Config(nb=64))
    assert w.dtype == torch.bfloat16
    assert np.array_equal(np.sort(perm.numpy()), np.arange(128))
    a16 = torch.from_numpy(a).bfloat16().float().numpy()
    assert _residual(a16, w.float(), perm) < 5e-2


def test_slogdet_matches_jax_and_numpy():
    a = _operand(192, 4)
    s_j, ld_j = jax.jit(lambda x: jlu.slogdet(_jgrid(), x, jlu.Config(
        nb=64)))(jnp.asarray(a))
    s, ld = lu.slogdet(_cpu(), torch.from_numpy(a), lu.Config(nb=64))
    s_ref, ld_ref = np.linalg.slogdet(a.astype(np.float64))
    assert float(s) == float(s_j) == s_ref
    assert float(ld) == pytest.approx(ld_ref, rel=1e-4)
    assert float(ld) == pytest.approx(float(ld_j), rel=1e-5)


def test_library_panel_factors_a_singular_matrix_as_jax():
    """lapack.lu factors a singular matrix with a zero pivot and no error,
    as lax.linalg.lu does (an operand zero-padded to the grid's tiles is
    singular: the tuner's LU sweep at n = 128 on a 2 x 2 slice)."""
    from capital_tpu_torch.ops import lapack

    a = _operand(128, 6)
    a[:, 64:] = 0.0
    lu_, piv, perm = lapack.lu(torch.from_numpy(a))
    jlu_, jpiv, jperm = jax.lax.linalg.lu(jnp.asarray(a))
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_allclose(lu_.numpy(), np.asarray(jlu_), atol=1e-5)
    assert not np.diag(lu_.numpy())[64:].any()


@pytest.mark.parametrize("k", [None, 8])
def test_solve_with_refinement(k):
    """A 1-D b gives a 1-D x; two refinement sweeps reach 1e-5."""
    from capital_tpu_torch.ops.precision import dot

    n = 256
    a = torch.from_numpy(_operand(n, 2))
    shape = (n,) if k is None else (n, k)
    b = torch.from_numpy(np.random.default_rng(7).standard_normal(
        shape).astype(np.float32))
    grid = _cpu()
    w, perm, _ = lu.factor(grid, a, lu.Config(nb=64))
    x = lu.solve_factored(grid, w, perm, b)
    for _ in range(2):
        r = b - dot(a, x.reshape(n, -1)).reshape(b.shape)
        x = x + lu.solve_factored(grid, w, perm, r)
    assert x.shape == b.shape
    res = torch.linalg.norm(a.double() @ x.double() - b.double()) \
        / torch.linalg.norm(b.double())
    assert float(res) < 1e-5
    x1 = lu.solve(grid, a, b, lu.Config(nb=64))
    assert x1.shape == b.shape


def test_f64_route_matches_jax():
    a = np.random.default_rng(0).standard_normal((256, 256))
    with jax.enable_x64():
        w_j, perm_j, _ = _jit_factor(64)(jnp.asarray(a))
        perm_j = np.asarray(perm_j)
    for panel in ("auto", "jax"):
        with pytest.MonkeyPatch.context() as mp:
            R.setenv(mp, CAPITAL_LU_PANEL=panel)
            w, perm, _ = lu.factor(_cpu(), torch.from_numpy(a),
                                   lu.Config(nb=64))
        assert w.dtype == torch.float64
        np.testing.assert_array_equal(perm.numpy(), perm_j)
        assert _residual(a, w, perm) < 1e-14


def test_cost_trace_matches_jax():
    """The analytic cost table (phases LU::panel/swap/trsm/schur) is the
    JAX package's, phase by phase."""
    n, nb = 256, 64
    a = _operand(n, 5)
    with jtracing.trace() as jt:
        jax.eval_shape(lambda x: jlu.factor(_jgrid(), x, jlu.Config(nb=nb)),
                       jnp.asarray(a))
    with tracing.trace() as t:
        lu.factor(_cpu(), torch.from_numpy(a), lu.Config(nb=nb))
    want = {k: dataclasses.astuple(v) for k, v in jt.by_phase.items()}
    got = {k: dataclasses.astuple(v) for k, v in t.by_phase.items()}
    assert got == want
    assert {k.split("/")[0] for k in got} >= {
        "LU::panel", "LU::swap", "LU::trsm", "LU::schur"}


def test_bench_driver_on_cpu(capsys):
    rec = bench_lu.main(["--device", "cpu", "--n", "128", "--nb", "64",
                         "--solve-k", "4", "--json", "--num-iter", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rec["bench"] == "lu_n128" and rec["device"] == "cpu"
    assert rec["residual"] < 1e-5
    assert '"bench": "lu_solve_n128"' in lines[-1]


@pytest.mark.parametrize("flag", [["--layout", "1"], ["--summa-impl", "ring"],
                                  ["--donate"]])
def test_bench_driver_refuses_flags_without_effect(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        bench_lu.main(["--device", "cpu", "--n", "128"] + flag)
    assert exc.value.code == 2
    assert flag[0] in capsys.readouterr().err


def test_chunked_residual_matches_dense():
    """The bench's row-slab ||PA - LU|| agrees with the dense formula as
    the JAX package's does (the same bound as tests/test_lu.py), and with
    the JAX package's chunked validator on the same factors."""
    n = 512
    a = _operand(n, 9)
    grid = _cpu()
    at = torch.from_numpy(a)
    w, perm, _ = lu.factor(grid, at, lu.Config(nb=128))
    l, u = lu.unpack(w)
    dense = float(torch.linalg.norm(at[perm.long()] - l @ u))
    chunked = float(bench_lu._chunked_residual(grid, w, perm, at,
                                               chunk=128))
    assert abs(dense - chunked) / dense < 0.3
    chunked_j = float(jbench._chunked_residual(
        _jgrid(), jnp.asarray(w.numpy()), jnp.asarray(perm.numpy()),
        jnp.asarray(a), chunk=128))
    assert chunked == pytest.approx(chunked_j, rel=0.3)


def test_factor_refuses_an_operand_off_the_grid_device():
    grid = Grid(device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="grid on cuda:0"):
        lu.factor(grid, torch.eye(128), lu.Config(nb=64))
