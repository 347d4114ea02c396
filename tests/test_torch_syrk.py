"""Port's triangle Gram kernel (plain version of csrc/syrk_upper.cu) vs the
JAX Pallas kernel in interpret mode, on the same small schedule
(t = mc = 128), including a window and a contraction long enough for the
two-level fold to fire (more than 32 row chunks).

Tolerances are the tile_dot ones: relative Frobenius 1e-6 at
highest/default, 2e-5 at high. The port's G is bitwise symmetric.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.ops.pallas_syrk import syrk_upper as syrk_jax
from capital_tpu_torch.ops import cuda_syrk, cuda_trmm
from capital_tpu_torch.ops.cuda_dot import tile_dot_plain
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(60, setup=120)

torch.set_num_threads(1)

TOL = {"highest": 1e-6, "high": 2e-5, "default": 1e-6}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("CAPITAL_TRMM_METHOD", "CAPITAL_SYRK_METHOD",
                "CAPITAL_CHOL_METHOD"):
        monkeypatch.delenv(var, raising=False)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _data(seed, shape):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, shape).astype(
        np.float32)


@pytest.mark.parametrize("level", ["highest", "high", "default"])
@pytest.mark.parametrize("m", [512, 33 * 128])  # the second folds once
def test_syrk_plain_matches_jax_kernel(m, level):
    a = _data(0, (m, 256))
    want = syrk_jax(jnp.asarray(a), interpret=True, t=128, mc=128,
                    matmul_precision=level)
    got = cuda_syrk.syrk_upper_plain(torch.from_numpy(a), prec=level, t=128,
                                     mc=128)
    assert got.dtype == torch.float32
    assert torch.equal(got, got.T)
    assert _rel(got.numpy(), want) < TOL[level]


def test_syrk_window_matches_jax_kernel():
    big = _data(1, (640, 512))
    aw = (128, 128, 384, 256)
    want = syrk_jax(jnp.asarray(big), interpret=True, t=128, mc=128,
                    a_window=aw)
    view = cuda_trmm.window(torch.from_numpy(big), aw)
    got = cuda_syrk.syrk_upper_plain(view, t=128, mc=128)
    assert torch.equal(got, got.T)
    assert _rel(got.numpy(), want) < TOL["highest"]
    # the wrapper reads the same window in place, on its own schedule
    assert torch.equal(cuda_syrk.syrk_upper(torch.from_numpy(big),
                                            a_window=aw),
                       cuda_syrk.syrk_upper_plain(view))


def test_syrk_fold_changes_the_summation_order():
    """The fold is part of the schedule: on a contraction of 33 chunks the
    plain version's result differs (in the last bits) from one long sum,
    and the JAX kernel's folded sum is the one it matches bitwise-closely."""
    a = _data(2, (33 * 128, 128)) * 1e3
    folded = cuda_syrk.syrk_upper_plain(torch.from_numpy(a), t=128, mc=128)
    long_sum = cuda_syrk.syrk_upper_plain(torch.from_numpy(a), t=128,
                                          mc=33 * 128)
    want = np.asarray(syrk_jax(jnp.asarray(a), interpret=True, t=128,
                               mc=128))
    assert not torch.equal(folded, long_sum)
    assert _rel(folded.numpy(), want) <= _rel(long_sum.numpy(), want)


def test_syrk_ragged_and_bf16():
    a = _data(3, (300, 200))
    got = cuda_syrk.syrk_upper(torch.from_numpy(a))
    want = a.astype(np.float64).T @ a
    assert torch.equal(got, got.T)
    assert _rel(got.numpy(), want) < 1e-6
    ab = torch.from_numpy(a).bfloat16()
    gb = cuda_syrk.syrk_upper(ab, out_dtype=torch.bfloat16)
    assert gb.dtype == torch.bfloat16 and torch.equal(gb, gb.T)
    ref = ab.double().T @ ab.double()
    assert _rel(gb.float().numpy(), ref.numpy()) < 1e-2


@pytest.mark.parametrize("level", ["highest", "high", "default"])
@pytest.mark.parametrize("shape,aw", [((640, 512), (128, 128, 384, 256)),
                                      ((700, 333), (3, 5, 601, 201))])
def test_syrk_wrapper_cpu_route(shape, aw, level):
    """On a CPU tensor the wrapper is the plain version on the window it
    reads in place, at every level, on an aligned and a ragged window."""
    big = torch.from_numpy(_data(5, shape))
    got = cuda_syrk.syrk_upper(big, a_window=aw, matmul_precision=level)
    want = cuda_syrk.syrk_upper_plain(cuda_trmm.window(big, aw), prec=level)
    assert torch.equal(got, want) and torch.equal(got, got.T)


def _unsplit_schedule(a, t, mc):
    """syrk_upper_plain as it was before row splits, kept as the reference
    that one split must equal bit for bit."""
    m, n = a.shape
    nc = -(-m // mc)
    g = torch.zeros((n, n), dtype=torch.float32)
    for i0 in range(0, n, t):
        acc = acc2 = None
        for c in range(nc):
            rows = slice(c * mc, (c + 1) * mc)
            p = tile_dot_plain(a[rows, i0:i0 + t], a[rows, i0:],
                               contract_dim0=True)
            acc = p if acc is None else acc + p
            if (c + 1) % 32 == 0 and c != nc - 1:
                acc2 = acc if acc2 is None else acc2 + acc
                acc = None
        g[i0:i0 + t, i0:] = acc if acc2 is None else acc2 + acc
    return torch.triu(g) + torch.triu(g, 1).T


@pytest.mark.parametrize("case", ["one_split", "unit_splits", "jax",
                                  "split_count"])
def test_syrk_row_splits(case):
    """Row splits at 'highest' (t = mc = 128, so a fold is 4096 rows):
    one split is the schedule without splits bit for bit, as are splits of
    one fold each (the partials add in the order the folds did); splits of
    several folds match the JAX kernel as the unsplit schedule does; G is
    bitwise symmetric. The split count is 1 where the tiles fill the
    card's waves, more for tall, narrow operands, never more than the
    folds (or chunks), and leaves no split empty."""
    if case == "split_count":
        count = cuda_syrk.split_count
        assert count(16384, 16384, 132) == 1     # 8256 tiles
        assert count(8192, 8192, 132) == 1       # eigh's Gram, 2080 tiles
        assert count(2 ** 20, 1024, 132) == 11   # 36 tiles: 3 waves of 132
        assert count(2 ** 18, 144, 132) == 16    # 3 tiles, 16 folds
        assert count(2 ** 22, 1024, 264) > 1
        assert count(3 * 512, 144, 132) == 3     # one chunk each
        assert count(512, 144, 264) == 1
        for m in (1, 511, 513, 16385, 40000, 2 ** 22):
            s = count(m, 128, 132)
            units = -(-m // (32 * 512 if m > 32 * 512 else 512))
            rows = cuda_syrk.split_rows(m, s)
            assert 1 <= s <= units and (s - 1) * rows < m <= s * rows
        return
    a = torch.from_numpy(_data(6, (2 * 4096 + 3 * 128 + 5, 256)))
    plain = functools.partial(cuda_syrk.syrk_upper_plain, t=128, mc=128)
    if case == "one_split":
        got = plain(a, splits=1)
        assert torch.equal(got, _unsplit_schedule(a, 128, 128))
    elif case == "unit_splits":
        got = plain(a, splits=3)
        assert cuda_syrk.split_rows(a.shape[0], 3, 128) == 4096
        assert torch.equal(got, plain(a))
    else:
        tall = torch.from_numpy(_data(7, (5 * 4096 + 300, 128)))
        got = plain(tall, splits=2)  # 3 folds, then 2 and a part
        want = syrk_jax(jnp.asarray(tall.numpy()), interpret=True, t=128,
                        mc=128)
        assert _rel(got.numpy(), want) < TOL["highest"]
        assert not torch.equal(got, plain(tall))
    assert torch.equal(got, got.T)
