"""The LU panel leaf: capital_tpu_torch's getrf_leaf (its plain version on
the CPU) against the JAX package's Pallas kernel in interpret mode, on the
same numpy strip.

The two share one step rule (masked elimination, smallest original row
among |.| ties, product then subtraction), so pj and pivots must be
identical and the factors agree to rounding: max-abs 1e-5 x the factor's
scale, the Pallas tests' own tolerance against LAPACK.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.ops.pallas_getrf import getrf_leaf_pallas
from capital_tpu_torch.ops import counters, reset_counters
from capital_tpu_torch.ops.cuda_getrf import (RES_MAX_BLOCKS, RES_STATIC_SMEM,
                                              RES_THREADS, getrf_leaf,
                                              getrf_leaf_plain, plan)
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(60, setup=120)

torch.set_num_threads(1)


def _strip(mm, ib, seed):
    return np.random.default_rng(seed).standard_normal(
        (mm, ib)).astype(np.float32)


def _zero_pivot(mm=128, ib=16):
    a = _strip(mm, ib, 7)
    a[0, 0] = 0.0
    return a


def _zero_column(mm=128, ib=16):
    a = _strip(mm, ib, 7)
    a[:, 3] = 0.0
    return a


def _ties(mm=512, ib=32):
    """Integer values in {-2, ..., 2}: many equal |.| compete every step,
    so the smallest-row rule decides most pivots."""
    return np.random.default_rng(31).integers(-2, 3, (mm, ib)).astype(
        np.float32)


STRIPS = {
    "256x16": lambda: _strip(256, 16, 272),
    "512x32": lambda: _strip(512, 32, 544),
    "640x24": lambda: _strip(640, 24, 664),
    "ragged_1000x64": lambda: _strip(1000, 64, 1064),
    "zero_pivot": _zero_pivot,
    "zero_column": _zero_column,
    "ties_512x32": _ties,
}


@pytest.mark.parametrize("name", list(STRIPS))
def test_leaf_matches_pallas(name):
    a = STRIPS[name]()
    lu_j, pj_j, piv_j = getrf_leaf_pallas(jnp.asarray(a), interpret=True)
    strip = torch.from_numpy(a.copy())
    lu_t, pj_t, piv_t = getrf_leaf_plain(strip)
    assert lu_t is strip  # factored in place
    np.testing.assert_array_equal(pj_t.numpy(), np.asarray(pj_j))
    np.testing.assert_array_equal(piv_t.numpy(), np.asarray(piv_j))
    lu_j = np.asarray(lu_j)
    scale = np.abs(lu_j).max()
    assert np.abs(lu_t.numpy() - lu_j).max() <= 1e-5 * scale
    assert np.isfinite(lu_t.numpy()).all()
    if name == "zero_pivot":
        assert int(pj_t[0]) != 0


def test_wrapper_on_a_cpu_tensor_is_the_plain_version():
    a = _strip(384, 32, 11)
    reset_counters()
    got = getrf_leaf(torch.from_numpy(a.copy()))
    want = getrf_leaf_plain(torch.from_numpy(a.copy()))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    used = counters()
    assert used["getrf_leaf"] == 0 and used["leaf_plain"] == 0
    # and P A = L U holds in its own right
    w64 = got[0].double().numpy()
    l = np.tril(w64, -1) + np.eye(384, 32)
    u = np.triu(w64[:32])
    pa = a.astype(np.float64)[got[1].numpy()]
    assert np.linalg.norm(l @ u - pa) / np.linalg.norm(pa) < 1e-6


def test_leaf_works_on_a_strided_window():
    """The panel hands the leaf a window of the workspace (row stride > ib):
    it is factored in place and the columns beside it are untouched."""
    a = _strip(300, 96, 5)
    w = torch.from_numpy(a.copy())
    want = getrf_leaf_plain(torch.from_numpy(a[40:, 20:52].copy()))
    got = getrf_leaf(w[40:, 20:52])
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert torch.equal(w[40:, 20:52], want[0])
    assert torch.equal(w[:40], torch.from_numpy(a[:40]))
    assert torch.equal(w[:, :20], torch.from_numpy(a[:, :20]))
    assert torch.equal(w[:, 52:], torch.from_numpy(a[:, 52:]))


def test_leaf_with_a_nan_follows_the_rank_rule():
    """A NaN ranks below every number (and above a done row). The Pallas
    kernel reads a column as a masked sum over the strip, so one NaN
    anywhere turns every column's max into NaN and its pivots into 0;
    it is held only where it still sees numbers: a NaN in the last
    column is read by the last step alone, so steps 0..ib-2 match the
    Pallas kernel on the strip with that NaN set to 0, and the last pivot
    is the largest |.| among the numbers left."""
    mm, ib, nan_row = 256, 16, 40
    a = _strip(mm, ib, 57)
    a[nan_row, ib - 1] = np.nan
    clean = a.copy()
    clean[nan_row, ib - 1] = 0.0
    lu_j, pj_j, piv_j = getrf_leaf_pallas(jnp.asarray(clean), interpret=True)
    lu_t, pj_t, piv_t = getrf_leaf_plain(torch.from_numpy(a.copy()))
    np.testing.assert_array_equal(piv_t.numpy()[:-1], np.asarray(piv_j)[:-1])
    np.testing.assert_array_equal(pj_t.numpy()[:ib - 1],
                                  np.asarray(pj_j)[:ib - 1])
    lu_j = np.asarray(lu_j)
    scale = np.abs(lu_j).max()
    assert np.abs(lu_t.numpy()[:, :ib - 1] - lu_j[:, :ib - 1]).max() \
        <= 1e-5 * scale
    # the NaN row pivoted at no earlier step (else its NaN would be in u);
    # at the last one it loses to every number: the live rows' multipliers
    # all have |l| <= 1 but its own, which is NaN
    assert nan_row not in pj_t.numpy()[:ib].tolist()
    tail = lu_t.numpy()[ib:, ib - 1]
    nan_at = np.flatnonzero(np.isnan(tail))
    assert pj_t.numpy()[ib + nan_at].tolist() == [nan_row]
    assert np.abs(np.delete(tail, nan_at)).max() <= 1.0


# heights of the LU paths' leaves and one past the grid's shared memory,
# at ib = 128 on a card with 132 SMs and 227 KB (232448 bytes) a block
PLANS = {
    128: ("resident", 4, 32, 16, 144),
    2048: ("resident", 64, 32, 16, 144),
    17792: ("resident", 132, 135, 2, 130),
    32768: ("resident", 132, 249, 2, 130),
    58476: ("resident", 132, 443, 1, 129),
    58477: ("tall", 0, 0, 0, 0),
    65536: ("tall", 0, 0, 0, 0),
}


@pytest.mark.parametrize("mm", list(PLANS))
def test_route_and_grid_by_height(mm):
    got = plan(mm, 128, 132, 232448)
    assert got[:5] == PLANS[mm]
    if got.route == "resident":
        assert got.blocks * got.rows_per >= mm > (got.blocks - 1) * \
            got.rows_per
        assert got.smem + RES_STATIC_SMEM <= 232448
        assert got.pitch % 32 == got.split % 32 and got.pitch >= 128
        assert RES_THREADS // got.split >= got.rows_per or got.split == 1


def test_route_is_a_function_of_its_inputs():
    """Narrower strips fit more rows; fewer SMs or less shared memory push
    a strip to the tall route; no grid is larger than one warp polls."""
    assert plan(65536, 64, 132, 232448).route == "resident"
    assert plan(32768, 128, 66, 232448).route == "tall"
    assert plan(32768, 128, 132, 100_000).route == "tall"
    assert plan(32768, 128, 200, 232448).blocks <= RES_MAX_BLOCKS


@pytest.mark.parametrize("shape", [(8, 16), (16,)])
def test_leaf_refuses_a_wide_or_flat_strip(shape):
    with pytest.raises(ValueError, match="mm >= ib"):
        getrf_leaf(torch.zeros(shape))
