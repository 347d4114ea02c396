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
from capital_tpu_torch.ops.cuda_getrf import getrf_leaf, getrf_leaf_plain

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


STRIPS = {
    "256x16": lambda: _strip(256, 16, 272),
    "512x32": lambda: _strip(512, 32, 544),
    "640x24": lambda: _strip(640, 24, 664),
    "ragged_1000x64": lambda: _strip(1000, 64, 1064),
    "zero_pivot": _zero_pivot,
    "zero_column": _zero_column,
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


@pytest.mark.parametrize("shape", [(8, 16), (16,)])
def test_leaf_refuses_a_wide_or_flat_strip(shape):
    with pytest.raises(ValueError, match="mm >= ib"):
        getrf_leaf(torch.zeros(shape))
