"""The cholinv validators follow the caller's matmul precision, as the
JAX package's (capital_tpu/validate.py) do: the same factor validated
under 'high' and under 'highest' gives two different residuals, and each
equals the same products written out by hand at that level.

The hand computation is the validator's own formula with the products
taken by ops.precision.dot at an explicit level, so the two agree to
1e-6 relative (the same operations in the same order; the slack covers
the f32 sum of squares).
"""

import functools

import pytest
import torch

from capital_tpu_torch import Grid, matrix, validate
from capital_tpu_torch.algs import cholinv
from capital_tpu_torch.ops.precision import default_matmul_precision, dot
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(60, setup=120)

torch.set_num_threads(1)

N = 512


@functools.lru_cache(maxsize=None)
def _factor():
    grid = Grid.square(device="cpu")
    a = matrix.symmetric(grid, N, 0, align=128)
    with default_matmul_precision("high"):
        r, rinv = cholinv.factor(grid, a, cholinv.Config(complete_inv=True))
    return grid, a.data, r, rinv


def _fro(x):
    return torch.sqrt(torch.sum(torch.square(x.float())))


def _by_hand(a, r, rinv, level):
    rm, rim = torch.triu(r), torch.triu(rinv)
    res = _fro(dot(rm.T, rm, precision=level) - a) / _fro(a)
    eye = torch.eye(N, dtype=r.dtype)
    inv = _fro(dot(rm, rim, precision=level) - eye) / N**0.5
    return float(res), float(inv)


def _validated(grid, a, r, rinv, chunks):
    masked = chunks > 1
    return (float(validate.cholesky_residual(grid, a, r, chunks=chunks,
                                             masked=masked)),
            float(validate.inverse_residual(grid, r, rinv, chunks=chunks,
                                            masked=masked)))


@pytest.mark.parametrize("chunks", [1, 4])
def test_validators_follow_the_callers_precision(chunks):
    grid, a, r, rinv = _factor()
    if chunks > 1:
        r, rinv = torch.triu(r), torch.triu(rinv)
    got = {}
    for level in ("high", "highest"):
        with default_matmul_precision(level):
            got[level] = _validated(grid, a, r, rinv, chunks)
        want = _by_hand(a, r, rinv, level)
        for g, w in zip(got[level], want):
            assert g == pytest.approx(w, rel=1e-6), (level, got, want)
    for hi, hst in zip(got["high"], got["highest"]):
        assert hi != hst, got
    # outside any context the validators run at the framework default
    assert _validated(grid, a, r, rinv, chunks) == got["highest"]
