"""The QR pieces beside CholeskyQR: lapack.geqrf/orgqr/qr against the JAX
package's (batched too), matrix.tall_skinny/debug, and the QR validators
against the same products written out by hand at 'high' and 'highest'.

Two LAPACK builds may choose other reflector signs, so the packed forms
are not compared entry by entry: Q R is held to A, Q^T Q to I and |diag R|
to the JAX package's. The hand-written validator products are the
validators' own formulas with ops.precision.dot at an explicit level, so
the two agree to 1e-6 relative (the slack covers the f32 sum of squares).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu import matrix as jmatrix
from capital_tpu import validate as jvalidate
from capital_tpu.grid import Grid as JGrid
from capital_tpu.ops import lapack as jlapack
from capital_tpu_torch import Grid, matrix, validate
from capital_tpu_torch.ops import lapack
from capital_tpu_torch.ops.precision import default_matmul_precision, dot

torch.set_num_threads(1)


def _jgrid():
    return JGrid.square(c=1, d=1, devices=jax.devices("cpu")[:1])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("shape", [(96, 32), (3, 40, 8)],
                         ids=["2d", "batched"])
def test_qr_matches_jax(shape):
    a = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    m, n = shape[-2:]
    packed, tau = lapack.geqrf(torch.from_numpy(a))
    assert packed.shape == shape and tau.shape == shape[:-2] + (n,)
    jpacked, jtau = jlapack.geqrf(jnp.asarray(a))
    assert jpacked.shape == packed.shape and jtau.shape == tau.shape
    q, r = lapack.qr(torch.from_numpy(a))
    assert q.shape == shape and r.shape == shape[:-2] + (n, n)
    assert torch.equal(q, lapack.orgqr(packed, tau))
    assert torch.equal(r, torch.triu(r))
    eye = np.eye(n)
    assert _rel(q @ r, a) < 1e-5
    assert np.abs((q.mT.double() @ q.double()).numpy() - eye).max() < 1e-5
    jq, jr = jlapack.qr(jnp.asarray(a))
    assert _rel(np.abs(np.diagonal(r, axis1=-2, axis2=-1)),
                np.abs(np.diagonal(np.asarray(jr), axis1=-2, axis2=-1))) < 1e-5
    # Q and R are unique up to the signs of R's rows
    sign = np.sign(np.diagonal(r, axis1=-2, axis2=-1)
                   * np.diagonal(np.asarray(jr), axis1=-2, axis2=-1))
    assert _rel(q.numpy() * sign[..., None, :], jq) < 1e-5
    assert _rel(r.numpy() * sign[..., :, None], jr) < 1e-5


def test_debug_matches_jax():
    m, n = 5, 7
    want = jmatrix.debug(_jgrid(), m, n)
    got = matrix.debug(Grid.square(device="cpu"), m, n)
    assert got.shape == want.shape == (m, n)
    assert got.padded_shape == want.padded_shape
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert got.data[4, 6] == 4 + m * 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tall_skinny(dtype):
    """Shape and padding as the JAX package's (rows padded to the device
    count, columns never); the column scale linspace(1, 2) applied to the
    same uniform draw."""
    grid = Grid.square(device="cpu")
    m, n = 300, 7
    jts = jmatrix.tall_skinny(_jgrid(), m, n, jax.random.key(0))
    ts = matrix.tall_skinny(grid, m, n, 3, dtype=dtype)
    plain = matrix.tall_skinny(grid, m, n, 3, dtype=dtype, col_scale=False)
    assert ts.shape == jts.shape == (m, n)
    assert ts.padded_shape == jts.padded_shape
    assert ts.dtype == dtype
    scale = torch.linspace(1.0, 2.0, n, dtype=dtype)
    assert torch.equal(ts.data, plain.data * scale)
    assert plain.data.abs().max() <= 0.5
    assert torch.equal(ts.data, matrix.tall_skinny(grid, m, n, 3,
                                                   dtype=dtype).data)


@functools.lru_cache(maxsize=None)
def _factored():
    """A graded 2048 x 128 operand and its Householder Q, R."""
    rng = np.random.default_rng(1)
    a = (rng.uniform(-0.5, 0.5, (2048, 128))
         * np.linspace(1.0, 2.0, 128)).astype(np.float32)
    q, r = lapack.qr(torch.from_numpy(a))
    return torch.from_numpy(a), q, r


def _fro(x):
    return torch.sqrt(torch.sum(torch.square(x.float())))


def _by_hand(a, q, r, level):
    n = q.shape[1]
    orth = _fro(dot(q.T, q, precision=level) - torch.eye(n)) / n**0.5
    res = _fro(dot(q, torch.triu(r), precision=level) - a) / _fro(a)
    return float(orth), float(res)


def _validated(a, q, r, layout):
    grid = Grid.square(device="cpu")
    return (float(validate.qr_orthogonality(grid, q, layout=layout)),
            float(validate.qr_residual(grid, a, q, r, layout=layout)))


@pytest.mark.parametrize("layout", ["auto", "1d", "2d"])
def test_qr_validators_follow_the_callers_precision(layout):
    a, q, r = _factored()
    got = {}
    for level in ("high", "highest"):
        with default_matmul_precision(level):
            got[level] = _validated(a, q, r, layout)
        want = _by_hand(a, q, r, level)
        for g, w in zip(got[level], want):
            assert g == pytest.approx(w, rel=1e-6), (level, got, want)
    for hi, hst in zip(got["high"], got["highest"]):
        assert hi != hst, got
    # outside any context the validators run at the framework default
    assert _validated(a, q, r, layout) == got["highest"]


def test_qr_validators_match_jax():
    """At 'highest' both packages read a Householder Q, R as orthogonal
    and exact to f32 rounding, within 2x of each other."""
    a, q, r = _factored()
    grid, jg = Grid.square(device="cpu"), _jgrid()
    got = (float(validate.qr_orthogonality(grid, q)),
           float(validate.qr_residual(grid, a, q, r)))
    want = (float(jvalidate.qr_orthogonality(jg, jnp.asarray(q.numpy()),
                                             layout="1d")),
            float(jvalidate.qr_residual(jg, jnp.asarray(a.numpy()),
                                        jnp.asarray(q.numpy()),
                                        jnp.asarray(r.numpy()), layout="1d")))
    for g, w in zip(got, want):
        assert 0 < g < 1e-5 and w / 2 < g < 2 * w, (got, want)
    with pytest.raises(ValueError, match="layout"):
        validate.qr_orthogonality(grid, q, layout="3d")
