"""Port's triangle TRMM (plain version of csrc/trmm_upper.cu) vs the JAX
Pallas kernel in interpret mode, on the same small schedule (t = mc = 128).

On a CPU tensor `cuda_trmm.trmm_upper` runs `trmm_upper_plain`; the CUDA
kernel itself is held against that plain version on the card by
chip_smoke.py. Tolerances are the tile_dot ones (tests/test_torch_dot.py):
relative Frobenius 1e-6 at highest/default, 2e-5 at high.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.ops import blas as jblas
from capital_tpu.ops import pallas_trmm
from capital_tpu.ops.pallas_trmm import trmm_upper as trmm_jax
from capital_tpu_torch.ops import blas, cuda_trmm

torch.set_num_threads(1)

TOL = {"highest": 1e-6, "high": 2e-5, "default": 1e-6}
CASES = [("L", False), ("L", True), ("R", False), ("R", True)]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("CAPITAL_TRMM_METHOD", "CAPITAL_SYRK_METHOD",
                "CAPITAL_CHOL_METHOD"):
        monkeypatch.delenv(var, raising=False)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _data(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.0, 1.0, s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("level", ["highest", "high", "default"])
@pytest.mark.parametrize("side,trans_a", CASES)
def test_trmm_plain_matches_jax_kernel(side, trans_a, level):
    n, m = 384, 256
    u, b = _data(0, (n, n), (n, m) if side == "L" else (m, n))
    want = trmm_jax(jnp.asarray(u), jnp.asarray(b), side=side,
                    trans_a=trans_a, interpret=True, t=128, mc=128,
                    matmul_precision=level)
    got = cuda_trmm.trmm_upper_plain(torch.from_numpy(u),
                                     torch.from_numpy(b), side=side,
                                     trans_a=trans_a, prec=level, t=128)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < TOL[level]


@pytest.mark.parametrize("side,trans_a", CASES)
def test_trmm_windows_match_jax_kernel(side, trans_a):
    """Tile-aligned windows of larger arrays (cholinv's workspace views)."""
    n, m = 256, 128
    big_u, big_b = _data(1, (512, 512), (512, 640))
    # lower garbage in U must not leak in: only the triangle is read
    big_u += 1e6 * np.tril(np.ones_like(big_u), -1)
    uw = (128, 256, n)
    bw = (128, 384, n, m) if side == "L" else (256, 128, m, n)
    want = trmm_jax(jnp.asarray(big_u), jnp.asarray(big_b), side=side,
                    trans_a=trans_a, interpret=True, t=128, mc=128,
                    u_window=uw, b_window=bw)
    got = cuda_trmm.trmm_upper(torch.from_numpy(big_u),
                               torch.from_numpy(big_b), side=side,
                               trans_a=trans_a, u_window=uw, b_window=bw)
    assert _rel(got.numpy(), want) < TOL["highest"]


@pytest.mark.parametrize("dtype,alpha", [("float32", -2.0),
                                         ("bfloat16", 0.3)])
def test_trmm_alpha_and_ragged_shape(dtype, alpha, monkeypatch):
    """alpha scales the product; a shape that is not a multiple of the tile
    runs the same schedule with a short last tile. A power of two is
    fused into the kernel; any other alpha scales the product after its
    rounding to B's dtype, as the JAX package's blas.trmm does (alpha
    rounded to bf16, the product rounded once more)."""
    n, m = 200, 72
    u, b = _data(2, (n, n), (n, m))
    tu, tb = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (u, b))
    got = blas.trmm(tu, tb, alpha=alpha, method="tri")
    assert got.dtype == tb.dtype
    if dtype == "float32":
        want = alpha * np.triu(u).astype(np.float64) @ b
        assert _rel(got.numpy(), want) < 1e-6
        return
    one = blas.trmm(tu, tb, alpha=1.0, method="tri")
    reference_way = np.asarray(alpha * jnp.asarray(one.float().numpy(),
                                                   jnp.bfloat16), np.float32)
    assert np.array_equal(got.float().numpy(), reference_way)
    # the kernel's own order (alpha before the rounding) differs here
    fused = cuda_trmm.trmm_upper(tu, tb, alpha=alpha)
    assert not torch.equal(fused, got)
    monkeypatch.setattr(pallas_trmm, "trmm_upper", functools.partial(
        pallas_trmm.trmm_upper, interpret=True, t=128, mc=128))
    want = jblas.trmm(jnp.asarray(u, jnp.bfloat16),
                      jnp.asarray(b, jnp.bfloat16), alpha=alpha,
                      method="tri")
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) < 1e-2


def test_trmm_bf16_one_pass():
    n, m = 256, 128
    u, b = _data(3, (n, n), (m, n))
    ub, bb = jnp.asarray(u, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = trmm_jax(ub, bb, side="R", interpret=True, t=128, mc=128)
    got = cuda_trmm.trmm_upper(torch.from_numpy(u).bfloat16(),
                               torch.from_numpy(b).bfloat16(), side="R")
    assert got.dtype == torch.bfloat16
    # both sum bf16 products in f32 and round the result to bf16 once
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) < 1e-2


def test_trmm_rejects_mismatched_shapes():
    u, b = _data(4, (128, 128), (96, 64))
    with pytest.raises(ValueError):
        cuda_trmm.trmm_upper(torch.from_numpy(u), torch.from_numpy(b))
    with pytest.raises(ValueError):
        cuda_trmm.trmm_upper(torch.from_numpy(u), torch.from_numpy(b),
                             b_window=(0, 0, 128, 128))
