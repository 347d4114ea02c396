"""Port's fused leaf (plain version of csrc/chol_inv.cu) vs the JAX Pallas
kernel in interpret mode.

The two are different valid roundings of the same blocked elimination
(the TPU kernel runs full-width slabs, the port only the blocks that are
nonzero), so they are held to the same quality as in
tests/test_pallas_chol.py: residual and inverse residual within 10x / 20x
of JAX's and below 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.ops.pallas_chol import chol_inv_pallas
from capital_tpu_torch.ops import cuda_chol, lapack

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("CAPITAL_TRMM_METHOD", "CAPITAL_SYRK_METHOD",
                "CAPITAL_CHOL_METHOD"):
        monkeypatch.delenv(var, raising=False)


def _spd(n, seed):
    u = np.random.default_rng(seed).uniform(-0.5, 0.5, (n, n))
    return ((u + u.T) * 0.5 + n * np.eye(n)).astype(np.float32)


def _quality(a, r, rinv):
    a64, r64, ri64 = (np.asarray(x, np.float64) for x in (a, r, rinv))
    n = a.shape[0]
    res = np.linalg.norm(r64.T @ r64 - a64) / np.linalg.norm(a64)
    inv = np.linalg.norm(r64 @ ri64 - np.eye(n)) / np.sqrt(n)
    return res, inv


@pytest.mark.parametrize("lower", [False, True])
@pytest.mark.parametrize("n", [128, 256, 512])
def test_leaf_plain_matches_jax_kernel(n, lower):
    a = _spd(n, n)
    rj, rij = (np.asarray(x) for x in chol_inv_pallas(
        jnp.asarray(a), lower=lower, interpret=True))
    rt, rit = (x.numpy() for x in cuda_chol.chol_inv_cuda(
        torch.from_numpy(a), lower=lower))
    if lower:  # (L, Linv) = (R^T, Rinv^T)
        rj, rij, rt, rit = rj.T, rij.T, rt.T, rit.T
    assert np.array_equal(np.tril(rt, -1), np.zeros_like(rt))
    assert np.array_equal(np.tril(rit, -1), np.zeros_like(rit))
    res_j, inv_j = _quality(a, rj, rij)
    res_t, inv_t = _quality(a, rt, rit)
    assert res_t < max(10 * res_j, 1e-7) and res_t < 1e-5, (res_t, res_j)
    assert inv_t < max(20 * inv_j, 1e-7) and inv_t < 1e-5, (inv_t, inv_j)
    # the same elimination in another rounding: far below the 1e-5 bar
    assert np.linalg.norm(rt - rj) / np.linalg.norm(rj) < 1e-6
    assert np.linalg.norm(rit - rij) / np.linalg.norm(rij) < 1e-6


def test_leaf_keeps_dtype_and_pivot_clamp():
    """bf16 storage factors in f32 and returns bf16; a zero pivot is
    clamped (1e-30), so a singular block gives finite numbers."""
    a = torch.from_numpy(_spd(128, 5))
    r, rinv = cuda_chol.chol_inv_cuda(a.bfloat16())
    assert r.dtype == rinv.dtype == torch.bfloat16
    sing = torch.zeros((128, 128))
    sing[0, 0] = 1.0
    r, rinv = cuda_chol.chol_inv_plain(sing)
    assert torch.isfinite(r).all()


@pytest.mark.parametrize("n", [96, 200])
def test_leaf_rejects_unaligned_n(n):
    with pytest.raises(ValueError):
        cuda_chol.chol_inv_cuda(torch.from_numpy(_spd(n, 0)))


def test_chol_inv_dispatch(monkeypatch):
    """'pallas' is the hand-written leaf; 'auto' on a CPU tensor and any
    block the leaf does not take (128 does not divide n, or n > 1024)
    go to 'xla' (torch.linalg), as in the JAX package."""
    a = torch.from_numpy(_spd(256, 1))
    lapack.chol_inv.xla_calls = 0
    cuda_chol.chol_inv_cuda.launches = 0
    r_auto, _ = lapack.chol_inv(a)
    assert lapack.chol_inv.xla_calls == 1
    monkeypatch.setenv("CAPITAL_CHOL_METHOD", "pallas")
    r_leaf, _ = lapack.chol_inv(a)
    assert lapack.chol_inv.xla_calls == 1
    lapack.chol_inv(torch.from_numpy(_spd(200, 2)))
    assert lapack.chol_inv.xla_calls == 2
    assert torch.allclose(r_auto, r_leaf, rtol=1e-5, atol=1e-5)
    assert cuda_chol.chol_inv_cuda.launches == 0  # CPU: plain version
    with pytest.raises(ValueError):
        lapack.chol_inv(a, method="lu")


def test_potrf_trtri_match_chol_inv_xla():
    a = torch.from_numpy(_spd(128, 3))
    r, rinv = lapack.chol_inv_xla(a)
    assert torch.allclose(lapack.potrf(a), r)
    assert torch.allclose(lapack.trtri(r), rinv, rtol=1e-5, atol=1e-6)
    l, linv = lapack.chol_inv_xla(a, lower=True)
    assert torch.allclose(l, r.T) and torch.allclose(linv, rinv.T)
