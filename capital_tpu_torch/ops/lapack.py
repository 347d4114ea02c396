"""Local factorization: Cholesky + simultaneous triangular inverse
(counterpart of capital_tpu/ops/lapack.py).

  chol_inv(A) -> (R, Rinv)  with A = R^T R, R upper-triangular.

method:
  * 'xla'    - torch.linalg.cholesky + solve_triangular against I (the
               name is kept so CAPITAL_CHOL_METHOD settings carry over);
  * 'pallas' - the hand-written fused leaf kernel (ops/cuda_chol.py; its
               plain PyTorch version on a CPU tensor). The name is kept
               for the same reason;
  * 'auto'   - CAPITAL_CHOL_METHOD if set, else 'pallas' on a GPU and
               'xla' elsewhere; blocks that are not a multiple of 128 or
               exceed 1024 take 'xla'.

  lu(A) -> (LU, pivots, perm)  partial-pivoting LU, lax.linalg.lu's
            return convention (algs/lu.py's CAPITAL_LU_PANEL=xla and CPU
            panel route).

  geqrf(A) -> (packed, tau), orgqr(packed, tau) -> Q, qr(A) -> (Q, R):
            Householder QR by torch.geqrf / householder_product, as the
            JAX package takes it from XLA's stock QR.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _f32in(x: torch.Tensor) -> torch.Tensor:
    """Low-precision storage factors in f32."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN on and below the diagonal where A is not
    positive definite, as lax.linalg.cholesky returns it
    (torch.linalg.cholesky raises), so a failed factorization reaches the
    caller's finiteness checks. No host sync."""
    L, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full((), float("nan"), dtype=L.dtype,
                                  device=L.device)).tril()


def chol_inv_xla(a: torch.Tensor, lower: bool = False):
    """(R, Rinv) with A = R^T R (upper, default) or (L, Linv), A = L L^T.
    A block that is not positive definite gives NaN factors."""
    dt = a.dtype
    a = _f32in(a)
    L = _cholesky(a)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False, left=True)
    L, Linv = L.to(dt), Linv.to(dt)
    # row-major results: the kernels take operands with unit column stride,
    # whatever layout the library returned
    if lower:
        return L.contiguous(), Linv.contiguous()
    return L.mT.contiguous(), Linv.mT.contiguous()


def potrf(a: torch.Tensor, lower: bool = False) -> torch.Tensor:
    """Cholesky factor only (NaN where A is not positive definite)."""
    L = _cholesky(_f32in(a)).to(a.dtype)
    return (L if lower else L.mT).contiguous()


def trtri(t: torch.Tensor, lower: bool = False) -> torch.Tensor:
    """Triangular inverse."""
    t32 = _f32in(t)
    eye = torch.eye(t32.shape[-1], dtype=t32.dtype, device=t32.device)
    return torch.linalg.solve_triangular(t32, eye, upper=not lower,
                                         left=True).to(t.dtype)


def geqrf(a: torch.Tensor):
    """Householder QR in LAPACK's packed form: (packed, tau), reflectors
    below the diagonal and R on and above it, in A's (m, n) layout.
    Batch dims supported."""
    return torch.geqrf(a)


def orgqr(packed: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """The reduced (m, n) Q with orthonormal columns from geqrf's packed
    reflectors."""
    return torch.linalg.householder_product(packed, tau)


def qr(a: torch.Tensor):
    """Reduced QR through the geqrf/orgqr pair: (Q (m, n), R (n, n)).
    Batch dims supported."""
    packed, tau = geqrf(a)
    n = a.shape[-1]
    return orgqr(packed, tau), torch.triu(packed[..., :n, :])


def chol_inv(a: torch.Tensor, lower: bool = False, method: str = "auto",
             platform: str | None = None):
    """Fused Cholesky + triangular inverse. See module docstring.
    platform: 'gpu'/'cpu' of the grid the call runs on (default: a's)."""
    if method == "auto":
        on_gpu = platform == "gpu" if platform else a.is_cuda
        method = os.environ.get("CAPITAL_CHOL_METHOD") or (
            "pallas" if on_gpu else "xla")
        n = a.shape[-1]
        if method == "pallas" and (n % 128 or n > 1024):
            method = "xla"
    if method == "xla":
        chol_inv.xla_calls += 1
        return chol_inv_xla(a, lower=lower)
    if method == "pallas":
        from capital_tpu_torch.ops.cuda_chol import chol_inv_cuda

        return chol_inv_cuda(a, lower=lower)
    raise ValueError(f"unknown chol_inv method {method!r}")


chol_inv.xla_calls = 0


def lu(a: torch.Tensor):
    """(lu, pivots, perm) of an (m, k) matrix by torch.linalg's getrf:
    lu holds L (unit diagonal implicit) below and U on and above the
    diagonal, row-swapped; pivots (min(m, k),) int32 are 0-based LAPACK
    swap targets; perm (m,) int32 has lu = a[perm]. Low-precision storage
    factors in f32 and is rounded back. A singular matrix factors with a
    zero pivot, as lax.linalg.lu's does (no error)."""
    lu.library_calls += 1
    lu_, piv, _ = torch.linalg.lu_factor_ex(_f32in(a))
    piv = (piv - 1).to(torch.int32)   # LAPACK's are 1-based
    return lu_.to(a.dtype), piv, perm_from_pivots(piv, a.shape[0])


def perm_from_pivots(pivots: torch.Tensor, m: int) -> torch.Tensor:
    """(m,) int32 row permutation of a 0-based LAPACK swap sequence (row i
    swapped with pivots[i], in order), on pivots' device."""
    perm = np.arange(m, dtype=np.int32)
    for i, p in enumerate(pivots.cpu().tolist()):
        perm[i], perm[p] = perm[p], perm[i]
    return torch.from_numpy(perm).to(pivots.device)


lu.library_calls = 0
