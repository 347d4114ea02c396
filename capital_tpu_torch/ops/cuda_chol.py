"""Fused blocked Cholesky + triangular inverse of an SPD leaf block
(counterpart of capital_tpu/ops/pallas_chol.py::chol_inv_pallas).

    chol_inv_cuda(A) -> (R, Rinv)   with A = R^T R, R upper-triangular.

Per 128-wide panel k: a rank-1 micro-Cholesky of the diagonal block that
also builds E = R_kk^{-T}; the slab R[k, k:] = E @ M[k, k:]; the trailing
update M[>k, >k] -= R[k, >k]^T R[k, >k]; the left-looking inverse
Rinv[:k, k] = -(Rinv[:k, :k] R[:k, k]) E^T and Rinv_kk = E^T. All f32.

On a CUDA tensor one cooperative launch of the hand-written kernel in
`csrc/chol_inv.cu` runs it and writes R and Rinv already masked; on a CPU
tensor `chol_inv_plain` repeats the same schedule on tensors.
"""

from __future__ import annotations

import ctypes

import torch

from capital_tpu_torch.ops import _build

_B = 128       # panel width
MAX_N = 1024   # largest block; lapack.chol_inv sends larger to torch

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]


def chol_inv_cuda(a: torch.Tensor, lower: bool = False):
    """(R, Rinv) with A = R^T R, or (L, Linv) = (R^T, Rinv^T) when lower.
    n must be a multiple of 128 (matrix.symmetric pads SPD operands with
    an identity diagonal so the padded block stays well-posed), and at
    most 1024 on a CUDA tensor."""
    n = a.shape[-1]
    if a.ndim != 2 or a.shape[0] != n or n % _B:
        raise ValueError(f"chol_inv_cuda needs a square block with 128 | n, "
                         f"got {tuple(a.shape)}")
    out_dtype = a.dtype
    if not a.is_cuda:
        r, rinv = chol_inv_plain(a.float())
        r, rinv = torch.triu(r), torch.triu(rinv)
    else:
        if n > MAX_N:
            raise ValueError(f"chol_inv kernel takes n <= {MAX_N}, got {n}")
        dev = a.device
        a32 = a.float().contiguous()  # no copy for a contiguous f32 block
        if a32.data_ptr() % 16:  # the kernel reads rows as float4
            a32 = a32.clone()
        # working copy M, E and T in one allocation
        ws = torch.empty(n * n + _B * _B + n * _B, dtype=torch.float32,
                         device=dev)
        r = torch.empty((n, n), dtype=torch.float32, device=dev)
        rinv = torch.empty((n, n), dtype=torch.float32, device=dev)
        fn = _build.function("chol_inv", "capital_chol_inv", _ARGTYPES)
        base, f32 = ws.data_ptr(), 4
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(a32.data_ptr(), base, r.data_ptr(), rinv.data_ptr(),
                     base + n * n * f32, base + (n * n + _B * _B) * f32, n,
                     stream)
        _build.check("chol_inv", err, "chol_inv launch")
        chol_inv_cuda.launches += 1
    r, rinv = r.to(out_dtype), rinv.to(out_dtype)
    if lower:
        return r.T, rinv.T
    return r, rinv


chol_inv_cuda.launches = 0


def _micro_chol_inv(m_kk: torch.Tensor) -> torch.Tensor:
    """E = R_kk^{-T} of one SPD block by rank-1 steps (the kernel's
    micro_chol_kernel): pivot row r_j = M[j, :] / sqrt(max(M[j, j], 1e-30))
    is eliminated from M and the same operator is applied to E."""
    b = m_kk.shape[0]
    m = m_kk.clone()
    e = torch.eye(b, dtype=torch.float32, device=m.device)
    floor = torch.tensor(1e-30, dtype=torch.float32, device=m.device)
    for j in range(b):
        dinv = 1.0 / torch.sqrt(torch.maximum(m[j, j], floor))
        rc = m[j:, j] * dinv      # r_j as a column (pivot column of M)
        rr = m[j, j:] * dinv      # r_j as a row
        er = e[j] * dinv
        m[j:, j:] -= torch.outer(rc, rr)
        e[j + 1:] -= torch.outer(rc[1:], er)
        e[j] = er
    return e


def chol_inv_plain(a: torch.Tensor):
    """The kernel's schedule on tensors; returns (R, Rinv) before the
    caller's triu."""
    n = a.shape[0]
    m = a.clone()
    r = torch.zeros_like(m)
    rinv = torch.zeros_like(m)
    for kb in range(0, n, _B):
        k1 = kb + _B
        e = _micro_chol_inv(m[kb:k1, kb:k1])
        r[kb:k1, kb:] = e @ m[kb:k1, kb:]
        if k1 < n:
            p = r[kb:k1, k1:]
            m[k1:, k1:] -= p.T @ p
        if kb:
            t = rinv[:kb, :kb] @ r[:kb, kb:k1]
            rinv[:kb, kb:k1] = -(t @ e.T)
        rinv[kb:k1, kb:k1] = e.T
    return r, rinv
