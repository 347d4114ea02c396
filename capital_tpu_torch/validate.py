"""Numerical validation oracles (counterpart of capital_tpu/validate.py).

Both return scalar relative Frobenius errors as 0-d f32 tensors. Their
products follow the caller's matmul precision, as the JAX package's do:
a caller that wants an f32-faithful check runs them under
`default_matmul_precision('highest')` (the framework default).
"""

from __future__ import annotations

import torch

from capital_tpu_torch.grid import Grid
from capital_tpu_torch.ops.precision import dot as _pdot
from capital_tpu_torch.parallel import summa


def _fro(x: torch.Tensor) -> torch.Tensor:
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    return torch.sqrt(torch.sum(torch.square(x.to(acc))))


def cholesky_residual(grid: Grid, a, r, impl: str = "gspmd",
                      chunks: int = 1, masked: bool = False) -> torch.Tensor:
    """||R^T R - A||_F / ||A||_F.

    chunks > 1 accumulates the squared norm over row panels of R^T R
    without ever forming the n x n product. masked=True promises r is
    already upper-triangular (true for factor() outputs)."""
    rm = r if masked else torch.triu(r)
    if chunks > 1 and r.shape[0] % chunks == 0:
        n = r.shape[0]
        nb = n // chunks
        acc = torch.zeros((), dtype=torch.float32, device=r.device)
        for i in range(chunks):
            cols = rm[:, i * nb:(i + 1) * nb]
            prod = _pdot(cols.T, rm)  # (R^T R)[i-th row panel, :]
            d = prod.float() - a[i * nb:(i + 1) * nb, :].float()
            acc = acc + torch.sum(d * d)
        return torch.sqrt(acc) / _fro(a)
    rr = summa.syrk(grid, rm, impl=impl)
    return _fro(rr - a) / _fro(a)


def inverse_residual(grid: Grid, r, rinv, impl: str = "gspmd",
                     chunks: int = 1, masked: bool = False) -> torch.Tensor:
    """||R Rinv - I||_F / sqrt(n). chunks > 1: panel accumulation;
    masked=True skips the triu copies."""
    n = r.shape[0]
    rm = r if masked else torch.triu(r)
    rim = rinv if masked else torch.triu(rinv)
    if chunks > 1 and n % chunks == 0:
        nb = n // chunks
        acc = torch.zeros((), dtype=torch.float32, device=r.device)
        for i in range(chunks):
            prod = _pdot(rm[i * nb:(i + 1) * nb, :], rim).float()
            idx = torch.arange(i * nb, (i + 1) * nb, device=r.device)
            prod[torch.arange(nb, device=r.device), idx] -= 1.0
            acc = acc + torch.sum(prod * prod)
        return torch.sqrt(acc) / torch.sqrt(torch.tensor(
            float(n), dtype=torch.float32, device=r.device))
    prod = summa.trmm(grid, rm, rim, side="L", uplo="U", impl=impl)
    eye = torch.eye(n, dtype=r.dtype, device=r.device)
    return _fro(prod - eye) / torch.sqrt(torch.tensor(
        float(n), dtype=torch.float32, device=r.device))
