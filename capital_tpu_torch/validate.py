"""Numerical validation oracles (counterpart of capital_tpu/validate.py).

Each returns a scalar relative Frobenius error as a 0-d f32 tensor. Their
products follow the caller's matmul precision, as the JAX package's do:
a caller that wants an f32-faithful check runs them under
`default_matmul_precision('highest')` (the framework default).

The QR oracles take layout '1d' (Q row-sharded over every device: its
Gram through cacqr.gram_1d, i.e. the SYRK kernel on a GPU, and Q R by a
local TRMM) or '2d' (through the SUMMA layer). layout='auto' means '1d'
on the one-device grid, where every tensor is row-sharded over all
devices; the JAX package reads it from the array's sharding.
"""

from __future__ import annotations

import torch

from capital_tpu_torch.algs.cacqr import gram_1d
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.ops import blas
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


def _qr_layout(layout: str) -> str:
    if layout not in ("auto", "1d", "2d"):
        raise ValueError(f"unknown layout {layout!r}")
    return "1d" if layout == "auto" else layout


def qr_orthogonality(grid: Grid, q, impl: str = "shard_map",
                     layout: str = "auto") -> torch.Tensor:
    """||Q^T Q - I||_F / sqrt(n)."""
    if _qr_layout(layout) == "1d":
        # kernel='auto': the SYRK kernel, whose two-level accumulation
        # keeps a 2^20-long contraction from dominating what it measures
        g = gram_1d(grid, q, kernel="auto")
    else:
        g = summa.syrk(grid, q, impl=impl)
    n = g.shape[0]
    eye = torch.eye(n, dtype=g.dtype, device=g.device)
    return _fro(g - eye) / torch.sqrt(torch.tensor(
        float(n), dtype=torch.float32, device=g.device))


def qr_residual(grid: Grid, a, q, r, impl: str = "shard_map",
                layout: str = "auto") -> torch.Tensor:
    """||Q R - A||_F / ||A||_F."""
    rt = torch.triu(r)
    if _qr_layout(layout) == "1d":
        qr = blas.trmm(rt, q, side="R", uplo="U", platform=grid.platform)
    else:
        qr = summa.trmm(grid, rt, q, side="R", uplo="U", impl=impl)
    return _fro(qr - a) / _fro(a)
