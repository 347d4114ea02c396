"""Newton-Schulz iterative matrix inversion (counterpart of
capital_tpu/algs/newton.py), on one device.

    X_0     = I / ||A||_inf                      (SPD A)
            = A^T / (||A||_1 ||A||_inf)          (general A, Pan & Schreiber)
    X_{k+1} = X_k (2I - A X_k)                   (one summa gemm, alpha=-1,
                                                  beta=2, with the cached XA)

until ||I - X A||_F / sqrt(n) <= tol or max_iter sweeps. The JAX package's
lax.while_loop is a Python loop here whose condition reads the squared
residual on the host: one device-to-host sync an iteration.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from capital_tpu_torch import tracing
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.matrix import DistMatrix
from capital_tpu_torch.parallel import summa


@dataclass(frozen=True)
class Config:
    """The JAX package's newton.Config, field for field. spd: A is
    symmetric positive-definite (the I/||A||_inf start)."""

    tol: float = 1e-6
    max_iter: int = 50
    spd: bool = False
    summa_impl: str = "gspmd"


def _fro2(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x.float()))


def invert(grid: Grid, a, cfg: Config = Config()):
    """X ~= A^{-1}; returns (X, iterations as an int, the final residual
    ||I - X A||_F / sqrt(n) as a 0-d f32 tensor)."""
    if isinstance(a, DistMatrix):
        a = a.data
    n = a.shape[0]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    norm_inf = torch.max(torch.sum(torch.abs(a), dim=1))
    if cfg.spd:
        x = eye / norm_inf.to(a.dtype)
    else:
        norm_1 = torch.max(torch.sum(torch.abs(a), dim=0))
        x = (a.T / (norm_1 * norm_inf)).to(a.dtype)
    # tol on ||.||_F / sqrt(n), in f32 as the JAX package forms it
    tol2 = float(torch.tensor(cfg.tol, dtype=torch.float32) ** 2 * n)

    def residual(x):
        xa = summa.gemm(grid, x, a, impl=cfg.summa_impl)
        return _fro2(eye - xa), xa

    with tracing.phase("NS::iterate"):
        r2, xa = residual(x)
        k = 0
        while k < cfg.max_iter and float(r2) > tol2:
            x = summa.gemm(grid, xa, x, c=x, alpha=-1.0, beta=2.0,
                           impl=cfg.summa_impl)
            r2, xa = residual(x)
            k += 1
    return x, k, torch.sqrt(r2 / n)
