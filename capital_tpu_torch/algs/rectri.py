"""Recursive triangular-matrix inversion (counterpart of
capital_tpu/algs/rectri.py).

    inv([[L11,   0 ],    = [[L11inv,               0    ],
         [L21,  L22]])      [-L22inv L21 L11inv,  L22inv]]

Recurse on both diagonal blocks, then one block-gemm chain for the
off-diagonal block; upper triangles are the transpose-dual. X is one
full-size buffer filled in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from capital_tpu_torch import tracing
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.matrix import DistMatrix
from capital_tpu_torch.ops import lapack
from capital_tpu_torch.parallel import summa


@dataclass(frozen=True)
class Config:
    """The JAX package's rectri.Config, field for field; base_method and
    summa_impl change nothing on one device."""

    split: int = 1
    bc_mult: int = 0
    min_bc: int = 128
    base_method: str = "auto"
    summa_impl: str = "shard_map"

    def base_dim(self, grid: Grid, n: int) -> int:
        bc = max(self.min_bc, grid.d1 * grid.c) << self.bc_mult
        return min(bc, n)


def _rec(grid: Grid, t: torch.Tensor, x: torch.Tensor, off: int, n: int,
         bc: int, lower: bool, cfg: Config) -> None:
    """Write the inverse of T's (off, off, n, n) diagonal block into X."""
    end = off + n
    if n <= bc:
        with tracing.phase("RT::base"):
            tracing.record("trtri_base", flops=n**3 / 3.0)
            x[off:end, off:end].copy_(
                lapack.trtri(t[off:end, off:end], lower=lower))
        return

    n1 = max(bc, n >> cfg.split)
    mid = off + n1
    _rec(grid, t, x, off, n1, bc, lower, cfg)
    _rec(grid, t, x, mid, n - n1, bc, lower, cfg)

    with tracing.phase("RT::combine"):
        x11 = x[off:mid, off:mid]
        x22 = x[mid:end, mid:end]
        if lower:
            # X21 = -L22inv L21 L11inv
            u = summa.gemm(grid, t[mid:end, off:mid], x11,
                           impl=cfg.summa_impl)
            x[mid:end, off:mid].copy_(
                summa.gemm(grid, x22, u, alpha=-1.0, impl=cfg.summa_impl))
        else:
            # X12 = -U11inv U12 U22inv
            u = summa.gemm(grid, t[off:mid, mid:end], x22,
                           impl=cfg.summa_impl)
            x[off:mid, mid:end].copy_(
                summa.gemm(grid, x11, u, alpha=-1.0, impl=cfg.summa_impl))


def invert(grid: Grid, t, lower: bool = True, cfg: Config = Config()):
    """X = T^{-1} for triangular T (n, n); only T's `lower` triangle is
    read."""
    if isinstance(t, DistMatrix):
        t = t.data
    t = torch.tril(t) if lower else torch.triu(t)
    n = t.shape[0]
    x = torch.zeros_like(t)
    _rec(grid, t, x, 0, n, cfg.base_dim(grid, n), lower, cfg)
    return x
