"""What the references share: products with or without TF32 rounding,
the upper Cholesky factor with its inverse, and relative Frobenius
distances taken in row blocks in float64.
"""

from __future__ import annotations

import math

import torch

ROWS = 4096  # rows a block of a distance


def exact_products() -> None:
    """float32 products in float32 (TF32 off), float64 in float64."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32's 10 mantissa bits, to nearest, ties to
    even: what a TF32 tensor-core product does to its inputs."""
    i = x.contiguous().view(torch.int32)
    r = (i + (0x0FFF + ((i >> 13) & 1))) & -8192
    return r.view(torch.float32)


def product(rounding: bool):
    """x @ y, with both inputs rounded to TF32 first when `rounding`."""
    if not rounding:
        return torch.matmul

    def mm(x, y):
        return tf32(x) @ tf32(y)

    return mm


def chol_upper(g: torch.Tensor):
    """(R, R^-1) with G = R^T R, R upper triangular, in G's dtype."""
    r = torch.linalg.cholesky(g).mT.contiguous()
    eye = torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    return r, torch.linalg.solve_triangular(r, eye, upper=True)


def squares(x: torch.Tensor, ref: torch.Tensor | None = None,
            offdiag: bool = False) -> torch.Tensor:
    """Sum of squares of x - ref (or of x) in float64, over row blocks;
    offdiag: of every entry off the diagonal."""
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for r0 in range(0, x.shape[0], ROWS):
        d = x[r0:r0 + ROWS].to(torch.float64, copy=True)
        if ref is not None:
            d -= ref[r0:r0 + ROWS]
        if offdiag:
            d.diagonal(r0).zero_()
        total += (d * d).sum()
    return total


def rel_fro(x: torch.Tensor, ref: torch.Tensor, offdiag: bool = False
            ) -> float:
    """||x - ref|| / ||ref|| (Frobenius), NaN staying NaN."""
    num = float(squares(x, ref, offdiag))
    den = float(squares(ref, None, offdiag))
    return math.sqrt(num / den)


class OneDevice:
    """The sums of a reference on one device: the identity."""

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return t
