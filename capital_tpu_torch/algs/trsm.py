"""Triangular solve (TRSM) by diagonal-block inversion (counterpart of
capital_tpu/algs/trsm.py):

    invert the diagonal blocks (rectri), then block forward/back
    substitution where each panel update is a gemm:

      L X = B (lower, left):   X_i = D_i^{-1} (B_i - sum_{j<i} L_ij X_j)
      U X = B (upper, left):   X_i = D_i^{-1} (B_i - sum_{j>i} U_ij X_j)

The substitution is a Python loop over row panels in place of the JAX
package's lax.scan, with the same masked full-width panel product
B_i - A[i, :] @ X: blocks of X not computed yet are zero, and A's wrong
triangle is masked to zero, so the full-width product equals the
triangular partial sum.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from capital_tpu_torch import tracing
from capital_tpu_torch.algs import rectri
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.matrix import DistMatrix
from capital_tpu_torch.ops.precision import dot as _pdot
from capital_tpu_torch.parallel import summa


@dataclass(frozen=True)
class Config:
    """nb: substitution panel width; tri: the diagonal-block inversions."""

    nb: int = 1024
    tri: rectri.Config = field(default_factory=rectri.Config)

    def panel(self, grid: Grid, n: int) -> int:
        """Largest panel <= nb that divides n (and d1*c)."""
        nb = min(self.nb, n)
        step = grid.d1 * grid.c
        while nb > step and (n % nb or nb % step):
            nb -= step if nb % step == 0 else nb % step
        if n % nb:
            nb = n
        return nb


def solve(grid: Grid, a, b, *, side: str = "L", lower: bool = True,
          unit_diag: bool = False, cfg: Config = Config()):
    """X with op: A X = B (side='L') or X A = B (side='R'), A triangular.

    a: (n, n); b: (n, m) for side L, (m, n) for side R. unit_diag=True
    reads only A's strict triangle and takes the diagonal as ones, so a
    packed LU workspace feeds both substitutions directly."""
    if isinstance(a, DistMatrix):
        a = a.data
    if isinstance(b, DistMatrix):
        b = b.data
    if side == "R":
        # X A = B  <=>  A^T X^T = B^T
        impl = cfg.tri.summa_impl
        xt = solve(grid, summa.transpose(grid, a, impl=impl),
                   summa.transpose(grid, b, impl=impl), side="L",
                   lower=not lower, unit_diag=unit_diag, cfg=cfg)
        return summa.transpose(grid, xt, impl=impl)

    n, m = a.shape[0], b.shape[1]
    # the panel gemms contract the RHS's columns over the grid: a too-
    # narrow RHS is padded to the divisibility unit (1 on one device)
    m_pad = (-m) % (max(grid.d, 1) * max(grid.c, 1))
    if m_pad:
        b = torch.nn.functional.pad(b, (0, m_pad))
        m += m_pad
    nb = cfg.panel(grid, n)
    num_p = n // nb

    if unit_diag:
        eye = torch.eye(n, dtype=a.dtype, device=a.device)
        a = (torch.tril(a, -1) if lower else torch.triu(a, 1)) + eye
    else:
        a = torch.tril(a) if lower else torch.triu(a)

    with tracing.phase("TRSM::diaginvert"):
        dinv = [rectri.invert(grid, a[i * nb:(i + 1) * nb,
                                      i * nb:(i + 1) * nb],
                              lower=lower, cfg=cfg.tri)
                for i in range(num_p)]

    # the whole substitution's cost, as the JAX package records it for its
    # scan: num_p panel gemms (nb x n)@(n x m) + num_p (nb x nb)@(nb x m)
    p = max(grid.num_devices, 1)
    tracing.record(
        "trsm.substitute",
        flops=2.0 * num_p * (nb * n * m + nb * nb * m) / p,
        comm_bytes=num_p * tracing.psum_bytes(
            nb * m * a.element_size() / max(grid.d1 * grid.d2, 1), grid.c),
        msgs=3 * num_p)

    x = torch.zeros_like(b)
    with tracing.phase("TRSM::substitute"):
        for i in (range(num_p) if lower else reversed(range(num_p))):
            rows = slice(i * nb, (i + 1) * nb)
            rhs = b[rows] - _pdot(a[rows], x).to(b.dtype)
            x[rows] = _pdot(dinv[i], rhs).to(b.dtype)
    if m_pad:
        x = x[:, :m - m_pad]
    return x
