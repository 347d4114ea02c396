"""Cyclic-workspace cholinv (counterpart of
capital_tpu/algs/cholinv_cyclic.py), on one device.

The recursion of cholinv._rec on a workspace kept in the block-cyclic
layout (parallel/cyclic.py): operand windows feed the window products
(cyclic.gemm_window / trmm_window / syrk_window), write-backs are
cyclic.update_window, triangles are clipped in global coordinates
(cyclic.read_window_tri), and each leaf reads its (bc, bc) window,
unpermutes it and runs cholinv._base_case, the fused Cholesky leaf
kernel on the card. The layout transform is paid once at entry and exit.
On one device the layout is the standard one; the window products are
plain products, as the JAX package's are.
"""

from __future__ import annotations

import numpy as np
import torch

from capital_tpu_torch import tracing
from capital_tpu_torch.algs import cholinv as _ci
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.matrix import DistMatrix
from capital_tpu_torch.parallel import cyclic


def _base_case(grid: Grid, w, ri, off: int, n: int, cfg, tb: int):
    with tracing.phase("CI::factor_diag"):
        blk_cyc = cyclic.read_window(grid, w, (off, off, n, n), tb=tb)
        blk = cyclic._take(blk_cyc, np.argsort(cyclic._perm(n, grid.d1, tb)),
                           np.argsort(cyclic._perm(n, grid.d2, tb)))
        rb, rib = _ci._base_case(grid, blk, cfg)
        rb = cyclic.to_cyclic(grid, rb, tb=tb)
        rib = cyclic.to_cyclic(grid, rib, tb=tb)
        w = cyclic.update_window(grid, w, rb, (off, off, n, n), tb=tb)
        ri = cyclic.update_window(grid, ri, rib, (off, off, n, n), tb=tb)
    return w, ri


def _rec(grid: Grid, carry, off: int, n: int, bc: int, cfg, top: bool,
         tb: int):
    w, ri = carry
    if n <= bc:
        return _base_case(grid, w, ri, off, n, cfg, tb)

    n1 = max(bc, n >> cfg.split)
    n2 = n - n1
    mid = off + n1
    nc = cfg.summa_chunks

    w, ri = _rec(grid, (w, ri), off, n1, bc, cfg, False, tb)

    # TRSM step: R12 = R11^{-T} A12
    with tracing.phase("CI::trsm"):
        r12 = cyclic.trmm_window(grid, ri, w, side="L", uplo="U",
                                 trans_a=True,
                                 a_window=(off, off, n1, n1),
                                 b_window=(off, mid, n1, n2),
                                 num_chunks=nc, tb=tb)
    w = cyclic.update_window(grid, w, r12, (off, mid, n1, n2), tb=tb)
    del r12

    # Schur update: A22 <- A22 - R12^T R12
    with tracing.phase("CI::tmu"):
        a22 = cyclic.read_window(grid, w, (mid, mid, n2, n2), tb=tb)
        s = cyclic.syrk_window(grid, w, c=a22, alpha=-1.0, beta=1.0,
                               a_window=(off, mid, n1, n2),
                               num_chunks=nc, tb=tb)
        del a22
    w = cyclic.update_window(grid, w, s, (mid, mid, n2, n2), tb=tb)
    del s

    w, ri = _rec(grid, (w, ri), mid, n2, bc, cfg, False, tb)

    if cfg.complete_inv or not top:
        # R12inv = -R11inv R12 R22inv
        with tracing.phase("CI::inv"):
            t = cyclic.trmm_window(grid, ri, w, side="R", uplo="U",
                                   a_window=(mid, mid, n2, n2),
                                   b_window=(off, mid, n1, n2),
                                   num_chunks=nc, tb=tb)
            r12inv = cyclic.trmm_window(grid, ri, t, side="L", uplo="U",
                                        alpha=-1.0,
                                        a_window=(off, off, n1, n1),
                                        num_chunks=nc, tb=tb)
            del t
        ri = cyclic.update_window(grid, ri, r12inv, (off, mid, n1, n2),
                                  tb=tb)
    return w, ri


def factor(grid: Grid, a, cfg: "_ci.Config" = None, tb: int | None = None):
    """(R, Rinv) like cholinv.factor, via the cyclic workspace. Returns
    standard-layout tensors; A is left as it was and must lie on the
    grid's device."""
    cfg = cfg or _ci.Config()
    if isinstance(a, DistMatrix):
        a = a.data
    if a.device != grid.device:
        raise ValueError(f"operand on {a.device}, grid on {grid.device}")
    n = a.shape[0]
    bc = cfg.base_dim(grid, n)
    if not grid.is_square:
        raise ValueError("cholinv_cyclic needs a square (d x d) slice")
    if tb is None:
        if bc % grid.d1:
            raise ValueError(f"need d | bc for tile alignment: "
                             f"bc={bc} d={grid.d1}")
        tb = bc // grid.d1
    w = cyclic.to_cyclic(grid, a, tb=tb)
    ri = torch.zeros_like(a)  # zeros: layout-free
    w, ri = _rec(grid, (w, ri), 0, n, bc, cfg, True, tb)
    r = torch.triu(cyclic.from_cyclic(grid, w, tb=tb))
    del w
    return r, cyclic.from_cyclic(grid, ri, tb=tb)
