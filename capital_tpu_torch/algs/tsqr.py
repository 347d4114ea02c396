"""TSQR: unconditionally stable tall-skinny QR (counterpart of
capital_tpu/algs/tsqr.py), on one device.

On one device the tree has one leaf: A = Q R by Householder QR
(lapack.qr: torch.geqrf + householder_product, as the JAX package takes
XLA's stock QR), its updates at 'highest'. R's diagonal is made
nonnegative (the LAPACK-style canonical form), applied as a diagonal flip
on both factors. The two-level tree (local QRs, the gathered R stack
factored again, Q back-propagated) runs on a grid of more than one rank
and is not ported yet: it raises (ROADMAP queue M, the first item after
the world grids of M9 and M10).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from capital_tpu_torch import tracing
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.matrix import DistMatrix
from capital_tpu_torch.ops import lapack
from capital_tpu_torch.ops.precision import default_matmul_precision


@dataclass(frozen=True)
class Config:
    """canonical: flip signs so diag(R) >= 0 (deterministic factors)."""

    canonical: bool = True


def factor(grid: Grid, a, cfg: Config = Config()):
    """A = Q R for tall-skinny A ((m, n), m >> n, rows over every device).
    Returns (Q with orthonormal columns at eps for any cond(A), R (n, n)
    upper triangular)."""
    if isinstance(a, DistMatrix):
        a = a.data
    m, n = a.shape
    ndev = max(grid.num_devices, 1)
    if m % ndev or m // ndev < n:
        raise ValueError(
            f"tsqr needs ndev | m and local rows >= n: m={m}, n={n}, "
            f"devices={ndev}")
    esz = a.element_size()
    tracing.record(
        "tsqr",
        flops=(2.0 * m * n * n * 2.0) / ndev + 2.0 * ndev * n * n * n,
        comm_bytes=tracing.all_gather_bytes(n * n * esz, ndev),
        msgs=1,
    )
    with tracing.phase("TSQR::factor"):
        q, r = (_kern_single(a, cfg) if ndev == 1
                else _kern_tree(grid, a, cfg, ndev))
    return q, r


def _canon(q: torch.Tensor, r: torch.Tensor):
    s = torch.where(torch.diagonal(r) < 0, -1.0, 1.0).to(r.dtype)
    return q * s[None, :], r * s[:, None]


def _kern_single(arr: torch.Tensor, cfg: Config):
    with default_matmul_precision("highest"):
        q, r = lapack.qr(arr)
    if cfg.canonical:
        q, r = _canon(q, r)
    return q, torch.triu(r)


def _kern_tree(grid: Grid, arr, cfg: Config, ndev: int):
    raise NotImplementedError(
        "the TSQR tree across ranks is not ported yet (ROADMAP queue M: "
        "the tree on the world grids of items M9 and M10)")
