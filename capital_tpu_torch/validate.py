"""Numerical validation oracles (counterpart of capital_tpu/validate.py).

Each returns a scalar relative Frobenius error as a 0-d f32 tensor. Their
products follow the caller's matmul precision, as the JAX package's do:
a caller that wants an f32-faithful check runs them under
`default_matmul_precision('highest')` (the framework default).

The QR oracles take layout '1d' (Q row-sharded over every device: its
Gram through cacqr.gram_1d, i.e. the SYRK kernel on a GPU, and Q R by a
per-rank TRMM) or '2d' (through the SUMMA layer). layout='auto' reads
it from Q's layout, as the JAX package reads the array's sharding: a
DArray of rows over every rank is '1d', any other DArray '2d', and a
tensor on one device '1d' (every tensor is row-sharded there).

On a grid of more than one rank the operands are DArrays (or tensors
every rank holds whole); the chunked forms of the Cholesky and inverse
residuals are one-device forms, and a mesh takes the products whole
through the SUMMA layer. A norm sums the local squares over the axes
that split the array (parallel/darray.sum_squares).
"""

from __future__ import annotations

import torch

from capital_tpu_torch.algs.cacqr import _rows, gram_1d, is_row_sharded
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.ops import blas
from capital_tpu_torch.ops.precision import dot as _pdot
from capital_tpu_torch.parallel import darray, summa
from capital_tpu_torch.parallel.darray import DArray


def _fro(x) -> torch.Tensor:
    return torch.sqrt(darray.sum_squares(x))


def _diff(grid: Grid, x, y):
    """x - y; on a mesh y laid out as the DArray x first."""
    if isinstance(x, DArray):
        return x.with_local(x.local - grid.constrain(y, x.spec).local)
    return x - y


def _triu(x):
    return x.triu() if isinstance(x, DArray) else torch.triu(x)


def _sqrt_n(n: int, like) -> torch.Tensor:
    dev = like.local.device if isinstance(like, DArray) else like.device
    return torch.sqrt(torch.tensor(float(n), dtype=torch.float32,
                                   device=dev))


def _across_ranks(grid: Grid) -> bool:
    return grid.mesh is not None and grid.num_devices > 1


def cholesky_residual(grid: Grid, a, r, impl: str = "shard_map",
                      chunks: int = 1, masked: bool = False) -> torch.Tensor:
    """||R^T R - A||_F / ||A||_F.

    chunks > 1 accumulates the squared norm over row panels of R^T R
    without ever forming the n x n product. masked=True promises r is
    already upper-triangular (true for factor() outputs)."""
    if _across_ranks(grid):
        rm = r if masked else _triu(grid.constrain(r, grid.slice_spec))
        rr = summa.syrk(grid, rm, impl=impl)
        return _fro(_diff(grid, rr, a)) / _fro(a)
    a, r = darray.whole(a), darray.whole(r)
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
    rr = darray.whole(summa.syrk(grid, rm, impl=impl))
    return _fro(rr - a) / _fro(a)


def inverse_residual(grid: Grid, r, rinv, impl: str = "shard_map",
                     chunks: int = 1, masked: bool = False) -> torch.Tensor:
    """||R Rinv - I||_F / sqrt(n). chunks > 1: panel accumulation;
    masked=True skips the triu copies."""
    n = r.shape[0]
    if _across_ranks(grid):
        spec = grid.slice_spec
        rm, rim = grid.constrain(r, spec), grid.constrain(rinv, spec)
        if not masked:
            rm, rim = rm.triu(), rim.triu()
        prod = summa.trmm(grid, rm, rim, side="L", uplo="U", impl=impl)
        prod = grid.constrain(prod, spec)
        return _fro(_diff(grid, prod, darray.eye_like(prod))) / _sqrt_n(
            n, prod)
    r, rinv = darray.whole(r), darray.whole(rinv)
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
    prod = darray.whole(summa.trmm(grid, rm, rim, side="L", uplo="U",
                                   impl=impl))
    eye = torch.eye(n, dtype=r.dtype, device=r.device)
    return _fro(prod - eye) / torch.sqrt(torch.tensor(
        float(n), dtype=torch.float32, device=r.device))


def _qr_layout(layout: str, q) -> str:
    if layout not in ("auto", "1d", "2d"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "auto":
        return "1d" if is_row_sharded(q) else "2d"
    return layout


def qr_orthogonality(grid: Grid, q, impl: str = "shard_map",
                     layout: str = "auto") -> torch.Tensor:
    """||Q^T Q - I||_F / sqrt(n)."""
    if _qr_layout(layout, q) == "1d":
        # kernel='auto': the SYRK kernel, whose two-level accumulation
        # keeps a 2^20-long contraction from dominating what it measures
        g = gram_1d(grid, q, kernel="auto")
    else:
        g = summa.syrk(grid, q, impl=impl)
    n = g.shape[0]
    if isinstance(g, DArray):
        return _fro(_diff(grid, g, darray.eye_like(g))) / _sqrt_n(n, g)
    eye = torch.eye(n, dtype=g.dtype, device=g.device)
    return _fro(g - eye) / _sqrt_n(n, g)


def qr_residual(grid: Grid, a, q, r, impl: str = "shard_map",
                layout: str = "auto") -> torch.Tensor:
    """||Q R - A||_F / ||A||_F. '1d': every rank multiplies its rows of Q
    by the replicated triu(R) (a TRMM side='R')."""
    if _qr_layout(layout, q) == "1d":
        rt = torch.triu(darray.whole(r))
        if grid.mesh is None:
            qr = blas.trmm(rt, q, side="R", uplo="U", platform=grid.platform)
        else:
            qq = _rows(grid, q)
            qr = qq.with_local(blas.trmm(rt, qq.local, side="R", uplo="U",
                                         platform=grid.platform))
    else:
        rt = _triu(grid.constrain(r, grid.slice_spec)) \
            if grid.mesh is not None else torch.triu(r)
        qr = summa.trmm(grid, rt, q, side="R", uplo="U", impl=impl)
    return _fro(_diff(grid, qr, a)) / _fro(a)


def eig_residual(grid: Grid, a, w, v, chunks: int = 1) -> torch.Tensor:
    """||A V - V diag(w)||_F / ||A||_F, accumulated over column chunks of V
    (never an (n, n) product), each chunk's A V at the caller's precision
    accumulated in f32 (f64 for f64)."""
    k = v.shape[1]
    chunks = max(1, min(chunks, k))
    while k % chunks:
        chunks -= 1
    kb = k // chunks
    acc_t = torch.float64 if a.dtype == torch.float64 else torch.float32
    acc = torch.zeros((), dtype=acc_t, device=a.device)
    for i in range(chunks):
        vc = v[:, i * kb:(i + 1) * kb]
        av = _pdot(a, vc, preferred_element_type=acc_t)
        d = av - vc.to(acc_t) * w[i * kb:(i + 1) * kb].to(acc_t)[None, :]
        acc = acc + torch.sum(d * d)
    return (torch.sqrt(acc) / _fro(a)).float()
