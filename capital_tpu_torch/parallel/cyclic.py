"""Block-cyclic workspace layout (counterpart of
capital_tpu/parallel/cyclic.py), on one device.

In the cyclic layout (tile tb, mesh (d1, d2)) global row tile g lives on
device row g % d1 at local tile g // d1, and columns likewise on d2: the
array is stored with its rows and columns permuted (`_perm`) so that a
window aligned to (tb*d1, tb*d2) is the same local rectangle on every
device, read without a message (the reference's `_restrict_` pointer
views). On the one-device grid d1 = d2 = 1 and `_perm` is the identity:
the layout is the standard one, a window is a strided view of the
workspace, and the products over windows are plain products
(precision.dot, as the JAX package's gemm_window contracts its gathered
panels), never the triangle kernels.

Tensors are not immutable here: `update_window` writes into the
workspace in place and returns it (the JAX package returns a new array;
callers that rebind the result, as cholinv_cyclic does, see the same
values). `read_window` materializes its window as a tensor of its own.
"""

from __future__ import annotations

import numpy as np
import torch

from capital_tpu_torch.grid import Grid
from capital_tpu_torch.ops.precision import dot as _pdot

TB = 128  # tile side


def _perm(n: int, d: int, tb: int = TB) -> np.ndarray:
    """Physical index -> global index map for one dimension (length n):
    physical position (dev * (n/d) + local) holds global element
    ((local//tb)*d + dev)*tb + local%tb."""
    if d <= 1:
        return np.arange(n)
    nb = n // d
    dev = np.arange(n) // nb
    loc = np.arange(n) % nb
    return (loc // tb * d + dev) * tb + loc % tb


def _check(grid: Grid, shape, tb: int):
    m, n = shape
    if m % (tb * grid.d1) or n % (tb * grid.d2):
        raise ValueError(
            f"cyclic layout needs {tb}*d | (m, n): shape={tuple(shape)} "
            f"d1={grid.d1} d2={grid.d2} tb={tb}")


def _take(x: torch.Tensor, rows: np.ndarray, cols: np.ndarray):
    """x[rows][:, cols] as a new tensor."""
    r = torch.as_tensor(rows, device=x.device)
    c = torch.as_tensor(cols, device=x.device)
    return x.index_select(0, r).index_select(1, c)


def to_cyclic(grid: Grid, a: torch.Tensor, tb: int = TB) -> torch.Tensor:
    """Standard (global-order) tensor -> cyclic physical layout (a new
    tensor; paid once per workspace, not once per window)."""
    _check(grid, a.shape, tb)
    return _take(a, _perm(a.shape[0], grid.d1, tb),
                 _perm(a.shape[1], grid.d2, tb))


def from_cyclic(grid: Grid, phys: torch.Tensor, tb: int = TB) -> torch.Tensor:
    """Inverse transform of to_cyclic (a new tensor)."""
    _check(grid, phys.shape, tb)
    return _take(phys, np.argsort(_perm(phys.shape[0], grid.d1, tb)),
                 np.argsort(_perm(phys.shape[1], grid.d2, tb)))


def global_rows(grid: Grid, m: int, tb: int = TB) -> np.ndarray:
    """global_rows(grid, m)[p] = global row held at physical row p (for
    structure masks in global coordinates on the permuted layout)."""
    return _perm(m, grid.d1, tb)


def global_cols(grid: Grid, n: int, tb: int = TB) -> np.ndarray:
    return _perm(n, grid.d2, tb)


def _win_check(grid: Grid, shape, window, tb: int, axis_div):
    r0, c0, h, w = window
    dr, dc = axis_div
    for off, ext, d, name in ((r0, h, dr, "rows"), (c0, w, dc, "cols")):
        if off % (tb * d) or ext % (tb * d):
            raise ValueError(
                f"cyclic window {name} must align to tb*d={tb * d}: "
                f"window={window}")
    if r0 + h > shape[0] or c0 + w > shape[1]:
        raise ValueError(f"window {window} exceeds shape {tuple(shape)}")


def _local_slice(blk: torch.Tensor, window, d1: int, d2: int):
    """The local view of a window: its offsets divided by the mesh."""
    r0, c0, h, w = window
    return blk[r0 // d1:r0 // d1 + h // d1, c0 // d2:c0 // d2 + w // d2]


def gemm_window(grid: Grid, a, b, *, a_window=None, b_window=None,
                num_chunks: int = 1, tb: int = TB) -> torch.Tensor:
    """C = A[a_window] @ B[b_window] on cyclic-layout operands; the result
    is cyclic over (a_window rows, b_window cols). The windows are views;
    the contraction runs in num_chunks K chunks (the largest count <=
    num_chunks that divides K), each a plain product, summed in order."""
    if not grid.is_square:
        raise ValueError("cyclic gemm_window needs a square (d x d) slice")
    if a_window is None:
        a_window = (0, 0, *a.shape)
    if b_window is None:
        b_window = (0, 0, *b.shape)
    _win_check(grid, a.shape, a_window, tb, (grid.d1, grid.d2))
    _win_check(grid, b.shape, b_window, tb, (grid.d1, grid.d2))
    if a_window[3] != b_window[2]:
        raise ValueError(f"K mismatch: {a_window} @ {b_window}")
    a_sub = _local_slice(a, a_window, grid.d1, grid.d2)
    b_sub = _local_slice(b, b_window, grid.d1, grid.d2)
    chunks = num_chunks
    while a_sub.shape[1] % chunks:
        chunks -= 1
    kc = a_sub.shape[1] // chunks
    part = None
    for i in range(chunks):
        p = _pdot(a_sub[:, i * kc:(i + 1) * kc], b_sub[i * kc:(i + 1) * kc])
        part = p if part is None else part + p
    return part.to(a.dtype)


def read_window(grid: Grid, phys, window, tb: int = TB) -> torch.Tensor:
    """A cyclic window as a tensor of its own (cyclic layout)."""
    _win_check(grid, phys.shape, window, tb, (grid.d1, grid.d2))
    return _local_slice(phys, window, grid.d1, grid.d2).clone()


def update_window(grid: Grid, phys, val, window, tb: int = TB):
    """Write a cyclic-layout value into a window of the cyclic workspace,
    in place; returns the workspace."""
    _win_check(grid, phys.shape, window, tb, (grid.d1, grid.d2))
    _local_slice(phys, window, grid.d1, grid.d2).copy_(val)
    return phys


def _global_index(d: int, tb: int, length: int, device) -> torch.Tensor:
    """(1, length) global index of each local position of a cyclic extent
    on the device of axis index 0 (the only one): (l//tb * d) * tb +
    l%tb."""
    idx = torch.arange(length, device=device)[None, :]
    return (idx // tb * d) * tb + idx % tb


def read_window_tri(grid: Grid, phys, window, uplo: str = "U",
                    tb: int = TB) -> torch.Tensor:
    """A cyclic window with its opposite triangle zeroed, in the window's
    global coordinates."""
    _win_check(grid, phys.shape, window, tb, (grid.d1, grid.d2))
    sub = _local_slice(phys, window, grid.d1, grid.d2)
    rows = _global_index(grid.d1, tb, sub.shape[0], sub.device)
    cols = _global_index(grid.d2, tb, sub.shape[1], sub.device)
    keep = rows.T <= cols if uplo == "U" else rows.T >= cols
    return torch.where(keep, sub, torch.zeros((), dtype=sub.dtype,
                                              device=sub.device))


def trmm_window(grid: Grid, a, b, *, side: str = "L", uplo: str = "U",
                trans_a: bool = False, alpha: float = 1.0,
                a_window=None, b_window=None, num_chunks: int = 1,
                tb: int = TB) -> torch.Tensor:
    """Triangular multiply on cyclic-layout windows: the triangular window
    read and masked (read_window_tri), transposed through
    summa.transpose when trans_a, then contracted with the other
    operand's window by gemm_window."""
    from capital_tpu_torch.parallel import summa as _summa

    if a_window is None:
        a_window = (0, 0, *a.shape)
    t = read_window_tri(grid, a, a_window, uplo=uplo, tb=tb)
    if trans_a:
        t = _summa.transpose(grid, t)
    if side == "L":
        out = gemm_window(grid, t, b, b_window=b_window,
                          num_chunks=num_chunks, tb=tb)
    else:
        out = gemm_window(grid, b, t, a_window=b_window,
                          num_chunks=num_chunks, tb=tb)
    if alpha != 1.0:
        out = alpha * out
    return out


def syrk_window(grid: Grid, a, *, c=None, alpha: float = 1.0,
                beta: float = 0.0, a_window=None, num_chunks: int = 1,
                tb: int = TB) -> torch.Tensor:
    """C = alpha * A[win]^T A[win] + beta * C on cyclic layouts."""
    from capital_tpu_torch.parallel import summa as _summa

    if a_window is None:
        a_window = (0, 0, *a.shape)
    aw = read_window(grid, a, a_window, tb=tb)
    at = _summa.transpose(grid, aw)
    out = gemm_window(grid, at, aw, num_chunks=num_chunks, tb=tb)
    if alpha != 1.0:
        out = alpha * out
    if c is not None and beta != 0.0:
        out = out + beta * c
    return out
