"""Matrix container: tensor + logical shape + structure tag (counterpart of
capital_tpu/matrix.py).

Triangular structure is a semantic mask, not packed storage. Global
shapes are padded up to a multiple of the grid tile; SPD matrices are
padded with an identity diagonal block (chol(blkdiag(A, I)) =
blkdiag(chol(A), I)), so algorithms run on padded shapes and results are
cropped on export. Values come from a torch.Generator and differ from
jax.random's; padding and masks match the JAX package.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch

from capital_tpu_torch.grid import Grid


class Structure(enum.Enum):
    """Semantic storage structure."""

    RECT = "rect"
    UPPERTRI = "uppertri"
    LOWERTRI = "lowertri"


def apply_structure(x: torch.Tensor, structure: Structure) -> torch.Tensor:
    """Materialize the structure mask."""
    if structure == Structure.UPPERTRI:
        return torch.triu(x)
    if structure == Structure.LOWERTRI:
        return torch.tril(x)
    return x


def _pad_up(n: int, tile: int) -> int:
    return -(-n // tile) * tile


@dataclass
class DistMatrix:
    """A logically (m, n) matrix stored padded on a Grid. `data` has the
    padded shape; `shape` is the logical one."""

    data: torch.Tensor
    shape: tuple[int, int]
    structure: Structure = Structure.RECT

    @property
    def padded_shape(self) -> tuple[int, int]:
        return tuple(self.data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def masked(self) -> torch.Tensor:
        return apply_structure(self.data, self.structure)

    def to_global(self) -> torch.Tensor:
        """Crop padding and apply the structure mask."""
        m, n = self.shape
        return apply_structure(self.data[:m, :n], self.structure)


def _generator(grid: Grid, key) -> torch.Generator:
    """`key` is a torch.Generator on the grid's device or an int seed."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=grid.device).manual_seed(int(key))


def _uniform(grid: Grid, shape, key, dtype) -> torch.Tensor:
    """Uniform(-0.5, 0.5) on the grid's device."""
    u = torch.rand(shape, generator=_generator(grid, key),
                   device=grid.device, dtype=torch.float32)
    return u.sub_(0.5).to(dtype)


def rand(grid: Grid, m: int, n: int, key, dtype=torch.float32,
         structure: Structure = Structure.RECT, row_tile: int | None = None,
         col_tile: int | None = None) -> DistMatrix:
    """Uniform(-0.5, 0.5) matrix, pad region zero."""
    pm = _pad_up(m, row_tile or grid.d1)
    pn = _pad_up(n, col_tile or grid.d2)
    u = _uniform(grid, (pm, pn), key, dtype)
    u[m:, :] = 0
    u[:, n:] = 0
    return DistMatrix(u, (m, n), structure)


def symmetric(grid: Grid, n: int, key, dtype=torch.float32,
              diag_shift: float | None = None, align: int = 1) -> DistMatrix:
    """SPD test matrix (U + U^T)/2 + shift*I, shift defaulting to n for
    diagonal dominance. align > 1 pads to a multiple of align (128 keeps
    the leaf kernel off ragged shapes); the pad region is an identity
    block."""
    pn = _pad_up(n, align * (grid.d1 if grid.is_square else grid.num_devices))
    shift = float(n) if diag_shift is None else float(diag_shift)
    u = _uniform(grid, (pn, pn), key, dtype)
    a = u + u.T
    del u
    a.mul_(0.5)
    a[n:, :] = 0
    a[:, n:] = 0
    diag = torch.ones(pn, dtype=dtype, device=grid.device)
    diag[:n] = shift
    a.diagonal().add_(diag)
    return DistMatrix(a, (n, n), Structure.RECT)


def identity(grid: Grid, n: int, dtype=torch.float32) -> DistMatrix:
    pn = _pad_up(n, grid.d1 if grid.is_square else grid.num_devices)
    return DistMatrix(torch.eye(pn, dtype=dtype, device=grid.device), (n, n),
                      Structure.RECT)


def debug(grid: Grid, m: int, n: int, dtype=torch.float32) -> DistMatrix:
    """Entry (i, j) = i + m*j, pad region zero: globally addressable
    values for layout tests."""
    pm, pn = _pad_up(m, grid.d1), _pad_up(n, grid.d2)
    i = torch.arange(pm, device=grid.device)[:, None]
    j = torch.arange(pn, device=grid.device)[None, :]
    v = (i + m * j).to(dtype)
    v[m:, :] = 0
    v[:, n:] = 0
    return DistMatrix(v, (m, n), Structure.RECT)


def tall_skinny(grid: Grid, m: int, n: int, key, dtype=torch.float32,
                col_scale: bool = True) -> DistMatrix:
    """Tall-skinny operand in the 1D layout (rows over all devices):
    Uniform(-0.5, 0.5), times the column scale linspace(1, 2) when
    col_scale (graded column magnitudes make orthogonality non-trivial),
    rows >= m zero. Columns are not padded."""
    pm = _pad_up(m, grid.num_devices)
    u = _uniform(grid, (pm, n), key, dtype)
    if col_scale:
        u.mul_(torch.linspace(1.0, 2.0, n, dtype=dtype, device=grid.device))
    u[m:, :] = 0
    return DistMatrix(u, (m, n), Structure.RECT)
