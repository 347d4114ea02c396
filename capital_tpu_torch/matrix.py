"""Matrix container: tensor + logical shape + structure tag (counterpart of
capital_tpu/matrix.py).

Triangular structure is a semantic mask, not packed storage. Global
shapes are padded up to a multiple of the grid tile; SPD matrices are
padded with an identity diagonal block (chol(blkdiag(A, I)) =
blkdiag(chol(A), I)), so algorithms run on padded shapes and results are
cropped on export. Values come from a torch.Generator and differ from
jax.random's; padding and masks match the JAX package. `spec` (a
grid.P) names the layout the JAX package would shard the result in; it
is checked against the grid's axes (Grid.sharding), and on one device
every valid spec places the result whole on the grid's device.

On a grid with a mesh (inside a world) the generators are born sharded:
`data` is a parallel.darray.DArray of `spec` (default P('y', 'x'), the
tall-skinny operand P(('z', 'y', 'x'), None)), and each rank makes its
own block from the global indices, as the JAX package's jit with sharded
output does, never the whole matrix. Their uniform draws are a
counter-based hash of (seed, i, j) (`_hash_uniform`), so a matrix is the
same on every grid shape and layout; they differ from the torch.Generator
draws of the one-device grid.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch

from capital_tpu_torch.grid import ALL_AXES, AXIS_X, AXIS_Y, P, Grid


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
    padded shape (a tensor, or on a mesh a DArray); `shape` is the
    logical one."""

    data: torch.Tensor
    shape: tuple[int, int]
    structure: Structure = Structure.RECT

    @property
    def padded_shape(self) -> tuple[int, int]:
        return tuple(self.data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def masked(self):
        """data with the structure mask applied (a DArray stays one)."""
        if self.structure == Structure.RECT or isinstance(self.data,
                                                          torch.Tensor):
            return apply_structure(self.data, self.structure)
        upper = self.structure == Structure.UPPERTRI
        return self.data.triu() if upper else self.data.tril()

    def to_global(self) -> torch.Tensor:
        """Crop padding and apply the structure mask (a DArray gathered
        whole on every rank first)."""
        from capital_tpu_torch.parallel.darray import to_global

        m, n = self.shape
        return apply_structure(to_global(self.data)[:m, :n], self.structure)


_M1 = -7046029254386353131   # 0x9E3779B97F4A7C15 as a signed int64
_M2 = -4658895280553007687   # 0xBF58476D1CE4E5B9
_M3 = -7723592293110705685   # 0x94D049BB133111EB
_HASH_ROWS = 1 << 22         # elements hashed at a time (temporaries)


def _srl(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 (torch's >> is arithmetic)."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _hash_uniform(seed: int, rows: torch.Tensor, cols: torch.Tensor,
                  dtype) -> torch.Tensor:
    """Uniform(-0.5, 0.5) values of the global entries (rows x cols), a
    SplitMix64 finaliser of mix(seed) + i * 2^21 + j keeping 24 bits:
    the same numbers on any device and any block split."""
    out = torch.empty((rows.numel(), cols.numel()), dtype=dtype,
                      device=rows.device)
    step = max(1, _HASH_ROWS // max(cols.numel(), 1))
    c = cols.to(torch.int64)[None, :]
    for i in range(0, rows.numel(), step):
        r = rows[i:i + step].to(torch.int64)[:, None]
        z = _mix_seed(seed) + (r << 21) + c + _M1
        z = (z ^ _srl(z, 30)) * _M2
        z = (z ^ _srl(z, 27)) * _M3
        z = z ^ _srl(z, 31)
        u = _srl(z, 40).to(torch.float32) * (1.0 / (1 << 24)) - 0.5
        out[i:i + step] = u.to(dtype)
    return out


def _mix_seed(seed: int) -> int:
    """seed * 0x94D049BB133111EB mod 2^64, as a signed int64."""
    s = (int(seed) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return s - (1 << 64) if s >= 1 << 63 else s


def _seed(key) -> int:
    if isinstance(key, torch.Generator):
        return int(key.initial_seed())
    return int(key)


def _blocks(grid: Grid, shape, spec):
    """(global row indices, global col indices, spec) of this rank's
    block of a matrix of `shape` laid out as spec on the grid's mesh."""
    from capital_tpu_torch.parallel.darray import DArray

    probe = DArray(torch.empty(0), shape, spec, grid.mesh)
    (r0, h), (c0, w) = probe.block(0), probe.block(1)
    dev = grid.device
    return (torch.arange(r0, r0 + h, device=dev),
            torch.arange(c0, c0 + w, device=dev), probe.spec)


def _born(grid: Grid, shape, spec, fill) -> "DistMatrix":
    """data of a mesh generator: fill(rows, cols) on this rank's block."""
    from capital_tpu_torch.parallel.darray import DArray

    rows, cols, spec = _blocks(grid, shape, spec)
    return DArray(fill(rows, cols), shape, spec, grid.mesh)


def _generator(grid: Grid, key) -> torch.Generator:
    """`key` is a torch.Generator on the grid's device or an int seed."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=grid.device).manual_seed(int(key))


def _check_spec(grid: Grid, spec: P | None) -> None:
    if spec is not None:
        grid.sharding(spec)


def _uniform(grid: Grid, shape, key, dtype) -> torch.Tensor:
    """Uniform(-0.5, 0.5) on the grid's device."""
    u = torch.rand(shape, generator=_generator(grid, key),
                   device=grid.device, dtype=torch.float32)
    return u.sub_(0.5).to(dtype)


def rand(grid: Grid, m: int, n: int, key, dtype=torch.float32,
         structure: Structure = Structure.RECT, spec: P | None = None,
         row_tile: int | None = None,
         col_tile: int | None = None) -> DistMatrix:
    """Uniform(-0.5, 0.5) matrix, pad region zero."""
    _check_spec(grid, spec)
    pm = _pad_up(m, row_tile or grid.d1)
    pn = _pad_up(n, col_tile or grid.d2)
    if grid.mesh is not None:
        def fill(rows, cols):
            u = _hash_uniform(_seed(key), rows, cols, dtype)
            live = (rows < m)[:, None] & (cols < n)[None, :]
            return u * live.to(dtype)

        data = _born(grid, (pm, pn), spec or P(AXIS_Y, AXIS_X), fill)
        return DistMatrix(data, (m, n), structure)
    u = _uniform(grid, (pm, pn), key, dtype)
    u[m:, :] = 0
    u[:, n:] = 0
    return DistMatrix(u, (m, n), structure)


def symmetric(grid: Grid, n: int, key, dtype=torch.float32,
              diag_shift: float | None = None, spec: P | None = None,
              align: int = 1) -> DistMatrix:
    """SPD test matrix (U + U^T)/2 + shift*I, shift defaulting to n for
    diagonal dominance. align > 1 pads to a multiple of align (128 keeps
    the leaf kernel off ragged shapes); the pad region is an identity
    block."""
    _check_spec(grid, spec)
    pn = _pad_up(n, align * (grid.d1 if grid.is_square else grid.num_devices))
    shift = float(n) if diag_shift is None else float(diag_shift)
    if grid.mesh is not None:
        def fill(rows, cols):
            # U[i, j] and U[j, i] are both known from the indices
            a = (_hash_uniform(_seed(key), rows, cols, dtype)
                 + _hash_uniform(_seed(key), cols, rows, dtype).T) * 0.5
            live = (rows < n)[:, None] & (cols < n)[None, :]
            a = a * live.to(dtype)
            diag = rows[:, None] == cols[None, :]
            fill_d = torch.where(rows < n, shift, 1.0).to(dtype)[:, None]
            return a + diag.to(dtype) * fill_d

        data = _born(grid, (pn, pn), spec or P(AXIS_Y, AXIS_X), fill)
        return DistMatrix(data, (n, n), Structure.RECT)
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


def identity(grid: Grid, n: int, dtype=torch.float32,
             spec: P | None = None) -> DistMatrix:
    _check_spec(grid, spec)
    pn = _pad_up(n, grid.d1 if grid.is_square else grid.num_devices)
    if grid.mesh is not None:
        data = _born(grid, (pn, pn), spec or P(AXIS_Y, AXIS_X),
                     lambda r, c: (r[:, None] == c[None, :]).to(dtype))
        return DistMatrix(data, (n, n), Structure.RECT)
    return DistMatrix(torch.eye(pn, dtype=dtype, device=grid.device),
                      (n, n), Structure.RECT)


def debug(grid: Grid, m: int, n: int, dtype=torch.float32,
          spec: P | None = None) -> DistMatrix:
    """Entry (i, j) = i + m*j, pad region zero: globally addressable
    values for layout tests."""
    _check_spec(grid, spec)
    dev = grid.device
    pm, pn = _pad_up(m, grid.d1), _pad_up(n, grid.d2)
    if grid.mesh is not None:
        def fill(rows, cols):
            v = (rows[:, None] + m * cols[None, :]).to(dtype)
            return v * ((rows < m)[:, None] & (cols < n)[None, :]).to(dtype)

        data = _born(grid, (pm, pn), spec or P(AXIS_Y, AXIS_X), fill)
        return DistMatrix(data, (m, n), Structure.RECT)
    i = torch.arange(pm, device=dev)[:, None]
    j = torch.arange(pn, device=dev)[None, :]
    v = (i + m * j).to(dtype)
    v[m:, :] = 0
    v[:, n:] = 0
    return DistMatrix(v, (m, n), Structure.RECT)


def tall_skinny(grid: Grid, m: int, n: int, key, dtype=torch.float32,
                col_scale: bool = True, spec: P | None = None) -> DistMatrix:
    """Tall-skinny operand in the 1D layout (rows over all devices):
    Uniform(-0.5, 0.5), times the column scale linspace(1, 2) when
    col_scale (graded column magnitudes make orthogonality non-trivial),
    rows >= m zero. Columns are not padded."""
    _check_spec(grid, spec)
    pm = _pad_up(m, grid.num_devices)
    if grid.mesh is not None:
        def fill(rows, cols):
            u = _hash_uniform(_seed(key), rows, cols, dtype)
            if col_scale:
                u.mul_(torch.linspace(1.0, 2.0, n, dtype=dtype,
                                      device=grid.device)[cols])
            return u * (rows < m)[:, None].to(dtype)

        data = _born(grid, (pm, n), spec or P(ALL_AXES, None), fill)
        return DistMatrix(data, (m, n), Structure.RECT)
    u = _uniform(grid, (pm, n), key, dtype)
    if col_scale:
        u.mul_(torch.linspace(1.0, 2.0, n, dtype=dtype, device=grid.device))
    u[m:, :] = 0
    return DistMatrix(u, (m, n), Structure.RECT)
