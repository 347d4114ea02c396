"""Distributed arrays: this rank's block of a global array (the port's
counterpart of a jax.Array sharded by NamedSharding(mesh, P(...))).

A DArray holds the local block, the global shape, the partition spec (one
entry per dimension, in mesh axis names) and the grid.Mesh. Dimension i
split over axes (a1, a2, ...) is cut into prod(sizes) equal blocks, and
this rank holds block number axis_index((a1, a2, ...)) of it, as
NamedSharding places blocks; a mesh axis that no dimension names
replicates the array along it. Plain tensors stand for replicated arrays
(every rank holds the whole value).

A container of the port's own rather than torch's DTensor: cholinv's
recursion reads and writes windows of its two workspaces at offsets that
cross block boundaries, which here are explicit gathers and local writes
(`window`, `set_window`) with no dependence on DTensor's slicing rules.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from capital_tpu_torch.grid import Mesh, P, spec_axes
from capital_tpu_torch.parallel import collectives as coll


def _norm(spec, ndim: int) -> P:
    ent = list(spec)[:ndim] + [None] * max(0, ndim - len(spec))
    return P(*ent)


@dataclass
class DArray:
    local: torch.Tensor
    shape: tuple
    spec: P
    mesh: Mesh

    def __post_init__(self):
        self.shape = tuple(int(s) for s in self.shape)
        self.spec = _norm(self.spec, len(self.shape))

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def device(self) -> torch.device:
        return self.local.device

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def axes(self, i: int) -> tuple:
        return spec_axes(self.spec[i])

    def block(self, i: int) -> tuple[int, int]:
        """(start, size) of this rank's block along dimension i."""
        return _block(self.mesh, self.shape[i], self.axes(i))

    def with_local(self, local: torch.Tensor) -> "DArray":
        return DArray(local, self.shape, self.spec, self.mesh)

    def triu(self) -> "DArray":
        return self.with_local(_tri_mask(self, upper=True))

    def tril(self) -> "DArray":
        return self.with_local(_tri_mask(self, upper=False))


def _block(mesh: Mesh, n: int, axes: tuple) -> tuple[int, int]:
    k = mesh.axis_size(axes)
    if n % k:
        raise ValueError(f"a dimension of {n} does not split over {axes} "
                         f"({k})")
    size = n // k
    return mesh.axis_index(axes) * size, size


def _tri_mask(x: DArray, upper: bool) -> torch.Tensor:
    (r0, h), (c0, w) = x.block(0), x.block(1)
    rows = torch.arange(r0, r0 + h, device=x.device)[:, None]
    cols = torch.arange(c0, c0 + w, device=x.device)[None, :]
    keep = cols >= rows if upper else cols <= rows
    return torch.where(keep, x.local, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))


def as_darray(x, mesh: Mesh) -> DArray:
    """x as a DArray on mesh: itself; a DArray of another mesh of the same
    world gathered whole; or a tensor every rank holds whole, as the
    replicated array."""
    if isinstance(x, DArray):
        if x.mesh is mesh:
            return x
        x = to_global(x)
    return DArray(x, tuple(x.shape), P(*([None] * x.ndim)), mesh)


def element_size(x) -> int:
    return (x.local if isinstance(x, DArray) else x).element_size()


def whole(x) -> torch.Tensor:
    """The whole array as one tensor: a DArray's block when its spec
    splits it over no axis of more than one member (no collective), else
    gathered; a tensor as it is."""
    if not isinstance(x, DArray):
        return x
    if all(x.mesh.axis_size(x.axes(i)) == 1 for i in range(x.ndim)):
        return x.local
    return to_global(x)


def distribute(t: torch.Tensor, mesh: Mesh, spec) -> DArray:
    """The DArray of spec whose global value is t (held whole by every
    rank): this rank's block of it, a view where slicing allows."""
    spec = _norm(spec, t.ndim)
    local = t
    for i in range(t.ndim):
        start, size = _block(mesh, t.shape[i], spec_axes(spec[i]))
        local = local.narrow(i, start, size)
    return DArray(local, tuple(t.shape), spec, mesh)


def to_global(x) -> torch.Tensor:
    """The whole array on every rank (all_gather along each split
    dimension)."""
    if not isinstance(x, DArray):
        return x
    out = x.local
    for i in range(x.ndim):
        out = coll.all_gather(out, x.mesh, x.axes(i), dim=i)
    return out


def reshard(x: DArray, spec) -> DArray:
    """x laid out as spec: a dimension whose axes stay, or only gain minor
    axes, is sliced locally; any other is gathered over its axes first."""
    spec = _norm(spec, x.ndim)
    if tuple(spec) == tuple(x.spec):
        return x
    keep = [x.axes(i) == spec_axes(spec[i])[:len(x.axes(i))]
            for i in range(x.ndim)]
    local = x.local
    # every gather first, while the ranks of a group still hold the same
    # blocks of the other dimensions; then each dimension cut to spec
    for i in range(x.ndim):
        if not keep[i]:
            local = coll.all_gather(local, x.mesh, x.axes(i), dim=i)
    for i in range(x.ndim):
        base = _block(x.mesh, x.shape[i], x.axes(i))[0] if keep[i] else 0
        start, size = _block(x.mesh, x.shape[i], spec_axes(spec[i]))
        local = local.narrow(i, start - base, size)
    return DArray(local, x.shape, spec, x.mesh)


def window(x: DArray, win) -> DArray:
    """The (r0, c0, h, w) window of a 2-D x as a DArray of x's spec: each
    split dimension gathered over its axes and cut to this rank's block of
    the window."""
    if win is None:
        return x
    r0, c0, h, w = win
    local = x.local
    for i, (o, n) in enumerate(((r0, h), (c0, w))):
        axes = x.axes(i)
        start, size = _block(x.mesh, n, axes)
        if x.mesh.axis_size(axes) > 1:
            local = coll.all_gather(local, x.mesh, axes, dim=i)
        local = local.narrow(i, o + start, size)
    return DArray(local, (h, w), x.spec, x.mesh)


def set_window(x: DArray, at, v) -> None:
    """Write v (a DArray of x's spec, or a replicated tensor) into x at
    (r0, c0), in place: v gathered whole, each rank writes the part that
    falls in its block."""
    r0, c0 = at
    full = to_global(v)
    h, w = full.shape
    (br, bh), (bc, bw) = x.block(0), x.block(1)
    lo_r, hi_r = max(r0, br), min(r0 + h, br + bh)
    lo_c, hi_c = max(c0, bc), min(c0 + w, bc + bw)
    if lo_r < hi_r and lo_c < hi_c:
        x.local[lo_r - br:hi_r - br, lo_c - bc:hi_c - bc].copy_(
            full[lo_r - r0:hi_r - r0, lo_c - c0:hi_c - c0])


def zeros(shape, spec, mesh: Mesh, dtype, device) -> DArray:
    spec = _norm(spec, len(shape))
    sizes = [_block(mesh, n, spec_axes(s))[1] for n, s in zip(shape, spec)]
    return DArray(torch.zeros(sizes, dtype=dtype, device=device), shape,
                  spec, mesh)


def eye_like(x: DArray) -> DArray:
    """The identity of x's shape, spec and dtype."""
    (r0, h), (c0, w) = x.block(0), x.block(1)
    rows = torch.arange(r0, r0 + h, device=x.device)[:, None]
    cols = torch.arange(c0, c0 + w, device=x.device)[None, :]
    return x.with_local((rows == cols).to(x.dtype))


def sum_squares(x) -> torch.Tensor:
    """sum(x^2) over the global array, in f32 (f64 for f64), on every
    rank: the local sums added over the axes the spec splits (replicas
    along the others hold the same values)."""
    t = x.local if isinstance(x, DArray) else x
    acc = torch.float64 if t.dtype == torch.float64 else torch.float32
    s = torch.sum(torch.square(t.to(acc)))
    if isinstance(x, DArray):
        axes = tuple(a for i in range(x.ndim) for a in x.axes(i))
        s = coll.psum(s, x.mesh, axes)
    return s
