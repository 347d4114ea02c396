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
cross block boundaries, which here are explicit moves and local writes
(`window`, `set_window`: one uneven all-to-all a split dimension, each
rank receiving only its block of the window; LU's row take `take_rows`)
with no dependence on DTensor's slicing rules. Elementwise arithmetic
(`+`, `-` and unary `-` of two DArrays of one shape, spec and mesh; `*`
and `/` by a scalar; `.to(dtype)`) works on the local blocks; a spec
mismatch raises ValueError, nothing is redistributed implicitly.
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

    def triu(self, diagonal: int = 0) -> "DArray":
        return self.with_local(_tri_mask(self, True, diagonal))

    def tril(self, diagonal: int = 0) -> "DArray":
        return self.with_local(_tri_mask(self, False, diagonal))

    def to(self, dtype: torch.dtype) -> "DArray":
        return self.with_local(self.local.to(dtype))

    def _like(self, other) -> torch.Tensor:
        """other's local block, when other is laid out as self."""
        if not isinstance(other, DArray):
            raise ValueError("a DArray combines only with a DArray (a "
                             "replicated tensor must be laid out first: "
                             "Grid.constrain)")
        if (other.shape != self.shape or tuple(other.spec) != tuple(self.spec)
                or other.mesh is not self.mesh):
            raise ValueError(f"DArray layouts differ: {self.shape} "
                             f"{self.spec!r} and {other.shape} "
                             f"{other.spec!r}")
        return other.local

    def __add__(self, other) -> "DArray":
        return self.with_local(self.local + self._like(other))

    def __sub__(self, other) -> "DArray":
        return self.with_local(self.local - self._like(other))

    def __neg__(self) -> "DArray":
        return self.with_local(-self.local)

    def __mul__(self, s) -> "DArray":
        return self.with_local(self.local * _scalar(s))

    __rmul__ = __mul__

    def __truediv__(self, s) -> "DArray":
        return self.with_local(self.local / _scalar(s))


def _scalar(s):
    if isinstance(s, (int, float)) or (isinstance(s, torch.Tensor)
                                       and s.dim() == 0):
        return s
    raise ValueError(f"a DArray scales only by a scalar, got {type(s)}")


def _block(mesh: Mesh, n: int, axes: tuple) -> tuple[int, int]:
    k = mesh.axis_size(axes)
    if n % k:
        raise ValueError(f"a dimension of {n} does not split over {axes} "
                         f"({k})")
    size = n // k
    return mesh.axis_index(axes) * size, size


def _tri_mask(x: DArray, upper: bool, k: int = 0) -> torch.Tensor:
    (r0, h), (c0, w) = x.block(0), x.block(1)
    rows = torch.arange(r0, r0 + h, device=x.device)[:, None]
    cols = torch.arange(c0, c0 + w, device=x.device)[None, :]
    keep = cols - rows >= k if upper else cols - rows <= k
    return torch.where(keep, x.local, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))


def fit(mesh: Mesh, shape, spec) -> P:
    """spec with every dimension that does not divide its axes' size
    replicated instead (the JAX package's constrain rule)."""
    spec = _norm(spec, len(shape))
    return P(*(None if n % mesh.axis_size(spec_axes(e)) else e
               for n, e in zip(shape, spec)))


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


def _cut(a: tuple, b: tuple) -> tuple:
    """The intersection of two [lo, hi) ranges; when it is empty, an empty
    range at a point of a (a tensor covering a narrows to it)."""
    lo = min(max(a[0], b[0]), a[1])
    return lo, max(lo, min(a[1], b[1]))


def _move(local: torch.Tensor, x: DArray, i: int, span: tuple,
          to_window: bool) -> torch.Tensor:
    """Re-block dimension i of the window span = [o, o + n) of x over x's
    axes between x's blocks (each cut to the window) and the window's own
    n/k blocks: to_window, local holds this rank's block of x inside the
    window and the result is its block of the window; else the reverse.
    Each member sends each peer the intersection of what it holds and
    what the peer wants (one uneven all-to-all). The members of the axes'
    group hold the same extent along the other dimension: when it is
    empty, nothing is moved."""
    axes = x.axes(i)
    k, me = x.mesh.axis_size(axes), x.mesh.axis_index(axes)
    bx, b, o = x.shape[i] // k, (span[1] - span[0]) // k, span[0]
    blocks = [_cut((t * bx, (t + 1) * bx), span) for t in range(k)]
    wins = [(o + t * b, o + (t + 1) * b) for t in range(k)]
    held, want = (blocks, wins) if to_window else (wins, blocks)
    shape = list(local.shape)
    shape[i] = want[me][1] - want[me][0]
    if 0 in local.shape[:i] + local.shape[i + 1:]:
        return local.new_empty(shape)
    send = [_cut(held[me], r) for r in want]
    sizes = [hi - lo for lo, hi in send]
    first = next((lo for lo, hi in send if hi > lo), held[me][0])
    part = local.narrow(i, first - held[me][0], sum(sizes))
    recv = [_cut(r, want[me]) for r in held]
    return coll.exchange(part, x.mesh, axes, sizes,
                         [hi - lo for lo, hi in recv], i)


def window(x: DArray, win) -> DArray:
    """The (r0, c0, h, w) window of a 2-D x as a DArray of x's spec. Each
    dimension is first cut locally to this rank's block of x inside the
    window; then, along each split dimension (rows first), each rank sends
    each peer of its axes the part of that which falls in the peer's
    block of the window (an uneven all-to-all), so a rank receives only
    what its block of the window holds."""
    if win is None:
        return x
    r0, c0, h, w = win
    spans = ((r0, r0 + h), (c0, c0 + w))
    if min(r0, c0) < 0 or r0 + h > x.shape[0] or c0 + w > x.shape[1]:
        raise ValueError(f"window {win} outside a {x.shape} array")
    local = x.local
    for i in range(2):
        _block(x.mesh, (h, w)[i], x.axes(i))  # a window that does not split
        start, size = x.block(i)
        lo, hi = _cut((start, start + size), spans[i])
        local = local.narrow(i, lo - start, hi - lo)
    for i in range(2):
        if x.mesh.axis_size(x.axes(i)) > 1:
            local = _move(local, x, i, spans[i], to_window=True)
    return DArray(local, (h, w), x.spec, x.mesh)


def _entry_for(x: DArray, v: DArray, i: int):
    """The spec entry set_window lays v's dimension i out as: v's own
    when it is whole (its axes have one member) or split as x's; x's when
    v's axes are a prefix of x's (reshard cuts locally); else None
    (gathered over v's axes)."""
    va, xa = v.axes(i), x.axes(i)
    if x.mesh.axis_size(va) == 1 or va == xa:
        return v.spec[i]
    if xa[:len(va)] == va and not v.shape[i] % x.mesh.axis_size(xa):
        return x.spec[i]
    return None


def set_window(x: DArray, at, v) -> None:
    """Write v into x at (r0, c0), in place; each rank writes the part of
    v that falls in its block. v is a replicated tensor (cut locally) or a
    DArray: a dimension v holds whole is cut locally; one split as x's is
    moved to x's blocks by the inverse of window's exchange; one split
    over a prefix of x's axes is cut to x's layout locally first; one
    split otherwise is gathered over its axes (_entry_for)."""
    r0, c0 = at
    (br, bh), (bc, bw) = x.block(0), x.block(1)
    mine = ((br, br + bh), (bc, bc + bw))
    if isinstance(v, DArray):
        if v.mesh is not x.mesh:
            v = as_darray(v, x.mesh)
        v = reshard(v, P(*(_entry_for(x, v, i) for i in range(2))))
        split = [x.mesh.axis_size(v.axes(i)) > 1 for i in range(2)]
        local = v.local
    else:
        split, local = [False, False], v
    h, w = v.shape
    spans = ((r0, r0 + h), (c0, c0 + w))
    for i in range(2):  # the dimensions held whole: cut locally
        if not split[i]:
            lo, hi = _cut(spans[i], mine[i])
            local = local.narrow(i, lo - spans[i][0], hi - lo)
    for i in range(2):
        if split[i]:
            local = _move(local, x, i, spans[i], to_window=False)
    (lo_r, hi_r), (lo_c, hi_c) = (_cut(mine[i], spans[i]) for i in range(2))
    if lo_r < hi_r and lo_c < hi_c:
        x.local[lo_r - br:hi_r - br, lo_c - bc:hi_c - bc].copy_(local)


def take_rows(x: DArray, win, perm: torch.Tensor) -> DArray:
    """The (r0, c0, h, w) window of a 2-D x with its rows taken by perm
    (row i of the result is window row perm[i]; perm replicated, (h,)),
    laid out as x: the window's column block gathered over the row axes,
    taken, and this rank's rows kept (LU's laswp, solve_factored's P b)."""
    xw = window(x, win)
    axes = xw.axes(0)
    rows = coll.all_gather(xw.local, x.mesh, axes, dim=0)
    start, size = _block(x.mesh, xw.shape[0], axes)
    return xw.with_local(
        rows.index_select(0, perm[start:start + size].to(rows.device)))


def transpose(x: DArray) -> DArray:
    """x^T with no data moved: this rank's block transposed, the spec's
    entries swapped (Grid.constrain lays it out anew)."""
    return DArray(x.local.T, (x.shape[1], x.shape[0]), (x.spec[1], x.spec[0]),
                  x.mesh)


def zeros(shape, spec, mesh: Mesh, dtype, device) -> DArray:
    spec = _norm(spec, len(shape))
    sizes = [_block(mesh, n, spec_axes(s))[1] for n, s in zip(shape, spec)]
    return DArray(torch.zeros(sizes, dtype=dtype, device=device), shape,
                  spec, mesh)


def eye(n: int, spec, mesh: Mesh, dtype, device) -> DArray:
    """The n x n identity as a DArray of spec."""
    return eye_like(zeros((n, n), fit(mesh, (n, n), spec), mesh, dtype,
                          device))


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
        s = coll.psum(s, x.mesh, split_axes(x))
    return s


def split_axes(x: DArray) -> tuple:
    """The mesh axes that split x: the ranks that differ along them hold
    its blocks once each (the others hold replicas)."""
    return tuple(a for i in range(x.ndim) for a in x.axes(i))


def diagonal(x: DArray) -> torch.Tensor:
    """The part of a 2-D x's main diagonal in this rank's block (possibly
    empty), in global order."""
    (r0, h), (c0, w) = x.block(0), x.block(1)
    lo, hi = max(r0, c0), min(r0 + h, c0 + w)
    if lo >= hi:
        return x.local.new_empty(0)
    idx = torch.arange(lo, hi, device=x.device)
    return x.local[idx - r0, idx - c0]


def diag_sum(x, fn) -> torch.Tensor:
    """sum(fn(diag(x))) over the global diagonal, on every rank (a tensor
    x: its own diagonal)."""
    if not isinstance(x, DArray):
        return torch.sum(fn(torch.diagonal(x)))
    return coll.psum(torch.sum(fn(diagonal(x))), x.mesh, split_axes(x))


def max_abs_sum(x, dim: int, dtype=None) -> torch.Tensor:
    """max over the other dimension of sum(|x|) along dim (dim=1: the
    infinity norm, dim=0: the 1-norm), in dtype (default x's), on every
    rank: the local sums added over dim's axes, the maximum taken over the
    other's."""
    t = x.local if isinstance(x, DArray) else x
    if dtype is not None:
        t = t.to(dtype)
    s = torch.sum(torch.abs(t), dim=dim)
    if not isinstance(x, DArray):
        return torch.max(s)
    s = coll.psum(s, x.mesh, x.axes(dim))
    return coll.pmax(torch.max(s), x.mesh, x.axes(1 - dim))
