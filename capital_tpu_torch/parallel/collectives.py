"""The JAX package's collectives on mesh axes, as torch.distributed calls
on the grid's process groups (grid.Mesh.group):

    lax.all_gather(x, axes, axis=dim, tiled=True)   -> all_gather
    lax.psum(x, axes)                               -> psum
    lax.pmax(x, axes)                               -> pmax
    lax.psum_scatter(x, axes, scatter_dimension=dim, tiled=True)
                                                    -> psum_scatter
    lax.ppermute(x, axes, pairs)                    -> ppermute
    lax.axis_index(axes)                            -> Mesh.axis_index

and `exchange`, an uneven all-to-all (dist.all_to_all_single), which
moves the pieces of a re-blocking (darray.window, set_window) where the
JAX package slices inside its jitted program.

`axes` is an axis name, a tuple of them (a joint axis, flat index
row-major, first axis major) or None (no axis: the identity). A process
group numbers its ranks in ascending global order, which a permuted
layout need not follow along an axis: the gathers and scatters here
reorder the pieces by mesh coordinate. Every call runs on the tensors'
device (NCCL on the card, gloo on the CPU), never through the host. The
`*_async` forms start the collective and return a Pending whose wait()
gives the result: what a later product does not need yet overlaps it.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from capital_tpu_torch.grid import Mesh


def _axes(axes) -> tuple:
    if axes is None:
        return ()
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


class Pending:
    """A started collective; wait() finishes it and returns its result."""

    def __init__(self, work, finish):
        self._work = work
        self._finish = finish

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
        return self._finish()


def _done(x: torch.Tensor) -> Pending:
    return Pending(None, lambda: x)


# the single-tensor collectives (renamed in newer torch releases)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor

_ORDERS: dict = {}


def _order(mesh: Mesh, axes: tuple) -> list | None:
    """order[j] = the group rank of the member at coordinate j of `axes`;
    None when the two orders agree."""
    key = (id(mesh), axes)
    if key not in _ORDERS:
        group_ranks = dist.get_process_group_ranks(mesh.group(axes))
        order = [group_ranks.index(r) for r in mesh.members(axes)]
        _ORDERS[key] = None if order == sorted(order) else order
    return _ORDERS[key]


def all_gather_async(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> Pending:
    """The blocks of x along `axes`, concatenated along dim in coordinate
    order (lax.all_gather tiled)."""
    axes = _axes(axes)
    if not axes:
        return _done(x)
    k = mesh.axis_size(axes)
    x = x.contiguous()
    buf = torch.empty((k * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    work = _ALL_GATHER(buf, x, group=mesh.group(axes), async_op=True)
    order = _order(mesh, axes)

    def finish():
        parts = buf.view(k, *x.shape)
        if order is not None:
            parts = parts[order]
        if dim == 0:
            return parts.reshape(k * x.shape[0], *x.shape[1:])
        return torch.cat(list(parts.unbind(0)), dim=dim)

    return Pending(work, finish)


def all_gather(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    return all_gather_async(x, mesh, axes, dim).wait()


def psum_async(x: torch.Tensor, mesh: Mesh, axes) -> Pending:
    """The sum of x over `axes`, on every member (lax.psum). x is left as
    it was."""
    axes = _axes(axes)
    if not axes:
        return _done(x)
    y = x.contiguous().clone()
    work = dist.all_reduce(y, group=mesh.group(axes), async_op=True)
    return Pending(work, lambda: y)


def psum(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    return psum_async(x, mesh, axes).wait()


def pmax(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The elementwise maximum of x over `axes`, on every member
    (lax.pmax). x is left as it was."""
    axes = _axes(axes)
    if not axes:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mesh.group(axes))
    return y


def psum_scatter(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    """The sum of x over `axes`, of which the member at coordinate j keeps
    the j-th of k equal pieces along dim (lax.psum_scatter tiled)."""
    axes = _axes(axes)
    if not axes:
        return x
    k = mesh.axis_size(axes)
    if x.shape[dim] % k:
        raise ValueError(f"psum_scatter: dimension {dim} of {tuple(x.shape)}"
                         f" does not split over {axes} ({k})")
    pieces = list(x.chunk(k, dim=dim))
    order = _order(mesh, axes)
    if order is not None:
        by_group = [None] * k
        for j, g in enumerate(order):
            by_group[g] = pieces[j]
        pieces = by_group
    src = torch.stack([p.contiguous() for p in pieces])
    out = torch.empty(src.shape[1:], dtype=x.dtype, device=x.device)
    _REDUCE_SCATTER(out, src.view(-1, *src.shape[2:]),
                    group=mesh.group(axes))
    return out


def ppermute(x: torch.Tensor, mesh: Mesh, axes, pairs) -> torch.Tensor:
    """x sent along `pairs` of flat indices over `axes` (lax.ppermute): a
    member that is no pair's destination gets zeros. A pair from a member
    to itself is a local copy."""
    axes = _axes(axes)
    if not axes:
        return x
    me = mesh.axis_index(axes)
    members = mesh.members(axes)
    dst = [d for s, d in pairs if s == me]
    src = [s for s, d in pairs if d == me]
    # contiguous whatever x's strides (irecv takes no strided buffer)
    out = (torch.zeros if not src else torch.empty)(
        x.shape, dtype=x.dtype, device=x.device)
    x = x.contiguous()
    ops = []
    for d in dst:
        if d == me:
            out.copy_(x)
        else:
            ops.append(dist.P2POp(dist.isend, x, members[d]))
    for s in src:
        if s != me:
            ops.append(dist.P2POp(dist.irecv, out, members[s]))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def exchange(x: torch.Tensor, mesh: Mesh, axes, send, recv,
             dim: int = 0) -> torch.Tensor:
    """An uneven all-to-all over `axes`: x cut along dim into pieces of
    send[j] (j in coordinate order), the j-th sent to the member at
    coordinate j; returns the pieces received, recv[j] long from the
    member at coordinate j, concatenated along dim in coordinate order.
    send[j] is what member j expects in its recv; the piece a member
    keeps (send[me] == recv[me]) is copied locally by the collective.
    The result is contiguous. A one-member axis still makes the call (its
    result is x's copy); darray keeps such dimensions local."""
    axes = _axes(axes)
    if not axes:
        return x
    k = mesh.axis_size(axes)
    if len(send) != k or len(recv) != k or sum(send) != x.shape[dim]:
        raise ValueError(f"exchange: sizes {send} / {recv} do not fit "
                         f"{tuple(x.shape)} along {dim} over {axes} ({k})")
    order = _order(mesh, axes) or list(range(k))  # coordinate -> group rank
    by_group = sorted(range(k), key=lambda j: order[j])  # group rank -> coord
    per = math.prod(x.shape[:dim] + x.shape[dim + 1:])  # elements an index
    pieces = x.split(send, dim)
    src = torch.cat([pieces[j].contiguous().reshape(-1) for j in by_group])
    out = torch.empty(sum(recv) * per, dtype=x.dtype, device=x.device)
    out_sizes = [recv[j] * per for j in by_group]
    dist.all_to_all_single(out, src, output_split_sizes=out_sizes,
                           input_split_sizes=[send[j] * per
                                              for j in by_group],
                           group=mesh.group(axes))
    got, shape = out.split(out_sizes), list(x.shape)
    parts = []
    for j in range(k):
        shape[dim] = recv[j]
        parts.append(got[order[j]].view(shape))
    return torch.cat(parts, dim)
