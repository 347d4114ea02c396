"""Distributed 2.5D matrix multiplication over the grid (counterpart of
capital_tpu/parallel/summa.py): the one communication engine that
cholinv, cacqr and the validators ride on.

Operands are block-distributed on the (row, col) slice, P(ax_y, ax_x),
and replicated over the c-deep depth axis. Schedules, each a function on
this rank's blocks with explicit collectives (parallel/collectives.py):

  * 'shard_map': depth layer z takes the z-th 1/c of its blocks' K
    extent; all_gather of the A pieces along x and of the B pieces along
    y assembles layer z's K panels; one local product; psum over z.
    num_chunks > 1 gathers and multiplies the K extent in pieces, the
    next piece's gathers started before the current product;
    collect_chunks > 1 sums the partial C over z in row slabs, each
    slab's psum started before the next slab's product; throttle waits
    for A's gather before starting B's (at most one in flight).
  * 'ring': Cannon rotation; a pre-skew, then d steps of a local product
    and single-hop shifts of A along x and B along y. Square slices only.
  * 'gspmd': the owner computes its C block from A's rows (gathered along
    x) and B's columns (gathered along y); every depth layer computes the
    same block.

On a grid with no mesh (one device, no world) every call is one local
BLAS call: trmm and syrk go straight to the kernel layer (ops/blas.py)
with their windows, and gemm is one plain product. On a mesh of one rank
trmm and syrk do the same (the JAX package's one-device routes), gemm and
transpose run their schedules on groups of one. Per-rank products are
plain products at the precision ladder (ops/precision.dot), as the JAX
package's are. Each call records its analytic per-device cost
(tracing.py).
"""

from __future__ import annotations

import torch

from capital_tpu_torch import tracing
from capital_tpu_torch.grid import Grid, P
from capital_tpu_torch.ops import blas
from capital_tpu_torch.ops.precision import dot as _pdot
from capital_tpu_torch.parallel import collectives as coll
from capital_tpu_torch.parallel import darray
from capital_tpu_torch.parallel.darray import DArray


def _win_shape(x, window) -> tuple[int, int]:
    """The windowed extent (cost recording), not the backing tensor's."""
    if window is None:
        return tuple(x.shape)
    return (window[2], window[3])


def _record_gemm_cost(grid: Grid, a_shape, b_shape, esz: int,
                      collect_chunks: int = 1):
    """Analytic per-device cost of one 2.5D gemm: 2mnk/(d^2 c) flops; two
    all_gathers of the K panels + one psum over depth. Only active inside
    tracing.trace()."""
    if tracing.active() is None:
        return
    d, c = grid.d1, grid.c
    m, k = a_shape
    n = b_shape[1]
    flops = 2.0 * m * n * k / (d * d * c)
    cc = max(1, collect_chunks) if c > 1 else 1
    comm = (
        tracing.all_gather_bytes(m * k * esz / (d * d * c), grid.d2)
        + tracing.all_gather_bytes(k * n * esz / (d * d * c), d)
        + tracing.psum_bytes(m * n * esz / (d * d), c)
    )
    tracing.record("summa.gemm", flops=flops, comm_bytes=comm, msgs=2 + cc)


IMPLS = ("shard_map", "ring", "gspmd")


def _check_divisible(grid: Grid, a_shape, b_shape):
    d, c = grid.d, grid.c
    m, k = a_shape
    k2, n = b_shape
    if k != k2:
        raise ValueError(f"gemm shape mismatch: {tuple(a_shape)} @ "
                         f"{tuple(b_shape)}")
    if m % d or n % d or k % (d * c):
        raise ValueError(
            f"summa needs d | m,n and d*c | k: m={m} n={n} k={k} d={d} c={c}"
        )


def _z_slice(mesh, a_blk, b_blk, ax_z):
    """Layer z takes the z-th K sub-slice of every block."""
    if ax_z is None:
        return a_blk, b_blk
    z = mesh.axis_index((ax_z,))
    c = mesh.axis_size((ax_z,))
    kc_a = a_blk.shape[1] // c
    kc_b = b_blk.shape[0] // c
    return (a_blk[:, z * kc_a:(z + 1) * kc_a],
            b_blk[z * kc_b:(z + 1) * kc_b])


def _summa_local(mesh, ax_z, ax_y, ax_x, a_blk, b_blk, num_chunks: int = 1,
                 throttle: bool = False, collect_chunks: int = 1):
    """The 'shard_map' schedule on this rank's blocks a_blk (mb, kb),
    b_blk (kb, nb)."""
    a_sub, b_sub = _z_slice(mesh, a_blk, b_blk, ax_z)
    chunks = num_chunks
    while a_sub.shape[1] % chunks or b_sub.shape[0] % chunks:
        chunks -= 1
    ka = a_sub.shape[1] // chunks
    kb = b_sub.shape[0] // chunks

    def gather_a(rows, i):
        return coll.all_gather_async(rows[:, i * ka:(i + 1) * ka], mesh,
                                     ax_x, dim=1)

    def gather_b(i):
        return coll.all_gather_async(b_sub[i * kb:(i + 1) * kb], mesh,
                                     ax_y, dim=0)

    cc = collect_chunks if ax_z is not None else 1
    while a_sub.shape[0] % cc:
        cc -= 1
    if cc <= 1:
        def start(i):
            pa = gather_a(a_sub, i)
            if throttle:  # B's gather waits for A's
                a_k = pa.wait()
                return (lambda: a_k), gather_b(i).wait
            return pa.wait, gather_b(i).wait

        part = None
        nxt = start(0)
        for i in range(chunks):
            get_a, get_b = nxt
            if i + 1 < chunks:
                nxt = start(i + 1)  # in flight during product i
            p = _pdot(get_a(), get_b())
            part = p if part is None else part + p
        if ax_z is not None:
            part = coll.psum(part, mesh, ax_z)
        return part.to(a_blk.dtype)
    # collect-pipelined: B's K panels gathered once up front; then per
    # row slab one A gather + product + psum, slab i's psum in flight
    # while slab i+1's gathers and product run
    b_ks = [gather_b(j).wait() for j in range(chunks)]
    mb = a_sub.shape[0] // cc
    pending = []
    for i in range(cc):
        rows = a_sub[i * mb:(i + 1) * mb]
        part = None
        for j in range(chunks):
            p = _pdot(gather_a(rows, j).wait(), b_ks[j])
            part = p if part is None else part + p
        pending.append(coll.psum_async(part, mesh, ax_z))
    return torch.cat([s.wait() for s in pending]).to(a_blk.dtype)


def _ring_local(mesh, ax_z, ax_y, ax_x, d: int, a_blk, b_blk,
                collect_chunks: int = 1):
    """The 'ring' (Cannon) schedule on this rank's blocks: pre-skew over
    the joint (y, x) axis, then d steps of a local product and one hop of
    A along x and of B along y."""
    a_sub, b_sub = _z_slice(mesh, a_blk, b_blk, ax_z)
    skew_a = [(y * d + j, y * d + (j - y) % d)
              for y in range(d) for j in range(d)]
    skew_b = [(i * d + x, ((i - x) % d) * d + x)
              for i in range(d) for x in range(d)]
    joint = tuple(a for a in (ax_y, ax_x) if a is not None)
    a_s = coll.ppermute(a_sub, mesh, joint, skew_a)
    b_s = coll.ppermute(b_sub, mesh, joint, skew_b)
    rot = [(j, (j - 1) % d) for j in range(d)]
    cc = collect_chunks if ax_z is not None else 1
    while a_s.shape[0] % cc:
        cc -= 1
    part = None
    for s in range(d):
        if s + 1 == d and cc > 1:
            # the last step's product in row slabs, each slab's depth
            # psum in flight while the next slab's product runs
            mb = a_s.shape[0] // cc
            pending = []
            for i in range(cc):
                p = _pdot(a_s[i * mb:(i + 1) * mb], b_s)
                if part is not None:
                    p = p + part[i * mb:(i + 1) * mb]
                pending.append(coll.psum_async(p, mesh, ax_z))
            part = torch.cat([x.wait() for x in pending])
        else:
            p = _pdot(a_s, b_s)
            part = p if part is None else part + p
        if s + 1 < d:
            a_s = coll.ppermute(a_s, mesh, ax_x, rot)
            b_s = coll.ppermute(b_s, mesh, ax_y, rot)
    if ax_z is not None and cc <= 1:
        part = coll.psum(part, mesh, ax_z)
    return part.to(a_blk.dtype)


def _gspmd_local(mesh, ax_y, ax_x, a_blk, b_blk):
    """C's (y, x) block from A's block row (gathered along x) and B's
    block column (gathered along y)."""
    a_rows = coll.all_gather(a_blk, mesh, ax_x, dim=1)
    b_cols = coll.all_gather(b_blk, mesh, ax_y, dim=0)
    return _pdot(a_rows, b_cols).to(a_blk.dtype)


def _epilogue(grid: Grid, out, c, alpha, beta):
    """alpha * out + beta * c, on the local blocks of a DArray."""
    dist_out = isinstance(out, DArray)
    t = out.local if dist_out else out
    if alpha != 1.0:
        t = alpha * t
    if c is not None and beta != 0.0:
        cl = grid.constrain(c, out.spec).local if dist_out else c
        t = t + beta * cl
    return out.with_local(t) if dist_out else t


def gemm(grid: Grid, a, b, *, c=None, alpha=1.0, beta=0.0,
         impl="shard_map", num_chunks: int = 1, throttle: bool = False,
         collect_chunks: int = 1):
    """C = alpha * A @ B + beta * C, distributed. impl is one of IMPLS
    (any other raises ValueError); on a mesh the result is a DArray of
    the slice spec."""
    if impl not in IMPLS:
        raise ValueError(f"unknown summa impl {impl!r}")
    _record_gemm_cost(grid, tuple(a.shape), tuple(b.shape),
                      darray.element_size(a), collect_chunks=collect_chunks)
    if grid.mesh is None:
        out = _pdot(a, b).to(a.dtype)
        return _epilogue(grid, out, c, alpha, beta)
    spec = grid.slice_spec
    if impl != "gspmd":
        _check_divisible(grid, a.shape, b.shape)
    a = grid.constrain(a, spec)
    b = grid.constrain(b, spec)
    mesh = grid.mesh
    if impl == "gspmd":
        local = _gspmd_local(mesh, grid.ax_y, grid.ax_x, a.local, b.local)
    elif impl == "ring":
        local = _ring_local(mesh, grid.ax_z, grid.ax_y, grid.ax_x, grid.d,
                            a.local, b.local, collect_chunks)
    else:
        local = _summa_local(mesh, grid.ax_z, grid.ax_y, grid.ax_x,
                             a.local, b.local, num_chunks, throttle,
                             collect_chunks)
    out = DArray(local, (a.shape[0], b.shape[1]), spec, mesh)
    return _epilogue(grid, out, c, alpha, beta)


def transpose(grid: Grid, a, impl="shard_map"):
    """Distributed transpose: every rank swaps blocks with its grid-
    transposed partner (one ppermute over the joint (row, col) axis),
    then transposes locally; under 'gspmd' a redistribution of the
    transposed blocks. On no mesh a local one."""
    tracing.record("summa.transpose",
                   comm_bytes=tracing.ppermute_bytes(
                       a.shape[0] * a.shape[1] * darray.element_size(a)
                       / max(grid.d1 * grid.d2, 1)),
                   msgs=1)
    if grid.mesh is None:
        return a.T.contiguous()
    spec = grid.slice_spec
    if impl == "gspmd":
        x = darray.as_darray(a, grid.mesh)
        t = DArray(x.local.T, (x.shape[1], x.shape[0]),
                   (x.spec[1], x.spec[0]), grid.mesh)
        return grid.constrain(t, spec)
    x = grid.constrain(a, spec)
    d = grid.d
    perm = [(y * d + xx, xx * d + y) for y in range(d) for xx in range(d)]
    joint = tuple(ax for ax in (grid.ax_y, grid.ax_x) if ax is not None)
    blk = coll.ppermute(x.local, grid.mesh, joint, perm)
    return DArray(blk.T.contiguous(), (x.shape[1], x.shape[0]), spec,
                  grid.mesh)


def _structure(t: DArray, uplo: str) -> DArray:
    return t.triu() if uplo == "U" else t.tril()


def trmm(grid: Grid, a, b, *, side="L", uplo="U", trans_a=False, alpha=1.0,
         impl="shard_map", num_chunks: int = 1, throttle: bool = False,
         collect_chunks: int = 1, a_window=None, b_window=None):
    """Triangular multiply. a_window/b_window=(r0, c0, h, w) operate on
    windows of larger arrays: without copying on one device (the kernel
    reads the window), as gathered windows across ranks. On a mesh of
    more than one rank the triangle is a mask on A and the multiply is
    the gemm engine; under 'gspmd' with trans_a, A^T is contracted
    without the block-exchange transpose."""
    if grid.num_devices == 1:
        aw, bw = _win_shape(a, a_window), _win_shape(b, b_window)
        if side == "L":
            _record_gemm_cost(grid, aw, bw, darray.element_size(a))
        else:
            _record_gemm_cost(grid, bw, aw, darray.element_size(a))
        out = blas.trmm(darray.whole(a), darray.whole(b), side=side,
                        uplo=uplo, trans_a=trans_a, alpha=alpha,
                        platform=grid.platform, a_window=a_window,
                        b_window=b_window)
        if grid.mesh is None:
            return out
        return darray.distribute(out, grid.mesh, grid.slice_spec)
    spec = grid.slice_spec
    a = darray.window(grid.constrain(a, spec), a_window)
    b = darray.window(grid.constrain(b, spec), b_window)
    t = _structure(a, uplo)
    kw = dict(impl=impl, num_chunks=num_chunks, throttle=throttle,
              collect_chunks=collect_chunks)
    if trans_a and impl == "gspmd" and side == "L":
        return _contract_t(grid, t, b, None, alpha, 0.0)
    if trans_a:
        t = transpose(grid, t, impl=impl)
    if side == "L":
        return gemm(grid, t, b, alpha=alpha, **kw)
    return gemm(grid, b, t, alpha=alpha, **kw)


def _contract_t(grid: Grid, a: DArray, b: DArray, c, alpha, beta):
    """alpha * A^T B + beta * C under 'gspmd': C's (y, x) block is A's
    column block y transposed times B's column block x, each
    redistributed whole down the rows."""
    _record_gemm_cost(grid, tuple(a.shape), tuple(b.shape),
                      darray.element_size(a))
    spec = grid.slice_spec
    a_c = darray.reshard(a, P(None, spec[0])).local
    b_c = darray.reshard(b, P(None, spec[1])).local
    out = DArray(_pdot(a_c.T, b_c).to(a.dtype), (a.shape[1], b.shape[1]),
                 spec, grid.mesh)
    return _epilogue(grid, out, c, alpha, beta)


def syrk(grid: Grid, a, *, c=None, alpha=1.0, beta=0.0, impl="shard_map",
         num_chunks: int = 1, throttle: bool = False,
         collect_chunks: int = 1, a_window=None):
    """C = alpha * A^T A + beta * C: the dominant-flop call of cholinv's
    Schur updates. Across ranks: the grid transpose of A times A through
    the gemm engine ('gspmd': A^T A contracted directly)."""
    if grid.num_devices == 1:
        aw = _win_shape(a, a_window)
        _record_gemm_cost(grid, aw, aw, darray.element_size(a))
        cl = darray.whole(c) if c is not None else None
        out = blas.syrk(darray.whole(a), c=cl, alpha=alpha, beta=beta,
                        platform=grid.platform, a_window=a_window)
        if grid.mesh is None:
            return out
        return darray.distribute(out, grid.mesh, grid.slice_spec)
    a = darray.window(grid.constrain(a, grid.slice_spec), a_window)
    return syrk2(grid, a, a, c=c, alpha=alpha, beta=beta, impl=impl,
                 num_chunks=num_chunks, throttle=throttle,
                 collect_chunks=collect_chunks)


def syrk2(grid: Grid, a, b, *, c=None, alpha=1.0, beta=0.0,
          impl="shard_map", num_chunks: int = 1, throttle: bool = False,
          collect_chunks: int = 1):
    """Two-matrix SYRK: C = alpha * A^T B + beta * C (polar's H = U^T A).
    On no mesh one plain product, recorded as the gemm it is."""
    if grid.mesh is None:
        return gemm(grid, a.T, b, c=c, alpha=alpha, beta=beta, impl=impl,
                    num_chunks=num_chunks, throttle=throttle,
                    collect_chunks=collect_chunks)
    if impl == "gspmd":
        spec = grid.slice_spec
        return _contract_t(grid, grid.constrain(a, spec),
                           grid.constrain(b, spec), c, alpha, beta)
    at = transpose(grid, a, impl=impl)
    return gemm(grid, at, b, c=c, alpha=alpha, beta=beta, impl=impl,
                num_chunks=num_chunks, throttle=throttle,
                collect_chunks=collect_chunks)
