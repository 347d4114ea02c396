"""ALS matrix-factorization recommender by batched normal-equation Cholesky
solves (counterpart of capital_tpu/apps/als.py), on one device.

Model: ratings R (users x items, observed entries masked), factors U
(users x k), V (items x k), ridge lambda. Each half-step is a batch of
k x k SPD normal-equation solves:

    per user u:  (V^T diag(m_u) V + lam*I) U_u = V^T (m_u * r_u)

Dense path (`fit`): the per-user Gramians of every user at once. The JAX
package writes them as the einsum 'ui,ik,il->ukl'; contracted left to
right that would hold a (users, items, k) tensor (137 GB at the bench's
65536 x 8192 x 64), so here each is one product at the ambient precision,
G = M @ (V (x) V) with V (x) V the (items, k^2) row-wise outer products,
reshaped to (users, k, k); the item side is the same with U (x) U. The
solves are a batched Cholesky and two triangular solves (stock library
calls, as the JAX package takes them from lax.linalg).

Sparse path (`fit_sparse`): fixed-width observation buckets on both sides
of the bipartite graph (`SparseRatings`), O(nnz k^2) a side, gathered and
solved in row chunks.

The random draws (the synthetic data's and the initial V) come from a
torch.Generator on the grid's device, each in its own helper; they are
not jax.random's. The sparse data's noise is an integer hash of (user,
item), bitwise the JAX package's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from capital_tpu_torch import tracing
from capital_tpu_torch.algs.cacqr import _operand
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.matrix import _generator
from capital_tpu_torch.ops import lapack
from capital_tpu_torch.ops.precision import dot as _pdot


@dataclass(frozen=True)
class Config:
    rank: int = 64
    lam: float = 0.1
    num_iters: int = 10


def _ratings_draws(grid: Grid, users: int, items: int, rank: int, key,
                   dtype):
    """The dense generator's draws, in order: the planted factors' (users,
    rank) and (items, rank) standard normals, the (users, items) noise
    normals and the (users, items) Uniform(0, 1) mask draws."""
    gen, dev = _generator(grid, key), grid.device
    ut = torch.randn((users, rank), generator=gen, device=dev, dtype=dtype)
    vt = torch.randn((items, rank), generator=gen, device=dev, dtype=dtype)
    noise = torch.randn((users, items), generator=gen, device=dev,
                        dtype=dtype)
    unif = torch.rand((users, items), generator=gen, device=dev)
    return ut, vt, noise, unif


def synthetic_ratings(grid: Grid, users: int, items: int, key,
                      rank: int = 16, density: float = 0.05,
                      dtype=torch.float32):
    """Planted low-rank ratings + N(0, 0.05^2) noise under a
    Bernoulli(density) observation mask. key: an int seed or a
    torch.Generator on the grid's device. Returns (R * M, M)."""
    pu = -(-users // grid.num_devices) * grid.num_devices
    ut, vt, noise, unif = _ratings_draws(grid, pu, items, rank, key, dtype)
    ut, vt = ut / math.sqrt(rank), vt / math.sqrt(rank)
    r = _pdot(ut, vt.T).to(dtype) + 0.05 * noise
    del noise
    m = unif < density
    del unif
    m[users:] = False
    return r * m, m.to(dtype)


def _solve_batch(g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x_i with G_i x_i = b_i for a batch of SPD k x k systems: batched
    Cholesky (NaN where G_i is not positive definite, as
    lax.linalg.cholesky) and two triangular solves."""
    lo = lapack._cholesky(g)
    y = torch.linalg.solve_triangular(lo, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(lo.mT, y, upper=True)
    return x[..., 0]


def _outer(f: torch.Tensor) -> torch.Tensor:
    """(rows, k) -> (rows, k*k): row i is f_i f_i^T, flattened."""
    return (f[:, :, None] * f[:, None, :]).reshape(f.shape[0], -1)


def _update_users(grid: Grid, r, m, v, lam):
    """U from fixed V: G_u = sum_i m_ui v_i v_i^T, b_u = sum_i r_ui v_i."""
    k = v.shape[1]
    eye = lam * torch.eye(k, dtype=v.dtype, device=v.device)
    g = _pdot(m, _outer(v)).reshape(-1, k, k)
    b = _pdot(r, v)
    return _solve_batch(g + eye, b)


def _update_items(grid: Grid, r, m, u, lam):
    """V from fixed U: G_i = sum_u m_ui u_u u_u^T, b_i = sum_u r_ui u_u
    (on one device the JAX package's psum of the shards' parts is the
    identity)."""
    k = u.shape[1]
    eye = lam * torch.eye(k, dtype=u.dtype, device=u.device)
    g = _pdot(m.T, _outer(u)).reshape(-1, k, k)
    b = _pdot(r.T, u)
    return _solve_batch(g + eye, b)


def rmse(grid: Grid, r, m, u, v) -> torch.Tensor:
    """Observed-entry RMSE, a 0-d tensor."""
    pred = _pdot(u, v.T)
    se = torch.sum(torch.square((pred - r) * m))
    cnt = torch.sum(m)
    return torch.sqrt(se / torch.clamp(cnt, min=1.0))


# ---------------------------------------------------------------------------
# bucketed-sparse path: regular bipartite observations, O(nnz k^2) updates
# ---------------------------------------------------------------------------

class SparseRatings(NamedTuple):
    """Fixed-width observation buckets on both sides of the bipartite graph.

    idx   (U, s): item ids rated by each user (s per user, exactly)
    val   (U, s): the ratings
    idx_t (I, t): user ids rating each item (t = s*U/I per item, exactly)
    val_t (I, t): the same ratings, item-major
    """

    idx: torch.Tensor
    val: torch.Tensor
    idx_t: torch.Tensor
    val_t: torch.Tensor


def _regular_draws(grid: Grid, users: int, items: int, s: int, rank: int,
                   key, dtype):
    """The regular generator's draws, in order: s random permutations of
    the items (s, items), s shifts in [0, items), and the planted factors'
    (users, rank) and (items, rank) standard normals."""
    gen, dev = _generator(grid, key), grid.device
    perms = torch.argsort(torch.rand((s, items), generator=gen, device=dev),
                          dim=1)
    shifts = torch.randint(0, items, (s,), generator=gen, device=dev)
    ut = torch.randn((users, rank), generator=gen, device=dev, dtype=dtype)
    vt = torch.randn((items, rank), generator=gen, device=dev, dtype=dtype)
    return perms, shifts, ut, vt


_M32 = 0xFFFFFFFF


def _noise(u: torch.Tensor, i: torch.Tensor, dtype) -> torch.Tensor:
    """The edge hash of (user, item) as noise in [-0.05, 0.05): the JAX
    package's uint32 arithmetic, carried in int64 and reduced mod 2^32
    after each multiply, so it is bitwise the same from either view."""
    h = (((u.to(torch.int64) * 0x9E3779B1) & _M32)
         + ((i.to(torch.int64) * 0x85EBCA77) & _M32)) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _M32
    h = h ^ (h >> 12)
    unit = (h >> 8).to(torch.float32) / float(1 << 24)
    return (0.05 * (2.0 * unit - 1.0)).to(dtype)


def _row_chunks(rows: int, chunks: int) -> int:
    """The largest count <= chunks that divides rows (the JAX package's
    lax.map chunking)."""
    nch = chunks
    while rows % nch:
        nch -= 1
    return rows // nch


def _edge_vals(row_f, col_f, row_ids, col_idx, row_is_user, chunks=16):
    """val[r, s] = <row_f[r], col_f[col_idx[r, s]]> + noise(user, item),
    in row chunks so the (rows, s, k) gather never materializes whole."""
    rows = col_idx.shape[0]
    step = _row_chunks(rows, chunks)
    out = torch.empty(col_idx.shape, dtype=row_f.dtype, device=row_f.device)
    for r0 in range(0, rows, step):
        rid, cix = row_ids[r0:r0 + step], col_idx[r0:r0 + step]
        v = _pdot(col_f[cix], row_f[rid][:, :, None])[..., 0]
        if row_is_user:
            out[r0:r0 + step] = v + _noise(rid[:, None], cix, v.dtype)
        else:
            out[r0:r0 + step] = v + _noise(cix, rid[:, None], v.dtype)
    return out


def synthetic_regular(grid: Grid, users: int, items: int, s: int, key,
                      rank: int = 16, dtype=torch.float32) -> SparseRatings:
    """Regular random bipartite ratings: s observations per user, s*U/I per
    item, built from s permutation rounds (round r: user u rates item
    pi_r[(u + h_r) mod I]). Both index structures come from the
    permutations and their inverses. A user may rate an item twice across
    rounds. Requires items | users. key: an int seed or a
    torch.Generator on the grid's device."""
    if users % items:
        raise ValueError("synthetic_regular needs items | users")
    dev = grid.device
    perms, shifts, ut, vt = _regular_draws(grid, users, items, s, rank, key,
                                           dtype)
    inv = torch.argsort(perms, dim=1)                          # (s, I)

    u_ids = torch.arange(users, device=dev)
    # user-major: idx[u, r] = perms[r, (u + h_r) % I]
    slot = (u_ids[:, None] + shifts[None, :]) % items           # (U, s)
    idx = perms[torch.arange(s, device=dev)[None, :], slot]

    # item-major: idx_t[i, r, m] = m*I + (inv[r, i] - h_r) % I
    reps = users // items
    base = (inv.T - shifts[None, :]) % items                    # (I, s)
    idx_t = (base[:, :, None]
             + items * torch.arange(reps, device=dev)[None, None, :])
    idx_t = idx_t.reshape(items, s * reps)

    ut, vt = ut / math.sqrt(rank), vt / math.sqrt(rank)
    val = _edge_vals(ut, vt, u_ids, idx, row_is_user=True)
    val_t = _edge_vals(vt, ut, torch.arange(items, device=dev), idx_t,
                       row_is_user=False)
    return SparseRatings(idx=idx, val=val.to(dtype), idx_t=idx_t,
                         val_t=val_t.to(dtype))


def _solve_side(factors_other, idx, val, lam, rank, chunks: int = 8):
    """One ALS side: for each row, gather its bucket of other-side factors,
    form the k x k normal equations and solve them, in row chunks."""
    rows = idx.shape[0]
    eye = lam * torch.eye(rank, dtype=factors_other.dtype,
                          device=factors_other.device)
    step = _row_chunks(rows, chunks)
    out = torch.empty((rows, rank), dtype=factors_other.dtype,
                      device=factors_other.device)
    for r0 in range(0, rows, step):
        f = factors_other[idx[r0:r0 + step]]            # (chunk, s, k)
        g = _pdot(f.transpose(1, 2), f) + eye
        b = _pdot(val[r0:r0 + step, None, :], f)[:, 0]
        out[r0:r0 + step] = _solve_batch(g, b)
    return out


def _initial_v(items: int, rank: int, dtype, device, key=0) -> torch.Tensor:
    """ALS's starting V, unscaled: (items, rank) standard normals from a
    generator seeded `key` (or `key` itself, a torch.Generator)."""
    gen = (key if isinstance(key, torch.Generator)
           else torch.Generator(device=device).manual_seed(int(key)))
    return torch.randn((items, rank), generator=gen, device=device,
                       dtype=dtype)


def fit_sparse(grid: Grid, data: SparseRatings, cfg: Config = Config(),
               items: int | None = None):
    """ALS over bucketed-sparse observations, O(nnz * k^2) a side. Returns
    (U, V, rmse over the observed edges as a 0-d tensor)."""
    val = _operand(grid, data.val)
    users = data.idx.shape[0]
    items = items or int(data.idx_t.shape[0])
    v = _initial_v(items, cfg.rank, val.dtype, val.device) / math.sqrt(
        cfg.rank)
    u = torch.zeros((users, cfg.rank), dtype=val.dtype, device=val.device)
    for _ in range(cfg.num_iters):
        with tracing.phase("ALS::users"):
            u = _solve_side(v, data.idx, data.val, cfg.lam, cfg.rank)
        with tracing.phase("ALS::items"):
            v = _solve_side(u, data.idx_t, data.val_t, cfg.lam, cfg.rank)

    # observed-edge RMSE, chunked like the updates
    step = _row_chunks(users, 8)
    se = torch.stack([
        torch.sum(torch.square(
            _pdot(v[data.idx[r0:r0 + step]], u[r0:r0 + step, :, None])[..., 0]
            - data.val[r0:r0 + step]))
        for r0 in range(0, users, step)]).sum()
    return u, v, torch.sqrt(se / data.val.numel())


def fit(grid: Grid, r, m, cfg: Config = Config(), key=None):
    """Run ALS from V0 = N(0, 1/rank) (key: an int seed or a
    torch.Generator, default seed 0); returns (U, V, rmse as a 0-d
    tensor). No host sync inside the loop."""
    r = _operand(grid, r)
    users, items = r.shape
    v = _initial_v(items, cfg.rank, r.dtype, r.device,
                   0 if key is None else key) / math.sqrt(cfg.rank)
    u = torch.zeros((users, cfg.rank), dtype=r.dtype, device=r.device)
    for _ in range(cfg.num_iters):
        with tracing.phase("ALS::users"):
            u = _update_users(grid, r, m, v, cfg.lam)
        with tracing.phase("ALS::items"):
            v = _update_items(grid, r, m, u, cfg.lam)
    return u, v, rmse(grid, r, m, u, v)
