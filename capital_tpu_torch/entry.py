"""Entry points (counterpart of __graft_entry__.py): the
one-device step and the multi-device dry run.

    fn, args = entry()          # cuda:0; entry('cpu') on the CPU
    r, rinv = fn(*args)
    figs = dryrun_multichip(8, device="cpu")   # 8 gloo CPU ranks
    figs = dryrun_multichip(torch.cuda.device_count())  # a NCCL rank a card

    python -m capital_tpu_torch.entry [--device cuda|cpu] [--devices N]

runs entry()'s step and then the dry run (with --device cpu on 8 gloo
CPU ranks unless --devices says: the JAX module's __main__, which forces
the CPU and its 8 virtual devices).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from capital_tpu_torch.algs import cholinv
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.parallel import launch

# The dry run's tall operands have 64 P and 32 P rows (P the ranks), the
# JAX dry run's, but never fewer than at P = 4: below it the JAX dry run's
# own operands fail its bounds (P = 1: the 64 x 128 CholeskyQR operand is
# wide, its orthogonality NaN; P = 2: polar of the 64 x 64 square with
# l0 = 1e-2 reads 0.125), and a card is one rank.
ROWS_MIN_P = 4

# The dry run's steps, in the JAX dry run's order: (name, what its figure
# is, the JAX dry run's bound on it: the figure must stay below it, or for
# the singular values at or above it; None where it asserts nothing).
STEPS = (
    ("cholinv", "cholesky residual", 1e-3),
    ("ring", "cholesky residual", None),
    ("cholinv_cyclic", "cholesky residual", 1e-3),
    ("cacqr_1d", "orthogonality", 1e-3),
    ("hybrid", "orthogonality", 1e-3),
    ("trsm", "relative residual", None),
    ("lu", "solve residual", 1e-2),
    ("tsqr", "orthogonality", 1e-3),
    ("polar", "orthogonality", 1e-3),
    ("eigh_partial", "residual", 1e-2),
    ("svd_partial", "least singular value", -1e-6),
    ("newton", "residual", 1e-2),
)


def entry(device=None):
    """(fn, example_args): fn(a) -> (R, Rinv) of cholinv.factor on a
    one-device grid; a = (U + U^T)/2 + n I with U Uniform(-0.5, 0.5)
    (seed 0), n = 512."""
    grid = Grid.square(c=1, d=1, device=device)
    cfg = cholinv.Config(base_method="auto", summa_impl="gspmd")

    def fn(a):
        r, rinv = cholinv.factor(grid, a, cfg)
        return r, rinv

    n = 512
    gen = torch.Generator(device=grid.device).manual_seed(0)
    u = torch.rand((n, n), generator=gen, device=grid.device) - 0.5
    a = (u + u.T) * 0.5 + n * torch.eye(n, device=grid.device)
    return fn, (a,)


def _grid_shape(p: int) -> tuple[int, int, int]:
    """Largest square slice d with d^2 | p; remainder becomes depth c."""
    d = 1
    for cand in range(int(math.isqrt(p)), 0, -1):
        if p % (cand * cand) == 0:
            d = cand
            break
    return (p // (d * d), d, d)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """One full distributed step of every path over n_devices ranks, the
    JAX dry run's steps with its configs, in its order (STEPS), each held
    to its bound (AssertionError, as the JAX dry run asserts): the c x d x
    d grid of _grid_shape (2.5D cholinv with the LAYER base case and the
    chunked depth collect, the ring engine, the cyclic workspace),
    CholeskyQR2 1D over every rank, the hybrid Gram on the rect grid of 2
    (when n_devices is at least 8 and divisible by 4), rectri + trsm, the
    LU solve, the TSQR tree, polar 1d, eigh_partial top-8, svd_partial and
    Newton. The tall operands have the JAX dry run's rows, as at
    ROWS_MIN_P ranks when there are fewer.

    device 'cuda': one NCCL rank a card, n_devices visible cards needed
    (fewer raise: the dry run never moves to the CPU unasked); 'cpu':
    n_devices gloo CPU ranks (launch.devices_for, launch.run_on). Inside
    a world of n_devices ranks it runs on it; one device outside a world
    runs here on the one-device grid. Returns {step: {"what", "value",
    "bound", "held"}} (every rank computes the same figures)."""
    devs = launch.devices_for(device, n_devices)
    return launch.run_on(_dryrun, devs, n_devices)


def _held(figs: dict, step: str, value: float) -> None:
    what, bound = next((w, b) for s, w, b in STEPS if s == step)
    held = (True if bound is None
            else value >= bound if step == "svd_partial" else value < bound)
    figs[step] = {"what": what, "value": value, "bound": bound,
                  "held": held}
    assert held, f"{step} {what} {value}"


def _rel_residual(a, x, b) -> float:
    """||A x - b|| / ||b|| in f64 on the host."""
    from capital_tpu_torch.interop import to_numpy

    a64, x64, b64 = (np.asarray(to_numpy(v), np.float64) for v in (a, x, b))
    return float(np.linalg.norm(a64 @ x64 - b64)
                 / max(np.linalg.norm(b64), 1e-30))


def _dryrun(device, n_devices: int) -> dict:
    """The dry run on this rank of a world of n_devices ranks (device
    None), or on `device` alone."""
    from capital_tpu_torch import matrix, validate
    from capital_tpu_torch.algs import (cacqr, cholinv_cyclic, eigh, lu,
                                        newton, polar, rectri, svd, trsm,
                                        tsqr)
    from capital_tpu_torch.interop import to_numpy
    from capital_tpu_torch.parallel import darray

    figs: dict = {}
    rows_p = max(n_devices, ROWS_MIN_P)
    c, d, _ = _grid_shape(n_devices)
    grid = Grid.square(c=c, d=d, device=device)

    # --- 2.5D path: distributed recursive Cholesky + inverse -------------
    n = max(256, 128 * d * c)
    a = matrix.symmetric(grid, n, 0)
    ccfg = cholinv.Config(base_method="xla", summa_impl="shard_map",
                          base_policy="layer", summa_chunks=2,
                          summa_collect_chunks=2)
    r, _ = cholinv.factor(grid, a.data, ccfg)
    _held(figs, "cholinv", float(validate.cholesky_residual(grid, a.data,
                                                            r)))

    # the ring (Cannon) engine on the same grid
    rcfg = cholinv.Config(base_method="xla", summa_impl="ring")
    rr, _ = cholinv.factor(grid, a.data, rcfg)
    _held(figs, "ring", float(validate.cholesky_residual(grid, a.data, rr)))
    del rr

    # the cyclic workspace on the same grid
    ycfg = cholinv.Config(base_method="xla", min_bc=128)
    ry, _ = cholinv_cyclic.factor(grid, a.data, ycfg)
    _held(figs, "cholinv_cyclic",
          float(validate.cholesky_residual(grid, a.data, ry)))
    del ry

    # --- 1D path: tall-skinny CholeskyQR2 over every rank ----------------
    m, k = 64 * rows_p, 128
    ts = matrix.tall_skinny(grid, m, k, 1)
    qcfg = cacqr.Config(num_iter=2, base_method="xla")
    q, _ = cacqr.factor_1d(grid, ts.data, qcfg)
    _held(figs, "cacqr_1d",
          float(validate.qr_orthogonality(grid, q, layout="1d")))
    del q, ts

    # --- hybrid path: rect grid, Gram on the (z, x) square view ----------
    rect_c = 2 if n_devices % 4 == 0 and n_devices >= 8 else 1
    if rect_c > 1:
        rgrid = Grid.rect(c=rect_c, device=device)
        th = matrix.tall_skinny(rgrid, 32 * rows_p, 128, 2)
        hcfg = cacqr.Config(
            num_iter=2, gram_policy="two_stage",
            chol=cholinv.Config(min_bc=64, base_method="xla"))
        qh, _ = cacqr.factor_hybrid(rgrid, th.data, hcfg)
        _held(figs, "hybrid",
              float(validate.qr_orthogonality(rgrid, qh, layout="1d")))
        del qh, th

    # --- triangular: rectri inverse + trsm substitution ------------------
    rw = darray.to_global(r)
    tl = torch.tril(rw.T) + n * torch.eye(n, dtype=rw.dtype,
                                          device=rw.device)
    tl = grid.constrain(tl, grid.slice_spec)
    tcfg = trsm.Config(nb=max(64, n // 4),
                       tri=rectri.Config(min_bc=64, base_method="xla"))
    b = matrix.rand(grid, n, 64, 3).data
    x = trsm.solve(grid, tl, b, lower=True, cfg=tcfg)
    _held(figs, "trsm", _rel_residual(tl, x, b))
    del r, rw, tl, b, x

    # --- general direct solver: LU with partial pivoting -----------------
    ag = matrix.rand(grid, n, n, 5).data
    bg = matrix.rand(grid, n, 32, 6).data
    lcfg = lu.Config(nb=max(64, n // 4), summa_impl="shard_map")
    w, perm, _ = lu.factor(grid, ag, lcfg)
    xg = lu.solve_factored(grid, w, perm, bg, trsm_cfg=tcfg)
    _held(figs, "lu", _rel_residual(ag, xg, bg))
    del ag, bg, w, xg

    # --- TSQR tree QR over the row-sharded grid --------------------------
    tq = matrix.tall_skinny(grid, 64 * rows_p, 32, 7)
    qt, _ = tsqr.factor(grid, tq.data)
    _held(figs, "tsqr",
          float(validate.qr_orthogonality(grid, qt, layout="1d")))
    del qt, tq

    # --- spectral: QDWH polar on the 1d row-sharded layout ---------------
    tsp = matrix.tall_skinny(grid, 32 * rows_p, 64, 4)
    pcfg = polar.Config(l0=1e-2, compute_h=False)  # well-conditioned input
    up = polar.polar(grid, tsp.data, pcfg, layout="1d")
    _held(figs, "polar",
          float(validate.qr_orthogonality(grid, up, layout="1d")))
    del up, tsp

    # --- spectral: top-k partial eigensolver on the square view ----------
    ne, ke = 256, 8
    ae = matrix.symmetric(grid, ne, 8, diag_shift=0.0)
    ecfg = eigh.Config(
        base_n=64,
        polar=polar.Config(compute_h=False,
                           chol=cholinv.Config(min_bc=64,
                                               base_method="xla")))
    we, ve = eigh.eigh_partial(grid, ae.data, ke, ecfg, which="top")
    a64 = np.asarray(to_numpy(ae.data), np.float64)
    v64 = np.asarray(to_numpy(ve), np.float64)
    w64 = np.asarray(to_numpy(we), np.float64)
    _held(figs, "eigh_partial",
          float(np.linalg.norm(a64 @ v64 - v64 * w64)
                / max(np.linalg.norm(a64), 1e-30)))
    del ae, we, ve

    # --- truncated SVD (QDWH polar + partial eig), 1d row-sharded --------
    asv = matrix.tall_skinny(grid, 32 * rows_p, 64, 9)
    scfg = svd.Config(eig=ecfg)
    _, ss, _ = svd.svd_partial(grid, asv.data, 8, scfg, layout="1d")
    _held(figs, "svd_partial", float(to_numpy(ss).min()))
    del asv

    # --- Newton-Schulz iterative inverse ---------------------------------
    an = matrix.symmetric(grid, n, 10)
    ncfg = newton.Config(spd=True, summa_impl="shard_map")
    _, _, resn = newton.invert(grid, an.data, ncfg)
    _held(figs, "newton", float(resn))
    return figs


def main(argv=None) -> dict:
    import argparse

    p = argparse.ArgumentParser(description="entry()'s step, then the "
                                            "multi-device dry run")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: a NCCL rank a card (default); cpu: gloo CPU "
                        "ranks")
    p.add_argument("--devices", type=int, default=None,
                   help="ranks (default: cpu 8, cuda the visible cards)")
    args = p.parse_args(argv)
    n = len(launch.devices_for(args.device, args.devices))
    fn, fargs = entry(args.device)
    r, _ = fn(*fargs)
    assert bool(torch.isfinite(r).all()), "entry: R is not finite"
    print("entry ok")
    figs = dryrun_multichip(n, device=args.device)
    print(f"dryrun_multichip({n}) ok")
    return figs


if __name__ == "__main__":
    main()
