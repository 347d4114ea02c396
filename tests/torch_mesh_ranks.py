"""The port's side of the mesh tests (tests/test_torch_mesh_*.py): the
functions an 8-rank gloo world runs, and the numpy operands both
packages take. This module imports neither JAX nor the JAX package: a
spawned rank re-imports the module its function comes from.

Each `*_world` function runs every case of one test module on every
rank and returns a dict of numpy results (whole arrays gathered on every
rank); `world(fn)` starts the world once and returns rank 0's dict, with
the per-rank entries of every rank under "ranks".
"""

from __future__ import annotations

import contextlib
import functools
import os

import numpy as np
import torch

RANKS = 8
SPECS = {"slice": ("y", "x"), "rows": (("z", "y", "x"), None),
         "repl": (None, None), "zx": ("z", "x"), "cols": (None, "y")}


def world(fn, *args, ranks: int = RANKS):
    """fn(*args) on `ranks` CPU ranks over gloo, one thread each, CAPITAL_*
    switches unset; rank 0's result, with every rank's `rank` entry listed
    under "ranks"."""
    from capital_tpu_torch.parallel.launch import launch

    env = {k: None for k in os.environ if k.startswith("CAPITAL_")}
    outs = launch(fn, ranks, *args, device="cpu", threads=1, env=env,
                  timeout=300.0)
    res = dict(outs[0])
    res["ranks"] = [o.get("rank") for o in outs]
    return res


def operand(m: int, n: int, seed: int) -> np.ndarray:
    """Uniform(-0.5, 0.5), f32."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.5, (m, n)).astype(np.float32)


def tall(m: int, n: int, seed: int) -> np.ndarray:
    """tall_skinny's distribution: Uniform(-0.5, 0.5) times the column
    scale linspace(1, 2)."""
    a = operand(m, n, seed) * np.linspace(1.0, 2.0, n, dtype=np.float32)
    return a.astype(np.float32)


def spd(n: int, seed: int) -> np.ndarray:
    """A well-conditioned SPD matrix: (U + U^T) / 2 + n I."""
    u = operand(n, n, seed)
    return ((u + u.T) * 0.5 + n * np.eye(n, dtype=np.float32)).astype(
        np.float32)


def _grids():
    from capital_tpu_torch import Grid

    return {"222": Grid.square(c=2, d=2), "rect": Grid.rect(c=2),
            "1d8": Grid.rect(c=1)}


def _flat(g222):
    """The 2 x 2 slice of the 2-deep grid, depth unused (plain 2D SUMMA on
    every layer)."""
    return g222.view(z=None, y="y", x="x")


def _np(x):
    from capital_tpu_torch.interop import to_numpy

    return to_numpy(x)


def costs(t) -> dict:
    """{phase/kind: (calls, flops, comm_bytes, msgs)} of a tracer (either
    package's: both keep Costs by phase)."""
    return {k: (c.calls, float(c.flops), float(c.comm_bytes), c.msgs)
            for k, c in t.by_phase.items()}


# ---------------------------------------------------------------------------
# grid, matrix, interop, collectives
# ---------------------------------------------------------------------------

def _catch(fn):
    try:
        out = fn()
        return ("ok", getattr(out, "shape", None))
    except Exception as exc:  # noqa: BLE001 - the error is the result
        return (type(exc).__name__, str(exc))


def grid_world() -> dict:
    import torch.distributed as dist

    from capital_tpu_torch import Grid, interop, matrix
    from capital_tpu_torch.grid import P
    from capital_tpu_torch.parallel import collectives as coll

    me = dist.get_rank()
    out = {"tables": {}, "props": {}, "coords": {}}
    makers = {"square c2 l0": lambda: Grid.square(c=2, d=2),
              "square c2 l1": lambda: Grid.square(c=2, d=2, layout=1),
              "square c2 l2": lambda: Grid.square(c=2, d=2, layout=2),
              "square c8": lambda: Grid.square(c=8, d=1),
              "rect c2": lambda: Grid.rect(c=2),
              "rect c2 l1": lambda: Grid.rect(c=2, layout=1),
              "rect c1": lambda: Grid.rect(c=1),
              "hybrid c2": lambda: Grid.hybrid(c=2, d=2)}
    for name, make in makers.items():
        g = make()
        out["tables"][name] = g.mesh.ranks.copy()
        out["props"][name] = (g.shape, g.c, g.d1, g.d2, g.num_devices,
                              g.is_square, g.platform,
                              tuple(g.mesh.device_mesh.mesh_dim_names))
        out["coords"][name] = tuple(g.mesh.coord[a] for a in "zyx")
    g = Grid.square(c=2, d=2, layout=2)
    views = {}
    for roles in ((None, "z", "x"), ("z", "y", "x"), (None, None, None),
                  ("x", "y", None)):
        v = g.view(*roles)
        views[roles] = (v.shape, v.num_devices, tuple(v.slice_spec),
                        tuple(v.block2d.spec), tuple(v.row1d.spec),
                        tuple(v.replicated.spec))
    out["views"] = views
    out["errors"] = {
        "square c3": _catch(lambda: Grid.square(c=3)),
        "square d3": _catch(lambda: Grid.square(c=1, d=3)),
        "rect c3": _catch(lambda: Grid.rect(c=3)),
        "rect c4": _catch(lambda: Grid.rect(c=4)),
        "layout odd": _catch(lambda: Grid.square(c=8, d=1, layout=2)),
        "layout 5": _catch(lambda: Grid.square(c=2, d=2, layout=5)),
        "hybrid c3": _catch(lambda: Grid.hybrid(c=3))}
    # interop: each rank's block of every spec, and the round trip
    a = operand(16, 8, 0)
    blocks, trips = {}, {}
    for name, spec in SPECS.items():
        x = interop.dist_from_numpy(a, g, spec)
        blocks[name] = x.local.numpy().copy()
        trips[name] = bool(np.array_equal(interop.to_numpy(x), a))
        for other, spec2 in SPECS.items():  # every redistribution
            y = g.constrain(x, P(*spec2))
            trips[f"{name}->{other}"] = bool(
                np.array_equal(interop.to_numpy(y), a)
                and tuple(y.spec) == tuple(P(*spec2)))
    narrow = g.constrain(interop.dist_from_numpy(operand(16, 1, 1), g,
                                                 ("y", None)), P("y", "x"))
    out["rank"] = {"rank": me, "blocks": blocks, "coords": out["coords"],
                   "narrow_spec": tuple(narrow.spec)}
    out["trips"] = trips
    # collectives on the layout-2 grid (its group order differs)
    x = torch.from_numpy(operand(4, 6, 10 + me))
    mesh = g.mesh
    col = {"gather_x1": coll.all_gather(x, mesh, "x", dim=1),
           "gather_yx0": coll.all_gather(x, mesh, ("y", "x"), dim=0),
           "gather_xy0": coll.all_gather(x, mesh, ("x", "y"), dim=0),
           "psum_z": coll.psum(x, mesh, "z"),
           "psum_all": coll.psum(x, mesh, ("z", "y", "x")),
           "scatter_y0": coll.psum_scatter(x, mesh, "y", dim=0),
           "scatter_zyx1": coll.psum_scatter(
               torch.from_numpy(operand(4, 8, 10 + me)), mesh,
               ("z", "y", "x"), dim=1),
           "ppermute_yx": coll.ppermute(x, mesh, ("y", "x"),
                                        [(0, 1), (1, 3), (3, 2), (2, 0)]),
           "ppermute_part": coll.ppermute(x, mesh, "x", [(0, 1)])}
    out["rank"]["coll"] = {k: v.numpy().copy() for k, v in col.items()}
    # generators, born sharded, on three grids
    gens = {}
    for gname, gg in (("222", g), ("222 l0", Grid.square(c=2, d=2)),
                      ("rect", Grid.rect(c=2))):
        s = matrix.symmetric(gg, 200, 3, align=64)
        r = matrix.rand(gg, 100, 60, 4)
        t = matrix.tall_skinny(gg, 1000, 16, 5)
        gens[gname] = {"sym": _np(s.data), "sym_shape": s.shape,
                       "rand": _np(r.data), "tall": _np(t.data),
                       "tall_local": tuple(t.data.local.shape),
                       "tall_spec": tuple(t.data.spec),
                       "debug": _np(matrix.debug(gg, 10, 6).data),
                       "eye": _np(matrix.identity(gg, 6).data),
                       "sym_global": s.to_global().numpy()}
    out["gens"] = gens
    return out


def failing_world() -> dict:
    """Rank 1 raises; the others wait in a collective it never joins."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank one fails on purpose")
    dist.barrier()
    return {"rank": dist.get_rank(),
            "env": sorted(k for k in os.environ if k.startswith("CAPITAL_"))}


def small_world() -> dict:
    """The constructors on a world of any size (test_torch_grid_api.py):
    shapes, and a grid that needs more ranks than the world has."""
    import torch.distributed as dist

    from capital_tpu_torch import Grid

    p = dist.get_world_size()
    return {"rank": dist.get_rank(),
            "square": Grid.square().shape, "rect": Grid.rect(c=1).shape,
            "hybrid": Grid.hybrid().shape,
            "local": Grid.square(device="cpu").shape,
            "too_big": _catch(lambda: Grid.square(c=1, d=p))}


def hybrid_world() -> dict:
    """cacqr's hybrid path on the rect grid over the world's ranks
    (test_torch_cacqr.py): shapes, and Q R against A."""
    from capital_tpu_torch import Grid, interop
    from capital_tpu_torch.algs import cacqr

    grid = Grid.rect(c=1)
    a_np = tall(512, 128, 0)
    a = interop.dist_from_numpy(a_np, grid, SPECS["rows"])
    g = cacqr.gram_hybrid(grid, a)
    q, r = cacqr.factor_hybrid(grid, a, cacqr_cfg())
    qn, rn = _np(q), _np(r)
    return {"grid": grid.shape, "gram": tuple(g.shape), "q": qn.shape,
            "r": rn.shape, "spec": tuple(q.spec),
            "res": float(np.abs(qn @ rn - a_np).max())}


# ---------------------------------------------------------------------------
# summa
# ---------------------------------------------------------------------------

SUMMA_A, SUMMA_B = (64, 96), (96, 32)
KNOBS = {"plain": {}, "chunks2": {"num_chunks": 2},
         "chunks3": {"num_chunks": 3}, "throttle": {"throttle": True,
                                                    "num_chunks": 2},
         "collect2": {"collect_chunks": 2},
         "collect2_chunks2": {"collect_chunks": 2, "num_chunks": 2}}


def summa_world() -> dict:
    from capital_tpu_torch import tracing
    from capital_tpu_torch.parallel import summa

    grids = _grids()
    g = grids["222"]
    flat = _flat(g)
    a, b = operand(*SUMMA_A, 0), operand(*SUMMA_B, 1)
    u, bb = operand(64, 64, 2), operand(64, 48, 3)
    cc = operand(SUMMA_A[0], SUMMA_B[1], 4)
    out = {"gemm": {}, "trmm": {}, "syrk": {}, "errors": {}, "costs": {}}
    for gname, gg in (("222", g), ("flat", flat)):
        for impl in ("shard_map", "ring", "gspmd"):
            for kname, kw in KNOBS.items():
                if impl != "shard_map" and "num_chunks" in kw:
                    continue
                if impl == "gspmd" and kw:
                    continue
                key = f"{gname} {impl} {kname}"
                out["gemm"][key] = _np(summa.gemm(gg, torch.from_numpy(a),
                                                  torch.from_numpy(b),
                                                  impl=impl, **kw))
            out["gemm"][f"{gname} {impl} alpha_beta"] = _np(summa.gemm(
                gg, torch.from_numpy(a), torch.from_numpy(b),
                c=torch.from_numpy(cc), alpha=0.5, beta=-2.0, impl=impl))
            out["gemm"][f"{gname} {impl} transpose"] = _np(
                summa.transpose(gg, torch.from_numpy(a), impl=impl))
            for side, tr in (("L", False), ("L", True), ("R", False),
                             ("R", True)):
                bx = bb if side == "L" else bb.T.copy()
                out["trmm"][f"{gname} {impl} {side} {tr}"] = _np(summa.trmm(
                    gg, torch.from_numpy(u), torch.from_numpy(bx), side=side,
                    trans_a=tr, alpha=1.5, impl=impl))
            out["trmm"][f"{gname} {impl} windows"] = _np(summa.trmm(
                gg, torch.from_numpy(u), torch.from_numpy(bb), side="L",
                trans_a=True, impl=impl, a_window=(16, 16, 32, 32),
                b_window=(16, 8, 32, 32)))
            out["syrk"][f"{gname} {impl}"] = _np(summa.syrk(
                gg, torch.from_numpy(a), impl=impl))
            out["syrk"][f"{gname} {impl} c"] = _np(summa.syrk(
                gg, torch.from_numpy(a), c=torch.from_numpy(
                    operand(96, 96, 5)), alpha=-1.0, beta=1.0, impl=impl))
            out["syrk"][f"{gname} {impl} window"] = _np(summa.syrk(
                gg, torch.from_numpy(u), impl=impl,
                a_window=(0, 32, 32, 32)))
            out["syrk"][f"{gname} {impl} syrk2"] = _np(summa.syrk2(
                gg, torch.from_numpy(a), torch.from_numpy(operand(64, 32, 6)),
                impl=impl))
    for impl in ("shard_map", "ring"):
        out["errors"][impl] = _catch(lambda: summa.gemm(
            g, torch.zeros(8, 6), torch.zeros(6, 4), impl=impl))
    out["errors"]["unknown"] = _catch(lambda: summa.gemm(
        g, torch.zeros(8, 8), torch.zeros(8, 8), impl="cannon"))
    for impl in ("shard_map", "gspmd"):
        with tracing.trace() as t:
            summa.gemm(g, torch.from_numpy(a), torch.from_numpy(b),
                       impl=impl, collect_chunks=2)
            summa.trmm(g, torch.from_numpy(u), torch.from_numpy(bb),
                       trans_a=True, impl=impl)
            summa.syrk(g, torch.from_numpy(a), impl=impl)
        out["costs"][impl] = costs(t)
    return out


# ---------------------------------------------------------------------------
# cholinv
# ---------------------------------------------------------------------------

CHOL_N = 256
POLICIES = ("replicated", "layer", "gather", "gather_overlap")
CHOL_CASES = {
    **{f"policy {p}": dict(base_policy=p) for p in POLICIES},
    "ring": dict(summa_impl="ring"), "gspmd": dict(summa_impl="gspmd"),
    "chunks": dict(summa_chunks=2, summa_throttle=True,
                   summa_collect_chunks=2),
    "lower": dict(lower=True), "partial": dict(complete_inv=False),
    "split2": dict(split=2), "bc_mult": dict(bc_mult=-1, min_bc=64),
    "gspmd lower": dict(summa_impl="gspmd", lower=True,
                        base_policy="layer")}


def chol_cfg(**kw):
    from capital_tpu_torch.algs import cholinv

    base = dict(min_bc=64, base_method="xla")
    base.update(kw)
    return cholinv.Config(**base)


def cholinv_world() -> dict:
    import torch.distributed as dist

    from capital_tpu_torch import interop, tracing, validate
    from capital_tpu_torch.algs import cholinv
    from capital_tpu_torch.ops import lapack

    grids = _grids()
    g = grids["222"]
    a_np = spd(CHOL_N, 13)
    a = interop.dist_from_numpy(a_np, g)
    out = {"factor": {}, "leaves": {}, "residuals": {}, "costs": {}}
    for name, kw in CHOL_CASES.items():
        cfg = chol_cfg(**kw)
        before = lapack.chol_inv.xla_calls
        with tracing.trace() as t:
            r, ri = cholinv.factor(g, a, cfg)
        out["factor"][name] = (_np(r), _np(ri))
        out["leaves"][name] = lapack.chol_inv.xla_calls - before
        out["costs"][name] = costs(t)
        if not cfg.lower:
            out["residuals"][name] = (
                float(validate.cholesky_residual(g, a, r)),
                float(validate.inverse_residual(g, r, ri)))
    flat = _flat(g)
    r, ri = cholinv.factor(flat, a, chol_cfg())
    out["factor"]["flat"] = (_np(r), _np(ri))
    out["residuals"]["flat"] = (float(validate.cholesky_residual(flat, a, r)),
                                float(validate.inverse_residual(flat, r, ri)))
    out["rank"] = {"rank": dist.get_rank(), "coord": tuple(
        g.mesh.coord[x] for x in "zyx"), "leaves": dict(out.pop("leaves"))}
    return out


# ---------------------------------------------------------------------------
# cacqr
# ---------------------------------------------------------------------------

QR_1D = (1024, 128)
QR_3D = (512, 128)
QR_HYB = (2048, 256)


def cacqr_cfg(chol=None, **kw):
    from capital_tpu_torch.algs import cacqr

    base = dict(base_method="xla", gram_kernel="dot")
    base.update(kw)
    return cacqr.Config(chol=chol_cfg(**(chol or {})), **base)


def _qr_out(grid, a, q, r, layout):
    from capital_tpu_torch import validate

    return (_np(q), _np(r),
            float(validate.qr_orthogonality(grid, q, layout=layout)),
            float(validate.qr_residual(grid, a, q, r, layout=layout)))


def cacqr_world() -> dict:
    import torch.distributed as dist

    from capital_tpu_torch import Grid, interop, tracing, validate
    from capital_tpu_torch.algs import cacqr
    from capital_tpu_torch.ops import counters, reset_counters

    grids = _grids()
    g, gr, g8 = grids["222"], grids["rect"], grids["1d8"]
    rows = SPECS["rows"]
    out = {"qr": {}, "gram": {}, "costs": {}, "auto": {}}
    a_np = tall(*QR_1D, 0)
    for gname, gg in (("222", g), ("rect", gr), ("1d8", g8)):
        a = interop.dist_from_numpy(a_np, gg, rows)
        for pol in ("allreduce", "two_stage", "packed"):
            out["gram"][f"{gname} {pol}"] = _np(cacqr.gram_1d(gg, a, pol))
            cfg = cacqr_cfg(gram_policy=pol)
            with tracing.trace() as t:
                q, r = cacqr.factor_1d(gg, a, cfg)
            out["qr"][f"1d {gname} {pol}"] = _qr_out(gg, a, q, r, "1d")
            out["costs"][f"1d {gname} {pol}"] = costs(t)
        q, r = cacqr.factor_1d(gg, a, cacqr_cfg(formq_chunks=4, num_iter=1))
        out["qr"][f"1d {gname} chunks"] = _qr_out(gg, a, q, r, "1d")
    # the 'tri' kernel (the SYRK kernel's plain version on the CPU)
    a = interop.dist_from_numpy(a_np, g, rows)
    reset_counters()
    q, r = cacqr.factor_1d(g, a, cacqr_cfg(gram_kernel="tri"))
    out["tri_counts"] = counters()
    reset_counters()
    cacqr.factor_1d(g, a, cacqr_cfg())
    out["dot_counts"] = counters()
    out["qr"]["1d 222 tri"] = _qr_out(g, a, q, r, "1d")
    out["auto"]["1d"] = (float(validate.qr_orthogonality(g, q)),
                         float(validate.qr_residual(g, a, q, r)))
    qt = cacqr.apply_q(g, q, a, trans=True)
    out["apply_qt"] = _np(qt)
    # 3D on the 2-deep grid, full and partial inverse
    b_np = tall(*QR_3D, 1)
    b = interop.dist_from_numpy(b_np, g)
    for ci in (True, False):
        cfg = cacqr_cfg(chol=dict(complete_inv=ci))
        with tracing.trace() as t:
            q, r = cacqr.factor_3d(g, b, cfg)
        out["qr"][f"3d {ci}"] = _qr_out(g, b, q, r, "2d")
        out["costs"][f"3d {ci}"] = costs(t)
    out["auto"]["2d"] = (float(validate.qr_orthogonality(g, q)),
                         float(validate.qr_residual(g, b, q, r)))
    # hybrid on the rect grid, every Gram policy
    h_np = tall(*QR_HYB, 2)
    h = interop.dist_from_numpy(h_np, gr, rows)
    for pol in ("allreduce", "two_stage", "packed"):
        out["gram"][f"hybrid {pol}"] = _np(cacqr.gram_hybrid(gr, h, pol))
        cfg = cacqr_cfg(gram_policy=pol, chol=dict(summa_impl="shard_map"))
        with tracing.trace() as t:
            q, r = cacqr.factor_hybrid(gr, h, cfg)
        out["qr"][f"hybrid {pol}"] = _qr_out(gr, h, q, r, "1d")
        out["costs"][f"hybrid {pol}"] = costs(t)
    q, r = cacqr.factor(gr, h, cacqr_cfg(local_thresh=128))
    out["qr"]["dispatch"] = _qr_out(gr, h, q, r, "auto")
    g81 = Grid.square(c=8, d=1)
    out["errors"] = {"hybrid c != d2": _catch(
        lambda: cacqr.factor_hybrid(g81, h, cacqr_cfg()))}
    out["rank"] = {"rank": dist.get_rank()}
    return out


# ---------------------------------------------------------------------------
# the solver layer: LU, rectri / trsm / Newton, TSQR / polar, linalg
# ---------------------------------------------------------------------------

def general(n: int, seed: int) -> np.ndarray:
    """A general (nonsymmetric, not dominant) f32 operand: standard
    normal, so LU pivots for real."""
    return np.random.default_rng(seed).standard_normal((n, n)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def controlled(m: int, n: int, cond: float, seed: int) -> np.ndarray:
    """Orthonormal U (m, n), V (n, n) and singular values geomspace(1,
    1/cond), f32 (cached: callers must not write to it). A world takes
    these as arguments from the parent (qr_polar_operands): eight ranks
    each running numpy's QR at once oversubscribe the host's cores."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((u * np.geomspace(1.0, 1.0 / cond, n)) @ v.T).astype(np.float32)


def _spy(module, name, calls, pick):
    """mock.patch.object(module, name) with a wrapper that appends
    pick(result) of every call to `calls`."""
    from unittest import mock

    real = getattr(module, name)

    def spy(*args, **kw):
        res = real(*args, **kw)
        calls.append(pick(res))
        return res

    return mock.patch.object(module, name, spy)


LU_N, LU_NB, LU_K = 256, 64, 8
# (grid, CAPITAL_* switches): the flat 2 x 2 view is the JAX package's
# grid122; CAPITAL_LU_IB=16 gives the recursive panel four leaves a panel
LU_CASES = {
    "222": ("222", {}),
    "flat": ("flat", {}),
    "lookahead": ("222", {"CAPITAL_LU_LOOKAHEAD": "1"}),
    "panel_jax": ("222", {"CAPITAL_LU_PANEL": "jax", "CAPITAL_LU_IB": "16"}),
    "panel_jax_lookahead": ("flat", {"CAPITAL_LU_PANEL": "jax",
                                     "CAPITAL_LU_LOOKAHEAD": "1"}),
}


def lu_world() -> dict:
    from unittest import mock

    import torch.distributed as dist

    from capital_tpu_torch import interop, tracing
    from capital_tpu_torch.algs import lu
    from capital_tpu_torch.ops.precision import default_matmul_precision
    from capital_tpu_torch.parallel import summa

    g = _grids()["222"]
    named = {"222": g, "flat": _flat(g)}
    a_np = general(LU_N, 1)
    out = {"factor": {}, "costs": {}}
    rank = {"rank": dist.get_rank(), "perm": {}, "sign": {}, "panels": {}}
    for name, (gname, env) in LU_CASES.items():
        gg = named[gname]
        a = interop.dist_from_numpy(a_np, gg)
        panels = []
        with mock.patch.dict(os.environ, env), \
                _spy(lu, "_panel_lu", panels, lambda r: (r[1], r[2])), \
                tracing.trace() as t:
            w, perm, sign = lu.factor(gg, a, lu.Config(nb=LU_NB))
        out["factor"][name] = (_np(w), perm.numpy().copy(), float(sign))
        out["costs"][name] = costs(t)
        rank["perm"][name] = perm.numpy().copy()
        rank["sign"][name] = float(sign)
        rank["panels"][name] = [(p.numpy().copy(), v.numpy().copy())
                                for p, v in panels]
    # solve, and solve with two refinement sweeps, on the flat view
    flat = named["flat"]
    b_np = operand(LU_N, LU_K, 7)
    a = interop.dist_from_numpy(a_np, flat)
    b = interop.dist_from_numpy(b_np, flat)
    x = lu.solve(flat, a, b, lu.Config(nb=LU_NB))
    w, perm, _ = lu.factor(flat, a, lu.Config(nb=LU_NB))
    xr = lu.solve_factored(flat, w, perm, b)
    for _ in range(2):
        with default_matmul_precision("highest"):
            res = b - summa.gemm(flat, a, xr)
        xr = xr + lu.solve_factored(flat, w, perm, res)
    out["solve"] = {"plain": _np(x), "refined": _np(xr),
                    "vector": _np(lu.solve_factored(
                        flat, w, perm, torch.from_numpy(b_np[:, 0].copy())))}
    sgn, logdet = lu.slogdet(g, interop.dist_from_numpy(a_np, g),
                             lu.Config(nb=LU_NB))
    out["slogdet"] = (float(sgn), float(logdet))
    rank["slogdet"] = out["slogdet"]
    out["rank"] = rank
    return out


TRI_N = 256
TRSM_CASES = {
    "lower": dict(side="L", lower=True, unit_diag=False, m=128),
    "upper": dict(side="L", lower=False, unit_diag=False, m=128),
    "right_lower": dict(side="R", lower=True, unit_diag=False, m=96),
    "right_upper": dict(side="R", lower=False, unit_diag=False, m=96),
    "packed_unit_lower": dict(side="L", lower=True, unit_diag=True, m=8),
    "packed_upper": dict(side="L", lower=False, unit_diag=False, m=8),
}
NEWTON_N = 128
# above the f32 rounding floor of ||I - X A||_F / sqrt(n) (~1e-6 at n =
# 128), so the stopping test reads the iteration, not the summation order
NEWTON_TOL = 1e-5


def rectri_cfg():
    from capital_tpu_torch.algs import rectri

    return rectri.Config(min_bc=64, base_method="xla")


def trsm_cfg():
    from capital_tpu_torch.algs import trsm

    return trsm.Config(nb=64, tri=rectri_cfg())


def trsm_operands(name: str):
    """(A, B) of a TRSM_CASES case: a triangle of a dominant matrix, or
    (packed) a dominant matrix with a random strict upper part, whose
    strict lower part is read as a unit lower triangle."""
    c = TRSM_CASES[name]
    if name.startswith("packed"):
        a = spd(TRI_N, 9) + np.triu(operand(TRI_N, TRI_N, 10), 1)
    else:
        a = spd(TRI_N, 3)
        a = np.tril(a) if c["lower"] else np.triu(a)
    shape = (TRI_N, c["m"]) if c["side"] == "L" else (c["m"], TRI_N)
    return a.astype(np.float32), operand(*shape, 4)


def newton_operand(kind: str) -> np.ndarray:
    """test_torch_newton_tsqr's operands: SPD (U + U^T)/2 + n I, or the
    general U + sqrt(n) I, U uniform(-0.5, 0.5) seeded 7."""
    rng = np.random.default_rng(7)
    u = rng.uniform(-0.5, 0.5, (NEWTON_N, NEWTON_N))
    if kind == "spd":
        a = (u + u.T) / 2 + NEWTON_N * np.eye(NEWTON_N)
    else:
        a = u + np.sqrt(NEWTON_N) * np.eye(NEWTON_N)
    return a.astype(np.float32)


def tri_world() -> dict:
    import torch.distributed as dist

    from capital_tpu_torch import interop, tracing
    from capital_tpu_torch.algs import newton, rectri, trsm
    from capital_tpu_torch.ops.precision import default_matmul_precision

    g = _grids()["222"]
    flat = _flat(g)
    out = {"rectri": {}, "trsm": {}, "newton": {}, "costs": {}}
    t_np = spd(TRI_N, 2)
    for lower in (True, False):
        t = np.tril(t_np) if lower else np.triu(t_np)
        with tracing.trace() as tr:
            x = rectri.invert(g, interop.dist_from_numpy(t, g), lower=lower,
                              cfg=rectri_cfg())
        out["rectri"][lower] = _np(x)
        out["costs"][f"rectri {lower}"] = costs(tr)
    for name, c in TRSM_CASES.items():
        a, b = trsm_operands(name)
        kw = dict(side=c["side"], lower=c["lower"], unit_diag=c["unit_diag"])
        with tracing.trace() as tr:
            x = trsm.solve(g, interop.dist_from_numpy(a, g),
                           interop.dist_from_numpy(b, g), cfg=trsm_cfg(),
                           **kw)
        out["trsm"][name] = _np(x)
        out["costs"][f"trsm {name}"] = costs(tr)
    # one right-hand side on d = 2: padded to the d*c unit
    a, _ = trsm_operands("lower")
    b1 = operand(TRI_N, 1, 4)
    for gname, gg in (("222", g), ("flat", flat)):
        x = trsm.solve(gg, interop.dist_from_numpy(a, gg),
                       torch.from_numpy(b1), cfg=trsm_cfg())
        out["trsm"][f"one_column {gname}"] = (_np(x), tuple(x.shape),
                                              tuple(x.spec))
    its = {}
    for kind, gname, gg in (("spd", "222", g), ("general", "flat", flat)):
        with default_matmul_precision("highest"), tracing.trace() as tr:
            x, it, res = newton.invert(
                gg, interop.dist_from_numpy(newton_operand(kind), gg),
                newton.Config(spd=kind == "spd", tol=NEWTON_TOL))
        out["newton"][kind] = (_np(x), it, float(res))
        out["costs"][f"newton {kind}"] = costs(tr)
        its[kind] = it
    out["rank"] = {"rank": dist.get_rank(), "iters": its}
    return out


TSQR_CASES = {"well": (2048, 96, 10.0, 0), "extreme": (4096, 64, 1e7, 1)}
POLAR_SQ = 128            # the '2d' operand, n x n
POLAR_TALL = (1024, 64)   # the '1d' operand


def polar_operands():
    """(square, tall) operands of condition 100 (test_torch_polar.py's
    kind): the '2d' n x n and the '1d' m x n."""
    return (controlled(POLAR_SQ, POLAR_SQ, 100.0, 20),
            controlled(*POLAR_TALL, 100.0, 21))


def nearest_operand():
    return controlled(POLAR_SQ, POLAR_SQ, 50.0, 3)


def polar_cfg(chol=None, **kw):
    from capital_tpu_torch.algs import polar

    return polar.Config(chol=chol or chol_cfg(), **kw)


def qr_polar_operands() -> dict:
    """The numpy operands of qr_polar_world, made once in the parent."""
    sq, tall = polar_operands()
    return {"tsqr": {name: controlled(*case)
                     for name, case in TSQR_CASES.items()},
            "sq": sq, "tall": tall, "near": nearest_operand()}


def qr_polar_world(ops: dict) -> dict:
    import torch.distributed as dist

    from capital_tpu_torch import interop, linalg, tracing
    from capital_tpu_torch.algs import polar, tsqr

    grids = _grids()
    g, g8 = grids["222"], grids["1d8"]
    flat = _flat(g)
    rows = SPECS["rows"]
    out = {"tsqr": {}, "polar": {}, "costs": {}, "layout": {}}
    rank = {"rank": dist.get_rank(), "r": {}, "zinv": {}}
    for name in TSQR_CASES:
        a = interop.dist_from_numpy(ops["tsqr"][name], g8, rows)
        with tracing.trace() as t:
            q, r = tsqr.factor(g8, a)
        out["tsqr"][name] = (_np(q), r.numpy().copy(), tuple(q.spec))
        out["costs"][f"tsqr {name}"] = costs(t)
        rank["r"][name] = r.numpy().copy()
    sq, tall = ops["sq"], ops["tall"]
    for name, gg, a_np, spec, layout, h in (
            ("2d flat", flat, sq, None, "2d", True),
            ("2d 222 u", g, sq, None, "2d", False),
            ("1d", g8, tall, rows, "1d", True),
            ("1d u", g8, tall, rows, "1d", False)):
        a = interop.dist_from_numpy(a_np, gg, spec)
        zinv = []
        with _spy(polar, "_zsolve_1d", zinv, lambda r: r[1].clone()), \
                tracing.trace() as t:
            res = polar.polar(gg, a, polar_cfg(compute_h=h), layout=layout)
        u, hh = res if h else (res, None)
        out["polar"][name] = (_np(u), None if hh is None else _np(hh),
                              tuple(u.spec))
        out["costs"][f"polar {name}"] = costs(t)
        if layout == "1d":
            rank["zinv"][name] = [z.numpy() for z in zinv]
    out["layout"] = {
        "rows": polar._resolve_layout(
            g8, interop.dist_from_numpy(tall, g8, rows), "auto"),
        "tall tensor": polar._resolve_layout(
            g, torch.from_numpy(tall), "auto"),
        "square": polar._resolve_layout(
            flat, interop.dist_from_numpy(sq, flat), "auto")}
    near = interop.dist_from_numpy(ops["near"], flat)
    out["nearest"] = {
        "orthogonal 2d": _np(linalg.nearest_orthogonal(flat, near,
                                                       polar_cfg())),
        "orthogonal 1d": _np(linalg.nearest_orthogonal(
            g8, interop.dist_from_numpy(tall, g8, rows), polar_cfg())),
        "psd": _np(linalg.nearest_psd(flat, near, polar_cfg()))}
    out["rank"] = rank
    return out


LIN_N, LIN_K = 128, 8
LSTSQ = (1024, 32, 4)
EXPM_N = 64


def linalg_operands() -> dict:
    """The numpy operands of linalg_world that take a QR, made once in the
    parent."""
    return {"lstsq": controlled(*LSTSQ[:2], 100.0, 34)}


def linalg_world(ops: dict) -> dict:
    import torch.distributed as dist

    from capital_tpu_torch import interop, linalg, tracing
    from capital_tpu_torch.algs import cholinv

    grids = _grids()
    g, gr, g8 = grids["222"], grids["rect"], grids["1d8"]
    flat = _flat(g)
    rows = SPECS["rows"]
    out = {"spd": {}, "solve": {}, "lstsq": {}, "vector": {}, "costs": {}}
    a_spd = spd(LIN_N, 30)
    b_np = operand(LIN_N, LIN_K, 31)
    a = interop.dist_from_numpy(a_spd, flat)
    b = interop.dist_from_numpy(b_np, flat)
    ccfg = chol_cfg(summa_impl="gspmd")
    with tracing.trace() as t:
        x = linalg.spd_solve(flat, a, b, ccfg, refine=2)
    out["spd"]["refine2"] = _np(x)
    out["costs"]["spd_solve"] = costs(t)
    fac = cholinv.factor(flat, a, ccfg)
    b2 = operand(LIN_N, LIN_K, 32)
    out["spd"]["factor_reuse"] = _np(linalg.spd_solve(
        flat, a, interop.dist_from_numpy(b2, flat), ccfg, factor=fac))
    out["spd"]["inv"] = _np(linalg.inv(flat, a, ccfg))
    out["spd"]["slogdet"] = tuple(float(v) for v in linalg.slogdet_spd(
        flat, a, ccfg))
    out["spd"]["slogdet_222"] = tuple(float(v) for v in linalg.slogdet_spd(
        g, interop.dist_from_numpy(a_spd, g), ccfg))
    gen = (operand(LIN_N, LIN_N, 33)
           + 10.0 * np.eye(LIN_N, dtype=np.float32)).astype(np.float32)
    ag = interop.dist_from_numpy(gen, flat)
    for method in ("normal", "polar", "lu"):
        with tracing.trace() as t:
            x = linalg.solve(flat, ag, b, method=method, cfg=ccfg,
                             polar_cfg=polar_cfg(chol=ccfg))
        out["solve"][method] = _np(x)
        out["costs"][f"solve {method}"] = costs(t)
    out["solve"]["lu bf16"] = _np(linalg.solve(
        flat, ag, b, method="lu", cfg=ccfg, factor_dtype=torch.bfloat16))
    m, n, k = LSTSQ
    at_np = ops["lstsq"]
    bt_np = operand(m, k, 35)
    for method, gname, gg in (("cqr2", "rect", gr), ("tsqr", "1d8", g8)):
        at = interop.dist_from_numpy(at_np, gg, rows)
        bt = interop.dist_from_numpy(bt_np, gg, rows)
        for refine in (0, 1):
            x = linalg.lstsq(gg, at, bt, cacqr_cfg(), refine=refine,
                             method=method)
            out["lstsq"][f"{method} {gname} {refine}"] = x.numpy().copy()
    e_np = (operand(EXPM_N, EXPM_N, 36) * (4.0 / EXPM_N**0.5)).astype(
        np.float32)
    out["expm"] = _np(linalg.expm(flat, interop.dist_from_numpy(e_np, flat),
                                  ccfg))
    # 1-D right-hand sides on d = 2
    b1 = torch.from_numpy(b_np[:, 0].copy())
    for method in ("normal", "lu", "polar"):
        out["vector"][f"solve {method}"] = linalg.solve(
            flat, ag, b1, method=method, cfg=ccfg,
            polar_cfg=polar_cfg(chol=ccfg)).numpy().copy()
    out["vector"]["spd_solve"] = linalg.spd_solve(flat, a, b1,
                                                  ccfg).numpy().copy()
    out["vector"]["lstsq"] = linalg.lstsq(
        flat, torch.from_numpy(at_np), torch.from_numpy(bt_np[:, 0].copy()),
        cacqr_cfg()).numpy().copy()
    out["rank"] = {"rank": dist.get_rank()}
    return out


# ---------------------------------------------------------------------------
# operands through a file (a spawned rank unpickles a large argument
# slowly: a 256 KiB one costs ~15 s of world start here)
# ---------------------------------------------------------------------------

def world_with(fn, ops: dict, ranks: int = RANKS):
    """world(fn, path), the flat dict of numpy arrays `ops` saved to a
    fresh .npz file at `path` for the call's length (fn reads it with
    unstash)."""
    import tempfile

    fd, path = tempfile.mkstemp(prefix="capital_ops_", suffix=".npz")
    os.close(fd)
    try:
        np.savez(path, **ops)
        return world(fn, path, ranks=ranks)
    finally:
        os.remove(path)


def unstash(path: str) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


# ---------------------------------------------------------------------------
# the cyclic workspace and cholinv_cyclic
# ---------------------------------------------------------------------------

CYC_TB = 16
CYC_N = 256
CYC_WINDOWS = {"full": ((0, 0, 256, 256), (0, 0, 256, 128)),
               "interior": ((64, 128, 128, 64), (192, 64, 64, 64)),
               "mix": ((128, 0, 128, 256), (0, 0, 256, 32))}


def integers(m: int, n: int, seed: int) -> np.ndarray:
    """Integer values in [-4, 4], f32: every product and sum of the
    window tests is exact in f32, whatever the summation order."""
    rng = np.random.default_rng(seed)
    return rng.integers(-4, 5, (m, n)).astype(np.float32)


def cyclic_cfg(**kw):
    from capital_tpu_torch.algs import cholinv

    base = dict(min_bc=64, base_method="xla")
    base.update(kw)
    return cholinv.Config(**base)


def cyclic_world() -> dict:
    import torch.distributed as dist

    from capital_tpu_torch import interop, tracing
    from capital_tpu_torch.algs import cholinv_cyclic
    from capital_tpu_torch.parallel import cyclic

    g = _grids()["222"]
    tb = CYC_TB
    a_np, b_np = integers(CYC_N, CYC_N, 0), integers(CYC_N, 128, 1)
    a = interop.dist_from_numpy(a_np, g)
    pa = cyclic.to_cyclic(g, a, tb=tb)
    pb = cyclic.to_cyclic(g, interop.dist_from_numpy(b_np, g), tb=tb)
    out = {"phys": _np(pa), "spec": tuple(pa.spec),
           "back": _np(cyclic.from_cyclic(g, pa, tb=tb)), "gemm": {}}
    win = (64, 128, 128, 64)
    rd = cyclic.read_window(g, pa, win, tb=tb)
    out["read"] = _np(rd)
    ws = pa.with_local(pa.local.clone())
    cyclic.update_window(g, ws, 2.0 * rd, win, tb=tb)
    out["update"] = _np(cyclic.from_cyclic(g, ws, tb=tb))
    out["tri"] = {uplo: _np(cyclic.read_window_tri(
        g, pa, (64, 64, 128, 128), uplo=uplo, tb=tb)) for uplo in "UL"}
    for name, (aw, bw) in CYC_WINDOWS.items():
        for chunks in (1, 2):
            out["gemm"][f"{name} {chunks}"] = _np(cyclic.gemm_window(
                g, pa, pb, a_window=aw, b_window=bw, num_chunks=chunks,
                tb=tb))
    out["trmm"] = {
        "L trans": _np(cyclic.trmm_window(
            g, pa, pa, side="L", trans_a=True, a_window=(0, 0, 128, 128),
            b_window=(0, 128, 128, 128), tb=tb)),
        "R": _np(cyclic.trmm_window(
            g, pa, pa, side="R", alpha=-1.0, a_window=(128, 128, 128, 128),
            b_window=(0, 128, 128, 128), num_chunks=2, tb=tb))}
    c = cyclic.read_window(g, pa, (128, 128, 128, 128), tb=tb)
    out["syrk"] = _np(cyclic.syrk_window(
        g, pa, c=c, alpha=-1.0, beta=1.0, a_window=(0, 128, 128, 128),
        tb=tb))
    # cholinv_cyclic: the 2 x 2 x 2 grid (chunked) and the flat 2 x 2 view
    spd_np = spd(CYC_N, 21)
    out["chol"], out["costs"] = {}, {}
    for name, gg, kw in (("222", g, {"summa_chunks": 2}),
                         ("flat", _flat(g), {})):
        with tracing.trace() as t:
            r, ri = cholinv_cyclic.factor(
                gg, interop.dist_from_numpy(spd_np, gg), cyclic_cfg(**kw))
        out["chol"][name] = (_np(r), _np(ri), tuple(r.spec))
        out["costs"][name] = costs(t)
    g8 = _grids()["1d8"]
    out["errors"] = {
        "d not dividing bc": _catch(lambda: cholinv_cyclic.factor(
            g, interop.dist_from_numpy(spd_np, g), cyclic_cfg(
                min_bc=63))),
        "non-square slice": _catch(lambda: cholinv_cyclic.factor(
            g8, interop.dist_from_numpy(spd_np, g8), cyclic_cfg())),
        "unaligned window": _catch(lambda: cyclic.read_window(
            g, pa, (8, 0, 64, 64), tb=tb))}
    out["rank"] = {"rank": dist.get_rank(), "block": pa.local.numpy().copy(),
                   "coord": tuple(g.mesh.coord[ax] for ax in "zyx")}
    return out


# ---------------------------------------------------------------------------
# the spectral layer: eigh, svd, linalg's spectral functions
# ---------------------------------------------------------------------------

def sym(n: int, vals, seed: int = 0) -> np.ndarray:
    """A = Q diag(vals) Q^T with a Haar-ish Q, f32 (tests/test_eigh.py's
    construction)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((q * np.asarray(vals)) @ q.T).astype(np.float32)


def factored(m: int, n: int, s, seed: int = 0) -> np.ndarray:
    """U diag(s) V^T with Haar-ish U, V, f32 (tests/test_torch_svd.py's)."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((u * np.asarray(s)) @ v.T).astype(np.float32)


# name -> (n, eigenvalues, seed, base_n)
EIGH_CASES = {
    "separated": (256, np.linspace(-1.0, 1.0, 256), 0, 128),
    # 202 is no multiple of 128 (the blkdiag padding), and its split (k =
    # 101) leaves two children of odd size, kept replicated along the axis
    # they do not divide
    "ragged": (202, np.linspace(0.1, 3.0, 202), 1, 128),
}
PARTIAL_K = 16
EIGH_GEN_N = 128


def eigh_operands() -> dict:
    out = {name: sym(n, vals, seed)
           for name, (n, vals, seed, _) in EIGH_CASES.items()}
    out["gen_b"] = spd(EIGH_GEN_N, 40)
    return out


def eigh_cfg(base_n: int):
    """The eigh config of the mesh tests: every cholinv of a sign or an
    orthonormalization is one leaf (min_bc 512 >= n), which keeps the
    JAX package's compiles short; the recursion's own schedules are the
    cholinv tests'."""
    from capital_tpu_torch.algs import cholinv, eigh, polar

    return eigh.Config(base_n=base_n, polar=polar.Config(
        compute_h=False, chol=cholinv.Config(min_bc=512,
                                             base_method="xla")))


@contextlib.contextmanager
def decisions(out: list):
    """Record every decision input of the eigensolver on this rank: each
    sign's (n, sigma, trace) and each split's (n, k, coupling)."""
    from unittest import mock

    from capital_tpu_torch.algs import eigh

    sign, split = eigh._stage_sign, eigh._stage_split

    def rec_sign(grid, a, sigma, cfg):
        u, tr = sign(grid, a, sigma, cfg)
        out.append(("sign", a.shape[0], float(sigma), float(tr)))
        return u, tr

    def rec_split(grid, a, u, key, cfg, k):
        res = split(grid, a, u, key, cfg, k)
        out.append(("split", a.shape[0], k, float(res[-1])))
        return res

    with mock.patch.object(eigh, "_stage_sign", rec_sign), \
            mock.patch.object(eigh, "_stage_split", rec_split):
        yield


def eigh_world(path: str) -> dict:
    import torch.distributed as dist

    from capital_tpu_torch import interop
    from capital_tpu_torch.algs import eigh
    from capital_tpu_torch.ops.precision import default_matmul_precision

    ops = unstash(path)
    g = _grids()["222"]
    flat = _flat(g)
    out = {"eigh": {}, "seen": {}, "spec": {}}
    seen: dict = {}
    with default_matmul_precision("highest"):
        for name, gg, case in (("flat", flat, "separated"),
                               ("222", g, "separated"),
                               ("ragged", flat, "ragged")):
            cfg = eigh_cfg(EIGH_CASES[case][3])
            seen[name] = []
            with decisions(seen[name]):
                w, v = eigh.eigh(gg, interop.dist_from_numpy(ops[case], gg),
                                 cfg)
            out["eigh"][name] = (w.numpy().copy(), _np(v))
            out["spec"][name] = tuple(v.spec)
        a = interop.dist_from_numpy(ops["separated"], flat)
        cfg = eigh_cfg(128)
        out["count"] = {s: eigh.count_above(flat, a, s, cfg)
                        for s in (-0.5, 0.0, 0.25)}
        out["eigvalsh"] = eigh.eigvalsh(flat, a, cfg).numpy().copy()
        out["partial"] = {}
        for which in ("top", "bottom"):
            seen[which] = []
            with decisions(seen[which]):
                w, x = eigh.eigh_partial(flat, a, PARTIAL_K, cfg,
                                         which=which)
            out["partial"][which] = (w.numpy().copy(), _np(x))
            out["spec"][which] = tuple(x.spec)
        n = EIGH_GEN_N
        ga = interop.dist_from_numpy(ops["separated"][:n, :n], flat)
        gb = interop.dist_from_numpy(ops["gen_b"], flat)
        w, x = eigh.eigh_gen(flat, ga, gb, eigh_cfg(EIGH_GEN_N))
        out["gen"] = (w.numpy().copy(), _np(x))
        out["spec"]["gen"] = tuple(x.spec)
    out["normal"] = eigh._normal(g, 12345, 64, torch.float32).numpy()
    out["rank"] = {"rank": dist.get_rank(), "seen": seen,
                   "normal": out["normal"]}
    out["seen"] = seen
    return out


# name -> (m, n, singular values, seed, layout, grid)
SVD_CASES = {
    "wide": (256, 256, np.linspace(3.0, 0.5, 256), 1, "2d", "flat"),
    "square": (128, 128, np.geomspace(1.0, 1e-2, 128), 0, "2d", "222"),
    "tall": (512, 128, np.geomspace(2.0, 1e-2, 128), 2, "1d", "1d8"),
}
SVD_PARTIAL_K = 8


def svd_operands() -> dict:
    out = {name: factored(m, n, s, seed)
           for name, (m, n, s, seed, _, _) in SVD_CASES.items()}
    rng = np.random.default_rng(11)
    q, _ = np.linalg.qr(rng.standard_normal((128, 128)))
    out["spd"] = ((q * np.linspace(0.5, 4.0, 128)) @ q.T).astype(np.float32)
    return out


def svd_cfg():
    from capital_tpu_torch.algs import cholinv, eigh, polar, svd

    chol = cholinv.Config(base_method="xla")
    return svd.Config(polar=polar.Config(chol=chol),
                      eig=eigh.Config(base_n=128, polar=polar.Config(
                          compute_h=False, chol=chol)))


# name -> (linalg function, operand, grid, extra arguments); "cfg": the
# svd config of the svd cases (so both packages share those compiles)
SVD_LINALG = {
    "pinv_square": ("pinv", "square", "222", {"cfg": "svd"}),
    "pinv_tall": ("pinv", "tall", "1d8", {"layout": "1d"}),
    "cond": ("cond", "square", "222", {"cfg": "svd"}),
    "funm_spd": ("funm_spd", "spd", "flat", {"fn": "exp"}),
    "spd_sqrt": ("spd_sqrt", "spd", "222", {}),
    "spd_sqrt_inverse": ("spd_sqrt", "spd", "flat", {"inverse": True}),
    "logm_spd": ("logm_spd", "spd", "flat", {}),
    "powm_spd": ("powm_spd", "spd", "222", {"p": -0.75}),
}


def svd_world(path: str) -> dict:
    import torch.distributed as dist

    from capital_tpu_torch import interop, linalg
    from capital_tpu_torch.algs import svd
    from capital_tpu_torch.ops.precision import default_matmul_precision

    ops = unstash(path)
    grids = _grids()
    grids["flat"] = _flat(grids["222"])
    rows = SPECS["rows"]
    out = {"svd": {}, "spec": {}, "linalg": {}}
    seen: dict = {}
    with default_matmul_precision("highest"):
        for name, (m, n, _, _, layout, gname) in SVD_CASES.items():
            gg = grids[gname]
            a = interop.dist_from_numpy(ops[name], gg,
                                        rows if layout == "1d" else None)
            seen[name] = []
            with decisions(seen[name]):
                u, s, v = svd.svd(gg, a, svd_cfg(), layout=layout)
            out["svd"][name] = (_np(u), s.numpy().copy(), _np(v))
            out["spec"][name] = (tuple(u.spec), tuple(v.spec))
        flat, g8 = grids["flat"], grids["1d8"]
        a = interop.dist_from_numpy(ops["wide"], flat)
        u, s, v = svd.svd_partial(flat, a, SVD_PARTIAL_K, svd_cfg(),
                                  layout="2d")
        out["partial"] = (_np(u), s.numpy().copy(), _np(v))
        out["spec"]["partial"] = (tuple(u.spec), tuple(v.spec))
        out["values"] = svd.singular_values(
            g8, interop.dist_from_numpy(ops["tall"], g8, rows), svd_cfg(),
            layout="1d").numpy().copy()
        for case, (fn, which, gname, kw) in SVD_LINALG.items():
            gg = grids[gname]
            spec = rows if kw.get("layout") == "1d" else None
            kw = dict(kw)
            if "fn" in kw:
                kw["fn"] = torch.exp
            if "cfg" in kw:
                kw["cfg"] = svd_cfg()
            got = getattr(linalg, fn)(
                gg, interop.dist_from_numpy(ops[which], gg, spec), **kw)
            out["linalg"][case] = _np(got)
            if hasattr(got, "spec"):
                out["spec"][case] = tuple(got.spec)
    out["rank"] = {"rank": dist.get_rank(), "seen": seen}
    out["seen"] = seen
    return out


# ---------------------------------------------------------------------------
# the apps: rSVD, PCA, ALS
# ---------------------------------------------------------------------------

RSVD_RUN = (2048, 256, 24, 8)     # m, n, k, oversample
PCA_RUN = (2048, 128, 8, 8)
# users (not a multiple of 8: the padding rows), items, true rank,
# density, seed, (rank, lam, iterations)
ALS_DENSE = dict(users=509, items=256, true_rank=8, density=0.3, seed=0,
                 cfg=(16, 0.05, 8))
ALS_SPARSE = dict(users=512, items=128, s=24, true_rank=6, seed=2,
                  cfg=(12, 0.05, 8))


def planted(m: int, n: int, rank: int, noise: float = 1e-3,
            seed: int = 0) -> np.ndarray:
    """tests/test_torch_rsvd.py's planted operand."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, rank)))
    v, _ = np.linalg.qr(rng.standard_normal((n, rank)))
    s = np.geomspace(10.0, 1.0, rank)
    a = (u * s) @ v.T + noise * rng.standard_normal((m, n))
    return np.asarray(a, np.float32)


def pca_data(m: int = 2048, n: int = 128, k: int = 8, seed: int = 11):
    rng = np.random.default_rng(seed)
    return np.asarray(
        rng.standard_normal((m, k)) @ rng.standard_normal((k, n))
        + 0.01 * rng.standard_normal((m, n)) + rng.standard_normal(n),
        np.float32)


def apps_world(path: str) -> dict:
    """The apps on the world's grids with the JAX package's draws (in the
    file: omega_<n>_<l>, the dense generator's ut/vt/noise/unif, the sparse
    one's perms/shifts/ut/vt, and the initial V's v0_dense, v0_sparse)
    patched into the port's draw helpers."""
    from unittest import mock

    import torch.distributed as dist

    from capital_tpu_torch import interop, tracing
    from capital_tpu_torch.apps import als, rsvd

    ops = unstash(path)
    t = {k: torch.from_numpy(v) for k, v in ops.items()}
    grids = _grids()
    rows = SPECS["rows"]
    out = {"rsvd": {}, "spec": {}, "costs": {}}
    m, n, k, os_ = RSVD_RUN
    with mock.patch.object(rsvd, "_omega",
                           lambda n, l, device: t[f"omega_{n}_{l}"]):
        for gname in ("1d8", "rect"):
            gg = grids[gname]
            a = interop.dist_from_numpy(ops["rsvd_a"], gg, rows)
            cfg = rsvd.Config(k=k, oversample=os_, power_iters=1)
            with tracing.trace() as tr:
                u, s, vt = rsvd.rsvd(gg, a, cfg)
            out["rsvd"][gname] = (_np(u), s.numpy().copy(),
                                  vt.numpy().copy())
            out["spec"][gname] = tuple(u.spec)
            out["costs"][gname] = costs(tr)
        g8 = grids["1d8"]
        _, _, pk, pos = PCA_RUN
        with tracing.trace() as tr:
            comps, var, mean = rsvd.pca(
                g8, interop.dist_from_numpy(ops["pca_a"], g8, rows),
                rsvd.Config(k=pk, oversample=pos, power_iters=1))
        out["pca"] = tuple(x.numpy().copy() for x in (comps, var, mean))
        out["costs"]["pca"] = costs(tr)
    d = ALS_DENSE
    g8 = grids["1d8"]
    draws = tuple(t[f"dense_{x}"] for x in ("ut", "vt", "noise", "unif"))
    with mock.patch.object(als, "_ratings_draws", lambda *a: draws):
        r, msk = als.synthetic_ratings(g8, d["users"], d["items"], d["seed"],
                                       rank=d["true_rank"],
                                       density=d["density"])
    out["ratings"] = (_np(r), _np(msk), tuple(r.spec))
    rank_, lam, iters = d["cfg"]
    cfg = als.Config(rank=rank_, lam=lam, num_iters=iters)
    with mock.patch.object(als, "_initial_v",
                           lambda *a, **kw: t["v0_dense"]):
        u, v, err = als.fit(g8, r, msk, cfg)
    out["fit"] = (_np(u), v.numpy().copy(), float(err), tuple(u.spec))
    out["rmse"] = float(als.rmse(g8, r, msk, u, v))
    sp = ALS_SPARSE
    sdraws = (t["sparse_perms"].long(), t["sparse_shifts"].long(),
              t["sparse_ut"], t["sparse_vt"])
    with mock.patch.object(als, "_regular_draws", lambda *a: sdraws):
        data = als.synthetic_regular(g8, sp["users"], sp["items"], sp["s"],
                                     sp["seed"], rank=sp["true_rank"])
    out["regular"] = tuple(x.numpy().copy() for x in data)
    rank_, lam, iters = sp["cfg"]
    with mock.patch.object(als, "_initial_v",
                           lambda *a, **kw: t["v0_sparse"]):
        u, v, err = als.fit_sparse(g8, data, als.Config(
            rank=rank_, lam=lam, num_iters=iters), items=sp["items"])
    out["fit_sparse"] = (u.numpy().copy(), v.numpy().copy(), float(err))
    out["rank"] = {"rank": dist.get_rank(), "v": out["fit"][1],
                   "err": out["fit"][2]}
    return out


# ---------------------------------------------------------------------------
# the tuner's grid shapes and the scaling sweep on sub-grids of the world
# ---------------------------------------------------------------------------

# the space of tests/test_autotune.py::test_sweep_grids_has_grid_column
TUNE_SPACE = {"bc_mult": [0], "base_method": ["xla"], "min_bc": [64],
              "summa_impl": ["shard_map"]}
TUNE_N = 128
QR_SPACE = {"path": ["1d", "3d", "hybrid"], "num_iter": [2],
            "gram_policy": ["allreduce", "two_stage"],
            "base_method": ["xla"]}
QR_M, QR_N = 1024, 64
# main's default multi-device spaces hold hundreds of candidates a shape:
# the world's main runs take these
MAIN_SPACES = {"cholinv": TUNE_SPACE,
               "lu": {"nb": [64], "summa_impl": ["shard_map"],
                      "precision": ["highest"], "lookahead": [False]}}
MAIN_RUNS = {"sweep": ["--alg", "cholinv"],
             "square:1:2": ["--alg", "cholinv", "--grid", "square:1:2"],
             "rect:2": ["--alg", "cholinv", "--grid", "rect:2"],
             "lu sweep": ["--alg", "lu", "--grid", "sweep"]}
SCALING_N = 256


def _records(cands) -> list:
    return [(c.params, c.costs, c.error, c.time_s) for c in cands]


def tune_world(prefix: str) -> dict:
    """sweep_grids of cacqr on the rect shape, tune.main (--cpu) with
    each of MAIN_RUNS on MAIN_SPACES (tables at prefix + the run's name),
    and bench.scaling --cpu of cholinv and summa, all on sub-grids of this
    world; rank 0's results, and under "rank" the count of candidates and
    rows every rank got back, and what launch.run_on gave a function over
    a device list that names one card for every rank, as torchrun's NCCL
    ranks' lists do (each rank's own cuda:LOCAL_RANK)."""
    from unittest import mock

    import torch.distributed as dist

    from capital_tpu_torch.autotune import tune
    from capital_tpu_torch.bench import scaling
    from capital_tpu_torch.parallel import launch

    out = {"main": {}, "scaling": {}}
    got = {"rank": dist.get_rank(), "main": {}, "scaling": {}}
    one_card = [torch.device("cuda", 0)] * dist.get_world_size()
    got["run_on"] = launch.run_on(lambda device, x: (device, x), one_card, 7)
    qr = tune.sweep_grids("cacqr", n=QR_N, m=QR_M, shapes=[("rect", 2, 2)],
                          space=QR_SPACE, num_iter=1)
    out["cacqr"] = _records(qr)
    got["cacqr"] = len(qr)

    def small(fn, space):
        return lambda grid, a, sp=None, num_iter=2: fn(grid, a, sp or space,
                                                       num_iter=num_iter)

    sweeps = {alg: small(tune._SWEEPS[alg], sp)
              for alg, sp in MAIN_SPACES.items()}
    with mock.patch.dict(tune._SWEEPS, sweeps):
        for name, argv in MAIN_RUNS.items():
            cands = tune.main(["--cpu", "--n", str(TUNE_N), "--num-iter",
                               "1", "--prefix", f"{prefix}{name}"] + argv)
            out["main"][name] = _records(cands)
            got["main"][name] = len(cands)
    for alg in ("cholinv", "summa"):
        rows = scaling.main(["--cpu", "--n", str(SCALING_N), "--alg", alg])
        out["scaling"][alg] = rows
        got["scaling"][alg] = len(rows)
    out["rank"] = got
    return out


# ---------------------------------------------------------------------------
# communication volume: the bytes a rank receives through collectives.py,
# and darray's windows against the gather-then-narrow functions they
# replaced
# ---------------------------------------------------------------------------

class Volume:
    """Bytes this rank receives, by the collective that moved them:
    all_gather (k - 1) x the input, all_reduce the tensor, reduce_scatter
    (k - 1) / k x the input, ppermute the tensors received, all_to_all
    the pieces from other members."""

    def __init__(self):
        self.by = dict.fromkeys(("all_gather", "all_reduce",
                                 "reduce_scatter", "ppermute",
                                 "all_to_all"), 0)

    @property
    def bytes(self) -> int:
        return sum(self.by.values())


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class _CountingDist:
    """torch.distributed as collectives.py sees it, with the calls that
    move data counted into a Volume."""

    def __init__(self, vol: Volume):
        import torch.distributed as dist

        self._dist, self._vol = dist, vol

    def __getattr__(self, name):
        return getattr(self._dist, name)

    def all_reduce(self, t, *args, **kw):
        self._vol.by["all_reduce"] += _nbytes(t)
        return self._dist.all_reduce(t, *args, **kw)

    def batch_isend_irecv(self, ops):
        self._vol.by["ppermute"] += sum(_nbytes(op.tensor) for op in ops
                                        if op.op is self._dist.irecv)
        return self._dist.batch_isend_irecv(ops)

    def all_to_all_single(self, out, src, output_split_sizes=None,
                          input_split_sizes=None, group=None, **kw):
        k = self._dist.get_world_size(group)
        sizes = output_split_sizes or [out.numel() // k] * k
        me = self._dist.get_rank(group)
        self._vol.by["all_to_all"] += (sum(sizes) - sizes[me]) * \
            out.element_size()
        return self._dist.all_to_all_single(
            out, src, output_split_sizes=output_split_sizes,
            input_split_sizes=input_split_sizes, group=group, **kw)


@contextlib.contextmanager
def counting():
    """A Volume that counts every collective collectives.py makes on this
    rank while the context is open."""
    from unittest import mock

    import torch.distributed as dist

    from capital_tpu_torch.parallel import collectives as coll

    vol = Volume()
    gather, scatter = coll._ALL_GATHER, coll._REDUCE_SCATTER

    def all_gather(buf, x, group=None, **kw):
        vol.by["all_gather"] += (dist.get_world_size(group) - 1) * _nbytes(x)
        return gather(buf, x, group=group, **kw)

    def reduce_scatter(out, src, group=None, **kw):
        k = dist.get_world_size(group)
        vol.by["reduce_scatter"] += (k - 1) * _nbytes(src) // k
        return scatter(out, src, group=group, **kw)

    with mock.patch.object(coll, "dist", _CountingDist(vol)), \
            mock.patch.object(coll, "_ALL_GATHER", all_gather), \
            mock.patch.object(coll, "_REDUCE_SCATTER", reduce_scatter):
        yield vol


def gathered_window(x, win):
    """darray.window as it was: each split dimension gathered whole over
    its axes, then cut to this rank's block of the window."""
    from capital_tpu_torch.parallel import collectives as coll
    from capital_tpu_torch.parallel import darray

    if win is None:
        return x
    r0, c0, h, w = win
    local = x.local
    for i, (o, n) in enumerate(((r0, h), (c0, w))):
        axes = x.axes(i)
        start, size = darray._block(x.mesh, n, axes)
        if x.mesh.axis_size(axes) > 1:
            local = coll.all_gather(local, x.mesh, axes, dim=i)
        local = local.narrow(i, o + start, size)
    return darray.DArray(local, (h, w), x.spec, x.mesh)


def gathered_set_window(x, at, v):
    """darray.set_window as it was: v gathered whole, each rank writing
    the part that falls in its block."""
    from capital_tpu_torch.parallel import darray

    r0, c0 = at
    full = darray.to_global(v)
    h, w = full.shape
    (br, bh), (bc, bw) = x.block(0), x.block(1)
    lo_r, hi_r = max(r0, br), min(r0 + h, br + bh)
    lo_c, hi_c = max(c0, bc), min(c0 + w, bc + bw)
    if lo_r < hi_r and lo_c < hi_c:
        x.local[lo_r - br:hi_r - br, lo_c - bc:hi_c - bc].copy_(
            full[lo_r - r0:hi_r - r0, lo_c - c0:hi_c - c0])


def gathered():
    """darray's window and set_window replaced by the gathering ones
    (take_rows reads window through the module)."""
    from unittest import mock

    from capital_tpu_torch.parallel import darray

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(darray, "window", gathered_window))
    stack.enter_context(mock.patch.object(darray, "set_window",
                                          gathered_set_window))
    return stack


def ppermute_empty_like(x, mesh, axes, pairs):
    """collectives.ppermute as it was: its receive buffer empty_like(x),
    which keeps a transposed x's strides. The receives are posted before
    the sends here, so that gloo's refusal leaves no send pending."""
    import torch.distributed as dist

    from capital_tpu_torch.parallel.collectives import _axes

    axes = _axes(axes)
    me = mesh.axis_index(axes)
    members = mesh.members(axes)
    out = torch.empty_like(x)
    x = x.contiguous()
    ops = [dist.P2POp(dist.irecv, out, members[s]) for s, d in pairs
           if d == me and s != me]
    ops += [dist.P2POp(dist.isend, x, members[d]) for s, d in pairs
            if s == me and d != me]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


VOL_N = 64
# (name, grid layout, spec): the 2 x 2 slice (z replicated), blocks over
# all three axes, rows over all eight ranks, a permuted rank table, and
# specs that split one dimension or take the axes out of order
VOL_SPECS = [("2x2", 0, ("y", "x")), ("2x2x2", 0, (("z", "y"), "x")),
             ("rows8", 0, (("z", "y", "x"), None)),
             ("2x2x2 layout2", 2, (("z", "y"), "x")),
             ("cols", 0, (None, "y")), ("xy", 1, ("x", ("z", "y")))]
# (r0, c0, h, w) of a 64 x 64 array: whole, interior, across block edges,
# inside one block, touching the first and the last row and column
VOL_WINDOWS = [(0, 0, 64, 64), (16, 8, 32, 48), (8, 4, 48, 40),
               (34, 36, 8, 8), (0, 0, 16, 24), (48, 40, 16, 24)]
# set_window's v of another spec than x's (the v's spec, per x spec)
VOL_OTHER = [(None, None), (("z", "y", "x"), None), (None, "x"),
             ("x", "y")]
# (case, grid, n): cholinv Config(min_bc=128, base_method='xla',
# shard_map) on spd(n, 13), LU Config(nb=128) on general(n, 1)
VOL_RUNS = [("cholinv", "2x2", 1024), ("cholinv", "2x2", 2048),
            ("cholinv", "2x2x2", 1024), ("cholinv", "2x2x2", 2048),
            ("lu", "2x2", 1024), ("lu", "2x2", 2048)]


def volume_operands() -> dict:
    ops = {}
    for alg, _, n in VOL_RUNS:
        key = f"{alg}{n}"
        if key not in ops:
            ops[key] = spd(n, 13) if alg == "cholinv" else general(n, 1)
    return ops


def _window_cases(out: dict, fails: list, me: int) -> None:
    """window, set_window and take_rows on every spec and window against
    the gathering functions: bitwise, and window within its byte bound."""
    from capital_tpu_torch import Grid
    from capital_tpu_torch.grid import P
    from capital_tpu_torch.parallel import darray

    t = torch.arange(VOL_N * VOL_N, dtype=torch.float32).reshape(VOL_N,
                                                                  VOL_N)
    u = -t - 0.5
    gen = torch.Generator().manual_seed(5)
    rows, callers = [], {}
    for name, layout, spec in VOL_SPECS:
        mesh = Grid.square(c=2, d=2, layout=layout).mesh
        x = darray.distribute(t, mesh, spec)
        k0, k1 = (mesh.axis_size(x.axes(i)) for i in range(2))
        for win in VOL_WINDOWS:
            r0, c0, h, w = win
            tag = f"{name} {win}"
            with counting() as vol:
                got = darray.window(x, win)
            with counting() as old:
                want = gathered_window(x, win)
            bound = x.local.element_size() * (h // k0) * (w + w // k1)
            if not (torch.equal(got.local, want.local)
                    and got.shape == want.shape
                    and tuple(got.spec) == tuple(want.spec)):
                fails.append(f"window {tag}: not bitwise")
            if vol.bytes > bound:
                fails.append(f"window {tag}: {vol.bytes} B > {bound}")
            rows.append(("window", name, win, vol.bytes, old.bytes, bound))
            # take_rows over the same window
            perm = torch.randperm(h, generator=gen)
            with counting() as vol:
                got = darray.take_rows(x, win, perm)
            with counting() as old, gathered():
                want = darray.take_rows(x, win, perm)
            if not torch.equal(got.local, want.local):
                fails.append(f"take_rows {tag}: not bitwise")
            rows.append(("take_rows", name, win, vol.bytes, old.bytes, None))
            # set_window: v of x's spec, replicated, and of other specs
            vs = {"same": darray.window(darray.distribute(u, mesh, spec),
                                        win),
                  "tensor": u[r0:r0 + h, c0:c0 + w].clone()}
            for other in VOL_OTHER:
                vspec = darray.fit(mesh, (h, w), P(*other))
                if tuple(vspec) != tuple(x.spec):
                    vs[str(other)] = darray.distribute(
                        u[r0:r0 + h, c0:c0 + w], mesh, vspec)
            for vname, v in vs.items():
                a = darray.distribute(t, mesh, spec)
                a = a.with_local(a.local.clone())
                b = a.with_local(a.local.clone())
                with counting() as vol:
                    darray.set_window(a, (r0, c0), v)
                with counting() as old:
                    gathered_set_window(b, (r0, c0), v)
                if not torch.equal(a.local, b.local):
                    fails.append(f"set_window {tag} v={vname}: not bitwise")
                if vol.bytes > old.bytes:
                    fails.append(f"set_window {tag} v={vname}: {vol.bytes}"
                                 f" B > the gathering {old.bytes}")
                rows.append((f"set_window v={vname}", name, win, vol.bytes,
                             old.bytes, None))
    out["windows"] = rows if me == 0 else None


def _ppermute_case(out: dict, fails: list) -> None:
    """ppermute of a transposed (non-contiguous) operand between the two
    members of 'x': the empty_like buffer fails, the contiguous one
    passes."""
    import torch.distributed as dist

    from capital_tpu_torch import Grid
    from capital_tpu_torch.parallel import collectives as coll

    mesh = Grid.square(c=2, d=2).mesh
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) + \
        100 * dist.get_rank()
    partner = mesh.members(("x",))[1 - mesh.axis_index(("x",))]
    want = (torch.arange(24, dtype=torch.float32).reshape(4, 6)
            + 100 * partner).T
    try:
        ppermute_empty_like(x.T, mesh, "x", [(0, 1), (1, 0)])
        before = "ok"
    except RuntimeError as exc:
        before = str(exc)
    got = coll.ppermute(x.T, mesh, "x", [(0, 1), (1, 0)])
    out["ppermute"] = {"before": before, "equal": bool(torch.equal(got, want)),
                       "contiguous": got.is_contiguous()}


def _run(alg: str, grid, a):
    from capital_tpu_torch.algs import cholinv, lu

    if alg == "cholinv":
        return cholinv.factor(grid, a, chol_cfg(min_bc=128))
    w, perm, sign = lu.factor(grid, a, lu.Config(nb=128))
    return w, perm, torch.tensor(float(sign))


def _block_of(x):
    return getattr(x, "local", x)


def volume_world(path: str) -> dict:
    """The window cases, the ppermute case, and each of VOL_RUNS twice:
    with darray's windows and with the gathering ones patched in. Rank
    0's bytes and results, each rank's failures, bitwise agreements and
    the callers of set_window with a v of another spec than x's."""
    import inspect
    from unittest import mock

    import torch.distributed as dist

    from capital_tpu_torch import interop, tracing
    from capital_tpu_torch.parallel import darray

    ops = unstash(path)
    me = dist.get_rank()
    out, fails = {}, []
    _window_cases(out, fails, me)
    _ppermute_case(out, fails)
    g = _grids()["222"]
    grids = {"2x2": _flat(g), "2x2x2": g}
    other_spec = set()
    real_set = darray.set_window

    def watched(x, at, v):
        if isinstance(v, darray.DArray) and tuple(v.spec) != tuple(x.spec):
            caller = inspect.stack()[1]
            other_spec.add(f"{os.path.basename(caller.filename)}:"
                           f"{caller.function}")
        return real_set(x, at, v)

    runs, same = {}, {}
    for alg, gname, n in VOL_RUNS:
        grid, key = grids[gname], f"{alg} {gname} {n}"
        a = interop.dist_from_numpy(ops[f"{alg}{n}"], grid)
        with counting() as vol, tracing.trace() as t, \
                mock.patch.object(darray, "set_window", watched):
            got = _run(alg, grid, a)
        with counting() as old, tracing.trace() as t_old, gathered():
            want = _run(alg, grid, a)
        same[key] = all(torch.equal(_block_of(p), _block_of(q))
                        for p, q in zip(got, want))
        runs[key] = {"bytes": vol.bytes, "by": dict(vol.by),
                     "gathered_bytes": old.bytes,
                     "record_bytes": float(t.totals().comm_bytes),
                     "costs_equal": costs(t) == costs(t_old)}
        del got, want
    out["runs"] = runs
    out["rank"] = {"rank": me, "fails": fails, "same": same,
                   "other_spec_callers": sorted(other_spec)}
    return out
