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
