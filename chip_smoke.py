#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (capital_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from capital_tpu_torch/csrc/ (one
   nvcc per source, all at once).
2. Kernel phase: holds each kernel against its plain PyTorch version on
   the same inputs at the main paths' shapes. Times each kernel, its plain
   version, one library call computing the same function (never called
   by the port) and the card's bound for the work.
   - at 'highest' and 'high': TRMM in all four cases on a 16384 window,
     on a ragged U (n = 1000) with B 1000 x 2995 (or 2995 x 1000), both
     windows at offsets that are no multiple of 4, and at 512^2 (the
     path's smallest call); on the ragged windows also the pack pass
     (ops/cuda_pack.py) bitwise against its plain version: U masked to
     its triangle and B, each read along its rows and along its columns,
     at the row's level (and at 'default' beside 'high'). SYRK on a
     16384 x 16384 window, a ragged 2995 x 1000 window at an unaligned
     offset, a 512 x 512 window (the path's smallest) and a 17000 x 256
     operand (deeper than 32 x 512 rows, so the kernels' fold fires), G
     bitwise symmetric each time; at 'high' also SYRK's split pass on the
     ragged window, bitwise against its plain version (hi and lo),
     bf16-in / bf16-out SYRK and TRMM (all four cases) at 'default'
     (4096^2, integer-valued so every summation order is exact: equal to
     the plain version bit for bit) and the fused Cholesky leaf at n =
     128, 256, 512, 1024 with the kernels it runs per call
     (torch.profiler). Tolerance: relative Frobenius 1e-5 for each output
     (the leaf's R and Rinv apart), as the kernel and the plain version
     sum in different orders;
   - the LU panel leaf (getrf_leaf) on the strips of LEAF_STRIPS: four
     heights the LU path runs (32768, a ragged 17792, 2048 and 128 rows
     of 128 columns), a tie-heavy and a zero-column 32768 x 128 strip,
     each a window of a workspace with row stride 32768, all on the
     resident route, and a 65536 x 128 strip on the tall route. pj and
     pivots must be identical and the factor within relative Frobenius
     1e-6 (the two share their arithmetic, so it is bitwise in fact);
     each strip must take its route, and a resident call must be one
     device launch; the library call is torch.linalg.lu_factor.
3. cholinv main path: cholinv.factor at n = 32768 f32, 'high', base case
   512, complete_inv, then n = 8192 at 'highest'. Chunked residuals must
   be below 1e-5.
4. LU main path: lu.factor at n = 32768, nb = 2048, f32, 'highest', seed
   0, two calls; the chunked ||PA - LU|| / ||A|| must be below 5e-4 and
   perm a permutation; the library's residual (torch.linalg.lu_factor on
   the same operand) is printed beside it. Then n = 8192, nb = 1024 with
   CAPITAL_LU_LOOKAHEAD=1 and lu.solve_factored on 256 right-hand sides
   with 2 refinement sweeps: solve residual below 1e-3.
5. cacqr main path: CholeskyQR2 (cacqr.factor_1d, f32) of
   matrix.tall_skinny at m = 2^20, n = 1024, 'highest' (the JAX package's
   `bench.cacqr` default), then m = 2^19, n = 4096, 'high', Q formed in
   place in 8 row chunks; two calls each, on fresh operands. Per factor
   SYRK runs 2 times, TRMM side='R' 2 x chunks and side='L' once, the
   Cholesky leaf twice at n = 1024 (at n = 4096 the Gram Cholesky is
   torch.linalg's, twice, by design). Orthogonality and residual, at
   'highest', must be below 1e-5; the library call is
   torch.linalg.qr(A, mode='reduced') on the same operand. The kernel
   phase adds SYRK and TRMM side='R' rows at this path's shapes (the Gram
   of 2^20 x 1024 at 'highest' and of 2^19 x 4096 at 'high'; formQ on
   2^20 x 1024 and on the 2^16 x 4096 chunk), each held against its plain
   version on the whole operand; and TRMM's pack of a B taller than 2^21
   rows, bitwise against its plain version. The path's own orthogonality
   and residual go through SYRK and TRMM, so they are also taken in f64
   plain products (orthogonality_f64, residual_f64), which run none of
   the kernels, and held to the same 1e-5.
6. F3: the plain bf16 Gram (blas.gram_dot, cacqr.gram_1d(kernel='dot'))
   of a bf16 2^22 x 1024 operand: peak memory above the operand below
   4 GiB each (no f32 copy of it), the Gram within 1e-5 of the SYRK
   kernel's; each, and the card's bf16-in / f32-out torch.mm (which the
   port does not use), is also held to an f64 Gram (reported).
7. QDWH polar main path: polar.polar of matrix.rand 2^18 x 2048 f32 at
   'highest', default Config (l0 = 1e-5: one QR-variant step, three
   Halley steps, one polish, H), layout '2d' (the headline: the Gram by
   SYRK, Z by cholinv, the updates by TRMM side='R' and, on no other
   path, side='R' transposed) and '1d'; two calls each. Orthogonality
   and reconstruction in f64 plain products below 1e-5, H bitwise
   symmetric, the first call's peak memory above A at most 6 iterates, U
   within 1e-4 of U V^T from an f64 SVD of A; the library call is the
   f32 torch.linalg.svd with U V^T and V diag(S) V^T (its U V^T against
   the f64 one is reported). The kernel phase adds TRMM side='R'
   (transposed and not) and SYRK rows at 2^18 x 2048 'highest', held
   against their plain versions on the whole operand.
8. Solver paths: linalg.spd_solve at n = 16384, k = 256, 'high', two
   refinement sweeps (f64 host residual over 8 columns below 1e-5;
   library cholesky + cholesky_solve); linalg.lstsq at 2^19 x 1024, k =
   64, 'highest', one sweep, by 'cqr2' and 'tsqr' (normal-equations
   residual in f64 over 8 columns at most 10 x torch.linalg.lstsq's; the
   TSQR Q's orthogonality in f64 below 1e-5); and a [linalg] phase that
   runs solve ('normal', 'lu', 'polar'), inv, slogdet_spd and
   newton.invert at n = 4096 and expm at n = 2048, each held to a plain
   f64 host computation (numpy, scipy) within the bound it prints.
   Every main path zeroes the launch counters just before it and reads
   them just after: each kernel of the path must have run the number of
   times its call tree gives (every LU leaf on the resident route), and
   no fallback may have run. GFLOP/s and
   the time ratio against the library call at the same shape are printed.

Exits non-zero on any failure, or when no CUDA device is present. The
last three lines are the card's name and power limit, a JSON object with
one row per kernel and shape and {"ok": true, "device": {...}}; the full
record is written to chiprun_out/chip_smoke.json. A row's `launches` is
the count of its kernel (and TRMM case) on the main path that runs it at
the row's precision and input type and on the row's kind of operand
(the polar rows: the 2d headline call's); a row that no main path runs
so (TRMM R,trans at 16384 and 512, the ragged, fold and bf16 TRMM and
SYRK rows, the leaf at a block size that neither cholinv's base case nor
cacqr's Gram takes, the LU leaf on the tall route) has `on_path` false
and 0 launches. A TRMM row's case is its side and transpose, with
":ragged", ":512", ":bf16", ":cacqr" or ":polar" after it for the shapes
beside 16384; SYRK's cacqr and polar rows have case "cacqr" and "polar";
an LU leaf row's case is its strip's label.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

TOL = 1e-5
PEAK_F32 = 67e12      # H100 SXM FFMA, dense (NVIDIA data sheet)
PEAK_BF16 = 989e12    # H100 SXM bf16 tensor cores, dense
MEM_BPS = 3.35e12     # H100 SXM HBM3
REPLACES = {
    "trmm_upper": "capital_tpu/ops/pallas_trmm.py:324",
    "syrk_upper": "capital_tpu/ops/pallas_syrk.py:149",
    "chol_inv": "capital_tpu/ops/pallas_chol.py:153",
    "getrf_leaf": "capital_tpu/ops/pallas_getrf.py:135",
}
SOURCE = {
    "trmm_upper": "capital_tpu_torch/csrc/trmm_upper.cu",
    "syrk_upper": "capital_tpu_torch/csrc/syrk_upper.cu",
    "chol_inv": "capital_tpu_torch/csrc/chol_inv.cu",
    "getrf_leaf": "capital_tpu_torch/csrc/getrf_leaf.cu",
}
# cholinv main path runs: (n, precision); the first is the headline cell
MAIN_RUNS = ((32768, "high"), (8192, "highest"))
LEAF_NS = (128, 256, 512, 1024)  # the Cholesky leaf's block sizes
# LU main path runs: (n, nb, lookahead, right-hand sides); f32 'highest'
LU_RUNS = ((32768, 2048, False, 0), (8192, 1024, True, 256))
LU_TOL, LU_SOLVE_TOL, LEAF_TOL = 5e-4, 1e-3, 1e-6
# cacqr main path runs: (m, n, precision, formq_chunks); CholeskyQR2, f32.
# The first is the JAX package's `bench.cacqr` default, the second its
# 2^19 x 4096 'high' run with Q formed in place (BENCH_LOCAL.md:39).
CACQR_RUNS = ((1 << 20, 1024, "highest", 1), (1 << 19, 4096, "high", 8))
TALL_PACK_ROWS = (1 << 21) + 4096  # > 65535 pack blocks of 32 rows
QR_TOL = 1e-5
# F3: the plain bf16 Gram at cacqr's bf16 gate shape, without f32 copies
F3_SHAPE = (1 << 22, 1024)
F3_PEAK_BYTES = 4 << 30          # above the 8 GiB operand
# QDWH polar: the JAX package's QDWH-SVD shape (README.md:113), f32
# 'highest', default Config; the headline layout first
POLAR_SHAPE = (1 << 18, 2048)
POLAR_LAYOUTS = ("2d", "1d")
POLAR_TOL, POLAR_SVD_TOL, POLAR_ITERATES = 1e-5, 1e-4, 6
# spd_solve: (n, k, precision, refine), BENCH_LOCAL.md:295; lstsq: (m, n,
# k, precision, refine) and its methods, BENCH_LOCAL.md:301-302
SPD_RUN = (16384, 256, "high", 2)
LSTSQ_RUN = (1 << 19, 1024, 64, "highest", 1)
LSTSQ_METHODS = ("cqr2", "tsqr")
SOLVE_TOL, LSTSQ_VS_LIBRARY = 1e-5, 10.0
# [linalg]: every other new entry point once, f32 'highest'
LINALG_N, LINALG_K, EXPM_N = 4096, 16, 2048
LINALG_TOL, EXPM_TOL = 1e-5, 5e-5


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def events_ms(fn, reps: int) -> float:
    """Mean ms of fn() over reps launches, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def once_ms(fn):
    """(ms, result) of one call, queue drained before and after."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop), out


def bound(ops: float, nbytes: float, peak: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_ops, t_bytes = ops / peak, nbytes / MEM_BPS
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def compare(got: torch.Tensor, want: torch.Tensor):
    d = got.double() - want.double()
    rel = float(torch.linalg.norm(d) / torch.linalg.norm(want.double()))
    return rel, float(d.abs().max())


def tree(n: int, bc: int, split: int = 1):
    """(leaves, inner nodes) of cholinv's recursion at base case bc."""
    if n <= bc:
        return 1, 0
    n1 = max(bc, n >> split)
    l1, i1 = tree(n1, bc, split)
    l2, i2 = tree(n - n1, bc, split)
    return l1 + l2, i1 + i2 + 1


def zero_counts() -> dict:
    """ops.counters()'s keys, every count 0: the start of a path's
    expected launch counts."""
    from capital_tpu_torch.ops import counters

    return {k: (dict.fromkeys(v, 0) if isinstance(v, dict) else 0)
            for k, v in counters().items()}


def add_trmm(want: dict, case: str, k: int = 1) -> None:
    want["trmm_upper"] += k
    want["trmm_upper_by_case"][case] += k


def add_cholinv(want: dict, n: int, bc: int, times: int = 1) -> None:
    """The launches of `times` cholinv.factor calls at n, base case bc
    (a multiple of 128 up to 1024, so every leaf is the kernel's)."""
    leaves, inner = tree(n, bc)
    for case in ("L", "L,trans", "R"):
        add_trmm(want, case, inner * times)
    want["syrk_upper"] += inner * times
    want["chol_inv"] += leaves * times


def kernel_phase(level: str, failures: list) -> list:
    from capital_tpu_torch.ops.cuda_syrk import syrk_upper, syrk_upper_plain
    from capital_tpu_torch.ops.cuda_trmm import trmm_upper, trmm_upper_plain

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    n = m = 16384
    passes, peak = (1, PEAK_F32) if level == "highest" else (3, PEAK_BF16)
    rows = []

    def add(name, case, shape, got, plain_ms, want, ms, lib_ms, ops, nbytes,
            peak_, precision=level):
        """got/want: a tensor, or a tuple of outputs each held to TOL on
        its own (so a small output is not hidden by a large one)."""
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        errs = [compare(g, w) for g, w in zip(got, want)]
        rel, mae = max(e[0] for e in errs), max(e[1] for e in errs)
        b_ms, b_by = bound(ops, nbytes, peak_)
        label = name if case is None else f"{name}[{case}]"
        row = {"name": f"{label}@{precision}", "kernel": name, "case": case,
               "route": "cuda", "source": SOURCE[name],
               "replaces": REPLACES[name], "precision": precision,
               "shape": shape, "launches": None, "max_abs_err": mae,
               "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        rows.append(row)
        print(f"[kernel] {row['name']} {shape}: rel_err={rel:.3e} "
              f"max_abs_err={mae:.3e} kernel_ms={ms:.3f} "
              f"plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
              f"bound_ms={b_ms:.3f} ({b_by})", flush=True)
        if not rel <= TOL:
            failures.append(f"{row['name']}: rel_err {rel:.3e} > {TOL}")
        return row

    # TRMM: U is the top-left 16384 block, B the 16384 x 16384 window at
    # column offset 16384 of a 16384 x 32768 workspace (cholinv's shapes);
    # then a ragged U (n = 1000) and B (1000 x 2995 or 2995 x 1000) at
    # unaligned offsets (no multiple of 4: the pack's edge path), and 512^2,
    # the main path's smallest call
    u = torch.rand((n, n), generator=gen, device=dev) - 0.5
    work = torch.rand((n, 2 * n), generator=gen, device=dev) - 0.5
    bw = (0, n, n, m)
    # (variant, u_window, B's offset, n, m, timed launches)
    trmm_cases = ((None, None, (0, n), n, m, 3),
                  ("ragged", (5, 9, 1000), (3, 7), 1000, 2995, 20),
                  ("512", (0, 0, 512), (0, n), 512, 512, 20))
    for variant, uw, (r0, c0), nn, mm, reps in trmm_cases:
        uv = u if uw is None else u[uw[0]:uw[0] + nn, uw[1]:uw[1] + nn]
        for side, trans in (("L", True), ("R", False), ("L", False),
                            ("R", True)):
            case = side + (",trans" if trans else "")
            h, w = (nn, mm) if side == "L" else (mm, nn)
            bv = work[r0:r0 + h, c0:c0 + w]

            def k(side=side, trans=trans, uw=uw, win=(r0, c0, h, w)):
                return trmm_upper(u, work, side=side, trans_a=trans,
                                  u_window=uw, b_window=win,
                                  matmul_precision=level)

            ms = events_ms(k, reps)
            got = k()
            plain_ms, want = once_ms(lambda: trmm_upper_plain(
                uv, bv, side=side, trans_a=trans, prec=level))

            def lib(side=side, trans=trans, uv=uv, bv=bv):
                t = torch.triu(uv).T if trans else torch.triu(uv)
                return (torch.matmul(t, bv) if side == "L"
                        else torch.matmul(bv, t))

            lib_ms = events_ms(lib, 2 if variant is None else reps)
            ops = passes * mm * nn * (nn + 1)
            nbytes = 4 * (nn * (nn + 1) / 2 + 2 * nn * mm)
            row = add("trmm_upper",
                      case if variant is None else f"{case}:{variant}",
                      [nn, mm], got, plain_ms, want, ms, lib_ms, ops,
                      nbytes, peak)
            if variant == "ragged" and case == "L,trans":
                row["pack_bitwise"] = check_packs(uv, bv, level, failures)
            del got, want
    del u, uv

    # SYRK on the same 16384 x 16384 window (the top-level Schur), a
    # ragged window at an unaligned offset (n = 1000 is no multiple of 128,
    # m = 2995 none of 512; the FFMA kernel's edge path), 512^2, the main
    # path's smallest call, and 17000 x 256, deeper than 32 x 512 rows, so
    # the fold fires. G must be bitwise symmetric everywhere
    tall = torch.rand((17000, 256), generator=gen, device=dev) - 0.5
    syrk_cases = ((None, work, bw), ("ragged", work, (5, 3, 2995, 1000)),
                  ("512", work, (0, n, 512, 512)),
                  ("fold", tall, (0, 0, *tall.shape)))
    for case, src, win in syrk_cases:
        r0, c0, h, w = win
        view = src[r0:r0 + h, c0:c0 + w]

        def ks(src=src, win=win):
            return syrk_upper(src, a_window=win, matmul_precision=level)

        ms = events_ms(ks, 3 if case is None else 20)
        got = ks()
        check_symmetric(got, f"syrk_upper[{case}]@{level}", failures)
        plain_ms, want = once_ms(lambda: syrk_upper_plain(view, prec=level))
        lib_ms = events_ms(lambda: torch.matmul(view.T, view),
                           2 if case is None else 20)
        row = add("syrk_upper", case, [h, w], got, plain_ms, want, ms, lib_ms,
                  passes * h * w * (w + 1), 4 * (h * w + w * w), peak)
        if case == "ragged" and level == "high":
            row["split_bitwise"] = {lvl: check_pack(
                view, lvl, "syrk_upper split pass", failures)
                for lvl in ("high", "default")}
        del got, want
    del work, bv, tall
    cacqr_rows(level, gen, failures, add)
    if level == "highest":
        polar_rows(gen, failures, add)

    if level == "high":
        bf16_syrk(gen, failures, add)
        bf16_trmm(gen, failures, add)
        leaf_rows(gen, add)
    return rows


def cacqr_rows(level: str, gen, failures: list, add) -> None:
    """SYRK (the Gram) and TRMM side='R' (formQ) at the cacqr main path's
    shapes at this level: 2^20 x 1024 at 'highest'; at 'high' the Gram of
    2^19 x 4096 and formQ on its 2^16 x 4096 chunk. Each is held against
    its plain version on the whole operand (row offsets past 2^31 bytes,
    the fold firing many times), both timed at that shape; G is bitwise
    symmetric."""
    from capital_tpu_torch.ops.cuda_syrk import syrk_upper, syrk_upper_plain
    from capital_tpu_torch.ops.cuda_trmm import trmm_upper, trmm_upper_plain

    m, n, _, chunks = next(r for r in CACQR_RUNS if r[2] == level)
    passes, peak = (1, PEAK_F32) if level == "highest" else (3, PEAK_BF16)
    a = torch.rand((m, n), generator=gen, device=gen.device) - 0.5

    def ks():
        return syrk_upper(a, matmul_precision=level)

    ms = events_ms(ks, 3)
    got = ks()
    check_symmetric(got, f"syrk_upper[cacqr]@{level}", failures)
    plain_ms, want = once_ms(lambda: syrk_upper_plain(a, prec=level))
    lib_ms = events_ms(lambda: torch.matmul(a.T, a), 3)
    add("syrk_upper", "cacqr", [m, n], got, plain_ms, want, ms, lib_ms,
        passes * m * n * (n + 1), 4 * (m * n + n * n), peak)
    del got, want

    mq = m // chunks  # one formQ call's rows
    b = a[:mq]
    u = torch.triu(torch.rand((n, n), generator=gen, device=gen.device))
    u.diagonal().add_(1.0)

    def kt():
        return trmm_upper(u, b, side="R", matmul_precision=level)

    ms = events_ms(kt, 3)
    out = kt()
    plain_ms, want = once_ms(lambda: trmm_upper_plain(u, b, side="R",
                                                      prec=level))
    lib_ms = events_ms(lambda: torch.matmul(b, u), 3)
    row = add("trmm_upper", "R:cacqr", [mq, n], out, plain_ms, want, ms,
              lib_ms, passes * mq * n * (n + 1),
              4 * (n * (n + 1) / 2 + 2 * n * mq), peak)
    del a, b, out, want
    # B's pack along its rows, o = rows beyond 65535 blocks of 32 (a 2^22-
    # row formQ without chunks): bitwise the plain version
    tall = torch.rand((TALL_PACK_ROWS, 128), generator=gen,
                      device=gen.device) - 0.5
    row["pack_tall_bitwise"] = check_pack(
        tall, level, "pack B (tall)", failures, along_rows=False)
    del tall
    torch.cuda.empty_cache()


def polar_rows(gen, failures: list, add) -> None:
    """TRMM side='R' (transposed and not) and SYRK at the polar headline's
    shape, 2^18 x 2048 f32 'highest', each held against its plain version
    on the whole operand; G is bitwise symmetric."""
    from capital_tpu_torch.ops.cuda_syrk import syrk_upper, syrk_upper_plain
    from capital_tpu_torch.ops.cuda_trmm import trmm_upper, trmm_upper_plain

    m, n = POLAR_SHAPE
    dev = gen.device
    a = torch.rand((m, n), generator=gen, device=dev) - 0.5
    u = torch.triu(torch.rand((n, n), generator=gen, device=dev))
    u.diagonal().add_(1.0)
    ops, nbytes = m * n * (n + 1), 4 * (n * (n + 1) / 2 + 2 * n * m)
    for trans in (True, False):
        case = "R,trans:polar" if trans else "R:polar"

        def kt(trans=trans):
            return trmm_upper(u, a, side="R", trans_a=trans,
                              matmul_precision="highest")

        ms = events_ms(kt, 3)
        out = kt()
        plain_ms, want = once_ms(lambda: trmm_upper_plain(
            u, a, side="R", trans_a=trans, prec="highest"))
        t = torch.triu(u).T if trans else torch.triu(u)
        lib_ms = events_ms(lambda: torch.matmul(a, t), 3)
        add("trmm_upper", case, [m, n], out, plain_ms, want, ms, lib_ms,
            ops, nbytes, PEAK_F32)
        del out, want

    def ks():
        return syrk_upper(a, matmul_precision="highest")

    ms = events_ms(ks, 3)
    got = ks()
    check_symmetric(got, "syrk_upper[polar]@highest", failures)
    plain_ms, want = once_ms(lambda: syrk_upper_plain(a, prec="highest"))
    lib_ms = events_ms(lambda: torch.matmul(a.T, a), 3)
    add("syrk_upper", "polar", [m, n], got, plain_ms, want, ms, lib_ms,
        ops, 4 * (m * n + n * n), PEAK_F32)
    del a, u, got, want
    torch.cuda.empty_cache()


def check_symmetric(g: torch.Tensor, what: str, failures: list) -> None:
    if not torch.equal(g, g.T):
        failures.append(f"{what}: G is not bitwise symmetric")


def check_pack(a: torch.Tensor, level: str, what: str, failures: list, *,
               along_rows: bool = True, upper: bool = False) -> bool:
    """The pack pass (ops/cuda_pack.py) on the card against its plain
    version, bit for bit: hi, lo where there is one, the zero padding and,
    with `upper`, the masked lower triangle."""
    from capital_tpu_torch.ops.cuda_pack import pack, pack_plain

    got = pack(a, level, along_rows=along_rows, upper=upper)
    want = pack_plain(a, level, along_rows=along_rows, upper=upper)
    same = all((g is None and w is None) or (
        g is not None and w is not None and g.shape == w.shape
        and torch.equal(g.view(torch.int16 if g.dtype == torch.bfloat16
                               else torch.int32),
                        w.view(torch.int16 if w.dtype == torch.bfloat16
                               else torch.int32)))
        for g, w in zip(got, want))
    print(f"[kernel] {what} {list(a.shape)} @{level}: bitwise equal to the "
          f"plain version={same}", flush=True)
    if not same:
        failures.append(f"{what} @{level}: differs from pack_plain")
    return same


def check_packs(u: torch.Tensor, b: torch.Tensor, level: str,
                failures: list) -> dict:
    """TRMM's packs on ragged windows at unaligned offsets: U masked, read
    along its rows (U^T) and along its columns; B unmasked, both ways. At
    'high' also the one-plane pack of 'default'."""
    out = {}
    for lvl in ((level, "default") if level == "high" else (level,)):
        for name, a, upper in (("U", u, True), ("B", b, False)):
            for along_rows in (True, False):
                label = (f"{lvl}/{name}/"
                         f"{'along_rows' if along_rows else 'along_cols'}")
                out[label] = check_pack(a, lvl, f"pack {label}", failures,
                                        along_rows=along_rows, upper=upper)
    return out


def bf16_trmm(gen, failures: list, add) -> None:
    """TRMM with bf16 in and out at 'default', all four cases, on
    integer-valued data: every product and partial sum is exact in f32, so
    the output's one rounding to bf16 must match the plain version's bit
    for bit."""
    from capital_tpu_torch.ops.cuda_trmm import trmm_upper, trmm_upper_plain

    n = m = 4096
    u, b = (torch.randint(-8, 9, (n, n), generator=gen, device=gen.device,
                          dtype=torch.float32).bfloat16() for _ in range(2))
    for side, trans in (("L", True), ("R", False), ("L", False),
                        ("R", True)):
        case = side + (",trans" if trans else "")

        def k(side=side, trans=trans):
            return trmm_upper(u, b, side=side, trans_a=trans)

        ms = events_ms(k, 10)
        got = k()
        plain_ms, want = once_ms(lambda: trmm_upper_plain(
            u, b, side=side, trans_a=trans, prec="default"))
        t = torch.triu(u).T if trans else torch.triu(u)
        lib_ms = events_ms(lambda: torch.matmul(t, b) if side == "L"
                           else torch.matmul(b, t), 10)
        if not (got.dtype == torch.bfloat16 and torch.equal(got, want)):
            failures.append(f"trmm_upper[{case}:bf16]: differs from the "
                            "plain version")
        add("trmm_upper", f"{case}:bf16", [n, m], got.float(), plain_ms,
            want.float(), ms, lib_ms, m * n * (n + 1),
            2 * (n * (n + 1) / 2 + 2 * n * m), PEAK_BF16,
            precision="default")


def bf16_syrk(gen, failures: list, add) -> None:
    """bf16 in, bf16 out at 'default' on integer-valued data: every product
    and partial sum is exact in f32 whatever the order, so the output's one
    rounding to bf16 must match the plain version's bit for bit."""
    from capital_tpu_torch.ops.cuda_syrk import syrk_upper, syrk_upper_plain

    m = n = 4096
    a = torch.randint(-8, 9, (m, n), generator=gen, device=gen.device,
                      dtype=torch.float32).bfloat16()

    def k():
        return syrk_upper(a, out_dtype=torch.bfloat16)

    ms = events_ms(k, 10)
    got = k()
    check_symmetric(got, "syrk_upper[bf16]@default", failures)
    check_pack(a, "default", "syrk_upper split pass", failures)
    plain_ms, want = once_ms(lambda: syrk_upper_plain(a, torch.bfloat16))
    lib_ms = events_ms(lambda: torch.matmul(a.T, a), 10)
    if not torch.equal(got, want):
        failures.append("syrk_upper[bf16]: differs from the plain version")
    add("syrk_upper", "bf16", [m, n], got.float(), plain_ms, want.float(), ms,
        lib_ms, m * n * (n + 1), 2 * (m * n + n * n), PEAK_BF16,
        precision="default")


def device_launches(fn) -> int:
    """Kernels the card runs for one call of fn (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_time_total > 0 and not e.key.startswith("Memcpy"))


def leaf_rows(gen, add) -> None:
    """The Cholesky leaf at every n the dispatch gate lets in that the
    main paths use or could (128 ... 1024). A Gram matrix plus a modest
    shift (condition ~5), so R and Rinv both carry off-diagonal weight;
    each is held to TOL on its own."""
    from capital_tpu_torch.ops.cuda_chol import chol_inv_cuda, chol_inv_plain

    dev = gen.device
    for nl in LEAF_NS:
        x = torch.rand((nl, nl), generator=gen, device=dev) - 0.5
        g = x @ x.T
        a = (g + g.T) * 0.5 + (nl / 12) * torch.eye(nl, device=dev)
        ms = events_ms(lambda: chol_inv_cuda(a), 50)
        got_r, got_ri = chol_inv_cuda(a)
        plain_ms, (pr, pri) = once_ms(lambda: chol_inv_plain(a))
        eye = torch.eye(nl, device=dev)

        def lib_leaf():
            lo = torch.linalg.cholesky(a)
            return torch.linalg.solve_triangular(lo, eye, upper=False)

        lib_ms = events_ms(lib_leaf, 50)
        row = add("chol_inv", f"n={nl}", [nl, nl], (got_r, got_ri), plain_ms,
                  (torch.triu(pr), torch.triu(pri)), ms, lib_ms,
                  2 * nl**3 / 3, 4 * 3 * nl * nl, PEAK_F32,
                  precision="f32")
        row["device_launches_per_call"] = device_launches(
            lambda: chol_inv_cuda(a))
        print(f"[kernel] chol_inv n={nl}: device launches per call "
              f"{row['device_launches_per_call']}", flush=True)


def main_path(n: int, level: str, failures: list) -> dict:
    from capital_tpu_torch import Grid, matrix, validate
    from capital_tpu_torch.algs import cholinv
    from capital_tpu_torch.ops import counters, reset_counters
    from capital_tpu_torch.ops.precision import default_matmul_precision

    grid = Grid.square(c=1, d=1)
    cfg = cholinv.Config(complete_inv=True)  # split 1, base case 512
    a = matrix.symmetric(grid, n, 0, align=128)
    bc = cfg.base_dim(grid, n)
    with default_matmul_precision(level):
        reset_counters()
        secs, (r, ri) = once_ms(lambda: cholinv.factor(grid, a, cfg))
        got = counters()
        del r, ri
        secs2, (r, ri) = once_ms(lambda: cholinv.factor(grid, a, cfg))
    best_ms = min(secs, secs2)
    leaves, inner = tree(n, bc)
    want = {"trmm_upper": 3 * inner, "syrk_upper": inner, "chol_inv": leaves,
            "trmm_upper_by_case": {"L": inner, "L,trans": inner, "R": inner,
                                   "R,trans": 0},
            "trmm_dot": 0, "syrk_dot": 0, "gram_dot": 0, "chol_xla": 0,
            "getrf_leaf": 0,
            "getrf_leaf_by_route": {"resident": 0, "tall": 0},
            "leaf_plain": 0, "lu_library": 0}
    if got != want:
        failures.append(f"main path n={n}: launch counts {got} != {want}")
    inv = float(validate.inverse_residual(grid, r, ri, chunks=8, masked=True))
    del ri
    res = float(validate.cholesky_residual(grid, a.data, r, chunks=8,
                                           masked=True))
    del r
    if not (res < 1e-5 and inv < 1e-5):  # also fails on NaN
        failures.append(f"main path n={n}: residual {res} / inverse "
                        f"residual {inv} not below 1e-5")

    def library():
        lo = torch.linalg.cholesky(a.data)
        eye = torch.eye(n, device=a.data.device)
        return torch.linalg.solve_triangular(lo, eye, upper=False)

    once_ms(lambda: torch.linalg.cholesky(a.data[:1024, :1024]))  # warm up
    lib_ms, out = once_ms(library)
    del out, a
    torch.cuda.empty_cache()
    gflops = (2 * n**3 / 3) / (best_ms / 1e3) / 1e9
    rec = {"n": n, "precision": level, "bc": bc, "ms": [secs, secs2],
           "gflops": gflops, "library_ms": lib_ms,
           "vs_library": lib_ms / best_ms, "residual": res,
           "inv_residual": inv, "launches": got}
    print(f"[main] {json.dumps(rec)}", flush=True)
    return rec


# getrf_leaf strips: (label, rows, workspace columns, values, the route
# the wrapper must take on a card with 132 SMs). Windows of
# a workspace with the LU path's row stride 32768: the first leaf of
# panel 0, the sixth leaf of panel 7, the last panel's first leaf, the
# smallest leaf; integer values in {-2..2} (equal |.| compete across
# CTAs) and a zero column at the tallest; and one strip taller than the
# resident route holds (the tall route), on a (65536, 256) workspace.
LEAF_STRIPS = (
    ("32768x128", 32768, 32768, "randn", "resident"),
    ("17792x128", 32768 - 7 * 2048 - 5 * 128, 32768, "randn", "resident"),
    ("2048x128", 2048, 32768, "randn", "resident"),
    ("128x128", 128, 32768, "randn", "resident"),
    ("32768x128:ties", 32768, 32768, "ties", "resident"),
    ("32768x128:zero_column", 32768, 32768, "zero_column", "resident"),
    ("65536x128:tall", 65536, 256, "randn", "tall"))


def leaf_phase(failures: list) -> list:
    """getrf_leaf against its plain version on the LEAF_STRIPS, each a
    window of a workspace: pj and pivots bit for bit, the factor within
    LEAF_TOL (bitwise is expected: the two share their arithmetic)."""
    from capital_tpu_torch.ops import cuda_getrf
    from capital_tpu_torch.ops.cuda_getrf import getrf_leaf, getrf_leaf_plain

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    ib = 128
    rows = []
    for label, mm, cols, values, route in LEAF_STRIPS:
        ws = torch.empty((mm, cols), device=dev)
        win = ws[:, :ib]
        if values == "ties":
            src = torch.randint(-2, 3, (mm, ib), generator=gen, device=dev,
                                dtype=torch.float32)
        else:
            src = torch.randn((mm, ib), generator=gen, device=dev)
        if values == "zero_column":
            src[:, 5] = 0.0
        how = cuda_getrf.plan(mm, ib, *cuda_getrf.limits(0))

        def restore():
            win.copy_(src)

        def k():
            restore()
            return getrf_leaf(win)

        # the wrapper's time (the launch and, on the tall route, the row
        # gather by pj) without the copy that restores the input
        ms = events_ms(k, 5) - events_ms(restore, 5)
        _, pj, piv = k()
        plain_ms, (want, pj_p, piv_p) = once_ms(
            lambda: getrf_leaf_plain(src.clone()))
        lib_ms = events_ms(lambda: torch.linalg.lu_factor_ex(src), 3)
        rel, mae = compare(win, want)
        same = torch.equal(pj, pj_p) and torch.equal(piv, piv_p)
        bitwise = torch.equal(win.view(torch.int32), want.view(torch.int32))
        launches = device_launches(k) - device_launches(restore)
        b_ms, b_by = bound(mm * ib * ib, 2 * mm * ib * 4, PEAK_F32)
        row = {"name": f"getrf_leaf[{label}]", "kernel": "getrf_leaf",
               "case": label, "route": "cuda", "source": SOURCE["getrf_leaf"],
               "replaces": REPLACES["getrf_leaf"], "precision": "highest",
               "shape": [mm, ib], "leaf_route": how.route,
               "plan": how._asdict(), "launches": None,
               "max_abs_err": mae, "rel_err": rel, "pivots_equal": same,
               "factor_bitwise": bitwise, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
               "device_launches_per_call": launches}
        rows.append(row)
        print(f"[kernel] {row['name']}: route={how.route} "
              f"ctas={how.blocks} rows_per_cta={how.rows_per} "
              f"pj/pivots equal={same} factor bitwise={bitwise} "
              f"rel_err={rel:.3e} max_abs_err={mae:.3e} kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
              f"bound_ms={b_ms:.4f} ({b_by}) "
              f"device launches per call={launches}", flush=True)
        if not same:
            failures.append(f"{row['name']}: pj/pivots differ from the "
                            "plain version")
        if not rel <= LEAF_TOL:
            failures.append(f"{row['name']}: rel_err {rel:.3e} > {LEAF_TOL}")
        if how.route != route:
            failures.append(f"{row['name']}: took the {how.route} route")
        if how.route == "resident" and launches != 1:
            failures.append(f"{row['name']}: {launches} device launches a "
                            "call on the resident route")
        del ws, win, src, want
    torch.cuda.empty_cache()
    return rows


def lu_path(n: int, nb: int, lookahead: bool, k_rhs: int,
            failures: list) -> dict:
    """lu.factor (and, with k_rhs, a refined solve) at f32 'highest'."""
    from unittest import mock

    from capital_tpu_torch import Grid
    from capital_tpu_torch.algs import lu
    from capital_tpu_torch.bench.lu import residual
    from capital_tpu_torch.ops import counters, reset_counters
    from capital_tpu_torch.ops.lapack import perm_from_pivots
    from capital_tpu_torch.ops.precision import default_matmul_precision, dot

    grid = Grid.square(c=1, d=1)
    dev = grid.device
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((n, n), generator=gen, device=dev)
    cfg = lu.Config(nb=nb)
    env = {"CAPITAL_LU_LOOKAHEAD": "1" if lookahead else "0"}
    with mock.patch.dict(os.environ, env), default_matmul_precision("highest"):
        reset_counters()
        secs, (w, perm, _) = once_ms(lambda: lu.factor(grid, a, cfg))
        got = counters()
        del w, perm
        secs2, (w, perm, _) = once_ms(lambda: lu.factor(grid, a, cfg))
        nbp = cfg.panel(grid, n)
        leaf_launches = (n // nbp) * lu.leaves(nbp, lu.leaf_width(True))
    best_ms = min(secs, secs2)
    want = zero_counts()
    want["getrf_leaf"] = leaf_launches
    want["getrf_leaf_by_route"]["resident"] = leaf_launches
    if got != want:
        failures.append(f"LU n={n}: launch counts {got} != {want}")
    is_perm = torch.equal(torch.sort(perm).values,
                          torch.arange(n, dtype=perm.dtype, device=dev))
    res = residual(grid, w, perm, a)
    rec = {"n": n, "nb": nb, "lookahead": lookahead, "precision": "highest",
           "ms": [secs, secs2], "gflops": (2 * n**3 / 3) / best_ms / 1e6,
           "residual": res, "perm_is_permutation": is_perm,
           "launches": got, "expected_getrf_leaf": leaf_launches}
    if not is_perm:
        failures.append(f"LU n={n}: perm is not a permutation")
    if not res < LU_TOL:  # also fails on NaN
        failures.append(f"LU n={n}: residual {res} not below {LU_TOL}")
    if k_rhs:
        b = torch.randn((n, k_rhs), generator=gen, device=dev)

        def solve():
            x = lu.solve_factored(grid, w, perm, b)
            for _ in range(2):
                x = x + lu.solve_factored(grid, w, perm, b - dot(a, x))
            return x

        with default_matmul_precision("highest"):
            solve_ms, x = once_ms(solve)
            sres = float(torch.linalg.norm(dot(a, x) - b)
                         / torch.linalg.norm(b))
        rec.update(solve_k=k_rhs, refine=2, solve_ms=solve_ms,
                   solve_residual=sres)
        if not sres < LU_SOLVE_TOL:
            failures.append(f"LU n={n}: solve residual {sres} not below "
                            f"{LU_SOLVE_TOL}")
    del w, perm
    torch.cuda.empty_cache()
    once_ms(lambda: torch.linalg.lu_factor(a[:1024, :1024]))  # warm up
    lib_ms, (lu_lib, piv_lib) = once_ms(lambda: torch.linalg.lu_factor(a))
    with default_matmul_precision("highest"):
        rec["library_residual"] = residual(
            grid, lu_lib, perm_from_pivots(piv_lib - 1, n), a)
    rec.update(library_ms=lib_ms, vs_library=lib_ms / best_ms)
    del lu_lib, piv_lib, a
    torch.cuda.empty_cache()
    print(f"[lu] {json.dumps(rec)}", flush=True)
    return rec


def cacqr_path(m: int, n: int, level: str, chunks: int,
               failures: list) -> dict:
    """CholeskyQR2 (cacqr.factor_1d) of tall_skinny(m, n, seed 0), f32 at
    `level`, two calls on fresh operands; validated at 'highest'."""
    from capital_tpu_torch import Grid, matrix, validate
    from capital_tpu_torch.algs import cacqr
    from capital_tpu_torch.ops import counters, reset_counters
    from capital_tpu_torch.ops.precision import default_matmul_precision

    grid = Grid.square(c=1, d=1)
    cfg = cacqr.Config(num_iter=2, formq_chunks=chunks)

    def operand():  # Q is written over it when chunks > 1
        return matrix.tall_skinny(grid, m, n, 0).data

    def run(a):
        return cacqr.factor_1d(grid, a, cfg, overwrite_a=True)

    a = operand()
    with default_matmul_precision(level):
        reset_counters()
        secs, (q, r) = once_ms(lambda: run(a))
        got = counters()
        del q, r, a
        a = operand()
        secs2, (q, r) = once_ms(lambda: run(a))
        del a
    best_ms = min(secs, secs2)
    leaf = n <= 1024
    want = zero_counts()
    want.update(syrk_upper=2, trmm_upper=2 * chunks + 1,
                chol_inv=2 if leaf else 0, chol_xla=0 if leaf else 2)
    want["trmm_upper_by_case"].update(R=2 * chunks, L=1)
    if got != want:
        failures.append(f"cacqr {m}x{n}: launch counts {got} != {want}")
    orth = float(validate.qr_orthogonality(grid, q))
    a = operand()
    res = float(validate.qr_residual(grid, a, q, r))
    orth64, res64 = qr_errors_f64(a, q, r)
    del q, r
    for what, x in (("orthogonality", orth), ("residual", res),
                    ("orthogonality_f64", orth64), ("residual_f64", res64)):
        if not x < QR_TOL:  # also fails on NaN
            failures.append(f"cacqr {m}x{n}: {what} {x} not below {QR_TOL}")
    torch.cuda.empty_cache()
    once_ms(lambda: torch.linalg.qr(a[:4096], mode="reduced"))  # warm up
    lib_ms, out = once_ms(lambda: torch.linalg.qr(a, mode="reduced"))
    del out, a
    torch.cuda.empty_cache()
    flops = 2 * (4 * m * n * n + 2 * n**3 / 3)
    rec = {"m": m, "n": n, "precision": level, "formq_chunks": chunks,
           "ms": [secs, secs2], "gflops": flops / best_ms / 1e6,
           "library_ms": lib_ms, "vs_library": lib_ms / best_ms,
           "orthogonality": orth, "residual": res,
           "orthogonality_f64": orth64, "residual_f64": res64,
           "launches": got}
    print(f"[cacqr] {json.dumps(rec)}", flush=True)
    return rec


def qr_errors_f64(a: torch.Tensor, q: torch.Tensor, r: torch.Tensor,
                  rows: int = 1 << 16) -> tuple[float, float]:
    """(||Q^T Q - I||_F / sqrt(n), ||Q R - A||_F / ||A||_F) in f64 plain
    products, row chunk by row chunk: the QR checked by none of the
    kernels that made it."""
    return factor_errors_f64(a, q, torch.triu(r), rows)


def factor_errors_f64(a: torch.Tensor, q: torch.Tensor, f: torch.Tensor,
                      rows: int = 1 << 16) -> tuple[float, float]:
    """(||Q^T Q - I||_F / sqrt(n), ||Q F - A||_F / ||A||_F) for a dense
    right factor F (R of a QR, H of a polar), as qr_errors_f64."""
    n = q.shape[1]
    g = torch.zeros((n, n), dtype=torch.float64, device=q.device)
    rt = f.double()
    d2 = a2 = 0.0
    for i in range(0, q.shape[0], rows):
        qc, ac = q[i:i + rows].double(), a[i:i + rows].double()
        g.addmm_(qc.T, qc)
        d2 += float(torch.sum((qc @ rt - ac) ** 2))
        a2 += float(torch.sum(ac ** 2))
    g.diagonal().sub_(1.0)
    return float(torch.linalg.norm(g)) / n**0.5, (d2 / a2) ** 0.5


def f3_phase(failures: list) -> dict:
    """F3: the plain bf16 Gram of a bf16 2^22 x 1024 operand through
    blas.gram_dot and cacqr.gram_1d(kernel='dot'), each with its peak
    memory above the operand (bound F3_PEAK_BYTES), held to the SYRK
    kernel's Gram within TOL. Both, and the card's bf16-in / f32-out
    torch.mm, are also held to an f64 Gram (reported, not bounded)."""
    from capital_tpu_torch import Grid
    from capital_tpu_torch.algs import cacqr
    from capital_tpu_torch.ops import blas, counters, reset_counters
    from capital_tpu_torch.ops.cuda_syrk import syrk_upper

    grid = Grid.square(c=1, d=1)
    dev = grid.device
    m, n = F3_SHAPE
    gen = torch.Generator(device=dev).manual_seed(3)
    a = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    step = min(m, 1 << 18)
    for i in range(0, m, step):
        a[i:i + step] = (torch.rand((step, n), generator=gen, device=dev)
                         - 0.5).bfloat16()
    rec = {"shape": [m, n], "dtype": "bfloat16",
           "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF")}
    reset_counters()
    for what, fn in (("gram_dot", lambda: blas.gram_dot(a)),
                     ("gram_1d", lambda: cacqr.gram_1d(grid, a,
                                                       kernel="dot"))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms, g = once_ms(fn)
        peak = torch.cuda.max_memory_allocated() - base
        rec[what] = {"ms": ms, "peak_bytes_above_operand": peak}
        if not peak < F3_PEAK_BYTES:
            failures.append(f"F3 {what}: peak {peak} bytes above the "
                            f"operand, not below {F3_PEAK_BYTES}")
        if what == "gram_dot":
            g_dot = g
        del g
    rec["launches"] = counters()
    if rec["launches"]["gram_dot"] != 2:
        failures.append(f"F3: gram_dot ran {rec['launches']['gram_dot']} "
                        "times, not 2")
    rec["syrk_ms"], g_syrk = once_ms(lambda: syrk_upper(a))
    g64 = torch.zeros((n, n), dtype=torch.float64, device=dev)
    for i in range(0, m, 1 << 16):
        c = a[i:i + (1 << 16)].double()
        g64.addmm_(c.T, c)
    del c
    rel = compare(g_dot, g_syrk)[0]
    rec.update(rel_to_syrk=rel, gram_dot_rel_to_f64=compare(g_dot, g64)[0],
               syrk_rel_to_f64=compare(g_syrk, g64)[0])
    if a.is_cuda and hasattr(torch.ops.aten.mm, "dtype"):  # not in the port
        ms, g_mm = once_ms(lambda: torch.mm(a.T, a,
                                            out_dtype=torch.float32))
        rec.update(mm_out_dtype_ms=ms,
                   mm_out_dtype_rel_to_f64=compare(g_mm, g64)[0],
                   mm_out_dtype_rel_to_syrk=compare(g_mm, g_syrk)[0])
        del g_mm
    if not rel <= TOL:
        failures.append(f"F3: gram_dot differs from the SYRK kernel's Gram "
                        f"by {rel:.3e} > {TOL}")
    del a, g_dot, g_syrk, g64
    torch.cuda.empty_cache()
    rec["card"] = smi()
    print(f"[f3] {json.dumps(rec)}", flush=True)
    return rec


def polar_want(n: int, layout: str, cfg, bc: int) -> dict:
    """Launches of one polar call at n columns, from its schedule: a
    QR-variant step runs SYRK 3 times, TRMM side='R' 3 times and 'R,trans'
    once, and factors 2 Grams; a Halley step 1, 1, 1 and 1; each polish
    one SYRK. '2d' factors by cholinv, '1d' by lapack.chol_inv (the leaf
    kernel up to n = 1024, torch.linalg above)."""
    from capital_tpu_torch.algs import polar

    sched = polar.qdwh_weights(cfg.resolve_l0(torch.float32),
                               torch.float32, cfg.max_iter)
    nq = sum(c > cfg.qr_switch for _, _, c in sched)
    nh = len(sched) - nq
    want = zero_counts()
    add_trmm(want, "R", 3 * nq + nh)
    add_trmm(want, "R,trans", nq + nh)
    want["syrk_upper"] += 3 * nq + nh + cfg.ns_polish
    factors = 2 * nq + nh
    if layout == "2d":
        add_cholinv(want, n, bc, factors)
    elif n % 128 == 0 and n <= 1024:
        want["chol_inv"] += factors
    else:
        want["chol_xla"] += factors
    return want


def polar_paths(failures: list) -> list:
    """polar(A) on matrix.rand 2^18 x 2048 f32 at 'highest', default
    Config, in each of POLAR_LAYOUTS, two calls each; the first call's
    peak memory above A (at most POLAR_ITERATES iterates). Orthogonality
    and reconstruction in f64 plain products below POLAR_TOL, H bitwise
    symmetric, U within POLAR_SVD_TOL of U V^T from an f64 SVD of A. The
    library call, timed, is the f32 torch.linalg.svd with U V^T and
    V diag(S) V^T; its U V^T is held to the f64 one too (reported)."""
    from capital_tpu_torch import Grid, matrix
    from capital_tpu_torch.algs import polar
    from capital_tpu_torch.ops import counters, reset_counters
    from capital_tpu_torch.ops.precision import default_matmul_precision

    grid = Grid.square(c=1, d=1)
    m, n = POLAR_SHAPE
    cfg = polar.Config()
    a = matrix.rand(grid, m, n, 0).data
    sched = polar.qdwh_weights(cfg.resolve_l0(a.dtype), a.dtype)

    def library():
        uu, ss, vh = torch.linalg.svd(a, full_matrices=False)
        return uu @ vh, (vh.T * ss) @ vh

    once_ms(lambda: torch.linalg.svd(a[:4096], full_matrices=False))
    lib_ms, (uv, hl) = once_ms(library)
    del hl
    uu, _, vh = torch.linalg.svd(a.double(), full_matrices=False)
    uv64 = uu @ vh
    del uu, vh
    lib_dev = compare(uv, uv64)[0]
    del uv
    torch.cuda.empty_cache()
    recs = []
    for layout in POLAR_LAYOUTS:
        with default_matmul_precision("highest"):
            reset_counters()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            secs, (u, h) = once_ms(lambda: polar.polar(grid, a, cfg,
                                                       layout=layout))
            peak = torch.cuda.max_memory_allocated() - base
            got = counters()
            del u, h
            secs2, (u, h) = once_ms(lambda: polar.polar(grid, a, cfg,
                                                        layout=layout))
        best_ms = min(secs, secs2)
        want = polar_want(n, layout, cfg, cfg.chol.base_dim(grid, n))
        if got != want:
            failures.append(f"polar {layout}: launch counts {got} != "
                            f"{want}")
        iterate = m * n * a.element_size()
        if not peak <= POLAR_ITERATES * iterate:
            failures.append(f"polar {layout}: peak {peak} bytes above A, "
                            f"more than {POLAR_ITERATES} iterates")
        symmetric = torch.equal(h, h.T)
        if not symmetric:
            failures.append(f"polar {layout}: H is not bitwise symmetric")
        orth, recon = factor_errors_f64(a, u, h)
        svd_rel = compare(u, uv64)[0]
        del u, h
        torch.cuda.empty_cache()
        for what, x, tol in (("orthogonality_f64", orth, POLAR_TOL),
                             ("reconstruction_f64", recon, POLAR_TOL),
                             ("u_vs_f64_svd", svd_rel, POLAR_SVD_TOL)):
            if not x < tol:  # also fails on NaN
                failures.append(f"polar {layout}: {what} {x} not below "
                                f"{tol}")
        rec = {"m": m, "n": n, "layout": layout, "precision": "highest",
               "schedule_c": [w[2] for w in sched], "ms": [secs, secs2],
               "library_ms": lib_ms, "vs_library": lib_ms / best_ms,
               "orthogonality_f64": orth, "reconstruction_f64": recon,
               "u_vs_f64_svd": svd_rel,
               "library_u_vs_f64_svd": lib_dev,
               "h_bitwise_symmetric": symmetric,
               "peak_bytes_above_a": peak, "iterate_bytes": iterate,
               "launches": got, "card": smi()}
        print(f"[polar] {json.dumps(rec)}", flush=True)
        recs.append(rec)
    del a, uv64
    torch.cuda.empty_cache()
    return recs


def spd_solve_path(failures: list) -> dict:
    """linalg.spd_solve at SPD_RUN (cholinv at 'high', two refinement
    sweeps), two calls; the f64 host residual over 8 columns below
    SOLVE_TOL. Library: torch.linalg.cholesky + cholesky_solve."""
    from capital_tpu_torch import Grid, linalg
    from capital_tpu_torch.algs import cholinv
    from capital_tpu_torch.bench import solve as bsolve
    from capital_tpu_torch.ops import counters, reset_counters
    from capital_tpu_torch.ops.precision import default_matmul_precision

    n, k, level, refine = SPD_RUN
    grid = Grid.square(c=1, d=1)
    a, b = bsolve.operands(grid, "spd", 0, n, k, torch.float32)
    cfg = cholinv.Config(summa_impl="gspmd")
    with default_matmul_precision(level):
        reset_counters()
        secs, x = once_ms(lambda: linalg.spd_solve(grid, a, b, cfg,
                                                   refine=refine))
        got = counters()
        secs2, x = once_ms(lambda: linalg.spd_solve(grid, a, b, cfg,
                                                    refine=refine))
    want = zero_counts()
    add_cholinv(want, n, cfg.base_dim(grid, n))
    add_trmm(want, "L,trans", 1 + refine)
    add_trmm(want, "L", 1 + refine)
    if got != want:
        failures.append(f"spd_solve n={n}: launch counts {got} != {want}")
    kb = bsolve.RESIDUAL_COLS
    a64, b64 = bsolve.host_f64(a), bsolve.host_f64(b[:, :kb])
    res = bsolve.residual_f64("spd", a64, b64, x)
    lib = bsolve.library_call("spd", a, b)
    once_ms(lib)  # warm up
    lib_ms, x_lib = once_ms(lib)
    lib_res = bsolve.residual_f64("spd", a64, b64, x_lib)
    del a, b, x, x_lib, a64
    torch.cuda.empty_cache()
    if not res < SOLVE_TOL:
        failures.append(f"spd_solve n={n}: residual {res} not below "
                        f"{SOLVE_TOL}")
    best_ms = min(secs, secs2)
    rec = {"n": n, "k": k, "precision": level, "refine": refine,
           "ms": [secs, secs2],
           "gflops": (2 * n**3 / 3 + (2 + 4 * refine) * n * n * k)
           / best_ms / 1e6,
           "solve_residual_f64": res, "library_ms": lib_ms,
           "vs_library": lib_ms / best_ms,
           "library_solve_residual_f64": lib_res, "launches": got,
           "card": smi()}
    print(f"[solve] {json.dumps(rec)}", flush=True)
    return rec


def lstsq_paths(failures: list) -> list:
    """linalg.lstsq at LSTSQ_RUN by each of LSTSQ_METHODS, two calls each;
    the normal-equations residual ||A^T (A x - b)|| / ||b|| in f64 on the
    host over 8 columns, at most LSTSQ_VS_LIBRARY times torch.linalg.lstsq's
    on the same operand. For tsqr also the orthogonality of tsqr.factor's
    Q in f64."""
    from capital_tpu_torch import Grid, linalg
    from capital_tpu_torch.algs import cacqr, tsqr
    from capital_tpu_torch.bench import solve as bsolve
    from capital_tpu_torch.ops import counters, reset_counters
    from capital_tpu_torch.ops.precision import default_matmul_precision

    m, n, k, level, refine = LSTSQ_RUN
    grid = Grid.square(c=1, d=1)
    a, b = bsolve.operands(grid, "lstsq", m, n, k, torch.float32)
    kb = bsolve.RESIDUAL_COLS
    a64, b64 = bsolve.host_f64(a), bsolve.host_f64(b[:, :kb])
    lib = bsolve.library_call("lstsq", a, b)
    once_ms(lambda: torch.linalg.lstsq(a[:8192], b[:8192]))  # warm up
    lib_ms, x_lib = once_ms(lib)
    lib_res = bsolve.residual_f64("lstsq", a64, b64, x_lib)
    del x_lib
    cfg = cacqr.Config(num_iter=2)
    recs = []
    for method in LSTSQ_METHODS:
        with default_matmul_precision(level):
            reset_counters()
            secs, x = once_ms(lambda: linalg.lstsq(
                grid, a, b, cfg, refine=refine, method=method))
            got = counters()
            secs2, x = once_ms(lambda: linalg.lstsq(
                grid, a, b, cfg, refine=refine, method=method))
        want = zero_counts()
        if method == "cqr2":  # the CholeskyQR2 factor; tsqr runs none
            want.update(syrk_upper=2, trmm_upper=3, chol_inv=2)
            want["trmm_upper_by_case"].update(R=2, L=1)
        if got != want:
            failures.append(f"lstsq {method}: launch counts {got} != "
                            f"{want}")
        res = bsolve.residual_f64("lstsq", a64, b64, x)
        del x
        best_ms = min(secs, secs2)
        rec = {"m": m, "n": n, "k": k, "precision": level,
               "refine": refine, "method": method, "ms": [secs, secs2],
               "gflops": (4 * m * n * n + (2 + 4 * refine) * m * n * k)
               / best_ms / 1e6,
               "normal_residual_f64": res,
               "library_normal_residual_f64": lib_res,
               "library_ms": lib_ms, "vs_library": lib_ms / best_ms,
               "launches": got}
        if method == "tsqr":
            with default_matmul_precision(level):
                q, r = tsqr.factor(grid, a)
            rec["q_orthogonality_f64"], rec["qr_residual_f64"] = \
                qr_errors_f64(a, q, r)
            rec["r_diag_nonnegative"] = bool(
                (torch.diagonal(r) >= 0).all())
            del q, r
            for what in ("q_orthogonality_f64", "qr_residual_f64"):
                if not rec[what] < QR_TOL:
                    failures.append(f"tsqr: {what} {rec[what]} not below "
                                    f"{QR_TOL}")
        if not res <= LSTSQ_VS_LIBRARY * lib_res:
            failures.append(f"lstsq {method}: normal residual {res} above "
                            f"{LSTSQ_VS_LIBRARY} x the library's {lib_res}")
        rec["card"] = smi()
        print(f"[lstsq] {json.dumps(rec)}", flush=True)
        recs.append(rec)
    del a, b, a64
    torch.cuda.empty_cache()
    return recs


def linalg_phase(failures: list) -> dict:
    """Every other new entry point once, f32 'highest', n = LINALG_N:
    solve by 'normal', 'lu' and 'polar' (A = rand + sqrt(n) I, cond ~4;
    LINALG_K right-hand sides), inv, slogdet_spd and newton.invert(spd)
    of matrix.symmetric, expm at EXPM_N (against torch.linalg.matrix_exp
    too). Each result is held to a plain f64 host computation (numpy,
    scipy) within the bound its entry states, and each call's launch
    counts to its call tree."""
    import numpy as np
    import scipy.linalg

    from capital_tpu_torch import Grid, linalg, matrix
    from capital_tpu_torch.algs import cholinv, lu, newton, polar
    from capital_tpu_torch.ops import counters, reset_counters
    from capital_tpu_torch.ops.precision import default_matmul_precision

    grid = Grid.square(c=1, d=1)
    dev = grid.device
    n, k = LINALG_N, LINALG_K
    cfg = cholinv.Config(summa_impl="gspmd")
    bc = cfg.base_dim(grid, n)
    gen = torch.Generator(device=dev).manual_seed(4)
    a = torch.rand((n, n), generator=gen, device=dev) - 0.5
    a.diagonal().add_(n**0.5)
    b = torch.rand((n, k), generator=gen, device=dev) - 0.5
    s = matrix.symmetric(grid, n, 0, align=128).data
    a64, b64, s64 = (t.cpu().double().numpy() for t in (a, b, s))
    x64 = np.linalg.solve(a64, b64)
    sinv64 = np.linalg.inv(s64)

    def rel64(got, want) -> float:
        got = got.cpu().double().numpy()
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    def solve_want(method: str) -> dict:
        want = zero_counts()
        if method == "lu":
            nbp = lu.Config().panel(grid, n)
            leaves = (n // nbp) * lu.leaves(nbp, lu.leaf_width(True))
            want["getrf_leaf"] = leaves
            want["getrf_leaf_by_route"]["resident"] = leaves
            return want
        if method == "polar":
            want = polar_want(n, "2d", polar.Config(chol=cfg), bc)
        add_cholinv(want, n, bc)   # the Gram's, or H's by spd_solve
        add_trmm(want, "L,trans", 3)   # two refinement sweeps
        add_trmm(want, "L", 3)
        return want

    def newton_call():
        x, iters, res = newton.invert(grid, s, newton.Config(spd=True))
        entries["newton"]["iters"] = iters
        entries["newton"]["ns_residual"] = float(res)
        return x

    expm_a = ((torch.rand((EXPM_N, EXPM_N), generator=gen, device=dev)
               - 0.5) * (4.0 / EXPM_N**0.5))
    expm_want = zero_counts()
    add_cholinv(expm_want, EXPM_N, cfg.base_dim(grid, EXPM_N))
    add_trmm(expm_want, "L,trans", 3)
    add_trmm(expm_want, "L", 3)
    chol_want = zero_counts()
    add_cholinv(chol_want, n, bc)
    calls = {f"solve_{m_}": (lambda m_=m_: linalg.solve(grid, a, b,
                                                        method=m_),
                             solve_want(m_), x64, LINALG_TOL)
             for m_ in ("normal", "lu", "polar")}
    calls.update(
        inv=(lambda: linalg.inv(grid, s), chol_want, sinv64, LINALG_TOL),
        newton=(newton_call, zero_counts(), sinv64, LINALG_TOL),
        slogdet_spd=(lambda: linalg.slogdet_spd(grid, s)[1], chol_want,
                     np.linalg.slogdet(s64)[1], LINALG_TOL),
        expm=(lambda: linalg.expm(grid, expm_a), expm_want,
              scipy.linalg.expm(expm_a.cpu().double().numpy()), EXPM_TOL))
    entries = {name: {} for name in calls}
    for name, (fn, want, ref, tol) in calls.items():
        with default_matmul_precision("highest"):
            reset_counters()
            ms, out = once_ms(fn)
            got = counters()
        err = rel64(out, ref)
        entries[name].update(ms=ms, rel_err_f64=err, bound=tol,
                             launches=got)
        if name in ("inv", "newton"):  # the error's share on the diagonal
            d = np.diagonal(out.cpu().double().numpy() - ref)
            entries[name]["diag_rel_err_f64"] = float(
                np.linalg.norm(d) / np.linalg.norm(ref))
        if name.startswith("solve"):
            r = a64 @ out.cpu().double().numpy() - b64
            entries[name]["solve_residual_f64"] = float(
                np.linalg.norm(r) / np.linalg.norm(b64))
        if got != want:
            failures.append(f"linalg {name}: launch counts {got} != {want}")
        if not err < tol:
            failures.append(f"linalg {name}: error {err} to the f64 host "
                            f"result not below {tol}")
        del out
    lib_ms, lib = once_ms(lambda: torch.linalg.matrix_exp(expm_a))
    entries["expm"].update(library_ms=lib_ms,
                           library_rel_err_f64=rel64(lib, calls["expm"][2]),
                           vs_library=lib_ms / entries["expm"]["ms"])
    del a, b, s, lib, expm_a
    torch.cuda.empty_cache()
    rec = {"n": n, "k": k, "expm_n": EXPM_N, "precision": "highest",
           "entries": entries, "card": smi()}
    print(f"[linalg] {json.dumps(rec)}", flush=True)
    return rec


def path_launches(row: dict, mains: list, lus: list, qrs: list,
                  polars: list) -> tuple[bool, int]:
    """(on_path, launches) of a kernel row: whether a main path runs its
    kernel at its precision, input type and kind of operand (the
    recursion's 128-aligned windows at most 32 x 512 rows deep; cacqr's
    Gram and formQ; polar's Gram and its side='R' products on the 2^18-row
    iterate; the leaf at cholinv's base case or cacqr's n; the LU leaf's
    strips), and that run's launches of the kernel (and TRMM case), else
    0. TRMM's R,trans case runs on the polar path only."""
    kernel, case = row["kernel"], row["case"]
    if kernel == "getrf_leaf":  # no leaf of the LU paths is that tall
        if row["leaf_route"] == "tall":
            return False, 0
        return True, lus[0]["launches"]["getrf_leaf"]
    if kernel == "chol_inv":  # f32 at every precision
        if case == f"n={mains[0]['bc']}":  # the cholinv headline run
            return True, mains[0]["launches"]["chol_inv"]
        qr = next((q for q in qrs if case == f"n={q['n']}"), None)
        return (True, qr["launches"]["chol_inv"]) if qr else (False, 0)
    if case in ("cacqr", "R:cacqr"):
        got = next(q["launches"] for q in qrs
                   if q["precision"] == row["precision"])
        return True, (got["trmm_upper_by_case"]["R"]
                      if kernel == "trmm_upper" else got[kernel])
    if case in ("polar", "R:polar", "R,trans:polar"):
        got = polars[0]["launches"]  # the 2d headline, 'highest'
        return True, (got["trmm_upper_by_case"][case.split(":")[0]]
                      if kernel == "trmm_upper" else got[kernel])
    got = next((mp["launches"] for mp in mains
                if mp["precision"] == row["precision"]), None)
    off_path = ("ragged", "fold", "bf16")
    if kernel == "trmm_upper":
        base, _, variant = case.partition(":")
        if base == "R,trans" or variant in off_path:
            return False, 0
        return True, got["trmm_upper_by_case"][base]
    if case in off_path:
        return False, 0
    return True, got[kernel]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        from capital_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: the capital_tpu_torch package is missing: {exc}",
              file=sys.stderr)
        return 1
    card = smi()
    print(card, flush=True)

    print(f"[build] {_build.build():.1f} s", flush=True)
    failures: list[str] = []
    rows = []
    for level in ("highest", "high"):
        rows += kernel_phase(level, failures)
    torch.cuda.empty_cache()
    rows += leaf_phase(failures)
    f3 = f3_phase(failures)
    mains = [main_path(n, level, failures) for n, level in MAIN_RUNS]
    lus = [lu_path(*run, failures) for run in LU_RUNS]
    qrs = [cacqr_path(*run, failures) for run in CACQR_RUNS]
    polars = polar_paths(failures)
    solves = [spd_solve_path(failures)]
    lstsqs = lstsq_paths(failures)
    linalgs = [linalg_phase(failures)]
    for row in rows:
        row["on_path"], row["launches"] = path_launches(row, mains, lus, qrs,
                                                        polars)
        if row["on_path"] and not row["launches"]:
            failures.append(f"{row['name']} never launched on the main path")
    result = {"card": card, "kernels": rows, "main": mains, "lu": lus,
              "cacqr": qrs, "f3": f3, "polar": polars, "solve": solves,
              "lstsq": lstsqs, "linalg": linalgs, "failures": failures}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    if failures:
        for msg in failures:
            print(f"FAIL: {msg}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"[chip_smoke] {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
