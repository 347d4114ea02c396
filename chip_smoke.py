#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (capital_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile-check N   # how often a one-call
                                              # profile misses kernels

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
9. QDWH spectral layer, f32 'highest', eigh base case 1024 (the JAX
   bench's default): [eigh] eigh.eigh of a Wigner-class n = 8192 operand
   (matrix.symmetric, diag_shift 0), two calls, residual and
   orthogonality in f64 below 1e-4, eigenvalues within 1e-5 ||A||_F of
   an f64 eigvalsh, the library's f32 torch.linalg.eigh beside it; [svd]
   svd.svd of [polar]'s operand, '2d', reconstruction and both
   orthogonalities in f64 below 1e-4, singular values within 1e-5 s_max
   of [polar]'s f64 SVD; [eigh_partial] the top 256 of a Wigner-class n =
   16384 operand (its probes, m, Rayleigh-Ritz residual and
   orthogonality, the values against the library's f32 eigh); [spectral]
   eigvalsh, count_above (exact), eigh_gen, svd_partial, singular_values,
   pinv, cond and the funm_spd family at n = 4096 against f64 results on
   the card. The recursion's shape depends on the spectrum: the path's
   sign, split and orthonormalization stages are recorded as they run
   (eigh_stages) and the expected launches built from them (a sign is a
   '2d' polar at its padded size; a cholinv leaf that is no multiple of
   128 is torch.linalg's, counted as chol_xla). The kernel phase adds
   TRMM side='R' and SYRK rows at the top sign's 8192^2 'highest' shape.
10. The application layer and host storage, at the JAX package's sizes:
   [rsvd] apps.rsvd of bench.rsvd's planted 2^18 x 2048 f32 operand
   (k = 128, oversample 16, one power iteration; the JAX bench's default),
   'highest'; [rsvd_bf16] 2^19 x 4096 in bf16 storage, k = 256,
   oversample 32 (BENCH_LOCAL.md:41); [pca] apps.pca of a planted rank-32
   2^16 x 512 operand with a column mean, k = 32; [als] apps.als.fit,
   dense, 65536 users x 8192 items, rank 64, density 0.05, 5 iterations,
   lam 0.05 (the JAX bench's defaults); [als_sparse] fit_sparse on 192
   observations a user (12.6 M); [io] save_factor / load_factor of an
   n = 4096 cholinv factor taken from the card (bitwise) and a
   save_sharded / load_sharded round trip of it. Each rSVD call runs two
   CholeskyQR2 factors of the f32 sketch: 4 TRMM side='R', 2 side='L', 4
   SYRK and, as l is no multiple of 128, 4 torch.linalg Gram Choleskys
   (chol_xla). Bounds: singular values within 5e-3 of the planted ones
   (PCA's variances within 1e-4 of an f64 eigendecomposition of the
   covariance), ||U^T U - I||_F < 1e-5 and ||A V^T - U diag(s)||_F /
   ||A||_F < 1e-4 in f64 products (bf16 storage: below bf16's unit
   roundoff 2^-8, as the JAX package rounds each sketch to bf16), ALS RMSE
   < 0.08 (noise floor 0.05) with no kernel and no fallback run. The
   library call for [rsvd] is torch.svd_lowrank(A, q=l, niter=1). Each
   prints its calls' times, its peak memory above the operand and the
   device's busy share of one profiled call; the core SVD of the first
   call is also held to an f64 SVD of the same B (reported). The kernel
   phase adds SYRK and TRMM side='R' rows at the sketches' shapes, 2^18 x
   144 and 2^19 x 288 f32 'highest', with the plain Gram's
   (blas.gram_dot) time beside them.
11. The autotuner and the one-device drivers: [autotune] tune.main for
   cholinv, cacqr, LU and eigh at its defaults (n = 4096, cacqr 2^18 x
   4096, the default spaces and --num-iter; tables under
   chiprun_out/autotune/), each alg's best params, time, candidate and
   error counts printed; any candidate error fails (the JAX tuner's
   one-device spaces hold only configs valid for these shapes), and each
   sweep must launch the kernels its path reaches; then the grid-shape
   sweep (tune.main --grid sweep) of cholinv at n = 4096 on the visible
   cards, one NCCL rank a card (grid_candidates: (square, 1, 1) alone on
   one card), whose candidates must carry the grid and device-count
   columns; [hybrid]
   cacqr.factor_hybrid on the one-device rect grid at 2^20 x 1024 f32
   'highest' (launches from its call tree, orthogonality and residual by
   the kernels and in f64 below 1e-5, its time beside factor_1d's on the
   same operand); [cyclic] cholinv_cyclic.factor at n = 8192 'highest',
   base case 512 (16 Cholesky leaves and no other kernel: its window
   products are plain products; residuals below 1e-5; its time beside
   cholinv.factor's); [drivers] bench.summa_gemm at 8192^3 'highest'
   (tile_rel_err below 1e-5), bench.scaling --alg cholinv, and again with
   --devices set to the visible cards (its shapes those c*d*d of them
   hold), entry()'s step (residuals below 1e-5) and the four examples,
   each held to its own bounds and launching its kernels.
   [dryrun] entry.dryrun_multichip over a world of one NCCL rank a card
   (the JAX dry run's steps, configs and bounds, in its order: each
   step's figure must hold its bound); on the rank's card it must launch
   SYRK, TRMM and the LU leaf (the Cholesky leaf not: its configs take
   torch.linalg's leaf or blocks narrower than 128) and run no plain LU
   leaf or library panel.
   [mesh] the multi-device substrate over NCCL, one rank a card
   (parallel/launch.py; one rank on a one-card machine), grids from the
   world's constructors: cholinv.factor at n = 32768 'high', base case
   512, with each base_policy and summa_impl, bitwise equal to the
   one-device factor of the same operand (on one rank) and 189 / 63 / 64
   TRMM / SYRK / leaf launches each, residuals below 1e-5; cacqr.factor_1d
   at 2^20 x 1024 'highest' on the rect grid with the SYRK Gram and each
   Gram policy, bitwise equal to the one-device factor, 3 / 2 / 2
   launches, errors by the kernels and in f64 below 1e-5; factor_3d at
   2^18 x 1024 and factor_hybrid at 2^20 x 1024, 'highest', within 1e-5
   of the one-device factor; summa.gemm 'shard_map' (num_chunks 4,
   collect_chunks 2) and 'ring' at 8192^3 'highest' within 1e-5 of a
   plain product. The solver layer (mesh_solvers), each call bitwise
   equal to the one-device call on the same operand with its call tree's
   launches and the one-device phases' bounds: lu.factor at each of
   LU_RUNS (256 and 64 getrf_leaf, all resident; the second with
   lookahead and the 256-column solve refined twice), polar 2^18 x 2048
   in '2d' (55 / 22 / 20 TRMM / SYRK / leaf) and '1d' (10 / 7 / 0 and 5
   chol_xla), spd_solve at SPD_RUN, lstsq at LSTSQ_RUN by 'cqr2' on the
   rect grid and by 'tsqr' (on one rank the single leaf), and trsm,
   rectri and newton (SPD) at n = 4096, 'highest', held to f64 on the
   card (residuals below 1e-5, Newton's inverse to LINALG_TOL). The
   spectral and application layers and the cyclic workspace
   (mesh_spectral): cholinv_cyclic at CYCLIC_RUN, eigh at EIGH_N,
   eigh_partial at PARTIAL_RUN, the twelve [spectral] entries at
   SPECTRAL_N, svd at POLAR_SHAPE, rsvd, pca, als and als_sparse at their
   phases' shapes, on their phases' operands; each bitwise equal to the
   one-device phase's result (its fingerprint: the phase's result is not
   computed again) with the phase's launches, so within the phase's
   bounds. Eight ranks on the one card (the 2 x 2 x 2 schedule, the TSQR tree, every
   multi-rank schedule) are not run: the installed gloo backend refuses
   batch_isend_irecv of CUDA tensors (MULTI_RANK_ON_CARD,
   bench/mesh_probe.py); they are held on 8 gloo CPU ranks by the
   tests.
   Every main path zeroes the launch counters just before it and reads
   them just after: each kernel of the path must have run the number of
   times its call tree gives (every LU leaf on the resident route), and
   no fallback may have run. GFLOP/s and
   the time ratio against the library call at the same shape are printed,
   and each phase's seconds.

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
an LU leaf row's case is its strip's label. The rows "R:eigh" and "eigh"
take their launches from the [eigh] run, and the leaf's n = 512 row
carries that run's leaf launches as `launches_eigh`; the rows "rsvd",
"R:rsvd", "rsvd_bf16" and "R:rsvd_bf16" from the first call of their
rSVD path. Every row also carries `launches_autotune`, `launches_hybrid`,
`launches_cyclic`, `launches_drivers`, `launches_mesh` and
`launches_dryrun` (the last two rank 0's):
its kernel's (for TRMM, its case's) launches in those phases, at every
precision.
"""

from __future__ import annotations

import contextlib
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
# QDWH spectral layer, f32 'highest', eigh base case 1024 (the JAX bench's
# default): eigh of a Wigner-class n = 8192 operand (matrix.symmetric with
# diag_shift 0, as the JAX bench builds it), svd at POLAR_SHAPE,
# eigh_partial (n, k) top, and the other entry points at SPECTRAL_N
EIGH_N, EIG_BASE = 8192, 1024
PARTIAL_RUN = (16384, 256)
SPECTRAL_N, SPECTRAL_K = 4096, 128
EIG_TOL = 1e-4       # residual and orthogonality in f64
EIG_W_TOL = 1e-5     # eigen- and singular values against f64 (relative)
SPECTRAL_TOL = 1e-4  # a matrix result against its f64 one (relative)
# application layer: rSVD runs (m, n, k, oversample, power_iters, dtype),
# the JAX bench's default and its bf16 run (BENCH_LOCAL.md:41, 120-121);
# PCA (m, n, k); ALS (users, items, rank, density or observations a user,
# iterations), the JAX bench's defaults; the io factor's n
RSVD_RUNS = {"rsvd": (1 << 18, 2048, 128, 16, 1, "float32"),
             "rsvd_bf16": (1 << 19, 4096, 256, 32, 1, "bfloat16")}
PCA_RUN = (1 << 16, 512, 32)
ALS_RUN = (65536, 8192, 64, 0.05, 5)
ALS_SPARSE_RUN = (65536, 8192, 64, 192, 5)
ALS_LAM, ALS_RMSE = 0.05, 0.08
IO_N = 4096
RSVD_SV_TOL, RSVD_ORTH_TOL, RSVD_RES_TOL = 5e-3, 1e-5, 1e-4
RSVD_RES_TOL_BF16 = 2.0**-8   # bf16's unit roundoff
PCA_TOL = 1e-4
# the autotuner (tune.main at its defaults: cholinv, LU and eigh n = 4096,
# cacqr 2^18 x 4096, the default spaces and --num-iter) and the kernels
# each alg's sweep must reach; the hybrid CholeskyQR at cacqr's headline
# shape; the cyclic-workspace cholinv (n, base case); the SUMMA gemm
# driver's default m = k = n
AUTOTUNE_ALGS = {"cholinv": ("trmm_upper", "syrk_upper", "chol_inv"),
                 "cacqr": ("trmm_upper", "syrk_upper"),
                 "lu": ("getrf_leaf",),
                 "eigh": ("trmm_upper", "syrk_upper", "chol_inv")}
AUTOTUNE_GRID_N = 4096  # the grid-shape sweep's cholinv operand
HYBRID_SHAPE = (1 << 20, 1024)
CYCLIC_RUN = (8192, 512)
SUMMA_GEMM_TOL = 1e-5
# [mesh]: the multi-device substrate over NCCL, one rank a card. The
# 2 x 2 x 2 schedule as eight ranks on one card needs a backend that takes
# every collective the engine issues on CUDA tensors; the installed gloo
# takes all_gather_into_tensor, all_reduce and reduce_scatter_tensor but
# fails batch_isend_irecv ("gloo/transport/tcp/pair.cc:339] writev ...:
# Bad address", torch 2.11.0+cu128; python -m
# capital_tpu_torch.bench.mesh_probe --ranks 8 --device cuda:0 --backend
# gloo), so that part is not run.
MULTI_RANK_ON_CARD = False
MESH_CHOL = (32768, "high")
MESH_QR = (1 << 20, 1024, "highest")
MESH_3D = (1 << 18, 1024, "highest")
MESH_GEMM = 8192
MESH_POLICIES = ("replicated", "layer", "gather", "gather_overlap")
MESH_IMPLS = ("shard_map", "ring", "gspmd")
# [mesh]'s solver layer: the triangular calls at n, right-hand sides k
MESH_TRI = (4096, 256)
# [dryrun]: the kernels the dry run must launch on the card, and the
# plain-version and library routes it must not take
DRYRUN_KERNELS = ("trmm_upper", "syrk_upper", "getrf_leaf")
DRYRUN_FALLBACKS = ("leaf_plain", "lu_library")
# the examples' kernels: each must launch at least once in its run
EXAMPLE_KERNELS = {
    "gp_regression": ("trmm_upper", "syrk_upper"),
    "orthogonalize_embeddings": ("trmm_upper", "syrk_upper", "chol_inv"),
    "spectral_analysis": ("trmm_upper", "syrk_upper"),
    "steady_state_transport": ("getrf_leaf",)}


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


# [mesh]'s references: the one-device phases' results on the operands
# mesh_spectral repeats, by name (keep_ref), passed to the world's ranks
MESH_REFS: dict = {}


def fingerprint(x) -> list:
    """A result's bit-level fingerprint, computed on the card: for each
    tensor (a DArray gathered whole) its shape, dtype and two int64 sums
    of its bit patterns (plain, and weighted by a hash of the position),
    for a number its repr. Equal results give equal fingerprints; unequal
    ones equal fingerprints only by a 2^-64-class collision."""
    from capital_tpu_torch.parallel import darray

    if isinstance(x, (tuple, list)):
        return [fingerprint(y) for y in x]
    if not isinstance(x, (torch.Tensor, darray.DArray)):
        return repr(x)
    t = darray.to_global(x).contiguous().reshape(-1)
    ints = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.int8}
    bits = (t if not t.is_floating_point()
            else t.view(ints[t.element_size()])).to(torch.int64)
    idx = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64)
    weight = (idx * 2654435761) % 2147483647 + 1
    return [list(x.shape), str(x.dtype), int(bits.sum()),
            int((bits * weight).sum())]


def keep_ref(name: str, out, launches: dict, **checks) -> None:
    """Keep a one-device phase's result for [mesh] (mesh_spectral): its
    fingerprint, launch counts and bound checks, so the world's call on
    the same operand is held to it without running it again."""
    MESH_REFS[name] = {"fp": fingerprint(out), "launches": launches,
                       "checks": checks}


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


def leaf_sizes(n: int, bc: int, split: int = 1) -> list:
    """The block sizes of cholinv's leaves at base case bc."""
    if n <= bc:
        return [n]
    n1 = max(bc, n >> split)
    return leaf_sizes(n1, bc, split) + leaf_sizes(n - n1, bc, split)


def add_cholinv(want: dict, n: int, bc: int, times: int = 1) -> None:
    """The launches of `times` cholinv.factor calls at n, base case bc. A
    leaf that is a multiple of 128 up to 1024 is the kernel's; any other
    (the eigensolver's data-dependent blocks) is torch.linalg's by design
    (`chol_xla`, ops/lapack.py, as the JAX package's dispatch)."""
    _, inner = tree(n, bc)
    for case in ("L", "L,trans", "R"):
        add_trmm(want, case, inner * times)
    want["syrk_upper"] += inner * times
    for size in leaf_sizes(n, bc):
        key = "chol_inv" if size % 128 == 0 and size <= 1024 else "chol_xla"
        want[key] += times


def add_counts(want: dict, more: dict) -> None:
    """want += more, key by key (ops.counters()'s shape)."""
    for k, v in more.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                want[k][kk] += vv
        else:
            want[k] += v


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
        eigh_rows(gen, failures, add)
        rsvd_rows(gen, failures, add)

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


def eigh_rows(gen, failures: list, add) -> None:
    """TRMM side='R' and SYRK at the [eigh] path's largest call, the top
    sign's 8192^2 'highest' update and Gram, each held against its plain
    version on the whole operand; G is bitwise symmetric."""
    from capital_tpu_torch.ops.cuda_syrk import syrk_upper, syrk_upper_plain
    from capital_tpu_torch.ops.cuda_trmm import trmm_upper, trmm_upper_plain

    n = EIGH_N
    dev = gen.device
    a = torch.rand((n, n), generator=gen, device=dev) - 0.5
    u = torch.triu(torch.rand((n, n), generator=gen, device=dev))
    u.diagonal().add_(1.0)
    ops = n * n * (n + 1)

    def kt():
        return trmm_upper(u, a, side="R", matmul_precision="highest")

    ms = events_ms(kt, 3)
    out = kt()
    plain_ms, want = once_ms(lambda: trmm_upper_plain(u, a, side="R",
                                                      prec="highest"))
    lib_ms = events_ms(lambda: torch.matmul(a, u), 3)
    add("trmm_upper", "R:eigh", [n, n], out, plain_ms, want, ms, lib_ms,
        ops, 4 * (n * (n + 1) / 2 + 2 * n * n), PEAK_F32)
    del out, want

    def ks():
        return syrk_upper(a, matmul_precision="highest")

    ms = events_ms(ks, 3)
    got = ks()
    check_symmetric(got, "syrk_upper[eigh]@highest", failures)
    plain_ms, want = once_ms(lambda: syrk_upper_plain(a, prec="highest"))
    lib_ms = events_ms(lambda: torch.matmul(a.T, a), 3)
    add("syrk_upper", "eigh", [n, n], got, plain_ms, want, ms, lib_ms, ops,
        4 * 2 * n * n, PEAK_F32)
    del a, u, got, want
    torch.cuda.empty_cache()


def rsvd_rows(gen, failures: list, add) -> None:
    """SYRK (the Gram) and TRMM side='R' (formQ) of the rSVD paths'
    CholeskyQR2 at their f32 sketch shapes, (m, l) = (2^18, 144) and (2^19,
    288), 'highest', each held against its plain version on the whole
    operand; G is bitwise symmetric. The plain Gram's time (blas.gram_dot,
    the port's 'dot' route) is added beside SYRK's."""
    from capital_tpu_torch.ops import blas
    from capital_tpu_torch.ops.cuda_syrk import syrk_upper, syrk_upper_plain
    from capital_tpu_torch.ops.cuda_trmm import trmm_upper, trmm_upper_plain

    dev = gen.device
    for case, (m, n, k, over, _, _) in RSVD_RUNS.items():
        l = k + over
        a = torch.rand((m, l), generator=gen, device=dev) - 0.5

        def ks():
            return syrk_upper(a, matmul_precision="highest")

        ms = events_ms(ks, 5)
        got = ks()
        check_symmetric(got, f"syrk_upper[{case}]@highest", failures)
        plain_ms, want = once_ms(lambda: syrk_upper_plain(a, prec="highest"))
        lib_ms = events_ms(lambda: torch.matmul(a.T, a), 5)
        row = add("syrk_upper", case, [m, l], got, plain_ms, want, ms, lib_ms,
                  m * l * (l + 1), 4 * (m * l + l * l), PEAK_F32)
        row["gram_dot_ms"] = events_ms(lambda: blas.gram_dot(a), 5)
        del got, want
        u = torch.triu(torch.rand((l, l), generator=gen, device=dev))
        u.diagonal().add_(1.0)

        def kt():
            return trmm_upper(u, a, side="R", matmul_precision="highest")

        ms = events_ms(kt, 5)
        out = kt()
        plain_ms, want = once_ms(lambda: trmm_upper_plain(u, a, side="R",
                                                          prec="highest"))
        lib_ms = events_ms(lambda: torch.matmul(a, u), 5)
        add("trmm_upper", f"R:{case}", [m, l], out, plain_ms, want, ms,
            lib_ms, m * l * (l + 1), 4 * (l * (l + 1) / 2 + 2 * l * m),
            PEAK_F32)
        del a, u, out, want
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


# One-call profiles lose kernel events on the H100 in two ways
# (`python3 chip_smoke.py --profile-check N`, PERF.md section 6): the call's
# first kernel, when the call starts as the session starts, and, in one or
# two sessions a thousand, a few at a time, every event of the session. So
# a session waits PROFILE_SETTLE_S, then launches a witness kernel
# (WITNESS) before the call: a session without the witness lost events, is
# not a reading, and is taken again after PROFILE_RETRY_S.
PROFILE_SETTLE_S = 2e-3
PROFILE_RETRY_S = 0.2
PROFILE_TRIES = 5
WITNESS = "bitwise_not"


def profiled_kernels(fn, settle: bool = True) -> tuple[dict, bool]:
    """(kernel events by name, copies and the witness left out; whether
    the witness was seen) of one torch.profiler session around one call
    of fn. settle=False profiles the bare call, with no wait and no
    witness (and so always reports the witness as seen)."""
    from torch.profiler import ProfilerActivity, profile

    mark = torch.zeros(1, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if settle:
            time.sleep(PROFILE_SETTLE_S)
            mark.bitwise_not_()
        fn()
        torch.cuda.synchronize()
    seen = {e.key: e.count for e in prof.key_averages()
            if e.device_time_total > 0 and not e.key.startswith("Memcpy")}
    witness = [k for k in seen if WITNESS in k]
    for k in witness:
        del seen[k]
    return seen, bool(witness) or not settle


def device_launches(fn) -> tuple[int, int]:
    """(kernels the card runs for one call of fn, profiles that lost their
    events on the way), from the first profile that kept its witness."""
    fn()
    torch.cuda.synchronize()
    for lost in range(PROFILE_TRIES):
        seen, kept = profiled_kernels(fn)
        if kept:
            return sum(seen.values()), lost
        time.sleep(PROFILE_RETRY_S)
    raise RuntimeError(f"{PROFILE_TRIES} profiles in a row lost their "
                       "events")


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
        row["device_launches_per_call"], row["profiles_lost"] = \
            device_launches(lambda: chol_inv_cuda(a))
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
        (with_copy, lost_k), (copy, lost_r) = (device_launches(k),
                                               device_launches(restore))
        launches = with_copy - copy
        b_ms, b_by = bound(mm * ib * ib, 2 * mm * ib * 4, PEAK_F32)
        row = {"name": f"getrf_leaf[{label}]", "kernel": "getrf_leaf",
               "case": label, "route": "cuda", "source": SOURCE["getrf_leaf"],
               "replaces": REPLACES["getrf_leaf"], "precision": "highest",
               "shape": [mm, ib], "leaf_route": how.route,
               "plan": how._asdict(), "launches": None,
               "max_abs_err": mae, "rel_err": rel, "pivots_equal": same,
               "factor_bitwise": bitwise, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
               "device_launches_per_call": launches,
               "profiles_lost": lost_k + lost_r}
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


def polar_paths(failures: list, keep: dict) -> list:
    """polar(A) on matrix.rand 2^18 x 2048 f32 at 'highest', default
    Config, in each of POLAR_LAYOUTS, two calls each; the first call's
    peak memory above A (at most POLAR_ITERATES iterates). Orthogonality
    and reconstruction in f64 plain products below POLAR_TOL, H bitwise
    symmetric, U within POLAR_SVD_TOL of U V^T from an f64 SVD of A. The
    library call, timed, is the f32 torch.linalg.svd with U V^T and
    V diag(S) V^T; its U V^T is held to the f64 one too (reported). The
    f64 singular values and the library time go into `keep` for [svd]."""
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
    uu, keep["s64"], vh = torch.linalg.svd(a.double(), full_matrices=False)
    keep["library_ms"] = lib_ms
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


@contextlib.contextmanager
def eigh_stages(rec: list):
    """Record the port's eigh stages while they run: ('sign', padded n,
    the sign's polar config), ('split', n, k), ('orth', padded n, its
    cholinv config). Harness code for the launch counts, which depend on
    the spectrum: it wraps eigh._stage_sign, _stage_split and
    _orthonormalize_2d for the duration of the block."""
    from capital_tpu_torch.algs import eigh

    sign, split, orth = (eigh._stage_sign, eigh._stage_split,
                         eigh._orthonormalize_2d)

    def rec_sign(grid, a, sigma, cfg):
        rec.append(("sign", eigh._padded(grid, a.shape[0]),
                    cfg.sign_polar_cfg(a.dtype)))
        return sign(grid, a, sigma, cfg)

    def rec_split(grid, a, u, key, cfg, k):
        rec.append(("split", a.shape[0], k))
        return split(grid, a, u, key, cfg, k)

    def rec_orth(grid, y, chol_cfg):
        rec.append(("orth", eigh._padded(grid, y.shape[0]), chol_cfg))
        return orth(grid, y, chol_cfg)

    eigh._stage_sign, eigh._stage_split = rec_sign, rec_split
    eigh._orthonormalize_2d = rec_orth
    try:
        yield
    finally:
        eigh._stage_sign, eigh._stage_split = sign, split
        eigh._orthonormalize_2d = orth


def stages_want(grid, rec: list, want: dict) -> dict:
    """Add the launches of the recorded stages: a sign is a '2d' polar at
    its padded n (polar_want); an orthonormalization three passes of one
    SYRK, one cholinv factor and one TRMM side='R'. The splits' and the
    glue's products are plain."""
    for kind, n, cfg in rec:
        if kind == "sign":
            add_counts(want, polar_want(n, "2d", cfg,
                                        cfg.chol.base_dim(grid, n)))
        elif kind == "orth":
            want["syrk_upper"] += 3
            add_trmm(want, "R", 3)
            add_cholinv(want, n, cfg.base_dim(grid, n), 3)
    return want


def stage_summary(rec: list) -> dict:
    """Signs by padded size and l0, and the splits' (n, k)."""
    signs: dict = {}
    for kind, n, cfg in rec:
        if kind == "sign":
            key = f"{n}@l0={cfg.l0:.3g}"
            signs[key] = signs.get(key, 0) + 1
    return {"signs": signs,
            "splits": [[n, k] for kind, n, k in rec if kind == "split"]}


def counted_call(fn):
    """(ms, result, launch counts, recorded stages, peak bytes above what
    was allocated before) of one call of fn."""
    from capital_tpu_torch.ops import counters, reset_counters

    rec: list = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counters()
    with eigh_stages(rec):
        ms, out = once_ms(fn)
    got = counters()
    return ms, out, got, rec, torch.cuda.max_memory_allocated() - base


def eig_errors_f64(a: torch.Tensor, w: torch.Tensor,
                   v: torch.Tensor) -> tuple[float, float]:
    """(||A V - V diag(w)||_F / ||A||_F, ||V^T V - I||_F / sqrt(k)) in f64
    products on the card."""
    a64, v64 = a.double(), v.double()
    res = float(torch.linalg.norm(a64 @ v64 - v64 * w.double()[None, :])
                / torch.linalg.norm(a64))
    del a64
    g = v64.T @ v64
    g.diagonal().sub_(1.0)
    return res, float(torch.linalg.norm(g)) / v.shape[1] ** 0.5


def eigh_path(failures: list) -> dict:
    """eigh.eigh of a Wigner-class EIGH_N operand, f32 'highest',
    Config(base_n=EIG_BASE), two calls (the first counted, its peak
    taken). Residual and orthogonality in f64 below EIG_TOL, eigenvalues
    within EIG_W_TOL * ||A||_F of an f64 eigvalsh on the card; the library
    call is the f32 torch.linalg.eigh (its residual and orthogonality
    reported)."""
    from capital_tpu_torch import Grid, matrix
    from capital_tpu_torch.algs import eigh
    from capital_tpu_torch.ops.precision import default_matmul_precision

    grid = Grid.square(c=1, d=1)
    n = EIGH_N
    a = matrix.symmetric(grid, n, 0, diag_shift=0.0, align=128).data
    cfg = eigh.Config(base_n=EIG_BASE)
    with default_matmul_precision("highest"):
        secs, (w, v), got, rec, peak = counted_call(
            lambda: eigh.eigh(grid, a, cfg))
        del w, v
        secs2, (w, v) = once_ms(lambda: eigh.eigh(grid, a, cfg))
    want = stages_want(grid, rec, zero_counts())
    if got != want:
        failures.append(f"eigh n={n}: launch counts {got} != {want}")
    res, orth = eig_errors_f64(a, w, v)
    keep_ref("eigh", (w, v), got, residual_f64=res, orthogonality_f64=orth)
    del v
    scale = float(torch.linalg.norm(a.double()))
    w64 = torch.linalg.eigvalsh(a.double())
    w_err = float(torch.max(torch.abs(w.double() - w64))) / scale
    once_ms(lambda: torch.linalg.eigh(a[:1024, :1024]))  # warm up
    lib_ms, (wl, vl) = once_ms(lambda: torch.linalg.eigh(a))
    lib_res, lib_orth = eig_errors_f64(a, wl, vl)
    lib_w_err = float(torch.max(torch.abs(wl.double() - w64))) / scale
    del wl, vl, a, w64
    torch.cuda.empty_cache()
    for what, x, tol in (("residual_f64", res, EIG_TOL),
                         ("orthogonality_f64", orth, EIG_TOL),
                         ("w_err_f64", w_err, EIG_W_TOL)):
        if not x < tol:  # also fails on NaN
            failures.append(f"eigh n={n}: {what} {x} not below {tol}")
    best_ms = min(secs, secs2)
    rec_out = {"n": n, "base_n": EIG_BASE, "precision": "highest",
               "ms": [secs, secs2], "library_ms": lib_ms,
               "vs_library": lib_ms / best_ms, "residual_f64": res,
               "orthogonality_f64": orth, "w_err_f64": w_err,
               "library_residual_f64": lib_res,
               "library_orthogonality_f64": lib_orth,
               "library_w_err_f64": lib_w_err, **stage_summary(rec),
               "launches": got, "peak_bytes_above_a": peak,
               "peak_n2x4": peak / (4 * n * n), "card": smi()}
    print(f"[eigh] {json.dumps(rec_out)}", flush=True)
    return rec_out


def svd_path(failures: list, keep: dict) -> dict:
    """svd.svd of [polar]'s operand (matrix.rand POLAR_SHAPE, seed 0), f32
    'highest', layout '2d', eig Config(base_n=EIG_BASE), two calls.
    Reconstruction and the orthogonality of U and of V in f64 below
    EIG_TOL; singular values within EIG_W_TOL * s_max of [polar]'s f64
    SVD; vs_library against the f32 torch.linalg.svd [polar] timed."""
    from capital_tpu_torch import Grid, matrix
    from capital_tpu_torch.algs import eigh, svd
    from capital_tpu_torch.ops.precision import default_matmul_precision

    grid = Grid.square(c=1, d=1)
    m, n = POLAR_SHAPE
    a = matrix.rand(grid, m, n, 0).data
    cfg = svd.Config(eig=eigh.Config(base_n=EIG_BASE))
    with default_matmul_precision("highest"):
        secs, (u, s, v), got, rec, peak = counted_call(
            lambda: svd.svd(grid, a, cfg, layout="2d"))
        del u, s, v
        secs2, (u, s, v) = once_ms(lambda: svd.svd(grid, a, cfg,
                                                   layout="2d"))
    want = polar_want(n, "2d", cfg.polar, cfg.polar.chol.base_dim(grid, n))
    stages_want(grid, rec, want)
    if got != want:
        failures.append(f"svd: launch counts {got} != {want}")
    orth_u, recon = factor_errors_f64(a, u, (v * s[None, :]).T)
    g = v.double().T @ v.double()
    g.diagonal().sub_(1.0)
    orth_v = float(torch.linalg.norm(g)) / n**0.5
    s64 = keep["s64"]
    s_err = float(torch.max(torch.abs(s.double() - s64)) / s64[0])
    keep_ref("svd", (u, s, v), got, reconstruction_f64=recon,
             u_orthogonality_f64=orth_u, v_orthogonality_f64=orth_v,
             s_err_f64=s_err)
    del u, s, v, g, a
    torch.cuda.empty_cache()
    for what, x, tol in (("reconstruction_f64", recon, EIG_TOL),
                         ("u_orthogonality_f64", orth_u, EIG_TOL),
                         ("v_orthogonality_f64", orth_v, EIG_TOL),
                         ("s_err_f64", s_err, EIG_W_TOL)):
        if not x < tol:
            failures.append(f"svd: {what} {x} not below {tol}")
    best_ms = min(secs, secs2)
    out = {"m": m, "n": n, "layout": "2d", "eig_base_n": EIG_BASE,
           "precision": "highest", "ms": [secs, secs2],
           "library_ms": keep["library_ms"],
           "vs_library": keep["library_ms"] / best_ms,
           "reconstruction_f64": recon, "u_orthogonality_f64": orth_u,
           "v_orthogonality_f64": orth_v, "s_err_f64": s_err,
           **stage_summary(rec), "launches": got,
           "peak_bytes_above_a": peak, "peak_n2x4": peak / (4 * n * n),
           "peak_operands": peak / (4 * m * n), "card": smi()}
    print(f"[svd] {json.dumps(out)}", flush=True)
    return out


def partial_path(failures: list) -> dict:
    """eigh.eigh_partial, top PARTIAL_RUN k of a Wigner-class n operand,
    f32 'highest', Config(base_n=EIG_BASE) with its default
    partial_refine=2, one call. The Rayleigh-Ritz pairs' residual and
    orthogonality in f64 below EIG_TOL; the eigenvalues within EIG_W_TOL *
    ||A||_F of the top k of the library's f32 torch.linalg.eigh on the
    same operand, which is also the library time."""
    from capital_tpu_torch import Grid, matrix
    from capital_tpu_torch.algs import eigh
    from capital_tpu_torch.ops.precision import default_matmul_precision

    grid = Grid.square(c=1, d=1)
    n, k = PARTIAL_RUN
    a = matrix.symmetric(grid, n, 0, diag_shift=0.0, align=128).data
    cfg = eigh.Config(base_n=EIG_BASE)
    with default_matmul_precision("highest"):
        secs, (w, x), got, rec, peak = counted_call(
            lambda: eigh.eigh_partial(grid, a, k, cfg, which="top"))
    want = stages_want(grid, rec, zero_counts())
    if got != want:
        failures.append(f"eigh_partial: launch counts {got} != {want}")
    tight = cfg.sign_polar_cfg(a.dtype).l0
    probes = sum(1 for kind, _, c in rec if kind == "sign" and c.l0 != tight)
    res, orth = eig_errors_f64(a, w, x)
    keep_ref("eigh_partial", (w, x), got, residual_f64=res,
             orthogonality_f64=orth)
    del x
    scale = float(torch.linalg.norm(a.double()))
    once_ms(lambda: torch.linalg.eigh(a[:1024, :1024]))  # warm up
    lib_ms, (wl, vl) = once_ms(lambda: torch.linalg.eigh(a))
    del vl, a
    w_err = float(torch.max(torch.abs(w.double() - wl[-k:].double())))
    w_err /= scale
    del wl
    torch.cuda.empty_cache()
    for what, v, tol in (("residual_f64", res, EIG_TOL),
                         ("orthogonality_f64", orth, EIG_TOL),
                         ("w_err_vs_library", w_err, EIG_W_TOL)):
        if not v < tol:
            failures.append(f"eigh_partial: {what} {v} not below {tol}")
    out = {"n": n, "k": k, "which": "top", "base_n": EIG_BASE,
           "partial_refine": cfg.partial_refine, "precision": "highest",
           "ms": secs, "library_ms": lib_ms, "vs_library": lib_ms / secs,
           "probes": probes,
           "m": [kk for kind, nn, kk in rec
                 if kind == "split" and nn == n][-1:],
           "residual_f64": res, "orthogonality_f64": orth,
           "w_err_vs_library": w_err, **stage_summary(rec), "launches": got,
           "peak_bytes_above_a": peak, "peak_n2x4": peak / (4 * n * n),
           "card": smi()}
    print(f"[eigh_partial] {json.dumps(out)}", flush=True)
    return out


def spectral_phase(failures: list) -> dict:
    """Every other spectral entry point once at SPECTRAL_N, f32 'highest',
    eigh Config(base_n=EIG_BASE), each against an f64 result on the card
    with its bound printed, and its launch counts against the stages it
    ran: eigvalsh and count_above (exact) of a Wigner-class operand,
    eigh_gen with an SPD B, svd_partial (SPECTRAL_K), singular_values, pinv
    and cond of A = rand + sqrt(n) I, funm_spd (reciprocal), spd_sqrt both
    ways, logm_spd and powm_spd of a shifted Wigner operand (cond ~9)."""
    from capital_tpu_torch import Grid, linalg, matrix
    from capital_tpu_torch.algs import eigh, svd
    from capital_tpu_torch.ops.precision import default_matmul_precision

    grid = Grid.square(c=1, d=1)
    dev = grid.device
    n, k = SPECTRAL_N, SPECTRAL_K
    ecfg = eigh.Config(base_n=EIG_BASE)
    scfg = svd.Config(eig=ecfg)
    bc = scfg.polar.chol.base_dim(grid, n)
    wig = matrix.symmetric(grid, n, 1, diag_shift=0.0, align=128).data
    bmat = matrix.symmetric(grid, n, 2, align=128).data
    radius = 2.0 * (n / 24.0) ** 0.5  # the Wigner part's spectral edge
    spd = matrix.symmetric(grid, n, 3, diag_shift=1.25 * radius,
                           align=128).data
    gen = torch.Generator(device=dev).manual_seed(5)
    gmat = torch.rand((n, n), generator=gen, device=dev) - 0.5
    gmat.diagonal().add_(n**0.5)

    w_wig = torch.linalg.eigvalsh(wig.double())
    mid = 3 * n // 4
    i = mid - 64 + int(torch.argmax(w_wig[mid - 63:mid + 65]
                                    - w_wig[mid - 64:mid + 64]))
    sigma = float(0.5 * (w_wig[i] + w_wig[i + 1]))
    s_g = torch.linalg.svdvals(gmat.double())
    ws, vs = torch.linalg.eigh(spd.double())
    b64 = bmat.double()
    lo = torch.linalg.cholesky(b64)
    c64 = torch.linalg.solve_triangular(
        lo, torch.linalg.solve_triangular(lo, wig.double(), upper=False).T,
        upper=False)
    w_gen = torch.linalg.eigvalsh(0.5 * (c64 + c64.T))
    c_norm = float(torch.linalg.norm(c64))
    del lo, c64

    def fspd(f):
        return (vs * f(ws)[None, :]) @ vs.T

    def rel(got, want):
        return float(torch.linalg.norm(got.double() - want)
                     / torch.linalg.norm(want))

    def vals(got, want, scale):
        return float(torch.max(torch.abs(got.double() - want))) / scale

    def gen_check(out):
        w, x = out
        x64 = x.double()
        bx = b64 @ x64
        g = x64.T @ bx
        g.diagonal().sub_(1.0)
        a64 = wig.double()
        res = float(torch.linalg.norm(a64 @ x64 - bx * w.double()[None, :])
                    / torch.linalg.norm(a64))
        return {"w_err_f64": vals(w, w_gen, c_norm),
                "b_orthogonality_f64": float(torch.linalg.norm(g)) / n**0.5,
                "residual_f64": res}

    def svdp_check(out):
        u, s, v = out
        a64 = gmat.double()
        res = float(torch.linalg.norm(a64 @ v.double() - u.double()
                                      * s.double()[None, :])
                    / torch.linalg.norm(a64))
        return {"s_err_f64": vals(s, s_g[:k], float(s_g[0])),
                "residual_f64": res}

    polar_base = polar_want(n, "2d", scfg.polar, bc)
    gen_base = zero_counts()
    add_cholinv(gen_base, n, bc)
    for case in ("R", "L,trans", "L"):
        add_trmm(gen_base, case)
    bounds = {"w_err_f64": EIG_W_TOL, "s_err_f64": EIG_W_TOL,
              "count_err": 0.5, "rel_err_f64": SPECTRAL_TOL,
              "residual_f64": EIG_TOL, "b_orthogonality_f64": EIG_TOL}
    calls = {
        "eigvalsh": (lambda: eigh.eigvalsh(grid, wig, ecfg), None,
                     lambda w: {"w_err_f64": vals(
                         w, w_wig, float(torch.linalg.norm(wig.double())))}),
        "count_above": (lambda: eigh.count_above(grid, wig, sigma, ecfg),
                        None, lambda c: {"count": c, "count_err": abs(
                            c - (n - i - 1))}),
        "eigh_gen": (lambda: eigh.eigh_gen(grid, wig, bmat, ecfg), gen_base,
                     gen_check),
        "svd_partial": (lambda: svd.svd_partial(grid, gmat, k, scfg,
                                                layout="2d"),
                        polar_base, svdp_check),
        "singular_values": (lambda: svd.singular_values(grid, gmat, scfg,
                                                        layout="2d"),
                            polar_base, lambda s: {"s_err_f64": vals(
                                s, s_g, float(s_g[0]))}),
        "pinv": (lambda: linalg.pinv(grid, gmat, cfg=scfg), polar_base,
                 lambda x: {"rel_err_f64": rel(
                     x, torch.linalg.pinv(gmat.double()))}),
        "cond": (lambda: linalg.cond(grid, gmat, cfg=scfg), polar_base,
                 lambda c: {"rel_err_f64": abs(float(c) - float(
                     s_g[0] / s_g[-1])) / float(s_g[0] / s_g[-1])}),
        "funm_spd": (lambda: linalg.funm_spd(grid, spd, torch.reciprocal,
                                             cfg=ecfg), None,
                     lambda x: {"rel_err_f64": rel(x, fspd(
                         torch.reciprocal))}),
        "spd_sqrt": (lambda: linalg.spd_sqrt(grid, spd, cfg=ecfg), None,
                     lambda x: {"rel_err_f64": rel(x, fspd(torch.sqrt))}),
        "spd_sqrt_inverse": (lambda: linalg.spd_sqrt(grid, spd, cfg=ecfg,
                                                     inverse=True), None,
                             lambda x: {"rel_err_f64": rel(x, fspd(
                                 torch.rsqrt))}),
        "logm_spd": (lambda: linalg.logm_spd(grid, spd, cfg=ecfg), None,
                     lambda x: {"rel_err_f64": rel(x, fspd(torch.log))}),
        "powm_spd": (lambda: linalg.powm_spd(grid, spd, 0.75, cfg=ecfg),
                     None, lambda x: {"rel_err_f64": rel(
                         x, fspd(lambda w: w**0.75))}),
    }
    MESH_REFS["sigma"] = sigma  # count_above's shift, for mesh_spectral
    entries = {}
    for name, (fn, base, check) in calls.items():
        with default_matmul_precision("highest"):
            ms, out, got, rec, _ = counted_call(fn)
        want = zero_counts()
        if base is not None:
            add_counts(want, base)
        stages_want(grid, rec, want)
        entry = {"ms": ms, **check(out), **stage_summary(rec),
                 "launches": got}
        keep_ref(name, out, got, **{key: entry[key] for key in entry
                                    if key in bounds})
        del out
        entry["bounds"] = {key: bounds[key] for key in entry
                           if key in bounds}
        for key, tol in entry["bounds"].items():
            if not entry[key] < tol:
                failures.append(f"spectral {name}: {key} {entry[key]} not "
                                f"below {tol}")
        if got != want:
            failures.append(f"spectral {name}: launch counts {got} != "
                            f"{want}")
        entries[name] = entry
    del wig, bmat, spd, gmat, b64, vs
    torch.cuda.empty_cache()
    out = {"n": n, "k": k, "base_n": EIG_BASE, "precision": "highest",
           "entries": entries, "card": smi()}
    print(f"[spectral] {json.dumps(out)}", flush=True)
    return out


def profiled_busy(fn, name: str) -> dict:
    """The device's busy share of one call of fn: the union of its
    kernels', copies' and fills' intervals (tracing.device_busy_ms) over
    the call's wall time, from a torch.profiler trace that is written to
    chiprun_out/ and removed."""
    from torch.profiler import ProfilerActivity, profile

    from capital_tpu_torch.tracing import device_busy_ms

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del out
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", f"trace_{name}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    busy = device_busy_ms(events)
    launches = sum(1 for e in events if e.get("cat") == "kernel")
    return {"wall_ms": wall_ms, "busy_ms": busy, "busy_share": busy / wall_ms,
            "device_kernels": launches}


@contextlib.contextmanager
def rsvd_cores(rec: list):
    """Record each core B that apps.rsvd hands its thin SVD (harness code
    for the core's accuracy check)."""
    from capital_tpu_torch.apps import rsvd

    core = rsvd._core_svd

    def rec_core(b):
        rec.append(b.detach().clone())
        return core(b)

    rsvd._core_svd = rec_core
    try:
        yield
    finally:
        rsvd._core_svd = core


def rsvd_want(q: int, l: int) -> dict:
    """Launches of one rSVD call: q + 1 CholeskyQR2 factors of the (m, l)
    f32 sketch, each 2 TRMM side='R', 1 side='L', 2 SYRK and 2 Gram
    Choleskys (the leaf kernel where 128 | l <= 1024, else torch.linalg's,
    chol_xla)."""
    want = zero_counts()
    add_trmm(want, "R", 2 * (q + 1))
    add_trmm(want, "L", q + 1)
    want["syrk_upper"] += 2 * (q + 1)
    leaf = l % 128 == 0 and l <= 1024
    want["chol_inv" if leaf else "chol_xla"] += 2 * (q + 1)
    return want


def svd_errors_f64(a: torch.Tensor, u: torch.Tensor, s: torch.Tensor,
                   vt: torch.Tensor, rows: int = 1 << 16):
    """(||U^T U - I||_F, ||A V^T - U diag(s)||_F / ||A||_F) in f64
    products, row chunk by row chunk."""
    k = u.shape[1]
    g = torch.zeros((k, k), dtype=torch.float64, device=u.device)
    v64, s64 = vt.double().T, s.double()
    d2 = a2 = 0.0
    for i in range(0, a.shape[0], rows):
        uc, ac = u[i:i + rows].double(), a[i:i + rows].double()
        g.addmm_(uc.T, uc)
        d2 += float(torch.sum((ac @ v64 - uc * s64) ** 2))
        a2 += float(torch.sum(ac ** 2))
    g.diagonal().sub_(1.0)
    return float(torch.linalg.norm(g)), (d2 / a2) ** 0.5


def core_errors(b: torch.Tensor) -> dict:
    """The card's f32 thin SVD of the rSVD core B and the port's own
    _core_svd (f64, rounded back: F8), each timed (best of two) and held to
    an f64 SVD of the same B: ||U_s^T U_s - I||_F and ||V^T V - I||_F in
    f64, and the largest singular-value error over s_max."""
    from capital_tpu_torch.apps import rsvd

    s64 = torch.linalg.svdvals(b.double())

    def errs(fn):
        ms = min(once_ms(fn)[0] for _ in range(2))
        us, s, vt = (x.double() for x in fn())
        gu = us.T @ us
        gv = vt @ vt.T
        gu.diagonal().sub_(1.0)
        gv.diagonal().sub_(1.0)
        return {"ms": ms, "u_orth_f64": float(torch.linalg.norm(gu)),
                "vt_orth_f64": float(torch.linalg.norm(gv)),
                "s_err_f64": float(torch.max(torch.abs(s - s64)) / s64[0])}

    return {"shape": list(b.shape),
            "f32_svd": errs(lambda: torch.linalg.svd(
                b.float(), full_matrices=False)),
            "port_core_svd": errs(lambda: rsvd._core_svd(b))}


def rsvd_path(name: str, failures: list) -> dict:
    """apps.rsvd of bench.rsvd's planted operand (RSVD_RUNS[name]) at
    'highest', two calls (the first counted, its peak and its core B
    taken), one profiled for the busy share. Bounds: singular values within
    RSVD_SV_TOL of the planted ones, ||U^T U - I||_F below RSVD_ORTH_TOL
    and the subspace residual below RSVD_RES_TOL (bf16 storage:
    RSVD_RES_TOL_BF16) in f64 products. The library call (f32 only) is
    torch.svd_lowrank(A, q=l, niter=q)."""
    from capital_tpu_torch import Grid
    from capital_tpu_torch.apps import rsvd
    from capital_tpu_torch.bench.rsvd import _planted
    from capital_tpu_torch.ops.precision import default_matmul_precision

    m, n, k, over, q, dtype = RSVD_RUNS[name]
    l = k + over
    grid = Grid.square(c=1, d=1)
    with default_matmul_precision("highest"):
        a, s_true = _planted(grid, m, n, k, getattr(torch, dtype), 0)
    cfg = rsvd.Config(k=k, oversample=over, power_iters=q)
    cores: list = []

    def run():
        return rsvd.rsvd(grid, a, cfg)

    with default_matmul_precision("highest"):
        with rsvd_cores(cores):
            secs, (u, s, vt), got, _, peak = counted_call(run)
        del u, s, vt
        secs2, (u, s, vt) = once_ms(run)
        busy = profiled_busy(run, name)
    want = rsvd_want(q, l)
    if got != want:
        failures.append(f"{name}: launch counts {got} != {want}")
    sv_err = float(torch.max(torch.abs(s - s_true) / s_true))
    orth, res = svd_errors_f64(a, u, s, vt)
    if dtype == "float32":
        keep_ref(name, (u, s, vt), got, sv_rel_err=sv_err,
                 orthogonality_f64=orth, subspace_residual_f64=res)
    del u, s, vt
    core = core_errors(cores[0])
    del cores
    res_tol = RSVD_RES_TOL if dtype == "float32" else RSVD_RES_TOL_BF16
    for what, x, tol in (("sv_rel_err", sv_err, RSVD_SV_TOL),
                         ("orthogonality_f64", orth, RSVD_ORTH_TOL),
                         ("subspace_residual_f64", res, res_tol)):
        if not x < tol:  # also fails on NaN
            failures.append(f"{name}: {what} {x} not below {tol}")
    best_ms = min(secs, secs2)
    rec = {"m": m, "n": n, "k": k, "l": l, "power_iters": q, "dtype": dtype,
           "precision": "highest", "ms": [secs, secs2],
           "gflops": (2.0 * m * n * l * (2 * q + 2)
                      + (q + 1) * 8.0 * m * l * l) / best_ms / 1e6,
           "sv_rel_err": sv_err, "orthogonality_f64": orth,
           "subspace_residual_f64": res,
           "bounds": {"sv_rel_err": RSVD_SV_TOL,
                      "orthogonality_f64": RSVD_ORTH_TOL,
                      "subspace_residual_f64": res_tol},
           "core": core, "launches": got, "peak_bytes_above_a": peak,
           "operand_bytes": a.numel() * a.element_size(), **busy}
    if dtype == "float32":
        once_ms(lambda: torch.svd_lowrank(a[:4096], q=l, niter=q))
        lib_ms, out = once_ms(lambda: torch.svd_lowrank(a, q=l, niter=q))
        del out
        rec.update(library_ms=lib_ms, vs_library=lib_ms / best_ms)
    else:
        rec.update(library_ms=None, vs_library=None)
    del a
    torch.cuda.empty_cache()
    rec["card"] = smi()
    print(f"[{name}] {json.dumps(rec)}", flush=True)
    return rec


def pca_path(failures: list) -> dict:
    """apps.pca of a planted rank-k (bench.rsvd's generator) PCA_RUN
    operand plus a column mean of N(0, 1) entries, f32 'highest', k
    components, oversample 8, one power iteration, two calls (the first
    counted, its peak taken), one profiled. The
    explained variance must lie within PCA_TOL (relative) of the top k
    eigenvalues of the f64 covariance on the card, the mean within 1e-6
    of the f64 mean, the components orthonormal within RSVD_ORTH_TOL."""
    from capital_tpu_torch import Grid
    from capital_tpu_torch.apps import rsvd
    from capital_tpu_torch.bench.rsvd import _planted
    from capital_tpu_torch.ops.precision import default_matmul_precision

    m, n, k = PCA_RUN
    grid = Grid.square(c=1, d=1)
    gen = torch.Generator(device=grid.device).manual_seed(6)
    with default_matmul_precision("highest"):
        a, _ = _planted(grid, m, n, k, torch.float32, 1)
    a += torch.randn((n,), generator=gen, device=grid.device)
    cfg = rsvd.Config(k=k, oversample=8, power_iters=1)
    with default_matmul_precision("highest"):
        secs, (comps, var, mean), got, _, peak = counted_call(
            lambda: rsvd.pca(grid, a, cfg))
        secs2, _ = once_ms(lambda: rsvd.pca(grid, a, cfg))
        busy = profiled_busy(lambda: rsvd.pca(grid, a, cfg), "pca")
    want = rsvd_want(1, k + 8)
    if got != want:
        failures.append(f"pca: launch counts {got} != {want}")
    x64 = a.double()
    mean64 = x64.mean(0)
    x64 -= mean64
    w64 = torch.linalg.eigvalsh(x64.T @ x64 / (m - 1)).flip(0)[:k]
    del x64
    var_err = float(torch.max(torch.abs(var.double() - w64) / w64))
    mean_err = float(torch.max(torch.abs(mean.double() - mean64)))
    c64 = comps.double()
    g = c64 @ c64.T
    g.diagonal().sub_(1.0)
    orth = float(torch.linalg.norm(g))
    for what, x, tol in (("variance_rel_err_f64", var_err, PCA_TOL),
                         ("mean_err_f64", mean_err, 1e-6),
                         ("components_orthogonality_f64", orth,
                          RSVD_ORTH_TOL)):
        if not x < tol:
            failures.append(f"pca: {what} {x} not below {tol}")
    keep_ref("pca", (comps, var, mean), got, variance_rel_err_f64=var_err,
             mean_err_f64=mean_err, components_orthogonality_f64=orth)
    rec = {"m": m, "n": n, "k": k, "precision": "highest",
           "ms": [secs, secs2], "variance_rel_err_f64": var_err,
           "mean_err_f64": mean_err, "components_orthogonality_f64": orth,
           "launches": got, "peak_bytes_above_a": peak, **busy,
           "card": smi()}
    del a, comps, var, mean
    torch.cuda.empty_cache()
    print(f"[pca] {json.dumps(rec)}", flush=True)
    return rec


def als_path(sparse: bool, failures: list) -> dict:
    """apps.als.fit (ALS_RUN, synthetic_ratings with planted rank 16) or
    fit_sparse (ALS_SPARSE_RUN, synthetic_regular), f32 'highest', lam
    ALS_LAM, data from seed 0, two calls (the first counted, its peak
    above the data taken), one profiled. RMSE below ALS_RMSE; no kernel
    and no fallback runs (the solves are the library's batched Cholesky)."""
    from capital_tpu_torch import Grid
    from capital_tpu_torch.apps import als
    from capital_tpu_torch.ops.precision import default_matmul_precision

    grid = Grid.square(c=1, d=1)
    name = "als_sparse" if sparse else "als"
    with default_matmul_precision("highest"):
        if sparse:
            users, items, k, obs, iters = ALS_SPARSE_RUN
            gen_ms, data = once_ms(lambda: als.synthetic_regular(
                grid, users, items, obs, 0))
            cfg = als.Config(rank=k, lam=ALS_LAM, num_iters=iters)

            def run():
                return als.fit_sparse(grid, data, cfg, items=items)

            nnz = users * obs
            flops = iters * (4.0 * nnz * k**2 + (users + items) * k**3 / 3)
            shape = {"users": users, "items": items, "rank": k, "nnz": nnz}
        else:
            users, items, k, density, iters = ALS_RUN
            gen_ms, (r, m) = once_ms(lambda: als.synthetic_ratings(
                grid, users, items, 0, rank=16, density=density))
            cfg = als.Config(rank=k, lam=ALS_LAM, num_iters=iters)

            def run():
                return als.fit(grid, r, m, cfg)

            flops = iters * (4.0 * users * items * k**2
                             + (users + items) * k**3 / 3)
            shape = {"users": users, "items": items, "rank": k,
                     "density": density, "observed": float(m.sum())}
        secs, (u, v, err), got, _, peak = counted_call(run)
        keep_ref(name, (u, v, err), got, rmse=float(err))
        del u, v
        secs2, _ = once_ms(run)
        busy = profiled_busy(run, name)
    err = float(err)
    want = zero_counts()
    if got != want:
        failures.append(f"{name}: launch counts {got} != {want}")
    if not err < ALS_RMSE:
        failures.append(f"{name}: rmse {err} not below {ALS_RMSE}")
    best_ms = min(secs, secs2)
    rec = {**shape, "iters": iters, "lam": ALS_LAM, "precision": "highest",
           "generate_ms": gen_ms, "ms": [secs, secs2],
           "gflops": flops / best_ms / 1e6, "rmse": err, "bound": ALS_RMSE,
           "launches": got, "peak_bytes_above_data": peak, **busy,
           "card": smi()}
    print(f"[{name}] {json.dumps(rec)}", flush=True)
    del run
    torch.cuda.empty_cache()
    return rec


def io_phase(failures: list) -> dict:
    """io.save_factor / load_factor of the R of cholinv.factor (n = IO_N,
    f32 'highest') taken from the card, and io.save_sharded / load_sharded
    of it, both into chiprun_out/ and removed after: each round trip must
    be bitwise. The packed file's bytes and the native library's use are
    reported."""
    import shutil

    from capital_tpu_torch import Grid, io, matrix, native
    from capital_tpu_torch.algs import cholinv

    grid = Grid.square(c=1, d=1)
    a = matrix.symmetric(grid, IO_N, 4, align=128)
    r, _ = cholinv.factor(grid, a, cholinv.Config())
    r = torch.triu(r)
    work = os.path.join("chiprun_out", "io_phase")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "factor.npz")
    t0 = time.perf_counter()
    io.save_factor(path, r, upper=True, meta={"seed": 4})
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back, meta = io.load_factor(path)
    load_ms = (time.perf_counter() - t0) * 1e3
    npz_equal = torch.equal(torch.from_numpy(back).to(r.device), r)
    file_bytes = os.path.getsize(path)
    ckpt = os.path.join(work, "ckpt")
    t0 = time.perf_counter()
    io.save_sharded(ckpt, {"r": r, "step": torch.tensor(7)})
    out = io.load_sharded(ckpt, {"r": torch.zeros_like(r),
                                 "step": torch.tensor(0)})
    dcp_ms = (time.perf_counter() - t0) * 1e3
    dcp_equal = torch.equal(out["r"], r) and int(out["step"]) == 7
    shutil.rmtree(work)
    for what, ok in (("npz round trip", npz_equal),
                     ("seed metadata", int(meta["seed"]) == 4),
                     ("save_sharded round trip", dcp_equal)):
        if not ok:
            failures.append(f"io: {what} is not bitwise")
    rec = {"n": IO_N, "native_available": native.available(),
           "save_factor_ms": save_ms, "load_factor_ms": load_ms,
           "npz_bitwise": npz_equal, "npz_bytes": file_bytes,
           "dense_bytes": 4 * IO_N * IO_N, "sharded_round_trip_ms": dcp_ms,
           "sharded_bitwise": dcp_equal}
    del a, r, out
    torch.cuda.empty_cache()
    print(f"[io] {json.dumps(rec)}", flush=True)
    return rec


def autotune_phase(failures: list) -> dict:
    """tune.main for each alg of AUTOTUNE_ALGS at its defaults, the tables
    under chiprun_out/autotune/. A candidate error fails the phase: the
    JAX tuner's one-device default spaces hold only configs valid for
    these shapes, so it records none. Each alg's sweep must launch every
    kernel its path reaches."""
    from capital_tpu_torch.autotune import tune
    from capital_tpu_torch.ops import counters, reset_counters

    work = os.path.join("chiprun_out", "autotune")
    os.makedirs(work, exist_ok=True)
    out = {}
    for alg, kernels in AUTOTUNE_ALGS.items():
        reset_counters()
        t0 = time.perf_counter()
        cands = tune.main(["--alg", alg, "--prefix",
                           os.path.join(work, f"autotune_torch_{alg}")])
        secs = time.perf_counter() - t0
        got = counters()
        errors = [c.error for c in cands if c.error]
        best = tune.best(cands)
        for err in errors:
            failures.append(f"autotune {alg}: candidate error {err}")
        for k in kernels:
            if not got[k]:
                failures.append(f"autotune {alg}: {k} never launched")
        out[alg] = {"candidates": len(cands), "errors": len(errors),
                    "best": best.params, "best_time_s": best.time_s,
                    "best_model_s": best.model_time_s,
                    "best_costs": best.costs, "seconds": secs,
                    "launches": got,
                    "records": [c.record() for c in cands]}
        print(f"[autotune] {alg}: best {json.dumps(best.params)} "
              f"{best.time_s * 1e3:.3f} ms (model "
              f"{best.model_time_s * 1e3:.3f} ms), {len(cands)} candidates, "
              f"{len(errors)} errors, {secs:.1f} s", flush=True)
        torch.cuda.empty_cache()

    reset_counters()
    t0 = time.perf_counter()
    cands = tune.main(["--alg", "cholinv", "--grid", "sweep", "--n",
                       str(AUTOTUNE_GRID_N), "--prefix",
                       os.path.join(work, "autotune_torch_cholinv_grid")])
    secs = time.perf_counter() - t0
    got = counters()
    errors = [c.error for c in cands if c.error]
    for err in errors:
        failures.append(f"autotune grid sweep: candidate error {err}")
    untagged = [c.params for c in cands
                if not {"grid", "devices"} <= set(c.params)]
    if not cands or untagged:
        failures.append(f"autotune grid sweep: candidates without the grid "
                        f"columns {untagged}")
    for k in AUTOTUNE_ALGS["cholinv"]:
        if not got[k]:
            failures.append(f"autotune grid sweep: {k} never launched")
    best = tune.best(cands) if cands else None
    grids = sorted({c.params.get("grid") for c in cands})
    out["cholinv_grid"] = {
        "n": AUTOTUNE_GRID_N, "cards": torch.cuda.device_count(),
        "grids": grids, "candidates": len(cands), "errors": len(errors),
        "best": best.params if best else None,
        "best_time_s": best.time_s if best else None,
        "seconds": secs, "launches": got,
        "records": [c.record() for c in cands]}
    print(f"[autotune] cholinv grid sweep: grids {grids}, best "
          f"{json.dumps(best.params if best else None)} "
          f"{(best.time_s if best else float('nan')) * 1e3:.3f} ms, "
          f"{len(cands)} candidates, {len(errors)} errors, {secs:.1f} s",
          flush=True)
    return out


def hybrid_phase(failures: list) -> dict:
    """cacqr.factor_hybrid on the one-device rect grid at HYBRID_SHAPE,
    f32 'highest', the two-stage Gram policy; two calls, then
    cacqr.factor_1d on the same operand. A factor runs two sweeps, each a
    SYRK Gram, the recursive cholinv of the 1024^2 Gram on the square view
    (base case 512) and a TRMM side='R', and one TRMM side='L' to merge.
    Orthogonality and residual below 1e-5, by the kernels and in f64."""
    from capital_tpu_torch import Grid, matrix, validate
    from capital_tpu_torch.algs import cacqr, cholinv
    from capital_tpu_torch.ops import counters, reset_counters
    from capital_tpu_torch.ops.precision import default_matmul_precision

    m, n = HYBRID_SHAPE
    grid = Grid.rect(c=1)
    cfg = cacqr.Config(gram_policy="two_stage")
    a = matrix.tall_skinny(grid, m, n, 0).data
    with default_matmul_precision("highest"):
        reset_counters()
        secs, (q, r) = once_ms(lambda: cacqr.factor_hybrid(grid, a, cfg))
        got = counters()
        del q, r
        secs2, (q, r) = once_ms(lambda: cacqr.factor_hybrid(grid, a, cfg))
        one = [once_ms(lambda: cacqr.factor_1d(grid, a, cfg))[0]
               for _ in range(2)]
    want = zero_counts()
    add_cholinv(want, n, cholinv.Config().base_dim(grid, n), times=2)
    want["syrk_upper"] += 2
    add_trmm(want, "R", 2)
    add_trmm(want, "L", 1)
    if got != want:
        failures.append(f"hybrid: launch counts {got} != {want}")
    orth = float(validate.qr_orthogonality(grid, q))
    res = float(validate.qr_residual(grid, a, q, r))
    orth64, res64 = qr_errors_f64(a, q, r)
    del q, r, a
    for what, x in (("orthogonality", orth), ("residual", res),
                    ("orthogonality_f64", orth64), ("residual_f64", res64)):
        if not x < QR_TOL:  # also fails on NaN
            failures.append(f"hybrid: {what} {x} not below {QR_TOL}")
    torch.cuda.empty_cache()
    rec = {"m": m, "n": n, "precision": "highest", "ms": [secs, secs2],
           "factor_1d_ms": one, "orthogonality": orth, "residual": res,
           "orthogonality_f64": orth64, "residual_f64": res64,
           "launches": got}
    print(f"[hybrid] {json.dumps(rec)}", flush=True)
    return rec


def cyclic_phase(failures: list) -> dict:
    """cholinv_cyclic.factor at CYCLIC_RUN, f32 'highest': the window
    products are plain products, so the Cholesky leaf runs alone, once a
    512-row leaf (16 at n = 8192); two calls, then cholinv.factor on the
    same operand. Residuals below 1e-5."""
    from capital_tpu_torch import Grid, matrix, validate
    from capital_tpu_torch.algs import cholinv, cholinv_cyclic
    from capital_tpu_torch.ops import counters, reset_counters
    from capital_tpu_torch.ops.precision import default_matmul_precision

    n, bc = CYCLIC_RUN
    grid = Grid.square(c=1, d=1)
    cfg = cholinv.Config(min_bc=bc)
    a = matrix.symmetric(grid, n, 0, align=128).data
    with default_matmul_precision("highest"):
        reset_counters()
        secs, (r, ri) = once_ms(lambda: cholinv_cyclic.factor(grid, a, cfg))
        got = counters()
        del r, ri
        secs2, (r, ri) = once_ms(lambda: cholinv_cyclic.factor(grid, a, cfg))
        block = [once_ms(lambda: cholinv.factor(grid, a, cfg))[0]
                 for _ in range(2)]
    want = zero_counts()
    want["chol_inv"] = tree(n, bc)[0]
    if got != want:
        failures.append(f"cyclic: launch counts {got} != {want}")
    inv = float(validate.inverse_residual(grid, r, ri, chunks=8))
    res = float(validate.cholesky_residual(grid, a, r, chunks=8))
    keep_ref("cyclic", (r, ri), got, residual=res, inv_residual=inv)
    del r, ri, a
    if not (res < 1e-5 and inv < 1e-5):  # also fails on NaN
        failures.append(f"cyclic: residual {res} / inverse residual {inv} "
                        "not below 1e-5")
    torch.cuda.empty_cache()
    rec = {"n": n, "bc": bc, "precision": "highest", "ms": [secs, secs2],
           "cholinv_factor_ms": block, "residual": res,
           "inv_residual": inv, "launches": got}
    print(f"[cyclic] {json.dumps(rec)}", flush=True)
    return rec


def drivers_phase(failures: list) -> dict:
    """bench.summa_gemm at its default 8192^3, 'highest' (tile_rel_err
    below 1e-5, no kernel); bench.scaling --alg cholinv (n = 1024, base
    case 128 on torch.linalg's leaf, as the JAX driver's config: TRMM and
    SYRK each inner node, two calls); entry()'s step (one Cholesky leaf,
    residuals below 1e-5); the four examples, each asserting its own
    bounds and launching the kernels EXAMPLE_KERNELS lists."""
    import importlib

    from capital_tpu_torch import Grid, validate
    from capital_tpu_torch.bench import scaling, summa_gemm
    from capital_tpu_torch.entry import entry
    from capital_tpu_torch.ops import counters, reset_counters

    out = {}
    reset_counters()
    rec = summa_gemm.main(["--json"])
    got = counters()
    if got != zero_counts():
        failures.append(f"summa_gemm: launch counts {got}")
    if not rec.get("tile_rel_err", 1.0) < SUMMA_GEMM_TOL:
        failures.append(f"summa_gemm: tile_rel_err {rec.get('tile_rel_err')}"
                        f" not below {SUMMA_GEMM_TOL}")
    out["summa_gemm"] = {**rec, "launches": got}

    reset_counters()
    (row,) = scaling.main(["--alg", "cholinv"])
    got = counters()
    leaves, inner = tree(1024, 128)
    want = zero_counts()
    for case in ("L", "L,trans", "R"):
        add_trmm(want, case, 2 * inner)
    want["syrk_upper"] = 2 * inner
    want["chol_xla"] = 2 * leaves
    if got != want:
        failures.append(f"scaling: launch counts {got} != {want}")
    out["scaling"] = {**row, "launches": got}

    cards = torch.cuda.device_count()
    reset_counters()
    rows = scaling.main(["--alg", "cholinv", "--devices", str(cards)])
    got = counters()
    shapes = [[c, d, d] for c, d in scaling.SHAPES if c * d * d <= cards]
    if [r["grid"] for r in rows] != shapes:
        failures.append(f"scaling --devices {cards}: grids "
                        f"{[r['grid'] for r in rows]} != {shapes}")
    if cards == 1 and got != want:
        failures.append(f"scaling --devices 1: launch counts {got} != "
                        f"{want}")
    out["scaling_devices"] = {"devices": cards, "rows": rows,
                              "launches": got}

    fn, (a,) = entry()
    reset_counters()
    ms, (r, ri) = once_ms(lambda: fn(a))
    got = counters()
    grid = Grid.square()
    res = float(validate.cholesky_residual(grid, a, r))
    inv = float(validate.inverse_residual(grid, r, ri))
    want = zero_counts()
    want["chol_inv"] = 1
    if got != want:
        failures.append(f"entry: launch counts {got} != {want}")
    if not (res < 1e-5 and inv < 1e-5):
        failures.append(f"entry: residual {res} / inverse residual {inv} "
                        "not below 1e-5")
    out["entry"] = {"n": a.shape[0], "ms": ms, "residual": res,
                    "inv_residual": inv, "launches": got}
    del a, r, ri

    from capital_tpu_torch.examples import bounds_held

    for name, kernels in EXAMPLE_KERNELS.items():
        mod = importlib.import_module(f"capital_tpu_torch.examples.{name}")
        reset_counters()
        t0 = time.perf_counter()
        try:
            figs = mod.main()
        except AssertionError as exc:  # the example's own check
            failures.append(f"example {name}: bound failed: {exc}")
            figs = {}
        got = counters()
        held = bounds_held(figs)
        if figs and not held:
            failures.append(f"example {name}: no bound returned")
        for what, value, bound, ok in held:
            if not ok:
                failures.append(f"example {name}: {what} {value} against "
                                f"{bound}")
        for k in kernels:
            if not got[k]:
                failures.append(f"example {name}: {k} never launched")
        out[name] = {k: (v.tolist() if hasattr(v, "tolist") else v)
                     for k, v in figs.items()}
        out[name].update(seconds=time.perf_counter() - t0, launches=got)
        torch.cuda.empty_cache()
    for name, rec in out.items():
        print(f"[drivers] {name} {json.dumps(rec)}", flush=True)
    return out


def mesh_rank(lstsq_library: dict, refs: dict) -> dict:
    """One rank of the [mesh] world (see the module docstring): every
    call on the world's grids, each against the one-device call of the
    same operand on this rank's card. Returns the rank's records and its
    failures."""
    import torch.distributed as dist

    from capital_tpu_torch import Grid, matrix, validate
    from capital_tpu_torch.algs import cacqr, cholinv
    from capital_tpu_torch.ops import counters, reset_counters
    from capital_tpu_torch.ops.precision import default_matmul_precision
    from capital_tpu_torch.ops.precision import dot as pdot
    from capital_tpu_torch.parallel import darray, summa

    from capital_tpu_torch.parallel.launch import world_device

    world, fails = dist.get_world_size(), []
    one = world == 1  # then every result must equal the one-device one
    dev = world_device()
    local = Grid.square(device=dev)
    out = {"rank": dist.get_rank(), "world": world,
           "backend": dist.get_backend(), "launches": zero_counts()}

    def same(what, got, want, tol=TOL, bitwise_on_one=False):
        """got against want: within tol (relative Frobenius), and bit for
        bit on one rank when bitwise_on_one."""
        got, want = darray.to_global(got), darray.to_global(want)
        rel, _ = compare(got, want)
        bitwise = bool(torch.equal(got, want))
        if not rel < tol or (one and bitwise_on_one and not bitwise):
            fails.append(f"mesh {what}: rel {rel}, bitwise {bitwise}")
        return {"rel": rel, "bitwise": bitwise}

    def counted(what, fn, want):
        reset_counters()
        ms, res = once_ms(fn)
        got = counters()
        add_counts(out["launches"], got)
        if one and got != want:
            fails.append(f"mesh {what}: launch counts {got} != {want}")
        return ms, res

    # cholinv at the headline cell, each placement and engine
    n, level = MESH_CHOL
    sq = Grid.square(c=1)
    a = matrix.symmetric(sq, n, 0, align=128)
    a_whole = darray.whole(a.data)
    bc = cholinv.Config().base_dim(sq, n)
    want = zero_counts()
    add_cholinv(want, n, bc)
    rows = {}
    with default_matmul_precision(level):
        ref_ms, (rr, rri) = once_ms(lambda: cholinv.factor(
            local, a_whole, cholinv.Config()))
        for pol in MESH_POLICIES:
            for impl in MESH_IMPLS:
                cfg = cholinv.Config(base_policy=pol, summa_impl=impl)
                ms, (r, ri) = counted(f"cholinv {pol} {impl}",
                                      lambda: cholinv.factor(sq, a, cfg),
                                      want)
                rows[f"{pol} {impl}"] = {"ms": ms, **same(
                    f"cholinv {pol} {impl} R", r, rr, bitwise_on_one=True)}
                same(f"cholinv {pol} {impl} Rinv", ri, rri,
                     bitwise_on_one=True)
                del r, ri
    res = float(validate.cholesky_residual(local, a_whole, rr, chunks=8,
                                           masked=True))
    inv = float(validate.inverse_residual(local, rr, rri, chunks=8,
                                          masked=True))
    if not (res < 1e-5 and inv < 1e-5):
        fails.append(f"mesh cholinv: residuals {res} / {inv}")
    del rr, rri, a, a_whole
    torch.cuda.empty_cache()
    out["cholinv"] = {"n": n, "precision": level, "grid": sq.shape,
                      "one_device_ms": ref_ms, "runs": rows,
                      "residual": res, "inv_residual": inv}

    # CholeskyQR2, 1D, the SYRK Gram, each policy
    m, nq, level = MESH_QR
    rect = Grid.rect(c=1)
    a = matrix.tall_skinny(rect, m, nq, 0)
    a_whole = darray.whole(a.data)
    want = zero_counts()
    want.update(syrk_upper=2, trmm_upper=3, chol_inv=2)
    want["trmm_upper_by_case"].update(R=2, L=1)
    rows = {}
    with default_matmul_precision(level):
        ref_ms, (rq, rr) = once_ms(lambda: cacqr.factor_1d(
            local, a_whole, cacqr.Config(gram_kernel="tri")))
        for pol in ("allreduce", "two_stage", "packed"):
            cfg = cacqr.Config(gram_kernel="tri", gram_policy=pol)
            ms, (q, r) = counted(f"factor_1d {pol}",
                                 lambda: cacqr.factor_1d(rect, a, cfg), want)
            del q, r  # a second call: the first starts NCCL's collectives
            ms2, (q, r) = once_ms(lambda: cacqr.factor_1d(rect, a, cfg))
            rows[pol] = {"ms": [ms, ms2], **same(f"factor_1d {pol} Q", q, rq,
                                                 bitwise_on_one=True)}
            same(f"factor_1d {pol} R", r, rr, bitwise_on_one=True)
            if pol == "allreduce":
                orth = float(validate.qr_orthogonality(rect, q))
                resq = float(validate.qr_residual(rect, a.data, q, r))
            del q, r
    orth64, res64 = qr_errors_f64(a_whole, rq, rr)
    for what, x in (("orthogonality", orth), ("residual", resq),
                    ("orthogonality_f64", orth64), ("residual_f64", res64)):
        if not x < QR_TOL:
            fails.append(f"mesh factor_1d: {what} {x}")
    out["factor_1d"] = {"m": m, "n": nq, "precision": level,
                        "grid": rect.shape, "one_device_ms": ref_ms,
                        "runs": rows, "orthogonality": orth,
                        "residual": resq, "orthogonality_f64": orth64,
                        "residual_f64": res64}

    # factor_hybrid on the same operand, factor_3d at MESH_3D
    with default_matmul_precision(level):
        cfg = cacqr.Config(gram_policy="two_stage")
        ref_ms, (hq, hr) = once_ms(lambda: cacqr.factor_hybrid(
            local, a_whole, cfg))
        want = zero_counts()
        zx = rect.view(z=None, y="z", x="x")  # the Gram's square view
        add_cholinv(want, nq, cacqr.Config().chol.base_dim(zx, nq), 2)
        want["syrk_upper"] += 2
        add_trmm(want, "R", 2)
        add_trmm(want, "L", 1)
        ms, (q, r) = counted("factor_hybrid",
                             lambda: cacqr.factor_hybrid(rect, a, cfg), want)
        out["factor_hybrid"] = {"m": m, "n": nq, "ms": ms,
                                "one_device_ms": ref_ms,
                                **same("factor_hybrid Q", q, hq)}
        same("factor_hybrid R", r, hr)
        del q, r, hq, hr, a, a_whole, rq, rr
        torch.cuda.empty_cache()
        m3, n3, _ = MESH_3D
        b = matrix.tall_skinny(sq, m3, n3, 1)
        b_whole = darray.whole(b.data)
        ref_ms, (tq, tr) = once_ms(lambda: cacqr.factor_3d(
            local, b_whole, cacqr.Config()))
        want = zero_counts()
        add_cholinv(want, n3, cacqr.Config().chol.base_dim(sq, n3), 2)
        want["syrk_upper"] += 2
        add_trmm(want, "R", 2)
        add_trmm(want, "L", 1)
        ms, (q, r) = counted("factor_3d",
                             lambda: cacqr.factor_3d(sq, b, cacqr.Config()),
                             want)
        out["factor_3d"] = {"m": m3, "n": n3, "ms": ms,
                            "one_device_ms": ref_ms,
                            **same("factor_3d Q", q, tq)}
        same("factor_3d R", r, tr)
        del q, r, tq, tr, b, b_whole
        torch.cuda.empty_cache()

    # the SUMMA engines against a plain product
    ng = MESH_GEMM
    x = matrix.rand(sq, ng, ng, 2).data
    y = matrix.rand(sq, ng, ng, 3).data
    gemms = {}
    with default_matmul_precision("highest"):
        plain = pdot(darray.whole(x), darray.whole(y))
        for name, kw in (("shard_map", dict(impl="shard_map", num_chunks=4,
                                            collect_chunks=2)),
                         ("ring", dict(impl="ring"))):
            ms, c = counted(f"gemm {name}",
                            lambda: summa.gemm(sq, x, y, **kw), zero_counts())
            del c
            ms2, c = once_ms(lambda: summa.gemm(sq, x, y, **kw))
            gemms[name] = {"ms": [ms, ms2], **same(f"gemm {name}", c, plain,
                                                   SUMMA_GEMM_TOL)}
            del c
    out["gemm"] = {"n": ng, "precision": "highest", "runs": gemms}
    del x, y, plain
    torch.cuda.empty_cache()
    mesh_solvers(out, fails, same, counted, local, lstsq_library)
    mesh_spectral(out, fails, local, refs)
    out["failures"] = fails
    return out


def mesh_solvers(out: dict, fails: list, same, counted, local,
                 lstsq_library: dict) -> None:
    """[mesh]'s solver layer on the world's grids, each call against the
    one-device call of the same operand (bitwise on one rank), with its
    call tree's launches and the one-device phases' residual bounds: LU
    at each of LU_RUNS (the second with lookahead and a refined solve),
    polar in each of POLAR_LAYOUTS, spd_solve at SPD_RUN, lstsq at
    LSTSQ_RUN by each method (normal residual at most LSTSQ_VS_LIBRARY x
    the [lstsq] phase's library residual), and trsm, rectri and Newton at
    MESH_TRI."""
    from unittest import mock

    from capital_tpu_torch import Grid, linalg, matrix
    from capital_tpu_torch.algs import cacqr, cholinv, lu, newton, polar
    from capital_tpu_torch.algs import rectri, trsm
    from capital_tpu_torch.bench import solve as bsolve
    from capital_tpu_torch.bench.lu import residual as lu_residual
    from capital_tpu_torch.ops.precision import default_matmul_precision
    from capital_tpu_torch.parallel import darray, summa

    sq, rect = Grid.square(c=1), Grid.rect(c=1)
    dev = local.device

    def both(what, fn, want, grid=sq):
        """(record, world result): fn(grid, unwrap) on the one-device
        grid, then counted on the world grid; each output held against
        the one-device one (bitwise on one rank)."""
        ref_ms, ref = once_ms(lambda: fn(local, darray.whole))
        ms, got = counted(what, lambda: fn(grid, lambda x: x), want)
        rels, bits = [], []
        for i, (g, r) in enumerate(zip(_outs(got), _outs(ref))):
            if isinstance(r, torch.Tensor) and r.is_floating_point():
                rec = same(f"{what} [{i}]", g, r, bitwise_on_one=True)
                rels.append(rec["rel"])
                bits.append(rec["bitwise"])
                continue
            eq = (torch.equal(g, r) if isinstance(r, torch.Tensor)
                  else g == r)
            if not eq:
                fails.append(f"mesh {what} [{i}]: {g} != {r}")
            bits.append(bool(eq))
        return {"ms": ms, "one_device_ms": ref_ms, "rel": rels,
                "bitwise": bits}, got

    # LU, each of LU_RUNS
    recs = []
    for n, nb, lookahead, k_rhs in LU_RUNS:
        gen = torch.Generator(device=dev).manual_seed(0)
        a = torch.randn((n, n), generator=gen, device=dev)
        ad = darray.distribute(a, sq.mesh, sq.slice_spec)
        cfg = lu.Config(nb=nb)
        nbp = cfg.panel(local, n)
        leaves = (n // nbp) * lu.leaves(nbp, lu.leaf_width(True))
        want = zero_counts()
        want["getrf_leaf"] = leaves
        want["getrf_leaf_by_route"]["resident"] = leaves
        env = {"CAPITAL_LU_LOOKAHEAD": "1" if lookahead else "0"}
        with mock.patch.dict(os.environ, env), \
                default_matmul_precision("highest"):
            rec, (w, perm, _) = both(
                f"LU n={n}", lambda g, un: lu.factor(
                    g, ad if g is sq else a, cfg), want)
            wg = darray.to_global(w)
            rec.update(n=n, nb=nb, lookahead=lookahead, leaves=leaves,
                       residual=lu_residual(local, wg, perm, a))
            del wg
            if not rec["residual"] < LU_TOL:
                fails.append(f"mesh LU n={n}: residual {rec['residual']}")
            if k_rhs:
                b = torch.randn((n, k_rhs), generator=gen, device=dev)
                bd = darray.distribute(b, sq.mesh, sq.slice_spec)
                w1 = darray.whole(w)

                def solve(g, un):
                    ww, bb, aa = ((w, bd, ad) if g is sq else (w1, b, a))
                    x = lu.solve_factored(g, ww, perm, bb)
                    for _ in range(2):
                        r = linalg._sub(g, bb, summa.gemm(g, aa, x))
                        x = linalg._add(g, x, lu.solve_factored(
                            g, ww, perm, r))
                    return x

                srec, x = both(f"LU n={n} solve", solve, zero_counts())
                xg = darray.to_global(x)
                srec["solve_residual"] = float(torch.linalg.norm(
                    a.double() @ xg.double() - b.double())
                    / torch.linalg.norm(b.double()))
                if not srec["solve_residual"] < LU_SOLVE_TOL:
                    fails.append(f"mesh LU n={n}: solve residual "
                                 f"{srec['solve_residual']}")
                rec.update(solve_k=k_rhs, solve=srec)
                del b, bd, x, xg, w1
        recs.append(rec)
        del a, ad, w, perm
        torch.cuda.empty_cache()
    out["lu"] = recs

    # QDWH polar, both layouts
    m, n = POLAR_SHAPE
    pcfg = polar.Config()
    pa = matrix.rand(sq, m, n, 0).data
    recs = []
    for layout in POLAR_LAYOUTS:
        want = polar_want(n, layout, pcfg, pcfg.chol.base_dim(local, n))
        with default_matmul_precision("highest"):
            rec, (u, h) = both(f"polar {layout}", lambda g, un: polar.polar(
                g, un(pa), pcfg, layout=layout), want)
        ug, hg = darray.to_global(u), darray.to_global(h)
        orth, recon = factor_errors_f64(darray.whole(pa), ug, hg)
        rec.update(layout=layout, orthogonality_f64=orth,
                   reconstruction_f64=recon,
                   u_spec=str(u.spec) if isinstance(u, darray.DArray)
                   else None)
        for what, x in (("orthogonality_f64", orth),
                        ("reconstruction_f64", recon)):
            if not x < POLAR_TOL:
                fails.append(f"mesh polar {layout}: {what} {x}")
        recs.append(rec)
        del u, h, ug, hg
        torch.cuda.empty_cache()
    out["polar"] = {"m": m, "n": n, "precision": "highest", "runs": recs}
    del pa

    # spd_solve at SPD_RUN
    n, k, level, refine = SPD_RUN
    a, b = bsolve.operands(sq, "spd", 0, n, k, torch.float32)
    ccfg = cholinv.Config(summa_impl="gspmd")
    want = zero_counts()
    add_cholinv(want, n, ccfg.base_dim(local, n))
    add_trmm(want, "L,trans", 1 + refine)
    add_trmm(want, "L", 1 + refine)
    with default_matmul_precision(level):
        rec, x = both("spd_solve", lambda g, un: linalg.spd_solve(
            g, un(a), un(b), ccfg, refine=refine), want)
    kb = bsolve.RESIDUAL_COLS
    aw = darray.whole(a)
    rec.update(n=n, k=k, precision=level, refine=refine,
               solve_residual_f64=bsolve.residual_f64(
                   "spd", bsolve.host_f64(aw),
                   bsolve.host_f64(darray.whole(b)[:, :kb]),
                   darray.to_global(x)))
    if not rec["solve_residual_f64"] < SOLVE_TOL:
        fails.append(f"mesh spd_solve: residual {rec['solve_residual_f64']}")
    out["spd_solve"] = rec
    del a, b, x, aw
    torch.cuda.empty_cache()

    # lstsq at LSTSQ_RUN, each method, on the rect grid
    m, n, k, level, refine = LSTSQ_RUN
    a, b = bsolve.operands(rect, "lstsq", m, n, k, torch.float32)
    qcfg = cacqr.Config(num_iter=2)
    a64 = bsolve.host_f64(a)
    b64 = bsolve.host_f64(b)[:, :bsolve.RESIDUAL_COLS]
    recs = []
    for method in LSTSQ_METHODS:
        want = zero_counts()
        if method == "cqr2":
            want.update(syrk_upper=2, trmm_upper=3, chol_inv=2)
            want["trmm_upper_by_case"].update(R=2, L=1)
        with default_matmul_precision(level):
            rec, x = both(f"lstsq {method}", lambda g, un: linalg.lstsq(
                g, un(a), un(b), qcfg, refine=refine, method=method), want,
                grid=rect)
        rec.update(method=method, normal_residual_f64=bsolve.residual_f64(
            "lstsq", a64, b64, x))
        bound = LSTSQ_VS_LIBRARY * lstsq_library[method]
        if not rec["normal_residual_f64"] <= bound:
            fails.append(f"mesh lstsq {method}: normal residual "
                         f"{rec['normal_residual_f64']} above {bound}")
        recs.append(rec)
        del x
    out["lstsq"] = {"m": m, "n": n, "k": k, "precision": level,
                    "refine": refine, "grid": rect.shape, "runs": recs}
    del a, b, a64
    torch.cuda.empty_cache()

    # trsm, rectri and Newton at MESH_TRI
    n, k = MESH_TRI
    t = matrix.symmetric(sq, n, 5, align=128).data
    b = matrix.rand(sq, n, k, 6).data
    t64 = torch.tril(darray.whole(t).double())
    tri = {}
    with default_matmul_precision("highest"):
        rec, x = both("trsm", lambda g, un: trsm.solve(g, un(t), un(b)),
                      zero_counts())
        b64 = darray.whole(b).double()
        rec["residual_f64"] = float(torch.linalg.norm(
            t64 @ darray.to_global(x).double() - b64)
            / torch.linalg.norm(b64))
        tri["trsm"] = rec
        rec, x = both("rectri", lambda g, un: rectri.invert(g, un(t)),
                      zero_counts())
        eye = torch.eye(n, dtype=torch.float64, device=dev)
        rec["residual_f64"] = float(torch.linalg.norm(
            t64 @ darray.to_global(x).double() - eye)) / n**0.5
        tri["rectri"] = rec
        rec, (x, iters, _) = both("newton", lambda g, un: newton.invert(
            g, un(t), newton.Config(spd=True)), zero_counts())
        inv64 = torch.linalg.inv(darray.whole(t).double())
        rec.update(iters=iters, rel_err_f64=float(torch.linalg.norm(
            darray.to_global(x).double() - inv64)
            / torch.linalg.norm(inv64)))
        tri["newton"] = rec
    for name, bound_key, tol in (("trsm", "residual_f64", TOL),
                                 ("rectri", "residual_f64", TOL),
                                 ("newton", "rel_err_f64", LINALG_TOL)):
        if not tri[name][bound_key] < tol:
            fails.append(f"mesh {name}: {bound_key} "
                         f"{tri[name][bound_key]} not below {tol}")
    out["tri"] = {"n": n, "k": k, "precision": "highest", **tri}
    del t, b, x, t64, b64, inv64, eye
    torch.cuda.empty_cache()


def mesh_spectral(out: dict, fails: list, local, refs: dict) -> None:
    """[mesh]'s spectral and application layers and the cyclic workspace
    on the world's grids, each call at its one-device phase's shape and
    on its operand (made again here from the phase's seeds): cyclic
    (CYCLIC_RUN), eigh (EIGH_N), eigh_partial (PARTIAL_RUN), the
    [spectral] entries (SPECTRAL_N), svd (POLAR_SHAPE, '2d'), rsvd
    (RSVD_RUNS['rsvd']), pca (PCA_RUN), als and als_sparse. On one rank
    each result must be bitwise equal to the one-device phase's (its
    fingerprint, keep_ref; on a mismatch the one-device call runs again
    here, to tell the two processes' runs apart from the world's path)
    with the phase's launch counts, and carries the phase's bound checks;
    on more ranks each is held within SPECTRAL_TOL of the one-device call
    made here (values and the basis-free results; eigenvectors and
    singular vectors by their f64 residual and orthogonality)."""
    import torch.distributed as dist

    from capital_tpu_torch import Grid, linalg, matrix
    from capital_tpu_torch.algs import cholinv, cholinv_cyclic, eigh, svd
    from capital_tpu_torch.algs.cacqr import ROW1D
    from capital_tpu_torch.apps import als, rsvd
    from capital_tpu_torch.bench.rsvd import _planted
    from capital_tpu_torch.ops.precision import default_matmul_precision
    from capital_tpu_torch.parallel import darray

    one = dist.get_world_size() == 1
    sq, rect = Grid.square(c=1), Grid.rect(c=1)
    dev = local.device
    recs: dict = {}

    def held(name, grid, fn, basis=(), check=None):
        """fn(grid, un) on the world grid, counted, against refs[name];
        basis: the output positions that carry a basis (held by check on
        more ranks)."""
        ref = refs[name]
        with default_matmul_precision("highest"):
            ms, got, counts, _, _ = counted_call(lambda: fn(grid, lambda x: x))
        fp = fingerprint(got)
        rec = {"ms": ms, "bitwise": fp == ref["fp"], "launches": counts,
               "one_device_checks": ref["checks"]}
        if one:
            if counts != ref["launches"]:
                fails.append(f"mesh {name}: launch counts {counts} != "
                             f"{ref['launches']}")
            if not rec["bitwise"]:
                with default_matmul_precision("highest"):
                    again = fn(local, darray.whole)
                rec["bitwise_to_this_rank"] = fingerprint(again) == fp
                fails.append(f"mesh {name}: not bitwise equal to the "
                             "one-device call (this rank's own one-device "
                             f"call: {rec['bitwise_to_this_rank']})")
        else:
            with default_matmul_precision("highest"):
                want = fn(local, darray.whole)
            rels = []
            for i, (g, w) in enumerate(zip(_outs(got), _outs(want))):
                if i in basis:
                    continue
                g = torch.as_tensor(darray.to_global(g)).to(dev)
                w = torch.as_tensor(darray.to_global(w)).to(dev)
                rel = (float(torch.linalg.norm(g.double() - w.double())
                             / max(float(torch.linalg.norm(w.double())),
                                   1e-30)))
                rels.append(rel)
                if not rel < SPECTRAL_TOL:
                    fails.append(f"mesh {name} [{i}]: rel {rel}")
            rec["rel"] = rels
            if check is not None:
                for key, (x, tol) in check(got).items():
                    rec[key] = x
                    if not x < tol:
                        fails.append(f"mesh {name}: {key} {x} not below "
                                     f"{tol}")
        recs[name] = rec
        del got

    def whole(*xs):
        return [darray.to_global(x) for x in xs]

    # cyclic cholinv at CYCLIC_RUN
    n, bc = CYCLIC_RUN
    a = matrix.symmetric(local, n, 0, align=128).data
    ad = darray.distribute(a, sq.mesh, sq.slice_spec)
    ccfg = cholinv.Config(min_bc=bc)
    held("cyclic", sq, lambda g, un: cholinv_cyclic.factor(
        g, ad if g is sq else a, ccfg))
    del a, ad

    # eigh at EIGH_N and eigh_partial at PARTIAL_RUN (Wigner operands)
    ecfg = eigh.Config(base_n=EIG_BASE)
    for name, n, call in (
            ("eigh", EIGH_N, lambda g, x: eigh.eigh(g, x, ecfg)),
            ("eigh_partial", PARTIAL_RUN[0], lambda g, x: eigh.eigh_partial(
                g, x, PARTIAL_RUN[1], ecfg, which="top"))):
        a = matrix.symmetric(local, n, 0, diag_shift=0.0, align=128).data
        ad = darray.distribute(a, sq.mesh, sq.slice_spec)

        def eig_check(res, a=a):
            r, o = eig_errors_f64(a, *whole(*res))
            return {"residual_f64": (r, EIG_TOL),
                    "orthogonality_f64": (o, EIG_TOL)}

        held(name, sq, lambda g, un, a=a, ad=ad, call=call: call(
            g, ad if g is sq else a), basis=(1,), check=eig_check)
        del a, ad
        torch.cuda.empty_cache()

    # the [spectral] entries at SPECTRAL_N, on spectral_phase's operands
    n, k = SPECTRAL_N, SPECTRAL_K
    scfg = svd.Config(eig=ecfg)
    radius = 2.0 * (n / 24.0) ** 0.5
    ops = {"wig": matrix.symmetric(local, n, 1, diag_shift=0.0,
                                   align=128).data,
           "bmat": matrix.symmetric(local, n, 2, align=128).data,
           "spd": matrix.symmetric(local, n, 3, diag_shift=1.25 * radius,
                                   align=128).data}
    gen = torch.Generator(device=dev).manual_seed(5)
    ops["gmat"] = torch.rand((n, n), generator=gen, device=dev) - 0.5
    ops["gmat"].diagonal().add_(n**0.5)
    dist_ops = {key: darray.distribute(x, sq.mesh, sq.slice_spec)
                for key, x in ops.items()}
    sigma = refs["sigma"]

    def opnd(g, key):
        return dist_ops[key] if g is sq else ops[key]

    spectral = {
        "eigvalsh": (lambda g: eigh.eigvalsh(g, opnd(g, "wig"), ecfg), ()),
        "count_above": (lambda g: eigh.count_above(g, opnd(g, "wig"), sigma,
                                                   ecfg), ()),
        "eigh_gen": (lambda g: eigh.eigh_gen(g, opnd(g, "wig"),
                                             opnd(g, "bmat"), ecfg), (1,)),
        "svd_partial": (lambda g: svd.svd_partial(g, opnd(g, "gmat"), k,
                                                  scfg, layout="2d"),
                        (0, 2)),
        "singular_values": (lambda g: svd.singular_values(
            g, opnd(g, "gmat"), scfg, layout="2d"), ()),
        "pinv": (lambda g: linalg.pinv(g, opnd(g, "gmat"), cfg=scfg), ()),
        "cond": (lambda g: linalg.cond(g, opnd(g, "gmat"), cfg=scfg), ()),
        "funm_spd": (lambda g: linalg.funm_spd(g, opnd(g, "spd"),
                                               torch.reciprocal, cfg=ecfg),
                     ()),
        "spd_sqrt": (lambda g: linalg.spd_sqrt(g, opnd(g, "spd"), cfg=ecfg),
                     ()),
        "spd_sqrt_inverse": (lambda g: linalg.spd_sqrt(
            g, opnd(g, "spd"), cfg=ecfg, inverse=True), ()),
        "logm_spd": (lambda g: linalg.logm_spd(g, opnd(g, "spd"), cfg=ecfg),
                     ()),
        "powm_spd": (lambda g: linalg.powm_spd(g, opnd(g, "spd"), 0.75,
                                               cfg=ecfg), ()),
    }
    for name, (call, basis) in spectral.items():
        held(name, sq, lambda g, un, call=call: call(g), basis=basis)
    del ops, dist_ops
    torch.cuda.empty_cache()

    # svd of [polar]'s operand, '2d'
    m, n = POLAR_SHAPE
    a = matrix.rand(local, m, n, 0).data
    ad = darray.distribute(a, sq.mesh, sq.slice_spec)

    def svd_check(res):
        u, s, v = whole(*res)
        orth_u, recon = factor_errors_f64(a, u, (v * s[None, :]).T)
        return {"reconstruction_f64": (recon, EIG_TOL),
                "u_orthogonality_f64": (orth_u, EIG_TOL)}

    held("svd", sq, lambda g, un: svd.svd(g, ad if g is sq else a, scfg,
                                          layout="2d"),
         basis=(0, 2), check=svd_check)
    del a, ad
    torch.cuda.empty_cache()

    # the apps on the rect grid: rsvd, pca, als, als_sparse
    m, n, kk, over, q, _ = RSVD_RUNS["rsvd"]
    with default_matmul_precision("highest"):
        a, _ = _planted(local, m, n, kk, torch.float32, 0)
    ad = darray.distribute(a, rect.mesh, ROW1D)
    rcfg = rsvd.Config(k=kk, oversample=over, power_iters=q)
    held("rsvd", rect, lambda g, un: rsvd.rsvd(g, ad if g is rect else a,
                                               rcfg), basis=(0, 2))
    del a, ad
    m, n, kk = PCA_RUN
    with default_matmul_precision("highest"):
        a, _ = _planted(local, m, n, kk, torch.float32, 1)
    a += torch.randn((n,), generator=torch.Generator(
        device=dev).manual_seed(6), device=dev)
    ad = darray.distribute(a, rect.mesh, ROW1D)
    pcfg = rsvd.Config(k=kk, oversample=8, power_iters=1)
    held("pca", rect, lambda g, un: rsvd.pca(g, ad if g is rect else a,
                                             pcfg), basis=(0,))
    del a, ad
    users, items, kk, density, iters = ALS_RUN
    acfg = als.Config(rank=kk, lam=ALS_LAM, num_iters=iters)

    def dense(g, un):
        r, msk = als.synthetic_ratings(g, users, items, 0, rank=16,
                                       density=density)
        return als.fit(g, r, msk, acfg)

    held("als", rect, dense, basis=(0, 1))
    users, items, kk, obs, iters = ALS_SPARSE_RUN
    scfg_als = als.Config(rank=kk, lam=ALS_LAM, num_iters=iters)

    def sparse(g, un):
        data = als.synthetic_regular(g, users, items, obs, 0)
        return als.fit_sparse(g, data, scfg_als, items=items)

    held("als_sparse", rect, sparse, basis=(0, 1))
    torch.cuda.empty_cache()
    for rec in recs.values():
        add_counts(out["launches"], rec["launches"])
    out["spectral"] = recs


def _outs(res) -> tuple:
    return res if isinstance(res, tuple) else (res,)


def mesh_phase(failures: list, lstsqs: list) -> dict:
    """[mesh]: mesh_rank on one NCCL rank a card."""
    from capital_tpu_torch.parallel import launch

    ranks = torch.cuda.device_count()
    lib = {r["method"]: r["library_normal_residual_f64"] for r in lstsqs}
    t0 = time.perf_counter()
    outs = launch.launch(mesh_rank, ranks, lib, MESH_REFS, device="cuda",
                         timeout=900)
    secs = time.perf_counter() - t0
    for o in outs:
        failures.extend(o.pop("failures"))
    rec = dict(outs[0])
    rec.update(ranks=ranks, seconds=secs, card=smi(),
               multi_rank_on_card=MULTI_RANK_ON_CARD)
    print(f"[mesh] {json.dumps(rec)}", flush=True)
    return rec


def dryrun_rank() -> dict:
    """One rank of the [dryrun] world: entry.dryrun_multichip over the
    world, its launches counted from 0 just before it."""
    import torch.distributed as dist

    from capital_tpu_torch import entry
    from capital_tpu_torch.ops import counters, reset_counters

    reset_counters()
    t0 = time.perf_counter()
    try:
        figs, error = entry.dryrun_multichip(dist.get_world_size()), None
    except AssertionError as exc:  # a step's bound
        figs, error = {}, str(exc)
    return {"rank": dist.get_rank(), "figures": figs, "error": error,
            "launches": counters(), "seconds": time.perf_counter() - t0}


def dryrun_phase(failures: list) -> dict:
    """[dryrun]: dryrun_rank on one NCCL rank a card; every step's figure
    within its bound, the steps those of entry.STEPS the world runs, the
    kernels of DRYRUN_KERNELS launched and no DRYRUN_FALLBACKS taken."""
    from capital_tpu_torch import entry
    from capital_tpu_torch.parallel import launch

    ranks = torch.cuda.device_count()
    t0 = time.perf_counter()
    outs = launch.launch(dryrun_rank, ranks, device="cuda", timeout=600)
    secs = time.perf_counter() - t0
    rec = dict(outs[0])
    hybrid = ranks >= 8 and ranks % 4 == 0
    steps = [s for s, _, _ in entry.STEPS if s != "hybrid" or hybrid]
    for o in outs:
        if o["error"]:
            failures.append(f"dryrun rank {o['rank']}: {o['error']}")
        elif list(o["figures"]) != steps:
            failures.append(f"dryrun rank {o['rank']}: steps "
                            f"{list(o['figures'])} != {steps}")
        for step, fig in o["figures"].items():
            if not fig["held"]:
                failures.append(f"dryrun {step}: {fig}")
    got = rec["launches"]
    for k in DRYRUN_KERNELS:
        if not got[k]:
            failures.append(f"dryrun: {k} never launched")
    for k in DRYRUN_FALLBACKS:
        if got[k]:
            failures.append(f"dryrun: {k} ran {got[k]} times")
    rec.update(ranks=ranks, world_seconds=secs, card=smi())
    print(f"[dryrun] {json.dumps(rec)}", flush=True)
    return rec


def phase_launches(row: dict, phases: dict) -> dict:
    """{phase: launches of the row's kernel (for TRMM, of its case) in
    that phase's runs}, for the phases whose records carry `launches`."""
    out = {}
    for name, got in phases.items():
        if row["kernel"] == "trmm_upper":
            out[name] = got["trmm_upper_by_case"][row["case"].split(":")[0]]
        else:
            out[name] = got[row["kernel"]]
    return out


def path_launches(row: dict, mains: list, lus: list, qrs: list,
                  polars: list, eighs: list,
                  rsvds: dict) -> tuple[bool, int]:
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
    if case and case.split(":")[-1] in rsvds:  # the rSVD's first call
        got = rsvds[case.split(":")[-1]]["launches"]
        return True, (got["trmm_upper_by_case"]["R"]
                      if kernel == "trmm_upper" else got[kernel])
    if case in ("eigh", "R:eigh"):
        got = eighs[0]["launches"]  # the [eigh] headline, 'highest'
        return True, (got["trmm_upper_by_case"]["R"]
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


def profile_check(reps: int) -> int:
    """How often a one-call profile misses kernels that ran: the 128 x 128
    LU leaf strip of LEAF_STRIPS (its restoring copy, then the leaf) and
    the Cholesky leaf at n = 128, each profiled `reps` times bare
    (profiled_kernels(settle=False)) and `reps` times as device_launches
    takes one reading (the wait and the witness), in turn; beside each
    reading, whether the witness was seen, the launches the wrapper counted
    in that call (ops.counters()) and its start in seconds. Readings to
    chiprun_out/profile_check.json."""
    from capital_tpu_torch.ops import _build, counters
    from capital_tpu_torch.ops.cuda_chol import chol_inv_cuda
    from capital_tpu_torch.ops.cuda_getrf import getrf_leaf

    print(f"[build] {_build.build():.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    ws = torch.empty((128, 32768), device=dev)
    win = ws[:, :128]
    src = torch.randn((128, 128), generator=gen, device=dev)
    x = torch.rand((128, 128), generator=gen, device=dev) - 0.5
    spd = x @ x.T + (128 / 12) * torch.eye(128, device=dev)

    def leaf():
        win.copy_(src)
        return getrf_leaf(win)

    cases = {"getrf_leaf[128x128]": (leaf, "getrf_leaf", 2),
             "chol_inv n=128": (lambda: chol_inv_cuda(spd), "chol_inv", 1)}
    readings = {f"{name} {how}": [] for name in cases
                for how in ("bare", "settled")}
    t0 = time.perf_counter()
    for name, (fn, key, _) in cases.items():
        fn()
        torch.cuda.synchronize()
        for _ in range(reps):
            for how in ("bare", "settled"):
                before = counters()[key]
                at = time.perf_counter() - t0
                seen, kept = profiled_kernels(fn, settle=how == "settled")
                readings[f"{name} {how}"].append(
                    {"kernels": seen, "witness": kept, "at_s": at,
                     "wrapper_launches": counters()[key] - before})
    summary = {}
    for name, (_, _, want) in cases.items():
        for how in ("bare", "settled"):
            rs = readings[f"{name} {how}"]
            tot = [sum(r["kernels"].values()) for r in rs]
            kept = [t for t, r in zip(tot, rs) if r["witness"]]
            summary[f"{name} {how}"] = {
                "reps": len(rs), "kernels_per_call": want,
                "short": sum(t < want for t in tot),
                "empty": sum(t == 0 for t in tot),
                "witness_lost": len(rs) - len(kept),
                "witness_lost_at_s": [round(r["at_s"], 2) for r in rs
                                      if not r["witness"]],
                "short_with_witness": sum(t < want for t in kept),
                "over": sum(t > want for t in tot),
                "wrapper_launches": sorted({r["wrapper_launches"]
                                            for r in rs})}
            print(f"[profile_check] {name} {how}: "
                  f"{json.dumps(summary[f'{name} {how}'])}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_check.json"), "w") as f:
        json.dump({"card": smi(), "summary": summary, "readings": readings},
                  f)
    bad = [k for k, v in summary.items() if "settled" in k
           and (v["short_with_witness"] or v["over"])]
    return 1 if bad else 0


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
    t0 = time.perf_counter()
    for level in ("highest", "high"):
        rows += kernel_phase(level, failures)
    torch.cuda.empty_cache()
    rows += leaf_phase(failures)
    print(f"[phase] kernels {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    f3 = f3_phase(failures)
    print(f"[phase] f3 {time.perf_counter() - t0:.1f} s", flush=True)
    phase_s = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        phase_s[name] = time.perf_counter() - t0
        print(f"[phase] {name} {phase_s[name]:.1f} s", flush=True)
        return out

    mains = timed("main", lambda: [main_path(n, level, failures)
                                   for n, level in MAIN_RUNS])
    lus = timed("lu", lambda: [lu_path(*run, failures) for run in LU_RUNS])
    qrs = timed("cacqr", lambda: [cacqr_path(*run, failures)
                                  for run in CACQR_RUNS])
    keep: dict = {}
    polars = timed("polar", lambda: polar_paths(failures, keep))
    solves = timed("solve", lambda: [spd_solve_path(failures)])
    lstsqs = timed("lstsq", lambda: lstsq_paths(failures))
    linalgs = timed("linalg", lambda: [linalg_phase(failures)])
    eighs = timed("eigh", lambda: [eigh_path(failures)])
    svds = timed("svd", lambda: [svd_path(failures, keep)])
    partials = timed("eigh_partial", lambda: [partial_path(failures)])
    spectrals = timed("spectral", lambda: [spectral_phase(failures)])
    rsvds = {name: timed(name, lambda name=name: rsvd_path(name, failures))
             for name in RSVD_RUNS}
    pcas = timed("pca", lambda: [pca_path(failures)])
    alss = [timed("als", lambda: als_path(False, failures)),
            timed("als_sparse", lambda: als_path(True, failures))]
    ios = timed("io", lambda: [io_phase(failures)])
    tunes = timed("autotune", lambda: autotune_phase(failures))
    hybrids = timed("hybrid", lambda: [hybrid_phase(failures)])
    cyclics = timed("cyclic", lambda: [cyclic_phase(failures)])
    drivers = timed("drivers", lambda: drivers_phase(failures))
    meshes = timed("mesh", lambda: [mesh_phase(failures, lstsqs)])
    dryruns = timed("dryrun", lambda: [dryrun_phase(failures)])
    new_phases = {"hybrid": hybrids[0]["launches"],
                  "cyclic": cyclics[0]["launches"],
                  "mesh": meshes[0]["launches"],
                  "dryrun": dryruns[0]["launches"]}
    for key, part in (("autotune", tunes), ("drivers", drivers)):
        new_phases[key] = zero_counts()
        for rec in part.values():
            add_counts(new_phases[key], rec["launches"])
    for row in rows:
        row["on_path"], row["launches"] = path_launches(
            row, mains, lus, qrs, polars, eighs, rsvds)
        if row["on_path"] and not row["launches"]:
            failures.append(f"{row['name']} never launched on the main path")
        if row["kernel"] == "chol_inv" and row["case"] == "n=512":
            row["launches_eigh"] = eighs[0]["launches"]["chol_inv"]
        row.update({f"launches_{k}": v
                    for k, v in phase_launches(row, new_phases).items()})
    result = {"card": card, "kernels": rows, "main": mains, "lu": lus,
              "cacqr": qrs, "f3": f3, "polar": polars, "solve": solves,
              "lstsq": lstsqs, "linalg": linalgs, "eigh": eighs,
              "svd": svds, "eigh_partial": partials, "spectral": spectrals,
              "rsvd": rsvds, "pca": pcas, "als": alss, "io": ios,
              "autotune": tunes, "hybrid": hybrids, "cyclic": cyclics,
              "drivers": drivers, "mesh": meshes, "dryrun": dryruns,
              "phase_s": phase_s,
              "failures": failures}
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
    if sys.argv[1:2] == ["--profile-check"] and torch.cuda.is_available():
        rc = profile_check(int(sys.argv[2]))
        sys.exit(rc)
    rc = main()
    print(f"[chip_smoke] {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
