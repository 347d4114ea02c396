// Fused blocked Cholesky + triangular inverse of one SPD leaf block.
//
// Replaces capital_tpu/ops/pallas_chol.py::chol_inv_pallas (pallas_call at
// :153; bodies _kernel :94 and _micro_chol_inv :52). For each 128-wide
// panel k of an n x n block (128 | n <= 1024):
//   1. micro-Cholesky of the diagonal block M_kk by 128 rank-1 steps that
//      also build E = R_kk^{-T} (Gauss-Jordan on the identity), pivot
//      clamped at max(d, 1e-30), scaled by rsqrt (within 2 ulp of the
//      plain version's 1 / sqrt);
//   2. slab R[k, k:] = E @ M[k, k:]  ([R_kk | R_{k,>k}]);
//   3. trailing update M[>k, >k] -= R[k, >k]^T R[k, >k];
//   4. inverse, left-looking: Rinv[:k, k] = -(Rinv[:k, :k] R[:k, k]) E^T,
//      then Rinv_kk = E^T.
// R and Rinv are written already masked (zeros below the diagonal), every
// entry, so the caller allocates them uninitialised. All arithmetic is f32.
//
// What bounds it on an H100: ~n^3 useful flops (2n^3/3 for R, as much for
// Rinv) over 3 n^2 f32 of traffic -- 1.3 us of FFMA at n = 512. The work
// is latency-bound instead: 128 dependent rank-1 steps per panel on one SM,
// and the dependent phases between them. The first version ran the micro-
// factorization as 1024 threads sweeping two full 128x128 shared tiles per
// step (0.31 ms a panel) and the products as 4 (n/128) + 1 launches.
//
// This design:
// - One cooperative launch per leaf (cudaLaunchCooperativeKernel, as
//   getrf_leaf.cu), phases separated by grid syncs (three per panel):
//     A: CTA 0 runs the micro-factorization; the other CTAs compute
//        T = Rinv[:k, :k] R[:k, k] (which does not depend on panel k's
//        micro-factorization) and zero the block column below panel k;
//     B: slab tiles, the inverse column -T E^T and Rinv_kk = E^T;
//     C: the trailing update, only on the 128-blocks on or above the block
//        diagonal (the only ones later panels read).
//   The products are 64x64 FFMA tiles over operands in L2 (3 MB at
//   n = 512), read with __ldcg so no CTA sees a stale L1 line of another
//   CTA's output. Panel 0 reads the caller's A directly and writes the
//   trailing blocks to the working copy M, so no copy precedes the launch.
// - The micro-factorization keeps M_kk and E in registers, one array W
//   that holds E left of the current column and M from it on: at step j
//   only rows > j change (columns > j: M's rank-1 update; columns <= j:
//   E's), so a warp whose 8 rows are all done leaves the loop and the
//   named barrier. Only pivot rows and columns go through shared memory,
//   double buffered, two steps to a barrier (see micro_chol). Each element
//   sees the same sequence of rank-1 updates as
//   ops/cuda_chol.py::_micro_chol_inv.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): see PERF.md
// section 6 -- n = 512 in ~0.21 ms against the first version's 1.55 ms
// and cholesky + solve_triangular's ~0.41 ms, one launch a call.
#include <algorithm>
#include <cooperative_groups.h>

#include "common.cuh"  // capital_error_string

namespace cg = cooperative_groups;

namespace {

constexpr int PB = 128;  // panel width
constexpr int GT = 64;   // product tile side
constexpr int GK = 32;   // product k slab
constexpr int LEAF_THREADS = 512;

struct Op {  // element (r, c) at p[r * rs + c * cs]
  const float* p;
  long long rs, cs;
};

struct Smem {
  __align__(16) float sa[GK][GT + 4];
  __align__(16) float sb[GK][GT + 4];
  // [pair parity][rows j0, j1 | columns j0, j1]
  __align__(16) float piv[2][4][PB];
  // [pair parity][dinv0, dinv1, rc0 at row j1, coef0 at column j1]
  __align__(16) float scal[2][4];
};

constexpr int PER = GT * GK / LEAF_THREADS;  // slab values a thread loads

// acc(r, c) = sum_{k in [klo, khi)} A(i0 + r, k) B(k, j0 + c) for a 64x64
// tile; epi(r, c, v) with r, c relative to (i0, j0). 2x4 values a thread
// (rows 2ty + i, columns 4tx + j, read from shared memory as float2 and
// float4); the next slab is read into registers while this one is
// multiplied.
template <class Epi>
__device__ void tile64(const Op& A, const Op& B, int i0, int j0, int klo,
                       int khi, Smem& sm, Epi epi) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[2][4] = {};
  float ra[PER], rb[PER];
  // slab element q of this thread: walk each operand's contiguous axis
  // across threads
  auto a_at = [&](int q, int& ii, int& kk) {
    const int idx = tid + q * LEAF_THREADS;
    if (A.cs == 1) { kk = idx % GK; ii = idx / GK; }
    else { ii = idx % GT; kk = idx / GT; }
  };
  auto b_at = [&](int q, int& kk, int& jj) {
    const int idx = tid + q * LEAF_THREADS;
    if (B.cs == 1) { jj = idx % GT; kk = idx / GT; }
    else { kk = idx % GK; jj = idx / GK; }
  };
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      int ii, kk, jj;
      a_at(q, ii, kk);
      ra[q] = __ldcg(A.p + (i0 + ii) * A.rs + (k0 + kk) * A.cs);
      b_at(q, kk, jj);
      rb[q] = __ldcg(B.p + (k0 + kk) * B.rs + (j0 + jj) * B.cs);
    }
  };
  if (klo < khi) fetch(klo);
  for (int k0 = klo; k0 < khi; k0 += GK) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      int ii, kk, jj;
      a_at(q, ii, kk);
      sm.sa[kk][ii] = ra[q];
      b_at(q, kk, jj);
      sm.sb[kk][jj] = rb[q];
    }
    __syncthreads();
    if (k0 + GK < khi) fetch(k0 + GK);
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float2 a2 = *reinterpret_cast<const float2*>(&sm.sa[kk][2 * ty]);
      const float4 b4 = *reinterpret_cast<const float4*>(&sm.sb[kk][4 * tx]);
      const float av[2] = {a2.x, a2.y}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) epi(2 * ty + i, 4 * tx + j, acc[i][j]);
}

// E = R_kk^{-T} of the 128x128 block at mk (row stride ld) into e (128 x
// 128, zeros above the diagonal). Warp w owns rows r0 + i = 8w + i, lane l
// columns c0 + q = 4l + q of W, i < 8, q < 4.
//
// Two steps j0 = 2p, j1 = 2p + 1 share one barrier: pivot rows and columns
// j0 and j1 are published as they stand before step j0, and every thread
// derives row and column j1 after step j0 for its own rows and columns with
// the same fma its owner would run. The thread that owns the 2x2 diagonal
// block publishes dinv0, dinv1 and the two scalars the others need. Each
// element still sees the rank-1 updates one at a time, in order. The pair
// loop is unrolled by 4, so owners index their registers with compile-
// time constants.
__device__ void micro_chol(const float* mk, long long ld, float* e,
                           Smem& sm) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 8 * warp, c0 = 4 * lane;
  float w[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 v = __ldcg(
        reinterpret_cast<const float4*>(mk + (long long)(r0 + i) * ld + c0));
    w[i][0] = v.x;
    w[i][1] = v.y;
    w[i][2] = v.z;
    w[i][3] = v.w;
  }

  // Publish rows and columns j0 = 8 jb + 2 pp and j1 = j0 + 1 into buffer
  // pp & 1: row j0 with 1 in place of d0 (E[j0][j0] is 1 before step j0),
  // row j1 with 0 at column j0 (column j0 of W starts over from 0: below
  // the diagonal it becomes column j0 of E; the rest is masked at the end)
  auto publish = [&](int jb, int pp) {
    const int i0 = 2 * pp, q0 = (2 * pp) % 4;  // compile-time
    float* row0 = sm.piv[pp & 1][0];
    float* row1 = sm.piv[pp & 1][1];
    float* col0 = sm.piv[pp & 1][2];
    float* col1 = sm.piv[pp & 1][3];
    const bool own_col = c0 == 8 * jb + 4 * (pp / 2);
    if (r0 == 8 * jb) {
      float a[4] = {w[i0][0], w[i0][1], w[i0][2], w[i0][3]};
      float b[4] = {w[i0 + 1][0], w[i0 + 1][1], w[i0 + 1][2], w[i0 + 1][3]};
      if (own_col) {
        const float dinv0 = rsqrtf(fmaxf(a[q0], 1e-30f));
        const float coef0_j1 = a[q0 + 1] * dinv0, rc0_j1 = b[q0] * dinv0;
        const float d1 = fmaf(-rc0_j1, coef0_j1, b[q0 + 1]);
        reinterpret_cast<float4*>(sm.scal[pp & 1])[0] = make_float4(
            dinv0, rsqrtf(fmaxf(d1, 1e-30f)), rc0_j1, coef0_j1);
        a[q0] = 1.f;
        b[q0] = 0.f;
      }
      reinterpret_cast<float4*>(row0 + c0)[0] =
          make_float4(a[0], a[1], a[2], a[3]);
      reinterpret_cast<float4*>(row1 + c0)[0] =
          make_float4(b[0], b[1], b[2], b[3]);
    }
    if (own_col) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        col0[r0 + i] = w[i][q0];
        col1[r0 + i] = w[i][q0 + 1];
        w[i][q0] = 0.f;
      }
    }
  };
  auto load8 = [](const float* p, float (&v)[8]) {
    const float4 x = reinterpret_cast<const float4*>(p)[0];
    const float4 y = reinterpret_cast<const float4*>(p)[1];
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  };

  publish(0, 0);
  __syncthreads();
  for (int jb = 0; jb < PB / 8; ++jb) {
    // a warp whose rows are all done leaves: nothing it holds is read
    // again, so the steps of block jb synchronise warps jb.. only
    if (warp < jb) break;
    const int active = (PB / 8 - jb) * 32;
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
      const int i0 = 2 * pp, q0 = (2 * pp) % 4;  // compile-time
      const int j0 = 8 * jb + i0, j1 = j0 + 1;
      const float4 sc = reinterpret_cast<const float4*>(sm.scal[pp & 1])[0];
      const float dinv0 = sc.x, dinv1 = sc.y, rc0_j1 = sc.z,
                  coef0_j1 = sc.w;
      const float4 ra =
          reinterpret_cast<const float4*>(sm.piv[pp & 1][0] + c0)[0];
      const float4 rb =
          reinterpret_cast<const float4*>(sm.piv[pp & 1][1] + c0)[0];
      float ca[8], cb[8];
      load8(sm.piv[pp & 1][2] + r0, ca);
      load8(sm.piv[pp & 1][3] + r0, cb);
      // step j0: coef0 = row j0 scaled; rc0 = column j0 scaled, 0 on rows
      // <= j0, which the step leaves alone
      const float ra4[4] = {ra.x, ra.y, ra.z, ra.w};
      const float rb4[4] = {rb.x, rb.y, rb.z, rb.w};
      float coef0[4], coef1[4], rc0[8], rc1[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        coef0[q] = ra4[q] * dinv0;
        // row j1 after step j0, 1 in place of d1, scaled
        const float b = fmaf(-rc0_j1, coef0[q], rb4[q]);
        coef1[q] = (c0 + q == j1 ? 1.f : b) * dinv1;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        rc0[i] = r0 + i > j0 ? ca[i] * dinv0 : 0.f;
        // column j1 after step j0, scaled
        const float c = fmaf(-rc0[i], coef0_j1, cb[i]);
        rc1[i] = r0 + i > j1 ? c * dinv1 : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) w[i][q] = fmaf(-rc0[i], coef0[q], w[i][q]);
      if (c0 == 8 * jb + 4 * (pp / 2)) {  // column j1 starts over from 0
#pragma unroll
        for (int i = 0; i < 8; ++i) w[i][q0 + 1] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) w[i][q] = fmaf(-rc1[i], coef1[q], w[i][q]);
      if (r0 == 8 * jb) {  // rows j0 and j1 of E
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (c0 + q <= j0) w[i0][q] = coef0[q];
          if (c0 + q <= j1) w[i0 + 1][q] = coef1[q];
        }
      }
      if (pp < 3) publish(jb, pp + 1);
      else if (jb + 1 < PB / 8) publish(jb + 1, 0);
      // one barrier a pair of steps (the buffers alternate), over the
      // active warps
      asm volatile("bar.sync 1, %0;\n" ::"r"(active) : "memory");
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = c0 + q <= r0 + i ? w[i][q] : 0.f;
    reinterpret_cast<float4*>(e + (r0 + i) * PB + c0)[0] =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// job j of a phase: CTA 0 keeps job 0 when `own0` (the micro-
// factorization), the other jobs go round the other CTAs
__device__ __forceinline__ bool mine(int job, bool own0) {
  const int g = gridDim.x, b = blockIdx.x;
  if (!own0 || g == 1) return job % g == b;
  if (job == 0) return b == 0;
  return b > 0 && (job - 1) % (g - 1) == b - 1;
}

__global__ void __launch_bounds__(LEAF_THREADS)
chol_inv_kernel(const float* a, float* m, float* r, float* rinv, float* e,
                float* t, int n) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Smem sm;
  const long long ld = n;
  for (int kb = 0; kb < n; kb += PB) {
    const int k1 = kb + PB, rest = n - k1;
    const float* src = kb == 0 ? a : m;  // panel 0 reads A in place

    // phase A: micro-factorization | T = Rinv[:kb, :kb] R[:kb, kb:k1] |
    // zeros in R and Rinv below panel k's diagonal block
    {
      const int nt = (kb / GT) * (PB / GT), nz = (rest / GT) * (PB / GT);
      for (int job = 0; job < 1 + nt + 2 * nz; ++job) {
        if (!mine(job, true)) continue;
        if (job == 0) {
          micro_chol(src + kb * ld + kb, ld, e, sm);
        } else if (job <= nt) {
          const int ti = (job - 1) / 2, tj = (job - 1) % 2;
          tile64({rinv, ld, 1}, {r + kb, ld, 1}, ti * GT, tj * GT, ti * GT,
                 kb, sm, [&](int rr, int cc, float v) {
                   t[(ti * GT + rr) * PB + tj * GT + cc] = v;
                 });
        } else {
          const int z = job - 1 - nt, which = z / nz, zz = z % nz;
          float* out = which ? rinv : r;
          const int rr0 = k1 + (zz / 2) * GT, cc0 = kb + (zz % 2) * GT;
          for (int idx = threadIdx.x; idx < GT * GT; idx += LEAF_THREADS)
            out[(rr0 + idx / GT) * ld + cc0 + idx % GT] = 0.f;
        }
      }
    }
    grid.sync();

    // phase B: R[kb:k1, kb:] = E @ M[kb:k1, kb:] (masked on the diagonal
    // block) | Rinv[:kb, kb:k1] = -T E^T | Rinv_kk = E^T
    {
      const int ns = (PB / GT) * ((n - kb) / GT), ni = (kb / GT) * (PB / GT);
      const int nd = (PB / GT) * (PB / GT);
      for (int job = 0; job < ns + ni + nd; ++job) {
        if (!mine(job, false)) continue;
        if (job < ns) {
          const int ti = job % 2, tj = job / 2;
          // E is lower-triangular: row block ti needs k < (ti + 1) 64
          tile64({e, PB, 1}, {src + kb * ld + kb, ld, 1}, ti * GT, tj * GT, 0,
                 (ti + 1) * GT, sm, [&](int rr, int cc, float v) {
                   const int gr = ti * GT + rr, gc = tj * GT + cc;
                   r[(kb + gr) * ld + kb + gc] = gr <= gc ? v : 0.f;
                 });
        } else if (job < ns + ni) {
          const int q = job - ns, ti = q / 2, tj = q % 2;
          // E^T is upper-triangular: column block tj needs k < (tj + 1) 64
          tile64({t, PB, 1}, {e, 1, PB}, ti * GT, tj * GT, 0, (tj + 1) * GT,
                 sm, [&](int rr, int cc, float v) {
                   rinv[(ti * GT + rr) * ld + kb + tj * GT + cc] = -v;
                 });
        } else {
          const int q = job - ns - ni, rr0 = (q / 2) * GT, cc0 = (q % 2) * GT;
          for (int idx = threadIdx.x; idx < GT * GT; idx += LEAF_THREADS) {
            const int rr = rr0 + idx / GT, cc = cc0 + idx % GT;
            rinv[(kb + rr) * ld + kb + cc] =
                rr <= cc ? __ldcg(e + cc * PB + rr) : 0.f;
          }
        }
      }
    }
    if (rest == 0) break;
    grid.sync();

    // phase C: M[k1:, k1:] -= P^T P, P = R[kb:k1, k1:], on the 128-blocks
    // (bi <= bj) later panels read; 4 tiles of 64 a block
    {
      const int nb = rest / PB, jobs = 4 * nb * (nb + 1) / 2;
      const float* p = r + kb * ld + k1;
      for (int job = 0; job < jobs; ++job) {
        if (!mine(job, false)) continue;
        int pr = job / 4, bi = 0;
        while (pr >= nb - bi) { pr -= nb - bi; ++bi; }
        const int bj = bi + pr, sub = job % 4;
        const int i0 = bi * PB + (sub / 2) * GT, j0 = bj * PB + (sub % 2) * GT;
        tile64({p, 1, ld}, {p, ld, 1}, i0, j0, 0, PB, sm,
               [&](int rr, int cc, float v) {
                 const long long o = (k1 + i0 + rr) * ld + k1 + j0 + cc;
                 m[o] = __ldcg(src + o) - v;
               });
      }
    }
    grid.sync();
  }
}

// CTAs the largest phase can use
int max_jobs(int n) {
  int most = 1;
  for (int kb = 0; kb < n; kb += PB) {
    const int rest = n - kb - PB, nb = rest / PB;
    const int a = 1 + (kb / GT) * 2 + 2 * (rest / GT) * 2;
    const int b = 2 * ((n - kb) / GT) + (kb / GT) * 2 + 4;
    const int c = 4 * nb * (nb + 1) / 2;
    most = std::max(most, std::max(a, std::max(b, c)));
  }
  return most;
}

}  // namespace

// a: the n x n SPD input (read only); m: n x n working copy; r, rinv: the
// n x n outputs (every entry written); e: 128 x 128 scratch; t: n x 128
// scratch. All contiguous f32, 128 | n <= 1024. Returns a cudaError_t.
extern "C" int capital_chol_inv(const float* a, float* m, float* r,
                                float* rinv, float* e, float* t, int n,
                                void* stream) {
  if (n < PB || n % PB || n > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chol_inv_kernel, LEAF_THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  // every CTA must be co-resident for grid.sync()
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int g = std::min(per_sm * sms, max_jobs(n));
  void* args[] = {&a, &m, &r, &rinv, &e, &t, &n};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(chol_inv_kernel),
                                    dim3(g), dim3(LEAF_THREADS), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
