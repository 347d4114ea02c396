// Triangle-aware Gram kernel: G = A^T A from the upper 128x128 tiles only.
//
// Replaces capital_tpu/ops/pallas_syrk.py::syrk_upper (pallas_call at
// :149, body _kernel :44). The TPU kernel enumerates upper tile pairs from a
// lookup table and walks the row chunks as its sequential grid axis; here
// one CTA owns one upper output tile (i <= j, found from blockIdx.x) and
// loops over the contraction rows itself.
//
// Two-level accumulation: the running tile is folded into a second
// accumulator every FOLD_ROWS = 32 x 512 contraction rows, as the TPU
// kernel folds every 32 chunks of 512 (pallas_syrk.py:65-68). This is an
// accuracy property, not a speed trick: it bounds the sequential-add error
// at ~(m/FOLD_ROWS + FOLD_ROWS/32) eps instead of m/32 eps. A contraction
// of at most FOLD_ROWS rows never folds. At 'highest' it runs an
// instantiation without the second accumulator (the registers it frees keep
// two CTAs on an SM); the wgmma kernel always holds it (three 64-float
// accumulators fit the registers setmaxnreg gives a consumer thread).
//
// Each tile is written with its mirror. Only entries with row <= col are
// written from their own sum; the entry below the diagonal is the same
// value mirrored, so G is bitwise symmetric. The tile is staged in shared
// memory (row stride 129 floats, so a column read is free of bank
// conflicts) and both the tile and its mirror are written row by row,
// coalesced. The leaf reads a pivot column as the pivot row's transpose,
// so an asymmetric Schur complement would feed it inconsistent values.
//
// What bounds it on an H100: m n^2 multiply-adds (the upper triangle)
// against reading A once and writing n^2 outputs -- compute-bound at the
// main path's shapes (16384^2: 65.6 ms of FFMA at 'highest', 13.3 ms of
// bf16 tensor-core work for the three passes of 'high').
//
// 'high' / 'default' (bf16 tensor cores):
//   1. A split pass reads the window once and writes a packed, K-major
//      (transposed: the contraction index contiguous) bf16 copy into the
//      caller's scratch, zero-padded to 128 columns x 64 rows: hi alone at
//      'default' and for bf16 inputs, hi and lo = bf16(x - hi) at 'high'
//      (hi bitwise pallas_dot.py::_split_f32's). Every element is split
//      once, not once per output tile as in the first version. Both
//      operands of the Gram are the same A, so one copy feeds both.
//   2. The product runs on wgmma (m64n128k16, bf16 in, f32 out) from
//      shared memory filled by TMA (cp.async.bulk.tensor, 128-byte swizzle)
//      through a ring of stages guarded by mbarriers: one producer warp
//      keeps the ring full, two consumer warpgroups each own 64 rows of
//      the 128x128 tile. Diagonal tiles load one operand and read it twice.
//      At 'high' three wgmma per k16 step: hi*hi, hi*lo, lo*hi.
//   3. The tensor cores' own f32 accumulation is not IEEE round-to-nearest
//      (measured on the card: a 17000-deep chain drifts ~1e-4 from an f32
//      sum). So each promotion interval of PROMO_ROWS contraction rows
//      goes into a freshly zeroed accumulator (scale-d = 0 on its first
//      wgmma) and is then added to the running f32 sum with ordinary adds.
// 'highest' (f32 FFMA, never TF32): a 128x128 tile per CTA, an 8x8 register
// micro-tile per thread read from shared memory as float4, a 4-stage
// cp.async (16-byte) pipeline; bound and triangle tests only on edge tiles
// (4-byte cp.async with zero fill).
//
// Promotion interval: 128 rows, chosen from one measurement of each
// candidate against the plain version at 16384 deep (relative Frobenius /
// max abs): 32 rows 5.03e-7 / 2.69e-3 in 26.7 ms, 64 rows 4.20e-7 /
// 1.95e-3 in 26.1 ms, 128 rows 4.42e-7 / 1.71e-3 in 24.3 ms (PERF.md).
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W), 16384^2 window:
// 'high' 25.4 ms (bound 13.3 ms, 52 %; Bt @ B 161.9 ms; the first version
// 191.8 ms), 'highest' 99.7 ms (bound 65.6 ms, 66 %; Bt @ B 160.6 ms; the
// first version 269.1 ms). The 512^2 calls (10 tiles on 132 SMs) take
// 0.043 / 0.068 ms against the library's 0.025 / 0.030 ms.
#include <cuda.h>

#include "tile_dot.cuh"

using namespace capital;

namespace {

// Contraction rows per first-level accumulator of the two-level sum
// (32 row chunks of 512, capital_tpu/ops/pallas_syrk.py:65-68).
constexpr int FOLD_ROWS = 32 * 512;
constexpr int T = 128;        // output tile side
constexpr int ST = T + 1;     // staged tile row stride (floats)
constexpr size_t STAGE_BYTES = T * ST * sizeof(float);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// upper tile pair number -> (i, j), i <= j, row-major over the triangle
__device__ __forceinline__ void pair_of(int p, int nt, int& i, int& j) {
  i = 0;
  while (p >= nt - i) { p -= nt - i; ++i; }
  j = i + p;
}

// Writes the staged tile st (T x ST floats) of output tile (i0, j0) and its
// mirror. Entry (i0 + r, j0 + c) comes from its own sum when it lies on or
// above the diagonal; (j0 + r, i0 + c) is the mirror of (i0 + c, j0 + r).
// Both passes walk output rows, so the writes coalesce.
template <typename TO>
__device__ void store_mirrored(const float* st, TO* g, long long ldg, int n,
                               int i0, int j0, int tid, int nthreads) {
  for (int idx = tid; idx < T * T; idx += nthreads) {
    const int r = idx / T, c = idx % T;
    if (i0 + r <= j0 + c && j0 + c < n)
      g[(long long)(i0 + r) * ldg + j0 + c] = from_f32<TO>(st[r * ST + c]);
    if (i0 + c <= j0 + r && j0 + r < n)
      g[(long long)(j0 + r) * ldg + i0 + c] = from_f32<TO>(st[c * ST + r]);
  }
}

// ---------------------------------------------------------------------------
// 'highest': f32 FFMA
// ---------------------------------------------------------------------------

constexpr int F_BK = 16, F_STAGES = 4, F_THREADS = 256;
constexpr size_t F_RING = F_STAGES * 2 * F_BK * T * sizeof(float);
constexpr size_t F_SMEM = F_RING > STAGE_BYTES ? F_RING : STAGE_BYTES;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
// 4 bytes, or zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [k0, k0 + F_BK) x columns [c0, c0 + T) of A into buf[k][c]
__device__ __forceinline__ void load_slab(float* buf, const float* a,
                                          long long lda, int m, int n,
                                          int k0, int c0, bool fast,
                                          int tid) {
  if (fast) {
#pragma unroll
    for (int q = tid; q < F_BK * T / 4; q += F_THREADS) {
      const int k = q / (T / 4), c = (q % (T / 4)) * 4;
      cp_async16(buf + k * T + c, a + (long long)(k0 + k) * lda + c0 + c);
    }
  } else {
    for (int q = tid; q < F_BK * T; q += F_THREADS) {
      const int k = q / T, c = q % T;
      const bool ok = k0 + k < m && c0 + c < n;
      cp_async4(buf + k * T + c,
                ok ? a + (long long)(k0 + k) * lda + c0 + c : a, ok);
    }
  }
}

template <typename TO, bool FOLD>
__global__ void __launch_bounds__(F_THREADS, FOLD ? 1 : 2)
syrk_ffma_kernel(const float* a, long long lda, TO* g, long long ldg, int m,
                 int n, int nt, int vec_ok) {
  extern __shared__ __align__(16) float fsm[];
  int ti, tj;
  pair_of(blockIdx.x, nt, ti, tj);
  const int i0 = ti * T, j0 = tj * T;
  const bool diag = ti == tj;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[8][8];
  float acc2[FOLD ? 8 : 1][FOLD ? 8 : 1];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if constexpr (FOLD) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc2[i][j] = 0.f;
  }

  const int kt_n = (m + F_BK - 1) / F_BK;
  const bool fast_i = vec_ok && i0 + T <= n, fast_j = vec_ok && j0 + T <= n;
  auto ring_a = [&](int s) { return fsm + s * 2 * F_BK * T; };
  auto load = [&](int kt) {
    const int s = kt % F_STAGES, k0 = kt * F_BK;
    const bool rows = k0 + F_BK <= m;
    load_slab(ring_a(s), a, lda, m, n, k0, i0, fast_i && rows, tid);
    if (!diag)
      load_slab(ring_a(s) + F_BK * T, a, lda, m, n, k0, j0, fast_j && rows,
                tid);
  };

#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < kt_n) load(s);
    cp_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_wait<F_STAGES - 2>();
    __syncthreads();  // slab kt landed; slab kt - 1 is no longer read
    if (kt + F_STAGES - 1 < kt_n) load(kt + F_STAGES - 1);
    cp_commit();
    const float* as = ring_a(kt % F_STAGES);
    const float* bs = diag ? as : as + F_BK * T;
#pragma unroll
    for (int k = 0; k < F_BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * T + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + k * T + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * T + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + k * T + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if constexpr (FOLD) {
      const int k_end = (kt + 1) * F_BK;
      if (k_end % FOLD_ROWS == 0 && k_end < m) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc2[i][j] += acc[i][j];
            acc[i][j] = 0.f;
          }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring becomes the staging tile
  float* st = fsm;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = (i < 4 ? 0 : 64) + ty * 4 + i % 4;
      const int c = (j < 4 ? 0 : 64) + tx * 4 + j % 4;
      float v = acc[i][j];
      if constexpr (FOLD) v = acc2[i][j] + acc[i][j];
      st[r * ST + c] = v;
    }
  __syncthreads();
  store_mirrored<TO>(st, g, ldg, n, i0, j0, tid, F_THREADS);
}

// ---------------------------------------------------------------------------
// 'high' / 'default': split pass + wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int W_BK = 64;  // contraction rows per stage: one 128-byte row
constexpr int W_THREADS = 384;  // consumer warpgroups 0-1, producer 2
constexpr int TILE_BYTES = T * W_BK * 2;  // one 128 x 64 bf16 operand tile
constexpr int PROMO_ROWS = 128;  // contraction rows per promotion interval
constexpr int PSTEPS = PROMO_ROWS / 16;  // k16 steps per promotion interval

__host__ __device__ constexpr int w_stages(int npass) {
  return npass == 3 ? 3 : 4;
}
__host__ __device__ constexpr int w_ops(int npass) {
  return npass == 3 ? 4 : 2;  // A_hi, B_hi (, A_lo, B_lo)
}
constexpr size_t w_smem(int npass) {
  return static_cast<size_t>(w_stages(npass)) * w_ops(npass) * TILE_BYTES +
         2 * w_stages(npass) * sizeof(uint64_t) + 1024;  // + alignment
}
static_assert(STAGE_BYTES <= 2 * 4 * TILE_BYTES, "staging fits the ring");

// split: hi[c][k] (and lo[c][k]) of A[k][c], zero-padded to n_pad x m_pad
template <typename TI, bool LO>
__global__ void split_kernel(const TI* a, long long lda, int m, int n,
                             __nv_bfloat16* hi, __nv_bfloat16* lo,
                             int m_pad) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int q = 0; q < 32; q += 8) {
    const int k = k0 + ty + q, c = c0 + tx;
    tile[ty + q][tx] =
        (k < m && c < n) ? to_f32(a[(long long)k * lda + c]) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 32; q += 8) {
    const float x = tile[tx][ty + q];
    const long long o = (long long)(c0 + ty + q) * m_pad + k0 + tx;
    if (LO) {
      const float h = bf16_hi(x);
      hi[o] = __float2bfloat16_rn(h);  // exact: h is on the bf16 grid
      lo[o] = __float2bfloat16_rn(x - h);
    } else {
      hi[o] = __float2bfloat16_rn(x);
    }
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// wait for the completion of the barrier's phase with this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int k, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads across a wait
__device__ __forceinline__ void reg_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define CAP_F8(i)                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A (64 x 16, K-major) * B^T (128 x 16, K-major); scale_d = 0 starts
// from zero
__device__ __forceinline__ void wgmma_64x128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : CAP_F8(0), CAP_F8(8), CAP_F8(16), CAP_F8(24), CAP_F8(32), CAP_F8(40),
        CAP_F8(48), CAP_F8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int NPASS, typename TO>
__global__ void __launch_bounds__(W_THREADS, 1)
syrk_wgmma_kernel(const __grid_constant__ CUtensorMap hi_map,
                  const __grid_constant__ CUtensorMap lo_map, TO* g,
                  long long ldg, int m, int n, int nt, int kt_n) {
  constexpr int S = w_stages(NPASS), OPS = w_ops(NPASS);
  extern __shared__ uint8_t wsm_raw[];
  uint8_t* base = wsm_raw + ((1024 - (smem_u32(wsm_raw) & 1023)) & 1023);
  auto tile = [&](int s, int op) { return base + (s * OPS + op) * TILE_BYTES; };
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S * OPS * TILE_BYTES);
  uint64_t* empty = full + S;

  int ti, tj;
  pair_of(blockIdx.x, nt, ti, tj);
  const int i0 = ti * T, j0 = tj * T;
  const bool diag = ti == tj;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128) {
      const int bytes = (diag ? 1 : 2) * (NPASS == 3 ? 2 : 1) * TILE_BYTES;
      for (int kt = 0; kt < kt_n; ++kt) {
        const int s = kt % S, k0 = kt * W_BK;
        if (kt >= S) mbar_wait(&empty[s], (kt / S - 1) & 1);
        mbar_expect_tx(&full[s], bytes);
        tma_load(tile(s, 0), &hi_map, k0, i0, &full[s]);
        if (!diag) tma_load(tile(s, 1), &hi_map, k0, j0, &full[s]);
        if (NPASS == 3) {
          tma_load(tile(s, 2), &lo_map, k0, i0, &full[s]);
          if (!diag) tma_load(tile(s, 3), &lo_map, k0, j0, &full[s]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128;  // this warpgroup's 64 rows
    float part[64], run[64], fold[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = run[i] = fold[i] = 0.f;
    const int steps = kt_n * (W_BK / 16);
    for (int kt = 0; kt < kt_n; ++kt) {
      const int s = kt % S;
      mbar_wait(&full[s], (kt / S) & 1);
      const uint64_t dah = wg_desc(tile(s, 0) + wg * 64 * 128);
      const uint64_t dbh = wg_desc(tile(s, diag ? 0 : 1));
      const uint64_t dal = wg_desc(tile(s, NPASS == 3 ? 2 : 0) + wg * 64 * 128);
      const uint64_t dbl = wg_desc(tile(s, NPASS == 3 ? (diag ? 2 : 3) : 0));
#pragma unroll
      for (int kk = 0; kk < W_BK / 16; ++kk) {
        const int step = kt * (W_BK / 16) + kk;
        const uint64_t o = 2 * kk;  // 32 bytes along K, in 16-byte units
        reg_fence(part);
        wg_fence();
        wgmma_64x128(part, dah + o, dbh + o, step % PSTEPS != 0);
        if (NPASS == 3) {
          wgmma_64x128(part, dah + o, dbl + o, 1);
          wgmma_64x128(part, dal + o, dbh + o, 1);
        }
        wg_commit();
        if ((step + 1) % PSTEPS == 0 || step + 1 == steps) {
          wg_wait0();
          reg_fence(part);
#pragma unroll
          for (int i = 0; i < 64; ++i) run[i] += part[i];
        }
      }
      wg_wait0();  // every wgmma reading stage s is done: release it
      reg_fence(part);
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
      const int k_end = (kt + 1) * W_BK;
      if (k_end % FOLD_ROWS == 0 && k_end < m) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          fold[i] += run[i];
          run[i] = 0.f;
        }
      }
    }
    // both consumer warpgroups are past the ring: it becomes the staging
    // tile (the producer issued no load that was not consumed)
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    float* st = reinterpret_cast<float*>(base);
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = wg * 64 + warp * 16 + lane / 4 + 8 * ((i >> 1) & 1);
      const int c = (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
      st[r * ST + c] = fold[i] + run[i];
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    store_mirrored<TO>(st, g, ldg, n, i0, j0, threadIdx.x, 2 * 128);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which this library does not
// link (only the runtime), so it is looked up through the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// map of a packed n_pad x m_pad bf16 copy, boxes of 128 rows x 64 columns
cudaError_t make_map(CUtensorMap* map, void* p, int m_pad, int n_pad) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(m_pad),
                              static_cast<cuuint64_t>(n_pad)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(m_pad) * 2};
  const cuuint32_t box[2] = {W_BK, T};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, dims,
                         strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename TO, bool FOLD>
int launch_ffma(const float* a, long long lda, TO* g, long long ldg, int m,
                int n, int nt, cudaStream_t s) {
  auto k = syrk_ffma_kernel<TO, FOLD>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(F_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_ok = (reinterpret_cast<uintptr_t>(a) % 16 == 0) && lda % 4 == 0;
  k<<<nt * (nt + 1) / 2, F_THREADS, F_SMEM, s>>>(a, lda, g, ldg, m, n, nt,
                                                  vec_ok);
  return static_cast<int>(cudaGetLastError());
}

template <int NPASS, typename TO>
int launch_wgmma(const CUtensorMap& hi, const CUtensorMap& lo, TO* g,
                 long long ldg, int m, int n, int nt, int kt_n,
                 cudaStream_t s) {
  auto k = syrk_wgmma_kernel<NPASS, TO>;
  const size_t bytes = w_smem(NPASS);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<nt * (nt + 1) / 2, W_THREADS, bytes, s>>>(hi, lo, g, ldg, m, n, nt,
                                                 kt_n);
  return static_cast<int>(cudaGetLastError());
}

// n_pad x m_pad: n to the output tile, m to the stage
int n_padded(int n) { return (n + T - 1) / T * T; }
int m_padded(int m) { return (m + W_BK - 1) / W_BK * W_BK; }

template <typename TO>
int run(int bf16_in, int prec, const void* a, long long lda, TO* g,
        long long ldg, int m, int n, void* scratch, cudaStream_t s) {
  const int nt = (n + T - 1) / T;
  if (prec == PREC_HIGHEST) {
    if (bf16_in) return static_cast<int>(cudaErrorInvalidValue);
    const float* af = static_cast<const float*>(a);
    return m > FOLD_ROWS
               ? launch_ffma<TO, true>(af, lda, g, ldg, m, n, nt, s)
               : launch_ffma<TO, false>(af, lda, g, ldg, m, n, nt, s);
  }
  if (prec != PREC_HIGH && prec != PREC_DEFAULT)
    return static_cast<int>(cudaErrorInvalidValue);
  const int npass = (prec == PREC_HIGH && !bf16_in) ? 3 : 1;
  const int n_pad = n_padded(n), m_pad = m_padded(m);
  auto* hi = static_cast<__nv_bfloat16*>(scratch);
  auto* lo = hi + static_cast<size_t>(n_pad) * m_pad;
  CUtensorMap hi_map, lo_map;
  cudaError_t err = make_map(&hi_map, hi, m_pad, n_pad);
  if (err == cudaSuccess)
    err = make_map(&lo_map, npass == 3 ? lo : hi, m_pad, n_pad);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kt_n = m_pad / W_BK;
  if (npass == 3)
    return launch_wgmma<3, TO>(hi_map, lo_map, g, ldg, m, n, nt, kt_n, s);
  return launch_wgmma<1, TO>(hi_map, lo_map, g, ldg, m, n, nt, kt_n, s);
}

}  // namespace

// The split pass: packs a (m x n, row stride lda, unit column stride; bf16
// if bf16_in, else f32) into scratch K-major as hi and, when lo != 0 (f32
// input at 'high'), lo right after it, each n_pad x m_pad bf16 (n_pad = n
// rounded up to 128, m_pad = m rounded up to 64, zeros in the padding).
// Returns a cudaError_t.
extern "C" int capital_syrk_split(int bf16_in, int lo, const void* a,
                                  long long lda, int m, int n, void* scratch,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1 || (bf16_in && lo))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_pad = n_padded(n), m_pad = m_padded(m);
  auto* h = static_cast<__nv_bfloat16*>(scratch);
  auto* l = h + static_cast<size_t>(n_pad) * m_pad;
  const dim3 grid(m_pad / 32, n_pad / 32), block(32, 8);
  if (bf16_in)
    split_kernel<__nv_bfloat16, false><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), lda, m, n, h, l, m_pad);
  else if (lo)
    split_kernel<float, true><<<grid, block, 0, s>>>(
        static_cast<const float*>(a), lda, m, n, h, l, m_pad);
  else
    split_kernel<float, false><<<grid, block, 0, s>>>(
        static_cast<const float*>(a), lda, m, n, h, l, m_pad);
  return static_cast<int>(cudaGetLastError());
}

// a: m x n with row stride lda and unit column stride, read at 'highest';
// g: n x n output with row stride ldg. bf16_in / bf16_out select bf16
// (else f32) for a / g. scratch: at 'high' / 'default' a's packed copy as
// capital_syrk_split wrote it (with lo for f32 input at 'high'); unused at
// 'highest'. Returns a cudaError_t.
extern "C" int capital_syrk_upper(int bf16_in, int bf16_out, int prec,
                                  const void* a, long long lda, void* g,
                                  long long ldg, int m, int n, void* scratch,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16_out)
    return run(bf16_in, prec, a, lda, static_cast<__nv_bfloat16*>(g), ldg, m,
               n, scratch, s);
  return run(bf16_in, prec, a, lda, static_cast<float*>(g), ldg, m, n,
             scratch, s);
}
