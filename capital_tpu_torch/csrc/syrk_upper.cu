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
// The pieces (hopper_mma.cuh, shared with TRMM):
// 'high' / 'default': the pack pass first writes A's K-major bf16 copy
// (hi, and lo at 'high') into the caller's scratch -- every element split
// once, not once per output tile as in the first version; both operands of
// the Gram are the same A, so one copy feeds both. Then the wgmma kernel
// sums it through the TMA ring; diagonal tiles load one operand and read it
// twice.
// 'highest' (f32 FFMA, never TF32): the cp.async ring reads A in place;
// bound tests only on edge tiles (4-byte cp.async with zero fill).
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W), 16384^2 window:
// 'high' 25.4 ms (bound 13.3 ms, 52 %; Bt @ B 161.9 ms; the first version
// 191.8 ms), 'highest' 99.7 ms (bound 65.6 ms, 66 %; Bt @ B 160.6 ms; the
// first version 269.1 ms). The 512^2 calls (10 tiles on 132 SMs) take
// 0.043 / 0.068 ms against the library's 0.025 / 0.030 ms.
#include "hopper_mma.cuh"

using namespace capital;

namespace {

// Contraction rows per first-level accumulator of the two-level sum
// (32 row chunks of 512, capital_tpu/ops/pallas_syrk.py:65-68).
constexpr int FOLD_ROWS = 32 * 512;

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

template <typename TO, bool FOLD>
__global__ void __launch_bounds__(F_THREADS, FOLD ? 1 : 2)
syrk_ffma_kernel(const float* a, long long lda, TO* g, long long ldg, int m,
                 int n, int nt, int vec_ok) {
  extern __shared__ __align__(16) float fsm[];
  int ti, tj;
  pair_of(blockIdx.x, nt, ti, tj);
  const int i0 = ti * T, j0 = tj * T;
  const int tid = threadIdx.x;

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

  const bool fast_i = vec_ok && i0 + T <= n, fast_j = vec_ok && j0 + T <= n;
  auto load = [&](int kt, float* da, float* db) {
    const int k0 = kt * F_BK;
    const bool rows = k0 + F_BK <= m;
    load_slab(da, a, lda, m, n, k0, i0, fast_i && rows, tid);
    if (db != da) load_slab(db, a, lda, m, n, k0, j0, fast_j && rows, tid);
  };
  auto fold = [&](int kt) {
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
  };
  ffma_ring(fsm, (m + F_BK - 1) / F_BK, ti == tj, acc, load, fold);

  // the ring becomes the staging tile
  float* st = fsm;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[i][j];
      if constexpr (FOLD) v = acc2[i][j] + acc[i][j];
      st[ffma_row(i) * ST + ffma_col(j)] = v;
    }
  __syncthreads();
  store_mirrored<TO>(st, g, ldg, n, i0, j0, tid, F_THREADS);
}

// ---------------------------------------------------------------------------
// 'high' / 'default': wgmma over the packed copy
// ---------------------------------------------------------------------------

template <int NPASS, typename TO>
__global__ void __launch_bounds__(W_THREADS, 1)
syrk_wgmma_kernel(const __grid_constant__ CUtensorMap hi_map,
                  const __grid_constant__ CUtensorMap lo_map, TO* g,
                  long long ldg, int m, int n, int nt, int kt_n) {
  extern __shared__ uint8_t wsm_raw[];
  const WRing<NPASS> ring(wsm_raw);
  int ti, tj;
  pair_of(blockIdx.x, nt, ti, tj);
  const int i0 = ti * T, j0 = tj * T;
  const bool diag = ti == tj;
  ring.init();

  if (threadIdx.x >= 2 * 128) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128) {
      const CUtensorMap* hm = &hi_map;
      const CUtensorMap* lm = &lo_map;
      const int bytes = (diag ? 1 : 2) * (NPASS == 3 ? 2 : 1) * TILE_BYTES;
      ring.produce(kt_n, bytes, [&](int s, int kt, uint64_t* bar) {
        const int k0 = kt * W_BK;
        tma_load(ring.tile(s, 0), hm, k0, i0, bar);
        if (!diag) tma_load(ring.tile(s, 1), hm, k0, j0, bar);
        if (NPASS == 3) {
          tma_load(ring.tile(s, 2), lm, k0, i0, bar);
          if (!diag) tma_load(ring.tile(s, 3), lm, k0, j0, bar);
        }
      });
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float part[64], run[64], fold[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = run[i] = fold[i] = 0.f;
    ring.consume(kt_n, diag ? 0 : 1, diag ? 2 : 3, part, run, [&](int kt) {
      const int k_end = (kt + 1) * W_BK;
      if (k_end % FOLD_ROWS == 0 && k_end < m) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          fold[i] += run[i];
          run[i] = 0.f;
        }
      }
    });
    // both consumer warpgroups are past the ring: it becomes the staging
    // tile (the producer issued no load that was not consumed)
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    float* st = reinterpret_cast<float*>(ring.base);
#pragma unroll
    for (int i = 0; i < 64; ++i)
      st[frag_row(i) * ST + frag_col(i)] = fold[i] + run[i];
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    store_mirrored<TO>(st, g, ldg, n, i0, j0, threadIdx.x, 2 * 128);
  }
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
  // the packed copy: n_pad x m_pad planes (capital::pack, along A's rows)
  const int n_pad = pad_up(n, T), m_pad = pad_up(m, W_BK);
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

// a: m x n with row stride lda and unit column stride, read at 'highest';
// g: n x n output with row stride ldg. bf16_in / bf16_out select bf16
// (else f32) for a / g. scratch: at 'high' / 'default' a's packed copy as
// capital_pack wrote it along a's rows (with lo for f32 input at 'high');
// unused at 'highest'. Returns a cudaError_t.
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
