// Device-side tile product of the TRMM kernel, and the helpers (precision
// codes, bf16 conversions and split, error strings) all kernels share.
//
// Counterpart of capital_tpu/ops/pallas_dot.py::tile_dot, the in-kernel
// product helper of the TPU's triangle kernels. One CTA of 256 threads
// computes one 128x128 (or 64x64) output tile C[i0:, j0:] =
// sum_{k in [klo, khi)} A[i, k] * B[k, j] over operands given as a base
// pointer and two strides, so windows of a workspace and transposed
// operands cost no copy. An operand may keep only its upper or lower
// triangle (the diagonal-tile mask of the TPU kernels); entries outside the
// bounds or the triangle load as zero, which also masks ragged edges.
//
// Precision ladder (the reference's, restated for this card):
//   PREC_HIGHEST  f32 FFMA (ffma_tile); never TF32.
//   PREC_HIGH     hi = RNE bf16(x), lo = bf16(x - hi); three bf16 tensor-
//                 core products with f32 accumulation: hi*hi + hi*lo +
//                 lo*hi (tc_tile<T, 3>).
//   PREC_DEFAULT  one bf16 pass (tc_tile<T, 1>); bf16 inputs always.
//
// What bounds it: at the main path's shapes (16384-wide windows) the work
// is compute-bound. This first version stages each K-slab through shared
// memory with plain loads and runs nvcuda::wmma 16x16x16 bf16 fragments
// (or an 8x8-per-thread FFMA micro-tile); wgmma, TMA and a multi-stage
// pipeline are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace capital {

enum Prec { PREC_HIGHEST = 0, PREC_HIGH = 1, PREC_DEFAULT = 2 };
// which triangle of an operand is kept, in the operand's (row, col) indices
enum Keep { KEEP_ALL = 0, KEEP_UPPER = 1 /* row <= col */,
            KEEP_LOWER = 2 /* row >= col */ };

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
struct Operand {
  const T* p;
  long long rs, cs;  // element (r, c) lives at p[r * rs + c * cs]
  int keep;
  __device__ __forceinline__ float get(int r, int c, int nr, int nc) const {
    if (r >= nr || c >= nc) return 0.f;
    if (keep == KEEP_UPPER && r > c) return 0.f;
    if (keep == KEEP_LOWER && r < c) return 0.f;
    return to_f32(p[(long long)r * rs + (long long)c * cs]);
  }
};

// x rounded to nearest-even on the bf16 grid, bit for bit as
// capital_tpu/ops/pallas_dot.py::_split_f32 does it.
__device__ __forceinline__ float bf16_hi(float x) {
  uint32_t u = __float_as_uint(x);
  u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
  return __uint_as_float(u);
}

template <int NPASS>
__device__ __forceinline__ void split_store(float x, __nv_bfloat16& hi,
                                            __nv_bfloat16& lo) {
  if (NPASS == 3) {
    float h = bf16_hi(x);
    hi = __float2bfloat16_rn(h);  // exact: h is on the bf16 grid
    lo = __float2bfloat16_rn(x - h);
  } else {
    hi = __float2bfloat16_rn(x);
  }
}

// Tensor-core tile: 128x128 output, K-slab 32, 8 warps of 32x64 each.
constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 32;

template <typename T, int NPASS, class Epi>
__device__ void tc_tile(const Operand<T>& A, const Operand<T>& B, int M,
                        int N, int K, int i0, int j0, int klo, int khi,
                        Epi epi) {
  using namespace nvcuda;
  constexpr int LDA = TC_BK + 8, LDB = TC_BN + 8;
  __shared__ __align__(32) __nv_bfloat16 a_hi[TC_BM * LDA];
  __shared__ __align__(32) __nv_bfloat16 a_lo[NPASS == 3 ? TC_BM * LDA : 16];
  __shared__ __align__(32) __nv_bfloat16 b_hi[TC_BK * LDB];
  __shared__ __align__(32) __nv_bfloat16 b_lo[NPASS == 3 ? TC_BK * LDB : 16];
  __shared__ __align__(32) float stage[THREADS / 32][16 * 16];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;  // warp tile: rows wm*32, cols wn*64

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = klo; k0 < khi; k0 += TC_BK) {
    __syncthreads();
    for (int idx = tid; idx < TC_BM * TC_BK; idx += THREADS) {
      int ii, kk;  // walk the operand's contiguous axis across threads
      if (A.cs == 1) { kk = idx % TC_BK; ii = idx / TC_BK; }
      else { ii = idx % TC_BM; kk = idx / TC_BM; }
      float x = A.get(i0 + ii, k0 + kk, M, K);
      __nv_bfloat16 lo;
      split_store<NPASS>(x, a_hi[ii * LDA + kk], lo);
      if (NPASS == 3) a_lo[ii * LDA + kk] = lo;
    }
    for (int idx = tid; idx < TC_BK * TC_BN; idx += THREADS) {
      int kk, jj;
      if (B.cs == 1) { jj = idx % TC_BN; kk = idx / TC_BN; }
      else { kk = idx % TC_BK; jj = idx / TC_BK; }
      float x = B.get(k0 + kk, j0 + jj, K, N);
      __nv_bfloat16 lo;
      split_store<NPASS>(x, b_hi[kk * LDB + jj], lo);
      if (NPASS == 3) b_lo[kk * LDB + jj] = lo;
    }
    __syncthreads();
    // The tensor cores' own f32 accumulation is not IEEE round-to-nearest
    // (measured on the card: a 17000-deep chain drifts ~1e-4 from an f32
    // sum), so each slab's products go into a fresh fragment and are then
    // promoted into the running sum with ordinary f32 adds.
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> part;
        wmma::fill_fragment(part, 0.f);
#pragma unroll
        for (int kk = 0; kk < TC_BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa_hi, fa_lo;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb_hi, fb_lo;
          const int oa = (wm * 32 + i * 16) * LDA + kk;
          const int ob = kk * LDB + wn * 64 + j * 16;
          wmma::load_matrix_sync(fa_hi, a_hi + oa, LDA);
          wmma::load_matrix_sync(fb_hi, b_hi + ob, LDB);
          wmma::mma_sync(part, fa_hi, fb_hi, part);
          if (NPASS == 3) {
            wmma::load_matrix_sync(fa_lo, a_lo + oa, LDA);
            wmma::load_matrix_sync(fb_lo, b_lo + ob, LDB);
            wmma::mma_sync(part, fa_hi, fb_lo, part);
            wmma::mma_sync(part, fa_lo, fb_hi, part);
          }
        }
#pragma unroll
        for (int t = 0; t < part.num_elements; ++t)
          acc[i][j].x[t] += part.x[t];
      }
  }

  // fragments go through a per-warp staging tile so each lane knows the
  // (row, col) of the values it hands to the epilogue
  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        epi(i0 + wm * 32 + i * 16 + e / 16, j0 + wn * 64 + j * 16 + e % 16,
            st[e]);
      __syncwarp();
    }
}

// FFMA tile: BM x BN output, K-slab BK, each thread a TM x TN micro-tile
// at rows ty + r * (BM / TM) and cols tx + c * (BN / TN).
template <typename T, int BM, int BN, int BK, int TM, int TN, class Epi>
__device__ void ffma_tile(const Operand<T>& A, const Operand<T>& B, int M,
                          int N, int K, int i0, int j0, int klo, int khi,
                          Epi epi) {
  constexpr int TX = BN / TN, TY = BM / TM;
  static_assert(TX * TY == THREADS, "one micro-tile per thread");
  __shared__ float as[BK][BM + 4];
  __shared__ float bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = klo; k0 < khi; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      int ii, kk;
      if (A.cs == 1) { kk = idx % BK; ii = idx / BK; }
      else { ii = idx % BM; kk = idx / BM; }
      as[kk][ii] = A.get(i0 + ii, k0 + kk, M, K);
    }
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      int kk, jj;
      if (B.cs == 1) { jj = idx % BN; kk = idx / BN; }
      else { kk = idx % BK; jj = idx / BK; }
      bs[kk][jj] = B.get(k0 + kk, j0 + jj, K, N);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      epi(i0 + ty + i * TY, j0 + tx + j * TX, acc[i][j]);
}

// Tile product at a runtime-chosen precision level.
template <typename T, int PREC, class Epi>
__device__ __forceinline__ void tile_dot(const Operand<T>& A,
                                         const Operand<T>& B, int M, int N,
                                         int K, int i0, int j0, int klo,
                                         int khi, Epi epi) {
  if constexpr (PREC == PREC_HIGHEST)
    ffma_tile<T, 128, 128, 16, 8, 8>(A, B, M, N, K, i0, j0, klo, khi, epi);
  else
    tc_tile<T, PREC == PREC_HIGH ? 3 : 1>(A, B, M, N, K, i0, j0, klo, khi,
                                          epi);
}

}  // namespace capital

extern "C" const char* capital_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
