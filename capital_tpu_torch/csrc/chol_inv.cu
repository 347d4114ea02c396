// Fused blocked Cholesky + triangular inverse of one SPD leaf block.
//
// Replaces capital_tpu/ops/pallas_chol.py::chol_inv_pallas (pallas_call at
// :153; bodies _kernel :94 and _micro_chol_inv :52). For each 128-wide
// panel k of an n x n block (128 | n):
//   1. micro-Cholesky of the diagonal block M_kk by 128 rank-1 steps that
//      also build E = R_kk^{-T} (Gauss-Jordan on the identity), pivot
//      clamped at max(d^2, 1e-30);
//   2. slab R[k, k:] = E @ M[k, k:]  ([R_kk | R_{k,>k}]);
//   3. trailing update M[>k, >k] -= R[k, >k]^T R[k, >k];
//   4. inverse, left-looking: Rinv[:k, k] = -(Rinv[:k, :k] R[:k, k]) E^T,
//      then Rinv_kk = E^T.
// The caller masks both outputs with triu. All arithmetic is f32 FFMA.
//
// The TPU kernel keeps three n^2 f32 buffers in VMEM (12 MB at n = 1024);
// an SM has 227 KB. So only the 128x128 micro-factorization stays on chip
// (M_kk and E in 2 x 64 KB of dynamic shared memory, one CTA), and steps
// 2-4 are small FFMA tile products whose operands live in L2 (3 MB at
// n = 512, well inside the 50 MB L2). Steps 2-4 touch only the blocks
// that are nonzero in exact arithmetic, where the TPU kernel runs full-
// width slabs to keep its shapes static.
//
// Bound: ~2n^3/3 useful flops over 3 n^2 f32 of traffic; at n = 512 the
// leaf is latency-bound by its 128 dependent rank-1 steps per panel and
// by the few CTAs its small products fill. This first version accepts
// that; the leaf is 64 calls per factor at n = 32768.
#include "tile_dot.cuh"

using namespace capital;

namespace {

constexpr int PB = 128;  // panel width
constexpr int MICRO_THREADS = 1024;
constexpr size_t MICRO_SMEM = (2 * PB * PB + 3 * PB) * sizeof(float);

__global__ void __launch_bounds__(MICRO_THREADS)
micro_chol_kernel(const float* m_in, long long ldm, float* e_out) {
  extern __shared__ float sm[];
  float* m = sm;             // M_kk, eliminated in place
  float* e = m + PB * PB;    // E, from the identity
  float* rowv = e + PB * PB; // pivot row of M, before step j
  float* colv = rowv + PB;   // pivot column of M, before step j
  float* erow = colv + PB;   // row j of E, before step j
  const int tid = threadIdx.x;
  for (int idx = tid; idx < PB * PB; idx += MICRO_THREADS) {
    const int r = idx / PB, c = idx % PB;
    m[idx] = m_in[(long long)r * ldm + c];
    e[idx] = r == c ? 1.f : 0.f;
  }
  for (int j = 0; j < PB; ++j) {
    __syncthreads();
    if (tid < PB) {
      rowv[tid] = m[j * PB + tid];
      colv[tid] = m[tid * PB + j];
      erow[tid] = e[j * PB + tid];
    }
    __syncthreads();
    const float dinv = 1.0f / sqrtf(fmaxf(rowv[j], 1e-30f));
    for (int idx = tid; idx < PB * PB; idx += MICRO_THREADS) {
      const int r = idx / PB, c = idx % PB;
      const float rc = colv[r] * dinv;  // r_j as a column (r >= j)
      if (r >= j && c >= j) m[idx] -= rc * (rowv[c] * dinv);
      const float er = erow[c] * dinv;
      if (r == j) e[idx] = er;
      else if (r > j) e[idx] -= rc * er;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < PB * PB; idx += MICRO_THREADS) e_out[idx] = e[idx];
}

struct GemmArgs {
  Operand<float> A, B;
  float* C;
  long long ldc;
  int M, N, K;
  float alpha, beta;
};

// C = alpha * A @ B + beta * C on 64x64 tiles (more CTAs for leaf shapes)
__global__ void __launch_bounds__(THREADS) leaf_gemm_kernel(GemmArgs g) {
  const int i0 = blockIdx.y * 64, j0 = blockIdx.x * 64;
  auto epi = [&](int r, int c, float v) {
    if (r < g.M && c < g.N) {
      float* p = g.C + (long long)r * g.ldc + c;
      *p = g.beta == 0.f ? g.alpha * v : g.alpha * v + g.beta * *p;
    }
  };
  ffma_tile<float, 64, 64, 16, 4, 4, false>(g.A, g.B, g.M, g.N, g.K, i0, j0,
                                            0, g.K, epi);
}

__global__ void transpose_kernel(const float* e, float* out, long long ldo) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < PB * PB) {
    const int r = idx / PB, c = idx % PB;
    out[(long long)r * ldo + c] = e[c * PB + r];
  }
}

void gemm(Operand<float> a, Operand<float> b, float* c, long long ldc, int m,
          int n, int k, float alpha, float beta, cudaStream_t s) {
  GemmArgs g{a, b, c, ldc, m, n, k, alpha, beta};
  dim3 grid((n + 63) / 64, (m + 63) / 64);
  leaf_gemm_kernel<<<grid, THREADS, 0, s>>>(g);
}

}  // namespace

// m: the n x n input, copied by the caller (overwritten); r, rinv: n x n,
// zero on entry; e: 128 x 128 scratch; t: n x 128 scratch. All contiguous
// f32. Returns a cudaError_t.
extern "C" int capital_chol_inv(float* m, float* r, float* rinv, float* e,
                                float* t, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n % PB) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      micro_chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(MICRO_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ld = n;
  for (int kb = 0; kb < n; kb += PB) {
    const int k1 = kb + PB;
    micro_chol_kernel<<<1, MICRO_THREADS, MICRO_SMEM, s>>>(m + kb * ld + kb,
                                                           ld, e);
    // slab: R[k, kb:] = E @ M[k, kb:]
    gemm({e, PB, 1, KEEP_ALL}, {m + kb * ld + kb, ld, 1, KEEP_ALL},
         r + kb * ld + kb, ld, PB, n - kb, PB, 1.f, 0.f, s);
    if (k1 < n)  // trailing: M[k1:, k1:] -= P^T P with P = R[k, k1:]
      gemm({r + kb * ld + k1, 1, ld, KEEP_ALL},
           {r + kb * ld + k1, ld, 1, KEEP_ALL}, m + k1 * ld + k1, ld, n - k1,
           n - k1, PB, -1.f, 1.f, s);
    if (kb > 0) {
      // T = Rinv[:kb, :kb] @ R[:kb, k];  Rinv[:kb, k] = -T @ E^T
      gemm({rinv, ld, 1, KEEP_ALL}, {r + kb, ld, 1, KEEP_ALL}, t, PB, kb, PB,
           kb, 1.f, 0.f, s);
      gemm({t, PB, 1, KEEP_ALL}, {e, 1, PB, KEEP_ALL}, rinv + kb, ld, kb, PB,
           PB, -1.f, 0.f, s);
    }
    transpose_kernel<<<PB * PB / 256, 256, 0, s>>>(e, rinv + kb * ld + kb, ld);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
