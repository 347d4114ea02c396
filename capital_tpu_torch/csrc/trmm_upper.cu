// Triangle-aware TRMM: multiply by upper-triangular U over the nonzero
// tiles only.
//
// Replaces capital_tpu/ops/pallas_trmm.py::trmm_upper (_trmm_upper_impl,
// pallas_call at :324; bodies _make_kernel :71 and the side-R kern :295).
//
//   side L          C = alpha * triu(U)   @ B   k >= i
//   side L, trans   C = alpha * triu(U)^T @ B   k <= i   (cholinv's TRSM step)
//   side R          C = alpha * B @ triu(U)     k <= j   (inverse assembly)
//   side R, trans   C = alpha * B @ triu(U)^T   k >= j   (QDWH's second product)
//
// The TPU kernel walks a sequential table of (output tile, k tile) pairs and
// carries each tile's sum in VMEM scratch. Here the grid is the 2-D set of
// 128x128 output tiles, blocks run in any order, and each CTA works out its
// own run of k inside the triangle and sums it in registers. U is read
// through (pointer, leading dimension) with its strictly lower entries
// masked while the diagonal tiles are staged into shared memory, so the
// transposed cases and the workspace windows of cholinv cost no copy.
// Ragged edges are masked in the same loads.
//
// Bound: m*n^2 multiply-adds (half a GEMM) against reading U's triangle and
// B once and writing C once: compute-bound at the main path's shapes (its
// arithmetic intensity is ~n/3 flop/byte). See tile_dot.cuh for what this
// first version does about it.
#include "tile_dot.cuh"

using namespace capital;

namespace {

template <typename T>
struct TrmmArgs {
  Operand<T> A, B;
  T* C;
  long long ldc;
  int M, N, K;
  float alpha;
};

template <typename T, int PREC>
__global__ void __launch_bounds__(THREADS) trmm_kernel(TrmmArgs<T> a) {
  const int i0 = blockIdx.y * 128, j0 = blockIdx.x * 128;
  // the k run of this output tile inside the triangle
  int klo = 0, khi = a.K;
  if (a.A.keep == KEEP_UPPER) klo = i0;                  // A[i,k]: i <= k
  if (a.A.keep == KEEP_LOWER) khi = min(a.K, i0 + 128);  // A[i,k]: k <= i
  if (a.B.keep == KEEP_UPPER) khi = min(a.K, j0 + 128);  // B[k,j]: k <= j
  if (a.B.keep == KEEP_LOWER) klo = j0;                  // B[k,j]: j <= k
  auto epi = [&](int r, int c, float v) {
    if (r < a.M && c < a.N)
      a.C[(long long)r * a.ldc + c] = from_f32<T>(a.alpha * v);
  };
  tile_dot<T, PREC>(a.A, a.B, a.M, a.N, a.K, i0, j0, klo, khi, epi);
}

template <typename T>
int launch(int prec, int side_r, int trans, const void* u, long long ldu,
           const void* b, long long ldb, void* c, long long ldc, int n, int m,
           float alpha, cudaStream_t stream) {
  TrmmArgs<T> a;
  const Operand<T> uu{static_cast<const T*>(u), ldu, 1, KEEP_UPPER};
  const Operand<T> ut{static_cast<const T*>(u), 1, ldu, KEEP_LOWER};  // U^T
  const Operand<T> bb{static_cast<const T*>(b), ldb, 1, KEEP_ALL};
  if (!side_r) {  // C (n x m) = op(U) @ B
    a.A = trans ? ut : uu;
    a.B = bb;
    a.M = n; a.N = m;
  } else {        // C (m x n) = B @ op(U)
    a.A = bb;
    a.B = trans ? ut : uu;
    a.M = m; a.N = n;
  }
  a.K = n;
  a.C = static_cast<T*>(c);
  a.ldc = ldc;
  a.alpha = alpha;
  dim3 grid((a.N + 127) / 128, (a.M + 127) / 128);
  switch (prec) {
    case PREC_HIGHEST:
      trmm_kernel<T, PREC_HIGHEST><<<grid, THREADS, 0, stream>>>(a); break;
    case PREC_HIGH:
      trmm_kernel<T, PREC_HIGH><<<grid, THREADS, 0, stream>>>(a); break;
    case PREC_DEFAULT:
      trmm_kernel<T, PREC_DEFAULT><<<grid, THREADS, 0, stream>>>(a); break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u: n x n (row stride ldu), b: n x m (side L) or m x n (side R) with row
// stride ldb, c: the output of b's shape with row stride ldc. All three
// have unit column stride. bf16 != 0 means every operand is bf16, else f32.
// Returns a cudaError_t.
extern "C" int capital_trmm_upper(int bf16, int prec, int side_r, int trans,
                                  const void* u, long long ldu, const void* b,
                                  long long ldb, void* c, long long ldc, int n,
                                  int m, float alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(prec, side_r, trans, u, ldu, b, ldb, c, ldc,
                                 n, m, alpha, s);
  return launch<float>(prec, side_r, trans, u, ldu, b, ldb, c, ldc, n, m,
                       alpha, s);
}
