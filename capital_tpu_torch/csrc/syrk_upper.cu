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
// at ~(m/FOLD_ROWS + FOLD_ROWS/32) eps instead of m/32 eps.
//
// Each tile is written with its mirror. Only entries with row <= col are
// written from their own sum; the entry below the diagonal is the same
// value mirrored, so G is bitwise symmetric. The leaf reads a pivot column
// as the pivot row's transpose, so an asymmetric Schur complement would
// feed it inconsistent values.
//
// Bound: m*n^2 multiply-adds against reading A once and writing n^2
// outputs: compute-bound at the main path's shapes.
#include "tile_dot.cuh"

using namespace capital;

namespace {

template <typename T, typename TO, int PREC>
__global__ void __launch_bounds__(THREADS)
syrk_kernel(Operand<T> at, Operand<T> a, TO* g, long long ldg, int m, int n,
            int nt) {
  int p = blockIdx.x, i = 0;  // upper tile pair number -> (i, j), i <= j
  while (p >= nt - i) { p -= nt - i; ++i; }
  const int j = i + p;
  auto epi = [&](int r, int c, float v) {
    if (r <= c && c < n) {
      const TO o = from_f32<TO>(v);
      g[(long long)r * ldg + c] = o;
      g[(long long)c * ldg + r] = o;
    }
  };
  tile_dot<T, PREC, true>(at, a, n, n, m, i * 128, j * 128, 0, m, epi);
}

template <typename T, typename TO>
int launch(int prec, const void* a, long long lda, void* g, long long ldg,
           int m, int n, cudaStream_t stream) {
  const T* p = static_cast<const T*>(a);
  const Operand<T> at{p, 1, lda, KEEP_ALL};  // A^T: (i, k) at a[k*lda + i]
  const Operand<T> aa{p, lda, 1, KEEP_ALL};
  const int nt = (n + 127) / 128;
  const int pairs = nt * (nt + 1) / 2;
  TO* out = static_cast<TO*>(g);
  switch (prec) {
    case PREC_HIGHEST:
      syrk_kernel<T, TO, PREC_HIGHEST><<<pairs, THREADS, 0, stream>>>(
          at, aa, out, ldg, m, n, nt);
      break;
    case PREC_HIGH:
      syrk_kernel<T, TO, PREC_HIGH><<<pairs, THREADS, 0, stream>>>(
          at, aa, out, ldg, m, n, nt);
      break;
    case PREC_DEFAULT:
      syrk_kernel<T, TO, PREC_DEFAULT><<<pairs, THREADS, 0, stream>>>(
          at, aa, out, ldg, m, n, nt);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: m x n with row stride lda and unit column stride; g: n x n output with
// row stride ldg. bf16_in / bf16_out select bf16 (else f32) for a / g.
// Returns a cudaError_t.
extern "C" int capital_syrk_upper(int bf16_in, int bf16_out, int prec,
                                  const void* a, long long lda, void* g,
                                  long long ldg, int m, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_in && bf16_out)
    return launch<__nv_bfloat16, __nv_bfloat16>(prec, a, lda, g, ldg, m, n, s);
  if (bf16_in)
    return launch<__nv_bfloat16, float>(prec, a, lda, g, ldg, m, n, s);
  if (bf16_out)
    return launch<float, __nv_bfloat16>(prec, a, lda, g, ldg, m, n, s);
  return launch<float, float>(prec, a, lda, g, ldg, m, n, s);
}
