// Triangle-aware TRMM: multiply by upper-triangular U over the nonzero
// tiles only.
//
// Replaces capital_tpu/ops/pallas_trmm.py::trmm_upper (_trmm_upper_impl,
// pallas_call at :324; bodies _make_kernel :71 and the side-R kern :295).
//
//   case      C =                      A operand    B operand    k run
//   L         alpha * triu(U)   @ B    U            B            k >= i
//   L,trans   alpha * triu(U)^T @ B    U^T          B            k <= i
//   R         alpha * B @ triu(U)      B            U            k <= j
//   R,trans   alpha * B @ triu(U)^T    B            U^T          k >= j
//
// L,trans is cholinv's TRSM step, R and L (alpha = -1) its inverse
// assembly; R,trans is QDWH's second product.
//
// The TPU kernel walks a sequential table of (output tile, k tile) pairs and
// carries each tile's sum in VMEM scratch. Here one CTA owns one 128x128
// output tile of a rectangular grid and sums its own run of k inside the
// triangle: [i0, K) for L, [0, i0 + 128) for L,trans, [0, j0 + 128) for R,
// [j0, K) for R,trans. Runs range from 128 to K rows, so the block order
// starts the longest runs first and the short ones fill the tail.
//
// What bounds it on an H100: m n^2 multiply-adds (half a GEMM) against
// reading U's triangle and B once and writing C once -- compute-bound at
// the main path's shapes (16384^2: 65.6 ms of FFMA at 'highest', 13.3 ms
// of bf16 tensor-core work for the three passes of 'high').
//
// The design takes SYRK's pieces (hopper_mma.cuh):
// 1. The pack pass reads each operand once into the caller's scratch,
//    U with its lower triangle written as zeros, both zero-padded: the
//    products never mask and never test a bound, and every case runs the
//    same product, the case being only the packs' orientation and the k-run
//    rule (runtime arguments, not template parameters).
// 2. 'high' / 'default': K-major bf16 packs (hi, and lo at 'high'), two
//    tensor maps, the TMA/mbarrier ring, two wgmma consumer warpgroups and
//    one producer warp. Each k run starts on a multiple of 128, so each
//    promotion interval of 128 rows is one k tile of trmm_upper_plain's
//    per-tile sums.
// 3. 'highest' (f32 FFMA, never TF32): the cp.async ring. It reads slabs
//    [k][outer] with 16-byte copies, which three of the four cases' operands
//    do not have in memory (contraction along columns). Rather than a
//    transposing load, which would give up the cp.async pipeline, the pack
//    pass writes both operands as f32 [k][outer] copies (PACK_F32): ~3.5
//    GB of traffic at 16384^2 (U's triangle and B read, two 1 GB copies
//    written; ~1 ms at 3.35 TB/s) against a ~100 ms product, and the
//    kernel has no edge path.
// The epilogue stages the tile through shared memory and writes
// C = alpha * sum in B's dtype (bf16 by RNE from the f32 sum), row by row,
// coalesced, masked to the M x N bounds.
#include "hopper_mma.cuh"

using namespace capital;

namespace {

// the k-run rule of each case (2 * side_r + trans)
enum Rule { RULE_L = 0, RULE_LT = 1, RULE_R = 2, RULE_RT = 3 };

// Block number -> output tile (ti, tj), the tiles with the longest k runs
// first: the triangle varies along rows on side L, along columns on side R.
__device__ __forceinline__ void tile_of(int b, int mt, int nt, int rule,
                                        int& ti, int& tj) {
  if (rule == RULE_L || rule == RULE_LT) {
    const int q = b / nt;
    tj = b % nt;
    ti = rule == RULE_L ? q : mt - 1 - q;
  } else {
    const int q = b / mt;
    ti = b % mt;
    tj = rule == RULE_RT ? q : nt - 1 - q;
  }
}

// The k run [klo, khi) of output tile (i0, j0) inside the triangle
__device__ __forceinline__ void k_run(int rule, int i0, int j0, int K,
                                      int& klo, int& khi) {
  klo = rule == RULE_L ? i0 : rule == RULE_RT ? j0 : 0;
  khi = rule == RULE_LT ? min(K, i0 + T) : rule == RULE_R ? min(K, j0 + T) : K;
}

// C[i0 + r][j0 + c] = alpha * st[r][c] inside the M x N bounds
template <typename TO>
__device__ void store_tile(const float* st, TO* c, long long ldc, int M,
                           int N, int i0, int j0, float alpha, int tid,
                           int nthreads) {
  for (int idx = tid; idx < T * T; idx += nthreads) {
    const int r = idx / T, col = idx % T;
    if (i0 + r < M && j0 + col < N)
      c[(long long)(i0 + r) * ldc + j0 + col] =
          from_f32<TO>(alpha * st[r * ST + col]);
  }
}

// ---------------------------------------------------------------------------
// 'highest': f32 FFMA over the [k][outer] f32 packs
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(F_THREADS, 2)
trmm_ffma_kernel(const float* a, int lda, const float* b, int ldb, float* c,
                 long long ldc, int M, int N, int K, int k_pad, int rule,
                 float alpha) {
  extern __shared__ __align__(16) float fsm[];
  int ti, tj, klo, khi;
  tile_of(blockIdx.x, lda / T, ldb / T, rule, ti, tj);  // lda, ldb: o_pad
  const int i0 = ti * T, j0 = tj * T;
  k_run(rule, i0, j0, K, klo, khi);
  const int tid = threadIdx.x;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // every slab lies inside the packs: klo is a multiple of 128 and
  // khi rounded up to F_BK is at most k_pad
  auto load = [&](int kt, float* da, float* db) {
    const int k0 = klo + kt * F_BK;
    load_slab(da, a, lda, k_pad, lda, k0, i0, true, tid);
    load_slab(db, b, ldb, k_pad, ldb, k0, j0, true, tid);
  };
  ffma_ring(fsm, (khi - klo + F_BK - 1) / F_BK, false, acc, load,
            [](int) {});

  float* st = fsm;  // the ring becomes the staging tile
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) st[ffma_row(i) * ST + ffma_col(j)] = acc[i][j];
  __syncthreads();
  store_tile<float>(st, c, ldc, M, N, i0, j0, alpha, tid, F_THREADS);
}

// ---------------------------------------------------------------------------
// 'high' / 'default': wgmma over the K-major bf16 packs
// ---------------------------------------------------------------------------

template <int NPASS, typename TO>
__global__ void __launch_bounds__(W_THREADS, 1)
trmm_wgmma_kernel(const __grid_constant__ CUtensorMap a_hi,
                  const __grid_constant__ CUtensorMap a_lo,
                  const __grid_constant__ CUtensorMap b_hi,
                  const __grid_constant__ CUtensorMap b_lo, TO* c,
                  long long ldc, int M, int N, int K, int rule, float alpha) {
  extern __shared__ uint8_t wsm_raw[];
  const WRing<NPASS> ring(wsm_raw);
  int ti, tj, klo, khi;
  tile_of(blockIdx.x, (M + T - 1) / T, (N + T - 1) / T, rule, ti, tj);
  const int i0 = ti * T, j0 = tj * T;
  k_run(rule, i0, j0, K, klo, khi);
  const int kt_n = (khi - klo + W_BK - 1) / W_BK;  // within the packs' k_pad
  ring.init();

  if (threadIdx.x >= 2 * 128) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128) {
      const CUtensorMap* ah = &a_hi;
      const CUtensorMap* al = &a_lo;
      const CUtensorMap* bh = &b_hi;
      const CUtensorMap* bl = &b_lo;
      ring.produce(kt_n, (NPASS == 3 ? 4 : 2) * TILE_BYTES,
                   [&](int s, int kt, uint64_t* bar) {
                     const int k0 = klo + kt * W_BK;
                     tma_load(ring.tile(s, 0), ah, k0, i0, bar);
                     tma_load(ring.tile(s, 1), bh, k0, j0, bar);
                     if (NPASS == 3) {
                       tma_load(ring.tile(s, 2), al, k0, i0, bar);
                       tma_load(ring.tile(s, 3), bl, k0, j0, bar);
                     }
                   });
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float part[64], run[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = run[i] = 0.f;
    ring.consume(kt_n, 1, 3, part, run, [](int) {});
    // both consumer warpgroups are past the ring: it becomes the staging
    // tile (the producer issued no load that was not consumed)
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    float* st = reinterpret_cast<float*>(ring.base);
#pragma unroll
    for (int i = 0; i < 64; ++i) st[frag_row(i) * ST + frag_col(i)] = run[i];
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    store_tile<TO>(st, c, ldc, M, N, i0, j0, alpha, threadIdx.x, 2 * 128);
  }
}

template <int NPASS, typename TO>
int launch_wgmma(const CUtensorMap (&maps)[4], TO* c, long long ldc, int M,
                 int N, int K, int rule, float alpha, cudaStream_t s) {
  auto k = trmm_wgmma_kernel<NPASS, TO>;
  const size_t bytes = w_smem(NPASS);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((M + T - 1) / T) * ((N + T - 1) / T);
  k<<<tiles, W_THREADS, bytes, s>>>(maps[0], maps[1], maps[2], maps[3], c,
                                    ldc, M, N, K, rule, alpha);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int run(int bf16, int prec, int side_r, int trans, const void* u,
        long long ldu, const void* b, long long ldb, TO* c, long long ldc,
        int n, int m, float alpha, void* scratch, cudaStream_t s) {
  int mode;
  if (prec == PREC_HIGHEST && !bf16)
    mode = PACK_F32;
  else if (prec == PREC_HIGH && !bf16)
    mode = PACK_HI_LO;
  else if (prec == PREC_HIGH || prec == PREC_DEFAULT)
    mode = PACK_HI;
  else
    return static_cast<int>(cudaErrorInvalidValue);
  const int M = side_r ? m : n, N = side_r ? n : m, K = n;
  const int m_pad = pad_up(M, T), n_pad = pad_up(N, T), k_pad = pad_up(K, W_BK);
  const size_t plane = mode == PACK_F32 ? 4 : 2;  // bytes per element
  const size_t planes = mode == PACK_HI_LO ? 2 : 1;
  void* pa = scratch;
  void* pb = static_cast<uint8_t*>(scratch) + planes * plane * m_pad * k_pad;
  // A: U (side L; contraction along U's rows for U^T) or B (side R);
  // B: B (side L, contraction along its rows) or U (side R; along U's
  // columns for U^T). U is packed with its lower triangle as zeros.
  int err = side_r ? pack(bf16, mode, 0, 0, b, ldb, m, n, pa, s)
                   : pack(bf16, mode, trans, 1, u, ldu, n, n, pa, s);
  if (!err)
    err = side_r ? pack(bf16, mode, !trans, 1, u, ldu, n, n, pb, s)
                 : pack(bf16, mode, 1, 0, b, ldb, n, m, pb, s);
  if (err) return err;
  const int rule = 2 * side_r + trans;
  if (mode == PACK_F32) {
    if constexpr (!std::is_same<TO, float>::value) {
      return static_cast<int>(cudaErrorInvalidValue);  // f32 only
    } else {
      cudaError_t e = cudaFuncSetAttribute(
          trmm_ffma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(F_SMEM));
      if (e != cudaSuccess) return static_cast<int>(e);
      trmm_ffma_kernel<<<(m_pad / T) * (n_pad / T), F_THREADS, F_SMEM, s>>>(
          static_cast<const float*>(pa), m_pad, static_cast<const float*>(pb),
          n_pad, c, ldc, M, N, K, k_pad, rule, alpha);
      return static_cast<int>(cudaGetLastError());
    }
  }
  const auto* ah = static_cast<const __nv_bfloat16*>(pa);
  const auto* bh = static_cast<const __nv_bfloat16*>(pb);
  const size_t a_plane = static_cast<size_t>(m_pad) * k_pad;
  const size_t b_plane = static_cast<size_t>(n_pad) * k_pad;
  const bool lo = mode == PACK_HI_LO;
  CUtensorMap maps[4];  // A hi, A lo, B hi, B lo
  cudaError_t e = make_map(&maps[0], ah, k_pad, m_pad);
  if (e == cudaSuccess) e = make_map(&maps[1], lo ? ah + a_plane : ah, k_pad, m_pad);
  if (e == cudaSuccess) e = make_map(&maps[2], bh, k_pad, n_pad);
  if (e == cudaSuccess) e = make_map(&maps[3], lo ? bh + b_plane : bh, k_pad, n_pad);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (lo) return launch_wgmma<3, TO>(maps, c, ldc, M, N, K, rule, alpha, s);
  return launch_wgmma<1, TO>(maps, c, ldc, M, N, K, rule, alpha, s);
}

}  // namespace

// u: n x n (row stride ldu), b: n x m (side L) or m x n (side R) with row
// stride ldb, c: the output of b's shape with row stride ldc. All three
// have unit column stride. bf16 != 0 means every operand is bf16, else f32
// ('highest' takes f32 only). scratch: the two packs, A's then B's, each
// planes x o_pad x k_pad elements (o_pad: the operand's output rows or
// columns rounded up to 128; k_pad: n rounded up to 64): two bf16 planes
// for f32 at 'high', one bf16 plane at 'default' and for bf16, one f32
// plane at 'highest'. Returns a cudaError_t.
extern "C" int capital_trmm_upper(int bf16, int prec, int side_r, int trans,
                                  const void* u, long long ldu, const void* b,
                                  long long ldb, void* c, long long ldc, int n,
                                  int m, float alpha, void* scratch,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  side_r = side_r != 0;
  trans = trans != 0;
  if (bf16)
    return run(bf16, prec, side_r, trans, u, ldu, b, ldb,
               static_cast<__nv_bfloat16*>(c), ldc, n, m, alpha, scratch, s);
  return run(bf16, prec, side_r, trans, u, ldu, b, ldb, static_cast<float*>(c),
             ldc, n, m, alpha, scratch, s);
}
