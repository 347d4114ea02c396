// Partial-pivoting LU of one tall strip: the leaf of the recursive LU panel.
//
// Replaces capital_tpu/ops/pallas_getrf.py::getrf_leaf_pallas (pallas_call
// at :135, body _kern :51). The strip (mm rows, ib <= 128 columns, f32) is
// factored by masked elimination: rows are never swapped while the kernel
// runs. For each column c:
//   1. pivot p = the not-done row with the largest |t[r, c]|, the smallest
//      original row among equal values (the Pallas kernel's tie rule);
//   2. multipliers l_r = t[r, c] / pivval (pivval == 0 divides by 1) for the
//      not-done rows other than p, written into column c;
//   3. rank-1 update t[r, j] -= u_j * l_r for j > c over the same rows, with
//      u = row p; row p is marked done and never changes again;
//   4. the LAPACK swap bookkeeping (pj: position -> original row, invp its
//      inverse, pivots[c] = the position swapped with c) as at
//      pallas_getrf.py:100-109.
// The caller gathers the strip by pj afterwards (ops/cuda_getrf.py).
//
// Arithmetic is the plain version's: a separate multiply and subtract
// (__fmul_rn / __fsub_rn, never contracted into an FMA) and IEEE division,
// so pivots and pj match getrf_leaf_plain exactly.
//
// Design. At the main path's tallest leaf the strip is 32768 x 128 f32 =
// 16 MB; an SM has 227 KB, and every column needs an argmax over all live
// rows. So the strip stays in global memory (L2-resident: 16 MB of the
// card's 50 MB L2), read through (pointer, row stride) so the panel's
// window in the workspace needs no copy, and one cooperative launch covers
// the whole leaf: each CTA owns a contiguous range of rows, and one grid-
// wide sync per column separates the candidates of step c from their
// reduction. Candidate slots are double-buffered by the parity of c, so a
// CTA that runs ahead into step c + 1 never overwrites a slot another CTA
// still reads. A row chosen as pivot is frozen, so every CTA may read it
// from L2 (__ldcg) right after the sync.
//
// Bound: the strip is read and written once (2 mm ib 4 bytes) and the
// update is ~mm ib^2 flops, both a few microseconds at the tallest leaf;
// this kernel is bounded instead by its ib dependent steps, each a grid
// sync plus two argmax reductions. Keeping the strip in shared memory
// across the grid, warp-level argmax and fewer syncs are later work.
#include <algorithm>
#include <climits>
#include <cooperative_groups.h>

#include "common.cuh"  // capital_error_string

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_IB = 128;
constexpr int LEAF_THREADS = 256;
constexpr int WARPS = LEAF_THREADS / 32;
constexpr int BLOCKS_PER_SM = 2;  // more CTAs only lengthen the grid sync
constexpr int MIN_ROWS = 32;      // rows per CTA below which CTAs are cut

struct Cand {
  float v;
  int r;
};

// (v, r) before (bv, br): larger |value| first, then the smaller row
__device__ __forceinline__ bool better(float v, int r, float bv, int br) {
  return v > bv || (v == bv && r < br);
}

__device__ __forceinline__ void warp_best(float& v, int& r) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int orow = __shfl_down_sync(0xffffffffu, r, off);
    if (better(ov, orow, v, r)) {
      v = ov;
      r = orow;
    }
  }
}

// Block-wide best (v, r); every thread gets the result. `red` holds
// WARPS + 1 entries.
__device__ Cand block_best(float v, int r, Cand* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  warp_best(v, r);
  if (lane == 0) red[warp] = {v, r};
  __syncthreads();
  if (warp == 0) {
    const Cand c = lane < WARPS ? red[lane] : Cand{-1.f, INT_MAX};
    v = c.v;
    r = c.r;
    warp_best(v, r);
    if (lane == 0) red[WARPS] = {v, r};
  }
  __syncthreads();
  const Cand out = red[WARPS];
  __syncthreads();  // red may be reused
  return out;
}

__global__ void __launch_bounds__(LEAF_THREADS)
getrf_leaf_kernel(float* t, long long ld, int mm, int ib, int rows_per,
                  int* pj, int* invp, int* done, int* piv, float* slot_v,
                  int* slot_r) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float urow[MAX_IB];
  __shared__ Cand red[WARPS + 1];
  const int g = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = b * rows_per, r1 = min(mm, r0 + rows_per);

  for (int r = r0 + tid; r < r1; r += LEAF_THREADS) done[r] = 0;
  if (b == 0)  // only block 0's thread 0 keeps the bookkeeping
    for (int r = tid; r < mm; r += LEAF_THREADS) pj[r] = invp[r] = r;
  __syncthreads();

  for (int c = 0; c < ib; ++c) {
    // 1. this CTA's candidate. A NaN ranks below every number but above
    // "no row", so a pivot always exists (mm >= ib).
    float bv = -1.f;
    int br = INT_MAX;
    for (int r = r0 + tid; r < r1; r += LEAF_THREADS) {
      if (done[r]) continue;
      const float x = t[(long long)r * ld + c];
      const float v = isnan(x) ? -0.5f : fabsf(x);
      if (better(v, r, bv, br)) {
        bv = v;
        br = r;
      }
    }
    const Cand loc = block_best(bv, br, red);
    float* sv = slot_v + (c & 1) * g;
    int* sr = slot_r + (c & 1) * g;
    if (tid == 0) {
      __stcg(sv + b, loc.v);
      __stcg(sr + b, loc.r);
    }
    grid.sync();

    // 2. the pivot: every CTA reduces the same slots to the same p
    bv = -1.f;
    br = INT_MAX;
    for (int i = tid; i < g; i += LEAF_THREADS) {
      const float v = __ldcg(sv + i);
      const int r = __ldcg(sr + i);
      if (better(v, r, bv, br)) {
        bv = v;
        br = r;
      }
    }
    const int p = block_best(bv, br, red).r;
    for (int j = tid; j < ib; j += LEAF_THREADS)
      urow[j] = __ldcg(t + (long long)p * ld + j);
    if (b == 0 && tid == 0) {
      // pivot row p (original index) sits at position cur: swap c <-> cur
      const int cur = invp[p];
      const int pj_c = pj[c], pj_cur = pj[cur];
      pj[c] = pj_cur;
      pj[cur] = pj_c;
      invp[pj_c] = cur;
      invp[pj_cur] = c;
      piv[c] = cur;
    }
    __syncthreads();
    const float pv = urow[c];
    const float safe = pv == 0.f ? 1.f : pv;

    // 3. multipliers and the rank-1 update, one warp per row
    for (int r = r0 + warp; r < r1; r += WARPS) {
      if (r == p) {
        if (lane == 0) done[r] = 1;
        continue;
      }
      if (done[r]) continue;
      float* row = t + (long long)r * ld;
      const float l = __fdiv_rn(row[c], safe);
      for (int j = c + 1 + lane; j < ib; j += 32)
        row[j] = __fsub_rn(row[j], __fmul_rn(urow[j], l));
      __syncwarp();
      if (lane == 0) row[c] = l;
    }
    __syncthreads();
  }
}

}  // namespace

// t: the strip, row stride ld, unit column stride (factored in place,
// unswapped); pj, invp, done: mm ints; piv: ib ints; slot_v, slot_r:
// 2 * max_blocks each. Returns a cudaError_t.
extern "C" int capital_getrf_leaf(float* t, long long ld, int mm, int ib,
                                  int* pj, int* invp, int* done, int* piv,
                                  float* slot_v, int* slot_r, int max_blocks,
                                  void* stream) {
  if (ib < 1 || ib > MAX_IB || mm < ib || ld < ib)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, getrf_leaf_kernel, LEAF_THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  // at most the co-resident CTAs; a larger grid fails the launch with
  // cudaErrorCooperativeLaunchTooLarge, which is returned as it is
  int g = std::min(std::min(per_sm, BLOCKS_PER_SM) * sms,
                   (mm + MIN_ROWS - 1) / MIN_ROWS);
  g = std::max(1, std::min(g, max_blocks));
  int rows_per = (mm + g - 1) / g;
  g = (mm + rows_per - 1) / rows_per;
  void* args[] = {&t, &ld, &mm, &ib, &rows_per, &pj, &invp,
                  &done, &piv, &slot_v, &slot_r};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(getrf_leaf_kernel), dim3(g), dim3(LEAF_THREADS),
      args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
