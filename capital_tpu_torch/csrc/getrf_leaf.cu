// Partial-pivoting LU of one tall strip: the leaf of the recursive LU panel.
//
// Replaces capital_tpu/ops/pallas_getrf.py::getrf_leaf_pallas (pallas_call
// at :135, body _kern :51). The strip (mm rows, ib <= 128 columns, f32) is
// factored by masked elimination: rows are never swapped while the
// elimination runs. For each column c:
//   1. pivot p = the not-done row with the largest |t[r, c]|, the smallest
//      original row among equal values (the Pallas kernel's tie rule); a
//      NaN ranks below every number and above "no row";
//   2. multipliers l_r = t[r, c] / pivval (pivval == 0 divides by 1) for the
//      not-done rows other than p, written into column c;
//   3. rank-1 update t[r, j] -= u_j * l_r for j > c over the same rows, with
//      u = row p; row p is marked done and never changes again;
//   4. the LAPACK swap bookkeeping: pivots[c] = cur, the position p sits at
//      before step c, and the positions c and cur are exchanged; pj (final
//      position -> original row) is the result of all ib exchanges.
// Arithmetic is the plain version's: a separate multiply and subtract
// (__fmul_rn / __fsub_rn, never contracted into an FMA) and IEEE division,
// so pj, pivots and the factor match getrf_leaf_plain bit for bit.
//
// Bound. The strip is read and written once (2 mm ib 4 bytes: 0.0100 ms at
// 32768 x 128 on 3.35 TB/s) and the update is ~mm ib^2 flops, a few
// microseconds. What bounds a leaf instead is its ib dependent steps: each
// needs the argmax over every live row of the strip, so each is one
// exchange between all CTAs.
//
// Two routes, chosen by the wrapper from (mm, ib, SM count, shared memory
// per block) before the launch (ops/cuda_getrf.py::plan):
//
// resident (every leaf of the LU paths): the strip lives in shared memory
// across the grid. One cooperative CTA an SM copies its contiguous rows in
// once, at a padded row pitch (pitch = S mod 32 words, S the threads that
// share a row), so its threads' row accesses hit distinct banks; 132 CTAs
// hold ~58k rows at ib = 128. A column is one exchange: each CTA publishes
// its candidate (|v|, row, the row's current position) and the row's
// columns c..ib-1 into its own slot in global memory (double-buffered by
// the parity of c) as 8-byte words that each carry the step's generation
// beside the value, so no fence and no flag store follow the data; warp 0
// of every CTA polls all g slots' heads at once, reduces them to the same
// winner and reads the pivot row from the winner's slot, word by word
// until each carries the generation. A CTA rewrites its slot of step c
// (for step c + 2) only after it has seen every CTA's head of step c + 1,
// which each CTA publishes after it has read step c's pivot row. Two block
// barriers a column. The update of column c computes each row's new column
// c + 1 and the CTA's candidate for step c + 1 in the same pass. The
// bookkeeping needs no serial thread: each CTA tracks the position of its
// own rows (the row at position c moves to cur, p moves to c), and the
// winner's slot carries cur. At the end each CTA writes each of its rows
// straight to its final position in the window and fills pj there, so the
// strip comes out swapped from this one launch: every CTA read its rows
// before the one grid sync at the start (which also orders the zeroed
// slots before any publish), so the in-place scatter never overwrites a
// row that is still to be read.
//
// tall (strips taller than the grid's shared memory holds): the strip stays
// in global memory (L2), read through (pointer, row stride); one grid sync
// and two block argmax reductions a column, up to two CTAs an SM; the
// caller gathers the strip by pj afterwards.
#include <algorithm>
#include <climits>
#include <cooperative_groups.h>

#include "common.cuh"  // capital_error_string

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_IB = 128;

struct Cand {
  float v;
  int r;
};

// (v, r) before (bv, br): larger |value| first, then the smaller row
__device__ __forceinline__ bool better(float v, int r, float bv, int br) {
  return v > bv || (v == bv && r < br);
}

// the candidate value of an element: NaN ranks below every number
__device__ __forceinline__ float rank(float x) {
  return isnan(x) ? -0.5f : fabsf(x);
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
template <int WARPS>
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

// ---------------------------------------------------------------- resident

constexpr int RES_THREADS = 512;
constexpr int RES_WARPS = RES_THREADS / 32;
constexpr int RES_MAX_BLOCKS = 160;  // the CTAs warp 0 polls, 5 a lane
constexpr int POLL = RES_MAX_BLOCKS / 32;
constexpr unsigned FULL = 0xffffffffu;
// A slot: one CTA's candidate for one step, as 8-byte words {value, gen}
// (gen = step + 1) so that each word says itself whether it is current:
// 0 the |value|, 1 the row, 2 its position, SLOT_HEAD + j column j.
constexpr int SLOT_HEAD = 4;
constexpr int SLOT_WORDS = SLOT_HEAD + MAX_IB;

// An 8-byte access is single-copy atomic, so a word read with the wanted
// gen holds that step's value: no fence orders the words of a slot.
__device__ __forceinline__ void st_word(uint2* p, unsigned x, unsigned gen) {
  asm volatile("st.volatile.global.v2.u32 [%0], {%1, %2};"
               :: "l"(p), "r"(x), "r"(gen) : "memory");
}

__device__ __forceinline__ uint2 ld_word(const uint2* p) {
  uint2 w;
  asm volatile("ld.volatile.global.v2.u32 {%0, %1}, [%2];"
               : "=r"(w.x), "=r"(w.y) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ unsigned wait_word(const uint2* p, unsigned gen) {
  uint2 w;
  do {
    w = ld_word(p);
  } while (w.y != gen);
  return w.x;
}

__device__ __forceinline__ uint2* slot_of(uint2* slots, int c, int cta) {
  return slots + (static_cast<size_t>(c & 1) * gridDim.x + cta) * SLOT_WORDS;
}

// Publish this CTA's candidate for step c (every thread passes its own):
// the block's best (value, row, the row's position) and the row's columns
// c..ib-1, written by warp 0.
__device__ __forceinline__ void publish(int c, float bv, int br, int ib,
                                        int r0, int pitch, const float* s_t,
                                        const int* s_pos, uint2* slots,
                                        Cand* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  warp_best(bv, br);
  if (lane == 0) red[warp] = {bv, br};
  __syncthreads();
  if (warp != 0) return;
  const Cand m = lane < RES_WARPS ? red[lane] : Cand{-1.f, INT_MAX};
  bv = m.v;
  br = m.r;
  warp_best(bv, br);
  bv = __shfl_sync(FULL, bv, 0);
  br = __shfl_sync(FULL, br, 0);
  uint2* sl = slot_of(slots, c, blockIdx.x);
  const unsigned gen = c + 1;
  int pos = 0;
  if (br != INT_MAX) {
    const float* src = s_t + (br - r0) * pitch;
    for (int j = c + lane; j < ib; j += 32)
      st_word(sl + SLOT_HEAD + j, __float_as_uint(src[j]), gen);
    pos = s_pos[br - r0];
  }
  if (lane == 0) {
    st_word(sl, __float_as_uint(bv), gen);
    st_word(sl + 1, static_cast<unsigned>(br), gen);
    st_word(sl + 2, static_cast<unsigned>(pos), gen);
  }
}

// Warp 0: wait for every CTA's candidate of step c, reduce them to the
// pivot p (every CTA reaches the same p) and copy p's row from its slot.
__device__ __forceinline__ void find_pivot(int c, int ib, int rows_per,
                                           uint2* slots, float* urow,
                                           int* s_p, int* s_cur) {
  const int g = gridDim.x, lane = threadIdx.x % 32;
  const unsigned gen = c + 1;
  float v[POLL];
  int r[POLL];
  bool ok;
  do {
    ok = true;
#pragma unroll
    for (int k = 0; k < POLL; ++k) {
      const int i = lane + 32 * k;
      v[k] = -1.f;
      r[k] = INT_MAX;
      if (i < g) {
        const uint2* sl = slot_of(slots, c, i);
        const uint2 a = ld_word(sl), b = ld_word(sl + 1);
        ok = ok && a.y == gen && b.y == gen;
        v[k] = __uint_as_float(a.x);
        r[k] = static_cast<int>(b.x);
      }
    }
  } while (!__all_sync(FULL, ok));
  float bv = v[0];
  int br = r[0];
#pragma unroll
  for (int k = 1; k < POLL; ++k)
    if (better(v[k], r[k], bv, br)) {
      bv = v[k];
      br = r[k];
    }
  warp_best(bv, br);
  const int p = __shfl_sync(FULL, br, 0);
  const uint2* sl = slot_of(slots, c, p / rows_per);
  for (int j = c + lane; j < ib; j += 32)
    urow[j] = __uint_as_float(wait_word(sl + SLOT_HEAD + j, gen));
  if (lane == 0) {
    *s_p = p;
    *s_cur = static_cast<int>(wait_word(sl + 2, gen));
  }
}

// S threads share a row: thread (slot, sub) updates columns c+1+sub,
// c+1+sub+S, ... of rows slot, slot + RES_THREADS / S, ...
template <int S>
__global__ void __launch_bounds__(RES_THREADS, 1)
getrf_resident_kernel(float* t, long long ld, int mm, int ib, int rows_per,
                      int pitch, int* pj, int* piv, uint2* slots) {
  // rows_per x pitch, then each row's position: a row with position < c
  // was the pivot of an earlier step (positions < c hold those pivots)
  extern __shared__ float s_t[];
  int* s_pos = reinterpret_cast<int*>(s_t + static_cast<size_t>(rows_per) *
                                                pitch);
  __shared__ float urow[MAX_IB];
  __shared__ int s_piv[MAX_IB];
  __shared__ Cand red[RES_WARPS];
  __shared__ int s_p, s_cur;
  constexpr int SLOTS = RES_THREADS / S;
  cg::grid_group grid = cg::this_grid();
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int sub = tid % S, slot = tid / S;
  const unsigned gmask = S == 32 ? FULL : ((1u << S) - 1) << (lane & ~(S - 1));
  const int r0 = b * rows_per, nrows = min(mm, r0 + rows_per) - r0;

  for (int k = tid; k < 2 * SLOT_WORDS; k += RES_THREADS)
    slot_of(slots, k / SLOT_WORDS, b)[k % SLOT_WORDS] = make_uint2(0, 0);
#pragma unroll 2
  for (int lr = warp; lr < nrows; lr += RES_WARPS) {
    const float* src = t + static_cast<long long>(r0 + lr) * ld;
    float* dst = s_t + lr * pitch;
#pragma unroll
    for (int q = 0; q < MAX_IB / 32; ++q)
      if (lane + 32 * q < ib) dst[lane + 32 * q] = src[lane + 32 * q];
  }
  for (int lr = tid; lr < nrows; lr += RES_THREADS) s_pos[lr] = r0 + lr;
  // every CTA has read its rows and zeroed its slots before any CTA
  // publishes; from here on the window is only written
  grid.sync();

  float bv = -1.f;
  int br = INT_MAX;
  for (int lr = tid; lr < nrows; lr += RES_THREADS) {
    const float v = rank(s_t[lr * pitch]);
    if (better(v, r0 + lr, bv, br)) {
      bv = v;
      br = r0 + lr;
    }
  }
  publish(0, bv, br, ib, r0, pitch, s_t, s_pos, slots, red);

  for (int c = 0; c < ib; ++c) {
    if (warp == 0) find_pivot(c, ib, rows_per, slots, urow, &s_p, &s_cur);
    __syncthreads();
    const int p = s_p, cur = s_cur;
    const float pv = urow[c];
    const float safe = pv == 0.f ? 1.f : pv;
    const bool next = c + 1 < ib;
    if (tid == 0) s_piv[c] = cur;

    // multipliers, the rank-1 update, positions and step c + 1's candidate
    bv = -1.f;
    br = INT_MAX;
    for (int lr = slot; lr < nrows; lr += SLOTS) {
      const int gr = r0 + lr;
      if (gr == p) {
        if (sub == 0) s_pos[lr] = c;
        continue;
      }
      const int pos = s_pos[lr];
      if (pos < c) continue;
      float* row = s_t + lr * pitch;
      const float l = __fdiv_rn(row[c], safe);
#pragma unroll 4
      for (int j = c + 1 + sub; j < ib; j += S)
        row[j] = __fsub_rn(row[j], __fmul_rn(urow[j], l));
      if (sub == 0 && next) {
        const float x = rank(row[c + 1]);
        if (better(x, gr, bv, br)) {
          bv = x;
          br = gr;
        }
      }
      __syncwarp(gmask);  // the row's threads have all read row[c] and pos
      if (sub == 0) {
        row[c] = l;
        if (pos == c) s_pos[lr] = cur;
      }
    }
    if (next) publish(c + 1, bv, br, ib, r0, pitch, s_t, s_pos, slots, red);
  }

  // each row straight to its final position
  __syncthreads();
  for (int lr = warp; lr < nrows; lr += RES_WARPS) {
    const int pos = s_pos[lr];
    const float* src = s_t + lr * pitch;
    float* dst = t + static_cast<long long>(pos) * ld;
#pragma unroll
    for (int q = 0; q < MAX_IB / 32; ++q)
      if (lane + 32 * q < ib) dst[lane + 32 * q] = src[lane + 32 * q];
    if (lane == 0) pj[pos] = r0 + lr;
  }
  if (b == 0)
    for (int j = tid; j < ib; j += RES_THREADS) piv[j] = s_piv[j];
}

template <int S>
cudaError_t launch_resident(float* t, long long ld, int mm, int ib,
                            int rows_per, int pitch, int* pj, int* piv,
                            uint2* slots, int g, int sms,
                            cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(rows_per) * (pitch * 4 + 4);
  auto* kern = getrf_resident_kernel<S>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        RES_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || g > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&t, &ld, &mm, &ib, &rows_per, &pitch, &pj, &piv, &slots};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(g),
                                     dim3(RES_THREADS), args, smem, stream);
}

// -------------------------------------------------------------------- tall

constexpr int LEAF_THREADS = 256;
constexpr int WARPS = LEAF_THREADS / 32;
constexpr int BLOCKS_PER_SM = 2;  // more CTAs only lengthen the grid sync
constexpr int MIN_ROWS = 32;      // rows per CTA below which CTAs are cut

__global__ void __launch_bounds__(LEAF_THREADS)
getrf_tall_kernel(float* t, long long ld, int mm, int ib, int rows_per,
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
    // 1. this CTA's candidate
    float bv = -1.f;
    int br = INT_MAX;
    for (int r = r0 + tid; r < r1; r += LEAF_THREADS) {
      if (done[r]) continue;
      const float v = rank(t[(long long)r * ld + c]);
      if (better(v, r, bv, br)) {
        bv = v;
        br = r;
      }
    }
    const Cand loc = block_best<WARPS>(bv, br, red);
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
    const int p = block_best<WARPS>(bv, br, red).r;
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

cudaError_t device_limits(int* sms, int* smem, int* coop) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(coop, cudaDevAttrCooperativeLaunch, dev);
  return err;
}

}  // namespace

// The current device's SM count and opt-in shared memory per block (bytes),
// the inputs of the wrapper's route choice. Returns a cudaError_t.
extern "C" int capital_getrf_limits(int* sms, int* smem) {
  int coop = 0;
  return static_cast<int>(device_limits(sms, smem, &coop));
}

// Resident route. t: the strip, row stride ld, unit column stride, factored
// in place and written back swapped; pj: mm ints (position -> original
// row); piv: ib ints; slots: 2 * g * 132 8-byte words; g = ceil(mm /
// rows_per) <= 160 CTAs of `split` threads a row, row pitch `pitch` floats.
// Returns a cudaError_t; a plan the card cannot run is refused, never
// changed.
extern "C" int capital_getrf_resident(float* t, long long ld, int mm, int ib,
                                      int rows_per, int split, int pitch,
                                      int* pj, int* piv, void* slots,
                                      void* stream) {
  if (ib < 1 || ib > MAX_IB || mm < ib || ld < ib || pitch < ib ||
      rows_per < 1 || (mm + rows_per - 1) / rows_per > RES_MAX_BLOCKS)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, smem = 0, coop = 0;
  cudaError_t err = device_limits(&sms, &smem, &coop);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const int g = (mm + rows_per - 1) / rows_per;
  using Launch = cudaError_t (*)(float*, long long, int, int, int, int, int*,
                                int*, uint2*, int, int, cudaStream_t);
  const Launch by_split[] = {launch_resident<1>, launch_resident<2>,
                             launch_resident<4>, launch_resident<8>,
                             launch_resident<16>, launch_resident<32>};
  int k = 0;
  while (k < 6 && (1 << k) != split) ++k;
  if (k == 6) return static_cast<int>(cudaErrorInvalidValue);
  err = by_split[k](t, ld, mm, ib, rows_per, pitch, pj, piv,
                    static_cast<uint2*>(slots), g, sms,
                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Tall route. t: the strip, row stride ld, unit column stride (factored in
// place, unswapped); pj, invp, done: mm ints; piv: ib ints; slot_v,
// slot_r: 2 * max_blocks each. Returns a cudaError_t.
extern "C" int capital_getrf_tall(float* t, long long ld, int mm, int ib,
                                  int* pj, int* invp, int* done, int* piv,
                                  float* slot_v, int* slot_r, int max_blocks,
                                  void* stream) {
  if (ib < 1 || ib > MAX_IB || mm < ib || ld < ib)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, smem = 0, coop = 0, per_sm = 0;
  cudaError_t err = device_limits(&sms, &smem, &coop);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, getrf_tall_kernel, LEAF_THREADS, 0);
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
      reinterpret_cast<void*>(getrf_tall_kernel), dim3(g), dim3(LEAF_THREADS),
      args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
