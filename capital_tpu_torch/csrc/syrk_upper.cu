// Triangle-aware Gram kernel: G = A^T A from the upper 128x128 tiles only.
//
// Replaces capital_tpu/ops/pallas_syrk.py::syrk_upper (pallas_call at
// :149, body _kernel :44). The TPU kernel enumerates upper tile pairs from a
// lookup table and walks the row chunks as its sequential grid axis; here
// one CTA owns one upper output tile (i <= j, found from blockIdx.x) and
// loops over the contraction rows itself.
//
// Row splits ('highest'): a tall, narrow A has few upper tiles (36 at n =
// 1024) for 132 SMs, and each CTA would walk every row alone. The wrapper
// then splits the rows too (blockIdx.y), choosing the count from the tiles,
// the CTAs the card holds at once and m (ops/cuda_syrk.py::split_count).
// Splits fall on whole folds (whole chunks where m <= FOLD_ROWS), so each
// split sums its rows exactly as below; it writes its partial tile to the
// caller's scratch, and syrk_reduce_kernel adds the partials in split
// order and writes each tile with its mirror. No float atomics: the same A
// gives the same G bit for bit. One split is the launch without splits.
//
// Two-level accumulation: the running tile is folded into a second
// accumulator every FOLD_ROWS = 32 x 512 contraction rows, as the TPU
// kernel folds every 32 chunks of 512 (pallas_syrk.py:65-68). This is an
// accuracy property, not a speed trick: it bounds the sequential-add error
// at ~(m/FOLD_ROWS + FOLD_ROWS/32) eps instead of m/32 eps. A contraction
// of at most FOLD_ROWS rows never folds. Below the fold each row chunk is
// summed apart, as the TPU kernel sums each chunk in one MXU product and
// the plain version in one tile_dot: the wgmma kernel in fresh 128-row
// promotion intervals (three 64-float accumulators fit the registers
// setmaxnreg gives a consumer thread), the FFMA kernel at 'highest' in a
// fresh accumulator for each CHUNK_ROWS = 512 rows, added into the running
// sum at the chunk's end. A single f32 chain over the whole contraction
// (the FFMA kernel before) left the Gram of a square 16384-row operand
// indefinite where its smallest eigenvalue is ~1e-7 of its norm (the
// eigensolver's split, ROADMAP F7). A contraction of at most CHUNK_ROWS
// rows runs an instantiation with one accumulator (the registers it frees
// keep two CTAs on an SM).
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
// bound tests only on edge tiles (4-byte cp.async with zero fill); with
// row splits, scratch holds the partial tiles.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W), 16384^2 window:
// 'high' 25.4 ms (bound 13.3 ms, 52 %; Bt @ B 161.9 ms; the first version
// 191.8 ms), 'highest' 110.8 ms with per-chunk sums, one split (bound 65.6
// ms, 59 %; Bt @ B 160.6 ms; the first version 269.1 ms). The 512^2 calls
// (10 tiles on 132 SMs) take 0.043 / 0.068 ms against the library's 0.025
// / 0.030 ms. Row splits at 'highest' (bench/syrk_ab.py, against the
// launch without them in the same call): 2^20 x 1024 (36 tiles, 11
// splits) 35.4 ms, was 120.8 (bound 16.4 ms, 46 %); 2^18 x 2048 (136
// tiles, 16 splits) 33.4, was 58.4; 2^18 x 144 (3 tiles, 16 splits) 2.41,
// was 35.7. The reduction kernel takes ~0.05 ms of a 2^20 x 1024 Gram.
#include "hopper_mma.cuh"

using namespace capital;

namespace {

// Contraction rows of one chunk, and per first-level accumulator of the
// two-level sum (32 row chunks of 512, capital_tpu/ops/pallas_syrk.py:65-68).
constexpr int CHUNK_ROWS = 512;
constexpr int FOLD_ROWS = 32 * CHUNK_ROWS;

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

// LEVELS: 1 (m <= CHUNK_ROWS), 2 (chunks summed apart), 3 (and folded).
// blockIdx.y is the row split: rows [r0, r1) with r0 = y * split_rows, a
// multiple of FOLD_ROWS (of CHUNK_ROWS where m <= FOLD_ROWS), so chunks
// and folds fall where they fall without the split. One split (part null)
// writes G; more write the split's partial tile, row-major, to part.
template <typename TO, int LEVELS>
__global__ void __launch_bounds__(F_THREADS, LEVELS == 1 ? 2 : 1)
syrk_ffma_kernel(const float* a, long long lda, TO* g, long long ldg, int m,
                 int n, int nt, int vec_ok, int split_rows, float* part) {
  extern __shared__ __align__(16) float fsm[];
  int ti, tj;
  pair_of(blockIdx.x, nt, ti, tj);
  const int i0 = ti * T, j0 = tj * T;
  const int tid = threadIdx.x;
  // m <= CHUNK_ROWS never splits: LEVELS 1 keeps the registers of two CTAs
  // an SM without the split's
  const int r0 = LEVELS == 1 ? 0 : blockIdx.y * split_rows;
  const int r1 = LEVELS == 1 ? m : min(m, r0 + split_rows);

  constexpr int N2 = LEVELS > 1 ? 8 : 1, N3 = LEVELS > 2 ? 8 : 1;
  float acc[8][8];     // the current chunk
  float acc2[N2][N2];  // the chunks since the last fold
  float acc3[N3][N3];  // the folds
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int i = 0; i < N2; ++i)
#pragma unroll
    for (int j = 0; j < N2; ++j) acc2[i][j] = 0.f;
#pragma unroll
  for (int i = 0; i < N3; ++i)
#pragma unroll
    for (int j = 0; j < N3; ++j) acc3[i][j] = 0.f;

  const bool fast_i = vec_ok && i0 + T <= n, fast_j = vec_ok && j0 + T <= n;
  auto load = [&](int kt, float* da, float* db) {
    const int k0 = r0 + kt * F_BK;
    const bool rows = k0 + F_BK <= m;
    load_slab(da, a, lda, m, n, k0, i0, fast_i && rows, tid);
    if (db != da) load_slab(db, a, lda, m, n, k0, j0, fast_j && rows, tid);
  };
  // at a chunk's end (not the last): acc2 = acc2 + chunk, as the plain
  // version's acc + p; every 32 chunks acc3 = acc3 + acc2
  auto promote = [&](int kt) {
    if constexpr (LEVELS > 1) {
      const int k_end = r0 + (kt + 1) * F_BK;
      if (k_end % CHUNK_ROWS == 0 && k_end < r1) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc2[i][j] += acc[i][j];
            acc[i][j] = 0.f;
          }
        if constexpr (LEVELS > 2) {
          if (k_end % FOLD_ROWS == 0) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                acc3[i][j] += acc2[i][j];
                acc2[i][j] = 0.f;
              }
          }
        }
      }
    }
  };
  ffma_ring(fsm, (r1 - r0 + F_BK - 1) / F_BK, ti == tj, acc, load, promote);

  // the ring becomes the staging tile
  float* st = fsm;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[i][j];
      if constexpr (LEVELS > 1) v = acc2[i][j] + v;
      if constexpr (LEVELS > 2) v = acc3[i][j] + v;
      st[ffma_row(i) * ST + ffma_col(j)] = v;
    }
  __syncthreads();
  if (LEVELS == 1 || part == nullptr) {
    store_mirrored<TO>(st, g, ldg, n, i0, j0, tid, F_THREADS);
    return;
  }
  float* out = part + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * T * T;
  for (int idx = tid; idx < T * T; idx += F_THREADS)
    out[idx] = st[(idx / T) * ST + idx % T];
}

// G's tile blockIdx.x from the splits' partials: summed in split order,
// ((p0 + p1) + p2) + ..., then written with its mirror as one split writes
// it. part holds `splits` planes of `gridDim.x` row-major tiles.
template <typename TO>
__global__ void __launch_bounds__(F_THREADS)
syrk_reduce_kernel(const float* part, int splits, TO* g, long long ldg, int n,
                   int nt) {
  extern __shared__ __align__(16) float fsm[];
  int ti, tj;
  pair_of(blockIdx.x, nt, ti, tj);
  const long long plane = (long long)gridDim.x * T * T;
  const float4* p =
      reinterpret_cast<const float4*>(part + (long long)blockIdx.x * T * T);
  for (int q = threadIdx.x; q < T * T / 4; q += F_THREADS) {
    float4 v = p[q];
    for (int k = 1; k < splits; ++k) {
      const float4 w = p[k * plane / 4 + q];
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    float* row = fsm + (4 * q / T) * ST + 4 * q % T;
    row[0] = v.x;
    row[1] = v.y;
    row[2] = v.z;
    row[3] = v.w;
  }
  __syncthreads();
  store_mirrored<TO>(fsm, g, ldg, n, ti * T, tj * T, threadIdx.x, F_THREADS);
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

// The rows one of `splits` takes: whole folds (whole chunks where m <=
// FOLD_ROWS), as evenly as whole units allow
int rows_per_split(int m, int splits) {
  const int unit = m > FOLD_ROWS ? FOLD_ROWS : CHUNK_ROWS;
  const int units = (m + unit - 1) / unit;
  return (units + splits - 1) / splits * unit;
}

template <typename TO, int LEVELS>
int launch_ffma(const float* a, long long lda, TO* g, long long ldg, int m,
                int n, int nt, int splits, float* part, cudaStream_t s) {
  auto k = syrk_ffma_kernel<TO, LEVELS>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(F_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_ok = (reinterpret_cast<uintptr_t>(a) % 16 == 0) && lda % 4 == 0;
  const int tiles = nt * (nt + 1) / 2;
  if (splits == 1) {
    k<<<tiles, F_THREADS, F_SMEM, s>>>(a, lda, g, ldg, m, n, nt, vec_ok, m,
                                       nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  const int rows = rows_per_split(m, splits);
  if ((m + rows - 1) / rows != splits)
    return static_cast<int>(cudaErrorInvalidValue);
  k<<<dim3(tiles, splits), F_THREADS, F_SMEM, s>>>(a, lda, g, ldg, m, n, nt,
                                                   vec_ok, rows, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto r = syrk_reduce_kernel<TO>;
  err = cudaFuncSetAttribute(r, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(STAGE_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  r<<<tiles, F_THREADS, STAGE_BYTES, s>>>(part, splits, g, ldg, n, nt);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the FFMA kernel the current device holds at once: its SMs times
// the instantiation's CTAs an SM, for m rows and the output type
template <typename TO, int LEVELS>
cudaError_t ffma_slots(int* slots) {
  auto k = syrk_ffma_kernel<TO, LEVELS>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(F_SMEM));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, F_THREADS,
                                                        F_SMEM);
  *slots = sms * per_sm;
  return err;
}

template <typename TO>
cudaError_t slots_for(int m, int* slots) {
  if (m > FOLD_ROWS) return ffma_slots<TO, 3>(slots);
  if (m > CHUNK_ROWS) return ffma_slots<TO, 2>(slots);
  return ffma_slots<TO, 1>(slots);
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
        long long ldg, int m, int n, int splits, void* scratch,
        cudaStream_t s) {
  const int nt = (n + T - 1) / T;
  if (prec == PREC_HIGHEST) {
    if (bf16_in || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
    const float* af = static_cast<const float*>(a);
    float* part = static_cast<float*>(scratch);
    if (m > FOLD_ROWS)
      return launch_ffma<TO, 3>(af, lda, g, ldg, m, n, nt, splits, part, s);
    if (m > CHUNK_ROWS)
      return launch_ffma<TO, 2>(af, lda, g, ldg, m, n, nt, splits, part, s);
    return launch_ffma<TO, 1>(af, lda, g, ldg, m, n, nt, splits, part, s);
  }
  if ((prec != PREC_HIGH && prec != PREC_DEFAULT) || splits != 1)
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
// (else f32) for a / g. splits: the row splits at 'highest' (1 elsewhere);
// each takes rows_per_split(m, splits) rows, and none may be empty.
// scratch: at 'high' / 'default' a's packed copy as capital_pack wrote it
// along a's rows (with lo for f32 input at 'high'); at 'highest' with
// splits > 1 the partial tiles, splits * nt (nt + 1) / 2 * 128^2 floats
// (nt = ceil(n / 128)); else unused. Returns a cudaError_t.
extern "C" int capital_syrk_upper(int bf16_in, int bf16_out, int prec,
                                  const void* a, long long lda, void* g,
                                  long long ldg, int m, int n, int splits,
                                  void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16_out)
    return run(bf16_in, prec, a, lda, static_cast<__nv_bfloat16*>(g), ldg, m,
               n, splits, scratch, s);
  return run(bf16_in, prec, a, lda, static_cast<float*>(g), ldg, m, n, splits,
             scratch, s);
}

// CTAs of the 'highest' kernel for m rows (bf16_out: its bf16-output
// instantiation) that the current device holds at once, the input of the
// wrapper's split count. Returns a cudaError_t.
extern "C" int capital_syrk_slots(int bf16_out, int m, int* slots) {
  return static_cast<int>(bf16_out ? slots_for<__nv_bfloat16>(m, slots)
                                   : slots_for<float>(m, slots));
}
