// The pieces of the Hopper matrix-product kernels that SYRK
// (syrk_upper.cu) and TRMM (trmm_upper.cu) share, each kept once here.
//
// 1. The pack pass. It reads one operand X (o x k: o output rows or
//    columns, k contraction) once from its source array and writes a
//    zero-padded copy that the product kernels read with no bounds test and
//    no mask:
//      - 'high' / 'default' (PACK_HI_LO, PACK_HI): K-major bf16
//        ([outer][k], the contraction index contiguous), o padded to 128
//        and k to 64, hi and, at 'high', lo = bf16(x - hi) as a second
//        plane right after it (hi bitwise pallas_dot.py::_split_f32's);
//      - 'highest' (PACK_F32): an f32 copy laid out [k][outer] (the outer
//        index contiguous), the layout the FFMA ring's 16-byte cp.async
//        loads read.
//    The source holds X either with the contraction along its rows
//    (X[o][k] = a[k][o]: SYRK's A, TRMM's B on side L, U^T) or along its
//    columns (X[o][k] = a[o][k]: a straight copy). With `upper`, entries
//    below the source's diagonal (row > col in its own indices) are
//    written as zeros: the triangle mask of TRMM's diagonal tiles, done
//    once. Ragged shapes and windows at any offset are read here, so the
//    products only ever see the aligned packed copy.
// 2. 'highest': a 4-stage ring of 16-byte cp.async copies feeding an 8x8
//    FFMA register micro-tile per thread (float4 shared reads), 256
//    threads per 128x128 output tile (ffma_ring).
// 3. 'high' / 'default': a ring of TMA copies (cp.async.bulk.tensor, boxes
//    of 128 rows x 64 bf16, 128-byte swizzle) guarded by mbarriers (WRing):
//    one producer thread keeps it full, two consumer warpgroups each own 64
//    rows of the 128x128 tile and run wgmma m64n128k16 (bf16 in, f32 out),
//    three per k16 step at 'high' (hi*hi, hi*lo, lo*hi). The tensor cores'
//    own f32 accumulation is not IEEE round-to-nearest (measured on the
//    card: a 17000-deep chain drifts ~1e-4 from an f32 sum), so each
//    promotion interval of PROMO_ROWS contraction rows is summed in a
//    freshly zeroed accumulator (scale-d = 0 on its first wgmma) and then
//    added to the running f32 sum with ordinary adds.
//
// Promotion interval: 128 rows, chosen from one measurement of each
// candidate on SYRK against its plain version at 16384 deep (relative
// Frobenius / max abs): 32 rows 5.03e-7 / 2.69e-3 in 26.7 ms, 64 rows
// 4.20e-7 / 1.95e-3 in 26.1 ms, 128 rows 4.42e-7 / 1.71e-3 in 24.3 ms
// (PERF.md). A kernel that starts its contraction on a multiple of 128
// therefore sums each aligned 128-row tile on its own, as the plain
// versions' per-tile products do.
#pragma once

#include <cuda.h>

#include <type_traits>

#include "common.cuh"

namespace capital {

constexpr int T = 128;     // output tile side
constexpr int ST = T + 1;  // staged tile row stride (floats): a column
                           // read is free of bank conflicts
constexpr size_t STAGE_BYTES = T * ST * sizeof(float);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

inline int pad_up(int x, int q) { return (x + q - 1) / q * q; }

// ---------------------------------------------------------------------------
// 1. The pack pass
// ---------------------------------------------------------------------------

constexpr int W_BK = 64;  // contraction rows per wgmma stage: a 128-byte row
enum PackMode { PACK_HI = 0, PACK_HI_LO = 1, PACK_F32 = 2 };

// One 32 x 32 block of X per CTA, numbered along k first (blockIdx.x =
// kb + (k_pad / 32) * ob: a 1-D grid, since o_pad / 32 passes gridDim.y's
// 65535 at 2^21 rows), read along the source's rows and written along the
// packed copy's rows through a shared tile (33 columns: both walks are
// free of bank conflicts).
template <typename TI, typename TP, bool LO>
__global__ void pack_kernel(const TI* a, long long lda, int rows, int cols,
                            int along_rows, int upper, TP* hi, TP* lo,
                            int o_pad, int k_pad) {
  constexpr bool KMAJOR = std::is_same<TP, __nv_bfloat16>::value;
  __shared__ float tile[32][33];
  const int nkb = k_pad / 32;
  const int k0 = (blockIdx.x % nkb) * 32, o0 = (blockIdx.x / nkb) * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  // tile[p][q] = a[r0 + p][c0 + q]
  const int r0 = along_rows ? k0 : o0, c0 = along_rows ? o0 : k0;
#pragma unroll
  for (int q = 0; q < 32; q += 8) {
    const int r = r0 + ty + q, c = c0 + tx;
    const bool ok = r < rows && c < cols && !(upper && r > c);
    tile[ty + q][tx] = ok ? to_f32(a[(long long)r * lda + c]) : 0.f;
  }
  __syncthreads();
  // the packed row p holds X[o0 + p][k0 + tx] (K-major) or X[o0 + tx][k0 + p]
  const bool flip = (along_rows != 0) == KMAJOR;
#pragma unroll
  for (int q = 0; q < 32; q += 8) {
    const int p = ty + q;
    const float x = flip ? tile[tx][p] : tile[p][tx];
    const long long o = KMAJOR ? (long long)(o0 + p) * k_pad + k0 + tx
                               : (long long)(k0 + p) * o_pad + o0 + tx;
    if constexpr (!KMAJOR) {
      hi[o] = x;
    } else if constexpr (LO) {
      const float h = bf16_hi(x);
      hi[o] = __float2bfloat16_rn(h);  // exact: h is on the bf16 grid
      lo[o] = __float2bfloat16_rn(x - h);
    } else {
      hi[o] = __float2bfloat16_rn(x);
    }
  }
}

// Packs X from a (rows x cols, row stride lda, unit column stride; bf16 if
// bf16_in, else f32) into out: o = cols, k = rows when along_rows, else
// o = rows, k = cols; o_pad = o rounded up to T, k_pad = k rounded up to
// W_BK. PACK_HI / PACK_HI_LO write bf16 [o_pad][k_pad] planes (lo right
// after hi), PACK_F32 one f32 [k_pad][o_pad] plane. Returns a cudaError_t.
inline int pack(int bf16_in, int mode, int along_rows, int upper,
                const void* a, long long lda, int rows, int cols, void* out,
                cudaStream_t s) {
  if (rows < 1 || cols < 1 || (bf16_in && mode != PACK_HI) || mode < 0 ||
      mode > PACK_F32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int o_pad = pad_up(along_rows ? cols : rows, T);
  const int k_pad = pad_up(along_rows ? rows : cols, W_BK);
  const long long blocks = (long long)(k_pad / 32) * (o_pad / 32);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks)), block(32, 8);
  auto* h = static_cast<__nv_bfloat16*>(out);
  auto* l = h + static_cast<size_t>(o_pad) * k_pad;
  if (bf16_in)
    pack_kernel<__nv_bfloat16, __nv_bfloat16, false><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), lda, rows, cols, along_rows,
        upper, h, l, o_pad, k_pad);
  else if (mode == PACK_HI_LO)
    pack_kernel<float, __nv_bfloat16, true><<<grid, block, 0, s>>>(
        static_cast<const float*>(a), lda, rows, cols, along_rows, upper, h,
        l, o_pad, k_pad);
  else if (mode == PACK_HI)
    pack_kernel<float, __nv_bfloat16, false><<<grid, block, 0, s>>>(
        static_cast<const float*>(a), lda, rows, cols, along_rows, upper, h,
        l, o_pad, k_pad);
  else
    pack_kernel<float, float, false><<<grid, block, 0, s>>>(
        static_cast<const float*>(a), lda, rows, cols, along_rows, upper,
        static_cast<float*>(out), nullptr, o_pad, k_pad);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// 2. 'highest': the cp.async ring and the FFMA micro-tile
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

// rows [k0, k0 + F_BK) x columns [c0, c0 + T) of a (m x n, row stride lda)
// into buf[k][c]; fast: 16-byte copies (the slab in bounds and aligned),
// else 4-byte copies with zero fill outside m x n
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

// Value (i, j) of a thread's FFMA micro-tile sits at this tile row / column
__device__ __forceinline__ int ffma_row(int i) {
  return (i < 4 ? 0 : 64) + (threadIdx.x / 16) * 4 + i % 4;
}
__device__ __forceinline__ int ffma_col(int j) {
  return (j < 4 ? 0 : 64) + (threadIdx.x % 16) * 4 + j % 4;
}

// The FFMA product of one 128x128 tile over kt_n slabs of F_BK
// contraction rows, through a F_STAGES-deep cp.async ring at `ring`
// (F_RING bytes). load(kt, a_dst, b_dst) issues slab kt's copies of the
// two operands, each F_BK x T, [k][outer] (b_dst == a_dst when one operand
// serves both sides); every landed slab adds A^T B into acc (value (i, j)
// at ffma_row(i), ffma_col(j)); after(kt) runs once slab kt is summed. On
// return every copy has landed and the ring is free for reuse.
template <class Load, class After>
__device__ __forceinline__ void ffma_ring(float* ring, int kt_n,
                                          bool one_operand,
                                          float (&acc)[8][8], Load load,
                                          After after) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  auto stage = [&](int kt) { return ring + (kt % F_STAGES) * 2 * F_BK * T; };
  auto issue = [&](int kt) {
    float* sa = stage(kt);
    load(kt, sa, one_operand ? sa : sa + F_BK * T);
  };
#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < kt_n) issue(s);
    cp_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_wait<F_STAGES - 2>();
    __syncthreads();  // slab kt landed; slab kt - 1 is no longer read
    if (kt + F_STAGES - 1 < kt_n) issue(kt + F_STAGES - 1);
    cp_commit();
    const float* as = stage(kt);
    const float* bs = one_operand ? as : as + F_BK * T;
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
    after(kt);
  }
  cp_wait<0>();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// 3. 'high' / 'default': TMA + mbarrier ring + wgmma
// ---------------------------------------------------------------------------

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
#undef CAP_F8

// Accumulator value i of a consumer thread sits at this row / column of
// the 128x128 tile (wgmma m64n128 f32 layout; warpgroup wg owns rows
// [64 wg, 64 wg + 64))
__device__ __forceinline__ int frag_row(int i) {
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  return wg * 64 + warp * 16 + (threadIdx.x % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int i) {
  return (i >> 2) * 8 + (threadIdx.x % 4) * 2 + (i & 1);
}

// The ring of a wgmma kernel in dynamic shared memory (w_smem(NPASS)
// bytes): S stages of OPS operand tiles (0 A_hi, 1 B_hi, 2 A_lo, 3 B_lo),
// a `full` barrier per stage (the producer's expect_tx + TMA bytes) and an
// `empty` one (one arrival per consumer warpgroup).
template <int NPASS>
struct WRing {
  static constexpr int S = w_stages(NPASS), OPS = w_ops(NPASS);
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit WRing(uint8_t* raw)
      : base(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023)),
        full(reinterpret_cast<uint64_t*>(base + S * OPS * TILE_BYTES)),
        empty(full + S) {}

  __device__ __forceinline__ uint8_t* tile(int s, int op) const {
    return base + (s * OPS + op) * TILE_BYTES;
  }

  // all threads of the block call it
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], 2);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // The producer thread: kt_n stages, each `bytes` of TMA copies that
  // load(s, kt, bar) issues into stage s against barrier bar.
  template <class Load>
  __device__ __forceinline__ void produce(int kt_n, int bytes,
                                          Load load) const {
    for (int kt = 0; kt < kt_n; ++kt) {
      const int s = kt % S;
      if (kt >= S) mbar_wait(&empty[s], (kt / S - 1) & 1);
      mbar_expect_tx(&full[s], bytes);
      load(s, kt, &full[s]);
    }
  }

  // A consumer warpgroup: rows [64 wg, 64 wg + 64) of the A tiles (ops 0,
  // 2) times the B tiles (ops b_hi, b_lo) over kt_n stages, each
  // PSTEPS k16 steps summed in part from zero and added into run. after(kt)
  // runs once stage kt is released.
  template <class After>
  __device__ __forceinline__ void consume(int kt_n, int b_hi, int b_lo,
                                          float (&part)[64], float (&run)[64],
                                          After after) const {
    const int wg = threadIdx.x / 128;
    const int steps = kt_n * (W_BK / 16);
    for (int kt = 0; kt < kt_n; ++kt) {
      const int s = kt % S;
      mbar_wait(&full[s], (kt / S) & 1);
      const uint64_t dah = wg_desc(tile(s, 0) + wg * 64 * 128);
      const uint64_t dbh = wg_desc(tile(s, b_hi));
      const uint64_t dal = wg_desc(tile(s, NPASS == 3 ? 2 : 0) + wg * 64 * 128);
      const uint64_t dbl = wg_desc(tile(s, NPASS == 3 ? b_lo : 0));
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
      after(kt);
    }
  }
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which these libraries do not
// link (only the runtime), so it is looked up through the runtime
inline EncodeTiled encode_tiled() {
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

// map of a packed o_pad x k_pad bf16 plane, boxes of T rows x W_BK columns
inline cudaError_t make_map(CUtensorMap* map, const void* p, int k_pad,
                            int o_pad) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k_pad),
                              static_cast<cuuint64_t>(o_pad)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k_pad) * 2};
  const cuuint32_t box[2] = {W_BK, T};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(p), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace capital

// The pack pass on its own (capital::pack; ops/cuda_pack.py::pack).
// Returns a cudaError_t.
extern "C" int capital_pack(int bf16_in, int mode, int along_rows, int upper,
                            const void* a, long long lda, int rows, int cols,
                            void* out, void* stream) {
  return capital::pack(bf16_in, mode, along_rows, upper, a, lda, rows, cols,
                       out, static_cast<cudaStream_t>(stream));
}
