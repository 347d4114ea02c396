// Host-side layout engine: block <-> cyclic redistribution and packed
// triangular (de)serialization, multithreaded C++.
//
// Native counterpart of the reference's redistribution utilities
// (ref: src/util/util.hpp:56-230 block_to_cyclic_{triangle,rect} /
// cyclic_to_block_*) and of the packed triangular storage the reference's
// structure policies keep (ref: src/matrix/structure.h:34-59 uppertri/
// lowertri packed offsets; serialize engine src/matrix/serialize.hpp:12-150).
//
// The device never wants packed or cyclic layouts (the matrix units want
// dense tiles) — but the HOST side still does: checkpoint
// export/import of triangular factors at half the bytes, and interchange
// with ScaLAPACK-style block-cyclic files. Those host transforms are pure
// memory-bandwidth loops, which is exactly where the reference used native
// code; Python/numpy fancy-indexing is 10-50x slower. Exposed via ctypes
// (capital_tpu_torch/native.py) with a numpy fallback when the library is
// absent. This is the PyTorch port's own copy of the JAX package's
// csrc/layout.cpp, with the same entry points and layouts.
//
// Build: capital_tpu_torch/native.py compiles it at first use with the host
// C++ compiler (c++ -O3 -std=c++17 -shared -fPIC -pthread) into
// capital_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

// run fn(lo, hi) over [0, n) split across hardware threads
template <typename F>
void parallel_rows(int64_t n, F fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nthreads = std::max<int64_t>(1, std::min<int64_t>(hw, n / 64));
  if (nthreads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// Row-major (m, n) global matrix -> per-process block-cyclic panels.
// Process grid pr x pc, block size bb. dst layout: for each process (i, j)
// (row-major process order), its local panel rows are the global rows
// r with (r / bb) % pr == i, in order; columns likewise.
// This is the ScaLAPACK 2D block-cyclic distribution; the reference's
// cyclic remap is the bb=1 special case (ref: util.hpp:72-99 cyclic layout
// with stride = number of processes).
void block_to_cyclic_f32(const float* src, float* dst, int64_t m, int64_t n,
                         int64_t pr, int64_t pc, int64_t bb) {
  int64_t lm = (m + pr * bb - 1) / (pr * bb) * bb;  // local rows per proc (padded)
  int64_t ln = (n + pc * bb - 1) / (pc * bb) * bb;  // local cols per proc (padded)
  parallel_rows(m, [=](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      int64_t pi = (r / bb) % pr;          // owner process row
      int64_t lr = (r / (pr * bb)) * bb + r % bb;  // local row index
      const float* srow = src + r * n;
      for (int64_t c = 0; c < n; ++c) {
        int64_t pj = (c / bb) % pc;
        int64_t lc = (c / (pc * bb)) * bb + c % bb;
        dst[((pi * pc + pj) * lm + lr) * ln + lc] = srow[c];
      }
    }
  });
}

// Inverse of block_to_cyclic_f32 (ref: cyclic_to_block_*, util.hpp:166-230).
void cyclic_to_block_f32(const float* src, float* dst, int64_t m, int64_t n,
                         int64_t pr, int64_t pc, int64_t bb) {
  int64_t lm = (m + pr * bb - 1) / (pr * bb) * bb;
  int64_t ln = (n + pc * bb - 1) / (pc * bb) * bb;
  parallel_rows(m, [=](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      int64_t pi = (r / bb) % pr;
      int64_t lr = (r / (pr * bb)) * bb + r % bb;
      float* drow = dst + r * n;
      for (int64_t c = 0; c < n; ++c) {
        int64_t pj = (c / bb) % pc;
        int64_t lc = (c / (pc * bb)) * bb + c % bb;
        drow[c] = src[((pi * pc + pj) * lm + lr) * ln + lc];
      }
    }
  });
}

// Dense (n, n) row-major -> packed upper triangle, column-major packed
// offset x*(x+1)/2 + y — the exact packed layout of the reference's
// uppertri structure (ref: structure.h:39 _offset_ formula).
void pack_upper_f32(const float* src, float* dst, int64_t n) {
  parallel_rows(n, [=](int64_t lo, int64_t hi) {
    for (int64_t col = lo; col < hi; ++col) {
      int64_t base = col * (col + 1) / 2;
      for (int64_t row = 0; row <= col; ++row)
        dst[base + row] = src[row * n + col];
    }
  });
}

void unpack_upper_f32(const float* src, float* dst, int64_t n) {
  parallel_rows(n, [=](int64_t lo, int64_t hi) {
    for (int64_t col = lo; col < hi; ++col) {
      int64_t base = col * (col + 1) / 2;
      for (int64_t row = 0; row < n; ++row)
        dst[row * n + col] = (row <= col) ? src[base + row] : 0.0f;
    }
  });
}

// Lower triangle packed: column-major segments, offset per reference
// lowertri (ref: structure.h:59): column j holds rows j..n-1.
void pack_lower_f32(const float* src, float* dst, int64_t n) {
  parallel_rows(n, [=](int64_t lo, int64_t hi) {
    for (int64_t col = lo; col < hi; ++col) {
      // offset of column col = sum_{k<col} (n - k) = col*n - col*(col-1)/2
      int64_t base = col * n - col * (col - 1) / 2;
      for (int64_t row = col; row < n; ++row)
        dst[base + (row - col)] = src[row * n + col];
    }
  });
}

void unpack_lower_f32(const float* src, float* dst, int64_t n) {
  parallel_rows(n, [=](int64_t lo, int64_t hi) {
    for (int64_t col = lo; col < hi; ++col) {
      int64_t base = col * n - col * (col - 1) / 2;
      for (int64_t row = 0; row < n; ++row)
        dst[row * n + col] = (row >= col) ? src[base + (row - col)] : 0.0f;
    }
  });
}

// Blocked out-of-place transpose (ref: util::transpose does the distributed
// version, util.hpp:232-247; this is the node-local leg used in export).
void transpose_f32(const float* src, float* dst, int64_t m, int64_t n) {
  constexpr int64_t TB = 64;
  parallel_rows((m + TB - 1) / TB, [=](int64_t lo, int64_t hi) {
    for (int64_t bi = lo; bi < hi; ++bi) {
      int64_t r0 = bi * TB, r1 = std::min(m, r0 + TB);
      for (int64_t c0 = 0; c0 < n; c0 += TB) {
        int64_t c1 = std::min(n, c0 + TB);
        for (int64_t r = r0; r < r1; ++r)
          for (int64_t c = c0; c < c1; ++c) dst[c * m + r] = src[r * n + c];
      }
    }
  });
}

}  // extern "C"
