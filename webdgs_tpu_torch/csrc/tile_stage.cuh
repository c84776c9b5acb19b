// Pieces shared by the kernels that read each tile's depth-sorted entry
// range: where an entry slot's attributes live (EntrySrc: packed (16, E)
// rows, or the Gaussian the slot's index names), the double-buffered
// cp.async staging of the raster kernels, rasterize_fwd.cu and
// rasterize_bwd.cu, into 12-float records in shared memory, the plain
// loads of the importance kernel, importance.cu, and the heaviest-first
// launch order of the raster kernels' tiles.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUsedRows = 11;  // cx .. ey (ops/rasterize.py ROW_*)
constexpr int kRec = 12;       // floats per staged record (one pad)

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// cp_async4, or with `full` false 4 zero bytes and no read of src (the
// src-size operand 0)
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src,
                                                bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where the attributes of entry slot e (0 <= e < e_len) live.  With rows
// set, the packed (16, E) rows: word `row` at rows[row * e_len + e]
// (ops/rasterize.py ROW_*).  Otherwise Gaussian gauss[e]'s own attributes
// in the five per-Gaussian tensors, the same 11 words: centre (N, 2),
// conic (N, 3), colour (N, 3), opacity (N,), extents (N, 2).  A slot whose
// valid[e] is false reads as 11 zeros, as the packed rows hold it, and its
// gauss[e] is never dereferenced: it may hold anything.
struct EntrySrc {
  const float* rows;
  const int32_t* gauss;
  const bool* valid;
  const float* center;
  const float* conic;
  const float* color;
  const float* opacity;
  const float* extents;
  int e_len;
};

inline EntrySrc packed_src(const void* rows, int e_len) {
  return {static_cast<const float*>(rows), nullptr, nullptr, nullptr,
          nullptr, nullptr, nullptr, nullptr, e_len};
}

inline EntrySrc indexed_src(const void* gauss, const void* valid,
                            const void* center, const void* conic,
                            const void* color, const void* opacity,
                            const void* extents, int e_len) {
  return {nullptr,
          static_cast<const int32_t*>(gauss),
          static_cast<const bool*>(valid),
          static_cast<const float*>(center),
          static_cast<const float*>(conic),
          static_cast<const float*>(color),
          static_cast<const float*>(opacity),
          static_cast<const float*>(extents),
          e_len};
}

// Word `row` of Gaussian g (row a constant once the caller's loop unrolls).
__device__ __forceinline__ const float* gauss_word(const EntrySrc& s,
                                                   size_t g, int row) {
  return row < 2   ? s.center + 2 * g + row
         : row < 5 ? s.conic + 3 * g + (row - 2)
         : row < 8 ? s.color + 3 * g + (row - 5)
         : row < 9 ? s.opacity + g
                   : s.extents + 2 * g + (row - 9);
}

// The slot's Gaussian, and whether the slot holds one (0 where not, so
// every address formed from it stays inside the tensors when N > 0).
__device__ __forceinline__ size_t slot_gauss(const EntrySrc& s, int e,
                                             bool* ok) {
  const int32_t g = __ldg(s.gauss + e);
  *ok = __ldg(reinterpret_cast<const unsigned char*>(s.valid) + e) != 0;
  return *ok ? (size_t)(uint32_t)g : 0;
}

// Entries [base, base + n) into records rec[j * kRec + row].  Packed rows:
// consecutive threads read consecutive slots of one row.  Through the
// index: a thread loads its slot's index and flag, then copies the
// Gaussian's 11 words (zero-filled for an invalid slot) into its record.
__device__ __forceinline__ void stage(float* rec, const EntrySrc& src,
                                      int base, int n) {
  if (src.gauss == nullptr) {
    for (int row = 0; row < kUsedRows; ++row) {
      const float* p = src.rows + (size_t)row * src.e_len + base;
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        cp_async4(rec + j * kRec + row, p + j);
      }
    }
    return;
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    bool ok;
    const size_t g = slot_gauss(src, base + j, &ok);
#pragma unroll
    for (int row = 0; row < kUsedRows; ++row) {
      cp_async4_zfill(rec + j * kRec + row, gauss_word(src, g, row),
                      ok);
    }
  }
}

// Slot e's 11 words by plain loads, for a kernel that reads each slot once.
__device__ __forceinline__ void load_entry(const EntrySrc& src, int e,
                                           float (&w)[kUsedRows]) {
  if (src.gauss == nullptr) {
#pragma unroll
    for (int row = 0; row < kUsedRows; ++row) {
      w[row] = __ldg(src.rows + (size_t)row * src.e_len + e);
    }
    return;
  }
  bool ok;
  const size_t g = slot_gauss(src, e, &ok);
#pragma unroll
  for (int row = 0; row < kUsedRows; ++row) {
    w[row] = ok ? __ldg(gauss_word(src, g, row)) : 0.f;
  }
}

// The heaviest tiles first: a counting sort of the tiles into kBuckets
// buckets of their clamped entry count (4 per octave, the largest counts
// first), one CTA.  Only the order in which tiles are launched changes,
// never a result (each tile writes its own slots alone), so the atomics'
// order within a bucket does not matter.  It shortens the last wave: a
// heavy tile launched late would run on an otherwise idle SM.
constexpr int kBuckets = 128;

__device__ __forceinline__ int count_bucket(const int32_t* offsets, int t,
                                            int e_len) {
  const int uo = min(max(offsets[t], 0), e_len);
  const int cnt = min(max(offsets[t + 1], uo), e_len) - uo;
  if (cnt <= 0) return kBuckets - 1;
  const int lg = 31 - __clz(cnt);
  const int frac = (lg >= 2 ? cnt >> (lg - 2) : cnt << (2 - lg)) & 3;
  return kBuckets - 1 - (lg * 4 + frac);
}

__global__ void tile_order_kernel(const int32_t* __restrict__ offsets,
                                  int n_tiles, int e_len,
                                  int32_t* __restrict__ order) {
  __shared__ int start[kBuckets];
  for (int b = threadIdx.x; b < kBuckets; b += blockDim.x) start[b] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
    atomicAdd(&start[count_bucket(offsets, t, e_len)], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // exclusive scan of the bucket sizes
    int run = 0;
    for (int b = 0; b < kBuckets; ++b) {
      const int c = start[b];
      start[b] = run;
      run += c;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
    order[atomicAdd(&start[count_bucket(offsets, t, e_len)], 1)] = t;
  }
}

}  // namespace
