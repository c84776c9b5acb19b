// Pieces shared by the raster kernels that walk each tile's depth-sorted
// entry range with double-buffered staging, rasterize_fwd.cu and
// rasterize_bwd.cu: 4-byte cp.async copies of the (16, E) entry rows into
// 12-float records in shared memory, and the heaviest-first launch order
// of the tiles.
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Entries [base, base + n) of the (16, E) rows into records rec[j * kRec +
// row]: consecutive threads read consecutive slots of one row.
__device__ __forceinline__ void stage(float* rec, const float* attrs,
                                      int e_len, int base, int n) {
  for (int row = 0; row < kUsedRows; ++row) {
    const float* src = attrs + (size_t)row * e_len + base;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      cp_async4(rec + j * kRec + row, src + j);
    }
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
