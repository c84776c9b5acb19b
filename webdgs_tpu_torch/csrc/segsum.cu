// Per-Gaussian segment sum of per-entry gradient rows, with the
// expansion-order gather fused in.  Hopper (sm_90a) CUDA C++, plain C
// interface.
//
// Replaces the TPU kernel webdgs_tpu/ops/segsum.py:_segsum_kernel
// (launched by segment_sum_rows, called from segment_reduce_entries).  The
// TPU version needs its rows gathered into expansion order first (split
// into bf16 hi/lo halves for the MXU) and accumulates blocks of 512
// Gaussians by one-hot matmuls.  Here one thread owns one (Gaussian, row)
// pair and sums, in expansion-index order, the rows of that Gaussian's
// contiguous expansion range [starts[g], starts[g+1]), reading each entry
// through the inverse sort permutation (slot = slots[k]) straight from the
// channel-major (C, L) cotangent the backward rasterizer wrote in
// sorted-slot order.  No atomics: the result is the same on every run.
// Accumulation is float32 with no hi/lo split.  A slot whose valid flag is
// 0 contributes nothing.
//
// What bounds it on the H100: device memory -- each entry row (C floats)
// read once, and each Gaussian's C sums written once.  The gathers are
// scattered (a permutation), so each 4-byte read pulls a 32-byte sector;
// this first, simple version leaves that to the L2 cache.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void segsum_kernel(const float* __restrict__ rows, int n_rows,
                              int64_t row_stride,
                              const int32_t* __restrict__ slots,
                              const uint8_t* __restrict__ valid,
                              const int32_t* __restrict__ starts, int n,
                              float* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)n * n_rows) return;
  const int g = (int)(idx / n_rows);
  const int c = (int)(idx - (int64_t)g * n_rows);
  const float* row = rows + (int64_t)c * row_stride;
  const int k1 = starts[g + 1];
  float acc = 0.f;
  for (int k = starts[g]; k < k1; ++k) {
    const int slot = slots[k];
    if (valid[slot]) acc += row[slot];
  }
  out[idx] = acc;  // (N, C) row-major
}

}  // namespace

extern "C" int webdgs_segsum(const void* rows, int n_rows, long long row_stride,
                             const void* slots, const void* valid,
                             const void* starts, int n, void* out,
                             void* stream) {
  if (n_rows <= 0 || n < 0 || row_stride < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long work = (long long)n * n_rows;
  const unsigned blocks = (unsigned)((work + threads - 1) / threads);
  segsum_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(rows), n_rows, (int64_t)row_stride,
      static_cast<const int32_t*>(slots), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(starts), n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
