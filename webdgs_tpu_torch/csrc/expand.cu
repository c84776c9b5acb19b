// Ragged per-Gaussian expansion: counts -> per-entry owner ids + binning
// words, channel-major.  Hopper (sm_90a) CUDA C++, plain C interface.
//
// Replaces the TPU kernel webdgs_tpu/ops/expand.py:_expand_kernel (launched
// by expand_fields, from binning.expand_entries).  The TPU version selects
// byte planes of the words through one-hot MXU matmuls; here each entry
// slot finds its owner directly.
//
// What bounds it on the H100: memory writes.  Every slot writes 6 int32
// (5 words + id, 24 B) and reads 5 words of its owner; the binary search
// over the inclusive count cumsum (log2 N ~ 17 steps at 100k Gaussians)
// reads a few cache lines that neighbouring slots share, so it stays in
// L1/L2.  Writes are coalesced: consecutive threads write consecutive slots
// of each output row.
//
// This is the first, simple, correct version: one thread per slot, no
// shared-memory staging of the cumsum, no vectorised stores.
//
// Contract: cum_incl is the inclusive cumsum of the per-Gaussian counts
// (N >= 1).  Slot e < total = cum_incl[N-1] gets the first j with
// cum_incl[j] > e; slots e >= total get id 0 and words 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 5;

__global__ void expand_fields_kernel(const int32_t* __restrict__ words,
                                     const int32_t* __restrict__ cum_incl,
                                     int n, int e_cap,
                                     int32_t* __restrict__ out_words,
                                     int32_t* __restrict__ out_ids) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= e_cap) return;
  const int total = cum_incl[n - 1];
  if (e >= total) {
    for (int w = 0; w < kWords; ++w) out_words[(size_t)w * e_cap + e] = 0;
    out_ids[e] = 0;
    return;
  }
  // first j with cum_incl[j] > e (exists because e < cum_incl[n-1])
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (cum_incl[mid] > e) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  for (int w = 0; w < kWords; ++w) {
    out_words[(size_t)w * e_cap + e] = words[(size_t)w * n + lo];
  }
  out_ids[e] = lo;
}

}  // namespace

extern "C" int webdgs_expand_fields(const void* words, const void* cum_incl,
                                    int n, int e_cap, void* out_words,
                                    void* out_ids, void* stream) {
  if (n <= 0 || e_cap <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (e_cap + threads - 1) / threads;
  expand_fields_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(words),
      static_cast<const int32_t*>(cum_incl), n, e_cap,
      static_cast<int32_t*>(out_words), static_cast<int32_t*>(out_ids));
  return (int)cudaGetLastError();
}

extern "C" const char* webdgs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
