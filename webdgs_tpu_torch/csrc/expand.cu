// Ragged per-Gaussian expansion: counts -> per-entry owner ids + binning
// words, channel-major.  Hopper (sm_90a) CUDA C++, plain C interface.
//
// Replaces the TPU kernel webdgs_tpu/ops/expand.py:_expand_kernel (launched
// by expand_fields, from binning.expand_entries).  The TPU version walks
// fixed blocks of Gaussians and selects byte planes of their words with
// one-hot MXU matmuls; here fixed spans of entry slots find their owners.
//
// What bounds it on the H100: memory writes.  Every slot writes 6 int32
// (5 words + id, 24 B); the count cumsum and the owners' words are read
// about once.  At a densify view most slots lie past the total (8.4M slots,
// 1.56M valid) and are zeros.
//
// Design:
// - A CTA owns kSpan = 1024 consecutive slots, 4 consecutive ones per
//   thread, so each output row takes one 16-byte store per thread.  A row
//   whose offset w * e_cap is not 16-byte aligned, and the last slots of
//   the capacity, take scalar stores.
// - A CTA whose span lies past the total writes zeros and reads nothing
//   but the total.
// - Otherwise two warps find the owners of the span's first and last valid
//   slot, g_lo and g_hi, by a 32-way search of the cumsum: each round one
//   probe per lane and a ballot, 5 rounds at 1.4M Gaussians where a binary
//   search takes 21 dependent loads.
// - The owner window cum_incl[g_lo..g_hi] is loaded into shared memory
//   with coalesced loads when it holds at most kWindow entries; each slot
//   then searches the window onward from its left neighbour's owner.  A
//   longer window (long runs of zero-count Gaussians: culled ones, dead
//   capacity) is searched in global memory inside [g_lo, g_hi] instead.
// - A thread finds its slots' owners first, then gathers and stores the
//   words row by row (neighbouring slots share owners, so the gathers hit
//   L1): few values live, 32 registers, 8 CTAs of 256 threads per SM.
//
// Contract: cum_incl is the inclusive cumsum of the per-Gaussian counts
// (N >= 1).  Slot e < total = cum_incl[N-1] gets the first j with
// cum_incl[j] > e; slots e >= total get id 0 and words 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 5;
constexpr int kThreads = 256;
constexpr int kVec = 4;                 // slots per thread
constexpr int kSpan = kThreads * kVec;  // 1024 slots per CTA
constexpr int kWindow = 4096;           // cumsum entries staged
constexpr int kCtasPerSm = 8;           // at most 32 registers
constexpr unsigned kFull = 0xffffffffu;

// First j in [lo, hi] with cum[j] > e, given cum[hi] > e.  Called by a
// whole warp; every lane returns it.  Each round probes 32 positions
// `step` apart and keeps the interval before the first probe above e.
__device__ int warp_owner(const int32_t* __restrict__ cum, int lo, int hi,
                          int e, int lane) {
  while (lo < hi) {
    const int step = (hi - lo) / 32 + 1;
    const int p = min(lo + lane * step, hi);
    const unsigned above = __ballot_sync(kFull, __ldg(cum + p) > e);
    if (above == 0u) {
      // every probe at or below e; the last probe fell short of hi
      lo = lo + 31 * step + 1;
    } else {
      const int k = __ffs(above) - 1;
      if (k == 0) return lo;
      hi = min(lo + k * step, hi);
      lo = lo + (k - 1) * step + 1;
    }
  }
  return lo;
}

// First j in [lo, hi] with win[j] > e, given win[hi] > e.
__device__ __forceinline__ int first_above(const int32_t* win, int lo,
                                           int hi, int e) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (win[mid] > e) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// First j' > j with win[j'] > e, given win[j] <= e < win[last]: probes
// j+1, j+2, j+4, ... (a run of zero-count Gaussians costs its logarithm,
// the next Gaussian one load), then bisects the last gap.
__device__ __forceinline__ int next_above(const int32_t* win, int j, int last,
                                          int e) {
  int lo = j + 1, hi = j + 1, step = 1;
  while (win[hi] <= e) {
    lo = hi + 1;
    hi = min(hi + step, last);
    step <<= 1;
  }
  return first_above(win, lo, hi, e);
}

__device__ __forceinline__ bool aligned16(const int32_t* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// kVec consecutive values into row[e..]: one 16-byte store where the row
// is aligned and all kVec slots lie in the span, else one store per slot.
__device__ __forceinline__ void store_slots(int32_t* row, bool aligned, int e,
                                            int n_in, const int32_t* v) {
  if (aligned && n_in >= kVec) {
    *reinterpret_cast<int4*>(row + e) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (i < n_in) row[e + i] = v[i];
    }
  }
}

// This thread's kVec slots of the span [e0, e0 + span).  win[j] =
// cum_incl[g_lo + j] for j in [0, last], in shared or global memory (each
// call is inlined where the kernel knows which).  Slots at or past the
// total get zeros.  The thread finds its slots' owners, stores their ids,
// then gathers and stores the words row by row (neighbouring slots share
// owners, so the gathers hit L1), which keeps few values live.
__device__ __forceinline__ void write_slots(
    const int32_t* __restrict__ words, const int32_t* win, int g_lo,
    int last, int n, int e_cap, int total, int e0, int span,
    int32_t* __restrict__ out_words, int32_t* __restrict__ out_ids) {
  const int off = threadIdx.x * kVec;
  if (off >= span) return;
  const int e = e0 + off;
  const int n_in = span - off;
  int j = 0;  // owner of the previous slot, relative to g_lo
  int32_t ids[kVec];
  unsigned valid = 0u;
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    ids[v] = 0;
    if (v < n_in && e + v < total) {
      if (win[j] <= e + v) j = next_above(win, j, last, e + v);
      ids[v] = g_lo + j;
      valid |= 1u << v;
    }
  }
  store_slots(out_ids, aligned16(out_ids), e, n_in, ids);
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int32_t* row = words + (size_t)w * n;
    int32_t vals[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      vals[v] = (valid >> v) & 1u ? __ldg(row + ids[v]) : 0;
    }
    int32_t* out_row = out_words + (size_t)w * e_cap;
    store_slots(out_row, aligned16(out_row), e, n_in, vals);
  }
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    expand_fields_kernel(const int32_t* __restrict__ words,
                         const int32_t* __restrict__ cum_incl, int n,
                         int e_cap, int32_t* __restrict__ out_words,
                         int32_t* __restrict__ out_ids) {
  __shared__ int32_t s_win[kWindow];
  __shared__ int s_owner[2];
  const int total = __ldg(cum_incl + n - 1);
  const int e0 = blockIdx.x * kSpan;
  const int span = min(kSpan, e_cap - e0);
  if (e0 >= total) {  // the whole span lies past the total: zeros
    write_slots(words, cum_incl, 0, 0, n, e_cap, total, e0, span,
                out_words, out_ids);
    return;
  }
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int e = warp == 0 ? e0 : min(e0 + span, total) - 1;
    const int g = warp_owner(cum_incl, 0, n - 1, e, threadIdx.x & 31);
    if ((threadIdx.x & 31) == 0) s_owner[warp] = g;
  }
  __syncthreads();
  const int g_lo = s_owner[0];
  const int last = s_owner[1] - g_lo;
  if (last < kWindow) {
    for (int i = threadIdx.x; i <= last; i += kThreads) {
      s_win[i] = __ldg(cum_incl + g_lo + i);
    }
    __syncthreads();
    write_slots(words, s_win, g_lo, last, n, e_cap, total, e0, span,
                out_words, out_ids);
  } else {
    write_slots(words, cum_incl + g_lo, g_lo, last, n, e_cap, total, e0,
                span, out_words, out_ids);
  }
}

}  // namespace

extern "C" int webdgs_expand_fields(const void* words, const void* cum_incl,
                                    int n, int e_cap, void* out_words,
                                    void* out_ids, void* stream) {
  if (n <= 0 || e_cap <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (e_cap - 1) / kSpan + 1;
  expand_fields_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(words),
      static_cast<const int32_t*>(cum_incl), n, e_cap,
      static_cast<int32_t*>(out_words), static_cast<int32_t*>(out_ids));
  return (int)cudaGetLastError();
}

// The launch shape: out = {threads, shared bytes, CTAs per SM, registers,
// slots per CTA, staged window}.
extern "C" int webdgs_expand_occupancy(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, expand_fields_kernel);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, expand_fields_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = kThreads;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = ctas;
  out[3] = attr.numRegs;
  out[4] = kSpan;
  out[5] = kWindow;
  return 0;
}

extern "C" const char* webdgs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
