// Per-Gaussian segment sum of per-entry rows that arrive in sorted-slot
// order.  Hopper (sm_90a) CUDA C++, plain C interface.
//
// Replaces the TPU kernel webdgs_tpu/ops/segsum.py:_segsum_kernel
// (launched by segment_sum_rows, called from segment_reduce_entries).  The
// TPU version needs its rows gathered into expansion order first (split
// into bf16 hi/lo halves for the MXU) and accumulates blocks of 512
// Gaussians by one-hot matmuls.  Here the function is bound by data
// movement, not arithmetic (one add per entry and channel), so the design
// is about layout.  The backward rasterizer hands over a channel-major
// (C, L) cotangent in sorted-slot order; in expansion order each Gaussian
// g owns the contiguous range [cum[g] - counts[g], cum[g]) of the
// inclusive count cumsum.  Gathering each entry through the inverse
// permutation reads C scattered rows at one scattered slot (C 32-byte
// sectors for 4C useful bytes) behind a chain of dependent index loads.
// Two passes instead, after a scan of the counts:
//
//  0. scan: the inclusive count cumsum, as a scan within blocks of 1024
//     Gaussians plus one block's scan of the block totals, whose last
//     entry is the entry total.  Integers: exact.
//  1. reorder: a CTA takes a tile of 256 consecutive sorted slots, loads
//     its (C, 256) rows, its entry_source and its valid flags with
//     coalesced loads into shared memory, and writes each slot's C values
//     as one contiguous row (float4 stores when C % 4 == 0) to row
//     entry_source[slot] of an (L, C) scratch in expansion order.
//  2. segment sum: a group of C consecutive threads owns one Gaussian
//     (half a warp at C = 16, one thread at C = 1) and sums its scratch
//     rows in ascending order in float32: at C = 16 each step is one
//     coalesced 64-byte load, and the loads of a range are independent of
//     each other, so they are issued in batches of 8.
//
// The entry total is read on the device, never on the host.  On the
// binning's inputs (ops/binning.py:bin_splats) the valid slots are exactly
// the prefix [0, total) of the sorted order (entry_valid = e_idx <
// total_kept), and entry_source maps that prefix one-to-one onto the
// expansion indices [0, total) (every expansion key past the total is the
// sentinel, which sorts last).  So pass 1 visits only slots below the
// total -- a persistent grid whose CTAs stop there -- and every scratch
// row pass 2 reads is written exactly once.  Within the prefix a slot
// whose valid flag is 0 writes a zero row; a slot at or past the total
// writes nothing.  Every index is bounded (total <= L, entry_source[slot]
// < total, k < L), so no input can make the kernel read or write outside
// its buffers.  Same order and type of accumulation as a serial
// per-Gaussian loop, no atomics: the result is the same on every run.
//
// Bytes at the 100k/800x600 training step (C = 16, 342k entries, 100k
// Gaussians): ~22 MB of rows in, ~22 MB of scratch out and back (which
// the 50 MB L2 can hold between the passes), 6.4 MB of sums out.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kScan = 1024;  // Gaussians per scan block (= threads)
constexpr int kSlots = 256;  // sorted slots per pass-1 tile (= threads)
constexpr int kChans = 16;   // channels per pass-1 tile; more go to grid.y
// shared row pitch: 258 = 2 (mod 32), so the 32 lanes of a float4 gather
// (8 slots x 4 channel quads) hit 32 distinct banks
constexpr int kPitch = kSlots + 2;
constexpr int kBatch = 8;  // pass-2 loads in flight per thread
constexpr unsigned kFull = 0xffffffffu;

// inclusive scan of v across a block of kScan threads; unsigned, so that
// garbage counts wrap instead of overflowing
__device__ unsigned block_scan(unsigned v, unsigned* warp_tot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_tot[w] = v;
  __syncthreads();
  if (w == 0) {
    unsigned s = warp_tot[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned u = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += u;
    }
    warp_tot[lane] = s;
  }
  __syncthreads();
  if (w > 0) v += warp_tot[w - 1];
  __syncthreads();  // warp_tot is free again
  return v;
}

// local[g]: inclusive scan of the counts within g's block of kScan;
// block_tot[b]: block b's total
__global__ void __launch_bounds__(kScan)
count_scan_kernel(const int32_t* __restrict__ counts, int n,
                  int32_t* __restrict__ local,
                  int32_t* __restrict__ block_tot) {
  __shared__ unsigned warp_tot[32];
  const int g = blockIdx.x * kScan + threadIdx.x;
  const unsigned v =
      block_scan(g < n ? (unsigned)counts[g] : 0u, warp_tot);
  if (g < n) local[g] = (int32_t)v;
  if (threadIdx.x == kScan - 1) block_tot[blockIdx.x] = (int32_t)v;
}

// block_off[b]: exclusive scan of the block totals; block_off[nb]: the
// entry total.  One CTA.
__global__ void __launch_bounds__(kScan)
block_offsets_kernel(const int32_t* __restrict__ block_tot, int nb,
                     int32_t* __restrict__ block_off) {
  __shared__ unsigned warp_tot[32];
  __shared__ unsigned chunk_tot;
  unsigned carry = 0;
  for (int base = 0; base < nb; base += kScan) {
    const int b = base + threadIdx.x;
    const unsigned own = b < nb ? (unsigned)block_tot[b] : 0u;
    const unsigned incl = block_scan(own, warp_tot);
    if (b < nb) block_off[b] = (int32_t)(carry + incl - own);
    if (threadIdx.x == kScan - 1) chunk_tot = incl;
    __syncthreads();
    carry += chunk_tot;
    __syncthreads();
  }
  if (threadIdx.x == 0) block_off[nb] = (int32_t)carry;
}

__global__ void __launch_bounds__(kSlots)
reorder_kernel(const float* __restrict__ rows, int n_rows, int64_t row_stride,
               const int32_t* __restrict__ src,
               const uint8_t* __restrict__ valid, int e_len,
               const int32_t* __restrict__ total_ptr,
               float* __restrict__ scratch) {
  __shared__ float tile[kChans * kPitch];
  __shared__ int dst[kSlots];
  const int total = min(max(*total_ptr, 0), e_len);
  const int c0 = blockIdx.y * kChans;
  const int cc = min(kChans, n_rows - c0);
  const int t = threadIdx.x;
  for (int64_t base = (int64_t)blockIdx.x * kSlots; base < total;
       base += (int64_t)gridDim.x * kSlots) {
    const int64_t slot = base + t;
    // the slot's index, flag and rows are loaded together (one round
    // trip, not a chain of three); a slot that writes nothing or whose
    // flag is 0 stages zeros
    int s = -1;
    bool flag = false;
    float v[kChans] = {};
    if (slot < total) {
      s = src[slot];
      flag = valid[slot] != 0;
      const float* r = rows + (int64_t)c0 * row_stride + slot;
#pragma unroll
      for (int c = 0; c < kChans; ++c) {
        if (c < cc) v[c] = r[c * row_stride];
      }
    }
    const bool in = s >= 0 && s < total;
    dst[t] = in ? s : -1;
#pragma unroll
    for (int c = 0; c < kChans; ++c) {
      if (c < cc) tile[c * kPitch + t] = in && flag ? v[c] : 0.f;
    }
    __syncthreads();
    if (n_rows % 4 == 0) {
      // one item = 4 consecutive channels of one slot: one float4 store,
      // 16-byte aligned since n_rows, c0 and 4q are multiples of 4
      const int per = cc / 4;
      for (int i = t; i < kSlots * per; i += kSlots) {
        const int sl = i / per, q = i - sl * per;
        const int kk = dst[sl];
        if (kk < 0) continue;
        const float* col = tile + 4 * q * kPitch + sl;
        const float4 v = make_float4(col[0], col[kPitch], col[2 * kPitch],
                                     col[3 * kPitch]);
        *reinterpret_cast<float4*>(scratch + kk * n_rows + c0 + 4 * q) = v;
      }
    } else {
      for (int i = t; i < kSlots * cc; i += kSlots) {
        const int sl = i / cc, c = i - sl * cc;
        const int kk = dst[sl];
        if (kk < 0) continue;
        scratch[kk * n_rows + c0 + c] = tile[c * kPitch + sl];
      }
    }
    __syncthreads();
  }
}

// kC: the channel count at compile time (the divisions by it become
// shifts), or 0 to take n_rows
template <int kC>
__global__ void segment_kernel(const float* __restrict__ scratch, int n_rows,
                               const int32_t* __restrict__ counts,
                               const int32_t* __restrict__ local,
                               const int32_t* __restrict__ block_off, int n,
                               int e_len, float* __restrict__ out) {
  const int C = kC > 0 ? kC : n_rows;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * C) return;
  const int g = idx / C;
  const int c = idx - g * C;
  const unsigned end = (unsigned)__ldg(local + g) +
                       (unsigned)__ldg(block_off + g / kScan);
  const int k0 = max((int)(end - (unsigned)__ldg(counts + g)), 0);
  const int k1 = min((int)end, e_len);
  const float* col = scratch + c;
  // the adds run in index order; a lane past the range adds +0, which
  // leaves the sum as it is (acc starts at +0 and so never holds -0)
  float acc = 0.f;
  for (int k = k0; k < k1; k += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      v[j] = k + j < k1 ? col[(k + j) * C] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) acc += v[j];
  }
  out[idx] = acc;  // (N, C) row-major
}

int launch(const float* rows, int n_rows, long long row_stride,
           const int32_t* src, const uint8_t* valid, int e_len,
           const int32_t* counts, int n, char* work, long long work_bytes,
           float* out, int device, cudaStream_t st) {
  const int nb = (n + kScan - 1) / kScan;
  const long long need = 4LL * ((long long)e_len * n_rows + n + 2LL * nb + 1);
  if (work_bytes < need) return (int)cudaErrorInvalidValue;
  float* scratch = reinterpret_cast<float*>(work);
  int32_t* local = reinterpret_cast<int32_t*>(scratch +
                                              (long long)e_len * n_rows);
  int32_t* block_tot = local + n;
  int32_t* block_off = block_tot + nb;  // nb + 1 entries

  count_scan_kernel<<<nb, kScan, 0, st>>>(counts, n, local, block_tot);
  block_offsets_kernel<<<1, kScan, 0, st>>>(block_tot, nb, block_off);
  if (e_len > 0) {
    // persistent: as many CTAs as fit on the card at once, each walking
    // tiles until the total (unknown on the host)
    static int per_sm = 0;
    if (per_sm == 0) {
      const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, reorder_kernel, kSlots, 0);
      if (e != cudaSuccess) return (int)e;
      per_sm = per_sm > 0 ? per_sm : 1;
    }
    int sms = 0;
    const cudaError_t e = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
    const int tiles = (e_len + kSlots - 1) / kSlots;
    const int fit = sms * per_sm;
    const dim3 grid(tiles < fit ? tiles : fit,
                    (n_rows + kChans - 1) / kChans);
    reorder_kernel<<<grid, kSlots, 0, st>>>(rows, n_rows, row_stride, src,
                                            valid, e_len, block_off + nb,
                                            scratch);
  }
  const unsigned blocks = (unsigned)(((long long)n * n_rows + 255) / 256);
  if (n_rows == 16) {
    segment_kernel<16><<<blocks, 256, 0, st>>>(
        scratch, n_rows, counts, local, block_off, n, e_len, out);
  } else if (n_rows == 1) {
    segment_kernel<1><<<blocks, 256, 0, st>>>(
        scratch, n_rows, counts, local, block_off, n, e_len, out);
  } else {
    segment_kernel<0><<<blocks, 256, 0, st>>>(
        scratch, n_rows, counts, local, block_off, n, e_len, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// rows: (n_rows, >= e_len) f32, row c at rows + c * row_stride, in
// sorted-slot order; src: (e_len,) i32 sorted slot -> expansion index;
// valid: (e_len,) u8; counts: (n,) i32 entries per Gaussian; work: at
// least 4 * (e_len * n_rows + n + 2 * ceil(n / 1024) + 1) bytes,
// uninitialised; out: (n, n_rows) f32.  Launches on `device`.
extern "C" int webdgs_segsum(const void* rows, int n_rows, long long row_stride,
                             const void* src, const void* valid, int e_len,
                             const void* counts, int n, void* work,
                             long long work_bytes, void* out, int device,
                             void* stream) {
  // 32-bit index math: the scratch and the output stay below 2^31 floats
  if (n_rows <= 0 || n < 0 || e_len < 0 || row_stride < e_len ||
      (long long)e_len * n_rows >= (1LL << 31) ||
      (long long)n * n_rows >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int err = launch(
      static_cast<const float*>(rows), n_rows, row_stride,
      static_cast<const int32_t*>(src), static_cast<const uint8_t*>(valid),
      e_len, static_cast<const int32_t*>(counts), n,
      static_cast<char*>(work), work_bytes, static_cast<float*>(out), device,
      (cudaStream_t)stream);
  if (prev != device) cudaSetDevice(prev);
  return err;
}
