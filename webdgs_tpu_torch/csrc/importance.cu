// Importance counts for densification: for each sorted entry slot, the
// number of flagged pixels of its tile to which the entry contributes.
// Hopper (sm_90a) CUDA C++, plain C interface.
//
// Replaces the TPU kernel webdgs_tpu/ops/importance.py:_metric_kernel
// (with _metric_tile and _metric_replay; launched by _entry_counts, wrapped
// here by ops/importance.py:entry_counts).  An entry at 1-based position
// pos of its tile's range contributes to pixel p when p is flagged,
// pos <= n_contrib(p) (the forward kernel's last contributor) and the
// entry's alpha at p is >= alpha_min -- the same alpha expression as the
// forward kernel (splat_alpha.cuh), so the decisions agree with the
// n_contrib it wrote.
//
// What bounds it on the H100: instruction issue of the alpha test (a box
// test, then the conic, an accurate expf and two compares) over the
// (flagged pixel, entry) pairs with pos <= n_contrib.  The bytes are few:
// 8 rows of each entry a flagged pixel reaches, the (T, P, 2) pixels and
// the (E,) counts.  So the design makes the work follow those pairs and
// nothing else:
// - Only flagged pixels with n_contrib >= 1 take part.  A CTA reads its
//   tile's (flag, n_contrib) pairs and compacts those pixels into a list
//   of (px, py, n_contrib) records in shared memory (__ballot_sync and a
//   scan over the warps' counts, in pixel order).  A tile with none
//   returns at once; the entries past the largest such n_contrib are
//   never read.
// - The records are ordered by n_contrib, largest first, in buckets of
//   kBucketPos positions (a counting sort in shared memory, any order
//   within a bucket): the entry at pos walks only the records of its
//   position's bucket and above, since every record below has
//   n_contrib < pos, and tests n_contrib per record.
// - One thread per entry slot: it reads the entry's 8 used rows straight
//   from global memory (consecutive lanes, consecutive slots), walks the
//   records as shared-memory broadcasts, counts in a register and writes
//   its slot once.  One writer per slot, integer counts, no atomics: the
//   output is bit-identical from run to run.  Neighbouring lanes hold
//   neighbouring positions, so they stop at nearly the same record.
// - The extent-box test comes before the expf: outside the box the
//   decision is false whatever alpha is, so no result changes.  Inside it
//   the decision is splat_alpha.cuh's, operation for operation (accurate
//   expf, no fmaf, the -fmad=false build).
// - A tile's live entries split over at most kSplit CTAs, in whole passes
//   of kThreads, so a long, heavily flagged tile is not one CTA's serial
//   work; each of them builds the record list anew (a few KB from L2).
//   Tiles launch in index order, a tile's CTAs together: the heaviest-
//   first order of the raster kernels (tile_stage.cuh) ran ~8 % slower
//   here, its one-CTA sort kernel included.
// - Each CTA clamps its tile's range to 0 <= uo <= end <= E, so no offset
//   reads outside attrs16 and the wrapper reads nothing back.
// The thread-per-pixel version it replaces (one CTA of tile_px threads,
// every warp over every entry up to the largest flagged n_contrib, 8 rows
// staged per chunk, a ballot per entry and warp) took ~55x its bound at a
// 960x540 densify view, this one ~6x; chip_smoke.py --before-imp times the
// two in turns and --ablate-imp the parts of this design (PERF.md).  40
// registers per thread, no spills: 6 CTAs of 256 threads per SM at 32 x 16
// tiles, 14,608 bytes of shared memory each (webdgs_importance_occupancy).

#include <cstdint>
#include <cuda_runtime.h>

#include "splat_alpha.cuh"

namespace {

constexpr int kThreads = 256;        // threads per CTA, one slot each
constexpr int kSplit = 8;            // CTAs per tile, at most
constexpr bool kOrderPixels = true;  // records by n_contrib, largest first
constexpr int kBucketPos = 32;       // positions of n_contrib per bucket
constexpr int kNcBuckets = 256;      // buckets; the last is open-ended
constexpr int kMaxRounds = 1024 / kThreads;  // pixel rounds at 1024 pixels
constexpr unsigned kFull = 0xffffffffu;

// The bucket of an n_contrib (or of a position) in 1 .. live, counted
// from position 1; n_contrib past live counts as live.
__device__ __forceinline__ int bucket_of(int nc, int live, int nb) {
  return min((min(nc, live) - 1) / kBucketPos, nb - 1);
}

// dynamic shared memory per CTA: a record (float4) and two ints per pixel
constexpr size_t smem_bytes(int npix) {
  return (size_t)npix * (sizeof(float4) + 2 * sizeof(int));
}

__global__ void __launch_bounds__(kThreads) importance_kernel(
    const float* __restrict__ attrs, int e_len,
    const int32_t* __restrict__ offsets, const float* __restrict__ pix,
    int ntx, int tile_w, int tile_h, float alpha_min, float alpha_max,
    float* __restrict__ out) {
  extern __shared__ float4 rec[];  // (px, py, n_contrib bits, 0) per record
  __shared__ int grp_base[32];     // per (round, warp): records before it
  __shared__ int grp_max[32];      // per (round, warp): largest n_contrib
  __shared__ int s_count, s_max;
  __shared__ int bucket_cnt[kNcBuckets];
  __shared__ int bucket_end[kNcBuckets];

  const int npix = tile_w * tile_h;
  int* pix_of = reinterpret_cast<int*>(rec + npix);  // compacted, unordered
  int* nc_of = pix_of + npix;
  const int t = blockIdx.x / kSplit;
  const int seg = blockIdx.x % kSplit;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int nwarps = kThreads / 32;

  const int uo = min(max(offsets[t], 0), e_len);
  const int cnt = min(max(offsets[t + 1], uo), e_len) - uo;
  if (seg * kThreads >= cnt) return;  // no share of this range can be ours

  // 1. the tile's pixels that can count: flagged, n_contrib >= 1
  const float* tp = pix + (size_t)t * npix * 2;
  unsigned votes[kMaxRounds] = {};
  int nc_r[kMaxRounds] = {};
  int rounds = 0;
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) {
    if (r * kThreads >= npix) break;  // the same for every thread
    const int p = r * kThreads + tid;
    int nc = 0;
    if (p < npix && tp[2 * p] > 0.f) nc = (int)tp[2 * p + 1];
    nc_r[r] = nc;
    votes[r] = __ballot_sync(kFull, nc >= 1);
    const int m = __reduce_max_sync(kFull, nc >= 1 ? nc : 0);
    if (lane == 0) {
      grp_base[r * nwarps + warp] = __popc(votes[r]);
      grp_max[r * nwarps + warp] = m;
    }
    rounds = r + 1;
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the groups' counts, in pixel order
    const int groups = rounds * nwarps;  // <= 32 for tile_px <= 1024
    const int c = lane < groups ? grp_base[lane] : 0;
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    const int m = __reduce_max_sync(kFull, lane < groups ? grp_max[lane] : 0);
    if (lane < groups) grp_base[lane] = incl - c;
    if (lane == 31) s_count = incl;
    if (lane == 0) s_max = m;
  }
  __syncthreads();
  const int n_rec = s_count;
  const int live = min(cnt, s_max);  // 0 when no pixel can count
  // this CTA's share of [0, live): whole passes of kThreads slots
  const int seg_len =
      max(1, ((live + kSplit - 1) / kSplit + kThreads - 1) / kThreads) *
      kThreads;
  const int j0 = seg * seg_len;
  if (j0 >= live) return;  // the same for every thread
  const int j1 = min(j0 + seg_len, live);

  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) {
    if (r < rounds && nc_r[r] >= 1) {
      const int k = grp_base[r * nwarps + warp] + __popc(votes[r] & below);
      pix_of[k] = r * kThreads + tid;
      nc_of[k] = nc_r[r];
    }
  }
  __syncthreads();

  // 2. the records in buckets of kBucketPos positions of n_contrib
  // (clamped to live), the largest first: a counting sort, in any order
  // within a bucket.  bucket_end[b] = the records in buckets >= b.
  const int nb = min(kNcBuckets, (live + kBucketPos - 1) / kBucketPos);
  for (int b = tid; b < nb; b += kThreads) bucket_cnt[b] = 0;
  __syncthreads();
  if (kOrderPixels) {
    for (int i = tid; i < n_rec; i += kThreads) {
      atomicAdd(&bucket_cnt[bucket_of(nc_of[i], live, nb)], 1);
    }
  }
  __syncthreads();
  if (warp == 0) {  // suffix sums: lane l takes buckets nb-1-8l .. nb-8-8l
    constexpr int kPer = kNcBuckets / 32;
    int part[kPer];
    int run = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int b = nb - 1 - (lane * kPer + q);
      run += b >= 0 ? bucket_cnt[b] : 0;
      part[q] = run;
    }
    int incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int b = nb - 1 - (lane * kPer + q);
      if (b >= 0) bucket_end[b] = bucket_cnt[b] = incl - run + part[q];
    }
  }
  __syncthreads();
  const int x0 = (t % ntx) * tile_w, y0 = (t / ntx) * tile_h;
  for (int i = tid; i < n_rec; i += kThreads) {
    const int nc = nc_of[i];
    // bucket_cnt now holds each bucket's free end, filled downwards
    const int k = kOrderPixels
                      ? atomicSub(&bucket_cnt[bucket_of(nc, live, nb)], 1) - 1
                      : i;
    const int p = pix_of[i];
    rec[k] = make_float4((float)(x0 + p % tile_w) + 0.5f,
                         (float)(y0 + p / tile_w) + 0.5f, __int_as_float(nc),
                         0.f);
  }
  __syncthreads();

  // 3. one thread per entry slot of this CTA's share
  for (int j = j0 + tid; j < j1; j += kThreads) {
    const size_t e = (size_t)uo + j;
    const float cx = attrs[e], cy = attrs[e_len + e];
    const float ca = attrs[2 * (size_t)e_len + e];
    const float cb = attrs[3 * (size_t)e_len + e];
    const float cc = attrs[4 * (size_t)e_len + e];
    const float op = attrs[8 * (size_t)e_len + e];
    const float ex = attrs[9 * (size_t)e_len + e];
    const float ey = attrs[10 * (size_t)e_len + e];
    const int pos = j + 1;
    // the records of pos's bucket and above; below it every n_contrib < pos
    const int stop =
        kOrderPixels ? bucket_end[bucket_of(pos, live, nb)] : n_rec;
    int n = 0;
    for (int i = 0; i < stop; ++i) {
      const float4 q = rec[i];
      if (__float_as_int(q.z) < pos) continue;
      const float dx = q.x - cx, dy = q.y - cy;
      if (!(fabsf(dx) <= ex && fabsf(dy) <= ey)) continue;  // box first
      float alpha;
      n += splat_alpha(dx, dy, ca, cb, cc, op, ex, ey, alpha_min, alpha_max,
                       &alpha);
    }
    out[e] = (float)n;
  }
}

}  // namespace

// out: the zeroed (E,) counts; only slots inside a tile's range up to its
// largest flagged n_contrib are written.
extern "C" int webdgs_importance(const void* attrs16, int e_len,
                                 const void* tile_offsets, const void* pix,
                                 int n_tiles, int ntx, int tile_w, int tile_h,
                                 float alpha_min, float alpha_max, void* out,
                                 void* stream) {
  const int npix = tile_w * tile_h;
  if (n_tiles <= 0 || npix <= 0 || npix > 1024 || npix % 32 != 0 ||
      (long long)n_tiles * kSplit > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  importance_kernel<<<n_tiles * kSplit, kThreads, smem_bytes(npix),
                      (cudaStream_t)stream>>>(
      static_cast<const float*>(attrs16), e_len,
      static_cast<const int32_t*>(tile_offsets),
      static_cast<const float*>(pix), ntx, tile_w, tile_h, alpha_min,
      alpha_max, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The launch shape for a tile of tile_w x tile_h pixels: out[0..4] =
// threads per CTA, shared bytes per CTA (dynamic and static), CTAs per SM
// that the kernel's registers, shared memory and threads allow on the
// current device, registers per thread, CTAs per tile at most (kSplit).
extern "C" int webdgs_importance_occupancy(int tile_w, int tile_h,
                                           int* out) {
  const int npix = tile_w * tile_h;
  if (npix <= 0 || npix > 1024 || npix % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  int blocks = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, importance_kernel, kThreads, smem_bytes(npix));
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, importance_kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = kThreads;
  out[1] = (int)(smem_bytes(npix) + attr.sharedSizeBytes);
  out[2] = blocks;
  out[3] = attr.numRegs;
  out[4] = kSplit;
  return (int)cudaSuccess;
}
