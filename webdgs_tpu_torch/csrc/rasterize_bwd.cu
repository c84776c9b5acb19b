// Backward tile rasterizer: per-entry cotangents of centre (2), conic (3),
// colour (3) and opacity (1) from the per-pixel cotangents of the forward
// output.  Hopper (sm_90a) CUDA C++, plain C interface.
//
// Replaces the TPU kernel webdgs_tpu/ops/rasterize.py:_bwd_kernel
// (launched by _backward_impl, the custom VJP of rasterize_tiles).  The
// TPU version forms the chunk's prefix sums with triangular MXU matmuls,
// reduces over pixels with MXU contractions, and writes chunk-aligned DMA
// windows with a read-modify-write of boundary chunks shared with the
// previous tile.  Here one CTA owns one tile and writes only its own slots
// [uo, end) of a zero-initialised (16, E) buffer, so windows, masks, zero
// fills and the read-modify-write have no counterpart.
//
// The function.  Per pixel, the tile's entries are walked front to back,
// recomputing alpha and the exclusive transmittance T exactly as the
// forward kernel does: the alpha decision through splat_alpha.cuh, then
// log T += log1pf(-alpha), T = expf(log T), done once T < t_threshold.
// The pixel carries cum_u = sum gamma * w (inclusive) and forms
//   dL/dalpha = gamma * T - (suffix - cum_u) / (1 - alpha),
// gamma = sum_c g_c * colour_c + g_acc, from the per-pixel suffix term
// suffix = sum_c g_c * out_c + g_acc * acc + g_T * T_final folded outside
// the kernel (the TPU kernel's identity, rasterize.py:432-481): no
// back-to-front replay.  With G = exp(-power/2), unclamped = op*G < alpha_max
// (alpha < alpha_max):
//   d_op = dL/dalpha * G (0 when clamped), q = d_op * (-op/2),
//   d_colour_c = g_c * w,
// and the per-entry sums over the tile's pixels of
//   d r, d g, d b, d op, S_qx, S_qy, sum qx*dx, sum qx*dy, sum qy*dy
// (qx = q*dx, qy = q*dy) give d_cx = -2 (ca S_qx + cb S_qy),
// d_cy = -2 (cb S_qx + cc S_qy), d_ca = sum qx dx, d_cb = 2 sum qx dy,
// d_cc = sum qy dy.  Rows 9-15 (extents, spare) stay 0.  Each CTA clamps
// its range to 0 <= uo <= end <= E (as the plain version does), so no
// offsets read or write outside the buffers and the wrapper reads nothing
// back.
//
// What bounds it, on an H100 80GB HBM3 at 700 W at the 100k / 800x600
// bench training step (950 tiles of 32 x 16, 342,079 entries, 39.8M
// evaluated (pixel, entry) pairs; chip_smoke.py): instruction issue,
// inferred from timing probes (chip_smoke.py --ablate-bwd times copies of
// this file with one part taken out; no pipe counters are read).  Memory
// traffic is small, and the bound from 54 fp32 operations per pair is
// 0.032 ms against the kernel's ~0.23 ms.  The largest parts are the
// butterfly, the accurate log1pf/expf of the transmittance (they must
// stay: they decide which pairs count) and the per-pair alpha test and
// gradient algebra, issued for every group of 32 pixels in which one lane
// needs it (shares in PERF.md).  A tile visits 169 entries on average
// before its pixels saturate, 384 at most, so the last wave matters.
//
// The design, point by point against the thread-per-pixel version it
// replaces (45 shuffles and 9 shared stores per warp and entry, 11 scalar
// shared loads per pair, synchronous staging, a cross-warp pass every 32
// entries: 0.50 ms at that step, chip_smoke.py --before-bwd):
// - kR = 4 pixels per thread, so a CTA has tile_px / 4 threads (128 at
//   32 x 16).  A warp owns 4 groups of 32 pixels, each an 8 x 4 block of
//   the tile (a run of 32 where the tile does not divide into blocks): in
//   a block fewer lanes outside a small splat's box sit beside lanes
//   inside it than in a row, and rows run slower.  A thread sums its 4
//   pairs' 9 terms in registers, so each shuffle covers 128 pixels.
// - Entries are staged as 12-float records (cx cy ca cb | cc r g b | op ex
//   ey pad): three 16-byte broadcast loads per entry and thread, shared by
//   its 4 pixels, in place of 11 scalar loads per pair.
// - A batched butterfly over kB = 4 entries: their 9 sums are
//   reduce-scattered across the warp (lane ^ 16 exchanges half the batch,
//   lane ^ 8 the other half of what is left: 9 (kB - 1) shuffles), then
//   5 - log2 kB xor steps finish each entry's sum: 54 shuffles per 4
//   entries in place of 180.  A batch in which no lane of the warp is live
//   is skipped (its sums are exact zeros).  The order is fixed, so repeats
//   are bit-identical.  kB = 8 needs more registers (3 CTAs per SM) and
//   twice the unrolled code, and runs slower; kR = 2 halves the CTAs per
//   SM and runs slower too.
// - The cross-warp pass runs once per 128 entries (once per chunk at the
//   default chunk): warp partials staged in shared memory, summed in warp
//   order, then one thread per entry writes its 9 rows, coalesced along E.
// - Double-buffered staging: chunk c + 1 is fetched with 4-byte cp.async
//   (a tile's uo has any alignment, and the copy transposes rows into
//   records) while chunk c computes; one barrier per chunk waits for it.
//   The training step's entries are staged through the binning's index,
//   as the forward kernel's (webdgs_rasterize_bwd_indexed); the per-slot
//   cotangents are written to the (16, E) output all the same, which the
//   segment sum reduces per Gaussian.
// - A pixel outside an entry's extent box skips the Gaussian's expf: the
//   forward's decision there is false whatever alpha is (without the skip
//   the kernel runs longer).  The decisions stay the forward's
//   operation for operation (splat_alpha.cuh, accurate expf/log1pf, the
//   -fmad=false build); the gradient algebra after them uses explicit fmaf
//   and __fdividef, which that flag does not forbid.
// - Tiles launch heaviest first: a one-CTA counting sort of the tiles by
//   entry count (tile_order_kernel, into the wrapper's scratch) gives the
//   launch order, so no heavy tile starts last.
// 128 registers per thread, no spills: 4 CTAs (16 warps) per SM at 32 x 16
// tiles and chunk 128, with 30,720 bytes of shared memory each.

#include <cstdint>
#include <cuda_runtime.h>

#include "splat_alpha.cuh"
#include "tile_stage.cuh"

namespace {

constexpr int kR = 4;  // pixels per thread
constexpr int kB = 4;  // entries per butterfly batch
constexpr int log2i(int x) { return x > 1 ? 1 + log2i(x >> 1) : 0; }
constexpr int kLogB = log2i(kB);
static_assert((1 << kLogB) == kB && kB <= 32, "kB: a power of 2 <= 32");

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowCx = 0, kRowCy = 1, kRowCa = 2, kRowCb = 3, kRowCc = 4;
constexpr int kRowR = 5, kRowG = 6, kRowB = 7, kRowOp = 8;
constexpr int kNumGpix = 5;    // d r, d g, d b, d acc, suffix
constexpr int kNumSums = 9;
constexpr int kMaxSub = 128;   // entries per cross-warp pass

// Sum v[e][k] over the warp for each entry e of the batch.  Afterwards the
// lane's v[0] holds the sums of entry sum_s bit(lane, 16 >> s) * (kB >> (s
// + 1)) -- the same entry in each group of 32 / kB lanes.
__device__ __forceinline__ void warp_sum_batch(float (&v)[kB][kNumSums],
                                               int lane) {
  // reduce-scatter: at offset o the lane keeps the half of its batch that
  // its bit o selects and adds its partner's copy of that half
#pragma unroll
  for (int s = 0; s < kLogB; ++s) {
    const int h = kB >> (s + 1);
    const int o = 16 >> s;
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
#pragma unroll
      for (int k = 0; k < kNumSums; ++k) {
        const float send = upper ? v[i][k] : v[i + h][k];
        const float keep = upper ? v[i + h][k] : v[i][k];
        v[i][k] = keep + __shfl_xor_sync(kFull, send, o);
      }
    }
  }
  // all-reduce over the lanes that hold the same entry
#pragma unroll
  for (int o = 16 >> kLogB; o >= 1; o >>= 1) {
#pragma unroll
    for (int k = 0; k < kNumSums; ++k) {
      v[0][k] += __shfl_xor_sync(kFull, v[0][k], o);
    }
  }
}

__global__ void __launch_bounds__(1024 / kR) rasterize_bwd_kernel(
    const EntrySrc src, const int32_t* __restrict__ offsets,
    const float* __restrict__ gpix, int ntx, int tile_w, int tile_h, int chunk, int sub, float alpha_min,
    float alpha_max, float t_threshold, float log_t_min,
    float* __restrict__ d_attrs, const int32_t* __restrict__ order) {
  extern __shared__ __align__(16) float smem[];
  const int rec_stride = chunk * kRec;
  float* recs = smem;                      // 2 buffers x chunk x kRec
  float* partial = smem + 2 * rec_stride;  // nwarps x 9 x sub

  const int t = order[blockIdx.x];  // heaviest tiles first
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int npix = tile_w * tile_h;
  const int e_len = src.e_len;
  const int uo = min(max(offsets[t], 0), e_len);
  const int end = min(max(offsets[t + 1], uo), e_len);
  const int cnt = end - uo;

  // the lane's entry after warp_sum_batch
  int my_entry = 0;
#pragma unroll
  for (int s = 0; s < kLogB; ++s) {
    if (lane & (16 >> s)) my_entry += kB >> (s + 1);
  }
  const bool leader = (lane & ((32 >> kLogB) - 1)) == 0;

  // the warp's pixels: kR groups of 32, group g the g-th 8 x 4 block of
  // the tile in row-major block order, or its g-th run of 32 pixels where
  // the tile does not divide into such blocks
  const bool blocked = tile_w % 8 == 0 && tile_h % 4 == 0;
  float px[kR], py[kR], g_r[kR], g_g[kR], g_b[kR], g_acc[kR], suffix[kR];
  float log_t_un[kR], t_cur[kR], cum_u[kR];
  bool done[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int g = warp * kR + r;
    const int p = blocked ? ((g / (tile_w >> 3)) * 4 + (lane >> 3)) * tile_w +
                                (g % (tile_w >> 3)) * 8 + (lane & 7)
                          : g * 32 + lane;
    const bool real = p < npix;
    px[r] = (float)((t % ntx) * tile_w + p % tile_w) + 0.5f;
    py[r] = (float)((t / ntx) * tile_h + p / tile_w) + 0.5f;
    const float* gp = gpix + (size_t)t * kNumGpix * npix + p;
    g_r[r] = real ? gp[0 * npix] : 0.f;
    g_g[r] = real ? gp[1 * npix] : 0.f;
    g_b[r] = real ? gp[2 * npix] : 0.f;
    g_acc[r] = real ? gp[3 * npix] : 0.f;
    suffix[r] = real ? gp[4 * npix] : 0.f;
    log_t_un[r] = 0.f;
    t_cur[r] = 1.f;
    cum_u[r] = 0.f;
    done[r] = !real || !(t_cur[r] >= t_threshold);
  }

  if (cnt > 0) stage(recs, src, uo, min(chunk, cnt));
  cp_async_commit();
  int buf = 0;
  for (int c0 = 0; c0 < cnt; c0 += chunk, buf ^= 1) {
    const int n_in = min(chunk, cnt - c0);
    // fetch the next chunk into the other buffer while this one computes
    // (its last reader passed the barrier that ended the previous chunk)
    if (c0 + chunk < cnt) {
      stage(recs + (buf ^ 1) * rec_stride, src, uo + c0 + chunk,
            min(chunk, cnt - c0 - chunk));
    }
    cp_async_commit();
    cp_async_wait<1>();  // this chunk's copies, not the next one's
    __syncthreads();
    const float* rec = recs + buf * rec_stride;

    for (int s0 = 0; s0 < n_in; s0 += sub) {
      const int n_sub = min(sub, n_in - s0);
      if (s0 > 0) __syncthreads();  // the last pass read its partials
      for (int b0 = 0; b0 < n_sub; b0 += kB) {
        float v[kB][kNumSums];
#pragma unroll
        for (int e = 0; e < kB; ++e) {
#pragma unroll
          for (int k = 0; k < kNumSums; ++k) v[e][k] = 0.f;
        }
        bool active = false;
#pragma unroll
        for (int r = 0; r < kR; ++r) active |= !done[r];
        bool live_any = false;
        if (__any_sync(kFull, active)) {
#pragma unroll
          for (int e = 0; e < kB; ++e) {
            if (b0 + e >= n_sub) break;
            const float4* q =
                reinterpret_cast<const float4*>(rec + (s0 + b0 + e) * kRec);
            const float4 c0123 = q[0];  // cx cy ca cb
            const float4 c4567 = q[1];  // cc r g b
            const float4 c89ab = q[2];  // op ex ey pad
            const float mhop = -0.5f * c89ab.x;
#pragma unroll
            for (int r = 0; r < kR; ++r) {
              if (done[r]) continue;
              const float dx = px[r] - c0123.x;
              const float dy = py[r] - c0123.y;
              // outside the extent box the decision is false whatever
              // alpha is: skip the Gaussian's expf
              if (!(fabsf(dx) <= c89ab.y && fabsf(dy) <= c89ab.z)) continue;
              float alpha, gw;
              if (!splat_alpha_weight(dx, dy, c0123.z, c0123.w, c4567.x,
                                      c89ab.x, c89ab.y, c89ab.z, alpha_min,
                                      alpha_max, &alpha, &gw)) {
                continue;
              }
              live_any = true;
              const float w = alpha * t_cur[r];
              const float gamma =
                  fmaf(g_r[r], c4567.y,
                       fmaf(g_g[r], c4567.z, fmaf(g_b[r], c4567.w, g_acc[r])));
              cum_u[r] = fmaf(gamma, w, cum_u[r]);
              const float dl_da =
                  fmaf(gamma, t_cur[r],
                       -__fdividef(suffix[r] - cum_u[r], 1.f - alpha));
              const float d_op = alpha < alpha_max ? dl_da * gw : 0.f;
              const float qq = d_op * mhop;
              const float qx = qq * dx;
              const float qy = qq * dy;
              v[e][0] = fmaf(g_r[r], w, v[e][0]);
              v[e][1] = fmaf(g_g[r], w, v[e][1]);
              v[e][2] = fmaf(g_b[r], w, v[e][2]);
              v[e][3] += d_op;
              v[e][4] += qx;
              v[e][5] += qy;
              v[e][6] = fmaf(qx, dx, v[e][6]);
              v[e][7] = fmaf(qx, dy, v[e][7]);
              v[e][8] = fmaf(qy, dy, v[e][8]);
              // the forward's transmittance update, op for op
              log_t_un[r] += log1pf(-alpha);
              t_cur[r] = expf(log_t_un[r]);
              done[r] = !(t_cur[r] >= t_threshold);
            }
          }
        }
        // a batch with no live lane keeps its exact zeros
        if (__any_sync(kFull, live_any)) warp_sum_batch(v, lane);
        if (leader && b0 + my_entry < n_sub) {
#pragma unroll
          for (int k = 0; k < kNumSums; ++k) {
            partial[(warp * kNumSums + k) * sub + b0 + my_entry] = v[0][k];
          }
        }
      }
      __syncthreads();
      // one thread per entry: the warp partials in warp order, then the
      // entry's 9 rows
      for (int j = tid; j < n_sub; j += nthreads) {
        float s[kNumSums];
#pragma unroll
        for (int k = 0; k < kNumSums; ++k) s[k] = partial[k * sub + j];
        for (int w = 1; w < nwarps; ++w) {
#pragma unroll
          for (int k = 0; k < kNumSums; ++k) {
            s[k] += partial[(w * kNumSums + k) * sub + j];
          }
        }
        const float* q = rec + (s0 + j) * kRec;
        const float ca = q[kRowCa], cb = q[kRowCb], cc = q[kRowCc];
        float* o = d_attrs + uo + c0 + s0 + j;
        o[(size_t)kRowCx * e_len] = -2.f * (ca * s[4] + cb * s[5]);
        o[(size_t)kRowCy * e_len] = -2.f * (cb * s[4] + cc * s[5]);
        o[(size_t)kRowCa * e_len] = s[6];
        o[(size_t)kRowCb * e_len] = 2.f * s[7];
        o[(size_t)kRowCc * e_len] = s[8];
        o[(size_t)kRowR * e_len] = s[0];
        o[(size_t)kRowG * e_len] = s[1];
        o[(size_t)kRowB * e_len] = s[2];
        o[(size_t)kRowOp * e_len] = s[3];
      }
    }
    // the tile stops once no pixel is still compositing (the forward's
    // test); the barrier also ends every read of this chunk's buffer
    bool more = false;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      more |= !done[r] && log_t_un[r] >= log_t_min;
    }
    if (!__syncthreads_or(more)) break;
  }
  cp_async_wait<0>();  // a prefetch the early exit left in flight
}

// Threads and dynamic shared bytes of the kernel for this tile and chunk,
// with the shared-memory opt-in above 48 KB.
cudaError_t launch_shape(int tile_w, int tile_h, int chunk, int* threads,
                         size_t* smem) {
  const int npix = tile_w * tile_h;
  if (npix <= 0 || npix > 1024 || chunk <= 0) return cudaErrorInvalidValue;
  // whole warps of 32 x kR pixels: pixels past npix are idle lanes that
  // contribute zeros
  *threads = (npix + 32 * kR - 1) / (32 * kR) * 32;
  const int sub = chunk < kMaxSub ? chunk : kMaxSub;
  *smem = sizeof(float) * ((size_t)2 * chunk * kRec +
                           (size_t)(*threads / 32) * kNumSums * sub);
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(rasterize_bwd_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

// tile_order: (n_tiles,) int32 scratch that receives the launch order
// (heaviest tiles first).
int launch(const EntrySrc& src, const void* tile_offsets, const void* gpix5,
           int n_tiles, int ntx, int tile_w, int tile_h, int chunk,
           float alpha_min, float alpha_max, float t_threshold,
           float log_t_min, void* d_attrs, void* tile_order, void* stream) {
  int threads;
  size_t smem;
  if (n_tiles <= 0 || tile_order == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = launch_shape(tile_w, tile_h, chunk, &threads, &smem);
  if (e != cudaSuccess) return (int)e;
  const auto* offsets = static_cast<const int32_t*>(tile_offsets);
  auto* order = static_cast<int32_t*>(tile_order);
  tile_order_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(
      offsets, n_tiles, src.e_len, order);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rasterize_bwd_kernel<<<n_tiles, threads, smem, (cudaStream_t)stream>>>(
      src, offsets, static_cast<const float*>(gpix5), ntx, tile_w, tile_h,
      chunk, chunk < kMaxSub ? chunk : kMaxSub, alpha_min, alpha_max,
      t_threshold, log_t_min, static_cast<float*>(d_attrs), order);
  return (int)cudaGetLastError();
}

}  // namespace

// The entries as packed (16, E) rows attrs16.
extern "C" int webdgs_rasterize_bwd(const void* attrs16, int e_len,
                                    const void* tile_offsets,
                                    const void* gpix5, int n_tiles, int ntx,
                                    int tile_w, int tile_h, int chunk,
                                    float alpha_min, float alpha_max,
                                    float t_threshold, float log_t_min,
                                    void* d_attrs, void* tile_order,
                                    void* stream) {
  return launch(packed_src(attrs16, e_len), tile_offsets, gpix5, n_tiles,
                ntx, tile_w, tile_h, chunk, alpha_min, alpha_max,
                t_threshold, log_t_min, d_attrs, tile_order, stream);
}

// The entries through their Gaussians (tile_stage.cuh EntrySrc), as
// webdgs_rasterize_fwd_indexed; d_attrs is the (16, E) per-slot output all
// the same.
extern "C" int webdgs_rasterize_bwd_indexed(
    const void* entry_gauss, const void* entry_valid, const void* center,
    const void* conic, const void* color, const void* opacity,
    const void* extents, int e_len, const void* tile_offsets,
    const void* gpix5, int n_tiles, int ntx, int tile_w, int tile_h,
    int chunk, float alpha_min, float alpha_max, float t_threshold,
    float log_t_min, void* d_attrs, void* tile_order, void* stream) {
  return launch(indexed_src(entry_gauss, entry_valid, center, conic, color,
                            opacity, extents, e_len),
                tile_offsets, gpix5, n_tiles, ntx, tile_w, tile_h, chunk,
                alpha_min, alpha_max, t_threshold, log_t_min, d_attrs,
                tile_order, stream);
}

// The launch shape for a tile of tile_w x tile_h pixels and this chunk:
// out[0..4] = threads per CTA, dynamic shared bytes, CTAs per SM that the
// kernel's registers, shared memory and threads allow on the current
// device, pixels per thread (kR), entries per butterfly batch (kB).
extern "C" int webdgs_rasterize_bwd_occupancy(int tile_w, int tile_h,
                                              int chunk, int* out) {
  int threads, blocks = 0;
  size_t smem;
  cudaError_t e = launch_shape(tile_w, tile_h, chunk, &threads, &smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, rasterize_bwd_kernel, threads, smem);
  out[0] = threads;
  out[1] = (int)smem;
  out[2] = blocks;
  out[3] = kR;
  out[4] = kB;
  return (int)e;
}
