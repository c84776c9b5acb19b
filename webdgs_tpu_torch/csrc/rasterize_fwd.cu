// Forward tile rasterizer: front-to-back alpha compositing of each tile's
// depth-sorted entry range.  Hopper (sm_90a) CUDA C++, plain C interface.
//
// Replaces the TPU kernel webdgs_tpu/ops/rasterize.py:_fwd_kernel (launched
// by _forward_impl, wrapped by rasterize_tiles).  The TPU version turns the
// per-pixel loop into log-transmittance prefix sums computed by triangular
// MXU matmuls (with bf16 hi/lo splits) over chunk-aligned DMA windows; here
// each pixel walks its tile's own range in order, so the windows,
// foreign-slot masks and matmul splits have no counterpart.
//
// Per entry and pixel, the same float32 math and thresholds as the TPU
// kernel (rasterize.py:140-171, 289-315):
//   alpha = min(op * exp(-0.5 * (dx*u1 + dy*u2)), alpha_max), zero when
//           |dx| > ex, |dy| > ey or alpha < alpha_min;
//   the entry counts only while the exclusive transmittance
//   T = exp(sum log1p(-alpha)) >= t_threshold; then rgb += c*alpha*T,
//   acc += alpha*T, n_contrib = 1-based position in the tile's range.
// Once T < t_threshold for a pixel nothing it owns changes again, so it
// does no more work; the tile stops (one __syncthreads_or per chunk, as the
// TPU kernel's while-loop test) when no pixel is still compositing with
// log T >= log(t_threshold).  Output channels per tile, planar over its P
// pixels: [r, g, b, acc_alpha, T_final, n_contrib, 0, 0].  Each CTA clamps
// its range to 0 <= uo <= end <= E, so no offsets read outside the entries
// and the wrapper reads nothing back.
//
// What bounds it on the H100: fp32 issue of the alpha test over the
// (pixel, entry) pairs and of the accurate log1pf/expf of the
// transmittance over the kept ones.  Those transcendentals must stay:
// they decide which pairs count, and the backward (rasterize_bwd.cu) and
// importance (importance.cu) kernels replay the decisions, the latter
// trusting the n_contrib written here.  Memory traffic is small: each
// entry a tile reaches is read once (11 words) and the (T, 8, P) tiles
// written once.
//
// The design, point by point against the thread-per-pixel version it
// replaces (one CTA of tile_w * tile_h threads in tile index order, rows
// copied by plain loads between two barriers, 8 scalar shared loads per
// pair for the alpha test and 3 more per kept pair, the expf computed
// before the extent-box test; chip_smoke.py --before-fwd times it):
// - kR = 4 pixels per thread, so a CTA has tile_px / 4 threads (128 at
//   32 x 16).  A warp owns 4 groups of 32 pixels, each an 8 x 4 block of
//   the tile (a run of 32 where the tile does not divide into blocks): in
//   a block fewer lanes outside a small splat's box sit beside lanes
//   inside it than in a row.  A thread carries its pixels' r, g, b, acc,
//   log T, T and n_contrib in registers and leaves the entry loop once
//   all 4 are done; a pixel that is done does nothing more.
// - Entries are staged as 12-float records (cx cy ca cb | cc r g b | op ex
//   ey pad): three 16-byte broadcast loads per entry and thread, shared by
//   its 4 pixels.
// - Double-buffered staging: chunk c + 1 is fetched with 4-byte cp.async
//   (a tile's uo has any alignment, and the copy transposes rows into
//   records) while chunk c computes; one barrier per chunk waits for it.
//   When the tile stops early a prefetch may still be in flight; the CTA
//   waits for it before it exits.
// - The render's entries are staged through the binning's index
//   (webdgs_rasterize_fwd_indexed; tile_stage.cuh EntrySrc): a thread
//   loads its slot's Gaussian and flag, then copies that Gaussian's 11
//   words straight from the projected attributes (zero-filled for an
//   invalid slot).  The (16, E) rows a gather, mask and transpose would
//   build over the whole capacity -- 64 bytes a slot, about 80 times the
//   entries a tile reaches before it saturates -- are never written; the
//   dependent index load costs the kernel ~1.5 % (PERF.md).  Packed rows
//   (webdgs_rasterize_fwd) stay an input, staged as before.
// - A pixel outside an entry's extent box skips the Gaussian's expf: the
//   decision there is false whatever alpha is, so no result changes.
//   Inside the box the alpha and the decision are splat_alpha.cuh's,
//   operation for operation.
// - Tiles launch heaviest first (tile_order_kernel, tile_stage.cuh, into
//   the wrapper's scratch), so no heavy tile starts in the last wave.
// Each pixel takes the same operations on the same entries in the same
// order as in that version (accurate expf/log1pf, the -fmad=false build,
// no fmaf), so all 8 output channels are bit-identical to it.
// 64 registers per thread, no spills: 8 CTAs (32 warps) per SM at 32 x 16
// tiles and chunk 128, with 12,288 bytes of shared memory each
// (webdgs_rasterize_fwd_occupancy; chip_smoke prints it).  kR = 2 and 1
// run faster at the 100k bench frame and slower at the 1M frame, where
// most of the forward's time is (chip_smoke --ablate-fwd; PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "splat_alpha.cuh"
#include "tile_stage.cuh"

namespace {

constexpr int kR = 4;  // pixels per thread
constexpr int kNumOut = 8;

__global__ void __launch_bounds__(1024 / kR) rasterize_fwd_kernel(
    const EntrySrc src, const int32_t* __restrict__ offsets, int ntx,
    int tile_w, int tile_h, int chunk, float alpha_min, float alpha_max,
    float t_threshold, float log_t_min, int track_ncontrib,
    float* __restrict__ out, const int32_t* __restrict__ order) {
  extern __shared__ __align__(16) float recs[];  // 2 buffers x chunk x kRec
  const int rec_stride = chunk * kRec;

  const int t = order[blockIdx.x];  // heaviest tiles first
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int npix = tile_w * tile_h;
  const int e_len = src.e_len;
  const int uo = min(max(offsets[t], 0), e_len);
  const int end = min(max(offsets[t + 1], uo), e_len);
  const int cnt = end - uo;

  // the thread's pixels: lane `lane` of groups warp * kR .. + kR - 1,
  // group g the g-th 8 x 4 block of the tile in row-major block order, or
  // its g-th run of 32 pixels where the tile does not divide into blocks
  const bool blocked = tile_w % 8 == 0 && tile_h % 4 == 0;
  const auto pixel = [&](int r) {
    const int g = warp * kR + r;
    return blocked ? ((g / (tile_w >> 3)) * 4 + (lane >> 3)) * tile_w +
                         (g % (tile_w >> 3)) * 8 + (lane & 7)
                   : g * 32 + lane;
  };
  int n_contrib[kR];
  float px[kR], py[kR], col_r[kR], col_g[kR], col_b[kR], acc[kR];
  float log_t[kR], t_cur[kR];
  bool done[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int p = pixel(r);
    px[r] = (float)((t % ntx) * tile_w + p % tile_w) + 0.5f;
    py[r] = (float)((t / ntx) * tile_h + p / tile_w) + 0.5f;
    col_r[r] = col_g[r] = col_b[r] = acc[r] = 0.f;
    log_t[r] = 0.f;
    t_cur[r] = 1.f;
    n_contrib[r] = 0;
    done[r] = p >= npix || !(t_cur[r] >= t_threshold);
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

    for (int j = 0; j < n_in; ++j) {
      bool live = false;
#pragma unroll
      for (int r = 0; r < kR; ++r) live |= !done[r];
      if (!live) break;
      const float4* q = reinterpret_cast<const float4*>(rec + j * kRec);
      const float4 c0123 = q[0];  // cx cy ca cb
      const float4 c4567 = q[1];  // cc r g b
      const float4 c89ab = q[2];  // op ex ey pad
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (done[r]) continue;
        const float dx = px[r] - c0123.x;
        const float dy = py[r] - c0123.y;
        // outside the extent box the decision is false whatever alpha
        // is: skip the Gaussian's expf
        if (!(fabsf(dx) <= c89ab.y && fabsf(dy) <= c89ab.z)) continue;
        float alpha;
        if (!splat_alpha(dx, dy, c0123.z, c0123.w, c4567.x, c89ab.x,
                         c89ab.y, c89ab.z, alpha_min, alpha_max, &alpha)) {
          continue;
        }
        const float w = alpha * t_cur[r];
        col_r[r] += w * c4567.y;
        col_g[r] += w * c4567.z;
        col_b[r] += w * c4567.w;
        acc[r] += w;
        log_t[r] += log1pf(-alpha);
        t_cur[r] = expf(log_t[r]);
        n_contrib[r] = c0 + j + 1;
        done[r] = !(t_cur[r] >= t_threshold);
      }
    }
    // the tile stops once no pixel is still compositing; the barrier also
    // ends every read of this chunk's buffer
    bool more = false;
#pragma unroll
    for (int r = 0; r < kR; ++r) more |= !done[r] && log_t[r] >= log_t_min;
    if (!__syncthreads_or(more)) break;
  }
  cp_async_wait<0>();  // a prefetch the early exit left in flight

  float* o = out + (size_t)t * kNumOut * npix;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int p = pixel(r);
    if (p >= npix) continue;
    o[0 * npix + p] = col_r[r];
    o[1 * npix + p] = col_g[r];
    o[2 * npix + p] = col_b[r];
    o[3 * npix + p] = acc[r];
    o[4 * npix + p] = expf(log_t[r]);
    o[5 * npix + p] = track_ncontrib ? (float)n_contrib[r] : 0.f;
    o[6 * npix + p] = 0.f;
    o[7 * npix + p] = 0.f;
  }
}

// Threads and dynamic shared bytes of the kernel for this tile and chunk:
// two buffers of chunk records, within the 48 KB a launch takes without an
// opt-in (ops/rasterize.py _MAX_CHUNK follows it).
cudaError_t launch_shape(int tile_w, int tile_h, int chunk, int* threads,
                         size_t* smem) {
  const int npix = tile_w * tile_h;
  if (npix <= 0 || npix > 1024 || chunk <= 0) return cudaErrorInvalidValue;
  // whole warps of 32 x kR pixels: pixels past npix are idle lanes
  *threads = (npix + 32 * kR - 1) / (32 * kR) * 32;
  *smem = sizeof(float) * (size_t)2 * chunk * kRec;
  return *smem <= 48 * 1024 ? cudaSuccess : cudaErrorInvalidValue;
}

// tile_order: (n_tiles,) int32 scratch that receives the launch order
// (heaviest tiles first).
int launch(const EntrySrc& src, const void* tile_offsets, int n_tiles,
           int ntx, int tile_w, int tile_h, int chunk, float alpha_min,
           float alpha_max, float t_threshold, float log_t_min,
           int track_ncontrib, void* out, void* tile_order, void* stream) {
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
  rasterize_fwd_kernel<<<n_tiles, threads, smem, (cudaStream_t)stream>>>(
      src, offsets, ntx, tile_w, tile_h, chunk, alpha_min, alpha_max,
      t_threshold, log_t_min, track_ncontrib, static_cast<float*>(out),
      order);
  return (int)cudaGetLastError();
}

}  // namespace

// The entries as packed (16, E) rows attrs16.
extern "C" int webdgs_rasterize_fwd(const void* attrs16, int e_len,
                                    const void* tile_offsets, int n_tiles,
                                    int ntx, int tile_w, int tile_h,
                                    int chunk, float alpha_min,
                                    float alpha_max, float t_threshold,
                                    float log_t_min, int track_ncontrib,
                                    void* out, void* tile_order,
                                    void* stream) {
  return launch(packed_src(attrs16, e_len), tile_offsets, n_tiles, ntx,
                tile_w, tile_h, chunk, alpha_min, alpha_max, t_threshold,
                log_t_min, track_ncontrib, out, tile_order, stream);
}

// The entries through their Gaussians: entry_gauss (E,) int32 and
// entry_valid (E,) bool per slot, and the five per-Gaussian attribute
// tensors (tile_stage.cuh EntrySrc); the rest as webdgs_rasterize_fwd.
extern "C" int webdgs_rasterize_fwd_indexed(
    const void* entry_gauss, const void* entry_valid, const void* center,
    const void* conic, const void* color, const void* opacity,
    const void* extents, int e_len, const void* tile_offsets, int n_tiles,
    int ntx, int tile_w, int tile_h, int chunk, float alpha_min,
    float alpha_max, float t_threshold, float log_t_min, int track_ncontrib,
    void* out, void* tile_order, void* stream) {
  return launch(indexed_src(entry_gauss, entry_valid, center, conic, color,
                            opacity, extents, e_len),
                tile_offsets, n_tiles, ntx, tile_w, tile_h, chunk, alpha_min,
                alpha_max, t_threshold, log_t_min, track_ncontrib, out,
                tile_order, stream);
}

// The launch shape for a tile of tile_w x tile_h pixels and this chunk:
// out[0..3] = threads per CTA, dynamic shared bytes, CTAs per SM that the
// kernel's registers, shared memory and threads allow on the current
// device, pixels per thread (kR).
extern "C" int webdgs_rasterize_fwd_occupancy(int tile_w, int tile_h,
                                              int chunk, int* out) {
  int threads, blocks = 0;
  size_t smem;
  cudaError_t e = launch_shape(tile_w, tile_h, chunk, &threads, &smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, rasterize_fwd_kernel, threads, smem);
  out[0] = threads;
  out[1] = (int)smem;
  out[2] = blocks;
  out[3] = kR;
  return (int)e;
}
