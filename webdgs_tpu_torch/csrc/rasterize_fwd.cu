// Forward tile rasterizer: front-to-back alpha compositing of each tile's
// depth-sorted entry range.  Hopper (sm_90a) CUDA C++, plain C interface.
//
// Replaces the TPU kernel webdgs_tpu/ops/rasterize.py:_fwd_kernel (launched
// by _forward_impl, wrapped by rasterize_tiles).  The TPU version turns the
// per-pixel loop into log-transmittance prefix sums computed by triangular
// MXU matmuls (with bf16 hi/lo splits) over chunk-aligned DMA windows; here
// each pixel is one thread that walks its tile's own range in order, so the
// windows, foreign-slot masks and matmul splits have no counterpart.
//
// Per entry and pixel, the same float32 math and thresholds as the TPU
// kernel (rasterize.py:140-171, 289-315):
//   alpha = min(op * exp(-0.5 * (dx*u1 + dy*u2)), alpha_max), zero when
//           |dx| > ex, |dy| > ey or alpha < alpha_min;
//   the entry counts only while the exclusive transmittance
//   T = exp(sum log1p(-alpha)) >= t_threshold; then rgb += c*alpha*T,
//   acc += alpha*T, n_contrib = 1-based position in the tile's range.
// Once T < t_threshold for a pixel nothing it owns changes again, so its
// thread stops working; the tile stops (one __syncthreads_or per chunk, as
// the TPU kernel's while-loop test) when no pixel is still compositing with
// log T >= log(t_threshold).  Output channels per tile, planar over its P
// pixels: [r, g, b, acc_alpha, T_final, n_contrib, 0, 0].
//
// What bounds it on the H100: the expf/log1pf arithmetic over (pixel,
// entry) pairs; the entry rows are staged once per chunk through shared
// memory (11 rows x chunk floats, 5.6 KB at chunk 128) and read back as
// broadcasts, so device-memory traffic is small beside it.
//
// This is the first, simple, correct version: one CTA of tile_w*tile_h
// threads per tile, synchronous staging, accurate expf/log1pf (compiled
// without fast math, with -fmad=false, so alphas near the 1/255 and 0.01
// thresholds round as in the plain torch version).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// attribute rows of the packed (16, E) entry array (ops/rasterize.py ROW_*)
constexpr int kRowCx = 0, kRowCy = 1, kRowCa = 2, kRowCb = 3, kRowCc = 4;
constexpr int kRowR = 5, kRowG = 6, kRowB = 7, kRowOp = 8, kRowEx = 9,
              kRowEy = 10;
constexpr int kUsedRows = 11;
constexpr int kNumOut = 8;

__global__ void rasterize_fwd_kernel(const float* __restrict__ attrs,
                                     int e_len,
                                     const int32_t* __restrict__ offsets,
                                     int ntx, int tile_w, int tile_h,
                                     int chunk, float alpha_min,
                                     float alpha_max, float t_threshold,
                                     float log_t_min, int track_ncontrib,
                                     float* __restrict__ out) {
  extern __shared__ float stage[];  // kUsedRows x chunk
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int npix = blockDim.x;
  const float px = (float)((t % ntx) * tile_w + p % tile_w) + 0.5f;
  const float py = (float)((t / ntx) * tile_h + p / tile_w) + 0.5f;
  const int uo = offsets[t];
  const int cnt = offsets[t + 1] - uo;

  float r = 0.f, g = 0.f, b = 0.f, acc = 0.f;
  float log_t_un = 0.f, log_t_gated = 0.f, t_cur = 1.f;
  int n_contrib = 0;
  bool done = !(t_cur >= t_threshold);

  for (int c0 = 0; c0 < cnt; c0 += chunk) {
    const int n_in = min(chunk, cnt - c0);
    __syncthreads();  // every thread is past the previous chunk
    for (int i = p; i < kUsedRows * n_in; i += npix) {
      const int row = i / n_in;
      const int j = i - row * n_in;
      stage[row * chunk + j] = attrs[(size_t)row * e_len + uo + c0 + j];
    }
    __syncthreads();

    for (int j = 0; j < n_in && !done; ++j) {
      const float dx = px - stage[kRowCx * chunk + j];
      const float dy = py - stage[kRowCy * chunk + j];
      const float ca = stage[kRowCa * chunk + j];
      const float cb = stage[kRowCb * chunk + j];
      const float cc = stage[kRowCc * chunk + j];
      const float u1 = ca * dx + cb * dy;
      const float u2 = cb * dx + cc * dy;
      const float power = dx * u1 + dy * u2;
      const float gw = expf(-0.5f * power);
      const float alpha = fminf(stage[kRowOp * chunk + j] * gw, alpha_max);
      const bool keep = fabsf(dx) <= stage[kRowEx * chunk + j] &&
                        fabsf(dy) <= stage[kRowEy * chunk + j] &&
                        alpha >= alpha_min;
      if (!keep) continue;
      const float w = alpha * t_cur;
      r += w * stage[kRowR * chunk + j];
      g += w * stage[kRowG * chunk + j];
      b += w * stage[kRowB * chunk + j];
      acc += w;
      const float alog = log1pf(-alpha);
      log_t_un += alog;
      log_t_gated += alog;
      t_cur = expf(log_t_un);
      n_contrib = c0 + j + 1;
      done = !(t_cur >= t_threshold);
    }
    if (!__syncthreads_or(!done && log_t_un >= log_t_min)) break;
  }

  float* o = out + (size_t)t * kNumOut * npix + p;
  o[0 * npix] = r;
  o[1 * npix] = g;
  o[2 * npix] = b;
  o[3 * npix] = acc;
  o[4 * npix] = expf(log_t_gated);
  o[5 * npix] = track_ncontrib ? (float)n_contrib : 0.f;
  o[6 * npix] = 0.f;
  o[7 * npix] = 0.f;
}

}  // namespace

extern "C" int webdgs_rasterize_fwd(const void* attrs16, int e_len,
                                    const void* tile_offsets, int n_tiles,
                                    int ntx, int tile_w, int tile_h,
                                    int chunk, float alpha_min,
                                    float alpha_max, float t_threshold,
                                    float log_t_min, int track_ncontrib,
                                    void* out, void* stream) {
  const int npix = tile_w * tile_h;
  if (n_tiles <= 0 || npix <= 0 || npix > 1024 || chunk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * kUsedRows * chunk;
  rasterize_fwd_kernel<<<n_tiles, npix, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(attrs16), e_len,
      static_cast<const int32_t*>(tile_offsets), ntx, tile_w, tile_h, chunk,
      alpha_min, alpha_max, t_threshold, log_t_min, track_ncontrib,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
