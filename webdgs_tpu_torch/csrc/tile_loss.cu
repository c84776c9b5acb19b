// Tile-space loss: the pixel cotangent of
//   lambda_l1 * L1 + lambda_l2 * L2 + lambda_dssim * (simplified DSSIM)
// on the rasterizer's planar tile buffer, plus per-tile metric sums.
// Hopper (sm_90a) CUDA C++, plain C interface.
//
// Replaces the TPU kernel webdgs_tpu/ops/tile_loss.py:_loss_kernel
// (launched by band_tile_loss_gradient / tile_loss_gradient).  The TPU
// version works on row-planar bands of a whole tile row and builds the
// edge-replicated 2-pixel halo with one-hot select matmuls; here one CTA
// owns one tile and stages the composited prediction (rgb + bg * T) and the
// target over the tile plus its halo, (tile_h+4) x (tile_w+4) per channel,
// in shared memory, reading the halo straight from the neighbour tiles of
// the planar (T, 8, P) buffer.  The edge clamp clamp(x, 0, img_w-1),
// clamp(y, 0, img_h-1) is index arithmetic.
//
// Per pixel (one thread each), per channel: 5x5 box means (row shifts, then
// column shifts, in window order), SSIM, dssim = (1 - ssim)/2 and
//   grad = l1 * sign(d) + l2 * d + ld * dssim * d,   d = pred - target,
// with sign(0) = 0 (untouched background pixels have d = 0 exactly).
// Pixels outside the frame (tile-grid padding) get zero gradient and count
// nowhere.  Output channels: 0-2 grad, 4 = sum_c bg_c * grad_c, the rest 0.
// The per-tile partials [sum |d|, sum d^2, sum dssim, valid px] are reduced
// deterministically: a warp-shuffle tree, then the warp partials summed in
// warp order by one thread.
//
// What bounds it on the H100: device memory.  Per pixel it reads 4 of the
// 8 tile channels (16 B) and 3 target floats (12 B) and writes 8 channels
// (32 B); the halo re-reads (about 1.4x the tile) mostly hit L2.  The
// window arithmetic (~150 flops per pixel from shared memory) is far below
// the card's rate.  This is the first, simple version: one CTA of
// tile_w*tile_h threads per tile, synchronous staging.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHalf = 2;
constexpr int kWin = 2 * kHalf + 1;
constexpr int kNumOut = 8;
constexpr int kOutT = 4;
constexpr int kNumSums = 4;
constexpr int kMaxWarps = 32;

__device__ __forceinline__ float sign_of(float d) {
  return (float)(d > 0.f) - (float)(d < 0.f);
}

// 5x5 box sum around (ly, lx) of a (hh, ww) shared plane, whose (0, 0) is
// the pixel (ly - 2, lx - 2): the sum of five row sums, each in order.
__device__ __forceinline__ float box(const float* plane, int ww, int ly,
                                     int lx) {
  float s = 0.f;
  for (int dy = 0; dy < kWin; ++dy) {
    const float* row = plane + (ly + dy) * ww + lx;
    float r = row[0];
    for (int dx = 1; dx < kWin; ++dx) r = r + row[dx];
    s = (dy == 0) ? r : s + r;
  }
  return s;
}

__device__ __forceinline__ float box_prod(const float* a, const float* b,
                                          int ww, int ly, int lx) {
  float s = 0.f;
  for (int dy = 0; dy < kWin; ++dy) {
    const int o = (ly + dy) * ww + lx;
    float r = a[o] * b[o];
    for (int dx = 1; dx < kWin; ++dx) r = r + a[o + dx] * b[o + dx];
    s = (dy == 0) ? r : s + r;
  }
  return s;
}

__global__ void tile_loss_kernel(const float* __restrict__ out,
                                 const float* __restrict__ target, int ntx,
                                 int tile_w, int tile_h, int img_w,
                                 int img_h, float l1, float l2, float ld,
                                 float c1, float c2, float bg0, float bg1,
                                 float bg2, float* __restrict__ dpix,
                                 float* __restrict__ sums) {
  extern __shared__ float smem[];
  const int hh = tile_h + 2 * kHalf;
  const int ww = tile_w + 2 * kHalf;
  const int plane = hh * ww;
  float* pred = smem;               // 3 planes
  float* targ = smem + 3 * plane;   // 3 planes
  float* warp_sums = smem + 6 * plane;  // kMaxWarps x kNumSums

  const int t = blockIdx.x;
  const int npix = tile_w * tile_h;
  const int p = threadIdx.x;
  const int tx0 = (t % ntx) * tile_w;
  const int ty0 = (t / ntx) * tile_h;
  const float bg[3] = {bg0, bg1, bg2};

  for (int i = p; i < plane; i += blockDim.x) {
    const int ly = i / ww;
    const int lx = i - ly * ww;
    const int gy = min(max(ty0 + ly - kHalf, 0), img_h - 1);
    const int gx = min(max(tx0 + lx - kHalf, 0), img_w - 1);
    const int src_t = (gy / tile_h) * ntx + gx / tile_w;
    const int src_p = (gy % tile_h) * tile_w + gx % tile_w;
    const float* o = out + (size_t)src_t * kNumOut * npix + src_p;
    const float tf = o[kOutT * npix];
    const float* tg = target + ((size_t)gy * img_w + gx) * 3;
    for (int c = 0; c < 3; ++c) {
      pred[c * plane + i] = o[c * npix] + bg[c] * tf;
      targ[c * plane + i] = tg[c];
    }
  }
  __syncthreads();

  const int ly = p / tile_w;
  const int lx = p - ly * tile_w;
  const bool valid = tx0 + lx < img_w && ty0 + ly < img_h;
  const float inv = 1.0f / (kWin * kWin);
  float grad[3];
  float s_abs = 0.f, s_sq = 0.f, s_ds = 0.f;
  for (int c = 0; c < 3; ++c) {
    const float* pp = pred + c * plane;
    const float* qq = targ + c * plane;
    const float mu_x = box(pp, ww, ly, lx) * inv;
    const float mu_y = box(qq, ww, ly, lx) * inv;
    const float sigma_x2 = box_prod(pp, pp, ww, ly, lx) * inv - mu_x * mu_x;
    const float sigma_y2 = box_prod(qq, qq, ww, ly, lx) * inv - mu_y * mu_y;
    const float sigma_xy = box_prod(pp, qq, ww, ly, lx) * inv - mu_x * mu_y;
    const float num = (2.f * mu_x * mu_y + c1) * (2.f * sigma_xy + c2);
    const float den =
        (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x2 + sigma_y2 + c2);
    const float dssim = (1.f - num / den) * 0.5f;
    const int own = (ly + kHalf) * ww + lx + kHalf;
    const float d = pp[own] - qq[own];
    float g = l1 * sign_of(d) + l2 * d;
    g = g + ld * dssim * d;
    grad[c] = valid ? g : 0.f;
    if (valid) {
      s_abs += fabsf(d);
      s_sq += d * d;
      s_ds += dssim;
    }
  }

  float* o = dpix + (size_t)t * kNumOut * npix + p;
  o[0 * npix] = grad[0];
  o[1 * npix] = grad[1];
  o[2 * npix] = grad[2];
  o[3 * npix] = 0.f;
  o[4 * npix] = bg0 * grad[0] + bg1 * grad[1] + bg2 * grad[2];
  o[5 * npix] = 0.f;
  o[6 * npix] = 0.f;
  o[7 * npix] = 0.f;

  // deterministic block reduction of the four partials
  float v[kNumSums] = {s_abs, s_sq, s_ds, valid ? 1.f : 0.f};
  for (int k = 0; k < kNumSums; ++k) {
    for (int off = 16; off > 0; off >>= 1) {
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    }
  }
  const int warp = p >> 5;
  if ((p & 31) == 0) {
    for (int k = 0; k < kNumSums; ++k) warp_sums[warp * kNumSums + k] = v[k];
  }
  __syncthreads();
  if (p == 0) {
    const int nwarps = blockDim.x >> 5;
    for (int k = 0; k < kNumSums; ++k) {
      float s = warp_sums[k];
      for (int w = 1; w < nwarps; ++w) s += warp_sums[w * kNumSums + k];
      sums[(size_t)t * kNumSums + k] = s;
    }
  }
}

}  // namespace

extern "C" int webdgs_tile_loss(const void* out, const void* target,
                                int n_tiles, int ntx, int tile_w, int tile_h,
                                int img_w, int img_h, float l1, float l2,
                                float ld, float c1, float c2, float bg0,
                                float bg1, float bg2, void* dpix, void* sums,
                                void* stream) {
  const int npix = tile_w * tile_h;
  // the block reduction needs whole warps
  if (n_tiles <= 0 || npix <= 0 || npix > kMaxWarps * 32 || npix % 32 != 0 ||
      img_w < kWin || img_h < kWin) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t plane = (size_t)(tile_h + 2 * kHalf) * (tile_w + 2 * kHalf);
  const size_t smem = sizeof(float) * (6 * plane + kMaxWarps * kNumSums);
  tile_loss_kernel<<<n_tiles, npix, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(out), static_cast<const float*>(target), ntx,
      tile_w, tile_h, img_w, img_h, l1, l2, ld, c1, c2, bg0, bg1, bg2,
      static_cast<float*>(dpix), static_cast<float*>(sums));
  return (int)cudaGetLastError();
}
