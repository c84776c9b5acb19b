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
// Per pixel and channel: 5x5 box means, SSIM, dssim = (1 - ssim)/2 and
//   grad = l1 * sign(d) + l2 * d + ld * dssim * d,   d = pred - target,
// with sign(0) = 0 (untouched background pixels have d = 0 exactly).
// Pixels outside the frame (tile-grid padding) get zero gradient and count
// nowhere.  Output channels: 0-2 grad, 4 = sum_c bg_c * grad_c, the rest 0.
// The per-tile partials [sum |d|, sum d^2, sum dssim, valid px] are reduced
// deterministically: each thread sums its pixels in a fixed order, then a
// warp-shuffle tree, then the warp partials in warp order by one thread.
//
// What bounds it on the H100: device memory.  Per pixel it reads 4 of the
// 8 tile channels (16 B) and 3 target floats (12 B) and writes 8 channels
// (32 B); the halo re-reads (about 1.4x the tile) mostly hit L2.
//
// Design:
// - Separable sums.  A thread owns kRows = 4 pixels of one column.  For
//   each of the kRows + 4 staged rows its windows cover it forms the five
//   row sums of x, y, x^2, y^2 and xy over the row's 5 columns (10 shared
//   loads), and each output pixel sums five row sums per quantity: ~20
//   shared loads per pixel and channel where the 25-tap windows took
//   ~150.  A window row is summed in column order, then the five row sums
//   in row order: the operations and their order of the 25-tap form, so
//   with -fmad=false the output is bit for bit the same.
// - Staging walks the halo with per-thread row and column counters, finds
//   a halo pixel's source tile by comparisons with the tile edges (no
//   division or modulo per element), and issues the loads of kStage
//   elements before it stores them.
// - A CTA has at most kMaxThreads threads, looping over (column, row
//   group) items when the tile has more; any tile of at most 1024 pixels
//   runs, with dynamic shared memory above 48 KB where its halo needs it.
// - What is left is latency: a warp's dependent shared loads and adds.
//   At most 85 registers (80 used) gives 6 CTAs of 128 threads per SM;
//   the compiler's own 101 registers gave 4 and ran 16% slower at the 1M
//   step.  A persistent CTA copying the next tile's halo with cp.async
//   while it computes gained nothing, so each tile has its own CTA.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHalf = 2;
constexpr int kWin = 2 * kHalf + 1;
constexpr int kNumOut = 8;
constexpr int kOutT = 4;
constexpr int kNumSums = 4;
constexpr int kRows = 4;  // output rows per thread
constexpr int kStage = 4;  // halo elements a thread loads before it stores
constexpr int kMinCtas = 3;  // of kMaxThreads per SM: at most 85 registers
constexpr int kHaloRows = kRows + 2 * kHalf;
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxTilePx = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sign_of(float d) {
  return (float)(d > 0.f) - (float)(d < 0.f);
}

// The tile offset (-2..2) and the position in its tile of frame
// coordinate g, for a tile starting at origin of the given size, where
// g - origin lies in [-2, size + 1]: comparisons, no division.
__device__ __forceinline__ void locate(int g, int origin, int size, int& dt,
                                       int& pos) {
  int r = g - origin, t = 0;
  while (r < 0) {
    r += size;
    --t;
  }
  while (r >= size) {
    r -= size;
    ++t;
  }
  dt = t;
  pos = r;
}

// The five row sums of one staged row at this column: x, y, x*x, y*y,
// x*y over the row's 5 columns, each in column order.
struct RowSums {
  float x, y, xx, yy, xy;
};

__device__ __forceinline__ RowSums row_sums(const float* a, const float* b) {
  RowSums r;
  r.x = a[0];
  r.y = b[0];
  r.xx = a[0] * a[0];
  r.yy = b[0] * b[0];
  r.xy = a[0] * b[0];
#pragma unroll
  for (int dx = 1; dx < kWin; ++dx) {
    const float x = a[dx], y = b[dx];
    r.x = r.x + x;
    r.y = r.y + y;
    r.xx = r.xx + x * x;
    r.yy = r.yy + y * y;
    r.xy = r.xy + x * y;
  }
  return r;
}

__global__ void __launch_bounds__(kMaxThreads, kMinCtas)
    tile_loss_kernel(const float* __restrict__ out,
                     const float* __restrict__ target, int ntx, int tile_w,
                     int tile_h, int img_w, int img_h, float l1, float l2,
                     float ld, float c1, float c2, float bg0, float bg1,
                     float bg2, float* __restrict__ dpix,
                     float* __restrict__ sums) {
  extern __shared__ float smem[];
  const int hh = tile_h + 2 * kHalf;
  const int ww = tile_w + 2 * kHalf;
  const int plane = hh * ww;
  float* pred = smem;                   // 3 planes
  float* targ = smem + 3 * plane;       // 3 planes
  float* warp_sums = smem + 6 * plane;  // kMaxWarps x kNumSums

  const int t = blockIdx.x;
  const int npix = tile_w * tile_h;
  const int tcy = t / ntx, tcx = t - tcy * ntx;
  const int tx0 = tcx * tile_w, ty0 = tcy * tile_h;
  const float bg[3] = {bg0, bg1, bg2};
  const size_t tile_stride = (size_t)kNumOut * npix;

  // stage the halo: a thread takes the elements tid, tid + blockDim.x, ...
  // with (ly, lx) advanced by blockDim.x elements per step, and issues the
  // loads of kStage elements before their stores
  {
    const int step_y = blockDim.x / ww, step_x = blockDim.x - step_y * ww;
    int ly = threadIdx.x / ww, lx = threadIdx.x - ly * ww;
    for (int i0 = threadIdx.x; i0 < plane; i0 += kStage * blockDim.x) {
      float vo[kStage][4], vt[kStage][3];
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        if (i0 + k * (int)blockDim.x < plane) {
          const int gy = min(max(ty0 + ly - kHalf, 0), img_h - 1);
          const int gx = min(max(tx0 + lx - kHalf, 0), img_w - 1);
          int dty, py, dtx, px;
          locate(gy, ty0, tile_h, dty, py);
          locate(gx, tx0, tile_w, dtx, px);
          const float* o = out + (size_t)((tcy + dty) * ntx + tcx + dtx) *
                                     tile_stride + py * tile_w + px;
          const float* tg = target + ((size_t)gy * img_w + gx) * 3;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            vo[k][c] = o[c * npix];
            vt[k][c] = tg[c];
          }
          vo[k][3] = o[kOutT * npix];
        }
        lx += step_x;
        ly += step_y;
        if (lx >= ww) {
          lx -= ww;
          ++ly;
        }
      }
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int i = i0 + k * blockDim.x;
        if (i < plane) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            pred[c * plane + i] = vo[k][c] + bg[c] * vo[k][3];
            targ[c * plane + i] = vt[k][c];
          }
        }
      }
    }
  }
  __syncthreads();

  const float inv = 1.0f / (kWin * kWin);
  const int groups = (tile_h + kRows - 1) / kRows;
  const int items = tile_w * groups;
  float s_abs = 0.f, s_sq = 0.f, s_ds = 0.f, s_px = 0.f;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int g = item / tile_w;
    const int lx = item - g * tile_w;
    const int ly0 = g * kRows;
    const int nrows = min(kRows, tile_h - ly0);
    float* o = dpix + (size_t)t * tile_stride + ly0 * tile_w + lx;
    float acc_t[kRows];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // staged row ly0 + i, columns lx .. lx + 4
      const float* pp = pred + c * plane + ly0 * ww + lx;
      const float* qq = targ + c * plane + ly0 * ww + lx;
      RowSums h[kHaloRows];
      float cx[kRows], cy[kRows];  // the pixels' own values
#pragma unroll
      for (int i = 0; i < kHaloRows; ++i) {
        if (i < nrows + 2 * kHalf) {
          h[i] = row_sums(pp + i * ww, qq + i * ww);
          if (i >= kHalf && i < kHalf + kRows) {
            cx[i - kHalf] = pp[i * ww + kHalf];
            cy[i - kHalf] = qq[i * ww + kHalf];
          }
        }
        const int r = i - (kWin - 1);  // the output row complete at i
        if (r < 0 || r >= nrows) continue;
        float sx = h[r].x, sy = h[r].y, sxx = h[r].xx, syy = h[r].yy,
              sxy = h[r].xy;
#pragma unroll
        for (int dy = 1; dy < kWin; ++dy) {
          sx = sx + h[r + dy].x;
          sy = sy + h[r + dy].y;
          sxx = sxx + h[r + dy].xx;
          syy = syy + h[r + dy].yy;
          sxy = sxy + h[r + dy].xy;
        }
        const float mu_x = sx * inv;
        const float mu_y = sy * inv;
        const float sigma_x2 = sxx * inv - mu_x * mu_x;
        const float sigma_y2 = syy * inv - mu_y * mu_y;
        const float sigma_xy = sxy * inv - mu_x * mu_y;
        const float num = (2.f * mu_x * mu_y + c1) * (2.f * sigma_xy + c2);
        const float den =
            (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x2 + sigma_y2 + c2);
        const float dssim = (1.f - num / den) * 0.5f;
        const float d = cx[r] - cy[r];
        const bool valid = tx0 + lx < img_w && ty0 + ly0 + r < img_h;
        float gr = l1 * sign_of(d) + l2 * d;
        gr = gr + ld * dssim * d;
        gr = valid ? gr : 0.f;
        o[c * npix + r * tile_w] = gr;
        acc_t[r] = c == 0 ? bg[0] * gr : acc_t[r] + bg[c] * gr;
        if (valid) {
          s_abs += fabsf(d);
          s_sq += d * d;
          s_ds += dssim;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nrows) break;
      float* q = o + r * tile_w;
      q[3 * npix] = 0.f;
      q[kOutT * npix] = acc_t[r];
      q[5 * npix] = 0.f;
      q[6 * npix] = 0.f;
      q[7 * npix] = 0.f;
      if (tx0 + lx < img_w && ty0 + ly0 + r < img_h) s_px += 1.f;
    }
  }

  // deterministic block reduction of the four partials
  float v[kNumSums] = {s_abs, s_sq, s_ds, s_px};
#pragma unroll
  for (int k = 0; k < kNumSums; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[k] += __shfl_down_sync(kFull, v[k], off);
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < kNumSums; ++k) warp_sums[warp * kNumSums + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int nwarps = blockDim.x >> 5;
    for (int k = 0; k < kNumSums; ++k) {
      float s = warp_sums[k];
      for (int w = 1; w < nwarps; ++w) s += warp_sums[w * kNumSums + k];
      sums[(size_t)t * kNumSums + k] = s;
    }
  }
}

// Threads and dynamic shared bytes of one tile's CTA.
void launch_shape(int tile_w, int tile_h, int* threads, size_t* smem) {
  const int items = tile_w * ((tile_h + kRows - 1) / kRows);
  *threads = min(kMaxThreads, (items + 31) / 32 * 32);
  const size_t plane = (size_t)(tile_h + 2 * kHalf) * (tile_w + 2 * kHalf);
  *smem = sizeof(float) * (6 * plane + kMaxWarps * kNumSums);
}

// Allow the dynamic shared memory a tile needs above the 48 KB default.
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(tile_loss_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

bool valid_tile(int tile_w, int tile_h) {
  return tile_w > 0 && tile_h > 0 && tile_w * tile_h <= kMaxTilePx;
}

}  // namespace

extern "C" int webdgs_tile_loss(const void* out, const void* target,
                                int n_tiles, int ntx, int tile_w, int tile_h,
                                int img_w, int img_h, float l1, float l2,
                                float ld, float c1, float c2, float bg0,
                                float bg1, float bg2, void* dpix, void* sums,
                                void* stream) {
  if (n_tiles <= 0 || ntx <= 0 || !valid_tile(tile_w, tile_h) ||
      img_w < kWin || img_h < kWin) {
    return (int)cudaErrorInvalidValue;
  }
  int threads;
  size_t smem;
  launch_shape(tile_w, tile_h, &threads, &smem);
  const cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  tile_loss_kernel<<<n_tiles, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(out), static_cast<const float*>(target), ntx,
      tile_w, tile_h, img_w, img_h, l1, l2, ld, c1, c2, bg0, bg1, bg2,
      static_cast<float*>(dpix), static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

// The launch shape for a tile: out = {threads, dynamic shared bytes, CTAs
// per SM, registers, output rows per thread}.
extern "C" int webdgs_tile_loss_occupancy(int tile_w, int tile_h, int* out) {
  if (!valid_tile(tile_w, tile_h)) return (int)cudaErrorInvalidValue;
  int threads;
  size_t smem;
  launch_shape(tile_w, tile_h, &threads, &smem);
  cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, tile_loss_kernel);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, tile_loss_kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = threads;
  out[1] = (int)smem;
  out[2] = ctas;
  out[3] = attr.numRegs;
  out[4] = kRows;
  return 0;
}
