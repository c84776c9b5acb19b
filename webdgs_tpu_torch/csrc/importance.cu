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
// Design: one CTA per tile, one thread per pixel, as rasterize_fwd.cu.  The
// TPU kernel's DMA windows and its read-modify-write of chunks shared with
// the neighbouring tile have no counterpart: each CTA writes only its own
// tile's slots of a zeroed (E,) output.  Two work bounds, as on the TPU: a
// tile with no flagged pixel returns at once (one __syncthreads_or), and
// the chunk loop stops at the largest flagged n_contrib (a block max in
// shared memory).  Per entry, each warp counts its pixels' masks with
// __popc(__ballot_sync(...)); the warp counts go to shared memory and one
// thread per entry sums them in warp order.  Integer arithmetic and no
// atomics: the output is bit-identical from run to run.
//
// What bounds it on the H100: the expf of the alpha test over (flagged
// pixel, entry) pairs; the 8 used attribute rows of each chunk are staged
// once in shared memory (4 KB at chunk 128) and read back as broadcasts.
// This is the first, simple, correct version.

#include <cstdint>
#include <cuda_runtime.h>

#include "splat_alpha.cuh"

namespace {

// staged rows: cx, cy, ca, cb, cc, op, ex, ey -- rows 0-4 and 8-10 of the
// packed (16, E) entry array (ops/rasterize.py ROW_*)
constexpr int kStageRows = 8;
constexpr int kSCx = 0, kSCy = 1, kSCa = 2, kSCb = 3, kSCc = 4, kSOp = 5,
              kSEx = 6, kSEy = 7;

__device__ __forceinline__ int source_row(int staged_row) {
  return staged_row < 5 ? staged_row : staged_row + 3;
}

__global__ void importance_kernel(const float* __restrict__ attrs, int e_len,
                                  const int32_t* __restrict__ offsets,
                                  const float* __restrict__ pix, int ntx,
                                  int tile_w, int tile_h, int chunk,
                                  float alpha_min, float alpha_max,
                                  float* __restrict__ out) {
  extern __shared__ float smem[];
  float* stage = smem;  // kStageRows x chunk
  int* warp_cnt = reinterpret_cast<int*>(smem + kStageRows * chunk);
  __shared__ int warp_max[32];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int npix = blockDim.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int nwarps = npix >> 5;

  // per-pixel (flag, n_contrib), channel-minor (T, P, 2)
  const float* px_in = pix + ((size_t)t * npix + p) * 2;
  const bool flagged = px_in[0] > 0.f;
  const int n_contrib = flagged ? (int)px_in[1] : 0;
  if (!__syncthreads_or(flagged)) return;  // nothing to count in this tile

  const int m = __reduce_max_sync(0xffffffffu, n_contrib);
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  int max_nc = 0;
  for (int w = 0; w < nwarps; ++w) max_nc = max(max_nc, warp_max[w]);

  const int uo = offsets[t];
  const int live = min(offsets[t + 1] - uo, max_nc);
  const float px = (float)((t % ntx) * tile_w + p % tile_w) + 0.5f;
  const float py = (float)((t / ntx) * tile_h + p / tile_w) + 0.5f;

  for (int c0 = 0; c0 < live; c0 += chunk) {
    const int n_in = min(chunk, live - c0);
    __syncthreads();  // every thread is past the previous chunk's sums
    for (int i = p; i < kStageRows * n_in; i += npix) {
      const int row = i / n_in;
      const int j = i - row * n_in;
      stage[row * chunk + j] =
          attrs[(size_t)source_row(row) * e_len + uo + c0 + j];
    }
    __syncthreads();

    for (int j = 0; j < n_in; ++j) {
      bool mask = false;
      if (c0 + j + 1 <= n_contrib) {  // n_contrib is 0 unless flagged
        float alpha;
        mask = splat_alpha(px - stage[kSCx * chunk + j],
                           py - stage[kSCy * chunk + j],
                           stage[kSCa * chunk + j], stage[kSCb * chunk + j],
                           stage[kSCc * chunk + j], stage[kSOp * chunk + j],
                           stage[kSEx * chunk + j], stage[kSEy * chunk + j],
                           alpha_min, alpha_max, &alpha);
      }
      const unsigned votes = __ballot_sync(0xffffffffu, mask);
      if (lane == 0) warp_cnt[warp * chunk + j] = __popc(votes);
    }
    __syncthreads();

    for (int j = p; j < n_in; j += npix) {
      int s = 0;
      for (int w = 0; w < nwarps; ++w) s += warp_cnt[w * chunk + j];
      out[uo + c0 + j] = (float)s;
    }
  }
}

}  // namespace

extern "C" int webdgs_importance(const void* attrs16, int e_len,
                                 const void* tile_offsets, const void* pix,
                                 int n_tiles, int ntx, int tile_w, int tile_h,
                                 int chunk, float alpha_min, float alpha_max,
                                 void* out, void* stream) {
  const int npix = tile_w * tile_h;
  if (n_tiles <= 0 || npix <= 0 || npix > 1024 || npix % 32 != 0 ||
      chunk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * (kStageRows + npix / 32) * chunk;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  importance_kernel<<<n_tiles, npix, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(attrs16), e_len,
      static_cast<const int32_t*>(tile_offsets),
      static_cast<const float*>(pix), ntx, tile_w, tile_h, chunk, alpha_min,
      alpha_max, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
