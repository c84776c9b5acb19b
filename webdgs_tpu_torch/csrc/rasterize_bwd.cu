// Backward tile rasterizer: per-entry cotangents of centre (2), conic (3),
// colour (3) and opacity (1) from the per-pixel cotangents of the forward
// output.  Hopper (sm_90a) CUDA C++, plain C interface.
//
// Replaces the TPU kernel webdgs_tpu/ops/rasterize.py:_bwd_kernel
// (launched by _backward_impl, the custom VJP of rasterize_tiles).  The
// TPU version forms the chunk's prefix sums with triangular MXU matmuls,
// reduces over pixels with MXU contractions, and writes chunk-aligned DMA
// windows with a read-modify-write of boundary chunks shared with the
// previous tile.  Here, as in rasterize_fwd.cu, one CTA owns one tile and
// one thread one pixel; each tile writes only its own slots
// [uo, uo + cnt) of a zero-initialised (16, E) buffer, so windows, masks,
// zero fills and the read-modify-write have no counterpart.
//
// Per pixel, the thread walks the tile's entries front to back and
// recomputes alpha and the exclusive transmittance T exactly as the
// forward kernel does (same float ops, same alpha_min / t_threshold
// decisions).  It carries cum_u = sum gamma * w (inclusive) and forms
//   dL/dalpha = gamma * T - (suffix - cum_u) / (1 - alpha),
// gamma = sum_c g_c * colour_c + g_acc, from the per-pixel suffix term
// suffix = sum_c g_c * out_c + g_acc * acc + g_T * T_final folded outside
// the kernel (the TPU kernel's identity, rasterize.py:432-481): no
// back-to-front replay.  With G = exp(-power/2), unclamped = op*G < alpha_max:
//   d_op = dL/dalpha * G, dL/dG = dL/dalpha * op (both 0 when clamped),
//   q = dL/dG * (-G/2), d_colour_c = g_c * w,
// and the per-entry sums over the tile's pixels of
//   d r, d g, d b, d op, S_qx, S_qy, sum qx*dx, sum qx*dy, sum qy*dy
// (qx = q*dx, qy = q*dy) give d_cx = -2 (ca S_qx + cb S_qy),
// d_cy = -2 (cb S_qx + cc S_qy), d_ca = sum qx dx, d_cb = 2 sum qx dy,
// d_cc = sum qy dy.  Rows 9-15 (extents, spare) stay 0.
//
// The 9 sums are reduced deterministically, 32 entries at a time: a
// warp-shuffle tree per entry (skipped, with an exact 0, when no lane of
// the warp has a live contribution), the warp partials staged in shared
// memory (16 warps x 9 x 32 floats = 18 KB), then summed in warp order.
// Every lane of a warp takes part in each shuffle: a saturated pixel
// contributes zeros.  The tile stops once no pixel is still compositing
// (one __syncthreads_or per chunk), as the forward does.
//
// What bounds it on the H100: the arithmetic over (pixel, entry) pairs --
// about 40 fp32 operations, one expf and one log1pf per live pair -- and
// the shuffles of the per-entry reduction (45 per warp and entry that has a
// live pixel); device-memory traffic (the (16, E) rows in, 9 rows out, the
// (T, 5, P) pixel cotangents) is small beside it.  First, simple version:
// synchronous staging, accurate expf/log1pf, compiled with -fmad=false so
// the alpha and T decisions round as in the forward kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowCx = 0, kRowCy = 1, kRowCa = 2, kRowCb = 3, kRowCc = 4;
constexpr int kRowR = 5, kRowG = 6, kRowB = 7, kRowOp = 8, kRowEx = 9,
              kRowEy = 10;
constexpr int kUsedRows = 11;
constexpr int kNumGpix = 5;  // d r, d g, d b, d acc, suffix
constexpr int kNumSums = 9;
constexpr int kSub = 32;  // entries reduced per round
constexpr int kMaxWarps = 32;

__global__ void rasterize_bwd_kernel(
    const float* __restrict__ attrs, int e_len,
    const int32_t* __restrict__ offsets, const float* __restrict__ gpix,
    int ntx, int tile_w, int tile_h, int chunk, float alpha_min,
    float alpha_max, float t_threshold, float log_t_min,
    float* __restrict__ d_attrs) {
  extern __shared__ float smem[];
  const int nwarps = blockDim.x >> 5;
  float* stage = smem;                              // kUsedRows x chunk
  float* partial = stage + kUsedRows * chunk;       // nwarps x 9 x kSub
  float* total = partial + nwarps * kNumSums * kSub;  // 9 x kSub

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int npix = tile_w * tile_h;
  const bool real = p < npix;
  const float px = (float)((t % ntx) * tile_w + p % tile_w) + 0.5f;
  const float py = (float)((t / ntx) * tile_h + p / tile_w) + 0.5f;
  const int uo = offsets[t];
  const int cnt = offsets[t + 1] - uo;

  float g_r = 0.f, g_g = 0.f, g_b = 0.f, g_acc = 0.f, suffix = 0.f;
  if (real) {
    const float* gp = gpix + (size_t)t * kNumGpix * npix + p;
    g_r = gp[0 * npix];
    g_g = gp[1 * npix];
    g_b = gp[2 * npix];
    g_acc = gp[3 * npix];
    suffix = gp[4 * npix];
  }
  float log_t_un = 0.f, t_cur = 1.f, cum_u = 0.f;
  bool done = !real || !(t_cur >= t_threshold);

  for (int c0 = 0; c0 < cnt; c0 += chunk) {
    const int n_in = min(chunk, cnt - c0);
    __syncthreads();  // every thread is past the previous chunk
    for (int i = p; i < kUsedRows * n_in; i += blockDim.x) {
      const int row = i / n_in;
      const int j = i - row * n_in;
      stage[row * chunk + j] = attrs[(size_t)row * e_len + uo + c0 + j];
    }
    __syncthreads();

    for (int s0 = 0; s0 < n_in; s0 += kSub) {
      const int n_sub = min(kSub, n_in - s0);
      for (int jj = 0; jj < n_sub; ++jj) {
        const int j = s0 + jj;
        float v[kNumSums];
        for (int k = 0; k < kNumSums; ++k) v[k] = 0.f;
        bool live = false;
        if (!done) {
          const float dx = px - stage[kRowCx * chunk + j];
          const float dy = py - stage[kRowCy * chunk + j];
          const float ca = stage[kRowCa * chunk + j];
          const float cb = stage[kRowCb * chunk + j];
          const float cc = stage[kRowCc * chunk + j];
          const float op = stage[kRowOp * chunk + j];
          const float u1 = ca * dx + cb * dy;
          const float u2 = cb * dx + cc * dy;
          const float power = dx * u1 + dy * u2;
          const float gw = expf(-0.5f * power);
          const float op_g = op * gw;
          const float alpha = fminf(op_g, alpha_max);
          live = fabsf(dx) <= stage[kRowEx * chunk + j] &&
                 fabsf(dy) <= stage[kRowEy * chunk + j] && alpha >= alpha_min;
          if (live) {
            const float w = alpha * t_cur;
            const float gamma = g_r * stage[kRowR * chunk + j] +
                                g_g * stage[kRowG * chunk + j] +
                                g_b * stage[kRowB * chunk + j] + g_acc;
            cum_u += gamma * w;
            const float dl_da =
                gamma * t_cur - (suffix - cum_u) / (1.f - alpha);
            const bool unclamped = op_g < alpha_max;
            const float dl_dg = unclamped ? dl_da * op : 0.f;
            const float q = dl_dg * (-0.5f * gw);
            const float qx = q * dx;
            const float qy = q * dy;
            v[0] = g_r * w;
            v[1] = g_g * w;
            v[2] = g_b * w;
            v[3] = unclamped ? dl_da * gw : 0.f;
            v[4] = qx;
            v[5] = qy;
            v[6] = qx * dx;
            v[7] = qx * dy;
            v[8] = qy * dy;
            log_t_un += log1pf(-alpha);
            t_cur = expf(log_t_un);
            done = !(t_cur >= t_threshold);
          }
        }
        if (__any_sync(0xffffffffu, live)) {
          for (int k = 0; k < kNumSums; ++k) {
            for (int off = 16; off > 0; off >>= 1) {
              v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
            }
          }
        }
        if (lane == 0) {
          for (int k = 0; k < kNumSums; ++k) {
            partial[(warp * kNumSums + k) * kSub + jj] = v[k];
          }
        }
      }
      __syncthreads();
      // one thread per (sum k, entry jj): the warp partials in warp order
      for (int i = p; i < kNumSums * kSub; i += blockDim.x) {
        const int k = i / kSub;
        const int jj = i - k * kSub;
        if (jj < n_sub) {
          float s = partial[k * kSub + jj];
          for (int w = 1; w < nwarps; ++w) {
            s += partial[(w * kNumSums + k) * kSub + jj];
          }
          total[i] = s;
        }
      }
      __syncthreads();
      if (p < n_sub) {
        const int j = s0 + p;
        const int slot = uo + c0 + j;
        const float ca = stage[kRowCa * chunk + j];
        const float cb = stage[kRowCb * chunk + j];
        const float cc = stage[kRowCc * chunk + j];
        const float s_qx = total[4 * kSub + p];
        const float s_qy = total[5 * kSub + p];
        d_attrs[(size_t)kRowCx * e_len + slot] = -2.f * (ca * s_qx + cb * s_qy);
        d_attrs[(size_t)kRowCy * e_len + slot] = -2.f * (cb * s_qx + cc * s_qy);
        d_attrs[(size_t)kRowCa * e_len + slot] = total[6 * kSub + p];
        d_attrs[(size_t)kRowCb * e_len + slot] = 2.f * total[7 * kSub + p];
        d_attrs[(size_t)kRowCc * e_len + slot] = total[8 * kSub + p];
        d_attrs[(size_t)kRowR * e_len + slot] = total[0 * kSub + p];
        d_attrs[(size_t)kRowG * e_len + slot] = total[1 * kSub + p];
        d_attrs[(size_t)kRowB * e_len + slot] = total[2 * kSub + p];
        d_attrs[(size_t)kRowOp * e_len + slot] = total[3 * kSub + p];
      }
    }
    if (!__syncthreads_or(!done && log_t_un >= log_t_min)) break;
  }
}

}  // namespace

extern "C" int webdgs_rasterize_bwd(const void* attrs16, int e_len,
                                    const void* tile_offsets,
                                    const void* gpix5, int n_tiles, int ntx,
                                    int tile_w, int tile_h, int chunk,
                                    float alpha_min, float alpha_max,
                                    float t_threshold, float log_t_min,
                                    void* d_attrs, void* stream) {
  const int npix = tile_w * tile_h;
  // whole warps: pixels past npix are idle lanes that contribute zeros
  const int threads = (npix + 31) / 32 * 32;
  const int nwarps = threads / 32;
  if (n_tiles <= 0 || npix <= 0 || threads > kMaxWarps * 32 || chunk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * ((size_t)kUsedRows * chunk +
                                       (size_t)nwarps * kNumSums * kSub +
                                       (size_t)kNumSums * kSub);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rasterize_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rasterize_bwd_kernel<<<n_tiles, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(attrs16), e_len,
      static_cast<const int32_t*>(tile_offsets),
      static_cast<const float*>(gpix5), ntx, tile_w, tile_h, chunk,
      alpha_min, alpha_max, t_threshold, log_t_min,
      static_cast<float*>(d_attrs));
  return (int)cudaGetLastError();
}
