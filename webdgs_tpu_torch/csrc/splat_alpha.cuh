// The per-(pixel, entry) alpha of the tile rasterizer, shared by the
// forward kernel (rasterize_fwd.cu), the backward kernel
// (rasterize_bwd.cu) and the importance kernel (importance.cu).  All three
// must take the same alpha >= alpha_min decision for every pair: the
// backward replays the forward's transmittance, and the importance kernel
// trusts the n_contrib that the forward kernel wrote.  The expression
// matches the plain torch versions (ops/rasterize.py:_chunk_alpha) op for
// op; the build's -fmad=false and accurate expf keep each float operation
// rounding once, as on the CPU.
#pragma once

#include <cuda_runtime.h>

// Returns whether the entry is kept at this pixel (inside its extent box
// and alpha >= alpha_min); *gw gets the Gaussian weight exp(-0.5 * power)
// and *alpha min(op * gw, alpha_max).  (dx, dy) = pixel centre - splat
// centre; (ca, cb, cc) the conic; (ex, ey) the extent half-widths.
__device__ __forceinline__ bool splat_alpha_weight(
    float dx, float dy, float ca, float cb, float cc, float op, float ex,
    float ey, float alpha_min, float alpha_max, float* alpha, float* gw) {
  const float u1 = ca * dx + cb * dy;
  const float u2 = cb * dx + cc * dy;
  const float power = dx * u1 + dy * u2;
  *gw = expf(-0.5f * power);
  *alpha = fminf(op * *gw, alpha_max);
  return fabsf(dx) <= ex && fabsf(dy) <= ey && *alpha >= alpha_min;
}

// The same decision and alpha, without the Gaussian weight.
__device__ __forceinline__ bool splat_alpha(float dx, float dy, float ca,
                                            float cb, float cc, float op,
                                            float ex, float ey,
                                            float alpha_min, float alpha_max,
                                            float* alpha) {
  float gw;
  return splat_alpha_weight(dx, dy, ca, cb, cc, op, ex, ey, alpha_min,
                            alpha_max, alpha, &gw);
}
