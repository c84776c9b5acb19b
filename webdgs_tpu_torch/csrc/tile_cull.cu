// The exact per-(Gaussian, tile) alpha cull of tile binning, in two
// kernels.  Hopper (sm_90a) CUDA C++, plain C interface.
//
// Replaces no TPU kernel: the JAX package computes the cull as XLA chains
// (webdgs_tpu/ops/binning.py:_cull_bitmask and _select_nth_set_bit), and
// the port ran the same chains in torch (ops/binning.py, kept there as the
// plain versions for CPU tensors).  On the card those chains were most of
// a training step's and of a viewer frame's device time: about a hundred
// elementwise launches over (N, 64) temporaries, one column per rect
// position of every slot, dead slots included, and six SWAR popcounts in
// int64 per entry slot.
//
// - cull_words: one thread per Gaussian slot.  It writes the slot's five
//   binning words, the layout expand_fields takes -- the key base
//   (base_tile << 16) | depth16, a zero offsets row (the caller writes the
//   offsets after its overflow drop), tiles_x, and the survivor mask lo/hi
//   -- and the survivor count.  It loops only over the rect's own
//   positions (a mean rect is 3-4 tiles; a slot with no tiles skips the
//   loop) and keeps the 64-bit mask in registers.
// - entry_keys: one thread per entry slot.  It reads the slot's expanded
//   words and the device-side total, selects the slot's rect position from
//   the survivor mask with __popc on 32-bit words, and writes the int64 sort
//   key, or the sentinel past the total.
//
// What bounds them on the H100: memory, and in cull_words the loop.
// cull_words reads 56 bytes and writes 24 per slot; entry_keys reads 20
// bytes per valid entry and writes 8 per entry slot.  cull_words' loop
// (about 40 float operations per rect position, four of them IEEE
// divisions) grows with the rects: the kernel takes 1.4x its byte bound at
// a 960x540 densify view (2.2 positions per slot with tiles) and 2.9x at a
// 1920x1080 frame (2.9); entry_keys takes 1.2-1.5x (PERF.md, row 7).
//
// Exactness: both return the same integers as the plain torch chains run on
// the same CUDA tensors.  The build's -fmad=false keeps each float
// operation rounding once, in the chain's order; logf is the accurate
// library function, as torch.log's; Python constants round to float32 once
// (the k constants below), as torch casts a scalar operand; a tensor
// divided by a Python scalar on the card is a product with the scalar's
// reciprocal, which torch takes in double and rounds to float32 once (the
// wrapper passes it so); torch.maximum, torch.minimum and torch.clamp
// propagate NaN, which fmaxf and fminf alone would not.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPositions = 64;  // rect positions the survivor mask covers
constexpr unsigned kMask32 = 0xffffffffu;
constexpr long long kSentinelKey = 0xffffffffLL;

// The chain's Python constants as torch casts them: double, then float32.
constexpr float kOpacityFloor = static_cast<float>(1e-12);
constexpr float kConicFloor = static_cast<float>(1e-12);
constexpr float kThrSlack = static_cast<float>(1.0 + 1e-5);
constexpr float kThrAdd = static_cast<float>(1e-4);
constexpr float kExtentSlack = static_cast<float>(1e-3);
constexpr float kQminShrink = static_cast<float>(1.0 - 1.0 / 4096.0);

__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// torch.clamp(v, lo, hi) with tensor bounds: NaN in any operand comes
// through; otherwise min(max(v, lo), hi), so hi wins when lo > hi.
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  if (v != v) return v;
  if (lo != lo) return lo;
  if (hi != hi) return hi;
  return fminf(fmaxf(v, lo), hi);
}

// The low k bits set, for k in [0, 32].
__device__ __forceinline__ unsigned low_bits(int k) {
  return k >= 32 ? kMask32 : (k <= 0 ? 0u : (1u << k) - 1u);
}

// The chain's quadratic at a point of the box's x edge (dxf fixed, dy
// clamped into [y0, y1]) and of its y edge.
__device__ __forceinline__ float edge_x(float dxf, float ca, float cb2,
                                        float cc, float ncb, float cc_s,
                                        float y0, float y1) {
  const float dy = clamp_t((ncb * dxf) / cc_s, y0, y1);
  return (ca * dxf + cb2 * dy) * dxf + cc * dy * dy;
}

__device__ __forceinline__ float edge_y(float dyf, float ca, float cb2,
                                        float cc, float ncb, float ca_s,
                                        float x0, float x1) {
  const float dx = clamp_t((ncb * dyf) / ca_s, x0, x1);
  return (ca * dx + cb2 * dyf) * dx + cc * dyf * dyf;
}

__global__ void __launch_bounds__(kThreads) cull_words_kernel(
    const float* __restrict__ conic, const float* __restrict__ opacity,
    const float* __restrict__ center, const float* __restrict__ extents,
    const int32_t* __restrict__ tile_min,
    const int32_t* __restrict__ tile_dims,
    const int32_t* __restrict__ num_tiles, const float* __restrict__ depth,
    int n, int ntx, int tile_w, int tile_h, float inv_alpha_min,
    int32_t* __restrict__ words, int32_t* __restrict__ counts) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int tmx = __ldg(tile_min + 2 * i);
  const int tmy = __ldg(tile_min + 2 * i + 1);
  const int tdx = __ldg(tile_dims + 2 * i);
  const int nt = __ldg(num_tiles + i);

  // key base: (base_tile << 16) | top 16 bits of the order-preserving
  // depth bits, clamped to 0xFFFE
  const unsigned bits = __float_as_uint(__ldg(depth + i));
  const unsigned ordered = bits ^ ((bits >> 31) ? kMask32 : 0x80000000u);
  const unsigned depth16 = min(ordered >> 16, 0xfffeu);
  const unsigned base = (unsigned)tmy * (unsigned)ntx + (unsigned)tmx;

  unsigned lo = 0u, hi = 0u;
  int count = 0;
  if (nt > kPositions) {
    // large rects keep every tile: identity masks
    lo = hi = kMask32;
    count = nt;
  } else if (nt > 0) {
    const float ca = __ldg(conic + 3 * i), cb = __ldg(conic + 3 * i + 1);
    const float cc = __ldg(conic + 3 * i + 2);
    const bool convex = ca > 0.0f && cc > 0.0f && ca * cc - cb * cb > 0.0f;
    if (!convex) {
      lo = low_bits(nt);
      hi = low_bits(nt - 32);
    } else {
      // cull iff qmin > qthr = 2 ln(op / alpha_min), rounded up for safety
      const float op = nan_max(__ldg(opacity + i), kOpacityFloor);
      const float qthr = 2.0f * logf(op * inv_alpha_min) * kThrSlack
                         + kThrAdd;
      const float cx = __ldg(center + 2 * i);
      const float cy = __ldg(center + 2 * i + 1);
      const float exm = __ldg(extents + 2 * i) + kExtentSlack;
      const float eym = __ldg(extents + 2 * i + 1) + kExtentSlack;
      const float ca_s = nan_max(ca, kConicFloor);
      const float cc_s = nan_max(cc, kConicFloor);
      const float ncb = -cb, cb2 = 2.0f * cb;
      const int tiles_x = max(tdx, 1);
      int q = 0, r = 0;
      for (int p = 0; p < nt; ++p) {
        // the tile's pixel-centre box relative to the splat centre
        // (int32 arithmetic that wraps, as torch's)
        const int px = (int)(((unsigned)tmx + r) * (unsigned)tile_w);
        const int py = (int)(((unsigned)tmy + q) * (unsigned)tile_h);
        float x0 = ((float)px + 0.5f) - cx;
        float y0 = ((float)py + 0.5f) - cy;
        float x1 = x0 + (float)(tile_w - 1);
        float y1 = y0 + (float)(tile_h - 1);
        // intersected with the extent box the rasterizer also tests
        const bool empty = x0 > exm || x1 < -exm || y0 > eym || y1 < -eym;
        x0 = nan_max(x0, -exm);
        x1 = nan_min(x1, exm);
        y0 = nan_max(y0, -eym);
        y1 = nan_min(y1, eym);
        const bool inside = x0 <= 0.0f && x1 >= 0.0f && y0 <= 0.0f &&
                            y1 >= 0.0f;
        // exact minimum of the convex quadratic over the box: interior (0)
        // or one of the four edges
        float qmin = nan_min(
            nan_min(edge_x(x0, ca, cb2, cc, ncb, cc_s, y0, y1),
                    edge_x(x1, ca, cb2, cc, ncb, cc_s, y0, y1)),
            nan_min(edge_y(y0, ca, cb2, cc, ncb, ca_s, x0, x1),
                    edge_y(y1, ca, cb2, cc, ncb, ca_s, x0, x1)));
        qmin = (inside ? 0.0f : qmin) * kQminShrink;
        if (!(qmin > qthr || empty)) {
          if (p < 32) {
            lo |= 1u << p;
          } else {
            hi |= 1u << (p - 32);
          }
        }
        if (++r == tiles_x) {
          r = 0;
          ++q;
        }
      }
    }
    count = __popc(lo) + __popc(hi);
  }
  const size_t stride = (size_t)n;
  words[i] = (int32_t)((base << 16) | depth16);
  words[stride + i] = 0;
  words[2 * stride + i] = tdx;
  words[3 * stride + i] = (int32_t)lo;
  words[4 * stride + i] = (int32_t)hi;
  counts[i] = count;
}

// Position of the (s+1)-th set bit of the 64-bit mask (hi:lo), s in
// [0, 64), by the popcount search of the chain: the word, then halves of
// 16, 8, 4, 2 and 1 bits.
__device__ __forceinline__ int nth_set_bit(unsigned lo, unsigned hi, int s) {
  const int pc_lo = __popc(lo);
  unsigned m = lo;
  int p = 0;
  if (s >= pc_lo) {
    m = hi;
    s -= pc_lo;
    p = 32;
  }
#pragma unroll
  for (int width = 16; width >= 1; width >>= 1) {
    const int c = __popc(m & ((1u << width) - 1u));
    if (s >= c) {
      s -= c;
      p += width;
      m >>= width;
    }
  }
  return p;
}

__global__ void __launch_bounds__(kThreads) entry_keys_kernel(
    const int32_t* __restrict__ words, const long long* __restrict__ total,
    int e_cap, int ntx, long long* __restrict__ keys) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= e_cap) return;
  if ((long long)e >= __ldg(total)) {
    keys[e] = kSentinelKey;
    return;
  }
  const size_t stride = (size_t)e_cap;
  const unsigned key_base = (unsigned)__ldg(words + e);
  const long long slot = (long long)e - (long long)__ldg(words + stride + e);
  const int tx = __ldg(words + 2 * stride + e);
  const long long tiles_x = tx > 1 ? tx : 1;
  long long pos = slot;
  if (slot < kPositions) {
    pos = nth_set_bit((unsigned)__ldg(words + 3 * stride + e),
                      (unsigned)__ldg(words + 4 * stride + e),
                      slot > 0 ? (int)slot : 0);
  }
  const long long q = pos / tiles_x;  // pos >= 0, tiles_x >= 1: floor
  const long long r = pos - q * tiles_x;
  const unsigned long long tile = (unsigned long long)(q * ntx + r);
  keys[e] = (long long)((key_base + (unsigned)(tile << 16)) & kMask32);
}

}  // namespace

extern "C" int webdgs_cull_words(const void* conic, const void* opacity,
                                 const void* center, const void* extents,
                                 const void* tile_min, const void* tile_dims,
                                 const void* num_tiles, const void* depth,
                                 int n, int ntx, int tile_w, int tile_h,
                                 float inv_alpha_min, void* words,
                                 void* counts, void* stream) {
  if (n <= 0 || tile_w <= 0 || tile_h <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n - 1) / kThreads + 1;
  cull_words_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(conic), static_cast<const float*>(opacity),
      static_cast<const float*>(center), static_cast<const float*>(extents),
      static_cast<const int32_t*>(tile_min),
      static_cast<const int32_t*>(tile_dims),
      static_cast<const int32_t*>(num_tiles),
      static_cast<const float*>(depth), n, ntx, tile_w, tile_h,
      inv_alpha_min, static_cast<int32_t*>(words),
      static_cast<int32_t*>(counts));
  return (int)cudaGetLastError();
}

extern "C" int webdgs_entry_keys(const void* words, const void* total,
                                 int e_cap, int ntx, void* keys,
                                 void* stream) {
  if (e_cap <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (e_cap - 1) / kThreads + 1;
  entry_keys_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(words),
      static_cast<const long long*>(total), e_cap, ntx,
      static_cast<long long*>(keys));
  return (int)cudaGetLastError();
}
