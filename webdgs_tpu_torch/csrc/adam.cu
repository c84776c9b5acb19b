// The per-group Adam update of a training step, in one pass.  Hopper
// (sm_90a) CUDA C++, plain C interface.
//
// Replaces no TPU kernel: the JAX package computes the update as an XLA
// chain (webdgs_tpu/ops/adam.py:adam_step), and the port ran the same chain
// in torch (ops/adam.py:adam_step_plain, kept there as the plain version
// for CPU tensors).  On the card that chain was a third of every training
// step's device time: the five parameter tensors and the five gradients
// concatenated into (N, 59) rows, some twenty out-of-place elementwise
// passes over them, three torch.where, the rows copied back out into five
// tensors, and three pageable uploads of per-lane vectors, each a host
// wait.
//
// A CTA takes a tile of kRows rows in four phases:
// 1. it copies the tile's rows of the five parameter tensors (means (N, 3),
//    quats (N, 4), log_scales (N, 3), opacity (N,), sh (N, 48)) and of the
//    five gradients into packed (kRows, 59) rows in shared memory, each
//    tensor read in one contiguous run, and the tile counts beside them;
// 2. a thread per element of the packed rows, in steps of kThreads, loads
//    its moments (the packed (N, 59) m and v, coalesced as they lie, all
//    the thread's loads issued before any is used), updates the element,
//    writes the new moments straight out and the parameter into the
//    shared rows;
// 3. a thread per visible row renormalises the row's quaternion there;
// 4. the new parameters go out to the five tensors, each written in one
//    contiguous run.
//
// What bounds it on the H100: memory.  With full SH it reads p, g, m and v
// (59 float32 lanes each) and the row's tile count, and writes p, m and v:
// 1,656 bytes a row, 1.46 ms at 2,961,408 rows.  With the DC coefficient
// alone it leaves the 45 SH rest lanes of the gradient unread: 1,476 bytes
// a row, 1.30 ms (PERF.md, row 8, has what it takes).  Nothing goes through device memory twice and the host uploads
// nothing: every hyperparameter is a kernel argument.  Measured against
// this design at 2,961,408 rows: a thread per element reading the five
// tensors in place, with no staging, 2.41 ms; the moments staged in shared
// memory too, 1.98-2.37 ms (tiles of 24-48 rows); tiles of 32, 48 and 96
// rows here, 2.10, 1.85 and 2.02 ms.
//
// Exactness: every lane equals the torch chain run on the same CUDA
// tensors.  The build's -fmad=false keeps each float operation rounding
// once, in the chain's order: beta1*m + (1-beta1)*g; ((1-beta2)*g)*g;
// -lr * (m*rc1) / (sqrt(v*rc2) + eps); p + step.  Python constants round to
// float32 once, as torch casts a scalar operand; a tensor divided by a
// Python scalar on the card is a product with the scalar's reciprocal
// (rc1, rc2, which the wrapper passes so); sqrtf and the division are
// IEEE-rounded, as torch's.  With the DC coefficient alone the chain
// multiplies the rest lanes' gradient by 0; the kernel takes it as 0
// unread, the same value for every finite gradient (the backward pass
// writes zeros there).  The quaternion's norm adds its four squares in
// the order torch's row reduction takes on the card; that order is the
// library's choice, not a contract, so the quaternion's lanes are held to 2
// ulp of the chain.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;     // rows per CTA: 30,464 bytes of shared rows
// the packed row, ops/adam.py's PACK_LAYOUT (which asserts these): the
// first lane of means, quats, log_scales, opacity_logits and sh, the first
// SH rest lane, and the row's width
constexpr int kMeansLo = 0, kQuatLo = 3, kScalesLo = 7, kOpacityLo = 10,
              kShLo = 11, kRestLo = 14, kLanes = 59;
// elements of the tile a thread updates
constexpr int kPerThread = (kRows * kLanes + kThreads - 1) / kThreads;
// the chain's clamp of the squared norm, as torch casts it
constexpr float kNormFloor = static_cast<float>(1e-24);

struct Tensors {
  // PACK_LAYOUT order: means, quats, log_scales, opacity_logits, sh
  const float* p0; const float* p1; const float* p2; const float* p3;
  const float* p4;
  const float* g0; const float* g1; const float* g2; const float* g3;
  const float* g4;
  float* o0; float* o1; float* o2; float* o3; float* o4;
  const float* m; const float* v; const int32_t* counts;
  float* m_out; float* v_out;
};

struct Scalars {
  // the learning rate of each lane group (``_step_lrs`` at the lanes
  // above) and the Adam constants
  float lr_means, lr_quats, lr_scales, lr_opacity, lr_dc, lr_rest;
  float beta1, one_minus_beta1, beta2, one_minus_beta2, eps;
  float rc1, rc2;  // 1/corr1, 1/corr2 in float32
};

__device__ __forceinline__ float lane_lr(int lane, const Scalars& s) {
  return lane < kQuatLo ? s.lr_means : lane < kScalesLo ? s.lr_quats
       : lane < kOpacityLo ? s.lr_scales : lane < kShLo ? s.lr_opacity
       : lane < kRestLo ? s.lr_dc : s.lr_rest;
}

// The first W lanes of the rows [row0, row0 + rows) of one (N, STRIDE)
// parameter tensor into lanes [LO, LO + W) of the packed rows; with
// W == STRIDE one contiguous run.
template <int W, int LO, int STRIDE = W>
__device__ __forceinline__ void stage_in(const float* __restrict__ src,
                                         long long row0, int rows,
                                         float* __restrict__ rows_sm) {
  const float* s = src + (size_t)row0 * STRIDE;
  for (int i = threadIdx.x; i < rows * W; i += kThreads) {
    const int r = i / W, c = i - r * W;
    rows_sm[r * kLanes + LO + c] = s[r * STRIDE + c];
  }
}

// The reverse: lanes [LO, LO + W) of the packed rows out to one tensor.
template <int W, int LO>
__device__ __forceinline__ void stage_out(const float* __restrict__ rows_sm,
                                          long long row0, int rows,
                                          float* __restrict__ dst) {
  float* d = dst + (size_t)row0 * W;
  for (int i = threadIdx.x; i < rows * W; i += kThreads) {
    const int r = i / W;
    d[i] = rows_sm[r * kLanes + LO + (i - r * W)];
  }
}

// FULL_SH: every SH lane's gradient is read; else the rest lanes' is 0.
template <bool FULL_SH>
__global__ void __launch_bounds__(kThreads) adam_kernel(Tensors t,
                                                        Scalars s,
                                                        long long n) {
  __shared__ float p_sm[kRows * kLanes];
  __shared__ float g_sm[kRows * kLanes];
  __shared__ int vis_sm[kRows];
  const long long row0 = (long long)blockIdx.x * kRows;
  const long long left = n - row0;
  const int rows = left < kRows ? (int)left : kRows;
  const int count = rows * kLanes;
  const size_t base = (size_t)row0 * kLanes;

  // 1. the tile's parameters and gradients into packed shared rows
  stage_in<3, kMeansLo>(t.p0, row0, rows, p_sm);
  stage_in<4, kQuatLo>(t.p1, row0, rows, p_sm);
  stage_in<3, kScalesLo>(t.p2, row0, rows, p_sm);
  stage_in<1, kOpacityLo>(t.p3, row0, rows, p_sm);
  stage_in<48, kShLo>(t.p4, row0, rows, p_sm);
  stage_in<3, kMeansLo>(t.g0, row0, rows, g_sm);
  stage_in<4, kQuatLo>(t.g1, row0, rows, g_sm);
  stage_in<3, kScalesLo>(t.g2, row0, rows, g_sm);
  stage_in<1, kOpacityLo>(t.g3, row0, rows, g_sm);
  if (FULL_SH) {
    stage_in<48, kShLo>(t.g4, row0, rows, g_sm);
  } else {  // the DC coefficient's 3 lanes of each 48
    stage_in<kRestLo - kShLo, kShLo, 48>(t.g4, row0, rows, g_sm);
  }
  if (threadIdx.x < rows) {
    vis_sm[threadIdx.x] = t.counts[row0 + threadIdx.x] > 0;
  }
  __syncthreads();

  // 2. each element's update: the moments in and out straight from device
  // memory, the parameter into the shared rows; a frozen row copied through
  float m_in[kPerThread], v_in[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = k * kThreads + threadIdx.x;
    if (e < count) {
      m_in[k] = t.m[base + e];
      v_in[k] = t.v[base + e];
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = k * kThreads + threadIdx.x;
    if (e >= count) break;
    const int r = e / kLanes, lane = e - r * kLanes;
    float m_new = m_in[k], v_new = v_in[k];
    if (vis_sm[r]) {
      // with DC only the rest lanes' gradient is 0, their rate 0
      const float g = FULL_SH || lane < kRestLo ? g_sm[e] : 0.0f;
      const float lr = lane_lr(lane, s);
      m_new = s.beta1 * m_in[k] + s.one_minus_beta1 * g;
      v_new = s.beta2 * v_in[k] + (s.one_minus_beta2 * g) * g;
      const float step = (-lr * (m_new * s.rc1))
                         / (sqrtf(v_new * s.rc2) + s.eps);
      p_sm[e] = p_sm[e] + step;
    }
    t.m_out[base + e] = m_new;
    t.v_out[base + e] = v_new;
  }
  __syncthreads();

  // 3. the quaternion's renormalisation, a thread per visible row:
  // sqrt(max(sum of squares, 1e-24)), then 1/qn and a product
  if (threadIdx.x < rows && vis_sm[threadIdx.x]) {
    float* q = p_sm + threadIdx.x * kLanes + kQuatLo;
    const float sq0 = q[0] * q[0], sq1 = q[1] * q[1], sq2 = q[2] * q[2],
                sq3 = q[3] * q[3];
    // in the order of torch's sum over a 59-lane row on the card: one warp,
    // lane k holding row lanes k and k + 32, combined by shuffles at offsets
    // 16, 8, 4, 2, 1, so row lanes 3..6 add as (4 + 6) + (3 + 5)
    const float sum = (sq1 + sq3) + (sq0 + sq2);
    // torch.clamp propagates NaN, which fmaxf alone would not
    const float qn = sqrtf(sum != sum ? sum : fmaxf(sum, kNormFloor));
    const float rq = 1.0f / qn;
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = q[k] * rq;
  }
  __syncthreads();

  // 4. the new parameters out to their five tensors
  stage_out<3, kMeansLo>(p_sm, row0, rows, t.o0);
  stage_out<4, kQuatLo>(p_sm, row0, rows, t.o1);
  stage_out<3, kScalesLo>(p_sm, row0, rows, t.o2);
  stage_out<1, kOpacityLo>(p_sm, row0, rows, t.o3);
  stage_out<48, kShLo>(p_sm, row0, rows, t.o4);
}

}  // namespace

extern "C" int webdgs_adam_step(
    const void* const* params, const void* const* grads, const void* m,
    const void* v, const void* counts, void* const* out_params, void* m_out,
    void* v_out, long long n, const float* lrs, int full_sh, float beta1,
    float one_minus_beta1, float beta2, float one_minus_beta2, float eps,
    float rc1, float rc2, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n - 1) / kRows + 1;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Tensors t = {
      static_cast<const float*>(params[0]),
      static_cast<const float*>(params[1]),
      static_cast<const float*>(params[2]),
      static_cast<const float*>(params[3]),
      static_cast<const float*>(params[4]),
      static_cast<const float*>(grads[0]),
      static_cast<const float*>(grads[1]),
      static_cast<const float*>(grads[2]),
      static_cast<const float*>(grads[3]),
      static_cast<const float*>(grads[4]),
      static_cast<float*>(out_params[0]), static_cast<float*>(out_params[1]),
      static_cast<float*>(out_params[2]), static_cast<float*>(out_params[3]),
      static_cast<float*>(out_params[4]),
      static_cast<const float*>(m), static_cast<const float*>(v),
      static_cast<const int32_t*>(counts), static_cast<float*>(m_out),
      static_cast<float*>(v_out)};
  const Scalars s = {lrs[0], lrs[1], lrs[2], lrs[3], lrs[4], lrs[5],
                     beta1, one_minus_beta1, beta2, one_minus_beta2, eps,
                     rc1, rc2};
  if (full_sh) {
    adam_kernel<true><<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(t, s, n);
  } else {
    adam_kernel<false><<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(t, s, n);
  }
  return (int)cudaGetLastError();
}
