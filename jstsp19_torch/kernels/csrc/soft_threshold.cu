// Complex soft threshold for Hopper (sm_90a):
//   out = sign(Re v) max(|Re v| - tau, 0) + j sign(Im v) max(|Im v| - tau, 0)
// in one pass over torch's interleaved complex64, with one tau for all
// entries or one tau per group of consecutive entries (one (n, m) matrix).
//
// Replaces the Pallas TPU kernel jstsp19_tpu/kernels/softthresh.py
// (fused_soft_threshold -> pallas_call at :30, body _kernel at :17).  In the
// port it is the shrinkage of the unfused solvers/admm.py::proposed_admm on
// every iteration, with the per-realization threshold tau_S / rho.
//
// What bounds it: device memory and launch latency.  It reads 8 bytes and
// writes 8 bytes per entry with six flops; at the port's shapes (256
// realizations of 32 x 16) the whole pass moves 2.1 MB.
//
// Design: the grid runs over (group, chunk): a block holds 256 vectors of
// one group, so each thread reads its tau once (the block's threads all read
// the same word), finds its group with one 32-bit division a block, and
// moves one 16-byte vector (two complex entries) each way, with a scalar
// tail where the group's count is odd.  Where v starts off a 16-byte
// boundary, or the groups have an odd count, the vectors are single
// entries.  The grid is sized to the work.  A single tau comes by value, a
// tau in device memory with the stride between groups (0: one for all).
// The arithmetic is that of solvers/sparse.py::soft_threshold (torch.sign
// times torch.clamp), NaN included.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (jstsp19_torch/kernels/build.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ inline float shrink(float x, float tau) {
  float mag = fabsf(x) - tau;
  mag = mag < 0.f ? 0.f : mag;  // a NaN stays NaN, as in torch.clamp
  const float sgn = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return sgn * mag;
}

__device__ inline float2 shrink2(float2 x, float tau) { return make_float2(shrink(x.x, tau), shrink(x.y, tau)); }

// vw = 2: 16-byte vectors; vw = 1: single entries.
template <int vw>
__global__ void __launch_bounds__(kThreads) soft_threshold_kernel(
    const float2* __restrict__ v, float2* __restrict__ out, const float* __restrict__ tau,
    long long tau_stride, float tau_value, long long group, unsigned blocks_per_group) {
  const unsigned g = blockIdx.x / blocks_per_group;  // once a block
  const long long first = (long long)(blockIdx.x - g * blocks_per_group) * (kThreads * vw);
  const long long left = group - first;  // entries of the group from the block's first on
  const int i = threadIdx.x * vw;
  if (i >= left) return;
  const float t = tau ? tau[g * tau_stride] : tau_value;
  const long long at = g * group + first + i;
  if (vw == 2 && i + 1 < left) {
    const float4 x = *reinterpret_cast<const float4*>(v + at);
    const float2 lo = shrink2(make_float2(x.x, x.y), t), hi = shrink2(make_float2(x.z, x.w), t);
    *reinterpret_cast<float4*>(out + at) = make_float4(lo.x, lo.y, hi.x, hi.y);
  } else {
    out[at] = shrink2(v[at], t);
  }
}

}  // namespace

extern "C" {

// What a launch needs besides the pointers and a tau given by value:
// kernels/softthresh.py::_Params holds the same fields, one instance per
// shape and tau layout, kept for the process.
struct SoftParams {
  long long tau_stride, group, groups;
};

// Thresholds p->groups groups of p->group complex entries of v into out on
// `stream`.  Group g takes tau[g * p->tau_stride] where tau is not null,
// else tau_value.  Returns the cudaGetLastError() code of the launch (0 =
// launched), or cudaErrorInvalidValue for an empty or a too large grid (over
// 2^31 - 1 blocks).
int soft_threshold_launch(const void* v, void* out, const void* tau, const SoftParams* p, float tau_value,
                          void* stream) {
  const bool vec = !((reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) & 15) &&
                   (!(p->group & 1) || p->groups == 1);
  const int vw = vec ? 2 : 1;
  const long long per_group = (p->group + (long long)kThreads * vw - 1) / ((long long)kThreads * vw);
  const long long blocks = per_group * p->groups;
  if (blocks <= 0 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* in = static_cast<const float2*>(v);
  float2* o = static_cast<float2*>(out);
  const float* t = static_cast<const float*>(tau);
  if (vec) {
    soft_threshold_kernel<2><<<(unsigned)blocks, kThreads, 0, s>>>(in, o, t, p->tau_stride, tau_value,
                                                                  p->group, (unsigned)per_group);
  } else {
    soft_threshold_kernel<1><<<(unsigned)blocks, kThreads, 0, s>>>(in, o, t, p->tau_stride, tau_value,
                                                                  p->group, (unsigned)per_group);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
