// Complex soft threshold for Hopper (sm_90a):
//   out = sign(Re v) max(|Re v| - tau, 0) + j sign(Im v) max(|Im v| - tau, 0)
// in one pass over torch's interleaved complex64, with one tau for all
// entries or one tau per (n, m) matrix of v.
//
// Replaces the Pallas TPU kernel jstsp19_tpu/kernels/softthresh.py
// (fused_soft_threshold -> pallas_call at :30, body _kernel at :17).  In the
// port it is the shrinkage of the unfused solvers/admm.py::proposed_admm on
// every iteration, with the per-realization threshold tau_S / rho.
//
// What bounds it: device memory and launch latency.  It reads 8 bytes and
// writes 8 bytes per entry with six flops; at the port's shapes (256
// realizations of 32 x 16) the whole pass moves 256 kB, so launch latency
// dominates.  One grid-stride loop of float2 loads and stores, so
// neighbouring threads touch neighbouring addresses.  The arithmetic is that of solvers/sparse.py::soft_threshold
// (torch.sign times torch.clamp), NaN included.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (jstsp19_torch/kernels/build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ inline float shrink(float x, float tau) {
  float mag = fabsf(x) - tau;
  mag = mag < 0.f ? 0.f : mag;  // a NaN stays NaN, as in torch.clamp
  const float sgn = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return sgn * mag;
}

__global__ void __launch_bounds__(kThreads) soft_threshold_kernel(
    const float2* v, const float* __restrict__ tau, long long mat_size, float2* out,
    long long total) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total; i += step) {
    const float t = tau[mat_size ? i / mat_size : 0];
    const float2 x = v[i];
    out[i] = make_float2(shrink(x.x, t), shrink(x.y, t));
  }
}

}  // namespace

extern "C" {

// Thresholds `total` complex entries of v into out on
// `stream`.  mat_size = n*m gives entry i the threshold tau[i / mat_size];
// mat_size = 0 gives every entry tau[0].  Returns the cudaGetLastError()
// code of the launch (0 = launched).
int soft_threshold_launch(
    const void* v, const void* tau, long long mat_size, void* out, long long total,
    void* stream) {
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  soft_threshold_kernel<<<(int)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(v), static_cast<const float*>(tau), mat_size,
      static_cast<float2*>(out), total);
  return (int)cudaGetLastError();
}

}  // extern "C"
