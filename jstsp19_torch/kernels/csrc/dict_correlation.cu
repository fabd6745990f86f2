// Batched dictionary correlation out_b = A_b^H K_b B_b^H for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel jstsp19_tpu/kernels/dictionary.py
// (dict_correlation -> pallas_call at :79, body _kernel at :33).  In the
// port it is the sparse-code correlation A^H K B^H of the unfused
// solvers/admm.py::proposed_admm on every iteration and the adjoint
// KronDictOp.rmv of VAMP.  Shapes: K (batch, N, M); A (N, Gr) shared or
// (batch, N, Gr); B (Kd, M) shared or (batch, Kd, M); out (batch, Gr, Kd);
// all complex64 as torch stores it, interleaved (re, im) float pairs.
//
// What bounds it: launch latency and the two dependent contractions, not
// device memory.  At the shapes the port launches (N = 32, Gr = 32,
// Kd = 16, M = 16..140) one realization is 0.3-0.7 M real multiply-adds on
// under 100 kB of operands; the whole batch reads a few MB.
//
// First design: one block per realization.  A, a tile of K's columns and
// the same columns of B are staged in shared memory; the (Gr, tile)
// intermediate A^H K stays in shared memory, as the TPU kernel keeps the
// (Gr, M) intermediate in VMEM; each thread accumulates its own entries of
// out over the tiles.  A tile is up to kMTile = 160 columns, so the
// canonical M = 140 is one tile.  Plain fp32 FMA loops with a fixed
// reduction order (over n, then over m in increasing order across tiles):
// a run is deterministic.  Tensor cores, TMA and occupancy tuning are left
// for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (jstsp19_torch/kernels/build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMTile = 160;

__host__ __device__ inline int tile_cols(int M) { return M < kMTile ? M : kMTile; }

// complex entries of shared memory: A, the K tile, the B tile, the A^H K
// tile and the output accumulator
__host__ __device__ inline long long smem_entries(int N, int M, int Gr, int Kd) {
  const long long MT = tile_cols(M);
  return (long long)N * Gr + (N + Kd + Gr) * MT + (long long)Gr * Kd;
}

__global__ void __launch_bounds__(kThreads) dict_correlation_kernel(
    const float2* __restrict__ A, long long a_stride,
    const float2* __restrict__ K,
    const float2* __restrict__ B, long long b_stride,
    float2* __restrict__ out, int N, int M, int Gr, int Kd) {
  extern __shared__ float2 smem[];
  const int MT = tile_cols(M);
  float2* As = smem;             // (N, Gr)
  float2* Ks = As + N * Gr;      // (N, MT)
  float2* Bs = Ks + N * MT;      // (Kd, MT)
  float2* Ms = Bs + Kd * MT;     // (Gr, MT): A^H K on the tile
  float2* Os = Ms + Gr * MT;     // (Gr, Kd): the accumulator
  const long long b = blockIdx.x;
  const float2* Ab = A + b * a_stride;
  const float2* Kb = K + b * (long long)N * M;
  const float2* Bb = B + b * b_stride;
  const int tid = threadIdx.x;

  for (int i = tid; i < N * Gr; i += kThreads) As[i] = Ab[i];
  for (int i = tid; i < Gr * Kd; i += kThreads) Os[i] = make_float2(0.f, 0.f);

  for (int m0 = 0; m0 < M; m0 += MT) {
    const int mt = min(MT, M - m0);
    __syncthreads();  // A is staged; the previous tile's readers are done
    for (int i = tid; i < N * mt; i += kThreads) {
      const int n = i / mt, m = i - n * mt;
      Ks[n * MT + m] = Kb[(long long)n * M + m0 + m];
    }
    for (int i = tid; i < Kd * mt; i += kThreads) {
      const int k = i / mt, m = i - k * mt;
      Bs[k * MT + m] = Bb[(long long)k * M + m0 + m];
    }
    __syncthreads();
    // Ms[g, m] = sum_n conj(A[n, g]) K[n, m]
    for (int i = tid; i < Gr * mt; i += kThreads) {
      const int g = i / mt, m = i - g * mt;
      float re = 0.f, im = 0.f;
      for (int n = 0; n < N; ++n) {
        const float2 a = As[n * Gr + g];
        const float2 k = Ks[n * MT + m];
        re = fmaf(a.x, k.x, fmaf(a.y, k.y, re));
        im = fmaf(a.x, k.y, fmaf(-a.y, k.x, im));
      }
      Ms[g * MT + m] = make_float2(re, im);
    }
    __syncthreads();
    // Os[g, k] += sum_m Ms[g, m] conj(B[k, m]); each thread owns its entries
    for (int o = tid; o < Gr * Kd; o += kThreads) {
      const int g = o / Kd, k = o - g * Kd;
      float2 acc = Os[o];
      for (int m = 0; m < mt; ++m) {
        const float2 x = Ms[g * MT + m];
        const float2 y = Bs[k * MT + m];
        acc.x = fmaf(x.x, y.x, fmaf(x.y, y.y, acc.x));
        acc.y = fmaf(x.y, y.x, fmaf(-x.x, y.y, acc.y));
      }
      Os[o] = acc;
    }
  }
  float2* ob = out + b * (long long)Gr * Kd;
  for (int o = tid; o < Gr * Kd; o += kThreads) ob[o] = Os[o];  // own entries
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs at these sizes.
long long dict_correlation_smem_bytes(int N, int M, int Gr, int Kd) {
  return smem_entries(N, M, Gr, Kd) * (long long)sizeof(float2);
}

// Launches one block per realization on `stream`.  a_stride / b_stride are
// the complex entries between two realizations' A / B (0 = shared).
// Returns the cudaGetLastError() code of the launch (0 = launched).
int dict_correlation_launch(
    const void* A, long long a_stride, const void* K, const void* B, long long b_stride,
    void* out, int batch, int N, int M, int Gr, int Kd, void* stream) {
  const size_t smem = (size_t)dict_correlation_smem_bytes(N, M, Gr, Kd);
  cudaError_t err = cudaFuncSetAttribute(
      dict_correlation_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dict_correlation_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(A), a_stride, static_cast<const float2*>(K),
      static_cast<const float2*>(B), b_stride, static_cast<float2*>(out), N, M, Gr, Kd);
  return (int)cudaGetLastError();
}

}  // extern "C"
