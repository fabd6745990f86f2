// Batched dictionary correlation out_b = A_b^H (K_b B_b^H) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel jstsp19_tpu/kernels/dictionary.py
// (dict_correlation -> pallas_call at :79, body _kernel at :33).  In the
// port it is the sparse-code correlation A^H K B^H of the unfused
// solvers/admm.py::proposed_admm on every iteration and the adjoint
// KronDictOp.rmv of VAMP.  Shapes: K (batch, N, M); A (N, Gr) shared or
// (batch, N, Gr); B (Kd, M) shared or (batch, Kd, M); out (batch, Gr, Kd);
// all complex64 as torch stores it, interleaved (re, im) float pairs.
//
// What bounds it: device memory.  In the cheaper association, P = K B^H
// (N*M*Kd complex multiply-adds) and then A^H P (Gr*N*Kd), every shape the
// port launches needs less time for its float32 operations than for its
// bytes at 3.35 TB/s; at the port's batch of 256 a call moves 5-17 MB, a
// few microseconds, so the latency of the first loads and of the two
// dependent products is what the design works on.
//
// Design (the plan, kernels/dictionary.py::plan, picks rpb, tk and mt from
// the shapes; the library recomputes the shared memory from them):
// - A block of 256 threads serves rpb realizations, 256/rpb threads each,
//   arranged tn x tk.  Thread (a, c) owns a 2x2 register tile of P, rows
//   a and a+tn, columns c and c+tk, and the same tile of out: one
//   shared-memory load feeds two products.
// - K's and B's columns stream through shared memory in tiles of mt
//   columns, two stages deep, with cp.async (16-byte copies where M is even
//   and the operands start on 16-byte boundaries, else 8-byte copies): tile
//   t+1 is in flight while tile t is multiplied.  A is copied once, in its
//   own group, and waited for only before the second product, so its load
//   overlaps the K B^H stream.  Copies go row by row, a power of two of
//   lanes to a row: no integer division per element.
// - Rows are padded to mt + 2 entries (mt % 4 == 0), an odd number of
//   16-byte units, so that the 16-byte reads of a quarter-warp's different
//   rows fall in different banks.
// - P accumulates in registers over m in increasing order, goes to shared
//   memory, and out = A^H P contracts over n in increasing order: a run is
//   deterministic.
// - Shapes beyond one pass (N or Gr above 2 tn, Kd above 2 tk) loop over
//   passes of rows and columns, streaming the tiles again for each.
// One launch a call.  Plain fp32 FMAs; no tensor cores (the port pins full
// fp32, and no launched shape is bound by its operations).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (jstsp19_torch/kernels/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 232448;  // what one block may use on Hopper

// Complex entries of one realization's part of shared memory: two stages of
// (K tile, B tile), then A (N, Gr), then P (N, kc).
struct Layout {
  int tn, nc, kc, pitch, stage, a_off, p_off, total;
};

__host__ __device__ inline Layout layout(int N, int Gr, int rpb, int tk, int mt) {
  Layout L;
  L.tn = kThreads / rpb / tk;
  L.nc = 2 * L.tn;  // rows of K (of P) a pass
  L.kc = 2 * tk;    // rows of B (columns of P and out) a pass
  L.pitch = mt + 2;
  L.stage = (L.nc + L.kc) * L.pitch;
  L.a_off = 2 * L.stage;
  L.p_off = L.a_off + ((N * Gr + 1) & ~1);  // even: every part 16-byte aligned
  L.total = L.p_off + N * L.kc;
  return L;
}

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ inline void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ inline void cp8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ inline void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int kPending>
__device__ inline void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
// Waits until at most `pending` (0, 1 or 2) of this thread's newest groups
// are still in flight.
__device__ inline void cp_wait_upto(int pending) {
  if (pending <= 0) cp_wait<0>();
  else if (pending == 1) cp_wait<1>();
  else cp_wait<2>();
}

// Copies `rows` rows of `cols` complex entries, row q from src + q*src_pitch
// to dst + q*dst_pitch; every thread of the block takes part, 2^lshift lanes
// to a row (the fewest that cover it, at most 32).
__device__ inline void copy_rows(float2* dst, int dst_pitch, const float2* src, long long src_pitch,
                                 int rows, int cols, bool vec) {
  const int units = vec ? cols >> 1 : cols;
  const int lshift = units <= 1 ? 0 : min(5, 32 - __clz(units - 1));
  const int lanes = 1 << lshift;
  const int lane = threadIdx.x & (lanes - 1);
  for (int q = threadIdx.x >> lshift; q < rows; q += kThreads >> lshift) {
    float2* d = dst + q * dst_pitch;
    const float2* s = src + q * src_pitch;
    if (vec) {
      for (int u = lane; u < units; u += lanes) cp16(d + 2 * u, s + 2 * u);
    } else {
      for (int u = lane; u < units; u += lanes) cp8(d + u, s + u);
    }
  }
}

// acc += x * conj(y)
__device__ inline void mac_conj_y(float2& acc, float xr, float xi, float yr, float yi) {
  acc.x = fmaf(xr, yr, fmaf(xi, yi, acc.x));
  acc.y = fmaf(xi, yr, fmaf(-xr, yi, acc.y));
}
// acc += conj(x) * y
__device__ inline void mac_conj_x(float2& acc, float2 x, float2 y) {
  acc.x = fmaf(x.x, y.x, fmaf(x.y, y.y, acc.x));
  acc.y = fmaf(x.x, y.y, fmaf(-x.y, y.x, acc.y));
}

// The position of a step in the stream: column pass k0, row pass n0, tile m0.
struct Step {
  int k0, n0, m0;
  // Moves to the next step; returns true where a column pass ends.
  __device__ bool next(int N, int M, const Layout& L, int mt) {
    m0 += mt;
    if (m0 < M) return false;
    m0 = 0;
    n0 += L.nc;
    if (n0 < N) return false;
    n0 = 0;
    k0 += L.kc;
    return true;
  }
};

__global__ void __launch_bounds__(kThreads) dict_correlation_kernel(
    const float2* __restrict__ A, long long a_stride, const float2* __restrict__ K,
    const float2* __restrict__ B, long long b_stride, float2* __restrict__ out,
    int batch, int N, int M, int Gr, int Kd, int rpb, int tk, int mt) {
  extern __shared__ __align__(16) float2 smem[];
  const Layout L = layout(N, Gr, rpb, tk, mt);
  const int per = kThreads / rpb;
  const int r = threadIdx.x / per, t = threadIdx.x - r * per;  // once a thread
  const int a = t / tk, c = t - a * tk;
  const int first = blockIdx.x * rpb;
  const int here = min(rpb, batch - first);  // realizations this block holds
  const bool mine = r < here;
  const long long b = (long long)first + r;
  const bool vec = !(M & 1) && !((reinterpret_cast<uintptr_t>(K) | reinterpret_cast<uintptr_t>(B)) & 15);
  const bool vec_a = !(Gr & 1) && !(reinterpret_cast<uintptr_t>(A) & 15);
  float2* part = smem + r * L.total;

  auto fetch = [&](const Step& s, int stage) {
    const int cols = min(mt, M - s.m0);
    const int nk = min(L.nc, N - s.n0), nb = min(L.kc, Kd - s.k0);
    for (int q = 0; q < here; ++q) {
      float2* dst = smem + q * L.total + stage * L.stage;
      const long long bq = (long long)first + q;
      copy_rows(dst, L.pitch, K + (bq * N + s.n0) * M + s.m0, M, nk, cols, vec);
      copy_rows(dst + L.nc * L.pitch, L.pitch, B + bq * b_stride + (long long)s.k0 * M + s.m0, M, nb,
                cols, vec);
    }
    cp_commit();
  };

  const int steps = ((Kd + L.kc - 1) / L.kc) * max(1, (N + L.nc - 1) / L.nc) * max(1, (M + mt - 1) / mt);
  Step load{0, 0, 0}, cur{0, 0, 0};
  fetch(load, 0);
  load.next(N, M, L, mt);
  for (int q = 0; q < here; ++q)
    copy_rows(smem + q * L.total + L.a_off, Gr, A + ((long long)first + q) * a_stride, Gr, N, Gr, vec_a);
  cp_commit();

  float2 acc[2][2];
  for (int s = 0; s < steps; ++s) {
    const bool more = s + 1 < steps;
    if (more) {
      fetch(load, (s + 1) & 1);
      load.next(N, M, L, mt);
    }
    cp_wait_upto((s == 0) + more);  // this step's tile (and A, behind it, at s = 0) may stay pending
    __syncthreads();

    if (cur.m0 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) acc[i][j] = make_float2(0.f, 0.f);
    }
    // P tile: rows cur.n0 + a (+ tn), columns cur.k0 + c (+ tk), over this tile's columns
    const int cols = min(mt, M - cur.m0);
    if (mine && a < N - cur.n0) {
      const float2* kp0 = part + (s & 1) * L.stage + a * L.pitch;
      const float2* kp1 = kp0 + L.tn * L.pitch;
      const float2* bp0 = part + (s & 1) * L.stage + (L.nc + c) * L.pitch;
      const float2* bp1 = bp0 + tk * L.pitch;
      int m = 0;
      for (; m + 1 < cols; m += 2) {
        const float4 x0 = *reinterpret_cast<const float4*>(kp0 + m);
        const float4 x1 = *reinterpret_cast<const float4*>(kp1 + m);
        const float4 y0 = *reinterpret_cast<const float4*>(bp0 + m);
        const float4 y1 = *reinterpret_cast<const float4*>(bp1 + m);
        mac_conj_y(acc[0][0], x0.x, x0.y, y0.x, y0.y);
        mac_conj_y(acc[0][1], x0.x, x0.y, y1.x, y1.y);
        mac_conj_y(acc[1][0], x1.x, x1.y, y0.x, y0.y);
        mac_conj_y(acc[1][1], x1.x, x1.y, y1.x, y1.y);
        mac_conj_y(acc[0][0], x0.z, x0.w, y0.z, y0.w);
        mac_conj_y(acc[0][1], x0.z, x0.w, y1.z, y1.w);
        mac_conj_y(acc[1][0], x1.z, x1.w, y0.z, y0.w);
        mac_conj_y(acc[1][1], x1.z, x1.w, y1.z, y1.w);
      }
      if (m < cols) {
        const float2 x0 = kp0[m], x1 = kp1[m], y0 = bp0[m], y1 = bp1[m];
        mac_conj_y(acc[0][0], x0.x, x0.y, y0.x, y0.y);
        mac_conj_y(acc[0][1], x0.x, x0.y, y1.x, y1.y);
        mac_conj_y(acc[1][0], x1.x, x1.y, y0.x, y0.y);
        mac_conj_y(acc[1][1], x1.x, x1.y, y1.x, y1.y);
      }
    }
    const int k0 = cur.k0;
    if (cur.m0 + mt >= M && mine) {  // the row pass ends: P's rows to shared memory
      float2* P = part + L.p_off;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = cur.n0 + a + i * L.tn;
        if (n < N) {
          P[n * L.kc + c] = acc[i][0];
          P[n * L.kc + c + tk] = acc[i][1];
        }
      }
    }
    if (cur.next(N, M, L, mt)) {  // the column pass ends: out = A^H P on its columns
      cp_wait_upto(more ? 1 : 0);  // A
      __syncthreads();
      if (mine) {
        const float2* As = part + L.a_off;
        const float2* P = part + L.p_off;
        float2* ob = out + b * Gr * Kd;
        for (int g0 = 0; g0 + a < Gr; g0 += L.nc) {
          const int g_0 = g0 + a, g_1 = min(g0 + a + L.tn, Gr - 1);
          float2 o[2][2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) o[i][j] = make_float2(0.f, 0.f);
          for (int n = 0; n < N; ++n) {
            const float2 x0 = As[n * Gr + g_0], x1 = As[n * Gr + g_1];
            const float2 p0 = P[n * L.kc + c], p1 = P[n * L.kc + c + tk];
            mac_conj_x(o[0][0], x0, p0);
            mac_conj_x(o[0][1], x0, p1);
            mac_conj_x(o[1][0], x1, p0);
            mac_conj_x(o[1][1], x1, p1);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int g = g0 + a + i * L.tn;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int k = k0 + c + j * tk;
              if (g < Gr && k < Kd) ob[g * Kd + k] = o[i][j];
            }
          }
        }
      }
    }
    __syncthreads();  // this stage's tile and P are free for the next writes
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs under the plan (rpb, tk, mt);
// kernels/dictionary.py::plan computes the same.
long long dict_correlation_smem_bytes(int N, int Gr, int rpb, int tk, int mt) {
  return (long long)rpb * layout(N, Gr, rpb, tk, mt).total * (long long)sizeof(float2);
}

// Lets the kernel take up to the 232,448 bytes of shared memory a block may
// use.  Called once, when the library is loaded.  Returns the CUDA error code.
int dict_correlation_init() {
  return (int)cudaFuncSetAttribute(dict_correlation_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kMaxSmemBytes);
}

// What a launch needs besides the pointers: kernels/dictionary.py::_Params
// holds the same fields, one instance per shape, kept for the process.
struct DictParams {
  long long a_stride, b_stride;  // complex entries between two realizations' A / B (0 = shared)
  int batch, N, M, Gr, Kd, rpb, tk, mt;
};

// Launches ceil(batch / rpb) blocks on `stream`.  A plan the kernel cannot
// run (rpb or tk not a power of two, more threads than a block, mt not a
// positive multiple of 4, too much shared memory) returns
// cudaErrorInvalidValue without launching; else the cudaGetLastError() code
// of the launch (0 = launched).
int dict_correlation_launch(const void* A, const void* K, const void* B, void* out, const DictParams* p,
                            void* stream) {
  const bool pow2 = p->rpb > 0 && !(p->rpb & (p->rpb - 1)) && p->tk > 0 && !(p->tk & (p->tk - 1));
  if (!pow2 || p->rpb * p->tk > kThreads || p->mt < 4 || (p->mt & 3) || p->batch < 1)
    return (int)cudaErrorInvalidValue;
  const long long smem = dict_correlation_smem_bytes(p->N, p->Gr, p->rpb, p->tk, p->mt);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  dict_correlation_kernel<<<(p->batch + p->rpb - 1) / p->rpb, kThreads, (size_t)smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(A), p->a_stride, static_cast<const float2*>(K),
      static_cast<const float2*>(B), p->b_stride, static_cast<float2*>(out), p->batch, p->N, p->M, p->Gr,
      p->Kd, p->rpb, p->tk, p->mt);
  return (int)cudaGetLastError();
}

}  // extern "C"
