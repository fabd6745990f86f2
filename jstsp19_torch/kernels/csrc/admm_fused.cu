// Fused tracked-SVT ADMM for Hopper (sm_90a): the whole Imax-iteration solve
// of one Monte-Carlo realization in one thread block.
//
// Replaces the Pallas TPU kernel jstsp19_tpu/kernels/admm_fused.py
// (fused_tracked_admm -> pallas_call at :361, body _fused_admm_kernel at :83)
// and computes what it computes, per realization and iteration:
//   W = X - V1/rho, zeroed whole if any entry is not finite; the Gram
//   G = W W^H and T = U^H G U; track_rounds round-robin Jacobi rounds on
//   (T, U) with the trig-free angle of the Pallas kernel; sigma = sqrt(diag T)
//   and f = max(sigma - tau_Y/rho, 0)/sigma; Y = (U f U^H) W; the X-update;
//   one exact-step steepest-descent step on r = A^H K B^H - (A^H A) v (B B^H)
//   with K = X - V2/rho - C; the re/im soft threshold; the optional
//   Algorithm-3 support mask; the C and dual updates.
//
// What bounds it: latency, in a chain.  Each realization is Imax
// sequential iterations of a dozen dependent small complex products
// (N x N by N x M and N x K by K x M at N = 32, M = 140, K = 16; about
// 0.5 M complex multiply-adds per iteration at their cheapest association,
// which bound it by operations at a fifth of the measured time), each step
// separated by a barrier,
// with the (N, M) state read from L2 and written back once per iteration.
// The per-phase split (tools/torch_admm_phases.py, PERF.md) puts about a
// third of an iteration in the tiles' loads and elementwise work and a
// quarter in the small Gr x K and N x N products.
//
// Design (second version):
// * Column tiles.  The (N, M) and (K, M) operands stream through shared
//   memory in column tiles of 32 (one column a lane); only the small
//   operands (U, A, A^H A, B B^H, S, v, A S, the N x N Gram buffers) stay
//   whole, so any M fits, and any even N whose N x N buffers fit (N <= 68
//   at Gr = 32, K = 16); at the sweeps' shapes two blocks share an SM (the
//   wrapper's plan says when).  An iteration is one pass over the
//   tiles between two N x N and Gr x K stages:
//     T = U^H G U, the rotations, f and Z = U f U^H (N x N);
//     each tile: A S B, the last iteration's C and V2 update, Y = Z W, the
//       X-update, K, this iteration's V1 update, L += K B^H, and the next
//       iteration's W and Gram G += W W^H;
//     r = A^H L - (A^H A) v (B B^H), the step, v, S and A S (Gr x K).
//   The products are reassociated where that saves work: Y = (U f U^H) W
//   needs one N x N by N x M product instead of two, and A^H (K B^H) one
//   pass over the columns instead of A^H K then (A^H K) B^H.  A S is
//   computed once per iteration and carried, where the Pallas kernel forms
//   it twice, and A S B once.  Each update runs on the values the Pallas
//   kernel gives it, at the tile pass where its inputs are at hand: C and
//   V2 need A S B of the new S, so they wait for the next iteration's pass,
//   which forms C again instead of storing it; the next W and its Gram are
//   formed where X and V1 are.  The sums run in another order than the
//   plain version's, within its tolerance.
// * Register tiles.  In the products a thread owns a 4 x 1 (or 2 x 1)
//   complex output tile: its rows come from vector loads that the warp
//   shares, its column from conflict-free scalar loads, so a shared load
//   feeds four FMAs instead of one.  In a column tile a thread owns 4 rows
//   of one column in each group of 32 rows: at the sweeps' N = 32 their
//   loads and K stay in registers; the instance for other shapes takes any
//   number of groups one at a time (column_tile).
// * The state (X, V1) and V2 stays in a per-realization global workspace
//   (L2) as a float4 and a float2 per element (24 B; 64 B of traffic an
//   element and iteration), read and written by the thread that owns the
//   element, fused into the products' epilogues.  A thread issues all of a
//   tile's loads before its stores.
// * Determinism: every output entry has one owner thread that sums in a
//   fixed order, across tiles too; the block reductions run in a fixed
//   order; there are no atomics.  Two runs are bit-equal.
// * The iteration's phases can be timed: built with -DADMM_PHASES, thread 0
//   of block 0 adds clock64() differences per phase to a device array
//   (tools/torch_admm_phases.py).  The normal build has no stamps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (jstsp19_torch/kernels/build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The block's dynamic shared memory (layout: struct Layout).
extern __shared__ __align__(16) float smem[];

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;   // rows of a column tile a thread owns, in each group of 32
constexpr int kTW = 32;    // width of a column tile: one column a lane
#ifdef ADMM_PHASES
constexpr int kPhases = 13;
__device__ long long g_phase_cycles[kPhases];
#define PHASE_START t_phase = clock64();
#define PHASE(i)                                      \
  if (blockIdx.x == 0 && threadIdx.x == 0) {          \
    const long long t_now = clock64();                \
    g_phase_cycles[i] += t_now - t_phase;             \
    t_phase = t_now;                                  \
  }
#else
#define PHASE_START
#define PHASE(i)
#endif

// The small complex operands are planar: a (re, im) pair of planes, the
// imaginary plane one plane after the real one.  The (N, M) state is a
// record per element, so that a thread moves an element's state in a few
// vector loads and stores.
struct Params {
  const float* in;      // (B, N, M, 4): subY re, subY im, 1 / (Omega + 2 rho), 0
  const float* a;       // (B, 2, N, Gr)
  const float* bmat;    // (B, 2, K, M)
  const float* ahat;    // (B, 2, Gr, Gr): (A^H A) transposed, [j][q] = (A^H A)[q][j]
  const float* bbh;     // (B, 2, K, K)
  const int32_t* rank;  // (B, Gr, K) or nullptr without the support schedule
  const float* hp;      // (B, 4): rho, tau_Y/rho, tau_S/rho, 1/rho
  const int32_t* sched; // (N-1, 2, N/2) round-robin pair table
  float* s;             // (B, 2, Gr, K)
  float* y;             // (B, N, M, 2) complex64, zero on entry
  float* work;          // (B, N, M, 4) (X, V1), then (B, N, M, 2) V2; zero on entry
  int batch, N, M, Gr, K, Imax, track_rounds, support_base, support_step;
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int imax2(int a, int b) { return a > b ? a : b; }

// Offsets (in floats) of the shared-memory buffers.  A complex buffer holds
// its real plane at the offset and its imaginary plane one plane later; a
// plane is a multiple of 4 floats, so both planes are 16-byte aligned.
// Mirrored by kernels/admm_fused.py::_layout_floats; keep the two equal.
struct Layout {
  int NP, ldn, ldt, ldb, ldw;
  int pU, pA, pH, pQ, pS, pASt, pL, pG, pE1, pE2, pBt, pWb;  // plane sizes
  int U, A, H, Q, S, v, ASt, L, G, E1, E2, Bt, Wb, rot, f, red, total;
  __host__ __device__ Layout() {}
  __host__ __device__ Layout(int N, int Gr, int K) {
    NP = round4(N);                         // rows read as 4-vectors
    ldn = N + 1;                            // N x N buffers: odd stride
    ldt = (NP / 4) % 2 == 0 ? NP + 4 : NP;  // transposed W tile (in E1): float4 stores
    ldb = kTW + 1;                          // B tile: odd stride
    ldw = kTW + 1;                          // W and K tile: odd stride
    pU = round4(N * ldn);
    pA = round4(N * Gr);
    pH = round4(Gr * Gr);
    pQ = round4(K * K);
    pS = round4(Gr * K);
    pASt = round4(K * NP);
    pL = round4(N * K);
    pG = round4(N * ldn);
    pE1 = round4(imax2(imax2(N * ldn, Gr * K), kTW * ldt));
    pE2 = round4(imax2(imax2(N * ldn, N * NP), K * Gr));
    pBt = round4(K * ldb);
    pWb = round4(N * ldw);
    int o = 0;
    U = o;   o += 2 * pU;
    A = o;   o += 2 * pA;
    H = o;   o += 2 * pH;
    Q = o;   o += 2 * pQ;
    S = o;   o += 2 * pS;
    v = o;   o += 2 * pS;
    ASt = o; o += 2 * pASt;
    L = o;   o += 2 * pL;
    G = o;   o += 2 * pG;
    E1 = o;  o += 2 * pE1;
    E2 = o;  o += 2 * pE2;
    Bt = o;  o += 2 * pBt;
    Wb = o;  o += 2 * pWb;
    rot = o; o += round4(3 * (N / 2));
    f = o;   o += round4(N);
    red = o; o += round4(2 * kWarps);
    total = o;
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Block-wide sum of two values in a fixed order.  Every thread returns the
// same totals.  Starts and ends with a barrier, so `red` may be reused.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
  for (int w = 0; w < kWarps; ++w) {
    a += red[w];
    b += red[kWarps + w];
  }
  __syncthreads();
}

// acc[r] += sum_{k < kd} x(k, i0 + r) * y(k, j), complex, planar, with x
// conjugated if CX and y if CY.  x(k, i) is at x[k*sxk + i*sxi], y(k, j) at
// y[k*syk + j*syj].  VEC: sxi == 1, x + i0 is 16-byte aligned and TI is a
// multiple of 4, so a row group is TI/4 float4 loads per plane (one address
// for a warp whose lanes share i0).  Indices past imax / jmax are clamped
// for the loads; their sums are not used.
template <int TI, bool CX, bool CY, bool VEC>
__device__ __forceinline__ void tile_mma(
    int kd, const float* __restrict__ xr, const float* __restrict__ xi, int sxk, int sxi, int imax,
    const float* __restrict__ yr, const float* __restrict__ yi, int syk, int syj, int jmax,
    int i0, int j, float (&cr)[TI], float (&ci)[TI]) {
  int io[TI];
#pragma unroll
  for (int r = 0; r < TI; ++r) io[r] = VEC ? i0 + r : min(i0 + r, imax - 1) * sxi;
  const int jo = min(j, jmax - 1) * syj;
#pragma unroll 4
  for (int k = 0; k < kd; ++k) {
    float ar[TI], ai[TI];
    const float* pr = xr + k * sxk;
    const float* pi = xi + k * sxk;
    if (VEC) {
#pragma unroll
      for (int q = 0; q < TI / 4; ++q) {
        const float4 u = *reinterpret_cast<const float4*>(pr + i0 + 4 * q);
        const float4 w = *reinterpret_cast<const float4*>(pi + i0 + 4 * q);
        ar[4 * q] = u.x; ar[4 * q + 1] = u.y; ar[4 * q + 2] = u.z; ar[4 * q + 3] = u.w;
        ai[4 * q] = w.x; ai[4 * q + 1] = w.y; ai[4 * q + 2] = w.z; ai[4 * q + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int r = 0; r < TI; ++r) {
        ar[r] = pr[io[r]];
        ai[r] = pi[io[r]];
      }
    }
    const float br = yr[k * syk + jo];
    const float bi = CY ? -yi[k * syk + jo] : yi[k * syk + jo];
#pragma unroll
    for (int r = 0; r < TI; ++r) {
      const float a_i = CX ? -ai[r] : ai[r];
      cr[r] = fmaf(ar[r], br, fmaf(-a_i, bi, cr[r]));
      ci[r] = fmaf(ar[r], bi, fmaf(a_i, br, ci[r]));
    }
  }
}

// out(i, j) = sum_k x(k, i) y(k, j) for i < I, j < J, handed to
// epi(i, j, re, im); a thread owns TI x 1 outputs on a TX-wide grid.  The
// owner of (i, j) depends only on (I, J), so an epilogue that accumulates
// into shared memory across calls sums in a fixed order.  Called by every
// thread of the block.
template <int TI, int TX, bool CX, bool CY, bool VEC, class Epi>
__device__ __forceinline__ void block_mm(
    int I, int J, int kd, const float* xr, const float* xi, int sxk, int sxi,
    const float* yr, const float* yi, int syk, int syj, Epi epi) {
  constexpr int TY = kThreads / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  for (int i0 = ty * TI; i0 < I; i0 += TY * TI) {
    for (int j = tx; j < J; j += TX) {
      float cr[TI], ci[TI];
#pragma unroll
      for (int r = 0; r < TI; ++r) cr[r] = ci[r] = 0.f;
      tile_mma<TI, CX, CY, VEC>(kd, xr, xi, sxk, sxi, I, yr, yi, syk, syj, J, i0, j, cr, ci);
#pragma unroll
      for (int r = 0; r < TI; ++r)
        if (i0 + r < I) epi(i0 + r, j, cr[r], ci[r]);
    }
  }
}

// The register tiles of an instance's products, from its compile-time
// sizes (0: known at run time only).  The N x N products: 2 x 1 tiles on an
// N-wide grid where N is fixed and its N/2 x N tiles fit the block's threads
// (N = 20: 200 threads busy, where 4 x 1 tiles on a 32-wide grid keep 100
// busy), else 4 x 1 tiles on a 32-wide grid.  The Gr x K products and
// K B^H: 2 x 1 tiles on a 32-wide grid where K is fixed at 32 (a 16 x 32
// product in one pass of all 256 threads, where a 16-wide grid takes two
// passes of 128), else on a 16-wide one.
template <int NT, int GT, int KT>
struct Tiles {
  static constexpr bool narrow = NT > 0 && NT * NT / 2 <= kThreads;
  static constexpr int nn_ti = narrow ? 2 : 4, nn_tx = narrow ? NT : 32;
  static constexpr int small_tx = KT == 32 ? 32 : 16;
};

// The N x N products: TI x 1 tiles on a TX-wide thread grid.
template <int TI, int TX, bool CX, bool CY, class Epi>
__device__ __forceinline__ void nn_mm(
    int I, int J, int kd, const float* xr, const float* xi, int sxk, int sxi,
    const float* yr, const float* yi, int syk, int syj, Epi epi) {
  block_mm<TI, TX, CX, CY, false>(I, J, kd, xr, xi, sxk, sxi, yr, yi, syk, syj, epi);
}

// The Gr x K products and K B^H: 2 x 1 tiles on a TX-wide thread grid.
template <int TX, bool CX, bool CY, class Epi>
__device__ __forceinline__ void small_mm(
    int I, int J, int kd, const float* xr, const float* xi, int sxk, int sxi,
    const float* yr, const float* yi, int syk, int syj, Epi epi) {
  block_mm<2, TX, CX, CY, false>(I, J, kd, xr, xi, sxk, sxi, yr, yi, syk, syj, epi);
}

// W = X - V1/rho, as both passes compute it (one rounding, the same bits).
__device__ __forceinline__ float w_of(float x, float v1, float inv_rho) {
  return fmaf(-v1, inv_rho, x);
}

// Everything a block needs: sizes, scalars, the shared-memory layout and
// its global state.
struct Ctx {
  int N, M, Gr, K;
  float rho, thrY, thrS, inv_rho, g;
  Layout ly;
  const float4* in;  // per element: subY re, subY im, dinv, 0
  const float* bg;   // B re, im planes (K x M)
  float2* y;         // per element: Y (written in the last iteration)
  float4* xv;        // per element: (X, V1)
  float2* v2;        // per element: V2
};

// Columns [m0, m0 + tw) of B into the B tile, row stride ldb.  Each
// chunk's loads are all issued before its stores; the caller issues its own
// state loads first, so the two sets of loads are in flight together.
__device__ __forceinline__ void load_b_tile(const Ctx& c, int m0, int tw) {
  constexpr int kChunk = 4;  // (k, j) entries a thread moves at once: K <= 32 in one chunk
  float* Btr = smem + c.ly.Bt;
  const int KM = c.K * c.M, n = c.K * kTW;
  for (int base = 0; base < n; base += kChunk * kThreads) {
    float vr[kChunk], vi[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int e = base + q * kThreads + threadIdx.x, k = e / kTW, j = e % kTW;
      const bool in = e < n && j < tw;
      vr[q] = in ? c.bg[k * c.M + m0 + j] : 0.f;
      vi[q] = in ? c.bg[KM + k * c.M + m0 + j] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int e = base + q * kThreads + threadIdx.x, k = e / kTW, j = e % kTW;
      if (e < n && j < tw) {
        Btr[k * c.ly.ldb + j] = vr[q];
        Btr[c.ly.pBt + k * c.ly.ldb + j] = vi[q];
      }
    }
  }
}

// One row group's elements of a column tile: rows n0 .. n0+3 of column
// m0 + j, as a thread holds them.
struct Rows {
  float4 xv[kRows];  // (X, V1)
  float4 iv[kRows];  // subY re, subY im, 1 / (Omega + 2 rho), 0
  float2 v2[kRows];
  bool in[kRows];    // inside the problem
};

// Loads the rows' (X, V1) and, if `all`, their V2 (after the first
// iteration) and inputs.  All loads are issued before any is used.
__device__ __forceinline__ void load_rows(const Ctx& c, Rows& s, int n0, int m0, int j, int tw, int it, bool all) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    s.in[r] = n0 + r < c.N && j < tw;
    const int e = s.in[r] ? (n0 + r) * c.M + m0 + j : 0;
    s.xv[r] = s.in[r] ? c.xv[e] : make_float4(0.f, 0.f, 0.f, 0.f);
    if (all) {
      s.v2[r] = s.in[r] && it > 0 ? c.v2[e] : make_float2(0.f, 0.f);
      s.iv[r] = s.in[r] ? c.in[e] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// The rows' W = X - V1/rho into the W tile (zero if the iteration's W was
// not finite).
__device__ __forceinline__ void store_w(const Ctx& c, const Rows& s, int n0, int j, bool ok) {
  float* Wr = smem + c.ly.Wb;
  float* Wi = Wr + c.ly.pWb;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (s.in[r]) {
      Wr[(n0 + r) * c.ly.ldw + j] = ok ? w_of(s.xv[r].x, s.xv[r].z, c.inv_rho) : 0.f;
      Wi[(n0 + r) * c.ly.ldw + j] = ok ? w_of(s.xv[r].y, s.xv[r].w, c.inv_rho) : 0.f;
    }
}

// The rows' update from A S B (b) and Y = Z W (y): the C and V2 update
// that ends the last iteration (it > 0), X = (V1 + rho Y + subY + V2 +
// rho C + rho A S B) / (Omega + 2 rho), K = X - V2/rho - C into kr, ki,
// this iteration's V1 update V1 + rho (Y - X), and the next W into the
// transposed tile Wt[j][n] unless this is the last iteration.  Stores the
// state, and Y in the last iteration.  Returns whether the next W is finite.
__device__ __forceinline__ bool update_rows(const Ctx& c, const Rows& s, int n0, int m0, int j, int tw, int it,
                                            bool last_it, const float (&br)[kRows], const float (&bi)[kRows],
                                            const float (&yr)[kRows], const float (&yi)[kRows],
                                            float (&kr)[kRows], float (&ki)[kRows]) {
  bool finite = true;
  float wn[2][kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float x[2] = {s.xv[r].x, s.xv[r].y}, v1[2] = {s.xv[r].z, s.xv[r].w}, b[2] = {br[r], bi[r]};
    const float sy[2] = {s.iv[r].x, s.iv[r].y}, y[2] = {yr[r], yi[r]};
    float vv[2] = {s.v2[r].x, s.v2[r].y}, cv[2] = {0.f, 0.f}, xn[2], v1n[2], k[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (it > 0) {
        cv[h] = c.g * (x[h] - b[h] - vv[h] * c.inv_rho);
        vv[h] = vv[h] + c.rho * (cv[h] - x[h] + b[h]);
      }
      xn[h] = (v1[h] + sy[h] + vv[h] + c.rho * cv[h] + c.rho * b[h] + c.rho * y[h]) * s.iv[r].z;
      k[h] = xn[h] + (-vv[h] * c.inv_rho - cv[h]);
      v1n[h] = v1[h] + c.rho * (y[h] - xn[h]);
      wn[h][r] = s.in[r] ? w_of(xn[h], v1n[h], c.inv_rho) : 0.f;
    }
    kr[r] = k[0];
    ki[r] = k[1];
    finite = finite && isfinite(wn[0][r]) && isfinite(wn[1][r]);
    if (s.in[r]) {
      const int e = (n0 + r) * c.M + m0 + j;
      c.xv[e] = make_float4(xn[0], xn[1], v1n[0], v1n[1]);
      c.v2[e] = make_float2(vv[0], vv[1]);
      if (last_it) c.y[e] = make_float2(y[0], y[1]);
    }
  }
  if (!last_it && j < tw) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(smem + c.ly.E1 + h * c.ly.pE1 + j * c.ly.ldt + n0) =
          make_float4(wn[h][0], wn[h][1], wn[h][2], wn[h][3]);
  }
  return finite;
}

// A S B and Y = Z W of the rows n0 .. n0+3 of the tile's column j.
__device__ __forceinline__ void asb_rows(const Ctx& c, int n0, int j, int tw, float (&br)[kRows],
                                         float (&bi)[kRows]) {
  const Layout& L = c.ly;
#pragma unroll
  for (int r = 0; r < kRows; ++r) br[r] = bi[r] = 0.f;
  tile_mma<kRows, false, false, true>(c.K, smem + L.ASt, smem + L.ASt + L.pASt, L.NP, 1, c.N,
                                      smem + L.Bt, smem + L.Bt + L.pBt, L.ldb, 1, tw, n0, j, br, bi);
}
__device__ __forceinline__ void zw_rows(const Ctx& c, int n0, int j, int tw, float (&yr)[kRows],
                                        float (&yi)[kRows]) {
  const Layout& L = c.ly;
#pragma unroll
  for (int r = 0; r < kRows; ++r) yr[r] = yi[r] = 0.f;
  tile_mma<kRows, false, false, true>(c.N, smem + L.E2, smem + L.E2 + L.pE2, L.NP, 1, c.N,
                                      smem + L.Wb, smem + L.Wb + L.pWb, L.ldw, 1, tw, n0, j, yr, yi);
}

// One column tile of an iteration.  A thread owns rows n0 .. n0+3 (n0 =
// 4 * warp + 32 g, for each group g of 32 rows) of column `lane` of the
// tile.  The tile's W = X - V1/rho goes into the W tile; then, per row,
// A S B with the S of the last iteration, Y = Z W and update_rows; K goes
// back into the W tile; then L (+)= K B^H and, unless this is the last
// iteration, the next iteration's Gram G (+)= W W^H.  C is not stored:
// each iteration forms it again from X, V2 and A S B.
//
// RG = 1 (N <= 32) keeps the group's loads and K in registers: every load
// of the tile (X, V1, V2, the inputs, the B tile) is issued at once.
// RG = 0 takes any N, one group at a time: it loads (X, V1) for W, then
// computes each group's Y = Z W into the Y buffer (global, the thread's
// own elements), and after a barrier reloads the group's state and Y and
// writes K straight into the W tile, whose reads have all ended.
//
// Called by every thread; holds the barriers between its steps and ends
// with one.  Returns whether the next W of its elements is finite.
template <int RG, int STX>
__device__ __forceinline__ bool column_tile(const Ctx& c, bool ok, int it, bool last_it, bool first, int m0,
                                            int tw, bool load_b, long long& t_phase) {
  static_assert(RG == 0 || RG == 1, "one group in registers, or any number one at a time");
  const int j = threadIdx.x & 31, w4 = kRows * (threadIdx.x >> 5);
  const Layout& L = c.ly;
  float* Wr = smem + L.Wb;
  float* Wi = Wr + L.pWb;
  bool finite = true;
  if (RG == 1) {
    Rows s;
    load_rows(c, s, w4, m0, j, tw, it, true);
    if (load_b) load_b_tile(c, m0, tw);
    store_w(c, s, w4, j, ok);
    __syncthreads();
    PHASE(3)
    float kr[kRows], ki[kRows];
    if (w4 < c.N) {
      float br[kRows], bi[kRows], yr[kRows], yi[kRows];
      asb_rows(c, w4, j, tw, br, bi);
      PHASE(4)
      zw_rows(c, w4, j, tw, yr, yi);
      PHASE(5)
      finite = update_rows(c, s, w4, m0, j, tw, it, last_it, br, bi, yr, yi, kr, ki);
    }
    __syncthreads();
    PHASE(6)
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (w4 + r < c.N && j < tw) {
        Wr[(w4 + r) * L.ldw + j] = kr[r];
        Wi[(w4 + r) * L.ldw + j] = ki[r];
      }
  } else {
    if (load_b) load_b_tile(c, m0, tw);
    for (int n0 = w4; n0 < c.N; n0 += 32) {
      Rows s;
      load_rows(c, s, n0, m0, j, tw, it, false);
      store_w(c, s, n0, j, ok);
    }
    __syncthreads();
    PHASE(3)
    PHASE(4)
    for (int n0 = w4; n0 < c.N; n0 += 32) {
      float yr[kRows], yi[kRows];
      zw_rows(c, n0, j, tw, yr, yi);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (n0 + r < c.N && j < tw) c.y[(n0 + r) * c.M + m0 + j] = make_float2(yr[r], yi[r]);
    }
    __syncthreads();
    PHASE(5)
    for (int n0 = w4; n0 < c.N; n0 += 32) {
      Rows s;
      load_rows(c, s, n0, m0, j, tw, it, true);
      float br[kRows], bi[kRows], yr[kRows], yi[kRows], kr[kRows], ki[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float2 y = s.in[r] ? c.y[(n0 + r) * c.M + m0 + j] : make_float2(0.f, 0.f);
        yr[r] = y.x;
        yi[r] = y.y;
      }
      asb_rows(c, n0, j, tw, br, bi);
      finite = update_rows(c, s, n0, m0, j, tw, it, last_it, br, bi, yr, yi, kr, ki) && finite;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (s.in[r]) {
          Wr[(n0 + r) * L.ldw + j] = kr[r];
          Wi[(n0 + r) * L.ldw + j] = ki[r];
        }
    }
    PHASE(6)
  }
  __syncthreads();
  PHASE(7)
  // L[n][k] (+)= sum_j K[n][j] conj(B[k][j])
  float* Lr = smem + L.L;
  float* Li = Lr + L.pL;
  const int Kd = c.K;
  small_mm<STX, false, true>(c.N, c.K, tw, Wr, Wi, 1, L.ldw, smem + L.Bt, smem + L.Bt + L.pBt, 1, L.ldb,
                        [&](int n, int k, float re, float im) {
                          if (first) {
                            Lr[n * Kd + k] = re;
                            Li[n * Kd + k] = im;
                          } else {
                            Lr[n * Kd + k] += re;
                            Li[n * Kd + k] += im;
                          }
                        });
  PHASE(8)
  if (!last_it) {  // the next iteration's Gram: G (+)= W W^H, W from Wt
    float* Gre = smem + L.G;
    float* Gim = Gre + L.pG;
    const int ldn = L.ldn;
    block_mm<4, 32, false, true, true>(c.N, c.N, tw, smem + L.E1, smem + L.E1 + L.pE1, L.ldt, 1, smem + L.E1,
                                       smem + L.E1 + L.pE1, L.ldt, 1, [&](int i, int k, float re, float im) {
                                         if (first) {
                                           Gre[i * ldn + k] = re;
                                           Gim[i * ldn + k] = im;
                                         } else {
                                           Gre[i * ldn + k] += re;
                                           Gim[i * ldn + k] += im;
                                         }
                                       });
  }
  __syncthreads();
  PHASE(9)
  return finite;
}

// NT, GT, KT: N, Gr and K fixed at compile time (0: taken from p at run
// time); RG: 1 for N <= 32 (one group of rows in registers), 0 for any N
// (column_tile); MINB: the blocks an SM the registers must leave room for.
// Three instances: <32, 32, 1, 0, 2> for the sweeps' N = Gr = 32, whose
// index arithmetic folds into constants (1.3-1.5x faster there than the
// same code with sizes at run time; PERF.md); <20, 16, 1, 32, 3> for
// errorVSnrf's N > M problem on the transpose (solvers/admm_transposed.py),
// three blocks an SM (80 registers, a few spills; 1.58x the generic
// instance's speed there, PERF.md); and <0, 0, 0, 0, 2> for every other
// shape.
template <int NT, int GT, int RG, int KT, int MINB>
__global__ void __launch_bounds__(kThreads, MINB) fused_admm_kernel(Params p) {
  using T = Tiles<NT, GT, KT>;
  const int N = NT ? NT : p.N, Gr = GT ? GT : p.Gr;
  const int M = p.M, K = KT ? KT : p.K;
  const int GK = Gr * K, half = N / 2, tid = threadIdx.x;
  const int b = blockIdx.x;

  Ctx c;
  c.N = N; c.M = M; c.Gr = Gr; c.K = K;
  c.ly = Layout(N, Gr, K);
  c.rho = p.hp[4 * b + 0];
  c.thrY = p.hp[4 * b + 1];
  c.thrS = p.hp[4 * b + 2];
  c.inv_rho = p.hp[4 * b + 3];
  c.g = c.rho / (c.rho + 1.0f);
  const size_t NM = (size_t)N * M;
  c.in = reinterpret_cast<const float4*>(p.in) + (size_t)b * NM;
  c.y = reinterpret_cast<float2*>(p.y) + (size_t)b * NM;
  c.xv = reinterpret_cast<float4*>(p.work) + (size_t)b * NM;
  c.v2 = reinterpret_cast<float2*>(reinterpret_cast<float4*>(p.work) + (size_t)p.batch * NM) + (size_t)b * NM;
  c.bg = p.bmat + (size_t)b * 2 * K * M;
  const Layout& Ly = c.ly;
  const int ldn = Ly.ldn, NP = Ly.NP;
  float *Ur = smem + Ly.U, *Ui = Ur + Ly.pU;
  float *Ar = smem + Ly.A, *Ai = Ar + Ly.pA;
  float *Hr = smem + Ly.H, *Hi = Hr + Ly.pH;
  float *Qr = smem + Ly.Q, *Qi = Qr + Ly.pQ;
  float *Sr = smem + Ly.S, *Si = Sr + Ly.pS;
  float *vr = smem + Ly.v, *vi = vr + Ly.pS;
  float *ASr = smem + Ly.ASt, *ASi = ASr + Ly.pASt;
  float *Lr = smem + Ly.L, *Li = Lr + Ly.pL;
  float *Gr_ = smem + Ly.G, *Gi_ = Gr_ + Ly.pG;
  float *E1r = smem + Ly.E1, *E1i = E1r + Ly.pE1;
  float *E2r = smem + Ly.E2, *E2i = E2r + Ly.pE2;
  float *rc = smem + Ly.rot, *rsr = rc + half, *rsi = rsr + half;
  float* fsh = smem + Ly.f;
  float* red = smem + Ly.red;
  const int32_t* rank = p.rank ? p.rank + (size_t)b * GK : nullptr;

  // ---- load the problem, zero the state ------------------------------------
  for (int e = tid; e < N * Gr; e += kThreads) {
    Ar[e] = p.a[(size_t)b * 2 * N * Gr + e];
    Ai[e] = p.a[(size_t)b * 2 * N * Gr + N * Gr + e];
  }
  for (int e = tid; e < Gr * Gr; e += kThreads) {
    Hr[e] = p.ahat[(size_t)b * 2 * Gr * Gr + e];
    Hi[e] = p.ahat[(size_t)b * 2 * Gr * Gr + Gr * Gr + e];
  }
  for (int e = tid; e < K * K; e += kThreads) {
    Qr[e] = p.bbh[(size_t)b * 2 * K * K + e];
    Qi[e] = p.bbh[(size_t)b * 2 * K * K + K * K + e];
  }
  for (int e = tid; e < GK; e += kThreads) Sr[e] = Si[e] = vr[e] = vi[e] = 0.f;
  for (int e = tid; e < K * NP; e += kThreads) ASr[e] = ASi[e] = 0.f;
  for (int e = tid; e < N * ldn; e += kThreads) {
    const int i = e / ldn, j = e - i * ldn;
    Ur[e] = (i == j) ? 1.f : 0.f;
    Ui[e] = Gr_[e] = Gi_[e] = 0.f;
  }
  __syncthreads();
  long long t_phase = 0;
  (void)t_phase;
  PHASE_START

  const int ntiles = (M + kTW - 1) / kTW;
  bool finite = true;  // the first W is zero, and so is its Gram
  for (int it = 0; it < p.Imax; ++it) {
    const bool ok = __syncthreads_and(finite);
    if (!ok) {  // the whole W is reset to zero, so is its Gram
      for (int e = tid; e < N * ldn; e += kThreads) Gr_[e] = Gi_[e] = 0.f;
      __syncthreads();
    }

    // ---- T = U^H (G U) -------------------------------------------------------
    nn_mm<T::nn_ti, T::nn_tx, false, false>(N, N, N, Gr_, Gi_, 1, ldn, Ur, Ui, ldn, 1, [&](int i, int j, float re, float im) {
      E2r[i * ldn + j] = re;
      E2i[i * ldn + j] = im;
    });
    __syncthreads();
    nn_mm<T::nn_ti, T::nn_tx, true, false>(N, N, N, Ur, Ui, ldn, 1, E2r, E2i, ldn, 1, [&](int i, int j, float re, float im) {
      E1r[i * ldn + j] = re;
      E1i[i * ldn + j] = im;
    });
    __syncthreads();
    PHASE(0)

    // ---- track_rounds Jacobi rounds on (T, U) --------------------------------
    // G[p,p] = G[q,q] = c, G[p,q] = -s, G[q,p] = conj(s): T <- G^H T G, U <- U G
    for (int j = 0; j < p.track_rounds; ++j) {
      const int ridx = (it * p.track_rounds + j) % (N - 1);
      const int* ps = p.sched + (size_t)ridx * 2 * half;
      const int* qs = ps + half;
      if (tid < half) {  // the trig-free angle of the Pallas kernel
        const int pp = ps[tid], qq = qs[tid];
        const float app = E1r[pp * ldn + pp], aqq = E1r[qq * ldn + qq];
        const float apr = E1r[pp * ldn + qq], api = E1i[pp * ldn + qq];
        const float mag = sqrtf(apr * apr + api * api);
        const bool pos = mag > 0.f;
        const float phr = pos ? apr / mag : 1.f;
        const float phi = pos ? api / mag : 0.f;
        const float d = app - aqq;
        const float u = 2.f * mag / (fabsf(d) + sqrtf(d * d + 4.f * mag * mag) + 1e-30f);
        const float w = 1.f / sqrtf(1.f + u * u);
        const float cs = d >= 0.f ? w : u * w;
        const float st = d >= 0.f ? u * w : w;
        rc[tid] = cs;
        rsr[tid] = st * phr;
        rsi[tid] = st * phi;
      }
      __syncthreads();
      for (int e = tid; e < half * N; e += kThreads) {
        const int k = e / N, col = e - k * N;
        const int pp = ps[k], qq = qs[k];
        const float cs = rc[k], sr = rsr[k], si = rsi[k];
        // rows of T: T[p] <- c T[p] + s T[q], T[q] <- c T[q] - conj(s) T[p]
        float xr = E1r[pp * ldn + col], xi = E1i[pp * ldn + col];
        float yr = E1r[qq * ldn + col], yi = E1i[qq * ldn + col];
        E1r[pp * ldn + col] = cs * xr + sr * yr - si * yi;
        E1i[pp * ldn + col] = cs * xi + sr * yi + si * yr;
        E1r[qq * ldn + col] = cs * yr - (sr * xr + si * xi);
        E1i[qq * ldn + col] = cs * yi - (sr * xi - si * xr);
        // columns of U: U[:,p] <- c U[:,p] + conj(s) U[:,q], U[:,q] <- c U[:,q] - s U[:,p]
        xr = Ur[col * ldn + pp]; xi = Ui[col * ldn + pp];
        yr = Ur[col * ldn + qq]; yi = Ui[col * ldn + qq];
        Ur[col * ldn + pp] = cs * xr + (sr * yr + si * yi);
        Ui[col * ldn + pp] = cs * xi + (sr * yi - si * yr);
        Ur[col * ldn + qq] = cs * yr - (sr * xr - si * xi);
        Ui[col * ldn + qq] = cs * yi - (sr * xi + si * xr);
      }
      __syncthreads();
      for (int e = tid; e < half * N; e += kThreads) {
        const int k = e / N, row = e - k * N;
        const int pp = ps[k], qq = qs[k];
        const float cs = rc[k], sr = rsr[k], si = rsi[k];
        const float xr = E1r[row * ldn + pp], xi = E1i[row * ldn + pp];
        const float yr = E1r[row * ldn + qq], yi = E1i[row * ldn + qq];
        E1r[row * ldn + pp] = cs * xr + (sr * yr + si * yi);
        E1i[row * ldn + pp] = cs * xi + (sr * yi - si * yr);
        E1r[row * ldn + qq] = cs * yr - (sr * xr - si * xi);
        E1i[row * ldn + qq] = cs * yi - (sr * xi + si * xr);
      }
      __syncthreads();
    }
    PHASE(1)

    // ---- f from sigma = sqrt(diag T); Z = U f U^H, stored as Zt[k][n] = Z[n][k]
    if (tid < N) {
      const float sig = sqrtf(fmaxf(E1r[tid * ldn + tid], 0.f));
      fsh[tid] = sig > 0.f ? fmaxf(sig - c.thrY, 0.f) / sig : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < N * N; e += kThreads) {
      const int i = e / N, k = e - i * N;
      E1r[i * ldn + k] = Ur[i * ldn + k] * fsh[k];
      E1i[i * ldn + k] = Ui[i * ldn + k] * fsh[k];
    }
    __syncthreads();
    nn_mm<T::nn_ti, T::nn_tx, false, true>(N, N, N, E1r, E1i, 1, ldn, Ur, Ui, 1, ldn, [&](int i, int j, float re, float im) {
      E2r[j * NP + i] = re;
      E2i[j * NP + i] = im;
    });
    __syncthreads();
    PHASE(2)

    // ---- the column tiles: C, V2, Y = Z W, X, K, V1, L = K B^H, the next G ---
    finite = true;
    for (int t = 0; t < ntiles; ++t) {
      const int m0 = t * kTW, tw = min(kTW, M - m0);
      finite = column_tile<RG, T::small_tx>(c, ok, it, it == p.Imax - 1, t == 0, m0, tw, ntiles > 1 || it == 0, t_phase) &&
               finite;
    }

    // ---- r = A^H L - (A^H A) v (B B^H) ---------------------------------------
    // r in E1 as [q][k]; (A^H A) x in E2 transposed, [k][q]
    small_mm<T::small_tx, true, false>(Gr, K, N, Ar, Ai, Gr, 1, Lr, Li, K, 1, [&](int q, int k, float re, float im) {
      E1r[q * K + k] = re;
      E1i[q * K + k] = im;
    });
    small_mm<T::small_tx, false, false>(Gr, K, Gr, Hr, Hi, Gr, 1, vr, vi, K, 1, [&](int q, int k, float re, float im) {
      E2r[k * Gr + q] = re;
      E2i[k * Gr + q] = im;
    });
    __syncthreads();
    small_mm<T::small_tx, false, false>(Gr, K, K, E2r, E2i, Gr, 1, Qr, Qi, K, 1, [&](int q, int k, float re, float im) {
      E1r[q * K + k] -= re;
      E1i[q * K + k] -= im;
    });
    __syncthreads();
    PHASE(10)

    // ---- exact step: num = |r|^2, den = Re<r, (A^H A) r (B B^H)> ---------------
    small_mm<T::small_tx, false, false>(Gr, K, Gr, Hr, Hi, Gr, 1, E1r, E1i, K, 1, [&](int q, int k, float re, float im) {
      E2r[k * Gr + q] = re;
      E2i[k * Gr + q] = im;
    });
    __syncthreads();
    float num = 0.f, den = 0.f;
    small_mm<T::small_tx, false, false>(Gr, K, K, E2r, E2i, Gr, 1, Qr, Qi, K, 1, [&](int q, int k, float re, float im) {
      const float rr = E1r[q * K + k], ri = E1i[q * K + k];
      num = fmaf(rr, rr, fmaf(ri, ri, num));
      den = fmaf(rr, re, fmaf(ri, im, den));
    });
    block_sum2(num, den, red);
    const float alpha = den > 0.f ? num / den : 0.f;
    PHASE(11)

    // ---- v += alpha r; S = soft(v); support mask; A S --------------------------
    const int nnz = min(p.support_base + p.support_step * (it + 1), GK);
    for (int e = tid; e < GK; e += kThreads) {
      const float xr = vr[e] + alpha * E1r[e];
      const float xi = vi[e] + alpha * E1i[e];
      vr[e] = xr;
      vi[e] = xi;
      float sr = copysignf(fmaxf(fabsf(xr) - c.thrS, 0.f), xr);
      float si = copysignf(fmaxf(fabsf(xi) - c.thrS, 0.f), xi);
      if (rank && rank[e] >= nnz) sr = si = 0.f;
      Sr[e] = sr;
      Si[e] = si;
    }
    __syncthreads();
    small_mm<T::small_tx, false, false>(N, K, Gr, Ar, Ai, 1, Gr, Sr, Si, K, 1, [&](int n, int k, float re, float im) {
      ASr[k * NP + n] = re;
      ASi[k * NP + n] = im;
    });
    __syncthreads();
    PHASE(12)
  }

  for (int e = tid; e < GK; e += kThreads) {
    p.s[(size_t)b * 2 * GK + e] = Sr[e];
    p.s[(size_t)b * 2 * GK + GK + e] = Si[e];
  }
}

// A kernel instance and its template arguments, as written.
struct Instance {
  void (*kern)(Params);
  const char* args;
};
#define INSTANCE(...) Instance{fused_admm_kernel<__VA_ARGS__>, #__VA_ARGS__}

// The instance that runs these sizes.
Instance instance(int N, int Gr, int K) {
  if (N == 32 && Gr == 32) return INSTANCE(32, 32, 1, 0, 2);
  if (N == 20 && Gr == 16 && K == 32) return INSTANCE(20, 16, 1, 32, 3);
  return INSTANCE(0, 0, 0, 0, 2);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for these sizes.
long long fused_tracked_admm_smem_bytes(int N, int Gr, int K) {
  return (long long)Layout(N, Gr, K).total * (long long)sizeof(float);
}

// The template arguments of the instance that runs N, Gr and K, as
// "NT, GT, RG, KT, MINB".
const char* fused_tracked_admm_instance(int N, int Gr, int K) { return instance(N, Gr, K).args; }

// Registers a thread uses (cudaFuncGetAttributes) in the instance that
// runs N, Gr and K, or a negative CUDA error code.
int fused_tracked_admm_registers(int N, int Gr, int K) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, instance(N, Gr, K).kern);
  return err == cudaSuccess ? a.numRegs : -(int)err;
}

// Blocks of the instance that runs N, Gr and K that one SM of the current
// device holds at once with smem_bytes of dynamic shared memory each
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor: its registers, its
// shared memory and the launch bounds together), or a negative CUDA error
// code.
int fused_tracked_admm_blocks_per_sm(int N, int Gr, int K, int smem_bytes) {
  void (*kern)(Params) = instance(N, Gr, K).kern;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads, smem_bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Phase names of the per-phase split, comma-separated, in stamp order (for
// the RG = 1 instances; in the generic one phase 4 is empty and phase 5 is
// Y = Z W of all rows).
const char* fused_tracked_admm_phase_names() {
  return "T = U^H G U,Jacobi rounds,f and Z = U f U^H,tile: loads and W,tile: A S B (thread 0),"
         "tile: Y = Z W (thread 0),tile: C V2 X V1 K next W,tile: K tile,tile: L += K B^H (thread 0),"
         "tile: next G += W W^H,r = A^H L - Hv BB^H,exact step,v S and A S";
}

// Cycles of block 0 spent in each phase since the last reset (a build with
// -DADMM_PHASES only; otherwise returns -1).  reset != 0 zeroes them.
int fused_tracked_admm_phase_cycles(long long* out, int reset) {
#ifdef ADMM_PHASES
  if (reset) {
    long long zero[kPhases] = {};
    return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(long long) * kPhases);
#else
  (void)out;
  (void)reset;
  return -1;
#endif
}

// Launches one block per realization on `stream` with the dynamic shared
// memory of the wrapper's plan (at least the layout's; more keeps a second
// block off the SM).  Returns the cudaGetLastError() code of the launch
// (0 = launched).
int fused_tracked_admm_launch(
    const void* in, const void* a, const void* bmat, const void* ahat, const void* bbh,
    const void* rank, const void* hp, const void* sched, void* s, void* y, void* work,
    int batch, int N, int M, int Gr, int K, int Imax, int track_rounds,
    int support_base, int support_step, int smem_bytes, void* stream) {
  if (N % 2 || N > M) return (int)cudaErrorInvalidValue;
  Params p;
  p.in = static_cast<const float*>(in);
  p.a = static_cast<const float*>(a);
  p.bmat = static_cast<const float*>(bmat);
  p.ahat = static_cast<const float*>(ahat);
  p.bbh = static_cast<const float*>(bbh);
  p.rank = static_cast<const int32_t*>(rank);
  p.hp = static_cast<const float*>(hp);
  p.sched = static_cast<const int32_t*>(sched);
  p.s = static_cast<float*>(s);
  p.y = static_cast<float*>(y);
  p.work = static_cast<float*>(work);
  p.batch = batch;
  p.N = N;
  p.M = M;
  p.Gr = Gr;
  p.K = K;
  p.Imax = Imax;
  p.track_rounds = track_rounds;
  p.support_base = support_base;
  p.support_step = support_step;

  const size_t smem_size = (size_t)imax2(Layout(N, Gr, K).total * (int)sizeof(float), smem_bytes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  void (*kern)(Params) = instance(N, Gr, K).kern;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_size);
  if (err != cudaSuccess) return (int)err;
  kern<<<batch, kThreads, smem_size, st>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
