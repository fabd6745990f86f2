// Fused tracked-SVT ADMM for Hopper (sm_90a): the whole Imax-iteration solve
// of one Monte-Carlo realization in one thread block.
//
// Replaces the Pallas TPU kernel jstsp19_tpu/kernels/admm_fused.py
// (fused_tracked_admm -> pallas_call at :361, body _fused_admm_kernel at :83)
// and computes what solvers/admm.py::proposed_admm(svt_method='tracked')
// computes, per realization:
//   W = X - V1/rho (all-or-nothing NaN reset); P = U^H W; track_rounds
//   round-robin Jacobi rounds on (U, P) as pair gathers; sigma = row norms
//   of P; Y = U (f o P); X = (V1 + rho Y + subY + V2 + rho C + rho A S B)
//   * dinv; one exact-step steepest-descent step on
//   r = A^H K B^H - (A^H A) v (B B^H); re/im soft threshold; optional
//   Algorithm-3 support mask; C and dual updates.
//
// What bounds it: not device memory.  Each realization is a chain of
// Imax sequential iterations, each a dozen dependent small complex
// products (32x32 by 32x140 at the canonical shape), so the time is the
// latency of that chain: about 0.7 M complex multiply-adds per iteration
// on operands that fit in one SM's shared memory.
//
// First design: one block of kThreads threads per realization, the
// iteration loop inside the block, phases separated by __syncthreads.
// All small operands (U, P, the K buffer, A^H K, A, B, A^H A, B B^H, S, v
// and temporaries) live in dynamic shared memory; the five (N, M) state
// planes X, V1, V2, C (workspace) and Y (output) stay in a per-realization
// global buffer, which at B = 256 (~60 MB) the 50 MB L2 mostly holds.  Every
// product is a plain fp32 FMA loop (no tensor cores), every reduction runs
// in a fixed order without atomics, so a run is deterministic.  Tensor
// cores, clusters and TMA are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (jstsp19_torch/kernels/build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Params {
  const float* suby_re;
  const float* suby_im;
  const float* dinv;    // (B, N, M) 1 / (Omega + 2 rho)
  const float* a_re;
  const float* a_im;    // (B, N, Gr)
  const float* b_re;
  const float* b_im;    // (B, K, M)
  const float* aha_re;
  const float* aha_im;  // (B, Gr, Gr)
  const float* bbh_re;
  const float* bbh_im;  // (B, K, K)
  const int32_t* rank;  // (B, Gr, K) or nullptr without the support schedule
  const float* hp;      // (B, 4): rho, tau_Y/rho, tau_S/rho, 1/rho
  const int32_t* sched; // (N-1, 2, N/2) round-robin pair table
  float* s_re;
  float* s_im;          // (B, Gr, K)
  float* y_re;
  float* y_im;          // (B, N, M)
  float* work;          // (B, 8, N, M): X, V1, V2, C as re/im planes
  int N, M, Gr, K, Imax, track_rounds, support_base, support_step;
};

// Offsets (in floats) of the shared-memory buffers; a complex buffer of n
// entries holds its real plane at the offset and its imaginary plane n later.
struct Layout {
  int U, P, W, AK, A, B, H, Q, S, v, AS, R, T, rank, rot, f, red, total;
  __host__ __device__ Layout(int N, int M, int Gr, int K) {
    int o = 0;
    U = o;    o += 2 * N * N;
    P = o;    o += 2 * N * M;
    W = o;    o += 2 * N * M;
    AK = o;   o += 2 * Gr * M;
    A = o;    o += 2 * N * Gr;
    B = o;    o += 2 * K * M;
    H = o;    o += 2 * Gr * Gr;
    Q = o;    o += 2 * K * K;
    S = o;    o += 2 * Gr * K;
    v = o;    o += 2 * Gr * K;
    AS = o;   o += 2 * N * K;
    R = o;    o += 2 * Gr * K;
    T = o;    o += 2 * Gr * K;
    rank = o; o += Gr * K;
    rot = o;  o += 3 * (N / 2);
    f = o;    o += N;
    red = o;  o += 2 * kWarps;
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

__global__ void __launch_bounds__(kThreads, 1) fused_admm_kernel(Params p) {
  extern __shared__ float sm[];
  const int N = p.N, M = p.M, Gr = p.Gr, K = p.K;
  const int NM = N * M, GK = Gr * K, half = N / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const Layout L(N, M, Gr, K);

  float *Ur = sm + L.U, *Ui = Ur + N * N;
  float *Pr = sm + L.P, *Pi = Pr + NM;
  float *Wr = sm + L.W, *Wi = Wr + NM;          // W, then K = X - V2/rho - C
  float *AKr = sm + L.AK, *AKi = AKr + Gr * M;  // A^H K
  float *Ar = sm + L.A, *Ai = Ar + N * Gr;
  float *Br = sm + L.B, *Bi = Br + K * M;
  float *Hr = sm + L.H, *Hi = Hr + Gr * Gr;     // A^H A
  float *Qr = sm + L.Q, *Qi = Qr + K * K;       // B B^H
  float *Sr = sm + L.S, *Si = Sr + GK;
  float *vr = sm + L.v, *vi = vr + GK;
  float *ASr = sm + L.AS, *ASi = ASr + N * K;   // A S
  float *Rr = sm + L.R, *Ri = Rr + GK;          // R1, then r
  float *Tr = sm + L.T, *Ti = Tr + GK;          // (A^H A) v, then (A^H A) r
  int* rk = reinterpret_cast<int*>(sm + L.rank);
  float *rc = sm + L.rot, *rsr = rc + half, *rsi = rsr + half;
  float* fsh = sm + L.f;
  float* red = sm + L.red;

  const float rho = p.hp[4 * b + 0];
  const float thrY = p.hp[4 * b + 1];
  const float thrS = p.hp[4 * b + 2];
  const float inv_rho = p.hp[4 * b + 3];
  const float g = rho / (rho + 1.0f);
  const bool use_support = p.rank != nullptr;

  const size_t off_nm = (size_t)b * NM;
  const float *sYr = p.suby_re + off_nm, *sYi = p.suby_im + off_nm;
  const float* dinv = p.dinv + off_nm;
  float *Yr = p.y_re + off_nm, *Yi = p.y_im + off_nm;
  float* wk = p.work + (size_t)b * 8 * NM;
  float *Xr = wk, *Xi = wk + NM, *V1r = wk + 2 * NM, *V1i = wk + 3 * NM;
  float *V2r = wk + 4 * NM, *V2i = wk + 5 * NM, *Cr = wk + 6 * NM, *Ci = wk + 7 * NM;

  // ---- load the problem, zero the state ------------------------------------
  for (int e = tid; e < N * Gr; e += kThreads) {
    Ar[e] = p.a_re[(size_t)b * N * Gr + e];
    Ai[e] = p.a_im[(size_t)b * N * Gr + e];
  }
  for (int e = tid; e < K * M; e += kThreads) {
    Br[e] = p.b_re[(size_t)b * K * M + e];
    Bi[e] = p.b_im[(size_t)b * K * M + e];
  }
  for (int e = tid; e < Gr * Gr; e += kThreads) {
    Hr[e] = p.aha_re[(size_t)b * Gr * Gr + e];
    Hi[e] = p.aha_im[(size_t)b * Gr * Gr + e];
  }
  for (int e = tid; e < K * K; e += kThreads) {
    Qr[e] = p.bbh_re[(size_t)b * K * K + e];
    Qi[e] = p.bbh_im[(size_t)b * K * K + e];
  }
  for (int e = tid; e < GK; e += kThreads) {
    Sr[e] = Si[e] = vr[e] = vi[e] = 0.f;
    rk[e] = use_support ? p.rank[(size_t)b * GK + e] : 0;
  }
  for (int e = tid; e < N * N; e += kThreads) {
    Ur[e] = (e / N == e % N) ? 1.f : 0.f;
    Ui[e] = 0.f;
  }
  for (int e = tid; e < NM; e += kThreads) {
    Xr[e] = Xi[e] = V1r[e] = V1i[e] = V2r[e] = V2i[e] = Cr[e] = Ci[e] = 0.f;
    Yr[e] = Yi[e] = 0.f;
  }
  __syncthreads();

  for (int it = 0; it < p.Imax; ++it) {
    // ---- 1. W = X - V1/rho, zeroed whole if any entry is not finite --------
    bool finite = true;
    for (int e = tid; e < NM; e += kThreads) {
      const float wr = Xr[e] - V1r[e] * inv_rho;
      const float wi = Xi[e] - V1i[e] * inv_rho;
      Wr[e] = wr;
      Wi[e] = wi;
      finite = finite && isfinite(wr) && isfinite(wi);
    }
    if (!__syncthreads_and(finite)) {
      for (int e = tid; e < NM; e += kThreads) Wr[e] = Wi[e] = 0.f;
      __syncthreads();
    }

    // ---- 2. P = U^H W ------------------------------------------------------
    for (int e = tid; e < NM; e += kThreads) {
      const int a = e / M, m = e - a * M;
      float pr = 0.f, pi = 0.f;
      for (int n = 0; n < N; ++n) {
        const float ur = Ur[n * N + a], ui = Ui[n * N + a];
        const float wr = Wr[n * M + m], wi = Wi[n * M + m];
        pr = fmaf(ur, wr, fmaf(ui, wi, pr));
        pi = fmaf(ur, wi, fmaf(-ui, wr, pi));
      }
      Pr[e] = pr;
      Pi[e] = pi;
    }
    __syncthreads();

    // ---- 3. track_rounds Jacobi rounds on (U, P) ---------------------------
    for (int j = 0; j < p.track_rounds; ++j) {
      const int ridx = (it * p.track_rounds + j) % (N - 1);
      const int* ps = p.sched + (size_t)ridx * 2 * half;
      const int* qs = ps + half;
      // pair sums of the rotated Gram P P^H: one warp per pair
      for (int k = warp; k < half; k += kWarps) {
        const int pp = ps[k], qq = qs[k];
        float app = 0.f, aqq = 0.f, apr = 0.f, api = 0.f;
        for (int m = lane; m < M; m += 32) {
          const float xr = Pr[pp * M + m], xi = Pi[pp * M + m];
          const float yr = Pr[qq * M + m], yi = Pi[qq * M + m];
          app = fmaf(xr, xr, fmaf(xi, xi, app));
          aqq = fmaf(yr, yr, fmaf(yi, yi, aqq));
          apr = fmaf(xr, yr, fmaf(xi, yi, apr));  // P_p conj(P_q)
          api = fmaf(xi, yr, fmaf(-xr, yi, api));
        }
        app = warp_sum(app);
        aqq = warp_sum(aqq);
        apr = warp_sum(apr);
        api = warp_sum(api);
        if (lane == 0) {
          const float mag = sqrtf(apr * apr + api * api);
          const float phr = mag > 0.f ? apr / mag : 1.f;
          const float phi = mag > 0.f ? api / mag : 0.f;
          const float theta = 0.5f * atan2f(2.f * mag, app - aqq);
          float st, ct;
          sincosf(theta, &st, &ct);
          rc[k] = ct;
          rsr[k] = st * phr;
          rsi[k] = st * phi;
        }
      }
      __syncthreads();
      // G[p,p] = G[q,q] = c, G[p,q] = -s, G[q,p] = conj(s):
      // P <- G^H P (rows p, q), U <- U G (columns p, q)
      for (int e = tid; e < half * M; e += kThreads) {
        const int k = e / M, m = e - k * M;
        const int pp = ps[k], qq = qs[k];
        const float c = rc[k], sr = rsr[k], si = rsi[k];
        const float xr = Pr[pp * M + m], xi = Pi[pp * M + m];
        const float yr = Pr[qq * M + m], yi = Pi[qq * M + m];
        Pr[pp * M + m] = c * xr + sr * yr - si * yi;  // c x + s y
        Pi[pp * M + m] = c * xi + sr * yi + si * yr;
        Pr[qq * M + m] = c * yr - (sr * xr + si * xi);  // c y - conj(s) x
        Pi[qq * M + m] = c * yi - (sr * xi - si * xr);
      }
      for (int e = tid; e < half * N; e += kThreads) {
        const int k = e / N, n = e - k * N;
        const int pp = ps[k], qq = qs[k];
        const float c = rc[k], sr = rsr[k], si = rsi[k];
        const float xr = Ur[n * N + pp], xi = Ui[n * N + pp];
        const float yr = Ur[n * N + qq], yi = Ui[n * N + qq];
        Ur[n * N + pp] = c * xr + (sr * yr + si * yi);  // c x + conj(s) y
        Ui[n * N + pp] = c * xi + (sr * yi - si * yr);
        Ur[n * N + qq] = c * yr - (sr * xr - si * xi);  // c y - s x
        Ui[n * N + qq] = c * yi - (sr * xi + si * xr);
      }
      __syncthreads();
    }

    // ---- 4. shrink factors from P's row norms; A S with the old S ----------
    for (int a = warp; a < N; a += kWarps) {
      float s2 = 0.f;
      for (int m = lane; m < M; m += 32) {
        const float xr = Pr[a * M + m], xi = Pi[a * M + m];
        s2 = fmaf(xr, xr, fmaf(xi, xi, s2));
      }
      s2 = warp_sum(s2);
      if (lane == 0) {
        const float sig = sqrtf(s2);
        fsh[a] = sig > 0.f ? fmaxf(sig - thrY, 0.f) / sig : 0.f;
      }
    }
    for (int e = tid; e < N * K; e += kThreads) {
      const int n = e / K, k = e - n * K;
      float xr = 0.f, xi = 0.f;
      for (int q = 0; q < Gr; ++q) {
        const float ar = Ar[n * Gr + q], ai = Ai[n * Gr + q];
        const float sr = Sr[q * K + k], si = Si[q * K + k];
        xr = fmaf(ar, sr, fmaf(-ai, si, xr));
        xi = fmaf(ar, si, fmaf(ai, sr, xi));
      }
      ASr[e] = xr;
      ASi[e] = xi;
    }
    __syncthreads();

    // ---- 5. Y = U (f o P); X-update; K = X - V2/rho - C --------------------
    for (int e = tid; e < NM; e += kThreads) {
      const int n = e / M, m = e - n * M;
      float yr = 0.f, yi = 0.f;
      for (int a = 0; a < N; ++a) {
        const float fa = fsh[a];
        const float ur = Ur[n * N + a] * fa, ui = Ui[n * N + a] * fa;
        const float xr = Pr[a * M + m], xi = Pi[a * M + m];
        yr = fmaf(ur, xr, fmaf(-ui, xi, yr));
        yi = fmaf(ur, xi, fmaf(ui, xr, yi));
      }
      float br = 0.f, bi = 0.f;  // (A S B)[n, m]
      for (int k = 0; k < K; ++k) {
        const float xr = ASr[n * K + k], xi = ASi[n * K + k];
        const float zr = Br[k * M + m], zi = Bi[k * M + m];
        br = fmaf(xr, zr, fmaf(-xi, zi, br));
        bi = fmaf(xr, zi, fmaf(xi, zr, bi));
      }
      const float v1r = V1r[e], v1i = V1i[e], v2r = V2r[e], v2i = V2i[e];
      const float cr = Cr[e], ci = Ci[e];
      const float xr = (v1r + rho * yr + sYr[e] + v2r + rho * cr + rho * br) * dinv[e];
      const float xi = (v1i + rho * yi + sYi[e] + v2i + rho * ci + rho * bi) * dinv[e];
      Yr[e] = yr;
      Yi[e] = yi;
      Xr[e] = xr;
      Xi[e] = xi;
      Wr[e] = xr - v2r * inv_rho - cr;
      Wi[e] = xi - v2i * inv_rho - ci;
    }
    __syncthreads();

    // ---- 6. A^H K ----------------------------------------------------------
    for (int e = tid; e < Gr * M; e += kThreads) {
      const int q = e / M, m = e - q * M;
      float xr = 0.f, xi = 0.f;
      for (int n = 0; n < N; ++n) {
        const float ar = Ar[n * Gr + q], ai = Ai[n * Gr + q];
        const float kr = Wr[n * M + m], ki = Wi[n * M + m];
        xr = fmaf(ar, kr, fmaf(ai, ki, xr));  // conj(a) k
        xi = fmaf(ar, ki, fmaf(-ai, kr, xi));
      }
      AKr[e] = xr;
      AKi[e] = xi;
    }
    __syncthreads();

    // ---- 7. R1 = (A^H K) B^H; T = (A^H A) v --------------------------------
    for (int e = tid; e < GK; e += kThreads) {
      const int q = e / K, k = e - q * K;
      float xr = 0.f, xi = 0.f;
      for (int m = 0; m < M; ++m) {
        const float ar = AKr[q * M + m], ai = AKi[q * M + m];
        const float zr = Br[k * M + m], zi = Bi[k * M + m];
        xr = fmaf(ar, zr, fmaf(ai, zi, xr));  // a conj(z)
        xi = fmaf(ai, zr, fmaf(-ar, zi, xi));
      }
      Rr[e] = xr;
      Ri[e] = xi;
      float tr = 0.f, ti = 0.f;
      for (int j = 0; j < Gr; ++j) {
        const float hr = Hr[q * Gr + j], hi = Hi[q * Gr + j];
        const float zr = vr[j * K + k], zi = vi[j * K + k];
        tr = fmaf(hr, zr, fmaf(-hi, zi, tr));
        ti = fmaf(hr, zi, fmaf(hi, zr, ti));
      }
      Tr[e] = tr;
      Ti[e] = ti;
    }
    __syncthreads();

    // ---- 8. r = R1 - T (B B^H) ---------------------------------------------
    for (int e = tid; e < GK; e += kThreads) {
      const int q = e / K, k = e - q * K;
      float xr = 0.f, xi = 0.f;
      for (int j = 0; j < K; ++j) {
        const float tr = Tr[q * K + j], ti = Ti[q * K + j];
        const float zr = Qr[j * K + k], zi = Qi[j * K + k];
        xr = fmaf(tr, zr, fmaf(-ti, zi, xr));
        xi = fmaf(tr, zi, fmaf(ti, zr, xi));
      }
      Rr[e] -= xr;
      Ri[e] -= xi;
    }
    __syncthreads();

    // ---- 9. T = (A^H A) r --------------------------------------------------
    for (int e = tid; e < GK; e += kThreads) {
      const int q = e / K, k = e - q * K;
      float xr = 0.f, xi = 0.f;
      for (int j = 0; j < Gr; ++j) {
        const float hr = Hr[q * Gr + j], hi = Hi[q * Gr + j];
        const float zr = Rr[j * K + k], zi = Ri[j * K + k];
        xr = fmaf(hr, zr, fmaf(-hi, zi, xr));
        xi = fmaf(hr, zi, fmaf(hi, zr, xi));
      }
      Tr[e] = xr;
      Ti[e] = xi;
    }
    __syncthreads();

    // ---- 10. exact step: num = |r|^2, den = Re<r, (A^H A) r (B B^H)> -------
    float num = 0.f, den = 0.f;
    for (int e = tid; e < GK; e += kThreads) {
      const int q = e / K, k = e - q * K;
      float xr = 0.f, xi = 0.f;
      for (int j = 0; j < K; ++j) {
        const float tr = Tr[q * K + j], ti = Ti[q * K + j];
        const float zr = Qr[j * K + k], zi = Qi[j * K + k];
        xr = fmaf(tr, zr, fmaf(-ti, zi, xr));
        xi = fmaf(tr, zi, fmaf(ti, zr, xi));
      }
      const float rr = Rr[e], ri = Ri[e];
      num = fmaf(rr, rr, fmaf(ri, ri, num));
      den = fmaf(rr, xr, fmaf(ri, xi, den));
    }
    block_sum2(num, den, red);
    const float alpha = den > 0.f ? num / den : 0.f;

    // ---- 11. v += alpha r; S = soft(v); support mask -----------------------
    const int nnz = min(p.support_base + p.support_step * (it + 1), GK);
    for (int e = tid; e < GK; e += kThreads) {
      const float xr = vr[e] + alpha * Rr[e];
      const float xi = vi[e] + alpha * Ri[e];
      vr[e] = xr;
      vi[e] = xi;
      float sr = copysignf(fmaxf(fabsf(xr) - thrS, 0.f), xr);
      float si = copysignf(fmaxf(fabsf(xi) - thrS, 0.f), xi);
      if (use_support && rk[e] >= nnz) sr = si = 0.f;
      Sr[e] = sr;
      Si[e] = si;
    }
    __syncthreads();

    // ---- 12. A S with the new S ----------------------------------------------
    for (int e = tid; e < N * K; e += kThreads) {
      const int n = e / K, k = e - n * K;
      float xr = 0.f, xi = 0.f;
      for (int q = 0; q < Gr; ++q) {
        const float ar = Ar[n * Gr + q], ai = Ai[n * Gr + q];
        const float sr = Sr[q * K + k], si = Si[q * K + k];
        xr = fmaf(ar, sr, fmaf(-ai, si, xr));
        xi = fmaf(ar, si, fmaf(ai, sr, xi));
      }
      ASr[e] = xr;
      ASi[e] = xi;
    }
    __syncthreads();

    // ---- 13. C and dual updates ----------------------------------------------
    for (int e = tid; e < NM; e += kThreads) {
      const int n = e / M, m = e - n * M;
      float br = 0.f, bi = 0.f;
      for (int k = 0; k < K; ++k) {
        const float xr = ASr[n * K + k], xi = ASi[n * K + k];
        const float zr = Br[k * M + m], zi = Bi[k * M + m];
        br = fmaf(xr, zr, fmaf(-xi, zi, br));
        bi = fmaf(xr, zi, fmaf(xi, zr, bi));
      }
      const float xr = Xr[e], xi = Xi[e];
      const float v2r = V2r[e], v2i = V2i[e];
      const float cr = g * (xr - br - v2r * inv_rho);
      const float ci = g * (xi - bi - v2i * inv_rho);
      Cr[e] = cr;
      Ci[e] = ci;
      V1r[e] += rho * (Yr[e] - xr);
      V1i[e] += rho * (Yi[e] - xi);
      V2r[e] = v2r + rho * (cr - xr + br);
      V2i[e] = v2i + rho * (ci - xi + bi);
    }
    __syncthreads();
  }

  for (int e = tid; e < GK; e += kThreads) {
    p.s_re[(size_t)b * GK + e] = Sr[e];
    p.s_im[(size_t)b * GK + e] = Si[e];
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs at these sizes.
long long fused_tracked_admm_smem_bytes(int N, int M, int Gr, int K) {
  return (long long)Layout(N, M, Gr, K).total * (long long)sizeof(float);
}

// Launches one block per realization on `stream`.  Returns the
// cudaGetLastError() code of the launch (0 = launched).
int fused_tracked_admm_launch(
    const void* suby_re, const void* suby_im, const void* dinv,
    const void* a_re, const void* a_im, const void* b_re, const void* b_im,
    const void* aha_re, const void* aha_im, const void* bbh_re, const void* bbh_im,
    const void* rank, const void* hp, const void* sched,
    void* s_re, void* s_im, void* y_re, void* y_im, void* work,
    int batch, int N, int M, int Gr, int K, int Imax, int track_rounds,
    int support_base, int support_step, void* stream) {
  Params p;
  p.suby_re = static_cast<const float*>(suby_re);
  p.suby_im = static_cast<const float*>(suby_im);
  p.dinv = static_cast<const float*>(dinv);
  p.a_re = static_cast<const float*>(a_re);
  p.a_im = static_cast<const float*>(a_im);
  p.b_re = static_cast<const float*>(b_re);
  p.b_im = static_cast<const float*>(b_im);
  p.aha_re = static_cast<const float*>(aha_re);
  p.aha_im = static_cast<const float*>(aha_im);
  p.bbh_re = static_cast<const float*>(bbh_re);
  p.bbh_im = static_cast<const float*>(bbh_im);
  p.rank = static_cast<const int32_t*>(rank);
  p.hp = static_cast<const float*>(hp);
  p.sched = static_cast<const int32_t*>(sched);
  p.s_re = static_cast<float*>(s_re);
  p.s_im = static_cast<float*>(s_im);
  p.y_re = static_cast<float*>(y_re);
  p.y_im = static_cast<float*>(y_im);
  p.work = static_cast<float*>(work);
  p.N = N;
  p.M = M;
  p.Gr = Gr;
  p.K = K;
  p.Imax = Imax;
  p.track_rounds = track_rounds;
  p.support_base = support_base;
  p.support_step = support_step;

  const size_t smem = (size_t)Layout(N, M, Gr, K).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_admm_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
