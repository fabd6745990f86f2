// Sparse-output dense product: selected entries of Z = Aᴴ·X.
//
// Native counterpart of the reference MEX
// `MPbased_solvers/BiGAMP/sparseMult2.c` (which computes the observed
// (row, col) entries of a masked product for BiGAMP).  Fresh
// implementation, complex-valued, C ABI for ctypes
// (jstsp19_torch/utils/native.py).  A (row, col) pair outside Z gives 0.
//
//   A: (n, r) column-major complex (interleaved re/im doubles)
//   X: (n, c) column-major complex
//   rows[k], cols[k]: the k-th requested entry of Z = Aᴴ X  (0-based)
//   out[k]: interleaved re/im result, length 2*m

#include <cstdint>

extern "C" {

void sparse_conj_mult(const double* A, const double* X, const int64_t* rows,
                      const int64_t* cols, double* out, int64_t n, int64_t r,
                      int64_t c, int64_t m) {
  for (int64_t k = 0; k < m; ++k) {
    const int64_t rj = rows[k];
    const int64_t cj = cols[k];
    if (rj < 0 || rj >= r || cj < 0 || cj >= c) {
      out[2 * k] = 0.0;
      out[2 * k + 1] = 0.0;
      continue;
    }
    const double* a = A + 2 * rj * n;  // column rj of A
    const double* x = X + 2 * cj * n;  // column cj of X
    double acc_re = 0.0, acc_im = 0.0;
    for (int64_t i = 0; i < n; ++i) {
      const double ar = a[2 * i], ai = a[2 * i + 1];
      const double xr = x[2 * i], xi = x[2 * i + 1];
      // conj(a) * x
      acc_re += ar * xr + ai * xi;
      acc_im += ar * xi - ai * xr;
    }
    out[2 * k] = acc_re;
    out[2 * k + 1] = acc_im;
  }
}

}  // extern "C"
