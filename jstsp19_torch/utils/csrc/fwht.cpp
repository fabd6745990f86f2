// Fast Walsh–Hadamard transform, sequency (Walsh) order, orthonormal
// scaling — the native-host counterpart of the reference MEX
// `MPbased_solvers/main/fastWHtrans.cpp` (same transform contract: length
// padded to the next power of two, output scaled by 1/sqrt(N), sequency
// ordering per Beauchamp).  Fresh implementation: natural-order butterfly
// network + closed-form sequency permutation
// (natural_index = bit_reverse(binary_to_gray(k))).
//
// C ABI for ctypes (jstsp19_torch/utils/native.py); operates in place on a
// caller-provided buffer of length n.  n must be a power of two: any other
// length is returned unchanged, unscaled, and the Python wrapper does not
// pad (the reference MEX pads to the next power of two).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// In-place natural-order unnormalized butterflies.
static void fwht_butterflies(double* x, int64_t n) {
  for (int64_t h = 1; h < n; h <<= 1) {
    for (int64_t i = 0; i < n; i += h << 1) {
      for (int64_t j = i; j < i + h; ++j) {
        const double a = x[j];
        const double b = x[j + h];
        x[j] = a + b;
        x[j + h] = a - b;
      }
    }
  }
}

static int64_t bitrev(int64_t v, int bits) {
  int64_t r = 0;
  for (int i = 0; i < bits; ++i) {
    r = (r << 1) | (v & 1);
    v >>= 1;
  }
  return r;
}

// Orthonormal FWHT of x[0..n), sequency order. scratch must hold n doubles.
void fwht_sequency(double* x, double* scratch, int64_t n) {
  if (n <= 0 || (n & (n - 1))) return;  // power-of-two only
  int bits = 0;
  while ((int64_t{1} << bits) < n) ++bits;
  fwht_butterflies(x, n);
  const double scale = 1.0 / std::sqrt(static_cast<double>(n));
  for (int64_t k = 0; k < n; ++k) {
    const int64_t gray = k ^ (k >> 1);
    scratch[k] = x[bitrev(gray, bits)] * scale;
  }
  std::memcpy(x, scratch, sizeof(double) * static_cast<size_t>(n));
}

// Orthonormal FWHT, natural (Hadamard) order.
void fwht_natural(double* x, int64_t n) {
  if (n <= 0 || (n & (n - 1))) return;
  fwht_butterflies(x, n);
  const double scale = 1.0 / std::sqrt(static_cast<double>(n));
  for (int64_t k = 0; k < n; ++k) x[k] *= scale;
}

}  // extern "C"
