// Orthonormal fast Walsh-Hadamard transform along the last axis, for Hopper
// (sm_90a): log2(n) natural-order radix-2 butterfly stages (a+b, a-b at
// distance h = 1, 2, ..., n/2), then a division by sqrt(n).  The sequency
// order is folded into the memory traffic: the forward transform stores
// natural index j at position inv(j) (= gathers out[k] = nat[perm(k)]); the
// inverse transform loads its input through inv (z[j] = y[inv(j)]), with
//   perm(k) = bitrev(gray(k)),   inv(j) = gray^-1(bitrev(j))
// computed in registers (kernels/wht.py::_sequency_perm).  float32 rows, or
// complex64 read as interleaved float2 so one pass transforms Re and Im.
//
// Replaces the Pallas TPU kernel jstsp19_tpu/kernels/wht.py (pallas_fwht ->
// pallas_call at :46, body _kernel at :19), which holds the whole (rows, n)
// array in VMEM.  In the port it is every FWHTOp.mv / rmv: two launches per
// GAMP iteration on the partial-Hadamard path.
//
// Design.  Up to 128 KB a row (n <= 2^15 float32, 2^14 complex64) one block
// holds a row in shared memory and runs every stage there: one read and one
// write of device memory.  Longer rows use the separable split
// H_n = H_{n1} (x) H_{n2} with n2 = 4096: a chunk pass runs the stages
// h < n2 on each contiguous chunk of n2 entries, and a column pass runs the
// stages h >= n2 on tiles of n1 x w entries (w contiguous columns at stride
// n2, n1*w = 4096).  Both passes apply the same additions in the same order
// as the plain version, so the result is bit-equal to it.  Rows up to
// n = 2^24 (n1 <= 4096); the wrapper raises above.
//
// What bounds it: device memory.  It reads each entry once and writes it
// once per pass, with log2(n) additions per entry.  At the slice's
// (32, 65536) float32 the function must move 2 x 8.39 MB = 16.8 MB, which at
// 3.35 TB/s takes 5.0 us; its 32 x 65536 x 16 = 33.6 M additions take
// 0.5 us at 67 TFLOP/s.  The split costs a second read and write (two
// passes), and the sequency scatter of the forward column pass writes 4-byte
// entries to scattered addresses.  Making it fast (16-byte loads, register
// radix-4/8 stages, one pass through a cluster's distributed shared memory)
// is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (jstsp19_torch/kernels/build.py).  The division
// by sqrt(n) stays a division (nvcc's default -prec-div=true), as in the
// plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRowBytes = 128 * 1024;  // one block holds a row up to this size
constexpr int kChunkLog2 = 12;          // n2 = 4096 for the split
constexpr int kTile = 4096;             // entries of a column-pass tile

enum Mode { kNatural = 0, kSequency = 1, kInverseSequency = 2 };

__device__ inline float add(float a, float b) { return a + b; }
__device__ inline float sub(float a, float b) { return a - b; }
__device__ inline float scaled(float a, float s) { return a / s; }
__device__ inline float2 add(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ inline float2 sub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ inline float2 scaled(float2 a, float s) { return make_float2(a.x / s, a.y / s); }

// The sequency position of natural index j: inv(j) = gray^-1(bitrev(j)).
__device__ inline unsigned inv_perm(unsigned j, int log2n) {
  unsigned b = log2n ? (__brev(j) >> (32 - log2n)) : 0u;
  b ^= b >> 1;
  b ^= b >> 2;
  b ^= b >> 4;
  b ^= b >> 8;
  b ^= b >> 16;
  return b;
}

// The natural index that sequency position k holds: perm(k) = bitrev(gray(k)).
__device__ inline unsigned perm(unsigned k, int log2n) {
  const unsigned g = k ^ (k >> 1);
  return log2n ? (__brev(g) >> (32 - log2n)) : 0u;
}

// Stages h = h_begin, 2 h_begin, ... < h_end over `len` shared entries
// (pairs (i, i+h) inside blocks of 2h).
template <typename T>
__device__ void butterflies(T* s, int len, int h_begin, int h_end) {
  for (int h = h_begin; h < h_end; h <<= 1) {
    for (int t = threadIdx.x; t < len / 2; t += blockDim.x) {
      const int i = (t / h) * 2 * h + (t % h);
      const T a = s[i], b = s[i + h];
      s[i] = add(a, b);
      s[i + h] = sub(a, b);
    }
    __syncthreads();
  }
}

// One block per row: load (through inv for the inverse sequency transform),
// every stage in shared memory, store scaled (gathering through perm for the
// forward sequency transform).
template <typename T>
__global__ void __launch_bounds__(kThreads) fwht_row_kernel(
    const T* __restrict__ x, T* __restrict__ out, int log2n, int mode, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int n = 1 << log2n;
  const T* xr = x + (long long)blockIdx.x * n;
  T* orow = out + (long long)blockIdx.x * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    s[j] = xr[mode == kInverseSequency ? inv_perm(j, log2n) : j];
  __syncthreads();
  butterflies(s, n, 1, n);
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    orow[k] = scaled(s[mode == kSequency ? perm(k, log2n) : k], scale);
}

// Split, pass 1: block (row, chunk) runs the stages h < n2 on one chunk of
// n2 contiguous entries, unscaled, into scratch.
template <typename T>
__global__ void __launch_bounds__(kThreads) fwht_chunk_kernel(
    const T* __restrict__ x, T* __restrict__ scratch, int log2n, int mode) {
  __shared__ T s[1 << kChunkLog2];
  const int n2 = 1 << kChunkLog2;
  const int chunks = 1 << (log2n - kChunkLog2);
  const long long row = blockIdx.x / chunks;
  const int c = blockIdx.x % chunks;
  const T* xr = x + (row << log2n);
  const int base = c * n2;
  for (int j = threadIdx.x; j < n2; j += blockDim.x)
    s[j] = xr[mode == kInverseSequency ? inv_perm(base + j, log2n) : base + j];
  __syncthreads();
  butterflies(s, n2, 1, n2);
  T* sr = scratch + (row << log2n) + base;
  for (int j = threadIdx.x; j < n2; j += blockDim.x) sr[j] = s[j];
}

// Split, pass 2: block (row, column tile) loads n1 x w entries (w contiguous
// columns at stride n2), runs the stages h >= n2 (h/n2 = 1, ..., n1/2 along
// the tile's rows), and stores scaled (scattering to inv(j) for the forward
// sequency transform).
template <typename T>
__global__ void __launch_bounds__(kThreads) fwht_column_kernel(
    const T* __restrict__ scratch, T* __restrict__ out, int log2n, int mode, float scale) {
  __shared__ T s[kTile];
  const int n2 = 1 << kChunkLog2;
  const int n1 = 1 << (log2n - kChunkLog2);
  const int w = kTile / n1;
  const int tiles = n2 / w;
  const long long row = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) * w;
  const T* sr = scratch + (row << log2n);
  for (int e = threadIdx.x; e < kTile; e += blockDim.x) {
    const int i1 = e / w, i2 = e % w;
    s[i2 * n1 + i1] = sr[(long long)i1 * n2 + c0 + i2];  // column i2 contiguous in shared
  }
  __syncthreads();
  for (int h = 1; h < n1; h <<= 1) {
    for (int t = threadIdx.x; t < kTile / 2; t += blockDim.x) {
      const int col = t / (n1 / 2), p = t % (n1 / 2);
      const int i = col * n1 + (p / h) * 2 * h + (p % h);
      const T a = s[i], b = s[i + h];
      s[i] = add(a, b);
      s[i + h] = sub(a, b);
    }
    __syncthreads();
  }
  T* orow = out + (row << log2n);
  for (int e = threadIdx.x; e < kTile; e += blockDim.x) {
    const int i1 = e / w, i2 = e % w;
    const unsigned j = (unsigned)i1 * n2 + c0 + i2;
    orow[mode == kSequency ? inv_perm(j, log2n) : j] = scaled(s[i2 * n1 + i1], scale);
  }
}

template <typename T>
int launch(const void* x, void* out, void* scratch, long long rows, int log2n, int mode,
           float scale, cudaStream_t stream) {
  const long long n = 1LL << log2n;
  const long long row_bytes = n * (long long)sizeof(T);
  if (row_bytes <= kRowBytes) {
    static bool attr_set = false;
    if (!attr_set) {
      cudaError_t e = cudaFuncSetAttribute(fwht_row_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kRowBytes);
      if (e != cudaSuccess) return (int)e;
      attr_set = true;
    }
    const int threads = n / 2 < kThreads ? (n / 2 < 32 ? 32 : (int)(n / 2)) : kThreads;
    fwht_row_kernel<T><<<(unsigned)rows, threads, (size_t)row_bytes, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), log2n, mode, scale);
    return (int)cudaGetLastError();
  }
  const long long chunks = n >> kChunkLog2;
  fwht_chunk_kernel<T><<<(unsigned)(rows * chunks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(scratch), log2n, mode);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (1LL << kChunkLog2) / (kTile / chunks);
  fwht_column_kernel<T><<<(unsigned)(rows * tiles), kThreads, 0, stream>>>(
      static_cast<const T*>(scratch), static_cast<T*>(out), log2n, mode, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Entries of a row up to which one block holds the row (elem_bytes = 4 for
// float32, 8 for complex64); longer rows take the two-pass split and need
// a scratch buffer of the input's size.
long long fwht_row_limit(int elem_bytes) { return kRowBytes / elem_bytes; }

// Largest log2(n) the kernel supports.
int fwht_max_log2n() { return kChunkLog2 + 12; }

// Transforms `rows` contiguous rows of n = 2^log2n entries of x into out on
// `stream`: is_complex = 0 for float32, 1 for complex64 (interleaved);
// mode 0 natural, 1 sequency, 2 inverse sequency; scale = sqrt(n).  scratch
// (the size of x) is used only above fwht_row_limit.  Returns the
// cudaGetLastError() code of the launches (0 = launched).
int fwht_launch(const void* x, void* out, void* scratch, long long rows, int log2n,
                int is_complex, int mode, float scale, void* stream) {
  if (log2n < 1 || log2n > fwht_max_log2n() || rows < 1 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_complex ? launch<float2>(x, out, scratch, rows, log2n, mode, scale, s)
                 : launch<float>(x, out, scratch, rows, log2n, mode, scale, s);
}

}  // extern "C"
