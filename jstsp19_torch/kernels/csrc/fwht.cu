// Orthonormal fast Walsh-Hadamard transform along the last axis, for Hopper
// (sm_90a): log2(n) natural-order radix-2 butterfly stages (a+b, a-b at
// distance h = 1, 2, ..., n/2), then a division by sqrt(n).  The sequency
// order is folded into the memory traffic: the forward transform gathers
// out[k] = nat[perm(k)]; the inverse transform puts input entry k at natural
// position perm(k) (z[j] = y[inv(j)], inv = perm^-1), with
//   perm(k) = bitrev(gray(k)),   inv(j) = gray^-1(bitrev(j))
// computed in registers (kernels/wht.py::_sequency_perm).  float32 rows, or
// complex64 read as interleaved float2 so one pass transforms Re and Im.
//
// Replaces the Pallas TPU kernel jstsp19_tpu/kernels/wht.py (pallas_fwht ->
// pallas_call at :46, body _kernel at :19), which holds the whole (rows, n)
// array in VMEM.  In the port it is every FWHTOp.mv / rmv: two launches per
// GAMP iteration on the partial-Hadamard path.
//
// What bounds it: device memory.  The function reads each entry once and
// writes it once, with log2(n) additions per entry: at the GAMP slice's
// (32, 65536) float32, 2 x 8.39 MB = 16.8 MB, 5.0 us at 3.35 TB/s, against
// 33.6 M additions, 0.5 us at 67 TFLOP/s.  So the design keeps every stage
// out of device memory, and moves rows in 16-byte vectors, contiguously.
//
// Design: three paths, by the bytes of a row (kernels/wht.py::plan_fwht
// picks one and hands it to fwht_launch).
//  - row (<= 128 KB: n <= 2^15 float32, 2^14 complex64): one block holds the
//    row in shared memory.  Each thread holds R = 128 B of entries (32
//    float32, 16 complex64) in registers and runs log2(R) stages there
//    between exchanges through shared memory: pass p takes the entries whose
//    index differs only in bits [p log2(R), (p+1) log2(R)), pass 0 as
//    16-byte vectors.  The passes are unrolled and the shared memory is
//    XOR-swizzled (swz) linearly, so a slot's place is its unit's base XOR a
//    constant: no run-time / or %, and one logic operation an entry.  The
//    swizzle keeps 16-byte vectors whole and sends the lanes of a warp to
//    distinct banks in every pass.
//  - cluster (<= 1 MB: n <= 2^18 float32, 2^17 complex64): a thread-block
//    cluster of C = 8 blocks (kClusterSize) holds the row, block r its
//    contiguous r-th 1/C, in one pass.  The stages h < n/C run in each block as in the row
//    path; after cluster.sync() the log2(C) top stages read the partner
//    blocks' entries through distributed shared memory, a 16-byte vector at
//    a time in natural order (scalar or scattered accesses to a partner
//    cost a transaction each), and natural-order results go straight to
//    device memory.  The sequency permutation never touches device memory
//    as scattered entries: the top stages' values at one offset across the
//    C blocks (with H offsets that differ in their top bits: Tile) are the
//    outputs of one contiguous run of sequency positions.  The forward
//    transform writes each run into the shared memory of the block that
//    owns that part of the output, which then stores its part contiguously;
//    the inverse transform reads such runs (a warp's within 1 KB) and writes
//    each (u, c) vector into the cluster's shared memory at its natural
//    position.  So device memory sees one contiguous read and one
//    contiguous write of each entry, in 16-byte vectors.  C = 8, the
//    largest portable size, is the one size whose parts stay within 128 KB
//    for every row up to 1 MB, and at (32, 65536) float32 it spreads the 32
//    rows over all the SMs: 256 blocks of 32 KB and 128 threads, in one wave
//    (the card holds 62 such clusters).  -DFWHT_CLUSTER=2 or 4 builds a
//    variant for tools/torch_fwht_phases.py's comparison of cluster sizes.
//  - split (above, up to n = 2^24): the separable split
//    H_n = H_{n1} (x) H_{n2}, n2 = 4096: a chunk pass runs the stages
//    h < n2 on each contiguous chunk, a column pass the stages h >= n2 on
//    tiles of n1 x w entries (w contiguous columns at stride n2, n1 w =
//    4096), kept in shared memory at a padded stride n1 + 1 so that the
//    transposes hit distinct banks.  Two reads and two writes of each entry.
// Every path applies the same additions to each entry in the same order as
// the plain version, so the result is bit-equal to it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (jstsp19_torch/kernels/build.py).  The division
// by sqrt(n) stays a division (nvcc's default -prec-div=true), as in the
// plain version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kRowBytes = 128 * 1024;  // a block holds up to this much of a row
constexpr int kRegBytes = 128;         // entries a thread holds in registers
constexpr int kMaxSmem = 232448;       // dynamic shared memory a block may use
constexpr int kChunkLog2 = 12;         // n2 = 4096 for the split
constexpr int kTile = 4096;            // entries of a column-pass tile
constexpr int kMinSplitLog2 = 16;      // the split takes n1 >= 16, so w <= 256
constexpr int kClusterUnplaceable = -1;
#ifndef FWHT_CLUSTER
#define FWHT_CLUSTER 8
#endif
constexpr int kClusterSize = FWHT_CLUSTER;  // blocks a cluster on the cluster path
static_assert(kClusterSize == 2 || kClusterSize == 4 || kClusterSize == 8,
              "a portable cluster of 2, 4 or 8 blocks");

// Built with -DFWHT_PHASES, thread 0 of every block of the row and cluster
// kernels adds the clock64() cycles of each phase (up to the barrier that
// ends it, or its own part where no barrier follows) to a device array
// (tools/torch_fwht_phases.py).  The normal build has no stamps.
#ifdef FWHT_PHASES
constexpr int kPhases = 5;
__device__ long long g_phase_cycles[kPhases + 1];  // per phase, then the blocks counted
#define PHASE_START long long t_phase = clock64();
#define PHASE(i)                                 \
  if (threadIdx.x == 0) {                        \
    const long long t_now = clock64();           \
    atomicAdd((unsigned long long*)&g_phase_cycles[i], (unsigned long long)(t_now - t_phase)); \
    t_phase = t_now;                             \
  }
#define PHASE_END \
  if (threadIdx.x == 0) atomicAdd((unsigned long long*)&g_phase_cycles[kPhases], 1ull);
#else
#define PHASE_START
#define PHASE(i)
#define PHASE_END
#endif

enum Mode { kNatural = 0, kSequency = 1, kInverseSequency = 2 };
enum Path { kRow = 0, kCluster = 1, kSplit = 2 };

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

__device__ inline float add(float a, float b) { return a + b; }
__device__ inline float sub(float a, float b) { return a - b; }
__device__ inline float scaled(float a, float s) { return a / s; }
__device__ inline float2 add(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ inline float2 sub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ inline float2 scaled(float2 a, float s) { return make_float2(a.x / s, a.y / s); }

__device__ inline void unpack(const float4& q, float* e) { e[0] = q.x; e[1] = q.y; e[2] = q.z; e[3] = q.w; }
__device__ inline void unpack(const float4& q, float2* e) { e[0] = make_float2(q.x, q.y); e[1] = make_float2(q.z, q.w); }
__device__ inline float4 pack(const float* e) { return make_float4(e[0], e[1], e[2], e[3]); }
__device__ inline float4 pack(const float2* e) { return make_float4(e[0].x, e[0].y, e[1].x, e[1].y); }

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

// Where entry i of a block's part of the row lies in its shared memory: bits
// [v, v + 3) (v = log2 of the entries in 16 bytes) XOR the higher 3-bit
// groups from bit b up (b = log2 of the entries across the 32 four-byte
// banks; a part holds at most 2^15 float32 or 2^14 complex64, so four groups
// cover it).  An involution, linear in XOR, that keeps each 16-byte vector
// whole and in order.
template <typename T>
__host__ __device__ constexpr unsigned swz(unsigned i) {
  constexpr int v = ilog2(16 / sizeof(T)), b = ilog2(128 / sizeof(T));
  return i ^ ((((i >> b) ^ (i >> (b + 3)) ^ (i >> (b + 6)) ^ (i >> (b + 9))) & 7u) << v);
}

// f(std::integral_constant<int, I>) for I = 0 .. N-1, each I a constant
// expression (a plain unrolled loop leaves the compiler to fold indices it
// computes through constexpr calls, and it may keep an array in memory)
template <int I, int N, typename F>
__device__ inline void static_for(F f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, N>(f);
  }
}

// gray^-1 and bit reversal of small compile-time numbers
__host__ __device__ constexpr unsigned gray_inv_small(unsigned x) { return x ^ (x >> 1) ^ (x >> 2) ^ (x >> 3) ^ (x >> 4); }
__host__ __device__ constexpr unsigned brev_small(unsigned x, int bits) {
  return bits == 0 ? 0u : ((x & 1u) << (bits - 1)) | brev_small(x >> 1, bits - 1);
}

// put(j, value) for each entry j of m contiguous ones at src, in 16-byte
// vectors where the row allows (the wrapper aligns rows to 16 bytes).
template <typename T, typename Put>
__device__ inline void load_entries(const T* __restrict__ src, unsigned m, Put put) {
  constexpr int kVec = 16 / sizeof(T);
  if (m % kVec == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (unsigned v = threadIdx.x; v < m / kVec; v += blockDim.x) {
      T e[kVec];
      unpack(src4[v], e);
#pragma unroll
      for (int i = 0; i < kVec; ++i) put(v * kVec + i, e[i]);
    }
  } else {
    for (unsigned j = threadIdx.x; j < m; j += blockDim.x) put(j, src[j]);
  }
}

// dst[k] = get(k) / scale for m contiguous entries, in 16-byte vectors.
template <typename T, typename Get>
__device__ inline void store_entries(T* __restrict__ dst, unsigned m, float scale, Get get) {
  constexpr int kVec = 16 / sizeof(T);
  if (m % kVec == 0) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
    for (unsigned v = threadIdx.x; v < m / kVec; v += blockDim.x) {
      T e[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) e[i] = scaled(get(v * kVec + i), scale);
      dst4[v] = pack(e);
    }
  } else {
    for (unsigned k = threadIdx.x; k < m; k += blockDim.x) dst[k] = scaled(get(k), scale);
  }
}

// m contiguous entries of src into s (swizzled), a 16-byte vector at a time.
template <typename T>
__device__ inline void load_contiguous(const T* __restrict__ src, T* s, unsigned m) {
  constexpr int kVec = 16 / sizeof(T);
  if (m % kVec == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (unsigned v = threadIdx.x; v < m / kVec; v += blockDim.x)
      *reinterpret_cast<float4*>(s + swz<T>(v * kVec)) = src4[v];
  } else {
    for (unsigned j = threadIdx.x; j < m; j += blockDim.x) s[swz<T>(j)] = src[j];
  }
}

// dst[k] = s[k] / scale for m contiguous entries, a 16-byte vector at a time.
template <typename T>
__device__ inline void store_contiguous(const T* s, T* __restrict__ dst, unsigned m, float scale) {
  store_entries(dst, m, scale, [&](unsigned k) { return s[swz<T>(k)]; });
}

// In-register butterflies: stages first .. log2(R) - 1 over the R entries of
// v, pairs (i, i + 2^st).
template <typename T, int R>
__device__ inline void register_stages(T (&v)[R], int first) {
#pragma unroll
  for (int st = 0; st < ilog2(R); ++st) {
    if (st >= first) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (!(i & (1 << st))) {
          const T a = v[i], b = v[i | (1 << st)];
          v[i] = add(a, b);
          v[i | (1 << st)] = sub(a, b);
        }
      }
    }
  }
}

// One pass: unit o holds the R entries at base(o) ^ off(i), i < R (off(i) a
// swizzled index, so the XOR is the swizzle of an index with disjoint bits),
// and runs the register stages [first, log2 R) on them; with kVectors the R
// entries are contiguous and move as 16-byte vectors.
template <typename T, int R, bool kVectors, typename Base, typename Off>
__device__ inline void pass_units(T* s, unsigned units, int first, Base base, Off off) {
  constexpr int kVec = 16 / sizeof(T);
  for (unsigned o = threadIdx.x; o < units; o += blockDim.x) {
    const unsigned b = base(o);
    T v[R];
    if constexpr (kVectors) {
#pragma unroll
      for (int u = 0; u < R / kVec; ++u)
        unpack(*reinterpret_cast<const float4*>(s + (b ^ off(u * kVec))), &v[u * kVec]);
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) v[i] = s[b ^ off(i)];
    }
    register_stages(v, first);
    if constexpr (kVectors) {
#pragma unroll
      for (int u = 0; u < R / kVec; ++u)
        *reinterpret_cast<float4*>(s + (b ^ off(u * kVec))) = pack(&v[u * kVec]);
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) s[b ^ off(i)] = v[i];
    }
  }
}

// The stages h = 1 .. m/2 over the m = 2^log2m entries of s (swizzled), R
// entries a thread, in passes of r = log2(R) index bits, unrolled so that
// each slot's place is the unit's base XOR a constant.  Pass p over bits
// [p r, (p+1) r): unit o holds the entries whose other bits are o's.  The
// last pass, over fewer bits rb when r does not divide log2m, holds the
// entries o + i 2^(log2m - r), whose top rb bits of i are that pass's, and
// runs only their stages.  In every pass the lanes of a warp differ in index
// bits that swz maps onto distinct banks.
template <typename T, int R>
__device__ inline void local_stages(T* s, int log2m) {
  constexpr int r = ilog2(R);
  constexpr int kPasses = (ilog2(kRowBytes / sizeof(T)) + r - 1) / r;
  const unsigned units = (1u << log2m) >> r;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int lo = p * r;
    if (lo >= log2m) break;
    if (lo + r <= log2m) {
      const unsigned lomask = (1u << lo) - 1u;
      auto base = [&](unsigned o) { return swz<T>(((o >> lo) << (lo + r)) | (o & lomask)); };
      auto off = [&](int i) { return swz<T>((unsigned)i << lo); };
      if (p == 0 && R >= 16 / (int)sizeof(T)) {
        pass_units<T, R, true>(s, units, 0, base, off);
      } else {
        pass_units<T, R, false>(s, units, 0, base, off);
      }
    } else {
      const int shift = log2m - r;
      unsigned bit[r];
#pragma unroll
      for (int b = 0; b < r; ++b) bit[b] = swz<T>(1u << (shift + b));
      auto off = [&](int i) {
        unsigned x = 0;
#pragma unroll
        for (int b = 0; b < r; ++b)
          if (i & (1 << b)) x ^= bit[b];
        return x;
      };
      pass_units<T, R, false>(s, units, r - (log2m - lo), [&](unsigned o) { return swz<T>(o); }, off);
    }
    __syncthreads();
  }
}

// The cross-block tile of a cluster of C blocks of m entries each.  Tile t
// holds the H x V offsets j_u + e (e < V contiguous; u < H spread over the
// top log2(H) offset bits, j_u = tV + bitrev(u) m/H) in all C blocks: H C V
// entries, with H C entries of T making 32 bytes or more.  After the top
// stages the H C values (u, c) of offset element e are the sequency outputs
// k = run(e) + (Q(u, c) XOR (H C - 1 if parity(bitrev(j_0 + e)) else 0)):
// one contiguous run, so the forward sequency transform writes whole 32-byte
// sectors and the inverse reads them.
template <typename T, int C>
struct Tile {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int H = 32 / (C * (int)sizeof(T)) > 1 ? 32 / (C * (int)sizeof(T)) : 1;
  static constexpr int kLogH = ilog2(H), kLogC = ilog2(C), HC = H * C;
  // the place of value (u, c) in its run, before the parity's reversal
  static __host__ __device__ constexpr int Q(int u, int c) {
    return (int)(gray_inv_small(((unsigned)u << kLogC) | brev_small((unsigned)c, kLogC)) & (HC - 1));
  }
  // offset of group u of tile t, in a part of 2^log2m entries.  With
  // `runs`, the lanes of a warp (t's low 5 bits) take the offset bits just
  // below the top log2(H), so that their sequency runs lie within a few
  // hundred bytes of each other; else consecutive vectors.
  static __device__ unsigned offset(unsigned t, int u, int log2m, bool runs) {
    const int tbits = log2m - kLogH - ilog2(V);
    const unsigned g = runs ? ((t & 31u) << (tbits - 5)) | (t >> 5) : t;
    return g * V + (brev_small((unsigned)u, kLogH) << (log2m - kLogH));
  }
  // the first sequency position of element e's run, and whether the run is reversed
  static __device__ unsigned run(unsigned j, int log2m, bool& reversed) {
    const unsigned b = __brev(j) >> (32 - log2m);
    unsigned g = b << kLogC;
    g ^= g >> 1;
    g ^= g >> 2;
    g ^= g >> 4;
    g ^= g >> 8;
    g ^= g >> 16;
    reversed = __popc(b) & 1;
    return g & ~(unsigned)(HC - 1);
  }
};

// Inverse sequency load of a cluster: input entry k goes to natural position
// perm(k) in the cluster's shared memory, a tile at a time: each element's
// run of H C contiguous inputs is read as 16-byte vectors, and each (u, c)
// group of V entries is written as one 16-byte vector into block c.
template <typename T, int C>
__device__ inline void tile_load(const T* __restrict__ xrow, T* (&part)[C], unsigned rank, int log2m) {
  using Tl = Tile<T, C>;
  constexpr int V = Tl::V, H = Tl::H, HC = Tl::HC;
  const unsigned share = ((1u << log2m) / (H * V)) / C;
  for (unsigned t = rank * share + threadIdx.x; t < (rank + 1) * share; t += blockDim.x) {
    T v[H][C][V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      bool rev;
      const unsigned k0 = Tl::run(Tl::offset(t, 0, log2m, true) + e, log2m, rev);
      T w[HC];
#pragma unroll
      for (int f = 0; f < HC / V; ++f) unpack(reinterpret_cast<const float4*>(xrow + k0)[f], &w[f * V]);
      static_for<0, HC>([&](auto uc) {
        constexpr int u = decltype(uc)::value / C, c = decltype(uc)::value % C, q = Tl::Q(u, c);
        v[u][c][e] = rev ? w[HC - 1 - q] : w[q];
      });
    }
#pragma unroll
    for (int u = 0; u < H; ++u) {
      const unsigned pos = swz<T>(Tl::offset(t, u, log2m, true));
#pragma unroll
      for (int c = 0; c < C; ++c) *reinterpret_cast<float4*>(part[c] + pos) = pack(v[u][c]);
    }
  }
}

// The top log2(C) stages of a cluster.  Each thread takes kTiles = 16 / (H C)
// tiles (so that they fill 256 bytes of registers; the plan gives a block
// (its part) / 256 B threads, so the block's share of tiles is covered
// once), reading the C blocks' 16-byte vectors of each tile's groups
// through distributed shared memory in natural order, neighbouring lanes
// on neighbouring vectors, and running the butterflies across blocks in
// registers.  Natural order: the scaled results go straight to device
// memory, one vector per (tile, u, c).  Forward sequency order: after every
// block has read (cluster.sync), each element's run of H C outputs is
// written into the shared memory of the block whose part of the output it
// is, at its sequency position; after a second cluster.sync each block
// stores its own part contiguously.  (Reading tiles in sequency order
// instead, or storing the runs to device memory directly, scatters 16-byte
// accesses that cost more than these writes.)  Returns whether the block's
// part of the output is left in s, unscaled.
template <typename T, int C>
__device__ inline bool tile_top_stages(T* (&part)[C], T* s, T* __restrict__ orow, unsigned rank, int log2m,
                                       int mode, float scale) {
  using Tl = Tile<T, C>;
  constexpr int V = Tl::V, H = Tl::H, HC = Tl::HC, kTiles = 16 / HC > 1 ? 16 / HC : 1;
  const unsigned m = 1u << log2m;
  const unsigned t0 = rank * ((m / (H * V)) / C) + threadIdx.x;
  T v[kTiles][H][C][V];
#pragma unroll
  for (int k = 0; k < kTiles; ++k) {
    const unsigned t = t0 + k * blockDim.x;
#pragma unroll
    for (int u = 0; u < H; ++u) {
      const unsigned pos = swz<T>(Tl::offset(t, u, log2m, false));
#pragma unroll
      for (int c = 0; c < C; ++c) unpack(*reinterpret_cast<const float4*>(part[c] + pos), v[k][u][c]);
    }
#pragma unroll
    for (int st = 0; st < Tl::kLogC; ++st)
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (!(c & (1 << st)))
#pragma unroll
          for (int u = 0; u < H; ++u)
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const T a = v[k][u][c][e], b = v[k][u][c | (1 << st)][e];
              v[k][u][c][e] = add(a, b);
              v[k][u][c | (1 << st)][e] = sub(a, b);
            }
  }
  if (mode != kSequency) {
#pragma unroll
    for (int k = 0; k < kTiles; ++k)
#pragma unroll
      for (int u = 0; u < H; ++u) {
        const unsigned j = Tl::offset(t0 + k * blockDim.x, u, log2m, false);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          T e4[V];
#pragma unroll
          for (int e = 0; e < V; ++e) e4[e] = scaled(v[k][u][c][e], scale);
          *reinterpret_cast<float4*>(orow + ((unsigned)c << log2m) + j) = pack(e4);
        }
      }
    return false;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block has read its tiles: the parts may be overwritten
#pragma unroll
  for (int k = 0; k < kTiles; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) {
      bool rev;
      const unsigned k0 = Tl::run(Tl::offset(t0 + k * blockDim.x, 0, log2m, false) + e, log2m, rev);
      T w[HC];
      static_for<0, HC>([&](auto uc) {
        constexpr int u = decltype(uc)::value / C, c = decltype(uc)::value % C, q = Tl::Q(u, c);
        w[q] = v[k][u][c][e];
      });
      T o[HC];
#pragma unroll
      for (int i = 0; i < HC; ++i) o[i] = rev ? w[HC - 1 - i] : w[i];
      // each 16-byte vector of the run at its own swizzled place in the owner block
      T* dst = cluster.map_shared_rank(s, (int)(k0 >> log2m));
#pragma unroll
      for (int f = 0; f < HC / V; ++f)
        *reinterpret_cast<float4*>(dst + swz<T>((k0 & (m - 1u)) + f * V)) = pack(&o[f * V]);
    }
  cluster.sync();
  return true;
}

// Row path: one block a row, R entries a thread.
template <typename T, int R>
__global__ void __launch_bounds__(kMaxThreads) fwht_row_kernel(
    const T* __restrict__ x, T* __restrict__ out, int log2n, int mode, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const unsigned n = 1u << log2n;
  const T* xr = x + ((long long)blockIdx.x << log2n);
  T* orow = out + ((long long)blockIdx.x << log2n);
  PHASE_START
  if (mode == kInverseSequency) {
    load_entries(xr, n, [&](unsigned k, T e) { s[swz<T>(perm(k, log2n))] = e; });
  } else {
    load_contiguous(xr, s, n);
  }
  __syncthreads();
  PHASE(0)
  local_stages<T, R>(s, log2n);
  PHASE(1)
  if (mode == kSequency) {
    store_entries(orow, n, scale, [&](unsigned k) { return s[swz<T>(perm(k, log2n))]; });
  } else {
    store_contiguous(s, orow, n, scale);
  }
  PHASE(3)
  PHASE_END
}

// Cluster path: a cluster of C blocks a row, block `rank` holding entries
// [rank m, (rank + 1) m), m = n / C, R entries a thread.
template <typename T, int R, int C>
__global__ void __launch_bounds__(kMaxThreads) fwht_cluster_kernel(
    const T* __restrict__ x, T* __restrict__ out, int log2n, int mode, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int log2m = log2n - ilog2(C);
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  T* part[C];  // each block's part of the row, through distributed shared memory
#pragma unroll
  for (int c = 0; c < C; ++c) part[c] = cluster.map_shared_rank(s, c);
  const long long row = (long long)(blockIdx.x / C) << log2n;
  PHASE_START
  if (mode == kInverseSequency) {
    cluster.sync();  // every block of the cluster runs before any writes into its memory
    tile_load<T, C>(x + row, part, rank, log2m);
    cluster.sync();
  } else {
    load_contiguous(x + row + ((long long)rank << log2m), s, 1u << log2m);
    __syncthreads();
  }
  PHASE(0)
  local_stages<T, R>(s, log2m);
  PHASE(1)
  cluster.sync();
  PHASE(2)
  if (tile_top_stages<T, C>(part, s, out + row, rank, log2m, mode, scale)) {
    PHASE(3)
    store_contiguous(s, out + row + ((long long)rank << log2m), 1u << log2m, scale);
  } else {
    PHASE(3)
    cluster.sync();  // no block leaves while a partner reads its memory
  }
  PHASE(4)
  PHASE_END
}

// Split, pass 1: block (row, chunk) runs the stages h < n2 on one chunk of
// n2 contiguous entries, unscaled, into scratch.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) fwht_chunk_kernel(
    const T* __restrict__ x, T* __restrict__ scratch, int log2n, int mode) {
  __shared__ __align__(16) T s[1 << kChunkLog2];
  constexpr int n2 = 1 << kChunkLog2;
  const int chunks = 1 << (log2n - kChunkLog2);
  const long long row = blockIdx.x / chunks;
  const int base = (blockIdx.x % chunks) * n2;
  const T* xr = x + (row << log2n);
  if (mode == kInverseSequency) {
    for (int j = threadIdx.x; j < n2; j += blockDim.x) s[swz<T>(j)] = xr[inv_perm(base + j, log2n)];
  } else {
    load_contiguous(xr + base, s, n2);
  }
  __syncthreads();
  local_stages<T, kRegBytes / sizeof(T)>(s, kChunkLog2);
  store_contiguous(s, scratch + (row << log2n) + base, n2, 1.0f);
}

// Split, pass 2: block (row, column tile) loads n1 x w entries (w contiguous
// columns at stride n2) into columns of stride n1 + 1, runs the stages
// h >= n2 (h/n2 = 1, ..., n1/2 down each column), and stores scaled
// (scattering to inv(j) for the forward sequency transform).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) fwht_column_kernel(
    const T* __restrict__ scratch, T* __restrict__ out, int log2n, int mode, float scale) {
  __shared__ T s[kTile + (kTile >> (kMinSplitLog2 - kChunkLog2))];
  const int log2n1 = log2n - kChunkLog2;
  const int n1 = 1 << log2n1;
  const int log2w = kChunkLog2 - log2n1;  // w = kTile / n1
  const int ld = n1 + 1;
  const int tiles = 1 << (kChunkLog2 - log2w);
  const long long row = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) << log2w;
  const T* sr = scratch + (row << log2n);
  for (int e = threadIdx.x; e < kTile; e += blockDim.x) {
    const int i1 = e >> log2w, i2 = e & ((1 << log2w) - 1);
    s[i2 * ld + i1] = sr[((long long)i1 << kChunkLog2) + c0 + i2];
  }
  __syncthreads();
  for (int lh = 0; lh < log2n1; ++lh) {
    const int h = 1 << lh;
    for (int t = threadIdx.x; t < kTile / 2; t += blockDim.x) {
      const int col = t >> (log2n1 - 1), p = t & ((n1 >> 1) - 1);
      const int i = col * ld + ((p >> lh) << (lh + 1)) + (p & (h - 1));
      const T a = s[i], b = s[i + h];
      s[i] = add(a, b);
      s[i + h] = sub(a, b);
    }
    __syncthreads();
  }
  T* orow = out + (row << log2n);
  for (int e = threadIdx.x; e < kTile; e += blockDim.x) {
    const int i1 = e >> log2w, i2 = e & ((1 << log2w) - 1);
    const unsigned j = ((unsigned)i1 << kChunkLog2) + c0 + i2;
    orow[mode == kSequency ? inv_perm(j, log2n) : j] = scaled(s[i2 * ld + i1], scale);
  }
}

// How many clusters of kClusterSize blocks of `threads` threads and `smem`
// bytes of dynamic shared memory the card holds at once, or minus the CUDA
// error code.
template <typename T>
int capacity(int threads, int smem) {
  constexpr int C = kClusterSize;
  auto kernel = fwht_cluster_kernel<T, kRegBytes / sizeof(T), C>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

// Launches fwht_row_kernel<T, R> (C = 1) or fwht_cluster_kernel<T, R, C> on
// rows x C blocks of `threads` threads with `smem` bytes of dynamic shared
// memory, as clusters of C blocks.
template <typename T, int R, int C>
int launch_block(const T* x, T* out, long long rows, int log2n, int mode, float scale, int threads,
                 int smem, cudaStream_t stream) {
  void (*kernel)(const T*, T*, int, int, float);
  if constexpr (C > 1) {
    kernel = fwht_cluster_kernel<T, R, C>;
  } else {
    kernel = fwht_row_kernel<T, R>;
  }
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * C));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if constexpr (C > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    static int placed_threads = 0, placed_smem = -1;  // the last configuration found to fit
    if (threads != placed_threads || smem != placed_smem) {
      const int clusters = capacity<T>(threads, smem);
      if (clusters < 0) return -clusters;
      if (clusters < 1) return kClusterUnplaceable;
      placed_threads = threads;
      placed_smem = smem;
    }
  }
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, out, log2n, mode, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The row path with R = min(n, 128 B of entries) entries a thread.
template <typename T, int R>
int launch_row(int n, const T* x, T* out, long long rows, int log2n, int mode, float scale, int threads,
               int smem, cudaStream_t stream) {
  if constexpr (R > 2) {
    if (n < R) return launch_row<T, R / 2>(n, x, out, rows, log2n, mode, scale, threads, smem, stream);
  }
  return launch_block<T, R, 1>(x, out, rows, log2n, mode, scale, threads, smem, stream);
}

template <typename T>
int launch_split(const T* x, T* out, T* scratch, long long rows, int log2n, int mode, float scale,
                 cudaStream_t stream) {
  const long long chunks = 1LL << (log2n - kChunkLog2);
  fwht_chunk_kernel<T><<<(unsigned)(rows * chunks), kMaxThreads, 0, stream>>>(x, scratch, log2n, mode);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (1LL << kChunkLog2) / (kTile / chunks);
  fwht_column_kernel<T><<<(unsigned)(rows * tiles), kMaxThreads, 0, stream>>>(scratch, out, log2n, mode, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xv, void* outv, void* scratchv, long long rows, int log2n, int mode, float scale,
           int path, int threads, int smem, cudaStream_t stream) {
  constexpr int kR = kRegBytes / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const long long n = 1LL << log2n;
  if (threads < 32 || threads > kMaxThreads || threads % 32) return (int)cudaErrorInvalidValue;
  if (path == kSplit) {
    if (log2n < kMinSplitLog2) return (int)cudaErrorInvalidValue;
    return launch_split<T>(x, out, static_cast<T*>(scratchv), rows, log2n, mode, scale, stream);
  }
  const int C = path == kRow ? 1 : kClusterSize;
  const long long row_bytes = n * (long long)sizeof(T), part = n / C;
  if (part * (long long)sizeof(T) > kRowBytes || (C > 1 && row_bytes <= kRowBytes) ||
      smem != part * (long long)sizeof(T) || (C > 1 && threads * 256LL != smem) || rows * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (path == kRow) return launch_row<T, kR>((int)n, x, out, rows, log2n, mode, scale, threads, smem, stream);
  return launch_block<T, kR, kClusterSize>(x, out, rows, log2n, mode, scale, threads, smem, stream);
}

}  // namespace

extern "C" {

// How many clusters of kClusterSize blocks of `threads` threads and `smem`
// bytes of dynamic shared memory the card holds at once
// (cudaOccupancyMaxActiveClusters; for the tools), or minus the CUDA error
// code.
int fwht_cluster_capacity(int is_complex, int threads, int smem) {
  return is_complex ? capacity<float2>(threads, smem) : capacity<float>(threads, smem);
}

const char* fwht_phase_names() {
  return "load (+ barrier),local stages,wait for the cluster,top stages (+ sequency exchange) / the "
         "row's stores (thread 0),stores or final cluster barrier";
}

// The cycles of each phase summed over the blocks, then the blocks counted,
// into out (-DFWHT_PHASES only; otherwise returns -1).  reset != 0 zeroes them.
int fwht_phase_cycles(long long* out, int reset) {
#ifdef FWHT_PHASES
  if (reset) {
    long long zero[kPhases + 1] = {};
    return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(long long) * (kPhases + 1));
#else
  (void)out;
  (void)reset;
  return -1;
#endif
}

// Transforms `rows` contiguous rows of n = 2^log2n entries of x into out on
// `stream`: is_complex = 0 for float32, 1 for complex64 (interleaved); mode
// 0 natural, 1 sequency, 2 inverse sequency; scale = sqrt(n).  The plan
// (kernels/wht.py::plan_fwht): path 0 row, 1 cluster (of kClusterSize
// blocks), 2 split; the threads of a block; its dynamic shared memory (n
// entries on the row path, n / kClusterSize on the cluster path; 0 on the
// split).  scratch (the size of x) is used only by the split.  x and out are 16-byte aligned.
// Returns 0 when launched, -1 when the card cannot place the cluster, else
// the CUDA error code (cudaErrorInvalidValue for a plan that does not fit n).
int fwht_launch(const void* x, void* out, void* scratch, long long rows, int log2n, int is_complex,
                int mode, float scale, int path, int threads, int smem, void* stream) {
  if (log2n < 1 || log2n > kChunkLog2 + 12 || rows < 1 || mode < 0 || mode > 2 || path < kRow || path > kSplit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_complex
             ? launch<float2>(x, out, scratch, rows, log2n, mode, scale, path, threads, smem, s)
             : launch<float>(x, out, scratch, rows, log2n, mode, scale, path, threads, smem, s);
}

}  // extern "C"
