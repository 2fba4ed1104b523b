// Adasum's per-entry combine for the data plane, CUDA C++ for sm_90a.
//
// Replaces no Pallas kernel: the JAX package leaves this arithmetic to XLA
// on the device (horovod_tpu/backend/xla.py:346-400, XlaAdasum's
// `combine`) and to numpy and its native dot3/combine loops on the host
// (horovod_tpu/backend/adasum.py:68-110).  It takes the role of the
// reference's CUDA Adasum helpers: over a fused pair a, b of fp32 (or
// fp64) vectors and a table of the entries' segments in them, it forms
// each entry's (a.b, |a|^2, |b|^2) and then ca*a + cb*b with the entry's
// coefficients.  In plain torch that is ~6 small launches per entry (292
// entries for BERT-large); here it is three launches per window:
//
//   1. adasum_tile_triplets_kernel: one block per tile (a piece of at most
//      kTile elements of one entry's segment) sums its three products in
//      fp64 into a row of per-tile partials;
//   2. adasum_entry_sum_kernel: one block per entry sums that entry's
//      partial rows in tile order;
//   3. adasum_combine_kernel: one block per tile forms its entry's
//      coefficients and writes ca*a + cb*b.
//
// Bound: bytes.  The two passes read a and b once each and write the
// output once, 20 bytes per fp32 element; the fp64 products are 6 flops
// per element, far below the card's fp64 rate.  So the design keeps the
// loads wide (16 bytes a thread where a and b share their alignment) and
// the blocks many (one per 64 KB tile of fp32), and spends fp64 on the
// accumulators, as the reference's double accumulators do.
//
// No atomics: every block sums its elements in one fixed order and the
// per-entry pass sums the tiles' rows in tile order, so a second launch on
// the same inputs gives the same bits.  The combine rounds the
// coefficients to the element type and rounds each product and the sum
// once (no fused multiply-add), as the plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Elements per tile: 64 KB of fp32 per operand, 16 float4 per thread.
constexpr int64_t kTile = 16384;
// Below this a squared norm counts as zero and its coefficient is 1.0
// (sqrt(DBL_MIN), reference adasum.h:385-391; the JAX _NORMSQ_EPS).
constexpr double kNormSqEps = 1.4916681462400413e-154;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

struct Acc {
  double dot = 0.0, aa = 0.0, bb = 0.0;
  __device__ void add(double x, double y) {
    dot = fma(x, y, dot);
    aa = fma(x, x, aa);
    bb = fma(y, y, bb);
  }
};

__device__ __forceinline__ void add4(Acc& acc, const float4& x,
                                     const float4& y) {
  acc.add(x.x, y.x);
  acc.add(x.y, y.y);
  acc.add(x.z, y.z);
  acc.add(x.w, y.w);
}

__device__ __forceinline__ void add4(Acc& acc, const double2& x,
                                     const double2& y) {
  acc.add(x.x, y.x);
  acc.add(x.y, y.y);
}

// The block's sum of the three accumulators, in a fixed tree; valid in
// thread 0.
__device__ Acc block_sum(Acc acc) {
  __shared__ double part[3][kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    acc.dot += __shfl_down_sync(0xffffffffu, acc.dot, off);
    acc.aa += __shfl_down_sync(0xffffffffu, acc.aa, off);
    acc.bb += __shfl_down_sync(0xffffffffu, acc.bb, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    part[0][warp] = acc.dot;
    part[1][warp] = acc.aa;
    part[2][warp] = acc.bb;
  }
  __syncthreads();
  Acc out;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) {
      out.dot += part[0][w];
      out.aa += part[1][w];
      out.bb += part[2][w];
    }
  }
  return out;
}

// Whether a + i, b + i (and out + i) share their offset within 16 bytes:
// then a scalar head brings all of them to a 16-byte boundary.
template <typename T>
__device__ __forceinline__ int64_t aligned_head(const T* a, const T* b,
                                                const T* out, int64_t i,
                                                int64_t end, bool* vec) {
  const uintptr_t ma = reinterpret_cast<uintptr_t>(a + i) & 15;
  const uintptr_t mb = reinterpret_cast<uintptr_t>(b + i) & 15;
  const uintptr_t mo = reinterpret_cast<uintptr_t>(out + i) & 15;
  *vec = ma == mb && ma == mo && ma % sizeof(T) == 0;
  if (!*vec) return 0;
  const int64_t head = ma ? static_cast<int64_t>((16 - ma) / sizeof(T)) : 0;
  return head < end - i ? head : end - i;
}

// tiles: three rows of n_tiles int64, the entry, start and end of each
// tile (window offsets).  partials: n_tiles rows of (dot, aa, bb).
template <typename T>
__global__ void __launch_bounds__(kThreads)
adasum_tile_triplets_kernel(const T* __restrict__ a, const T* __restrict__ b,
                            const int64_t* __restrict__ tiles, int64_t n_tiles,
                            double* __restrict__ partials) {
  using VT = typename Vec<T>::type;
  constexpr int V = Vec<T>::n;
  const int64_t t = blockIdx.x;
  int64_t i = tiles[n_tiles + t];
  const int64_t end = tiles[2 * n_tiles + t];
  Acc acc;
  bool vec;
  const int64_t head = aligned_head(a, b, a, i, end, &vec);
  if (vec) {
    for (int64_t j = threadIdx.x; j < head; j += kThreads)
      acc.add(a[i + j], b[i + j]);
    i += head;
    const int64_t nv = (end - i) / V;
    const VT* av = reinterpret_cast<const VT*>(a + i);
    const VT* bv = reinterpret_cast<const VT*>(b + i);
#pragma unroll 4
    for (int64_t j = threadIdx.x; j < nv; j += kThreads)
      add4(acc, av[j], bv[j]);
    i += nv * V;
  }
  for (int64_t j = i + threadIdx.x; j < end; j += kThreads)
    acc.add(a[j], b[j]);
  const Acc sum = block_sum(acc);
  if (threadIdx.x == 0) {
    partials[3 * t] = sum.dot;
    partials[3 * t + 1] = sum.aa;
    partials[3 * t + 2] = sum.bb;
  }
}

// entry_ptr: num_entries + 1 offsets into the tiles (an entry's tiles are
// consecutive); an entry with none gets zeros.
__global__ void __launch_bounds__(kThreads)
adasum_entry_sum_kernel(const double* __restrict__ partials,
                        const int64_t* __restrict__ entry_ptr,
                        double* __restrict__ triplets) {
  const int e = blockIdx.x;
  Acc acc;
  for (int64_t t = entry_ptr[e] + threadIdx.x; t < entry_ptr[e + 1];
       t += kThreads) {
    acc.dot += partials[3 * t];
    acc.aa += partials[3 * t + 1];
    acc.bb += partials[3 * t + 2];
  }
  const Acc sum = block_sum(acc);
  if (threadIdx.x == 0) {
    triplets[3 * e] = sum.dot;
    triplets[3 * e + 1] = sum.aa;
    triplets[3 * e + 2] = sum.bb;
  }
}

__device__ __forceinline__ float mul_rn(float x, float y) {
  return __fmul_rn(x, y);
}
__device__ __forceinline__ double mul_rn(double x, double y) {
  return __dmul_rn(x, y);
}
__device__ __forceinline__ float add_rn(float x, float y) {
  return __fadd_rn(x, y);
}
__device__ __forceinline__ double add_rn(double x, double y) {
  return __dadd_rn(x, y);
}

template <typename T>
__device__ __forceinline__ T combine1(T ca, T x, T cb, T y) {
  return add_rn(mul_rn(ca, x), mul_rn(cb, y));
}

__device__ __forceinline__ float4 combine4(float ca, const float4& x,
                                           float cb, const float4& y) {
  return make_float4(combine1(ca, x.x, cb, y.x), combine1(ca, x.y, cb, y.y),
                     combine1(ca, x.z, cb, y.z), combine1(ca, x.w, cb, y.w));
}

__device__ __forceinline__ double2 combine4(double ca, const double2& x,
                                            double cb, const double2& y) {
  return make_double2(combine1(ca, x.x, cb, y.x), combine1(ca, x.y, cb, y.y));
}

// out may be a or b: each element is read and written by one thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
adasum_combine_kernel(const T* a, const T* b, T* out,
                      const int64_t* __restrict__ tiles, int64_t n_tiles,
                      const double* __restrict__ triplets) {
  using VT = typename Vec<T>::type;
  constexpr int V = Vec<T>::n;
  const int64_t t = blockIdx.x;
  const int64_t e = tiles[t];
  int64_t i = tiles[n_tiles + t];
  const int64_t end = tiles[2 * n_tiles + t];
  const double dot = triplets[3 * e], aa = triplets[3 * e + 1],
               bb = triplets[3 * e + 2];
  const T ca = static_cast<T>(aa >= kNormSqEps ? 1.0 - dot / (2.0 * aa) : 1.0);
  const T cb = static_cast<T>(bb >= kNormSqEps ? 1.0 - dot / (2.0 * bb) : 1.0);
  bool vec;
  const int64_t head = aligned_head(a, b, out, i, end, &vec);
  if (vec) {
    for (int64_t j = threadIdx.x; j < head; j += kThreads)
      out[i + j] = combine1(ca, a[i + j], cb, b[i + j]);
    i += head;
    const int64_t nv = (end - i) / V;
    const VT* av = reinterpret_cast<const VT*>(a + i);
    const VT* bv = reinterpret_cast<const VT*>(b + i);
    VT* ov = reinterpret_cast<VT*>(out + i);
#pragma unroll 4
    for (int64_t j = threadIdx.x; j < nv; j += kThreads)
      ov[j] = combine4(ca, av[j], cb, bv[j]);
    i += nv * V;
  }
  for (int64_t j = i + threadIdx.x; j < end; j += kThreads)
    out[j] = combine1(ca, a[j], cb, b[j]);
}

template <typename T>
int triplets(const void* a, const void* b, const int64_t* tiles,
             int64_t n_tiles, const int64_t* entry_ptr, int num_entries,
             double* partials, double* out, cudaStream_t s) {
  if (n_tiles > 0)
    adasum_tile_triplets_kernel<T><<<static_cast<unsigned>(n_tiles), kThreads,
                                     0, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), tiles, n_tiles,
        partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  adasum_entry_sum_kernel<<<static_cast<unsigned>(num_entries), kThreads, 0,
                            s>>>(partials, entry_ptr, out);
  return cudaGetLastError();
}

template <typename T>
int combine(const void* a, const void* b, void* out, const int64_t* tiles,
            int64_t n_tiles, const double* trip, cudaStream_t s) {
  adasum_combine_kernel<T><<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      tiles, n_tiles, trip);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements per tile and the norm threshold, so the wrapper can check its
// copies.
long long hvd_adasum_tile() { return kTile; }
double hvd_adasum_normsq_eps() { return kNormSqEps; }

// Triplets of num_entries entries (rows of (dot, |a|^2, |b|^2), fp64) into
// out; partials is scratch of 3 * n_tiles doubles.  Two launches (one when
// there is no tile).
int hvd_adasum_triplets(int fp64, const void* a, const void* b,
                        const void* tiles, long long n_tiles,
                        const void* entry_ptr, int num_entries, void* partials,
                        void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* t = static_cast<const int64_t*>(tiles);
  const int64_t* p = static_cast<const int64_t*>(entry_ptr);
  double* part = static_cast<double*>(partials);
  double* o = static_cast<double*>(out);
  return fp64 ? triplets<double>(a, b, t, n_tiles, p, num_entries, part, o, s)
              : triplets<float>(a, b, t, n_tiles, p, num_entries, part, o, s);
}

// out = ca*a + cb*b over every tile, with each tile's entry's coefficients
// from trip.  One launch; n_tiles must be at least 1.
int hvd_adasum_combine(int fp64, const void* a, const void* b, void* out,
                       const void* tiles, long long n_tiles, const void* trip,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* t = static_cast<const int64_t*>(tiles);
  const double* c = static_cast<const double*>(trip);
  return fp64 ? combine<double>(a, b, out, t, n_tiles, c, s)
              : combine<float>(a, b, out, t, n_tiles, c, s);
}

}  // extern "C"
