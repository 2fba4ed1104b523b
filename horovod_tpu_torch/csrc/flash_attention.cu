// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels.
//
// Replaces the three Pallas TPU kernels of the library flash attention that
// horovod_tpu/models/transformer.py:128-135 reaches
// (jax/experimental/pallas/ops/tpu/flash_attention.py, jax 0.9.0):
//
//   forward  _flash_attention_impl     (:589, body _flash_attention_kernel :331)
//   dK, dV   _flash_attention_bwd_dkv  (:941, body _flash_attention_dkv_kernel :796)
//   dQ       _flash_attention_bwd_dq   (:1287, body _flash_attention_dq_kernel :1146)
//
// Same functions, in the JAX package's [b, s, h, d] layout:
//
//   forward  S = scale * Q Kᵀ (fp32; key > query masked when causal),
//            o = softmax(S) V (bf16 out), lse = logsumexp(S) per row (fp32)
//   dK, dV   P = exp(S - lse), dV = Pᵀ dO, dS = P ∘ (dO Vᵀ - di),
//            dK = scale * dSᵀ Q
//   dQ       dQ = scale * dS K
//
// where di = rowsum(o ∘ dO) comes from the caller, as in the library (:273).
// The library keeps the row max m and row sum l broadcast to 128 lanes as
// residuals; here one fp32 lse per row takes their place.
//
// Design (the first, simple one).  The TPU kernels walk a sequential grid and
// carry m, l and the accumulators in VMEM from one grid step to the next.  On
// Hopper the blocks run in no order, so each block owns one output tile and
// loops over the other sequence axis itself, its accumulators in registers:
//   forward  one block per (64-row q tile, head, batch), looping over k tiles
//            with an online softmax in fp32;
//   dK, dV   one block per (64-row k tile, head, batch), looping over q tiles;
//   dQ       one block per (64-row q tile, head, batch), looping over k tiles.
// Four warps per block; each warp owns 16 rows of the block's tile and issues
// mma.sync.m16n8k16 bf16 products with fp32 accumulators.  Each tile is
// staged in shared memory with 16-byte loads and zero-filled past the ragged
// end of the sequence; out-of-range and causally masked pairs get probability
// exactly 0.  A row whose keys seen so far are all masked keeps m = -inf and
// subtracts 0 instead, so (-inf) - (-inf) never makes a NaN.  As on the JAX
// einsum path, probabilities are rounded to bf16 before the product with V
// (and P, dS before the backward products).  No atomics: dK/dV and dQ are two
// kernels, as in the library, so every sum is taken in a fixed order and
// repeated runs give identical bits.  No cp.async pipeline, no wgmma or TMA:
// making it fast is later work.
//
// The inputs may be strided views (row stride 3·h·d for the q, k, v slices of
// a fused qkv projection): the kernel takes each input's batch, sequence and
// head strides in elements; the head dimension is contiguous.  Outputs are
// contiguous [b, s, h, d] (bf16) and [b, h, s] (lse, fp32).
//
// Bound (BERT-large, b 8, s 512, h 16, d 64, non-causal): the forward does
// 4·b·h·s²·d = 8.6 GFLOP, 8.7 µs at the H100 SXM's 989 TFLOP/s dense bf16,
// and moves 33.8 MB of q, k, v, o and lse, 10.1 µs at 3.35 TB/s: bound by
// bytes, barely (s = 512 is short).  dK/dV (8·b·h·s²·d) and dQ (6·b·h·s²·d)
// are bound by operations.  chip_smoke.py computes each shape's bound and
// PERF.md lists them.
//
// Interface: plain C, loaded with ctypes.  The caller checks device, dtype,
// head_dim (64 or 128), the 16-byte alignment of pointers and strides,
// allocates every output and passes PyTorch's current stream.  Each launch
// returns cudaGetLastError() so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// Mirrored by horovod_tpu_torch/kernels/flash_attention.py::_Params.  Outside
// the unnamed namespace: the C entry points take it, and a type with internal
// linkage would make them internal too.
struct HvdFlashParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;   // dO (backward)
  const float* di;    // rowsum(o ∘ dO), [b, h, s] (backward)
  float* lse;         // [b, h, s]: written by the forward, read by the backward
  bf16* o;            // forward output
  bf16* dq;
  bf16* dk;
  bf16* dv;
  long long q_stride[3];   // batch, sequence, head; in elements
  long long k_stride[3];
  long long v_stride[3];
  long long do_stride[3];
  int b, h, s;
  float scale;
  int causal;
};

namespace {

typedef HvdFlashParams Params;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows of the block's own tile

// Row pitch of a staged tile, in bf16: 8 extra (16 bytes) keeps 16-byte
// alignment and spreads a fragment's 32 lanes over 32 banks.
template <int D>
struct Pitch {
  static constexpr int value = D + 8;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a·b on a 16x8 tile: a 16x16 (row major), b 16x8 (column major).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment layouts of m16n8k16 (PTX ISA), with g = lane / 4, t = lane % 4:
//   A: regs {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)}
//   B: regs {(k 2t..2t+1, n g), (k 2t+8..2t+9, n g)}
//   C: {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}

// A fragment of rows r0.., columns c0.. of a row-major staged tile.
template <int P>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int r0,
                                       int c0, int g, int t) {
  a[0] = ld32(s + (r0 + g) * P + c0 + 2 * t);
  a[1] = ld32(s + (r0 + g + 8) * P + c0 + 2 * t);
  a[2] = ld32(s + (r0 + g) * P + c0 + 2 * t + 8);
  a[3] = ld32(s + (r0 + g + 8) * P + c0 + 2 * t + 8);
}

// B fragment (k = column c0.., n = row n0..) of a tile staged [n][k]: the
// transposed operand of X·Yᵀ, two contiguous bf16 per register.
template <int P>
__device__ __forceinline__ void load_b_t(uint32_t (&b)[2], const bf16* s,
                                         int n0, int c0, int g, int t) {
  b[0] = ld32(s + (n0 + g) * P + c0 + 2 * t);
  b[1] = ld32(s + (n0 + g) * P + c0 + 2 * t + 8);
}

// B fragment (k = row k0.., n = column n0..) of a tile staged [k][n]: the
// operand of X·Y, two bf16 from neighbouring rows per register.
template <int P>
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const bf16* s, int k0,
                                       int n0, int g, int t) {
  const bf16* p = s + (k0 + 2 * t) * P + n0 + g;
  b[0] = pack(p[0], p[P]);
  b[1] = pack(p[8 * P], p[9 * P]);
}

// A fragment for k columns 16·kk.. from C accumulators (two 16x8 tiles).
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

// Stage rows [row0, row0 + ROWS) of one head's [s, D] slice into a tile of
// pitch P; rows at or past s are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int row0,
                                          int s) {
  constexpr int P = Pitch<D>::value;
  constexpr int kVecs = D / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < ROWS * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    uint4 val = zero;
    if (row0 + r < s)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * P + c) = val;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ const bf16* head(const bf16* base,
                                            const long long (&stride)[3],
                                            int b, int h) {
  return base + b * stride[0] + h * stride[2];
}

// Write rows of a warp's 16 x D accumulator, times `mul`, as bf16 into a
// contiguous [b, s, h, D] tensor.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const Params& p, int b,
                                           int h, int row_a,
                                           const float (&acc)[D / 8][4],
                                           float mul_a, float mul_b, int t) {
  const long long row_stride = (long long)p.h * D;
  bf16* base = out + ((long long)b * p.s * p.h + h) * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_a + 8 * half;
    if (row >= p.s) continue;
    const float mul = half ? mul_b : mul_a;
    bf16* dst = base + row * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int P = Pitch<D>::value;
  constexpr int BN = 64;  // keys per k tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kRows * P;
  bf16* vs = ks + BN * P;

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_a = q0 + warp * 16 + g;  // this thread's two rows
  const int row_b = row_a + 8;
  const bf16* kh = head(p.k, p.k_stride, b, h);
  const bf16* vh = head(p.v, p.v_stride, b, h);

  load_tile<D, kRows>(qs, head(p.q, p.q_stride, b, h), p.q_stride[1], q0, p.s);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.0f, 0.0f};

  const int kv_end = p.causal ? min(p.s, q0 + kRows) : p.s;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D, BN>(ks, kh, p.k_stride[1], k0, p.s);
    load_tile<D, BN>(vs, vh, p.v_stride[1], k0, p.s);
    __syncthreads();

    float sc[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a<P>(a, qs, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        uint32_t bb[2];
        load_b_t<P>(bb, ks, j * 8, kk * 16, g, t);
        mma(sc[j], a, bb);
      }
    }

    // Scale, mask, and the tile's row max.
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        float x = sc[j][e] * p.scale;
        if (col >= p.s || (p.causal && col > row)) x = -CUDART_INF_F;
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float base[2];
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      base[r] = m_new == -CUDART_INF_F ? 0.0f : m_new;
      alpha[r] = __expf(m[r] - base[r]);
      m[r] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = __expf(sc[j][e] - base[e >> 1]);
        sc[j][e] = pv;
        rs[e >> 1] += pv;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // o += P V, P rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bb[2];
        load_b<P>(bb, vs, kk * 16, n * 8, g, t);
        mma(acc[n], a, bb);
      }
    }
  }

  const float inv_a = l[0] > 0.0f ? 1.0f / l[0] : 0.0f;
  const float inv_b = l[1] > 0.0f ? 1.0f / l[1] : 0.0f;
  store_rows<D>(p.o, p, b, h, row_a, acc, inv_a, inv_b, t);
  if (t == 0) {
    float* lse = p.lse + ((long long)b * p.h + h) * p.s;
    if (row_a < p.s) lse[row_a] = m[0] + logf(l[0]);
    if (row_b < p.s) lse[row_b] = m[1] + logf(l[1]);
  }
}

template <int D>
struct DkvTile {
  // q rows per step: fewer at D = 128 keeps the accumulators in registers.
  static constexpr int BQ = D == 128 ? 32 : 64;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const Params p) {
  constexpr int P = Pitch<D>::value;
  constexpr int BQ = DkvTile<D>::BQ;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kRows * P;
  bf16* qs = vs + kRows * P;
  bf16* dos = qs + BQ * P;
  float* lse_s = reinterpret_cast<float*>(dos + BQ * P);
  float* di_s = lse_s + BQ;

  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key_a = k0 + warp * 16 + g;  // this thread's two keys
  const int key_b = key_a + 8;
  const bf16* qh = head(p.q, p.q_stride, b, h);
  const bf16* doh = head(p.dout, p.do_stride, b, h);
  const long long bh = ((long long)b * p.h + h) * p.s;

  load_tile<D, kRows>(ks, head(p.k, p.k_stride, b, h), p.k_stride[1], k0, p.s);
  load_tile<D, kRows>(vs, head(p.v, p.v_stride, b, h), p.v_stride[1], k0, p.s);

  float dk[D / 8][4];
  float dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[n][e] = 0.0f;
      dv[n][e] = 0.0f;
    }

  // Causal: only queries at or after the block's first key see it.
  const int q_begin = p.causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < p.s; q0 += BQ) {
    __syncthreads();
    load_tile<D, BQ>(qs, qh, p.q_stride[1], q0, p.s);
    load_tile<D, BQ>(dos, doh, p.do_stride[1], q0, p.s);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const bool in = q0 + i < p.s;
      lse_s[i] = in ? p.lse[bh + q0 + i] : 0.0f;
      di_s[i] = in ? p.di[bh + q0 + i] : 0.0f;
    }
    __syncthreads();

    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: this warp's 16 keys x BQ queries.
    float st[BQ / 8][4];
    float dpt[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[j][e] = 0.0f;
        dpt[j][e] = 0.0f;
      }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4];
      uint32_t av[4];
      load_a<P>(ak, ks, warp * 16, kk * 16, g, t);
      load_a<P>(av, vs, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        uint32_t bq[2];
        uint32_t bd[2];
        load_b_t<P>(bq, qs, j * 8, kk * 16, g, t);
        load_b_t<P>(bd, dos, j * 8, kk * 16, g, t);
        mma(st[j], ak, bq);
        mma(dpt[j], av, bd);
      }
    }

    // Pᵀ = exp(scale·Sᵀ − lse) and dSᵀ = Pᵀ ∘ (dPᵀ − di); masked pairs 0.
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * t + (e & 1);
        const int q = q0 + qi;
        const int key = e < 2 ? key_a : key_b;
        const bool valid = q < p.s && key < p.s && !(p.causal && key > q);
        const float pv = valid ? __expf(st[j][e] * p.scale - lse_s[qi]) : 0.0f;
        st[j][e] = pv;
        dpt[j][e] = pv * (dpt[j][e] - di_s[qi]);
      }

    // dV += Pᵀ dO and dK += dSᵀ Q.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ap[4];
      uint32_t ads[4];
      c_to_a(ap, st[2 * kk], st[2 * kk + 1]);
      c_to_a(ads, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bd[2];
        uint32_t bq[2];
        load_b<P>(bd, dos, kk * 16, n * 8, g, t);
        load_b<P>(bq, qs, kk * 16, n * 8, g, t);
        mma(dv[n], ap, bd);
        mma(dk[n], ads, bq);
      }
    }
  }

  store_rows<D>(p.dk, p, b, h, key_a, dk, p.scale, p.scale, t);
  store_rows<D>(p.dv, p, b, h, key_a, dv, 1.0f, 1.0f, t);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
  constexpr int P = Pitch<D>::value;
  constexpr int BN = 64;  // keys per k tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kRows * P;
  bf16* ks = dos + kRows * P;
  bf16* vs = ks + BN * P;

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const bf16* kh = head(p.k, p.k_stride, b, h);
  const bf16* vh = head(p.v, p.v_stride, b, h);
  const long long bh = ((long long)b * p.h + h) * p.s;

  load_tile<D, kRows>(qs, head(p.q, p.q_stride, b, h), p.q_stride[1], q0, p.s);
  load_tile<D, kRows>(dos, head(p.dout, p.do_stride, b, h), p.do_stride[1], q0,
                      p.s);
  const float lse[2] = {row_a < p.s ? p.lse[bh + row_a] : 0.0f,
                        row_b < p.s ? p.lse[bh + row_b] : 0.0f};
  const float di[2] = {row_a < p.s ? p.di[bh + row_a] : 0.0f,
                       row_b < p.s ? p.di[bh + row_b] : 0.0f};

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;

  const int kv_end = p.causal ? min(p.s, q0 + kRows) : p.s;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();
    load_tile<D, BN>(ks, kh, p.k_stride[1], k0, p.s);
    load_tile<D, BN>(vs, vh, p.v_stride[1], k0, p.s);
    __syncthreads();

    // S = Q Kᵀ and dP = dO Vᵀ: this warp's 16 queries x BN keys.
    float sc[BN / 8][4];
    float dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = 0.0f;
        dp[j][e] = 0.0f;
      }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4];
      uint32_t ad[4];
      load_a<P>(aq, qs, warp * 16, kk * 16, g, t);
      load_a<P>(ad, dos, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        uint32_t bk[2];
        uint32_t bv[2];
        load_b_t<P>(bk, ks, j * 8, kk * 16, g, t);
        load_b_t<P>(bv, vs, j * 8, kk * 16, g, t);
        mma(sc[j], aq, bk);
        mma(dp[j], ad, bv);
      }
    }

    // dS = P ∘ (dP − di), P = exp(scale·S − lse); masked pairs 0.
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const bool valid =
            key < p.s && row < p.s && !(p.causal && key > row);
        const float pv =
            valid ? __expf(sc[j][e] * p.scale - lse[e >> 1]) : 0.0f;
        sc[j][e] = pv * (dp[j][e] - di[e >> 1]);
      }

    // dQ += dS K.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bb[2];
        load_b<P>(bb, ks, kk * 16, n * 8, g, t);
        mma(dq[n], a, bb);
      }
    }
  }

  store_rows<D>(p.dq, p, b, h, row_a, dq, p.scale, p.scale, t);
}

template <int D>
constexpr int fwd_smem() {
  return (kRows + 2 * 64) * Pitch<D>::value * (int)sizeof(bf16);
}

template <int D>
constexpr int dkv_smem() {
  return (2 * kRows + 2 * DkvTile<D>::BQ) * Pitch<D>::value * (int)sizeof(bf16) +
         2 * DkvTile<D>::BQ * (int)sizeof(float);
}

template <int D>
constexpr int dq_smem() {
  return (2 * kRows + 2 * 64) * Pitch<D>::value * (int)sizeof(bf16);
}

// Launch `kernel` over (q or k tiles, heads, batch) with `smem` bytes of
// dynamic shared memory; returns cudaGetLastError().
template <typename Kernel>
int launch(Kernel kernel, int smem, const Params& p, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.s + kRows - 1) / kRows, p.h, p.b);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Size of HvdFlashParams, so the caller can check its mirror of the struct.
int hvd_flash_params_size() { return static_cast<int>(sizeof(HvdFlashParams)); }

int hvd_flash_fwd_bf16(const HvdFlashParams* p, int head_dim, void* stream) {
  if (head_dim == 64)
    return launch(flash_fwd_kernel<64>, fwd_smem<64>(), *p, stream);
  if (head_dim == 128)
    return launch(flash_fwd_kernel<128>, fwd_smem<128>(), *p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int hvd_flash_bwd_dkv_bf16(const HvdFlashParams* p, int head_dim, void* stream) {
  if (head_dim == 64)
    return launch(flash_bwd_dkv_kernel<64>, dkv_smem<64>(), *p, stream);
  if (head_dim == 128)
    return launch(flash_bwd_dkv_kernel<128>, dkv_smem<128>(), *p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int hvd_flash_bwd_dq_bf16(const HvdFlashParams* p, int head_dim, void* stream) {
  if (head_dim == 64)
    return launch(flash_bwd_dq_kernel<64>, dq_smem<64>(), *p, stream);
  if (head_dim == 128)
    return launch(flash_bwd_dq_kernel<128>, dq_smem<128>(), *p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
