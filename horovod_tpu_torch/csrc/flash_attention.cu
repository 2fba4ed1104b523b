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
// The TPU kernels walk a sequential grid and carry m, l and the accumulators
// in VMEM from one grid step to the next.  On Hopper the blocks run in no
// order, so each output tile belongs to one block (or one work item of a
// persistent block), which loops over the other sequence axis itself, its
// accumulators in registers.  What every kernel
// keeps, and what makes its results exact and repeatable: one fp32 lse per
// row; probabilities (and P, dS in the backward) rounded to bf16 before
// their products, as on the JAX einsum path; out-of-range and causally
// masked pairs get probability exactly 0, and a row whose keys seen so far
// are all masked keeps m = -inf and subtracts 0 instead, so (-inf) - (-inf)
// never makes a NaN.  No atomics: dK/dV and dQ are two kernels, as in the
// library, so every sum is taken in a fixed order and repeated runs give
// identical bits.
//
// All three kernels are built for Hopper (see each kernel's note): TMA
// loads into a ring of shared-memory stages completed on mbarriers, wgmma
// for every product, one producer warpgroup and two consumer warpgroups
// with registers moved between them by setmaxnreg (hopper.cuh).
//
// The inputs may be strided views (row stride 3·h·d for the q, k, v slices of
// a fused qkv projection): the kernels take each input's batch, sequence and
// head strides in elements, the head dimension contiguous; the host encodes
// one TMA tensor map per input over that view, so the slices are read in
// place.  Outputs are contiguous [b, s, h, d] (bf16) and [b, h, s] (lse,
// fp32).
//
// Interface: plain C, loaded with ctypes.  The caller checks device, dtype,
// head_dim (64 or 128), the 16-byte alignment of pointers and strides,
// allocates every output and passes PyTorch's current stream.  Each launch
// returns cudaGetLastError() (or cudaErrorInvalidValue if a tensor map is
// refused) so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

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

using namespace hvd_hopper;

// Every kernel: two consumer warpgroups, each 64 rows of the block's
// 128-row tile, then one producer warpgroup (wgmma wants its warpgroups
// aligned to four warps, so the consumers come first).
// 128·40 + 256·232 = 64,512 of the SM's 65,536 registers: one block per SM.
constexpr int kWarpgroup = 128;
constexpr int kConsumers = 2;
constexpr int kHopperThreads = (kConsumers + 1) * kWarpgroup;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// The A operand of a wgmma (m64k16, bf16 from registers) for k columns
// 16·kk.. from the fp32 accumulators of columns 16·kk.. and 16·kk + 8..
// (hopper.cuh gives both layouts), rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x (MUFU.EX2); 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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

// Row r of panel c of a tile staged as TMA writes it: D / 64 panels of
// ROWS x 64 bf16 (128-byte rows, 128-byte swizzle), panel c holding
// columns [64c, 64c + 64).
template <int ROWS>
__device__ __forceinline__ const bf16* panel(const bf16* tile, int c, int r) {
  return tile + (c * ROWS + r) * 64;
}

// TMA loads of rows [row0, row0 + ROWS) of one head's [s, D] slice into a
// tile of D / 64 panels, completing on `bar`.
template <int D, int ROWS>
__device__ __forceinline__ void load_panels(bf16* tile, const CUtensorMap* map,
                                            uint64_t* bar, int row0, int h,
                                            int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_4d(tile + c * ROWS * 64, map, bar, 64 * c, h, row0, b);
}

// sc = Q Kᵀ for this warpgroup's 64 queries (rows 64·wg.. of the Q tile
// of QROWS rows) and the BN keys of `ks`; K-dim D, both K-major.
template <int D, int BN, int QROWS>
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 8][4], const bf16* qs,
                                         int wg, const bf16* ks) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / 4;
    const uint64_t step = 2 * (kk % 4);  // 32 bytes of K
    wgmma_ss<BN>(&sc[0][0], desc_sw128(panel<QROWS>(qs, c, wg * 64)) + step,
                 desc_sw128(panel<BN>(ks, c, 0)) + step, kk > 0);
  }
}

// acc += P V: P (bf16) from registers, V (BN keys x D) MN-major.
template <int D, int BN>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 8][4],
                                         const uint32_t (&a)[BN / 16][4],
                                         const bf16* vs) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      wgmma_rs_mn<64>(&acc[8 * c][0], a[kk],
                      desc_sw128(panel<BN>(vs, c, 16 * kk)), 1);
}

// Online softmax over one k tile of BN keys from k0, in log2 units (the
// scores times scale·log2e): masks (when kGeneral) the keys past each row's
// `last` with -inf, updates the row max m and sum l, leaves the
// unnormalised probabilities in sc and each row's rescale factor for the
// accumulator in alpha.  A row whose keys so far are all masked keeps
// m = -inf and subtracts 0.  Without kGeneral (a tile with no masked pair
// and scale > 0) the max is taken over the raw scores and each probability
// costs one FFMA and one exp2.
template <int BN, bool kGeneral>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 8][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             float scale_log2, int k0,
                                             const int (&last)[2], int t) {
  // Four running maxima and sums per row (by j % 4) keep the dependency
  // chains short; the max is exact in any order.
  float mx[2][4];
  float rs[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mx[r][c] = -CUDART_INF_F;
      rs[r][c] = 0.0f;
    }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[j][e];
      if (kGeneral) {
        x *= scale_log2;
        if (k0 + j * 8 + 2 * t + (e & 1) > last[e >> 1]) x = -CUDART_INF_F;
        sc[j][e] = x;
      }
      mx[e >> 1][j % 4] = fmaxf(mx[e >> 1][j % 4], x);
    }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float tile_max = quad_max(fmaxf(fmaxf(mx[r][0], mx[r][1]),
                                    fmaxf(mx[r][2], mx[r][3])));
    if (!kGeneral) tile_max *= scale_log2;
    const float m_new = fmaxf(m[r], tile_max);
    base[r] = m_new == -CUDART_INF_F ? 0.0f : m_new;
    alpha[r] = ex2(m[r] - base[r]);
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pv = kGeneral ? ex2(sc[j][e] - base[e >> 1])
                                : ex2(fmaf(sc[j][e], scale_log2, -base[e >> 1]));
      sc[j][e] = pv;
      rs[e >> 1][j % 4] += pv;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] +
           quad_sum((rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]));
}

// Named barriers 1 and 2, one per consumer warpgroup (0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id) {
  bar_sync(id, kConsumers * kWarpgroup);
}

__device__ __forceinline__ void named_arrive(int id) {
  bar_arrive(id, kConsumers * kWarpgroup);
}

// Persistent blocks: block j takes work items j, j + gridDim.x, ... of the
// (row tile, head, batch) grid, row tiles fastest so that the blocks of one
// wave share a head's K and V in L2.  `reverse` walks the row tiles last
// first (the causal forward's heaviest first).
struct WorkItem {
  int row0, h, b;
};

__device__ __forceinline__ WorkItem work_item(long long w, int row_tiles,
                                              int rows, int heads,
                                              bool reverse) {
  const int t = static_cast<int>(w % row_tiles);
  const long long rest = w / row_tiles;
  return {(reverse ? row_tiles - 1 - t : t) * rows,
          static_cast<int>(rest % heads), static_cast<int>(rest / heads)};
}

template <int D>
struct FwdPlan {
  static constexpr int kQueries = 64 * kConsumers;  // per work item
  static constexpr int kKeys = 128;                 // per k tile
  static constexpr int kStages = 3;
  // Q tiles in flight: two at D = 64, so the next item's Q loads during
  // this one; one at D = 128, where two would not fit beside the ring.
  static constexpr int kQBuffers = D == 64 ? 2 : 1;
  static constexpr int kQBytes = kQueries * D * 2;
  static constexpr int kKvBytes = kKeys * D * 2;  // a K or V tile
  static constexpr int kStageBytes = 2 * kKvBytes;
  // Byte offsets from the 1024-aligned base: the Q buffers, the ring of
  // (K, V) stages, then the barriers q_full[kQBuffers], q_empty[kQBuffers],
  // full[kStages], empty[kStages].
  static constexpr int kRing = kQBuffers * kQBytes;
  static constexpr int kBars = kRing + kStages * kStageBytes;
  static constexpr int kSmem = 1024 + kBars + 16 * (kQBuffers + kStages);
};

// Forward, replacing FA:589.  Bound: at BERT-large (b 8, s 512, h 16, d 64)
// it does 4·b·h·s²·d = 8.6 GFLOP (8.7 µs at 989 TFLOP/s dense bf16) and
// moves 33.8 MB of q, k, v, o and lse (10.1 µs at 3.35 TB/s): bound by
// bytes, barely; at d = 128 by operations.  At d = 64 the exp of each
// score costs about as much time on the card's 16 exp units per SM as its
// 256 multiply-adds on the tensor cores.
//
// Persistent: one block per SM walks work items of (128-query tile, head,
// batch).  The producer warpgroup's first thread loads each item's Q tile
// into a free Q buffer (`q_empty`; two at d = 64), and keeps a ring of
// three (K, V) stages of 128 keys full with TMA across items; each stage completes on its `full`
// mbarrier and is released by the 256 consumer threads on its `empty` one.
// Each consumer warpgroup owns 64 queries: S = Q Kᵀ by wgmma with both
// operands in shared memory (K-major), the online softmax in fp32 (log2
// units, one exp2 per score) on the accumulator registers, then O += P V by
// wgmma with P (bf16) from registers and V read MN-major from shared
// memory.  S of the next k tile is issued before P V of the last one, so
// the softmax overlaps a product in flight, and the two warpgroups take
// turns to issue (named barriers), so one's softmax overlaps the other's
// products.  Q is released before the item's last P V and its stores, so
// the next item's loads overlap them.  TMA zero-fills rows past s; masks
// are applied on the k tiles that cross s or the diagonal, and queries past
// s are not stored.
template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = FwdPlan<D>;
  constexpr int BN = L::kKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_empty = q_full + L::kQBuffers;
  uint64_t* full = q_empty + L::kQBuffers;
  uint64_t* empty = full + L::kStages;

  const int row_tiles = (p.s + L::kQueries - 1) / L::kQueries;
  const long long n_items = (long long)row_tiles * p.h * p.b;
  auto item = [&](long long w) {
    return work_item(w, row_tiles, L::kQueries, p.h, p.causal);
  };
  auto n_k_tiles = [&](int q0) {
    return ((p.causal ? min(p.s, q0 + L::kQueries) : p.s) + BN - 1) / BN;
  };
  auto q_tile = [&](int n) {
    return reinterpret_cast<bf16*>(smem + (n % L::kQBuffers) * L::kQBytes);
  };
  auto k_tile = [&](int it) {
    return reinterpret_cast<bf16*>(smem + L::kRing +
                                   (it % L::kStages) * L::kStageBytes);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kQBuffers; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], kConsumers * kWarpgroup);
    }
    for (int i = 0; i < L::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers * kWarpgroup);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup;
  if (wg == kConsumers) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers * kWarpgroup) {
      int it = 0;  // k tiles loaded so far, over all items
      int n = 0;   // items so far
      for (long long w = blockIdx.x; w < n_items; w += gridDim.x, ++n) {
        const WorkItem x = item(w);
        uint64_t* q_bar = &q_full[n % L::kQBuffers];
        mbar_wait(&q_empty[n % L::kQBuffers], ((n / L::kQBuffers) & 1) ^ 1);
        mbar_arrive_expect_tx(q_bar, L::kQBytes);
        load_panels<D, L::kQueries>(q_tile(n), &tq, q_bar, x.row0, x.h, x.b);
        const int n_tiles = n_k_tiles(x.row0);
        for (int i = 0; i < n_tiles; ++i, ++it) {
          const int stage = it % L::kStages;
          mbar_wait(&empty[stage], ((it / L::kStages) & 1) ^ 1);
          bf16* ks = k_tile(it);
          mbar_arrive_expect_tx(&full[stage], L::kStageBytes);
          load_panels<D, BN>(ks, &tk, &full[stage], i * BN, x.h, x.b);
          load_panels<D, BN>(ks + BN * D, &tv, &full[stage], i * BN, x.h,
                             x.b);
        }
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const float scale_log2 = p.scale * kLog2e;
    // The two consumer warpgroups take turns to issue their products: each
    // waits on its named barrier (1 + wg), which the other arrives at once
    // it has issued.  Warpgroup 0 goes first, and takes warpgroup 1's last
    // arrival at the end.
    auto my_turn = [&] { named_sync(1 + wg); };
    auto your_turn = [&] { named_arrive(2 - wg); };
    if (wg == 1) named_arrive(1);

    int it = 0;  // k tiles consumed so far, over all items
    int n = 0;
    for (long long w = blockIdx.x; w < n_items; w += gridDim.x, ++n) {
      const WorkItem x = item(w);
      const int qw0 = x.row0 + wg * 64;  // this warpgroup's first query
      const int row_a = qw0 + warp * 16 + g;  // this thread's two rows
      const int row_b = row_a + 8;
      // Each row's last key: past it, keys are masked.
      const int last[2] = {p.causal ? min(p.s - 1, row_a) : p.s - 1,
                           p.causal ? min(p.s - 1, row_b) : p.s - 1};
      const int n_tiles = n_k_tiles(x.row0);

      float acc[D / 8][4];
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;
      float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // row max, log2 units
      float l[2] = {0.0f, 0.0f};
      float alpha[2];
      float sc[BN / 8][4];
      uint32_t a[BN / 16][4];  // P of the previous k tile, bf16
      // Scores to probabilities for k tile i: the general path where the
      // tile holds a masked pair of this warpgroup or scale <= 0.
      auto softmax = [&](int i) {
        if ((i + 1) * BN > p.s || (p.causal && (i + 1) * BN - 1 > qw0) ||
            !(scale_log2 > 0.0f))
          softmax_tile<BN, true>(sc, m, l, alpha, scale_log2, i * BN, last,
                                 t);
        else
          softmax_tile<BN, false>(sc, m, l, alpha, scale_log2, i * BN, last,
                                  t);
      };

      // k tile i: S_i = Q K_iᵀ is issued before P_{i-1} V_{i-1}, and the
      // softmax of S_i runs while that product is in flight.
      const bf16* qs = q_tile(n);
      mbar_wait(&q_full[n % L::kQBuffers], (n / L::kQBuffers) & 1);
      mbar_wait(&full[it % L::kStages], (it / L::kStages) & 1);
      __syncwarp();
      my_turn();
      wgmma_fence();
      issue_qk<D, BN, L::kQueries>(sc, qs, wg, k_tile(it));
      wgmma_commit();
      your_turn();
      wgmma_wait<0>();
      fence_regs<BN / 2>(&sc[0][0]);
      softmax(0);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        c_to_a(a[kk], sc[2 * kk], sc[2 * kk + 1]);
      for (int i = 1; i < n_tiles; ++i) {
        const int cur = it + i;
        mbar_wait(&full[cur % L::kStages], (cur / L::kStages) & 1);
        __syncwarp();
        my_turn();
        wgmma_fence();
        issue_qk<D, BN, L::kQueries>(sc, qs, wg, k_tile(cur));
        wgmma_commit();
        issue_pv<D, BN>(acc, a, k_tile(cur - 1) + BN * D);
        wgmma_commit();
        your_turn();
        wgmma_wait<1>();
        fence_regs<BN / 2>(&sc[0][0]);
        softmax(i);
        // Keep the softmax ahead of the wait: it is what overlaps P V.
        fence_regs<BN / 2>(&sc[0][0]);
        fence_regs<2>(l);
        wgmma_wait<0>();
        fence_regs<D / 2>(&acc[0][0]);
        mbar_arrive(&empty[(cur - 1) % L::kStages]);
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          acc[c][0] *= alpha[0];
          acc[c][1] *= alpha[0];
          acc[c][2] *= alpha[1];
          acc[c][3] *= alpha[1];
        }
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          c_to_a(a[kk], sc[2 * kk], sc[2 * kk + 1]);
      }
      // Every S of this item has completed.
      mbar_arrive(&q_empty[n % L::kQBuffers]);
      it += n_tiles;
      my_turn();
      wgmma_fence();
      issue_pv<D, BN>(acc, a, k_tile(it - 1) + BN * D);
      wgmma_commit();
      your_turn();
      wgmma_wait<0>();
      fence_regs<D / 2>(&acc[0][0]);
      mbar_arrive(&empty[(it - 1) % L::kStages]);

      const float inv_a = l[0] > 0.0f ? 1.0f / l[0] : 0.0f;
      const float inv_b = l[1] > 0.0f ? 1.0f / l[1] : 0.0f;
      store_rows<D>(p.o, p, x.b, x.h, row_a, acc, inv_a, inv_b, t);
      if (t == 0) {
        float* lse = p.lse + ((long long)x.b * p.h + x.h) * p.s;
        if (row_a < p.s) lse[row_a] = m[0] * kLn2 + logf(l[0]);
        if (row_b < p.s) lse[row_b] = m[1] * kLn2 + logf(l[1]);
      }
    }
    if (wg == 0) my_turn();
  }
}

template <int D>
struct DkvPlan {
  static constexpr int kKeys = 64 * kConsumers;  // per block
  // Queries per q tile: fewer at D = 128 keeps dK, dV, Sᵀ and dPᵀ in the
  // consumers' 232 registers.
  static constexpr int kQueries = D == 128 ? 32 : 64;
  static constexpr int kStages = 3;
  static constexpr int kKvBytes = kKeys * D * 2;   // K or V
  static constexpr int kQBytes = kQueries * D * 2;  // a Q or dO tile
  static constexpr int kStageBytes = 2 * kQBytes;
  // Byte offsets from the 1024-aligned base: K, V, the ring of (Q, dO)
  // stages, log2e·lse[kStages][kQueries] and di[kStages][kQueries] (fp32),
  // then the barriers kv_full, full[kStages], empty[kStages].
  static constexpr int kRing = 2 * kKvBytes;
  static constexpr int kRowStats = kRing + kStages * kStageBytes;
  static constexpr int kBars = kRowStats + 2 * kStages * kQueries * 4;
  static constexpr int kSmem = 1024 + kBars + 8 * (1 + 2 * kStages);
};

// dK, dV, replacing FA:941.  Bound: 8·b·h·s²·d operations (four products
// per (query, key) pair), 17.4 µs at BERT-large's shape at 989 TFLOP/s:
// bound by operations.
//
// One block per (128-key tile, head, batch), looping over q tiles from the
// causal start (the block's first key) or 0.  The producer warpgroup's first
// warp loads K and V once, then keeps a ring of three (Q, dO) stages full:
// its first thread issues the TMA loads, and its 32 lanes copy the tile's
// lse and di (fp32) into the stage before they arrive on its `full` barrier.
// Each consumer warpgroup owns 64 keys and works in the transposed form:
// Sᵀ = K Qᵀ and dPᵀ = V dOᵀ by wgmma with both operands in shared memory
// (K-major), Pᵀ = exp(scale·Sᵀ - lse) and dSᵀ = Pᵀ ∘ (dPᵀ - di) in fp32 on
// the accumulators, then dV += Pᵀ dO and dK += dSᵀ Q by wgmma with Pᵀ and
// dSᵀ (bf16) from registers and dO, Q read MN-major from shared memory.
// Four commit groups per q tile let the exp of Pᵀ run while dPᵀ is in
// flight and dSᵀ while dV's product is; masks are applied only on the
// tiles that cross s or the diagonal.  dK and dV stay in registers until
// the end; no sum leaves the block.
template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const Params p) {
  using L = DkvPlan<D>;
  constexpr int BQ = L::kQueries;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + L::kKeys * D;
  float* lse_s = reinterpret_cast<float*>(smem + L::kRowStats);
  float* di_s = lse_s + L::kStages * BQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + L::kStages;

  const int k0 = blockIdx.x * L::kKeys;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // Causal: only queries at or after the block's first key see it.
  const int q_begin = p.causal ? (k0 / BQ) * BQ : 0;
  const int n_tiles = (p.s - q_begin + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < L::kStages; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], kConsumers * kWarpgroup);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup;
  if (wg == kConsumers) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x / 32 == 4 * kConsumers) {
      const int lane = threadIdx.x % 32;
      const long long bh = ((long long)b * p.h + h) * p.s;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * L::kKvBytes);
        load_panels<D, L::kKeys>(ks, &tk, kv_full, k0, h, b);
        load_panels<D, L::kKeys>(vs, &tv, kv_full, k0, h, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int stage = i % L::kStages;
        const int q0 = q_begin + i * BQ;
        mbar_wait(&empty[stage], ((i / L::kStages) & 1) ^ 1);
        for (int j = lane; j < BQ; j += 32) {
          const bool in = q0 + j < p.s;
          lse_s[stage * BQ + j] = in ? p.lse[bh + q0 + j] * kLog2e : 0.0f;
          di_s[stage * BQ + j] = in ? p.di[bh + q0 + j] : 0.0f;
        }
        if (lane == 0) {
          bf16* qs =
              reinterpret_cast<bf16*>(smem + L::kRing + stage * L::kStageBytes);
          mbar_arrive_expect_tx(&full[stage], L::kStageBytes);
          load_panels<D, BQ>(qs, &tq, &full[stage], q0, h, b);
          load_panels<D, BQ>(qs + BQ * D, &tdo, &full[stage], q0, h, b);
        } else {
          mbar_arrive(&full[stage]);
        }
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int kw0 = k0 + wg * 64;  // this warpgroup's first key
    const int key_a = kw0 + warp * 16 + g;  // this thread's two keys
    const int key_b = key_a + 8;
    const float scale_log2 = p.scale * kLog2e;

    float dk[D / 8][4];
    float dv[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[n][e] = 0.0f;
        dv[n][e] = 0.0f;
      }

    mbar_wait(kv_full, 0);
    __syncwarp();
    for (int i = 0; i < n_tiles; ++i) {
      const int stage = i % L::kStages;
      mbar_wait(&full[stage], (i / L::kStages) & 1);
      __syncwarp();
      const bf16* qs = reinterpret_cast<const bf16*>(smem + L::kRing +
                                                     stage * L::kStageBytes);
      const bf16* dos = qs + BQ * D;
      const float* lse_t = lse_s + stage * BQ;
      const float* di_t = di_s + stage * BQ;
      const int q0 = q_begin + i * BQ;
      // Whether this tile holds a masked pair: ragged queries or keys, or
      // keys after queries.
      const bool masked = q0 + BQ > p.s || kw0 + 64 > p.s ||
                          (p.causal && kw0 + 63 > q0);

      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (this warpgroup's 64 keys x BQ queries)
      // in two groups: the exp of Pᵀ runs while dPᵀ is in flight.
      float st[BQ / 8][4];
      float dpt[BQ / 8][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t step = 2 * (kk % 4);  // 32 bytes of K
        wgmma_ss<BQ>(&st[0][0],
                     desc_sw128(panel<L::kKeys>(ks, kk / 4, wg * 64)) + step,
                     desc_sw128(panel<BQ>(qs, kk / 4, 0)) + step, kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t step = 2 * (kk % 4);
        wgmma_ss<BQ>(&dpt[0][0],
                     desc_sw128(panel<L::kKeys>(vs, kk / 4, wg * 64)) + step,
                     desc_sw128(panel<BQ>(dos, kk / 4, 0)) + step, kk > 0);
      }
      wgmma_commit();

      // Pᵀ = 2^(scale·log2e·Sᵀ − log2e·lse); masked pairs 0.
      wgmma_wait<1>();
      fence_regs<BQ / 2>(&st[0][0]);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 lz = *reinterpret_cast<const float2*>(lse_t + j * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pv = ex2(st[j][e] * scale_log2 - ((e & 1) ? lz.y : lz.x));
          if (masked) {
            const int q = q0 + j * 8 + 2 * t + (e & 1);
            const int key = e < 2 ? key_a : key_b;
            if (q >= p.s || key >= p.s || (p.causal && key > q)) pv = 0.0f;
          }
          st[j][e] = pv;
        }
      }
      // dV += Pᵀ dO (Pᵀ rounded to bf16, dO MN-major); dSᵀ = Pᵀ ∘ (dPᵀ − di)
      // runs while it is in flight.
      uint32_t ap[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) c_to_a(ap[kk], st[2 * kk], st[2 * kk + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          wgmma_rs_mn<64>(&dv[8 * c][0], ap[kk],
                          desc_sw128(panel<BQ>(dos, c, 16 * kk)), 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs<BQ / 2>(&dpt[0][0]);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 dz = *reinterpret_cast<const float2*>(di_t + j * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[j][e] = st[j][e] * (dpt[j][e] - ((e & 1) ? dz.y : dz.x));
      }
      // dK += dSᵀ Q, dSᵀ rounded to bf16, Q MN-major.
      uint32_t ads[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        c_to_a(ads[kk], dpt[2 * kk], dpt[2 * kk + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          wgmma_rs_mn<64>(&dk[8 * c][0], ads[kk],
                          desc_sw128(panel<BQ>(qs, c, 16 * kk)), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(&dv[0][0]);
      fence_regs<D / 2>(&dk[0][0]);
      mbar_arrive(&empty[stage]);
    }

    store_rows<D>(p.dk, p, b, h, key_a, dk, p.scale, p.scale, t);
    store_rows<D>(p.dv, p, b, h, key_a, dv, 1.0f, 1.0f, t);
  }
}

template <int D>
struct DqPlan {
  static constexpr int kQueries = 64 * kConsumers;  // per work item
  // Keys per k tile: 128 at D = 64 (fewer, longer products per tile), 64
  // at D = 128, where dQ's accumulator is twice as large.
  static constexpr int kKeys = D == 64 ? 128 : 64;
  static constexpr int kStages = 4;
  // (Q, dO) tiles in flight: two at D = 64, so the next item's load
  // overlaps this one; one at D = 128, as in the forward.
  static constexpr int kQBuffers = D == 64 ? 2 : 1;
  static constexpr int kQBytes = kQueries * D * 2;  // a Q or dO tile
  static constexpr int kKvBytes = kKeys * D * 2;    // a K or V tile
  static constexpr int kStageBytes = 2 * kKvBytes;
  // Byte offsets from the 1024-aligned base: the (Q, dO) buffers, the ring
  // of (K, V) stages, then the barriers q_full[kQBuffers],
  // q_empty[kQBuffers], full[kStages], empty[kStages].
  static constexpr int kRing = kQBuffers * 2 * kQBytes;
  static constexpr int kBars = kRing + kStages * kStageBytes;
  static constexpr int kSmem = 1024 + kBars + 16 * (kQBuffers + kStages);
};

// dS = P ∘ (dP − di) for one k tile of BN keys from k0, in place of the
// scores: P = 2^(scale·log2e·S − log2e·lse), from the row's lse2 = log2e·lse
// and di (0 for rows past s).  With kMasked (a tile that crosses s or the
// diagonal of this warpgroup) pairs of a key past s or, when causal, past
// the query get P = 0; without it each P costs one FFMA and one exp2.
template <int BN, bool kMasked>
__device__ __forceinline__ void ds_tile(float (&sc)[BN / 8][4],
                                        const float (&dp)[BN / 8][4],
                                        const float (&lse2)[2],
                                        const float (&di)[2], float scale_log2,
                                        int k0, const int (&last)[2], int t) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pv = ex2(fmaf(sc[j][e], scale_log2, -lse2[e >> 1]));
      if (kMasked && k0 + j * 8 + 2 * t + (e & 1) > last[e >> 1]) pv = 0.0f;
      sc[j][e] = pv * (dp[j][e] - di[e >> 1]);
    }
}

// dQ, replacing FA:1287.  Bound: 6·b·h·s²·d operations (three products per
// (query, key) pair), 13.0 µs at BERT-large's shape at 989 TFLOP/s: bound
// by operations.
//
// The forward's structure with one more score product and no online
// softmax.  Persistent: one block per SM walks work items of (128-query
// tile, head, batch).  The producer warpgroup's first thread loads each
// item's Q and dO tiles once into a free buffer (`q_empty`; two at d = 64)
// and keeps a ring of four (K, V) stages of 128 keys (64 at d = 128) full
// with TMA across
// items.  Each consumer warpgroup owns 64 queries and loads their lse and
// di once per item.  Per k tile: S = Q Kᵀ and dP = dO Vᵀ by wgmma with both
// operands in shared memory (K-major); P and dS = P ∘ (dP − di) in fp32 on
// the accumulators; dQ += dS K by wgmma with dS (bf16) from registers and K
// read MN-major from shared memory.  S and dP of k tile i are issued before
// dS K of tile i − 1, so the exp overlaps a product in flight, and the two
// warpgroups take turns to issue (named barriers).  Masks are applied only
// on the k tiles that cross s or the diagonal; the causal loop ends at the
// item's last query.  dQ stays in registers until the item's end and is
// scaled at the store; no sum leaves the block.
template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const Params p) {
  using L = DqPlan<D>;
  constexpr int BN = L::kKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_empty = q_full + L::kQBuffers;
  uint64_t* full = q_empty + L::kQBuffers;
  uint64_t* empty = full + L::kStages;

  const int row_tiles = (p.s + L::kQueries - 1) / L::kQueries;
  const long long n_items = (long long)row_tiles * p.h * p.b;
  auto item = [&](long long w) {
    return work_item(w, row_tiles, L::kQueries, p.h, p.causal);
  };
  auto n_k_tiles = [&](int q0) {
    return ((p.causal ? min(p.s, q0 + L::kQueries) : p.s) + BN - 1) / BN;
  };
  // Q of item n; its dO follows.
  auto q_tile = [&](int n) {
    return reinterpret_cast<bf16*>(smem + (n % L::kQBuffers) * 2 * L::kQBytes);
  };
  // K of k tile `it`; its V follows.
  auto k_tile = [&](int it) {
    return reinterpret_cast<bf16*>(smem + L::kRing +
                                   (it % L::kStages) * L::kStageBytes);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kQBuffers; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], kConsumers * kWarpgroup);
    }
    for (int i = 0; i < L::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers * kWarpgroup);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup;
  if (wg == kConsumers) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers * kWarpgroup) {
      int it = 0;  // k tiles loaded so far, over all items
      int n = 0;   // items so far
      for (long long w = blockIdx.x; w < n_items; w += gridDim.x, ++n) {
        const WorkItem x = item(w);
        uint64_t* q_bar = &q_full[n % L::kQBuffers];
        mbar_wait(&q_empty[n % L::kQBuffers], ((n / L::kQBuffers) & 1) ^ 1);
        mbar_arrive_expect_tx(q_bar, 2 * L::kQBytes);
        bf16* qs = q_tile(n);
        load_panels<D, L::kQueries>(qs, &tq, q_bar, x.row0, x.h, x.b);
        load_panels<D, L::kQueries>(qs + L::kQueries * D, &tdo, q_bar,
                                    x.row0, x.h, x.b);
        const int n_tiles = n_k_tiles(x.row0);
        for (int i = 0; i < n_tiles; ++i, ++it) {
          const int stage = it % L::kStages;
          mbar_wait(&empty[stage], ((it / L::kStages) & 1) ^ 1);
          bf16* ks = k_tile(it);
          mbar_arrive_expect_tx(&full[stage], L::kStageBytes);
          load_panels<D, BN>(ks, &tk, &full[stage], i * BN, x.h, x.b);
          load_panels<D, BN>(ks + BN * D, &tv, &full[stage], i * BN, x.h,
                             x.b);
        }
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const float scale_log2 = p.scale * kLog2e;
    // Turns to issue, as in the forward: warpgroup 0 goes first, and takes
    // warpgroup 1's last arrival at the end.
    auto my_turn = [&] { named_sync(1 + wg); };
    auto your_turn = [&] { named_arrive(2 - wg); };
    if (wg == 1) named_arrive(1);

    int it = 0;  // k tiles consumed so far, over all items
    int n = 0;
    for (long long w = blockIdx.x; w < n_items; w += gridDim.x, ++n) {
      const WorkItem x = item(w);
      const int qw0 = x.row0 + wg * 64;  // this warpgroup's first query
      const int row_a = qw0 + warp * 16 + g;  // this thread's two rows
      const int row_b = row_a + 8;
      // Each row's last key: past it, keys are masked.
      const int last[2] = {p.causal ? min(p.s - 1, row_a) : p.s - 1,
                           p.causal ? min(p.s - 1, row_b) : p.s - 1};
      const long long bh = ((long long)x.b * p.h + x.h) * p.s;
      const bool in_a = row_a < p.s;
      const bool in_b = row_b < p.s;
      const float lse2[2] = {in_a ? p.lse[bh + row_a] * kLog2e : 0.0f,
                             in_b ? p.lse[bh + row_b] * kLog2e : 0.0f};
      const float di[2] = {in_a ? p.di[bh + row_a] : 0.0f,
                           in_b ? p.di[bh + row_b] : 0.0f};
      const int n_tiles = n_k_tiles(x.row0);

      float dq[D / 8][4];
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[c][e] = 0.0f;
      float sc[BN / 8][4];
      float dp[BN / 8][4];
      uint32_t a[BN / 16][4];  // dS of the previous k tile, bf16
      auto ds = [&](int i) {
        if ((i + 1) * BN > p.s || (p.causal && (i + 1) * BN - 1 > qw0))
          ds_tile<BN, true>(sc, dp, lse2, di, scale_log2, i * BN, last, t);
        else
          ds_tile<BN, false>(sc, dp, lse2, di, scale_log2, i * BN, last, t);
      };
      const bf16* qs = q_tile(n);
      const bf16* dos = qs + L::kQueries * D;
      auto issue_scores = [&](int cur) {
        const bf16* ks = k_tile(cur);
        issue_qk<D, BN, L::kQueries>(sc, qs, wg, ks);
        issue_qk<D, BN, L::kQueries>(dp, dos, wg, ks + BN * D);
      };

      // k tile i: S_i and dP_i are issued before dS_{i-1} K_{i-1}, and dS_i
      // is computed while that product is in flight.
      mbar_wait(&q_full[n % L::kQBuffers], (n / L::kQBuffers) & 1);
      mbar_wait(&full[it % L::kStages], (it / L::kStages) & 1);
      __syncwarp();
      my_turn();
      wgmma_fence();
      issue_scores(it);
      wgmma_commit();
      your_turn();
      wgmma_wait<0>();
      fence_regs<BN / 2>(&sc[0][0]);
      fence_regs<BN / 2>(&dp[0][0]);
      ds(0);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        c_to_a(a[kk], sc[2 * kk], sc[2 * kk + 1]);
      for (int i = 1; i < n_tiles; ++i) {
        const int cur = it + i;
        mbar_wait(&full[cur % L::kStages], (cur / L::kStages) & 1);
        __syncwarp();
        my_turn();
        wgmma_fence();
        issue_scores(cur);
        wgmma_commit();
        issue_pv<D, BN>(dq, a, k_tile(cur - 1));
        wgmma_commit();
        your_turn();
        wgmma_wait<1>();
        fence_regs<BN / 2>(&sc[0][0]);
        fence_regs<BN / 2>(&dp[0][0]);
        ds(i);
        // Keep dS ahead of the wait: it is what overlaps dS K.
        fence_regs<BN / 2>(&sc[0][0]);
        wgmma_wait<0>();
        fence_regs<D / 2>(&dq[0][0]);
        mbar_arrive(&empty[(cur - 1) % L::kStages]);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          c_to_a(a[kk], sc[2 * kk], sc[2 * kk + 1]);
      }
      // Every S and dP of this item has completed.
      mbar_arrive(&q_empty[n % L::kQBuffers]);
      it += n_tiles;
      my_turn();
      wgmma_fence();
      issue_pv<D, BN>(dq, a, k_tile(it - 1));
      wgmma_commit();
      your_turn();
      wgmma_wait<0>();
      fence_regs<D / 2>(&dq[0][0]);
      mbar_arrive(&empty[(it - 1) % L::kStages]);
      store_rows<D>(p.dq, p, x.b, x.h, row_a, dq, p.scale, p.scale, t);
    }
    if (wg == 0) my_turn();
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory; each caller keeps
// the result in a static, so this runs once per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool encode(CUtensorMap* map, const bf16* base, const long long (&stride)[3],
            int rows, int d, const Params& p) {
  return encode_bshd(map, base, p.b, p.s, p.h, d, stride, rows);
}

template <int D>
int launch_fwd(const Params& p, cudaStream_t stream) {
  using L = FwdPlan<D>;
  static const cudaError_t attr = allow_smem(flash_fwd_kernel<D>, L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, p.q, p.q_stride, L::kQueries, D, p) ||
      !encode(&tk, p.k, p.k_stride, L::kKeys, D, p) ||
      !encode(&tv, p.v, p.v_stride, L::kKeys, D, p))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items =
      (long long)((p.s + L::kQueries - 1) / L::kQueries) * p.h * p.b;
  flash_fwd_kernel<D><<<persistent_blocks(items), kHopperThreads, L::kSmem,
                        stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const Params& p, cudaStream_t stream) {
  using L = DkvPlan<D>;
  static const cudaError_t attr = allow_smem(flash_bwd_dkv_kernel<D>, L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tq, tk, tv, tdo;
  if (!encode(&tq, p.q, p.q_stride, L::kQueries, D, p) ||
      !encode(&tk, p.k, p.k_stride, L::kKeys, D, p) ||
      !encode(&tv, p.v, p.v_stride, L::kKeys, D, p) ||
      !encode(&tdo, p.dout, p.do_stride, L::kQueries, D, p))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p.s + L::kKeys - 1) / L::kKeys, p.h, p.b);
  flash_bwd_dkv_kernel<D>
      <<<grid, kHopperThreads, L::kSmem, stream>>>(tq, tk, tv, tdo, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const Params& p, cudaStream_t stream) {
  using L = DqPlan<D>;
  static const cudaError_t attr = allow_smem(flash_bwd_dq_kernel<D>, L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tq, tk, tv, tdo;
  if (!encode(&tq, p.q, p.q_stride, L::kQueries, D, p) ||
      !encode(&tk, p.k, p.k_stride, L::kKeys, D, p) ||
      !encode(&tv, p.v, p.v_stride, L::kKeys, D, p) ||
      !encode(&tdo, p.dout, p.do_stride, L::kQueries, D, p))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items =
      (long long)((p.s + L::kQueries - 1) / L::kQueries) * p.h * p.b;
  flash_bwd_dq_kernel<D><<<persistent_blocks(items), kHopperThreads, L::kSmem,
                           stream>>>(tq, tk, tv, tdo, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
void tiles(int* out) {
  const int t[6] = {FwdPlan<D>::kQueries, FwdPlan<D>::kKeys,
                    DkvPlan<D>::kKeys,    DkvPlan<D>::kQueries,
                    DqPlan<D>::kQueries,  DqPlan<D>::kKeys};
  for (int i = 0; i < 6; ++i) out[i] = t[i];
}

}  // namespace

extern "C" {

// Size of HvdFlashParams, so the caller can check its mirror of the struct.
int hvd_flash_params_size() { return static_cast<int>(sizeof(HvdFlashParams)); }

// Tile sizes at `head_dim`, so the caller can check its copy: the forward's
// queries per work item and keys per k tile, the dK/dV kernel's keys per
// block and queries per q tile, then the dQ kernel's queries per work item
// and keys per k tile.  Returns 0, or -1 for another head_dim.
int hvd_flash_tiles(int head_dim, int* out) {
  if (head_dim == 64) {
    tiles<64>(out);
    return 0;
  }
  if (head_dim == 128) {
    tiles<128>(out);
    return 0;
  }
  return -1;
}

int hvd_flash_fwd_bf16(const HvdFlashParams* p, int head_dim, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch_fwd<64>(*p, s);
  if (head_dim == 128) return launch_fwd<128>(*p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int hvd_flash_bwd_dkv_bf16(const HvdFlashParams* p, int head_dim, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch_dkv<64>(*p, s);
  if (head_dim == 128) return launch_dkv<128>(*p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int hvd_flash_bwd_dq_bf16(const HvdFlashParams* p, int head_dim, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch_dq<64>(*p, s);
  if (head_dim == 128) return launch_dq<128>(*p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
