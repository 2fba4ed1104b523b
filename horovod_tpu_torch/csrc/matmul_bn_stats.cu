// Fused 1x1-conv + BatchNorm-statistics matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_matmul_stats_fwd_pallas` / `_matmul_stats_kernel`
// in horovod_tpu/kernels/conv_bn_stats.py (pallas_call at :105).  Same function:
//
//   y[M,N]  = x[M,K] @ w[K,N]          (bf16 in, fp32 accumulator, bf16 out)
//   p1[i,n] = sum over the rows of row block i of acc[:, n]
//   p2[i,n] = sum over the rows of row block i of acc[:, n]^2
//
// The statistics come from the fp32 accumulator while the output tile is still
// on chip, so BatchNorm never re-reads y for them.  The wrapper
// (horovod_tpu_torch/kernels/conv_bn_stats.py) sums the [ceil(M/BM), N]
// partials with one torch reduction, exactly where the JAX package reduces its
// per-row-block partials outside the kernel (:131).  No atomics: every sum is
// taken in a fixed order, so repeated runs give identical bits.
//
// Bound at the ResNet-50 shapes (batch 128, 224x224, 36 launches per forward):
// about 543 GFLOP per step, 0.55 ms at the H100 SXM's 989 TFLOP/s dense bf16.
// For large M a shape does about K*N/(K+N) FLOP per byte, so every shape with
// K*N/(K+N) under the card's ~295 FLOP/byte ridge (stages 1-2, and the
// (512,256), (256,1024), (1024,256) shapes of stage 3) is bound by bytes at
// 3.35 TB/s; the (K,N) pairs of 512 with 1024 or 2048, and 1024 with 2048,
// by operations.  At the four stage-1 shapes y is as large as x or larger,
// so the stores matter as much as the loads.
// chip_smoke.py computes each shape's bound, max(2MKN / 989e12,
// (2(MK + KN + MN) + 8 ceil(M/BM) N) / 3.35e12), and PERF.md lists them.
//
// Design.  The TPU kernel walks a sequential (i, j, k) grid with a VMEM
// accumulator carried across k steps.  Here one persistent block per SM walks
// the BM x BN output tiles, row tiles slowest, so that the blocks in flight
// share x rows and every w panel stays in L2.  BN is 64 where N <= 64, else
// 128 (tiles of 256 columns ran slower; PERF.md).  One producer
// thread keeps a ring of (x, w) stages of 64 of K full with TMA (2-D tensor
// maps, 128-byte swizzle; TMA reads past M, K and N as zero, so rows past M
// give zero accumulators, which add exactly 0 to both statistics), running
// ahead into the next tiles while the consumers finish this one.  Two
// consumer warpgroups own 64 rows each and issue wgmma m64n64k16 with x
// K-major and w MN-major from shared memory, one instruction per 64 columns.
// The epilogue writes y as bf16 into a shared tile in the swizzled layout and
// one thread per warpgroup stores it by TMA (clipped at M and N), so the
// stores leave as whole lines and overlap the next tile's products.  The
// column statistics come from the fp32 accumulators: a sum over each thread's
// two rows, a butterfly over the 8 lanes that share a column (each step
// halves the values a lane carries), then the 8 warps' rows combined in
// shared memory in a fixed order and written to the partials.
//
// Interface: plain C, loaded with ctypes.  The caller checks device, dtype,
// shape (K % 8 == 0, N % 8 == 0: TMA's 16-byte row strides), contiguity and
// 16-byte alignment, allocates every output, and passes PyTorch's current
// stream.  The launch returns cudaGetLastError() (or cudaErrorInvalidValue if
// a tensor map is refused) so a refused launch is reported, not silently
// skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hvd_hopper;
typedef __nv_bfloat16 bf16;

constexpr int BM = 128;  // rows per tile: two consumer warpgroups of 64
constexpr int BK = 64;   // K per stage: one 128-byte swizzle span
// Two consumer warpgroups, then the producer warpgroup (wgmma wants its
// warpgroups aligned to four warps).  128·40 + 256·232 = 64,512 of the
// SM's 65,536 registers: one block per SM.
constexpr int kWarpgroup = 128;
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * kWarpgroup;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int BN>
struct Plan {
  static constexpr int kPanels = BN / 64;  // 64-column panels of w and y
  // As many stages as fit beside the y tile: more loads in flight.
  static constexpr int kStages = BN == 128 ? 5 : 6;
  static constexpr int kXBytes = BM * BK * 2;
  static constexpr int kStageBytes = kXBytes + BK * BN * 2;
  // Byte offsets from the 1024-aligned base: the ring of (x, w) stages, the
  // y tile (per warpgroup kPanels panels of 64 rows x 128 bytes), the
  // statistics rows red[2][8 warps][BN] (fp32), then the barriers
  // full[kStages], empty[kStages].
  static constexpr int kY = kStages * kStageBytes;
  static constexpr int kRed = kY + BM * BN * 2;
  static constexpr int kBars = kRed + 2 * 8 * BN * 4;
  static constexpr int kSmem = 1024 + kBars + 16 * kStages;
};

// One step of the butterfly over lane bit `m`: of v[0, LEN), the lane with
// the bit clear keeps the lower half and the other the upper half, each
// added to its partner's copy.
template <int LEN>
__device__ __forceinline__ void halve(float* v, int lane, int m) {
  const bool upper = lane & m;
#pragma unroll
  for (int i = 0; i < LEN / 2; ++i) {
    const float send = upper ? v[i] : v[i + LEN / 2];
    const float keep = upper ? v[i + LEN / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    matmul_bn_stats_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tw,
                           const __grid_constant__ CUtensorMap ty,
                           float* __restrict__ p1, float* __restrict__ p2,
                           int M, int K, int N) {
  using L = Plan<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  float* red = reinterpret_cast<float*>(smem + L::kRed);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kStages;

  const int n_tiles = (N + BN - 1) / BN;
  const long long n_items = (long long)((M + BM - 1) / BM) * n_tiles;
  const int k_steps = (K + BK - 1) / BK;
  // x of stage `it`; its w panels follow.
  auto x_tile = [&](int it) {
    return reinterpret_cast<bf16*>(smem + (it % L::kStages) * L::kStageBytes);
  };

  if (threadIdx.x == 0) {
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
      int it = 0;  // stages loaded so far, over all tiles
      for (long long w = blockIdx.x; w < n_items; w += gridDim.x) {
        const int m0 = static_cast<int>(w / n_tiles) * BM;
        const int n0 = static_cast<int>(w % n_tiles) * BN;
        for (int kb = 0; kb < k_steps; ++kb, ++it) {
          const int stage = it % L::kStages;
          mbar_wait(&empty[stage], ((it / L::kStages) & 1) ^ 1);
          bf16* xs = x_tile(it);
          bf16* ws = xs + BM * BK;
          mbar_arrive_expect_tx(&full[stage], L::kStageBytes);
          tma_load_2d(xs, &tx, &full[stage], kb * BK, m0);
#pragma unroll
          for (int c = 0; c < L::kPanels; ++c)
            tma_load_2d(ws + c * BK * 64, &tw, &full[stage], n0 + 64 * c,
                        kb * BK);
        }
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const bool leader = threadIdx.x % kWarpgroup == 0;
    // This warpgroup's half of the y tile, and this warp's statistics rows.
    unsigned char* ys = smem + L::kY + wg * 64 * BN * 2;
    float* red1 = red + (wg * 4 + warp) * BN;
    float* red2 = red1 + 8 * BN;

    int it = 0;  // stages consumed so far, over all tiles
    for (long long w = blockIdx.x; w < n_items; w += gridDim.x) {
      const int m_tile = static_cast<int>(w / n_tiles);
      const int n0 = static_cast<int>(w % n_tiles) * BN;

      // acc[c]: this warpgroup's 64 rows x columns [64c, 64c + 64) of the
      // tile, in the m64n64 accumulator layout (hopper.cuh).
      float acc[L::kPanels][32];
      for (int kb = 0; kb < k_steps; ++kb, ++it) {
        const int stage = it % L::kStages;
        mbar_wait(&full[stage], (it / L::kStages) & 1);
        const bf16* xs = x_tile(it);
        const bf16* ws = xs + BM * BK;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t a = desc_sw128(xs + wg * 64 * BK) + 2 * kk;
#pragma unroll
          for (int c = 0; c < L::kPanels; ++c)
            wgmma_ss_mn64(acc[c], a, desc_sw128(ws + (c * BK + 16 * kk) * 64),
                          kb > 0 || kk > 0);
        }
        wgmma_commit();
        // The last step's products have completed: release its stage.
        wgmma_wait<1>();
        if (kb > 0) mbar_arrive(&empty[(it - 1) % L::kStages]);
      }
      wgmma_wait<0>();
      fence_regs<BN / 2>(&acc[0][0]);
      mbar_arrive(&empty[(it - 1) % L::kStages]);

      // The y tile and the statistics rows are free once the last tile's
      // TMA store has read them and every thread has read the rows.
      if (leader) bulk_wait_read<0>();
      bar_sync(3, kConsumers * kWarpgroup);
#pragma unroll
      for (int c = 0; c < L::kPanels; ++c) {
        unsigned char* yp = ys + c * 64 * 128;
        // v[(2j + q)·2 + stat]: column 8j + 2t + q of panel c, summed over
        // this thread's rows g and g + 8.
        float v[32];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = warp * 16 + g + 8 * half;
            // 16-byte chunk j of row r, in the 128-byte swizzle.
            *reinterpret_cast<uint32_t*>(yp + r * 128 + ((j ^ (r & 7)) << 4) +
                                         4 * t) =
                pack(acc[c][4 * j + 2 * half], acc[c][4 * j + 2 * half + 1]);
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float a0 = acc[c][4 * j + q];
            const float a1 = acc[c][4 * j + 2 + q];
            v[(2 * j + q) * 2] = a0 + a1;
            v[(2 * j + q) * 2 + 1] = a0 * a0 + a1 * a1;
          }
        }
        // Over the warp's 16 rows: lane (g, t) ends with j = g.
        halve<32>(v, lane, 16);
        halve<16>(v, lane, 8);
        halve<8>(v, lane, 4);
        const int col = 64 * c + 8 * g + 2 * t;
        *reinterpret_cast<float2*>(red1 + col) = make_float2(v[0], v[2]);
        *reinterpret_cast<float2*>(red2 + col) = make_float2(v[1], v[3]);
      }
      fence_proxy_async();
      bar_sync(1 + wg, kWarpgroup);
      if (leader) {
#pragma unroll
        for (int c = 0; c < L::kPanels; ++c)
          tma_store_2d(&ty, ys + c * 64 * 128, n0 + 64 * c,
                       m_tile * BM + 64 * wg);
        bulk_commit();
      }
      // Both warpgroups' rows are written: the 8 warps' sums in order.
      bar_sync(3, kConsumers * kWarpgroup);
      const int col = threadIdx.x;
      if (col < BN && n0 + col < N) {
        float s1 = 0.0f;
        float s2 = 0.0f;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          s1 += red[r * BN + col];
          s2 += red[(8 + r) * BN + col];
        }
        p1[(size_t)m_tile * N + n0 + col] = s1;
        p2[(size_t)m_tile * N + n0 + col] = s2;
      }
    }
    if (leader) bulk_wait<0>();
  }
}

// Columns per tile for N: 64 if that covers it, else 128.
int block_n(int n) { return n <= 64 ? 64 : 128; }

template <int BN>
int launch(const void* x, const void* w, void* y, float* p1, float* p2, int M,
           int K, int N, cudaStream_t stream) {
  using L = Plan<BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      matmul_bn_stats_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tx, tw, ty;
  if (!encode_2d(&tx, x, M, K, BM) || !encode_2d(&tw, w, K, N, BK) ||
      !encode_2d(&ty, y, M, N, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  matmul_bn_stats_kernel<BN><<<persistent_blocks(items), kThreads, L::kSmem,
                               stream>>>(tx, tw, ty, p1, p2, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows per row block: the partials buffers have ceil(M / BM) rows.
int hvd_matmul_bn_stats_block_m() { return BM; }

// Columns per tile at N, so the caller can check its copy of the rule.
int hvd_matmul_bn_stats_block_n(int n) { return block_n(n); }

// The largest M one launch covers: M is an int and so is every row offset.
long long hvd_matmul_bn_stats_max_m() { return 0x7fffffffLL / BM * BM; }

int hvd_matmul_bn_stats_bf16(const void* x, const void* w, void* y, void* p1,
                             void* p2, int M, int K, int N, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* s1 = static_cast<float*>(p1);
  float* s2 = static_cast<float*>(p2);
  return block_n(N) == 64 ? launch<64>(x, w, y, s1, s2, M, K, N, s)
                           : launch<128>(x, w, y, s1, s2, M, K, N, s);
}

}  // extern "C"
