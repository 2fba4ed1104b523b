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
// Design (the first, simple one).  The TPU kernel walks a sequential (i, j, k)
// grid with a VMEM accumulator carried across k steps.  Here each block owns
// one BM x BN output tile and loops over K itself; the accumulator lives in
// WMMA register fragments.  Each K step stages a BM x BK tile of x and a BK x BN
// tile of w in shared memory with 16-byte loads, zero-filling what lies past
// the ragged edges, so masked rows and columns contribute exactly 0 to both the
// product and the sums (no padding of the inputs).  The epilogue goes fragment
// by fragment through a per-warp shared scratch tile: it writes y (bf16,
// round-to-nearest-even), keeps per-column partial sums in registers, and
// combines the four warps of a column in shared memory in a fixed order.
// No cp.async pipeline, no wgmma/TMA: making it fast is later work.
//
// Bound at the ResNet-50 shapes (batch 128, 224x224, 36 launches per forward):
// about 543 GFLOP per step, 0.55 ms at the H100 SXM's 989 TFLOP/s dense bf16.
// For large M a shape does about K*N/(K+N) FLOP per byte, so every shape with
// K*N/(K+N) under the card's ~295 FLOP/byte ridge (stages 1-2, and the
// (512,256), (256,1024), (1024,256) shapes of stage 3) is bound by bytes at
// 3.35 TB/s; the (K,N) pairs of 512 with 1024 or 2048, and 1024 with 2048,
// by operations.
// chip_smoke.py computes each shape's bound, max(2MKN / 989e12,
// (2(MK + KN + MN) + 8 ceil(M/BM) N) / 3.35e12), and PERF.md lists them.
//
// Interface: plain C, loaded with ctypes.  The caller checks device, dtype,
// shape (K % 8 == 0, N % 8 == 0), contiguity and 16-byte alignment, allocates
// every output, and passes PyTorch's current stream.  The launch returns
// cudaGetLastError() so a refused launch is reported, not silently skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int WARPS_M = 4;
constexpr int WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;  // 32 rows per warp
constexpr int WN = BN / WARPS_N;  // 64 columns per warp
constexpr int FM = WM / 16;       // 2 fragments down
constexpr int FN = WN / 16;       // 4 fragments across
// Row pitches padded by 8 bf16 (16 bytes): keeps every WMMA fragment pointer
// 32-byte aligned and spreads the rows over the shared-memory banks.
constexpr int A_LD = BK + 8;
constexpr int B_LD = BN + 8;

struct __align__(128) Smem {
  __nv_bfloat16 a[BM * A_LD];
  __nv_bfloat16 b[BK * B_LD];
  float scratch[WARPS_M * WARPS_N][16 * 16];
  float red1[WARPS_M][BN];
  float red2[WARPS_M][BN];
};

__global__ void __launch_bounds__(THREADS)
matmul_bn_stats_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       __nv_bfloat16* __restrict__ y,
                       float* __restrict__ p1,
                       float* __restrict__ p2,
                       int M, int K, int N) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: BM x BK, 8 bf16 per 16-byte load.  K % 8 == 0, so a vector is
    // either wholly inside the matrix or wholly past its edge.
    for (int v = tid; v < BM * BK / 8; v += THREADS) {
      const int r = v / (BK / 8);
      const int c = (v % (BK / 8)) * 8;
      const int gm = m0 + r;
      const int gk = k0 + c;
      uint4 val = zero;
      if (gm < M && gk < K)
        val = *reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk);
      *reinterpret_cast<uint4*>(&sm.a[r * A_LD + c]) = val;
    }
    // w tile: BK x BN.
    for (int v = tid; v < BK * BN / 8; v += THREADS) {
      const int r = v / (BN / 8);
      const int c = (v % (BN / 8)) * 8;
      const int gk = k0 + r;
      const int gn = n0 + c;
      uint4 val = zero;
      if (gk < K && gn < N)
        val = *reinterpret_cast<const uint4*>(w + (size_t)gk * N + gn);
      *reinterpret_cast<uint4*>(&sm.b[r * B_LD + c]) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], &sm.a[(wm * WM + i * 16) * A_LD + kk], A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], &sm.b[kk * B_LD + wn * WN + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue.  Lane l owns column (l % 16) of each 16x16 fragment and rows
  // 8*(l / 16) .. 8*(l / 16) + 7 of it.
  float* scr = sm.scratch[warp];
  const int c = lane & 15;
  const int rh = lane >> 4;
  float cs1[FN];
  float cs2[FN];
#pragma unroll
  for (int j = 0; j < FN; ++j) {
    cs1[j] = 0.0f;
    cs2[j] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gn = n0 + wn * WN + j * 16 + c;
      float a1 = 0.0f;
      float a2 = 0.0f;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int lr = rh * 8 + r;
        const int gm = m0 + wm * WM + i * 16 + lr;
        const float v = scr[lr * 16 + c];
        if (gm < M && gn < N) {
          y[(size_t)gm * N + gn] = __float2bfloat16(v);
          a1 += v;
          a2 += v * v;
        }
      }
      a1 += __shfl_down_sync(0xffffffffu, a1, 16);
      a2 += __shfl_down_sync(0xffffffffu, a2, 16);
      cs1[j] += a1;  // meaningful in lanes 0..15
      cs2[j] += a2;
      __syncwarp();
    }
  }
  if (lane < 16) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      sm.red1[wm][wn * WN + j * 16 + lane] = cs1[j];
      sm.red2[wm][wn * WN + j * 16 + lane] = cs2[j];
    }
  }
  __syncthreads();
  if (tid < BN) {
    const int gn = n0 + tid;
    if (gn < N) {
      float t1 = 0.0f;
      float t2 = 0.0f;
#pragma unroll
      for (int r = 0; r < WARPS_M; ++r) {
        t1 += sm.red1[r][tid];
        t2 += sm.red2[r][tid];
      }
      p1[(size_t)blockIdx.y * N + gn] = t1;
      p2[(size_t)blockIdx.y * N + gn] = t2;
    }
  }
}

}  // namespace

extern "C" {

// Rows per block: the partials buffers have ceil(M / BM) rows.
int hvd_matmul_bn_stats_block_m() { return BM; }

// The largest M one launch covers (gridDim.y <= 65535).
long long hvd_matmul_bn_stats_max_m() { return 65535LL * BM; }

int hvd_matmul_bn_stats_bf16(const void* x, const void* w, void* y, void* p1,
                             void* p2, int M, int K, int N, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_bn_stats_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(p1), static_cast<float*>(p2),
      M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
