// Tiled bf16 matrix products for Hopper (sm_90a): the plain matmul on the
// TMA-fed wgmma mainloop of gemm_sm90.cuh, and the matmul with an RMSNorm
// applied to x on its way in, on the mma.sync mainloop of gemm_common.cuh.
//
// Replaces two TPU kernels of tpu_dra/workloads/pallas_kernels.py:
//   * _matmul_kernel (:57), called at :89 by matmul (:75)
//       -> matmul_sm90_kernel, C entry tpu_dra_matmul
//   * _fused_rmsnorm_matmul_kernel (:863), called at :947 by
//     fused_rmsnorm_matmul (:933), the forward of rmsnorm_matmul_train (:887)
//       -> rownorm_kernel then gemm_kernel, C entry tpu_dra_rmsnorm_matmul
//
// Contract (the reference's):
//   x [M, K] bf16 and w [K, N] bf16, both row-major; out [M, N] bf16;
//   out[m, n] = bf16(sum_k a[m, k] * w[k, n]), the sum in fp32, where
//     a = x                                         (matmul)
//     a = bf16((x_f32 * r[m]) * gamma[k])           (rmsnorm_matmul)
//     r[m] = rsqrt(sum_k x_f32[m, k]^2 / K + eps),   gamma fp32 [K].
//   normed is rounded to bf16 before the product, as the reference rounds
//   it at :878; the norm is applied to each staged x tile, so that rounding
//   point is kept exactly.  K and N are multiples of 8 (16-byte rows); M is
//   any; ragged tile edges are zero-filled on load and masked on store.
//
// What bounds them at the paths' shapes:
//   matmul 4096^3 (bench section_pallas_matmul): 137 GFLOP, 139 us at
//     989 TF/s; 100 MB of operands, 30 us at 3.35 TB/s: operations.
//   rmsnorm_matmul [16384, 2048] @ [2048, 6144] (ln1 -> wqkv) and
//     @ [2048, 8192] (ln2 -> w1): 412 and 550 GFLOP, 417 and 556 us;
//     295 and 369 MB, 88 and 110 us: operations.
// So the design runs every product on the tensor cores and keeps the
// operands in shared memory once per tile.
//
// The plain matmul is the simplest client of gemm_sm90.cuh, as the ring
// kernels use it: 128 x 256 output tiles, 4 stages of 64-deep K, clusters
// of 2 blocks on vertically adjacent tiles that multicast each w tile, a
// persistent grid of one block per SM walking the output tiles (row-tile
// pairs outermost, so the blocks in flight share x rows in L2), 5-D tensor
// maps whose three outer axes have size 1, and the fp32 accumulators
// rounded once to bf16 at a masked store.
//
// rmsnorm_matmul, first version (the mma.sync mainloop: one block of 8
// warps per 128 x 128 output tile, K in 32-deep tiles double-buffered
// through registers, ldmatrix feeding mma.sync m16n8k16):
//   * it needs each row's r before the first product, where the TPU kernel
//     holds a whole [bm, K] row block in VMEM (512 KB at K = 2048, more
//     than the 227 KB of shared memory a block can have).  A first kernel
//     (rownorm_kernel, one warp per row, an fp32 pass over K) writes r [M]
//     to a scratch vector; the GEMM block reads its 128 values into shared
//     memory and scales each x tile by r and gamma in fp32 on its way into
//     shared memory.  Both launch from the one C entry.  (A first version
//     computed r in the GEMM block's own prologue: that read the block's
//     rows of x again for every column block of the grid, 48x for wqkv,
//     and cost ~0.9 ms of the 2.36 ms call on an H100; the pre-pass reads
//     x once.)
// Left for later: rmsnorm_matmul on the wgmma mainloop.

#include "gemm_common.cuh"
#include "gemm_sm90.cuh"

namespace {

// --------------------------------------------------------------------------
// matmul on the wgmma mainloop
// --------------------------------------------------------------------------

namespace plain {

using namespace gemm90;
using MatmulConfig = Config<256, 4, 2>;
using C = MatmulConfig;

// Work item w: the cluster's pair of row tiles w / ct (block crank takes
// row tile crank of the pair), column tile w % ct
__global__ void __cluster_dims__(C::kCluster, 1, 1)
__launch_bounds__(kThreads, 1)
matmul_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w,
                   __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) uint8_t raw[];
  const Ring<C> ring = ring_at<C>(raw);
  init_ring(ring, releases<C>(0));
  const int rt = ((M + kBM - 1) / kBM + C::kCluster - 1) / C::kCluster;
  const int ct = (N + C::kBN - 1) / C::kBN;
  const int nk = (K + kBK - 1) / kBK;
  int it = 0;                                   // stages walked
  auto m0_of = [&](int w) { return (w / ct * C::kCluster + ring.crank) * kBM; };
  auto n0_of = [&](int w) { return w % ct * C::kBN; };

  if (threadIdx.x < kWarpgroup) {
    reg_dealloc<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&tm_x);
      prefetch_map(&tm_w);
      for_each_item<C>(rt * ct, [&](int w) {
        produce_tile(ring, it, nk, Operand{&tm_x, 0, 0, 0},
                     Operand{&tm_w, 0, 0, 0}, m0_of(w), n0_of(w));
      });
    }
  } else {
    reg_alloc<C::kConsumerRegs>();
    const Frag f = Frag::mine();
    float acc[C::kBN / 2];
    for_each_item<C>(rt * ct, [&](int w) {
      consume_tile(ring, acc, it, nk, f.c, f.lane);
      const int m0 = m0_of(w), n0 = n0_of(w);
#pragma unroll
      for (int j = 0; j < C::kBN / 8; ++j) {
        const int col = n0 + f.col0 + 8 * j;
        if (col >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + f.row0 + 8 * h;
          if (row < M)
            *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * N +
                                         col) =
                pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    });
  }
  finish_ring<C>();
}

cudaError_t launch(const void* x, const void* w, void* out, int M, int N,
                   int K, cudaStream_t stream) {
  CUtensorMap tm_x, tm_w;
  cudaError_t err;
  if ((err = map_bf16_5d(&tm_x, x, {K, M, 1, 1, 1}, {K, 0, 0, 0}, kBM)) !=
          cudaSuccess ||
      (err = map_bf16_5d(&tm_w, w, {N, K, 1, 1, 1}, {N, 0, 0, 0}, kBK)) !=
          cudaSuccess)
    return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      matmul_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const long long rt =
      ((M + kBM - 1) / kBM + C::kCluster - 1) / C::kCluster;
  int blocks;
  if ((err = grid_blocks<C>(rt * ((N + C::kBN - 1) / C::kBN), &blocks)) !=
      cudaSuccess)
    return err;
  matmul_sm90_kernel<<<blocks, kThreads, C::kSmemBytes, stream>>>(
      tm_x, tm_w, static_cast<__nv_bfloat16*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace plain

// --------------------------------------------------------------------------
// rmsnorm_matmul on the mma.sync mainloop
// --------------------------------------------------------------------------

using namespace gemm;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// r[m] = rsqrt(sum_k x[m, k]^2 / K + eps) in fp32, one warp per row
__global__ void __launch_bounds__(kThreads)
rownorm_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ r,
               int M, int K, float eps) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const __nv_bfloat16* xr = x + static_cast<size_t>(row) * K;
  float ss = 0.f;
  for (int c = lane * 8; c < K; c += 32 * 8) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      ss += f.x * f.x;
      ss += f.y * f.y;
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) r[row] = rsqrtf(ss / static_cast<float>(K) + eps);
}

__global__ void __launch_bounds__(kThreads, 2)
gemm_kernel(const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ w,
            const float* __restrict__ gamma, const float* __restrict__ r,
            __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  __shared__ Smem sm;
  __shared__ float sR[kBM];

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // the block's rows of r (rownorm_kernel), 0 past M
  for (int i = threadIdx.x; i < kBM; i += kThreads)
    sR[i] = m0 + i < M ? r[m0 + i] : 0.f;
  __syncthreads();

  float acc[4][4][4];
  mainloop(acc, sm, x, w, gamma, sR, m0, n0, M, N, K);

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + acc_col(nt);
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + acc_row(mt, h);
        if (row < M)
          *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * N + col) =
              pack_bf16(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
  }
}

bool bad_shape(int M, int N, int K) {
  return M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 ||
         (M + kBM - 1) / kBM > 65535;
}

cudaError_t launch_norm(const void* x, const void* gamma, const void* w,
                        const void* r, void* out, int M, int N, int K,
                        cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(gamma), static_cast<const float*>(r),
      static_cast<__nv_bfloat16*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns the cudaError_t
// of its launch; 0 means the kernel was enqueued on `stream`.
extern "C" int tpu_dra_matmul(const void* x, const void* w, void* out, int M,
                              int N, int K, void* stream) {
  if (bad_shape(M, N, K)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(plain::launch(x, w, out, M, N, K,
                                       static_cast<cudaStream_t>(stream)));
}

// r is fp32 scratch [M] that the caller allocates; it holds each row's
// rsqrt(mean(x^2) + eps) afterwards
extern "C" int tpu_dra_rmsnorm_matmul(const void* x, const void* gamma,
                                      const void* w, void* r, void* out,
                                      int M, int N, int K, float eps,
                                      void* stream) {
  if (bad_shape(M, N, K)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  rownorm_kernel<<<(M + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(r), M, K, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_norm(x, gamma, w, r, out, M, N, K, st));
}

extern "C" const char* tpu_dra_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
