// Tiled bf16 matrix products for Hopper (sm_90a), both on the TMA-fed
// wgmma mainloop of gemm_sm90.cuh: the plain matmul, and the matmul with
// an RMSNorm applied to x on its way in.
//
// Replaces two TPU kernels of tpu_dra/workloads/pallas_kernels.py:
//   * _matmul_kernel (:57), called at :89 by matmul (:75)
//       -> matmul_sm90_kernel, C entry tpu_dra_matmul
//   * _fused_rmsnorm_matmul_kernel (:863), called at :947 by
//     fused_rmsnorm_matmul (:933), the forward of rmsnorm_matmul_train (:887)
//       -> rownorm_kernel, then matmul_sm90_kernel on the normed x it wrote,
//          C entry tpu_dra_rmsnorm_matmul
//
// Contract (the reference's):
//   x [M, K] bf16 and w [K, N] bf16, both row-major; out [M, N] bf16;
//   out[m, n] = bf16(sum_k a[m, k] * w[k, n]), the sum in fp32, where
//     a = x                                         (matmul)
//     a = bf16((x_f32 * r[m]) * gamma[k])           (rmsnorm_matmul)
//     r[m] = rsqrt(sum_k x_f32[m, k]^2 / K + eps),   gamma fp32 [K].
//   normed is rounded to bf16 before the product, as the reference rounds
//   it at :878; the norm is applied to each x element in that order, so
//   that rounding point is kept exactly.  K and N are multiples
//   of 8 (16-byte rows); M is any; ragged tile edges are zero-filled on
//   load and masked on store.
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
// rmsnorm_matmul needs each row's r before the row's first product, where
// the TPU kernel holds a whole [bm, K] row block in VMEM (512 KB at K =
// 2048, more than the 227 KB of shared memory a block can have).  So it is
// two kernels: rownorm_kernel (one warp per row, an fp32 pass over K)
// reads x, writes r [M] to a scratch vector and normed x, bf16 [M, K], to
// a second scratch, and the plain matmul multiplies the normed x by w.
// That moves 2 · M · K · 2 bytes more than a fused kernel (~40 us at
// wqkv), but normalises each x element once, where a kernel fusing the
// norm into the wgmma mainloop normalises it once per 256-wide column
// tile (24 times at wqkv).  Two such fused designs, the norm in the
// consumers' registers ahead of wgmma with A from registers and producer
// warps rewriting each landed x box in place, were slower than this one
// on an H100 (PERF.md §6).

#include "gemm_sm90.cuh"

namespace {

using namespace gemm90;

// --------------------------------------------------------------------------
// matmul on the wgmma mainloop
// --------------------------------------------------------------------------

namespace plain {

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
// the row norms r [M] and normed x
// --------------------------------------------------------------------------

constexpr int kNormRows = 8;                   // rows (warps) a block
constexpr int kNormThreads = kNormRows * 32;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// (x · r) · gamma, pairwise, rounded to bf16: two columns of one row
__device__ __forceinline__ uint32_t norm_pair(uint32_t pair, float r,
                                              float2 g) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pair));
  return pack_bf16((v.x * r) * g.x, (v.y * r) * g.y);
}

// r[m] = rsqrt(sum_k x[m, k]^2 / K + eps) in fp32 and xn[m, :] =
// bf16((x[m, :] · r[m]) · gamma), one warp per row
__global__ void __launch_bounds__(kNormThreads)
rownorm_kernel(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ gamma, float* __restrict__ r,
               __nv_bfloat16* __restrict__ xn, int M, int K, float eps) {
  const int row = blockIdx.x * kNormRows + (threadIdx.x >> 5);
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
  const float rr = rsqrtf(ss / static_cast<float>(K) + eps);
  if (lane == 0) r[row] = rr;
  for (int c = lane * 8; c < K; c += 32 * 8) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    uint32_t* h = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h[e] = norm_pair(h[e], rr, *reinterpret_cast<const float2*>(
                                     gamma + c + 2 * e));
    *reinterpret_cast<uint4*>(xn + static_cast<size_t>(row) * K + c) = v;
  }
}

bool bad_shape(int M, int N, int K) {
  return M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns the cudaError_t
// of its launches; 0 means the kernels were enqueued on `stream`.
extern "C" int tpu_dra_matmul(const void* x, const void* w, void* out, int M,
                              int N, int K, void* stream) {
  if (bad_shape(M, N, K)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(plain::launch(x, w, out, M, N, K,
                                       static_cast<cudaStream_t>(stream)));
}

// r is fp32 scratch [M] and xn bf16 scratch [M, K] that the caller
// allocates; afterwards r holds each row's rsqrt(mean(x^2) + eps) and xn
// the normed x
extern "C" int tpu_dra_rmsnorm_matmul(const void* x, const void* gamma,
                                      const void* w, void* r, void* xn,
                                      void* out, int M, int N, int K,
                                      float eps, void* stream) {
  if (bad_shape(M, N, K)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  rownorm_kernel<<<(M + kNormRows - 1) / kNormRows, kNormThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<float*>(r), static_cast<__nv_bfloat16*>(xn), M, K, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(plain::launch(xn, w, out, M, N, K, st));
}

extern "C" const char* tpu_dra_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
