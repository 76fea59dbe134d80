// Tiled bf16 matrix product for Hopper (sm_90a), plain and with an RMSNorm
// applied to x on its way in: one mainloop, two entry points.
//
// Replaces two TPU kernels of tpu_dra/workloads/pallas_kernels.py:
//   * _matmul_kernel (:57), called at :89 by matmul (:75)
//       -> gemm_kernel<false>, C entry tpu_dra_matmul
//   * _fused_rmsnorm_matmul_kernel (:863), called at :947 by
//     fused_rmsnorm_matmul (:933), the forward of rmsnorm_matmul_train (:887)
//       -> rownorm_kernel then gemm_kernel<true>, C entry
//          tpu_dra_rmsnorm_matmul
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
// Design of this first version:
//   * one block of 8 warps per 128 x 128 output tile, the warps 2 (M) x 4
//     (N), each warp 64 x 32; K streams in 32-deep tiles through two shared
//     buffers, the next tile's loads in flight (in registers) while the
//     current one is multiplied;
//   * fragments come from shared memory through ldmatrix (.trans for w,
//     whose rows are K), products are mma.sync m16n8k16 bf16 with fp32
//     accumulation; the accumulator is rounded to bf16 once at the store.
//   * rmsnorm_matmul needs each row's r before the first product, where
//     the TPU kernel holds a whole [bm, K] row block in VMEM (512 KB at
//     K = 2048, more than the 227 KB of shared memory a block can have).
//     A first kernel (rownorm_kernel, one warp per row, an fp32 pass over
//     K) writes r [M] to a scratch vector; the GEMM block reads its 128
//     values into shared memory and scales each x tile by r and gamma in
//     fp32 on its way into shared memory.  Both launch from the one C
//     entry.  (A first version computed r in the GEMM block's own
//     prologue: that read the block's rows of x again for every column
//     block of the grid, 48x for wqkv, and cost ~0.9 ms of the 2.36 ms
//     call on an H100; the pre-pass reads x once.)
// Left for later: wgmma fed by TMA rings and a persistent grid.

#include "flash_common.cuh"

namespace {

using flash::mma;
using flash::pack_bf16;

constexpr int kBM = 128;                  // output rows per block
constexpr int kBN = 128;                  // output columns per block
constexpr int kBK = 32;                   // K per staged tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kAS = kBK + 8;              // smem row stride of an x tile
constexpr int kBS = kBN + 8;              // smem row stride of a w tile
constexpr int kAV = kBM * kBK / 8 / kThreads;   // 16-byte vectors a thread
constexpr int kBV = kBK * kBN / 8 / kThreads;   // loads per tile (2 each)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and register i receives matrix i's fragment
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// The same, each matrix transposed on the way (for an operand stored k x n)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4],
                                              const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

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

// The block's x tile at k0 into registers: vector i of this thread is row
// idx / 4, columns (idx % 4) * 8 .. + 7 with idx = tid + i * kThreads;
// zero past M or K
__device__ __forceinline__ void load_x(uint4 v[kAV],
                                       const __nv_bfloat16* __restrict__ x,
                                       int m0, int k0, int M, int K) {
#pragma unroll
  for (int i = 0; i < kAV; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / (kBK / 8), c = (idx % (kBK / 8)) * 8;
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M && k0 + c < K)
      v[i] = *reinterpret_cast<const uint4*>(
          x + static_cast<size_t>(m0 + r) * K + k0 + c);
  }
}

// The block's w tile at k0: row idx / 16, columns (idx % 16) * 8 .. + 7
__device__ __forceinline__ void load_w(uint4 v[kBV],
                                       const __nv_bfloat16* __restrict__ w,
                                       int n0, int k0, int N, int K) {
#pragma unroll
  for (int i = 0; i < kBV; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / (kBN / 8), c = (idx % (kBN / 8)) * 8;
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < K && n0 + c < N)
      v[i] = *reinterpret_cast<const uint4*>(
          w + static_cast<size_t>(k0 + r) * N + n0 + c);
  }
}

// Staged x vectors into shared memory; with NORM each element becomes
// bf16((x * r[row]) * gamma[k]) in fp32 first (the reference's normed)
template <bool NORM>
__device__ __forceinline__ void store_x(uint16_t* s, uint4 v[kAV],
                                        const float* sR,
                                        const float* __restrict__ gamma,
                                        int m0, int k0, int M, int K) {
#pragma unroll
  for (int i = 0; i < kAV; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / (kBK / 8), c = (idx % (kBK / 8)) * 8;
    uint4 val = v[i];
    if constexpr (NORM) {
      if (m0 + r < M && k0 + c < K) {
        const float rr = sR[r];
        const float4 g0 = *reinterpret_cast<const float4*>(gamma + k0 + c);
        const float4 g1 =
            *reinterpret_cast<const float4*>(gamma + k0 + c + 4);
        const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          h[e] = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(f.x, rr), g[2 * e]),
                                       __fmul_rn(__fmul_rn(f.y, rr),
                                                 g[2 * e + 1]));
        }
      }
    }
    *reinterpret_cast<uint4*>(s + r * kAS + c) = val;
  }
}

__device__ __forceinline__ void store_w(uint16_t* s, const uint4 v[kBV]) {
#pragma unroll
  for (int i = 0; i < kBV; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / (kBN / 8), c = (idx % (kBN / 8)) * 8;
    *reinterpret_cast<uint4*>(s + r * kBS + c) = v[i];
  }
}

// acc += the warp's 64 x 32 share of (x tile) . (w tile) over kBK
__device__ __forceinline__ void multiply(float acc[4][4][4],
                                         const uint16_t* sX,
                                         const uint16_t* sW, int wm, int wn,
                                         int lane) {
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;   // ldmatrix row
  const int lcol = (lane >> 4) * 8;                      // ldmatrix column
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      ldsm_x4(a[mt], sX + (wm + mt * 16 + lrow) * kAS + kk + lcol);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      ldsm_x4_trans(r, sW + (kk + lrow) * kBS + wn + np * 16 + lcol);
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

template <bool NORM>
__global__ void __launch_bounds__(kThreads, 2)
gemm_kernel(const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ w,
            const float* __restrict__ gamma, const float* __restrict__ r,
            __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) uint16_t sX[2][kBM * kAS];
  __shared__ __align__(16) uint16_t sW[2][kBK * kBS];
  __shared__ float sR[NORM ? kBM : 1];

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  if constexpr (NORM) {
    // the block's rows of r (rownorm_kernel), 0 past M
    for (int i = threadIdx.x; i < kBM; i += kThreads)
      sR[i] = m0 + i < M ? r[m0 + i] : 0.f;
    __syncthreads();
  }

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  uint4 vx[kAV], vw[kBV];
  const int nk = (K + kBK - 1) / kBK;
  load_x(vx, x, m0, 0, M, K);
  load_w(vw, w, n0, 0, N, K);
  store_x<NORM>(sX[0], vx, sR, gamma, m0, 0, M, K);
  store_w(sW[0], vw);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    const int k1 = (kt + 1) * kBK;
    if (kt + 1 < nk) {                  // next tile's loads in flight
      load_x(vx, x, m0, k1, M, K);
      load_w(vw, w, n0, k1, N, K);
    }
    multiply(acc, sX[buf], sW[buf], wm, wn, lane);
    if (kt + 1 < nk) {
      store_x<NORM>(sX[buf ^ 1], vx, sR, gamma, m0, k1, M, K);
      store_w(sW[buf ^ 1], vw);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn + nt * 8 + 2 * (lane & 3);
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mt * 16 + (lane >> 2) + 8 * h;
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

template <bool NORM>
cudaError_t launch(const void* x, const void* gamma, const void* w,
                   const void* r, void* out, int M, int N, int K,
                   cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<NORM><<<grid, kThreads, 0, stream>>>(
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
  return static_cast<int>(launch<false>(x, nullptr, w, nullptr, out, M, N, K,
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
  return static_cast<int>(launch<true>(x, gamma, w, r, out, M, N, K, st));
}

extern "C" const char* tpu_dra_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
