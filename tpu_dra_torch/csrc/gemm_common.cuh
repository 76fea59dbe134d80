// The tiled bf16 GEMM mainloop of the RMSNorm-matmul (matmul.cu
// tpu_dra_rmsnorm_matmul; the plain matmul and the ring kernels run on
// gemm_sm90.cuh): one block of 8 warps
// per 128 x 128 output tile, the warps 2 (M) x 4 (N), each warp 64 x 32;
// K streams in 32-deep tiles through two shared buffers, the next tile's
// loads in flight (in registers) while the current one is multiplied;
// fragments come from shared memory through ldmatrix (.trans for w, whose
// rows are K), products are mma.sync m16n8k16 bf16 with fp32 accumulation.
//
// x is [M, K] and w is [K, N], both row-major bf16 with K and N multiples
// of 8 (16-byte rows); M is any.  Ragged tile edges are zero-filled on
// load; the caller masks its stores.  The accumulator fragment of lane l
// in warp (wm, wn) holds, for mt, nt < 4 and h < 2, the two columns
//   col = n0 + wn + nt * 8 + 2 * (l % 4) (+1)
// of row m0 + wm + mt * 16 + l / 4 + 8 * h in acc[mt][nt][2h], [2h + 1].

#pragma once

#include "flash_common.cuh"

namespace gemm {

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

// Row and column of vector i of this thread in an x tile (kBM x kBK)
__device__ __forceinline__ int x_row(int i) {
  return (threadIdx.x + i * kThreads) / (kBK / 8);
}
__device__ __forceinline__ int x_col(int i) {
  return ((threadIdx.x + i * kThreads) % (kBK / 8)) * 8;
}

// The block's x tile at k0 into registers: vector i of this thread is row
// x_row(i), columns x_col(i) .. + 7; zero past M or K
__device__ __forceinline__ void load_x(uint4 v[kAV],
                                       const __nv_bfloat16* __restrict__ x,
                                       int m0, int k0, int M, int K) {
#pragma unroll
  for (int i = 0; i < kAV; ++i) {
    const int r = x_row(i), c = x_col(i);
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

// Staged x vectors into shared memory, each element becoming
// bf16((x * r[row]) * gamma[k]) in fp32 first (the reference's normed)
__device__ __forceinline__ void store_x(uint16_t* s, uint4 v[kAV],
                                        const float* sR,
                                        const float* __restrict__ gamma,
                                        int m0, int k0, int M, int K) {
#pragma unroll
  for (int i = 0; i < kAV; ++i) {
    const int r = x_row(i), c = x_col(i);
    uint4 val = v[i];
    if (m0 + r < M && k0 + c < K) {
      const float rr = sR[r];
      const float4 g0 = *reinterpret_cast<const float4*>(gamma + k0 + c);
      const float4 g1 = *reinterpret_cast<const float4*>(gamma + k0 + c + 4);
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

// Shared memory of one GEMM block: two x tiles and two w tiles
struct alignas(16) Smem {
  uint16_t x[2][kBM * kAS];
  uint16_t w[2][kBK * kBS];
};

// The block's 128 x 128 tile of x . w at (m0, n0), into acc (zeroed
// here), x normalised on its way in: sR holds the block's 128 row norms
// and gamma [K] the gains.
__device__ __forceinline__ void mainloop(float acc[4][4][4], Smem& sm,
                                         const __nv_bfloat16* __restrict__ x,
                                         const __nv_bfloat16* __restrict__ w,
                                         const float* __restrict__ gamma,
                                         const float* sR, int m0, int n0,
                                         int M, int N, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
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
  store_x(sm.x[0], vx, sR, gamma, m0, 0, M, K);
  store_w(sm.w[0], vw);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    const int k1 = (kt + 1) * kBK;
    if (kt + 1 < nk) {                  // next tile's loads in flight
      load_x(vx, x, m0, k1, M, K);
      load_w(vw, w, n0, k1, N, K);
    }
    multiply(acc, sm.x[buf], sm.w[buf], wm, wn, lane);
    if (kt + 1 < nk) {
      store_x(sm.x[buf ^ 1], vx, sR, gamma, m0, k1, M, K);
      store_w(sm.w[buf ^ 1], vw);
    }
    __syncthreads();
  }
}

// Row and column of accumulator element (mt, nt, 2h [+1]) of this thread
// in the block's tile (relative to m0, n0)
__device__ __forceinline__ int acc_row(int mt, int h) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp >> 2) * 64 + mt * 16 + (lane >> 2) + 8 * h;
}
__device__ __forceinline__ int acc_col(int nt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp & 3) * 32 + nt * 8 + 2 * (lane & 3);
}

}  // namespace gemm
