// Building blocks shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): bf16 tensor-core products through mma.sync, fragment
// loads from shared memory, and tile copies from device memory.
//
// Tiles live in shared memory as raw bf16 bits (uint16_t), row-major with
// a row stride of D + 8 elements.  The 16-byte pad keeps every row 16-byte
// aligned for the vector copies and puts the 8 rows a fragment load
// touches on distinct banks.
//
// Fragment layouts are those of mma.sync.m16n8k16 (row.col) for bf16
// operands with fp32 accumulation; lane = 4 * g + t (g = lane / 4,
// t = lane % 4):
//   A (16x16, row major)  a[0] = (g,   2t..2t+1)   a[1] = (g+8, 2t..2t+1)
//                         a[2] = (g, 2t+8..2t+9)   a[3] = (g+8, 2t+8..)
//   B (16x8, k x n)       b0 = (k 2t..2t+1,  n g)  b1 = (k 2t+8..2t+9, n g)
//   C (16x8, fp32)        c[0..1] = (g, 2t..2t+1)  c[2..3] = (g+8, 2t..)
// Each register holds two bf16 values, the lower index in the low half.
// The C fragments of two neighbouring 8-column tiles, rounded to bf16 in
// pairs, are exactly the A fragment of the 16-column block they cover:
// that is how a score tile feeds the next product without leaving
// registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace flash {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -FLT_MAX;
constexpr double kLog2e = 1.4426950408889634;

template <int D>
struct Tile {
  static constexpr int kStride = D + 8;       // bf16 elements per smem row
  static constexpr int kVec = D / 8;          // 16-byte vectors per row
};

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of the 16x16 block at (row0, col0) of a row-major tile
__device__ __forceinline__ void load_a(uint32_t a[4], const uint16_t* s,
                                       int stride, int row0, int col0,
                                       int lane) {
  const uint16_t* p = s + (row0 + (lane >> 2)) * stride + col0 + 2 * (lane & 3);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * stride + 8);
}

// B fragment with B[k][n] = s[n0 + n][k0 + k]: the tile holds B's columns
// as its rows (k contiguous), as K does in Q·Kᵀ
__device__ __forceinline__ void load_b_nk(uint32_t& b0, uint32_t& b1,
                                          const uint16_t* s, int stride,
                                          int n0, int k0, int lane) {
  const uint16_t* p = s + (n0 + (lane >> 2)) * stride + k0 + 2 * (lane & 3);
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B fragment with B[k][n] = s[k0 + k][n0 + n]: the tile holds B's rows
// (n contiguous), as V does in P·V
__device__ __forceinline__ void load_b_kn(uint32_t& b0, uint32_t& b1,
                                          const uint16_t* s, int stride,
                                          int k0, int n0, int lane) {
  const uint16_t* p = s + (k0 + 2 * (lane & 3)) * stride + n0 + (lane >> 2);
  b0 = static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[stride]) << 16);
  b1 = static_cast<uint32_t>(p[8 * stride]) |
       (static_cast<uint32_t>(p[9 * stride]) << 16);
}

// two fp32 values rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments of a 16 x (16 * KSTEPS) block from the C fragments of its
// 2 * KSTEPS 8-column tiles, rounded to bf16
template <int KSTEPS>
__device__ __forceinline__ void c_to_a(uint32_t a[KSTEPS][4],
                                       float c[2 * KSTEPS][4]) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// Rows [row0, row0 + rows) of a [n, D] bf16 matrix into a smem tile; rows
// at or past `n` are zero.  With `scale`, each element becomes
// bf16(float(x) * scale) (q's pre-scale).
template <int D, bool SCALE>
__device__ __forceinline__ void load_tile(uint16_t* s, const __nv_bfloat16* g,
                                          int row0, int n, int rows,
                                          float scale = 1.f) {
  using T = Tile<D>;
  for (int idx = threadIdx.x; idx < rows * T::kVec; idx += kThreads) {
    const int r = idx / T::kVec;
    const int c = (idx % T::kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      val = *reinterpret_cast<const uint4*>(
          g + static_cast<size_t>(row0 + r) * D + c);
      if constexpr (SCALE) {
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          h[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
      }
    }
    *reinterpret_cast<uint4*>(s + r * T::kStride + c) = val;
  }
}

// Rows [row0, row0 + rows) of a length-n fp32 vector into smem; 0 past n.
__device__ __forceinline__ void load_vec(float* s, const float* g, int row0,
                                         int n, int rows) {
  for (int r = threadIdx.x; r < rows; r += kThreads)
    s[r] = row0 + r < n ? g[row0 + r] : 0.f;
}

// The value of `x` summed (or maxed) over the 4 lanes that share a row
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace flash
