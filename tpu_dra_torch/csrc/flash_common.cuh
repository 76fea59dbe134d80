// Small helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu) and the mma.sync GEMM mainloop of gemm_common.cuh: the
// masked-score value, 2^x on the special-function unit, bf16 packing, the
// row reductions of a wgmma / mma accumulator fragment, one mma.sync
// product, the persistent walk of q-tile pairs, and the shared-memory
// attribute of a launch.
//
// mma.sync.m16n8k16 (row.col) fragments for bf16 operands with fp32
// accumulation; lane = 4 * g + t (g = lane / 4, t = lane % 4):
//   A (16x16, row major)  a[0] = (g,   2t..2t+1)   a[1] = (g+8, 2t..2t+1)
//                         a[2] = (g, 2t+8..2t+9)   a[3] = (g+8, 2t+8..)
//   B (16x8, k x n)       b0 = (k 2t..2t+1,  n g)  b1 = (k 2t+8..2t+9, n g)
//   C (16x8, fp32)        c[0..1] = (g, 2t..2t+1)  c[2..3] = (g+8, 2t..)
// Each register holds two bf16 values, the lower index in the low half.
// The 4 lanes that share g hold one row of an accumulator, in this layout
// and in wgmma's (hopper.cuh), so quad_sum / quad_max reduce a row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace flash {

constexpr float kNeg = -FLT_MAX;
constexpr double kLog2e = 1.4426950408889634;

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (ex2.approx.ftz: 2 ulp, subnormal
// results flushed to 0); a masked score, -FLT_MAX minus a finite max,
// gives exactly 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// The q tiles of this block of a persistent grid, in order: f(bh, qt) for
// the tiles of each of its work items, the round robin over [BH,
// ceil(n_qt / 2)] items, each a pair of one head-row's q tiles: the
// longest and the shortest left under the causal mask, so every item
// costs about as many k tiles
template <typename F>
__device__ __forceinline__ void for_each_tile(int n_qt, int BH, F&& f) {
  const int n_pairs = (n_qt + 1) / 2;
  for (int w = blockIdx.x; w < BH * n_pairs; w += gridDim.x) {
    const int bh = w / n_pairs, p = w % n_pairs;
    f(bh, n_qt - 1 - p);
    if (p != n_qt - 1 - p) f(bh, p);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace flash
