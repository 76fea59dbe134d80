// Flash-attention backward for Hopper (sm_90a): the split pair.
//
// Replaces two TPU kernels of tpu_dra/workloads/pallas_kernels.py, both
// reached through _flash_attn_bwd (:543) with bwd_impl="split":
//   * _flash_bwd_dq_kernel (:367), called at :661  -> flash_bwd_dq_kernel
//   * _flash_bwd_dkdv_kernel (:453), called at :682 -> flash_bwd_dkdv_kernel
// Each recomputes its score tiles from the saved base-2 logsumexp instead
// of keeping an S x S probability matrix.
//
// Contract (the reference's):
//   qs     [BH, S, D]    bf16, q pre-scaled by D^-0.5 * log2 e and rounded
//                        to bf16 (the caller computes it once for both)
//   k, v   [BHkv, Sk, D] bf16; q head-row bh reads kv row bh / g
//   dout   [BH, S, D]    bf16 cotangent of out
//   l2, dd [BH, S]       fp32: the forward's l2, and rowsum(dout * out)
//   P  = exp2(qs . k^T - l2), 0 where masked (causal: start-aligned rows
//        >= cols, Sk == S; and past the ragged ends)
//   dS = P * (dout . v^T - dd), rounded to bf16 before both of its products
//   dq = (dS . k) * scale               scale = D^-0.5, on the fp32 sum
//   dv = bf16(P)^T . dout               per q head-row
//   dk = (dS^T . qs) * (1 / log2 e)     per q head-row, on the fp32 sum
// For GQA (g > 1) dk/dv come out per q head-row [BH, Sk, D], rounded to
// bf16, and the caller sums each group in fp32, as the reference does.
// No block writes what another block writes: dq is summed in registers
// over the block's own k tiles, dk/dv over its own q tiles; no atomics.
//
// What bounds them at the training path's shapes ([256, 1024, 128] causal):
//   dq:   qs, k, v, dout, dq (+ l2, dd)  ~337 MB, 101 us at 3.35 TB/s;
//         three S x S products under the mask, 103 GFLOP, 104 us at
//         989 TF/s: bound ~104 us, on the operations side.
//   dkdv: qs, k, v, dout, dk, dv (+ l2, dd) ~403 MB, 120 us; four
//         products, 137 GFLOP, 139 us: bound ~139 us, operations.
// So the design keeps every score tile in registers and runs every product
// on the tensor cores; what it leaves on the table is in the notes below.
//
// Design of this first version (shared with flash_fwd.cu):
//   * dq: one block of 4 warps per (q head-row, 64-row q tile), 16 q rows
//     per warp; the qs and dout tiles stay in shared memory, 64-key tiles
//     of K and V stream through it; the accumulator stays in registers.
//     Under the mask a block walks k tiles j while j*64 < (i+1)*64.
//   * dkdv: one block of 4 warps per (q head-row, 64-key tile), 16 keys per
//     warp, computing in the transposed orientation (P^T from k . qs^T, as
//     the TPU kernel does); 32-row tiles of qs, dout, l2 and dd stream
//     through shared memory from the diagonal down (under the mask a block
//     starts at the q tile that holds its first key); both accumulators
//     stay in registers.
//   * all products are mma.sync m16n8k16 bf16 with fp32 accumulation.
// Left for later: the single-pass kernel that shares one recompute between
// dq and dk/dv (TPU row #5), wgmma/TMA, ldmatrix fragment loads.
//
// Rounding points, pinned here (no output check sees all of them): qs is
// rounded by the caller; bf16(P) feeds dv while dS uses the fp32 P; dS is
// rounded to bf16 where its C fragments become A fragments (c_to_a);
// dq's scale and dk's 1/log2 e multiply the fp32 accumulators before the
// single rounding to bf16 at the store.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBQ = 64;       // dq: q rows per block (16 per warp)
constexpr int kBK = 64;       // dq: keys per tile; dkdv: keys per block
constexpr int kBQ2 = 32;      // dkdv: q rows per streamed tile
constexpr float kInvLog2e = static_cast<float>(1.0 / kLog2e);

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * kBQ + 2 * kBK) * Tile<D>::kStride * 2;
}

template <int D>
constexpr int dkdv_smem_bytes() {
  return (2 * kBK + 2 * kBQ2) * Tile<D>::kStride * 2 + 2 * kBQ2 * 4;
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ qs,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ l2, const float* __restrict__ dd,
                    __nv_bfloat16* __restrict__ dq, int S, int Sk, int group,
                    float scale) {
  using T = Tile<D>;
  constexpr int kDK = D / 16;
  constexpr int kDT = D / 8;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sQ = smem;
  uint16_t* sO = sQ + kBQ * T::kStride;      // dout tile
  uint16_t* sK = sO + kBQ * T::kStride;
  uint16_t* sV = sK + kBK * T::kStride;

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int bh = blockIdx.y;
  const int kvh = bh / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_a = q0 + warp * 16 + (lane >> 2);
  const int col_t = 2 * (lane & 3);
  const size_t qoff = static_cast<size_t>(bh) * S;

  load_tile<D, false>(sQ, qs + qoff * D, q0, S, kBQ);
  load_tile<D, false>(sO, dout + qoff * D, q0, S, kBQ);
  float l2r[2], ddr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    l2r[r] = row < S ? l2[qoff + row] : 0.f;
    ddr[r] = row < S ? dd[qoff + row] : 0.f;
  }
  const __nv_bfloat16* kb = k + static_cast<size_t>(kvh) * Sk * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(kvh) * Sk * D;

  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int kv_end = CAUSAL ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();
    load_tile<D, false>(sK, kb, k0, Sk, kBK);
    load_tile<D, false>(sV, vb, k0, Sk, kBK);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      uint32_t a[4], o[4];
      load_a(a, sQ, T::kStride, warp * 16, kk * 16, lane);
      load_a(o, sO, T::kStride, warp * 16, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        load_b_nk(b0, b1, sK, T::kStride, nt * 8, kk * 16, lane);
        mma(s[nt], a, b0, b1);              // qs . K^T
        load_b_nk(b0, b1, sV, T::kStride, nt * 8, kk * 16, lane);
        mma(dp[nt], o, b0, b1);             // dout . V^T
      }
    }

    const bool masked = k0 + kBK > Sk || (CAUSAL && k0 + kBK - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        bool keep = true;
        if (masked) {
          const int col = k0 + nt * 8 + col_t + (e & 1);
          keep = col < Sk && (!CAUSAL || col <= row_a + 8 * r);
        }
        const float p = keep ? exp2f(s[nt][e] - l2r[r]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - ddr[r]);     // dS, fp32
      }
    }
    // dS rounded to bf16 here, before dS . K
    uint32_t da[4][4];
    c_to_a<4>(da, s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        uint32_t b0, b1;
        load_b_kn(b0, b1, sK, T::kStride, kk * 16, dt * 8, lane);
        mma(acc[dt], da[kk], b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* o = dq + (qoff + row) * D + col_t;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      *reinterpret_cast<uint32_t*>(o + dt * 8) =
          pack_bf16(acc[dt][2 * r] * scale, acc[dt][2 * r + 1] * scale);
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ qs,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ l2,
                      const float* __restrict__ dd,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int S, int Sk,
                      int group) {
  using T = Tile<D>;
  constexpr int kDK = D / 16;
  constexpr int kDT = D / 8;
  constexpr int kNT = kBQ2 / 8;     // 8-wide query tiles per streamed tile
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sK = smem;
  uint16_t* sV = sK + kBK * T::kStride;
  uint16_t* sQ = sV + kBK * T::kStride;
  uint16_t* sO = sQ + kBQ2 * T::kStride;     // dout tile
  float* sL2 = reinterpret_cast<float*>(sO + kBQ2 * T::kStride);
  float* sDD = sL2 + kBQ2;

  const int k0 = blockIdx.x * kBK;
  const int bh = blockIdx.y;
  const int kvh = bh / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key_a = k0 + warp * 16 + (lane >> 2);    // keys g and g + 8
  const int col_t = 2 * (lane & 3);
  const size_t qoff = static_cast<size_t>(bh) * S;

  load_tile<D, false>(sK, k + static_cast<size_t>(kvh) * Sk * D, k0, Sk, kBK);
  load_tile<D, false>(sV, v + static_cast<size_t>(kvh) * Sk * D, k0, Sk, kBK);

  float dka[kDT][4], dva[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

  // under the mask, q rows before k0 see none of this block's keys
  for (int q0 = CAUSAL ? k0 : 0; q0 < S; q0 += kBQ2) {
    __syncthreads();
    load_tile<D, false>(sQ, qs + qoff * D, q0, S, kBQ2);
    load_tile<D, false>(sO, dout + qoff * D, q0, S, kBQ2);
    load_vec(sL2, l2 + qoff, q0, S, kBQ2);
    load_vec(sDD, dd + qoff, q0, S, kBQ2);
    __syncthreads();

    // P^T = exp2(k . qs^T - l2), 16 keys x 32 queries per warp
    float p[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      uint32_t a[4];
      load_a(a, sK, T::kStride, warp * 16, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t b0, b1;
        load_b_nk(b0, b1, sQ, T::kStride, nt * 8, kk * 16, lane);
        mma(p[nt], a, b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + col_t + (e & 1);      // query within tile
        const int key = key_a + 8 * (e >> 1);
        const bool keep = q0 + qi < S && (!CAUSAL || q0 + qi >= key);
        p[nt][e] = keep ? exp2f(p[nt][e] - sL2[qi]) : 0.f;
      }
    }

    // dV += bf16(P^T) . dout
    uint32_t pa[kBQ2 / 16][4];
    c_to_a<kBQ2 / 16>(pa, p);
#pragma unroll
    for (int kk = 0; kk < kBQ2 / 16; ++kk) {
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        uint32_t b0, b1;
        load_b_kn(b0, b1, sO, T::kStride, kk * 16, dt * 8, lane);
        mma(dva[dt], pa[kk], b0, b1);
      }
    }

    // dS^T = P^T * (v . dout^T - dd), with the fp32 P^T
    float ds[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) ds[nt][0] = ds[nt][1] = ds[nt][2] = ds[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      uint32_t a[4];
      load_a(a, sV, T::kStride, warp * 16, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t b0, b1;
        load_b_nk(b0, b1, sO, T::kStride, nt * 8, kk * 16, lane);
        mma(ds[nt], a, b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[nt][e] = p[nt][e] * (ds[nt][e] - sDD[nt * 8 + col_t + (e & 1)]);

    // dK += bf16(dS^T) . qs
    uint32_t da[kBQ2 / 16][4];
    c_to_a<kBQ2 / 16>(da, ds);
#pragma unroll
    for (int kk = 0; kk < kBQ2 / 16; ++kk) {
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        uint32_t b0, b1;
        load_b_kn(b0, b1, sQ, T::kStride, kk * 16, dt * 8, lane);
        mma(dka[dt], da[kk], b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + 8 * r;
    if (key >= Sk) continue;
    const size_t off = (static_cast<size_t>(bh) * Sk + key) * D + col_t;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + off + dt * 8) = pack_bf16(
          dka[dt][2 * r] * kInvLog2e, dka[dt][2 * r + 1] * kInvLog2e);
      *reinterpret_cast<uint32_t*>(dv + off + dt * 8) =
          pack_bf16(dva[dt][2 * r], dva[dt][2 * r + 1]);
    }
  }
}

template <int D, bool CAUSAL>
cudaError_t launch_dq(const void* qs, const void* k, const void* v,
                      const void* dout, const void* l2, const void* dd,
                      void* dq, int BH, int S, int Sk, int group, float scale,
                      cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<D, CAUSAL>;
  constexpr int bytes = dq_smem_bytes<D>();
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(qs), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(l2), static_cast<const float*>(dd),
      static_cast<__nv_bfloat16*>(dq), S, Sk, group, scale);
  return cudaGetLastError();
}

template <int D, bool CAUSAL>
cudaError_t launch_dkdv(const void* qs, const void* k, const void* v,
                        const void* dout, const void* l2, const void* dd,
                        void* dk, void* dv, int BH, int S, int Sk, int group,
                        cudaStream_t stream) {
  auto kernel = flash_bwd_dkdv_kernel<D, CAUSAL>;
  constexpr int bytes = dkdv_smem_bytes<D>();
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + kBK - 1) / kBK, BH);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(qs), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(l2), static_cast<const float*>(dd),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, Sk,
      group);
  return cudaGetLastError();
}

bool bad_shape(int BH, int BHkv, int S, int Sk, int causal) {
  return BH <= 0 || BHkv <= 0 || BH % BHkv != 0 || S <= 0 || Sk <= 0 ||
         BH > 65535 || (causal && S != Sk);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns the cudaError_t
// of its launch; 0 means the kernel was enqueued on `stream`.
extern "C" int tpu_dra_flash_bwd_dq(const void* qs, const void* k,
                                    const void* v, const void* dout,
                                    const void* l2, const void* dd, void* dq,
                                    int BH, int BHkv, int S, int Sk, int D,
                                    int causal, float scale, void* stream) {
  if (bad_shape(BH, BHkv, S, Sk, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = BH / BHkv;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64)
    err = causal ? launch_dq<64, true>(qs, k, v, dout, l2, dd, dq, BH, S, Sk, g, scale, st)
                 : launch_dq<64, false>(qs, k, v, dout, l2, dd, dq, BH, S, Sk, g, scale, st);
  else if (D == 128)
    err = causal ? launch_dq<128, true>(qs, k, v, dout, l2, dd, dq, BH, S, Sk, g, scale, st)
                 : launch_dq<128, false>(qs, k, v, dout, l2, dd, dq, BH, S, Sk, g, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" int tpu_dra_flash_bwd_dkdv(const void* qs, const void* k,
                                      const void* v, const void* dout,
                                      const void* l2, const void* dd,
                                      void* dk, void* dv, int BH, int BHkv,
                                      int S, int Sk, int D, int causal,
                                      void* stream) {
  if (bad_shape(BH, BHkv, S, Sk, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = BH / BHkv;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64)
    err = causal ? launch_dkdv<64, true>(qs, k, v, dout, l2, dd, dk, dv, BH, S, Sk, g, st)
                 : launch_dkdv<64, false>(qs, k, v, dout, l2, dd, dk, dv, BH, S, Sk, g, st);
  else if (D == 128)
    err = causal ? launch_dkdv<128, true>(qs, k, v, dout, l2, dd, dk, dv, BH, S, Sk, g, st)
                 : launch_dkdv<128, false>(qs, k, v, dout, l2, dd, dk, dv, BH, S, Sk, g, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* tpu_dra_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
