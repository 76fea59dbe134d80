// Flash-attention backward for Hopper (sm_90a): the split pair and the
// single-pass (fused) kernel.
//
// Replaces three TPU kernels of tpu_dra/workloads/pallas_kernels.py, all
// reached through _flash_attn_bwd (:543):
//   * _flash_bwd_dq_kernel (:367), called at :661  -> flash_bwd_dq_kernel
//   * _flash_bwd_dkdv_kernel (:453), called at :682 -> flash_bwd_kv_kernel
//     with FUSED = false                      (both bwd_impl="split")
//   * _flash_bwd_fused_kernel (:494), called at :633 -> flash_bwd_kv_kernel
//     with FUSED = true                       (bwd_impl="fused")
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
// In the split pair no block writes what another block writes: dq is summed
// in registers over the block's own k tiles, dk/dv over its own q tiles.
//
// The fused kernel is the dK/dV kernel plus dq from the same recompute:
//   slot[t] = bf16(dS) . k      fp32, one slot per 64-key tile t (block),
// stored, not added: no two blocks write one element.  Under the causal
// mask tile t's queries start at row 64 t, so its slot holds only rows
// [64 t, S) (slot_base); the slots of the training path's [256, 1024, 128]
// take 1.14 GB where 16 full slots would take 2.15 GB.  A second kernel
// (finish_dq_kernel, launched from the same C entry) then sums, for each
// reference k block j (key / kv_block; its dq partials are [BH, n_j, S, D],
// one per block of bk_kv = 1024 keys at the training path's shapes), the
// slots of j's tiles in key order in fp32, and forms
// dq = bf16(sum_j f32(bf16(partial_j)) * scale), the reference's rounding
// points (:450, :658), in one pass.  The TPU kernel writes each (j, i)
// step's partial to its own slot because its grid runs j outside i; here
// every tile keeps its own slot and the sum runs in a fixed order, so the
// fused path is bit-reproducible from run to run, as the split pair is.
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
// Fused at the same shape: dk, dv and dq from one recompute, five
// products, 172 GFLOP, 174 us at 989 TF/s; ~470 MB (dq written once in
// bf16), 140 us: operations.  Per 32-row q tile the block stages bf16(dS)
// in shared memory as [query][key] and each warp multiplies it by the
// resident k tile for D / 4 of dq's columns, then stores the [32, D / 4]
// result into the tile's slot.
// Left for later: wgmma/TMA, ldmatrix fragment loads.
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

constexpr int kDSS = kBK + 8;  // fused: smem row stride of the dS tile

// fused: where the dq slot of 64-key tile t starts in the scratch, and its
// first row (slot t holds rows [lo, S) of every q head-row)
template <bool CAUSAL>
__device__ __forceinline__ size_t slot_base(int t, int BH, int S, int D) {
  const long long rows_before =
      CAUSAL ? static_cast<long long>(t) * S - 32LL * t * (t - 1)
             : static_cast<long long>(t) * S;
  return static_cast<size_t>(rows_before) * BH * D;
}

template <bool CAUSAL>
__device__ __forceinline__ int slot_lo(int t) {
  return CAUSAL ? t * kBK : 0;
}

template <int D, bool FUSED>
constexpr int kv_smem_bytes() {
  return (2 * kBK + 2 * kBQ2) * Tile<D>::kStride * 2 + 2 * kBQ2 * 4 +
         (FUSED ? kBQ2 * kDSS * 2 : 0);
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

template <int D, bool CAUSAL, bool FUSED>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_kernel(const __nv_bfloat16* __restrict__ qs,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ l2,
                    const float* __restrict__ dd,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv,
                    float* __restrict__ dqacc, int S, int Sk, int group) {
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
  uint16_t* sDS = reinterpret_cast<uint16_t*>(sDD + kBQ2);  // fused: [q][key]

  const int k0 = blockIdx.x * kBK;
  const int bh = blockIdx.y;
  const int kvh = bh / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key_a = k0 + warp * 16 + (lane >> 2);    // keys g and g + 8
  const int col_t = 2 * (lane & 3);
  const size_t qoff = static_cast<size_t>(bh) * S;
  // fused: this block's own dq slot, at its head-row's first row
  const int lo = slot_lo<CAUSAL>(blockIdx.x);
  float* dqb = FUSED ? dqacc + slot_base<CAUSAL>(blockIdx.x, gridDim.y, S, D) +
                           static_cast<size_t>(bh) * (S - lo) * D
                     : nullptr;

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
        const bool keep = q0 + qi < S && (!CAUSAL || q0 + qi >= key) &&
                          (!FUSED || key < Sk);
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
    if constexpr (FUSED) {
      // bf16(dS) into shared memory as [query][key]: register kk of da
      // holds (key g, queries 16kk + 2t, +1), (key g + 8, same queries),
      // (key g, queries + 8), (key g + 8, queries + 8)
      const int key_l = warp * 16 + (lane >> 2);
#pragma unroll
      for (int kk = 0; kk < kBQ2 / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qrow = kk * 16 + col_t + 8 * (e >> 1);
          const int key = key_l + 8 * (e & 1);
          sDS[qrow * kDSS + key] = static_cast<uint16_t>(da[kk][e] & 0xffffu);
          sDS[(qrow + 1) * kDSS + key] = static_cast<uint16_t>(da[kk][e] >> 16);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBQ2 / 16; ++kk) {
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        uint32_t b0, b1;
        load_b_kn(b0, b1, sQ, T::kStride, kk * 16, dt * 8, lane);
        mma(dka[dt], da[kk], b0, b1);
      }
    }

    if constexpr (FUSED) {
      // slot rows [q0, q0 + 32) = bf16(dS) . k over this block's 64 keys;
      // warp w takes dq columns [w * D / 4, (w + 1) * D / 4)
      constexpr int kQT = D / 32;      // 8-wide dq column tiles per warp
      const int c0 = warp * (D / 4);
      __syncthreads();
#pragma unroll
      for (int mt = 0; mt < kBQ2 / 16; ++mt) {
        float acc[kQT][4];
#pragma unroll
        for (int nt = 0; nt < kQT; ++nt)
          acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          uint32_t a[4];
          load_a(a, sDS, kDSS, mt * 16, kk * 16, lane);
#pragma unroll
          for (int nt = 0; nt < kQT; ++nt) {
            uint32_t b0, b1;
            load_b_kn(b0, b1, sK, T::kStride, kk * 16, c0 + nt * 8, lane);
            mma(acc[nt], a, b0, b1);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + mt * 16 + (lane >> 2) + 8 * r;
          if (row >= S) continue;
          float* dst = dqb + static_cast<size_t>(row - lo) * D + c0 + col_t;
#pragma unroll
          for (int nt = 0; nt < kQT; ++nt)
            *reinterpret_cast<float2*>(dst + nt * 8) =
                make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
        }
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

template <int D, bool CAUSAL, bool FUSED>
cudaError_t launch_kv(const void* qs, const void* k, const void* v,
                      const void* dout, const void* l2, const void* dd,
                      void* dk, void* dv, void* dqacc, int BH, int S, int Sk,
                      int group, cudaStream_t stream) {
  auto kernel = flash_bwd_kv_kernel<D, CAUSAL, FUSED>;
  constexpr int bytes = kv_smem_bytes<D, FUSED>();
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + kBK - 1) / kBK, BH);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(qs), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(l2), static_cast<const float*>(dd),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      static_cast<float*>(dqacc), S, Sk, group);
  return cudaGetLastError();
}

// dq = bf16(sum_j f32(bf16(partial_j)) * scale) over BH * S * D elements,
// four per thread (D is 64 or 128), where partial_j sums the slots of k
// block j's tiles (`per_j` of them, n_t in all) in key order in fp32
template <bool CAUSAL>
__global__ void __launch_bounds__(256)
finish_dq_kernel(const float* __restrict__ slots,
                 __nv_bfloat16* __restrict__ dq, int BH, int S, int D,
                 int n_t, int per_j, float scale) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) * 4;
  if (i >= static_cast<size_t>(BH) * S * D) return;
  const int bh = static_cast<int>(i / (static_cast<size_t>(S) * D));
  const int row = static_cast<int>(i / D % S), col = static_cast<int>(i % D);
  // under the mask, tiles past the row's own hold nothing of it
  const int last = CAUSAL ? min(n_t, row / kBK + 1) : n_t;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t0 = 0; t0 < n_t; t0 += per_j) {
    float p[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t = t0; t < min(t0 + per_j, last); ++t) {
      const int lo = slot_lo<CAUSAL>(t);
      const float4 a = *reinterpret_cast<const float4*>(
          slots + slot_base<CAUSAL>(t, BH, S, D) +
          (static_cast<size_t>(bh) * (S - lo) + row - lo) * D + col);
      p[0] += a.x;
      p[1] += a.y;
      p[2] += a.z;
      p[3] += a.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[e] += __bfloat162float(__float2bfloat16_rn(p[e]));
  }
  uint2 out;
  out.x = pack_bf16(s[0] * scale, s[1] * scale);
  out.y = pack_bf16(s[2] * scale, s[3] * scale);
  *reinterpret_cast<uint2*>(dq + i) = out;
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
    err = causal ? launch_kv<64, true, false>(qs, k, v, dout, l2, dd, dk, dv, nullptr, BH, S, Sk, g, st)
                 : launch_kv<64, false, false>(qs, k, v, dout, l2, dd, dk, dv, nullptr, BH, S, Sk, g, st);
  else if (D == 128)
    err = causal ? launch_kv<128, true, false>(qs, k, v, dout, l2, dd, dk, dv, nullptr, BH, S, Sk, g, st)
                 : launch_kv<128, false, false>(qs, k, v, dout, l2, dd, dk, dv, nullptr, BH, S, Sk, g, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The fused kernel: dk, dv as tpu_dra_flash_bwd_dkdv, and dq's unscaled fp32
// sums per 64-key tile stored into dqacc (scratch of ceil(Sk / 64) slots,
// slot t [BH, S - lo, D] with lo = 64 t under the causal mask, else 0;
// the caller allocates it, uninitialised), then dq [BH, S, D] bf16 from
// them with `scale` = D^-0.5; kv_block is a positive multiple of 64.
extern "C" int tpu_dra_flash_bwd_fused(const void* qs, const void* k,
                                       const void* v, const void* dout,
                                       const void* l2, const void* dd,
                                       void* dk, void* dv, void* dqacc,
                                       void* dq, int BH, int BHkv, int S,
                                       int Sk, int D, int causal, int kv_block,
                                       float scale, void* stream) {
  if (bad_shape(BH, BHkv, S, Sk, causal) || kv_block <= 0 || kv_block % kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = BH / BHkv;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64)
    err = causal ? launch_kv<64, true, true>(qs, k, v, dout, l2, dd, dk, dv, dqacc, BH, S, Sk, g, st)
                 : launch_kv<64, false, true>(qs, k, v, dout, l2, dd, dk, dv, dqacc, BH, S, Sk, g, st);
  else if (D == 128)
    err = causal ? launch_kv<128, true, true>(qs, k, v, dout, l2, dd, dk, dv, dqacc, BH, S, Sk, g, st)
                 : launch_kv<128, false, true>(qs, k, v, dout, l2, dd, dk, dv, dqacc, BH, S, Sk, g, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(BH) * S * D;
  const unsigned blocks = static_cast<unsigned>((n / 4 + 255) / 256);
  const int n_t = (Sk + kBK - 1) / kBK, per_j = kv_block / kBK;
  const auto* slots = static_cast<const float*>(dqacc);
  auto* out = static_cast<__nv_bfloat16*>(dq);
  if (causal)
    finish_dq_kernel<true><<<blocks, 256, 0, st>>>(slots, out, BH, S, D, n_t,
                                                  per_j, scale);
  else
    finish_dq_kernel<false><<<blocks, 256, 0, st>>>(slots, out, BH, S, D, n_t,
                                                   per_j, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpu_dra_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
