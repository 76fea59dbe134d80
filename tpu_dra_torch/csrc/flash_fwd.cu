// Flash-attention forward for Hopper (sm_90a).
//
// Replaces two TPU kernels of tpu_dra/workloads/pallas_kernels.py:
// _flash_attn_kernel (:151, MHA, reached through _flash_attn_fwd :315) and
// _flash_attn_gqa_kernel (:221, GQA, through _flash_attn_fwd_gqa :268).
// One kernel takes any group size g >= 1: q head-row bh reads kv row bh / g.
//
// Contract (the reference's):
//   q    [BH, S, D]    bf16, NOT pre-scaled: the kernel multiplies each
//                      element by `qscale` (D^-0.5 * log2 e, rounded to
//                      bf16 by the caller as JAX's weak typing does) and
//                      rounds the product to bf16 while loading the tile
//   k, v [BHkv, Sk, D] bf16, BH = g * BHkv; causal needs Sk == S and masks
//                      start-aligned rows >= cols
//   out  [BH, S, D]    bf16 = acc / max(l, 1e-30), so a fully masked row is 0
//   l2   [BH, S]       fp32 base-2 logsumexp m + log2(max(l, 1e-30))
//
// What bounds it at the training path's shapes ([256, 1024, 128], causal):
// q, k, v, out and l2 are ~270 MB, 80 us at 3.35 TB/s; the two S x S
// products under the mask are 68.7 GFLOP, 69 us at 989 TF/s.  Both sides
// are close, so the design keeps every score in registers (no S x S
// tensor in memory) and does both products on the tensor cores.
//
// Design of this first version:
//   * one block of 4 warps per (q head-row, 64-row q tile); each warp owns
//     16 q rows.  Blocks take their q tiles longest-first under the mask.
//   * the q tile's A fragments stay in registers for the whole block; each
//     64-key tile of K and V is copied to shared memory with 16-byte
//     loads (rows past Sk zero-filled) and read back as mma fragments.
//   * S = qs . K^T and O += P . V are mma.sync m16n8k16 bf16 products with
//     fp32 accumulation; the score tile's C fragments become P's A
//     fragments in registers.
//   * online softmax in base 2 per row (m, l over the 4 lanes of a row),
//     with the reference's safe_m pattern: a row masked everywhere so far
//     takes its exponent against 0 and its correction factor is 0, so
//     exp2(neg - neg) never leaks weight.
//   * causal: a block walks k tiles j while j*64 < (i+1)*64, masking only
//     the diagonal tile and the ragged tail past Sk.
// Left for later: wgmma with TMA-fed shared memory rings, ldmatrix for the
// fragment loads, and keeping more than one K/V tile in flight.
//
// Rounding points, pinned here because no output check can see them all:
//   * q is rounded to bf16 after the pre-scale (load_tile<.., true>);
//   * p is rounded to bf16 where the score fragments become P's A
//     fragments (c_to_a below), before P . V; l sums the UNROUNDED p;
//   * out = acc / l is rounded to bf16 once, at the store.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBQ = 64;   // q rows per block, 16 per warp
constexpr int kBK = 64;   // keys per tile

template <int D>
constexpr int fwd_smem_bytes() {
  return (kBQ + 2 * kBK) * Tile<D>::kStride * 2;
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ l2,
                 int S, int Sk, int group, float qscale) {
  using T = Tile<D>;
  constexpr int kDK = D / 16;     // k-steps of q . K^T over D
  constexpr int kDT = D / 8;      // 8-wide output tiles over D
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sQ = smem;
  uint16_t* sK = sQ + kBQ * T::kStride;
  uint16_t* sV = sK + kBK * T::kStride;

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int bh = blockIdx.y;
  const int kvh = bh / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_a = q0 + warp * 16 + (lane >> 2);   // rows g and g + 8
  const int col_t = 2 * (lane & 3);

  const __nv_bfloat16* kb = k + static_cast<size_t>(kvh) * Sk * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(kvh) * Sk * D;

  load_tile<D, true>(sQ, q + static_cast<size_t>(bh) * S * D, q0, S, kBQ,
                     qscale);
  __syncthreads();
  uint32_t qa[kDK][4];
#pragma unroll
  for (int kk = 0; kk < kDK; ++kk)
    load_a(qa[kk], sQ, T::kStride, warp * 16, kk * 16, lane);

  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};      // this lane's share of each row's sum

  const int kv_end = CAUSAL ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();            // every warp is done with the last tile
    load_tile<D, false>(sK, kb, k0, Sk, kBK);
    load_tile<D, false>(sV, vb, k0, Sk, kBK);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        load_b_nk(b0, b1, sK, T::kStride, nt * 8, kk * 16, lane);
        mma(s[nt], qa[kk], b0, b1);
      }
    }

    // mask the ragged tail and, on the diagonal tile, the future
    const bool masked = k0 + kBK > Sk || (CAUSAL && k0 + kBK - 1 > q0);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (masked) {
          const int col = k0 + nt * 8 + col_t + (e & 1);
          const int row = row_a + (e >> 1) * 8;
          if (col >= Sk || (CAUSAL && col > row)) s[nt][e] = kNeg;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float safe[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      safe[r] = m_new == kNeg ? 0.f : m_new;
      corr[r] = m[r] == kNeg ? 0.f : exp2f(m[r] - safe[r]);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[nt][e] == kNeg ? 0.f : exp2f(s[nt][e] - safe[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // p rounded to bf16 here, before P . V
    uint32_t pa[4][4];
    c_to_a<4>(pa, s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        uint32_t b0, b1;
        load_b_kn(b0, b1, sV, T::kStride, kk * 16, dt * 8, lane);
        mma(acc[dt], pa[kk], b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    const float lr = fmaxf(quad_sum(l[r]), 1e-30f);
    if (row < S) {
      __nv_bfloat16* o = out + (static_cast<size_t>(bh) * S + row) * D + col_t;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<uint32_t*>(o + dt * 8) =
            pack_bf16(acc[dt][2 * r] / lr, acc[dt][2 * r + 1] / lr);
      if ((lane & 3) == 0)
        l2[static_cast<size_t>(bh) * S + row] = m[r] + log2f(lr);
    }
  }
}

template <int D, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* l2, int BH, int S, int Sk, int group, float qscale,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D, CAUSAL>;
  constexpr int bytes = fwd_smem_bytes<D>();
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(l2), S, Sk, group, qscale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns the cudaError_t of the
// launch; 0 means the kernel was enqueued on `stream`.
extern "C" int tpu_dra_flash_fwd(const void* q, const void* k, const void* v,
                                 void* out, void* l2, int BH, int BHkv, int S,
                                 int Sk, int D, int causal, float qscale,
                                 void* stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv != 0 || S <= 0 || Sk <= 0 ||
      BH > 65535 || (causal && S != Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = BH / BHkv;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64)
    err = causal ? launch<64, true>(q, k, v, out, l2, BH, S, Sk, group, qscale, st)
                 : launch<64, false>(q, k, v, out, l2, BH, S, Sk, group, qscale, st);
  else if (D == 128)
    err = causal ? launch<128, true>(q, k, v, out, l2, BH, S, Sk, group, qscale, st)
                 : launch<128, false>(q, k, v, out, l2, BH, S, Sk, group, qscale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* tpu_dra_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
