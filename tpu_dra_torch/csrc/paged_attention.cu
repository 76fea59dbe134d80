// Paged decode attention for Hopper (sm_90a).
//
// Replaces tpu_dra/workloads/paged_kv.py::paged_attention and its Pallas
// body _paged_attn_kernel: one query token per slot attends the slot's
// context through a block table, online softmax in base 2, GQA groups,
// bf16 pages or int8 pages with per-position fp32 scales.
//
// Contract (same as the reference):
//   q        [B, H, Dh]        bf16, pre-scaled by Dh^-0.5 * log2(e) and
//                              rounded to bf16 by the caller
//   k/v      [Hkv, P, ps, Dh]  bf16, or int8 with k_s/v_s [Hkv, P, ps, 1] fp32
//   table    [B, MP]           int32 page ids, -1 = no page (clamped to
//                              page 0 and removed by the length mask)
//   lengths  [B]               int32 context length, the new token included
//   out      [B, H, Dh]        bf16; a zero-length slot gives zeros
//
// What bounds it: device-memory bytes.  Every live token's K and V row is
// read once (plus q), and each row feeds only the g = H/Hkv query rows of
// its group, about 4 flops per byte at g = 4 — far below the ~295 flops
// per byte where the H100's bf16 tensor cores would become the limit.
//
// Design of this first version, and what it does about that bound:
//   * one block per (slot, kv head); the block walks only the first
//     ceil(len/ps) table entries, so dead pages cost nothing;
//   * 8 warps split the slot's tokens in tiles of 8 consecutive tokens
//     (a tile never crosses a page: ps is a multiple of 8).  A lane owns
//     Dh/32 dimensions; a warp reads a whole K or V row as one coalesced
//     256-byte access at Dh = 128, with 8 rows of a tile in flight;
//   * the group's query rows stay in registers, each K/V element is read
//     from device memory exactly once, so nothing is staged in shared
//     memory; each warp keeps its own online-softmax state (m, l, acc in
//     fp32) and the warps merge through shared memory at the end.
// Left for later: split-K over pages so long contexts and small batches
// fill all 132 SMs (the grid here is only B * Hkv blocks), cp.async/TMA
// double buffering of the page tiles, and the group's rows as a
// tensor-core product instead of warp-shuffle reductions.
//
// Rounding points follow the reference: scores accumulate in fp32 from
// bf16 operands; p is rounded to bf16 before the P.V product; int8 rows
// dequantize as (int8 * scale) rounded to bf16; out = acc / l with l == 0
// treated as 1, cast to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 8;   // consecutive tokens a warp takes per step
constexpr float kNeg = -FLT_MAX;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// DPL consecutive bf16 values → fp32
template <int DPL>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float scale, float* out) {
  if constexpr (DPL == 4) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float2 a = __bfloat1622float2(h2[0]);
    float2 b = __bfloat1622float2(h2[1]);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else if constexpr (DPL == 2) {
    float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x; out[1] = a.y;
  } else {
#pragma unroll
    for (int e = 0; e < DPL; ++e) out[e] = __bfloat162float(p[e]);
  }
}

// DPL consecutive int8 values → (int8 * scale) rounded to bf16, as fp32
template <int DPL>
__device__ __forceinline__ void load_row(const int8_t* p, float scale,
                                         float* out) {
  if constexpr (DPL == 4) {
    char4 c = *reinterpret_cast<const char4*>(p);
    out[0] = round_bf16(static_cast<float>(c.x) * scale);
    out[1] = round_bf16(static_cast<float>(c.y) * scale);
    out[2] = round_bf16(static_cast<float>(c.z) * scale);
    out[3] = round_bf16(static_cast<float>(c.w) * scale);
  } else {
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      out[e] = round_bf16(static_cast<float>(p[e]) * scale);
  }
}

template <int DH, int G, typename T, bool QUANT>
__global__ void __launch_bounds__(kWarps * 32)
paged_attn_kernel(const __nv_bfloat16* __restrict__ q,
                  const T* __restrict__ k_pages,
                  const T* __restrict__ v_pages,
                  const float* __restrict__ k_s,
                  const float* __restrict__ v_s,
                  const int32_t* __restrict__ table,
                  const int32_t* __restrict__ lengths,
                  __nv_bfloat16* __restrict__ out,
                  int H, int P, int ps, int MP) {
  constexpr int DPL = DH / 32;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d0 = lane * DPL;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > MP * ps ? MP * ps : len);

  float qr[G][DPL];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    const __nv_bfloat16* qp = q + (static_cast<size_t>(b) * H + h * G + r) * DH + d0;
#pragma unroll
    for (int e = 0; e < DPL; ++e) qr[r][e] = __bfloat162float(qp[e]);
  }

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }

  const int n_tiles = (len + kTile - 1) / kTile;
  for (int t = warp; t < n_tiles; t += kWarps) {
    const int tok0 = t * kTile;
    int page = table[static_cast<size_t>(b) * MP + tok0 / ps];
    page = page < 0 ? 0 : page;
    // token row index into the flattened [Hkv, P, ps] row space
    const size_t row0 = (static_cast<size_t>(h) * P + page) * ps + tok0 % ps;

    float kf[kTile][DPL];
#pragma unroll
    for (int i = 0; i < kTile; ++i)
      load_row<DPL>(k_pages + (row0 + i) * DH + d0,
                    QUANT ? k_s[row0 + i] : 1.f, kf[i]);

    float s[G][kTile];
#pragma unroll
    for (int r = 0; r < G; ++r) {
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) part = fmaf(qr[r][e], kf[i][e], part);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        s[r][i] = tok0 + i < len ? part : kNeg;
      }
    }

    float vf[kTile][DPL];
#pragma unroll
    for (int i = 0; i < kTile; ++i)
      load_row<DPL>(v_pages + (row0 + i) * DH + d0,
                    QUANT ? v_s[row0 + i] : 1.f, vf[i]);

#pragma unroll
    for (int r = 0; r < G; ++r) {
      float mt = kNeg;
#pragma unroll
      for (int i = 0; i < kTile; ++i) mt = fmaxf(mt, s[r][i]);
      // tok0 < len, so the tile has a live column and m_new is finite
      const float m_new = fmaxf(m[r], mt);
      const float corr = m[r] == kNeg ? 0.f : exp2f(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] *= corr;
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        const float p = tok0 + i < len ? exp2f(s[r][i] - m_new) : 0.f;
        psum += p;
        const float pb = round_bf16(p);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(pb, vf[i][e], acc[r][e]);
      }
      l[r] = l[r] * corr + psum;
      m[r] = m_new;
    }
  }

  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][DH];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) sm_acc[warp][r][d0 + e] = acc[r][e];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * DH; idx += blockDim.x) {
    const int r = idx / DH;
    const int d = idx % DH;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = sm_m[w][r] == kNeg ? 0.f : exp2f(sm_m[w][r] - mx);
      lsum += sm_l[w][r] * f;
      a += sm_acc[w][r][d] * f;
    }
    out[(static_cast<size_t>(b) * H + h * G + r) * DH + d] =
        __float2bfloat16(a / (lsum == 0.f ? 1.f : lsum));
  }
}

template <int DH, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_s, const void* v_s, const void* table,
                   const void* lengths, void* out, int B, int H, int Hkv,
                   int P, int ps, int MP, bool quantized,
                   cudaStream_t stream) {
  const dim3 grid(B, Hkv);
  const dim3 block(kWarps * 32);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* tp = static_cast<const int32_t*>(table);
  const auto* lp = static_cast<const int32_t*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (quantized) {
    paged_attn_kernel<DH, G, int8_t, true><<<grid, block, 0, stream>>>(
        qp, static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
        static_cast<const float*>(k_s), static_cast<const float*>(v_s),
        tp, lp, op, H, P, ps, MP);
  } else {
    paged_attn_kernel<DH, G, __nv_bfloat16, false><<<grid, block, 0, stream>>>(
        qp, static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), nullptr, nullptr, tp, lp, op,
        H, P, ps, MP);
  }
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(int G, const void* q, const void* k, const void* v,
                      const void* k_s, const void* v_s, const void* table,
                      const void* lengths, void* out, int B, int H, int Hkv,
                      int P, int ps, int MP, bool quantized,
                      cudaStream_t stream) {
  switch (G) {
    case 1: return launch<DH, 1>(q, k, v, k_s, v_s, table, lengths, out, B, H, Hkv, P, ps, MP, quantized, stream);
    case 2: return launch<DH, 2>(q, k, v, k_s, v_s, table, lengths, out, B, H, Hkv, P, ps, MP, quantized, stream);
    case 4: return launch<DH, 4>(q, k, v, k_s, v_s, table, lengths, out, B, H, Hkv, P, ps, MP, quantized, stream);
    case 8: return launch<DH, 8>(q, k, v, k_s, v_s, table, lengths, out, B, H, Hkv, P, ps, MP, quantized, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns the cudaError_t of
// the launch; 0 means the kernel was enqueued on `stream`.
extern "C" int tpu_dra_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_s, const void* v_s, const void* table,
    const void* lengths, void* out, int B, int H, int Hkv, int P, int ps,
    int Dh, int MP, int quantized, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || ps % kTile != 0 || MP <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Hkv;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (Dh) {
    case 64:
      err = launch_dh<64>(G, q, k_pages, v_pages, k_s, v_s, table, lengths,
                          out, B, H, Hkv, P, ps, MP, quantized != 0, st);
      break;
    case 128:
      err = launch_dh<128>(G, q, k_pages, v_pages, k_s, v_s, table, lengths,
                           out, B, H, Hkv, P, ps, MP, quantized != 0, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* tpu_dra_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
