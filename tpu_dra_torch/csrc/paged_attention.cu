// Paged decode attention for Hopper (sm_90a).
//
// Replaces tpu_dra/workloads/paged_kv.py::paged_attention (:312) and its
// Pallas body _paged_attn_kernel (:248), called at :359: one query token
// per slot attends the slot's context through a block table, online
// softmax in base 2, GQA groups, bf16 pages or int8 pages with
// per-position fp32 scales.
//
// Contract (same as the reference):
//   q        [B, H, Dh]        bf16, pre-scaled by Dh^-0.5 * log2(e) and
//                              rounded to bf16 by the caller
//   k/v      [Hkv, P, ps, Dh]  bf16, or int8 with k_s/v_s [Hkv, P, ps, 1] fp32
//   table    [B, MP]           int32 page ids, -1 = no page (clamped to
//                              page 0 and removed by the length mask)
//   lengths  [B]               int32 context length, the new token included
//   out      [B, H, Dh]        bf16; a zero-length slot gives zeros
//   ws       fp32 workspace of B * Hkv * ceil(MP * ps / kSpanTokens) * g *
//            (Dh + 2) floats that the caller allocates (nothing is read
//            from it before this call writes it)
//
// What bounds it: device-memory bytes.  Every live token's K and V row is
// read once (plus q), and each row feeds only the g = H/Hkv query rows of
// its group, about 4 flops per byte at g = 4 — far below the ~295 flops
// per byte where the H100's bf16 tensor cores would become the limit.  So
// the design keeps as many bytes in flight as it can and spreads them over
// every SM:
//   * a work item is (slot, kv head, span of kSpanTokens consecutive
//     tokens).  The grid is fixed by MP, ceil(MP · ps / kSpanTokens) spans
//     a slot, so the host never reads the lengths; a span that starts at
//     or past its slot's length exits at once.  At the serving path's
//     decode step (32 slots over 2 kv heads, lengths 257-320) that is 192
//     working blocks, and 4 slots of 1024 tokens give 64;
//   * a block walks its span in kTile-token tiles through a ring of
//     kStages shared-memory buffers fed by cp.async: the K and V rows of
//     the next kStages − 1 tiles are in flight while a tile is scored.
//     Each row's page comes from the table; rows at or past the length
//     are zero-filled and never read from the pool.  The 16-byte chunks
//     of a row are XOR-swizzled by the row, so neither the score reads
//     (8 rows at one chunk) nor the P·V reads conflict on banks;
//   * scores without a shuffle tree: mma.sync m16n8k16 with the group's g
//     query rows padded to 16, each warp a quarter of the tile's tokens
//     in n-tiles of 8, the K fragments by ldmatrix (bf16 pages) or
//     dequantised from int8;
//   * softmax: a warp per query row, each lane kTile / 32 tokens; P·V on
//     the CUDA cores, each thread 8 dims of one row over a share of the
//     tile's tokens, the shares summed in a fixed order at the span's end;
//   * each span writes its fp32 (m, l, acc) to the workspace, and a second
//     kernel of the same call merges each (slot, head)'s live spans in
//     span order, so the result does not depend on which block ran first
//     and two calls give the same bits.  The merge is a programmatic
//     dependent launch: its blocks are scheduled while the spans run and
//     wait in griddepcontrol.wait until the span grid has finished and
//     its writes are visible, so its launch latency hides under the
//     spans.
//
// Rounding points follow the reference: scores accumulate in fp32 from
// bf16 operands; p is rounded to bf16 before the P.V product while l sums
// the unrounded p; int8 rows dequantize as (int8 * scale) rounded to bf16;
// out = acc / l with l == 0 treated as 1, cast to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;             // tokens a tile
constexpr int kSpanTokens = 128;      // tokens a work item (2 pages of 64)
constexpr int kStages = 3;            // tile buffers in the cp.async ring
static_assert(kSpanTokens % kTile == 0, "a span is whole tiles");
static_assert(kTile % (8 * kWarps) == 0 && kTile % 32 == 0,
              "a tile is whole 8-token n-tiles a warp and whole warps");
constexpr int kWarpTokens = kTile / kWarps;   // tokens a warp scores
constexpr int kLaneTokens = kTile / 32;       // tokens a lane in softmax

using flash::mma;
using flash::pack_bf16;
using hopper::ldsm_x4;
using hopper::smem_u32;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16 bytes from global to shared memory, or 16 zero bytes if !live
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(live ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(live ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 8 consecutive elements of a staged row -> fp32 (int8: bf16(int8 · scale))
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float,
                                      float (&o)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    o[2 * e] = f.x;
    o[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float scale,
                                      float (&o)[8]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    o[e] = round_bf16(static_cast<float>(c[e]) * scale);
}

// Two consecutive int8 elements of a staged row dequantised, as a bf16
// pair (an mma fragment register)
__device__ __forceinline__ uint32_t load2(const int8_t* p, float scale) {
  return pack_bf16(static_cast<float>(p[0]) * scale,
                   static_cast<float>(p[1]) * scale);
}

// One K or V tile in shared memory: kTile rows of Dh elements; 16-byte
// chunk c of row i lies at chunk c ^ (i % kChunks)
template <int DH, typename T>
struct Tile {
  static constexpr int kRowBytes = DH * static_cast<int>(sizeof(T));
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kBytes = kTile * kRowBytes;
  // byte offset of element e of row i
  __device__ __forceinline__ static int at(int i, int e) {
    const int b = e * static_cast<int>(sizeof(T));
    return i * kRowBytes + (((b >> 4) ^ (i % kChunks)) << 4) + (b & 15);
  }
};

// The block's shared memory: kStages tile buffers (K, V, their scales),
// then q [G][DH] fp32, the tile's scores and rounded p [G][kTile], each
// row's rescale of the tile, the P·V shares [kThreads][8] and the span's
// row offsets
template <int DH, int G, typename T>
struct Smem {
  using L = Tile<DH, T>;
  static constexpr int kK = 0;
  static constexpr int kV = L::kBytes;
  static constexpr int kKs = 2 * L::kBytes;
  static constexpr int kVs = kKs + kTile * 4;
  static constexpr int kStage = kVs + kTile * 4;
  static constexpr int kQ = kStages * kStage;
  static constexpr int kS = kQ + G * DH * 4;
  static constexpr int kP = kS + G * kTile * 4;
  static constexpr int kCorr = kP + G * kTile * 4;
  static constexpr int kRed = kCorr + 8 * 4;
  static constexpr int kRows = kRed + kThreads * 8 * 4;
  static constexpr int kBytes = kRows + kSpanTokens * 8;
};

// The span (slot blockIdx.z, kv head blockIdx.y, span blockIdx.x) of every
// live span: its partial (m, l, acc) of each of the G query rows into the
// workspace record of the span, [G][DH] acc, then [G] m, then [G] l
// (at most 168 registers a thread, for 3 blocks an SM: left to itself
// ptxas gave one instantiation 96 and spilled, and at 128 another one
// spilled)
template <int DH, int G, typename T, bool QUANT>
__global__ void __launch_bounds__(kThreads, 3)
paged_span_kernel(const __nv_bfloat16* __restrict__ q,
                  const T* __restrict__ k_pages,
                  const T* __restrict__ v_pages,
                  const float* __restrict__ k_s,
                  const float* __restrict__ v_s,
                  const int32_t* __restrict__ table,
                  const int32_t* __restrict__ lengths,
                  float* __restrict__ ws, int H, int Hkv, int P, int ps,
                  int MP, int n_spans) {
  using L = Tile<DH, T>;
  using S = Smem<DH, G, T>;
  constexpr int kRowsPerWarp = (G + kWarps - 1) / kWarps;
  constexpr int kPvChunks = DH / 8;                // a thread's 8 dims
  constexpr int kGroups = kThreads / kPvChunks;
  constexpr int kParts = kGroups / G;              // shares of a tile's tokens
  static_assert(kGroups % G == 0 && kTile % kParts == 0, "P·V shares");
  extern __shared__ __align__(16) uint8_t smem[];

  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int span = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = span * kSpanTokens;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* qf = reinterpret_cast<float*>(smem + S::kQ);
  float* sS = reinterpret_cast<float*>(smem + S::kS);
  float* sP = reinterpret_cast<float*>(smem + S::kP);
  float* sCorr = reinterpret_cast<float*>(smem + S::kCorr);
  long long* rows = reinterpret_cast<long long*>(smem + S::kRows);

  // the span's rows in the flattened [Hkv, P, ps] pool and the q rows,
  // read before the length is known, so that their loads overlap its
  // load rather than wait for it
  for (int i = tid; i < kSpanTokens && t0 + i < MP * ps; i += kThreads) {
    const int tok = t0 + i;
    int page = table[static_cast<size_t>(b) * MP + tok / ps];
    page = page < 0 ? 0 : page;
    rows[i] = (static_cast<long long>(h) * P + page) * ps + tok % ps;
  }
  for (int i = tid; i < G * DH; i += kThreads)
    qf[i] = __bfloat162float(q[(static_cast<size_t>(b) * H + h * G) * DH + i]);
  int len = lengths[b];
  len = len < 0 ? 0 : (len > MP * ps ? MP * ps : len);
  if (t0 >= len) return;                           // a dead span
  const int t1 = min(t0 + kSpanTokens, len);
  const int n_tiles = (t1 - t0 + kTile - 1) / kTile;
  __syncthreads();

  // tile j of the span into its ring buffer; rows past the length read
  // zeros
  auto load_tile = [&](int j) {
    uint8_t* st = smem + (j % kStages) * S::kStage;
    for (int x = tid; x < kTile * L::kChunks; x += kThreads) {
      const int i = x / L::kChunks, c = x % L::kChunks;
      const bool live = j * kTile + i < t1 - t0;
      const long long row = live ? rows[j * kTile + i] : 0;
      const int dst = L::at(i, 16 * c / static_cast<int>(sizeof(T)));
      cp_async16(smem_u32(st + S::kK + dst), k_pages + row * DH +
                 16 * c / static_cast<int>(sizeof(T)), live);
      cp_async16(smem_u32(st + S::kV + dst), v_pages + row * DH +
                 16 * c / static_cast<int>(sizeof(T)), live);
    }
    if constexpr (QUANT) {
      for (int i = tid; i < kTile; i += kThreads) {
        const bool live = j * kTile + i < t1 - t0;
        const long long row = live ? rows[j * kTile + i] : 0;
        cp_async4(smem_u32(st + S::kKs + 4 * i), k_s + row, live);
        cp_async4(smem_u32(st + S::kVs + 4 * i), v_s + row, live);
      }
    }
  };

  // the query rows as mma A fragments (rows g..15 of the 16 are zero)
  const int gq = lane >> 2, tq = lane & 3;
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const float* qr = qf + gq * DH + 16 * kk + 2 * tq;
    qa[kk][0] = gq < G ? pack_bf16(qr[0], qr[1]) : 0u;
    qa[kk][2] = gq < G ? pack_bf16(qr[8], qr[9]) : 0u;
    qa[kk][1] = qa[kk][3] = 0u;
  }

  // P·V: 8 dims of row pr over share `part` of each tile's tokens
  const int pc = tid % kPvChunks, grp = tid / kPvChunks;
  const int pr = grp % G, part = grp / G;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    m_run[j] = -INFINITY;
    l_run[j] = 0.f;
  }

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) load_tile(j);
    cp_async_commit();
  }
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                 // tile j landed; tile j - 1 is done
    if (j + kStages - 1 < n_tiles) load_tile(j + kStages - 1);
    cp_async_commit();
    const uint8_t* st = smem + (j % kStages) * S::kStage;
    const T* vt = reinterpret_cast<const T*>(st + S::kV);
    const float* ks = reinterpret_cast<const float*>(st + S::kKs);
    const float* vs = reinterpret_cast<const float*>(st + S::kVs);
    const int tok0 = t0 + j * kTile;

    // scores [G][kTile], -inf past the length
#pragma unroll
    for (int nt = 0; nt < kWarpTokens / 8; ++nt) {
      const int n0 = warp * kWarpTokens + 8 * nt;   // the n-tile's tokens
      const int i = n0 + gq;                        // this lane's B token
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (QUANT) {
        const float sc = ks[i];
        const int8_t* kr = reinterpret_cast<const int8_t*>(st + S::kK);
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          mma(c, qa[kk], load2(kr + L::at(i, 16 * kk + 2 * tq), sc),
              load2(kr + L::at(i, 16 * kk + 2 * tq + 8), sc));
      } else {
        // ldmatrix: lane l names token n0 + l % 8, chunk 4 p + l / 8;
        // registers: b0, b1 of k-step 2p, then of 2p + 1
        const uint32_t kb = smem_u32(st + S::kK);
        const int li = n0 + (lane & 7);
#pragma unroll
        for (int p = 0; p < DH / 32; ++p) {
          uint32_t bf[4];
          ldsm_x4(bf, kb + L::at(li, 8 * (4 * p + (lane >> 3))));
          mma(c, qa[2 * p], bf[0], bf[1]);
          mma(c, qa[2 * p + 1], bf[2], bf[3]);
        }
      }
      if (gq < G) {
        const int i0 = n0 + 2 * tq;
        sS[gq * kTile + i0] = tok0 + i0 < t1 ? c[0] : -INFINITY;
        sS[gq * kTile + i0 + 1] = tok0 + i0 + 1 < t1 ? c[1] : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w keeps rows w, w + kWarps; lane l tokens l,
    // l + 32, ...
#pragma unroll
    for (int jr = 0; jr < kRowsPerWarp; ++jr) {
      const int r = warp + kWarps * jr;
      if (r < G) {
        float s[kLaneTokens], mt = -INFINITY;
#pragma unroll
        for (int jt = 0; jt < kLaneTokens; ++jt) {
          s[jt] = sS[r * kTile + lane + 32 * jt];
          mt = fmaxf(mt, s[jt]);
        }
        // the tile's first token is live, so m_new is finite
        const float m_new = fmaxf(m_run[jr], warp_max(mt));
        const float corr = exp2f(m_run[jr] - m_new);   // 0 on the first tile
        float psum = 0.f;
#pragma unroll
        for (int jt = 0; jt < kLaneTokens; ++jt) {
          const float p = exp2f(s[jt] - m_new);        // 0 past the length
          psum += p;
          sP[r * kTile + lane + 32 * jt] = round_bf16(p);
        }
        l_run[jr] = l_run[jr] * corr + warp_sum(psum);
        m_run[jr] = m_new;
        if (lane == 0) sCorr[r] = corr;
      }
    }
    __syncthreads();

    {
      const float corr = sCorr[pr];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] *= corr;
#pragma unroll 8
      for (int n = 0; n < kTile / kParts; ++n) {
        const int i = part * (kTile / kParts) + n;
        const float p = sP[pr * kTile + i];
        float vv[8];
        load8(reinterpret_cast<const T*>(
                  reinterpret_cast<const uint8_t*>(vt) + L::at(i, 8 * pc)),
              QUANT ? vs[i] : 1.f, vv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(p, vv[e], acc[e]);
      }
    }
  }

  // the span's partial: the P·V shares summed in part order
  float* red = reinterpret_cast<float*>(smem + S::kRed);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 8; ++e) red[grp * DH + 8 * pc + e] = acc[e];
  __syncthreads();
  float* rec = ws + (static_cast<size_t>(b * Hkv + h) * n_spans + span) * G *
                        (DH + 2);
  for (int x = tid; x < G * DH; x += kThreads) {
    const int r = x / DH, d = x % DH;
    float a = 0.f;
#pragma unroll
    for (int pt = 0; pt < kParts; ++pt) a += red[(pt * G + r) * DH + d];
    rec[x] = a;
  }
#pragma unroll
  for (int jr = 0; jr < kRowsPerWarp; ++jr) {
    const int r = warp + kWarps * jr;
    if (r < G && lane == 0) {
      rec[G * DH + r] = m_run[jr];
      rec[G * DH + G + r] = l_run[jr];
    }
  }
}

// out of (slot blockIdx.y, kv head blockIdx.x): the live spans' partials
// merged in span order; no live span (length 0) gives zeros
template <int DH, int G>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ ws,
                     const int32_t* __restrict__ lengths,
                     __nv_bfloat16* __restrict__ out, int H, int Hkv, int ps,
                     int MP, int n_spans) {
  constexpr int kRec = G * (DH + 2);
  // every span block has finished and its partial is visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int h = blockIdx.x, b = blockIdx.y;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > MP * ps ? MP * ps : len);
  const int live = (len + kSpanTokens - 1) / kSpanTokens;
  const float* rec0 =
      ws + static_cast<size_t>(b * Hkv + h) * n_spans * kRec;
  for (int x = threadIdx.x; x < G * DH; x += kThreads) {
    const int r = x / DH;
    float mx = -INFINITY;
    // (unrolled, so that the loads of several spans are in flight at once)
#pragma unroll 8
    for (int s = 0; s < live; ++s) mx = fmaxf(mx, rec0[s * kRec + G * DH + r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll 8
    for (int s = 0; s < live; ++s) {
      const float* rec = rec0 + s * kRec;
      const float f = exp2f(rec[G * DH + r] - mx);
      lsum += rec[G * DH + G + r] * f;
      a += rec[x] * f;
    }
    out[(static_cast<size_t>(b) * H + h * G) * DH + x] =
        __float2bfloat16(a / (lsum == 0.f ? 1.f : lsum));
  }
}

template <int DH, int G, typename T, bool QUANT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_s, const void* v_s, const void* table,
                   const void* lengths, void* out, void* ws, int B, int H,
                   int Hkv, int P, int ps, int MP, cudaStream_t stream) {
  using S = Smem<DH, G, T>;
  auto kernel = paged_span_kernel<DH, G, T, QUANT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (attr != cudaSuccess) return attr;
  const int n_spans = (MP * ps + kSpanTokens - 1) / kSpanTokens;
  const auto* lp = static_cast<const int32_t*>(lengths);
  auto* wp = static_cast<float*>(ws);
  kernel<<<dim3(n_spans, Hkv, B), kThreads, S::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(k_s),
      static_cast<const float*>(v_s), static_cast<const int32_t*>(table), lp,
      wp, H, Hkv, P, ps, MP, n_spans);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_combine_kernel<DH, G>,
                            static_cast<const float*>(wp), lp,
                            static_cast<__nv_bfloat16*>(out), H, Hkv, ps, MP,
                            n_spans);
}

template <int DH, int G>
cudaError_t launch_typed(bool quantized, const void* q, const void* k,
                         const void* v, const void* k_s, const void* v_s,
                         const void* table, const void* lengths, void* out,
                         void* ws, int B, int H, int Hkv, int P, int ps,
                         int MP, cudaStream_t stream) {
  if (quantized)
    return launch<DH, G, int8_t, true>(q, k, v, k_s, v_s, table, lengths,
                                       out, ws, B, H, Hkv, P, ps, MP, stream);
  return launch<DH, G, __nv_bfloat16, false>(q, k, v, nullptr, nullptr,
                                             table, lengths, out, ws, B, H,
                                             Hkv, P, ps, MP, stream);
}

template <int DH>
cudaError_t launch_dh(int G, bool quantized, const void* q, const void* k,
                      const void* v, const void* k_s, const void* v_s,
                      const void* table, const void* lengths, void* out,
                      void* ws, int B, int H, int Hkv, int P, int ps, int MP,
                      cudaStream_t stream) {
  switch (G) {
    case 1: return launch_typed<DH, 1>(quantized, q, k, v, k_s, v_s, table, lengths, out, ws, B, H, Hkv, P, ps, MP, stream);
    case 2: return launch_typed<DH, 2>(quantized, q, k, v, k_s, v_s, table, lengths, out, ws, B, H, Hkv, P, ps, MP, stream);
    case 4: return launch_typed<DH, 4>(quantized, q, k, v, k_s, v_s, table, lengths, out, ws, B, H, Hkv, P, ps, MP, stream);
    case 8: return launch_typed<DH, 8>(quantized, q, k, v, k_s, v_s, table, lengths, out, ws, B, H, Hkv, P, ps, MP, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns the cudaError_t of
// the launches (the spans, then their merge); 0 means both kernels were
// enqueued on `stream`.
extern "C" int tpu_dra_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_s, const void* v_s, const void* table,
    const void* lengths, void* out, void* ws, int B, int H, int Hkv, int P,
    int ps, int Dh, int MP, int quantized, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || H % Hkv != 0 ||
      ps <= 0 || MP <= 0 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Hkv;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (Dh) {
    case 64:
      err = launch_dh<64>(G, quantized != 0, q, k_pages, v_pages, k_s, v_s,
                          table, lengths, out, ws, B, H, Hkv, P, ps, MP, st);
      break;
    case 128:
      err = launch_dh<128>(G, quantized != 0, q, k_pages, v_pages, k_s, v_s,
                           table, lengths, out, ws, B, H, Hkv, P, ps, MP, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* tpu_dra_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
