// Flash-attention forward for Hopper (sm_90a): TMA-fed wgmma with a
// producer warpgroup and two consumer warpgroups.
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
//                      rounds the product to bf16 before the first product
//   k, v [BHkv, Sk, D] bf16, BH = g * BHkv; causal needs Sk == S and masks
//                      start-aligned rows >= cols
//   out  [BH, S, D]    bf16 = acc / max(l, 1e-30), so a fully masked row is 0
//   l2   [BH, S]       fp32 base-2 logsumexp m + log2(max(l, 1e-30))
//
// What bounds it at the training path's shapes ([256, 1024, 128], causal):
// q, k, v, out and l2 are ~270 MB, 80 us at 3.35 TB/s; the two S x S
// products under the mask are 68.7 GFLOP, 69 us at 989 TF/s.  Both sides
// are close, so every score stays in registers (no S x S tensor in
// memory), both products run on wgmma, and the copies overlap the math.
//
// Design:
//   * a persistent grid: one block (CTA) of three warpgroups per SM walks
//     work items of one q head-row each, a pair of 128-row q tiles, the
//     longest and the shortest left under the causal mask, so every item
//     costs n_qt + 1 k tiles and a static round robin balances the card;
//     items go head by head, so the blocks in flight share K/V in L2.
//     Warpgroup 0 is the producer: one thread issues every TMA copy, its
//     warps 1-3 pre-scale each q tile in shared memory, and the group
//     gives its registers up (setmaxnreg) to warpgroups 1 and 2, the
//     consumers, which own 64 q rows each.  q is double-buffered: the
//     producer loads and scales the next tile's q while the consumers
//     work on the current one, and the out tile has its own buffer, so a
//     tile's start overlaps the last one's end.
//   * TMA with 3-D maps over [BH, S, D] and [BHkv, Sk, D] (hopper.cuh):
//     rows past S or Sk arrive as zeros, never from the next head.  K and V
//     tiles of 128 keys go through separate rings of kStages buffers with
//     full / empty mbarriers; the producer runs one K tile ahead of V, in
//     the order the consumers need them.  Every tile is 128B-swizzled, as
//     64-column boxes (two per row at D = 128).
//   * S = qs·Kᵀ is wgmma m64n128k16 over D / 16 k-steps with both operands
//     K-major in shared memory; O += P·V is wgmma m64nDk16 with A = P from
//     registers (the score accumulator rounded to bf16 in place, see
//     hopper.cuh) and B = the V tile MN-major.  P never goes to memory.
//   * a consumer's loop overlaps its softmax with its own P·V: it issues
//     S_j and P_{j-1}·V_{j-1}, waits for S_j alone, runs the softmax of
//     tile j while P·V runs, then waits for P·V, rescales O and packs P_j.
//     The two consumers take turns to issue (a token passed through two
//     named barriers), so one's softmax runs while the other's products
//     keep the tensor cores busy: the exponentials, 16 a clock per SM,
//     cost about half as long as the products of a tile.
//   * online softmax in base 2 per row, with the reference's safe_m rule:
//     a row masked everywhere so far takes its exponent against 0 and its
//     correction factor is 0, so exp2(neg - neg) never leaks weight.  p is
//     one ex2.approx.ftz (a masked score gives exactly 0).
//   * epilogue: out is scaled by 1 / l, rounded to bf16 into the consumer's
//     half of an out buffer (same swizzle) and written by TMA store, which
//     drops rows past S, while the next tile starts; l2 goes out per row
//     from registers.
//
// Rounding points, pinned here because no output check can see them all:
//   * q is rounded to bf16 after the pre-scale (the producer's warps 1-3
//     rescale the tile in shared memory and fence it for wgmma);
//   * p is rounded to bf16 where the score accumulator becomes P's A
//     fragments, before P·V; l sums the UNROUNDED p;
//   * out = acc · (1 / l) is rounded to bf16 once, at the store (one fp32
//     reciprocal per row: within an fp32 ulp of acc / l before rounding).
// Masks are applied only on tiles that cross the diagonal or the ragged
// key tail: zero-filled keys past Sk score 0, not -inf, so they are masked
// by col >= Sk (under the causal mask, where Sk == S, by col > row).

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::kNeg;
using flash::pack_bf16;
using flash::quad_max;
using flash::quad_sum;
using namespace hopper;

constexpr int kBQ = 128;          // q rows per block, 64 per consumer
constexpr int kBK = 128;          // keys per K/V tile (S is m64n128)
constexpr int kStages = 2;        // buffers in each of the K and V rings
constexpr int kWarpgroup = 128;
constexpr int kThreadsFwd = 3 * kWarpgroup;
constexpr int kConsumerWarps = 8;
constexpr int kScalerWarps = 3;   // producer warps 1-3 pre-scale q
// 40 · 128 + 232 · 256 = 64,512, the 168 · 384 registers the block starts
// with: setmaxnreg.inc only takes what the block's own warps gave back, so
// a producer that kept more would leave the consumers waiting for ever
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kRowBytes = 128;    // one swizzled row of a 64-column box

// Shared memory, from a 1024-byte aligned base: two q tiles (the tile a
// block works on and the next), the out tile, the K ring, the V ring, then
// the barriers.
template <int D>
struct Smem {
  static constexpr int kBoxes = D / 64;
  static constexpr int kQBox = kBQ * kRowBytes;          // one 64-column box
  static constexpr int kKVBox = kBK * kRowBytes;
  static constexpr int kQ = 0;                           // + (tile & 1) · kQTile
  static constexpr int kQTile = kBoxes * kQBox;
  static constexpr int kO = kQ + 2 * kQTile;
  static constexpr int kK = kO + kQTile;
  static constexpr int kV = kK + kStages * kBoxes * kKVBox;
  static constexpr int kBar = kV + kStages * kBoxes * kKVBox;
  static constexpr int kBars = 6 + 4 * kStages;
  static constexpr int kBytes = kBar + kBars * 8 + 1024;  // + alignment slack
};

// q_* per q buffer: tile t uses buffer t & 1, phase (t >> 1) & 1
struct Barriers {
  uint64_t* q_full;     // q has landed
  uint64_t* q_ready;    // q is pre-scaled and visible to wgmma
  uint64_t* q_empty;    // every S product of the tile is done
  uint64_t* k_full;
  uint64_t* v_full;
  uint64_t* k_empty;
  uint64_t* v_empty;
};

// The q tiles of this block, in order: f(bh, qt) for the tiles of each of
// its work items (the round robin over [BH, ceil(n_qt / 2)] items).
template <typename F>
__device__ __forceinline__ void for_each_tile(int n_qt, int BH, F&& f) {
  const int n_pairs = (n_qt + 1) / 2;
  for (int w = blockIdx.x; w < BH * n_pairs; w += gridDim.x) {
    const int bh = w / n_pairs, p = w % n_pairs;
    f(bh, n_qt - 1 - p);
    if (p != n_qt - 1 - p) f(bh, p);
  }
}

// key tile j of kv row kvh into ring slot `it` (the block's running count
// of k tiles)
template <int D>
__device__ __forceinline__ void load_kv(uint8_t* ring, uint64_t* full,
                                        uint64_t* empty,
                                        const CUtensorMap* map, int it, int j,
                                        int kvh) {
  using L = Smem<D>;
  const int st = it % kStages;
  mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
  mbar_expect_tx(&full[st], L::kBoxes * L::kKVBox);
#pragma unroll
  for (int b = 0; b < L::kBoxes; ++b)
    tma_load(ring + (st * L::kBoxes + b) * L::kKVBox, map, &full[st], b * 64,
             j * kBK, kvh);
}

// S = qs·Kᵀ for this consumer's 64 rows against the K tile in ring slot
// j (issued, not waited for)
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[kBK / 2], uint32_t q_addr,
                                       uint32_t k_ring, int j) {
  using L = Smem<D>;
  const uint32_t k_addr = k_ring + (j % kStages) * L::kBoxes * L::kKVBox;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * L::kQBox + (kk % 4) * 32;
    const uint32_t koff = (kk / 4) * L::kKVBox + (kk % 4) * 32;
    wgmma_ss_n128<0>(s, desc_sw128(q_addr + off, 16, 1024),
                     desc_sw128(k_addr + koff, 16, 1024), kk > 0);
  }
  wgmma_commit();
  fence_regs(s);
}

// O += P·V for the V tile in ring slot j (issued, not waited for)
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         uint32_t (&pa)[kBK / 16][4],
                                         uint32_t v_ring, int j) {
  using L = Smem<D>;
  const uint32_t v_addr = v_ring + (j % kStages) * L::kBoxes * L::kKVBox;
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs<D, 1>(o, pa[kk],
                   desc_sw128(v_addr + kk * 16 * kRowBytes, L::kKVBox, 1024));
  wgmma_commit();
  fence_regs(o);
}

// 2^x on the special-function unit (ex2.approx.ftz: 2 ulp, subnormal
// results flushed to 0); a masked score, -FLT_MAX minus a finite max,
// gives exactly 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online-softmax step of one score tile, in place: s becomes the
// unrounded p; m, l and corr are this thread's two rows (l a partial sum
// over the thread's columns).
template <bool CAUSAL>
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0,
                                             int row0, int col_t, int Sk,
                                             bool masked) {
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    const int r = (i >> 1) & 1;
    if (masked) {
      // under the causal mask Sk == S, so col > row covers the tail too
      // (rows past S are never stored)
      const int col = k0 + 8 * (i >> 2) + col_t + (i & 1);
      if (CAUSAL ? col > row0 + 8 * r : col >= Sk) s[i] = kNeg;
    }
    mx[r] = fmaxf(mx[r], s[i]);
  }
  float safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    safe[r] = m_new == kNeg ? 0.f : m_new;
    corr[r] = m[r] == kNeg ? 0.f : exp2f(m[r] - safe[r]);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float p = exp2_ftz(s[i] - safe[r]);     // 0 where masked
    s[i] = p;
    l[r] += p;
  }
}

// p rounded to bf16 here, before P·V: columns 16 kk .. 16 kk + 15 of the
// score accumulator are the A fragment of k-step kk
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kBK / 16][4],
                                       const float (&s)[kBK / 2]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
}

// The issue token of the two consumers: named barrier kTurn + c opens when
// the other consumer passes the turn to consumer c.
constexpr int kTurn = 3;

__device__ __forceinline__ void turn_wait(int c) {
  named_sync(kTurn + c, 2 * kWarpgroup);
}

__device__ __forceinline__ void turn_pass(int c) {
  named_arrive(kTurn + 1 - c, 2 * kWarpgroup);
}

// Where a consumer thread sits: its warpgroup's 64 rows of the tile and
// its two rows and columns in the wgmma fragments.
struct Consumer {
  int c;        // consumer 0 or 1: rows 64 c .. 64 c + 63 of a q tile
  int tid;      // thread in the warpgroup
  int lane;
  int row_l;    // its rows in the warpgroup's 64: row_l and row_l + 8
  int col_t;    // its first column in each 8-column block
};

// One q tile (q head-row bh, rows q0 ..) for one consumer warpgroup; `it`
// is the block's running count of k tiles, `tile` of q tiles.
template <int D, bool CAUSAL>
__device__ __forceinline__ void consume_tile(
    uint8_t* base, const Barriers& bar, const CUtensorMap* tm_o,
    float* __restrict__ l2, const Consumer& me, int tile, int it, int q0,
    int bh, int S, int Sk, int n_k) {
  using L = Smem<D>;
  const int q_first = q0 + 64 * me.c;                // this consumer's rows
  const int row0 = q_first + me.row_l;
  const int qb = tile & 1;
  uint8_t* q_half = base + L::kQ + qb * L::kQTile + me.c * 64 * kRowBytes;
  uint8_t* o_half = base + L::kO + me.c * 64 * kRowBytes;
  const uint32_t q_addr = smem_u32(q_half);
  const uint32_t k_ring = smem_u32(base + L::kK);
  const uint32_t v_ring = smem_u32(base + L::kV);

  mbar_wait(&bar.q_ready[qb], (tile >> 1) & 1);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float s[kBK / 2];
  uint32_t pa[kBK / 16][4];
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  float corr[2];
  auto masked = [&](int j) {
    const int k0 = j * kBK;
    return k0 + kBK > Sk || (CAUSAL && k0 + kBK - 1 > q_first);
  };
  // the K slot of S_j is free once S_j is in; the q buffer once the last
  // S is in
  auto release_k = [&](int j) {
    if (me.lane == 0) {
      mbar_arrive(&bar.k_empty[(it + j) % kStages]);
      if (j == n_k - 1) mbar_arrive(&bar.q_empty[qb]);
    }
  };

  // tile 0: O is still zero, so nothing to rescale
  mbar_wait(&bar.k_full[it % kStages], (it / kStages) & 1);
  turn_wait(me.c);
  issue_s<D>(s, q_addr, k_ring, it);
  turn_pass(me.c);
  wgmma_wait<0>();
  fence_regs(s);
  release_k(0);
  softmax_tile<CAUSAL>(s, m, l, corr, 0, row0, me.col_t, Sk, masked(0));
  pack_p(pa, s);

  for (int j = 1; j < n_k; ++j) {
    const int ik = it + j, iv = it + j - 1;
    mbar_wait(&bar.k_full[ik % kStages], (ik / kStages) & 1);
    mbar_wait(&bar.v_full[iv % kStages], (iv / kStages) & 1);
    turn_wait(me.c);
    issue_s<D>(s, q_addr, k_ring, ik);
    issue_pv<D>(o, pa, v_ring, iv);
    turn_pass(me.c);
    wgmma_wait<1>();                     // S_j is in; P_{j-1}·V_{j-1} runs on
    fence_regs(s);
    release_k(j);
    softmax_tile<CAUSAL>(s, m, l, corr, j * kBK, row0, me.col_t, Sk,
                         masked(j));
    wgmma_wait<0>();
    fence_regs(o);
    if (me.lane == 0) mbar_arrive(&bar.v_empty[iv % kStages]);
    rescale<D>(o, corr);
    pack_p(pa, s);
  }
  const int iv = it + n_k - 1;
  mbar_wait(&bar.v_full[iv % kStages], (iv / kStages) & 1);
  turn_wait(me.c);
  issue_pv<D>(o, pa, v_ring, iv);
  turn_pass(me.c);
  wgmma_wait<0>();
  fence_regs(o);
  if (me.lane == 0) mbar_arrive(&bar.v_empty[iv % kStages]);

  // epilogue: out = acc · (1 / l) rounded to bf16 into this consumer's
  // half of the out buffer (the q tile's swizzled layout), once the last
  // tile's store has read it, then one TMA store per box
  float lr[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lr[r] = fmaxf(quad_sum(l[r]), 1e-30f);
    inv[r] = 1.f / lr[r];
  }
  if (me.tid == 0) tma_store_wait_read();
  named_sync(1 + me.c, kWarpgroup);
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int row = me.row_l + 8 * r;
    const int col = 8 * (i >> 2) + me.col_t;
    uint8_t* dst = o_half + (col / 64) * L::kQBox + row * kRowBytes +
                   ((((col % 64) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o[i] * inv[r],
                                                  o[i + 1] * inv[r]);
  }
  fence_proxy_async();
  named_sync(1 + me.c, kWarpgroup);
  if (me.tid == 0 && q_first < S) {
#pragma unroll
    for (int b = 0; b < L::kBoxes; ++b)
      tma_store(tm_o, o_half + b * L::kQBox, b * 64, q_first, bh);
    tma_store_commit();
  }
  if ((me.lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < S) l2[static_cast<size_t>(bh) * S + row] = m[r] + log2f(lr[r]);
    }
  }
}

// number of key tiles of a q tile starting at row q0
template <bool CAUSAL>
__device__ __forceinline__ int key_tiles(int q0, int Sk) {
  const int kv_end = CAUSAL ? min(Sk, q0 + kBQ) : Sk;
  return (kv_end + kBK - 1) / kBK;
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreadsFwd, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o,
                 float* __restrict__ l2, int BH, int S, int Sk, int group,
                 float qscale) {
  using L = Smem<D>;
  extern __shared__ __align__(16) uint8_t raw[];
  uint8_t* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kBar);
  const Barriers bar{bars,
                     bars + 2,
                     bars + 4,
                     bars + 6,
                     bars + 6 + kStages,
                     bars + 6 + 2 * kStages,
                     bars + 6 + 3 * kStages};
  const int n_qt = (S + kBQ - 1) / kBQ;

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(&bar.q_full[qb], 1);
      mbar_init(&bar.q_ready[qb], kScalerWarps);
      mbar_init(&bar.q_empty[qb], kConsumerWarps);
    }
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&bar.k_full[st], 1);
      mbar_init(&bar.v_full[st], 1);
      mbar_init(&bar.k_empty[st], kConsumerWarps);
      mbar_init(&bar.v_empty[st], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  int tile = 0, it = 0;       // q tiles and k tiles this block has walked
  if (threadIdx.x < kWarpgroup) {
    // producer: per q tile, q once its buffer's last tile is done with
    // it, then K_0, then K_{j+1} ahead of V_j
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      for_each_tile(n_qt, BH, [&](int bh, int qt) {
        const int kvh = bh / group;
        const int n_k = key_tiles<CAUSAL>(qt * kBQ, Sk);
        const int qb = tile & 1;
        mbar_wait(&bar.q_empty[qb], ((tile >> 1) & 1) ^ 1);
        mbar_expect_tx(&bar.q_full[qb], L::kQTile);
        for (int b = 0; b < L::kBoxes; ++b)
          tma_load(base + L::kQ + qb * L::kQTile + b * L::kQBox, &tm_q,
                   &bar.q_full[qb], b * 64, qt * kBQ, bh);
        load_kv<D>(base + L::kK, bar.k_full, bar.k_empty, &tm_k, it, 0, kvh);
        for (int j = 0; j < n_k; ++j) {
          if (j + 1 < n_k)
            load_kv<D>(base + L::kK, bar.k_full, bar.k_empty, &tm_k,
                       it + j + 1, j + 1, kvh);
          load_kv<D>(base + L::kV, bar.v_full, bar.v_empty, &tm_v, it + j, j,
                     kvh);
        }
        it += n_k;
        ++tile;
      });
    } else if (threadIdx.x >= 32) {
      // q rounded to bf16 after the pre-scale, in place, then made visible
      // to wgmma, while the consumers work on the tile before
      const int lane = threadIdx.x % 32;
      for_each_tile(n_qt, BH, [&](int, int) {
        const int qb = tile & 1;
        mbar_wait(&bar.q_full[qb], (tile >> 1) & 1);
        uint4* p = reinterpret_cast<uint4*>(base + L::kQ + qb * L::kQTile);
        for (int i = threadIdx.x - 32; i < L::kQTile / 16;
             i += 32 * kScalerWarps) {
          uint4 val = p[i];
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            h[e] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
          }
          p[i] = val;
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&bar.q_ready[qb]);
        ++tile;
      });
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % kWarpgroup;
    const int lane = tid % 32;
    const Consumer me{static_cast<int>(threadIdx.x) / kWarpgroup - 1, tid,
                      lane, 16 * (tid / 32) + (lane >> 2), 2 * (lane & 3)};
    if (me.c == 1) turn_pass(1);        // consumer 0 issues first
    for_each_tile(n_qt, BH, [&](int bh, int qt) {
      const int n_k = key_tiles<CAUSAL>(qt * kBQ, Sk);
      consume_tile<D, CAUSAL>(base, bar, &tm_o, l2, me, tile, it, qt * kBQ,
                              bh, S, Sk, n_k);
      it += n_k;
      ++tile;
    });
    if (me.c == 0) turn_wait(0);        // the last pass, so none is left
    if (tid == 0) tma_store_wait_read();   // before the block's memory goes
  }
}

// blocks of the persistent grid: one per SM, or one per work item where
// there are fewer
inline cudaError_t grid_size(int items, int* blocks) {
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = items < sms ? items : sms;
  return err;
}

template <int D, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* l2, int BH, int BHkv, int S, int Sk, float qscale,
                   cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  cudaError_t err;
  if ((err = tensor_map_bf16(&tm_q, q, BH, S, D, kBQ)) != cudaSuccess ||
      (err = tensor_map_bf16(&tm_k, k, BHkv, Sk, D, kBK)) != cudaSuccess ||
      (err = tensor_map_bf16(&tm_v, v, BHkv, Sk, D, kBK)) != cudaSuccess ||
      (err = tensor_map_bf16(&tm_o, out, BH, S, D, 64)) != cudaSuccess)
    return err;
  auto kernel = flash_fwd_kernel<D, CAUSAL>;
  constexpr int bytes = Smem<D>::kBytes;
  if ((err = flash::allow_smem(kernel, bytes)) != cudaSuccess) return err;
  int blocks;
  if ((err = grid_size(BH * ((S + 2 * kBQ - 1) / (2 * kBQ)), &blocks)) !=
      cudaSuccess)
    return err;
  kernel<<<blocks, kThreadsFwd, bytes, stream>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<float*>(l2), BH, S, Sk, BH / BHkv,
      qscale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns the cudaError_t of the
// tensor-map encodes and the launch; 0 means the kernel was enqueued on
// `stream`.
extern "C" int tpu_dra_flash_fwd(const void* q, const void* k, const void* v,
                                 void* out, void* l2, int BH, int BHkv, int S,
                                 int Sk, int D, int causal, float qscale,
                                 void* stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv != 0 || S <= 0 || Sk <= 0 ||
      BH > 65535 || (causal && S != Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64)
    err = causal ? launch<64, true>(q, k, v, out, l2, BH, BHkv, S, Sk, qscale, st)
                 : launch<64, false>(q, k, v, out, l2, BH, BHkv, S, Sk, qscale, st);
  else if (D == 128)
    err = causal ? launch<128, true>(q, k, v, out, l2, BH, BHkv, S, Sk, qscale, st)
                 : launch<128, false>(q, k, v, out, l2, BH, BHkv, S, Sk, qscale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* tpu_dra_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
