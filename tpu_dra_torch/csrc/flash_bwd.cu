// Flash-attention backward for Hopper (sm_90a): the split pair (the dQ
// kernel and the dK/dV kernel) and the single-pass (fused) kernel, all on
// TMA-fed wgmma (hopper.cuh).
//
// Replaces three TPU kernels of tpu_dra/workloads/pallas_kernels.py, all
// reached through _flash_attn_bwd (:543):
//   * _flash_bwd_dq_kernel (:367), called at :661  -> flash_bwd_dq_kernel
//   * _flash_bwd_dkdv_kernel (:453), called at :682 -> flash_bwd_fused_kernel
//                                <D, CAUSAL, false>  (both bwd_impl="split")
//   * _flash_bwd_fused_kernel (:494), called at :633 -> flash_bwd_fused_kernel
//                                <D, CAUSAL, true>   (bwd_impl="fused")
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
//
// What bounds them at the training path's shapes ([256, 1024, 128] causal):
//   dq:    qs, k, v, dout, dq (+ l2, dd)  ~337 MB, 101 us at 3.35 TB/s;
//          three S x S products under the mask, 103 GFLOP, 104 us at
//          989 TF/s: bound ~104 us, on the operations side.
//   dkdv:  qs, k, v, dout, dk, dv (+ l2, dd) ~403 MB, 120 us; four
//          products, 137 GFLOP, 139 us: bound ~139 us, operations.
//   fused: dk, dv and dq from one recompute, five products, 172 GFLOP,
//          174 us; ~470 MB (dq written once in bf16), 140 us: operations.
// So every score tile stays in registers and every product runs on wgmma.
//
// The dQ kernel (flash_bwd_dq_kernel), on the forward's skeleton
// (flash_fwd.cu), dq-major:
//   * a persistent grid of one block per SM, three warpgroups, walking work
//     items of one q head-row each: a pair of 128-row q tiles, the longest
//     and the shortest left under the causal mask, so every item costs
//     about as many k tiles and a static round robin balances the card;
//     items go head by head, so the blocks in flight share K/V in L2.
//     Thread 0 of warpgroup 0 issues every TMA copy: each q tile's qs and
//     dout once, into one of kQBufs buffers (the next tile's land while
//     this one runs), and 64-key tiles of K and V through a ring of
//     kStages buffers (full / empty mbarriers).  The producer warpgroup
//     gives its registers up (setmaxnreg) to warpgroups 1 and 2, the
//     consumers, which own 64 q rows of the tile each.
//   * per k tile j a consumer computes S = qs·Kᵀ and dP = dout·Vᵀ (wgmma
//     m64n64k16, both operands K-major in shared memory), P = exp2(S − l2)
//     masked (ex2.approx on the special-function unit, as the forward),
//     dS = bf16(P∘(dP − dd)) as the next product's A fragments (the
//     accumulator's columns 16 kk.. are k-step kk's A fragment,
//     hopper.cuh), and dq += dS·K (m64nDk16, A from registers, the K tile
//     MN-major as V is in the forward's P·V).  It issues dq_{j-1} ahead of
//     S_j and dP_j, so the tensor cores run the last tile's dq while the
//     exponentials of this one wait for S_j.  l2 and dd are per-row values
//     in the accumulator's own threads: read once per q tile.
//   * dq stays in fp32 registers over every key of the q tile, in key order,
//     and is scaled by D^-0.5 and rounded to bf16 once, then stored from
//     registers.  Under the mask a consumer walks k tiles j while 64 j is at
//     most its last row, so consumer 0 of a diagonal q tile stops one tile
//     before consumer 1: it waits for that tile and releases it unused.
//     TMA zero-fills rows past S and keys past Sk; P is masked past Sk.
//   * no block writes what another writes and nothing is summed across
//     blocks: no scratch, no flags, and dq is the same from run to run.
//     (The fused kernel's dq, summed per 1024-key block through bf16, is
//     a different function of its inputs past Sk = 1024.)
//
// The dK/dV kernel is flash_bwd_fused_kernel<D, CAUSAL, false>: the fused
// kernel's mainloop (below) with its dS copy, its dq product, its writer
// warps, its named barrier and its flags switched off, so it computes its
// four products alone (and its P takes ex2.approx where the fused kernel
// keeps exp2f).  An item's K/V buffer is then free once its last dP^T is
// in, and its smem has room for a second K/V item buffer, so an item's K and V land while the item before
// runs its last q tiles; and its items come from a static walk: pairs of
// one head-row's 128-key items, the longest and the shortest left under
// the causal mask, round robin over the blocks (no counter, no scratch).
//
// The fused kernel (flash_bwd_fused_kernel<D, CAUSAL, true>):
//   * a persistent grid of one block per SM, three warpgroups.  A work item
//     is one (q head-row, 128-key tile); its K and V tiles come in once by
//     TMA.  Warpgroup 0 is the producer: thread 0 takes the next item from
//     a counter in global memory and issues the TMA loads, warp 1 stages
//     each q tile's l2 and dd, warps 2 and 3 are the dq writers (below);
//     it keeps 24 registers (setmaxnreg) and gives the rest to warpgroups
//     1 and 2, the consumers, which own 64 of the item's keys each, with
//     their dK and dV accumulators in registers.
//   * 64-row tiles of qs and dout stream through a ring of kStages buffers
//     (full / empty mbarriers), from the last q tile down to the one that
//     holds the item's first key under the causal mask (all of them
//     otherwise): every item of a head-row starts at the same last tile,
//     so the items that add into one dq tile reach it together.  TMA
//     zero-fills rows past S and keys past Sk; P is masked there.
//   * all five products are wgmma: S^T = K.qs^T and dP^T = V.dout^T
//     (m64n64k16, both operands K-major in shared memory); dV +=
//     bf16(P^T).dout and dK += bf16(dS^T).qs (m64nDk16, A from registers:
//     the score accumulator is its own A fragment, hopper.cuh; dout and qs
//     MN-major); dq = dS.K (m64n64k16 per 64 dq columns, 8 k-steps over the
//     item's 128 keys) reads bf16(dS) from ONE shared-memory copy: each
//     consumer stores its dS^T rows (keys) as the accumulator holds them,
//     q contiguous, 128B-swizzled, and wgmma reads that tile as an
//     MN-major A operand (the transpose bit for A); K is its MN-major B.
//     dS goes through two such buffers in turn, so one named barrier per
//     q tile (both halves stored) is all the consumers share.
//   * dq without per-tile slots, still deterministic.  dqacc holds one fp32
//     accumulator per reference k block j (KV_BLOCK keys, pallas_kernels.py
//     :658): [n_j, BH, S, D].  A consumer stages its [64, 64] dq half tile
//     (128B-swizzled fp32 pieces); lane 0 of its writer
//     warp waits until the flag of (j, head-row, q tile, half) in global
//     memory equals the item's position in key order within j, writes
//     (position 0) or adds (the others) the tile into dqacc by TMA (a bulk
//     store, or a bulk reduce-add, which L2 applies), waits for the writes
//     to complete, fences and releases the flag to position + 1.  Only the
//     flags are zeroed per call; dqacc needs no memset.
//   * the sum's order: the 128-key items of block j in key order, each
//     item's own sum over its 128 keys as wgmma takes it (8 k-steps of 16
//     keys, in key order).  Then dq = bf16(sum_j f32(bf16(acc_j)) * scale),
//     the reference's rounding points: where n_j = 1 the last item of a q
//     tile takes the sum back by TMA and forms dq in place of a release (no
//     second pass), else finish_dq_kernel does after the launch.
//   * no deadlock: items are handed out from one counter, each head-row's
//     in ascending key order (head-rows in groups of 64, key tile outer
//     within a group), and a block takes its next item only when it has
//     one to run, so an item waits only for items of smaller index, each
//     held by a running block that is not waiting on a later one.  A
//     group's accumulators (32 MB at the flagship) stay in L2 while they
//     are summed, and a head-row's items start 64 apart, so the later ones
//     rarely wait for their flags.
//
// Rounding points, pinned here (no output check sees all of them): qs is
// rounded by the caller; bf16(P) feeds dv while dS uses the fp32 P; dS is
// rounded to bf16 once, and those bf16 values feed both dK and dq; dq's
// scale and dk's 1/log2 e multiply the fp32 sums before the single
// rounding to bf16 at the store (the fused kernel's per-block dq partial
// rounded to bf16 first, as the reference does).

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr float kInvLog2e = static_cast<float>(1.0 / flash::kLog2e);

// blocks of a persistent grid: one per SM, or one per work item where
// there are fewer
inline cudaError_t grid_blocks(int items, int* blocks) {
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = items < sms ? items : sms;
  return err;
}

// ---------------------------------------------------------------------------
// The dQ kernel (see the header)
// ---------------------------------------------------------------------------

namespace dqk {

using flash::for_each_tile;
using namespace hopper;

constexpr int kBQ = 128;          // q rows per tile, 64 per consumer
constexpr int kBK = 64;           // keys per K/V tile (S and dP are m64n64)
constexpr int kStages = 3;        // buffers in the K/V ring
constexpr int kQBufs = 2;         // qs/dout tile buffers
constexpr int kWarpgroup = 128;
constexpr int kThreadsDq = 3 * kWarpgroup;
constexpr int kConsumerWarps = 8;
// 40 · 128 + 232 · 256 = 64,512, the 168 · 384 registers the block starts
// with (setmaxnreg.inc only takes what the block's warps gave back)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kRowBytes = 128;    // one swizzled row of a 64-column box

// Shared memory, from a 1024-byte aligned base: kQBufs buffers of a q
// tile's qs and dout, the K/V ring (each stage K, then V), the barriers.
template <int D>
struct Smem {
  static constexpr int kBoxes = D / 64;
  static constexpr int kQBox = kBQ * kRowBytes;          // one 64-column box
  static constexpr int kKVBox = kBK * kRowBytes;
  static constexpr int kQTile = kBoxes * kQBox;          // qs or dout
  static constexpr int kQBuf = 2 * kQTile;               // qs, then dout
  static constexpr int kQ = 0;
  static constexpr int kKV = kQ + kQBufs * kQBuf;
  static constexpr int kStage = 2 * kBoxes * kKVBox;     // K, then V
  static constexpr int kBar = kKV + kStages * kStage;
  static constexpr int kBars = 2 * kQBufs + 2 * kStages;
  static constexpr int kBytes = kBar + kBars * 8 + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "shared memory over the 227 KB a block has");
};

// q tile `tile` uses buffer tile % kQBufs, k tile `ik` (the block's running
// count) stage ik % kStages
struct Barriers {
  uint64_t* q_full;     // [kQBufs] qs and dout have landed
  uint64_t* q_empty;    // [kQBufs] the tile's last S and dP are done
  uint64_t* kv_full;    // [kStages] K and V have landed
  uint64_t* kv_empty;   // [kStages] the tile's dq product (K's last reader)
                        // is done
};

struct Params {
  const float* l2;
  const float* dd;
  __nv_bfloat16* dq;
  int BH, S, Sk, group;
  float scale;
};

// k tiles that rows before `row_end` need: under the mask while kBK * j is
// at most the last row, else all of Sk
template <bool CAUSAL>
__device__ __forceinline__ int key_tiles(int row_end, int Sk) {
  const int kv_end = CAUSAL ? min(Sk, row_end) : Sk;
  return (kv_end + kBK - 1) / kBK;
}

// d (64 x N) = A·B with both operands K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss_kmajor(float (&d)[N / 2],
                                                uint64_t da, uint64_t db,
                                                int accumulate) {
  if constexpr (N == 64)
    wgmma_ss_n64<0, 0>(d, da, db, accumulate);
  else
    wgmma_ss_n128<0>(d, da, db, accumulate);
}

// d = A·Bᵀ over D for one consumer: A its 64 rows at a_addr of a q tile
// (boxes kQBox apart), B the kBK rows of a K or V tile at b_addr (boxes
// kKVBox apart); issued and committed, not waited for
template <int D>
__device__ __forceinline__ void issue_nt(float (&d)[kBK / 2], uint32_t a_addr,
                                         uint32_t b_addr) {
  using L = Smem<D>;
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_kmajor<kBK>(
        d, desc_sw128(a_addr + (kk / 4) * L::kQBox + (kk % 4) * 32, 16, 1024),
        desc_sw128(b_addr + (kk / 4) * L::kKVBox + (kk % 4) * 32, 16, 1024),
        kk > 0);
  wgmma_commit();
  fence_regs(d);
}

// dq += dS·K: A the bf16 dS fragments, B the K tile at k_addr MN-major
// (issued and committed, not waited for)
template <int D>
__device__ __forceinline__ void issue_dq(float (&dq)[D / 2],
                                         const uint32_t (&pa)[kBK / 16][4],
                                         uint32_t k_addr) {
  using L = Smem<D>;
  fence_regs(dq);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs<D, 1>(dq, pa[kk],
                   desc_sw128(k_addr + kk * 16 * kRowBytes, L::kKVBox, 1024));
  wgmma_commit();
  fence_regs(dq);
}

// Where a consumer thread sits: its warpgroup's 64 rows of the tile and
// its two rows and columns in the wgmma fragments.
struct Consumer {
  int c;        // consumer 0 or 1: rows 64 c .. 64 c + 63 of a q tile
  int lane;
  int row_l;    // its rows in the warpgroup's 64: row_l and row_l + 8
  int col_t;    // its first column in each 8-column block
};

// One q tile (q head-row bh, rows q0 ..) for one consumer warpgroup; `it`
// is the block's running count of k tiles, `tile` of q tiles.
template <int D, bool CAUSAL>
__device__ __forceinline__ void consume_tile(uint8_t* base,
                                             const Barriers& bar,
                                             const Params& p,
                                             const Consumer& me, int tile,
                                             int it, int q0, int bh) {
  using L = Smem<D>;
  const int q_first = q0 + 64 * me.c;                // this consumer's rows
  const int row0 = q_first + me.row_l;
  const int qb = tile % kQBufs;
  const uint32_t q_addr =
      smem_u32(base + L::kQ + qb * L::kQBuf) + me.c * 64 * kRowBytes;
  const uint32_t do_addr = q_addr + L::kQTile;
  const uint32_t kv_ring = smem_u32(base + L::kKV);
  auto k_at = [&](int j) { return kv_ring + ((it + j) % kStages) * L::kStage; };
  const int n_all = key_tiles<CAUSAL>(q0 + kBQ, p.Sk);   // the producer's
  const int n_mine = key_tiles<CAUSAL>(q_first + 64, p.Sk);

  const size_t off = static_cast<size_t>(bh) * p.S;
  float l2r[2], ddr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    l2r[h] = row < p.S ? p.l2[off + row] : 0.f;
    ddr[h] = row < p.S ? p.dd[off + row] : 0.f;
  }
  mbar_wait(&bar.q_full[qb], (tile / kQBufs) & 1);

  float dq[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
  float s[kBK / 2], dp[kBK / 2];
  uint32_t pa[kBK / 16][4];
  for (int j = 0; j < n_mine; ++j) {
    const int ik = it + j;
    const uint32_t k_addr = k_at(j);
    mbar_wait(&bar.kv_full[ik % kStages], (ik / kStages) & 1);
    if (j > 0) issue_dq<D>(dq, pa, k_at(j - 1));   // dq += dS_{j-1}·K_{j-1}
    issue_nt<D>(s, q_addr, k_addr);                  // S_j = qs·K_jᵀ
    issue_nt<D>(dp, do_addr, k_addr + L::kBoxes * L::kKVBox);  // dout·V_jᵀ
    wgmma_wait<1>();               // dq_{j-1} and S_j are in; dP_j runs on
    fence_regs(dq);
    fence_regs(s);
    if (j > 0 && me.lane == 0)
      mbar_arrive(&bar.kv_empty[(ik - 1) % kStages]);

    // P = exp2(S − l2), fp32; element x is (row row0 + 8 h, key k0 + 8
    // (x >> 2) + col_t + (x & 1)) with h = (x >> 1) & 1
    const int k0 = j * kBK;
    const bool masked = k0 + kBK > p.Sk || (CAUSAL && k0 + kBK - 1 > q_first);
#pragma unroll
    for (int x = 0; x < kBK / 2; ++x) {
      const int h = (x >> 1) & 1;
      bool keep = true;
      if (masked) {
        const int key = k0 + 8 * (x >> 2) + me.col_t + (x & 1);
        keep = CAUSAL ? key <= row0 + 8 * h : key < p.Sk;
      }
      s[x] = keep ? flash::exp2_ftz(s[x] - l2r[h]) : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    if (j == n_mine - 1 && me.lane == 0) mbar_arrive(&bar.q_empty[qb]);
    // dS = P∘(dP − dd) with the fp32 P, rounded to bf16 here, once:
    // register pa[kk][e] holds columns 16 kk + 8 (e >> 1) + col_t, +1 of
    // row row0 + 8 (e & 1)
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 8 * kk + 2 * e;
        pa[kk][e] = flash::pack_bf16(s[x] * (dp[x] - ddr[e & 1]),
                                     s[x + 1] * (dp[x + 1] - ddr[e & 1]));
      }
  }
  issue_dq<D>(dq, pa, k_at(n_mine - 1));
  wgmma_wait<0>();
  fence_regs(dq);
  if (me.lane == 0) {
    mbar_arrive(&bar.kv_empty[(it + n_mine - 1) % kStages]);
    // tiles the other consumer's rows need and these do not: wait for
    // each (its stage's last phase is then complete) and release it
    for (int j = n_mine; j < n_all; ++j) {
      const int ik = it + j;
      mbar_wait(&bar.kv_full[ik % kStages], (ik / kStages) & 1);
      mbar_arrive(&bar.kv_empty[ik % kStages]);
    }
  }
  __syncwarp();

  // dq = bf16(acc · D^-0.5), once; element 4 jj + 2 h + e is (row row0 + 8
  // h, column 8 jj + col_t + e)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= p.S) continue;
    __nv_bfloat16* o = p.dq + (off + row) * D + me.col_t;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<uint32_t*>(o + 8 * jj) = flash::pack_bf16(
          dq[4 * jj + 2 * h] * p.scale, dq[4 * jj + 2 * h + 1] * p.scale);
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreadsDq, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const Params p) {
  using L = Smem<D>;
  extern __shared__ __align__(16) uint8_t raw[];
  uint8_t* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kBar);
  const Barriers bar{bars, bars + kQBufs, bars + 2 * kQBufs,
                     bars + 2 * kQBufs + kStages};
  const int n_qt = (p.S + kBQ - 1) / kBQ;

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < kQBufs; ++qb) {
      mbar_init(&bar.q_full[qb], 1);
      mbar_init(&bar.q_empty[qb], kConsumerWarps);
    }
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&bar.kv_full[st], 1);
      mbar_init(&bar.kv_empty[st], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  int tile = 0, it = 0;       // q tiles and k tiles this block has walked
  if (threadIdx.x < kWarpgroup) {
    // producer: per q tile, qs and dout once their buffer's last tile is
    // done with them, then its k tiles' K and V in key order
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      prefetch_map(&tm_do);
      for_each_tile(n_qt, p.BH, [&](int bh, int qt) {
        const int kvh = bh / p.group;
        const int n_k = key_tiles<CAUSAL>(qt * kBQ + kBQ, p.Sk);
        const int qb = tile % kQBufs;
        uint8_t* qbuf = base + L::kQ + qb * L::kQBuf;
        mbar_wait(&bar.q_empty[qb], ((tile / kQBufs) & 1) ^ 1);
        mbar_expect_tx(&bar.q_full[qb], L::kQBuf);
        for (int b = 0; b < L::kBoxes; ++b) {
          tma_load(qbuf + b * L::kQBox, &tm_q, &bar.q_full[qb], b * 64,
                   qt * kBQ, bh);
          tma_load(qbuf + L::kQTile + b * L::kQBox, &tm_do, &bar.q_full[qb],
                   b * 64, qt * kBQ, bh);
        }
        for (int j = 0; j < n_k; ++j) {
          const int ik = it + j, st = ik % kStages;
          uint8_t* stage = base + L::kKV + st * L::kStage;
          mbar_wait(&bar.kv_empty[st], ((ik / kStages) & 1) ^ 1);
          mbar_expect_tx(&bar.kv_full[st], L::kStage);
          for (int b = 0; b < L::kBoxes; ++b) {
            tma_load(stage + b * L::kKVBox, &tm_k, &bar.kv_full[st], b * 64,
                     j * kBK, kvh);
            tma_load(stage + (L::kBoxes + b) * L::kKVBox, &tm_v,
                     &bar.kv_full[st], b * 64, j * kBK, kvh);
          }
        }
        it += n_k;
        ++tile;
      });
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % kWarpgroup, lane = tid % 32;
    const Consumer me{static_cast<int>(threadIdx.x) / kWarpgroup - 1, lane,
                      16 * (tid / 32) + (lane >> 2), 2 * (lane & 3)};
    for_each_tile(n_qt, p.BH, [&](int bh, int qt) {
      consume_tile<D, CAUSAL>(base, bar, p, me, tile, it, qt * kBQ, bh);
      it += key_tiles<CAUSAL>(qt * kBQ + kBQ, p.Sk);
      ++tile;
    });
  }
}

template <int D, bool CAUSAL>
cudaError_t launch(const void* qs, const void* k, const void* v,
                   const void* dout, const void* l2, const void* dd,
                   void* dq, int BH, int BHkv, int S, int Sk, float scale,
                   cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err;
  if ((err = tensor_map_bf16(&tm_q, qs, BH, S, D, kBQ)) != cudaSuccess ||
      (err = tensor_map_bf16(&tm_do, dout, BH, S, D, kBQ)) != cudaSuccess ||
      (err = tensor_map_bf16(&tm_k, k, BHkv, Sk, D, kBK)) != cudaSuccess ||
      (err = tensor_map_bf16(&tm_v, v, BHkv, Sk, D, kBK)) != cudaSuccess)
    return err;
  auto kernel = flash_bwd_dq_kernel<D, CAUSAL>;
  constexpr int bytes = Smem<D>::kBytes;
  static const cudaError_t attr = flash::allow_smem(kernel, bytes);
  if (attr != cudaSuccess) return attr;
  int blocks;
  if ((err = grid_blocks(BH * ((S + 2 * kBQ - 1) / (2 * kBQ)), &blocks)) !=
      cudaSuccess)
    return err;
  const Params p{static_cast<const float*>(l2), static_cast<const float*>(dd),
                 static_cast<__nv_bfloat16*>(dq), BH, S, Sk, BH / BHkv,
                 scale};
  kernel<<<blocks, kThreadsDq, bytes, stream>>>(tm_q, tm_k, tm_v, tm_do, p);
  return cudaGetLastError();
}

}  // namespace dqk

// ---------------------------------------------------------------------------
// The fused kernel on TMA and wgmma, and with DQ = false the dK/dV kernel
// (see the header)
// ---------------------------------------------------------------------------

namespace fused {

using namespace hopper;

constexpr int kItemKeys = 128;    // keys per work item, 64 per consumer
constexpr int kQRows = 64;        // q rows per streamed tile
constexpr int kStages = 2;        // buffers in the q-tile ring
constexpr int kWarpgroup = 128;
constexpr int kThreadsFused = 3 * kWarpgroup;
constexpr int kConsumerWarps = 8;
// 24 · 128 + 240 · 256 = 64,512, the 168 · 384 registers the block starts
// with (setmaxnreg.inc only takes what the block's warps gave back)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kRowBytes = 128;    // one swizzled row of a 64-column box
constexpr int kPieceCols = 32;    // fp32 columns of a staged dq piece
constexpr int kPieceBytes = 64 * kRowBytes;   // [64 rows][32 fp32], swizzled
constexpr int kDsReady = 1;       // named barrier: both halves of dS stored
constexpr int kGroup = 64;        // head-rows whose items the walk interleaves

// K/V item buffers: one with dq (its dS and dq tiles take the room),
// two without, so an item's K and V land while the one before runs
__host__ __device__ constexpr int kv_bufs(bool dq) { return dq ? 1 : 2; }

// Shared memory, from a 1024-byte aligned base: the items' K and V tiles
// (kKVBufs buffers, each K then V), the q-tile ring (qs, then dout), with
// DQ two dS^T tiles and the staged dq half tiles, each stage's l2 and dd,
// the barriers and the item indices.
template <int D, bool DQ>
struct Smem {
  static constexpr int kBoxes = D / 64;                  // also dq halves
  static constexpr int kKVBox = kItemKeys * kRowBytes;   // 16 KB
  static constexpr int kQBox = kQRows * kRowBytes;       // 8 KB
  static constexpr int kKVBufs = kv_bufs(DQ);
  static constexpr int kKVBytes = 2 * kBoxes * kKVBox;   // one item's K, V
  static constexpr int kK = 0;
  static constexpr int kV = kK + kBoxes * kKVBox;
  static constexpr int kRing = kKVBufs * kKVBytes;
  static constexpr int kStageBytes = 2 * kBoxes * kQBox;
  static constexpr int kDS = kRing + kStages * kStageBytes;
  // [128 keys][64 q], and one dq half tile
  static constexpr int kDSBytes = DQ ? kItemKeys * kRowBytes : 0;
  static constexpr int kDq = kDS + 2 * kDSBytes;
  static constexpr int kDqBytes = DQ ? 2 * kPieceBytes : 0;
  static constexpr int kStat = kDq + kBoxes * kDqBytes;
  static constexpr int kBar = kStat + kStages * 2 * kQRows * 4;
  static constexpr int kBars = 2 * kKVBufs + 2 * kStages + 6;
  static constexpr int kItem = kBar + kBars * 8;
  static constexpr int kBytes = kItem + 4 * kKVBufs + 16 + 1024;  // + slack
  static_assert(kBytes <= 232448, "shared memory over the 227 KB a block has");
};

// item n of a block uses K/V buffer b = n % kKVBufs, phase (n / kKVBufs) & 1
struct Barriers {
  uint64_t* kv_full;    // [kKVBufs] the item's K, V (and its index) have
                        // landed
  uint64_t* kv_empty;   // [kKVBufs] the item's last product that reads K/V
                        // is done, and its writers have read its index
  uint64_t* q_full;     // [kStages] qs, dout (TMA) and l2, dd (warp 1)
  uint64_t* q_empty;    // [kStages] every product of the tile is done
  uint64_t* dq_full;    // [2] a consumer's dq half tile is staged
  uint64_t* dq_empty;   // [2] its writer is done with it
  uint64_t* dq_back;    // [2] the block's sum is back for dq to be formed
};

// What the launch shares with every role of the block
struct Params {
  const float* l2;
  const float* dd;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* dqacc;         // [n_j, BH, S, D] fp32
  int* flags;           // [n_j, BH, n_qt, 2], zeroed by the launch
  int* next;            // the item counter, zeroed by the launch
  __nv_bfloat16* dq;    // written here when direct
  int BH, S, Sk, group, n_kt, n_qt, per_j, direct;
  float scale;
};

// item w = (head-row bh, key tile kt): head-rows in groups of kGroup, and
// within a group the key tile outer and the head-row inner.  A head-row's
// key tiles come in ascending order, so every item that one waits for has
// a smaller index; its items are kGroup apart, so each starts when the one
// before has done part of its q tiles and rarely waits for its flags; and a
// group's accumulators (kGroup x 512 KB at S 1024, D 128) stay in L2.
struct Item {
  int bh, kt, first;    // first: the lowest q tile the item's keys reach
};

template <bool CAUSAL>
__device__ __forceinline__ Item item_at(int w, const Params& p) {
  const int g0 = w / (kGroup * p.n_kt) * kGroup, gs = min(kGroup, p.BH - g0);
  const int bh = g0 + (w - g0 * p.n_kt) % gs, kt = (w - g0 * p.n_kt) / gs;
  return {bh, kt, CAUSAL ? kt * kItemKeys / kQRows : 0};
}

// item w of the dK/dV kernel (DQ = false): the key tile outer and the
// head-row inner, so in index order the longest items under the causal
// mask (the first key tiles) come first
template <bool CAUSAL>
__device__ __forceinline__ Item kv_item_at(int w, const Params& p) {
  const int bh = w % p.BH, kt = w / p.BH;
  return {bh, kt, CAUSAL ? kt * kItemKeys / kQRows : 0};
}

// The block's items in order, as thread 0 of the producer publishes them:
// f(item, K/V buffer) for each, until the walk runs out.  A dq writer lags
// a q tile behind the consumers, a whole item where the item has one q
// tile, so it also holds the next item back (`hold`: its warp's arrival on
// kv_empty once it has read the index), and the index and kv_full's phase
// never run two items ahead of it.
template <bool CAUSAL, bool DQ, typename F>
__device__ __forceinline__ void for_each_item(const Barriers& bar,
                                              const volatile int* s_item,
                                              const Params& p, bool hold,
                                              F&& f) {
  constexpr int kBufs = kv_bufs(DQ);
  for (int n = 0;; ++n) {
    const int b = n % kBufs;
    mbar_wait(&bar.kv_full[b], (n / kBufs) & 1);
    const int w = s_item[b];
    if (w < 0) return;
    if (hold) {
      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive(&bar.kv_empty[b]);
    }
    f(DQ ? item_at<CAUSAL>(w, p) : kv_item_at<CAUSAL>(w, p), b);
  }
}

// the causal mask within a tile is needed where a query may precede a key
// of the consumer's 64, or past the ragged ends
template <bool CAUSAL>
__device__ __forceinline__ bool tile_masked(int q0, int kc, int S, int Sk) {
  return q0 + kQRows > S || kc + 64 > Sk || (CAUSAL && q0 < kc + 63);
}

template <int D, bool CAUSAL, bool DQ>
__global__ void __launch_bounds__(kThreadsFused, 1)
flash_bwd_fused_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_acc,
                       const Params p) {
  using L = Smem<D, DQ>;
  constexpr int B = L::kKVBufs;
  extern __shared__ __align__(16) uint8_t raw[];
  uint8_t* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kBar);
  const Barriers bar{bars, bars + B, bars + 2 * B, bars + 2 * B + kStages,
                     bars + 2 * B + 2 * kStages, bars + 2 * B + 2 * kStages + 2,
                     bars + 2 * B + 2 * kStages + 4};
  volatile int* s_item = reinterpret_cast<volatile int*>(base + L::kItem);
  const int items = p.BH * p.n_kt;

  if (threadIdx.x == 0) {
    for (int b = 0; b < B; ++b) {
      mbar_init(&bar.kv_full[b], 1);
      // the consumer warps at the item's end, the dq writers at its start
      mbar_init(&bar.kv_empty[b], kConsumerWarps + (DQ ? L::kBoxes : 0));
    }
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&bar.q_full[st], 2);
      mbar_init(&bar.q_empty[st], kConsumerWarps);
    }
    for (int c = 0; c < 2; ++c) {
      mbar_init(&bar.dq_full[c], 4);
      mbar_init(&bar.dq_empty[c], 1);
      mbar_init(&bar.dq_back[c], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  int t = 0;     // q tiles this block has walked (all roles count alike)
  if (threadIdx.x < kWarpgroup) {
    reg_dealloc<kProducerRegs>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      prefetch_map(&tm_do);
      // item n takes K/V buffer n % B once the item before in it is done;
      // then its index (-1: no more), its K and V, its q tiles from the
      // last down
      auto claim = [&](int n) {
        mbar_wait(&bar.kv_empty[n % B], ((n / B) & 1) ^ 1);
      };
      auto produce = [&](int n, int w) {
        const int b = n % B;
        s_item[b] = w;
        if (w < 0) {
          mbar_arrive(&bar.kv_full[b]);
          return;
        }
        const Item it = DQ ? item_at<CAUSAL>(w, p) : kv_item_at<CAUSAL>(w, p);
        const int kvh = it.bh / p.group;
        uint8_t* kv = base + b * L::kKVBytes;
        mbar_expect_tx(&bar.kv_full[b], L::kKVBytes);
        for (int bx = 0; bx < L::kBoxes; ++bx) {
          tma_load(kv + L::kK + bx * L::kKVBox, &tm_k, &bar.kv_full[b],
                   bx * 64, it.kt * kItemKeys, kvh);
          tma_load(kv + L::kV + bx * L::kKVBox, &tm_v, &bar.kv_full[b],
                   bx * 64, it.kt * kItemKeys, kvh);
        }
        for (int i = p.n_qt - 1; i >= it.first; --i, ++t) {
          const int st = t % kStages;
          uint8_t* stage = base + L::kRing + st * L::kStageBytes;
          mbar_wait(&bar.q_empty[st], ((t / kStages) & 1) ^ 1);
          mbar_expect_tx(&bar.q_full[st], L::kStageBytes);
          for (int bx = 0; bx < L::kBoxes; ++bx) {
            tma_load(stage + bx * L::kQBox, &tm_q, &bar.q_full[st], bx * 64,
                     i * kQRows, it.bh);
            tma_load(stage + (L::kBoxes + bx) * L::kQBox, &tm_do,
                     &bar.q_full[st], bx * 64, i * kQRows, it.bh);
          }
        }
      };
      if constexpr (DQ) {
        // the next item from the counter, once its buffer is free
        for (int n = 0;; ++n) {
          claim(n);
          const int w = atomicAdd(p.next, 1);
          produce(n, w < items ? w : -1);
          if (w >= items) break;
        }
      } else {
        // pairs of one head-row's items, the longest and the shortest left
        // under the causal mask, round robin over the blocks
        const int n_pairs = (p.n_kt + 1) / 2;
        int n = 0;
        for (int pw = blockIdx.x; pw < p.BH * n_pairs; pw += gridDim.x) {
          const int bh = pw / n_pairs, pr = pw % n_pairs;
          claim(n);
          produce(n++, pr * p.BH + bh);
          if (pr != p.n_kt - 1 - pr) {
            claim(n);
            produce(n++, (p.n_kt - 1 - pr) * p.BH + bh);
          }
        }
        claim(n);
        produce(n, -1);
      }
    } else if (warp == 1) {
      // each q tile's l2 and dd into its stage (0 past S)
      for_each_item<CAUSAL, DQ>(bar, s_item, p, false, [&](const Item& it, int) {
        for (int i = p.n_qt - 1; i >= it.first; --i, ++t) {
          const int st = t % kStages;
          float* stat = reinterpret_cast<float*>(base + L::kStat) +
                        st * 2 * kQRows;
          mbar_wait(&bar.q_empty[st], ((t / kStages) & 1) ^ 1);
          const size_t off = static_cast<size_t>(it.bh) * p.S;
          for (int r = lane; r < kQRows; r += 32) {
            const int row = i * kQRows + r;
            stat[r] = row < p.S ? p.l2[off + row] : 0.f;
            stat[kQRows + r] = row < p.S ? p.dd[off + row] : 0.f;
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&bar.q_full[st]);
        }
      });
    } else if (DQ && warp >= 2 && warp - 2 < L::kBoxes) {
      // writer of dq columns 64 c .. 64 c + 63: lane 0 adds each staged
      // half tile into dqacc[j] by TMA, in key order behind its flag; where
      // the item is the last of its block j at the q tile (and n_j = 1),
      // the sum comes back by TMA and the warp forms dq from it
      const int c = warp - 2;
      uint8_t* sq = base + L::kDq + c * L::kDqBytes;
      int formed = 0;
      for_each_item<CAUSAL, DQ>(bar, s_item, p, true, [&](const Item& it, int) {
        const int j = it.kt / p.per_j, pos = it.kt - j * p.per_j;
        const int j_last = min((j + 1) * p.per_j, p.n_kt) - 1;
        for (int i = p.n_qt - 1; i >= it.first; --i, ++t) {
          mbar_wait(&bar.dq_full[c], t & 1);
          // the last item of block j that reaches q tile i
          const int last =
              CAUSAL ? min(j_last, (i * kQRows + kQRows - 1) / kItemKeys)
                     : j_last;
          const bool form = p.direct && it.kt == last;
          const int z = j * p.BH + it.bh;     // dqacc [n_j * BH, S, D]
          if (lane == 0) {
            int* flag = p.flags + (static_cast<size_t>(z) * p.n_qt + i) * 2 + c;
            // a flag that never comes would hang the card: after ~2^24
            // polls the kernel traps, and the launch reports the fault
            for (int spin = 0; ld_acquire_gpu(flag) != pos; ++spin)
              if (spin > (1 << 24)) __trap();
            fence_proxy_async_global();
            for (int pc = 0; pc < 2; ++pc) {
              const int col = 64 * c + pc * kPieceCols;
              if (pos == 0)
                tma_store(&tm_acc, sq + pc * kPieceBytes, col, i * kQRows, z);
              else
                tma_reduce_add(&tm_acc, sq + pc * kPieceBytes, col,
                               i * kQRows, z);
            }
            tma_store_commit();
            tma_store_wait_all();
            fence_proxy_async_global();
            if (form) {
              mbar_expect_tx(&bar.dq_back[c], 2 * kPieceBytes);
              for (int pc = 0; pc < 2; ++pc)
                tma_load(sq + pc * kPieceBytes, &tm_acc, &bar.dq_back[c],
                         64 * c + pc * kPieceCols, i * kQRows, z);
            } else {
              __threadfence();
              st_release_gpu(flag, pos + 1);
            }
          }
          if (form) {
            // dq = bf16(f32(bf16(partial)) * scale), the one block's sum
            mbar_wait(&bar.dq_back[c], formed++ & 1);
            const size_t row0 = static_cast<size_t>(it.bh) * p.S + i * kQRows;
            const int rows = min(kQRows, p.S - i * kQRows);
            for (int idx = lane; idx < rows * 16; idx += 32) {
              const int r = idx >> 4, c4 = (idx & 15) * 4;
              const int pc = c4 / kPieceCols, x = (c4 % kPieceCols) * 4;
              const float4 v = *reinterpret_cast<const float4*>(
                  sq + pc * kPieceBytes + r * kRowBytes +
                  (((x >> 4) ^ (r & 7)) << 4));
              auto r16 = [&](float y) {
                return __bfloat162float(__float2bfloat16_rn(y)) * p.scale;
              };
              uint2 out;
              out.x = flash::pack_bf16(r16(v.x), r16(v.y));
              out.y = flash::pack_bf16(r16(v.z), r16(v.w));
              *reinterpret_cast<uint2*>(p.dq + (row0 + r) * D + 64 * c + c4) =
                  out;
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&bar.dq_empty[c]);
        }
      });
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int c = static_cast<int>(threadIdx.x) / kWarpgroup - 1;
    const int tid = threadIdx.x % kWarpgroup, warp = tid / 32, lane = tid % 32;
    const int row_l = 16 * warp + (lane >> 2);   // +8: the fragment's 2nd row
    const int col_t = 2 * (lane & 3);
    const bool dq_mine = DQ && c < L::kBoxes;
    float dk[D / 2], dv[D / 2];
    for_each_item<CAUSAL, DQ>(bar, s_item, p, false, [&](const Item& it, int b) {
      const int kc = it.kt * kItemKeys + 64 * c;     // this consumer's keys
      const uint32_t k_addr = smem_u32(base + b * L::kKVBytes + L::kK);
      const uint32_t v_addr = smem_u32(base + b * L::kKVBytes + L::kV);
#pragma unroll
      for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.f;
      for (int i = p.n_qt - 1; i >= it.first; --i, ++t) {
        const int st = t % kStages;
        const int q0 = i * kQRows;
        uint8_t* stage = base + L::kRing + st * L::kStageBytes;
        const uint32_t q_addr = smem_u32(stage);
        const uint32_t do_addr = q_addr + L::kBoxes * L::kQBox;
        const float* sl2 =
            reinterpret_cast<const float*>(base + L::kStat) + st * 2 * kQRows;
        const float* sdd = sl2 + kQRows;
        mbar_wait(&bar.q_full[st], (t / kStages) & 1);

        // S^T = K_c · qs^T and dP^T = V_c · dout^T, 64 keys x 64 queries
        float s[32], dp[32];
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * L::kKVBox + c * 64 * kRowBytes +
                               (kk % 4) * 32;
          const uint32_t qoff = (kk / 4) * L::kQBox + (kk % 4) * 32;
          wgmma_ss_n64<0, 0>(s, desc_sw128(k_addr + off, 16, 1024),
                             desc_sw128(q_addr + qoff, 16, 1024), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * L::kKVBox + c * 64 * kRowBytes +
                               (kk % 4) * 32;
          const uint32_t qoff = (kk / 4) * L::kQBox + (kk % 4) * 32;
          wgmma_ss_n64<0, 0>(dp, desc_sw128(v_addr + off, 16, 1024),
                             desc_sw128(do_addr + qoff, 16, 1024), kk > 0);
        }
        wgmma_commit();
        fence_regs(s);
        fence_regs(dp);
        wgmma_wait<1>();
        fence_regs(s);

        // P^T = exp2(S^T - l2), fp32; element x is (key row_l + 8 h,
        // query 8 j + col_t + e) with x = 4 j + 2 h + e
        const bool masked = tile_masked<CAUSAL>(q0, kc, p.S, p.Sk);
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int qi = 8 * (x >> 2) + col_t + (x & 1);
          bool keep = true;
          if (masked) {
            const int key = kc + row_l + 8 * ((x >> 1) & 1);
            keep = q0 + qi < p.S && key < p.Sk && (!CAUSAL || q0 + qi >= key);
          }
          // exp2f in the fused kernel, the SFU's ex2.approx in the dK/dV
          // kernel (as in the dQ kernel and the forward)
          const float e = s[x] - sl2[qi];
          s[x] = keep ? (DQ ? exp2f(e) : flash::exp2_ftz(e)) : 0.f;
        }
        // bf16(P^T) as dV's A fragments: columns 16 kk .. 16 kk + 15
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pa[kk][e] = flash::pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        wgmma_wait<0>();
        fence_regs(dp);
        // without dq, K and V are read by S^T and dP^T alone
        if (!DQ && i == it.first && lane == 0) mbar_arrive(&bar.kv_empty[b]);

        // dV += bf16(P^T) · dout (dout MN-major)
        fence_regs(dv);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<D, 1>(dv, pa[kk],
                         desc_sw128(do_addr + kk * 16 * kRowBytes, L::kQBox,
                                    1024));
        wgmma_commit();
        fence_regs(dv);

        // dS^T = P^T ∘ (dP^T − dd) with the fp32 P^T, while dV runs
#pragma unroll
        for (int x = 0; x < 32; ++x)
          dp[x] = s[x] * (dp[x] - sdd[8 * (x >> 2) + col_t + (x & 1)]);
        wgmma_wait<0>();
        fence_regs(dv);

        // dS rounded to bf16 here, once: dK's A fragments and dq's A tile
        uint8_t* ds = base + L::kDS + (t & 1) * L::kDSBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pa[kk][e] = flash::pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
        if constexpr (DQ) {
          // dS^T rows (keys 64 c + row) as the accumulator holds them, q
          // contiguous, 128B-swizzled: register pa[kk][e] is (row_l + 8 (e
          // & 1), queries 16 kk + 8 (e >> 1) + col_t, +1)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = 64 * c + row_l + 8 * (e & 1);
              const int chunk = 2 * kk + (e >> 1);
              *reinterpret_cast<uint32_t*>(
                  ds + row * kRowBytes + ((chunk ^ (row & 7)) << 4) +
                  col_t * 2) = pa[kk][e];
            }
        }

        // dK += bf16(dS^T) · qs (qs MN-major)
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<D, 1>(dk, pa[kk],
                         desc_sw128(q_addr + kk * 16 * kRowBytes, L::kQBox,
                                    1024));
        wgmma_commit();
        fence_regs(dk);

        float dq[32];
        if constexpr (DQ) {
          // both consumers' halves of dS stored and visible to wgmma
          fence_proxy_async();
          named_sync(kDsReady, 2 * kWarpgroup);
          if (dq_mine) {
            // dq columns 64 c .. = dS · K over the item's 128 keys: A the
            // dS^T tile MN-major, B the K tile's box c MN-major
            const uint32_t ds_addr = smem_u32(ds);
            fence_regs(dq);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kItemKeys / 16; ++kk)
              wgmma_ss_n64<1, 1>(
                  dq, desc_sw128(ds_addr + kk * 16 * kRowBytes, L::kDSBytes,
                                 1024),
                  desc_sw128(k_addr + c * L::kKVBox + kk * 16 * kRowBytes,
                             L::kKVBox, 1024),
                  kk > 0);
            wgmma_commit();
            fence_regs(dq);
          }
        }
        wgmma_wait<0>();
        fence_regs(dk);
        if constexpr (DQ) fence_regs(dq);
        if (lane == 0) {
          mbar_arrive(&bar.q_empty[st]);
          if (DQ && i == it.first) mbar_arrive(&bar.kv_empty[b]);
        }
        if (dq_mine) {
          // stage the fp32 half tile for the writer, once it has read the
          // last one: two pieces of 32 columns, 128B-swizzled as TMA reads
          // them, then visible to the async proxy
          mbar_wait(&bar.dq_empty[c], (t & 1) ^ 1);
          uint8_t* sq = base + L::kDq + c * L::kDqBytes;
#pragma unroll
          for (int x = 0; x < 32; x += 2) {
            const int row = row_l + 8 * ((x >> 1) & 1);
            const int col = 8 * (x >> 2) + col_t;
            const int bb = (col % kPieceCols) * 4;
            *reinterpret_cast<float2*>(
                sq + (col / kPieceCols) * kPieceBytes + row * kRowBytes +
                (((bb >> 4) ^ (row & 7)) << 4) + (bb & 15)) =
                make_float2(dq[x], dq[x + 1]);
          }
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(&bar.dq_full[c]);
        }
      }
      // dk = bf16(acc / log2 e), dv = bf16(acc), per q head-row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = kc + row_l + 8 * h;
        if (key >= p.Sk) continue;
        const size_t off = (static_cast<size_t>(it.bh) * p.Sk + key) * D + col_t;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          *reinterpret_cast<uint32_t*>(p.dk + off + 8 * jj) = flash::pack_bf16(
              dk[4 * jj + 2 * h] * kInvLog2e, dk[4 * jj + 2 * h + 1] * kInvLog2e);
          *reinterpret_cast<uint32_t*>(p.dv + off + 8 * jj) =
              flash::pack_bf16(dv[4 * jj + 2 * h], dv[4 * jj + 2 * h + 1]);
        }
      }
    });
  }
}

// dq = bf16(sum_j f32(bf16(acc_j)) * scale) over BH * S * D elements, four
// per thread (D is 64 or 128); under the causal mask block j holds a q
// tile's rows only if its first key is at most the tile's last row
template <bool CAUSAL>
__global__ void __launch_bounds__(256)
finish_dq_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ dq,
                 int BH, int S, int D, int n_j, int kv_block, float scale) {
  const size_t n = static_cast<size_t>(BH) * S * D;
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) * 4;
  if (i >= n) return;
  const int row = static_cast<int>(i / D % S);
  const int tile_end = row / kQRows * kQRows + kQRows - 1;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < n_j; ++j) {
    if (CAUSAL && j * kv_block > tile_end) break;
    const float4 a = *reinterpret_cast<const float4*>(acc + j * n + i);
    s[0] += __bfloat162float(__float2bfloat16_rn(a.x));
    s[1] += __bfloat162float(__float2bfloat16_rn(a.y));
    s[2] += __bfloat162float(__float2bfloat16_rn(a.z));
    s[3] += __bfloat162float(__float2bfloat16_rn(a.w));
  }
  uint2 out;
  out.x = flash::pack_bf16(s[0] * scale, s[1] * scale);
  out.y = flash::pack_bf16(s[2] * scale, s[3] * scale);
  *reinterpret_cast<uint2*>(dq + i) = out;
}

// The scratch: dqacc [n_j, BH, S, D] fp32, then the flags [n_j, BH, n_qt,
// 2] and the item counter (int32)
struct Layout {
  int n_kt, n_qt, per_j, n_j;

  Layout(int S, int Sk, int kv_block)
      : n_kt((Sk + kItemKeys - 1) / kItemKeys),
        n_qt((S + kQRows - 1) / kQRows),
        per_j(kv_block / kItemKeys),
        n_j((Sk + kv_block - 1) / kv_block) {}
};

template <int D, bool CAUSAL>
cudaError_t launch(const void* qs, const void* k, const void* v,
                   const void* dout, const void* l2, const void* dd, void* dk,
                   void* dv, void* scratch, void* dq, int BH, int BHkv,
                   int S, int Sk, int kv_block, float scale,
                   cudaStream_t stream) {
  const Layout lay(S, Sk, kv_block);
  float* acc = static_cast<float*>(scratch);
  int* flags = reinterpret_cast<int*>(acc + lay.n_j * static_cast<size_t>(BH) * S * D);
  const size_t flag_ints = static_cast<size_t>(lay.n_j) * BH * lay.n_qt * 2;
  const int direct = lay.n_j == 1;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_acc;
  cudaError_t err;
  if ((err = tensor_map_f32(&tm_acc, acc, lay.n_j * BH, S, D, kQRows)) !=
          cudaSuccess ||
      (err = tensor_map_bf16(&tm_q, qs, BH, S, D, kQRows)) != cudaSuccess ||
      (err = tensor_map_bf16(&tm_do, dout, BH, S, D, kQRows)) != cudaSuccess ||
      (err = tensor_map_bf16(&tm_k, k, BHkv, Sk, D, kItemKeys)) != cudaSuccess ||
      (err = tensor_map_bf16(&tm_v, v, BHkv, Sk, D, kItemKeys)) != cudaSuccess)
    return err;
  if ((err = cudaMemsetAsync(flags, 0, (flag_ints + 1) * sizeof(int),
                             stream)) != cudaSuccess)
    return err;
  auto kernel = flash_bwd_fused_kernel<D, CAUSAL, true>;
  constexpr int bytes = Smem<D, true>::kBytes;
  static const cudaError_t attr = flash::allow_smem(kernel, bytes);
  if (attr != cudaSuccess) return attr;
  const int items = BH * lay.n_kt;
  int blocks;
  if ((err = grid_blocks(items, &blocks)) != cudaSuccess) return err;
  const Params p{static_cast<const float*>(l2), static_cast<const float*>(dd),
                 static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
                 acc, flags, flags + flag_ints, static_cast<__nv_bfloat16*>(dq),
                 BH, S, Sk, BH / BHkv, lay.n_kt, lay.n_qt, lay.per_j, direct,
                 scale};
  kernel<<<blocks, kThreadsFused, bytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_acc, p);
  if ((err = cudaGetLastError()) != cudaSuccess || direct) return err;
  const size_t n = static_cast<size_t>(BH) * S * D;
  const unsigned fin = static_cast<unsigned>((n / 4 + 255) / 256);
  if (CAUSAL)
    finish_dq_kernel<true><<<fin, 256, 0, stream>>>(
        acc, static_cast<__nv_bfloat16*>(dq), BH, S, D, lay.n_j, kv_block,
        scale);
  else
    finish_dq_kernel<false><<<fin, 256, 0, stream>>>(
        acc, static_cast<__nv_bfloat16*>(dq), BH, S, D, lay.n_j, kv_block,
        scale);
  return cudaGetLastError();
}

// The dK/dV kernel: the fused kernel without dq (no scratch: its tm_acc is
// never read, and the walk is static)
template <int D, bool CAUSAL>
cudaError_t launch_dkdv(const void* qs, const void* k, const void* v,
                      const void* dout, const void* l2, const void* dd,
                      void* dk, void* dv, int BH, int BHkv, int S, int Sk,
                      cudaStream_t stream) {
  const int n_kt = (Sk + kItemKeys - 1) / kItemKeys;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err;
  if ((err = tensor_map_bf16(&tm_q, qs, BH, S, D, kQRows)) != cudaSuccess ||
      (err = tensor_map_bf16(&tm_do, dout, BH, S, D, kQRows)) != cudaSuccess ||
      (err = tensor_map_bf16(&tm_k, k, BHkv, Sk, D, kItemKeys)) != cudaSuccess ||
      (err = tensor_map_bf16(&tm_v, v, BHkv, Sk, D, kItemKeys)) != cudaSuccess)
    return err;
  auto kernel = flash_bwd_fused_kernel<D, CAUSAL, false>;
  constexpr int bytes = Smem<D, false>::kBytes;
  static const cudaError_t attr = flash::allow_smem(kernel, bytes);
  if (attr != cudaSuccess) return attr;
  int blocks;
  if ((err = grid_blocks(BH * ((n_kt + 1) / 2), &blocks)) != cudaSuccess)
    return err;
  const Params p{static_cast<const float*>(l2), static_cast<const float*>(dd),
                 static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
                 nullptr, nullptr, nullptr, nullptr,
                 BH, S, Sk, BH / BHkv, n_kt, (S + kQRows - 1) / kQRows, 0, 0,
                 0.f};
  kernel<<<blocks, kThreadsFused, bytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_q, p);
  return cudaGetLastError();
}

}  // namespace fused

bool bad_shape(int BH, int BHkv, int S, int Sk, int causal) {
  return BH <= 0 || BHkv <= 0 || BH % BHkv != 0 || S <= 0 || Sk <= 0 ||
         BH > 65535 || (causal && S != Sk);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns the cudaError_t
// of its tensor-map encodes and launch; 0 means the kernel was enqueued on
// `stream`.
extern "C" int tpu_dra_flash_bwd_dq(const void* qs, const void* k,
                                    const void* v, const void* dout,
                                    const void* l2, const void* dd, void* dq,
                                    int BH, int BHkv, int S, int Sk, int D,
                                    int causal, float scale, void* stream) {
  if (bad_shape(BH, BHkv, S, Sk, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64)
    err = causal ? dqk::launch<64, true>(qs, k, v, dout, l2, dd, dq, BH, BHkv, S, Sk, scale, st)
                 : dqk::launch<64, false>(qs, k, v, dout, l2, dd, dq, BH, BHkv, S, Sk, scale, st);
  else if (D == 128)
    err = causal ? dqk::launch<128, true>(qs, k, v, dout, l2, dd, dq, BH, BHkv, S, Sk, scale, st)
                 : dqk::launch<128, false>(qs, k, v, dout, l2, dd, dq, BH, BHkv, S, Sk, scale, st);
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
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64)
    err = causal ? fused::launch_dkdv<64, true>(qs, k, v, dout, l2, dd, dk, dv, BH, BHkv, S, Sk, st)
                 : fused::launch_dkdv<64, false>(qs, k, v, dout, l2, dd, dk, dv, BH, BHkv, S, Sk, st);
  else if (D == 128)
    err = causal ? fused::launch_dkdv<128, true>(qs, k, v, dout, l2, dd, dk, dv, BH, BHkv, S, Sk, st)
                 : fused::launch_dkdv<128, false>(qs, k, v, dout, l2, dd, dk, dv, BH, BHkv, S, Sk, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The fused kernel: dk, dv as tpu_dra_flash_bwd_dkdv and dq [BH, S, D] bf16
// with `scale` = D^-0.5, dq's fp32 sums per block of kv_block keys (a
// positive multiple of 128) summed in key order through `scratch`, which
// the caller allocates uninitialised, 16-byte aligned: dqacc [n_j, BH, S,
// D] fp32 (n_j = ceil(Sk / kv_block)), then n_j * BH * ceil(S / 64) * 2 + 1
// int32 flags, which the launch zeroes.
extern "C" int tpu_dra_flash_bwd_fused(const void* qs, const void* k,
                                       const void* v, const void* dout,
                                       const void* l2, const void* dd,
                                       void* dk, void* dv, void* scratch,
                                       void* dq, int BH, int BHkv, int S,
                                       int Sk, int D, int causal, int kv_block,
                                       float scale, void* stream) {
  if (bad_shape(BH, BHkv, S, Sk, causal) || kv_block <= 0 ||
      kv_block % fused::kItemKeys)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64)
    err = causal ? fused::launch<64, true>(qs, k, v, dout, l2, dd, dk, dv, scratch, dq, BH, BHkv, S, Sk, kv_block, scale, st)
                 : fused::launch<64, false>(qs, k, v, dout, l2, dd, dk, dv, scratch, dq, BH, BHkv, S, Sk, kv_block, scale, st);
  else if (D == 128)
    err = causal ? fused::launch<128, true>(qs, k, v, dout, l2, dd, dk, dv, scratch, dq, BH, BHkv, S, Sk, kv_block, scale, st)
                 : fused::launch<128, false>(qs, k, v, dout, l2, dd, dk, dv, scratch, dq, BH, BHkv, S, Sk, kv_block, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* tpu_dra_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
