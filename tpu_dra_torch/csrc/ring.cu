// The ring kernels for Hopper (sm_90a): all-gather-matmul,
// matmul-reduce-scatter and the ring shift, over a ring of n ranks that
// live on one card (a virtual mesh), or one rank a process with its
// neighbours' buffers mapped in (a process ring).
//
// Replaces three TPU kernels of tpu_dra/workloads/pallas_kernels.py:
//   * _ag_matmul_kernel (:1058), called at :1152 by _ag_matmul_call (:1137)
//       -> ring_ag_matmul_kernel, C entry tpu_dra_ring_ag_matmul
//   * _matmul_rs_kernel (:1165), called at :1230 by _matmul_rs_call (:1213)
//       -> ring_matmul_rs_kernel, C entry tpu_dra_ring_matmul_rs
//   * _ring_shift_kernel (:1313), called at :1337 by _ring_shift_call
//     (:1329) -> ring_shift_kernel, C entry tpu_dra_ring_shift
//
// Layout.  Every operand carries the rank axis and a group axis (the
// data-parallel groups, each its own ring): rank r of group g is
// (g, r).  x and w reach the C entries as a base pointer plus a rank
// stride and a group stride in elements (a stride of 0 shares one tensor
// among ranks or groups: a weight replicated over the groups); y, a, comm
// and the shifted output are contiguous [G, n, ...].  The blocks of rank r
// read only rank r's own slots and write only into their own outputs and
// the buffers of rank r + 1 or r - 1: those writes are the reference's
// remote copies, so the device code is what a version over several cards
// would run with peer pointers; only the host side would change.
//
// One launch per ring step covers every rank of every group.  The stream
// order between the step launches stands in for the reference's DMA
// semaphores, its neighbour barrier (:1041-1047) and the RS credit
// handshake (:1191-1210): a launch starts after the previous step's copies
// have landed, so nothing spins on a flag.
//
// A process ring (the *_peer C entries, kLocal): each process launches the
// same per-rank device code for its own rank r0 alone (G = 1, one rank in
// the launch).  Its x, w, y, a and comm hold that rank only (rank and
// group coordinates 0), and the copies to rank r0 +- 1 go through maps on
// the neighbour's a or comm, which the caller allocated with
// tpu_dra_ipc_alloc in that process and opened here with tpu_dra_ipc_open
// (CUDA IPC).  The step order across processes is the caller's: it
// synchronizes its stream after each step launch and meets its group at a
// barrier, before the next step and before a call's first step.  The
// items, the K walk and the rounding points are the virtual ring's, so
// rank r0's outputs are byte-equal to rank r0's slice of a virtual launch.
//
// all-gather-matmul, per rank (reference contract, :1245): x [m, K] is the
// rank's row shard, w [K, N] its own weight; y [n*m, N] = gather(x) . w
// with y's row block s = slot s = rank s's shard, a [n, m, K] the gathered
// operand, byte-exact.  Step i (tpu_dra_ring_ag_matmul with step = i):
//   unidirectional (m odd or n <= 2): slot s = (r - i) mod n; y rows of
//     slot s = a[s] . w; for i < n - 1 slot s is copied into a[s] of rank
//     r + 1.  At i = 0 the slot is x itself, also copied into own a[r].
//   bidirectional (m even and n > 2, the reference's rule at :1151): the
//     high half-rows of slot (r - i) mod n travel right, the low half of
//     slot (r + i) mod n travel left; step i computes those two halves
//     (step 0 both halves of slot r) and forwards them for i < n - 1.
//
// matmul-reduce-scatter, per rank (:1281): x [n*m, K], w [K, N]; y [m, N]
// = (sum over ranks of x . w)[rows of chunk r].  Step t: c = (r - 1 - t)
// mod n; p = x[c] . w in fp32, plus, for t > 0, the fp32 partial that
// arrived from the left in comm[r][t % 2]; for t < n - 1 p goes as fp32
// into comm[r + 1][(t + 1) % 2], on the last step it is rounded into y.
// So chunk c sums in ring order from rank c + 1, each rank adding its own
// product to the running sum, as the reference does; the comm slot that
// step t writes is not the one rank r + 1 reads in the same step.
//
// ring shift (:1349): out[(r + dir) mod n] = x[r], dir = +1 (right) or -1
// (left), byte-exact, with 16-byte vector copies where every rank's block
// is 16-byte aligned (a byte loop otherwise).
//
// What bounds them at the training paths' shapes (H100 SXM: 989 TF/s bf16,
// 3.35 TB/s; n = 4 ranks):
//   AG x [4096, 2048] . wqkv [2048, 1536] per rank: 412 GFLOP, 0.42 ms;
//     x, w, y, a and the 3 ring copies ~ 0.2 GB, 0.06 ms: operations.
//   RS x [16384, 2048] . w2 [2048, 2048] per rank: 550 GFLOP, 0.56 ms:
//     operations (the fp32 partials, 3 x 4 x 32 MB written and read, take
//     ~0.11 ms of bytes beside them).
//   shift of a [16, 16, 256, 128] bf16 block per rank: 134 MB moved,
//     0.04 ms: bytes.
// So both matmuls run on the TMA-fed, warp-specialized wgmma mainloop of
// gemm_sm90.cuh (128 x 256 output tiles, 4 stages of 64-deep K, clusters
// of 2 blocks that multicast each w tile, a persistent grid of one block
// per SM), and the shift is plain wide copies.
// Left for later: steps that overlap (the copy of step i with the product
// of step i), which only several cards make worth having.
//
// Work items.  A launch's items are (rank, segment, pair of row tiles,
// column tile), the rank outermost, so the blocks in flight share one
// rank's weight shard (6-8 MB) and x rows in L2; the two blocks of a
// cluster take the pair's two row tiles and share the w tile.  The RS has
// one segment (its chunk).  Every item walks K from 0 in the same 16-wide
// k-steps, so the two AG directions give bit-equal y.
//
// The gathered operand.  The items of column tile 0 already hold each
// x tile of their rows in shared memory: a side thread of the producer
// warpgroup writes that tile to own a (step 0) and to the neighbour's a
// with TMA stores through a map on a with the same swizzle (so it lands
// unswizzled, rows past the segment and columns past K dropped), and
// releases the stage only once the stores have read it
// (cp.async.bulk.wait_group.read).  Two side threads take the ring's
// slots in turn, so one's wait does not hold back the next stage's
// stores.  No extra read of the slot.
//
// The reduce-scatter's epilogue.  For t > 0 the producer follows an
// item's K stages with three more stages that carry the incoming fp32
// partial as boxes (pieces) of 128 rows x 32 columns (128B swizzled,
// through a map on comm; three to a stage, eight a tile), so the partial
// arrives as early as the ring allows, up to kStages stages ahead,
// instead of being read by the consumers after the product (at t = 0 the
// three stages carry nothing and only give the output room).  Each
// consumer reads its rows of a stage's pieces in the accumulator layout,
// adds its product and, for t < n - 1, writes the sum back in place; one
// thread of each consumer then sends its 64 rows of each piece to rank
// r + 1's comm[(t + 1) % 2] by TMA store (a second map on comm, boxes of
// 64 rows) and the stage is released once the store has read it.  On the
// last step the sum is rounded to bf16 into an unswizzled 64 x 32 box
// over the same half piece and goes to y by TMA store the same way.
//
// Settled here:
//   * strides a tensor map cannot express: w often arrives as an expanded
//     view with group stride 0 (a weight shared by the dp groups, the
//     transposed weights of the backward).  Every operand is one 5-D map
//     (columns, rows, slot or chunk, rank, group) per launch; an axis of
//     stride 0 becomes an axis of size 1 read at coordinate 0 (the `axes`
//     bits).  x is read from x at step 0 and from a later: two maps, both
//     encoded once per call.  The AG's maps are bounded to the segment's
//     rows (a base at its first row), so TMA zero-fills and drops exactly
//     there.  Maps go to the kernel as __grid_constant__ parameters (at
//     most 7 maps, 896 B of the 4 KB: the AG's two peer maps, the RS's one,
//     are encoded for process rings only).
//   * a process ring's copies: TMA stores through maps on the neighbour's
//     IPC-mapped a or comm, the same instruction as into the virtual
//     ring's own buffers.  The map cache's key holds the peer pointers.
//   * host time per launch: the maps of one call are encoded at its first
//     step and reused for the other n − 1 (the C entries keep the last
//     call's key and maps); the shared-memory attribute and the SM count
//     are set and read once per process.
//   * bit-equality of the two AG directions: one K walk for every item.
//   * registers: 56 for the producer warpgroup, 224 for the consumers
//     (128 accumulator registers each); ptxas reports no spills (at 40 /
//     232 the reduce-scatter spilled 8 bytes).

#include <cstring>
#include <mutex>

#include "gemm_sm90.cuh"

namespace {

using namespace gemm90;
using RingConfig = Config<256, 4, 2>;
using C = RingConfig;

__device__ __host__ __forceinline__ int wrap(int v, int n) {
  return ((v % n) + n) % n;
}

// One segment of an AG step: the rows [row0, row0 + rows) of slot
// (r + slot_off) mod n, forwarded to rank r + dst (dst 0: not forwarded)
struct AgSegment {
  int slot_off;
  int row0;
  int dst;
};

// What one AG step computes on every rank: nseg segments of `rows` rows
// each; at the first step the slot is read from x rather than a
struct AgStep {
  int nseg;
  int rows;
  int first;
  AgSegment seg[2];
};

__device__ __forceinline__ AgSegment segment(const AgStep& st, int s) {
  return s == 0 ? st.seg[0] : st.seg[1];
}

// Outer axes a map has (the rest are of size 1, read at coordinate 0);
// kLocal: a process ring's launch, one rank whose own buffers hold it alone
// and whose copies go through the peer maps
constexpr int kXRank = 1, kXGroup = 2, kWRank = 4, kWGroup = 8, kLocal = 16;

// the rank or group coordinate c of a launch's own buffers (a, comm, y)
__device__ __forceinline__ int own(int axes, int c) {
  return axes & kLocal ? 0 : c;
}

// Threads that copy the AG's x tiles into a, one ring slot each in turn
constexpr int kCopiers = 2;
static_assert(C::kStages % kCopiers == 0,
              "each copier owns whole slots of the ring");

// A work item: rank r of group g, segment s, the tile at (m0, n0)
struct Item {
  int g, r, s, m0, n0;
};

// Item w of a launch over `ranks` = G·n ranks, nseg segments, rt groups
// of kCluster row tiles and ct column tiles: the rank outermost, the
// column tile innermost; block `crank` of the cluster takes row tile
// crank of the group
__device__ __forceinline__ Item item_at(int w, int ranks, int n, int nseg,
                                        int rt, int ct, int crank) {
  const int rank = w / (nseg * rt * ct);
  w %= nseg * rt * ct;
  const int s = w / (rt * ct);
  w %= rt * ct;
  return {rank / n, rank % n, s, (w / ct * C::kCluster + crank) * kBM,
          w % ct * C::kBN};
}

// groups of kCluster row tiles over `rows` rows
__host__ __device__ __forceinline__ int row_groups(int rows) {
  const int tiles = (rows + kBM - 1) / kBM;
  return (tiles + C::kCluster - 1) / C::kCluster;
}

struct AgParams {
  CUtensorMap src[2];   // per segment: the slot's rows in x (step 0) or a
  CUtensorMap dst[2];   // per segment: the same rows of a, for the copies
  CUtensorMap w;
  CUtensorMap peer[2];  // kLocal: the same rows of the a the segment goes to
};

struct RsParams {
  CUtensorMap x;        // [G, n, n (chunks), m, K]
  CUtensorMap w;
  CUtensorMap comm;     // fp32 [G, n, 2, m, N], boxes of 128 rows (loads)
  CUtensorMap out;      // the same, boxes of 64 rows (a consumer's stores)
  CUtensorMap y;        // bf16 [G, n, m, N], unswizzled 64 x 32 boxes
  CUtensorMap peer;     // kLocal: rank r0 + 1's comm, as `out`
};

__device__ __forceinline__ Operand w_operand(const CUtensorMap* w, int axes,
                                             int r, int g) {
  return {w, 0, axes & kWRank ? r : 0, axes & kWGroup ? g : 0};
}

__global__ void __cluster_dims__(C::kCluster, 1, 1)
__launch_bounds__(kThreads, 1)
ring_ag_matmul_kernel(const __grid_constant__ AgParams p,
                      __nv_bfloat16* __restrict__ y, int r0, int ranks,
                      int n, int m, int K, int N, int axes, AgStep st) {
  extern __shared__ __align__(16) uint8_t raw[];
  const Ring<C> ring = ring_at<C>(raw);
  init_ring(ring, releases<C>(1));              // + the stage's copier
  const int rt = row_groups(st.rows), ct = (N + C::kBN - 1) / C::kBN;
  const int items = ranks * st.nseg * rt * ct;
  const int nk = (K + kBK - 1) / kBK;
  int it = 0;                                   // stages walked
  auto item = [&](int w) {   // a process ring's launch: rank r0 alone
    Item t = item_at(w, ranks, n, st.nseg, rt, ct, ring.crank);
    t.r += r0;
    return t;
  };

  if (threadIdx.x < kWarpgroup) {
    reg_dealloc<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&p.src[0]);
      prefetch_map(&p.w);
      for_each_item<C>(items, [&](int w) {
        const Item t = item(w);
        const int slot = wrap(t.r + segment(st, t.s).slot_off, n);
        const Operand a{&p.src[t.s], st.first ? 0 : slot,
                        st.first ? (axes & kXRank ? t.r : 0) : own(axes, t.r),
                        st.first ? (axes & kXGroup ? t.g : 0)
                                 : own(axes, t.g)};
        produce_tile(ring, it, nk, a, w_operand(&p.w, axes, t.r, t.g), t.m0,
                     t.n0);
      });
    } else if (threadIdx.x % 32 == 0 && threadIdx.x / 32 <= kCopiers) {
      // the side threads (lane 0 of warps 1 .. kCopiers) take the ring's
      // slots in turn: column tile 0 copies each x tile into own a (step
      // 0) and the neighbour's a, and each stage is released once its
      // stores have read it; a copier waits only for its own stage's
      // stores.  A copier waits for its own stages alone, and since
      // kCopiers divides kStages those are every phase of its slots: a
      // parity wait names the right phase only if the waiter sees each
      // phase of the slot, and a slot advances only once its copier has
      // released it.  (Waiting on another copier's slot could leave it a
      // phase behind there, waiting for a phase that never comes.)
      const int me = threadIdx.x / 32 - 1;
      for_each_item<C>(items, [&](int w) {
        const Item t = item(w);
        const AgSegment sg = segment(st, t.s);
        const int slot = wrap(t.r + sg.slot_off, n);
        const bool copy = t.n0 == 0;
        const bool mine = copy && st.first, peer = copy && sg.dst != 0;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          if (it % kCopiers != me) continue;
          wait_full(ring, it);
          const int stg = it % C::kStages;
          if (mine)
            tma_store_5d(&p.dst[t.s], ring.a_tile(stg), kt * kBK, t.m0, slot,
                         own(axes, t.r), own(axes, t.g));
          if (peer && (axes & kLocal))
            tma_store_5d(&p.peer[t.s], ring.a_tile(stg), kt * kBK, t.m0,
                         slot, 0, 0);
          else if (peer)
            tma_store_5d(&p.dst[t.s], ring.a_tile(stg), kt * kBK, t.m0, slot,
                         wrap(t.r + sg.dst, n), t.g);
          if (mine || peer) {
            tma_store_commit();
            tma_store_wait_read();
          }
          mbar_arrive(&ring.empty[stg]);
        }
      });
    }
  } else {
    reg_alloc<C::kConsumerRegs>();
    const Frag f = Frag::mine();
    float acc[C::kBN / 2];
    for_each_item<C>(items, [&](int w) {
      const Item t = item(w);
      const AgSegment sg = segment(st, t.s);
      consume_tile(ring, acc, it, nk, f.c, f.lane);
      const int slot = wrap(t.r + sg.slot_off, n);
      __nv_bfloat16* yr =
          y + (static_cast<size_t>(own(axes, t.g * n + t.r)) * n * m +
               static_cast<size_t>(slot) * m + sg.row0) * N;
#pragma unroll
      for (int j = 0; j < C::kBN / 8; ++j) {
        const int col = t.n0 + f.col0 + 8 * j;
        if (col >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = t.m0 + f.row0 + 8 * h;
          if (row < st.rows)
            *reinterpret_cast<uint32_t*>(yr + static_cast<size_t>(row) * N +
                                         col) =
                pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    });
  }
  finish_ring<C>();
}

// The reduce-scatter's partials go through the stage ring after the
// item's K stages, as boxes (pieces) of 128 rows x 32 fp32 columns, 128B
// swizzled, kPacked to a stage
constexpr int kPieceCols = kRowBytes / 4;
constexpr int kPieces = C::kBN / kPieceCols;
constexpr int kPacked = C::kStageBytes / C::kABytes;   // pieces a stage

// this thread's float2 of a piece at tile row `row`, piece column `col`
__device__ __forceinline__ float2* piece_at(uint8_t* piece, int row,
                                            int col) {
  return reinterpret_cast<float2*>(
      piece + row * kRowBytes + ((((col * 4) >> 4) ^ (row & 7)) << 4) +
      ((col * 4) & 15));
}

// y's bf16 pair at row `row` (of a consumer's 64), piece column `col` of
// an unswizzled [64][32] box staged over the consumer's half of a piece
__device__ __forceinline__ uint32_t* y_at(uint8_t* half, int row, int col) {
  return reinterpret_cast<uint32_t*>(half + row * kPieceCols * 2 + col * 2);
}

__global__ void __cluster_dims__(C::kCluster, 1, 1)
__launch_bounds__(kThreads, 1)
ring_matmul_rs_kernel(const __grid_constant__ RsParams p,
                      float* __restrict__ comm,    // what p.comm maps
                      __nv_bfloat16* __restrict__ y,  // what p.y maps
                      int r0, int ranks, int n, int m,
                      int K, int N, int axes, int t) {
  extern __shared__ __align__(16) uint8_t raw[];
  const Ring<C> ring = ring_at<C>(raw);
  init_ring(ring, releases<C>(0));
  const int rt = row_groups(m), ct = (N + C::kBN - 1) / C::kBN;
  const int items = ranks * rt * ct;
  const int nk = (K + kBK - 1) / kBK;
  int it = 0;
  auto item = [&](int w) {
    Item t = item_at(w, ranks, n, 1, rt, ct, ring.crank);
    t.r += r0;
    return t;
  };

  if (threadIdx.x < kWarpgroup) {
    reg_dealloc<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&p.x);
      prefetch_map(&p.w);
      prefetch_map(&p.comm);
      prefetch_map(&p.out);
      prefetch_map(&p.y);
      for_each_item<C>(items, [&](int w) {
        const Item u = item(w);
        const int c = (u.r + 2 * n - 1 - t) % n;      // this step's chunk
        const Operand a{&p.x, c, axes & kXRank ? u.r : 0,
                        axes & kXGroup ? u.g : 0};
        produce_tile(ring, it, nk, a, w_operand(&p.w, axes, u.r, u.g), u.m0,
                     u.n0);
        for (int q = 0; q < kPieces; q += kPacked) {
          if (t > 0)                         // the partial from the left
            produce_boxes(ring, it, Operand{&p.comm, t % 2, own(axes, u.r),
                                            own(axes, u.g)},
                          u.n0 + q * kPieceCols, kPieceCols,
                          min(kPacked, kPieces - q), u.m0);
          else                               // room for the output
            produce_nothing(ring, it);
        }
      });
    }
  } else {
    reg_alloc<C::kConsumerRegs>();
    const Frag f = Frag::mine();
    float acc[C::kBN / 2];
    for_each_item<C>(items, [&](int w) {
      const Item u = item(w);
      consume_tile(ring, acc, it, nk, f.c, f.lane);
#pragma unroll
      for (int q0 = 0; q0 < kPieces; q0 += kPacked) {
        constexpr int kJ = kPieceCols / 8;   // column blocks of a piece
        wait_full(ring, it);
        uint8_t* stage = ring.a_tile(it % C::kStages);
        float2 in[kPacked][kJ][2];
        if (t > 0) {                         // the incoming partial
#pragma unroll
          for (int b = 0; b < kPacked; ++b)
#pragma unroll
            for (int j = 0; j < kJ; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                if (q0 + b < kPieces)
                  in[b][j][h] = *piece_at(stage + b * C::kABytes,
                                          f.row0 + 8 * h, f.col0 + 8 * j);
        }
        // y's layout overlaps other threads' partials: all read first
        if (t == n - 1) named_sync(1 + f.c, kWarpgroup);
#pragma unroll
        for (int b = 0; b < kPacked; ++b) {
          if (q0 + b >= kPieces) continue;
          uint8_t* half = stage + b * C::kABytes + f.c * 64 * kRowBytes;
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            const int jj = (q0 + b) * kJ + j;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float2 v = make_float2(acc[4 * jj + 2 * h],
                                     acc[4 * jj + 2 * h + 1]);
              if (t > 0) {
                v.x += in[b][j][h].x;
                v.y += in[b][j][h].y;
              }
              if (t < n - 1)             // the outgoing partial, in place
                *piece_at(stage + b * C::kABytes, f.row0 + 8 * h,
                          f.col0 + 8 * j) = v;
              else                       // y, rounded once
                *y_at(half, f.row0 - 64 * f.c + 8 * h, f.col0 + 8 * j) =
                    pack_bf16(v.x, v.y);
            }
          }
        }
        // the stage's reads and writes before the async proxy's: this
        // consumer's half of each piece goes to rank r + 1's comm (or to
        // y) by TMA store, and the stage is released once the store has
        // read it
        fence_proxy_async();
        named_sync(1 + f.c, kWarpgroup);
        if (threadIdx.x % kWarpgroup == 0) {
          for (int b = 0; b < kPacked && q0 + b < kPieces; ++b) {
            uint8_t* half = stage + b * C::kABytes + f.c * 64 * kRowBytes;
            const int c0 = u.n0 + (q0 + b) * kPieceCols, c1 = u.m0 + 64 * f.c;
            if (t < n - 1 && (axes & kLocal))
              tma_store_5d(&p.peer, half, c0, c1, (t + 1) % 2, 0, 0);
            else if (t < n - 1)
              tma_store_5d(&p.out, half, c0, c1, (t + 1) % 2, (u.r + 1) % n,
                           u.g);
            else
              tma_store_5d(&p.y, half, c0, c1, 0, own(axes, u.r),
                           own(axes, u.g));
          }
          tma_store_commit();
          tma_store_wait_read();
        }
        __syncwarp();
        release(ring, it, f.lane);
        ++it;
      }
    });
  }
  finish_ring<C>();
}

constexpr int kShiftThreads = 256;

__global__ void __launch_bounds__(kShiftThreads)
ring_shift_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                  int n, long long bytes, int dir, int vec) {
  const int r = blockIdx.y % n, g = blockIdx.y / n;
  const size_t base = static_cast<size_t>(g) * n;
  const uint8_t* src = x + (base + r) * bytes;
  uint8_t* dst = out + (base + wrap(r + dir, n)) * bytes;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = bytes / 16;
    for (long long i = first; i < nv; i += stride)
      reinterpret_cast<uint4*>(dst)[i] =
          reinterpret_cast<const uint4*>(src)[i];
    done = nv * 16;
  }
  for (long long i = done + first; i < bytes; i += stride) dst[i] = src[i];
}

// The AG step schedule (see the header)
AgStep ag_step(int n, int m, int i, bool bidir) {
  AgStep st{};
  st.first = i == 0;
  const int fwd = i < n - 1;
  if (!bidir) {
    st.nseg = 1;
    st.rows = m;
    st.seg[0] = {-i, 0, fwd ? 1 : 0};
    return st;
  }
  const int half = m / 2;
  st.nseg = 2;
  st.rows = half;
  st.seg[0] = {-i, half, fwd ? 1 : 0};   // high half, travelling right
  st.seg[1] = {i, 0, fwd ? -1 : 0};      // low half, travelling left
  return st;
}

bool bad_gemm(int G, int n, int rows, int N, int K) {
  return G <= 0 || n <= 0 || rows <= 0 || N <= 0 || K <= 0 || N % 8 ||
         K % 8 || static_cast<long long>(G) * n > 65535;
}

// The last call's arguments and the maps encoded for them: the n step
// launches of one call encode once
template <int KEYS, class Maps>
struct MapCache {
  std::mutex mu;
  long long key[KEYS] = {};
  bool valid = false;
  Maps maps;
};

// The outer-axis bits and the map of w [.., K, N] (rank and group strides
// w_rs, w_gs, 0 where shared)
cudaError_t map_w(CUtensorMap* map, int* axes, const void* w, int G, int n,
                  int K, int N, long long w_rs, long long w_gs) {
  *axes |= (w_rs ? kWRank : 0) | (w_gs ? kWGroup : 0);
  return map_bf16_5d(map, w, {N, K, 1, w_rs ? n : 1, w_gs ? G : 1},
                     {N, 0, w_rs, w_gs}, kBK);
}

struct AgMaps {
  AgParams first;       // src = x
  AgParams later;       // src = a
  int axes;
};

// x, w, a as in tpu_dra_ring_ag_matmul; local: a holds one rank and
// peer[0] / peer[1] are the a of the ranks the high (or only) and the low
// segments go to, right and left
cudaError_t ag_maps(AgMaps* out, const void* x, const void* w, void* a,
                    void* const* peer, int G, int n, int m, int K, int N,
                    long long x_rs, long long x_gs, long long w_rs,
                    long long w_gs, const AgStep& st, bool local) {
  int axes = (x_rs ? kXRank : 0) | (x_gs ? kXGroup : 0) |
             (local ? kLocal : 0);
  cudaError_t err = map_w(&out->first.w, &axes, w, G, n, K, N, w_rs, w_gs);
  const long long slab = static_cast<long long>(m) * K;
  const long long nr = local ? 1 : n;           // ranks each a holds
  for (int s = 0; s < st.nseg && err == cudaSuccess; ++s) {
    const long long row0 = st.seg[s].row0;
    err = map_bf16_5d(&out->first.src[s],
                      static_cast<const __nv_bfloat16*>(x) + row0 * K,
                      {K, st.rows, 1, x_rs ? n : 1, x_gs ? G : 1},
                      {K, 0, x_rs, x_gs}, kBM);
    if (err == cudaSuccess)
      err = map_bf16_5d(&out->first.dst[s],
                        static_cast<const __nv_bfloat16*>(a) + row0 * K,
                        {K, st.rows, n, nr, G},
                        {K, slab, n * slab, n * nr * slab}, kBM);
    if (err == cudaSuccess && local)
      err = map_bf16_5d(&out->first.peer[s],
                        static_cast<const __nv_bfloat16*>(peer[s]) + row0 * K,
                        {K, st.rows, n, 1, 1}, {K, slab, n * slab, n * slab},
                        kBM);
    out->later.src[s] = out->first.dst[s];
    out->later.dst[s] = out->first.dst[s];
    out->later.peer[s] = out->first.peer[s];
  }
  out->later.w = out->first.w;
  out->axes = axes;
  return err;
}

struct RsMaps {
  RsParams params;
  int axes;
};

// local: comm and y hold one rank and peer is rank r0 + 1's comm
cudaError_t rs_maps(RsMaps* out, const void* x, const void* w,
                    const void* comm, const void* peer, const void* y, int G,
                    int n, int m, int K, int N, long long x_rs,
                    long long x_gs, long long w_rs, long long w_gs,
                    bool local) {
  int axes = (x_rs ? kXRank : 0) | (x_gs ? kXGroup : 0) |
             (local ? kLocal : 0);
  cudaError_t err = map_w(&out->params.w, &axes, w, G, n, K, N, w_rs, w_gs);
  const long long chunk = static_cast<long long>(m) * N;
  const long long nr = local ? 1 : n;
  if (err == cudaSuccess)
    err = map_bf16_5d(&out->params.x, x,
                      {K, m, n, x_rs ? n : 1, x_gs ? G : 1},
                      {K, static_cast<long long>(m) * K, x_rs, x_gs}, kBM);
  if (err == cudaSuccess)
    err = map_f32_5d(&out->params.comm, comm, {N, m, 2, nr, G},
                     {N, chunk, 2 * chunk, 2 * nr * chunk}, kBM);
  if (err == cudaSuccess)
    err = map_f32_5d(&out->params.out, comm, {N, m, 2, nr, G},
                     {N, chunk, 2 * chunk, 2 * nr * chunk}, kBM / 2);
  if (err == cudaSuccess && local)
    err = map_f32_5d(&out->params.peer, peer, {N, m, 2, 1, 1},
                     {N, chunk, 2 * chunk, 2 * chunk}, kBM / 2);
  if (err == cudaSuccess)
    err = map_5d(&out->params.y, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, y,
                 {N, m, 1, nr, G}, {N, 0, chunk, nr * chunk}, kBM / 2,
                 kPieceCols, CU_TENSOR_MAP_SWIZZLE_NONE);
  out->axes = axes;
  return err;
}

// blocks in flight on the persistent grid, and the kernel's shared-memory
// attribute, set once per process
template <typename Kernel>
cudaError_t setup(Kernel kernel, long long items, int* blocks) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  cudaError_t err = grid_blocks<C>(items, blocks);
  return err;
}

// One AG step over ranks r0 .. r0 + ranks - 1 (every rank of the virtual
// ring, or a process ring's own rank: local)
int ag_launch(const void* x, const void* w, void* y, void* a,
              void* const* peer, int G, int n, int r0, int ranks, int m,
              int K, int N, long long x_rs, long long x_gs, long long w_rs,
              long long w_gs, int step, int bidir, bool local,
              void* stream) {
  if (bad_gemm(G, n, m, N, K) || step < 0 || step >= n ||
      (bidir && (m % 2 || n <= 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const AgStep st = ag_step(n, m, step, bidir != 0);
  static MapCache<20, AgMaps> cache;
  const long long key[20] = {
      reinterpret_cast<long long>(x), reinterpret_cast<long long>(w),
      reinterpret_cast<long long>(a),
      local ? reinterpret_cast<long long>(peer[0]) : 0,
      local ? reinterpret_cast<long long>(peer[1]) : 0,
      G, n, m, K, N, x_rs, x_gs, w_rs, w_gs, bidir, local, 0, 0, 0, 0};
  AgParams params;
  int axes;
  {
    std::lock_guard<std::mutex> lock(cache.mu);
    if (!cache.valid || std::memcmp(cache.key, key, sizeof key) != 0) {
      cache.valid = false;
      const cudaError_t err = ag_maps(&cache.maps, x, w, a, peer, G, n, m,
                                      K, N, x_rs, x_gs, w_rs, w_gs, st,
                                      local);
      if (err != cudaSuccess) return static_cast<int>(err);
      std::memcpy(cache.key, key, sizeof key);
      cache.valid = true;
    }
    params = st.first ? cache.maps.first : cache.maps.later;
    axes = cache.maps.axes;
  }
  const long long items = static_cast<long long>(ranks) * st.nseg *
                          row_groups(st.rows) * ((N + C::kBN - 1) / C::kBN);
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int blocks;
  cudaError_t err = setup(ring_ag_matmul_kernel, items, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_ag_matmul_kernel<<<blocks, kThreads, C::kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      params, static_cast<__nv_bfloat16*>(y), r0, ranks, n, m, K, N, axes,
      st);
  return static_cast<int>(cudaGetLastError());
}

// One RS step over ranks r0 .. r0 + ranks - 1, as ag_launch
int rs_launch(const void* x, const void* w, void* comm, const void* peer,
              void* y, int G, int n, int r0, int ranks, int m, int K, int N,
              long long x_rs, long long x_gs, long long w_rs, long long w_gs,
              int step, bool local, void* stream) {
  if (bad_gemm(G, n, m, N, K) || step < 0 || step >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  static MapCache<16, RsMaps> cache;
  const long long key[16] = {
      reinterpret_cast<long long>(x), reinterpret_cast<long long>(w),
      reinterpret_cast<long long>(comm), reinterpret_cast<long long>(y),
      local ? reinterpret_cast<long long>(peer) : 0, G, n, m, K, N, x_rs,
      x_gs, w_rs, w_gs, local, 0};
  RsParams params;
  int axes;
  {
    std::lock_guard<std::mutex> lock(cache.mu);
    if (!cache.valid || std::memcmp(cache.key, key, sizeof key) != 0) {
      cache.valid = false;
      const cudaError_t err = rs_maps(&cache.maps, x, w, comm, peer, y, G, n,
                                      m, K, N, x_rs, x_gs, w_rs, w_gs,
                                      local);
      if (err != cudaSuccess) return static_cast<int>(err);
      std::memcpy(cache.key, key, sizeof key);
      cache.valid = true;
    }
    params = cache.maps.params;
    axes = cache.maps.axes;
  }
  const long long items = static_cast<long long>(ranks) * row_groups(m) *
                          ((N + C::kBN - 1) / C::kBN);
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int blocks;
  cudaError_t err = setup(ring_matmul_rs_kernel, items, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_matmul_rs_kernel<<<blocks, kThreads, C::kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      params, static_cast<float*>(comm), static_cast<__nv_bfloat16*>(y), r0,
      ranks, n, m, K, N, axes, step);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches one kernel on
// `stream` and returns its cudaError_t; 0 means it was enqueued.

// Step `step` (0 <= step < n) of the all-gather-matmul; bidir selects the
// half-shard ring (m even and n > 2 only)
extern "C" int tpu_dra_ring_ag_matmul(const void* x, const void* w, void* y,
                                      void* a, int G, int n, int m, int K,
                                      int N, long long x_rs, long long x_gs,
                                      long long w_rs, long long w_gs,
                                      int step, int bidir, void* stream) {
  void* const none[2] = {nullptr, nullptr};
  return ag_launch(x, w, y, a, none, G, n, 0, G * n, m, K, N, x_rs, x_gs,
                   w_rs, w_gs, step, bidir, false, stream);
}

// Step `step` of a process ring's all-gather-matmul for its rank r of n:
// x [m, K] and w [K, N] this rank's, y [n*m, N], a [n, m, K] this
// process's gathered operand, a_right and a_left the a of ranks r + 1 and
// r - 1 (IPC-mapped; a_left is written only by the bidirectional ring)
extern "C" int tpu_dra_ring_ag_matmul_peer(const void* x, const void* w,
                                           void* y, void* a, void* a_right,
                                           void* a_left, int r, int n, int m,
                                           int K, int N, int step, int bidir,
                                           void* stream) {
  if (r < 0 || r >= n || a_right == nullptr || (bidir && a_left == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  void* const peer[2] = {a_right, bidir ? a_left : a_right};
  return ag_launch(x, w, y, a, peer, 1, n, r, 1, m, K, N, 0, 0, 0, 0, step,
                   bidir, true, stream);
}

// Step `step` of the matmul-reduce-scatter; comm is fp32 scratch
// [G, n, 2, m, N] that the caller allocates and keeps across the n steps
extern "C" int tpu_dra_ring_matmul_rs(const void* x, const void* w,
                                      void* comm, void* y, int G, int n,
                                      int m, int K, int N, long long x_rs,
                                      long long x_gs, long long w_rs,
                                      long long w_gs, int step,
                                      void* stream) {
  return rs_launch(x, w, comm, nullptr, y, G, n, 0, G * n, m, K, N, x_rs,
                   x_gs, w_rs, w_gs, step, false, stream);
}

// Step `step` of a process ring's matmul-reduce-scatter for its rank r of
// n: x [n*m, K], w [K, N], y [m, N], comm this process's fp32 [2, m, N]
// and comm_right rank r + 1's (IPC-mapped)
extern "C" int tpu_dra_ring_matmul_rs_peer(const void* x, const void* w,
                                           void* comm, void* comm_right,
                                           void* y, int r, int n, int m,
                                           int K, int N, int step,
                                           void* stream) {
  if (r < 0 || r >= n || comm_right == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return rs_launch(x, w, comm, comm_right, y, 1, n, r, 1, m, K, N, 0, 0, 0,
                   0, step, true, stream);
}

// A process ring's buffer that its neighbours write into: `bytes` of
// device memory from cudaMalloc (the base of its own allocation, as
// cudaIpcGetMemHandle wants) and its 64-byte IPC handle
extern "C" int tpu_dra_ipc_alloc(long long bytes, void** ptr,
                                 char* handle) {
  if (bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  err = cudaIpcGetMemHandle(&h, *ptr);
  if (err != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
    return static_cast<int>(err);
  }
  static_assert(sizeof h == 64, "a CUDA IPC handle is 64 bytes");
  std::memcpy(handle, &h, sizeof h);
  return 0;
}

// Map another process's buffer from its handle (not this process's own:
// CUDA refuses that); peer access across cards is enabled lazily
extern "C" int tpu_dra_ipc_open(const char* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof h);
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int tpu_dra_ipc_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

extern "C" int tpu_dra_ipc_free(void* ptr) {
  return static_cast<int>(cudaFree(ptr));
}

// `bytes` from src to dst on `stream` (a process ring's results out of its
// buffer into tensors the caller owns)
extern "C" int tpu_dra_ipc_copy(void* dst, const void* src, long long bytes,
                                void* stream) {
  return static_cast<int>(cudaMemcpyAsync(
      dst, src, static_cast<size_t>(bytes), cudaMemcpyDeviceToDevice,
      static_cast<cudaStream_t>(stream)));
}

// out[g, (r + dir) mod n] = x[g, r] for blocks of `bytes` bytes, x and out
// contiguous [G, n, bytes]; dir is +1 or -1.  A process ring's shift is
// G = n = 1 with out the neighbour's IPC-mapped buffer: one rank's block
// copied there
extern "C" int tpu_dra_ring_shift(const void* x, void* out, int G, int n,
                                  long long bytes, int dir, void* stream) {
  if (G <= 0 || n <= 0 || bytes <= 0 || (dir != 1 && dir != -1) ||
      static_cast<long long>(G) * n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = bytes % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long units = vec ? bytes / 16 : bytes;
  const long long blocks = (units + kShiftThreads - 1) / kShiftThreads;
  const dim3 grid(static_cast<unsigned>(blocks < 1024 ? blocks : 1024),
                  G * n);
  ring_shift_kernel<<<grid, kShiftThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), n, bytes,
      dir, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpu_dra_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
