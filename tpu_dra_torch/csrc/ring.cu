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
//     (:1329) -> ring_shift_kernel (virtual ring), ring_shift_peer_kernel
//     (process ring), C entries tpu_dra_ring_shift and _peer
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
// One launch a call.  A matmul's launch runs all n ring steps of every
// rank of every group, as the reference's kernel runs its whole ring
// (:1083-1098, :1191-1206), and synchronizes inside the kernel, on flags
// in global memory in place of the reference's DMA semaphores:
//   * the flags.  Each ring has an int32 flag buffer, flag_words(n) words
//     a rank (the virtual ring's [G, n, words], a process ring's one rank
//     per process, tpu_dra_ipc_alloc'd and opened by its neighbours like
//     a and comm): per gathered slot and segment, per partial slot, the
//     two neighbour-barrier words, the shift's delivery word, and the
//     writer-side arrival counts.
//   * the epochs.  A flag is never reset: the caller numbers its calls on
//     a ring (the epoch, 1, 2, ...; the buffer starts zeroed) and a flag
//     is written with the epoch of the call that delivered its data, so a
//     waiter waits for flag >= epoch and a value left by an earlier call
//     never satisfies it (the reference drains its semaphores to zero at
//     exit, :1208-1210, instead).  The arrival counts do return to zero:
//     the last arrival resets its count before it publishes.
//   * the writer.  A thread that copied rows into a neighbour's a (or a
//     partial into its comm) by TMA store waits for the stores' completion
//     (cp.async.bulk.wait_group 0: their writes performed, not merely
//     their shared-memory source read, as the stage release's .read form
//     waits), fences the async proxy against the generic one
//     (fence.proxy.async.global), then adds one to the slot's arrival
//     count with atom.acq_rel; the arrival that completes the count
//     resets it and publishes the neighbour's flag with st.release.  On a
//     process ring both are at system scope (.sys), so the code is the
//     one a ring over several cards runs; the virtual ring's ranks all
//     live on one card, and there they are at GPU scope (.gpu): at system
//     scope there the w2 call took 993.8 us against 922.0 and the wo call
//     494.4 against 453.8 (H100 80GB HBM3, 700 W; kernels.variants ring).
//   * the reader.  The producer thread, before it loads a gathered slot or
//     an incoming partial, spins on ld.acquire of the flag (at the scope
//     of the release) until it holds the call's epoch, then issues
//     fence.proxy.async.global: without that fence the TMA read (the
//     async proxy) could be ordered before the acquire and see the slot's
//     stale bytes.
//   * the neighbour barrier (a process ring only, the reference's
//     _ring_neighbor_barrier, :1041-1047: "a remote DMA must never land in
//     a peer's unallocated scratch").  Every block raises its rank's
//     started word in both neighbours with the call's epoch, and a thread
//     waits for the neighbour's started word before its first store into
//     that neighbour.  The neighbour's kernel for this call has started,
//     so by its stream order its copy out of the previous call's a, comm
//     or shift buffer is done: calls on a process ring need no host
//     synchronize and no group barrier between them.
//   * the reduce-scatter's partials.  comm holds n - 1 slots a rank (max(n
//     - 1, 1) at the C level), partial t in slot t, each written once a
//     call and read once: no slot is reused within a call, so the
//     reference's credit semaphore (cap_sem, :1191-1206) has no
//     counterpart.  The cost: (n - 1) m N fp32 a rank, 96 MB at w2 (m =
//     4096, N = 2048, n = 4; the double buffer took 64 MB), 384 MB over a
//     virtual ring of 4.  Across calls the virtual ring's stream order and
//     the process ring's neighbour barrier order the slot's reuse.
//   * co-residency.  Blocks wait for each other, so every block of the
//     persistent grid must be resident at once: the grid is the number of
//     clusters of 2 that cudaOccupancyMaxActiveClusters reports (not the
//     SM count), or fewer where there are fewer items.  Items are dispensed
//     step-major ((step, group, rank, segment, row pair, column tile),
//     round robin over the clusters; on the virtual ring the ranks of a
//     step rotate with it, item_rank), and every wait is for items of an
//     earlier step, so the earliest unfinished item's cluster is always at
//     it and its waits are met: the ring cannot deadlock.  (A block counts
//     an item's outgoing partial at the item's end, before its next item,
//     whose epilogue may wait for it.)
//   * the spin bound.  A wait reads %globaltimer; past the bound
//     (tpu_dra_ring_set_timeout, 30 s unless set) the waiting thread
//     writes a fault record (kernel, group, rank, step, epoch, what it
//     waited for) into host-mapped memory and traps.  The Python side
//     reads the record (tpu_dra_ring_fault) and raises naming the ring,
//     rank and step: a neighbour that never comes is an error, not a hang.
//   * the overlap.  A gathered tile's forward store is issued from the
//     stage the product reads, before that product, so the copy to rank
//     r + 1 travels while the product of its slot runs; the blocks of
//     step t + 1 run their products while step t's partials land (a
//     tile's partial waited for and counted after the block's next
//     product instead left the RS no faster on an H100, and spilled).
//
// A process ring (the *_peer C entries, kLocal): each process launches the
// same per-rank device code for its own rank r0 alone (G = 1, one rank in
// the launch).  Its x, w, y, a, comm and flags hold that rank only (rank
// and group coordinates 0), and the copies and flags for rank r0 +- 1 go
// through maps on the neighbour's a, comm or flags, which the caller
// allocated with tpu_dra_ipc_alloc in that process and opened here with
// tpu_dra_ipc_open (CUDA IPC).  The items, the K walk and the rounding
// points are the virtual ring's, so rank r0's outputs are byte-equal to
// rank r0's slice of a virtual launch.
//
// all-gather-matmul, per rank (reference contract, :1245): x [m, K] is the
// rank's row shard, w [K, N] its own weight; y [n*m, N] = gather(x) . w
// with y's row block s = slot s = rank s's shard, a [n, m, K] the gathered
// operand, byte-exact.  Step i:
//   unidirectional (m odd or n <= 2): slot s = (r - i) mod n; y rows of
//     slot s = a[s] . w; for i < n - 1 slot s is copied into a[s] of rank
//     r + 1.  At i = 0 the slot is x itself, also copied into own a[r].
//   bidirectional (m even and n > 2, the reference's rule at :1151): the
//     high half-rows of slot (r - i) mod n travel right, the low half of
//     slot (r + i) mod n travel left; step i computes those two halves
//     (step 0 both halves of slot r) and forwards them for i < n - 1.
//   A slot's segment, read at step i >= 1, waits on its flag, which the
//   neighbour's copiers publish at step i - 1 once all its rows landed.
//
// matmul-reduce-scatter, per rank (:1281): x [n*m, K], w [K, N]; y [m, N]
// = (sum over ranks of x . w)[rows of chunk r].  Step t: c = (r - 1 - t)
// mod n; p = x[c] . w in fp32, plus, for t > 0, the fp32 partial that
// arrived from the left in comm[r][t - 1] (waited for on its flag); for
// t < n - 1 p goes as fp32 into comm[r + 1][t], on the last step it is
// rounded into y.  So chunk c sums in ring order from rank c + 1, each
// rank adding its own product to the running sum, as the reference does.
//
// ring shift (:1349): out[(r + dir) mod n] = x[r], dir = +1 (right) or -1
// (left), byte-exact, with 16-byte vector copies where every rank's block
// is 16-byte aligned (a byte loop otherwise).  The virtual ring's shift
// waits for nothing.  A process ring's: the neighbour barrier, the copy,
// and the last block to finish publishes the receiver's delivery word,
// then waits for its own, so the caller's copy out follows the kernel.
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
// of 2 blocks that multicast each w tile, a persistent grid), and the
// shift is plain wide copies.
//
// Work items.  A launch's items are (step, rank, segment, pair of row
// tiles, column tile), the step outermost, then the rank, so the blocks in
// flight share one rank's weight shard (6-8 MB) and x rows in L2; the two
// blocks of a cluster take the pair's two row tiles and share the w tile.
// The RS has one segment (its chunk).  Every item walks K from 0 in the
// same 16-wide k-steps, so the two AG directions give bit-equal y.
//
// The gathered operand.  The items of column tile 0 already hold each
// x tile of their rows in shared memory: a side thread of the producer
// warpgroup writes that tile to own a (step 0) and to the neighbour's a
// with TMA stores through a map on a with the same swizzle (so it lands
// unswizzled, rows past the segment and columns past K dropped), and
// releases the stage only once the stores have read it
// (cp.async.bulk.wait_group.read).  Two side threads take the ring's
// slots in turn, so one's wait does not hold back the next stage's
// stores; each arrives on the slot's count once an item (kCopiers
// arrivals a block, row_groups x kCluster blocks a segment).  No extra
// read of the slot.
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
// r + 1's comm[t] by TMA store (a second map on comm, boxes of 64 rows),
// the stage is released once the store has read it, and after the item's
// last piece the thread waits for its stores to complete and arrives on
// the step's count (two consumers a block, every block of the step's
// items).  On the last step the sum is rounded to bf16 into an unswizzled
// 64 x 32 box over the same half piece and goes to y by TMA store the
// same way.
//
// Settled here:
//   * strides a tensor map cannot express: w often arrives as an expanded
//     view with group stride 0 (a weight shared by the dp groups, the
//     transposed weights of the backward).  Every operand is one 5-D map
//     (columns, rows, slot or chunk, rank, group) per launch; an axis of
//     stride 0 becomes an axis of size 1 read at coordinate 0 (the `axes`
//     bits).  x is read from x at step 0 and from a later: two maps a
//     segment.  The AG's maps are bounded to the segment's rows (a base at
//     its first row), so TMA zero-fills and drops exactly there.  Maps go
//     to the kernel as __grid_constant__ parameters (at most 7 maps, 896 B
//     of the 4 KB: the AG's two peer maps, the RS's one, are encoded for
//     process rings only).
//   * a process ring's copies: TMA stores through maps on the neighbour's
//     IPC-mapped a or comm, the same instruction as into the virtual
//     ring's own buffers.  The map cache's key holds the peer pointers.
//   * host time per launch: the last call's maps are kept and reused when
//     the pointers and shapes repeat; the shared-memory attribute and the
//     resident cluster count are set and read once per process.
//   * bit-equality of the two AG directions: one K walk for every item.
//   * registers: 56 for the producer warpgroup, 224 for the consumers
//     (128 accumulator registers each).

#include <atomic>
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

// Segment s of step i (see the header): one segment of m rows, or (bidir)
// the high half travelling right and the low half travelling left, each
// `rows` = m / 2 rows
__device__ __forceinline__ AgSegment ag_segment(int i, int s, int n,
                                                int rows, bool bidir) {
  const int fwd = i < n - 1;
  if (!bidir) return {-i, 0, fwd};
  return s == 0 ? AgSegment{-i, rows, fwd} : AgSegment{i, 0, -fwd};
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

// A work item: ring step `step` of rank r of group g, segment s, the tile
// at (m0, n0)
struct Item {
  int step, g, r, s, m0, n0;
};

// Item w of a launch over n steps of `ranks` = G·n ranks, nseg segments,
// rt groups of kCluster row tiles and ct column tiles: the step outermost,
// then the rank, the column tile innermost; block `crank` of the cluster
// takes row tile crank of the group
__device__ __forceinline__ Item item_at(int w, int ranks, int n, int nseg,
                                        int rt, int ct, int crank) {
  const int step = w / (ranks * nseg * rt * ct);
  w %= ranks * nseg * rt * ct;
  const int rank = w / (nseg * rt * ct);
  w %= nseg * rt * ct;
  const int s = w / (rt * ct);
  w %= rt * ct;
  return {step, rank / n, rank % n, s, (w / ct * C::kCluster + crank) * kBM,
          w % ct * C::kBN};
}

// The rank of an item whose rank position within its group and step is
// t.r: on the virtual ring the positions rotate with the step, so that
// the item a wait is for, of rank r - 1 (or r + 1) one step earlier,
// lies a whole step of items back (n - 2 ranks' worth at least), not
// just before the waiting one; a process ring's launch holds rank r0
__device__ __forceinline__ int item_rank(const Item& t, int n, int r0,
                                         bool local) {
  return local ? r0 : (t.r + t.step) % n;
}

// groups of kCluster row tiles over `rows` rows
__host__ __device__ __forceinline__ int row_groups(int rows) {
  const int tiles = (rows + kBM - 1) / kBM;
  return (tiles + C::kCluster - 1) / C::kCluster;
}

// --------------------------------------------------------------------------
// the flags (see the header)
// --------------------------------------------------------------------------

// A rank's words: the neighbour barrier's started words (raised by the
// left and by the right neighbour), the shift's delivery word and its
// arrival count, then per gathered slot and segment a flag, per forwarded
// slot and segment an arrival count, per partial slot a flag and an
// arrival count
constexpr int kFromLeft = 0, kFromRight = 1, kShiftFlag = 2, kShiftCount = 3,
              kAgFlags = 4;

__host__ __device__ __forceinline__ int ag_flag(int slot, int s) {
  return kAgFlags + 2 * slot + s;
}
__host__ __device__ __forceinline__ int ag_count(int n, int slot, int s) {
  return kAgFlags + 2 * n + 2 * slot + s;
}
__host__ __device__ __forceinline__ int rs_flag(int n, int t) {
  return kAgFlags + 4 * n + t;
}
__host__ __device__ __forceinline__ int rs_count(int n, int t) {
  return kAgFlags + 5 * n + t;
}
// words a rank, whole 128-byte lines
__host__ __device__ __forceinline__ int flag_words(int n) {
  return (kAgFlags + 6 * n + 31) / 32 * 32;
}

// What a launch synchronizes on: the flag words (the virtual ring's
// [G, n, words]; a process ring's own rank, and its neighbours' mapped
// words), the call's epoch, the fault record and the spin bound
struct Flags {
  int* own;
  int* right;
  int* left;
  int words;
  int epoch;
  int* fault;
  long long timeout_ns;
};

// the words of rank (g, r + dir)
__device__ __forceinline__ int* flags_of(const Flags& f, int axes, int g,
                                         int r, int n, int dir) {
  if (axes & kLocal) return dir == 0 ? f.own : dir > 0 ? f.right : f.left;
  return f.own + static_cast<size_t>(g * n + wrap(r + dir, n)) * f.words;
}

// the kernels and the waits a fault record names
enum { kAgKernel = 1, kRsKernel = 2, kShiftKernel = 3 };
enum { kWaitBarrier = 0, kWaitSlot = 1, kWaitPartial = 2, kWaitDelivery = 3 };

// Record the fault in host-mapped memory and trap: the record's fields
// first, its first word (1) last
__device__ __noinline__ void timed_out(const Flags& f, int kernel, int g,
                                       int r, int step, int what,
                                       int local) {
  volatile int* rec = f.fault;
  rec[1] = kernel;
  rec[2] = g;
  rec[3] = r;
  rec[4] = step;
  rec[5] = f.epoch;
  rec[6] = what;
  rec[7] = local;
  __threadfence_system();
  rec[0] = 1;
  __threadfence_system();
  __trap();
}

// An acquire load of a flag at the scope its ring needs: the system's on a
// process ring (`local`: its neighbours may be other cards, so this is the
// code a ring over several cards runs), the GPU's on the virtual ring,
// whose ranks all live on this card
__device__ __forceinline__ int ld_flag(const int* flag, bool local) {
  return local ? ld_acquire_sys(flag) : ld_acquire_gpu(flag);
}

// Spin until *flag holds this call's epoch, at most the spin bound
__device__ __forceinline__ void wait_flag(const Flags& f, const int* flag,
                                          int kernel, int g, int r, int step,
                                          int what, int local) {
  if (ld_flag(flag, local) >= f.epoch) return;
  const unsigned long long t0 = global_ns();
  while (ld_flag(flag, local) < f.epoch) {
    __nanosleep(100);
    if (global_ns() - t0 > static_cast<unsigned long long>(f.timeout_ns))
      timed_out(f, kernel, g, r, step, what, local);
  }
}

// One of `total` arrivals on *count (after the arriving thread's writes
// completed); the last resets the count and publishes *flag = epoch, at
// the scope of ld_flag
__device__ __forceinline__ void arrive(int* count, int total, int* flag,
                                       int epoch, bool local) {
  const int old = local ? atom_add_acq_rel_sys(count, 1)
                        : atom_add_acq_rel_gpu(count, 1);
  if (old == total - 1) {
    *reinterpret_cast<volatile int*>(count) = 0;
    if (local)
      st_release_sys(flag, epoch);
    else
      st_release_gpu(flag, epoch);
  }
}

// The neighbour barrier's first half: this rank has started the call
__device__ __forceinline__ void raise_started(const Flags& f) {
  st_release_sys(f.right + kFromLeft, f.epoch);
  st_release_sys(f.left + kFromRight, f.epoch);
}

struct AgParams {
  CUtensorMap x[2];     // per segment: the slot's rows in x (step 0)
  CUtensorMap a[2];     // per segment: the same rows of a (later steps, and
                        // the copies)
  CUtensorMap w;
  CUtensorMap peer[2];  // kLocal: the same rows of the a the segment goes to
};

struct RsParams {
  CUtensorMap x;        // [G, n, n (chunks), m, K]
  CUtensorMap w;
  CUtensorMap comm;     // fp32 [G, n, n - 1, m, N], boxes of 128 rows (loads)
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
                      __nv_bfloat16* __restrict__ y, const Flags fl, int r0,
                      int ranks, int n, int m, int K, int N, int axes,
                      int nseg, int rows) {
  extern __shared__ __align__(16) uint8_t raw[];
  const Ring<C> ring = ring_at<C>(raw);
  init_ring(ring, releases<C>(1));              // + the stage's copier
  const bool bidir = nseg == 2, local = axes & kLocal;
  const int rt = row_groups(rows), ct = (N + C::kBN - 1) / C::kBN;
  const int items = n * ranks * nseg * rt * ct;
  const int nk = (K + kBK - 1) / kBK;
  const int copies = rt * C::kCluster * kCopiers;   // arrivals a segment
  int it = 0;                                   // stages walked
  auto item = [&](int w) {
    Item t = item_at(w, ranks, n, nseg, rt, ct, ring.crank);
    t.r = item_rank(t, n, r0, local);
    return t;
  };
  if (local && threadIdx.x == 0) raise_started(fl);

  if (threadIdx.x < kWarpgroup) {
    reg_dealloc<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&p.x[0]);
      prefetch_map(&p.w);
      for_each_item<C>(items, [&](int w) {
        const Item t = item(w);
        const int slot =
            wrap(t.r + ag_segment(t.step, t.s, n, rows, bidir).slot_off, n);
        if (t.step > 0) {   // the slot's rows have landed in own a
          wait_flag(fl, flags_of(fl, axes, t.g, t.r, n, 0) +
                            ag_flag(slot, t.s),
                    kAgKernel, t.g, t.r, t.step, kWaitSlot, local);
          fence_proxy_async_global();
        }
        const Operand a =
            t.step == 0
                ? Operand{&p.x[t.s], 0, axes & kXRank ? t.r : 0,
                          axes & kXGroup ? t.g : 0}
                : Operand{&p.a[t.s], slot, own(axes, t.r), own(axes, t.g)};
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
      // phase behind there, waiting for a phase that never comes.)  After
      // an item's stages a copier that forwarded waits for its stores to
      // complete and arrives on the slot's count.
      const int me = threadIdx.x / 32 - 1;
      bool met = !local;               // the neighbour barrier passed
      for_each_item<C>(items, [&](int w) {
        const Item t = item(w);
        const AgSegment sg = ag_segment(t.step, t.s, n, rows, bidir);
        const int slot = wrap(t.r + sg.slot_off, n);
        const bool copy = t.n0 == 0;
        const bool mine = copy && t.step == 0, peer = copy && sg.dst != 0;
        if (peer && !met) {
          wait_flag(fl, fl.own + kFromRight, kAgKernel, t.g, t.r, t.step,
                    kWaitBarrier, 1);
          wait_flag(fl, fl.own + kFromLeft, kAgKernel, t.g, t.r, t.step,
                    kWaitBarrier, 1);
          met = true;
        }
        for (int kt = 0; kt < nk; ++kt, ++it) {
          if (it % kCopiers != me) continue;
          wait_full(ring, it);
          const int stg = it % C::kStages;
          if (mine)
            tma_store_5d(&p.a[t.s], ring.a_tile(stg), kt * kBK, t.m0, slot,
                         own(axes, t.r), own(axes, t.g));
          if (peer && local)
            tma_store_5d(&p.peer[t.s], ring.a_tile(stg), kt * kBK, t.m0,
                         slot, 0, 0);
          else if (peer)
            tma_store_5d(&p.a[t.s], ring.a_tile(stg), kt * kBK, t.m0, slot,
                         wrap(t.r + sg.dst, n), t.g);
          if (mine || peer) {
            tma_store_commit();
            tma_store_wait_read();
          }
          mbar_arrive(&ring.empty[stg]);
        }
        if (peer) {
          tma_store_wait_all();
          fence_proxy_async_global();
          arrive(flags_of(fl, axes, t.g, t.r, n, 0) + ag_count(n, slot, t.s),
                 copies,
                 flags_of(fl, axes, t.g, t.r, n, sg.dst) + ag_flag(slot, t.s),
                 fl.epoch, local);
        }
      });
      tma_store_wait_all();
    }
  } else {
    reg_alloc<C::kConsumerRegs>();
    const Frag f = Frag::mine();
    float acc[C::kBN / 2];
    for_each_item<C>(items, [&](int w) {
      const Item t = item(w);
      const AgSegment sg = ag_segment(t.step, t.s, n, rows, bidir);
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
          if (row < rows)
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
ring_matmul_rs_kernel(const __grid_constant__ RsParams p, const Flags fl,
                      int r0, int ranks, int n, int m, int K, int N,
                      int axes) {
  extern __shared__ __align__(16) uint8_t raw[];
  const Ring<C> ring = ring_at<C>(raw);
  init_ring(ring, releases<C>(0));
  const bool local = axes & kLocal;
  const int rt = row_groups(m), ct = (N + C::kBN - 1) / C::kBN;
  const int items = n * ranks * rt * ct;
  const int nk = (K + kBK - 1) / kBK;
  const int parts = rt * ct * C::kCluster * 2;  // arrivals a step's partial
  int it = 0;
  auto item = [&](int w) {
    Item t = item_at(w, ranks, n, 1, rt, ct, ring.crank);
    t.r = item_rank(t, n, r0, local);
    return t;
  };
  if (local && threadIdx.x == 0) raise_started(fl);

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
        const int t = u.step;
        const int c = (u.r + 2 * n - 1 - t) % n;      // this step's chunk
        const Operand a{&p.x, c, axes & kXRank ? u.r : 0,
                        axes & kXGroup ? u.g : 0};
        produce_tile(ring, it, nk, a, w_operand(&p.w, axes, u.r, u.g), u.m0,
                     u.n0);
        if (t > 0) {   // the partial from the left has landed in own comm
          wait_flag(fl, flags_of(fl, axes, u.g, u.r, n, 0) + rs_flag(n, t - 1),
                    kRsKernel, u.g, u.r, t, kWaitPartial, local);
          fence_proxy_async_global();
        }
        for (int q = 0; q < kPieces; q += kPacked) {
          if (t > 0)                         // the partial from the left
            produce_boxes(ring, it, Operand{&p.comm, t - 1, own(axes, u.r),
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
    bool met = !local;                       // the neighbour barrier passed
    for_each_item<C>(items, [&](int w) {
      const Item u = item(w);
      const int t = u.step;
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
          if (t < n - 1 && !met) {
            wait_flag(fl, fl.own + kFromRight, kRsKernel, u.g, u.r, t,
                      kWaitBarrier, 1);
            met = true;
          }
          for (int b = 0; b < kPacked && q0 + b < kPieces; ++b) {
            uint8_t* half = stage + b * C::kABytes + f.c * 64 * kRowBytes;
            const int c0 = u.n0 + (q0 + b) * kPieceCols, c1 = u.m0 + 64 * f.c;
            if (t < n - 1 && local)
              tma_store_5d(&p.peer, half, c0, c1, t, 0, 0);
            else if (t < n - 1)
              tma_store_5d(&p.out, half, c0, c1, t, (u.r + 1) % n, u.g);
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
      // the outgoing partial has landed in rank r + 1's comm[t]: arrive
      if (t < n - 1 && threadIdx.x % kWarpgroup == 0) {
        tma_store_wait_all();
        fence_proxy_async_global();
        arrive(flags_of(fl, axes, u.g, u.r, n, 0) + rs_count(n, t), parts,
               flags_of(fl, axes, u.g, u.r, n, 1) + rs_flag(n, t), fl.epoch,
               local);
      }
    });
    if (threadIdx.x % kWarpgroup == 0) tma_store_wait_all();
  }
  finish_ring<C>();
}

constexpr int kShiftThreads = 256;

// this block's share of one rank's block of `bytes`: 16-byte vectors where
// `vec`, then the bytes left
__device__ __forceinline__ void copy_block(const uint8_t* src, uint8_t* dst,
                                           long long bytes, int vec) {
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

__global__ void __launch_bounds__(kShiftThreads)
ring_shift_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                  int n, long long bytes, int dir, int vec) {
  const int r = blockIdx.y % n, g = blockIdx.y / n;
  const size_t base = static_cast<size_t>(g) * n;
  copy_block(x + (base + r) * bytes, out + (base + wrap(r + dir, n)) * bytes,
             bytes, vec);
}

// A process ring's shift of rank r's block into the IPC-mapped buffer of
// rank r + dir: the neighbour barrier, the copy, then the last block to
// arrive publishes the receiver's delivery word and waits for its own
__global__ void __launch_bounds__(kShiftThreads)
ring_shift_peer_kernel(const uint8_t* __restrict__ x,
                       uint8_t* __restrict__ out, long long bytes, int vec,
                       const Flags fl, int r, int dir) {
  if (threadIdx.x == 0) {
    raise_started(fl);
    wait_flag(fl, fl.own + (dir > 0 ? kFromRight : kFromLeft), kShiftKernel,
              0, r, 0, kWaitBarrier, 1);
  }
  __syncthreads();
  copy_block(x, out, bytes, vec);
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0 &&
      atom_add_acq_rel_sys(fl.own + kShiftCount, 1) ==
          static_cast<int>(gridDim.x) - 1) {
    *reinterpret_cast<volatile int*>(fl.own + kShiftCount) = 0;
    st_release_sys((dir > 0 ? fl.right : fl.left) + kShiftFlag, fl.epoch);
    wait_flag(fl, fl.own + kShiftFlag, kShiftKernel, 0, r, 0, kWaitDelivery,
              1);
  }
}

bool bad_gemm(int G, int n, int rows, int N, int K) {
  return G <= 0 || n <= 0 || rows <= 0 || N <= 0 || K <= 0 || N % 8 ||
         K % 8 || static_cast<long long>(G) * n > 65535;
}

// The last call's arguments and the maps encoded for them
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
  AgParams params;
  int axes;
};

// x, w, a as in tpu_dra_ring_ag_matmul; local: a holds one rank and
// peer[0] / peer[1] are the a of the ranks the high (or only) and the low
// segments go to, right and left; segment s starts at row0[s] and spans
// `rows` rows
cudaError_t ag_maps(AgMaps* out, const void* x, const void* w, void* a,
                    void* const* peer, int G, int n, int m, int K, int N,
                    long long x_rs, long long x_gs, long long w_rs,
                    long long w_gs, int nseg, int rows, bool local) {
  int axes = (x_rs ? kXRank : 0) | (x_gs ? kXGroup : 0) |
             (local ? kLocal : 0);
  AgParams& p = out->params;
  cudaError_t err = map_w(&p.w, &axes, w, G, n, K, N, w_rs, w_gs);
  const long long slab = static_cast<long long>(m) * K;
  const long long nr = local ? 1 : n;           // ranks each a holds
  for (int s = 0; s < nseg && err == cudaSuccess; ++s) {
    const long long row0 = nseg == 2 && s == 0 ? rows : 0;
    err = map_bf16_5d(&p.x[s],
                      static_cast<const __nv_bfloat16*>(x) + row0 * K,
                      {K, rows, 1, x_rs ? n : 1, x_gs ? G : 1},
                      {K, 0, x_rs, x_gs}, kBM);
    if (err == cudaSuccess)
      err = map_bf16_5d(&p.a[s],
                        static_cast<const __nv_bfloat16*>(a) + row0 * K,
                        {K, rows, n, nr, G},
                        {K, slab, n * slab, n * nr * slab}, kBM);
    if (err == cudaSuccess && local)
      err = map_bf16_5d(&p.peer[s],
                        static_cast<const __nv_bfloat16*>(peer[s]) + row0 * K,
                        {K, rows, n, 1, 1}, {K, slab, n * slab, n * slab},
                        kBM);
  }
  out->axes = axes;
  return err;
}

struct RsMaps {
  RsParams params;
  int axes;
};

// local: comm and y hold one rank and peer is rank r0 + 1's comm; comm
// holds max(n - 1, 1) partial slots a rank
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
  const long long slots = n > 1 ? n - 1 : 1;
  if (err == cudaSuccess)
    err = map_bf16_5d(&out->params.x, x,
                      {K, m, n, x_rs ? n : 1, x_gs ? G : 1},
                      {K, static_cast<long long>(m) * K, x_rs, x_gs}, kBM);
  if (err == cudaSuccess)
    err = map_f32_5d(&out->params.comm, comm, {N, m, slots, nr, G},
                     {N, chunk, slots * chunk, slots * nr * chunk}, kBM);
  if (err == cudaSuccess)
    err = map_f32_5d(&out->params.out, comm, {N, m, slots, nr, G},
                     {N, chunk, slots * chunk, slots * nr * chunk}, kBM / 2);
  if (err == cudaSuccess && local)
    err = map_f32_5d(&out->params.peer, peer, {N, m, slots, 1, 1},
                     {N, chunk, slots * chunk, slots * chunk}, kBM / 2);
  if (err == cudaSuccess)
    err = map_5d(&out->params.y, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, y,
                 {N, m, 1, nr, G}, {N, 0, chunk, nr * chunk}, kBM / 2,
                 kPieceCols, CU_TENSOR_MAP_SWIZZLE_NONE);
  out->axes = axes;
  return err;
}

// The spin bound in nanoseconds (tpu_dra_ring_set_timeout)
std::atomic<long long> g_timeout_ns{30LL * 1000 * 1000 * 1000};

// The fault record, 8 ints of host memory mapped into the device,
// allocated once per process: its host and device pointers
struct FaultRecord {
  int* host = nullptr;
  int* dev = nullptr;
  cudaError_t err = cudaSuccess;
};

const FaultRecord& fault_record() {
  static const FaultRecord rec = [] {
    FaultRecord r;
    r.err = cudaHostAlloc(reinterpret_cast<void**>(&r.host), 8 * sizeof(int),
                          cudaHostAllocMapped);
    if (r.err != cudaSuccess) {
      r.host = nullptr;
      return r;
    }
    std::memset(r.host, 0, 8 * sizeof(int));
    r.err = cudaHostGetDevicePointer(reinterpret_cast<void**>(&r.dev),
                                     r.host, 0);
    return r;
  }();
  return rec;
}

// The launch's Flags, or an error
cudaError_t flags_for(Flags* f, void* own, void* right, void* left, int n,
                      int epoch) {
  if (own == nullptr || epoch <= 0) return cudaErrorInvalidValue;
  f->own = static_cast<int*>(own);
  f->right = static_cast<int*>(right);
  f->left = static_cast<int*>(left);
  f->words = flag_words(n);
  f->epoch = epoch;
  f->timeout_ns = g_timeout_ns.load();
  f->fault = fault_record().dev;
  return fault_record().err;
}

// Clusters of the persistent grid: every cluster resident at once
// (cudaOccupancyMaxActiveClusters), or one per item where there are fewer;
// the kernel's shared-memory attribute and the resident count are set and
// read once per process
template <typename Kernel>
cudaError_t resident_grid(Kernel kernel, long long items, int* blocks) {
  static int most = 0;
  static const cudaError_t err = [kernel] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    int sms = 0;
    if (e == cudaSuccess) e = sm_count(&sms);
    if (e != cudaSuccess) return e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(sms / C::kCluster * C::kCluster, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = C::kSmemBytes;
    e = cudaOccupancyMaxActiveClusters(&most, kernel, &cfg);
    return e == cudaSuccess && most <= 0 ? cudaErrorInvalidConfiguration : e;
  }();
  *blocks = static_cast<int>(items < most ? items : most) * C::kCluster;
  return err;
}

// One AG call (all n steps) over ranks r0 .. r0 + ranks - 1 (every rank of
// the virtual ring, or a process ring's own rank: local)
int ag_launch(const void* x, const void* w, void* y, void* a,
              void* const* peer, const Flags& fl, int G, int n, int r0,
              int ranks, int m, int K, int N, long long x_rs, long long x_gs,
              long long w_rs, long long w_gs, int bidir, bool local,
              void* stream) {
  if (bad_gemm(G, n, m, N, K) || (bidir && (m % 2 || n <= 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nseg = bidir ? 2 : 1, rows = bidir ? m / 2 : m;
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
                                      K, N, x_rs, x_gs, w_rs, w_gs, nseg,
                                      rows, local);
      if (err != cudaSuccess) return static_cast<int>(err);
      std::memcpy(cache.key, key, sizeof key);
      cache.valid = true;
    }
    params = cache.maps.params;
    axes = cache.maps.axes;
  }
  const long long items = static_cast<long long>(n) * ranks * nseg *
                          row_groups(rows) * ((N + C::kBN - 1) / C::kBN);
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int blocks;
  cudaError_t err = resident_grid(ring_ag_matmul_kernel, items, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_ag_matmul_kernel<<<blocks, kThreads, C::kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      params, static_cast<__nv_bfloat16*>(y), fl, r0, ranks, n, m, K, N,
      axes, nseg, rows);
  return static_cast<int>(cudaGetLastError());
}

// One RS call over ranks r0 .. r0 + ranks - 1, as ag_launch
int rs_launch(const void* x, const void* w, void* comm, const void* peer,
              void* y, const Flags& fl, int G, int n, int r0, int ranks,
              int m, int K, int N, long long x_rs, long long x_gs,
              long long w_rs, long long w_gs, bool local, void* stream) {
  if (bad_gemm(G, n, m, N, K)) return static_cast<int>(cudaErrorInvalidValue);
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
  const long long items = static_cast<long long>(n) * ranks * row_groups(m) *
                          ((N + C::kBN - 1) / C::kBN);
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int blocks;
  cudaError_t err = resident_grid(ring_matmul_rs_kernel, items, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_matmul_rs_kernel<<<blocks, kThreads, C::kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      params, fl, r0, ranks, n, m, K, N, axes);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte vectors where every block is aligned to them
int vectorized(const void* x, const void* out, long long bytes) {
  return bytes % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

unsigned shift_blocks(long long bytes, int vec) {
  const long long units = vec ? bytes / 16 : bytes;
  const long long blocks = (units + kShiftThreads - 1) / kShiftThreads;
  return static_cast<unsigned>(blocks < 1024 ? blocks : 1024);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches one kernel on
// `stream` and returns its cudaError_t; 0 means it was enqueued.  The
// matmul entries take the ring's flag words (flag_words(n) ints a rank,
// zeroed when the ring's buffer was made) and the call's epoch (the
// ring's calls numbered from 1): a call's launch covers all n ring steps.

// Ints a rank of the flag buffer of a ring of n ranks
extern "C" int tpu_dra_ring_flag_words(int n) { return flag_words(n); }

// The all-gather-matmul; bidir selects the half-shard ring (m even and
// n > 2 only); flags [G, n, flag_words(n)]
extern "C" int tpu_dra_ring_ag_matmul(const void* x, const void* w, void* y,
                                      void* a, void* flags, int G, int n,
                                      int m, int K, int N, long long x_rs,
                                      long long x_gs, long long w_rs,
                                      long long w_gs, int bidir, int epoch,
                                      void* stream) {
  Flags fl;
  const cudaError_t err = flags_for(&fl, flags, nullptr, nullptr, n, epoch);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* const none[2] = {nullptr, nullptr};
  return ag_launch(x, w, y, a, none, fl, G, n, 0, G * n, m, K, N, x_rs, x_gs,
                   w_rs, w_gs, bidir, false, stream);
}

// A process ring's all-gather-matmul for its rank r of n: x [m, K] and
// w [K, N] this rank's, y [n*m, N], a [n, m, K] this process's gathered
// operand, a_right and a_left the a of ranks r + 1 and r - 1 (IPC-mapped;
// a_left is written only by the bidirectional ring); flags this process's
// flag words, flags_right and flags_left its neighbours' (IPC-mapped)
extern "C" int tpu_dra_ring_ag_matmul_peer(
    const void* x, const void* w, void* y, void* a, void* a_right,
    void* a_left, void* flags, void* flags_right, void* flags_left, int r,
    int n, int m, int K, int N, int bidir, int epoch, void* stream) {
  if (r < 0 || r >= n || a_right == nullptr || (bidir && a_left == nullptr) ||
      flags_right == nullptr || flags_left == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Flags fl;
  const cudaError_t err =
      flags_for(&fl, flags, flags_right, flags_left, n, epoch);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* const peer[2] = {a_right, bidir ? a_left : a_right};
  return ag_launch(x, w, y, a, peer, fl, 1, n, r, 1, m, K, N, 0, 0, 0, 0,
                   bidir, true, stream);
}

// The matmul-reduce-scatter; comm is fp32 scratch [G, n, max(n - 1, 1),
// m, N] that the caller allocates for the call
extern "C" int tpu_dra_ring_matmul_rs(const void* x, const void* w,
                                      void* comm, void* y, void* flags, int G,
                                      int n, int m, int K, int N,
                                      long long x_rs, long long x_gs,
                                      long long w_rs, long long w_gs,
                                      int epoch, void* stream) {
  Flags fl;
  const cudaError_t err = flags_for(&fl, flags, nullptr, nullptr, n, epoch);
  if (err != cudaSuccess) return static_cast<int>(err);
  return rs_launch(x, w, comm, nullptr, y, fl, G, n, 0, G * n, m, K, N, x_rs,
                   x_gs, w_rs, w_gs, false, stream);
}

// A process ring's matmul-reduce-scatter for its rank r of n: x [n*m, K],
// w [K, N], y [m, N], comm this process's fp32 [n - 1, m, N] and
// comm_right rank r + 1's (IPC-mapped); flags as in the gather's
extern "C" int tpu_dra_ring_matmul_rs_peer(
    const void* x, const void* w, void* comm, void* comm_right, void* y,
    void* flags, void* flags_right, void* flags_left, int r, int n, int m,
    int K, int N, int epoch, void* stream) {
  if (r < 0 || r >= n || comm_right == nullptr || flags_right == nullptr ||
      flags_left == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Flags fl;
  const cudaError_t err =
      flags_for(&fl, flags, flags_right, flags_left, n, epoch);
  if (err != cudaSuccess) return static_cast<int>(err);
  return rs_launch(x, w, comm, comm_right, y, fl, 1, n, r, 1, m, K, N, 0, 0,
                   0, 0, true, stream);
}

// out[g, (r + dir) mod n] = x[g, r] for blocks of `bytes` bytes, x and out
// contiguous [G, n, bytes]; dir is +1 or -1
extern "C" int tpu_dra_ring_shift(const void* x, void* out, int G, int n,
                                  long long bytes, int dir, void* stream) {
  if (G <= 0 || n <= 0 || bytes <= 0 || (dir != 1 && dir != -1) ||
      static_cast<long long>(G) * n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = vectorized(x, out, bytes);
  const dim3 grid(shift_blocks(bytes, vec), G * n);
  ring_shift_kernel<<<grid, kShiftThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), n, bytes,
      dir, vec);
  return static_cast<int>(cudaGetLastError());
}

// A process ring's shift for its rank r of n: this rank's block of `bytes`
// into `out`, the IPC-mapped buffer of rank r + dir; the kernel ends once
// the block of rank r - dir has landed in this process's buffer
extern "C" int tpu_dra_ring_shift_peer(const void* x, void* out,
                                       long long bytes, void* flags,
                                       void* flags_right, void* flags_left,
                                       int r, int n, int dir, int epoch,
                                       void* stream) {
  if (bytes <= 0 || (dir != 1 && dir != -1) || r < 0 || r >= n ||
      out == nullptr || flags_right == nullptr || flags_left == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Flags fl;
  const cudaError_t err =
      flags_for(&fl, flags, flags_right, flags_left, n, epoch);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = vectorized(x, out, bytes);
  ring_shift_peer_kernel<<<shift_blocks(bytes, vec), kShiftThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), bytes, vec,
      fl, r, dir);
  return static_cast<int>(cudaGetLastError());
}

// The spin bound of every later launch, in seconds
extern "C" int tpu_dra_ring_set_timeout(double seconds) {
  if (!(seconds > 0)) return static_cast<int>(cudaErrorInvalidValue);
  g_timeout_ns.store(static_cast<long long>(seconds * 1e9));
  return 0;
}

// The fault record into out[8] (readable after the fault has poisoned the
// context: it is host memory): its first word is 1 once a wait ran past
// the bound, then kernel (1 gather, 2 reduce-scatter, 3 shift), group,
// rank, step, epoch, what it waited for (0 the neighbour barrier, 1 a
// gathered slot, 2 a partial, 3 the shift's delivery) and 1 for a
// process ring; returns the first word, or -1 if the record cannot be made
extern "C" int tpu_dra_ring_fault(int* out) {
  const int* rec = fault_record().host;
  if (rec == nullptr) return -1;
  for (int i = 0; i < 8; ++i)
    out[i] = reinterpret_cast<const volatile int*>(rec)[i];
  return out[0];
}

// A process ring's buffer that its neighbours write into: `bytes` of
// device memory from cudaMalloc (the base of its own allocation, as
// cudaIpcGetMemHandle wants), zeroed, and its 64-byte IPC handle
extern "C" int tpu_dra_ipc_alloc(long long bytes, void** ptr,
                                 char* handle) {
  if (bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  cudaIpcMemHandle_t h;
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(&h, *ptr);
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

extern "C" const char* tpu_dra_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
