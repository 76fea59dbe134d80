// A TMA-fed, warp-specialized wgmma GEMM mainloop for Hopper (sm_90a), on
// the building blocks of hopper.cuh; the ring kernels (ring.cu) and the
// plain matmul (matmul.cu) run on it.
//
// One block (CTA) is three warpgroups, and blocks pair up in clusters of 2
// that share each w tile.  Warpgroup 0 is the producer: its
// thread 0 keeps TMA loads of x and w tiles in flight through a ring of
// kStages shared-memory stages with full / empty mbarriers, its other
// warps are the caller's side channel (the ring copies of the gathered
// operand), and the group gives most of its registers back
// (setmaxnreg) to warpgroups 1 and 2, the consumers.  Each consumer owns
// 64 rows of the kBM x kBN output tile and runs wgmma m64nBNk16 with fp32
// accumulators in registers.  The two blocks of a cluster take vertically
// adjacent tiles: each loads its own x box and half of the w boxes, which
// TMA multicasts into both blocks, so a stage's empty barrier counts the
// consumer warps of both blocks.  The grid is persistent: a cluster walks
// the launch's work items round robin, and the producer runs up to
// kStages stages ahead of the consumers, so one tile's epilogue runs under
// the next tile's loads.  A stage may also carry up to three boxes of an
// epilogue input (produce_boxes): the reduce-scatter's fp32 partials come
// through the same ring.
//
// Operands (row-major bf16, K and N multiples of 8 so every row is 16-byte
// aligned, as TMA requires):
//   x [rows, K] is the A operand, K-major: a stage holds one 64-column box
//     of kBM rows, 128B-swizzled (hopper.cuh's layout convention); k-step
//     kk of consumer c starts at c * 64 rows * 128 B + kk * 32 B, atoms at
//     SBO = 1024 B.
//   w [K, N] is the B operand, read MN-major (the transpose bit), exactly
//     as V is read in the flash forward's P·V: a stage holds kBN / 64
//     boxes of 64 k-rows x 64 columns (8 KB each); k-step kk starts kk *
//     16 rows * 128 B into the first box, atoms at SBO = 1024 B, the next
//     64 columns one box on (LBO = 8 KB).
// Both are read through 5-D tensor maps (columns, rows, and three outer
// axes the caller chooses: slot, rank, group), so one map covers every
// rank and group of a launch; an outer axis whose stride is 0 (a weight
// shared by the groups) becomes an axis of size 1 read at coordinate 0.
// TMA zero-fills a box past the map's rows, columns or K, so ragged M, N
// and K tiles add zeros; the caller masks its stores.
//
// Every work item walks K from 0 up in the same 16-wide k-steps, so an
// output element's sum is taken in one order whatever tile, segment or
// ring direction computed it.

#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace gemm90 {

using namespace hopper;

constexpr int kBM = 128;          // output rows per tile, 64 per consumer
constexpr int kBK = 64;           // K per stage: one swizzled box of x
constexpr int kWarpgroup = 128;
constexpr int kThreads = 3 * kWarpgroup;
constexpr int kConsumerWarps = 8;
constexpr int kRowBytes = 128;    // one swizzled row of a 64-column box

// Tile width, stages, and blocks a cluster (1, or 2 that share each w
// tile: each block loads half of its boxes and multicasts them to both,
// so a block reads 16 + 16 KB a stage from L2 instead of 16 + 32).  One
// block an SM.  Registers: setmaxnreg.inc only takes what the block's own
// warps gave back, so producer · 128 + consumer · 256 must not exceed the
// 168 · 384 the block starts with.
template <int BN, int STAGES, int CLUSTER>
struct Config {
  static_assert(BN == 128 || BN == 256, "tile width 128 or 256");
  static_assert(CLUSTER == 1 || CLUSTER == 2, "clusters of 1 or 2 blocks");
  static constexpr int kBN = BN;
  static constexpr int kStages = STAGES;
  static constexpr int kCluster = CLUSTER;
  static constexpr int kBoxesB = BN / 64;
  static constexpr int kABytes = kBM * kRowBytes;          // 16 KB
  static constexpr int kBBox = kBK * kRowBytes;            // 8 KB
  static constexpr int kStageBytes = kABytes + kBoxesB * kBBox;
  static constexpr int kBar = STAGES * kStageBytes;
  static constexpr int kSmemBytes = kBar + 2 * STAGES * 8 + 1024;  // + slack
  static constexpr int kProducerRegs = 56;
  static constexpr int kConsumerRegs = 224;
  static_assert(kProducerRegs * 128 + kConsumerRegs * 256 <= 168 * kThreads,
                "setmaxnreg asks for more registers than the block has");
};

// --------------------------------------------------------------------------
// host
// --------------------------------------------------------------------------

// A 5-D map at `base` of elements of `bytes` bytes: dims innermost first
// (dims[0] contiguous), strides of dims 1-4 in elements (16-byte
// multiples), boxes of box_cols x box_rows; 128B-swizzled boxes span 128
// bytes a row.  A dim of size 1 is given a dense stride, whatever the
// caller passed.
inline cudaError_t map_5d(CUtensorMap* map, CUtensorMapDataType type,
                          int bytes, const void* base,
                          const long long (&dims)[5],
                          const long long (&strides)[4], int box_rows,
                          int box_cols = 0,
                          CUtensorMapSwizzle swizzle =
                              CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t d[5], s[4];
  long long dense = dims[0];
  for (int i = 0; i < 5; ++i) d[i] = static_cast<cuuint64_t>(dims[i]);
  for (int i = 0; i < 4; ++i) {
    const long long st = dims[i + 1] == 1 ? dense : strides[i];
    if (st <= 0 || (st * bytes) % 16) return cudaErrorInvalidValue;
    s[i] = static_cast<cuuint64_t>(st) * bytes;
    dense = st * dims[i + 1];
  }
  const cuuint32_t box[5] = {
      static_cast<cuuint32_t>(box_cols ? box_cols : kRowBytes / bytes),
      static_cast<cuuint32_t>(box_rows), 1, 1, 1};
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, type, 5, const_cast<void*>(base), d, s, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// bf16 operands: boxes of 64 columns
inline cudaError_t map_bf16_5d(CUtensorMap* map, const void* base,
                               const long long (&dims)[5],
                               const long long (&strides)[4], int box_rows) {
  return map_5d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims,
                strides, box_rows);
}

// fp32 partials: boxes of 32 columns
inline cudaError_t map_f32_5d(CUtensorMap* map, const void* base,
                              const long long (&dims)[5],
                              const long long (&strides)[4], int box_rows) {
  return map_5d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, dims, strides,
                box_rows);
}

// The card's SM count, read once per process
inline cudaError_t sm_count(int* sms) {
  static int count = 0;
  static const cudaError_t err = [] {
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return e;
  }();
  *sms = count;
  return err;
}

// Blocks of the persistent grid: one per SM in whole clusters, or one
// cluster per work item where there are fewer (a work item is one output
// tile per block of its cluster)
template <class C>
inline cudaError_t grid_blocks(long long items, int* blocks) {
  int sms;
  const cudaError_t err = sm_count(&sms);
  const long long most = sms / C::kCluster;
  *blocks = static_cast<int>(items < most ? items : most) * C::kCluster;
  return err;
}

// --------------------------------------------------------------------------
// device
// --------------------------------------------------------------------------

// One operand's map and the coordinates of its three outer axes
struct Operand {
  const CUtensorMap* map;
  int c2, c3, c4;
};

// The block's shared memory from a 1024-byte aligned base: the stages,
// then the full and the empty barriers; and the block's rank in its
// cluster
template <class C>
struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int crank;

  __device__ __forceinline__ uint8_t* a_tile(int st) const {
    return base + st * C::kStageBytes;
  }
  __device__ __forceinline__ uint8_t* b_tile(int st) const {
    return base + st * C::kStageBytes + C::kABytes;
  }
};

template <class C>
__device__ __forceinline__ Ring<C> ring_at(uint8_t* raw) {
  uint8_t* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + C::kBar);
  return {base, bars, bars + C::kStages,
          C::kCluster > 1 ? cluster_rank() : 0};
}

// Every consumer warp of the cluster releases each stage (the w boxes of
// a stage land in every block of the cluster), and `side` more arrivals of
// this block's own
template <class C>
__host__ __device__ constexpr int releases(int side) {
  return C::kCluster * kConsumerWarps + side;
}

// Thread 0 sets up the barriers: full completes on the producer's one
// arrival and the stage's bytes, empty on `count` arrivals; then the
// cluster (or the block) synchronises, so no peer arrives on a barrier
// before it is set up
template <class C>
__device__ __forceinline__ void init_ring(const Ring<C>& ring, int count) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(&ring.full[st], 1);
      mbar_init(&ring.empty[st], count);
    }
    fence_barrier_init();
  }
  __syncwarp();
  if constexpr (C::kCluster > 1)
    cluster_sync();
  else
    __syncthreads();
}

// The end of the block: no block of a cluster leaves while a peer may
// still write into its shared memory or arrive on its barriers
template <class C>
__device__ __forceinline__ void finish_ring() {
  if constexpr (C::kCluster > 1) {
    __syncwarp();
    cluster_sync();
  }
}

// The block's work items, round robin over the persistent grid's clusters
// (every block of a cluster walks the same items)
template <class C, typename F>
__device__ __forceinline__ void for_each_item(int items, F&& f) {
  if constexpr (C::kCluster > 1) {
    for (int w = cluster_index(); w < items; w += cluster_count()) f(w);
  } else {
    for (int w = blockIdx.x; w < items; w += gridDim.x) f(w);
  }
}

// Producer: the nk stages of one tile (rows m0 of a, columns n0 of b);
// `it` is the block's running count of stages.  In a cluster of 2 each
// block loads half of the w boxes into both blocks.
template <class C>
__device__ __forceinline__ void produce_tile(const Ring<C>& ring, int& it,
                                             int nk, const Operand& a,
                                             const Operand& b, int m0,
                                             int n0) {
  constexpr int kMine = C::kBoxesB / C::kCluster;
  const int first = ring.crank * kMine;
  for (int kt = 0; kt < nk; ++kt, ++it) {
    const int st = it % C::kStages;
    mbar_wait(&ring.empty[st], ((it / C::kStages) & 1) ^ 1);
    mbar_expect_tx(&ring.full[st], C::kStageBytes);
    tma_load_5d(ring.a_tile(st), a.map, &ring.full[st], kt * kBK, m0, a.c2,
                a.c3, a.c4);
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const int bx = first + i;
      if constexpr (C::kCluster > 1)
        tma_load_5d_multicast(ring.b_tile(st) + bx * C::kBBox, b.map,
                              &ring.full[st], (1 << C::kCluster) - 1,
                              n0 + bx * 64, kt * kBK, b.c2, b.c3, b.c4);
      else
        tma_load_5d(ring.b_tile(st) + bx * C::kBBox, b.map, &ring.full[st],
                    n0 + bx * 64, kt * kBK, b.c2, b.c3, b.c4);
    }
  }
}

// Producer: one stage that carries `count` boxes of an epilogue input
// (each an a-sized box: kBM rows x 128 bytes), at columns c0, c0 + step,
// ..., packed from the stage's start; count · kABytes ≤ kStageBytes
template <class C>
__device__ __forceinline__ void produce_boxes(const Ring<C>& ring, int& it,
                                              const Operand& a, int c0,
                                              int step, int count, int c1) {
  const int st = it % C::kStages;
  mbar_wait(&ring.empty[st], ((it / C::kStages) & 1) ^ 1);
  mbar_expect_tx(&ring.full[st], count * C::kABytes);
  for (int b = 0; b < count; ++b)
    tma_load_5d(ring.a_tile(st) + b * C::kABytes, a.map, &ring.full[st],
                c0 + b * step, c1, a.c2, a.c3, a.c4);
  ++it;
}

// Producer: one stage that carries nothing, for the consumers to stage an
// epilogue output in
template <class C>
__device__ __forceinline__ void produce_nothing(const Ring<C>& ring,
                                                int& it) {
  const int st = it % C::kStages;
  mbar_wait(&ring.empty[st], ((it / C::kStages) & 1) ^ 1);
  mbar_arrive(&ring.full[st]);
  ++it;
}

// A consumer warp's release of stage `it`: lane 0 arrives for the warp on
// the stage's empty barrier of every block of the cluster
template <class C>
__device__ __forceinline__ void release(const Ring<C>& ring, int it,
                                        int lane) {
  if (lane != 0) return;
  uint64_t* bar = &ring.empty[it % C::kStages];
  if constexpr (C::kCluster > 1) {
#pragma unroll
    for (int cta = 0; cta < C::kCluster; ++cta) mbar_arrive_cta(bar, cta);
  } else {
    mbar_arrive(bar);
  }
}

template <class C>
__device__ __forceinline__ void wait_full(const Ring<C>& ring, int it) {
  mbar_wait(&ring.full[it % C::kStages], (it / C::kStages) & 1);
}

__device__ __forceinline__ uint64_t a_desc(uint32_t a_tile, int c, int kk) {
  return desc_sw128(a_tile + c * 64 * kRowBytes + kk * 32, 16, 1024);
}

template <class C>
__device__ __forceinline__ uint64_t b_desc(uint32_t b_tile, int kk) {
  return desc_sw128(b_tile + kk * 16 * kRowBytes, C::kBBox, 1024);
}

// Consumer c: acc (its 64 rows x kBN, the wgmma D fragment of hopper.cuh)
// = the tile's product over nk stages.  Stage kt's products are issued
// before stage kt − 1's are waited for; each warp releases a stage once
// its products have read it.
template <class C>
__device__ __forceinline__ void consume_tile(const Ring<C>& ring,
                                             float (&acc)[C::kBN / 2],
                                             int& it, int nk, int c,
                                             int lane) {
  for (int kt = 0; kt < nk; ++kt, ++it) {
    const int st = it % C::kStages;
    wait_full(ring, it);
    const uint32_t at = smem_u32(ring.a_tile(st));
    const uint32_t bt = smem_u32(ring.b_tile(st));
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if constexpr (C::kBN == 256)
        wgmma_ss_n256<1>(acc, a_desc(at, c, kk), b_desc<C>(bt, kk),
                         kt > 0 || kk > 0);
      else
        wgmma_ss_n128<1>(acc, a_desc(at, c, kk), b_desc<C>(bt, kk),
                         kt > 0 || kk > 0);
    }
    wgmma_commit();
    fence_regs(acc);
    if (kt > 0) {
      wgmma_wait<1>();
      fence_regs(acc);
      release(ring, it - 1, lane);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  release(ring, it - 1, lane);
}

// Where a consumer thread's accumulator lies in the tile: d[4 j + 2 h + e]
// is (row(h), col(j) + e)
struct Frag {
  int c;       // consumer 0 or 1: tile rows 64 c .. 64 c + 63
  int lane;
  int row0;    // tile row of h = 0 (h = 1 is 8 below)
  int col0;    // tile column of j = 0 (j steps 8 columns)

  __device__ __forceinline__ static Frag mine() {
    const int tid = threadIdx.x % kWarpgroup, lane = tid % 32;
    const int c = static_cast<int>(threadIdx.x) / kWarpgroup - 1;
    return {c, lane, 64 * c + 16 * (tid / 32) + (lane >> 2), 2 * (lane & 3)};
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace gemm90
