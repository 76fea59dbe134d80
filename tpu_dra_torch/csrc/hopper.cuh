// Hopper (sm_90a) building blocks shared by the port's kernels: TMA tensor
// maps and bulk tensor copies (multicast to a cluster's blocks included,
// and the fp32 reduce-add into global memory), mbarriers (local and a
// cluster peer's), wgmma shared-memory descriptors and products, ldmatrix,
// the fences between them, acquire / release flags in global memory, named
// barriers, cluster barriers and register reallocation between warpgroups.
//
// Layout convention.  Every operand tile in shared memory is what TMA
// writes with CU_TENSOR_MAP_SWIZZLE_128B for a box 64 bf16 wide: rows of
// 128 bytes, the 16-byte chunk c of row r stored at chunk c ^ (r % 8), and
// 8-row atoms of 1024 bytes that must start 1024-byte aligned.  A matrix
// wider than 64 columns is a sequence of such boxes, one per 64 columns.
// The wgmma descriptors below describe that layout:
//   * K-major operand (the reduction dim contiguous, as q and K in q·Kᵀ):
//     the 16-wide k-step kk of a box starts kk * 32 bytes into it; the
//     8-row atoms follow at SBO = 1024 bytes; LBO is unused.
//   * MN-major operand (the output dim contiguous, as V in P·V; the
//     instruction's transpose bit set): a 16-row k-step spans two atoms,
//     SBO = 1024 bytes apart; the next 64 output columns are the next box,
//     LBO bytes on.
//
// wgmma fragments (PTX ISA, "Register fragments for wgmma", bf16 in, fp32
// accumulate), warp w of the warpgroup, lane = 4 * g + t:
//   D (64 x N fp32)  d[4 j + 2 h + e] = (row 16 w + g + 8 h, col 8 j + 2 t + e)
//   A (64 x 16 bf16, registers)
//                    a[0] = (16 w + g,     k 2t..2t+1)  a[1] = (16 w + g + 8, 2t..)
//                    a[2] = (16 w + g, k 2t+8..2t+9)    a[3] = (16 w + g + 8, 2t+8..)
// so the accumulator's columns 16 kk .. 16 kk + 15, rounded to bf16 in
// pairs, are exactly the A fragment of k-step kk: a score tile becomes the
// next product's A operand without leaving registers.
//
// The host side finds cuTensorMapEncodeTiled through the runtime's
// driver entry point, so the libraries need not link libcuda.

#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// --------------------------------------------------------------------------
// host: tensor maps
// --------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map of a contiguous bf16 tensor [n, rows, cols] (cols innermost) read
// or written in boxes of 64 columns x `box_rows` rows of one matrix, 128B
// swizzled.  Reads past `rows` (or `n`) fill zeros; writes there are
// dropped.  Needs a 16-byte aligned base and cols a multiple of 8.
inline cudaError_t tensor_map_bf16(CUtensorMap* map, const void* base,
                                   int n, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The same for a contiguous fp32 tensor [n, rows, cols] in boxes of 32
// columns (128 bytes) x `box_rows` rows, 128B swizzled
inline cudaError_t tensor_map_f32(CUtensorMap* map, const void* base, int n,
                                  int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 4,
                                 static_cast<cuuint64_t>(rows) * cols * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// --------------------------------------------------------------------------
// device: addresses, barriers, fences
// --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// spin until the barrier's phase of parity `parity` has completed (a fresh
// barrier counts its phase "before the first" as complete: waiting on
// parity 1 returns at once)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// generic-proxy accesses to shared memory are ordered before later
// async-proxy ones: writes become visible to wgmma operand reads and TMA
// stores, and reads complete before a TMA load overwrites the buffer
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the same between the generic and the async proxy for global memory: a
// flag released after a TMA write completed, or acquired before a TMA
// access, orders it
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) over `threads` threads: wait
// there, or arrive without waiting
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// --------------------------------------------------------------------------
// device: thread block clusters
// --------------------------------------------------------------------------

// this block's rank in its cluster, the cluster's index in the grid and
// the grid's number of clusters (along x)
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return static_cast<int>(r);
}

// every thread of every block of the cluster: what each wrote before is
// visible to the others after (a block's barriers initialised before a
// peer arrives on them; no block exits while a peer still writes to it)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// one arrival on the barrier at the same shared-memory offset in block
// `cta` of the cluster (this block's own included).  The arrival releases
// at CTA scope, as a local one does: it orders this thread's reads of the
// stage, not its global stores, which a cluster-scope release would wait
// for
__device__ __forceinline__ void mbar_arrive_cta(uint64_t* bar, int cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
      :: "r"(smem_u32(bar)), "r"(cta) : "memory");
}

// a flag in global memory read with acquire and written with release
// semantics at GPU scope: what the writer stored before the release is
// visible to a reader after its acquire
__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_gpu(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// the same at system scope, for flags that a kernel in another process, or
// on another card, reads or writes through a peer mapping; and the
// read-modify-write that counts arrivals, at either scope (it returns the
// old count)
__device__ __forceinline__ int ld_acquire_sys(const int* p) {
  int v;
  asm volatile("ld.acquire.sys.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(int* p, int v) {
  asm volatile("st.release.sys.global.b32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int atom_add_acq_rel_gpu(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ int atom_add_acq_rel_sys(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.sys.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// the global nanosecond timer (the same on every SM)
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// --------------------------------------------------------------------------
// device: TMA
// --------------------------------------------------------------------------

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// box at (c0 columns, c1 rows, c2 matrix) into `dst`; completes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// the same for 5-D maps: box at (c0 columns, c1 rows, c2, c3, c4)
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// tma_load_5d into the same shared-memory offset of every block of the
// cluster in `mask`, each completing on its own barrier at `bar`'s offset
__device__ __forceinline__ void tma_load_5d_multicast(
    void* dst, const CUtensorMap* map, uint64_t* bar, uint16_t mask, int c0,
    int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5, %6, %7}], [%2], "
      "%8;\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
         "h"(mask)
      : "memory");
}

__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5, %6}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// the box at (c0, c1, c2) += the shared-memory tile at `src`, element by
// element in fp32, by TMA (a bulk-group operation, as a store)
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map,
                                               const void* src, int c0,
                                               int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// close the group of stores issued so far
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until every committed store has read its shared-memory source
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// wait until every committed store has completed its writes
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// --------------------------------------------------------------------------
// device: wgmma
// --------------------------------------------------------------------------

// descriptor of a 128B-swizzled shared-memory operand at `addr` (see the
// layout convention above); offsets in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator
// register across a wgmma issue or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// four 8 x 8 bf16 matrices from shared memory: lane l gives the address
// of row l % 8 of matrix l / 8, and register i receives matrix i (lane l
// holds row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1), the mma.sync /
// wgmma A-fragment layout when the four matrices are a 16 x 16 tile's
// quarters in the order (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15),
// (8-15, 8-15)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

#define HOPPER_D8(d, i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

#define HOPPER_D32(d)                                                       \
  HOPPER_D8(d, 0), HOPPER_D8(d, 8), HOPPER_D8(d, 16), HOPPER_D8(d, 24)

#define HOPPER_D64(d) HOPPER_D32(d), HOPPER_D8(d, 32), HOPPER_D8(d, 40),    \
                      HOPPER_D8(d, 48), HOPPER_D8(d, 56)

#define HOPPER_D64_AT(d, i)                                                 \
  HOPPER_D8(d, i), HOPPER_D8(d, i + 8), HOPPER_D8(d, i + 16),               \
      HOPPER_D8(d, i + 24), HOPPER_D8(d, i + 32), HOPPER_D8(d, i + 40),     \
      HOPPER_D8(d, i + 48), HOPPER_D8(d, i + 56)

#define HOPPER_R128                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"

#define HOPPER_R32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

#define HOPPER_R64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 64) = A·B (+ d when `accumulate`), A and B from shared memory by
// descriptor, bf16 in, fp32 out; TRANS_A = 1 reads A MN-major (the M dim
// contiguous, as a transposed score tile is stored), TRANS_B = 1 reads B
// MN-major
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : HOPPER_D32(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
}

// d (64 x 128) = A·B (+ d when `accumulate`), A and B from shared memory
// by descriptor, bf16 in, fp32 out; TRANS_B = 1 reads B MN-major
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_R64
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : HOPPER_D64(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// d (64 x 256) = A·B (+ d when `accumulate`), as wgmma_ss_n128
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " HOPPER_R128
      ", %128, %129, p, 1, 1, 0, %131;\n}\n"
      : HOPPER_D64_AT(d, 0), HOPPER_D64_AT(d, 64)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// d (64 x N) += A·B with A (64 x 16 bf16) from registers in the fragment
// layout above and B from shared memory by descriptor
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma_rs takes N 64 or 128");
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : HOPPER_D64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(TRANS_B));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : HOPPER_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(TRANS_B));
  }
}

#undef HOPPER_D8
#undef HOPPER_D32
#undef HOPPER_D64
#undef HOPPER_D64_AT
#undef HOPPER_R128
#undef HOPPER_R32
#undef HOPPER_R64

}  // namespace hopper
