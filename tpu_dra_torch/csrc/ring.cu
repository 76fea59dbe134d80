// The ring kernels for Hopper (sm_90a): all-gather-matmul,
// matmul-reduce-scatter and the ring shift, over a ring of n ranks that
// live on one card (a virtual mesh).
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
// The copy comes out of the x tiles that the blocks of column tile 0
// stage for their product: no extra read of the slot.
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
// So the products run on the tensor cores through the tested mainloop of
// gemm_common.cuh, and the shift is plain wide copies.
// Left for later: steps that overlap (the copy of step i with the product
// of step i), which only several cards make worth having.

#include "gemm_common.cuh"

namespace {

using namespace gemm;

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

__device__ __forceinline__ int wrap(int v, int n) { return ((v % n) + n) % n; }

// Copies the staged x vectors of a tile into up to two destinations (own
// a and a neighbour's a), masked to the segment's rows and K
struct CopyTap {
  __nv_bfloat16* own;     // or nullptr
  __nv_bfloat16* peer;    // or nullptr
  int m0, rows, K;
  __device__ __forceinline__ void operator()(const uint4 (&v)[kAV],
                                             int k0) const {
#pragma unroll
    for (int i = 0; i < kAV; ++i) {
      const int r = m0 + x_row(i), c = k0 + x_col(i);
      if (r < rows && c < K) {
        const size_t off = static_cast<size_t>(r) * K + c;
        if (own) *reinterpret_cast<uint4*>(own + off) = v[i];
        if (peer) *reinterpret_cast<uint4*>(peer + off) = v[i];
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads, 2)
ring_ag_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      __nv_bfloat16* __restrict__ y, __nv_bfloat16* a, int n,
                      int m, int K, int N, long long x_rs, long long x_gs,
                      long long w_rs, long long w_gs, AgStep st) {
  __shared__ Smem sm;
  const int r = blockIdx.z % n, g = blockIdx.z / n;
  const int tiles = (st.rows + kBM - 1) / kBM;
  const int s = blockIdx.y / tiles;
  const int m0 = (blockIdx.y % tiles) * kBM, n0 = blockIdx.x * kBN;
  const AgSegment sg = s == 0 ? st.seg[0] : st.seg[1];
  const int slot = wrap(r + sg.slot_off, n);
  const size_t slab = static_cast<size_t>(m) * K;        // one slot of a
  const size_t rank = static_cast<size_t>(g) * n + r;
  __nv_bfloat16* a_own = a + rank * n * slab;             // rank r's a
  const __nv_bfloat16* src =
      (st.first ? x + g * x_gs + r * x_rs : a_own + slot * slab) +
      static_cast<size_t>(sg.row0) * K;
  const __nv_bfloat16* wr = w + g * w_gs + r * w_rs;

  CopyTap tap{nullptr, nullptr, m0, st.rows, K};
  if (blockIdx.x == 0) {
    const size_t rows_off = slot * slab + static_cast<size_t>(sg.row0) * K;
    if (st.first) tap.own = a_own + rows_off;
    if (sg.dst != 0) {
      const size_t peer = static_cast<size_t>(g) * n + wrap(r + sg.dst, n);
      tap.peer = a + peer * n * slab + rows_off;
    }
  }
  float acc[4][4][4];
  mainloop<false>(acc, sm, src, wr, nullptr, nullptr, m0, n0, st.rows, N, K,
                  tap);

  __nv_bfloat16* yr =
      y + rank * n * static_cast<size_t>(m) * N +
      (static_cast<size_t>(slot) * m + sg.row0) * N;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + acc_col(nt);
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + acc_row(mt, h);
        if (row < st.rows)
          *reinterpret_cast<uint32_t*>(yr + static_cast<size_t>(row) * N +
                                       col) =
              pack_bf16(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ring_matmul_rs_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w, float* comm,
                      __nv_bfloat16* __restrict__ y, int n, int m, int K,
                      int N, long long x_rs, long long x_gs, long long w_rs,
                      long long w_gs, int t) {
  __shared__ Smem sm;
  const int r = blockIdx.z % n, g = blockIdx.z / n;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int c = (r + 2 * n - 1 - t) % n;                  // this step's chunk
  const size_t chunk = static_cast<size_t>(m) * N;
  const __nv_bfloat16* xr =
      x + g * x_gs + r * x_rs + static_cast<size_t>(c) * m * K;
  const __nv_bfloat16* wr = w + g * w_gs + r * w_rs;
  float acc[4][4][4];
  mainloop<false>(acc, sm, xr, wr, nullptr, nullptr, m0, n0, m, N, K);

  const size_t rank = static_cast<size_t>(g) * n + r;
  const size_t right = static_cast<size_t>(g) * n + (r + 1) % n;
  const float* in = comm + (rank * 2 + t % 2) * chunk;             // own
  float* out = comm + (right * 2 + (t + 1) % 2) * chunk;           // peer
  __nv_bfloat16* yr = y + rank * chunk;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + acc_col(nt);
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + acc_row(mt, h);
        if (row >= m) continue;
        const size_t off = static_cast<size_t>(row) * N + col;
        float2 p = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        if (t > 0) {                       // the partial from the left
          const float2 q = *reinterpret_cast<const float2*>(in + off);
          p.x += q.x;
          p.y += q.y;
        }
        if (t < n - 1)
          *reinterpret_cast<float2*>(out + off) = p;
        else
          *reinterpret_cast<uint32_t*>(yr + off) = pack_bf16(p.x, p.y);
      }
    }
  }
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
  if (bad_gemm(G, n, m, N, K) || step < 0 || step >= n ||
      (bidir && (m % 2 || n <= 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const AgStep st = ag_step(n, m, step, bidir != 0);
  const int tiles = (st.rows + kBM - 1) / kBM;
  if (static_cast<long long>(tiles) * st.nseg > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, tiles * st.nseg, G * n);
  ring_ag_matmul_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
      static_cast<__nv_bfloat16*>(a), n, m, K, N, x_rs, x_gs, w_rs, w_gs, st);
  return static_cast<int>(cudaGetLastError());
}

// Step `step` of the matmul-reduce-scatter; comm is fp32 scratch
// [G, n, 2, m, N] that the caller allocates and keeps across the n steps
extern "C" int tpu_dra_ring_matmul_rs(const void* x, const void* w,
                                      void* comm, void* y, int G, int n,
                                      int m, int K, int N, long long x_rs,
                                      long long x_gs, long long w_rs,
                                      long long w_gs, int step,
                                      void* stream) {
  if (bad_gemm(G, n, m, N, K) || step < 0 || step >= n ||
      (m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, (m + kBM - 1) / kBM, G * n);
  ring_matmul_rs_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(comm),
      static_cast<__nv_bfloat16*>(y), n, m, K, N, x_rs, x_gs, w_rs, w_gs,
      step);
  return static_cast<int>(cudaGetLastError());
}

// out[g, (r + dir) mod n] = x[g, r] for blocks of `bytes` bytes, x and out
// contiguous [G, n, bytes]; dir is +1 or -1
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
