"""The addressing of the wgmma GEMM mainloop (``csrc/gemm_sm90.cuh``), of
the ring kernels' persistent walk (``csrc/ring.cu``), of the plain
matmul's (``csrc/matmul.cu``) and of the RMSNorm-matmul's row-norm pass,
replayed on the CPU.

The kernels cannot run here, so what the hardware does with their
addresses is modelled in PyTorch with the constants and expressions read
from the sources:

- TMA writes a box of 64 bf16 columns with ``CU_TENSOR_MAP_SWIZZLE_128B``:
  row i lies at ``i · 128`` bytes, its 16-byte chunk c at chunk
  ``c ^ (i mod 8)``, and a box past the tensor's rows, columns or K reads
  zeros;
- ``wgmma`` reads a 128B-swizzled operand through its descriptor: the
  address of an element in the unswizzled canonical layout (K-major:
  ``start + (m / 8)·SBO + (m mod 8)·128 + 2k``; MN-major: ``start + (n /
  64)·LBO + (k / 8)·SBO + (k mod 8)·128 + 2·(n mod 64)``), with bits 4-6
  XORed by bits 7-9 (the swizzle of 1024-byte aligned atoms).

The replay places x (K-major, one box a stage) and w (MN-major, kBN / 64
boxes a stage) as TMA would for every stage of an output tile, reads the
consumers' A and B through the kernel's descriptors and checks the product
equals ``x @ w`` exactly (small integers: every sum is exact in fp32), at
ragged M, N and K.  It then walks a launch's work items as the persistent
grid does and checks each (rank, segment, row tile, column tile) is taken
exactly once and that only column tile 0 writes the gathered operand,
covering every element of each segment once.  The plain matmul's walk
(one rank, one segment: row-tile pairs outermost, each block of a cluster
one row tile of the pair) must cover every output tile once, and its
tiles, read through its tensor-map coordinates and stored with its masks,
must give ``x @ w`` exactly at a ragged shape.

The RMSNorm-matmul's row-norm pass is replayed (it writes normed x, and
the plain matmul multiplies it): every element of x written once, the
norm's order (x · r) · gamma rounded to bf16 once, no gamma read past K,
and the tile equal to the normed product.

Each planted fault must fail: a wrong LBO, a missing box jump (LBO 0), a
swizzle phase off by one row, a work item skipped; and in the row-norm
pass gamma taken from the wrong column, the neighbouring row's r, and
x · r rounded to bf16 before the gamma multiply.  The copy threads'
waits on the stage ring are replayed too: a waiter on an mbarrier's phase
parity must see every phase of the slots it waits on, and can only if it
gates them (a copier that waited on another's slot could fall a phase
behind there and wait for ever).
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest
import torch

CSRC = Path(__file__).resolve().parent.parent / "tpu_dra_torch" / "csrc"
HEADER = (CSRC / "gemm_sm90.cuh").read_text()
RING = (CSRC / "ring.cu").read_text()
MATMUL = (CSRC / "matmul.cu").read_text()


def constant(name: str, text: str = HEADER) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


BM, BK, ROW = constant("kBM"), constant("kBK"), constant("kRowBytes")
BN, STAGES, CLUSTER = map(int, re.search(
    r"using RingConfig = Config<(\d+), (\d+), (\d+)>;", RING).groups())
A_BYTES = BM * ROW                   # Config::kABytes
B_BOX = BK * ROW                     # Config::kBBox
STAGE = A_BYTES + BN // 64 * B_BOX   # Config::kStageBytes
SMS = 132


def test_the_replay_reads_the_sources_it_models():
    """The expressions the replay models, as the sources write them."""
    for line in (
            "return desc_sw128(a_tile + c * 64 * kRowBytes + kk * 32, 16, "
            "1024);",
            "return desc_sw128(b_tile + kk * 16 * kRowBytes, C::kBBox, 1024);",
            "static constexpr int kABytes = kBM * kRowBytes;",
            "static constexpr int kBBox = kBK * kRowBytes;",
            "static constexpr int kStageBytes = kABytes + kBoxesB * kBBox;",
            "for (int w = cluster_index(); w < items; w += cluster_count()) "
            "f(w);",
            "const int first = ring.crank * kMine;",
            "n0 + bx * 64, kt * kBK, b.c2, b.c3, b.c4);"):
        assert line in HEADER, line
    for line in ("const bool copy = t.n0 == 0;",
                 "  const int rank = w / (nseg * rt * ct);\n"
                 "  w %= nseg * rt * ct;\n"
                 "  const int s = w / (rt * ct);\n"
                 "  w %= rt * ct;\n"
                 "  return {rank / n, rank % n, s, (w / ct * C::kCluster + "
                 "crank) * kBM,\n          w % ct * C::kBN};",
                 "      piece + row * kRowBytes + ((((col * 4) >> 4) ^ "
                 "(row & 7)) << 4) +\n      ((col * 4) & 15));"):
        assert line in RING, line
    assert (BM, BK, ROW) == (128, 64, 128) and BN in (128, 256)
    assert CLUSTER in (1, 2)
    # the RMSNorm-matmul runs the plain matmul on the row-norm pass's
    # normed x (test_the_norm_replay_reads_its_source has the rest)
    for line in ("rownorm_kernel<<<(M + kNormRows - 1) / kNormRows, "
                 "kNormThreads, 0, st>>>(",
                 "return static_cast<int>(plain::launch(xn, w, out, M, N, K, "
                 "st));"):
        assert line in MATMUL, line


# --------------------------------------------------------------------------
# shared memory: TMA's placement and wgmma's reads
# --------------------------------------------------------------------------

def swizzle(addr):
    """Byte address → where the 128B swizzle puts it."""
    return addr ^ (((addr >> 7) & 7) << 4)


def tma_box(smem, base: int, src, r0: int, c0: int, rows: int,
            phase: int = 0):
    """TMA's copy of the box at (rows r0.., columns c0..c0+63) of the 2-D
    ``src`` into ``smem`` (one element per 2 bytes) at ``base``, 128B
    swizzled, zeros past src's edges; ``phase`` plants a swizzle off by
    that many rows."""
    assert base % 1024 == 0
    i = torch.arange(rows)[:, None]
    j = torch.arange(64)[None, :]
    r, c = r0 + i, c0 + j
    inside = (r < src.shape[0]) & (c < src.shape[1])
    vals = torch.where(inside, src[r.clamp(max=src.shape[0] - 1),
                                   c.clamp(max=src.shape[1] - 1)], 0.0)
    addr = base + i * ROW + (((j // 8) ^ ((i + phase) % 8)) * 16) + (j % 8) * 2
    smem[addr // 2] = vals


def read_kmajor(smem, start: int, sbo: int):
    """The 64 x 16 A operand a K-major descriptor names."""
    m = torch.arange(64)[:, None]
    k = torch.arange(16)[None, :]
    return smem[swizzle(start + (m // 8) * sbo + (m % 8) * ROW + k * 2) // 2]


def read_mnmajor(smem, start: int, lbo: int, sbo: int, n: int):
    """The 16 x n B operand an MN-major (transposed) descriptor names."""
    k = torch.arange(16)[:, None]
    j = torch.arange(n)[None, :]
    return smem[swizzle(start + (j // 64) * lbo + (k // 8) * sbo
                        + (k % 8) * ROW + (j % 64) * 2) // 2]


def tile_product(x, w, m0: int, n0: int, fault=None):
    """One output tile as the mainloop computes it: every stage placed by
    TMA into a ring slot, both consumers' k-steps read through the
    kernel's descriptors; returns the [BM, BN] fp32 accumulator."""
    smem = torch.full((STAGES * STAGE // 2,), float("nan"))
    acc = torch.zeros((BM, BN))
    lbo = {"wrong-lbo": B_BOX // 2, "no-box-jump": 0}.get(fault, B_BOX)
    phase = 1 if fault == "swizzle-phase" else 0
    K = x.shape[1]
    for kt in range(-(-K // BK)):
        st = kt % STAGES
        a_tile, b_tile = st * STAGE, st * STAGE + A_BYTES
        tma_box(smem, a_tile, x, m0, kt * BK, BM, phase)
        # each block of the cluster loads (and multicasts) its share of
        # the w boxes: together every box once
        placed = []
        mine = BN // 64 // CLUSTER
        for crank in range(CLUSTER):
            for bx in range(crank * mine, crank * mine + mine):
                tma_box(smem, b_tile + bx * B_BOX, w, kt * BK, n0 + bx * 64,
                        BK, phase)
                placed.append(bx)
        assert sorted(placed) == list(range(BN // 64))
        for c in range(2):
            for kk in range(BK // 16):
                a = read_kmajor(smem, a_tile + c * 64 * ROW + kk * 32, 1024)
                b = read_mnmajor(smem, b_tile + kk * 16 * ROW, lbo, 1024, BN)
                acc[64 * c:64 * c + 64] += a @ b
    return acc


def want_tile(x, w, m0: int, n0: int):
    xp = torch.zeros((BM, x.shape[1]))
    rows = x[m0:m0 + BM]
    xp[:rows.shape[0]] = rows
    wp = torch.zeros((w.shape[0], BN))
    cols = w[:, n0:n0 + BN]
    wp[:, :cols.shape[1]] = cols
    return xp @ wp


def small_ints(shape, seed: int):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-3, 4, shape, generator=g).float()


# (rows, K, N, tile): the path's full boxes, then M, N and K off the
# tile and box sizes (K 72: one whole box and a ragged one; N 264: a
# second column tile of 8 columns)
TILES = [(256, 192, 512, (128, 256)), (200, 72, 264, (128, 256)),
         (77, 136, 264, (0, 0))]


@pytest.mark.parametrize("rows,K,N,tile", TILES, ids=str)
def test_descriptors_read_what_tma_wrote(rows, K, N, tile):
    x, w = small_ints((rows, K), rows + K), small_ints((K, N), N)
    m0, n0 = tile
    n0 = min(n0, (N - 1) // BN * BN)
    got = tile_product(x, w, m0, n0)
    assert torch.equal(got, want_tile(x, w, m0, n0))


@pytest.mark.parametrize("fault", ["wrong-lbo", "no-box-jump",
                                   "swizzle-phase"])
def test_planted_addressing_fault_fails(fault):
    x, w = small_ints((256, 136), 1), small_ints((136, 512), 2)
    got = tile_product(x, w, 128, 256 if BN == 256 else 128, fault)
    assert not torch.equal(got, want_tile(x, w, 128,
                                          256 if BN == 256 else 128))


# --------------------------------------------------------------------------
# the persistent walk
# --------------------------------------------------------------------------

def item_at(w: int, n: int, nseg: int, rt: int, ct: int, crank: int):
    """``item_at`` of ring.cu: (g, r, s, m0, n0) of block ``crank`` of the
    cluster that takes item w (rt groups of CLUSTER row tiles)."""
    rank, w = divmod(w, nseg * rt * ct)
    s, w = divmod(w, rt * ct)
    return rank // n, rank % n, s, (w // ct * CLUSTER + crank) * BM, \
        w % ct * BN


def walk(G: int, n: int, nseg: int, rows: int, N: int, fault=None):
    """Every block's tiles, in order, on the persistent grid: one block a
    SM in clusters of CLUSTER (132 SMs), or one cluster per item where
    there are fewer; every block of a cluster walks the cluster's items."""
    rt = -(-(-(-rows // BM)) // CLUSTER)
    ct = -(-N // BN)
    items = G * n * nseg * rt * ct
    clusters = min(items, SMS // CLUSTER)
    taken = []
    for c in range(clusters):
        w = c
        while w < items:
            if not (fault == "skipped-item" and w == items // 2):
                taken.extend(item_at(w, n, nseg, rt, ct, crank)
                             for crank in range(CLUSTER))
            w += clusters
    return taken, rt * CLUSTER, ct


# (G, n, nseg, segment rows, K, N): the path's wqkv gather (bidirectional,
# 2048-row half shards), the reduce-scatter at w2, and ragged cases
WALKS = [(1, 4, 2, 2048, 2048, 1536), (1, 4, 1, 4096, 2048, 2048),
         (2, 4, 2, 65, 72, 264), (1, 2, 1, 77, 520, 512), (1, 1, 1, 1, 8, 8)]


def check_walk(G, n, nseg, rows, K, N, fault=None):
    taken, rt, ct = walk(G, n, nseg, rows, N, fault)   # rt: row tiles
    want = {(g, r, s, i * BM, j * BN) for g in range(G) for r in range(n)
            for s in range(nseg) for i in range(rt) for j in range(ct)}
    assert len(taken) == len(set(taken)) == len(want)
    assert set(taken) == want
    # the gathered operand: only column tile 0 copies, and its boxes (128
    # rows x 64 columns, bounded to the segment and K) cover each element
    # of each segment once
    written = torch.zeros((G, n, nseg, rows, K), dtype=torch.int64)
    for g, r, s, m0, n0 in taken:
        if n0 == 0:                       # `const bool copy = t.n0 == 0;`
            for k0 in range(0, K, BK):
                written[g, r, s, m0:m0 + BM, k0:k0 + BK] += 1
    assert bool((written == 1).all())


@pytest.mark.parametrize("case", WALKS, ids=str)
def test_walk_takes_every_item_once(case):
    check_walk(*case)


def test_planted_skipped_item_fails():
    with pytest.raises(AssertionError):
        check_walk(*WALKS[0], fault="skipped-item")


# --------------------------------------------------------------------------
# the reduce-scatter's epilogue pieces
# --------------------------------------------------------------------------

PIECE_COLS = ROW // 4            # fp32 columns of a 128-byte swizzled box


def piece_read(smem, row: int, col: int):
    """``piece_at`` of ring.cu: the float2 at tile row ``row``, piece column
    ``col`` (even) of the piece at the start of ``smem``."""
    addr = row * ROW + ((((col * 4) >> 4) ^ (row & 7)) << 4) + ((col * 4) & 15)
    return smem[addr // 4:addr // 4 + 2]


PACKED = STAGE // A_BYTES         # pieces a stage (ring.cu kPacked)


@pytest.mark.parametrize("phase", [0, 1], ids=["clean", "swizzle-phase"])
def test_epilogue_pieces_read_what_tma_wrote(phase):
    """TMA's fp32 boxes of 128 rows x 32 columns (128B swizzled), packed
    PACKED to a stage at a_tile + b · kABytes, against the consumers'
    reads of them in the accumulator layout: every thread's two rows and
    four column pairs of every piece of a 256-column tile, and the 64-row
    boxes each consumer's TMA store reads back; a swizzle one row off must
    fail."""
    assert "constexpr int kPacked = C::kStageBytes / C::kABytes;" in RING
    assert "in[b][j][h] = *piece_at(stage + b * C::kABytes," in RING
    assert ("uint8_t* half = stage + b * C::kABytes + f.c * 64 * kRowBytes;"
            in RING)
    pieces = BN // PIECE_COLS
    part = torch.arange(BM * BN, dtype=torch.float32).view(BM, BN)
    ok = True
    for q0 in range(0, pieces, PACKED):
        smem = torch.full((STAGE // 4,), float("nan"))
        i = torch.arange(BM)[:, None]
        j = torch.arange(PIECE_COLS)[None, :]
        for b in range(min(PACKED, pieces - q0)):
            addr = b * A_BYTES + i * ROW + (((j * 4 // 16) ^ ((i + phase) % 8))
                                            * 16) + (j * 4) % 16
            q = q0 + b
            smem[addr // 4] = part[:, q * PIECE_COLS:(q + 1) * PIECE_COLS]
        for b in range(min(PACKED, pieces - q0)):
            q = q0 + b
            for c in range(2):                       # consumer
                for warp in range(4):
                    for lane in range(32):
                        row0 = 64 * c + 16 * warp + lane // 4
                        col0 = 2 * (lane % 4)
                        for jj in range(PIECE_COLS // 8):
                            for h in range(2):
                                r, col = row0 + 8 * h, col0 + 8 * jj
                                got = piece_read(smem[b * A_BYTES // 4:], r,
                                                 col)
                                want = part[r, q * PIECE_COLS + col:
                                            q * PIECE_COLS + col + 2]
                                ok &= torch.equal(got, want)
            # the outgoing partial, written back in place, leaves by one
            # TMA store per consumer: a 64-row box of the same swizzle at
            # the consumer's half of the piece
            for c in range(2):
                base = b * A_BYTES + c * 64 * ROW
                assert base % 1024 == 0
                i = torch.arange(64)[:, None]
                addr = base + i * ROW + (((j * 4 // 16) ^ (i % 8)) * 16) \
                    + (j * 4) % 16
                ok &= torch.equal(smem[addr // 4],
                                  part[64 * c:64 * c + 64,
                                       q * PIECE_COLS:(q + 1) * PIECE_COLS])
    assert ok == (phase == 0)


def test_y_staging_covers_the_consumers_half_once():
    """On the last step each consumer rounds its 64 rows x 32 columns of a
    piece to bf16 into an unswizzled [64][32] box at its half of the piece
    (``y_at``), which one TMA store (box 32 x 64, no swizzle) reads row by
    row: every thread's pairs land once, inside the half's 8 KB, in
    row-major order."""
    assert ("return reinterpret_cast<uint32_t*>(half + row * kPieceCols * 2 + "
            "col * 2);" in RING)
    seen = torch.zeros(64 * PIECE_COLS, dtype=torch.int64)
    for warp in range(4):
        for lane in range(32):
            row0 = 16 * warp + lane // 4          # f.row0 - 64 · c
            col0 = 2 * (lane % 4)
            for j in range(PIECE_COLS // 8):
                for h in range(2):
                    r, col = row0 + 8 * h, col0 + 8 * j
                    addr = r * PIECE_COLS * 2 + col * 2
                    assert addr + 4 <= 64 * ROW   # inside the half
                    seen[addr // 2] += 1
                    seen[addr // 2 + 1] += 1
                    assert addr // 2 == r * PIECE_COLS + col
    assert bool((seen == 1).all())


# --------------------------------------------------------------------------
# the copy threads' waits on the stage ring
# --------------------------------------------------------------------------

COPIERS = constant("kCopiers", RING)


def copier_is_safe(stages: int, copiers: int, waits_all: bool) -> bool:
    """Whether every copier, waiting by parity, sees every phase of each
    ring slot it waits on (``waits_all``: it waits on every stage and acts
    on its own; otherwise it waits on its own stages alone): true when
    each slot it waits on advances only after its own release."""
    for me in range(copiers):
        own = {it for it in range(stages * copiers * 4)
               if it % copiers == me}
        waited = range(stages * copiers * 4) if waits_all else own
        for it in waited:
            # the slot's next phase needs this stage released; unless this
            # copier releases it, the slot can run ahead of the copier
            if it not in own:
                return False
    return True


def test_each_copier_owns_whole_slots():
    """kCopiers divides kStages, so a copier's stages are every stage of
    its slots, and it waits on those alone."""
    assert "if (it % kCopiers != me) continue;\n          wait_full(ring, it);" \
        in RING
    assert STAGES % COPIERS == 0
    assert all({it % STAGES for it in range(64) if it % COPIERS == me}
               .isdisjoint({it % STAGES for it in range(64)
                            if it % COPIERS != me})
               for me in range(COPIERS))
    assert copier_is_safe(STAGES, COPIERS, waits_all=False)


@pytest.mark.parametrize("stages,copiers,waits_all",
                         [(4, 2, True), (4, 3, False)],
                         ids=["waits-on-every-stage", "copiers-not-dividing"])
def test_planted_copier_fault_fails(stages, copiers, waits_all):
    """A copier that waits on stages it does not release, or copiers that
    share a slot, can miss a phase."""
    shared = any(not {it % stages for it in range(64) if it % copiers == me}
                 .isdisjoint({it % stages for it in range(64)
                              if it % copiers != me})
                 for me in range(copiers))
    assert not copier_is_safe(stages, copiers, waits_all) or shared


# --------------------------------------------------------------------------
# the plain matmul's walk (matmul.cu matmul_sm90_kernel)
# --------------------------------------------------------------------------

def test_the_matmul_replay_reads_its_source():
    """The plain matmul runs the ring kernels' mainloop configuration, one
    rank and one segment: 5-D maps whose outer axes have size 1, read at
    coordinate 0, and the walk below."""
    assert tuple(map(int, re.search(
        r"using MatmulConfig = Config<(\d+), (\d+), (\d+)>;",
        MATMUL).groups())) == (BN, STAGES, CLUSTER)
    for line in (
            "map_bf16_5d(&tm_x, x, {K, M, 1, 1, 1}, {K, 0, 0, 0}, kBM)",
            "map_bf16_5d(&tm_w, w, {N, K, 1, 1, 1}, {N, 0, 0, 0}, kBK)",
            "produce_tile(ring, it, nk, Operand{&tm_x, 0, 0, 0},",
            "Operand{&tm_w, 0, 0, 0}, m0_of(w), n0_of(w));",
            "auto m0_of = [&](int w) { return (w / ct * C::kCluster + "
            "ring.crank) * kBM; };",
            "auto n0_of = [&](int w) { return w % ct * C::kBN; };",
            "const int rt = ((M + kBM - 1) / kBM + C::kCluster - 1) / "
            "C::kCluster;",
            "if (col >= N) continue;",
            "if (row < M)"):
        assert line in MATMUL, line


def matmul_walk(M: int, N: int, fault=None):
    """Every block's (m0, n0), in order, on the persistent grid: clusters
    of CLUSTER blocks on 132 SMs walk the rt·ct items round robin, block
    crank of a cluster taking row tile crank of the item's pair.
    ``no-crank``: both blocks of a cluster take the pair's first row
    tile."""
    rt = -(-(-(-M // BM)) // CLUSTER)
    ct = -(-N // BN)
    items = rt * ct
    clusters = min(items, SMS // CLUSTER)
    taken = []
    for c in range(clusters):
        for w in range(c, items, clusters):
            for crank in range(CLUSTER):
                r = 0 if fault == "no-crank" else crank
                taken.append(((w // ct * CLUSTER + r) * BM, w % ct * BN))
    return taken


def covers_once(taken, M: int, N: int) -> bool:
    """The masked stores (rows < M, columns < N) of the taken tiles cover
    each output tile exactly once; tiles wholly past M store nothing."""
    count = torch.zeros((-(-M // BM), -(-N // BN)), dtype=torch.int64)
    for m0, n0 in taken:
        if m0 < M and n0 < N:
            count[m0 // BM, n0 // BN] += 1
    return bool((count == 1).all())


# (M, K, N): the bench's 4096^3, and M, K and N off the tiles (an odd
# number of row tiles, K 264 a ragged stage, N 136 a partial tile)
MATMUL_SHAPES = [(4096, 4096, 4096), (300, 264, 136)]


@pytest.mark.parametrize("mkn", MATMUL_SHAPES, ids=str)
def test_matmul_walk_covers_every_tile_once(mkn):
    M, _, N = mkn
    assert covers_once(matmul_walk(M, N), M, N)


def test_matmul_tiles_give_the_product_at_a_ragged_shape():
    """Each tile of the ragged walk through TMA's boxes at its coordinates
    and the consumers' descriptors, stored with the kernel's masks."""
    M, K, N = MATMUL_SHAPES[1]
    x, w = small_ints((M, K), 5), small_ints((K, N), 6)
    out = torch.full((M, N), float("nan"))
    for m0, n0 in matmul_walk(M, N):
        acc = tile_product(x, w, m0, n0)
        rows, cols = min(BM, max(0, M - m0)), min(BN, N - n0)
        out[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
    assert torch.equal(out, x @ w)


def test_planted_matmul_walk_fault_fails():
    M, _, N = MATMUL_SHAPES[1]
    assert not covers_once(matmul_walk(M, N, fault="no-crank"), M, N)


# --------------------------------------------------------------------------
# the RMSNorm-matmul (matmul.cu): rownorm_kernel writes normed x, and the
# plain matmul multiplies it by w
# --------------------------------------------------------------------------

# gamma-unswizzled: gamma read at the wrong column (the chunk's first
# pair); neighbour-r: the next row's r; round-before-gamma:
# bf16(bf16(x · r) · gamma)
NORM_FAULTS = ["gamma-unswizzled", "neighbour-r", "round-before-gamma"]


def test_the_norm_replay_reads_its_source():
    """The row-norm pass's expressions as matmul.cu writes them: each
    lane's 8-column chunks of a row, r in fp32, gamma pairs read at the
    chunk's columns in the order (x · r) · gamma, normed x stored at the
    row's chunk, and the plain matmul run on it."""
    for line in (
            "for (int c = lane * 8; c < K; c += 32 * 8) {",
            "const float rr = rsqrtf(ss / static_cast<float>(K) + eps);",
            "h[e] = norm_pair(h[e], rr, *reinterpret_cast<const float2*>(\n"
            "                                     gamma + c + 2 * e));",
            "*reinterpret_cast<uint4*>(xn + static_cast<size_t>(row) * K + c) "
            "= v;",
            "return pack_bf16((v.x * r) * g.x, (v.y * r) * g.y);",
            "return static_cast<int>(plain::launch(xn, w, out, M, N, K, st));"):
        assert line in MATMUL, line
    assert "mma.sync" not in MATMUL


def normed(x, r, g, fault=None):
    """bf16((x · r) · gamma) in fp32 (``norm_pair``); ``round-before-gamma``
    rounds x · r to bf16 first."""
    if fault == "round-before-gamma":
        return ((x * r).bfloat16().float() * g).bfloat16().float()
    return ((x * r) * g).bfloat16().float()


def prepass_xn(x, gamma, r, fault=None):
    """The row-norm pass, rownorm_kernel: the warp of row m walks its
    8-column chunks c = 8 · lane + 256 j below K, each pair of columns
    normalised with gamma at (c + 2e, c + 2e + 1); asserts every (row, k)
    is written once and no gamma past K is read."""
    M, K = x.shape
    xn = torch.full((M, K), float("nan"))
    written = torch.zeros((M, K), dtype=torch.int64)
    read = torch.zeros(K + 8, dtype=torch.int64)
    for lane in range(32):
        for c in range(lane * 8, K, 32 * 8):
            cols = torch.arange(c, c + 8)
            read[cols] += 1
            g = gamma[cols]
            if fault == "gamma-unswizzled":          # the chunk's first pair
                g = gamma[c + cols % 2]
            rows = torch.arange(M)
            if fault == "neighbour-r":
                rows = (rows + 1).clamp(max=M - 1)
            xn[:, cols] = normed(x[:, cols], r[rows][:, None], g[None], fault)
            written[:, cols] += 1
    assert bool((written == 1).all()) and not bool(read[K:].any())
    return xn


def norm_tile_product(x, gamma, w, r, m0: int, n0: int, fault=None):
    """One output tile: the row-norm pass's normed x through the plain
    matmul's tile (each stage's boxes placed by TMA, zero past M and K)."""
    return tile_product(prepass_xn(x, gamma, r, fault), w, m0, n0).double()


def norm_operands(M: int, K: int, N: int, seed: int):
    """Small-integer x and w, r in [0.5, 2) and gamma in [0.5, 1.5): every
    normed value is a bf16 multiple of 2^-10, so the fp64 sums are exact."""
    gen = torch.Generator().manual_seed(seed)
    x, w = small_ints((M, K), seed), small_ints((K, N), seed + 1)
    r = 0.5 + 1.5 * torch.rand((M,), generator=gen)
    gamma = 0.5 + torch.rand((K,), generator=gen)
    return x, w, r, gamma


def want_norm_tile(x, gamma, w, r, m0: int, n0: int):
    a = normed(x, r[:, None], gamma[None, :]).double()
    return want_tile(a, w.double(), m0, n0).double()


# (M, K, N, tile): the path's full boxes, then M, N and K off the tile and
# box sizes (K 72: the second stage's x box holds 8 columns and 56 zeros)
NORM_TILES = [(256, 128, 512, (128, 256)), (200, 72, 264, (128, 256)),
              (77, 136, 264, (0, 0))]


@pytest.mark.parametrize("mkn", NORM_TILES, ids=str)
def test_norm_tile_gives_the_normed_product(mkn):
    """Every element of x normalised exactly once, and the tile equal to
    bf16((x · r) · gamma) @ w, rows past M adding zeros."""
    M, K, N, (m0, n0) = mkn
    x, w, r, gamma = norm_operands(M, K, N, M + K)
    n0 = min(n0, (N - 1) // BN * BN)
    got = norm_tile_product(x, gamma, w, r, m0, n0)
    assert torch.equal(got, want_norm_tile(x, gamma, w, r, m0, n0))


def test_norm_gamma_past_k_reads_zero():
    """At K 72 the second stage's x box is zero past column 8 (TMA's fill
    of the normed x), and the pass reads no gamma past K: a gamma whose
    entries past K hold NaN still gives the finite, exact tile."""
    M, K, N = 128, 72, 256
    x, w, r, gamma = norm_operands(M, K, N, 3)
    padded = torch.cat([gamma, torch.full((56,), float("nan"))])
    got = norm_tile_product(x, padded, w, r, 0, 0)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want_norm_tile(x, gamma, w, r, 0, 0))


@pytest.mark.parametrize("fault", NORM_FAULTS)
def test_planted_norm_fault_fails(fault):
    M, K, N = 256, 136, 256
    x, w, r, gamma = norm_operands(M, K, N, 11)
    got = norm_tile_product(x, gamma, w, r, 128, 0, fault)
    assert not torch.equal(got, want_norm_tile(x, gamma, w, r, 128, 0))
