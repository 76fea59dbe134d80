"""The ring protocol of csrc/ring.cu, replayed on the CPU.

The kernels cannot run here, so their synchronization is replayed by a
seeded scheduler: every cluster of a launch's persistent grid is an
actor that walks its items in the dispenser's order (step-major: ring
step, group, rank, segment, row pair, column tile; round robin over the
clusters), and runs as far as its waits allow, in a random interleaving
of the actors.  A copy to a neighbour is a store that lands some ticks
after it is issued; the writer waits for it to land (``wait_group 0``)
before it arrives on the slot's count, and the last arrival publishes
the reader's flag with the call's epoch; a reader waits for its flag to
hold the epoch before it reads.  The replay follows the kernels'
schedule (``ag_segment``, the index arithmetic of
``ring_ag_matmul_kernel`` and ``ring_matmul_rs_kernel``) and asserts:

- every read of a gathered slot or a partial finds rows that this call
  delivered and that have landed: it waited on the flag its writer
  released after the store completed;
- with the epochs of back-to-back calls, a call's waits are met only by
  its own flags, and on a process ring (each rank's kernels in its own
  process, a copy out after each call) call c + 1 writes into a
  neighbour's buffer only once that neighbour has started c + 1 (the
  neighbour barrier), so never over a slot call c still reads;
- the reduce-scatter's comm: n - 1 slots, each written once a call and
  read once, never overwritten unread;
- with the grid at its co-resident size and items dispensed step-major,
  every wait is for items earlier in the order, and the launch finishes;
- every gathered row lands once, every output row is computed once;
- the gathered operand equals the plain version's bit for bit, the
  products agree with the whole gathered product within 1e-6 in fp32
  (each segment's rows are a separate product; seen: equal), and the
  reduce-scatter equals ``mesh.psum_scatter`` bit for bit, its ring
  summation order included.

The clean replays must pass for both gather directions and every grid
size; each planted fault must fail: a wrong slot index, a skipped step,
a partial slot reused one step early (two slots and no credit), a flag
published once the store has only read its source, a reader that does
not wait, an epoch not advanced between calls, a process ring without
the neighbour barrier, items dispensed rank-major, and a grid sized by
the SM count past what is resident.
"""

from __future__ import annotations

import random
from collections import defaultdict

import pytest
import torch

from tpu_dra_torch.workloads import collective_matmul as cm
from tpu_dra_torch.workloads.mesh import psum_scatter

CLUSTER = 2          # blocks a cluster (ring.cu's RingConfig)
COPIERS = 2          # ring.cu's kCopiers
TILE = 2             # rows a block's tile in the replay (128 on the card)


class ProtocolError(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise ProtocolError(msg)


def ag_segments(n: int, m: int, i: int, bidir: bool):
    """``ag_segment`` of ring.cu: step i's segments ``(slot offset, first
    row, rows, direction the rows travel on: +1, -1 or 0)``."""
    fwd = i < n - 1
    if not bidir:
        return [(-i, 0, m, 1 if fwd else 0)]
    half = m // 2
    return [(-i, half, half, 1 if fwd else 0),       # high half, right
            (i, 0, half, -1 if fwd else 0)]          # low half, left


def row_groups(rows: int) -> int:
    return -(-(-(-rows // TILE)) // CLUSTER)


# --------------------------------------------------------------------------
# the scheduler
# --------------------------------------------------------------------------

class Sim:
    """Shared memory, flags and arrival counts, stores in flight, and the
    actors (generators) that yield what they wait for: ``("flag", key,
    epoch)`` or ``("landed", handles)``."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)
        self.flags = defaultdict(int)
        self.counts = defaultdict(int)
        self.mem = {}               # key → (value, call)
        self.read = set()           # keys whose landed value was read
        self.inflight = []          # [ticks, key, value, call, handle]
        self.landed = set()
        self.guard = None           # (key, value, call) → None, or raise

    def store(self, key, value, call):
        handle = object()
        self.inflight.append([self.rng.randint(1, 5), key, value, call,
                              handle])
        return handle

    def load(self, key, call, what, once=False):
        """The landed value at ``key``, which this call must have
        delivered; ``once``: a value read only once (a partial)."""
        check(key in self.mem and self.mem[key][1] == call,
              f"{what}: read before this call's rows landed")
        check(not (once and key in self.read),
              f"{what}: read a partial already read (a stale slot)")
        self.read.add(key)
        return self.mem[key][0]

    def arrive(self, count, total, flag, epoch):
        self.counts[count] += 1
        if self.counts[count] == total:
            self.counts[count] = 0
            self.flags[flag] = epoch

    def _tick(self):
        keep = []
        for st in self.inflight:
            st[0] -= 1
            if st[0] > 0:
                keep.append(st)
                continue
            _, key, value, call, handle = st
            if self.guard is not None:
                self.guard(key, value, call)
            self.mem[key] = (value, call)
            self.read.discard(key)
            self.landed.add(handle)
        self.inflight = keep

    def _ready(self, cond) -> bool:
        if cond is None:
            return True
        if cond[0] == "flag":
            return self.flags[cond[1]] >= cond[2]
        return all(h in self.landed for h in cond[1])

    def run(self, actors, resident: int) -> None:
        """Run ``actors`` (a launch's clusters, or several launches'), at
        most ``resident`` at once: a later one starts when one ends.
        Raise if none can move while work is left (a hang)."""
        pending, running = list(actors), []
        while pending or running or self.inflight:
            while pending and len(running) < resident:
                running.append([pending.pop(0), None])
            self._tick()
            moved = False
            order = running[:]
            self.rng.shuffle(order)
            for act in order:
                if not self._ready(act[1]):
                    continue
                moved = True
                try:
                    act[1] = next(act[0])
                except StopIteration:
                    running.remove(act)
            check(moved or self.inflight or not (pending or running),
                  "no cluster can move: a wait is for an item that no "
                  "resident cluster will run")


# --------------------------------------------------------------------------
# the all-gather-matmul
# --------------------------------------------------------------------------

def ag_items(G, n, m, ct, fault=None):
    """The gather's items in the dispenser's order: ``(step, g, r, seg,
    row pair, column tile)``, step-major, the ranks of a step rotated by
    the step (``item_rank``; ``rank-major``: the fault)."""
    bidir = m % 2 == 0 and n > 2
    nseg = 2 if bidir else 1
    rows = m // 2 if bidir else m
    rt = row_groups(rows)
    items = [(i, g, (k + i) % n, s, p, j) for i in range(n)
             for g in range(G) for k in range(n) for s in range(nseg)
             for p in range(rt) for j in range(ct)]
    if fault == "rank-major":
        items.sort(key=lambda t: (t[1], t[2], t[0]))
    return items, bidir, rows, rt


def ag_call(sim, x, w, y, a_key, flag_key, epoch, call, ranks=None,
            clusters=4, ct=2, fault=None, met=None):
    """One gather launch over ranks ``ranks`` (all: the virtual ring; one:
    a process ring's), as cluster actors.  x ``[G, n, m, K]``, w ``[G, n,
    K, N]``; y ``[G, n, n·m, N]`` is written in place; ``a_key(g, r,
    slot, row, half)`` and ``flag_key(g, r, name)`` name the shared
    words; ``met(g, r, dst)`` is the neighbour barrier's wait (a process
    ring), or None."""
    G, n, m, K = x.shape
    N = w.shape[-1]
    items, bidir, rows, rt = ag_items(G, n, m, ct, fault)
    ranks = set(range(n)) if ranks is None else set(ranks)
    mine = [t for t in items if t[2] in ranks]
    copies = rt * CLUSTER * COPIERS
    cols = -(-N // ct)
    half_k = -(-K // 2)

    def cluster(c):
        for t in mine[c::clusters]:
            i, g, r, s, p, j = t
            if fault == "skipped-step" and i == n - 2:
                continue
            off, row0, seg_rows, dst = ag_segments(n, m, i, bidir)[s]
            slot = (r + off) % n
            if fault == "wrong-slot" and i > 0:
                slot = (slot + off // abs(off)) % n      # one hop too far
            if i > 0 and fault != "no-wait":
                yield ("flag", flag_key(g, r, ("ag", slot, s)), epoch)
            for crank in range(CLUSTER):
                # a block past the segment's rows computes and copies
                # nothing (TMA drops its boxes) but still arrives
                lo = row0 + (p * CLUSTER + crank) * TILE
                hi = max(lo, min(lo + TILE, row0 + seg_rows))
                if i == 0 or lo == hi:
                    src = x[g, r, lo:hi]
                else:
                    src = torch.stack([torch.cat([
                        sim.load(a_key(g, r, slot, q, 0), call,
                                 f"step {i}: rank {r}, slot {slot}"),
                        sim.load(a_key(g, r, slot, q, 1), call,
                                 f"step {i}: rank {r}, slot {slot}")])
                        for q in range(lo, hi)])
                out = y[g, r, slot * m + lo:slot * m + hi,
                        j * cols:(j + 1) * cols]
                check(bool(torch.isnan(out).all()),
                      f"rank {r}: rows {lo}.. of slot {slot} computed twice")
                out.copy_(src @ w[g, r, :, j * cols:(j + 1) * cols])
                if j != 0:
                    continue
                for cp in range(COPIERS):      # the side threads
                    k = slice(cp * half_k, (cp + 1) * half_k)
                    handles = []
                    for q in range(lo, hi):
                        v = src[q - lo, k].clone()
                        if i == 0:
                            handles.append(sim.store(
                                a_key(g, r, slot, q, cp), v, call))
                        if dst:
                            if met is not None:
                                yield met(g, r, dst)
                            handles.append(sim.store(
                                a_key(g, (r + dst) % n, slot, q, cp), v,
                                call))
                    if dst:
                        if fault != "published-on-read":
                            yield ("landed", handles)
                        sim.arrive(flag_key(g, r, ("ag_count", slot, s)),
                                   copies,
                                   flag_key(g, (r + dst) % n, ("ag", slot, s)),
                                   epoch)
            yield None
    return [cluster(c) for c in range(clusters)]


def ag_words(G, n, m, K):
    """A virtual ring's gather: a fresh ``a`` a call (keys carry the
    call) and one flag buffer."""
    return (lambda call: lambda g, r, slot, row, half:
            ("a", call, g, r, slot, row, half),
            lambda g, r, name: ("flags", g, r, name))


def gathered(sim, G, n, m, K, a_key):
    """The gathered operand ``[G, n, n, m, K]`` out of the replay's
    memory (a row that never landed is a fault)."""
    half = -(-K // 2)
    a = torch.empty((G, n, n, m, K))
    for g in range(G):
        for r in range(n):
            for slot in range(n):
                for q in range(m):
                    for cp in range(COPIERS):
                        key = a_key(g, r, slot, q, cp)
                        check(key in sim.mem, f"rank {r}: row {q} of slot "
                              f"{slot} never arrived")
                        a[g, r, slot, q, cp * half:(cp + 1) * half] = \
                            sim.mem[key][0]
    return a


def replay_ag(x, w, fault=None, clusters=4, calls=1, seed=0,
              resident=None):
    """``calls`` back-to-back gathers on a virtual ring over x ``[n, m,
    K]`` (rank r's shard) and w ``[n, K, N]``, on one flag buffer, each
    its own epoch (``stale-epoch``: the fault, the epoch not advanced);
    returns the last call's ``(y [n, n·m, N] fp32 sums, a [n, n, m,
    K])``."""
    x, w = x[None], w[None]
    G, n, m, K = x.shape
    sim = Sim(seed)
    akeys, fkey = ag_words(G, n, m, K)
    for call in range(1, calls + 1):
        epoch = 1 if fault == "stale-epoch" else call
        y = torch.full((G, n, n * m, w.shape[-1]), float("nan"))
        actors = ag_call(sim, x + call - 1, w, y, akeys(call), fkey, epoch,
                         call, clusters=clusters, fault=fault)
        sim.run(actors, clusters if resident is None else resident)
        check(not bool(torch.isnan(y).any()), "an output row was never "
              "computed")
    return y[0], gathered(sim, G, n, m, K, akeys(calls))[0]


# --------------------------------------------------------------------------
# the matmul-reduce-scatter
# --------------------------------------------------------------------------

def rs_items(n, m, ct, fault=None):
    """The reduce-scatter's items: ``(step, r, row pair, column tile)``,
    as :func:`ag_items` orders them."""
    rt = row_groups(m)
    items = [(t, (k + t) % n, p, j) for t in range(n) for k in range(n)
             for p in range(rt) for j in range(ct)]
    if fault == "rank-major":
        items.sort(key=lambda t: (t[1], t[0]))
    return items, rt


def rs_call(sim, p, y, comm_key, flag_key, epoch, call, ranks=None,
            clusters=4, ct=2, fault=None, met=None):
    """One reduce-scatter launch over ranks ``ranks`` as cluster actors:
    step t, rank r works on chunk c = (r − 1 − t) mod n, adds its own
    product to the partial that arrived from the left in comm[r][t − 1]
    and stores the sum into comm[r + 1][t], or keeps it on the last step
    (``double-buffer``: the fault, slot t mod 2 of two).  A cluster
    counts an item's outgoing partial once its stores landed, at the
    item's end (``counted-after-wait``: the fault, after the next item's
    wait for its own partial)."""
    n, nm, N = p.shape
    m = nm // n
    items, rt = rs_items(n, m, ct, fault)
    ranks = set(range(n)) if ranks is None else set(ranks)
    mine = [t for t in items if t[1] in ranks]
    parts = rt * ct * CLUSTER * 2
    cols = -(-N // ct)

    def slot_of(t):
        return t % 2 if fault == "double-buffer" else t

    def count(sent):
        for h, t, r in sent:
            if fault != "published-on-read":
                yield ("landed", h)
            sim.arrive(flag_key(r, ("rs_count", t)), parts,
                       flag_key((r + 1) % n, ("rs", slot_of(t))), epoch)

    def cluster(c):
        sent = []
        for t, r, pr, j in mine[c::clusters]:
            if fault == "skipped-step" and t == n - 2:
                continue
            ch = (r + 2 * n - 1 - t) % n
            if t > 0 and fault != "no-wait":
                yield ("flag", flag_key(r, ("rs", slot_of(t - 1))), epoch)
            if fault == "counted-after-wait":
                yield from count(sent)
                sent = []
            handles = [[], []]
            for crank in range(CLUSTER):
                lo = (pr * CLUSTER + crank) * TILE
                for row in range(lo, min(lo + TILE, m)):
                    mine_row = p[r, ch * m + row, j * cols:(j + 1) * cols]
                    acc = mine_row
                    if t > 0:
                        acc = mine_row + sim.load(
                            comm_key(r, slot_of(t - 1), row, j), call,
                            f"step {t}: rank {r}'s partial", once=True)
                    if t < n - 1:
                        if met is not None:
                            yield met(r)
                        # the two consumers: rows of each half of the tile
                        handles[(row - lo) * 2 // TILE].append(sim.store(
                            comm_key((r + 1) % n, slot_of(t), row, j), acc,
                            call))
                    else:
                        out = y[r, row, j * cols:(j + 1) * cols]
                        check(bool(torch.isnan(out).all()),
                              f"rank {r}: row {row} reduced twice")
                        out.copy_(acc)
                if t < n - 1:
                    sent += [(h, t, r) for h in handles]
                    handles = [[], []]
            if fault != "counted-after-wait":
                yield from count(sent)
                sent = []
            yield None
        yield from count(sent)
    return [cluster(c) for c in range(clusters)]


def comm_guard(sim):
    """A partial may land on a comm slot only once the one there was
    read (the slot rule: no partial overwritten unread)."""
    def guard(key, value, call):
        if key in sim.mem and key not in sim.read:
            raise ProtocolError(f"{key}: a partial overwritten before it "
                                f"was read")
    return guard


def replay_rs(p, fault=None, clusters=4, calls=1, seed=0, resident=None):
    """``calls`` back-to-back reduce-scatters on a virtual ring over the
    ranks' fp32 products p ``[n, n·m, N]``, on one flag buffer; returns
    the last call's y ``[n, m, N]``."""
    n, nm, N = p.shape
    sim = Sim(seed)
    sim.guard = comm_guard(sim)
    for call in range(1, calls + 1):
        epoch = 1 if fault == "stale-epoch" else call
        y = torch.full((n, nm // n, N), float("nan"))
        actors = rs_call(sim, p * call, y,
                         lambda r, s, row, j, call=call:
                         ("comm", call, r, s, row, j),
                         lambda r, name: ("flags", r, name), epoch, call,
                         clusters=clusters, fault=fault)
        sim.run(actors, clusters if resident is None else resident)
        check(not bool(torch.isnan(y).any()), "a row was never reduced")
    return y / calls


def inputs(n, m, K=16, N=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, m, K), generator=g).bfloat16()
    w = torch.randn((n, K, N), generator=g).bfloat16()
    return x, w


CASES = [(4, 4), (4, 3), (3, 2), (2, 4), (8, 6)]   # (n, m): both directions


@pytest.mark.parametrize("n,m", CASES)
def test_clean_gather_replay_passes_and_equals_the_plain_version(n, m):
    x, w = inputs(n, m)
    for seed in range(3):
        y, a = replay_ag(x.float(), w.float(), seed=seed)
        _, want_a = cm.all_gather_matmul_ref(x[None], w[None])
        assert torch.equal(a, want_a[0].float())
        want_y = x.float().reshape(n * m, -1) @ w.float()   # [n, n·m, N]
        torch.testing.assert_close(y, want_y, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_clean_reduce_scatter_replay_adds_in_the_plain_versions_order(n):
    """Values chosen so that fp32 sums depend on their order: the replay
    (the kernel's order) is bit-equal to ``mesh.psum_scatter``, and from
    three ranks on (two addends commute) it is not the rank-order sum."""
    m, N = 4, 4
    g = torch.Generator().manual_seed(n)
    p = torch.randn((n, n * m, N), generator=g) * torch.tensor(
        [2.0 ** (8 * (r % 3)) for r in range(n)])[:, None, None]
    for seed in range(3):
        y = replay_rs(p, seed=seed)
        assert torch.equal(y, psum_scatter(p[None], 1, 2)[0])
    if n > 2:
        assert not torch.equal(y, p.reshape(n, n, m, N).sum(0))


@pytest.mark.parametrize("fault", ["wrong-slot", "skipped-step"])
@pytest.mark.parametrize("n,m", [(4, 4), (4, 3), (3, 2)])
def test_planted_gather_faults_fail_the_replay(n, m, fault):
    x, w = inputs(n, m)
    with pytest.raises(ProtocolError):
        replay_ag(x.float(), w.float(), fault=fault)


@pytest.mark.parametrize("fault", ["double-buffer", "skipped-step"])
@pytest.mark.parametrize("n", [4, 5])
def test_planted_reduce_scatter_faults_fail_the_replay(n, fault):
    """Two comm slots reused with no credit (from n = 4 a slot is written
    twice a call): a rank's partial of step t + 2 lands on the one of
    step t before the neighbour read it, or the neighbour's wait is met
    by the older partial's flag and it reads that one again (some
    interleaving of the seeds shows it); a skipped step never publishes
    its flags, and the ring hangs."""
    p = torch.randn((n, 4 * n, 4))
    with pytest.raises(ProtocolError):
        for seed in range(20):
            replay_rs(p, fault=fault, seed=seed, clusters=16)


# --------------------------------------------------------------------------
# the flags: completion, the reader's wait, the epochs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fault", ["published-on-read", "no-wait"])
@pytest.mark.parametrize("kernel", ["gather", "reduce-scatter"])
def test_a_read_waits_for_the_flag_released_after_completion(kernel, fault):
    """A flag published once the stores have only read their source (the
    ``.read`` wait), or a reader that does not wait, lets some
    interleaving read rows that have not landed."""
    x, w = inputs(4, 4)
    p = torch.randn((4, 16, 4))
    with pytest.raises(ProtocolError):
        for seed in range(20):
            if kernel == "gather":
                replay_ag(x.float(), w.float(), fault=fault, seed=seed,
                          clusters=16)
            else:
                replay_rs(p, fault=fault, seed=seed, clusters=16)


@pytest.mark.parametrize("kernel", ["gather", "reduce-scatter"])
def test_back_to_back_calls_meet_only_their_own_epochs(kernel):
    """Three calls on one flag buffer, each on inputs of its own: with the
    epoch advanced every call each equals its plain version; with the
    epoch left as it was (the planted fault) the second call's waits are
    met by the first call's flags and it reads rows it has not
    delivered."""
    x, w = inputs(4, 4)
    p = torch.randn((4, 16, 4))
    for seed in range(3):
        if kernel == "gather":
            y, a = replay_ag(x.float(), w.float(), calls=3, seed=seed)
            assert torch.equal(a, (x.float() + 2)[None].expand(
                4, -1, -1, -1))
        else:
            y = replay_rs(p, calls=3, seed=seed)
            assert torch.equal(y, psum_scatter((p * 3)[None], 1, 2)[0] / 3)
    with pytest.raises(ProtocolError):
        for seed in range(10):
            if kernel == "gather":
                replay_ag(x.float(), w.float(), calls=2, seed=seed,
                          fault="stale-epoch", clusters=16)
            else:
                replay_rs(p, calls=2, seed=seed, fault="stale-epoch",
                          clusters=16)


def process_ring(x, w, calls: int, seed: int, barrier: bool = True):
    """A gather on a process ring: each rank's launch in its own process
    (one actor a rank and call, started once that rank's previous call
    has ended and its copy out read its ``a``), ``a`` one buffer a rank
    reused across calls, the epochs one count a ring.  With ``barrier``
    each rank raises its started word in both neighbours at the kernel's
    start and waits for the neighbour's before its first store there.
    Returns each call's copied-out ``a`` per rank."""
    n, m, K = x.shape
    sim = Sim(seed)
    copied = defaultdict(int)              # rank → last call copied out

    def guard(key, value, call):
        if key[0] == "a" and key in sim.mem:
            owner, old = key[1], sim.mem[key][1]
            check(copied[owner] >= old, f"rank {owner}: call {call} wrote "
                  f"its a before call {old} was copied out")
    sim.guard = guard
    out = defaultdict(dict)

    def rank_calls(r):
        for call in range(1, calls + 1):
            sim.flags[("started", (r + 1) % n, -1)] = call
            sim.flags[("started", (r - 1) % n, 1)] = call
            y = torch.full((1, n, n * m, w.shape[-1]), float("nan"))
            met = ((lambda g, rr, dst, call=call:
                    ("flag", ("started", rr, dst), call))
                   if barrier else None)
            # the rank's one cluster, interleaved with the other ranks'
            (act,) = ag_call(sim, x[None] + call, w[None], y,
                             lambda g, rr, slot, row, half:
                             ("a", rr, slot, row, half),
                             lambda g, rr, name: ("flags", rr, name),
                             call, call, ranks=[r], clusters=1, met=met)
            yield from act
            rows = []
            for slot in range(n):
                for q in range(m):
                    halves = [sim.load(("a", r, slot, q, cp), call,
                                       f"rank {r}'s copy out")
                              for cp in range(COPIERS)]
                    rows.append(torch.cat(halves))
            out[r][call] = torch.stack(rows).reshape(n, m, K)
            copied[r] = call
            yield None
    sim.run([rank_calls(r) for r in range(n)], n)
    return out


def test_the_neighbour_barrier_orders_a_process_rings_calls():
    """Three gathers on a process ring of 4, a launch a rank and call:
    with the neighbour barrier every copy out holds its own call's
    gathered operand; without it (the planted fault) some interleaving
    lets a fast rank's next call land in a neighbour's a before that
    neighbour copied the last call out."""
    x, w = inputs(4, 4)
    for seed in range(5):
        out = process_ring(x.float(), w.float(), 3, seed)
        for r in range(4):
            for call in (1, 2, 3):
                assert torch.equal(out[r][call], x.float() + call)
    with pytest.raises(ProtocolError):
        for seed in range(40):
            process_ring(x.float(), w.float(), 3, seed, barrier=False)


# --------------------------------------------------------------------------
# the order of the items and the grid
# --------------------------------------------------------------------------

def writers_before_waiters(kernel: str, n: int, m: int, fault=None) -> bool:
    """Every wait's writers (the items that arrive on its flag's count)
    come before the waiting item in the dispenser's order."""
    first_wait, last_write = {}, {}
    if kernel == "gather":
        items, bidir, _, _ = ag_items(1, n, m, 2, fault)
        for w, (i, g, r, s, p, j) in enumerate(items):
            off, _, _, dst = ag_segments(n, m, i, bidir)[s]
            slot = (r + off) % n
            if i > 0:
                first_wait.setdefault((r, slot, s), w)
            if dst and j == 0:
                last_write[((r + dst) % n, slot, s)] = w
    else:
        items, _ = rs_items(n, m, 2, fault)
        for w, (t, r, p, j) in enumerate(items):
            if t > 0:
                first_wait.setdefault((r, t - 1), w)
            if t < n - 1:
                last_write[((r + 1) % n, t)] = w
    return all(last_write[k] < w for k, w in first_wait.items())


@pytest.mark.parametrize("kernel", ["gather", "reduce-scatter"])
@pytest.mark.parametrize("n,m", CASES)
def test_every_wait_is_for_earlier_items(kernel, n, m):
    """Step-major: every flag a waiting item needs is published by items
    earlier in the order; rank-major (the planted order) breaks it."""
    assert writers_before_waiters(kernel, n, m)
    if n > 2:
        assert not writers_before_waiters(kernel, n, m, "rank-major")


@pytest.mark.parametrize("clusters", [1, 2, 3, 7, 16, 64])
def test_any_co_resident_grid_finishes(clusters):
    """The clean gather and reduce-scatter finish on any number of
    clusters, down to one, when every cluster of the grid is resident at
    once (the grid sized by ``cudaOccupancyMaxActiveClusters``)."""
    x, w = inputs(4, 4)
    y, a = replay_ag(x.float(), w.float(), clusters=clusters)
    assert torch.equal(a, x.float()[None].expand(4, -1, -1, -1))
    p = torch.randn((4, 16, 4))
    assert torch.equal(replay_rs(p, clusters=clusters),
                       psum_scatter(p[None], 1, 2)[0])


def test_a_partial_counted_after_the_next_wait_can_hang():
    """The reduce-scatter counts a tile's outgoing partial at the item's
    end.  Counted only after the next item's wait (the planted fault), a
    cluster whose next item waits for the partial it holds back hangs:
    with the ranks rotated, every item's partial comes from the item n·T
    back, T the items of a rank and step, so on n·T clusters that is the
    same cluster's previous item.  Counted at the item's end, the same
    grid finishes."""
    n, m, ct = 4, 4, 2
    T = row_groups(m) * ct
    p = torch.randn((n, n * m, 4))
    assert torch.equal(replay_rs(p, clusters=n * T),
                       psum_scatter(p[None], 1, 2)[0])
    with pytest.raises(ProtocolError, match="no cluster can move"):
        replay_rs(p, clusters=n * T, fault="counted-after-wait")


@pytest.mark.parametrize("kernel", ["gather", "reduce-scatter"])
def test_a_grid_past_the_resident_clusters_can_hang(kernel):
    """A grid of more clusters than fit at once (sized by the SM count
    while the card holds fewer clusters of 2): the resident clusters wait
    for items that a cluster not yet started holds, and none can move."""
    x, w = inputs(4, 4)
    p = torch.randn((4, 16, 4))
    with pytest.raises(ProtocolError, match="no cluster can move"):
        if kernel == "gather":
            replay_ag(x.float(), w.float(), clusters=5, resident=2)
        else:
            replay_rs(p, clusters=5, resident=2)
