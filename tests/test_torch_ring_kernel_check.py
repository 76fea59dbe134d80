"""The ring protocol of csrc/ring.cu, replayed on the CPU.

The kernels cannot run here, so their step-by-step ownership is replayed
launch by launch: which rank reads which slot (or which partial) at which
ring step, where it copies what it read, and in what order the
reduce-scatter adds.  The replay follows the kernels' schedule (``ag_step``
and the index arithmetic of ``ring_ag_matmul_kernel`` and
``ring_matmul_rs_kernel``) and asserts the protocol's invariants:

- no rank reads a slot (a row of a gathered shard, or a partial sum)
  before the launch that delivered it has ended: a launch sees only what
  earlier launches wrote, as the stream order guarantees and nothing
  more;
- within one launch no rank writes a buffer region another rank reads;
- every gathered row lands once, every output row is computed once;
- the gathered operand equals the plain version's bit for bit, the
  products agree with the whole gathered product within 1e-6 in fp32
  (each segment's rows are a separate product; seen: equal), and the
  reduce-scatter equals ``mesh.psum_scatter`` bit for bit, its ring
  summation order included.

The clean replay must pass for both gather directions; each planted fault
(a wrong slot index, a skipped step, a partial-sum buffer reused one step
early) must fail.
"""

from __future__ import annotations

import pytest
import torch

from tpu_dra_torch.workloads import collective_matmul as cm
from tpu_dra_torch.workloads.mesh import psum_scatter


class ProtocolError(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise ProtocolError(msg)


def ag_segments(n: int, m: int, i: int, bidir: bool):
    """``ag_step`` of ring.cu: step i's segments ``(slot offset, first
    row, rows, direction the rows travel on: +1, -1 or 0)``."""
    fwd = i < n - 1
    if not bidir:
        return [(-i, 0, m, 1 if fwd else 0)]
    half = m // 2
    return [(-i, half, half, 1 if fwd else 0),       # high half, right
            (i, 0, half, -1 if fwd else 0)]          # low half, left


def replay_ag(x, w, fault=None):
    """The all-gather-matmul over x ``[n, m, K]`` (rank r's shard) and w
    ``[n, K, N]``; returns ``(y [n, n·m, N] fp32 sums, a [n, n, m, K])``."""
    n, m, K = x.shape
    bidir = m % 2 == 0 and n > 2
    a = torch.zeros((n, n, m, K))
    landed = torch.full((n, n, m), -1)       # launch that wrote each row
    y = torch.zeros((n, n * m, w.shape[-1]))
    computed = torch.zeros((n, n * m), dtype=torch.int64)
    for i in range(n):
        if fault == "skipped-step" and i == n - 2:
            continue
        reads, writes = [], []
        for r in range(n):
            for off, row0, rows, dst in ag_segments(n, m, i, bidir):
                slot = (r + off) % n
                if fault == "wrong-slot" and i > 0:
                    slot = (slot + off // abs(off)) % n   # one hop too far
                rr = slice(row0, row0 + rows)
                if i == 0:
                    src = x[r, rr]
                    writes.append((r, slot, rr, src))     # own a[r]
                else:
                    seen = landed[r, slot, rr]
                    check(bool(((seen >= 0) & (seen < i)).all()),
                          f"step {i}: rank {r} reads rows {row0}.. of slot "
                          f"{slot} before they were delivered")
                    src = a[r, slot, rr]
                    reads.append((r, slot, rr))
                y[r, slot * m + row0:slot * m + row0 + rows] = src @ w[r]
                computed[r, slot * m + row0:slot * m + row0 + rows] += 1
                if dst:
                    writes.append(((r + dst) % n, slot, rr, src.clone()))
        for r, s, rr, _ in writes:
            for r2, s2, rr2 in reads:
                overlap = (r, s) == (r2, s2) and rr.start < rr2.stop \
                    and rr2.start < rr.stop
                check(not overlap, f"step {i}: rank {r}'s slot {s} is "
                      f"written while it is read")
        for r, s, rr, v in writes:
            check(bool((landed[r, s, rr] == -1).all()),
                  f"step {i}: rows of slot {s} land twice on rank {r}")
            a[r, s, rr] = v
            landed[r, s, rr] = i
    check(bool((computed == 1).all()), "an output row was computed "
          f"{int(computed.min())} or {int(computed.max())} times")
    check(bool((landed >= 0).all()), "a gathered row never arrived")
    return y, a


def replay_rs(p, fault=None):
    """The matmul-reduce-scatter over the ranks' fp32 products p ``[n,
    n·m, N]``: step t, rank r works on chunk c = (r − 1 − t) mod n, adds
    its own product to the partial from the left in comm[r][t % 2] and
    sends the sum to comm[r + 1][(t + 1) % 2], or keeps it on the last
    step.  Returns y ``[n, m, N]``."""
    n, nm, N = p.shape
    m = nm // n
    comm = torch.zeros((n, 2, m, N))
    wrote = torch.full((n, 2), -1)           # launch that last wrote a slot
    y = torch.full((n, m, N), float("nan"))
    for t in range(n):
        if fault == "skipped-step" and t == n - 2:
            continue
        reads, writes = set(), []
        for r in range(n):
            c = (r + 2 * n - 1 - t) % n
            acc = p[r, c * m:(c + 1) * m]
            if t > 0:
                check(int(wrote[r, t % 2]) == t - 1,
                      f"step {t}: rank {r} reads a partial the previous "
                      f"step did not deliver")
                acc = acc + comm[r, t % 2]
                reads.add((r, t % 2))
            if t < n - 1:
                slot = (t + 1) % 2 if fault != "early-reuse" else t % 2
                writes.append(((r + 1) % n, slot, acc))
            else:
                y[r] = acc
        for r, s, v in writes:
            check((r, s) not in reads, f"step {t}: rank {r}'s partial "
                  f"slot {s} is overwritten while it is read")
            comm[r, s] = v
            wrote[r, s] = t
    return y


def inputs(n, m, K=16, N=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, m, K), generator=g).bfloat16()
    w = torch.randn((n, K, N), generator=g).bfloat16()
    return x, w


CASES = [(4, 4), (4, 3), (3, 2), (2, 4), (8, 6)]   # (n, m): both directions


@pytest.mark.parametrize("n,m", CASES)
def test_clean_gather_replay_passes_and_equals_the_plain_version(n, m):
    x, w = inputs(n, m)
    y, a = replay_ag(x.float(), w.float())
    _, want_a = cm.all_gather_matmul_ref(x[None], w[None])
    assert torch.equal(a, want_a[0].float())
    want_y = x.float().reshape(n * m, -1) @ w.float()       # [n, n·m, N]
    torch.testing.assert_close(y, want_y, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_clean_reduce_scatter_replay_adds_in_the_plain_versions_order(n):
    """Values chosen so that fp32 sums depend on their order: the replay
    (the kernel's order) is bit-equal to ``mesh.psum_scatter``, and from
    three ranks on (two addends commute) it is not the rank-order sum."""
    m, N = 2, 4
    g = torch.Generator().manual_seed(n)
    p = torch.randn((n, n * m, N), generator=g) * torch.tensor(
        [2.0 ** (8 * (r % 3)) for r in range(n)])[:, None, None]
    y = replay_rs(p)
    assert torch.equal(y, psum_scatter(p[None], 1, 2)[0])
    if n > 2:
        assert not torch.equal(y, p.reshape(n, n, m, N).sum(0))


@pytest.mark.parametrize("fault", ["wrong-slot", "skipped-step"])
@pytest.mark.parametrize("n,m", [(4, 4), (4, 3), (3, 2)])
def test_planted_gather_faults_fail_the_replay(n, m, fault):
    x, w = inputs(n, m)
    with pytest.raises(ProtocolError):
        replay_ag(x.float(), w.float(), fault=fault)


@pytest.mark.parametrize("fault", ["early-reuse", "skipped-step"])
@pytest.mark.parametrize("n", [3, 4])
def test_planted_reduce_scatter_faults_fail_the_replay(n, fault):
    p = torch.randn((n, 2 * n, 4))
    with pytest.raises(ProtocolError):
        replay_rs(p, fault=fault)
