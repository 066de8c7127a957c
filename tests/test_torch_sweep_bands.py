"""The band route of the sweep kernel (csrc/wavefront_segment.cu,
wavefront_band_kernel), emulated in plain torch on the CPU.

band_sweep below follows the kernel's control flow: each band of columns
keeps its own ring of (k + W) slots, loads the carried diagonals from the
ring in (halo columns included), computes only the true cells of its columns
on the diagonals band_plan's rules give it, and reads its left neighbour's
cells only through the k-column slices that neighbour published, diagonal by
diagonal; a diagonal the neighbour never published reads as NaN, and so do
ring slots the band never wrote, so a cell that read anything it should not
would come out NaN. The bands run in dependency order (left to right). The
result must be bit-equal to the plain sweep (wavefront_plain) on every true
cell, ring and corner, and the plain sweep and the emulation to the JAX
reference's segments (XLA:CPU); the Forward is held within the tolerance
chip_smoke.py holds the kernel to.

band_protocol models the route's progress counters and halo ring alone,
the bands interleaved a step at a time: no band waits forever, no slice is
overwritten before it is read, and no wait sees its counter stand still for
more than a few steps, however wide the pair.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coati_tpu.align import longseq as jax_longseq
from coati_tpu.align.wavefront import gap_consts_array
from coati_tpu.structs import GapParams
from coati_tpu_torch.align import wavefront as tw
from coati_tpu_torch.kernels import wavefront_segment as seg_mod
from coati_tpu_torch.kernels.wavefront_fill import SMEM_BYTES

FWD_RTOL, FWD_ATOL = 4e-6, 2e-5  # chip_smoke.py's, of the Forward's values
NAN = float("nan")


def _group(seed, k, la, lb, n_codes=16):
    """Pairs of the given lengths (multiples of 3k and k) padded to their
    maxima, descendant codes < n_codes (all 15 IUPAC columns and the gap)."""
    rng = np.random.default_rng(seed)
    la, lb = np.array(la, np.int32), np.array(lb, np.int32)
    B = len(la)
    aseq = np.zeros((B, int(la.max())), np.int32)
    bseq = np.zeros((B, int(lb.max())), np.int32)
    for p in range(B):
        aseq[p, : la[p]] = rng.integers(0, 183, la[p])
        bseq[p, : lb[p]] = rng.integers(0, n_codes, lb[p])
    return aseq, bseq, la, lb


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def _cells(i, j, k, preds, a, b, table, gc, log):
    """Cells (i, j) of one diagonal from their predecessors' M, D, I in the
    band's ring: preds = ([3, n] at slots c - 1 of diagonal d - 2, c and
    c - k of diagonal d - k, c = j - off): csrc/common.cuh cell_update."""
    ng, gs, go, ge = (gc[q] for q in range(4))
    gek1, gek, ngo = ge * float(k - 1), ge * float(k), ng + go
    plus2 = tw.lse if log else torch.maximum
    ci, ck, cl = preds
    diag, up, left = (i >= 1) & (j >= 1), i >= k, j >= k
    low = torch.full_like(ci[0], tw.LOWEST)
    p2M, p2D, p2I = (torch.where(diag, ci[s], low) for s in range(3))
    pkM, pkD, pkI = (torch.where(up, ck[s], low) for s in range(3))
    pkMs = torch.where(left, cl[0], low)
    pkIs = torch.where(left, cl[2], low)
    code = b[(j - k).clamp(min=0)]
    sub = torch.where(code < 15, table.reshape(-1)[a[(i - k).clamp(min=0)] * 15
                                                   + code.clamp(max=14)], 0.0)
    m2m0, d2m0, i2m0 = (p2M + ng) + ng, p2D + gs, (p2I + gs) + ng
    m2d0, i2d0, m2i0 = (pkM + ng) + go, (pkI + gs) + go, pkMs + go
    M = plus2(plus2(m2m0 + sub, d2m0 + sub), i2m0 + sub)
    D = plus2(plus2(m2d0 + gek1, pkD + gek), i2d0 + gek1)
    I = plus2(m2i0 + gek1, pkIs + gek)
    body = up & left
    m_marg = torch.where((i == k - 1) & (j == k - 1), 0.0, tw.LOWEST)
    d_ok = (j == k - 1) & (i >= 2 * k - 1) & ((i - (k - 1)) % k == 0)
    i_ok = (i == k - 1) & (j >= 2 * k - 1) & ((j - (k - 1)) % k == 0)
    d_marg = torch.where(d_ok, tw.margin_values(ngo, ge, i), tw.LOWEST)
    i_marg = torch.where(i_ok, tw.margin_values(go, ge, j), tw.LOWEST)
    M, D, I = (torch.where(body, v, marg)
               for v, marg in ((M, m_marg), (D, d_marg), (I, i_marg)))
    bm = tw.argmax_mdi(m2m0, d2m0, i2m0)
    bd = tw.argmax_mdi(m2d0, pkD + ge, i2d0)
    bi = torch.where(m2i0 > pkIs + ge, 0, 2).to(torch.uint8)
    return M, D, I, bm | (bd << 2) | (bi << 4)


def band_sweep(aseq, bseq, la, lb, table, gc, carry, d0, *, k, n_steps, mode,
               plan):
    """The band route's sweep of diagonals [d0, d0 + n_steps), mode
    "viterbi" (with bp), "score" or "forward" (d0 = 0, every diagonal).
    Returns (adj [3, B], bp [B, n_steps, C] or mdi [B, NA+k, C, 3] or None,
    (ring_out, corners_out)); cells the route does not write stay NaN
    (mdi) or 0 (bp)."""
    B, NA = aseq.shape
    C = bseq.shape[1] + k
    K = max(k, 2)
    nring = K + 1
    ring_in, corners_in = carry
    log = mode == "forward"
    ng, gs = gc[0], gc[1]
    ring_out = torch.full((K, 3, B, C), tw.LOWEST)
    corners_out = corners_in.clone()
    adj = torch.stack([(corners_in[0] + ng) + ng, corners_in[1] + gs,
                       (corners_in[2] + gs) + ng])
    out = None
    if mode == "viterbi":
        out = torch.zeros((B, n_steps, C), dtype=torch.uint8)
    elif log:
        out = torch.full((B, NA + k, C, 3), NAN)
    W = plan.width
    for p in range(B):
        rows, cols = int(la[p]) + k, int(lb[p]) + k
        d_last = rows + cols - 2
        d_end = min(d0 + n_steps - 1, d_last)
        published = {}  # the left neighbour's slices: diagonal -> [3, k]
        for j0, j1 in plan.bands:
            off = j0 - k
            ring = torch.full((nring, 3, k + W), NAN)
            slots = torch.arange(off, j1)
            for q in range(K):
                ring[(d0 - 1 - q) % nring, :, : j1 - off] = torch.where(
                    slots >= 0, ring_in[q, :, p, slots.clamp(min=0)], tw.LOWEST)
            d_first = max(d0, j0)
            d_stop = min(d_end, j1 - 1 + rows - 1) if j0 < cols else d_first - 1
            mine = {}
            copied = d0 - 1
            for d in range(d_first, d_stop + 1):
                if j0 > 0:
                    e_lo = max(copied + 1, d - K, d0)
                    for e in range(e_lo, d):
                        ring[e % nring, :, :k] = published.get(
                            e, torch.full((3, k), NAN))
                    copied = max(copied, d - 1)
                lo = max(0, d - (rows - 1), j0)
                hi = min(d, cols - 1, j1 - 1)
                if lo <= hi:
                    j = torch.arange(lo, hi + 1)
                    i = d - j
                    c = j - off
                    r2 = ring[(d - 2) % nring]
                    rk = ring[(d - k) % nring]
                    M, D, I, code = _cells(
                        i, j, k, (r2[:, c - 1], rk[:, c], rk[:, c - k]),
                        aseq[p], bseq[p], table, gc, log)
                    ring[d % nring, :, c] = torch.stack((M, D, I))
                    if mode == "viterbi":
                        out[p, d - d0, j] = code
                    elif log:
                        out[p, i, j] = torch.stack((M, D, I), dim=-1)
                    if d == d_last:
                        corners_out[:, p] = torch.stack((M[-1], D[-1], I[-1]))
                        adj[:, p] = torch.stack(
                            ((M[-1] + ng) + ng, D[-1] + gs, (I[-1] + gs) + ng))
                mine[d] = ring[d % nring, :, j1 - j0 : j1 - j0 + k].clone()
            published = mine
            for q in range(K):  # ring_out, the band's own columns
                dq = d0 + n_steps - 1 - q
                if not 0 <= dq <= d_last:
                    continue
                j_lo, j_hi = max(0, dq - (rows - 1), j0), min(dq, cols - 1, j1 - 1)
                if j_lo <= j_hi:
                    ring_out[q, :, p, j_lo : j_hi + 1] = ring[
                        dq % nring, :, j_lo - off : j_hi + 1 - off]
    return adj, out, (ring_out, corners_out)


def _true_cells(la, lb, k, d_first, n_diag, C, body=False):
    """[B, n_diag, C] mask of each pair's (la+k) x (lb+k) cells on diagonals
    d_first .. d_first + n_diag - 1 (body: i, j >= k)."""
    d = (d_first + torch.arange(n_diag))[None, :, None]
    j = torch.arange(C)[None, None, :]
    i = d - j
    lo = k if body else 0
    la = torch.as_tensor(la).long()[:, None, None]
    lb = torch.as_tensor(lb).long()[:, None, None]
    return (i >= lo) & (i < la + k) & (j >= lo) & (j < lb + k)


def _assert_ring_equal(got, want, la, lb, k, d_top):
    """Rings [K, 3, B, C] (ring[q] = diagonal d_top - q) equal on true
    cells; the route's ring holds LOWEST everywhere else."""
    K, _, B, C = got.shape
    mask = _true_cells(la, lb, k, d_top - K + 1, K, C).flip(1)  # [B, K, C]
    m = mask.permute(1, 0, 2)[:, None].expand(K, 3, B, C)
    assert torch.equal(got[m], want[m])
    assert bool((got[~m] == tw.LOWEST).all())


def _plan(B, C, k, blocks, n_bands=None):
    plan = seg_mod.band_plan(B, C, k, blocks, 64)
    assert plan is not None
    if n_bands is not None:
        assert len(plan.bands) == n_bands
    return plan


def _segment_chain(mg94_table, k, la, lb, blocks, T, seed):
    """Both sweeps chained from the empty carry over every segment of T
    diagonals: bp on true cells, ring and corners equal after every segment;
    returns the plan and the last adjusted corners."""
    aseq, bseq, la, lb = _group(seed, k, la, lb)
    gc = gap_consts_array(GapParams(len=k))
    args = _torch(aseq, bseq, la, lb, mg94_table, gc)
    B, C = aseq.shape[0], bseq.shape[1] + k
    Dtot = aseq.shape[1] + bseq.shape[1] + 2 * k - 1
    assert Dtot % T != 0
    plan = _plan(B, C, k, blocks)
    carry_b = carry_p = seg_mod.empty_carry(B, C, k, "cpu")
    for s in range(-(-Dtot // T)):
        adj_b, bp_b, carry_b = band_sweep(*args, carry_b, s * T, k=k, n_steps=T,
                                          mode="viterbi", plan=plan)
        adj_p, bp_p, carry_p = seg_mod.segment_plain(*args, carry_p, s * T, k=k,
                                                     n_steps=T, want_bp=True)
        mask = _true_cells(la, lb, k, s * T, T, C)
        assert torch.equal(bp_b[mask], bp_p[mask]), f"bp of segment {s}"
        _assert_ring_equal(carry_b[0], carry_p[0], la, lb, k, (s + 1) * T - 1)
        assert torch.equal(carry_b[1], carry_p[1])
    assert torch.equal(adj_b, adj_p)
    return plan, (aseq, bseq, la, lb, gc), adj_b


@pytest.mark.parametrize("k,la,lb,blocks,T,seed", [
    (1, (150, 99, 195), (200, 131, 170), 4, 97, 1),
    (3, (99, 198, 144), (192, 150, 201), 4, 89, 2),
    (5, (195, 120), (200, 150), 5, 97, 3),
])
def test_band_segments_equal_plain_and_xla(mg94_table, k, la, lb, blocks, T, seed):
    """k = 1, 3, 5: a ragged group in segments of T diagonals (T not dividing
    the diagonals) from the carried ring, each band reading its neighbour
    only through the published slices, equals the plain sweep and the JAX
    reference's _segment chain (XLA:CPU) on every true cell."""
    plan, (aseq, bseq, la, lb, gc), adj = _segment_chain(
        mg94_table, k, la, lb, blocks, T, seed)
    assert 3 <= len(plan.bands) <= 6
    B, NA = aseq.shape
    C = bseq.shape[1] + k
    jargs = [jnp.asarray(x) for x in (aseq, bseq, la, lb, mg94_table, gc)]
    ring = jnp.full((max(k, 2), 3, B, C), np.float32(tw.LOWEST))
    corners = tuple(jnp.full((B,), np.float32(tw.LOWEST)) for _ in range(3))
    Dtot = NA + bseq.shape[1] + 2 * k - 1
    for s in range(-(-Dtot // T)):
        adj_x, _, (ring, corners) = jax_longseq._segment(
            *jargs, ring, corners, jnp.int32(s * T), k=k, n_steps=T, mode="score")
    np.testing.assert_array_equal(adj.numpy(), np.stack([np.asarray(c) for c in adj_x]))


def test_bands_without_cells_of_the_short_pair(mg94_table):
    """A ragged group where the later bands hold no cell of the short pair
    (its columns end in the first band), and, in later segments, bands whose
    cells all lie before the segment: both sweeps still agree."""
    plan, (aseq, bseq, la, lb, _), _ = _segment_chain(
        mg94_table, 1, (30, 201), (40, 200), 5, 61, 4)
    C = bseq.shape[1] + 1
    assert int(lb[0]) + 1 <= plan.bands[0][1] and len(plan.bands) >= 4
    assert C == plan.bands[-1][1]


def test_a_last_band_narrower_than_the_others(mg94_table):
    """C = 196 slots at 5 blocks: four bands of 40 and a last of 36."""
    plan, _, _ = _segment_chain(mg94_table, 1, (195,), (195,), 5, 150, 5)
    widths = [j1 - j0 for j0, j1 in plan.bands]
    assert widths[-1] < plan.width and min(widths) >= 33


@pytest.mark.parametrize("k", [1, 3])
def test_band_score_sweep_equals_the_score_kernels_plain(mg94_table, k):
    """The score entry point: every diagonal from an empty ring in one launch
    (the last band of the long pair waits the longest for its first cell)."""
    aseq, bseq, la, lb = _group(10 + k, k, (9 * k * 3, 60 * k), (180, 90))
    gc = gap_consts_array(GapParams(len=k))
    args = _torch(aseq, bseq, la, lb, mg94_table, gc)
    B, C = aseq.shape[0], bseq.shape[1] + k
    Dtot = aseq.shape[1] + bseq.shape[1] + 2 * k - 1
    plan = _plan(B, C, k, 6)
    adj, _, _ = band_sweep(*args, seg_mod.empty_carry(B, C, k, "cpu"), 0, k=k,
                           n_steps=Dtot, mode="score", plan=plan)
    want = tw.wavefront_plain(*args, k=k, mode="score")[0]
    assert torch.equal(adj, torch.stack(want))


@pytest.mark.parametrize("k", [1, 3])
def test_band_forward_within_tolerance_of_plain(mg94_table, k):
    """The Forward entry point: every M, D, I of each pair's rectangle and
    the corners within FWD_ATOL + FWD_RTOL * |value| of the plain Forward."""
    aseq, bseq, la, lb = _group(20 + k, k, (126, 9 * k), (150, 120))
    gc = gap_consts_array(GapParams(len=k))
    args = _torch(aseq, bseq, la, lb, mg94_table, gc)
    B, C = aseq.shape[0], bseq.shape[1] + k
    Dtot = aseq.shape[1] + bseq.shape[1] + 2 * k - 1
    plan = _plan(B, C, k, 4)
    adj, mdi, _ = band_sweep(*args, seg_mod.empty_carry(B, C, k, "cpu"), 0, k=k,
                             n_steps=Dtot, mode="forward", plan=plan)
    adj_p, mdi_p = tw.wavefront_plain(*args, k=k, mode="forward", semiring="log")
    adj_p = torch.stack(adj_p)
    assert bool((abs(adj - adj_p) <= FWD_ATOL + FWD_RTOL * adj_p.abs()).all())
    for p in range(B):
        got = mdi[p, : int(la[p]) + k, : int(lb[p]) + k]
        want = mdi_p[p, : int(la[p]) + k, : int(lb[p]) + k]
        live = want > -1e30
        assert torch.equal(live, got > -1e30)
        assert bool((abs(got[live] - want[live])
                     <= FWD_ATOL + FWD_RTOL * want[live].abs()).all())


@pytest.mark.parametrize("B,C,k,blocks,threads", [
    (4, 32001, 1, 32, 1024), (1, 10_000, 1, 20, 512), (1, 160_003, 1, 132, 1024),
    (3, 6_565, 3, 13, 512), (2, 6_601, 5, 13, 1024), (1, 29_398, 1, 58, 512),
    (1, 196, 1, 5, 64), (3, 202, 5, 6, 32), (8, 4_097, 2, 16, 256),
    (1, 100, 1, 9, 32), (2, 70, 5, 4, 32),
])
def test_band_plan_tiles_the_columns(B, C, k, blocks, threads):
    """The bands cover [0, C) without gap or overlap, each at least k + 32
    wide and all but the last `width`; no more than `blocks`; the ring and
    the table fit one block's shared memory; the halo ring outlasts
    max(k, 2) + 2 diagonals; the scratch is the halo rings and counters."""
    plan = seg_mod.band_plan(B, C, k, blocks, threads)
    if plan is None:
        assert min(blocks, C // (k + 32)) < 2
        return
    bands = plan.bands
    assert 2 <= len(bands) <= blocks
    assert bands[0][0] == 0 and bands[-1][1] == C
    assert all(b[1] == n[0] for b, n in zip(bands, bands[1:]))
    assert all(j1 - j0 == plan.width for j0, j1 in bands[:-1])
    assert min(j1 - j0 for j0, j1 in bands) >= k + 32
    assert plan.smem_bytes <= SMEM_BYTES
    assert plan.smem_bytes == ((max(k, 2) + 1) * 3 * (k + plan.width) + 183 * 15) * 4
    assert plan.slots > max(k, 2) + 2
    assert plan.halo == k
    assert plan.cells_a_thread == -(-plan.width // threads)
    n = len(bands)
    assert plan.scratch_bytes == B * ((n - 1) * plan.slots * 3 * k * 4 + n * 4)


def test_band_plan_refuses_what_the_kernel_cannot_take():
    """No band route for one band, k over 32, a ring (or a table) over
    shared memory, or a halo ring that does not outlast K + 2 diagonals."""
    assert seg_mod.band_plan(1, 64, 1, 4, 64) is None  # one band of >= 33
    assert seg_mod.band_plan(1, 5000, 40, 4, 64) is None
    assert seg_mod.band_plan(4, 32001, 1, 4, 1024) is None  # 8,001 columns a band
    assert seg_mod.band_plan(4, 32001, 1, 32, 1024, table_len=24 * 183 * 15) is None
    with pytest.raises(ValueError, match="outlast"):
        seg_mod.band_plan(1, 1000, 3, 4, 64, slots=5)
    assert seg_mod.band_plan(1, 1000, 3, 4, 64, slots=6).slots == 6


def test_sweep_launch_takes_the_band_route_without_a_global_ring():
    """Several blocks a pair go to the band route with halo rings and
    counters and no global ring; where the band's ring does not fit, to the
    barrier route; several="barrier" forces that route; stamps go to the
    band route alone; a shape the kernel does not take, a launch made for
    another sweep, or stamps too short raise."""
    launch = seg_mod.sweep_launch(4, 32001, 1, 32, 1024)
    ring, sync, halo, nxt, stamps = launch.buffers("cpu")
    assert launch.route == "bands" and ring is None and sync is None
    assert tuple(halo.shape) == (4, 31, seg_mod.HALO_SLOTS, 3, 1)
    assert nxt.tolist() == [[0] * 32] * 4 and stamps is None
    assert launch.ints() == (3, 32, 1001, seg_mod.HALO_SLOTS, 183 * 15)
    launch.check(4, 32001, 1, 183 * 15)
    with pytest.raises(ValueError, match="a launch for B=4 C=32001"):
        launch.check(4, 32001, 3, 183 * 15)
    barrier = seg_mod.sweep_launch(2, 32001, 1, 4, 1024)  # 8,001 a band
    ring, sync, halo, nxt, _ = barrier.buffers("cpu")
    assert barrier.route == "barrier" and halo is None and nxt is None
    assert tuple(ring.shape) == (2, 3, 3, 32001) and sync.tolist() == [0, 0]
    forced = seg_mod.sweep_launch(4, 32001, 1, 32, 1024, several="barrier")
    assert forced.route == "barrier" and forced.blocks == 32
    stamps = torch.full((3 * 4 * 32,), -1, dtype=torch.int64)
    timed = seg_mod.sweep_launch(4, 32001, 1, 32, 1024, stamps=stamps)
    assert timed.buffers("cpu")[4] is stamps
    assert seg_mod.sweep_launch(2, 32001, 1, 4, 1024, stamps=stamps).buffers(
        "cpu")[4] is None  # the barrier route writes none
    with pytest.raises(ValueError, match="stamps must be int64"):
        seg_mod.sweep_launch(4, 32001, 1, 32, 1024, stamps=stamps[:-1])
    with pytest.raises(ValueError, match="'bands' or 'barrier'"):
        seg_mod.sweep_launch(4, 32001, 1, 32, 1024, several="ring")
    with pytest.raises(ValueError, match="multiple of 32"):
        seg_mod.sweep_launch(1, 1000, 1, 1, 100)


INT_MAX = 2**31 - 1


def band_protocol(plan, rows, cols, d0, n_steps, k, echo=True):
    """The band route's progress counters and halo ring for one pair
    (csrc/wavefront_segment.cu wavefront_band_kernel), every band taking
    one step a round in turn: a poll, a store, a slice copy or a diagonal's
    cells. Every slice a band copies from a busy neighbour's diagonals must
    hold the diagonal it wants, and every band must end. Returns the longest
    run of polls in which a wait saw its counter stand still. echo=False is
    the protocol without the echo: counters start at each band's first
    diagonal and a band waiting for its first cell publishes nothing."""
    K, F = max(k, 2), plan.slots
    d_end = min(d0 + n_steps - 1, rows + cols - 2)
    n = len(plan.bands)
    nxt = [0] * n
    halo = [[None] * F for _ in range(n - 1)]
    longest = [0]

    def first_stop(b):
        j0, j1 = plan.bands[b]
        d_first = max(d0, j0)
        return d_first, (min(d_end, j1 - 1 + rows - 1) if j0 < cols else d_first - 1)

    def wait(flag, target, seen, echo_to=None, cap=0):
        still = 0
        while seen < target:
            now = nxt[flag]
            if now != seen:
                seen, still = now, 0
                if echo_to is not None:
                    nxt[echo_to] = min(now, cap)
            else:
                still += 1
                longest[0] = max(longest[0], still)
            yield
        return seen

    def band(b):
        d_first, d_stop = first_stop(b)
        busy = d_first <= d_stop
        nxt[b] = (d0 if echo else d_first) if busy else INT_MAX
        yield
        left_seen = right_seen = 0
        copied = d0 - 1
        for d in range(d_first, d_stop + 1):
            if b > 0 and max(copied + 1, d - K, d0) < d:
                e_lo = max(copied + 1, d - K, d0)
                to = b if echo and d == d_first else None
                left_seen = yield from wait(b - 1, d, left_seen, to, d_first)
                yield
                lf, ls = first_stop(b - 1)
                for e in range(max(e_lo, lf), min(d - 1, ls) + 1):
                    assert halo[b - 1][e % F] == e, f"band {b} read a stale slice"
                copied = d - 1
            yield  # the diagonal's cells
            if b + 1 < n:
                right_seen = yield from wait(b + 1, d - F + K + 1, right_seen)
                halo[b][d % F] = d
            nxt[b] = d + 1
            yield
        if busy:
            nxt[b] = INT_MAX

    running = [band(b) for b in range(n)]
    rounds = 0
    while running:
        rounds += 1
        assert rounds < 10 * (d_end - d0 + 1) + 1000, "the bands deadlocked"
        for g in list(running):
            try:
                next(g)
            except StopIteration:
                running.remove(g)
    return longest[0]


@pytest.mark.parametrize("k,C,rows,blocks,d0,T,slots", [
    (1, 600, 40, 6, 0, 639, 256),  # a whole sweep: the last band starts 500 in
    (1, 600, 40, 6, 0, 639, 5),  # the least ring: back-pressure binds
    (3, 600, 60, 6, 0, 659, 6),
    (5, 600, 30, 5, 0, 629, 8),
    (1, 600, 40, 6, 300, 97, 5),  # a later segment: the first bands are idle
    (1, 900, 40, 9, 0, 939, 5),
    (1, 3000, 40, 30, 0, 3039, 5),  # five times wider: the bound holds
])
def test_band_counters_keep_moving(k, C, rows, blocks, d0, T, slots):
    """Every wait of the band route sees its counter move within a few
    rounds whatever C is, so a watchdog on a still counter may be short: a
    band waiting for its first cell echoes its left neighbour's counter.
    With the halo ring at its least (max(k, 2) + 3) the bands still end, and
    no slice is overwritten before it is read."""
    plan = seg_mod.band_plan(1, C, k, blocks, 64, slots=slots)
    assert plan.bands[-1][0] >= 480 and len(plan.bands) == blocks
    assert band_protocol(plan, rows, C, d0, T, k) <= 6


def test_without_the_echo_a_far_band_waits_on_a_still_counter():
    """What the echo is for: without it the last band's left neighbour
    keeps its counter at its own first diagonal until its own left
    neighbour reaches it, a stall that grows with C (in the kernel some
    0.4 s at 160 knt, seconds at several hundred knt)."""
    plan = seg_mod.band_plan(1, 600, 1, 6, 64)
    assert band_protocol(plan, 40, 600, 0, 639, 1, echo=False) > 500
    assert band_protocol(plan, 40, 600, 0, 639, 1) <= 6
