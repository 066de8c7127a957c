"""The strip fill (csrc/wavefront_fill.cu, strip_fill_kernel) and the
windowed whole-stack walk (csrc/traceback_walk.cu, traceback_walk_kernel),
emulated in plain torch on the CPU.

strip_fill below follows the fill kernel's traversal: each worker (a warp)
sweeps stripes of 32 strips of W columns, one strip a lane, row by row with
lane l one row behind lane l - 1; the lane keeps the last k rows of its
strip in slots t % k; the left strip's edge of a row (M and I of its last k
columns, D of its last) comes from lane l - 1's previous step, or for lane
0 from the left stripe's edge: the warp boundary's ring of RING_ROWS rows in
shared memory, or the edge buffer of the block's last warp (passes, several
blocks a pair) counted every BATCH rows, read BATCH rows at a time
into registers once AHEAD rows beyond lane 0's row are there (a ring slot is
free again once its batch is in registers). The workers of a pair run interleaved,
each waiting as the kernel waits (for the row it reads, and before it
overwrites a ring slot not yet taken): in each round every worker, in a
random order, runs a random number of steps up to 200 or until it must wait,
so producers run far ahead of their readers and the ring fills; a round in
which none can move is a deadlock. Every register, ring slot and edge entry not yet
written reads as NaN, so a cell that read anything it should not would
differ. The result must be bit-equal to wavefront_plain (rows_from_diagonals
of its stack) and to XLA:CPU (coati_tpu/align/wavefront.py) on every true
cell's backpointer byte and on the corners. With want_bp=False it follows
the score-only body (kBp = false): the same traversal, no stack written.

The long path's two passes (kCkpt) follow the same traversal: pass 1,
score-only, also stores each lane's W columns of M, D, I of the k rows
above every band boundary as it passes them (ckpt_fill); pass 2 fills one
band of rows with backpointers, each lane starting every stripe from the
checkpoint (its k register rows, its own edge of the row above the band and
its left neighbour's), the rows of the loop relative to the band and the
cells' absolute (band_fill). The checkpoint is NaN wherever pass 1 did not
write it, so a band that read such an entry would differ.

window_walk follows the walk kernel: windows of 2kS rows and columns above
and left of an anchor, the next one anchored where the walk stands after
each round of S steps and used a round later; a byte outside the window the
walk reads from is an error. It must be op-for-op equal to traceback_plain.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coati_tpu.align.wavefront import gap_consts_array, wavefront
from coati_tpu.structs import GapParams
from coati_tpu_torch.align import engine
from coati_tpu_torch.align import wavefront as tw
from coati_tpu_torch.kernels import traceback_walk as walk_mod
from coati_tpu_torch.kernels import wavefront_fill as fill_mod
from coati_tpu_torch.kernels import wavefront_score as score_mod

NAN = float("nan")
RING_ROWS = fill_mod.RING_ROWS
BATCH = 8  # csrc/wavefront_fill.cu kBatch: rows of a stripe edge taken, and counted, at once
AHEAD = 16  # kAhead: rows a reader waits for beyond its own


def _group(seed, k, la, lb, n_codes=16, G=1):
    """Pairs of the given lengths (multiples of 3k and k) padded to their
    maxima; ancestor p uses table p % G of a stacked [G * 183, 15] table."""
    rng = np.random.default_rng(seed)
    la, lb = np.array(la, np.int32), np.array(lb, np.int32)
    B = len(la)
    aseq = np.zeros((B, int(la.max())), np.int32)
    bseq = np.zeros((B, int(lb.max())), np.int32)
    for p in range(B):
        aseq[p, : la[p]] = rng.integers(0, 183, la[p]) + 183 * (p % G)
        bseq[p, : lb[p]] = rng.integers(0, n_codes, lb[p])
    return aseq, bseq, la, lb


def _tables(mg94_table, G):
    rng = np.random.default_rng(17)
    if G == 1:
        return np.asarray(mg94_table, np.float32)
    noise = rng.uniform(-0.5, 0.5, (G - 1, *np.shape(mg94_table)))
    stacked = [np.asarray(mg94_table)] + list(np.asarray(mg94_table) + noise)
    return np.concatenate(stacked).astype(np.float32)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def cell_compute(i, j, k, p2, pk, ps, sub, gc):
    """csrc/common.cuh cell_compute on vectors: predecessors as read,
    p2 = (M, D, I) of (i-1, j-1), pk = (M, D, I) of (i-k, j), ps = (M, I) of
    (i, j-k); those off the matrix take LOWEST."""
    ng, gs, go, ge = (gc[q] for q in range(4))
    gek1, gek, ngo = ge * float(k - 1), ge * float(k), ng + go
    diag, up, left = (i >= 1) & (j >= 1), i >= k, j >= k
    low = torch.full(i.shape, tw.LOWEST)
    p2M, p2D, p2I = (torch.where(diag, v, low) for v in p2)
    pkM, pkD, pkI = (torch.where(up, v, low) for v in pk)
    pkMs, pkIs = (torch.where(left, v, low) for v in ps)
    m2m0, d2m0, i2m0 = (p2M + ng) + ng, p2D + gs, (p2I + gs) + ng
    m2d0, i2d0, m2i0 = (pkM + ng) + go, (pkI + gs) + go, pkMs + go
    M = torch.maximum(torch.maximum(m2m0 + sub, d2m0 + sub), i2m0 + sub)
    D = torch.maximum(torch.maximum(m2d0 + gek1, pkD + gek), i2d0 + gek1)
    I = torch.maximum(m2i0 + gek1, pkIs + gek)
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


class Pair:
    """What the workers of one pair share: its sequences and lengths, the
    warp boundary rings and counters of each block, the edge buffers and
    counters of the block boundaries, and the outputs."""

    def __init__(self, a, b, la, lb, k, launch, NA, bp, corners, p, table, gc,
                 band=None):
        self.a, self.b, self.k, self.launch = a, b, k, launch
        self.rows, self.cols, self.lb = int(la) + k, int(lb) + k, int(lb)
        self.bp, self.corners, self.p = bp, corners, p  # bp None: score-only
        self.table, self.gc = table.reshape(-1), gc
        # the long path: band = (row0, band_rows, ckpt). Pass 1 (bp None):
        # row0 0, ckpt [n_ckpt, B, k, 3, Cp] written; pass 2: the band's
        # rows, ckpt [B, k, 3, Cp] read (None at row 0)
        self.row0, self.band_rows, self.ckpt = band if band else (0, None, None)
        self.in_band = band is not None and bp is not None
        self.nrows = (min(self.rows, self.row0 + self.band_rows) - self.row0
                      if self.in_band else self.rows)
        E = 2 * k + 1
        U = launch.warps * launch.blocks
        self.ring = [torch.full((RING_ROWS, E), NAN) for _ in range(U)]
        self.sprog = [0] * U  # rows a warp has put in its ring (running count)
        self.scons = [0] * U  # rows a warp has taken from its left ring
        edge_rows = self.band_rows if self.in_band else NA + k
        self.edge = [torch.full((edge_rows, E), NAN) for _ in range(launch.blocks)]
        self.gprog = [0] * launch.blocks  # released rows of a block's edge
        self.nstripes = fill_mod.stripes(self.cols, launch.W)


class Worker:
    """One warp of one pair: block blk, warp w of the block. step() runs one
    step of the row loop, or returns False where the kernel would wait."""

    def __init__(self, pr: Pair, blk: int, w: int):
        self.pr, self.blk, self.w = pr, blk, w
        L = pr.launch
        self.u = blk * L.warps + w
        self.U = L.warps * L.blocks
        self.s, self.ps = self.u, 0
        self.done = self.s >= pr.nstripes or pr.nrows <= 0
        if not self.done:
            self._start_stripe()

    def _start_stripe(self):
        pr, k, W = self.pr, self.pr.k, self.pr.launch.W
        self.t = 0
        self.n_steps = -(-(pr.nrows + 31) // k) * k
        self.j_base = self.s * 32 * W + torch.arange(32) * W  # [lanes]
        j = self.j_base[:, None] + torch.arange(W)[None, :]
        jb = j - k
        ok = (jb >= 0) & (jb < pr.lb)
        self.bc = torch.where(ok, pr.b[jb.clamp(0, max(pr.b.shape[0] - 1, 0))], 15)
        self.reg = torch.full((k, 3, 32, W), NAN)  # slot, state, lane, column
        self.l = torch.full((3, 32, k), NAN)  # left edge: M, I [lanes, k]; D at [2, :, 0]
        self.e = torch.full((3, 32, k), NAN)  # own edge of the last row
        if pr.in_band and pr.row0 > 0:
            self._seed()

    def _seed(self):
        """Pass 2's start of a stripe: the kernel's reads of the band's
        checkpoint [k, 3, Cp] of the pair, columns outside [0, Cp) LOWEST."""
        pr, k, W = self.pr, self.pr.k, self.pr.launch.W
        ck = pr.ckpt[pr.p]
        Cp = ck.shape[2]

        def at(q, st, j):
            ok = (j >= 0) & (j < Cp)
            return torch.where(ok, ck[q, st, j.clamp(0, Cp - 1)], tw.LOWEST)

        lanes = torch.arange(32)
        for sl in range(k):  # row r0 - k + q in slot (lane + q) % k
            q = (sl - lanes) % k
            for c in range(W):
                for st in range(3):
                    self.reg[sl, st, :, c] = at(q, st, self.j_base + c)
        for q in range(k):
            self.l[0, :, q] = at(k - 1, 0, self.j_base - k + q)
            self.l[1, :, q] = at(k - 1, 2, self.j_base - k + q)
            self.e[0, :, q] = at(k - 1, 0, self.j_base + W - k + q)
            self.e[1, :, q] = at(k - 1, 2, self.j_base + W - k + q)
        self.l[2, :, 0] = at(k - 1, 1, self.j_base - 1)
        self.e[2, :, 0] = at(k - 1, 1, self.j_base + W - 1)

    # the kernel's waits, checked before the step (they do not depend on it)
    def _left(self):
        """(published rows of the left stripe's edge, their running base)."""
        pr, L = self.pr, self.pr.launch
        if self.w > 0:
            return pr.sprog[self.u - 1], self.ps * pr.nrows
        src_blk = self.blk - 1 if self.blk > 0 else L.blocks - 1
        src_base = (self.ps if self.blk > 0 else self.ps - 1) * pr.nrows
        return pr.gprog[src_blk], src_base

    def _ready(self):
        pr, L, t = self.pr, self.pr.launch, self.t
        base = self.ps * pr.nrows
        if self.s > 0 and t % BATCH == 0 and t < pr.nrows:
            need = min(t + AHEAD, pr.nrows) if t + BATCH < pr.nrows else 0
            if t == 0:
                need = max(need, min(BATCH, pr.nrows))
            published, src_base = self._left()
            if published < src_base + need:
                return False
        i31 = t - 31
        to_ring = self.s + 1 < pr.nstripes and self.w + 1 < L.warps
        if to_ring and 0 <= i31 < pr.nrows:  # lane 31 writes slot (base + i) % R
            if pr.scons[self.u + 1] < base + i31 - RING_ROWS + 1:
                return False
        return True

    def _load_batch(self, r0):
        """Rows r0 .. r0 + BATCH - 1 of the left stripe's edge, as read now."""
        pr, L = self.pr, self.pr.launch
        out = torch.full((BATCH, 2 * pr.k + 1), NAN)
        base = self.ps * pr.nrows
        for q in range(BATCH):
            row = r0 + q
            if row >= pr.nrows:
                continue
            if self.w > 0:
                out[q] = pr.ring[self.u - 1][(base + row) % RING_ROWS]
            else:
                src_blk = self.blk - 1 if self.blk > 0 else L.blocks - 1
                out[q] = pr.edge[src_blk][row]
        return out

    def step(self):
        if self.done:
            return False
        if not self._ready():
            return False
        pr, L, k, W, t = self.pr, self.pr.launch, self.pr.k, self.pr.launch.W, self.t
        r = t % k
        lanes = torch.arange(32)
        i = t - lanes  # relative to the band's first row
        live = (i >= 0) & (i < pr.nrows)
        base = self.ps * pr.nrows
        pM, pI, pD = self.l[0, :, k - 1].clone(), self.l[1, :, k - 1].clone(), self.l[2, :, 0].clone()
        # __shfl_up_sync: lane l takes lane l - 1's; lane 0 keeps its own
        self.l = torch.cat([self.e[:, :1], self.e[:, :-1]], dim=1).clone()
        if self.s > 0 and t % BATCH == 0 and t < pr.nrows:
            if t == 0:
                self.nxt = self._load_batch(0)
            self.cur = self.nxt
            if self.w > 0:
                pr.scons[self.u] = base + min(t + BATCH, pr.nrows)
            if t + BATCH < pr.nrows:
                self.nxt = self._load_batch(t + BATCH)
        if self.s > 0:
            row = self.cur[t % BATCH]
            self.l[0, 0], self.l[1, 0], self.l[2, 0, 0] = row[:k], row[k:2 * k], row[2 * k]
        if bool(live.any()):
            self._row(i, live, r, pM, pD, pI)
        # lane 31 hands its row on
        i31 = t - 31
        if 0 <= i31 < pr.nrows and self.s + 1 < pr.nstripes:
            entry = torch.cat([self.e[0, 31], self.e[1, 31], self.e[2, 31, :1]])
            if self.w + 1 < L.warps:
                gi = base + i31
                pr.ring[self.u][gi % RING_ROWS] = entry
                if (i31 + 1) % BATCH == 0 or i31 == pr.nrows - 1:
                    pr.sprog[self.u] = gi + 1
            else:
                pr.edge[self.blk][i31] = entry
                if (i31 + 1) % BATCH == 0 or i31 == pr.nrows - 1:
                    pr.gprog[self.blk] = base + i31 + 1
        self.t += 1
        if self.t == self.n_steps:
            self.s += self.U
            self.ps += 1
            self.done = self.s >= pr.nstripes
            if not self.done:
                self._start_stripe()
        return True

    def _row(self, ir, live, r, pM, pD, pI):
        pr, k, W = self.pr, self.pr.k, self.pr.launch.W
        reg = self.reg
        i = pr.row0 + ir  # the cells' rows are absolute
        a_idx = (i - k).clamp(0, max(pr.a.shape[0] - 1, 0))
        arow = torch.where(i >= k, pr.a[a_idx] * 15, 0)
        corner = (i == pr.rows - 1) & (not pr.in_band)
        o = (pM, pD, pI)
        for c in range(W):
            j = self.j_base + c
            if c == 0:
                d = (pM, pD, pI)
            elif k == 1:
                d = o
            else:
                d = tuple(reg[(r - 1) % k, q, :, c - 1] for q in range(3))
            kk = tuple(reg[r, q, :, c].clone() for q in range(3))
            if c >= k:
                sp = (reg[r, 0, :, c - k], reg[r, 2, :, c - k])
            else:
                sp = (self.l[0, :, c], self.l[1, :, c])
            code = self.bc[:, c]
            emit = (i >= k) & (j >= k) & (code < 15)
            sub = torch.where(emit, pr.table[(arow + code.clamp(max=14)).clamp(0)], 0.0)
            M, D, I, bp = cell_compute(i, j, k, d, kk, sp, sub, pr.gc)
            if k == 1:
                o = kk
            for q, v in enumerate((M, D, I)):
                reg[r, q, :, c] = torch.where(live, v, reg[r, q, :, c])
            if pr.bp is not None:
                store = live & (self.j_base < pr.cols)
                pr.bp[pr.p, ir[store], j[store]] = bp[store]
            hit = live & corner & (j == pr.cols - 1)
            if bool(hit.any()):
                lane = int(torch.nonzero(hit)[0])
                ng, gs = pr.gc[0], pr.gc[1]
                pr.corners[:, pr.p] = torch.stack(
                    ((M[lane] + ng) + ng, D[lane] + gs, (I[lane] + gs) + ng))
        if pr.ckpt is not None and not pr.in_band:  # pass 1's stores
            H = pr.band_rows
            for lane in torch.nonzero(live & ((i + k) % H < k) & ((i + k) // H <= pr.ckpt.shape[0])):
                lane = int(lane)
                b, q = divmod(int(i[lane]) + k, H)  # band b >= 1, at b - 1
                Cp = pr.ckpt.shape[4]
                for c in range(W):
                    j = int(self.j_base[lane]) + c
                    if j < Cp:
                        pr.ckpt[b - 1, pr.p, q, :, j] = reg[r, :, lane, c]
        for q in range(k):
            self.e[0, :, q] = torch.where(live, reg[r, 0, :, W - k + q], self.e[0, :, q])
            self.e[1, :, q] = torch.where(live, reg[r, 2, :, W - k + q], self.e[1, :, q])
        self.e[2, :, 0] = torch.where(live, reg[r, 1, :, W - 1], self.e[2, :, 0])


def strip_fill(aseq, bseq, la, lb, table, gc, *, k, launch, want_bp=True,
               band=None):
    """The strip kernel's fill of every pair: (corners [3, B] adjusted, bp
    [B, NA + k, Cp] in row layout); bytes no strip writes stay 0. want_bp
    False: the score-only body, bp None. band: the long path's passes, as
    Pair takes it (ckpt_fill and band_fill)."""
    B, NA = aseq.shape
    C = bseq.shape[1] + k
    bp = None
    if want_bp:
        rows = band[1] if band else NA + k
        bp = torch.zeros((B, rows, fill_mod.row_stride(C)), dtype=torch.uint8)
    corners = torch.full((3, B), NAN)
    rng = np.random.default_rng(B * 1000 + C + (band[0] if band else 0))
    for p in range(B):
        pr = Pair(aseq[p], bseq[p], la[p], lb[p], k, launch, NA, bp, corners,
                  p, table, gc, band)
        workers = [Worker(pr, blk, w) for blk in range(launch.blocks)
                   for w in range(launch.warps)]
        while not all(wk.done for wk in workers):
            moved = False
            for q in rng.permutation(len(workers)):
                for _ in range(int(rng.integers(1, 201))):
                    if not workers[q].step():
                        break
                    moved = True
            assert moved, f"pair {p}: no worker can move"
    return corners, bp


# (k, lengths of the ancestors, of the descendants, W, warps, pairs, blocks, G)
CASES = [
    # narrower than one strip, than one warp; one warp a pair
    (1, (9, 30), (3, 40), 16, 1, 1, 1, 1),
    # several warps in one pass, ragged, a stacked table
    (1, (45, 60, 90), (150, 97, 260), 4, 3, 1, 1, 3),
    # stripe passes through the edge buffer, two pairs a block
    (1, (81, 69), (300, 210), 4, 2, 2, 1, 1),
    # several blocks a pair, with passes
    (1, (75,), (400,), 4, 1, 1, 2, 1),
    # k = 3 and k = 5: the row slots; passes at k = 3, strips of 8 at k = 5
    (3, (99, 72), (150, 201), 4, 2, 1, 1, 2),
    (3, (63, 90), (260, 120), 4, 1, 1, 1, 1),
    (5, (75, 45), (200, 135), 8, 1, 1, 2, 1),
]


@pytest.mark.parametrize("k,la,lb,W,warps,pairs,blocks,G", CASES)
def test_strip_fill_equals_plain_and_xla(mg94_table, k, la, lb, W, warps,
                                         pairs, blocks, G):
    aseq, bseq, la, lb = _group(10 * k + W + warps, k, la, lb, G=G)
    table = _tables(mg94_table, G)
    gc = gap_consts_array(GapParams(len=k))
    args = _torch(aseq, bseq, la, lb, table, gc)
    B, NA = aseq.shape
    C = bseq.shape[1] + k
    launch = fill_mod.fill_launch(B, C, k, W, warps, pairs, blocks,
                                  table_len=table.size)
    corners, bp = strip_fill(*args, k=k, launch=launch)
    want_c, want_bp = fill_mod.fill_rows_plain(*args, k=k)
    mask = fill_mod.true_cells(torch.as_tensor(la), torch.as_tensor(lb), k,
                               NA + k, bp.shape[2])
    assert torch.equal(bp[mask], want_bp[mask])
    assert torch.equal(corners, torch.stack(want_c))
    # and the JAX reference, XLA:CPU
    (cm, cd, ci), bp_x = wavefront(*[jnp.asarray(x) for x in (aseq, bseq, la, lb, table, gc)],
                                   k=k, semiring="tropical", mode="viterbi")
    rows_x = fill_mod.rows_from_diagonals(
        torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(bp_x), (1, 0, 2)))), NA, k)
    assert torch.equal(bp[mask], rows_x[mask])
    assert torch.equal(corners, torch.from_numpy(np.stack([np.asarray(x) for x in (cm, cd, ci)])))


def test_the_emulation_covers_its_shapes():
    """The cases reach what they claim: a pair narrower than one strip and
    than one warp, passes, several blocks a pair."""
    launches = [fill_mod.fill_launch(len(la), max(lb) + k, k, W, warps, pairs, blocks)
                for k, la, lb, W, warps, pairs, blocks, _ in CASES]
    k0, _, lb0, W0 = CASES[0][:4]
    assert min(lb0) + k0 < W0
    assert any(l.passes > 1 and l.blocks == 1 for l in launches)
    assert any(l.passes > 1 and l.blocks > 1 for l in launches)
    assert any(l.pairs > 1 for l in launches)
    assert any(fill_mod.stripes(l.C, l.W) < 2 and l.C < 32 * l.W for l in launches)


def ckpt_fill(aseq, bseq, la, lb, table, gc, *, k, launch, band_rows, n_ckpt):
    """The long path's pass 1 as the kernel runs it: (corners [3, B],
    ckpt [n_ckpt, B, k, 3, Cp], NaN where no lane stored)."""
    B, C = aseq.shape[0], bseq.shape[1] + k
    ckpt = torch.full((n_ckpt, B, k, 3, fill_mod.row_stride(C)), NAN)
    corners, _ = strip_fill(aseq, bseq, la, lb, table, gc, k=k, launch=launch,
                            want_bp=False, band=(0, band_rows, ckpt))
    return corners, ckpt


def band_fill(aseq, bseq, la, lb, table, gc, ckpt, *, k, launch, row0, band_rows):
    """The long path's pass 2 over one band as the kernel runs it: bp [B,
    band_rows, Cp], 0 where no strip stored."""
    return strip_fill(aseq, bseq, la, lb, table, gc, k=k, launch=launch,
                      band=(row0, band_rows, ckpt))[1]


# (k, lengths of the ancestors, of the descendants, W, warps, pairs, blocks,
# band rows): bands of k, 2k and 7k rows, a last band that is not full,
# several blocks a pair, stripe passes, two pairs a block
LONG_CASES = [
    (1, (12, 15), (150, 97), 4, 2, 1, 2, 1),
    (1, (45,), (300,), 4, 1, 1, 2, 7),
    (1, (15, 21), (60, 90), 16, 1, 2, 1, 2),
    (3, (36, 27), (99, 150), 4, 2, 1, 1, 6),
    (3, (45,), (120,), 4, 1, 1, 2, 21),
    (8, (48, 24), (64, 40), 8, 1, 1, 1, 8),
    (8, (48,), (296,), 8, 1, 1, 2, 16),
]


@pytest.mark.parametrize("k,la,lb,W,warps,pairs,blocks,H", LONG_CASES)
def test_long_passes_equal_plain_and_xla(mg94_table, k, la, lb, W, warps, pairs,
                                         blocks, H):
    """Pass 1's checkpoint equals ckpt_plain's on every entry the kernel
    defines and its corners XLA:CPU's; pass 2, band by band from that
    checkpoint, gives every true cell's byte of the whole stack of
    band_fill_plain and of XLA:CPU."""
    aseq, bseq, la, lb = _group(20 * k + H + W, k, la, lb)
    gc = gap_consts_array(GapParams(len=k))
    args = _torch(aseq, bseq, la, lb, mg94_table, gc)
    B, NA = aseq.shape
    C = bseq.shape[1] + k
    Cp = fill_mod.row_stride(C)
    R = NA + k
    n_bands = -(-R // H)
    assert n_bands >= 2
    score_launch = fill_mod.fill_launch(B, C, k, W, warps, pairs, blocks,
                                        widths=fill_mod.SCORE_WIDTHS)
    fill_launch = fill_mod.fill_launch(B, C, k, W, warps, pairs, blocks)
    corners, ckpt = ckpt_fill(*args, k=k, launch=score_launch, band_rows=H,
                              n_ckpt=n_bands - 1)
    want_c, want_ck = score_mod.ckpt_plain(*args, k=k, band_rows=H,
                                           n_ckpt=n_bands - 1)
    defined = score_mod.ckpt_cells(args[2], args[3], k, H, n_bands - 1, Cp)
    assert bool(defined.any(dim=(1, 2, 3, 4)).all())  # no slot left unwritten
    assert torch.equal(ckpt[defined], want_ck[defined])
    assert torch.equal(corners, want_c)
    (cm, cd, ci), bp_x = wavefront(*[jnp.asarray(x) for x in (aseq, bseq, la, lb, mg94_table, gc)],
                                   k=k, semiring="tropical", mode="viterbi")
    assert torch.equal(corners, torch.from_numpy(np.stack([np.asarray(x) for x in (cm, cd, ci)])))

    stack = torch.zeros((B, n_bands * H, Cp), dtype=torch.uint8)
    want = torch.zeros_like(stack)
    for b in range(n_bands):
        ck = ckpt[b - 1] if b else None
        stack[:, b * H:(b + 1) * H] = band_fill(*args, ck, k=k, launch=fill_launch,
                                                row0=b * H, band_rows=H)
        want[:, b * H:(b + 1) * H] = fill_mod.wavefront_fill_band(
            *args, want_ck[b - 1] if b else None, k=k, row0=b * H, band_rows=H)
    mask = fill_mod.true_cells(args[2], args[3], k, R, Cp)
    rows_x = fill_mod.rows_from_diagonals(
        torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(bp_x), (1, 0, 2)))), NA, k)
    assert torch.equal(stack[:, :R][mask], rows_x[mask])
    assert torch.equal(want[:, :R][mask], rows_x[mask])


def test_the_long_emulation_covers_its_shapes():
    """The long cases reach what they claim: k = 1, 3 and 8, bands of k, 2k
    and 7k rows, a last band that is not full, several blocks a pair,
    passes, two pairs a block."""
    ks, heights, partial = set(), set(), False
    launches = []
    for k, la, lb, W, warps, pairs, blocks, H in LONG_CASES:
        ks.add(k)
        heights.add(H // k)
        partial |= (max(la) + k) % H != 0
        launches.append(fill_mod.fill_launch(len(la), max(lb) + k, k, W, warps,
                                             pairs, blocks))
    assert ks == {1, 3, 8} and {1, 2, 7} <= heights and partial
    assert any(l.blocks > 1 for l in launches)
    assert any(l.passes > 1 for l in launches)
    assert any(l.pairs > 1 for l in launches)


def window_walk(bp, corners, la, lb, *, k, max_steps, S):
    """The walk kernel's traversal: windows of H = 2kS rows and columns,
    the next anchored at the walk's position after each round of S steps and
    read a round later. Reading a cell its window does not hold raises."""
    cM, cD, cI = corners
    B, _, Cp = bp.shape
    H = 2 * k * S
    ops = torch.full((max_steps, B), -1, dtype=torch.int8)
    for p in range(B):
        st = int(tw.argmax_mdi(cM[p:p + 1], cD[p:p + 1], cI[p:p + 1])[0])
        i, j, s = int(la[p]) + k - 1, int(lb[p]) + k - 1, 0

        def fetch(ia, ja):
            r0, c0 = max(ia - H, 0), max(ja - H, 0) & ~15
            c1 = (ja & ~15) + 16
            win = torch.full(bp.shape[1:], -1, dtype=torch.int16)
            win[r0:ia + 1, c0:c1] = bp[p, r0:ia + 1, c0:c1].to(torch.int16)
            return win

        def going():
            return s < max_steps and (i > k - 1 or j > k - 1) and i >= 0 and j >= 0

        cur = fetch(i, j) if going() else None
        rnd = 0
        while going():
            nxt = fetch(i, j) if rnd > 0 else cur
            for _ in range(S):
                if not going():
                    break
                code = int(cur[i, j])
                assert code >= 0, f"pair {p}: ({i}, {j}) outside its window"
                ops[s, p] = st
                i, j = (i - 1, j - 1) if st == 0 else (i - k, j) if st == 1 else (i, j - k)
                st = (code >> (2 * st)) & 3
                s += 1
            cur = nxt
            rnd += 1
    return ops, torch.maximum(cM, torch.maximum(cD, cI))


@pytest.mark.parametrize("k,S", [(1, 1), (1, 2), (1, 3), (1, 5), (1, 8), (3, 2),
                                 (3, 3), (5, 1), (5, 4)])
def test_window_walk_equals_plain_walk(mg94_table, k, S):
    """Windows cross the walk at every step offset (S from 1 to 8, walks of
    hundreds of steps); op for op and score equal to traceback_plain on the
    diagonal stack, and to traceback_rows_plain on the row stack."""
    aseq, bseq, la, lb = _group(50 + 7 * k + S, k, (66 * k, 33 * k, 9 * k),
                                (60 * k, 41 * k, 5 * k))
    gc = gap_consts_array(GapParams(len=k))
    args = _torch(aseq, bseq, la, lb, mg94_table, gc)
    corners, bp_d = tw.wavefront_plain(*args, k=k)
    bp_r = fill_mod.rows_from_diagonals(bp_d, aseq.shape[1], k)
    steps = int((la + lb).max())
    want_ops, want_score = tw.traceback_plain(bp_d, corners, args[2], args[3],
                                              k=k, max_steps=steps)
    ops, score = window_walk(bp_r, corners, la, lb, k=k, max_steps=steps, S=S)
    assert torch.equal(ops, want_ops) and torch.equal(score, want_score)
    rows_ops, rows_score = tw.traceback_rows_plain(bp_r, corners, args[2],
                                                   args[3], k=k, max_steps=steps)
    assert torch.equal(rows_ops, want_ops) and torch.equal(rows_score, want_score)


def window_walk_band(bp_band, row0, state, ops, *, k, S, start=None):
    """The band walk kernel's traversal (traceback_walk_kernel<true>): the
    whole-stack walk's windows over one band of rows [row0, row0 + H),
    clipped at the band's first row; a pair walks while its row is in the
    band, from its corner on the first launch (start), else from state.
    Reading a cell its window does not hold raises. Returns the score with
    start, else None."""
    B, Hb, Cp = bp_band.shape
    Hw = 2 * k * S
    score = None
    if start is not None:
        adj, la, lb = start
        score = torch.maximum(adj[0], torch.maximum(adj[1], adj[2]))
    for p in range(B):
        if start is not None:
            st = int(tw.argmax_mdi(adj[0][p:p + 1], adj[1][p:p + 1], adj[2][p:p + 1])[0])
            i, j, s = int(la[p]) + k - 1, int(lb[p]) + k - 1, 0
        else:
            i, j, st, s = (int(state[q, p]) for q in range(4))

        def fetch(ia, ja):
            r0, c0 = max(ia - row0 - Hw, 0), max(ja - Hw, 0) & ~15
            c1 = (ja & ~15) + 16
            win = torch.full((Hb, Cp), -1, dtype=torch.int16)
            win[r0:ia - row0 + 1, c0:c1] = bp_band[p, r0:ia - row0 + 1, c0:c1].to(torch.int16)
            return win

        def going():
            return (s < ops.shape[0] and (i > k - 1 or j > k - 1) and j >= 0
                    and row0 <= i < row0 + Hb)

        cur = fetch(i, j) if going() else None
        rnd = 0
        while going():
            nxt = fetch(i, j) if rnd > 0 else cur
            for _ in range(S):
                if not going():
                    break
                code = int(cur[i - row0, j])
                assert code >= 0, f"pair {p}: ({i}, {j}) outside its window"
                ops[s, p] = st
                i, j = (i - 1, j - 1) if st == 0 else (i - k, j) if st == 1 else (i, j - k)
                st = (code >> (2 * st)) & 3
                s += 1
            cur = nxt
            rnd += 1
        state[:, p] = torch.tensor([i, j, st, s], dtype=torch.int32)
    return score


@pytest.mark.parametrize("k,S,H", [(1, 1, 1), (1, 3, 7), (1, 8, 10), (3, 2, 3),
                                   (3, 5, 21), (8, 1, 16), (8, 4, 8)])
def test_band_walk_equals_plain_and_the_whole_stack_walk(mg94_table, k, S, H):
    """The whole stack cut into bands of H rows and walked last to first:
    the band walk's windows (S steps a round) and walk_band (its plain
    version on the CPU) give, band after band, the same state and ops, and
    at the end the ops and score of traceback_rows_plain over the whole
    stack, op for op."""
    aseq, bseq, la, lb = _group(60 + 7 * k + S, k, (22 * k, 11 * k, 3 * k),
                                (20 * k, 14 * k, 2 * k))
    gc = gap_consts_array(GapParams(len=k))
    args = _torch(aseq, bseq, la, lb, mg94_table, gc)
    corners, bp_r = fill_mod.fill_rows_plain(*args, k=k)
    adj = torch.stack(corners)
    B, R, Cp = bp_r.shape
    steps = int((la + lb).max())
    want_ops, want_score = tw.traceback_rows_plain(bp_r, corners, args[2], args[3],
                                                   k=k, max_steps=steps)
    n_bands = -(-R // H)
    assert n_bands >= 2
    stack = torch.zeros((B, n_bands * H, Cp), dtype=torch.uint8)
    stack[:, :R] = bp_r
    state_e, state_p = torch.full((4, B), 7, dtype=torch.int32), torch.empty((4, B), dtype=torch.int32)
    ops_e = torch.full((steps, B), -1, dtype=torch.int8)
    ops_p = ops_e.clone()
    top = n_bands - 1
    for b in range(top, -1, -1):
        band = stack[:, b * H:(b + 1) * H].contiguous()
        start = (adj, args[2], args[3]) if b == top else None
        score_e = window_walk_band(band, b * H, state_e, ops_e, k=k, S=S, start=start)
        _, _, score_p = walk_mod.walk_band(band, b * H, state_p, ops_p, k=k, start=start)
        assert torch.equal(state_e, state_p) and torch.equal(ops_e, ops_p)
        if b == top:
            assert torch.equal(score_e, want_score) and torch.equal(score_p, want_score)
    assert torch.equal(ops_p, want_ops)
    assert state_p[0].tolist() == [k - 1] * B and state_p[1].tolist() == [k - 1] * B


@pytest.mark.parametrize("k", [1, 3, 5])
def test_row_layout_fill_and_walk_equal_the_diagonal_ones(mg94_table, k):
    """The wrappers on the CPU (row layout) give the corners and ops of
    wavefront_plain + traceback_plain (diagonal layout) on the same pairs,
    and the stack is that stack, cell for cell."""
    aseq, bseq, la, lb = _group(70 + k, k, (30 * k, 45 * k, 12 * k),
                                (40 * k, 21 * k, 50 * k))
    gc = gap_consts_array(GapParams(len=k))
    args = _torch(aseq, bseq, la, lb, mg94_table, gc)
    corners, bp_r = fill_mod.wavefront_fill(*args, k=k)
    want_c, bp_d = tw.wavefront_plain(*args, k=k)
    assert all(torch.equal(x, y) for x, y in zip(corners, want_c))
    R, Cp = bp_r.shape[1:]
    assert Cp % 16 == 0 and R == aseq.shape[1] + k
    i = torch.arange(R)[:, None]
    j = torch.arange(bp_d.shape[2])[None, :]
    assert torch.equal(bp_r[:, :, : bp_d.shape[2]], bp_d[:, i + j, j])
    steps = int((la + lb).max())
    ops, score = walk_mod.traceback_walk(bp_r, corners, args[2], args[3], k=k,
                                         max_steps=steps)
    want_ops, want_score = tw.traceback_plain(bp_d, want_c, args[2], args[3],
                                              k=k, max_steps=steps)
    assert torch.equal(ops, want_ops) and torch.equal(score, want_score)


def test_a_gap_length_above_the_kernels_takes_the_sweep(mg94_table):
    """k > MAX_K: fused_align_ops runs the sweep over every diagonal and the
    segment walk, with the ops and scores of the plain fill and walk."""
    k = fill_mod.MAX_K + 1
    aseq, bseq, la, lb = _group(90, k, (3 * k, 6 * k), (4 * k, 2 * k))
    gc = gap_consts_array(GapParams(len=k))
    args = _torch(aseq, bseq, la, lb, mg94_table, gc)
    steps = int((la + lb).max())
    ops, score = engine.fused_align_ops(*args, k=k, max_steps=steps)
    corners, bp = tw.wavefront_plain(*args, k=k)
    want_ops, want_score = tw.traceback_plain(bp, corners, args[2], args[3],
                                              k=k, max_steps=steps)
    assert torch.equal(ops, want_ops) and torch.equal(score, want_score)


@pytest.mark.parametrize("B,C,k,sms", [(64, 1057, 1, 132), (1, 16_001, 1, 132),
                                       (2, 16_001, 1, 132), (1, 8_001, 3, 132),
                                       (454, 1597, 1, 132), (3, 500, 8, 132)])
def test_fill_shape_keeps_no_large_pair_on_one_block(B, C, k, sms):
    """fill_shape's launches are ones the kernel takes; above
    MULTI_BLOCK_SLOTS a pair spreads over several blocks while the card has
    SMs for them, and no launch is a single block of 256 threads for it."""
    launch = fill_mod.fill_shape(B, C, k, sms=sms)
    assert launch.threads <= fill_mod.max_threads(k, launch.W)
    assert launch.W in fill_mod.STRIP_WIDTHS[k]
    if launch.blocks > 1:
        assert B * launch.blocks <= sms and launch.pairs == 1
    if C > fill_mod.MULTI_BLOCK_SLOTS and B * 2 <= sms:
        assert launch.blocks > 1
    assert launch.passes * launch.warps * launch.blocks >= fill_mod.stripes(C, launch.W)
