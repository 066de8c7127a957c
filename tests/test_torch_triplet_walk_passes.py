"""The triplet walk kernel (csrc/triplet_walk.cu), emulated in plain torch on
the CPU.

WalkEmu below follows the kernel a pair at a time. A codon block binds its
lane, then recomputes its rows over columns 0..j in passes of R x T columns
(walk_launch): each thread holds R adjacent columns; a row's prefix maximum
of M - off is a serial maximum over the thread's columns, then an exclusive
scan of the thread totals inside each warp and across the warps, carried
from pass to pass; the column left of a warp's first comes from the warp
before (its M, D, and the I rebuilt from its partial maximum P and off +
(go - ge), as the kernel hands them over), the column left of a pass's first
from the pass before. Run-exit indices are the last flagged column inside a
warp, then the maximum of the warps before and of the passes before (the
kernel takes a pass's last exit row through the next pass's first barrier;
the values are the same). The third row is computed only when the block is
entered in state I. Each owner keeps what the walk reads, a down-step code
(the next state from M and from D) of row 2, row 1 and the boundary, and the
three rows' exit indices, in a window of Wc columns up to j, and left of the
window in the scratch. Warp 0 keeps the next block's lanes at the 64 columns
up to j. The first pass of a block is loaded a block ahead, up to the j of
the block before.

The band route (bands > 1): band q, one block of the pair's cluster, holds
the pass [q RT, (q + 1) RT). The bands run each part in random order; after
each row's scan they exchange their totals and their last column through
slots (NaN until written); the last exit row stays block-level in the
windows, and the walker, the block whose band holds j, adds the bands before
to what it reads of it, and reads other bands' windows after a run that
leaves its own.

Every slot of the windows, the scratch, the exchange slots and the lane
window holds NaN until this block writes it, and the walk raises on reading
one. State and op rows must be bit-equal to triplet_walk_plain, which
tests/test_torch_triplet.py holds to the JAX package's _triplet_walk_seg_xla
(XLA:CPU) and to triplet_walk_pallas (interpreted); one case is held to the
XLA walk here.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coati_tpu.constants import CODONS61
from coati_tpu import triplet_wavefront as jax_tw
from coati_tpu_torch import triplet_wavefront as tw
from coati_tpu_torch.kernels import triplet_rows as rows_k
from coati_tpu_torch.kernels import triplet_walk as walk_k
from test_torch_triplet import Packed, models, ragged_pairs
from test_torch_triplet_bands import _batch

F32 = torch.float32
NEG = torch.tensor(rows_k.NEG, dtype=F32)
NINF = torch.tensor(-torch.inf, dtype=F32)
NAN = float("nan")
LANE_WINDOW = walk_k.LANE_WINDOW


class UnwrittenRead(AssertionError):
    pass


def _f(x):
    return torch.as_tensor(x, dtype=F32)


def _max(a, b):
    return torch.maximum(_f(a), _f(b))


class Gap:
    def __init__(self, gc):
        self.gs, self.go, self.ge = gc[1], gc[2], gc[3]
        (self.ng_ng, self.gs_ng, self.ng_go, self.gs_go,
         self.go_ge) = rows_k.gap_composites(gc)

    def shiftmax3(self, c, sM, sD, sI):
        core = _max(_max(sM + self.ng_ng, sD + self.gs), sI + self.gs_ng)
        return torch.where(c >= 1, core, NEG)

    def dmax3(self, M, D, I):
        return _max(_max(M + self.ng_go, D + self.ge), I + self.gs_go)

    def ins(self, c, excl, off):
        return torch.where(c >= 1, excl + (off + self.go_ge), NEG)

    def code(self, M, D, I):
        """The down-step code: next state from M | from D << 2."""
        M, D, I = _max(M, NEG), _max(D, NEG), _max(I, NEG)
        return (_amax_pref(M + self.ng_ng, D + self.gs, I + self.gs_ng)
                | _amax_pref(M + self.ng_go, D + self.ge, I + self.gs_go) << 2)

    def exits(self, M, I):
        return (M + self.go) > (I + self.ge)


def _amax_pref(a, b, c):
    return torch.where(c > _max(a, b), 2, (b > a).long())


def _excl_scan(tot, run, nwarps):
    """The kernel's block scan of thread totals [T]: (the exclusive maximum
    of each thread, the new run, and of each warp the maximum of run and the
    warps before it and the warp-exclusive maximum at its lane 31)."""
    wt = tot.view(nwarps, 32)
    winc = torch.cummax(wt, dim=1).values
    wex = torch.cat([NINF.expand(nwarps, 1), winc[:, :-1]], dim=1)
    inc_w = torch.cummax(winc[:, -1], dim=0).values
    base = _max(run, torch.cat([NINF[None], inc_w[:-1]]))  # run and the warps before
    excl = _max(base[:, None], wex).reshape(-1)
    return excl, _max(run, inc_w[-1]), base, wex[:, 31]


class Cols:
    """A pass's columns [c0, c0 + RT) as loaded by their threads: the
    boundary up to jmax (NEG beyond), off (0 beyond), the descendant code
    left of each column (-1 at column 0 and beyond), and the boundary one
    column left of each."""

    def __init__(self, emu, b, t, c0, jmax):
        n = emu.RT
        c = torch.arange(c0, c0 + n)
        self.c = c
        ok = c <= jmax
        bnd = emu.grid[t, :, b]  # [3, Cc]
        cc = c.clamp(max=emu.Cc - 1)
        self.MDI = torch.where(ok[None], bnd[:, cc], NEG)
        left = (c >= 1) & (c - 1 <= jmax)
        self.left = torch.where(left[None], bnd[:, (c - 1).clamp(0, emu.Cc - 1)], NEG)
        self.off = torch.where(ok, emu.ins_off[b, cc], _f(0.0))
        self.d = torch.where(ok & (c >= 1), emu.des[b, (c - 1).clamp(0, emu.m - 1)].long(), -1)


class WalkEmu:
    """A launch of the walk at `launch` over grid_seg / amax_seg from t_lo;
    `mutate`: "no scratch" (columns left of the window are not kept),
    "lane window unchecked" (the next lane always read from the lane
    window). Records what the walk's reads went to in `self.seen`."""

    def __init__(self, grid_seg, amax_seg, anc_seg, des, ins_off, t_lo, state, ops,
                 tables, launch, mutate=None):
        self.grid, self.amax, self.anc, self.des, self.ins_off = (
            grid_seg, amax_seg, anc_seg, des, ins_off)
        self.t_lo, self.state, self.ops = t_lo, state, ops
        self.logP64, self.match_emit, gc = tables
        self.g = Gap(gc)
        self.launch, self.mutate = launch, mutate
        self.S = amax_seg.shape[0]
        self.B, self.m = des.shape
        self.Cc = self.m + 1
        self.R, self.T, self.Wc, self.C = launch.cols, launch.threads, launch.window, launch.bands
        self.RT = self.R * self.T
        self.nwarps = self.T // 32
        self.emit = torch.cat([match_emit_rows(self.match_emit), torch.zeros((4, 1))], dim=1)
        self.seen = {"window": 0, "scratch": 0, "earlier pass": 0, "lane window": 0,
                     "lane device": 0, "another band": 0}
        self.rng = random.Random(7)
        self.neg_code = int(self.g.code(NEG, NEG, NEG))

    def run(self):
        for b in range(self.B):
            self.pair(b)
        return self.state, self.ops

    # -- one pair, one block a codon block ------------------------------------
    def pair(self, b):
        i, j, st = (int(self.state[q, b]) for q in range(3))
        act = lambda t, i, j: i > 3 * (self.t_lo + t) and (i > 0 or j > 0)  # noqa: E731
        lanes = None      # the lane window (the next block's lanes), or None
        prev_j = None     # the j the next block's first pass was loaded up to
        bind = self.bind_device(b, self.S - 1, j, st) if act(self.S - 1, i, j) else None
        for t in range(self.S - 1, -1, -1):
            out = 6 * (self.t_lo + t)
            if not act(t, i, j):
                for ph in range(6):
                    self.ops[out + ph, b] = st if ph & 1 else 2
                if t > 0 and act(t - 1, i, j):
                    bind = self.bind_device(b, t - 1, j, st)
                prev_j = None
                continue
            bj = j
            lo = 0 if bj + 1 <= self.Wc else (bj + 1 - self.Wc + 3) // 4 * 4
            # this block's windows (a band's each on the band route), scratch
            # and lane window: NaN until written
            self.winC = torch.full((self.C, 3, self.Wc), NAN)
            self.winU = torch.full((self.C, 3, self.Wc), NAN)
            self.scr = torch.full((6, self.Cc), NAN)
            lanes = torch.full((3, LANE_WINDOW), NAN)
            if t > 0:  # warp 0: the next block's lanes at distance l from j
                for l in range(LANE_WINDOW):
                    c = bj - l
                    for s in range(3):
                        lanes[s, l] = float(self.amax[t - 1, s, b, c]) if c >= 0 else 0.0
            if self.C > 1:
                self.recompute_bands(b, t, bj, st == 2, bind, prev_j)
            else:
                self.recompute(b, t, bj, lo, st == 2, bind, prev_j)
            i, j, st = self.walk(b, t, i, j, st, lo, out)
            prev_j = bj if t > 0 else None
            if t > 0 and act(t - 1, i, j):
                l = bj - j  # j only moves left
                if l < LANE_WINDOW or self.mutate == "lane window unchecked":
                    # past its end the window holds nothing of this row
                    s3 = 0 if st == 0 else (1 if st == 1 else 2)
                    v = lanes[s3, l] if l < LANE_WINDOW else torch.tensor(NAN)
                    self.check(v, "the lane window")
                    self.seen["lane window"] += 1
                    bind = self.bind_lane(b, t - 1, int(v))
                else:
                    self.seen["lane device"] += 1
                    bind = self.bind_device(b, t - 1, j, st)
        self.state[0, b], self.state[1, b], self.state[2, b] = i, j, st

    def bind_device(self, b, t, j, st):
        s3 = 0 if st == 0 else (1 if st == 1 else 2)
        return self.bind_lane(b, t, int(self.amax[t, s3, b, j]))

    def bind_lane(self, b, t, lane):
        cod = int(self.anc[b, t])
        cost = _max(self.logP64[cod, lane], NEG) if lane < 64 else NEG
        return lane, cost

    def check(self, v, what):
        if torch.isnan(torch.as_tensor(v)).any():
            raise UnwrittenRead(f"the walk read an unwritten slot of {what}")

    # -- the recompute -------------------------------------------------------
    def recompute(self, b, t, bj, lo, row3, bind, prev_j):
        g, R, T, RT = self.g, self.R, self.T, self.RT
        lane, cost = bind
        e = [self.emit[(lane >> sh) & 3] for sh in (4, 2, 0)]  # [5] each, d = -1 last
        npass = (bj + RT) // RT
        runI = [NINF, NINF, NINF]
        runU = [-1, -1, -1]
        carry = None  # the pass before's last column of rows 1 and 2
        for k in range(npass):
            c0 = k * RT
            # the first pass was loaded a block ahead, up to the block before's j
            x = Cols(self, b, t, c0, prev_j if (k == 0 and prev_j is not None) else bj)
            c = x.c
            M0, D0, I0 = x.MDI
            self.put_codes(2, g.code(M0, D0, I0), c, bj, lo)  # phase 5's
            # row 1 from the boundary
            M1, D1, I1, runI[0], edge1 = self.row(
                c, x.left, (M0, D0, I0), x, e[0], None, runI[0], k == 0)
            self.put_codes(0, g.code(M1, D1, I1), c, bj, lo)  # phase 3's
            left2 = self.left_of((M1, D1, I1), carry[0] if carry else None, edge1)
            M2, D2, I2, runI[1], edge2 = self.row(
                c, left2, (M1, D1, I1), x, e[1], None, runI[1], k == 0)
            U1, runU[0] = self.exits(c, M1, I1, runU[0])
            self.put_u(0, U1, c, bj, lo)
            self.put_codes(1, g.code(M2, D2, I2), c, bj, lo)  # phase 1's
            if row3:
                left3 = self.left_of((M2, D2, I2), carry[1] if carry else None, edge2)
                M3, _, I3, runI[2], _ = self.row(
                    c, left3, (M2, D2, I2), x, e[2], cost, runI[2], k == 0)
                U2, runU[1] = self.exits(c, M2, I2, runU[1])
                U3, runU[2] = self.exits(c, M3, I3, runU[2])
                self.put_u(2, U3, c, bj, lo)
            else:
                U2, runU[1] = self.exits(c, M2, I2, runU[1])
            self.put_u(1, U2, c, bj, lo)
            carry = ((M1[-1], D1[-1], I1[-1]), (M2[-1], D2[-1], I2[-1]))

    def recompute_bands(self, b, t, bj, row3, bind, prev_j):
        """The band route: band q (block q of the pair's cluster) holds the
        pass [q RT, (q + 1) RT). After each row's scan every band puts its
        totals and its last column into an exchange slot; after the cluster
        barrier each takes the maxima of the bands before it and its left
        column from them. The bands run each part in random order; the
        slots hold NaN until written."""
        g, C, RT = self.g, self.C, self.RT
        lane, cost = bind
        e = [self.emit[(lane >> sh) & 3] for sh in (4, 2, 0)]
        xs = [Cols(self, b, t, q * RT, prev_j if prev_j is not None else bj) for q in range(C)]
        slots = torch.full((C, 2, 8), NAN)
        made = [0]

        def order():
            qs = list(range(C))
            self.rng.shuffle(qs)
            return qs

        def exchange(hands):
            """hands[q] = (f32 total, int total, M, D, P, K) of band q: each
            band's (f32 base, int base, its left column)."""
            s = made[0] & 1
            made[0] += 1
            for q in order():
                slots[q, s, :6] = torch.stack([_f(v) for v in hands[q]])
            out = [None] * C
            for q in order():
                mine = slots[:q, s]
                self.check(mine[:, :2], "an exchange slot")
                base = mine[:, 0].max() if q else NINF
                ubase = int(mine[:, 1].max()) if q else -1
                edge = None
                if q:
                    left = slots[q - 1, s]
                    self.check(left[2:6], "an exchange slot")
                    prev = slots[:q - 1, s, 0].max() if q > 1 else NINF
                    edge = (left[2], left[3], _max(prev, left[4]) + left[5])
                out[q] = (base, ubase, edge)
            return out

        # the boundary's codes, then row 1 in every band
        loc = [None] * C
        for q in order():
            x = xs[q]
            self.put_codes(2, g.code(*x.MDI), x.c, bj, q * RT, q)
            loc[q] = self.row_local(x.c, x.left, tuple(x.MDI), x, e[0], None, NINF)
        ex = exchange([(r["hand"][0], -1, *r["hand"][1:]) for r in loc])
        rows1 = [None] * C
        for q in order():
            rows1[q] = self.row_final(loc[q], ex[q][0]) + (ex[q][2],)
            M1, D1, I1 = rows1[q][:3]
            self.put_codes(0, g.code(M1, D1, I1), xs[q].c, bj, q * RT, q)
        # row 2, and row 1's exits
        u1 = [None] * C
        for q in order():
            M1, D1, I1, _, edge, bedge = rows1[q]
            left = self.left_of((M1, D1, I1), bedge, edge)
            loc[q] = self.row_local(xs[q].c, left, (M1, D1, I1), xs[q], e[1], None, NINF)
            u1[q] = self.exits(xs[q].c, M1, I1, -1)
        ex = exchange([(loc[q]["hand"][0], u1[q][1], *loc[q]["hand"][1:]) for q in range(C)])
        rows2 = [None] * C
        for q in order():
            rows2[q] = self.row_final(loc[q], ex[q][0]) + (ex[q][2],)
            M2, D2, I2 = rows2[q][:3]
            self.put_u(0, torch.clamp(u1[q][0], min=ex[q][1]), xs[q].c, bj, q * RT, q)
            self.put_codes(1, g.code(M2, D2, I2), xs[q].c, bj, q * RT, q)
        last = [None] * C  # the last exit row's band parts: U3 entered in I, else U2
        if row3:
            u2 = [None] * C
            for q in order():
                M2, D2, I2, _, edge, bedge = rows2[q]
                left = self.left_of((M2, D2, I2), bedge, edge)
                loc[q] = self.row_local(xs[q].c, left, (M2, D2, I2), xs[q], e[2], cost, NINF)
                u2[q] = self.exits(xs[q].c, M2, I2, -1)
            ex = exchange([(loc[q]["hand"][0], u2[q][1], *loc[q]["hand"][1:])
                           for q in range(C)])
            for q in order():
                M3, _, I3 = self.row_final(loc[q], ex[q][0])[:3]
                self.put_u(1, torch.clamp(u2[q][0], min=ex[q][1]), xs[q].c, bj, q * RT, q)
                last[q] = self.exits(xs[q].c, M3, I3, -1)
        else:
            for q in order():
                M2, _, I2 = rows2[q][:3]
                last[q] = self.exits(xs[q].c, M2, I2, -1)
        # the last exit row stays block-level in the windows; its bands' totals
        # go to the slots, and the walker adds the bands before to what it reads
        self.pend_row = 2 if row3 else 1
        for q in order():
            self.put_u(self.pend_row, last[q][0], xs[q].c, bj, q * RT, q)
        s = made[0] & 1
        for q in order():
            slots[q, s, 1] = float(last[q][1])
        self.pend_tot = slots[:, s, 1]

    def row(self, c, left, below, x, e, cost, run, first_pass):
        """One row of a pass, as row_step: M and D from the row below and its
        column left of each (`left` [3, RT]), then the scan. Returns (M, D,
        I, the new run, each warp's last column as the next warp rebuilds
        it)."""
        return self.row_final(self.row_local(c, left, below, x, e, cost, run), NINF)

    def row_local(self, c, left, below, x, e, cost, run):
        """A row's part before any band exchange: M, D and the block's scan."""
        g, R, T = self.g, self.R, self.T
        pM, pD, pI = below
        ec = e[x.d]  # d = -1 takes the padded 0
        core = g.shiftmax3(c, left[0], left[1], left[2])
        if cost is None:
            M, D = core + ec, g.dmax3(pM, pD, pI)
        else:
            M, D = core + (cost + ec), g.dmax3(pM, pD, pI) + cost
        v = (M - x.off).view(T, R)
        inc = torch.cummax(v, dim=1).values
        ex = torch.cat([NINF.expand(T, 1), inc[:, :-1]], dim=1)  # in the thread
        excl_t, run2, base, wex31 = _excl_scan(inc[:, -1], _f(run), self.nwarps)
        # what the block's last thread hands to the next band: its totals,
        # its last column's M, D, the maximum left of it (P), off + (go - ge)
        hand = (run2, M[-1], D[-1], _max(excl_t[-1], ex[-1, -1]), x.off[-1] + g.go_ge)
        return dict(c=c, x=x, M=M, D=D, ex=ex, excl_t=excl_t, run2=run2, base=base,
                    wex31=wex31, hand=hand)

    def row_final(self, r, band_base):
        """I from the block's scan and the bands before (band_base); each
        warp's last column's I as the next warp rebuilds it from the
        hand-over: the warp's maximum left of that column (P) and off + (go
        - ge) (K), with run, the warps and the bands before it."""
        g, R, T = self.g, self.R, self.T
        c, x, M, D, ex = r["c"], r["x"], r["M"], r["D"], r["ex"]
        excl = _max(_max(r["excl_t"], band_base)[:, None], ex).reshape(-1)
        I = g.ins(c, excl, x.off)
        last = torch.arange(31, T, 32) * R + R - 1
        P = _max(r["wex31"], ex[31::32, -1])
        K = x.off[last] + g.go_ge
        edge_I = _max(_max(r["base"], P), band_base) + K
        if not torch.equal(edge_I, I[last]):
            raise AssertionError("the hand-over rebuilds another I than the column's")
        return M, D, I, r["run2"], (M[last], D[last], edge_I, last)

    def left_of(self, row, carry, edge):
        """The row's value one column left of each column: the column before
        in the pass; a warp's first from the warp before's hand-over; the
        pass's first from the pass before (NEG at column 0)."""
        M, D, I = row
        Ml, Dl, Il = (torch.cat([_f(carry[q] if carry else NEG)[None], v[:-1]])
                      for q, v in enumerate((M, D, I)))
        Me, De, Ie, last = edge
        first = last[:-1] + 1  # each warp's first column but warp 0's
        Ml[first], Dl[first], Il[first] = Me[:-1], De[:-1], Ie[:-1]
        return torch.stack([Ml, Dl, Il])

    def exits(self, c, M, I, run):
        """Run-exit indices of a row over the pass: the last flagged column
        inside each warp (ballots), then the warps before and the passes
        before."""
        R = self.R
        col = torch.where(self.g.exits(M, I), c, -1).view(self.nwarps, 32 * R)
        winc = torch.cummax(col, dim=1).values
        totals = winc[:, -1]
        base = torch.cat([torch.tensor([-1]), torch.cummax(totals, dim=0).values[:-1]])
        U = torch.maximum(winc, torch.clamp(base, min=run)[:, None]).reshape(-1)
        return U, max(run, int(totals.max()))

    def put_codes(self, r, code, c, bj, lo, band=0):
        self._put(self.winC[band, r], self.scr[r], code.to(F32), c, bj, lo)

    def put_u(self, r, U, c, bj, lo, band=0):
        self._put(self.winU[band, r], self.scr[3 + r], U.to(F32), c, bj, lo)

    def _put(self, wrow, srow, v, c, bj, lo):
        ok = c <= bj
        win = ok & (c >= lo)
        wrow[(c[win] - lo)] = v[win]
        if self.mutate != "no scratch":
            left = ok & (c < lo)
            srow[c[left]] = v[left]

    # -- the walk ------------------------------------------------------------
    def walk(self, b, t, i, j, st, lo, out):
        pass_of_j = j // self.RT

        def read(win, r, srow, col):
            if self.C > 1:  # the band's window that holds the column
                q = col // self.RT
                v = win[q, r, col - q * self.RT]
                if win is self.winU and r == self.pend_row and q > 0:
                    self.check(self.pend_tot[:q], "an exchange slot")
                    v = _max(v, self.pend_tot[:q].max())
                self.seen["another band" if q != min(pass_of_j, self.C - 1) else "window"] += 1
            elif col >= lo:
                v = win[0, r, col - lo]
                self.seen["window"] += 1
            else:
                v = self.scr[srow, col]
                self.seen["scratch"] += 1
            if col // self.RT < pass_of_j:
                self.seen["earlier pass"] += 1
            self.check(v, "the window" if self.C > 1 or col >= lo else "the scratch")
            return int(v)

        base_i = 3 * (self.t_lo + t)
        for ph in range(6):
            act = i > base_i and (i > 0 or j > 0)
            if ph % 2 == 0:
                cnt = 0
                if act and st == 2:
                    r = 2 - ph // 2
                    u = 0 if j < 1 else max(read(self.winU, r, 3 + r, j - 1), 0)
                    cnt, j, st = j - u, u, 0
                self.ops[out + ph, b] = 2 | (cnt << 2)
            else:
                pj = j - (1 if st == 0 else 0)
                self.ops[out + ph, b] = st | (int(act) << 2)
                if act:
                    r = 1 if ph == 1 else (0 if ph == 3 else 2)
                    code = self.neg_code if pj < 0 else read(self.winC, r, r, pj)
                    i, j, st = i - 1, pj, (code & 3) if st == 0 else (code >> 2)
        return i, j, st


def match_emit_rows(match_emit):
    """[4, 5]: the match emission of each intermediate nucleotide x against
    each descendant code d."""
    return match_emit[:4, :5].to(F32)


# -- inputs -------------------------------------------------------------------
def insertion_pairs(seed, n, cods=(30, 70), runs=(30, 150)):
    """Homologous pairs whose descendant carries one to three insertions of
    30-150 nt (and a few point changes), so that the walk takes long
    insertion runs; every other pair also loses a codon or two."""
    rng = random.Random(seed)
    pairs = []
    for p in range(n):
        anc = "".join(rng.choice(CODONS61) for _ in range(rng.randint(*cods)))
        des = [rng.choice("ACGT") if rng.random() < 0.04 else x for x in anc]
        for _ in range(rng.randint(1, 3)):
            pos = rng.randint(0, len(des))
            des[pos:pos] = [rng.choice("ACGT") for _ in range(rng.randint(*runs))]
        if p % 2:
            pos = rng.randint(0, len(des) - 6)
            del des[pos:pos + 3 * rng.randint(1, 2)]
        pairs.append((anc, "".join(des)))
    return pairs


class Walks:
    """One batch's rows by the plain rows (held to XLA elsewhere) and the
    walk's starting state, the grid with boundary 0 in front."""

    def __init__(self, name, pairs):
        self.anc, self.des, self.io, self.lt, self.lm, self.tables = _batch(name, pairs)
        self.B, self.n_cod = self.anc.shape
        init = tw.triplet_init_carry(self.des, self.io, self.tables[2])
        rows, lanes, _ = rows_k.triplet_rows_plain(self.anc, self.des, self.io,
                                                   *self.tables, init)
        self.grid = torch.cat([init[None], rows])
        self.amax = torch.cat([torch.zeros_like(lanes[:1]), lanes])
        b = torch.arange(self.B)
        last = self.lt.long()
        self.st0, _ = tw.triplet_terminal(self.grid[last, 0, b], self.grid[last, 1, b],
                                          self.grid[last, 2, b], self.lm, self.tables[2])

    def start(self):
        state = tw._walk_state(self.lt, self.lm, self.st0)
        return state, torch.zeros((6 * self.n_cod, self.B), dtype=torch.int32)

    def walk(self, fn, spans):
        """fn(grid, amax, anc, des, io, t_lo, state, ops, *tables) over
        spans of codon blocks, top to bottom."""
        state, ops = self.start()
        for t_lo, S in reversed(spans):
            fn(self.grid[t_lo:t_lo + S + 1], self.amax[t_lo + 1:t_lo + S + 1],
               self.anc[:, t_lo:t_lo + S].contiguous(), self.des, self.io, t_lo,
               state, ops, *self.tables)
        return state, ops

    def spans(self, seg=None):
        seg = seg or self.n_cod
        return [(lo, min(seg, self.n_cod - lo)) for lo in range(0, self.n_cod, seg)]


def emulated(w, launch, spans, **kw):
    emus = []

    def fn(*args):
        emu = WalkEmu(*args[:8], args[8:], launch, **kw)
        emus.append(emu)
        return emu.run()

    return w.walk(fn, spans), emus


def _equal(got, want):
    assert torch.equal(got[0], want[0]), "walk state"
    assert torch.equal(got[1], want[1]), "op rows"


CASES = [
    # model, pairs, launches (cols, threads, window, bands; bands 0: as many
    # bands of one pass as cover the row), blocks a segment
    ("tri-mg", ("ins", 11, 6), ((1, 32, 16, 1), (2, 64, 32, 1), (4, 32, None, 1),
                                (2, 64, None, 0)), None),
    ("tri-mg", ("ins", 12, 5), ((2, 32, 8, 1), (8, 32, 64, 1), (4, 64, None, 0)), 9),
    ("tri-ecm", ("ins", 13, 4), ((4, 32, 24, 1), (1, 64, None, 1), (2, 96, None, 0)), None),
    ("tri-mg", ("ragged", 5, 16), ((1, 32, 8, 1), (2, 32, None, 1), (1, 32, None, 0)), 4),
    ("tri-ecm", ("ragged", 6, 10), ((2, 64, 12, 1), (4, 32, 4, 1), (2, 32, None, 0)), None),
]


def case_launch(Cc, cols, threads, window, bands):
    if bands == 0:
        bands = -(-Cc // (cols * threads))
        assert 2 <= bands <= walk_k.MAX_BANDS, (Cc, cols, threads)
    return walk_k.walk_launch(Cc, cols, threads, window, bands)


def _pairs(spec):
    kind, seed, n = spec
    if kind == "ins":
        return insertion_pairs(seed, n)
    return ragged_pairs(seed, n, cods=(2, 30), nts=(1, 150))


_WALKS = {}


def walks(name, spec):
    key = (name, spec)
    if key not in _WALKS:
        _WALKS[key] = Walks(name, _pairs(spec))
    return _WALKS[key]


_RUNS = {}


def case_runs(name, spec, shapes, seg):
    """[(emulated (state, ops), the emulations' reads by place)] of one case
    at each of its shapes, computed once."""
    key = (name, spec, shapes, seg)
    if key not in _RUNS:
        w = walks(name, spec)
        runs = []
        for shape in shapes:
            launch = case_launch(w.des.shape[1] + 1, *shape)
            got, emus = emulated(w, launch, w.spans(seg))
            seen = {}
            for emu in emus:
                for k, v in emu.seen.items():
                    seen[k] = seen.get(k, 0) + v
            runs.append((got, seen))
        _RUNS[key] = runs
    return _RUNS[key]


@pytest.mark.parametrize("name,spec,shapes,seg", CASES)
def test_emulated_walk_equals_plain(name, spec, shapes, seg):
    """tri-mg and tri-ecm; pairs with insertions of 30-150 nt and ragged
    batches with N; passes of 1-8 columns x 32-96 threads, windows of 4-64
    columns and the whole row, and the band route (2-8 bands of one pass);
    the walk whole and in segments from a checkpoint (t_lo > 0): state and
    op rows bit-equal to plain."""
    w = walks(name, spec)
    want = w.walk(walk_k.triplet_walk_plain, w.spans(seg))
    for got, _ in case_runs(name, spec, shapes, seg):
        _equal(got, want)


def test_the_cases_reach_their_shapes():
    """Across the cases the walk reads the window, the scratch (a run that
    leaves the window), columns of an earlier pass than j's, another band's
    window (on the band route), the lane window and the device for the next
    lane (a run longer than 64 columns)."""
    seen = {}
    for case in CASES:
        for _, part in case_runs(*case):
            for k, v in part.items():
                seen[k] = seen.get(k, 0) + v
    assert all(seen[k] > 0 for k in ("window", "scratch", "earlier pass", "another band",
                                     "lane window", "lane device")), seen


def test_emulated_walk_equals_the_xla_walk():
    """One case against the JAX package's scan directly (XLA:CPU), its rows
    too: the port's plain rows feed the emulation, the JAX rows the scan."""
    pairs = insertion_pairs(21, 4)
    jm, _ = models("tri-mg")
    pk = Packed(jm, pairs)
    grid, amax = jax_tw._triplet_rows(*pk.jargs, *pk.jtables, n_cod=pk.n_cod)
    grid, amax = np.asarray(grid), np.asarray(amax)
    b = np.arange(pk.B)
    st0, _ = jax_tw.triplet_terminal(*(jnp.asarray(grid[pk.lens_t, s, b]) for s in range(3)),
                                     jnp.asarray(pk.lens_m), pk.jtables[2])
    state0 = (3 * jnp.asarray(pk.lens_t), jnp.asarray(pk.lens_m),
              jnp.asarray(st0).astype(jnp.int32), jnp.zeros((6 * pk.n_cod, pk.B), jnp.int32))
    xi, xj, xst, xops = jax_tw._triplet_walk_seg_xla(
        jnp.asarray(grid[:-1]), jnp.asarray(amax[1:]), *pk.jargs, jnp.int32(0), state0,
        *pk.jtables, S=pk.n_cod)
    w = Walks("tri-mg", pairs)
    np.testing.assert_array_equal(w.grid.numpy(), grid)
    launch = walk_k.walk_launch(w.des.shape[1] + 1, 2, 32, 16)
    (state, ops), _ = emulated(w, launch, w.spans())
    for got, want in zip(state, (xi, xj, xst)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ops.numpy(), np.asarray(xops))


@pytest.mark.parametrize("mutate", ["no scratch", "lane window unchecked"])
def test_leaving_out_a_refill_reads_nan(mutate):
    """Without the scratch for the columns left of the window, a run that
    leaves it reads a slot never written; read without its range check, the
    lane window does after a run longer than it."""
    w = walks("tri-mg", ("ins", 11, 6))
    launch = walk_k.walk_launch(w.des.shape[1] + 1, 2, 64, 32)
    with pytest.raises(UnwrittenRead):
        emulated(w, launch, w.spans(), mutate=mutate)


def test_walk_launch_and_smem():
    """walk_launch takes the kernel's shapes and raises on others (on the
    band route 2-8 bands that cover the row, a window of a band); the
    window's layout is 15 bytes a column beside the fixed part."""
    L = walk_k.walk_launch(1011, 2, 512)
    assert (L.cols, L.threads, L.window) == (2, 512, 1012) and not L.scratch(1011)
    assert walk_k.walk_launch(14997, 8, 256, 64).scratch(14997)
    assert walk_k.walk_smem_bytes(1012) == walk_k.walk_smem_bytes(0) + 15 * 1012
    L = walk_k.walk_launch(14997, 4, 512, bands=8)
    assert (L.window, L.bands) == (2048, 8) and not L.scratch(14997)
    for bad in ((3, 64, None), (8, 512, None), (2, 48, None), (2, 64, 10)):
        with pytest.raises(ValueError):
            walk_k.walk_launch(100, *bad)
    for bands, window in ((9, None), (7, None), (8, 1024)):  # too many, too few, too narrow
        with pytest.raises(ValueError):
            walk_k.walk_launch(14997, 4, 512, window, bands)


def test_wrapper_on_cpu_takes_plain_at_any_launch():
    """On CPU tensors triplet_walk takes the plain version whatever launch it
    is given, and counts no launch."""
    w = walks("tri-mg", ("ragged", 5, 16))
    want = w.walk(walk_k.triplet_walk_plain, w.spans(4))
    before = walk_k.LAUNCHES
    Cc = w.des.shape[1] + 1
    for launch in (None, walk_k.walk_launch(Cc, 8, 256, 4), walk_k.walk_launch(Cc, 1, 32)):
        def fn(*args, launch=launch):
            return walk_k.triplet_walk(*args, launch=launch)
        _equal(w.walk(fn, w.spans(4)), want)
    assert walk_k.LAUNCHES == before
