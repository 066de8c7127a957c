"""The band route of the triplet rows kernel (csrc/triplet_rows.cu), emulated
in plain torch on the CPU.

BandEmu below follows the kernel: each pair's columns are cut into bands
of whole tiles (rows_launch), one block a band. A band runs the codon steps
one after another, a tile of columns at a time through the three phases,
with the running maxima and the last column's phase values handed from tile
to tile. Everything its first tile takes from the columns to its left comes
from a record its left neighbour published for that step: the 22 running
maxima, the left column's 45 phase values and the boundary below at that
column. Records go through a ring of F slots a band boundary; progress
counters (steps done) are read before a band starts a step (its left
neighbour's) and before it overwrites a slot (its right neighbour's:
back-pressure). A band reads the boundary below only at its own columns.
The entry costs come from a table of 6 classes of column x 16 groups built
once a step.

The bands of a pair run as generators, interleaved in random order by
random numbers of actions (a poll, a record copied, a tile, a record
written, a counter stored), and every slot of the boundaries (grid or
scratch) and of the rings not yet written holds NaN, which any read of it
carries into the cells (torch.maximum propagates NaN). The rows, lanes and
carry out must be bit-equal to triplet_rows_plain's, which
tests/test_torch_triplet.py holds to the JAX reference's scan (XLA:CPU) and
its Pallas kernel (interpreted). No round may find every band waiting.
"""

import random

import numpy as np
import pytest
import torch

from coati_tpu_torch import triplet_hmm as torch_hmm
from coati_tpu_torch import triplet_wavefront as tw
from coati_tpu_torch.kernels import triplet_rows as rows_k
from coati_tpu_torch.structs import AlignmentParams
from test_torch_triplet import Packed, jax_rows, models, ragged_pairs

NEG = rows_k.NEG
NAN = float("nan")


class Deadlock(AssertionError):
    pass


def _pairs(seed, n, cods, nts):
    return ragged_pairs(seed, n, cods=cods, nts=nts)


def _batch(name, pairs):
    """The port's packed batch of `pairs` under model `name` on the CPU:
    (anc_cods, des, ins_off, lens_t, lens_m, (logP64, match_emit, gc))."""
    aln = AlignmentParams()
    aln.model = name
    if name == "tri-ecm":
        from coati_tpu_torch.constants import ECM_DNA_PI

        aln.pi = ECM_DNA_PI
    model = torch_hmm.build_triplet_model(aln)
    enc = [torch_hmm.encode_triplet_pair(model, a, d) for a, d in pairs]
    anc_p, des_p, lens_t, lens_m, ins_off, tables, _ = tw._pack_batch(
        model, [e[0] for e in enc], [e[1] for e in enc], "cpu")
    t = [torch.from_numpy(x.copy()) for x in (anc_p, des_p, ins_off, lens_t, lens_m)]
    return (*t, tables)


class Tables:
    """One step's entry costs for one pair: KD [16] and its x3, and with the
    table the match lanes' first-max of cost + e for 6 classes of column
    (descendant code 0-4 left of the column; column 0, where e is 0)."""

    def __init__(self, cost, match_emit):
        cost = cost.reshape(16, 4)
        self.KD, self.KDpay = rows_k.first_max(cost, 1)
        e = torch.cat([match_emit[:4, :5].T, torch.zeros((1, 4))])  # [6, 4]
        self.KK, pay = rows_k.first_max(cost[None] + e[:, None, :], 2)  # [6, 16]
        self.KKlane = torch.arange(16)[None] * 4 + pay


def _excl_max(v, run):
    """Exclusive prefix maximum along the last axis from `run`; returns it
    and the new run (run taking the whole tile in)."""
    inc = torch.cummax(v, dim=-1).values
    excl = torch.cat([run[..., None], torch.maximum(inc[..., :-1], run[..., None])], dim=-1)
    return excl, torch.maximum(run, inc[..., -1])


def _shift(v, left):
    """The value of the column to the left: `left` for the tile's first."""
    return torch.cat([left[..., None], v[..., :-1]], dim=-1)


class Band:
    """Band `q` = columns [j0, j1) of pair b, its steps as a generator of
    actions; yields False after a poll that found its counter short."""

    def __init__(self, emu, b, q, j0, j1, last):
        self.emu, self.b, self.q, self.j0, self.j1, self.last = emu, b, q, j0, j1, last

    def run(self):
        e, b, q = self.emu, self.b, self.q
        T = e.launch.threads
        des, off = e.des[b], e.ins_off[b]
        n_steps = min(max(int(e.steps[b]), 0), e.S)
        for t in range(n_steps):
            if q > 0:  # the left neighbour's record of step t
                while e.progress[b][q - 1] < t + 1:
                    yield False
                yield True
                rec = e.rings[b][q - 1][t % e.slots].clone()
                if e.mutate == "halo from the boundary":
                    prev = e.boundary(b, t - 1)
                    rec[67:70] = prev[:, self.j0 - 1]
            else:
                rec = None
            tab = Tables(e.logP64[e.anc[b, t]], e.match_emit)
            prev = e.boundary(b, t - 1)
            run1 = rec[0:4] if rec is not None else torch.full((4,), -torch.inf)
            run2 = rec[4:20] if rec is not None else torch.full((16,), -torch.inf)
            runW = rec[20] if rec is not None else torch.tensor(-torch.inf)
            runC = torch.tensor(int(rec[21].view(torch.int32)) if rec is not None else -1)
            tile1 = rec[22:31] if rec is not None else torch.full((9,), NAN)
            tile2 = rec[31:67] if rec is not None else torch.full((36,), NAN)
            halo = rec[67:70] if rec is not None else torch.full((3,), NAN)
            for lo in range(self.j0, self.j1, T):
                hi = min(lo + T, self.j1)
                run1, run2, runW, runC, tile1, tile2 = self.tile(
                    t, lo, hi, prev, halo, tab, des, off, run1, run2, runW, runC,
                    tile1, tile2)
                yield True
            if not self.last:
                if e.back_pressure:
                    while e.progress[b][q + 1] < t - e.lead + 1:
                        yield False
                rec = torch.cat([run1, run2, runW[None], runC.to(torch.int32).view(
                    torch.float32)[None], tile1, tile2, prev[:, self.j1 - 1]])
                e.rings[b][q][t % e.slots] = rec
                yield True
            e.progress[b][q] = t + 1
            yield True
        cur = e.boundary(b, n_steps - 1)
        e.carry_out[:, b, self.j0:self.j1] = cur[:, self.j0:self.j1]

    def tile(self, t, lo, hi, prev, halo, tab, des, off, run1, run2, runW, runC,
             tile1, tile2):
        """Columns [lo, hi) of step t: the kernel's three phases."""
        e = self.emu
        g = e.ops
        j = torch.arange(lo, hi)
        Mc, Dc, Ic = prev[0, lo:hi], prev[1, lo:hi], prev[2, lo:hi]
        # the boundary below at the column to the left: the band's own, or
        # the left neighbour's from its record
        left_col = halo if lo == self.j0 else prev[:, lo - 1]
        sM, sD, sI = (_shift(prev[s, lo:hi], left_col[s]) for s in range(3))
        o = off[lo:hi]
        cls = torch.where(j >= 1, des[(j - 1).clamp(min=0)].long(), 5)
        E = torch.cat([e.match_emit[:4, :5].T, torch.zeros((1, 4))])[cls].T  # [4, n]

        def shiftmax3(M, D, I):
            core = torch.maximum(torch.maximum(M + g.ng_ng, D + g.gs), I + g.gs_ng)
            return torch.where(j >= 1, core, NEG)

        def dmax3(M, D, I):
            return torch.maximum(torch.maximum(M + g.ng_go, D + g.ge), I + g.gs_go)

        def ins(excl):
            return torch.where(j >= 1, excl + (o + g.go_ge), NEG)

        core1 = shiftmax3(sM, sD, sI)
        M1 = core1[None] + E                                    # [4, n]
        D1 = dmax3(Mc, Dc, Ic)[None]                            # [1, n]
        ex1, run1 = _excl_max(M1 - o, run1)
        I1 = ins(ex1)
        sM1 = _shift(M1, tile1[0:4])
        sD1 = _shift(D1, tile1[4:5])
        sI1 = _shift(I1, tile1[5:9])
        core2 = shiftmax3(sM1, sD1, sI1)                        # [4, n]
        M2 = (core2[:, None] + E[None]).reshape(16, -1)
        D2 = dmax3(M1, D1, I1)                                  # [4, n]
        ex2, run2 = _excl_max(M2 - o, run2)
        I2 = ins(ex2)
        sM2 = _shift(M2, tile2[0:16])
        sD2 = _shift(D2, tile2[16:20])
        sI2 = _shift(I2, tile2[20:36])
        D2g = D2.repeat_interleave(4, dim=0)
        core3 = shiftmax3(sM2, sD2.repeat_interleave(4, dim=0), sI2)
        D3 = dmax3(M2, D2g, I2)
        Ml = core3 + tab.KK[cls].T                              # [16, n]
        Dl = D3 + tab.KD[:, None]
        Mbest, gM = rows_k.first_max(Ml, 0)
        Dbest, gD = rows_k.first_max(Dl, 0)
        Wbest, gW = rows_k.first_max(Ml - o, 0)
        laneM = tab.KKlane[cls, gM]
        laneD = gD * 4 + tab.KDpay[gD]
        laneW = tab.KKlane[cls, gW]
        exW, runW = _excl_max(Wbest, runW)
        Inew = ins(exW)
        code = torch.where(Wbest > exW, j * 64 + laneW, -1)
        exC, runC = _excl_max(code, runC)
        cur = e.boundary(self.b, t)
        cur[0, lo:hi], cur[1, lo:hi], cur[2, lo:hi] = Mbest, Dbest, Inew
        if e.amax is not None:
            am = e.amax[t, :, self.b]
            am[0, lo:hi] = laneM.to(torch.uint8)
            am[1, lo:hi] = laneD.to(torch.uint8)
            am[2, lo:hi] = torch.where(j >= 1, exC % 64, 0).to(torch.uint8)
        last = lambda v: v[:, -1]  # noqa: E731
        return (run1, run2, runW, runC, torch.cat([last(M1), last(D1), last(I1)]),
                torch.cat([last(M2), last(D2), last(I2)]))


class BandEmu:
    """The launch of the rows kernel at `launch` over a batch: grid form
    (keep_grid) or scratch form, NaN wherever nothing was written yet."""

    def __init__(self, anc, des, ins_off, steps, lens_m, tables, carry, launch, *,
                 keep_grid=True, slots=None, lead=None, back_pressure=True, mutate=None):
        self.anc, self.des, self.ins_off, self.steps, self.lens_m = anc, des, ins_off, steps, lens_m
        self.logP64, self.match_emit, gc = tables
        self.carry, self.launch = carry, launch
        self.B, self.S = anc.shape
        self.Cc = des.shape[1] + 1
        self.slots = launch.slots if slots is None else slots
        self.lead = self.slots if lead is None else lead
        self.back_pressure, self.mutate = back_pressure, mutate
        ops = rows_k._Rows(ins_off, gc)
        self.ops = ops
        shape = (self.S, 3, self.B, self.Cc)
        self.grid = torch.full(shape, NAN) if keep_grid else None
        self.amax = torch.full(shape, 255, dtype=torch.uint8) if keep_grid else None
        self.scratch = None if keep_grid else torch.full((2, 3, self.B, self.Cc), NAN)
        self.carry_out = torch.full_like(carry, NAN)
        n = launch.bands
        self.progress = [[0] * n for _ in range(self.B)]
        self.rings = [[[torch.full((rows_k.RECORD,), NAN) for _ in range(self.slots)]
                       for _ in range(n - 1)] for _ in range(self.B)]

    def boundary(self, b, t):
        """[3, Cc] view of pair b's boundary after step t (t = -1: the carry)."""
        if t < 0:
            return self.carry[:, b]
        if self.grid is not None:
            return self.grid[t, :, b]
        return self.scratch[t & 1, :, b]

    def bands(self, b):
        Cb = int(self.lens_m[b]) + 1
        W = self.launch.width
        spans = [(q * W, min((q + 1) * W, Cb)) for q in range(self.launch.bands) if q * W < Cb]
        return [Band(self, b, q, j0, j1, q == len(spans) - 1)
                for q, (j0, j1) in enumerate(spans)]

    def run(self, rng, order="random"):
        """Every pair's bands interleaved: in random order and random steps,
        or ("greedy") left to right, each as far as it can go. Raises
        Deadlock when a round finds every band waiting."""
        for b in range(self.B):
            running = [band.run() for band in self.bands(b)]
            while running:
                moved = False
                seq = list(running)
                if order == "random":
                    rng.shuffle(seq)
                for g in seq:
                    for _ in range(rng.randint(1, 4) if order == "random" else 10**9):
                        try:
                            if next(g):
                                moved = True
                            elif order != "random":
                                break
                        except StopIteration:
                            running.remove(g)
                            moved = True
                            break
                if not moved:
                    raise Deadlock(f"pair {b}: every band waits")
        return self.grid, self.amax, self.carry_out


def _true_cells(lens_t, lens_m, S, Cc, t0=0):
    """[S, 3, B, Cc] mask of each pair's own steps (after boundary t0) and columns."""
    t = torch.arange(t0 + 1, t0 + S + 1)[:, None, None, None]
    j = torch.arange(Cc)[None, None, None, :]
    own = (t <= lens_t[None, None, :, None]) & (j <= lens_m[None, None, :, None])
    return own.expand(-1, 3, -1, -1)


def _emulate(batch, launch, *, t0=0, keep_grid=True, seed=0, order="random", **kw):
    """The emulation and the plain version from boundary t0 of the plain
    full sweep: (emulated rows, lanes, carry out; plain's; the mask)."""
    anc, des, io, lt, lm, tables = batch
    B, n_cod = anc.shape
    Cc = des.shape[1] + 1
    init = tw.triplet_init_carry(des, io, tables[2])
    full, full_lanes, _ = rows_k.triplet_rows_plain(anc, des, io, *tables, init)
    carry = init if t0 == 0 else full[t0 - 1].clone()
    S = n_cod - t0
    steps = (lt - t0).clamp(0, S).to(torch.int32)
    args = (anc[:, t0:].contiguous(), des, io, steps, lm, tables, carry, launch)
    emu = BandEmu(*args, keep_grid=keep_grid, **kw)
    grid, amax, out = emu.run(random.Random(seed), order)
    want_out = full[torch.clamp(lt, min=t0) - 1, :, torch.arange(B)].permute(1, 0, 2)
    want_out = torch.where((lt <= t0)[None, :, None], carry, want_out)
    return (grid, amax, out, full[t0:], full_lanes[t0:], want_out,
            _true_cells(lt, lm, S, Cc, t0), lm)


def _assert_equal(res, keep_grid=True):
    grid, amax, out, want_g, want_a, want_out, own, lm = res
    cols = torch.arange(out.shape[2])[None, :] <= lm[:, None]  # [B, Cc]
    assert torch.equal(out[:, cols], want_out[:, cols]), "the carry out"
    if keep_grid:
        assert torch.equal(grid[own], want_g[own]), "boundary rows"
        assert torch.equal(amax[own], want_a[own]), "argmax lanes"


CASES = [
    # model, pairs (seed, n, codons, nt), bands, threads, slots, t0
    ("tri-mg", (5, 16, (1, 12), (1, 200)), 1, 32, 8, 0),
    ("tri-mg", (5, 16, (1, 12), (1, 200)), 2, 32, 8, 0),
    ("tri-mg", (6, 8, (4, 30), (100, 300)), 3, 32, 2, 0),
    ("tri-mg", (7, 6, (10, 40), (100, 250)), 4, 32, 3, 9),
    ("tri-ecm", (8, 6, (4, 30), (60, 200)), 2, 64, 1, 0),
    ("tri-ecm", (9, 6, (10, 30), (90, 240)), 4, 32, 8, 5),
]


@pytest.mark.parametrize("keep_grid", [True, False])
@pytest.mark.parametrize("name,spec,bands,threads,slots,t0", CASES)
def test_band_rows_equal_plain(name, spec, bands, threads, slots, t0, keep_grid):
    """1-4 bands a pair of 32 or 64 columns a tile, ragged batches with N,
    tri-mg and tri-ecm, from boundary 0 or a checkpoint, in the grid form
    and the scratch form, rings of 1 to 8 slots: rows, lanes and the carry
    out bit-equal to plain on each pair's own steps and columns, whatever
    order the bands run in."""
    batch = _batch(name, _pairs(*spec))
    Cc = batch[1].shape[1] + 1
    launch = rows_k.rows_launch(Cc, bands, threads, slots=slots)
    assert launch.bands == bands
    for seed in range(3):
        _assert_equal(_emulate(batch, launch, t0=t0, keep_grid=keep_grid, seed=seed),
                      keep_grid)


def test_the_cases_reach_their_shapes():
    """Some pair of a case ends in the first band while others reach the
    last; the last band is narrower than the others; some pair has no step
    after the checkpoint."""
    short = narrow = idle = 0
    for name, spec, bands, threads, slots, t0 in CASES:
        anc, des, _, lt, lm, _ = _batch(name, _pairs(*spec))
        launch = rows_k.rows_launch(des.shape[1] + 1, bands, threads)
        short += bands > 1 and bool((lm + 1 <= launch.width).any())
        narrow += (des.shape[1] + 1) % launch.width != 0
        idle += bool((lt <= t0).any()) and t0 > 0
    assert short >= 3 and narrow >= 3 and idle >= 1


def test_band_rows_equal_the_jax_reference():
    """The emulated bands against the JAX package's scan directly (XLA:CPU)."""
    jm, _ = models("tri-mg")
    pairs = _pairs(6, 8, (4, 30), (100, 300))
    batch = _batch("tri-mg", pairs)
    launch = rows_k.rows_launch(batch[1].shape[1] + 1, 3, 32)
    grid, amax, *_, own, _ = _emulate(batch, launch)
    want_grid, want_amax = jax_rows(Packed(jm, pairs))
    np.testing.assert_array_equal(grid[own].numpy(), want_grid[1:][own.numpy()])
    np.testing.assert_array_equal(amax[own].numpy().astype(np.int32),
                                  want_amax[1:][own.numpy()])


def _mutant(**kw):
    batch = _batch("tri-mg", _pairs(6, 8, (4, 30), (100, 300)))
    launch = rows_k.rows_launch(batch[1].shape[1] + 1, 3, 32)
    return _emulate(batch, launch, order="greedy", **kw)


def test_greedy_order_is_still_right():
    """Left to right, each band as far as it goes: back-pressure holds band
    0 a ring's length ahead, and the rows are right."""
    _assert_equal(_mutant())
    _assert_equal(_mutant(keep_grid=False), keep_grid=False)


def test_without_back_pressure_the_cells_are_wrong():
    with pytest.raises(AssertionError, match="boundary rows|the carry out"):
        _assert_equal(_mutant(back_pressure=False))


def test_a_ring_of_one_slot_computes_wrong_cells():
    """A ring of 1 slot under the waits of a ring of RECORD_SLOTS: a band
    overwrites a record its right neighbour has not read."""
    with pytest.raises(AssertionError, match="boundary rows|the carry out"):
        _assert_equal(_mutant(slots=1, lead=rows_k.RECORD_SLOTS))


def test_reading_the_left_column_from_the_scratch_is_a_race():
    """What the record's boundary values are for: in the scratch form a band
    that read its left neighbour's column of the boundary below would find
    it already overwritten by the step after."""
    with pytest.raises(AssertionError, match="the carry out"):
        _assert_equal(_mutant(keep_grid=False, mutate="halo from the boundary"),
                      keep_grid=False)


def test_rows_launch_tiles_the_columns():
    """Bands of whole tiles, as even as whole tiles allow, covering the row,
    no band empty; a shape the kernel does not take raises."""
    for Cc in (1, 31, 32, 33, 999, 1011, 3011, 14997):
        for threads in (32, 64, 256, 512):
            for bands in (1, 2, 3, 4, 6, 30, 132):
                L = rows_k.rows_launch(Cc, bands, threads)
                tiles = -(-Cc // threads)
                assert L.width % threads == 0 and L.bands <= min(bands, tiles)
                assert L.bands * L.width >= Cc > (L.bands - 1) * L.width
                L.check(Cc)
    assert rows_k.rows_launch(14997, 132, 512).bands == 30
    with pytest.raises(ValueError, match="multiple of"):
        rows_k.rows_launch(100, 2, 48)
    with pytest.raises(ValueError, match="do not cut"):
        rows_k.rows_launch(1011, 2, 512).check(2000)


def test_wrapper_on_cpu_takes_plain_at_any_launch():
    """On CPU tensors triplet_rows takes the plain version whatever launch
    it is given, and counts no launch; a launch that does not cut the row
    raises."""
    anc, des, io, lt, lm, tables = _batch("tri-mg", _pairs(3, 5, (2, 9), (10, 90)))
    Cc = des.shape[1] + 1
    init = tw.triplet_init_carry(des, io, tables[2])
    before = rows_k.LAUNCHES
    want = rows_k.triplet_rows(anc, des, io, lt, lm, *tables, init)
    for launch in (rows_k.rows_launch(Cc, 3, 32), rows_k.rows_launch(Cc, 2, 64, slots=1)):
        got = rows_k.triplet_rows(anc, des, io, lt, lm, *tables, init, launch=launch)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert rows_k.LAUNCHES == before
    with pytest.raises(ValueError, match="do not cut"):
        rows_k.triplet_rows(anc, des, io, lt, lm, *tables, init,
                            launch=rows_k.RowsLaunch(1, 32, 32))
