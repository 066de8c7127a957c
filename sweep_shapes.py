#!/usr/bin/env python3
"""Time the port's sweep kernel (coati_tpu_torch/csrc/wavefront_segment.cu)
at several launch shapes, on its two several-blocks routes in turns, and
hold every shape to the one-block result.

    python3 sweep_shapes.py [--root DIR] [segment] [forward] [triplet] [fill]
                            [score] [segwalk] [samplewalk] [walkcells] [band]
                                 # from the repository root; needs one card;
                                 # no argument: every table but walkcells

For square random pairs of several sizes, alone and in a group of four, and
for several (blocks a pair, threads a block), it runs one 4,000-diagonal
segment with backpointers in the middle of the matrix, from the carry of a
score-only sweep down to it. A shape of several blocks runs at the
all-to-all barrier and on the band route (bands of columns), in turns: each
is first held to one block a pair (its backpointers on the pairs' true
cells, ring and corners bit-equal, any difference raises), then timed in the
order barrier, bands, bands, barrier, in microseconds a diagonal (both
readings printed). Then, at the shape the wrapper chooses, one run of the band route
with per-block timer stamps: the first and the last band's time to their
first cell and to their exit, the first band's pace, and what the last
waited beyond it, in hops. Last, the whole score-only sweep with the chosen
shape. CUDA events, mean of 2 launches after a warm-up, a reading.

Then the same for the Forward entry point of that kernel, which writes 12
bytes a cell where the segment writes 1: one pair of 9,999 and of 29,397 nt
(the sizes the sample verb is driven at), the whole matrix, at 1 to 132
blocks a pair, each shape on each route held to the one-block result
(equal, or within FWD_ATOL + FWD_RTOL * |value|, reported; a larger
difference raises), timed in turns beside the score-only sweep at the same
shape and route, the shape the wrapper chooses marked.

The rows of these two tables set kernels/wavefront_segment.py sweep_shape
and BAND_MIN_COLUMNS, and kernels/wavefront_forward.py forward_shape and
FORWARD_MIN_COLUMNS (their comments name the rows).

The fill table times the Viterbi fill kernel (csrc/wavefront_fill.cu) at
its launch shapes, strips of W columns x warps a pair x pairs a block (x
blocks a pair for pairs above 4,096 slots), each held bit-equal to the
shape fill_shape chooses on the pairs' true cells and corners: at B = 64
pairs of 600-999 nt (the kernel cell of chip_smoke.py), at one chunk of each
bucket of the main path's mix (156, 471, 999 and 1,500 nt, as many pairs as
the engine puts in a launch), and at k = 3. Then one pair of 8,000 nt, one
of 16,000 and two of 16,000 through the fill and the whole-stack walk
against the sweep's band route (wavefront_segment over every diagonal and
the segment walk), ops and scores equal. Last the whole-stack walk
(csrc/traceback_walk.cu) at S steps a window and warps a block, at the
B = 64 cell and at the 1,500 nt chunk, each equal op for op to the default.
The windows are copied with cp.async; a TMA tile copy was not tried.
CUDA events, mean of 5 launches after a warm-up (2 for the lone pairs).
Its rows set kernels/wavefront_fill.py fill_shape and
kernels/traceback_walk.py WINDOW_STEPS and WALK_WARPS.

Then the triplet rows kernel (csrc/triplet_rows.cu), which sweeps a row one
column a thread, a tile of the block's threads at a time, a pair's columns
cut into bands of tiles, one block a band: the two tri-mg batches
chip_smoke.py aligns, the first 512 codon steps of a lone 6,000 nt pair and
of its long pair, at
bands a pair x threads a band (128 to 512, the most the kernel is compiled
for; as many bands as the card holds at once), each held equal to the shape
rows_shape picks on the pairs' own cells; then the walk kernel
(csrc/triplet_walk.cu) at columns a thread x threads a block, at
walk_shape's window, and on the long pair at smaller windows (the rest in
the device scratch), each held equal in state and op rows to walk_shape's.
Its rows set kernels/triplet_rows.py rows_shape and
kernels/triplet_walk.py walk_shape.

The walkcells table times the triplet walk kernel at its three cells, each
pair's rows by the package's own rows kernel: 64 x 999 nt and 16 x 2,997 nt
whole, and the 15,000 nt pair over the segments of its long route (the
launches alignpair makes), then that pair through alignpair -m tri-mg twice
(host clock). It uses only what the package had before the
walk's redesign, so `--root DIR` times an unpacked older tree of the
repository (its chip_smoke.py and coati_tpu_torch imported from DIR), in
the same session as this one.

The band table times the long path's passes on the fill's strips
(csrc/wavefront_fill_long.cu) at the two long cases of chip_smoke.py's long
phase, the four 29-32 knt pairs as one group (driven there through the
long path by long_slots) and the 160,002 nt pair: pass 1 (the score-only
sweep that keeps the checkpoint rows) beside the score kernel alone, in
turns; then the middle band of rows with backpointers from its checkpoint
at strips of W columns x warps a block, as many blocks as the stripes need
(passes beyond the SMs the group leaves), each held bit-equal to
band_shape's launch on the band's true cells; the band walk at S steps a
window x warps a block on that band, from the state the real walk enters
it with, each equal in state and ops to the default; last the whole path
(align_long_group) timed by kernel. CUDA events, mean of 2 launches after
a warm-up. Its rows set kernels/wavefront_fill.py band_shape.

The samplewalk table times the sample walk (csrc/sample_walk.cu) at S steps
a window x warps a block and at one thread a sample, on the sample verb's
own matrices and uniforms at 9,999 nt x 200 samples, each held op for op
and score for score to walk_shape's. Its rows set kernels/sample_walk.py
WINDOW_STEPS and WALK_WARPS.
"""

from __future__ import annotations

import functools
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# --root DIR: import chip_smoke and coati_tpu_torch from another tree
if len(sys.argv) > 2 and sys.argv[1] == "--root":
    sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
    del sys.argv[1:3]
else:
    sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    KernelTimer,
    LENGTH_MIX,
    LONG_MIX,
    LONGPAIR_NT,
    N_LONG,
    SAMPLE_RUNS,
    TRIPLET_BATCHES,
    TRIPLET_LONG_NT,
    TripletBatch,
    make_pairs,
    rows_grid,
    run_sample,
    wrappers,
)
from coati_tpu_torch import cli, triplet_hmm  # noqa: E402
from coati_tpu_torch.align import longseq  # noqa: E402
from coati_tpu_torch.align.wavefront import walk_segment_plain  # noqa: E402
from coati_tpu_torch import triplet_wavefront as tw  # noqa: E402
from coati_tpu_torch.align.engine import _pad_batch, _sweep_align_ops  # noqa: E402
from coati_tpu_torch.kernels import (  # noqa: E402
    sample_walk,
    traceback_walk,
    triplet_rows,
    triplet_walk,
    wavefront_fill,
    wavefront_forward,
    wavefront_score,
    wavefront_segment,
)
from coati_tpu_torch.utils import encode_marginal  # noqa: E402
from coati_tpu_torch.params import alignment_params, params_from_numpy  # noqa: E402

SEGMENT = 4000  # diagonals of the timed segment
SIZES = ((8_000, 1), (32_000, 4), (32_000, 1), (160_000, 1))  # (nt, pairs)
BLOCKS = (1, 4, 8, 9, 16, 32, 33, 132)
THREADS = (1024, 512)
FORWARD_SIZES = (9_999, 29_397)  # nt of the one pair
FORWARD_BLOCKS = (1, 8, 16, 20, 33, 58, 132)
# each several-blocks shape runs at the barrier and on the band route, in
# turns (sweep_launch's `several`); one block a pair runs the first alone
TURNS = ("barrier", "bands")
FWD_RTOL, FWD_ATOL = 4e-6, 2e-5  # chip_smoke.py's, of the Forward's values
TRIPLET_THREADS = (512, 256, 128)  # threads a band
TRIPLET_BANDS = (2, 3, 4, 6, 8, 12, 15, 24, 30, 60, 120)  # bands a pair, at most
TRIPLET_LONG_STEPS = 512  # codon steps of the long pair that are swept
TRIPLET_MID_NT = 6_000  # a lone pair between the batches and the long pair (its first steps)
WALK_THREADS = (64, 128, 256, 512)  # the triplet walk's threads a block
WALK_WINDOWS = (64, 256, 1024)  # and its windows beside walk_shape's, on the long pair
# samplewalk table: (S, warps a block); S = 0 is one thread a sample
SAMPLE_SHAPES = ((0, 1), (8, 4), (16, 2), (16, 4), (16, 8), (24, 4), (32, 1),
                 (32, 2), (32, 4), (32, 8))
# fill table: (strips of W columns, warps a pair, pairs a block) at a bucket
FILL_SHAPES = ((4, 5), (4, 9), (8, 2), (8, 3), (8, 5), (8, 9), (16, 1),
               (16, 2), (16, 4))
FILL_PAIRS = (1, 2)
LONE = ((8_000, 1), (16_000, 1), (16_000, 2))  # (nt, pairs) of the lone pairs
LONE_SHAPES = ((8, 1), (8, 2), (8, 4), (4, 1), (4, 2))  # (W, warps) spread over blocks
WALK_S = (16, 32, 48, 64)
WALK_WARPS = (1, 2, 4)
# score table: (W, warps) of the strip route beside score_shape's, for a
# bucket (one block a pair) and for pairs spread over blocks
SCORE_SHAPES = ((4, 5), (8, 2), (8, 5), (16, 1), (16, 2))
SCORE_SPREAD = ((4, 1), (4, 2), (4, 4), (4, 8), (8, 2), (8, 4), (8, 5), (16, 2),
                (16, 3), (16, 4))
SEGWALK_S = (16, 32, 64)
SEGWALK_WARPS = (1, 2)
# band table: (W, warps a block) of a band's launch beside band_shape's, and
# the band walk's (S, warps)
BAND_SHAPES = ((4, 1), (4, 2), (4, 4), (4, 8), (8, 1), (8, 2), (8, 4), (8, 8),
               (16, 1), (16, 2), (16, 4), (16, 8))
BAND_WALKS = ((16, 1), (32, 1), (32, 2), (48, 2), (64, 2))


def elapsed_ms(fn, reps: int = 2) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def true_cells(n, d0, T, dev):
    """[T, n + 1] mask of the cells (i, j >= 1) of an n x n pair's matrix on
    diagonals [d0, d0 + T): the kernel writes backpointers nowhere else."""
    d = (d0 + torch.arange(T, device=dev))[:, None]
    j = torch.arange(n + 1, device=dev)[None, :]
    i = d - j
    return (i >= 1) & (i <= n) & (j >= 1)


def forward_table(dev, card, p):
    """The Forward of one pair at every launch shape, each several-blocks
    shape on both routes in turns, against one block a pair, beside the
    score-only sweep at the same shape."""
    for n in FORWARD_SIZES:
        rng = np.random.default_rng(1)
        a = torch.from_numpy(rng.integers(0, 183, (1, n)).astype(np.int32)).to(dev)
        b = torch.from_numpy(rng.integers(0, 4, (1, n)).astype(np.int32)).to(dev)
        lens = torch.full((1,), n, dtype=torch.int32, device=dev)
        args = (a, b, lens, lens, p.table, p.gap_consts)
        launch = launcher(1, n + 1, p)
        rule = wavefront_forward.forward_shape(1, n + 1, dev)
        want_adj, want = wavefront_forward.wavefront_forward(
            *args, k=1, launch=launch((1, 1024)))
        for threads in THREADS:
            for blocks in FORWARD_BLOCKS:
                shape = (blocks, threads)
                turns = TURNS if blocks > 1 else TURNS[:1]
                launches = {t: launch(shape, t) for t in turns}
                taken, verdicts = [], []
                for t in turns:
                    adj, mdi = wavefront_forward.wavefront_forward(
                        *args, k=1, launch=launches[t])
                    taken.append(label(launches[t], t))
                    verdicts.append(forward_verdict(mdi, adj, want, want_adj,
                                                    n, shape, taken[-1]))
                    del adj, mdi
                times = in_turns(turns, lambda t: wavefront_forward.wavefront_forward(
                    *args, k=1, launch=launches[t]))
                score = in_turns(turns, lambda t: wavefront_score.wavefront_score(
                    *args, k=1, launch=launches[t]))
                mark = " (forward_shape's choice)" if shape == rule else ""
                for t, name, verdict in zip(turns, taken, verdicts):
                    ms, sms = times[t], score[t]
                    print(f"[{card}] Forward 1 x {n} nt, {blocks} x {threads} "
                          f"threads{mark}, {name}: {verdict} one block a pair; "
                          f"{fmt(ms)} ms = {fmt(ms, 1e3 / (2 * n))} us a "
                          f"diagonal, {n * n / min(ms) / 1e6:.2f} Gcells/s; "
                          f"score-only sweep {fmt(sms)} ms = "
                          f"{fmt(sms, 1e3 / (2 * n))} us a diagonal", flush=True)
        del want, want_adj


def launcher(B, C, p):
    """launch(shape, several="bands", stamps=None): the sweep launch of B
    pairs of C slots at k = 1 with that (blocks, threads)."""
    def launch(shape, several="bands", stamps=None):
        return wavefront_segment.sweep_launch(B, C, 1, *shape, p.table.numel(),
                                              several=several, stamps=stamps)
    return launch


def forward_verdict(mdi, adj, want, want_adj, n, shape, name):
    if torch.equal(mdi, want) and torch.equal(adj, want_adj):
        return "equal to"
    diff = (mdi - want).abs()
    worst = float(diff.max())
    if bool((diff > FWD_ATOL + FWD_RTOL * want.abs()).any()):
        raise AssertionError(f"Forward {n} nt, {shape[0]} x {shape[1]} threads, "
                             f"{name}: differs from one block by {worst:.3e}")
    return f"within {worst:.3e} of"


def label(launch, several):
    """What a launch made with `several` takes."""
    if launch.route != "bands":
        if launch.blocks == 1 or several == launch.route:
            return launch.route
        return f"{launch.route} (the band route declined)"
    plan = launch.plan
    return (f"bands ({launch.blocks} of {plan.width} columns, "
            f"{plan.cells_a_thread} cells a thread)")


def in_turns(turns, fn):
    """{turn: [ms, ms]}: fn(turn) timed under each turn, then again in
    reverse order (old, new, new, old)."""
    times = {t: [] for t in turns}
    for t in [*turns, *reversed(turns)]:
        times[t].append(elapsed_ms(lambda: fn(t)))
    return times


def fmt(ms, scale=1.0):
    return " / ".join(f"{t * scale:.3f}" for t in ms)


def triplet_table(dev, card):
    """The triplet rows kernel at bands a pair x threads a band, each held
    to the result at the shape rows_shape picks on the pairs' own cells;
    then the walk (on the whole pairs) at columns a thread x threads a block
    (and windows, and bands), each held to walk_shape's."""
    model = triplet_hmm.build_triplet_model(alignment_params("tri-mg"))
    shapes = [(n, nt, seed, None) for n, nt, seed in TRIPLET_BATCHES]
    shapes.append((1, TRIPLET_MID_NT, 16, TRIPLET_LONG_STEPS))
    shapes.append((1, TRIPLET_LONG_NT, 13, TRIPLET_LONG_STEPS))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, nt, seed, steps in shapes:
        whole = make_pairs(n, np.random.default_rng(seed), length_mix=[(nt, 1.0)])
        pairs = whole
        if steps:  # the rows over the first codon steps of the ancestor against all of des
            pairs = [(a[:3 * steps], b) for a, b in pairs]
        tb = TripletBatch(model, pairs, dev)
        own = tb.true_cells()
        chosen = triplet_rows.rows_shape(tb.B, tb.Cc, dev)
        launches = [chosen, triplet_rows.rows_launch(
            tb.Cc, 1, triplet_rows.block_threads(tb.Cc))]
        for threads in TRIPLET_THREADS:
            room = sms * triplet_rows.blocks_per_sm(threads) // tb.B
            for bands in TRIPLET_BANDS:
                launch = triplet_rows.rows_launch(tb.Cc, bands, threads)
                if launch not in launches and launch.bands <= room:
                    launches.append(launch)

        def rows(launch):
            shape = (tb.n_cod + 1, 3, tb.B, tb.Cc)
            grid = torch.empty(shape, dtype=torch.float32, device=dev)
            amax = torch.empty(shape, dtype=torch.uint8, device=dev)
            grid[0], amax[0] = tb.init, 0
            triplet_rows.triplet_rows(*tb.rows_args(), tb.init, keep_grid=True,
                                      grid_out=grid[1:], amax_out=amax[1:], launch=launch)
            return grid, amax

        grid, amax = rows(chosen)
        want = (grid[own], amax[own])
        print(f"[{card}] triplet {n} x {nt} nt ({tb.n_cod} codon steps, {tb.Cc} "
              f"columns)", flush=True)
        if steps:  # the walk on the whole pair: the cut one starts with a long run
            tw_ = TripletBatch(model, whole, dev)
            gw, aw = rows_grid(tw_)
            print(f"[{card}]   the walk over all {tw_.n_cod} codon blocks", flush=True)
            walk_table(card, tw_, gw, aw, True)
            del gw, aw
        else:
            walk_table(card, tb, grid, amax, False)
        for launch in launches:
            got = rows(launch)
            if not (torch.equal(got[0][own], want[0]) and torch.equal(got[1][own], want[1])):
                raise AssertionError(f"triplet {n} x {nt} nt, {launch}: differs from "
                                     f"rows_shape's {chosen}")
            del got
            ms = elapsed_ms(lambda: rows(launch))
            mark = " (rows_shape's)" if launch == chosen else ""
            print(f"[{card}]   rows at {launch.bands} bands of {launch.width} columns x "
                  f"{launch.threads} threads{mark}: equal; {ms:.3f} ms = "
                  f"{ms / tb.n_cod * 1e3:.2f} us a codon step", flush=True)
        del grid, amax, want, own


def walkcells_table(dev, card):
    """The triplet walk at its three cells, by the package imported (see
    --root): the two batches whole, the 15,000 nt pair in the segments of
    its long route, mean of 3 after a warm-up (CUDA events); then the pair's
    alignpair wall, twice."""
    model = triplet_hmm.build_triplet_model(alignment_params("tri-mg"))
    cells = [(f"{n} x {nt} nt", make_pairs(n, np.random.default_rng(seed),
                                           length_mix=[(nt, 1.0)]), False)
             for n, nt, seed in TRIPLET_BATCHES]
    (a, b), = make_pairs(1, np.random.default_rng(13), length_mix=[(TRIPLET_LONG_NT, 1.0)])
    cells.append((f"one {len(a)} x {len(b)} nt pair", [(a, b)], True))
    for name, pairs, long in cells:
        tb = TripletBatch(model, pairs, dev)
        shape = (tb.n_cod + 1, 3, tb.B, tb.Cc)
        grid = torch.empty(shape, dtype=torch.float32, device=dev)
        amax = torch.empty(shape, dtype=torch.uint8, device=dev)
        grid[0], amax[0] = tb.init, 0
        triplet_rows.triplet_rows(*tb.rows_args(), tb.init, keep_grid=True,
                                  grid_out=grid[1:], amax_out=amax[1:])
        seg = tw.seg_cods_for(tb.Cc) if long else tb.n_cod
        spans = [(lo, min(seg, tb.n_cod - lo)) for lo in range(0, tb.n_cod, seg)]
        ms = elapsed_ms(lambda: tb.walk(triplet_walk.triplet_walk, grid, amax, spans), 3)
        print(f"[{card}] walkcells {name}: the walk {ms:.3f} ms over {len(spans)} "
              f"launch{'es' if len(spans) > 1 else ''} = {ms / tb.n_cod * 1e3:.2f} us a codon "
              f"block", flush=True)
        del grid, amax
    # the long pair end to end: alignpair -m tri-mg, twice (host clock)
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "pair.fasta"
        src.write_text(f">anc\n{a}\n>des\n{b}\n")
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            if cli.main(["alignpair", str(src), "-m", "tri-mg", "-o", str(Path(tmp) / "o.json")]):
                raise AssertionError("alignpair -m tri-mg failed")
            walls.append(time.perf_counter() - t0)
    print(f"[{card}] walkcells one {len(a)} x {len(b)} nt pair through alignpair -m tri-mg: "
          f"{' / '.join(f'{w:.3f}' for w in walls)} s wall", flush=True)


def walk_table(card, tb, grid, amax, windows):
    """The triplet walk over a batch's codon blocks at walk_shape's launch,
    then at every columns a thread x threads a block it takes (at that
    window), and with `windows` at WALK_WINDOWS too: each equal in state and
    op rows to walk_shape's, timed."""
    whole = [(0, tb.n_cod)]
    chosen = triplet_walk.walk_shape(tb.B, tb.Cc, tb.dev)
    launches = [chosen]
    for cols in triplet_walk.COLS:
        for threads in WALK_THREADS:
            if threads > (triplet_walk.THREADS // 2 if cols == 8 else triplet_walk.THREADS):
                continue
            launch = triplet_walk.walk_launch(tb.Cc, cols, threads, chosen.window)
            if launch not in launches:
                launches.append(launch)
    if windows:
        launches += [triplet_walk.walk_launch(tb.Cc, chosen.cols, chosen.threads, w)
                     for w in WALK_WINDOWS]
    # the band route: bands of one pass, a cluster of 2-8 blocks a pair, where
    # every pair's bands fit the SMs at once
    sms = torch.cuda.get_device_properties(tb.dev).multi_processor_count
    for cols in triplet_walk.COLS:
        for threads in WALK_THREADS:
            bands = -(-tb.Cc // (cols * threads))
            if (2 <= bands <= triplet_walk.MAX_BANDS and tb.B * bands <= sms
                    and threads <= (triplet_walk.THREADS // 2 if cols == 8
                                    else triplet_walk.THREADS)):
                launch = triplet_walk.walk_launch(tb.Cc, cols, threads, bands=bands)
                if launch not in launches:
                    launches.append(launch)

    def walk(launch):
        return tb.walk(functools.partial(triplet_walk.triplet_walk, launch=launch),
                       grid, amax, whole)

    want = walk(chosen)
    blocks = int(((want[1].reshape(-1, 6, tb.B) >> 2).sum(axis=1) > 0).sum())
    # where a block's time goes at walk_shape's launch: the kernel's clock stamps
    stamps = torch.zeros((tb.B, tb.n_cod, 5), dtype=torch.int64, device=tb.dev)
    tb.walk(functools.partial(triplet_walk.triplet_walk, launch=chosen, stamps=stamps),
            grid, amax, whole)
    s = stamps.cpu().numpy().astype(np.float64)
    act = s[:, :, 0] != 0
    d = np.diff(s, axis=2)[act].mean(axis=0)
    gap = (s[:, :-1, 0] - s[:, 1:, 4])[act[:, :-1] & act[:, 1:]].mean()
    print(f"[{card}]   walk_shape's {chosen}: SM cycles a block (mean over {int(act.sum())} "
          f"active blocks): to the first row's end {d[0]:.0f}, the rest of the passes "
          f"{d[1]:.0f}, to the walk {d[2]:.0f}, the walk {d[3]:.0f}, the walk's end to the "
          f"next block {gap:.0f}", flush=True)
    for launch in launches:
        got = walk(launch)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"triplet walk at {launch}: differs from walk_shape's "
                                 f"{chosen}")
        ms = elapsed_ms(lambda: walk(launch))
        mark = " (walk_shape's)" if launch == chosen else ""
        passes = -(-tb.Cc // (launch.cols * launch.threads))
        how = (f"{launch.bands} bands" if launch.bands > 1 else
               f"a full row {passes} pass{'es' if passes > 1 else ''}")
        print(f"[{card}]   walk at {launch.cols} columns x {launch.threads} threads "
              f"({how}), a window of "
              f"{launch.window}{' and the scratch' if launch.scratch(tb.Cc) else ''}"
              f"{mark}: equal; {ms:.3f} ms = {ms / tb.n_cod * 1e3:.2f} us a codon block "
              f"({blocks} active blocks over the pairs)", flush=True)


def samplewalk_table(dev, card):
    """The sample walk at S steps a window x warps a block, and at one
    thread a sample (S = 0, the body before windows), on the matrices and
    uniforms of the sample verb at 9,999 nt x 200 samples (chip_smoke.py's
    cell), each held op for op and score for score to walk_shape's."""
    seen = {}
    real = sample_walk.sample_walk

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.setdefault("walk", (args, kw["k"], out))
        return out

    nt, n, seed = SAMPLE_RUNS[0]
    with tempfile.TemporaryDirectory() as tmp, wrappers({"sample_walk": spy}):
        run_sample(dev, card, tmp, nt, n, seed)
    args, k, want = seen.pop("walk")
    steps = int((want[0] >= 0).sum())
    chosen = sample_walk.walk_shape(k)
    print(f"[{card}] sample walk, {nt} nt x {n} samples, k={k}: {steps} steps, "
          f"walk_shape {chosen}", flush=True)
    for S, warps in SAMPLE_SHAPES:
        got = real(*args, k=k, S=S, warps=warps)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"sample walk S={S} x {warps}: differs from "
                                 f"walk_shape's {chosen}")
        ms = elapsed_ms(lambda: real(*args, k=k, S=S, warps=warps), 5)
        mark = " (walk_shape's)" if (S, warps) == chosen else ""
        what = "one thread a sample" if S == 0 else f"S={S} x {warps} warps a block"
        print(f"[{card}]   {what}{mark}: equal; {ms:.3f} ms = "
              f"{ms * 1e6 / (steps / n):.1f} ns a step", flush=True)


def main(argv=None) -> int:
    names = {"segment", "forward", "triplet", "fill", "score", "segwalk", "samplewalk",
             "band"}
    tables = set(sys.argv[1:] if argv is None else argv) or names
    if tables - names - {"walkcells"}:
        raise SystemExit("sweep_shapes: tables are " + ", ".join(sorted(names | {"walkcells"})))
    if not torch.cuda.is_available():
        raise SystemExit("sweep_shapes: needs a CUDA device")
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    if "band" in tables:
        band_table(dev, card)
    if "score" in tables:
        score_table(dev, card)
    if "segwalk" in tables:
        segwalk_table(dev, card)
    if "fill" in tables:
        fill_table(dev, card)
    if "triplet" in tables:
        triplet_table(dev, card)
    if "walkcells" in tables:
        walkcells_table(dev, card)
    if "samplewalk" in tables:
        samplewalk_table(dev, card)
    if "segment" in tables:
        segment_table(dev, card)
    if "forward" in tables:
        aln = alignment_params()
        forward_table(dev, card, params_from_numpy(aln.subst_matrix, aln.gap, dev))
    return 0


def segment_table(dev, card):
    """The segment kernel at every launch shape, each several-blocks shape on
    both routes in turns, against one block a pair; then the band route's
    skew at the chosen shape, and the chosen shape's score-only sweep."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    aln = alignment_params()
    p = params_from_numpy(aln.subst_matrix, aln.gap, dev)
    for n, B in SIZES:
        rng = np.random.default_rng(0)
        a = torch.from_numpy(rng.integers(0, 183, (B, n)).astype(np.int32)).to(dev)
        b = torch.from_numpy(rng.integers(0, 4, (B, n)).astype(np.int32)).to(dev)
        lens = torch.full((B,), n, dtype=torch.int32, device=dev)
        args = (a, b, lens, lens, p.table, p.gap_consts)
        d0 = n - SEGMENT // 2
        mask = true_cells(n, d0, SEGMENT, dev)
        launch = launcher(B, n + 1, p)
        chosen = wavefront_segment.sweep_shape(B, n + 1, dev)

        def segment(carry, lnch, want_carry=True):
            return wavefront_segment.wavefront_segment(
                *args, carry, d0, k=1, n_steps=SEGMENT, want_bp=True,
                want_carry=want_carry, launch=lnch)

        # the carry entering diagonal d0, swept with the chosen shape
        _, _, carry = wavefront_segment.wavefront_segment(
            *args, wavefront_segment.empty_carry(B, n + 1, 1, dev), 0, k=1,
            n_steps=d0, want_bp=False)
        _, want_bp, (want_ring, want_corners) = segment(carry, launch((1, 1024)))
        want_bp = want_bp[:, mask]
        for threads in THREADS:
            for blocks in BLOCKS:
                if blocks * B > sms:
                    continue
                turns = TURNS if blocks > 1 else TURNS[:1]
                launches = {t: launch((blocks, threads), t) for t in turns}
                taken = []
                for t in turns:
                    _, bp, (ring, corners) = segment(carry, launches[t])
                    taken.append(label(launches[t], t))
                    if not (torch.equal(bp[:, mask], want_bp)
                            and torch.equal(ring, want_ring)
                            and torch.equal(corners, want_corners)):
                        raise AssertionError(
                            f"{B} x {n} nt, {blocks} x {threads} threads a pair, "
                            f"{taken[-1]}: differs from one block of 1,024 "
                            f"threads a pair")
                    del bp, ring, corners
                times = in_turns(turns, lambda t: segment(carry, launches[t],
                                                          want_carry=False))
                for t, name in zip(turns, taken):
                    print(f"[{card}] {B} x {n} nt, {blocks} x {threads} threads a "
                          f"pair, {name}: bit-equal to one block a pair; segment "
                          f"with bp {fmt(times[t])} ms = "
                          f"{fmt(times[t], 1e3 / SEGMENT)} us a diagonal",
                          flush=True)
        skew_line(card, dev, B, n, d0, launch, chosen,
                  lambda lnch: segment(carry, lnch, want_carry=False))
        del want_bp, want_ring, want_corners, carry
        ms = elapsed_ms(lambda: wavefront_score.wavefront_score(
            *args, k=1, launch=launch(chosen)))
        print(f"[{card}] {B} x {n} nt, chosen {chosen[0]} x {chosen[1]}, "
              f"{launch(chosen).route}: score-only sweep "
              f"{ms:.1f} ms = {B * n * n / ms / 1e6:.2f} Gcells/s, "
              f"{ms / (2 * n) * 1e3:.2f} us a diagonal", flush=True)


def skew_line(card, dev, B, n, d0, launch, shape, run):
    """The band route at the chosen shape with per-block timer stamps: the
    first and the last band of pair 0, from the launch's first block entry
    to their first cell and to their exit, and each one's pace. The last
    band's first cell lies (j0 - d0) diagonals in; what it waited beyond
    that many diagonals at its own pace is the pipeline's fill, about
    (bands - 1) hops."""
    plain = launch(shape)
    if plain.route != "bands":
        return
    run(plain)
    n_b = plain.blocks
    stamps = torch.full((3 * B * n_b,), -1, dtype=torch.int64, device=dev)
    run(launch(shape, stamps=stamps))
    torch.cuda.synchronize()
    st = stamps.view(B * n_b, 3).cpu()
    t0 = int(st[:, 0].min())
    first, last = st[0].tolist(), st[n_b - 1].tolist()
    d_end = d0 + SEGMENT - 1

    def pace(stamp, j0, j1):  # ns a diagonal over the band's diagonals here
        n_diag = min(d_end, j1 - 1 + n) - max(d0, j0) + 1
        return (stamp[2] - stamp[1]) / max(1, n_diag - 1)

    (f0, f1), (l0, l1) = plain.plan.bands[0], plain.plan.bands[-1]
    p_first, p_last = pace(first, f0, f1), pace(last, l0, l1)
    late = max(0, l0 - d0)
    fill = (last[1] - t0) - late * p_last
    print(f"[{card}] {B} x {n} nt, chosen {n_b} bands of {plain.plan.width} x "
          f"{plain.threads} threads: first band's first "
          f"cell {(first[1] - t0) / 1e3:.1f} us, exit {(first[2] - t0) / 1e3:.1f} us, "
          f"pace {p_first:.0f} ns a diagonal; last band's first cell (diagonal "
          f"{d0 + late}, {late} in) {(last[1] - t0) / 1e3:.1f} us, exit "
          f"{(last[2] - t0) / 1e3:.1f} us, pace {p_last:.0f} ns a diagonal; so the "
          f"last waited {fill / 1e3:.1f} us beyond its pace = "
          f"{fill / max(1, n_b - 1):.0f} ns a hop", flush=True)


def bucket_chunks(dev, p):
    """(name, k, args): the B = 64 cell (random codes, as chip_smoke.py
    makes it), one launch of each bucket of the main path's mix (the pairs
    chip_smoke.py aligns, seed 0, as many as the engine puts in a launch),
    and k = 3 at 471 nt."""
    rng = np.random.default_rng(1)
    la = rng.integers(200, 334, 64) * 3
    lb = rng.integers(600, 1000, 64)
    a = [rng.integers(0, 183, n).astype(np.int32) for n in la]
    b = [rng.integers(0, 4, n).astype(np.int32) for n in lb]
    out = [("B=64 cell, 600-999 nt", 1, a, b)]
    pairs = make_pairs(10_000, np.random.default_rng(0), length_mix=LENGTH_MIX)
    for nt, _ in LENGTH_MIX:
        enc = [encode_marginal(x, y) for x, y in pairs if len(x) == nt]
        q = -(-nt // 96) * 96
        max_b = max(1, (1 << 30) // ((q + 1) * (q + 1)))
        enc = enc[:max_b]
        out.append((f"{nt} nt bucket, one launch", 1, [e[0] for e in enc],
                    [e[1] for e in enc]))
    enc = [encode_marginal(x, y) for x, y in pairs if len(x) == 471][:256]
    out.append(("471 nt, k=3 (every length a multiple of 9 and 3)", 3,
                [e[0][: len(e[0]) // 9 * 9] for e in enc],
                [e[1][: len(e[1]) // 3 * 3] for e in enc]))
    for name, k, aa, bb in out:
        aseq, bseq, la, lb = _pad_batch(aa, bb, 96)
        args = [torch.from_numpy(x).to(dev) for x in (aseq, bseq, la, lb)]
        yield name, k, (*args, p.table, p.gap_consts), int((la + lb).max())


def fill_table(dev, card):
    aln = alignment_params()
    p = params_from_numpy(aln.subst_matrix, aln.gap, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    walk_args = []
    for name, k, args, steps in bucket_chunks(dev, p):
        if k != 1:
            p3 = params_from_numpy(alignment_params(gap_len=k).subst_matrix,
                                   alignment_params(gap_len=k).gap, dev)
            args = (*args[:4], p3.table, p3.gap_consts)
        B, C = args[0].shape[0], args[1].shape[1] + k
        rule = wavefront_fill.fill_shape(B, C, k, args[4].numel(), sms)
        want_c, want = wavefront_fill.wavefront_fill(*args, k=k, launch=rule)
        mask = wavefront_fill.true_cells(args[2], args[3], k, *want.shape[1:])
        print(f"[{card}] fill, {name}: B={B} C={C} k={k}; fill_shape: W={rule.W} "
              f"x {rule.warps} warps x {rule.pairs} pairs, {rule.passes} passes",
              flush=True)
        for W, warps in FILL_SHAPES:
            for pairs in FILL_PAIRS:
                try:
                    launch = wavefront_fill.fill_launch(B, C, k, W, warps, pairs,
                                                        table_len=args[4].numel())
                except ValueError as e:
                    print(f"[{card}]   W={W} x {warps} warps x {pairs} pairs: "
                          f"not taken ({e})", flush=True)
                    continue
                got_c, got = wavefront_fill.wavefront_fill(*args, k=k, launch=launch)
                same = (torch.equal(got[mask], want[mask])
                        and all(torch.equal(x, y) for x, y in zip(got_c, want_c)))
                if not same:
                    raise AssertionError(f"fill {name} W={W} x {warps} x {pairs}: "
                                         f"differs from fill_shape's launch")
                del got
                ms = elapsed_ms(lambda: wavefront_fill.wavefront_fill(
                    *args, k=k, launch=launch), 5)
                mark = " (fill_shape's choice)" if launch == rule else ""
                print(f"[{card}]   W={W} x {warps} warps x {pairs} pairs, "
                      f"{launch.passes} passes{mark}: equal; {ms:.4f} ms", flush=True)
        rule_ms = elapsed_ms(lambda: wavefront_fill.wavefront_fill(*args, k=k), 5)
        print(f"[{card}]   fill_shape's launch: {rule_ms:.4f} ms", flush=True)
        if k == 1 and (name.startswith("B=64") or name.startswith("1500")):
            walk_args.append((name, args, want_c, want, steps))
        del want
    lone_table(dev, card, p, sms)
    for name, args, corners, bp, steps in walk_args:
        ref, ref_score = traceback_walk.traceback_walk(bp, corners, args[2], args[3],
                                                       k=1, max_steps=steps)
        for S in WALK_S:
            for warps in WALK_WARPS:
                if warps * traceback_walk.window_bytes(1, S) > traceback_walk.SMEM_BYTES:
                    continue
                run = lambda: traceback_walk.traceback_walk(  # noqa: E731
                    bp, corners, args[2], args[3], k=1, max_steps=steps, S=S,
                    warps=warps)
                ops, score = run()
                if not (torch.equal(ops, ref) and torch.equal(score, ref_score)):
                    raise AssertionError(f"walk {name} S={S} x {warps}: differs")
                mark = (" (the default)" if (S, warps) == (
                    traceback_walk.window_steps(1), traceback_walk.WALK_WARPS) else "")
                print(f"[{card}] walk, {name}: S={S} x {warps} warps a block{mark}, "
                      f"cp.async: equal; {elapsed_ms(run, 5):.4f} ms, "
                      f"{int((ref >= 0).sum(0).max())} steps the longest walk",
                      flush=True)


def lone_table(dev, card, p, sms):
    """Lone mid-size pairs: the fill kernel over several blocks a pair, and
    the sweep's band route, fill and walk together; ops and scores equal."""
    for n, B in LONE:
        rng = np.random.default_rng(n + B)
        a = torch.from_numpy(rng.integers(0, 183, (B, n)).astype(np.int32)).to(dev)
        b = torch.from_numpy(rng.integers(0, 4, (B, n)).astype(np.int32)).to(dev)
        lens = torch.full((B,), n, dtype=torch.int32, device=dev)
        args = (a, b, lens, lens, p.table, p.gap_consts)
        C = n + 1
        rule = wavefront_fill.fill_shape(B, C, 1, p.table.numel(), sms)

        def strips(launch=None):
            corners, bp = wavefront_fill.wavefront_fill(*args, k=1, launch=launch)
            return traceback_walk.traceback_walk(bp, corners, lens, lens, k=1,
                                                 max_steps=2 * n)

        def bands():
            return _sweep_align_ops(*args, k=1, max_steps=2 * n)

        want = bands()
        got = strips()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"lone {B} x {n} nt: strips and bands differ")
        del got
        shape = wavefront_segment.sweep_shape(B, C, dev)
        t_bands = [elapsed_ms(bands), elapsed_ms(bands)]
        t_rule = [elapsed_ms(strips), elapsed_ms(strips)]
        print(f"[{card}] lone {B} x {n} nt, fill + walk: fill_shape W={rule.W} x "
              f"{rule.warps} warps x {rule.blocks} blocks {fmt(t_rule)} ms; band "
              f"route ({shape[0]} blocks of {shape[1]} threads) {fmt(t_bands)} ms; "
              f"equal ops and scores", flush=True)
        for W, warps in LONE_SHAPES:
            n_st = wavefront_fill.stripes(C, W)
            blocks = min(-(-n_st // warps), sms // B)
            launch = wavefront_fill.fill_launch(B, C, 1, W, warps, 1, blocks)
            ms = elapsed_ms(lambda: wavefront_fill.wavefront_fill(
                *args, k=1, launch=launch))
            print(f"[{card}]   fill alone, W={W} x {warps} warps x {blocks} "
                  f"blocks, {launch.passes} passes: {ms:.2f} ms", flush=True)


def long_cases():
    """(name, encoded ancestors, descendants): the four 29-32 knt pairs of
    chip_smoke.py's long phase (seed 1) and its 160,002 nt pair (seed 3)."""
    for name, pairs in (
            (f"{N_LONG} x 29-32 knt", make_pairs(N_LONG, np.random.default_rng(1),
                                                 length_mix=LONG_MIX)),
            (f"1 x {LONGPAIR_NT} nt", make_pairs(1, np.random.default_rng(3),
                                                 length_mix=[(LONGPAIR_NT, 1.0)]))):
        enc = [encode_marginal(a, b) for a, b in pairs]
        yield name, [e[0] for e in enc], [e[1] for e in enc]


def score_table(dev, card):
    """Score-only Viterbi: the strip route (score_shape's launch and others)
    against the sweep's (sweep_shape's: one block a pair, or bands), each
    strip launch held bit-equal to the sweep's corners: the B = 64 cell, one
    launch of each bucket of the main path's mix and k = 3 (bucket_chunks),
    lone pairs of 8,000 and 16,000 nt (and two of 16,000), the four 29-32
    knt pairs as viterbi_scores_batch pads them, and the 160,002 nt pair. score_shape's launch and the sweep in turns (strips,
    sweep, sweep, strips); CUDA events, mean of 2 launches after a warm-up."""
    aln = alignment_params()
    p = params_from_numpy(aln.subst_matrix, aln.gap, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, k, args, _ in bucket_chunks(dev, p):
        if k != 1:
            pk = params_from_numpy(alignment_params(gap_len=k).subst_matrix,
                                   alignment_params(gap_len=k).gap, dev)
            args = (*args[:4], pk.table, pk.gap_consts)
        score_row(dev, card, name, k, args, sms, SCORE_SHAPES)
    for n, B in LONE:
        rng = np.random.default_rng(n + B)
        a = torch.from_numpy(rng.integers(0, 183, (B, n)).astype(np.int32)).to(dev)
        b = torch.from_numpy(rng.integers(0, 4, (B, n)).astype(np.int32)).to(dev)
        lens = torch.full((B,), n, dtype=torch.int32, device=dev)
        score_row(dev, card, f"lone {B} x {n} nt", 1, (a, b, lens, lens, p.table,
                                                        p.gap_consts), sms, SCORE_SPREAD)
    for name, enc_as, enc_bs in long_cases():
        aseq, bseq, la, lb = _pad_batch(enc_as, enc_bs, 96)
        args = [torch.from_numpy(x).to(dev) for x in (aseq, bseq, la, lb)]
        score_row(dev, card, name, 1, (*args, p.table, p.gap_consts), sms,
                  SCORE_SPREAD)


def score_row(dev, card, name, k, args, sms, shapes):
    B, C = args[0].shape[0], args[1].shape[1] + k
    table_len = args[4].numel()
    rule = wavefront_score.score_shape(B, C, k, table_len, sms)
    sweep_shape = wavefront_segment.sweep_shape(B, C, dev)
    sweep = wavefront_segment.sweep_launch(B, C, k, *sweep_shape, table_len)
    launches = {"strips": rule, "sweep": sweep}

    def run(launch):
        return wavefront_score.wavefront_score(*args, k=k, launch=launch)

    want = run(sweep)
    if not torch.equal(run(rule), want):
        raise AssertionError(f"score {name}: score_shape's strips differ from the sweep")
    times = in_turns(("strips", "sweep"), lambda t: run(launches[t]))
    print(f"[{card}] score, {name}: B={B} C={C} k={k}; score_shape W={rule.W} x "
          f"{rule.warps} warps x {rule.pairs} pairs x {rule.blocks} blocks, "
          f"{rule.passes} passes: {fmt(times['strips'])} ms; sweep {sweep.route} "
          f"({sweep.blocks} x {sweep.threads} threads a pair): {fmt(times['sweep'])} "
          f"ms; bit-equal", flush=True)
    for W, warps in shapes:
        blocks = 1
        if rule.blocks > 1:
            blocks = min(-(-wavefront_fill.stripes(C, W) // warps), max(1, sms // B))
        try:
            launch = wavefront_fill.fill_launch(
                B, C, k, W, warps, 1, blocks, table_len=table_len,
                widths=wavefront_fill.SCORE_WIDTHS)
        except ValueError as e:
            print(f"[{card}]   W={W} x {warps} warps x {blocks} blocks: not taken "
                  f"({e})", flush=True)
            continue
        if launch == rule:
            continue
        if not torch.equal(run(launch), want):
            raise AssertionError(f"score {name} W={W} x {warps} x {blocks}: differs "
                                 f"from the sweep")
        print(f"[{card}]   W={W} x {warps} warps x {blocks} blocks, {launch.passes} "
              f"passes: bit-equal; {elapsed_ms(lambda: run(launch)):.3f} ms", flush=True)


def segwalk_table(dev, card):
    """The segment walk at S steps a window and warps a block: the middle
    segment of the four 29-32 knt pairs' group and of the 160,002 nt pair,
    as the long path cuts them (its backpointers recomputed from the carry
    of a score-only sweep down to it), each pair's walk entering at the
    segment's top near the main diagonal; every S equal op for op and state
    for state to the plain walk. CUDA events, mean of 5 launches after a
    warm-up."""
    aln = alignment_params()
    p = params_from_numpy(aln.subst_matrix, aln.gap, dev)
    k = 1
    for name, enc_as, enc_bs in long_cases():
        aseq, bseq, la, lb = longseq._pad_group(enc_as, enc_bs)
        a, b, tla, tlb = (torch.from_numpy(x).to(dev) for x in (aseq, bseq, la, lb))
        args = (a, b, tla, tlb, p.table, p.gap_consts)
        B, NA = aseq.shape
        C = bseq.shape[1] + k
        Dtot = NA + bseq.shape[1] + 2 * k - 1
        T = min(Dtot, longseq.seg_diagonals_for(B, C))
        d0 = (-(-Dtot // T)) // 2 * T
        _, _, carry = wavefront_segment.wavefront_segment(
            *args, wavefront_segment.empty_carry(B, C, k, dev), 0, k=k, n_steps=d0,
            want_bp=False)
        _, bp, _ = wavefront_segment.wavefront_segment(
            *args, carry, d0, k=k, n_steps=T, want_bp=True, want_carry=False)
        del carry
        d_top = d0 + T - 1
        j0 = torch.minimum(torch.full_like(tlb, d_top // 2), tlb + (k - 1))
        entry = torch.stack([d_top - j0, j0, torch.zeros_like(j0), torch.zeros_like(j0)])

        def walk(fn, **kw):
            st = entry.clone()
            ops = torch.full((T, B), -1, dtype=torch.int8, device=dev)
            fn(bp, d0, st, ops, k=k, **kw)
            return st, ops

        want_st, want_ops = walk(walk_segment_plain)
        steps = int((want_ops >= 0).sum())
        longest = int((want_ops >= 0).sum(0).max())
        print(f"[{card}] segment walk, {name}: B={B} C={C} d0={d0} T={T}, {steps} "
              f"steps over the pairs", flush=True)
        for S in SEGWALK_S:
            for warps in SEGWALK_WARPS:
                got_st, got_ops = walk(traceback_walk.walk_segment, S=S, warps=warps)
                if not (torch.equal(got_st, want_st) and torch.equal(got_ops, want_ops)):
                    raise AssertionError(f"segment walk {name} S={S} x {warps}: "
                                         f"differs from the plain walk")
                mark = (" (the default)" if (S, warps) == (
                    traceback_walk.segment_window_steps(k), traceback_walk.WALK_WARPS)
                    else "")
                ms = elapsed_ms(lambda: walk(traceback_walk.walk_segment, S=S,
                                             warps=warps), 5)
                print(f"[{card}]   S={S} x {warps} warps a block{mark}: equal; "
                      f"{ms:.4f} ms = {ms * 1e6 / longest:.0f} ns a step of the "
                      f"longest walk's {longest}", flush=True)
        del bp


def band_table(dev, card):
    """The long path's passes on strips at the two long cases (see the
    module's docstring)."""
    aln = alignment_params()
    p = params_from_numpy(aln.subst_matrix, aln.gap, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k = 1
    for name, enc_as, enc_bs in long_cases():
        aseq, bseq, la, lb = longseq._pad_group(enc_as, enc_bs)
        a, b, tla, tlb = (torch.from_numpy(x).to(dev) for x in (aseq, bseq, la, lb))
        args = (a, b, tla, tlb, p.table, p.gap_consts)
        B, NA = aseq.shape
        C = bseq.shape[1] + k
        Cp = wavefront_fill.row_stride(C)
        H = longseq.band_rows_for(B, Cp, k)
        top = (int(la.max()) + k - 1) // H
        mid = top // 2
        rule = wavefront_score.score_shape(B, C, k, p.table.numel(), sms)

        def runs(turn):
            if turn == "ckpt":
                return wavefront_score.wavefront_score_ckpt(*args, k=k, band_rows=H,
                                                            n_ckpt=top)
            return wavefront_score.wavefront_score(*args, k=k)

        adj, ckpt = runs("ckpt")
        if not torch.equal(adj, runs("score")):
            raise AssertionError(f"band {name}: pass 1's corners differ from the score kernel's")
        times = in_turns(("ckpt", "score"), runs)
        print(f"[{card}] band, {name}: B={B} C={C} Cp={Cp}, {top + 1} bands of {H} rows; "
              f"pass 1 at score_shape W={rule.W} x {rule.warps} warps x {rule.blocks} "
              f"blocks {fmt(times['ckpt'])} ms, the score kernel alone "
              f"{fmt(times['score'])} ms; corners bit-equal", flush=True)

        # the walk's state entering the middle band: the real walk down to it
        state = torch.empty((4, B), dtype=torch.int32, device=dev)
        ops = torch.full((NA + bseq.shape[1], B), -1, dtype=torch.int8, device=dev)
        for band in range(top, mid, -1):
            bp = wavefront_fill.wavefront_fill_band(*args, ckpt[band - 1] if band else None,
                                                    k=k, row0=band * H, band_rows=H)
            traceback_walk.walk_band(bp, band * H, state, ops, k=k,
                                     start=(adj, tla, tlb) if band == top else None)
        del bp
        entry = state.clone()
        r0 = mid * H
        ck = ckpt[mid - 1] if mid else None
        default = wavefront_fill.band_shape(B, C, k, p.table.numel(), sms)
        want = wavefront_fill.wavefront_fill_band(*args, ck, k=k, row0=r0, band_rows=H)
        i = (r0 + torch.arange(H, device=dev))[None, :, None]
        j = torch.arange(Cp, device=dev)[None, None, :]
        mask = ((i >= k) & (i < (tla.long() + k)[:, None, None]) & (j >= k)
                & (j < (tlb.long() + k)[:, None, None]))
        want_true = want[mask]
        del want
        for W, warps in BAND_SHAPES:
            n = wavefront_fill.stripes(C, W)
            blocks = max(1, min(-(-n // warps), sms // B))
            try:
                launch = wavefront_fill.fill_launch(B, C, k, W, warps, 1, blocks,
                                                    table_len=p.table.numel())
            except ValueError as e:
                print(f"[{card}]   W={W} x {warps} warps: not taken ({e})", flush=True)
                continue

            def run(launch=launch):
                return wavefront_fill.wavefront_fill_band(*args, ck, k=k, row0=r0,
                                                          band_rows=H, launch=launch)

            if not torch.equal(run()[mask], want_true):
                raise AssertionError(f"band {name} W={W} x {warps}: differs from "
                                     f"band_shape's launch")
            mark = " (band_shape's)" if launch == default else ""
            print(f"[{card}]   band {mid} (rows {r0}-{r0 + H - 1}), W={W} x {warps} "
                  f"warps x {blocks} blocks, {launch.passes} passes{mark}: bit-equal; "
                  f"{elapsed_ms(run):.2f} ms", flush=True)

        bp = wavefront_fill.wavefront_fill_band(*args, ck, k=k, row0=r0, band_rows=H)

        def walk(S=None, warps=traceback_walk.WALK_WARPS):
            st = entry.clone()
            o = ops.clone()
            traceback_walk.walk_band(bp, r0, st, o, k=k, S=S, warps=warps)
            return st, o

        want_st, want_ops = walk()
        steps = int((want_st[3] - entry[3]).max())
        for S, warps in BAND_WALKS:
            got = walk(S, warps)
            if not (torch.equal(got[0], want_st) and torch.equal(got[1], want_ops)):
                raise AssertionError(f"band walk {name} S={S} x {warps}: differs")
            mark = (" (the default)" if (S, warps) == (
                traceback_walk.window_steps(k), traceback_walk.WALK_WARPS) else "")
            print(f"[{card}]   band walk S={S} x {warps} warps a block{mark}: equal; "
                  f"{elapsed_ms(lambda: walk(S, warps), 5):.4f} ms, {steps} steps the "
                  f"longest walk in the band", flush=True)
        del bp, ckpt

        def whole():
            return longseq.align_long_group(*args, k=k, host_lens=(la, lb))

        whole()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with KernelTimer(dev) as timer:
            whole()
        wall = time.perf_counter() - t0
        parts = {n: (timer.count(n), timer.seconds(n) * 1e3)
                 for n in ("wavefront_score_ckpt", "wavefront_fill_band",
                           "traceback_walk_band")}
        print(f"[{card}] band, {name}: align_long_group {wall * 1e3:.1f} ms wall; "
              + "; ".join(f"{n} {ms:.1f} ms over {c}" for n, (c, ms) in parts.items()),
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
