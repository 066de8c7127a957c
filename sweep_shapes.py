#!/usr/bin/env python3
"""Time the port's sweep kernel (coati_tpu_torch/csrc/wavefront_segment.cu)
at several launch shapes, on its two several-blocks routes in turns, and
hold every shape to the one-block result.

    python3 sweep_shapes.py [segment] [forward] [triplet]
                                 # from the repository root; needs one card;
                                 # no argument: all three tables

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

Last the two triplet kernels (csrc/triplet_rows.cu, csrc/triplet_walk.cu),
which sweep a row one column a thread, a tile of the block's threads at a
time: the two tri-mg batches chip_smoke.py aligns and the first 512 codon
steps of its long pair, with blocks of 128 to 512 threads (the most the
kernels are compiled for), each held equal to the 512-thread result on the
pairs' own cells and op rows.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    TRIPLET_BATCHES,
    TRIPLET_LONG_NT,
    TripletBatch,
    make_pairs,
)
from coati_tpu_torch import triplet_hmm  # noqa: E402
from coati_tpu_torch import triplet_wavefront as tw  # noqa: E402
from coati_tpu_torch.kernels import (  # noqa: E402
    triplet_rows,
    triplet_walk,
    wavefront_forward,
    wavefront_score,
    wavefront_segment,
)
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
TRIPLET_THREADS = (512, 256, 128)  # the first is what the rest is held to
TRIPLET_LONG_STEPS = 512  # codon steps of the long pair that are swept


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
    """The triplet rows and walk kernels with blocks of 128 to 512 threads (8
    to 2 tiles a 1,000-column row), each held to the result at 512, the
    wrappers' own choice (kernels/triplet_rows.py THREADS, which both take)."""
    model = triplet_hmm.build_triplet_model(alignment_params("tri-mg"))
    shapes = [(n, nt, seed, None) for n, nt, seed in TRIPLET_BATCHES]
    shapes.append((1, TRIPLET_LONG_NT, 13, TRIPLET_LONG_STEPS))
    chosen = triplet_rows.THREADS
    for n, nt, seed, steps in shapes:
        pairs = make_pairs(n, np.random.default_rng(seed), length_mix=[(nt, 1.0)])
        if steps:  # the first codon steps of the ancestor against all of des
            pairs = [(a[:3 * steps], b) for a, b in pairs]
        tb = TripletBatch(model, pairs, dev)
        own = tb.true_cells()
        whole = [(0, tb.n_cod)]
        want = None
        try:
            for threads in TRIPLET_THREADS:
                triplet_rows.THREADS = threads
                grid, amax = tw._triplet_rows(*tb.rows_args())
                state, ops = tb.walk(triplet_walk.triplet_walk, grid, amax, whole)
                got = (grid[own], amax[own], state, ops)
                if want is None:
                    want = got
                elif not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"triplet {n} x {nt} nt, {threads} threads: "
                                         f"differs from {TRIPLET_THREADS[0]} threads")
                rows_ms = elapsed_ms(lambda: tw._triplet_rows(*tb.rows_args()))
                walk_ms = elapsed_ms(lambda: tb.walk(triplet_walk.triplet_walk,
                                                     grid, amax, whole))
                block = triplet_rows.block_threads(tb.Cc)
                tiles = -(-tb.Cc // block)
                print(f"[{card}] triplet {n} x {nt} nt ({tb.n_cod} codon steps, "
                      f"{tb.Cc} columns), {block} threads a block = {tiles} "
                      f"tiles a row: equal to {TRIPLET_THREADS[0]} threads; rows "
                      f"{rows_ms:.3f} ms = {rows_ms / tb.n_cod / tiles * 1e3:.2f} us a "
                      f"step and tile, walk {walk_ms:.3f} ms = "
                      f"{walk_ms / tb.n_cod * 1e3:.2f} us a block", flush=True)
                del grid, amax, got
        finally:
            triplet_rows.THREADS = chosen
        del want, own


def main(argv=None) -> int:
    tables = set(sys.argv[1:] if argv is None else argv) or {"segment", "forward", "triplet"}
    if tables - {"segment", "forward", "triplet"}:
        raise SystemExit("sweep_shapes: tables are segment, forward, triplet")
    if not torch.cuda.is_available():
        raise SystemExit("sweep_shapes: needs a CUDA device")
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    if "triplet" in tables:
        triplet_table(dev, card)
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
        ms = elapsed_ms(lambda: wavefront_score.wavefront_score(*args, k=1))
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


if __name__ == "__main__":
    sys.exit(main())
