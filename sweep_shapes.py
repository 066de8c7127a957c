#!/usr/bin/env python3
"""Time the port's sweep kernel (coati_tpu_torch/csrc/wavefront_segment.cu)
at several launch shapes, and hold every shape to the one-block result.

    python3 sweep_shapes.py [segment] [forward] [triplet]
                                 # from the repository root; needs one card;
                                 # no argument: all three tables

For square random pairs of several sizes, alone and in a group of four, and
for several (blocks a pair, threads a block), it runs one 4,000-diagonal
segment with backpointers in the middle of the matrix, from the carry of a
score-only sweep down to it. Each shape's backpointers on the
pairs' true cells, ring and corners must be bit-equal to those of one block
a pair (any difference raises); then the launch is timed, in microseconds a
diagonal. Last, the whole score-only sweep with the shape the wrapper
chooses (kernels/wavefront_segment.py sweep_shape, whose rule was set from
this table). It stands in its own (blocks, threads) for sweep_shape while it
measures. CUDA events, mean of 2 launches after a warm-up.

Then the same for the Forward entry point of that kernel, which writes 12
bytes a cell where the segment writes 1: one pair of 9,999 and of 29,397 nt
(the sizes the sample verb is driven at), the whole matrix, at 1 to 132
blocks a pair, each shape's corners and M, D, I held to the one-block
result (they must be equal: a cell's arithmetic does not depend on the
block that computes it; a difference within FWD_ATOL + FWD_RTOL * |value|
would be reported, a larger one raises), timed beside the score-only sweep
at the same shape, with the shape the wrapper chooses
(kernels/wavefront_forward.py forward_shape) marked.

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
BLOCKS = (1, 4, 8, 16, 33, 132)
THREADS = (1024, 512)
FORWARD_SIZES = (9_999, 29_397)  # nt of the one pair
FORWARD_BLOCKS = (1, 4, 8, 10, 16, 20, 29, 33, 58, 66, 132)
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
    """The Forward of one pair at every launch shape, against one block a
    pair, beside the score-only sweep at the same shape."""
    chosen = wavefront_score.sweep_shape
    chosen_forward = wavefront_forward.forward_shape
    for n in FORWARD_SIZES:
        rng = np.random.default_rng(1)
        a = torch.from_numpy(rng.integers(0, 183, (1, n)).astype(np.int32)).to(dev)
        b = torch.from_numpy(rng.integers(0, 4, (1, n)).astype(np.int32)).to(dev)
        lens = torch.full((1,), n, dtype=torch.int32, device=dev)
        args = (a, b, lens, lens, p.table, p.gap_consts)
        rule = chosen_forward(1, n + 1, dev)
        try:
            wavefront_forward.forward_shape = lambda *_: (1, 1024)
            want_adj, want = wavefront_forward.wavefront_forward(*args, k=1)
            for threads in THREADS:
                for blocks in FORWARD_BLOCKS:
                    shape = (blocks, threads)
                    wavefront_forward.forward_shape = lambda *_, s=shape: s
                    adj, mdi = wavefront_forward.wavefront_forward(*args, k=1)
                    verdict = "equal to"
                    if not (torch.equal(mdi, want) and torch.equal(adj, want_adj)):
                        diff = (mdi - want).abs()
                        worst = float(diff.max())
                        if bool((diff > FWD_ATOL + FWD_RTOL * want.abs()).any()):
                            raise AssertionError(
                                f"Forward {n} nt, {blocks} x {threads} threads: "
                                f"differs from one block by {worst:.3e}")
                        verdict = f"within {worst:.3e} of"
                    del adj, mdi
                    ms = elapsed_ms(lambda: wavefront_forward.wavefront_forward(
                        *args, k=1))
                    wavefront_score.sweep_shape = lambda *_, s=shape: s
                    score_ms = elapsed_ms(
                        lambda: wavefront_score.wavefront_score(*args, k=1))
                    mark = " (forward_shape's choice)" if shape == rule else ""
                    print(f"[{card}] Forward 1 x {n} nt, {blocks} x {threads} threads"
                          f"{mark}: {verdict} one block a pair; {ms:.1f} ms = "
                          f"{ms / (2 * n) * 1e3:.2f} us a diagonal, "
                          f"{n * n / ms / 1e6:.2f} Gcells/s; score-only sweep "
                          f"{score_ms:.1f} ms = {score_ms / (2 * n) * 1e3:.2f} us a "
                          f"diagonal", flush=True)
        finally:
            wavefront_score.sweep_shape = chosen
            wavefront_forward.forward_shape = chosen_forward
        del want, want_adj


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
    """The segment kernel at every launch shape, against one block a pair."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    aln = alignment_params()
    p = params_from_numpy(aln.subst_matrix, aln.gap, dev)
    chosen = wavefront_segment.sweep_shape
    for n, B in SIZES:
        rng = np.random.default_rng(0)
        a = torch.from_numpy(rng.integers(0, 183, (B, n)).astype(np.int32)).to(dev)
        b = torch.from_numpy(rng.integers(0, 4, (B, n)).astype(np.int32)).to(dev)
        lens = torch.full((B,), n, dtype=torch.int32, device=dev)
        args = (a, b, lens, lens, p.table, p.gap_consts)
        d0 = n - SEGMENT // 2
        mask = true_cells(n, d0, SEGMENT, dev)

        def segment(carry):
            return wavefront_segment.wavefront_segment(
                *args, carry, d0, k=1, n_steps=SEGMENT, want_bp=True)

        try:
            # the carry entering diagonal d0, swept with the chosen shape
            _, _, carry = wavefront_segment.wavefront_segment(
                *args, wavefront_segment.empty_carry(B, n + 1, 1, dev), 0, k=1,
                n_steps=d0, want_bp=False)
            wavefront_segment.sweep_shape = lambda *_: (1, 1024)
            _, want_bp, (want_ring, want_corners) = segment(carry)
            want_bp = want_bp[:, mask]
            for threads in THREADS:
                for blocks in BLOCKS:
                    if blocks * B > sms:
                        continue
                    wavefront_segment.sweep_shape = lambda *_, s=(blocks, threads): s
                    _, bp, (ring, corners) = segment(carry)
                    same = (torch.equal(bp[:, mask], want_bp)
                            and torch.equal(ring, want_ring)
                            and torch.equal(corners, want_corners))
                    del bp, ring, corners
                    if not same:
                        raise AssertionError(
                            f"{B} x {n} nt, {blocks} x {threads} threads a pair "
                            f"differs from one block of 1,024 threads a pair")
                    ms = elapsed_ms(lambda: wavefront_segment.wavefront_segment(
                        *args, carry, d0, k=1, n_steps=SEGMENT, want_bp=True,
                        want_carry=False))
                    print(f"[{card}] {B} x {n} nt, {blocks} x {threads} threads a pair: "
                          f"bit-equal to one block a pair; segment with bp "
                          f"{ms:.1f} ms = {ms / SEGMENT * 1e3:.2f} us a diagonal",
                          flush=True)
        finally:
            wavefront_segment.sweep_shape = chosen
        del want_bp, want_ring, want_corners, carry
        blocks, threads = chosen(B, n + 1, dev)
        ms = elapsed_ms(lambda: wavefront_score.wavefront_score(*args, k=1))
        print(f"[{card}] {B} x {n} nt, chosen {blocks} x {threads}: score-only sweep "
              f"{ms:.1f} ms = {B * n * n / ms / 1e6:.2f} Gcells/s, "
              f"{ms / (2 * n) * 1e3:.2f} us a diagonal", flush=True)


if __name__ == "__main__":
    sys.exit(main())
