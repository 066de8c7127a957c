#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (coati_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printing lines (any failure raises, exit code non-zero):

1. device  - requires torch.cuda.is_available(); prints nvidia-smi's card
             name and power limit, the torch and CUDA versions.
2. build   - nvcc-builds the kernels from coati_tpu_torch/csrc.
3. kernels - every kernel against its plain PyTorch version on the card.
             Fill (strips, row layout) and whole-stack walk: the B=64 999 nt
             bucket, k=3, 5, 6, 7 and 8 ragged, IUPAC codes, stacked table_idx
             tables (G=3 in shared memory, G=24 read from device memory),
             pairs over 4,096 slots spread over several blocks (C~6,000,
             k=1 and k=3), stripe passes through the edge buffer in one
             block and over several (forced shapes); corners, bp on every
             true cell, ops and scores bit-equal; in every such case the
             score kernel on the strip route (score_shape's launch, or the
             forced shape), its corners bit-equal to plain and to the fill's;
             and a gap length above the fill kernel's (k=9), which
             fused_align_ops must send through the sweep and the segment
             walk, equal to the plain fill and walk, and the score kernel
             through the sweep, equal to plain.
             Segment kernel, score kernel forced onto each route of the
             sweep, and segment walk (a warp a pair, windows) at the gap
             lengths they serve, above the strip body's (k=9, and 12 on the
             band route): ragged groups with IUPAC and gap codes, a segment
             length that does not divide the diagonals, each route of the
             sweep (one block a pair with the ring in shared or in global
             memory; several blocks a pair as bands of columns, band widths
             that are not a multiple of the threads, groups where some bands
             hold no cell of a short pair; at the all-to-all barrier,
             forced); every launch must take its case's route, the band route
             with no global ring; after every segment the ring and raw
             corners, the backpointers on true cells, the walk state and the
             ops. Everything must be bit-equal. Then a WATCHDOG_NT nt
             score-only sweep whose last band waits longer than a stalled
             wait may last, equal to the barrier route.
             The long path on strips (k <= 8): the checkpointing score
             kernel, the band fill and the band walk, band by band from the
             last, k = 1, 3 and 8, ragged groups, a group spread over
             several blocks a pair, forced shapes with stripe passes, and
             strips of 16 over cooperative blocks (the 160 knt pair's);
             the corners and every checkpoint entry the kernel defines,
             each band's bp on its true cells, the walk state and ops after
             every band bit-equal to plain, the end equal to the
             whole-stack route.
             Forward kernel and sample walk: k=1, 3 and 5, ragged groups with
             all 15 IUPAC columns and the gap code, each route of the sweep;
             the corners and every M, D, I of each pair's rectangle within
             FWD_ATOL + FWD_RTOL * |value| of plain (the largest absolute
             and relative difference printed); the walk on the kernel's
             matrices and fixed uniforms, at walk_shape's windows, at a
             forced small S and at one thread a sample: op streams equal,
             scores within SCORE_ATOL + SCORE_RTOL * |score|; the window
             layout's size in kernels/sample_walk.py equal to the library's
             at walk_shape's shape for k = 1-20.
4. main    - the batch verb's batch_align over 10,000 synthetic mar-mg
             pairs (make_pairs and the length mix below, seed 0), run twice;
             then WARM_RUNS warm runs are timed; the launch counters are reset
             just before the first warm run and read just after it. Checks on
             that run: every alignment ungaps to its inputs, the pairs in
             tests/data/torch_main_path_golden.json equal the JAX
             reference's results (XLA:CPU), a stratified 256-pair subset
             equals the plain version on the card (strings and f32 scores),
             the CLI's alignpair gives CT----ATAGTG on the reference
             example, both kernels launched. Every timed run's output equals
             the checked run's byte for byte. Prints the process's CPU time
             over the timed runs beside their wall, with PyTorch's CPU
             threads. Then one more warm run under torch.profiler (CPU
             activity): it fails if aten::pin_memory or aten::_pin_memory
             ran, and prints the ATen operations the run called.
   trace   - the CLI's batch --trace-dir over the main mix's first
             TRACE_PAIRS pairs, after the same batch without it: the bytes
             equal; one trace file that parses; its kernel events hold the
             fill's and the walk's kernels, as many launches of each as
             KernelTimer counted in that run, their summed duration within
             TRACE_DURATION_TOL of CUDA events around the library's launches.
             Prints the trace's size, the traced against the untraced wall,
             the card's busy share and the host's functions by self time;
             then the same, unchecked, for sample at 9,999 nt x 200 and
             batch -m tri-mg at 64 x 999 nt.
5. long    - batch_align over 1,000 pairs of the same mix plus four pairs of
             29,397-31,998 nt at the default byte budget: every pair takes
             the fill (the four pairs' stacks of rows fit it; no kernel of
             the long path launches); the same with two pairs of 6-8 knt in
             their place; then, with longseq.BP_BUDGET_BYTES at
             LONG_PHASE_BUDGET, which the two pairs' stacks pass, they take
             the long path on strips; counters reset just before, read just
             after that run and viterbi_scores_batch over the same pairs.
             Checks: every alignment ungaps to its inputs and the rows
             path's equal the fill's row for row; every score equals the
             score kernel's; the checkpointing score kernel, the band fill
             and the band walk launched, and the segment kernel and segment
             walk did not. Then the two pairs' group at its full shape:
             pass 1 over the whole matrix, the middle band's fill and walk,
             each against its plain version on the same inputs and timed;
             the score kernel over the four 29-32 knt pairs on the strip
             route, the band route and at the barrier, equal, timed in
             turns; a two-pair 3-4 knt group through the long path in
             several bands equals the plain versions end to end; the pairs
             of tests/data/torch_long_path_golden.json, forced through the
             long path, equal the JAX reference's results. Then a k = 9
             batch (above the strip body's k) with four 24-25 knt pairs
             whose stacks of diagonals pass the default budget: the sweep
             with bp and the segment walk for the rest, the long pairs in
             segments of diagonals (the segment kernel without and with
             bp), nothing of the strips, every alignment equal to the
             whole-matrix sweep's; the long group's middle segment at its
             full shape against plain. And one pair of LONGPAIR_NT nt
             through the CLI's alignpair: its stack of rows passes the
             default budget, so it takes the long path on strips and the
             segment kernels never launch; it ungaps to its inputs, its
             score is the score kernel's (whose strip and band routes are
             held equal and timed in turns) and the sum along its own path
             as the fill sums it (path_score).
   lonepair - one LONE_NT nt pair through the CLI's alignpair and through
             batch_align: the fill and whole-stack walk launched once each
             (spread over blocks), equal to the long path's alignment (the
             long path on strips, forced by long_slots=0).
6. numbers - warm alignments/s, device times from CUDA events, Gcells/s,
             kernel against plain times and bounds, peak device memory
             (printed last, after phases 7 and 8).
7. sample  - the CLI's sample on one pair of 9,999 nt, 200 samples, and one
             of 29,397 nt, 1,000 samples, each twice with one seed; counters
             reset just before, read just after. Checks: every sample ungaps
             to its inputs, both runs wrote the same bytes, the Forward
             kernel and the sample walk launched. At 9,999 nt also: the
             largest adjusted corner against native.forward_score, the
             Forward kernel against its plain version over the whole
             matrix, all 200 walks again by the plain walk on the run's own
             matrices and uniforms; the walk timed at its windows and, in
             turns, at one thread a sample (the body before windows). Then
             the native route on the card's host: a 999 nt pair, 1,000
             samples, native.sample_anchor beside.
8. msa     - the CLI's msa over a synthetic tree of 1,000 leaves of ~1,500
             nt with as many different distances to the reference (1,000
             stacked tables): every row ungaps to its sequence; a 12-leaf
             tree equals the JAX reference's output
             (tests/data/torch_msa_golden.json).

9. triplet - the codon triplet models. Kernels: the forward rows
             (triplet_rows) and the walk (triplet_walk) against their plain
             versions on the card, tolerance 0: ragged batches with N,
             tri-ecm, one pair, rows wider than a block's tile, the rows at
             the shape rows_shape picks and at forced shapes (2-4 bands of
             32 or 64 threads, rings of 1-8 slots, one band), the carry form
             from a checkpoint with and without the grid at each of them,
             the walk whole and in segments with a ragged last one, on the
             plain rows and on the kernel's own (whose cells outside the
             pairs are uninitialized), at the shape walk_shape picks and at
             forced ones (passes of 1-8 columns x 32-64 threads, windows of
             8-64 columns that insertion runs leave, the whole row, the band
             route of 2-8 blocks a pair); the walk through one segment of the
             long pair at walk_shape's band route and forced shapes. Path:
             batch_align -m tri-mg over 64 pairs of 999
             nt and 16 of 2,997 nt, counters reset just before the timed run
             and read just after; a subset again with the plain versions
             standing in; tests/data/torch_triplet_golden.json held; a few
             results against triplet_path_score; a tri-ecm and a dna pair
             through alignpair against the host engine; one pair of
             TRIPLET_LONG_NT nt through alignpair -m tri-mg, which the
             default byte budget sends down the segmented path, held string
             for string to the full-grid route.
10. multi  - two lanes, two CUDA streams on the one card (LANES). The main
             path's 10,000 pairs through batch_align over the two lanes,
             counters and each lane's chunk count reset just before and read
             just after: every row byte-equal to one lane's, which equal
             phase 4's; both kernels launched, both lanes ran chunks; warm
             runs in turns with one lane; the kernels' busy share of a
             traced two-lane run. The mesh entry points on the two lanes,
             each equal to one lane: sharded_viterbi_scores over phase 5's
             1,004 pairs (the long ones spread over blocks on the second
             lane), sharded_triplet_align_batch at 64 x 999 nt against
             batch_align -m tri-mg, sharded_sample_batch at 9,999 nt x 200
             op for op against sample_batch_device, dryrun_multichip(LANES).
             Then batch --multihost in two processes of the CLI (gloo, a
             free localhost port) on the card, over 2,000 pairs of the main
             mix under mar-mg (LOCAL_RANK and LOCAL_WORLD_SIZE set, as
             torchrun sets them) and 16 pairs of 999 nt under tri-mg (not
             set) with a rejected pair in each shard: each process on the
             cards multihost.local_devices gives it, its kernels launched,
             every merged row byte-equal to a one-process run's row for its
             pair (under mar-mg the whole file), the scores manifest equal
             to its rows with null at the rejected pairs. Prints its
             seconds.

11. bench  - python -m coati_tpu_torch.bench with BENCH_QUICK=1 in a
             subprocess on the card (a HOME of its own for the anchor's
             cache). Fails if it exits non-zero, if its last line does not
             parse, lacks a key of bench.KEYS or passes bench.LINE_BYTES, if
             its "device" is not the card's label (nvidia-smi's name and
             power limit), if vs_baseline is null, or if its stderr's kernel
             counts show a kernel of the bench's path never launched: the
             fill and walk, the Forward and sample walk, the triplet rows
             and walk, the long path's checkpointing score kernel, band
             fill and band walk. Prints the line
             and the bench's stderr but its unrounded record.

Every line carries the seconds since the start; before phase 6's numbers a
line gives each phase's seconds. The line before last is a JSON object with
one entry per kernel; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from coati_tpu_torch import batchrun, cli, driver, triplet_hmm, utils  # noqa: E402
from coati_tpu_torch import bench as bench_mod  # noqa: E402
from coati_tpu_torch import profiling  # noqa: E402
from coati_tpu_torch.profiling import (  # noqa: E402
    KernelTimer,
    launch_counts,
    reset_launch_counts,
)
from coati_tpu_torch.profiling import swapped as wrappers  # noqa: E402
from coati_tpu_torch import device as device_mod  # noqa: E402
from coati_tpu_torch import triplet_wavefront as tw  # noqa: E402
from coati_tpu_torch.align import engine, longseq, sample_device  # noqa: E402
from coati_tpu_torch.align.sample_device import sample_paths_plain  # noqa: E402
from coati_tpu_torch.align.wavefront import (  # noqa: E402
    band_fill_plain,
    traceback_plain,
    traceback_rows_plain,
    walk_band_plain,
    walk_segment_plain,
    wavefront_plain,
)
from coati_tpu_torch.constants import CODONS61  # noqa: E402
from coati_tpu_torch.io.fasta import read_fasta  # noqa: E402
from coati_tpu_torch.kernels import _build  # noqa: E402
from coati_tpu_torch.kernels import sample_walk as sample_mod  # noqa: E402
from coati_tpu_torch.kernels import traceback_walk as walk_mod  # noqa: E402
from coati_tpu_torch.kernels import triplet_rows as trows_mod  # noqa: E402
from coati_tpu_torch.kernels import triplet_walk as twalk_mod  # noqa: E402
from coati_tpu_torch.kernels import wavefront_fill as fill_mod  # noqa: E402
from coati_tpu_torch.kernels import wavefront_forward as fwd_mod  # noqa: E402
from coati_tpu_torch.kernels import wavefront_score as score_mod  # noqa: E402
from coati_tpu_torch.kernels import wavefront_segment as seg_mod  # noqa: E402
from coati_tpu_torch.params import alignment_params, params_from_numpy  # noqa: E402
from coati_tpu_torch.parallel import dryrun as dryrun_mod  # noqa: E402
from coati_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from coati_tpu_torch.structs import SeqData  # noqa: E402
from coati_tpu_torch.tools.common import elapsed_ms  # noqa: E402
from coati_tpu_torch.tools.inputs import LENGTH_MIX, descendant, make_pairs  # noqa: E402,F401
from coati_tpu_torch.utils import encode_marginal  # noqa: E402

N_PAIRS = 10_000
# long phase: the ladder's top and the reference's 32 knt benchmark size
LONG_MIX = [(29397, 0.5), (31998, 0.5)]
N_LONG = 4
N_LONG_PHASE_MIX = 1_000  # pairs of LENGTH_MIX beside the long ones
LONGPAIR_NT = 160_002  # the size of the reference's longest shipped example
# a lone mid-size pair: over 4,096 slots, its bp stack under the long path's
# budget, so the fill kernel spreads it over blocks
LONE_NT = 16_000
# the JAX reference's results for a few ~3 knt pairs forced through the long
# route, written and checked by tests/test_torch_golden.py
LONG_GOLDEN = ROOT / "tests" / "data" / "torch_long_path_golden.json"
LONG_GOLDEN_SLOTS = 1024  # long_slots that forces them
# the long phase: two pairs of 6-8 knt, and a budget of device bytes for one
# stack that their stacks of rows (36-64 MB) pass and the mix's do not, so
# that they take the long path (read at the call, as a user may set it) at
# a size the plain versions check at full shape in seconds
ROWS_MIX = [(6000, 0.5), (7998, 0.5)]
LONG_PHASE_BUDGET = 16 << 20
# the kernels of the long path on strips (k <= 8), and those of the sweep
# that the long path keeps above (K5 and the segment walk)
LONG_KERNELS = ("wavefront_score_ckpt", "wavefront_fill_band", "traceback_walk_band")
SEGMENT_KERNELS = ("wavefront_segment", "traceback_walk_segment")
# gap length of the long phase's sweep run, above the strip body's; its
# pairs (mix, long) and the long ones' sizes: stacks of diagonals of 1.1-1.2
# GB a pair, over the default budget, so that the default routing sends them
# down the diagonal long path
K_SWEEP = fill_mod.MAX_K + 1
SWEEP_PAIRS = (48, 4)
SWEEP_LONG_MIX = [(23997, 0.5), (24993, 0.5)]
# a budget no pair of the sweep run passes: every pair on the whole-matrix sweep
WHOLE_SWEEP_BUDGET = 1 << 34
# H100 SXM data sheet: HBM3 bytes/s, and f32 operations/s outside the tensor
# cores (an FMA counted as two)
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# f32 operations the recurrence does on one cell: 10 shared partial sums, 13
# adds and maxima of M, D, I; with backpointers 2 more adds and 7 compares
CELL_OPS = 23
CELL_OPS_BP = 32
# the JAX reference's results for some of the main path's pairs, written and
# checked by tests/test_torch_golden.py
GOLDEN = ROOT / "tests" / "data" / "torch_main_path_golden.json"
# the JAX reference's msa output for a small tree, written and checked by
# tests/test_torch_golden.py
MSA_GOLDEN = ROOT / "tests" / "data" / "torch_msa_golden.json"
MSA_GOLDEN_SHAPE = (12, 300)  # leaves, nt of the reference
MSA_SHAPE = (1000, 1500)  # the msa phase: leaves, nt of the reference
# the sample phase: (nt, samples, seed); the first is the kernels' cell
SAMPLE_RUNS = [(9999, 200, 5), (29397, 1000, 6)]
SAMPLE_HOST_RUN = (999, 1000, 7)  # the native route, on the card's host
# f32 operations of one Forward cell: the 10 shared partial sums and 8 adds
# of the recurrence, and 5 lse of 8 each (max, subtract, negated absolute
# value, minimum, exp, log1p, compare-and-select, add; exp and log1p counted
# as one operation each)
CELL_OPS_FORWARD = 58
# f32 operations of one step of the sample walk: 7 adds for the candidates, 3
# subtractions, 3 exp, 1 log (one operation each), 2 adds, a multiplication,
# 2 compares, 3 selects, a subtraction and the score's add
STEP_OPS_WALK = 24
# the triplet phase: (pairs, nt, seed) of each tri-mg batch, the sizes the
# repo's bench runs the triplet engine at; the first is the kernels' cell
TRIPLET_BATCHES = [(64, 999, 11), (16, 2997, 12)]
# one pair just over the default byte budget of the full grid
# (triplet_wavefront.TRIPLET_GRID_BUDGET_BYTES: 5,001 x 15,001 cells x 15 B)
TRIPLET_LONG_NT = 15_000
# the JAX reference's results for some 156 and 471 nt pairs under tri-mg,
# written and checked by tests/test_torch_golden.py
TRIPLET_GOLDEN = ROOT / "tests" / "data" / "torch_triplet_golden.json"
TRIPLET_GOLDEN_PAIRS = 24
# f32 operations the forward rows need on one boundary cell (one column of one
# codon step), a prefix maximum as one maximum an element: phase 1 27 (core 5,
# 4 M adds, D 5, 4 I of 3, off + go_ge 1), phase 2 104 (4 cores 20, 16 M adds,
# 4 D 20, 16 I of 3), phase 3 256 (16 cores 80, 16 D 80, 16 M lane, 16 D lane
# and 16 W adds, three collapses of 15 compares, the W maximum, the I add, the
# new-maximum compare). The 16 entry costs max over x3 of cost + e depend only
# on the pair, the step and the descendant nucleotide left of the column, a
# table of 16 x 6 a step and not a cell's work, so they are not counted
# (csrc/triplet_rows.cu computes them again in every column: 112 more).
CELL_OPS_TRIPLET = 387
# f32 operations of the walk on one recomputed column of one block: three
# cores and three D rows of 5, 4 emission and cost adds, the D row's cost
# add, three I of 4
CELL_OPS_TRIPLET_WALK = 47
WARM_RUNS = 5  # timed warm runs of the main path; the first is also checked
# the ATen operations that pin a tensor: a chunk's copies go through its lane's
# reused pinned buffers, so the main path calls neither
PIN_OPS = ("aten::pin_memory", "aten::_pin_memory")
# the trace phase: pairs of the main mix through batch --trace-dir; the trace's
# fill and walk time against the CUDA events' (relative); host functions shown
TRACE_PAIRS = 2_000
TRACE_DURATION_TOL = 0.10
TRACE_TOP = 8
# the multi phase: two lanes (two streams) on the one card; warm runs of the
# main path a lane count, in turns; pairs of the main mix, and (pairs, nt,
# seed) of a tri-mg stream, for the two-process batch --multihost runs
LANES = ["cuda:0", "cuda:0"]
MULTI_WARM_RUNS = 3
MULTIHOST_MIX_PAIRS = 2_000
MULTIHOST_TRIPLET = (16, 999, 18)
# The Forward kernel against its plain version: lse is built from expf and
# log1pf, which differ from torch's CUDA exp and log1p in the last place, and
# the differences add up along a path, so a value is held to FWD_ATOL +
# FWD_RTOL * |value| (f32 keeps 6e-8 of a value; cells of a 10 knt pair reach
# 1e4). The walk on the same matrices and uniforms must give the same ops;
# a score is a sum of up to na + nb f32 log probabilities.
FWD_RTOL = 4e-6
FWD_ATOL = 2e-5
SCORE_RTOL = 4e-6
SCORE_ATOL = 1e-4
# the sample walk at a forced small window: (S, warps a block)
SMALL_WINDOWS = (3, 2)
# The band route's watchdog: a wait traps after csrc/wavefront_segment.cu
# kStallCycles SM cycles without a move of the counter it reads, about a
# second at an H100 SXM's top SM clock. The last of 132 bands of one pair of
# WATCHDOG_NT nt starts some 635,000 diagonals in, about 2 s of waiting.
STALL_CYCLES = 2_000_000_000
TOP_SM_HZ = 1.98e9
WATCHDOG_NT = 640_000
KERNELS = {
    "wavefront_fill": {
        "route": "cuda",
        "source": "coati_tpu_torch/csrc/wavefront_fill.cu",
        "replaces": "coati_tpu/kernels/wavefront_pallas.py:330",
    },
    "traceback_walk": {
        "route": "cuda",
        "source": "coati_tpu_torch/csrc/traceback_walk.cu",
        "replaces": "coati_tpu/align/wavefront.py:271",
    },
    "wavefront_segment": {
        "route": "cuda",
        "source": "coati_tpu_torch/csrc/wavefront_segment.cu",
        "replaces": "coati_tpu/kernels/wavefront_pallas.py:909",
    },
    "wavefront_score": {
        "route": "cuda",
        "source": "coati_tpu_torch/csrc/wavefront_fill.cu",
        "replaces": "coati_tpu/kernels/wavefront_pallas.py:330",
    },
    "traceback_walk_segment": {
        "route": "cuda",
        "source": "coati_tpu_torch/csrc/traceback_walk.cu",
        "replaces": "coati_tpu/align/longseq.py:57",
    },
    # the long path on strips (k <= 8), in place of K5's two passes and the
    # segment walk there
    "wavefront_score_ckpt": {
        "route": "cuda",
        "source": "coati_tpu_torch/csrc/wavefront_fill_long.cu",
        "replaces": "coati_tpu/kernels/wavefront_pallas.py:909",
    },
    "wavefront_fill_band": {
        "route": "cuda",
        "source": "coati_tpu_torch/csrc/wavefront_fill_long.cu",
        "replaces": "coati_tpu/kernels/wavefront_pallas.py:909",
    },
    "traceback_walk_band": {
        "route": "cuda",
        "source": "coati_tpu_torch/csrc/traceback_walk.cu",
        "replaces": "coati_tpu/align/longseq.py:57",
    },
    "wavefront_forward": {
        "route": "cuda",
        "source": "coati_tpu_torch/csrc/wavefront_segment.cu",
        "replaces": "coati_tpu/kernels/wavefront_pallas.py:330",
    },
    "sample_walk": {
        "route": "cuda",
        "source": "coati_tpu_torch/csrc/sample_walk.cu",
        "replaces": "coati_tpu/align/sample_device.py:39",
    },
    "triplet_rows": {
        "route": "cuda",
        "source": "coati_tpu_torch/csrc/triplet_rows.cu",
        "replaces": "coati_tpu/kernels/triplet_pallas.py:197",
    },
    "triplet_walk": {
        "route": "cuda",
        "source": "coati_tpu_torch/csrc/triplet_walk.cu",
        "replaces": "coati_tpu/kernels/triplet_pallas.py:454",
    },
}


def make_msa_inputs(n_leaves, nt, seed):
    """Inputs of the msa verb: a reference of nt nt (random codons), n_leaves
    descendants of it (make_pairs's mutations) and a random binary tree over
    them whose branch lengths are all different, so that every leaf has its
    own distance to the reference. Returns (FASTA text, Newick text,
    reference name, {name: sequence}).

    The rows msa writes for such leaves are not all one length: merge_indels
    (msa/insertions.py, the same in both packages) adds the gap columns of a
    group whose insertions are already closed once for every position it
    passes, when that group meets one with open insertions. Every row still
    ungaps to its sequence, and the port writes the JAX package's bytes."""
    rng = np.random.default_rng(seed)
    ref = "".join(rng.choice(np.array(CODONS61), size=nt // 3))
    seqs = {"ref": ref}
    for i in range(n_leaves):
        seqs[f"leaf{i}"] = descendant(ref, rng)
    nodes = list(seqs)
    rng.shuffle(nodes)
    lengths = rng.permutation(2 * len(nodes))  # all different
    n_len = 0

    def branch():
        nonlocal n_len
        n_len += 1
        return 0.0005 + 0.00001 * int(lengths[n_len - 1])

    while len(nodes) > 2:  # join the two oldest subtrees, queue the result
        a, b = nodes.pop(0), nodes.pop(0)
        nodes.append(f"({a}:{branch():.5f},{b}:{branch():.5f})")
    newick = f"({nodes[0]}:{branch():.5f},{nodes[1]}:{branch():.5f});"
    fasta = "".join(f">{name}\n{seq}\n" for name, seq in seqs.items())
    return fasta, newick, "ref", seqs


def msa_golden_record(text):
    """Golden record of an msa run's FASTA output."""
    rows = read_fasta(io.StringIO(text)).seqs
    return {"rows": len(rows), "width": len(rows[0]),
            "sha256": hashlib.sha256(text.encode()).hexdigest()}


def golden_record(index, row):
    """Golden record of one batch_align output row of pair `index`: its
    score and a sha256 of its aligned strings."""
    aln = row["alignment"]
    text = aln[f"anc{index}"] + "\n" + aln[f"des{index}"]
    return {"index": index, "score": row["score"],
            "sha256": hashlib.sha256(text.encode()).hexdigest()}


def long_golden_record(index, result):
    """Golden record of one engine AlignResult of long-path pair `index`."""
    text = result.seq0 + "\n" + result.seq1
    return {"index": index, "score": float(np.float32(result.score)),
            "sha256": hashlib.sha256(text.encode()).hexdigest()}


def triplet_golden_pairs(seed):
    """The named pairs of TRIPLET_GOLDEN: 156 and 471 nt."""
    pairs = make_pairs(TRIPLET_GOLDEN_PAIRS, np.random.default_rng(seed),
                       length_mix=[(156, 0.5), (471, 0.5)])
    return [(f"anc{i}", a, f"des{i}", b) for i, (a, b) in enumerate(pairs)]


def long_golden_pairs(seed):
    """The pairs of LONG_GOLDEN: three of 2,997 nt."""
    return make_pairs(3, np.random.default_rng(seed), length_mix=[(2997, 1.0)])


def _triplet_rows_plain(anc_cods, des_codes, ins_off, steps, lens_m, *rest,
                        keep_grid=True, grid_out=None, amax_out=None):
    grid, amax, out = trows_mod.triplet_rows_plain(
        anc_cods, des_codes, ins_off, *rest, keep_grid=keep_grid, steps=steps)
    if keep_grid and grid_out is not None:
        grid, amax = grid_out.copy_(grid), amax_out.copy_(amax)
    return grid, amax, out


def _segment_plain(*args, want_carry=True, **kw):
    adj, bp, carry = seg_mod.segment_plain(*args, **kw)
    return adj, bp, (carry if want_carry else None)


PLAIN = {
    "wavefront_fill": fill_mod.fill_rows_plain,
    "traceback_walk": traceback_rows_plain,
    "wavefront_segment": _segment_plain,
    "wavefront_score": score_mod.score_plain,
    "traceback_walk_segment": walk_segment_plain,
    "wavefront_score_ckpt": score_mod.ckpt_plain,
    "wavefront_fill_band": band_fill_plain,
    "traceback_walk_band": walk_band_plain,
    "triplet_rows": _triplet_rows_plain,
    "triplet_walk": twalk_mod.triplet_walk_plain,
}


T_START = time.perf_counter()


def say(phase: str, msg: str) -> None:
    """One line of a phase, with the seconds since the script started."""
    print(f"[{phase} +{time.perf_counter() - T_START:.0f}s] {msg}", flush=True)


def in_turns(dev, reps, *fns):
    """Each fn timed by elapsed_ms in the order given and then in reverse
    (a, b, b, a): a list of its two readings each."""
    times = [[] for _ in fns]
    for q in [*range(len(fns)), *reversed(range(len(fns)))]:
        times[q].append(elapsed_ms(fns[q], dev, reps))
    return times


def mean(xs):
    return sum(xs) / len(xs)


# --- phase 1 ----------------------------------------------------------------
def phase_device() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    say("device", f"{torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"| CUDA {torch.version.cuda} | devices {torch.cuda.device_count()}")
    return torch.device("cuda:0"), card


# --- phase 2 ----------------------------------------------------------------
def phase_build() -> None:
    t0 = time.perf_counter()
    path, log = _build.build()
    _build.load()
    secs = time.perf_counter() - t0
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    say("build", f"{path.name} in {secs:.2f} s; ptxas: " + " | ".join(regs))


# --- phase 3 ----------------------------------------------------------------
def _random_case(seed, k, B, na, nb, n_codes=4, G=1):
    """Random encoded batch in one padded bucket: lens in [na[0], na[1]] nt
    (multiples of 3k) and [nb[0], nb[1]] (multiples of k); pair p uses
    table p % G of G mar-mg tables over branch lengths 0.0133-0.5."""
    rng = np.random.default_rng(seed)
    la = rng.integers(na[0] // (3 * k), na[1] // (3 * k) + 1, B) * 3 * k
    lb = rng.integers(nb[0] // k, nb[1] // k + 1, B) * k
    NA = -(-int(la.max()) // 96) * 96
    NB = -(-int(lb.max()) // 96) * 96
    aseq = np.zeros((B, NA), np.int32)
    bseq = np.zeros((B, NB), np.int32)
    for p in range(B):
        aseq[p, : la[p]] = rng.integers(0, 183, la[p]) + 183 * (p % G)
        bseq[p, : lb[p]] = rng.integers(0, n_codes, lb[p])
    tables = np.stack([alignment_params(br_len=t).subst_matrix
                       for t in np.geomspace(0.0133, 0.5, G)])
    return aseq, bseq, la.astype(np.int32), lb.astype(np.int32), tables


def check_case(dev, name, k, B, na, nb, expect, n_codes=4, G=1, seed=0,
               timing=None, launch=None):
    """One batch through the fill and walk kernels and their plain versions
    (fill_rows_plain, traceback_rows_plain): corners, bp on every true cell,
    ops and scores bit-equal. expect(launch) must hold for the launch the
    fill takes (fill_shape's, or `launch` (W, warps, pairs, blocks) forced);
    timing None, "kernels" or "all" (kernels and plain versions)."""
    aseq, bseq, la, lb, tables = _random_case(seed, k, B, na, nb, n_codes, G)
    p = params_from_numpy(tables, alignment_params(gap_len=k).gap, dev)
    a, b, tla, tlb = (torch.from_numpy(x).to(dev) for x in (aseq, bseq, la, lb))
    steps = int((la + lb).max())
    C = bseq.shape[1] + k
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    forced = launch
    if forced is None:
        launch = fill_mod.fill_shape(B, C, k, p.table.numel(), sms)
    else:
        launch = fill_mod.fill_launch(B, C, k, *forced, table_len=p.table.numel())
    if not expect(launch):
        raise AssertionError(f"kernel case {name}: the fill takes {launch}, "
                             f"not the route the case is for")
    args = (a, b, tla, tlb, p.table, p.gap_consts)

    # the score kernel on the strip route: score_shape's launch, or the
    # forced shape built score-only
    if forced is None:
        score_launch = score_mod.score_shape(B, C, k, p.table.numel(), sms)
    else:
        score_launch = fill_mod.fill_launch(B, C, k, *forced, table_len=p.table.numel(),
                                            widths=fill_mod.SCORE_WIDTHS)
    if not expect(score_launch):
        raise AssertionError(f"kernel case {name}: the score kernel takes "
                             f"{score_launch}, not the route the case is for")

    ck, bpk = fill_mod.wavefront_fill(*args, k=k, launch=launch)
    cp, bpp = fill_mod.fill_rows_plain(*args, k=k)
    opk, sk = walk_mod.traceback_walk(bpk, ck, tla, tlb, k=k, max_steps=steps)
    opp, sp = traceback_rows_plain(bpp, cp, tla, tlb, k=k, max_steps=steps)
    sck = score_mod.wavefront_score(*args, k=k, launch=score_launch)
    scp = score_mod.score_plain(*args, k=k)
    torch.cuda.synchronize(dev)

    fill_err = max(float((x - y).abs().max()) for x, y in zip(ck, cp))
    walk_err = float((sk - sp).abs().max())
    mask = fill_mod.true_cells(tla, tlb, k, *bpk.shape[1:])
    bad = []
    if not all(torch.equal(x, y) for x, y in zip(ck, cp)):
        bad.append("corners")
    if not torch.equal(bpk[mask], bpp[mask]):
        bad.append(f"bp ({int((bpk[mask] != bpp[mask]).sum())} cells)")
    if not torch.equal(opk, opp):
        bad.append("ops")
    if not torch.equal(sk, sp):
        bad.append("scores")
    if not (torch.equal(sck, scp) and torch.equal(sck, torch.stack(cp))):
        bad.append("score kernel corners")
    if not bool(torch.isfinite(sk).all()):
        bad.append("non-finite scores")
    if bad:
        raise AssertionError(f"kernel case {name}: {', '.join(bad)} differ "
                             f"from the plain version")
    fill_err = max(fill_err, float((sck - scp).abs().max()))
    out = {"fill_err": fill_err, "walk_err": walk_err, "launch": launch}
    times = ""
    if timing:
        out["fill_ms"] = elapsed_ms(lambda: fill_mod.wavefront_fill(
            *args, k=k, launch=launch), dev, 10)
        out["walk_ms"] = elapsed_ms(lambda: walk_mod.traceback_walk(
            bpk, ck, tla, tlb, k=k, max_steps=steps), dev, 10)
        times = f"; fill {out['fill_ms']:.3f} ms, walk {out['walk_ms']:.3f} ms"
        cells = segment_cells(la, lb, k, 0, aseq.shape[1] + bseq.shape[1] + 2 * k - 1)
        in_bytes = sum(t.numel() * t.element_size() for t in args)
        # inputs in; 1 B a cell of the pairs' matrices and the corners out
        out["fill_bound"] = bound(in_bytes + cells + 12 * B, cells * CELL_OPS_BP)
        # 1 B a step, corners and lens in; the ops buffer and scores out
        n_steps = int((opk >= 0).sum())
        out["walk_bound"] = bound(n_steps + 20 * B + opk.numel() + 4 * B, 0)
    if timing == "all":
        out["fill_plain_ms"] = elapsed_ms(lambda: fill_mod.fill_rows_plain(
            *args, k=k), dev, 2)
        out["walk_plain_ms"] = elapsed_ms(lambda: traceback_rows_plain(
            bpk, ck, tla, tlb, k=k, max_steps=steps), dev, 2)
        times += (f" (plain: fill {out['fill_plain_ms']:.1f} ms, "
                  f"walk {out['walk_plain_ms']:.1f} ms)")
    say("kernels", f"{name}: B={B} NA={aseq.shape[1]} NB={bseq.shape[1]} k={k} "
        f"G={G}, strips of {launch.W} x {launch.warps} warps x {launch.pairs} "
        f"pairs x {launch.blocks} blocks, {launch.passes} passes, table in "
        f"{'shared' if launch.table_shared else 'device'} memory: corners, bp "
        f"on {int(mask.sum())} true cells, {int((opk >= 0).sum())} ops and "
        f"scores bit-equal to plain; the score kernel in strips of "
        f"{score_launch.W} x {score_launch.warps} warps x {score_launch.pairs} pairs "
        f"x {score_launch.blocks} blocks, {score_launch.passes} passes: corners "
        f"bit-equal to plain and to the fill's{times}")
    return out


def check_sweep_route(dev, k, B, na, nb, seed):
    """A gap length above the fill kernel's (fill_mod.MAX_K) goes through
    engine.fused_align_ops to the sweep over every diagonal and the segment
    walk: those kernels launch, the fill and whole-stack walk do not, and
    the ops and scores equal the plain fill and walk's (diagonal layout)."""
    aseq, bseq, la, lb, tables = _random_case(seed, k, B, na, nb, n_codes=16)
    p = params_from_numpy(tables, alignment_params(gap_len=k).gap, dev)
    args = [torch.from_numpy(x).to(dev) for x in (aseq, bseq, la, lb)]
    args += [p.table, p.gap_consts]
    steps = int((la + lb).max())
    reset_launch_counts()
    ops, score = engine.fused_align_ops(*args, k=k, max_steps=steps)
    torch.cuda.synchronize(dev)
    counts = launch_counts()
    corners, bp = wavefront_plain(*args, k=k)
    want_ops, want_score = traceback_plain(bp, corners, args[2], args[3], k=k,
                                           max_steps=steps)
    took = {n: counts[n] for n in ("wavefront_fill", "traceback_walk",
                                   "wavefront_segment", "traceback_walk_segment")}
    if took != {"wavefront_fill": 0, "traceback_walk": 0, "wavefront_segment": 1,
                "traceback_walk_segment": 1}:
        raise AssertionError(f"k={k}: fused_align_ops launched {took}, not the sweep")
    if not (torch.equal(ops, want_ops) and torch.equal(score, want_score)):
        raise AssertionError(f"k={k}: the sweep route's ops or scores differ "
                             f"from plain")
    reset_launch_counts()
    sc = score_mod.wavefront_score(*args, k=k)
    torch.cuda.synchronize(dev)
    counts = launch_counts()
    if (counts["wavefront_score"], counts["wavefront_fill"]) != (1, 0):
        raise AssertionError(f"k={k}: the score kernel took {counts}")
    if not torch.equal(sc, score_mod.score_plain(*args, k=k)):
        raise AssertionError(f"k={k}: the score kernel's sweep route differs from plain")
    say("kernels", f"k={k} (above the fill kernel's {fill_mod.MAX_K}), B={B}: "
        f"fused_align_ops took the sweep ({took}); ops and scores bit-equal to "
        f"the plain fill and walk; the score kernel's sweep route bit-equal to "
        f"plain")
    return float((score - want_score).abs().max())


def _random_group(seed, k, la_range, lb_range, B):
    """Ragged group of B pairs padded to its maxima, descendants with all 15
    IUPAC columns and the gap code 15; lengths multiples of 3k and k."""
    rng = np.random.default_rng(seed)
    la = rng.integers(la_range[0] // (3 * k), la_range[1] // (3 * k) + 1, B) * 3 * k
    lb = rng.integers(lb_range[0] // k, lb_range[1] // k + 1, B) * k
    aseq = np.zeros((B, int(la.max())), np.int32)
    bseq = np.zeros((B, int(lb.max())), np.int32)
    for p in range(B):
        aseq[p, : la[p]] = rng.integers(0, 183, la[p])
        bseq[p, : lb[p]] = rng.integers(0, 16, lb[p])
    return aseq, bseq, la.astype(np.int32), lb.astype(np.int32)


def _rect_cells(la, lb, k, d_first, n_diag, C, dev, body=False):
    """[B, n_diag, C] mask of the cells of each pair's (la+k) x (lb+k)
    matrix on diagonals d_first .. d_first + n_diag - 1; body: only cells
    with i, j >= k."""
    d = (d_first + torch.arange(n_diag, device=dev))[None, :, None]
    j = torch.arange(C, device=dev)[None, None, :]
    i = d - j
    lo = k if body else 0
    la = la[:, None, None].long()
    lb = lb[:, None, None].long()
    return (i >= lo) & (i < la + k) & (j >= lo) & (j < lb + k)


def segment_cells(la, lb, k, d0, T):
    """Cells of the pairs' (la+k) x (lb+k) matrices on diagonals [d0, d0+T)."""
    d = np.arange(d0, d0 + T, dtype=np.int64)[None, :]
    rows = la.astype(np.int64)[:, None] + k
    cols = lb.astype(np.int64)[:, None] + k
    n = np.minimum(d, cols - 1) - np.maximum(0, d - (rows - 1)) + 1
    return int(np.maximum(n, 0).sum())


def walk_difference(st_k, ops_k, st_p, ops_p):
    """How far a segment walk is from its plain version: the largest
    absolute difference of the (i, j, st, s) state or of an op code."""
    return float(max((st_k - st_p).abs().max(),
                     (ops_k.int() - ops_p.int()).abs().max()))


def check_segment_case(dev, name, k, B, la_range, lb_range, T, route, seed,
                       idle=False):
    """One ragged group through the segment kernel, the score kernel and the
    segment walk, and through their plain versions, each chained from its own
    carry: after every segment of pass 1 the ring on the pairs' cells and the
    raw corners, after every segment of pass 2 the backpointers on the true
    cells, the walk state and the ops must be bit-equal; so must the score
    kernel's corners and the last segment's adjusted corners. route is the
    one every launch must take by the wrappers' own rule: "shared" or
    "global" (one block a pair, the ring there), "bands" (several blocks a
    pair, each a band of columns), or "barrier" (several blocks a pair at an
    all-to-all barrier, forced: the rule sends no such group there). idle:
    some pair must have no cell in some band."""
    aseq, bseq, la, lb = _random_group(seed, k, la_range, lb_range, B)
    B, NA = aseq.shape
    NB = bseq.shape[1]
    C = NB + k
    K = max(k, 2)
    Dtot = NA + NB + 2 * k - 1
    n_seg = -(-Dtot // T)
    if Dtot % T == 0:
        raise AssertionError(f"segment case {name}: T={T} divides Dtot={Dtot}")
    launch = case_launch(dev, f"segment case {name}", seg_mod.sweep_shape, B, C,
                         k, route, idle, lb + k)
    return _segment_case(dev, name, k, B, T, route, launch, aseq, bseq, la, lb,
                         C, K, n_seg)


def case_launch(dev, what, shape, B, C, k, route, idle=False, cols=None,
                table_len=183 * 15):
    """The launch a sweep wrapper makes for B pairs of C slots with the
    launch shape `shape` gives (forced to the barrier for route "barrier"),
    checked by took_route."""
    several = "barrier" if route == "barrier" else "bands"
    launch = seg_mod.sweep_launch(B, C, k, *shape(B, C, dev), table_len,
                                  several=several)
    return took_route(what, launch, route, dev, idle, cols)


def took_route(what, launch, route, dev, idle=False, cols=None):
    """The launch takes `route`, and on the band route no global ring or
    barrier counters; idle: a pair of `cols` slots has no cell in some band."""
    if launch.route != route:
        raise AssertionError(f"{what}: route {launch.route}, meant {route}")
    ring, sync = launch.buffers(dev)[:2]
    if route == "bands" and (ring is not None or sync is not None):
        raise AssertionError(f"{what}: the band route allocated a global ring")
    if idle and not any(int(c) <= launch.plan.bands[-1][0] for c in cols):
        raise AssertionError(f"{what}: every pair has cells in every band")
    return launch


def _segment_case(dev, name, k, B, T, route, launch, aseq, bseq, la, lb, C, K,
                  n_seg):
    p = params_from_numpy(alignment_params(gap_len=k).subst_matrix,
                          alignment_params(gap_len=k).gap, dev)
    a, b, tla, tlb = (torch.from_numpy(x).to(dev) for x in (aseq, bseq, la, lb))
    args = (a, b, tla, tlb, p.table, p.gap_consts)
    NA, NB = aseq.shape[1], bseq.shape[1]

    def bad(what, s):
        raise AssertionError(f"segment case {name}: {what} differ from the "
                             f"plain version after segment {s}")

    err = 0.0
    ck, cp = seg_mod.empty_carry(B, C, k, dev), seg_mod.empty_carry(B, C, k, dev)
    ckpts_k, ckpts_p = [], []
    for s in range(n_seg):
        ckpts_k.append(ck)
        ckpts_p.append(cp)
        adj_k, _, ck = seg_mod.wavefront_segment(*args, ck, s * T, k=k,
                                                 n_steps=T, want_bp=False,
                                                 launch=launch)
        adj_p, _, cp = seg_mod.segment_plain(*args, cp, s * T, k=k,
                                             n_steps=T, want_bp=False)
        # ring[q] is diagonal (s+1)T - 1 - q: the mask runs down the diagonals
        mask = _rect_cells(tla, tlb, k, (s + 1) * T - K, K, C, dev).flip(1)
        rk = ck[0].permute(2, 0, 1, 3)  # [B, K, 3, C]
        rp = cp[0].permute(2, 0, 1, 3)
        m4 = mask[:, :, None, :].expand_as(rk)
        if not torch.equal(rk[m4], rp[m4]):
            bad("ring", s)
        if not torch.equal(ck[1], cp[1]):
            bad("raw corners", s)
    if not torch.equal(adj_k, adj_p):
        bad("adjusted corners", n_seg - 1)
    err = max(err, float((adj_k - adj_p).abs().max()))

    sc_k = score_mod.wavefront_score(*args, k=k, launch=launch)
    sc_p = score_mod.score_plain(*args, k=k)
    if not (torch.equal(sc_k, sc_p) and torch.equal(sc_k, adj_k)):
        raise AssertionError(f"segment case {name}: score kernel corners differ "
                             f"from the plain version or the segment chain")
    if not bool(torch.isfinite(sc_k).all()):
        raise AssertionError(f"segment case {name}: non-finite corners")

    steps = int((la + lb).max())
    st_k = torch.zeros((4, B), dtype=torch.int32, device=dev)
    st_p = st_k.clone()
    ops_k = torch.full((steps, B), -1, dtype=torch.int8, device=dev)
    ops_p = ops_k.clone()
    n_cells = 0
    walk_err = 0.0
    for s in range(n_seg - 1, -1, -1):
        _, bp_k, _ = seg_mod.wavefront_segment(
            *args, ckpts_k[s], s * T, k=k, n_steps=T, want_bp=True,
            want_carry=False, launch=launch)
        _, bp_p, _ = seg_mod.segment_plain(*args, ckpts_p[s], s * T, k=k,
                                           n_steps=T, want_bp=True)
        mask = _rect_cells(tla, tlb, k, s * T, T, C, dev, body=True)
        n_cells += int(mask.sum())
        if not torch.equal(bp_k[mask], bp_p[mask]):
            bad(f"bp ({int((bp_k[mask] != bp_p[mask]).sum())} cells)", s)
        # the topmost segment's walk starts at the corners
        start_k, start_p = ((adj, tla, tlb) if s == n_seg - 1 else None
                            for adj in (adj_k, adj_p))
        _, _, score_k = walk_mod.walk_segment(bp_k, s * T, st_k, ops_k, k=k,
                                              start=start_k)
        _, _, score_p = walk_segment_plain(bp_p, s * T, st_p, ops_p, k=k,
                                           start=start_p)
        walk_err = max(walk_err, walk_difference(st_k, ops_k, st_p, ops_p))
        if start_k is not None:
            walk_err = max(walk_err, float((score_k - score_p).abs().max()))
            if not torch.equal(score_k, score_p):
                bad("walk scores", s)
        if not torch.equal(st_k, st_p):
            bad("walk state", s)
        if not torch.equal(ops_k, ops_p):
            bad("ops", s)
    torch.cuda.synchronize(dev)
    done = (st_k[0] == k - 1) & (st_k[1] == k - 1)
    if not bool(done.all()):
        raise AssertionError(f"segment case {name}: a walk did not reach the origin")
    width = f", bands of {launch.plan.width}" if launch.plan else ""
    say("kernels", f"{name}: B={B} NA={NA} NB={NB} k={k} T={T} ({n_seg} segments) "
        f"{launch.blocks} x {launch.threads} threads a pair{width}, route {route}: "
        f"ring, raw corners, "
        f"bp on {n_cells} true cells, "
        f"walk state and {int((ops_k >= 0).sum())} ops bit-equal to plain after "
        f"every segment; score kernel corners bit-equal")
    return err, walk_err


def phase_segment_kernels(dev):
    """Every route of the sweep at the gap lengths it still serves, above the
    strip body's MAX_K (k = 9, and 12 on the band route): one block a pair
    with the ring in shared or global memory; several blocks a pair as bands
    (band widths that are not a multiple of the threads; a ragged group
    where some bands hold no cell of a short pair) and at the all-to-all
    barrier; then the band route's watchdog (which the Forward shares at
    every k) on a pair whose last band legitimately waits longer than the
    stall limit."""
    cases = [
        ("ragged 1.5-1.8 knt, k=9", 9, 3, (1500, 1800), (1500, 1800), 777, "shared", 11),
        ("wide descendants, k=9", 9, 3, (150, 300), (4200, 4400), 1000, "bands", 11),
        ("wide descendants, k=12", 12, 3, (150, 300), (4200, 4400), 1000, "bands", 12),
        ("ragged wide group, idle bands, k=9", 9, 3, (150, 300), (600, 4400), 1000,
         "bands", 12, True),
        ("wide descendants at the barrier, k=9", 9, 3, (300, 600), (6500, 6600), 1000,
         "barrier", 13),
        ("wide group of wide descendants, k=9", 9, 67, (150, 300), (6500, 6600), 1000,
         "global", 17),
    ]
    errs = [check_segment_case(dev, *c) for c in cases]
    check_band_watchdog(dev)
    return max(e[0] for e in errs), max(e[1] for e in errs)


def check_long_case(dev, name, k, B, la_range, lb_range, H, seed, shape=None):
    """One ragged group through the long path's kernels on the fill's strips
    and through their plain versions, band by band from the last: pass 1's
    corners and checkpoint rows (on every entry the kernel defines), each
    band's backpointers on its true cells, the band walk's state and ops
    after every band, and at the end the ops and scores of the whole-stack
    route (fused_align_ops) must be bit-equal. shape: (W, warps, blocks)
    forced on both passes (stripe passes, several blocks a pair), else the
    rules' launches (score_shape, band_shape)."""
    aseq, bseq, la, lb = _random_group(seed, k, la_range, lb_range, B)
    aln = alignment_params(gap_len=k)
    p = params_from_numpy(aln.subst_matrix, aln.gap, dev)
    tla, tlb = (torch.from_numpy(x).to(dev) for x in (la, lb))
    args = (*(torch.from_numpy(x).to(dev) for x in (aseq, bseq)), tla, tlb,
            p.table, p.gap_consts)
    B, NA = aseq.shape
    C = bseq.shape[1] + k
    Cp = fill_mod.row_stride(C)
    top = (int(la.max()) + k - 1) // H
    launches = (None, None)
    if shape is not None:
        launches = tuple(fill_mod.fill_launch(B, C, k, *shape[:2], 1, shape[2],
                                              widths=w)
                         for w in (fill_mod.SCORE_WIDTHS, fill_mod.STRIP_WIDTHS))
    adj_k, ck_k = score_mod.wavefront_score_ckpt(*args, k=k, band_rows=H,
                                                 n_ckpt=top, launch=launches[0])
    adj_p, ck_p = score_mod.ckpt_plain(*args, k=k, band_rows=H, n_ckpt=top)
    defined = score_mod.ckpt_cells(tla, tlb, k, H, top, Cp)
    if not (torch.equal(adj_k, adj_p) and torch.equal(ck_k[defined], ck_p[defined])):
        raise AssertionError(f"long case {name}: pass 1 differs from the plain version")
    err = float((ck_k[defined] - ck_p[defined]).abs().max())
    steps = int((la + lb).max())
    st_k = torch.empty((4, B), dtype=torch.int32, device=dev)
    st_p = st_k.clone()
    ops_k = torch.full((steps, B), -1, dtype=torch.int8, device=dev)
    ops_p = ops_k.clone()
    n_cells = 0
    walk_err = 0.0
    for b in range(top, -1, -1):
        bp_k = fill_mod.wavefront_fill_band(*args, ck_k[b - 1] if b else None, k=k,
                                            row0=b * H, band_rows=H, launch=launches[1])
        bp_p = band_fill_plain(*args, ck_p[b - 1] if b else None, k=k, row0=b * H,
                               band_rows=H)
        mask = fill_mod.true_cells(tla, tlb, k, (b + 1) * H, Cp)[:, b * H:]
        n_cells += int(mask.sum())
        if not torch.equal(bp_k[mask], bp_p[mask]):
            raise AssertionError(f"long case {name}: band {b}'s bp differs from the "
                                 f"plain version ({int((bp_k[mask] != bp_p[mask]).sum())} cells)")
        start_k, start_p = ((adj, tla, tlb) if b == top else None for adj in (adj_k, adj_p))
        _, _, score_k = walk_mod.walk_band(bp_k, b * H, st_k, ops_k, k=k, start=start_k)
        _, _, score_p = walk_band_plain(bp_p, b * H, st_p, ops_p, k=k, start=start_p)
        walk_err = max(walk_err, walk_difference(st_k, ops_k, st_p, ops_p))
        if not (torch.equal(st_k, st_p) and torch.equal(ops_k, ops_p)):
            raise AssertionError(f"long case {name}: the band walk differs from the "
                                 f"plain version after band {b}")
        if b == top:
            if not torch.equal(score_k, score_p):
                raise AssertionError(f"long case {name}: walk scores differ")
            score = score_k
    want_ops, want_score = engine.fused_align_ops(*args, k=k, max_steps=steps)
    if not (torch.equal(ops_k, want_ops) and torch.equal(score, want_score)):
        raise AssertionError(f"long case {name}: the long path differs from the "
                             f"whole-stack fill and walk")
    shp = "forced" if shape else "the rules'"
    say("kernels", f"{name}: B={B} NA={NA} NB={C - k} k={k}, {top + 1} bands of {H} "
        f"rows, {shp} launches: corners and {int(defined.sum())} checkpoint entries, "
        f"bp on {n_cells} true cells, walk state and {int((ops_k >= 0).sum())} ops "
        f"bit-equal to plain after every band; equal to the whole-stack route")
    return err, walk_err


def phase_long_kernels(dev):
    """The long path's kernels on strips (k <= 8) against their plain
    versions: k = 1, 3 and 8, ragged groups, bands of a few hundred rows, a
    group spread over several blocks a pair, forced shapes with stripe
    passes, and strips of 16 over cooperative blocks (the 160,002 nt pair's
    shape)."""
    cases = [
        ("long, ragged 0.8-1.2 knt", 1, 3, (800, 1200), (800, 1200), 300, 31),
        ("long, wide descendants over blocks", 1, 2, (150, 300), (2500, 3000), 120, 32),
        ("long, k=3", 3, 3, (450, 600), (450, 600), 150, 33),
        ("long, k=8", 8, 2, (480, 720), (480, 720), 240, 34),
        ("long, stripe passes over blocks", 1, 2, (300, 450), (1500, 2000), 150, 35,
         (4, 2, 3)),
        ("long, k=3, stripe passes", 3, 2, (270, 360), (900, 1200), 150, 36, (4, 1, 2)),
        # the instantiation band_shape gives the 160,002 nt pair: strips of 16,
        # 4 warps a block, several cooperative blocks a pair
        ("long, W=16 over cooperative blocks", 1, 2, (250, 300), (4200, 5000), 120, 37,
         (16, 4, 3)),
    ]
    errs = [check_long_case(dev, *c) for c in cases]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def check_band_watchdog(dev):
    """A score-only sweep of one WATCHDOG_NT nt pair on the band route, with
    timer stamps: its last band waits for its first cell for longer than a
    stalled wait is allowed to last (STALL_CYCLES at the card's top clock),
    which it survives only because the counters it waits on keep moving. Its
    corners must equal the barrier route's."""
    aseq, bseq, la, lb = _random_group(31, 1, (WATCHDOG_NT, WATCHDOG_NT),
                                       (WATCHDOG_NT, WATCHDOG_NT), 1)
    p = params_from_numpy(alignment_params().subst_matrix, alignment_params().gap, dev)
    args = [torch.from_numpy(x).to(dev) for x in (aseq, bseq, la, lb)]
    args += [p.table, p.gap_consts]
    C = bseq.shape[1] + 1
    shape = seg_mod.sweep_shape(1, C, dev)
    probe = seg_mod.sweep_launch(1, C, 1, *shape, p.table.numel())
    stamps = torch.full((3 * probe.blocks,), -1, dtype=torch.int64, device=dev)
    launch = seg_mod.sweep_launch(1, C, 1, *shape, p.table.numel(), stamps=stamps)
    took_route("watchdog case", launch, "bands", dev)
    barrier = seg_mod.sweep_launch(1, C, 1, *shape, p.table.numel(),
                                   several="barrier")
    t0 = time.perf_counter()
    got = score_mod.wavefront_score(*args, k=1, launch=launch)
    torch.cuda.synchronize(dev)
    bands_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = score_mod.wavefront_score(*args, k=1, launch=barrier)
    torch.cuda.synchronize(dev)
    barrier_s = time.perf_counter() - t0
    if not torch.equal(got, want):
        raise AssertionError("watchdog case: the band route's corners differ "
                             "from the barrier route's")
    st = stamps.view(-1, 3).cpu()
    waited = float(st[-1, 1] - st[-1, 0]) / 1e9
    limit = STALL_CYCLES / TOP_SM_HZ
    if waited <= 1.5 * limit:
        raise AssertionError(f"watchdog case: the last band waited {waited:.2f} s "
                             f"for its first cell, not over 1.5 x the stall limit "
                             f"{limit:.2f} s: the case proves nothing")
    say("kernels", f"watchdog: 1 x {WATCHDOG_NT} nt score-only sweep, "
        f"{launch.blocks} bands of {launch.plan.width} x {launch.threads} threads: "
        f"the last band waited {waited:.2f} s for its first cell, "
        f"{waited / limit:.1f} x the stall limit ({STALL_CYCLES:.0e} cycles = "
        f"{limit:.2f} s at {TOP_SM_HZ / 1e6:.0f} MHz), and did not trap; corners "
        f"equal the barrier route's ({bands_s:.2f} s on the band route, "
        f"{barrier_s:.2f} s at the barrier)")


def forward_difference(want, got, what):
    """Largest absolute and relative difference of Forward values `got` from
    `want`, held to FWD_ATOL + FWD_RTOL * |want|; cells that are LOWEST on
    one side must be LOWEST on the other."""
    live = want > -1e30
    if not torch.equal(live, got > -1e30):
        raise AssertionError(f"{what}: LOWEST cells differ from the plain version")
    w, g = want[live].double(), got[live].double()
    if w.numel() == 0:
        return 0.0, 0.0
    diff = (w - g).abs()
    over = diff - (FWD_ATOL + FWD_RTOL * w.abs())
    abs_err = float(diff.max())
    rel_err = float((diff / w.abs().clamp(min=1e-30)).max())
    if not bool(torch.isfinite(g).all()) or float(over.max()) > 0:
        at = int(over.argmax())
        raise AssertionError(
            f"{what}: differs from the plain version by {float(diff[at]):.3e} "
            f"at value {float(w[at]):.6g} (max abs {abs_err:.3e}, max rel "
            f"{rel_err:.3e}; tolerance {FWD_ATOL} + {FWD_RTOL} * |value|)")
    return abs_err, rel_err


def check_walk(dev, name, mdi, enc_a, enc_b, p, n_samples, seed, corners=None):
    """The sample walk kernel against its plain version on the same matrices
    and the same uniforms: op streams equal, scores within SCORE_ATOL +
    SCORE_RTOL * |score|. corners: written into mdi's corner cell first.
    Returns the largest score difference."""
    k = p.k
    R, Cc = mdi.shape[:2]
    if corners is not None:
        mdi[R - 1, Cc - 1] = corners
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    uniforms = torch.rand(((R - k) + (Cc - k) + 1, n_samples), generator=gen,
                          dtype=torch.float32, device=dev)
    args = (mdi, enc_a, enc_b, p.table, p.gap_consts, uniforms)
    ops_p, sc_p = sample_paths_plain(*args, k=k)
    err = 0.0
    # walk_shape's windows, small ones, and one thread a sample (the route
    # walk_shape takes above k = 20)
    for S, warps in (sample_mod.walk_shape(k), SMALL_WINDOWS, (0, 1)):
        ops_k, sc_k = sample_mod.sample_walk(*args, k=k, S=S, warps=warps)
        shape = f"windows of {S} steps x {warps} warps" if S else "one thread a sample"
        err = max(err, compare_walks(f"{name}, {shape}", ops_k, sc_k, ops_p, sc_p))
    return err


def compare_walks(name, ops_k, sc_k, ops_p, sc_p):
    if not torch.equal(ops_k, ops_p):
        t, n = (int(x[0]) for x in torch.nonzero(ops_k != ops_p, as_tuple=True))
        raise AssertionError(
            f"sample walk {name}: op streams differ from the plain version in "
            f"{int((ops_k != ops_p).any(0).sum())} of {ops_k.shape[1]} samples, "
            f"first at step {t} of sample {n} (kernel {int(ops_k[t, n])}, plain "
            f"{int(ops_p[t, n])})")
    diff = (sc_k.double() - sc_p.double()).abs()
    if (not bool(torch.isfinite(sc_k).all())
            or bool((diff > SCORE_ATOL + SCORE_RTOL * sc_p.double().abs()).any())):
        raise AssertionError(
            f"sample walk {name}: scores differ from the plain version by up "
            f"to {float(diff.max()):.3e} (tolerance {SCORE_ATOL} + {SCORE_RTOL} "
            f"* |score|)")
    say("kernels", f"sample walk {name}: {ops_k.shape[1]} samples, "
        f"{int((ops_k >= 0).sum())} ops equal to plain, scores "
        f"{float(sc_k.min()):.3f}..{float(sc_k.max()):.3f} within "
        f"{float(diff.max()):.3e} of plain")
    return float(diff.max())


def check_forward_case(dev, name, k, B, la_range, lb_range, route, seed,
                       idle=False):
    """One ragged group through the Forward kernel and its plain version on
    the card: the adjusted corners and every M, D, I of each pair's (la+k) x
    (lb+k) rectangle, margins included, within the tolerance; then the
    sample walk on the kernel's matrices of pair 0 against its plain
    version. route and idle as check_segment_case's."""
    aseq, bseq, la, lb = _random_group(seed, k, la_range, lb_range, B)
    aln = alignment_params(gap_len=k)
    p = params_from_numpy(aln.subst_matrix, aln.gap, dev)
    a, b, tla, tlb = (torch.from_numpy(x).to(dev) for x in (aseq, bseq, la, lb))
    args = (a, b, tla, tlb, p.table, p.gap_consts)
    launch = case_launch(dev, f"forward case {name}", fwd_mod.forward_shape, B,
                         bseq.shape[1] + k, k, route, idle, lb + k)
    adj_k, mdi_k = fwd_mod.wavefront_forward(*args, k=k, launch=launch)
    adj_p, mdi_p = fwd_mod.forward_plain(*args, k=k)
    abs_err, rel_err = forward_difference(adj_p, adj_k, f"forward case {name}: corners")
    cells, lowest = 0, 0.0
    for q in range(B):
        rect = (slice(0, int(la[q]) + k), slice(0, int(lb[q]) + k))
        e = forward_difference(mdi_p[q][rect], mdi_k[q][rect],
                               f"forward case {name}: pair {q}")
        abs_err, rel_err = max(abs_err, e[0]), max(rel_err, e[1])
        cells += (int(la[q]) + k) * (int(lb[q]) + k)
        lowest = min(lowest, float(mdi_k[q][rect][mdi_k[q][rect] > -1e30].min()))
    say("kernels", f"forward {name}: B={B} NA={aseq.shape[1]} NB={bseq.shape[1]} "
        f"k={k} {launch.blocks} x {launch.threads} threads a pair, route {route}: corners and "
        f"M, D, I of {cells} cells within {abs_err:.3e} (relative {rel_err:.3e}) "
        f"of plain, values down to {lowest:.1f}")
    # pair 0's matrices, cut to its rectangle, with its adjusted corners
    R0, C0 = int(la[0]) + k, int(lb[0]) + k
    walk_err = check_walk(
        dev, name, mdi_k[0, :R0, :C0].contiguous(), a[0, : R0 - k].contiguous(),
        b[0, : C0 - k].contiguous(), p, 203, seed, corners=adj_k[:, 0])
    return abs_err, walk_err


def phase_sample_kernels(dev):
    """The Forward kernel and the sample walk against their plain versions:
    k = 1, 3 and 5, ragged groups (some with idle bands), every route of the
    sweep (the barrier forced, at k = 1 and 3)."""
    cases = [
        ("ragged 0.6-1 knt", 1, 5, (600, 999), (600, 999), "shared", 21),
        ("ragged 0.6-1 knt, k=3", 3, 5, (600, 999), (600, 999), "shared", 22),
        ("wide descendants", 1, 3, (150, 300), (4200, 4400), "bands", 11),
        ("wide descendants, k=3", 3, 3, (150, 300), (4200, 4400), "bands", 11),
        ("wide descendants, k=5", 5, 3, (150, 300), (4200, 4400), "bands", 11),
        ("ragged wide group, idle bands", 1, 3, (150, 300), (600, 4400), "bands",
         12, True),
        ("wide descendants at the barrier", 1, 3, (300, 600), (6500, 6600),
         "barrier", 23),
        ("wide descendants at the barrier, k=3", 3, 3, (300, 600), (4900, 5100),
         "barrier", 24),
        ("wide group of wide descendants", 1, 67, (90, 150), (6500, 6600),
         "global", 25),
        ("wide group of wide descendants, k=3", 3, 67, (90, 150), (4900, 5100),
         "global", 26),
    ]
    # the window route's shared memory as the wrapper counts it and as the
    # kernel's library does, at every shape walk_shape picks
    lib, table_len = _build.load(), sample_mod.TABLE_LEN
    for k in range(1, 21):
        S, warps = sample_mod.walk_shape(k)
        mine = sample_mod.table_bytes(table_len) + warps * sample_mod.window_bytes(k, S)
        theirs = lib.coati_sample_walk_smem_bytes(k, S, warps, table_len)
        if theirs != mine:
            raise AssertionError(f"sample walk at k={k}, S={S}, {warps} warps: "
                                 f"{theirs} bytes of shared memory in the library, "
                                 f"{mine} in kernels/sample_walk.py")
    say("kernels", "sample walk: the window layout's size agrees with the library's "
        "at walk_shape's shape for k = 1-20")
    errs = [check_forward_case(dev, *c) for c in cases]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def phase_kernels(dev):
    def one_block(launch):
        return launch.blocks == 1 and launch.passes == 1

    def spread(launch):
        return launch.blocks > 1

    def table_in_device(launch):
        return not launch.table_shared

    main_shape = check_case(dev, "main-path shape, 999 nt", 1, 64, (600, 999),
                            (600, 999), one_block, seed=1, timing="all")
    # the same shape with a table too large for shared memory (24 x 183 x 15
    # f32 = 263,520 B): read from device memory, timed against the one above
    main_global = check_case(dev, "main-path shape, stacked table_idx G=24", 1,
                             64, (600, 999), (600, 999), table_in_device, G=24,
                             seed=1, timing="kernels")
    cases = [main_shape, main_global,
             check_case(dev, "pairs over 4,096 slots, several blocks a pair", 1,
                        2, (300, 300), (6240, 6240), spread, seed=6),
             check_case(dev, "C~6000 pairs, stacked table_idx G=24", 3, 2,
                        (1500, 3000), (5997, 5997),
                        lambda ln: spread(ln) and table_in_device(ln), G=24, seed=7),
             check_case(dev, "k=3 ragged", 3, 32, (150, 480), (150, 480),
                        one_block, seed=2),
             check_case(dev, "k=5 ragged, IUPAC + gap codes", 5, 16, (150, 480),
                        (150, 480), one_block, n_codes=16, seed=8),
             # the last strip bodies the fill and score kernels are built for
             check_case(dev, "k=6 ragged", 6, 16, (150, 480), (150, 480),
                        one_block, seed=12),
             check_case(dev, "k=7 ragged, IUPAC + gap codes", 7, 16, (150, 480),
                        (150, 480), one_block, n_codes=16, seed=13),
             check_case(dev, "k=8 ragged", 8, 16, (150, 480), (150, 480),
                        one_block, seed=14),
             check_case(dev, "IUPAC + gap codes", 1, 32, (96, 300), (96, 300),
                        one_block, n_codes=16, seed=3),
             check_case(dev, "stacked table_idx G=3", 1, 30, (96, 300),
                        (96, 300), one_block, G=3, seed=4),
             check_case(dev, "stripe passes, two pairs a block (forced)", 3, 9,
                        (300, 600), (300, 600), lambda ln: ln.passes > 1,
                        seed=9, launch=(4, 1, 2, 1)),
             check_case(dev, "passes over several blocks (forced)", 1, 2,
                        (300, 300), (2000, 2000),
                        lambda ln: ln.passes > 1 and spread(ln), seed=10,
                        launch=(8, 2, 1, 3))]
    main_shape["fill_global_table_ms"] = main_global["fill_ms"]
    sweep_err = check_sweep_route(dev, fill_mod.MAX_K + 1, 6, (270, 540),
                                  (180, 360), seed=11)
    return (main_shape, max(c["fill_err"] for c in cases) + sweep_err,
            max(c["walk_err"] for c in cases))


# --- phase 4 ----------------------------------------------------------------
def _batch_text(named, device, model="mar-mg"):
    """batch_align's output for `named` on `device` (a device or lanes):
    (pairs aligned, the JSON lines as written)."""
    out = io.StringIO()
    n = batchrun.batch_align(alignment_params(model), named, out, device=device)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return n, out.getvalue()


def _run_batch(named, dev, model="mar-mg"):
    n, text = _batch_text(named, dev, model)
    return n, [json.loads(line) for line in text.splitlines()]


def _check_rows(named, rows):
    """Every row holds a finite score and an alignment that ungaps to its
    inputs."""
    for (na, a, nd, b), row in zip(named, rows):
        aln = row.get("alignment")
        if (aln is None or aln[na].replace("-", "") != a
                or aln[nd].replace("-", "") != b or len(aln[na]) != len(aln[nd])
                or not np.isfinite(row["score"])):
            raise AssertionError(f"bad alignment row {str(row)[:300]}")


def _subset_matches_plain(named, rows, dev):
    """A stratified subset of the main path's pairs, run through batch_align
    on the same device with the plain fill and walk standing in for the
    kernels, gives the main path's rows (strings and f32 scores)."""
    by_len = {}
    for i, (_, a, _, _) in enumerate(named):
        by_len.setdefault(len(a), []).append(i)
    per = max(1, 256 // len(by_len))
    subset = [i for idxs in by_len.values() for i in idxs[:per]]
    with wrappers({n: PLAIN[n] for n in ("wavefront_fill", "traceback_walk")}):
        _, plain = _run_batch([named[i] for i in subset], dev)
    for i, got in zip(subset, plain):
        want = rows[i]
        if (got["alignment"], got["score"]) != (want["alignment"], want["score"]):
            raise AssertionError(f"pair {i}: kernel path {want} != plain {got}")
    return len(subset)


def _cli_reference_example(dev):
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "example.fasta"
        out = Path(tmp) / "out.fasta"
        src.write_text(">1\nCTCTGGATAGTG\n>2\nCTATAGTG\n")
        rc = cli.main(["alignpair", str(src), "-o", str(out),
                       "--device", dev.type])
        lines = out.read_text().split()
        if rc != 0 or "CT----ATAGTG" not in lines:
            raise AssertionError(f"alignpair reference example: rc={rc} {lines}")
    return lines


def phase_main(dev, n_pairs=N_PAIRS):
    t0 = time.perf_counter()
    pairs = make_pairs(n_pairs, np.random.default_rng(0), length_mix=LENGTH_MIX)
    named = [(f"anc{i}", a, f"des{i}", b) for i, (a, b) in enumerate(pairs)]
    say("main", f"made {len(named)} pairs in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    _run_batch(named, dev)  # first run: allocator, pinned pools, caches
    cold = time.perf_counter() - t0

    reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cpu0, t0 = cpu_seconds(), time.perf_counter()
    n, text = _batch_text(named, dev)
    warm, cpu = [time.perf_counter() - t0], [cpu_seconds() - cpu0]
    rows = [json.loads(line) for line in text.splitlines()]
    launches = {name: count for name, count in launch_counts().items()
                if name in ("wavefront_fill", "traceback_walk")}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    if n != len(named) or len(rows) != len(named):
        raise AssertionError(f"aligned {n} of {len(named)} pairs")
    _check_rows(named, rows)
    if dev.type == "cuda" and min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    golden = json.loads(GOLDEN.read_text())["pairs"]
    for want in golden:
        got = golden_record(want["index"], rows[want["index"]])
        if got != want:
            raise AssertionError(f"pair {want['index']}: {got} != JAX reference {want}")
    n_sub = _subset_matches_plain(named, rows, dev)
    example = _cli_reference_example(dev)
    for _ in range(WARM_RUNS - 1):
        cpu0, t0 = cpu_seconds(), time.perf_counter()
        again = _batch_text(named, dev)[1]
        warm.append(time.perf_counter() - t0)
        cpu.append(cpu_seconds() - cpu0)
        if again != text:
            bad = sum(x != y for x, y in zip(again.splitlines(), text.splitlines()))
            raise AssertionError(f"warm run {len(warm)}: {bad} rows differ from the "
                                 f"checked run's")
    say("main", f"batch_align {n} pairs: cold {cold:.2f} s, warm "
        f"{', '.join(f'{w:.3f}' for w in warm)} s; "
        f"launches {launches}; all ungap to their inputs; {len(golden)} golden "
        f"pairs equal the JAX reference; {n_sub}-pair stratified "
        f"subset equals the plain version; alignpair example -> {example[-1]}; "
        f"every warm run's output byte-equal to the checked run's")
    say("main", f"host over the {len(warm)} timed warm runs: CPU {sum(cpu):.3f} s of "
        f"this process over {sum(warm):.3f} s of wall ({sum(cpu) / sum(warm):.1%}), "
        f"torch.get_num_threads() {torch.get_num_threads()}")
    ops = aten_counts(lambda: _run_batch(named, dev))
    pinned = {name: ops.get(name, 0) for name in PIN_OPS}
    if any(pinned.values()):
        raise AssertionError(f"a warm run of the main path pinned tensors: {pinned}")
    say("main", f"one warm run under torch.profiler: {pinned}; ATen operations "
        f"by calls: " + ", ".join(f"{name} {c}" for name, c in
                                  sorted(ops.items(), key=lambda x: -x[1])[:16]))

    true_cells = sum(len(a) * len(b) for _, a, _, b in named)
    timer = None
    if dev.type == "cuda":
        t0 = time.perf_counter()
        with KernelTimer(dev) as timer:
            _run_batch(named, dev)
        timer.wall = time.perf_counter() - t0
    return {"warm_s": warm, "cold_s": cold, "launches": launches, "peak": peak,
            "true_cells": true_cells, "timer": timer, "n": n, "named": named,
            "rows": rows}


def cpu_seconds() -> float:
    """This process's CPU seconds, user and system, over all its threads."""
    t = os.times()
    return t.user + t.system


def aten_counts(run) -> dict:
    """{ATen operation: calls} of run() under torch.profiler, CPU activity."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    return {e.key: e.count for e in prof.key_averages() if e.key.startswith("aten::")}


# --- trace ------------------------------------------------------------------
@contextlib.contextmanager
def library_events(names):
    """CUDA events on the current stream around every call of the kernel
    library's entry points `names`: {name: [(start, end), ...]}. They
    bracket the launch alone, not the wrapper's Python before it, which a
    trace of every Python function slows."""
    lib = _build.load()
    real = {name: getattr(lib, name) for name in names}
    events = {name: [] for name in names}

    def timed(name, fn):
        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = fn(*args)
            end.record()
            events[name].append((start, end))
            return rc
        return call

    for name, fn in real.items():
        setattr(lib, name, timed(name, fn))
    try:
        yield events
    finally:
        for name, fn in real.items():
            setattr(lib, name, fn)


def _traced(what, log_dir, wall, kernels_on_path):
    """Read the one trace file in log_dir: a line of its size, the card's
    busy share and the top host functions by self time, as shares of the
    traced span (the first to the last Python function event: `wall` also
    holds the profiler's start and the trace's export). Returns (events,
    {kernel name: (launches, us)})."""
    files = profiling.trace_files(log_dir)
    if len(files) != 1:
        raise AssertionError(f"trace of {what}: {len(files)} files, not one")
    t0 = time.perf_counter()
    events = profiling.load_trace(files[0])
    parse_s = time.perf_counter() - t0
    kernels = profiling.kernel_totals(events)
    busy_us = sum(us for _, us in kernels.values())
    missing = [k for k in kernels_on_path if not any(k in name for name in kernels)]
    if missing:
        raise AssertionError(f"trace of {what}: no kernel named {missing}: "
                             f"{sorted(kernels)[:20]}")
    host = profiling.host_self_times(events)
    funcs = [e for e in events if e.get("cat") == "python_function"]
    span_us = (max(e["ts"] + e.get("dur", 0.0) for e in funcs)
               - min(e["ts"] for e in funcs))
    top = "; ".join(f"{name} {us / 1e3:.1f} ms ({us / span_us:.1%}, {n} calls)"
                    for name, us, n in host[:TRACE_TOP])
    say("trace", f"{what}: trace {files[0].stat().st_size / 1e6:.1f} MB, {len(events)} "
        f"events, parsed in {parse_s:.1f} s; traced span {span_us / 1e6:.3f} s of a "
        f"{wall:.3f} s wall; {sum(n for n, _ in kernels.values())} kernels "
        f"{busy_us / 1e3:.1f} ms = the card busy {busy_us / span_us:.1%} of the span; "
        f"host by self time: {top}")
    return events, kernels


def phase_trace(dev, card, main_run):
    """batch --trace-dir over the main mix's first TRACE_PAIRS pairs: the
    output byte-equal to the same batch without the trace; one trace file
    that parses; its kernel events hold the fill's and the walk's kernels,
    as many launches of each as KernelTimer counted in the same run, their
    summed duration within TRACE_DURATION_TOL of the CUDA events around the
    library's launches. Then the same trace, unchecked, of sample at
    SAMPLE_RUNS[0] and of batch -m tri-mg at TRIPLET_BATCHES[0], for their
    host profiles by function."""
    named = main_run["named"][:TRACE_PAIRS]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        src = tmp / "mix.fasta"
        src.write_text("".join(f">{na}\n{a}\n>{nd}\n{b}\n" for na, a, nd, b in named))
        argv = ["batch", str(src), "--device", dev.type]
        t0 = time.perf_counter()
        if cli.main(argv + ["-o", str(tmp / "plain.jsonl")]) != 0:
            raise AssertionError("batch without --trace-dir failed")
        torch.cuda.synchronize(dev)
        wall_plain = time.perf_counter() - t0
        entry = {"wavefront_fill": "coati_wavefront_fill",
                 "traceback_walk": "coati_traceback_walk"}
        t0 = time.perf_counter()
        with KernelTimer(dev) as timer, library_events(list(entry.values())) as lib:
            rc = cli.main(argv + ["-o", str(tmp / "traced.jsonl"),
                                  "--trace-dir", str(tmp / "trace")])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"batch --trace-dir failed: rc={rc}")
        if (tmp / "traced.jsonl").read_bytes() != (tmp / "plain.jsonl").read_bytes():
            raise AssertionError("batch --trace-dir wrote other bytes than batch")
        names = {"wavefront_fill": "strip_fill_kernel<",
                 "traceback_walk": "traceback_walk_kernel<false>("}
        events, kernels = _traced(f"[{card}] batch --trace-dir, {len(named)} pairs of the "
                                  f"main mix", tmp / "trace", wall, list(names.values()))
        got = {}
        for wrapper, pattern in names.items():
            runs = [v for name, v in kernels.items() if pattern in name]
            got[wrapper] = (sum(n for n, _ in runs), sum(us for _, us in runs))
            if got[wrapper][0] != timer.count(wrapper) or timer.count(wrapper) == 0:
                raise AssertionError(f"trace: {got[wrapper][0]} launches of {pattern}, "
                                     f"KernelTimer counted {timer.count(wrapper)}")
        traced_ms = sum(us for _, us in got.values()) / 1e3
        events_ms = sum(s.elapsed_time(e) for pairs in lib.values() for s, e in pairs)
        if not abs(traced_ms - events_ms) <= TRACE_DURATION_TOL * events_ms:
            raise AssertionError(f"trace: fill and walk {traced_ms:.3f} ms in the trace, "
                                 f"{events_ms:.3f} ms by CUDA events")
        ranges = profiling.range_totals(events)
        say("trace", f"[{card}] output byte-equal to batch without the trace "
            f"({wall_plain:.3f} s wall untraced, {wall:.3f} s traced: "
            f"{wall / wall_plain:.1f}x); fill {got['wavefront_fill'][0]} and walk "
            f"{got['traceback_walk'][0]} launches, as KernelTimer counted; their "
            f"{traced_ms:.3f} ms in the trace against {events_ms:.3f} ms by CUDA events "
            f"around the launches ({traced_ms / events_ms - 1:+.1%}; around the wrappers "
            f"{(timer.seconds('wavefront_fill') + timer.seconds('traceback_walk')) * 1e3:.3f} "
            f"ms); ranges " + ", ".join(f"{name} {n} x {us / 1e3:.1f} ms"
                                        for name, (n, us) in sorted(ranges.items())))
        del events

        nt, n, seed = SAMPLE_RUNS[0]
        (a, b), = make_pairs(1, np.random.default_rng(seed), length_mix=[(nt, 1.0)])
        src = tmp / "pair.fasta"
        src.write_text(f">anc\n{a}\n>des\n{b}\n")
        argv = ["sample", str(src), "-n", str(n), "-s", str(seed), "--device", dev.type,
                "-o", str(tmp / "samples.json")]
        if cli.main(argv) != 0:
            raise AssertionError("sample failed")
        t0 = time.perf_counter()
        with profiling.trace(str(tmp / "trace_sample"), dev):
            cli.main(argv)
        _traced(f"[{card}] sample, {nt} nt x {n}", tmp / "trace_sample",
                time.perf_counter() - t0, ["wavefront_", "sample_"])

        n, nt, seed = TRIPLET_BATCHES[0]
        pairs = make_pairs(n, np.random.default_rng(seed), length_mix=[(nt, 1.0)])
        src = tmp / "tri.fasta"
        src.write_text("".join(f">anc{i}\n{a}\n>des{i}\n{b}\n"
                               for i, (a, b) in enumerate(pairs)))
        argv = ["batch", str(src), "-m", "tri-mg", "--device", dev.type,
                "-o", str(tmp / "tri.jsonl")]
        if cli.main(argv) != 0:
            raise AssertionError("batch -m tri-mg failed")
        t0 = time.perf_counter()
        cli.main(argv + ["--trace-dir", str(tmp / "trace_tri")])
        _traced(f"[{card}] batch -m tri-mg --trace-dir, {n} pairs of {nt} nt",
                tmp / "trace_tri", time.perf_counter() - t0,
                ["triplet_rows", "triplet_walk"])


# --- phase 5 ----------------------------------------------------------------
def _encoded(pairs):
    enc = [encode_marginal(a, b) for a, b in pairs]
    return ([e[0] for e in enc], [e[1] for e in enc],
            [a for a, _ in pairs], [b for _, b in pairs])


def _trimmed(pairs):
    """Each pair as SeqData with its end stop codons trimmed (.stops), as
    batch_align and alignpair trim them."""
    datas = []
    for a, b in pairs:
        d = SeqData(names=["anc", "des"], seqs=[a, b])
        utils.trim_end_stops(d)
        datas.append(d)
    return datas


def score_kernel_scores(pairs, aln, dev):
    """The scores batch_align and alignpair must give for `pairs`: the score
    kernel's over the pairs with their end stop codons trimmed, then the
    end-stop adjustment those verbs apply (utils.restore_end_stops)."""
    datas = _trimmed(pairs)
    enc_as, enc_bs, _, _ = _encoded([tuple(d.seqs) for d in datas])
    scores = engine.viterbi_scores_batch(enc_as, enc_bs, aln.subst_matrix,
                                         aln.gap, device=dev)
    out = []
    for d, sc in zip(datas, scores):
        d.score = float(sc)
        utils.restore_end_stops(d, aln.gap)
        out.append(np.float32(d.score))
    return out


def _same_results(what, got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        if (g.seq0, g.seq1) != (w.seq0, w.seq1) or np.float32(g.score) != np.float32(w.score):
            raise AssertionError(f"{what}: pair {i} differs (scores {g.score} "
                                 f"and {w.score})")


def _forced_group_matches_plain(dev, aln):
    """Two pairs of 3-4 knt through the long path in bands of 1,000 rows (a
    budget of one such band): the kernels' strings and scores equal the
    plain versions' on the card."""
    pairs = make_pairs(2, np.random.default_rng(2), length_mix=[(2997, 0.5), (3996, 0.5)])
    enc = _encoded(pairs)
    Cp = fill_mod.row_stride(max(len(b) for b in enc[1]) + int(aln.gap.len))
    run = lambda: longseq.viterbi_align_long_batch(  # noqa: E731
        *enc, aln.subst_matrix, aln.gap, device=dev)
    names = ("wavefront_score_ckpt", "wavefront_fill_band", "traceback_walk_band")
    with bp_budget(len(pairs) * Cp * 1000):
        got = run()
        with wrappers({n: PLAIN[n] for n in names}):
            want = run()
    _same_results("forced long group against plain", got, want)
    for (a, b), r in zip(pairs, got):
        if r.seq0.replace("-", "") != a or r.seq1.replace("-", "") != b:
            raise AssertionError("forced long group does not ungap to its inputs")
    return [len(a) for a, _ in pairs]


def _long_golden_matches(dev, aln):
    golden = json.loads(LONG_GOLDEN.read_text())
    pairs = long_golden_pairs(golden["seed"])
    res = engine.viterbi_align_batch(*_encoded(pairs), aln.subst_matrix, aln.gap,
                                     long_slots=LONG_GOLDEN_SLOTS, device=dev)
    for want in golden["pairs"]:
        got = long_golden_record(want["index"], res[want["index"]])
        if got != want:
            raise AssertionError(f"long pair {want['index']}: {got} != JAX "
                                 f"reference {want}")
    return len(golden["pairs"])


@contextlib.contextmanager
def bp_budget(n_bytes):
    """longseq.BP_BUDGET_BYTES set to n_bytes (the long path reads it at the
    call)."""
    old = longseq.BP_BUDGET_BYTES
    longseq.BP_BUDGET_BYTES = n_bytes
    try:
        yield
    finally:
        longseq.BP_BUDGET_BYTES = old


def _timed_plain(dev, fn):
    """(fn's result, its milliseconds on the host clock to a synchronised
    end): a plain version's one run is both its check and its time."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t0) * 1e3


def _band_cell(dev, long_pairs, aln):
    """The long phase's group of long pairs at its full shape, as its rows
    path cuts it: pass 1 (the checkpointing score kernel), the middle band's
    fill from its checkpoint and the band walk through it (from the state
    the kernels' own walk enters it with), each against its plain version
    on the same inputs, bit for bit, and timed."""
    k = int(aln.gap.len)
    enc_as, enc_bs, _, _ = _encoded(long_pairs)
    aseq, bseq, la, lb = longseq._pad_group(enc_as, enc_bs)
    p = params_from_numpy(aln.subst_matrix, aln.gap, dev)
    a, b, tla, tlb = (torch.from_numpy(x).to(dev) for x in (aseq, bseq, la, lb))
    args = (a, b, tla, tlb, p.table, p.gap_consts)
    B, NA = aseq.shape
    C = bseq.shape[1] + k
    Cp = fill_mod.row_stride(C)
    H = longseq.band_rows_for(B, Cp, k)
    top = (int(la.max()) + k - 1) // H
    mid = top // 2
    r0 = mid * H

    def ckpt_run():
        return score_mod.wavefront_score_ckpt(*args, k=k, band_rows=H, n_ckpt=top)

    adj, ckpt = ckpt_run()
    (adj_p, ck_p), ckpt_plain_ms = _timed_plain(dev, lambda: score_mod.ckpt_plain(
        *args, k=k, band_rows=H, n_ckpt=top))
    defined = score_mod.ckpt_cells(tla, tlb, k, H, top, Cp)
    if not (torch.equal(adj, adj_p) and torch.equal(ckpt[defined], ck_p[defined])):
        raise AssertionError("band cell: pass 1 differs from the plain version")
    ckpt_err = float((ckpt[defined] - ck_p[defined]).abs().max())
    n_ckpt_entries = int(defined.sum())
    del ck_p, defined

    # the kernels' walk down to the middle band
    state = torch.empty((4, B), dtype=torch.int32, device=dev)
    ops = torch.full((NA + bseq.shape[1], B), -1, dtype=torch.int8, device=dev)
    for band in range(top, mid, -1):
        bp = fill_mod.wavefront_fill_band(*args, ckpt[band - 1], k=k, row0=band * H,
                                          band_rows=H)
        walk_mod.walk_band(bp, band * H, state, ops, k=k,
                           start=(adj, tla, tlb) if band == top else None)
    del bp
    ck = ckpt[mid - 1] if mid else None

    def band_run():
        return fill_mod.wavefront_fill_band(*args, ck, k=k, row0=r0, band_rows=H)

    bp_k = band_run()
    bp_p, band_plain_ms = _timed_plain(dev, lambda: band_fill_plain(
        *args, ck, k=k, row0=r0, band_rows=H))
    mask = fill_mod.true_cells(tla, tlb, k, r0 + H, Cp)[:, r0:]
    band_cells = int(mask.sum())
    if not torch.equal(bp_k[mask], bp_p[mask]):
        raise AssertionError(f"band cell: band {mid}'s bp differs from the plain "
                             f"version ({int((bp_k[mask] != bp_p[mask]).sum())} cells)")
    del bp_p, mask

    def walk_run(fn):
        st, o = state.clone(), ops.clone()
        fn(bp_k, r0, st, o, k=k)
        return st, o

    st_k, ops_k = walk_run(walk_mod.walk_band)
    (st_p, ops_p), walk_plain_ms = _timed_plain(dev, lambda: walk_run(walk_band_plain))
    walk_err = walk_difference(st_k, ops_k, st_p, ops_p)
    if not (torch.equal(st_k, st_p) and torch.equal(ops_k, ops_p)):
        raise AssertionError("band cell: the band walk differs from the plain version")
    steps = int((st_k[3] - state[3]).sum())

    cells = int(((la.astype(np.int64) + k) * (lb.astype(np.int64) + k)).sum())
    in_bytes = sum(t.numel() * t.element_size() for t in args)
    band_in = in_bytes + (0 if ck is None else ck.numel() * 4)
    out = {
        "shape": f"B={B} NA={NA} NB={C - k} k={k}, {top + 1} bands of {H} rows, "
                 f"band {mid} (rows {r0}-{r0 + H - 1})",
        "ckpt_ms": elapsed_ms(ckpt_run, dev, 2), "ckpt_plain_ms": ckpt_plain_ms,
        "band_ms": elapsed_ms(band_run, dev, 2), "band_plain_ms": band_plain_ms,
        "walk_ms": elapsed_ms(lambda: walk_run(walk_mod.walk_band), dev, 5),
        "walk_plain_ms": walk_plain_ms,
        "ckpt_err": ckpt_err, "band_err": 0.0, "walk_err": walk_err,
        "steps": steps, "band_cells": band_cells, "cells": cells,
        # pass 1 reads the inputs once, writes the corners and the checkpoint
        # entries; every true cell once without backpointers
        "ckpt_bound": bound(in_bytes + 12 * B + 4 * n_ckpt_entries, cells * CELL_OPS),
        # a band reads the inputs and its checkpoint, writes 1 B a true cell
        "band_bound": bound(band_in + band_cells, band_cells * CELL_OPS_BP),
        # the walk reads 1 B a step and its state, writes 1 B a step and its state
        "walk_bound": bound(2 * steps + 2 * 16 * B, 0),
    }
    say("long", f"band cell {out['shape']}: pass 1 {out['ckpt_ms']:.2f} ms (plain "
        f"{ckpt_plain_ms:.0f} ms), {n_ckpt_entries} checkpoint entries and the corners "
        f"bit-equal; the band with bp {out['band_ms']:.2f} ms (plain {band_plain_ms:.0f} "
        f"ms), {band_cells} true cells bit-equal; the band walk of {steps} steps "
        f"{out['walk_ms']:.3f} ms (plain {walk_plain_ms:.0f} ms), state and ops equal")
    return out


def _sweep_run(dev):
    """Gap length K_SWEEP (above the strip body's MAX_K): a batch of the main
    mix, its pairs cut to multiples of 3k, and SWEEP_LONG long pairs whose
    stacks of diagonals pass the default budget, through
    viterbi_align_batch at the default routing, counters reset just before
    and read just after: the whole-matrix pairs take the sweep with bp and
    the segment walk, the long ones the segments of diagonals (K5 without
    and with bp, the segment walk); nothing of the strips launches. Every
    alignment ungaps to its inputs and equals the run with every pair on
    the whole-matrix sweep (a budget none passes). Then the long group's
    middle segment at its full shape against the plain versions
    (_segment_cell)."""
    aln = alignment_params(gap_len=K_SWEEP)
    k = K_SWEEP
    n_mix, n_long = SWEEP_PAIRS
    cut = lambda s: s[: len(s) // (3 * k) * (3 * k)]  # noqa: E731
    mix = [(cut(a), cut(b)) for a, b in
           make_pairs(n_mix, np.random.default_rng(19), length_mix=LENGTH_MIX[:3])]
    longs = [(cut(a), cut(b)) for a, b in
             make_pairs(n_long, np.random.default_rng(20), length_mix=SWEEP_LONG_MIX)]
    pairs = mix + longs
    enc = _encoded(pairs)
    routed = [longseq.is_long_pair(len(x), len(y), k) for x, y in zip(enc[0], enc[1])]
    if routed != [False] * n_mix + [True] * n_long:
        raise AssertionError(f"k={k}: the default budget did not route exactly the "
                             f"{n_long} long pairs")
    reset_launch_counts()
    t0 = time.perf_counter()
    with KernelTimer(dev) as timer:
        got = engine.viterbi_align_batch(*enc, aln.subst_matrix, aln.gap, device=dev)
    timer.wall = time.perf_counter() - t0
    launches = launch_counts()
    with bp_budget(WHOLE_SWEEP_BUDGET):
        want = engine.viterbi_align_batch(*enc, aln.subst_matrix, aln.gap, device=dev)
    _same_results(f"k={k}: the long route against the whole-matrix sweep", got, want)
    del want
    _check_rows([("a", a, "b", b) for a, b in pairs],
                [{"alignment": {"a": r.seq0, "b": r.seq1}, "score": r.score} for r in got])
    strips = ("wavefront_fill", "traceback_walk", "wavefront_score_ckpt",
              "wavefront_fill_band", "traceback_walk_band")
    if timer.count("segment_pass1") == 0 or dev.type == "cuda" and (
            min(launches["wavefront_segment"], launches["traceback_walk_segment"]) == 0
            or any(launches[n] for n in strips)):
        raise AssertionError(f"k={k}: the sweep and the segment walk did not carry "
                             f"the batch alone: {launches}")
    cell = _segment_cell(dev, longs, aln)
    say("long", f"k={k}: {n_mix} pairs and {n_long} long ones of "
        f"{', '.join(f'{len(a)}x{len(b)}' for a, b in longs)} nt (by the default "
        f"budget) through viterbi_align_batch in {timer.wall:.2f} s; launches "
        f"{dict((n, launches[n]) for n in ('wavefront_segment', 'traceback_walk_segment'))}, "
        f"K5 {timer.count('segment_pass1')} without bp and {timer.count('segment_bp')} "
        f"with, none of the strips; equal to the whole-matrix sweep; all ungap to "
        f"their inputs")
    return {"launches": launches, "cell": cell}


def _segment_cell(dev, pairs, aln):
    """A long group's segment at its full shape: the segment kernel (with
    and without backpointers) and the segment walk, each timed against its
    plain version and held bit-equal to it. Pass 1 runs to the middle
    segment on the kernel to make the checkpoint; the walk enters the
    segment from the corners when it is the top one, else at its top near
    the main diagonal."""
    k = int(aln.gap.len)
    enc_as, enc_bs, _, _ = _encoded(pairs)
    aseq, bseq, la, lb = longseq._pad_group(enc_as, enc_bs)
    p = params_from_numpy(aln.subst_matrix, aln.gap, dev)
    a, b, tla, tlb = (torch.from_numpy(x).to(dev) for x in (aseq, bseq, la, lb))
    args = (a, b, tla, tlb, p.table, p.gap_consts)
    B, NA = aseq.shape
    NB = bseq.shape[1]
    C = NB + k
    Dtot = NA + NB + 2 * k - 1
    T = min(Dtot, longseq.seg_diagonals_for(B, C))
    n_seg = -(-Dtot // T)
    mid = n_seg // 2
    d0 = mid * T
    carry = seg_mod.empty_carry(B, C, k, dev)
    for s in range(mid):
        _, _, carry = seg_mod.wavefront_segment(*args, carry, s * T, k=k,
                                                n_steps=T, want_bp=False)
    launch = case_launch(dev, "segment cell", seg_mod.sweep_shape, B, C, k,
                         seg_mod.sweep_launch(B, C, k, *seg_mod.sweep_shape(B, C, dev),
                                              p.table.numel()).route,
                         table_len=p.table.numel())
    kw = dict(k=k, n_steps=T, launch=launch)
    adj, bp_k, out_k = seg_mod.wavefront_segment(*args, carry, d0, want_bp=True, **kw)
    (_, bp_p, out_p), segment_plain_ms = _timed_plain(dev, lambda: seg_mod.segment_plain(
        *args, carry, d0, k=k, n_steps=T, want_bp=True))
    mask = _rect_cells(tla, tlb, k, d0, T, C, dev, body=True)
    ring_mask = _rect_cells(tla, tlb, k, d0 + T - max(k, 2), max(k, 2), C, dev).flip(1)
    rk, rp = (o[0].permute(2, 0, 1, 3) for o in (out_k, out_p))
    m4 = ring_mask[:, :, None, :].expand_as(rk)
    if not (torch.equal(bp_k[mask], bp_p[mask]) and torch.equal(rk[m4], rp[m4])
            and torch.equal(out_k[1], out_p[1])):
        raise AssertionError("segment cell: kernel differs from the plain version")
    seg_err = float((rk[m4] - rp[m4]).abs().max())
    del bp_p, mask, m4

    if mid == n_seg - 1:  # the top segment: the walk starts at the corners
        entry = torch.zeros((4, B), dtype=torch.int32, device=dev)
        start = (adj, tla, tlb)
    else:  # a walk entering the segment at its top, near the main diagonal
        d_top = d0 + T - 1
        j0 = torch.minimum(torch.full_like(tlb, d_top // 2), tlb + (k - 1))
        entry = torch.stack([d_top - j0, j0, torch.zeros_like(j0), torch.zeros_like(j0)])
        start = None

    def walk_run(fn):
        st = entry.clone()
        o = torch.full((NA + NB, B), -1, dtype=torch.int8, device=dev)
        fn(bp_k, d0, st, o, k=k, start=start)
        return st, o

    st_k, ops_k = walk_run(walk_mod.walk_segment)
    (st_p, ops_p), walk_plain_ms = _timed_plain(dev, lambda: walk_run(walk_segment_plain))
    walk_err = walk_difference(st_k, ops_k, st_p, ops_p)
    if not (torch.equal(st_k, st_p) and torch.equal(ops_k, ops_p)):
        raise AssertionError("segment cell: walk differs from the plain version")
    steps = int((ops_k >= 0).sum())

    cells = segment_cells(la, lb, k, d0, T)
    carry_bytes = sum(t.numel() * 4 for t in carry)
    in_bytes = sum(t.numel() * t.element_size() for t in args) + carry_bytes
    out = {
        "shape": f"B={B} NA={NA} NB={NB} k={k} d0={d0} T={T} ({n_seg} segments), "
                 f"route {launch.route}, {launch.blocks} x {launch.threads} threads",
        "cells": cells, "steps": steps, "err": seg_err, "walk_err": walk_err,
        "segment_bp_ms": elapsed_ms(lambda: seg_mod.wavefront_segment(
            *args, carry, d0, want_bp=True, want_carry=False, **kw), dev, 2),
        "segment_pass1_ms": elapsed_ms(lambda: seg_mod.wavefront_segment(
            *args, carry, d0, want_bp=False, **kw), dev, 2),
        "segment_plain_ms": segment_plain_ms,
        "walk_ms": elapsed_ms(lambda: walk_run(walk_mod.walk_segment), dev, 5),
        "walk_plain_ms": walk_plain_ms,
        # with backpointers: inputs and carry in, 1 B a cell and adj out
        "segment_bound": bound(in_bytes + cells + 12 * B, cells * CELL_OPS_BP),
        # the walk reads 1 B a step and its state, writes 1 B a step and its state
        "walk_bound": bound(2 * steps + 2 * 16 * B, 0),
    }
    say("long", f"segment cell {out['shape']}: {cells} cells, segment kernel "
        f"{out['segment_bp_ms']:.1f} ms with bp, {out['segment_pass1_ms']:.1f} ms "
        f"without, plain {segment_plain_ms:.0f} ms; walk of {steps} steps "
        f"{out['walk_ms']:.3f} ms, plain {walk_plain_ms:.0f} ms; all bit-equal to plain")
    return out


def score_routes(dev, what, args, k, barrier=False):
    """The score kernel over one group on the strip route (score_shape's
    launch), on the sweep's band route and, with barrier, at the all-to-all
    barrier: bit-equal corners; each timed once after a warm-up, in turns
    (strips, bands[, barrier, barrier], bands, strips). Returns {route: [ms,
    ms]} and the strip launch under "launch"."""
    B, C = args[0].shape[0], args[1].shape[1] + k
    table_len = args[4].numel()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    launches = {"strips": score_mod.score_shape(B, C, k, table_len, sms)}
    routes = ("bands", "barrier") if barrier else ("bands",)
    for route in routes:
        launches[route] = case_launch(dev, f"{what}: score kernel", seg_mod.sweep_shape,
                                      B, C, k, route, table_len=table_len)

    def run(route):
        return score_mod.wavefront_score(*args, k=k, launch=launches[route])

    want = run("strips")
    for route in routes:
        if not torch.equal(run(route), want):
            raise AssertionError(f"{what}: the score kernel's {route} route differs "
                                 f"from its strip route")
    turns = ("strips", *routes)
    out = {t: [] for t in turns}
    for t in (*turns, *reversed(turns)):
        out[t].append(elapsed_ms(lambda: run(t), dev, 1))
    out["launch"] = launches["strips"]
    return out


def score_line(times):
    """score_routes' times as "strips (W x warps x blocks) a, b ms, bands
    ...", for a line."""
    ln = times["launch"]
    parts = [f"strips ({ln.W} x {ln.warps} warps x {ln.blocks} blocks) "
             f"{', '.join(f'{t:.3f}' for t in times['strips'])} ms"]
    parts += [f"{r} {', '.join(f'{t:.3f}' for t in times[r])} ms"
              for r in ("bands", "barrier") if r in times]
    return "; ".join(parts)


def bound(n_bytes, n_ops):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move n_bytes and do n_ops f32 operations."""
    by_bytes = n_bytes / PEAK_BYTES_S * 1e3
    by_ops = n_ops / PEAK_F32_OPS_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _long_group_scores(dev, long_pairs, aln):
    """The score kernel over the four long pairs' group whole, on the strip
    route, the band route and at the barrier: equal, timed in turns."""
    k = int(aln.gap.len)
    enc_as, enc_bs, _, _ = _encoded(long_pairs)
    aseq, bseq, la, lb = longseq._pad_group(enc_as, enc_bs)
    p = params_from_numpy(aln.subst_matrix, aln.gap, dev)
    args = (*(torch.from_numpy(x).to(dev) for x in (aseq, bseq, la, lb)), p.table,
            p.gap_consts)
    cells = int(((la.astype(np.int64) + k) * (lb.astype(np.int64) + k)).sum())
    in_bytes = sum(t.numel() * t.element_size() for t in args)
    times = score_routes(dev, "long group", args, k, barrier=True)
    say("long", f"the score kernel over the {N_LONG}-pair group whole, in turns: "
        f"{score_line(times)}; equal")
    return times, bound(in_bytes + 12 * len(long_pairs), cells * CELL_OPS)


def phase_long(dev, mix_named):
    aln = alignment_params()
    t0 = time.perf_counter()
    k = int(aln.gap.len)
    mix = list(mix_named[:N_LONG_PHASE_MIX])
    first_long = len(mix)

    def with_pairs(pairs):
        return mix + [(f"anc{first_long + i}", a, f"des{first_long + i}", b)
                      for i, (a, b) in enumerate(pairs)]

    long_pairs = make_pairs(N_LONG, np.random.default_rng(1), length_mix=LONG_MIX)
    rows_pairs = make_pairs(len(ROWS_MIX), np.random.default_rng(2), length_mix=ROWS_MIX)
    named, named_rows = with_pairs(long_pairs), with_pairs(rows_pairs)
    if any(longseq.is_long_pair(len(a), len(b), k) for _, a, _, b in named + named_rows):
        raise AssertionError("a pair's stack of rows passes the default budget: the "
                             f"{N_LONG} long pairs should fit the fill")
    with bp_budget(LONG_PHASE_BUDGET):
        routed = [longseq.is_long_pair(len(a), len(b), k) for _, a, _, b in named_rows]
    if routed != [False] * first_long + [True] * len(rows_pairs):
        raise AssertionError(f"a budget of {LONG_PHASE_BUDGET} bytes did not route "
                             f"exactly the {len(rows_pairs)} pairs to the long path")
    for a, b in long_pairs + rows_pairs:
        d = SeqData(names=["a", "b"], seqs=[a, b])
        utils.trim_end_stops(d)
        if any(d.stops):  # the engine-level comparisons below take none
            raise AssertionError("a long pair ends in a stop codon")
    say("long", f"made {N_LONG} pairs of "
        f"{', '.join(f'{len(a)}x{len(b)}' for a, b in long_pairs)} nt and "
        f"{len(rows_pairs)} of {', '.join(f'{len(a)}x{len(b)}' for a, b in rows_pairs)} "
        f"nt in {time.perf_counter() - t0:.1f} s")
    on_card = dev.type == "cuda"  # the plain versions count no launch

    def on_the_fill(pairs):
        """batch_align at the default budget: every pair on the fill."""
        reset_launch_counts()
        t0 = time.perf_counter()
        n, rows = _run_batch(pairs, dev)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        if on_card and (min(counts["wavefront_fill"], counts["traceback_walk"]) == 0
                        or any(counts[n] for n in LONG_KERNELS + SEGMENT_KERNELS)):
            raise AssertionError(f"the default budget did not keep every pair on the "
                                 f"fill: {counts}")
        if n != len(pairs):
            raise AssertionError(f"aligned {n} of {len(pairs)} pairs")
        _check_rows(pairs, rows)
        return rows, wall

    def scores_equal(pairs, rows):
        t0 = time.perf_counter()
        scores = score_kernel_scores([(a, b) for _, a, _, b in pairs], aln, dev)
        for i, (row, sc) in enumerate(zip(rows, scores)):
            if np.float32(row["score"]) != sc:
                raise AssertionError(f"pair {i}: alignment score {row['score']} != "
                                     f"score kernel's {sc}")
        return time.perf_counter() - t0

    # by default the four 29-32 knt pairs take the fill, their stacks of rows
    # within 1 GiB, and so do the 6-8 knt pairs
    long_rows, fill_wall = on_the_fill(named)
    scores_equal(named, long_rows)
    fill_rows, _ = on_the_fill(named_rows)
    # a budget the 6-8 knt pairs' stacks pass drives them through the rows path
    with bp_budget(LONG_PHASE_BUDGET):
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with KernelTimer(dev) as timer:
            n, rows = _run_batch(named_rows, dev)
        timer.wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        score_wall = scores_equal(named_rows, rows)
        launches = launch_counts()
        if n != len(named_rows) or len(rows) != len(named_rows):
            raise AssertionError(f"aligned {n} of {len(named_rows)} pairs")
        _check_rows(named_rows, rows)
        if on_card and min(launches[n] for n in ("wavefront_fill", "traceback_walk",
                                                 "wavefront_score", *LONG_KERNELS)) == 0:
            raise AssertionError(f"a kernel of the long path never launched: {launches}")
        if any(launches[n] for n in SEGMENT_KERNELS):
            raise AssertionError(f"the segment kernels launched for a k = {k} long "
                                 f"pair: {launches}")
        if rows != fill_rows:
            raise AssertionError("the rows path's alignments differ from the fill's")
        H = longseq.band_rows_for(len(rows_pairs), fill_mod.row_stride(
            max(len(b) for b in _encoded(rows_pairs)[1]) + k), k)
        cell = _band_cell(dev, rows_pairs, aln)
    group_scores = _long_group_scores(dev, long_pairs, aln)
    forced = _forced_group_matches_plain(dev, aln)
    n_golden = _long_golden_matches(dev, aln)
    sweep = _sweep_run(dev)
    say("long", f"batch_align {N_LONG_PHASE_MIX} pairs and the {N_LONG} long ones at "
        f"the default budget: all on the fill, {fill_wall:.2f} s wall; with "
        f"{len(rows_pairs)} pairs of 6-8 knt in their place at a budget of "
        f"{LONG_PHASE_BUDGET} bytes: {timer.wall:.2f} s wall, viterbi_scores_batch "
        f"{score_wall:.2f} s; launches "
        f"{ {n: launches[n] for n in ('wavefront_fill', 'traceback_walk', 'wavefront_score', *LONG_KERNELS, *SEGMENT_KERNELS)} }; "
        f"all ungap to their inputs; every score equals the score kernel's; the rows "
        f"path's rows equal the fill's byte for byte; forced group of {forced} nt "
        f"equals plain; {n_golden} long golden pairs equal the JAX reference")
    return {"timer": timer, "launches": launches, "peak": peak, "n": n,
            "score_wall": score_wall, "fill_wall": fill_wall,
            "true_cells": sum(len(a) * len(b) for a, b in rows_pairs),
            "band_rows": H, "pairs": [(a, b) for _, a, _, b in named],
            "cell": cell, "sweep": sweep, "group_scores": group_scores}


def score_cell(dev):
    """The score kernel at the fill's kernel cell (B=64, <=999 nt, k=1)
    against its plain version."""
    aseq, bseq, la, lb, tables = _random_case(1, 1, 64, (600, 999), (600, 999))
    p = params_from_numpy(tables, alignment_params().gap, dev)
    args = [torch.from_numpy(x).to(dev) for x in (aseq, bseq, la, lb)]
    args += [p.table, p.gap_consts]
    got = score_mod.wavefront_score(*args, k=1)
    want = score_mod.score_plain(*args, k=1)
    if not torch.equal(got, want):
        raise AssertionError("score cell: kernel differs from the plain version")
    cells = segment_cells(la, lb, 1, 0, aseq.shape[1] + bseq.shape[1] + 1)
    in_bytes = sum(t.numel() * t.element_size() for t in args)
    return {"ms": elapsed_ms(lambda: score_mod.wavefront_score(*args, k=1), dev, 10),
            "plain_ms": elapsed_ms(lambda: score_mod.score_plain(*args, k=1), dev, 2),
            "err": float((got - want).abs().max()), "cells": cells,
            "bound": bound(in_bytes + 12 * 64, cells * CELL_OPS)}


# --- phase 6 ----------------------------------------------------------------
def phase_numbers(card, main_shape, main, long, score, sample, triplet, errs):
    tag = f"[{card}]"
    t = main["timer"]
    fill_s, walk_s = t.seconds("wavefront_fill"), t.seconds("traceback_walk")
    w = sorted(main["warm_s"])
    say("numbers", f"{tag} warm wall {main['n']} pairs, median of {len(w)} runs "
        f"{np.median(w):.3f} s = {main['n'] / np.median(w):.1f} aln/s (fastest "
        f"{main['n'] / w[0]:.1f}, slowest {main['n'] / w[-1]:.1f} aln/s; cold "
        f"{main['cold_s']:.2f} s)")
    say("numbers", f"{tag} main path device time (CUDA events): fill "
        f"{fill_s * 1e3:.1f} ms over {t.count('wavefront_fill')} launches, walk "
        f"{walk_s * 1e3:.1f} ms over {t.count('traceback_walk')} launches; "
        f"the two kernels busy {(fill_s + walk_s) / t.wall:.1%} of that run's "
        f"{t.wall:.3f} s wall")
    say("numbers", f"{tag} fill {main['true_cells'] / fill_s / 1e9:.2f} Gcells/s over "
        f"{main['true_cells']} true cells (sum la*lb), "
        f"{t.padded_cells / fill_s / 1e9:.2f} Gcells/s over {t.padded_cells} padded cells")
    say("numbers", f"{tag} B=64 999 nt bucket: fill {main_shape['fill_ms']:.3f} ms vs plain "
        f"{main_shape['fill_plain_ms']:.1f} ms; walk {main_shape['walk_ms']:.3f} ms vs "
        f"plain {main_shape['walk_plain_ms']:.1f} ms; score {score['ms']:.3f} ms vs "
        f"plain {score['plain_ms']:.1f} ms")
    say("numbers", f"{tag} B=64 999 nt bucket: fill with the table in shared memory "
        f"{main_shape['fill_ms']:.3f} ms, in global memory (G=24) "
        f"{main_shape['fill_global_table_ms']:.3f} ms")
    say("numbers", f"{tag} peak device memory of the warm run "
        f"{main['peak'] / 2**20:.1f} MiB (torch.cuda.max_memory_allocated)")
    lt = long["timer"]
    p1, p2, wk = (lt.seconds(n) for n in LONG_KERNELS)
    say("numbers", f"{tag} long phase: {long['n']} pairs in {lt.wall:.2f} s wall (with "
        f"the {N_LONG} 29-32 knt pairs on the fill at the default budget: "
        f"{long['fill_wall']:.2f} s); the two 6-8 knt pairs in "
        f"{lt.count('wavefront_fill_band')} bands of "
        f"{long['band_rows']} rows: pass 1 {p1 * 1e3:.1f} ms over "
        f"{lt.count('wavefront_score_ckpt')} launches, the bands with bp "
        f"{p2 * 1e3:.1f} ms over {lt.count('wavefront_fill_band')}, band walk "
        f"{wk * 1e3:.1f} ms over {lt.count('traceback_walk_band')} (CUDA events); "
        f"{2 * long['true_cells'] / (p1 + p2) / 1e9:.2f} Gcells/s over "
        f"{long['true_cells']} true cells counted once a sweep; peak device memory "
        f"{long['peak'] / 2**20:.1f} MiB")
    cell = long["cell"]
    sweep = long["sweep"]
    seg = sweep["cell"]
    sg, sg_bound = long["group_scores"]
    say("numbers", f"{tag} wavefront_score over the {N_LONG}-pair group whole, in "
        f"turns: {score_line(sg)}; bound {sg_bound[0]:.3g} ms by {sg_bound[1]}")
    say("numbers", f"{tag} long phase: viterbi_scores_batch over the phase's "
        f"{long['n']} pairs {long['score_wall']:.2f} s wall in "
        f"{long['launches']['wavefront_score']} launches")

    def entry(name, launches, err, ms, plain_ms, bnd):
        return {"name": name, **KERNELS[name], "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}

    kernels = [
        entry("wavefront_fill", main["launches"]["wavefront_fill"], errs["fill"],
              main_shape["fill_ms"], main_shape["fill_plain_ms"],
              main_shape["fill_bound"]),
        entry("traceback_walk", main["launches"]["traceback_walk"], errs["walk"],
              main_shape["walk_ms"], main_shape["walk_plain_ms"],
              main_shape["walk_bound"]),
        entry("wavefront_segment", sweep["launches"]["wavefront_segment"],
              max(errs["segment"], seg["err"]), seg["segment_bp_ms"],
              seg["segment_plain_ms"], seg["segment_bound"]),
        entry("wavefront_score", long["launches"]["wavefront_score"],
              max(errs["segment"], score["err"]), score["ms"], score["plain_ms"],
              score["bound"]),
        entry("traceback_walk_segment", sweep["launches"]["traceback_walk_segment"],
              max(errs["segment_walk"], seg["walk_err"]), seg["walk_ms"],
              seg["walk_plain_ms"], seg["walk_bound"]),
        entry("wavefront_score_ckpt", long["launches"]["wavefront_score_ckpt"],
              max(errs["long"], cell["ckpt_err"]), cell["ckpt_ms"],
              cell["ckpt_plain_ms"], cell["ckpt_bound"]),
        entry("wavefront_fill_band", long["launches"]["wavefront_fill_band"],
              cell["band_err"], cell["band_ms"], cell["band_plain_ms"],
              cell["band_bound"]),
        entry("traceback_walk_band", long["launches"]["traceback_walk_band"],
              max(errs["long_walk"], cell["walk_err"]), cell["walk_ms"],
              cell["walk_plain_ms"], cell["walk_bound"]),
        entry("wavefront_forward", sample["launches"]["wavefront_forward"],
              max(errs["forward"], sample["forward_err"]), sample["forward_ms"],
              sample["forward_plain_ms"], sample["forward_bound"]),
        entry("sample_walk", sample["launches"]["sample_walk"],
              max(errs["sample_walk"], sample["walk_err"]), sample["walk_ms"],
              sample["walk_plain_ms"], sample["walk_bound"]),
        entry("triplet_rows", triplet["launches"]["triplet_rows"],
              triplet["rows_err"], triplet["rows_ms"], triplet["rows_plain_ms"],
              triplet["rows_bound"]),
        entry("triplet_walk", triplet["launches"]["triplet_walk"],
              triplet["walk_err"], triplet["walk_ms"], triplet["walk_plain_ms"],
              triplet["walk_bound"]),
    ]
    for e in kernels:
        say("numbers", f"{tag} {e['name']}: {e['ms']:.3f} ms, bound {e['bound_ms']:.3g} "
            f"ms by {e['bound_by']} ({e['bound_ms'] / e['ms']:.3%} of it reached), "
            f"plain {e['plain_ms']:.1f} ms, no library call computes it")
    print(json.dumps({"kernels": kernels}), flush=True)


# --- phase 7: sampling -------------------------------------------------------
def _trimmed_encoding(a, b):
    """The encoded pair the sample verb works on: end stops trimmed."""
    d = SeqData(names=["anc", "des"], seqs=[a, b])
    utils.trim_end_stops(d)
    return encode_marginal(*d.seqs)


def _check_samples(path, a, b, n):
    arr = json.loads(Path(path).read_text())
    if len(arr) != n:
        raise AssertionError(f"sample wrote {len(arr)} of {n} samples")
    _check_rows([("anc", a, "des", b)] * n, arr)
    return len({tuple(r["alignment"].values()) for r in arr})


def run_sample(dev, card, tmp, nt, n, seed, cell=False):
    """One synthetic pair of nt nt, n samples, through the CLI's sample on
    the card, twice with one seed. Checks: every sample ungaps to its inputs,
    both runs wrote the same bytes, both kernels launched. cell: also the
    kernels' cell at this shape: the largest adjusted corner against
    native.forward_score, the Forward kernel and the walk (on the run's own
    matrices and uniforms) against their plain versions, timed."""
    (a, b), = make_pairs(1, np.random.default_rng(seed), length_mix=[(nt, 1.0)])
    src = Path(tmp) / f"pair{nt}.fasta"
    src.write_text(f">anc\n{a}\n>des\n{b}\n")
    outs = [Path(tmp) / f"samples{nt}_{r}.json" for r in range(2)]
    argv = ["sample", str(src), "-n", str(n), "-s", str(seed), "--device", dev.type]
    seen = {}
    real_forward, real_walk = fwd_mod.wavefront_forward, sample_mod.sample_walk

    def forward_spy(*args, **kw):
        out = real_forward(*args, **kw)
        seen["forward"] = (args, out)
        return out

    def walk_spy(*args, **kw):
        out = real_walk(*args, **kw)
        seen.setdefault("walk", (args, out))
        return out

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    spies = {"wavefront_forward": forward_spy, "sample_walk": walk_spy} if cell else {}
    t0 = time.perf_counter()
    with wrappers(spies), KernelTimer(dev) as timer:
        rc = cli.main(argv + ["-o", str(outs[0])])
    wall = time.perf_counter() - t0
    launches = {name: launch_counts()[name]
                for name in ("wavefront_forward", "sample_walk")}
    peak = torch.cuda.max_memory_allocated(dev)
    if rc != 0:
        raise AssertionError(f"sample failed: rc={rc}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the sampling path never launched: {launches}")
    distinct = _check_samples(outs[0], a, b, n)
    t0 = time.perf_counter()
    if cli.main(argv + ["-o", str(outs[1])]) != 0:
        raise AssertionError("the second sample run failed")
    wall2 = time.perf_counter() - t0
    if outs[0].read_bytes() != outs[1].read_bytes():
        raise AssertionError("sample: one seed gave two outputs")
    fwd_ms = timer.seconds("wavefront_forward") * 1e3
    walk_ms = timer.seconds("sample_walk") * 1e3
    say("sample", f"[{card}] {len(a)} x {len(b)} nt, {n} samples through sample: "
        f"{wall:.2f} s wall = {n / wall:.1f} samples/s (again {wall2:.2f} s, the "
        f"same {outs[0].stat().st_size} bytes); Forward {fwd_ms:.1f} ms over "
        f"{launches['wavefront_forward']} launch, walk {walk_ms:.1f} ms over "
        f"{launches['sample_walk']} (CUDA events): the card busy "
        f"{(fwd_ms + walk_ms) / 1e3 / wall:.1%} of the wall; peak device memory "
        f"{peak / 2**20:.1f} MiB; every sample ungaps to its inputs, {distinct} "
        f"distinct alignments")
    out = {"launches": launches, "wall": wall, "n": n}
    if cell:
        out.update(_sample_cell(dev, a, b, seen))
    for path in outs:
        path.unlink()
    return out


def _timed_once(fn):
    """(fn(), its milliseconds by CUDA events), no warm-up."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _sample_cell(dev, a, b, seen):
    """The Forward kernel and the sample walk at the sample phase's first
    shape, on what the run itself gave them."""
    from coati_tpu_torch import native

    aln = alignment_params()
    fargs, (adj, mdi) = seen["forward"]
    wargs, (ops_k, sc_k) = seen["walk"]
    enc_a, enc_b = _trimmed_encoding(a, b)
    t0 = time.perf_counter()
    want = native.forward_score(enc_a, enc_b, aln.subst_matrix, aln.gap)
    native_s = time.perf_counter() - t0
    got = float(adj.max())
    if not abs(got - want) <= FWD_ATOL + FWD_RTOL * abs(want):
        raise AssertionError(f"sample cell: the Forward's corner {got} is not "
                             f"native.forward_score's {want}")
    k = int(aln.gap.len)
    cells = (len(enc_a) + k) * (len(enc_b) + k)
    # each plain version runs once, timed as it runs: 20,000 diagonals or
    # steps of some 60 launches each take tens of seconds
    (adj_p, mdi_p), forward_plain_ms = _timed_once(
        lambda: fwd_mod.forward_plain(*fargs, k=k))
    # the run wrote the adjusted corner into its matrices: compare the rest
    mdi_p[0, -1, -1] = adj_p[:, 0]
    abs_err, rel_err = forward_difference(mdi_p, mdi, "sample cell: Forward")
    forward_difference(adj_p, adj, "sample cell: corners")
    del mdi_p
    (ops_p, sc_p), walk_plain_ms = _timed_once(
        lambda: sample_paths_plain(*wargs, k=k))
    walk_err = compare_walks("at the sample phase's shape", ops_k, sc_k, ops_p, sc_p)
    steps = int((ops_k >= 0).sum())
    n = ops_k.shape[1]
    in_bytes = sum(t.numel() * t.element_size() for t in fargs)
    launch = case_launch(dev, "sample cell: Forward", fwd_mod.forward_shape,
                         fargs[0].shape[0], fargs[1].shape[1] + k, k, "bands",
                         table_len=fargs[4].numel())
    forward_ms = elapsed_ms(
        lambda: fwd_mod.wavefront_forward(*fargs, k=k, launch=launch), dev, 3)
    # the windows and one thread a sample (the body before them), in turns
    walk_ms, walk_old_ms = in_turns(
        dev, 5, lambda: sample_mod.sample_walk(*wargs, k=k),
        lambda: sample_mod.sample_walk(*wargs, k=k, S=0))
    res = {
        "forward_err": abs_err, "walk_err": walk_err,
        "walk_ms": mean(walk_ms), "walk_turns": (walk_ms, walk_old_ms),
        "forward_ms": forward_ms,
        "forward_plain_ms": forward_plain_ms,
        "walk_plain_ms": walk_plain_ms,
        # inputs in; 12 B a cell and the corners out
        "forward_bound": bound(in_bytes + 12 * cells + 12, cells * CELL_OPS_FORWARD),
        # a step reads two cells of 12 B, its uniform, two codes and a table
        # entry; the ops buffer and the scores are written once
        "walk_bound": bound(steps * (24 + 4 + 8 + 4) + 4 * n + ops_k.numel() + 4 * n,
                            steps * STEP_OPS_WALK),
    }
    say("sample", f"cell {len(enc_a)} x {len(enc_b)} nt, {n} samples: the largest "
        f"adjusted corner {got} against native.forward_score {want} "
        f"({native_s:.2f} s on the host); Forward kernel {res['forward_ms']:.1f} ms "
        f"at {launch.blocks} bands of {launch.plan.width} x {launch.threads} threads "
        f"({cells / res['forward_ms'] / 1e6:.2f} Gcells/s), plain "
        f"{res['forward_plain_ms']:.1f} ms, {cells} cells within {abs_err:.3e} "
        f"(relative {rel_err:.3e}); walk of {steps} steps at windows of "
        f"{sample_mod.walk_shape(k)[0]} steps x {sample_mod.walk_shape(k)[1]} warps "
        f"{' / '.join(f'{t:.3f}' for t in walk_ms)} ms, mean {mean(walk_ms):.3f} ms = "
        f"{mean(walk_ms) * 1e6 / (steps / n):.1f} ns a step, one thread a sample "
        f"{' / '.join(f'{t:.3f}' for t in walk_old_ms)} ms (in turns), plain "
        f"{res['walk_plain_ms']:.1f} ms")
    return res


def run_sample_host(dev, card, tmp):
    """The native route of sample on the card's host: a pair under 4,000,000
    cells, and native.sample_anchor (Forward and tracebacks, no strings)
    beside it."""
    from coati_tpu_torch import native

    nt, n, seed = SAMPLE_HOST_RUN
    (a, b), = make_pairs(1, np.random.default_rng(seed), length_mix=[(nt, 1.0)])
    src = Path(tmp) / "pair_host.fasta"
    out = Path(tmp) / "samples_host.json"
    src.write_text(f">anc\n{a}\n>des\n{b}\n")
    native.available()  # built before the clock starts
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(["sample", str(src), "-n", str(n), "-s", str(seed), "-o", str(out),
                   "--device", dev.type])
    wall = time.perf_counter() - t0
    if rc != 0 or max(launch_counts().values()) != 0:
        raise AssertionError(f"host sample: rc={rc}, launches {launch_counts()}")
    distinct = _check_samples(out, a, b, n)
    aln = alignment_params()
    enc_a, enc_b = _trimmed_encoding(a, b)
    t0 = time.perf_counter()
    native.sample_anchor(enc_a, enc_b, aln.subst_matrix, aln.gap, n, seed=seed)
    anchor = time.perf_counter() - t0
    say("sample", f"[{card}] host route: {len(a)} x {len(b)} nt, {n} samples through "
        f"sample in {wall:.3f} s = {n / wall:.1f} samples/s on the card's host, no "
        f"kernel launched, {distinct} distinct alignments; native.sample_anchor "
        f"alone {anchor:.3f} s = {n / anchor:.1f} samples/s")


def phase_sample(dev, card):
    with tempfile.TemporaryDirectory() as tmp:
        runs = [run_sample(dev, card, tmp, *shape, cell=(i == 0))
                for i, shape in enumerate(SAMPLE_RUNS)]
        run_sample_host(dev, card, tmp)
    return runs[0]


# --- phase 8: msa -------------------------------------------------------------
def run_msa(dev, tmp, n_leaves, nt, seed):
    """make_msa_inputs through the CLI's msa on the card: (output text, wall
    seconds, the inputs' sequences)."""
    fasta, newick, ref, seqs = make_msa_inputs(n_leaves, nt, seed)
    src, tree, out = (Path(tmp) / f"msa{n_leaves}.{ext}"
                      for ext in ("fasta", "newick", "out.fasta"))
    src.write_text(fasta)
    tree.write_text(newick)
    t0 = time.perf_counter()
    rc = cli.main(["msa", str(src), str(tree), ref, "-o", str(out),
                   "--device", dev.type])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"msa failed: rc={rc}")
    return out.read_text(), wall, seqs


def phase_msa(dev, card):
    golden = json.loads(MSA_GOLDEN.read_text())
    with tempfile.TemporaryDirectory() as tmp:
        text, _, _ = run_msa(dev, tmp, *MSA_GOLDEN_SHAPE, golden["seed"])
        if msa_golden_record(text) != golden["record"]:
            raise AssertionError(f"msa of the small tree: {msa_golden_record(text)} "
                                 f"!= JAX reference {golden['record']}")
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        with KernelTimer(dev) as timer:
            text, wall, seqs = run_msa(dev, tmp, *MSA_SHAPE, 9)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    data = read_fasta(io.StringIO(text))
    names, rows = data.names, data.seqs
    if names != list(seqs) or min(len(r) for r in rows) < len(seqs["ref"]):
        raise AssertionError("msa: rows are not the inputs' in order, each at "
                             "least as long as the reference")
    for name, row in zip(names, rows):
        if row.replace("-", "") != seqs[name]:
            raise AssertionError(f"msa: row {name} does not ungap to its leaf")
    if launches["wavefront_fill"] == 0 or launches["traceback_walk"] == 0:
        raise AssertionError(f"msa launched no fill or walk: {launches}")
    fill_ms, walk_ms = (timer.seconds(n) * 1e3 for n in ("wavefront_fill", "traceback_walk"))
    say("msa", f"[{card}] {len(rows)} sequences ({MSA_SHAPE[0]} leaves of "
        f"~{MSA_SHAPE[1]} nt, as many tables) through msa: {wall:.2f} s wall, "
        f"rows of {min(len(r) for r in rows)}-{max(len(r) for r in rows)} columns "
        f"({len({len(r) for r in rows})} lengths: merge_indels' fault, see "
        f"make_msa_inputs); fill {fill_ms:.1f} ms over "
        f"{launches['wavefront_fill']} launches, walk {walk_ms:.1f} ms over "
        f"{launches['traceback_walk']} (CUDA events): the card busy "
        f"{(fill_ms + walk_ms) / 1e3 / wall:.1%} of the wall; peak device memory "
        f"{peak / 2**20:.1f} MiB; every row ungaps to its leaf; the small tree "
        f"equals the JAX reference's output")


def path_score(enc_a, enc_b, s0, s1, table, gap_consts):
    """The f32 value the Viterbi fill (k = 1) gives the corner at the end of
    one alignment's own path: its columns replayed from the origin, each cell
    the fill's candidate for the state the path comes from, in the fill's
    order of operations (align/wavefront.py _diagonal_step: the margins of
    row and column 0 by margin_values' one rounding, the candidates by
    separate f32 adds), then the corner's terminal adjustment. On the path
    that the walk reads off the backpointers this is the reported score bit
    for bit: a backpointer compares the same partial sums the value's max
    does (before the emission, which rounds them monotonically), so any
    other path, or a wrong byte that moved it, gives another value or
    fails."""
    f32 = np.float32
    ng, gs, go, ge = (f32(x) for x in np.asarray(gap_consts, np.float32))
    zero = f32(ge * f32(0.0))  # gek1 at k = 1
    ngo = f32(ng + go)
    tab = np.asarray(table, np.float32).reshape(-1)

    def margin(base, idx):
        return f32(np.float64(base) + np.float64(ge) * (float(idx) - 1.0))

    if len(s0) != len(s1):
        raise AssertionError("path_score: rows of unequal length")
    i = j = 0
    st, v = 0, f32(0.0)  # 0 M, 1 D, 2 I; the origin's M margin
    for x, y in zip(s0, s1):
        if x != "-" and y != "-":
            i, j = i + 1, j + 1
            if i > len(enc_a) or j > len(enc_b):
                raise AssertionError("path_score: the path leaves the matrix")
            b = int(enc_b[j - 1])
            sub = tab[int(enc_a[i - 1]) * 15 + b] if b < 15 else f32(0.0)
            v = (f32(f32(v + ng) + ng), f32(v + gs), f32(f32(v + gs) + ng))[st]
            v, st = f32(v + sub), 0
        elif y == "-" and x != "-":
            i += 1
            if j == 0:
                v = margin(ngo, i)
            else:
                v = (f32(f32(f32(v + ng) + go) + zero), f32(v + ge),
                     f32(f32(f32(v + gs) + go) + zero))[st]
            st = 1
        elif x == "-" and y != "-":
            j += 1
            if i == 0:
                v = margin(go, j)
            elif st == 1:
                raise AssertionError("path_score: an insertion right after a "
                                     "deletion, which the fill never takes")
            else:
                v = f32(f32(f32(v + go) + zero) if st == 0 else f32(v + ge))
            st = 2
        else:
            raise AssertionError("path_score: a column of two gaps")
    if (i, j) != (len(enc_a), len(enc_b)):
        raise AssertionError(f"path_score: the path ends at {(i, j)}, not at the "
                             f"corner {(len(enc_a), len(enc_b))}")
    return (f32(f32(v + ng) + ng), f32(v + gs), f32(f32(v + gs) + ng))[st]


def run_longpair(dev, card, nt):
    """One synthetic pair of nt nt through the CLI's alignpair on the card:
    its stack of rows passes the default budget, so it takes the long path on
    strips; the counters show the sweep never launched. Its score equals the
    score kernel's and the sum along its own path (path_score)."""
    (a, b), = make_pairs(1, np.random.default_rng(3), length_mix=[(nt, 1.0)])
    aln = alignment_params()
    k = int(aln.gap.len)
    if not longseq.is_long_pair(len(a), len(b), k):
        raise AssertionError(f"a {len(a)} x {len(b)} nt pair fits the budget")
    H = longseq.band_rows_for(1, fill_mod.row_stride(len(b) + k), k)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "pair.fasta"
        out = Path(tmp) / "out.json"
        src.write_text(f">anc\n{a}\n>des\n{b}\n")
        t0 = time.perf_counter()
        with KernelTimer(dev) as timer:
            rc = cli.main(["alignpair", str(src), "-o", str(out)])
        wall = time.perf_counter() - t0
        counts = launch_counts()
        row = json.loads(out.read_text()) if rc == 0 else None
    peak = torch.cuda.max_memory_allocated(dev)
    if rc != 0:
        raise AssertionError(f"alignpair failed: rc={rc}")
    _check_rows([("anc", a, "des", b)], [row])
    if min(counts[n] for n in LONG_KERNELS) == 0 or any(counts[n] for n in SEGMENT_KERNELS):
        raise AssertionError(f"the {len(a)} nt pair did not take the long path on "
                             f"strips alone: {counts}")
    t0 = time.perf_counter()
    score, = score_kernel_scores([(a, b)], aln, dev)
    score_wall = time.perf_counter() - t0
    if np.float32(row["score"]) != score:
        raise AssertionError(f"alignpair's score {row['score']} is not the "
                             f"score kernel's {score}")
    # the alignment's own path, summed as the fill sums it, gives that score:
    # a band that sent the walk astray would not
    t0 = time.perf_counter()
    d, = _trimmed([(a, b)])
    n_stop = 3 if any(d.stops) else 0  # the columns restore_end_stops appends
    path = [row["alignment"][n] for n in ("anc", "des")]
    path = [x[:len(x) - n_stop] for x in path]
    if [x.replace("-", "") for x in path] != d.seqs:
        raise AssertionError("the alignment's path does not ungap to the trimmed pair")
    p_cpu = params_from_numpy(aln.subst_matrix, aln.gap, "cpu")
    d.score = float(path_score(*encode_marginal(*d.seqs), *path, p_cpu.table,
                               p_cpu.gap_consts))
    utils.restore_end_stops(d, aln.gap)
    if np.float32(d.score) != np.float32(row["score"]):
        raise AssertionError(f"the alignment's own path sums to {d.score}, not to "
                             f"its reported score {row['score']}")
    path_wall = time.perf_counter() - t0
    p1, p2, wk = (timer.seconds(n) for n in LONG_KERNELS)
    cells = len(a) * len(b)
    enc_as, enc_bs, _, _ = _encoded([(a, b)])
    padded = engine._pad_batch(enc_as, enc_bs, 96)
    p = params_from_numpy(aln.subst_matrix, aln.gap, dev)
    args = [torch.from_numpy(x).to(dev) for x in padded] + [p.table, p.gap_consts]
    score_ms = score_routes(dev, f"{len(a)} nt pair", args, k)
    say("longpair", f"[{card}] the score kernel over the {len(a)} nt pair, in turns: "
        f"{score_line(score_ms)}; equal")
    say("longpair", f"[{card}] {len(a)} x {len(b)} nt through alignpair: {wall:.2f} s "
        f"wall, {timer.count('wavefront_fill_band')} bands of {H} rows, pass 1 "
        f"{p1 * 1e3:.1f} ms, the bands with bp {p2 * 1e3:.1f} ms, band walk "
        f"{wk * 1e3:.1f} ms (CUDA events), {2 * cells / (p1 + p2) / 1e9:.2f} Gcells/s "
        f"over {cells} true cells counted once a sweep; launches "
        f"{ {n: counts[n] for n in LONG_KERNELS + SEGMENT_KERNELS} }; peak device "
        f"memory {peak / 2**20:.1f} MiB; ungaps to its inputs; score {score} equals "
        f"the score kernel's ({score_wall:.2f} s wall) and the sum along its own path "
        f"of {len(path[0])} columns ({path_wall:.2f} s on the host)")

def run_lonepair(dev, card, nt=LONE_NT):
    """One pair of nt nt through the CLI's alignpair and through batch_align:
    the fill kernel spread over several blocks and the whole-stack walk, one
    launch each; the alignment equals the long path's for the same pair
    (the rows path, held to plain in phases 3 and 5)."""
    aln = alignment_params()
    k = int(aln.gap.len)
    for seed in range(4, 40):
        (a, b), = make_pairs(1, np.random.default_rng(seed), length_mix=[(nt, 1.0)])
        d = SeqData(names=["a", "b"], seqs=[a, b])
        utils.trim_end_stops(d)
        if not any(d.stops):
            break
    C = -(-len(b) // 96) * 96 + k
    if longseq.is_long_pair(len(a), len(b), k) or C <= fill_mod.MULTI_BLOCK_SLOTS:
        raise AssertionError(f"a {len(a)} x {len(b)} nt pair is not a lone mid-size pair")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    launch = fill_mod.fill_shape(1, C, k, 183 * 15, sms)
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "pair.fasta"
        out = Path(tmp) / "out.json"
        src.write_text(f">anc\n{a}\n>des\n{b}\n")
        reset_launch_counts()
        t0 = time.perf_counter()
        with KernelTimer(dev) as timer:
            rc = cli.main(["alignpair", str(src), "-o", str(out)])
        wall = time.perf_counter() - t0
        counts = launch_counts()
        row = json.loads(out.read_text()) if rc == 0 else None
    if rc != 0:
        raise AssertionError(f"alignpair failed: rc={rc}")
    _check_rows([("anc", a, "des", b)], [row])
    took = {n: counts[n] for n in ("wavefront_fill", "traceback_walk",
                                   "wavefront_segment", "traceback_walk_segment")}
    if took != {"wavefront_fill": 1, "traceback_walk": 1, "wavefront_segment": 0,
                "traceback_walk_segment": 0}:
        raise AssertionError(f"the lone pair took {took}, not the fill and walk")
    reset_launch_counts()
    t0 = time.perf_counter()
    _, rows = _run_batch([("anc", a, "des", b)], dev)
    batch_wall = time.perf_counter() - t0
    if (launch_counts()["wavefront_fill"], launch_counts()["traceback_walk"]) != (1, 1):
        raise AssertionError("batch_align did not take the fill and walk")
    long_r, = engine.viterbi_align_batch(*_encoded([(a, b)]), aln.subst_matrix,
                                         aln.gap, long_slots=0, device=dev)
    want = (long_r.seq0, long_r.seq1, np.float32(long_r.score))
    for what, r in (("alignpair", row), ("batch_align", rows[0])):
        got = (r["alignment"]["anc"], r["alignment"]["des"], np.float32(r["score"]))
        if got != want:
            raise AssertionError(f"lone pair through {what}: differs from the long path")
    fill_ms = timer.seconds("wavefront_fill") * 1e3
    walk_ms = timer.seconds("traceback_walk") * 1e3
    say("lonepair", f"[{card}] {len(a)} x {len(b)} nt through alignpair: {wall:.2f} s "
        f"wall (batch_align {batch_wall:.2f} s); route: the fill kernel, strips of "
        f"{launch.W} x {launch.warps} warps x {launch.blocks} blocks, "
        f"{fill_ms:.2f} ms, and the whole-stack walk {walk_ms:.2f} ms (CUDA "
        f"events); equal to the long path's alignment and score")
    return {"wall": wall, "batch_wall": batch_wall, "fill_ms": fill_ms,
            "walk_ms": walk_ms, "launch": launch}


# --- phase 9: the triplet models ---------------------------------------------
def _triplet_model(name):
    return triplet_hmm.build_triplet_model(alignment_params(name))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _triplet_case_pairs(seed, B, cods, nts):
    """Ragged pairs of cods codons: the even ones homologous (make_pairs's
    mutations), the odd ones with an unrelated descendant of nts nt; 2% N."""
    rng = np.random.default_rng(seed)
    codons, nucs = np.array(CODONS61), np.array(list("ACGT"))
    pairs = []
    for p in range(B):
        anc = "".join(rng.choice(codons, size=int(rng.integers(cods[0], cods[1] + 1))))
        if p % 2 == 0:
            des = list(descendant(anc, rng))
        else:
            des = list(rng.choice(nucs, size=int(rng.integers(nts[0], nts[1] + 1))))
        for q in np.nonzero(rng.random(len(des)) < 0.02)[0]:
            des[q] = "N"
        pairs.append((anc, "".join(des)))
    return pairs


class TripletBatch:
    """A batch packed onto the device as the engine packs it."""

    def __init__(self, model, pairs, dev):
        enc = [triplet_hmm.encode_triplet_pair(model, a, d) for a, d in pairs]
        (anc_p, des_p, self.lens_t, self.lens_m, ins_off, self.tables,
         self.n_cod) = tw._pack_batch(model, [e[0] for e in enc],
                                      [e[1] for e in enc], dev)
        self.aj, self.dj, self.io, self.lt, self.lm = (
            torch.from_numpy(x).to(dev)
            for x in (anc_p, des_p, ins_off, self.lens_t, self.lens_m))
        self.B, self.Cc, self.dev = len(pairs), des_p.shape[1] + 1, dev
        self.init = tw.triplet_init_carry(self.dj, self.io, self.tables[2])

    def rows_args(self):
        return (self.aj, self.dj, self.io, self.lt, self.lm, *self.tables)

    def true_cells(self, t_first=0):
        """[n_cod + 1 - t_first, 3, B, Cc] mask of each pair's own boundaries
        (t <= its codons) and columns (j <= its nt), from boundary t_first."""
        t = torch.arange(t_first, self.n_cod + 1, device=self.dev)[:, None, None, None]
        j = torch.arange(self.Cc, device=self.dev)[None, None, None, :]
        own = (t <= self.lt[None, None, :, None]) & (j <= self.lm[None, None, :, None])
        return own.expand(-1, 3, -1, -1)

    def walk(self, fn, grid, amax, spans):
        """The traceback of the whole batch by fn over `spans` of codon
        blocks, top to bottom: (state [3, B], ops [6 n_cod, B])."""
        bidx = torch.arange(self.B, device=self.dev)
        last = self.lt.long()
        st0, _ = tw.triplet_terminal(grid[last, 0, bidx], grid[last, 1, bidx],
                                     grid[last, 2, bidx], self.lm, self.tables[2])
        state = tw._walk_state(self.lt, self.lm, st0)
        ops = torch.zeros((6 * self.n_cod, self.B), dtype=torch.int32, device=self.dev)
        for t_lo, S in reversed(spans):
            fn(grid[t_lo:t_lo + S + 1], amax[t_lo + 1:t_lo + S + 1],
               self.aj[:, t_lo:t_lo + S].contiguous(), self.dj, self.io, t_lo,
               state, ops, *self.tables)
        return state, ops


def rows_grid(tb, launch=None):
    """The full sweep of a batch by the rows kernel at `launch` (default
    rows_shape's): (boundaries [n_cod + 1, 3, B, Cc], argmax lanes)."""
    shape = (tb.n_cod + 1, 3, tb.B, tb.Cc)
    grid = torch.empty(shape, dtype=torch.float32, device=tb.dev)
    amax = torch.empty(shape, dtype=torch.uint8, device=tb.dev)
    grid[0], amax[0] = tb.init, 0
    trows_mod.triplet_rows(*tb.rows_args(), tb.init, keep_grid=True,
                           grid_out=grid[1:], amax_out=amax[1:], launch=launch)
    return grid, amax


def rows_launches(tb):
    """The shape rows_shape picks for a batch, and forced ones: 2 to 4 bands
    a pair of 32 or 64 threads with rings of 1, 2 and 8 slots, and one band
    of block_threads (one block a pair)."""
    forced = [trows_mod.rows_launch(tb.Cc, n, t, slots=f)
              for n, t, f in ((2, 32, 1), (3, 64, 2), (4, 32, 8))]
    one = trows_mod.rows_launch(tb.Cc, 1, trows_mod.block_threads(tb.Cc))
    return [trows_mod.rows_shape(tb.B, tb.Cc, tb.dev), *forced, one]


def launch_name(launch):
    return (f"{launch.bands} band{'s' if launch.bands > 1 else ''} x "
            f"{launch.threads} threads")


def band_launch(Cc, cols):
    """The band route at as many bands as a row of Cc columns takes at 64
    columns a band, up to 8, of the fewest threads that cover it."""
    bands = min(twalk_mod.MAX_BANDS, -(-Cc // 64))
    threads = max(32, -(-Cc // (cols * bands * 32)) * 32)
    return twalk_mod.walk_launch(Cc, cols, threads, bands=max(bands, 2))


def walk_launches(tb, windows=(8, 16, 64)):
    """The walk's launch by walk_shape for a batch, and forced ones that take
    several passes a block (1-8 columns a thread x 32-64 threads) with
    windows of a few columns, so that insertion runs leave them and the rows
    left of them come from the scratch, one with the whole row, and the
    band route (a cluster of 2-8 blocks a pair) at 1 and 2 columns a thread."""
    forced = [twalk_mod.walk_launch(tb.Cc, c, t, w)
              for (c, t), w in zip(((2, 64), (4, 32), (8, 64)), windows)]
    return [twalk_mod.walk_shape(tb.B, tb.Cc, tb.dev), *forced,
            twalk_mod.walk_launch(tb.Cc, 1, 32), band_launch(tb.Cc, 1), band_launch(tb.Cc, 2)]


def walk_name(launch, Cc):
    if launch.bands > 1:
        return f"{launch.bands} bands of {launch.cols} x {launch.threads} threads"
    return (f"{launch.cols} x {launch.threads} threads, a window of {launch.window}"
            f"{' and the scratch' if launch.scratch(Cc) else ''}")


def walk_at(launch):
    return functools.partial(twalk_mod.triplet_walk, launch=launch)


def check_triplet_case(dev, name, model_name, pairs, seg):
    """One batch through the forward rows kernel and the walk kernel and
    through their plain versions on the card; everything compared must be
    equal (tolerance 0). Rows and lanes over each pair's own cells, at every
    launch of rows_launches: the full sweep, and the carry form from a
    checkpoint in the middle with the grid and without (the carry out
    alone). The walk's state and every op row: whole, in segments of `seg`
    blocks with a ragged last one, and on the kernel's own rows. Returns the
    largest differences (rows, walk)."""
    tb = TripletBatch(_triplet_model(model_name), pairs, dev)
    if tb.n_cod % seg == 0 or tb.n_cod < 2:
        raise AssertionError(f"triplet case {name}: {tb.n_cod} codons against "
                             f"segments of {seg}")
    grid_k, amax_k = tw._triplet_rows(*tb.rows_args())
    with wrappers({"triplet_rows": PLAIN["triplet_rows"]}):
        grid_p, amax_p = tw._triplet_rows(*tb.rows_args())
    _sync(dev)

    def bad(what):
        raise AssertionError(f"triplet case {name}: {what} differ from the "
                             f"plain version")

    own = tb.true_cells()
    t0 = tb.n_cod // 2
    S = tb.n_cod - t0
    steps = (tb.lt - t0).clamp(0, S)
    args = (tb.aj[:, t0:].contiguous(), tb.dj, tb.io, steps, tb.lm, *tb.tables,
            grid_p[t0].contiguous())
    above = tb.true_cells(t0 + 1)
    # a pair's carry out is the boundary after its own last step
    last = torch.clamp(tb.lt, min=t0).long()
    want = grid_p[last, :, torch.arange(tb.B, device=dev)].permute(1, 0, 2)
    cols = above[0]
    launches = rows_launches(tb)
    rows_err = 0.0
    for launch in launches:
        how = launch_name(launch)
        if launch != launches[0]:
            grid_k, amax_k = rows_grid(tb, launch)
        if not torch.equal(grid_k[own], grid_p[own]):
            bad(f"boundary rows at {how} ({int((grid_k[own] != grid_p[own]).sum())} cells)")
        if not torch.equal(amax_k[own], amax_p[own]):
            bad(f"argmax lanes at {how} ({int((amax_k[own] != amax_p[own]).sum())} cells)")
        if not bool(torch.isfinite(grid_k[own]).all()):
            raise AssertionError(f"triplet case {name}: non-finite boundary rows")
        rows_err = max(rows_err, float((grid_k[own] - grid_p[own]).abs().max()))
        # the carry form, from the plain version's boundary t0
        g2, a2, out_grid = trows_mod.triplet_rows(*args, keep_grid=True, launch=launch)
        none_g, none_a, out_carry = trows_mod.triplet_rows(*args, keep_grid=False,
                                                           launch=launch)
        _sync(dev)
        if none_g is not None or none_a is not None:
            bad("the carry-only outputs")
        if not (torch.equal(g2[above], grid_p[t0 + 1:][above])
                and torch.equal(a2[above], amax_p[t0 + 1:][above])):
            bad(f"rows or lanes of the carry form at {how}")
        for what, out in (("with the grid", out_grid), ("alone", out_carry)):
            if not torch.equal(out[cols], want[cols]):
                bad(f"the carry out {what} at {how}")
    grid_k, amax_k = rows_grid(tb)  # the walk below on rows_shape's rows

    whole = [(0, tb.n_cod)]
    segs = [(lo, min(seg, tb.n_cod - lo)) for lo in range(0, tb.n_cod, seg)]
    st_p, ops_p = tb.walk(twalk_mod.triplet_walk_plain, grid_p, amax_p, whole)
    walk_err = 0.0
    walks = walk_launches(tb)
    for launch in walks:
        how = walk_name(launch, tb.Cc)
        fn = walk_at(launch)
        for what, got in (
                ("the whole walk", tb.walk(fn, grid_p, amax_p, whole)),
                ("the walk in segments", tb.walk(fn, grid_p, amax_p, segs)),
                ("the walk on the kernel's rows", tb.walk(fn, grid_k, amax_k, whole))):
            _sync(dev)
            walk_err = max(walk_err, float((got[0] - st_p).abs().max()),
                           float((got[1] - ops_p).abs().max()))
            if not (torch.equal(got[0], st_p) and torch.equal(got[1], ops_p)):
                bad(f"state or op rows of {what} at {how}")
    if not bool((st_p[0] == 0).all()):
        raise AssertionError(f"triplet case {name}: a walk did not reach row 0")
    counts = ops_p[0::2] >> 2  # the run rows' counts
    runs = int((counts > 1).sum())
    left = [int((counts >= x.window).sum()) for x in walks[1:4]]
    say("kernels", f"triplet {name}: {model_name} B={tb.B} n_cod={tb.n_cod} "
        f"Cc={tb.Cc}: rows and lanes on {int(own[:, 0].sum())} true cells at "
        f"{', '.join(launch_name(x) for x in launches)} (the first rows_shape's), "
        f"the carry form from boundary {t0} with and without the grid at each, "
        f"walk state and "
        f"{ops_p.numel()} op rows ({runs} insertion runs, {left} at least as long as "
        f"the forced windows) whole, in {len(segs)} segments of {seg} and on the "
        f"kernel's own rows at {'; '.join(walk_name(x, tb.Cc) for x in walks)} (the "
        f"first walk_shape's): equal to plain")
    return rows_err, walk_err, left


def phase_triplet_kernels(dev):
    cases = [
        # name, model, pairs, blocks a walk segment
        ("ragged with N", "tri-mg", _triplet_case_pairs(31, 24, (1, 60), (1, 200)), 7),
        ("tri-ecm", "tri-ecm", _triplet_case_pairs(32, 5, (20, 90), (50, 300)), 11),
        ("one pair", "tri-mg", _triplet_case_pairs(33, 1, (70, 70), (0, 0)), 16),
        # rows wider than a tile of 512 columns, no multiple of it
        ("wide rows", "tri-mg", _triplet_case_pairs(34, 6, (100, 450), (600, 1400)), 64),
    ]
    errs = [check_triplet_case(dev, *c) for c in cases]
    left = np.sum([e[2] for e in errs], axis=0)
    if left.min() < 1:
        raise AssertionError(f"no insertion run of the triplet cases leaves the forced "
                             f"walk windows: {left.tolist()}")
    return max(e[0] for e in errs), max(e[1] for e in errs)


def walk_columns(ops, j_end):
    """(columns the walk computed again, summed over every block a pair was
    active in; the number of those blocks), from the op rows [6 n_cod, B] and
    each walk's last j."""
    v = ops.reshape(-1, 6, ops.shape[1])
    cnt, op = v >> 2, v & 3
    consumed = (cnt * (op != 1)).sum(axis=1)  # descendant columns a block took
    j_entry = j_end[None, :] + np.cumsum(consumed, axis=0)
    active = cnt.sum(axis=1) > 0
    return int(((j_entry + 1) * active).sum()), int(active.sum())


def triplet_cell(dev, pairs):
    """The two triplet kernels at one batch's shape: each timed against its
    plain version and held equal to it on every true cell and op row."""
    tb = TripletBatch(_triplet_model("tri-mg"), pairs, dev)
    shape = (tb.n_cod + 1, 3, tb.B, tb.Cc)
    grid = torch.empty(shape, dtype=torch.float32, device=dev)
    amax = torch.empty(shape, dtype=torch.uint8, device=dev)
    grid[0], amax[0] = tb.init, 0

    chosen = trows_mod.rows_shape(tb.B, tb.Cc, dev)
    threads = trows_mod.block_threads(tb.Cc)
    shapes = (chosen, trows_mod.rows_launch(tb.Cc, 1, threads))

    def rows(launch=chosen):
        return lambda: trows_mod.triplet_rows(
            *tb.rows_args(), tb.init, keep_grid=True, grid_out=grid[1:],
            amax_out=amax[1:], launch=launch)

    # rows_shape's bands and one band
    turns = in_turns(dev, 5, *(rows(x) for x in shapes))
    rows_ms = mean(turns[0])
    (gp, ap, _), rows_plain_ms = _timed_once(lambda: trows_mod.triplet_rows_plain(
        tb.aj, tb.dj, tb.io, *tb.tables, tb.init))
    own = tb.true_cells(1)
    if not (torch.equal(grid[1:][own], gp[own]) and torch.equal(amax[1:][own], ap[own])):
        raise AssertionError("triplet cell: rows or lanes differ from the plain version")
    rows_err = float((grid[1:][own] - gp[own]).abs().max())
    del gp, ap, own

    whole = [(0, tb.n_cod)]
    walk_launch = twalk_mod.walk_shape(tb.B, tb.Cc, dev)
    st_k, ops_k = tb.walk(twalk_mod.triplet_walk, grid, amax, whole)
    (st_p, ops_p), walk_plain_ms = _timed_once(
        lambda: tb.walk(twalk_mod.triplet_walk_plain, grid, amax, whole))
    if not (torch.equal(st_k, st_p) and torch.equal(ops_k, ops_p)):
        raise AssertionError("triplet cell: the walk differs from the plain version")
    walk_ms = elapsed_ms(lambda: tb.walk(twalk_mod.triplet_walk, grid, amax, whole), dev, 5)
    walk_err = float(max((st_k - st_p).abs().max(), (ops_k - ops_p).abs().max()))

    cells = int((tb.lens_t.astype(np.int64) * (tb.lens_m + 1)).sum())
    row_cols = int((tb.lens_m + 1).sum())
    in_bytes = sum(t.numel() * t.element_size() for t in (*tb.rows_args(), tb.init))
    cols, blocks = walk_columns(ops_k.cpu().numpy(), st_k[1].cpu().numpy())
    out = {
        "shape": f"B={tb.B} n_cod={tb.n_cod} Cc={tb.Cc}", "cells": cells,
        "rows_ms": rows_ms, "rows_plain_ms": rows_plain_ms, "rows_err": rows_err,
        "rows_turns": turns,
        "walk_ms": walk_ms, "walk_plain_ms": walk_plain_ms, "walk_err": walk_err,
        # inputs and the carry in; 15 B a true cell and the carry out
        "rows_bound": bound(in_bytes + tw.GRID_CELL_BYTES * cells + 12 * row_cols,
                            cells * CELL_OPS_TRIPLET),
        # 12 B of boundary a column computed again, a lane and a codon a
        # block, the sequences' columns once; the op rows and the state out
        "walk_bound": bound(12 * cols + 5 * blocks + 8 * row_cols
                            + ops_k.numel() * 4 + 24 * tb.B,
                            cols * CELL_OPS_TRIPLET_WALK),
    }
    wb = out["walk_bound"]
    say("triplet", f"cell {out['shape']}: rows kernel {rows_ms:.3f} ms (mean of the turns) over {cells} "
        f"true cells ({cells / rows_ms / 1e6:.3f} Gcells/s) at {launch_name(chosen)}; "
        f"in turns {' / '.join(f'{t:.3f}' for t in turns[0])} ms, one band "
        f"{' / '.join(f'{t:.3f}' for t in turns[1])}; plain "
        f"{rows_plain_ms:.1f} ms; walk kernel {walk_ms:.3f} ms "
        f"({walk_ms / tb.n_cod * 1e3:.2f} us a codon block) at {walk_name(walk_launch, tb.Cc)} "
        f"over {blocks} blocks and {cols} columns computed again, bound {wb[0]:.4f} ms "
        f"by {wb[1]} ({wb[0] / walk_ms:.2%} of it reached), plain "
        f"{walk_plain_ms:.1f} ms; both equal to plain")
    return out


def _no_end_stops(a, b):
    d = SeqData(names=["a", "b"], seqs=[a, b])
    utils.trim_end_stops(d)
    return not any(d.stops)


def run_triplet_batch(dev, card, n_pairs, nt, seed, n_plain):
    """One tri-mg batch of n_pairs pairs of nt nt through batch_align."""
    pairs = make_pairs(n_pairs, np.random.default_rng(seed), length_mix=[(nt, 1.0)])
    named = [(f"anc{i}", a, f"des{i}", b) for i, (a, b) in enumerate(pairs)]
    t0 = time.perf_counter()
    _run_batch(named, dev, "tri-mg")
    cold = time.perf_counter() - t0

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with KernelTimer(dev) as timer:
        n, rows = _run_batch(named, dev, "tri-mg")
    walls = [time.perf_counter() - t0]
    launches = {name: launch_counts()[name] for name in ("triplet_rows", "triplet_walk")}
    peak = torch.cuda.max_memory_allocated(dev)
    if n != len(named) or len(rows) != len(named):
        raise AssertionError(f"aligned {n} of {len(named)} pairs")
    _check_rows(named, rows)
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the triplet path never launched: {launches}")
    for _ in range(2):
        t0 = time.perf_counter()
        _run_batch(named, dev, "tri-mg")
        walls.append(time.perf_counter() - t0)

    with wrappers({name: PLAIN[name] for name in ("triplet_rows", "triplet_walk")}):
        _, plain = _run_batch(named[:n_plain], dev, "tri-mg")
    for i, (got, want) in enumerate(zip(plain, rows)):
        if (got["alignment"], got["score"]) != (want["alignment"], want["score"]):
            raise AssertionError(f"triplet pair {i} of {nt} nt: kernel path "
                                 f"{want['score']} != plain {got['score']}")
    # the alignment attains its score: an independent scorer, f64, in
    # another order of operations
    model = _triplet_model("tri-mg")
    scored = [i for i, (a, b) in enumerate(pairs) if _no_end_stops(a, b)][:2]
    for i in scored:
        s0, s1 = rows[i]["alignment"].values()
        sc = triplet_hmm.triplet_path_score(model, s0, s1)
        if not abs(sc - rows[i]["score"]) <= 1e-4 * (1 + abs(sc)):
            raise AssertionError(f"triplet pair {i}: score {rows[i]['score']} but "
                                 f"its alignment scores {sc}")
    rows_s, walk_s = timer.seconds("triplet_rows"), timer.seconds("triplet_walk")
    w = sorted(walls)
    say("triplet", f"[{card}] batch_align -m tri-mg, {n} pairs of {nt} nt: cold "
        f"{cold:.2f} s, warm {', '.join(f'{x:.3f}' for x in walls)} s, median "
        f"{n / w[1]:.1f} aln/s; rows {rows_s * 1e3:.1f} ms over "
        f"{launches['triplet_rows']} launch, walk {walk_s * 1e3:.1f} ms over "
        f"{launches['triplet_walk']} (CUDA events): the card busy "
        f"{(rows_s + walk_s) / walls[0]:.1%} of that run's {walls[0]:.3f} s wall; "
        f"peak device memory {peak / 2**20:.1f} MiB; all ungap to their inputs; "
        f"the first {n_plain} equal the plain versions; {len(scored)} alignments "
        f"attain their scores by triplet_path_score")
    return {"launches": launches, "pairs": pairs}


def _triplet_golden_matches(dev):
    golden = json.loads(TRIPLET_GOLDEN.read_text())
    named = triplet_golden_pairs(golden["seed"])
    _, rows = _run_batch(named, dev, "tri-mg")
    for want in golden["pairs"]:
        got = golden_record(want["index"], rows[want["index"]])
        if got != want:
            raise AssertionError(f"triplet pair {want['index']}: {got} != JAX "
                                 f"reference {want}")
    return len(golden["pairs"])


def _alignpair_row(tmp, a, b, argv):
    """One pair through the CLI's alignpair into JSON."""
    src, out = Path(tmp) / "pair.fasta", Path(tmp) / "out.json"
    src.write_text(f">anc\n{a}\n>des\n{b}\n")
    rc = cli.main(["alignpair", str(src), "-o", str(out), *argv])
    if rc != 0:
        raise AssertionError(f"alignpair {argv} failed: rc={rc}")
    row = json.loads(out.read_text())
    _check_rows([("anc", a, "des", b)], [row])
    return row


def _row_equals(what, row, want):
    got = (*row["alignment"].values(), np.float32(row["score"]))
    if got != (want[0], want[1], np.float32(want[2])):
        raise AssertionError(f"{what}: {got[2]} and its strings differ from "
                             f"{want[2]}")


def _triplet_cli_pairs(dev, tmp):
    """A tri-ecm pair large enough for the batched device engine and a dna
    pair through alignpair, each against the host engine triplet_align."""
    done = []
    for model_name, nt, seed, on_card in (("tri-ecm", 600, 14, True), ("dna", 300, 15, False)):
        (a, b), = make_pairs(1, np.random.default_rng(seed), length_mix=[(nt, 1.0)])
        if not _no_end_stops(a, b):
            raise AssertionError(f"the {model_name} pair ends in a stop codon")
        reset_launch_counts()
        row = _alignpair_row(tmp, a, b, ["-m", model_name, "--device", dev.type])
        launched = launch_counts()["triplet_rows"] > 0 and launch_counts()["triplet_walk"] > 0
        if launched != on_card:
            raise AssertionError(f"alignpair -m {model_name}: kernels launched: {launched}")
        _row_equals(f"alignpair -m {model_name}", row,
                    triplet_hmm.triplet_align(_triplet_model(model_name), a, b))
        done.append(f"{model_name} {len(a)} x {len(b)} nt")
    return done


def check_triplet_wide_segment(dev, a, b, t0, S):
    """The kernels at the long pair's width against the plain versions:
    codon blocks t0 .. t0 + S - 1 of the pair (a, b), one segment of the
    segmented path from its checkpoint. The rows and lanes of the whole-grid
    sweep there, the carry form from boundary t0 with the grid and without,
    and the walk through the segment from the state the walk above it left,
    all equal to plain from the same boundary and state (tolerance 0).
    Returns the largest differences (rows, walk)."""
    tb = TripletBatch(_triplet_model("tri-mg"), [(a, b)], dev)
    grid, amax = tw._triplet_rows(*tb.rows_args())
    anc_seg = tb.aj[:, t0:t0 + S].contiguous()
    carry = grid[t0].contiguous()
    gp, ap, cp = trows_mod.triplet_rows_plain(anc_seg, tb.dj, tb.io, *tb.tables, carry)
    steps = torch.full((1,), S, dtype=torch.int32, device=dev)
    args = (anc_seg, tb.dj, tb.io, steps, tb.lm, *tb.tables, carry)
    g2, a2, c2 = trows_mod.triplet_rows(*args, keep_grid=True)
    _, _, c3 = trows_mod.triplet_rows(*args, keep_grid=False)
    # the one-band route, which the cases above hold to plain at every width
    one = trows_mod.rows_launch(tb.Cc, 1, trows_mod.block_threads(tb.Cc))
    g1, a1, c1 = trows_mod.triplet_rows(*args, keep_grid=True, launch=one)
    _, _, c4 = trows_mod.triplet_rows(*args, keep_grid=False, launch=one)
    _sync(dev)
    for what, got, want in (
            ("boundary rows of the whole sweep", grid[t0 + 1:t0 + S + 1], gp),
            ("argmax lanes of the whole sweep", amax[t0 + 1:t0 + S + 1], ap),
            ("boundary rows of the carry form", g2, gp),
            ("argmax lanes of the carry form", a2, ap),
            ("the carry out with the grid", c2, cp),
            ("the carry out alone", c3, cp),
            ("boundary rows of the carry form against one band", g2, g1),
            ("argmax lanes of the carry form against one band", a2, a1),
            ("the carry out with the grid against one band", c2, c1),
            ("the carry out alone against one band", c3, c4)):
        if not torch.equal(got, want):
            raise AssertionError(f"triplet wide segment: {what} differ from the plain "
                                 f"version ({int((got != want).sum())} cells)")
    rows_err = float((g2 - gp).abs().max())
    del g2, a2, gp, ap, g1, a1

    above = [(lo, min(S, tb.n_cod - lo)) for lo in range(t0 + S, tb.n_cod, S)]
    state, ops = tb.walk(twalk_mod.triplet_walk, grid, amax, above)
    j_in = int(state[1, 0])

    def through(fn):
        st, op = state.clone(), ops.clone()
        fn(grid[t0:t0 + S + 1], amax[t0 + 1:t0 + S + 1], anc_seg, tb.dj, tb.io, t0,
           st, op, *tb.tables)
        return st, op

    st_p, ops_p = through(twalk_mod.triplet_walk_plain)
    walks = [twalk_mod.walk_shape(1, tb.Cc, dev), twalk_mod.walk_launch(tb.Cc, 8, 64, 64),
             twalk_mod.walk_launch(tb.Cc, 2, 512, 1024),
             twalk_mod.walk_launch(tb.Cc, 4, 512, bands=8),
             twalk_mod.walk_launch(tb.Cc, 8, 256, bands=8)]
    walk_err = 0.0
    for walk in walks:
        st_k, ops_k = through(walk_at(walk))
        _sync(dev)
        if not (torch.equal(st_k, st_p) and torch.equal(ops_k, ops_p)):
            raise AssertionError(f"triplet wide segment: state or op rows of the walk at "
                                 f"{walk_name(walk, tb.Cc)} differ from the plain version")
        walk_err = max(walk_err, float((st_k - st_p).abs().max()),
                       float((ops_k - ops_p).abs().max()))
    if int(state[0, 0]) <= 3 * t0 or int(st_p[0, 0]) != 3 * t0:
        raise AssertionError("triplet wide segment: the walk did not cross the segment")
    launch = trows_mod.rows_shape(1, tb.Cc, dev)
    say("kernels", f"triplet wide segment: tri-mg {len(a)} x {len(b)} nt, codon blocks "
        f"{t0}..{t0 + S - 1} from the boundary under them, Cc={tb.Cc} "
        f"({launch_name(launch)} of {launch.width} columns): rows and lanes on "
        f"{S * tb.Cc} cells from the whole sweep and from the carry form, the carry "
        f"out with and without the grid, equal to plain and to one band; the walk's "
        f"state and {6 * S} op rows "
        f"through the segment (entered at column {j_in}, left at {int(st_p[1, 0])}) at "
        f"{'; '.join(walk_name(x, tb.Cc) for x in walks)} (the first walk_shape's): "
        f"equal to plain")
    return rows_err, walk_err


def triplet_long_pair(nt):
    (pair,) = make_pairs(1, np.random.default_rng(13), length_mix=[(nt, 1.0)])
    return pair


def run_triplet_longpair(dev, card, tmp, a, b):
    """One pair just over the default byte budget through alignpair -m
    tri-mg: the segmented path, held to the full-grid route on the card."""
    if not (tw.is_long_pair(len(a), len(b)) and _no_end_stops(a, b)):
        raise AssertionError("the long triplet pair is not routed to the "
                             "segmented path, or ends in a stop codon")
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    walked = []  # each walk launch's op rows and the j it left at
    t0 = time.perf_counter()
    with KernelTimer(dev) as timer:
        timed = twalk_mod.triplet_walk

        def spy(grid_seg, amax_seg, anc_seg, des, io, t_lo, state, ops, *rest, **kw):
            out = timed(grid_seg, amax_seg, anc_seg, des, io, t_lo, state, ops, *rest, **kw)
            walked.append((ops[6 * t_lo:6 * (t_lo + amax_seg.shape[0])].clone(),
                           state[1].clone()))
            return out

        with wrappers({"triplet_walk": spy}):
            row = _alignpair_row(tmp, a, b, ["-m", "tri-mg"])
    wall = time.perf_counter() - t0
    launches = {name: launch_counts()[name] for name in ("triplet_rows", "triplet_walk")}
    peak = torch.cuda.max_memory_allocated(dev)
    cols = blocks = 0
    for ops, j_end in walked:
        c, n = walk_columns(ops.cpu().numpy(), j_end.cpu().numpy())
        cols, blocks = cols + c, blocks + n
    # as triplet_cell's: 12 B of boundary a column computed again, a lane and
    # a codon a block, the sequences' columns and the op rows once a launch
    walk_bound = bound(12 * cols + 5 * blocks + len(walked) * (8 * (len(b) + 1) + 24)
                       + sum(ops.numel() * 4 for ops, _ in walked),
                       cols * CELL_OPS_TRIPLET_WALK)
    n_seg = -(-(len(a) // 3) // tw.seg_cods_for(len(b) + 1))
    if launches != {"triplet_rows": 2 * n_seg, "triplet_walk": n_seg} or n_seg < 2:
        raise AssertionError(f"long triplet pair: launches {launches} for {n_seg} segments")
    model = _triplet_model("tri-mg")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    full = tw._align_group(model, [(a, b)],
                           [triplet_hmm.encode_triplet_pair(model, a, b)], "device", dev)[0]
    full_wall = time.perf_counter() - t0
    full_peak = torch.cuda.max_memory_allocated(dev)
    _row_equals("long triplet pair against the full-grid route", row, full)
    rows_s, walk_s = timer.seconds("triplet_rows"), timer.seconds("triplet_walk")
    say("triplet", f"[{card}] {len(a)} x {len(b)} nt through alignpair -m tri-mg: "
        f"{wall:.2f} s wall, {n_seg} segments of {tw.seg_cods_for(len(b) + 1)} codon "
        f"blocks, rows {rows_s:.2f} s over {launches['triplet_rows']} launches (two "
        f"sweeps), walk {walk_s * 1e3:.1f} ms over {launches['triplet_walk']} (CUDA "
        f"events; {walk_s * 1e6 / (len(a) // 3):.2f} us a codon block, {blocks} blocks "
        f"and {cols} columns computed again, bound {walk_bound[0]:.3f} ms by "
        f"{walk_bound[1]}, {walk_bound[0] / (walk_s * 1e3):.2%} of it reached): the card "
        f"busy {(rows_s + walk_s) / wall:.1%}; peak device memory "
        f"{peak / 2**20:.1f} MiB; equal in strings and f32 score to the full-grid "
        f"route ({full_wall:.2f} s wall, peak {full_peak / 2**20:.1f} MiB)")
    return launches


def phase_triplet(dev, card):
    rows_err, walk_err = phase_triplet_kernels(dev)
    runs = [run_triplet_batch(dev, card, *shape, n_plain)
            for shape, n_plain in zip(TRIPLET_BATCHES, (8, 2))]
    n_golden = _triplet_golden_matches(dev)
    long_a, long_b = triplet_long_pair(TRIPLET_LONG_NT)
    with tempfile.TemporaryDirectory() as tmp:
        cli_pairs = _triplet_cli_pairs(dev, tmp)
        run_triplet_longpair(dev, card, tmp, long_a, long_b)
    say("triplet", f"{n_golden} golden pairs equal the JAX reference; alignpair "
        f"equals the host engine on {' and '.join(cli_pairs)}")
    # the kernels against plain at every width the path ran them at: a middle
    # segment of the long pair, then both batches (the first is the cell)
    seg = tw.seg_cods_for(len(long_b) + 1)
    t_mid = len(long_a) // 3 // seg // 2 * seg
    wide = check_triplet_wide_segment(dev, long_a, long_b, t_mid, seg)
    cell, second = (triplet_cell(dev, run["pairs"]) for run in runs)
    cell["launches"] = runs[0]["launches"]
    cell["rows_err"] = max(cell["rows_err"], second["rows_err"], rows_err, wide[0])
    cell["walk_err"] = max(cell["walk_err"], second["walk_err"], walk_err, wide[1])
    return cell


# --- phase 10: several lanes and several processes ---------------------------
# run in a child process: the CLI's own entry point, then the launch counts of
# the kernels it may run, as JSON on the last line of stderr
CLI_WITH_COUNTS = """
import json, sys
from coati_tpu_torch import cli
from coati_tpu_torch.kernels import traceback_walk, triplet_rows, triplet_walk, wavefront_fill
from coati_tpu_torch.parallel.multihost import local_devices
rc = cli.main(sys.argv[1:])
print(json.dumps({"devices": local_devices(),
                  "wavefront_fill": wavefront_fill.LAUNCHES,
                  "traceback_walk": traceback_walk.LAUNCHES,
                  "triplet_rows": triplet_rows.LAUNCHES,
                  "triplet_walk": triplet_walk.LAUNCHES}), file=sys.stderr)
sys.exit(rc)
"""


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _restored(datas, results, gap):
    """(alignment strings, f32 score) of each result, with the end stop
    codons that trim_end_stops took from its pair put back, as batch_align
    writes them."""
    out = []
    for d, (s0, s1, sc) in zip(datas, results):
        e = SeqData(names=list(d.names), seqs=[s0, s1], score=sc, stops=list(d.stops))
        utils.restore_end_stops(e, gap)
        out.append((e.seqs[0], e.seqs[1], np.float32(e.score)))
    return out


def multi_main_path(dev, card, main_run):
    """The main path's 10,000 pairs through batch_align over two lanes:
    every row byte-equal to one lane's, which equal phase 4's; warm runs in
    turns with one lane; chunks a lane, launches, the kernels' busy share."""
    named = main_run["named"]
    lanes = device_mod.resolve_devices(LANES)
    if len(lanes) != 2 or (dev.type == "cuda" and any(x.stream is None for x in lanes)):
        raise AssertionError(f"two lanes with streams of their own expected: {lanes}")
    _, one_text = _batch_text(named, dev)
    if [json.loads(line) for line in one_text.splitlines()] != main_run["rows"]:
        raise AssertionError("one lane no longer gives phase 4's rows")
    _batch_text(named, lanes)  # warm the lanes' streams and pools
    for lane in lanes:
        lane.chunks = 0
    reset_launch_counts()
    n, two_text = _batch_text(named, lanes)
    launches = {name: launch_counts()[name] for name in ("wavefront_fill", "traceback_walk")}
    chunks = [lane.chunks for lane in lanes]
    if n != len(named) or two_text != one_text:
        bad = sum(x != y for x, y in zip(two_text.splitlines(), one_text.splitlines()))
        raise AssertionError(f"two lanes: {bad} rows differ from one lane's")
    if min(chunks) == 0 or (dev.type == "cuda" and min(launches.values()) == 0):
        raise AssertionError(f"two lanes: launches {launches}, chunks a lane {chunks}")
    walls = {1: [], 2: []}
    for q in [1, 2, 2, 1, 1, 2][:2 * MULTI_WARM_RUNS]:
        t0 = time.perf_counter()
        _batch_text(named, lanes if q == 2 else dev)
        walls[q].append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    with KernelTimer(dev) as timer:
        _batch_text(named, lanes)
    timer.wall = time.perf_counter() - t0
    busy = timer.seconds("wavefront_fill") + timer.seconds("traceback_walk")

    def rate(ws):
        w = sorted(ws)
        return (f"median {n / w[len(w) // 2]:.1f} aln/s (fastest {n / w[0]:.1f}, slowest "
                f"{n / w[-1]:.1f}; walls {', '.join(f'{x:.3f}' for x in ws)} s)")

    say("multi", f"[{card}] batch_align {n} pairs over two lanes {LANES} (two "
        f"streams): every row byte-equal to one lane's and to phase 4's; chunks a "
        f"lane {chunks}; launches {launches}")
    say("multi", f"[{card}] warm, in turns one lane / two lanes / two / one / one / "
        f"two: one lane {rate(walls[1])}; two lanes {rate(walls[2])}")
    say("multi", f"[{card}] two lanes, one traced run: fill "
        f"{timer.seconds('wavefront_fill') * 1e3:.1f} ms over "
        f"{timer.count('wavefront_fill')} launches, walk "
        f"{timer.seconds('traceback_walk') * 1e3:.1f} ms over "
        f"{timer.count('traceback_walk')} (CUDA events on the lanes' streams, "
        f"summed): {busy / timer.wall:.1%} of the {timer.wall:.3f} s wall")
    return {"walls": walls, "chunks": chunks, "launches": launches}


def multi_mesh(dev, card, long_run):
    """The mesh entry points over two lanes, each equal to one lane's."""
    mesh = mesh_mod.make_mesh(devices=LANES)
    aln = alignment_params()
    done = []

    # scores of phase 5's pairs: 1,000 of the main mix and the four long
    # ones, which the second lane's strips spread over blocks (cooperative)
    datas = _trimmed(long_run["pairs"])
    enc = [encode_marginal(*d.seqs) for d in datas]
    enc_as, enc_bs = [e[0] for e in enc], [e[1] for e in enc]
    reset_launch_counts()
    t0 = time.perf_counter()
    got = mesh_mod.sharded_viterbi_scores(enc_as, enc_bs, aln.subst_matrix, aln.gap, mesh)
    wall = time.perf_counter() - t0
    n_score = launch_counts()["wavefront_score"]
    want = engine.viterbi_scores_batch(enc_as, enc_bs, aln.subst_matrix, aln.gap,
                                       device=dev)
    if not np.array_equal(got, want) or (dev.type == "cuda" and n_score == 0):
        raise AssertionError(f"sharded_viterbi_scores: {int((got != want).sum())} "
                             f"scores differ from one lane's ({n_score} launches)")
    done.append(f"sharded_viterbi_scores over {len(enc)} pairs ({wall:.2f} s, "
                f"{n_score} launches) bit-equal to viterbi_scores_batch")

    # triplet: phase 9's first batch
    n_tri, nt, seed = TRIPLET_BATCHES[0]
    pairs = make_pairs(n_tri, np.random.default_rng(seed), length_mix=[(nt, 1.0)])
    named = [(f"anc{i}", a, f"des{i}", b) for i, (a, b) in enumerate(pairs)]
    _, rows = _run_batch(named, dev, "tri-mg")
    datas = _trimmed(pairs)
    model = _triplet_model("tri-mg")
    reset_launch_counts()
    t0 = time.perf_counter()
    tri = mesh_mod.sharded_triplet_align_batch(model, [tuple(d.seqs) for d in datas], mesh)
    wall = time.perf_counter() - t0
    n_rows, n_walk = launch_counts()["triplet_rows"], launch_counts()["triplet_walk"]
    for i, (row, got) in enumerate(zip(rows, _restored(datas, tri, aln.gap))):
        want = (*row["alignment"].values(), np.float32(row["score"]))
        if got != want:
            raise AssertionError(f"sharded_triplet_align_batch: pair {i} differs from "
                                 f"batch_align -m tri-mg")
    if dev.type == "cuda" and min(n_rows, n_walk) < 2:
        raise AssertionError(f"sharded triplet: launches rows {n_rows}, walk {n_walk}")
    done.append(f"sharded_triplet_align_batch {n_tri} x {nt} nt ({wall:.2f} s, rows "
                f"{n_rows} and walk {n_walk} launches) equal to batch_align -m tri-mg")

    # sampling: phase 7's first pair, the draws split over the lanes
    nt, n, seed = SAMPLE_RUNS[0]
    (a, b), = make_pairs(1, np.random.default_rng(seed), length_mix=[(nt, 1.0)])
    d = _trimmed([(a, b)])[0]
    enc_a, enc_b = encode_marginal(*d.seqs)
    mdi, corners = driver._forward_diag(enc_a, enc_b, aln, dev)
    args = (mdi, corners, enc_a, enc_b, aln.subst_matrix, *d.seqs, aln.gap, seed, n)
    reset_launch_counts()
    t0 = time.perf_counter()
    drawn = mesh_mod.sharded_sample_batch(*args, mesh)
    wall = time.perf_counter() - t0
    n_walk = launch_counts()["sample_walk"]
    single = list(sample_device.sample_batch_device(*args))
    if drawn != single or (dev.type == "cuda" and n_walk != 2):
        raise AssertionError(f"sharded_sample_batch: {sum(x != y for x, y in zip(drawn, single))} "
                             f"samples differ from sample_batch_device ({n_walk} walks)")
    _check_rows([("anc", d.seqs[0], "des", d.seqs[1])] * n,
                [{"alignment": {"anc": s0, "des": s1}, "score": sc} for s0, s1, sc in drawn])
    done.append(f"sharded_sample_batch {len(d.seqs[0])} x {len(d.seqs[1])} nt x {n} "
                f"({wall:.2f} s, one walk a lane) op for op equal to sample_batch_device")
    del mdi

    t0 = time.perf_counter()
    summary = dryrun_mod.dryrun_multichip(LANES)
    done.append(f"{summary} ({time.perf_counter() - t0:.2f} s)")
    for line in done:
        say("multi", f"[{card}] {line}")


def _multihost_run(dev, tmp, name, named, model, rejected=(), local=False):
    """batch over `named` in one process (this one) and in two coordinated
    processes of the CLI (batch --multihost over gloo) on the card (local:
    with LOCAL_RANK and LOCAL_WORLD_SIZE set as torchrun sets them, so each
    process takes its own cards, here both the one card): every
    merged row byte-equal to the one-process row for its pair (the whole
    file byte-equal where no pair is rejected: a batch writes a chunk's
    rejected pairs first, so a rejected pair in the second shard moves the
    rows), the scores manifest equal to the rows with null where a pair was
    rejected, and each process's kernels launched."""
    src = Path(tmp) / f"{name}.fasta"
    src.write_text("".join(f">{na}\n{a}\n>{nd}\n{b}\n" for na, a, nd, b in named))
    single, merged = Path(tmp) / f"{name}.one.jsonl", Path(tmp) / f"{name}.jsonl"
    rejected = list(rejected)
    argv = ["batch", str(src), "-m", model, "--device", dev.type]
    if cli.main(argv + ["-o", str(single)]) != 0:
        raise AssertionError(f"batch -m {model} failed")
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", CLI_WITH_COUNTS, *argv, "-o", str(merged), "--multihost",
         "--coordinator", f"localhost:{port}", "--nproc", "2", "--pid", str(pid)],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "LOCAL_RANK": str(pid), "LOCAL_WORLD_SIZE": "2"} if local
        else None)
        for pid in (0, 1)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for pid, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"batch --multihost --pid {pid} exited "
                                 f"{p.returncode}: {err[-2000:]}")
    counts = [json.loads(err.strip().splitlines()[-1]) for _, err in outs]
    kernels = (("triplet_rows", "triplet_walk") if model.startswith("tri")
               else ("wavefront_fill", "traceback_walk"))
    if dev.type == "cuda" and any(c[k] == 0 for c in counts for k in kernels):
        raise AssertionError(f"batch --multihost -m {model}: launches {counts}")
    cards = [c["devices"] for c in counts]
    n_cards = torch.cuda.device_count()
    every = [f"cuda:{q}" for q in range(n_cards)]
    want = ([every[pid::2] or [every[pid % n_cards]] for pid in (0, 1)] if local
            else [every, every])
    if dev.type == "cuda" and cards != want:
        raise AssertionError(f"batch --multihost -m {model}: the processes took {cards}, "
                             f"not {want}")
    one = {json.loads(line)["pair"]: line for line in single.read_text().splitlines()}
    two = {json.loads(line)["pair"]: line for line in merged.read_text().splitlines()}
    if len(one) != len(named) or two != one:
        raise AssertionError(f"batch --multihost -m {model}: "
                             f"{sum(two.get(i) != x for i, x in one.items())} merged rows "
                             f"differ from one process's")
    errors = sorted(i for i, line in one.items() if "error" in json.loads(line))
    if errors != rejected:
        raise AssertionError(f"batch -m {model}: rejected pairs {errors}, not {rejected}")
    same_bytes = merged.read_bytes() == single.read_bytes()
    if not errors and not same_bytes:
        raise AssertionError(f"batch --multihost -m {model}: the merged file differs "
                             f"from one process's")
    man = json.loads((Path(tmp) / f"{name}.jsonl.scores.json").read_text())
    want = [json.loads(one[i]).get("score") for i in range(len(named))]
    if man["n_pairs"] != len(named) or man["scores"] != want:
        raise AssertionError(f"batch --multihost -m {model}: the scores manifest "
                             f"does not match the rows")
    return (f"-m {model}, {len(named)} pairs (rejected {errors}, null in the manifest): "
            f"two processes{' (LOCAL_RANK set)' if local else ''} on {cards}, "
            f"{wall:.2f} s wall, launches "
            f"{[{k: c[k] for k in kernels} for c in counts]}; every merged row of "
            f"{merged.stat().st_size} bytes equal to one process's for its pair (the "
            f"whole file byte-equal: {same_bytes}), the manifest's "
            f"{len(man['scores'])} scores its rows'")


def multi_processes(dev, card, main_run):
    """Two processes of batch --multihost on the one card, under mar-mg and
    under tri-mg with a rejected pair (an early stop codon) in each
    process's shard, so that rank 1's null score goes through the
    allgather."""
    n_tri, nt, seed = MULTIHOST_TRIPLET
    pairs = make_pairs(n_tri, np.random.default_rng(seed), length_mix=[(nt, 1.0)])
    rejected = [0, n_tri // 2 + 3]
    for i in rejected:
        a, b = pairs[i]
        pairs[i] = (a[:3] + "TAA" + a[6:], b)
    tri = [(f"anc{i}", a, f"des{i}", b) for i, (a, b) in enumerate(pairs)]
    with tempfile.TemporaryDirectory() as tmp:
        for line in (_multihost_run(dev, tmp, "mix",
                                    main_run["named"][:MULTIHOST_MIX_PAIRS], "mar-mg",
                                    local=True),
                     _multihost_run(dev, tmp, "tri", tri, "tri-mg", rejected)):
            say("multi", f"[{card}] batch --multihost {line}")


def phase_multi(dev, card, main_run, long_run):
    t0 = time.perf_counter()
    run = multi_main_path(dev, card, main_run)
    multi_mesh(dev, card, long_run)
    multi_processes(dev, card, main_run)
    say("multi", f"phase 10 took {time.perf_counter() - t0:.1f} s")
    return run


# --- phase 11: the bench ----------------------------------------------------
# the kernels the bench's sections launch, every one of which must launch
BENCH_KERNELS = ("wavefront_fill", "traceback_walk", "wavefront_forward", "sample_walk",
                 "triplet_rows", "triplet_walk", *LONG_KERNELS)


def phase_bench(card):
    torch.cuda.empty_cache()  # the card's memory to the bench's process
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as home:
        proc = subprocess.run(
            [sys.executable, "-m", "coati_tpu_torch.bench"], cwd=ROOT, timeout=600,
            capture_output=True, text=True,
            env={**os.environ, "BENCH_QUICK": "1", "HOME": home})
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"bench exited {proc.returncode}: {proc.stderr[-3000:]}")
    last = proc.stdout.strip().splitlines()[-1]
    line = json.loads(last)
    launched = dict.fromkeys(BENCH_KERNELS, 0)
    for ln in proc.stderr.splitlines():
        if ln.startswith("# kernels "):
            for name, n in json.loads(ln.split(": ", 1)[1]).items():
                launched[name] = launched.get(name, 0) + n
        if not ln.startswith("# record "):
            say("bench", ln)
    say("bench", f"line ({len(last.encode())} bytes): {last}")
    if len(last.encode()) > bench_mod.LINE_BYTES or tuple(line) != bench_mod.KEYS:
        raise AssertionError(f"bench line of {len(last.encode())} bytes, keys {list(line)}")
    if line["device"] != card or line["vs_baseline"] is None:
        raise AssertionError(f"bench device {line['device']!r} (the card: {card!r}), "
                             f"vs_baseline {line['vs_baseline']}")
    if min(launched[name] for name in BENCH_KERNELS) == 0:
        raise AssertionError(f"a kernel of the bench's path never launched: {launched}")
    say("bench", f"python -m coati_tpu_torch.bench (BENCH_QUICK=1) in {secs:.1f} s; "
        f"launches {launched}")


def main() -> int:
    secs = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = time.perf_counter() - t0
        return out

    dev, card = phase("device", phase_device)
    phase("build", phase_build)
    main_shape, fill_err, walk_err = phase("kernels", phase_kernels, dev)
    seg_err, seg_walk_err = phase("segment kernels", phase_segment_kernels, dev)
    long_err, long_walk_err = phase("long kernels", phase_long_kernels, dev)
    fwd_err, sample_walk_err = phase("sample kernels", phase_sample_kernels, dev)
    main_run = phase("main", phase_main, dev)
    phase("trace", phase_trace, dev, card, main_run)
    long_run = phase("long", phase_long, dev, main_run["named"])
    phase("longpair", run_longpair, dev, card, LONGPAIR_NT)
    phase("lonepair", run_lonepair, dev, card)
    sample_run = phase("sample", phase_sample, dev, card)
    phase("msa", phase_msa, dev, card)
    triplet_run = phase("triplet", phase_triplet, dev, card)
    phase("multi", phase_multi, dev, card, main_run, long_run)
    phase("bench", phase_bench, card)
    score = phase("score cell", score_cell, dev)
    say("phases", ", ".join(f"{name} {s:.1f} s" for name, s in secs.items())
        + f"; {time.perf_counter() - T_START:.1f} s in all")
    phase_numbers(card, main_shape, main_run, long_run, score, sample_run,
                  triplet_run, {"fill": fill_err, "walk": walk_err, "segment": seg_err,
                   "segment_walk": seg_walk_err, "long": long_err,
                   "long_walk": long_walk_err, "forward": fwd_err,
                   "sample_walk": sample_walk_err})
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "coati_tpu", "bench"))
    if bad:
        raise AssertionError(f"the port imported {bad}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
