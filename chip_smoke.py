#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (coati_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printing one line (any failure raises, exit code non-zero):

1. device  - requires torch.cuda.is_available(); prints nvidia-smi's card
             name and power limit, the torch and CUDA versions.
2. build   - nvcc-builds the kernels from coati_tpu_torch/csrc.
3. kernels - the fill and walk kernels against their plain PyTorch versions
             on the card: k=1 and k=3, ragged lengths in one bucket, IUPAC
             codes, stacked table_idx tables, and each of the fill's four
             routes (ring and table each in shared or global memory).
             Corners, scores, backpointers on true-matrix cells and op
             sequences must be bit-equal.
4. main    - the batch verb's batch_align over 10,000 synthetic mar-mg
             pairs (bench.py's make_pairs and length mix, seed 0), run twice;
             then WARM_RUNS warm runs are timed; the launch counters are reset
             just before the first warm run and read just after it. Checks on
             that run: every alignment ungaps to its inputs, the pairs in
             tests/data/torch_main_path_golden.json equal the JAX
             reference's results (XLA:CPU), a stratified 256-pair subset
             equals the plain version on the card (strings and f32 scores),
             the CLI's alignpair gives CT----ATAGTG on the reference
             example, both kernels launched.
5. numbers - warm alignments/s, fill and walk device time from CUDA events,
             fill Gcells/s, kernel vs plain times, peak device memory.

The line before last is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench import make_pairs  # noqa: E402
from coati_tpu_torch import batchrun, cli  # noqa: E402
from coati_tpu_torch.align.wavefront import traceback_plain, wavefront_plain  # noqa: E402
from coati_tpu_torch.kernels import _build  # noqa: E402
from coati_tpu_torch.kernels import traceback_walk as walk_mod  # noqa: E402
from coati_tpu_torch.kernels import wavefront_fill as fill_mod  # noqa: E402
from coati_tpu_torch.params import alignment_params, params_from_numpy  # noqa: E402

LENGTH_MIX = [(156, 0.35), (471, 0.30), (999, 0.20), (1500, 0.15)]  # bench.py:34
N_PAIRS = 10_000
# the JAX reference's results for some of the main path's pairs, written and
# checked by tests/test_torch_golden.py
GOLDEN = ROOT / "tests" / "data" / "torch_main_path_golden.json"
WARM_RUNS = 5  # timed warm runs of the main path; the first is also checked
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
}


def golden_record(index, row):
    """Golden record of one batch_align output row of pair `index`: its
    score and a sha256 of its aligned strings."""
    aln = row["alignment"]
    text = aln[f"anc{index}"] + "\n" + aln[f"des{index}"]
    return {"index": index, "score": row["score"],
            "sha256": hashlib.sha256(text.encode()).hexdigest()}


@contextlib.contextmanager
def wrappers(fill, walk):
    """Stand fill and walk in for the kernel wrappers the engine calls."""
    orig = (fill_mod.wavefront_fill, walk_mod.traceback_walk)
    fill_mod.wavefront_fill, walk_mod.traceback_walk = fill, walk
    try:
        yield
    finally:
        fill_mod.wavefront_fill, walk_mod.traceback_walk = orig


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def elapsed_ms(fn, dev, reps: int) -> float:
    """Mean milliseconds per call of fn() over reps calls after one warm-up:
    CUDA events on the card, the host clock elsewhere."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


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


def _true_cells(la, lb, k, Dtot, C, dev):
    d = torch.arange(Dtot, device=dev)[None, :, None]
    j = torch.arange(C, device=dev)[None, None, :]
    i = d - j
    la = la[:, None, None].long()
    lb = lb[:, None, None].long()
    return (i >= k) & (i < la + k) & (j >= k) & (j < lb + k)


def check_case(dev, name, k, B, na, nb, route, n_codes=4, G=1, seed=0,
               timing=None):
    """One batch through both kernels and both plain versions; route is the
    (ring, table) placement the fill must take; timing None, "kernels" or
    "all" (kernels and plain versions)."""
    aseq, bseq, la, lb, tables = _random_case(seed, k, B, na, nb, n_codes, G)
    p = params_from_numpy(tables, alignment_params(gap_len=k).gap, dev)
    a, b, tla, tlb = (torch.from_numpy(x).to(dev) for x in (aseq, bseq, la, lb))
    steps = int((la + lb).max())
    C = bseq.shape[1] + k
    took = tuple("shared" if on else "global" for on in (
        fill_mod.ring_in_shared(C, k),
        fill_mod.table_in_shared(C, k, p.table.numel())))
    if took != route:
        raise AssertionError(f"kernel case {name}: ring/table in {took}, "
                             f"meant to be in {route}")

    ck, bpk = fill_mod.wavefront_fill(a, b, tla, tlb, p.table, p.gap_consts, k=k)
    cp, bpp = wavefront_plain(a, b, tla, tlb, p.table, p.gap_consts, k=k)
    opk, sk = walk_mod.traceback_walk(bpk, ck, tla, tlb, k=k, max_steps=steps)
    opp, sp = traceback_plain(bpp, cp, tla, tlb, k=k, max_steps=steps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    fill_err = max(float((x - y).abs().max()) for x, y in zip(ck, cp))
    walk_err = float((sk - sp).abs().max())
    mask = _true_cells(tla, tlb, k, bpk.shape[1], C, dev)
    bad = []
    if not all(torch.equal(x, y) for x, y in zip(ck, cp)):
        bad.append("corners")
    if not torch.equal(bpk[mask], bpp[mask]):
        bad.append(f"bp ({int((bpk[mask] != bpp[mask]).sum())} cells)")
    if not torch.equal(opk, opp):
        bad.append("ops")
    if not torch.equal(sk, sp):
        bad.append("scores")
    if not bool(torch.isfinite(sk).all()):
        bad.append("non-finite scores")
    if bad:
        raise AssertionError(f"kernel case {name}: {', '.join(bad)} differ "
                             f"from the plain version")
    out = {"fill_err": fill_err, "walk_err": walk_err}
    times = ""
    if timing:
        out["fill_ms"] = elapsed_ms(lambda: fill_mod.wavefront_fill(
            a, b, tla, tlb, p.table, p.gap_consts, k=k), dev, 10)
        out["walk_ms"] = elapsed_ms(lambda: walk_mod.traceback_walk(
            bpk, ck, tla, tlb, k=k, max_steps=steps), dev, 10)
        times = f"; fill {out['fill_ms']:.3f} ms, walk {out['walk_ms']:.3f} ms"
    if timing == "all":
        out["fill_plain_ms"] = elapsed_ms(lambda: wavefront_plain(
            a, b, tla, tlb, p.table, p.gap_consts, k=k), dev, 2)
        out["walk_plain_ms"] = elapsed_ms(lambda: traceback_plain(
            bpk, ck, tla, tlb, k=k, max_steps=steps), dev, 2)
        times += (f" (plain: fill {out['fill_plain_ms']:.1f} ms, "
                  f"walk {out['walk_plain_ms']:.1f} ms)")
    say("kernels", f"{name}: B={B} NA={aseq.shape[1]} NB={bseq.shape[1]} k={k} "
        f"G={G} ring/table in {route[0]}/{route[1]} memory: corners, bp on "
        f"{int(mask.sum())} true cells, {int((opk >= 0).sum())} ops and scores "
        f"bit-equal to plain{times}")
    return out


def phase_kernels(dev):
    shared, glob = "shared", "global"
    main_shape = check_case(dev, "main-path shape, 999 nt", 1, 64, (600, 999),
                            (600, 999), (shared, shared), seed=1, timing="all")
    # the same shape with a table too large for shared memory (24 x 183 x 15
    # f32 = 263,520 B): the global-table route, timed against the one above
    main_global = check_case(dev, "main-path shape, stacked table_idx G=24", 1,
                             64, (600, 999), (600, 999), (shared, glob), G=24,
                             seed=1, timing="kernels")
    cases = [main_shape, main_global,
             check_case(dev, "ring near the shared-memory limit", 1, 2,
                        (300, 300), (6240, 6240), (shared, glob), seed=6),
             check_case(dev, "C~6000 pair", 3, 1, (3000, 3000), (5997, 5997),
                        (glob, shared), seed=5),
             check_case(dev, "C~6000 pairs, stacked table_idx G=24", 3, 2,
                        (1500, 3000), (5997, 5997), (glob, glob), G=24, seed=7),
             check_case(dev, "k=3 ragged", 3, 32, (150, 480), (150, 480),
                        (shared, shared), seed=2),
             check_case(dev, "IUPAC + gap codes", 1, 32, (96, 300), (96, 300),
                        (shared, shared), n_codes=16, seed=3),
             check_case(dev, "stacked table_idx G=3", 1, 30, (96, 300),
                        (96, 300), (shared, shared), G=3, seed=4)]
    main_shape["fill_global_table_ms"] = main_global["fill_ms"]
    return main_shape, max(c["fill_err"] for c in cases), max(c["walk_err"] for c in cases)


# --- phase 4 ----------------------------------------------------------------
class KernelTimer:
    """Records CUDA events around every wrapper call of one run, for the
    fill and walk device time of the main path."""

    def __init__(self, dev):
        self.dev = dev
        self.events = {"wavefront_fill": [], "traceback_walk": []}
        self.padded_cells = 0
        self.wall = 0.0  # seconds of the traced run, set by the caller
        self._swap = None

    def _wrap(self, name, fn):
        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events[name].append((start, end))
            if name == "wavefront_fill":
                (B, NA), NB = args[0].shape, args[1].shape[1]
                k = kw["k"]
                self.padded_cells += B * (NA + k) * (NB + k)
            return out
        return timed

    def __enter__(self):
        self._swap = wrappers(
            self._wrap("wavefront_fill", fill_mod.wavefront_fill),
            self._wrap("traceback_walk", walk_mod.traceback_walk))
        self._swap.__enter__()
        return self

    def __exit__(self, *exc):
        self._swap.__exit__(*exc)
        torch.cuda.synchronize(self.dev)

    def seconds(self, name):
        return sum(s.elapsed_time(e) for s, e in self.events[name]) / 1e3


def _run_batch(named, dev):
    out = io.StringIO()
    n = batchrun.batch_align(alignment_params(), named, out, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return n, [json.loads(line) for line in out.getvalue().splitlines()]


def _subset_matches_plain(named, rows, dev):
    """A stratified subset of the main path's pairs, run through batch_align
    on the same device with the plain fill and walk standing in for the
    kernels, gives the main path's rows (strings and f32 scores)."""
    by_len = {}
    for i, (_, a, _, _) in enumerate(named):
        by_len.setdefault(len(a), []).append(i)
    per = max(1, 256 // len(by_len))
    subset = [i for idxs in by_len.values() for i in idxs[:per]]
    with wrappers(wavefront_plain, traceback_plain):
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

    fill_mod.LAUNCHES = walk_mod.LAUNCHES = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    n, rows = _run_batch(named, dev)
    warm = [time.perf_counter() - t0]
    launches = {"wavefront_fill": fill_mod.LAUNCHES,
                "traceback_walk": walk_mod.LAUNCHES}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    if n != len(named) or len(rows) != len(named):
        raise AssertionError(f"aligned {n} of {len(named)} pairs")
    for (na, a, nd, b), row in zip(named, rows):
        aln = row.get("alignment")
        if (aln is None or aln[na].replace("-", "") != a
                or aln[nd].replace("-", "") != b or len(aln[na]) != len(aln[nd])
                or not np.isfinite(row["score"])):
            raise AssertionError(f"bad alignment row {row}")
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
        t0 = time.perf_counter()
        _run_batch(named, dev)
        warm.append(time.perf_counter() - t0)
    say("main", f"batch_align {n} pairs: cold {cold:.2f} s, warm "
        f"{', '.join(f'{w:.3f}' for w in warm)} s; "
        f"launches {launches}; all ungap to their inputs; {len(golden)} golden "
        f"pairs equal the JAX reference; {n_sub}-pair stratified "
        f"subset equals the plain version; alignpair example -> {example[-1]}")

    true_cells = sum(len(a) * len(b) for _, a, _, b in named)
    timer = None
    if dev.type == "cuda":
        t0 = time.perf_counter()
        with KernelTimer(dev) as timer:
            _run_batch(named, dev)
        timer.wall = time.perf_counter() - t0
    return {"warm_s": warm, "cold_s": cold, "launches": launches, "peak": peak,
            "true_cells": true_cells, "timer": timer, "n": n}


# --- phase 5 ----------------------------------------------------------------
def phase_numbers(card, main_shape, main, fill_err, walk_err):
    tag = f"[{card}]"
    t = main["timer"]
    fill_s, walk_s = t.seconds("wavefront_fill"), t.seconds("traceback_walk")
    w = sorted(main["warm_s"])
    say("numbers", f"{tag} warm wall {main['n']} pairs, median of {len(w)} runs "
        f"{np.median(w):.3f} s = {main['n'] / np.median(w):.1f} aln/s (fastest "
        f"{main['n'] / w[0]:.1f}, slowest {main['n'] / w[-1]:.1f} aln/s; cold "
        f"{main['cold_s']:.2f} s)")
    say("numbers", f"{tag} main path device time (CUDA events): fill "
        f"{fill_s * 1e3:.1f} ms over {len(t.events['wavefront_fill'])} launches, walk "
        f"{walk_s * 1e3:.1f} ms over {len(t.events['traceback_walk'])} launches; "
        f"the two kernels busy {(fill_s + walk_s) / t.wall:.1%} of that run's "
        f"{t.wall:.3f} s wall")
    say("numbers", f"{tag} fill {main['true_cells'] / fill_s / 1e9:.2f} Gcells/s over "
        f"{main['true_cells']} true cells (sum la*lb), "
        f"{t.padded_cells / fill_s / 1e9:.2f} Gcells/s over {t.padded_cells} padded cells")
    say("numbers", f"{tag} B=64 999 nt bucket: fill {main_shape['fill_ms']:.3f} ms vs plain "
        f"{main_shape['fill_plain_ms']:.1f} ms; walk {main_shape['walk_ms']:.3f} ms vs "
        f"plain {main_shape['walk_plain_ms']:.1f} ms")
    say("numbers", f"{tag} B=64 999 nt bucket: fill with the table in shared memory "
        f"{main_shape['fill_ms']:.3f} ms, in global memory (G=24) "
        f"{main_shape['fill_global_table_ms']:.3f} ms")
    say("numbers", f"{tag} peak device memory of the warm run "
        f"{main['peak'] / 2**20:.1f} MiB (torch.cuda.max_memory_allocated)")
    kernels = []
    for name, short, err in (("wavefront_fill", "fill", fill_err),
                             ("traceback_walk", "walk", walk_err)):
        kernels.append({"name": name, **KERNELS[name],
                        "launches": main["launches"][name], "max_abs_err": err,
                        "ms": main_shape[f"{short}_ms"],
                        "plain_ms": main_shape[f"{short}_plain_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)


def main() -> int:
    dev, card = phase_device()
    phase_build()
    main_shape, fill_err, walk_err = phase_kernels(dev)
    main_run = phase_main(dev)
    phase_numbers(card, main_shape, main_run, fill_err, walk_err)
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("the port's main path imported jax")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
