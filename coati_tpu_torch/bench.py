"""The port's benchmark: the repository's bench.py, section by section, on
the card.

    python -m coati_tpu_torch.bench                          # on the card
    BENCH_QUICK=1 python -m coati_tpu_torch.bench --device cpu

Prints ONE JSON line on stdout with the keys of bench.py's line; everything
else goes to stderr as "# " lines (each section's route and kernel launches,
every pass, the whole record unrounded). Without CUDA and without
--device cpu it exits non-zero: there is no fallback to the CPU.

The same workloads as bench.py, from the same seed and the same order of
draws from one generator, so each section gets bench.py's pairs:

1. setup     - the mixed mar-mg pairs, encoded; the native single-thread
               anchor (native.viterbi_score over every 4th pair), cached a
               host in ~/.cache/coati_tpu_torch_anchor_v1.json by pairs, seed
               and the native library's build (its file name holds a hash).
2. headline  - engine.viterbi_align_batch over the mixed pairs: a warm-up
               pass (with the kernels' build on the card, reported as
               set-up), then passes until two agree within 10% of the
               fastest, their median reported and every pass kept.
3. device    - device_seconds: the summed time of every kernel launch of the
               first timed headline pass (profiling.KernelTimer: CUDA events
               on the card, the host clock around the plain versions on the
               CPU); device_chunk_breakdown groups it by chunk shape.
4. ladder    - homogeneous batches of 156 to 29,397 nt: one warm-up pass and
               two timed, the device time from the first timed one.
5. sample    - driver._forward_diag + sample_device.sample_batch_device on
               one pair; the native production route (sampleback_batch on
               Lehmer64) and native.sample_anchor beside it.
6. sample-long - the same on one long pair.
7. triplet   - triplet_wavefront.triplet_align_batch under tri-mg, a batch
               and a batch of longer pairs.
8. long pair - viterbi_align_batch on one long pair through the two-pass
               long path (long_slots=0: the section times that path at
               every size; at 32,001 nt the default byte budget would let
               the fill take the pair, whose rows fit it).

Environment knobs, as bench.py's: BENCH_QUICK=1 (small sizes), BENCH_PAIRS,
BENCH_LADDER (0: no ladder; its pairs are then not drawn, so later sections'
pairs shift as bench.py's do), BENCH_MAX_PASSES, BENCH_PASS_BUDGET_S,
BENCH_QUANTUM and BENCH_MAXCELLS_LOG2 (viterbi_align_batch's quantum and
max_batch_cells).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import types
from pathlib import Path

import numpy as np

from coati_tpu_torch.tools.inputs import LENGTH_MIX, make_pairs

SEED = 20260817
QUICK_MIX = [(156, 0.6), (471, 0.4)]
# bytes of the stdout line: a reader that keeps the last 2,000 characters of
# the output gets all of it
LINE_BYTES = 1500
# the keys of bench.py's line, in its order
KEYS = (
    "metric", "value", "unit", "vs_baseline", "cells_per_sec", "n_pairs",
    "batch_seconds", "pass_seconds", "stat", "baseline_cells_per_sec",
    "triplet_cells_per_sec", "triplet_long_cells_per_sec", "triplet_long_nt",
    "longpair_cells_per_sec", "longpair_nt", "samples_per_sec", "sample_n",
    "sample_nt", "samples_production_per_sec", "samples_baseline_per_sec",
    "samples_vs_baseline", "sample_long_per_sec", "sample_long_n",
    "sample_long_nt", "sample_long_vs_baseline", "device_seconds",
    "device_chunk_breakdown", "ladder", "device",
)
# the keys of a ladder rung that bench.py always writes
RUNG_KEYS = ("nt", "n_pairs", "cells_per_sec", "alignments_per_sec", "pass_seconds")


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Each section's size: (nt, count) pairs; the headline's pair count is
    BENCH_PAIRS's default."""

    pairs: int
    mix: list
    ladder: list  # [(nt, pairs)]
    sample: tuple  # (nt, samples)
    sample_long: tuple  # (nt, samples)
    triplet: tuple  # (nt, pairs)
    triplet_long: tuple  # (nt, pairs)
    long_nt: int


SIZES = {
    "full": Sizes(10_000, LENGTH_MIX,
                  [(156, 1024), (990, 512), (1959, 128), (3945, 32), (7872, 8),
                   (15624, 2), (29397, 1)],
                  (999, 1000), (9999, 200), (999, 64), (2997, 16), 32_001),
    "quick": Sizes(400, QUICK_MIX, [(156, 64), (471, 16)],
                   (471, 32), (999, 8), (471, 8), (999, 2), 7_998),
}


@dataclasses.dataclass(frozen=True)
class Config:
    sizes: Sizes
    n_pairs: int
    ladder: bool
    max_passes: int
    pass_budget_s: float
    quantum: int
    max_cells: int


def config(environ) -> Config:
    """The run's configuration from the BENCH_* variables of `environ`."""
    sizes = SIZES["quick" if environ.get("BENCH_QUICK") == "1" else "full"]
    return Config(
        sizes=sizes,
        n_pairs=int(environ.get("BENCH_PAIRS", sizes.pairs)),
        ladder=environ.get("BENCH_LADDER", "1") == "1",
        max_passes=int(environ.get("BENCH_MAX_PASSES", "6")),
        pass_budget_s=float(environ.get("BENCH_PASS_BUDGET_S", "90")),
        quantum=int(environ.get("BENCH_QUANTUM", "96")),
        max_cells=1 << int(environ.get("BENCH_MAXCELLS_LOG2", "30")),
    )


def section_pairs(cfg: Config, seed: int = SEED) -> dict:
    """Every section's (ancestor, descendant) pairs, drawn from one
    generator in bench.py's order: headline, ladder rungs (none without the
    ladder), sample, sample-long, triplet, triplet-long, long pair."""
    rng = np.random.default_rng(seed)
    s = cfg.sizes

    def one(nt):
        return make_pairs(1, rng, length_mix=[(nt, 1.0)])[0]

    out = {"headline": make_pairs(cfg.n_pairs, rng, length_mix=s.mix)}
    out["ladder"] = [(nt, make_pairs(n, rng, length_mix=[(nt, 1.0)]))
                     for nt, n in (s.ladder if cfg.ladder else [])]
    out["sample"] = one(s.sample[0])
    out["sample_long"] = one(s.sample_long[0])
    out["triplet"] = make_pairs(s.triplet[1], rng, length_mix=[(s.triplet[0], 1.0)])
    out["triplet_long"] = make_pairs(s.triplet_long[1], rng,
                                     length_mix=[(s.triplet_long[0], 1.0)])
    out["long"] = one(s.long_nt)
    return out


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def log_launches(section: str) -> None:
    """The kernel launches counted since the last reset, then a reset."""
    from coati_tpu_torch import profiling

    counts = {n: c for n, c in profiling.launch_counts().items() if c}
    log(f"kernels {section}: {json.dumps(counts)}")
    profiling.reset_launch_counts()


def native_anchor(enc_as, enc_bs, table, gap, n_pairs: int) -> float:
    """Cells/s of the native single-thread Viterbi score over every 4th
    pair, timed once a host and cached."""
    from coati_tpu_torch import native

    path = Path.home() / ".cache" / "coati_tpu_torch_anchor_v1.json"
    key = f"pairs{n_pairs}-seed{SEED}-{native.library_path().name}"
    try:
        blob = json.loads(path.read_text())
    except (OSError, ValueError):
        blob = {}
    if key in blob:
        rate = float(blob[key]["cells_per_sec"])
        log(f"native baseline (cached): {rate / 1e6:.0f} Mcells/s")
        return rate
    native.available()  # the build, outside the timing
    cells = 0
    t0 = time.perf_counter()
    for i in range(0, len(enc_as), 4):
        native.viterbi_score(enc_as[i], enc_bs[i], table, gap)
        cells += len(enc_as[i]) * len(enc_bs[i])
    rate = cells / (time.perf_counter() - t0)
    blob[key] = {"cells_per_sec": rate, "cells": cells,
                 "measured_at": time.strftime("%Y-%m-%d %H:%M:%S")}
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(blob, indent=1))
    log(f"native baseline (fresh, cached to {path}): {rate / 1e6:.0f} Mcells/s")
    return rate


def breakdown(timer) -> list[dict]:
    """The timed pass's chunks by shape, costliest first."""
    rows = [{"NA": na, "NB": nb, "B": b, "n_chunks": n,
             "device_ms_per_chunk": secs * 1e3 / n}
            for (na, nb, b), (n, secs) in timer.chunk_seconds().items()]
    return sorted(rows, key=lambda r: -r["n_chunks"] * r["device_ms_per_chunk"])


def run(cfg: Config, device: str = "cuda"):
    """Every section once on `device`: (the summary, with bench.py's keys
    and unrounded values; {"headline": its AlignResults, "triplet": the
    triplet batch's (s0, s1, score)})."""
    import torch

    from coati_tpu_torch import native, profiling
    from coati_tpu_torch.align.engine import viterbi_align_batch
    from coati_tpu_torch.align.sample_device import sample_batch_device
    from coati_tpu_torch.driver import _forward_diag
    from coati_tpu_torch.models import marginal_p, mg94_p
    from coati_tpu_torch.rng import Lehmer64
    from coati_tpu_torch.structs import AlignmentParams, GapParams
    from coati_tpu_torch.tools.common import device_and_label, sync
    from coati_tpu_torch.triplet_hmm import build_triplet_model
    from coati_tpu_torch.triplet_wavefront import triplet_align_batch
    from coati_tpu_torch.utils import encode_marginal

    dev, label = device_and_label(device)
    log(f"device: {label} | torch {torch.__version__}")
    t_setup = time.perf_counter()
    pi = (0.308, 0.185, 0.199, 0.308)
    table = marginal_p(mg94_p(0.0133, 0.2, pi), pi).astype(np.float32)
    gap = GapParams()
    inputs = section_pairs(cfg)
    pairs = inputs["headline"]
    enc = [encode_marginal(a, d) for a, d in pairs]
    enc_as, enc_bs = [e[0] for e in enc], [e[1] for e in enc]
    a_strs, b_strs = [p[0] for p in pairs], [p[1] for p in pairs]
    true_cells = float(sum(len(a) * len(b) for a, b in zip(enc_as, enc_bs)))
    log(f"setup: {cfg.n_pairs} pairs, {true_cells / 1e9:.2f} Gcells, "
        f"{time.perf_counter() - t_setup:.1f}s")
    base_rate = native_anchor(enc_as, enc_bs, table, gap, cfg.n_pairs)

    def align(ea, eb, sa, sb, **kw):
        return viterbi_align_batch(ea, eb, sa, sb, table, gap, quantum=cfg.quantum,
                                   max_batch_cells=cfg.max_cells, device=dev, **kw)

    def timed(fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return time.perf_counter() - t0, out

    # ---- headline --------------------------------------------------------
    profiling.reset_launch_counts()
    if dev.type == "cuda":
        from coati_tpu_torch.kernels import _build

        secs, _ = timed(lambda: (_build.build(), _build.load()))
        log(f"set-up: kernels built and loaded in {secs:.1f}s")
    warm, _ = timed(lambda: align(enc_as, enc_bs, a_strs, b_strs))
    log(f"set-up: warm-up pass {warm:.1f}s (first use of every chunk shape)")
    dts = []
    timer = profiling.KernelTimer(dev)  # around the first timed pass
    t_budget = time.perf_counter() + cfg.pass_budget_s
    for p in range(cfg.max_passes):
        with timer if p == 0 else contextlib.nullcontext():
            dt, results = timed(lambda: align(enc_as, enc_bs, a_strs, b_strs))
        dts.append(dt)
        log(f"pass {p + 1}: {dt:.3f}s")
        best = min(dts)
        if (p >= 1 and sum(d <= best * 1.10 for d in dts) >= 2) or time.perf_counter() > t_budget:
            break
    best = min(dts)
    dt = float(np.median([d for d in dts if d <= best * 1.10]))
    if not all(np.isfinite(r.score) and len(r.seq0) == len(r.seq1) for r in results):
        raise AssertionError("headline: a score is not finite or a row pair differs in length")
    device_seconds = timer.seconds()
    chunk_rows = breakdown(timer)
    log(f"headline: fill + walk, {dt:.3f}s a pass (median of the agreeing), "
        f"{cfg.n_pairs / dt:.1f} aln/s; device {device_seconds:.4f}s over "
        f"{sum(r['n_chunks'] for r in chunk_rows)} chunks")
    for r in chunk_rows:
        log(f"chunk {r['NA']}x{r['NB']} B={r['B']}: {r['n_chunks']} x "
            f"{r['device_ms_per_chunk']:.3f} ms")
    log_launches("headline")

    # ---- ladder ----------------------------------------------------------
    ladder = []
    for nt, lp in inputs["ladder"]:
        le = [encode_marginal(a, d) for a, d in lp]
        las, lbs = [e[0] for e in le], [e[1] for e in le]
        ast, bst = [p[0] for p in lp], [p[1] for p in lp]
        align(las, lbs, ast, bst)  # warm-up
        times = []
        with profiling.KernelTimer(dev) as lt:
            t, lres = timed(lambda: align(las, lbs, ast, bst))
        times.append(t)
        times.append(timed(lambda: align(las, lbs, ast, bst))[0])
        if not all(np.isfinite(r.score) for r in lres):
            raise AssertionError(f"ladder {nt} nt: a score is not finite")
        dt_l = float(np.median(times))
        cells_l = float(sum(len(a) * len(b) for a, b in zip(las, lbs)))
        l_dev = lt.seconds()
        ladder.append({"nt": nt, "n_pairs": len(lp), "cells_per_sec": cells_l / dt_l,
                       "alignments_per_sec": len(lp) / dt_l, "pass_seconds": times,
                       "device_seconds": l_dev, "device_cells_per_sec": cells_l / l_dev})
        log(f"ladder {nt} nt x {len(lp)}: {cells_l / dt_l / 1e6:.0f} Mcells/s wall, "
            f"{cells_l / l_dev / 1e6:.0f} device ({l_dev * 1e3:.2f} ms)")
        log_launches(f"ladder {nt}")

    # ---- sample ----------------------------------------------------------
    saln = types.SimpleNamespace(gap=gap, subst_matrix=table)

    def sampler(pair, n):
        se_a, se_b = encode_marginal(*pair)

        def draw():
            mdi, corners = _forward_diag(se_a, se_b, saln, dev)
            return list(sample_batch_device(mdi, corners, se_a, se_b, table,
                                            pair[0], pair[1], gap, SEED, n))
        return se_a, se_b, draw

    sample_nt, n_samples = cfg.sizes.sample
    se_a, se_b, draw = sampler(inputs["sample"], n_samples)
    draw()  # warm-up
    dt_s, s_out = timed(draw)
    if len(s_out) != n_samples or not all(np.isfinite(sc) for _, _, sc in s_out):
        raise AssertionError("sample: wrong count or a score that is not finite")
    samples_per_s = n_samples / dt_s
    log(f"sample: Forward + sample walk, {n_samples} tracebacks of a {sample_nt} nt "
        f"pair, {samples_per_s:.0f} samples/s")
    log_launches("sample")
    sp = inputs["sample"]
    native.sampleback_batch(se_a, se_b, table, gap, sp[0], sp[1], 8, Lehmer64())
    t0 = time.perf_counter()
    native.sampleback_batch(se_a, se_b, table, gap, sp[0], sp[1], n_samples, Lehmer64())
    samples_prod = n_samples / (time.perf_counter() - t0)
    log(f"sample production route (native Lehmer): {samples_prod:.0f} samples/s")
    native.sample_anchor(se_a, se_b, table, gap, 8)
    t0 = time.perf_counter()
    native.sample_anchor(se_a, se_b, table, gap, n_samples)
    samples_base = n_samples / (time.perf_counter() - t0)
    log(f"sample native anchor: {samples_base:.0f} samples/s -> vs_baseline "
        f"{samples_per_s / samples_base:.2f}")

    sl_nt, sl_n = cfg.sizes.sample_long
    sl_a, sl_b, draw = sampler(inputs["sample_long"], sl_n)
    draw()  # warm-up
    dt_sl, sl_out = timed(draw)
    if len(sl_out) != sl_n:
        raise AssertionError("sample-long: wrong count")
    sample_long_per_s = sl_n / dt_sl
    t0 = time.perf_counter()
    native.sample_anchor(sl_a, sl_b, table, gap, sl_n)
    sample_long_vs_base = sample_long_per_s / (sl_n / (time.perf_counter() - t0))
    log(f"sample-long: {sl_n} tracebacks of a {sl_nt} nt pair, {sample_long_per_s:.0f} "
        f"samples/s, vs_baseline {sample_long_vs_base:.2f}")
    log_launches("sample-long")
    del draw, s_out, sl_out
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the Forward matrices of the long pair

    # ---- triplet ---------------------------------------------------------
    tri_model = build_triplet_model(AlignmentParams(model="tri-mg"))

    def triplet(section):
        tp = inputs[section.replace("-", "_")]
        triplet_align_batch(tri_model, tp, device=dev)  # warm-up
        secs, res = timed(lambda: triplet_align_batch(tri_model, tp, device=dev))
        if not all(np.isfinite(sc) for _, _, sc in res):
            raise AssertionError(f"{section}: a score is not finite")
        rate = sum(len(a) * len(d) for a, d in tp) / secs
        log(f"{section}: rows + walk, {len(tp)} pairs x ~{len(tp[0][0])} nt, "
            f"{rate / 1e6:.0f} Mcells/s")
        log_launches(section)
        return rate, res

    tri_rate, tri_res = triplet("triplet")
    tri_l_rate, _ = triplet("triplet-long")

    # ---- long pair -------------------------------------------------------
    lp = inputs["long"]
    le_a, le_b = encode_marginal(*lp)
    align([le_a], [le_b], [lp[0]], [lp[1]], long_slots=0)  # warm-up
    dt_long, lres = timed(lambda: align([le_a], [le_b], [lp[0]], [lp[1]], long_slots=0))
    if not np.isfinite(lres[0].score):
        raise AssertionError("long pair: the score is not finite")
    long_rate = len(le_a) * len(le_b) / dt_long
    log(f"long pair: two-pass long path, {len(le_a)}x{len(le_b)} nt, "
        f"{long_rate / 1e6:.0f} Mcells/s")
    log_launches("long pair")

    aln_per_s = cfg.n_pairs / dt
    summary = {
        "metric": "alignments_per_sec_mixed10k_marmg",
        "value": aln_per_s,
        "unit": "alignments/s",
        "vs_baseline": aln_per_s / (cfg.n_pairs / (true_cells / base_rate)),
        "cells_per_sec": true_cells / dt,
        "n_pairs": cfg.n_pairs,
        "batch_seconds": dt,
        "pass_seconds": dts,
        "stat": "median_of_agreeing_passes",
        "baseline_cells_per_sec": base_rate,
        "triplet_cells_per_sec": tri_rate,
        "triplet_long_cells_per_sec": tri_l_rate,
        "triplet_long_nt": cfg.sizes.triplet_long[0],
        "longpair_cells_per_sec": long_rate,
        "longpair_nt": cfg.sizes.long_nt,
        "samples_per_sec": samples_per_s,
        "sample_n": n_samples,
        "sample_nt": sample_nt,
        "samples_production_per_sec": samples_prod,
        "samples_baseline_per_sec": samples_base,
        "samples_vs_baseline": samples_per_s / samples_base,
        "sample_long_per_sec": sample_long_per_s,
        "sample_long_n": sl_n,
        "sample_long_nt": sl_nt,
        "sample_long_vs_baseline": sample_long_vs_base,
        "device_seconds": device_seconds,
        "device_chunk_breakdown": chunk_rows,
        "ladder": ladder,
        "device": label,
    }
    return summary, {"headline": results, "triplet": tri_res}


class _OneDigit(float):
    """A number the line carries to one significant digit."""


def _number(x) -> str:
    """x as a JSON number, to what the noise supports: passes of one run
    agree within 10% and runs differ by up to 1.6x, so two significant
    digits, and whole numbers from 100 up to 1e5 (no longer than two digits
    would be); one digit for a _OneDigit."""
    if isinstance(x, (bool, int)) or x is None:
        return json.dumps(x)
    digits = 1 if isinstance(x, _OneDigit) else 2
    x = float(x)
    if digits == 2 and 100 <= abs(x) < 1e5:
        return str(round(x))
    if x == 0:
        return "0"
    text = f"{x:.{digits - 1}e}"
    mant, _, exp = text.partition("e")
    if -3 <= int(exp) < 2:
        return repr(float(text)).removesuffix(".0")
    return f"{mant.removesuffix('.0')}e{int(exp)}"


def _dumps(obj) -> str:
    if isinstance(obj, dict):
        return "{" + ",".join(f"{json.dumps(k)}:{_dumps(v)}" for k, v in obj.items()) + "}"
    if isinstance(obj, (list, tuple)):
        return "[" + ",".join(_dumps(v) for v in obj) + "]"
    if isinstance(obj, str):
        return json.dumps(obj)
    return _number(obj)


def summary_line(summary: dict, limit: int = LINE_BYTES) -> str:
    """The stdout line: the summary as compact JSON, its numbers rounded
    (_number). bench.py's keys all stay. Its ladder rungs keep RUNG_KEYS and
    its breakdown is one entry summing every chunk shape; then, while the
    line stays within `limit` bytes, the shapes are split out costliest
    first, and then each rung, smallest first, gets its device_seconds and
    device_cells_per_sec back. Where even that first line passes `limit`
    (the full configuration: the keys alone take some 1,200 bytes), the
    rungs' rates and pass times go to one significant digit, and, should
    the line still pass it, the largest rungs leave the line. What does not
    fit is on stderr."""
    shapes, rungs = summary["device_chunk_breakdown"], summary["ladder"]

    def line(n_shapes, n_rungs, coarse=False, n_ladder=len(rungs)):
        rest = shapes[n_shapes:]
        n = sum(r["n_chunks"] for r in rest)
        merged = [{"n_chunks": n, "device_ms_per_chunk": sum(
            r["n_chunks"] * r["device_ms_per_chunk"] for r in rest) / n}] if rest else []
        ladder = [r if i < n_rungs else {k: r[k] for k in RUNG_KEYS}
                  for i, r in enumerate(rungs[:n_ladder])]
        if coarse:
            ladder = [{**r, "cells_per_sec": _OneDigit(r["cells_per_sec"]),
                       "alignments_per_sec": _OneDigit(r["alignments_per_sec"]),
                       "pass_seconds": [_OneDigit(t) for t in r["pass_seconds"]]}
                      for r in ladder]
        return _dumps({**summary, "device_chunk_breakdown": shapes[:n_shapes] + merged,
                       "ladder": ladder})

    def fits(text):
        return len(text.encode()) <= limit

    if not fits(line(0, 0)):
        n_ladder = len(rungs)
        while n_ladder > 1 and not fits(line(0, 0, True, n_ladder)):
            n_ladder -= 1
        return line(0, 0, True, n_ladder)
    n_shapes = n_rungs = 0
    while n_shapes < len(shapes) and fits(line(n_shapes + 1, 0)):
        n_shapes += 1
    while n_rungs < len(rungs) and fits(line(n_shapes, n_rungs + 1)):
        n_rungs += 1
    return line(n_shapes, n_rungs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m coati_tpu_torch.bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    summary, _ = run(config(os.environ), args.device)
    log(f"record {json.dumps(summary)}")
    print(summary_line(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
