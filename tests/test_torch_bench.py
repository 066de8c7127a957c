"""coati_tpu_torch.bench, the port's counterpart of bench.py, on the CPU.

Its sections draw bench.py's pairs, draw for draw; a QUICK run with
--device cpu prints one line that holds tests/test_bench_schema.py's keys and
value checks; that run's headline (first 32 pairs) and triplet batch equal
the JAX package's results on XLA:CPU (strings byte-equal, scores bit-equal in
f32); and the line stays under 1,500 bytes at the full configuration.

The run patches QUICK's sizes (bench.SIZES, a module constant), because the
plain versions loop over diagonals and codon steps in Python: 48 headline
pairs of 156 nt, ladder rungs of 8 x 156 and 2 x 471 nt, samples of 156 and
471 nt, triplet batches of 8 x 156 and 2 x 312 nt and a 471 nt long pair, in
place of 400 pairs of 156/471 nt, 64 x 156, 16 x 471, 471, 999, 8 x 471,
2 x 999 and 7,998 nt (the last alone ~40 s a pass through the plain
segmented path). The run keeps one CPU thread: under a parallel test run
each worker's thread pool would otherwise contend for every core.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

import bench as jax_bench
from coati_tpu import triplet_wavefront as jax_tw
from coati_tpu.align.engine import viterbi_align_batch as jax_align_batch
from coati_tpu.models import marginal_p, mg94_p
from coati_tpu.structs import AlignmentParams as JaxAlignmentParams
from coati_tpu.structs import GapParams as JaxGapParams
from coati_tpu.triplet_hmm import build_triplet_model as jax_triplet_model
from coati_tpu.utils import encode_marginal
from coati_tpu_torch import bench

# tests/test_bench_schema.py:38-50, the keys of bench.py's line
SCHEMA_KEYS = (
    "metric", "value", "unit", "vs_baseline", "cells_per_sec",
    "n_pairs", "batch_seconds", "pass_seconds", "stat",
    "baseline_cells_per_sec", "triplet_cells_per_sec",
    "triplet_long_cells_per_sec", "longpair_cells_per_sec",
    "samples_per_sec", "sample_n", "sample_nt",
    "samples_production_per_sec",
    "samples_baseline_per_sec", "samples_vs_baseline",
    "sample_long_per_sec", "sample_long_n", "sample_long_nt",
    "sample_long_vs_baseline",
    "device_seconds", "device_chunk_breakdown", "ladder", "device",
)
RUN_SIZES = dataclasses.replace(
    bench.SIZES["quick"], pairs=48, mix=[(156, 1.0)], ladder=[(156, 8), (471, 2)],
    sample=(156, 8), sample_long=(471, 4), triplet=(156, 8), triplet_long=(312, 2),
    long_nt=471)
RUN_ENV = {"BENCH_QUICK": "1", "BENCH_MAX_PASSES": "2", "BENCH_PASS_BUDGET_S": "30"}


def jax_bench_draws(quick: bool, ladder: bool) -> dict:
    """bench.py's pairs in the order its main() draws them (bench.py:147,
    :283-295, :344-346, :409-410, :442, :456-457, :473-474), with its
    sizes."""
    rng = np.random.default_rng(20260817)
    mix = ([(156, 0.6), (471, 0.4)] if quick else
           [(156, 0.35), (471, 0.30), (999, 0.20), (1500, 0.15)])
    spec = ([(156, 64), (471, 16)] if quick else
            [(156, 1024), (990, 512), (1959, 128), (3945, 32), (7872, 8),
             (15624, 2), (29397, 1)])

    def draw(n, nt):
        return jax_bench.make_pairs(n, rng, length_mix=[(nt, 1.0)])

    out = {"headline": jax_bench.make_pairs(400 if quick else 10000, rng, length_mix=mix)}
    out["ladder"] = [(nt, draw(n, nt)) for nt, n in spec] if ladder else []
    out["sample"] = draw(1, 471 if quick else 999)[0]
    out["sample_long"] = draw(1, 999 if quick else 9999)[0]
    out["triplet"] = draw(8 if quick else 64, 471 if quick else 999)
    out["triplet_long"] = draw(2 if quick else 16, 999 if quick else 2997)
    out["long"] = draw(1, 7998 if quick else 32001)[0]
    return out


@pytest.mark.parametrize("quick,ladder", [(True, True), (True, False), (False, True)])
def test_sections_draw_the_jax_benchs_pairs(quick, ladder):
    env = {"BENCH_QUICK": "1"} if quick else {}
    if not ladder:
        env["BENCH_LADDER"] = "0"
    assert bench.section_pairs(bench.config(env)) == jax_bench_draws(quick, ladder)


@pytest.fixture(scope="module")
def quick_run(tmp_path_factory):
    """One QUICK run of main(["--device", "cpu"]) in this process: (rc, its
    stdout, its stderr, what run() returned)."""
    got = {}
    real_run = bench.run

    def spy(*args, **kw):
        got["run"] = real_run(*args, **kw)
        return got["run"]

    out, err = io.StringIO(), io.StringIO()
    home = str(tmp_path_factory.mktemp("home"))  # the native anchor's cache
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with mock.patch.dict(os.environ, {**RUN_ENV, "HOME": home}), \
                mock.patch.dict(bench.SIZES, quick=RUN_SIZES), \
                mock.patch.object(bench, "run", spy), \
                contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench.main(["--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    return rc, out.getvalue(), err.getvalue(), got["run"]


def test_quick_run_prints_the_schemas_line(quick_run):
    """The checks tests/test_bench_schema.py makes of bench.py's line."""
    rc, stdout, stderr, _ = quick_run
    assert rc == 0, stderr[-2000:]
    lines = [ln for ln in stdout.strip().splitlines() if ln.strip()]
    assert len(lines) == 1, stdout
    assert len(lines[0].encode()) < bench.LINE_BYTES
    out = json.loads(lines[0])
    for key in SCHEMA_KEYS:
        assert key in out, key
    assert tuple(out) == bench.KEYS
    assert out["device_seconds"] > 0
    assert isinstance(out["device_chunk_breakdown"], list)
    assert out["device_chunk_breakdown"]
    for entry in out["device_chunk_breakdown"]:
        assert entry["n_chunks"] >= 1 and entry["device_ms_per_chunk"] > 0
    assert out["samples_vs_baseline"] is None or out["samples_vs_baseline"] > 0
    assert out["sample_long_per_sec"] > 0
    assert out["metric"] == "alignments_per_sec_mixed10k_marmg"
    assert out["value"] > 0
    assert out["stat"] == "median_of_agreeing_passes"
    assert isinstance(out["pass_seconds"], list) and out["pass_seconds"]
    assert all(t > 0 for t in out["pass_seconds"])
    assert isinstance(out["ladder"], list) and out["ladder"]
    for entry in out["ladder"]:
        for key in ("nt", "n_pairs", "cells_per_sec",
                    "alignments_per_sec", "pass_seconds"):
            assert key in entry, entry
        assert entry["cells_per_sec"] > 0
    assert out["samples_per_sec"] > 0
    # the port's own: the device named, the anchor set, every section's
    # launches on stderr (none on the CPU, where the plain versions run)
    assert out["device"] == "cpu" and out["vs_baseline"] > 0
    sections = [ln.split(":")[0] for ln in stderr.splitlines() if ln.startswith("# kernels ")]
    assert sections == ["# kernels headline", "# kernels ladder 156", "# kernels ladder 471",
                        "# kernels sample", "# kernels sample-long", "# kernels triplet",
                        "# kernels triplet-long", "# kernels long pair"]


def test_quick_run_equals_the_jax_package(quick_run):
    """The run's headline results (first 32 pairs) and triplet batch equal
    coati_tpu's on XLA:CPU, each package with its own parameters."""
    summary, results = quick_run[3]
    with mock.patch.dict(bench.SIZES, quick=RUN_SIZES):
        inputs = bench.section_pairs(bench.config(RUN_ENV))
    pi = (0.308, 0.185, 0.199, 0.308)
    table = marginal_p(mg94_p(0.0133, 0.2, pi), pi).astype(np.float32)
    pairs = inputs["headline"][:32]
    enc = [encode_marginal(a, d) for a, d in pairs]
    want = jax_align_batch([e[0] for e in enc], [e[1] for e in enc],
                           [p[0] for p in pairs], [p[1] for p in pairs],
                           table, JaxGapParams())
    for got, w in zip(results["headline"][:32], want, strict=True):
        assert (got.seq0, got.seq1) == (w.seq0, w.seq1)
        assert np.float32(got.score) == np.float32(w.score)

    model = jax_triplet_model(JaxAlignmentParams(model="tri-mg"))
    want = jax_tw.triplet_align_batch(model, inputs["triplet"])
    assert len(results["triplet"]) == len(inputs["triplet"]) == 8
    for got, w in zip(results["triplet"], want, strict=True):
        assert got[:2] == w[:2]
        assert np.float32(got[2]) == np.float32(w[2])


# the unrounded record of the full configuration, as printed on stderr by a
# run on an NVIDIA H100 80GB HBM3 at 700 W (to four digits)
H100_RECORD = {
    "metric": "alignments_per_sec_mixed10k_marmg", "value": 38320.0, "unit": "alignments/s",
    "vs_baseline": 114.9, "cells_per_sec": 2.359e10, "n_pairs": 10000, "batch_seconds": 0.261,
    "pass_seconds": [0.2811, 0.3362, 0.2536, 0.2683], "stat": "median_of_agreeing_passes",
    "baseline_cells_per_sec": 2.054e8, "triplet_cells_per_sec": 3.632e9,
    "triplet_long_cells_per_sec": 6.806e9, "triplet_long_nt": 2997,
    "longpair_cells_per_sec": 5.892e9, "longpair_nt": 32001, "samples_per_sec": 59400.0,
    "sample_n": 1000, "sample_nt": 999, "samples_production_per_sec": 7005.0,
    "samples_baseline_per_sec": 7733.0, "samples_vs_baseline": 7.682,
    "sample_long_per_sec": 3195.0, "sample_long_n": 200, "sample_long_nt": 9999,
    "sample_long_vs_baseline": 181.0, "device_seconds": 0.0255,
    "device_chunk_breakdown": [
        {"NA": 1536, "NB": 1536, "B": 454, "n_chunks": 3, "device_ms_per_chunk": 3.744},
        {"NA": 1056, "NB": 1056, "B": 961, "n_chunks": 2, "device_ms_per_chunk": 3.019},
        {"NA": 480, "NB": 480, "B": 2851, "n_chunks": 1, "device_ms_per_chunk": 3.199},
        {"NA": 1536, "NB": 1536, "B": 144, "n_chunks": 1, "device_ms_per_chunk": 2.389},
        {"NA": 1056, "NB": 1056, "B": 103, "n_chunks": 1, "device_ms_per_chunk": 1.19},
        {"NA": 192, "NB": 192, "B": 3487, "n_chunks": 1, "device_ms_per_chunk": 0.8256},
        {"NA": 480, "NB": 576, "B": 131, "n_chunks": 1, "device_ms_per_chunk": 0.626}],
    "ladder": [
        {"nt": 156, "n_pairs": 1024, "cells_per_sec": 2.612e9, "alignments_per_sec": 107300.0,
         "pass_seconds": [0.01091, 0.008169], "device_seconds": 0.0004349,
         "device_cells_per_sec": 5.731e10},
        {"nt": 990, "n_pairs": 512, "cells_per_sec": 3.417e10, "alignments_per_sec": 34870.0,
         "pass_seconds": [0.01666, 0.01271], "device_seconds": 0.00168,
         "device_cells_per_sec": 2.986e11},
        {"nt": 1959, "n_pairs": 128, "cells_per_sec": 5.518e10, "alignments_per_sec": 14380.0,
         "pass_seconds": [0.009388, 0.008412], "device_seconds": 0.002469,
         "device_cells_per_sec": 1.989e11},
        {"nt": 3945, "n_pairs": 32, "cells_per_sec": 3.312e10, "alignments_per_sec": 2129.0,
         "pass_seconds": [0.015, 0.01506], "device_seconds": 0.01297,
         "device_cells_per_sec": 3.839e10},
        {"nt": 7872, "n_pairs": 8, "cells_per_sec": 3.128e10, "alignments_per_sec": 504.8,
         "pass_seconds": [0.01573, 0.01597], "device_seconds": 0.01397,
         "device_cells_per_sec": 3.549e10},
        {"nt": 15624, "n_pairs": 2, "cells_per_sec": 3.02e10, "alignments_per_sec": 123.8,
         "pass_seconds": [0.01612, 0.01619], "device_seconds": 0.01394,
         "device_cells_per_sec": 3.501e10},
        {"nt": 29397, "n_pairs": 1, "cells_per_sec": 5.433e9, "alignments_per_sec": 6.286,
         "pass_seconds": [0.159, 0.1592], "device_seconds": 0.1574,
         "device_cells_per_sec": 5.493e9}],
    "device": "NVIDIA H100 80GB HBM3, 700.00 W",
}


@pytest.mark.parametrize("passes", [4, 6])
def test_line_of_the_full_configuration_stays_under_the_limit(passes):
    """The H100 run's record, and the same with six passes (the most the
    bench takes), gives a line under 1,500 bytes with every key, all seven
    rungs and every chunk of the breakdown."""
    summary = {**H100_RECORD, "pass_seconds": (H100_RECORD["pass_seconds"] * 2)[:passes]}
    line = bench.summary_line(summary)
    assert len(line.encode()) < 1500, len(line.encode())
    out = json.loads(line)
    assert tuple(out) == bench.KEYS
    assert [r["nt"] for r in out["ladder"]] == [r["nt"] for r in H100_RECORD["ladder"]]
    assert all(set(bench.RUNG_KEYS) <= set(r) for r in out["ladder"])
    assert sum(e["n_chunks"] for e in out["device_chunk_breakdown"]) == 10
    assert len(out["pass_seconds"]) == passes
    assert out["value"] == 38320 and out["cells_per_sec"] == 2.4e10
    assert out["ladder"][0]["cells_per_sec"] == 3e9  # a rung's rates to one digit


def test_line_stays_under_the_limit_at_any_size():
    """With every value at its longest (rates of five digits or with an
    exponent, passes of 0.01 and 0.001 s, 24 chunk shapes) the line still
    keeps every key and stays under 1,500 bytes, its largest rungs left to
    stderr; a QUICK-sized summary keeps every rung's device numbers and every
    shape, at two significant digits."""
    rate, secs, big = 1.23456e11, 0.0123456, 98765.4
    shapes = [{"NA": na, "NB": nb, "B": 1023, "n_chunks": 12, "device_ms_per_chunk": 12.3456}
              for na in (192, 480, 1056, 1536) for nb in (192, 480, 576, 1056, 1536, 1632)]
    rungs = [{**r, "cells_per_sec": rate, "alignments_per_sec": big,
              "pass_seconds": [secs, 0.00823], "device_seconds": secs,
              "device_cells_per_sec": rate} for r in H100_RECORD["ladder"]]
    summary = {k: big if isinstance(v, float) else v for k, v in H100_RECORD.items()}
    summary.update(pass_seconds=[0.00823] * 6, device_chunk_breakdown=shapes, ladder=rungs)
    line = bench.summary_line(summary)
    assert len(line.encode()) < 1500, len(line.encode())
    out = json.loads(line)
    assert tuple(out) == bench.KEYS and out["ladder"]
    assert sum(e["n_chunks"] for e in out["device_chunk_breakdown"]) == 12 * len(shapes)

    small = {**summary, "device_chunk_breakdown": shapes[:3], "ladder": rungs[:2]}
    out = json.loads(bench.summary_line(small))
    assert out["device_chunk_breakdown"] == json.loads(bench._dumps(shapes[:3]))
    assert all("device_seconds" in r for r in out["ladder"])
    assert out["ladder"][0]["cells_per_sec"] == 1.2e11


@pytest.mark.parametrize("x,text", [(0.0123456, "0.012"), (12.3456, "12"), (1.5, "1.5"),
                                    (7227.4, "7227"), (98765.4, "98765"), (1.23456e11, "1.2e11"),
                                    (1.5e-5, "1.5e-5"), (0.0, "0"), (None, "null"), (400, "400")])
def test_numbers_are_rounded_to_two_digits(x, text):
    assert bench._number(x) == text
    assert json.loads(text) == (None if x is None else pytest.approx(x, rel=0.05))


def test_no_card_no_run():
    """Without CUDA and without --device cpu the bench fails before it
    draws or prints anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would run on it")
    with mock.patch.object(bench, "section_pairs") as draws, \
            contextlib.redirect_stdout(io.StringIO()) as out:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.main([])
    assert not draws.called and out.getvalue() == ""
