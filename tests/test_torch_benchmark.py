"""The port's benchmark (BENCHMARK.json, benchmark/) on the CPU at tiny sizes.

Each of the five cells, and the four-card cell that waits outside
BENCHMARK.json, runs through the harness with --device cpu, where the port
runs its kernels' plain versions (the four-card cell over four CPU lanes):
every metric is printed by name with its unit, the checks pass, an
altered alignment string counts one failure, and the control (the checks'
reference in lower precision in the program's place) is caught. The
harness's readings over several cards, its host layer times and its
breakdown of a trace are held to made-up numbers and hand-made events. The
checks' reference is held to the JAX package's tables, oracle and triplet
sweep; the harness's generator to the tools' draw for draw, the roofline
work to the true cells whatever the chunk size, and the harness to
importing nothing of JAX, the JAX package or either bench.

Two module constants are lowered so that the tiny cells keep their real
routes (both are read at the call): driver.NATIVE_SAMPLE_CELLS, so that
`sample` takes the Forward + walk route and not the native host sampler, and
longseq.BP_BUDGET_BYTES, so that the largest alignpair pair takes the
two-pass long path while the others take the fill.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import checks, reference, roofline, run
from benchmark.inputs import cell_pairs, make_pairs

REPO = Path(__file__).resolve().parent.parent
SEED = 5
# the cells at a size the plain versions run in seconds on the CPU
TINY = {
    "batch-mix10k": {"traffic": {"pairs": 8, "length_mix": [[24, 0.5], [36, 0.5]]}},
    "alignpair-refladder": {"traffic": {"lengths": [21, 33, 72]},
                            "check": {"align_max_nt": 72, "witness_max_nt": 33}},
    "alignpair-160k": {"traffic": {"lengths": [72]},
                       "check": {"align_max_nt": 60, "witness_max_nt": 33}},
    "sample-10k": {"traffic": {"lengths": [45]}, "samples": 20},
    "batch-tri-mg-exons": {"traffic": {"pairs": 4, "length_mix": [[30, 1.0]]}},
    "batch-mix40k-4card": {"traffic": {"pairs": 8, "length_mix": [[24, 0.5], [36, 0.5]]}},
}
# a bp stack of the 72 nt pair passes it (5,840 bytes of rows, two bands),
# one of the 33 nt pair does not
BP_BUDGET = 4000


@pytest.fixture
def tiny_routes(monkeypatch):
    from coati_tpu_torch import driver
    from coati_tpu_torch.align import longseq

    monkeypatch.setattr(driver, "NATIVE_SAMPLE_CELLS", 0)
    monkeypatch.setattr(longseq, "BP_BUDGET_BYTES", BP_BUDGET)


def tiny_cell(name):
    cell = run.load_cell(name)
    cell.update(TINY[name])
    return cell


def index():
    return json.loads((REPO / "BENCHMARK.json").read_text())


# the cell that waits outside BENCHMARK.json: its runs spread wider than its bound
WAITING = ["batch-mix40k-4card"]


def reports(doc, cell, m):
    """Whether a run of the cell reports metric m: its own end-to-end metric
    and peak memory, the kernel metrics of its kernel families, the host
    layer times in a batch cell, the busy share and the build everywhere."""
    if doc["metrics"][m]["kind"] == "end_to_end":
        return m in (cell["metric"], "peak_device_mib")
    if m.startswith("kernel_"):
        return m.split(".")[1] in cell["kernels"]
    if m.startswith("host_seconds."):
        return cell["verb"] == "batch"
    return m in ("device_busy_share", "build_seconds")


@pytest.mark.parametrize("name", list(TINY))
def test_cell_prints_every_metric_and_passes_its_checks(name, tiny_routes):
    from coati_tpu_torch.align import longseq

    cell = tiny_cell(name)
    if cell["verb"] == "alignpair":  # the largest pair alone takes the long path
        pairs = cell_pairs(cell["traffic"], SEED)
        assert [longseq.is_long_pair(len(a), len(b), 1) for a, b in pairs] == \
            [n == 72 for n in cell["traffic"]["lengths"]]
    lines = []
    record = run.run_cell(cell, SEED, "cpu", repeats=1, log=lines.append)
    assert record["correct"] and record["checks"]["failed"] == 0
    assert record["checks"]["attempted"] > len(cell_pairs(cell["traffic"], SEED))
    line = json.dumps(record, separators=(",", ":"))
    assert len(line) < 1500
    decl = index()["metrics"]
    named = [m for m in decl if reports(index(), cell, m)]
    assert cell["metric"] in named and "peak_device_mib" in named
    for metric in named:
        shown = [ln for ln in lines if ln.startswith(f"{metric}: ")]
        assert len(shown) == 1, metric
        assert decl[metric]["unit"] in shown[0]
    for metric in named:  # and in the last line
        assert metric in record or metric in record["layer"], metric
    # no device number from a CPU run
    assert record["peak_device_mib"] is None
    assert all(v is None for m, v in record["layer"].items()
               if m.startswith("kernel_") or m == "device_busy_share")
    assert record["stats"][cell["metric"]]["n"] == 1
    # and nothing that BENCHMARK.json does not name for this cell
    assert {m for m in record if m in decl} | set(record["layer"]) <= set(named)
    assert ("host_seconds.output" in record["layer"]) == (cell["verb"] == "batch")
    assert "engine_seconds" not in record["layer"]
    # the breakdown: no device operation and no card on the CPU
    assert record["breakdown"]["ops"] == [] and record["breakdown"]["gaps"] == []


def _altered(text, old, new):
    assert old in text
    return text.replace(old, new, 1)


@pytest.mark.parametrize("name", list(TINY))
def test_an_altered_string_counts_one_failure(name, tiny_routes, tmp_path):
    cell = tiny_cell(name)
    pairs = cell_pairs(cell["traffic"], SEED)
    from coati_tpu_torch.align import sample_device

    calls = run.calls_of(cell, pairs, SEED, run.cards(cell, "cpu"), tmp_path)
    kept = []
    with run.stand_in(sample_device, "sample_uniforms", run.keep_uniforms(kept)):
        outputs = run.repeat(calls, run.cards(cell, "cpu"))[2]
    uniforms = np.concatenate(kept, axis=1) if kept else None

    def tally(texts):
        t = checks.Tally()
        run.check_calls(t, cell, [s.pairs for s in calls], texts, uniforms)
        return t

    good = tally(outputs)
    assert good.failed == 0 and good.attempted > 0
    # one nucleotide of one descendant string changed: A <-> C
    text = outputs[-1]
    if cell["verb"] == "batch":
        row = json.loads(text.splitlines()[1])
        s1 = list(row["alignment"].values())[1]
    elif cell["verb"] == "alignpair":
        s1 = list(json.loads(text)["alignment"].values())[1]
    else:
        s1 = list(json.loads(text)[1]["alignment"].values())[1]
    at = re.search("[AC]", s1).start()
    changed = s1[:at] + {"A": "C", "C": "A"}[s1[at]] + s1[at + 1:]
    bad = tally(outputs[:-1] + [_altered(text, f'"{s1}"', f'"{changed}"')])
    assert (bad.attempted, bad.failed) == (good.attempted, 1)
    assert bad.notes


@pytest.mark.parametrize("name", list(TINY))
def test_the_control_is_caught(name):
    """The reference in bfloat16 in the program's place: every
    cell's checks call it incorrect. bfloat16 changes no sample of a 45 nt
    pair (its errors grow with the length), so the sample cell's control
    takes a 1,500 nt pair, in the reference alone."""
    cell = tiny_cell(name)
    if name == "sample-10k":
        cell.update(traffic={"lengths": [1500]}, samples=50)
    lines = []
    record = run.control_cell(cell, SEED, log=lines.append)
    assert record["caught"] and record["checks"]["failed"] > 0
    assert record["checks"]["worst"]
    assert lines[-1].startswith("# check reading ")


def _jax_gap(cfg):
    from coati_tpu.structs import GapParams

    return GapParams(len=1, open=cfg["gap_open"], extend=cfg["gap_extend"])


class _Uniforms:
    """An rng whose f24() draws are one column of the uniforms in turn."""

    def __init__(self, column):
        self.it = iter(column)

    def f24(self):
        return float(next(self.it))


def test_reference_equals_the_jax_package():
    """The checks' reference, built from the configurations alone, against
    the JAX package: the marginal table bit for bit, the oracle's Viterbi
    alignments byte for byte with equal scores, its sampleback on the same
    uniforms, and the triplet sweep's f64 optimum."""
    from coati_tpu import utils as jutils
    from coati_tpu.align import oracle
    from coati_tpu.align.semiring import LOG
    from coati_tpu.models import marginal_p, mg94_p
    from coati_tpu.structs import AlignmentParams
    from coati_tpu.triplet_hmm import build_triplet_model, encode_triplet_pair, triplet_forward

    cfg = run.load_cell("batch-mix10k")["config"]
    ref = reference.Marginal(cfg)
    table = marginal_p(mg94_p(cfg["time"], cfg["omega"], cfg["pi"]), cfg["pi"])
    table = table.astype(np.float32)
    assert np.array_equal(ref.table, table[:, :4])
    gap = _jax_gap(cfg)
    pairs = make_pairs(6, np.random.default_rng(11), [(24, 0.5), (36, 0.5)])
    pairs.append((pairs[0][0], pairs[0][1][:len(pairs[0][1]) // 3 * 3 - 3] + "TGA"))
    for a, b in pairs:
        ta, tb, sa, sb = reference.split_stops(a, b)
        ea, eb = jutils.encode_marginal(ta, tb)
        want = oracle.traceback(oracle.forward_oracle(ea, eb, table, gap), ta, tb, gap)
        got = ref.align(a, b)
        assert got[:2] == (want[0] + (sa or "---" * bool(sb)), want[1] + (sb or "---" * bool(sa)))
        extra = ref.stop_gap if len(sa) != len(sb) else np.float32(0)
        assert got[2] == float(np.float32(np.float32(want[2]) + extra))
        assert ref.path_value(a, b, *got[:2]) == got[2]
    # the sampler: the oracle's sampleback over its Forward, one column each
    a, b = pairs[1]
    ea, eb = jutils.encode_marginal(a, b)
    work = oracle.forward_oracle(ea, eb, table, gap, semiring=LOG)
    u = np.random.default_rng(2).random((len(a) + len(b) + 1, 6), dtype=np.float32)
    drawn, _ = ref.sample(a, b, u)
    for s, (s0, s1, score) in enumerate(drawn):
        want = oracle.sampleback_mdi(work.mch, work.del_, work.ins, ea, eb, table, a, b,
                                     gap, _Uniforms(u[:, s]))
        assert (s0, s1) == want[:2] and score == pytest.approx(want[2], abs=1e-5)
    # the triplet model's optimum, f64 against f64
    tcfg = run.load_cell("batch-tri-mg-exons")["config"]
    tri = reference.Triplet(tcfg)
    model = build_triplet_model(AlignmentParams(model="tri-mg", br_len=tcfg["time"],
                                                omega=tcfg["omega"], gap=_jax_gap(tcfg)))
    for a, b in pairs[:4]:
        term = triplet_forward(model, *encode_triplet_pair(model, a, b), dtype=np.float64)[0]
        assert tri.score(a, b) == pytest.approx(-max(term), rel=1e-12)
        s0, s1, score = tri.align(a, b)
        assert tri.path_score(a, b, s0, s1) == pytest.approx(score, rel=1e-12)


def test_rates_are_the_whole_window():
    st = run.rate_stats(10, [1.0, 1.0, 2.0], True)
    assert st["value"] == pytest.approx(30 / 4) and st["median"] == 10 and st["n"] == 3
    assert st["min"] == 5 and st["max"] == 10
    st = run.rate_stats(1, [1.0, 1.0, 4.0], False)
    assert st["value"] == 2.0 and st["median"] == 1.0


def test_generator_equals_the_tools_draw_for_draw():
    from coati_tpu_torch.tools.inputs import LENGTH_MIX
    from coati_tpu_torch.tools.inputs import make_pairs as tools_make_pairs

    mix = run.load_cell("batch-mix10k")["traffic"]["length_mix"]
    assert [tuple(x) for x in mix] == LENGTH_MIX
    for seed in (0, 20261017):
        ours = make_pairs(40, np.random.default_rng(seed), mix)
        assert ours == tools_make_pairs(40, np.random.default_rng(seed), LENGTH_MIX)
    # one pair a length, in turn, from one generator
    lengths = [156, 990, 33]
    rng = np.random.default_rng(3)
    want = [tools_make_pairs(1, rng, [(n, 1.0)])[0] for n in lengths]
    assert cell_pairs({"lengths": lengths}, 3) == want
    assert [len(a) for a, _ in want] == lengths


def test_roofline_work_does_not_move_with_the_chunk_size(tmp_path):
    cell = tiny_cell("batch-mix10k")
    pairs = cell_pairs(cell["traffic"], SEED)
    works = []
    for chunk in (2048, 5):
        calls = run.calls_of(cell, pairs, SEED, ["cpu"], tmp_path, chunk=chunk)
        text = run.repeat(calls, ["cpu"])[2][0]
        fill = {"fill": (1, 0.0), "walk": (1, 0.0)}
        works.append(run.call_work(cell, calls[0], text, fill).by)
    assert works[0] == works[1]
    cells = sum((len(a) + 1) * (len(b) + 1) for a, b in pairs)
    assert works[0]["fill"][1] == roofline.CELL_OPS_BP * cells
    # the long route counts the same cells twice, and no route where both ran
    long = run.call_work(cell, calls[0], text, {"segment_bp": (1, 0.0)}).by
    assert long["segment_bp"][1] == roofline.CELL_OPS_BP * cells
    assert long["segment_pass1"][1] == roofline.CELL_OPS * cells
    assert run.call_work(cell, calls[0], text,
                            {"fill": (1, 0.0), "segment_bp": (1, 0.0)}).by == {}


def test_kernel_families_by_trace_name():
    names = {
        "void strip_fill_kernel<1, 8, true>(FillArgs)": "fill",
        "_Z17strip_fill_kernelILi1ELi8ELb1EEv8FillArgs": "fill",
        "void strip_fill_kernel<3, 16, false>(FillArgs)": "score",
        "traceback_walk_kernel(unsigned char const*, float const*)": "walk",
        "traceback_walk_segment_kernel(unsigned char const*)": "segment_walk",
        "void wavefront_band_kernel<(Out)0>(SweepArgs)": "segment_pass1",
        "void wavefront_band_kernel<(Out)1>(SweepArgs)": "segment_bp",
        "void wavefront_sweep_kernel<true, (Out)2, false>(SweepArgs)": "forward",
        "void (anonymous namespace)::wavefront_band_kernel<((anonymous namespace)::Out)1>"
        "((anonymous namespace)::SweepArgs)": "segment_bp",
        "_ZN12_GLOBAL__N_121wavefront_band_kernelILNS_3OutE2EEEvNS_9SweepArgsE": "forward",
        "sample_window_kernel(float const*)": "sample_walk",
        "void triplet_rows_kernel(int const*)": "triplet_rows",
        "void triplet_walk_kernel<2>(float const*)": "triplet_walk",
        "void at::native::vectorized_elementwise_kernel<4>(int)": "other",
    }
    for name, fam in names.items():
        assert roofline.family(name) == fam, name
    # bytes or operations, whichever takes longer
    assert roofline.bound_ms(3.35e9, 0) == pytest.approx(1.0)
    assert roofline.bound_ms(0, 67e9) == pytest.approx(1.0)
    assert roofline.walk_steps("AC-GT", "ACCG-", 1) == 5
    assert roofline.walk_steps("AC---GT", "ACCCGGT", 3) == 5


def test_benchmark_json_names_the_five_cells():
    doc = index()
    names = [w["name"] for w in doc["workloads"]]
    assert names == ["batch-mix10k", "alignpair-refladder", "alignpair-160k",
                     "sample-10k", "batch-tri-mg-exons"]
    assert sorted(p.stem for p in (REPO / "benchmark" / "cells").glob("*.json")) == \
        sorted(names + WAITING)
    decl = doc["metrics"]
    for w in doc["workloads"]:
        cell = run.load_cell(w["name"])
        assert w["chips"] == cell["chips"] == 1 and "chips" not in json.loads(
            (REPO / w["cell"]).read_text())
        assert len(w["source"]) <= 200 and w["reduced"] == []
        assert w["command"] == f"python3 benchmark/run.py {w['name']}"
        assert w["metrics"] == [cell["metric"], "peak_device_mib"]
        for m in w["metrics"]:
            assert decl[m]["kind"] == "end_to_end" and w["name"] in decl[m]["workloads"]
            assert 0 < w["bounds"][m] < 1
        for fam in cell["kernels"]:
            for m in (f"kernel_ms.{fam}", f"kernel_roofline.{fam}"):
                assert w["name"] in decl[m]["workloads"]
    for m, d in decl.items():
        assert d["unit"] and d["direction"] in ("higher", "lower") and d["workloads"]
        assert set(d["workloads"]) <= set(names)
        if m.startswith("kernel_"):
            fam = m.split(".")[1]
            assert d["workloads"] == [n for n in names
                                      if fam in run.load_cell(n)["kernels"]]


def test_every_metric_names_only_cells_that_report_it():
    """Each metric's workloads are exactly the cells whose runs report it:
    the cell's own end-to-end metric and peak memory, the kernel metrics of
    its kernel families, the host layer times of the batch cells, the busy
    share and the build everywhere."""
    doc = index()
    cells = {w["name"]: run.load_cell(w["name"]) for w in doc["workloads"]}
    for m, d in doc["metrics"].items():
        assert d["workloads"] == [n for n, c in cells.items() if reports(doc, c, m)], m
        assert not set(WAITING) & set(d["workloads"]), m
    assert "engine_seconds" not in doc["metrics"]
    assert {f"host_seconds.{p}" for p in ("encode", "engine", "strings", "output")} <= \
        set(doc["metrics"])


def test_four_card_cell_loads_and_lists_four_cards(monkeypatch):
    import torch

    cell = run.load_cell("batch-mix40k-4card")
    # its own file gives its cards: it is not in BENCHMARK.json
    assert "batch-mix40k-4card" not in run.cell_names()
    assert cell["chips"] == 4 and cell["verb"] == "batch" and cell["config"]["model"] == "mar-mg"
    assert cell["traffic"]["pairs"] == 40000 and cell["check"] == {"every": 8}
    assert cell["traffic"]["length_mix"] == run.load_cell("batch-mix10k")["traffic"]["length_mix"]
    assert run.cards(cell, "cpu") == ["cpu"] * 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "init", lambda: None)
    assert run.cards(cell, "cuda") == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert run.cards(run.load_cell("batch-mix10k"), "cuda") == ["cuda:0"]
    assert run.on_card(["cuda:0", "cuda:3"]) == [0, 3] and run.on_card(["cpu"] * 4) == []
    # the first 10,000 pairs are batch-mix10k's
    small = {"pairs": 50, "length_mix": cell["traffic"]["length_mix"]}
    assert cell_pairs(small, SEED)[:20] == cell_pairs({**small, "pairs": 20}, SEED)


def test_a_cell_asking_for_more_cards_than_exist_fails(monkeypatch, capsys):
    import torch

    cell = run.load_cell("batch-mix40k-4card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(RuntimeError, match="takes 4 cards and 3 are visible"):
        run.cards(cell, "cuda")
    # the cell stops before any pair is made or any call runs
    monkeypatch.setattr(run, "cell_pairs", lambda *a: pytest.fail("ran on fewer cards"))
    with pytest.raises(RuntimeError, match="does not run on fewer"):
        run.run_cell(cell, SEED, "cuda", repeats=1, log=lambda _: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert run.main(["batch-mix40k-4card"]) == 2
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["correct"] is False and "takes 4 cards" in last["error"]


def test_peak_and_busy_share_over_several_cards():
    peaks = [[700.0, 733.5, 720.0, 710.0],  # a repeat: each card's peak MiB
             [701.0, 730.0, 733.625, 712.0],
             [699.0, 731.0, 733.0, 715.0]]
    st, by_card = run.peak_stats(peaks)
    assert st["value"] == st["max"] == 733.625  # the largest card's, in any repeat
    assert st["min"] == 733.0 and st["median"] == 733.5 and st["n"] == 3
    assert by_card == [701.0, 733.5, 733.625, 715.0]
    # 100 ms of kernels over four cards and a median wall of 2 s
    assert run.busy_share(100.0, [1.0, 2.0, 4.0], 4) == pytest.approx(1.25)
    assert run.busy_share(100.0, [1.0, 2.0, 4.0], 1) == pytest.approx(5.0)


def test_host_load_from_made_up_clocks():
    said = run.host_load((10.0, 3.0), (12.0, 4.5))  # 1.5 s of CPU over 2 s of wall
    assert said.startswith("CPU 1.5 s of this process over 2 s of wall (75.0%), ")
    assert said.endswith(" threads")
    wall, cpu = run.host_clock()
    sum(i * i for i in range(200_000))
    assert run.host_clock()[0] > wall and run.host_clock()[1] >= cpu


NAMES = run.PROGRAM_RANGES | {"encode", "engine", "read", "align", "write"}


def _span(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1,
            "args": args}


def test_breakdown_names_each_gap_by_the_host_range_open():
    """A window of 100 us: engine (10-60) holds ops_to_strings (40-55),
    then encode (60-70); write (80-95) and read (90-100) overlap, read the
    later begun. Card 0 runs the fill (5-40), a copy (45-50) and one of
    PyTorch's kernels (70-92), then one that takes no time; card 1 runs
    nothing."""
    events = [
        _span("user_annotation", run.WINDOW, 0, 100),
        _span("user_annotation", "aten::something", 0, 100),  # not a layer's range
        _span("user_annotation", "engine", 10, 50),
        _span("user_annotation", "ops_to_strings", 40, 15),
        _span("user_annotation", "encode", 60, 10),
        _span("user_annotation", "write", 80, 15),
        _span("user_annotation", "read", 90, 10),
        _span("kernel", "void strip_fill_kernel<1, 8, true>(FillArgs)", 5, 35, device=0),
        _span("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 45, 5, device=0),
        _span("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)", 70, 22,
              device=0),
        _span("kernel", "void at::native::(anonymous namespace)::distribution_kernel<4>(int)",
              92, 0, device=0),
        {"ph": "i", "name": "Record Window End", "ts": 101},
    ]
    brk = run.Breakdown("output", NAMES)
    brk.add(events, [0])
    # gaps of card 0: 0-5 under no range, 40-45 and 50-70 begun under
    # ops_to_strings, 92-100 under read
    assert sorted(brk.gaps) == [(5, "ops_to_strings", 0, 40), (5, "output", 0, 0),
                                (8, "read", 0, 92), (20, "ops_to_strings", 0, 50)]
    assert brk.longest(1) == [[0.02, "ops_to_strings", 0, 0.05]]
    assert brk.busy == {0: 57.0}
    rec = brk.record(top=3)
    assert rec["window_ms"] == 0.1
    assert rec["ops"] == [["fill", 0.035, 1], ["vectorized_elementwise_kernel", 0.022, 1],
                          ["Memcpy DtoH", 0.005, 1]]
    assert brk.ops["distribution_kernel"] == [1, 0.0]
    assert rec["gaps"] == [[0.02, "ops_to_strings", 0], [0.008, "read", 0],
                           [0.005, "output", 0]]
    assert set(rec) == {"window_ms", "ops", "gaps"}
    # a card with no operation is idle the whole window, begun under no range
    idle = run.Breakdown("output", NAMES)
    idle.add(events, [0, 1])
    assert sorted(idle.gaps) == sorted(brk.gaps + [(100, "output", 1, 0)])
    # two ranges begun together: the shorter is the inner
    tie = run.Breakdown("output", NAMES)
    tie.add([_span("user_annotation", run.WINDOW, 0, 100),
             _span("user_annotation", "engine", 60, 30),
             _span("user_annotation", "ops_to_strings", 60, 10),
             _span("kernel", "void strip_fill_kernel<1, 8, true>(FillArgs)", 0, 60, device=0)],
            [0])
    assert tie.gaps == [(40, "ops_to_strings", 0, 60)]
    # the last line keeps its size whatever the names
    many = run.Breakdown("output", NAMES)
    many.ops = {f"{'k' * 31}{i}": [1000, 1e6 + i] for i in range(12)}
    many.gaps = [(1e5 + i, "triplet_align_batch", 3, 1e6) for i in range(12)]
    assert len(json.dumps(many.record(), separators=(",", ":"))) < 600


@pytest.mark.parametrize("name", ["batch-mix10k", "batch-tri-mg-exons", "batch-mix40k-4card"])
def test_host_seconds_of_a_tiny_batch_cell(name, tmp_path):
    cell = tiny_cell(name)
    on = run.cards(cell, "cpu")
    calls = run.calls_of(cell, cell_pairs(cell["traffic"], SEED), SEED, on, tmp_path)
    want = run.repeat(calls, on)[2]  # warm
    parts, wall = run.host_seconds(calls, on)
    assert set(parts) == {"encode", "engine", "strings", "output"}
    assert all(v >= 0 for v in parts.values()) and wall > 0
    assert parts["encode"] + parts["engine"] + parts["output"] == pytest.approx(wall, rel=1e-12)
    assert 0 < parts["strings"] <= parts["engine"] and parts["encode"] > 0
    # the stand-ins are gone and changed nothing
    from coati_tpu_torch import batchrun, native
    from coati_tpu_torch.align import engine

    assert batchrun.encode_marginal_chunk.__module__ == "coati_tpu_torch.batchrun"
    assert not hasattr(engine.viterbi_align_batch, "__wrapped__")
    assert not hasattr(native.ops_to_strings_native, "__wrapped__")
    assert run.repeat(calls, on)[2] == want


def test_harness_imports_nothing_of_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|coati_tpu|bench|coati_tpu_torch\.bench)\b"
                     r"|coati_tpu_torch\s+import\s+.*\bbench\b", re.M)
    for path in sorted((REPO / "benchmark").glob("*.py")):
        assert not pat.search(path.read_text()), path
    code = ("import sys; sys.argv = ['run.py']; import benchmark.run; "
            "import coati_tpu_torch.cli, coati_tpu_torch.batchrun; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'coati_tpu', 'bench')"
            " or m == 'coati_tpu_torch.bench']; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("stub", [None, "jax", "coati_tpu"])
def test_a_run_that_imported_jax_gives_no_result(stub):
    """main() exits 2 with an error and correct false, not the record, when
    JAX or the JAX package is in sys.modules at the end of a cell's run (a
    stub module here; the cell's run stood in for by a made-up record)."""
    code = ("import sys, types, json; from benchmark import run; "
            "run.torch.cuda.is_available = lambda: True; "
            "run.run_cell = lambda *a: {'cell': 'batch-mix10k', 'correct': True}; "
            f"stub = {stub!r}; "
            "sys.modules.update({stub: types.ModuleType(stub)} if stub else {}); "
            "sys.exit(run.main(['batch-mix10k']))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    last = json.loads(res.stdout.splitlines()[-1])
    if stub is None:
        assert res.returncode == 0 and last == {"cell": "batch-mix10k", "correct": True}
    else:
        assert res.returncode == 2, res.stdout + res.stderr
        assert last["correct"] is False and f"imported: ['{stub}']" in last["error"]


def test_without_a_card_it_exits_non_zero_and_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert run.main(["batch-mix10k"]) == 2
    assert capsys.readouterr().out == ""
