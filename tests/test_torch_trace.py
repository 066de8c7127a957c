"""The port's trace (profiling.trace, batch --trace-dir) and the cards a
--multihost process owns (multihost.local_devices), on the CPU.

On the CPU the trace holds the host alone; chip_smoke.py's trace phase holds
the card's kernels in it to the launches and times CUDA events see."""

from __future__ import annotations

import json

import pytest
import torch

from coati_tpu_torch import batchrun, cli, profiling
from coati_tpu_torch.parallel import multihost

PAIRS = (
    ">a0\nATGAAACCCGGGTTTTAA\n>d0\nATGAAACCGGGTTTTAA\n"
    ">a1\nATGCTCTGGATAGTGCCC\n>d1\nATGCTATAGTGCNC\n"
    ">a2\nATGGGGCCCAAATTTGGGCCC\n>d2\nATGGGGCCCAAAGGGTTTGGGCCC\n"
    ">a3\nATGXXX\n>d3\nATG\n"
)


@pytest.mark.parametrize("model", ["mar-mg", "tri-mg"])
def test_batch_trace_dir_writes_one_trace_and_the_same_bytes(tmp_path, model):
    """batch --trace-dir on the CPU: one trace file that parses, with the
    host's Python functions and the engine's ranges, and output bytes equal
    to the same batch without the trace."""
    src = tmp_path / "pairs.fasta"
    src.write_text(PAIRS)
    argv = ["batch", str(src), "-m", model, "--device", "cpu"]
    assert cli.main(argv + ["-o", str(tmp_path / "plain.jsonl")]) == 0
    assert cli.main(argv + ["-o", str(tmp_path / "traced.jsonl"),
                            "--trace-dir", str(tmp_path / "trace")]) == 0
    assert (tmp_path / "traced.jsonl").read_bytes() == (tmp_path / "plain.jsonl").read_bytes()
    files = profiling.trace_files(tmp_path / "trace")
    assert len(files) == 1
    events = profiling.load_trace(files[0])
    host = profiling.host_self_times(events)
    assert host and all(us >= -1.0 and n >= 1 for _, us, n in host)
    assert any("batch_align" in name for name, _, _ in host)
    ranges = profiling.range_totals(events)
    want = {"fused_align_ops", "traceback_walk", "ops_to_strings"} if model == "mar-mg" \
        else {"triplet_align_batch"}
    assert want <= set(ranges)
    assert profiling.kernel_totals(events) == {}  # the CPU has no kernels


def test_trace_without_a_directory_is_a_no_op(tmp_path):
    with profiling.trace(None, "cuda"):
        x = torch.ones(3) + 1
    with profiling.trace("", "cpu"):
        x = x + 1
    assert float(x.sum()) == 9.0
    assert list(tmp_path.iterdir()) == []


def test_trace_of_a_card_where_there_is_none_raises(tmp_path, monkeypatch):
    """A trace asked for on a card records the card or fails: with no CUDA
    it does not fall back to a host-only trace."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with profiling.trace(str(tmp_path / "t"), "cuda"):
            pass
    assert profiling.on_card(["cpu", "cuda:1"]) and not profiling.on_card("cpu")


def test_host_self_times_subtract_children():
    """Self time is a function's duration less its direct children's, summed
    by name."""
    ev = [
        {"cat": "python_function", "name": "f", "dur": 10.0,
         "args": {"Python id": 1, "Python parent id": None}},
        {"cat": "python_function", "name": "g", "dur": 4.0,
         "args": {"Python id": 2, "Python parent id": 1}},
        {"cat": "python_function", "name": "g", "dur": 3.0,
         "args": {"Python id": 3, "Python parent id": 1}},
        {"cat": "python_function", "name": "h", "dur": 1.0,
         "args": {"Python id": 4, "Python parent id": 2}},
        {"cat": "kernel", "name": "k", "dur": 2.5},
        {"cat": "kernel", "name": "k", "dur": 0.5},
        {"cat": "user_annotation", "name": "r", "dur": 6.0},
    ]
    assert profiling.host_self_times(ev) == [("g", 6.0, 2), ("f", 3.0, 1), ("h", 1.0, 1)]
    assert profiling.kernel_totals(ev) == {"k": (2, 3.0)}
    assert profiling.range_totals(ev) == {"r": (1, 6.0)}


@pytest.fixture
def four_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "COATI_TPU_MAX_DEVICES"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("env,want", [
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, ["cuda:1", "cuda:3"]),
    ({"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "2"}, ["cuda:0", "cuda:2"]),
    ({}, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    ({"COATI_TPU_MAX_DEVICES": "2"}, ["cuda:0", "cuda:1"]),
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2", "COATI_TPU_MAX_DEVICES": "1"},
     ["cuda:1"]),
    ({"LOCAL_RANK": "5", "LOCAL_WORLD_SIZE": "8"}, ["cuda:1"]),
    ({"LOCAL_RANK": "1"}, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
])
def test_local_devices(four_cards, env, want):
    """A process's cards under torchrun's LOCAL_RANK and LOCAL_WORLD_SIZE
    (both needed), every card without them, COATI_TPU_MAX_DEVICES capping
    either; with more processes than cards a process shares card r % 4."""
    for var, value in env.items():
        four_cards.setenv(var, value)
    assert multihost.local_devices() == want


def test_no_card_no_local_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert multihost.local_devices() == []


@pytest.mark.parametrize("multi,want", [(True, ["cuda:1", "cuda:3"]), (False, "cuda")])
def test_batch_multihost_runs_on_the_process_cards(four_cards, tmp_path, multi, want):
    """batch --multihost --device cuda aligns on multihost.local_devices();
    without --multihost, on "cuda" (every card) as before."""
    four_cards.setenv("LOCAL_RANK", "1")
    four_cards.setenv("LOCAL_WORLD_SIZE", "2")
    seen = []

    def fake_batch_align(aln, pairs, out, **kw):
        seen.append(kw["device"])
        return 0

    four_cards.setattr(batchrun, "batch_align", fake_batch_align)
    src = tmp_path / "pairs.fasta"
    src.write_text(PAIRS)
    out = tmp_path / "out.jsonl"
    argv = ["batch", str(src), "-o", str(out)] + (["--multihost"] if multi else [])
    assert cli.main(argv) == 0
    assert seen == [want]
    if multi:
        assert json.loads((tmp_path / "out.jsonl.scores.json").read_text())["n_pairs"] == 4
