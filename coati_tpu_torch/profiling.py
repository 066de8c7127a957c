"""Profiling and throughput accounting (counterpart of coati_tpu/profiling.py).

trace() captures a torch.profiler trace of the host (every Python function,
as a JAX trace shows the host) and, on a card, of the device's kernels and
copies, viewable in TensorBoard or Perfetto; the readers below sum it by
kernel and by host function. ThroughputMeter is a running cells/sec and
alignments/sec meter used by the batch verb. KernelTimer is the one reader
of device time over a run, through the table of kernel wrappers (WRAPPERS)
and their launch counters: chip_smoke.py and the bench both time with it.
"""

from __future__ import annotations

import collections
import contextlib
import json
import time
from pathlib import Path

import torch

from coati_tpu_torch.kernels import (
    sample_walk,
    traceback_walk,
    triplet_rows,
    triplet_walk,
    wavefront_fill,
    wavefront_forward,
    wavefront_score,
    wavefront_segment,
)


def on_card(device) -> bool:
    """Whether `device` (a name or a torch.device, or a list of them) names
    a card."""
    items = device if isinstance(device, (list, tuple)) else [device]
    return any(torch.device(d).type == "cuda" for d in items)


@contextlib.contextmanager
def trace(log_dir: str | None, device="cuda"):
    """Capture a torch.profiler trace into `log_dir` if a directory is
    given; no-op otherwise.

    CPU activity always, with Python function events (with_stack), and CUDA
    activity when `device` names a card. The trace goes through
    tensorboard_trace_handler, one file a process
    ({host}_{pid}.{stamp}.pt.trace.json), as jax.profiler writes one a host.
    On a card the trace must hold the card's activity: a profiler that
    recorded none (no CUPTI) raises RuntimeError once the block is done."""
    if not log_dir:
        yield
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    card = on_card(device)
    if card and not torch.cuda.is_available():
        raise RuntimeError("a trace of the card asked for, but CUDA is not available")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    write = tensorboard_trace_handler(str(log_dir))
    device_events = []

    def ready(prof):
        write(prof)
        device_events.append(sum(
            e.device_type() == DeviceType.CUDA
            for e in prof.profiler.kineto_results.events()))

    with profile(activities=activities, with_stack=True, on_trace_ready=ready):
        yield
        if card:
            torch.cuda.synchronize()
    if card and not (device_events and device_events[0]):
        raise RuntimeError(
            f"the trace in {log_dir} recorded no activity of the card: the "
            "profiler could not trace it (CUPTI)")


def trace_files(log_dir) -> list[Path]:
    """The trace files in `log_dir`, oldest first."""
    return sorted(Path(log_dir).glob("*.pt.trace.json"), key=lambda p: p.stat().st_mtime)


def load_trace(path) -> list[dict]:
    """The events of one trace file."""
    with open(path) as f:
        return json.load(f)["traceEvents"]


def kernel_totals(events) -> dict[str, tuple[int, float]]:
    """{kernel name: (launches, summed microseconds)} over the events of
    category "kernel" (the card's kernels)."""
    out: dict[str, list] = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("cat") == "kernel":
            out[e["name"]][0] += 1
            out[e["name"]][1] += float(e.get("dur", 0.0))
    return {name: (n, us) for name, (n, us) in out.items()}


def host_self_times(events) -> list[tuple[str, float, int]]:
    """[(Python function, self microseconds, calls)], largest first: each
    python_function event's duration less its direct children's (linked by
    the trace's "Python id" and "Python parent id"), summed by name, so
    time spent in native code (numpy, aten, a launch) counts to the
    function that called it."""
    funcs = [e for e in events if e.get("cat") == "python_function"]
    child_us: dict[int, float] = collections.defaultdict(float)
    for e in funcs:
        parent = e.get("args", {}).get("Python parent id")
        if parent is not None:
            child_us[parent] += float(e.get("dur", 0.0))
    self_us: dict[str, float] = collections.defaultdict(float)
    calls: dict[str, int] = collections.defaultdict(int)
    for e in funcs:
        pid = e.get("args", {}).get("Python id")
        self_us[e["name"]] += float(e.get("dur", 0.0)) - child_us.get(pid, 0.0)
        calls[e["name"]] += 1
    return sorted(((n, us, calls[n]) for n, us in self_us.items()),
                  key=lambda x: -x[1])


def range_totals(events) -> dict[str, tuple[int, float]]:
    """{record_function name: (calls, summed microseconds)} over the host's
    user_annotation events."""
    out: dict[str, list] = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("cat") == "user_annotation":
            out[e["name"]][0] += 1
            out[e["name"]][1] += float(e.get("dur", 0.0))
    return {name: (n, us) for name, (n, us) in out.items()}


class ThroughputMeter:
    """Accumulates (cells, pairs, seconds) across kernel calls."""

    def __init__(self) -> None:
        self.cells = 0
        self.pairs = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def measure(self, cells: int, pairs: int):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds += time.perf_counter() - t0
            self.cells += cells
            self.pairs += pairs

    @property
    def cells_per_sec(self) -> float:
        return self.cells / self.seconds if self.seconds else 0.0

    @property
    def pairs_per_sec(self) -> float:
        return self.pairs / self.seconds if self.seconds else 0.0

    def summary(self) -> dict:
        return {
            "cells": self.cells,
            "pairs": self.pairs,
            "seconds": round(self.seconds, 3),
            "cells_per_sec": round(self.cells_per_sec, 0),
            "pairs_per_sec": round(self.pairs_per_sec, 2),
        }


# the kernel wrappers the engine, the long-pair path, sampling and the
# triplet path call, by name: (module, attribute), and the module attribute
# that counts each one's kernel launches
WRAPPERS = {
    "wavefront_fill": (wavefront_fill, "wavefront_fill"),
    "traceback_walk": (traceback_walk, "traceback_walk"),
    "wavefront_segment": (wavefront_segment, "wavefront_segment"),
    "wavefront_score": (wavefront_score, "wavefront_score"),
    "traceback_walk_segment": (traceback_walk, "walk_segment"),
    "wavefront_score_ckpt": (wavefront_score, "wavefront_score_ckpt"),
    "wavefront_fill_band": (wavefront_fill, "wavefront_fill_band"),
    "traceback_walk_band": (traceback_walk, "walk_band"),
    "wavefront_forward": (wavefront_forward, "wavefront_forward"),
    "sample_walk": (sample_walk, "sample_walk"),
    "triplet_rows": (triplet_rows, "triplet_rows"),
    "triplet_walk": (triplet_walk, "triplet_walk"),
}
# a module's counter is LAUNCHES unless it holds several wrappers
_COUNTER_ATTR = {"traceback_walk_segment": "SEGMENT_LAUNCHES",
                 "wavefront_score_ckpt": "CKPT_LAUNCHES",
                 "wavefront_fill_band": "BAND_LAUNCHES",
                 "traceback_walk_band": "BAND_LAUNCHES"}
COUNTERS = {name: (mod, _COUNTER_ATTR.get(name, "LAUNCHES"))
            for name, (mod, _) in WRAPPERS.items()}


def launch_counts() -> dict[str, int]:
    """{wrapper name: kernel launches counted since the last reset}."""
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


@contextlib.contextmanager
def swapped(standins):
    """Stand functions in for the kernel wrappers of those names."""
    orig = {name: getattr(*WRAPPERS[name]) for name in standins}
    for name, fn in standins.items():
        setattr(*WRAPPERS[name], fn)
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(*WRAPPERS[name], fn)


class KernelTimer:
    """Times every kernel wrapper call of one run: CUDA events on the stream
    the wrapper launches on (a lane's own stream inside Lane.context()), or,
    on the CPU, where the wrappers run their plain versions, the host clock.
    Calls are kept by wrapper name; the segment kernel's apart by pass,
    "segment_pass1" without backpointers and "segment_bp" with. Each call is
    also counted to its chunk: the shape (NA, NB, B) of the last fill
    launched before it, so the walk goes with its fill."""

    def __init__(self, dev):
        self.dev = torch.device(dev)
        self.events = {}  # name: [(start, end)], CUDA events or host seconds
        self.chunks = {}  # (NA, NB, B): [fills, [(start, end)]]
        self.padded_cells = 0  # of the fill
        self.wall = 0.0  # seconds of the timed run, set by the caller
        self._chunk = None
        self._swap = None

    def _stamp(self):
        if self.dev.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _wrap(self, name, fn):
        def timed(*args, **kw):
            start = self._stamp()
            out = fn(*args, **kw)
            span = (start, self._stamp())
            key = name
            if name == "wavefront_segment":
                key = "segment_bp" if kw["want_bp"] else "segment_pass1"
            self.events.setdefault(key, []).append(span)
            if name == "wavefront_fill":
                (B, NA), NB = args[0].shape, args[1].shape[1]
                self.padded_cells += B * (NA + kw["k"]) * (NB + kw["k"])
                self._chunk = (NA, NB, B)
                self.chunks.setdefault(self._chunk, [0, []])[0] += 1
            if self._chunk is not None:
                self.chunks[self._chunk][1].append(span)
            return out
        return timed

    def __enter__(self):
        self._swap = swapped({name: self._wrap(name, getattr(*WRAPPERS[name]))
                              for name in WRAPPERS})
        self._swap.__enter__()
        return self

    def __exit__(self, *exc):
        self._swap.__exit__(*exc)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    @staticmethod
    def _seconds(spans):
        return sum(e - s if isinstance(s, float) else s.elapsed_time(e) / 1e3
                   for s, e in spans)

    def count(self, name):
        return len(self.events.get(name, []))

    def seconds(self, name=None):
        """Summed seconds of the calls of `name`, or of every call."""
        names = self.events if name is None else [name]
        return sum(self._seconds(self.events.get(n, [])) for n in names)

    def chunk_seconds(self) -> dict:
        """{(NA, NB, B): (chunks, summed seconds of their calls)}."""
        return {shape: (n, self._seconds(spans))
                for shape, (n, spans) in self.chunks.items()}
