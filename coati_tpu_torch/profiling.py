"""Throughput accounting (counterpart of coati_tpu/profiling.py).

A running cells/sec and alignments/sec meter used by the batch verb. Device
tracing is not ported yet.
"""

from __future__ import annotations

import contextlib
import time


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
