"""What the tools share: the device they run on, named as every number
written down names it, and the timers."""

from __future__ import annotations

import subprocess
import time

import torch

from coati_tpu_torch.device import resolve_device


def device_and_label(name: str) -> tuple[torch.device, str]:
    """The torch.device for `name` (cuda where there is none raises) and its
    label: nvidia-smi's card name and power limit on a card, "cpu" else."""
    dev = resolve_device(name)
    if dev.type != "cuda":
        return dev, "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(index)],
        capture_output=True, text=True, timeout=60, check=True)
    return dev, smi.stdout.strip().splitlines()[0].strip()


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def elapsed_ms(fn, dev: torch.device, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` calls after one warm-up: CUDA
    events around the calls on a card, the host clock on the CPU."""
    fn()
    sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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


def wall_s(fn, dev: torch.device):
    """(seconds, result) of one call of fn() on the host clock, the device
    synchronised before and after."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return time.perf_counter() - t0, out
