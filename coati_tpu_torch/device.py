"""Device selection (counterpart of coati_tpu.align.engine._devices_for).

resolve_device gives one device; resolve_devices a list of lanes, the queues
the engine spreads its chunks over: each a device and, where several lanes
run on cards, a CUDA stream of its own. A list may name a device more than
once, so two lanes can share one card (two streams) or the CPU (two turns).
Asking for CUDA where there is none is an error: no code path moves to the
CPU on its own. Also the copies between host and device that the engine
overlaps with its kernels.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """The torch.device for `name` ("cuda", "cuda:N" or "cpu").

    Raises RuntimeError when CUDA is asked for and torch.cuda.is_available()
    is False."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(name)!r} requested but CUDA is not available; "
            "pass --device cpu (device='cpu') to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(name)!r}")
    return dev


class Lane:
    """One queue of work: a device and, on a card when a run has several
    lanes, a CUDA stream of its own (None: the device's current stream).
    `chunks` counts the chunks and long-pair groups the engine has enqueued
    on it."""

    __slots__ = ("device", "stream", "chunks")

    def __init__(self, device: torch.device, stream=None):
        self.device = device
        self.stream = stream
        self.chunks = 0

    def __repr__(self) -> str:
        return f"Lane({self.device}, stream={'own' if self.stream else 'current'})"

    def context(self):
        """Make this lane's card and stream current for the work enqueued
        inside (every kernel wrapper launches on the current stream)."""
        if self.stream is not None:
            return torch.cuda.stream(self.stream)
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def share(self, *tensors) -> None:
        """Order this lane's stream after what the current stream of its
        device has enqueued so far, and mark `tensors`, written there, as in
        use by the lane, so that the caching allocator does not hand their
        memory out again before the lane's work on them is done."""
        if self.stream is None:
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        for t in tensors:
            t.record_stream(self.stream)


def resolve_devices(spec="cuda") -> list[Lane]:
    """The lanes for `spec`: a name or torch.device, a list of them, or a
    list of Lanes (returned as they are, so their streams and counts carry
    over between calls).

    "cuda" means every local card, capped by COATI_TPU_MAX_DEVICES as the
    JAX package caps its devices; "cuda:N" that card; "cpu" one CPU lane.
    Each entry of a list is a lane of its own, a repeated one too. One lane
    runs on its device's current stream; with several, each lane on a card
    gets a stream of its own. Raises as resolve_device does."""
    if isinstance(spec, Lane):
        return [spec]
    items = [spec] if isinstance(spec, (str, torch.device)) else list(spec)
    if items and all(isinstance(x, Lane) for x in items):
        return items
    devs = []
    for item in items:
        if isinstance(item, Lane):
            raise TypeError("give lanes or device names, not both")
        dev = resolve_device(item)
        if dev.type == "cuda" and dev.index is None:
            n = torch.cuda.device_count()
            cap = int(os.environ.get("COATI_TPU_MAX_DEVICES", "0"))
            devs += [torch.device("cuda", q) for q in range(min(n, cap) if cap > 0 else n)]
        else:
            devs.append(dev)
    if not devs:
        raise ValueError("no device given")
    if len(devs) == 1:
        return [Lane(devs[0])]
    return [Lane(d, torch.cuda.Stream(device=d) if d.type == "cuda" else None)
            for d in devs]


def upload(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """x as a tensor on dev; to a card through pinned memory, without
    waiting for the copy."""
    t = torch.from_numpy(x)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def download(*tensors):
    """Start the device->host copies; returns (host tensors, event that
    completes after the last copy, or None on the CPU)."""
    if tensors[0].device.type != "cuda":
        return tensors, None
    with torch.profiler.record_function("download"):
        hosts = []
        for t in tensors:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            hosts.append(host)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(tensors[0].device))
        return hosts, ev
