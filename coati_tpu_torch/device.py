"""Device selection (counterpart of coati_tpu.align.engine._devices_for).

One device per call. Asking for CUDA where there is none is an error: no
code path moves to the CPU on its own. Also the copies between host and
device that the engine overlaps with its kernels.
"""

from __future__ import annotations

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
    hosts = []
    for t in tensors:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        hosts.append(host)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(tensors[0].device))
    return hosts, ev
