"""Device selection (counterpart of coati_tpu.align.engine._devices_for).

One device per call. Asking for CUDA where there is none is an error: no
code path moves to the CPU on its own.
"""

from __future__ import annotations

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
