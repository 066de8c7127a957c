"""Wrapper of the traceback walk kernel (csrc/traceback_walk.cu).

Counterpart of coati_tpu/align/wavefront.py traceback_ops_impl. CPU tensors
take the plain PyTorch version (align/wavefront.py traceback_plain); CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from coati_tpu_torch.align.wavefront import traceback_plain
from coati_tpu_torch.kernels import _build

LAUNCHES = 0  # kernel launches made by traceback_walk


def _check(bp, corners, lens_a, lens_b):
    B = lens_a.shape[0]
    if bp.dtype != torch.uint8 or bp.dim() != 3 or bp.shape[0] != B:
        raise ValueError(f"bp must be [B, Dtot, C] uint8, got {tuple(bp.shape)} {bp.dtype}")
    for name, t, want in (("cM", corners[0], torch.float32),
                          ("cD", corners[1], torch.float32),
                          ("cI", corners[2], torch.float32),
                          ("lens_a", lens_a, torch.int32),
                          ("lens_b", lens_b, torch.int32)):
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be [{B}], got {tuple(t.shape)}")
        if t.device != bp.device:
            raise ValueError(f"{name} is on {t.device}, bp on {bp.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not bp.is_contiguous():
        raise ValueError("bp must be contiguous")


def traceback_walk(bp, corners, lens_a, lens_b, *, k: int, max_steps: int):
    """Backward walk: (ops [max_steps, B] int8, score [B] f32) as
    traceback_plain returns them. max_steps >= max(la + lb) holds every walk
    (a walk makes at most one op per consumed residue)."""
    global LAUNCHES
    _check(bp, corners, lens_a, lens_b)
    if bp.device.type == "cpu":
        return traceback_plain(bp, corners, lens_a, lens_b, k=k, max_steps=max_steps)
    if bp.device.type != "cuda":
        raise ValueError(f"unsupported device {bp.device}")
    B, Dtot, C = bp.shape
    ops = torch.empty((max_steps, B), dtype=torch.int8, device=bp.device)
    score = torch.empty((B,), dtype=torch.float32, device=bp.device)
    lib = _build.load()
    with torch.cuda.device(bp.device):
        stream = torch.cuda.current_stream(bp.device).cuda_stream
        rc = lib.coati_traceback_walk(
            bp.data_ptr(), corners[0].data_ptr(), corners[1].data_ptr(),
            corners[2].data_ptr(), lens_a.data_ptr(), lens_b.data_ptr(),
            ops.data_ptr(), score.data_ptr(), B, Dtot, C, k, max_steps, stream,
        )
    _build.check(rc, "traceback_walk")
    LAUNCHES += 1
    return ops, score
