"""Wrapper of the sample walk kernel (csrc/sample_walk.cu).

Counterpart of coati_tpu/align/sample_device.py _sample_paths: N stochastic
tracebacks over one pair's Forward matrices, the uniforms supplied by the
caller. CPU tensors take the plain PyTorch version
(align/sample_device.py sample_paths_plain); CUDA tensors launch the kernel
or raise.
"""

from __future__ import annotations

import torch

from coati_tpu_torch.align.sample_device import sample_paths_plain
from coati_tpu_torch.kernels import _build

LAUNCHES = 0  # kernel launches made by sample_walk


def _check(mdi, enc_a, enc_b, table, gap_consts, uniforms, k):
    named = {"mdi": mdi, "enc_a": enc_a, "enc_b": enc_b, "table": table,
             "gap_consts": gap_consts, "uniforms": uniforms}
    dev = mdi.device
    for name, t in named.items():
        want = torch.int32 if name in ("enc_a", "enc_b") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, mdi on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mdi.dim() != 3 or mdi.shape[2] != 3:
        raise ValueError(f"mdi must be [R, Cc, 3], got {tuple(mdi.shape)}")
    R, Cc = mdi.shape[:2]
    if tuple(enc_a.shape) != (R - k,) or tuple(enc_b.shape) != (Cc - k,):
        raise ValueError(
            f"enc_a, enc_b must be [{R - k}] and [{Cc - k}] for mdi "
            f"{tuple(mdi.shape)} and k = {k}, got {tuple(enc_a.shape)}, "
            f"{tuple(enc_b.shape)}")
    n_steps = (R - k) + (Cc - k)
    if uniforms.dim() != 2 or uniforms.shape[0] != n_steps + 1:
        raise ValueError(
            f"uniforms must be [{n_steps + 1}, N], got {tuple(uniforms.shape)}")
    if table.dim() != 2 or table.shape[1] != 15 or tuple(gap_consts.shape) != (4,):
        raise ValueError("table must be [rows, 15] and gap_consts [4]")


def sample_walk(mdi, enc_a, enc_b, table, gap_consts, uniforms, *, k: int):
    """N = uniforms.shape[1] stochastic tracebacks from the corner of mdi
    [R, Cc, 3] (one pair's Forward matrices, the terminal-adjusted corner
    written at [R-1, Cc-1]). uniforms [n_steps + 1, N] f32 in [0, 1): row 0
    the corner draw, row t + 1 step t, n_steps = (R-k) + (Cc-k). Returns
    (ops [n_steps, N] int8 in walk order, 0 = match, 1 = delete, 2 = insert,
    -1 after a walk's end; scores [N] f32, each path's log probability)."""
    global LAUNCHES
    _check(mdi, enc_a, enc_b, table, gap_consts, uniforms, k)
    dev = mdi.device
    if dev.type == "cpu":
        return sample_paths_plain(mdi, enc_a, enc_b, table, gap_consts,
                                  uniforms, k=k)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    R, Cc = mdi.shape[:2]
    n_steps, N = uniforms.shape[0] - 1, uniforms.shape[1]
    ops = torch.full((n_steps, N), -1, dtype=torch.int8, device=dev)
    scores = torch.empty((N,), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.coati_sample_walk(
            mdi.data_ptr(), enc_a.data_ptr(), enc_b.data_ptr(),
            table.data_ptr(), gap_consts.data_ptr(), uniforms.data_ptr(),
            ops.data_ptr(), scores.data_ptr(), R, Cc, k, N, n_steps, stream)
    _build.check(rc, "sample_walk")
    LAUNCHES += 1
    return ops, scores
