"""Wrapper of the score-only Viterbi kernel (csrc/wavefront_segment.cu,
entry point coati_wavefront_score).

Counterpart of coati_tpu/kernels/wavefront_pallas.py wavefront_pallas with
want_bp=False: the corner scores of every pair with O(diagonal) state and
no backpointers. CPU tensors take the plain PyTorch version (score_plain,
align/wavefront.py wavefront_plain in score mode); CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import torch

from coati_tpu_torch.align.wavefront import wavefront_plain
from coati_tpu_torch.kernels import _build
from coati_tpu_torch.kernels.wavefront_fill import _check
from coati_tpu_torch.kernels.wavefront_segment import (
    SweepLaunch,
    ptr,
    sweep_launch,
    sweep_shape,
)

LAUNCHES = 0  # kernel launches made by wavefront_score


def score_plain(aseq, bseq, lens_a, lens_b, table, gap_consts, *, k: int):
    """Plain version of wavefront_score: corners [3, B] f32."""
    adj, _ = wavefront_plain(aseq, bseq, lens_a, lens_b, table, gap_consts,
                             k=k, mode="score")
    return torch.stack(adj)


def wavefront_score(aseq, bseq, lens_a, lens_b, table, gap_consts, *, k: int,
                    launch: SweepLaunch | None = None):
    """Score-only Viterbi: the terminal-adjusted corners (cM, cD, cI) as one
    [3, B] f32 tensor; a pair's score is their maximum. launch: how to
    launch the kernel (wavefront_segment.sweep_launch), by default
    sweep_shape's. Preconditions as wavefront_fill's."""
    global LAUNCHES
    _check(aseq, bseq, lens_a, lens_b, table, gap_consts)
    dev = aseq.device
    if dev.type == "cpu":
        return score_plain(aseq, bseq, lens_a, lens_b, table, gap_consts, k=k)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, NA = aseq.shape
    NB = bseq.shape[1]
    C = NB + k
    adj = torch.empty((3, B), dtype=torch.float32, device=dev)
    if launch is None:
        launch = sweep_launch(B, C, k, *sweep_shape(B, C, dev), table.numel())
    launch.check(B, C, k, table.numel())
    scratch = launch.buffers(dev)  # held until the kernel is launched
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.coati_wavefront_score(
            aseq.data_ptr(), bseq.data_ptr(), lens_a.data_ptr(),
            lens_b.data_ptr(), table.data_ptr(), gap_consts.data_ptr(),
            adj.data_ptr(), *map(ptr, scratch), B, NA, NB, k, *launch.ints(),
            launch.threads, stream,
        )
    _build.check(rc, "wavefront_score")
    LAUNCHES += 1
    return adj
