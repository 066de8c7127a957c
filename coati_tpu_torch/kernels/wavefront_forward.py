"""Wrapper of the Forward kernel (csrc/wavefront_segment.cu, entry point
coati_wavefront_forward).

Counterpart of coati_tpu/kernels/wavefront_pallas.py wavefront_pallas with
mode="forward": the log-semiring Forward fill of every pair, every cell's
M, D, I kept for the stochastic traceback. CPU tensors take the plain
PyTorch version (forward_plain, align/wavefront.py wavefront_plain in
forward mode); CUDA tensors launch the kernel or raise.

The values come out in row layout, mdi [B, NA+k, NB+k, 3] f32 with cell
(i, j) of pair p at [p, i, j]: what kernels/sample_walk.py reads.
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

LAUNCHES = 0  # kernel launches made by wavefront_forward
# A Forward cell costs five lse (an expf and a log1pf each) where a Viterbi
# cell costs five maxima, so its bands are narrower and its blocks smaller.
# Rows that set this, on an H100 (sweep_shapes.py, the Forward table; PERF.md
# section 6): one 9,999 nt pair 36.5-36.7 ms in 58-132 bands of 512
# threads against 40.5-41.1 at 1,024 and 87.0-90.1 at the barrier (the old
# route's best, 20-66 x 512); one 29,397 nt pair 114.3 ms in 132 bands of
# 512 threads against 122.9 at 1,024 and 272-301 at the barrier. The band
# route lost to the barrier only at 4 or more cells a thread (29,397 nt in 8
# or 16 bands), which this rule gives one pair only above 132 x 3 x 512 =
# 202,752 slots, a Forward of some 490 GB.
FORWARD_MIN_COLUMNS = 64
FORWARD_BLOCK_THREADS = 512


def forward_shape(B: int, C: int, device) -> tuple[int, int]:
    """(blocks a pair, threads a block) of the Forward of B pairs of C slots:
    sweep_shape's rule with bands of at least FORWARD_MIN_COLUMNS columns
    and blocks of FORWARD_BLOCK_THREADS threads."""
    return sweep_shape(B, C, device, FORWARD_MIN_COLUMNS, FORWARD_BLOCK_THREADS)


def forward_bytes(na: int, nb: int, k: int) -> int:
    """Bytes of one pair's Forward matrices: 3 f32 a cell of (na+k) x (nb+k)."""
    return 12 * (na + k) * (nb + k)


def forward_plain(aseq, bseq, lens_a, lens_b, table, gap_consts, *, k: int):
    """Plain version of wavefront_forward, every slot of the padded matrix."""
    adj, mdi = wavefront_plain(aseq, bseq, lens_a, lens_b, table, gap_consts,
                               k=k, mode="forward", semiring="log")
    return torch.stack(adj), mdi


def wavefront_forward(aseq, bseq, lens_a, lens_b, table, gap_consts, *, k: int,
                      launch: SweepLaunch | None = None):
    """Log-semiring Forward fill. Returns (adj, mdi): adj [3, B] f32 the
    terminal-adjusted corners (cM, cD, cI), mdi [B, NA+k, NB+k, 3] f32 the M,
    D, I of every cell, margins included, the raw corner at its cell. On
    CUDA only the cells of each pair's (la+k) x (lb+k) rectangle are
    written; the rest of mdi is uninitialized. launch: how to launch the
    kernel (wavefront_segment.sweep_launch), by default forward_shape's.
    Preconditions as wavefront_fill's."""
    global LAUNCHES
    _check(aseq, bseq, lens_a, lens_b, table, gap_consts)
    dev = aseq.device
    if dev.type == "cpu":
        return forward_plain(aseq, bseq, lens_a, lens_b, table, gap_consts, k=k)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, NA = aseq.shape
    NB = bseq.shape[1]
    C = NB + k
    adj = torch.empty((3, B), dtype=torch.float32, device=dev)
    mdi = torch.empty((B, NA + k, C, 3), dtype=torch.float32, device=dev)
    if launch is None:
        launch = sweep_launch(B, C, k, *forward_shape(B, C, dev), table.numel())
    launch.check(B, C, k, table.numel())
    scratch = launch.buffers(dev)  # held until the kernel is launched
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.coati_wavefront_forward(
            aseq.data_ptr(), bseq.data_ptr(), lens_a.data_ptr(),
            lens_b.data_ptr(), table.data_ptr(), gap_consts.data_ptr(),
            adj.data_ptr(), *map(ptr, scratch), mdi.data_ptr(), B, NA, NB, k,
            *launch.ints(), launch.threads, stream,
        )
    _build.check(rc, "wavefront_forward")
    LAUNCHES += 1
    return adj, mdi
