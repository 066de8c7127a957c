"""Wrapper of the Viterbi fill kernel (csrc/wavefront_fill.cu).

Counterpart of coati_tpu/kernels/wavefront_pallas.py wavefront_pallas
(viterbi, want_bp=True) and wavefront_pallas_stacked. CPU tensors take the
plain PyTorch version (align/wavefront.py wavefront_plain); CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import torch

from coati_tpu_torch.align.wavefront import wavefront_plain
from coati_tpu_torch.kernels import _build

LAUNCHES = 0  # kernel launches made by wavefront_fill

SMEM_BYTES = 232_448  # dynamic shared memory one H100 block may use
THREADS = 256


def ring_slots(k: int) -> int:
    """Diagonals the kernel keeps: the last max(k, 2) plus the one it writes."""
    return max(k, 2) + 1


def ring_bytes(C: int, k: int) -> int:
    """Bytes of the ring: 3 f32 state planes x ring_slots(k) diagonals x C."""
    return ring_slots(k) * 3 * C * 4


def ring_in_shared(C: int, k: int) -> bool:
    """True when the ring fits one block's shared memory; else it lives in
    a per-pair global scratch."""
    return ring_bytes(C, k) <= SMEM_BYTES


def table_in_shared(C: int, k: int, table_len: int) -> bool:
    """True when the table's table_len f32 fit the shared memory the ring
    leaves; else the kernel reads it from global memory."""
    ring = ring_bytes(C, k) if ring_in_shared(C, k) else 0
    return ring + table_len * 4 <= SMEM_BYTES


def _check(aseq, bseq, lens_a, lens_b, table, gap_consts):
    named = {"aseq": aseq, "bseq": bseq, "lens_a": lens_a, "lens_b": lens_b,
             "table": table, "gap_consts": gap_consts}
    dev = aseq.device
    for name, t in named.items():
        want = torch.float32 if name in ("table", "gap_consts") else torch.int32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, aseq on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B = aseq.shape[0]
    if (aseq.dim() != 2 or bseq.dim() != 2 or bseq.shape[0] != B
            or tuple(lens_a.shape) != (B,) or tuple(lens_b.shape) != (B,)):
        raise ValueError(
            f"shapes aseq {tuple(aseq.shape)} bseq {tuple(bseq.shape)} "
            f"lens {tuple(lens_a.shape)}/{tuple(lens_b.shape)} do not agree")
    if table.dim() != 2 or table.shape[1] != 15 or tuple(gap_consts.shape) != (4,):
        raise ValueError(f"table must be [rows, 15] and gap_consts [4], got "
                         f"{tuple(table.shape)} and {tuple(gap_consts.shape)}")


def wavefront_fill(aseq, bseq, lens_a, lens_b, table, gap_consts, *, k: int):
    """Viterbi fill: ((cM, cD, cI), bp) as wavefront_plain returns them.

    On CUDA only the cells of each pair's (la+k) x (lb+k) matrix of bp are
    written; the rest of the [B, Dtot, C] stack is left uninitialized.
    Preconditions the kernel does not check (they would cost a device sync;
    the engine checks them on the host): lens_a <= NA, lens_b <= NB, aseq
    codes < table rows, bseq codes < 16."""
    global LAUNCHES
    _check(aseq, bseq, lens_a, lens_b, table, gap_consts)
    if aseq.device.type == "cpu":
        return wavefront_plain(aseq, bseq, lens_a, lens_b, table, gap_consts, k=k)
    if aseq.device.type != "cuda":
        raise ValueError(f"unsupported device {aseq.device}")
    B, NA = aseq.shape
    NB = bseq.shape[1]
    C = NB + k
    Dtot = NA + NB + 2 * k - 1
    dev = aseq.device
    bp = torch.empty((B, Dtot, C), dtype=torch.uint8, device=dev)
    corners = torch.empty((3, B), dtype=torch.float32, device=dev)
    ring_shared = ring_in_shared(C, k)
    scratch = None if ring_shared else torch.empty(
        (B, ring_slots(k), 3, C), dtype=torch.float32, device=dev)
    table_shared = table_in_shared(C, k, table.numel())
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.coati_wavefront_fill(
            aseq.data_ptr(), bseq.data_ptr(), lens_a.data_ptr(),
            lens_b.data_ptr(), table.data_ptr(), gap_consts.data_ptr(),
            None if scratch is None else scratch.data_ptr(), bp.data_ptr(),
            corners.data_ptr(), B, NA, NB, k, table.numel(),
            int(ring_shared), int(table_shared), THREADS, stream,
        )
    _build.check(rc, "wavefront_fill")
    LAUNCHES += 1
    return (corners[0], corners[1], corners[2]), bp
