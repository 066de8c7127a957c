"""Wrapper of the segment kernel (csrc/wavefront_segment.cu).

Counterpart of coati_tpu/kernels/wavefront_pallas.py
wavefront_pallas_segment: diagonals [d0, d0 + n_steps) of a group of pairs
from a carried ring. CPU tensors take the plain PyTorch version
(segment_plain, which is align/wavefront.py wavefront_plain in its segment
form); CUDA tensors launch the kernel or raise.

The carry is the reference's (coati_tpu/align/longseq.py _segment): ring
[K, 3, B, C] f32 with ring[q] = diagonal d0 - 1 - q, K = max(k, 2), and the
raw corners captured so far as one [3, B] f32 tensor (cM, cD, cI).
"""

from __future__ import annotations

import torch

from coati_tpu_torch.align.wavefront import LOWEST, wavefront_plain
from coati_tpu_torch.kernels import _build
from coati_tpu_torch.kernels.wavefront_fill import (
    _check,
    ring_in_shared,
    ring_slots,
)

LAUNCHES = 0  # kernel launches made by wavefront_segment
MULTI_BLOCK_SLOTS = 4096  # slots a pair above which several blocks sweep it


def sweep_shape(B: int, C: int, device, multi_threads: int = 1024) -> tuple[int, int]:
    """(blocks a pair, threads a block) of the sweep of B pairs of C slots.

    Pairs of more than MULTI_BLOCK_SLOTS slots, in a group narrower than the
    card's SMs, are each spread over several blocks: as many as keep the
    whole group on the card at once (one block of 1,024 threads an SM), and
    no more than a full diagonal has cells for. Those blocks meet at a
    barrier in device memory after every diagonal, which costs about as much
    as a block's pass over 4,096 cells; below that, one block a pair.

    multi_threads: the threads of each of a pair's several blocks, so the
    cells of a full diagonal a block takes at least: 1,024 for the Viterbi
    sweeps, fewer for a sweep whose cells cost more (the Forward)."""
    threads = 1024 if C > 2048 else 256
    if C <= MULTI_BLOCK_SLOTS:
        return 1, threads
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = min(sms // B, -(-C // multi_threads))
    return (blocks, multi_threads) if blocks > 1 else (1, threads)


def sweep_scratch(B: int, C: int, k: int, blocks: int, device):
    """(ring in shared memory?, global ring scratch or None, barrier counters
    or None) for a sweep of `blocks` blocks a pair."""
    ring_shared = blocks == 1 and ring_in_shared(C, k)
    scratch = None if ring_shared else torch.empty(
        (B, ring_slots(k), 3, C), dtype=torch.float32, device=device)
    sync = torch.zeros((B,), dtype=torch.int32, device=device) if blocks > 1 else None
    return ring_shared, scratch, sync


def empty_carry(B: int, C: int, k: int, device):
    """The carry entering diagonal 0: ring and raw corners all LOWEST."""
    ring = torch.full((max(k, 2), 3, B, C), LOWEST, dtype=torch.float32,
                      device=device)
    corners = torch.full((3, B), LOWEST, dtype=torch.float32, device=device)
    return ring, corners


def _check_carry(carry, B, C, k, dev):
    ring, corners = carry
    for name, t, shape in (("ring", ring, (max(k, 2), 3, B, C)),
                           ("corners", corners, (3, B))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"carry {name} must be f32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"carry {name} is on {t.device}, aseq on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"carry {name} must be contiguous")


def segment_plain(aseq, bseq, lens_a, lens_b, table, gap_consts, carry, d0, *,
                  k: int, n_steps: int, want_bp: bool):
    """Plain version of wavefront_segment, every slot of the padded matrix."""
    ring, corners = carry
    adj, bp, (ring_out, raw) = wavefront_plain(
        aseq, bseq, lens_a, lens_b, table, gap_consts, k=k,
        mode="viterbi" if want_bp else "score", d_start=d0, n_steps=n_steps,
        ring_init=ring, corner_init=tuple(corners), return_carry=True)
    return torch.stack(adj), bp, (ring_out, torch.stack(raw))


def wavefront_segment(aseq, bseq, lens_a, lens_b, table, gap_consts, carry,
                      d0: int, *, k: int, n_steps: int, want_bp: bool,
                      want_carry: bool = True):
    """Diagonals [d0, d0 + n_steps) from `carry`.

    Returns (adj, bp, carry_out): adj [3, B] the terminal-adjusted corners
    (meaningful once every pair's corner diagonal has run), bp [B, n_steps, C]
    uint8 or None, carry_out (ring, raw corners) or None when not wanted.
    On CUDA only the cells of each pair's (la+k) x (lb+k) matrix are computed:
    bp elsewhere is uninitialized and ring_out elsewhere is LOWEST.
    Preconditions as wavefront_fill's."""
    global LAUNCHES
    _check(aseq, bseq, lens_a, lens_b, table, gap_consts)
    B, NA = aseq.shape
    NB = bseq.shape[1]
    C = NB + k
    dev = aseq.device
    _check_carry(carry, B, C, k, dev)
    if d0 < 0 or n_steps < 1:
        raise ValueError(f"d0 {d0} and n_steps {n_steps} must be >= 0 and >= 1")
    if dev.type == "cpu":
        adj, bp, out = segment_plain(aseq, bseq, lens_a, lens_b, table,
                                     gap_consts, carry, d0, k=k,
                                     n_steps=n_steps, want_bp=want_bp)
        return adj, bp, (out if want_carry else None)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    ring_in, corners_in = carry
    ring_out = torch.empty_like(ring_in) if want_carry else None
    corners_out = torch.empty_like(corners_in) if want_carry else None
    adj = torch.empty((3, B), dtype=torch.float32, device=dev)
    bp = torch.empty((B, n_steps, C), dtype=torch.uint8, device=dev) if want_bp else None
    blocks, threads = sweep_shape(B, C, dev)
    ring_shared, scratch, sync = sweep_scratch(B, C, k, blocks, dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.coati_wavefront_segment(
            aseq.data_ptr(), bseq.data_ptr(), lens_a.data_ptr(),
            lens_b.data_ptr(), table.data_ptr(), gap_consts.data_ptr(),
            ring_in.data_ptr(), corners_in.data_ptr(), ptr(ring_out),
            ptr(corners_out), adj.data_ptr(), ptr(scratch), ptr(bp), ptr(sync),
            B, NA, NB, k, d0, n_steps, int(ring_shared), int(want_bp),
            blocks, threads, stream,
        )
    _build.check(rc, "wavefront_segment")
    LAUNCHES += 1
    return adj, bp, ((ring_out, corners_out) if want_carry else None)
