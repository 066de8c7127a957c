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

import dataclasses

import torch

from coati_tpu_torch.align.wavefront import LOWEST, wavefront_plain
from coati_tpu_torch.kernels import _build
from coati_tpu_torch.kernels.wavefront_fill import (
    MULTI_BLOCK_SLOTS,
    SMEM_BYTES,
    _check,
)

LAUNCHES = 0  # kernel launches made by wavefront_segment
# Narrowest band the Viterbi sweeps spread a pair to: on an H100 one 8,000 nt
# pair took 1.40 us a diagonal in 32-33 bands of 243-251 columns and 1.54 in
# 127 of 63; one 32,000 nt pair 1.62 in 132 of 243 (sweep_shapes.py, the
# segment table; PERF.md section 6).
BAND_MIN_COLUMNS = 243
# How a launch sweeps its pairs (csrc/wavefront_segment.cu Route): one block a
# pair with the ring in global or in shared memory; several blocks a pair that
# meet at an all-to-all barrier after every diagonal, ring in global memory;
# several blocks a pair, each a band of columns, ring in shared memory.
ROUTES = {"global": 0, "shared": 1, "barrier": 2, "bands": 3}
HALO_SLOTS = 256  # F: diagonals of each band boundary's halo ring


def ring_slots(k: int) -> int:
    """Diagonals the sweep keeps: the last max(k, 2) plus the one it writes."""
    return max(k, 2) + 1


def ring_in_shared(C: int, k: int) -> bool:
    """True when one block's ring of ring_slots(k) diagonals x 3 f32 states x
    C slots fits its shared memory; else it lives in a per-pair global
    scratch."""
    return ring_slots(k) * 3 * C * 4 <= SMEM_BYTES


def sweep_shape(B: int, C: int, device, min_columns: int = BAND_MIN_COLUMNS,
                threads: int | None = None) -> tuple[int, int]:
    """(blocks a pair, threads a block) of the sweep of B pairs of C slots.

    Up to MULTI_BLOCK_SLOTS slots one block a pair (1,024 threads above 2,048
    slots, else 256). Above, each pair is cut into as many bands as keep the
    whole group on the card at once (one block an SM: the launch is
    cooperative) and no narrower than min_columns, with blocks of 512
    threads while a band has at most 1,024 columns and of 1,024 above (or
    `threads`). Rows that set this (sweep_shapes.py; PERF.md section 6):
    bands of 243-251 columns at 512 threads, 1.40-1.62 us a diagonal at
    8,000 and 32,000 nt against 1.60-1.85 at 1,024 threads and 2.53-3.03 at
    the barrier; 4 x 32,000 nt in 33 bands of 970, 2.00 us at 512 threads,
    2.06 at 1,024, 3.78 at the barrier; 160,000 nt in 132 bands of 1,213,
    2.68 us at 1,024 threads, 2.72 at 512, 5.04-5.09 at the barrier."""
    if C <= MULTI_BLOCK_SLOTS:
        return 1, 1024 if C > 2048 else 256
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = min(sms // B, -(-C // min_columns))
    if blocks <= 1:
        return 1, 1024
    if threads is None:
        threads = 512 if -(-C // blocks) <= 1024 else 1024
    return blocks, threads


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """Columns [j0, j1) of each of a pair's bands (every one `width` wide but
    the last, which may be narrower), the halo of k columns, the halo ring
    of `slots` diagonals, and what it takes: the band's cells a thread on a
    full diagonal, shared memory a block, device scratch (halo rings and
    counters) of the whole launch."""

    bands: tuple[tuple[int, int], ...]
    width: int
    halo: int
    slots: int
    cells_a_thread: int
    smem_bytes: int
    scratch_bytes: int


def band_plan(B: int, C: int, k: int, blocks: int, threads: int, *,
              table_len: int = 183 * 15,
              slots: int = HALO_SLOTS) -> BandPlan | None:
    """The band route's cut of C slots into at most `blocks` bands of at
    least k + 32 columns, or None when it cannot take the launch (fewer than
    two such bands, k over 32, or a band's ring and the table over one
    block's shared memory). The halo ring of `slots` diagonals must outlast
    max(k, 2) + 2 of them (what a reader may still copy, and two diagonals of
    counters that lag)."""
    if slots <= max(k, 2) + 2:
        raise ValueError(f"halo ring of {slots} diagonals: the ring must "
                         f"outlast max(k, 2) + 2 diagonals")
    if k > 32:
        return None
    n = min(blocks, C // (k + 32))
    while n >= 2:
        width = -(-C // n)
        n_bands = -(-C // width)
        if n_bands >= 2 and C - (n_bands - 1) * width >= k + 32:
            break
        n -= 1
    if n < 2:
        return None
    smem = (ring_slots(k) * 3 * (k + width) + table_len) * 4
    if smem > SMEM_BYTES:
        return None
    bands = tuple((b * width, min(C, (b + 1) * width)) for b in range(n_bands))
    scratch = B * ((n_bands - 1) * slots * 3 * k * 4 + n_bands * 4)
    return BandPlan(bands, width, k, slots, -(-width // threads), smem, scratch)


@dataclasses.dataclass(frozen=True)
class SweepLaunch:
    """How a sweep of B pairs of C slots at gap length k is launched: its
    route (a key of ROUTES), blocks a pair, threads a block, the table's
    length, the band plan (band route), and `stamps`: None, or an int64
    tensor on the card of at least 3 x B x blocks, into which the band route
    writes each block's globaltimer (ns) at entry, at its first cell (after
    its first halo wait) and at exit (a block with no cell leaves the second
    as the caller filled it)."""

    route: str
    B: int
    C: int
    k: int
    blocks: int
    threads: int
    table_len: int
    plan: BandPlan | None = None
    stamps: torch.Tensor | None = None

    def buffers(self, device):
        """Fresh scratch of one launch, as the entry points take it:
        (ring_scratch, sync, halo, next, stamps), None where the route takes
        none. The global ring [B, K+1, 3, C] f32 (one block a pair with the
        ring in global memory, and the barrier route), the barrier counters
        [B] zeros, the halo rings [B, bands-1, F, 3, k] f32 and the progress
        counters [B, bands] zeros (band route)."""
        B, C, k = self.B, self.C, self.k
        ring = sync = halo = nxt = None
        if self.route in ("global", "barrier"):
            ring = torch.empty((B, ring_slots(k), 3, C), dtype=torch.float32,
                               device=device)
        if self.route == "barrier":
            sync = torch.zeros((B,), dtype=torch.int32, device=device)
        if self.route == "bands":
            n = len(self.plan.bands)
            halo = torch.empty((B, n - 1, self.plan.slots, 3, k),
                               dtype=torch.float32, device=device)
            nxt = torch.zeros((B, n), dtype=torch.int32, device=device)
        stamps = self.stamps if self.route == "bands" else None
        if stamps is not None and stamps.device != torch.device(device):
            raise ValueError(f"stamps on {stamps.device}, the sweep on {device}")
        return ring, sync, halo, nxt, stamps

    def ints(self):
        """route, blocks_per_pair, band_width, halo_slots, table_len."""
        plan = self.plan
        return (ROUTES[self.route], self.blocks, plan.width if plan else 0,
                plan.slots if plan else 0, self.table_len)

    def check(self, B: int, C: int, k: int, table_len: int) -> None:
        """Raises unless the launch was made for this sweep."""
        if (self.B, self.C, self.k, self.table_len) != (B, C, k, table_len):
            raise ValueError(
                f"a launch for B={self.B} C={self.C} k={self.k} table of "
                f"{self.table_len}, given B={B} C={C} k={k} table of {table_len}")


def sweep_launch(B: int, C: int, k: int, blocks: int, threads: int,
                 table_len: int = 183 * 15, *, several: str = "bands",
                 stamps: torch.Tensor | None = None) -> SweepLaunch:
    """The route of a sweep of B pairs of C slots at `blocks` blocks a pair
    of `threads` threads. Several blocks take the band route where
    band_plan allows it, with as many blocks as it has bands, else the
    barrier route; several="barrier" forces the barrier route. stamps: as
    SweepLaunch's. Raises on a shape the kernel does not take."""
    if blocks < 1 or threads < 32 or threads > 1024 or threads % 32:
        raise ValueError(f"{blocks} blocks of {threads} threads a pair: the "
                         f"sweep takes 1 or more blocks of 32-1,024 threads, "
                         f"a multiple of 32")
    if several not in ("bands", "barrier"):
        raise ValueError(f"several blocks a pair take 'bands' or 'barrier', "
                         f"not {several!r}")
    shape = dict(B=B, C=C, k=k, threads=threads, table_len=table_len)
    if blocks == 1:
        return SweepLaunch("shared" if ring_in_shared(C, k) else "global",
                           blocks=1, **shape)
    plan = band_plan(B, C, k, blocks, threads, table_len=table_len)
    if several == "bands" and plan is not None:
        n = len(plan.bands)
        if stamps is not None and (stamps.dtype != torch.int64
                                   or stamps.numel() < 3 * B * n):
            raise ValueError(f"stamps must be int64 of at least {3 * B * n}")
        return SweepLaunch("bands", blocks=n, plan=plan, stamps=stamps, **shape)
    return SweepLaunch("barrier", blocks=blocks, **shape)


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
                      want_carry: bool = True,
                      launch: SweepLaunch | None = None):
    """Diagonals [d0, d0 + n_steps) from `carry`.

    Returns (adj, bp, carry_out): adj [3, B] the terminal-adjusted corners
    (meaningful once every pair's corner diagonal has run), bp [B, n_steps, C]
    uint8 or None, carry_out (ring, raw corners) or None when not wanted.
    On CUDA only the cells of each pair's (la+k) x (lb+k) matrix are computed:
    bp elsewhere is uninitialized and ring_out elsewhere is LOWEST. launch:
    how to launch the kernel (sweep_launch), by default sweep_shape's.
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
    if launch is None:
        launch = sweep_launch(B, C, k, *sweep_shape(B, C, dev), table.numel())
    launch.check(B, C, k, table.numel())
    scratch = launch.buffers(dev)  # held until the kernel is launched
    ring, *rest = map(ptr, scratch)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        route, blocks, width, slots, table_len = launch.ints()
        rc = lib.coati_wavefront_segment(
            aseq.data_ptr(), bseq.data_ptr(), lens_a.data_ptr(),
            lens_b.data_ptr(), table.data_ptr(), gap_consts.data_ptr(),
            ring_in.data_ptr(), corners_in.data_ptr(), ptr(ring_out),
            ptr(corners_out), adj.data_ptr(), ring, ptr(bp), *rest, B, NA, NB,
            k, d0, n_steps, route, int(want_bp), blocks, width, slots,
            table_len, launch.threads, stream,
        )
    _build.check(rc, "wavefront_segment")
    LAUNCHES += 1
    return adj, bp, ((ring_out, corners_out) if want_carry else None)


def ptr(t):
    """A tensor's device pointer, None for None."""
    return None if t is None else t.data_ptr()
