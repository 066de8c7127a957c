"""Wrapper of the Viterbi fill kernel (csrc/wavefront_fill.cu).

Counterpart of coati_tpu/kernels/wavefront_pallas.py wavefront_pallas
(viterbi, want_bp=True) and wavefront_pallas_stacked, for gap lengths k up
to MAX_K (the engine sends a larger k through the sweep kernel). CPU tensors
take the plain PyTorch version (fill_rows_plain: align/wavefront.py
wavefront_plain, its stack turned into the row layout); CUDA tensors launch
the kernel or raise.

The backpointer stack is in row layout, bp [B, NA + k, Cp] uint8 with cell
(i, j) at [p, i, j] and Cp = row_stride(NB + k), on both devices.

wavefront_fill_band is the long path's pass 2 (align/longseq.py): the same
fill over one band of rows from the checkpoint of the rows above it
(csrc/wavefront_fill_long.cu, entry point coati_wavefront_fill_band), with
its plain version align/wavefront.py band_fill_plain.
"""

from __future__ import annotations

import dataclasses

import torch

from coati_tpu_torch.align.wavefront import band_fill_plain, wavefront_plain
from coati_tpu_torch.kernels import _build

LAUNCHES = 0  # kernel launches made by wavefront_fill
BAND_LAUNCHES = 0  # kernel launches made by wavefront_fill_band

SMEM_BYTES = 232_448  # dynamic shared memory one H100 block may use
MAX_K = 8  # largest gap length the kernel is built for
# strip widths the kernel is built for, by gap length (csrc/wavefront_fill.cu
# launch_w): W >= k columns, and no more registers than a thread can have
STRIP_WIDTHS = {1: (4, 8, 16), 2: (4, 8, 16), 3: (4,), 4: (4,),
                5: (8,), 6: (8,), 7: (8,), 8: (8,)}
# the same body score-only (entry point coati_wavefront_fill_score,
# kernels/wavefront_score.py) is built for fewer: the widths score_shape
# picks at k = 1, one width above (k = 2 takes strips of 4)
SCORE_WIDTHS = {1: (4, 8, 16), 2: (4,), 3: (4,), 4: (4,),
                5: (8,), 6: (8,), 7: (8,), 8: (8,)}
RING_ROWS = 64  # rows of a warp boundary's ring (kRingRows)
ROW_QUANTUM = 16  # a row of the stack is a multiple of 16 bytes
MULTI_BLOCK_SLOTS = 4096  # slots a pair above which it spreads over blocks
BAND_WARPS = 4  # warps a block of a band's launch (band_shape)


def row_stride(C: int) -> int:
    """Bytes of a row of the stack for C slots: C rounded up to 16."""
    return -(-C // ROW_QUANTUM) * ROW_QUANTUM


def max_threads(k: int, W: int) -> int:
    """Threads a block may have at gap length k and strips of W columns
    (csrc/wavefront_fill.cu max_threads)."""
    regs = 6 * k * W + 2 * W + 60
    return 1024 if regs <= 64 else 512 if regs <= 128 else 256


def stripes(C: int, W: int) -> int:
    """Stripes of 32 strips of W columns that cover C slots."""
    return -(-C // (32 * W))


@dataclasses.dataclass(frozen=True)
class FillLaunch:
    """How the fill kernel sweeps B pairs of C slots at gap length k: strips
    of W columns, `warps` warps a pair in a block, `pairs` pairs a block,
    `blocks` blocks a pair, the table in shared memory or not."""

    B: int
    C: int
    k: int
    W: int
    warps: int
    pairs: int = 1
    blocks: int = 1
    table_shared: bool = True

    @property
    def threads(self) -> int:
        return 32 * self.warps * self.pairs

    @property
    def passes(self) -> int:
        """Times the warps of a pair sweep the rows: its stripes over its
        warps."""
        return -(-stripes(self.C, self.W) // (self.warps * self.blocks))

    @property
    def needs_edge(self) -> bool:
        """A stripe edge leaves a block: the edge buffer and its counters."""
        return self.blocks > 1 or stripes(self.C, self.W) > self.warps

    def smem_bytes(self, table_len: int) -> int:
        n_warps = self.warps * self.pairs
        table = -(-table_len // 4) * 4 * 4 if self.table_shared else 0
        return table + n_warps * RING_ROWS * (2 * self.k + 1) * 4 + 8 * n_warps


def fill_launch(B: int, C: int, k: int, W: int, warps: int, pairs: int = 1,
                blocks: int = 1, table_len: int = 183 * 15, *,
                widths=STRIP_WIDTHS) -> FillLaunch:
    """A launch of the given shape, checked; the table goes to shared memory
    when it fits, else it is read from device memory. widths: the strip
    widths the kernel is built for by k (SCORE_WIDTHS for the score-only
    body). Raises on a shape the kernel does not take."""
    if k not in widths or W not in widths[k]:
        raise ValueError(f"strips of {W} columns at k={k}: the kernel is built "
                         f"for {widths.get(k, ())}")
    if warps < 1 or pairs < 1 or blocks < 1 or (blocks > 1 and pairs > 1):
        raise ValueError(f"{warps} warps a pair, {pairs} pairs and {blocks} "
                         f"blocks: several blocks a pair take one pair a block")
    if 32 * warps * pairs > max_threads(k, W):
        raise ValueError(f"{32 * warps * pairs} threads: at k={k}, W={W} a "
                         f"block takes at most {max_threads(k, W)}")
    shape = dict(B=B, C=C, k=k, W=W, warps=warps, pairs=pairs, blocks=blocks)
    table_shared = FillLaunch(**shape).smem_bytes(table_len) <= SMEM_BYTES
    launch = FillLaunch(**shape, table_shared=table_shared)
    if launch.smem_bytes(table_len) > SMEM_BYTES:
        raise ValueError(f"{launch.smem_bytes(table_len)} bytes of shared "
                         f"memory a block: over {SMEM_BYTES}")
    return launch


def fill_shape(B: int, C: int, k: int, table_len: int = 183 * 15,
               sms: int = 132, *, widths=STRIP_WIDTHS) -> FillLaunch:
    """The launch the wrapper makes for B pairs of C slots at gap length k
    (widths as fill_launch's; where the width below is not built, the widest
    that is).

    Few pairs (fewer than 8 warps a SM at strips of 8): strips of 8 columns
    at k <= 2, of 4 at k = 3 or 4 (the only width built there), of 8 above, every stripe of a pair its own
    warp (one pass), one pair a block: the pair's chain of rows sets the
    time. Many pairs, at k <= 2 and over 512 slots: strips of 16, one warp a
    pair in passes (two while the pairs alone fill fewer than 8 warps a SM),
    two pairs a block: the card is full, and wider strips spend fewer
    instructions a cell.
    Above MULTI_BLOCK_SLOTS slots, strips of 4 (where k allows) and two
    warps a block, the pair's stripes spread over as many blocks as the SMs
    (`sms`) hold for the group: no such pair is left on one block while the
    card has SMs free. Rows that set this (sweep_shapes.py fill, second
    table; PERF.md section 6), H100, k = 1 unless said, ms: B = 64 x 1,057
    slots 0.85 at 8 x 5 warps (4 x 9: 0.85, 16 x 2: 0.96, 16 x 4: 0.94, two
    pairs a block 1.04); the main path's buckets in one launch, 156 nt
    (B = 3,589) 0.57 at 8 x 1 (16 x 1: 0.93), 471 nt (B = 3,008) 1.88 at
    16 x 1 (8 x 3: 2.94, 16 x 2: 3.62), 999 nt (B = 961) 2.68 at 16 x 1,
    2.78 at 16 x 2, 2.69 with two pairs a block (8 x 5: 4.17), 1,500 nt
    (B = 454) 3.83 at 16 x 2, 3.33 with two pairs a block (16 x 1: 4.19,
    8 x 9: 6.00); two pairs a block at 471 nt 1.85; k = 3, 471 nt (B = 256) 0.54 at 4 x 5 (8 x 3:
    0.63); one pair of 16,000 nt 13.1 at 4 x 2 warps over 63 blocks (8 x 1-4
    over 16-63 blocks: 14.3-14.5), and fill + walk 15.5 against 53.4 through
    the sweep's band route and the segment walk."""
    spread = C > MULTI_BLOCK_SLOTS
    many = B * stripes(C, 8) >= 8 * sms
    pairs = 1
    if many and not spread and 16 in widths[k] and C > 512:
        W, warps_most, pairs = 16, 1 if B >= 8 * sms else 2, 2
    else:
        W = 4 if spread or k >= 3 else 8
        if W not in widths[k]:
            W = widths[k][-1]
        warps_most = max_threads(k, W) // 32
    n = stripes(C, W)
    blocks = 1
    if spread:
        blocks = max(1, min(-(-n // 2), sms // max(B, 1)))
    warps = min(warps_most, -(-n // blocks))
    return fill_launch(B, C, k, W, warps, pairs, blocks, table_len, widths=widths)


def band_shape(B: int, C: int, k: int, table_len: int = 183 * 15,
               sms: int = 132) -> FillLaunch:
    """The launch of one band of rows of the long path's pass 2 for B pairs
    of C slots at gap length k: BAND_WARPS warps a block, every stripe of a
    pair its own warp over as many blocks as the SMs hold for the group, in
    the narrowest strips of at least 8 columns (where built) whose stripes
    that covers in one pass, else the widest (passes only where even those
    do not fit). A band of a few thousand rows pays every stripe's skew
    (some 48 rows a warp) once, so one pass beats the narrow strips and
    passes fill_shape takes for a whole matrix. Rows that set this
    (sweep_shapes.py band; PERF.md section 6), H100, k = 1, a middle band,
    ms, W x warps x blocks (passes): the four 29-32 knt pairs, 8,384 rows,
    11.52 at 8 x 4 x 32 (16 x 4 x 16: 12.90, 16 x 2 x 32: 13.05, 4 x 4 x
    33 (2): 12.97, 4 x 8 x 32: 13.69, 8 x 8 x 16: 13.77); the 160,002 nt
    pair, 6,710 rows, 24.73 at 16 x 4 x 79 (16 x 2 x 132 (2): 24.82, 16 x
    8 x 40: 32.19, 8 x 4 x 132 (2): 29.37, 8 x 8 x 79: 34.85, 4 x 4 x 132
    (3): 39.91)."""
    room = max(1, sms // max(B, 1))
    built = STRIP_WIDTHS[k]
    fits = [w for w in built if w >= 8 and stripes(C, w) <= BAND_WARPS * room]
    W = fits[0] if fits else built[-1]
    n = stripes(C, W)
    blocks = min(-(-n // BAND_WARPS), room)
    warps = min(max_threads(k, W) // 32, BAND_WARPS, -(-n // blocks))
    return fill_launch(B, C, k, W, warps, 1, blocks, table_len)


def edge_buffers(launch: FillLaunch, NA: int, dev, rows: int | None = None):
    """(edge, gprog) of one launch for ancestors padded to NA: the edge
    buffer [B, blocks, rows, 2k + 1] f32 (rows NA + k, or a band's) and its
    release counters [B, blocks] (zeros) when stripes leave a block, else
    (None, None)."""
    if not launch.needs_edge:
        return None, None
    B, k = launch.B, launch.k
    rows = NA + k if rows is None else rows
    return (torch.empty((B, launch.blocks, rows, 2 * k + 1), dtype=torch.float32,
                        device=dev),
            torch.zeros((B, launch.blocks), dtype=torch.int32, device=dev))


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


def rows_from_diagonals(bp_diag, NA: int, k: int):
    """The row layout [B, NA + k, row_stride(C)] of a diagonal-layout stack
    [B, Dtot, C] (cell (i, j) at [p, i + j, j]); the padding columns hold 0."""
    B, _, C = bp_diag.shape
    R = NA + k
    i = torch.arange(R, device=bp_diag.device)[:, None]
    j = torch.arange(C, device=bp_diag.device)[None, :]
    out = torch.zeros((B, R, row_stride(C)), dtype=torch.uint8,
                      device=bp_diag.device)
    out[:, :, :C] = bp_diag[:, i + j, j]
    return out


def true_cells(la, lb, k: int, R: int, Cp: int):
    """[B, R, Cp] mask of each pair's true cells i, j >= k in row layout (the
    cells of the stack wavefront_fill defines, less the first k rows and
    columns)."""
    i = torch.arange(R, device=la.device)[None, :, None]
    j = torch.arange(Cp, device=la.device)[None, None, :]
    la = la.long()[:, None, None]
    lb = lb.long()[:, None, None]
    return (i >= k) & (i < la + k) & (j >= k) & (j < lb + k)


def fill_rows_plain(aseq, bseq, lens_a, lens_b, table, gap_consts, *, k: int):
    """Plain version of wavefront_fill: wavefront_plain, its stack in row
    layout."""
    corners, bp = wavefront_plain(aseq, bseq, lens_a, lens_b, table,
                                  gap_consts, k=k)
    return corners, rows_from_diagonals(bp, aseq.shape[1], k)


def wavefront_fill(aseq, bseq, lens_a, lens_b, table, gap_consts, *, k: int,
                   launch: FillLaunch | None = None):
    """Viterbi fill: ((cM, cD, cI), bp) with the terminal-adjusted corners
    and the stack in row layout [B, NA + k, row_stride(NB + k)].

    On CUDA only the cells of each pair's (la+k) x (lb+k) matrix of bp are
    defined; the rest of the stack is left uninitialized. launch: the shape
    (fill_launch), by default fill_shape's. Preconditions the kernel does
    not check (they would cost a device sync; the engine checks them on the
    host): lens_a <= NA, lens_b <= NB, aseq codes < table rows, bseq codes
    < 16."""
    global LAUNCHES
    _check(aseq, bseq, lens_a, lens_b, table, gap_consts)
    if aseq.device.type == "cpu":
        return fill_rows_plain(aseq, bseq, lens_a, lens_b, table, gap_consts, k=k)
    if aseq.device.type != "cuda":
        raise ValueError(f"unsupported device {aseq.device}")
    if k not in STRIP_WIDTHS:
        raise ValueError(f"the fill kernel takes k <= {MAX_K}, got {k}: a "
                         f"larger k takes the sweep (engine.fused_align_ops)")
    B, NA = aseq.shape
    NB = bseq.shape[1]
    C = NB + k
    Cp = row_stride(C)
    dev = aseq.device
    if launch is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        launch = fill_shape(B, C, k, table.numel(), sms)
    if (launch.B, launch.C, launch.k) != (B, C, k):
        raise ValueError(f"a launch for B={launch.B} C={launch.C} k={launch.k}, "
                         f"given B={B} C={C} k={k}")
    bp = torch.empty((B, NA + k, Cp), dtype=torch.uint8, device=dev)
    corners = torch.empty((3, B), dtype=torch.float32, device=dev)
    edge, gprog = edge_buffers(launch, NA, dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.coati_wavefront_fill(
            aseq.data_ptr(), bseq.data_ptr(), lens_a.data_ptr(),
            lens_b.data_ptr(), table.data_ptr(), gap_consts.data_ptr(),
            bp.data_ptr(), corners.data_ptr(),
            None if edge is None else edge.data_ptr(),
            None if gprog is None else gprog.data_ptr(),
            B, NA, NB, k, Cp, table.numel(), int(launch.table_shared),
            launch.W, launch.warps, launch.pairs, launch.blocks, stream,
        )
    _build.check(rc, "wavefront_fill")
    LAUNCHES += 1
    return (corners[0], corners[1], corners[2]), bp


def wavefront_fill_band(aseq, bseq, lens_a, lens_b, table, gap_consts, ckpt, *,
                        k: int, row0: int, band_rows: int,
                        launch: FillLaunch | None = None):
    """The long path's pass 2: the Viterbi fill with backpointers over rows
    [row0, row0 + band_rows) of each pair's matrix, from ckpt [B, k, 3, Cp]
    f32, (M, D, I) of rows row0 - k .. row0 - 1 as wavefront_score_ckpt keeps
    them (one band's slice; None for row0 = 0). Returns bp [B, band_rows,
    Cp] uint8 in row layout, cell (i, j) at [p, i - row0, j], Cp =
    row_stride(NB + k); on CUDA only the true cells of each pair's rows in
    the band are defined, and a pair with no row in it launches no work.
    k <= MAX_K. launch: the shape (fill_launch), by default band_shape's.
    Preconditions as wavefront_fill's."""
    global BAND_LAUNCHES
    _check(aseq, bseq, lens_a, lens_b, table, gap_consts)
    if k not in STRIP_WIDTHS or band_rows < k or row0 < 0:
        raise ValueError(f"a band of {band_rows} rows at row {row0}, k={k}: the "
                         f"kernel takes k <= {MAX_K} and at least k rows")
    B, NA = aseq.shape
    NB = bseq.shape[1]
    C = NB + k
    Cp = row_stride(C)
    dev = aseq.device
    if row0 > 0:
        if ckpt is None:
            raise ValueError("a band below row 0 starts from its checkpoint")
        if (ckpt.dtype != torch.float32 or tuple(ckpt.shape) != (B, k, 3, Cp)
                or not ckpt.is_contiguous() or ckpt.device != dev):
            raise ValueError(f"ckpt must be contiguous f32 [{B}, {k}, 3, {Cp}] on "
                             f"{dev}, got {ckpt.dtype} {tuple(ckpt.shape)} on {ckpt.device}")
    if dev.type == "cpu":
        return band_fill_plain(aseq, bseq, lens_a, lens_b, table, gap_consts,
                               ckpt if row0 > 0 else None, k=k, row0=row0,
                               band_rows=band_rows)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if launch is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        launch = band_shape(B, C, k, table.numel(), sms)
    if (launch.B, launch.C, launch.k) != (B, C, k):
        raise ValueError(f"a launch for B={launch.B} C={launch.C} k={launch.k}, "
                         f"given B={B} C={C} k={k}")
    bp = torch.empty((B, band_rows, Cp), dtype=torch.uint8, device=dev)
    edge, gprog = edge_buffers(launch, NA, dev, rows=band_rows)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.coati_wavefront_fill_band(
            aseq.data_ptr(), bseq.data_ptr(), lens_a.data_ptr(),
            lens_b.data_ptr(), table.data_ptr(), gap_consts.data_ptr(),
            ckpt.data_ptr() if row0 > 0 else None, bp.data_ptr(),
            None if edge is None else edge.data_ptr(),
            None if gprog is None else gprog.data_ptr(),
            B, NA, NB, k, Cp, row0, band_rows, table.numel(),
            int(launch.table_shared), launch.W, launch.warps, launch.pairs,
            launch.blocks, stream,
        )
    _build.check(rc, "wavefront_fill_band")
    BAND_LAUNCHES += 1
    return bp
