"""Wrapper of the score-only Viterbi kernels: the strip body without
backpointers (csrc/wavefront_fill.cu, entry point coati_wavefront_fill_score)
for gap lengths up to wavefront_fill.MAX_K, the sweep (csrc/wavefront_segment.cu,
entry point coati_wavefront_score) above.

Counterpart of coati_tpu/kernels/wavefront_pallas.py wavefront_pallas with
want_bp=False: the corner scores of every pair with no backpointers and
O(NA) state a block boundary. CPU tensors take the plain PyTorch version
(score_plain, align/wavefront.py wavefront_plain in score mode); CUDA
tensors launch a kernel or raise.

wavefront_score_ckpt is the long path's pass 1 (align/longseq.py): the strip
body without backpointers that also keeps the k rows above every band
boundary (csrc/wavefront_fill_long.cu, entry point coati_wavefront_fill_ckpt),
with its plain version ckpt_plain.
"""

from __future__ import annotations

import torch

from coati_tpu_torch.align.wavefront import LOWEST, wavefront_plain
from coati_tpu_torch.kernels import _build
from coati_tpu_torch.kernels.wavefront_fill import (
    MAX_K,
    MULTI_BLOCK_SLOTS,
    SCORE_WIDTHS,
    FillLaunch,
    _check,
    edge_buffers,
    fill_launch,
    fill_shape,
    row_stride,
    stripes,
)
from coati_tpu_torch.kernels.wavefront_segment import (
    SweepLaunch,
    ptr,
    sweep_launch,
    sweep_shape,
)

LAUNCHES = 0  # kernel launches made by wavefront_score
CKPT_LAUNCHES = 0  # kernel launches made by wavefront_score_ckpt
SPREAD_WARPS = 4  # warps a block of a pair spread over blocks


def score_shape(B: int, C: int, k: int, table_len: int = 183 * 15,
                sms: int = 132) -> FillLaunch:
    """The strip launch of a score-only sweep of B pairs of C slots at gap
    length k <= MAX_K.

    Up to MULTI_BLOCK_SLOTS slots, fill_shape's rule over the widths the
    score-only body is built for (SCORE_WIDTHS). Above, with no stack to
    hold, each pair's stripes in one pass over blocks of SPREAD_WARPS
    warps, no more blocks than the SMs hold for the group, in the narrowest
    strips of at least 8 columns (where built) that let them: a step of 8
    columns costs a lane about what one of 4 does, and fewer stripes skew
    less; a fifth warp on an SM slows the rows. Where no width fits,
    fill_shape's rule (passes). Rows that set this (sweep_shapes.py score;
    PERF.md section 6), H100, k = 1, ms, W x warps x blocks: one pair of
    8,000 nt 5.76 at 8 x 4 x 8 (4 x 1 x 63: 6.46-6.62, 16 x 4 x 4: 6.41;
    the sweep's bands 20.47); one of 16,000 11.65 at 8 x 4 x 16 (8 x 2 x
    32: 11.72, 4 x 1-4: 12.76-13.03, 16 x 2-4: 12.89-13.01, bands 41.2);
    two of 16,000 11.67 at 8 x 4 x 16 (4 x 2 x 63: 12.83); the four 29-32
    knt pairs 23.08-23.13 at 8 x 4 x 32 (4 x 8 x 33: 27.0, 16 x 2-4:
    25.7-25.8, 8 x 5 x 26: 26.9, bands 110.2-110.7); the 160,002 nt pair
    128.3 at 16 x 4 x 79 (16 x 3 x 105: 128.5-136.1, 8 x 5 x 126: 134.0,
    4 x 10 x 132: 146.8, bands 683.5). Below the threshold, fill_shape's
    launches against the sweep's one block a pair: the B = 64 cell 0.67-0.68
    at 8 x 5 (2.05); the main path's buckets in one launch, 156 nt 0.35
    (1.79), 471 nt 1.36 (6.42), 999 nt 2.05 (7.54; 16 x 1, one pair a
    block: 1.92), 1,500 nt 2.47 (9.31); k = 3 at 471 nt 0.43 (0.86)."""
    if k > MAX_K:
        raise ValueError(f"the strip body takes k <= {MAX_K}, got {k}: a "
                         f"larger k takes the sweep")
    if C > MULTI_BLOCK_SLOTS:
        room = max(1, sms // max(B, 1))
        built = SCORE_WIDTHS[k]
        for W in [w for w in built if w >= 8] or built:
            n = stripes(C, W)
            if n <= SPREAD_WARPS * room:
                warps = min(SPREAD_WARPS, n)
                return fill_launch(B, C, k, W, warps, 1, -(-n // warps), table_len,
                                   widths=SCORE_WIDTHS)
    return fill_shape(B, C, k, table_len, sms, widths=SCORE_WIDTHS)


def score_plain(aseq, bseq, lens_a, lens_b, table, gap_consts, *, k: int):
    """Plain version of wavefront_score: corners [3, B] f32."""
    adj, _ = wavefront_plain(aseq, bseq, lens_a, lens_b, table, gap_consts,
                             k=k, mode="score")
    return torch.stack(adj)


def wavefront_score(aseq, bseq, lens_a, lens_b, table, gap_consts, *, k: int,
                    launch: FillLaunch | SweepLaunch | None = None):
    """Score-only Viterbi: the terminal-adjusted corners (cM, cD, cI) as one
    [3, B] f32 tensor; a pair's score is their maximum. launch: a strip
    launch (score_shape, or wavefront_fill.fill_launch with
    widths=SCORE_WIDTHS) or a sweep launch (wavefront_segment.sweep_launch);
    by default score_shape's for k <= MAX_K, sweep_shape's above.
    Preconditions as wavefront_fill's."""
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
        if k <= MAX_K:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            launch = score_shape(B, C, k, table.numel(), sms)
        else:
            launch = sweep_launch(B, C, k, *sweep_shape(B, C, dev), table.numel())
    lib = _build.load()
    if isinstance(launch, FillLaunch):
        if (launch.B, launch.C, launch.k) != (B, C, k) or launch.W not in SCORE_WIDTHS.get(k, ()):
            raise ValueError(f"a strip launch for B={launch.B} C={launch.C} "
                             f"k={launch.k} W={launch.W}, given B={B} C={C} k={k} "
                             f"(widths built: {SCORE_WIDTHS.get(k, ())})")
        edge, gprog = edge_buffers(launch, NA, dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.coati_wavefront_fill_score(
                aseq.data_ptr(), bseq.data_ptr(), lens_a.data_ptr(),
                lens_b.data_ptr(), table.data_ptr(), gap_consts.data_ptr(),
                adj.data_ptr(), ptr(edge), ptr(gprog), B, NA, NB, k,
                table.numel(), int(launch.table_shared), launch.W,
                launch.warps, launch.pairs, launch.blocks, stream,
            )
    else:
        launch.check(B, C, k, table.numel())
        scratch = launch.buffers(dev)  # held until the kernel is launched
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


def ckpt_cells(lens_a, lens_b, k: int, band_rows: int, n_ckpt: int, Cp: int):
    """[n_ckpt, B, k, 3, Cp] mask of the checkpoint entries the kernel
    defines: bands 1 .. n_ckpt, rows and columns of each pair's (la+k) x
    (lb+k) matrix."""
    b = torch.arange(1, n_ckpt + 1, device=lens_a.device)[:, None, None]
    row = b * band_rows - k + torch.arange(k, device=lens_a.device)[None, None, :]
    row_ok = row < (lens_a.long() + k)[None, :, None]  # [n, B, k]
    col_ok = torch.arange(Cp, device=lens_a.device)[None, :] < (lens_b.long() + k)[:, None]
    mask = row_ok[:, :, :, None, None] & col_ok[None, :, None, None, :]
    return mask.expand(n_ckpt, lens_a.shape[0], k, 3, Cp)


def ckpt_plain(aseq, bseq, lens_a, lens_b, table, gap_consts, *, k: int,
               band_rows: int, n_ckpt: int):
    """Plain version of wavefront_score_ckpt: (corners [3, B] f32, ckpt
    [n_ckpt, B, k, 3, Cp] f32), wavefront_plain in score mode keeping the
    checkpoint rows (entries the kernel leaves undefined hold LOWEST or the
    padding's values)."""
    B = aseq.shape[0]
    Cp = row_stride(bseq.shape[1] + k)
    R = aseq.shape[1] + k
    # rows b x band_rows - k .. b x band_rows - 1 of bands b = 1 .. n_ckpt
    # (band 0 starts at the top boundary), those the padded matrix has
    rows = [r for b in range(1, n_ckpt + 1)
            for r in range(b * band_rows - k, b * band_rows) if r < R]
    adj, kept = wavefront_plain(aseq, bseq, lens_a, lens_b, table, gap_consts,
                                k=k, mode="score", keep_rows=rows)
    ckpt = torch.full((n_ckpt, B, k, 3, Cp), LOWEST, dtype=torch.float32,
                      device=aseq.device)
    C = kept.shape[2]
    for n, r in enumerate(rows):
        b, q = divmod(r + k, band_rows)
        ckpt[b - 1, :, q, :, :C] = kept[:, n].permute(0, 2, 1)
    return torch.stack(adj), ckpt


def wavefront_score_ckpt(aseq, bseq, lens_a, lens_b, table, gap_consts, *,
                         k: int, band_rows: int, n_ckpt: int,
                         launch: FillLaunch | None = None):
    """The long path's pass 1: score-only Viterbi over each pair's whole
    matrix that also keeps (M, D, I) of the k rows above every band boundary
    b x band_rows, b = 1 .. n_ckpt (band 0 starts at the top boundary).
    Returns (corners [3, B] f32 terminal-adjusted, ckpt [n_ckpt, B, k, 3,
    Cp] f32 with row b x band_rows - k + q at [b - 1, p, q], Cp =
    row_stride(NB + k)); on CUDA only the entries of ckpt_cells are defined.
    k <= MAX_K; band_rows >= k; n_ckpt >= 0. launch: a strip
    launch (score_shape's by default, or wavefront_fill.fill_launch with
    widths=SCORE_WIDTHS). Preconditions as wavefront_fill's."""
    global CKPT_LAUNCHES
    _check(aseq, bseq, lens_a, lens_b, table, gap_consts)
    if k > MAX_K or band_rows < k or n_ckpt < 0:
        raise ValueError(f"checkpoints at k={k} (the strip body takes k <= {MAX_K}) "
                         f"every {band_rows} rows (at least k), {n_ckpt} of them")
    dev = aseq.device
    if dev.type == "cpu":
        return ckpt_plain(aseq, bseq, lens_a, lens_b, table, gap_consts, k=k,
                          band_rows=band_rows, n_ckpt=n_ckpt)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, NA = aseq.shape
    NB = bseq.shape[1]
    C = NB + k
    Cp = row_stride(C)
    if launch is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        launch = score_shape(B, C, k, table.numel(), sms)
    if (launch.B, launch.C, launch.k) != (B, C, k) or launch.W not in SCORE_WIDTHS[k]:
        raise ValueError(f"a strip launch for B={launch.B} C={launch.C} "
                         f"k={launch.k} W={launch.W}, given B={B} C={C} k={k} "
                         f"(widths built: {SCORE_WIDTHS[k]})")
    adj = torch.empty((3, B), dtype=torch.float32, device=dev)
    ckpt = torch.empty((n_ckpt, B, k, 3, Cp), dtype=torch.float32, device=dev)
    edge, gprog = edge_buffers(launch, NA, dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.coati_wavefront_fill_ckpt(
            aseq.data_ptr(), bseq.data_ptr(), lens_a.data_ptr(),
            lens_b.data_ptr(), table.data_ptr(), gap_consts.data_ptr(),
            adj.data_ptr(), ckpt.data_ptr(), ptr(edge), ptr(gprog), B, NA, NB,
            k, Cp, band_rows, n_ckpt, table.numel(), int(launch.table_shared),
            launch.W, launch.warps, launch.pairs, launch.blocks, stream,
        )
    _build.check(rc, "wavefront_score_ckpt")
    CKPT_LAUNCHES += 1
    return adj, ckpt
