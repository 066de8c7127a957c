"""Wrappers of the traceback walk kernels (csrc/traceback_walk.cu).

Counterparts of coati_tpu/align/wavefront.py traceback_ops_impl (the walk
over a whole backpointer stack, here in the fill kernel's row layout) and
coati_tpu/align/longseq.py _walk_segment (the walk of long pairs, one
segment at a time: walk_segment over diagonals above k = 8, walk_band over
the row bands of the fill's long path up to it). CPU tensors take the plain
PyTorch versions (align/wavefront.py traceback_rows_plain,
walk_segment_plain, walk_band_plain); CUDA tensors launch the kernels or
raise.
"""

from __future__ import annotations

import torch

from coati_tpu_torch.align.wavefront import (
    traceback_rows_plain,
    walk_band_plain,
    walk_segment_plain,
)
from coati_tpu_torch.kernels import _build

LAUNCHES = 0  # kernel launches made by traceback_walk
SEGMENT_LAUNCHES = 0  # kernel launches made by walk_segment
BAND_LAUNCHES = 0  # kernel launches made by walk_band
SMEM_BYTES = 232_448  # dynamic shared memory one H100 block may use
# S, steps a window of the whole-stack walk serves, and warps (pairs) a block.
# On an H100 at the B = 64 cell (sweep_shapes.py fill): S = 16 0.17-0.18 ms,
# 32 0.152-0.153, 48 0.154-0.157, 64 0.163-0.166 at 1-4 warps a block; at the
# 1,500 nt launch 0.155, 0.140-0.141, 0.143, 0.147-0.148. Shorter windows do
# not hide the copy, longer ones copy more than they save; warps a block do
# not matter.
WINDOW_STEPS = 32
WALK_WARPS = 2
# S of the segment walk (a warp a pair, windows of diagonals): set by
# sweep_shapes.py segwalk.
SEGMENT_WINDOW_STEPS = 32
WINDOW_ROW_BYTES = 32 * 16  # a window row is at most 32 copies of 16 bytes


def window_steps(k: int) -> int:
    """S at gap length k: WINDOW_STEPS at k = 1, fewer at larger k so that a
    window of 2kS rows and columns stays near the size it has at k = 1."""
    return max(4, WINDOW_STEPS // k)


def window_bytes(k: int, S: int) -> int:
    """Shared memory one warp of the whole-stack walk takes: two windows of
    2kS + 1 rows of 2kS + 31 bytes rounded up to 16, and S staged ops."""
    H = 2 * k * S
    wb = -(-(H + 31) // 16) * 16
    return 2 * (H + 1) * wb + -(-S // 16) * 16


def segment_window_steps(k: int) -> int:
    """S of the segment walk at gap length k: SEGMENT_WINDOW_STEPS at k = 1,
    fewer at larger k, as window_steps, and no more than WALK_WARPS windows
    of rows of WINDOW_ROW_BYTES fit in a block."""
    S = max(4, SEGMENT_WINDOW_STEPS // k)
    while S > 1 and (WALK_WARPS * segment_window_bytes(k, S) > SMEM_BYTES
                     or segment_row_bytes(k, S) > WINDOW_ROW_BYTES):
        S -= 1
    return S


def segment_window_bytes(k: int, S: int) -> int:
    """Shared memory one warp of the segment walk takes: two windows of
    2 max(2, k) S + 1 diagonals of 2kS + 16 bytes rounded up to 16 (a row is
    copied from the 16-byte boundary below its first cell), and S staged
    ops."""
    Hd = 2 * max(k, 2) * S
    return 2 * (Hd + 1) * segment_row_bytes(k, S) + -(-S // 16) * 16


def segment_row_bytes(k: int, S: int) -> int:
    """Bytes of a row of a segment walk's window: the 2kS + 1 columns a
    window holds at an offset of up to 15, rounded up to 16."""
    return -(-(2 * k * S + 16) // 16) * 16


def _windows(k: int, S: int | None, warps: int) -> int:
    """S of a walk over rows (default window_steps(k)), checked: warps
    windows of it fit a block's shared memory and a window row fits
    WINDOW_ROW_BYTES."""
    S = window_steps(k) if S is None else S
    if (S < 1 or not 1 <= warps <= 32 or warps * window_bytes(k, S) > SMEM_BYTES
            or 2 * k * S + 31 > WINDOW_ROW_BYTES):
        raise ValueError(f"{warps} warps of windows for S={S} at k={k}: over "
                         f"{SMEM_BYTES} bytes of shared memory a block, or "
                         f"window rows over {WINDOW_ROW_BYTES} bytes")
    return S


def _check(bp, corners, lens_a, lens_b):
    B = lens_a.shape[0]
    if bp.dtype != torch.uint8 or bp.dim() != 3 or bp.shape[0] != B:
        raise ValueError(f"bp must be [B, R, Cp] uint8, got {tuple(bp.shape)} {bp.dtype}")
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


def traceback_walk(bp, corners, lens_a, lens_b, *, k: int, max_steps: int,
                   S: int | None = None, warps: int = WALK_WARPS):
    """Backward walk over a stack in row layout, bp [B, NA + k, Cp] uint8 as
    wavefront_fill returns it: (ops [max_steps, B] int8, score [B] f32) as
    traceback_rows_plain returns them. max_steps >= max(la + lb) holds every
    walk (a walk makes at most one op per consumed residue). S: steps a
    window serves (default window_steps(k)); warps: pairs a block."""
    global LAUNCHES
    _check(bp, corners, lens_a, lens_b)
    if bp.device.type == "cpu":
        return traceback_rows_plain(bp, corners, lens_a, lens_b, k=k,
                                    max_steps=max_steps)
    if bp.device.type != "cuda":
        raise ValueError(f"unsupported device {bp.device}")
    B, R, Cp = bp.shape
    if Cp % 16:
        raise ValueError(f"rows of the stack must be a multiple of 16 bytes, got {Cp}")
    S = _windows(k, S, warps)
    ops = torch.empty((max_steps, B), dtype=torch.int8, device=bp.device)
    score = torch.empty((B,), dtype=torch.float32, device=bp.device)
    lib = _build.load()
    with torch.cuda.device(bp.device):
        stream = torch.cuda.current_stream(bp.device).cuda_stream
        rc = lib.coati_traceback_walk(
            bp.data_ptr(), corners[0].data_ptr(), corners[1].data_ptr(),
            corners[2].data_ptr(), lens_a.data_ptr(), lens_b.data_ptr(),
            ops.data_ptr(), score.data_ptr(), B, R, Cp, k, max_steps, S,
            warps, stream,
        )
    _build.check(rc, "traceback_walk")
    LAUNCHES += 1
    return ops, score


def _check_start(start, B, dev):
    adj, lens_a, lens_b = start
    if adj.dtype != torch.float32 or tuple(adj.shape) != (3, B) or not adj.is_contiguous():
        raise ValueError(f"adj must be contiguous f32 [3, {B}], got "
                         f"{adj.dtype} {tuple(adj.shape)}")
    for name, t in (("lens_a", lens_a), ("lens_b", lens_b)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 [{B}]")
    for name, t in (("adj", adj), ("lens_a", lens_a), ("lens_b", lens_b)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the stack on {dev}")


def walk_segment(bp_seg, d0: int, state, ops, *, k: int, start=None,
                 S: int | None = None, warps: int = WALK_WARPS):
    """Advance every pair's walk through the segment bp_seg [B, T, C] uint8
    of diagonals [d0, d0 + T), as walk_segment_plain does: state [4, B] int32
    = each pair's (i, j, st, s) and ops [max_steps, B] int8 are updated in
    place. The segments are supplied last to first.

    start: on the first launch of a walk, (adj [3, B] f32 terminal-adjusted
    corners, lens_a, lens_b): every pair starts at its corner with no op
    written, whatever state holds. S: steps a window serves (default
    segment_window_steps(k)); warps: pairs a block. Returns (state, ops,
    score): score [B] f32 = max of the corners with start, else None."""
    global SEGMENT_LAUNCHES
    if bp_seg.dtype != torch.uint8 or bp_seg.dim() != 3 or not bp_seg.is_contiguous():
        raise ValueError(f"bp_seg must be contiguous [B, T, C] uint8, got "
                         f"{tuple(bp_seg.shape)} {bp_seg.dtype}")
    B, T, C = bp_seg.shape
    dev = bp_seg.device
    _check_state(state, ops, B, dev, "bp_seg")
    if start is not None:
        _check_start(start, B, dev)
    if dev.type == "cpu":
        return walk_segment_plain(bp_seg, d0, state, ops, k=k, start=start)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    S = segment_window_steps(k) if S is None else S
    if (S < 1 or not 1 <= warps <= 32
            or warps * segment_window_bytes(k, S) > SMEM_BYTES
            or segment_row_bytes(k, S) > WINDOW_ROW_BYTES):
        raise ValueError(f"{warps} warps of segment windows for S={S} at k={k}: "
                         f"over {SMEM_BYTES} bytes of shared memory a block, or "
                         f"window rows over {WINDOW_ROW_BYTES} bytes")
    score = None
    first = (None, None, None, None)
    if start is not None:
        score = torch.empty((B,), dtype=torch.float32, device=dev)
        first = tuple(t.data_ptr() for t in (*start, score))
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.coati_traceback_walk_segment(
            bp_seg.data_ptr(), *first, state.data_ptr(), ops.data_ptr(),
            B, T, C, k, d0, ops.shape[0], S, warps, stream,
        )
    _build.check(rc, "walk_segment")
    SEGMENT_LAUNCHES += 1
    return state, ops, score


def _check_state(state, ops, B, dev, what):
    for name, t, dtype, shape in (("state", state, torch.int32, (4, B)),
                                  ("ops", ops, torch.int8, (ops.shape[0], B))):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, {what} on {dev}")


def walk_band(bp_band, row0: int, state, ops, *, k: int, start=None,
              S: int | None = None, warps: int = WALK_WARPS):
    """Advance every pair's walk through one band of rows, bp_band [B, H, Cp]
    uint8 holding rows [row0, row0 + H) in row layout (the long path's pass
    2, wavefront_fill.wavefront_fill_band), as walk_band_plain does: state [4,
    B] int32 = each pair's (i, j, st, s) and ops [max_steps, B] int8 (filled
    with -1 beforehand) are updated in place. The bands are supplied last to
    first; a pair walks while its row is in the band. start, S and warps as
    walk_segment's (S defaults to window_steps(k), the whole-stack walk's).
    Returns (state, ops, score)."""
    global BAND_LAUNCHES
    if bp_band.dtype != torch.uint8 or bp_band.dim() != 3 or not bp_band.is_contiguous():
        raise ValueError(f"bp_band must be contiguous [B, H, Cp] uint8, got "
                         f"{tuple(bp_band.shape)} {bp_band.dtype}")
    B, H, Cp = bp_band.shape
    dev = bp_band.device
    _check_state(state, ops, B, dev, "bp_band")
    if start is not None:
        _check_start(start, B, dev)
    if dev.type == "cpu":
        return walk_band_plain(bp_band, row0, state, ops, k=k, start=start)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if Cp % 16 or row0 < 0:
        raise ValueError(f"rows of the band must be a multiple of 16 bytes and "
                         f"row0 >= 0, got {Cp} and {row0}")
    S = _windows(k, S, warps)
    score = None
    first = (None, None, None, None)
    if start is not None:
        score = torch.empty((B,), dtype=torch.float32, device=dev)
        first = tuple(t.data_ptr() for t in (*start, score))
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.coati_traceback_walk_band(
            bp_band.data_ptr(), *first, state.data_ptr(), ops.data_ptr(),
            B, H, Cp, k, row0, ops.shape[0], S, warps, stream,
        )
    _build.check(rc, "walk_band")
    BAND_LAUNCHES += 1
    return state, ops, score
