"""Plain PyTorch versions of the marginal Viterbi fill, the Forward fill and
the traceback walk.

Counterpart of coati_tpu/align/wavefront.py (viterbi, score and forward
modes, tropical and log semirings, any gap length k, whole matrix or one
segment of diagonals from a carried ring). These are the reference the CUDA kernels in
coati_tpu_torch/kernels are held against, and the path the kernel wrappers
take for tensors on the CPU. They keep the JAX version's layout and f32
operation order so that corners, backpointers and walks are bit-equal:

- cell (i, j) lives on anti-diagonal d = i + j at slot j, C = NB + k slots;
- the per-cell f32 op order is wavefront.py:182-195, the backpointer
  comparands :218-221, the terminal adjustment :253-255;
- the two margin formulas go + ge*(j-1) and (ng+go) + ge*(i-1) are computed
  in float64 and rounded once to float32. XLA:CPU contracts them into one
  single-rounded FMA, in the whole-matrix scan and in the segment form
  alike. The float64 product of an f32 and an integer below 2^24 is exact
  (48 bits), and so is the sum while it needs at most 53 bits: with the
  default gap parameters (ge = -0.18, a multiple of 2^-26; go and ng+go
  near -6.9, multiples of 2^-21) it needs 18 + 26 = 44 bits at i = 165,000
  and 50 at i = 2^24, so the one rounding to f32 gives the FMA's value.

In the log semiring (Forward) the sums are the reference's piecewise
logSumExp, lse: its exp and log1p differ in the last place between XLA:CPU,
torch on the CPU, torch on CUDA and a hand kernel, so Forward values are held
to a tolerance relative to their magnitude, never to bit-equality; every
other operation keeps the order above. Forward mode returns every cell's M,
D, I in row layout, mdi [B, R, C, 3] f32 with cell (i, j) at [p, i, j]: the
layout the sample walk reads (a cell's three values in one 12-byte load).

The backpointer output is [B, n_steps, C] uint8 (pair-major), row d - d_start
for diagonal d; the whole matrix has Dtot = NA+NB+2k-1 diagonals. Byte bits
0-1 / 2-3 / 4-5 hold the M / D / I predecessor state. The fill kernel's stack
is in row layout instead (kernels/wavefront_fill.py rows_from_diagonals);
traceback_rows_plain walks it.
"""

from __future__ import annotations

import numpy as np
import torch

from coati_tpu_torch.align.semiring import gap_constants
from coati_tpu_torch.constants import F32_LOWEST

LOWEST = float(np.float32(F32_LOWEST))


def gap_consts_array(gap) -> np.ndarray:
    """(no_gap, gap_stop, gap_open, gap_extend) as a [4] float32 array."""
    return np.array(gap_constants(gap.open, gap.extend), dtype=np.float32)


def _shift_right(x, s):
    """result[..., j] = x[..., j-s] with LOWEST fill."""
    if s == 0:
        return x
    pad = torch.full(x.shape[:-1] + (s,), LOWEST, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-s]], dim=-1)


def margin_values(base, ge, idx):
    """f32(base + ge*(idx - 1)) with one rounding: the value XLA:CPU's
    contracted FMA gives for the margin rows/columns (wavefront.py:154,160)."""
    return (base.double() + ge.double() * (idx.double() - 1.0)).float()


def argmax_mdi(m, d, i):
    """Reference max_mdi preference: M unless D strictly greater, I only if
    strictly greater than both. uint8 codes 0/1/2."""
    code = (d > m).to(torch.uint8)
    best = torch.maximum(m, d)
    return torch.where(i > best, torch.full_like(code, 2), code)


def lse(a, b):
    """f32 logSumExp in the reference's piecewise form (wavefront.py:56-66):
    max + exp(y) for y = -|a - b| <= -16, else max + log1p(exp(y))."""
    mx = torch.maximum(a, b)
    y = -(a - b).abs()
    t = torch.where(y <= -16.0, torch.exp(y),
                    torch.log1p(torch.exp(torch.clamp(y, max=0.0))))
    return mx + t


def _diagonal_step(aseq, bseq, table, gap_consts, *, k: int, semiring: str):
    """The recurrence on one anti-diagonal, shared by the whole-matrix fill
    and the band fill: step(d, prev2, prevk, want_code) -> (M, D, I, code),
    each [B, C] over slots j (cell (d - j, j)), from the (M, D, I) of
    diagonals d-2 (prev2) and d-k (prevk); the margins and LOWEST outside
    the matrix's rows are applied; code is the packed backpointer byte, or
    None without want_code."""
    plus2 = torch.maximum if semiring == "tropical" else lse
    B, NA = aseq.shape
    NB = bseq.shape[1]
    dev = aseq.device
    R = NA + k
    C = NB + k
    ng, gs, go, ge = (gap_consts[q] for q in range(4))
    gek1 = ge * float(k - 1)
    gek = ge * float(k)
    ngo = ng + go

    j_iota = torch.arange(C, device=dev)
    table_flat = table.reshape(-1)
    a_long = aseq.long()
    b_slot = torch.cat(
        [torch.zeros((B, k), dtype=torch.long, device=dev), bseq.long()], dim=1
    )  # [B, C]: b[j-k] at slot j >= k
    b_emit = b_slot < 15  # code 15 ('-') has no column: the one-hot sum gives 0
    # insert-row margin values and mask depend on j only
    i_marg_j = margin_values(go, ge, j_iota)
    ins_ok_j = (j_iota >= 2 * k - 1) & ((j_iota - (k - 1)) % k == 0)

    def step(d, prev2, prevk, want_code):
        i_vec = d - j_iota

        a_rows = a_long[:, (i_vec - k).clamp(0, NA - 1)]
        sub = torch.where(b_emit, table_flat[a_rows * 15 + b_slot.clamp(max=14)], 0.0)

        p2M = _shift_right(prev2[0], 1)
        p2D = _shift_right(prev2[1], 1)
        p2I = _shift_right(prev2[2], 1)
        pkM, pkD, pkI = prevk
        pkMs = _shift_right(pkM, k)
        pkIs = _shift_right(pkI, k)

        m2m = ((p2M + ng) + ng) + sub
        d2m = (p2D + gs) + sub
        i2m = ((p2I + gs) + ng) + sub
        m2d = ((pkM + ng) + go) + gek1
        i2d = ((pkI + gs) + go) + gek1
        d2d = pkD + gek
        m2i = (pkMs + go) + gek1
        i2i = pkIs + gek

        M = plus2(plus2(m2m, d2m), i2m)
        D = plus2(plus2(m2d, d2d), i2d)
        I = plus2(m2i, i2i)

        body = (i_vec >= k) & (i_vec < R) & (j_iota >= k)
        m_marg = torch.where((i_vec == k - 1) & (j_iota == k - 1), 0.0, LOWEST)
        i_marg = torch.where((i_vec == k - 1) & ins_ok_j, i_marg_j, LOWEST)
        del_ok = (j_iota == k - 1) & (i_vec >= 2 * k - 1) & ((i_vec - (k - 1)) % k == 0)
        d_marg = torch.where(del_ok, margin_values(ngo, ge, i_vec), LOWEST)
        M = torch.where(body, M, m_marg)
        D = torch.where(body, D, d_marg)
        I = torch.where(body, I, i_marg)

        code = None
        if want_code:
            bp_m = argmax_mdi((p2M + ng) + ng, p2D + gs, (p2I + gs) + ng)
            bp_d = argmax_mdi((pkM + ng) + go, pkD + ge, (pkI + gs) + go)
            bp_i = torch.where(pkMs + go > pkIs + ge, 0, 2).to(torch.uint8)
            code = bp_m | (bp_d << 2) | (bp_i << 4)
        return M, D, I, code

    return step


def wavefront_plain(aseq, bseq, lens_a, lens_b, table, gap_consts, *, k: int,
                    mode: str = "viterbi", semiring: str = "tropical",
                    d_start: int = 0,
                    n_steps: int | None = None, ring_init=None,
                    corner_init=None, return_carry: bool = False,
                    keep_rows=None):
    """Viterbi or Forward fill, one loop step per anti-diagonal: the whole
    matrix, or diagonals [d_start, d_start + n_steps) from a carried ring.

    aseq [B, NA] int (< table rows), bseq [B, NB] int (< 16), lens [B] int,
    table [rows, 15] f32, gap_consts [4] f32. mode "viterbi" also returns the
    packed backpointers bp [B, n_steps, C] uint8, mode "score" None in
    their place, mode "forward" (whole matrix only) every cell's values
    mdi [B, NA+k, C, 3] f32. semiring "tropical" adds with max, "log" with
    lse. ring_init [K, 3, B, C] f32 holds diagonals d_start-1 ..
    d_start-K (K = max(k, 2)), corner_init the raw corners (cM, cD, cI)
    captured so far; both default to LOWEST. keep_rows (mode "score" only):
    a list of n row indices, whose cells' (M, D, I) are returned in bp's
    place as kept [B, n, C, 3] f32 (the long path's checkpoint rows; the
    whole matrix is never held). Returns (adj, bp), adj the
    terminal-adjusted corners [B] f32 (meaningful once every pair's corner
    diagonal has run); with return_carry (adj, bp, (ring, raw corners)) to
    start the next segment from."""
    if mode not in ("viterbi", "score", "forward"):
        raise ValueError(
            f"mode must be 'viterbi', 'score' or 'forward', got {mode!r}")
    if semiring not in ("tropical", "log"):
        raise ValueError(f"semiring must be 'tropical' or 'log', got {semiring!r}")
    B, NA = aseq.shape
    NB = bseq.shape[1]
    dev = aseq.device
    R = NA + k
    C = NB + k
    Dtot = R + C - 1
    if n_steps is None:
        n_steps = Dtot
    if mode == "forward" and (d_start != 0 or n_steps != Dtot):
        raise ValueError("forward mode runs the whole matrix only")
    if keep_rows is not None and mode != "score":
        raise ValueError("keep_rows goes with mode 'score'")
    K = max(k, 2)
    step = _diagonal_step(aseq, bseq, table, gap_consts, k=k, semiring=semiring)
    j_iota = torch.arange(C, device=dev)
    corner_d = (lens_a + lens_b).long() + 2 * (k - 1)
    corner_j = (lens_b.long() + (k - 1))[:, None]

    empty = torch.full((B, C), LOWEST, dtype=torch.float32, device=dev)
    if ring_init is None:
        ring = [(empty, empty, empty)] * K  # ring[q] = diagonal d-1-q
    else:
        ring = [tuple(ring_init[q, s] for s in range(3)) for q in range(K)]
    if corner_init is None:
        cM = cD = cI = torch.full((B,), LOWEST, dtype=torch.float32, device=dev)
    else:
        cM, cD, cI = corner_init
    bp = None
    if mode == "viterbi":
        bp = torch.empty((B, n_steps, C), dtype=torch.uint8, device=dev)
    elif mode == "forward":  # mdi takes bp's place in what is returned
        bp = torch.empty((B, R, C, 3), dtype=torch.float32, device=dev)
    elif keep_rows is not None:
        # kept rows by slot, and one more slot that takes every other cell,
        # so the scatter below needs no mask (each slot j once a diagonal)
        n_keep = len(keep_rows)
        slot_of = torch.full((R + 1,), n_keep, dtype=torch.long, device=dev)
        slot_of[torch.as_tensor(keep_rows, dtype=torch.long, device=dev)] = \
            torch.arange(n_keep, device=dev)
        kept = torch.full((B, n_keep + 1, C, 3), LOWEST, dtype=torch.float32,
                          device=dev)

    for d in range(d_start, d_start + n_steps):
        M, D, I, code = step(d, ring[1], ring[k - 1], mode == "viterbi")

        sel = corner_d == d
        cM = torch.where(sel, M.gather(1, corner_j)[:, 0], cM)
        cD = torch.where(sel, D.gather(1, corner_j)[:, 0], cD)
        cI = torch.where(sel, I.gather(1, corner_j)[:, 0], cI)

        ring = [(M, D, I)] + ring[: K - 1]

        i_vec = d - j_iota
        if mode == "forward":
            in_rows = (i_vec >= 0) & (i_vec < R)
            bp[:, i_vec[in_rows], j_iota[in_rows]] = torch.stack(
                (M, D, I), dim=-1)[:, in_rows]
        elif mode == "viterbi":
            bp[:, d - d_start, :] = code
        elif keep_rows is not None:
            slot = slot_of[torch.where((i_vec >= 0) & (i_vec < R), i_vec, R)]
            kept[:, slot, j_iota] = torch.stack((M, D, I), dim=-1)

    if keep_rows is not None:
        bp = kept[:, :n_keep]
    adj = adjust_corners((cM, cD, cI), gap_consts)
    if return_carry:
        ring_arr = torch.stack([torch.stack(r, dim=0) for r in ring], dim=0)
        return adj, bp, (ring_arr, (cM, cD, cI))
    return adj, bp


def band_fill_plain(aseq, bseq, lens_a, lens_b, table, gap_consts, ckpt, *,
                    k: int, row0: int, band_rows: int):
    """The Viterbi fill with backpointers over one band of rows [row0, row0 +
    band_rows) of the whole matrix, from the k rows above it: bp [B,
    band_rows, row_stride] uint8 in row layout, cell (i, j) at [p, i - row0,
    j] (row_stride: C = NB + k rounded up to 16, the padding 0).

    ckpt [B, k, 3, Cp >= C] f32 holds (M, D, I) of rows row0 - k .. row0 - 1
    (the long path's checkpoint; None for row0 = 0, the top boundary). The
    band is swept by anti-diagonals, a step each, as wavefront_plain sweeps
    the matrix (a cell needs (i, j - k) of its own row, so a row is not one
    vector step): the diagonals that cross the checkpoint rows take those
    rows' values from it, so every band cell sees the whole fill's
    predecessors, and its byte is the whole fill's."""
    B, NA = aseq.shape
    NB = bseq.shape[1]
    dev = aseq.device
    C = NB + k
    Cp = -(-C // 16) * 16
    K = max(k, 2)
    r1 = row0 + band_rows
    if row0 > 0 and ckpt is None:
        raise ValueError("a band below row 0 starts from its checkpoint")
    step = _diagonal_step(aseq, bseq, table, gap_consts, k=k, semiring="tropical")
    j_iota = torch.arange(C, device=dev)
    empty = torch.full((B, C), LOWEST, dtype=torch.float32, device=dev)
    ring = [(empty, empty, empty)] * K  # ring[q] = diagonal d-1-q
    bp = torch.zeros((B, band_rows, Cp), dtype=torch.uint8, device=dev)
    first = row0 - k if row0 > 0 else 0
    for d in range(first, r1 - 1 + C):
        M, D, I, code = step(d, ring[1], ring[k - 1], True)
        i_vec = d - j_iota
        in_band = (i_vec >= row0) & (i_vec < r1)
        bp[:, (i_vec - row0).clamp(0, band_rows - 1)[in_band], j_iota[in_band]] = \
            code[:, in_band]
        if row0 > 0:  # the checkpoint's rows on this diagonal
            q = i_vec - (row0 - k)
            above = (q >= 0) & (q < k)
            qc = q.clamp(0, k - 1)
            M, D, I = (torch.where(above, ckpt[:, qc, s, j_iota], v)
                       for s, v in enumerate((M, D, I)))
        ring = [(M, D, I)] + ring[: K - 1]
    return bp
def adjust_corners(raw, gap_consts):
    """Terminal-state adjustment of raw corner scores (wavefront.py:253-255)."""
    cM, cD, cI = raw
    ng, gs = gap_consts[0], gap_consts[1]
    return (cM + ng) + ng, cD + gs, (cI + gs) + ng


def traceback_plain(bp, corners, lens_a, lens_b, *, k: int, max_steps: int):
    """Backward walk of every pair from its corner, all pairs one step per
    loop iteration (the while-loop form of traceback_ops_impl).

    bp [B, Dtot, C] uint8 in diagonal layout, from wavefront_plain or the
    segment kernel (kernels/wavefront_segment.py); the fill kernel's stack
    is in row layout and takes traceback_rows_plain. Returns
    (ops, score): ops [max_steps, B] int8, op codes 0=match 1=delete
    2=insert walking BACKWARD from the corner with -1 after each walk's
    end; score [B] f32 = max(cM, max(cD, cI))."""
    cM, cD, cI = corners
    B = cM.shape[0]
    dev = cM.device
    st = argmax_mdi(cM, cD, cI).long()
    score = torch.maximum(cM, torch.maximum(cD, cI))
    i = lens_a.long() + (k - 1)
    j = lens_b.long() + (k - 1)
    rows = torch.arange(B, device=dev)
    ops = torch.full((max_steps, B), -1, dtype=torch.int8, device=dev)
    for s in range(max_steps):
        active = (i > k - 1) | (j > k - 1)
        if not bool(active.any()):
            break
        code = bp[rows, i + j, j].long()
        nxt = (code >> (2 * st)) & 3
        di = torch.where(st == 0, 1, torch.where(st == 1, k, 0))
        dj = torch.where(st == 0, 1, torch.where(st == 1, 0, k))
        ops[s] = torch.where(active, st, -1).to(torch.int8)
        i = torch.where(active, i - di, i)
        j = torch.where(active, j - dj, j)
        st = torch.where(active, nxt, st)
    return ops, score


def traceback_rows_plain(bp, corners, lens_a, lens_b, *, k: int,
                         max_steps: int):
    """traceback_plain over a stack in row layout, bp [B, R, Cr] uint8 with
    cell (i, j) at [p, i, j] (kernels/wavefront_fill.py): the same walk, op
    for op."""
    cM, cD, cI = corners
    B = cM.shape[0]
    dev = cM.device
    st = argmax_mdi(cM, cD, cI).long()
    score = torch.maximum(cM, torch.maximum(cD, cI))
    i = lens_a.long() + (k - 1)
    j = lens_b.long() + (k - 1)
    rows = torch.arange(B, device=dev)
    ops = torch.full((max_steps, B), -1, dtype=torch.int8, device=dev)
    for s in range(max_steps):
        active = (i > k - 1) | (j > k - 1)
        if not bool(active.any()):
            break
        code = bp[rows, i, j].long()
        nxt = (code >> (2 * st)) & 3
        di = torch.where(st == 0, 1, torch.where(st == 1, k, 0))
        dj = torch.where(st == 0, 1, torch.where(st == 1, 0, k))
        ops[s] = torch.where(active, st, -1).to(torch.int8)
        i = torch.where(active, i - di, i)
        j = torch.where(active, j - dj, j)
        st = torch.where(active, nxt, st)
    return ops, score


def walk_init_plain(adj, lens_a, lens_b, *, k: int):
    """Start of the segmented walk: state [4, B] int32 = each pair's
    (i, j, st, s) at its corner with no op written, and score [B] f32, from
    the terminal-adjusted corners adj [3, B]."""
    cM, cD, cI = adj
    state = torch.stack([
        lens_a.to(torch.int32) + (k - 1),
        lens_b.to(torch.int32) + (k - 1),
        argmax_mdi(cM, cD, cI).to(torch.int32),
        torch.zeros_like(lens_a, dtype=torch.int32),
    ])
    return state, torch.maximum(cM, torch.maximum(cD, cI))


def walk_segment_plain(bp_seg, d0: int, state, ops, *, k: int, start=None):
    """Advance every pair's backward walk through one segment (counterpart
    of coati_tpu/align/longseq.py _walk_segment).

    bp_seg [B, T, C] uint8 holds diagonals [d0, d0 + T). A pair walks while
    its cell's diagonal i + j is at least d0, then parks until the segment
    below is supplied. Its ops go to ops[s] ([max_steps, B] int8, filled
    with -1 by the caller), each pair counting its own s, where the
    reference counts one s for the group and leaves -1 for parked pairs: the
    op sequences with the -1 dropped are the same. state and ops are
    updated in place.

    start: on the first call of a walk, (adj, lens_a, lens_b) as
    walk_init_plain takes them: every pair starts at its corner, whatever
    state holds. Returns (state, ops, score), score None without start."""
    B, T, _ = bp_seg.shape
    max_steps = ops.shape[0]
    score = None
    if start is not None:
        first, score = walk_init_plain(*start, k=k)
        state.copy_(first)
    i, j, st, s = (state[q].long() for q in range(4))
    rows = torch.arange(B, device=bp_seg.device)
    while True:
        active = (((i > k - 1) | (j > k - 1)) & (i + j >= d0) & (i + j - d0 < T)
                  & (s < max_steps))
        if not bool(active.any()):
            break
        code = bp_seg[rows, (i + j - d0).clamp(0, T - 1), j].long()
        nxt = (code >> (2 * st)) & 3
        di = torch.where(st == 0, 1, torch.where(st == 1, k, 0))
        dj = torch.where(st == 0, 1, torch.where(st == 1, 0, k))
        ops[s[active], rows[active]] = st[active].to(torch.int8)
        i = torch.where(active, i - di, i)
        j = torch.where(active, j - dj, j)
        st = torch.where(active, nxt, st)
        s = torch.where(active, s + 1, s)
    state.copy_(torch.stack([i, j, st, s]).to(torch.int32))
    return state, ops, score


def walk_band_plain(bp_band, row0: int, state, ops, *, k: int, start=None):
    """Advance every pair's backward walk through one band of rows (the long
    path's pass 2, band_fill_plain): bp_band [B, H, Cp] uint8 holds rows
    [row0, row0 + H) in row layout. A pair walks while its row i is in the
    band, then parks until the band below is supplied; a step of k rows may
    leave it. state [4, B] int32 = (i, j, st, s) and ops [max_steps, B] int8
    (filled with -1 by the caller) are updated in place, each pair counting
    its own s. start: on the first call of a walk, (adj, lens_a, lens_b) as
    walk_init_plain takes them. Returns (state, ops, score), score None
    without start. Op for op the walk of traceback_rows_plain."""
    B, H, _ = bp_band.shape
    max_steps = ops.shape[0]
    score = None
    if start is not None:
        first, score = walk_init_plain(*start, k=k)
        state.copy_(first)
    i, j, st, s = (state[q].long() for q in range(4))
    rows = torch.arange(B, device=bp_band.device)
    while True:
        active = (((i > k - 1) | (j > k - 1)) & (i >= row0) & (i - row0 < H)
                  & (j >= 0) & (s < max_steps))
        if not bool(active.any()):
            break
        code = bp_band[rows, (i - row0).clamp(0, H - 1), j.clamp(min=0)].long()
        nxt = (code >> (2 * st)) & 3
        di = torch.where(st == 0, 1, torch.where(st == 1, k, 0))
        dj = torch.where(st == 0, 1, torch.where(st == 1, 0, k))
        ops[s[active], rows[active]] = st[active].to(torch.int8)
        i = torch.where(active, i - di, i)
        j = torch.where(active, j - dj, j)
        st = torch.where(active, nxt, st)
        s = torch.where(active, s + 1, s)
    state.copy_(torch.stack([i, j, st, s]).to(torch.int32))
    return state, ops, score
