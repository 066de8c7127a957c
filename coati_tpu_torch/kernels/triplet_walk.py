"""The triplet traceback walk: plain version and wrapper of the kernel
(csrc/triplet_walk.cu).

Counterpart of coati_tpu/kernels/triplet_pallas.py triplet_walk_pallas and of
the scan it replaces, coati_tpu/triplet_wavefront.py _triplet_walk_seg_xla:
the walk over S codon blocks, top to bottom, with every pair's (i, j, state)
carried in and out, so it serves the whole walk and the segments of a long
pair alike. Per block: bind the descendant-codon lane from the forward's
argmax lanes, compute the block's three rows again for that one lane, then six
phases (insertion run, down-step, three times).

CPU tensors take triplet_walk_plain; CUDA tensors launch the kernel or raise.

The op rows are the reference's: row 6 t + phase of `ops` holds op | count <<
2 for codon block t, phases in the walk's order (0: insertion run at row 3, 1:
step to row 2, 2: run at row 2, 3: step to row 1, 4: run at row 1, 5: step to
the boundary); triplet_wavefront._decode_ops reads them and skips count 0.
"""

from __future__ import annotations

import torch

from coati_tpu_torch.kernels import _build
from coati_tpu_torch.kernels.triplet_rows import (
    NEG,
    _Rows,
    block_threads,
    emissions,
)

LAUNCHES = 0  # kernel launches made by triplet_walk


def _sel(plane, col, fill):
    """plane[b, col[b]] as the reference's one-hot select (mask, then max
    with `fill`) gives it: max(value, fill), and fill where col is outside
    the row."""
    n = plane.shape[1]
    inside = (col >= 0) & (col < n)
    v = plane.gather(1, col.clamp(0, n - 1)[:, None])[:, 0]
    return torch.where(inside, v.clamp(min=fill), fill)


def _amax_pref(a, b, c):
    """M unless D is strictly greater; I only if strictly greater than both."""
    code = (b > a).long()
    return torch.where(c > torch.maximum(a, b), 2, code)


def triplet_walk_plain(grid_seg, amax_seg, anc_seg, des_codes, ins_off,
                       t_lo: int, state, ops, logP64, match_emit, gc):
    """Plain version: walk codon blocks t_lo + S - 1 .. t_lo, S =
    amax_seg.shape[0].

    grid_seg [>= S, 3, B, Cc] f32: boundary t_lo + t at row t, the base of
    block t; amax_seg [S, 3, B, Cc] uint8: the argmax lanes at boundary t_lo +
    t + 1, its top; anc_seg [B, S] int32; des_codes, ins_off, logP64,
    match_emit, gc as triplet_rows_plain's. state [3, B] int32 (i, j, st) and
    ops [6 * n_cod, B] int32 are updated in place (rows 6 t_lo .. 6 (t_lo +
    S) - 1 of ops are written) and returned."""
    S = amax_seg.shape[0]
    B = des_codes.shape[0]
    rows = _Rows(ins_off, gc)
    E = emissions(des_codes, match_emit)  # [B, 4, Cc]
    Cc = E.shape[2]
    i, j, st = (state[q].long() for q in range(3))
    for t in range(S - 1, -1, -1):
        base_i = 3 * (t_lo + t)
        Mr, Dr, Ir = grid_seg[t, 0], grid_seg[t, 1], grid_seg[t, 2]
        # bind each active pair's lane at the block's top boundary
        am = amax_seg[t].long()
        am_st = torch.where((st == 0)[:, None], am[0],
                            torch.where((st == 1)[:, None], am[1], am[2]))
        lane = _sel(am_st, j, 0)
        cost_row = logP64[anc_seg[:, t].long()]  # [B, 64]
        cost_s = _sel(cost_row, lane, NEG)[:, None]

        def e_at(x):
            return E.gather(1, x[:, None, None].expand(B, 1, Cc))[:, 0]

        e1, e2, e3 = e_at((lane >> 4) & 3), e_at((lane >> 2) & 3), e_at(lane & 3)
        M1 = rows.shiftmax3(Mr, Dr, Ir) + e1
        D1 = rows.dmax3(Mr, Dr, Ir)
        I1 = rows.row_ins(M1)
        M2 = rows.shiftmax3(M1, D1, I1) + e2
        D2 = rows.dmax3(M1, D1, I1)
        I2 = rows.row_ins(M2)
        # phase 3 carries the lane's entry cost: core3 + (cost + e3)
        M3 = rows.shiftmax3(M2, D2, I2) + (cost_s + e3)
        D3 = rows.dmax3(M2, D2, I2) + cost_s
        I3 = rows.row_ins(M3)
        rows_M, rows_D, rows_I = (M1, M2, M3), (D1, D2, D3), (I1, I2, I3)
        u_iota = torch.arange(Cc, device=Mr.device)[None, :]

        for ph in range(6):
            act = (i > base_i) & ((i > 0) | (j > 0))
            if ph % 2 == 0:
                # an insertion run at row 3 - ph // 2 ends in one phase: at
                # the last column u <= j - 1 where the literal f32 test
                # (M[u] + go) > (I[u] + ge) holds; 0 when none does
                r = 2 - ph // 2
                run_here = act & (st == 2)
                exit_ok = (rows_M[r] + rows.go) > (rows_I[r] + rows.ge)
                ucol = torch.cummax(torch.where(exit_ok, u_iota, -1), dim=1).values
                u = _sel(ucol, j - 1, 0)
                cnt = torch.where(run_here, j - u, 0)
                ops[6 * (t_lo + t) + ph] = (2 | (cnt << 2)).to(torch.int32)
                j = torch.where(run_here, u, j)
                st = torch.where(run_here, 0, st)
            else:
                # one M or D down-step; it reads the row below (for the last
                # step the boundary, where the entry cost is common to all)
                rb = 1 - ph // 2
                pj = j - (st == 0).long()
                if ph < 5:
                    Mv, Dv, Iv = rows_M[rb], rows_D[rb], rows_I[rb]
                else:
                    Mv, Dv, Iv = Mr, Dr, Ir
                mv, dv, iv = _sel(Mv, pj, NEG), _sel(Dv, pj, NEG), _sel(Iv, pj, NEG)
                nxt_m = _amax_pref(mv + rows.ng_ng, dv + rows.gs, iv + rows.gs_ng)
                nxt_d = _amax_pref(mv + rows.ng_go, dv + rows.ge, iv + rows.gs_go)
                nxt = torch.where(st == 0, nxt_m, nxt_d)
                ops[6 * (t_lo + t) + ph] = (st | (act.long() << 2)).to(torch.int32)
                i = torch.where(act, i - 1, i)
                j = torch.where(act, pj, j)
                st = torch.where(act, nxt, st)
    state[0], state[1], state[2] = i, j, st
    return state, ops


def _check(grid_seg, amax_seg, anc_seg, des_codes, ins_off, state, ops,
           logP64, match_emit, gc):
    B, m = des_codes.shape
    S = amax_seg.shape[0]
    dev = des_codes.device
    if grid_seg.dim() != 4 or grid_seg.shape[0] < S:
        raise ValueError(f"grid_seg must hold at least {S} boundaries, got "
                         f"{tuple(grid_seg.shape)}")
    if ops.dim() != 2 or ops.shape[0] % 6:
        raise ValueError(f"ops must be [6 * n_cod, B], got {tuple(ops.shape)}")
    want = (("grid_seg", grid_seg, torch.float32, (grid_seg.shape[0], 3, B, m + 1)),
            ("amax_seg", amax_seg, torch.uint8, (S, 3, B, m + 1)),
            ("anc_seg", anc_seg, torch.int32, (B, S)),
            ("des_codes", des_codes, torch.int32, (B, m)),
            ("ins_off", ins_off, torch.float32, (B, m + 1)),
            ("state", state, torch.int32, (3, B)),
            ("ops", ops, torch.int32, (ops.shape[0], B)),
            ("logP64", logP64, torch.float32, (61, 64)),
            ("match_emit", match_emit, torch.float32, (4, 5)),
            ("gc", gc, torch.float32, (4,)))
    for name, t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, des_codes on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def triplet_walk(grid_seg, amax_seg, anc_seg, des_codes, ins_off, t_lo: int,
                 state, ops, logP64, match_emit, gc):
    """Walk codon blocks t_lo + S - 1 .. t_lo; arguments and results as
    triplet_walk_plain's. On CUDA a pair reads only its own columns 0..j of
    the boundaries and lanes, so what triplet_rows left uninitialized is
    never touched."""
    global LAUNCHES
    _check(grid_seg, amax_seg, anc_seg, des_codes, ins_off, state, ops,
           logP64, match_emit, gc)
    B, m = des_codes.shape
    S = amax_seg.shape[0]
    dev = des_codes.device
    if t_lo < 0 or 6 * (t_lo + S) > ops.shape[0]:
        raise ValueError(f"blocks {t_lo}..{t_lo + S - 1} lie outside ops' "
                         f"{ops.shape[0] // 6} blocks")
    if dev.type == "cpu":
        return triplet_walk_plain(grid_seg, amax_seg, anc_seg, des_codes,
                                  ins_off, t_lo, state, ops, logP64,
                                  match_emit, gc)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    scratch = torch.empty((B, 9, m + 1), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.coati_triplet_walk(
            grid_seg.data_ptr(), amax_seg.data_ptr(), anc_seg.data_ptr(),
            des_codes.data_ptr(), ins_off.data_ptr(), logP64.data_ptr(),
            match_emit.data_ptr(), gc.data_ptr(), state.data_ptr(),
            ops.data_ptr(), scratch.data_ptr(), B, m, S, t_lo,
            block_threads(m + 1), stream,
        )
    _build.check(rc, "triplet_walk")
    LAUNCHES += 1
    return state, ops
