"""The triplet traceback walk: plain version and wrapper of the kernel
(csrc/triplet_walk.cu).

Counterpart of coati_tpu/kernels/triplet_pallas.py triplet_walk_pallas and of
the scan it replaces, coati_tpu/triplet_wavefront.py _triplet_walk_seg_xla:
the walk over S codon blocks, top to bottom, with every pair's (i, j, state)
carried in and out, so it serves the whole walk and the segments of a long
pair alike. Per block: bind the descendant-codon lane from the forward's
argmax lanes, compute the block's three rows again for that one lane, then six
phases (insertion run, down-step, three times).

CPU tensors take triplet_walk_plain at any launch; CUDA tensors launch the
kernel or raise.

The kernel runs a block a pair, or (the band route) a thread block cluster
of up to 8 blocks a pair, one pass of the row a block. Each thread holds R
adjacent columns, a pass R x T columns. What the walk reads of a block's
rows, each down-step's next state as a code and each row's run-exit index,
stays in shared memory over a window of Wc columns up to j (the whole row
where it fits; on the band route each block's band), the columns left of it
in a device scratch (csrc/triplet_walk.cu). walk_shape picks (R, T, Wc,
bands) from B, Cc and the card; `launch=walk_launch(...)` forces a shape.
Results do not depend on it.

The op rows are the reference's: row 6 t + phase of `ops` holds op | count <<
2 for codon block t, phases in the walk's order (0: insertion run at row 3, 1:
step to row 2, 2: run at row 2, 3: step to row 1, 4: run at row 1, 5: step to
the boundary); triplet_wavefront._decode_ops reads them and skips count 0.
"""

from __future__ import annotations

import dataclasses

import torch

from coati_tpu_torch.kernels import _build
from coati_tpu_torch.kernels.triplet_rows import NEG, _Rows, emissions

LAUNCHES = 0  # kernel launches made by triplet_walk
COLS = (1, 2, 4, 8)  # columns a thread the kernel is compiled for
THREADS = 512  # threads a block at most; 256 at 8 columns a thread
# the shared memory layout of csrc/triplet_walk.cu: the entry-cost table,
# match_emit, two scan buffers, the pass carry (f32), then per window column
# three run-exit indices (int32) and three step codes (a byte each), then the
# next block's lanes, 3 x LANE_WINDOW bytes
FIXED_BYTES = 4 * (61 * 64 + 32 + 2 * 16 * 6 + 16 + 2 * 8)
COL_BYTES = 3 * 4 + 3
LANE_WINDOW = 64
SCRATCH_ROWS = 6  # int32 rows a pair left of the window: three code rows, three exit rows
MAX_BANDS = 8  # blocks a pair at most on the band route: a portable cluster


def walk_smem_bytes(window: int) -> int:
    """Dynamic shared memory of a block at a window of `window` columns."""
    return FIXED_BYTES + COL_BYTES * window + 3 * LANE_WINDOW


@dataclasses.dataclass(frozen=True)
class WalkLaunch:
    """How the walk is launched: `cols` adjacent columns a thread, `threads`
    a block, a window of `window` columns in shared memory (a multiple of
    4; rows wider than it keep a device scratch), and `bands` blocks a pair
    (more than 1: a cluster, a band of one pass a block)."""

    cols: int
    threads: int
    window: int
    bands: int = 1

    def scratch(self, Cc: int) -> bool:
        """Whether rows of Cc columns need the device scratch."""
        return self.bands == 1 and self.window < Cc


def walk_launch(Cc: int, cols: int, threads: int, window: int | None = None,
                bands: int = 1) -> WalkLaunch:
    """A launch at `cols` columns a thread and `threads` a block, its window
    the whole row of Cc columns (rounded up to 4) unless given; with bands
    > 1, that many blocks a pair, the window a band of cols x threads.
    Raises on a shape the kernel does not take."""
    if cols not in COLS or threads < 32 or threads % 32 or threads > THREADS or (
            cols == 8 and threads > THREADS // 2):
        raise ValueError(f"{cols} columns x {threads} threads: the walk takes "
                         f"{COLS} columns a thread and 32-{THREADS} threads, a "
                         f"multiple of 32 ({THREADS // 2} at 8 columns)")
    if not 1 <= bands <= MAX_BANDS or (bands > 1 and bands * cols * threads < Cc):
        raise ValueError(f"{bands} bands of {cols} x {threads} columns: 1 to "
                         f"{MAX_BANDS} bands a pair, which cover its {Cc} columns")
    if window is None:
        window = cols * threads if bands > 1 else -(-Cc // 4) * 4
    if window < 4 or window % 4 or (bands > 1 and window < cols * threads):
        raise ValueError(f"a window of {window} columns: a multiple of 4 is needed, "
                         f"a band's at least on the band route")
    return WalkLaunch(cols, threads, window, bands)


def smem_limit() -> int:
    """The most dynamic shared memory a block of the current card may take."""
    n = _build.load().coati_triplet_walk_smem_limit()
    if n < 1:
        raise RuntimeError("triplet_walk: no shared memory limit from the card")
    return n


def walk_shape(B: int, Cc: int, device) -> WalkLaunch:
    """The launch for B pairs of Cc columns. One block a pair, 2 columns a
    thread and the fewest threads, up to 512, that cover the row in one
    pass (passes of 1,024 columns above), the whole row in the window where
    it fits the card's shared memory, else the widest window that does. A
    row of more than 4 such passes, up to 16,384 columns, takes the band
    route where all B pairs' bands fit the SMs at once: bands of 2 x 512
    columns up to 8,192 columns, of 8 x 256 above. Rows that set this
    (sweep_shapes.py triplet; PERF.md section 6), ms on an H100: 16 x 2,997
    nt 7.01 at one block (3 passes), 8.45 at 6 bands; a lone 6,000 nt pair
    21.1 at one block, 18.1 at 6 bands; the 15,000 nt pair 105.2 at one
    block, 57.1 at 8 bands of 8 x 256."""
    passes = -(-Cc // 1024)
    if passes > 4 and Cc <= MAX_BANDS * 2048:
        cols, threads = (2, 512) if Cc <= MAX_BANDS * 1024 else (8, 256)
        bands = -(-Cc // (cols * threads))
        if B * bands <= torch.cuda.get_device_properties(device).multi_processor_count:
            return walk_launch(Cc, cols, threads, bands=bands)
    with torch.cuda.device(device):
        limit = smem_limit()
    whole = -(-Cc // 4) * 4
    window = whole if walk_smem_bytes(whole) <= limit else (
        (limit - walk_smem_bytes(0)) // COL_BYTES // 4 * 4)
    return walk_launch(Cc, 2, min(THREADS, -(-Cc // 64) * 32), window)


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
                 state, ops, logP64, match_emit, gc, *, launch: WalkLaunch | None = None,
                 stamps=None):
    """Walk codon blocks t_lo + S - 1 .. t_lo; arguments and results as
    triplet_walk_plain's. On CUDA a pair reads only its own columns 0..j of
    the boundaries and lanes, so what triplet_rows left uninitialized is
    never touched. launch: the kernel's shape (default walk_shape). stamps:
    None, or an int64 [B, S, 5] tensor on the card that takes each active
    block's clocks (cycles) at its start, its first row, the end of its
    passes, the walk's start and end."""
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
    launch = launch or walk_shape(B, m + 1, dev)
    lib = _build.load()
    theirs = lib.coati_triplet_walk_smem_bytes(launch.window)
    if theirs != walk_smem_bytes(launch.window):
        raise RuntimeError(f"triplet_walk: the library lays out {theirs} bytes of shared "
                           f"memory and {walk_smem_bytes(launch.window)} here: the two "
                           f"layouts differ")
    if stamps is not None and (stamps.dtype != torch.int64 or tuple(stamps.shape) != (B, S, 5)
                               or stamps.device != dev or not stamps.is_contiguous()):
        raise ValueError(f"stamps must be contiguous int64 ({B}, {S}, 5) on {dev}")
    scratch = None
    if launch.scratch(m + 1):
        scratch = torch.empty((B, SCRATCH_ROWS, m + 1), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.coati_triplet_walk(
            grid_seg.data_ptr(), amax_seg.data_ptr(), anc_seg.data_ptr(),
            des_codes.data_ptr(), ins_off.data_ptr(), logP64.data_ptr(),
            match_emit.data_ptr(), gc.data_ptr(), state.data_ptr(),
            ops.data_ptr(), None if scratch is None else scratch.data_ptr(),
            None if stamps is None else stamps.data_ptr(), B, m, S, t_lo, launch.cols,
            launch.threads, launch.window, launch.bands, stream,
        )
    _build.check(rc, "triplet_walk")
    LAUNCHES += 1
    return state, ops
