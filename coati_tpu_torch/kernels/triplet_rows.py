"""The triplet forward rows: plain version and wrapper of the kernel
(csrc/triplet_rows.cu).

Counterpart of coati_tpu/kernels/triplet_pallas.py triplet_rows_pallas and of
the scan it replaces, coati_tpu/triplet_wavefront.py _triplet_rows_carry: the
max-plus forward of the codon-context pair-HMM as a row sweep over codon
steps, the 61 descendant-codon lanes factored into 4 + 16 + 16 row variants
(triplet_hmm._DP), from a carried collapsed boundary. Every f32 add keeps the
reference's grouping and every argmax its first-maximum rule, so boundary rows
and argmax lanes are the reference's bits.

CPU tensors take triplet_rows_plain; CUDA tensors launch the kernel or raise.

The kernel cuts a pair's columns into bands of whole tiles, one block a band,
the bands running the codon steps as a pipeline (csrc/triplet_rows.cu).
rows_shape picks bands a pair and threads a band from B, Cc and the blocks
the card holds at once; `launch=rows_launch(...)` forces a shape. Results do
not depend on it.

Layout (the reference's): boundary rows [S, 3, B, Cc] f32 with the states in
the order M, D, I and Cc = m + 1 columns; the argmax lanes in the same shape
as uint8 (codon64 values, x1 * 16 + x2 * 4 + x3, are below 64: 15 bytes a cell
where int32 lanes would make it 24); a carry is one boundary, [3, B, Cc].
"""

from __future__ import annotations

import dataclasses

import torch

from coati_tpu_torch.kernels import _build

NEG = -1.0e30
LAUNCHES = 0  # kernel launches made by triplet_rows
# threads a block at most (the most the rows kernel is compiled for): one
# column each, a tile at a time
THREADS = 512
RECORD = 72  # f32 slots of a band's record of one step (csrc/triplet_rows.cu kRecord)
# F: records of each band boundary's ring. A band runs about a step behind
# its left neighbour, so a few slots keep back-pressure from binding.
RECORD_SLOTS = 8


def emissions(des_codes, match_emit):
    """E [B, 4, Cc] f32: E[b, x, j] is the match emission of intermediate
    nucleotide x against des[b, j - 1]; column 0 emits nothing."""
    B = des_codes.shape[0]
    body = match_emit[:4][:, des_codes.long()].permute(1, 0, 2)  # [B, 4, m]
    zero = torch.zeros((B, 4, 1), dtype=torch.float32, device=des_codes.device)
    return torch.cat([zero, body], dim=2)


def gap_composites(gc):
    """The sums of gap constants the recurrence uses, each formed once in
    f32 as the reference forms them: (ng_ng, gs_ng, ng_go, gs_go, go_ge)."""
    ng, gs, go, ge = gc[0], gc[1], gc[2], gc[3]
    return ng + ng, gs + ng, ng + go, gs + go, go - ge


def first_max(vals, dim: int):
    """(maximum along dim, index of the first element equal to it): the
    reference's tie rule written out, not left to a library's argmax."""
    top = vals.amax(dim=dim, keepdim=True)
    n = vals.shape[dim]
    shape = [1] * vals.dim()
    shape[dim] = n
    idx = torch.arange(n, device=vals.device).view(shape)
    first = torch.where(vals == top, idx, n).amin(dim=dim)
    return top.squeeze(dim), first


def _col(B, value, dtype, device):
    return torch.full((B, 1), value, dtype=dtype, device=device)


class _Rows:
    """The row operators of one batch: shifts and maxima over the last axis,
    shared by the forward rows and the walk's single-lane recompute."""

    def __init__(self, ins_off, gc):
        self.off = ins_off
        self.gs, self.go, self.ge = gc[1], gc[2], gc[3]
        (self.ng_ng, self.gs_ng, self.ng_go, self.gs_go,
         self.go_ge) = gap_composites(gc)

    def shiftmax3(self, M, D, I):
        """max3(M[j-1] + ng_ng, D[j-1] + gs, I[j-1] + gs_ng); NEG at j = 0."""
        body = torch.maximum(
            torch.maximum(M[..., :-1] + self.ng_ng, D[..., :-1] + self.gs),
            I[..., :-1] + self.gs_ng)
        pad = torch.full_like(M[..., :1], NEG)
        return torch.cat([pad, body], dim=-1)

    def dmax3(self, M, D, I):
        return torch.maximum(torch.maximum(M + self.ng_go, D + self.ge),
                             I + self.gs_go)

    def row_ins(self, M):
        """The in-row insertion recurrence by its prefix-max closed form:
        I[j] = max_{u<j}(M[u] - off[u]) + (off[j] + (go - ge)); NEG at 0."""
        off = self.off if M.dim() == 2 else self.off[:, None, :]
        run = torch.cummax(M - off, dim=-1).values
        pad = torch.full_like(M[..., :1], NEG)
        return torch.cat([pad, run[..., :-1] + (off[..., 1:] + self.go_ge)],
                         dim=-1)


def triplet_rows_plain(anc_cods, des_codes, ins_off, logP64, match_emit, gc,
                       carry, *, keep_grid: bool = True, steps=None):
    """Plain version: S = anc_cods.shape[1] codon steps from `carry`.

    anc_cods [B, S] int32 codon61 indices; des_codes [B, m] int32 in [0, 5)
    (4 = N); ins_off [B, m + 1] f32 insertion run offsets, a host numpy
    cumsum; logP64 [61, 64] f32 entry costs by codon64 lane (NEG at stops);
    match_emit [4, 5] f32; gc [4] f32 (ng, gs, go, ge); carry [3, B, Cc].

    Returns (boundaries [S, 3, B, Cc] f32, argmax lanes [S, 3, B, Cc] uint8,
    carry out [3, B, Cc]); the first two None with keep_grid=False. Every
    slot of the padded batch is computed, as the reference's scan does.
    steps [B], when given, is the number of steps pair b really has: its
    carry out is the boundary after that many (the rows go on regardless)."""
    B, S = anc_cods.shape
    Cc = des_codes.shape[1] + 1
    dev = des_codes.device
    ops = _Rows(ins_off, gc)
    E = emissions(des_codes, match_emit)  # [B, 4, Cc]
    off3 = ins_off[:, None, :]
    u_iota = torch.arange(Cc, device=dev)[None, :]
    neg_col = _col(B, NEG, torch.float32, dev)
    inf_col = _col(B, float("-inf"), torch.float32, dev)
    zero_col = _col(B, 0, torch.int64, dev)

    Mc, Dc, Ic = carry[0], carry[1], carry[2]
    out_carry = carry.clone()
    rows, lanes = [], []
    for t in range(S):
        cost = logP64[anc_cods[:, t].long()].reshape(B, 16, 4)
        core1 = ops.shiftmax3(Mc, Dc, Ic)                        # [B, Cc]
        M1 = core1[:, None, :] + E                               # [B, 4, Cc]
        D1 = ops.dmax3(Mc, Dc, Ic)
        I1 = ops.row_ins(M1)
        D1b = D1[:, None, :].expand_as(M1)
        core2 = ops.shiftmax3(M1, D1b, I1)
        M2 = (core2[:, :, None, :] + E[:, None]).reshape(B, 16, Cc)
        D2 = ops.dmax3(M1, D1b, I1)                              # [B, 4, Cc]
        I2 = ops.row_ins(M2)
        D2g = D2.repeat_interleave(4, dim=1)                     # [B, 16, Cc]
        core3 = ops.shiftmax3(M2, D2g, I2)
        D3 = ops.dmax3(M2, D2g, I2)
        ce = cost[:, :, :, None] + E[:, None, :, :]              # [B, 16, 4, Cc]
        K, Kpay = first_max(ce, 2)                               # first-max x3
        Mlane = core3 + K
        KD, KDpay = first_max(cost, 2)                           # [B, 16]
        Dlane = D3 + KD[:, :, None]

        Mc, gM = first_max(Mlane, 1)
        amaxM = gM * 4 + Kpay.gather(1, gM[:, None, :])[:, 0]
        Dc, gD = first_max(Dlane, 1)
        amaxD = gD * 4 + KDpay.gather(1, gD)
        Wstar, gW = first_max(Mlane - off3, 1)
        lane_at_u = gW * 4 + Kpay.gather(1, gW[:, None, :])[:, 0]
        run = torch.cummax(Wstar, dim=1).values
        Ic = torch.cat([neg_col, run[:, :-1] + (ins_off[:, 1:] + ops.go_ge)], dim=1)
        # the I lane: the earliest column that reaches the running maximum
        newmax = Wstar > torch.cat([inf_col, run[:, :-1]], dim=1)
        code = torch.where(newmax, u_iota * 64 + lane_at_u, -1)
        code_run = torch.cummax(code, dim=1).values
        amaxI = torch.cat([zero_col, code_run[:, :-1] % 64], dim=1)
        row = torch.stack([Mc, Dc, Ic])
        out_carry = row if steps is None else torch.where(
            (steps > t)[None, :, None], row, out_carry)
        if keep_grid:
            rows.append(row)
            lanes.append(torch.stack([amaxM, amaxD, amaxI]).to(torch.uint8))
    if not keep_grid:
        return None, None, out_carry
    return torch.stack(rows), torch.stack(lanes), out_carry


def _check(anc_cods, des_codes, ins_off, steps, lens_m, logP64, match_emit,
           gc, carry):
    B, m = des_codes.shape
    dev = des_codes.device
    want = (("anc_cods", anc_cods, torch.int32, (B, anc_cods.shape[-1])),
            ("des_codes", des_codes, torch.int32, (B, m)),
            ("ins_off", ins_off, torch.float32, (B, m + 1)),
            ("steps", steps, torch.int32, (B,)),
            ("lens_m", lens_m, torch.int32, (B,)),
            ("logP64", logP64, torch.float32, (61, 64)),
            ("match_emit", match_emit, torch.float32, (4, 5)),
            ("gc", gc, torch.float32, (4,)),
            ("carry", carry, torch.float32, (3, B, m + 1)))
    for name, t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, des_codes on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_out(name, t, dtype, shape, dev):
    if (t.dtype != dtype or tuple(t.shape) != shape or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous {dtype} {shape} on {dev}")


def block_threads(Cc: int) -> int:
    """Threads of a block for rows of Cc columns: whole warps, one column a
    thread, THREADS at most; wider rows go a tile at a time."""
    return min(THREADS, -(-Cc // 32) * 32)


@dataclasses.dataclass(frozen=True)
class RowsLaunch:
    """How the rows of Cc columns are launched: `bands` blocks a pair of
    `threads` threads, each band `width` columns (whole tiles; the last band
    may hold fewer), a ring of `slots` records a band boundary."""

    bands: int
    threads: int
    width: int
    slots: int = RECORD_SLOTS

    def check(self, Cc: int) -> None:
        """Raises unless the bands cover Cc columns, each but the last
        non-empty."""
        if self.bands * self.width < Cc or (self.bands - 1) * self.width >= max(Cc, 1):
            raise ValueError(f"{self.bands} bands of {self.width} columns do not "
                             f"cut {Cc} columns")


def rows_launch(Cc: int, bands: int, threads: int, *,
                slots: int = RECORD_SLOTS) -> RowsLaunch:
    """At most `bands` bands a pair of whole tiles of `threads` threads over
    Cc columns, as even as whole tiles allow. Raises on a shape the kernel
    does not take."""
    if threads < 32 or threads > THREADS or threads % 32 or bands < 1 or slots < 1:
        raise ValueError(f"{bands} bands of {threads} threads, {slots} slots: the "
                         f"rows take 32-{THREADS} threads a block, a multiple of "
                         f"32, one or more bands and slots")
    tiles = -(-Cc // threads)
    per = -(-tiles // min(bands, tiles))
    return RowsLaunch(-(-tiles // per), threads, per * threads, slots)


def blocks_per_sm(threads: int) -> int:
    """Blocks of the rows kernel one SM holds at `threads` threads."""
    n = _build.load().coati_triplet_rows_blocks_per_sm(threads)
    if n < 1:
        raise RuntimeError(f"triplet_rows: no occupancy at {threads} threads")
    return n


def rows_shape(B: int, Cc: int, device) -> RowsLaunch:
    """The launch of B pairs of Cc columns. Rows of one tile of
    block_threads(Cc) columns: one band a pair. Wider: a band of one
    256-column tile a block where all B pairs' bands fit the SMs one each;
    else tiles of block_threads(Cc) and as many bands a pair, up to one a
    tile, as keep all B pairs' bands on the card at once (the launch is
    cooperative), one band a pair where B fills it. Rows that set this
    (sweep_shapes.py triplet; PERF.md section 6), us a codon step on an
    H100: one 15,000 nt pair 6.80 at 59 bands of 256, 6.85 at 118 of 128,
    8.36 at 30 of 512; 16 x 2,997 nt 7.81 at 6 bands of 512 (7.12 at 24 of
    128, three blocks an SM); 64 x 999 nt 7.43-7.65 at 2 of 512, 7.95 at 4
    of 256."""
    threads = block_threads(Cc)
    tiles = -(-Cc // threads)
    if tiles == 1:
        return rows_launch(Cc, 1, threads)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if B * -(-Cc // 256) <= sms:
        return rows_launch(Cc, -(-Cc // 256), 256)
    return rows_launch(Cc, max(1, min(tiles, sms * blocks_per_sm(threads) // B)),
                       threads)


def triplet_rows(anc_cods, des_codes, ins_off, steps, lens_m, logP64,
                 match_emit, gc, carry, *, keep_grid: bool = True,
                 grid_out=None, amax_out=None, launch: RowsLaunch | None = None):
    """S = anc_cods.shape[1] codon steps of the forward rows from `carry`.

    Arguments as triplet_rows_plain's, and: steps [B] int32, the codon steps
    pair b really has in this launch (its own n_cod less the steps before,
    within 0..S); lens_m [B] int32, its descendant length. grid_out [S, 3, B,
    Cc] f32 and amax_out (uint8) are written in place when given.

    Returns (boundaries, argmax lanes, carry out) as triplet_rows_plain
    with `steps`: a pair's carry out is the boundary after its last step
    (the carry in, with no step). On CUDA only pair b's first steps[b] rows
    and lens_m[b] + 1 columns are computed: the rest is uninitialized.
    launch: the kernel's shape (default rows_shape)."""
    global LAUNCHES
    _check(anc_cods, des_codes, ins_off, steps, lens_m, logP64, match_emit,
           gc, carry)
    B, S = anc_cods.shape
    Cc = des_codes.shape[1] + 1
    dev = des_codes.device
    if S < 1:
        raise ValueError("anc_cods holds no codon step")
    for name, t, dtype in (("grid_out", grid_out, torch.float32),
                           ("amax_out", amax_out, torch.uint8)):
        if t is not None:
            _check_out(name, t, dtype, (S, 3, B, Cc), dev)
    if launch is not None:
        launch.check(Cc)
    if dev.type == "cpu":
        grid, amax, out = triplet_rows_plain(
            anc_cods, des_codes, ins_off, logP64, match_emit, gc, carry,
            keep_grid=keep_grid, steps=steps)
        if keep_grid and grid_out is not None:
            grid = grid_out.copy_(grid)
        if keep_grid and amax_out is not None:
            amax = amax_out.copy_(amax)
        return grid, amax, out
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    grid = amax = scratch = None
    if keep_grid:
        grid = grid_out if grid_out is not None else torch.empty(
            (S, 3, B, Cc), dtype=torch.float32, device=dev)
        amax = amax_out if amax_out is not None else torch.empty(
            (S, 3, B, Cc), dtype=torch.uint8, device=dev)
    else:  # the rows alternate between two boundaries of scratch
        scratch = torch.empty((2, 3, B, Cc), dtype=torch.float32, device=dev)
    out = torch.empty_like(carry)
    launch = launch or rows_shape(B, Cc, dev)
    records = progress = None
    if launch.bands > 1:  # each band boundary's ring, each band's steps done
        records = torch.empty((B, launch.bands - 1, launch.slots, RECORD),
                              dtype=torch.float32, device=dev)
        progress = torch.zeros((B, launch.bands), dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.coati_triplet_rows(
            anc_cods.data_ptr(), des_codes.data_ptr(), ins_off.data_ptr(),
            steps.data_ptr(), lens_m.data_ptr(), logP64.data_ptr(),
            match_emit.data_ptr(), gc.data_ptr(), carry.data_ptr(),
            ptr(grid), ptr(amax), out.data_ptr(), ptr(scratch), ptr(records),
            ptr(progress), B, des_codes.shape[1], S, launch.threads, launch.bands,
            launch.width, launch.slots, stream,
        )
    _build.check(rc, "triplet_rows")
    LAUNCHES += 1
    return grid, amax, out
