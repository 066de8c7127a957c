"""Batched device engine for the triplet (codon-context) pair-HMM
(counterpart of coati_tpu/triplet_wavefront.py).

The codon-channel DP runs as a row sweep over codon steps that keeps only the
lane-collapsed boundary rows (kernels/triplet_rows.py); the traceback walks
those boundaries block by block, binding the descendant-codon lane from the
forward's argmax lanes and computing each block's three rows again for that
one lane (kernels/triplet_walk.py). On a CUDA device both are hand-written
kernels; on the CPU their plain PyTorch versions. Arithmetic is float32
throughout and every add keeps the host engine's grouping
(triplet_hmm._DP), so strings and scores are triplet_hmm.triplet_align's.

Three sizes, one result: a batch is cut into sub-batches whose grids fit
TRIPLET_BATCH_BYTES; a pair whose own grid would pass
TRIPLET_GRID_BUDGET_BYTES takes the segmented two-pass path
(triplet_align_long), which holds one segment's grid at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from coati_tpu_torch import constants as C
from coati_tpu_torch.device import fill_rows, host_arrays, lane_of
from coati_tpu_torch.kernels import triplet_rows as rows_k
from coati_tpu_torch.kernels import triplet_walk as walk_k
from coati_tpu_torch.kernels.triplet_rows import NEG, triplet_rows_plain  # noqa: F401
from coati_tpu_torch.kernels.triplet_walk import triplet_walk_plain  # noqa: F401

# a boundary cell: three f32 rows and three uint8 argmax lanes
GRID_CELL_BYTES = 15
# A pair whose boundary grid would pass this takes the segmented path. The
# rule is one of bytes, as align/longseq.py BP_BUDGET_BYTES is for the
# marginal models: 1 GiB is (n / 3 + 1) x (m + 1) = 71.6 M cells, a square
# pair of about 14,650 nt.
TRIPLET_GRID_BUDGET_BYTES = 1 << 30
# the grids of one sub-batch of triplet_align_batch
TRIPLET_BATCH_BYTES = 4 << 30
SEG_CODS = 512  # codon blocks a segment of the long path, at most


def grid_bytes(n_cod: int, m: int, B: int = 1) -> int:
    """Bytes of the boundary grid and argmax lanes of B pairs padded to n_cod
    codons by m nt."""
    return (n_cod + 1) * (m + 1) * GRID_CELL_BYTES * B


def is_long_pair(na: int, nb: int) -> bool:
    """Whether a pair of na x nb nt takes the segmented path."""
    return grid_bytes(na // 3, nb) > TRIPLET_GRID_BUDGET_BYTES


def seg_cods_for(Cc: int) -> int:
    """Codon blocks a segment of the long path: SEG_CODS, fewer where a
    segment's grid would pass the byte budget."""
    return max(1, min(SEG_CODS, TRIPLET_GRID_BUDGET_BYTES // (Cc * GRID_CELL_BYTES)))


def triplet_tables(model, device):
    """The model's tables as f32 tensors on `device`: (logP64 [61, 64] entry
    costs by codon64 lane x1 * 16 + x2 * 4 + x3, NEG at stops; match_emit
    [4, 5]; gc [4] = (ng, gs, go, ge))."""
    logP64 = np.full((61, 64), np.float32(NEG), np.float32)
    logP64[:, C.COD61_TO_64] = model.logP.astype(np.float32)
    gc = np.array([model.ng, model.gs, model.go, model.ge], np.float32)
    return (torch.from_numpy(logP64).to(device),
            torch.from_numpy(model.match_emit.astype(np.float32)).to(device),
            torch.from_numpy(gc).to(device))


def _pack_batch(model, anc_encs, des_encs, device, staging=None):
    """Pad a batch to its maxima. Returns numpy (anc_p [B, n_cod], des_p [B,
    m], lens_t, lens_m, ins_off [B, m + 1]), new arrays or with `staging`
    (device.Staging) views of its next upload slot, in that order for
    staging.send(); the tables on `device`; n_cod."""
    B = len(anc_encs)
    n_cod = max(len(a) for a in anc_encs)
    m = max(len(d) for d in des_encs)
    anc_p, des_p, lens_t, lens_m, ins_off = host_arrays(
        staging, ((B, n_cod), np.int32), ((B, m), np.int32), ((B,), np.int32),
        ((B,), np.int32), ((B, m + 1), np.float32))
    lens_t[:] = fill_rows(anc_p, anc_encs)
    lens_m[:] = fill_rows(des_p, des_encs)

    # insertion run offsets on host numpy f32: the same sequential cumsum and
    # grouping as triplet_hmm._DP, so the host and device walks see the same
    # I-state bits (a cumsum on the device may reassociate); columns past a
    # pair's own length continue its prefix and are never read
    ge32 = np.float32(model.ge)
    e = model.ins_emit[des_p].astype(np.float32)  # [B, m]
    ins_off[:, 0] = 0
    np.cumsum(e, axis=1, dtype=np.float32, out=ins_off[:, 1:])
    ins_off += ge32 * np.arange(m + 1, dtype=np.float32)[None, :]
    return (anc_p, des_p, lens_t, lens_m, ins_off,
            triplet_tables(model, device), n_cod)


def triplet_init_carry(des_codes, ins_off, gc):
    """Boundary row 0 [3, B, Cc] (the host engine's init_row)."""
    B, m = des_codes.shape
    dev = des_codes.device
    M0 = torch.full((B, m + 1), NEG, dtype=torch.float32, device=dev)
    M0[:, 0] = 0.0
    I0 = rows_k._Rows(ins_off, gc).row_ins(M0)
    return torch.stack([M0, torch.full_like(M0, NEG), I0])


def _triplet_rows(anc_cods, des_codes, ins_off, lens_t, lens_m, logP64,
                  match_emit, gc):
    """Full-matrix forward: row 0 and one sweep over all codons. Returns
    (boundaries [n_cod + 1, 3, B, Cc] f32, argmax lanes of the same shape,
    uint8, row 0 all 0: no lane is bound there)."""
    B, n_cod = anc_cods.shape
    Cc = des_codes.shape[1] + 1
    dev = des_codes.device
    grid = torch.empty((n_cod + 1, 3, B, Cc), dtype=torch.float32, device=dev)
    amax = torch.empty((n_cod + 1, 3, B, Cc), dtype=torch.uint8, device=dev)
    init = triplet_init_carry(des_codes, ins_off, gc)
    grid[0] = init
    amax[0] = 0
    rows_k.triplet_rows(anc_cods, des_codes, ins_off, lens_t, lens_m, logP64,
                        match_emit, gc, init, keep_grid=True,
                        grid_out=grid[1:], amax_out=amax[1:])
    return grid, amax


def triplet_terminal(Mr, Dr, Ir, lens_m, gc):
    """Terminal state and raw score from each pair's final collapsed
    boundary [B, Cc] (align_fst ShortestDistance convention)."""
    ng, gs = gc[0], gc[1]
    at = lens_m.long()[:, None]
    tm = Mr.gather(1, at)[:, 0] + (ng + ng)
    td = Dr.gather(1, at)[:, 0] + gs
    ti = Ir.gather(1, at)[:, 0] + (gs + ng)
    st0 = (td > tm).long()
    st0 = torch.where(ti > torch.maximum(tm, td), 2, st0)
    return st0, torch.maximum(torch.maximum(tm, td), ti)


def _walk_state(lens_t, lens_m, st0):
    return torch.stack([3 * lens_t.long(), lens_m.long(), st0]).to(torch.int32)


def _triplet_traceback(grid, amax, anc_cods, des_codes, ins_off, lens_t,
                       lens_m, logP64, match_emit, gc):
    """Full-matrix traceback: the terminal pick, then one walk over all codon
    blocks. Returns (run-encoded ops [6 * n_cod, B] int32, state [3, B] int32
    = each walk's last (i, j, st), score [B] f32)."""
    B, n_cod = anc_cods.shape
    bidx = torch.arange(B, device=grid.device)
    last = lens_t.long()
    st0, score = triplet_terminal(grid[last, 0, bidx], grid[last, 1, bidx],
                                  grid[last, 2, bidx], lens_m, gc)
    state = _walk_state(lens_t, lens_m, st0)
    ops = torch.zeros((6 * n_cod, B), dtype=torch.int32, device=grid.device)
    walk_k.triplet_walk(grid, amax[1:], anc_cods, des_codes, ins_off, 0,
                        state, ops, logP64, match_emit, gc)
    return ops, state, score


def triplet_align_long(model, anc: str, des: str, *, seg_cods: int | None = None,
                       device="cuda"):
    """Align one long pair under a codon triplet model in bounded memory.

    The checkpointed two-pass recipe of align/longseq.py on the
    codon-boundary grid: pass 1 sweeps the forward rows keeping only the
    collapsed [3, Cc] carry and a checkpoint of it every seg_cods codon
    blocks; pass 2 computes each segment's boundaries and argmax lanes again
    from its checkpoint, last to first, and drains the walk through it. Peak
    memory: one segment's grid and n / seg_cods checkpoints.

    Strings and score are those of triplet_hmm.triplet_align and of
    triplet_align_batch: the same f32 arithmetic, the same walk."""
    from coati_tpu_torch.triplet_hmm import encode_triplet_pair

    if not model.codon:
        raise ValueError("segmented triplet path requires a codon model")
    lane = lane_of(device)
    dev = lane.device
    ea, ed = encode_triplet_pair(model, anc, des)
    _, des_p, _, _, _, tables, n_cod = _pack_batch(model, [ea], [ed], dev,
                                                   lane.staging)
    aj, dj, lt, lm, io = lane.staging.send()
    Cc = des_p.shape[1] + 1
    S = min(int(seg_cods) if seg_cods else seg_cods_for(Cc), n_cod)
    spans = [(t_lo, min(S, n_cod - t_lo)) for t_lo in range(0, n_cod, S)]

    def sweep(t_lo, S_i, carry, **kw):
        steps = torch.full((1,), S_i, dtype=torch.int32, device=dev)
        return rows_k.triplet_rows(aj[:, t_lo:t_lo + S_i].contiguous(), dj, io,
                                   steps, lm, *tables, carry, **kw)

    # pass 1: the carry only, with a checkpoint entering each segment
    carry = triplet_init_carry(dj, io, tables[2])
    ckpts = []
    for t_lo, S_i in spans:
        ckpts.append(carry)
        _, _, carry = sweep(t_lo, S_i, carry, keep_grid=False)
    st0, score = triplet_terminal(carry[0], carry[1], carry[2], lm, tables[2])

    # pass 2: each segment's grid again, last to first, and the walk through
    # it; the checkpoint is the boundary under the segment's first block
    state = _walk_state(lt, lm, st0)
    ops = torch.zeros((6 * n_cod, 1), dtype=torch.int32, device=dev)
    grid_seg = torch.empty((S + 1, 3, 1, Cc), dtype=torch.float32, device=dev)
    amax_seg = torch.empty((S, 3, 1, Cc), dtype=torch.uint8, device=dev)
    for t_lo, S_i in reversed(spans):
        grid_seg[0] = ckpts.pop()
        sweep(t_lo, S_i, grid_seg[0], keep_grid=True,
              grid_out=grid_seg[1:S_i + 1], amax_out=amax_seg[:S_i])
        walk_k.triplet_walk(grid_seg[:S_i + 1], amax_seg[:S_i],
                            aj[:, t_lo:t_lo + S_i].contiguous(), dj, io, t_lo,
                            state, ops, *tables)

    with lane.staging.fetch(ops, state, score) as (ops_h, state_h, score_h):
        s0, s1 = _decode_ops(anc, des, ops_h[:, 0], int(state_h[0, 0]),
                             int(state_h[1, 0]))
        return s0, s1, float(-score_h[0])


def triplet_boundaries_batch(model, anc_encs, des_encs, device="cuda"):
    """Device forward for a batch of encoded pairs (codon models).

    anc_encs: list of [n_cod_i] codon61 arrays; des_encs: list of [m_i] code
    arrays. Returns the boundary grid [n_cod_max + 1, 3, B, Cc] as numpy f32
    (what lies beyond a pair's own n_cod rows and m + 1 columns is padding,
    uninitialized when it comes from a CUDA device)."""
    lane = lane_of(device)
    tables = _pack_batch(model, anc_encs, des_encs, lane.device, lane.staging)[5]
    aj, dj, lt, lm, io = lane.staging.send()
    grid, _ = _triplet_rows(aj, dj, io, lt, lm, *tables)
    return grid.cpu().numpy()


def _decode_ops(anc, des, runs_b, i_end, j_end):
    """Rebuild aligned strings from the walk's run-encoded op rows
    (row 6*t + phase = op | count << 2, backward-walk order; see
    kernels/triplet_walk.py) ending at (i_end, j_end); leading row-0
    insertions cover des[:j_end]. Forward order = blocks ascending,
    phases descending within each block."""
    v = np.asarray(runs_b).reshape(-1, 6)[:, ::-1].ravel()  # forward order
    cnt = v >> 2
    keep = cnt > 0
    ops_run = (v & 3)[keep]
    cnt_run = cnt[keep]
    # one op per aligned column after the row-0 insertion prefix, then the
    # same cumsum/scatter string build as the marginal engine
    opsc = np.repeat(ops_run, cnt_run)
    consume_a = opsc != 2
    consume_b = opsc != 1
    idx_a = np.cumsum(consume_a) - 1 + i_end
    idx_b = np.cumsum(consume_b) - 1 + j_end
    a_arr = np.frombuffer(anc.encode("ascii") or b"-", np.uint8)
    b_arr = np.frombuffer(des.encode("ascii") or b"-", np.uint8)
    dash = np.uint8(ord("-"))
    s0 = np.where(consume_a, a_arr[np.minimum(idx_a, len(a_arr) - 1)], dash)
    s1 = np.where(consume_b, b_arr[np.minimum(idx_b, len(b_arr) - 1)], dash)
    return (
        "-" * j_end + s0.tobytes().decode("ascii"),
        des[:j_end] + s1.tobytes().decode("ascii"),
    )


def _sub_batches(enc):
    """Cut a batch, in order, into groups of pair indices whose padded grids
    fit TRIPLET_BATCH_BYTES; a pair for the segmented path is a group of its
    own, marked long. Yields (indices, long)."""
    cur, n_cod, m = [], 0, 0
    for i, (ea, ed) in enumerate(enc):
        if grid_bytes(len(ea), len(ed)) > TRIPLET_GRID_BUDGET_BYTES:
            if cur:
                yield cur, False
            yield [i], True
            cur, n_cod, m = [], 0, 0
            continue
        n2, m2 = max(n_cod, len(ea)), max(m, len(ed))
        if cur and grid_bytes(n2, m2, len(cur) + 1) > TRIPLET_BATCH_BYTES:
            yield cur, False
            cur, n2, m2 = [], len(ea), len(ed)
        cur.append(i)
        n_cod, m = n2, m2
    if cur:
        yield cur, False


def _group_rows(model, enc, lane):
    """Pack one sub-batch of encoded pairs into the lane's staging, upload it
    and enqueue its forward rows: ((anc, des, ins_off, lens_t, lens_m) on
    the lane's device, tables, grid, amax)."""
    tables = _pack_batch(model, [e[0] for e in enc], [e[1] for e in enc],
                         lane.device, lane.staging)[5]
    aj, dj, lt, lm, io = lane.staging.send()
    args = (aj, dj, io, lt, lm)
    return (args, tables, *_triplet_rows(*args, *tables))


def enqueue_group(model, enc, lane):
    """One sub-batch of encoded pairs through the forward rows and the device
    traceback on the current stream, and the copy of the results back into
    the lane's staging: returns a device.Fetch of (run-encoded ops, state,
    score). Nothing waits for the device but the tables' copies."""
    args, tables, grid, amax = _group_rows(model, enc, lane)
    return lane.staging.fetch(*_triplet_traceback(grid, amax, *args, *tables))


def decode_group(pairs, fetch):
    """[(seq0, seq1, score), ...] of `pairs` from what enqueue_group
    returned for them, once the device is done."""
    out = []
    with fetch as (ops, state, score):
        for b, (anc, des) in enumerate(pairs):
            s0, s1 = _decode_ops(anc, des, ops[:, b], int(state[0, b]),
                                 int(state[1, b]))
            out.append((s0, s1, float(-score[b])))
    return out


def _align_group(model, pairs, enc, traceback, device):
    """One sub-batch through the forward rows and the traceback."""
    from coati_tpu_torch.triplet_hmm import _DP, traceback_from_boundaries

    lane = lane_of(device)
    if traceback == "device":
        return decode_group(pairs, enqueue_group(model, enc, lane))

    grid = _group_rows(model, enc, lane)[2].cpu().numpy()
    out = []
    for b, ((anc, des), (ea, ed)) in enumerate(zip(pairs, enc)):
        ncb, Ccb = len(ea), len(ed) + 1
        boundaries = [tuple(grid[t, s, b, :Ccb].copy() for s in range(3))
                      for t in range(ncb + 1)]
        Mb, Db, Ib = boundaries[ncb]
        dp = _DP(model, ea, ed, dtype=np.float32)
        term = (Mb[-1] + dp.ng_ng, Db[-1] + dp.gs, Ib[-1] + dp.gs_ng)
        out.append(traceback_from_boundaries(model, anc, des, term,
                                             boundaries, dp))
    return out


def triplet_align_batch(model, pairs, traceback: str = "device",
                        device="cuda", enc=None):
    """Align (anc, des) string pairs under a triplet model on `device`: the
    batched forward rows, then either the batched device traceback (the
    default; only op rows leave the device) or the per-pair host walk over
    the boundary grid (traceback="host", the recompute oracle the device walk
    is tested against).

    Returns [(seq0, seq1, score), ...], equal to triplet_hmm.triplet_align's
    (the dna model goes to that host engine: its one-lane rows are cheap there
    and its boundary grid would hold every row). The result depends on none
    of the byte budgets that cut the batch. enc, when given, is each pair's
    encode_triplet_pair result, for a caller that has encoded them already.
    device: a name or a device.Lane, whose staging the sub-batches reuse."""
    from coati_tpu_torch.triplet_hmm import encode_triplet_pair, triplet_align

    if traceback not in ("device", "host"):
        raise ValueError(f"traceback must be 'device' or 'host', got {traceback!r}")
    lane = lane_of(device)
    if not model.codon:
        return [triplet_align(model, a, d) for a, d in pairs]

    with torch.profiler.record_function("triplet_align_batch"):
        if enc is None:
            enc = [encode_triplet_pair(model, a, d) for a, d in pairs]
        out = [None] * len(pairs)
        for idxs, long in _sub_batches(enc):
            if long:
                res = [triplet_align_long(model, *pairs[idxs[0]], device=lane)]
            else:
                res = _align_group(model, [pairs[i] for i in idxs],
                                   [enc[i] for i in idxs], traceback, lane)
            for i, r in zip(idxs, res):
                out[i] = r
        return out
