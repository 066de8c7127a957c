"""Long-pair Viterbi alignment with O(n) device memory: checkpointed two-pass
traceback (counterpart of coati_tpu/align/longseq.py).

The whole backpointer stack of a pair costs (na + k) x row_stride(nb + k)
bytes in the fill's row layout (1.0 GB at 32,000 nt, 26 GB at 160,000 nt),
so a pair whose stack would pass BP_BUDGET_BYTES runs in bands of rows
instead, up to k = wavefront_fill.MAX_K:

  pass 1 (forward): the score-only strip body sweeps the whole matrix once
    and keeps (M, D, I) of the k rows above every band boundary as it passes
    them (k * 3 * Cp floats a pair a band; kernels/wavefront_score.py
    wavefront_score_ckpt), and the corners.
  pass 2 (traceback): for each band of band_rows_for(B, Cp, k) rows, last to
    first, the strip body with backpointers fills the band from its
    checkpoint (kernels/wavefront_fill.py wavefront_fill_band), held only
    while the band walk steps every pair's walk through it
    (kernels/traceback_walk.py walk_band).

Compute is two sweeps of the matrix (pass 1, and the recompute), the
classic checkpointed-DP trade. The JAX package's recipe carries a ring of
diagonals and recomputes segments of diagonals, a layout for the TPU's
lanes; on the card the strips sweep rows at a fraction of the time. Above
MAX_K the strip body is not built, and a pair keeps that recipe: the segment
kernel (kernels/wavefront_segment.py, the reference's _segment) over
segments of diagonals from checkpointed rings, and the segment walk
(traceback_walk.walk_segment, its _walk_segment). Nothing is read back to
the host between bands or segments. On CPU tensors the wrappers take their
plain versions. A group of pairs is padded to one shape and swept together.

Results do not depend on the band height, the segment length, the budget or
the grouping.
"""

from __future__ import annotations

import numpy as np
import torch

from coati_tpu_torch.device import lane_of
from coati_tpu_torch.kernels import traceback_walk as _walk
from coati_tpu_torch.kernels import wavefront_fill as _fill
from coati_tpu_torch.kernels import wavefront_score as _score
from coati_tpu_torch.kernels import wavefront_segment as _seg
from coati_tpu_torch.params import params_from_numpy

# device bytes one stack of backpointers may take: a pair whose whole stack
# is larger is aligned in bands (segments above MAX_K), and a group's band
# holds as many rows as fit. An H100's 80 GB hold several such stacks
# beside the bucketed chunks in flight (2 bytes a cell of up to 2^30 cells)
BP_BUDGET_BYTES = 1 << 30
# cap on a group's pass-1 checkpoint bytes; bounds its width
LONG_CKPT_BYTES = 4 << 30
# a group is one launch of at least one block a pair; past this width more
# pairs only queue behind the card's SMs
LONG_GROUP_MAX = 1024


def bp_bytes(na: int, nb: int, k: int) -> int:
    """Bytes of the whole backpointer stack of one na x nb pair in the layout
    the port stores: rows of the fill up to MAX_K, diagonals of the sweep
    above."""
    if k <= _fill.MAX_K:
        return (na + k) * _fill.row_stride(nb + k)
    return (na + nb + 2 * k - 1) * (nb + k)


def is_long_pair(na: int, nb: int, k: int, long_slots: int | None = None) -> bool:
    """True when the pair takes the two-pass path: its backpointer stack
    passes BP_BUDGET_BYTES, or, with the long_slots override, its descendant
    needs more than long_slots slots."""
    if long_slots is not None:
        return nb + k > long_slots
    return bp_bytes(na, nb, k) > BP_BUDGET_BYTES


def band_rows_for(B: int, Cp: int, k: int) -> int:
    """Rows a band of a B-pair group of rows of Cp bytes holds within
    BP_BUDGET_BYTES: a multiple of k, at least k."""
    return max(k, BP_BUDGET_BYTES // (B * Cp) // k * k)


def seg_diagonals_for(B: int, C: int) -> int:
    """Diagonals a segment of a B-pair group of C slots holds within
    BP_BUDGET_BYTES (the diagonal route, k > MAX_K)."""
    return max(1, BP_BUDGET_BYTES // (B * C))


def long_batch_width(nb: int, k: int = 1) -> int:
    """How many long pairs of descendant length <= nb to sweep as one group:
    the widest group whose pass-1 checkpoints stay within LONG_CKPT_BYTES,
    the ancestor about as long as the descendant. Up to MAX_K a checkpoint
    is k rows of (M, D, I) a pair for each band but the first (k x 3 x Cp
    f32), at the band height the width allows; above, one carry of
    max(k, 2) diagonals a pair a segment."""
    C = nb + k
    if k <= _fill.MAX_K:
        Cp = _fill.row_stride(C)
        per_band = k * 3 * Cp * 4  # bytes a pair

        def ckpt_bytes(B):
            return (-(-C // band_rows_for(B, Cp, k)) - 1) * B * per_band
    else:
        carry = (max(k, 2) * 3 * C + 3) * 4  # bytes a pair

        def ckpt_bytes(B):
            return -(-2 * C // seg_diagonals_for(B, C)) * B * carry
    width = 1
    while width < LONG_GROUP_MAX and ckpt_bytes(width + 1) <= LONG_CKPT_BYTES:
        width += 1
    return width


def _pad_group(enc_as, enc_bs, staging=None):
    """Pad a group of encoded pairs to one shared [B, NA] / [B, NB] shape
    (the group's maxima). Returns numpy (aseq, bseq, lens_a, lens_b), as
    engine.pad_pairs does (with `staging`, views of its next upload slot)."""
    from coati_tpu_torch.align.engine import pad_pairs

    NA = max(1, max(len(a) for a in enc_as))
    NB = max(1, max(len(b) for b in enc_bs))
    return pad_pairs(enc_as, enc_bs, NA, NB, staging)


def align_long_group(aseq, bseq, lens_a, lens_b, table, gap_consts, *, k: int,
                     seg_diagonals: int | None = None, host_lens=None):
    """The two passes over one padded group, enqueued on the current stream
    with no host synchronisation: in bands of rows up to MAX_K, in segments
    of diagonals above.

    Tensors on one device as the kernels take them. A band holds
    band_rows_for's rows (k <= MAX_K), a segment seg_diagonals diagonals
    (k > MAX_K; default seg_diagonals_for). host_lens: (lens_a, lens_b) as
    numpy, known on the host, so that the bands or segments past every
    pair's corner are not run (default: all are). Returns (ops, score): ops [NA + NB, B] int8 walking
    backward from each corner with -1 after each walk's end, score [B] f32."""
    if k > _fill.MAX_K:
        return _align_long_diagonals(aseq, bseq, lens_a, lens_b, table,
                                     gap_consts, k=k, seg_diagonals=seg_diagonals,
                                     host_lens=host_lens)
    B, NA = aseq.shape
    NB = bseq.shape[1]
    Cp = _fill.row_stride(NB + k)
    R = NA + k
    H = min(band_rows_for(B, Cp, k), -(-R // k) * k)
    last_row = R - 1 if host_lens is None else int(np.max(host_lens[0])) + k - 1
    top = last_row // H  # the band of the lowest corner; those past it are padding
    args = (aseq, bseq, lens_a, lens_b, table, gap_consts)

    # pass 1: the whole matrix, score-only, keeping the rows above each band
    # below the first (band b's at ckpt[b - 1])
    adj, ckpt = _score.wavefront_score_ckpt(*args, k=k, band_rows=H, n_ckpt=top)

    # pass 2: each band's bp from its checkpoint, walked; the bp of a band is
    # released when the next one is made, in stream order
    state = torch.empty((4, B), dtype=torch.int32, device=aseq.device)
    ops = torch.full((max(1, NA + NB), B), -1, dtype=torch.int8,
                     device=aseq.device)
    for b in range(top, -1, -1):
        bp = _fill.wavefront_fill_band(*args, ckpt[b - 1] if b else None, k=k,
                                       row0=b * H, band_rows=H)
        out = _walk.walk_band(bp, b * H, state, ops, k=k,
                              start=(adj, lens_a, lens_b) if b == top else None)
        if b == top:
            score = out[2]
        del bp
    return ops, score


def _align_long_diagonals(aseq, bseq, lens_a, lens_b, table, gap_consts, *,
                          k: int, seg_diagonals, host_lens):
    """align_long_group in segments of diagonals (k > MAX_K): pass 1 sweeps
    segment by segment, carrying the ring of the last max(k, 2) diagonals
    and the raw corners, and keeps the carry entering each segment (K * 3 *
    C floats a pair each); pass 2 recomputes each segment, last to first,
    with packed backpointers from its checkpoint, walked by the segment
    walk."""
    B, NA = aseq.shape
    NB = bseq.shape[1]
    C = NB + k
    Dtot = NA + NB + 2 * k - 1
    T = min(Dtot, int(seg_diagonals) if seg_diagonals else seg_diagonals_for(B, C))
    if T < 1:
        raise ValueError(f"seg_diagonals must be >= 1, got {seg_diagonals}")
    n_seg = -(-Dtot // T)
    max_corner = (Dtot - 1 if host_lens is None
                  else int(np.max(host_lens[0] + host_lens[1])) + 2 * (k - 1))
    args = (aseq, bseq, lens_a, lens_b, table, gap_consts)

    # pass 1: forward sweep, checkpoint the carry entering each segment
    carry = _seg.empty_carry(B, C, k, aseq.device)
    ckpts = []
    adj = None
    for s in range(n_seg):
        if s * T > max_corner:
            break  # every corner is captured: the rest is padding
        ckpts.append(carry)
        adj, _, carry = _seg.wavefront_segment(
            *args, carry, s * T, k=k, n_steps=T, want_bp=False)
    del carry

    # pass 2: recompute each segment's bp from its checkpoint, walk it; the
    # bp of a segment is released when the next one is made, in stream order
    state = torch.empty((4, B), dtype=torch.int32, device=aseq.device)
    ops = torch.full((max(1, NA + NB), B), -1, dtype=torch.int8,
                     device=aseq.device)
    top = len(ckpts) - 1  # its walk starts at the corners
    for s in range(top, -1, -1):
        _, bp_seg, _ = _seg.wavefront_segment(
            *args, ckpts.pop(), s * T, k=k, n_steps=T, want_bp=True,
            want_carry=False)
        out = _walk.walk_segment(bp_seg, s * T, state, ops, k=k,
                                 start=(adj, lens_a, lens_b) if s == top else None)
        if s == top:
            score = out[2]
        del bp_seg
    return ops, score


def enqueue_long_group(enc_as, enc_bs, params, lane, seg_diagonals=None):
    """Pad one group of encoded pairs into the lane's staging, copy it to
    the lane's device, enqueue its two passes and the copy of the results
    back. Returns a device.Fetch of (ops, score): ops [max(la + lb), B] int8
    walking backward, score [B] f32. Nothing waits for the device."""
    aseq, bseq, la, lb = _pad_group(enc_as, enc_bs, lane.staging)
    params.check_codes(aseq, bseq)
    steps = max(1, int(np.max(la + lb)))
    ops, score = align_long_group(
        *lane.staging.send(), params.table, params.gap_consts, k=params.k,
        seg_diagonals=seg_diagonals, host_lens=(la, lb))
    return lane.staging.fetch(ops[:steps], score)


def viterbi_align_long_batch(enc_as, enc_bs, a_strs, b_strs, table, gap, *,
                             seg_diagonals: int | None = None, device="cuda"):
    """Viterbi-align a GROUP of long pairs with bounded memory, all pairs in
    one two-pass sweep (padded to the group's maxima: callers should group
    pairs of similar length). Returns a list of engine.AlignResult; strings
    and scores are those of the full-backpointer path.

    A band (up to MAX_K) holds as many rows as fit BP_BUDGET_BYTES;
    seg_diagonals: diagonals a segment above MAX_K (default: as many as
    fit). device: a name or a device.Lane."""
    from coati_tpu_torch.align.engine import ops_to_strings

    lane = lane_of(device)
    params = params_from_numpy(table, gap, lane.device)
    with lane.context():
        fetch = enqueue_long_group(enc_as, enc_bs, params, lane, seg_diagonals)
    with fetch as (ops, score):
        return ops_to_strings(ops[::-1], score, a_strs, b_strs, params.k)


def viterbi_align_long(enc_a, enc_b, a_str, b_str, table, gap, *,
                       seg_diagonals: int | None = None, device="cuda"):
    """Viterbi-align one long pair with bounded memory (a group of 1)."""
    return viterbi_align_long_batch(
        [enc_a], [enc_b], [a_str], [b_str], table, gap,
        seg_diagonals=seg_diagonals, device=device)[0]
