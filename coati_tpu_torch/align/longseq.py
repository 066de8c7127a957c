"""Long-pair Viterbi alignment with O(n) device memory: segmented two-pass
traceback (counterpart of coati_tpu/align/longseq.py).

Full backpointers cost Dtot * C bytes a pair (2.0 GB at 32,000 nt, 51 GB at
160,000 nt), so a pair whose stack would pass BP_BUDGET_BYTES runs in
segments of diagonals instead:

  pass 1 (forward): the segment kernel sweeps the matrix segment by
    segment, carrying the ring of the last K = max(k, 2) diagonals and the
    raw corners; the carry entering each segment is kept as a checkpoint
    (K * 3 * C floats a pair each).
  pass 2 (traceback): for each segment, last to first, the segment kernel
    recomputes its diagonals from the checkpoint with packed backpointers,
    held only while the segment walk steps every pair's walk through them.

Compute is two sweeps of the matrix (pass 1, and the recompute), the
classic checkpointed-DP trade. Nothing is read back to the host between
segments. The kernels and their plain versions are
kernels/wavefront_segment.py (the reference's _segment) and
kernels/traceback_walk.py walk_segment (its _walk_segment); on
CPU tensors the wrappers take the plain versions. A group of pairs is padded
to one shape and swept together, each pair by one or by several thread
blocks (kernels/wavefront_segment.py sweep_shape).

Results do not depend on the segment length, the budget or the grouping.
"""

from __future__ import annotations

import numpy as np
import torch

from coati_tpu_torch.device import lane_of
from coati_tpu_torch.kernels import traceback_walk as _walk
from coati_tpu_torch.kernels import wavefront_segment as _seg
from coati_tpu_torch.params import params_from_numpy

# device bytes one stack of backpointers may take: a pair whose whole stack
# (Dtot * C bytes) is larger is aligned in segments, and a group's segment
# holds as many diagonals as fit. An H100's 80 GB hold several such stacks
# beside the bucketed chunks in flight (2 bytes a cell of up to 2^30 cells)
BP_BUDGET_BYTES = 1 << 30
# cap on a group's pass-1 checkpoint bytes; bounds its width
LONG_CKPT_BYTES = 4 << 30
# a group is one launch of at least one block a pair; past this width more
# pairs only queue behind the card's SMs
LONG_GROUP_MAX = 1024


def bp_bytes(na: int, nb: int, k: int) -> int:
    """Bytes of the whole backpointer stack of one na x nb pair."""
    return (na + nb + 2 * k - 1) * (nb + k)


def is_long_pair(na: int, nb: int, k: int, long_slots: int | None = None) -> bool:
    """True when the pair takes the segmented path: its backpointer stack
    passes BP_BUDGET_BYTES, or, with the long_slots override, its descendant
    needs more than long_slots slots."""
    if long_slots is not None:
        return nb + k > long_slots
    return bp_bytes(na, nb, k) > BP_BUDGET_BYTES


def seg_diagonals_for(B: int, C: int) -> int:
    """Diagonals a segment of a B-pair group of C slots holds within
    BP_BUDGET_BYTES."""
    return max(1, BP_BUDGET_BYTES // (B * C))


def long_batch_width(nb: int, k: int = 1) -> int:
    """How many long pairs of descendant length <= nb to sweep as one group:
    the widest group whose checkpoints (one carry a segment, at the segment
    length its width allows) stay within LONG_CKPT_BYTES."""
    C = nb + k
    Dtot = 2 * C  # ancestor about as long as the descendant
    carry = (max(k, 2) * 3 * C + 3) * 4  # bytes a pair
    width = 1
    while width < LONG_GROUP_MAX:
        B = width + 1
        n_seg = -(-Dtot // seg_diagonals_for(B, C))
        if n_seg * B * carry > LONG_CKPT_BYTES:
            break
        width = B
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
                     seg_diagonals: int | None = None, max_corner=None):
    """The two passes over one padded group, enqueued on the current stream
    with no host synchronisation.

    Tensors on one device as the kernels take them. max_corner: the highest
    corner diagonal of the group, max(la + lb) + 2(k-1), known on the host
    (default: every segment is walked). Returns (ops, score): ops
    [NA + NB, B] int8 walking backward from each corner with -1 after each
    walk's end, score [B] f32."""
    B, NA = aseq.shape
    NB = bseq.shape[1]
    C = NB + k
    Dtot = NA + NB + 2 * k - 1
    T = min(Dtot, int(seg_diagonals) if seg_diagonals else seg_diagonals_for(B, C))
    if T < 1:
        raise ValueError(f"seg_diagonals must be >= 1, got {seg_diagonals}")
    n_seg = -(-Dtot // T)
    if max_corner is None:
        max_corner = Dtot - 1
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
        seg_diagonals=seg_diagonals, max_corner=steps + 2 * (params.k - 1))
    return lane.staging.fetch(ops[:steps], score)


def viterbi_align_long_batch(enc_as, enc_bs, a_strs, b_strs, table, gap, *,
                             seg_diagonals: int | None = None, device="cuda"):
    """Viterbi-align a GROUP of long pairs with bounded memory, all pairs in
    one segmented sweep (padded to the group's maxima: callers should group
    pairs of similar length). Returns a list of engine.AlignResult; strings
    and scores are those of the full-backpointer path.

    seg_diagonals: diagonals a segment (default: as many as fit
    BP_BUDGET_BYTES). device: a name or a device.Lane."""
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
