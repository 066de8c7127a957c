"""Batch alignment engine: length bucketing, the fused fill + walk step, the
routing of long pairs, and score-only Viterbi.

Counterpart of coati_tpu/align/engine.py. Pairs are bucketed by padded
shape and chunked by cell count; each chunk runs the Viterbi fill and the
traceback walk back to back on one stream, the backpointer stack never
leaves the device, and only the op codes and scores are copied to the host,
where the native library builds the aligned strings. A pair whose backpointer stack would
pass the budget of align/longseq.py goes, grouped with pairs of similar
size, through the segmented two-pass path there. Every chunk and then every
group is enqueued before the first result is read, so the device works
while the host pads the next chunk and builds strings. Given several lanes
(device.resolve_devices), the chunks go round-robin over them, each enqueued
on its lane's stream, and the long pairs to the first. Score-only Viterbi
keeps no backpointers and plans its launches by bytes (score_chunks). A
chunk is padded straight into its lane's pinned buffers and its results come
back into them (device.Staging), so no CPU tensor operation runs on the way.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from coati_tpu_torch.align import longseq
from coati_tpu_torch.device import fill_rows, host_arrays, resolve_devices
from coati_tpu_torch.kernels import traceback_walk as _walk
from coati_tpu_torch.kernels import wavefront_fill as _fill
from coati_tpu_torch.kernels import wavefront_score as _score
from coati_tpu_torch.kernels import wavefront_segment as _seg
from coati_tpu_torch.params import params_from_numpy


@dataclasses.dataclass
class AlignResult:
    seq0: str
    seq1: str
    score: float


def _round_up(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


def ops_to_strings(ops_fwd, score, a_strs, b_strs, k):
    """Aligned strings from forward-ordered op codes, built in one pass of
    the native library (native.ops_to_strings_native), as
    coati_tpu/align/engine.py ops_to_strings does. A library that does not
    build raises; ops_to_strings_plain is the numpy version it is held to.

    ops_fwd: [steps, B] int8 with -1 padding (leading, since the walk ran
    backward and was reversed)."""
    from coati_tpu_torch import native

    with record_function("ops_to_strings"):
        pairs = native.ops_to_strings_native(ops_fwd, a_strs, b_strs, k)
        return [AlignResult(s0, s1, float(score[p]))
                for p, (s0, s1) in enumerate(pairs)]


def ops_to_strings_plain(ops_fwd, score, a_strs, b_strs, k):
    """The numpy version of ops_to_strings, one pair at a time."""
    results = []
    for p in range(ops_fwd.shape[1]):
        ops = ops_fwd[:, p]
        ops = ops[ops >= 0]
        if k > 1:
            ops = np.repeat(ops, np.where(ops == 0, 1, k))
        a_arr = np.frombuffer(a_strs[p].encode("ascii"), dtype=np.uint8)
        b_arr = np.frombuffer(b_strs[p].encode("ascii"), dtype=np.uint8)
        consume_a = ops != 2
        consume_b = ops != 1
        idx_a = np.cumsum(consume_a) - 1
        idx_b = np.cumsum(consume_b) - 1
        dash = np.uint8(ord("-"))
        s0 = np.where(consume_a, a_arr[np.maximum(idx_a, 0)], dash)
        s1 = np.where(consume_b, b_arr[np.maximum(idx_b, 0)], dash)
        results.append(AlignResult(
            s0.astype(np.uint8).tobytes().decode("ascii"),
            s1.astype(np.uint8).tobytes().decode("ascii"),
            float(score[p]),
        ))
    return results


def pad_pairs(enc_as, enc_bs, NA, NB, staging=None):
    """The pairs zero-padded to [B, NA] / [B, NB] int32, and their lengths:
    numpy (aseq, bseq, lens_a, lens_b), new arrays, or with `staging`
    (device.Staging) views of its next upload slot, for staging.send()."""
    B = len(enc_as)
    aseq, bseq, lens_a, lens_b = host_arrays(
        staging, ((B, NA), np.int32), ((B, NB), np.int32), ((B,), np.int32),
        ((B,), np.int32))
    lens_a[:] = fill_rows(aseq, enc_as)
    lens_b[:] = fill_rows(bseq, enc_bs)
    return aseq, bseq, lens_a, lens_b


def _pad_batch(enc_as, enc_bs, quantum, staging=None):
    """pad_pairs to the pairs' maxima rounded up to the quantum."""
    na = max(len(a) for a in enc_as)
    nb = max(len(b) for b in enc_bs)
    NA = max(_round_up(na, quantum), quantum)
    NB = max(_round_up(nb, quantum), quantum)
    return pad_pairs(enc_as, enc_bs, NA, NB, staging)


def fused_align_ops(aseq, bseq, lens_a, lens_b, table, gap_consts, *, k,
                    max_steps):
    """Viterbi fill then traceback walk on the current stream.

    Returns (ops [max_steps, B] int8 walking backward, score [B] f32) on the
    inputs' device. Up to k = wavefront_fill.MAX_K the fill kernel and the
    whole-stack walk, on a stack in row layout; a larger k the sweep kernel
    over every diagonal from an empty carry with backpointers, and the
    segment walk over that one segment (diagonal layout). One code path on
    both devices. The bp stack is released when this returns; the caching
    allocator reuses it in stream order, after the walk."""
    with record_function("fused_align_ops"):
        if k > _fill.MAX_K:
            return _sweep_align_ops(aseq, bseq, lens_a, lens_b, table,
                                    gap_consts, k=k, max_steps=max_steps)
        corners, bp = _fill.wavefront_fill(aseq, bseq, lens_a, lens_b, table,
                                           gap_consts, k=k)
        with record_function("traceback_walk"):
            return _walk.traceback_walk(bp, corners, lens_a, lens_b, k=k,
                                        max_steps=max_steps)


def _sweep_align_ops(aseq, bseq, lens_a, lens_b, table, gap_consts, *, k,
                     max_steps):
    """fused_align_ops through the sweep kernel and the segment walk: the
    whole matrix as one segment."""
    B, NA = aseq.shape
    NB = bseq.shape[1]
    carry = _seg.empty_carry(B, NB + k, k, aseq.device)
    adj, bp, _ = _seg.wavefront_segment(
        aseq, bseq, lens_a, lens_b, table, gap_consts, carry, 0, k=k,
        n_steps=NA + NB + 2 * k - 1, want_bp=True, want_carry=False)
    state = torch.empty((4, B), dtype=torch.int32, device=aseq.device)
    ops = torch.full((max_steps, B), -1, dtype=torch.int8, device=aseq.device)
    _, ops, score = _walk.walk_segment(bp, 0, state, ops, k=k,
                                       start=(adj, lens_a, lens_b))
    return ops, score


def _long_groups(long_pairs, enc_as, enc_bs, k):
    """Long pairs sorted by size and cut into groups that one segmented
    sweep takes: a pair joins the group before it while the group is
    narrower than long_batch_width allows for its widest descendant and the
    pair is at least 0.7 of the group's first (largest) pair, so padding to
    the group's maxima wastes less than about half the sweep."""
    order = sorted(long_pairs, key=lambda i: -(len(enc_as[i]) + len(enc_bs[i])))
    groups: list[list[int]] = []
    for idx in order:
        size = len(enc_as[idx]) + len(enc_bs[idx])
        if groups:
            head = groups[-1][0]
            head_size = len(enc_as[head]) + len(enc_bs[head])
            nb_max = max(len(enc_bs[i]) for i in groups[-1] + [idx])
            width = longseq.long_batch_width(nb_max, k)
            if len(groups[-1]) < width and size >= 0.7 * head_size:
                groups[-1].append(idx)
                continue
        groups.append([idx])
    return groups


def params_by_device(lanes, table, gap) -> dict:
    """The model's Params on each distinct device of `lanes`, copied once a
    device (lanes on one device share them); every lane's stream waits for
    the copies and holds them (Lane.share)."""
    params = {}
    for lane in lanes:
        if lane.device not in params:
            params[lane.device] = params_from_numpy(table, gap, lane.device)
        lane.share(params[lane.device].table, params[lane.device].gap_consts)
    return params


def viterbi_align_batch(
    enc_as,
    enc_bs,
    a_strs,
    b_strs,
    table,
    gap,
    quantum: int = 96,
    max_batch_cells: int = 1 << 30,
    table_idx=None,
    long_slots: int | None = None,
    device="cuda",
) -> list[AlignResult]:
    """Align many pairs: bucket by padded shape, run the fused fill + walk
    per chunk, build strings on the host. Results keep input order.

    device: a device name, or a list of them or of lanes
    (device.resolve_devices): the chunks go round-robin over the lanes, as
    coati_tpu/align/engine.py sends them over its devices, and long pairs
    to the first lane. A pair's result does not depend on its chunk or lane.

    table_idx: optional per-pair index into a stacked table [G, 183, 15],
    folded into the ancestor encoding (enc_a + 183*idx against the
    flattened [G*183, 15] table).

    long_slots: descendants needing more slots than this take the segmented
    long-pair path; by default a pair takes it when its backpointer stack
    would pass longseq.BP_BUDGET_BYTES."""
    lanes = resolve_devices(device)
    k = int(gap.len)
    table32 = np.asarray(table, dtype=np.float32)
    if table_idx is not None:
        if table32.ndim != 3:
            raise ValueError("table_idx requires a stacked [G, rows, 15] table")
        nrows = table32.shape[1]
        enc_as = [
            np.asarray(a, dtype=np.int32) + np.int32(nrows * int(table_idx[i]))
            for i, a in enumerate(enc_as)
        ]
    params = params_by_device(lanes, table32, gap)

    buckets: dict[tuple[int, int], list[int]] = collections.defaultdict(list)
    long_pairs: list[int] = []
    for idx, (a, b) in enumerate(zip(enc_as, enc_bs)):
        if longseq.is_long_pair(len(a), len(b), k, long_slots):
            long_pairs.append(idx)
            continue
        qa = max(_round_up(len(a), quantum), quantum)
        qb = max(_round_up(len(b), quantum), quantum)
        buckets[(qa, qb)].append(idx)

    # phase 1: enqueue every chunk, on the next lane in turn (with several
    # lanes a bucket is cut so that every lane gets work); phase 2: read
    # results in launch order
    inflight = []
    n_launched = 0
    for (qa, qb), idxs in buckets.items():
        max_b = max(1, max_batch_cells // ((qa + k) * (qb + k)))
        if len(lanes) > 1:
            max_b = min(max_b, -(-len(idxs) // len(lanes)))
        for s in range(0, len(idxs), max_b):
            chunk = idxs[s : s + max_b]
            lane = lanes[n_launched % len(lanes)]
            n_launched += 1
            aseq, bseq, la, lb = _pad_batch(
                [enc_as[i] for i in chunk], [enc_bs[i] for i in chunk], quantum,
                lane.staging)
            p = params[lane.device]
            p.check_codes(aseq, bseq)
            with lane.context():
                ops, score = fused_align_ops(
                    *lane.staging.send(), p.table, p.gap_consts, k=k,
                    max_steps=max(1, int(np.max(la + lb))),
                )
                inflight.append((chunk, lane.staging.fetch(ops, score)))
            lane.chunks += 1

    # long pairs after the buckets, on the first lane, so the card works on
    # those while the host pads the groups
    first = lanes[0]
    for grp in _long_groups(long_pairs, enc_as, enc_bs, k):
        with first.context():
            inflight.append((grp, longseq.enqueue_long_group(
                [enc_as[i] for i in grp], [enc_bs[i] for i in grp],
                params[first.device], first)))
        first.chunks += 1

    results: list[AlignResult | None] = [None] * len(enc_as)
    for chunk, fetch in inflight:
        with fetch as (ops, score):
            out = ops_to_strings(
                ops[::-1], score,
                [a_strs[i] for i in chunk], [b_strs[i] for i in chunk], k,
            )
        for i, r in zip(chunk, out):
            results[i] = r
    return results  # type: ignore[return-value]


def viterbi_align_single(enc_a, enc_b, a_str, b_str, table, gap,
                         device="cuda") -> tuple:
    r = viterbi_align_batch([enc_a], [enc_b], [a_str], [b_str], table, gap,
                            device=device)[0]
    return r.seq0, r.seq1, r.score


# device bytes one score-only launch may hold: its inputs, corners and
# scratch (score_launch_bytes)
SCORE_BATCH_BYTES = 1 << 30


def score_launch_bytes(B: int, NA: int, NB: int, k: int, spread: bool,
                       sms: int = 132) -> int:
    """At most the device bytes of one score-only launch of B pairs padded to
    NA x NB: the inputs and corners, and the route's scratch. Up to
    wavefront_fill.MAX_K the strip body's edge buffer, (NA + k) x (2k + 1)
    f32 for each block a stripe edge may leave: one a pair, or with `spread`
    (pairs over MULTI_BLOCK_SLOTS slots) as many blocks as the SMs hold
    beside the pairs. Above, the sweep's ring of diagonals in device memory,
    ring_slots(k) x 3 x (NB + k) f32 a pair. No backpointers."""
    inputs = 4 * B * (NA + NB + 2) + 12 * B
    if k > _fill.MAX_K:
        return inputs + 4 * B * _seg.ring_slots(k) * 3 * (NB + k)
    blocks = max(B, sms) if spread else B
    return inputs + 4 * blocks * (NA + k) * (2 * k + 1)


def score_chunks(lens_a, lens_b, k: int, quantum: int = 96,
                 max_batch_bytes: int = SCORE_BATCH_BYTES,
                 sms: int = 132) -> list[list[int]]:
    """The launches of viterbi_scores_batch, planned from the lengths alone:
    lists of pair indices, each in input order, each one launch. Pairs are
    bucketed by padded shape, as viterbi_align_batch's, except that the
    pairs over MULTI_BLOCK_SLOTS slots (k <= MAX_K) share a bucket with
    those whose padded descendant is within the same power of two: the
    strip body runs each pair's own rows and stripes, so padding to the
    bucket's maxima costs memory only, and pairs of like size share the SMs
    evenly. A bucket is cut where score_launch_bytes would pass
    max_batch_bytes."""
    buckets: dict[object, list[int]] = collections.defaultdict(list)
    shapes = []
    for idx, (na, nb) in enumerate(zip(lens_a, lens_b)):
        qa = max(_round_up(na, quantum), quantum)
        qb = max(_round_up(nb, quantum), quantum)
        shapes.append((qa, qb))
        spread = k <= _fill.MAX_K and qb + k > _fill.MULTI_BLOCK_SLOTS
        buckets[("spread", qb.bit_length()) if spread else (qa, qb)].append(idx)
    chunks = []
    for key, idxs in buckets.items():
        chunk: list[int] = []
        NA = NB = 0
        for idx in idxs:
            qa, qb = shapes[idx]
            na, nb = max(NA, qa), max(NB, qb)
            if chunk and score_launch_bytes(len(chunk) + 1, na, nb, k,
                                            key[0] == "spread", sms) > max_batch_bytes:
                chunks.append(chunk)
                chunk, na, nb = [], qa, qb
            chunk.append(idx)
            NA, NB = na, nb
        chunks.append(chunk)
    return chunks


def enqueue_scores(enc_as, enc_bs, k, lane, params, quantum: int = 96,
                   max_batch_bytes: int = SCORE_BATCH_BYTES) -> list:
    """Phase 1 of viterbi_scores_batch on one lane: every launch that
    score_chunks plans, enqueued with its upload and download. Returns
    [(pair indices, device.Fetch of the corners), ...]."""
    dev = lane.device
    p = params[dev]
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 132)
    inflight = []
    for chunk in score_chunks([len(a) for a in enc_as], [len(b) for b in enc_bs],
                              k, quantum, max_batch_bytes, sms):
        aseq, bseq, la, lb = _pad_batch(
            [enc_as[i] for i in chunk], [enc_bs[i] for i in chunk], quantum,
            lane.staging)
        p.check_codes(aseq, bseq)
        with lane.context():
            corners = _score.wavefront_score(*lane.staging.send(), p.table,
                                             p.gap_consts, k=k)
            inflight.append((chunk, lane.staging.fetch(corners)))
    return inflight


def collect_scores(inflight, n: int) -> np.ndarray:
    """Phase 2 of viterbi_scores_batch: the [n] f32 scores, in input order."""
    scores = np.zeros(n, dtype=np.float32)
    for chunk, fetch in inflight:
        with fetch as (corners,):
            scores[chunk] = corners.max(axis=0)
    return scores


def viterbi_scores_batch(enc_as, enc_bs, table, gap, quantum: int = 96,
                         max_batch_bytes: int = SCORE_BATCH_BYTES,
                         device="cuda") -> np.ndarray:
    """Score-only Viterbi (no traceback storage), O(NA) device memory a
    block boundary: the [n] f32 scores viterbi_align_batch would give, for
    pairs of any length. Launches as score_chunks plans them; every chunk is
    enqueued before the first score is read. Runs on the first lane of
    `device` (resolve_devices), as coati_tpu's runs on one device;
    parallel.mesh.sharded_viterbi_scores spreads it over lanes."""
    lane = resolve_devices(device)[0]
    params = params_by_device([lane], table, gap)
    inflight = enqueue_scores(enc_as, enc_bs, int(gap.len), lane, params,
                              quantum, max_batch_bytes)
    return collect_scores(inflight, len(enc_as))
