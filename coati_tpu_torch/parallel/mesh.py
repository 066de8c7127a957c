"""Data parallelism over a list of lanes: split, enqueue on each lane, gather.

Counterpart of coati_tpu/parallel/mesh.py. The workload is data-parallel
over sequence pairs: the model tables are tiny and go to each device once,
the pair batch is cut into contiguous shards, one a lane, each shard runs
the single-device engine's own step on its lane's stream, and only op codes
and scores come back, gathered in input order, through each lane's staging
(device.Staging). torch has no shard_map; a mesh here is a list of lanes
(device.resolve_devices) on one "data" axis. A pair's result does not
depend on its shard, bucket or chunk, so every entry point gives the
single-device results, bit for bit. Each shard is its own list on its own
lane, so, unlike the JAX package's shard_map, nothing needs equal shards:
the shards are ceil(n / lanes) long, the last one ragged, and nothing is
padded.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from coati_tpu_torch.align import engine
from coati_tpu_torch.device import Lane, resolve_devices


@dataclasses.dataclass
class Mesh:
    """The lanes of one "data" axis."""

    lanes: list[Lane]

    @property
    def size(self) -> int:
        return len(self.lanes)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D data-parallel mesh over the first n_devices lanes of `devices`
    (resolve_devices: names, a repeated name, or lanes; by default every
    local card)."""
    lanes = resolve_devices("cuda" if devices is None else devices)
    if n_devices is not None:
        if n_devices > len(lanes):
            raise ValueError(f"need {n_devices} lanes, have {len(lanes)}")
        lanes = lanes[:n_devices]
    return Mesh(lanes)


def _shards(mesh: Mesh, n: int) -> list[tuple[Lane, int, int]]:
    """(lane, lo, hi) of each lane's contiguous shard [lo, hi) of n items,
    ceil(n / lanes) a lane; lanes past the end get none."""
    per = -(-n // mesh.size)
    return [(lane, q * per, min(n, (q + 1) * per))
            for q, lane in enumerate(mesh.lanes) if q * per < n]


def _offset(inflight, lo: int) -> list:
    """A shard's in-flight chunks with their pair indices made global."""
    return [([lo + i for i in chunk], d) for chunk, d in inflight]


def sharded_viterbi_scores(enc_as, enc_bs, table, gap, mesh: Mesh,
                           quantum: int = 96) -> np.ndarray:
    """Viterbi scores [n] f32 for a pair batch, one contiguous shard a lane:
    each shard's launches (engine.viterbi_scores_batch's plan) are enqueued
    on its lane before the first score is read."""
    params = engine.params_by_device(mesh.lanes, table, gap)
    inflight = []
    for lane, lo, hi in _shards(mesh, len(enc_as)):
        inflight += _offset(engine.enqueue_scores(
            enc_as[lo:hi], enc_bs[lo:hi], int(gap.len), lane, params, quantum), lo)
    return engine.collect_scores(inflight, len(enc_as))


def sharded_align_step(aseq, bseq, lens_a, lens_b, table, gap_consts, *, k,
                       mesh: Mesh):
    """The fused fill + walk of an already padded batch with its rows split
    over the lanes: numpy aseq [B, NA], bseq [B, NB], lens_a, lens_b [B],
    table [rows, 15] f32, gap_consts [4] f32. Each shard of rows goes through
    engine.fused_align_ops on its lane's stream. Returns numpy (ops [steps,
    B] int8 in walk order, -1 after each walk's end, scores [B] f32); each
    shard's ops are padded with -1 at the end of the walk order to the
    longest shard's steps, so that ops[::-1] is engine.ops_to_strings'
    forward order."""
    table32 = np.ascontiguousarray(table, dtype=np.float32)
    gc32 = np.ascontiguousarray(gap_consts, dtype=np.float32)
    on_device = {}
    inflight = []
    for lane, lo, hi in _shards(mesh, aseq.shape[0]):
        dev = lane.device
        if dev not in on_device:
            on_device[dev] = (torch.from_numpy(table32).to(dev),
                              torch.from_numpy(gc32).to(dev))
        tbl, gc = on_device[dev]
        lane.share(tbl, gc)
        shard = [x[lo:hi] for x in (aseq, bseq, lens_a, lens_b)]
        for dst, x in zip(lane.staging.stage(*((x.shape, x.dtype) for x in shard)),
                          shard):
            dst[...] = x
        with lane.context():
            ops, score = engine.fused_align_ops(
                *lane.staging.send(), tbl, gc, k=k,
                max_steps=max(1, int(np.max(shard[2] + shard[3]))))
            inflight.append(lane.staging.fetch(ops, score))
    ops_out, scores = [], []
    for fetch in inflight:
        with fetch as (ops, score):
            ops_out.append(ops.copy())
            scores.append(score.copy())
    steps = max(o.shape[0] for o in ops_out)
    ops_out = [np.concatenate([o, np.full((steps - o.shape[0], o.shape[1]), -1, np.int8)])
               for o in ops_out]
    return np.concatenate(ops_out, axis=1), np.concatenate(scores)


def sharded_viterbi_align_batch(enc_as, enc_bs, a_strs, b_strs, table, gap,
                                mesh: Mesh, quantum: int = 96):
    """Alignments of a pair batch over the mesh's lanes: the engine's own
    round-robin (engine.viterbi_align_batch with the lanes as its device),
    whose chunks go to the lanes in turn, a bucket cut so that every lane
    gets work. Returns a list of AlignResult in input order."""
    return engine.viterbi_align_batch(enc_as, enc_bs, a_strs, b_strs, table, gap,
                                      quantum=quantum, device=mesh.lanes)


def sharded_triplet_align_batch(model, pairs, mesh: Mesh):
    """Triplet alignments [(seq0, seq1, score), ...] of (anc, des) string
    pairs, one contiguous shard a lane: each shard cut into sub-batches as
    triplet_wavefront.triplet_align_batch cuts a batch, each sub-batch's
    forward rows and device traceback enqueued on its lane
    (triplet_wavefront.enqueue_group), then all decoded in order. A pair
    over the segmented path's budget runs triplet_align_long on its lane;
    the dna model, which has no codon lanes, the host engine. Strings and
    scores are those of triplet_align_batch and triplet_hmm.triplet_align."""
    from coati_tpu_torch import triplet_wavefront as tw
    from coati_tpu_torch.triplet_hmm import encode_triplet_pair, triplet_align

    if not model.codon:
        return [triplet_align(model, a, d) for a, d in pairs]
    enc = [encode_triplet_pair(model, a, d) for a, d in pairs]
    out = [None] * len(pairs)
    inflight = []
    for lane, lo, hi in _shards(mesh, len(pairs)):
        for idxs, long in tw._sub_batches(enc[lo:hi]):
            idxs = [lo + i for i in idxs]
            with lane.context():
                if long:
                    out[idxs[0]] = tw.triplet_align_long(
                        model, *pairs[idxs[0]], device=lane)
                else:
                    inflight.append((idxs, tw.enqueue_group(
                        model, [enc[i] for i in idxs], lane)))
    for idxs, fetch in inflight:
        for i, r in zip(idxs, tw.decode_group([pairs[i] for i in idxs], fetch)):
            out[i] = r
    return out


def sharded_sample_batch(mdi, corners, enc_a, enc_b, table, a: str, b: str,
                         gap, seed_u64: int, n: int, mesh: Mesh):
    """n alignments drawn from the Forward distribution with the draws split
    over the lanes: [(s0, s1, score), ...] in draw order.

    mdi [R, Cc, 3] f32 and corners as align/sample_device.py
    sample_batch_device takes them (the corners are written into mdi in
    place). The matrices go once to each distinct device of the lanes. The
    uniforms are drawn on mdi's device from one generator, in the chunks and
    order in which sample_batch_device draws them, and each lane walks its
    contiguous slice of the columns (kernels/sample_walk.py). A walk reads
    only its own column, so the samples equal sample_batch_device's for the
    seed, whatever the number of lanes (the JAX package splits its key by
    device, so its samples depend on the mesh size)."""
    from coati_tpu_torch import native
    from coati_tpu_torch.align.sample_device import (
        SAMPLE_CHUNK,
        sample_uniforms,
        walk_inputs,
    )
    from coati_tpu_torch.kernels.sample_walk import sample_walk

    k = int(gap.len)
    if n <= 0:
        return []
    uniforms = torch.cat(list(sample_uniforms(
        mdi.device, seed_u64, len(enc_a) + len(enc_b), n)), dim=1)
    inputs = {mdi.device: (mdi, *walk_inputs(mdi, corners, enc_a, enc_b, table, gap),
                           uniforms)}
    inflight = []
    for lane, lo, hi in _shards(mesh, n):
        dev = lane.device
        if dev not in inputs:
            inputs[dev] = tuple(t.to(dev) for t in inputs[mdi.device])
        lane.share(*inputs[dev])
        m, tbl, gc, ea, eb, u = inputs[dev]
        with lane.context():
            for c in range(lo, hi, SAMPLE_CHUNK):
                cols = u[:, c:min(hi, c + SAMPLE_CHUNK)].contiguous()
                inflight.append(lane.staging.fetch(
                    *sample_walk(m, ea, eb, tbl, gc, cols, k=k)))
    out = []
    for fetch in inflight:
        with fetch as (ops, scores):
            nb = ops.shape[1]
            strings = native.ops_to_strings_native(ops[::-1], [a] * nb, [b] * nb, k)
            out += [(s0, s1, float(sc)) for (s0, s1), sc in zip(strings, scores)]
    return out
