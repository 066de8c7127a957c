"""Batch alignment stream with a resume manifest (counterpart of
coati_tpu/batchrun.py).

One JSON line per pair goes to the output stream, and every finished pair
index to the manifest, so a restarted run skips finished work.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from coati_tpu_torch import constants as C
from coati_tpu_torch import utils
from coati_tpu_torch.io.fasta import read_fasta
from coati_tpu_torch.structs import AlignmentParams, SeqData


def read_pairs_fasta(path: str):
    """Read a multi-FASTA whose records pair up consecutively
    (anc0, des0, anc1, des1, ...)."""
    with open(path) as f:
        data = read_fasta(f)
    if data.size() % 2 != 0:
        raise ValueError("Pair-stream FASTA must contain an even number of sequences.")
    pairs = []
    for i in range(0, data.size(), 2):
        pairs.append(
            (data.names[i], data.seqs[i], data.names[i + 1], data.seqs[i + 1])
        )
    return pairs


def _validate_triplet_pair(anc: str) -> None:
    """Per-pair ancestor validation for the triplet path (utils.cc:1102-1135
    semantics, applied per stream record instead of per process)."""
    if len(anc) % 3 != 0:
        raise ValueError("Length of reference sequence must be multiple of 3.")
    up = anc.upper()
    for i in range(0, len(up) - 3, 3):
        if up[i : i + 3] in C.STOP_CODON_STRS:
            raise ValueError("Early stop codon in ancestor.")
    if any(ch not in "ACGTUacgtu" for ch in anc):
        raise ValueError(
            "Ambiguous nucleotides in reference sequence not supported."
        )


# every three-letter string that utils.trim_end_stops takes for a stop codon
_STOP_ENDS = frozenset(
    x + y + z for x in "ACGTUacgtu" for y in "ACGTUacgtu" for z in "ACGTUacgtu"
    if (int(C.NT16_TABLE[ord(x)]) << 4 | int(C.NT16_TABLE[ord(y)]) << 2
        | int(C.NT16_TABLE[ord(z)])) in C.STOP_CODONS_64)
_IS_STOP64 = np.zeros(64, dtype=bool)
_IS_STOP64[list(C.STOP_CODONS_64)] = True
# NT16_TABLE for bytes.translate; a codon's three ancestor codes, codon*3+phase
_NT16_BYTES = C.NT16_TABLE.tobytes()
_CODON_CODES = (C.COD64_TO_61[:, None] * 3 + np.arange(3)).astype(np.int32)


def _trim(seq: str) -> tuple[str, str]:
    """(seq less a terminal stop codon, that codon or ""), as
    utils.trim_end_stops trims one sequence."""
    end = seq[-3:]
    return (seq[:-3], end) if end in _STOP_ENDS else (seq, "")


def _pairs_at(offsets: np.ndarray, positions: np.ndarray) -> set:
    """The pairs whose slices of a joined buffer (starts `offsets`) hold
    `positions`."""
    return set((np.searchsorted(offsets, positions, side="right") - 1).tolist())


def encode_marginal_chunk(seqs):
    """Encode a chunk of (ancestor, descendant) pairs for the marginal engine
    in one pass: utils.trim_end_stops and utils.encode_marginal on every
    pair, as one NT16_TABLE lookup over the joined ancestors and one over
    the joined descendants, codons from the three phases, stops through a
    table of 64.

    Returns, a pair, (enc_a, enc_b, trimmed ancestor, trimmed descendant,
    [stop of the ancestor, stop of the descendant]), the code arrays views of
    one buffer; or None for a pair on which encode_marginal raises (length
    not a multiple of 3, an ancestor code above 3, an early stop, a
    descendant code above 15, a string that is not ASCII), left out of the
    buffers so that the codon frame holds."""
    ancs, dess, stops = [], [], []
    for a, d in seqs:
        a, sa = _trim(a)
        d, sd = _trim(d)
        ancs.append(a)
        dess.append(d)
        stops.append([sa, sd])
    bad = {p for p, (a, d) in enumerate(zip(ancs, dess))
           if len(a) % 3 or not (a.isascii() and d.isascii())}
    parts_a = [("" if p in bad else a) for p, a in enumerate(ancs)]
    parts_b = [("" if p in bad else d) for p, d in enumerate(dess)]
    off_a = np.cumsum([0] + [len(a) for a in parts_a])
    off_b = np.cumsum([0] + [len(d) for d in parts_b])

    a_codes = np.frombuffer("".join(parts_a).encode("ascii").translate(_NT16_BYTES),
                            np.uint8)
    bad |= _pairs_at(off_a, np.flatnonzero(a_codes > 3))
    a2 = a_codes & 3  # an ambiguous pair's codons stay in range; it is out
    cods64 = (a2[0::3] << 4) | (a2[1::3] << 2) | a2[2::3]
    bad |= _pairs_at(off_a, 3 * np.flatnonzero(_IS_STOP64[cods64]))
    enc_a = np.take(_CODON_CODES, cods64, axis=0).reshape(-1)

    b_codes = np.frombuffer("".join(parts_b).encode("ascii").translate(_NT16_BYTES),
                            np.uint8)
    bad |= _pairs_at(off_b, np.flatnonzero(b_codes > 15))
    enc_b = b_codes.astype(np.int32)

    oa, ob = off_a.tolist(), off_b.tolist()
    return [None if p in bad else
            (enc_a[oa[p]:oa[p + 1]], enc_b[ob[p]:ob[p + 1]], ancs[p], dess[p], stops[p])
            for p in range(len(seqs))]


def _encode_pair(seq_a: str, seq_b: str, triplet_model):
    """One pair as batch_align encoded it before encode_marginal_chunk, the
    route of the triplet models and of the pairs the chunk encoder leaves out
    (to raise their errors): (enc_a, enc_b, trimmed strings, stops)."""
    d = SeqData(names=["", ""], seqs=[seq_a, seq_b])
    if triplet_model is not None:
        from coati_tpu_torch.triplet_hmm import encode_triplet_pair

        _validate_triplet_pair(d.seqs[0])
        utils.trim_end_stops(d)
        ea, eb = encode_triplet_pair(triplet_model, d.seqs[0], d.seqs[1])
    else:
        utils.trim_end_stops(d)
        ea, eb = utils.encode_marginal(d.seqs[0], d.seqs[1])
    return ea, eb, d.seqs[0], d.seqs[1], d.stops


def _restore_stops(s0: str, s1: str, score: float, stops, gap_score):
    """utils.restore_end_stops on one aligned pair, the gap score given:
    (s0, s1, score)."""
    if len(stops[0]) == len(stops[1]):
        return s0 + stops[0], s1 + stops[1], score
    score = float(np.float32(score) + np.float32(gap_score))
    if not stops[0]:
        return s0 + "---", s1 + stops[1], score
    return s0 + stops[0], s1 + "---", score


def _load_done(manifest: str) -> set:
    done = set()
    if manifest and os.path.exists(manifest):
        with open(manifest) as f:
            for line in f:
                line = line.strip()
                if line:
                    done.add(int(line))
    return done


def batch_align(
    aln: AlignmentParams,
    pairs,
    out_stream,
    manifest: str = "",
    chunk: int = 2048,
    meter=None,
    index_offset: int = 0,
    device="cuda",
) -> int:
    """Align `pairs` [(name_a, seq_a, name_b, seq_b), ...] under the model in
    aln; write one JSON line per pair to out_stream; record completed indices
    in `manifest`. Returns the number of pairs aligned.

    The marginal models go through align/engine.py viterbi_align_batch,
    whose chunks go round-robin over the lanes of `device` (a name, or a
    list of names or lanes: device.resolve_devices), the triplet models
    (tri-mg, tri-ecm, dna) on the first lane through
    triplet_wavefront.triplet_align_batch, which cuts a chunk into
    sub-batches that fit the device.

    meter: optional profiling.ThroughputMeter."""
    from coati_tpu_torch.align.engine import AlignResult, viterbi_align_batch
    from coati_tpu_torch.device import resolve_devices

    lanes = resolve_devices(device)
    utils.set_subst(aln)
    triplet_model = None
    if not aln.is_marginal():
        from coati_tpu_torch.triplet_hmm import build_triplet_model
        from coati_tpu_torch.triplet_wavefront import triplet_align_batch

        triplet_model = build_triplet_model(aln)
    done = _load_done(manifest)
    mf = open(manifest, "a") if manifest else None
    # restore_end_stops's logf(g*e*e), in f32 like the reference
    gap_score = np.log(np.float32(aln.gap.open) * np.float32(aln.gap.extend)
                       * np.float32(aln.gap.extend)).astype(np.float32)

    todo = [i for i in range(len(pairs)) if i not in done]
    n_aligned = 0
    try:
        for s in range(0, len(todo), chunk):
            idxs = todo[s : s + chunk]
            if triplet_model is None:
                encoded = encode_marginal_chunk(
                    [(pairs[i][1], pairs[i][3]) for i in idxs])
            else:
                encoded = [None] * len(idxs)
            enc_as, enc_bs, astrs, bstrs, stops, keep = [], [], [], [], [], []
            for i, e in zip(idxs, encoded):
                if e is None:
                    try:
                        e = _encode_pair(pairs[i][1], pairs[i][3], triplet_model)
                    except ValueError as exc:
                        out_stream.write(json.dumps(
                            {"pair": i + index_offset, "error": str(exc)}) + "\n")
                        if mf:
                            mf.write(f"{i}\n")
                        continue
                enc_as.append(e[0])
                enc_bs.append(e[1])
                astrs.append(e[2])
                bstrs.append(e[3])
                stops.append(e[4])
                keep.append(i)
            if not keep:
                continue

            def run_chunk():
                if triplet_model is not None:
                    with lanes[0].context():
                        trip = triplet_align_batch(
                            triplet_model, list(zip(astrs, bstrs)),
                            device=lanes[0], enc=list(zip(enc_as, enc_bs)))
                    return [AlignResult(s0, s1, sc) for s0, s1, sc in trip]
                return viterbi_align_batch(
                    enc_as, enc_bs, astrs, bstrs, aln.subst_matrix, aln.gap,
                    device=lanes,
                )

            if meter is not None:
                cells = sum(len(a) * len(b) for a, b in zip(astrs, bstrs))
                with meter.measure(cells, len(keep)):
                    results = run_chunk()
            else:
                results = run_chunk()
            for i, r, st in zip(keep, results, stops):
                s0, s1, score = r.seq0, r.seq1, r.score
                if st[0] or st[1]:
                    s0, s1, score = _restore_stops(s0, s1, score, st, gap_score)
                out_stream.write(json.dumps({
                    "pair": i + index_offset,
                    "alignment": {pairs[i][0]: s0, pairs[i][2]: s1},
                    "score": float(np.float32(score)),
                }) + "\n")
                if mf:
                    mf.write(f"{i}\n")
                n_aligned += 1
            if mf:
                mf.flush()
            out_stream.flush()
    finally:
        if mf:
            mf.close()
    return n_aligned


def cmd_batch(argv) -> int:
    """CLI: coati-tpu-torch batch pairs.fasta [-o out.jsonl] [--manifest m.txt]"""
    import argparse

    from coati_tpu_torch.params import alignment_params
    from coati_tpu_torch.profiling import ThroughputMeter, trace

    p = argparse.ArgumentParser(
        prog="coati-tpu-torch batch",
        description="Batch-align a stream of sequence pairs (resumable)",
    )
    p.add_argument("input", help="multi-FASTA of consecutive (anc, des) pairs")
    p.add_argument("-o", "--output", default="", help="output JSONL (default stdout)")
    p.add_argument("--manifest", default="", help="progress manifest for resume")
    p.add_argument("-m", "--model", default="mar-mg",
                   choices=["mar-mg", "mar-ecm", "tri-mg", "tri-ecm", "dna"])
    p.add_argument("-t", "--time", type=float, default=0.0133, dest="br_len")
    p.add_argument("-g", "--gap-open", type=float, default=0.001)
    p.add_argument("-e", "--gap-extend", type=float, default=1 - 1 / 6)
    p.add_argument("-k", "--gap-len", type=int, default=1)
    p.add_argument("-w", "--omega", type=float, default=0.2)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device to align on: cuda, every local card (under "
                   "--multihost this process's own: multihost.local_devices; "
                   "COATI_TPU_MAX_DEVICES caps them), or cpu (default: cuda)")
    p.add_argument("--trace-dir", default="",
                   help="Capture a torch.profiler trace of the run (host "
                   "functions and, on a card, its kernels and copies) into "
                   "this directory, one file a process (TensorBoard, "
                   "Perfetto)")
    p.add_argument("--multihost", action="store_true",
                   help="Multi-process mode: join a torch.distributed (gloo) "
                   "group, align only this process's shard of the pair "
                   "stream, then merge: scores are allgathered into a global "
                   "manifest and process 0 concatenates the per-process shard "
                   "files when they share a filesystem")
    p.add_argument("--coordinator", default=None,
                   help="torch.distributed rendezvous address (host:port; "
                   "default: the env:// variables when set, else one process)")
    p.add_argument("--nproc", type=int, default=None,
                   help="torch.distributed process count")
    p.add_argument("--pid", type=int, default=None,
                   help="torch.distributed process index")
    args = p.parse_args(argv)

    aln = alignment_params(args.model, args.br_len, args.omega, args.gap_open,
                           args.gap_extend, args.gap_len)

    pairs = read_pairs_fasta(args.input)
    output_base = args.output
    n_total = len(pairs)
    shard_lo = 0
    started = False
    device = args.device
    if args.multihost:
        # each process aligns a contiguous shard on its own cards; the merge
        # below collates
        from coati_tpu_torch.parallel.multihost import (
            host_shard,
            init_distributed,
            local_devices,
            rank,
            shard_bounds,
        )

        if device == "cuda":
            device = local_devices() or device  # no card: resolve_devices raises
        started = init_distributed(args.coordinator, args.nproc, args.pid)
        shard_lo, _ = shard_bounds(n_total)
        pairs = host_shard(pairs)
        if args.output:
            args.output = f"{args.output}.{rank()}"
        if args.manifest:
            args.manifest = f"{args.manifest}.{rank()}"
    try:
        out = open(args.output, "w" if not args.manifest else "a") \
            if args.output else sys.stdout
        meter = ThroughputMeter()
        try:
            with trace(args.trace_dir or None, device):
                n = batch_align(aln, pairs, out, manifest=args.manifest,
                                meter=meter, index_offset=shard_lo, device=device)
        finally:
            if args.output:
                out.close()

        if args.multihost:
            from coati_tpu_torch.parallel.multihost import merge_multihost_outputs

            local_scores = np.full(len(pairs), np.nan, np.float32)
            if args.output:
                with open(args.output) as f:
                    for line in f:
                        row = json.loads(line)
                        if "score" in row:
                            local_scores[row["pair"] - shard_lo] = row["score"]
            _, merged = merge_multihost_outputs(output_base, local_scores, n_total)
            if merged:
                print(f"merged {n_total}-pair output -> {merged}", file=sys.stderr)
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()
    stats = meter.summary()
    print(f"aligned {n} pairs: {stats['cells_per_sec'] / 1e6:.0f} Mcells/s, "
          f"{stats['pairs_per_sec']:.1f} pairs/s "
          f"({stats['seconds']:.1f}s engine time)", file=sys.stderr)
    print(json.dumps({"metrics": stats}), file=sys.stderr)
    return 0
