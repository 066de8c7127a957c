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
        from coati_tpu_torch.triplet_hmm import (
            build_triplet_model,
            encode_triplet_pair,
        )
        from coati_tpu_torch.triplet_wavefront import triplet_align_batch

        triplet_model = build_triplet_model(aln)
    done = _load_done(manifest)
    mf = open(manifest, "a") if manifest else None

    todo = [i for i in range(len(pairs)) if i not in done]
    n_aligned = 0
    try:
        for s in range(0, len(todo), chunk):
            enc_as, enc_bs, astrs, bstrs, stops, keep = [], [], [], [], [], []
            for i in todo[s : s + chunk]:
                na, sa, nb, sb = pairs[i]
                d = SeqData(names=[na, nb], seqs=[sa, sb])
                try:
                    if triplet_model is not None:
                        _validate_triplet_pair(d.seqs[0])
                        utils.trim_end_stops(d)
                        ea, eb = encode_triplet_pair(
                            triplet_model, d.seqs[0], d.seqs[1])
                    else:
                        utils.trim_end_stops(d)
                        ea, eb = utils.encode_marginal(d.seqs[0], d.seqs[1])
                except ValueError as exc:
                    out_stream.write(json.dumps(
                        {"pair": i + index_offset, "error": str(exc)}) + "\n")
                    if mf:
                        mf.write(f"{i}\n")
                    continue
                enc_as.append(ea)
                enc_bs.append(eb)
                astrs.append(d.seqs[0])
                bstrs.append(d.seqs[1])
                stops.append(d.stops)
                keep.append(i)
            if not keep:
                continue

            def run_chunk():
                if triplet_model is not None:
                    with lanes[0].context():
                        trip = triplet_align_batch(
                            triplet_model, list(zip(astrs, bstrs)),
                            device=lanes[0].device, enc=list(zip(enc_as, enc_bs)))
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
                d = SeqData(names=[pairs[i][0], pairs[i][2]],
                            seqs=[r.seq0, r.seq1], score=r.score, stops=st)
                utils.restore_end_stops(d, aln.gap)
                out_stream.write(json.dumps({
                    "pair": i + index_offset,
                    "alignment": {d.names[0]: d.seqs[0], d.names[1]: d.seqs[1]},
                    "score": float(np.float32(d.score)),
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
