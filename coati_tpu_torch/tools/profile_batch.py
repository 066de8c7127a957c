"""Where the mixed batch spends its time (counterpart of
tools/profile_batch.py).

The bench's mixed batch (make_pairs, seed 20260817, 10,000 pairs by
default) goes through the steps of align/engine.py viterbi_align_batch, one
at a time, timed apart, by chunk:

  encode  - as batch_align does: batchrun.encode_marginal_chunk over chunks of
            2,048 pairs (end stops trimmed, one pass over each chunk)
  prep    - bucketing by padded shape and the padding of each chunk into the
            lane's staging (device.Staging)
  launch  - the host's time to upload a chunk and enqueue its kernels and copy
  fill, walk, copy - device milliseconds of the fill kernel, the walk kernel
            and the copy of ops and scores back (CUDA events; on the CPU the
            host clock around the plain versions)
  block   - the host waiting for the device once everything is enqueued
  strings - the native string build (ops_to_strings)

Three passes, the first cold, each checked against viterbi_align_batch on
the same pairs.

    python -m coati_tpu_torch.tools.profile_batch [--device cuda|cpu] [--pairs N]
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time

import numpy as np

CHUNK = 2048  # batch_align's default chunk


def run(device: str = "cuda", n_pairs: int = 10_000, passes: int = 3,
        length_mix=None) -> dict:
    import torch

    from coati_tpu_torch.align import engine, longseq
    from coati_tpu_torch.batchrun import encode_marginal_chunk
    from coati_tpu_torch.device import Lane
    from coati_tpu_torch.kernels import traceback_walk as walk_k
    from coati_tpu_torch.kernels import wavefront_fill as fill_k
    from coati_tpu_torch.params import alignment_params, params_from_numpy
    from coati_tpu_torch.tools.common import device_and_label, sync
    from coati_tpu_torch.tools.inputs import LENGTH_MIX, make_pairs

    dev, label = device_and_label(device)
    print(f"# device: {label}", file=sys.stderr)
    pairs = make_pairs(n_pairs, np.random.default_rng(20260817),
                       length_mix=length_mix or LENGTH_MIX)
    aln = alignment_params("mar-mg")
    gap, k = aln.gap, int(aln.gap.len)
    params = params_from_numpy(aln.subst_matrix, gap, dev)
    quantum, max_batch_cells = 96, 1 << 30
    on_card = dev.type == "cuda"
    lane = Lane(dev)

    def mark():
        if not on_card:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(a, b):
        return a.elapsed_time(b) if on_card else (b - a) * 1e3

    reports = []
    for p in range(passes):
        t_all = time.perf_counter()
        t0 = time.perf_counter()
        encoded = [e for s in range(0, len(pairs), CHUNK)
                   for e in encode_marginal_chunk(pairs[s:s + CHUNK])]
        if any(e is None for e in encoded):
            raise ValueError("the profile takes no pair that fails to encode")
        enc_as, enc_bs, astrs, bstrs, _ = zip(*encoded)
        t_encode = time.perf_counter() - t0

        t0 = time.perf_counter()
        buckets = collections.defaultdict(list)
        for idx, (a, b) in enumerate(zip(enc_as, enc_bs)):
            if longseq.is_long_pair(len(a), len(b), k):
                raise ValueError("the profile takes no long pair")
            qa = max(engine._round_up(len(a), quantum), quantum)
            qb = max(engine._round_up(len(b), quantum), quantum)
            buckets[(qa, qb)].append(idx)
        t_prep = time.perf_counter() - t0
        t_launch = 0.0
        inflight = []
        for (qa, qb), idxs in buckets.items():
            max_b = max(1, max_batch_cells // ((qa + k) * (qb + k)))
            for s in range(0, len(idxs), max_b):
                chunk = idxs[s: s + max_b]
                t0 = time.perf_counter()
                aseq, bseq, la, lb = engine._pad_batch(
                    [enc_as[i] for i in chunk], [enc_bs[i] for i in chunk], quantum,
                    lane.staging)
                params.check_codes(aseq, bseq)
                t1 = time.perf_counter()
                args = lane.staging.send()
                marks = [mark()]
                corners, bp = fill_k.wavefront_fill(*args, params.table,
                                                    params.gap_consts, k=k)
                marks.append(mark())
                ops, score = walk_k.traceback_walk(bp, corners, args[2], args[3], k=k,
                                                   max_steps=max(1, int(np.max(la + lb))))
                marks.append(mark())
                got = lane.staging.fetch(ops, score)
                marks.append(mark())
                t2 = time.perf_counter()
                t_prep += t1 - t0
                t_launch += t2 - t1
                inflight.append(((qa, qb), chunk, got, marks, (t1 - t0) * 1e3))
        t0 = time.perf_counter()
        sync(dev)
        t_block = time.perf_counter() - t0

        t_strings = 0.0
        results = [None] * len(pairs)
        chunks = []
        for shape, chunk, got, marks, pad_ms in inflight:
            with got as (ops, score):
                t0 = time.perf_counter()
                out = engine.ops_to_strings(ops[::-1], score,
                                            [astrs[i] for i in chunk],
                                            [bstrs[i] for i in chunk], k)
                dt = time.perf_counter() - t0
            t_strings += dt
            for i, r in zip(chunk, out):
                results[i] = r
            chunks.append({"shape": list(shape), "pairs": len(chunk),
                           "pad_ms": pad_ms, "fill_ms": ms(marks[0], marks[1]),
                           "walk_ms": ms(marks[1], marks[2]),
                           "copy_ms": ms(marks[2], marks[3]), "strings_ms": dt * 1e3})
        t_total = time.perf_counter() - t_all

        want = engine.viterbi_align_batch(enc_as, enc_bs, astrs, bstrs,
                                          aln.subst_matrix, gap, device=dev)
        if [(r.seq0, r.seq1, r.score) for r in results] != \
                [(r.seq0, r.seq1, r.score) for r in want]:
            raise AssertionError("the profiled steps differ from viterbi_align_batch")
        rep = {"pass": p, "pairs": len(pairs), "total_s": t_total,
               "encode_s": t_encode, "prep_s": t_prep, "launch_s": t_launch,
               "block_s": t_block, "strings_s": t_strings,
               "fill_ms": sum(c["fill_ms"] for c in chunks),
               "walk_ms": sum(c["walk_ms"] for c in chunks),
               "copy_ms": sum(c["copy_ms"] for c in chunks),
               "chunks": len(chunks), "buckets": len(buckets)}
        print(f"[{label}] pass {p}: {len(pairs)} pairs {t_total:.3f} s = "
              f"{len(pairs) / t_total:.1f} aln/s; encode {t_encode:.3f} s, prep "
              f"{t_prep:.3f}, launch {t_launch:.3f}, block {t_block:.3f}, strings "
              f"{t_strings:.3f}; fill {rep['fill_ms']:.1f} ms, walk {rep['walk_ms']:.1f} ms, "
              f"copy {rep['copy_ms']:.1f} ms over {len(chunks)} chunks of "
              f"{len(buckets)} buckets; equal to viterbi_align_batch", flush=True)
        for c in chunks:
            print(f"    chunk {c['shape']} n={c['pairs']} pad {c['pad_ms']:.2f} ms, "
                  f"fill {c['fill_ms']:.3f}, walk {c['walk_ms']:.3f}, copy "
                  f"{c['copy_ms']:.3f}, strings {c['strings_ms']:.2f}")
        rep["by_chunk"] = chunks
        reports.append(rep)
    return {"device": label, "passes": reports}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m coati_tpu_torch.tools.profile_batch",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--pairs", type=int, default=10_000)
    args = p.parse_args(argv)
    out = run(args.device, args.pairs)
    print(json.dumps({"device": out["device"], "passes": [
        {k: v for k, v in r.items() if k != "by_chunk"} for r in out["passes"]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
