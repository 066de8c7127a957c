"""The long-pair path on the card, written as evidence to
tests/data/torch_gpu_longpair.json (counterpart of tools/run_longpair.py,
which writes LONGPAIR.json).

Aligns the JAX tool's two seeded pairs, 10,667 and 53,334 codons (32,001 and
160,002 nt: the reference's largest benchmark and sampledata scales),
through align/engine.py viterbi_align_batch, whose default byte budget
sends the 160,002 nt pair down the two-pass long path of align/longseq.py
(bands of rows) and lets the 32,001 nt pair's stack of rows (1.03 GB) take
the fill: one cold pass (the first use of each shape) and one warm pass,
timed whole, strings included. Records LONGPAIR.json's fields, each pair's
route, the cold wall, and the peak of torch.cuda.max_memory_allocated.

    python -m coati_tpu_torch.tools.run_longpair [--device cuda|cpu] [--quick] [-o PATH]

--quick aligns one pair of 2,667 codons instead.
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "tests" / "data" / "torch_gpu_longpair.json"
SIZES = (10667, 53334)  # codons: 32,001 and 160,002 nt
QUICK_SIZES = (2667,)


def run(device: str = "cuda", sizes=SIZES) -> dict:
    import torch

    from coati_tpu_torch.align.engine import viterbi_align_batch
    from coati_tpu_torch.align.longseq import is_long_pair
    from coati_tpu_torch.params import alignment_params
    from coati_tpu_torch.provenance import kernel_hash
    from coati_tpu_torch.tools.common import device_and_label, wall_s
    from coati_tpu_torch.tools.inputs import make_pair
    from coati_tpu_torch.utils import encode_marginal

    dev, label = device_and_label(device)
    print(f"# device: {label}", file=sys.stderr)
    aln = alignment_params("mar-mg")  # t 0.0133, omega 0.2, k 1
    table, gap = aln.subst_matrix, aln.gap
    runs = []
    for n_cod in sizes:
        anc, des = make_pair(np.random.default_rng(20260819 + n_cod), n_cod)
        ea, eb = encode_marginal(anc, des)
        cells = len(ea) * len(eb)
        print(f"# aligning {len(ea)} x {len(eb)} nt ({cells / 1e9:.1f} Gcells)",
              file=sys.stderr)

        def align():
            return viterbi_align_batch([ea], [eb], [anc], [des], table, gap,
                                       device=dev)[0]

        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        cold, _ = wall_s(align, dev)
        dt, r = wall_s(align, dev)
        if len(r.seq0) != len(r.seq1) or not np.isfinite(r.score):
            raise AssertionError(f"{len(ea)} nt: a malformed alignment")
        if r.seq0.replace("-", "") != anc or r.seq1.replace("-", "") != des:
            raise AssertionError(f"{len(ea)} nt: the alignment does not ungap to its inputs")
        peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        runs.append({
            "nt": len(ea),
            "nt_des": len(eb),
            "route": "long" if is_long_pair(len(ea), len(eb), int(gap.len)) else "fill",
            "cells": cells,
            "cold_seconds": round(cold, 3),
            "wall_seconds": round(dt, 3),
            "cells_per_sec": round(cells / dt, 0),
            "score": float(r.score),
            "aligned_len": len(r.seq0),
            "peak_rss_kb": int(peak_kb),
            "max_memory_allocated": (int(torch.cuda.max_memory_allocated(dev))
                                     if dev.type == "cuda" else None),
            "device": label,
        })
        print(f"#   cold {cold:.2f} s, warm {dt:.2f} s, {cells / dt / 1e9:.2f} Gcells/s, "
              f"peak RSS {peak_kb / 1e6:.2f} GB", file=sys.stderr)
    return {
        "note": ("viterbi_align_batch at its default byte budget, strings "
                 "included; wall of the warm pass. route 'long': the "
                 "O(n)-memory two-pass traceback of align/longseq.py (a "
                 "checkpointing score pass, then bands of rows refilled with "
                 "backpointers and walked); 'fill': the whole stack of rows "
                 "fits the budget"),
        "generated": time.strftime("%Y-%m-%d %H:%M:%S"),
        "runs": runs,
        "kernel_hash": kernel_hash(REPO),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m coati_tpu_torch.tools.run_longpair",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--quick", action="store_true",
                   help=f"one pair of {QUICK_SIZES[0]} codons")
    p.add_argument("-o", "--output", default=str(OUT), help=f"record (default {OUT})")
    args = p.parse_args(argv)
    blob = run(args.device, QUICK_SIZES if args.quick else SIZES)
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Path(args.output).write_text(json.dumps(blob, indent=1) + "\n")
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
