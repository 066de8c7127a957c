"""Parity of the port's engines on the card with the f32 oracles, written as
evidence to tests/data/torch_gpu_parity.json (counterpart of
tools/tpu_parity_check.py, which writes TPU_PARITY.json).

The marginal groups go through align/engine.py viterbi_align_batch (the
fill and walk kernels up to k = 8, the sweep and segment walk above) and
are held to align/oracle.py, the reference align_pair.cc's f32 recurrence
and greedy traceback; the tri-mg group goes through
triplet_wavefront.triplet_align_batch (the triplet rows and walk kernels)
and is held to the host engine triplet_hmm.triplet_align. A pair passes when
its strings are equal and its score is within 1e-4 (2e-3 for triplet), the
JAX tool's criteria; the largest score difference is recorded too.

The seed (20260819) and the draw order are the JAX tool's, so the first four
groups are TPU_PARITY.json's 264 pairs: scattered k=1 (80) and k=3 (24)
with IUPAC codes in the descendant, 128 pairs of one shape (k=1), 32 tri-mg
pairs. Then 24 pairs at each of k = 2, 4, 5, 6, 7, 8 (every strip body of
the fill) and 9 (the sweep route).

    python -m coati_tpu_torch.tools.gpu_parity_check [--device cuda|cpu] [-o PATH]

Exit code 1 on any mismatch.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "tests" / "data" / "torch_gpu_parity.json"
SEED = 20260819
SCORE_TOL = 1e-4
TRIPLET_SCORE_TOL = 2e-3
EXTRA_KS = (2, 4, 5, 6, 7, 8, 9)
EXTRA_PAIRS = 24
EXTRA_MAX_CODONS = 40


def draw_groups(rng):
    """[(label, k or None for tri-mg, pairs)] in the JAX tool's draw order,
    then the groups at EXTRA_KS."""
    from coati_tpu_torch.constants import CODONS61
    from coati_tpu_torch.tools.inputs import make_group

    groups = [
        ("scattered-k1", 1, make_group(rng, 80, 1, 40)),
        ("scattered-k3", 3, make_group(rng, 24, 3, 30)),
        ("stacked-k1", 1, make_group(rng, 128, 1, 22, ambig_frac=0.0)),
    ]
    codon_arr = np.array(CODONS61)
    nts = np.array(list("ACGT"))
    tri = []
    for _ in range(32):
        n_cod = int(rng.integers(2, 16))
        anc = "".join(rng.choice(codon_arr, size=n_cod))
        des = "".join(rng.choice(nts, size=int(rng.integers(3, 3 * n_cod + 4))))
        tri.append((anc, des))
    groups.append(("triplet", None, tri))
    for k in EXTRA_KS:
        groups.append((f"scattered-k{k}", k,
                       make_group(rng, EXTRA_PAIRS, k, EXTRA_MAX_CODONS)))
    return groups


def check_marginal(label, k, pairs, table, dev):
    """Mismatch records and the largest score difference of one group."""
    from coati_tpu_torch import utils
    from coati_tpu_torch.align import oracle
    from coati_tpu_torch.align.engine import viterbi_align_batch
    from coati_tpu_torch.structs import GapParams

    gap = GapParams(len=k)
    enc = [utils.encode_marginal(a, d) for a, d in pairs]
    results = viterbi_align_batch([e[0] for e in enc], [e[1] for e in enc],
                                  [p[0] for p in pairs], [p[1] for p in pairs],
                                  table, gap, device=dev)
    bad, worst = [], 0.0
    for (anc, des), (ea, eb), r in zip(pairs, enc, results):
        w = oracle.forward_oracle(ea, eb, table, gap, oracle.TROPICAL)
        s0, s1, score = oracle.traceback(w, anc, des, gap)
        diff = abs(r.score - float(score))
        worst = max(worst, diff)
        if (r.seq0, r.seq1) != (s0, s1) or not diff <= SCORE_TOL:
            bad.append({"group": label, "k": k, "anc": anc, "des": des,
                        "engine": [r.seq0, r.seq1, r.score],
                        "oracle": [s0, s1, float(score)]})
    return bad, worst


def check_triplet(label, pairs, dev):
    from coati_tpu_torch.structs import AlignmentParams
    from coati_tpu_torch.triplet_hmm import build_triplet_model, triplet_align
    from coati_tpu_torch.triplet_wavefront import triplet_align_batch

    model = build_triplet_model(AlignmentParams(model="tri-mg"))
    got = triplet_align_batch(model, pairs, device=dev)
    bad, worst = [], 0.0
    for (anc, des), (s0, s1, sc) in zip(pairs, got):
        h0, h1, hsc = triplet_align(model, anc, des)
        diff = abs(sc - hsc)
        worst = max(worst, diff)
        if (s0, s1) != (h0, h1) or not diff <= TRIPLET_SCORE_TOL:
            bad.append({"group": label, "anc": anc, "des": des,
                        "engine": [s0, s1, sc], "oracle": [h0, h1, hsc]})
    return bad, worst


def run(device: str = "cuda", per_group: int | None = None) -> dict:
    """Check every group on `device` (per_group: only the first pairs of
    each, all drawn, so they stay the same); the verdict as it is written."""
    from coati_tpu_torch.params import alignment_params
    from coati_tpu_torch.provenance import kernel_hash
    from coati_tpu_torch.tools.common import device_and_label, sync

    dev, label = device_and_label(device)
    print(f"# device: {label}", file=sys.stderr)
    table = alignment_params("mar-mg").subst_matrix  # t 0.0133, omega 0.2
    groups = draw_groups(np.random.default_rng(SEED))
    n_total, mismatches, summary = 0, [], []
    t0 = time.perf_counter()
    for name, k, pairs in groups:
        pairs = pairs[:per_group] if per_group else pairs
        if k is None:
            bad, worst = check_triplet(name, pairs, dev)
        else:
            bad, worst = check_marginal(name, k, pairs, table, dev)
        sync(dev)
        n_total += len(pairs)
        mismatches += bad
        summary.append({"group": name, "k": k, "n_pairs": len(pairs),
                        "n_mismatches": len(bad), "max_score_diff": worst})
        print(f"# {name}: {len(pairs)} pairs, {len(bad)} mismatches, largest "
              f"score difference {worst:.3g}", file=sys.stderr)
    return {
        "ok": not mismatches,
        "n_pairs": n_total,
        "n_mismatches": len(mismatches),
        "mismatches": mismatches[:5],
        "groups": summary,
        "max_score_diff": max(g["max_score_diff"] for g in summary),
        "device": label,
        "seconds": round(time.perf_counter() - t0, 1),
        "kernel_hash": kernel_hash(REPO),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m coati_tpu_torch.tools.gpu_parity_check",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("-o", "--output", default=str(OUT), help=f"verdict (default {OUT})")
    args = p.parse_args(argv)
    out = run(args.device)
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Path(args.output).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({k: out[k] for k in ("ok", "n_pairs", "n_mismatches", "device")}))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
