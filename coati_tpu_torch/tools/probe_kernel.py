"""The Viterbi kernels' time at a bucket shape (counterpart of
tools/probe_kernel.py).

For each shape NA x NB x B (random codes, every pair at full length, k = 1)
it times, over M launches each, with CUDA events on the card:

  full      - the engine's chunk step, engine.fused_align_ops: the fill with
              backpointers, then the walk
  fill+bp   - the fill kernel alone (kernels/wavefront_fill.py)
  score     - score-only Viterbi (kernels/wavefront_score.py), no backpointers

and prints true cells/s and slot cells/s (the padded matrix). The TPU
probe's stacked rows have no counterpart: the port does not stack pairs
along the diagonal. On the CPU the same steps run the plain versions, timed
on the host clock.

    python -m coati_tpu_torch.tools.probe_kernel [--device cuda|cpu]
        [--shapes 480x480x1024,1056x1056x256] [--reps M]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

SHAPES = "480x480x1024,1056x1056x256"


def run(device: str = "cuda", shapes: str = SHAPES, reps: int = 10) -> dict:
    import torch

    from coati_tpu_torch.align import engine
    from coati_tpu_torch.kernels import wavefront_fill as fill_k
    from coati_tpu_torch.kernels import wavefront_score as score_k
    from coati_tpu_torch.params import alignment_params, params_from_numpy
    from coati_tpu_torch.tools.common import device_and_label, elapsed_ms

    dev, label = device_and_label(device)
    print(f"# device: {label}", file=sys.stderr)
    aln = alignment_params("mar-mg")
    k = 1
    p = params_from_numpy(aln.subst_matrix, aln.gap, dev)
    rng = np.random.default_rng(0)
    rows = []
    for shape in shapes.split(","):
        NA, NB, B = (int(v) for v in shape.split("x"))
        a = torch.from_numpy(rng.integers(0, 183, (B, NA)).astype(np.int32)).to(dev)
        b = torch.from_numpy(rng.integers(0, 4, (B, NB)).astype(np.int32)).to(dev)
        la = torch.full((B,), NA, dtype=torch.int32, device=dev)
        lb = torch.full((B,), NB, dtype=torch.int32, device=dev)
        args = (a, b, la, lb, p.table, p.gap_consts)
        true_cells = float(B) * NA * NB
        slot_cells = float(B) * (NA + k) * (NB + k)
        stages = {
            "full": lambda: engine.fused_align_ops(*args, k=k, max_steps=NA + NB),
            "fill+bp": lambda: fill_k.wavefront_fill(*args, k=k),
            "score": lambda: score_k.wavefront_score(*args, k=k),
        }
        for name, fn in stages.items():
            t = elapsed_ms(fn, dev, reps)
            rows.append({"shape": [NA, NB, B], "stage": name, "ms": t,
                         "gtrue_s": true_cells / t / 1e6, "gslot_s": slot_cells / t / 1e6})
            print(f"[{label}] NA={NA} NB={NB} B={B} {name}: {t:.3f} ms, "
                  f"{true_cells / t / 1e6:.2f} Gtrue/s, {slot_cells / t / 1e6:.2f} "
                  f"Gslot/s (mean of {reps})", flush=True)
        del a, b, args
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"device": label, "reps": reps, "rows": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m coati_tpu_torch.tools.probe_kernel",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--shapes", default=SHAPES, help="NAxNBxB,... (nt, nt, pairs)")
    p.add_argument("--reps", type=int, default=10, help="launches a stage (M)")
    args = p.parse_args(argv)
    print(json.dumps(run(args.device, args.shapes, args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
