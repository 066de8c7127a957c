"""Where the triplet batch spends its time (counterpart of
tools/probe_triplet.py).

triplet_wavefront.triplet_align_batch over N tri-mg pairs of NT nt
(make_pairs, seed 20260820), cut into its steps and each timed alone, the
mean of --reps runs after a warm-up:

  encode   - encode_triplet_pair per pair (host)
  pack     - padding into the staging (device.Staging), the insertion offsets
             and the tables, and the upload
  rows     - the forward rows kernel (kernels/triplet_rows.py)
  walk     - the terminal pick and the walk kernel (kernels/triplet_walk.py)
  fetch    - the copy of the op rows, states and scores back
  decode   - the host's string build from the op rows
  end to end - triplet_align_batch, whole

Device steps by CUDA events on the card (the host clock on the CPU, where
the plain versions run). The steps' strings and scores must equal
triplet_align_batch's.

    python -m coati_tpu_torch.tools.probe_triplet [--device cuda|cpu]
        [--nt 999] [--n 64] [--reps 3]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def run(device: str = "cuda", nt: int = 999, n: int = 64, reps: int = 3) -> dict:
    from coati_tpu_torch import triplet_wavefront as tw
    from coati_tpu_torch.device import Lane
    from coati_tpu_torch.structs import AlignmentParams
    from coati_tpu_torch.tools.common import device_and_label, elapsed_ms, sync
    from coati_tpu_torch.tools.inputs import make_pairs
    from coati_tpu_torch.triplet_hmm import build_triplet_model, encode_triplet_pair

    dev, label = device_and_label(device)
    print(f"# device: {label}", file=sys.stderr)
    model = build_triplet_model(AlignmentParams(model="tri-mg"))
    pairs = make_pairs(n, np.random.default_rng(20260820), length_mix=[(nt, 1.0)])
    true_cells = sum(len(a) * len(d) for a, d in pairs)

    def host_ms(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        sync(dev)
        return (time.perf_counter() - t0) * 1e3 / reps, out

    tw.triplet_align_batch(model, pairs, device=dev)  # warm: the library, allocator, pools
    t_enc, enc = host_ms(lambda: [encode_triplet_pair(model, a, d) for a, d in pairs])
    if any(tw.grid_bytes(len(ea), len(ed), len(enc)) > tw.TRIPLET_BATCH_BYTES
           for ea, ed in enc):
        raise ValueError("the probe takes a batch of one sub-batch")

    lane = Lane(dev)

    def pack():
        tables = tw._pack_batch(model, [e[0] for e in enc], [e[1] for e in enc],
                                dev, lane.staging)[5]
        aj, dj, lt, lm, io = lane.staging.send()
        return (aj, dj, io, lt, lm), tables

    def fetch():
        with lane.staging.fetch(ops, state, score):
            pass

    t_pack, (args, tables) = host_ms(pack)
    t_rows = elapsed_ms(lambda: tw._triplet_rows(*args, *tables), dev, reps)
    grid, amax = tw._triplet_rows(*args, *tables)
    t_walk = elapsed_ms(lambda: tw._triplet_traceback(grid, amax, *args, *tables), dev, reps)
    ops, state, score = tw._triplet_traceback(grid, amax, *args, *tables)
    t_fetch = elapsed_ms(fetch, dev, reps)
    got = lane.staging.fetch(ops, state, score)
    t_dec, steps = host_ms(lambda: tw.decode_group(pairs, got))
    t_e2e, whole = host_ms(lambda: tw.triplet_align_batch(model, pairs, device=dev))
    if steps != whole:
        raise AssertionError("the probed steps differ from triplet_align_batch")
    rows = {"encode": t_enc, "pack": t_pack, "rows": t_rows, "walk": t_walk,
            "fetch": t_fetch, "decode": t_dec, "end to end": t_e2e}
    print(f"# [{label}] {n} pairs x {nt} nt, {true_cells / 1e6:.1f} Mcells, "
          f"B={len(pairs)} n_cod={args[0].shape[1]} m={args[1].shape[1]}")
    for name, t in rows.items():
        print(f"{name:12s} {t:9.3f} ms  {true_cells / t / 1e3:9.1f} Mcells/s")
    return {"device": label, "pairs": n, "nt": nt, "reps": reps, "ms": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m coati_tpu_torch.tools.probe_triplet",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--nt", type=int, default=999)
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    print(json.dumps(run(args.device, args.nt, args.n, args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
