"""A dry run of every multi-lane path on tiny shapes (counterpart of
__graft_entry__.py dryrun_multichip).

    python -m coati_tpu_torch.parallel.dryrun                  # two streams on the first card
    python -m coati_tpu_torch.parallel.dryrun cuda:0 cuda:1    # two cards
    python -m coati_tpu_torch.parallel.dryrun cpu cpu cpu      # three CPU lanes
"""

from __future__ import annotations

import sys

import numpy as np


def dryrun_multichip(devices) -> str:
    """Run the production batch paths over the lanes of `devices`
    (device.resolve_devices: ["cpu"] * 3, ["cuda:0", "cuda:0"], ...) on
    tiny shapes, with odd pair counts so that the last shard is shorter
    than the others:

    1. sharded_viterbi_align_batch (the round-robin engine over the lanes),
       and sharded_align_step with a padded batch's rows split over the
       lanes, against the engine on the first lane alone;
    2. sharded_triplet_align_batch under tri-mg against the host engine
       triplet_hmm.triplet_align;
    3. sharded_sample_batch: the same samples twice for a seed, equal to
       sample_batch_device's on the first lane, every path an alignment of
       the input pair.

    Strings and scores must be equal, tolerance 0. Raises AssertionError on
    a difference; returns a one-line summary."""
    from coati_tpu_torch import triplet_hmm
    from coati_tpu_torch.align import engine
    from coati_tpu_torch.align.sample_device import sample_batch_device
    from coati_tpu_torch.constants import CODONS61
    from coati_tpu_torch.driver import _forward_diag
    from coati_tpu_torch.params import alignment_params
    from coati_tpu_torch.parallel.mesh import (
        make_mesh,
        sharded_align_step,
        sharded_sample_batch,
        sharded_triplet_align_batch,
        sharded_viterbi_align_batch,
    )
    from coati_tpu_torch.utils import encode_marginal
    from coati_tpu_torch.align.wavefront import gap_consts_array

    mesh = make_mesh(devices=devices)
    nd = mesh.size
    rng = np.random.default_rng(0)
    aln = alignment_params("mar-mg")
    table, gap = aln.subst_matrix, aln.gap

    # 1) marginal: the mesh and the split step against one lane
    b = max(2 * nd, 4) + 1
    ancs = ["".join(rng.choice(CODONS61, size=8)) for _ in range(b)]
    dess = ["".join(rng.choice(list("ACGT"), size=24)) for _ in range(b)]
    enc = [encode_marginal(a, d) for a, d in zip(ancs, dess)]
    enc_as, enc_bs = [e[0] for e in enc], [e[1] for e in enc]
    sharded = sharded_viterbi_align_batch(enc_as, enc_bs, ancs, dess, table,
                                          gap, mesh, quantum=32)
    alone = engine.viterbi_align_batch(enc_as, enc_bs, ancs, dess, table, gap,
                                       quantum=32, device=mesh.lanes[0].device)
    aseq, bseq, la, lb = engine._pad_batch(enc_as, enc_bs, 32)
    ops, score = sharded_align_step(aseq, bseq, la, lb, table,
                                    gap_consts_array(gap), k=int(gap.len), mesh=mesh)
    step = engine.ops_to_strings(ops[::-1], score, ancs, dess, int(gap.len))
    if not (sharded == alone == step):
        raise AssertionError("marginal: the mesh, one lane and the split step differ")

    # 2) triplet over the mesh against the host engine
    model = triplet_hmm.build_triplet_model(alignment_params("tri-mg"))
    tri_pairs = [("".join(rng.choice(CODONS61, size=6)),
                  "".join(rng.choice(list("ACGT"), size=15))) for _ in range(nd + 3)]
    tri = sharded_triplet_align_batch(model, tri_pairs, mesh)
    for (a, d), got in zip(tri_pairs, tri):
        want = triplet_hmm.triplet_align(model, a, d)
        if tuple(got) != tuple(want):
            raise AssertionError(f"triplet {a}/{d}: mesh {got} != host {want}")

    # 3) sampling with the draws split over the lanes
    dev0 = mesh.lanes[0].device
    mdi, corners = _forward_diag(enc_as[0], enc_bs[0], aln, dev0)
    n_draws = 2 * nd + 1
    args = (mdi, corners, enc_as[0], enc_bs[0], table, ancs[0], dess[0], gap, 42, n_draws)
    drawn = sharded_sample_batch(*args, mesh)
    again = sharded_sample_batch(*args, mesh)
    single = list(sample_batch_device(*args))
    if not drawn == again == single:
        raise AssertionError("mesh sampling is not the single-lane stream for its seed")
    for s0, s1, sc in drawn:
        if (s0.replace("-", ""), s1.replace("-", "")) != (ancs[0], dess[0]) or not np.isfinite(sc):
            raise AssertionError(f"a sampled path is no alignment of the pair: {s0}/{s1}")

    return (f"dryrun_multichip({nd} lanes): marginal mesh == split step "
            f"== one lane ({b} pairs, chunks a lane {[x.chunks for x in mesh.lanes]}), "
            f"triplet mesh == host ({len(tri_pairs)} pairs), sample mesh == one lane "
            f"({n_draws} draws); score[0]={sharded[0].score:.4f}")


def main(argv) -> None:
    """The lanes named in argv; with none, two streams on the first card
    (which raises where there is no CUDA)."""
    print(dryrun_multichip(argv or ["cuda:0", "cuda:0"]))


if __name__ == "__main__":
    main(sys.argv[1:])
