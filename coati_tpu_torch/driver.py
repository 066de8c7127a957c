"""Pairwise alignment driver (counterpart of coati_tpu/driver.py
_viterbi_align and marg_alignment; reference align_marginal.cc:44-88)."""

from __future__ import annotations

import sys

from coati_tpu_torch import utils
from coati_tpu_torch.io import read_input, write_output
from coati_tpu_torch.structs import AlignmentParams


def _viterbi_align(aln: AlignmentParams, device) -> None:
    """Viterbi-align aln.data.seqs[0/1] in place."""
    from coati_tpu_torch.align.engine import viterbi_align_single

    anc, des = aln.seq(0), aln.seq(1)
    enc_a, enc_b = utils.encode_marginal(anc, des)
    s0, s1, score = viterbi_align_single(
        enc_a, enc_b, anc, des, aln.subst_matrix, aln.gap, device=device
    )
    aln.data.seqs = [s0, s1]
    aln.data.score = score


def marg_alignment(aln: AlignmentParams, device="cuda") -> bool:
    """Pairwise alignment with a marginal model; -s scores the input
    alignment instead."""
    aln.data = read_input(aln)
    utils.set_subst(aln)

    if aln.score:
        from coati_tpu_torch.align.score import alignment_score

        print(f"{alignment_score(aln, aln.subst_matrix):g}")
        return True

    utils.process_marginal(aln)
    try:
        _viterbi_align(aln, device)
    except MemoryError:
        print("ERROR: sequences to align exceed available memory.",
              file=sys.stderr)
        return False
    utils.restore_end_stops(aln.data, aln.gap)
    write_output(aln)
    return True
