"""Score an existing pairwise alignment under the marginal model.

Mirror of alignment_score (align_marginal.cc:373-473): expanded-CIGAR state
machine with the same f32 accumulation order and terminal-state accounting.
"""

from __future__ import annotations

import numpy as np

from coati_tpu_torch.align.semiring import gap_constants
from coati_tpu_torch.structs import AlignmentParams
from coati_tpu_torch.utils import encode_marginal, process_alignment, restore_end_stops

F = np.float32


def alignment_score(aln: AlignmentParams, p_marg: np.ndarray) -> float:
    cigar = process_alignment(aln)
    enc_a, enc_b = encode_marginal(aln.data.seqs[0], aln.data.seqs[1])
    table = np.asarray(p_marg, dtype=np.float32)

    ng, gs, go, ge = gap_constants(aln.gap.open, aln.gap.extend)

    def power(x, n):
        return F(x * F(n))

    MATCH, GAP = 0, 1
    state = MATCH
    score = F(0.0)
    nins = ndel = 0
    apos = bpos = 0

    for op in cigar:
        if state == MATCH:
            if op == "I":
                nins += 1
                bpos += 1
                state = GAP
            elif op == "D":
                ndel += 1
                apos += 1
                state = GAP
            else:
                score = F(
                    F(F(score + ng) + ng) + table[enc_a[apos], enc_b[bpos]]
                )
                apos += 1
                bpos += 1
        else:  # GAP
            if op == "I":
                nins += 1
                bpos += 1
            elif op == "D":
                ndel += 1
                apos += 1
            else:
                if nins == 0:
                    score = F(F(F(F(score + ng) + go) + power(ge, ndel - 1)) + gs)
                elif ndel == 0:
                    score = F(F(F(F(score + go) + power(ge, nins - 1)) + gs) + ng)
                else:
                    score = F(
                        F(F(F(F(score + go) + go) + power(ge, nins + ndel - 2)) + gs)
                        + gs
                    )
                score = F(score + table[enc_a[apos], enc_b[bpos]])
                nins = ndel = 0
                state = MATCH
                apos += 1
                bpos += 1

    # terminal state
    if state == MATCH:
        score = F(F(score + ng) + ng)
    else:
        if nins == 0:
            score = F(F(F(F(score + ng) + go) + power(ge, ndel - 1)) + gs)
        elif ndel == 0:
            score = F(F(F(F(score + go) + power(ge, nins - 1)) + gs) + ng)
        else:
            score = F(
                F(F(F(F(F(score + go) + go) + power(ge, nins + ndel - 2)) + gs) + gs)
                + ng
            )

    aln.data.score = float(score)
    restore_end_stops(aln.data, aln.gap)
    return float(np.float32(aln.data.score))
