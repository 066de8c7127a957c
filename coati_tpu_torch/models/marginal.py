"""Marginal substitution model: reduce a 61x61 codon P matrix to the
183x15 log-odds table indexed by (codon*3 + phase, IUPAC nucleotide).

This table is the only model state the DP kernel needs; it is built once on
the host (f64) and shipped to devices as an f32 constant. Semantics mirror
COATi src/lib/mutation_coati.cc:164-306.
"""

from __future__ import annotations

import enum

import numpy as np

from coati_tpu_torch.constants import CODON_NUC, IUPAC_ORDER, IUPAC_SETS


class AmbiguousNucs(enum.Enum):
    SUM = "SUM"
    BEST = "BEST"


class MarginalSubst(enum.Enum):
    SUM = "SUM"
    MAX = "MAX"


def _log_sum_exp(cols: list[np.ndarray]) -> np.ndarray:
    m = np.maximum.reduce(cols)
    acc = np.zeros_like(m)
    for c in cols:
        acc = acc + np.exp(c - m)
    return m + np.log(acc)


def marginal_p(
    p: np.ndarray,
    pi,
    amb: AmbiguousNucs = AmbiguousNucs.SUM,
    msub: MarginalSubst = MarginalSubst.SUM,
) -> np.ndarray:
    """Build the 183x15 marginal log-odds table.

    out[cod*3+pos, nuc] = log( P(nuc at pos | ancestor codon cod) / pi[nuc] )
    where the numerator marginalizes (SUM) or maximizes (MAX) over descendant
    codons whose nucleotide at `pos` equals `nuc` (mutation_coati.cc:164-202).
    Columns 4..14 handle IUPAC ambiguity codes via logSumExp (SUM) or max
    (BEST) over the component nucleotides (:234-306).
    """
    p = np.asarray(p, dtype=np.float64)
    pi = np.asarray(pi, dtype=np.float64)
    assert p.shape == (61, 61)

    # sel[pos, nuc, j] = 1 if descendant codon j has `nuc` at `pos`
    sel = np.zeros((3, 4, 61), dtype=np.float64)
    for pos in range(3):
        for nuc in range(4):
            sel[pos, nuc, CODON_NUC[:, pos] == nuc] = 1.0

    out = np.empty((183, 15), dtype=np.float64)
    for pos in range(3):
        if msub is MarginalSubst.SUM:
            marg = p @ sel[pos].T  # (61, 4)
        else:
            marg = np.max(p[:, None, :] * sel[pos][None, :, :], axis=2)
        out[pos::3, :4] = np.log(marg / pi[None, :])

    # ambiguity columns
    for col in range(4, 15):
        comp = IUPAC_SETS[IUPAC_ORDER[col]]
        cols = [out[:, c] for c in comp]
        if amb is AmbiguousNucs.SUM:
            out[:, col] = _log_sum_exp(cols)
        else:
            out[:, col] = np.maximum.reduce(cols)

    return out


def ambiguous_sum_p(p183: np.ndarray) -> np.ndarray:
    """Fill ambiguity columns by logSumExp (in place semantics of reference)."""
    out = p183.copy()
    for col in range(4, 15):
        comp = IUPAC_SETS[IUPAC_ORDER[col]]
        out[:, col] = _log_sum_exp([p183[:, c] for c in comp])
    return out


def ambiguous_best_p(p183: np.ndarray) -> np.ndarray:
    out = p183.copy()
    for col in range(4, 15):
        comp = IUPAC_SETS[IUPAC_ORDER[col]]
        out[:, col] = np.maximum.reduce([p183[:, c] for c in comp])
    return out
