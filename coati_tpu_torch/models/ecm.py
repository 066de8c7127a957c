"""Empirical Codon Model (Kosiol et al. 2007).

Numeric tables (exchangeabilities + stationary frequencies) are published
supplemental data from Kosiol 2007, extracted from the reference's
ecm_unrest.tcc into coati_tpu_torch/data/ecm.npz. Model construction mirrors
COATi src/lib/mutation_ecm.cc:151-184 but vectorized in f64.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
from coati_tpu_torch.constants import AMINO_GROUP, CODON_NUC
from coati_tpu_torch.models.mg94 import expm_once

_DATA = Path(__file__).resolve().parent.parent / "data" / "ecm.npz"


@functools.lru_cache(maxsize=1)
def _load_ecm():
    d = np.load(_DATA)
    return d["exchang"].astype(np.float64), d["ecm_pi"].astype(np.float64)


def ecm_exchangeabilities() -> np.ndarray:
    return _load_ecm()[0]


def ecm_pi() -> np.ndarray:
    return _load_ecm()[1]


def nts_ntv(c1: int, c2: int) -> tuple[int, int]:
    """Count transitions / transversions between two 61-index codons.

    Mirrors mutation_ecm.cc:47-63 (A=0,C=1,G=2,T=3: same parity => transition).
    """
    n1, n2 = CODON_NUC[c1], CODON_NUC[c2]
    diff = n1 != n2
    ts = int(np.sum(diff & ((n1 % 2) == (n2 % 2))))
    tv = int(np.sum(diff & ((n1 % 2) != (n2 % 2))))
    return ts, tv


def k_bias(c1: int, c2: int, model: int = 0, kappa: float = 2.5) -> float:
    """Transition-transversion bias function (mutation_ecm.cc:108-123)."""
    ts, tv = nts_ntv(c1, c2)
    if model == 1:
        return float(kappa) ** ts
    if model == 2:
        return float(kappa) ** tv
    return 1.0


def ecm_p(br_len: float, omega: float) -> np.ndarray:
    """ECM 61x61 substitution P matrix (mutation_ecm.cc:151-184).

    Q[i,j] = exchang[i,j] * ecm_pi[j] * (omega if nonsynonymous else 1),
    normalized by the stationary flow d, then P = expm(Q * t / d).
    """
    if br_len <= 0:
        raise ValueError("Branch length must be positive.")
    exchang, pi = _load_ecm()
    w = np.where(AMINO_GROUP[:, None] == AMINO_GROUP[None, :], 1.0, float(omega))
    q = exchang * pi[None, :] * w
    np.fill_diagonal(q, 0.0)
    row_sum = q.sum(axis=1)
    q[np.diag_indices(61)] = -row_sum
    d = float((pi * row_sum).sum())
    return expm_once(q * (float(br_len) / d))
