"""Codon substitution models (MG94, ECM, GTR) and marginal reductions."""

from coati_tpu_torch.models.mg94 import mg94_p, mg94_q, gtr_q
from coati_tpu_torch.models.ecm import ecm_p, nts_ntv, k_bias
from coati_tpu_torch.models.marginal import (
    marginal_p,
    ambiguous_sum_p,
    ambiguous_best_p,
    AmbiguousNucs,
    MarginalSubst,
)

__all__ = [
    "mg94_p",
    "mg94_q",
    "gtr_q",
    "ecm_p",
    "nts_ntv",
    "k_bias",
    "marginal_p",
    "ambiguous_sum_p",
    "ambiguous_best_p",
    "AmbiguousNucs",
    "MarginalSubst",
]
