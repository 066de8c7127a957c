"""Core parameter/data containers (reference structs.hpp / data.hpp analogs)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from coati_tpu_torch import constants as C
from coati_tpu_torch.models.marginal import AmbiguousNucs, MarginalSubst

MARGINAL_MODELS = ("mar-mg", "mar-ecm")
TRIPLET_MODELS = ("tri-mg", "tri-ecm", "dna")


@dataclasses.dataclass
class GapParams:
    """Gap unit length and open/extend probabilities (structs.hpp:37-47)."""

    len: int = C.DEFAULT_GAP_LEN
    open: float = C.DEFAULT_GAP_OPEN
    extend: float = C.DEFAULT_GAP_EXTEND


@dataclasses.dataclass
class SeqData:
    """Names + sequences + score (+ trimmed terminal stop codons)."""

    path: str = ""
    names: list[str] = dataclasses.field(default_factory=list)
    seqs: list[str] = dataclasses.field(default_factory=list)
    score: float = 0.0
    stops: list[str] = dataclasses.field(default_factory=list)

    def size(self) -> int:
        if len(self.names) != len(self.seqs):
            raise ValueError("Different number of sequences and names.")
        return len(self.names)


@dataclasses.dataclass
class AlignmentParams:
    """All model/run parameters for an alignment (structs.hpp:66-99)."""

    data: SeqData = dataclasses.field(default_factory=SeqData)
    model: str = "mar-mg"
    br_len: float = C.DEFAULT_BR_LEN
    omega: float = C.DEFAULT_OMEGA
    pi: tuple = C.DEFAULT_PI
    tree: str = ""
    refs: str = ""
    rev: bool = False
    rate: str = ""  # path to user rate-matrix CSV
    gap: GapParams = dataclasses.field(default_factory=GapParams)
    sigma: tuple = C.DEFAULT_SIGMA
    output: str = ""
    score: bool = False
    amb: AmbiguousNucs = AmbiguousNucs.SUM
    sub: MarginalSubst = MarginalSubst.SUM
    bc_error: float = C.DEFAULT_BC_ERROR
    # resolved 183x15 marginal table (f32) once set_subst has run
    subst_matrix: Optional[np.ndarray] = None

    def is_marginal(self) -> bool:
        return self.model in MARGINAL_MODELS or bool(self.rate)

    def seq(self, i: int) -> str:
        return self.data.seqs[i]

    def name(self, i: int) -> str:
        return self.data.names[i]
