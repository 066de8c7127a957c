"""Model parameters carried from the JAX package's numpy arrays to tensors."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from coati_tpu import constants as C
from coati_tpu import utils
from coati_tpu.structs import AlignmentParams, GapParams
from coati_tpu_torch.align.wavefront import gap_consts_array


@dataclasses.dataclass(frozen=True)
class Params:
    table: torch.Tensor  # [rows, 15] f32, rows = 183 * G
    gap_consts: torch.Tensor  # [4] f32: (no_gap, gap_stop, gap_open, gap_extend)
    k: int  # gap unit length


def params_from_numpy(table, gap, device) -> Params:
    """Tensors on `device` for a [183, 15] (or stacked [G, 183, 15]) marginal
    table and a GapParams.

    The kernels read the emission with a direct gather, which equals the
    JAX package's 15-term one-hot masked sum only for finite entries
    (0 * -inf is NaN), so a non-finite table is refused."""
    t = np.asarray(table, dtype=np.float32)
    if t.shape[-1] != 15 or t.ndim not in (2, 3):
        raise ValueError(f"marginal table must be [rows, 15] or [G, rows, 15], got {t.shape}")
    if not np.isfinite(t).all():
        raise ValueError("marginal table has non-finite entries")
    t = np.ascontiguousarray(t.reshape(-1, 15))
    return Params(
        table=torch.from_numpy(t).to(device),
        gap_consts=torch.from_numpy(gap_consts_array(gap)).to(device),
        k=int(gap.len),
    )


def alignment_params(model: str = "mar-mg", br_len: float = C.DEFAULT_BR_LEN,
                     omega: float = C.DEFAULT_OMEGA,
                     gap_open: float = C.DEFAULT_GAP_OPEN,
                     gap_extend: float = C.DEFAULT_GAP_EXTEND,
                     gap_len: int = C.DEFAULT_GAP_LEN) -> AlignmentParams:
    """The JAX package's AlignmentParams for one model and gap setting, with
    its marginal table resolved into .subst_matrix (coati_tpu.utils.set_subst;
    None for a triplet model)."""
    aln = AlignmentParams(model=model, br_len=br_len, omega=omega,
                          gap=GapParams(len=gap_len, open=gap_open,
                                        extend=gap_extend))
    utils.set_subst(aln)
    return aln
