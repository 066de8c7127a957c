"""Model parameters and carried state as tensors, from numpy arrays in the
JAX package's layout."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from coati_tpu_torch import constants as C
from coati_tpu_torch import utils
from coati_tpu_torch.structs import AlignmentParams, GapParams
from coati_tpu_torch.align.wavefront import gap_consts_array


@dataclasses.dataclass(frozen=True)
class Params:
    table: torch.Tensor  # [rows, 15] f32, rows = 183 * G
    gap_consts: torch.Tensor  # [4] f32: (no_gap, gap_stop, gap_open, gap_extend)
    k: int  # gap unit length

    def check_codes(self, aseq: np.ndarray, bseq: np.ndarray) -> None:
        """Raise unless the ancestor codes index the table's rows and the
        descendant codes are nucleotide codes; the kernels do not check."""
        if (aseq.min() < 0 or aseq.max() >= self.table.shape[0]
                or bseq.min() < 0 or bseq.max() > 15):
            raise ValueError("sequence codes out of range for the table")


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
    """AlignmentParams for one model and gap setting, with its marginal
    table resolved into .subst_matrix (utils.set_subst; None for a triplet
    model)."""
    aln = AlignmentParams(model=model, br_len=br_len, omega=omega,
                          gap=GapParams(len=gap_len, open=gap_open,
                                        extend=gap_extend))
    utils.set_subst(aln)
    return aln


def carry_from_numpy(ring, corners, device):
    """The segment carry of the JAX package's _segment as the port's:
    (ring [K, 3, B, C] f32 with ring[q] = diagonal d0 - 1 - q, raw corners
    (cM, cD, cI) each [B]) -> (ring tensor, corners [3, B] tensor) on
    `device`. The port keeps the reference's ring order and shape, so the
    arrays cross as they are."""
    ring = np.array(ring, dtype=np.float32, order="C")  # a writable copy
    if ring.ndim != 4 or ring.shape[1] != 3:
        raise ValueError(f"ring must be [K, 3, B, C], got {ring.shape}")
    raw = np.stack([np.asarray(c, dtype=np.float32) for c in corners])
    if raw.shape != (3, ring.shape[2]):
        raise ValueError(f"corners must be three [{ring.shape[2]}] arrays, "
                         f"got {raw.shape}")
    return torch.from_numpy(ring).to(device), torch.from_numpy(raw).to(device)


def carry_to_numpy(carry):
    """The port's segment carry as the JAX package's _segment takes it:
    (ring [K, 3, B, C], (cM, cD, cI)) numpy arrays."""
    ring, corners = carry
    raw = corners.cpu().numpy()
    return ring.cpu().numpy(), (raw[0], raw[1], raw[2])


def forward_from_numpy(Ms, Ds, Is, corners, R: int, Cc: int, device):
    """One pair's Forward matrices in the JAX package's diagonal layout
    (Ms, Ds, Is each [Dtot, C >= Cc] with cell (i, j) at [i + j, j]; the
    terminal-adjusted corners (cm, cd, ci)) as the port's: (mdi [R, Cc, 3]
    f32 with cell (i, j) at [i, j], corners [3] f32) on `device`."""
    ii = np.arange(R)[:, None]
    jj = np.arange(Cc)[None, :]
    mdi = np.stack([np.asarray(S, dtype=np.float32)[ii + jj, jj]
                    for S in (Ms, Ds, Is)], axis=-1)
    adj = np.array([float(c) for c in corners], dtype=np.float32)
    return torch.from_numpy(mdi).to(device), torch.from_numpy(adj).to(device)


def forward_to_numpy(mdi, corners):
    """The port's Forward matrices as the JAX package's: (Ms, Ds, Is each
    [R + Cc - 1, Cc] with cell (i, j) at [i + j, j], slots outside the
    matrix LOWEST; (cm, cd, ci) floats)."""
    m = mdi.cpu().numpy()
    R, Cc = m.shape[:2]
    ii = np.arange(R)[:, None]
    jj = np.arange(Cc)[None, :]
    planes = []
    for s in range(3):
        S = np.full((R + Cc - 1, Cc), C.F32_LOWEST, dtype=np.float32)
        S[ii + jj, jj] = m[:, :, s]
        planes.append(S)
    cm, cd, ci = (float(c) for c in corners)
    return planes[0], planes[1], planes[2], (cm, cd, ci)


def triplet_tables_from_numpy(logP64, match_emit, gc, device):
    """The triplet tables of the JAX package's _pack_batch (logP64 [61, 64],
    match_emit [4, 5], gc [4]) as contiguous f32 tensors on `device`."""
    shapes = ((61, 64), (4, 5), (4,))
    out = []
    for arr, shape in zip((logP64, match_emit, gc), shapes):
        a = np.array(arr, dtype=np.float32, order="C")  # a writable copy
        if a.shape != shape:
            raise ValueError(f"triplet table must be {shape}, got {a.shape}")
        out.append(torch.from_numpy(a).to(device))
    return tuple(out)


def triplet_carry_from_numpy(carry, device):
    """The triplet sweep's carry as the JAX package's _triplet_rows_carry
    takes it, (Mc, Dc, Ic) each [B, Cc], as the port's [3, B, Cc] f32."""
    stacked = np.stack([np.asarray(c, dtype=np.float32) for c in carry])
    if stacked.ndim != 3 or stacked.shape[0] != 3:
        raise ValueError(f"carry must be three [B, Cc] arrays, got {stacked.shape}")
    return torch.from_numpy(stacked).to(device)


def triplet_carry_to_numpy(carry):
    """The port's [3, B, Cc] carry as the JAX package's (Mc, Dc, Ic)."""
    c = carry.cpu().numpy()
    return c[0], c[1], c[2]


def triplet_state_from_numpy(i, j, st, device):
    """The triplet walk's state (i, j, st), each [B], as the port's [3, B]
    int32 tensor."""
    state = np.stack([np.asarray(x).astype(np.int32) for x in (i, j, st)])
    return torch.from_numpy(state).to(device)


def triplet_state_to_numpy(state):
    """The port's [3, B] walk state as (i, j, st) int32 arrays."""
    s = state.cpu().numpy()
    return s[0], s[1], s[2]
