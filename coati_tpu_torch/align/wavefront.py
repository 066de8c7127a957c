"""Plain PyTorch versions of the marginal Viterbi fill and traceback walk.

Counterpart of coati_tpu/align/wavefront.py (viterbi mode, tropical
semiring, any gap length k). These are the reference the CUDA kernels in
coati_tpu_torch/kernels are held against, and the path the kernel wrappers
take for tensors on the CPU. They keep the JAX version's layout and f32
operation order so that corners, backpointers and walks are bit-equal:

- cell (i, j) lives on anti-diagonal d = i + j at slot j, C = NB + k slots;
- the per-cell f32 op order is wavefront.py:182-195, the backpointer
  comparands :218-221, the terminal adjustment :253-255;
- the two margin formulas go + ge*(j-1) and (ng+go) + ge*(i-1) are computed
  in float64 and rounded once to float32. XLA:CPU contracts them into one
  single-rounded FMA; for these magnitudes the float64 product and sum are
  exact, so one rounding gives the same value.

The backpointer output is [B, Dtot, C] uint8 (pair-major), Dtot = NA+NB+2k-1;
byte bits 0-1 / 2-3 / 4-5 hold the M / D / I predecessor state.
"""

from __future__ import annotations

import numpy as np
import torch

from coati_tpu.align.semiring import gap_constants
from coati_tpu.constants import F32_LOWEST

LOWEST = float(np.float32(F32_LOWEST))


def gap_consts_array(gap) -> np.ndarray:
    """(no_gap, gap_stop, gap_open, gap_extend) as a [4] float32 array."""
    return np.array(gap_constants(gap.open, gap.extend), dtype=np.float32)


def _shift_right(x, s):
    """result[..., j] = x[..., j-s] with LOWEST fill."""
    if s == 0:
        return x
    pad = torch.full(x.shape[:-1] + (s,), LOWEST, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-s]], dim=-1)


def margin_values(base, ge, idx):
    """f32(base + ge*(idx - 1)) with one rounding: the value XLA:CPU's
    contracted FMA gives for the margin rows/columns (wavefront.py:154,160)."""
    return (base.double() + ge.double() * (idx.double() - 1.0)).float()


def argmax_mdi(m, d, i):
    """Reference max_mdi preference: M unless D strictly greater, I only if
    strictly greater than both. uint8 codes 0/1/2."""
    code = (d > m).to(torch.uint8)
    best = torch.maximum(m, d)
    return torch.where(i > best, torch.full_like(code, 2), code)


def wavefront_plain(aseq, bseq, lens_a, lens_b, table, gap_consts, *, k: int):
    """Viterbi fill with packed backpointers, one loop step per anti-diagonal.

    aseq [B, NA] int (< table rows), bseq [B, NB] int (< 16), lens [B] int,
    table [rows, 15] f32, gap_consts [4] f32. Returns ((cM, cD, cI), bp):
    terminal-adjusted corner scores [B] f32 and bp [B, Dtot, C] uint8."""
    B, NA = aseq.shape
    NB = bseq.shape[1]
    dev = aseq.device
    R = NA + k
    C = NB + k
    Dtot = R + C - 1
    K = max(k, 2)
    ng, gs, go, ge = (gap_consts[q] for q in range(4))
    gek1 = ge * float(k - 1)
    gek = ge * float(k)
    ngo = ng + go

    j_iota = torch.arange(C, device=dev)
    table_flat = table.reshape(-1)
    a_long = aseq.long()
    b_slot = torch.cat(
        [torch.zeros((B, k), dtype=torch.long, device=dev), bseq.long()], dim=1
    )  # [B, C]: b[j-k] at slot j >= k
    b_emit = b_slot < 15  # code 15 ('-') has no column: the one-hot sum gives 0
    corner_d = (lens_a + lens_b).long() + 2 * (k - 1)
    corner_j = (lens_b.long() + (k - 1))[:, None]

    empty = torch.full((B, C), LOWEST, dtype=torch.float32, device=dev)
    ring = [(empty, empty, empty)] * K  # ring[q] = diagonal d-1-q
    cM = cD = cI = torch.full((B,), LOWEST, dtype=torch.float32, device=dev)
    bp = torch.empty((B, Dtot, C), dtype=torch.uint8, device=dev)
    # insert-row margin values and mask depend on j only
    i_marg_j = margin_values(go, ge, j_iota)
    ins_ok_j = (j_iota >= 2 * k - 1) & ((j_iota - (k - 1)) % k == 0)

    for d in range(Dtot):
        prev2 = ring[1]
        prevk = ring[k - 1]
        i_vec = d - j_iota

        a_rows = a_long[:, (i_vec - k).clamp(0, NA - 1)]
        sub = torch.where(b_emit, table_flat[a_rows * 15 + b_slot.clamp(max=14)], 0.0)

        p2M = _shift_right(prev2[0], 1)
        p2D = _shift_right(prev2[1], 1)
        p2I = _shift_right(prev2[2], 1)
        pkM, pkD, pkI = prevk
        pkMs = _shift_right(pkM, k)
        pkIs = _shift_right(pkI, k)

        m2m = ((p2M + ng) + ng) + sub
        d2m = (p2D + gs) + sub
        i2m = ((p2I + gs) + ng) + sub
        m2d = ((pkM + ng) + go) + gek1
        i2d = ((pkI + gs) + go) + gek1
        d2d = pkD + gek
        m2i = (pkMs + go) + gek1
        i2i = pkIs + gek

        M = torch.maximum(torch.maximum(m2m, d2m), i2m)
        D = torch.maximum(torch.maximum(m2d, d2d), i2d)
        I = torch.maximum(m2i, i2i)

        body = (i_vec >= k) & (i_vec < R) & (j_iota >= k)
        m_marg = torch.where((i_vec == k - 1) & (j_iota == k - 1), 0.0, LOWEST)
        i_marg = torch.where((i_vec == k - 1) & ins_ok_j, i_marg_j, LOWEST)
        del_ok = (j_iota == k - 1) & (i_vec >= 2 * k - 1) & ((i_vec - (k - 1)) % k == 0)
        d_marg = torch.where(del_ok, margin_values(ngo, ge, i_vec), LOWEST)
        M = torch.where(body, M, m_marg)
        D = torch.where(body, D, d_marg)
        I = torch.where(body, I, i_marg)

        sel = corner_d == d
        cM = torch.where(sel, M.gather(1, corner_j)[:, 0], cM)
        cD = torch.where(sel, D.gather(1, corner_j)[:, 0], cD)
        cI = torch.where(sel, I.gather(1, corner_j)[:, 0], cI)

        ring = [(M, D, I)] + ring[: K - 1]

        bp_m = argmax_mdi((p2M + ng) + ng, p2D + gs, (p2I + gs) + ng)
        bp_d = argmax_mdi((pkM + ng) + go, pkD + ge, (pkI + gs) + go)
        bp_i = torch.where(pkMs + go > pkIs + ge, 0, 2).to(torch.uint8)
        bp[:, d, :] = bp_m | (bp_d << 2) | (bp_i << 4)

    cMa = (cM + ng) + ng
    cIa = (cI + gs) + ng
    cDa = cD + gs
    return (cMa, cDa, cIa), bp


def traceback_plain(bp, corners, lens_a, lens_b, *, k: int, max_steps: int):
    """Backward walk of every pair from its corner, all pairs one step per
    loop iteration (the while-loop form of traceback_ops_impl).

    bp [B, Dtot, C] uint8 from wavefront_plain or the fill kernel. Returns
    (ops, score): ops [max_steps, B] int8, op codes 0=match 1=delete
    2=insert walking BACKWARD from the corner with -1 after each walk's
    end; score [B] f32 = max(cM, max(cD, cI))."""
    cM, cD, cI = corners
    B = cM.shape[0]
    dev = cM.device
    st = argmax_mdi(cM, cD, cI).long()
    score = torch.maximum(cM, torch.maximum(cD, cI))
    i = lens_a.long() + (k - 1)
    j = lens_b.long() + (k - 1)
    rows = torch.arange(B, device=dev)
    ops = torch.full((max_steps, B), -1, dtype=torch.int8, device=dev)
    for s in range(max_steps):
        active = (i > k - 1) | (j > k - 1)
        if not bool(active.any()):
            break
        code = bp[rows, i + j, j].long()
        nxt = (code >> (2 * st)) & 3
        di = torch.where(st == 0, 1, torch.where(st == 1, k, 0))
        dj = torch.where(st == 0, 1, torch.where(st == 1, 0, k))
        ops[s] = torch.where(active, st, -1).to(torch.int8)
        i = torch.where(active, i - di, i)
        j = torch.where(active, j - dj, j)
        st = torch.where(active, nxt, st)
    return ops, score
