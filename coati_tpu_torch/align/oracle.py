"""NumPy oracle for the pair-HMM DP: a float32-faithful mirror of the
reference forward_impl / traceback / sampleback (align_pair.cc:62-458).

Copy of coati_tpu/align/oracle.py. It is the truth the port's native
library (csrc/pairhmm.cc) is held to in the tests; no production path runs
it. Loops are plain Python; use only on short sequences.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from coati_tpu_torch.align.semiring import (
    LOG,
    ONE,
    TROPICAL,
    ZERO,
    gap_constants,
    log_sum_exp_f32,
)

F = np.float32


@dataclasses.dataclass
class Work:
    """DP matrices (match/delete/insert), optionally per-edge values."""

    mch: np.ndarray
    del_: np.ndarray
    ins: np.ndarray
    edges: dict | None = None  # 8 edge matrices for sampling


def forward_oracle(a, b, table, gap, semiring=TROPICAL, save_edges=False) -> Work:
    """Fill the DP matrices exactly like forward_impl (align_pair.cc:62-139).

    a: int array in [0,183) (ancestor codon*3+phase), b: int array in [0,15).
    table: (183,15) float32 log-odds table. gap: GapParams.
    """
    table = np.asarray(table, dtype=np.float32)
    ng, gs, go, ge = gap_constants(gap.open, gap.extend)
    k = int(gap.len)
    start = k - 1

    if semiring == TROPICAL:
        plus2 = lambda x, y: max(x, y)
    elif semiring == LOG:
        plus2 = log_sum_exp_f32
    else:
        raise ValueError(semiring)

    def plus3(x, y, z):
        return plus2(plus2(x, y), z)

    def power(x, n):
        return F(x * F(n))

    R = len(a) + k
    Cc = len(b) + k
    lowest = ZERO
    mch = np.full((R, Cc), lowest, dtype=np.float32)
    dl = np.full((R, Cc), lowest, dtype=np.float32)
    ins = np.full((R, Cc), lowest, dtype=np.float32)

    mch[start, start] = ONE
    for i in range(start + k, R, k):
        dl[i, start] = F(F(ng + go) + power(ge, i - 1))
    for j in range(start + k, Cc, k):
        ins[start, j] = F(go + power(ge, j - 1))

    edges = None
    if save_edges:
        names = [
            "mch_mch", "mch_del", "mch_ins", "del_mch",
            "del_del", "ins_mch", "ins_del", "ins_ins",
        ]
        edges = {n: np.full((R, Cc), lowest, dtype=np.float32) for n in names}
        # init_margins: del_del = del, ins_ins = ins (copies of margins)
        edges["del_del"] = dl.copy()
        edges["ins_ins"] = ins.copy()

    gek1 = power(ge, k - 1)
    gek = power(ge, k)

    for i in range(k, R):
        ai = int(a[i - k])
        for j in range(k, Cc):
            sub = table[ai, int(b[j - k])]
            m2m = F(F(F(mch[i - 1, j - 1] + ng) + ng) + sub)
            d2m = F(F(dl[i - 1, j - 1] + gs) + sub)
            i2m = F(F(F(ins[i - 1, j - 1] + gs) + ng) + sub)

            m2d = F(F(F(mch[i - k, j] + ng) + go) + gek1)
            i2d = F(F(F(ins[i - k, j] + gs) + go) + gek1)
            d2d = F(dl[i - k, j] + gek)

            m2i = F(F(mch[i, j - k] + go) + gek1)
            i2i = F(ins[i, j - k] + gek)

            mch[i, j] = plus3(m2m, d2m, i2m)
            dl[i, j] = plus3(m2d, d2d, i2d)
            ins[i, j] = plus2(m2i, i2i)

            if save_edges:
                edges["mch_mch"][i, j] = m2m
                edges["mch_del"][i, j] = m2d
                edges["mch_ins"][i, j] = m2i
                edges["del_mch"][i, j] = d2m
                edges["del_del"][i, j] = d2d
                edges["ins_mch"][i, j] = i2m
                edges["ins_del"][i, j] = i2d
                edges["ins_ins"][i, j] = i2i

    # terminal state adjustment (align_pair.cc:130-138)
    mch[R - 1, Cc - 1] = F(F(mch[R - 1, Cc - 1] + ng) + ng)
    ins[R - 1, Cc - 1] = F(F(ins[R - 1, Cc - 1] + gs) + ng)
    dl[R - 1, Cc - 1] = F(dl[R - 1, Cc - 1] + gs)

    return Work(mch, dl, ins, edges)


MATCH, DELETION, INSERTION = 0, 1, 2


def max_mdi(m, d, i) -> int:
    """Argmax with M > D > I tie preference (align_pair.cc:210-221)."""
    best, val = MATCH, m
    if d > val:
        best, val = DELETION, d
    if i > val:
        return INSERTION
    return best


def max_mi(m, i) -> int:
    """M vs I with tie -> I (align_pair.cc:230-232)."""
    return MATCH if m > i else INSERTION


def traceback(work: Work, a: str, b: str, gap) -> tuple[str, str, float]:
    """Greedy Viterbi traceback (align_pair.cc:249-303)."""
    ng, gs, go, ge = gap_constants(gap.open, gap.extend)
    k = int(gap.len)
    i = work.mch.shape[0] - 1
    j = work.mch.shape[1] - 1
    s0: list[str] = []
    s1: list[str] = []

    score = max(work.mch[i, j], work.del_[i, j], work.ins[i, j])
    m = max_mdi(work.mch[i, j], work.del_[i, j], work.ins[i, j])

    while j > (k - 1) or i > (k - 1):
        if m == MATCH:
            s0.append(a[i - k])
            s1.append(b[j - k])
            i -= 1
            j -= 1
            m = max_mdi(
                F(F(work.mch[i, j] + ng) + ng),
                F(work.del_[i, j] + gs),
                F(F(work.ins[i, j] + gs) + ng),
            )
        elif m == DELETION:
            for t in range(i, i - k, -1):
                s0.append(a[t - k])
                s1.append("-")
            i -= k
            m = max_mdi(
                F(F(work.mch[i, j] + ng) + go),
                F(work.del_[i, j] + ge),
                F(F(work.ins[i, j] + gs) + go),
            )
        else:  # INSERTION
            for t in range(j, j - k, -1):
                s0.append("-")
                s1.append(b[t - k])
            j -= k
            m = max_mi(F(work.mch[i, j] + go), F(work.ins[i, j] + ge))

    return "".join(reversed(s0)), "".join(reversed(s1)), float(score)


def _sample_mdi(log_m, log_d, log_i, p):
    """Categorical draw over (M,D,I) given log weights (align_pair.cc:336-357)."""
    m = np.exp(F(log_m)).astype(F)
    d = np.exp(F(log_d)).astype(F)
    i = np.exp(F(log_i)).astype(F)
    scale = F(F(m + d) + i)
    p = F(F(p) * scale)
    if p < m:
        ret, score = MATCH, F(log_m)
    elif p < F(d + m):
        ret, score = DELETION, F(log_d)
    else:
        ret, score = INSERTION, F(log_i)
    return ret, F(score - np.log(scale).astype(F))


def _sample_mi(log_m, log_i, p):
    m = np.exp(F(log_m)).astype(F)
    i = np.exp(F(log_i)).astype(F)
    scale = F(m + i)
    p = F(F(p) * scale)
    if p < m:
        ret, score = MATCH, F(log_m)
    else:
        ret, score = INSERTION, F(log_i)
    return ret, F(score - np.log(scale).astype(F))


def sampleback_mdi(M, D, I, enc_a, enc_b, table, a: str, b: str, gap, rng):
    """Stochastic traceback over the 3 state matrices, reconstructing edge
    values on the fly (equivalent to the reference's 11-matrix layout but
    with 3.7x less memory; formulas are the forward_impl transition chains,
    margin cells use the init_margins copy semantics del_del=del,
    ins_ins=ins)."""
    table = np.asarray(table, dtype=np.float32)
    ng, gs, go, ge = gap_constants(gap.open, gap.extend)
    k = int(gap.len)
    gek1 = F(ge * F(k - 1))
    gek = F(ge * F(k))
    R, Cc = M.shape
    i = R - 1
    j = Cc - 1
    s0: list[str] = []
    s1: list[str] = []
    score = F(0.0)

    def body(i, j):
        return i >= k and j >= k

    w = max(M[i, j], D[i, j], I[i, j])
    pick, ds = _sample_mdi(F(M[i, j] - w), F(D[i, j] - w), F(I[i, j] - w),
                           rng.f24())
    score = F(score + ds)

    while j > (k - 1) or i > (k - 1):
        if pick == MATCH:
            s0.append(a[i - k])
            s1.append(b[j - k])
            w = M[i, j]
            sub = table[int(enc_a[i - k]), int(enc_b[j - k])]
            if body(i, j):
                mm = F(F(F(M[i - 1, j - 1] + ng) + ng) + sub)
                dm = F(F(D[i - 1, j - 1] + gs) + sub)
                im = F(F(F(I[i - 1, j - 1] + gs) + ng) + sub)
            else:
                mm = dm = im = ZERO
            pick, ds = _sample_mdi(F(mm - w), F(dm - w), F(im - w), rng.f24())
            score = F(score + ds)
            i -= 1
            j -= 1
        elif pick == DELETION:
            for t in range(i, i - k, -1):
                s0.append(a[t - k])
                s1.append("-")
            w = D[i, j]
            if body(i, j):
                md = F(F(F(M[i - k, j] + ng) + go) + gek1)
                dd = F(D[i - k, j] + gek)
                id_ = F(F(F(I[i - k, j] + gs) + go) + gek1)
            else:
                md = id_ = ZERO
                dd = D[i, j]  # init_margins copy semantics
            pick, ds = _sample_mdi(F(md - w), F(dd - w), F(id_ - w), rng.f24())
            score = F(score + ds)
            i -= k
        else:
            for t in range(j, j - k, -1):
                s0.append("-")
                s1.append(b[t - k])
            w = I[i, j]
            if body(i, j):
                mi = F(F(M[i, j - k] + go) + gek1)
                ii = F(I[i, j - k] + gek)
            else:
                mi = ZERO
                ii = I[i, j]
            pick, ds = _sample_mi(F(mi - w), F(ii - w), rng.f24())
            score = F(score + ds)
            j -= k

    return "".join(reversed(s0)), "".join(reversed(s1)), float(score)


def sampleback(work: Work, a: str, b: str, gap, rng) -> tuple[str, str, float]:
    """Stochastic traceback over stored edge matrices (align_pair.cc:401-458).

    rng: coati_tpu_torch.rng.Lehmer64 (f24 draws) for reference parity.
    """
    assert work.edges is not None, "sampleback requires edges (save_edges=True)"
    e = work.edges
    k = int(gap.len)
    i = work.mch.shape[0] - 1
    j = work.mch.shape[1] - 1
    s0: list[str] = []
    s1: list[str] = []
    score = F(0.0)

    w = max(work.mch[i, j], work.del_[i, j], work.ins[i, j])
    pick, ds = _sample_mdi(
        F(work.mch[i, j] - w), F(work.del_[i, j] - w), F(work.ins[i, j] - w),
        rng.f24(),
    )
    score = F(score + ds)

    while j > (k - 1) or i > (k - 1):
        if pick == MATCH:
            s0.append(a[i - k])
            s1.append(b[j - k])
            w = work.mch[i, j]
            pick, ds = _sample_mdi(
                F(e["mch_mch"][i, j] - w),
                F(e["del_mch"][i, j] - w),
                F(e["ins_mch"][i, j] - w),
                rng.f24(),
            )
            score = F(score + ds)
            i -= 1
            j -= 1
        elif pick == DELETION:
            for t in range(i, i - k, -1):
                s0.append(a[t - k])
                s1.append("-")
            w = work.del_[i, j]
            pick, ds = _sample_mdi(
                F(e["mch_del"][i, j] - w),
                F(e["del_del"][i, j] - w),
                F(e["ins_del"][i, j] - w),
                rng.f24(),
            )
            score = F(score + ds)
            i -= k
        else:
            for t in range(j, j - k, -1):
                s0.append("-")
                s1.append(b[t - k])
            w = work.ins[i, j]
            pick, ds = _sample_mi(
                F(e["mch_ins"][i, j] - w), F(e["ins_ins"][i, j] - w), rng.f24()
            )
            score = F(score + ds)
            j -= k

    return "".join(reversed(s0)), "".join(reversed(s1)), float(score)
