"""Triplet codon models (tri-mg, tri-ecm, dna) as a codon-context pair-HMM
(the port's own copy of coati_tpu/triplet_hmm.py; numpy only, apart from
triplet_align_driver, which takes the device to align on).

The reference evaluates these models by FST composition + shortest path
(align_fst.cc:45-150) over a vendored OpenFst subset. Derivation used here
instead: the composed machine  anc-FSA ∘ (codon-subst FST ∘ indel FST) ∘
des-FSA  is exactly a 3-state affine pair-HMM whose match/delete steps carry
a live "chosen descendant codon" lane c' in [0,61):

  generative chain: ancestor codons --P(c'|c) codon channel--> intermediate
  nucleotide sequence --per-nucleotide affine indel channel
  (mutation_fst.cc:197-257: insert ~pi, delete free, match pays 1-3*eps /
  eps base-calling error, N matches free)--> descendant.

The transition structure (insertions precede deletions, d->i forbidden,
identical start/terminal factors) is the same as the marginal DP; emissions
depend on the intermediate nucleotide nuc(c', phase); P(c'|c) is paid when
a codon is entered whether or not its nucleotides survive deletion (the
FST composition emits before the indel channel consumes).

Viterbi memory: collapsed codon-boundary rows only (~4 B/cell), with
per-block (3 rows) recompute during traceback. The in-row insertion
recurrence is solved by a prefix-max (cummax) closed form, so each row is
pure vectorized numpy over (columns, 61 codon lanes). The 'dna' model uses
the same machinery with a 4x4 channel and no codon lane.

Scores follow the FST convention: reported score = -log(best path weight);
insertions pay pi (a path-independent constant away from the marginal
convention, so gap placement agrees between the two conventions).
"""

from __future__ import annotations

import numpy as np

from coati_tpu_torch import constants as C
from coati_tpu_torch.structs import AlignmentParams

NEG = -1.0e30
MATCH, DELETION, INSERTION = 0, 1, 2


_DES_LUT = np.full(256, -1, np.int32)
for _ch, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3), ("N", 4)):
    _DES_LUT[ord(_ch)] = _v
    _DES_LUT[ord(_ch.lower())] = _v


def encode_triplet_des(des: str) -> np.ndarray:
    """A,C,G,T(U)->0..3, N->4; other symbols rejected (acceptor table,
    mutation_fst.cc:310-327). One table lookup over the whole string."""
    try:
        raw = np.frombuffer(des.encode("ascii"), np.uint8)
    except UnicodeEncodeError:
        bad = next(ch for ch in des if ord(ch) > 127)
        raise ValueError(
            f"Invalid nucleotide {bad!r} for triplet model alignment."
        ) from None
    out = _DES_LUT[raw]
    if out.min(initial=0) < 0:
        bad = des[int(np.argmax(out < 0))]
        raise ValueError(
            f"Invalid nucleotide {bad!r} for triplet model alignment."
        )
    return out


def encode_triplet_anc(anc: str) -> np.ndarray:
    """Ancestor as 61-index codon array (pre-validated by process_triplet)."""
    codes = C.NT16_TABLE[np.frombuffer(anc.upper().encode(), np.uint8)]
    if np.any(codes > 3):
        raise ValueError(
            "Ambiguous nucleotides in reference sequence not supported."
        )
    c64 = (
        (codes[0::3].astype(np.int32) << 4)
        | (codes[1::3].astype(np.int32) << 2)
        | codes[2::3].astype(np.int32)
    )
    if np.any(np.isin(c64, C.STOP_CODONS_64)):
        raise ValueError("Early stop codon in ancestor.")
    return C.COD64_TO_61[c64]


class TripletModel:
    """Log-space emission/transition tables for one model instance."""

    def __init__(self, logP, pi, gap_open, gap_extend, bc_error, codon=True):
        self.codon = codon
        self.logP = np.asarray(logP, dtype=np.float64)  # [61,61] or [4,4]
        self.ng = float(np.log1p(-gap_open))
        self.gs = float(np.log1p(-gap_extend))
        self.go = float(np.log(gap_open))
        self.ge = float(np.log(gap_extend))
        pi = np.asarray(pi, dtype=np.float64)
        # insertion emission per des code (4=N -> weight 1)
        self.ins_emit = np.concatenate([np.log(pi), [0.0]])
        # match emission [intermediate nuc 0..3, des code 0..4]
        eps = float(bc_error)
        me = np.full((4, 5), np.log(eps))
        np.fill_diagonal(me[:, :4], np.log1p(-3.0 * eps))
        me[:, 4] = 0.0
        self.match_emit = me
        self.cnuc = C.CODON_NUC.T.copy()  # [3, 61]
        if not codon:
            # dna model: the 4-lane intermediate nucleotide is entered and
            # collapsed within a single row, so the per-symbol channel folds
            # into effective tables (mutation_fst.cc:105-148 composed with
            # the indel FST's match/delete arcs, :232-247):
            #   match: max_mid logP[a, mid] + me[mid, des]
            #   delete: the deleted symbol still passed the channel ->
            #           max_mid logP[a, mid]
            self.match_emit_eff = (
                self.logP[:, :, None] + me[None, :, :]
            ).max(axis=1)  # [4, 5]
            self.del_cost = self.logP.max(axis=1)  # [4]


def build_triplet_model(aln: AlignmentParams) -> TripletModel:
    from coati_tpu_torch.models import ecm_p, mg94_p

    if aln.model == "tri-mg":
        sigma = aln.sigma if any(s > 0 for s in aln.sigma) else None
        P = mg94_p(aln.br_len, aln.omega, aln.pi, sigma)
        return TripletModel(np.log(np.maximum(P, 1e-300)), aln.pi,
                            aln.gap.open, aln.gap.extend, aln.bc_error)
    if aln.model == "tri-ecm":
        P = ecm_p(aln.br_len, aln.omega)
        return TripletModel(np.log(np.maximum(P, 1e-300)), C.ECM_DNA_PI,
                            aln.gap.open, aln.gap.extend, aln.bc_error)
    if aln.model == "dna":
        P = mg94_p(aln.br_len, aln.omega, aln.pi)
        # marginalize to 4x4 and row-normalize (mutation_fst.cc:105-148)
        dna_p = np.zeros((4, 4))
        nucs = C.CODON_NUC
        for pos in range(3):
            sel = np.zeros((61, 4))
            sel[np.arange(61), nucs[:, pos]] = 1.0
            dna_p += sel.T @ P @ sel
        dna_p /= dna_p.sum(axis=1, keepdims=True)
        return TripletModel(np.log(dna_p), aln.pi, aln.gap.open,
                            aln.gap.extend, aln.bc_error, codon=False)
    raise ValueError("Mutation model unknown.")


class _DP:
    """Row-sweep DP engine over columns j (0..m), FACTORED over the codon
    lane for codon models.

    Factorization (shared bit-for-bit by this host engine, the plain
    PyTorch rows and the CUDA kernel): within one codon
    block the 61 chosen-codon lanes differ only by (a) the codon-entry
    cost logP[anc_t, c'] and (b) the per-phase emission class
    nuc(c', phase) in {A,C,G,T}. Under (max, +) both enter additively, so
    the block computes 4 phase-1 variants (x1), 16 phase-2 variants
    (x1,x2), 16 phase-3 cores, and folds (cost + phase-3 emission) as a
    4-way max K[x1x2, j] = max_x3(cost[x1x2x3] + E[x3, j]) — ~36 row
    computations instead of 3 x 61 laned rows (~5x fewer ops; the values
    are exact because max reassociation is exact, and every f32 ADD below
    is a single canonical expression tree all three engines share).

    The CANONICAL dtype is float32 — the reference's FST weights are f32
    (OpenFst StdArc) — so traceback tie decisions agree bit-for-bit
    across engines. Argmax lanes (codon64 encoding x1*16+x2*4+x3) use
    first-maximal-group + first-maximal-payload rules that reproduce the
    lexicographic first-lane tie rule. dtype=float64 remains available
    for oracle cross-checks."""

    def __init__(self, model: TripletModel, anc: np.ndarray, des: np.ndarray,
                 dtype=np.float32):
        self.m = model
        self.anc = anc
        self.des = des
        self.dtype = dtype
        self.Cc = len(des) + 1
        # dtype-local gap constants and their composite sums (device-order)
        self.ng = dtype(model.ng)
        self.gs = dtype(model.gs)
        self.go = dtype(model.go)
        self.ge = dtype(model.ge)
        self.ng_ng = self.ng + self.ng
        self.gs_ng = self.gs + self.ng
        self.ng_go = self.ng + self.go
        self.gs_go = self.gs + self.go
        self.go_ge = self.go - self.ge
        e = model.ins_emit[des].astype(dtype)
        self.cumE = np.concatenate(
            [np.zeros(1, dtype), np.cumsum(e, dtype=dtype)]
        )  # [Cc]
        j = np.arange(self.Cc, dtype=dtype)
        self.ins_off = self.cumE + self.ge * j
        self.n_lanes = 61 if model.codon else 1
        if model.codon:
            # E[x, j] = match emission of intermediate nucleotide x at
            # column j (j >= 1 consumes des[j-1]); column 0 never emits
            E = np.zeros((4, self.Cc), dtype)
            E[:, 1:] = model.match_emit[:4, des].astype(dtype)
            self.E = E
            # codon64-indexed entry costs (NEG at stops): lane64 =
            # x1*16 + x2*4 + x3 so phase classes are bit-extracted
            lp64 = np.full((61, 64), dtype(NEG), dtype)
            lp64[:, C.COD61_TO_64] = model.logP.astype(dtype)
            self.logP64 = lp64

    # --- factored codon-block machinery (codon models) ----------------------
    def _shiftmax3(self, M, D, I):
        """core[j] = max3(M[j-1]+ng_ng, D[j-1]+gs, I[j-1]+gs_ng); NEG at 0.
        Broadcasts over trailing group axes."""
        out = np.full_like(M, NEG)
        out[1:] = np.maximum(
            np.maximum(M[:-1] + self.ng_ng, D[:-1] + self.gs),
            I[:-1] + self.gs_ng,
        )
        return out

    def _dmax3(self, M, D, I):
        return np.maximum(np.maximum(M + self.ng_go, D + self.ge),
                          I + self.gs_go)

    def block_pieces(self, t, Mc, Dc, Ic):
        """All factored rows of codon block t from the collapsed boundary
        below it. Returns a dict of [Cc]- and [Cc, G]-shaped arrays."""
        ET = self.E.T  # [Cc, 4]
        core1 = self._shiftmax3(Mc, Dc, Ic)               # [Cc]
        M1 = core1[:, None] + ET                          # [Cc, 4]
        D1 = self._dmax3(Mc, Dc, Ic)                      # [Cc]
        I1 = self.row_ins(M1)                             # [Cc, 4]
        D1b = np.broadcast_to(D1[:, None], M1.shape)
        core2 = self._shiftmax3(M1, D1b, I1)              # [Cc, 4]
        M2 = (core2[:, :, None] + ET[:, None, :]).reshape(self.Cc, 16)
        D2 = self._dmax3(M1, D1b, I1)                     # [Cc, 4] (per x1)
        I2 = self.row_ins(M2)                             # [Cc, 16]
        D2g = np.repeat(D2, 4, axis=1)                    # [Cc, 16]
        core3 = self._shiftmax3(M2, D2g, I2)              # [Cc, 16]
        D3 = self._dmax3(M2, D2g, I2)                     # [Cc, 16]
        cost = self.logP64[self.anc[t]].reshape(16, 4)    # [16, 4]
        ce = cost[None, :, :] + ET[:, None, :]            # [Cc, 16, 4]
        K = ce.max(axis=2)                                # [Cc, 16]
        Kpay = np.argmax(ce, axis=2).astype(np.int32)     # first-max x3
        Mlane = core3 + K                                 # [Cc, 16]
        KD = cost.max(axis=1)                             # [16]
        KDpay = np.argmax(cost, axis=1).astype(np.int32)
        Dlane = D3 + KD[None, :]                          # [Cc, 16]
        return {
            "core1": core1, "M1": M1, "D1": D1, "I1": I1,
            "M2": M2, "D2": D2, "I2": I2,
            "core3": core3, "D3": D3,
            "K": K, "Kpay": Kpay, "KD": KD, "KDpay": KDpay,
            "Mlane": Mlane, "Dlane": Dlane, "cost": cost,
        }

    def collapse_values(self, p):
        """Collapsed boundary rows (Mc', Dc', Ic') above the block."""
        Mc2 = p["Mlane"].max(axis=1)
        Dc2 = p["Dlane"].max(axis=1)
        W = p["Mlane"] - self.ins_off[:, None]
        Wstar = W.max(axis=1)
        run = np.maximum.accumulate(Wstar)
        Ic2 = np.full(self.Cc, NEG, self.dtype)
        Ic2[1:] = run[:-1] + (self.ins_off[1:] + self.go_ge)
        return Mc2, Dc2, Ic2

    def collapse_amax(self, p):
        """argmax lanes (codon64) per state at the boundary above the
        block. Rules (shared with the device engines): M/D pick the
        first-maximal group then first-maximal payload; I picks the
        earliest column u achieving the running max, with that column's
        first-maximal (group, x3)."""
        Cc = self.Cc
        rows = np.arange(Cc)
        gM = np.argmax(p["Mlane"], axis=1)
        amaxM = (gM * 4 + p["Kpay"][rows, gM]).astype(np.int32)
        gD = np.argmax(p["Dlane"], axis=1)
        amaxD = (gD * 4 + p["KDpay"][gD]).astype(np.int32)
        W = p["Mlane"] - self.ins_off[:, None]
        Wstar = W.max(axis=1)
        gW = np.argmax(W, axis=1)
        lane_at_u = (gW * 4 + p["Kpay"][rows, gW]).astype(np.int64)
        run = np.maximum.accumulate(Wstar)
        prev_run = np.concatenate(
            [np.asarray([-np.inf], Wstar.dtype), run[:-1]]
        )
        newmax = Wstar > prev_run
        code = np.where(newmax, rows.astype(np.int64) * 64 + lane_at_u, -1)
        code_run = np.maximum.accumulate(code)
        amaxI = np.zeros(Cc, np.int32)
        amaxI[1:] = (code_run[:-1] % 64).astype(np.int32)
        return amaxM, amaxD, amaxI

    def lane_rows3(self, t, p, lane64):
        """Phase-3 rows for one bound lane: the lane's own (cost + e3)
        replaces the group K."""
        g, x3 = lane64 >> 2, lane64 & 3
        cost_s = self.logP64[self.anc[t], lane64]
        ce3 = cost_s + self.E[x3]
        M3 = p["core3"][:, g] + ce3
        D3l = p["D3"][:, g] + cost_s
        I3 = self.row_ins(M3)
        return M3, D3l, I3

    def init_row(self):
        """Boundary row 0: M=[one at j=0], D=-inf, I = insertion run margin."""
        M0 = np.full(self.Cc, NEG, dtype=self.dtype)
        M0[0] = 0.0
        D0 = np.full(self.Cc, NEG, dtype=self.dtype)
        I0 = self.row_ins(M0)
        return M0, D0, I0

    def row_ins(self, Mrow):
        """I[j] = max(M[j-1]+go, I[j-1]+ge) + ins_emit[j-1], vectorized:
        I[j] = cumE[j] + ge*j + (go-ge) + max_{u<j}(M[u] - cumE[u] - ge*u).
        Grouping matches the device row_ins: run + (ins_off + (go-ge))."""
        if Mrow.ndim == 1:
            base = Mrow - self.ins_off
            run = np.maximum.accumulate(base)
            out = np.full(self.Cc, NEG, dtype=Mrow.dtype)
            out[1:] = run[:-1] + (self.ins_off[1:] + self.go_ge)
            return out
        base = Mrow - self.ins_off[:, None]
        run = np.maximum.accumulate(base, axis=0)
        out = np.full_like(Mrow, NEG)
        out[1:] = run[:-1] + (self.ins_off[1:, None] + self.go_ge)
        return out

    def step_row(self, i, M_prev, D_prev, I_prev):
        """Compute row i (consuming ancestor symbol i-1) from row i-1 —
        dna model only (codon models use the factored block machinery)."""
        m = self.m
        dt = self.dtype
        assert not m.codon
        x = self.anc[i - 1]
        emit = m.match_emit_eff[x][self.des].astype(dt)
        M = np.full(self.Cc, NEG, dtype=dt)
        M[1:] = np.maximum(
            np.maximum(M_prev[:-1] + self.ng_ng, D_prev[:-1] + self.gs),
            I_prev[:-1] + self.gs_ng,
        ) + emit
        D = np.maximum(np.maximum(M_prev + self.ng_go, D_prev + self.ge),
                       I_prev + self.gs_go) + dt(m.del_cost[x])
        I = self.row_ins(M)
        return M, D, I


def _clp(x):
    return x if x.ndim == 1 else x.max(axis=-1)


def triplet_forward(model, anc_cods, des_codes, keep_boundaries=False,
                    dtype=np.float32):
    """Viterbi sweep. Returns (terminal (M,D,I) adjusted at (n,m),
    boundary_rows) where boundary_rows[t] = collapsed rows at i=3t (codon
    models; every row for dna)."""
    dp = _DP(model, anc_cods, des_codes, dtype=dtype)
    n = len(anc_cods) * (3 if model.codon else 1)
    Mr, Dr, Ir = dp.init_row()
    boundaries = [(Mr.copy(), Dr.copy(), Ir.copy())] if keep_boundaries else None

    if model.codon:
        for t in range(len(anc_cods)):
            p = dp.block_pieces(t, Mr, Dr, Ir)
            Mr, Dr, Ir = dp.collapse_values(p)
            if keep_boundaries:
                boundaries.append((Mr, Dr, Ir))
    else:
        for i in range(1, n + 1):
            Mr, Dr, Ir = dp.step_row(i, Mr, Dr, Ir)
            if keep_boundaries:
                boundaries.append((Mr, Dr, Ir))

    term = (
        Mr[-1] + dp.ng_ng,
        Dr[-1] + dp.gs,
        Ir[-1] + dp.gs_ng,
    )
    return term, boundaries, dp


def _argmax_pref(mv, dv, iv):
    """M unless D strictly greater; I only if strictly greater than both."""
    best, val = MATCH, mv
    if dv > val:
        best, val = DELETION, dv
    if iv > val:
        return INSERTION
    return best


def encode_triplet_pair(model, anc: str, des: str):
    if model.codon:
        anc_enc = encode_triplet_anc(anc)
    else:
        anc_enc = encode_triplet_des(anc)
        if np.any(anc_enc == 4):
            raise ValueError(
                "Ambiguous nucleotides in reference sequence not supported."
            )
    return anc_enc, encode_triplet_des(des)


def triplet_align(model, anc: str, des: str):
    """Viterbi alignment under a triplet model.

    Returns (seq0, seq1, score) with score = -log best path weight (the
    FST ShortestDistance convention, align_fst.cc:91-97).
    """
    anc_enc, des_codes = encode_triplet_pair(model, anc, des)
    term, boundaries, dp = triplet_forward(
        model, anc_enc, des_codes, keep_boundaries=True
    )
    return traceback_from_boundaries(model, anc, des, term, boundaries, dp)


def traceback_from_boundaries(model, anc: str, des: str, term, boundaries,
                              dp: _DP):
    """Backward walk over checkpointed boundary rows (shared by the host
    forward and the device batch forward).

    Lane invariant: within a codon block the optimal path's lane c' is
    constant; whenever the walk arrives at a boundary with no lane bound
    (walk start, or after crossing a codon-entry transition), the
    collapse's argmax lane (codon64) of the current cell value is
    globally optimal because the value flowing onward was collapsed at
    the next codon entry. Phase-1/2 comparisons use the factored no-cost
    rows — the entry cost is common to every same-lane candidate, and the
    forward's cores were computed from exactly these values, so decisions
    agree with the forward bit-for-bit.
    """
    n = len(anc)
    mnum = len(des)
    score = max(term)
    state = _argmax_pref(*term)

    if not model.codon:
        # dna: boundaries holds EVERY row (period 1)
        s0: list[str] = []
        s1: list[str] = []
        i, j = n, mnum
        while i > 0 or j > 0:
            if state == MATCH:
                s0.append(anc[i - 1])
                s1.append(des[j - 1])
                pi_, pj = i - 1, j - 1
            elif state == DELETION:
                s0.append(anc[i - 1])
                s1.append("-")
                pi_, pj = i - 1, j
            else:
                s0.append("-")
                s1.append(des[j - 1])
                pi_, pj = i, j - 1
            if pi_ == 0 and pj == 0:
                break
            Mb, Db, Ib = boundaries[pi_]
            mv, dv, iv = Mb[pj], Db[pj], Ib[pj]
            if state == MATCH:
                nxt = _argmax_pref(mv + dp.ng_ng, dv + dp.gs, iv + dp.gs_ng)
            elif state == DELETION:
                nxt = _argmax_pref(mv + dp.ng_go, dv + dp.ge, iv + dp.gs_go)
            else:
                nxt = MATCH if mv + dp.go > iv + dp.ge else INSERTION
            i, j, state = pi_, pj, nxt
        return "".join(reversed(s0)), "".join(reversed(s1)), float(-score)

    pieces_cache = [-1, None]

    def pieces(t):
        if pieces_cache[0] != t:
            Mb, Db, Ib = boundaries[t]
            pieces_cache[0] = t
            pieces_cache[1] = dp.block_pieces(t, Mb, Db, Ib)
        return pieces_cache[1]

    rows3_cache: dict = {}

    def rows3(t, lane64):
        key = (t, lane64)
        if key not in rows3_cache:
            rows3_cache.clear()
            rows3_cache[key] = dp.lane_rows3(t, pieces(t), lane64)
        return rows3_cache[key]

    amax_cache = [-1, None]

    def amax(t):
        if amax_cache[0] != t:
            amax_cache[0] = t
            amax_cache[1] = dp.collapse_amax(pieces(t))
        return amax_cache[1]

    def cell_vals(i, j, lane64):
        t = (i - 1) // 3
        r = (i - 1) % 3
        p = pieces(t)
        x1 = (lane64 >> 4) & 3
        g = lane64 >> 2
        if r == 0:
            return p["M1"][j, x1], p["D1"][j], p["I1"][j, x1]
        if r == 1:
            return p["M2"][j, g], p["D2"][j, x1], p["I2"][j, g]
        M3, D3l, I3 = rows3(t, lane64)
        return M3[j], D3l[j], I3[j]

    s0 = []
    s1 = []
    i, j = n, mnum
    lane: int | None = None

    while i > 0 or j > 0:
        if i > 0 and lane is None:
            # binds only happen at codon boundaries (walk start or after
            # a crossing), where i is a multiple of 3
            aM, aD, aI = amax(i // 3 - 1)
            lane = int((aM, aD, aI)[state][j])

        if state == MATCH:
            s0.append(anc[i - 1])
            s1.append(des[j - 1])
            pi_, pj = i - 1, j - 1
        elif state == DELETION:
            s0.append(anc[i - 1])
            s1.append("-")
            pi_, pj = i - 1, j
        else:  # INSERTION
            s0.append("-")
            s1.append(des[j - 1])
            pi_, pj = i, j - 1

        if pi_ == 0 and pj == 0:
            i, j = 0, 0
            break

        crossing_entry = state != INSERTION and (i - 1) % 3 == 0

        if pi_ == 0 or crossing_entry:
            # predecessor is a collapsed boundary row; the codon-entry
            # cost is common to all three candidates and drops out
            Mb, Db, Ib = boundaries[pi_ // 3]
            mv, dv, iv = Mb[pj], Db[pj], Ib[pj]
        else:
            mv, dv, iv = cell_vals(pi_, pj, lane)

        if state == MATCH:
            nxt = _argmax_pref(mv + dp.ng_ng, dv + dp.gs, iv + dp.gs_ng)
        elif state == DELETION:
            nxt = _argmax_pref(mv + dp.ng_go, dv + dp.ge, iv + dp.gs_go)
        else:
            nxt = MATCH if mv + dp.go > iv + dp.ge else INSERTION

        if crossing_entry:
            lane = None
        i, j, state = pi_, pj, nxt

    return "".join(reversed(s0)), "".join(reversed(s1)), float(-score)


def triplet_path_score(model, s0: str, s1: str) -> float:
    """Score a FIXED aligned pair under the triplet model (the path weight
    the FST composition would assign this exact alignment): transition
    chain + per-codon-block max over the descendant-codon lane. Returns
    -log weight like triplet_align. Independent of the DP engines — used
    to verify that a traceback's alignment attains the optimal score."""
    if len(s0) != len(s1):
        raise ValueError("Aligned sequences must have equal length.")
    anc = s0.replace("-", "")
    des = s1.replace("-", "")
    if model.codon:
        anc_c = encode_triplet_anc(anc)
    else:
        anc_c = encode_triplet_des(anc)
    des_c = encode_triplet_des(des)

    ng, gs, go, ge = model.ng, model.gs, model.go, model.ge
    into_m = {"S": ng * 2, "M": ng * 2, "I": gs + ng, "D": gs}
    into_d = {"S": ng + go, "M": ng + go, "I": gs + go, "D": ge}
    into_i = {"S": go, "M": go, "I": ge}

    logp = 0.0
    prev = "S"
    i = j = 0
    ops = []
    for a, b in zip(s0, s1):
        if a != "-" and b != "-":
            logp += into_m[prev]
            ops.append(("M", i, j))
            if not model.codon:
                logp += float(model.match_emit_eff[anc_c[i], des_c[j]])
            i += 1
            j += 1
            prev = "M"
        elif b == "-":
            logp += into_d[prev]
            if not model.codon:
                logp += float(model.del_cost[anc_c[i]])
            i += 1
            prev = "D"
        else:
            if prev == "D":
                raise ValueError("Insertion directly after deletion is "
                                 "not representable.")
            logp += into_i[prev] + float(model.ins_emit[des_c[j]])
            j += 1
            prev = "I"
    logp += into_m[prev]  # terminal factor
    if model.codon:
        for t in range(len(anc) // 3):
            lane = np.array(model.logP[anc_c[t]], dtype=np.float64)
            for (op, ii, jj) in ops:
                if op == "M" and 3 * t <= ii < 3 * t + 3:
                    lane = lane + model.match_emit[
                        model.cnuc[ii % 3], des_c[jj]
                    ]
            logp += float(lane.max())
    return float(-logp)


def triplet_score(model, anc: str, des: str) -> float:
    """Optimal-path score in float64 (oracle precision; the alignment
    engines themselves are float32-canonical like the reference's f32 FST
    weights)."""
    anc_enc = (encode_triplet_anc(anc) if model.codon
               else encode_triplet_des(anc))
    des_codes = encode_triplet_des(des)
    term, _, _ = triplet_forward(model, anc_enc, des_codes,
                                 dtype=np.float64)
    return float(-max(term))


def triplet_align_driver(aln: AlignmentParams, device="cuda") -> bool:
    """The alignpair verb for tri-mg / tri-ecm / dna (align_fst.cc:45-111)."""
    from coati_tpu_torch import triplet_wavefront as tw
    from coati_tpu_torch import utils
    from coati_tpu_torch.device import resolve_device
    from coati_tpu_torch.io import read_input, write_output

    if aln.score:
        raise ValueError("Scoring only works with marginal models.")
    dev = resolve_device(device)

    aln.data = read_input(aln)
    utils.process_triplet(aln)
    utils.set_subst(aln)  # sets ECM pi etc.
    model = build_triplet_model(aln)

    anc, des = aln.seq(0), aln.seq(1)
    # Three routes, one result (the same f32 arithmetic and tie-breaks, so
    # the strings are triplet_align's): a pair whose boundary grid would pass
    # the byte budget takes the segmented two-pass path; a large pair the
    # batched device engine; a small one the host sweep, which is done before
    # a device call would have started.
    if model.codon and tw.is_long_pair(len(anc), len(des)):
        s0, s1, score = tw.triplet_align_long(model, anc, des, device=dev)
    elif model.codon and len(anc) * len(des) > 250_000:
        s0, s1, score = tw.triplet_align_batch(model, [(anc, des)],
                                               device=dev)[0]
    else:
        s0, s1, score = triplet_align(model, anc, des)
    aln.data.seqs = [s0, s1]
    aln.data.score = score

    utils.restore_end_stops(aln.data, aln.gap)
    write_output(aln)
    return True
