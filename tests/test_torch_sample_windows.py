"""The window route of the sample walk kernel (csrc/sample_walk.cu,
sample_window_kernel), emulated in plain Python on the CPU.

window_walk below follows the kernel: a warp a sample, rounds of S steps;
at the start of each round the warp copies the window of the Forward
matrices the next S steps can reach, rows max(i, 0) - k(S + 1) .. max(i, 0)
and columns max(j, 0) - k(S + 1) .. max(j, 0) clipped at 0, together with
the S uniforms of those steps and the codes of the window's rows and
columns; one lane takes the steps there, the reached cell's M, D, I kept
from the step before (the corner, the walk's first cell, is read from the
first window). Each step loads, before it draws, the three predecessors
and the match emission of the cell it moves to, which the step after it
reads: k beyond the S steps, hence the window's k(S + 1). A window row is copied as the lanes copy it: 16 bytes at a time
from the 16-byte boundary at or below the address of its first cell, which
the emulation places at a given offset from a 16-byte boundary (cells are 12
bytes, so rows start at any multiple of 4), to the place that puts its
first cell at window byte K + r P (K = 16 + that cell's offset, the pitch P
= Q + 12 Cc mod 16), so that every cell lies at K + r P + 12 c. A read of a
cell, a uniform or a code the window was not meant to hold raises, and so
does a copy that would leave the matrices' buffer or the window, or land on
another row's cells.

The samples step in lockstep, as the kernel's rounds keep them (every
active sample takes S steps a round), and the arithmetic of a step is
sample_paths_plain's, on values read through the windows, so the ops and
scores must equal sample_paths_plain's, which tests/test_torch_sample.py
holds to the JAX reference's _sample_paths on the same matrices and
uniforms.
"""

import numpy as np
import pytest
import torch

from coati_tpu.align.wavefront import gap_consts_array
from coati_tpu.structs import GapParams
from coati_tpu_torch.align import sample_device as tsd
from coati_tpu_torch.align.wavefront import LOWEST
from coati_tpu_torch.kernels import sample_walk as walk_mod
from coati_tpu_torch.kernels import wavefront_forward as fwd_mod


class OutsideWindow(AssertionError):
    pass


class Window:
    """One round's window of one sample: rows [r0, ia] x columns [c0, ja]
    of the matrices (flat bytes at address addr0), cell (r, c) at window
    byte K + r P + 12 c; `held` marks the bytes of the window's cells, the
    only ones a read may take; the uniforms of steps [t, t + lim) and the
    codes of its rows and columns."""

    def __init__(self, flat, addr0, Cc, i, j, H, t, lim, uniforms, n, enc_a, enc_b, k):
        self.ia, self.ja = max(i, 0), max(j, 0)
        self.r0, self.c0 = max(self.ia - H, 0), max(self.ja - H, 0)
        rows, cols = self.ia - self.r0 + 1, self.ja - self.c0 + 1
        Q, size = walk_mod.window_layout(H)
        row_step = (Cc * 12) % 16
        self.P = Q + row_step
        span = 12 * cols
        first = addr0 + (self.r0 * Cc + self.c0) * 12
        a0 = first % 16
        self.K = 16 + a0
        self.bytes = np.full(size, -1, np.int16)
        self.held = np.full(size, -1, np.int32)  # the row whose cell a byte is
        for r in range(rows):
            self.held[self.K + r * self.P:self.K + r * self.P + span] = r
        nch = walk_mod.window_row_bytes(H) // 16  # chunks a row may span
        assert nch <= 32, "a window row over 32 chunks"
        lo_buf, hi_buf = addr0 - addr0 % 16, -(-(addr0 + flat.size) // 16) * 16
        for r in range(rows):  # the chunks the warp copies, as the kernel loops them
            off = (a0 + r * row_step) % 16
            assert off == (first + r * Cc * 12) % 16
            for ch in range(nch):
                if 16 * ch < off + span:
                    lo = first + r * Cc * 12 - off + 16 * ch
                    dst = self.K + r * self.P - off + 16 * ch
                    assert lo % 16 == 0 and dst % 16 == 0
                    assert lo_buf <= lo and lo + 16 <= hi_buf, "a copy leaves the buffer"
                    assert 0 <= dst and dst + 16 <= size, "a copy leaves the window"
                    owners = set(self.held[dst:dst + 16].tolist()) - {-1, r}
                    assert not owners, f"row {r}'s copy lands on row {owners}"
                    for q in range(16):
                        at = lo + q - addr0
                        if 0 <= at < flat.size:
                            self.bytes[dst + q] = flat[at]
        self.t, self.lim, self.n = t, lim, n
        self.uni = uniforms[t + 1:t + 1 + lim, n].clone()
        self.code_a = [int(enc_a[max(self.r0 + x - k, 0)]) if len(enc_a) else 0 for x in range(rows)]
        self.code_b = [int(enc_b[max(self.c0 + x - k, 0)]) if len(enc_b) else 0 for x in range(cols)]

    def cell(self, ii, jj):
        r = max(ii, 0) - self.r0
        c = max(jj, 0) - self.c0
        at = self.K + r * self.P + 12 * c
        if not (r >= 0 and c >= 0 and 0 <= at and at + 12 <= self.held.size
                and (self.held[at:at + 12] == r).all()):
            raise OutsideWindow(f"cell ({ii}, {jj}) outside its window")
        raw = self.bytes[at:at + 12]
        assert (raw >= 0).all(), f"cell ({ii}, {jj}) never copied"
        return np.frombuffer(raw.astype(np.uint8).tobytes(), np.float32)

    def uniform(self, t):
        if not 0 <= t - self.t < self.lim:
            raise OutsideWindow(f"uniform of step {t} outside steps {self.t}..")
        return self.uni[t - self.t]

    def codes(self, i, j):
        x, y = max(i, 0) - self.r0, max(j, 0) - self.c0
        if not (0 <= x < len(self.code_a) and 0 <= y < len(self.code_b)):
            raise OutsideWindow(f"codes of ({i}, {j}) outside the window")
        return self.code_a[x], self.code_b[y]


def window_walk(mdi, enc_a, enc_b, table, gap_consts, uniforms, *, k, S, addr0=0, H=None):
    """The window route's walk; returns (ops, scores) as sample_walk. H: how
    far the window reaches above and left of its anchor, k(S + 1) unless
    given (S steps, and each loads what the step after it may read)."""
    R, Cc = mdi.shape[:2]
    n_steps, N = uniforms.shape[0] - 1, uniforms.shape[1]
    H = k * (S + 1) if H is None else H
    flat = mdi.contiguous().numpy().reshape(-1).view(np.uint8)
    ng, gs, go, ge = (gap_consts[q] for q in range(4))
    gek1, gek = ge * float(k - 1), ge * float(k)
    zero = torch.tensor(LOWEST, dtype=torch.float32)
    table_flat = table.reshape(-1)
    i = torch.full((N,), R - 1, dtype=torch.long)
    j = torch.full((N,), Cc - 1, dtype=torch.long)
    wins = [None] * N
    # what the next step of each walk may read, loaded a step ahead: the
    # predecessors into M, D and I, and the match emission
    v_p, v_k, v_j = (torch.zeros((N, 3)) for _ in range(3))
    sub = torch.zeros(N)

    def fetch(n, t, lim):
        wins[n] = Window(flat, addr0, Cc, int(i[n]), int(j[n]), H, t, lim, uniforms, n,
                         enc_a, enc_b, k)

    def ahead(n, ii, jj):
        w = wins[n]
        for v, (di, dj) in ((v_p, (1, 1)), (v_k, (k, 0)), (v_j, (0, k))):
            v[n] = torch.from_numpy(w.cell(ii - di, jj - dj).copy())
        ca, cb = w.codes(ii, jj)
        sub[n] = table_flat[ca * 15 + cb] if cb < 15 else 0.0

    for n in range(N):
        fetch(n, 0, min(S, n_steps))
    c = torch.from_numpy(np.stack([w.cell(R - 1, Cc - 1) for w in wins]))  # [N, 3]
    for n in range(N):
        ahead(n, R - 1, Cc - 1)
    w0 = c.max(dim=1).values
    u0 = torch.stack([uniforms[0, n] for n in range(N)])
    pick, score = tsd._draw(c[:, 0] - w0, c[:, 1] - w0, c[:, 2] - w0, u0)
    ops = torch.full((n_steps, N), -1, dtype=torch.int8)
    for t in range(n_steps):
        active = (i > k - 1) | (j > k - 1)
        if not bool(active.any()):
            break
        if t % S == 0 and t > 0:  # a new round: each walk that goes on fetches
            for n in range(N):
                if bool(active[n]):
                    fetch(n, t, min(S, n_steps - t))
                    ahead(n, int(i[n]), int(j[n]))
        body = (i >= k) & (j >= k)
        di = torch.where(pick == 0, 1, torch.where(pick == 1, k, 0))
        dj = torch.where(pick == 0, 1, torch.where(pick == 2, k, 0))
        pi, pj = i - di, j - dj
        # the arithmetic of sample_paths_plain on the values read a step ahead
        mm = torch.where(body, v_p[:, 0] + (ng + ng) + sub, zero)
        dm = torch.where(body, v_p[:, 1] + gs + sub, zero)
        im = torch.where(body, v_p[:, 2] + (gs + ng) + sub, zero)
        md = torch.where(body, v_k[:, 0] + (ng + go) + gek1, zero)
        dd = torch.where(body, v_k[:, 1] + gek, c[:, 1])
        id_ = torch.where(body, v_k[:, 2] + (gs + go) + gek1, zero)
        mi = torch.where(body, v_j[:, 0] + go + gek1, zero)
        ii = torch.where(body, v_j[:, 2] + gek, c[:, 2])
        w = c.gather(1, pick[:, None])[:, 0]
        logm = torch.where(pick == 0, mm, torch.where(pick == 1, md, mi)) - w
        logd = torch.where(pick == 0, dm, torch.where(pick == 1, dd, zero)) - w
        logi = torch.where(pick == 0, im, torch.where(pick == 1, id_, ii)) - w
        u = torch.zeros(N)
        for n in range(N):
            if bool(active[n]):
                u[n] = wins[n].uniform(t)
        nxt, ds = tsd._draw(logm, logd, logi, u)
        v = torch.where((pick == 0)[:, None], v_p, torch.where((pick == 1)[:, None], v_k, v_j))
        for n in range(N):  # the step after may read these
            if bool(active[n]):
                ahead(n, int(pi[n]), int(pj[n]))
        ops[t] = torch.where(active, pick, -1).to(torch.int8)
        i = torch.where(active, pi, i)
        j = torch.where(active, pj, j)
        score = torch.where(active, score + ds, score)
        pick = torch.where(active, nxt, pick)
        c = torch.where(active[:, None], v, c)
    return ops, score


def _inputs(seed, k, na, nb, N, mg94_table):
    """One pair's Forward matrices (the plain Forward, the adjusted corner
    written in as sample_batch_device writes it) and N samples' uniforms."""
    rng = np.random.default_rng(seed)
    enc_a = torch.from_numpy(rng.integers(0, 183, na).astype(np.int32))
    enc_b = torch.from_numpy(rng.integers(0, 16, nb).astype(np.int32))
    table = torch.from_numpy(np.ascontiguousarray(mg94_table, np.float32))
    gc = torch.from_numpy(gap_consts_array(GapParams(len=k)))
    adj, mdi = fwd_mod.forward_plain(enc_a[None], enc_b[None], torch.tensor([na], dtype=torch.int32),
                                     torch.tensor([nb], dtype=torch.int32), table, gc, k=k)
    mdi = mdi[0].contiguous()
    mdi[na + k - 1, nb + k - 1] = adj[:, 0]
    gen = torch.Generator().manual_seed(seed)
    uniforms = torch.rand(((na + nb) + 1, N), generator=gen)
    return mdi, enc_a, enc_b, table, gc, uniforms


# (k, ancestor nt, descendant nt, samples, S, addr0): k = 1, 3, 5; windows
# that reach the matrix's edges, walks that end inside a window, a pair much
# wider than long and one much longer than wide, several address offsets
CASES = [
    (1, 60, 47, 13, 32, 0),
    (1, 60, 47, 9, 4, 4),
    (1, 9, 60, 9, 3, 8),
    (1, 75, 6, 9, 5, 12),
    (3, 36, 42, 11, 10, 4),
    (3, 45, 30, 7, 2, 12),
    (5, 45, 50, 7, 6, 8),
    (5, 30, 40, 7, 1, 0),
]


@pytest.mark.parametrize("k,na,nb,N,S,addr0", CASES)
def test_window_walk_equals_plain(mg94_table, k, na, nb, N, S, addr0):
    args = _inputs(100 * k + na + S, k, na, nb, N, mg94_table)
    ops_e, sc_e = window_walk(*args, k=k, S=S, addr0=addr0)
    ops_p, sc_p = tsd.sample_paths_plain(*args, k=k)
    assert torch.equal(ops_e, ops_p)
    assert torch.equal(sc_e, sc_p)
    assert (ops_p >= 0).sum() > 0 and bool(torch.isfinite(sc_p).all())


def test_the_cases_reach_their_shapes(mg94_table):
    """Some walk ends inside a window (not on a round's boundary), some
    window is clipped at row 0 and at column 0, the offsets cover every
    multiple of 4 below 16, and some rows start at a different offset than
    the row above."""
    ends_inside = 0
    for k, na, nb, N, S, _ in CASES:
        args = _inputs(100 * k + na + S, k, na, nb, N, mg94_table)
        ops, _ = tsd.sample_paths_plain(*args, k=k)
        lengths = (ops >= 0).sum(0)
        ends_inside += int((lengths % S != 0).sum())
    assert ends_inside >= 10
    assert {addr0 for *_, addr0 in CASES} == {0, 4, 8, 12}
    assert any(((nb + k) * 12) % 16 for k, _, nb, *_ in CASES)


def test_a_window_one_row_short_reads_outside_it(mg94_table):
    """A window reaching k(S + 1) - 1 rows and columns beyond its anchor:
    some step reads a cell it does not hold."""
    args = _inputs(7, 1, 60, 47, 13, mg94_table)
    with pytest.raises(OutsideWindow):
        window_walk(*args, k=1, S=8, H=8)
    args = _inputs(9, 3, 36, 42, 11, mg94_table)
    with pytest.raises(OutsideWindow):
        window_walk(*args, k=3, S=4, H=14)


def test_walk_shape_fits_a_block():
    """Up to k = 20 the default shape takes windows that fit a block's
    shared memory beside the table, S at most 32 (a lane stages one uniform), rows of at most
    32 chunks of 16 bytes (one a lane); k = 1 takes WINDOW_STEPS; above, one
    thread a sample. window_bytes is the kernel's warp_bytes."""
    for k in range(1, 65):
        S, warps = walk_mod.walk_shape(k)
        if k > 20:
            assert (S, warps) == (0, 1)
            continue
        assert 1 <= S <= 32 and warps >= 1
        assert (walk_mod.table_bytes(walk_mod.TABLE_LEN) + warps * walk_mod.window_bytes(k, S)
                <= walk_mod.SMEM_BYTES)
        assert walk_mod.window_row_bytes(k * (S + 1)) <= walk_mod.WINDOW_ROW_BYTES
    assert walk_mod.walk_shape(1) == (walk_mod.WINDOW_STEPS, walk_mod.WALK_WARPS)
    assert walk_mod.walk_shape(3) == (10, walk_mod.WALK_WARPS)
    # 34 rows at a pitch of 448 + 12 and 32 bytes, 388 of uniforms, log
    # weights and scales, 272 of codes, 32 of ops, rounded up to 16
    assert walk_mod.window_layout(33) == (448, 34 * 460 + 32)
    assert walk_mod.window_bytes(1, 32) == -(-(34 * 460 + 32 + 388 + 272 + 32) // 16) * 16


def test_sample_walk_on_cpu_takes_plain_at_any_shape(mg94_table):
    """On CPU tensors sample_walk takes sample_paths_plain whatever S and
    warps it is given, and counts no launch; a shape the kernel does not
    take raises."""
    args = _inputs(3, 1, 30, 24, 5, mg94_table)
    before = walk_mod.LAUNCHES
    want = tsd.sample_paths_plain(*args, k=1)
    for S, warps in ((0, 1), (1, 1), (32, 8)):
        got = walk_mod.sample_walk(*args, k=1, S=S, warps=warps)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert walk_mod.LAUNCHES == before
    with pytest.raises(ValueError, match="S must be 0 or 1-32"):
        walk_mod.sample_walk(*args, k=1, S=33)
    with pytest.raises(ValueError, match="shared memory"):
        walk_mod.sample_walk(*args, k=1, S=32, warps=32)
    k = 21  # one step reaches 21 rows and columns: a row of 45 cells is 34 chunks
    wide = (torch.zeros((30 + k, 20 + k, 3)), torch.zeros(30, dtype=torch.int32),
            torch.zeros(20, dtype=torch.int32), *args[3:5], torch.zeros((51, 2)))
    with pytest.raises(ValueError, match="their rows"):
        walk_mod.sample_walk(*wide, k=k, S=1)
