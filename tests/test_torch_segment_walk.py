"""The segment walk kernel (csrc/traceback_walk.cu,
traceback_walk_segment_kernel), emulated in plain Python on the CPU.

window_walk_segment below follows the kernel: a warp a pair, rounds of S
steps (the first of them, as many as surely stay inside the matrix and the
segment, taken without a test: the emulation asserts that they do), two
windows a warp, the next one anchored where the walk stands at
the start of each round and used a round later. A window holds diagonals
[t - Hd, t] x columns [j - Hc, j] of the segment (t = i + j - d0), Hd =
2 max(2, k) S, Hc = 2kS, clipped at 0. Its rows are copied as the lanes
copy them: 16 bytes at a time from the 16-byte boundary at or below the
address of the row's first cell, which the emulation places at a given
offset from a 16-byte boundary, since rows of C bytes are not a multiple of
16; lane l copies chunk l % nch of rows l // nch, l // nch + per, ... A
read of a byte the window was not meant to hold raises, and so does a
copy that would leave the segment's buffer or its window row.

The ops and the (i, j, st, s) state after each segment, chained last to
first, must equal walk_segment_plain's and the JAX reference's
(coati_tpu/align/longseq.py _walk_segment on XLA:CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coati_tpu.align import longseq as jax_longseq
from coati_tpu.align.wavefront import gap_consts_array
from coati_tpu.structs import GapParams
from coati_tpu_torch.align import wavefront as tw
from coati_tpu_torch.kernels import traceback_walk as walk_mod
from test_torch_longseq import _jax_segments


def _ragged(seed, k, la, lb, n_codes=4):
    """Pairs of the given lengths (multiples of 3k and k) padded to their
    maxima."""
    rng = np.random.default_rng(seed)
    la, lb = np.array(la, np.int32), np.array(lb, np.int32)
    B = len(la)
    aseq = np.zeros((B, int(la.max())), np.int32)
    bseq = np.zeros((B, int(lb.max())), np.int32)
    for p in range(B):
        aseq[p, : la[p]] = rng.integers(0, 183, la[p])
        bseq[p, : lb[p]] = rng.integers(0, n_codes, lb[p])
    return aseq, bseq, la, lb


class Window:
    """One window as the kernel fills it: rows [t0, ta] x columns [c0, ja],
    row r at byte off(r) of its wb bytes; `held` marks the bytes of the
    window's cells, the only ones a read may take."""

    def __init__(self, flat, addr0, p, T, C, ta, ja, Hd, Hc, wb):
        self.t0, self.c0 = max(ta - Hd, 0), max(ja - Hc, 0)
        first = addr0 + (p * T + self.t0) * C + self.c0  # byte address
        self.a0, self.cm, self.wb = first % 16, C & 15, wb
        self.bytes = np.full((Hd + 1, wb), -1, np.int16)
        self.held = np.zeros((Hd + 1, wb), bool)
        span = ja - self.c0 + 1
        nch = (span + 30) >> 4
        assert nch <= 32 and 16 * nch <= wb
        per = 32 // nch
        rows = ta - self.t0 + 1
        for lane in range(32):  # the lanes' copies, as fetch_seg_window makes them
            c = lane % nch
            r = lane // nch
            while lane < per * nch and r < rows:
                off = (self.a0 + r * (C & 15)) & 15
                assert off == (first + r * C) % 16
                if 16 * c < off + span:
                    lo = first + r * C - off + 16 * c
                    assert lo % 16 == 0
                    # the chunk holds a byte of this row's cells
                    assert lo < first + r * C + span and lo + 16 > first + r * C
                    for q in range(16):
                        at = lo + q - addr0
                        if 0 <= at < flat.size:
                            self.bytes[r, 16 * c + q] = flat[at]
                self.held[r, off:off + span] = True
                r += per

    def read(self, t, j):
        r = t - self.t0
        at = ((self.a0 + r * self.cm) & 15) + j - self.c0
        assert 0 <= r < self.bytes.shape[0] and 0 <= at < self.wb
        assert self.held[r, at], f"cell ({t}, {j}) outside its window"
        assert self.bytes[r, at] >= 0, f"cell ({t}, {j}) never copied"
        return int(self.bytes[r, at])


def window_walk_segment(bp_seg, d0, state, ops, *, k, S, start=None, addr0=0):
    """The kernel's walk through bp_seg [B, T, C] (diagonals [d0, d0 + T)),
    its buffer at byte address addr0; updates state and ops in place as
    walk_segment does. Returns the score with start, else None."""
    B, T, C = bp_seg.shape
    flat = bp_seg.reshape(-1).numpy()
    Hd, Hc = 2 * max(k, 2) * S, 2 * k * S
    wb = (Hc + 31) & ~15
    assert wb == walk_mod.segment_row_bytes(k, S)
    max_steps = ops.shape[0]
    score = None
    if start is not None:
        adj, la, lb = start
        score = torch.maximum(adj[0], torch.maximum(adj[1], adj[2]))
    for p in range(B):
        if start is not None:
            i, j, s = int(la[p]) + k - 1, int(lb[p]) + k - 1, 0
            st = int(tw.argmax_mdi(adj[0, p:p + 1], adj[1, p:p + 1], adj[2, p:p + 1])[0])
        else:
            i, j, st, s = (int(state[q, p]) for q in range(4))

        def going(n):
            return (s + n < max_steps and (i > k - 1 or j > k - 1) and i >= 0
                    and j >= 0 and i + j >= d0 and i + j - d0 < T)

        def fetch():
            return Window(flat, addr0, p, T, C, i + j - d0, j, Hd, Hc, wb)

        done = not going(0)
        cur = None if done else fetch()
        rnd = 0
        while not done:
            nxt = fetch() if rnd > 0 else cur
            n, lim = 0, min(S, max_steps - s)
            # the kernel takes the first `sure` steps without testing them
            sure = min(lim, min(i, j) // k, (i + j - d0) // max(k, 2) + 1)
            while n < lim and (n < sure or going(n)):
                assert going(n), f"pair {p}: step {n} of {sure} sure steps ends the walk"
                code = cur.read(i + j - d0, j)
                ops[s + n, p] = st
                i, j = (i - 1, j - 1) if st == 0 else (i - k, j) if st == 1 else (i, j - k)
                st = (code >> (2 * st)) & 3
                n += 1
            done = not going(n)
            s += n
            cur = nxt
            rnd += 1
        state[:, p] = torch.tensor([i, j, st, s], dtype=torch.int32)
    return score


def _ops_lists(ops):
    ops = np.asarray(ops)
    return [ops[:, p][ops[:, p] >= 0].tolist() for p in range(ops.shape[1])]


# (k, ancestors, descendants, T, S, addr0): a T that does not divide the
# diagonals; ragged pairs whose corners lie below the top segment (they park
# at once) or that park at different launches; several window offsets
CASES = [
    (1, (90, 153, 30), (96, 150, 24), 64, 1, 0),
    (1, (90, 153, 30), (96, 150, 24), 64, 3, 5),
    (1, (150, 120), (140, 160), 77, 8, 11),
    (3, (99, 144, 36), (102, 138, 27), 100, 2, 3),
    (3, (144, 72), (150, 60), 61, 5, 15),
    (5, (105, 150), (110, 145), 90, 1, 7),
    (5, (150, 45), (140, 40), 70, 3, 0),
    (9, (135, 108), (144, 99), 80, 2, 9),
]


@pytest.mark.parametrize("k,la,lb,T,S,addr0", CASES)
def test_window_walk_segment_equals_plain_and_xla(mg94_table, k, la, lb, T, S, addr0):
    aseq, bseq, la, lb = _ragged(400 + 10 * k + S, k, la, lb)
    gc = gap_consts_array(GapParams(len=k))
    B = aseq.shape[0]
    Dtot = aseq.shape[1] + bseq.shape[1] + 2 * k - 1
    assert Dtot % T
    ref = _jax_segments(aseq, bseq, la, lb, mg94_table, gc, k, T, "viterbi")
    adj = torch.from_numpy(np.stack(ref[-1][1]))
    t_la, t_lb = torch.from_numpy(la), torch.from_numpy(lb)

    st = jax_longseq._argmax_mdi(*[jnp.asarray(c) for c in ref[-1][1]]).astype(jnp.int32)
    i, j = jnp.asarray(la) + jnp.int32(k - 1), jnp.asarray(lb) + jnp.int32(k - 1)
    s_x, ops_x = jnp.int32(0), jnp.full((Dtot, B), -1, dtype=jnp.int8)
    state_e = torch.full((4, B), 7, dtype=torch.int32)
    state_p = state_e.clone()
    ops_e = torch.full((Dtot, B), -1, dtype=torch.int8)
    ops_p = ops_e.clone()
    top = len(ref) - 1
    parked = set()
    for seg in range(top, -1, -1):
        bp_x = ref[seg][2]
        i, j, st, s_x, ops_x = jax_longseq._walk_segment(
            jnp.asarray(bp_x), jnp.int32(seg * T), i, j, st, s_x, ops_x, k=k)
        bp = torch.from_numpy(np.ascontiguousarray(np.transpose(bp_x, (1, 0, 2))))
        begin = (adj, t_la, t_lb) if seg == top else None
        score_e = window_walk_segment(bp, seg * T, state_e, ops_e, k=k, S=S,
                                      start=begin, addr0=addr0)
        _, _, score_p = tw.walk_segment_plain(bp, seg * T, state_p, ops_p, k=k,
                                              start=begin)
        assert torch.equal(state_e, state_p) and torch.equal(ops_e, ops_p)
        if begin is not None:
            assert torch.equal(score_e, score_p)
        np.testing.assert_array_equal(state_e[:3].numpy(), np.stack(
            [np.asarray(i), np.asarray(j), np.asarray(st)]))
        assert _ops_lists(ops_e) == _ops_lists(ops_x)
        parked |= {p for p in range(B) if int(state_e[0, p]) + int(state_e[1, p]) < seg * T}
    assert state_e[0].tolist() == [k - 1] * B and state_e[1].tolist() == [k - 1] * B
    assert len(parked) == B  # every pair parked at least once


def test_the_cases_reach_their_shapes():
    """Some pair's corner lies below the top segment (it parks on the first
    launch), and the window offsets cover odd and even row strides."""
    below = 0
    for k, la, lb, T, _, _ in CASES:
        NA, NB = max(la), max(lb)
        Dtot = NA + NB + 2 * k - 1
        top_d0 = (Dtot - 1) // T * T
        below += any(a + b + 2 * (k - 1) < top_d0 for a, b in zip(la, lb))
    assert below >= 3
    assert {(max(lb) + k) % 2 for k, _, lb, *_ in CASES} == {0, 1}
    assert len({addr0 for *_, addr0 in CASES}) >= 5


def test_the_default_windows_fit_a_block():
    """At every gap length up to 32 the default S gives windows whose rows
    are at most 32 copies of 16 bytes and whose warps fit the shared memory
    a block may use."""
    for k in range(1, 33):
        S = walk_mod.segment_window_steps(k)
        assert S >= 1
        assert walk_mod.segment_row_bytes(k, S) <= walk_mod.WINDOW_ROW_BYTES
        assert walk_mod.WALK_WARPS * walk_mod.segment_window_bytes(k, S) <= walk_mod.SMEM_BYTES
    assert walk_mod.segment_window_steps(1) == walk_mod.SEGMENT_WINDOW_STEPS


def test_segment_walk_on_cpu_launches_nothing(mg94_table):
    """On CPU tensors walk_segment takes walk_segment_plain, whatever S and
    warps it is given, and counts no launch."""
    k, T = 1, 64
    aseq, bseq, la, lb = _ragged(5, k, (60, 90), (66, 84))
    gc = gap_consts_array(GapParams(len=k))
    ref = _jax_segments(aseq, bseq, la, lb, mg94_table, gc, k, T, "viterbi")
    adj = torch.from_numpy(np.stack(ref[-1][1]))
    B, Dtot = 2, aseq.shape[1] + bseq.shape[1] + 1
    before = (walk_mod.LAUNCHES, walk_mod.SEGMENT_LAUNCHES)
    state = torch.empty((4, B), dtype=torch.int32)
    ops = torch.full((Dtot, B), -1, dtype=torch.int8)
    want_state, want_ops = state.clone(), ops.clone()
    top = len(ref) - 1
    for seg in range(top, -1, -1):
        bp = torch.from_numpy(np.ascontiguousarray(np.transpose(ref[seg][2], (1, 0, 2))))
        begin = (adj, torch.from_numpy(la), torch.from_numpy(lb)) if seg == top else None
        walk_mod.walk_segment(bp, seg * T, state, ops, k=k, start=begin, S=3, warps=1)
        tw.walk_segment_plain(bp, seg * T, want_state, want_ops, k=k, start=begin)
        assert torch.equal(state, want_state) and torch.equal(ops, want_ops)
    assert (walk_mod.LAUNCHES, walk_mod.SEGMENT_LAUNCHES) == before
