"""coati_tpu_torch's long-pair path and score-only Viterbi against the JAX
package on the CPU.

The same numpy inputs go through coati_tpu (XLA:CPU, and the Pallas kernels
in interpret mode) and through the port, whose kernel wrappers take their
plain PyTorch versions on CPU tensors. Tolerance: none. Rings, corners and
scores are compared bit for bit in f32, backpointer bytes on every slot,
walk states value for value, op sequences op for op, strings byte for byte.
"""

import functools
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coati_tpu.align import engine as jax_engine
from coati_tpu.align import longseq as jax_longseq
from coati_tpu.align.wavefront import gap_consts_array, wavefront, wavefront_impl
from coati_tpu.constants import CODONS61
from coati_tpu.structs import GapParams
from coati_tpu.utils import encode_marginal
from coati_tpu_torch.align import engine as torch_engine
from coati_tpu_torch.align import longseq as torch_longseq
from coati_tpu_torch.align import wavefront as tw
from coati_tpu_torch.kernels import traceback_walk as walk_mod
from coati_tpu_torch.kernels import wavefront_score as score_mod
from coati_tpu_torch.kernels import wavefront_segment as seg_mod
from coati_tpu_torch.params import carry_from_numpy, carry_to_numpy


@pytest.fixture(autouse=True)
def _one_jax_device(monkeypatch):
    monkeypatch.setenv("COATI_TPU_MAX_DEVICES", "1")


def _group(seed, k, B=3, na=(90, 150), nb=(90, 150), n_codes=16):
    """Ragged random group padded to its maxima: ancestor codes < 183,
    descendant codes < n_codes (all 15 IUPAC columns and the gap code 15),
    lengths multiples of 3k (ancestor) and k (descendant)."""
    rng = np.random.default_rng(seed)
    la = rng.integers(na[0] // (3 * k), na[1] // (3 * k) + 1, B) * 3 * k
    lb = rng.integers(nb[0] // k, nb[1] // k + 1, B) * k
    aseq = np.zeros((B, int(la.max())), np.int32)
    bseq = np.zeros((B, int(lb.max())), np.int32)
    for p in range(B):
        aseq[p, : la[p]] = rng.integers(0, 183, la[p])
        bseq[p, : lb[p]] = rng.integers(0, n_codes, lb[p])
    return aseq, bseq, la.astype(np.int32), lb.astype(np.int32)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def _jax_segments(aseq, bseq, la, lb, table, gc, k, T, mode):
    """The reference's pass 1 by _segment: per segment (carry in, adj, ys,
    carry out) as numpy."""
    B, NA = aseq.shape
    C = bseq.shape[1] + k
    K = max(k, 2)
    Dtot = NA + bseq.shape[1] + 2 * k - 1
    lowest = np.float32(np.finfo(np.float32).min)
    ring = jnp.full((K, 3, B, C), lowest)
    corners = tuple(jnp.full((B,), lowest) for _ in range(3))
    jargs = [jnp.asarray(x) for x in (aseq, bseq, la, lb, table, gc)]
    out = []
    for s in range(-(-Dtot // T)):
        adj, ys, (ring2, corners2) = jax_longseq._segment(
            *jargs, ring, corners, jnp.int32(s * T), k=k, n_steps=T, mode=mode)
        out.append(((np.asarray(ring), [np.asarray(c) for c in corners]),
                    [np.asarray(c) for c in adj],
                    None if ys is None else np.asarray(ys),
                    (np.asarray(ring2), [np.asarray(c) for c in corners2])))
        ring, corners = ring2, corners2
    return out


def _assert_carry_equal(carry, want):
    ring, corners = carry_to_numpy(carry)
    np.testing.assert_array_equal(ring, want[0])
    for x, y in zip(corners, want[1]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("k,T", [(1, 64), (3, 100)])
def test_segment_fill_matches_xla_segments(mg94_table, k, T):
    """The segment wrapper chained over every segment of a ragged group:
    ring, raw corners and the segment's bp equal _segment's after every
    segment, on every slot; and again started in the middle from the
    reference's checkpoint through the carry conversion."""
    aseq, bseq, la, lb = _group(300 + k, k)
    gc = gap_consts_array(GapParams(len=k))
    B, C = aseq.shape[0], bseq.shape[1] + k
    Dtot = aseq.shape[1] + bseq.shape[1] + 2 * k - 1
    assert Dtot % T != 0
    ref = _jax_segments(aseq, bseq, la, lb, mg94_table, gc, k, T, "viterbi")
    assert len(ref) >= 3
    targs = _torch(aseq, bseq, la, lb, mg94_table, gc)

    carry = seg_mod.empty_carry(B, C, k, "cpu")
    _assert_carry_equal(carry, ref[0][0])
    for s, (_, adj_x, bp_x, carry_x) in enumerate(ref):
        adj, bp, carry = seg_mod.wavefront_segment(
            *targs, carry, s * T, k=k, n_steps=T, want_bp=True)
        _assert_carry_equal(carry, carry_x)
        np.testing.assert_array_equal(bp.numpy(), np.transpose(bp_x, (1, 0, 2)))
    np.testing.assert_array_equal(adj.numpy(), np.stack(ref[-1][1]))

    mid = len(ref) // 2
    carry = carry_from_numpy(*ref[mid][0], "cpu")
    for s in range(mid, len(ref)):
        adj, bp, carry = seg_mod.wavefront_segment(
            *targs, carry, s * T, k=k, n_steps=T, want_bp=False)
        assert bp is None
        _assert_carry_equal(carry, ref[s][3])
    np.testing.assert_array_equal(adj.numpy(), np.stack(ref[-1][1]))
    # and the other way round: the reference continues from the port's carry
    ring_np, corners_np = carry_to_numpy(carry_from_numpy(*ref[mid][0], "cpu"))
    adj_x, _, _ = jax_longseq._segment(
        *[jnp.asarray(x) for x in (aseq, bseq, la, lb, mg94_table, gc)],
        jnp.asarray(ring_np), tuple(jnp.asarray(c) for c in corners_np),
        jnp.int32(mid * T), k=k, n_steps=T, mode="score")
    for x, y in zip(adj_x, ref[mid][1]):
        np.testing.assert_array_equal(np.asarray(x), y)


@pytest.mark.parametrize("k,T", [(1, 64), (3, 100)])
def test_segment_chain_matches_pallas_segment_kernel(mg94_table, k, T):
    """The TPU segment kernel in interpret mode, chained with its own carry
    layout, and the port's chain give the same adjusted corners."""
    from coati_tpu.kernels.wavefront_pallas import (
        segment_consts,
        segment_corners,
        wavefront_pallas_segment,
    )

    aseq, bseq, la, lb = _group(310 + k, k, na=(48, 96), nb=(48, 96))
    gc = gap_consts_array(GapParams(len=k))
    B = aseq.shape[0]
    fold = max(1, 8 // B)
    consts, carry, n_seg, _, NAr = segment_consts(
        *[jnp.asarray(x) for x in (aseq, bseq, la, lb, mg94_table, gc)],
        k=k, T=T, code_cols=tuple(range(15)), fold=fold)
    for s in range(n_seg):
        _, carry = wavefront_pallas_segment(
            consts, carry, jnp.int32(s * T), k=k, T=T, want_bp=False, NA=NAr,
            interpret=True, fold=fold)
    want = [np.asarray(c)[:B] for c in segment_corners(carry[2], jnp.asarray(gc), fold)]

    targs = _torch(aseq, bseq, la, lb, mg94_table, gc)
    Dtot = aseq.shape[1] + bseq.shape[1] + 2 * k - 1
    tcarry = seg_mod.empty_carry(B, bseq.shape[1] + k, k, "cpu")
    for s in range(-(-Dtot // 37)):
        adj, _, tcarry = seg_mod.wavefront_segment(
            *targs, tcarry, s * 37, k=k, n_steps=37, want_bp=False)
    np.testing.assert_array_equal(adj.numpy(), np.stack(want))


@pytest.mark.parametrize("k", [1, 3])
def test_score_mode_matches_xla_and_pallas(mg94_table, k):
    from coati_tpu.kernels.wavefront_pallas import wavefront_pallas

    aseq, bseq, la, lb = _group(320 + k, k, B=8, na=(24, 96), nb=(24, 96))
    gc = gap_consts_array(GapParams(len=k))
    jargs = [jnp.asarray(x) for x in (aseq, bseq, la, lb, mg94_table, gc)]
    want, ys = wavefront(*jargs, k=k, semiring="tropical", mode="score")
    assert ys is None
    got = score_mod.wavefront_score(*_torch(aseq, bseq, la, lb, mg94_table, gc), k=k)
    np.testing.assert_array_equal(got.numpy(), np.stack([np.asarray(c) for c in want]))
    pal, _ = wavefront_pallas(*jargs, k=k, bc=8, want_bp=False, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.stack([np.asarray(c) for c in pal]))
    # the plain fill in score mode is the viterbi mode without bp
    adj, bp = tw.wavefront_plain(*_torch(aseq, bseq, la, lb, mg94_table, gc), k=k)
    np.testing.assert_array_equal(got.numpy(), torch.stack(adj).numpy())
    # an unknown mode or semiring is refused; forward mode, ported with the
    # sampling path, takes the whole matrix only
    with pytest.raises(ValueError, match="mode"):
        tw.wavefront_plain(*_torch(aseq, bseq, la, lb, mg94_table, gc), k=k,
                           mode="backward")
    with pytest.raises(ValueError, match="semiring"):
        tw.wavefront_plain(*_torch(aseq, bseq, la, lb, mg94_table, gc), k=k,
                           mode="score", semiring="arctic")
    with pytest.raises(ValueError, match="whole matrix"):
        tw.wavefront_plain(*_torch(aseq, bseq, la, lb, mg94_table, gc), k=k,
                           mode="forward", semiring="log", n_steps=10)
    # the log semiring in score mode gives the Forward's corners
    log_adj, none = tw.wavefront_plain(
        *_torch(aseq, bseq, la, lb, mg94_table, gc), k=k, mode="score",
        semiring="log")
    fwd_adj, _ = tw.wavefront_plain(
        *_torch(aseq, bseq, la, lb, mg94_table, gc), k=k, mode="forward",
        semiring="log")
    assert none is None
    for x, y in zip(log_adj, fwd_adj):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def _mutated_pair(rng, n_codons, k=1, sub_rate=0.05, n_indels=3, alphabet="ACGT"):
    anc = "".join(rng.choice(CODONS61) for _ in range(n_codons))
    des = list(anc)
    for i in range(len(des)):
        if rng.random() < sub_rate:
            des[i] = rng.choice(alphabet)
    des = "".join(des)
    for _ in range(n_indels):
        ln = rng.randint(1, 9)
        pos = rng.randint(0, max(0, len(des) - ln))
        if rng.random() < 0.5:
            des = des[:pos] + des[pos + ln:]
        else:
            des = des[:pos] + "".join(rng.choice("ACGT") for _ in range(ln)) + des[pos:]
    return anc, des[: len(des) - len(des) % k]


def _pairs(seed, sizes, k, alphabet="ACGT"):
    rng = random.Random(seed)
    pairs = [_mutated_pair(rng, n, k, alphabet=alphabet) for n in sizes]
    enc = [encode_marginal(a, d) for a, d in pairs]
    return ([e[0] for e in enc], [e[1] for e in enc],
            [a for a, _ in pairs], [d for _, d in pairs])


def _assert_same(res_a, res_b):
    assert len(res_a) == len(res_b)
    for ra, rb in zip(res_a, res_b):
        assert (ra.seq0, ra.seq1) == (rb.seq0, rb.seq1)
        assert np.float32(ra.score) == np.float32(rb.score)


@pytest.mark.parametrize("k", [1, 3])
def test_scores_batch_matches_jax_and_the_alignments(mg94_table, k):
    enc_as, enc_bs, astrs, bstrs = _pairs(40 + k, (10, 25, 40, 33, 70, 12), k,
                                          alphabet="ACGTRYN")
    gap = GapParams(len=k)
    want = jax_engine.viterbi_scores_batch(enc_as, enc_bs, mg94_table, gap)
    got = torch_engine.viterbi_scores_batch(enc_as, enc_bs, mg94_table, gap,
                                            device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    aligned = torch_engine.viterbi_align_batch(enc_as, enc_bs, astrs, bstrs,
                                               mg94_table, gap, device="cpu")
    np.testing.assert_array_equal(
        got, np.array([r.score for r in aligned], dtype=np.float32))
    split = torch_engine.viterbi_scores_batch(enc_as, enc_bs, mg94_table, gap,
                                              device="cpu", max_batch_bytes=5_000)
    np.testing.assert_array_equal(split, want)


def _ops_lists(ops):
    ops = np.asarray(ops)
    return [ops[:, p][ops[:, p] >= 0].tolist() for p in range(ops.shape[1])]


@pytest.mark.parametrize("k,T", [(1, 64), (3, 100)])
def test_segment_walk_matches_xla_walk_segment(mg94_table, k, T):
    """The segment walk over the reference's own segments, last to first:
    (i, j, st) of every pair equal _walk_segment's after each segment, and so
    do the op sequences; each pair's s counts its own ops."""
    aseq, bseq, la, lb = _group(330 + k, k, n_codes=4)
    gc = gap_consts_array(GapParams(len=k))
    ref = _jax_segments(aseq, bseq, la, lb, mg94_table, gc, k, T, "viterbi")
    adj = ref[-1][1]
    B = aseq.shape[0]
    Dtot = aseq.shape[1] + bseq.shape[1] + 2 * k - 1

    st = jax_longseq._argmax_mdi(*[jnp.asarray(c) for c in adj]).astype(jnp.int32)
    i = jnp.asarray(la) + jnp.int32(k - 1)
    j = jnp.asarray(lb) + jnp.int32(k - 1)
    s_steps = jnp.int32(0)
    ops = jnp.full((Dtot, B), -1, dtype=jnp.int8)

    t_la, t_lb = _torch(la, lb)
    t_adj = torch.from_numpy(np.stack(adj))
    state, score = tw.walk_init_plain(t_adj, t_la, t_lb, k=k)
    np.testing.assert_array_equal(state.numpy(), np.stack(
        [np.asarray(i), np.asarray(j), np.asarray(st), np.zeros(B, np.int32)]))
    # the first call starts every walk at its corner, whatever state holds
    state = torch.full((4, B), 7, dtype=torch.int32)
    t_ops = torch.full((Dtot, B), -1, dtype=torch.int8)

    top = len(ref) - 1
    for seg in range(top, -1, -1):
        bp_x = ref[seg][2]
        i, j, st, s_steps, ops = jax_longseq._walk_segment(
            jnp.asarray(bp_x), jnp.int32(seg * T), i, j, st, s_steps, ops, k=k)
        bp_t = torch.from_numpy(np.ascontiguousarray(np.transpose(bp_x, (1, 0, 2))))
        state, t_ops, score = walk_mod.walk_segment(
            bp_t, seg * T, state, t_ops, k=k,
            start=(t_adj, t_la, t_lb) if seg == top else None)
        if seg == top:
            np.testing.assert_array_equal(
                score.numpy(), np.maximum(adj[0], np.maximum(adj[1], adj[2])))
        else:
            assert score is None
        np.testing.assert_array_equal(state[:3].numpy(), np.stack(
            [np.asarray(i), np.asarray(j), np.asarray(st)]))
        lists = _ops_lists(t_ops)
        assert lists == _ops_lists(ops)
        assert state[3].tolist() == [len(x) for x in lists]
    assert state[0].tolist() == [k - 1] * B and state[1].tolist() == [k - 1] * B


@pytest.mark.parametrize("k,sizes,seg,band", [
    (1, (60,), 64, 40), (1, (50, 60, 40), 77, 7), (1, (20,), 64, 1),
    (1, (50, 60, 40), 77, None), (3, (60,), 100, 21), (3, (50, 60, 40), 64, 6),
    (3, (20, 16), 64, 3), (9, (30,), 64, None), (9, (24, 30), 77, None)])
def test_long_batch_matches_xla_long_path_and_full_bp(mg94_table, monkeypatch,
                                                      k, sizes, seg, band):
    """The port's long path against the reference's (XLA:CPU, in segments
    of `seg` diagonals) and against the full-bp path: up to MAX_K in bands
    of `band` rows (a budget of the group's band of that height; None: the
    default budget, one band here), above it (k = 9) in segments of
    diagonals, the route that stays there."""
    from coati_tpu_torch.kernels.wavefront_fill import row_stride

    enc_as, enc_bs, astrs, bstrs = _pairs(50 + k + len(sizes), sizes, k)
    gap = GapParams(len=k)
    if band is not None:
        Cp = row_stride(max(len(b) for b in enc_bs) + k)
        monkeypatch.setattr(torch_longseq, "BP_BUDGET_BYTES", len(sizes) * Cp * band)
        assert torch_longseq.band_rows_for(len(sizes), Cp, k) == band // k * k
    want = jax_longseq._viterbi_align_long_xla(
        enc_as, enc_bs, astrs, bstrs, mg94_table, gap, seg_diagonals=seg, quantum=64)
    got = torch_longseq.viterbi_align_long_batch(
        enc_as, enc_bs, astrs, bstrs, mg94_table, gap, seg_diagonals=seg,
        device="cpu")
    _assert_same(want, got)
    full = torch_engine.viterbi_align_batch(enc_as, enc_bs, astrs, bstrs,
                                            mg94_table, gap, device="cpu")
    _assert_same(full, got)
    for r, a, b in zip(got, astrs, bstrs):
        assert r.seq0.replace("-", "") == a and r.seq1.replace("-", "") == b
    # the segment length does not change the result; neither does the budget
    one = torch_longseq.viterbi_align_long(
        enc_as[0], enc_bs[0], astrs[0], bstrs[0], mg94_table, gap, device="cpu")
    _assert_same([one], got[:1])


@pytest.mark.parametrize("seed,sizes,unrelated", [
    (61, (70, 90, 40), False), (62, (50,), False), (63, (30, 45, 12), True)])
def test_path_score_sums_the_long_paths_own_path(mg94_table, monkeypatch, seed,
                                                 sizes, unrelated):
    """chip_smoke.path_score, which holds the 160,002 nt alignment on the
    card to its score: summed along each pair's own path the way the fill
    sums it, the long path's alignments (in bands of a few rows, k = 1) give
    their scores bit for bit, which are the JAX long path's; unrelated pairs
    start and end with gap runs down the matrix's margins. A path cut short
    is refused."""
    from chip_smoke import path_score
    from coati_tpu_torch.kernels.wavefront_fill import row_stride

    enc_as, enc_bs, astrs, bstrs = _pairs(seed, sizes, 1)
    if unrelated:
        rng = random.Random(seed)
        bstrs = ["".join(rng.choice("ACGT") for _ in range(rng.randint(5, 4 * n)))
                 for n in sizes]
        enc = [encode_marginal(a, b) for a, b in zip(astrs, bstrs)]
        enc_as, enc_bs = [e[0] for e in enc], [e[1] for e in enc]
    gap = GapParams()
    Cp = row_stride(max(len(b) for b in enc_bs) + 1)
    monkeypatch.setattr(torch_longseq, "BP_BUDGET_BYTES", len(sizes) * Cp * 17)
    got = torch_longseq.viterbi_align_long_batch(enc_as, enc_bs, astrs, bstrs,
                                                 mg94_table, gap, device="cpu")
    want = jax_longseq._viterbi_align_long_xla(enc_as, enc_bs, astrs, bstrs,
                                               mg94_table, gap, seg_diagonals=64,
                                               quantum=64)
    _assert_same(want, got)
    gc = gap_consts_array(gap)
    for ea, eb, r in zip(enc_as, enc_bs, got):
        assert path_score(ea, eb, r.seq0, r.seq1, mg94_table, gc) == np.float32(r.score)
    if unrelated:
        assert any(r.seq0.startswith("-") or r.seq1.startswith("-") for r in got)
        assert any(r.seq0.endswith("-") or r.seq1.endswith("-") for r in got)
    with pytest.raises(AssertionError, match="corner"):
        path_score(enc_as[0], enc_bs[0], got[0].seq0[:-1], got[0].seq1[:-1],
                   mg94_table, gc)


def test_engine_routes_long_pairs(mg94_table, monkeypatch):
    """A mixed batch with long_slots=400: the routed result equals the
    unrouted one and the JAX engine's, in input order. The three long pairs
    go as one group through the rows path: one checkpointing pass, then a
    band fill and a band walk a band (a budget lowered to cut them into
    bands), and never the sweep."""
    from coati_tpu_torch.kernels import wavefront_fill as fill_mod

    enc_as, enc_bs, astrs, bstrs = _pairs(7, (150, 20, 140, 35, 170), 1)
    gap = GapParams()
    k = 1
    routed_idx = [i for i, b in enumerate(enc_bs)
                  if torch_longseq.is_long_pair(len(enc_as[i]), len(b), k, 400)]
    assert len(routed_idx) == 3
    assert not any(torch_longseq.is_long_pair(len(a), len(b), k)
                   for a, b in zip(enc_as, enc_bs))
    NA = max(len(enc_as[i]) for i in routed_idx)
    Cp = fill_mod.row_stride(max(len(enc_bs[i]) for i in routed_idx) + k)
    monkeypatch.setattr(torch_longseq, "BP_BUDGET_BYTES", 3 * Cp * 200)
    H = torch_longseq.band_rows_for(3, Cp, k)
    assert H == 200
    calls = {"ckpt": [], "band": [], "walk": [], "segment": []}

    def spy(name, fn):
        def counting(*args, **kw):
            calls[name].append(args[0].shape[0])
            return fn(*args, **kw)
        return counting

    for name, mod, attr in (("ckpt", score_mod, "wavefront_score_ckpt"),
                            ("band", fill_mod, "wavefront_fill_band"),
                            ("walk", walk_mod, "walk_band"),
                            ("segment", seg_mod, "wavefront_segment")):
        monkeypatch.setattr(mod, attr, spy(name, getattr(mod, attr)))
    routed = torch_engine.viterbi_align_batch(
        enc_as, enc_bs, astrs, bstrs, mg94_table, gap, quantum=64,
        long_slots=400, device="cpu")
    n_bands = -(-(NA + k) // H)
    assert n_bands >= 2
    assert calls == {"ckpt": [3], "band": [3] * n_bands, "walk": [3] * n_bands,
                     "segment": []}  # one group of the three
    plain = torch_engine.viterbi_align_batch(
        enc_as, enc_bs, astrs, bstrs, mg94_table, gap, quantum=64, device="cpu")
    _assert_same(plain, routed)
    want = jax_engine.viterbi_align_batch(
        enc_as, enc_bs, astrs, bstrs, mg94_table, gap, quantum=64, long_slots=400)
    _assert_same(want, routed)


def test_thresholds_come_from_bytes():
    """A pair is long when its backpointer stack, in the layout the port
    stores (the fill's rows up to MAX_K, the sweep's diagonals above),
    passes the budget; a group's band (segment) fits the budget; the group
    width keeps the checkpoints within theirs."""
    from coati_tpu_torch.kernels.wavefront_fill import MAX_K, row_stride

    budget = torch_longseq.BP_BUDGET_BYTES
    assert torch_longseq.bp_bytes(32000, 32000, 1) == 32001 * 32016
    assert torch_longseq.bp_bytes(32000, 32000, 9) == 64017 * 32009
    assert not torch_longseq.is_long_pair(1500, 1500, 1)
    assert not torch_longseq.is_long_pair(16000, 16000, 1)
    assert not torch_longseq.is_long_pair(29397, 29397, 1)  # 0.86 GB of rows
    assert not torch_longseq.is_long_pair(32001, 32001, 1)
    assert torch_longseq.is_long_pair(33000, 33000, 1)
    assert torch_longseq.is_long_pair(29397, 29397, MAX_K + 1)  # diagonals
    assert torch_longseq.is_long_pair(160002, 160002, 1)
    assert torch_longseq.is_long_pair(30, 500, 1, long_slots=400)
    assert not torch_longseq.is_long_pair(29397, 29397, 1, long_slots=10**9)
    for B, nb, k in ((1, 160002, 1), (4, 33000, 1), (8, 400, 3), (2, 50000, 8)):
        Cp = row_stride(nb + k)
        H = torch_longseq.band_rows_for(B, Cp, k)
        assert H % k == 0 and B * H * Cp <= budget < B * (H + k) * Cp
    assert torch_longseq.band_rows_for(1, 160016, 1) == 6710
    for B, C in ((1, 160003), (4, 32001), (8, 401)):
        T = torch_longseq.seg_diagonals_for(B, C)
        assert B * T * C <= budget < B * (T + 1) * C
    for nb in (400, 33000, 160002):
        w = torch_longseq.long_batch_width(nb, 1)
        assert 1 <= w <= torch_longseq.LONG_GROUP_MAX
        C = nb + 1
        Cp = row_stride(C)
        # a checkpoint a band below the first
        n_ckpt = -(-C // torch_longseq.band_rows_for(w, Cp, 1)) - 1
        assert n_ckpt * w * 3 * Cp * 4 <= torch_longseq.LONG_CKPT_BYTES
        if w < torch_longseq.LONG_GROUP_MAX:
            n_ckpt = -(-C // torch_longseq.band_rows_for(w + 1, Cp, 1)) - 1
            assert n_ckpt * (w + 1) * 3 * Cp * 4 > torch_longseq.LONG_CKPT_BYTES
    assert torch_longseq.long_batch_width(160002, 1) < torch_longseq.long_batch_width(33000, 1)
    w9 = torch_longseq.long_batch_width(32000, 9)
    n_seg = -(-2 * 32009 // torch_longseq.seg_diagonals_for(w9, 32009))
    assert n_seg * w9 * (9 * 3 * 32009 + 3) * 4 <= torch_longseq.LONG_CKPT_BYTES
    groups = torch_engine._long_groups(
        [0, 1, 2, 3], [[0] * 1000, [0] * 300, [0] * 990, [0] * 650],
        [[0] * 1000, [0] * 300, [0] * 990, [0] * 650], 1)
    assert groups == [[0, 2], [3], [1]]  # the 0.7 rule


def test_sweep_shape_spreads_long_pairs_over_the_sms(monkeypatch):
    """Several blocks a pair only above MULTI_BLOCK_SLOTS, never more blocks
    than SMs in all (the launch is cooperative), bands no narrower than
    BAND_MIN_COLUMNS, 512 threads while a band holds up to 1,024 columns;
    the launch takes the band route where it can, with no global ring."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    shape = functools.partial(seg_mod.sweep_shape, device="cuda")
    assert seg_mod.BAND_MIN_COLUMNS == 243
    assert shape(2048, 1057) == (1, 256)
    assert shape(3, seg_mod.MULTI_BLOCK_SLOTS) == (1, 1024)
    assert shape(1, 8001) == (33, 512)
    assert shape(4, 32001) == (33, 512)
    assert shape(1, 32001) == (132, 512)
    assert shape(1, 160003) == (132, 1024)
    assert shape(100, 32001) == (1, 1024)
    assert shape(500, 32001) == (1, 1024)
    for B in (1, 2, 5, 33, 67, 131, 132, 133):
        blocks, threads = shape(B, 50_000)
        assert blocks == 1 or B * blocks <= 132
    one = seg_mod.sweep_launch(2, 1057, 1, 1, 256)
    assert one.route == "shared" and one.buffers("cpu") == (None,) * 5
    wide = seg_mod.sweep_launch(2, 7001, 1, 1, 1024)
    ring, *rest = wide.buffers("cpu")
    assert wide.route == "global" and tuple(ring.shape) == (2, 3, 3, 7001)
    assert rest == [None] * 4
    bands = seg_mod.sweep_launch(4, 32001, 1, *shape(4, 32001))
    ring, sync, _, nxt, _ = bands.buffers("cpu")
    assert bands.route == "bands" and ring is None and sync is None
    assert bands.blocks == len(bands.plan.bands) == 33 and bands.plan.width == 970
    assert nxt.tolist() == [[0] * 33] * 4
    # a group too wide for a band's ring in shared memory stays at the barrier
    barrier = seg_mod.sweep_launch(33, 32001, 1, *shape(33, 32001))
    assert barrier.route == "barrier" and barrier.blocks == 4
    assert tuple(barrier.buffers("cpu")[1].shape) == (33,)


@pytest.mark.parametrize("k", [1, 3])
def test_segment_margins_pin_xla_fma_to_165000(mg94_table, k):
    """The margin rule in segment form: with the diagonal index d_start +
    step traced, XLA:CPU still contracts (ng+go) + ge*(i-1) into one FMA, out
    to i = 165,000; the float64-then-round margins equal its values, and the
    plain segment's ring equals _segment's there."""
    NA, NB, T = 165_000, 3, 2000
    gc = gap_consts_array(GapParams(len=k))
    ng, gs, go, ge = (torch.tensor(x) for x in gc)
    aseq = np.zeros((1, NA), np.int32)
    bseq = np.zeros((1, NB), np.int32)
    la, lb = np.array([NA], np.int32), np.array([NB], np.int32)
    C, K = NB + k, max(k, 2)
    lowest = np.float32(np.finfo(np.float32).min)
    ring0 = np.full((K, 3, 1, C), lowest, np.float32)
    corners0 = [np.full((1,), lowest, np.float32)] * 3
    jargs = [jnp.asarray(x) for x in (aseq, bseq, la, lb, mg94_table, gc)]
    run = jax.jit(functools.partial(
        wavefront_impl, k=k, semiring="tropical", mode="forward", n_steps=T,
        return_carry=True))
    differs = False
    for d0 in (0, 20_000, 163_500):
        _, (_, Ds, _), _ = run(*jargs, d_start=jnp.int32(d0),
                               ring_init=jnp.asarray(ring0),
                               corner_init=tuple(jnp.asarray(c) for c in corners0))
        i = d0 + np.arange(T) - (k - 1)  # row of slot k-1 on each diagonal
        ok = (i >= 2 * k - 1) & ((i - (k - 1)) % k == 0)
        got = tw.margin_values(ng + go, ge, torch.from_numpy(i[ok])).numpy()
        np.testing.assert_array_equal(np.asarray(Ds)[ok, 0, k - 1], got)
        unfused = (ng + go) + ge * (torch.from_numpy(i[ok]).float() - 1.0)
        differs |= bool((unfused.numpy() != got).any())

        _, _, (ring_x, _) = jax_longseq._segment(
            *jargs, jnp.asarray(ring0), tuple(jnp.asarray(c) for c in corners0),
            jnp.int32(d0), k=k, n_steps=T, mode="score")
        _, _, (ring_t, _) = seg_mod.wavefront_segment(
            *_torch(aseq, bseq, la, lb, mg94_table, gc),
            carry_from_numpy(ring0, corners0, "cpu"), d0, k=k, n_steps=T,
            want_bp=False)
        np.testing.assert_array_equal(ring_t.numpy(), np.asarray(ring_x))
    assert differs  # the rounding rule matters
    assert i[ok].max() >= 165_000


def test_segment_wrappers_on_cpu_launch_nothing_and_check_inputs(mg94_table):
    k = 1
    aseq, bseq, la, lb = _group(5, k, B=2, na=(12, 24), nb=(12, 24))
    gc = gap_consts_array(GapParams(len=k))
    args = _torch(aseq, bseq, la, lb, mg94_table, gc)
    B, C = 2, bseq.shape[1] + k
    seg_mod.LAUNCHES = score_mod.LAUNCHES = walk_mod.SEGMENT_LAUNCHES = 0
    carry = seg_mod.empty_carry(B, C, k, "cpu")
    adj, bp, out = seg_mod.wavefront_segment(*args, carry, 0, k=k, n_steps=20,
                                             want_bp=True)
    assert bp.shape == (B, 20, C) and out[0].shape == carry[0].shape
    assert seg_mod.wavefront_segment(*args, carry, 0, k=k, n_steps=20,
                                     want_bp=False, want_carry=False)[1:] == (None, None)
    score_mod.wavefront_score(*args, k=k)
    state = torch.empty((4, B), dtype=torch.int32)
    walk_mod.walk_segment(bp, 0, state, torch.full((40, B), -1, dtype=torch.int8),
                          k=k, start=(adj, args[2], args[3]))
    assert (seg_mod.LAUNCHES, score_mod.LAUNCHES, walk_mod.SEGMENT_LAUNCHES) == (0, 0, 0)
    with pytest.raises(ValueError, match="carry ring"):
        seg_mod.wavefront_segment(*args, (carry[0][:, :, :1], carry[1]), 0, k=k,
                                  n_steps=20, want_bp=False)
    with pytest.raises(ValueError, match="carry corners"):
        seg_mod.wavefront_segment(*args, (carry[0], carry[1].double()), 0, k=k,
                                  n_steps=20, want_bp=False)
    with pytest.raises(ValueError, match="n_steps"):
        seg_mod.wavefront_segment(*args, carry, 0, k=k, n_steps=0, want_bp=False)
    with pytest.raises(TypeError):
        score_mod.wavefront_score(args[0].long(), *args[1:], k=k)
    with pytest.raises(ValueError, match="state"):
        walk_mod.walk_segment(bp, 0, state[:3], torch.full((40, B), -1, dtype=torch.int8), k=k)
    with pytest.raises(ValueError, match="adj"):
        walk_mod.walk_segment(bp, 0, state, torch.full((40, B), -1, dtype=torch.int8),
                              k=k, start=(adj[:2], args[2], args[3]))
    with pytest.raises(ValueError, match="ring must be"):
        carry_from_numpy(np.zeros((2, 2, 1, 4), np.float32), [np.zeros(1)] * 3, "cpu")


@pytest.mark.parametrize("k,sizes,seg", [(1, (90, 120), 100), (3, (60, 90), 77)])
def test_long_batch_matches_the_native_engine(mg94_table, k, sizes, seg):
    """The segmented long-pair route against the port's native C++ engine
    (native.viterbi_align: its own fill and backpointer walk), the
    string-level truth where the Python oracle is too slow: alignments
    byte-equal; scores within 1e-6 of their magnitude, since the native
    margins are a product and a sum where the device's are one FMA."""
    from coati_tpu_torch import native
    from coati_tpu_torch.structs import GapParams as TorchGapParams

    enc_as, enc_bs, astrs, bstrs = _pairs(70 + k, sizes, k)
    gap = TorchGapParams(len=k)
    got = torch_longseq.viterbi_align_long_batch(
        enc_as, enc_bs, astrs, bstrs, mg94_table, gap, seg_diagonals=seg,
        device="cpu")
    for r, ea, eb, a, b in zip(got, enc_as, enc_bs, astrs, bstrs):
        s0, s1, score = native.viterbi_align(ea, eb, a, b, gap, mg94_table)
        assert (r.seq0, r.seq1) == (s0, s1)
        assert r.score == pytest.approx(score, rel=1e-6, abs=0)
        assert native.viterbi_score(ea, eb, mg94_table, gap) == \
            pytest.approx(r.score, rel=1e-6, abs=0)
