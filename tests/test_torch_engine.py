"""coati_tpu_torch's batch engine against coati_tpu's on the CPU.

Same pairs, same tables: aligned strings must be byte-equal and scores
bit-equal (f32), across several length buckets, at k=1 and k=3, with IUPAC
descendant codes and with a stacked table_idx table.
"""

import numpy as np
import pytest
import torch

from coati_tpu.align import engine as jax_engine
from coati_tpu.align.wavefront import gap_consts_array as jax_gap_consts
from coati_tpu.constants import CODONS61
from coati_tpu.models import marginal_p, mg94_p
from coati_tpu.structs import GapParams
from coati_tpu.utils import encode_marginal
from coati_tpu_torch.align import engine as torch_engine
from coati_tpu_torch.align import longseq
from coati_tpu_torch.params import params_from_numpy

PI = (0.308, 0.185, 0.199, 0.308)


@pytest.fixture(autouse=True)
def _one_jax_device(monkeypatch):
    """One CPU device for the JAX engine: fewer chunk shapes to compile,
    same results."""
    monkeypatch.setenv("COATI_TPU_MAX_DEVICES", "1")


def _pairs(seed, n, k, iupac=True):
    """n homologous pairs of 30-210 nt, descendants with point changes,
    IUPAC codes and indels; lengths kept multiples of 3 and k."""
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("ACGTRYMKSWBDHVN" if iupac else "ACGT"))
    out = []
    for _ in range(n):
        anc = "".join(rng.choice(CODONS61, size=int(rng.integers(10, 71))))
        des = np.array(list(anc))
        flip = rng.random(len(des)) < 0.08
        des[flip] = rng.choice(alphabet, size=int(flip.sum()))
        des = "".join(des)
        for _ in range(int(rng.integers(0, 3))):
            ln = k * int(rng.integers(1, 4))
            pos = int(rng.integers(0, len(des) - ln))
            if rng.random() < 0.5:
                des = des[:pos] + des[pos + ln:]
            else:
                des = des[:pos] + "".join(rng.choice(alphabet[:4], size=ln)) + des[pos:]
        des = des[: len(des) - len(des) % k]
        out.append((anc, des))
    return out


def _encode(pairs):
    enc = [encode_marginal(a, b) for a, b in pairs]
    return [e[0] for e in enc], [e[1] for e in enc]


def _assert_same(res_jax, res_torch):
    assert len(res_jax) == len(res_torch)
    for rj, rt in zip(res_jax, res_torch):
        assert (rj.seq0, rj.seq1) == (rt.seq0, rt.seq1)
        assert np.float32(rj.score) == np.float32(rt.score)
        assert rj.score == rt.score


@pytest.mark.parametrize("k", [1, 3])
def test_batch_matches_jax_engine(mg94_table, k):
    pairs = _pairs(10 + k, 24, k)
    enc_as, enc_bs = _encode(pairs)
    astrs = [a for a, _ in pairs]
    bstrs = [b for _, b in pairs]
    gap = GapParams(len=k)
    qa = {max(-(-len(a) // 96) * 96, 96) for a in enc_as}
    assert len(qa) >= 2  # several buckets
    res_jax = jax_engine.viterbi_align_batch(enc_as, enc_bs, astrs, bstrs,
                                             mg94_table, gap)
    res_torch = torch_engine.viterbi_align_batch(enc_as, enc_bs, astrs, bstrs,
                                                 mg94_table, gap, device="cpu")
    _assert_same(res_jax, res_torch)
    for (a, b), r in zip(pairs, res_torch):
        assert r.seq0.replace("-", "") == a and r.seq1.replace("-", "") == b


def test_batch_table_idx_matches_jax_engine():
    """Stacked [G, 183, 15] tables, one per branch length, as msa uses."""
    tables = np.stack([
        marginal_p(mg94_p(t, 0.2, PI), PI).astype(np.float32)
        for t in (0.0133, 0.05, 0.2)
    ])
    pairs = _pairs(21, 18, 1)
    enc_as, enc_bs = _encode(pairs)
    astrs = [a for a, _ in pairs]
    bstrs = [b for _, b in pairs]
    tidx = [i % 3 for i in range(len(pairs))]
    gap = GapParams()
    res_jax = jax_engine.viterbi_align_batch(
        enc_as, enc_bs, astrs, bstrs, tables, gap, table_idx=tidx)
    res_torch = torch_engine.viterbi_align_batch(
        enc_as, enc_bs, astrs, bstrs, tables, gap, table_idx=tidx, device="cpu")
    _assert_same(res_jax, res_torch)


def test_chunking_does_not_change_results(mg94_table):
    """Small max_batch_cells splits every bucket into many chunks."""
    pairs = _pairs(5, 10, 1, iupac=False)
    enc_as, enc_bs = _encode(pairs)
    astrs = [a for a, _ in pairs]
    bstrs = [b for _, b in pairs]
    gap = GapParams()
    whole = torch_engine.viterbi_align_batch(enc_as, enc_bs, astrs, bstrs,
                                             mg94_table, gap, device="cpu")
    split = torch_engine.viterbi_align_batch(enc_as, enc_bs, astrs, bstrs,
                                             mg94_table, gap, device="cpu",
                                             max_batch_cells=20_000)
    _assert_same(whole, split)


def test_single_matches_jax(mg94_table):
    anc, des = "CTCTGGATAGTG", "CTATAGTG"
    ea, eb = encode_marginal(anc, des)
    gap = GapParams()
    got = torch_engine.viterbi_align_single(ea, eb, anc, des, mg94_table, gap,
                                            device="cpu")
    want = jax_engine.viterbi_align_single(ea, eb, anc, des, mg94_table, gap)
    assert got == want
    assert got[1] == "CT----ATAGTG"


def _lower_budget(monkeypatch, enc_as, enc_bs):
    """Lower the backpointer budget so that a pair the CPU can take passes it."""
    biggest = max(longseq.bp_bytes(len(a), len(b), 1) for a, b in zip(enc_as, enc_bs))
    monkeypatch.setattr(longseq, "BP_BUDGET_BYTES", biggest // 3)
    assert any(longseq.is_long_pair(len(a), len(b), 1) for a, b in zip(enc_as, enc_bs))


def test_long_pairs_are_refused(mg94_table, monkeypatch):
    """Only where the device asked for is missing: a long pair for a CUDA
    device on a host without one raises, and is not aligned on the CPU
    instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pairs = _pairs(33, 3, 1, iupac=False)
    enc_as, enc_bs = _encode(pairs)
    _lower_budget(monkeypatch, enc_as, enc_bs)
    monkeypatch.setattr(longseq, "align_long_group",
                        lambda *a, **kw: pytest.fail("the long path ran"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_engine.viterbi_align_batch(
            enc_as, enc_bs, [a for a, _ in pairs], [b for _, b in pairs],
            mg94_table, GapParams(), device="cuda")


def test_long_pairs_take_the_segmented_path(mg94_table, monkeypatch):
    """A pair whose backpointer stack passes the budget is aligned in
    segments, with the result of the full-backpointer path."""
    pairs = _pairs(33, 3, 1, iupac=False)
    enc_as, enc_bs = _encode(pairs)
    astrs = [a for a, _ in pairs]
    bstrs = [b for _, b in pairs]
    whole = torch_engine.viterbi_align_batch(enc_as, enc_bs, astrs, bstrs,
                                             mg94_table, GapParams(), device="cpu")
    _lower_budget(monkeypatch, enc_as, enc_bs)
    calls = []
    real = longseq.align_long_group
    monkeypatch.setattr(longseq, "align_long_group",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    routed = torch_engine.viterbi_align_batch(enc_as, enc_bs, astrs, bstrs,
                                              mg94_table, GapParams(), device="cpu")
    assert calls
    _assert_same(whole, routed)


def test_params_from_numpy_round_trips(mg94_table):
    for k in (1, 3):
        gap = GapParams(len=k)
        p = params_from_numpy(mg94_table, gap, "cpu")
        assert p.k == k
        assert p.table.dtype == torch.float32 and tuple(p.table.shape) == (183, 15)
        np.testing.assert_array_equal(p.table.numpy(), mg94_table)
        np.testing.assert_array_equal(p.gap_consts.numpy(), jax_gap_consts(gap))
    stacked = np.stack([mg94_table, mg94_table * 2])
    p = params_from_numpy(stacked, GapParams(), "cpu")
    np.testing.assert_array_equal(p.table.numpy(), stacked.reshape(-1, 15))
    bad = mg94_table.copy()
    bad[3, 4] = -np.inf
    with pytest.raises(ValueError, match="non-finite"):
        params_from_numpy(bad, GapParams(), "cpu")


def test_alignment_params_resolve_the_jax_packages_table():
    import dataclasses

    from coati_tpu.structs import AlignmentParams
    from coati_tpu.utils import set_subst
    from coati_tpu_torch.params import alignment_params

    want = AlignmentParams()
    set_subst(want)
    got = alignment_params()
    assert dataclasses.asdict(got.gap) == dataclasses.asdict(want.gap)
    assert got.model == "mar-mg"
    np.testing.assert_array_equal(got.subst_matrix, want.subst_matrix)
    got = alignment_params("mar-mg", 0.05, 0.3, 0.002, 0.9, 3)
    assert dataclasses.asdict(got.gap) == dataclasses.asdict(
        GapParams(len=3, open=0.002, extend=0.9))
    np.testing.assert_array_equal(
        got.subst_matrix, marginal_p(mg94_p(0.05, 0.3, PI), PI).astype(np.float32))
    assert alignment_params("tri-mg").subst_matrix is None


@pytest.mark.parametrize("k", [1, 3])
def test_native_strings_equal_the_numpy_version(mg94_table, k):
    """ops_to_strings goes through the port's native library, as the JAX
    package's does through its own; ops_to_strings_plain is the numpy
    version it is held to, on random op streams with -1 padding and on the
    engine's own walks."""
    rng = np.random.default_rng(90 + k)
    a_strs, b_strs, cols = [], [], []
    for _ in range(12):
        ops = rng.choice([0, 0, 0, 1, 2], size=int(rng.integers(0, 60)))
        na = int((ops == 0).sum() + k * (ops == 1).sum())
        nb = int((ops == 0).sum() + k * (ops == 2).sum())
        a_strs.append("".join(rng.choice(list("ACGT"), size=na)))
        b_strs.append("".join(rng.choice(list("ACGTN"), size=nb)))
        cols.append(ops)
    steps = max(len(c) for c in cols) + 3
    ops_fwd = np.full((steps, len(cols)), -1, np.int8)
    for p, c in enumerate(cols):
        ops_fwd[steps - len(c):, p] = c  # leading -1, as a reversed walk has
    score = rng.normal(size=len(cols)).astype(np.float32)
    got = torch_engine.ops_to_strings(ops_fwd, score, a_strs, b_strs, k)
    want = torch_engine.ops_to_strings_plain(ops_fwd, score, a_strs, b_strs, k)
    assert got == want and len(got) == 12
    _assert_same(jax_engine.ops_to_strings(ops_fwd, score, a_strs, b_strs, k), got)
    for r, a, b in zip(got, a_strs, b_strs):
        assert r.seq0.replace("-", "") == a and r.seq1.replace("-", "") == b

    pairs = _pairs(31 + k, 8, k)
    enc_as, enc_bs = _encode(pairs)
    gap = GapParams(len=k)
    astrs, bstrs = [a for a, _ in pairs], [b for _, b in pairs]
    native_res = torch_engine.viterbi_align_batch(enc_as, enc_bs, astrs, bstrs,
                                                  mg94_table, gap, device="cpu")
    calls = []

    def plain_spy(*args):
        calls.append(1)
        return torch_engine.ops_to_strings_plain(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_engine, "ops_to_strings", plain_spy)
        plain_res = torch_engine.viterbi_align_batch(
            enc_as, enc_bs, astrs, bstrs, mg94_table, gap, device="cpu")
    assert calls and native_res == plain_res
