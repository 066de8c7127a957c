"""coati_tpu_torch's sampling path against the JAX package on the CPU.

The same numpy inputs go through coati_tpu (XLA:CPU, and the Pallas Forward
kernel in interpret mode) and through coati_tpu_torch's plain versions.

Tolerances. The Forward's sums are lse, built from exp and log1p, which
differ in the last place between XLA:CPU and torch on the CPU; the
differences add up along a path of na + nb cells. So Forward values are held
to FWD_RTOL of their magnitude plus FWD_ATOL (the JAX package's own tests
hold its Pallas kernel to atol = 1e-4 at 24 x 21 nt; values there are below
100, so this is tighter). The walk is compared on the SAME matrices and the
SAME uniforms: op streams must be equal, scores agree to SCORE_ATOL (a sum
of na + nb log probabilities, each off by an ulp of exp or log).
"""

import json
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coati_tpu import native as jnative
from coati_tpu import utils as jutils
from coati_tpu.align import sample_device as jsd
from coati_tpu.align.wavefront import gap_consts_array, wavefront
from coati_tpu.kernels.wavefront_pallas import wavefront_pallas
from coati_tpu.rng import Lehmer64 as JLehmer64
from coati_tpu.structs import AlignmentParams as JAlignmentParams
from coati_tpu.structs import GapParams as JGapParams
from coati_tpu_torch import driver as tdriver
from coati_tpu_torch import native as tnative
from coati_tpu_torch import params as tparams
from coati_tpu_torch import utils as tutils
from coati_tpu_torch.align import oracle as toracle
from coati_tpu_torch.align import sample_device as tsd
from coati_tpu_torch.align import wavefront as tw
from coati_tpu_torch.kernels import sample_walk as walk_mod
from coati_tpu_torch.kernels import wavefront_forward as fwd_mod
from coati_tpu_torch.rng import Lehmer64 as TLehmer64
from coati_tpu_torch.structs import GapParams as TGapParams

FWD_RTOL = 2e-6  # of a value's magnitude: a few f32 ulps
FWD_ATOL = 2e-5
SCORE_ATOL = 1e-4


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def _ragged(seed, k, B, na, nb):
    """Ragged batch, ancestor codes < 183, descendant codes all 15 columns."""
    rng = np.random.default_rng(seed)
    la = rng.integers(na[0] // (3 * k), na[1] // (3 * k) + 1, B) * 3 * k
    lb = rng.integers(nb[0] // k, nb[1] // k + 1, B) * k
    aseq = np.zeros((B, int(la.max())), np.int32)
    bseq = np.zeros((B, int(lb.max())), np.int32)
    for p in range(B):
        aseq[p, : la[p]] = rng.integers(0, 183, la[p])
        bseq[p, : lb[p]] = rng.integers(0, 15, lb[p])
    return aseq, bseq, la.astype(np.int32), lb.astype(np.int32)


def _assert_forward_close(want, got, what):
    """Largest absolute and relative difference, held to the tolerance."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    live = want > -1e30  # LOWEST cells must be LOWEST on both sides
    np.testing.assert_array_equal(live, got > -1e30, err_msg=what)
    diff = np.abs(want - got)[live]
    bound = FWD_ATOL + FWD_RTOL * np.abs(want[live])
    worst = int(np.argmax(diff - bound))
    assert (diff <= bound).all(), (
        f"{what}: |diff| {diff[worst]:.3e} at value {want[live][worst]:.6g} "
        f"(max abs {diff.max():.3e}, max rel "
        f"{(diff / np.maximum(np.abs(want[live]), 1e-30)).max():.3e})")


def _rows_from_diagonals(S, R, C):
    """[Dtot, B, C] diagonal layout -> [B, R, C] row layout."""
    S = np.asarray(S)
    ii = np.arange(R)[:, None]
    jj = np.arange(C)[None, :]
    return np.transpose(S[ii + jj, :, jj], (2, 0, 1))


@pytest.mark.parametrize("k", [1, 3])
def test_plain_forward_matches_xla(mg94_table, k):
    """Corners and every M/D/I value of each pair's true rectangle, margins
    included; the plain version keeps the reference's padded slots too."""
    aseq, bseq, la, lb = _ragged(40 + k, k, 6, (30, 150), (30, 150))
    gc = gap_consts_array(JGapParams(len=k))
    corners, (Ms, Ds, Is) = wavefront(
        *[jnp.asarray(x) for x in (aseq, bseq, la, lb, mg94_table, gc)],
        k=k, semiring="log", mode="forward")
    adj, mdi = fwd_mod.wavefront_forward(
        *_torch(aseq, bseq, la, lb, mg94_table, gc), k=k)
    assert tuple(adj.shape) == (3, len(la))
    for s in range(3):
        _assert_forward_close(corners[s], adj[s].numpy(), f"corner {s}")
    B, R, C, _ = mdi.shape
    assert (R, C) == (aseq.shape[1] + k, bseq.shape[1] + k)
    for s, S in enumerate((Ms, Ds, Is)):
        want = _rows_from_diagonals(S, R, C)
        _assert_forward_close(want, mdi[..., s].numpy(), f"plane {s}")
        for p in range(B):  # the true rectangle holds live values
            assert np.isfinite(want[p, : la[p] + k, : lb[p] + k]).all()


@pytest.mark.parametrize("k", [1, 3])
def test_plain_forward_matches_pallas_interpret(mg94_table, k):
    """Against the TPU kernel itself, in interpret mode, at the size its
    own test uses."""
    rng = np.random.default_rng(5 + k)
    B, NA, NB = 8, 24, 21
    gc = gap_consts_array(JGapParams(len=k))
    aseq = rng.integers(0, 183, (B, NA)).astype(np.int32)
    bseq = rng.integers(0, 15, (B, NB)).astype(np.int32)
    la = np.full(B, NA, np.int32)
    lb = np.full(B, NB, np.int32)
    corners, (Ms, Ds, Is) = wavefront_pallas(
        *[jnp.asarray(x) for x in (aseq, bseq, la, lb, mg94_table, gc)],
        k=k, bc=8, mode="forward", interpret=True)
    adj, mdi = fwd_mod.wavefront_forward(
        *_torch(aseq, bseq, la, lb, mg94_table, gc), k=k)
    for s in range(3):
        _assert_forward_close(corners[s], adj[s].numpy(), f"corner {s}")
    R, C = NA + k, NB + k
    for s, S in enumerate((Ms, Ds, Is)):
        want = _rows_from_diagonals(np.asarray(S)[: R + C - 1, :, :C], R, C)
        _assert_forward_close(want, mdi[..., s].numpy(), f"plane {s}")


def test_lse_keeps_the_piecewise_form():
    """exp below the -16 threshold, log1p(exp) above, LOWEST stays LOWEST."""
    a = torch.tensor([0.0, 0.0, -3.0, tw.LOWEST, tw.LOWEST, 5.0])
    b = torch.tensor([-16.0, -15.999, -3.0, tw.LOWEST, -2.0, -40.0])
    got = tw.lse(a, b).numpy()
    y = -np.abs(a.numpy() - b.numpy())
    want = np.maximum(a.numpy(), b.numpy()) + np.where(
        y <= -16, np.exp(y), np.log1p(np.exp(np.minimum(y, 0)))).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[3] == np.float32(tw.LOWEST) and got[4] == np.float32(-2.0)
    from coati_tpu.align.wavefront import _lse

    np.testing.assert_allclose(got, np.asarray(_lse(a.numpy(), b.numpy())),
                               rtol=1e-6)


def _pair(seed, k, na, nb):
    rng = np.random.default_rng(seed)
    enc_a = rng.integers(0, 183, na).astype(np.int32)
    enc_b = rng.integers(0, 15, nb).astype(np.int32)
    return enc_a, enc_b


def _jax_forward(enc_a, enc_b, table, gc, k):
    corners, (Ms, Ds, Is) = wavefront(
        jnp.asarray(enc_a[None]), jnp.asarray(enc_b[None]),
        jnp.asarray([len(enc_a)], jnp.int32), jnp.asarray([len(enc_b)], jnp.int32),
        jnp.asarray(table), jnp.asarray(gc), k=k, semiring="log", mode="forward")
    return ([np.asarray(S)[:, 0, :] for S in (Ms, Ds, Is)],
            tuple(float(c[0]) for c in corners))


def _jax_uniforms(key, n_steps, N):
    """The uniforms _sample_paths draws from `key`, by its own calls."""
    key, k0 = jax.random.split(key)
    rows = [jax.random.uniform(k0, (N,), jnp.float32)]
    for kt in jax.random.split(key, n_steps):
        rows.append(jax.random.uniform(kt, (N,), jnp.float32))
    return np.stack([np.asarray(r) for r in rows])


@pytest.mark.parametrize("k,na,nb,N", [(1, 60, 47, 37), (3, 72, 57, 53),
                                       (1, 9, 120, 11), (1, 150, 6, 11)])
def test_plain_walk_matches_xla_on_its_matrices_and_uniforms(mg94_table, k, na,
                                                            nb, N):
    enc_a, enc_b = _pair(7 * k + na, k, na, nb)
    gc = gap_consts_array(JGapParams(len=k))
    (Ms, Ds, Is), corners = _jax_forward(enc_a, enc_b, mg94_table, gc, k)
    R, Cc = na + k, nb + k
    d = R + Cc - 2
    # the adjusted corner goes into the matrices, as sample_batch_device does
    Ms, Ds, Is = (S.copy() for S in (Ms, Ds, Is))
    Ms[d, Cc - 1], Ds[d, Cc - 1], Is[d, Cc - 1] = corners
    n_steps = (R - k) + (Cc - k)
    key = jax.random.PRNGKey(1234 + k)
    ops_x, score_x = jsd._sample_paths(
        jnp.asarray(Ms), jnp.asarray(Ds), jnp.asarray(Is), jnp.asarray(enc_a),
        jnp.asarray(enc_b), jnp.asarray(mg94_table), jnp.asarray(gc), key,
        k=k, n_steps=n_steps, n_samples=N, R=R, Cc=Cc)
    uniforms = _jax_uniforms(key, n_steps, N)

    mdi, adj = tparams.forward_from_numpy(Ms, Ds, Is, corners, R, Cc, "cpu")
    np.testing.assert_array_equal(adj.numpy(), np.array(corners, np.float32))
    np.testing.assert_array_equal(mdi[R - 1, Cc - 1].numpy(), adj.numpy())
    ops_t, score_t = walk_mod.sample_walk(
        mdi, *_torch(enc_a, enc_b, mg94_table, gc, uniforms), k=k)
    assert ops_t.dtype == torch.int8 and tuple(ops_t.shape) == (n_steps, N)
    np.testing.assert_array_equal(np.asarray(ops_x), ops_t.numpy())
    assert (np.asarray(ops_x) >= 0).sum() > 0
    np.testing.assert_allclose(np.asarray(score_x), score_t.numpy(),
                               rtol=0, atol=SCORE_ATOL)
    # and back: the port's layout round-trips to the reference's
    Mb, Db, Ib, cb = tparams.forward_to_numpy(mdi, adj)
    live = Ms > -1e30
    np.testing.assert_array_equal(Mb[live], Ms[live])
    np.testing.assert_array_equal(Ib[Is > -1e30], Is[Is > -1e30])
    assert cb == pytest.approx(corners)


def test_sample_walk_refuses_wrong_shapes(mg94_table):
    enc_a, enc_b = _pair(3, 1, 6, 5)
    gc = gap_consts_array(JGapParams())
    mdi = torch.zeros((7, 6, 3))
    good = _torch(enc_a, enc_b, mg94_table, gc, np.zeros((12, 4), np.float32))
    walk_mod.sample_walk(mdi, *good, k=1)
    with pytest.raises(ValueError, match="uniforms"):
        walk_mod.sample_walk(mdi, *good[:4], torch.zeros((11, 4)), k=1)
    with pytest.raises(ValueError, match="enc_a"):
        walk_mod.sample_walk(mdi, good[0][:5].contiguous(), *good[1:], k=1)
    with pytest.raises(TypeError, match="uniforms"):
        walk_mod.sample_walk(mdi, *good[:4], torch.zeros((12, 4)).double(), k=1)


def _codons(rng, n):
    """n random sense codons: an ancestor without early stops."""
    from coati_tpu_torch.constants import CODONS61

    return "".join(rng.choice(np.array(CODONS61), size=n))


def _aln(pkg_utils, cls, k=1):
    aln = cls()
    aln.model = "mar-mg"
    aln.gap.len = k
    pkg_utils.set_subst(aln)
    return aln


def _taln(k=1):
    from coati_tpu_torch.structs import AlignmentParams

    return _aln(tutils, AlignmentParams, k)


def test_sample_batch_device_matches_host_distribution():
    """As tests/test_sample.py does for the JAX sampler: same path -> score
    within 1e-3, path frequencies within 0.04 at N = 2,000, against the
    port's oracle walking the port's matrices on a Lehmer64 stream."""
    aln = _taln()
    anc, des = "CTCTGGATAGTG", "CTATAGTG"
    enc_a, enc_b = tutils.encode_marginal(anc, des)
    N = 2000
    mdi, corners = tdriver._forward_diag(enc_a, enc_b, aln, torch.device("cpu"))
    dev = list(tsd.sample_batch_device(mdi, corners, enc_a, enc_b,
                                       aln.subst_matrix, anc, des, aln.gap,
                                       42, N))
    assert len(dev) == N
    M, D, I = tdriver._forward_mdi(enc_a, enc_b, aln, device="cpu")
    rng = TLehmer64()
    host = [toracle.sampleback_mdi(M, D, I, enc_a, enc_b, aln.subst_matrix,
                                   anc, des, aln.gap, rng) for _ in range(N)]
    host_score = {(s0, s1): sc for s0, s1, sc in host}
    for s0, s1, sc in dev:
        assert len(s0) == len(s1)
        assert s0.replace("-", "") == anc and s1.replace("-", "") == des
        hs = host_score.get((s0, s1))
        if hs is not None:
            assert sc == pytest.approx(hs, abs=1e-3)
    cd = Counter((s0, s1) for s0, s1, _ in dev)
    ch = Counter((s0, s1) for s0, s1, _ in host)
    for key in set(cd) | set(ch):
        assert abs(cd.get(key, 0) - ch.get(key, 0)) / N < 0.04


def test_forward_mdi_matches_the_jax_package():
    from coati_tpu.driver import _forward_mdi as j_forward_mdi

    anc, des = "CTCTGGATAGTGAAATTT", "CTATAGTGAACTT"
    jaln = _aln(jutils, JAlignmentParams)
    taln = _taln()
    M, D, I = j_forward_mdi(*jutils.encode_marginal(anc, des), jaln)
    Mt, Dt, It = tdriver._forward_mdi(*tutils.encode_marginal(anc, des), taln,
                                      device="cpu")
    for want, got, name in ((M, Mt, "M"), (D, Dt, "D"), (I, It, "I")):
        _assert_forward_close(want, got, name)


def test_sample_batch_device_deterministic_and_chunked():
    aln = _taln()
    anc, des = "CCCCCC", "CCCCCCCC"
    enc_a, enc_b = tutils.encode_marginal(anc, des)
    mdi, corners = tdriver._forward_diag(enc_a, enc_b, aln, torch.device("cpu"))

    def run(n, chunk):
        return list(tsd.sample_batch_device(
            mdi, corners, enc_a, enc_b, aln.subst_matrix, anc, des, aln.gap,
            7, n, chunk=chunk))

    a = run(60, 4096)
    assert a == run(60, 4096)  # same seed -> same stream, scores too
    c = run(60, 25)
    assert len(c) == 60
    assert c == run(60, 25)
    for s0, s1, _ in c:
        assert s0.replace("-", "") == anc and s1.replace("-", "") == des


def test_decode_sample_ops_equals_the_native_strings_and_the_jax_decoder():
    rng = np.random.default_rng(11)
    for k in (1, 3):
        a = "".join(rng.choice(list("ACGT"), 12 * k))
        b = "".join(rng.choice(list("ACGT"), 9 * k))
        # a walk that consumes both: 6k matches, deletes and inserts between
        ops_fwd = [0] * (3 * k) + [1] * ((12 * k - 6 * k) // k) + [0] * (3 * k) \
            + [2] * ((9 * k - 6 * k) // k)
        col = np.full(len(ops_fwd) + 5, -1, np.int8)
        col[: len(ops_fwd)] = ops_fwd[::-1]  # walk order, -1 after the end
        got = tsd.decode_sample_ops(col, a, b, k)
        assert got == jsd.decode_sample_ops(col, a, b, k)
        assert got == tnative.ops_to_strings_native(col[::-1, None], [a], [b], k)[0]
        assert got[0].replace("-", "") == a and got[1].replace("-", "") == b
    assert tsd.decode_sample_ops(np.full(4, -1, np.int8), "", "", 1) == ("", "")


def test_native_sampleback_stream_exact_vs_oracle():
    """The port's library, built without FMA contraction, consumes the same
    Lehmer64 f24 stream as the port's oracle and gives every path."""
    aln = _taln()
    anc, des = "CTCTGGATAGTG", "CTATAGTG"
    enc_a, enc_b = tutils.encode_marginal(anc, des)
    N = 500
    rng_n = TLehmer64()
    nat = tnative.sampleback_batch(enc_a, enc_b, aln.subst_matrix, aln.gap,
                                   anc, des, N, rng_n)
    work = toracle.forward_oracle(enc_a, enc_b, aln.subst_matrix, aln.gap,
                                  "log", save_edges=False)
    M, D, I = (np.array(x, np.float32) for x in (work.mch, work.del_, work.ins))
    rng_o = TLehmer64()
    host = [toracle.sampleback_mdi(M, D, I, enc_a, enc_b, aln.subst_matrix,
                                   anc, des, aln.gap, rng_o) for _ in range(N)]
    assert rng_n.state == rng_o.state
    for (n0, n1, ns), (h0, h1, hs) in zip(nat, host):
        assert (n0, n1) == (h0, h1)
        assert ns == pytest.approx(hs, abs=1e-5)


@pytest.mark.parametrize("k,seed", [(1, 3), (1, 4), (3, 5)])
def test_native_equals_the_jax_packages_library(mg94_table, k, seed):
    """Same inputs and seeds through the port's build of pairhmm.cc and the
    JAX package's checked-in binary: alignments and sampled paths byte-equal,
    the same draws consumed. The checked-in binary was compiled with FMA
    contraction (-march=native), the port's without, so f32 values may differ
    in the last places: scores are held to 1e-6 of their magnitude, sampled
    path scores to 2e-5, and backpointer bytes may differ where two
    candidates are within an ulp (they must walk to the same alignment)."""
    rng = np.random.default_rng(seed)
    anc = _codons(rng, 20 * k)
    des = "".join(rng.choice(np.array(list("ACGT")), 17 * 3 * k))
    jg, tg = JGapParams(len=k), TGapParams(len=k)
    ja, jb = jutils.encode_marginal(anc, des)
    ta, tb = tutils.encode_marginal(anc, des)
    np.testing.assert_array_equal(ja, ta)
    assert tnative.available()
    for fn in ("viterbi_score", "forward_score"):
        want = getattr(jnative, fn)(ja, jb, mg94_table, jg)
        assert getattr(tnative, fn)(ta, tb, mg94_table, tg) == \
            pytest.approx(want, rel=1e-6, abs=0)
    ts, tbp, tst = tnative.viterbi_bp(ta, tb, mg94_table, tg)
    js, jbp, jst = jnative.viterbi_bp(ja, jb, mg94_table, jg)
    assert tst == jst and ts == pytest.approx(js, rel=1e-6, abs=0)
    assert tbp.shape == jbp.shape and (tbp != jbp).mean() < 0.01
    t0, t1, tsc = tnative.viterbi_align(ta, tb, anc, des, tg, mg94_table)
    j0, j1, jsc = jnative.viterbi_align(ja, jb, anc, des, jg, mg94_table)
    assert (t0, t1) == (j0, j1) and tsc == pytest.approx(jsc, rel=1e-6, abs=0)
    assert tnative.sample_anchor(ta, tb, mg94_table, tg, 50, seed=9) == \
        pytest.approx(jnative.sample_anchor(ja, jb, mg94_table, jg, 50, seed=9),
                      rel=1e-6, abs=0)
    r1, r2 = TLehmer64(), JLehmer64()
    got = tnative.sampleback_batch(ta, tb, mg94_table, tg, anc, des, 40, r1)
    want = jnative.sampleback_batch(ja, jb, mg94_table, jg, anc, des, 40, r2)
    assert r1.state == r2.state
    assert [x[:2] for x in got] == [x[:2] for x in want]
    np.testing.assert_allclose([x[2] for x in got], [x[2] for x in want],
                               rtol=0, atol=2e-5)


def test_forward_corner_is_the_native_forward_score():
    """The largest adjusted corner of the Forward is native.forward_score,
    to the tolerance: the check chip_smoke.py makes at 9,999 nt."""
    aln = _taln()
    anc = _codons(np.random.default_rng(2), 100)
    des = anc[:100] + anc[109:]
    enc_a, enc_b = tutils.encode_marginal(anc, des)
    _, corners = tdriver._forward_diag(enc_a, enc_b, aln, torch.device("cpu"))
    want = tnative.forward_score(enc_a, enc_b, aln.subst_matrix, aln.gap)
    assert abs(max(corners) - want) <= FWD_ATOL + FWD_RTOL * abs(want)


def test_forward_budget_raises_memory_error(monkeypatch):
    aln = _taln()
    enc_a, enc_b = tutils.encode_marginal("CTCTGGATAGTG", "CTATAGTG")
    monkeypatch.setattr(tdriver, "FORWARD_BUDGET_BYTES", 1000)
    with pytest.raises(MemoryError, match=r"12 x 8 nt.*1,404 bytes.*1,000"):
        tdriver._forward_diag(enc_a, enc_b, aln, torch.device("cpu"))


def test_marg_sample_routes(tmp_path, monkeypatch):
    """At most native_cells cells: the native sampler; above: Forward and
    the sample walk. Both outputs are valid JSON arrays that ungap to the
    inputs."""
    from coati_tpu_torch.cli import _seeded_rng
    from coati_tpu_torch.structs import AlignmentParams

    anc, des = "CTCTGGATAGTGAAATTT", "CTATAGTGAACTT"
    inp = tmp_path / "p.fasta"
    inp.write_text(f">a\n{anc}\n>b\n{des}\n")
    calls = Counter()
    for mod, name in ((tnative, "sampleback_batch"), (tsd, "sample_batch_device")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    for cells, want in ((4_000_000, "sampleback_batch"), (10, "sample_batch_device")):
        aln = AlignmentParams()
        aln.data.path = str(inp)
        aln.output = str(tmp_path / f"{want}.json")
        before = calls[want]
        tdriver.marg_sample(aln, 6, _seeded_rng(["11"]), device="cpu",
                            native_cells=cells)
        assert calls[want] == before + 1
        arr = json.loads((tmp_path / f"{want}.json").read_text())
        assert len(arr) == 6
        for rec in arr:
            s0, s1 = rec["alignment"].values()
            assert s0.replace("-", "") == anc and s1.replace("-", "") == des
            assert np.isfinite(rec["score"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdriver.marg_sample(AlignmentParams(), 1, _seeded_rng(["1"]))


def test_forward_shape_takes_blocks_of_512_threads(monkeypatch):
    """One block a pair up to MULTI_BLOCK_SLOTS slots; above, blocks of
    FORWARD_BLOCK_THREADS threads in bands of at least FORWARD_MIN_COLUMNS,
    as many as the card has SMs for the group, on the band route wherever
    band_plan takes the launch, as the Viterbi sweeps."""
    import types

    from coati_tpu_torch.kernels import wavefront_segment as seg_mod

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    assert fwd_mod.FORWARD_BLOCK_THREADS == 512
    assert fwd_mod.FORWARD_MIN_COLUMNS == 64
    assert fwd_mod.forward_shape(1, 1000, "cuda") == (1, 256)
    assert fwd_mod.forward_shape(1, seg_mod.MULTI_BLOCK_SLOTS, "cuda") == (1, 1024)
    assert fwd_mod.forward_shape(1, 10_000, "cuda") == (132, 512)
    assert fwd_mod.forward_shape(1, 29_398, "cuda") == (132, 512)
    assert fwd_mod.forward_shape(1, 160_003, "cuda") == (132, 512)
    assert fwd_mod.forward_shape(3, 6_565, "cuda") == (44, 512)
    assert fwd_mod.forward_shape(67, 6_600, "cuda") == (1, 1024)
    assert fwd_mod.forward_shape(500, 6_600, "cuda") == (1, 1024)
    assert seg_mod.sweep_shape(1, 10_000, "cuda") == (42, 512)
    launch = seg_mod.sweep_launch(1, 29_398, 1, *fwd_mod.forward_shape(1, 29_398, "cuda"))
    assert launch.route == "bands" and launch.plan.cells_a_thread == 1
    launch = seg_mod.sweep_launch(8, 29_398, 1, *fwd_mod.forward_shape(8, 29_398, "cuda"))
    assert launch.route == "bands" and launch.plan.cells_a_thread == 4
    assert fwd_mod.forward_bytes(29_397, 29_397, 1) == 12 * 29_398 ** 2
