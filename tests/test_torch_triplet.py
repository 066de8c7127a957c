"""The port's triplet engine against the JAX package's, on the CPU.

The same numpy or `random` seeded inputs go through coati_tpu's functions on
XLA:CPU (its Pallas kernels in interpret mode, on one case each) and through
coati_tpu_torch's plain versions. Tolerance: none. Boundary rows, argmax
lanes, walk state and op rows are compared with assert_array_equal, strings
with ==, scores as f32 with ==.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coati_tpu import triplet_hmm as jax_hmm
from coati_tpu import triplet_wavefront as jax_tw
from coati_tpu.constants import CODONS61, ECM_DNA_PI
from coati_tpu.structs import AlignmentParams as JaxAlignmentParams
from coati_tpu_torch import params as P
from coati_tpu_torch import triplet_hmm as torch_hmm
from coati_tpu_torch import triplet_wavefront as tw
from coati_tpu_torch.kernels import triplet_rows as rows_k
from coati_tpu_torch.kernels import triplet_walk as walk_k
from coati_tpu_torch.structs import AlignmentParams as TorchAlignmentParams

CPU = torch.device("cpu")


def models(name):
    """(the JAX package's TripletModel, the port's) for one model name, each
    from its own package's AlignmentParams."""
    out = []
    for params, hmm in ((JaxAlignmentParams, jax_hmm),
                        (TorchAlignmentParams, torch_hmm)):
        aln = params()
        aln.model = name
        if name == "tri-ecm":
            aln.pi = ECM_DNA_PI
        out.append(hmm.build_triplet_model(aln))
    return out


def ragged_pairs(seed, n, cods=(1, 12), nts=(1, 30), alphabet="ACGTN"):
    rng = random.Random(seed)
    pairs = [("CTCTGGATAGTG", "CTATAGTG")]  # the reference fixture
    for _ in range(n - 1):
        anc = "".join(rng.choice(CODONS61) for _ in range(rng.randint(*cods)))
        des = "".join(rng.choice(alphabet) for _ in range(rng.randint(*nts)))
        pairs.append((anc, des))
    return pairs


def homolog(rng, n_cod, subs=0.06, indels=4):
    """A random coding ancestor and a descendant with point changes and a
    few indels of 1-6 nt."""
    anc = "".join(rng.choice(CODONS61) for _ in range(n_cod))
    des = [rng.choice("ACGT") if rng.random() < subs else c for c in anc]
    des = "".join(des)
    for _ in range(indels):
        ln = rng.randint(1, 6)
        pos = rng.randint(0, max(0, len(des) - ln))
        if rng.random() < 0.5:
            des = des[:pos] + des[pos + ln:]
        else:
            des = des[:pos] + "".join(rng.choice("ACGT") for _ in range(ln)) + des[pos:]
    return anc, des


class Packed:
    """One batch packed by the JAX package, as jnp arrays and as the port's
    tensors made from the same numpy arrays."""

    def __init__(self, jax_model, pairs):
        enc = [jax_hmm.encode_triplet_pair(jax_model, a, d) for a, d in pairs]
        (self.anc_p, self.des_p, self.lens_t, self.lens_m, self.ins_off,
         self.jtables, self.n_cod) = jax_tw._pack_batch(
            jax_model, [e[0] for e in enc], [e[1] for e in enc])
        self.jargs = (jnp.asarray(self.anc_p), jnp.asarray(self.des_p),
                      jnp.asarray(self.ins_off))
        self.targs = tuple(torch.from_numpy(x.copy()) for x in
                           (self.anc_p, self.des_p, self.ins_off))
        self.lt, self.lm = (torch.from_numpy(x.copy())
                            for x in (self.lens_t, self.lens_m))
        self.ttables = P.triplet_tables_from_numpy(
            *(np.asarray(t) for t in self.jtables), CPU)
        self.B = len(pairs)


def jax_rows(pk):
    grid, amax = jax_tw._triplet_rows(*pk.jargs, *pk.jtables, n_cod=pk.n_cod)
    return np.asarray(grid), np.asarray(amax)


def torch_rows(pk):
    grid, amax = tw._triplet_rows(*pk.targs, pk.lt, pk.lm, *pk.ttables)
    return grid.numpy(), amax.numpy().astype(np.int32)


@pytest.mark.parametrize("name", ["tri-mg", "tri-ecm"])
def test_rows_plain_equal_the_xla_scan(name):
    """Boundary rows and argmax lanes of a ragged batch (16 pairs, 1-12
    codons, 1-30 nt with N): equal, tolerance 0. The port's own tables equal
    the JAX package's too."""
    jm, tm = models(name)
    pk = Packed(jm, ragged_pairs(5, 16))
    for got, want in zip(tw.triplet_tables(tm, CPU), pk.ttables):
        assert torch.equal(got, want)
    grid, amax = torch_rows(pk)
    want_grid, want_amax = jax_rows(pk)
    np.testing.assert_array_equal(grid, want_grid)
    np.testing.assert_array_equal(amax, want_amax)
    assert np.isfinite(grid).all()


def test_rows_plain_equal_the_pallas_kernel_interpreted():
    from coati_tpu.kernels.triplet_pallas import triplet_rows_pallas

    jm, _ = models("tri-mg")
    pk = Packed(jm, ragged_pairs(5, 16, cods=(1, 10), nts=(1, 25)))
    want_grid, want_amax = triplet_rows_pallas(
        *pk.jargs, *pk.jtables, n_cod=pk.n_cod, bc=4, interpret=True)
    grid, amax = torch_rows(pk)
    np.testing.assert_array_equal(grid, np.asarray(want_grid))
    np.testing.assert_array_equal(amax, np.asarray(want_amax))


@pytest.mark.parametrize("keep_grid", [True, False])
def test_rows_carry_form_equals_the_xla_scan(keep_grid):
    """From a checkpoint in the middle of the sweep, through the wrapper: the
    rows, the lanes and the carry out equal _triplet_rows_carry's when every
    pair is given every step, as the reference's scan runs them; given its
    own steps, a pair's carry out is the boundary after its last one."""
    jm, _ = models("tri-mg")
    pk = Packed(jm, ragged_pairs(9, 8, cods=(6, 12)))
    want_grid, _ = jax_rows(pk)
    t0 = 7
    S = pk.n_cod - t0
    ckpt = tuple(jnp.asarray(want_grid[t0, s]) for s in range(3))
    jb, ja, jc = jax_tw._triplet_rows_carry(
        pk.jargs[0][:, t0:], *pk.jargs[1:], *pk.jtables, ckpt, n_cod=S,
        keep_grid=keep_grid)
    carry = P.triplet_carry_from_numpy([np.asarray(c) for c in ckpt], CPU)
    args = (pk.targs[0][:, t0:].contiguous(), *pk.targs[1:])
    every = torch.full((pk.B,), S, dtype=torch.int32)
    tb, ta, tc = rows_k.triplet_rows(*args, every, pk.lm, *pk.ttables, carry,
                                     keep_grid=keep_grid)
    own = (pk.lt - t0).clamp(0, S).to(torch.int32)
    assert 0 in own.tolist() and S in own.tolist()
    _, _, to = rows_k.triplet_rows(*args, own, pk.lm, *pk.ttables, carry,
                                   keep_grid=keep_grid)
    last = np.maximum(pk.lens_t, t0)
    np.testing.assert_array_equal(
        to.numpy(), want_grid[last, :, np.arange(pk.B)].transpose(1, 0, 2))
    for got, want in zip(P.triplet_carry_to_numpy(tc), jc):
        np.testing.assert_array_equal(got, np.asarray(want))
    if keep_grid:
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(ta.numpy().astype(np.int32), np.asarray(ja))
        np.testing.assert_array_equal(tb.numpy(), want_grid[t0 + 1:])
    else:
        assert jb is None and tb is None and ta is None


def test_init_carry_and_terminal_equal_the_jax_package():
    jm, _ = models("tri-mg")
    pk = Packed(jm, ragged_pairs(3, 8))
    want = jax_tw.triplet_init_carry(pk.jargs[1], pk.jargs[2], pk.jtables[2])
    got = tw.triplet_init_carry(pk.targs[1], pk.targs[2], pk.ttables[2])
    for g, w in zip(P.triplet_carry_to_numpy(got), want):
        np.testing.assert_array_equal(g, np.asarray(w))
    grid, _ = jax_rows(pk)
    b = np.arange(pk.B)
    rows = [grid[pk.lens_t, s, b] for s in range(3)]
    jst, jsc = jax_tw.triplet_terminal(*(jnp.asarray(r) for r in rows),
                                       jnp.asarray(pk.lens_m), pk.jtables[2])
    tst, tsc = tw.triplet_terminal(*(torch.from_numpy(r) for r in rows),
                                   pk.lm, pk.ttables[2])
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))


WALK_PAIRS = [
    # a long insertion run, a deletion-heavy pair, insertions at both ends
    ("GCGACTGTTAGCAGC", "GCGACT" + "TTTTTGGGGGAAAAA" + "GTTAGCAGC"),
    ("GCGACTGTTAGCAGCAAATTT", "GCGTTT"),
    ("GCGACTGTT", "AAAAAAAGCGACTGTTCCCCC"),
    ("GCGACTGTTAGC", "GCGAGTCTTAAGC"),
]


def walk_inputs(seed=5, extra=6):
    jm, _ = models("tri-mg")
    rng = random.Random(seed)
    pairs = list(WALK_PAIRS)
    for _ in range(extra):
        anc = "".join(rng.choice(CODONS61) for _ in range(rng.randint(3, 13)))
        des = "".join(rng.choice("ACGT") for _ in range(rng.randint(2, 35)))
        pairs.append((anc, des))
    pk = Packed(jm, pairs)
    grid, amax = jax_rows(pk)
    b = np.arange(pk.B)
    st0, _ = jax_tw.triplet_terminal(
        *(jnp.asarray(grid[pk.lens_t, s, b]) for s in range(3)),
        jnp.asarray(pk.lens_m), pk.jtables[2])
    return pk, grid, amax, np.asarray(st0).astype(np.int32)


def jax_walk(pk, grid, amax, st0):
    state0 = (3 * jnp.asarray(pk.lens_t), jnp.asarray(pk.lens_m),
              jnp.asarray(st0), jnp.zeros((6 * pk.n_cod, pk.B), jnp.int32))
    return state0, jax_tw._triplet_walk_seg_xla(
        jnp.asarray(grid[:-1]), jnp.asarray(amax[1:]), *pk.jargs,
        jnp.int32(0), state0, *pk.jtables, S=pk.n_cod)


def torch_walk_inputs(pk, grid, amax, st0):
    state = P.triplet_state_from_numpy(3 * pk.lens_t, pk.lens_m, st0, CPU)
    ops = torch.zeros((6 * pk.n_cod, pk.B), dtype=torch.int32)
    return (torch.from_numpy(grid.copy()),
            torch.from_numpy(amax.astype(np.uint8)), state, ops)


def test_walk_plain_equals_the_xla_walk_and_the_pallas_kernel():
    """(i, j, st) and every op row, over insertion runs, deletions,
    insertions at both ends and ragged lengths (n_cod is no multiple of the
    reference's group of 8): equal to the XLA walk, and to the Pallas walk
    in interpret mode."""
    from coati_tpu.kernels.triplet_pallas import triplet_walk_pallas

    pk, grid, amax, st0 = walk_inputs()
    assert pk.n_cod % 8 != 0
    state0, (xi, xj, xst, xops) = jax_walk(pk, grid, amax, st0)
    g, a, state, ops = torch_walk_inputs(pk, grid, amax, st0)
    walk_k.triplet_walk(g, a[1:], *pk.targs, 0, state, ops, *pk.ttables)
    for got, want in zip(P.triplet_state_to_numpy(state), (xi, xj, xst)):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(ops.numpy(), np.asarray(xops))
    assert (ops.numpy() >> 2).max() >= 15  # the long insertion run, in one row

    aj, dj, io = pk.jargs
    cost_rows = jnp.transpose(pk.jtables[0][aj], (1, 0, 2))
    E4 = jnp.concatenate([
        jnp.zeros((pk.B, 4, 1), jnp.float32),
        jnp.transpose(pk.jtables[1][:4, dj], (1, 0, 2))], axis=2)
    pi, pj, pst, prows = triplet_walk_pallas(
        jnp.asarray(grid[:-1]), jnp.asarray(amax[1:]), cost_rows, E4, io,
        jnp.int32(0), state0[0], state0[1], state0[2], pk.jtables[2],
        S=pk.n_cod, interpret=True)
    for got, want in zip(P.triplet_state_to_numpy(state), (pi, pj, pst)):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(ops.numpy(), np.asarray(prows))


@pytest.mark.parametrize("seg", [3, 4])
def test_walk_plain_in_segments_equals_the_xla_walk(seg):
    """The walk drained through segments of `seg` blocks from the top, the
    last one ragged, each from t_lo > 0 but the last: after every segment the
    state and the op rows equal the XLA walk's over the same segment, and at
    the end the whole walk's."""
    pk, grid, amax, st0 = walk_inputs(seed=8)
    assert pk.n_cod % seg != 0
    _, (xi, xj, xst, xops) = jax_walk(pk, grid, amax, st0)
    g, a, state, ops = torch_walk_inputs(pk, grid, amax, st0)
    jstate = (3 * jnp.asarray(pk.lens_t), jnp.asarray(pk.lens_m),
              jnp.asarray(st0), jnp.zeros((6 * pk.n_cod, pk.B), jnp.int32))
    spans = [(lo, min(seg, pk.n_cod - lo)) for lo in range(0, pk.n_cod, seg)]
    for t_lo, S in reversed(spans):
        jstate = jax_tw._triplet_walk_seg_xla(
            jnp.asarray(grid[t_lo:t_lo + S + 1]),
            jnp.asarray(amax[t_lo + 1:t_lo + S + 1]),
            pk.jargs[0][:, t_lo:t_lo + S], *pk.jargs[1:], jnp.int32(t_lo),
            jstate, *pk.jtables, S=S)
        walk_k.triplet_walk(
            g[t_lo:t_lo + S + 1].contiguous(),
            a[t_lo + 1:t_lo + S + 1].contiguous(),
            pk.targs[0][:, t_lo:t_lo + S].contiguous(), *pk.targs[1:], t_lo,
            state, ops, *pk.ttables)
        for got, want in zip(P.triplet_state_to_numpy(state), jstate[:3]):
            np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(ops.numpy(), np.asarray(jstate[3]))
    for got, want in zip(P.triplet_state_to_numpy(state), (xi, xj, xst)):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(ops.numpy(), np.asarray(xops))


def _same(got, want):
    """Strings equal, scores equal as f32."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g[0], g[1]) == (w[0], w[1])
        assert np.float32(g[2]) == np.float32(w[2])


@pytest.mark.parametrize("traceback", ["device", "host"])
def test_align_batch_equals_the_jax_package(traceback):
    """The slice as a whole on the 101 pairs of the JAX package's own batch
    test: strings equal and scores equal in f32 to its triplet_align_batch
    and to its host engine triplet_align, and every alignment attains the
    score (triplet_path_score, an independent scorer in another order of
    operations: 1e-4)."""
    jm, tm = models("tri-mg")
    rng = random.Random(77)
    pairs = [("CTCTGGATAGTG", "CTATAGTG")]
    for _ in range(100):
        anc = "".join(rng.choice(CODONS61) for _ in range(rng.randint(1, 12)))
        des = "".join(rng.choice("ACGTN") for _ in range(rng.randint(1, 30)))
        pairs.append((anc, des))
    got = tw.triplet_align_batch(tm, pairs, traceback=traceback, device="cpu")
    assert got[0][:2] == ("CTCTGGATAGTG", "CT----ATAGTG")
    _same(got, jax_tw.triplet_align_batch(jm, pairs, traceback=traceback))
    _same(got, [jax_hmm.triplet_align(jm, a, d) for a, d in pairs])
    for s0, s1, sc in got:
        assert torch_hmm.triplet_path_score(tm, s0, s1) == pytest.approx(sc, abs=1e-4)


@pytest.mark.parametrize("name", ["tri-ecm", "dna"])
def test_align_batch_ecm_and_dna(name):
    jm, tm = models(name)
    pairs = [("CTCTGGATAGTG", "CTATAGTG"), ("GCGACTGTT", "GCGATTGCTGTT"),
             ("GCGACTGTTAGC", "GCGNNTGTTAGCA")]
    got = tw.triplet_align_batch(tm, pairs, device="cpu")
    _same(got, jax_tw.triplet_align_batch(jm, pairs))
    _same(got, [jax_hmm.triplet_align(jm, a, d) for a, d in pairs])


def test_align_long_equals_the_host_engine():
    """The segmented two-pass path with the walk crossing many seams
    (seg_cods=7, a ragged last segment) against the JAX package's host
    engine; and the default segment length, which holds a short pair in one
    segment."""
    jm, tm = models("tri-mg")
    rng = random.Random(23)
    for _ in range(3):
        anc, des = homolog(rng, rng.randint(40, 60))
        want = jax_hmm.triplet_align(jm, anc, des)
        _same([tw.triplet_align_long(tm, anc, des, seg_cods=7, device="cpu")], [want])
    _same([tw.triplet_align_long(tm, anc, des, device="cpu")], [want])
    _, dna = models("dna")
    with pytest.raises(ValueError, match="codon model"):
        tw.triplet_align_long(dna, anc, des, device="cpu")


def test_results_depend_on_no_threshold(monkeypatch):
    """A batch cut into sub-batches of a few pairs, with its larger pairs
    sent down the segmented path in segments of 3 blocks, gives the uncut
    batch's results."""
    _, tm = models("tri-mg")
    rng = random.Random(41)
    pairs = [homolog(rng, rng.randint(5, 30), indels=2) for _ in range(12)]
    want = tw.triplet_align_batch(tm, pairs, device="cpu")
    enc = [torch_hmm.encode_triplet_pair(tm, a, d) for a, d in pairs]
    assert [g for g in tw._sub_batches(enc)] == [(list(range(12)), False)]
    _same(tw.triplet_align_batch(tm, pairs, device="cpu", enc=enc), want)

    sizes = sorted(tw.grid_bytes(len(a), len(d)) for a, d in enc)
    monkeypatch.setattr(tw, "TRIPLET_GRID_BUDGET_BYTES", sizes[7])
    monkeypatch.setattr(tw, "TRIPLET_BATCH_BYTES", 3 * sizes[7])
    monkeypatch.setattr(tw, "SEG_CODS", 3)
    groups = list(tw._sub_batches(enc))
    assert sum(long for _, long in groups) == 4
    assert sorted(i for idxs, _ in groups for i in idxs) == list(range(12))
    assert max(len(idxs) for idxs, _ in groups) > 1 and len(groups) > 5
    for idxs, long in groups:
        sub = [enc[i] for i in idxs]
        assert long or tw.grid_bytes(max(len(a) for a, _ in sub),
                                     max(len(d) for _, d in sub),
                                     len(sub)) <= 3 * sizes[7]
    calls = []
    real = tw.triplet_align_long
    monkeypatch.setattr(tw, "triplet_align_long",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _same(tw.triplet_align_batch(tm, pairs, device="cpu"), want)
    assert len(calls) == 4
    assert tw.is_long_pair(3 * 30, 90) and not tw.is_long_pair(3, 3)


def test_batch_align_encodes_a_triplet_pair_once(monkeypatch):
    """batch_align validates a pair by encoding it and hands the encodings
    on to triplet_align_batch; its rows are the engine's own results."""
    import io
    import json

    from coati_tpu_torch import batchrun
    from coati_tpu_torch.params import alignment_params

    _, tm = models("tri-mg")
    rng = random.Random(5)
    pairs = [homolog(rng, rng.randint(5, 20)) for _ in range(6)]
    want = tw.triplet_align_batch(tm, pairs, device="cpu")
    calls = []
    real = torch_hmm.encode_triplet_pair
    monkeypatch.setattr(torch_hmm, "encode_triplet_pair",
                        lambda *a: calls.append(1) or real(*a))
    out = io.StringIO()
    named = [(f"a{i}", a, f"d{i}", d) for i, (a, d) in enumerate(pairs)]
    assert batchrun.batch_align(alignment_params("tri-mg"), named, out, device="cpu") == 6
    assert len(calls) == 6
    rows = [json.loads(line) for line in out.getvalue().splitlines()]
    got = [(*r["alignment"].values(), r["score"]) for r in rows]
    _same(got, want)


def test_default_thresholds_are_rules_on_bytes():
    """At 15 B a cell 1 GiB holds 71.6 M boundary cells: a square pair of
    14,500 nt fits, one of 15,000 nt takes the segmented path; a segment of
    the long path stays within the same budget."""
    assert tw.GRID_CELL_BYTES == 3 * 4 + 3
    assert not tw.is_long_pair(14_499, 14_500)
    assert tw.is_long_pair(15_000, 15_000)
    assert tw.seg_cods_for(15_001) == tw.SEG_CODS == 512
    wide = 1_000_000
    assert tw.seg_cods_for(wide) * wide * 15 <= tw.TRIPLET_GRID_BUDGET_BYTES


def test_boundaries_batch_equals_the_jax_package():
    jm, tm = models("tri-mg")
    pairs = ragged_pairs(13, 6)
    jenc = [jax_hmm.encode_triplet_pair(jm, a, d) for a, d in pairs]
    tenc = [torch_hmm.encode_triplet_pair(tm, a, d) for a, d in pairs]
    want = jax_tw.triplet_boundaries_batch(jm, [e[0] for e in jenc], [e[1] for e in jenc])
    got = tw.triplet_boundaries_batch(tm, [e[0] for e in tenc], [e[1] for e in tenc],
                                      device="cpu")
    np.testing.assert_array_equal(got, want)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Wrong dtype, shape or device raises before any launch; without CUDA a
    request for it is an error, not a move to the CPU."""
    jm, tm = models("tri-mg")
    pk = Packed(jm, ragged_pairs(2, 4))
    carry = tw.triplet_init_carry(pk.targs[1], pk.targs[2], pk.ttables[2])
    args = (*pk.targs, pk.lt, pk.lm, *pk.ttables, carry)
    with pytest.raises(ValueError, match="anc_cods"):
        rows_k.triplet_rows(args[0].long(), *args[1:])
    with pytest.raises(ValueError, match="carry"):
        rows_k.triplet_rows(*args[:-1], carry[:, :, :-1].contiguous())
    with pytest.raises(ValueError, match="grid_out"):
        rows_k.triplet_rows(*args, grid_out=torch.empty((1, 3, 4, 2)))
    grid, amax, _ = rows_k.triplet_rows(*args)
    state = torch.zeros((3, pk.B), dtype=torch.int32)
    ops = torch.zeros((6 * pk.n_cod, pk.B), dtype=torch.int32)
    wargs = (grid, amax, *pk.targs, 0, state, ops, *pk.ttables)
    with pytest.raises(ValueError, match="amax_seg"):
        walk_k.triplet_walk(grid, amax.int(), *wargs[2:])
    with pytest.raises(ValueError, match="outside ops"):
        walk_k.triplet_walk(*wargs[:5], 1, *wargs[6:])
    with pytest.raises(ValueError, match="state"):
        walk_k.triplet_walk(*wargs[:6], state.long(), *wargs[7:])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tw.triplet_align_batch(tm, [("GCG", "GCG")])
    with pytest.raises(ValueError, match="traceback"):
        tw.triplet_align_batch(tm, [("GCG", "GCG")], traceback="x", device="cpu")
    assert rows_k.block_threads(30) == 32 and rows_k.block_threads(9999) == 512
