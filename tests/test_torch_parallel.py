"""The port's multi-lane paths (coati_tpu_torch.parallel, the engine's
round-robin) against the JAX package's mesh on its 8 virtual CPU devices,
on the CPU. Lanes are ["cpu"] * n: the split, the per-lane enqueue and the
gather in input order run as they run over streams on a card. Tolerance:
none. Strings are compared with ==, scores as f32 with ==.
"""

import random

import jax
import numpy as np
import pytest
import torch

from coati_tpu import triplet_hmm as jax_hmm
from coati_tpu.align import engine as jax_engine
from coati_tpu.constants import CODONS61
from coati_tpu.parallel import mesh as jax_mesh
from coati_tpu.parallel import multihost as jax_multihost
from coati_tpu.structs import AlignmentParams as JaxAlignmentParams
from coati_tpu.structs import GapParams as JaxGapParams
from coati_tpu_torch import triplet_hmm as torch_hmm
from coati_tpu_torch.align import engine
from coati_tpu_torch.align.sample_device import sample_batch_device
from coati_tpu_torch.align.wavefront import gap_consts_array
from coati_tpu_torch.device import resolve_devices
from coati_tpu_torch.driver import _forward_diag
from coati_tpu_torch.params import alignment_params
from coati_tpu_torch.parallel import mesh, multihost
from coati_tpu_torch.parallel import dryrun
from coati_tpu_torch.parallel.dryrun import dryrun_multichip
from coati_tpu_torch.structs import AlignmentParams as TorchAlignmentParams
from coati_tpu_torch.structs import GapParams
from coati_tpu_torch.utils import encode_marginal


@pytest.fixture(scope="module")
def jax_mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax_mesh.make_mesh(8)


def random_pairs(seed, n, cods=(2, 8), nts=(3, 24)):
    """n (anc, des, enc_a, enc_b) from `random`, as tests/test_parallel.py
    makes them."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        anc = "".join(rng.choice(CODONS61) for _ in range(rng.randint(*cods)))
        des = "".join(rng.choice("ACGT") for _ in range(rng.randint(*nts)))
        out.append((anc, des, *encode_marginal(anc, des)))
    return [list(x) for x in zip(*out)]


def test_sharded_scores_match_jax_and_single_lane(mg94_table, jax_mesh8):
    _, _, enc_as, enc_bs = random_pairs(3, 19)  # odd: the last shard is ragged
    want = jax_mesh.sharded_viterbi_scores(enc_as, enc_bs, mg94_table, JaxGapParams(),
                                           jax_mesh8, quantum=32)
    lanes = mesh.make_mesh(devices=["cpu"] * 8)
    got = mesh.sharded_viterbi_scores(enc_as, enc_bs, mg94_table, GapParams(), lanes,
                                      quantum=32)
    one = engine.viterbi_scores_batch(enc_as, enc_bs, mg94_table, GapParams(),
                                      quantum=32, device="cpu")
    assert got.dtype == np.float32 and got.shape == (19,)
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    np.testing.assert_array_equal(got, one)


def test_sharded_align_strings_match_jax_and_single_lane(mg94_table, jax_mesh8):
    ancs, dess, enc_as, enc_bs = random_pairs(11, 21)
    want = jax_mesh.sharded_viterbi_align_batch(enc_as, enc_bs, ancs, dess, mg94_table,
                                                JaxGapParams(), jax_mesh8, quantum=32)
    jax_one = jax_engine.viterbi_align_batch(enc_as, enc_bs, ancs, dess, mg94_table,
                                             JaxGapParams(), quantum=32)
    got = mesh.sharded_viterbi_align_batch(enc_as, enc_bs, ancs, dess, mg94_table,
                                           GapParams(), mesh.make_mesh(devices=["cpu"] * 8),
                                           quantum=32)
    assert len(got) == 21
    for g, w, o in zip(got, want, jax_one):
        assert (g.seq0, g.seq1) == (w.seq0, w.seq1) == (o.seq0, o.seq1)
        assert np.float32(g.score) == np.float32(w.score) == np.float32(o.score)


def test_sharded_align_step_matches_jax(mg94_table, jax_mesh8):
    """The split fused step on an already padded batch: each pair's ops
    (the -1 padding dropped) and score equal JAX's sharded_align_step's, and
    the -1 padding lies where ops_to_strings expects it after [::-1]."""
    ancs, dess, enc_as, enc_bs = random_pairs(7, 16)
    aseq, bseq, la, lb = jax_engine._pad_batch(enc_as, enc_bs, 32)
    gc = gap_consts_array(GapParams())
    ops_w, score_w = jax_mesh.sharded_align_step(
        jax.numpy.asarray(aseq), jax.numpy.asarray(bseq), jax.numpy.asarray(la),
        jax.numpy.asarray(lb), jax.numpy.asarray(mg94_table), jax.numpy.asarray(gc),
        k=1, mesh=jax_mesh8)
    ops_w, score_w = np.asarray(ops_w), np.asarray(score_w)
    ops, score = mesh.sharded_align_step(aseq, bseq, la, lb, mg94_table, gc, k=1,
                                         mesh=mesh.make_mesh(devices=["cpu"] * 3))
    assert ops.dtype == np.int8 and ops.shape[1] == 16
    np.testing.assert_array_equal(score, score_w)
    for p in range(16):
        np.testing.assert_array_equal(ops[:, p][ops[:, p] >= 0], ops_w[:, p][ops_w[:, p] >= 0])
        walk = ops[:, p]
        assert (walk[: (walk >= 0).sum()] >= 0).all()  # -1 only after the walk
    got = engine.ops_to_strings(ops[::-1], score, ancs, dess, 1)
    one = engine.viterbi_align_batch(enc_as, enc_bs, ancs, dess, mg94_table, GapParams(),
                                     quantum=32, device="cpu")
    assert got == one


def test_engine_round_robin_uses_every_lane(mg94_table):
    """One bucket of 32 pairs over 8 lanes: the bucket is cut so that every
    lane runs a chunk, and the results equal one lane's and the JAX engine's
    (which round-robins over the 8 virtual devices)."""
    rng = random.Random(5)
    ancs = ["".join(rng.choice(CODONS61) for _ in range(4)) for _ in range(32)]
    dess = ["".join(rng.choice("ACGT") for _ in range(12)) for _ in range(32)]
    enc = [encode_marginal(a, d) for a, d in zip(ancs, dess)]
    enc_as, enc_bs = [e[0] for e in enc], [e[1] for e in enc]
    lanes = resolve_devices(["cpu"] * 8)
    assert len(lanes) == 8 and all(lane.stream is None for lane in lanes)
    got = engine.viterbi_align_batch(enc_as, enc_bs, ancs, dess, mg94_table,
                                     GapParams(), quantum=16, device=lanes)
    assert [lane.chunks for lane in lanes] == [1] * 8
    one = engine.viterbi_align_batch(enc_as, enc_bs, ancs, dess, mg94_table,
                                     GapParams(), quantum=16, device="cpu")
    want = jax_engine.viterbi_align_batch(enc_as, enc_bs, ancs, dess, mg94_table,
                                          JaxGapParams(), quantum=16)
    assert got == one
    for g, w in zip(got, want):
        assert (g.seq0, g.seq1, np.float32(g.score)) == (w.seq0, w.seq1, np.float32(w.score))


def test_round_robin_sends_long_pairs_to_the_first_lane(mg94_table):
    """Pairs forced onto the long-pair route go, in groups, to the first
    lane; the rest round-robin; every result is one lane's."""
    ancs, dess, enc_as, enc_bs = random_pairs(13, 9, cods=(4, 12), nts=(10, 36))
    lanes = resolve_devices(["cpu"] * 3)
    long_slots = 25
    n_long = sum(len(b) + 1 > long_slots for b in enc_bs)
    assert 0 < n_long < 9
    got = engine.viterbi_align_batch(enc_as, enc_bs, ancs, dess, mg94_table, GapParams(),
                                     quantum=16, long_slots=long_slots, device=lanes)
    one = engine.viterbi_align_batch(enc_as, enc_bs, ancs, dess, mg94_table, GapParams(),
                                     quantum=16, long_slots=long_slots, device="cpu")
    assert got == one
    n_groups = len(engine._long_groups(
        [i for i, b in enumerate(enc_bs) if len(b) + 1 > long_slots], enc_as, enc_bs, 1))
    buckets = lanes[0].chunks + lanes[1].chunks + lanes[2].chunks - n_groups
    assert n_groups >= 1 and lanes[0].chunks >= n_groups and buckets >= 3


def test_resolve_devices(monkeypatch):
    """A name or a list, repeats kept; lanes pass through; one lane runs on
    the current stream; CUDA where there is none raises."""
    (lane,) = resolve_devices("cpu")
    assert lane.device == torch.device("cpu") and lane.stream is None
    lanes = resolve_devices(["cpu", torch.device("cpu")])
    assert [x.device.type for x in lanes] == ["cpu", "cpu"] and lanes[0] is not lanes[1]
    assert resolve_devices(lanes) == lanes
    assert resolve_devices(lanes[1]) == [lanes[1]]
    with pytest.raises(ValueError):
        resolve_devices([])
    with pytest.raises(TypeError):
        resolve_devices([lanes[0], "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for spec in ("cuda", ["cpu", "cuda:0"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_devices(spec)


def _triplet_models():
    out = []
    for params, hmm in ((JaxAlignmentParams, jax_hmm), (TorchAlignmentParams, torch_hmm)):
        aln = params()
        aln.model = "tri-mg"
        out.append(hmm.build_triplet_model(aln))
    return out


def test_sharded_triplet_matches_jax_and_host(jax_mesh8):
    rng = random.Random(9)
    pairs = [("CTCTGGATAGTG", "CTATAGTG")]
    for _ in range(10):  # 11 pairs over 8 lanes and devices: ragged shards
        anc = "".join(rng.choice(CODONS61) for _ in range(rng.randint(2, 6)))
        des = "".join(rng.choice("ACGT") for _ in range(rng.randint(4, 18)))
        pairs.append((anc, des))
    jax_model, torch_model = _triplet_models()
    want = jax_mesh.sharded_triplet_align_batch(jax_model, pairs, jax_mesh8)
    got = mesh.sharded_triplet_align_batch(torch_model, pairs,
                                           mesh.make_mesh(devices=["cpu"] * 8))
    assert len(got) == len(pairs)
    for (a, d), g, w in zip(pairs, got, want):
        host = torch_hmm.triplet_align(torch_model, a, d)
        assert (g[0], g[1]) == (w[0], w[1]) == (host[0], host[1])
        assert np.float32(g[2]) == np.float32(w[2]) == np.float32(host[2])


@pytest.mark.parametrize("model", ["dna", "tri-ecm-long"])
def test_sharded_triplet_other_routes(monkeypatch, model):
    """The dna model goes to the host engine; a pair over the grid budget
    takes the segmented path on its lane: both equal triplet_align."""
    from coati_tpu_torch import triplet_wavefront as tw
    from coati_tpu_torch.constants import ECM_DNA_PI

    aln = TorchAlignmentParams()
    aln.model = model.split("-long")[0]
    if aln.model == "tri-ecm":
        aln.pi = ECM_DNA_PI
        monkeypatch.setattr(tw, "TRIPLET_GRID_BUDGET_BYTES", 1_500)
    torch_model = torch_hmm.build_triplet_model(aln)
    pairs = [("CTCTGGATAGTGCTCTGGATAGTG", "CTCTGGATAGTGCTATAGTG"),
             ("ATGAAACCCGGG", "ATGAAACCGGG"), ("CTCTGGATAGTG", "CTATAGTG")]
    got = mesh.sharded_triplet_align_batch(torch_model, pairs,
                                           mesh.make_mesh(devices=["cpu"] * 2))
    assert got == [torch_hmm.triplet_align(torch_model, a, d) for a, d in pairs]
    if model.endswith("long"):
        assert tw.is_long_pair(*map(len, pairs[0])) and not tw.is_long_pair(*map(len, pairs[2]))


@pytest.mark.parametrize("n_lanes,n", [(3, 7), (4, 2)])
def test_sharded_sample_equals_single_lane(n_lanes, n):
    """The draws split over the lanes: the single-lane samples for the seed,
    the same twice, every path an alignment of the pair (with 4 lanes and 2
    draws, two lanes get none)."""
    anc, des = "CCCCCCAAATTT", "CCCCCCCCAANT"
    aln = alignment_params("mar-mg")
    enc_a, enc_b = encode_marginal(anc, des)
    mdi, corners = _forward_diag(enc_a, enc_b, aln, torch.device("cpu"))
    lanes = mesh.make_mesh(devices=["cpu"] * n_lanes)
    args = (mdi, corners, enc_a, enc_b, aln.subst_matrix, anc, des, aln.gap, 17, n)
    got = mesh.sharded_sample_batch(*args, lanes)
    assert got == mesh.sharded_sample_batch(*args, lanes)
    assert got == list(sample_batch_device(*args))
    assert len(got) == n
    for s0, s1, sc in got:
        assert s0.replace("-", "") == anc and s1.replace("-", "") == des
        assert np.isfinite(sc) and sc <= 0
    other = mesh.sharded_sample_batch(*args[:-2], 18, n, lanes)
    assert n < 3 or other != got


def test_shard_bounds_match_jax():
    for pc in range(1, 6):
        for n in range(41):
            items = list(range(n))
            shards = []
            for pi in range(pc):
                assert multihost.shard_bounds(n, pi, pc) == jax_multihost.shard_bounds(n, pi, pc)
                shards.append(multihost.host_shard(items, pi, pc))
                assert shards[-1] == jax_multihost.host_shard(items, pi, pc)
            assert sum(shards, []) == items
    assert multihost.shard_bounds(10) == (0, 10)  # one process, no group


def test_global_scores_allgather_returns_its_input(jax_mesh8):
    scores = np.arange(16, dtype=np.float32)
    lanes = mesh.make_mesh(devices=["cpu"] * 8)
    np.testing.assert_array_equal(multihost.global_scores_allgather(scores, lanes), scores)
    np.testing.assert_array_equal(
        multihost.global_scores_allgather(scores, lanes),
        jax_multihost.global_scores_allgather(scores, jax_mesh8))
    odd = np.array([1.5, np.nan, -2.0], np.float32)
    np.testing.assert_array_equal(multihost.global_scores_allgather(odd, lanes), odd)


def test_merge_one_process(tmp_path):
    """Without a group: the scores manifest and the one shard as the
    output."""
    base = tmp_path / "out.jsonl"
    (tmp_path / "out.jsonl.0").write_text('{"pair": 0}\n{"pair": 1}\n')
    scores, merged = multihost.merge_multihost_outputs(
        str(base), np.array([1.25, np.nan], np.float32), 2)
    assert merged == str(base) and base.read_text() == '{"pair": 0}\n{"pair": 1}\n'
    assert scores[0] == 1.25 and np.isnan(scores[1])
    assert (tmp_path / "out.jsonl.scores.json").read_text() == \
        '{"n_pairs": 2, "scores": [1.25, null]}'


def test_dryrun_multichip_on_three_cpu_lanes():
    assert "3 lanes" in dryrun_multichip(["cpu"] * 3)


def test_dryrun_defaults_to_the_card(monkeypatch, capsys):
    """With no lanes named the dry run asks for two streams on the first
    card: where there is no CUDA it raises, and it runs on the CPU only when
    asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main([])
    dryrun.main(["cpu", "cpu"])
    assert "2 lanes" in capsys.readouterr().out


def test_shards_are_contiguous_and_ragged():
    """ceil(n / lanes) items a lane, the last shard shorter, nothing padded;
    lanes past the end get no shard."""
    lanes = mesh.make_mesh(devices=["cpu"] * 4)
    assert [(lo, hi) for _, lo, hi in mesh._shards(lanes, 7)] == [(0, 2), (2, 4), (4, 6), (6, 7)]
    assert [(lo, hi) for _, lo, hi in mesh._shards(lanes, 2)] == [(0, 1), (1, 2)]
    assert [lane for lane, _, _ in mesh._shards(lanes, 2)] == lanes.lanes[:2]
    assert mesh._shards(lanes, 0) == []
