"""Score-only Viterbi on the strip body (csrc/wavefront_fill.cu compiled with
kBp = false, entry point coati_wavefront_fill_score), emulated on the CPU.

The emulation is tests/test_torch_fill_strips.py's strip_fill with
want_bp=False: the fill kernel's traversal (strips, skew, warp rings, the
edge buffer and its release counters, registers and slots that read NaN
until written), writing no stack. Its corners must be bit-equal to
score_plain and to the JAX package's score mode on XLA:CPU
(coati_tpu/align/wavefront.py wavefront(mode="score") and
coati_tpu/align/engine.py viterbi_scores_batch). Then the score route's
launch shapes, and the chunks viterbi_scores_batch plans from lengths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coati_tpu.align import engine as jax_engine
from coati_tpu.align.wavefront import gap_consts_array, wavefront
from coati_tpu.structs import GapParams
from coati_tpu_torch.align import engine as torch_engine
from coati_tpu_torch.kernels import wavefront_fill as fill_mod
from coati_tpu_torch.kernels import wavefront_score as score_mod
from coati_tpu_torch.kernels import wavefront_segment as seg_mod
from test_torch_fill_strips import _group, _tables, _torch, strip_fill

# (k, lengths of the ancestors, of the descendants, W, warps, pairs, blocks, G),
# widths the score-only body is built for (wavefront_fill.SCORE_WIDTHS)
CASES = [
    # several warps in one pass, ragged, a stacked table
    (1, (45, 60, 90), (150, 97, 260), 8, 2, 1, 1, 3),
    # stripe passes through the edge buffer, two pairs a block
    (1, (81, 69), (300, 210), 4, 2, 2, 1, 1),
    # several blocks a pair, with passes
    (1, (75,), (400,), 4, 1, 1, 2, 1),
    # strips of 16, one warp in passes
    (1, (66, 30), (700, 120), 16, 1, 1, 1, 1),
    # k = 3: passes over several blocks
    (3, (99, 72), (300, 201), 4, 1, 1, 2, 2),
    # k = 5: strips of 8, several blocks a pair
    (5, (75, 45), (200, 135), 8, 1, 1, 2, 1),
]


def _jax_score_corners(aseq, bseq, la, lb, table, gc, k):
    (cm, cd, ci), _ = wavefront(*[jnp.asarray(x) for x in (aseq, bseq, la, lb, table, gc)],
                                k=k, semiring="tropical", mode="score")
    return torch.from_numpy(np.stack([np.asarray(x) for x in (cm, cd, ci)]))


@pytest.mark.parametrize("k,la,lb,W,warps,pairs,blocks,G", CASES)
def test_score_strips_equal_plain_and_xla(mg94_table, k, la, lb, W, warps, pairs,
                                          blocks, G):
    aseq, bseq, la, lb = _group(20 * k + W + warps, k, la, lb, G=G)
    table = _tables(mg94_table, G)
    gc = gap_consts_array(GapParams(len=k))
    args = _torch(aseq, bseq, la, lb, table, gc)
    B = aseq.shape[0]
    C = bseq.shape[1] + k
    launch = fill_mod.fill_launch(B, C, k, W, warps, pairs, blocks,
                                  table_len=table.size, widths=fill_mod.SCORE_WIDTHS)
    corners, bp = strip_fill(*args, k=k, launch=launch, want_bp=False)
    assert bp is None
    assert torch.equal(corners, score_mod.score_plain(*args, k=k))
    assert torch.equal(corners, _jax_score_corners(aseq, bseq, la, lb, table, gc, k))


def test_the_score_cases_reach_their_shapes():
    """Passes in one block and over several, several blocks a pair, two
    pairs a block, and every k of the cases with a width built score-only."""
    launches = [fill_mod.fill_launch(len(la), max(lb) + k, k, W, warps, pairs, blocks,
                                     widths=fill_mod.SCORE_WIDTHS)
                for k, la, lb, W, warps, pairs, blocks, _ in CASES]
    assert any(ln.passes > 1 and ln.blocks == 1 for ln in launches)
    assert any(ln.passes > 1 and ln.blocks > 1 for ln in launches)
    assert any(ln.pairs > 1 for ln in launches)
    assert {ln.k for ln in launches if ln.blocks > 1} == {1, 3, 5}


@pytest.mark.parametrize("B,C,k", [(64, 1057, 1), (4, 32_065, 1), (1, 160_003, 1),
                                   (350, 289, 1), (961, 1057, 1), (454, 1633, 1),
                                   (2, 6_001, 2), (32, 577, 3), (3, 4_500, 5),
                                   (16, 577, 8), (200, 32_065, 1)])
def test_score_shape_takes_a_built_width_and_fits_the_card(B, C, k):
    """score_shape's launches use the widths built score-only, fit a block's
    threads, cover every stripe, and spread a pair over 4,096 slots over
    several blocks while the card has SMs for them, the whole group at once
    (a cooperative launch)."""
    sms = 132
    launch = score_mod.score_shape(B, C, k, sms=sms)
    assert launch.W in fill_mod.SCORE_WIDTHS[k]
    assert launch.threads <= fill_mod.max_threads(k, launch.W)
    assert launch.passes * launch.warps * launch.blocks >= fill_mod.stripes(C, launch.W)
    if launch.blocks > 1:
        assert B * launch.blocks <= sms and launch.pairs == 1
    if C > fill_mod.MULTI_BLOCK_SLOTS and 2 * B <= sms:
        assert launch.blocks > 1
    edge, gprog = fill_mod.edge_buffers(launch, 100, "cpu")
    if launch.needs_edge:
        assert edge.shape == (B, launch.blocks, 100 + k, 2 * k + 1)
        assert gprog.shape == (B, launch.blocks) and not gprog.any()
    else:
        assert edge is None and gprog is None


def test_score_shape_leaves_larger_gaps_to_the_sweep():
    with pytest.raises(ValueError, match="sweep"):
        score_mod.score_shape(4, 500, fill_mod.MAX_K + 1)
    with pytest.raises(ValueError, match="built"):
        fill_mod.fill_launch(4, 500, 2, 8, 2, widths=fill_mod.SCORE_WIDTHS)


def test_score_wrapper_on_cpu_launches_nothing(mg94_table):
    """On CPU tensors wavefront_score takes score_plain whatever launch it
    is given (a strip launch, a sweep launch, none), and counts no launch;
    its corners equal the JAX package's score mode."""
    for k in (1, 3, fill_mod.MAX_K + 1):
        aseq, bseq, la, lb = _group(60 + k, k, (12 * k, 21 * k), (9 * k, 30 * k))
        gc = gap_consts_array(GapParams(len=k))
        args = _torch(aseq, bseq, la, lb, mg94_table, gc)
        B, C = 2, bseq.shape[1] + k
        before = (score_mod.LAUNCHES, seg_mod.LAUNCHES, fill_mod.LAUNCHES)
        launches = [None, seg_mod.sweep_launch(B, C, k, 1, 256)]
        if k <= fill_mod.MAX_K:
            launches.append(score_mod.score_shape(B, C, k))
        want = _jax_score_corners(aseq, bseq, la, lb, mg94_table, gc, k)
        for launch in launches:
            got = score_mod.wavefront_score(*args, k=k, launch=launch)
            assert torch.equal(got, want)
        assert (score_mod.LAUNCHES, seg_mod.LAUNCHES, fill_mod.LAUNCHES) == before


def test_four_32_knt_pairs_are_one_chunk():
    """The score chunks of the long phase's four 29-32 knt pairs: one
    launch; the 160 knt pair alone is one too."""
    la = [29_397, 31_998, 29_397, 31_998]
    lb = [29_400, 31_992, 29_391, 32_004]
    assert torch_engine.score_chunks(la, lb, 1) == [[0, 1, 2, 3]]
    assert torch_engine.score_chunks([160_002], [160_005], 1) == [[0]]
    # the four beside pairs of the main mix: their buckets apart, in input order
    mix_a = [156, 471, 29_397, 999, 31_998, 156, 29_397, 31_998, 471]
    mix_b = [153, 474, 29_400, 990, 31_992, 159, 29_391, 32_004, 468]
    chunks = torch_engine.score_chunks(mix_a, mix_b, 1)
    assert [2, 4, 6, 7] in chunks
    assert sorted(i for c in chunks for i in c) == list(range(len(mix_a)))
    assert all(c == sorted(c) for c in chunks)


def test_score_chunks_cut_by_bytes_not_cells():
    """Chunks hold inputs, corners and the edge buffer within the budget;
    no backpointer cells are counted, so a bucket of 999 nt pairs is one
    chunk where the fill's cell budget would cut it; a small budget cuts
    buckets into chunks that keep input order; pairs of unlike size that
    spread over blocks are not padded to one another."""
    n = 3_000
    la, lb = [999] * n, [999] * n
    assert len(torch_engine.score_chunks(la, lb, 1)) == 1
    assert n > (1 << 30) // (1056 * 1056)  # what a cut by cells would allow
    budget = torch_engine.score_launch_bytes(10, 1056, 1056, 1, False)
    chunks = torch_engine.score_chunks(la, lb, 1, max_batch_bytes=budget)
    assert [len(c) for c in chunks] == [10] * (n // 10)
    assert sum(chunks, []) == list(range(n))
    apart = torch_engine.score_chunks([6_000, 160_002, 6_300], [6_003, 160_005, 6_297], 1)
    assert apart == [[0, 2], [1]]
    # the edge buffer of a spread group counts every SM's block; above
    # MAX_K the sweep's ring of diagonals a pair is counted instead
    inputs = 4 * 4 * (960 + 960 + 2) + 12 * 4
    assert torch_engine.score_launch_bytes(4, 960, 960, 1, True) == inputs + 4 * 132 * 961 * 3
    k = fill_mod.MAX_K + 1
    assert (torch_engine.score_launch_bytes(4, 960, 960, k, False)
            == inputs + 4 * 4 * seg_mod.ring_slots(k) * 3 * (960 + k))


def test_scores_batch_over_spread_pairs_matches_jax(mg94_table, monkeypatch):
    """viterbi_scores_batch with pairs over the spread threshold (lowered so
    that small pairs cross it) and pairs below it: the same scores as the
    JAX package's."""
    monkeypatch.setattr(fill_mod, "MULTI_BLOCK_SLOTS", 100)
    rng = np.random.default_rng(8)
    lens = [(90, 96), (60, 57), (150, 141), (30, 33), (120, 129)]
    enc_as = [rng.integers(0, 183, a).astype(np.int32) for a, _ in lens]
    enc_bs = [rng.integers(0, 16, b).astype(np.int32) for _, b in lens]
    gap = GapParams(len=1)
    chunks = torch_engine.score_chunks([a for a, _ in lens], [b for _, b in lens], 1,
                                       quantum=32)
    assert [0, 2, 4] in chunks or [2, 4] in chunks
    want = jax_engine.viterbi_scores_batch(enc_as, enc_bs, mg94_table, gap, quantum=32)
    got = torch_engine.viterbi_scores_batch(enc_as, enc_bs, mg94_table, gap, quantum=32,
                                            device="cpu")
    np.testing.assert_array_equal(got, want)
