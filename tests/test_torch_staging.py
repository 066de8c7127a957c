"""A lane's staging (coati_tpu_torch/device.py Staging) on the CPU.

Chunks padded straight into a lane's upload slots hold the bytes the JAX
package's numpy padding gives for the same inputs (coati_tpu's
engine._pad_rows / _pad_batch and triplet_wavefront._pack_batch): ragged
lengths, quanta 32 and 96, empty and one-pair chunks, table_idx offsets,
int32 and int8 codes, slots that held larger chunks before. Tolerance:
none, the arrays are compared byte for byte. The slots are reused from
chunk to chunk and grow only when a chunk needs more; a slot is filled
again only after its last copy. Alignments through many chunks a lane equal
the JAX package's.
"""

import numpy as np
import pytest
import torch

from coati_tpu import triplet_hmm as jax_hmm
from coati_tpu import triplet_wavefront as jax_tw
from coati_tpu.align import engine as jax_engine
from coati_tpu.constants import CODONS61
from coati_tpu.structs import AlignmentParams as JaxAlignmentParams
from coati_tpu.utils import encode_marginal
from coati_tpu_torch import device as device_mod
from coati_tpu_torch import triplet_hmm as torch_hmm
from coati_tpu_torch import triplet_wavefront as tw
from coati_tpu_torch.align import engine, longseq
from coati_tpu_torch.structs import AlignmentParams as TorchAlignmentParams

CPU = torch.device("cpu")
SLOTS = device_mod.UPLOAD_SLOTS


def ragged(seed, B, lo, hi, top=15):
    """B int32 code arrays of lo..hi codes each, views of one buffer as the
    chunk encoder gives them."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, B)
    flat = rng.integers(0, top + 1, int(lens.sum())).astype(np.int32)
    cuts = np.concatenate([[0], np.cumsum(lens)])
    return [flat[cuts[p]:cuts[p + 1]] for p in range(B)]


def same_bytes(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def dirty(staging):
    """Fill every upload slot with a larger chunk of bytes no padding holds,
    so that what a test stages next lands on stale memory."""
    for _ in range(SLOTS):
        for a in staging.stage(((4096,), np.uint8)):
            a[:] = 0xA5


@pytest.mark.parametrize("dtype", [np.int32, np.int8])
@pytest.mark.parametrize("case", ["empty", "one", "ragged", "full"])
def test_fill_rows_equals_the_jax_padding(dtype, case):
    B, lo, hi = {"empty": (0, 1, 1), "one": (1, 5, 5), "ragged": (37, 0, 61),
                 "full": (9, 64, 64)}[case]
    seqs = [s.astype(dtype) for s in ragged(B, B, lo, hi)]
    N = 64
    want, want_lens = jax_engine._pad_rows(seqs, N, dtype=dtype)
    out = np.full((B, N), 0x5A, dtype)
    same_bytes(device_mod.fill_rows(out, seqs), want_lens)
    same_bytes(out, want)


@pytest.mark.parametrize("quantum", [32, 96])
@pytest.mark.parametrize("shape", [(1, 3, 40), (24, 1, 200), (130, 30, 97)])
def test_staged_pad_batch_equals_the_jax_pad_batch(quantum, shape):
    """Through a lane's slots, after larger chunks left their bytes there, and
    round the whole ring: each chunk equals the JAX package's _pad_batch."""
    B, lo, hi = shape
    staging = device_mod.Staging(CPU)
    dirty(staging)
    for turn in range(SLOTS + 1):
        enc_as = ragged(10 * turn + 1, B, lo, hi, top=182)
        enc_bs = ragged(10 * turn + 2, B, lo, hi)
        want = jax_engine._pad_batch(enc_as, enc_bs, quantum)
        got = engine._pad_batch(enc_as, enc_bs, quantum, staging)
        for g, w in zip(got, want):
            same_bytes(g, w)
        for t, g in zip(staging.send(), got):  # on the CPU the staged arrays
            assert t.data_ptr() == g.ctypes.data
            same_bytes(t.numpy(), g)


def test_staged_pad_batch_with_table_idx_offsets():
    """Ancestor codes offset by 183 x the pair's table index, as
    viterbi_align_batch folds a stacked table in."""
    rng = np.random.default_rng(5)
    enc_as = [a + np.int32(183 * int(g)) for a, g in
              zip(ragged(3, 50, 1, 120, top=182), rng.integers(0, 24, 50))]
    enc_bs = ragged(4, 50, 1, 120)
    staging = device_mod.Staging(CPU)
    dirty(staging)
    for g, w in zip(engine._pad_batch(enc_as, enc_bs, 96, staging),
                    jax_engine._pad_batch(enc_as, enc_bs, 96)):
        same_bytes(g, w)


def test_staged_pad_group_equals_the_plain_rows():
    """The long path's group, padded to its maxima: the JAX package's
    _pad_rows at the same widths."""
    enc_as = ragged(7, 5, 300, 900, top=182)
    enc_bs = ragged(8, 5, 250, 1000)
    staging = device_mod.Staging(CPU)
    dirty(staging)
    aseq, bseq, la, lb = longseq._pad_group(enc_as, enc_bs, staging)
    want_a, want_la = jax_engine._pad_rows(enc_as, max(map(len, enc_as)))
    want_b, want_lb = jax_engine._pad_rows(enc_bs, max(map(len, enc_bs)))
    for g, w in zip((aseq, bseq, la, lb), (want_a, want_b, want_la, want_lb)):
        same_bytes(g, w)
    for g, w in zip((aseq, bseq, la, lb), longseq._pad_group(enc_as, enc_bs)):
        same_bytes(g, w)


def triplet_models():
    out = []
    for params, hmm in ((JaxAlignmentParams, jax_hmm), (TorchAlignmentParams, torch_hmm)):
        aln = params()
        aln.model = "tri-mg"
        out.append(hmm.build_triplet_model(aln))
    return out


def triplet_pairs(seed, n, cods=(1, 14), nts=(0, 40)):
    rng = np.random.default_rng(seed)
    return [("".join(rng.choice(CODONS61, size=int(rng.integers(*cods)))),
             "".join(rng.choice(list("ACGTN"), size=int(rng.integers(*nts)))))
            for _ in range(n)]


@pytest.mark.parametrize("n", [1, 9])
def test_staged_pack_batch_equals_the_jax_pack_batch(n):
    """The triplet batch's codes, lengths and insertion offsets, packed into
    a lane's slot over stale bytes: the JAX package's _pack_batch, bit for
    bit (the offsets' f32 cumsum in the same order)."""
    jm, tm = triplet_models()
    pairs = triplet_pairs(n, n)
    jenc = [jax_hmm.encode_triplet_pair(jm, a, d) for a, d in pairs]
    tenc = [torch_hmm.encode_triplet_pair(tm, a, d) for a, d in pairs]
    want = jax_tw._pack_batch(jm, [e[0] for e in jenc], [e[1] for e in jenc])
    staging = device_mod.Staging(CPU)
    dirty(staging)
    got = tw._pack_batch(tm, [e[0] for e in tenc], [e[1] for e in tenc], CPU, staging)
    for g, w in zip(got[:5], want[:5]):
        same_bytes(g, w)
    assert got[6] == want[6]


def test_upload_slots_are_reused_and_grow():
    """Chunks of one shape go round the ring's slots, a slot's buffer the same
    memory each time it comes round; a larger chunk grows its slot, and the
    chunks after it reuse the grown buffer."""
    staging = device_mod.Staging(CPU)
    small = (((8, 96), np.int32), ((8, 96), np.int32), ((8,), np.int32), ((8,), np.int32))
    ptrs = [staging.stage(*small)[0].ctypes.data for _ in range(2 * SLOTS)]
    assert len(set(ptrs)) == SLOTS and ptrs[:SLOTS] == ptrs[SLOTS:]
    sizes = [s.host.numel() for s in staging.uploads]
    big = staging.stage(((64, 960), np.int32))[0]
    assert staging.uploads[0].host.numel() >= big.nbytes > sizes[0]
    grown = staging.uploads[0].host.data_ptr()
    for _ in range(SLOTS):
        staging.stage(*small)
    assert staging.uploads[0].host.data_ptr() == grown
    assert [s.host.numel() for s in staging.uploads[1:]] == sizes[1:]


class Copy:
    """A stand-in for the CUDA event after a slot's copy: records the wait."""

    def __init__(self, log, name):
        self.log, self.name = log, name

    def synchronize(self):
        self.log.append(self.name)


def test_a_slot_is_filled_again_only_after_its_last_copy():
    """stage() waits on a slot's event before it hands the slot out again,
    and on no other slot's."""
    staging = device_mod.Staging(CPU)
    log = []
    for q in range(SLOTS):
        staging.stage(((4,), np.int32))
        staging.uploads[q].event = Copy(log, q)
    assert log == []
    for q in range(SLOTS):
        staging.stage(((4,), np.int32))
        assert log == list(range(q + 1)) and staging.uploads[q].event is None


def test_download_slots_are_held_until_read():
    """A download slot that a reader holds is not handed out again; once the
    reader's block ends it is."""
    staging = device_mod.Staging(CPU)
    first = staging._download_slot()
    first.busy = True
    second = staging._download_slot()
    assert second is not first and staging.downloads == [first, second]
    log = []
    with device_mod.Fetch(["arrays"], Copy(log, "copy"), first) as got:
        assert got == ["arrays"] and log == ["copy"]
    assert staging._download_slot() is first


def marginal_pairs(seed, n, n_long):
    """n pairs of one padded shape at quantum 32 (ancestors of 12-30 nt,
    descendants of 40-64) and n_long with descendants of 100-120 nt."""
    rng = np.random.default_rng(seed)
    out = []
    for p in range(n + n_long):
        anc = "".join(rng.choice(CODONS61, size=int(rng.integers(4, 11))))
        nb = rng.integers(100, 121) if p >= n else rng.integers(40, 65)
        out.append((anc, "".join(rng.choice(list("ACGT"), size=int(nb)))))
    return out


def test_many_chunks_a_lane_equal_the_jax_engine(monkeypatch):
    """Chunks of four pairs, more than the ring's slots on each of two CPU
    lanes, and long pairs through the segmented path's group: strings and
    f32 scores of the JAX package's engine (on one CPU device: fewer chunk
    shapes to compile)."""
    monkeypatch.setenv("COATI_TPU_MAX_DEVICES", "1")
    from coati_tpu.align.engine import viterbi_align_batch as jax_align
    from coati_tpu.models import marginal_p, mg94_p
    from coati_tpu.structs import GapParams as JaxGap
    from coati_tpu_torch.structs import GapParams as TorchGap

    pairs = marginal_pairs(11, 40, 2)
    enc = [encode_marginal(a, b) for a, b in pairs]
    enc_as, enc_bs = [e[0] for e in enc], [e[1] for e in enc]
    a_strs, b_strs = [a for a, _ in pairs], [b for _, b in pairs]
    pi = (0.308, 0.185, 0.199, 0.308)
    table = marginal_p(mg94_p(0.0133, 0.2, pi), pi).astype(np.float32)
    want = jax_align(enc_as, enc_bs, a_strs, b_strs, table, JaxGap(), quantum=32)
    lanes = device_mod.resolve_devices(["cpu", "cpu"])
    got = engine.viterbi_align_batch(enc_as, enc_bs, a_strs, b_strs, table,
                                     TorchGap(), quantum=32,
                                     max_batch_cells=4 * 33 * 65,
                                     long_slots=100, device=lanes)
    assert min(lane.chunks for lane in lanes) > SLOTS
    assert [(r.seq0, r.seq1, np.float32(r.score)) for r in got] == \
        [(r.seq0, r.seq1, np.float32(r.score)) for r in want]


def test_triplet_sub_batches_through_one_lane_equal_the_host_engine(monkeypatch):
    """A triplet batch cut into more sub-batches than the ring has slots, each
    packed into the same lane's staging: the JAX package's host engine's
    alignments, strings equal and scores equal in f32."""
    jm, tm = triplet_models()
    pairs = triplet_pairs(21, 8, cods=(2, 8), nts=(3, 24))
    monkeypatch.setattr(tw, "TRIPLET_BATCH_BYTES", 2 * tw.grid_bytes(8, 24))
    lane = device_mod.lane_of("cpu")
    got = tw.triplet_align_batch(tm, pairs, device=lane)
    assert len(list(tw._sub_batches([torch_hmm.encode_triplet_pair(tm, a, d)
                                      for a, d in pairs]))) > SLOTS
    want = [jax_hmm.triplet_align(jm, a, d) for a, d in pairs]
    assert [(s0, s1, np.float32(sc)) for s0, s1, sc in got] == \
        [(s0, s1, np.float32(sc)) for s0, s1, sc in want]
