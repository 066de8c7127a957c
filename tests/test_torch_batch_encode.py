"""The batch stream's one-pass chunk encoder (batchrun.encode_marginal_chunk)
against the per-pair encoding it replaced, on the CPU.

Seeded pairs with bad ones mixed in (a length that is not a multiple of 3,
an ambiguous ancestor, an early stop, a character no code takes, text that
is not ASCII, terminal stops on either side) go through the chunk encoder,
through the port's per-pair route (SeqData, trim_end_stops, encode_marginal)
and through the JAX package's utils: every code array, trimmed string and
stop is equal, and the encoder leaves out exactly the pairs on which
encode_marginal raises. batch_align writes the JAX package's bytes, stream
and manifest, at chunks of 1, 7 and 2,048 pairs and on a resumed run.
"""

from __future__ import annotations

import io

import numpy as np
import pytest

from coati_tpu import batchrun as jax_batchrun
from coati_tpu import utils as jax_utils
from coati_tpu.structs import AlignmentParams as JaxAlignmentParams
from coati_tpu.structs import SeqData as JaxSeqData
from coati_tpu_torch import batchrun, utils
from coati_tpu_torch.structs import AlignmentParams, SeqData
from coati_tpu_torch.tools.inputs import make_pairs


@pytest.fixture(autouse=True)
def _one_jax_device(monkeypatch):
    monkeypatch.setenv("COATI_TPU_MAX_DEVICES", "1")


def mixed_pairs(seed: int, n: int = 24) -> list:
    """n seeded pairs of 12-60 nt, every other one edited by the next of
    `edits` in turn (made bad, given terminal stops, an ambiguous
    descendant), then short pairs and faults at a sequence's first place."""
    rng = np.random.default_rng(seed)
    pairs = make_pairs(n, rng, length_mix=[(12, 0.3), (33, 0.4), (60, 0.3)])
    edits = [
        lambda a, d: (a[:-1], d),                         # length not a multiple of 3
        lambda a, d: (a[:3] + "ANC" + a[6:], d),          # N in the ancestor
        lambda a, d: (a[:3] + "TGA" + a[6:], d),          # an early stop
        lambda a, d: (a, d[:2] + "X" + d[3:]),            # no code takes X
        lambda a, d: (a[:4] + "é" + a[5:], d),            # not ASCII, ancestor
        lambda a, d: (a, d + "ß"),                        # not ASCII, descendant
        lambda a, d: (a + "TAA", d),                      # terminal stops
        lambda a, d: (a, d + "tag"),
        lambda a, d: (a + "uga", d + "TAG"),
        lambda a, d: (a + "TAG", d[:-1] + "TAA"),
        lambda a, d: (a[:3] + "TAA" + a[6:] + "TAA", d),  # early and terminal
        lambda a, d: (a, "RYN-" + d),                     # ambiguous descendant: valid
    ]
    for k, i in enumerate(range(0, n, 2)):
        a, d = pairs[i]
        pairs[i] = edits[k % len(edits)](a, d)
    pairs += [("", ""), ("TAA", "TA"), ("ATG", ""), ("", "TGA"), ("TA", "ATG"),
              ("AAATAA", "AAATAA"), ("AAA-CC", "AAA"), ("ATG", "ATG"),
              ("NAAAAA", "AAA"), ("ATG", "ATG"), ("TGAAAA", "AAA"), ("ATG", "ATG"),
              ("AAA", "*AA"), ("ATG", "ATG")]
    return pairs


def per_pair(seqdata, mod, a: str, d: str):
    """The per-pair route through `mod`'s utils: (enc_a, enc_b, trimmed
    strings, stops), or the text of the ValueError it raises."""
    data = seqdata(names=["a", "d"], seqs=[a, d])
    mod.trim_end_stops(data)
    try:
        ea, eb = mod.encode_marginal(data.seqs[0], data.seqs[1])
    except ValueError as exc:
        return str(exc)
    return ea, eb, data.seqs[0], data.seqs[1], data.stops


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_chunk_encoder_equals_encode_marginal(seed):
    pairs = mixed_pairs(seed)
    got = batchrun.encode_marginal_chunk(pairs)
    assert len(got) == len(pairs)
    n_bad = 0
    for p, ((a, d), g) in enumerate(zip(pairs, got)):
        want = per_pair(SeqData, utils, a, d)
        jax_want = per_pair(JaxSeqData, jax_utils, a, d)
        if isinstance(want, str):
            assert jax_want == want and g is None, (p, want)
            n_bad += 1
            continue
        assert g is not None, p
        for w in (want, jax_want):
            for x, y in zip(g[:2], w[:2]):
                assert x.dtype == y.dtype and np.array_equal(x, y), p
            assert list(g[2:4]) == list(w[2:4]) and list(g[4]) == list(w[4]), p
    assert n_bad >= 8
    kept = [g for g in got if g is not None]
    assert all(g[0].base is kept[0][0].base and g[1].base is kept[0][1].base for g in kept)


def run_batch(mod, aln, pairs, chunk, manifest=""):
    out = io.StringIO()
    if mod is batchrun:
        mod.batch_align(aln, pairs, out, manifest=manifest, chunk=chunk, device="cpu")
    else:
        mod.batch_align(aln, pairs, out, manifest=manifest, chunk=chunk)
    return out.getvalue()


@pytest.mark.parametrize("chunk", [1, 7, 2048])
def test_batch_bytes_equal_the_jax_package(chunk):
    named = [(f"a{i}", a, f"d{i}", d) for i, (a, d) in enumerate(mixed_pairs(5, 16))]
    got = run_batch(batchrun, AlignmentParams(), named, chunk)
    want = run_batch(jax_batchrun, JaxAlignmentParams(), named, chunk)
    assert got == want
    rows = got.splitlines()
    assert len(rows) == len(named)
    assert sum('"error"' in r for r in rows) >= 6
    assert any('---"' in r for r in rows)  # a stop on one side only


def test_resumed_batch_bytes_equal_the_jax_package(tmp_path):
    named = [(f"a{i}", a, f"d{i}", d) for i, (a, d) in enumerate(mixed_pairs(6, 16))]
    outs = []
    for tag, mod, aln in (("torch", batchrun, AlignmentParams()),
                          ("jax", jax_batchrun, JaxAlignmentParams())):
        manifest = tmp_path / f"{tag}.txt"
        manifest.write_text("0\n3\n4\n10\n21\n")
        outs.append((run_batch(mod, aln, named, 7, str(manifest)), manifest.read_bytes()))
    assert outs[0] == outs[1]
    done = [int(x) for x in outs[0][1].split()]
    assert sorted(done) == list(range(len(named)))
    assert '"pair": 3,' not in outs[0][0] and len(outs[0][0].splitlines()) == len(named) - 5
