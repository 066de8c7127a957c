"""coati_tpu_torch's msa against the JAX package's on the CPU.

The same sequences and tree go through coati_tpu.msa.msa and
coati_tpu_torch.msa.msa (the plain fill and walk, device "cpu"). Tolerance:
none: the output files are equal byte for byte.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from chip_smoke import make_msa_inputs  # noqa: E402

from coati_tpu.cli import main as jax_main  # noqa: E402
from coati_tpu.msa import msa as jmsa  # noqa: E402
from coati_tpu.structs import AlignmentParams as JAlignmentParams  # noqa: E402
from coati_tpu_torch.align import engine as tengine  # noqa: E402
from coati_tpu_torch.cli import main as torch_main  # noqa: E402
from coati_tpu_torch.io.fasta import read_fasta  # noqa: E402
from coati_tpu_torch.msa import msa as tmsa  # noqa: E402
from coati_tpu_torch.structs import AlignmentParams  # noqa: E402


@pytest.fixture(autouse=True)
def _one_jax_device(monkeypatch):
    monkeypatch.setenv("COATI_TPU_MAX_DEVICES", "1")


def _write_inputs(tmp_path, n_leaves, nt, seed):
    fasta, newick, ref, seqs = make_msa_inputs(n_leaves, nt, seed)
    src, tree = tmp_path / "in.fasta", tmp_path / "tree.newick"
    src.write_text(fasta)
    tree.write_text(newick)
    return str(src), str(tree), ref, seqs


@pytest.mark.parametrize("n_leaves,nt,seed,ext", [(9, 90, 1, "fasta"),
                                                  (9, 90, 1, "phy"),
                                                  (17, 60, 2, "fasta"),
                                                  (4, 150, 3, "json")])
def test_msa_on_a_synthetic_tree_matches_the_jax_package(tmp_path, n_leaves, nt,
                                                         seed, ext):
    """Byte for byte, and every row ungaps to its sequence. The rows need
    not be one length: see chip_smoke.make_msa_inputs."""
    src, tree, ref, seqs = _write_inputs(tmp_path, n_leaves, nt, seed)
    outs = []
    for tag, main, extra in (("jax", jax_main, []),
                             ("torch", torch_main, ["--device", "cpu"])):
        out = tmp_path / f"{tag}.{ext}"
        assert main(["msa", src, tree, ref, "-o", str(out), *extra]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and outs[1]
    if ext == "fasta":
        with open(tmp_path / "torch.fasta") as f:
            data = read_fasta(f)
        assert data.names == list(seqs)
        assert min(len(row) for row in data.seqs) >= nt
        for name, row in zip(data.names, data.seqs):
            assert row.replace("-", "") == seqs[name]


def test_make_msa_inputs_gives_every_leaf_its_own_distance():
    from coati_tpu_torch.msa import tree as treemod

    _, newick, ref, seqs = make_msa_inputs(40, 30, 5)
    tree = treemod.parse_newick(newick)
    treemod.reroot(tree, ref)
    ref_pos = treemod.find_node(tree, ref)
    leaves = [n for n in range(len(tree)) if tree[n].is_leaf and n != ref_pos]
    assert sorted(tree[n].label for n in leaves) == sorted(set(seqs) - {ref})
    dist = [treemod.distance_ref(tree, ref_pos, n) for n in leaves]
    assert len(set(dist)) == 40 and min(dist) > 0


def test_align_leafs_makes_one_engine_call_with_stacked_tables(tmp_path, monkeypatch):
    """One table a distinct branch length, stacked, one table index a leaf
    (coati_tpu/msa/msa.py:62), and the device handed on."""
    src, tree, ref, seqs = _write_inputs(tmp_path, 6, 60, 4)
    calls = []
    real = tengine.viterbi_align_batch

    def spy(enc_as, enc_bs, a_strs, b_strs, table, gap, **kw):
        calls.append((np.asarray(table).shape, list(kw["table_idx"]), kw["device"]))
        return real(enc_as, enc_bs, a_strs, b_strs, table, gap, **kw)

    monkeypatch.setattr(tengine, "viterbi_align_batch", spy)
    aln = AlignmentParams()
    aln.data.path, aln.tree, aln.refs = src, tree, ref
    aln.output = str(tmp_path / "out.fasta")
    assert tmsa.ref_indel_alignment(aln, device="cpu")
    assert calls == [((6, 183, 15), list(range(6)), "cpu")]


def test_msa_refuses_what_the_jax_package_refuses(tmp_path):
    src = tmp_path / "two.fasta"
    src.write_text(">A\nTCATCG\n>B\nTCAGTCG\n")
    tree = tmp_path / "t.newick"
    tree.write_text("(A:0.1,B:0.2);")
    for mod, cls, kw in ((jmsa, JAlignmentParams, {}),
                         (tmsa, AlignmentParams, {"device": "cpu"})):
        aln = cls()
        aln.data.path, aln.tree, aln.refs = str(src), str(tree), "A"
        with pytest.raises(ValueError, match="At least three sequences"):
            mod.ref_indel_alignment(aln, **kw)
        aln = cls(model="tri-mg")
        with pytest.raises(ValueError, match="marginal"):
            mod.ref_indel_alignment(aln, **kw)
