"""Golden results of the JAX reference on main-path and long-path pairs,
shared with chip_smoke.py.

tests/data/torch_main_path_golden.json holds, for the first 8 pairs of each
length class of the main-path batch (bench.py's make_pairs, seed 0), the
score and a sha256 of the aligned strings that coati_tpu's batch_align
gives on XLA:CPU. This test recomputes them with the JAX package, so the
file stays the reference's, and holds the port's CPU path to them;
chip_smoke.py holds the port's CUDA path to the same file.

tests/data/torch_long_path_golden.json holds the same for three pairs of
2,997 nt (chip_smoke's long_golden_pairs) forced through the long-pair route
of coati_tpu's viterbi_align_batch with long_slots=LONG_GOLDEN_SLOTS.

tests/data/torch_msa_golden.json holds the size and a sha256 of the FASTA
that coati_tpu's msa verb writes for chip_smoke's make_msa_inputs at
MSA_GOLDEN_SHAPE (12 leaves with 12 different distances to a 300 nt
reference).

tests/data/torch_triplet_golden.json holds the score and a sha256 of the
aligned strings that coati_tpu's batch_align gives under tri-mg for
chip_smoke's triplet_golden_pairs (24 pairs of 156 and 471 nt).

Regenerate with: JAX_PLATFORMS=cpu python tests/test_torch_golden.py
"""

import importlib
import io
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from chip_smoke import (  # noqa: E402
    GOLDEN,
    LENGTH_MIX,
    LONG_GOLDEN,
    LONG_GOLDEN_SLOTS,
    MSA_GOLDEN,
    MSA_GOLDEN_SHAPE,
    TRIPLET_GOLDEN,
    golden_record,
    long_golden_pairs,
    long_golden_record,
    make_msa_inputs,
    make_pairs,
    msa_golden_record,
    triplet_golden_pairs,
)

PER_CLASS = 8


def golden_pairs(seed=0):
    """(indices, named pairs) of the first PER_CLASS pairs of each length
    class in the seed's make_pairs stream."""
    rng = np.random.default_rng(seed)
    pairs, by_len = [], {}
    while min((len(by_len.get(L, [])) for L, _ in LENGTH_MIX)) < PER_CLASS:
        (a, b), = make_pairs(1, rng, length_mix=LENGTH_MIX)
        by_len.setdefault(len(a), []).append(len(pairs))
        pairs.append((a, b))
    idx = sorted(i for L, _ in LENGTH_MIX for i in by_len[L][:PER_CLASS])
    return idx, [(f"anc{i}", pairs[i][0], f"des{i}", pairs[i][1]) for i in idx]


def records_of(batch_align, idx, named, model="mar-mg", **kw):
    """Golden records of `named` through one package's batch_align, with
    that package's own AlignmentParams, defaults but for the model."""
    package = batch_align.__module__.split(".")[0]
    aln = importlib.import_module(f"{package}.structs").AlignmentParams(model=model)
    out = io.StringIO()
    batch_align(aln, named, out, **kw)
    rows = [json.loads(line) for line in out.getvalue().splitlines()]
    return [golden_record(i, row) for i, row in zip(idx, rows)]


def test_golden_is_the_reference_and_the_port_meets_it(monkeypatch):
    from coati_tpu.batchrun import batch_align as jax_batch_align
    from coati_tpu_torch.batchrun import batch_align as torch_batch_align

    monkeypatch.setenv("COATI_TPU_MAX_DEVICES", "1")
    golden = json.loads(GOLDEN.read_text())
    idx, named = golden_pairs(golden["seed"])
    assert [r["index"] for r in golden["pairs"]] == idx
    assert records_of(jax_batch_align, idx, named) == golden["pairs"]
    assert records_of(torch_batch_align, idx, named, device="cpu") == golden["pairs"]


def test_golden_pairs_follow_the_main_path_stream():
    """make_pairs draws pair by pair, so the golden indices name the same
    pairs in chip_smoke's 10,000-pair batch."""
    idx, named = golden_pairs(0)
    whole = make_pairs(idx[-1] + 1, np.random.default_rng(0), length_mix=LENGTH_MIX)
    assert [(a, b) for _, a, _, b in named] == [whole[i] for i in idx]


def test_make_pairs_is_the_benchs():
    """chip_smoke's own make_pairs gives bench.py's pairs for equal seeds,
    on the main path's mix and on a long class."""
    import bench

    for seed, n, mix in ((0, 300, LENGTH_MIX), (1, 2, [(2997, 0.5), (4500, 0.5)])):
        want = bench.make_pairs(n, np.random.default_rng(seed), length_mix=mix)
        assert make_pairs(n, np.random.default_rng(seed), length_mix=mix) == want


def long_records(viterbi_align_batch, encode_marginal, table, gap, seed, **kw):
    pairs = long_golden_pairs(seed)
    enc = [encode_marginal(a, b) for a, b in pairs]
    res = viterbi_align_batch(
        [e[0] for e in enc], [e[1] for e in enc], [a for a, _ in pairs],
        [b for _, b in pairs], table, gap, long_slots=LONG_GOLDEN_SLOTS, **kw)
    return [long_golden_record(i, r) for i, r in enumerate(res)]


def test_long_golden_is_the_reference_and_the_port_meets_it(mg94_table, monkeypatch):
    from coati_tpu.align.engine import viterbi_align_batch as jax_align
    from coati_tpu.structs import GapParams
    from coati_tpu.utils import encode_marginal as jax_encode
    from coati_tpu_torch.align.engine import viterbi_align_batch as torch_align
    from coati_tpu_torch.structs import GapParams as TorchGapParams
    from coati_tpu_torch.utils import encode_marginal as torch_encode

    monkeypatch.setenv("COATI_TPU_MAX_DEVICES", "1")
    golden = json.loads(LONG_GOLDEN.read_text())
    want = golden["pairs"]
    assert long_records(jax_align, jax_encode, mg94_table, GapParams(),
                        golden["seed"]) == want
    assert long_records(torch_align, torch_encode, mg94_table, TorchGapParams(),
                        golden["seed"], device="cpu") == want


def triplet_records(batch_align, seed, **kw):
    named = triplet_golden_pairs(seed)
    return records_of(batch_align, range(len(named)), named, model="tri-mg", **kw)


def test_triplet_golden_is_the_reference_and_the_port_meets_it(monkeypatch):
    from coati_tpu.batchrun import batch_align as jax_batch_align
    from coati_tpu_torch.batchrun import batch_align as torch_batch_align

    monkeypatch.setenv("COATI_TPU_MAX_DEVICES", "1")
    golden = json.loads(TRIPLET_GOLDEN.read_text())
    assert len(golden["pairs"]) == 24
    assert triplet_records(jax_batch_align, golden["seed"]) == golden["pairs"]
    assert triplet_records(torch_batch_align, golden["seed"],
                           device="cpu") == golden["pairs"]


def msa_record(cli_main, seed, tmp, extra=()):
    """Golden record of one package's msa verb on the golden tree."""
    fasta, newick, ref, _ = make_msa_inputs(*MSA_GOLDEN_SHAPE, seed)
    src, tree, out = (Path(tmp) / name for name in ("in.fasta", "t.newick", "out.fasta"))
    src.write_text(fasta)
    tree.write_text(newick)
    assert cli_main(["msa", str(src), str(tree), ref, "-o", str(out), *extra]) == 0
    return msa_golden_record(out.read_text())


def test_msa_golden_is_the_reference_and_the_port_meets_it(tmp_path, monkeypatch):
    from coati_tpu.cli import main as jax_main
    from coati_tpu_torch.cli import main as torch_main

    monkeypatch.setenv("COATI_TPU_MAX_DEVICES", "1")
    golden = json.loads(MSA_GOLDEN.read_text())
    assert golden["record"]["rows"] == MSA_GOLDEN_SHAPE[0] + 1
    assert msa_record(jax_main, golden["seed"], tmp_path) == golden["record"]
    assert msa_record(torch_main, golden["seed"], tmp_path,
                      ("--device", "cpu")) == golden["record"]


if __name__ == "__main__":
    import tempfile

    from coati_tpu.cli import main as jax_main

    with tempfile.TemporaryDirectory() as tmp:
        MSA_GOLDEN.write_text(json.dumps({
            "source": "coati_tpu.cli msa on XLA:CPU, mar-mg defaults, "
                      f"chip_smoke.make_msa_inputs{MSA_GOLDEN_SHAPE}, seed 8",
            "seed": 8,
            "record": msa_record(jax_main, 8, tmp),
        }, indent=1) + "\n")
    print(f"wrote {MSA_GOLDEN}")

    from coati_tpu.align.engine import viterbi_align_batch as jax_align
    from coati_tpu.batchrun import batch_align as jax_batch_align
    from coati_tpu.models import marginal_p, mg94_p
    from coati_tpu.structs import GapParams
    from coati_tpu.utils import encode_marginal as jax_encode

    pi = (0.308, 0.185, 0.199, 0.308)
    table = marginal_p(mg94_p(0.0133, 0.2, pi), pi).astype(np.float32)
    LONG_GOLDEN.write_text(json.dumps({
        "source": "coati_tpu.align.engine.viterbi_align_batch on XLA:CPU, "
                  f"mar-mg defaults, long_slots={LONG_GOLDEN_SLOTS}, "
                  "chip_smoke.long_golden_pairs, seed 7",
        "seed": 7,
        "pairs": long_records(jax_align, jax_encode, table, GapParams(), 7),
    }, indent=1) + "\n")
    print(f"wrote {LONG_GOLDEN}")

    TRIPLET_GOLDEN.write_text(json.dumps({
        "source": "coati_tpu.batchrun.batch_align on XLA:CPU, tri-mg defaults, "
                  "chip_smoke.triplet_golden_pairs, seed 16",
        "seed": 16,
        "pairs": triplet_records(jax_batch_align, 16),
    }, indent=1) + "\n")
    print(f"wrote {TRIPLET_GOLDEN}")

    idx, named = golden_pairs(0)
    GOLDEN.write_text(json.dumps({
        "source": "coati_tpu.batchrun.batch_align on XLA:CPU, mar-mg defaults, "
                  "bench.py make_pairs, seed 0",
        "seed": 0,
        "pairs": records_of(jax_batch_align, idx, named),
    }, indent=1) + "\n")
    print(f"wrote {len(idx)} records to {GOLDEN}")
