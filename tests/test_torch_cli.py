"""coati-tpu-torch CLI against coati-tpu's, byte for byte, on the CPU; the
port's import isolation from jax and from the JAX package; and the
no-silent-fallback guard."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from coati_tpu import cli as jax_cli
from coati_tpu_torch import cli as torch_cli
from coati_tpu_torch.device import resolve_device

REPO = Path(__file__).resolve().parent.parent
PAIR = ">anc\nCTCTGGATAGTG\n>des\nCTATAGTG\n"
ALIGNED = ">anc\nCTCTGGATAGTG\n>des\nCT----ATAGTG\n"
PAIRS = (
    ">a0\nATGAAACCCGGGTTTTAA\n>d0\nATGAAACCGGGTTTTAA\n"
    ">a1\nATGCTCTGGATAGTGCCC\n>d1\nATGCTATAGTGCNC\n"
    ">a2\nATGGGGCCCAAATTTGGGCCC\n>d2\nATGGGGCCCAAAGGGTTTGGGCCC\n"
    ">a3\nATGXXX\n>d3\nATG\n"
)


@pytest.fixture(autouse=True)
def _one_jax_device(monkeypatch):
    monkeypatch.setenv("COATI_TPU_MAX_DEVICES", "1")


def _run_both(tmp_path, name, text, args, out_name):
    src = tmp_path / name
    src.write_text(text)
    outs = []
    for tag, main, extra in (("jax", jax_cli.main, []),
                             ("torch", torch_cli.main, ["--device", "cpu"])):
        out = tmp_path / f"{tag}_{out_name}" if out_name else None
        argv = [args[0], str(src), *args[1:], *extra]
        if out is not None:
            argv += ["-o", str(out)]
        assert main(argv) == 0, tag
        outs.append(out.read_bytes() if out is not None else None)
    return outs


@pytest.mark.parametrize("out_name", ["out.json", "out.fasta"])
def test_alignpair_matches_jax_cli(tmp_path, out_name):
    got_jax, got_torch = _run_both(tmp_path, "pair.fasta", PAIR,
                                   ["alignpair"], out_name)
    assert got_jax == got_torch
    if out_name.endswith(".fasta"):
        assert b"CT----ATAGTG" in got_torch


def test_alignpair_score_matches_jax_cli(tmp_path, capsys):
    src = tmp_path / "aligned.fasta"
    src.write_text(ALIGNED)
    assert jax_cli.main(["alignpair", str(src), "-s"]) == 0
    want = capsys.readouterr().out
    assert torch_cli.main(["alignpair", str(src), "-s", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert float(want) == pytest.approx(1.50913, abs=1e-4)


def test_batch_matches_jax_cli(tmp_path):
    got_jax, got_torch = _run_both(tmp_path, "pairs.fasta", PAIRS,
                                   ["batch"], "out.jsonl")
    assert got_jax == got_torch
    rows = [json.loads(line) for line in got_torch.decode().splitlines()]
    assert [r["pair"] for r in rows if "error" in r] == [3]
    assert sum("alignment" in r for r in rows) == 3


def test_not_ported_verbs_and_models_exit_1(tmp_path, capsys):
    """Every verb, every model and every option is ported now: nothing is
    left to say "not yet ported". What exits 1 is what the JAX package
    refuses too: msa and sample take marginal models only; alignpair takes
    the triplet models. batch --multihost without a coordinator is one
    process and writes what batch writes; batch --trace-dir exits 0, writes
    one trace and the bytes batch writes."""
    src = tmp_path / "pair.fasta"
    src.write_text(PAIR)
    assert sorted(torch_cli.VERBS) == sorted(jax_cli.VERBS)
    for main in (jax_cli.main, torch_cli.main):
        assert main(["msa", str(src), "y", "z", "-m", "tri-mg"]) == 1
        assert "MSA only supports marginal models" in capsys.readouterr().err
        assert main(["sample", str(src), "-m", "tri-mg"]) == 1
        assert "Sampling only available" in capsys.readouterr().err
    out = tmp_path / "tri.fasta"
    assert torch_cli.main(["alignpair", str(src), "-m", "tri-mg",
                           "--device", "cpu", "-o", str(out)]) == 0
    assert "not yet ported" not in capsys.readouterr().err
    assert "CT----ATAGTG" in out.read_text()
    pairs = tmp_path / "pairs.fasta"
    pairs.write_text(PAIRS)
    outs = []
    for name, extra in (("one.jsonl", []), ("multi.jsonl", ["--multihost"])):
        out = tmp_path / name
        assert torch_cli.main(["batch", str(pairs), *extra, "--device", "cpu",
                               "-o", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and outs[0]
    assert (tmp_path / "multi.jsonl.0").read_bytes() == outs[0]
    assert json.loads((tmp_path / "multi.jsonl.scores.json").read_text())["n_pairs"] == 4
    capsys.readouterr()
    traced = tmp_path / "traced.jsonl"
    assert torch_cli.main(["batch", str(pairs), "--trace-dir", str(tmp_path / "tr"),
                           "--device", "cpu", "-o", str(traced)]) == 0
    assert "not yet ported" not in capsys.readouterr().err
    assert traced.read_bytes() == outs[0]
    assert len(list((tmp_path / "tr").glob("*.pt.trace.json"))) == 1


def _msa_inputs(tmp_path):
    """A small tree with distinct branch lengths and its sequences."""
    fasta = tmp_path / "msa.fasta"
    fasta.write_text(">A\nTCATCG\n>B\nTCAGTCG\n>C\nTATCG\n>D\nTCACTCG\n"
                     ">E\nTCATC\n")
    tree = tmp_path / "tree.newick"
    tree.write_text("((((A:0.1,B:0.15):0.1,C:0.12):0.1,D:0.07):0.1,E:0.2);")
    return str(fasta), str(tree)


def test_port_never_imports_jax(tmp_path):
    """Importing the port and its parallel package, aligning one pair with
    alignpair and a stream with batch (and batch --multihost) under a
    marginal and a triplet model (the latter through the batched
    engine and the segmented path too), sampling on both routes and one msa on
    the CPU leaves jax, the JAX
    package coati_tpu and bench out of sys.modules (a subprocess, since this
    test process imports them)."""
    fasta, tree = _msa_inputs(tmp_path)
    msa_out = tmp_path / "msa_out.fasta"
    samples = [tmp_path / "s1.json", tmp_path / "s3.json"]
    src = tmp_path / "pair.fasta"
    src.write_text(PAIR)
    pairs = tmp_path / "pairs.fasta"
    pairs.write_text(PAIRS)
    out = tmp_path / "out.fasta"
    rows = tmp_path / "out.jsonl"
    code = (
        "import sys\n"
        "import coati_tpu_torch\n"
        "import coati_tpu_torch.parallel.dryrun\n"
        "import coati_tpu_torch.parallel.multihost\n"
        "from coati_tpu_torch.cli import main\n"
        f"rc = main(['alignpair', {str(src)!r}, '--device', 'cpu', '-o', {str(out)!r}])\n"
        "assert rc == 0, rc\n"
        f"rc = main(['batch', {str(pairs)!r}, '--device', 'cpu', '-o', {str(rows)!r}])\n"
        "assert rc == 0, rc\n"
        f"rc = main(['batch', {str(pairs)!r}, '--device', 'cpu', '--multihost',\n"
        f"           '-o', {str(tmp_path / 'multi.jsonl')!r}])\n"
        "assert rc == 0, rc\n"
        f"rc = main(['sample', {str(src)!r}, '-n', '3', '-s', '5', '--device', 'cpu',\n"
        f"           '-o', {str(samples[0])!r}])\n"
        "assert rc == 0, rc\n"
        f"rc = main(['alignpair', {str(src)!r}, '-m', 'tri-mg', '--device', 'cpu',\n"
        f"           '-o', {str(tmp_path / 'tri.fasta')!r}])\n"
        "assert rc == 0, rc\n"
        "from coati_tpu_torch import triplet_wavefront\n"
        "triplet_wavefront.TRIPLET_GRID_BUDGET_BYTES = 400\n"
        f"rc = main(['batch', {str(pairs)!r}, '-m', 'tri-mg', '--device', 'cpu',\n"
        f"           '-o', {str(tmp_path / 'tri.jsonl')!r}])\n"
        "assert rc == 0, rc\n"
        "from coati_tpu_torch import driver\n"
        "driver.NATIVE_SAMPLE_CELLS = 0\n"
        f"rc = main(['sample', {str(src)!r}, '-n', '3', '-s', '5', '--device', 'cpu',\n"
        f"           '-o', {str(samples[1])!r}])\n"
        "assert rc == 0, rc\n"
        f"rc = main(['msa', {fasta!r}, {tree!r}, 'A', '--device', 'cpu',\n"
        f"           '-o', {str(msa_out)!r}])\n"
        "assert rc == 0, rc\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'coati_tpu', 'bench'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
    assert "CT----ATAGTG" in out.read_text()
    assert "CT----ATAGTG" in (tmp_path / "tri.fasta").read_text()
    assert len(rows.read_text().splitlines()) == 4
    assert (tmp_path / "multi.jsonl").read_bytes() == rows.read_bytes()
    assert len((tmp_path / "tri.jsonl").read_text().splitlines()) == 4
    assert all(len(json.loads(path.read_text())) == 3 for path in samples)
    assert msa_out.read_text().count(">") == 5


def test_port_sources_import_nothing_of_jax_or_the_jax_package():
    """No *.py of the port, and not chip_smoke.py, imports jax, coati_tpu or
    bench, by an import statement or by name through importlib. Comments and
    docstrings that name the counterpart file are fine."""
    banned = r"(jax|jaxlib|bench|coati_tpu)"
    statement = re.compile(rf"^\s*(from|import)\s+{banned}(\.|\s|,|$)")
    by_name = re.compile(rf"(import_module|__import__)\(\s*['\"]{banned}(\.|['\"])")
    files = sorted((REPO / "coati_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "sweep_shapes.py"]
    assert len(files) > 25
    bad = []
    for path in files:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if statement.search(line) or by_name.search(line):
                bad.append(f"{path.relative_to(REPO)}:{n}: {line.strip()}")
    assert not bad, bad
    assert statement.search("from coati_tpu.utils import x")
    assert statement.search("    import jax")
    assert not statement.search("from coati_tpu_torch.utils import x")


@pytest.mark.parametrize("verb,out_name", [("alignpair", "out.json"),
                                           ("alignpair", "out.fasta"),
                                           ("batch", "out.jsonl")])
def test_long_route_matches_jax_cli(tmp_path, monkeypatch, verb, out_name):
    """Pairs forced through the long-pair route of both packages (the JAX
    package by its slot threshold, the port by its byte budget): the CLIs
    write the same bytes."""
    import numpy as np

    import coati_tpu.align.engine as jax_engine
    from coati_tpu.constants import CODONS61
    from coati_tpu_torch.align import longseq

    rng = np.random.default_rng(17)
    records = []
    for n in range(2 if verb == "batch" else 1):
        anc = "".join(rng.choice(CODONS61, size=110 + 20 * n))
        des = anc[:100] + anc[109:250] + "ACGTTT" + anc[250:]
        records.append(f">a{n}\n{anc}\n>d{n}\n{des}\n")
    monkeypatch.setattr(jax_engine, "LONG_PAIR_SLOTS", 200)
    monkeypatch.setattr(longseq, "BP_BUDGET_BYTES", 60_000)
    calls = []
    real = longseq.align_long_group
    monkeypatch.setattr(longseq, "align_long_group",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got_jax, got_torch = _run_both(tmp_path, "long.fasta", "".join(records),
                                   [verb], out_name)
    assert calls
    assert got_jax == got_torch and got_torch


def test_cuda_request_without_cuda_raises(tmp_path, monkeypatch, capsys):
    """No silent fallback: asking for CUDA where there is none is an error,
    from the device resolver, the engine and the CLI alike."""
    from coati_tpu_torch.align.engine import viterbi_align_batch
    from coati_tpu.structs import GapParams

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        viterbi_align_batch([], [], [], [], [[0.0] * 15], GapParams())
    assert resolve_device("cpu") == torch.device("cpu")
    src = tmp_path / "pair.fasta"
    src.write_text(PAIR)
    out = tmp_path / "out.fasta"
    assert torch_cli.main(["alignpair", str(src), "-o", str(out)]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not out.exists()


def _outputs(tmp_path, jax_argv, torch_extra=(), out_name=None, capsys=None):
    """(coati-tpu's bytes, coati-tpu-torch's) for one command line: of the
    file given to -o, or of stdout."""
    outs = []
    for tag, main, extra in (("jax", jax_cli.main, ()),
                             ("torch", torch_cli.main, torch_extra)):
        argv = [*jax_argv, *extra]
        out = None
        if out_name:
            out = tmp_path / f"{tag}_{out_name}"
            argv += ["-o", str(out)]
        assert main(argv) == 0, tag
        outs.append(out.read_bytes() if out else capsys.readouterr().out.encode())
    return outs


def test_sample_native_route_matches_jax_cli(tmp_path):
    """At most 4,000,000 cells: both CLIs draw the reference's Lehmer64
    stream through their native libraries. The known-good pair with -s 42 is
    byte-equal. On a 510 nt pair with -n 8 -s 11 the sampled alignments are
    byte-equal and the scores agree to 2e-5: the JAX package's checked-in
    library was built with FMA contraction, the port's is not, so a path's
    f32 log probability may differ in its last places."""
    import numpy as np
    from coati_tpu.constants import CODONS61

    src = tmp_path / "cc.fasta"
    src.write_text(">A\nCCCCCC\n>B\nCCCCCCCC\n")
    got_jax, got_torch = _outputs(tmp_path, ["sample", str(src), "-n", "3", "-s", "42"],
                                  ("--device", "cpu"), "cc.json")
    assert got_jax == got_torch
    assert [tuple(r["alignment"].values())[0] for r in json.loads(got_torch)] == \
        ["CC--CCCC", "CCCCCC--", "CCCC--CC"]

    rng = np.random.default_rng(5)
    anc = "".join(rng.choice(np.array(CODONS61), size=170))
    des = anc[:250] + anc[260:]
    src = tmp_path / "mid.fasta"
    src.write_text(f">a\n{anc}\n>b\n{des}\n")
    got_jax, got_torch = _outputs(tmp_path, ["sample", str(src), "-n", "8", "-s", "11"],
                                  ("--device", "cpu"), "mid.json")
    want, got = json.loads(got_jax), json.loads(got_torch)
    assert [r["alignment"] for r in got] == [r["alignment"] for r in want]
    assert len(got) == 8 and got_torch.startswith(b"[\n{\n  \"alignment\"")
    for g, w in zip(got, want):
        assert list(g) == list(w) == ["alignment", "score"]
        assert g["score"] == pytest.approx(w["score"], abs=2e-5)


def test_sample_device_route_on_the_cpu(tmp_path, monkeypatch):
    """sample forced onto the Forward + walk route with --device cpu: valid
    JSON, every sample ungaps to its inputs, one seed gives one output,
    another seed another. Not byte-equal to coati-tpu: the streams differ by
    design."""
    from coati_tpu_torch import driver
    from coati_tpu_torch.align import sample_device

    monkeypatch.setattr(driver, "NATIVE_SAMPLE_CELLS", 0)
    calls = []
    real = sample_device.sample_batch_device
    monkeypatch.setattr(sample_device, "sample_batch_device",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    anc, des = "CCCCCCAAATAA", "CCCCCCCCAANTAA"  # many placements, end stops
    src = tmp_path / "pair.fasta"
    src.write_text(f">anc\n{anc}\n>des\n{des}\n")
    outs = []
    for seed, name in (("11", "a"), ("11", "b"), ("12", "c")):
        out = tmp_path / f"{name}.json"
        assert torch_cli.main(["sample", str(src), "-n", "40", "-s", seed,
                               "--device", "cpu", "-o", str(out)]) == 0
        outs.append(out.read_bytes())
    assert len(calls) == 3
    assert outs[0] == outs[1] and outs[0] != outs[2]
    rows = json.loads(outs[0])
    assert len(rows) == 40
    for r in rows:
        s0, s1 = r["alignment"].values()
        assert len(s0) == len(s1)
        assert s0.replace("-", "") == anc and s1.replace("-", "") == des
        assert r["score"] < 0
    assert len({tuple(r["alignment"].values()) for r in rows}) > 1


def test_sample_without_cuda_fails_whatever_the_size(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "pair.fasta"
    src.write_text(PAIR)
    assert torch_cli.main(["sample", str(src), "-n", "2", "-s", "1"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    fasta, tree = _msa_inputs(tmp_path)
    assert torch_cli.main(["msa", fasta, tree, "A"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_genseed_and_version_match_jax_cli(tmp_path, capsys):
    from test_sample import GENSEED_VECTORS

    for args, expect in GENSEED_VECTORS:
        got_jax, got_torch = _outputs(tmp_path, ["genseed", *args], capsys=capsys)
        assert got_jax == got_torch == (expect + "\n").encode()
    assert torch_cli.main(["genseed"]) == 0  # seeded from the clock
    assert len(capsys.readouterr().out.strip()) == 27
    got_jax, got_torch = _outputs(tmp_path, ["version"], capsys=capsys)
    assert got_torch == got_jax.replace(b"coati-tpu ", b"coati-tpu-torch ")
    assert got_torch.startswith(b"coati-tpu-torch v")


@pytest.mark.parametrize("args,out_name", [
    ([], "out.phy"),
    (["-p"], "out.fasta"),
    (["-p", "-c", "?"], "out.fasta"),
    (["-s", "b", "a"], "out.fasta"),
    (["-x", "2"], "out.json"),
    (["-p", "-c", "N", "-x", "2", "1"], "out.phy"),
])
def test_format_matches_jax_cli(tmp_path, args, out_name):
    src = tmp_path / "in.fasta"
    src.write_text(">a\nAC-GTAC--T\n>b\nACCGTACGGT\n")
    got_jax, got_torch = _outputs(tmp_path, ["format", str(src), *args],
                                  out_name=out_name)
    assert got_jax == got_torch and got_torch
    assert torch_cli.main(["format", str(src), "-c", "?"]) != 0
    assert torch_cli.main(["format", str(src), "-s", "a", "-x", "1"]) != 0


@pytest.mark.parametrize("out_name", ["out.fasta", "out.phy", "out.json"])
def test_msa_matches_jax_cli(tmp_path, out_name):
    fasta, tree = _msa_inputs(tmp_path)
    got_jax, got_torch = _outputs(tmp_path, ["msa", fasta, tree, "A"],
                                  ("--device", "cpu"), out_name)
    assert got_jax == got_torch and got_torch


TRIPLET_PAIR = ">anc\nATGCTCTGGATAGTGCCCTAA\n>des\nATGCTATAGTGCNCTAA\n"
TRIPLET_PAIRS = PAIRS + (
    ">a4\nATGTAACCC\n>d4\nATGCCC\n"      # early stop codon
    ">a5\nATGNCC\n>d5\nATGCC\n"          # ambiguous ancestor
    ">a6\nATGCC\n>d6\nATGCC\n"           # length no multiple of 3
    ">a7\nATGCCC\n>d7\nATGRCC\n"         # a descendant symbol the model lacks
    ">a8\nCTCTGGATAGTG\n>d8\nCTATAGTG\n"
)


@pytest.mark.parametrize("model,out_name", [("tri-mg", "out.json"),
                                            ("tri-mg", "out.fasta"),
                                            ("tri-ecm", "out.json"),
                                            ("dna", "out.phy")])
def test_triplet_alignpair_matches_jax_cli(tmp_path, model, out_name):
    """alignpair under the triplet models, a pair with N and end stop codons:
    the JAX CLI's bytes."""
    got_jax, got_torch = _run_both(tmp_path, "pair.fasta", TRIPLET_PAIR,
                                   ["alignpair", "-m", model], out_name)
    assert got_jax == got_torch and got_torch


@pytest.mark.parametrize("model", ["tri-mg", "tri-ecm", "dna"])
def test_triplet_batch_matches_jax_cli(tmp_path, model):
    """batch under the triplet models, rejects included (the marginal
    stream's bad record, an early stop, an ambiguous ancestor, a length that
    is no multiple of 3, a descendant symbol outside ACGTN): the JAX CLI's
    bytes."""
    got_jax, got_torch = _run_both(tmp_path, "pairs.fasta", TRIPLET_PAIRS,
                                   ["batch", "-m", model], "out.jsonl")
    assert got_jax == got_torch
    rows = [json.loads(line) for line in got_torch.decode().splitlines()]
    assert [r["pair"] for r in rows if "error" in r] == [3, 4, 5, 6, 7]
    assert len({r["error"] for r in rows if "error" in r}) == 4
    assert sum("alignment" in r for r in rows) == 4


def test_triplet_rejects_match_jax_cli(tmp_path, capsys):
    """What triplet_align_driver refuses, it refuses with the JAX CLI's exit
    code and message: -s, an early stop, an ambiguous ancestor, a reference
    whose length is no multiple of 3."""
    cases = [(ALIGNED, ["-s"], "Scoring only works with marginal models"),
             (">a\nATGTAACCC\n>d\nATGCCC\n", [], "Early stop codon"),
             (">a\nATGNCC\n>d\nATGCC\n", [], "Ambiguous nucleotides"),
             (">a\nATGCC\n>d\nATGCC\n", [], "multiple of 3")]
    for n, (text, extra, message) in enumerate(cases):
        src = tmp_path / f"bad{n}.fasta"
        src.write_text(text)
        errs = []
        for main, device in ((jax_cli.main, []), (torch_cli.main, ["--device", "cpu"])):
            assert main(["alignpair", str(src), "-m", "tri-mg", *extra, *device]) == 1
            errs.append(capsys.readouterr().err)
        assert errs[0] == errs[1] and message in errs[1]


@pytest.mark.parametrize("route", ["batch engine", "segmented"])
def test_triplet_routes_match_jax_cli(tmp_path, monkeypatch, route):
    """A 540 nt pair through alignpair -m tri-mg on the batched engine (over
    250,000 nt x nt in both packages) and, with both packages' thresholds
    shrunk, on the segmented path in segments of 11 blocks: each route is
    taken, and the CLIs write the same bytes."""
    import random

    import coati_tpu.triplet_wavefront as jax_tw
    import coati_tpu_torch.triplet_wavefront as torch_tw
    from coati_tpu.constants import CODONS61

    rng = random.Random(3)
    anc = "".join(rng.choice(CODONS61) for _ in range(180))
    des = list(anc)
    for _ in range(30):
        des[rng.randrange(len(des))] = rng.choice("ACGT")
    des = "".join(des)[:200] + "ACGTT" + "".join(des)[200:-9]
    calls = []
    name = "triplet_align_batch" if route == "batch engine" else "triplet_align_long"
    for mod in (jax_tw, torch_tw):
        real = getattr(mod, name)

        def spy(*a, _real=real, _mod=mod.__name__, **kw):
            calls.append(_mod)
            if name == "triplet_align_long":
                kw["seg_cods"] = 11
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    if route == "segmented":
        monkeypatch.setattr(jax_tw, "TRIPLET_LONG_GRID_CELLS", 1000)
        monkeypatch.setattr(torch_tw, "TRIPLET_GRID_BUDGET_BYTES", 15_000)
    got_jax, got_torch = _run_both(tmp_path, "big.fasta", f">1\n{anc}\n>2\n{des}\n",
                                   ["alignpair", "-m", "tri-mg"], "out.json")
    assert calls == ["coati_tpu.triplet_wavefront", "coati_tpu_torch.triplet_wavefront"]
    assert got_jax == got_torch and got_torch


@pytest.mark.parametrize("form", ["--platform cpu", "--platform=cpu", "env"])
def test_platform_cpu_matches_jax_cli(tmp_path, monkeypatch, form):
    """--platform cpu, --platform=cpu and COATI_TPU_FORCE_PLATFORM=cpu are
    stripped from anywhere on the command line and run the port on the CPU
    (no --device given), with coati-tpu's bytes for the same command line;
    --platform tpu or gpu beside --device cpu is accepted."""
    src = tmp_path / "pair.fasta"
    src.write_text(PAIR)
    flag = [] if form == "env" else form.split()
    if form == "env":
        monkeypatch.setenv("COATI_TPU_FORCE_PLATFORM", "cpu")
    outs = []
    for tag, main in (("jax", jax_cli.main), ("torch", torch_cli.main)):
        out = tmp_path / f"{tag}.fasta"
        assert main(["alignpair", *flag, str(src), "-o", str(out)]) == 0, tag
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and b"CT----ATAGTG" in outs[1]
    monkeypatch.delenv("COATI_TPU_FORCE_PLATFORM", raising=False)
    for value in ("tpu", "gpu"):
        out = tmp_path / f"{value}.fasta"
        assert torch_cli.main(["alignpair", str(src), "--platform", value,
                               "--device", "cpu", "-o", str(out)]) == 0
        assert out.read_bytes() == outs[0]
    assert torch_cli._apply_platform(
        ["batch", "in.fa", "--platform", "cpu", "--device", "cuda"]) == [
        "batch", "in.fa", "--device", "cuda"]
    assert torch_cli._apply_platform(["genseed", "--platform=cpu", "42"]) == [
        "genseed", "42"]
