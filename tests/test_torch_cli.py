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
    assert torch_cli.main(["msa", "x", "y", "z"]) == 1
    assert "not yet ported" in capsys.readouterr().err
    src = tmp_path / "pair.fasta"
    src.write_text(PAIR)
    assert torch_cli.main(["alignpair", str(src), "-m", "tri-mg",
                           "--device", "cpu"]) == 1
    assert "not yet ported" in capsys.readouterr().err
    assert torch_cli.main(["batch", str(src), "--multihost",
                           "--device", "cpu"]) == 1
    assert "not yet ported" in capsys.readouterr().err


def test_port_never_imports_jax(tmp_path):
    """Importing the port, aligning one pair with alignpair and a stream with
    batch on the CPU leaves jax, the JAX package coati_tpu and bench out of
    sys.modules (a subprocess, since this test process imports them)."""
    src = tmp_path / "pair.fasta"
    src.write_text(PAIR)
    pairs = tmp_path / "pairs.fasta"
    pairs.write_text(PAIRS)
    out = tmp_path / "out.fasta"
    rows = tmp_path / "out.jsonl"
    code = (
        "import sys\n"
        "import coati_tpu_torch\n"
        "from coati_tpu_torch.cli import main\n"
        f"rc = main(['alignpair', {str(src)!r}, '--device', 'cpu', '-o', {str(out)!r}])\n"
        "assert rc == 0, rc\n"
        f"rc = main(['batch', {str(pairs)!r}, '--device', 'cpu', '-o', {str(rows)!r}])\n"
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
    assert len(rows.read_text().splitlines()) == 4


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
