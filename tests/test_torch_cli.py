"""coati-tpu-torch CLI against coati-tpu's, byte for byte, on the CPU; the
port's import isolation from jax; and the no-silent-fallback guard."""

import json
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
    """Importing the port and aligning one pair on the CPU leaves jax out of
    sys.modules (a subprocess, since this test process imports jax)."""
    src = tmp_path / "pair.fasta"
    src.write_text(PAIR)
    out = tmp_path / "out.fasta"
    code = (
        "import sys\n"
        "import coati_tpu_torch\n"
        "from coati_tpu_torch.cli import main\n"
        f"rc = main(['alignpair', {str(src)!r}, '--device', 'cpu', '-o', {str(out)!r}])\n"
        "assert rc == 0, rc\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
    assert "CT----ATAGTG" in out.read_text()


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
