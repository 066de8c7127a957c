"""The port's tools (coati_tpu_torch/tools) and source hash
(coati_tpu_torch/provenance.py) on the CPU, and the freshness of the
evidence they wrote on the card.

The seeded generators draw the JAX tools' pairs; every tool runs on
--device cpu at a few tiny pairs and refuses cuda where there is none; the
two checked-in files tests/data/torch_gpu_parity.json and
torch_gpu_longpair.json were made on an H100 from the current sources
(their kernel_hash), and the long pairs' scores equal LONGPAIR.json's TPU
scores for the same seeded pairs."""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from coati_tpu_torch import provenance
from coati_tpu_torch.tools import (
    gpu_parity_check,
    inputs,
    probe_kernel,
    probe_triplet,
    profile_batch,
    run_longpair,
)

REPO = Path(__file__).resolve().parent.parent
PARITY = REPO / "tests" / "data" / "torch_gpu_parity.json"
LONGPAIR = REPO / "tests" / "data" / "torch_gpu_longpair.json"


def _load_jax_tool(name):
    """tools/<name>.py as a module, the environment as it was before: the
    long-pair tool sets COATI_TPU_FORCE_PLATFORM when it is imported."""
    saved = os.environ.get("COATI_TPU_FORCE_PLATFORM")
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if saved is None:
            os.environ.pop("COATI_TPU_FORCE_PLATFORM", None)
        else:
            os.environ["COATI_TPU_FORCE_PLATFORM"] = saved
    return mod


def test_parity_groups_draw_the_tpu_artifacts_pairs():
    """gpu_parity_check's first four groups are tools/tpu_parity_check.py's
    (TPU_PARITY.json's 264 pairs), drawn in its order from its seed, and the
    groups after them cover k = 2 to 9 with lengths alignpair accepts."""
    from coati_tpu.constants import CODONS61

    jt = _load_jax_tool("tpu_parity_check")
    rng = np.random.default_rng(gpu_parity_check.SEED)
    want = [jt.make_group(rng, 80, 1, 40), jt.make_group(rng, 24, 3, 30),
            jt.make_group(rng, 128, 1, 22, ambig_frac=0.0)]
    codon_arr, nts = np.array(CODONS61), np.array(list("ACGT"))
    tri = []
    for _ in range(32):
        n_cod = int(rng.integers(2, 16))
        anc = "".join(rng.choice(codon_arr, size=n_cod))
        tri.append((anc, "".join(rng.choice(nts, size=int(rng.integers(3, 3 * n_cod + 4))))))
    want.append(tri)
    groups = gpu_parity_check.draw_groups(np.random.default_rng(gpu_parity_check.SEED))
    assert [g[2] for g in groups[:4]] == want
    assert sum(len(p) for p in want) == 264
    assert [g[1] for g in groups] == [1, 3, 1, None, 2, 4, 5, 6, 7, 8, 9]
    for _, k, pairs in groups[4:]:
        assert len(pairs) == gpu_parity_check.EXTRA_PAIRS
        assert all(len(a) % 3 == 0 and len(a) % k == 0 and len(d) % k == 0
                   for a, d in pairs)


@pytest.mark.parametrize("n_codons", [30, 2667])
def test_make_pair_draws_the_jax_tools_pair(n_codons):
    jr = _load_jax_tool("run_longpair")
    seed = 20260819 + n_codons
    assert inputs.make_pair(np.random.default_rng(seed), n_codons) == \
        jr.make_pair(np.random.default_rng(seed), n_codons)


def test_make_pairs_is_chip_smokes_and_the_bench_mix():
    import chip_smoke

    assert chip_smoke.make_pairs is inputs.make_pairs
    assert chip_smoke.LENGTH_MIX == inputs.LENGTH_MIX
    assert [l for l, _ in inputs.LENGTH_MIX] == [156, 471, 999, 1500]


def test_gpu_parity_check_on_the_cpu():
    v = gpu_parity_check.run("cpu", per_group=2)
    assert v["ok"] and v["n_mismatches"] == 0 and v["n_pairs"] == 22
    assert v["device"] == "cpu" and v["kernel_hash"] == provenance.kernel_hash()
    assert [g["group"] for g in v["groups"]][:4] == [
        "scattered-k1", "scattered-k3", "stacked-k1", "triplet"]
    assert v["max_score_diff"] <= gpu_parity_check.SCORE_TOL


def test_run_longpair_on_the_cpu_through_the_long_path(monkeypatch):
    """Small pairs forced down the segmented path by a small byte budget:
    the record holds LONGPAIR.json's fields, and the scores are those of the
    unforced route."""
    from coati_tpu_torch.align import longseq

    plain = run_longpair.run("cpu", (40, 70))
    monkeypatch.setattr(longseq, "BP_BUDGET_BYTES", 4096)
    groups = []
    real = longseq.enqueue_long_group

    def spy(enc_as, *args, **kw):
        groups.append(len(enc_as))
        return real(enc_as, *args, **kw)

    monkeypatch.setattr(longseq, "enqueue_long_group", spy)
    forced = run_longpair.run("cpu", (40, 70))
    assert groups == [1, 1, 1, 1]  # each pair cold and warm
    runs = [plain["runs"], forced["runs"]]
    want = json.loads((REPO / "LONGPAIR.json").read_text())["runs"][0]
    for r in runs[1]:
        assert set(want) <= set(r)
        assert r["nt"] in (120, 210) and r["device"] == "cpu"
        assert r["max_memory_allocated"] is None
    assert [(r["score"], r["aligned_len"]) for r in runs[0]] == \
        [(r["score"], r["aligned_len"]) for r in runs[1]]
    assert plain["kernel_hash"] == provenance.kernel_hash()


def test_profile_batch_on_the_cpu():
    out = profile_batch.run("cpu", 12, 1, length_mix=[(60, 0.5), (90, 0.5)])
    (rep,) = out["passes"]
    assert out["device"] == "cpu" and rep["pairs"] == 12
    assert rep["chunks"] == len(rep["by_chunk"]) >= 2
    assert sum(c["pairs"] for c in rep["by_chunk"]) == 12
    assert all(rep[k] >= 0 for k in ("encode_s", "prep_s", "launch_s", "strings_s"))


def test_probe_kernel_on_the_cpu(capsys):
    assert probe_kernel.main(["--device", "cpu", "--shapes", "24x30x2", "--reps", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["stage"] for r in out["rows"]] == ["full", "fill+bp", "score"]
    assert all(r["shape"] == [24, 30, 2] and r["ms"] > 0 for r in out["rows"])


def test_probe_triplet_on_the_cpu(capsys):
    assert probe_triplet.main(["--device", "cpu", "--nt", "60", "--n", "3", "--reps", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out["ms"]) == ["encode", "pack", "rows", "walk", "fetch", "decode",
                               "end to end"]


@pytest.mark.parametrize("tool", [gpu_parity_check, run_longpair, profile_batch,
                                  probe_kernel, probe_triplet])
def test_tools_refuse_cuda_where_there_is_none(tool, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--device", "cuda"]
    if tool in (gpu_parity_check, run_longpair):
        argv += ["-o", str(tmp_path / "out.json")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv)
    assert not (tmp_path / "out.json").exists()


def test_kernel_hash_covers_every_listed_file():
    files = provenance.kernel_files()
    pkg = REPO / "coati_tpu_torch"
    want = {p.relative_to(REPO).as_posix() for pattern in
            ("csrc/*.cu", "csrc/*.cuh", "csrc/pairhmm.cc", "kernels/*.py")
            for p in pkg.glob(pattern)}
    want |= {f"coati_tpu_torch/{m}" for m in (
        "align/wavefront.py", "align/engine.py", "align/longseq.py", "align/semiring.py",
        "align/sample_device.py", "triplet_hmm.py", "triplet_wavefront.py")}
    assert set(files) == want and len(files) == len(want)
    assert "coati_tpu_torch/csrc/wavefront_fill.cu" in files
    assert "coati_tpu_torch/kernels/_build.py" in files


@pytest.fixture(scope="module")
def source_copy(tmp_path_factory):
    """The listed files and one that is not, copied under a fresh root."""
    root = tmp_path_factory.mktemp("src")
    for rel in provenance.kernel_files() + ["coati_tpu_torch/cli.py"]:
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(REPO / rel, root / rel)
    return root


@pytest.mark.parametrize("rel", [
    "coati_tpu_torch/csrc/wavefront_fill.cu", "coati_tpu_torch/csrc/common.cuh",
    "coati_tpu_torch/csrc/pairhmm.cc", "coati_tpu_torch/kernels/_build.py",
    "coati_tpu_torch/align/engine.py", "coati_tpu_torch/triplet_wavefront.py"])
def test_kernel_hash_changes_with_one_byte(source_copy, rel):
    base = provenance.kernel_hash(source_copy)
    assert base == provenance.kernel_hash(REPO)
    path = source_copy / rel
    data = path.read_bytes()
    try:
        path.write_bytes(data[:-1] + bytes([data[-1] ^ 1]))
        assert provenance.kernel_hash(source_copy) != base
    finally:
        path.write_bytes(data)
    assert provenance.kernel_hash(source_copy) == base


def test_kernel_hash_ignores_unlisted_files(source_copy):
    base = provenance.kernel_hash(source_copy)
    path = source_copy / "coati_tpu_torch" / "cli.py"
    data = path.read_bytes()
    try:
        path.write_bytes(data + b"\n")
        assert provenance.kernel_hash(source_copy) == base
    finally:
        path.write_bytes(data)


def test_gpu_parity_artifact_is_current():
    """tests/data/torch_gpu_parity.json, made on an H100 by gpu_parity_check
    from the current sources: every pair equal to the oracles, k = 1 to 9
    and tri-mg."""
    v = json.loads(PARITY.read_text())
    assert v["ok"] and v["n_mismatches"] == 0 and not v["mismatches"], v["mismatches"]
    assert v["n_pairs"] >= 264 + 168
    assert "H100" in v["device"]
    assert {g["k"] for g in v["groups"]} == {None, *range(1, 10)}
    assert all(g["n_mismatches"] == 0 for g in v["groups"])
    assert v["kernel_hash"] == provenance.kernel_hash(), (
        "kernel sources changed since torch_gpu_parity.json was made: regenerate it on "
        "the card: python -m coati_tpu_torch.tools.gpu_parity_check")


def test_gpu_longpair_artifact_is_current():
    blob = json.loads(LONGPAIR.read_text())
    assert blob["kernel_hash"] == provenance.kernel_hash(), (
        "kernel sources changed since torch_gpu_longpair.json was made: regenerate it "
        "on the card: python -m coati_tpu_torch.tools.run_longpair")
    by_nt = {r["nt"]: r for r in blob["runs"]}
    assert set(by_nt) == {32001, 160002}
    for r in blob["runs"]:
        assert "H100" in r["device"]
        assert r["wall_seconds"] > 0 and np.isfinite(r["score"])
        assert r["cells"] >= (r["nt"] - 2000) ** 2
        # bounded memory: far below the 3-matrix full DP (3 * nt^2 * 4 bytes)
        assert 0 < r["max_memory_allocated"] < 3 * r["nt"] ** 2 * 4 / 4


def test_gpu_longpair_scores_equal_the_tpu_scores():
    """The same seeded pairs score on the H100 as LONGPAIR.json's on the TPU,
    within 1e-4 x |score|."""
    tpu = {r["nt"]: r for r in json.loads((REPO / "LONGPAIR.json").read_text())["runs"]}
    gpu = {r["nt"]: r for r in json.loads(LONGPAIR.read_text())["runs"]}
    assert set(gpu) == set(tpu)
    for nt, r in gpu.items():
        assert r["nt_des"] == tpu[nt]["nt_des"]
        assert abs(r["score"] - tpu[nt]["score"]) <= 1e-4 * abs(tpu[nt]["score"])
