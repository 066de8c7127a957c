"""Multi-process batch runs of the port: two real torch.distributed (gloo)
processes of `coati-tpu-torch batch --multihost --device cpu`, each aligning
its contiguous shard, merged by process 0. The merged file must equal a
one-process run byte for byte, and the allgathered score manifest must match
its rows, under a marginal model and under tri-mg with a rejected pair in
each process's shard (the JAX package's two-process test runs the marginal
model only).

A batch writes a chunk's rejected pairs before its alignments, in this
package as in the JAX package, so where a later shard holds a rejected pair
the merged rows come in another order than one process's. There every row
must equal one process's row for its pair, byte for byte.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

MARGINAL_PAIRS = """>anc0
CTCTGGATAGTG
>des0
CTATAGTG
>anc1
GCGATTGCTGTT
>des1
GCGACTGTT
>anc2
AAACCCGGGTTT
>des2
AAACCAGGGTTT
>anc3
ATGGTGCTGTCC
>des3
ATGGTGGTGTCCTAA
>anc4
CTCTGGATAGTGCTCTGGATAGTG
>des4
CTCTGGATAGTGCTATAGTG
"""

TRIPLET_PAIRS = """>stop0
ATGTAACCC
>des0
ATGCCC
>anc1
ATGCTCTGGATAGTGCCC
>des1
ATGCTATAGTGCNC
>anc2
ATGAAACCCGGGTTTTAA
>des2
ATGAAACCGGGTTTTAA
>stop3
CTCTAAATAGTG
>des3
CTATAGTG
>anc4
ATGGGGCCCAAATTTGGGCCC
>des4
ATGGGGCCCAAAGGGTTTGGGCCC
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_batch(argv):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    return subprocess.Popen(
        [sys.executable, "-m", "coati_tpu_torch.cli", "batch", *argv, "--device", "cpu"],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _wait(procs, timeout=300):
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err


@pytest.mark.parametrize("model,text,errors", [("mar-mg", MARGINAL_PAIRS, []),
                                               ("tri-mg", TRIPLET_PAIRS, [0, 3])])
def test_two_process_multihost_merge(tmp_path, model, text, errors):
    inp = tmp_path / "pairs.fasta"
    inp.write_text(text)
    single = tmp_path / "single.jsonl"
    merged = tmp_path / "merged.jsonl"
    port = _free_port()
    procs = [_run_batch([str(inp), "-m", model, "-o", str(single)])]
    procs += [_run_batch([str(inp), "-m", model, "-o", str(merged), "--multihost",
                          "--coordinator", f"localhost:{port}", "--nproc", "2",
                          "--pid", str(pid)])
              for pid in (0, 1)]
    _wait(procs)

    shards = [(tmp_path / f"merged.jsonl.{p}").read_text() for p in (0, 1)]
    assert all(shards)
    assert merged.read_text() == shards[0] + shards[1]
    if not errors:
        assert merged.read_bytes() == single.read_bytes()
    one = {json.loads(line)["pair"]: line for line in single.read_text().splitlines()}
    two = {json.loads(line)["pair"]: line for line in merged.read_text().splitlines()}
    assert len(one) == len(two) == 5 and two == one
    rows = {i: json.loads(line) for i, line in one.items()}
    assert [i for i, r in sorted(rows.items()) if "error" in r] == errors
    man = json.loads((tmp_path / "merged.jsonl.scores.json").read_text())
    assert man["n_pairs"] == 5 and len(man["scores"]) == 5
    assert [i for i, s in enumerate(man["scores"]) if s is None] == errors
    for i, s in enumerate(man["scores"]):
        assert s == rows[i].get("score")
