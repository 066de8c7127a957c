"""Source hash for the evidence made on the card (counterpart of
coati_tpu/provenance.py).

tests/data/torch_gpu_parity.json and tests/data/torch_gpu_longpair.json are
made on an NVIDIA card by coati_tpu_torch/tools/gpu_parity_check.py and
run_longpair.py and checked in; they are only as fresh as the sources they
were made with. Each records `kernel_hash` when it is made, and the tests
fail once the sources no longer match, so an edited kernel without new
evidence is a failing test, not a stale file. The kernel library needs no
cache directory of its own: its file is already named by a hash of its
sources (kernels/_build.py library_path).
"""

from __future__ import annotations

import hashlib
from pathlib import Path

PACKAGE = "coati_tpu_torch"
# every file whose change can alter a result on the card, by glob under the
# package: the CUDA sources, the native library that builds every string,
# the kernel wrappers, the engines that route and cut the work
KERNEL_SOURCES = (
    "csrc/*.cu",
    "csrc/*.cuh",
    "csrc/pairhmm.cc",
    "kernels/*.py",
    "align/wavefront.py",
    "align/engine.py",
    "align/longseq.py",
    "align/semiring.py",
    "align/sample_device.py",
    "triplet_hmm.py",
    "triplet_wavefront.py",
)


def kernel_files(repo_root: Path | None = None) -> list[str]:
    """The files KERNEL_SOURCES names, relative to `repo_root`, in order."""
    root = repo_root or Path(__file__).resolve().parent.parent
    files = []
    for pattern in KERNEL_SOURCES:
        found = sorted((root / PACKAGE).glob(pattern))
        if not found:
            raise FileNotFoundError(f"{PACKAGE}/{pattern} matches no file under {root}")
        files += [p.relative_to(root).as_posix() for p in found]
    return files


def kernel_hash(repo_root: Path | None = None) -> str:
    """sha256 over each listed file's path and bytes."""
    root = repo_root or Path(__file__).resolve().parent.parent
    h = hashlib.sha256()
    for rel in kernel_files(root):
        h.update(rel.encode())
        h.update((root / rel).read_bytes())
    return h.hexdigest()
