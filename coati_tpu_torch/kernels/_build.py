"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

Every `csrc/*.cu` file is compiled by an nvcc of its own, all started
together, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). In a checkout of
the repository the library goes to `build/coati_tpu_torch/` at its root; in
an installed copy, or where that root is not writable, to
`$XDG_CACHE_HOME/coati_tpu_torch/` (default `~/.cache/coati_tpu_torch/`).
It is named by a hash of the sources and flags, so an edited source is
rebuilt. Pointers and the CUDA
stream cross as `c_void_p`, sizes as `c_int`; each entry point returns
`cudaGetLastError()` after its launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"


def build_dir(root: Path = Path(__file__).resolve().parents[2]) -> Path:
    """Where the library is built: build/coati_tpu_torch/ under the checkout
    `root` when it is a writable checkout (it holds pyproject.toml), else a
    per-user cache."""
    if (root / "pyproject.toml").is_file() and os.access(root, os.W_OK):
        return root / "build" / "coati_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "coati_tpu_torch"


BUILD_DIR = build_dir()
# -fmad=false: no contraction anywhere; the kernels spell out the only FMAs
# the reference has (the two margin formulas) as __fmaf_rn
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    # aseq bseq lens_a lens_b table gap bp corners edge gprog, B NA NB k Cp
    # table_len table_shared W warps_per_pair pairs_per_block blocks_per_pair,
    # stream
    "coati_wavefront_fill": [_P] * 10 + [_I] * 11 + [_P],
    # aseq bseq lens_a lens_b table gap corners edge gprog, B NA NB k table_len
    # table_shared W warps_per_pair pairs_per_block blocks_per_pair, stream
    "coati_wavefront_fill_score": [_P] * 9 + [_I] * 10 + [_P],
    # aseq bseq lens_a lens_b table gap corners ckpt edge gprog, B NA NB k Cp
    # band_rows n_ckpt table_len table_shared W warps_per_pair pairs_per_block
    # blocks_per_pair, stream
    "coati_wavefront_fill_ckpt": [_P] * 10 + [_I] * 13 + [_P],
    # aseq bseq lens_a lens_b table gap ckpt bp edge gprog, B NA NB k Cp row0
    # band_rows table_len table_shared W warps_per_pair pairs_per_block
    # blocks_per_pair, stream
    "coati_wavefront_fill_band": [_P] * 10 + [_I] * 13 + [_P],
    # bp cM cD cI lens_a lens_b ops score, B R Cp k max_steps S warps, stream
    "coati_traceback_walk": [_P] * 8 + [_I] * 7 + [_P],
    # bp adj lens_a lens_b score state ops, B R Cp k row0 max_steps S warps,
    # stream
    "coati_traceback_walk_band": [_P] * 7 + [_I] * 8 + [_P],
    # aseq bseq lens_a lens_b table gap ring_in corners_in ring_out corners_out
    # adj ring_scratch bp sync halo next stamps, B NA NB k d0 T route want_bp
    # blocks_per_pair band_width halo_slots table_len threads, stream
    "coati_wavefront_segment": [_P] * 17 + [_I] * 13 + [_P],
    # aseq bseq lens_a lens_b table gap adj ring_scratch sync halo next stamps,
    # B NA NB k route blocks_per_pair band_width halo_slots table_len threads,
    # stream
    "coati_wavefront_score": [_P] * 12 + [_I] * 10 + [_P],
    # bp adj lens_a lens_b score state ops, B T C k d0 max_steps S warps,
    # stream
    "coati_traceback_walk_segment": [_P] * 7 + [_I] * 8 + [_P],
    # aseq bseq lens_a lens_b table gap adj ring_scratch sync halo next stamps
    # mdi, B NA NB k route blocks_per_pair band_width halo_slots table_len
    # threads, stream
    "coati_wavefront_forward": [_P] * 13 + [_I] * 10 + [_P],
    # mdi enc_a enc_b table gap uniforms ops scores, R Cc k N n_steps S warps
    # table_len, stream
    "coati_sample_walk": [_P] * 8 + [_I] * 8 + [_P],
    # k S warps table_len
    "coati_sample_walk_smem_bytes": [_I] * 4,
    # anc_cods des ins_off steps lens_m logP64 match_emit gc carry_in grid
    # amax carry_out scratch records progress, B m S threads bands band_width
    # slots, stream
    "coati_triplet_rows": [_P] * 15 + [_I] * 7 + [_P],
    # threads
    "coati_triplet_rows_blocks_per_sm": [_I],
    # grid amax anc_seg des ins_off logP64 match_emit gc state ops scratch
    # stamps, B m S t_lo cols threads window bands, stream
    "coati_triplet_walk": [_P] * 12 + [_I] * 8 + [_P],
    # window
    "coati_triplet_walk_smem_bytes": [_I],
    "coati_triplet_walk_smem_limit": [],
}

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcoati_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels unless the library for these sources exists.
    Returns the library's path and nvcc's output ("" when nothing was
    built); the output includes ptxas' register and shared memory use."""
    out = library_path()
    if out.exists():
        return out, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = BUILD_DIR / f"{out.stem}.{os.getpid()}.obj"
    objs.mkdir(exist_ok=True)
    try:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = objs / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = ""
        failed = []
        for obj, job in jobs:
            log += job.communicate()[0]
            if job.returncode != 0:
                failed.append(obj.stem)
        if not failed:
            res = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                 *[str(obj) for obj, _ in jobs]],
                capture_output=True, text=True)
            log += res.stdout + res.stderr
            if res.returncode != 0:
                failed.append("the link")
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(objs, ignore_errors=True)
    return out, log


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()[0]))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _I
            _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
