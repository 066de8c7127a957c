"""ctypes bindings to the port's native pair-HMM engine (csrc/pairhmm.cc).

Counterpart of coati_tpu/native.py with its own copy of the source and its
own build: g++ at first use, into the directory the CUDA kernels are built
in (kernels/_build.py BUILD_DIR), the library named by a hash of the source
and flags so an edited source is rebuilt. The flags pin the f32 stream:
-ffp-contract=off and no -march=native, so the compiler turns no a*b+c into
an FMA and the results do not depend on the machine that built it. The truth
for that stream is align/oracle.py. A failed build raises. Host only: this
is the single-thread C++ baseline beside the card's numbers, the pass that
builds the engine's strings and the seeded sampler of `sample` for small
inputs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from coati_tpu_torch.kernels._build import BUILD_DIR, CSRC

SOURCE = CSRC / "pairhmm.cc"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared")
_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libcoatihmm_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/pairhmm.cc unless the library for this source exists."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler found: set CXX")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cxx} failed ({res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
    return _lib


def _bind(lib):
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    c_int, c_float, cp = ctypes.c_int, ctypes.c_float, ctypes.c_char_p
    pair = [i32p, c_int, i32p, c_int, f32p, c_float, c_float, c_int]
    for name in ("coati_viterbi_score", "coati_forward_score"):
        fn = getattr(lib, name)
        fn.restype = c_float
        fn.argtypes = pair
    lib.coati_viterbi_bp.restype = c_float
    lib.coati_viterbi_bp.argtypes = pair + [u8p, ctypes.POINTER(c_int)]
    lib.coati_sample_anchor.restype = ctypes.c_double
    lib.coati_sample_anchor.argtypes = pair + [c_int, ctypes.c_uint64]
    lib.coati_sampleback.restype = None
    lib.coati_sampleback.argtypes = pair + [c_int, u64p, i8p, c_int, f32p]
    lib.coati_ops_to_strings.restype = None
    lib.coati_ops_to_strings.argtypes = [
        i8p, c_int, c_int, c_int, cp, i64p, cp, i64p, u8p, u8p,
        ctypes.c_int64, i32p,
    ]
    return lib


def ops_to_strings_native(ops_fwd, a_strs, b_strs, k):
    """Build aligned string pairs from forward-ordered op codes in one
    native pass. Returns list of (seq0, seq1)."""
    lib = _load()
    ops = np.ascontiguousarray(ops_fwd, dtype=np.int8)
    steps, n = ops.shape
    a_cat = "".join(a_strs).encode("ascii")
    b_cat = "".join(b_strs).encode("ascii")
    a_off = np.zeros(n, np.int64)
    b_off = np.zeros(n, np.int64)
    pos = 0
    for i, s in enumerate(a_strs):
        a_off[i] = pos
        pos += len(s)
    pos = 0
    for i, s in enumerate(b_strs):
        b_off[i] = pos
        pos += len(s)
    max_w = max((len(a) + len(b) for a, b in zip(a_strs, b_strs)), default=1)
    out0 = np.zeros((n, max_w), np.uint8)
    out1 = np.zeros((n, max_w), np.uint8)
    out_len = np.zeros(n, np.int32)
    lib.coati_ops_to_strings(ops, steps, n, k, a_cat, a_off, b_cat, b_off,
                             out0, out1, max_w, out_len)
    res = []
    for p in range(n):
        w = int(out_len[p])
        res.append((out0[p, :w].tobytes().decode("ascii"),
                    out1[p, :w].tobytes().decode("ascii")))
    return res


def available() -> bool:
    """True once the library is built and loaded; a failed build raises
    (the port has no route that does without it)."""
    _load()
    return True


def viterbi_score(enc_a, enc_b, table, gap) -> float:
    lib = _load()
    a = np.ascontiguousarray(enc_a, dtype=np.int32)
    b = np.ascontiguousarray(enc_b, dtype=np.int32)
    t = np.ascontiguousarray(table, dtype=np.float32)
    return float(lib.coati_viterbi_score(a, len(a), b, len(b), t,
                                         np.float32(gap.open),
                                         np.float32(gap.extend), gap.len))


def forward_score(enc_a, enc_b, table, gap) -> float:
    lib = _load()
    a = np.ascontiguousarray(enc_a, dtype=np.int32)
    b = np.ascontiguousarray(enc_b, dtype=np.int32)
    t = np.ascontiguousarray(table, dtype=np.float32)
    return float(lib.coati_forward_score(a, len(a), b, len(b), t,
                                         np.float32(gap.open),
                                         np.float32(gap.extend), gap.len))


def viterbi_bp(enc_a, enc_b, table, gap):
    """Returns (score, bp[(na+k), (nb+k)] uint8, start_state)."""
    lib = _load()
    a = np.ascontiguousarray(enc_a, dtype=np.int32)
    b = np.ascontiguousarray(enc_b, dtype=np.int32)
    t = np.ascontiguousarray(table, dtype=np.float32)
    k = gap.len
    bp = np.zeros(((len(a) + k), (len(b) + k)), dtype=np.uint8)
    state = ctypes.c_int(0)
    score = lib.coati_viterbi_bp(a, len(a), b, len(b), t,
                                 np.float32(gap.open), np.float32(gap.extend),
                                 k, bp, ctypes.byref(state))
    return float(score), bp, int(state.value)


def viterbi_align(enc_a, enc_b, a_str, b_str, gap, table):
    """Full native alignment: C++ DP + packed-bp walk -> aligned strings.

    Independent single-thread reimplementation of the reference pipeline
    (align_pair.cc:55-139 fill + :141-239 traceback); used as the string-
    level truth for long-pair parity tests where the Python oracle is too
    slow. Returns (seq0, seq1, score)."""
    score, bp, st = viterbi_bp(enc_a, enc_b, table, gap)
    k = int(gap.len)
    i, j = len(enc_a) + k - 1, len(enc_b) + k - 1
    s0, s1 = [], []
    ai, bi = len(a_str), len(b_str)
    while i > k - 1 or j > k - 1:
        if i == k - 1:
            st = 2
        elif j == k - 1:
            st = 1
        if st == 0:
            s0.append(a_str[ai - 1])
            s1.append(b_str[bi - 1])
            ai -= 1
            bi -= 1
            nxt = bp[i, j] & 3
            i -= 1
            j -= 1
        elif st == 1:
            for _ in range(k):
                s0.append(a_str[ai - 1])
                s1.append("-")
                ai -= 1
            nxt = (bp[i, j] >> 2) & 3
            i -= k
        else:
            for _ in range(k):
                s0.append("-")
                s1.append(b_str[bi - 1])
                bi -= 1
            nxt = (bp[i, j] >> 4) & 3
            j -= k
        st = int(nxt)
    return "".join(reversed(s0)), "".join(reversed(s1)), float(score)


def sample_anchor(enc_a, enc_b, table, gap, n_samples: int,
                  seed: int = 42) -> float:
    """Reference-equivalent sampling workload, single thread: one Forward
    (log) fill with stored M/D/I planes + n stochastic tracebacks
    (align_marginal.cc:536-594). Returns the checksum (sum of sampled
    path scores); callers time the call."""
    lib = _load()
    a = np.ascontiguousarray(enc_a, dtype=np.int32)
    b = np.ascontiguousarray(enc_b, dtype=np.int32)
    t = np.ascontiguousarray(table, dtype=np.float32)
    return float(lib.coati_sample_anchor(
        a, len(a), b, len(b), t, np.float32(gap.open),
        np.float32(gap.extend), gap.len, int(n_samples), seed))


def sampleback_batch(enc_a, enc_b, table, gap, a: str, b: str, n: int,
                     rng):
    """Host sampling path: Forward fill + n stochastic tracebacks drawing
    from `rng` (coati_tpu_torch.rng.Lehmer64, state threaded through C and
    written back). Walk semantics mirror oracle.sampleback_mdi; strings
    are built for all n samples in one native pass (coati_ops_to_strings).
    Returns a list of (s0, s1, score)."""
    lib = _load()
    ea = np.ascontiguousarray(enc_a, dtype=np.int32)
    eb = np.ascontiguousarray(enc_b, dtype=np.int32)
    t = np.ascontiguousarray(table, dtype=np.float32)
    k = int(gap.len)
    steps_cap = len(ea) + len(eb) + 2
    ops = np.empty((steps_cap, n), np.int8)
    scores = np.empty(n, np.float32)
    state = np.array(
        [rng.state & 0xFFFFFFFFFFFFFFFF, rng.state >> 64], np.uint64
    )
    lib.coati_sampleback(
        ea, len(ea), eb, len(eb), t, np.float32(gap.open),
        np.float32(gap.extend), k, int(n), state, ops, steps_cap, scores,
    )
    rng.state = int(state[0]) | (int(state[1]) << 64)
    # ops are in walk (backward) order; coati_ops_to_strings takes
    # forward order and skips -1 padding — one pass for all n samples
    pairs = ops_to_strings_native(ops[::-1], [a] * n, [b] * n, k)
    return [
        (s0, s1, float(scores[s])) for s, (s0, s1) in enumerate(pairs)
    ]
