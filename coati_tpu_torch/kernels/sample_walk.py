"""Wrapper of the sample walk kernel (csrc/sample_walk.cu).

Counterpart of coati_tpu/align/sample_device.py _sample_paths: N stochastic
tracebacks over one pair's Forward matrices, the uniforms supplied by the
caller. CPU tensors take the plain PyTorch version
(align/sample_device.py sample_paths_plain); CUDA tensors launch the kernel
or raise.

The kernel runs a warp a sample, `warps` samples a block, in windows of S
steps: the rows and columns the next S steps can reach, k(S + 1) + 1 of
each (a step also loads what the step after it may read), are copied into
shared memory with the S uniforms, and one lane takes the steps there; the
block keeps the table in shared memory. walk_shape picks S and warps from k;
S = 0 forces one thread a sample reading device memory at every step (the
route above k = 20, and the body before windows). The sizes of the window
route below are those of csrc/sample_walk.cu (window_row_bytes,
window_pitch, window_bytes, warp_bytes, table_bytes); before a launch the
wrapper holds their sum to the library's coati_sample_walk_smem_bytes.
"""

from __future__ import annotations

import torch

from coati_tpu_torch.align.sample_device import sample_paths_plain
from coati_tpu_torch.kernels import _build

LAUNCHES = 0  # kernel launches made by sample_walk
SMEM_BYTES = 232_448  # dynamic shared memory one H100 block may use
# S, steps a window serves at k = 1, and warps (samples) a block. On an H100
# at 9,999 nt x 200 samples (sweep_shapes.py samplewalk, two runs): S = 32 at
# 1, 2 and 4 warps 2.418-2.520 ms, 8 warps 3.051-3.062; S = 16 2.470-2.490;
# S = 8 3.139-3.166; one thread a sample 4.113-4.191.
WINDOW_STEPS = 32
WALK_WARPS = 2
WINDOW_ROW_BYTES = 32 * 16  # a window row is at most 32 copies of 16 bytes, one a lane
TABLE_LEN = 183 * 15  # f32 of one marginal table, which the window route keeps in shared memory


def window_steps(k: int) -> int:
    """S at gap length k: WINDOW_STEPS at k = 1, fewer at larger k so that a
    window of k(S + 1) + 1 rows and columns stays near the size it has at
    k = 1."""
    return max(1, WINDOW_STEPS // k)


def window_row_bytes(H: int) -> int:
    """Bytes of the 16-byte chunks a window row may span at window height H
    = k(S + 1): H + 1 cells of 12 bytes from an offset of up to 12."""
    return -(-12 * (H + 2) // 16) * 16


def window_layout(H: int) -> tuple[int, int]:
    """(pitch Q, bytes) of a window at height H: row r's first cell lies at
    K + r P, P = Q + 12 Cc mod 16."""
    Q = -(-(12 * (H + 1) + 27) // 16) * 16
    return Q, (H + 1) * (Q + 12) + 32


def window_bytes(k: int, S: int) -> int:
    """Shared memory one warp takes: its window; S + 1 uniforms, S chosen
    log weights and S scales; the codes of the window's H + 1 rows and
    columns, H = k(S + 1); S staged op codes; rounded up to 16."""
    H = k * (S + 1)
    return -(-(window_layout(H)[1] + 4 * (S + 1) + 8 * S + 8 * (H + 1) + S) // 16) * 16


def table_bytes(table_len: int) -> int:
    """Shared memory the table takes in a block of the window route."""
    return -(-4 * table_len // 16) * 16


def block_warps(k: int, S: int, table_len: int = TABLE_LEN) -> int:
    """Warps a block at windows of S steps: WALK_WARPS, fewer where their
    windows and the table pass a block's shared memory (0 where one window
    does)."""
    room = SMEM_BYTES - table_bytes(table_len)
    return min(WALK_WARPS, room // window_bytes(k, S)) if S else 1


def walk_shape(k: int, table_len: int = TABLE_LEN) -> tuple[int, int]:
    """(S, warps a block) of the walk at gap length k: window_steps(k), fewer
    where a window row would span more than WINDOW_ROW_BYTES, and
    block_warps; (0, 1), one thread a sample, where no window fits (k over
    20)."""
    S = window_steps(k)
    while S >= 1 and window_row_bytes(k * (S + 1)) > WINDOW_ROW_BYTES:
        S -= 1
    warps = block_warps(k, S, table_len) if S >= 1 else 0
    return (S, warps) if warps >= 1 else (0, 1)


def _check(mdi, enc_a, enc_b, table, gap_consts, uniforms, k):
    named = {"mdi": mdi, "enc_a": enc_a, "enc_b": enc_b, "table": table,
             "gap_consts": gap_consts, "uniforms": uniforms}
    dev = mdi.device
    for name, t in named.items():
        want = torch.int32 if name in ("enc_a", "enc_b") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, mdi on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mdi.dim() != 3 or mdi.shape[2] != 3:
        raise ValueError(f"mdi must be [R, Cc, 3], got {tuple(mdi.shape)}")
    R, Cc = mdi.shape[:2]
    if tuple(enc_a.shape) != (R - k,) or tuple(enc_b.shape) != (Cc - k,):
        raise ValueError(
            f"enc_a, enc_b must be [{R - k}] and [{Cc - k}] for mdi "
            f"{tuple(mdi.shape)} and k = {k}, got {tuple(enc_a.shape)}, "
            f"{tuple(enc_b.shape)}")
    n_steps = (R - k) + (Cc - k)
    if uniforms.dim() != 2 or uniforms.shape[0] != n_steps + 1:
        raise ValueError(
            f"uniforms must be [{n_steps + 1}, N], got {tuple(uniforms.shape)}")
    if table.dim() != 2 or table.shape[1] != 15 or tuple(gap_consts.shape) != (4,):
        raise ValueError("table must be [rows, 15] and gap_consts [4]")


def sample_walk(mdi, enc_a, enc_b, table, gap_consts, uniforms, *, k: int,
                S: int | None = None, warps: int | None = None):
    """N = uniforms.shape[1] stochastic tracebacks from the corner of mdi
    [R, Cc, 3] (one pair's Forward matrices, the terminal-adjusted corner
    written at [R-1, Cc-1]). uniforms [n_steps + 1, N] f32 in [0, 1): row 0
    the corner draw, row t + 1 step t, n_steps = (R-k) + (Cc-k). Returns
    (ops [n_steps, N] int8 in walk order, 0 = match, 1 = delete, 2 = insert,
    -1 after a walk's end; scores [N] f32, each path's log probability).
    S and warps force a launch shape (default walk_shape(k); S = 0 one
    thread a sample); the results do not depend on it."""
    global LAUNCHES
    _check(mdi, enc_a, enc_b, table, gap_consts, uniforms, k)
    table_len = table.numel()
    S = walk_shape(k, table_len)[0] if S is None else S
    warps = block_warps(k, S, table_len) if warps is None else warps
    if S != 0 and (not 1 <= S <= 32 or not 1 <= warps <= 32
                   or table_bytes(table_len) + warps * window_bytes(k, S) > SMEM_BYTES
                   or window_row_bytes(k * (S + 1)) > WINDOW_ROW_BYTES):
        raise ValueError(f"{warps} warps of windows of S={S} steps at k={k}: S "
                         f"must be 0 or 1-32, the windows within {SMEM_BYTES} "
                         f"bytes of shared memory a block and their rows within "
                         f"{WINDOW_ROW_BYTES}")
    dev = mdi.device
    if dev.type == "cpu":
        return sample_paths_plain(mdi, enc_a, enc_b, table, gap_consts,
                                  uniforms, k=k)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    R, Cc = mdi.shape[:2]
    n_steps, N = uniforms.shape[0] - 1, uniforms.shape[1]
    ops = torch.full((n_steps, N), -1, dtype=torch.int8, device=dev)
    scores = torch.empty((N,), dtype=torch.float32, device=dev)
    lib = _build.load()
    if S != 0:
        smem = table_bytes(table_len) + warps * window_bytes(k, S)
        theirs = lib.coati_sample_walk_smem_bytes(k, S, warps, table_len)
        if theirs != smem:
            raise RuntimeError(
                f"sample_walk: the window route at k={k}, S={S}, {warps} warps "
                f"takes {theirs} bytes of shared memory in csrc/sample_walk.cu "
                f"and {smem} here: the two layouts differ")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.coati_sample_walk(
            mdi.data_ptr(), enc_a.data_ptr(), enc_b.data_ptr(),
            table.data_ptr(), gap_consts.data_ptr(), uniforms.data_ptr(),
            ops.data_ptr(), scores.data_ptr(), R, Cc, k, N, n_steps, S, warps,
            table_len, stream)
    _build.check(rc, "sample_walk")
    LAUNCHES += 1
    return ops, scores
