"""Stochastic traceback on the device: N samples walk one pair's Forward
matrices in parallel.

Counterpart of coati_tpu/align/sample_device.py. The Forward (log-semiring)
fill runs once (kernels/wavefront_forward.py), then N tracebacks walk its
M, D, I from the corner: each step rebuilds in f32 the candidate edges into
the current cell's state and draws the predecessor by inverse CDF, `p *
scale` against the cumulative weights. Only the int8 op codes and a score a
sample leave the device.

The distribution is the host sampler's (native.sampleback_batch,
oracle.sampleback_mdi): the same f32 edge reconstructions, the same margin
semantics (on the margins D and I copy), the same draw. The sampled stream
differs from the reference's Lehmer64 stream, which the host route of
driver.marg_sample keeps for small inputs, and from the JAX package's
threefry stream: the walk takes its uniforms as an argument, a tensor
[n_steps + 1, N] (row 0 the corner draw, row t + 1 step t), and production
draws them with torch.rand from a torch.Generator on the device seeded from
the seeded Lehmer64, so a seed gives the same samples on the same kind of
device.

Layout: mdi [R, Cc, 3] f32, cell (i, j)'s M, D, I at [i, j], R = na + k,
Cc = nb + k, the terminal-adjusted corner at [R-1, Cc-1].
"""

from __future__ import annotations

import numpy as np
import torch

from coati_tpu_torch.align.wavefront import LOWEST, gap_consts_array

SAMPLE_CHUNK = 4096  # samples a launch of the walk


def _draw(logm, logd, logi, p):
    """Inverse-CDF draw among three log weights: (state picked, its log
    probability) (sample_device.py:74-82)."""
    em = torch.exp(logm)
    ed = torch.exp(logd)
    ei = torch.exp(logi)
    scale = em + ed + ei
    ps = p * scale
    pick = torch.where(ps < em, 0, torch.where(ps < em + ed, 1, 2))
    chosen = torch.where(pick == 0, logm, torch.where(pick == 1, logd, logi))
    return pick, chosen - torch.log(scale)


def sample_paths_plain(mdi, enc_a, enc_b, table, gap_consts, uniforms, *,
                       k: int):
    """Plain version of kernels/sample_walk.py sample_walk: all N walks one
    step per loop iteration, every add in the order of _sample_paths
    (sample_device.py:84-147). Arguments and results as sample_walk's."""
    R, Cc = mdi.shape[:2]
    n_steps, N = uniforms.shape[0] - 1, uniforms.shape[1]
    dev = mdi.device
    ng, gs, go, ge = (gap_consts[q] for q in range(4))
    gek1 = ge * float(k - 1)
    gek = ge * float(k)
    zero = torch.tensor(LOWEST, dtype=torch.float32, device=dev)
    table_flat = table.reshape(-1)
    a_long, b_long = enc_a.long(), enc_b.long()

    def val3(i, j):  # [N, 3]: M, D, I at (i, j), clamped into the matrix
        return mdi[i.clamp(min=0), j.clamp(min=0)]

    corner = mdi[R - 1, Cc - 1]
    w0 = corner.max()
    pick, score = _draw(*((corner[s] - w0).expand(N) for s in range(3)),
                        uniforms[0])
    i = torch.full((N,), R - 1, dtype=torch.long, device=dev)
    j = torch.full((N,), Cc - 1, dtype=torch.long, device=dev)
    ops = torch.full((n_steps, N), -1, dtype=torch.int8, device=dev)
    for t in range(n_steps):
        active = (i > k - 1) | (j > k - 1)
        if not bool(active.any()):
            break
        body = (i >= k) & (j >= k)
        code = b_long[(j - k).clamp(min=0)]
        # code 15 ('-') has no column, as in the fill
        sub = torch.where(
            code < 15,
            table_flat[a_long[(i - k).clamp(min=0)] * 15 + code.clamp(max=14)],
            0.0)
        v_c = val3(i, j)
        v_p = val3(i - 1, j - 1)  # into M
        mm = torch.where(body, v_p[:, 0] + (ng + ng) + sub, zero)
        dm = torch.where(body, v_p[:, 1] + gs + sub, zero)
        im = torch.where(body, v_p[:, 2] + (gs + ng) + sub, zero)
        v_k = val3(i - k, j)  # into D; on the margin D copies
        md = torch.where(body, v_k[:, 0] + (ng + go) + gek1, zero)
        dd = torch.where(body, v_k[:, 1] + gek, v_c[:, 1])
        id_ = torch.where(body, v_k[:, 2] + (gs + go) + gek1, zero)
        v_j = val3(i, j - k)  # into I; D never precedes I
        mi = torch.where(body, v_j[:, 0] + go + gek1, zero)
        ii = torch.where(body, v_j[:, 2] + gek, v_c[:, 2])

        w = v_c.gather(1, pick[:, None])[:, 0]
        logm = torch.where(pick == 0, mm, torch.where(pick == 1, md, mi)) - w
        logd = torch.where(pick == 0, dm, torch.where(pick == 1, dd, zero)) - w
        logi = torch.where(pick == 0, im, torch.where(pick == 1, id_, ii)) - w
        nxt, ds = _draw(logm, logd, logi, uniforms[t + 1])

        ops[t] = torch.where(active, pick, -1).to(torch.int8)
        di = torch.where(pick == 0, 1, torch.where(pick == 1, k, 0))
        dj = torch.where(pick == 0, 1, torch.where(pick == 2, k, 0))
        i = torch.where(active, i - di, i)
        j = torch.where(active, j - dj, j)
        score = torch.where(active, score + ds, score)
        pick = torch.where(active, nxt, pick)
    return ops, score


def decode_sample_ops(ops_n, a: str, b: str, k: int):
    """One aligned pair from a walk-order op column (int8, -1 padding): the
    numpy version of the string building that sample_batch_device leaves to
    native.ops_to_strings_native."""
    ops = ops_n[ops_n >= 0][::-1].astype(np.int64)  # forward order
    if ops.size == 0:
        return "", ""
    cols = np.repeat(ops, np.where(ops == 0, 1, k))  # one op code a column
    a_arr = np.frombuffer(a.encode("ascii"), dtype=np.uint8)
    b_arr = np.frombuffer(b.encode("ascii"), dtype=np.uint8)
    dash = np.uint8(ord("-"))
    use_a, use_b = cols != 2, cols != 1
    s0 = np.where(use_a, a_arr[np.maximum(np.cumsum(use_a) - 1, 0)], dash)
    s1 = np.where(use_b, b_arr[np.maximum(np.cumsum(use_b) - 1, 0)], dash)
    return (s0.astype(np.uint8).tobytes().decode("ascii"),
            s1.astype(np.uint8).tobytes().decode("ascii"))


def walk_inputs(mdi, corners, enc_a, enc_b, table, gap):
    """What the walk reads beside mdi, on mdi's device: (table [rows, 15] f32,
    gap constants [4], enc_a, enc_b int32), with the terminal-adjusted
    corners (cm, cd, ci) written into mdi's corner cell in place; checks
    mdi's shape [R, Cc, 3]."""
    dev = mdi.device
    k = int(gap.len)
    R, Cc = len(enc_a) + k, len(enc_b) + k
    if tuple(mdi.shape) != (R, Cc, 3):
        raise ValueError(f"mdi must be [{R}, {Cc}, 3], got {tuple(mdi.shape)}")
    mdi[R - 1, Cc - 1] = torch.tensor([float(c) for c in corners],
                                      dtype=torch.float32, device=dev)
    return (torch.from_numpy(
                np.ascontiguousarray(table, dtype=np.float32).reshape(-1, 15)).to(dev),
            torch.from_numpy(gap_consts_array(gap)).to(dev),
            torch.from_numpy(np.ascontiguousarray(enc_a, dtype=np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(enc_b, dtype=np.int32)).to(dev))


def sample_uniforms(dev, seed_u64: int, n_steps: int, n: int,
                    chunk: int = SAMPLE_CHUNK):
    """The walks' uniforms for n samples, `chunk` columns a tensor
    [n_steps + 1, <= chunk] f32 on dev, from one torch.Generator on dev
    seeded from seed_u64: the same numbers for a seed on the same kind of
    device, however the samples are then split."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed_u64 & 0x7FFFFFFFFFFFFFFF)
    for done in range(0, n, chunk):
        yield torch.rand((n_steps + 1, min(chunk, n - done)), generator=gen,
                         dtype=torch.float32, device=dev)


def sample_batch_device(mdi, corners, enc_a, enc_b, table, a: str, b: str,
                        gap, seed_u64: int, n: int, chunk: int = SAMPLE_CHUNK):
    """Draw n alignments from the Forward distribution on mdi's device.

    mdi [R, Cc, 3] f32 from wavefront_forward (one pair); corners the
    terminal-adjusted (cm, cd, ci), written into mdi's corner cell in place.
    Yields (s0, s1, score) in stream order, `chunk` samples a launch;
    deterministic for a seed and a kind of device."""
    from coati_tpu_torch import native
    from coati_tpu_torch.kernels.sample_walk import sample_walk

    k = int(gap.len)
    table_t, gc, ea, eb = walk_inputs(mdi, corners, enc_a, enc_b, table, gap)
    n_steps = len(enc_a) + len(enc_b)
    for uniforms in sample_uniforms(mdi.device, seed_u64, n_steps, n, chunk):
        nb = uniforms.shape[1]
        ops, scores = sample_walk(mdi, ea, eb, table_t, gc, uniforms, k=k)
        ops = ops.cpu().numpy()
        scores = scores.cpu().numpy()
        # walk order reversed is forward order; the native pass skips the -1
        pairs = native.ops_to_strings_native(ops[::-1], [a] * nb, [b] * nb, k)
        for s, (s0, s1) in enumerate(pairs):
            yield s0, s1, float(scores[s])
