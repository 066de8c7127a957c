"""Pairwise alignment and sampling drivers (counterpart of
coati_tpu/driver.py; reference align_marginal.cc:44-88, :536-594)."""

from __future__ import annotations

import sys

import numpy as np
import torch

from coati_tpu_torch import utils
from coati_tpu_torch.device import resolve_device
from coati_tpu_torch.io import read_input, write_output
from coati_tpu_torch.io.jsonio import write_json_sample
from coati_tpu_torch.structs import AlignmentParams

# Pairs of at most this many cells (na+k)*(nb+k) are sampled on the host by
# the native library, on the reference's Lehmer64 stream.
NATIVE_SAMPLE_CELLS = 4_000_000
# Bytes the Forward matrices of one pair may take on the device (12 a cell):
# 32 GiB holds a pair of about 53,000 nt square on an 80 GB card, beside the
# uniforms and op codes of a chunk of samples.
FORWARD_BUDGET_BYTES = 32 << 30


def _viterbi_align(aln: AlignmentParams, device) -> None:
    """Viterbi-align aln.data.seqs[0/1] in place."""
    from coati_tpu_torch.align.engine import viterbi_align_single

    anc, des = aln.seq(0), aln.seq(1)
    enc_a, enc_b = utils.encode_marginal(anc, des)
    s0, s1, score = viterbi_align_single(
        enc_a, enc_b, anc, des, aln.subst_matrix, aln.gap, device=device
    )
    aln.data.seqs = [s0, s1]
    aln.data.score = score


def marg_alignment(aln: AlignmentParams, device="cuda") -> bool:
    """Pairwise alignment with a marginal model; -s scores the input
    alignment instead."""
    aln.data = read_input(aln)
    utils.set_subst(aln)

    if aln.score:
        from coati_tpu_torch.align.score import alignment_score

        print(f"{alignment_score(aln, aln.subst_matrix):g}")
        return True

    utils.process_marginal(aln)
    try:
        _viterbi_align(aln, device)
    except MemoryError:
        print("ERROR: sequences to align exceed available memory.",
              file=sys.stderr)
        return False
    utils.restore_end_stops(aln.data, aln.gap)
    write_output(aln)
    return True


def _forward_diag(enc_a, enc_b, aln, dev):
    """The log-semiring Forward of one pair on `dev`: (mdi [R, Cc, 3] f32
    with cell (i, j)'s M, D, I at [i, j], the terminal-adjusted corners
    (cm, cd, ci) as floats). Counterpart of coati_tpu/driver.py
    _forward_diag; the name stays though the port's layout is by rows.

    Raises MemoryError when the matrices would pass FORWARD_BUDGET_BYTES."""
    from coati_tpu_torch.kernels.wavefront_forward import (
        forward_bytes,
        wavefront_forward,
    )
    from coati_tpu_torch.params import params_from_numpy

    k = int(aln.gap.len)
    na, nb = len(enc_a), len(enc_b)
    need = forward_bytes(na, nb, k)
    if need > FORWARD_BUDGET_BYTES:
        raise MemoryError(
            f"the Forward matrices of a {na} x {nb} nt pair take {need:,} "
            f"bytes (12 a cell of {na + k} x {nb + k}); the budget is "
            f"{FORWARD_BUDGET_BYTES:,} (driver.FORWARD_BUDGET_BYTES)")
    params = params_from_numpy(aln.subst_matrix, aln.gap, dev)
    aseq = np.ascontiguousarray(enc_a, dtype=np.int32)[None, :]
    bseq = np.ascontiguousarray(enc_b, dtype=np.int32)[None, :]
    params.check_codes(aseq, bseq)
    args = [torch.from_numpy(x).to(dev) for x in (
        aseq, bseq, np.array([na], np.int32), np.array([nb], np.int32))]
    adj, mdi = wavefront_forward(*args, params.table, params.gap_consts, k=k)
    cm, cd, ci = (float(x) for x in adj[:, 0].cpu())
    return mdi[0], (cm, cd, ci)


def _forward_mdi(enc_a, enc_b, aln, device="cuda"):
    """Host (i, j)-layout state matrices M, D, I (numpy [R, Cc]) with the
    terminal-adjusted corner written in: the layout oracle.sampleback_mdi
    walks."""
    mdi, corners = _forward_diag(enc_a, enc_b, aln, resolve_device(device))
    m = mdi.cpu().numpy()
    M, D, I = (np.ascontiguousarray(m[:, :, s]) for s in range(3))
    M[-1, -1], D[-1, -1], I[-1, -1] = corners
    return M, D, I


def marg_sample(aln: AlignmentParams, sample_size: int, rng, device="cuda",
                native_cells: int | None = None) -> None:
    """Sample alignments via Forward + stochastic traceback
    (align_marginal.cc:536-594).

    Pairs of at most native_cells cells (default NATIVE_SAMPLE_CELLS, read
    at the call) take the native host sampler on rng's Lehmer64 stream (the
    reference's alignments for equal seeds); larger ones the Forward kernel
    and the sample walk on `device`, on a torch.Generator seeded from
    rng.u64(). The device is resolved first, so without a card the call
    fails the same whatever the input's size, unless device is "cpu"."""
    dev = resolve_device(device)
    if native_cells is None:
        native_cells = NATIVE_SAMPLE_CELLS
    aln.data = read_input(aln)
    if aln.data.size() != 2:
        raise ValueError("Exactly two sequences required.")

    out_path = str(aln.output)
    if not out_path or out_path == "-":
        out = sys.stdout
        close = False
    else:
        try:
            out = open(out_path, "w")
        except OSError as exc:
            raise ValueError(f"Opening output file {aln.output} failed.") from exc
        close = True

    try:
        len_a = len(aln.seq(0))
        if len_a % 3 != 0 or len_a % aln.gap.len != 0:
            raise ValueError("Length of reference sequence must be multiple of 3.")
        if len(aln.seq(1)) % aln.gap.len != 0:
            raise ValueError(
                f"Length of descendant sequence must be multiple of {aln.gap.len}."
            )

        utils.trim_end_stops(aln.data)
        anc, des = aln.seq(0), aln.seq(1)
        enc_a, enc_b = utils.encode_marginal(anc, des)
        utils.set_subst(aln)

        stops = aln.data.stops
        n_cells = (len(enc_a) + aln.gap.len) * (len(enc_b) + aln.gap.len)
        if n_cells <= native_cells:
            from coati_tpu_torch import native

            samples = native.sampleback_batch(
                enc_a, enc_b, aln.subst_matrix, aln.gap, anc, des,
                sample_size, rng,
            )
        else:
            from coati_tpu_torch.align.sample_device import sample_batch_device

            mdi, corners = _forward_diag(enc_a, enc_b, aln, dev)
            samples = sample_batch_device(
                mdi, corners, enc_a, enc_b, aln.subst_matrix, anc, des,
                aln.gap, rng.u64(), sample_size,
            )
        for i, (s0, s1, score) in enumerate(samples):
            aln.data.seqs = [s0, s1]
            aln.data.score = score
            aln.data.stops = list(stops)
            utils.restore_end_stops(aln.data, aln.gap)
            write_json_sample(aln.data, out, i, sample_size)
    finally:
        if close:
            out.close()
