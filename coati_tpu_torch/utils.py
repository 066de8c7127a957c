"""Sequence encoding, validation, and end-stop-codon machinery.

Mirrors the behavior of COATi src/lib/utils.cc:
  - marginal_seq_encoding (:496-528)
  - set_subst model dispatch (:595-618)
  - order_ref / process_marginal / process_alignment (:789-938)
  - trim_end_stops / restore_end_stops (:945-1063)
  - process_triplet (:1102-1135)
"""

from __future__ import annotations

import numpy as np

from coati_tpu_torch import constants as C
from coati_tpu_torch.structs import AlignmentParams, SeqData


# ---------------------------------------------------------------------------
# codon helpers
# ---------------------------------------------------------------------------
def cod_int(codon: str) -> int:
    """Codon string -> 64-index (AAA=0 .. TTT=63); -1 if ambiguous."""
    if len(codon) < 3:
        raise ValueError("codon too short")
    if any(ch not in "ACGTUacgtu" for ch in codon[:3]):
        return -1
    t = C.NT16_TABLE
    return (int(t[ord(codon[0])]) << 4) | (int(t[ord(codon[1])]) << 2) | int(
        t[ord(codon[2])]
    )


def cod64_to_61(cod: int) -> int:
    if cod < 0 or cod > 63:
        raise ValueError(f"Codon index {cod} is out of range [0-63].")
    v = int(C.COD64_TO_61[cod])
    if v < 0:
        raise ValueError("Stop codon not expected in cod64_to_61")
    return v


def cod61_to_64(cod: int) -> int:
    if cod < 0 or cod > 60:
        raise ValueError(f"Codon index {cod} is out of range [0-60].")
    return int(C.COD61_TO_64[cod])


def get_nuc(cod61: int, pos: int) -> int:
    if cod61 > 61 or cod61 < 0:
        raise ValueError("Codon out of range for list without stop codons.")
    return int(C.CODON_NUC[cod61, pos])


def cod_distance(c1: int, c2: int) -> int:
    return int(np.sum(C.CODON_NUC[c1] != C.CODON_NUC[c2]))


# ---------------------------------------------------------------------------
# sequence encoding
# ---------------------------------------------------------------------------
def encode_marginal(anc: str, des: str) -> tuple[np.ndarray, np.ndarray]:
    """Encode (ancestor, descendant) for the marginal DP.

    Ancestor -> int32 array of codon*3+phase in [0,183); rejects ambiguous
    nucleotides and early stop codons. Descendant -> nt16 codes in [0,15].
    (utils.cc:496-528)
    """
    if len(anc) % 3 != 0:
        raise ValueError("Length of ancestor must be multiple of 3.")
    a_codes = C.NT16_TABLE[np.frombuffer(anc.encode("ascii"), dtype=np.uint8)]
    if np.any(a_codes > 3):
        raise ValueError("Ambiguous nucleotides in ancestor/reference.")
    cods64 = (
        (a_codes[0::3].astype(np.int32) << 4)
        | (a_codes[1::3].astype(np.int32) << 2)
        | a_codes[2::3].astype(np.int32)
    )
    if np.any(np.isin(cods64, C.STOP_CODONS_64)):
        raise ValueError("Early stop codon in ancestor/reference.")
    cods61 = C.COD64_TO_61[cods64]
    enc_a = (cods61[:, None] * 3 + np.arange(3)[None, :]).reshape(-1).astype(np.int32)

    d_codes = C.NT16_TABLE[np.frombuffer(des.encode("ascii"), dtype=np.uint8)]
    if np.any(d_codes > 15):
        raise ValueError("Invalid nucleotide in descendant.")
    return enc_a, d_codes.astype(np.int32)


# ---------------------------------------------------------------------------
# model dispatch
# ---------------------------------------------------------------------------
def set_subst(aln: AlignmentParams) -> None:
    """Resolve the substitution model into aln.subst_matrix (183x15 f32).

    (utils.cc:595-618; triplet models are resolved by the triplet engine.)
    """
    from coati_tpu_torch.models import ecm_p, marginal_p, mg94_p

    if aln.rate:
        from coati_tpu_torch.io.matrix_csv import parse_matrix_csv

        aln.model = "user_marg_model"
        p = parse_matrix_csv(aln.rate)
        aln.subst_matrix = marginal_p(p, aln.pi, aln.amb, aln.sub).astype(np.float32)
    elif aln.model == "mar-ecm":
        p = ecm_p(aln.br_len, aln.omega)
        aln.subst_matrix = marginal_p(p, aln.pi, aln.amb, aln.sub).astype(np.float32)
    elif aln.model == "mar-mg":
        sigma = aln.sigma if any(s > 0 for s in aln.sigma) else None
        p = mg94_p(aln.br_len, aln.omega, aln.pi, sigma)
        aln.subst_matrix = marginal_p(p, aln.pi, aln.amb, aln.sub).astype(np.float32)
    elif aln.model in ("tri-mg", "dna", "tri-ecm"):
        if aln.model == "tri-ecm":
            aln.pi = C.ECM_DNA_PI
        # handled by the triplet engine (coati_tpu.triplet)
        aln.subst_matrix = None
    else:
        raise ValueError("Mutation model unknown.")


# ---------------------------------------------------------------------------
# pre/post processing
# ---------------------------------------------------------------------------
def order_ref(aln: AlignmentParams) -> None:
    """Put the reference sequence first (utils.cc:789-801)."""
    if aln.data.names and aln.data.names[0] == aln.refs:
        return
    if (len(aln.data.names) > 1 and aln.data.names[1] == aln.refs) or aln.rev:
        aln.data.names[0], aln.data.names[1] = aln.data.names[1], aln.data.names[0]
        aln.data.seqs[0], aln.data.seqs[1] = aln.data.seqs[1], aln.data.seqs[0]
    else:
        raise ValueError("Name of reference sequence not found.")


def process_marginal(aln: AlignmentParams) -> None:
    """Validate inputs for the marginal DP path (utils.cc:809-838)."""
    if aln.data.size() != 2:
        raise ValueError("Exactly two sequences required.")
    if aln.refs or aln.rev:
        order_ref(aln)
    len_a = len(aln.seq(0))
    len_b = len(aln.seq(1))
    if len_a % 3 != 0 or len_a % aln.gap.len != 0:
        raise ValueError(
            "Length of reference sequence must be multiple of 3 and gap unit length."
        )
    if len_b % aln.gap.len != 0:
        raise ValueError(
            "Length of descendant sequence must be multiple of gap unit length."
        )
    trim_end_stops(aln.data)


def trim_end_stops(data: SeqData) -> None:
    """Remove terminal stop codons, remembering them (utils.cc:945-967)."""
    for i in range(data.size()):
        seq = data.seqs[i]
        if len(seq) < 3:
            data.stops.append("")
            continue
        last = seq[-3:]
        cod = cod_int(last) if all(ch in "ACGTUacgtu" for ch in last) else -1
        if cod in C.STOP_CODONS_64:
            data.stops.append(last)
            data.seqs[i] = seq[:-3]
        else:
            data.stops.append("")


def restore_end_stops(data: SeqData, gap) -> None:
    """Re-append trimmed stop codons post alignment (utils.cc:1044-1063)."""
    if len(data.stops) != 2:
        raise RuntimeError("Error restoring end stop codons.")
    # logf(g*e*e) computed in f32 like the reference
    gap_score = np.log(
        np.float32(gap.open) * np.float32(gap.extend) * np.float32(gap.extend)
    ).astype(np.float32)
    if len(data.stops[0]) == len(data.stops[1]):
        data.seqs[0] += data.stops[0]
        data.seqs[1] += data.stops[1]
    elif not data.stops[0]:
        data.seqs[0] += "---"
        data.seqs[1] += data.stops[1]
        data.score = float(np.float32(data.score) + np.float32(gap_score))
    elif not data.stops[1]:
        data.seqs[0] += data.stops[0]
        data.seqs[1] += "---"
        data.score = float(np.float32(data.score) + np.float32(gap_score))


def process_alignment(aln: AlignmentParams) -> str:
    """Validate a given pairwise alignment for scoring; return expanded CIGAR.

    Also trims aligned terminal stop codons by replacing them with gaps
    (utils.cc:847-938).
    """
    if aln.data.size() != 2:
        raise ValueError("Exactly two sequences required.")
    if aln.refs or aln.rev:
        order_ref(aln)

    len_a = len(aln.data.seqs[0])
    len_b = len(aln.data.seqs[1])
    if len_a != len_b:
        raise ValueError(
            "For alignment scoring both sequences must have equal length."
        )

    # find last three non-gap positions; if they spell a stop codon, replace
    # with gaps and remember
    for i in range(2):
        seq = aln.data.seqs[i]
        positions = [p for p in range(len(seq)) if seq[p] != "-"]
        if len(positions) < 3:
            aln.data.stops.append("")
            continue
        p1, p2, p3 = positions[-3], positions[-2], positions[-1]
        last_cod = seq[p1] + seq[p2] + seq[p3]
        cod = cod_int(last_cod) if all(ch in "ACGTUacgtu" for ch in last_cod) else -1
        if cod in C.STOP_CODONS_64:
            aln.data.stops.append(last_cod)
            s = list(seq)
            s[p1] = s[p2] = s[p3] = "-"
            aln.data.seqs[i] = "".join(s)
        else:
            aln.data.stops.append("")

    cigar = []
    for a, b in zip(aln.data.seqs[0], aln.data.seqs[1]):
        if a != "-" and b != "-":
            cigar.append("M")
        elif a != "-" and b == "-":
            cigar.append("D")
        elif a == "-" and b != "-":
            cigar.append("I")
    aln.data.seqs[0] = aln.data.seqs[0].replace("-", "")
    aln.data.seqs[1] = aln.data.seqs[1].replace("-", "")

    len_a = len(aln.seq(0))
    len_b = len(aln.seq(1))
    if len_a % 3 != 0 or len_a % aln.gap.len != 0:
        raise ValueError(
            "Length of reference sequence must be multiple of 3 and gap unit length."
        )
    if len_b % aln.gap.len != 0:
        raise ValueError(
            "Length of descendant sequence must be multiple of gap unit length."
        )
    return "".join(cigar)


def process_triplet(aln: AlignmentParams) -> None:
    """Validate inputs for the triplet (FST-equivalent) path (utils.cc:1102-1135)."""
    if aln.data.size() != 2:
        raise ValueError("Exactly two sequences required.")
    if aln.refs or aln.rev:
        order_ref(aln)
    if len(aln.seq(0)) % 3 != 0:
        raise ValueError("Length of reference sequence must be multiple of 3.")
    seq0 = aln.seq(0).upper()
    for i in range(0, len(seq0) - 3, 3):
        if seq0[i : i + 3] in C.STOP_CODON_STRS:
            raise ValueError("Early stop codon in ancestor.")
    if any(ch not in "ACGTUacgtu" for ch in aln.seq(0)):
        raise ValueError("Ambiguous nucleotides in reference sequence not supported.")
    trim_end_stops(aln.data)
