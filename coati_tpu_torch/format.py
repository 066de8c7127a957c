"""The `format` verb: convert formats, extract/reorder seqs, preserve phase.

Mirrors reference format.cc:41-128.
"""

from __future__ import annotations

import dataclasses

from coati_tpu_torch.io import write_output
from coati_tpu_torch.structs import AlignmentParams, SeqData


@dataclasses.dataclass
class FormatArgs:
    preserve_phase: bool = False
    padding: str = "?"
    names: list = dataclasses.field(default_factory=list)
    pos: list = dataclasses.field(default_factory=list)


def extract_seqs(fmt: FormatArgs, data: SeqData) -> None:
    """Keep only sequences specified by name or 1-based position
    (format.cc:89-128)."""
    if fmt.names:
        pos = []
        for name in fmt.names:
            try:
                pos.append(data.names.index(name) + 1)
            except ValueError:
                raise ValueError(f"Sequence {name} not found.") from None
        fmt.pos = pos

    if fmt.pos:
        if min(fmt.pos) == 0 or max(fmt.pos) > data.size():
            raise ValueError("Positions of seqs to extract are of out range")
        data.names = [data.names[p - 1] for p in fmt.pos]
        data.seqs = [data.seqs[p - 1] for p in fmt.pos]


def format_sequences(fmt: FormatArgs, aln: AlignmentParams) -> int:
    """Format/extract/pad sequences and write output (format.cc:41-76)."""
    if fmt.names or fmt.pos:
        extract_seqs(fmt, aln.data)

    if fmt.preserve_phase:
        if fmt.padding == "-":
            raise ValueError(f"Invalid padding character {fmt.padding} .")
        pad = fmt.padding[0]
        seq0 = aln.data.seqs[0]
        pos = seq0.find("-")
        while pos != -1:
            gap_len = 0
            while pos + gap_len < len(seq0) and seq0[pos + gap_len] == "-":
                gap_len += 1
            n_pad = gap_len % 3
            if n_pad:
                # pad so the next codon starts in frame: gap len 1 (mod 3)
                # gets 2 pads, len 2 gets 1 (format.cc:60-68 fallthrough)
                insert = pad * (3 - n_pad)
                aln.data.seqs = [
                    s[: pos + gap_len] + insert + s[pos + gap_len :]
                    for s in aln.data.seqs
                ]
                seq0 = aln.data.seqs[0]
            pos = seq0.find("-", pos + gap_len)

    write_output(aln)
    return 0
