"""FASTA codec (reference fasta.cc:39-87 reader, 60-column writer)."""

from __future__ import annotations

from typing import TextIO

from coati_tpu_torch.structs import SeqData


def read_fasta(stream: TextIO) -> SeqData:
    data = SeqData()
    name = None
    content: list[str] = []
    for line in stream:
        line = line.rstrip("\n")
        if not line:
            continue
        if line.startswith(";"):
            continue
        if line.startswith(">"):
            if name is not None:
                data.seqs.append("".join(content))
            name = line[1:]
            if not name:
                raise ValueError(
                    "Input fasta file contains a sequence without a name."
                )
            data.names.append(name)
            content = []
        elif name is not None:
            content.append("".join(line.split()))
    if name is not None:
        data.seqs.append("".join(content))
    return data


def write_fasta(data: SeqData, stream: TextIO) -> None:
    for name, seq in zip(data.names, data.seqs):
        stream.write(">" + name + "\n")
        for i in range(0, len(seq), 60):
            stream.write(seq[i : i + 60] + "\n")
