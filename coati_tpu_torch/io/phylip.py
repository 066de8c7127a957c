"""PHYLIP interleaved codec (reference phylip.cc:37-97 reader, :194-215 writer).

Writer layout: "<n> <len>" header; per-seq line = 10-char padded name +
first 50 chars; blank line; then 60-char blocks per sequence, blank line
after each block group.
"""

from __future__ import annotations

from typing import TextIO

from coati_tpu_torch.structs import SeqData


def read_phylip(stream: TextIO) -> SeqData:
    data = SeqData()
    header = stream.readline().split()
    if len(header) < 2:
        raise ValueError("Invalid phylip header.")
    n_seqs = int(header[0])
    data.names = [""] * n_seqs
    data.seqs = [""] * n_seqs

    # first block: names + first chunk
    read = 0
    while read < n_seqs:
        line = stream.readline()
        if line == "":
            raise ValueError("Unexpected end of phylip file.")
        line = line.rstrip("\n")
        if not line:
            continue
        data.names[read] = "".join(line[:10].split())
        data.seqs[read] = "".join(line[10:].split())
        read += 1

    # remaining interleaved blocks
    count = 0
    for line in stream:
        line = line.rstrip("\n")
        if not line:
            continue
        data.seqs[count % n_seqs] += "".join(line.split())
        count += 1
    return data


def write_phylip(data: SeqData, stream: TextIO) -> None:
    stream.write(f"{data.size()} {len(data.seqs[0])}\n")
    i = 50
    for name, seq in zip(data.names, data.seqs):
        padded = name[:10].ljust(10)
        stream.write(padded + seq[:i] + "\n")
    stream.write("\n")
    length = len(data.seqs[0])
    while i < length:
        for seq in data.seqs:
            stream.write(seq[i : i + 60] + "\n")
        stream.write("\n")
        i += 60
