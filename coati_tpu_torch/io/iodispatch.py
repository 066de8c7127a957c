"""Input/output dispatch by `[format:]file` spec (reference io.cc:184-346,
utils.cc:630-645)."""

from __future__ import annotations

import sys
from dataclasses import dataclass

from coati_tpu_torch.io.fasta import read_fasta, write_fasta
from coati_tpu_torch.io.jsonio import read_json, write_json
from coati_tpu_torch.io.phylip import read_phylip, write_phylip
from coati_tpu_torch.structs import AlignmentParams, SeqData


@dataclass
class FileType:
    path: str
    type_ext: str


def extract_file_type(path: str) -> FileType:
    """Extract extension from `file.ext` or `ext:file` specs (utils.cc:630-645)."""
    path = path.strip(" \f\n\r\t\v")
    colon = path.find(":")
    if colon > 1:
        return FileType(path[colon + 1 :], "." + path[:colon])
    # suffix extension (pathlib semantics differ slightly; mirror C++
    # std::filesystem::path::extension: leading-dot-only names have none)
    base = path.rsplit("/", 1)[-1]
    if base in (".", ".."):
        return FileType(path, "")
    dot = base.rfind(".")
    if dot > 0:
        return FileType(path, base[dot:])
    return FileType(path, "")


def read_input(aln: AlignmentParams) -> SeqData:
    if not aln.data.path:
        in_type = FileType("-", ".json")
    else:
        in_type = extract_file_type(str(aln.data.path))

    if not in_type.path or in_type.path == "-":
        stream = sys.stdin
        close = False
    else:
        try:
            stream = open(in_type.path, "r")
        except OSError as exc:
            raise ValueError(
                f"Opening input file {aln.data.path} failed."
            ) from exc
        close = True

    try:
        if in_type.type_ext in (".fa", ".fasta"):
            data = read_fasta(stream)
        elif in_type.type_ext == ".phy":
            data = read_phylip(stream)
        elif in_type.type_ext == ".json":
            data = read_json(stream)
        else:
            raise ValueError(f"Invalid input {aln.data.path}.")
    finally:
        if close:
            stream.close()
    data.path = str(aln.data.path)
    return data


def write_output(aln: AlignmentParams) -> None:
    if not aln.output:
        out_type = FileType("-", ".json")
    else:
        out_type = extract_file_type(str(aln.output))

    if out_type.path == "-":
        stream = sys.stdout
        close = False
    else:
        stream = open(out_type.path, "w")
        close = True

    try:
        if out_type.type_ext in (".fa", ".fasta"):
            write_fasta(aln.data, stream)
        elif out_type.type_ext == ".phy":
            write_phylip(aln.data, stream)
        elif out_type.type_ext == ".json":
            write_json(aln.data, stream)
        else:
            raise ValueError(f"Invalid output format {out_type.type_ext}.")
    finally:
        if close:
            stream.close()
