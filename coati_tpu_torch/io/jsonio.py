"""JSON codec matching the reference's nlohmann ordered_json output bytes
(json.cc:37-56, :163-226): 2-space indent, insertion key order, score as a
double (shortest round-trip repr, same as Python's float repr).
"""

from __future__ import annotations

import json
from typing import TextIO

import numpy as np

from coati_tpu_torch.structs import SeqData


def _score_value(score: float):
    # reference stores float32 and serializes as double
    return float(np.float32(score))


def to_json_obj(data: SeqData) -> dict:
    return {
        "alignment": {n: s for n, s in zip(data.names, data.seqs)},
        "score": _score_value(data.score),
    }


def read_json(stream: TextIO) -> SeqData:
    obj = json.load(stream)
    data = SeqData()
    for name, seq in obj["alignment"].items():
        data.names.append(name)
        data.seqs.append(seq)
    data.score = float(obj["score"])
    return data


def write_json(data: SeqData, stream: TextIO) -> None:
    stream.write(json.dumps(to_json_obj(data), indent=2))
    stream.write("\n")


def write_json_sample(data: SeqData, stream: TextIO, iter_: int, total: int) -> None:
    """Streaming JSON array for `coati sample` (json.cc:211-226)."""
    if iter_ == 0:
        stream.write("[\n")
    stream.write(json.dumps(to_json_obj(data), indent=2))
    if iter_ < total - 1:
        stream.write(",\n")
    else:
        stream.write("\n]\n")
