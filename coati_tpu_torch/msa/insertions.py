"""Insertion bookkeeping for reference-anchored MSA (reference insertions.cc).

Tracks open ('o'=111) vs closed ('c'=99) insertion flags per alignment
column while pairwise alignments are merged up the guide tree. Semantics
are a faithful port of merge_indels/add_closed_ins/check_all_open/
find_open_ins/add_gap (insertions.cc:38-438); these run on the host — the
data is tiny and the logic is inherently sequential.
"""

from __future__ import annotations

import dataclasses

OPEN = 111  # 'o'
CLOSED = 99  # 'c'


class InsVector:
    """Sparse int vector with Eigen::SparseVector-like semantics."""

    def __init__(self, cols: int, items: dict | None = None):
        self.cols = cols
        self.d: dict[int, int] = dict(items or {})

    def get(self, pos: int) -> int:
        return self.d.get(pos, 0)

    def set(self, pos: int, val: int) -> None:
        if val == 0:
            self.d.pop(pos, None)
        else:
            self.d[pos] = val

    def nonzeros(self) -> int:
        return sum(1 for v in self.d.values() if v != 0)

    def shift_right_after(self, pos: int) -> None:
        """ins[i] = ins[i-1] for i in (pos, cols); drops the last element.

        (add_gap's manual shift loop, insertions.cc:431-435)"""
        new = {}
        for p, v in self.d.items():
            if p < pos:
                new[p] = v
            elif p + 1 < self.cols:
                new[p + 1] = v  # entries at >= pos move up, incl. pos itself
        self.d = new

    def copy(self) -> "InsVector":
        return InsVector(self.cols, self.d)


@dataclasses.dataclass
class InsertionData:
    """Sequences + names + shared insertion flags (insertion_data_t)."""

    sequences: list
    names: list
    insertions: InsVector

    @classmethod
    def single(cls, seq: str, name: str, ins: InsVector) -> "InsertionData":
        return cls([seq], [name], ins)

    def copy(self) -> "InsertionData":
        return InsertionData(
            list(self.sequences), list(self.names), self.insertions.copy()
        )


def insertion_flags(ref: str, seq: str) -> InsVector:
    """Open-insertion flags from a pairwise alignment (insertions.cc:38-60)."""
    if len(ref) != len(seq):
        raise RuntimeError(
            "Opening insertion flags failed, length of sequences is different."
        )
    ins = InsVector(2 * len(seq))
    for i, ch in enumerate(ref):
        if ch == "-":
            ins.set(i, OPEN)
    return ins


def _char_at(s: str, pos: int) -> str:
    """C++ std::string::operator[] at size() yields NUL."""
    return s[pos] if pos < len(s) else "\0"


def add_gap(ins_data: list, seq_indexes: list, pos: int) -> None:
    """Close the insertion at pos for seq_indexes; insert a gap column into
    every other group (insertions.cc:410-438)."""
    others = [i for i in range(len(ins_data)) if i not in seq_indexes]
    for si in seq_indexes:
        ins_data[si].insertions.set(pos, CLOSED)
    for si in others:
        grp = ins_data[si]
        grp.sequences = [s[:pos] + "-" + s[pos:] for s in grp.sequences]
        grp.insertions.shift_right_after(pos)
        grp.insertions.set(pos, CLOSED)


def add_closed_ins(ins_data: list, pos: int) -> int:
    """Propagate already-closed insertions at/after pos (insertions.cc:150-163).

    Mirrors the C++ loop: on processing a closed insertion the local pos
    advances and the same group index is re-examined."""
    processed = 0
    seq = 0
    while seq < len(ins_data):
        if ins_data[seq].insertions.get(pos) == CLOSED:
            add_gap(ins_data, [seq], pos)
            pos += 1
            processed += 1
            continue  # re-check same group at the advanced position
        seq += 1
    return processed


def check_all_open(ins_data: list, pos: int) -> bool:
    """All groups have an open insertion of the same nucleotide at pos
    (insertions.cc:176-194)."""
    nuc = None
    for grp in ins_data:
        if pos > len(grp.sequences[0]):
            return False
        ch = _char_at(grp.sequences[0], pos)
        if nuc is None:
            nuc = ch
        if grp.insertions.get(pos) != OPEN or ch != nuc:
            return False
    return True


def find_open_ins(ins_data: list, pos: int) -> list:
    """Indexes of groups with an open insertion of the first-seen nucleotide
    at pos (insertions.cc:205-230)."""
    indexes: list[int] = []
    nuc = None
    for seq, grp in enumerate(ins_data):
        if grp.insertions.get(pos) == OPEN:
            if pos > len(grp.sequences[0]):
                continue
            ch = _char_at(grp.sequences[0], pos)
            if nuc is None:
                nuc = ch
                indexes.append(seq)
            elif ch == nuc:
                indexes.append(seq)
    return indexes


def merge_indels(ins_data: list) -> InsertionData:
    """Merge the insertion structure of sibling groups (insertions.cc:93-140)."""
    if len(ins_data) < 2:
        raise RuntimeError("Merging indels of only 1 sequence.")

    num_gaps = sum(g.insertions.nonzeros() for g in ins_data)
    processed = 0
    pos = 0
    while processed < num_gaps:
        processed += add_closed_ins(ins_data, pos)
        if check_all_open(ins_data, pos):
            pos += 1
            processed += len(ins_data)
            continue
        indexes = find_open_ins(ins_data, pos)
        if indexes:
            add_gap(ins_data, indexes, pos)
            processed += len(indexes)
        pos += 1

    merged = InsertionData([], [], ins_data[0].insertions)
    for grp in ins_data:
        merged.sequences.extend(grp.sequences)
        merged.names.extend(grp.names)
    return merged
