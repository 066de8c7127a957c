"""Newick tree parsing and manipulation (reference tree.cc).

The reference uses Boost Spirit X3; this is a recursive-descent parser
producing the same flat `tree_t` layout: preorder with each internal node
before its children, `parent` self-loop at the root (tree.cc:29-107 grammar,
:196-236 expected layout).
"""

from __future__ import annotations

import dataclasses
import re


@dataclasses.dataclass
class Node:
    label: str = ""
    length: float = 0.0
    is_leaf: bool = False
    parent: int = 0
    children: list = dataclasses.field(default_factory=list)


TreeT = list  # list[Node]

_LABEL_RE = re.compile(r"[-0-9A-Za-z/%_.]+")


def read_newick(path: str) -> str:
    try:
        with open(path) as f:
            content = f.read()
    except OSError as exc:
        raise ValueError(f"Error opening {path}.") from exc
    if not content:
        raise ValueError("Reading tree failed, file is empty!")
    return content


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.text)

    def peek(self) -> str:
        return self.text[self.pos] if not self.eof() else ""

    def label(self) -> str:
        m = _LABEL_RE.match(self.text, self.pos)
        if not m:
            return ""
        self.pos = m.end()
        return m.group(0)

    _FLOAT_RE = re.compile(r"[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?")

    def length(self) -> float:
        if self.peek() == ":":
            self.pos += 1
            m = self._FLOAT_RE.match(self.text, self.pos)
            if not m:
                raise RuntimeError("Parsing content of newick tree failed.")
            self.pos = m.end()
            return float(m.group(0))
        return 0.0

    def node(self) -> TreeT:
        if self.peek() == "(":
            return self.inode()
        return self.leaf()

    def leaf(self) -> TreeT:
        label = self.label()
        if not label:
            raise RuntimeError("Parsing content of newick tree failed.")
        length = self.length()
        return [Node(label, length, True, 0)]

    def inode(self) -> TreeT:
        assert self.peek() == "("
        self.pos += 1
        subtrees = [self.node()]
        while self.peek() == ",":
            self.pos += 1
            subtrees.append(self.node())
        if self.peek() != ")":
            raise RuntimeError("Parsing content of newick tree failed.")
        self.pos += 1
        label = self.label()
        length = self.length()
        out: TreeT = [Node(label, length, False, 0)]
        for sub in subtrees:
            n = len(out)
            for nd in sub:
                nd = dataclasses.replace(nd, children=list(nd.children))
                nd.parent += n
                out.append(nd)
            out[n].parent = 0
        return out


def parse_newick(content: str) -> TreeT:
    """Parse newick text into the flat tree layout (tree.cc:174-192)."""
    for ch in ("\t", "\n", " "):
        content = content.replace(ch, "")
    p = _Parser(content)
    tree = p.node()
    if p.peek() == ";":
        p.pos += 1
    if not p.eof():
        raise RuntimeError("Parsing content of newick tree failed.")
    return tree


def find_node(tree: TreeT, name: str) -> int:
    for i, nd in enumerate(tree):
        if nd.label == name:
            return i
    raise ValueError(f"Node {name} not found.")


def find_seq(name: str, data) -> str:
    try:
        return data.seqs[data.names.index(name)]
    except ValueError:
        raise ValueError(f"Sequence {name} not found.") from None


def reroot(tree: TreeT, nroot_name: str) -> None:
    """Make the named leaf the outgroup (tree.cc:332-359)."""
    ref = find_node(tree, nroot_name)
    newroot = tree[ref].parent
    ancestors = []
    node = newroot
    while tree[node].parent != node:
        ancestors.append(node)
        node = tree[node].parent
    ancestors.append(node)
    for i in range(len(ancestors) - 1, 0, -1):
        tree[ancestors[i]].parent = ancestors[i - 1]
        tree[ancestors[i]].length = tree[ancestors[i - 1]].length
    tree[newroot].parent = newroot
    tree[newroot].length = 0.0


def distance_ref(tree: TreeT, ref: int, node: int) -> float:
    """Path length node -> root plus root -> ref (tree.cc:440-453)."""
    distance = 0.0
    while tree[node].parent != node:
        distance += tree[node].length
        node = tree[node].parent
    return distance + tree[ref].length
