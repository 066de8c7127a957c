"""Seeded inputs of the tools and of chip_smoke.py.

Copies of the JAX package's generators, draw for draw, so that equal seeds
give equal pairs: make_pairs is bench.py's, make_group
tools/tpu_parity_check.py's and make_pair tools/run_longpair.py's.
"""

from __future__ import annotations

import math

import numpy as np

from coati_tpu_torch.constants import CODONS61

# the length classes (nt) and weights of the repo's bench headline
LENGTH_MIX = [(156, 0.35), (471, 0.30), (999, 0.20), (1500, 0.15)]


def make_pairs(n_pairs, rng, length_mix=LENGTH_MIX):
    """Synthetic homologous pairs: ancestor = random codons, descendant =
    ancestor with ~5% point mutations and 0-2 indels of 1-9 nt. Draw for
    draw the pairs of the repo's bench (bench.py make_pairs), so equal seeds
    give equal pairs."""
    codon_arr = np.array(CODONS61)
    lengths = [l for l, _ in length_mix]
    probs = np.array([p for _, p in length_mix])
    probs = probs / probs.sum()
    pairs = []
    for _ in range(n_pairs):
        nt_len = int(rng.choice(lengths, p=probs))
        anc = "".join(rng.choice(codon_arr, size=nt_len // 3))
        pairs.append((anc, descendant(anc, rng)))
    return pairs


def descendant(anc, rng):
    """anc with ~5% point mutations and 0-2 indels of 1-9 nt."""
    nts = np.array(list("ACGT"))
    des = list(anc)
    idx = rng.random(len(des)) < 0.05
    for i in np.nonzero(idx)[0]:
        des[i] = str(rng.choice(nts))
    des = "".join(des)
    for _ in range(int(rng.integers(0, 3))):
        ln = int(rng.integers(1, 10))
        pos = int(rng.integers(0, max(1, len(des) - ln)))
        if rng.random() < 0.5:
            des = des[:pos] + des[pos + ln:]
        else:
            ins = "".join(rng.choice(nts, size=ln))
            des = des[:pos] + ins + des[pos:]
    return des


def make_group(rng, n_pairs, k, max_codons, ambig_frac=0.05):
    """n_pairs unrelated pairs for a parity group at gap length k: an
    ancestor of random codons whose length is a multiple of k (2 to
    max_codons codons where every length is), a random descendant of a
    multiple of k nt up to twice as long, a share ambig_frac of its
    nucleotides replaced by IUPAC ambiguity codes. At k = 1 and 3 draw for
    draw tools/tpu_parity_check.py's make_group."""
    codon_arr = np.array(CODONS61)
    ambig = np.array(list("RYSWKMBDHVN"))
    nts = np.array(list("ACGT"))
    unit = k // math.gcd(k, 3)  # codons a whole number of gap units
    pairs = []
    for _ in range(n_pairs):
        n_cod = int(rng.integers(2 if unit == 1 else 1, max_codons // unit + 1)) * unit
        anc = "".join(rng.choice(codon_arr, size=n_cod))
        m = int(rng.integers(1, 2 * n_cod + 1)) * 3
        m = max(m - m % k, k)
        des = list(rng.choice(nts, size=m))
        for i in np.nonzero(rng.random(m) < ambig_frac)[0]:
            des[i] = str(rng.choice(ambig))
        pairs.append((anc, "".join(des)))
    return pairs


def make_pair(rng, n_codons):
    """One long homologous pair: n_codons random codons, the descendant with
    ~5% point mutations and 12 indels of 1-9 nt."""
    codon_arr = np.array(CODONS61)
    anc = "".join(rng.choice(codon_arr, size=n_codons))
    des = list(anc)
    idx = rng.random(len(des)) < 0.05
    nts = np.array(list("ACGT"))
    for i in np.nonzero(idx)[0]:
        des[i] = str(rng.choice(nts))
    des = "".join(des)
    for _ in range(12):
        ln = int(rng.integers(1, 10))
        pos = int(rng.integers(0, max(1, len(des) - ln)))
        if rng.random() < 0.5:
            des = des[:pos] + des[pos + ln:]
        else:
            ins = "".join(rng.choice(nts, size=ln))
            des = des[:pos] + ins + des[pos:]
    return anc, des
