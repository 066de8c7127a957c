"""Core biological constants and encodings for coati_tpu.

Semantics follow the reference COATi implementation
(COATi src/include/coati/utils.hpp:36-70 nt16 table + amino groups,
COATi src/lib/utils.cc:72-85 codon packing, :1144-1211 61<->64 maps)
but everything here is re-derived structurally from the standard genetic code
rather than transcribed.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# IUPAC nucleotide 16-code:  A C G T R Y M K S W B D H V N -
#   index:                   0 1 2 3 4 5 6 7 8 9 10 11 12 13 14 15
# (reference: utils.hpp:36-61)
# ---------------------------------------------------------------------------
NUC_ORDER = "ACGT"
IUPAC_ORDER = "ACGTRYMKSWBDHVN-"

# which plain nucleotides each IUPAC symbol covers (by ACGT index)
IUPAC_SETS = {
    "A": (0,), "C": (1,), "G": (2,), "T": (3,), "U": (3,),
    "R": (0, 2), "Y": (1, 3), "M": (0, 1), "K": (2, 3),
    "S": (1, 2), "W": (0, 3),
    "B": (1, 2, 3), "D": (0, 2, 3), "H": (0, 1, 3), "V": (0, 1, 2),
    "N": (0, 1, 2, 3),
}

# char -> nt16 code lookup table over 256 ASCII values; invalid -> 16
NT16_TABLE = np.full(256, 16, dtype=np.uint8)
for _i, _c in enumerate(IUPAC_ORDER):
    NT16_TABLE[ord(_c)] = _i
    NT16_TABLE[ord(_c.lower())] = _i
NT16_TABLE[ord("U")] = 3
NT16_TABLE[ord("u")] = 3

# ---------------------------------------------------------------------------
# Codons.
# 64-codon index: cod = n0*16 + n1*4 + n2  (A=0,C=1,G=2,T=3), i.e. bit-packed
# exactly like the reference's cod_int (utils.cc:72-85).
# 61-codon index: same ordering with the three stop codons removed
# (TAA=48, TAG=50, TGA=56 in 64-index space).
# ---------------------------------------------------------------------------
STOP_CODONS_64 = (48, 50, 56)
STOP_CODON_STRS = ("TAA", "TAG", "TGA")

CODONS64 = [NUC_ORDER[c >> 4] + NUC_ORDER[(c >> 2) & 3] + NUC_ORDER[c & 3]
            for c in range(64)]
CODONS61 = [c for i, c in enumerate(CODONS64) if i not in STOP_CODONS_64]

# maps between the two index spaces
COD64_TO_61 = np.full(64, -1, dtype=np.int32)
COD61_TO_64 = np.zeros(61, dtype=np.int32)
_j = 0
for _i in range(64):
    if _i in STOP_CODONS_64:
        continue
    COD64_TO_61[_i] = _j
    COD61_TO_64[_j] = _i
    _j += 1

# nucleotide of codon (61-index) at position 0/1/2, values 0..3
CODON_NUC = np.zeros((61, 3), dtype=np.int32)
for _i in range(61):
    c64 = int(COD61_TO_64[_i])
    CODON_NUC[_i] = [(c64 >> 4) & 3, (c64 >> 2) & 3, c64 & 3]

# ---------------------------------------------------------------------------
# Standard genetic code -> amino-acid group per codon (61-index).
# The reference stores ASCII codes of the amino-acid letter
# (utils.hpp:66-70 `amino_group`); we derive them from the genetic code.
# ---------------------------------------------------------------------------
_GENETIC_CODE = {
    # Phe / Leu
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    # Ile / Met
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    # Val
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
    # Ser
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "AGT": "S", "AGC": "S",
    # Pro
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    # Thr
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    # Ala
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    # Tyr
    "TAT": "Y", "TAC": "Y",
    # His / Gln
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    # Asn / Lys
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    # Asp / Glu
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    # Cys / Trp
    "TGT": "C", "TGC": "C", "TGG": "W",
    # Arg
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "AGA": "R", "AGG": "R",
    # Gly
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}

AMINO_GROUP = np.array([ord(_GENETIC_CODE[c]) for c in CODONS61], dtype=np.uint8)

# ---------------------------------------------------------------------------
# Model defaults (reference structs.hpp:37-99)
# ---------------------------------------------------------------------------
DEFAULT_BR_LEN = 0.0133
DEFAULT_OMEGA = 0.2
DEFAULT_PI = (0.308, 0.185, 0.199, 0.308)
DEFAULT_GAP_LEN = 1
DEFAULT_GAP_OPEN = 0.001
DEFAULT_GAP_EXTEND = 1.0 - 1.0 / 6.0
DEFAULT_BC_ERROR = 0.0001
DEFAULT_SIGMA = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

# Yang (1994) nucleotide substitution rates used by MG94 when no GTR sigmas
# are given (reference mutation_coati.cc:65-68)
YANG_1994_NUC_Q = np.array(
    [
        [-0.818, 0.132, 0.586, 0.1],
        [0.221, -1.349, 0.231, 0.897],
        [0.909, 0.215, -1.322, 0.198],
        [0.1, 0.537, 0.128, -0.765],
    ],
    dtype=np.float64,
)

# ECM DNA stationary frequencies used when model == tri-ecm
# (reference utils.cc:612-614)
ECM_DNA_PI = (0.2676350, 0.2357727, 0.2539630, 0.2426323)

# float32 "lowest" used as semiring zero by the reference
# (std::numeric_limits<float>::lowest())
F32_LOWEST = np.float32(np.finfo(np.float32).min)
