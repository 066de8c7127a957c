"""User rate-matrix CSV parser (reference io.cc:48-88).

Format: first line = branch length; then 3721 lines `codon,codon,rate`.
Returns P = expm(Q * t) with the same orientation as mg94_p.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import expm

from coati_tpu_torch.utils import cod64_to_61, cod_int


def parse_matrix_csv(path: str) -> np.ndarray:
    try:
        f = open(path, "r")
    except OSError as exc:
        raise ValueError(f"Error opening file {path}.") from exc

    with f:
        br_len = float(f.readline())
        q = np.zeros((61, 61), dtype=np.float64)
        count = 0
        for line in f:
            line = line.strip()
            if not line:
                continue
            c0, c1, val = line.split(",")
            q[cod64_to_61(cod_int(c0)), cod64_to_61(cod_int(c1))] = float(val)
            count += 1

    if count != 3721:
        raise ValueError("Error reading substitution rate CSV file. Exiting!")

    return expm(q * br_len)
