"""Semiring scalar helpers in float32, mirroring reference semiring.hpp.

The DP kernels select ops at trace time (tropical = Viterbi, log = Forward);
these helpers give f32-faithful scalar constants and the piecewise
log1p_exp/log_sum_exp used by the reference (utils.hpp:120-160).
"""

from __future__ import annotations

import numpy as np

from coati_tpu_torch.constants import F32_LOWEST

TROPICAL = "tropical"
LOG = "log"


def gap_constants(gap_open: float, gap_extend: float):
    """(no_gap, gap_stop, gap_open, gap_extend) in log space, float32.

    no_gap = log1p(-g), gap_stop = log1p(-e), gap_open = log(g),
    gap_extend = log(e) — computed with f32 ops like the reference
    (align_pair.cc:66-69).
    """
    g = np.float32(gap_open)
    e = np.float32(gap_extend)
    return (
        np.log1p(np.float32(-g)).astype(np.float32),
        np.log1p(np.float32(-e)).astype(np.float32),
        np.log(g).astype(np.float32),
        np.log(e).astype(np.float32),
    )


def log1p_exp_f32(x):
    """Piecewise-stable log(1+exp(x)) for float32 (utils.hpp:134-146)."""
    x = np.float32(x)
    if x <= np.float32(-16.0):
        return np.exp(x).astype(np.float32)
    if x <= np.float32(8.0):
        return np.log1p(np.exp(x)).astype(np.float32)
    if x <= np.float32(14.5):
        return (x + np.exp(-x)).astype(np.float32)
    return x


def log_sum_exp_f32(a, b):
    """f32 log(exp(a)+exp(b)) (utils.hpp:152-156)."""
    a = np.float32(a)
    b = np.float32(b)
    x = max(a, b)
    y = -np.abs(a - b, dtype=np.float32)
    return np.float32(x + log1p_exp_f32(y))


ZERO = F32_LOWEST  # semiring zero for log/tropical (numeric_limits::lowest)
ONE = np.float32(0.0)
