"""coati_tpu_torch: the PyTorch/CUDA port of coati_tpu.

The JAX package `coati_tpu` stays the reference. This package owns every
module that touches a device (the marginal Viterbi fill and traceback walk,
as hand-written CUDA kernels with plain PyTorch versions beside them) and
imports the jax-free host modules of `coati_tpu` (codecs, models, I/O,
scoring) instead of copying them. It never imports jax.
"""

from coati_tpu import __version__

__all__ = ["__version__"]
