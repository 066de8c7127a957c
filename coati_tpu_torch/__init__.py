"""coati_tpu_torch: the PyTorch/CUDA port of coati_tpu.

The JAX package `coati_tpu` stays the reference the tests hold this package
to, but this package imports nothing of it: it keeps its own copies of the
host modules it needs (constants, structs, utils, version, profiling, io/,
models/, align/semiring, align/score) under the same names, and owns every
module that touches a device. Ported so far: marginal Viterbi alignment of
pair batches (`alignpair`, `batch`), long pairs through the segmented
two-pass path, and score-only Viterbi, each on hand-written CUDA kernels
with plain PyTorch versions beside them. Still to port (ROADMAP.md, "Modules
to port"): sampling (item 8), triplet models (item 9), msa and the other
verbs (item 5), multi-device (item 10).
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
