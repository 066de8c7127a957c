"""coati_tpu_torch: the PyTorch/CUDA port of coati_tpu.

The JAX package `coati_tpu` stays the reference the tests hold this package
to, but this package imports nothing of it: it keeps its own copies of the
host modules it needs (constants, structs, utils, version, profiling, io/,
models/, align/semiring, align/score, rng, format, msa/, triplet_hmm) under
the same names, and owns every
module that touches a device. Ported: all seven verbs of the CLI; marginal
Viterbi alignment of pair batches (`alignpair`, `batch`, `msa`), long pairs
through the segmented two-pass path, score-only Viterbi, sampling from the
Forward distribution (`sample`), and the triplet models tri-mg, tri-ecm and
dna (`alignpair`, `batch`) with their own segmented path; several devices
(the engine's chunks round-robin over a list of lanes, the mesh entry points
of `parallel/mesh.py`) and several processes (`batch --multihost` on
torch.distributed); a torch.profiler trace (`batch --trace-dir`); the tools
(`coati_tpu_torch.tools`: the parity and long-pair evidence, the probes);
the bench (`python -m coati_tpu_torch.bench`, bench.py's sections on the
card); every device kernel of the JAX package has a hand-written CUDA kernel
here with a plain PyTorch version beside it.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
