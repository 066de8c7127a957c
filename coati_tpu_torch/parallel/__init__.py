"""Data parallelism over lanes (parallel.mesh) and processes
(parallel.multihost). Counterpart of coati_tpu/parallel."""

from coati_tpu_torch.parallel.mesh import (
    make_mesh,
    sharded_align_step,
    sharded_viterbi_scores,
)

__all__ = ["make_mesh", "sharded_align_step", "sharded_viterbi_scores"]
