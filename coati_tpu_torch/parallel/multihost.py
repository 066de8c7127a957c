"""Multi-process scale-out on torch.distributed (counterpart of
coati_tpu/parallel/multihost.py).

The workload is data-parallel over sequence pairs: each process reads its
contiguous shard of the pair stream, aligns it on its own devices and writes
its own shard file; the scores are then allgathered and process 0 merges
the shards. The collectives carry small host arrays, so they use the gloo
backend everywhere, on a card's host too: NCCL refuses two ranks on one
card, which is how one card runs two processes.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Join a gloo process group: at tcp://{coordinator} (host:port) with
    the given size and rank, or, with no coordinator, from the env://
    variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) when they are
    set. Otherwise, or when a group is already up, nothing: one process, as
    the JAX package's initialize falls through outside a cluster. Returns
    whether this call started a group."""
    if dist.is_initialized():
        return False
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs the process count and index")
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
        return True
    if all(v in os.environ for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")):
        dist.init_process_group("gloo", init_method="env://")
        return True
    return False


def rank() -> int:
    """This process's index in the group (0 alone)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of processes in the group (1 alone)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_devices() -> list[str]:
    """The cards this process owns, by name (counterpart of
    jax.local_devices()): where LOCAL_RANK and LOCAL_WORLD_SIZE are set, as
    torchrun sets them, every card q with q % LOCAL_WORLD_SIZE == LOCAL_RANK,
    so that the processes on one node split its cards (with more processes
    than cards, process r shares card r % cards); otherwise every card.
    Either way capped by COATI_TPU_MAX_DEVICES, as device.resolve_devices
    caps "cuda". No card: an empty list."""
    n = torch.cuda.device_count()
    cards = list(range(n))
    if n and "LOCAL_RANK" in os.environ and "LOCAL_WORLD_SIZE" in os.environ:
        local_rank = int(os.environ["LOCAL_RANK"])
        local_size = int(os.environ["LOCAL_WORLD_SIZE"])
        cards = [q for q in cards if q % local_size == local_rank] or [local_rank % n]
    cap = int(os.environ.get("COATI_TPU_MAX_DEVICES", "0"))
    if cap > 0:
        cards = cards[:cap]
    return [f"cuda:{q}" for q in cards]


def shard_bounds(n: int, process_index: int | None = None,
                 process_count: int | None = None) -> tuple[int, int]:
    """[lo, hi) global-index bounds of this process's contiguous shard."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    per = -(-n // pc)
    lo = min(pi * per, n)
    return lo, min(lo + per, n)


def host_shard(items: list, process_index: int | None = None,
               process_count: int | None = None) -> list:
    """This process's contiguous shard of a work list (the pair stream is
    cut before encoding, so each process touches only its own input)."""
    lo, hi = shard_bounds(len(items), process_index, process_count)
    return items[lo:hi]


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def merge_multihost_outputs(output_base: str, local_scores, n_total: int):
    """Collate a multi-process batch run, with the JAX package's file
    contract.

    1. Each process's scores (NaN for error rows), padded with NaN to the
       shard size, are allgathered in process order into one global array;
       process 0 writes it to `{output_base}.scores.json` (error rows carry
       null).
    2. After a barrier (every process has closed its shard file), process 0
       concatenates the shards `{output_base}.{p}` into `{output_base}` when
       every one of them is visible on its filesystem. A second barrier
       keeps every process until the merge is done.

    local_scores: float32 array over THIS process's shard positions.
    Returns (global_scores, merged path or None)."""
    pc = world_size()
    per = -(-n_total // pc) if n_total else 0
    pad = torch.full((max(per, 1),), float("nan"), dtype=torch.float32)
    pad[: len(local_scores)] = torch.from_numpy(np.asarray(local_scores, np.float32))
    if dist.is_initialized():
        parts = [torch.empty_like(pad) for _ in range(pc)]
        dist.all_gather(parts, pad)
    else:
        parts = [pad]
    scores = torch.cat(parts).numpy()[:n_total]

    _barrier()  # every process has written and closed its shard
    merged = None
    if rank() == 0 and output_base:
        with open(f"{output_base}.scores.json", "w") as f:
            json.dump({"n_pairs": n_total,
                       "scores": [None if np.isnan(s) else float(s) for s in scores]}, f)
        shard_files = [f"{output_base}.{p}" for p in range(pc)]
        if all(os.path.exists(s) for s in shard_files):
            with open(output_base, "w") as out:
                for s in shard_files:
                    with open(s) as fh:
                        out.write(fh.read())
            merged = output_base
    _barrier()
    return scores, merged


def global_scores_allgather(local_scores: np.ndarray, mesh) -> np.ndarray:
    """The scores as the JAX package's global_scores_allgather returns them:
    a copy of the input, in order. There the scores are sharded over the
    mesh's devices and gathered back; here they live on the host, where
    nothing needs gathering. `mesh` is taken for the same signature."""
    return np.array(local_scores, dtype=np.float32)
