"""Tools of the port, each run as `python -m coati_tpu_torch.tools.<name>`
(counterparts of the JAX package's tools/):

- gpu_parity_check: the engines on the card against the f32 oracles, written
  to tests/data/torch_gpu_parity.json;
- run_longpair: the 32 knt and 160 knt pairs through the long-pair path,
  written to tests/data/torch_gpu_longpair.json;
- profile_batch, probe_kernel, probe_triplet: where the time of the mixed
  batch, of a bucket's kernels and of the triplet batch goes;
- inputs: the seeded pairs they and chip_smoke.py draw.

Each takes --device (default cuda; cpu runs the plain versions at a small
size) and refuses cuda where there is none.
"""
