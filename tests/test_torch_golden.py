"""Golden results of the JAX reference on main-path pairs, shared with
chip_smoke.py.

tests/data/torch_main_path_golden.json holds, for the first 8 pairs of each
length class of the main-path batch (bench.py's make_pairs, seed 0), the
score and a sha256 of the aligned strings that coati_tpu's batch_align
gives on XLA:CPU. This test recomputes them with the JAX package, so the
file stays the reference's, and holds the port's CPU path to them;
chip_smoke.py holds the port's CUDA path to the same file.

Regenerate with: JAX_PLATFORMS=cpu python tests/test_torch_golden.py
"""

import io
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from chip_smoke import GOLDEN, LENGTH_MIX, golden_record  # noqa: E402

PER_CLASS = 8


def golden_pairs(seed=0):
    """(indices, named pairs) of the first PER_CLASS pairs of each length
    class in the seed's make_pairs stream."""
    from bench import make_pairs

    rng = np.random.default_rng(seed)
    pairs, by_len = [], {}
    while min((len(by_len.get(L, [])) for L, _ in LENGTH_MIX)) < PER_CLASS:
        (a, b), = make_pairs(1, rng, length_mix=LENGTH_MIX)
        by_len.setdefault(len(a), []).append(len(pairs))
        pairs.append((a, b))
    idx = sorted(i for L, _ in LENGTH_MIX for i in by_len[L][:PER_CLASS])
    return idx, [(f"anc{i}", pairs[i][0], f"des{i}", pairs[i][1]) for i in idx]


def records_of(batch_align, idx, named, **kw):
    from coati_tpu.structs import AlignmentParams

    out = io.StringIO()
    batch_align(AlignmentParams(), named, out, **kw)
    rows = [json.loads(line) for line in out.getvalue().splitlines()]
    return [golden_record(i, row) for i, row in zip(idx, rows)]


def test_golden_is_the_reference_and_the_port_meets_it(monkeypatch):
    from coati_tpu.batchrun import batch_align as jax_batch_align
    from coati_tpu_torch.batchrun import batch_align as torch_batch_align

    monkeypatch.setenv("COATI_TPU_MAX_DEVICES", "1")
    golden = json.loads(GOLDEN.read_text())
    idx, named = golden_pairs(golden["seed"])
    assert [r["index"] for r in golden["pairs"]] == idx
    assert records_of(jax_batch_align, idx, named) == golden["pairs"]
    assert records_of(torch_batch_align, idx, named, device="cpu") == golden["pairs"]


def test_golden_pairs_follow_the_main_path_stream():
    """make_pairs draws pair by pair, so the golden indices name the same
    pairs in chip_smoke's 10,000-pair batch."""
    from bench import make_pairs

    idx, named = golden_pairs(0)
    whole = make_pairs(idx[-1] + 1, np.random.default_rng(0), length_mix=LENGTH_MIX)
    assert [(a, b) for _, a, _, b in named] == [whole[i] for i in idx]


if __name__ == "__main__":
    from coati_tpu.batchrun import batch_align as jax_batch_align

    idx, named = golden_pairs(0)
    GOLDEN.write_text(json.dumps({
        "source": "coati_tpu.batchrun.batch_align on XLA:CPU, mar-mg defaults, "
                  "bench.py make_pairs, seed 0",
        "seed": 0,
        "pairs": records_of(jax_batch_align, idx, named),
    }, indent=1) + "\n")
    print(f"wrote {len(idx)} records to {GOLDEN}")
