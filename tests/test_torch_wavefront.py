"""coati_tpu_torch's plain fill and walk against the JAX package on the CPU.

The same numpy inputs go through coati_tpu.align.wavefront (XLA:CPU, and the
Pallas kernels in interpret mode) and through coati_tpu_torch. Tolerance:
none. Corners and scores are compared bit for bit in f32, backpointer bytes
on every true-matrix cell, walks op for op.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coati_tpu.align.wavefront import (
    gap_consts_array,
    traceback_ops,
    traceback_ops_impl,
    wavefront,
    wavefront_impl,
)
from coati_tpu.structs import GapParams
from coati_tpu_torch.align import wavefront as tw
from coati_tpu_torch.kernels import traceback_walk as walk_mod
from coati_tpu_torch.kernels import wavefront_fill as fill_mod


def _batch(seed, k, B=8, na=(48, 240), nb=(48, 240), n_codes=16):
    """Ragged random batch: ancestor codes < 183, descendant codes < n_codes
    (all 15 IUPAC columns and the gap code 15), lengths multiples of 3k
    (ancestor) and k (descendant)."""
    rng = np.random.default_rng(seed)
    la = rng.integers(na[0] // (3 * k), na[1] // (3 * k) + 1, B) * 3 * k
    lb = rng.integers(nb[0] // k, nb[1] // k + 1, B) * k
    NA, NB = int(la.max()), int(lb.max())
    aseq = np.zeros((B, NA), np.int32)
    bseq = np.zeros((B, NB), np.int32)
    for p in range(B):
        aseq[p, : la[p]] = rng.integers(0, 183, la[p])
        bseq[p, : lb[p]] = rng.integers(0, n_codes, lb[p])
    return aseq, bseq, la.astype(np.int32), lb.astype(np.int32)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def _true_cells(la, lb, k, Dtot, C):
    """[B, Dtot, C] mask of cells k <= i < la+k, k <= j < lb+k."""
    d = np.arange(Dtot)[None, :, None]
    j = np.arange(C)[None, None, :]
    i = d - j
    return ((i >= k) & (i < la[:, None, None] + k)
            & (j >= k) & (j < lb[:, None, None] + k))


def _ops_lists(ops):
    """Per-pair op sequences with -1 holes dropped."""
    ops = np.asarray(ops)
    return [ops[:, p][ops[:, p] >= 0].tolist() for p in range(ops.shape[1])]


@pytest.mark.parametrize("k", [1, 3])
def test_plain_fill_matches_xla(mg94_table, k):
    aseq, bseq, la, lb = _batch(100 + k, k)
    gc = gap_consts_array(GapParams(len=k))
    (cm, cd, ci), bp = wavefront(
        *[jnp.asarray(x) for x in (aseq, bseq, la, lb, mg94_table, gc)],
        k=k, semiring="tropical", mode="viterbi",
    )
    (tm, td, ti), tbp = tw.wavefront_plain(
        *_torch(aseq, bseq, la, lb, mg94_table, gc), k=k
    )
    for x, y in ((cm, tm), (cd, td), (ci, ti)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    bp_x = np.transpose(np.asarray(bp), (1, 0, 2))
    assert bp_x.shape == tuple(tbp.shape)
    mask = _true_cells(la, lb, k, *bp_x.shape[1:])
    assert mask.sum() == int((la.astype(np.int64) * lb).sum())
    np.testing.assert_array_equal(bp_x[mask], tbp.numpy()[mask])
    # the plain version keeps the reference's layout: every slot agrees
    np.testing.assert_array_equal(bp_x, tbp.numpy())


@pytest.mark.parametrize("k", [1, 3])
def test_margins_pin_xla_fma(mg94_table, k):
    """The float64-then-round margins equal XLA:CPU's contracted FMA values
    read back from the reference's own forward-mode diagonals: the delete
    column for i < 20,000 and the insert row for j < 2,000."""
    gc = gap_consts_array(GapParams(len=k))
    ng, gs, go, ge = (torch.tensor(x) for x in gc)
    run = jax.jit(functools.partial(
        wavefront_impl, k=k, semiring="log", mode="forward"))

    def margins_from_xla(NA, NB):
        a = np.zeros((1, NA), np.int32)
        b = np.zeros((1, NB), np.int32)
        _, (_, Ds, Is) = run(a, b, np.array([NA], np.int32),
                             np.array([NB], np.int32), mg94_table, gc)
        return np.asarray(Ds)[:, 0, :], np.asarray(Is)[:, 0, :]

    Ds, _ = margins_from_xla(20001, 3)
    i = np.arange(Ds.shape[0]) - (k - 1)
    ok = (i >= 2 * k - 1) & ((i - (k - 1)) % k == 0) & (i < 20001 + k)
    got = tw.margin_values(ng + go, ge, torch.from_numpy(i[ok])).numpy()
    np.testing.assert_array_equal(Ds[ok, k - 1], got)
    unfused = (ng + go) + ge * (torch.from_numpy(i[ok]).float() - 1.0)
    assert (unfused.numpy() != got).any()  # the rounding rule matters

    _, Is = margins_from_xla(3, 2000)
    j = np.arange(Is.shape[1])
    ok = (j >= 2 * k - 1) & ((j - (k - 1)) % k == 0)
    row = Is[j[ok] + (k - 1), j[ok]]  # cell (k-1, j) on diagonal j + k - 1
    got = tw.margin_values(go, ge, torch.from_numpy(j[ok])).numpy()
    np.testing.assert_array_equal(row, got)


def test_plain_fill_matches_pallas_interpret(mg94_table):
    from coati_tpu.kernels.wavefront_pallas import wavefront_pallas

    k = 1
    aseq, bseq, la, lb = _batch(7, k, B=8, na=(24, 48), nb=(24, 48))
    gc = gap_consts_array(GapParams(len=k))
    (cm, cd, ci), bp = wavefront_pallas(
        *[jnp.asarray(x) for x in (aseq, bseq, la, lb, mg94_table, gc)],
        k=k, bc=8, interpret=True,
    )
    (tm, td, ti), tbp = tw.wavefront_plain(
        *_torch(aseq, bseq, la, lb, mg94_table, gc), k=k
    )
    for x, y in ((cm, tm), (cd, td), (ci, ti)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    Dtot, C = tbp.shape[1:]
    bp_p = np.transpose(np.asarray(bp), (1, 0, 2))[:, :Dtot, :C]
    mask = _true_cells(la, lb, k, Dtot, C)
    np.testing.assert_array_equal(bp_p[mask], tbp.numpy()[mask])


@pytest.mark.parametrize("k", [1, 3])
def test_plain_walk_matches_stacked_pallas(mg94_table, k):
    """The stacked TPU kernel, walked through its d_base/row_idx layout, and
    the port's plain fill + walk give the same corners and op sequences."""
    from coati_tpu.kernels.wavefront_pallas import wavefront_pallas_stacked

    R, bc = 2, 4
    aseq, bseq, la, lb = _batch(40 + k, k, B=R * bc, na=(9, 36), nb=(6, 42))
    gc = gap_consts_array(GapParams(len=k))
    jargs = [jnp.asarray(x) for x in (aseq, bseq, la, lb, mg94_table, gc)]
    corners, bp, d_base, row_idx, _ = wavefront_pallas_stacked(
        *jargs, k=k, R=R, bc=bc, du=2, interpret=True,
    )
    ops_s, (_, score_s) = traceback_ops(
        bp, corners, jargs[2], jargs[3], k=k, d_base=d_base, row_idx=row_idx,
    )
    t_la, t_lb = _torch(la, lb)
    tcorners, tbp = tw.wavefront_plain(
        *_torch(aseq, bseq), t_la, t_lb, *_torch(mg94_table, gc), k=k
    )
    for x, y in zip(corners, tcorners):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    ops_t, score_t = tw.traceback_plain(
        tbp, tcorners, t_la, t_lb, k=k, max_steps=int((la + lb).max())
    )
    np.testing.assert_array_equal(np.asarray(score_s), score_t.numpy())
    assert _ops_lists(ops_s) == _ops_lists(ops_t)


@pytest.mark.parametrize("k,form", [(1, "scan"), (1, "while"), (3, "scan"),
                                    (3, "while")])
def test_plain_walk_matches_xla(mg94_table, k, form):
    """traceback_plain against both forms of traceback_ops_impl: the
    hole-emitting diagonal scan and the while loop (taken when the bp stack
    has more rows than pairs)."""
    aseq, bseq, la, lb = _batch(200 + k, k, na=(30, 120), nb=(30, 120))
    gc = gap_consts_array(GapParams(len=k))
    jla, jlb = jnp.asarray(la), jnp.asarray(lb)
    corners, bp = wavefront(
        *[jnp.asarray(x) for x in (aseq, bseq)], jla, jlb,
        jnp.asarray(mg94_table), jnp.asarray(gc),
        k=k, semiring="tropical", mode="viterbi",
    )
    if form == "while":
        bp = jnp.concatenate([bp, jnp.zeros_like(bp[:, :1])], axis=1)
    ops_x, (_, score_x) = jax.jit(
        functools.partial(traceback_ops_impl, k=k)
    )(bp, corners, jla, jlb)
    bp_t = torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(bp)[:, : len(la)], (1, 0, 2))))
    tcorners = [torch.from_numpy(np.array(c)) for c in corners]
    ops_t, score_t = tw.traceback_plain(
        bp_t, tcorners, *_torch(la, lb), k=k, max_steps=int((la + lb).max())
    )
    np.testing.assert_array_equal(np.asarray(score_x), score_t.numpy())
    assert _ops_lists(ops_x) == _ops_lists(ops_t)


def test_wrappers_on_cpu_take_plain_path(mg94_table):
    """On CPU tensors the kernel wrappers run the plain versions and launch
    nothing; their counters stay at 0. The fill returns wavefront_plain's
    stack in row layout, and the walk over it equals traceback_plain over
    the diagonal stack."""
    k = 1
    aseq, bseq, la, lb = _batch(3, k, B=4, na=(12, 36), nb=(12, 36))
    gc = gap_consts_array(GapParams(len=k))
    args = _torch(aseq, bseq, la, lb, mg94_table, gc)
    fill_mod.LAUNCHES = walk_mod.LAUNCHES = 0
    corners, bp = fill_mod.wavefront_fill(*args, k=k)
    ref_corners, ref_bp = tw.wavefront_plain(*args, k=k)
    assert torch.equal(bp, fill_mod.rows_from_diagonals(ref_bp, aseq.shape[1], k))
    for x, y in zip(corners, ref_corners):
        assert torch.equal(x, y)
    steps = int((la + lb).max())
    ops, score = walk_mod.traceback_walk(bp, corners, args[2], args[3], k=k,
                                         max_steps=steps)
    ref_ops, ref_score = tw.traceback_plain(ref_bp, corners, args[2], args[3],
                                            k=k, max_steps=steps)
    assert torch.equal(ops, ref_ops) and torch.equal(score, ref_score)
    assert fill_mod.LAUNCHES == 0 and walk_mod.LAUNCHES == 0


def test_wrappers_check_their_inputs(mg94_table):
    k = 1
    aseq, bseq, la, lb = _batch(4, k, B=2, na=(12, 12), nb=(12, 12))
    gc = gap_consts_array(GapParams(len=k))
    a, b, ta, tb, tab, g = _torch(aseq, bseq, la, lb, mg94_table, gc)
    with pytest.raises(TypeError):
        fill_mod.wavefront_fill(a.long(), b, ta, tb, tab, g, k=k)
    with pytest.raises(ValueError):
        fill_mod.wavefront_fill(a, b, ta[:1], tb, tab, g, k=k)
    with pytest.raises(ValueError):
        fill_mod.wavefront_fill(a.t(), b, ta, tb, tab, g, k=k)


def test_build_names_the_library_by_its_sources(tmp_path, monkeypatch):
    """An edited kernel source gets a new library name, so it is rebuilt."""
    from coati_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// one\n")
    first = _build.library_path()
    assert _build.library_path() == first
    (tmp_path / "k.cuh").write_text("// header\n")
    second = _build.library_path()
    (tmp_path / "k.cu").write_text("// two\n")
    assert len({first, second, _build.library_path()}) == 3
    assert first.parent == _build.BUILD_DIR


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No toolkit, no silent fallback: the build raises and names nvcc."""
    from coati_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not any((tmp_path / "build").glob("*.so"))


def test_build_dir_is_the_checkout_or_the_user_cache(tmp_path, monkeypatch):
    """A writable checkout builds under its own build/; an installed copy
    (no pyproject.toml beside the package) or a read-only checkout builds
    in the per-user cache."""
    from coati_tpu_torch.kernels import _build

    checkout = tmp_path / "checkout"
    checkout.mkdir()
    (checkout / "pyproject.toml").write_text("")
    site = tmp_path / "site-packages"
    site.mkdir()
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build.build_dir(checkout) == checkout / "build" / "coati_tpu_torch"
    assert _build.build_dir(site) == tmp_path / "cache" / "coati_tpu_torch"
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    assert _build.build_dir(checkout) == tmp_path / "cache" / "coati_tpu_torch"
