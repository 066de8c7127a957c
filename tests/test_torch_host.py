"""coati_tpu_torch's own host modules against the coati_tpu modules they were
copied from.

The port imports nothing of the JAX package, so it keeps its own constants,
structs, utils, version, profiling, io/, models/, align/semiring,
align/score, rng, format, align/oracle, msa/tree, msa/insertions and
triplet_hmm. Each case sends the same numpy-seeded inputs through both copies
and wants equal results: tables and arrays bit-equal, strings and file bytes
equal. Tolerance: none.
"""

import dataclasses
import importlib
import io
import types

import numpy as np
import pytest

PI = (0.308, 0.185, 0.199, 0.308)
IUPAC = "ACGTRYMKSWBDHVN"


def both(name):
    return (importlib.import_module(f"coati_tpu.{name}"),
            importlib.import_module(f"coati_tpu_torch.{name}"))


def _same(x, y, where=""):
    """Deep equality of constants: arrays bit-equal, containers item by item."""
    if isinstance(x, np.ndarray):
        assert isinstance(y, np.ndarray) and x.dtype == y.dtype, where
        np.testing.assert_array_equal(x, y, err_msg=where)
    elif isinstance(x, dict):
        assert x.keys() == y.keys(), where
        for key in x:
            _same(x[key], y[key], f"{where}[{key!r}]")
    elif isinstance(x, (list, tuple)):
        assert type(x) is type(y) and len(x) == len(y), where
        for n, (a, b) in enumerate(zip(x, y)):
            _same(a, b, f"{where}[{n}]")
    else:
        assert x == y, where


def _random_seqs(rng, n, alphabet, lo=9, hi=120, mult=3):
    out = []
    for _ in range(n):
        ln = int(rng.integers(lo // mult, hi // mult + 1)) * mult
        out.append("".join(rng.choice(list(alphabet), size=ln)))
    return out


def _coding_seq(rng, codons, n):
    return "".join(rng.choice(codons, size=n))


def case_constants():
    jc, tc = both("constants")
    names = [n for n in vars(jc) if not n.startswith("_")
             and not isinstance(getattr(jc, n), types.ModuleType)]
    assert names == [n for n in vars(tc) if not n.startswith("_")
                     and not isinstance(getattr(tc, n), types.ModuleType)]
    assert len(names) > 10
    for n in names:
        _same(getattr(jc, n), getattr(tc, n), n)


def case_models():
    jm, tm = both("models")
    for t, w in ((0.0133, 0.2), (0.3, 1.1)):
        _same(jm.mg94_p(t, w, PI), tm.mg94_p(t, w, PI), "mg94_p")
        _same(jm.ecm_p(t, w), tm.ecm_p(t, w), "ecm_p")
    sigma = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6)
    _same(jm.mg94_p(0.05, 0.2, PI, sigma), tm.mg94_p(0.05, 0.2, PI, sigma))
    _same(jm.mg94_q(0.2, PI), tm.mg94_q(0.2, PI), "mg94_q")
    p = jm.mg94_p(0.0133, 0.2, PI)
    for amb in ("SUM", "BEST"):
        for sub in ("SUM", "MAX"):
            want = jm.marginal_p(p, PI, jm.marginal.AmbiguousNucs(amb),
                                 jm.marginal.MarginalSubst(sub))
            got = tm.marginal_p(p, PI, tm.marginal.AmbiguousNucs(amb),
                                tm.marginal.MarginalSubst(sub))
            _same(want, got, f"marginal_p {amb} {sub}")
    assert jm.nts_ntv(3, 17) == tm.nts_ntv(3, 17)
    assert jm.k_bias(3, 17) == tm.k_bias(3, 17)


def case_encode_marginal():
    ju, tu = both("utils")
    jc, _ = both("constants")
    rng = np.random.default_rng(11)
    ancs = [_coding_seq(rng, jc.CODONS61, int(rng.integers(3, 60))) for _ in range(12)]
    ancs += ["ATGTTA", "atgccc", "ATGUUU"]
    dess = _random_seqs(rng, 6, "ACGT", mult=1) + _random_seqs(rng, 6, IUPAC, mult=1)
    dess += ["ACGT-N", "acgtn", "AUGC"]
    for a, d in zip(ancs, dess):
        for x, y in zip(ju.encode_marginal(a, d), tu.encode_marginal(a, d)):
            _same(x, y, f"encode_marginal {a} {d}")
    for a, d in (("ATGNNN", "ATG"), ("ATGTAACCC", "ATG"), ("ATGTAA", "ATG"), ("ATGCC", "ATG"),
                 ("ATGCCC", "AXG")):
        errs = []
        for u in (ju, tu):
            with pytest.raises(ValueError) as exc:
                u.encode_marginal(a, d)
            errs.append(str(exc.value))
        assert errs[0] == errs[1]
    for cod in ("AAA", "TTT", "CAG", "tga"):
        assert ju.cod_int(cod) == tu.cod_int(cod)
    for c in range(64):
        if c in jc.STOP_CODONS_64:
            with pytest.raises(ValueError, match="Stop codon"):
                tu.cod64_to_61(c)
        else:
            assert ju.cod64_to_61(c) == tu.cod64_to_61(c)
    for c in range(61):
        assert ju.cod61_to_64(c) == tu.cod61_to_64(c)
        assert [ju.get_nuc(c, q) for q in range(3)] == [tu.get_nuc(c, q) for q in range(3)]
        assert ju.cod_distance(c, 60 - c) == tu.cod_distance(c, 60 - c)


def case_end_stops():
    ju, tu = both("utils")
    js, ts = both("structs")
    rng = np.random.default_rng(5)
    seqs = _random_seqs(rng, 8, "ACGT")
    stops = ["TAA", "TAG", "TGA", "", "taa", "NNN"]
    for n, body in enumerate(seqs):
        pair = [body + stops[n % 6], seqs[(n + 1) % 8] + stops[(n // 2) % 6]]
        out = []
        for u, st in ((ju, js), (tu, ts)):
            d = st.SeqData(names=["a", "b"], seqs=list(pair), score=1.25)
            u.trim_end_stops(d)
            trimmed = (list(d.seqs), list(d.stops))
            u.restore_end_stops(d, st.GapParams(len=1 + 2 * (n % 2)))
            out.append((trimmed, list(d.seqs), d.score))
        assert out[0] == out[1]


def case_set_subst(tmp_path):
    ju, tu = both("utils")
    js, ts = both("structs")
    jm, tm = both("models.marginal")
    rate = tmp_path / "rate.csv"
    jc, _ = both("constants")
    rng = np.random.default_rng(2)
    lines = ["0.05"]
    for c0 in jc.CODONS61:
        for c1 in jc.CODONS61:
            lines.append(f"{c0},{c1},{rng.random() * 0.01:.6f}")
    rate.write_text("\n".join(lines) + "\n")
    settings = [
        {}, {"model": "mar-ecm"}, {"br_len": 0.2, "omega": 0.5},
        {"sigma": (0.1, 0.2, 0.3, 0.4, 0.5, 0.6)}, {"rate": str(rate)},
        {"model": "tri-mg"}, {"model": "tri-ecm"},
    ]
    for kw in settings:
        got = []
        for u, st, mm in ((ju, js, jm), (tu, ts, tm)):
            aln = st.AlignmentParams(**kw)
            aln.amb = mm.AmbiguousNucs("BEST") if kw.get("br_len") else aln.amb
            u.set_subst(aln)
            got.append((aln.subst_matrix, aln.model, tuple(aln.pi)))
        if got[0][0] is None:
            assert got[1][0] is None
        else:
            _same(got[0][0], got[1][0], f"set_subst {kw}")
        assert got[0][1:] == got[1][1:]
    for u, st in ((ju, js), (tu, ts)):
        with pytest.raises(ValueError, match="Mutation model unknown"):
            u.set_subst(st.AlignmentParams(model="nope"))
    jcsv, tcsv = both("io.matrix_csv")
    _same(jcsv.parse_matrix_csv(str(rate)), tcsv.parse_matrix_csv(str(rate)))


def case_process(tmp_path):
    """process_marginal, order_ref and process_alignment leave the same data
    and raise the same errors."""
    ju, tu = both("utils")
    js, ts = both("structs")
    inputs = [
        (["a", "b"], ["ATGCCCTAA", "ATGCC"], {}),
        (["a", "b"], ["ATGCC", "ATGCCCTAA"], {"rev": True}),
        (["a", "b"], ["ATGCC", "ATGCCC"], {"refs": "b"}),
        (["a", "b"], ["ATGCC", "ATGCCC"], {"refs": "zz"}),
        (["a", "b"], ["ATGCC", "ATGCC"], {}),
        (["a"], ["ATG"], {}),
    ]
    for names, seqs, kw in inputs:
        got = []
        for u, st in ((ju, js), (tu, ts)):
            aln = st.AlignmentParams(**kw)
            aln.data = st.SeqData(names=list(names), seqs=list(seqs))
            try:
                u.process_marginal(aln)
                got.append((aln.data.names, aln.data.seqs, aln.data.stops))
            except ValueError as exc:
                got.append(str(exc))
        assert got[0] == got[1]
    for seqs in (["CTCTGGATAGTG", "CT----ATAGTG"], ["ATGCCCTAA", "ATG---TAA"],
                 ["ATG", "ATGC"]):
        got = []
        for u, st in ((ju, js), (tu, ts)):
            aln = st.AlignmentParams()
            aln.data = st.SeqData(names=["a", "b"], seqs=list(seqs))
            try:
                got.append((u.process_alignment(aln), aln.data.seqs, aln.data.stops))
            except ValueError as exc:
                got.append(str(exc))
        assert got[0] == got[1]


def _seqdata(st, rng):
    seqs = _random_seqs(rng, 2, "ACGT-", lo=150, hi=150)
    return st.SeqData(names=["anc", "a_longer_name"], seqs=seqs, score=-12.3456789)


def case_io_roundtrip(kind, tmp_path):
    """Each writer gives the same bytes, each reader the same data, and what
    one copy wrote the other reads back."""
    js, ts = both("structs")
    jio, tio = both({"fasta": "io.fasta", "phylip": "io.phylip", "json": "io.jsonio"}[kind])
    short = {"fasta": "fasta", "phylip": "phylip", "json": "json"}[kind]
    texts = []
    for mod, st in ((jio, js), (tio, ts)):
        out = io.StringIO()
        getattr(mod, f"write_{short}")(_seqdata(st, np.random.default_rng(3)), out)
        texts.append(out.getvalue())
    assert texts[0] == texts[1] and texts[0]
    read = [getattr(mod, f"read_{short}")(io.StringIO(texts[1 - n]))
            for n, mod in enumerate((jio, tio))]
    assert (read[0].names, read[0].seqs) == (read[1].names, read[1].seqs)
    back = io.StringIO()
    getattr(tio, f"write_{short}")(read[1], back)
    if kind != "json":  # json carries the score, the others do not
        assert back.getvalue() == texts[0]
    else:
        assert read[0].score == read[1].score
        out = io.StringIO()
        tio.write_json_sample(read[1], out, 0, 2)
        want = io.StringIO()
        jio.write_json_sample(read[0], want, 0, 2)
        assert out.getvalue() == want.getvalue()


def case_io_dispatch(tmp_path):
    """read_input and write_output pick the codec from the path the same way
    and write the same files."""
    jd, td = both("io.iodispatch")
    js, ts = both("structs")
    for path in ("x.fasta", "fa:x.txt", "json:-", "x.phy", "dir/x.json", "x", ""):
        assert dataclasses.asdict(jd.extract_file_type(path)) == \
            dataclasses.asdict(td.extract_file_type(path))
    src = tmp_path / "in.fasta"
    src.write_text(">a\nCTCTGGATAGTG\n>b\nCTATAGTG\n")
    for ext in ("fasta", "phy", "json"):
        outs = []
        for tag, d, st in (("j", jd, js), ("t", td, ts)):
            aln = st.AlignmentParams()
            aln.data.path = str(src)
            aln.data = d.read_input(aln)
            aln.data.score = 1.5
            aln.output = str(tmp_path / f"{tag}.{ext}")
            d.write_output(aln)
            outs.append((tmp_path / f"{tag}.{ext}").read_bytes())
        assert outs[0] == outs[1] and outs[0]
    for d, st in ((jd, js), (td, ts)):
        aln = st.AlignmentParams()
        aln.data.path = str(tmp_path / "missing.fasta")
        with pytest.raises(ValueError, match="Opening input file"):
            d.read_input(aln)


def case_alignment_score(mg94_table):
    jsc, tsc = both("align.score")
    js, ts = both("structs")
    cases = [
        (["CTCTGGATAGTG", "CT----ATAGTG"], 1),
        (["ATGCCC---GGG", "ATGCCCAAAGGG"], 1),
        (["ATGCCC---GGGTAA", "ATGCCCAAAGGGTAA"], 3),
        (["ATGCCCGGG", "ATGNCCGRG"], 1),
    ]
    for seqs, k in cases:
        got = []
        for mod, st in ((jsc, js), (tsc, ts)):
            aln = st.AlignmentParams()
            aln.gap.len = k
            aln.data = st.SeqData(names=["a", "b"], seqs=list(seqs))
            got.append(mod.alignment_score(aln, mg94_table))
        assert got[0] == got[1] and np.isfinite(got[0])


def case_semiring():
    jsr, tsr = both("align.semiring")
    rng = np.random.default_rng(9)
    for g, e in [(0.001, 1 - 1 / 6), (0.002, 0.9)] + list(rng.random((6, 2)) * 0.98 + 0.01):
        _same(jsr.gap_constants(g, e), tsr.gap_constants(g, e))
    for x in (-20.0, -3.0, 0.0, 5.0, 10.0, 20.0):
        assert jsr.log1p_exp_f32(x) == tsr.log1p_exp_f32(x)
        assert jsr.log_sum_exp_f32(x, 1.0) == tsr.log_sum_exp_f32(x, 1.0)
    assert (jsr.ZERO, jsr.ONE) == (tsr.ZERO, tsr.ONE)


def case_structs_version_profiling():
    js, ts = both("structs")
    assert dataclasses.asdict(js.GapParams()) == dataclasses.asdict(ts.GapParams())
    ja, ta = js.AlignmentParams(), ts.AlignmentParams()
    fields = [f.name for f in dataclasses.fields(ja)]
    assert fields == [f.name for f in dataclasses.fields(ta)]
    for name in fields:
        x, y = getattr(ja, name), getattr(ta, name)
        if dataclasses.is_dataclass(x):
            assert dataclasses.asdict(x) == dataclasses.asdict(y)
        elif hasattr(x, "value"):  # the enums of models.marginal
            assert x.value == y.value
        else:
            assert x == y or (x is None and y is None)
    assert [ja.is_marginal(), js.AlignmentParams(model="tri-mg").is_marginal()] == \
        [ta.is_marginal(), ts.AlignmentParams(model="tri-mg").is_marginal()]
    jv, tv = both("version")
    import coati_tpu
    import coati_tpu_torch

    assert coati_tpu.__version__ == coati_tpu_torch.__version__
    assert jv.version_integer() == tv.version_integer()
    assert jv.version_integer_from_string("1.2.3") == tv.version_integer_from_string("1.2.3")
    assert tv.check_version_number() == 0 and tv.check_version_number(1) == 1
    jp, tp = both("profiling")
    meters = [jp.ThroughputMeter(), tp.ThroughputMeter()]
    for m in meters:
        with m.measure(1000, 3):
            pass
        m.seconds = 0.5
    assert meters[0].summary() == meters[1].summary()


def case_batchrun_helpers(tmp_path):
    """The helpers batchrun and cli took over from the JAX package's."""
    from coati_tpu import batchrun as jb
    from coati_tpu import cli as jcli
    from coati_tpu_torch import batchrun as tb
    from coati_tpu_torch import cli as tcli

    for anc in ("ATGCCC", "atgccc", "ATGTAA", "ATGCC", "ATGTAACCC", "ATGNCC", "AUGCCC"):
        errs = []
        for mod in (jb, tb):
            try:
                errs.append(mod._validate_triplet_pair(anc))
            except ValueError as exc:
                errs.append(str(exc))
        assert errs[0] == errs[1]

    fasta = tmp_path / "pairs.fasta"
    fasta.write_text(">a0\nATGCCC\n>d0\nATGCC\n>a1\nATGAAA\n>d1\nATGAA\n")
    assert jb.read_pairs_fasta(str(fasta)) == tb.read_pairs_fasta(str(fasta))
    odd = tmp_path / "odd.fasta"
    odd.write_text(">a0\nATGCCC\n")
    for mod in (jb, tb):
        with pytest.raises(ValueError, match="even number"):
            mod.read_pairs_fasta(str(odd))
    manifest = tmp_path / "m.txt"
    manifest.write_text("0\n\n7\n12\n")
    assert jb._load_done(str(manifest)) == tb._load_done(str(manifest)) == {0, 7, 12}
    assert jb._load_done("") == tb._load_done("") == set()
    import argparse

    argv = ["in.fasta", "-m", "mar-ecm", "-t", "0.2", "-g", "0.01", "-e", "0.5",
            "-w", "0.3", "-k", "3", "-a", "best", "--marginal-sub", "max",
            "-p", "0.1", "0.2", "0.3", "0.4", "-o", "out.json"]
    filled = []
    for mod in (jcli, tcli):
        p = argparse.ArgumentParser()
        mod._add_model_opts(p, "models")
        aln = mod._fill_aln(p.parse_args(argv))
        filled.append({f.name: getattr(aln, f.name) for f in dataclasses.fields(aln)
                       if f.name not in ("data", "gap", "amb", "sub")}
                      | {"gap": dataclasses.asdict(aln.gap), "amb": aln.amb.value,
                         "sub": aln.sub.value, "path": aln.data.path})
        with pytest.raises(argparse.ArgumentTypeError):
            mod._positive_float("0")
    assert filled[0] == filled[1]


def case_rng():
    jr, tr = both("rng")
    for seeds in (["42"], ["42", "hello"], ["-7"], ["2147483648"], ["a", "b", "c"]):
        rngs = []
        for mod in (jr, tr):
            rng = mod.Lehmer64()
            mod.seed_random(rng, mod.string_seed_seq(seeds))
            rngs.append(rng)
        assert rngs[0].state == rngs[1].state
        assert jr.encode_seed(rngs[0].get_seed_u32x4()) == \
            tr.encode_seed(rngs[1].get_seed_u32x4())
        for draw in ("bits", "u64", "f24", "f53"):
            assert [getattr(rngs[0], draw)() for _ in range(50)] == \
                [getattr(rngs[1], draw)() for _ in range(50)]
        assert rngs[0].state == rngs[1].state
    assert jr.Lehmer64().state == tr.Lehmer64().state
    assert jr.SeedSeq256([1, 2, 3]).generate(8) == tr.SeedSeq256([1, 2, 3]).generate(8)
    assert [jr.str_crushto32(x) for x in ("", "coati", "0x1F")] == \
        [tr.str_crushto32(x) for x in ("", "coati", "0x1F")]
    assert [jr.base58_encode_u32(u) for u in (0, 57, 58, 2**32 - 1)] == \
        [tr.base58_encode_u32(u) for u in (0, 57, 58, 2**32 - 1)]
    assert len(tr.auto_seed_seq().generate(4)) == 4


def case_format(tmp_path):
    jf, tf = both("format")
    js, ts = both("structs")
    seqs = ["AC-GTAC--TAAA----C", "ACCGTACGGTAAACCCCC", "ACCGTAC--TAAAC---C"]
    runs = [
        dict(preserve_phase=True, padding="?"),
        dict(preserve_phase=True, padding="N", names=["c", "a"]),
        dict(pos=[2, 3]),
        dict(names=["b"]),
    ]
    for n, kw in enumerate(runs):
        outs = []
        for tag, fmt_mod, st in (("j", jf, js), ("t", tf, ts)):
            aln = st.AlignmentParams()
            aln.data = st.SeqData(names=["a", "b", "c"], seqs=list(seqs))
            aln.output = str(tmp_path / f"{tag}{n}.fasta")
            assert fmt_mod.format_sequences(fmt_mod.FormatArgs(**kw), aln) == 0
            outs.append((tmp_path / f"{tag}{n}.fasta").read_bytes())
        assert outs[0] == outs[1] and outs[0]
    for fmt_mod, st in ((jf, js), (tf, ts)):
        aln = st.AlignmentParams()
        aln.data = st.SeqData(names=["a", "b"], seqs=seqs[:2])
        with pytest.raises(ValueError, match="Invalid padding"):
            fmt_mod.format_sequences(
                fmt_mod.FormatArgs(preserve_phase=True, padding="-"), aln)
        with pytest.raises(ValueError):
            fmt_mod.extract_seqs(fmt_mod.FormatArgs(names=["zz"]), aln.data)


def case_oracle(mg94_table):
    """Fill, traceback and seeded sampleback of the Python oracle, tropical
    and log, k = 1 and 3: every matrix bit-equal, every string equal."""
    jo, to = both("align.oracle")
    js, ts = both("structs")
    ju, tu = both("utils")
    jr, tr = both("rng")
    rng = np.random.default_rng(21)
    from coati_tpu.constants import CODONS61

    for k in (1, 3):
        anc = _coding_seq(rng, CODONS61, 6 * k)
        des = "".join(rng.choice(list("ACGT"), size=5 * 3 * k))
        for semiring in ("tropical", "log"):
            works = []
            for orc, st, ut in ((jo, js, ju), (to, ts, tu)):
                gap = st.GapParams(len=k)
                a, b = ut.encode_marginal(anc, des)
                work = orc.forward_oracle(a, b, mg94_table, gap, semiring,
                                          save_edges=True)
                works.append((orc, work, gap, a, b))
            (_, wj, _, _, _), (_, wt, _, _, _) = works
            for name in ("mch", "del_", "ins"):
                _same(getattr(wj, name), getattr(wt, name), name)
            _same(wj.edges, wt.edges, "edges")
            if semiring == "tropical":
                assert jo.traceback(wj, anc, des, works[0][2]) == \
                    to.traceback(wt, anc, des, works[1][2])
                continue
            r1, r2 = jr.Lehmer64(), tr.Lehmer64()
            for _ in range(20):
                assert jo.sampleback(wj, anc, des, works[0][2], r1) == \
                    to.sampleback(wt, anc, des, works[1][2], r2)
                assert jo.sampleback_mdi(wj.mch, wj.del_, wj.ins, works[0][3],
                                         works[0][4], mg94_table, anc, des,
                                         works[0][2], r1) == \
                    to.sampleback_mdi(wt.mch, wt.del_, wt.ins, works[1][3],
                                      works[1][4], mg94_table, anc, des,
                                      works[1][2], r2)
            assert r1.state == r2.state
    assert [jo.max_mdi(1.0, 1.0, 1.0), jo.max_mdi(0.0, 1.0, 1.0), jo.max_mi(1.0, 1.0)] == \
        [to.max_mdi(1.0, 1.0, 1.0), to.max_mdi(0.0, 1.0, 1.0), to.max_mi(1.0, 1.0)]


def _tree_view(tree):
    return [(n.label, n.length, n.is_leaf, n.parent, list(n.children)) for n in tree]


def case_msa_tree(tmp_path):
    jt, tt = both("msa.tree")
    js, ts = both("structs")
    texts = [
        "(B_b:6.0,(A-a:5.0,C/c:3.0,E.e:4.0)Ancestor:5.0,D%:11.0);",
        "((raccoon:19.2,bear:6.8):0.8,((sea_lion:12.0,seal:12.0):7.5,"
        "((monkey:100.9,cat:47.1):20.6,weasel:18.9):2.1):3.9,dog:25.5);",
        "((((A:0.1,B:0.15):0.1,C:0.12):0.1,D:0.07):0.1,E:2e-1);",
    ]
    for text in texts:
        a, b = jt.parse_newick(text), tt.parse_newick(text)
        assert _tree_view(a) == _tree_view(b) and len(b) > 4
        leaves = [n.label for n in b if n.is_leaf]
        for ref in (leaves[0], leaves[-1]):
            a, b = jt.parse_newick(text), tt.parse_newick(text)
            jt.reroot(a, ref)
            tt.reroot(b, ref)
            assert _tree_view(a) == _tree_view(b)
            ra, rb = jt.find_node(a, ref), tt.find_node(b, ref)
            assert ra == rb
            assert [jt.distance_ref(a, ra, n) for n in range(len(a))] == \
                [tt.distance_ref(b, rb, n) for n in range(len(b))]
    for mod in (jt, tt):
        with pytest.raises(RuntimeError):
            mod.parse_newick("")
        with pytest.raises(ValueError):
            mod.read_newick(str(tmp_path / "missing.newick"))
    path = tmp_path / "t.newick"
    path.write_text(texts[0])
    assert jt.read_newick(str(path)) == tt.read_newick(str(path)) == texts[0]
    for mod, st in ((jt, js), (tt, ts)):
        data = st.SeqData(names=["x", "y"], seqs=["AC", "GT"])
        assert mod.find_seq("y", data) == "GT"


def _ins_view(data):
    return (data.sequences, data.names, data.insertions.cols,
            sorted(data.insertions.d.items()))


def case_msa_insertions():
    ji, ti = both("msa.insertions")
    assert (ji.OPEN, ji.CLOSED) == (ti.OPEN, ti.CLOSED)
    pairs = [("TCA-TCG", "TCAGTCG"), ("TCATCG", "TCATCG"), ("-TCATCG", "TTCATCG"),
             ("TCA--TCG", "TCAGGTCG"), ("TCATCG-", "T-ATCGA")]
    merged = []
    for mod in (ji, ti):
        flags = [mod.insertion_flags(r, s) for r, s in pairs]
        data = [mod.InsertionData.single(s, f"n{n}", f)
                for n, ((_, s), f) in enumerate(zip(pairs, flags))]
        left = mod.merge_indels([d.copy() for d in data[:3]])
        right = mod.merge_indels([d.copy() for d in data[3:]])
        merged.append([_ins_view(left), _ins_view(right),
                       _ins_view(mod.merge_indels([left, right]))])
        with pytest.raises(RuntimeError):
            mod.insertion_flags("TCA-TC", "TCAGTCG")
        vec = mod.InsVector(10)
        vec.set(3, mod.OPEN)
        vec.set(7, mod.CLOSED)
        vec.shift_right_after(4)
        merged[-1].append((vec.cols, sorted(vec.d.items()), vec.nonzeros(),
                           vec.get(3), vec.get(8), vec.copy().get(8)))
    assert merged[0] == merged[1]
    assert len(merged[1][2][0]) == 5


def case_triplet_hmm():
    """The triplet host engine: model tables, encoders and their errors, the
    forward's boundary rows, alignments, the path scorer and the f64 score,
    under the three models."""
    jh, th = both("triplet_hmm")
    js, ts = both("structs")
    jc, _ = both("constants")
    rng = np.random.default_rng(31)
    assert (jh.NEG, jh.MATCH, jh.DELETION, jh.INSERTION) == \
        (th.NEG, th.MATCH, th.DELETION, th.INSERTION)
    pairs = [("CTCTGGATAGTG", "CTATAGTG"), ("GCGACTGTT", "AAAAAAAGCGACTGTTCCCCC")]
    for _ in range(6):
        anc = _coding_seq(rng, jc.CODONS61, int(rng.integers(1, 14)))
        pairs.append((anc, "".join(rng.choice(list("ACGTN"), size=int(rng.integers(1, 40))))))
    for name, kw in (("tri-mg", {}), ("tri-mg", {"sigma": (0.1, 0.2, 0.3, 0.4, 0.5, 0.6)}),
                     ("tri-ecm", {"br_len": 0.1}), ("dna", {"omega": 0.5})):
        jm = jh.build_triplet_model(js.AlignmentParams(model=name, **kw))
        tm = th.build_triplet_model(ts.AlignmentParams(model=name, **kw))
        for attr in ("logP", "ins_emit", "match_emit", "cnuc"):
            _same(getattr(jm, attr), getattr(tm, attr), f"{name}.{attr}")
        assert (jm.codon, jm.ng, jm.gs, jm.go, jm.ge) == (tm.codon, tm.ng, tm.gs, tm.go, tm.ge)
        if not jm.codon:
            _same(jm.match_emit_eff, tm.match_emit_eff)
            _same(jm.del_cost, tm.del_cost)
        for anc, des in pairs:
            ja, jd = jh.encode_triplet_pair(jm, anc, des)
            ta, td = th.encode_triplet_pair(tm, anc, des)
            _same(ja, ta, "anc codes")
            _same(jd, td, "des codes")
            jterm, jb, jdp = jh.triplet_forward(jm, ja, jd, keep_boundaries=True)
            tterm, tb, tdp = th.triplet_forward(tm, ta, td, keep_boundaries=True)
            _same(list(jterm), list(tterm), "terminal")
            _same([list(r) for r in jb], [list(r) for r in tb], "boundaries")
            _same(jdp.ins_off, tdp.ins_off, "ins_off")
            want = jh.triplet_align(jm, anc, des)
            assert th.triplet_align(tm, anc, des) == want
            assert th.traceback_from_boundaries(tm, anc, des, tterm, tb, tdp) == want
            assert jh.triplet_path_score(jm, *want[:2]) == th.triplet_path_score(tm, *want[:2])
            assert jh.triplet_score(jm, anc, des) == th.triplet_score(tm, anc, des)
            if jm.codon:
                jp = jdp.block_pieces(0, *jb[0])
                tp = tdp.block_pieces(0, *tb[0])
                _same(jp, tp, "block_pieces")
                _same(list(jdp.collapse_amax(jp)), list(tdp.collapse_amax(tp)))
    for mod, st in ((jh, js), (th, ts)):
        model = mod.build_triplet_model(st.AlignmentParams(model="tri-mg"))
        dna = mod.build_triplet_model(st.AlignmentParams(model="dna"))
        for bad, match in ((("ATGNCC", "ATG"), "Ambiguous"), (("ATGTAACCC", "ATG"), "Early stop"),
                           (("ATGCCC", "ATGXCC"), "Invalid nucleotide 'X'"),
                           (("ATGCCC", "ATG\u00e9"), "Invalid nucleotide")):
            with pytest.raises(ValueError, match=match):
                mod.encode_triplet_pair(model, *bad)
        with pytest.raises(ValueError, match="Ambiguous"):
            mod.encode_triplet_pair(dna, "ACNT", "ACGT")
        with pytest.raises(ValueError, match="Mutation model unknown"):
            mod.build_triplet_model(st.AlignmentParams(model="mar-mg"))
        with pytest.raises(ValueError, match="equal length"):
            mod.triplet_path_score(model, "ATG", "AT")
        with pytest.raises(ValueError, match="not representable"):
            mod.triplet_path_score(model, "ATG-", "A--C")


def _io_case(kind):
    return lambda tmp_path: case_io_roundtrip(kind, tmp_path)


CASES = {
    "constants": case_constants,
    "models": case_models,
    "encode_marginal": case_encode_marginal,
    "end_stops": case_end_stops,
    "set_subst": case_set_subst,
    "process": case_process,
    "io_fasta": _io_case("fasta"),
    "io_phylip": _io_case("phylip"),
    "io_json": _io_case("json"),
    "io_dispatch": case_io_dispatch,
    "alignment_score": case_alignment_score,
    "semiring": case_semiring,
    "structs_version_profiling": case_structs_version_profiling,
    "batchrun_cli_helpers": case_batchrun_helpers,
    "rng": case_rng,
    "format": case_format,
    "align_oracle": case_oracle,
    "msa_tree": case_msa_tree,
    "msa_insertions": case_msa_insertions,
    "triplet_hmm": case_triplet_hmm,
}


@pytest.mark.parametrize("name", list(CASES))
def test_copied_module_equals_its_original(name, tmp_path, mg94_table):
    case = CASES[name]
    wants = case.__code__.co_varnames[: case.__code__.co_argcount]
    given = {"tmp_path": tmp_path, "mg94_table": mg94_table}
    case(**{w: given[w] for w in wants})
