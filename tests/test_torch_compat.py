"""Parity of the port's host modules behind the CLI's last flags with the
JAX package's, in process on the CPU: the Rust binary's FASTA reader, the
``paper`` Henikoff weights (full and site-chunked), the ``hk`` weight mask,
``site_stats``, ``site_annotations(_multi)``, the PLINK and site-stats
writers, ``GzipMemberWriter``, the f64 audit engine ``reference_impl``,
``ProgressBar``, and the two ``build_parser()``s.

The ``paper`` weights are float32 reductions in each package's own order:
held at rtol 2e-6, not bits.  Everything else is held exactly.
"""

from __future__ import annotations

import argparse
import io

import numpy as np
import pytest

from weightedld_tpu import cli as jcli
from weightedld_tpu import pipeline as jpipe
from weightedld_tpu.core import henikoff as jhk
from weightedld_tpu.core import reference_impl as jref
from weightedld_tpu.io import fasta as jfasta
from weightedld_tpu.io import progressbar as jbar
from weightedld_tpu.io import vcf as jvcf
from weightedld_tpu.io import writer as jwriter
from weightedld_tpu.runtime.driver import Progress as JProgress
from weightedld_tpu_torch import cli
from weightedld_tpu_torch import pipeline as ppipe
from weightedld_tpu_torch.core import henikoff as phk
from weightedld_tpu_torch.core import reference_impl as pref
from weightedld_tpu_torch.core.ld_dense import LdRecords
from weightedld_tpu_torch.io import fasta as pfasta
from weightedld_tpu_torch.io import progressbar as pbar
from weightedld_tpu_torch.io import vcf as pvcf
from weightedld_tpu_torch.io import writer as pwriter
from weightedld_tpu_torch.runtime.driver import Progress

from .fixtures import ALL_FASTAS, random_alignment, write_fasta
from .test_torch_ambiguous import write_ambiguous_fasta
from .test_torch_regions import write_two_chrom_vcf

# ---------------------------------------------------------------------------
# The Rust binary's FASTA reader
# ---------------------------------------------------------------------------

RUST_FASTAS = {
    "unwrapped": ">a\nACGT\n>b\nacgT\n>c\nA-NT\n",
    "crlf": ">a\r\nACGT\r\n>b\r\nTTGA\r\n",
    "no-header": "ACGT\nACGA\n>x\nTTTT\n",
    "wrapped": ">a\nACGTAC\nGT\n>b\nACGTTC\nGA\n",
    "no-final-newline": ">a\nACGT\n>b\nACGT",
    "blank-line": ">a\nACGT\n\n>b\nACGT\n",
    "headers-only": ">a\n>b\n",
    "iupac": ">a\nRYKM\n>b\nACGT\n>c\nSWBD\n",
}


@pytest.mark.parametrize("name", list(RUST_FASTAS))
def test_read_fasta_rust_equals_jax(tmp_path, name):
    path = tmp_path / f"{name}.fasta"
    path.write_text(RUST_FASTAS[name], newline="")
    try:
        want = jfasta.read_fasta_rust_with_names(path)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pfasta.read_fasta_rust_with_names(path)
        assert str(got.value) == str(e)
        return
    codes, names = pfasta.read_fasta_rust_with_names(path)
    assert names == want[1]
    assert codes.dtype == want[0].dtype
    np.testing.assert_array_equal(codes, want[0])
    np.testing.assert_array_equal(pfasta.read_fasta_rust(path), want[0])


# ---------------------------------------------------------------------------
# Henikoff weights: the paper formula
# ---------------------------------------------------------------------------

PAPER_SHAPES = [(5, 7, 0.1), (40, 60, 0.05), (300, 500, 0.2), (64, 33, 0.0)]


@pytest.mark.parametrize("n,s,p_unknown", PAPER_SHAPES)
def test_paper_weights_equal_jax(n, s, p_unknown):
    import jax.numpy as jnp

    aln = random_alignment(np.random.default_rng(n + s), n, s,
                           p_unknown=p_unknown)
    want = np.asarray(jhk.henikoff_weights_paper(jnp.asarray(aln)))
    got = phk.henikoff_weights_paper(aln, device="cpu")
    assert got.dtype.is_floating_point and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6)
    assert got.numpy().max() == 1.0
    # Site-chunked: the same sums in another grouping.
    want_l = np.asarray(jhk.henikoff_weights_large(aln, site_chunk=16,
                                                   variant="paper"))
    got_l = phk.henikoff_weights_large(aln, site_chunk=16, device="cpu",
                                       variant="paper")
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=2e-6)
    np.testing.assert_allclose(got_l.numpy(), want, rtol=2e-6)


def test_paper_weights_of_the_henikoff_paper_example():
    """t1's columns 2-6 are the Henikoff paper's example: paper weights
    0.5, 0.5, 0.5, 0.5, 1.0 (tests/test_cli.py::test_compat_rust_preset)."""
    aln = np.array([[0] * 5, [0] * 5, [1] * 5, [1] * 5, [3] * 5], np.int8)
    np.testing.assert_allclose(
        phk.henikoff_weights_paper(aln, device="cpu").numpy(),
        [0.5, 0.5, 0.5, 0.5, 1.0], rtol=1e-7)


def test_weights_for_rejects_unknown_variant():
    with pytest.raises(ValueError, match="variant"):
        phk.henikoff_weights_large(np.zeros((3, 4), np.int8), device="cpu",
                                   variant="rust")


PREP_CONFIGS = [
    dict(weight_mask="hk"),
    dict(weighting="paper"),
    dict(weighting="paper", weight_mask="hk", max_minor=0.5),
    dict(fasta_reader="rust"),
    dict(fasta_reader="rust", weighting="paper",
         keep_samples=tuple(f"seq{i}" for i in range(0, 40, 3))),
    dict(unweighted=True, fasta_reader="rust"),
]


@pytest.mark.parametrize("case", range(len(PREP_CONFIGS)))
def test_prepare_fasta_equals_jax(tmp_path, case):
    path = tmp_path / "amb.fasta"
    write_ambiguous_fasta(path)
    kw = PREP_CONFIGS[case]
    want = jpipe.prepare(path, jpipe.WldConfig(**kw))
    got = ppipe.prepare(path, ppipe.WldConfig(**kw), device="cpu")
    np.testing.assert_array_equal(got.alignment, want.alignment)
    np.testing.assert_array_equal(got.site_map, want.site_map)
    np.testing.assert_array_equal(got.hk_mask, want.hk_mask)
    np.testing.assert_array_equal(got.ld_mask, want.ld_mask)
    if kw.get("weighting") == "paper":
        assert got.weights.dtype == np.float32
        np.testing.assert_allclose(got.weights, want.weights, rtol=2e-6)
    else:
        np.testing.assert_array_equal(got.weights, want.weights)


def test_prepare_vcf_paper_equals_jax(tmp_path):
    path = tmp_path / "two.vcf"
    write_two_chrom_vcf(path)
    for kw in (dict(weighting="paper"), dict(weighting="paper", chrom="2")):
        want = jpipe.prepare(path, jpipe.WldConfig(**kw))
        got = ppipe.prepare(path, ppipe.WldConfig(**kw), device="cpu")
        np.testing.assert_array_equal(got.site_map, want.site_map)
        np.testing.assert_allclose(got.weights, want.weights, rtol=2e-6)
    res, split = ppipe.prepare_vcf_cross(
        path, ppipe.WldConfig(weighting="paper"), "1", "2", device="cpu")
    jres, jsplit = jpipe.prepare_vcf_cross(
        path, jpipe.WldConfig(weighting="paper"), "1", "2")
    assert split == jsplit
    np.testing.assert_allclose(res.weights, jres.weights, rtol=2e-6)


def test_large_inputs_take_the_paper_formula(monkeypatch, tmp_path):
    """Above ``_LARGE_CELLS`` both formulas run site-chunked on the
    device, each its own (``pipeline.py:37-51``)."""
    path = tmp_path / "amb.fasta"
    write_ambiguous_fasta(path)
    small = ppipe.prepare(path, ppipe.WldConfig(weighting="paper"),
                          device="cpu")
    monkeypatch.setattr(ppipe, "_LARGE_CELLS", 10)
    large = ppipe.prepare(path, ppipe.WldConfig(weighting="paper"),
                          device="cpu")
    np.testing.assert_allclose(large.weights, small.weights, rtol=2e-6)
    host = ppipe.prepare(path, ppipe.WldConfig(), device="cpu")
    monkeypatch.setattr(ppipe, "_LARGE_CELLS", 10 ** 12)
    np.testing.assert_allclose(
        ppipe.prepare(path, ppipe.WldConfig(), device="cpu").weights,
        host.weights, rtol=1e-6)


# ---------------------------------------------------------------------------
# site_stats and the site annotations
# ---------------------------------------------------------------------------

SITE_STATS_CASES = [
    ("t1.fasta", {}),
    ("amb.fasta", {"min_acgt": 0.9, "max_minor": 0.4}),
    ("amb.fasta", {"fasta_reader": "rust", "min_variability": 0.2}),
    ("amb.fasta", {"keep_samples": ("seq1", "seq2", "seq5")}),
    ("two.vcf", {}),
    ("two.vcf", {"region": "2:1-3000", "exclude_samples": ("s0", "s3")}),
    ("two.vcf", {"chrom": "1"}),
    ("t1.fasta", {"region": "1"}),
    ("two.vcf", {"chrom": "9"}),
]


@pytest.fixture
def inputs(tmp_path):
    write_fasta(tmp_path / "t1.fasta", ALL_FASTAS["t1"])
    write_ambiguous_fasta(tmp_path / "amb.fasta")
    write_two_chrom_vcf(tmp_path / "two.vcf")
    return tmp_path


@pytest.mark.parametrize("case", range(len(SITE_STATS_CASES)))
def test_site_stats_equals_jax(inputs, case):
    src, kw = SITE_STATS_CASES[case]
    path = inputs / src
    try:
        want = jpipe.site_stats(path, jpipe.WldConfig(**kw))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ppipe.site_stats(path, ppipe.WldConfig(**kw))
        assert str(got.value) == str(e)
        return
    got = ppipe.site_stats(path, ppipe.WldConfig(**kw))
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    a, b = io.StringIO(), io.StringIO()
    pwriter.write_site_stats(got, a)
    jwriter.write_site_stats(want, b)
    assert a.getvalue() == b.getvalue()


ANNOT_FILTERS = [(None, None), ("1", None), ("2", (500, 3000)),
                 ("1", (1, 2)), ("3", None)]


@pytest.mark.parametrize("case", range(len(ANNOT_FILTERS)))
def test_site_annotations_equal_jax(inputs, case):
    path = inputs / "two.vcf"
    chrom, rng = ANNOT_FILTERS[case]
    try:
        want = jvcf.site_annotations(path, chrom, rng)
    except jvcf.VcfError as e:
        with pytest.raises(pvcf.VcfError) as got:
            pvcf.site_annotations(path, chrom, rng)
        assert str(got.value) == str(e)
        return
    got = pvcf.site_annotations(path, chrom, rng)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    # The positions are the readers' site_map.
    np.testing.assert_array_equal(
        got[0], pvcf.read_vcf(path, chrom=chrom, pos_range=rng)[1])


def test_site_annotations_multi_equals_jax(inputs):
    path = inputs / "two.vcf"
    filters = [("1", (1, 2500)), ("1", (2600, 99999)), ("2", None)]
    want = jvcf.site_annotations_multi(path, filters)
    got = pvcf.site_annotations_multi(path, filters)
    for g, w, f in zip(got, want, filters):
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1:] == w[1:]
        single = pvcf.site_annotations(path, *f)
        np.testing.assert_array_equal(g[0], single[0])
    with pytest.raises(pvcf.VcfError) as e:
        pvcf.site_annotations_multi(path, [("1", None), ("9", None)])
    with pytest.raises(jvcf.VcfError) as je:
        jvcf.site_annotations_multi(path, [("1", None), ("9", None)])
    assert str(e.value) == str(je.value)


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------


def _records(rng, n: int) -> LdRecords:
    pos = np.sort(rng.choice(5000, size=(n, 2)), axis=1)
    v = rng.normal(size=(3, n)).astype(np.float32)
    return LdRecords(pos_a=pos[:, 0], pos_b=pos[:, 1], d=v[0],
                     d_prime=v[1], r2=np.abs(v[2]))


@pytest.mark.parametrize("ndigits", [3, 4, 6])
@pytest.mark.parametrize("cross", [False, True])
def test_plink_rows_equal_jax(ndigits, cross):
    rng = np.random.default_rng(ndigits)
    rec = _records(rng, 9000)        # more than one 4,096-row chunk
    pos = np.unique(np.concatenate([rec.pos_a, rec.pos_b])).tolist()
    co = {p: "chr7" for p in pos[::2]}
    ids = {p: f"rs{p}" for p in pos[1::3]}
    maps = (co, ids) + (({p: "chr9" for p in pos}, {p: f"b{p}"
                                                    for p in pos[::5]})
                        if cross else ())
    a, b = io.StringIO(), io.StringIO()
    pwriter.write_pairs(rec, a, ndigits=ndigits,
                        annot=pwriter.PairAnnot(*maps))
    jwriter.write_pairs(rec, b, ndigits=ndigits,
                        annot=jwriter.PairAnnot(*maps))
    assert a.getvalue() == b.getvalue()
    assert a.getvalue().startswith(jwriter.PLINK_PAIR_HEADER + "\n")
    assert pwriter.pair_header(None) == jwriter.pair_header(None)


def test_gzip_members_equal_jax(tmp_path):
    import gzip

    chunks = ["header\n", "", "a\tb\n" * 500, "", "x" * 70000 + "\n", "z\n"]
    for mod, name in ((pwriter, "p.gz"), (jwriter, "j.gz")):
        with mod.GzipMemberWriter(tmp_path / name) as fh:
            for c in chunks:
                fh.write(c)
                fh.flush()
    data = (tmp_path / "p.gz").read_bytes()
    assert data == (tmp_path / "j.gz").read_bytes()
    assert gzip.decompress(data).decode() == "".join(chunks)
    # Truncating at a member boundary and appending gives the same file.
    with pwriter.GzipMemberWriter(tmp_path / "p.gz") as fh:
        fh.write(chunks[0])
        fh.flush()
        cut = fh.tell()
        fh.write("torn")
    with pwriter.GzipMemberWriter(tmp_path / "p.gz", append_at=cut) as fh:
        for c in chunks[1:]:
            fh.write(c)
            fh.flush()
    assert (tmp_path / "p.gz").read_bytes() == data


# ---------------------------------------------------------------------------
# The audit engine, the progress bar, the parsers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_impl_equals_jax(seed):
    rng = np.random.default_rng(seed)
    aln = random_alignment(rng, 30, 25, p_unknown=0.08)
    w = rng.random(30) + 0.1
    sm = np.arange(25) * 7 + 3
    assert pref.reference_ld(aln, w, sm) == jref.reference_ld(aln, w, sm)
    np.testing.assert_array_equal(pref.reference_henikoff(aln),
                                  jref.reference_henikoff(aln))
    for a, b in zip(pref.reference_variable_sites(aln, 0.8, 0.02),
                    jref.reference_variable_sites(aln, 0.8, 0.02)):
        np.testing.assert_array_equal(a, b)


class _Tty(io.StringIO):
    def isatty(self):
        return True


@pytest.mark.parametrize("tty", [False, True])
def test_progress_bar_equals_jax(tty):
    steps = [(0, 100, 0, 0.0), (10, 100, 2, 1.0), (55, 100, 9, 2.5),
             (100, 100, 13, 3.0), (100, 100, 13, 3.5)]
    outs = []
    for bar_mod, prog in ((pbar, Progress), (jbar, JProgress)):
        buf = _Tty() if tty else io.StringIO()
        bar = bar_mod.ProgressBar(buf, width=20)
        for done, total, rec, el in steps:
            bar(prog(pairs_done=done, pairs_total=total,
                     records_emitted=rec, elapsed_s=el))
        bar.close()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].count("100.0%") == 1
    assert Progress(5, 9, 1, 2.0).pairs_per_s == 2.5
    assert Progress(5, 9, 1, 0.0).pairs_per_s == 0.0


def _options(parser: argparse.ArgumentParser) -> dict:
    return {a.option_strings[0] if a.option_strings else a.dest:
            (tuple(a.option_strings), a.choices, a.default, a.nargs,
             a.type, type(a).__name__)
            for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


def test_parsers_take_the_same_options():
    """Every option of the JAX CLI but the four multi-process ones is the
    port's, with the same choices and defaults; the port adds only
    ``--device``."""
    want = _options(jcli.build_parser())
    got = _options(cli.build_parser())
    multi = {"--devices", "--coordinator", "--num-processes", "--process-id"}
    assert set(cli.NOT_PORTED) == multi
    assert set(got) - set(want) == {"--device"}
    assert set(want) - set(got) == multi
    for opt in set(want) - multi:
        assert got[opt] == want[opt], opt
