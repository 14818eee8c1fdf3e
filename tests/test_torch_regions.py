"""Parity of the port's region, chromosome and sample handling, and of its
CLI's window, cross and filter flags, with the JAX package, on the CPU.

* ``parse_region`` and ``regions_overlap`` on a table of specs, the
  malformed tails the JAX package reads as chromosome names included
  (ADVICE ``vcf.py:76``, reproduced on purpose);
* the readers (``read_vcf``, ``read_vcf_python``, ``scan_vcf``,
  ``read_vcf_site_major`` with ``chrom`` / ``pos_range`` / a sample
  ``row_mask``, ``list_chromosomes``, ``vcf_sample_names``) and the
  pipeline (``prepare`` with a region and sample subsets, FASTA sample
  subsets, ``prepare_vcf_cross``, the streamed twins) on a synthetic
  two-chromosome VCF: arrays, weights and error messages equal the JAX
  package's;
* the CLI: each new flag and their compositions give the JAX CLI's
  standard output and exit code.  The JAX CLI runs in a subprocess with
  ``XLA_FLAGS=--xla_cpu_max_isa=AVX`` (no FMA; see
  tests/test_torch_slice.py) and its tiled sessions on the interpret-mode
  Pallas kernels.  TSV and site-list output byte for byte; JSON counts
  exact and float32 sums within rtol 1e-5 (per-batch summation order);
  matrices equal on kept cells; the first line of standard error equal on
  every exit 2.  ``--list-chroms`` ignores ``--region`` and the sample
  flags, as the JAX CLI does (ADVICE ``cli.py:469``).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from weightedld_tpu_torch import cli
from weightedld_tpu_torch import pipeline as pipe
from weightedld_tpu_torch.io import fasta as pfasta
from weightedld_tpu_torch.io import vcf as pvcf
from weightedld_tpu_torch.runtime.driver import DriverConfig, LdSession
from weightedld_tpu_torch.runtime.ingest import (
    prepare_fasta_streamed,
    prepare_vcf_streamed,
)

from .test_torch_ambiguous import write_ambiguous_fasta

REPO = Path(__file__).resolve().parent.parent
N_SAMPLES = 40
CHROMS = (("1", 150), ("2", 110))
LAY = ["--engine", "tiled", "--tile", "32", "--seq-chunk", "64"]
LAY_F = ["--engine", "tiled", "--tile", "16", "--seq-chunk", "64"]
KEEP = [f"s{i}" for i in range(0, N_SAMPLES, 2)]


def write_two_chrom_vcf(path: Path, seed: int = 23) -> None:
    """Phased genotypes over 0 / 1 / '.' on chromosomes 1 and 2 (POS
    restarts), correlated neighbours, a few unphased calls."""
    rng = np.random.default_rng(seed)
    header = ("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
              "FILTER\tINFO\tFORMAT\t"
              + "\t".join(f"s{i}" for i in range(N_SAMPLES)))
    rows = []
    for chrom, n_sites in CHROMS:
        haps = np.where(rng.random((2 * N_SAMPLES, n_sites)) < 0.6, "0", "1")
        haps[rng.random(haps.shape) < 0.05] = "."
        for s in range(1, n_sites, 2):
            src = haps[:, s - 1].copy()
            flip = rng.random(2 * N_SAMPLES) < 0.12
            src[flip] = np.where(src[flip] == "0", "1", "0")
            haps[:, s] = src
        pos = np.cumsum(rng.integers(5, 60, size=n_sites)) + 100
        for s in range(n_sites):
            gts = [f"{haps[2 * i, s]}|{haps[2 * i + 1, s]}"
                   for i in range(N_SAMPLES)]
            if s % 19 == 0:
                gts[s % N_SAMPLES] = "0/1"
            rows.append(f"{chrom}\t{pos[s]}\trs{chrom}_{s}\tA\tT\t.\tPASS\t"
                        f".\tGT\t" + "\t".join(gts))
    path.write_text(header + "\n" + "\n".join(rows) + "\n")


def write_inputs(d: Path) -> None:
    write_two_chrom_vcf(d / "two.vcf")
    write_ambiguous_fasta(d / "amb.fasta")
    (d / "keep.txt").write_text("# kept samples\n" + "\n".join(KEEP)
                                + "\n\n")


CROSS_A, CROSS_B = "1:1-2500", "1:2600-99999"
VCF_CASES = {
    "list-chroms": ["--list-chroms"],
    "list-chroms-ignores-filters": ["--list-chroms", "--region", "2:1-500",
                                    "--keep-samples", "s1,s2"],
    "chrom": ["--chrom", "2"] + LAY,
    "region": ["--region", "1:800-4000"] + LAY,
    "region-open-end": ["--region", "1:3,000-"] + LAY,
    "region-typo-is-a-name": ["--region", "1:100-2x0"] + LAY,
    "region-bad": ["--region", "1:900-100"] + LAY,
    "region-no-name": ["--region", ":1-100"] + LAY,
    "chrom-and-region": ["--chrom", "1", "--region", "1"] + LAY,
    "window-site": ["--max-distance", "12"] + LAY,
    "window-bp": ["--chrom", "1", "--max-distance-bp", "400"] + LAY,
    "window-bp-two-chroms": ["--max-distance-bp", "400"] + LAY,
    "window-both-stats": ["--chrom", "1", "--max-distance", "10",
                          "--max-distance-bp", "300", "--stats-only",
                          "--r2-threshold", "0.05"] + LAY,
    "window-decay": ["--chrom", "2", "--max-distance-bp", "500",
                     "--ld-decay", "0,50,200,500,1000"] + LAY,
    "window-hist": ["--max-distance", "15", "--r2-hist",
                    "0,0.05,0.2,1.01"] + LAY,
    "window-top": ["--chrom", "1", "--max-distance", "10", "--top",
                   "8"] + LAY,
    "window-prune": ["--chrom", "1", "--max-distance-bp", "300",
                     "--prune-r2", "0.1"] + LAY,
    "window-matrix": ["--chrom", "1", "--max-distance", "10",
                      "--matrix-output", "{out}"] + LAY,
    "window-dense-is-tiled": ["--chrom", "2", "--max-distance", "7",
                              "--engine", "dense"],
    "cross-chroms": ["--cross-regions", "1", "2"] + LAY,
    "cross-same-chrom": ["--cross-regions", CROSS_A, CROSS_B,
                         "--r2-threshold", "0.02"] + LAY,
    "cross-stats": ["--cross-regions", CROSS_A, CROSS_B,
                    "--stats-only"] + LAY,
    "cross-top": ["--cross-regions", "1", "2", "--top", "6"] + LAY,
    "cross-decay": ["--cross-regions", CROSS_A, CROSS_B, "--ld-decay",
                    "0,100,1000,10000"] + LAY,
    "cross-hist": ["--cross-regions", "1", "2", "--r2-hist",
                   "0,0.1,1.01"] + LAY,
    "cross-prune": ["--cross-regions", CROSS_A, CROSS_B, "--prune-r2",
                    "0.1"] + LAY,
    "cross-matrix": ["--cross-regions", CROSS_A, CROSS_B,
                     "--matrix-output", "{out}"] + LAY,
    "cross-samples": ["--cross-regions", "1", "2", "--keep-samples",
                      "@{keep}"] + LAY,
    "cross-decay-two-chroms": ["--cross-regions", "1", "2", "--ld-decay",
                               "0,10"] + LAY,
    "cross-overlap": ["--cross-regions", "1:1-3000", "1:2000-5000"] + LAY,
    "cross-self": ["--cross-regions", "1", "1"] + LAY,
    "cross-dense": ["--cross-regions", CROSS_A, CROSS_B, "--engine",
                    "dense"],
    "cross-window": ["--cross-regions", "1", "2", "--max-distance",
                     "5"] + LAY,
    "cross-stream": ["--cross-regions", "1", "2", "--stream-ingest"] + LAY,
    "cross-chrom": ["--cross-regions", "1", "2", "--chrom", "1"] + LAY,
    "cross-empty": ["--cross-regions", "1:1-2", "2"] + LAY,
    "keep": ["--keep-samples", "s0,s3,s5,s7,s11,s13", "--chrom",
             "2"] + LAY,
    "keep-file-exclude": ["--keep-samples", "@{keep}", "--exclude-samples",
                          "s2", "--max-distance", "20"] + LAY,
    "exclude-region-window": ["--exclude-samples", "s0,s1,s2", "--region",
                              "2:1-3000", "--max-distance-bp",
                              "250"] + LAY,
    "keep-unknown": ["--keep-samples", "s0,nobody"] + LAY,
    "keep-empty": ["--keep-samples", ","] + LAY,
    "stream-compose": ["--region", "2:1-4000", "--keep-samples", "@{keep}",
                       "--max-distance-bp", "300", "--stream-ingest"] + LAY,
    "stream-chrom-window": ["--chrom", "1", "--stream-ingest",
                            "--max-distance", "9"] + LAY,
}
FASTA_CASES = {
    "fasta-chrom": ["--chrom", "1"],
    "fasta-region": ["--region", "x"],
    "fasta-cross": ["--cross-regions", "a:1-2", "b:3-4"],
    "fasta-list-chroms": ["--list-chroms"],
    "fasta-keep-window": ["--keep-samples",
                          ",".join(f"seq{i}" for i in range(30)),
                          "--max-distance", "60"] + LAY_F,
    "fasta-exclude-stream": ["--exclude-samples", "seq1,seq2",
                             "--stream-ingest", "--max-distance",
                             "60"] + LAY_F,
    "fasta-window-bp": ["--max-distance-bp", "30"] + LAY_F,
}
CLI_CASES = {**{k: ("two.vcf", v) for k, v in VCF_CASES.items()},
             **{k: ("amb.fasta", v) for k, v in FASTA_CASES.items()}}
# The port's streamed session packs the UNKNOWN-carrying sites where the
# JAX one does not, so that it writes the port's standard run's bytes
# (ROADMAP queue 3): these cases are held to the JAX CLI's standard run.
JAX_UNSTREAMED = {"fasta-exclude-stream"}


def _argv(d: Path, name: str, tag: str) -> list[str]:
    src, args = CLI_CASES[name]
    return ["--file", str(d / src)] + [
        a.replace("{out}", str(d / f"{name}_{tag}.npz"))
         .replace("{keep}", str(d / "keep.txt")) for a in args]


def run_cli(main, argv: list[str]) -> tuple[int, str, str]:
    """``(exit code, stdout, first stderr line)`` of one in-process run."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:        # argparse errors
            rc = e.code
    lines = err.getvalue().splitlines()
    return rc, out.getvalue(), (lines[0] if lines else "")


def _jax_reference(out_dir: str) -> None:
    """Subprocess body: the JAX CLI on every case."""
    import weightedld_tpu.runtime.driver as jd
    from weightedld_tpu import cli as jcli

    # The tiled sessions on the Pallas kernels (interpret mode off a TPU).
    resolve = jd._resolve_engine
    jd._resolve_engine = lambda engine, platform=None: (
        "pallas" if engine == "auto" else resolve(engine, platform))
    d = Path(out_dir)
    meta = {}
    for name in CLI_CASES:
        argv = _argv(d, name, "jax")
        if name in JAX_UNSTREAMED:
            argv.remove("--stream-ingest")
        rc, out, err = run_cli(jcli.main, argv)
        meta[name] = {"rc": rc, "out": out, "err": err}
    (d / "meta.json").write_text(json.dumps(meta))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("regions")
    write_inputs(d)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_regions import _jax_reference; "
            "_jax_reference(sys.argv[2])")
    subprocess.run([sys.executable, "-c", code, str(REPO), str(d)],
                   env=env, check=True, timeout=900, cwd=REPO)
    return d, json.loads((d / "meta.json").read_text())


def _hold_json(got: str, want: str) -> None:
    g = json.loads(got.strip().splitlines()[-1])
    w = json.loads(want.strip().splitlines()[-1])
    g.pop("elapsed_s", None)
    w.pop("elapsed_s", None)
    assert set(g) == set(w)
    for key, val in w.items():
        if key in ("r2_sum_over_threshold", "r2_sum", "abs_d_prime_sum",
                   "r2_mean", "abs_d_prime_mean"):
            np.testing.assert_allclose(np.array(g[key], float),
                                       np.array(val, float), rtol=1e-5,
                                       err_msg=key)
        else:
            assert g[key] == val, key


@pytest.mark.parametrize("name", list(CLI_CASES))
def test_cli_equals_jax(jax_ref, name):
    d, meta = jax_ref
    want = meta[name]
    rc, out, err = run_cli(cli.main, _argv(d, name, "port")
                           + ["--device", "cpu"])
    assert rc == want["rc"], (err, want["err"])
    if rc != 0:
        assert rc == 2 and err == want["err"] and err.startswith("error:")
        return
    args = CLI_CASES[name][1]
    if "--matrix-output" in args:
        got_m = np.load(d / f"{name}_port.npz")
        want_m = np.load(d / f"{name}_jax.npz")
        keep = want_m["keep"]
        np.testing.assert_array_equal(got_m["keep"], keep)
        np.testing.assert_array_equal(got_m["site_map"], want_m["site_map"])
        for key in ("d", "d_prime", "r2"):
            np.testing.assert_array_equal(got_m[key][keep],
                                          want_m[key][keep])
            assert np.isnan(got_m[key][~keep]).all()
        assert keep.any()
    elif any(a in args for a in ("--stats-only", "--ld-decay", "--r2-hist")):
        _hold_json(out, want["out"])
    else:
        assert out == want["out"]
        assert out.count("\n") >= 2


def test_cli_cases_cover_each_flag():
    flags = {a for _src, args in CLI_CASES.values() for a in args
             if a.startswith("--")}
    assert {"--max-distance", "--max-distance-bp", "--cross-regions",
            "--chrom", "--region", "--list-chroms", "--keep-samples",
            "--exclude-samples"} <= flags
    assert flags - {"-"} <= {o for a in cli.build_parser()._actions
                     for o in a.option_strings}


# ---------------------------------------------------------------------------
# Regions, readers and the pipeline, in process
# ---------------------------------------------------------------------------

REGION_SPECS = [
    "chr1", "chr1:100-200", "chr1:44,890,000-44,890,200", "chr1:5-",
    "chr1:-9", "chr1:7-7", "HLA-A*01:01", "chr1:abc", "19:100-2x0",
    "chr1:1-2-3", "a:b:10-20", ":1-100", "chr1:9-5", "chr1:-", "chr1:",
]


@pytest.mark.parametrize("spec", REGION_SPECS)
def test_parse_region_equals_jax(spec):
    from weightedld_tpu.io import vcf as jvcf

    try:
        want = jvcf.parse_region(spec)
    except jvcf.VcfError as e:
        with pytest.raises(pvcf.VcfError) as got:
            pvcf.parse_region(spec)
        assert str(got.value) == str(e)
        return
    assert pvcf.parse_region(spec) == want


def test_malformed_region_tails_are_names_as_in_jax():
    """ADVICE ``vcf.py:76``, reproduced: a typo in the numeric tail
    becomes a chromosome name that matches no record."""
    assert pvcf.parse_region("19:100-2x0") == ("19:100-2x0", None)
    assert pvcf.parse_region("chr1:1-2-3") == ("chr1:1-2-3", None)


OVERLAP_PAIRS = [("1", "2"), ("1", "1"), ("1:1-10", "1:11-20"),
                 ("1:1-10", "1:10-20"), ("1:5-", "1:1-4"), ("1", "1:3-4"),
                 ("1:-9", "1:9-"), ("x:1-2", "y:1-2")]


@pytest.mark.parametrize("a,b", OVERLAP_PAIRS)
def test_regions_overlap_equals_jax(a, b):
    from weightedld_tpu.pipeline import regions_overlap

    assert pipe.regions_overlap(a, b) == regions_overlap(a, b)
    assert pipe.regions_overlap(b, a) == regions_overlap(b, a)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("region_inputs")
    write_inputs(d)
    return d


READ_FILTERS = [(None, None), ("1", None), ("2", None), ("2", (500, 3000)),
                ("1", (3000, 1 << 62)), (None, (200, 900))]


@pytest.mark.parametrize("chrom,pos_range", READ_FILTERS)
def test_readers_with_filters_equal_jax(inputs, chrom, pos_range):
    from weightedld_tpu.io import vcf as jvcf

    path = inputs / "two.vcf"
    got = pvcf.read_vcf(path, chrom=chrom, pos_range=pos_range)
    want = jvcf.read_vcf(path, chrom=chrom, pos_range=pos_range)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got_py = pvcf.read_vcf_python(path, chrom=chrom, pos_range=pos_range)
    for g, w in zip(got_py, want):
        np.testing.assert_array_equal(g, w)
    n_haps, sm = pvcf.scan_vcf(path, chrom, pos_range)
    jn, jsm = jvcf.scan_vcf(path, chrom, pos_range)
    assert n_haps == jn
    np.testing.assert_array_equal(sm, jsm)
    mask = np.random.default_rng(1).random(n_haps) < 0.6
    got_sm = pvcf.read_vcf_site_major(path, s_pad=len(sm) + 5,
                                      n_pad=int(mask.sum()) + 3,
                                      chrom=chrom, pos_range=pos_range,
                                      row_mask=mask)
    want_sm = jvcf.read_vcf_site_major(path, chrom=chrom,
                                       s_pad=len(sm) + 5,
                                       n_pad=int(mask.sum()) + 3,
                                       pos_range=pos_range, row_mask=mask)
    for g, w in zip(got_sm, want_sm):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got_sm[0][:len(sm), :int(mask.sum())],
                                  got[0][mask].T)


@pytest.mark.parametrize("chrom,pos_range", [("3", None), ("1", (1, 2)),
                                             (None, (1, 2))])
def test_reader_no_records_errors_equal_jax(inputs, chrom, pos_range):
    from weightedld_tpu.io import vcf as jvcf

    path = inputs / "two.vcf"
    for fn in ("read_vcf", "scan_vcf"):
        with pytest.raises(jvcf.VcfError) as want:
            getattr(jvcf, fn)(path, chrom=chrom, pos_range=pos_range)
        with pytest.raises(pvcf.VcfError) as got:
            getattr(pvcf, fn)(path, chrom=chrom, pos_range=pos_range)
        assert str(got.value) == str(want.value)


def test_list_chromosomes_and_sample_names_equal_jax(inputs, tmp_path):
    from weightedld_tpu.io import vcf as jvcf

    path = inputs / "two.vcf"
    assert pvcf.list_chromosomes(path) == jvcf.list_chromosomes(path) \
        == ["1", "2"]
    assert pvcf.vcf_sample_names(path) == jvcf.vcf_sample_names(path)
    bad = tmp_path / "bad.vcf"
    bad.write_text("##x\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
    for fn in ("list_chromosomes", "vcf_sample_names"):
        with pytest.raises(jvcf.VcfError) as want:
            getattr(jvcf, fn)(bad)
        with pytest.raises(pvcf.VcfError) as got:
            getattr(pvcf, fn)(bad)
        assert str(got.value).replace(str(bad), "") == \
            str(want.value).replace(str(bad), "")


PREPARE_CFGS = [
    dict(region="2:500-3500"),
    dict(chrom="1", keep_samples=tuple(KEEP)),
    dict(region="1", exclude_samples=("s0", "s5", "s9")),
    dict(keep_samples=tuple(KEEP), exclude_samples=("s2",)),
    dict(chrom="2", unweighted=True, exclude_samples=("s3",)),
]


@pytest.mark.parametrize("case", range(len(PREPARE_CFGS)))
def test_prepare_with_filters_equals_jax(inputs, case):
    from weightedld_tpu.pipeline import WldConfig as JWld
    from weightedld_tpu.pipeline import prepare as jprepare

    kw = PREPARE_CFGS[case]
    path = inputs / "two.vcf"
    got = pipe.prepare(path, pipe.WldConfig(**kw), device="cpu")
    want = jprepare(path, JWld(**kw))
    np.testing.assert_array_equal(got.alignment, want.alignment)
    np.testing.assert_array_equal(got.site_map, want.site_map)
    np.testing.assert_array_equal(got.weights, want.weights)
    ref = pipe.prepare(path, pipe.WldConfig(chrom=kw.get("chrom")),
                       device="cpu")
    assert got.alignment.shape[0] < ref.alignment.shape[0] or \
        got.alignment.shape[1] < ref.alignment.shape[1] or "region" in kw


@pytest.mark.parametrize("keep,exclude", [
    (tuple(f"seq{i}" for i in range(0, 40, 3)), None),
    (None, ("seq1", "seq7")),
    (tuple(f"seq{i}" for i in range(20)), ("seq4",)),
])
def test_fasta_sample_subsets_equal_jax(inputs, keep, exclude):
    from weightedld_tpu.io import fasta as jfasta
    from weightedld_tpu.pipeline import WldConfig as JWld
    from weightedld_tpu.pipeline import prepare as jprepare

    path = inputs / "amb.fasta"
    kw = dict(keep_samples=keep, exclude_samples=exclude)
    got = pipe.prepare(path, pipe.WldConfig(**kw), device="cpu")
    want = jprepare(path, JWld(**kw))
    for f in ("alignment", "site_map", "weights", "hk_mask", "ld_mask"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    n, s, counts, mask = pfasta.scan_fasta(path, **kw)
    jn, js, jcounts, jmask = jfasta.scan_fasta(path, **kw)
    assert (n, s) == (jn, js)
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_array_equal(mask, jmask)
    ld = np.random.default_rng(2).random(s) < 0.7
    np.testing.assert_array_equal(
        pfasta.read_fasta_site_major(path, ld, scan=(n, s), s_pad=100,
                                     n_pad=64, row_mask=mask),
        jfasta.read_fasta_site_major(path, ld, s_pad=100, n_pad=64,
                                     scan=(jn, js), row_mask=jmask))


@pytest.mark.parametrize("keep,exclude", [
    (("s0", "nobody"), None), (None, ("zz",)), (("s0",), ("s0",)),
])
def test_sample_subset_errors_equal_jax(inputs, keep, exclude):
    from weightedld_tpu.pipeline import WldConfig as JWld
    from weightedld_tpu.pipeline import prepare as jprepare

    path = inputs / "two.vcf"
    kw = dict(keep_samples=keep, exclude_samples=exclude)
    with pytest.raises(ValueError) as want:
        jprepare(path, JWld(**kw))
    with pytest.raises(ValueError) as got:
        pipe.prepare(path, pipe.WldConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value)


def test_vcf_row_names_equal_jax(inputs):
    from weightedld_tpu.pipeline import _vcf_row_names

    path = inputs / "two.vcf"
    for n_haps in (2 * N_SAMPLES, N_SAMPLES):
        assert pipe._vcf_row_names(path, n_haps) == \
            _vcf_row_names(path, n_haps)
    with pytest.raises(ValueError) as want:
        _vcf_row_names(path, 7)
    with pytest.raises(ValueError) as got:
        pipe._vcf_row_names(path, 7)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("a,b,kw", [
    ("1", "2", {}),
    (CROSS_A, CROSS_B, dict(keep_samples=tuple(KEEP))),
    ("2:1-2000", "1:3000-", dict(exclude_samples=("s1",), unweighted=True)),
])
def test_prepare_vcf_cross_equals_jax(inputs, a, b, kw):
    from weightedld_tpu.pipeline import WldConfig as JWld
    from weightedld_tpu.pipeline import prepare_vcf_cross as jcross

    path = inputs / "two.vcf"
    got, split = pipe.prepare_vcf_cross(path, pipe.WldConfig(**kw), a, b,
                                        device="cpu")
    want, jsplit = jcross(path, JWld(**kw), a, b)
    assert split == jsplit
    for f in ("alignment", "site_map", "weights"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("a,b,kw", [
    ("1", "1:5-9", {}), ("1:1-2", "2", {}), ("1", "2", dict(chrom="1")),
])
def test_prepare_vcf_cross_errors_equal_jax(inputs, a, b, kw):
    from weightedld_tpu.pipeline import WldConfig as JWld
    from weightedld_tpu.pipeline import prepare_vcf_cross as jcross

    path = inputs / "two.vcf"
    with pytest.raises(ValueError) as want:
        jcross(path, JWld(**kw), a, b)
    with pytest.raises(ValueError) as got:
        pipe.prepare_vcf_cross(path, pipe.WldConfig(**kw), a, b,
                               device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(chrom="2"),
    dict(chrom="1", pos_range=(400, 5000), keep_samples=tuple(KEEP)),
    dict(exclude_samples=("s0", "s39")),
])
def test_streamed_vcf_filters_equal_jax(inputs, kw):
    from weightedld_tpu.runtime.driver import DriverConfig as JCfg
    from weightedld_tpu.runtime.ingest import (
        prepare_vcf_streamed as jstreamed,
    )

    path = inputs / "two.vcf"
    got, sm = prepare_vcf_streamed(path, DriverConfig(tile=32, seq_chunk=64),
                                   **kw)
    want, jsm = jstreamed(path, cfg=JCfg(tile=32, seq_chunk=64,
                                         engine="pallas"), **kw)
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(sm, jsm)
    assert (got.n_seqs, got.n_sites) == (want.n_seqs, want.n_sites)
    # The streamed buffer holds the batch pipeline's filtered matrix.
    region = None
    if "pos_range" in kw:
        region = f"{kw['chrom']}:{kw['pos_range'][0]}-{kw['pos_range'][1]}"
    res = pipe.prepare(path, pipe.WldConfig(
        chrom=None if region else kw.get("chrom"), region=region,
        keep_samples=kw.get("keep_samples"),
        exclude_samples=kw.get("exclude_samples")), device="cpu")
    np.testing.assert_array_equal(got.codes[:got.n_sites, :got.n_seqs],
                                  res.alignment.T)


def test_streamed_fasta_samples_equal_jax(inputs):
    from weightedld_tpu.runtime.driver import DriverConfig as JCfg
    from weightedld_tpu.runtime.ingest import (
        prepare_fasta_streamed as jstreamed,
    )

    path = inputs / "amb.fasta"
    kw = dict(keep_samples=tuple(f"seq{i}" for i in range(25)),
              exclude_samples=("seq3",))
    got = prepare_fasta_streamed(path, cfg=DriverConfig(tile=16,
                                                        seq_chunk=64), **kw)
    want = jstreamed(path, cfg=JCfg(tile=16, seq_chunk=64, engine="pallas"),
                     **kw)
    np.testing.assert_array_equal(got[0].codes, want[0].codes)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [3, 9])
def test_region_subset_window_composition(tmp_path, seed):
    """``--region`` + ``--keep-samples`` + ``--max-distance-bp`` equal a
    manual column and row slice of the full read, weighted alone, with the
    window as a filter of the slice's full run (``tests/test_pipeline.py:
    219-275`` on the port)."""
    from weightedld_tpu_torch.core.henikoff import henikoff_weights_host

    rng = np.random.default_rng(seed)
    names = [f"s{i}" for i in range(14)]
    rows, pos = [], 100
    for i in range(30):
        pos += int(rng.integers(5, 60))
        gts = "\t".join(f"{rng.integers(0, 2)}|{rng.integers(0, 2)}"
                        for _ in names)
        rows.append(f"chr3\t{pos}\trs{i}\tA\tT\t.\t.\t.\tGT\t{gts}")
    f = tmp_path / "c.vcf"
    f.write_text("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(names) + "\n" + "\n".join(rows) + "\n")
    lo, hi = 150, pos - 40
    res = pipe.prepare(f, pipe.WldConfig(region=f"chr3:{lo}-{hi}",
                                         keep_samples=tuple(names[:9])),
                       device="cpu")
    full, sm = pvcf.read_vcf(f)
    col = (sm >= lo) & (sm <= hi)
    n = full.shape[0]
    sub = full[np.ix_([k for k in range(n) if (n - 1 - k) // 2 < 9],
                      np.flatnonzero(col))]
    np.testing.assert_array_equal(res.alignment, sub)
    np.testing.assert_array_equal(res.weights, henikoff_weights_host(sub))

    def recs(**cfg):
        sess = LdSession(res.alignment, res.weights, res.site_map,
                         DriverConfig(tile=8, **cfg), device="cpu")
        return {(int(a), int(b)): float(r2) for _b, r in sess.stream()
                for a, b, r2 in zip(r.pos_a, r.pos_b, r.r2)}

    everything = recs()
    want = {k: v for k, v in everything.items() if k[1] - k[0] <= 120}
    assert recs(max_bp_distance=120) == want and want
