"""Parity of the port's CLI with the JAX CLI on the flags ported last: the
``--compat rust`` preset, ``--fasta-reader``, ``--weighting``,
``--weight-mask``, ``--max-minor``, ``--engine reference``, ``--sort``,
``--out-format plink``, ``--site-stats``, ``--save-prepared`` /
``--load-prepared``, ``--checkpoint``, ``--progress`` / ``--progress-bar``,
``--profile-dir``, ``--version`` and ``-v``, on the CPU.

Each case runs the port's ``cli.main(..., "--device", "cpu")`` in process and
the JAX CLI in one subprocess per file, with ``XLA_FLAGS=--xla_cpu_max_isa=AVX``
(no FMA; see tests/test_torch_slice.py) and its tiled sessions on the
interpret-mode Pallas kernels, as tests/test_torch_regions.py does.  The
inputs are the in-memory fixtures, a synthetic two-chromosome VCF with SNP
ids, VCFs whose positions collide, and the ambiguous FASTA; never the
reference checkout.  Held: the exit code, standard output and every file
written byte for byte, and the first line of standard error (where it
carries no time or rate).  ``paper``-weighted output is held byte for byte
where the two packages' weights are bit-equal, and otherwise row for row:
positions exact, values within one quantum of ``--ndigits``.  The cases of
``tests/test_cli.py`` that exercise these flags are rerun here on these
inputs, ``--checkpoint`` without ``--pair-output`` (ignored, ADVICE
``cli.py:401``) among them.
"""

from __future__ import annotations

import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from weightedld_tpu_torch import __version__, cli

from .fixtures import ALL_FASTAS, write_fasta
from .test_torch_ambiguous import write_ambiguous_fasta
from .test_torch_regions import run_cli, write_two_chrom_vcf

REPO = Path(__file__).resolve().parent.parent
LAY = ["--engine", "tiled", "--tile", "32", "--seq-chunk", "64"]
LAY_F = ["--engine", "tiled", "--tile", "16", "--seq-chunk", "64"]
GTS = "\t".join(["0|1"] * 7 + ["1|0"] * 7)
VCF_HEAD = ("##fileformat=VCFv4.1\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\t"
            "INFO\tFORMAT\t" + "\t".join(f"s{i}" for i in range(14)))


def _vcf(path: Path, rows: list[tuple[str, int, str]]) -> None:
    path.write_text(VCF_HEAD + "\n" + "\n".join(
        f"{c}\t{p}\t{i}\tA\tT\t.\t.\t.\tGT\t{GTS}" for c, p, i in rows)
        + "\n")


def write_inputs(d: Path) -> None:
    for name in ("t1", "t3", "t6", "example"):
        write_fasta(d / f"{name}.fasta", ALL_FASTAS[name])
    write_fasta(d / "mono.fasta", ["AAAA"] * 6)
    (d / "ragged.fasta").write_text(">a\nACGT\n>b\nACG\n")
    # Wrapped records: one record, two lines -> ragged for the Rust reader.
    (d / "wrapped.fasta").write_text(">a\nACGTAC\nGT\n>b\nACGTTC\nGA\n"
                                     ">c\nTCGTAC\nGT\n")
    write_two_chrom_vcf(d / "two.vcf")
    write_ambiguous_fasta(d / "amb.fasta")
    _vcf(d / "dup.vcf", [("chr1", 100, "rsA"), ("chr1", 200, "rsA2"),
                         ("chr2", 100, "rsB"), ("chr2", 200, "rsB2")])
    _vcf(d / "dupid.vcf", [("chr1", 100, "rsSNP"), ("chr1", 100, "rsINDEL"),
                           ("chr1", 200, "rsC")])
    # A prepared cache both CLIs load (written by the port; the format is
    # the JAX package's).
    from weightedld_tpu_torch.pipeline import WldConfig, prepare
    from weightedld_tpu_torch.runtime.cache import save_prepared

    save_prepared(d / "t3.npz", prepare(d / "t3.fasta", WldConfig(),
                                        device="cpu"),
                  {"min_acgt": 0.8, "min_variability": 0.02,
                   "unweighted": False, "max_minor": 1.0,
                   "weight_mask": "ld", "weighting": "python",
                   "chrom": None, "fasta_reader": "python", "region": None,
                   "keep_samples": None, "exclude_samples": None})


CROSS_A, CROSS_B = "1:1-2500", "1:2600-99999"
CASES = {
    # --compat rust and its parts.
    "compat-rust": ("t1.fasta", ["--compat", "rust"]),
    "compat-rust-weights": ("t1.fasta", ["--compat", "rust",
                                         "--weights-output", "{out}.w"]),
    "compat-rust-overrides": ("t3.fasta", ["--compat", "rust",
                                           "--r2-threshold", "0.05",
                                           "--ndigits", "5", "--weighting",
                                           "python", "--max-minor", "0.9"]),
    "compat-rust-amb-tiled": ("amb.fasta", ["--compat", "rust"] + LAY_F),
    "compat-rust-vcf-tiled": ("two.vcf", ["--compat", "rust", "--chrom",
                                          "1"] + LAY),
    "compat-rust-wrapped": ("wrapped.fasta", ["--compat", "rust"]),
    "fasta-reader-rust": ("t3.fasta", ["--fasta-reader", "rust"]),
    "fasta-reader-python-wins": ("wrapped.fasta", ["--compat", "rust",
                                                   "--fasta-reader",
                                                   "python"]),
    "fasta-reader-rust-keep": ("amb.fasta", ["--fasta-reader", "rust",
                                             "--keep-samples",
                                             ",".join(f"seq{i}"
                                                      for i in range(25))]
                               + LAY_F),
    "weighting-paper": ("example.fasta", ["--weighting", "paper",
                                          "--weights-output", "{out}.w"]),
    "weighting-paper-vcf": ("two.vcf", ["--weighting", "paper",
                                        "--r2-threshold", "0.05"] + LAY),
    "weighting-paper-stats": ("amb.fasta", ["--weighting", "paper",
                                            "--stats-only"] + LAY_F),
    "weight-mask-hk": ("t1.fasta", ["--weight-mask", "hk",
                                    "--weights-output", "{out}.w"]),
    "weight-mask-hk-amb": ("amb.fasta", ["--weight-mask", "hk"] + LAY_F),
    "max-minor": ("amb.fasta", ["--max-minor", "0.3"] + LAY_F),
    # --engine reference.
    "reference": ("t3.fasta", ["--engine", "reference"]),
    "reference-threshold": ("amb.fasta", ["--engine", "reference",
                                          "--r2-threshold", "0.05"]),
    "reference-top": ("t3.fasta", ["--engine", "reference", "--top", "3"]),
    "reference-stats": ("t3.fasta", ["--engine", "reference",
                                     "--stats-only", "--tile", "16",
                                     "--seq-chunk", "64"]),
    "reference-decay-warns": ("t3.fasta", ["--engine", "reference",
                                           "--ld-decay", "0,1,10",
                                           "--tile", "16", "--seq-chunk",
                                           "64"]),
    "reference-quant-warns": ("t3.fasta", ["--engine", "reference",
                                           "--weight-quant", "int8"]),
    "reference-cross": ("two.vcf", ["--engine", "reference",
                                    "--cross-regions", "1", "2"]),
    # --sort.
    "sort-t3": ("t3.fasta", ["--sort"] + LAY_F),
    "sort-vcf": ("two.vcf", ["--sort", "--r2-threshold", "0.1"] + LAY),
    "sort-amb-file": ("amb.fasta", ["--sort", "--pair-output",
                                    "{out}.tsv"] + LAY_F),
    # --out-format plink.
    "plink-vcf-chrom": ("two.vcf", ["--out-format", "plink", "--chrom",
                                    "1"] + LAY),
    "plink-vcf-tiled": ("two.vcf", ["--out-format", "plink", "--region",
                                    "1:1-4000"] + LAY),
    "plink-vcf-file": ("two.vcf", ["--out-format", "plink", "--chrom", "2",
                                   "--pair-output", "{out}.ld"] + LAY),
    "plink-vcf-sort": ("two.vcf", ["--out-format", "plink", "--chrom", "2",
                                   "--sort"] + LAY),
    "plink-two-chroms": ("two.vcf", ["--out-format", "plink"]),
    "plink-top": ("two.vcf", ["--out-format", "plink", "--chrom", "1",
                              "--top", "5"] + LAY),
    "plink-prune": ("two.vcf", ["--out-format", "plink", "--chrom", "1",
                                "--prune-r2", "0.1"] + LAY),
    "plink-cross": ("two.vcf", ["--out-format", "plink", "--cross-regions",
                                "1", "2", "--r2-threshold", "0.1"] + LAY),
    "plink-cross-prune": ("two.vcf", ["--out-format", "plink",
                                      "--cross-regions", CROSS_A, CROSS_B,
                                      "--prune-r2", "1.01"] + LAY),
    "plink-fasta": ("example.fasta", ["--out-format", "plink"]),
    "plink-fasta-tiled-file": ("amb.fasta", ["--out-format", "plink",
                                             "--pair-output",
                                             "{out}.ld"] + LAY_F),
    "plink-empty": ("mono.fasta", ["--out-format", "plink"]),
    "plink-dup-pos": ("dup.vcf", ["--out-format", "plink"]),
    "plink-dup-pos-chrom": ("dup.vcf", ["--out-format", "plink", "--chrom",
                                        "chr2"]),
    "plink-dup-id-warns": ("dupid.vcf", ["--out-format", "plink"]),
    "plink-stats-only": ("two.vcf", ["--out-format", "plink",
                                     "--stats-only"]),
    "plink-load-prepared": (None, ["--load-prepared", "{d}/t3.npz",
                                   "--out-format", "plink"]),
    # --site-stats.
    "site-stats": ("t1.fasta", ["--site-stats", "{out}.tsv"]),
    "site-stats-stdout": ("amb.fasta", ["--site-stats", "-", "--max-minor",
                                        "0.4", "--min-acgt", "0.9"]),
    "site-stats-rust": ("t3.fasta", ["--site-stats", "-",
                                     "--compat", "rust"]),
    "site-stats-vcf": ("two.vcf", ["--site-stats", "-", "--region",
                                   "2:1-3000", "--keep-samples", "s1,s4"]),
    "site-stats-stats-only": ("t1.fasta", ["--site-stats", "-",
                                           "--stats-only"]),
    "site-stats-no-file": (None, ["--site-stats", "-"]),
    "site-stats-save": ("t1.fasta", ["--site-stats", "-", "--save-prepared",
                                     "{out}.npz"]),
    "site-stats-ragged": ("ragged.fasta", ["--site-stats", "-"]),
    "site-stats-cross": ("two.vcf", ["--site-stats", "-", "--cross-regions",
                                     "1", "2"]),
    "list-chroms-save": ("two.vcf", ["--list-chroms", "--save-prepared",
                                     "{out}.npz"]),
    # --save-prepared / --load-prepared.
    "save-prepared": ("amb.fasta", ["--save-prepared", "{out}.npz",
                                    "--r2-threshold", "0.2"] + LAY_F),
    "load-prepared": (None, ["--load-prepared", "{d}/t3.npz"]),
    "load-prepared-warns": ("t1.fasta", ["--load-prepared", "{d}/t3.npz",
                                         "--min-acgt", "0.5",
                                         "--keep-samples", "seq0,seq1"]
                        + LAY_F),
    "load-prepared-stream": (None, ["--load-prepared", "{d}/t3.npz",
                                    "--stream-ingest"]),
    "load-prepared-cross": ("two.vcf", ["--load-prepared", "{d}/t3.npz",
                                        "--cross-regions", "1", "2"]),
    "no-file": (None, ["--r2-threshold", "0.1"]),
    # --stream-ingest's refusals of the new flags.
    "stream-save": ("two.vcf", ["--stream-ingest", "--save-prepared",
                                "{out}.npz"] + LAY),
    "stream-paper": ("two.vcf", ["--stream-ingest", "--weighting",
                                 "paper"] + LAY),
    "stream-reference": ("two.vcf", ["--stream-ingest", "--engine",
                                     "reference"]),
    "stream-rust-fasta": ("amb.fasta", ["--stream-ingest", "--compat",
                                        "rust"] + LAY_F),
    "stream-hk-fasta": ("amb.fasta", ["--stream-ingest", "--weight-mask",
                                      "hk"] + LAY_F),
    # --checkpoint.
    "checkpoint-file": ("two.vcf", ["--checkpoint", "--pair-output",
                                    "{out}.tsv", "--tiles-per-batch",
                                    "2"] + LAY),
    "checkpoint-gz": ("amb.fasta", ["--checkpoint", "--pair-output",
                                    "{out}.tsv.gz", "--tiles-per-batch",
                                    "3"] + LAY_F),
    "checkpoint-plink-gz": ("two.vcf", ["--checkpoint", "--out-format",
                                        "plink", "--chrom", "1",
                                        "--pair-output", "{out}.ld.gz"]
                            + LAY),
    "checkpoint-stdout-dash": ("t3.fasta", ["--checkpoint", "--pair-output",
                                            "-"] + LAY_F),
    "checkpoint-no-output-ignored": ("t3.fasta", ["--checkpoint"] + LAY_F),
    "gzip-output": ("amb.fasta", ["--pair-output", "{out}.tsv.gz",
                                  "--weights-output", "{out}.w.gz"]
                    + LAY_F),
    # Progress, profile, version, verbosity.
    "progress": ("two.vcf", ["--progress", "--chrom", "1"] + LAY),
    "progress-bar": ("amb.fasta", ["--progress-bar"] + LAY_F),
    "progress-bar-prune": ("two.vcf", ["--progress-bar", "--chrom", "2",
                                       "--prune-r2", "0.2"] + LAY),
    "profile-dir": ("two.vcf", ["--profile-dir", "{out}.prof", "--chrom",
                                "1"] + LAY),
    "version": (None, ["--version"]),
    "verbose": ("t3.fasta", ["-v"] + LAY_F),
}
# stderr carries a time or a rate in these cases: its first line is held
# to a pattern, not to the JAX bytes.
TIMED = {"progress", "progress-bar", "progress-bar-prune", "verbose",
         "profile-dir"}
# Held row for row where the two packages' paper weights differ.
PAPER = {name for name, (_src, args) in CASES.items()
         if "paper" in args or ("rust" in args and "--compat" in args)}
# The JAX CLI's trace is a jax.profiler trace; its output bytes are those
# of the same run without one.
NO_JAX_PROFILE = {"profile-dir"}


def _argv(d: Path, name: str, tag: str) -> list[str]:
    src, args = CASES[name]
    out = [] if src is None else ["--file", str(d / src)]
    return out + [a.replace("{out}", str(d / f"{name}_{tag}"))
                  .replace("{d}", str(d)) for a in args]


def _outputs(d: Path, name: str, tag: str) -> dict[str, bytes]:
    """The files a case wrote, by their suffix."""
    base = f"{name}_{tag}"
    return {p.name[len(base):]: p.read_bytes() for p in d.iterdir()
            if p.name.startswith(base) and p.is_file()}


def _recording(fn, seen: list):
    """``fn`` (a ``pipeline._weights_for``) that also appends each weight
    vector it returns to ``seen``."""
    def wrapped(*args, **kwargs):
        w = fn(*args, **kwargs)
        seen.append(np.asarray(w, np.float32))
        return w

    return wrapped


def _jax_reference(out_dir: str) -> None:
    """Subprocess body: the JAX CLI on every case."""
    import logging

    import weightedld_tpu.pipeline as jpipe
    import weightedld_tpu.runtime.driver as jd
    from weightedld_tpu import cli as jcli

    # The tiled sessions on the Pallas kernels (interpret mode off a TPU).
    resolve = jd._resolve_engine
    jd._resolve_engine = lambda engine, platform=None: (
        "pallas" if engine == "auto" else resolve(engine, platform))
    seen: list = []
    jpipe._weights_for = _recording(jpipe._weights_for, seen)
    d = Path(out_dir)
    meta = {}
    for name in CASES:
        # Each case configures logging as a fresh process would (-v).
        logging.root.handlers.clear()
        argv = _argv(d, name, "jax")
        if name in NO_JAX_PROFILE:
            i = argv.index("--profile-dir")
            del argv[i:i + 2]
        seen.clear()
        rc, out, err = run_cli(jcli.main, argv)
        meta[name] = {"rc": rc, "out": out, "err": err,
                      "weights": [w.tolist() for w in seen]}
    (d / "meta.json").write_text(json.dumps(meta))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    write_inputs(d)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_cli import _jax_reference; "
            "_jax_reference(sys.argv[2])")
    subprocess.run([sys.executable, "-c", code, str(REPO), str(d)],
                   env=env, check=True, timeout=900, cwd=REPO)
    return d, json.loads((d / "meta.json").read_text())


def _hold_rows(got: str, want: str, ndigits: int) -> None:
    """Row for row: every column but the value columns exact, the values
    within one quantum of ``ndigits``."""
    g = got.splitlines()
    w = want.splitlines()
    assert len(g) == len(w) and g[:1] == w[:1]
    header = w[0].split("\t")
    vals = [i for i, h in enumerate(header) if h in ("D", "D'", "R2", "DP")]
    q = 10.0 ** -ndigits
    for gl, wl in zip(g[1:], w[1:]):
        gc, wc = gl.split("\t"), wl.split("\t")
        assert [c for i, c in enumerate(gc) if i not in vals] \
            == [c for i, c in enumerate(wc) if i not in vals], (gl, wl)
        for i in vals:
            assert abs(float(gc[i]) - float(wc[i])) <= q * 1.0001, (gl, wl)


def _hold_json(got: str, want: str) -> None:
    """Counts exact, float32 sums and means within rtol 1e-5 (the packages
    sum batches in different orders)."""
    g = json.loads(got.strip().splitlines()[-1])
    w = json.loads(want.strip().splitlines()[-1])
    g.pop("elapsed_s", None)
    w.pop("elapsed_s", None)
    assert set(g) == set(w)
    for key, val in w.items():
        vals = val if isinstance(val, list) else [val]
        gots = g[key] if isinstance(g[key], list) else [g[key]]
        assert len(gots) == len(vals), key
        for a, b in zip(gots, vals):
            if isinstance(b, float):
                np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=key)
            else:
                assert a == b, key


@pytest.mark.parametrize("name", list(CASES))
def test_cli_equals_jax(jax_ref, monkeypatch, name):
    import weightedld_tpu_torch.pipeline as ppipe

    d, meta = jax_ref
    want = meta[name]
    seen: list = []
    monkeypatch.setattr(ppipe, "_weights_for",
                        _recording(ppipe._weights_for, seen))
    rc, out, err = run_cli(cli.main, _argv(d, name, "port")
                           + ["--device", "cpu"])
    assert rc == want["rc"], (err, want["err"])
    if name == "version":
        assert out == f"weightedld-tpu-torch {__version__}\n"
        assert want["out"] == f"weightedld-tpu {__version__}\n"
        return
    if name in TIMED:
        _hold_timed(name, err, want["err"], d)
    else:
        # The port's --weight-quant warning names no TPU.
        assert err == want["err"].replace("tiled TPU engine", "tiled engine")
    if rc != 0:
        assert rc == 2 and err.startswith("error:")
        return
    same_w = len(seen) == len(want["weights"]) and all(
        np.array_equal(a, np.asarray(b, np.float32))
        for a, b in zip(seen, want["weights"]))
    args = CASES[name][1]
    if name in PAPER and seen:
        np.testing.assert_allclose(
            np.concatenate(seen), np.concatenate(
                [np.asarray(w, np.float32) for w in want["weights"]]),
            rtol=2e-6)
    if "--stats-only" in args or "--ld-decay" in args:
        _hold_json(out, want["out"])
    elif name in PAPER and not same_w:
        nd = 3 if "--ndigits" not in args \
            else int(args[args.index("--ndigits") + 1])
        _hold_rows(out, want["out"], nd)
    else:
        assert out == want["out"]
    got_files = _outputs(d, name, "port")
    want_files = _outputs(d, name, "jax")
    assert set(got_files) == set(want_files)
    for suffix, data in want_files.items():
        if suffix.endswith(".npz"):
            _hold_npz(d / f"{name}_port{suffix}", d / f"{name}_jax{suffix}")
        elif name in PAPER and not same_w and suffix.endswith(".w"):
            np.testing.assert_allclose(
                np.loadtxt(io.BytesIO(got_files[suffix]), skiprows=1),
                np.loadtxt(io.BytesIO(data), skiprows=1), atol=1.0001e-6)
        elif name in PAPER and not same_w:
            _hold_rows(got_files[suffix].decode(), data.decode(), 3)
        else:
            assert got_files[suffix] == data, suffix


def _hold_npz(got: Path, want: Path) -> None:
    with np.load(got) as g, np.load(want) as w:
        assert set(g.files) == set(w.files)
        for k in w.files:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _hold_timed(name: str, err: str, want_err: str, d: Path) -> None:
    if name == "progress":
        pat = r"^\[progress\] (\d+)/(\d+) pairs evaluated \([\d,]+ pairs/s, " \
            r"(\d+) records\)$"
        g, w = re.match(pat, err), re.match(pat, want_err)
        assert g and w and g.groups()[0] == g.groups()[1]
        # The same plan work and the same record count at the last report.
        assert g.groups() == w.groups()
    elif name.startswith("progress-bar"):
        assert err.startswith("[") and want_err.startswith("[")
        assert "100.0%" in err and "100.0%" in want_err
    elif name == "verbose":
        # The JAX CLI's first INFO line is its multi-process bring-up's,
        # which the port does not have yet (ROADMAP item 13).
        pat = r"^\[INFO\] \d{4}-\d\d-\d\d \d\d:\d\d:\d\d "
        assert re.match(pat + r"stage ingest +[\d.]+s$", err)
        assert re.match(pat, want_err)
    elif name == "profile-dir":
        traces = list((d / f"{name}_port.prof").glob("trace_*.json"))
        assert len(traces) == 1
        events = json.loads(traces[0].read_text())["traceEvents"]
        assert any(e.get("name") for e in events)


def test_progress_is_the_last_batch_once(jax_ref):
    """``--progress`` on a plan of many batches reports at most once per
    ``progress_every_s`` and always after the last batch: one line here,
    with every pair of the plan evaluated."""
    d, _meta = jax_ref
    rc, _out, err = run_cli(cli.main, _argv(d, "progress", "port")
                            + ["--device", "cpu"])
    assert rc == 0
    lines = [ln for ln in err.splitlines() if ln.startswith("[progress]")]
    assert len(lines) == 1


def test_checkpoint_without_output_is_ignored_in_both(jax_ref):
    """ADVICE ``cli.py:401``, reproduced: ``--checkpoint`` with no
    ``--pair-output`` writes the records to standard output, warns nothing
    and leaves no checkpoint, in both CLIs."""
    d, meta = jax_ref
    want = meta["checkpoint-no-output-ignored"]
    rc, out, err = run_cli(cli.main, _argv(d, "checkpoint-no-output-ignored",
                                           "port") + ["--device", "cpu"])
    for got in ((rc, out, err), (want["rc"], want["out"], want["err"])):
        assert got[0] == 0 and got[2] == ""
        assert got[1].startswith("posa\tposb\t") and got[1].count("\n") > 1
    assert not list(d.glob("*.ckpt.json")) and not list(
        Path.cwd().glob("*.ckpt.json"))


def test_cases_cover_each_ported_flag():
    flags = {a for _src, args in CASES.values() for a in args
             if a.startswith("-")}
    ported = {"--compat", "--fasta-reader", "--weighting", "--weight-mask",
              "--max-minor", "--engine", "--sort", "--out-format",
              "--site-stats", "--save-prepared", "--load-prepared",
              "--checkpoint", "--progress", "--progress-bar",
              "--profile-dir", "--version", "-v"}
    assert ported <= flags
    assert not set(cli.NOT_PORTED) & flags
