"""Parity of the port's native ingest (weightedld_tpu_torch/io/native.py,
which builds ``native/wldio.cpp`` itself) and of its streaming readers with
the JAX package, on the CPU.

* Readers: the port's native FASTA / VCF readers against the JAX package's
  Python readers (``read_fasta_with_names_python``, ``read_vcf_python``),
  array for array and error message for error message, on the fixtures,
  random, gzip and CRLF inputs, mutated inputs and a missing file; the
  port's Python reader (``WLD_NATIVE_IO=0``) against its native one.
* Formatter and transpose: the native pair / weights formatter against the
  Python formatter, byte for byte; ``transpose_pad_i8`` and the native
  branch of ``pad_alignment_site_major`` against the numpy pad.
* Streaming readers: ``scan_vcf`` / ``read_vcf_site_major`` /
  ``scan_fasta`` / ``read_fasta_site_major`` equal to the JAX ones, and the
  site-major histogram bit-equal to JAX's.
"""

from __future__ import annotations

import gzip
import io
import string
import warnings
from pathlib import Path

import numpy as np
import pytest

from weightedld_tpu.core.sites import (
    site_histogram_host_site_major as jax_hist_sm,
)
from weightedld_tpu.io import fasta as jfasta
from weightedld_tpu.io import vcf as jvcf
from weightedld_tpu.io.writer import _fmt as jax_fmt
from weightedld_tpu_torch.core.ld_dense import LdRecords
from weightedld_tpu_torch.core.sites import site_histogram_host_site_major
from weightedld_tpu_torch.io import fasta, native, vcf
from weightedld_tpu_torch.io.writer import write_pairs, write_weights
from weightedld_tpu_torch.ops.cuda_ld import pad_alignment_site_major

from .fixtures import ALL_FASTAS, random_alignment, write_fasta

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def python_io(monkeypatch):
    """Force the port's Python readers and formatters."""
    monkeypatch.setenv("WLD_NATIVE_IO", "0")


def test_library_builds_into_the_package_and_is_not_the_jax_one():
    assert native.available(), native.build_error()
    path = native.library_path()
    assert path.exists() and path.parent == REPO / "weightedld_tpu_torch" \
        / "build"
    assert native.load().wldio_version() == b"wldio-4"


def test_switch_forces_python(python_io):
    assert native.load() is None and not native.available()


def test_failed_build_warns_once_and_falls_back(tmp_path, monkeypatch):
    """A source that does not compile: one RuntimeWarning naming g++'s
    error, then the Python readers."""
    bad = tmp_path / "wldio.cpp"
    bad.write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_error", None)
    with pytest.warns(RuntimeWarning, match="no_such_header_here"):
        assert native.load() is None
    assert "no_such_header_here" in native.build_error()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert native.load() is None      # no second warning
    path = tmp_path / "t5.fasta"
    write_fasta(path, ALL_FASTAS["t5"])
    got, _ = fasta.read_fasta_with_names(path)
    want, _ = jfasta.read_fasta_with_names_python(path)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# FASTA
# ---------------------------------------------------------------------------


def _fasta_parity(path):
    got = native.read_fasta_native(path)
    want = jfasta.read_fasta_with_names_python(path)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.int8
    assert got[1] == want[1]


@pytest.mark.parametrize("name", sorted(ALL_FASTAS))
def test_fasta_fixture_parity(tmp_path, name):
    path = tmp_path / f"{name}.fasta"
    write_fasta(path, ALL_FASTAS[name])
    _fasta_parity(path)


def _random_fasta(path: Path, seed: int, n: int = 40, s: int = 500,
                  newline: str = "\n") -> None:
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(
        (string.ascii_letters + "-.*NRYKM").encode(), dtype=np.uint8)
    rows = alphabet[rng.integers(0, len(alphabet), size=(n, s))]
    with open(path, "w", newline="") as fh:
        for i, row in enumerate(rows):
            text = row.tobytes().decode()
            fh.write(f">r{i} extra  stuff{newline}")
            width = int(rng.integers(50, 90))
            for j in range(0, len(text), width):
                fh.write(text[j:j + width] + newline)


@pytest.mark.parametrize("newline", ["\n", "\r\n"])
@pytest.mark.parametrize("seed", [1, 2])
def test_fasta_random_and_crlf_parity(tmp_path, seed, newline):
    path = tmp_path / "rand.fasta"
    _random_fasta(path, seed, newline=newline)
    _fasta_parity(path)


def test_fasta_gzip_parity(tmp_path):
    plain = tmp_path / "rand.fasta"
    _random_fasta(plain, 3)
    gz = tmp_path / "rand.fasta.gz"
    gz.write_bytes(gzip.compress(plain.read_bytes()))
    _fasta_parity(gz)
    np.testing.assert_array_equal(native.read_fasta_native(gz)[0],
                                  native.read_fasta_native(plain)[0])


@pytest.mark.parametrize("content", [
    ">a\nACG\n>b\nAC\n",
    "ACGT\n>a\nACGT\n",
    "\n\n",
    ">only\n>headers\n",
])
def test_fasta_errors_identical(tmp_path, content):
    path = tmp_path / "bad.fasta"
    path.write_text(content)
    with pytest.raises(ValueError) as want:
        jfasta.read_fasta_with_names_python(path)
    with pytest.raises(ValueError) as got:
        native.read_fasta_native(path)
    assert str(got.value) == str(want.value)


def _mutate(rng, text: str) -> str:
    b = bytearray(text.encode())
    for _ in range(rng.integers(1, 4)):
        if not b:
            break
        i = int(rng.integers(0, len(b)))
        op = rng.integers(0, 3)
        if op == 0:
            b[i] = int(rng.integers(32, 127))
        elif op == 1:
            del b[i:i + int(rng.integers(1, 6))]
        else:
            b = b[:i]
    return b.decode("latin-1")


def test_fasta_mutated_inputs_agree(tmp_path):
    rng = np.random.default_rng(99)
    base = ">a\nACGT\n>b\nTG-n\n>c wide\nAC\nGT\n"
    path = tmp_path / "f.fasta"
    for _ in range(60):
        text = _mutate(rng, base)
        path.write_text(text)
        try:
            want = jfasta.read_fasta_with_names_python(path)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                native.read_fasta_native(path)
            assert str(got.value) == str(e), repr(text)
            continue
        got = native.read_fasta_native(path)
        np.testing.assert_array_equal(got[0], want[0], err_msg=repr(text))
        assert got[1] == want[1], repr(text)


def test_fasta_port_python_equals_native(tmp_path, monkeypatch):
    path = tmp_path / "rand.fasta"
    _random_fasta(path, 4)
    aln_n, names_n = fasta.read_fasta_with_names(path)
    monkeypatch.setenv("WLD_NATIVE_IO", "0")
    aln_p, names_p = fasta.read_fasta_with_names(path)
    np.testing.assert_array_equal(aln_n, aln_p)
    assert names_n == names_p


# ---------------------------------------------------------------------------
# VCF
# ---------------------------------------------------------------------------

SAMPLES = 16
HEADER = ("##fileformat=VCFv4.1\n##contig=<ID=1>\n#CHROM\tPOS\tID\tREF\tALT"
          "\tQUAL\tFILTER\tINFO\tFORMAT\t"
          + "\t".join(f"s{i}" for i in range(SAMPLES)))


def _row(pos, gts):
    return f"1\t{pos}\trs{pos}\tA\tT\t100\tPASS\t.\tGT\t" + "\t".join(gts)


def _random_vcf_text(seed: int, n_sites: int = 60, newline: str = "\n",
                     trailing_newline: bool = True) -> str:
    """Phased, unphased, half-missing, FORMAT-subfield and ALT2/3 calls."""
    rng = np.random.default_rng(seed)
    forms = ["0|1", "1|0", "0|0", "1|1", ".|1", "0|.", ".|.", "0/1", "2|3",
             "1|2:35", "0|0:12:.", "3|1"]
    rows = [_row(100 + 13 * s, [forms[i] for i in
                                rng.integers(0, len(forms), SAMPLES)])
            for s in range(n_sites)]
    text = newline.join([*HEADER.split("\n"), *rows])
    return text + newline if trailing_newline else text


def _vcf_parity(path):
    got = native.read_vcf_native(path)
    want = jvcf.read_vcf_python(path)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int8 and got[1].dtype == np.int64


@pytest.mark.parametrize("newline", ["\n", "\r\n"])
@pytest.mark.parametrize("seed", [5, 6])
def test_vcf_random_and_crlf_parity(tmp_path, seed, newline):
    path = tmp_path / "rand.vcf"
    path.write_bytes(_random_vcf_text(seed, newline=newline).encode())
    _vcf_parity(path)


def test_vcf_trailing_line_quirk_parity(tmp_path):
    """No newline after the last record: both readers drop it."""
    path = tmp_path / "quirk.vcf"
    path.write_text(_random_vcf_text(7, n_sites=10, trailing_newline=False))
    _vcf_parity(path)
    assert native.read_vcf_native(path)[0].shape[1] == 9


def test_vcf_gzip_parity(tmp_path):
    plain = tmp_path / "rand.vcf"
    plain.write_text(_random_vcf_text(8))
    gz = tmp_path / "rand.vcf.gz"
    gz.write_bytes(gzip.compress(plain.read_bytes()))
    _vcf_parity(gz)
    np.testing.assert_array_equal(native.read_vcf_native(gz)[0],
                                  native.read_vcf_native(plain)[0])


@pytest.mark.parametrize("case", ["no_header", "one_sample", "alt6",
                                  "ragged", "bad_allele", "few_columns",
                                  "no_records"])
def test_vcf_errors_identical(tmp_path, case):
    ok = ["0|1"] * SAMPLES
    text = {
        "no_header": "1\t5\t.\tA\tT\t.\t.\t.\tGT\t0|1\n",
        "one_sample": ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\t"
                       "FORMAT\ts0\n1\t5\t.\tA\tT\t.\t.\t.\tGT\t0|1\n"),
        "alt6": HEADER + "\n" + _row(5, ["0|6"] + ok[1:]) + "\n",
        "ragged": (HEADER + "\n" + _row(5, ok) + "\n" + _row(6, ok[1:])
                   + "\n"),
        "bad_allele": HEADER + "\n" + _row(5, ["x|1"] + ok[1:]) + "\n",
        "few_columns": (HEADER + "\n" + _row(5, ok) + "\n"
                        + "1\t6\trs6\tA\tT\n" + _row(7, ok) + "\n"),
        "no_records": HEADER + "\n",
    }[case]
    path = tmp_path / f"{case}.vcf"
    path.write_text(text)
    with pytest.raises(jvcf.VcfError) as want:
        jvcf.read_vcf_python(path)
    with pytest.raises(vcf.VcfError) as got:
        native.read_vcf_native(path)
    assert str(got.value) == str(want.value)
    with pytest.raises(vcf.VcfError) as got_py:
        vcf.read_vcf_python(path)
    assert str(got_py.value) == str(want.value)


def test_vcf_mutated_inputs_agree(tmp_path):
    rng = np.random.default_rng(7)
    base = (HEADER + "\n" + _row(5, ["0|1", ".|.", "1|1", "0/1"] * 4) + "\n"
            + _row(9, ["0|0", "1|.", "2|3", "."] * 4) + "\n")
    path = tmp_path / "f.vcf"
    for _ in range(60):
        text = _mutate(rng, base)
        path.write_text(text)
        try:
            want = jvcf.read_vcf_python(path)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                native.read_vcf_native(path)
            assert str(got.value) == str(e), repr(text)
            continue
        got = native.read_vcf_native(path)
        np.testing.assert_array_equal(got[0], want[0], err_msg=repr(text))
        np.testing.assert_array_equal(got[1], want[1], err_msg=repr(text))


@pytest.mark.parametrize("reader", ["fasta", "vcf"])
def test_missing_file_raises_the_same_oserror(tmp_path, reader):
    path = tmp_path / f"absent.{reader}"
    read = {"fasta": native.read_fasta_native,
            "vcf": native.read_vcf_native}[reader]
    oracle = {"fasta": jfasta.read_fasta_with_names_python,
              "vcf": jvcf.read_vcf_python}[reader]
    with pytest.raises(OSError) as want:
        oracle(path)
    with pytest.raises(OSError) as got:
        read(path)
    assert type(got.value) is type(want.value) is FileNotFoundError


def test_vcf_dispatch_and_port_python_equal_native(tmp_path, monkeypatch):
    path = tmp_path / "rand.vcf"
    path.write_text(_random_vcf_text(9))
    aln_n, pos_n = vcf.read_vcf(path)
    want = native.read_vcf_native(path)
    np.testing.assert_array_equal(aln_n, want[0])
    monkeypatch.setenv("WLD_NATIVE_IO", "0")
    aln_p, pos_p = vcf.read_vcf(path)
    np.testing.assert_array_equal(aln_n, aln_p)
    np.testing.assert_array_equal(pos_n, pos_p)


# ---------------------------------------------------------------------------
# Formatter and transpose
# ---------------------------------------------------------------------------


def _records(seed: int, n: int) -> LdRecords:
    rng = np.random.default_rng(seed)
    vals = rng.random((3, n)).astype(np.float32) * 2 - 1
    # Rounding ties and edge values the formatter must reproduce.
    edge = np.array([0.00005, -0.00005, 0.12345, 0.99995, 1.0, -0.0, 0.0,
                     np.nan, np.inf, -np.inf, 1e-9, 123456.789, 2.5e-5,
                     0.30000001, 7e22], np.float32)
    vals[:, :len(edge)] = edge
    pos = np.sort(rng.integers(0, 2**40, size=(2, n)), axis=0)
    return LdRecords(pos_a=pos[0], pos_b=pos[1], d=vals[0], d_prime=vals[1],
                     r2=vals[2])


@pytest.mark.parametrize("ndigits", [0, 1, 4, 6, 9, 17, 100, 101, -1])
def test_write_pairs_native_bytes_equal_python(monkeypatch, ndigits):
    rec = _records(ndigits + 10, 3000)
    a = io.StringIO()
    write_pairs(rec, a, ndigits=ndigits)
    monkeypatch.setenv("WLD_NATIVE_IO", "0")
    b = io.StringIO()
    write_pairs(rec, b, ndigits=ndigits)
    assert a.getvalue() == b.getvalue()
    rows = [f"{pa}\t{pb}\t{jax_fmt(d, ndigits)}\t{jax_fmt(dp, ndigits)}\t"
            f"{jax_fmt(r2, ndigits)}" for pa, pb, d, dp, r2 in zip(
                rec.pos_a.tolist(), rec.pos_b.tolist(), rec.d.tolist(),
                rec.d_prime.tolist(), rec.r2.tolist())]
    assert a.getvalue() == "posa\tposb\tD\tD'\tR2\n" + "\n".join(rows) + "\n"


def test_write_pairs_native_chunks():
    """More than one 2^18-record chunk."""
    rec = _records(3, (1 << 18) + 77)
    a = io.StringIO()
    write_pairs(rec, a, header=False)
    assert a.getvalue().count("\n") == (1 << 18) + 77
    assert a.getvalue() == native.format_pairs_native(*rec, 4)


@pytest.mark.parametrize("ndigits", [0, 3, 6, 12])
def test_write_weights_native_bytes_equal_python(monkeypatch, ndigits):
    rng = np.random.default_rng(ndigits)
    w = np.concatenate([rng.random(500), [0.0, 1.0, 0.5, 1e-7, 0.0000005]])
    a = io.StringIO()
    write_weights(w, a, ndigits=ndigits)
    monkeypatch.setenv("WLD_NATIVE_IO", "0")
    b = io.StringIO()
    write_weights(w, b, ndigits=ndigits)
    assert a.getvalue() == b.getvalue()


@pytest.mark.parametrize("n,s,tile,chunk", [(7, 9, 4, 8), (130, 257, 64, 64),
                                            (1000, 300, 256, 192)])
def test_transpose_pad_equals_numpy(n, s, tile, chunk):
    rng = np.random.default_rng(n)
    aln = rng.integers(0, 6, size=(n, s)).astype(np.int8)
    s_pad, n_pad = -(-s // tile) * tile, -(-n // chunk) * chunk
    want = np.full((s_pad, n_pad), 5, np.int8)
    want[:s, :n] = aln.T
    np.testing.assert_array_equal(
        native.transpose_pad_i8(aln, s_pad, n_pad, 5), want)


def test_pad_alignment_native_branch_equals_numpy_oracle(monkeypatch):
    """At 2^24 cells the session's pad goes through the native transpose."""
    rng = np.random.default_rng(0)
    aln = rng.integers(0, 6, size=(1024, 16400), dtype=np.int8)  # > 2^24
    calls = []
    real = native.transpose_pad_i8
    monkeypatch.setattr(native, "transpose_pad_i8",
                        lambda *a: calls.append(1) or real(*a))
    got = pad_alignment_site_major(aln, 256, 192)
    assert calls == [1]
    monkeypatch.setenv("WLD_NATIVE_IO", "0")
    want = pad_alignment_site_major(aln, 256, 192)
    assert calls == [1]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Streaming readers and the site-major histogram
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pad", [None, (64, 64)])
def test_streaming_vcf_equals_jax(tmp_path, pad):
    path = tmp_path / "rand.vcf"
    path.write_text(_random_vcf_text(11, n_sites=50, trailing_newline=False))
    n_haps, site_map = vcf.scan_vcf(path)
    jn, jmap = jvcf.scan_vcf(path)
    assert n_haps == jn
    np.testing.assert_array_equal(site_map, jmap)
    s_pad, n_pad = pad or (None, None)
    got = vcf.read_vcf_site_major(path, s_pad=s_pad, n_pad=n_pad)
    want = jvcf.read_vcf_site_major(path, s_pad=s_pad, n_pad=n_pad)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == n_haps
    aln, _ = vcf.read_vcf(path)
    np.testing.assert_array_equal(got[0][:aln.shape[1], :aln.shape[0]],
                                  aln.T)


def test_streaming_vcf_errors_equal_jax(tmp_path):
    path = tmp_path / "rand.vcf"
    path.write_text(_random_vcf_text(12, n_sites=20))
    n_haps, site_map = vcf.scan_vcf(path)
    for scan in ((n_haps, site_map[:-1]), (n_haps, site_map + 1),
                 (n_haps + 2, site_map)):
        with pytest.raises(jvcf.VcfError) as want:
            jvcf.read_vcf_site_major(path, scan=scan)
        with pytest.raises(vcf.VcfError) as got:
            vcf.read_vcf_site_major(path, scan=scan)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="padding smaller"):
        vcf.read_vcf_site_major(path, s_pad=5)


@pytest.mark.parametrize("pad", [None, (96, 64)])
def test_streaming_fasta_equals_jax(tmp_path, pad):
    rng = np.random.default_rng(13)
    aln = random_alignment(rng, 50, 90)
    path = tmp_path / "r.fasta"
    write_fasta(path, ["".join("ACGT-N"[c] for c in row) for row in aln])
    n_seqs, n_sites, counts, mask = fasta.scan_fasta(path, block_rows=16)
    jn, js, jcounts, jmask = jfasta.scan_fasta(path, block_rows=16)
    assert (n_seqs, n_sites) == (jn, js) and mask is None and jmask is None
    np.testing.assert_array_equal(counts, jcounts)
    ld_mask = rng.random(n_sites) < 0.7
    s_pad, n_pad = pad or (None, None)
    got = fasta.read_fasta_site_major(path, ld_mask, scan=(n_seqs, n_sites),
                                      s_pad=s_pad, n_pad=n_pad)
    want = jfasta.read_fasta_site_major(path, ld_mask, s_pad=s_pad,
                                        n_pad=n_pad, scan=(jn, js))
    np.testing.assert_array_equal(got, want)
    k = int(ld_mask.sum())
    np.testing.assert_array_equal(got[:k, :n_seqs], aln[:, ld_mask].T)


def test_streaming_fasta_errors_equal_jax(tmp_path):
    path = tmp_path / "r.fasta"
    path.write_text(">a\nACGT\n>b\nAC\n")
    with pytest.raises(ValueError) as want:
        jfasta.scan_fasta(path)
    with pytest.raises(ValueError) as got:
        fasta.scan_fasta(path)
    assert str(got.value) == str(want.value)
    path.write_text(">a\nACGT\n>b\nACGA\n")
    mask = np.ones(4, bool)
    for scan in ((3, 4), (1, 4)):
        with pytest.raises(ValueError) as want:
            jfasta.read_fasta_site_major(path, mask, scan=scan)
        with pytest.raises(ValueError) as got:
            fasta.read_fasta_site_major(path, mask, scan=scan)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("row_chunk", [7, 4096])
def test_site_histogram_site_major_equals_jax(row_chunk):
    rng = np.random.default_rng(row_chunk)
    codes = rng.integers(0, 6, size=(160, 96)).astype(np.int8)
    got = site_histogram_host_site_major(codes, 150, 90, row_chunk=row_chunk)
    want = jax_hist_sm(codes, 150, 90, row_chunk=row_chunk)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)

