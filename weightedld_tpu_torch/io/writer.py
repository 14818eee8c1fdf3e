"""Output writers: pair records (TSV and PLINK layouts), per-sequence
weights and the per-site diagnostic TSV.

Copy of ``weightedld_tpu/io/writer.py``: ``PairAnnot`` and
``pair_header`` (``:28-46``), ``open_text_output`` and its wrappers
(``:48-101``), ``GzipMemberWriter`` (``:104-180``), ``_fmt`` and
``write_pairs`` with its PLINK rows (``:183-256``), ``write_weights``
(``:259-271``) and ``write_site_stats`` (``:274-291``).  The Python
reference prints ``posa posb D D' R2`` tab-separated with ``round(x, 4)``
formatting (``WeightedLD.py:176, 282-284``); the weights TSV is the Rust
reference's ``index weight`` dump (``main.rs:70-80``).  Both use the
native formatter (``io/native.py``, the same bytes) when it is built and
``0 <= ndigits <= 100``, else the Python one.  PLINK rows are formatted in
Python, as the JAX writer formats them (the native formatter covers the
TSV layout only).
"""

from __future__ import annotations

import io
import sys
from typing import IO, Mapping, NamedTuple

import numpy as np

from ..core.ld_dense import LdRecords

PAIR_HEADER = "posa\tposb\tD\tD'\tR2"

# PLINK --r2 dprime column order (CHR_A BP_A SNP_A CHR_B BP_B SNP_B R2 DP),
# tab-separated, plus a trailing D column (PLINK has no signed-D output).
PLINK_PAIR_HEADER = "CHR_A\tBP_A\tSNP_A\tCHR_B\tBP_B\tSNP_B\tR2\tDP\tD"


class PairAnnot(NamedTuple):
    """Per-site identity for PLINK-style pair output: position ->
    chromosome name / SNP id (the VCF CHROM and ID columns via
    ``io.vcf.site_annotations``, or synthesized for FASTA input).
    ``chrom_of_b`` / ``id_of_b``: separate maps for the pair's second
    endpoint (``--cross-regions``, whose blocks may share POS values on
    different chromosomes); None = the first endpoint's maps."""

    chrom_of: Mapping[int, str]
    id_of: Mapping[int, str]
    chrom_of_b: Mapping[int, str] | None = None
    id_of_b: Mapping[int, str] | None = None


def pair_header(annot: PairAnnot | None = None) -> str:
    return PLINK_PAIR_HEADER if annot is not None else PAIR_HEADER


def open_text_output(path):
    """Text handle for TSV output; ``.gz`` writes deterministic gzip
    (mtime 0, no file name) and ``-`` means stdout."""
    if str(path) == "-":
        return _StdoutText()
    if str(path).endswith(".gz"):
        return _DeterministicGzipText(path)
    return open(path, "w")


class _StdoutText:
    """Context-manager stdout wrapper whose close() does NOT close stdout."""

    def write(self, s):
        return sys.stdout.write(s)

    def flush(self):
        sys.stdout.flush()

    def close(self):
        sys.stdout.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _DeterministicGzipText(io.TextIOWrapper):
    """Gzip text writer with no mtime and no embedded file name."""

    def __init__(self, path):
        import gzip

        self._raw = open(path, "wb")
        gz = gzip.GzipFile(filename="", fileobj=self._raw, mode="wb", mtime=0)
        super().__init__(gz, encoding="utf-8")

    def close(self):
        try:
            super().close()
        finally:
            self._raw.close()


class GzipMemberWriter:
    """Checkpoint-compatible gzip TSV writer: the text written between
    ``flush()`` calls becomes one independent deterministic gzip member
    (mtime 0, no file name), and concatenated members form one valid gzip
    stream (RFC 1952 multi-member).  A resume can therefore truncate the
    file at any recorded member boundary (``tell()`` right after
    ``flush()``), which a single gzip stream cannot offer.  Text streams
    through an incremental ``zlib`` compressor, and a member's header is
    written with its first byte: an empty segment writes no member, so
    the bytes depend only on the records and a resumed run equals an
    uninterrupted one."""

    # RFC 1952 header: magic, deflate, no flags, mtime 0, XFL=2 (level 9,
    # as gzip.compress), OS=255 (unknown).
    _HEADER = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x02\xff"

    def __init__(self, path, append_at: int | None = None):
        if append_at is None:
            self._f = open(path, "wb")
        else:
            self._f = open(path, "r+b")
            self._f.truncate(append_at)
            self._f.seek(append_at)
        self._comp = None  # the open member's compressor, if any
        self._crc = 0
        self._size = 0

    def write(self, s: str) -> int:
        import zlib

        data = s.encode("utf-8")
        if not data:
            return 0
        if self._comp is None:
            self._comp = zlib.compressobj(9, zlib.DEFLATED, -15)
            self._crc = 0
            self._size = 0
            self._f.write(self._HEADER)
        self._crc = zlib.crc32(data, self._crc)
        self._size += len(data)
        out = self._comp.compress(data)
        if out:
            self._f.write(out)
        return len(s)

    def flush(self) -> None:
        import struct

        if self._comp is not None:
            self._f.write(self._comp.flush())
            self._f.write(struct.pack("<II", self._crc,
                                      self._size & 0xFFFFFFFF))
            self._comp = None
        self._f.flush()

    def tell(self) -> int:
        """The current member boundary; call right after :meth:`flush`."""
        return self._f.tell()

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _fmt(x: float, ndigits: int) -> str:
    # Python's print(round(x, 4)) semantics: shortest float repr.
    return repr(round(float(x), ndigits))


def write_pairs(records: LdRecords, out: IO[str] | None = None,
                ndigits: int = 4, header: bool = True,
                annot: PairAnnot | None = None) -> None:
    out = out if out is not None else sys.stdout
    if header:
        out.write(pair_header(annot) + "\n")
    if annot is not None:
        # PLINK rows (CHR/BP/SNP per endpoint); a position absent from the
        # maps writes chromosome "0" / id ".".
        co, io_ = annot.chrom_of, annot.id_of
        cob = annot.chrom_of_b if annot.chrom_of_b is not None else co
        iob = annot.id_of_b if annot.id_of_b is not None else io_
        rows: list[str] = []
        for pa, pb, d, dp, r2 in zip(
            records.pos_a.tolist(), records.pos_b.tolist(),
            records.d.tolist(), records.d_prime.tolist(),
            records.r2.tolist()
        ):
            pa, pb = int(pa), int(pb)
            rows.append(
                f"{co.get(pa, '0')}\t{pa}\t{io_.get(pa, '.')}\t"
                f"{cob.get(pb, '0')}\t{pb}\t{iob.get(pb, '.')}\t"
                f"{_fmt(r2, ndigits)}\t{_fmt(dp, ndigits)}\t"
                f"{_fmt(d, ndigits)}")
            if len(rows) >= 4096:
                out.write("\n".join(rows) + "\n")
                rows.clear()
        if rows:
            out.write("\n".join(rows) + "\n")
        return
    from . import native

    if native.available() and 0 <= ndigits <= 100:
        # Chunks of 2^18 records bound the formatter's buffer.
        chunk = 1 << 18
        for lo in range(0, len(records.pos_a), chunk):
            hi = lo + chunk
            out.write(native.format_pairs_native(
                records.pos_a[lo:hi], records.pos_b[lo:hi],
                records.d[lo:hi], records.d_prime[lo:hi],
                records.r2[lo:hi], ndigits))
        return
    buf: list[str] = []
    for pa, pb, d, dp, r2 in zip(
        records.pos_a.tolist(), records.pos_b.tolist(), records.d.tolist(),
        records.d_prime.tolist(), records.r2.tolist()
    ):
        buf.append(f"{pa}\t{pb}\t{_fmt(d, ndigits)}\t{_fmt(dp, ndigits)}\t"
                   f"{_fmt(r2, ndigits)}")
        if len(buf) >= 4096:
            out.write("\n".join(buf) + "\n")
            buf.clear()
    if buf:
        out.write("\n".join(buf) + "\n")


def write_weights(weights: np.ndarray, out: IO[str], ndigits: int = 6) -> None:
    """Per-sequence weights TSV: header ``sequence weight``, then
    ``index weight`` rows."""
    out.write("sequence\tweight\n")
    from . import native

    if native.available() and 0 <= ndigits <= 100:
        out.write(native.format_weights_native(np.asarray(weights), ndigits))
        return
    for i, w in enumerate(np.asarray(weights).tolist()):
        out.write(f"{i}\t{round(float(w), ndigits)}\n")


SITE_STATS_HEADER = "site\tcoverage\tmajor_code\tminor_fraction\thk\tld"


def write_site_stats(stats: dict, out: IO[str], ndigits: int = 4,
                     header: bool = True) -> None:
    """Per-site diagnostic TSV (``pipeline.site_stats``): one row per input
    site with the coverage and minor fraction the masks judge and the hk /
    ld verdicts (0/1)."""
    if header:
        out.write(SITE_STATS_HEADER + "\n")
    site = stats["site"]
    cov = stats["coverage"]
    mc = stats["major_code"]
    mf = stats["minor_fraction"]
    hk = stats["hk"]
    ld = stats["ld"]
    for i in range(len(site)):
        out.write(
            f"{site[i]}\t{round(float(cov[i]), ndigits)}\t{int(mc[i])}\t"
            f"{round(float(mf[i]), ndigits)}\t{int(hk[i])}\t{int(ld[i])}\n")
