"""Multi-sample VCF ingestion: the native reader, the Python reader, and
the two-pass streaming reader into the padded site-major layout.

Copy of ``read_vcf`` (the native dispatch of
``weightedld_tpu/io/vcf.py:178-207``), ``read_vcf_python``, ``scan_vcf``
(``:406-441``), ``read_vcf_site_major`` (``:443-522``) and their helpers
(``:118-260, 360-405, 524-560``), without the chromosome, region and sample
filters.  Semantics (reference ``WeightedLD.py:311-379``):

* header = first line containing ``#CHROM``; the first data line needs more
  than 12 tab columns (multi-sample file);
* phased ``a|b`` splits into two haplotype rows; unphased ``a/b`` becomes
  two missing haplotypes; ``.`` is code 4 (missing); allele indices above 5
  are rejected;
* ``site_map`` is the POS column as int64;
* rows are the haplotypes in reverse file order (the reference's
  ``np.rot90``);
* the reference's trailing-line quirk is kept: a file that does not end
  with a newline loses its last record;
* no site masking on the VCF path.
"""

from __future__ import annotations

import io as _io
from pathlib import Path

import numpy as np

from ..core.encode import ALIGNMENT_DTYPE, GAP, UNKNOWN
from .fasta import _open_maybe_gzip


class VcfError(ValueError):
    pass


def _parse_allele(tok: str) -> int:
    if tok == "." or tok == "":
        return GAP
    try:
        v = int(tok)
    except ValueError as e:
        raise VcfError(f"bad allele {tok!r}") from e
    if v > 5 or v < 0:
        raise VcfError(
            f"allele index {v} exceeds the supported alphabet (ALT1..ALT3 "
            "map to codes 1..3; ALT4/ALT5 alias the missing/ambiguous codes "
            "4/5 for reference parity; ALT6+ is unsupported)"
        )
    return v


def _fast_parse_gt_block(block: str) -> np.ndarray | None:
    """Vectorized decode of a genotype region whose fields are all exactly
    ``x?y`` with single-character alleles; None falls back to the general
    per-field parser."""
    m = len(block) + 1
    if m % 4 != 0:
        return None
    arr = np.frombuffer(block.encode("ascii", "replace"), dtype=np.uint8)
    a1, sep, a2 = arr[0::4], arr[1::4], arr[2::4]
    tabs = arr[3::4]
    if tabs.size and not (tabs == ord("\t")).all():
        return None
    phased = sep == ord("|")
    unphased = sep == ord("/")
    if not (phased | unphased).all():
        return None
    dot = ord(".")
    ok1 = (a1 == dot) | ((a1 >= ord("0")) & (a1 <= ord("5")))
    ok2 = (a2 == dot) | ((a2 >= ord("0")) & (a2 <= ord("5")))
    if not (ok1.all() and ok2.all()):
        return None
    v1 = np.where(a1 == dot, GAP, a1 - ord("0"))
    v2 = np.where(a2 == dot, GAP, a2 - ord("0"))
    v1 = np.where(unphased, GAP, v1)
    v2 = np.where(unphased, GAP, v2)
    row = np.empty(2 * len(v1), dtype=ALIGNMENT_DTYPE)
    row[0::2] = v1
    row[1::2] = v2
    return row


def read_vcf(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Read a multi-sample VCF into ``(alignment [n_haplotypes, n_sites]
    int8, site_map [n_sites] int64 POS)``: the native mmap / OpenMP reader
    (``io/native.py``) when it is built, with the same semantics and error
    messages, else :func:`read_vcf_python` (``WLD_NATIVE_IO=0`` forces
    it)."""
    from . import native

    if native.available():
        return native.read_vcf_native(path)
    return read_vcf_python(path)


def _iter_variant_lines(path: str | Path):
    """Yield ``(lineno, line)`` for every variant record (1-based line
    numbers), streaming, with the reference's trailing-line drop and blank
    lines skipped."""
    with _open_maybe_gzip(path) as raw:
        fh = _io.TextIOWrapper(raw, encoding="utf-8", errors="replace",
                               newline=None)
        in_data = False
        held = None            # (lineno, stripped_line, had_newline)
        lineno = 0
        for line in fh:
            lineno += 1
            had_nl = line.endswith("\n")
            body = line[:-1] if had_nl else line
            if not in_data:
                if "#CHROM" in body:
                    in_data = True
                continue
            if held is not None and held[1].strip():
                yield held[0], held[1]
            held = (lineno, body, had_nl)
        if not in_data:
            raise VcfError(f"{path}: no #CHROM header line found")
        if held is not None and held[2] and held[1].strip():
            yield held[0], held[1]


def _decode_record(path, lineno, line):
    """Parse one variant line -> ``(pos, row int8)``."""
    cols = line.split("\t", 9)
    if len(cols) < 10:
        raise VcfError(f"{path}:{lineno}: fewer than 10 columns")
    pos = int(cols[1])
    fast = _fast_parse_gt_block(cols[9])
    if fast is not None:
        return pos, fast

    haps: list[int] = []
    for field in cols[9].split("\t"):
        gt = field.split(":", 1)[0]
        if "|" in gt:
            a, b = gt.split("|", 1)
            haps.append(_parse_allele(a))
            haps.append(_parse_allele(b))
        elif "/" in gt:
            haps.append(GAP)
            haps.append(GAP)
        else:
            haps.append(_parse_allele(gt))
    return pos, np.asarray(haps, dtype=np.int16).astype(ALIGNMENT_DTYPE)


def _check_multisample(path, line):
    if len(line.split("\t")) <= 12:
        raise VcfError(
            f"{path}: too few sample columns — is this a multi-sample VCF?"
        )


def read_vcf_python(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Row-list VCF reader (``vcf.py:524-560`` without the chrom/region
    filters, which are not ported)."""
    positions: list[int] = []
    site_rows: list[np.ndarray] = []
    n_haps = None
    first = True

    for lineno, line in _iter_variant_lines(path):
        if first:
            _check_multisample(path, line)
            first = False
        pos, row = _decode_record(path, lineno, line)
        if n_haps is None:
            n_haps = len(row)
        elif len(row) != n_haps:
            raise VcfError(
                f"{path}:{lineno}: inconsistent haplotype count "
                f"({len(row)} vs {n_haps})"
            )
        positions.append(pos)
        site_rows.append(row)

    if first:
        raise VcfError(f"{path}: no variant records")
    site_map = np.asarray(positions, dtype=np.int64)
    mat = np.stack(site_rows, axis=0)                 # [n_sites, n_haps]
    alignment = np.ascontiguousarray(mat.T[::-1])     # rot90 row order
    return alignment, site_map


def scan_vcf(path: str | Path) -> tuple[int, np.ndarray]:
    """Pass 1 of the two-pass site-major ingest: ``(n_haplotypes,
    site_map)`` without decoding genotypes (the POS list only).  The first
    record is decoded once for the haplotype count; pass 2 re-validates
    every record."""
    positions: list[int] = []
    n_haps = None
    first = True
    for lineno, line in _iter_variant_lines(path):
        if first:
            _check_multisample(path, line)
            first = False
        cols = line.split("\t", 2)
        if len(cols) < 3:
            raise VcfError(f"{path}:{lineno}: fewer than 10 columns")
        positions.append(int(cols[1]))
        if n_haps is None:
            n_haps = len(_decode_record(path, lineno, line)[1])
    if first:
        raise VcfError(f"{path}: no variant records")
    return n_haps, np.asarray(positions, dtype=np.int64)


def read_vcf_site_major(
    path: str | Path,
    s_pad: int | None = None,
    n_pad: int | None = None,
    scan: tuple[int, np.ndarray] | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Two-pass streaming ingest straight into the padded SITE-MAJOR layout:
    ``(codes [s_pad, n_pad] int8, site_map, n_haplotypes)`` with
    ``codes[s, k] == alignment[k, s]`` for :func:`read_vcf`'s ``alignment``
    (row ``s`` holds the record's haplotypes reversed, the rot90 order) and
    UNKNOWN padding.  Pass 1 (:func:`scan_vcf`, or ``scan``) sizes the
    buffer, which is allocated once; pass 2 decodes each record into its
    row, so peak host memory is the buffer itself.  The record set is the
    readers' (trailing-line quirk included); a record count or POS that
    differs from pass 1's raises "file changed between ingest passes".
    ``s_pad`` / ``n_pad`` default to no padding; a session needs
    ``LdSession.required_padding``'s."""
    n_haps, site_map = scan if scan is not None else scan_vcf(path)
    s = len(site_map)
    s_pad = s if s_pad is None else s_pad
    n_pad = n_haps if n_pad is None else n_pad
    if s_pad < s or n_pad < n_haps:
        raise ValueError(f"padding smaller than data: {(s_pad, n_pad)} < "
                         f"{(s, n_haps)}")
    out = np.full((s_pad, n_pad), UNKNOWN, dtype=ALIGNMENT_DTYPE)
    i = 0
    for lineno, line in _iter_variant_lines(path):
        pos, row = _decode_record(path, lineno, line)
        if len(row) != n_haps:
            raise VcfError(
                f"{path}:{lineno}: inconsistent haplotype count "
                f"({len(row)} vs {n_haps})"
            )
        if i >= s or pos != site_map[i]:
            raise VcfError(f"{path}: file changed between ingest passes")
        out[i, :n_haps] = row[::-1]   # rot90 parity: reversed haplotypes
        i += 1
    if i != s:
        raise VcfError(f"{path}: file changed between ingest passes")
    return out, site_map, n_haps
