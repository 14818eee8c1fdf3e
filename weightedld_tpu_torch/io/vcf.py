"""Multi-sample VCF ingestion: the native reader, the Python reader, and
the two-pass streaming reader into the padded site-major layout.

Copy of ``parse_region`` and ``vcf_sample_names``
(``weightedld_tpu/io/vcf.py:49-115``), ``read_vcf`` (the native dispatch
of ``:178-207``; a chromosome or region filter reads through the Python
reader, as there), ``list_chromosomes`` (``:259-281``),
``site_annotations`` and ``site_annotations_multi`` (``:283-358``, the
CHROM / ID maps of ``--out-format plink``), ``read_vcf_python``,
``scan_vcf`` (``:406-441``) and ``read_vcf_site_major`` (``:443-522``) with
the ``chrom`` / ``pos_range`` filters and the sample ``row_mask``, and
their helpers (``:118-260, 360-405, 524-560``).  Semantics (reference
``WeightedLD.py:311-379``):

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


def parse_region(spec: str) -> tuple[str, tuple[int, int] | None]:
    """Parse a samtools-style region ``CHR`` or ``CHR:START-END`` into
    ``(chrom, pos_range)``: ``pos_range`` is a 1-based INCLUSIVE ``(lo,
    hi)`` over the POS column, or None for a whole chromosome.  A range
    needs a ``-`` in the tail after the LAST ``:``; open ends (``CHR:START-``,
    ``CHR:-END``) and digit-grouping commas are accepted; any other tail is
    part of the chromosome name (``HLA-A*01:01``).  As in the JAX package,
    a malformed numeric tail (``19:100-2x0``) also becomes a name
    (ROADMAP queue 3)."""
    chrom, sep, rng = spec.rpartition(":")
    if not sep:
        return spec, None
    lo_s, dash, hi_s = rng.partition("-")
    try:
        if not dash:
            raise ValueError
        lo_s = lo_s.replace(",", "")
        hi_s = hi_s.replace(",", "")
        lo = int(lo_s) if lo_s else 0
        hi = int(hi_s) if hi_s else (1 << 62)
    except ValueError:
        # No numeric START-END tail: the whole spec is a chromosome name.
        return spec, None
    if not chrom:
        raise VcfError(f"bad region {spec!r}: empty chromosome name")
    if lo < 0 or hi < lo:
        raise VcfError(f"bad region {spec!r}: need 0 <= START <= END")
    return chrom, (lo, hi)


def vcf_sample_names(path: str | Path) -> list[str]:
    """Sample names of the ``#CHROM`` header line (columns 10+), in file
    order, reading only the header.  Sample ``i`` owns file-order
    haplotypes ``2i`` and ``2i+1``; alignment row ``k`` belongs to sample
    ``(n_haps-1-k) // 2`` (the reference's ``np.rot90``).  The header test
    is the readers' ``"#CHROM" in line``, so the names align with the
    records."""
    with _open_maybe_gzip(path) as raw:
        fh = _io.TextIOWrapper(raw, encoding="utf-8", errors="replace",
                               newline=None)
        for line in fh:
            body = line.rstrip("\n")
            if "#CHROM" in body:
                cols = body.split("\t")
                if len(cols) < 10:
                    raise VcfError(
                        f"{path}: #CHROM header has no sample columns")
                return [c.strip() for c in cols[9:] if c.strip()]
    raise VcfError(f"{path}: no #CHROM header line found")


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


def read_vcf(path: str | Path, chrom: str | None = None,
             pos_range: tuple[int, int] | None = None,
             ) -> tuple[np.ndarray, np.ndarray]:
    """Read a multi-sample VCF into ``(alignment [n_haplotypes, n_sites]
    int8, site_map [n_sites] int64 POS)``: the native mmap / OpenMP reader
    (``io/native.py``) when it is built, with the same semantics and error
    messages, else :func:`read_vcf_python` (``WLD_NATIVE_IO=0`` forces
    it).  ``chrom`` keeps the records of one CHROM value and
    ``pos_range`` a 1-based inclusive POS window (:func:`parse_region`);
    a filtered read goes through :func:`read_vcf_python`, as in the JAX
    package."""
    if chrom is not None or pos_range is not None:
        return read_vcf_python(path, chrom=chrom, pos_range=pos_range)
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


def list_chromosomes(path: str | Path) -> list[str]:
    """Distinct CHROM values of the variant records in first-appearance
    order (the readers' record set, trailing-line quirk included), from the
    CHROM column alone, streaming."""
    seen: set[str] = set()
    out: list[str] = []
    for _lineno, ln in _iter_variant_lines(path):
        c = ln.split("\t", 1)[0]
        if c not in seen:
            seen.add(c)
            out.append(c)
    if not out:
        raise VcfError(f"{path}: no variant records")
    return out


def _decode_record(path, lineno, line, chrom=None, pos_range=None):
    """Parse one variant line -> ``(pos, row int8)``, or None where the
    chromosome or POS filter drops it."""
    cols = line.split("\t", 9)
    if len(cols) < 10:
        raise VcfError(f"{path}:{lineno}: fewer than 10 columns")
    if chrom is not None and cols[0] != chrom:
        return None
    pos = int(cols[1])
    if pos_range is not None and not (pos_range[0] <= pos <= pos_range[1]):
        return None
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


def _no_records_msg(path, chrom, pos_range=None):
    where = f" on chromosome {chrom!r}" if chrom is not None else ""
    if pos_range is not None:
        where += f" in POS range {pos_range[0]}-{pos_range[1]}"
    return f"{path}: no variant records{where}"


def read_vcf_python(path: str | Path, chrom: str | None = None,
                    pos_range: tuple[int, int] | None = None,
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Row-list VCF reader (``vcf.py:524-560``), the fallback and parity
    oracle of :func:`read_vcf`, with its filters."""
    positions: list[int] = []
    site_rows: list[np.ndarray] = []
    n_haps = None
    first = True

    for lineno, line in _iter_variant_lines(path):
        if first:
            _check_multisample(path, line)
            first = False
        rec = _decode_record(path, lineno, line, chrom, pos_range)
        if rec is None:
            continue
        pos, row = rec
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
    if not positions:
        raise VcfError(_no_records_msg(path, chrom, pos_range))
    site_map = np.asarray(positions, dtype=np.int64)
    mat = np.stack(site_rows, axis=0)                 # [n_sites, n_haps]
    alignment = np.ascontiguousarray(mat.T[::-1])     # rot90 row order
    return alignment, site_map


def site_annotations(path: str | Path, chrom: str | None = None,
                     pos_range: tuple[int, int] | None = None,
                     ) -> tuple[np.ndarray, list[str], list[str]]:
    """Streaming ``(positions, chroms, ids)`` over the record set the
    readers keep (chromosome / region filters and trailing-line quirk
    included): the CHROM and ID columns of each kept record, aligned with
    the readers' ``site_map``, without decoding genotypes.  The identity
    source of ``--out-format plink``."""
    positions: list[int] = []
    chroms: list[str] = []
    ids: list[str] = []
    first = True
    for lineno, line in _iter_variant_lines(path):
        if first:
            _check_multisample(path, line)
            first = False
        # The column check of _decode_record, so the annotation set cannot
        # drift from the readers' record set.
        cols = line.split("\t", 9)
        if len(cols) < 10:
            raise VcfError(f"{path}:{lineno}: fewer than 10 columns")
        if chrom is not None and cols[0] != chrom:
            continue
        pos = int(cols[1])
        if pos_range is not None \
                and not (pos_range[0] <= pos <= pos_range[1]):
            continue
        positions.append(pos)
        chroms.append(cols[0])
        ids.append(cols[2] if cols[2] else ".")
    if first:
        raise VcfError(f"{path}: no variant records")
    if not positions:
        raise VcfError(_no_records_msg(path, chrom, pos_range))
    return np.asarray(positions, dtype=np.int64), chroms, ids


def site_annotations_multi(
    path: str | Path,
    filters: list[tuple[str | None, tuple[int, int] | None]],
) -> list[tuple[np.ndarray, list[str], list[str]]]:
    """:func:`site_annotations` for several ``(chrom, pos_range)`` filters
    in one streaming pass (``--cross-regions --out-format plink``): one
    ``(positions, chroms, ids)`` tuple per filter; a filter that matches no
    record raises the single-filter form's error."""
    outs = [([], [], []) for _ in filters]
    first = True
    for lineno, line in _iter_variant_lines(path):
        if first:
            _check_multisample(path, line)
            first = False
        cols = line.split("\t", 9)
        if len(cols) < 10:
            raise VcfError(f"{path}:{lineno}: fewer than 10 columns")
        pos = int(cols[1])
        for (chrom, pos_range), (ps, cs, ids) in zip(filters, outs):
            if chrom is not None and cols[0] != chrom:
                continue
            if pos_range is not None \
                    and not (pos_range[0] <= pos <= pos_range[1]):
                continue
            ps.append(pos)
            cs.append(cols[0])
            ids.append(cols[2] if cols[2] else ".")
    if first:
        raise VcfError(f"{path}: no variant records")
    for (chrom, pos_range), (ps, _cs, _ids) in zip(filters, outs):
        if not ps:
            raise VcfError(_no_records_msg(path, chrom, pos_range))
    return [(np.asarray(ps, dtype=np.int64), cs, ids)
            for ps, cs, ids in outs]


def scan_vcf(path: str | Path, chrom: str | None = None,
             pos_range: tuple[int, int] | None = None,
             ) -> tuple[int, np.ndarray]:
    """Pass 1 of the two-pass site-major ingest: ``(n_haplotypes,
    site_map)`` of the records the filters keep, without decoding
    genotypes (the POS list only).  The first kept record is decoded once
    for the haplotype count; pass 2 re-validates every record."""
    positions: list[int] = []
    n_haps = None
    first = True
    for lineno, line in _iter_variant_lines(path):
        if first:
            _check_multisample(path, line)
            first = False
        cols = line.split("\t", 2)
        if chrom is not None and cols[0] != chrom:
            continue
        if len(cols) < 3:
            raise VcfError(f"{path}:{lineno}: fewer than 10 columns")
        pos = int(cols[1])
        if pos_range is not None \
                and not (pos_range[0] <= pos <= pos_range[1]):
            continue
        positions.append(pos)
        if n_haps is None:
            rec = _decode_record(path, lineno, line, chrom, pos_range)
            n_haps = len(rec[1])
    if first:
        raise VcfError(f"{path}: no variant records")
    if not positions:
        raise VcfError(_no_records_msg(path, chrom, pos_range))
    return n_haps, np.asarray(positions, dtype=np.int64)


def read_vcf_site_major(
    path: str | Path,
    s_pad: int | None = None,
    n_pad: int | None = None,
    scan: tuple[int, np.ndarray] | None = None,
    chrom: str | None = None,
    pos_range: tuple[int, int] | None = None,
    row_mask: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Two-pass streaming ingest straight into the padded SITE-MAJOR layout:
    ``(codes [s_pad, n_pad] int8, site_map, n_kept)`` with ``codes[s, k] ==
    alignment[k, s]`` for :func:`read_vcf`'s ``alignment`` under the same
    filters (row ``s`` holds the record's haplotypes reversed, the rot90
    order) and UNKNOWN padding.  ``row_mask`` (bool over alignment rows)
    drops samples' haplotypes while decoding; ``n_kept`` is the number of
    haplotype columns kept.  Pass 1 (:func:`scan_vcf`, or ``scan``) sizes
    the buffer, which is allocated once; pass 2 decodes each record into
    its row, so peak host memory is the buffer itself.  The record set is
    the readers' (trailing-line quirk included); a record count or POS that
    differs from pass 1's raises "file changed between ingest passes".
    ``s_pad`` / ``n_pad`` default to no padding; a session needs
    ``LdSession.required_padding``'s."""
    n_haps, site_map = scan if scan is not None \
        else scan_vcf(path, chrom, pos_range)
    if row_mask is not None:
        row_mask = np.asarray(row_mask, dtype=bool)
        if len(row_mask) != n_haps:
            raise ValueError("row_mask length must equal n_haplotypes")
    n_kept = n_haps if row_mask is None else int(row_mask.sum())
    s = len(site_map)
    s_pad = s if s_pad is None else s_pad
    n_pad = n_kept if n_pad is None else n_pad
    if s_pad < s or n_pad < n_kept:
        raise ValueError(f"padding smaller than data: {(s_pad, n_pad)} < "
                         f"{(s, n_kept)}")
    out = np.full((s_pad, n_pad), UNKNOWN, dtype=ALIGNMENT_DTYPE)
    i = 0
    for lineno, line in _iter_variant_lines(path):
        rec = _decode_record(path, lineno, line, chrom, pos_range)
        if rec is None:
            continue
        pos, row = rec
        if len(row) != n_haps:
            raise VcfError(
                f"{path}:{lineno}: inconsistent haplotype count "
                f"({len(row)} vs {n_haps})"
            )
        if i >= s or pos != site_map[i]:
            raise VcfError(f"{path}: file changed between ingest passes")
        rev = row[::-1]               # rot90 parity: reversed haplotypes
        out[i, :n_kept] = rev if row_mask is None else rev[row_mask]
        i += 1
    if i != s:
        raise VcfError(f"{path}: file changed between ingest passes")
    return out, site_map, n_kept
