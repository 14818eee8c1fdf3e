"""Multi-sample VCF ingestion (pure Python / numpy reader).

Copy of ``read_vcf`` / ``read_vcf_python`` and their helpers from
``weightedld_tpu/io/vcf.py:118-260, 360-405, 524-560`` (the native
``libwldio`` reader is not ported).  Semantics (reference
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

from ..core.encode import ALIGNMENT_DTYPE, GAP
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
    int8, site_map [n_sites] int64 POS)`` — :func:`read_vcf_python`."""
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
