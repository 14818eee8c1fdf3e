"""FASTA ingestion: the native reader, the Python reader, and the two-pass
streaming reader into the padded site-major layout.

Copy of ``read_fasta_with_names`` (the native dispatch of
``weightedld_tpu/io/fasta.py:20-35``), ``read_fasta_with_names_python``,
``read_fasta``, ``iter_fasta_rows``, ``scan_fasta`` (``:185-254``) and
``read_fasta_site_major`` (``:256-314``) with sample subsetting, their
helpers (``:38-101``), and the Rust binary's line framing,
``read_fasta_rust`` and ``read_fasta_rust_with_names`` (``:104-158``).
BioPython / reference-Python semantics
(``WeightedLD.py:21-41``): a record is every line between one ``>`` header
and the next, concatenated; whitespace-only lines are skipped; gzip input
inflates transparently.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.encode import (
    ALIGNMENT_DTYPE,
    UNKNOWN,
    encode_alignment,
    encode_sequence_bytes,
)


def _open_maybe_gzip(path: str | Path):
    """Binary handle; transparently inflates gzip inputs (magic 1f 8b)."""
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        import gzip

        return gzip.open(path, "rb")
    return open(path, "rb")


def _iter_fasta_raw(path: str | Path):
    """Yield ``(name, raw_bytes)`` per record, one record resident at a time."""
    name = None
    current: list[bytes] = []
    with _open_maybe_gzip(path) as fh:
        for raw_line in fh:
            line = raw_line.strip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(current)
                    current.clear()
                name = line[1:].decode("utf-8", "replace").strip()
            else:
                if name is None:
                    raise ValueError(
                        f"{path}: sequence data before first '>' header")
                current.append(line)
    if name is not None:
        yield name, b"".join(current)


def read_fasta_with_names(path: str | Path) -> tuple[np.ndarray, list[str]]:
    """``([n_seqs, n_sites] int8 codes, names)`` of a FASTA alignment: the
    native mmap / OpenMP reader (``io/native.py``) when it is built, with
    the same semantics and error messages, else
    :func:`read_fasta_with_names_python` (``WLD_NATIVE_IO=0`` forces it)."""
    from . import native

    if native.available():
        return native.read_fasta_native(path)
    return read_fasta_with_names_python(path)


def read_fasta_with_names_python(
    path: str | Path,
) -> tuple[np.ndarray, list[str]]:
    """The Python reader, fallback and parity oracle of
    :func:`read_fasta_with_names`."""
    names: list[str] = []
    rows: list[bytes] = []
    for name, raw in _iter_fasta_raw(path):
        names.append(name)
        rows.append(raw)
    if not rows or not any(rows):
        raise ValueError(f"{path}: no sequences found")
    return encode_alignment(rows), names


def read_fasta(path: str | Path) -> np.ndarray:
    """Like :func:`read_fasta_with_names`, codes only."""
    return read_fasta_with_names(path)[0]


# The Rust binary's per-character map (lib.rs:53-63): both cases of acgt
# and '-' are known; everything else, '\n' and '\r' included (its line
# reader never strips them), is Unknown.
_RUST_LUT = np.full(256, UNKNOWN, dtype=np.int8)
for _ch, _code in (("a", 0), ("c", 1), ("g", 2), ("t", 3), ("-", 4)):
    _RUST_LUT[ord(_ch)] = _code
    _RUST_LUT[ord(_ch.upper())] = _code


def read_fasta_rust(path: str | Path) -> np.ndarray:
    """The reference Rust binary's FASTA semantics (``lib.rs:277-307``),
    the ``--fasta-reader rust`` / ``--compat rust`` ingest:

    * every non-``>`` line is its own sequence (wrapped records are not
      concatenated);
    * the line terminator is kept and maps to Unknown, so every row ends in
      an Unknown column (monomorphic, dropped by the masks);
    * unequal row lengths abort (``lib.rs:180``) as ``ValueError``: a last
      line without a newline, or wrapped records;
    * a blank line is a row of length 1.
    """
    return read_fasta_rust_with_names(path)[0]


def read_fasta_rust_with_names(
        path: str | Path) -> tuple[np.ndarray, list[str]]:
    """:func:`read_fasta_rust` and the per-row names: each line takes the
    latest ``>`` header's name (``lib.rs:287-304``); lines before any
    header get an empty name."""
    rows: list[np.ndarray] = []
    names: list[str] = []
    name = ""
    with _open_maybe_gzip(path) as fh:
        for raw_line in fh:
            if raw_line.startswith(b">"):
                name = raw_line[1:].decode("utf-8", "replace").strip()
                continue
            rows.append(_RUST_LUT[np.frombuffer(raw_line, dtype=np.uint8)])
            names.append(name)
    if not rows:
        raise ValueError(f"{path}: no sequences found")
    n_sites = len(rows[0])
    for i, r in enumerate(rows):
        if len(r) != n_sites:
            raise ValueError(
                f"{path}: sequence {i} has {len(r)} symbols, expected "
                f"{n_sites} (the Rust reader does not concatenate wrapped "
                "FASTA lines and keeps line terminators; lib.rs:180)")
    return np.stack(rows, axis=0), names


def iter_fasta_rows(path: str | Path):
    """``(record_index, encoded int8 row)`` per record, one record resident
    at a time; a header with no sequence lines gives a length-0 row."""
    for idx, (_name, raw) in enumerate(_iter_fasta_raw(path)):
        yield idx, encode_sequence_bytes(raw)


def scan_fasta(path: str | Path, block_rows: int = 1024,
               keep_samples: tuple[str, ...] | None = None,
               exclude_samples: tuple[str, ...] | None = None,
               ) -> tuple[int, int, np.ndarray, np.ndarray | None]:
    """Pass 1 of the two-pass FASTA ingest: ``(n_seqs, n_sites, counts
    [S, 5], row_mask)``, the per-site histograms over codes 0..4, without
    the ``[N, S]`` matrix (peak memory: one ``[block_rows, S]`` row block).
    Rectangularity is checked over every record with the batch reader's
    wording; pass 2 re-validates every record.

    ``keep_samples`` / ``exclude_samples`` subset by record name during
    this pass: skipped records count in neither ``n_seqs`` nor ``counts``
    (subset before the masks, as the pipeline does); unknown names and
    fewer than 2 survivors are errors; ``row_mask`` (bool per record, None
    without subsetting) drives pass 2."""
    from ..core.sites import site_histogram_host

    subsetting = keep_samples is not None or exclude_samples is not None
    ks = set(keep_samples) if keep_samples is not None else None
    es = set(exclude_samples) if exclude_samples is not None else None
    names: list[str] = []
    n_sites = None
    n_seqs = 0
    counts = None
    block: list[np.ndarray] = []

    def flush():
        nonlocal counts
        if block:
            h = site_histogram_host(np.stack(block, axis=0)).astype(np.int64)
            counts = h if counts is None else counts + h
            block.clear()

    for idx, (name, raw) in enumerate(_iter_fasta_raw(path)):
        row = encode_sequence_bytes(raw)
        if n_sites is None:
            n_sites = len(row)
        elif len(row) != n_sites:
            raise ValueError(
                f"ragged alignment: sequence {idx} has length {len(row)}, "
                f"expected {n_sites}"
            )
        if subsetting:
            names.append(name)
            if (ks is not None and name not in ks) \
                    or (es is not None and name in es):
                continue
        n_seqs += 1
        block.append(row)
        if len(block) >= block_rows:
            flush()
    flush()
    row_mask = None
    if subsetting and names:
        # The pipeline's validation, and a mask equal to the per-record
        # decisions above.
        from ..pipeline import _sample_row_mask

        row_mask = _sample_row_mask(names, keep_samples, exclude_samples)
    if (n_sites or 0) == 0 or (not subsetting and n_seqs == 0):
        raise ValueError(f"{path}: no sequences found")
    return n_seqs, n_sites, counts, row_mask


def read_fasta_site_major(
    path: str | Path,
    ld_mask: np.ndarray,
    scan: tuple[int, int],
    s_pad: int | None = None,
    n_pad: int | None = None,
    row_mask: np.ndarray | None = None,
) -> np.ndarray:
    """Pass 2: decode each record into its COLUMN of a padded site-major
    buffer of the LD-kept sites, ``codes[s, k] == trimmed_alignment[k, s]``
    with UNKNOWN padding.  ``scan`` is pass 1's ``(n_seqs, n_sites)`` (with
    ``row_mask``, n_seqs counts the kept records, which are the only ones
    decoded); a record that disagrees with it raises "file changed between
    ingest passes"."""
    ld_mask = np.asarray(ld_mask, dtype=bool)
    n_seqs, n_sites = scan
    if len(ld_mask) != n_sites:
        raise ValueError("ld_mask length must equal the scanned n_sites")
    s_kept = int(ld_mask.sum())
    s_pad = s_kept if s_pad is None else s_pad
    n_pad = n_seqs if n_pad is None else n_pad
    if s_pad < s_kept or n_pad < n_seqs:
        raise ValueError(f"padding smaller than data: {(s_pad, n_pad)} < "
                         f"{(s_kept, n_seqs)}")
    out = np.full((s_pad, n_pad), UNKNOWN, dtype=ALIGNMENT_DTYPE)
    # Rows land in a [B, s_kept] block that is transposed into the buffer
    # once per block: a per-row strided column write is about 2x slower.
    block_rows = 256
    block = np.empty((block_rows, s_kept), dtype=ALIGNMENT_DTYPE)
    k = 0
    b = 0
    full_keep = bool(ld_mask.all())
    for idx, row in iter_fasta_rows(path):
        if row_mask is not None and (idx >= len(row_mask)
                                     or not row_mask[idx]):
            if idx >= len(row_mask) or len(row) != n_sites:
                raise ValueError(
                    f"{path}: file changed between ingest passes")
            continue
        if len(row) != n_sites or k + b >= n_seqs:
            raise ValueError(f"{path}: file changed between ingest passes")
        block[b] = row if full_keep else row[ld_mask]
        b += 1
        if b == block_rows:
            out[:s_kept, k:k + b] = block.T
            k += b
            b = 0
    if b:
        out[:s_kept, k:k + b] = block[:b].T
        k += b
    if k != n_seqs:
        raise ValueError(f"{path}: file changed between ingest passes")
    return out
