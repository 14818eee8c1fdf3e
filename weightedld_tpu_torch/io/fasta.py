"""FASTA ingestion (pure Python / numpy reader).

Copy of ``read_fasta`` / ``read_fasta_with_names`` and their helpers from
``weightedld_tpu/io/fasta.py:20-101`` (the native reader and the Rust-binary
framing are not ported).  BioPython / reference-Python semantics
(``WeightedLD.py:21-41``): a record is every line between one ``>`` header
and the next, concatenated; whitespace-only lines are skipped; gzip input
inflates transparently.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.encode import encode_alignment


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
    """``([n_seqs, n_sites] int8 codes, names)`` of a FASTA alignment."""
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
