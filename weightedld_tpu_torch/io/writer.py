"""TSV output writers (pair records and per-sequence weights).

Copy of ``pair_header``, ``open_text_output``, ``_fmt``, ``write_pairs``
(TSV layout) and ``write_weights`` from ``weightedld_tpu/io/writer.py:
44-101, 183-268``.  The Python reference prints ``posa posb D D' R2``
tab-separated with ``round(x, 4)`` formatting (``WeightedLD.py:176,
282-284``); the weights TSV is the Rust reference's ``index weight`` dump
(``main.rs:70-80``).  Both use the native formatter (``io/native.py``, the
same bytes) when it is built and ``0 <= ndigits <= 100``, else the Python
one.  The PLINK layout is not ported.
"""

from __future__ import annotations

import io
import sys
from typing import IO

import numpy as np

from ..core.ld_dense import LdRecords

PAIR_HEADER = "posa\tposb\tD\tD'\tR2"


def pair_header() -> str:
    return PAIR_HEADER


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


def _fmt(x: float, ndigits: int) -> str:
    # Python's print(round(x, 4)) semantics: shortest float repr.
    return repr(round(float(x), ndigits))


def write_pairs(records: LdRecords, out: IO[str] | None = None,
                ndigits: int = 4, header: bool = True) -> None:
    out = out if out is not None else sys.stdout
    if header:
        out.write(pair_header() + "\n")
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
