"""ctypes bindings to the native ingest library built from ``native/wldio.cpp``.

Copy of ``weightedld_tpu/io/native.py``: ``_configure`` (``:36-68``), the
version check of ``load`` (``:71-101``), ``read_fasta_native``
(``:129-163``), ``read_vcf_native`` (``:166-199``), the two formatters
(``:206-247``) and ``transpose_pad_i8`` (``:250-266``).  The library is an
mmap-based OpenMP C++ parser that writes FASTA / VCF files straight into
int8 code matrices, a formatter with Python's ``repr(round(x, n))`` bytes,
and a blocked transpose into the padded site-major layout; its parsing
semantics and error messages are those of the Python readers in this
package, which stay the fallback and the parity oracle.

How the library is found: at first use this module compiles the
repository's ``native/wldio.cpp`` with the ``g++`` on ``PATH`` (not
``$CXX``, which may name a GCC without the OpenMP runtime) and the flags of
``native/Makefile``'s ``IOFLAGS``, linked with ``-lz``, into
``weightedld_tpu_torch/build/`` under a name keyed by a hash of the source
and the flags, so an edited source rebuilds.  The compile writes a
temporary file and renames it into place under a file lock, so concurrent
processes build it once.  It never loads
``native/libwldio.so``, which the JAX package's tests build and manage.

``WLD_NATIVE_IO=0`` forces the Python readers and formatters (read on
every call).  A failed build warns once (``RuntimeWarning``, with the first
lines of ``g++``'s stderr) and the Python path runs; :func:`build_error`
returns the reason.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import warnings
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parent.parent
SOURCE = PKG.parent / "native" / "wldio.cpp"
BUILD_DIR = PKG / "build"
VERSION = b"wldio-4"
CXX_FLAGS = ("-O3", "-funroll-loops", "-fopenmp", "-std=c++17", "-Wall",
             "-shared", "-fPIC")
LIBS = ("-lz",)

_ERR_CAP = 4096

_lib: ctypes.CDLL | None = None
_tried = False
_error: str | None = None


def _configure(lib: ctypes.CDLL) -> None:
    i64 = ctypes.c_int64
    p_i64 = ctypes.POINTER(i64)
    lib.wldio_version.restype = ctypes.c_char_p
    lib.wldio_fasta_open.restype = ctypes.c_void_p
    lib.wldio_fasta_open.argtypes = [
        ctypes.c_char_p, p_i64, p_i64, p_i64, ctypes.c_char_p, i64,
    ]
    lib.wldio_fasta_fill.restype = ctypes.c_int
    lib.wldio_fasta_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p,
    ]
    lib.wldio_fasta_close.argtypes = [ctypes.c_void_p]
    lib.wldio_vcf_open.restype = ctypes.c_void_p
    lib.wldio_vcf_open.argtypes = [
        ctypes.c_char_p, p_i64, p_i64, ctypes.c_char_p, i64,
    ]
    lib.wldio_vcf_fill.restype = ctypes.c_int
    lib.wldio_vcf_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, i64,
    ]
    lib.wldio_vcf_close.argtypes = [ctypes.c_void_p]
    lib.wldio_format_pairs.restype = i64
    lib.wldio_format_pairs.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, i64, ctypes.c_int, ctypes.c_void_p, i64,
    ]
    lib.wldio_format_weights.restype = i64
    lib.wldio_format_weights.argtypes = [
        ctypes.c_void_p, i64, ctypes.c_int, ctypes.c_void_p, i64,
    ]
    lib.wldio_transpose_pad_i8.restype = None
    lib.wldio_transpose_pad_i8.argtypes = [
        ctypes.c_void_p, i64, i64, ctypes.c_void_p, i64, i64, ctypes.c_int8,
    ]


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    h = hashlib.sha256(repr((CXX_FLAGS, LIBS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libwldio_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile the library unless it is there; raises ``RuntimeError``
    with ``g++``'s stderr on failure."""
    if not SOURCE.exists():
        raise RuntimeError(f"{SOURCE} not found")
    out = library_path()
    if out.exists():
        return out
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libwldio.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # one compile among processes
        if out.exists():
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = ["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE), *LIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            Path(tmp).unlink(missing_ok=True)
            raise RuntimeError(f"g++ could not run: {e}") from e
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            raise RuntimeError(proc.stderr.strip() or
                               f"g++ exited {proc.returncode}")
        os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL | None:
    """The native library, built and loaded once per process; None when
    ``WLD_NATIVE_IO=0`` or when it cannot be built (warned once)."""
    global _lib, _tried, _error
    if os.environ.get("WLD_NATIVE_IO", "1") == "0":
        return None
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(_build()))
        _configure(lib)
        version = lib.wldio_version()
        if version != VERSION:
            raise RuntimeError(f"version {version!r} != {VERSION!r}")
    except (RuntimeError, OSError, AttributeError) as e:
        _error = str(e)
        head = "\n".join(_error.splitlines()[:5])
        warnings.warn(
            f"native io library unavailable, using the Python readers and "
            f"formatters: {head}", RuntimeWarning, stacklevel=2)
        return None
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def build_error() -> str | None:
    """Why the library could not be built or loaded (None if it loaded or
    was not tried)."""
    return _error


def _check_readable(path) -> None:
    """Raise the OSError subclass the Python readers would (FileNotFound,
    IsADirectory, Permission) instead of the library's generic error."""
    with open(path, "rb"):
        pass


def read_fasta_native(path: str | Path) -> tuple[np.ndarray, list[str]]:
    """``([n_seqs, n_sites] int8 codes, names)``; raises ValueError with the
    Python reader's messages."""
    lib = load()
    assert lib is not None, "native io library not loaded"
    _check_readable(path)
    n_seqs = ctypes.c_int64()
    n_sites = ctypes.c_int64()
    names_len = ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERR_CAP)
    h = lib.wldio_fasta_open(
        str(path).encode(), ctypes.byref(n_seqs), ctypes.byref(n_sites),
        ctypes.byref(names_len), err, _ERR_CAP,
    )
    if not h:
        raise ValueError(err.value.decode("utf-8", "replace"))
    try:
        out = np.empty((n_seqs.value, n_sites.value), dtype=np.int8)
        names_buf = ctypes.create_string_buffer(max(1, names_len.value))
        lib.wldio_fasta_fill(
            h, out.ctypes.data_as(ctypes.c_void_p), names_buf,
        )
        raw = names_buf.raw[: names_len.value].decode("utf-8", "replace")
    finally:
        lib.wldio_fasta_close(h)
    if out.shape[1] == 0:
        # Header-only files: the Python reader's ingest error.
        raise ValueError(f"{path}: no sequences found")
    names = raw.split("\n") if raw else [""] * n_seqs.value
    if len(names) != n_seqs.value:  # all-empty names edge case
        names = (names + [""] * n_seqs.value)[: n_seqs.value]
    return out, names


def read_vcf_native(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """``([n_haplotypes, n_sites] int8, POS int64)`` with the Python
    reader's rot90 row reversal; raises ``VcfError`` with its messages."""
    from .vcf import VcfError  # lazy: vcf.py imports this module

    lib = load()
    assert lib is not None, "native io library not loaded"
    _check_readable(path)
    n_sites = ctypes.c_int64()
    n_haps = ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERR_CAP)
    h = lib.wldio_vcf_open(
        str(path).encode(), ctypes.byref(n_sites), ctypes.byref(n_haps),
        err, _ERR_CAP,
    )
    if not h:
        raise VcfError(err.value.decode("utf-8", "replace"))
    try:
        mat = np.empty((n_sites.value, n_haps.value), dtype=np.int8)
        positions = np.empty(n_sites.value, dtype=np.int64)
        rc = lib.wldio_vcf_fill(
            h,
            mat.ctypes.data_as(ctypes.c_void_p),
            positions.ctypes.data_as(ctypes.c_void_p),
            err, _ERR_CAP,
        )
        if rc != 0:
            raise VcfError(err.value.decode("utf-8", "replace"))
    finally:
        lib.wldio_vcf_close(h)
    # rot90 parity: haplotype rows in reverse order (WeightedLD.py:375).
    alignment = np.ascontiguousarray(mat.T[::-1])
    return alignment, positions


def _c64(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def format_pairs_native(pos_a, pos_b, d, d_prime, r2,
                        ndigits: int = 4) -> str:
    """Pair records as TSV rows, each cell ``repr(round(x, n))``
    (``WeightedLD.py:282-284``)."""
    lib = load()
    assert lib is not None, "native io library not loaded"
    pa = np.ascontiguousarray(pos_a, dtype=np.int64)
    pb = np.ascontiguousarray(pos_b, dtype=np.int64)
    dd = np.ascontiguousarray(d, dtype=np.float64)
    dp = np.ascontiguousarray(d_prime, dtype=np.float64)
    rr = np.ascontiguousarray(r2, dtype=np.float64)
    n = len(pa)
    cap = 128 * n + 16
    buf = np.empty(cap, dtype=np.uint8)
    written = lib.wldio_format_pairs(
        _c64(pa), _c64(pb), _c64(dd), _c64(dp), _c64(rr),
        n, ndigits, _c64(buf), cap,
    )
    if written < 0:
        raise ValueError(
            f"native pair formatting rejected the request (ndigits={ndigits})"
        )
    return buf[:written].tobytes().decode("ascii")


def format_weights_native(weights, ndigits: int = 6) -> str:
    """Per-sequence weights as ``index\\tweight`` TSV rows."""
    lib = load()
    assert lib is not None, "native io library not loaded"
    w = np.ascontiguousarray(weights, dtype=np.float64)
    n = len(w)
    cap = 64 * n + 16
    buf = np.empty(cap, dtype=np.uint8)
    written = lib.wldio_format_weights(_c64(w), n, ndigits, _c64(buf), cap)
    if written < 0:
        raise ValueError(
            f"native weights formatting rejected the request (ndigits={ndigits})"
        )
    return buf[:written].tobytes().decode("ascii")


def transpose_pad_i8(src: np.ndarray, s_pad: int, n_pad: int,
                     fill: int) -> np.ndarray:
    """``[N, S]`` int8 row-major -> ``[s_pad, n_pad]`` transposed and padded
    with ``fill`` (the upload layout), by the blocked OpenMP transpose.
    The caller checks :func:`available`; the numpy oracle is
    ``ops.cuda_ld.pad_alignment_site_major``'s small-input path."""
    lib = load()
    src = np.ascontiguousarray(src, dtype=np.int8)
    n, s = src.shape
    assert s_pad >= s and n_pad >= n
    dst = np.empty((s_pad, n_pad), dtype=np.int8)
    lib.wldio_transpose_pad_i8(
        _c64(src), ctypes.c_int64(n), ctypes.c_int64(s),
        _c64(dst), ctypes.c_int64(s_pad), ctypes.c_int64(n_pad),
        ctypes.c_int8(fill),
    )
    return dst
