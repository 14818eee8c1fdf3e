"""Build the CUDA sources under ``csrc/`` into one shared library, at first
use, and load it with ``ctypes`` (a plain C interface: no PyTorch headers,
so the build takes seconds).

The library lands in ``weightedld_tpu_torch/build/`` under a name keyed by a
hash of the sources and the compiler flags, so an edited source rebuilds
and an unchanged one is reused.  The build reads nothing outside the
package except the CUDA toolkit (``nvcc`` and its headers).  A failed
build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"

# -fmad=false: no FMA contraction (the f32 combine and the pair algebra must
# round like the JAX reference); no --use_fast_math: IEEE division.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# ld_majmin_codes / ld_majmin_planes: 12 pointers, 8 ints, the stream.
_MAJMIN_ARGTYPES = [_P] * 12 + [_I] * 8 + [_P]


@dataclass
class BuildInfo:
    """What :func:`load_library` did: the library path, whether it was
    compiled in this process, the compile time and ptxas's report."""

    path: Path | None = None
    compiled: bool = False
    seconds: float = 0.0
    ptxas: str = ""


build_info = BuildInfo()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of weightedld_tpu_torch are built from source at first use")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = _sources()
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libwld_kernels_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *[str(s) for s in srcs if s.suffix == ".cu"]]
        t0 = time.monotonic()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_info.seconds = time.monotonic() - t0
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        build_info.compiled = True
        build_info.ptxas = proc.stderr
    lib = ctypes.CDLL(str(out))
    for name in ("ld_majmin_codes", "ld_majmin_planes"):
        fn = getattr(lib, name)
        fn.argtypes = _MAJMIN_ARGTYPES
        fn.restype = ctypes.c_int
    build_info.path = out
    _lib = lib
    return lib
