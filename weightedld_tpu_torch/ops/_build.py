"""Build the CUDA sources under ``csrc/`` at first use, one shared library
per source, and load them with ``ctypes`` (a plain C interface: no PyTorch
headers, so a build takes seconds).

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, into ``weightedld_tpu_torch/build/`` under a name keyed by a hash
of the source, the shared headers (``*.cuh``) and the compiler flags, so an
edited source rebuilds and an unchanged one is reused.  The build reads
nothing outside the package except the CUDA toolkit (``nvcc`` and its
headers).  A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

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
# Entry point -> argument types.  ld_majmin_*: 12 pointers, 8 ints, the
# stream; ld_general*: 12 pointers, 10 ints, the stream; ld_decay_bins: 10
# pointers, 6 ints, the stream.
ENTRIES = {
    "ld_majmin_codes": [_P] * 12 + [_I] * 8 + [_P],
    "ld_majmin_planes": [_P] * 12 + [_I] * 8 + [_P],
    "ld_general": [_P] * 12 + [_I] * 10 + [_P],
    "ld_general_unit": [_P] * 12 + [_I] * 10 + [_P],
    "ld_decay_bins": [_P] * 10 + [_I] * 6 + [_P],
}


@dataclass
class BuildInfo:
    """What :func:`load_library` did: the library paths, the sources
    compiled in this process, the wall time of the (parallel) build and
    ptxas's report of each compiled source."""

    paths: list[Path] = field(default_factory=list)
    compiled: list[str] = field(default_factory=list)
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


def _targets() -> list[tuple[Path, Path]]:
    """``(source, library path)`` of every ``csrc/*.cu``."""
    headers = sorted(CSRC.glob("*.cuh"))
    out = []
    for src in sorted(CSRC.glob("*.cu")):
        h = hashlib.sha256(repr(NVCC_FLAGS).encode())
        for s in (src, *headers):
            h.update(s.name.encode())
            h.update(s.read_bytes())
        out.append((src, BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"))
    return out


def load_library() -> SimpleNamespace:
    """Build what is missing, load every library and return the entry
    points as attributes; cached per process."""
    global _lib
    if _lib is not None:
        return _lib
    targets = _targets()
    jobs = []
    t0 = time.monotonic()
    for src, out in targets:
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        jobs.append((src, out, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, out, tmp, cmd, proc in jobs:
        _stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            failed.append(f"nvcc failed (exit {proc.returncode}): "
                          f"{' '.join(cmd)}\n{stderr}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        build_info.compiled.append(src.name)
        build_info.ptxas += stderr
    if jobs:
        build_info.seconds = time.monotonic() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    fns = {}
    for _src, out in targets:
        lib = ctypes.CDLL(str(out))
        for name, argtypes in ENTRIES.items():
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
        build_info.paths.append(out)
    missing = set(ENTRIES) - set(fns)
    if missing:
        raise RuntimeError(f"entry points missing from {CSRC}: "
                           f"{sorted(missing)}")
    _lib = SimpleNamespace(**fns)
    return _lib
