"""A root with the benchmark's cells at a tiny size, for the CPU tests: the
repository's ``BENCHMARK.json`` with each configuration file replaced by a
copy whose sizes are cut (S stays above 2,048, where the CLI runs the
tiled session and its kernels' plain versions)."""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = {
    # 120 sequences: independent sites leave some hundreds of chance pairs
    # above r2 0.1 among 2,100 sites.
    "crit250_vcf": {"n_seqs": 120, "n_sites": 2100},
}


def make_root(tmp: Path) -> Path:
    """``tmp`` holding ``BENCHMARK.json`` and tiny copies of the
    configurations under ``ldbench/configs``; every other part is found
    beside the harness."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg.update(TINY[c["name"]])
        dst = tmp / c["file"]
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run_subprocess(root: Path, cell: str, seed: int = 7,
                   seconds: float = 1.0, trace: int = 0,
                   extra=()) -> tuple[int, str, str]:
    """One run in a fresh interpreter: ``(exit code, stdout, stderr)``."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "ldbench" / "run.py"), "--workload",
         cell, "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace), "--root", str(root), "--device", "cpu", *extra],
        capture_output=True, text=True, timeout=600, cwd=str(root),
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    return proc.returncode, proc.stdout, proc.stderr


def run_inprocess(root: Path, cell: str, seed: int = 7,
                  seconds: float = 0.5, trace: int = 0) -> tuple[int, dict]:
    """One run in this process (for tests that patch the program):
    ``(exit code, result line)``."""
    from ldbench.harness.main import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace), "--root", str(root),
                   "--device", "cpu"])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else {})
