"""A root with the benchmark's cells at a tiny size, for the CPU tests: the
repository's ``BENCHMARK.json`` with each configuration file replaced by a
copy whose sizes are cut to its ``tiny/<config>.json``.

Every part a test reads is declared in files: the cells in
``BENCHMARK.json``, each configuration's CPU size in ``tiny/``, so that a
configuration and its cells join the tests by adding files and appending
entries.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

from ldbench.harness import spec

REPO = Path(__file__).resolve().parents[2]


def bench(root: Path = REPO) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def configs(root: Path = REPO) -> list[str]:
    return [c["name"] for c in bench(root)["configs"]]


def cells(loop: str | None = None, root: Path = REPO) -> list[str]:
    """The names of ``root``'s cells, those whose traffic runs ``loop``
    (``"cli"`` or ``"session"``) where it is given."""
    out = []
    for w in bench(root)["workloads"]:
        mix = json.loads(spec.find(root, "traffic", w["traffic"],
                                   ".json").read_text())
        if loop is None or mix["loop"] == loop:
            out.append(w["name"])
    return out


def device_only(root: Path = REPO) -> set[str]:
    """The metrics read from the device trace: a CPU run reports none."""
    b = bench(root)
    return {m["name"] for m in b["end_to_end"] + b["per_layer"]
            if m["source"] == "device_trace"}


def tiny_size(root: Path, config: str) -> dict:
    """The keys ``tiny/<config>.json`` cuts (its ``why`` left out)."""
    try:
        path = spec.find(root, "tiny", config, ".json")
    except FileNotFoundError as e:
        raise FileNotFoundError(
            f"configuration {config!r} has no CPU size: add "
            f"ldbench/tiny/{config}.json ({e})") from None
    return {k: v for k, v in json.loads(path.read_text()).items()
            if k != "why"}


def make_root(tmp: Path) -> Path:
    """``tmp`` completed into a root: its ``BENCHMARK.json`` (the
    repository's where it has none) and a tiny copy of each configuration
    file, read from ``tmp`` where it holds one and from the repository
    otherwise.  Every other part is found under ``tmp/ldbench`` first,
    then beside the harness."""
    b = bench(tmp if (tmp / "BENCHMARK.json").is_file() else REPO)
    for c in b["configs"]:
        src = tmp / c["file"]
        cfg = json.loads((src if src.is_file() else REPO / c["file"])
                         .read_text())
        cfg.update(tiny_size(tmp, c["name"]))
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(b))
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
