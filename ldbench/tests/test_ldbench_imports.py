"""The import boundary: nothing under ``ldbench/`` imports JAX, the JAX
package or the old harness scripts (top-level names compared whole:
``weightedld_tpu_torch`` begins with ``weightedld_tpu``), the reference
imports nothing of the program, and a directory holding only the
benchmark's files cannot run."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

from ldbench.harness.main import FORBIDDEN, forbidden_modules
from ldbench.tests import tiny

LDBENCH = tiny.REPO / "ldbench"


def _imports(path: Path) -> set[str]:
    """Top-level names of every import in ``path`` (relative imports
    excluded: they stay inside ``ldbench``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
    return out


def test_no_source_imports_jax_or_the_old_harness():
    for path in LDBENCH.rglob("*.py"):
        bad = _imports(path) & set(FORBIDDEN)
        assert not bad, f"{path}: {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in (LDBENCH / "reference").rglob("*.py"):
        assert "weightedld_tpu_torch" not in _imports(path), path
        assert _imports(path) <= {"__future__", "dataclasses", "numpy",
                                  "torch"}, path


def test_module_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "weightedld_tpu_torch_x", sys)
    assert "weightedld_tpu_torch_x" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert forbidden_modules() == ["jax.numpy"]


def test_run_loads_no_forbidden_module(tmp_path):
    """A whole run in a fresh interpreter, then its own check of
    ``sys.modules`` after the window: the run exits 0 only when it found
    nothing (the result line says so by being printed)."""
    root = tiny.make_root(tmp_path)
    rc, out, err = tiny.run_subprocess(root, "crit250_vcf.session", seed=9)
    assert rc == 0, err[-2000:]
    assert out.strip().splitlines()[-1].startswith("{")


def test_benchmark_files_alone_cannot_run(tmp_path):
    """Only ``BENCHMARK.json`` and the files under ``paths``: the program
    is missing, so the run exits nonzero and prints no result."""
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(LDBENCH, tmp_path / "ldbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "ldbench/run.py", "--workload", "crit250_vcf.cli",
         "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_module_loaded_after_the_window_withholds_the_result(tmp_path):
    """A per-layer reader, loaded after the window closed, that brings in a
    module named ``jax``: the run checks ``sys.modules`` again just before
    it prints, so it exits nonzero, prints no result and names the
    module."""
    root = tiny.make_root(tmp_path)
    (root / "ldbench" / "metrics").mkdir(parents=True)
    (root / "ldbench" / "metrics" / "loads_jax.py").write_text(
        "import sys\nimport types\n\n\ndef read(run):\n"
        "    sys.modules['jax'] = types.ModuleType('jax')\n"
        "    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "loads_jax", "unit": "s", "better": "lower",
        "source": "host_clock", "layer": "cli", "moves": "job_s",
        "workloads": ["crit250_vcf.cli"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, out, err = tiny.run_subprocess(root, "crit250_vcf.cli", trace=1)
    assert rc != 0
    assert out.strip() == ""
    assert "'jax'" in err
