"""Find a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic mix, its limits, its generator and the
readers of its per-layer metrics.

Every part is a file of its own, looked up first under the root's
``ldbench/`` (the checkout the benchmark runs in, or a directory a test
builds) and then beside this harness, so that a cell is added by adding
files and entries, never by editing one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent      # the ldbench directory


@dataclass
class Cell:
    name: str
    root: Path
    bench: dict
    workload: dict
    config_entry: dict
    config: dict
    traffic: dict
    limits: dict

    def metrics(self, section: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports:
        those whose ``workloads`` list names it, or that have none."""
        return [m for m in self.bench.get(section, [])
                if self.name in m.get("workloads", [self.name])]


def find(root: Path, kind: str, name: str, suffix: str) -> Path:
    for base in (root / "ldbench", HERE):
        p = base / kind / f"{name}{suffix}"
        if p.is_file():
            return p
    raise FileNotFoundError(f"no {kind}/{name}{suffix} under {root} or "
                            f"{HERE}")


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "ldbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, name: str) -> Cell:
    bench_path = root / "BENCHMARK.json"
    if not bench_path.is_file():
        raise FileNotFoundError(f"{bench_path} not found")
    bench = json.loads(bench_path.read_text())
    wl = [w for w in bench["workloads"] if w["name"] == name]
    if not wl:
        raise KeyError(f"no workload {name!r} in {bench_path}")
    wl = wl[0]
    ce = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
    config = json.loads((root / ce["file"]).read_text())
    traffic = json.loads(find(root, "traffic", wl["traffic"],
                              ".json").read_text())
    limits = json.loads(find(root, "limits", name, ".json").read_text())
    return Cell(name=name, root=root, bench=bench, workload=wl,
                config_entry=ce, config=config, traffic=traffic,
                limits=limits)
