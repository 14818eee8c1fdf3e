"""Each cell end to end at a tiny size on the CPU (the kernels' plain
versions), in a fresh interpreter, as the benchmark command runs."""

from __future__ import annotations

import json

import numpy as np
import pytest

from ldbench.harness import spec
from ldbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("root"))


def _cell_metrics(section: str, cell: str) -> set:
    return {m["name"] for m in tiny.bench()[section]
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", tiny.cells())
def test_cell_runs_correct_with_the_contract_keys(root, cell):
    rc, out, err = tiny.run_subprocess(root, cell, seed=2**31 + 11,
                                       seconds=1.0)
    assert rc == 0, err[-2000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == _cell_metrics("end_to_end", cell)
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    # The numbers compared close standard error, each beside its limit.
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") and "limit" in line
               for line in tail)


@pytest.mark.parametrize("cell", tiny.cells())
def test_traced_run_reads_its_layers(root, cell):
    rc, out, err = tiny.run_subprocess(root, cell, seed=5, seconds=1.0,
                                       trace=1)
    assert rc == 0, err[-2000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks" and "breakdown" in res
    want = _cell_metrics("per_layer", cell)
    # On the CPU no reader of the device finds anything to read, and none
    # reports a number for it.
    device_only = tiny.device_only()
    got = set(res["metrics"])
    assert not got & device_only
    if cell in tiny.cells("cli"):
        assert got == want - device_only
    else:
        # A query kind that the short window did not reach has no mean.
        assert got <= want - device_only and got


def _generate(root, config: str, seed: int) -> dict:
    entry = [c for c in tiny.bench(root)["configs"] if c["name"] == config][0]
    cfg = json.loads((root / entry["file"]).read_text())
    gen = spec.load_module(spec.find(root, "generators", cfg["generator"],
                                     ".py"))
    return gen.generate(cfg, seed, "cpu")


@pytest.mark.parametrize("config", tiny.configs())
def test_seed_fixes_the_inputs(root, config):
    a = _generate(root, config, 2**31 + 5)
    b = _generate(root, config, 2**31 + 5)
    c = _generate(root, config, 2**31 + 6)
    assert (a["codes"] == b["codes"]).all()
    assert (a["positions"] == b["positions"]).all()
    assert (a["codes"] != c["codes"]).any()


def test_criterion_sites_keep_the_bench_proportions(root):
    # The criterion bench's cells: major, minor or missing, about 60 / 30 /
    # 10 %.
    a = _generate(root, "crit250_vcf", 2**31 + 5)
    assert set(np.unique(a["codes"])) == {0, 1, 4}
    assert abs((a["codes"] == 4).mean() - 0.1) < 0.01


def test_no_card_exits_nonzero_without_a_result(root):
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, str(tiny.REPO / "ldbench" / "run.py"), "--workload",
         "crit250_vcf.cli", "--seed", "1", "--seconds", "1", "--trace", "0",
         "--root", str(root)], capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_the_card(root):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rc, out, err = tiny.run_subprocess(root, "crit250_vcf.session", seed=3,
                                       seconds=1.0, extra=("--device",
                                                           "cuda"))
    assert rc == 0, err[-2000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
