"""A cell is added by files alone: a configuration, a traffic mix, a limits
file and a per-layer metric written into a fresh directory make a cell
that runs, with no edit to a file of the harness."""

from __future__ import annotations

import json

from ldbench.tests import tiny


def test_new_config_mix_and_metric_as_files(tmp_path):
    root = tiny.make_root(tmp_path)
    lb = root / "ldbench"
    cfg = json.loads((tiny.REPO / "ldbench/configs/crit250_vcf.json")
                     .read_text())
    cfg.update(tiny.tiny_size(tiny.REPO, "crit250_vcf"), name="cohort_small",
               n_sites=2200, major_frac=0.7)
    (lb / "configs" / "cohort_small.json").write_text(json.dumps(cfg))
    (lb / "traffic").mkdir()
    mix = json.loads((tiny.REPO / "ldbench/traffic/cli.json").read_text())
    mix["argv"] = [a if a != "0.1" else "0.15" for a in mix["argv"]]
    mix["threshold"] = 0.15
    (lb / "traffic" / "cli_strong.json").write_text(json.dumps(mix))
    (lb / "limits").mkdir()
    (lb / "limits" / "cohort_small.cli_strong.json").write_text(
        (tiny.REPO / "ldbench/limits/crit250_vcf.cli.json").read_text())
    (lb / "metrics").mkdir()
    (lb / "metrics" / "jobs_per_window.py").write_text(
        "def read(run):\n    return float(len(run.window.jobs))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "cohort_small", "source": "a test", "reduced": [],
        "file": "ldbench/configs/cohort_small.json", "why": "a test"})
    bench["workloads"].append({
        "name": "cohort_small.cli_strong", "config": "cohort_small",
        "traffic": "cli_strong", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "job_s":
            m["workloads"].append("cohort_small.cli_strong")
    bench["per_layer"].append({
        "name": "jobs_per_window", "unit": "jobs", "better": "higher",
        "source": "host_clock", "layer": "cli", "moves": "job_s",
        "workloads": ["cohort_small.cli_strong"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, out, err = tiny.run_subprocess(root, "cohort_small.cli_strong",
                                       trace=1)
    assert rc == 0, err[-2000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["jobs_per_window"]["value"] >= 1
    rc, out, err = tiny.run_subprocess(root, "cohort_small.cli_strong")
    res = json.loads(out.strip().splitlines()[-1])
    assert set(res["metrics"]) == {"job_s", "setup_s"}


def test_new_session_mix_as_a_file(tmp_path):
    """A session mix with a query kind the cell's mix does not ask for (an
    r2 histogram) and other arguments, added as one data file, runs and
    is judged."""
    root = tiny.make_root(tmp_path)
    lb = root / "ldbench"
    (lb / "traffic").mkdir()
    mix = json.loads((tiny.REPO / "ldbench/traffic/session.json")
                     .read_text())
    mix["cycle"] = [{"kind": "r2_histogram",
                     "edges": [0.0, 0.05, 0.1, 0.2, 1.0]},
                    {"kind": "stream", "r2_threshold": 0.2},
                    {"kind": "ld_decay", "edges": [0, 10, 100, 1000]},
                    {"kind": "top_pairs", "k": 10}]
    (lb / "traffic" / "session_hist.json").write_text(json.dumps(mix))
    (lb / "limits").mkdir()
    (lb / "limits" / "crit250_vcf.session_hist.json").write_text(
        (tiny.REPO / "ldbench/limits/crit250_vcf.session.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "crit250_vcf.session_hist", "config": "crit250_vcf",
        "traffic": "session_hist", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("query_s", "query_p90_s"):
            m["workloads"].append("crit250_vcf.session_hist")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, out, err = tiny.run_subprocess(root, "crit250_vcf.session_hist")
    assert rc == 0, err[-2000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"query_s", "query_p90_s", "setup_s"}
