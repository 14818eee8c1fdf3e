"""A masked FASTA configuration with ambiguity codes joins the benchmark by
files alone: a generator, a configuration, its CPU size, limits and a
per-layer metric written into a fresh root, and entries appended to its
``BENCHMARK.json``.  Its two cells, on the existing ``cli`` and
``session`` mixes, run the parts of the harness that the VCF cells never
reach: the site mask, a ``.fasta`` input to the CLI, the general kernel
class of the roofline's work, and the judging of ``prune`` and
``ld_decay`` over a masked site map."""

from __future__ import annotations

import json
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import weightedld_tpu_torch as wld
from ldbench.harness import loops, main, spec
from ldbench.reference import ld_ref
from ldbench.tests import faults, tiny
from weightedld_tpu_torch import cli
from weightedld_tpu_torch.core.sites import compute_variable_sites_host

NAME = "msa_iupac_test"
CLI, SESSION = f"{NAME}.cli", f"{NAME}.session"
HERE = Path(__file__).resolve().parent

# The deployment's sizes; the tiny file cuts the sequences for the CPU.
CONFIG = {
    "name": NAME,
    "source": "a test: HIV-1 pol genotypes over HXB2 2253-3554 (protease "
              "and RT codons 1-335), mixtures about 0.5 % of bases",
    "generator": "iupac_fasta",
    "format": "fasta",
    "n_seqs": 100000,
    "n_sites": 1302,
    "n_clades": 8,
    "variable_frac": 0.3,
    "clade_frac": 0.15,
    "within_frac": 0.03,
    "third_frac": 0.3,
    "mixture_frac": 0.005,
    "mixture_at_variable": 0.9,
    "n_frac": 0.1,
    "trim_max": 40,
    "lower_frac": 0.2,
    "line_width": 60,
    "mask": True,
    "min_acgt": 0.8,
    "min_variability": 0.02,
}
TINY = {"n_seqs": 160,
        "why": "160 sequences keep some hundreds of the 1,302 columns "
               "variable, each tile pair in the general class"}
# The session's gaps, set from this configuration's own readings on the CPU
# (the tiny size, 1 s windows): the program's largest over 12 seeds, r2
# 8.3e-7 and D' 5.2e-7 (high-LD pairs, r2 near 1: crit250's limits, set
# on its chance pairs of small r2, do not carry over); the program's int8
# weight mode's smallest over 3, 4.5e-6 and 2.7e-6; the bfloat16
# reference's, 5.7e-4 and 3.2e-4.  Each limit lies near
# lower^(1/3) upper^(2/3).  The counts, d_gap and sum_gap are crit250's.
SESSION_GAPS = {"r2_gap": 2.5e-6, "dp_gap": 1.5e-6}
METRIC = ("def read(run):\n"
          "    work = run.window.work\n"
          "    if not work.get('general'):\n"
          "        return None\n"
          "    total = sum(w['n_pairs'] for w in work.values())\n"
          "    return 100.0 * work['general']['n_pairs'] / total\n")


def add_config(root: Path) -> None:
    """The configuration's files under ``root/ldbench`` and its entries
    appended to ``root/BENCHMARK.json`` (the repository's where ``root``
    has none), as a change that adds a configuration writes them."""
    lb = root / "ldbench"
    for d in ("configs", "generators", "tiny", "limits", "metrics"):
        (lb / d).mkdir(parents=True, exist_ok=True)
    (lb / "configs" / f"{NAME}.json").write_text(json.dumps(CONFIG))
    shutil.copy(HERE / "iupac_fasta.py", lb / "generators" / "iupac_fasta.py")
    (lb / "tiny" / f"{NAME}.json").write_text(json.dumps(TINY))
    for traffic in ("cli", "session"):
        limits = json.loads((tiny.REPO / "ldbench" / "limits"
                             / f"crit250_vcf.{traffic}.json").read_text())
        if traffic == "session":
            limits.update(SESSION_GAPS)
        (lb / "limits" / f"{NAME}.{traffic}.json").write_text(
            json.dumps(limits))
    (lb / "metrics" / "general_pairs_pct.py").write_text(METRIC)
    src = root if (root / "BENCHMARK.json").is_file() else tiny.REPO
    bench = tiny.bench(src)
    bench["configs"].append({
        "name": NAME, "source": CONFIG["source"], "reduced": [],
        "file": f"ldbench/configs/{NAME}.json", "why": "a test"})
    for traffic in ("cli", "session"):
        bench["workloads"].append({
            "name": f"{NAME}.{traffic}", "config": NAME,
            "traffic": traffic, "chips": 1, "why": "a test"})
    wants = {"job_s": CLI, "query_s": SESSION, "query_p90_s": SESSION}
    for m in bench["end_to_end"]:
        if m["name"] in wants:
            m["workloads"].append(wants[m["name"]])
    bench["per_layer"].append({
        "name": "general_pairs_pct", "unit": "%", "better": "lower",
        "source": "program_counter", "layer": "kernels", "moves": "query_s",
        "workloads": [SESSION]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("root")
    add_config(tmp)
    return tiny.make_root(tmp)


@pytest.fixture(autouse=True)
def _temp_in_root(root, monkeypatch):
    """Every temporary file of a run, in this process or another, under
    the test's own directory."""
    tmp = root / "tmp"
    tmp.mkdir(exist_ok=True)
    monkeypatch.setenv("TMPDIR", str(tmp))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))


def _data(root, seed: int) -> tuple[dict, dict]:
    cell = spec.load_cell(root, SESSION)
    gen = spec.load_module(spec.find(root, "generators",
                                     cell.config["generator"], ".py"))
    return cell.config, gen.generate(cell.config, seed, "cpu")


def _ref_keep(config: dict, codes: np.ndarray) -> np.ndarray:
    _hk, ld = ld_ref.site_masks(torch.from_numpy(codes), config["min_acgt"],
                                config["min_variability"])
    return ld.numpy()


def test_the_cells_join_by_files_alone(root):
    assert tiny.configs(root) == [*tiny.configs(), NAME]
    assert tiny.cells("cli", root)[-1] == CLI
    assert tiny.cells("session", root)[-1] == SESSION
    cfg = json.loads((root / f"ldbench/configs/{NAME}.json").read_text())
    assert cfg["n_seqs"] == TINY["n_seqs"] and "why" not in cfg


@pytest.mark.parametrize("cell", (CLI, SESSION))
def test_cell_runs_correct(root, cell):
    rc, out, err = tiny.run_subprocess(root, cell, seed=2**31 + 17)
    assert rc == 0, err[-2000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = ({"job_s", "setup_s"} if cell == CLI
            else {"query_s", "query_p90_s", "setup_s"})
    assert set(res["metrics"]) == want


def test_traced_session_reads_the_general_class(root):
    rc, out, err = tiny.run_subprocess(root, SESSION, seed=19, trace=1)
    assert rc == 0, err[-2000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["general_pairs_pct"]["value"] > 50.0


def test_session_runs_the_general_kernel(root):
    config, data = _data(root, 5)
    mix = spec.load_cell(root, SESSION).traffic
    sess, _pos, _codes = loops.build_session(config, data, mix, "cpu")
    roofline = spec.load_module(spec.find(root, "metrics", "roofline",
                                          ".py"))
    work = roofline.session_work(sess, 5)
    assert work["general"]["n_pairs"] > 0
    assert work["general"]["n_sites"] == int(_ref_keep(config,
                                                       data["codes"]).sum())
    tiles = sess.phase_tiles
    assert tiles["general"] > tiles.get("majmin", 0)
    assert sum(w["n_pairs"] for w in work.values()) == (
        sess.n_sites * (sess.n_sites - 1) // 2)


def test_the_alignment_has_what_the_configuration_states(root):
    config, data = _data(root, 6)
    codes = data["codes"]
    assert set(np.unique(codes)) == {0, 1, 2, 3, 4, 5}
    assert abs((codes == 5).mean() - config["mixture_frac"]) < 0.002
    keep = _ref_keep(config, codes)
    # The mixtures sit mostly at the variable columns, which the mask keeps.
    assert (codes[:, keep] == 5).mean() > 2 * (codes[:, ~keep] == 5).mean()
    assert 100 < keep.sum() < len(keep)


@pytest.mark.parametrize("seed", (7, 8))
def test_harness_mask_is_the_programs(root, seed):
    """The reference's mask keeps the sites the program's own masks keep:
    the host one a FASTA job and the session take, and the device one."""
    config, data = _data(root, seed)
    codes = data["codes"]
    keep = _ref_keep(config, codes)
    _hk, host = compute_variable_sites_host(codes, config["min_acgt"],
                                            config["min_variability"])
    _hk, dev = wld.compute_variable_sites(codes, config["min_acgt"],
                                          config["min_variability"],
                                          device="cpu")
    assert (host == keep).all() and (dev.numpy() == keep).all()
    mix = spec.load_cell(root, SESSION).traffic
    _sess, pos, _codes = loops.build_session(config, data, mix, "cpu")
    assert np.array_equal(pos, data["positions"][keep])


def test_session_masks_as_the_reference_at_a_coverage_boundary(root):
    """A column covered by exactly 96 of 120 sequences: 0.8 > 0.8 is false
    in the reference's float64 and in the program's host mask, true in
    its device mask's float32.  The session keeps what the reference
    keeps."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 2, size=(120, 40)).astype(np.int8)
    codes[:24, 3] = 4
    data = {"codes": codes, "positions": np.arange(40, dtype=np.int64)}
    config = {"mask": True, "min_acgt": 0.8, "min_variability": 0.02}
    keep = _ref_keep(config, codes)
    assert not keep[3]
    mix = spec.load_cell(root, SESSION).traffic
    _sess, pos, _codes = loops.build_session(config, data, mix, "cpu")
    assert np.array_equal(pos, data["positions"][keep])


def test_general_work_counts_the_kept_planes(root, tmp_path):
    """Gaps only in a column the mask drops: the general class's least
    work counts the planes of the sites the session holds (A and C), not
    those of every column (A, C and the gap)."""
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 2, size=(120, 40)).astype(np.int8)
    codes[rng.random((120, 40)) < 0.02] = 5
    codes[:40, 5] = 4
    data = {"codes": codes, "positions": np.arange(40, dtype=np.int64)}
    config = {"mask": True, "min_acgt": 0.8, "min_variability": 0.02}
    assert not _ref_keep(config, codes)[5]
    roofline = spec.load_module(spec.find(root, "metrics", "roofline",
                                          ".py"))
    win, _state = loops.run_session(config, spec.load_cell(
        root, SESSION).traffic, data, str(tmp_path), "cpu", 0.1, False,
        roofline.session_work)
    assert "general" in win.work
    assert {w["planes"] for w in win.work.values()} == {2}


def test_cli_numbers_sites_by_column(root, tmp_path):
    """A FASTA job's site numbers are the generator's positions of the
    kept columns, as the reference numbers them."""
    config, data = _data(root, 9)
    path, out = tmp_path / "in.fasta", tmp_path / "out.tsv"
    data["write"](path)
    keep = _ref_keep(config, data["codes"])
    res = wld.prepare(path, device="cpu")
    assert np.array_equal(res.site_map, data["positions"][keep])
    assert np.array_equal(res.alignment, data["codes"][:, keep])
    assert cli.main(["--file", str(path), "--r2-threshold", "0.1",
                     "--pair-output", str(out), "--device", "cpu"]) == 0
    rec = main.parse_tsv(out.read_bytes())
    assert len(rec["pos_a"]) > 0
    kept = data["positions"][keep]
    assert np.isin(rec["pos_a"], kept).all()
    assert np.isin(rec["pos_b"], kept).all()


@pytest.mark.parametrize("cell", (CLI, SESSION))
@pytest.mark.parametrize("edit", (faults.r2_off, faults.dropped))
def test_altered_answer_is_caught(root, monkeypatch, cell, edit):
    faults.patch_records(monkeypatch, edit)
    rc, res = tiny.run_inprocess(root, cell, seed=21)
    assert rc == 0 and res["correct"] is False


@pytest.mark.parametrize("cell", (CLI, SESSION))
def test_half_the_work_left_out_is_caught(root, monkeypatch, cell):
    """The dense engine of a job over some hundreds of sites, and a
    session over a few tiles, which runs a single batch."""
    faults.drop_half(monkeypatch)
    rc, res = tiny.run_inprocess(root, cell, seed=22)
    assert rc == 0 and res["correct"] is False
