"""``bench_torch.py``, the port's benchmark, on the CPU (``--device cpu``,
the kernels' plain versions, tiny sizes).

* The default interleaved run at ``WLD_BENCH_S=256``,
  ``WLD_BENCH_REPS=2``, with ``tests/test_bench.py``'s JSON assertions
  against ``bench.py``, plus the ``device`` block and the sessions'
  entries (the other three smoke runs, ``--pod``, are in
  ``test_torch_bench_pod.py``).
* The three input generators bit-equal to ``bench.py``'s for the same
  seeds (``bench.py`` loaded by path: its top level imports only numpy).
* On the loaded and heavy inputs at S = 256, the records of the bench's
  CPU session equal the JAX ``LdSession``'s (``engine="xla"``, as
  ``bench.py`` runs off a TPU) but pairs within 1e-6 of r2 = 0.1, values
  at rtol 2e-5 / atol 1e-6 (two kernel families, ROADMAP's port notes).
* ``import bench_torch`` in a fresh interpreter loads neither ``jax``,
  ``weightedld_tpu`` nor ``bench.py``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
from weightedld_tpu.core.henikoff import henikoff_weights as jax_henikoff
from weightedld_tpu.parallel.sharded import default_mesh
from weightedld_tpu.runtime.driver import DriverConfig as JaxConfig
from weightedld_tpu.runtime.driver import LdSession as JaxSession

REPO = Path(__file__).resolve().parents[1]
SCRIPT = str(REPO / "bench_torch.py")
RTOL, ATOL, TIE = 2e-5, 1e-6, 1e-6


def _spec_bench():
    spec = importlib.util.spec_from_file_location("bench_jax_twin",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BENCH = _spec_bench()


def _env(**extra) -> dict:
    env = dict(os.environ)
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        env.pop(k, None)
    env.update(extra)
    return env


def _run(args: list[str], timeout: int, **env) -> tuple[int, str, dict]:
    """``(exit code, output, the last line's JSON or None)`` of
    ``bench_torch.py args`` in a subprocess."""
    res = subprocess.run(
        [sys.executable, "-u", SCRIPT, *args], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=_env(**env),
        timeout=timeout, cwd=REPO)
    lines = res.stdout.strip().splitlines()
    payload = (json.loads(lines[-1]) if res.returncode == 0 and lines
               and lines[-1].startswith("{") else None)
    return res.returncode, res.stdout, payload


CPU_DEVICE = {"name": "cpu", "power_limit": None, "count": 1}


def test_bench_torch_default_interleaved_smoke():
    """The default run prints bench.py's comparable JSON: floor / loaded /
    heavy blocks each with a min/median/max spread and a same-round probe
    ratio, plus the device block and each session's kernel entry."""
    rc, out, payload = _run(["--device", "cpu"], 300, WLD_BENCH_S="256",
                            WLD_BENCH_REPS="2")
    assert rc == 0, out[-3000:]
    assert payload["metric"] == "weighted_ld_site_pairs_per_s_per_chip"
    assert payload["value"] > 0
    assert payload["value"] == payload["floor"]["pairs_per_s"]["max"]
    for block in ("floor", "loaded", "heavy"):
        spread_key = ("pairs_per_s" if block != "heavy"
                      else "stream_pairs_per_s")
        for key in (spread_key, "probe_ratio"):
            st = payload[block][key]
            assert st["min"] <= st["median"] <= st["max"], (block, key)
            assert st["n"] == 2
    assert payload["loaded"]["records_per_scan"] > 0
    own = payload["loaded"]["stream_vs_own_summarize"]
    assert own["min"] <= own["median"] <= own["max"] and own["n"] == 2
    assert payload["heavy"]["records_per_scan"] > 0
    assert payload["heavy"]["stream_vs_summarize_ratio"]["median"] > 0
    assert payload["heavy"]["config"]["decimals"] == 4
    assert payload["probe"]["pairs_per_s"]["min"] > 0
    assert payload["device"] == CPU_DEVICE
    cfg = payload["config"]
    assert cfg["n_sites"] == 256 and cfg["host_cores"] == os.cpu_count()
    for name in ("floor", "loaded", "heavy"):
        sess = cfg["sessions"][name]
        assert sess["entries"] == ["ld_majmin_codes"], name
        assert sess["weights"] == "int8x3" and sess["tile"] == 256
        assert sess["launches"] == {}       # plain versions count nothing
    if cfg["baseline"] != "unavailable":
        assert payload["vs_baseline"] > 0
        assert cfg["cpu_baseline_pairs_per_s"] > 0
        assert bench_torch.baseline_path().exists()


GENERATORS = (
    ("synthetic_alignment", lambda m: m.synthetic_alignment(
        np.random.default_rng(42), 1000, 256)),
    ("synthetic_alignment", lambda m: m.synthetic_alignment(
        np.random.default_rng(3), 37, 101)),
    ("structured_alignment", lambda m: m.structured_alignment(
        np.random.default_rng(7), 1000, 256, 16)),
    ("structured_alignment", lambda m: m.structured_alignment(
        np.random.default_rng(11), 50, 300, 40)),
    ("_heavy_alignment", lambda m: m._heavy_alignment(100, 256, 12)),
    ("_heavy_alignment", lambda m: m._heavy_alignment(250, 2048, 250)),
)


@pytest.mark.parametrize("case", range(len(GENERATORS)))
def test_generators_equal_bench_py(case):
    _name, make = GENERATORS[case]
    got, want = make(bench_torch), make(BENCH)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def _records(stream) -> dict:
    out = {}
    for _b, rec in stream:
        for a, b, d, dp, r2 in zip(*(np.asarray(getattr(rec, k)) for k in (
                "pos_a", "pos_b", "d", "d_prime", "r2"))):
            out[int(a), int(b)] = (float(d), float(dp), float(r2))
    return out


@pytest.mark.parametrize("cell", ("loaded", "heavy"))
def test_bench_session_records_equal_jax(cell):
    """The bench's session on the CPU (the kernels' plain versions, the
    port's device Henikoff weights) against bench.py's off-TPU session (the
    JAX XLA engine, JAX's device weights) on the same input."""
    n_sites = 256
    if cell == "loaded":
        aln = bench_torch.structured_alignment(
            np.random.default_rng(7), bench_torch.N_SEQS, n_sites,
            max(8, n_sites // 16))
    else:
        aln = bench_torch._heavy_alignment(100, n_sites, max(8, n_sites // 20))
    got = _records(bench_torch.session(aln, torch.device("cpu")).stream())
    jsess = JaxSession(
        aln, np.asarray(jax_henikoff(jnp.asarray(aln))), np.arange(n_sites),
        JaxConfig(r2_threshold=bench_torch.R2_THRESHOLD, engine="xla"),
        mesh=default_mesh(jax.devices()[:1]))
    want = _records(jsess.stream())

    def off_tie(recs):
        return {k: v for k, v in recs.items()
                if abs(v[2] - bench_torch.R2_THRESHOLD) > TIE}

    got, want = off_tie(got), off_tie(want)
    assert len(want) > (20 if cell == "loaded" else 200)
    assert sorted(got) == sorted(want)
    keys = sorted(want)
    np.testing.assert_allclose(np.array([got[k] for k in keys]),
                               np.array([want[k] for k in keys]),
                               rtol=RTOL, atol=ATOL)


ENTRY_CASES = {
    "codes": (dict(), False, ["ld_majmin_codes"], "int8x3"),
    "planes": (dict(preplaned="on"), False, ["ld_majmin_planes"], "int8x3"),
    "lo_int8": (dict(weight_quant="lo_int8"), False,
                ["ld_majmin_codes_lo_int8"], "lo_int8"),
    "general": (dict(kernel="general"), False, ["ld_general"], "int8x3"),
    "general-unit": (dict(kernel="general"), True, ["ld_general_unit"],
                     "unit"),
    "general-planes": (dict(kernel="general", preplaned="on"), False,
                       ["ld_general_planes"], "int8x3"),
}


@pytest.mark.parametrize("case", sorted(ENTRY_CASES))
def test_entries_name_each_phase_kernel(case):
    """``entries`` reads the session's kernel attributes as the launch
    counters name the entries."""
    from weightedld_tpu_torch.runtime.driver import DriverConfig, LdSession

    cfg, unit, names, mode = ENTRY_CASES[case]
    rng = np.random.default_rng(5)
    aln = bench_torch.synthetic_alignment(rng, 70, 200)
    w = (np.ones(70) if unit else rng.random(70) + 0.05).astype(np.float32)
    sess = LdSession(aln, w, np.arange(200),
                     DriverConfig(tile=32, seq_chunk=64, **cfg),
                     device="cpu")
    got = bench_torch.entries(sess)
    assert (got["entries"], got["weights"], got["tile"]) == (names, mode, 32)
    assert got["n_batches"] == sess.n_batches


def test_bench_torch_imports_no_jax():
    """A fresh interpreter that imports the script and every module of the
    port, and runs the bench's session, holds none of the JAX side."""
    code = ("import importlib, pkgutil, sys, numpy as np, torch, "
            "bench_torch, weightedld_tpu_torch as pkg\n"
            "for m in pkgutil.walk_packages(pkg.__path__, 'weightedld_tpu_"
            "torch.'):\n"
            "    if not m.name.endswith('__main__'):\n"
            "        importlib.import_module(m.name)\n"
            "aln = bench_torch.synthetic_alignment(np.random.default_rng(0), "
            "20, 300)\n"
            "s = bench_torch.session(aln, torch.device('cpu'))\n"
            "s.summarize(); bench_torch.entries(s)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'weightedld_tpu', 'bench')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   cwd=REPO, env=_env())


def test_baseline_builds_into_the_port_build_directory():
    path = bench_torch.baseline_path()
    assert path.parent == REPO / "weightedld_tpu_torch" / "build"
    assert path.name.startswith("weighted_ld_baseline_")
    # Keyed by the flags: native/Makefile's CXXFLAGS.
    makefile = (REPO / "native" / "Makefile").read_text()
    flags = next(line for line in makefile.splitlines()
                 if line.startswith("CXXFLAGS"))
    assert flags.split(":=", 1)[1].split() == list(bench_torch.BASELINE_FLAGS)
