"""Parity of the port's ambiguity-code path with the JAX package, on the CPU.

Inputs with UNKNOWN (code 5) cells — ambiguity characters of a FASTA — go
through the port's ``LdSession`` on ``device="cpu"`` (the plain versions of
both kernels) and through the JAX ``LdSession`` with
``DriverConfig(engine="pallas", tile=16, seq_chunk=64)`` on a one-device
mesh (interpret-mode Pallas kernels):

* the hybrid session (unsafe-site packing, then the factorized kernel on
  the safe tile pairs and the general kernel on the rest) and the
  ``kernel="general"`` session, weighted and unweighted: TSV bytes,
  ``summarize``, the packing permutation and the safe/unsafe split equal
  the JAX session's;
* the CLI ``--engine tiled`` on a FASTA with ambiguity characters: TSV
  bytes equal the JAX session's on the JAX package's own prepared input;
* the CLI ``--engine tiled --tile 16`` on the two golden fixtures that
  carry ambiguity codes (``example``, ``t1``): the golden TSV bytes.

The JAX side runs in a subprocess with FMA instructions withheld from XLA's
CPU backend (``XLA_FLAGS=--xla_cpu_max_isa=AVX``; see
tests/test_torch_slice.py).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from weightedld_tpu_torch import cli
from weightedld_tpu_torch.pipeline import WldConfig, prepare
from weightedld_tpu_torch.runtime.driver import (
    DriverConfig,
    LdSession,
    run_to_tsv,
)

from .fixtures import ALL_FASTAS, write_fasta
from .test_torch_slice import _golden_tsv

REPO = Path(__file__).resolve().parent.parent
TILE, CHUNK = 16, 64
INPUTS = ("tie", "scattered")
KERNELS = ("auto", "general")
VARIANTS = [(name, uw, kern) for name in INPUTS for uw in (False, True)
            for kern in KERNELS]


def make_input(name: str):
    """``(alignment, weights, site_map)``, as in tests/test_pallas_ld.py's
    hybrid tests: ``tie`` has one count-tie site beside an UNKNOWN (the
    global factorized test fails, most tile pairs stay safe), ``scattered``
    near-balanced sites with UNKNOWN cells at 30 % of the sites (packing
    engages)."""
    rng = np.random.default_rng(0)
    if name == "tie":
        n_seqs, n_sites = 64, 70
        aln = rng.choice([0, 0, 0, 0, 0, 1, 1, 2],
                         size=(n_seqs, n_sites)).astype(np.int8)
        aln[:32, 36] = 0
        aln[32:, 36] = 1
        aln[5, 38] = 5
        aln[7, 3] = 5
        site_map = np.arange(n_sites)
    else:
        n_seqs, n_sites = 64, 160
        aln = rng.choice([0, 0, 1, 1, 1],
                         size=(n_seqs, n_sites)).astype(np.int8)
        for s in rng.choice(n_sites, size=48, replace=False):
            aln[rng.integers(n_seqs), s] = 5
        site_map = np.arange(n_sites) * 3 + 7
    w = (rng.random(n_seqs) + 0.05).astype(np.float32)
    return aln, w, site_map


def write_ambiguous_fasta(path: Path, seed: int = 11) -> None:
    """Near-balanced A/C/G/T columns with 6 % gaps, correlated column pairs,
    and 1-2 ambiguity characters (N, R, Y) in a fifth of the columns."""
    rng = np.random.default_rng(seed)
    n, s = 40, 120
    cols = rng.choice(list("ACGT-"), p=(0.235, 0.235, 0.235, 0.235, 0.06),
                      size=(n, s))
    for c in range(1, s, 4):
        src = cols[:, c - 1].copy()
        flip = rng.random(n) < 0.1
        src[flip] = rng.choice(list("ACGT"), size=int(flip.sum()))
        cols[:, c] = src
    for c in rng.choice(s, size=s // 5, replace=False):
        rows = rng.choice(n, size=rng.integers(1, 3), replace=False)
        cols[rows, c] = rng.choice(list("NRY"), size=len(rows))
    write_fasta(path, ["".join(r) for r in cols])


def _jax_reference(out_dir: str) -> None:
    """Subprocess body: the JAX sessions' TSVs, summaries, packing
    permutations and safe/unsafe splits."""
    import jax

    from weightedld_tpu.parallel.sharded import default_mesh
    from weightedld_tpu.pipeline import WldConfig as JWldConfig
    from weightedld_tpu.pipeline import prepare as jprepare
    from weightedld_tpu.runtime.driver import DriverConfig as JCfg
    from weightedld_tpu.runtime.driver import LdSession as JSession
    from weightedld_tpu.runtime.driver import run_to_tsv as jrun_to_tsv

    mesh = default_mesh(jax.devices()[:1])
    out = Path(out_dir)
    meta = {}
    for name, uw, kern in VARIANTS:
        aln, w, sm = make_input(name)
        if uw:
            w = np.ones_like(w)
        tag = f"{name}_{uw}_{kern}"
        cfg = JCfg(engine="pallas", tile=TILE, seq_chunk=CHUNK, kernel=kern)
        jrun_to_tsv(aln, w, sm, out / f"jax_{tag}.tsv", cfg, mesh=mesh,
                    checkpoint=False)
        sess = JSession(aln, w, sm, JCfg(engine="pallas", tile=TILE,
                                         seq_chunk=CHUNK, kernel=kern,
                                         r2_threshold=0.05), mesh=mesh)
        meta[tag] = {
            "summary": sess.summarize(),
            "site_perm": (None if sess._site_perm is None
                          else sess._site_perm.tolist()),
            "hybrid_safe": (None if sess._hybrid_safe is None
                            else sess._hybrid_safe.tolist()),
            "majmin": bool(sess._majmin),
        }
    fasta = out / "ambiguous.fasta"
    write_ambiguous_fasta(fasta)
    for uw in (False, True):
        res = jprepare(fasta, JWldConfig(unweighted=uw))
        jrun_to_tsv(res.alignment, res.weights, res.site_map,
                    out / f"jax_fasta_{uw}.tsv",
                    JCfg(engine="pallas", tile=TILE, seq_chunk=CHUNK),
                    mesh=mesh, checkpoint=False)
    (out / "meta.json").write_text(json.dumps(meta))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("ambiguous")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_ambiguous import _jax_reference; "
            "_jax_reference(sys.argv[2])")
    subprocess.run([sys.executable, "-c", code, str(REPO), str(d)],
                   env=env, check=True, timeout=900, cwd=REPO)
    return d, json.loads((d / "meta.json").read_text())


def _port_input(name, uw):
    aln, w, sm = make_input(name)
    return aln, (np.ones_like(w) if uw else w), sm


@pytest.mark.parametrize("name,uw,kern", VARIANTS)
def test_session_tsv_bytes_equal_jax(jax_ref, tmp_path, name, uw, kern):
    d, _meta = jax_ref
    out = tmp_path / "port.tsv"
    n = run_to_tsv(*_port_input(name, uw), out,
                   DriverConfig(tile=TILE, seq_chunk=CHUNK, kernel=kern),
                   device="cpu")
    assert n > 1000
    assert out.read_bytes() == (d / f"jax_{name}_{uw}_{kern}.tsv").read_bytes()


@pytest.mark.parametrize("name,uw,kern", VARIANTS)
def test_session_summarize_matches_jax(jax_ref, name, uw, kern):
    _d, meta = jax_ref
    sess = LdSession(*_port_input(name, uw),
                     DriverConfig(tile=TILE, seq_chunk=CHUNK, kernel=kern,
                                  r2_threshold=0.05), device="cpu")
    got, want = sess.summarize(), meta[f"{name}_{uw}_{kern}"]["summary"]
    for key in ("n_sequences", "n_sites", "n_pairs", "n_over_threshold"):
        assert got[key] == want[key], key
    assert got["r2_max"] == want["r2_max"]
    assert got["r2_sum_over_threshold"] == pytest.approx(
        want["r2_sum_over_threshold"], rel=1e-6)


@pytest.mark.parametrize("name,uw,kern", VARIANTS)
def test_packing_and_split_equal_jax(jax_ref, name, uw, kern):
    _d, meta = jax_ref
    want = meta[f"{name}_{uw}_{kern}"]
    sess = LdSession(*_port_input(name, uw),
                     DriverConfig(tile=TILE, seq_chunk=CHUNK, kernel=kern),
                     device="cpu")
    got_perm = None if sess.site_perm is None else sess.site_perm.tolist()
    got_safe = (None if sess.hybrid_safe is None
                else sess.hybrid_safe.tolist())
    assert got_perm == want["site_perm"]
    assert got_safe == want["hybrid_safe"]
    tiles = sess.phase_tiles
    if kern == "general":
        assert tiles == {"majmin": 0, "general": sess.plan.n_tiles}
        assert sess.auxc_dev is None
    else:
        # Both inputs fail the global test; each splits the plan.
        assert not want["majmin"] and want["hybrid_safe"] is not None
        assert tiles["majmin"] == sum(want["hybrid_safe"])
        assert tiles["majmin"] + tiles["general"] == sess.plan.n_tiles
        assert sess.n_batches == sum(
            -(-n // min(8, n)) for n in tiles.values())


@pytest.mark.parametrize("uw", [False, True])
def test_cli_fasta_with_ambiguity_bytes_equal_jax(jax_ref, tmp_path, uw):
    d, _meta = jax_ref
    fasta = tmp_path / "ambiguous.fasta"
    write_ambiguous_fasta(fasta)
    res = prepare(fasta, WldConfig(unweighted=uw))
    assert (res.alignment == 5).any()          # ambiguity codes survive
    sess = LdSession(res.alignment, res.weights, res.site_map,
                     DriverConfig(tile=TILE, seq_chunk=CHUNK), device="cpu")
    assert sess.phase_tiles["general"] > 0
    out = tmp_path / "cli.tsv"
    argv = ["--file", str(fasta), "--device", "cpu", "--engine", "tiled",
            "--tile", str(TILE), "--seq-chunk", str(CHUNK), "--pair-output",
            str(out)] + (["--unweighted"] if uw else [])
    assert cli.main(argv) == 0
    assert out.read_bytes() == (d / f"jax_fasta_{uw}.tsv").read_bytes()


@pytest.mark.parametrize("name", ["example", "t1"])
def test_cli_tiled_goldens_with_ambiguity_codes(tmp_path, name):
    path = tmp_path / f"{name}.fasta"
    write_fasta(path, ALL_FASTAS[name])
    out = tmp_path / "pairs.tsv"
    assert cli.main(["--file", str(path), "--device", "cpu", "--engine",
                     "tiled", "--tile", str(TILE), "--pair-output",
                     str(out)]) == 0
    assert out.read_text() == _golden_tsv(name)
