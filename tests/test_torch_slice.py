"""Parity of the port's main path (weightedld_tpu_torch) with the goldens and
with the JAX package, on the CPU.

* Dense engine: the 4-dp records and weights of all seven in-memory
  fixtures equal ``GOLDEN`` (the example fixture carries an ambiguity code,
  so the dense engine handles UNKNOWN), through the pipeline and the CLI.
* Tiled engine: the port's ``LdSession`` on ``device="cpu"`` writes the same
  TSV bytes as the JAX ``LdSession`` with ``DriverConfig(engine="pallas",
  tile=T, seq_chunk=C)`` on a one-device mesh, preplaned off and on,
  weighted and unweighted, on a seeded VCF.  The JAX side runs in a
  subprocess with FMA instructions withheld from XLA's CPU backend
  (``XLA_FLAGS=--xla_cpu_max_isa=AVX``): XLA contracts multiply-adds that
  the JAX program writes as separate operations, which moves f32 results by
  an ulp and can flip a 4-dp rounding (see tests/test_torch_majmin.py).
* Henikoff weights bit-equal to ``henikoff_weights_host``; the import
  boundary (no jax, no triton); what raises instead of falling back.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from weightedld_tpu.core.henikoff import henikoff_weights_host as jax_hk
from weightedld_tpu_torch import cli
from weightedld_tpu_torch.core.henikoff import henikoff_weights_host
from weightedld_tpu_torch.io.writer import _fmt
from weightedld_tpu_torch.pipeline import WldConfig, prepare, run
from weightedld_tpu_torch.runtime.driver import (
    DriverConfig,
    LdSession,
    plane_budget,
    run_to_tsv,
)

from .fixtures import ALL_FASTAS, GOLDEN, random_alignment, write_fasta

REPO = Path(__file__).resolve().parent.parent
TILE, CHUNK = 32, 64
N_SAMPLES, N_SITES = 60, 300     # 120 haplotypes (2 seq chunks), 10 tiles


# ---------------------------------------------------------------------------
# Dense engine: goldens
# ---------------------------------------------------------------------------


def _golden_tsv(name: str) -> str:
    rows = [f"{a}\t{b}\t{_fmt(d, 4)}\t{_fmt(dp, 4)}\t{_fmt(r2, 4)}"
            for a, b, d, dp, r2 in GOLDEN[name]["pairs"]]
    return "posa\tposb\tD\tD'\tR2\n" + "".join(r + "\n" for r in rows)


@pytest.mark.parametrize("name", list(ALL_FASTAS))
def test_dense_pipeline_matches_golden(tmp_path, name):
    path = tmp_path / f"{name}.fasta"
    write_fasta(path, ALL_FASTAS[name])
    res = run(path, device="cpu")
    g = GOLDEN[name]
    assert res.hk_mask.astype(int).tolist() == g["hk"]
    assert res.ld_mask.astype(int).tolist() == g["ld"]
    assert [round(float(w), 4) for w in res.weights] == g["weights"]
    rec = res.records
    got = [(int(a), int(b), round(float(d), 4), round(float(dp), 4),
            round(float(r2), 4)) for a, b, d, dp, r2 in
           zip(rec.pos_a, rec.pos_b, rec.d, rec.d_prime, rec.r2)]
    assert got == [tuple(p) for p in g["pairs"]]


@pytest.mark.parametrize("name", list(ALL_FASTAS))
def test_cli_dense_tsv_bytes_equal_golden(tmp_path, name):
    path = tmp_path / f"{name}.fasta"
    write_fasta(path, ALL_FASTAS[name])
    out = tmp_path / "pairs.tsv"
    wout = tmp_path / "weights.tsv"
    assert cli.main(["--file", str(path), "--device", "cpu",
                     "--pair-output", str(out),
                     "--weights-output", str(wout)]) == 0
    assert out.read_text() == _golden_tsv(name)
    rows = wout.read_text().splitlines()
    assert rows[0] == "sequence\tweight"
    assert [round(float(r.split("\t")[1]), 4) for r in rows[1:]] \
        == GOLDEN[name]["weights"]


# ---------------------------------------------------------------------------
# Tiled engine: byte parity with the JAX session
# ---------------------------------------------------------------------------


def _vcf_row(pos, gts):
    return f"1\t{pos}\trs{pos}\tA\tT\t100\tPASS\t.\tGT\t" + "\t".join(gts)


def _write_seeded_vcf(path: Path, seed: int = 7) -> None:
    """Phased genotypes over alleles 0 / 1 / '.', with correlated site
    pairs and a few unphased calls (which decode as missing)."""
    rng = np.random.default_rng(seed)
    haps = np.where(rng.random((2 * N_SAMPLES, N_SITES)) < 0.62, "0", "1")
    haps[rng.random(haps.shape) < 0.08] = "."
    for s in range(1, N_SITES, 3):          # LD: copy a neighbour, mutated
        src = haps[:, s - 1].copy()
        flip = rng.random(2 * N_SAMPLES) < 0.1
        src[flip] = np.where(src[flip] == "0", "1", "0")
        haps[:, s] = src
    header = ("##fileformat=VCFv4.1\n##contig=<ID=1>\n#CHROM\tPOS\tID\tREF"
              "\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
              + "\t".join(f"s{i}" for i in range(N_SAMPLES)))
    rows = []
    for s in range(N_SITES):
        gts = [f"{haps[2 * i, s]}|{haps[2 * i + 1, s]}"
               for i in range(N_SAMPLES)]
        if s % 17 == 0:
            gts[s % N_SAMPLES] = "0/1"
        rows.append(_vcf_row(100 + 7 * s, gts))
    path.write_text(header + "\n" + "\n".join(rows) + "\n")


VARIANTS = [(pp, uw) for pp in ("off", "on") for uw in (False, True)]


def _jax_reference(vcf: str, out_dir: str) -> None:
    """Subprocess body: the JAX session's TSVs and summaries."""
    import jax

    from weightedld_tpu.parallel.sharded import default_mesh
    from weightedld_tpu.pipeline import WldConfig as JWldConfig
    from weightedld_tpu.pipeline import prepare as jprepare
    from weightedld_tpu.runtime.driver import DriverConfig as JCfg
    from weightedld_tpu.runtime.driver import LdSession as JSession
    from weightedld_tpu.runtime.driver import run_to_tsv as jrun_to_tsv

    mesh = default_mesh(jax.devices()[:1])
    summaries = {}
    for pp, uw in VARIANTS:
        res = jprepare(vcf, JWldConfig(unweighted=uw))
        cfg = JCfg(engine="pallas", tile=TILE, seq_chunk=CHUNK, preplaned=pp)
        jrun_to_tsv(res.alignment, res.weights, res.site_map,
                    f"{out_dir}/jax_{pp}_{uw}.tsv", cfg, mesh=mesh,
                    checkpoint=False)
        sess = JSession(res.alignment, res.weights, res.site_map,
                        JCfg(engine="pallas", tile=TILE, seq_chunk=CHUNK,
                             preplaned=pp, r2_threshold=0.05), mesh=mesh)
        summaries[f"{pp}_{uw}"] = sess.summarize()
    Path(out_dir, "summaries.json").write_text(json.dumps(summaries))


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice")
    vcf = d / "seeded.vcf"
    _write_seeded_vcf(vcf)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_slice import _jax_reference; "
            "_jax_reference(sys.argv[2], sys.argv[3])")
    subprocess.run([sys.executable, "-c", code, str(REPO), str(vcf), str(d)],
                   env=env, check=True, timeout=900, cwd=REPO)
    return d, vcf, json.loads((d / "summaries.json").read_text())


@pytest.mark.parametrize("pp,uw", VARIANTS)
def test_tiled_session_tsv_bytes_equal_jax(seeded, pp, uw):
    d, vcf, _ = seeded
    res = prepare(vcf, WldConfig(unweighted=uw))
    out = d / f"torch_{pp}_{uw}.tsv"
    cfg = DriverConfig(tile=TILE, seq_chunk=CHUNK, preplaned=pp)
    n = run_to_tsv(res.alignment, res.weights, res.site_map, out, cfg,
                   device="cpu")
    want = (d / f"jax_{pp}_{uw}.tsv").read_bytes()
    assert n > 1000
    assert out.read_bytes() == want


@pytest.mark.parametrize("pp,uw", VARIANTS)
def test_session_summarize_matches_jax(seeded, pp, uw):
    _d, vcf, summaries = seeded
    res = prepare(vcf, WldConfig(unweighted=uw))
    sess = LdSession(res.alignment, res.weights, res.site_map,
                     DriverConfig(tile=TILE, seq_chunk=CHUNK, preplaned=pp,
                                  r2_threshold=0.05), device="cpu")
    assert sess.preplaned == (pp == "on")
    got, want = sess.summarize(), summaries[f"{pp}_{uw}"]
    for key in ("n_sequences", "n_sites", "n_pairs", "n_over_threshold"):
        assert got[key] == want[key], key
    assert got["r2_max"] == want["r2_max"]
    assert got["r2_sum_over_threshold"] == pytest.approx(
        want["r2_sum_over_threshold"], rel=1e-6)


def test_auto_preplaned_builds_no_planes_on_cpu():
    rng = np.random.default_rng(5)
    aln = rng.choice((0, 1, 4), size=(40, 100)).astype(np.int8)
    sess = LdSession(aln, np.ones(40, np.float32), np.arange(100),
                     DriverConfig(tile=TILE, seq_chunk=CHUNK), device="cpu")
    assert not sess.preplaned
    assert sess.planes_dev is None and sess.codes_dev is not None
    assert len(sess.operands) == 1
    assert plane_budget(torch.device("cpu")) == 0


def test_cli_tiled_tsv_bytes_equal_jax(seeded, tmp_path):
    d, vcf, _ = seeded
    out = tmp_path / "cli.tsv"
    assert cli.main(["--file", str(vcf), "--device", "cpu", "--engine",
                     "tiled", "--tile", str(TILE), "--seq-chunk", str(CHUNK),
                     "--pair-output", str(out)]) == 0
    assert out.read_bytes() == (d / "jax_off_False.tsv").read_bytes()


# ---------------------------------------------------------------------------
# Host code and the import boundary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,p_unknown", [((40, 60), 0.05),
                                             ((150, 300), 0.0),
                                             ((9, 4), 0.3)])
def test_henikoff_bit_equal_to_jax_host(shape, p_unknown):
    rng = np.random.default_rng(sum(shape))
    aln = random_alignment(rng, *shape, p_unknown=p_unknown)
    got, want = henikoff_weights_host(aln), jax_hk(aln)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_writers_bytes_equal_jax():
    # The JAX writers format through the native library when it is built;
    # the port's Python formatting must give the same bytes, including
    # -0.0, NaN and inf D' values and large positions.
    import io

    from weightedld_tpu.core.ld_dense import LdRecords as JRecords
    from weightedld_tpu.io.writer import write_pairs as jwrite_pairs
    from weightedld_tpu.io.writer import write_weights as jwrite_weights
    from weightedld_tpu_torch.core.ld_dense import LdRecords
    from weightedld_tpu_torch.io.writer import write_pairs, write_weights

    rng = np.random.default_rng(5)
    n = 2000
    vals = [(rng.standard_normal(n) * 0.1).astype(np.float32)
            for _ in range(3)]
    vals[0][:4] = [-0.0, -3e-5, 0.00005, 0.99995]
    vals[1][:3] = [np.inf, -np.inf, np.nan]
    pos = np.sort(rng.integers(0, 3_000_000_000, size=(2, n)), axis=0)
    rec = (pos[0], pos[1], *vals)
    for nd in (4, 3):
        a, b = io.StringIO(), io.StringIO()
        write_pairs(LdRecords(*rec), a, ndigits=nd)
        jwrite_pairs(JRecords(*rec), b, ndigits=nd)
        assert a.getvalue() == b.getvalue()
    w = henikoff_weights_host(random_alignment(rng, 300, 50))
    a, b = io.StringIO(), io.StringIO()
    write_weights(w, a)
    jwrite_weights(w, b)
    assert a.getvalue() == b.getvalue()


def test_port_imports_neither_jax_nor_triton():
    code = ("import sys, weightedld_tpu_torch, weightedld_tpu_torch.cli, "
            "weightedld_tpu_torch.ops.cuda_ld, "
            "weightedld_tpu_torch.ops.cuda_general, "
            "weightedld_tpu_torch.ops._build, "
            "weightedld_tpu_torch.pipeline, "
            "weightedld_tpu_torch.runtime.driver, "
            "weightedld_tpu_torch.runtime.ingest, "
            "weightedld_tpu_torch.io.native, "
            "weightedld_tpu_torch.io.progressbar, "
            "weightedld_tpu_torch.core.reference_impl, "
            "weightedld_tpu_torch.runtime.cache, "
            "weightedld_tpu_torch.runtime.profiling; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'triton', 'weightedld_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   cwd=REPO)


# ---------------------------------------------------------------------------
# No hidden fallback; what is not ported raises
# ---------------------------------------------------------------------------


def test_cuda_default_without_card_is_an_error(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    path = tmp_path / "t5.fasta"
    write_fasta(path, ALL_FASTAS["t5"])
    assert cli.main(["--file", str(path)]) == 2
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    from weightedld_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        run(path)


MULTI_PROCESS_FLAGS = [("--devices", "2"), ("--coordinator", "localhost:1"),
                       ("--num-processes", "2"), ("--process-id", "0")]


@pytest.mark.parametrize("flag", [
    spelling for f, v in MULTI_PROCESS_FLAGS for spelling in ([f, v],
                                                              [f"{f}={v}"])])
def test_cli_flag_not_yet_ported(flag, capsys):
    assert cli.main(["--file", "x.vcf", "--device", "cpu", *flag]) == 2
    err = capsys.readouterr().err
    assert "not yet ported" in err and "ROADMAP" in err
    assert flag[0].split("=")[0] in err and "item 13" in err


def _unsafe_unknown_alignment():
    rng = np.random.default_rng(3)
    aln = rng.choice((0, 1), size=(40, 70)).astype(np.int8)
    aln[rng.random(aln.shape) < 0.1] = 5
    return aln


def test_session_raises_for_inputs_off_the_slice():
    aln = _unsafe_unknown_alignment()
    w = np.ones(40, np.float32)
    sm = np.arange(70)
    # UNKNOWNs whose margins fail the factorized test: no longer refused,
    # the session runs the tile pairs it cannot prove on the general kernel.
    sess = LdSession(aln, w, sm, DriverConfig(tile=32), device="cpu")
    assert sess.phase_tiles["general"] > 0
    assert sess.summarize()["n_pairs"] > 0
    clean = np.where(aln == 5, 0, aln).astype(np.int8)
    # lo_int8 is ported: the session packs its weights and runs.
    wl = (np.random.default_rng(1).random(40) + 0.05).astype(np.float32)
    sess = LdSession(clean, wl, sm,
                     DriverConfig(tile=32, weight_quant="lo_int8"),
                     device="cpu")
    assert sess.kernel_kw["wquant"] == "lo_int8"
    assert tuple(sess.weights_dev.shape) == (3, 64)
    assert sess.summarize()["n_pairs"] > 0
    # weights=None is ported (on-device Henikoff); a site-major buffer that
    # is not padded for the session's tile and seq chunk is refused.
    from weightedld_tpu_torch.runtime.driver import SiteMajorCodes

    codes = np.full((128, 64), 5, np.int8)     # one tile more than 96
    codes[:70, :40] = clean.T
    with pytest.raises(ValueError, match="required_padding"):
        LdSession(SiteMajorCodes(codes=codes, n_seqs=40, n_sites=70), None,
                  sm, DriverConfig(tile=32), device="cpu")


def test_cli_large_input_and_lo_int8_exit_not_ported(tmp_path, monkeypatch,
                                                     capsys):
    path = tmp_path / "t4.fasta"
    write_fasta(path, ALL_FASTAS["t4"])
    # lo_int8 is ported: the tiled engine's TSV holds the golden records.
    out = tmp_path / "lo.tsv"
    assert cli.main(["--file", str(path), "--device", "cpu", "--engine",
                     "tiled", "--tile", "16", "--weight-quant", "lo_int8",
                     "--pair-output", str(out)]) == 0
    assert out.read_text() == _golden_tsv("t4")
    import weightedld_tpu_torch.pipeline as pipe

    # Inputs over _LARGE_CELLS are ported: weighted on the device (here the
    # CPU) in site chunks, with the golden records.
    monkeypatch.setattr(pipe, "_LARGE_CELLS", 10)
    out = tmp_path / "large.tsv"
    assert cli.main(["--file", str(path), "--device", "cpu",
                     "--pair-output", str(out)]) == 0
    assert out.read_text() == _golden_tsv("t4")
