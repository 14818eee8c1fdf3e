"""Parity of the port's streaming-ingest sessions and device Henikoff
weights with the JAX package, on the CPU.

* Weights: ``henikoff_weights_host_site_major`` bit-equal to JAX's;
  ``henikoff_weights_site_major`` and ``henikoff_weights_large`` (torch on
  the CPU) and ``pipeline._weights_for`` over a lowered ``_LARGE_CELLS``
  within rtol 1e-6 of JAX's.
* Sessions: ``session_from_vcf`` / ``session_from_fasta`` on ``cpu`` write
  the same TSV bytes as the port's standard session at the same tile; the
  FASTA carries ambiguity codes, so the unsafe-site packing and the hybrid
  split run on the site-major buffer.  ``weights=None`` (on the device)
  within rtol 1e-6 of the host weights; ``prune`` of a streamed session
  equal to the standard one's; a mis-padded buffer is refused.
* CLI: ``--stream-ingest`` TSVs equal the JAX CLI's ``--stream-ingest`` on
  a VCF and a FASTA, byte for byte, with the JAX side in a subprocess under
  ``XLA_FLAGS=--xla_cpu_max_isa=AVX`` (see tests/test_torch_slice.py).
  The JAX streamed session does not pack unsafe sites (its packing needs
  the sequence-major matrix, ``driver.py:419``) where the port's does, so
  on a FASTA with ambiguity codes the port's ``--stream-ingest`` TSV is
  held to the JAX in-memory session, which packs.  ``--stream-ingest
  --engine dense`` exits 2.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from weightedld_tpu.core import henikoff as jhk
from weightedld_tpu_torch import cli
from weightedld_tpu_torch.core.henikoff import (
    henikoff_weights_host,
    henikoff_weights_host_site_major,
    henikoff_weights_large,
    henikoff_weights_site_major,
)
from weightedld_tpu_torch.io.writer import pair_header, write_pairs
from weightedld_tpu_torch.ops.cuda_ld import pad_alignment_site_major
from weightedld_tpu_torch.pipeline import WldConfig, prepare
from weightedld_tpu_torch.runtime.driver import (
    DriverConfig,
    LdSession,
    SiteMajorCodes,
)
from weightedld_tpu_torch.runtime.ingest import (
    prepare_fasta_streamed,
    session_from_fasta,
    session_from_vcf,
)

from .fixtures import random_alignment, write_fasta
from .test_torch_ambiguous import write_ambiguous_fasta
from .test_torch_slice import _write_seeded_vcf

REPO = Path(__file__).resolve().parent.parent
TILE, CHUNK = 32, 64
RTOL = 1e-6


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def _codes_sm(seed: int, n: int, s: int, p_unknown: float, tile: int = 32,
              chunk: int = 64):
    rng = np.random.default_rng(seed)
    aln = random_alignment(rng, n, s, p_unknown=p_unknown)
    return aln, pad_alignment_site_major(aln, tile, chunk)


@pytest.mark.parametrize("n,s,p_unknown,row_chunk", [
    (40, 300, 0.0, 4096), (50, 257, 0.05, 64), (130, 90, 0.3, 7)])
def test_host_site_major_bit_equal_to_jax(n, s, p_unknown, row_chunk):
    aln, codes = _codes_sm(n, n, s, p_unknown)
    got = henikoff_weights_host_site_major(codes, s, n, row_chunk=row_chunk)
    want = jhk.henikoff_weights_host_site_major(codes, s, n,
                                                row_chunk=row_chunk)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, henikoff_weights_host(aln), rtol=1e-12)


@pytest.mark.parametrize("n,s,p_unknown,site_chunk", [
    (40, 300, 0.0, 16384), (50, 257, 0.05, 64), (130, 90, 0.3, 7)])
def test_site_major_device_weights_match_jax(n, s, p_unknown, site_chunk):
    import torch

    aln, codes = _codes_sm(n, n, s, p_unknown)
    got = henikoff_weights_site_major(torch.from_numpy(codes), n,
                                      site_chunk=site_chunk)
    want = np.asarray(jhk.henikoff_weights_site_major(jnp.asarray(codes), n))
    assert got.dtype == torch.float32 and got.shape == (codes.shape[1],)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    assert not got[n:].any()
    np.testing.assert_allclose(got[:n].numpy(), henikoff_weights_host(aln),
                               rtol=RTOL)


@pytest.mark.parametrize("site_chunk", [7, 64, 16384])
def test_large_weights_match_jax(site_chunk):
    rng = np.random.default_rng(site_chunk)
    aln = random_alignment(rng, 70, 230, p_unknown=0.1)
    got = henikoff_weights_large(aln, site_chunk=site_chunk, device="cpu")
    want = np.asarray(jhk.henikoff_weights_large(aln, site_chunk=site_chunk))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), henikoff_weights_host(aln),
                               rtol=RTOL)


def test_weights_for_over_large_cells_matches_jax(monkeypatch):
    import weightedld_tpu.pipeline as jpipe
    import weightedld_tpu_torch.pipeline as pipe

    rng = np.random.default_rng(3)
    aln = random_alignment(rng, 60, 200, p_unknown=0.05)
    monkeypatch.setattr(pipe, "_LARGE_CELLS", 1000)
    monkeypatch.setattr(jpipe, "_LARGE_CELLS", 1000)
    got = pipe._weights_for(aln, "cpu")
    want = jpipe._weights_for(aln)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # Under the limit: the host float64 weights, bit-equal.
    monkeypatch.setattr(pipe, "_LARGE_CELLS", aln.size)
    monkeypatch.setattr(jpipe, "_LARGE_CELLS", aln.size)
    np.testing.assert_array_equal(pipe._weights_for(aln, "cpu"),
                                  jpipe._weights_for(aln))


# ---------------------------------------------------------------------------
# Sessions
# ---------------------------------------------------------------------------


def _tsv(sess: LdSession) -> str:
    buf = io.StringIO()
    buf.write(pair_header() + "\n")
    for _b, rec in sess.stream():
        write_pairs(rec, buf, header=False)
    return buf.getvalue()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ingest")
    vcf = d / "seeded.vcf"
    _write_seeded_vcf(vcf)
    amb = d / "ambiguous.fasta"
    write_ambiguous_fasta(amb)
    return d, vcf, amb


@pytest.mark.parametrize("uw", [False, True])
def test_session_from_vcf_tsv_equals_standard(inputs, uw):
    _d, vcf, _amb = inputs
    cfg = DriverConfig(tile=TILE, seq_chunk=CHUNK)
    res = prepare(vcf, WldConfig(unweighted=uw), device="cpu")
    want = _tsv(LdSession(res.alignment, res.weights, res.site_map, cfg,
                          device="cpu"))
    sess = session_from_vcf(vcf, cfg, device="cpu", unweighted=uw)
    assert isinstance(sess._host, SiteMajorCodes)
    np.testing.assert_array_equal(sess.weights,
                                  np.asarray(res.weights, np.float32))
    got = _tsv(sess)
    assert got.count("\n") > 1000
    assert got == want


@pytest.mark.parametrize("uw", [False, True])
def test_session_from_fasta_packs_and_tsv_equals_standard(inputs, uw):
    _d, _vcf, amb = inputs
    cfg = DriverConfig(tile=16, seq_chunk=CHUNK)
    res = prepare(amb, WldConfig(unweighted=uw), device="cpu")
    std = LdSession(res.alignment, res.weights, res.site_map, cfg,
                    device="cpu")
    sess = session_from_fasta(amb, cfg, device="cpu", unweighted=uw)
    assert sess.site_perm is not None and std.site_perm is not None
    np.testing.assert_array_equal(sess.site_perm, std.site_perm)
    np.testing.assert_array_equal(sess.hybrid_safe, std.hybrid_safe)
    assert 0 < sess.phase_tiles["general"] < sess.plan.n_tiles
    np.testing.assert_array_equal(sess.weights,
                                  np.asarray(res.weights, np.float32))
    assert _tsv(sess) == _tsv(std)
    assert sess.summarize(0.05) == std.summarize(0.05)


def test_streamed_fasta_masks_equal_pipeline(inputs):
    _d, _vcf, amb = inputs
    sm, site_map, hk, ld = prepare_fasta_streamed(
        amb, cfg=DriverConfig(tile=16, seq_chunk=CHUNK))
    res = prepare(amb, device="cpu")
    np.testing.assert_array_equal(ld, res.ld_mask)
    np.testing.assert_array_equal(hk, res.hk_mask)
    np.testing.assert_array_equal(site_map, res.site_map)
    np.testing.assert_array_equal(
        sm.codes[:sm.n_sites, :sm.n_seqs], res.alignment.T)


@pytest.mark.parametrize("source", ["vcf", "fasta"])
def test_prune_of_streamed_session_equals_standard(inputs, source):
    _d, vcf, amb = inputs
    path = vcf if source == "vcf" else amb
    cfg = DriverConfig(tile=16, seq_chunk=CHUNK)
    res = prepare(path, device="cpu")
    std = LdSession(res.alignment, res.weights, res.site_map, cfg,
                    device="cpu")
    make = session_from_vcf if source == "vcf" else session_from_fasta
    sess = make(path, cfg, device="cpu")
    for rule in ("maf", "first"):
        np.testing.assert_array_equal(sess.prune(0.1, rule=rule),
                                      std.prune(0.1, rule=rule))


def test_f32_device_weights_within_rtol_of_host(inputs):
    _d, vcf, amb = inputs
    cfg = DriverConfig(tile=TILE, seq_chunk=CHUNK)
    host = session_from_vcf(vcf, cfg, device="cpu")
    dev = session_from_vcf(vcf, cfg, device="cpu", weight_precision="f32")
    assert dev.weights.dtype == np.float32
    np.testing.assert_allclose(dev.weights, host.weights, rtol=RTOL)
    # weights=None on a sequence-major input, with packing.
    res = prepare(amb, device="cpu")
    sess = LdSession(res.alignment, None, res.site_map,
                     DriverConfig(tile=16, seq_chunk=CHUNK), device="cpu")
    assert sess.site_perm is not None
    np.testing.assert_allclose(sess.weights, res.weights, rtol=RTOL)
    with pytest.raises(ValueError, match="weight_precision"):
        session_from_vcf(vcf, cfg, device="cpu", weight_precision="f16")


def test_mis_padded_buffer_is_refused(inputs):
    _d, vcf, _amb = inputs
    res = prepare(vcf, device="cpu")
    n, s = res.alignment.shape
    cfg = DriverConfig(tile=TILE, seq_chunk=CHUNK)
    assert LdSession.required_padding(n, s, cfg) == (320, 128)
    for tile, chunk in ((64, CHUNK), (TILE, 32)):
        codes = pad_alignment_site_major(res.alignment, tile, chunk)
        if codes.shape == (320, 128):
            continue
        with pytest.raises(ValueError, match="required_padding"):
            LdSession(SiteMajorCodes(codes, n, s), res.weights,
                      res.site_map, cfg, device="cpu")
    codes = pad_alignment_site_major(res.alignment, TILE, CHUNK)
    with pytest.raises(ValueError, match="required_padding"):
        LdSession(SiteMajorCodes(codes.astype(np.int16), n, s),
                  res.weights, res.site_map, cfg, device="cpu")


# ---------------------------------------------------------------------------
# CLI against the JAX CLI
# ---------------------------------------------------------------------------


def _write_clean_fasta(path: Path, seed: int = 4) -> None:
    """A/C/G/T columns with gaps and correlated pairs, no ambiguity code."""
    rng = np.random.default_rng(seed)
    cols = rng.choice(list("ACGT-"), p=(0.4, 0.3, 0.1, 0.1, 0.1),
                      size=(48, 140))
    for c in range(1, 140, 3):
        src = cols[:, c - 1].copy()
        flip = rng.random(48) < 0.1
        src[flip] = "A"
        cols[:, c] = src
    write_fasta(path, ["".join(r) for r in cols])


def _jax_reference(out_dir: str) -> None:
    """Subprocess body: the JAX CLI's ``--stream-ingest`` TSVs of the VCF
    and the clean FASTA, and the JAX in-memory session's TSV of the
    ambiguous FASTA."""
    import jax

    from weightedld_tpu.cli import main as jmain
    from weightedld_tpu.parallel.sharded import default_mesh
    from weightedld_tpu.pipeline import prepare as jprepare
    from weightedld_tpu.runtime.driver import DriverConfig as JCfg
    from weightedld_tpu.runtime.driver import run_to_tsv as jrun_to_tsv

    out = Path(out_dir)
    for name in ("seeded.vcf", "clean.fasta"):
        rc = jmain(["--file", str(out / name), "--stream-ingest", "--tile",
                    str(TILE), "--seq-chunk", str(CHUNK), "--pair-output",
                    str(out / f"jax_{name}.tsv")])
        assert rc == 0, name
    res = jprepare(out / "ambiguous.fasta")
    jrun_to_tsv(res.alignment, res.weights, res.site_map,
                out / "jax_ambiguous.fasta.tsv",
                JCfg(engine="pallas", tile=TILE, seq_chunk=CHUNK),
                mesh=default_mesh(jax.devices()[:1]), checkpoint=False)


@pytest.fixture(scope="module")
def jax_cli(inputs):
    d, _vcf, _amb = inputs
    _write_clean_fasta(d / "clean.fasta")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_ingest import _jax_reference; "
            "_jax_reference(sys.argv[2])")
    subprocess.run([sys.executable, "-c", code, str(REPO), str(d)], env=env,
                   check=True, timeout=900, cwd=REPO)
    return d


@pytest.mark.parametrize("name", ["seeded.vcf", "clean.fasta",
                                  "ambiguous.fasta"])
def test_cli_stream_ingest_tsv_bytes_equal_jax(jax_cli, tmp_path, name):
    d = jax_cli
    out = tmp_path / "out.tsv"
    assert cli.main(["--file", str(d / name), "--stream-ingest", "--device",
                     "cpu", "--tile", str(TILE), "--seq-chunk", str(CHUNK),
                     "--pair-output", str(out)]) == 0
    want = (d / f"jax_{name}.tsv").read_bytes()
    assert want.count(b"\n") > 100
    assert out.read_bytes() == want


def test_cli_stream_ingest_equals_default_run(inputs, tmp_path, capsys):
    """Weights TSV, an analytics mode and the records of the streamed run
    equal the default (native reader) run's."""
    _d, vcf, _amb = inputs
    base = ["--file", str(vcf), "--device", "cpu", "--engine", "tiled",
            "--tile", str(TILE), "--seq-chunk", str(CHUNK)]
    outs = {}
    for tag, extra in (("default", []), ("stream", ["--stream-ingest"])):
        assert cli.main(base + extra + [
            "--pair-output", str(tmp_path / f"{tag}.tsv"),
            "--weights-output", str(tmp_path / f"{tag}_w.tsv")]) == 0
        capsys.readouterr()
        assert cli.main(base + extra + ["--stats-only"]) == 0
        stats = json.loads(capsys.readouterr().out)
        stats.pop("elapsed_s")
        outs[tag] = ((tmp_path / f"{tag}.tsv").read_bytes(),
                     (tmp_path / f"{tag}_w.tsv").read_bytes(), stats)
    assert outs["stream"] == outs["default"]


def test_cli_stream_ingest_dense_engine_exits_2(inputs, capsys):
    _d, vcf, _amb = inputs
    assert cli.main(["--file", str(vcf), "--device", "cpu",
                     "--stream-ingest", "--engine", "dense"]) == 2
    assert ("--stream-ingest requires the tiled engine (--engine dense "
            "holds the matrix in sequence-major form)"
            in capsys.readouterr().err)
