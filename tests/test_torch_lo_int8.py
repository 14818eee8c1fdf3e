"""Parity of the port's ``lo_int8`` weight mode with the JAX package.

``w ~= bf16(w) + alpha * q``: one float pass of the bf16 weights plus one
int8 pass of the quantized residual, combined as ``F + alpha * f32(J)``
once per seq chunk (``pallas_ld.py:307-315``, ``:926-930``,
``:1173-1177``).

* The port's packer ``pad_weights_lo_int8`` is bit-equal to JAX's (which
  rounds to bf16 with ``ml_dtypes``; the port with torch's cast) on random
  weights, on exact rounding ties and on subnormal residuals.
* The plain versions of the four weighted entries (factorized codes and
  planes, general codes and planes) hold the same inputs as the JAX
  interpret-mode kernels at ``wquant="lo_int8"``: in-process at rtol 1e-5 /
  atol 1e-6, and bit for bit with FMA instructions withheld from XLA's CPU
  backend (``XLA_FLAGS=--xla_cpu_max_isa=AVX``, in a subprocess; see
  tests/test_torch_majmin.py).
* The CLI's ``--engine tiled --weight-quant lo_int8`` TSV equals, byte for
  byte, the JAX session's (``engine="pallas"``, the same tile and chunk) on
  the JAX package's own prepared input, for a VCF and for a FASTA with
  ambiguity characters (the hybrid split: both kernels in lo_int8).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weightedld_tpu.ops import pallas_ld as P
from weightedld_tpu.parallel.triangle import plan_tiles
from weightedld_tpu_torch import cli
from weightedld_tpu_torch.ops import cuda_general as G
from weightedld_tpu_torch.ops import cuda_ld as K

from .test_torch_ambiguous import write_ambiguous_fasta
from .test_torch_majmin import assert_stats_match
from .test_torch_slice import _write_seeded_vcf

REPO = Path(__file__).resolve().parent.parent
TILE, CHUNK = 32, 64

# ---------------------------------------------------------------------------
# The packer
# ---------------------------------------------------------------------------

PACKER_CASES = {
    "random": (np.random.default_rng(1).random(300) + 0.05).astype(
        np.float32),
    # Halfway between two bf16 numbers (8 significant bits): ties to even.
    "ties": np.asarray([1.0, 1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8,
                        0.5 + 2.0 ** -9, 0.75 + 2.0 ** -9, 2.0 ** -8 * 1.5,
                        0.3], np.float32),
    # Subnormal weights: the residuals and their scale are subnormal too.
    "subnormal": np.asarray([3.3e-39, 1.1e-39, 2.9e-39, 7e-40],
                            np.float32),
    "subnormal-residual": np.asarray([1e-38 + 1e-44, 1.3e-38, 2e-38, 1e-39],
                                     np.float32),
    "bf16-exact": np.asarray([1.0, 0.5, 0.25, 0.75], np.float32),
}


@pytest.mark.parametrize("name", list(PACKER_CASES))
@pytest.mark.parametrize("chunk", [4, 64])
def test_pad_weights_lo_int8_bit_equal_to_jax(name, chunk):
    w = PACKER_CASES[name]
    if name == "random":
        w = w / w.max()
    got = K.pad_weights_lo_int8(w, chunk)
    want = P.pad_weights_lo_int8(w, chunk)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if name == "bf16-exact":
        assert not got[1:].any()


# ---------------------------------------------------------------------------
# The plain versions of the four weighted entries
# ---------------------------------------------------------------------------

# id -> (seed, alphabet, n_seqs, n_sites, tile, seq_chunk, UNKNOWN fraction)
CASES = {
    "snp": (1, (0, 1, 4), 50, 70, 16, 64, 0.05),
    "multichunk": (2, (0, 1, 2, 3, 4), 150, 40, 16, 64, 0.03),
    "ragged": (3, (0, 1, 2, 4), 37, 45, 32, 20, 0.08),
}
ENTRIES = ("majmin-codes", "majmin-pre", "general-codes", "general-pre")


def make_case(name: str) -> dict:
    """Numpy inputs (both packages build from these): the alignment without
    UNKNOWN for the factorized entries, with it for the general ones."""
    seed, alphabet, n, s, tile, chunk, unk = CASES[name]
    rng = np.random.default_rng(seed)
    aln = rng.choice(alphabet, size=(n, s)).astype(np.int8)
    dirty = aln.copy()
    dirty[rng.random(aln.shape) < unk] = 5
    w = (rng.random(n) + 0.05).astype(np.float32)
    w /= w.max()
    plan = plan_tiles(s, tile)
    emit = np.ones(plan.n_tiles, np.int32)
    emit[rng.random(plan.n_tiles) < 0.2] = 0
    auxc, auxr = P.majmin_site_aux(aln, plan.s_pad)
    return dict(
        codes=P.pad_alignment_site_major(aln, tile, chunk),
        dirty=P.pad_alignment_site_major(dirty, tile, chunk),
        planes=P.detect_planes(dirty),
        weights=P.pad_weights_lo_int8(w, chunk), auxc=auxc, auxr=auxr,
        tile_i=plan.tile_i, tile_j=plan.tile_j, emit=emit,
        kw=dict(tile=tile, n_sites=s, seq_chunk=chunk, wquant="lo_int8"))


def jax_stats(c: dict, entry: str) -> dict:
    j = {k: jnp.asarray(c[k]) for k in ("codes", "dirty", "weights", "auxc",
                                         "auxr", "tile_i", "tile_j", "emit")}
    tiles = (j["tile_i"], j["tile_j"], j["emit"])
    tile = c["kw"]["tile"]
    if entry == "majmin-codes":
        st = P.pallas_tile_stats_majmin(
            j["codes"], j["weights"], j["auxc"], j["auxr"], *tiles,
            interpret=True, **c["kw"])
    elif entry == "majmin-pre":
        planes = P.build_majmin_planes(j["codes"], j["auxc"], tile=tile)
        st = P.pallas_tile_stats_majmin_pre(
            planes, (), j["weights"], j["auxc"], j["auxr"], *tiles,
            interpret=True, **c["kw"])
    else:
        pre = entry == "general-pre"
        src = P.build_planes_tiled(j["dirty"], tile=tile,
                                   planes=c["planes"]) if pre else j["dirty"]
        st = P.pallas_tile_stats(src, j["weights"], *tiles, preplaned=pre,
                                 planes=c["planes"], interpret=True,
                                 **c["kw"])
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def port_stats(c: dict, entry: str) -> dict:
    t = {k: torch.from_numpy(np.ascontiguousarray(c[k]))
         for k in ("codes", "dirty", "weights", "auxc", "tile_i", "tile_j",
                   "emit")}
    tiles = (t["tile_i"], t["tile_j"], t["emit"])
    tile = c["kw"]["tile"]
    if entry == "majmin-codes":
        st = K.tile_stats_majmin(t["codes"], t["weights"], t["auxc"], *tiles,
                                 **c["kw"])
    elif entry == "majmin-pre":
        planes = K.build_majmin_planes(t["codes"], t["auxc"], tile=tile)
        st = K.tile_stats_majmin_pre(planes, None, t["weights"], t["auxc"],
                                     *tiles, **c["kw"])
    else:
        pre = entry == "general-pre"
        src = G.build_planes_tiled(t["dirty"], tile=tile,
                                   planes=c["planes"]) if pre else t["dirty"]
        st = G.tile_stats_general(src, t["weights"], *tiles, preplaned=pre,
                                  planes=c["planes"], **c["kw"])
    return {f: getattr(st, f).numpy() for f in st._fields}


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_interpret(name, entry):
    c = make_case(name)
    assert_stats_match(port_stats(c, entry), jax_stats(c, entry))


def _jax_reference(out_dir: str) -> None:
    """Subprocess body: every case through the JAX kernels, and the JAX
    session's lo_int8 TSVs of the seeded VCF and the ambiguous FASTA."""
    import jax

    from weightedld_tpu.parallel.sharded import default_mesh
    from weightedld_tpu.pipeline import prepare as jprepare
    from weightedld_tpu.runtime.driver import DriverConfig as JCfg
    from weightedld_tpu.runtime.driver import run_to_tsv as jrun_to_tsv

    out = Path(out_dir)
    arrays = {}
    for name in CASES:
        c = make_case(name)
        for entry in ENTRIES:
            for f, v in jax_stats(c, entry).items():
                arrays[f"{name}/{entry}/{f}"] = v
    np.savez(out / "stats.npz", **arrays)
    mesh = default_mesh(jax.devices()[:1])
    _write_seeded_vcf(out / "seeded.vcf")
    write_ambiguous_fasta(out / "ambiguous.fasta")
    counts = {}
    for src in ("seeded.vcf", "ambiguous.fasta"):
        res = jprepare(out / src)
        counts[src] = jrun_to_tsv(
            res.alignment, res.weights, res.site_map, out / f"{src}.tsv",
            JCfg(engine="pallas", tile=TILE, seq_chunk=CHUNK,
                 weight_quant="lo_int8"), mesh=mesh, checkpoint=False)
    (out / "counts.json").write_text(json.dumps(counts))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("lo_int8")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_lo_int8 import _jax_reference; "
            "_jax_reference(sys.argv[2])")
    subprocess.run([sys.executable, "-c", code, str(REPO), str(d)],
                   env=env, check=True, timeout=900, cwd=REPO)
    return d, dict(np.load(d / "stats.npz"))


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("name", list(CASES))
def test_plain_bitwise_vs_jax_without_fma(jax_ref, name, entry):
    _d, stats = jax_ref
    ref = {f: stats[f"{name}/{entry}/{f}"]
           for f in ("d", "d_prime", "r2", "keep")}
    assert_stats_match(port_stats(make_case(name), entry), ref, bitwise=True)


@pytest.mark.parametrize("src", ["seeded.vcf", "ambiguous.fasta"])
def test_cli_lo_int8_tsv_bytes_equal_jax(jax_ref, tmp_path, src):
    d, _stats = jax_ref
    out = tmp_path / "cli.tsv"
    assert cli.main(["--file", str(d / src), "--device", "cpu", "--engine",
                     "tiled", "--tile", str(TILE), "--seq-chunk", str(CHUNK),
                     "--weight-quant", "lo_int8", "--pair-output",
                     str(out)]) == 0
    want = (d / f"{src}.tsv").read_bytes()
    assert want.count(b"\n") > 100
    assert out.read_bytes() == want
