"""Parity of the port's analytics (``LdSession.ld_decay``,
``r2_histogram``, ``top_pairs``, ``prune``, ``matrices``, ``summarize`` and
the CLI modes ``--stats-only``, ``--top``, ``--ld-decay``, ``--r2-hist``,
``--prune-r2`` / ``--prune-rule``, ``--matrix-output`` /
``--matrix-dtype``) with the JAX package, on the CPU.

The JAX side runs in a subprocess with FMA instructions withheld from XLA's
CPU backend (``XLA_FLAGS=--xla_cpu_max_isa=AVX``; see
tests/test_torch_slice.py): the JAX CLI's own ``main`` with its tiled
sessions on the Pallas kernels in interpret mode (the engine the JAX
package runs on a TPU; off a TPU its CLI would pick the XLA engine, another
kernel family), and the JAX ``LdSession`` methods directly.  Inputs:

* a seeded VCF (120 haplotypes x 300 sites), where ``--stats-only`` and
  ``--top`` run on both the dense engine (the default for S <= 2048) and
  the tiled one (``--engine tiled``);
* a FASTA with ambiguity characters, where the session packs the
  UNKNOWN-carrying sites and splits the plan (the packing fold-back of
  every method), and its ``kernel="general"`` session.

Rules: counts exact; float32 sums within rtol 1e-5 (per-batch summation
order differs); the top-k rows strictly above the k-th value equal and the
multiset of r2 values equal (ties at the k-th value are arbitrary);
pruned positions identical; matrices equal on kept cells (float16 within
2^-10 relative).  One histogram edge is an r2 value that occurs, so the
``>=`` / ``<`` boundary is pinned.
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
from weightedld_tpu_torch.pipeline import prepare
from weightedld_tpu_torch.runtime.driver import (
    DriverConfig,
    LdSession,
    validate_decay_edges,
    validate_hist_edges,
)

from .test_torch_ambiguous import write_ambiguous_fasta
from .test_torch_slice import _write_seeded_vcf

REPO = Path(__file__).resolve().parent.parent
TILE, CHUNK = 32, 64
FASTA_TILE = 16
DECAY = {"seeded.vcf": "0,10,50,200,700,2100",
         "ambiguous.fasta": "0,1,5,20,60,120"}
TOP_K = 25
PRUNE_THR = 0.2


def cli_modes(src: str, hist_edges: str) -> dict:
    """name -> CLI arguments of one mode on input ``src`` (both packages
    take them; the port adds ``--device cpu``)."""
    tile = TILE if src.endswith(".vcf") else FASTA_TILE
    lay = ["--tile", str(tile), "--seq-chunk", str(CHUNK)]
    modes = {
        "stats-tiled": ["--stats-only", "--engine", "tiled",
                        "--r2-threshold", "0.05"] + lay,
        "top-tiled": ["--top", str(TOP_K), "--engine", "tiled"] + lay,
        "decay": ["--ld-decay", DECAY[src]] + lay,
        "hist": ["--r2-hist", hist_edges] + lay,
        "prune-maf": ["--prune-r2", str(PRUNE_THR)] + lay,
        "prune-first": ["--prune-r2", str(PRUNE_THR), "--prune-rule",
                        "first"] + lay,
        "matrix-float32": ["--matrix-output", "{out}.npz"] + lay,
        "matrix-float16": ["--matrix-output", "{out}.npz",
                           "--matrix-dtype", "float16"] + lay,
    }
    if src.endswith(".vcf"):
        modes["stats-dense"] = ["--stats-only", "--r2-threshold", "0.05"]
        modes["top-dense"] = ["--top", str(TOP_K)]
    return modes


SOURCES = ("seeded.vcf", "ambiguous.fasta")
MODE_CASES = [(src, m) for src in SOURCES for m in cli_modes(src, "0,1")]
KERNELS = ("auto", "general")


def _run_cli(main, argv: list[str], out: Path) -> str:
    """One CLI run with its record/site output in ``out`` (TSV modes) or
    ``out.npz``; returns its standard output."""
    import contextlib
    import io

    argv = [a.replace("{out}", str(out)) for a in argv]
    if not any(a == "--matrix-output" for a in argv):
        argv += ["--pair-output", str(out)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0, argv
    return buf.getvalue()


def _session_results(sess, edges_decay, edges_hist) -> dict:
    """The analytics of one session, as JSON-able values."""
    top = sess.top_pairs(TOP_K)
    return {
        "summary": sess.summarize(r2_threshold=0.05),
        "decay": sess.ld_decay(edges_decay),
        "hist": sess.r2_histogram(edges_hist),
        "top": [[int(a), int(b), float(d), float(dp), float(r2)]
                for a, b, d, dp, r2 in zip(*top)],
        "prune_maf": [int(p) for p in sess.prune(PRUNE_THR)],
        "prune_first": [int(p) for p in sess.prune(PRUNE_THR,
                                                   rule="first")],
    }


def _jax_reference(out_dir: str) -> None:
    """Subprocess body: the JAX CLI and the JAX sessions on both inputs."""
    import jax

    import weightedld_tpu.runtime.driver as jd
    from weightedld_tpu import cli as jcli
    from weightedld_tpu.parallel.sharded import default_mesh
    from weightedld_tpu.pipeline import prepare as jprepare

    # The tiled sessions on the Pallas kernels (interpret mode off a TPU).
    resolve = jd._resolve_engine
    jd._resolve_engine = lambda engine, platform=None: (
        "pallas" if engine == "auto" else resolve(engine, platform))
    out = Path(out_dir)
    _write_seeded_vcf(out / "seeded.vcf")
    write_ambiguous_fasta(out / "ambiguous.fasta")
    mesh = default_mesh(jax.devices()[:1])
    meta = {}
    for src in SOURCES:
        res = jprepare(out / src)
        tile = TILE if src.endswith(".vcf") else FASTA_TILE
        sessions = {kern: jd.LdSession(
            res.alignment, res.weights, res.site_map,
            jd.DriverConfig(engine="pallas", tile=tile, seq_chunk=CHUNK,
                            kernel=kern), mesh=mesh) for kern in KERNELS}
        # A histogram edge on an r2 value that occurs: the 3rd strongest.
        pinned = float(sessions["auto"].top_pairs(3).r2[2])
        edges_hist = tuple(sorted({0.0, 0.01, pinned, 0.5, 1.01}))
        edges_decay = tuple(int(e) for e in DECAY[src].split(","))
        meta[src] = {
            "hist_edges": list(edges_hist),
            "pinned": pinned,
            "packed": sessions["auto"]._site_perm is not None,
            "sessions": {k: _session_results(s, edges_decay, edges_hist)
                         for k, s in sessions.items()},
            "stdout": {},
        }
        for kern, s in sessions.items():
            mats = s.matrices()
            np.savez(out / f"{src}.{kern}.session.npz", **mats)
        hist_arg = ",".join(repr(e) for e in edges_hist)
        for mode, argv in cli_modes(src, hist_arg).items():
            meta[src]["stdout"][mode] = _run_cli(
                jcli.main, ["--file", str(out / src)] + argv,
                out / f"{src}.{mode}.jax")
    (out / "meta.json").write_text(json.dumps(meta))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("analytics")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_analytics import _jax_reference; "
            "_jax_reference(sys.argv[2])")
    subprocess.run([sys.executable, "-c", code, str(REPO), str(d)],
                   env=env, check=True, timeout=900, cwd=REPO)
    return d, json.loads((d / "meta.json").read_text())


def _port_session(d: Path, src: str, kern: str) -> LdSession:
    res = prepare(d / src)
    tile = TILE if src.endswith(".vcf") else FASTA_TILE
    return LdSession(res.alignment, res.weights, res.site_map,
                     DriverConfig(tile=tile, seq_chunk=CHUNK, kernel=kern),
                     device="cpu")


# ---------------------------------------------------------------------------
# Comparison rules
# ---------------------------------------------------------------------------


def assert_json_close(got: dict, want: dict) -> None:
    """Counts and edges equal; float sums and means within rtol 1e-5."""
    assert set(got) - {"elapsed_s"} == set(want) - {"elapsed_s"}
    for key, w in want.items():
        if key == "elapsed_s":
            continue
        g = got[key]
        if isinstance(w, list):
            assert len(g) == len(w), key
            for a, b in zip(g, w):
                if b is None or isinstance(b, int) and not isinstance(
                        b, bool) and key != "edges":
                    assert a == b, key
                else:
                    assert a == pytest.approx(b, rel=1e-5, abs=1e-12), key
        elif isinstance(w, float):
            assert g == pytest.approx(w, rel=1e-5), key
        else:
            assert g == w, key


def assert_top_equal(got: list, want: list) -> None:
    """Rows strictly above the k-th value equal (as sets of pairs with
    their values); the multiset of r2 values equal."""
    assert len(got) == len(want)
    kth = want[-1][4]
    above = lambda rows: sorted(tuple(r) for r in rows if r[4] > kth)
    assert above(got) == above(want)
    assert sorted(r[4] for r in got) == sorted(r[4] for r in want)


def assert_matrices_equal(got, want, rel: float = 0.0) -> None:
    keep = want["keep"]
    np.testing.assert_array_equal(got["keep"], keep)
    assert keep.any()
    for f in ("d", "d_prime", "r2"):
        assert got[f].dtype == want[f].dtype
        g = got[f][keep].astype(np.float64)
        w = want[f][keep].astype(np.float64)
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin)
        np.testing.assert_allclose(g[fin], w[fin], rtol=rel, atol=0)
        assert np.isnan(got[f][~keep]).all()


def _tsv_rows(text: str) -> list:
    lines = text.strip().splitlines()
    assert lines[0] == "posa\tposb\tD\tD'\tR2"
    return [[int(x) if i < 2 else float(x) for i, x in
             enumerate(ln.split("\t"))] for ln in lines[1:]]


# ---------------------------------------------------------------------------
# The library: LdSession methods
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kern", KERNELS)
@pytest.mark.parametrize("src", SOURCES)
def test_session_analytics_match_jax(jax_ref, src, kern):
    d, meta = jax_ref
    want = meta[src]["sessions"][kern]
    sess = _port_session(d, src, kern)
    if kern == "auto":
        assert (sess.site_perm is not None) == meta[src]["packed"]
        assert (sess.site_perm is not None) == (src == "ambiguous.fasta")
    edges_hist = meta[src]["hist_edges"]
    got = _session_results(sess, validate_decay_edges(DECAY[src].split(",")),
                           edges_hist)
    for key in ("summary", "decay", "hist"):
        assert_json_close(got[key], want[key])
    assert_top_equal(got["top"], want["top"])
    assert got["prune_maf"] == want["prune_maf"]
    assert got["prune_first"] == want["prune_first"]
    assert len(got["prune_maf"]) < sess.n_sites


@pytest.mark.parametrize("kern", KERNELS)
@pytest.mark.parametrize("src", SOURCES)
def test_session_matrices_match_jax(jax_ref, src, kern):
    d, _meta = jax_ref
    want = dict(np.load(d / f"{src}.{kern}.session.npz"))
    got = _port_session(d, src, kern).matrices()
    assert_matrices_equal(got, want)


def test_histogram_edge_on_an_occurring_r2_value(jax_ref):
    d, meta = jax_ref
    edges = meta["seeded.vcf"]["hist_edges"]
    sess = _port_session(d, "seeded.vcf", "auto")
    pinned = np.float32(meta["seeded.vcf"]["pinned"])
    top = sess.top_pairs(3)
    assert top.r2[2] == pinned            # the edge is an r2 value
    # The pair at the edge falls in the bin that starts there: >= / <.
    b = edges.index(float(pinned))
    assert sess.r2_histogram(edges)["n_pairs"][b] >= 1
    assert sess.r2_histogram((0.0, float(pinned)))["n_pairs"][0] \
        == sess.summarize()["n_pairs"] - int((sess.top_pairs(10).r2
                                              >= pinned).sum())


def test_matrices_refuse_bfloat16_and_other_dtypes():
    rng = np.random.default_rng(2)
    aln = rng.choice((0, 1), size=(20, 40)).astype(np.int8)
    sess = LdSession(aln, np.ones(20, np.float32), np.arange(40),
                     DriverConfig(tile=16, seq_chunk=CHUNK), device="cpu")
    for dt in ("bfloat16", np.float64, "int8"):
        with pytest.raises(ValueError):
            sess.matrices(dtype=dt)


@pytest.mark.parametrize("edges,kind", [
    (["0"], "decay"), (["5", "5"], "decay"), (["0", str(2 ** 31)], "decay"),
    (["0.1"], "hist"), (["0.5", "0.2"], "hist")])
def test_edge_validation_equals_jax(edges, kind):
    from weightedld_tpu.runtime import driver as jd

    port = validate_decay_edges if kind == "decay" else validate_hist_edges
    jax_fn = jd.validate_decay_edges if kind == "decay" \
        else jd.validate_hist_edges
    with pytest.raises(ValueError) as got:
        port(edges)
    with pytest.raises(ValueError) as want:
        jax_fn(edges)
    assert str(got.value) == str(want.value)


def test_ld_decay_refuses_a_decreasing_site_map():
    rng = np.random.default_rng(4)
    aln = rng.choice((0, 1), size=(30, 40)).astype(np.int8)
    sm = np.concatenate([np.arange(20), np.arange(20)])    # POS restarts
    sess = LdSession(aln, np.ones(30, np.float32), sm,
                     DriverConfig(tile=16, seq_chunk=CHUNK), device="cpu")
    with pytest.raises(ValueError, match="non-decreasing"):
        sess.ld_decay((0, 10))
    with pytest.raises(ValueError, match="unique"):
        sess.prune(0.1)


# ---------------------------------------------------------------------------
# The CLI modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,mode", MODE_CASES)
def test_cli_mode_matches_jax(jax_ref, tmp_path, src, mode):
    d, meta = jax_ref
    hist_arg = ",".join(repr(e) for e in meta[src]["hist_edges"])
    argv = ["--file", str(d / src), "--device", "cpu"] \
        + cli_modes(src, hist_arg)[mode]
    out = tmp_path / "port"
    stdout = _run_cli(cli.main, argv, out)
    want_stdout = meta[src]["stdout"][mode]
    jax_out = d / f"{src}.{mode}.jax"
    if mode.startswith(("stats", "decay", "hist")):
        got, want = json.loads(stdout), json.loads(want_stdout)
        assert_json_close(got, want)
        assert "elapsed_s" in got
    elif mode.startswith("top"):
        assert_top_equal(_tsv_rows(out.read_text()),
                         _tsv_rows(jax_out.read_text()))
    elif mode.startswith("prune"):
        assert out.read_text() == jax_out.read_text()
        assert 0 < len(out.read_text().split()) < 300
    else:
        got = dict(np.load(f"{out}.npz"))
        want = dict(np.load(f"{jax_out}.npz"))
        np.testing.assert_array_equal(got["site_map"], want["site_map"])
        assert_matrices_equal(got, want,
                              rel=2.0 ** -10 if mode.endswith("16") else 0)


def test_cli_modes_are_mutually_exclusive(capsys):
    assert cli.main(["--file", "x.vcf", "--device", "cpu", "--top", "3",
                     "--prune-r2", "0.1"]) == 2
    assert "mutually exclusive" in capsys.readouterr().err


@pytest.mark.parametrize("argv,message", [
    (["--ld-decay", "5,1"], "--ld-decay"),
    (["--r2-hist", "0.1"], "--r2-hist"),
    (["--top", "0"], "positive K"),
    (["--prune-r2", "nan"], "finite"),
])
def test_cli_rejects_bad_mode_arguments(tmp_path, capsys, argv, message):
    vcf = tmp_path / "s.vcf"
    _write_seeded_vcf(vcf)
    assert cli.main(["--file", str(vcf), "--device", "cpu", "--tile",
                     str(TILE)] + argv) == 2
    assert message in capsys.readouterr().err


def test_cli_modes_on_fewer_than_two_sites(tmp_path, capsys):
    from .fixtures import write_fasta

    path = tmp_path / "mono.fasta"
    write_fasta(path, ["AAAAC", "AAAAC", "AAAAT", "AAAAT"])  # 1 LD site
    assert cli.main(["--file", str(path), "--device", "cpu",
                     "--stats-only"]) == 0
    assert json.loads(capsys.readouterr().out)["n_pairs"] == 0
    assert cli.main(["--file", str(path), "--device", "cpu", "--ld-decay",
                     "0,10"]) == 0
    assert json.loads(capsys.readouterr().out)["n_pairs"] == [0]
    assert cli.main(["--file", str(path), "--device", "cpu", "--prune-r2",
                     "0.1"]) == 0
    assert capsys.readouterr().out == "4\n"
