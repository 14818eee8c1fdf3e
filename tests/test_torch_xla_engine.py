"""The port's XLA tile engine against the JAX package's.

``DriverConfig(engine="xla")`` runs the JAX package's portable tile engine:
``core/ld_tiled.tile_stats_batch`` contracts one-hot ``[N, 5T]`` operands
into the joint tables with float32 matrix products and finalizes them with
``core/paircore.finalize_pair_tile``.  Here, on the CPU, at small shapes:

* ``tile_stats_batch`` against the JAX function (jit, CPU): diagonal,
  off-diagonal, ``emit=False`` and padded last tiles, codes 0..5: ``keep``
  bit-equal, D, D' and r2 at rtol 1e-5 / atol 1e-6 on kept pairs (XLA:CPU's
  GEMM order is Eigen's blocking, which torch's does not reproduce; see
  ``tests/test_torch_dense.py``);
* ``LdSession(engine="xla")`` against the JAX session on its XLA engine
  (one CPU device, or a two-device mesh against ``devices=["cpu", "cpu"]``
  at equal tiles per batch): the goldens' TSVs byte for byte; on random
  VCF-like and ambiguous inputs equal record sets with values at rtol 1e-5 /
  atol 1e-6 and TSVs equal except 4-dp ties whose raw values lie within
  1e-6 (counted); every analytics method (counts exact, sums at rtol 1e-5);
  windows and ``cross_split``; ``weights=None``;
* what the port does on its own: a bad engine string raises, a
  ``SiteMajorCodes`` input raises as in JAX, a checkpoint resumed under the
  other engine is refused, ``torch.set_float32_matmul_precision`` changes
  no bit of the engine, and neither the default session nor the CLI's ever
  reaches ``tile_stats_batch``.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from weightedld_tpu_torch import cli
from weightedld_tpu_torch.core.ld_tiled import pad_alignment, tile_stats_batch
from weightedld_tpu_torch.io.writer import write_pairs
from weightedld_tpu_torch.pipeline import prepare
from weightedld_tpu_torch.runtime import driver as drv
from weightedld_tpu_torch.runtime.driver import (
    DriverConfig,
    LdSession,
    SiteMajorCodes,
    collect_ld_records,
    run_to_tsv,
    stream_ld_records,
)

from .fixtures import ALL_FASTAS, write_fasta
from .test_torch_multiprocess import _clean_env, _free_port, _wait_all
from .test_torch_slice import _golden_tsv

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-6
TIE_GAP = 1e-6
# 13 tiles of 16 sites over S = 200: 91 tile pairs, 12 batches of 8.
CFG = dict(tile=16, tiles_per_shard_batch=8)
DECAY = [0, 10, 100, 1000, 100000]
HIST = [0.0, 0.05, 0.2, 0.5, 1.01]
INPUTS = ("vcf", "amb")


def make_input(name: str):
    """``(alignment, weights, site_map)``, 48 x 200 from a numpy seed:
    ``vcf`` codes 0 / 1 / 4 (VCF's alleles and missing) with every second
    site a 10 %-mutated copy of its neighbour; ``amb`` codes 0..4 with 6 %
    UNKNOWN cells and the same LD."""
    rng = np.random.default_rng({"vcf": 31, "amb": 32}[name])
    n, s = 48, 200
    if name == "vcf":
        aln = rng.choice([0, 0, 0, 1, 1, 4], size=(n, s)).astype(np.int8)
    else:
        aln = rng.choice([0, 0, 1, 2, 3, 4], size=(n, s)).astype(np.int8)
    for c in range(1, s, 2):
        src = aln[:, c - 1].copy()
        flip = rng.random(n) < 0.1
        src[flip] = rng.choice([0, 1], size=int(flip.sum()))
        aln[:, c] = src
    if name == "amb":
        aln[rng.random(aln.shape) < 0.06] = 5
    w = (rng.random(n) + 0.05).astype(np.float32)
    return aln, w, np.arange(5, 5 + 7 * s, 7, dtype=np.int64)


def _jax():
    import jax

    from weightedld_tpu.parallel.sharded import default_mesh
    from weightedld_tpu.runtime import driver as jd

    return jax, default_mesh, jd


def _jax_session(aln, w, sm, g: int = 1, **cfg):
    jax, default_mesh, jd = _jax()
    return jd.LdSession(aln, w, sm, jd.DriverConfig(engine="xla", **cfg),
                        mesh=default_mesh(jax.devices()[:g]))


def _records(stream) -> dict:
    """Concatenated ``(pos_a, pos_b, d, d_prime, r2)`` of a stream, numpy."""
    parts = [r for _b, r in stream]
    return {f: np.concatenate([np.asarray(getattr(p, f)) for p in parts])
            for f in ("pos_a", "pos_b", "d", "d_prime", "r2")}


def _assert_values(got, want, label: str = "") -> None:
    """Equal non-finite patterns, finite values at RTOL / ATOL."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=label)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL,
                               err_msg=label)


def _assert_same_records(got: dict, want: dict) -> None:
    """The same pairs in the same order, values at RTOL / ATOL."""
    assert len(got["pos_a"]) == len(want["pos_a"]) > 0
    for f in ("pos_a", "pos_b"):
        np.testing.assert_array_equal(got[f], want[f])
    for f in ("d", "d_prime", "r2"):
        _assert_values(got[f], want[f], f)


def _tsv_rows(rec: dict) -> list[str]:
    buf = io.StringIO()
    from weightedld_tpu_torch.core.ld_dense import LdRecords

    write_pairs(LdRecords(*(rec[f] for f in LdRecords._fields)), buf,
                header=False)
    return buf.getvalue().splitlines()


def _tie_rows(got_rows, want_rows, got: dict, want: dict) -> int:
    """Rows of two equal-length TSVs that differ; each must be a 4-dp tie:
    its raw values (``got`` / ``want`` records, row for row) within
    TIE_GAP, every differing field one 4-dp quantum apart.  Returns their
    count."""
    assert len(got_rows) == len(want_rows)
    ties = 0
    for i, (g, w) in enumerate(zip(got_rows, want_rows)):
        if g == w:
            continue
        ties += 1
        gf, wf = g.split("\t"), w.split("\t")
        assert gf[:2] == wf[:2], (g, w)
        for a, b in zip(gf[2:], wf[2:]):
            if a != b:
                assert abs(abs(float(a) - float(b)) - 1e-4) < 1e-9, (g, w)
        for f in ("d", "d_prime", "r2"):
            assert abs(float(got[f][i]) - float(want[f][i])) <= TIE_GAP, (
                g, w, f)
    return ties


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX XLA-engine session's read-outs of each input, at CFG."""
    out = {}
    for name in INPUTS:
        aln, w, sm = make_input(name)
        js = _jax_session(aln, w, sm, **CFG)
        out[name] = {
            "n_batches": js.n_batches,
            "records": _records(js.stream()),
            "summary": js.summarize(r2_threshold=0.05),
            "decay": js.ld_decay(DECAY),
            "hist": js.r2_histogram(HIST),
            "top": js.top_pairs(25),
            "prune": np.asarray(js.prune(0.3)),
            "matrices": js.matrices(),
        }
    return out


def _session(name: str, **extra) -> LdSession:
    aln, w, sm = make_input(name)
    return LdSession(aln, w, sm, DriverConfig(engine="xla", **CFG, **extra),
                     device="cpu")


# ---------------------------------------------------------------------------
# tile_stats_batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", (True, False))
@pytest.mark.parametrize("n", (7, 64))
def test_tile_stats_batch_equals_jax(n, weighted):
    import jax.numpy as jnp

    from weightedld_tpu.core.ld_tiled import tile_stats_batch as jtiles

    rng = np.random.default_rng(n)
    s, t = 50, 16                    # S_pad 64: the last tile has 2 sites
    aln = rng.choice(6, p=[0.3, 0.25, 0.15, 0.1, 0.1, 0.1],
                     size=(n, s)).astype(np.int8)
    w = ((rng.random(n) + 0.05) if weighted else np.ones(n)).astype(
        np.float32)
    codes = pad_alignment(aln, t)
    # Diagonal, off-diagonal, padded last tile (with itself and others),
    # and two emit=False tiles.
    ti = np.array([0, 0, 1, 2, 3, 0, 1, 0], np.int32)
    tj = np.array([0, 1, 3, 2, 3, 3, 1, 2], np.int32)
    em = np.array([1, 1, 1, 1, 1, 1, 0, 0], bool)
    want = jtiles(jnp.asarray(codes), jnp.asarray(w), jnp.asarray(ti),
                  jnp.asarray(tj), jnp.asarray(em), tile=t, n_sites=s)
    got = tile_stats_batch(*(torch.from_numpy(x) for x in (codes, w, ti,
                                                           tj, em)),
                           tile=t, n_sites=s)
    keep = np.asarray(want.keep)
    assert got.keep.shape == (8, t, t)
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    assert keep.sum() > 100 and not keep[6:].any() and not keep[4, 2:].any()
    for f in ("d", "d_prime", "r2"):
        _assert_values(getattr(got, f).numpy()[keep],
                       np.asarray(getattr(want, f))[keep], f)


def test_pad_alignment_equals_jax():
    from weightedld_tpu.core.ld_tiled import pad_alignment as jpad

    aln = np.random.default_rng(3).integers(0, 6, (5, 37)).astype(np.int8)
    np.testing.assert_array_equal(pad_alignment(aln, 16), jpad(aln, 16))
    whole = aln[:, :32]
    assert pad_alignment(whole, 16) is whole        # no copy, as in JAX


@pytest.mark.parametrize("prec", ("high", "medium"))
def test_matmul_precision_changes_no_bit(prec):
    """TF32 (``"high"``) and bf16 (``"medium"``, oneDNN on the CPU) are
    refused inside the engine's products and left set outside them."""
    aln, w, _sm = make_input("amb")
    codes = torch.from_numpy(pad_alignment(aln, 16))
    ti = torch.tensor([0, 0, 3, 12], dtype=torch.int32)
    tj = torch.tensor([0, 5, 9, 12], dtype=torch.int32)
    em = torch.ones(4, dtype=torch.int32)

    def run():
        return tile_stats_batch(codes, torch.from_numpy(w), ti, tj, em,
                                tile=16, n_sites=200)

    want = run()
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(prec)
    try:
        got = run()
        assert torch.get_float32_matmul_precision() == prec
    finally:
        torch.set_float32_matmul_precision(before)
    bits = lambda x: x if x.dtype == torch.bool else x.view(torch.int32)
    for f in got._fields:
        assert torch.equal(bits(getattr(got, f)), bits(getattr(want, f))), f


# ---------------------------------------------------------------------------
# Sessions against the JAX XLA engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(ALL_FASTAS))
def test_golden_tsv_bytes_equal_jax(tmp_path, name):
    """The goldens at the auto tile (T = 128, one tile): the port's and the
    JAX engine's TSVs are the golden TSV, byte for byte."""
    _jax_mod, default_mesh, jd = _jax()
    from weightedld_tpu.pipeline import prepare as jprepare

    path = tmp_path / f"{name}.fasta"
    write_fasta(path, ALL_FASTAS[name])
    res, jres = prepare(path, device="cpu"), jprepare(path)
    got, want = tmp_path / "port.tsv", tmp_path / "jax.tsv"
    sess_cfg = DriverConfig(engine="xla")
    run_to_tsv(res.alignment, res.weights, res.site_map, got, sess_cfg,
               device="cpu")
    jd.run_to_tsv(np.asarray(jres.alignment), np.asarray(jres.weights),
                  np.asarray(jres.site_map), want,
                  jd.DriverConfig(engine="xla"),
                  mesh=default_mesh(_jax_mod.devices()[:1]))
    assert got.read_bytes() == want.read_bytes()
    assert got.read_text() == _golden_tsv(name)


@pytest.mark.parametrize("name", INPUTS)
def test_session_records_equal_jax(jax_ref, name):
    sess = _session(name)
    assert sess.engine == "xla" and sess.site_perm is None
    assert sess.n_batches == jax_ref[name]["n_batches"] == 12
    assert sess.phase_tiles == {"majmin": 0, "general": 0, "xla": 91}
    assert drv._plan_engine(sess) == "xla"
    got, want = _records(sess.stream()), jax_ref[name]["records"]
    _assert_same_records(got, want)
    # run_batch is stream's batch b.
    rb = sess.run_batch(3)
    streamed = dict(sess.stream())[3]
    for f in ("pos_a", "pos_b", "d", "d_prime", "r2"):
        np.testing.assert_array_equal(getattr(rb, f), getattr(streamed, f))


@pytest.mark.parametrize("name", INPUTS)
def test_run_to_tsv_equals_jax_except_ties(jax_ref, tmp_path, name):
    aln, w, sm = make_input(name)
    out = tmp_path / "port.tsv"
    n = run_to_tsv(aln, w, sm, out, DriverConfig(engine="xla", **CFG),
                   device="cpu")
    want = jax_ref[name]["records"]
    rows = out.read_text().splitlines()
    assert rows[0] == "posa\tposb\tD\tD'\tR2" and n == len(rows) - 1
    got = _records(_session(name).stream())
    ties = _tie_rows(rows[1:], _tsv_rows(want), got, want)
    assert ties <= n // 1000, ties


@pytest.mark.parametrize("name", INPUTS)
def test_stream_decimals_equals_stream(jax_ref, name):
    """``stream(decimals=4)`` on the XLA engine: the first scan takes the
    exact path, a re-scan the speculative compaction at the learned
    capacities, both formatting to ``stream()``'s bytes."""
    sess = _session(name)
    plain = _tsv_rows(_records(sess.stream()))
    first = _tsv_rows(_records(sess.stream(decimals=4)))
    assert sess.path_counts["exact"] > 0
    spec = dict(sess.path_counts)
    again = _tsv_rows(_records(sess.stream(decimals=4)))
    assert sess.path_counts["exact"] == spec["exact"]
    assert sess.path_counts["speculative"] >= spec["speculative"] + 12
    assert first == again == plain


@pytest.mark.parametrize("method", ("summarize", "ld_decay", "r2_histogram",
                                    "top_pairs", "prune", "matrices"))
@pytest.mark.parametrize("name", INPUTS)
def test_analytics_equal_jax(jax_ref, name, method):
    sess, ref = _session(name), jax_ref[name]
    if method == "summarize":
        got, want = sess.summarize(r2_threshold=0.05), ref["summary"]
        for key in ("n_sequences", "n_sites", "n_pairs", "n_over_threshold"):
            assert got[key] == want[key], key
        for key in ("r2_sum_over_threshold", "r2_max"):
            assert got[key] == pytest.approx(want[key], rel=RTOL), key
    elif method == "ld_decay":
        got, want = sess.ld_decay(DECAY), ref["decay"]
        for key in ("edges", "n_pairs", "n_d_prime_finite"):
            assert got[key] == want[key], key
        for key in ("r2_sum", "r2_mean", "abs_d_prime_sum",
                    "abs_d_prime_mean"):
            np.testing.assert_allclose(np.asarray(got[key], float),
                                       np.asarray(want[key], float),
                                       rtol=RTOL, err_msg=key)
    elif method == "r2_histogram":
        got, want = sess.r2_histogram(HIST), ref["hist"]
        assert got["n_pairs"] == want["n_pairs"] and sum(got["n_pairs"]) > 0
    elif method == "top_pairs":
        got, want = sess.top_pairs(25), ref["top"]
        np.testing.assert_allclose(got.r2, np.asarray(want.r2), rtol=RTOL)
        # Ties at the k-th value are broken arbitrarily: the pairs above it
        # are the same.
        cut = float(np.asarray(want.r2).min()) * (1 + 2 * RTOL)

        def above(rec):
            return sorted((int(a), int(b)) for a, b, r in zip(
                np.asarray(rec.pos_a), np.asarray(rec.pos_b),
                np.asarray(rec.r2)) if r > cut)

        assert above(got) == above(want)
    elif method == "prune":
        got = sess.prune(0.3)
        np.testing.assert_array_equal(got, ref["prune"])
        assert 0 < len(got) < 200
    else:
        got, want = sess.matrices(), ref["matrices"]
        np.testing.assert_array_equal(got["keep"], want["keep"])
        for key in ("d", "d_prime", "r2"):
            _assert_values(got[key], want[key], key)


@pytest.mark.parametrize("window", ("sites", "bp", "both", "cross"))
def test_windows_and_cross_equal_jax(window):
    name = "amb" if window == "bp" else "vcf"
    aln, w, sm = make_input(name)
    extra = {"sites": dict(max_site_distance=20),
             "bp": dict(max_bp_distance=300),
             "both": dict(max_site_distance=30, max_bp_distance=150),
             "cross": dict(cross_split=77)}[window]
    sess = LdSession(aln, w, sm, DriverConfig(engine="xla", **CFG, **extra),
                     device="cpu")
    js = _jax_session(aln, w, sm, **CFG, **extra)
    assert sess.n_batches == js.n_batches
    assert sess.plan.n_tiles < 91
    got, want = _records(sess.stream()), _records(js.stream())
    _assert_same_records(got, want)
    gs, ws = sess.summarize(), js.summarize()
    assert gs["n_pairs"] == ws["n_pairs"] == len(got["pos_a"])
    if window == "cross":
        assert (got["pos_a"] < sm[77]).all() and (got["pos_b"] >= sm[77]).all()


def test_weights_none_equals_jax():
    """``weights=None``: the port's device Henikoff weights (float32 cells,
    float64 site sums) beside the JAX function's (float32), at 1e-6, and
    the records at the engine's tolerance."""
    aln, _w, sm = make_input("amb")
    sess = LdSession(aln, None, sm, DriverConfig(engine="xla", **CFG),
                     device="cpu")
    js = _jax_session(aln, None, sm, **CFG)
    np.testing.assert_allclose(sess.weights, np.asarray(js.weights),
                               rtol=1e-6)
    assert sess.weights.dtype == np.float32 and sess.weights.max() == 1.0
    _assert_same_records(_records(sess.stream()), _records(js.stream()))


@pytest.mark.parametrize("name", INPUTS)
def test_two_shards_equal_two_device_mesh(name):
    """G = 2 (``devices=["cpu", "cpu"]``) against a two-device JAX mesh at
    equal tiles per batch: the same records in the same order (batch, then
    shard), and the same reductions."""
    aln, w, sm = make_input(name)
    sess = LdSession(aln, w, sm, DriverConfig(engine="xla", **CFG),
                     devices=["cpu", "cpu"])
    js = _jax_session(aln, w, sm, g=2, **CFG)
    assert sess.n_shards == 2 and sess.n_batches == js.n_batches == 6
    _assert_same_records(_records(sess.stream()), _records(js.stream()))
    got, want = sess.r2_histogram(HIST), js.r2_histogram(HIST)
    assert got["n_pairs"] == want["n_pairs"]
    one = LdSession(aln, w, sm, DriverConfig(engine="xla", **CFG),
                    device="cpu")
    assert (sorted(_tsv_rows(_records(sess.stream(decimals=4))))
            == sorted(_tsv_rows(_records(one.stream()))))


def test_stream_and_collect_entry_points():
    aln, w, sm = make_input("vcf")
    cfg = DriverConfig(engine="xla", **CFG)
    want = _records(_session("vcf").stream())
    got = _records(stream_ld_records(aln, w, sm, cfg, device="cpu"))
    col = collect_ld_records(aln, w, sm, cfg, device="cpu",
                             devices=["cpu", "cpu"])
    for f in want:
        np.testing.assert_array_equal(got[f], want[f])
        np.testing.assert_array_equal(np.sort(getattr(col, f)),
                                      np.sort(want[f]))


# ---------------------------------------------------------------------------
# Refusals, the checkpoint, and the default engine
# ---------------------------------------------------------------------------


def test_bad_engine_raises():
    aln, w, sm = make_input("vcf")
    with pytest.raises(ValueError, match="engine must be auto|pallas|xla"):
        LdSession(aln, w, sm, DriverConfig(engine="bogus"), device="cpu")
    with pytest.raises(ValueError, match="got 'tiled'"):
        drv._resolve_engine("tiled")
    assert drv._resolve_engine("auto") == drv._resolve_engine("pallas") \
        == "pallas"
    assert drv.resolve_tile(None, "xla") == 128
    assert drv.resolve_tile(None) == drv.resolve_tile(None, "auto") == 256
    assert drv.resolve_tile(64, "xla") == 64


def test_site_major_input_raises_as_in_jax():
    _jax_mod, _mesh, jd = _jax()
    aln, w, sm = make_input("vcf")
    cfg = DriverConfig(engine="xla", tile=16)
    with pytest.raises(ValueError) as got:
        LdSession.required_padding(48, 200, cfg)
    with pytest.raises(ValueError) as want:
        jd.LdSession.required_padding(48, 200, jd.DriverConfig(
            engine="xla", tile=16))
    assert str(got.value) == str(want.value)
    s_pad, n_pad = LdSession.required_padding(48, 200, DriverConfig(tile=16))
    buf = np.full((s_pad, n_pad), 5, np.int8)
    buf[:200, :48] = aln.T
    with pytest.raises(ValueError, match="requires the pallas engine "
                       r"\(resolved engine: 'xla'\)"):
        LdSession(SiteMajorCodes(buf, 48, 200), w, sm, cfg, device="cpu")


def test_xla_on_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    aln, w, sm = make_input("vcf")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        LdSession(aln, w, sm, DriverConfig(engine="xla"), device="cuda")


def test_auto_batch_size_on_the_card():
    cuda = torch.device("cuda")
    # T = 128, N = 1,000: 45 B per row and site plus 512 B per pair.
    k = drv.resolve_xla_tiles_per_batch(None, 73920, 128, 1000, 0.1, cuda)
    assert k == (4 << 30) // (45 * 1000 * 128 + 512 * 128 * 128)
    assert drv.resolve_xla_tiles_per_batch(None, 10, 128, 1000, 0.1,
                                           cuda) == 10
    assert drv.resolve_xla_tiles_per_batch(None, 73920, 128, 1000, 0.1,
                                           torch.device("cpu")) == 8
    assert drv.resolve_xla_tiles_per_batch(5, 73920, 128, 1000, 0.1,
                                           cuda) == 5


class _Stop(Exception):
    pass


@pytest.mark.parametrize("suffix", (".tsv", ".tsv.gz"))
def test_checkpoint_resume_and_engine_refusal(tmp_path, monkeypatch, suffix):
    aln, w, sm = make_input("amb")
    cfg = DriverConfig(engine="xla", **CFG)
    full = tmp_path / f"full{suffix}"
    run_to_tsv(aln, w, sm, full, cfg, device="cpu")
    part = tmp_path / f"part{suffix}"
    orig = LdSession.stream

    def limited(self, *a, **kw):
        for n, item in enumerate(orig(self, *a, **kw), 1):
            yield item
            if n >= 4 and not kw.get("start_batch"):
                raise _Stop

    monkeypatch.setattr(LdSession, "stream", limited)
    with pytest.raises(_Stop):
        run_to_tsv(aln, w, sm, part, cfg, device="cpu")
    monkeypatch.setattr(LdSession, "stream", orig)
    ckpt = Path(str(part) + ".ckpt.json")
    state = json.loads(ckpt.read_text())
    assert state["next_batch"] == 4 and state["resolved"]["engine"] == "xla"
    # The same run under the kernels' engine is refused, naming xla.
    with pytest.raises(RuntimeError, match=r"engine=xla .*DriverConfig\("
                       r"engine='xla'\)"):
        run_to_tsv(aln, w, sm, part, DriverConfig(**CFG), device="cpu")
    run_to_tsv(aln, w, sm, part, cfg, device="cpu")
    assert part.read_bytes() == full.read_bytes()
    assert not ckpt.exists()
    # A kernel checkpoint resumed under engine="xla" names the default.
    kpart = tmp_path / f"kpart{suffix}"
    monkeypatch.setattr(LdSession, "stream", limited)
    with pytest.raises(_Stop):
        run_to_tsv(aln, w, sm, kpart, DriverConfig(**CFG), device="cpu")
    monkeypatch.setattr(LdSession, "stream", orig)
    with pytest.raises(RuntimeError, match=r"DriverConfig\(engine='pallas'"):
        run_to_tsv(aln, w, sm, kpart, cfg, device="cpu")


def _count_tile_stats_batch(monkeypatch) -> list:
    calls = []

    def counted(*a, **kw):
        calls.append(a[2].shape[0])
        return tile_stats_batch(*a, **kw)

    monkeypatch.setattr(drv, "tile_stats_batch", counted)
    return calls


@pytest.mark.parametrize("name", INPUTS)
def test_default_session_never_calls_tile_stats_batch(monkeypatch, name):
    calls = _count_tile_stats_batch(monkeypatch)
    aln, w, sm = make_input(name)
    sess = LdSession(aln, w, sm, DriverConfig(**CFG), device="cpu")
    assert sess.engine == "pallas"
    list(sess.stream())
    sess.summarize()
    assert calls == []
    xla = _session(name)
    list(xla.stream())
    xla.summarize()
    assert len(calls) == 2 * xla.n_batches


def test_cli_tiled_runs_resolve_to_pallas(tmp_path, monkeypatch):
    calls = _count_tile_stats_batch(monkeypatch)
    engines = []
    init = LdSession.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        engines.append(self.engine)

    monkeypatch.setattr(LdSession, "__init__", spy)
    aln, _w, _sm = make_input("amb")
    path = tmp_path / "amb.fasta"
    write_fasta(path, ["".join("ACGT-N"[c] for c in row) for row in aln])
    out = tmp_path / "pairs.tsv"
    for extra in ([], ["--stats-only"], ["--r2-hist", "0,0.5,1.01"]):
        assert cli.main(["--file", str(path), "--device", "cpu", "--engine",
                         "tiled", "--tile", "16", "--pair-output", str(out),
                         *extra]) == 0
    assert engines == ["pallas"] * 3 and calls == []


_WORKER = """
import json, sys
sys.path.insert(0, {repo!r})
pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from weightedld_tpu_torch.parallel import multihost
multihost.initialize_distributed(f"127.0.0.1:{{port}}", 2, pid)
from tests.test_torch_xla_engine import xla_outs
res = xla_outs(["cpu"], out + ".tsv")
with open(out + f".proc{{pid}}.json", "w") as fh:
    json.dump(res, fh)
"""


def xla_outs(devices, tsv: str) -> dict:
    """An XLA-engine session's read-outs on ``devices`` (this process's
    shards), and ``run_to_tsv`` into ``tsv`` (process 0 writes)."""
    aln, w, sm = make_input("amb")
    cfg = DriverConfig(engine="xla", tile=16, tiles_per_shard_batch=4)
    sess = LdSession(aln, w, sm, cfg, devices=devices)
    rows = [[int(a), int(b), float(r)] for _b, rec in sess.stream()
            for a, b, r in zip(rec.pos_a, rec.pos_b, rec.r2)]
    out = {"n_shards": sess.n_shards, "rows": rows,
           "summary": sess.summarize(r2_threshold=0.3),
           "decay": sess.ld_decay(DECAY)}
    out["n_tsv"] = run_to_tsv(aln, w, sm, tsv, cfg, devices=devices,
                              checkpoint=False)
    return out


def test_two_processes_equal_two_local_shards(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=str(REPO)))
    port = str(_free_port())
    base = str(tmp_path / "out")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), port, base],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_clean_env(), cwd=REPO) for pid in (0, 1)]
    for rc, _o, e in _wait_all(procs):
        assert rc == 0, e[-3000:]
    want = xla_outs(["cpu", "cpu"], str(tmp_path / "one.tsv"))
    for p in (0, 1):
        got = json.loads(Path(f"{base}.proc{p}.json").read_text())
        assert got == want
    assert Path(f"{base}.tsv").read_bytes() \
        == (tmp_path / "one.tsv").read_bytes()
    assert want["n_shards"] == 2 and want["n_tsv"] == len(want["rows"]) > 100
