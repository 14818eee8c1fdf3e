"""Parity of the port's windowed and inter-region LD with the JAX package,
on the CPU.

* Plans: ``plan_tiles`` (site-index band, bp band, both, cross rectangle),
  ``plan_tiles_permuted`` and their validation messages equal the JAX
  functions' arrays and messages; ``_windowed_packing_pays`` equals JAX's.
* Sessions: the port's ``LdSession(device="cpu")`` (the kernels' plain
  versions) against the JAX ``LdSession`` with ``DriverConfig(engine=
  "pallas")`` on a one-device mesh (interpret-mode Pallas kernels), run in
  a subprocess with ``XLA_FLAGS=--xla_cpu_max_isa=AVX`` (no FMA; see
  tests/test_torch_slice.py): TSV bytes, the plan, the packing
  permutation, the safe/unsafe split and ``summarize`` for
  ``max_site_distance``, ``max_bp_distance``, both, and ``cross_split``
  on a VCF-like input (the factorized kernel), and on an input with
  UNKNOWN cells (windowed-packed under each window, hybrid and unpacked
  under ``cross_split``); every analytics method under a bp window, under
  a packed site window and under ``cross_split``; and the packing of the
  JAX package's own cases (``tests/test_pallas_ld.py:675-805``).
* The JAX package's driver cases (``tests/test_driver.py:199, 653-715,
  831, 1102-1190``) rerun on the port against its own full-triangle run.

Tolerances: TSV bytes, plans, permutations and counts exact; float32 sums
within rtol 1e-5 (per-batch summation order); records of a packed session
against the full run as a set, values within rtol 2e-5 / atol 1e-6 (the
packing can flip a pair's in-kernel orientation).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from weightedld_tpu_torch.parallel import triangle as tri
from weightedld_tpu_torch.runtime import driver as drv
from weightedld_tpu_torch.runtime.driver import (
    DriverConfig,
    LdSession,
    run_to_tsv,
)

from .fixtures import random_alignment

REPO = Path(__file__).resolve().parent.parent
CHUNK = 64


def make_input(name: str):
    """``(alignment, weights, site_map, tile)``: ``vcf`` codes 0 / 1 / 4
    with irregular positions (the factorized kernel); ``amb`` the JAX
    windowed-packing case (64 x 160, 14 sites with one UNKNOWN cell)."""
    rng = np.random.default_rng(41)
    if name == "vcf":
        n, s = 60, 200
        aln = rng.choice([0, 0, 0, 1, 1, 4], size=(n, s)).astype(np.int8)
        for c in range(1, s, 3):          # LD: a mutated copy of a neighbour
            src = aln[:, c - 1].copy()
            flip = rng.random(n) < 0.1
            src[flip] = np.where(src[flip] == 0, 1, 0)
            aln[:, c] = src
        sm = np.cumsum(rng.integers(1, 60, size=s)).astype(np.int64) + 99
        return aln, (rng.random(n) + 0.05).astype(np.float32), sm, 32
    n, s = 64, 160
    aln = rng.choice([0, 0, 1, 1, 1], size=(n, s)).astype(np.int8)
    for c in rng.choice(s, size=14, replace=False):
        aln[rng.integers(n), c] = 5
    return aln, (rng.random(n) + 0.05).astype(np.float32), \
        np.arange(s) * 3 + 7, 16


WINDOWS = {"site": {"max_site_distance": 40},
           "bp": {"max_bp_distance": 700},
           "both": {"max_site_distance": 50, "max_bp_distance": 900},
           "cross": {"cross_split": 90}}
AMB_WINDOWS = {"site": {"max_site_distance": 60},
               "bp": {"max_bp_distance": 150},
               "both": {"max_site_distance": 70, "max_bp_distance": 180},
               "cross": {"cross_split": 70}}
CASES = [(name, w) for name in ("vcf", "amb") for w in WINDOWS]
ANALYTICS_CASES = [("vcf", "bp"), ("amb", "site"), ("vcf", "cross")]
DECAY_EDGES = (0, 20, 100, 400, 2000)
HIST_EDGES = (0.0, 0.05, 0.1, 0.3, 1.01)
TOP_K, PRUNE_THR = 15, 0.2


def case_cfg(name: str, window: str, **extra) -> dict:
    """DriverConfig fields of a case (both packages take them)."""
    win = (WINDOWS if name == "vcf" else AMB_WINDOWS)[window]
    return dict(tile=make_input(name)[3], seq_chunk=CHUNK, **win, **extra)


def _analytics(sess) -> dict:
    """Every analytics method of one session, as JSON-able values."""
    top = sess.top_pairs(TOP_K)
    mats = sess.matrices()
    keep = np.asarray(mats["keep"])
    return {
        "summary": sess.summarize(r2_threshold=0.05),
        "decay": sess.ld_decay(DECAY_EDGES),
        "hist": sess.r2_histogram(HIST_EDGES),
        "top": [[int(a), int(b), float(r2)]
                for a, b, r2 in zip(top.pos_a, top.pos_b, top.r2)],
        "prune": [int(p) for p in sess.prune(PRUNE_THR)],
        "prune_first": [int(p) for p in sess.prune(PRUNE_THR,
                                                   rule="first")],
        "keep": np.argwhere(keep).tolist(),
        "r2": [float(v) for v in np.asarray(mats["r2"])[keep]],
    }


def _own_packing_cases():
    """The JAX package's packing cases (``tests/test_pallas_ld.py:
    675-805``, rng seed 0): ``(name, alignment, site_map, cfg fields)``."""
    rng = np.random.default_rng(0)
    aln = rng.choice([0, 0, 1, 1, 1], size=(32, 64)).astype(np.int8)
    aln[3, 10] = 5
    aln[9, 40] = 5
    out = [("order", aln, np.arange(64),
            dict(tile=16, seq_chunk=32, max_site_distance=20))]
    rng = np.random.default_rng(0)
    aln = rng.choice([0, 0, 1, 1, 1], size=(64, 160)).astype(np.int8)
    for s in rng.choice(160, size=14, replace=False):
        aln[rng.integers(64), s] = 5
    for i, kw in enumerate(({"max_site_distance": 60},
                            {"max_bp_distance": 150},
                            {"max_site_distance": 70,
                             "max_bp_distance": 180})):
        out.append((f"parity{i}", aln, np.arange(160) * 3 + 7,
                    dict(tile=16, seq_chunk=64, **kw)))
    rng = np.random.default_rng(0)
    aln = rng.choice([0, 0, 1, 1, 1], size=(48, 128)).astype(np.int8)
    for s in rng.choice(128, size=40, replace=False):
        aln[rng.integers(48), s] = 5
    out.append(("dense-dirt", aln, np.arange(128),
                dict(tile=16, seq_chunk=64, max_site_distance=32)))
    return out


def _jax_reference(out_dir: str) -> None:
    """Subprocess body: the JAX sessions' TSVs, plans, packing, summaries
    and analytics."""
    import jax

    from weightedld_tpu.parallel.sharded import default_mesh
    from weightedld_tpu.runtime.driver import DriverConfig as JCfg
    from weightedld_tpu.runtime.driver import LdSession as JSession
    from weightedld_tpu.runtime.driver import run_to_tsv as jrun_to_tsv

    mesh = default_mesh(jax.devices()[:1])
    out = Path(out_dir)
    meta = {"cases": {}, "analytics": {}, "own": {}}
    for name, window in CASES:
        aln, w, sm, _t = make_input(name)
        cfg = case_cfg(name, window)
        jrun_to_tsv(aln, w, sm, out / f"jax_{name}_{window}.tsv",
                    JCfg(engine="pallas", **cfg), mesh=mesh,
                    checkpoint=False)
        sess = JSession(aln, w, sm, JCfg(engine="pallas", r2_threshold=0.05,
                                         **cfg), mesh=mesh)
        meta["cases"][f"{name}_{window}"] = {
            "summary": sess.summarize(),
            "tile_i": sess.plan.tile_i.tolist(),
            "tile_j": sess.plan.tile_j.tolist(),
            "site_perm": (None if sess._site_perm is None
                          else sess._site_perm.tolist()),
            "windowed_packed": bool(sess._windowed_packed),
            "hybrid_safe": (None if sess._hybrid_safe is None
                            else sess._hybrid_safe.tolist()),
        }
        if (name, window) in ANALYTICS_CASES:
            meta["analytics"][f"{name}_{window}"] = _analytics(sess)
    for name, aln, sm, kw in _own_packing_cases():
        sess = JSession(aln, np.ones(aln.shape[0], np.float32), sm,
                        JCfg(engine="pallas", **kw), mesh=mesh)
        meta["own"][name] = {
            "site_perm": (None if sess._site_perm is None
                          else sess._site_perm.tolist()),
            "windowed_packed": bool(sess._windowed_packed),
            "n_tiles": int(sess.plan.n_tiles),
        }
    (out / "meta.json").write_text(json.dumps(meta))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("windows")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_windows import _jax_reference; "
            "_jax_reference(sys.argv[2])")
    subprocess.run([sys.executable, "-c", code, str(REPO), str(d)],
                   env=env, check=True, timeout=900, cwd=REPO)
    return d, json.loads((d / "meta.json").read_text())


def _session(name: str, window: str, **extra) -> LdSession:
    aln, w, sm, _t = make_input(name)
    return LdSession(aln, w, sm, DriverConfig(**case_cfg(name, window,
                                                         **extra)),
                     device="cpu")


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

_SM = np.cumsum(np.random.default_rng(3).integers(0, 90, size=300))
PLAN_CASES = [
    dict(n_sites=300, tile=32),
    dict(n_sites=300, tile=32, max_site_distance=1),
    dict(n_sites=300, tile=32, max_site_distance=33),
    dict(n_sites=257, tile=16, max_site_distance=100),
    dict(n_sites=300, tile=32, max_bp_distance=0, site_map=_SM),
    dict(n_sites=300, tile=32, max_bp_distance=900, site_map=_SM),
    dict(n_sites=300, tile=16, max_bp_distance=4000, site_map=_SM),
    dict(n_sites=300, tile=32, max_site_distance=40, max_bp_distance=1500,
         site_map=_SM),
    dict(n_sites=70, tile=16, cross_split=37),
    dict(n_sites=300, tile=32, cross_split=1),
    dict(n_sites=300, tile=32, cross_split=299),
    dict(n_sites=300, tile=32, cross_split=128),
]


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_plan_tiles_equals_jax(case):
    from weightedld_tpu.parallel import triangle as jtri

    kw = PLAN_CASES[case]
    got, want = tri.plan_tiles(**kw), jtri.plan_tiles(**kw)
    for f in ("n_sites", "tile", "s_pad", "grid", "n_tiles"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.tile_i, want.tile_i)
    np.testing.assert_array_equal(got.tile_j, want.tile_j)
    assert got.tile_i.dtype == np.int32


def _perm_of(seed: int, n: int, n_dirty: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    dirty = np.zeros(n, bool)
    dirty[rng.choice(n, size=n_dirty, replace=False)] = True
    return np.concatenate([np.flatnonzero(~dirty), np.flatnonzero(dirty)])


PERMUTED_CASES = [
    dict(n_sites=300, tile=32, max_site_distance=40,
         orig_idx=_perm_of(1, 300, 9)),
    dict(n_sites=257, tile=16, max_site_distance=5,
         orig_idx=_perm_of(2, 257, 30)),
    dict(n_sites=300, tile=32, max_bp_distance=900,
         site_map=_SM[_perm_of(1, 300, 9)]),
    dict(n_sites=300, tile=32, max_site_distance=60, max_bp_distance=2000,
         orig_idx=_perm_of(4, 300, 12), site_map=_SM[_perm_of(4, 300, 12)]),
    dict(n_sites=200, tile=16, max_site_distance=25,
         orig_idx=np.arange(200)),
]


@pytest.mark.parametrize("case", range(len(PERMUTED_CASES)))
def test_plan_tiles_permuted_equals_jax(case):
    from weightedld_tpu.parallel import triangle as jtri

    kw = PERMUTED_CASES[case]
    got, want = tri.plan_tiles_permuted(**kw), jtri.plan_tiles_permuted(**kw)
    assert (got.s_pad, got.grid) == (want.s_pad, want.grid)
    np.testing.assert_array_equal(got.tile_i, want.tile_i)
    np.testing.assert_array_equal(got.tile_j, want.tile_j)


def test_permuted_plan_of_identity_is_the_band():
    kw = dict(n_sites=200, tile=16, max_site_distance=25)
    band = tri.plan_tiles(**kw)
    perm = tri.plan_tiles_permuted(orig_idx=np.arange(200), **kw)
    np.testing.assert_array_equal(band.tile_i, perm.tile_i)
    np.testing.assert_array_equal(band.tile_j, perm.tile_j)


@pytest.mark.parametrize("fn,kw", [
    ("plan_tiles", dict(n_sites=1, tile=16)),
    ("plan_tiles", dict(n_sites=70, tile=16, cross_split=0)),
    ("plan_tiles", dict(n_sites=70, tile=16, cross_split=70)),
    ("plan_tiles", dict(n_sites=70, tile=16, max_bp_distance=5,
                        site_map=np.arange(69))),
    ("plan_tiles_permuted", dict(n_sites=70, tile=16, max_site_distance=5)),
    ("plan_tiles_permuted", dict(n_sites=70, tile=16, max_bp_distance=5,
                                 site_map=np.arange(71))),
])
def test_plan_validation_messages_equal_jax(fn, kw):
    from weightedld_tpu.parallel import triangle as jtri

    with pytest.raises(ValueError) as want:
        getattr(jtri, fn)(**kw)
    with pytest.raises(ValueError) as got:
        getattr(tri, fn)(**kw)
    assert str(got.value) == str(want.value)


GATE_CASES = [
    (14, 160, dict(max_site_distance=60), None),
    (40, 128, dict(max_site_distance=32), None),
    (16, 128, dict(max_site_distance=32), None),
    (14, 160, dict(max_bp_distance=150), "linear"),
    (30, 160, dict(max_bp_distance=150), "linear"),
    (5, 300, dict(max_bp_distance=900), "irregular"),
    (14, 160, dict(max_site_distance=70, max_bp_distance=180), "linear"),
    (3, 100, dict(max_bp_distance=10), "decreasing"),
]


@pytest.mark.parametrize("case", range(len(GATE_CASES)))
def test_windowed_packing_pays_equals_jax(case):
    from weightedld_tpu.runtime import driver as jdrv

    n_dirty, n, win, kind = GATE_CASES[case]
    bad = np.zeros(n, bool)
    bad[np.random.default_rng(case).choice(n, n_dirty, replace=False)] = True
    sm = {None: np.arange(n), "linear": np.arange(n) * 3 + 7,
          "irregular": _SM[:n], "decreasing": np.arange(n)[::-1].copy()}[kind]
    got = drv._windowed_packing_pays(bad, DriverConfig(**win), sm, n)
    want = jdrv._windowed_packing_pays(bad, jdrv.DriverConfig(**win), sm, n)
    assert got == want


# ---------------------------------------------------------------------------
# Sessions against the JAX sessions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,window", CASES)
def test_session_tsv_bytes_equal_jax(jax_ref, tmp_path, name, window):
    d, _meta = jax_ref
    aln, w, sm, _t = make_input(name)
    out = tmp_path / "port.tsv"
    n = run_to_tsv(aln, w, sm, out, DriverConfig(**case_cfg(name, window)),
                   device="cpu")
    assert n > 100
    assert out.read_bytes() == (d / f"jax_{name}_{window}.tsv").read_bytes()


@pytest.mark.parametrize("name,window", CASES)
def test_session_plan_and_packing_equal_jax(jax_ref, name, window):
    want = jax_ref[1]["cases"][f"{name}_{window}"]
    sess = _session(name, window)
    assert sess.plan.tile_i.tolist() == want["tile_i"]
    assert sess.plan.tile_j.tolist() == want["tile_j"]
    assert (None if sess.site_perm is None
            else sess.site_perm.tolist()) == want["site_perm"]
    assert sess.windowed_packed == want["windowed_packed"]
    assert (None if sess.hybrid_safe is None
            else sess.hybrid_safe.tolist()) == want["hybrid_safe"]
    # The windowed packing engages under every window of the UNKNOWN
    # input; the cross session never packs but still splits by tile pair.
    if name == "amb":
        assert sess.windowed_packed == (window != "cross")
        assert sess.hybrid_safe is not None
    if window == "cross":
        assert sess.site_perm is None


@pytest.mark.parametrize("name,window", CASES)
def test_session_summarize_equals_jax(jax_ref, name, window):
    want = jax_ref[1]["cases"][f"{name}_{window}"]["summary"]
    got = _session(name, window, r2_threshold=0.05).summarize()
    for key in ("n_sequences", "n_sites", "n_pairs", "n_over_threshold"):
        assert got[key] == want[key], key
    assert got["r2_max"] == want["r2_max"]
    assert got["r2_sum_over_threshold"] == pytest.approx(
        want["r2_sum_over_threshold"], rel=1e-5)


@pytest.mark.parametrize("name,window", ANALYTICS_CASES)
def test_analytics_equal_jax(jax_ref, name, window):
    want = jax_ref[1]["analytics"][f"{name}_{window}"]
    got = json.loads(json.dumps(_analytics(_session(name, window))))
    for key in ("n_pairs", "n_over_threshold", "r2_max"):
        assert got["summary"][key] == want["summary"][key], key
    for part in ("decay", "hist"):
        for key, val in want[part].items():
            if key in ("r2_sum", "abs_d_prime_sum", "r2_mean",
                       "abs_d_prime_mean"):
                np.testing.assert_allclose(
                    np.array(got[part][key], float),
                    np.array(val, float), rtol=1e-5, err_msg=key)
            else:
                assert got[part][key] == val, (part, key)
    # Top-k: the set of rows strictly above the k-th value, and the
    # multiset of values (the order of equal values, and which pairs tie at
    # the k-th value, are arbitrary).
    kth = want["top"][-1][2]
    assert sorted(r for r in got["top"] if r[2] > kth) == \
        sorted(r for r in want["top"] if r[2] > kth)
    assert sorted(r[2] for r in got["top"]) == \
        sorted(r[2] for r in want["top"])
    assert got["prune"] == want["prune"]
    assert got["prune_first"] == want["prune_first"]
    assert got["keep"] == want["keep"]
    assert got["r2"] == want["r2"]


@pytest.mark.parametrize("case", range(5))
def test_own_packing_cases_equal_jax(jax_ref, case):
    name, aln, sm, kw = _own_packing_cases()[case]
    want = jax_ref[1]["own"][name]
    sess = LdSession(aln, np.ones(aln.shape[0], np.float32), sm,
                     DriverConfig(**kw), device="cpu")
    assert (None if sess.site_perm is None
            else sess.site_perm.tolist()) == want["site_perm"]
    assert sess.windowed_packed == want["windowed_packed"]
    assert sess.plan.n_tiles == want["n_tiles"]
    if name == "order":
        clean = [s for s in range(64) if s not in (10, 40)]
        assert sess.site_perm.tolist() == clean + [10, 40]
    if name == "dense-dirt":       # 2 * 40 dirty sites > a 32-site window
        assert not sess.windowed_packed and sess.site_perm is None


# ---------------------------------------------------------------------------
# The JAX package's driver cases, on the port against its own full run
# ---------------------------------------------------------------------------


def _records(aln, w, sm, **cfg) -> dict:
    sess = LdSession(aln, w, sm, DriverConfig(**cfg), device="cpu")
    out = {}
    for _b, rec in sess.stream():
        for a, b, d, dp, r2 in zip(rec.pos_a, rec.pos_b, rec.d, rec.d_prime,
                                   rec.r2):
            out[(int(a), int(b))] = (float(d), float(dp), float(r2))
    return out


def _assert_records(got: dict, want: dict) -> None:
    """Same pair set, values within rtol 2e-5 / atol 1e-6: inputs with
    UNKNOWN cells pack differently under a window than in the full run,
    which can flip a pair's in-kernel orientation."""
    assert set(got) == set(want) and want
    for key, vals in want.items():
        np.testing.assert_allclose(got[key], vals, rtol=2e-5, atol=1e-6,
                                   err_msg=str(key))


def test_windowed_ld(rng):
    aln = random_alignment(rng, 30, 100)
    w = np.ones(30, dtype=np.float32)
    sm = np.arange(100)
    full = _records(aln, w, sm, tile=16)
    win = _records(aln, w, sm, tile=16, max_site_distance=20)
    _assert_records(win, {k: v for k, v in full.items()
                          if k[1] - k[0] <= 20})


@pytest.mark.parametrize("window", [40, 150, 100000])
def test_bp_window_matches_brute_force(rng, window):
    aln = random_alignment(rng, 30, 96)
    w = (rng.random(30) + 0.05).astype(np.float32)
    sm = np.cumsum(rng.integers(1, 60, size=96)).astype(np.int64)
    full = _records(aln, w, sm, tile=16)
    sess = LdSession(aln, w, sm, DriverConfig(
        tile=16, max_bp_distance=window, tiles_per_shard_batch=2),
        device="cpu")
    got = {}
    for _b, rec in sess.stream():
        got.update({(int(a), int(b)): float(r2)
                    for a, b, r2 in zip(rec.pos_a, rec.pos_b, rec.r2)})
    want = {k: v[2] for k, v in full.items() if k[1] - k[0] <= window}
    _assert_records(got, want)
    assert sess.summarize()["n_pairs"] == len(want)


def test_bp_window_composes_with_index_window(rng):
    aln = random_alignment(rng, 25, 80)
    w = np.ones(25, dtype=np.float32)
    sm = np.cumsum(rng.integers(1, 30, size=80)).astype(np.int64)
    idx = {int(p): i for i, p in enumerate(sm)}
    full = _records(aln, w, sm, tile=16)
    got = _records(aln, w, sm, tile=16, max_site_distance=20,
                   max_bp_distance=120)
    _assert_records(got, {k: v for k, v in full.items()
                          if k[1] - k[0] <= 120
                          and idx[k[1]] - idx[k[0]] <= 20})


def test_bp_window_rejects_decreasing_site_map(rng):
    aln = random_alignment(rng, 10, 20)
    with pytest.raises(ValueError, match="non-decreasing"):
        LdSession(aln, np.ones(10, np.float32), np.arange(20)[::-1].copy(),
                  DriverConfig(tile=16, max_bp_distance=5), device="cpu")
    with pytest.raises(ValueError, match="fit int32"):
        LdSession(aln, np.ones(10, np.float32), np.arange(20) + 2**31,
                  DriverConfig(tile=16, max_bp_distance=5), device="cpu")


def test_prune_windowed(rng):
    aln = random_alignment(rng, 24, 60)
    w = np.ones(24, dtype=np.float32)
    sm = np.arange(60)
    sess = LdSession(aln, w, sm, DriverConfig(tile=16, max_site_distance=8),
                     device="cpu")
    kept = set(int(p) for p in sess.prune(0.3))
    for (a, b), (_d, _dp, r2) in _records(aln, w, sm, tile=16).items():
        if b - a <= 8 and a in kept and b in kept:
            assert r2 <= 0.3


def test_plan_tiles_cross_split():
    plan = tri.plan_tiles(70, tile=16, cross_split=37)
    assert set(plan.tile_i.tolist()) <= {0, 1, 2}
    assert set(plan.tile_j.tolist()) <= {2, 3, 4}
    assert len(plan.tile_i) == 9
    assert tri.plan_tiles(70, tile=16).n_tiles == 15


@pytest.mark.parametrize("seed", [2, 5])
def test_cross_split_matches_the_full_rectangle(seed):
    rng = np.random.default_rng(seed)
    aln = random_alignment(rng, 32, 70, p_gap=0.03, p_unknown=0.02)
    w = rng.random(32).astype(np.float32) + 0.1
    sm = np.arange(70, dtype=np.int64) * 7
    full = _records(aln, w, sm, tile=16, seq_chunk=128)
    got = _records(aln, w, sm, tile=16, seq_chunk=128, cross_split=37)
    _assert_records(got, {k: v for k, v in full.items()
                          if k[0] < sm[37] <= k[1]})


def test_cross_split_analytics_inherit_rectangle(rng):
    aln = random_alignment(rng, 30, 64, p_gap=0.02, p_unknown=0.0)
    w = np.ones(30, np.float32)
    sm = np.arange(64, dtype=np.int64)
    full = _records(aln, w, sm, tile=16)
    n_rect = sum(1 for a, b in full if a < 20 <= b)
    s = LdSession(aln, w, sm, DriverConfig(tile=16, cross_split=20),
                  device="cpu")
    assert s.summarize()["n_pairs"] == n_rect
    tp = s.top_pairs(7)
    assert all(pa < 20 <= pb for pa, pb in zip(tp.pos_a.tolist(),
                                               tp.pos_b.tolist()))
    assert sum(s.r2_histogram((0.0, 0.5, 1.01))["n_pairs"]) == n_rect
    assert sum(s.ld_decay((0, 10, 100))["n_pairs"]) == n_rect
    ij = np.argwhere(s.matrices()["keep"])
    assert len(ij) == n_rect
    assert (ij[:, 0] < 20).all() and (ij[:, 1] >= 20).all()


@pytest.mark.parametrize("kw,match", [
    (dict(cross_split=20), "cross_split must be in"),
    (dict(cross_split=0), "cross_split must be in"),
    (dict(cross_split=5, max_site_distance=3), "window flags"),
    (dict(cross_split=5, max_bp_distance=3), "window flags"),
])
def test_cross_split_validations_equal_jax(rng, kw, match):
    from weightedld_tpu.runtime.driver import DriverConfig as JCfg
    from weightedld_tpu.runtime.driver import LdSession as JSession

    aln = random_alignment(rng, 10, 20)
    w, sm = np.ones(10, np.float32), np.arange(20, dtype=np.int64)
    with pytest.raises(ValueError, match=match) as got:
        LdSession(aln, w, sm, DriverConfig(**kw), device="cpu")
    with pytest.raises(ValueError) as want:
        JSession(aln, w, sm, JCfg(engine="xla", **kw))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("window", ["site", "bp", "both"])
def test_unpacked_window_is_the_filtered_full_run_in_order(tmp_path, window):
    """An unpacked windowed plan is a row-major subset of the full plan:
    its TSV is the full TSV's rows, filtered, in the same order."""
    aln, w, sm, tile = make_input("vcf")
    cfg = case_cfg("vcf", window)
    out_w, out_f = tmp_path / "w.tsv", tmp_path / "f.tsv"
    run_to_tsv(aln, w, sm, out_w, DriverConfig(**cfg), device="cpu")
    run_to_tsv(aln, w, sm, out_f, DriverConfig(tile=tile, seq_chunk=CHUNK),
               device="cpu")
    idx = {int(p): i for i, p in enumerate(sm)}
    site_w = cfg.get("max_site_distance", 1 << 40)
    bp_w = cfg.get("max_bp_distance", 1 << 40)
    lines = out_f.read_text().splitlines(keepends=True)
    want = [ln for ln in lines[1:]
            if int(ln.split("\t")[1]) - int(ln.split("\t")[0]) <= bp_w
            and idx[int(ln.split("\t")[1])] - idx[int(ln.split("\t")[0])]
            <= site_w]
    assert out_w.read_text() == lines[0] + "".join(want)


@pytest.mark.parametrize("window", ["site", "bp", "both"])
def test_windowed_packing_equals_forced_general(window):
    """The windowed packing (interval plan, |distance| lookup masks) gives
    the forced-general windowed run's records, summarize and decay
    (``tests/test_pallas_ld.py:693-772``)."""
    aln, w, sm, _t = make_input("amb")
    cfg = case_cfg("amb", window)
    packed = LdSession(aln, w, sm, DriverConfig(**cfg), device="cpu")
    base = LdSession(aln, w, sm, DriverConfig(kernel="general", **cfg),
                     device="cpu")
    assert packed.windowed_packed and base.site_perm is None
    _assert_records(_records(aln, w, sm, **cfg),
                    _records(aln, w, sm, kernel="general", **cfg))
    assert packed.summarize()["n_pairs"] == base.summarize()["n_pairs"]
    assert packed.ld_decay(DECAY_EDGES)["n_pairs"] == \
        base.ld_decay(DECAY_EDGES)["n_pairs"]
