"""Parity of the port's sharded sessions with the JAX package on a G-device
mesh, on the CPU.

* ``tile_pair_counts``, ``pairs_per_shard`` and ``stripe`` equal the JAX
  functions on the full, windowed, cross and permuted plans.
* Sessions: the port's ``LdSession(devices=["cpu"] * G)`` (the kernels'
  plain versions, G shards in one process) against the JAX ``LdSession``
  with ``DriverConfig(engine="pallas")`` on ``default_mesh(jax.devices()
  [:G])`` (interpret-mode Pallas kernels), G in {2, 3, 4}, on a factorized
  input, an input with UNKNOWN cells (packed, hybrid plan: both phases
  striped on their own) and a windowed plan whose shards carry uneven emit
  counts (``tests/test_multiprocess.py:68-79``).  The JAX side runs in a
  subprocess with G virtual CPU devices and FMA withheld from XLA's CPU
  backend (``XLA_FLAGS=--xla_cpu_max_isa=AVX``; tests/test_torch_slice.py).
* Launch order: in every batch of ``stream``, ``summarize``, ``ld_decay``,
  ``r2_histogram``, ``top_pairs`` and ``matrices``, a session dispatches
  all of its G local slices together, and every slice of batch b + 1
  before its first host read of batch b (an exact compaction or the wait
  for a copy to the host), on the hybrid plan at G = 1, 2 and 3.

Tolerances: TSV bytes, record order, counts, plans and prune sets exact;
float32 sums within rtol 1e-5 / atol 1e-6 (per-shard summation order);
streamed and top-k values within rtol 1e-5 / atol 1e-6.
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
from weightedld_tpu_torch.runtime import driver
from weightedld_tpu_torch.runtime.driver import (
    DriverConfig,
    LdSession,
    run_to_tsv,
)

REPO = Path(__file__).resolve().parent.parent
SHARDS = (2, 3, 4)
TILE, CHUNK = 16, 64
CASES = {"fact": {}, "amb": {},
         "win": {"max_site_distance": 40, "max_bp_distance": 500}}
DECAY_EDGES = (0, 20, 100, 400, 5000)
HIST_EDGES = (0.0, 0.05, 0.1, 0.3, 1.01)
TOP_K, PRUNE_THR, SUMMARY_THR = 12, 0.2, 0.05
RTOL, ATOL = 1e-5, 1e-6


def make_input(name: str):
    """``(alignment, weights, site_map)``: ``fact`` and ``win`` codes 0 / 1
    / 4 with LD between neighbours and irregular positions (the factorized
    kernel); ``amb`` the same with 14 UNKNOWN cells (packed, hybrid)."""
    rng = np.random.default_rng(17)
    n, s = 48, 160
    aln = rng.choice([0, 0, 0, 1, 1, 4], size=(n, s)).astype(np.int8)
    for c in range(1, s, 3):
        src = aln[:, c - 1].copy()
        flip = rng.random(n) < 0.1
        src[flip] = np.where(src[flip] == 0, 1, 0)
        aln[:, c] = src
    sm = np.cumsum(rng.integers(1, 60, size=s)).astype(np.int64) + 99
    w = (rng.random(n) + 0.05).astype(np.float32)
    if name == "amb":
        for c in rng.choice(s, size=14, replace=False):
            aln[rng.integers(n), c] = 5
    return aln, w, sm


def _cfg(name: str, **extra) -> dict:
    return dict(tile=TILE, seq_chunk=CHUNK, **CASES[name], **extra)


def _analytics(sess) -> dict:
    """Every read-out of one session, as JSON-able values."""
    rows = []
    for _b, rec in sess.stream():
        rows += [[int(a), int(b), float(d), float(dp), float(r2)]
                 for a, b, d, dp, r2 in zip(rec.pos_a, rec.pos_b, rec.d,
                                            rec.d_prime, rec.r2)]
    top = sess.top_pairs(TOP_K)
    mats = sess.matrices()
    keep = np.asarray(mats["keep"])
    return {
        "rows": rows,
        "summary": sess.summarize(r2_threshold=SUMMARY_THR),
        "decay": sess.ld_decay(DECAY_EDGES),
        "hist": sess.r2_histogram(HIST_EDGES),
        "top": [float(r) for r in top.r2],
        "prune": [int(p) for p in sess.prune(PRUNE_THR)],
        "keep": np.argwhere(keep).tolist(),
        "r2": [float(v) for v in np.asarray(mats["r2"])[keep]],
    }


def _jax_reference(out_dir: str, g: int) -> None:
    """Subprocess body: the JAX sessions of every case on a g-device
    mesh."""
    import jax

    from weightedld_tpu.parallel.sharded import default_mesh
    from weightedld_tpu.runtime.driver import DriverConfig as JCfg
    from weightedld_tpu.runtime.driver import LdSession as JSession
    from weightedld_tpu.runtime.driver import run_to_tsv as jrun_to_tsv

    mesh = default_mesh(jax.devices()[:g])
    out = Path(out_dir)
    meta = {}
    for name in CASES:
        aln, w, sm = make_input(name)
        jrun_to_tsv(aln, w, sm, out / f"jax_{name}_{g}.tsv",
                    JCfg(engine="pallas", **_cfg(name)), mesh=mesh,
                    checkpoint=False)
        sess = JSession(aln, w, sm, JCfg(engine="pallas", **_cfg(name)),
                        mesh=mesh)
        meta[name] = _analytics(sess)
    (out / f"meta_{g}.json").write_text(json.dumps(meta))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    procs = []
    for g in SHARDS:
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=("--xla_cpu_max_isa=AVX "
                              f"--xla_force_host_platform_device_count={g}"))
        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "from tests.test_torch_sharded import _jax_reference; "
                "_jax_reference(sys.argv[2], int(sys.argv[3]))")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(REPO), str(d), str(g)],
            env=env, cwd=REPO))
    try:
        for p in procs:
            assert p.wait(timeout=600) == 0
    finally:
        for p in procs:
            p.kill()
    return d, {g: json.loads((d / f"meta_{g}.json").read_text())
               for g in SHARDS}


def _session(name: str, g: int) -> LdSession:
    aln, w, sm = make_input(name)
    return LdSession(aln, w, sm, DriverConfig(**_cfg(name)),
                     devices=["cpu"] * g)


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

_SM = np.cumsum(np.random.default_rng(3).integers(0, 90, size=300))
_PERM = np.random.default_rng(4).permutation(300)
PLANS = {
    "full": lambda m: m.plan_tiles(300, 32),
    "window": lambda m: m.plan_tiles(300, 16, 40, max_bp_distance=900,
                                     site_map=_SM),
    "cross": lambda m: m.plan_tiles(300, 32, cross_split=128),
    "permuted": lambda m: m.plan_tiles_permuted(300, 32, 60, orig_idx=_PERM),
}


@pytest.mark.parametrize("g", (1, 2, 3, 4, 7))
@pytest.mark.parametrize("plan", list(PLANS))
def test_stripe_and_pairs_per_shard_equal_jax(plan, g):
    from weightedld_tpu.parallel import triangle as jtri

    got, want = PLANS[plan](tri), PLANS[plan](jtri)
    for a, b in zip(tri.stripe(got, g), jtri.stripe(want, g)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(tri.pairs_per_shard(got, g),
                                  jtri.pairs_per_shard(want, g))
    np.testing.assert_array_equal(tri.tile_pair_counts(got),
                                  jtri.tile_pair_counts(want))
    if plan == "full":
        assert tri.pairs_per_shard(got, g).sum() == got.n_pairs


# ---------------------------------------------------------------------------
# Sessions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("g", SHARDS)
@pytest.mark.parametrize("name", list(CASES))
def test_run_to_tsv_bytes_equal_jax(jax_ref, tmp_path, name, g):
    d, _meta = jax_ref
    aln, w, sm = make_input(name)
    out = tmp_path / "torch.tsv"
    n = run_to_tsv(aln, w, sm, out, DriverConfig(**_cfg(name)),
                   devices=["cpu"] * g, checkpoint=False)
    assert n > 100
    assert out.read_bytes() == (d / f"jax_{name}_{g}.tsv").read_bytes()


@pytest.mark.parametrize("g", SHARDS)
@pytest.mark.parametrize("name", list(CASES))
def test_session_read_outs_equal_jax(jax_ref, name, g):
    _d, meta = jax_ref
    want = meta[g][name]
    sess = _session(name, g)
    assert sess.n_shards == g and sess.n_local == g
    if name == "amb":
        assert sess.site_perm is not None
        assert sess.phase_tiles["general"] > 0 < sess.phase_tiles["majmin"]
    got = _analytics(sess)
    # Records: the same pairs in the same (global shard) order.
    assert [r[:2] for r in got["rows"]] == [r[:2] for r in want["rows"]]
    np.testing.assert_allclose(np.asarray(got["rows"])[:, 2:],
                               np.asarray(want["rows"])[:, 2:],
                               rtol=RTOL, atol=ATOL)
    for key in ("n_sequences", "n_sites", "n_pairs", "n_over_threshold"):
        assert got["summary"][key] == want["summary"][key], key
    for key in ("r2_sum_over_threshold", "r2_max"):
        assert got["summary"][key] == pytest.approx(
            want["summary"][key], rel=RTOL, abs=ATOL), key
    for key in ("n_pairs", "n_d_prime_finite"):
        assert got["decay"][key] == want["decay"][key], key
    for key in ("r2_sum", "abs_d_prime_sum"):
        np.testing.assert_allclose(got["decay"][key], want["decay"][key],
                                   rtol=RTOL, atol=ATOL)
    assert got["hist"] == want["hist"]
    np.testing.assert_allclose(got["top"], want["top"], rtol=RTOL,
                               atol=ATOL)
    assert got["prune"] == want["prune"]
    assert got["keep"] == want["keep"]
    np.testing.assert_allclose(got["r2"], want["r2"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("g", SHARDS)
def test_windowed_shards_carry_uneven_emit_counts(g):
    """The band plan hands the shards different real-tile counts, and the
    session's records are those of its one-shard run, as a set."""
    sess = _session("win", g)
    per_shard = sess.layout.phases[0].emit_host.sum(axis=1)
    assert len(set(per_shard.tolist())) > 1, per_shard
    assert per_shard.sum() == sess.plan.n_tiles
    rows = {(int(a), int(b), float(r)) for _b, rec in sess.stream()
            for a, b, r in zip(rec.pos_a, rec.pos_b, rec.r2)}
    one = {(int(a), int(b), float(r)) for _b, rec in _session("win", 1)
           .stream() for a, b, r in zip(rec.pos_a, rec.pos_b, rec.r2)}
    assert rows == one and rows


@pytest.mark.parametrize("name", list(CASES))
def test_one_shard_is_the_default_session(name):
    """``devices=["cpu"]`` is the default session: the same batches and
    records in the same order."""
    aln, w, sm = make_input(name)
    a = LdSession(aln, w, sm, DriverConfig(**_cfg(name)), device="cpu")
    b = _session(name, 1)
    assert (a.n_shards, a.n_batches) == (1, b.n_batches)
    ra = [(x.pos_a.tolist(), x.r2.tolist()) for _b, x in a.stream()]
    rb = [(x.pos_a.tolist(), x.r2.tolist()) for _b, x in b.stream()]
    assert ra == rb


def test_progress_counts_every_shard():
    sess = _session("win", 3)
    seen = []
    for _b, _rec in sess.stream(on_progress=seen.append):
        pass
    t2 = TILE * TILE
    assert seen[-1].pairs_done == seen[-1].pairs_total \
        == sess.plan.n_tiles * t2


READS = {
    "stream": lambda s: list(s.stream()),
    "summarize": lambda s: s.summarize(),
    "ld_decay": lambda s: s.ld_decay(DECAY_EDGES),
    "r2_histogram": lambda s: s.r2_histogram(HIST_EDGES),
    "top_pairs": lambda s: s.top_pairs(TOP_K),
    "matrices": lambda s: s.matrices(),
}


@pytest.mark.parametrize("method", list(READS))
@pytest.mark.parametrize("g", (1, 2, 3))
def test_every_shard_launches_before_the_first_read(monkeypatch, g, method):
    """The events of one read-out: ``dispatch`` of a slice, ``yield`` where
    the batch loop hands batch b to its reader, and the reads.  Without
    the reads they must be batch 0's and batch 1's G dispatches, then
    ``yield b`` after batch b + 1's G dispatches, then the last ``yield``:
    the slices of a batch launch together, in shard order, and batch
    b + 1's before anything of batch b is read.  Every read follows a
    ``yield`` (or another read), never a dispatch, and each batch is
    read."""
    sess = _session("amb", g)
    events = []
    dispatch = LdSession._dispatch
    pipelined = LdSession._pipelined

    def logged_dispatch(self, b, shard=0):
        events.append(("dispatch", b, shard))
        return dispatch(self, b, shard)

    def logged_pipelined(self, *a, **k):
        for b, launched in pipelined(self, *a, **k):
            events.append(("yield", b))
            yield b, launched

    def logged(name, fn):
        def wrapper(*a, **k):
            events.append((name,))
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(LdSession, "_dispatch", logged_dispatch)
    monkeypatch.setattr(LdSession, "_pipelined", logged_pipelined)
    monkeypatch.setattr(driver, "compact_tile_stats",
                        logged("compact", driver.compact_tile_stats))
    monkeypatch.setattr(driver, "_to_host",
                        logged("to_host", driver._to_host))
    READS[method](sess)
    n = sess.n_batches
    assert n > 2
    launches = lambda b: [("dispatch", b, sh) for sh in range(g)]
    want = launches(0)
    for b in range(1, n):
        want += launches(b) + [("yield", b - 1)]
    want.append(("yield", n - 1))
    assert [ev for ev in events if ev[0] in ("dispatch", "yield")] == want
    for prev, ev in zip([("start",)] + events, events):
        if ev[0] in ("compact", "to_host"):
            assert prev[0] in ("yield", "compact", "to_host"), (prev, ev)
        if prev[0] == "yield":
            assert ev[0] in ("compact", "to_host"), (prev, ev)
