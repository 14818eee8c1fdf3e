"""The port's record transport against the JAX package's, on the CPU.

* ``round_fixed_exact`` equals the JAX ``round_fixed_exact``, and
  ``round_decimals`` (the rounding of ``stream(decimals=d)``) CPython's
  ``round(x, d)`` and the values JAX's wire decoder yields, on JAX's
  adversarial sweep (``tests/test_driver.py:395-426``: half-ties,
  near-ties at 1e-7 and 1e-9, tiny negatives, signed zeros, randoms) at
  every d in 0..4.
* ``compact_fixed`` (the speculative compaction) equals the exact
  ``compact_tile_stats`` row for row, under and over its capacity, with
  and without rounding.
* ``LdSession.stream(decimals=d)`` writes the bytes of ``stream()``
  formatted at d digits (d = 3, 4) across repeated scans, on a factorized,
  a hybrid, a windowed-packed and a G = 2 session, and the JAX session's
  ``stream(decimals=4)`` bytes (``tests/test_driver.py:428-465``).
* Capacity: poisoned capacities fall back to the exact path with the same
  bytes (``:238-266``); the capacity is learned, grows under a denser
  threshold, shrinks after a high-yield scan and turns off beyond
  ``_SPEC_CAP_MAX`` (``:977-1014``, ``:1049-1076``); ``decimals`` outside
  0..4 raises; a plan of T > 512 (beyond JAX's wire) rounds as well.
* ``run_to_tsv`` (which streams at ``decimals=ndigits``) interrupted and
  resumed under ``checkpoint`` writes the uninterrupted bytes.

The JAX side runs in a subprocess with ``XLA_FLAGS=--xla_cpu_max_isa=AVX``
and its session on the interpret-mode Pallas kernels, as in
tests/test_torch_checkpoint.py.  Tolerances: none; bytes, integers and
float32 bits are compared exactly.
"""

from __future__ import annotations

import io
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import quantizer_sweep as sweep
from weightedld_tpu_torch.core.ld_tiled import (
    compact_fixed,
    compact_tile_stats,
    decode_block,
    round_decimals,
    round_fixed_exact,
    threshold_mask,
)
from weightedld_tpu_torch.core.paircore import PairStats
from weightedld_tpu_torch.io.writer import write_pairs
from weightedld_tpu_torch.runtime import driver
from weightedld_tpu_torch.runtime.driver import (
    DriverConfig,
    LdSession,
    run_to_tsv,
    stream_ld_records,
)

from .fixtures import random_alignment
from .test_torch_sharded import make_input as sharded_input
from .test_torch_windows import AMB_WINDOWS
from .test_torch_windows import make_input as windows_input

REPO = Path(__file__).resolve().parent.parent
# The JAX parity input: 30 x 96 random codes with gaps and 5 % UNKNOWN
# cells (a hybrid plan), tile 16, one device.
JAX_SHAPE, JAX_TILE = (30, 96), 16
# The D quantum of JAX's wire that stands for -0.0 (``neg_zero_sentinel``).
JAX_NEG_ZERO = -(1 << 15)


def jax_input():
    rng = np.random.default_rng(5)
    n, s = JAX_SHAPE
    aln = random_alignment(rng, n, s)
    w = (rng.random(n) * 0.9 + 0.1).astype(np.float32)
    return aln, w, np.arange(s) * 7 + 11


def _jax_reference(out_dir: str) -> None:
    """Subprocess body: the JAX quantizer on each sweep, and the JAX
    session's ``stream(decimals=4)`` TSV."""
    import jax
    import jax.numpy as jnp

    import weightedld_tpu.runtime.driver as jd
    from weightedld_tpu.core.ld_tiled import round_fixed_exact as jround
    from weightedld_tpu.io.writer import write_pairs as jwrite
    from weightedld_tpu.parallel.sharded import default_mesh

    d = Path(out_dir)
    np.savez(d / "quanta.npz", **{
        str(dd): np.asarray(jround(jnp.asarray(sweep(dd)), 10 ** dd,
                                   neg_zero_sentinel=True))
        for dd in range(5)})
    resolve = jd._resolve_engine
    jd._resolve_engine = lambda engine, platform=None: (
        "pallas" if engine == "auto" else resolve(engine, platform))
    aln, w, sm = jax_input()
    sess = jd.LdSession(aln, w, sm, jd.DriverConfig(
        engine="pallas", tile=JAX_TILE, seq_chunk=64),
        default_mesh(jax.devices()[:1]))
    for scan in range(2):        # the second scan at learned capacities
        buf = io.StringIO()
        for _b, rec in sess.stream(decimals=4):
            jwrite(rec, buf, header=False)
        (d / f"jax_{scan}.tsv").write_text(buf.getvalue())


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("transport")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_transport import _jax_reference; "
            "_jax_reference(sys.argv[2])")
    subprocess.run([sys.executable, "-c", code, str(REPO), str(d)],
                   env=env, check=True, timeout=600, cwd=REPO)
    return d


def _decoded(q: np.ndarray, d: int) -> np.ndarray:
    """The float32 D values JAX's wire decoder gives quanta ``q``
    (``_records_from_wire3``)."""
    return np.where(q == JAX_NEG_ZERO, np.float32(-0.0),
                    (q.astype(np.int64) / 10 ** d).astype(np.float32))


# ---------------------------------------------------------------------------
# The quantizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", range(5))
def test_round_fixed_exact_equals_cpython_round(d):
    x = sweep(d)
    q = round_fixed_exact(torch.from_numpy(x), 10 ** d).numpy()
    assert q.dtype == np.int32
    dec = round_decimals(torch.from_numpy(x), 10 ** d).numpy()
    assert dec.dtype == np.float32
    # The rounded value, formatted (the writer's view), and the quantum
    # over 10^d in float64 with x's sign, both Python's round.
    bad = [i for i in range(len(x))
           if repr(round(float(dec[i]), d)) != repr(round(float(x[i]), d))
           or repr(math.copysign(int(q[i]) / 10 ** d, x[i]))
           != repr(round(float(x[i]), d))]
    assert not bad, (d, x[bad[0]], q[bad[0]])
    np.testing.assert_array_equal(
        dec.view(np.int32),
        np.array([round(float(v), d) for v in x], np.float32).view(np.int32))


@pytest.mark.parametrize("d", range(5))
def test_round_fixed_exact_equals_jax(jax_ref, d):
    want = np.load(jax_ref / "quanta.npz")[str(d)]
    got = round_fixed_exact(torch.from_numpy(sweep(d)), 10 ** d).numpy()
    np.testing.assert_array_equal(got, np.where(want == JAX_NEG_ZERO, 0,
                                                want))


def test_quantize_values_equals_the_wire_decoder(jax_ref):
    """``round_decimals`` gives the values JAX's wire decoder yields from
    JAX's quanta bit for bit, -0.0 included; ``scale=None`` passes."""
    for d in range(5):
        x = torch.from_numpy(sweep(d))
        want = _decoded(np.load(jax_ref / "quanta.npz")[str(d)], d)
        np.testing.assert_array_equal(
            round_decimals(x, 10 ** d).numpy().view(np.int32),
            want.view(np.int32))
    assert round_decimals(x, None) is x


# ---------------------------------------------------------------------------
# The compaction
# ---------------------------------------------------------------------------


def _batch(seed: int = 3, k: int = 5, t: int = 16):
    """Random ``[K, T, T]`` stats with tiny negative and exactly -0.0 D
    among them, and a threshold mask."""
    g = torch.Generator().manual_seed(seed)
    d = (torch.rand((k, t, t), generator=g) - 0.5) * 0.5
    d[0, 0, :4] = torch.tensor([-3e-5, -0.0, 4e-5, -0.00005])
    r2 = torch.rand((k, t, t), generator=g)
    dp = torch.randn((k, t, t), generator=g)
    keep = torch.rand((k, t, t), generator=g) < 0.7
    keep[0, 0, :4] = True
    r2[0, 0, :4] = 0.5
    st = PairStats(d=d, d_prime=dp, r2=r2, keep=keep)
    ti = torch.randint(0, 40, (k,), generator=g, dtype=torch.int32)
    tj = ti + torch.randint(0, 3, (k,), generator=g, dtype=torch.int32)
    return st, ti, tj, threshold_mask(st, 0.25), t


@pytest.mark.parametrize("shape", ((5, 16), (3, 5)))
@pytest.mark.parametrize("scale", (None, 10000))
@pytest.mark.parametrize("slack", (-10, 0, 37))
def test_compact_fixed_equals_exact(scale, slack, shape):
    """Row for row the exact path's, under, at and over the capacity, on
    a batch of whole 8-pair words and on one whose last word is padded;
    both round D and r2 alike and leave D' as it is."""
    st, ti, tj, mask, t = _batch(k=shape[0], t=shape[1])
    n, sites, vals = compact_tile_stats(st, ti, tj, mask, tile=t,
                                        scale=scale)
    _n, _s, raw = compact_tile_stats(st, ti, tj, mask, tile=t)
    for c in (0, 2):
        assert torch.equal(vals[:, c], round_decimals(raw[:, c], scale))
    assert torch.equal(vals[:, 1], raw[:, 1])
    cap = n + slack
    count, block = compact_fixed(st, ti, tj, mask, tile=t, capacity=cap,
                                 scale=scale)
    assert int(count) == n and tuple(block.shape) == (cap, 5)
    block = block.numpy()
    m = min(n, cap)
    assert not block[m:].any()                 # dead slots are zeroed
    got_s, got_v = decode_block(block[:m])
    np.testing.assert_array_equal(got_s, sites.numpy()[:m])
    np.testing.assert_array_equal(got_v.view(np.int32),
                                  vals.numpy()[:m].view(np.int32))
    if scale is not None:                      # -3e-5 rounds to -0.0
        assert np.signbit(got_v[:2, 0]).all() and not got_v[:2, 0].any()


# ---------------------------------------------------------------------------
# Sessions
# ---------------------------------------------------------------------------


def _tsv(sess, ndigits: int = 4, **kw) -> tuple[str, int]:
    buf = io.StringIO()
    n = 0
    for _b, rec in sess.stream(**kw):
        write_pairs(rec, buf, header=False, ndigits=ndigits)
        n += len(rec)
    return buf.getvalue(), n


def _sessions() -> dict:
    """A factorized, a hybrid (packed), a windowed-packed and a G = 2
    hybrid session."""
    rng = np.random.default_rng(0)
    aln = random_alignment(rng, 40, 200)
    w = (rng.random(40) * 0.9 + 0.1).astype(np.float32)
    fact = aln.copy()
    fact[fact == 5] = 0
    a_aln, a_w, a_sm = sharded_input("amb")
    p_aln, p_w, p_sm, p_t = windows_input("amb")
    k2 = dict(tile=16, seq_chunk=64, tiles_per_shard_batch=2)
    return {
        "factorized": LdSession(fact, w, np.arange(200),
                                DriverConfig(**k2), device="cpu"),
        "hybrid": LdSession(a_aln, a_w, a_sm, DriverConfig(**k2),
                            device="cpu"),
        "windowed-packed": LdSession(
            p_aln, p_w, p_sm, DriverConfig(
                tile=p_t, seq_chunk=64, tiles_per_shard_batch=2,
                **AMB_WINDOWS["site"]), device="cpu"),
        "g2": LdSession(a_aln, a_w, a_sm, DriverConfig(**k2),
                        devices=["cpu", "cpu"]),
    }


SESSIONS = ("factorized", "hybrid", "windowed-packed", "g2")


@pytest.fixture(scope="module")
def sessions():
    return _sessions()


@pytest.mark.parametrize("name", SESSIONS)
def test_stream_decimals_round_trips_through_the_wire(sessions, name):
    """``stream(decimals=d)``, records rounded on the device, writes
    ``stream()``'s bytes at d digits, on the first scan (partly exact:
    unlearned batches) and on re-scans (all speculative), for d = 4 and
    3."""
    sess = sessions[name]
    if name == "windowed-packed":
        assert sess.windowed_packed
    if name in ("hybrid", "g2"):
        assert sess.hybrid_safe is not None and sess.site_perm is not None
    base, n0 = _tsv(sess)
    assert n0 > 0
    for d in (4, 4, 3):
        before = dict(sess.path_counts)
        got, n = _tsv(sess, ndigits=d, decimals=d)
        want = base if d == 4 else _tsv(sess, ndigits=3)[0]
        assert n == n0 and got == want
        assert sess.path_counts["exact"] == before["exact"]   # learned
        assert sess.path_counts["speculative"] > before["speculative"]


@pytest.mark.parametrize("scan", (0, 1))
def test_stream_decimals_tsv_equals_jax(jax_ref, scan):
    aln, w, sm = jax_input()
    sess = LdSession(aln, w, sm, DriverConfig(tile=JAX_TILE, seq_chunk=64),
                     device="cpu")
    for _ in range(scan):
        _tsv(sess, decimals=4)
    got, n = _tsv(sess, decimals=4)
    assert n > 0
    assert got == (jax_ref / f"jax_{scan}.tsv").read_text()


def test_yielded_values_are_rounded_and_d_prime_exact(sessions):
    sess = sessions["hybrid"]
    exact = [r for _b, r in sess.stream()]
    for scan in range(2):
        rounded = [r for _b, r in sess.stream(decimals=4)]
        for a, b in zip(exact, rounded):
            np.testing.assert_array_equal(a.pos_a, b.pos_a)
            np.testing.assert_array_equal(a.d_prime.view(np.int32),
                                          b.d_prime.view(np.int32))
            for f in ("d", "r2"):
                want = round_decimals(torch.from_numpy(getattr(a, f)), 10000)
                np.testing.assert_array_equal(
                    getattr(b, f).view(np.int32),
                    want.numpy().view(np.int32))


def test_poisoned_capacity_falls_back_to_the_exact_path(monkeypatch):
    """Learned capacities poisoned to one record overflow on every slice
    that holds more, and the exact path gives the same bytes."""
    rng = np.random.default_rng(2)
    aln = random_alignment(rng, 30, 120)
    sess = LdSession(aln, np.ones(30, np.float32), np.arange(120),
                     DriverConfig(tile=16, tiles_per_shard_batch=2),
                     device="cpu")
    base, _n = _tsv(sess)
    got, _n = _tsv(sess, decimals=4)
    monkeypatch.setattr(driver, "_spec_capacity", lambda n: 1)
    counts = {b: c[0] for b, c in sess._batch_caps.items()}
    before = dict(sess.path_counts)
    assert _tsv(sess, decimals=4)[0] == base == got
    assert sess.path_counts["exact"] - before["exact"] == sum(
        c > 1 for c in counts.values()) > 0


def _learning_session(thr):
    rng = np.random.default_rng(8)
    aln = rng.choice([0, 0, 0, 1, 1, 4], size=(32, 160)).astype(np.int8)
    w = (rng.random(32) + 0.05).astype(np.float32)
    return LdSession(aln, w, np.arange(160),
                     DriverConfig(tile=32, tiles_per_shard_batch=1,
                                  r2_threshold=thr), device="cpu")


def _rows(sess, **kw):
    return sorted((int(a), int(b), float(r)) for _b, rec in sess.stream(**kw)
                  for a, b, r in zip(rec.pos_a, rec.pos_b, rec.r2))


def test_capacity_is_learned_and_overflows_exactly():
    """A sparse scan learns a capacity; a denser threshold forgets the
    per-batch memory, overflows the window into the exact path and gives
    a fresh session's records; beyond ``_SPEC_CAP_MAX`` speculation
    turns off."""
    ses = _learning_session(0.5)
    assert ses._spec_cap == 0 and ses.n_batches >= 3
    sparse = _rows(ses)
    cap_sparse = ses._spec_cap
    assert cap_sparse > 0 and ses._caps_thr == 0.5
    exact0 = ses.path_counts["exact"]
    dense = _rows(ses, r2_threshold=0.0)
    assert ses._caps_thr == 0.0
    assert ses.path_counts["exact"] > exact0            # overflows
    assert dense == _rows(_learning_session(0.0))
    assert ses._spec_cap >= cap_sparse
    assert sparse == [r for r in dense if r[2] > 0.5]
    orig = driver._SPEC_CAP_MAX
    try:
        driver._SPEC_CAP_MAX = 2
        assert _rows(ses, r2_threshold=0.0) == dense
    finally:
        driver._SPEC_CAP_MAX = orig
    assert ses._spec_cap == 0


def test_capacity_shrinks_after_a_high_yield_scan():
    ses = _learning_session(0.9)
    dense = sum(len(r) for _b, r in ses.stream(r2_threshold=None))
    cap_dense = ses._spec_cap
    assert cap_dense >= driver._spec_capacity(dense // ses.n_batches)
    sparse = sum(len(r) for _b, r in ses.stream(r2_threshold=0.99))
    assert sparse < dense
    assert ses._spec_cap < cap_dense                    # the window forgot
    assert ses._spec_cap == max(ses._cap_hist)
    assert sum(len(r) for _b, r in ses.stream(r2_threshold=None)) == dense


@pytest.mark.parametrize("decimals", (7, -1))
def test_decimals_outside_0_to_4_raise(sessions, decimals):
    with pytest.raises(ValueError, match="decimals"):
        next(iter(sessions["factorized"].stream(decimals=decimals)))
    aln, w, sm = jax_input()
    with pytest.raises(ValueError, match="decimals"):
        next(stream_ld_records(aln, w, sm, DriverConfig(tile=16),
                               device="cpu", decimals=decimals))


def test_plan_beyond_the_wire_rounds_on_the_host():
    """At T > 512, beyond what word 0 of JAX's wire addresses, the JAX
    session yields exact values (``driver.py:965-984``); the port's
    ``decimals`` contract rounds on every plan, with the same bytes."""
    aln, w, sm = jax_input()
    sess = LdSession(aln, w, sm, DriverConfig(tile=1024, seq_chunk=64),
                     device="cpu")
    assert sess.cfg.tile > 512
    base, n0 = _tsv(sess)
    exact = [r for _b, r in sess.stream()]
    for _ in range(2):
        assert _tsv(sess, decimals=4) == (base, n0)
    rounded = [r for _b, r in sess.stream(decimals=4)]
    for a, b in zip(exact, rounded):
        np.testing.assert_array_equal(
            b.r2, round_decimals(torch.from_numpy(a.r2), 10000).numpy())


@pytest.mark.parametrize("suffix", (".tsv", ".tsv.gz"))
def test_run_to_tsv_resumes_to_the_uninterrupted_bytes(tmp_path, suffix):
    """``run_to_tsv`` streams at ``decimals=ndigits``: interrupted after
    two batches (the batch launched ahead is dropped unread) and resumed,
    it writes the uninterrupted run's bytes, which are ``stream()``'s."""
    import gzip

    aln, w, sm = sharded_input("amb")
    cfg = DriverConfig(tile=16, seq_chunk=64, tiles_per_shard_batch=2)
    full = tmp_path / f"full{suffix}"
    run_to_tsv(aln, w, sm, full, cfg, device="cpu", checkpoint=True)
    part = tmp_path / f"part{suffix}"
    orig = LdSession.stream

    class Stop(Exception):
        pass

    def limited(self, *a, **kw):
        assert kw.get("decimals") == 4
        for n, item in enumerate(orig(self, *a, **kw)):
            yield item
            if n >= 1 and not kw.get("start_batch"):
                raise Stop

    LdSession.stream = limited
    try:
        with pytest.raises(Stop):
            run_to_tsv(aln, w, sm, part, cfg, device="cpu", checkpoint=True)
    finally:
        LdSession.stream = orig
    assert Path(str(part) + ".ckpt.json").exists()
    run_to_tsv(aln, w, sm, part, cfg, device="cpu", checkpoint=True)
    assert part.read_bytes() == full.read_bytes()
    text = (gzip.decompress(full.read_bytes()).decode() if suffix.endswith(
        ".gz") else full.read_text())
    body = _tsv(LdSession(aln, w, sm, cfg, device="cpu"))[0]
    assert text.split("\n", 1)[1] == body
