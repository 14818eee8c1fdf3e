"""The margin split of an alignment whose every site holds UNKNOWN cells, on
the CPU: ``packing_permutation`` orders the margin-stable sites (margin
above every site's UNKNOWN count) first and the rest after, each class in
input order, so the tile pairs of two stable tiles run the factorized
kernel.  Every query of such a session answers as the
``kernel="general"`` session on the same input, and the gates (too few
stable sites, a window, a cross split, a partly dirty input) keep the order
they had.

The factorized cells are the general kernel's selected cells bit for bit:
the hybrid session equals a general session laid out in its order.
Against the general session in input order, a pair whose two sites swap
sides under the packing (the earlier becomes the column) may differ by
some ulps, as the pair algebra's float32 arithmetic is not bitwise
symmetric in its two sites (the plain versions and the card's kernels
alike); those values are held within the ``hiv_pol_iupac.session`` cell's
limits.  The card's twin is
``tests/test_torch_cuda.py::test_margin_packed_session_bit_equal_on_card``.

``session_layout`` alone, with no upload, is held to what the built
session reports and launches, over the packings, windows, engines,
kernels, weight modes and preplaned settings.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from weightedld_tpu_torch.core.sites import site_histogram_host
from weightedld_tpu_torch.ops.cuda_ld import (
    majmin_site_margins,
    majmin_tile_margins,
)
from weightedld_tpu_torch.runtime import profiling
from weightedld_tpu_torch.runtime.driver import (
    DriverConfig,
    LdSession,
    packing_permutation,
    run_to_tsv,
)

N_SEQS, N_SITES, TILE = 200, 320, 64
LIMITS = json.loads((Path(__file__).resolve().parents[1] / "ldbench" / "limits"
                     / "hiv_pol_iupac.session.json").read_text())


def all_dirty(seed: int = 0, n_stable: int = 200) -> np.ndarray:
    """``N_SEQS x N_SITES`` codes, 1-4 UNKNOWN cells at every site.
    ``n_stable`` sites, scattered, are biallelic with one of four clusters
    of 50 sequences on the minor base (5 % of rows flipped): margins near
    50, and LD between the sites of one cluster.  The rest hold a third
    base as common as the second (margin 0)."""
    rng = np.random.default_rng(seed)
    cluster = np.arange(N_SEQS) // 50
    aln = np.empty((N_SEQS, N_SITES), np.int8)
    stable = np.zeros(N_SITES, bool)
    stable[rng.choice(N_SITES, n_stable, replace=False)] = True
    for j in range(N_SITES):
        a, b, c = rng.permutation(4)[:3]
        if stable[j]:
            minor = (cluster == rng.integers(4)) ^ (rng.random(N_SEQS) < .05)
            aln[:, j] = np.where(minor, b, a)
        else:
            aln[:, j] = rng.permutation(np.repeat([a, b, c], [100, 50, 50]))
        aln[rng.choice(N_SEQS, rng.integers(1, 5), replace=False), j] = 5
    return aln


SITE_MAP = np.arange(N_SITES) * 7 + 3


def _session(aln, **cfg) -> LdSession:
    return LdSession(aln, None, SITE_MAP,
                     DriverConfig(**{"tile": TILE, "r2_threshold": 0.05,
                                     "tiles_per_shard_batch": 4, **cfg}),
                     device="cpu")


def _stable(aln) -> np.ndarray:
    margin, u = majmin_site_margins(site_histogram_host(aln), aln.shape[0])
    assert (u > 0).all()
    return margin > u.max()


@pytest.fixture(scope="module")
def pair():
    aln = all_dirty()
    return aln, _session(aln), _session(aln, kernel="general")


def _traced(fn):
    """``(fn(), the spans it finished)`` under a CPU profiler."""
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, [s for s in profiling.spans() if s.start >= t0]


def _pack_spans(spans) -> list:
    return [s for s in spans if s.name == "upload.pack" and "order" in s.attrs]


def unlay(mats: dict, perm: np.ndarray) -> dict:
    """``matrices()`` of a session fed the sites in ``perm``'s order, put
    back in the input order: each pair in the upper triangle, NaN (False
    for ``keep``) on and below the diagonal, as ``matrices()`` gives."""
    inv = np.argsort(perm)                 # site -> its laid-out index
    swap = inv[:, None] > inv[None, :]     # the pair sits below the diagonal
    upper = np.triu(np.ones(swap.shape, bool), 1)
    out = {}
    for name, m in mats.items():
        m = m[np.ix_(inv, inv)]
        out[name] = np.where(upper, np.where(swap, m.T, m),
                             False if m.dtype == bool else np.nan
                             ).astype(m.dtype)
    return out


def assert_within_limits(d, dp, r2, ref_d, ref_dp, ref_r2):
    """Per-pair values as the cell's ``r2_gap``, ``d_gap`` and ``dp_gap``
    judge them, against the general session's."""
    f64 = lambda x: np.asarray(x, np.float64)
    assert np.abs(f64(r2) - f64(ref_r2)).max() <= LIMITS["r2_gap"]
    assert np.abs(f64(d) - f64(ref_d)).max() <= LIMITS["d_gap"]
    assert (np.abs(f64(dp) - f64(ref_dp))
            / np.maximum(1.0, np.abs(f64(ref_dp)))).max() <= LIMITS["dp_gap"]


def test_site_perm_is_the_two_class_order(pair):
    aln, sess, gen = pair
    stable = _stable(aln)
    assert stable.sum() >= 3 * TILE
    want = np.concatenate([np.flatnonzero(stable), np.flatnonzero(~stable)])
    np.testing.assert_array_equal(sess.site_perm, want)
    assert not sess.windowed_packed
    assert gen.site_perm is None
    # In input order no tile pair passes the exact test.
    grid = -(-N_SITES // TILE)
    stab, umax = majmin_tile_margins(site_histogram_host(aln), N_SEQS, TILE,
                                     grid)
    assert not (stab[:, None] > umax[None, :]).any()


def test_stable_tiles_run_factorized(pair):
    aln, sess, gen = pair
    n_full = int(_stable(aln).sum()) // TILE
    tiles = sess.phase_tiles
    assert tiles["majmin"] == n_full * (n_full + 1) // 2
    assert tiles["majmin"] + tiles["general"] == sess.plan.n_tiles
    safe = sess.hybrid_safe
    ti, tj = np.asarray(sess.plan.tile_i), np.asarray(sess.plan.tile_j)
    np.testing.assert_array_equal(safe, (ti < n_full) & (tj < n_full))
    assert gen.phase_tiles == {"majmin": 0, "general": gen.plan.n_tiles}


def test_pack_and_plan_spans_count_the_split():
    aln = all_dirty()
    sess, spans = _traced(lambda: _session(aln))
    (pack,) = _pack_spans(spans)
    assert pack.attrs == {"order": "margin_split",
                          "stable_sites": int(_stable(aln).sum())}
    (plan,) = [s for s in spans if s.name == "upload.plan"
               and "majmin_tile_pairs" in s.attrs]
    assert plan.attrs["majmin_tile_pairs"] == sess.phase_tiles["majmin"] > 0
    assert plan.attrs["general_tile_pairs"] == sess.phase_tiles["general"]


def _records(sess, **kw) -> dict:
    """Stream records keyed by their position pair."""
    out = {}
    for _b, rec in sess.stream(**kw):
        for a, b, d, dp, r2 in zip(rec.pos_a, rec.pos_b, rec.d,
                                   rec.d_prime, rec.r2):
            assert (a, b) not in out
            out[(int(a), int(b))] = (d, dp, r2)
    return out


def _bits(x) -> bytes:
    return np.asarray(x, np.float32).tobytes()


@pytest.mark.parametrize("thr", (None, 0.3))
def test_stream_equals_general(pair, thr):
    _aln, sess, gen = pair
    got = _records(sess, r2_threshold=thr)
    want = _records(gen, r2_threshold=thr)
    assert len(want) > 100 and got.keys() == want.keys()
    assert all(a < b for a, b in got)
    keys = list(want)
    assert_within_limits(*np.array([got[k] for k in keys]).T,
                          *np.array([want[k] for k in keys]).T)


def test_summarize_and_histogram_equal_general(pair):
    _aln, sess, gen = pair
    for thr in (0.05, 0.5):
        got, want = sess.summarize(thr), gen.summarize(thr)
        # The sum adds float32 r2 in batch order, which the packing changes.
        np.testing.assert_allclose(got.pop("r2_sum_over_threshold"),
                                   want.pop("r2_sum_over_threshold"),
                                   rtol=1e-6)
        assert got == want
    edges = [0.0, 0.01, 0.1, 0.3, 0.6, 1.01]
    assert sess.r2_histogram(edges) == gen.r2_histogram(edges)


def test_top_pairs_equal_general(pair):
    _aln, sess, gen = pair
    got, want = sess.top_pairs(25), gen.top_pairs(25)
    assert _bits(got.r2) == _bits(want.r2)
    key = lambda rec: sorted(zip(rec.pos_a.tolist(), rec.pos_b.tolist(),
                                 rec.d.tolist(), rec.d_prime.tolist()))
    assert key(got) == key(want)


def test_ld_decay_equals_general(pair):
    _aln, sess, gen = pair
    edges = [0, 50, 300, 1000, 3000]
    got, want = sess.ld_decay(edges), gen.ld_decay(edges)
    assert got.keys() == want.keys()
    for name, val in want.items():
        if np.asarray(val).dtype.kind == "f":
            np.testing.assert_allclose(got[name], val, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got[name], val)


@pytest.mark.parametrize("thr", (0.2, 0.5))
def test_prune_equals_general(pair, thr):
    _aln, sess, gen = pair
    got = sess.prune(thr)
    np.testing.assert_array_equal(got, gen.prune(thr))
    assert 0 < len(got) < N_SITES


def test_matrices_equal_general(pair):
    aln, sess, gen = pair
    got, want = sess.matrices(), gen.matrices()
    np.testing.assert_array_equal(got["keep"], want["keep"])
    keep = want["keep"]
    assert_within_limits(*(got[n][keep] for n in ("d", "d_prime", "r2")),
                          *(want[n][keep] for n in ("d", "d_prime", "r2")))
    # Laid out in the hybrid's order, the general session gives the same
    # bits: the factorized cells equal the general kernel's.
    perm = sess.site_perm
    laid = unlay(LdSession(aln[:, perm], None, SITE_MAP[perm],
                           DriverConfig(tile=TILE, kernel="general"),
                           device="cpu").matrices(), perm)
    np.testing.assert_array_equal(laid["keep"], keep)
    for name in ("d", "d_prime", "r2"):
        assert got[name][keep].tobytes() == laid[name][keep].tobytes(), name


def test_run_to_tsv_rows_equal_general(tmp_path):
    """The same rows; their order follows each session's plan."""
    aln = all_dirty(seed=1)
    outs = {}
    for kern in ("auto", "general"):
        out = tmp_path / f"{kern}.tsv"
        run_to_tsv(aln, None, SITE_MAP, out,
                   DriverConfig(tile=TILE, r2_threshold=0.05, kernel=kern),
                   device="cpu")
        head, *rows = out.read_bytes().splitlines()
        outs[kern] = head, sorted(rows)
    assert len(outs["auto"][1]) > 100
    assert outs["auto"] == outs["general"]


def _input_order_split(aln) -> np.ndarray:
    """The hybrid split of the plan in input order (no packing)."""
    sess = _session(aln, kernel="general")
    grid = sess.plan.grid
    stab, umax = majmin_tile_margins(site_histogram_host(aln), N_SEQS, TILE,
                                     grid)
    ti, tj = np.asarray(sess.plan.tile_i), np.asarray(sess.plan.tile_j)
    return (((umax[tj] == 0) | (stab[ti] > umax[tj]))
            & ((umax[ti] == 0) | (stab[tj] > umax[ti])))


def test_fewer_stable_sites_than_a_tile_keep_input_order():
    aln = all_dirty(n_stable=TILE - 1)
    assert _stable(aln).sum() == TILE - 1
    counts = site_histogram_host(aln)
    assert packing_permutation(counts, N_SEQS,
                               DriverConfig(tile=TILE)) is None
    sess = _session(aln)
    assert sess.site_perm is None
    safe = _input_order_split(aln)
    assert sess.phase_tiles == {"majmin": int(safe.sum()),
                                "general": int((~safe).sum())}
    # One more stable site and the tile fills: the split is taken.
    assert packing_permutation(site_histogram_host(all_dirty(n_stable=TILE)),
                               N_SEQS, DriverConfig(tile=TILE)) is not None
    # The gate follows the tile the plan resolves: 256 by default.
    assert packing_permutation(site_histogram_host(all_dirty()),
                               N_SEQS, DriverConfig()) is None


@pytest.mark.parametrize("window", ({"max_site_distance": 40},
                                    {"max_bp_distance": 300}))
def test_window_keeps_input_order(window):
    aln = all_dirty()
    assert packing_permutation(site_histogram_host(aln), N_SEQS,
                               DriverConfig(tile=TILE, **window),
                               SITE_MAP) is None
    sess = _session(aln, **window)
    assert sess.site_perm is None and not sess.windowed_packed


def test_cross_session_never_packs():
    aln = all_dirty()
    sess, spans = _traced(lambda: _session(aln, cross_split=N_SITES // 2))
    assert sess.site_perm is None and not _pack_spans(spans)


def test_partly_dirty_keeps_the_clean_dirty_order():
    aln = all_dirty()
    clean = np.arange(10, 180)
    aln[:, clean] = np.where(aln[:, clean] == 5, 0, aln[:, clean])
    counts = site_histogram_host(aln)
    margin, u = majmin_site_margins(counts, N_SEQS)
    bad = u > 0
    assert not bad[clean].any() and bad.sum() == N_SITES - len(clean)
    cl, di = np.flatnonzero(~bad), np.flatnonzero(bad)
    want = np.concatenate([cl[np.argsort(-margin[cl], kind="stable")],
                           di[np.argsort(u[di], kind="stable")]])
    sess, spans = _traced(lambda: _session(aln))
    np.testing.assert_array_equal(sess.site_perm, want)
    (pack,) = _pack_spans(spans)
    assert pack.attrs["order"] == "clean_dirty"
    # Under a window: clean then dirty, each in input order.
    win = DriverConfig(tile=TILE, max_site_distance=N_SITES)
    np.testing.assert_array_equal(
        packing_permutation(counts, N_SEQS, win, SITE_MAP),
        np.concatenate([cl, di]))


def _partly_dirty(lo: int = 10, hi: int = 180) -> np.ndarray:
    """:func:`all_dirty` with the UNKNOWN cells of sites ``lo:hi`` made the
    first base."""
    aln = all_dirty()
    aln[:, lo:hi] = np.where(aln[:, lo:hi] == 5, 0, aln[:, lo:hi])
    return aln


W_RAND = (np.random.default_rng(4).random(N_SEQS) + 0.05).astype(np.float32)
W_UNIT = np.ones(N_SEQS, np.float32)
W_EXACT = ((np.arange(N_SEQS) % 4 + 1) / 4).astype(np.float32)
# case: (input, DriverConfig fields, weights, packing order, weight mode)
LAYOUT_CASES = {
    "clean": (lambda: _partly_dirty(0, N_SITES), {}, W_RAND, "none",
              "int8x3"),
    "partly-dirty": (_partly_dirty, {}, W_RAND, "clean_dirty", "int8x3"),
    "all-dirty": (all_dirty, {}, W_RAND, "margin_split", "int8x3"),
    "windowed": (_partly_dirty, {"max_site_distance": N_SITES}, W_RAND,
                 "windowed", "int8x3"),
    "cross": (_partly_dirty, {"cross_split": N_SITES // 2}, W_RAND, "none",
              "int8x3"),
    "general": (all_dirty, {"kernel": "general"}, W_RAND, "none", "int8x3"),
    "xla": (all_dirty, {"engine": "xla"}, W_RAND, "none", None),
    **{f"quant-{wq}": (_partly_dirty, {"weight_quant": wq}, W_RAND,
                       "clean_dirty", "int8x3" if wq == "none" else wq)
       for wq in ("none", "split_bf16", "lo_int8", "int8", "int8x3")},
    "unit": (all_dirty, {"weight_quant": "int8"}, W_UNIT, "margin_split",
             "unit"),
    "bf16-exact": (_partly_dirty, {}, W_EXACT, "clean_dirty", "bf16_exact"),
    "preplaned-on": (_partly_dirty, {"preplaned": "on"}, W_RAND,
                     "clean_dirty", "int8x3"),
    "preplaned-off": (all_dirty, {"preplaned": "off"}, W_RAND,
                      "margin_split", "int8x3"),
    "general-on": (_partly_dirty, {"kernel": "general", "preplaned": "on"},
                   W_UNIT, "none", "unit"),
}
WEIGHT_ROWS = {"unit": 1, "bf16_exact": 1, "split_bf16": 1, "lo_int8": 3,
               "int8": 4, "int8x3": 6}


def _launched_as(fn, kw) -> str:
    """The launch-counter name of the wrapper call ``fn(**kw)``, as the
    wrappers count it."""
    from weightedld_tpu_torch.ops import cuda_ld as K

    if fn.__name__ == "tile_stats_batch":
        return "tile_stats_batch"
    kind = K.weight_kind(kw["exact_weights"], kw["unit_weights"],
                         kw["wquant"])
    if fn.__name__ == "tile_stats_general":
        entry = ("ld_general_planes" if kw["preplaned"] else
                 "ld_general_unit" if kind == "unit" else "ld_general")
    else:
        entry = ("ld_majmin_planes" if fn.__name__.endswith("_pre")
                 else "ld_majmin_codes")
    return K.launch_name(entry, kind)


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_layout_alone_names_what_the_session_runs(case):
    """``session_layout`` and ``with_weights`` alone, with no upload, give
    the packing, the split, each phase's entry and the weight mode that the
    built session reports and calls its kernels with."""
    import torch

    from weightedld_tpu_torch.runtime.driver import session_layout

    make, fields, w, order, mode = LAYOUT_CASES[case]
    aln = make()
    cfg = DriverConfig(tile=TILE, r2_threshold=0.05,
                       tiles_per_shard_batch=4, **fields)
    cpu = torch.device("cpu")
    lay = session_layout(aln, lambda: site_histogram_host(aln), N_SEQS,
                         N_SITES, SITE_MAP, cfg, cpu).with_weights(w, cpu)
    sess = LdSession(aln, w, SITE_MAP, cfg, device="cpu")
    for got, want in ((lay.site_perm, sess.site_perm),
                      (lay.hybrid_safe, sess.hybrid_safe)):
        assert (got is None) == (want is None)
        np.testing.assert_array_equal(got, want)
    assert lay.phase_tiles == sess.phase_tiles
    assert (lay.preplaned, lay.general_preplaned) == (
        sess.preplaned, sess.general_preplaned)
    assert (lay.order, lay.weight_mode) == (order, mode)
    assert lay.windowed_packed == sess.windowed_packed == (
        order == "windowed")
    if mode is not None:
        assert sess.weights_dev.shape[0] == WEIGHT_ROWS[mode]
    first = 0
    for ph in lay.phases:
        fn, _plain, _args, kw = sess.batch_kernel(first)
        assert ph.entry == _launched_as(fn, kw), (ph.kernel, ph.entry)
        for lb in range(ph.n_batches):
            sl = slice(lb * ph.k, (lb + 1) * ph.k)
            want = (ph.tile_i_host[0, sl], ph.tile_j_host[0, sl],
                    ph.emit_host[0, sl])
            for got_t, want_t in zip(sess.batch_tiles_host(first + lb), want):
                np.testing.assert_array_equal(got_t, want_t)
        first += ph.n_batches
    assert first == sess.n_batches
