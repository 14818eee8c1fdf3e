"""Parity of the port's factorized-kernel module (weightedld_tpu_torch.ops.
cuda_ld) with the JAX package's Pallas kernels.

The same numpy inputs go through ``pallas_tile_stats_majmin`` /
``pallas_tile_stats_majmin_pre`` in interpret mode (as tests/test_pallas_ld.py
runs them) and through the port's wrappers on CPU tensors, which run the
plain PyTorch versions.  Tolerance on kept pairs: rtol=1e-5, atol=1e-6 (f32
noise), ``keep`` equal, non-finite patterns equal.

XLA's CPU backend contracts multiply-adds into FMAs (e.g. ``pa_major *
pb_major - obs_mm`` and the int8 cascade combine), which the JAX program
does not ask for and the port does not do.  With FMA instructions withheld
(``XLA_FLAGS=--xla_cpu_max_isa=AVX``, in a subprocess) the interpret-mode
kernels and the plain versions agree bit for bit; the ``bitwise`` tests
hold that.

The kernel-vs-plain tests on the card are in tests/test_torch_cuda.py
(no jax import, so they also run where only PyTorch is installed).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from weightedld_tpu.ops import pallas_ld as P
from weightedld_tpu.parallel.triangle import plan_tiles
from weightedld_tpu_torch.ops import cuda_ld as K

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-6

# id -> (seed, alphabet, n_seqs, n_sites, tile, seq_chunk, weight mode)
CASES = {
    "dna-int8x3": (1, (0, 1, 2, 3, 4), 50, 70, 16, 64, "int8x3"),
    "snp-int8x3": (2, (0, 1, 4), 50, 70, 16, 64, "int8x3"),
    "binary-int8x3": (3, (0, 1), 50, 70, 16, 64, "int8x3"),
    "dna-unit": (4, (0, 1, 2, 3, 4), 48, 40, 16, 64, "unit"),
    "snp-exact": (5, (0, 1, 4), 48, 40, 16, 64, "exact"),
    "binary-split": (6, (0, 1), 50, 70, 16, 64, "split_bf16"),
    "snp-int8": (7, (0, 3, 4), 50, 70, 16, 64, "int8"),
    "multichunk": (8, (0, 1, 3, 4), 150, 40, 16, 64, "int8x3"),
    "ragged": (9, (0, 1, 2, 4), 37, 45, 32, 20, "int8x3"),
}


def make_case(name: str) -> dict:
    """Numpy inputs of one case (both packages build from these)."""
    seed, alphabet, n, s, tile, chunk, mode = CASES[name]
    rng = np.random.default_rng(seed)
    aln = rng.choice(alphabet, size=(n, s)).astype(np.int8)
    if mode == "unit":
        w = np.ones(n, np.float32)
    elif mode == "exact":
        w = ((np.arange(n) % 4 + 1) / 4.0).astype(np.float32)
    else:
        w = (rng.random(n) + 0.05).astype(np.float32)
        w /= w.max()
    if mode in ("int8", "int8x3"):
        wr = P.pad_weights_int8(w, chunk, levels=2 if mode == "int8" else 3)
    else:
        wr = P.pad_weights(w, chunk)
    plan = plan_tiles(s, tile)
    emit = np.ones(plan.n_tiles, np.int32)
    emit[rng.random(plan.n_tiles) < 0.2] = 0
    auxc, auxr = P.majmin_site_aux(aln, plan.s_pad)
    return dict(
        codes=P.pad_alignment_site_major(aln, tile, chunk), weights=wr,
        auxc=auxc, auxr=auxr, tile_i=plan.tile_i, tile_j=plan.tile_j,
        emit=emit, nlev={"int8": 2, "int8x3": 3}.get(mode, 0),
        kw=dict(tile=tile, n_sites=s, seq_chunk=chunk,
                unit_weights=mode == "unit", exact_weights=mode == "exact",
                wquant=mode if mode in ("int8", "int8x3") else ""))


def jax_stats(c: dict, entry: str) -> dict:
    """The JAX kernel's outputs (interpret mode) as numpy arrays."""
    j = {k: jnp.asarray(c[k]) for k in ("codes", "weights", "auxc", "auxr",
                                         "tile_i", "tile_j", "emit")}
    if entry == "codes":
        st = P.pallas_tile_stats_majmin(
            j["codes"], j["weights"], j["auxc"], j["auxr"], j["tile_i"],
            j["tile_j"], j["emit"], interpret=True, **c["kw"])
    else:
        planes = P.build_majmin_planes(j["codes"], j["auxc"],
                                       tile=c["kw"]["tile"])
        xq = (P.build_majmin_xq(planes, j["weights"], c["nlev"])
              if c["nlev"] and not c["kw"]["unit_weights"] else ())
        st = P.pallas_tile_stats_majmin_pre(
            planes, xq, j["weights"], j["auxc"], j["auxr"], j["tile_i"],
            j["tile_j"], j["emit"], interpret=True, **c["kw"])
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def port_stats(c: dict, entry: str, device="cpu") -> K.PairStats:
    t = {k: torch.from_numpy(np.ascontiguousarray(c[k])).to(device)
         for k in ("codes", "weights", "auxc", "tile_i", "tile_j", "emit")}
    args = (t["weights"], t["auxc"], t["tile_i"], t["tile_j"], t["emit"])
    if entry == "codes":
        return K.tile_stats_majmin(t["codes"], *args, **c["kw"])
    planes = K.build_majmin_planes(t["codes"], t["auxc"],
                                   tile=c["kw"]["tile"])
    xq = (K.build_majmin_xq(planes, t["weights"], c["nlev"])
          if c["nlev"] and not c["kw"]["unit_weights"] else None)
    return K.tile_stats_majmin_pre(planes, xq, *args, **c["kw"])


def assert_stats_match(got: dict, ref: dict, bitwise: bool = False) -> None:
    keep = ref["keep"]
    np.testing.assert_array_equal(got["keep"], keep)
    assert keep.any()
    for f in ("d", "d_prime", "r2"):
        g, r = got[f][keep], ref[f][keep]
        fin = np.isfinite(r)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=f)
        if bitwise:
            np.testing.assert_array_equal(g[fin], r[fin], err_msg=f)
        else:
            np.testing.assert_allclose(g[fin], r[fin], rtol=RTOL, atol=ATOL,
                                       err_msg=f)


def _np(st: K.PairStats) -> dict:
    return {f: getattr(st, f).cpu().numpy() for f in st._fields}


@pytest.mark.parametrize("entry", ["codes", "pre"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_interpret(name, entry):
    c = make_case(name)
    assert_stats_match(_np(port_stats(c, entry)), jax_stats(c, entry))


def _jax_reference_no_fma(out_path: str) -> None:
    """Subprocess body: every case through the JAX kernels, saved to npz."""
    arrays = {}
    for name in CASES:
        c = make_case(name)
        for entry in ("codes", "pre"):
            for f, v in jax_stats(c, entry).items():
                arrays[f"{name}/{entry}/{f}"] = v
    np.savez(out_path, **arrays)


@pytest.fixture(scope="module")
def jax_no_fma(tmp_path_factory):
    out = tmp_path_factory.mktemp("nofma") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_majmin import _jax_reference_no_fma; "
            "_jax_reference_no_fma(sys.argv[2])")
    subprocess.run([sys.executable, "-c", code, str(REPO), str(out)],
                   env=env, check=True, timeout=600, cwd=REPO)
    return dict(np.load(out))


@pytest.mark.parametrize("entry", ["codes", "pre"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_bitwise_vs_jax_without_fma(jax_no_fma, name, entry):
    ref = {f: jax_no_fma[f"{name}/{entry}/{f}"]
           for f in ("d", "d_prime", "r2", "keep")}
    got = _np(port_stats(make_case(name), entry))
    assert_stats_match(got, ref, bitwise=True)


# ---------------------------------------------------------------------------
# Host packers and device builders: equal to the JAX package's.
# ---------------------------------------------------------------------------


def test_packers_equal_jax(rng):
    aln = rng.choice((0, 1, 2, 4), size=(37, 53)).astype(np.int8)
    aln[3, 7] = 5
    w = (rng.random(37) + 0.01).astype(np.float32)
    np.testing.assert_array_equal(K.pad_weights_int8(w, 16, levels=3),
                                  P.pad_weights_int8(w, 16, levels=3))
    np.testing.assert_array_equal(K.pad_weights_int8(w, 16),
                                  P.pad_weights_int8(w, 16))
    np.testing.assert_array_equal(K.pad_weights(w, 16), P.pad_weights(w, 16))
    np.testing.assert_array_equal(K.pad_alignment_site_major(aln, 16, 8),
                                  P.pad_alignment_site_major(aln, 16, 8))
    for got, want in zip(K.majmin_site_aux(aln, 64),
                         P.majmin_site_aux(aln, 64)):
        np.testing.assert_array_equal(got, want)
    assert K.detect_planes_unknown(aln) == P.detect_planes_unknown(aln)
    assert K.majmin_safe_with_unknown(aln) == P.majmin_safe_with_unknown(aln)
    clean = rng.choice((0, 1), p=(0.9, 0.1), size=(200, 30)).astype(np.int8)
    clean[0, :] = 5
    assert K.majmin_safe_with_unknown(clean) \
        == P.majmin_safe_with_unknown(clean)


@pytest.mark.parametrize("w", [
    np.ones(9, np.float32),
    (np.arange(1, 10) / 8.0).astype(np.float32),
    np.asarray([1.0, 0.3, 1e-3], np.float32),
    np.asarray([1.0, 1.0 + 2.0 ** -7, 2.0 ** -20], np.float32),
    np.asarray([1.0, 1.0 + 2.0 ** -8], np.float32),
])
def test_weights_bf16_exact_equals_ml_dtypes(w):
    want = bool((w.astype(ml_dtypes.bfloat16).astype(np.float32) == w).all())
    assert K.weights_bf16_exact(w) == want == P.weights_bf16_exact(w)


def test_plane_builders_equal_jax():
    c = make_case("dna-int8x3")
    tile = c["kw"]["tile"]
    pj = P.build_majmin_planes(jnp.asarray(c["codes"]), jnp.asarray(c["auxc"]),
                               tile=tile)
    xj = P.build_majmin_xq(pj, jnp.asarray(c["weights"]), 3)
    pt = K.build_majmin_planes(torch.from_numpy(c["codes"]),
                               torch.from_numpy(c["auxc"]), tile=tile)
    xt = K.build_majmin_xq(pt, torch.from_numpy(c["weights"]), 3)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(xt.numpy(), np.stack(
        [np.asarray(x) for x in xj]))


def test_pair_algebra_matches_jax_and_skips_p95_boundary(rng):
    cells = rng.integers(0, 40, size=(4, 64)).astype(np.float32)
    # PA = 19/20 exactly under unit weights: the pair must be skipped.
    cells[:, 0] = (10.0, 9.0, 1.0, 0.0)
    cells[:, 1] = (0.0, 0.0, 0.0, 0.0)         # empty: skipped
    keep = np.ones(64, bool)
    dj, dpj, r2j, kj = (np.asarray(x) for x in P._pair_algebra(
        *(jnp.asarray(x) for x in cells), jnp.asarray(keep)))
    dt, dpt, r2t, kt = (x.numpy() for x in K.pair_algebra(
        *(torch.from_numpy(x) for x in cells), torch.from_numpy(keep)))
    np.testing.assert_array_equal(kt, kj)
    assert not kt[0] and not kt[1] and kt.any()
    for g, r in ((dt, dj), (dpt, dpj), (r2t, r2j)):
        fin = np.isfinite(r) & kj
        np.testing.assert_allclose(g[fin], r[fin], rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# Wrapper checks: bad inputs raise; nothing falls back.
# ---------------------------------------------------------------------------


def _cpu_args(name="snp-int8x3"):
    c = make_case(name)
    t = {k: torch.from_numpy(np.ascontiguousarray(c[k]))
         for k in ("codes", "weights", "auxc", "tile_i", "tile_j", "emit")}
    return c, t


@pytest.mark.parametrize("breakage,exc", [
    ("codes_dtype", TypeError),
    ("weights_rows", ValueError),
    ("auxc_shape", ValueError),
    ("noncontiguous", ValueError),
    ("seq_chunk", ValueError),
    ("tile_index", ValueError),
    ("lo_int8", None),             # ported: runs, and equals JAX's kernel
    ("meta_device", ValueError),
])
def test_wrapper_raises_on_bad_input(breakage, exc):
    c, t = _cpu_args()
    kw = dict(c["kw"])
    codes, weights, auxc = t["codes"], t["weights"], t["auxc"]
    ti = t["tile_i"]
    if breakage == "codes_dtype":
        codes = codes.to(torch.int32)
    elif breakage == "weights_rows":
        weights = weights[:4].contiguous()
    elif breakage == "auxc_shape":
        auxc = auxc[:-1].contiguous()
    elif breakage == "noncontiguous":
        codes = codes.t().contiguous().t()
    elif breakage == "seq_chunk":
        kw["seq_chunk"] = 48
    elif breakage == "tile_index":
        ti = ti.clone()
        ti[0] = 999
    elif breakage == "lo_int8":
        kw["wquant"] = "lo_int8"
        w = (np.random.default_rng(0).random(50) + 0.05).astype(np.float32)
        c = dict(c, weights=P.pad_weights_lo_int8(w, 64), kw=kw)
        weights = torch.from_numpy(c["weights"])
    elif breakage == "meta_device":
        codes = codes.to("meta")
    if exc is None:
        st = K.tile_stats_majmin(codes, weights, auxc, ti, t["tile_j"],
                                 t["emit"], **kw)
        assert_stats_match(_np(st), jax_stats(c, "codes"))
        return
    with pytest.raises(exc):
        K.tile_stats_majmin(codes, weights, auxc, ti, t["tile_j"],
                            t["emit"], **kw)


def test_pre_wrapper_raises_on_missing_xq():
    c, t = _cpu_args()
    planes = K.build_majmin_planes(t["codes"], t["auxc"],
                                   tile=c["kw"]["tile"])
    with pytest.raises(TypeError):
        K.tile_stats_majmin_pre(planes, None, t["weights"], t["auxc"],
                                t["tile_i"], t["tile_j"], t["emit"],
                                **c["kw"])


def test_cpu_wrapper_launches_nothing():
    K.reset_launches()
    c, t = _cpu_args()
    K.tile_stats_majmin(t["codes"], t["weights"], t["auxc"], t["tile_i"],
                        t["tile_j"], t["emit"], **c["kw"])
    assert set(K.launches) == {
        entry + mode for entry in ("ld_majmin_codes", "ld_majmin_planes")
        for mode in ("", "_lo_int8", "_split_bf16", "_bf16_exact")}
    assert not any(K.launches.values())


# ---------------------------------------------------------------------------
# The float weight modes' host pieces: weight kind, launch names, the bf16
# pass bits the kernel builds its B operand from, the auto entry rule.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exact,unit,wquant,kind", [
    (False, True, "int8x3", "unit"),
    (True, True, "", "unit"),
    (True, False, "lo_int8", "exact"),
    (False, False, "int8", "int"),
    (False, False, "int8x3", "int"),
    (False, False, "", "split"),
    (False, False, "lo_int8", "lo"),
])
def test_weight_kind_follows_jax_precedence(exact, unit, wquant, kind):
    assert K.weight_kind(exact, unit, wquant) == kind


@pytest.mark.parametrize("entry", ["ld_majmin_codes", "ld_majmin_planes"])
@pytest.mark.parametrize("kind,suffix", [
    ("unit", ""), ("int", ""), ("lo", "_lo_int8"), ("split", "_split_bf16"),
    ("exact", "_bf16_exact")])
def test_launch_name_of_each_entry_and_kind(entry, kind, suffix):
    assert K.launch_name(entry, kind) == entry + suffix
    assert K.launch_name(entry, kind) in K.launches


def _jax_float_passes(w: np.ndarray, kind: str) -> list:
    """The JAX kernel's bf16 pass weights (pallas_ld.py:922-935) as bf16
    numpy rows: w_hi for every kind, then w_lo for split_bf16."""
    wj = jnp.asarray(w)[None, :]
    w_hi = wj.astype(jnp.bfloat16)
    passes = [np.asarray(w_hi)[0]]
    if kind == "split":
        w_lo = (wj - w_hi.astype(jnp.float32)).astype(jnp.bfloat16)
        passes.append(np.asarray(w_lo)[0])
    return passes


@pytest.mark.parametrize("kind", ["exact", "split", "lo"])
@pytest.mark.parametrize("seed", [0, 1])
def test_float_pass_bits_equal_jax_products(kind, seed):
    # The kernel's B operand is the indicator's set halfwords holding these
    # bits: the same values as JAX's xs * w_hi (pallas_ld.py:929) and
    # xs * w_lo; lo_int8's q level rides as one more pass, exact in bf16.
    rng = np.random.default_rng(seed)
    n = 70
    w = (rng.random(n) + 0.05).astype(np.float32)
    w /= w.max()
    if kind == "exact":
        w = ((np.arange(n) % 4 + 1) / 4.0).astype(np.float32)
    wr = P.pad_weights_lo_int8(w, 64) if kind == "lo" \
        else P.pad_weights(w, 64)
    bits = K.float_pass_bits(torch.from_numpy(wr), kind)
    passes = _jax_float_passes(wr[0], kind)
    want = passes + ([wr[1].astype(ml_dtypes.bfloat16)] if kind == "lo"
                     else [])
    assert bits.dtype == torch.int16 and bits.is_contiguous()
    assert bits.shape == (len(want), wr.shape[1])
    for got, ref in zip(bits.numpy(), want):
        np.testing.assert_array_equal(got.view(np.uint16),
                                      np.asarray(ref).view(np.uint16))
    if kind == "lo":
        np.testing.assert_array_equal(
            bits[1].view(torch.bfloat16).float().numpy(), wr[1])
    x = rng.integers(0, 2, size=(8, wr.shape[1])).astype(np.int8)
    xs = jnp.asarray(x).astype(jnp.bfloat16)
    for p, w_pass in enumerate(passes):
        prod = np.asarray(xs * jnp.asarray(w_pass)[None, :])
        port = torch.where(torch.from_numpy(x) != 0, bits[p], 0)
        np.testing.assert_array_equal(
            port.view(torch.bfloat16).float().numpy(),
            prod.astype(np.float32))


GIB = 1 << 30


@pytest.mark.parametrize("chunk,plane_bytes,budget,want", [
    (1024, GIB, 2 * GIB, True),
    (64, GIB, 2 * GIB, True),
    (2048, 2 * GIB, 2 * GIB, True),
    (200, GIB, 2 * GIB, False),             # 4-byte plane copies
    (40, GIB, 2 * GIB, False),
    (1024, 3 * GIB, 2 * GIB, False),        # the planes do not fit
    (1024, 1, 0, False),                    # the CPU: no budget
])
def test_auto_preplaned_rule(chunk, plane_bytes, budget, want):
    from weightedld_tpu_torch.runtime.driver import auto_preplaned

    assert auto_preplaned(chunk, plane_bytes, budget) is want


@pytest.mark.parametrize("mode", ["int8x3", "int8", "unit", "exact",
                                  "split_bf16", "lo_int8"])
@pytest.mark.parametrize("chunk", [64, 40])
def test_session_auto_entry_in_every_weight_mode(monkeypatch, mode, chunk):
    # The same rule in every weight mode: the planes when they fit and the
    # seq chunk is a multiple of 16, else the codes; the float modes stage
    # the planes alone (their B rows are built in-kernel).
    from weightedld_tpu_torch.runtime import driver

    monkeypatch.setattr(driver, "plane_budget", lambda device: 1 << 40)
    rng = np.random.default_rng(3)
    aln = rng.choice((0, 1, 4), size=(60, 90)).astype(np.int8)
    w = {"unit": np.ones(60, np.float32),
         "exact": ((np.arange(60) % 4 + 1) / 4.0).astype(np.float32)}.get(
             mode, (rng.random(60) + 0.05).astype(np.float32))
    wq = mode if mode in ("int8", "split_bf16", "lo_int8") else "none"
    sess = driver.LdSession(aln, w, np.arange(90),
                            driver.DriverConfig(tile=32, seq_chunk=chunk,
                                                weight_quant=wq),
                            device="cpu")
    kind = K.weight_kind(sess.kernel_kw["exact_weights"],
                         sess.kernel_kw["unit_weights"],
                         sess.kernel_kw["wquant"])
    assert kind == {"int8x3": "int", "int8": "int"}.get(mode, {
        "split_bf16": "split", "lo_int8": "lo"}.get(mode, mode))
    assert sess.preplaned == (chunk % 16 == 0)
    if sess.preplaned:
        planes, xq = sess.operands
        assert planes.shape == (2 * sess.plan.s_pad, 64)
        assert (xq is None) == (kind != "int")
    else:
        assert sess.operands[0].shape == (sess.plan.s_pad, chunk * 2)
