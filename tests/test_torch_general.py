"""Parity of the port's general-kernel module (weightedld_tpu_torch.ops.
cuda_general) with the JAX package's general Pallas kernels.

The same numpy inputs — alignments with UNKNOWN (code 5) cells — go through
``pallas_tile_stats`` in interpret mode (``_ld_kernel`` / ``_ld_kernel_unit``
and ``_ld_finalize``, as tests/test_pallas_ld.py runs them) and through the
port's ``tile_stats_general`` on CPU tensors, which runs the plain PyTorch
version.  Cases: P = 2..5 allele planes, every weight mode, several seq
chunks, ragged S and N, emit == 0 tiles, a restricted ``planes`` tuple, and
both operand sources (codes, and the one-hot planes of
``build_planes_tiled``).  Tolerance on kept pairs: rtol=1e-5, atol=1e-6,
``keep`` equal, non-finite patterns equal.

With FMA instructions withheld from XLA's CPU backend
(``XLA_FLAGS=--xla_cpu_max_isa=AVX``, in a subprocess; see
tests/test_torch_majmin.py) every case agrees bit for bit: the integer
weight modes always, the float modes because their f32 sums are exact at
these sizes.  The ``bitwise`` tests hold that.

The kernel-vs-plain tests on the card are in tests/test_torch_cuda.py.
"""

from __future__ import annotations

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
from weightedld_tpu_torch.ops import cuda_general as G
from weightedld_tpu_torch.ops import cuda_ld as K

from .test_torch_majmin import assert_stats_match

REPO = Path(__file__).resolve().parent.parent

# id -> (seed, alphabet, n_seqs, n_sites, tile, seq_chunk, weight mode,
#        UNKNOWN cell fraction, planes (None = the planes present))
CASES = {
    "dna5-int8x3": (1, (0, 1, 2, 3, 4), 50, 70, 16, 64, "int8x3", 0.05, None),
    "dna4-int8": (2, (0, 1, 2, 4), 50, 70, 16, 64, "int8", 0.05, None),
    "snp3-unit": (3, (0, 1, 4), 48, 40, 16, 64, "unit", 0.08, None),
    "bin2-exact": (4, (0, 1), 48, 40, 16, 64, "exact", 0.1, None),
    "dna5-split": (5, (0, 1, 2, 3, 4), 50, 45, 16, 64, "split_bf16", 0.05,
                   None),
    "multichunk": (6, (0, 1, 2, 3, 4), 150, 40, 16, 64, "int8x3", 0.03,
                   None),
    "ragged": (7, (0, 1, 2, 4), 37, 45, 32, 20, "int8x3", 0.08, None),
    "restricted": (8, (0, 1, 2, 3, 4), 50, 70, 16, 64, "int8x3", 0.05,
                   (0, 1, 3)),
    "restricted-unit": (9, (0, 1, 2, 3, 4), 150, 40, 16, 64, "unit", 0.02,
                        (2, 4)),
}


def make_case(name: str) -> dict:
    """Numpy inputs of one case (both packages build from these)."""
    seed, alphabet, n, s, tile, chunk, mode, unk, planes = CASES[name]
    rng = np.random.default_rng(seed)
    aln = rng.choice(alphabet, size=(n, s)).astype(np.int8)
    aln[rng.random(aln.shape) < unk] = 5
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
    if planes is None:
        planes = P.detect_planes(aln)
    return dict(
        codes=P.pad_alignment_site_major(aln, tile, chunk),
        weights=wr, tile_i=plan.tile_i, tile_j=plan.tile_j, emit=emit,
        kw=dict(tile=tile, n_sites=s, seq_chunk=chunk, planes=planes,
                unit_weights=mode == "unit", exact_weights=mode == "exact",
                wquant=mode if mode in ("int8", "int8x3") else ""))


def jax_stats(c: dict, entry: str) -> dict:
    """``pallas_tile_stats`` in interpret mode, as numpy arrays."""
    src = jnp.asarray(c["codes"])
    if entry == "pre":
        src = P.build_planes_tiled(src, tile=c["kw"]["tile"],
                                   planes=c["kw"]["planes"])
    st = P.pallas_tile_stats(
        src, jnp.asarray(c["weights"]), jnp.asarray(c["tile_i"]),
        jnp.asarray(c["tile_j"]), jnp.asarray(c["emit"]),
        preplaned=entry == "pre", interpret=True, **c["kw"])
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def port_stats(c: dict, entry: str) -> dict:
    t = {k: torch.from_numpy(np.ascontiguousarray(c[k]))
         for k in ("codes", "weights", "tile_i", "tile_j", "emit")}
    src = t["codes"]
    if entry == "pre":
        src = G.build_planes_tiled(src, tile=c["kw"]["tile"],
                                   planes=c["kw"]["planes"])
    st = G.tile_stats_general(src, t["weights"], t["tile_i"], t["tile_j"],
                              t["emit"], preplaned=entry == "pre",
                              **c["kw"])
    return {f: getattr(st, f).numpy() for f in st._fields}


@pytest.mark.parametrize("entry", ["codes", "pre"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_interpret(name, entry):
    c = make_case(name)
    assert_stats_match(port_stats(c, entry), jax_stats(c, entry))


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
            "from tests.test_torch_general import _jax_reference_no_fma; "
            "_jax_reference_no_fma(sys.argv[2])")
    subprocess.run([sys.executable, "-c", code, str(REPO), str(out)],
                   env=env, check=True, timeout=600, cwd=REPO)
    return dict(np.load(out))


@pytest.mark.parametrize("entry", ["codes", "pre"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_bitwise_vs_jax_without_fma(jax_no_fma, name, entry):
    ref = {f: jax_no_fma[f"{name}/{entry}/{f}"]
           for f in ("d", "d_prime", "r2", "keep")}
    assert_stats_match(port_stats(make_case(name), entry), ref, bitwise=True)


# ---------------------------------------------------------------------------
# Host copies and the plane builder: equal to the JAX package's.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,alphabet,p_unknown", [
    (0, (0, 1, 2, 3, 4), 0.01), (1, (0, 1), 0.05), (2, (0, 1, 4), 0.0),
    (3, (2,), 0.02)])
def test_margins_equal_jax(seed, alphabet, p_unknown):
    from weightedld_tpu.core.sites import site_histogram_host

    rng = np.random.default_rng(seed)
    aln = rng.choice(alphabet, size=(90, 75)).astype(np.int8)
    aln[rng.random(aln.shape) < p_unknown] = 5
    counts = site_histogram_host(aln)
    for got, want in zip(K.majmin_site_margins(counts, 90),
                         P.majmin_site_margins(counts, 90)):
        np.testing.assert_array_equal(got, want)
    for tile in (16, 32):
        grid = -(-75 // tile)
        for got, want in zip(K.majmin_tile_margins(counts, 90, tile, grid),
                             P.majmin_tile_margins(counts, 90, tile, grid)):
            np.testing.assert_array_equal(got, want)
    assert K._MARGIN_INF == P._MARGIN_INF
    assert K.ALL_PLANES == P.ALL_PLANES
    assert K.detect_planes_unknown(aln) == P.detect_planes_unknown(aln)


@pytest.mark.parametrize("planes", [(0, 1, 2, 3, 4), (0, 1, 4), (3,)])
def test_build_planes_tiled_equal_jax(planes):
    c = make_case("dna5-int8x3")
    tile = c["kw"]["tile"]
    want = np.asarray(P.build_planes_tiled(jnp.asarray(c["codes"]),
                                           tile=tile, planes=planes))
    got = G.build_planes_tiled(torch.from_numpy(c["codes"]), tile=tile,
                               planes=planes)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Wrapper checks: bad inputs raise; nothing falls back.
# ---------------------------------------------------------------------------


def _cpu_args(name="dna5-int8x3"):
    c = make_case(name)
    t = {k: torch.from_numpy(np.ascontiguousarray(c[k]))
         for k in ("codes", "weights", "tile_i", "tile_j", "emit")}
    return c, t


@pytest.mark.parametrize("breakage,exc", [
    ("planes_repeat", ValueError),
    ("planes_code", ValueError),
    ("weights_rows", ValueError),
    ("codes_dtype", TypeError),
    ("preplaned_rows", ValueError),
    ("tile_index", ValueError),
    ("lo_int8", None),             # ported: runs, and equals JAX's kernel
    ("meta_device", ValueError),
])
def test_wrapper_raises_on_bad_input(breakage, exc):
    c, t = _cpu_args()
    kw = dict(c["kw"])
    codes, weights, ti = t["codes"], t["weights"], t["tile_i"]
    if breakage == "planes_repeat":
        kw["planes"] = (0, 1, 1)
    elif breakage == "planes_code":
        kw["planes"] = (0, 5)
    elif breakage == "weights_rows":
        weights = weights[:4].contiguous()
    elif breakage == "codes_dtype":
        codes = codes.to(torch.int32)
    elif breakage == "preplaned_rows":
        kw["preplaned"] = True
        codes = G.build_planes_tiled(codes, tile=kw["tile"])[:-1].contiguous()
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
        st = G.tile_stats_general(codes, weights, ti, t["tile_j"], t["emit"],
                                  **kw)
        assert_stats_match({f: getattr(st, f).numpy() for f in st._fields},
                           jax_stats(c, "codes"))
        return
    with pytest.raises(exc):
        G.tile_stats_general(codes, weights, ti, t["tile_j"], t["emit"],
                             **kw)


def test_cpu_wrapper_launches_nothing():
    G.reset_launches()
    c, t = _cpu_args("snp3-unit")
    G.tile_stats_general(t["codes"], t["weights"], t["tile_i"], t["tile_j"],
                         t["emit"], **c["kw"])
    assert set(G.launches) == {
        entry + suffix for entry in ("ld_general", "ld_general_planes")
        for suffix in ("", "_lo_int8", "_split_bf16", "_bf16_exact")} | {
        "ld_general_unit"}
    assert not any(G.launches.values())
