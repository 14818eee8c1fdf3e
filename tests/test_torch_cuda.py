"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips when
``torch.cuda.is_available()`` is False (the decision is made inside a
fixture, never at import).  The module imports torch and the port only, so
it runs on a machine with the card and no JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Inputs are random alignments from numpy seeds, without UNKNOWN codes for
the factorized kernel and with them for the general kernel; tolerance on
kept pairs rtol=1e-5, atol=1e-6 with equal ``keep`` and equal non-finite
patterns (the kernels follow the plain versions' operation order, so in
practice they agree bit for bit).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from weightedld_tpu_torch.ops import cuda_general as G
from weightedld_tpu_torch.ops import cuda_ld as K
from weightedld_tpu_torch.parallel.triangle import plan_tiles
from weightedld_tpu_torch.runtime.driver import (DriverConfig, LdSession,
                                                 plane_budget)

RTOL, ATOL = 1e-5, 1e-6

# id -> (seed, alphabet, n_seqs, n_sites, tile, seq_chunk, weight mode)
CASES = {
    "dna-int8x3": (1, (0, 1, 2, 3, 4), 150, 300, 48, 64, "int8x3"),
    "snp-int8x3-main": (2, (0, 1, 4), 1000, 600, 256, 1024, "int8x3"),
    "dna-unit": (3, (0, 1, 2, 3, 4), 150, 300, 48, 64, "unit"),
    "snp-exact": (4, (0, 1, 4), 150, 300, 48, 64, "exact"),
    "snp-split": (5, (0, 1, 4), 150, 300, 48, 64, "split_bf16"),
    "snp-int8": (6, (0, 3, 4), 150, 300, 48, 64, "int8"),
    "binary-ragged": (7, (0, 1), 37, 90, 32, 40, "unit"),
    "multichunk": (8, (0, 1, 2, 3, 4), 333, 257, 64, 120, "int8x3"),
    "snp-lo_int8-main": (9, (0, 1, 4), 1000, 600, 256, 1024, "lo_int8"),
    "dna-lo_int8": (10, (0, 1, 2, 3, 4), 333, 257, 64, 120, "lo_int8"),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _inputs(name: str, device):
    return _make_inputs(*CASES[name], device)


def _make_inputs(seed, alphabet, n, s, tile, chunk, mode, device,
                 emit_kind="random", monomorphic_tile=False):
    """Kernel arguments for a random alignment.  ``emit_kind``: "random"
    (each tile pair emits with probability 0.8), "mixed" (every third tile
    pair is padding), "none" (no tile pair emits) or "all";
    ``monomorphic_tile``: every site of the first site tile is fixed."""
    rng = np.random.default_rng(seed)
    aln = rng.choice(alphabet, size=(n, s)).astype(np.int8)
    if monomorphic_tile:
        aln[:, :tile] = aln[0, :tile]
    if mode == "unit":
        w = np.ones(n, np.float32)
    elif mode == "exact":
        w = ((np.arange(n) % 4 + 1) / 4.0).astype(np.float32)
    else:
        w = (rng.random(n) + 0.05).astype(np.float32)
        w /= w.max()
    nlev = {"int8": 2, "int8x3": 3}.get(mode, 0)
    wr = _packed_weights(w, chunk, mode)
    plan = plan_tiles(s, tile)
    emit = np.ones(plan.n_tiles, np.int32)
    if emit_kind == "random":
        emit[rng.random(plan.n_tiles) < 0.2] = 0
    elif emit_kind == "mixed":
        emit[1::3] = 0
    elif emit_kind == "none":
        emit[:] = 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    arrays = dict(codes=t(K.pad_alignment_site_major(aln, tile, chunk)),
                  weights=t(wr), auxc=t(K.majmin_site_aux(aln, plan.s_pad)[0]),
                  tile_i=t(plan.tile_i), tile_j=t(plan.tile_j), emit=t(emit))
    kw = dict(tile=tile, n_sites=s, seq_chunk=chunk,
              unit_weights=mode == "unit", exact_weights=mode == "exact",
              wquant=mode if nlev or mode == "lo_int8" else "")
    return arrays, kw, nlev


def _packed_weights(w, chunk, mode):
    nlev = {"int8": 2, "int8x3": 3}.get(mode, 0)
    if nlev:
        return K.pad_weights_int8(w, chunk, levels=nlev)
    if mode == "lo_int8":
        return K.pad_weights_lo_int8(w, chunk)
    return K.pad_weights(w, chunk)


def _assert_match(got: K.PairStats, ref: K.PairStats) -> None:
    keep = ref.keep.cpu()
    assert torch.equal(got.keep.cpu(), keep)
    assert keep.any()
    for f in ("d", "d_prime", "r2"):
        g, r = getattr(got, f).cpu()[keep], getattr(ref, f).cpu()[keep]
        fin = torch.isfinite(r)
        assert torch.equal(torch.isfinite(g), fin), f
        torch.testing.assert_close(g[fin], r[fin], rtol=RTOL, atol=ATOL)


def _run_entry(a, kw, nlev, entry):
    """``(kernel stats, plain stats)`` of one factorized entry point; checks
    that the call launched its kernel once."""
    args = (a["weights"], a["auxc"], a["tile_i"], a["tile_j"], a["emit"])
    before = dict(K.launches)
    if entry == "codes":
        got = K.tile_stats_majmin(a["codes"], *args, **kw)
        ref = K.tile_stats_majmin_plain(a["codes"], *args, **kw)
        kernel = "ld_majmin_codes"
    else:
        planes = K.build_majmin_planes(a["codes"], a["auxc"], tile=kw["tile"])
        xq = K.build_majmin_xq(planes, a["weights"], nlev) if nlev else None
        got = K.tile_stats_majmin_pre(planes, xq, *args, **kw)
        ref = K.tile_stats_majmin_pre_plain(planes, xq, *args, **kw)
        kernel = "ld_majmin_planes"
    kernel = K.launch_name(kernel, K.weight_kind(
        kw["exact_weights"], kw["unit_weights"], kw["wquant"]))
    torch.cuda.synchronize()
    assert K.launches[kernel] == before[kernel] + 1
    return got, ref


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["codes", "pre"])
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_on_card(cuda_device, name, entry):
    a, kw, nlev = _inputs(name, cuda_device)
    _assert_match(*_run_entry(a, kw, nlev, entry))


# The tensor-core body at its edges, in every weight mode.  id -> (seed,
# alphabet, n_seqs, n_sites, tile, seq_chunk, emit kind, monomorphic first
# tile): a tile below, between and above the 64 x 32 site block of a CTA
# (512: the largest the compaction takes); seq chunks that are not
# multiples of 16 (N_pad neither), so every chunk ends in a partial stage
# (128 int8 or 64 bf16 columns) staged 4 bytes at a time; three
# 1,024-column chunks; batches with no emitting tile pair and with every
# third one padding; a tile whose every site is monomorphic.
WGMMA_CASES = {
    "t48-c40": (41, (0, 1, 2, 3, 4), 150, 300, 48, 40, "mixed", False),
    "t96-c120": (42, (0, 1, 4), 333, 500, 96, 120, "mixed", False),
    "t512-c200": (43, (0, 1, 4), 200, 600, 512, 200, "mixed", False),
    "n3000-c1024": (44, (0, 1, 4), 3000, 300, 96, 1024, "mixed", False),
    "emit-none": (45, (0, 1, 2, 3, 4), 150, 300, 96, 64, "none", False),
    "monomorphic": (46, (0, 1, 4), 200, 400, 96, 200, "all", True),
}


# Bit for bit in every mode whose f32 partial sums are exact (the integer
# modes; lo_int8's w_hi and q passes and bf16-exact weights here, the note
# at the top of csrc/ld_majmin.cu); split_bf16's w_lo pass is held to
# RTOL / ATOL.
@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["codes", "pre"])
@pytest.mark.parametrize("mode", ["unit", "int8", "int8x3", "exact",
                                  "split_bf16", "lo_int8"])
@pytest.mark.parametrize("name", list(WGMMA_CASES))
def test_wgmma_body_bit_equal_on_card(cuda_device, name, mode, entry):
    seed, alphabet, n, s, tile, chunk, emit_kind, mono = WGMMA_CASES[name]
    a, kw, nlev = _make_inputs(seed, alphabet, n, s, tile, chunk, mode,
                               cuda_device, emit_kind, mono)
    got, ref = _run_entry(a, kw, nlev, entry)
    keep = ref.keep.cpu()
    assert torch.equal(got.keep.cpu(), keep)
    assert bool(keep.any()) == (emit_kind != "none")
    if mono:
        assert not keep[a["tile_i"].cpu() == 0].any()
    tol = (RTOL, ATOL) if mode == "split_bf16" else (0, 0)
    for f in ("d", "d_prime", "r2"):
        torch.testing.assert_close(getattr(got, f).cpu()[keep],
                                   getattr(ref, f).cpu()[keep], rtol=tol[0],
                                   atol=tol[1], equal_nan=True, msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["ld_majmin_codes", "ld_majmin_planes"])
@pytest.mark.parametrize("nlev,nflt", [(0, 3), (2, 1), (4, 0), (0, 0)])
def test_unbuilt_weight_mode_is_refused(cuda_device, entry, nlev, nflt):
    # dispatch builds one body in six (nlev, nflt) modes and refuses the
    # rest with cudaErrorInvalidValue (1) before anything runs.
    from weightedld_tpu_torch.ops._build import load_library

    a, kw, _ = _inputs("dna-int8x3", cuda_device)
    k = a["tile_i"].shape[0]
    out = torch.empty((k, kw["tile"], kw["tile"]), device=cuda_device)
    keep = torch.empty((k, kw["tile"], kw["tile"]), dtype=torch.int8,
                       device=cuda_device)
    s_pad, n_pad = a["codes"].shape
    rc = getattr(load_library(), entry)(
        a["codes"].data_ptr(), a["codes"].data_ptr(), 0, 0,
        a["auxc"].data_ptr(), a["tile_i"].data_ptr(), a["tile_j"].data_ptr(),
        a["emit"].data_ptr(), out.data_ptr(), out.data_ptr(),
        out.data_ptr(), keep.data_ptr(), k, kw["tile"], kw["n_sites"],
        s_pad, n_pad, kw["seq_chunk"], nlev, nflt,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 1


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices(cuda_device):
    a, kw, _ = _inputs("dna-int8x3", cuda_device)
    with pytest.raises(ValueError):
        K.tile_stats_majmin(a["codes"], a["weights"].cpu(), a["auxc"],
                            a["tile_i"], a["tile_j"], a["emit"], **kw)


@pytest.mark.cuda
def test_auto_preplaned_picks_planes_that_fit(cuda_device):
    # The preplaned entry scans faster in every weight mode measured on
    # the card at 16-byte-aligned seq chunks, so "auto" takes the planes
    # whenever they fit plane_budget.
    rng = np.random.default_rng(12)
    aln = rng.choice((0, 1, 4), size=(300, 500)).astype(np.int8)
    w = (rng.random(300) + 0.05).astype(np.float32)
    for wq in ("none", "int8", "lo_int8", "split_bf16"):
        sess = LdSession(aln, w, np.arange(500),
                         DriverConfig(tile=128, weight_quant=wq),
                         device=cuda_device)
        assert sess.preplaned and sess.codes_dev is None, wq
        planes, xq = sess.operands
        assert planes is not None, wq
        assert (xq is None) == (wq in ("lo_int8", "split_bf16")), wq
    assert plane_budget(cuda_device) > 0


@pytest.mark.cuda
def test_auto_preplaned_takes_codes_for_4_byte_staging(cuda_device):
    # A seq chunk that is not a multiple of 16 leaves the preplaned entry
    # 4-byte copies of its operand rows, where the codes entry scans faster
    # in every weight mode (integer and float).
    rng = np.random.default_rng(12)
    aln = rng.choice((0, 1, 4), size=(300, 500)).astype(np.int8)
    w = (rng.random(300) + 0.05).astype(np.float32)
    exact = ((np.arange(300) % 4 + 1) / 4.0).astype(np.float32)
    for wts, wq in ((w, "none"), (w, "int8"), (np.ones(300, np.float32),
                                               "none"),
                    (w, "lo_int8"), (w, "split_bf16"), (exact, "none")):
        sess = LdSession(aln, wts, np.arange(500),
                         DriverConfig(tile=128, seq_chunk=40,
                                      weight_quant=wq),
                         device=cuda_device)
        assert not sess.preplaned, wq
        assert sess.codes_dev is not None, wq


@pytest.mark.cuda
@pytest.mark.parametrize("preplaned", ["off", "on"])
def test_session_records_equal_on_cpu_and_card(cuda_device, preplaned):
    rng = np.random.default_rng(11)
    aln = rng.choice((0, 1, 4), p=(0.6, 0.3, 0.1),
                     size=(200, 700)).astype(np.int8)
    w = (rng.random(200) + 0.05).astype(np.float32)
    sm = np.arange(700) * 3
    cfg = DriverConfig(tile=128, seq_chunk=64, preplaned=preplaned)
    runs = {}
    for dev in ("cpu", cuda_device):
        sess = LdSession(aln, w, sm, cfg, device=dev)
        recs = [r for _b, r in sess.stream()]
        runs[str(dev)] = [np.concatenate([getattr(r, f) for r in recs])
                          for f in ("pos_a", "pos_b", "d", "d_prime", "r2")]
    for a, b in zip(runs["cpu"], runs[str(cuda_device)]):
        np.testing.assert_array_equal(a, b)


# id -> (seed, alphabet, n_seqs, n_sites, tile, seq_chunk, weight mode,
#        UNKNOWN cell fraction, planes (None = the planes present))
GENERAL_CASES = {
    "dna5-int8x3": (1, (0, 1, 2, 3, 4), 150, 300, 48, 64, "int8x3", 0.05,
                    None),
    "dna5-int8x3-main": (2, (0, 1, 2, 3, 4), 1000, 600, 256, 1024, "int8x3",
                         0.01, None),
    "snp3-unit": (3, (0, 1, 4), 150, 300, 48, 64, "unit", 0.08, None),
    "bin2-exact": (4, (0, 1), 150, 300, 48, 64, "exact", 0.05, None),
    "dna4-split": (5, (0, 1, 2, 4), 150, 300, 48, 64, "split_bf16", 0.03,
                   None),
    "snp3-int8": (6, (0, 3, 4), 150, 300, 48, 64, "int8", 0.02, None),
    "ragged-unit": (7, (0, 1, 2, 3, 4), 37, 90, 32, 40, "unit", 0.05, None),
    "restricted": (8, (0, 1, 2, 3, 4), 333, 257, 64, 120, "int8x3", 0.04,
                   (0, 2, 4)),
    "dna5-lo_int8-main": (9, (0, 1, 2, 3, 4), 1000, 600, 256, 1024,
                          "lo_int8", 0.01, None),
    "restricted-lo_int8": (10, (0, 1, 2, 3, 4), 333, 257, 64, 120, "lo_int8",
                           0.04, (0, 2, 4)),
}


def _general_inputs(name: str, device):
    return _general_case(*GENERAL_CASES[name], device)


def _general_case(seed, alphabet, n, s, tile, chunk, mode, unk, planes,
                  device):
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
    nlev = {"int8": 2, "int8x3": 3}.get(mode, 0)
    wr = _packed_weights(w, chunk, mode)
    plan = plan_tiles(s, tile)
    emit = np.ones(plan.n_tiles, np.int32)
    emit[rng.random(plan.n_tiles) < 0.2] = 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    kw = dict(tile=tile, n_sites=s, seq_chunk=chunk,
              planes=planes or K.detect_planes_unknown(aln)[0],
              unit_weights=mode == "unit", exact_weights=mode == "exact",
              wquant=mode if nlev or mode == "lo_int8" else "")
    return (t(K.pad_alignment_site_major(aln, tile, chunk)), t(wr),
            t(plan.tile_i), t(plan.tile_j), t(emit), kw)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["codes", "pre"])
@pytest.mark.parametrize("name", list(GENERAL_CASES))
def test_general_kernel_matches_plain_on_card(cuda_device, name, entry):
    codes, wr, ti, tj, em, kw = _general_inputs(name, cuda_device)
    src = codes
    if entry == "pre":
        src = G.build_planes_tiled(codes, tile=kw["tile"], planes=kw["planes"])
        kernel = "ld_general_planes"
    else:
        kernel = "ld_general_unit" if kw["unit_weights"] else "ld_general"
    kernel = K.launch_name(kernel, K.weight_kind(
        kw["exact_weights"], kw["unit_weights"], kw["wquant"]))
    before = dict(G.launches)
    got = G.tile_stats_general(src, wr, ti, tj, em, preplaned=entry == "pre",
                               **kw)
    ref = G.tile_stats_general_plain(src, wr, ti, tj, em,
                                     preplaned=entry == "pre", **kw)
    torch.cuda.synchronize()
    assert G.launches[kernel] == before[kernel] + 1
    _assert_match(got, ref)


# The tensor-core body at its edges, in every weight mode and both entries.
# id -> (seed, alphabet, n_seqs, n_sites, tile, seq_chunk, UNKNOWN cell
# fraction, planes): P = 2..5 (blocks of 128 / P A sites x 8-96 B sites);
# T = 512 and tiles below a block; seq chunks that are not multiples of 16
# (4-byte staging, partial stages); N = 3,000 in three chunks; a restricted
# planes tuple.
GENERAL_EDGE_CASES = {
    "p2-t512-c200": (51, (0, 1), 200, 600, 512, 200, 0.03, None),
    "p3-t96-c40": (52, (0, 1, 2), 150, 300, 96, 40, 0.05, None),
    "p4-n3000": (53, (0, 1, 2, 4), 3000, 300, 96, 1024, 0.02, None),
    "p5-t512-c200": (54, (0, 1, 2, 3, 4), 200, 600, 512, 200, 0.01, None),
    "restricted-t48": (55, (0, 1, 2, 3, 4), 150, 300, 48, 120, 0.05,
                       (1, 3, 4)),
    "p5-n3000": (56, (0, 1, 2, 3, 4), 3000, 300, 96, 1024, 0.02, None),
}


# Bit for bit in every mode but split_bf16: the integer modes always, and
# lo_int8's and bf16-exact's weights here keep every f32 partial sum exact
# (the note at the top of csrc/ld_general.cu).
@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["codes", "pre"])
@pytest.mark.parametrize("mode", ["unit", "int8", "int8x3", "exact",
                                  "split_bf16", "lo_int8"])
@pytest.mark.parametrize("name", list(GENERAL_EDGE_CASES))
def test_general_wgmma_body_bit_equal_on_card(cuda_device, name, mode,
                                              entry):
    seed, alphabet, n, s, tile, chunk, unk, planes = GENERAL_EDGE_CASES[name]
    codes, wr, ti, tj, em, kw = _general_case(seed, alphabet, n, s, tile,
                                              chunk, mode, unk, planes,
                                              cuda_device)
    src = codes
    if entry == "pre":
        src = G.build_planes_tiled(codes, tile=tile, planes=kw["planes"])
    got = G.tile_stats_general(src, wr, ti, tj, em, preplaned=entry == "pre",
                               **kw)
    ref = G.tile_stats_general_plain(src, wr, ti, tj, em,
                                     preplaned=entry == "pre", **kw)
    torch.cuda.synchronize()
    keep = ref.keep.cpu()
    assert torch.equal(got.keep.cpu(), keep)
    assert keep.any()
    tol = (RTOL, ATOL) if mode == "split_bf16" else (0, 0)
    for f in ("d", "d_prime", "r2"):
        torch.testing.assert_close(getattr(got, f).cpu()[keep],
                                   getattr(ref, f).cpu()[keep], rtol=tol[0],
                                   atol=tol[1], equal_nan=True, msg=f)


# dispatch builds one body for P = 1..5 in six modes and refuses the rest
# with cudaErrorInvalidValue (1) before anything runs; the unit entry
# ignores nlev and nflt, so only P refuses there.
@pytest.mark.cuda
@pytest.mark.parametrize("entry,nlev,nflt,n_planes", [
    ("ld_general", 0, 3, 5), ("ld_general", 2, 1, 5),
    ("ld_general", 4, 0, 5), ("ld_general", 0, 0, 5),
    ("ld_general", 3, 0, 0), ("ld_general", 3, 0, 6),
    ("ld_general_unit", 3, 0, 0), ("ld_general_unit", 3, 0, 6)])
def test_general_unbuilt_mode_is_refused(cuda_device, entry, nlev, nflt,
                                         n_planes):
    from weightedld_tpu_torch.ops._build import load_library

    codes, wr, ti, tj, em, kw = _general_inputs("dna5-int8x3", cuda_device)
    k, t = ti.shape[0], kw["tile"]
    out = torch.empty((k, t, t), device=cuda_device)
    keep = torch.empty((k, t, t), dtype=torch.int8, device=cuda_device)
    s_pad, n_pad = codes.shape
    rc = getattr(load_library(), entry)(
        codes.data_ptr(), 0, wr.data_ptr(), wr.data_ptr(), wr.data_ptr(),
        ti.data_ptr(), tj.data_ptr(), em.data_ptr(), out.data_ptr(),
        out.data_ptr(), out.data_ptr(), keep.data_ptr(), k, t,
        kw["n_sites"], s_pad, n_pad, kw["seq_chunk"], nlev, nflt, n_planes,
        sum(c << (3 * i) for i, c in enumerate(kw["planes"])),
        torch.cuda.current_stream().cuda_stream)
    assert rc == 1


def _scattered_alignment(rng, n_seqs, n_sites, n_dirty):
    """Near-balanced sites with 1-2 UNKNOWN cells at ``n_dirty`` sites."""
    aln = rng.choice((0, 1, 2, 3, 4), size=(n_seqs, n_sites)).astype(np.int8)
    for s in rng.choice(n_sites, size=n_dirty, replace=False):
        aln[rng.choice(n_seqs, size=rng.integers(1, 3), replace=False), s] = 5
    return aln


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,unit", [("auto", False), ("auto", True),
                                         ("general", False)])
def test_hybrid_session_records_equal_on_cpu_and_card(cuda_device, kernel,
                                                      unit):
    rng = np.random.default_rng(13)
    aln = _scattered_alignment(rng, 200, 700, 20)
    w = np.ones(200, np.float32) if unit \
        else (rng.random(200) + 0.05).astype(np.float32)
    cfg = DriverConfig(tile=128, seq_chunk=64, kernel=kernel)
    runs = {}
    for dev in ("cpu", cuda_device):
        sess = LdSession(aln, w, np.arange(700) * 2, cfg, device=dev)
        if kernel == "auto":
            assert sess.site_perm is not None
            assert sess.phase_tiles["majmin"] > 0
        assert sess.phase_tiles["general"] > 0
        recs = [r for _b, r in sess.stream()]
        runs[str(dev)] = [np.concatenate([getattr(r, f) for r in recs])
                          for f in ("pos_a", "pos_b", "d", "d_prime", "r2")]
    for a, b in zip(runs["cpu"], runs[str(cuda_device)]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,weight_quant", [("auto", "none"),
                                                 ("auto", "lo_int8"),
                                                 ("general", "none")])
def test_analytics_equal_on_cpu_and_card(cuda_device, kernel, weight_quant):
    rng = np.random.default_rng(14)
    aln = _scattered_alignment(rng, 200, 700, 20)
    w = (rng.random(200) + 0.05).astype(np.float32)
    sm = np.arange(700) * 2 + 1
    cfg = DriverConfig(tile=128, seq_chunk=64, kernel=kernel,
                       weight_quant=weight_quant)
    runs = {}
    for dev in ("cpu", cuda_device):
        sess = LdSession(aln, w, sm, cfg, device=dev)
        runs[str(dev)] = (sess.summarize(r2_threshold=0.02),
                          sess.ld_decay((0, 10, 100, 1000, 2000)),
                          sess.r2_histogram((0.0, 0.01, 0.05, 1.01)),
                          sess.prune(0.05).tolist(),
                          sess.top_pairs(40), sess.matrices(np.float16))
    cpu, card = runs["cpu"], runs[str(cuda_device)]
    for key in ("n_pairs", "n_over_threshold", "r2_max"):
        assert cpu[0][key] == card[0][key]
    assert cpu[0]["r2_sum_over_threshold"] == pytest.approx(
        card[0]["r2_sum_over_threshold"], rel=1e-5)
    assert cpu[1]["n_pairs"] == card[1]["n_pairs"]
    np.testing.assert_allclose(cpu[1]["r2_sum"], card[1]["r2_sum"],
                               rtol=1e-5)
    assert cpu[2] == card[2] and cpu[3] == card[3]
    np.testing.assert_array_equal(np.sort(cpu[4].r2), np.sort(card[4].r2))
    for f in ("keep", "d", "d_prime", "r2"):
        np.testing.assert_array_equal(cpu[5][f], card[5][f])
