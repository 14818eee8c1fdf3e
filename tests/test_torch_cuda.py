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
# planes tuple; at P = 5 and T = 256, diagonal tile pairs and a ragged last
# tile of 88 sites, and a last tile of one site (its diagonal tile pair
# wholly dead), where the kernel runs only the live work items.
GENERAL_EDGE_CASES = {
    "p2-t512-c200": (51, (0, 1), 200, 600, 512, 200, 0.03, None),
    "p3-t96-c40": (52, (0, 1, 2), 150, 300, 96, 40, 0.05, None),
    "p4-n3000": (53, (0, 1, 2, 4), 3000, 300, 96, 1024, 0.02, None),
    "p5-t512-c200": (54, (0, 1, 2, 3, 4), 200, 600, 512, 200, 0.01, None),
    "restricted-t48": (55, (0, 1, 2, 3, 4), 150, 300, 48, 120, 0.05,
                       (1, 3, 4)),
    "p5-n3000": (56, (0, 1, 2, 3, 4), 3000, 300, 96, 1024, 0.02, None),
    "p5-t256-ragged": (57, (0, 1, 2, 3, 4), 300, 600, 256, 256, 0.02, None),
    "p5-t256-one-site": (58, (0, 1, 2, 3, 4), 200, 513, 256, 200, 0.02,
                         None),
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


@pytest.mark.cuda
def test_traced_live_items_of_the_pol_cell_on_card(cuda_device):
    """On the CPU-size input of the benchmark's ``hiv_pol_iupac``
    (``ldbench/tiny``: some 385 kept sites, a diagonal tile pair and a
    ragged last tile), each general ``batch.kernel`` span of a traced query
    counts the launch's work items and its live ones as a search over every
    pair of every item does, with the block the library names."""
    import json
    import time
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from ldbench.harness import loops, spec
    from weightedld_tpu_torch.runtime import profiling

    from .test_torch_general_items import live_blocks

    lb = Path(__file__).resolve().parents[1] / "ldbench"
    cfg = {**json.loads((lb / "configs" / "hiv_pol_iupac.json").read_text()),
           **json.loads((lb / "tiny" / "hiv_pol_iupac.json").read_text())}
    data = spec.load_module(lb / "generators" / "iupac_fasta.py").generate(
        cfg, 2**31 + 41, "cpu")
    mix = json.loads((lb / "traffic" / "session.json").read_text())
    sess, _pos, _codes = loops.build_session(cfg, data, mix, "cuda")
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU]):
        sess.summarize()
    spans = [s for s in profiling.spans() if s.start >= t0
             and s.name == "batch.kernel" and s.attrs["kernel"] == "general"]
    batches = [b for b in range(sess.n_batches)
               if sess._locate(b)[0].kernel == "general"]
    assert len(spans) == len(batches) > 0
    kw = sess.general_kw
    block = G.work_block(len(sess.planes), exact_weights=kw["exact_weights"],
                         unit_weights=kw["unit_weights"], wquant=kw["wquant"],
                         preplaned=kw["preplaned"])
    assert block[0] == 128 // len(sess.planes) // 8 * 8
    for b, sp in zip(batches, spans):
        ti, tj, em = sess.batch_tiles_host(b)
        want = live_blocks(ti, tj, em, tile=sess.cfg.tile,
                           n_sites=sess.n_sites, block=block)
        assert 0 < want.sum() < want.size
        assert (sp.attrs["items"], sp.attrs["live_items"]) == (
            want.size, int(want.sum()))


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


@pytest.mark.cuda
@pytest.mark.parametrize("shards", (1, 2))
def test_margin_packed_session_bit_equal_on_card(cuda_device, shards):
    """An alignment with UNKNOWN cells at every site, its margin-stable
    sites packed first (``packing_permutation``'s margin split), so its
    stable tile pairs run the factorized kernel and the rest the general
    one.  Every kept pair's r2, D and D' bit-equal to a
    ``kernel="general"`` session fed the sites in the packed order (the
    factorized cells are the general kernel's), and against the general
    session in input order the same records, within the
    ``hiv_pol_iupac.session`` cell's limits where a pair's sites swap
    sides.  Two shards take two cards where two are visible, else share
    ``cuda:0``."""
    from .test_torch_margin_packing import (
        N_SEQS,
        SITE_MAP,
        TILE,
        all_dirty,
        assert_within_limits,
        unlay,
    )

    aln = all_dirty()
    w = (np.random.default_rng(15).random(N_SEQS) + 0.05).astype(np.float32)
    devs = ([torch.device("cuda", i % torch.cuda.device_count())
             for i in range(shards)])

    def run(codes, sm, kernel):
        sess = LdSession(codes, w, sm,
                         DriverConfig(tile=TILE, r2_threshold=0.05,
                                      tiles_per_shard_batch=2, kernel=kernel),
                         devices=devs)
        recs = {}
        for _b, r in sess.stream():
            for a, b, *vals in zip(r.pos_a.tolist(), r.pos_b.tolist(),
                                   r.d.tolist(), r.d_prime.tolist(),
                                   r.r2.tolist()):
                recs[min(a, b), max(a, b)] = vals
        return sess, recs, sess.matrices()

    sess, recs, mats = run(aln, SITE_MAP, "auto")
    perm = sess.site_perm
    assert perm is not None
    assert sess.phase_tiles["majmin"] > 0 < sess.phase_tiles["general"]
    _s, laid_recs, laid = run(aln[:, perm], SITE_MAP[perm], "general")
    _s, g_recs, g_mats = run(aln, SITE_MAP, "general")
    laid = unlay(laid, perm)
    keep = mats["keep"]
    assert len(recs) > 100 and recs == laid_recs
    np.testing.assert_array_equal(keep, laid["keep"])
    np.testing.assert_array_equal(keep, g_mats["keep"])
    for f in ("d", "d_prime", "r2"):
        assert mats[f][keep].tobytes() == laid[f][keep].tobytes(), f
    assert recs.keys() == g_recs.keys()
    assert_within_limits(*(mats[f][keep] for f in ("d", "d_prime", "r2")),
                         *(g_mats[f][keep] for f in ("d", "d_prime", "r2")))


@pytest.mark.cuda
@pytest.mark.parametrize("unit", (False, True))
def test_xla_engine_on_card_equals_cpu(cuda_device, unit):
    """``engine="xla"`` on the card against the CPU (cuBLAS against the CPU
    GEMM: summation orders differ, so values at rtol 1e-5 / atol 1e-6 and
    the same kept pairs), with no kernel launched and no bit changed by
    ``float32_matmul_precision("high")``."""
    rng = np.random.default_rng(15)
    aln = _scattered_alignment(rng, 200, 700, 20)
    w = np.ones(200, np.float32) if unit \
        else (rng.random(200) + 0.05).astype(np.float32)
    cfg = DriverConfig(engine="xla", tile=128)
    runs = {}
    for dev in ("cpu", cuda_device):
        sess = LdSession(aln, w, np.arange(700) * 2, cfg, device=dev)
        assert sess.phase_tiles["xla"] == sess.plan.n_tiles
        K.reset_launches()
        G.reset_launches()
        recs = [r for _b, r in sess.stream()]
        assert not any({**K.launches, **G.launches}.values())
        runs[str(dev)] = [np.concatenate([getattr(r, f) for r in recs])
                          for f in ("pos_a", "pos_b", "d", "d_prime", "r2")]
        if dev != "cpu":
            before = torch.get_float32_matmul_precision()
            torch.set_float32_matmul_precision("high")
            try:
                high = [r for _b, r in sess.stream()]
            finally:
                torch.set_float32_matmul_precision(before)
            for f, want in zip(("pos_a", "pos_b", "d", "d_prime", "r2"),
                               runs[str(dev)]):
                got = np.concatenate([getattr(r, f) for r in high])
                assert got.tobytes() == want.tobytes(), f
    cpu, card = runs["cpu"], runs[str(cuda_device)]
    np.testing.assert_array_equal(cpu[0], card[0])
    np.testing.assert_array_equal(cpu[1], card[1])
    for a, b in zip(cpu[2:], card[2:]):
        fin = np.isfinite(a)
        np.testing.assert_array_equal(fin, np.isfinite(b))
        np.testing.assert_allclose(b[fin], a[fin], rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# The LD-decay kernel (csrc/ld_reduce.cu) against its plain version
# ---------------------------------------------------------------------------

# id -> (DriverConfig keywords, sites with UNKNOWN cells)
DECAY_SOURCES = {
    "majmin": (dict(tile=128, seq_chunk=64), 0),
    "general": (dict(tile=128, seq_chunk=64, kernel="general"), 20),
    "hybrid-packed": (dict(tile=128, seq_chunk=64), 20),
    "xla": (dict(tile=128, engine="xla"), 20),
    "windowed": (dict(tile=128, seq_chunk=64, max_bp_distance=300), 0),
}
DECAY_SITES = 700                      # 5 tiles and a padded last one
DECAY_POS = np.arange(DECAY_SITES) * 2 + 1


def _decay_edges(n_bins: int) -> tuple:
    """``n_bins`` bins from below 0 to past the largest distance (1,398):
    1, 2 and 5 bins take one launch, 40 five launches of 8 bins and 300
    38 launches, the last of 4 bins."""
    fixed = {1: (0, 700), 2: (0, 100, 1000),
             5: (-7, 0, 10, 100, 1000, 2000)}
    if n_bins in fixed:
        return fixed[n_bins]
    edges = tuple(int(e) for e in np.linspace(-3, 1500, n_bins + 1))
    assert len(set(edges)) == n_bins + 1
    return edges


def _decay_session(source: str, device, devices=None) -> LdSession:
    kw, dirty = DECAY_SOURCES[source]
    rng = np.random.default_rng(16)
    aln = _scattered_alignment(rng, 200, DECAY_SITES, dirty)
    w = (rng.random(200) + 0.05).astype(np.float32)
    cfg = DriverConfig(**kw)
    if devices is not None:
        return LdSession(aln, w, DECAY_POS, cfg, devices=devices)
    return LdSession(aln, w, DECAY_POS, cfg, device=device)


def _assert_bins(got: torch.Tensor, want: torch.Tensor) -> None:
    """Counts equal, sums within rtol 1e-6 (the kernel sums in float64,
    the plain version in float32), NaN where the plain version has it."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    assert g.shape == w.shape and got.dtype == torch.float64
    np.testing.assert_array_equal(g[:, [0, 3]], w[:, [0, 3]])
    np.testing.assert_allclose(g[:, [1, 2]], w[:, [1, 2]], rtol=1e-6,
                               atol=0, equal_nan=True)


def _plain_bins(st, ti, tj, sm, edges, tile) -> torch.Tensor:
    from weightedld_tpu_torch.parallel.analytics import decay_batch_plain

    cpu = K.PairStats(*(x.cpu() for x in st))
    return decay_batch_plain(cpu, ti.cpu(), tj.cpu(), sm.cpu(), edges,
                             tile=tile)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bins", (1, 2, 5, 40, 300))
@pytest.mark.parametrize("source", list(DECAY_SOURCES))
def test_decay_kernel_matches_plain_on_card(cuda_device, source, n_bins):
    """Every batch of a session on each producer of ``PairStats`` (the
    factorized and general kernels, the hybrid's packed plan, the XLA
    engine, a bp window folded into keep), through ``decay_batch`` on the
    card against ``decay_batch_plain`` on the CPU copies of the same
    stats; ceil(B / 8) launches a batch; the same bits on a second
    run."""
    from weightedld_tpu_torch.parallel import analytics

    sess = _decay_session(source, cuda_device)
    if source == "hybrid-packed":
        assert sess.site_perm is not None
    assert sess.plan.s_pad > DECAY_SITES
    edges = _decay_edges(n_bins)
    sm = sess._site_map_dev("ld_decay")
    t = sess.cfg.tile
    for b in range(sess.n_batches):
        st, ti, tj = sess._dispatch(b)
        analytics.reset_launches()
        got = analytics.decay_batch(st, ti, tj, sm, edges, tile=t)
        again = analytics.decay_batch(st, ti, tj, sm, edges, tile=t)
        torch.cuda.synchronize()
        assert analytics.launches == {"ld_decay_bins": 2 * -(-n_bins // 8)}
        assert got.cpu().numpy().tobytes() == again.cpu().numpy().tobytes()
        want = _plain_bins(st, ti, tj, sm, edges, t)
        _assert_bins(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bins", (5, 40))
def test_decay_kernel_nan_and_infinite_d_prime_on_card(cuda_device, n_bins):
    """Kept pairs with NaN and infinite D' (left out of the |D'| sum and
    its count) and one kept pair with a NaN r2 (its bin's r2 sum NaN, no
    other bin's), against the plain version."""
    from weightedld_tpu_torch.parallel import analytics

    sess = _decay_session("majmin", cuda_device)
    edges = _decay_edges(n_bins)
    sm = sess._site_map_dev("ld_decay")
    st, ti, tj = sess._dispatch(0)
    kept = torch.nonzero(st.keep.reshape(-1)).reshape(-1)
    assert kept.numel() > 100
    dp, r2 = st.d_prime.clone(), st.r2.clone()
    dp.view(-1)[kept[::7]] = float("nan")
    dp.view(-1)[kept[3::11]] = float("inf")
    dp.view(-1)[kept[5::13]] = -float("inf")
    r2.view(-1)[kept[kept.numel() // 2]] = float("nan")
    st = K.PairStats(st.d, dp, r2, st.keep)
    got = analytics.decay_batch(st, ti, tj, sm, edges, tile=sess.cfg.tile)
    want = _plain_bins(st, ti, tj, sm, edges, sess.cfg.tile)
    assert np.isnan(want[:, 1].numpy()).sum() == 1
    _assert_bins(got, want)


def _shifted(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` one element past an aligned address."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return flat[1:].view(x.shape).copy_(x)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bins", (2, 5, 40))
@pytest.mark.parametrize("tile", (10, 12, 64))
def test_decay_kernel_on_hand_built_stats_on_card(cuda_device, tile, n_bins):
    """Random stats at tiles that take the one-slot loads (T = 10) and the
    16-byte ones (12, 64), unkept slots NaN, positions permuted inside the
    tiles; and the same stats one element past an aligned address (the
    one-slot loads again)."""
    from weightedld_tpu_torch.parallel import analytics

    rng = np.random.default_rng(tile * 100 + n_bins)
    k, grid = 37, 9
    pos = rng.permutation(np.cumsum(rng.integers(0, 9, grid * tile)))
    keep = rng.random((k, tile, tile)) < 0.7
    r2 = rng.random((k, tile, tile)).astype(np.float32)
    dp = rng.uniform(-1, 1, (k, tile, tile)).astype(np.float32)
    r2[~keep] = dp[~keep] = np.nan
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
    ti = t(rng.integers(0, grid, k).astype(np.int32))
    tj = t(rng.integers(0, grid, k).astype(np.int32))
    sm = t(pos.astype(np.int32))
    edges = _decay_edges(n_bins)
    st = K.PairStats(t(np.zeros_like(r2)), t(dp), t(r2), t(keep))
    for st in (st, K.PairStats(*(_shifted(x) for x in st))):
        got = analytics.decay_batch(st, ti, tj, sm, edges, tile=tile)
        _assert_bins(got, _plain_bins(st, ti, tj, sm, edges, tile))
        assert got[:, 0].sum() > 0


@pytest.mark.cuda
def test_decay_kernel_refuses_what_it_does_not_take(cuda_device):
    from weightedld_tpu_torch.parallel import analytics

    sess = _decay_session("majmin", cuda_device)
    sm = sess._site_map_dev("ld_decay")
    st, ti, tj = sess._dispatch(0)
    t = sess.cfg.tile
    with pytest.raises(ValueError, match="contiguous"):
        analytics.decay_batch(
            K.PairStats(st.d, st.d_prime, st.r2.transpose(1, 2), st.keep),
            ti, tj, sm, (0, 10), tile=t)
    with pytest.raises(TypeError, match="keep must be torch.bool"):
        analytics.decay_batch(
            K.PairStats(st.d, st.d_prime, st.r2, st.keep.to(torch.uint8)),
            ti, tj, sm, (0, 10), tile=t)
    with pytest.raises(ValueError, match="is on cpu"):
        analytics.decay_batch(st, ti, tj, sm.cpu(), (0, 10), tile=t)
    empty = K.PairStats(*(x[:0] for x in st))
    got = analytics.decay_batch(empty, ti[:0], tj[:0], sm, (0, 10, 20),
                                tile=t)
    assert got.tolist() == [[0.0] * 4] * 2


@pytest.mark.cuda
def test_decay_kernel_faults_on_a_tile_index_out_of_range(cuda_device):
    """A tile index past ``S_pad / T`` stops the kernel with a device fault
    (in a child process: the fault ends its CUDA context) instead of
    reading outside the site map; the same call in range succeeds."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent(f"""
        import sys, torch
        from weightedld_tpu_torch.core.paircore import PairStats
        from weightedld_tpu_torch.parallel.analytics import decay_batch
        dev = torch.device({str(cuda_device)!r})
        k, t = 3, 16
        st = PairStats(*(torch.zeros((k, t, t), device=dev)
                         for _ in range(3)),
                       torch.ones((k, t, t), dtype=torch.bool, device=dev))
        sm = torch.arange(4 * t, dtype=torch.int32, device=dev)
        ti = torch.tensor([0, 1, int(sys.argv[1])], dtype=torch.int32,
                          device=dev)
        tj = torch.tensor([1, 2, 3], dtype=torch.int32, device=dev)
        try:
            out = decay_batch(st, ti, tj, sm, (0, 100), tile=t)
            torch.cuda.synchronize()
        except RuntimeError as exc:
            print("fault:", exc)
            sys.exit(3)
        print(out.tolist())
    """)
    runs = {i: subprocess.run([sys.executable, "-c", code, str(i)],
                              capture_output=True, text=True, timeout=300)
            for i in (3, 4)}
    assert runs[3].returncode == 0, runs[3].stderr
    assert runs[3].stdout.strip() == str([[3.0 * 16 * 16, 0.0, 0.0,
                                           3.0 * 16 * 16]])
    assert runs[4].returncode != 0 and "[[" not in runs[4].stdout


@pytest.mark.cuda
def test_decay_session_launches_once_a_batch_and_shard(cuda_device):
    """``ld_decay`` on two shards sharing the card: one launch a batch and
    shard, and the curve of one shard on the card and of the CPU."""
    from weightedld_tpu_torch.parallel import analytics

    edges = (0, 10, 100, 1000, 2000)
    runs = {}
    for name, devs in (("cpu", ["cpu"]), ("g1", [cuda_device]),
                       ("g2", [cuda_device, cuda_device])):
        sess = _decay_session("hybrid-packed", None, devices=devs)
        analytics.reset_launches()
        runs[name] = sess.ld_decay(edges)
        want = 0 if name == "cpu" else sess.n_batches * len(devs)
        assert analytics.launches == {"ld_decay_bins": want}
    for name in ("g1", "g2"):
        assert runs[name]["n_pairs"] == runs["cpu"]["n_pairs"]
        assert runs[name]["n_d_prime_finite"] \
            == runs["cpu"]["n_d_prime_finite"]
        for key in ("r2_sum", "abs_d_prime_sum"):
            np.testing.assert_allclose(runs[name][key], runs["cpu"][key],
                                       rtol=1e-6)
