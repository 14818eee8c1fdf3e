#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # all phases, one card

Phases (each failure propagates; the script exits non-zero and prints no
result line):

1. build   — print the card's name and power limit, build
             ``weightedld_tpu_torch/csrc/ld_majmin.cu`` for sm_90a with nvcc.
2. kernels — each kernel entry point against its plain PyTorch version on
             the card, on random no-UNKNOWN alignments from numpy seeds
             (ragged S and N, several seq chunks, emit=0 tiles, int8x3 /
             int8 / unit / bf16-exact / split_bf16 weights); then the
             kernel's and the plain version's time on the full tile plan of
             N=1,000 x S=8,192, whose outputs are held against each other.
3. main    — the CLI in-process on a synthetic VCF at the headline shape
             (1,000 haplotypes x 49,152 sites, the loaded distribution with
             3,400 planted site triplets), ``--r2-threshold 0.1``: every
             planted pair must be in the output, and the run must launch
             ``ld_majmin_planes``.  The same input through ``run_to_tsv``
             with ``preplaned="off"`` (the path of inputs whose planes do not
             fit the card) must launch ``ld_majmin_codes`` and write the
             same bytes.  Then one full batch of the CLI's own session
             (2,520 tiles, auto seq chunk), and of the same session with the
             codes entry, kernel against plain version.
4. cpu-vs-card — the same CLI on ``--device cpu`` and ``--device cuda`` on a
             1,000 x 4,096 slice with ``--tile 256 --seq-chunk 200`` (five
             seq chunks): the two TSVs must be byte-identical, the card run
             must launch a kernel and the CPU run none; then the session's
             batch, kernel against plain.

Not in the default run: ``--phases profile`` times the headline scan and
breaks one scan down by device kernel with torch.profiler; ``--phases
entries`` times the two entry points over whole sessions at several N and
S, interleaved.

The launch counters are zeroed just before each run of the main path and
read just after it; the kernels line reports ``ld_majmin_planes`` from the
headline CLI run and ``ld_majmin_codes`` from the headline codes-entry run.  Launches of
the kernel-vs-plain checks are not counted.  The last three lines of
standard output are the kernels JSON, the card line from nvidia-smi, and
the result JSON.  The script makes only card 0 visible to itself.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

RTOL, ATOL = 1e-5, 1e-6
N_HEAD, S_HEAD, N_TRIPLETS = 1000, 49152, 3400
S_TIMED = 8192
SLICE_SITES = 4096
# (N, S) of the entries phase: N_pad below, at and above 1,024 at the
# headline S, and planes + xq of 1.2 GB at N = 1,000.
ENTRY_SHAPES = ((500, S_HEAD), (1000, S_HEAD), (2000, S_HEAD),
                (1000, 147456))

KERNELS = {
    "ld_majmin_codes": "weightedld_tpu/ops/pallas_ld.py:847",
    "ld_majmin_planes": "weightedld_tpu/ops/pallas_ld.py:1110",
}
SOURCE = "weightedld_tpu_torch/csrc/ld_majmin.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase_build() -> None:
    from weightedld_tpu_torch.ops import _build

    log(f"[build] card: {card_line()}")
    t0 = time.monotonic()
    _build.load_library()
    info = _build.build_info
    log(f"[build] {info.path.name}: compiled={info.compiled} "
        f"nvcc {info.seconds:.2f}s, load {time.monotonic() - t0:.2f}s")
    for line in info.ptxas.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] ptxas: {line.strip()}")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _case_inputs(seed, alphabet, n_seqs, n_sites, tile, seq_chunk, wq,
                 device):
    import torch

    from weightedld_tpu_torch.ops import cuda_ld as K
    from weightedld_tpu_torch.parallel.triangle import plan_tiles

    rng = np.random.default_rng(seed)
    aln = rng.choice(alphabet, size=(n_seqs, n_sites)).astype(np.int8)
    if wq == "unit":
        w = np.ones(n_seqs, np.float32)
    elif wq == "exact":
        w = ((np.arange(n_seqs) % 4 + 1) / 4.0).astype(np.float32)
    else:
        w = (rng.random(n_seqs) + 0.05).astype(np.float32)
        w /= w.max()
    if wq in ("int8", "int8x3"):
        wr = K.pad_weights_int8(w, seq_chunk, levels=2 if wq == "int8" else 3)
    else:
        wr = K.pad_weights(w, seq_chunk)
    plan = plan_tiles(n_sites, tile)
    emit = np.ones(plan.n_tiles, np.int32)
    emit[rng.random(plan.n_tiles) < 0.25] = 0       # some padding tiles
    codes = K.pad_alignment_site_major(aln, tile, seq_chunk)
    auxc, _ = K.majmin_site_aux(aln, plan.s_pad)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    kw = dict(tile=tile, n_sites=n_sites, seq_chunk=seq_chunk,
              unit_weights=wq == "unit", exact_weights=wq == "exact",
              wquant=wq if wq in ("int8", "int8x3") else "")
    return (t(codes), t(wr), t(auxc), t(plan.tile_i), t(plan.tile_j),
            t(emit), kw)


def _compare(got, ref, label: str) -> float:
    """Assert kernel == plain (keep equal; d/d'/r2 on kept pairs within
    RTOL/ATOL with equal non-finite patterns); returns the max abs error."""
    import torch

    keep = ref.keep
    if not torch.equal(got.keep, keep):
        raise AssertionError(f"{label}: keep differs at "
                             f"{int((got.keep != keep).sum())} pairs")
    worst = 0.0
    for f in ("d", "d_prime", "r2"):
        g = getattr(got, f)[keep]
        r = getattr(ref, f)[keep]
        fin = torch.isfinite(r)
        if not torch.equal(torch.isfinite(g), fin):
            raise AssertionError(f"{label}: {f} non-finite pattern differs")
        torch.testing.assert_close(g[fin], r[fin], rtol=RTOL, atol=ATOL,
                                   msg=lambda m: f"{label} {f}: {m}")
        if fin.any():
            worst = max(worst, float((g[fin] - r[fin]).abs().max()))
    return worst


def _time_cuda(fn, reps: int):
    """``(ms per call, the last call's result)`` of ``fn`` on the card."""
    import torch

    # Two warm-up calls: each timed call allocates its outputs while the
    # previous call's are still held, so the caching allocator must already
    # hold two calls' worth of blocks for no cudaMalloc to land in the timing.
    out = fn()
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def check_session_batch(sess, label: str, piece: int = 128) -> float:
    """Batch 0 of ``sess`` through its kernel entry, with the session's own
    operands, tile lists and keywords (the main path's launch shape), held
    against the plain version (run ``piece`` tiles at a time: every tile is
    independent); returns the max abs error on kept pairs."""
    import torch

    from weightedld_tpu_torch.ops import cuda_ld as K

    fn, plain = ((K.tile_stats_majmin_pre, K.tile_stats_majmin_pre_plain)
                 if sess.preplaned else
                 (K.tile_stats_majmin, K.tile_stats_majmin_plain))
    args = (*sess.operands, sess.weights_dev, sess.auxc_dev)
    ti, tj, em = sess.batch_tiles(0)
    got = fn(*args, ti, tj, em, **sess.kernel_kw)
    parts = [plain(*args, ti[p:p + piece], tj[p:p + piece], em[p:p + piece],
                   **sess.kernel_kw) for p in range(0, ti.shape[0], piece)]
    ref = type(got)(*(torch.cat([getattr(x, f) for x in parts])
                      for f in got._fields))
    torch.cuda.synchronize()
    e = _compare(got, ref, label)
    log(f"[check] ok: {label}: batch 0 of {sess.n_batches}, "
        f"{ti.shape[0]} tiles, {sess.cfg}, {int(ref.keep.sum())} kept pairs, "
        f"max |kernel - plain| {e}")
    return e


def phase_kernels() -> dict:
    import torch

    from weightedld_tpu_torch.ops import cuda_ld as K

    dev = torch.device("cuda")
    err = {name: 0.0 for name in KERNELS}
    bitwise = {name: True for name in KERNELS}
    cases = [
        # seed, alphabet, N, S, tile, seq_chunk, weight mode
        (1, (0, 1, 4), 1000, 700, 256, 256, "int8x3"),
        (2, (0, 1, 2, 3, 4), 150, 300, 48, 64, "int8x3"),
        (3, (0, 1, 2, 3, 4), 150, 300, 48, 64, "unit"),
        (4, (0, 1, 4), 150, 300, 48, 64, "exact"),
        (5, (0, 1, 4), 150, 300, 48, 64, "split_bf16"),
        (6, (0, 3, 4), 150, 300, 48, 64, "int8"),
        (7, (0, 1), 37, 90, 32, 40, "unit"),
        (8, (0, 1, 2, 3, 4), 333, 257, 64, 120, "int8x3"),
    ]
    for seed, alpha, n, s, tile, chunk, wq in cases:
        codes, wr, auxc, ti, tj, em, kw = _case_inputs(
            seed, alpha, n, s, tile, chunk, wq, dev)
        label = f"N={n} S={s} T={tile} chunk={chunk} {wq} alphabet={alpha}"
        got = K.tile_stats_majmin(codes, wr, auxc, ti, tj, em, **kw)
        ref = K.tile_stats_majmin_plain(codes, wr, auxc, ti, tj, em, **kw)
        torch.cuda.synchronize()
        e = _compare(got, ref, "codes " + label)
        err["ld_majmin_codes"] = max(err["ld_majmin_codes"], e)
        bitwise["ld_majmin_codes"] &= bool(torch.equal(
            got.r2[ref.keep], ref.r2[ref.keep]))
        planes = K.build_majmin_planes(codes, auxc, tile=tile)
        nlev = {"int8": 2, "int8x3": 3}.get(kw["wquant"], 0)
        xq = K.build_majmin_xq(planes, wr, nlev) if nlev else None
        got = K.tile_stats_majmin_pre(planes, xq, wr, auxc, ti, tj, em, **kw)
        ref = K.tile_stats_majmin_pre_plain(planes, xq, wr, auxc, ti, tj, em,
                                            **kw)
        torch.cuda.synchronize()
        e = _compare(got, ref, "planes " + label)
        err["ld_majmin_planes"] = max(err["ld_majmin_planes"], e)
        bitwise["ld_majmin_planes"] &= bool(torch.equal(
            got.r2[ref.keep], ref.r2[ref.keep]))
        log(f"[kernels] ok: {label}")
    log(f"[kernels] max |kernel - plain| on kept pairs: {err}; "
        f"r2 bitwise equal: {bitwise}")

    # Time both entry points and their plain versions on the full tile
    # plan of N=1,000 x S=8,192 (T=256, one 1,024-wide seq chunk, int8x3),
    # then hold the timed calls' outputs against each other.
    codes, wr, auxc, ti, tj, em, kw = _case_inputs(
        11, (0, 1, 4), N_HEAD, S_TIMED, 256, 1024, "int8x3", dev)
    em = torch.ones_like(em)
    planes = K.build_majmin_planes(codes, auxc, tile=256)
    xq = K.build_majmin_xq(planes, wr, 3)
    batch = 128

    def run(fn, *ops):
        return [fn(*ops, wr, auxc, ti[lo:lo + batch], tj[lo:lo + batch],
                   em[lo:lo + batch], **kw)
                for lo in range(0, ti.shape[0], batch)]

    ops = {"ld_majmin_codes": (K.tile_stats_majmin, K.tile_stats_majmin_plain,
                               (codes,)),
           "ld_majmin_planes": (K.tile_stats_majmin_pre,
                                K.tile_stats_majmin_pre_plain, (planes, xq))}
    ms, plain_ms = {}, {}
    for name, (fn, plain, src) in ops.items():
        ms[name], got = _time_cuda(lambda: run(fn, *src), 3)
        plain_ms[name], ref = _time_cuda(lambda: run(plain, *src), 1)
        for b, (g, r) in enumerate(zip(got, ref)):
            e = _compare(g, r, f"{name} timed N={N_HEAD} S={S_TIMED} "
                         f"chunk=1024 batch {b}")
            err[name] = max(err[name], e)
        log(f"[kernels] ok: {name} timed calls, {ti.shape[0]} tiles in "
            f"{len(got)} launches of <= {batch}, kernel == plain")
        del got, ref
    n_pairs = S_TIMED * (S_TIMED - 1) // 2
    for name in KERNELS:
        log(f"[kernels] {name}: {ms[name]:.3f} ms kernel vs "
            f"{plain_ms[name]:.3f} ms plain for {ti.shape[0]} tiles "
            f"(N={N_HEAD}, S={S_TIMED}, T=256, int8x3): "
            f"{n_pairs / (ms[name] / 1e3):.4g} pairs/s kernel")
    return {"err": err, "ms": ms, "plain_ms": plain_ms}


# ---------------------------------------------------------------------------
# Phases 3 and 4: the CLI
# ---------------------------------------------------------------------------


def loaded_alignment(rng, n_seqs, n_sites, n_groups):
    """Alleles 0 / 1 / missing at 60 / 30 / 10 % with ``n_groups`` planted
    triplets (a seed site plus two 2%-mutated copies), as bench.py's
    ``synthetic_alignment`` / ``structured_alignment`` with VCF codes."""
    r = rng.random((n_seqs, n_sites))
    aln = np.where(r < 0.6, 0, np.where(r < 0.9, 1, 4)).astype(np.int8)
    seeds = rng.choice(n_sites, size=(n_groups, 3), replace=False)
    for s0, s1, s2 in seeds:
        for dst in (s1, s2):
            col = aln[:, s0].copy()
            mut = rng.random(n_seqs) < 0.02
            col[mut] = np.where(col[mut] == 0, 1, 0)
            aln[:, dst] = col
    return aln, seeds


def write_vcf(path: Path, aln: np.ndarray) -> None:
    """Phased diploid VCF whose reader output is ``aln`` (rows are the
    reversed file-order haplotypes), POS = site index + 1; text built with
    numpy, one genotype block per site."""
    haps = aln[::-1]
    n_h, s = haps.shape
    lut = np.zeros(8, np.uint8)
    lut[0], lut[1], lut[4] = ord("0"), ord("1"), ord(".")
    ch = lut[haps]                                   # [n_h, S]
    g = np.empty((s, n_h // 2, 4), np.uint8)
    g[:, :, 0] = ch[0::2].T
    g[:, :, 1] = ord("|")
    g[:, :, 2] = ch[1::2].T
    g[:, :, 3] = ord("\t")
    g[:, -1, 3] = ord("\n")
    rows = g.reshape(s, -1)
    head = ("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER"
            "\tINFO\tFORMAT\t"
            + "\t".join(f"S{i}" for i in range(n_h // 2)) + "\n")
    with open(path, "wb") as fh:
        fh.write(head.encode())
        for i in range(s):
            fh.write(f"1\t{i + 1}\trs{i + 1}\tA\tT\t100\tPASS\t.\tGT\t"
                     .encode())
            fh.write(rows[i].tobytes())


def read_pairs(path: Path) -> list[tuple[int, int]]:
    out = []
    with open(path) as fh:
        next(fh)
        for line in fh:
            a, b = line.split("\t", 2)[:2]
            out.append((int(a), int(b)))
    return out


def _session(res, **cfg):
    """The tiled session the CLI builds on the card for the prepared input
    ``res`` with these ``DriverConfig`` fields."""
    from weightedld_tpu_torch.runtime.driver import DriverConfig, LdSession

    return LdSession(res.alignment, res.weights, res.site_map,
                     DriverConfig(**cfg), device="cuda")


def _counted(fn, *args, **kwargs):
    """``(fn's result, the kernel launch counts of that call alone)``."""
    from weightedld_tpu_torch.ops import cuda_ld

    cuda_ld.reset_launches()
    out = fn(*args, **kwargs)
    return out, dict(cuda_ld.launches)


def _drive(argv: list[str], timer=None) -> dict:
    """One CLI run; returns the kernel launch counts of that run alone."""
    from weightedld_tpu_torch import cli

    rc, counts = _counted(cli.main, argv, timer=timer)
    if rc != 0:
        raise RuntimeError(f"cli.main {' '.join(argv)} exited {rc}")
    return counts


def phase_main(tmp: Path) -> tuple[dict, dict]:
    """The headline runs; returns the main-path launch count of each kernel
    and the max abs errors of the batch checks."""
    from weightedld_tpu_torch.pipeline import prepare
    from weightedld_tpu_torch.runtime.driver import DriverConfig, run_to_tsv
    from weightedld_tpu_torch.runtime.profiling import StageTimer

    rng = np.random.default_rng(2024)
    t0 = time.monotonic()
    aln, seeds = loaded_alignment(rng, N_HEAD, S_HEAD, N_TRIPLETS)
    vcf = tmp / "headline.vcf"
    write_vcf(vcf, aln)
    log(f"[main] synthetic VCF {N_HEAD} x {S_HEAD}: "
        f"{vcf.stat().st_size / 1e6:.1f} MB in {time.monotonic() - t0:.1f}s")
    out = tmp / "headline.tsv"
    timer = StageTimer()
    t0 = time.monotonic()
    counts = _drive(["--file", str(vcf), "--r2-threshold", "0.1",
                     "--pair-output", str(out)], timer=timer)
    wall = time.monotonic() - t0
    log(f"[main] kernel launches of the headline run: {counts}")
    if counts["ld_majmin_planes"] == 0:
        raise AssertionError("the headline run never launched "
                             "ld_majmin_planes")
    pairs = set(read_pairs(out))
    planted = set()
    for trip in seeds:
        a, b, c = sorted(int(x) + 1 for x in trip)
        planted |= {(a, b), (a, c), (b, c)}
    missing = planted - pairs
    if missing:
        raise AssertionError(f"{len(missing)} of {len(planted)} planted "
                             f"pairs missing, e.g. {sorted(missing)[:5]}")
    n_pairs = S_HEAD * (S_HEAD - 1) // 2
    scan = timer.spans.get("scan+write", float("nan"))
    log(f"[main] {len(pairs)} records (all {len(planted)} planted pairs "
        f"present); cli wall {wall:.3f}s")
    for name, sec in timer.spans.items():
        log(f"[main] stage {name:<12} {sec:.3f}s")
    log(f"[main] {n_pairs / scan:.4g} pairs/s over scan+write "
        f"({n_pairs} pairs), {n_pairs / wall:.4g} pairs/s end to end")
    np.save(tmp / "headline_aln.npy", aln[:, :SLICE_SITES])

    # The same input through the library entry with the codes entry, the
    # path of inputs whose planes do not fit the card (plane_budget).
    res = prepare(vcf)
    out_codes = tmp / "headline_codes.tsv"
    n_rec, codes_counts = _counted(
        run_to_tsv, res.alignment, res.weights, res.site_map, out_codes,
        DriverConfig(r2_threshold=0.1, preplaned="off"), device="cuda")
    log(f"[main] codes entry (run_to_tsv, preplaned='off'): {n_rec} "
        f"records, kernel launches {codes_counts}")
    if codes_counts["ld_majmin_codes"] == 0:
        raise AssertionError("the codes-entry run never launched "
                             "ld_majmin_codes")
    if out_codes.read_bytes() != out.read_bytes():
        raise AssertionError("the codes entry's TSV differs from the CLI's")
    log("[main] codes entry's TSV byte-identical to the CLI's")
    launches = {"ld_majmin_planes": counts["ld_majmin_planes"],
                "ld_majmin_codes": codes_counts["ld_majmin_codes"]}

    # The CLI's own session (preplaned, auto seq chunk and batch size), and
    # the same with the codes entry: one full batch each, kernel vs plain.
    err = {}
    for name, pp in (("ld_majmin_planes", "auto"), ("ld_majmin_codes", "off")):
        sess = _session(res, r2_threshold=0.1, preplaned=pp)
        if sess.preplaned != (name == "ld_majmin_planes"):
            raise AssertionError(f"headline preplaned={pp}: session chose "
                                 f"preplaned={sess.preplaned}")
        err[name] = check_session_batch(sess, f"headline {name}")
        del sess
    return launches, err


def phase_cpu_vs_card(tmp: Path) -> tuple[str, float]:
    """The slice run on both devices; returns the kernel of the card run
    and the max abs error of its batch check."""
    from weightedld_tpu_torch.pipeline import prepare

    aln = np.load(tmp / "headline_aln.npy") if (
        tmp / "headline_aln.npy").exists() else loaded_alignment(
            np.random.default_rng(2024), N_HEAD, S_HEAD, N_TRIPLETS
        )[0][:, :SLICE_SITES]
    vcf = tmp / "slice.vcf"
    write_vcf(vcf, aln)
    outs, counts = {}, {}
    for device in ("cpu", "cuda"):
        out = tmp / f"slice_{device}.tsv"
        t0 = time.monotonic()
        # --seq-chunk 200: five chunks, each combined into the f32 cells.
        counts[device] = _drive(
            ["--file", str(vcf), "--device", device, "--engine", "tiled",
             "--tile", "256", "--seq-chunk", "200", "--r2-threshold",
             "0.005", "--pair-output", str(out)])
        outs[device] = out.read_bytes()
        log(f"[cpu-vs-card] {device}: {outs[device].count(b'\n') - 1} "
            f"records in {time.monotonic() - t0:.2f}s, kernel launches "
            f"{counts[device]}")
    if any(counts["cpu"].values()):
        raise AssertionError(f"the CPU run launched kernels: {counts['cpu']}")
    if not any(counts["cuda"].values()):
        raise AssertionError("the slice run on the card launched no kernel")
    if outs["cpu"] != outs["cuda"]:
        raise AssertionError("CPU and CUDA TSVs differ")
    log(f"[cpu-vs-card] TSVs byte-identical "
        f"({len(outs['cuda'])} bytes)")
    sess = _session(prepare(vcf), tile=256, seq_chunk=200,
                    r2_threshold=0.005)
    name = "ld_majmin_planes" if sess.preplaned else "ld_majmin_codes"
    return name, check_session_batch(sess, f"slice {name}")


def _scan_seconds(sess) -> float:
    """Wall seconds of one ``stream()`` scan of ``sess``, synchronized."""
    import torch

    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _b, _rec in sess.stream():
        pass
    torch.cuda.synchronize()
    return time.monotonic() - t0


def phase_profile() -> None:
    """Not in the default run: where the headline scan's time goes.  The
    session the CLI builds (Henikoff weights, r2 > 0.1) is scanned three
    times after a warm-up, summarized once, then scanned once under
    torch.profiler for the device time by kernel and the device idle
    share."""
    from torch.profiler import ProfilerActivity, profile

    from weightedld_tpu_torch.core.henikoff import henikoff_weights_host
    from weightedld_tpu_torch.runtime.driver import DriverConfig, LdSession

    aln, _seeds = loaded_alignment(np.random.default_rng(2024), N_HEAD,
                                   S_HEAD, N_TRIPLETS)
    w = henikoff_weights_host(aln)
    n_pairs = S_HEAD * (S_HEAD - 1) // 2
    t0 = time.monotonic()
    sess = LdSession(aln, w, np.arange(1, S_HEAD + 1),
                     DriverConfig(r2_threshold=0.1))
    log(f"[profile] set-up {time.monotonic() - t0:.4f}s {sess.cfg} "
        f"preplaned={sess.preplaned} batches={sess.n_batches}")
    _scan_seconds(sess)                                # warm-up
    for _ in range(3):
        dt = _scan_seconds(sess)
        log(f"[profile] stream: {dt:.4f}s {n_pairs / dt:.4g} pairs/s | "
            f"{card_line()}")
    t0 = time.monotonic()
    sess.summarize()
    log(f"[profile] summarize: {time.monotonic() - t0:.4f}s")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _scan_seconds(sess)
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_time_total > 0), key=lambda r: -r[1])
    kernels = [r for r in rows if not r[0].startswith(("aten::", "cuda"))]
    busy = sum(r[1] for r in kernels)
    log(f"[profile] device kernel time {busy:.3f} ms of {wall * 1e3:.3f} ms "
        f"wall: idle share {1 - busy / (wall * 1e3):.4f}")
    for name, ms, count in kernels[:12]:
        log(f"[profile]   {ms:10.3f} ms x{count:<4d} {name[:90]}")


def phase_entries() -> None:
    """Not in the default run: the codes entry against the preplaned entry,
    whole sessions on Henikoff-weighted loaded alignments at several N and
    S (set-up, then scans interleaved on, off, off, on after a warm-up of
    each), so that ``preplaned="auto"`` can be set from the card."""
    import torch

    from weightedld_tpu_torch.core.henikoff import henikoff_weights_host
    from weightedld_tpu_torch.runtime.driver import DriverConfig, LdSession

    for n, s in ENTRY_SHAPES:
        aln, _seeds = loaded_alignment(np.random.default_rng(n + s), n, s,
                                       N_TRIPLETS)
        w = henikoff_weights_host(aln)
        sessions, setup = {}, {}
        for pp in ("on", "off"):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            sessions[pp] = LdSession(aln, w, np.arange(1, s + 1),
                                     DriverConfig(r2_threshold=0.1,
                                                  preplaned=pp))
            setup[pp] = time.monotonic() - t0
        sess = sessions["on"]
        plane_bytes = sum(t.numel() for t in sess.operands if t is not None)
        scans = {"on": [], "off": []}
        for pp in ("on", "off"):
            _scan_seconds(sessions[pp])                # warm-up
        for pp in ("on", "off", "off", "on"):
            scans[pp].append(_scan_seconds(sessions[pp]))
        best = {pp: min(v) for pp, v in scans.items()}
        log(f"[entries] N={n} S={s} {sess.cfg} planes+xq {plane_bytes} B: "
            f"set-up on {setup['on']:.4f}s off {setup['off']:.4f}s; scans "
            f"on {scans['on']} off {scans['off']}; best off/on "
            f"{best['off'] / best['on']:.4f} | {card_line()}")
        del sessions, sess
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,main,cpu-vs-card",
                    help="comma-separated subset of build, kernels, main, "
                    "cpu-vs-card, profile and entries (default: the first "
                    "four, which the result line needs)")
    args = ap.parse_args()
    phases = args.phases.split(",")

    # The smoke test runs on one card.
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False — this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    res = None
    err = dict.fromkeys(KERNELS, 0.0)
    launches = {}
    with tempfile.TemporaryDirectory(prefix="wld_smoke_") as td:
        tmp = Path(td)
        if "build" in phases:
            phase_build()
        if "kernels" in phases:
            res = phase_kernels()
            err = res["err"]
        if "main" in phases:
            launches, main_err = phase_main(tmp)
            for name, e in main_err.items():
                err[name] = max(err[name], e)
        if "cpu-vs-card" in phases:
            name, e = phase_cpu_vs_card(tmp)
            err[name] = max(err[name], e)
        if "profile" in phases:
            phase_profile()
        if "entries" in phases:
            phase_entries()
    if set(phases) != {"build", "kernels", "main", "cpu-vs-card"}:
        log("[smoke] partial run: no result line")
        return 0
    log(f"[smoke] main-path launches: ld_majmin_planes from the headline "
        f"CLI run, ld_majmin_codes from the headline codes-entry run: "
        f"{launches}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": KERNELS[name], "launches": launches[name],
         "max_abs_err": err[name], "ms": res["ms"][name],
         "plain_ms": res["plain_ms"][name]}
        for name in KERNELS]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
