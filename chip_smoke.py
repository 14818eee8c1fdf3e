#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # all phases, one card

Phases (each failure propagates; the script exits non-zero and prints no
result line):

1. build   — print the card's name and power limit, build every
             ``weightedld_tpu_torch/csrc/*.cu`` for sm_90a (one nvcc per
             source, all started together) and, beside them, the native
             io library from ``native/wldio.cpp`` (g++).
2. kernels — each kernel entry point against its plain PyTorch version on
             the card: the factorized entries on random no-UNKNOWN
             alignments, the general entries (codes and preplaned, weighted
             and unit) on alignments with 1-10 % UNKNOWN cells and P = 2..5
             planes, a restricted ``planes`` tuple among them (ragged S and
             N, several seq chunks, emit=0 tiles, int8x3 / int8 / unit /
             bf16-exact / split_bf16 / lo_int8 weights), and the general
             body's edges (``GENERAL_EDGE_CASES``) in every weight mode; the
             factorized lo_int8 and bf16-exact rows and every general row
             but split_bf16 must give r2 bit for bit; then
             each kernel's and its plain version's time on the full tile
             plan of N=1,000 x S=8,192 (the general kernels at P = 5 with
             1 % UNKNOWN sites; each weighted entry in int8x3 and in
             lo_int8, the factorized ones in split_bf16 and bf16-exact too,
             the general ones timed there as well; the kernel in one launch,
             the plain version in pieces of 128 tiles), whose outputs are
             held against each other, beside its bound, and ``torch._int_mm``
             and a bf16 ``torch.mm`` over the factorized contraction (the
             yardsticks) in the same call.
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
5. analytics — the analytics methods of one session on the headline
             input the main phase prepared, held against the main phase's
             records: ``summarize`` (n_over_threshold = the record count),
             ``r2_histogram`` (bins sum to n_pairs), ``ld_decay`` (counts
             sum to n_pairs), ``top_pairs(1000)`` (no other record is
             stronger), ``prune(0.1)`` (no record joins two kept sites);
             ``matrices`` of an S = 8,192 slice, float32 and float16,
             against a stream's records; the CLI's ``--r2-hist``,
             ``--ld-decay``, ``--top 1000`` and ``--prune-r2 0.1`` on that
             slice against the same session's methods, and its
             ``--matrix-output --matrix-dtype float16`` on a 2,048-site
             slice against the method; then lo_int8: the CLI's ``--stats-only --weight-quant
             lo_int8`` (the preplaned entry; counts equal int8x3's) and
             ``run_to_tsv(preplaned="off", weight_quant="lo_int8")`` (the
             codes entry, held to int8x3 at rtol 2e-5 / atol 1e-6), and
             one full batch of each lo_int8 headline session (preplaned
             and codes entry), kernel against plain; then ``summarize`` of
             the prepared headline in split_bf16 and with its weights
             rounded to bf16 (bf16-exact), each through both entries and
             held to int8x3's counts, with one full batch of each, kernel
             against plain.
6. ambiguous — the ambiguity-code path at full size: a synthetic FASTA of
             1,024 sequences x 16,384 columns over A C G T - with 1-2
             ambiguity characters (N R Y) at 1 % of the columns and planted
             correlated column triplets, some through ambiguous columns.
             (1) the CLI, ``--r2-threshold 0.1``: the hybrid session
             (unsafe-site packing, factorized kernel on the safe tile pairs,
             ``ld_general`` on the rest), every planted pair present;
             (2) ``run_to_tsv(kernel="general")``: only ``ld_general``, the
             same record set with values within rtol 2e-5 / atol 1e-6 (the
             packing flips some pairs' in-kernel orientation), and with
             ``preplaned="on"`` only ``ld_general_planes`` and the same
             bytes; (2b) lo_int8 through the CLI (``ld_general`` in lo_int8
             on the hybrid's general phase) and ``run_to_tsv(kernel=
             "general", preplaned="on", weight_quant="lo_int8")``, each
             held to its int8x3 twin at rtol 2e-5 / atol 1e-6 with every
             planted pair; (2c) split_bf16 and bf16-rounded weights
             through ``kernel="general"`` on both entries, every planted
             pair, one batch each kernel against plain; (3) the CLI with
             ``--unweighted``:
             ``ld_general_unit``;
             (4) CPU vs card on the first 4,096 columns, ``--tile 256
             --seq-chunk 256 --r2-threshold 0.03``, weighted and
             unweighted: byte-identical TSVs,
             general kernels on the card and no launch on the CPU; (5)
             kernel against plain: the general batch of the CLI's hybrid
             session and of its lo_int8 twin, and batch 0 of the
             ``kernel="general"`` session, of its unit twin and of its
             preplaned lo_int8 twin.
7. ingest  — the ingest front: the native io library loaded (where the
             host lacks zlib's header, a ``native_io unavailable: ...``
             line and the Python readers throughout); the native and
             Python readers give equal arrays on the headline VCF; the
             headline CLI with the Python reader (``WLD_NATIVE_IO=0``),
             the native reader and ``--stream-ingest`` writes the same
             TSV bytes, each launching ``ld_majmin_planes``, with every
             stage time; ``session_from_vcf(weight_precision="f32")`` on
             the card: weights within rtol 1e-6 of the host f64 weights,
             every planted pair; ``henikoff_weights_site_major`` timed on
             the headline's codes; the ambiguous FASTA through
             ``--stream-ingest``: the default run's TSV bytes, with
             ``ld_general``; a 1000 Genomes-sized cohort (5,008
             haplotypes x 49,152 sites of the loaded distribution, 3,400
             planted triplets, a ~490 MB VCF) through the default CLI:
             the native reader, ``henikoff_weights_large`` on the card
             (246 M cells > 200 M), the native transpose and
             ``ld_majmin_planes``, every planted pair, its weights within
             rtol 1e-5 of ``henikoff_weights_host_site_major``.  Every
             stage is printed with the card and the host's core count.
8. windows — windowed, region-restricted and inter-region LD at the
             headline size: (1) the headline alignment on chromosome 20
             with POS a seeded sum of geometric gaps (mean 200 bp, about
             9.8 Mb) through the CLI with ``--max-distance-bp 1000000
             --r2-threshold 0.1`` (PLINK 1.9's default ``--ld-window-kb
             1000``): the full-triangle CLI's TSV filtered to ``posb - posa
             <= 1000000``, byte for byte, every planted in-window pair,
             ``ld_majmin_planes``; ``run_to_tsv(preplaned="off")`` with the
             window (``ld_majmin_codes``, same bytes); ``--max-distance
             5000`` beside it (the filter by both); ``--ld-decay`` counts
             summing to the window's pairs; ``--prune-r2 0.1`` (no
             windowed record joins two kept sites); one batch kernel
             against plain; (2) ``--region 20:2000001-6000000`` with the
             window: the bytes of ``run_to_tsv`` on that column slice with
             its own Henikoff weights; (3) the alignment as a
             two-chromosome VCF (sites 0-24,575 on ``1``, the rest on
             ``2``, POS restarting): ``--cross-regions 1 2`` equal to the
             full session's rectangle ``i < 24,576 <= j``, byte for byte,
             every planted pair across the split, ``--stats-only`` counts,
             and ``--ld-decay`` exiting 2; (4) the ambiguous FASTA with
             ``--max-distance 2000``: windowed-packed, ``ld_majmin_planes``
             and ``ld_general``, the full run's records within the window
             (a set, rtol 2e-5 / atol 1e-6), every planted in-window pair,
             its ``--stream-ingest`` twin's bytes, one batch of each phase
             kernel against plain; (5) the ingest phase's cohort with
             ``--keep-samples`` naming 503 samples and ``--max-distance
             5000``: 1,006 haplotypes, weights equal to
             ``henikoff_weights_host`` of the row subset, every planted
             in-window pair; (6) ``--device cpu`` against ``--device cuda``
             on a 4,096-site slice with ``--max-distance-bp 200000`` and on
             the ambiguous FASTA's first 4,096 columns with
             ``--max-distance 500`` (windowed-packed): byte-identical TSVs.
             Every run prints its stages, launches, the scan's pairs/s
             over the pairs in its set and its plan tiles, with the card.
9. flags   — the flags of the last CLI slice at full size (writes its own
             inputs when run alone, ``--phases build,flags``): the
             headline's default TSV at r² > 0.1, then ``--compat rust``
             on the headline and on the ambiguous FASTA (the Rust
             reader, the hybrid): paper weights computed on the card
             within rtol 2e-6 of the CPU float32 ones, the TSV equal to
             ``run_to_tsv`` fed those weights; ``--out-format plink``
             (the default TSV's pairs and values row for row);
             ``--sort`` (its rows lexsorted); ``--checkpoint``
             interrupted after batch 3 (a patch of ``LdSession.stream``
             in this script) and resumed, equal to an uninterrupted
             checkpointed run, plain and ``.gz``, through the CLI
             (``ld_majmin_planes``) and ``run_to_tsv(preplaned="off")``
             (``ld_majmin_codes``); ``--save-prepared`` then
             ``--load-prepared`` (the same bytes, no ingest or weights
             stage); ``--site-stats`` on the ambiguous FASTA;
             ``--profile-dir`` (a trace naming ``ld_majmin_wgmma``, the
             same bytes); ``--progress-bar`` (100 % once);
             ``--engine reference`` against dense on 64 x 200; CPU vs
             card under ``--compat rust`` on 4,096 sites.  Every run
             prints its stages and wall with the card; the phase fails
             unless its runs launched ``ld_majmin_planes``,
             ``ld_majmin_codes`` and ``ld_general``.

Not in the default run: ``--phases profile`` times the headline
session's ``stream`` and ``summarize`` scans interleaved, one batch's
top-k selection with and without the tile-max prefilter, and breaks one
scan down by device kernel with torch.profiler; ``--phases entries`` times
the two factorized entry points over whole sessions at several N and S,
interleaved, in int8x3, lo_int8 and split_bf16; ``--phases pace`` times
variants of the factorized body that drop or change one part of its work
(``PACE_VARIANTS``) beside the committed body; ``--phases yardstick``
times ``torch._int_mm`` and a bf16 ``torch.mm`` over the factorized
kernel's contraction alone (the kernels phase runs them too); ``--phases
general`` runs every general entry in every weight mode on each general
case and the 528-tile plan, synchronized after each launch (run it under
``compute-sanitizer`` where the card allows); ``--phases gpace`` times
variants of the general body that drop one part of its work
(``GENERAL_PACE_VARIANTS``) beside the committed body.

The launch counters are zeroed just before each run of the main path and
read just after it; the kernels line reports ``ld_majmin_planes`` from the
headline CLI run, ``ld_majmin_codes`` from the headline codes-entry run,
``ld_general`` from the ambiguous CLI run, ``ld_general_planes`` from its
preplaned ``kernel="general"`` run and ``ld_general_unit`` from its
``--unweighted`` CLI run, the four lo_int8 variants from the lo_int8
runs of the analytics and ambiguous phases, the factorized split_bf16
and bf16-exact variants from the analytics phase's summarize runs, and the
general ones from the ambiguous phase's ``kernel="general"`` runs (2c).
The windows and flags phases zero the counters before each of their runs
as well, require the kernels each run must launch, and print their counts
on their own lines; the kernels line does not take them.
Launches of the kernel-vs-plain checks (every weighted entry in lo_int8
too, the factorized ones in split_bf16 and bf16-exact, each on a full
batch of the main path's own session) are not counted.  The last three
lines of standard output are the kernels JSON, the card line from
nvidia-smi, and the result JSON.  The script makes only
the first visible card visible to itself.
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
# The analytics phase's edges, and the sites of its matrix-export slices
# (the session's method; the CLI's --matrix-output).
HIST_EDGES = "0,0.1,0.2,0.5,1.01"
DECAY_EDGES = "0,1,10,100,1000,10000,100000"
TOP_K = 1000
MATRIX_SITES, MATRIX_CLI_SITES = 8192, 2048
# (N, S, seq_chunk) of the entries phase: N_pad below, at and above 1,024
# at the headline S, planes + xq of 1.2 GB at N = 1,000, and a seq chunk
# that is not a multiple of 16 (4-byte operand copies); None = auto.
ENTRY_SHAPES = ((500, S_HEAD, None), (1000, S_HEAD, None),
                (2000, S_HEAD, None), (1000, 147456, None),
                (1000, S_HEAD, 200))
ENTRY_MODES = ("none", "lo_int8", "split_bf16")

# The ambiguous cell: sequences x columns, ambiguous columns, planted
# triplets, and the columns of its CPU-vs-card slice.
N_AMB, S_AMB, N_DIRTY, N_AMB_GROUPS = 1024, 16384, 164, 300
# The ingest phase's cohort: the 2,504 samples of 1000 Genomes phase 3 as
# phased diploid haplotypes, over the headline's 49,152 sites.
N_COHORT, S_COHORT = 5008, 49152
AMB_SLICE = 4096
# The windows phase: the headline alignment on chromosome 20 with POS a
# seeded cumulative sum of geometric gaps of mean WIN_GAP bp; PLINK 1.9's
# default --ld-window-kb 1000 as the bp window, a site window beside it,
# the decay edges (the window is inclusive and the bins half-open, so the
# last edge is one past it), the region, the ambiguous FASTA's site
# windows, and the cohort subset (the samples of 1000 Genomes phase 3's
# EUR super-population).
WIN_SEED, WIN_GAP, WIN_BP, WIN_SITES = 20, 200, 1_000_000, 5000
WIN_DECAY = "0,1000,10000,100000,1000001"
WIN_REGION = (2_000_001, 6_000_000)
WIN_AMB, WIN_AMB_SLICE, N_SUBSET = 2000, 500, 503

# name -> (TPU kernel it replaces, source)
MAJMIN_SRC = "weightedld_tpu_torch/csrc/ld_majmin.cu"
GENERAL_SRC = "weightedld_tpu_torch/csrc/ld_general.cu"
KERNELS = {
    "ld_majmin_codes": ("weightedld_tpu/ops/pallas_ld.py:847", MAJMIN_SRC),
    "ld_majmin_planes": ("weightedld_tpu/ops/pallas_ld.py:1110", MAJMIN_SRC),
    "ld_general": ("weightedld_tpu/ops/pallas_ld.py:184", GENERAL_SRC),
    "ld_general_unit": ("weightedld_tpu/ops/pallas_ld.py:361", GENERAL_SRC),
    "ld_general_planes": ("weightedld_tpu/ops/pallas_ld.py:658", GENERAL_SRC),
    # The lo_int8 weight mode of the same bodies (pallas_ld.py:926-930,
    # :1173-1177, :307-315), counted under their own names.
    "ld_majmin_codes_lo_int8": ("weightedld_tpu/ops/pallas_ld.py:926",
                                MAJMIN_SRC),
    "ld_majmin_planes_lo_int8": ("weightedld_tpu/ops/pallas_ld.py:1173",
                                 MAJMIN_SRC),
    # The factorized kernel's other float modes (pallas_ld.py:931-935,
    # :1178-1182), counted under their own names as well.
    "ld_majmin_codes_split_bf16": ("weightedld_tpu/ops/pallas_ld.py:931",
                                   MAJMIN_SRC),
    "ld_majmin_planes_split_bf16": ("weightedld_tpu/ops/pallas_ld.py:1178",
                                    MAJMIN_SRC),
    "ld_majmin_codes_bf16_exact": ("weightedld_tpu/ops/pallas_ld.py:934",
                                   MAJMIN_SRC),
    "ld_majmin_planes_bf16_exact": ("weightedld_tpu/ops/pallas_ld.py:1181",
                                    MAJMIN_SRC),
    "ld_general_lo_int8": ("weightedld_tpu/ops/pallas_ld.py:307",
                           GENERAL_SRC),
    "ld_general_planes_lo_int8": ("weightedld_tpu/ops/pallas_ld.py:307",
                                  GENERAL_SRC),
    # The general kernel's other float modes (pallas_ld.py:316-325).
    "ld_general_split_bf16": ("weightedld_tpu/ops/pallas_ld.py:316",
                              GENERAL_SRC),
    "ld_general_planes_split_bf16": ("weightedld_tpu/ops/pallas_ld.py:316",
                                     GENERAL_SRC),
    "ld_general_bf16_exact": ("weightedld_tpu/ops/pallas_ld.py:322",
                              GENERAL_SRC),
    "ld_general_planes_bf16_exact": ("weightedld_tpu/ops/pallas_ld.py:322",
                                     GENERAL_SRC),
}
# The H100 SXM's published dense peaks at 700 W (int8 and bf16 tensor
# cores, HBM3), against which bound_ms is computed.
PEAK_INT8_OPS, PEAK_BF16_FLOPS, PEAK_BYTES = 1979e12, 989e12, 3.35e12
# The int8x3 factorized entries' times on the kernel-timing plan with the
# earlier dp4a body, in launches of <= 128 tiles (PERF.md), printed beside
# the tensor-core body's.
DP4A_MS = {"ld_majmin_codes": 10.307, "ld_majmin_planes": 9.455}
# The general entries' times on the same plan with the earlier CUDA-core
# dp4a body (one launch each, an H100 80GB HBM3 at 700 W; PERF.md),
# printed beside the tensor-core body's.
GENERAL_DP4A_MS = {
    "ld_general": 22.867, "ld_general_unit": 17.876,
    "ld_general_planes": 32.396, "ld_general_lo_int8": 31.379,
    "ld_general_planes_lo_int8": 41.020, "ld_general_split_bf16": 28.843,
    "ld_general_bf16_exact": 24.961}

# The general kernel's cases: seed, alphabet, N, S, tile, seq_chunk, weight
# mode, UNKNOWN cell fraction, planes (None = the planes present).
GENERAL_CASES = (
    (21, (0, 1, 2, 3, 4), 1000, 700, 256, 256, "int8x3", 0.01, None),
    (22, (0, 1, 2, 3, 4), 150, 300, 48, 64, "int8x3", 0.05, None),
    (23, (0, 1, 4), 150, 300, 48, 64, "unit", 0.10, None),
    (24, (0, 1), 150, 300, 48, 64, "exact", 0.05, None),
    (25, (0, 1, 2, 4), 150, 300, 48, 64, "split_bf16", 0.03, None),
    (26, (0, 3, 4), 150, 300, 48, 64, "int8", 0.02, None),
    (27, (0, 1, 2, 3, 4), 37, 90, 32, 40, "unit", 0.05, None),
    (28, (0, 1, 2, 3, 4), 333, 257, 64, 120, "int8x3", 0.04, (0, 2, 4)),
    (29, (0, 1, 2, 3, 4), 333, 257, 64, 120, "unit", 0.04, (1, 3)),
    (30, (0, 1, 2, 3, 4), 1000, 700, 256, 256, "lo_int8", 0.01, None),
    (32, (0, 1, 2, 3, 4), 333, 257, 64, 120, "lo_int8", 0.04, (0, 2, 4)),
)
GENERAL_MODES = ("int8x3", "int8", "unit", "lo_int8", "split_bf16", "exact")


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


def ptxas_report(text: str) -> list[str]:
    """One line per kernel instantiation of ``nvcc -Xptxas -v``'s report:
    the kernel with its template arguments, registers (the launch's count;
    warpgroups that run ``setmaxnreg`` differ), stack, spill stores and
    loads, and whether ptxas serialized its wgmma (C7515)."""
    import re

    def short(mangled: str) -> str:
        m = re.search(r"\d(ld_\w+?)I((?:L[ib]\d+E)+)E", mangled)
        if not m:
            return mangled
        args = re.findall(r"L[ib](\d+)E", m.group(2))
        return f"{m.group(1)}<{','.join(args)}>"

    rows, serial, cur = {}, set(), None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = short(m.group(1))
            rows[cur] = {}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            rows[cur].update(stack=m.group(1), st=m.group(2), ld=m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            rows[cur]["regs"] = m.group(1)
        m = re.search(r"\(C7515\).*'(\w+)'", line)
        if m:
            serial.add(short(m.group(1)))
    return [f"{name}: {r.get('regs', '?')} registers, {r.get('stack', '?')} "
            f"B stack, {r.get('st', '?')} B spill stores, {r.get('ld', '?')} "
            f"B spill loads" + (", wgmma serialized (C7515)"
                                if name in serial else "")
            for name, r in rows.items()]


def phase_build() -> None:
    import threading
    import warnings

    from weightedld_tpu_torch.io import native
    from weightedld_tpu_torch.ops import _build

    log(f"[build] card: {card_line()}")
    t0 = time.monotonic()
    # g++ builds the native io library while nvcc builds the kernels.
    t_native = {}

    def build_native():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # reported by the ingest phase
            native.load()
        t_native["s"] = time.monotonic() - t0

    th = threading.Thread(target=build_native)
    th.start()
    _build.load_library()
    th.join()
    log(f"[build] native io library: "
        f"{native.library_path().name if native.available() else 'unavailable'}"
        f" in {t_native['s']:.2f}s (g++, beside nvcc)")
    info = _build.build_info
    log(f"[build] {[p.name for p in info.paths]}: compiled "
        f"{info.compiled} in parallel, nvcc {info.seconds:.2f}s, build + "
        f"load {time.monotonic() - t0:.2f}s")
    for line in ptxas_report(info.ptxas):
        log(f"[build] ptxas {line}")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _case_inputs(seed, alphabet, n_seqs, n_sites, tile, seq_chunk, wq,
                 device, aln=None):
    import torch

    from weightedld_tpu_torch.ops import cuda_ld as K
    from weightedld_tpu_torch.parallel.triangle import plan_tiles

    rng = np.random.default_rng(seed)
    if aln is None:
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
    elif wq == "lo_int8":
        wr = K.pad_weights_lo_int8(w, seq_chunk)
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
              wquant=wq if wq in ("int8", "int8x3", "lo_int8") else "")
    return (t(codes), t(wr), t(auxc), t(plan.tile_i), t(plan.tile_j),
            t(emit), kw)


def _general_case_inputs(seed, alphabet, n_seqs, n_sites, tile, seq_chunk,
                         wq, unknown, planes, device, dirty_sites=None):
    """Inputs of the general kernel: UNKNOWN cells at a fraction
    ``unknown`` of all cells, or 1-2 cells at ``dirty_sites`` random sites;
    ``planes`` None = the planes present."""
    from weightedld_tpu_torch.ops import cuda_ld as K

    rng = np.random.default_rng(seed)
    aln = rng.choice(alphabet, size=(n_seqs, n_sites)).astype(np.int8)
    if dirty_sites is None:
        aln[rng.random(aln.shape) < unknown] = 5
    else:
        for s in rng.choice(n_sites, size=dirty_sites, replace=False):
            aln[rng.choice(n_seqs, size=rng.integers(1, 3), replace=False),
                s] = 5
    out = _case_inputs(seed, alphabet, n_seqs, n_sites, tile, seq_chunk, wq,
                       device, aln=aln)
    codes, wr, _auxc, ti, tj, em, kw = out
    kw["planes"] = planes or K.detect_planes_unknown(aln)[0]
    return codes, wr, ti, tj, em, kw


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


def check_session_batch(sess, label: str, b: int = 0,
                        piece: int = 128) -> tuple[str, float]:
    """Batch ``b`` of ``sess`` through its kernel entry, with the session's
    own operands, tile lists and keywords (the main path's launch shape),
    held against the plain version (run ``piece`` tiles at a time: every
    tile is independent); returns the kernel's name and the max abs error
    on kept pairs."""
    import torch

    from weightedld_tpu_torch.ops import cuda_general, cuda_ld

    fn, plain, args, kw = sess.batch_kernel(b)
    ti, tj, em = sess.batch_tiles(b)
    before = {**cuda_ld.launches, **cuda_general.launches}
    got = fn(*args, ti, tj, em, **kw)
    after = {**cuda_ld.launches, **cuda_general.launches}
    (name,) = [n for n in after if after[n] != before[n]]
    parts = [plain(*args, ti[p:p + piece], tj[p:p + piece], em[p:p + piece],
                   **kw) for p in range(0, ti.shape[0], piece)]
    ref = type(got)(*(torch.cat([getattr(x, f) for x in parts])
                      for f in got._fields))
    torch.cuda.synchronize()
    e = _compare(got, ref, label)
    log(f"[check] ok: {label}: {name} batch {b} of {sess.n_batches}, "
        f"{ti.shape[0]} tiles, {sess.cfg}, {int(ref.keep.sum())} kept pairs, "
        f"max |kernel - plain| {e}")
    return name, e


def _hold_pieces(got, ref: list, piece: int, label: str, bitwise: dict,
                 name: str) -> float:
    """Hold one launch's stats ``got`` against the plain version's run in
    pieces of ``piece`` tiles (``ref``); clears ``bitwise[name]`` where r2
    differs in a bit; returns the max abs error on kept pairs."""
    import torch

    worst = 0.0
    for b, r in enumerate(ref):
        g = type(got)(*(getattr(got, f)[b * piece:(b + 1) * piece]
                        for f in got._fields))
        worst = max(worst, _compare(g, r, f"{label} piece {b}"))
        bitwise[name] &= bool(torch.equal(g.r2[r.keep], r.r2[r.keep]))
    return worst


# Weight mode -> the suffix its launches count under: every entry counts
# each float mode under its own name.
MODE_SUFFIX = {"lo_int8": "_lo_int8", "split_bf16": "_split_bf16",
               "exact": "_bf16_exact"}
# The factorized rows r2 must be bit-equal on (their weights keep every f32
# partial sum exact: the note at the top of csrc/ld_majmin.cu).
BIT_EQUAL_MODES = ("lo_int8", "exact")
# The general rows r2 must be bit-equal on: the integer modes always, and
# lo_int8 and bf16-exact, whose kernels-phase weights (in [2^-5, 1] or
# multiples of 1/4, N < 4,096) keep every f32 partial sum exact.
GENERAL_BIT_EQUAL_MODES = ("int8x3", "int8", "unit", "lo_int8", "exact")
# Passes of each factorized weight mode on the int8 and on the bf16 tensor
# cores, by the function (lo_int8's residual is an int8 pass).
INT8_PASSES = {"int8x3": 3, "lo_int8": 1}
BF16_PASSES = {"lo_int8": 1, "split_bf16": 2, "exact": 1}
# The general body's passes (the weighted ones and the unit pass whose
# joint gives the counts) and their type: its own work is P^2 MACs per pass,
# pair and sequence column.
GENERAL_PASSES = {"int8x3": (4, "int8"), "int8": (3, "int8"),
                  "unit": (1, "int8"), "lo_int8": (3, "bf16"),
                  "split_bf16": (3, "bf16"), "exact": (2, "bf16")}
# The general body's edges, each in every weight mode and both entries:
# seed, alphabet, N, S, tile, seq_chunk, UNKNOWN cell fraction, planes.  P
# = 2..5; T = 512 and tiles below a CTA's block of sites; seq chunks that
# are not multiples of 16 (4-byte staging); N = 3,000 in three chunks; a
# restricted planes tuple.
GENERAL_EDGE_CASES = (
    (41, (0, 1), 200, 600, 512, 200, 0.03, None),
    (42, (0, 1, 2), 150, 300, 96, 40, 0.05, None),
    (43, (0, 1, 2, 4), 3000, 300, 96, 1024, 0.02, None),
    (44, (0, 1, 2, 3, 4), 200, 600, 512, 200, 0.01, None),
    (45, (0, 1, 2, 3, 4), 150, 300, 48, 120, 0.05, (1, 3, 4)),
    (46, (0, 1, 2, 3, 4), 3000, 300, 96, 1024, 0.02, None),
)


def _variant(name: str, wq: str) -> str:
    """The kernels-line name of entry ``name`` under weight mode ``wq``."""
    return name + MODE_SUFFIX.get(wq, "")


def _bound(ops_int8: float, flops_bf16: float, nbytes: float,
           ) -> tuple[float, str]:
    """``(bound_ms, bound_by)``: the larger of the bytes over the HBM rate
    and the operations over the tensor-core peaks of their type."""
    t_ops = ops_int8 / PEAK_INT8_OPS + flops_bf16 / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_kernels() -> dict:
    import torch

    from weightedld_tpu_torch.ops import cuda_general as G
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
        (9, (0, 1, 4), 1000, 700, 256, 256, "lo_int8"),
        (10, (0, 1, 2, 3, 4), 150, 300, 48, 64, "lo_int8"),
        (12, (0, 1, 4), 333, 257, 64, 120, "lo_int8"),
        # The wgmma body's edges: a CTA block larger than the tile, 4-byte
        # staging (N_pad and seq_chunk not multiples of 16), three chunks.
        (13, (0, 1, 4), 200, 600, 512, 200, "int8x3"),
        (14, (0, 1, 2, 3, 4), 150, 300, 96, 40, "int8"),
        (15, (0, 1, 4), 3000, 300, 96, 1024, "int8x3"),
        # The same edges in the float modes (bf16 operands, 64-column
        # stages): 4-byte staging, a block larger than the tile, N = 3,000.
        (16, (0, 1, 4), 200, 600, 512, 200, "split_bf16"),
        (17, (0, 1, 2, 3, 4), 150, 300, 96, 40, "exact"),
        (18, (0, 1, 4), 3000, 300, 96, 1024, "lo_int8"),
        (19, (0, 1, 4), 200, 600, 512, 200, "lo_int8"),
        (20, (0, 1, 2, 3, 4), 150, 300, 96, 120, "split_bf16"),
        (22, (0, 1, 4), 3000, 300, 96, 1024, "exact"),
    ]
    for seed, alpha, n, s, tile, chunk, wq in cases:
        codes, wr, auxc, ti, tj, em, kw = _case_inputs(
            seed, alpha, n, s, tile, chunk, wq, dev)
        label = f"N={n} S={s} T={tile} chunk={chunk} {wq} alphabet={alpha}"
        name = _variant("ld_majmin_codes", wq)
        got = K.tile_stats_majmin(codes, wr, auxc, ti, tj, em, **kw)
        ref = K.tile_stats_majmin_plain(codes, wr, auxc, ti, tj, em, **kw)
        torch.cuda.synchronize()
        err[name] = max(err[name], _compare(got, ref, "codes " + label))
        bitwise[name] &= bool(torch.equal(got.r2[ref.keep], ref.r2[ref.keep]))
        planes = K.build_majmin_planes(codes, auxc, tile=tile)
        nlev = {"int8": 2, "int8x3": 3}.get(kw["wquant"], 0)
        xq = K.build_majmin_xq(planes, wr, nlev) if nlev else None
        name = _variant("ld_majmin_planes", wq)
        got = K.tile_stats_majmin_pre(planes, xq, wr, auxc, ti, tj, em, **kw)
        ref = K.tile_stats_majmin_pre_plain(planes, xq, wr, auxc, ti, tj, em,
                                            **kw)
        torch.cuda.synchronize()
        err[name] = max(err[name], _compare(got, ref, "planes " + label))
        bitwise[name] &= bool(torch.equal(got.r2[ref.keep], ref.r2[ref.keep]))
        log(f"[kernels] ok: {label}")
    log(f"[kernels] max |kernel - plain| on kept pairs: {err}; "
        f"r2 bitwise equal: {bitwise}")

    # Time both entry points and their plain versions on the full tile
    # plan of N=1,000 x S=8,192 (T=256, one 1,024-wide seq chunk; int8x3,
    # then each float mode), then hold the timed calls' outputs against
    # each other.
    # A kernel takes the whole plan in one launch, as the main path gives
    # it batches of thousands of tiles; the plain version runs in pieces of
    # `batch` tiles, which bound its float64 operands.
    batch = 128
    ms, plain_ms, bound, shape, ms_pieces = {}, {}, {}, {}, {}
    for wq in ("int8x3", "lo_int8", "split_bf16", "exact"):
        codes, wr, auxc, ti, tj, em, kw = _case_inputs(
            11, (0, 1, 4), N_HEAD, S_TIMED, 256, 1024, wq, dev)
        em = torch.ones_like(em)
        planes = K.build_majmin_planes(codes, auxc, tile=256)
        nlev = 3 if wq == "int8x3" else 0
        xq = K.build_majmin_xq(planes, wr, 3) if nlev else None

        def run(fn, *ops, step=ti.shape[0]):
            return [fn(*ops, wr, auxc, ti[lo:lo + step], tj[lo:lo + step],
                       em[lo:lo + step], **kw)
                    for lo in range(0, ti.shape[0], step)]

        ops = {"ld_majmin_codes": (K.tile_stats_majmin,
                                   K.tile_stats_majmin_plain, (codes,)),
               "ld_majmin_planes": (K.tile_stats_majmin_pre,
                                    K.tile_stats_majmin_pre_plain,
                                    (planes, xq))}
        # Work of the whole plan: 4 cells per output pair, per sequence
        # column: int8x3 3 int8 MACs; lo_int8 one bf16 MAC (w_hi) and one
        # int8 MAC (the residual); split_bf16 two bf16 MACs; bf16-exact
        # one.  Bytes: each input read once, the outputs (d, d', r2 f32,
        # keep int8) written once.
        pairs = ti.shape[0] * 256 * 256
        n_pad, s_pad = codes.shape[1], codes.shape[0]
        macs = 4 * pairs * n_pad
        out_bytes = 13 * pairs + 12 * ti.shape[0] + wr.numel() * 4 \
            + auxc.numel() * 4
        for name, (fn, plain, src) in ops.items():
            vname = _variant(name, wq)
            in_bytes = sum(x.numel() for x in src if x is not None)
            bound[vname] = _bound(2 * macs * INT8_PASSES.get(wq, 0),
                                  2 * macs * BF16_PASSES.get(wq, 0),
                                  in_bytes + out_bytes)
            ms[vname], (got,) = _time_cuda(lambda: run(fn, *src), 10)
            if vname in DP4A_MS:
                # The dp4a body's method: launches of <= 128 tiles, each
                # paying the wrapper's host work.
                ms_pieces[vname] = _time_cuda(
                    lambda: run(fn, *src, step=batch), 10)[0]
            plain_ms[vname], ref = _time_cuda(
                lambda: run(plain, *src, step=batch), 1)
            err[vname] = max(err[vname], _hold_pieces(
                got, ref, batch, f"{vname} timed N={N_HEAD} S={S_TIMED} "
                f"chunk=1024", bitwise, vname))
            shape[vname] = f"{wq}, s_pad {s_pad}, n_pad {n_pad}"
            log(f"[kernels] ok: {vname} timed calls, {ti.shape[0]} tiles in "
                f"one launch, kernel == plain")
            del got, ref
        del codes, planes, xq

    # The general kernel's entries (codes, unit weights, preplaned) against
    # their plain versions: P = 2..5, 1-10 % UNKNOWN cells, a restricted
    # planes tuple, every weight mode; then the body's edges in every mode.
    edges = [(seed, alpha, n, s, tile, chunk, wq, unk, planes)
             for seed, alpha, n, s, tile, chunk, unk, planes
             in GENERAL_EDGE_CASES for wq in GENERAL_MODES]
    for seed, alpha, n, s, tile, chunk, wq, unk, planes in (*GENERAL_CASES,
                                                            *edges):
        codes, wr, ti, tj, em, kw = _general_case_inputs(
            seed, alpha, n, s, tile, chunk, wq, unk, planes, dev)
        label = (f"N={n} S={s} T={tile} chunk={chunk} {wq} UNKNOWN {unk} "
                 f"planes={kw['planes']}")
        for pre in (False, True):
            src = G.build_planes_tiled(codes, tile=tile, planes=kw["planes"]) \
                if pre else codes
            name = _variant("ld_general_planes" if pre else (
                "ld_general_unit" if wq == "unit" else "ld_general"), wq)
            got = G.tile_stats_general(src, wr, ti, tj, em, preplaned=pre,
                                       **kw)
            ref = G.tile_stats_general_plain(src, wr, ti, tj, em,
                                             preplaned=pre, **kw)
            torch.cuda.synchronize()
            err[name] = max(err[name], _compare(got, ref, f"{name} {label}"))
            bitwise[name] &= bool(torch.equal(got.r2[ref.keep],
                                              ref.r2[ref.keep]))
        log(f"[kernels] ok: general {label}")
    log(f"[kernels] max |kernel - plain| on kept pairs: {err}; "
        f"r2 bitwise equal: {bitwise}")

    # Time the general entries and their plain versions on the full plan of
    # N=1,000 x S=8,192 at P = 5 with 1 % UNKNOWN sites (T=256, one
    # 1,024-wide chunk; the kernel in one launch, the plain version in
    # pieces), outputs held against each other, in every mode the main
    # path launches.
    own = {}
    for entry, wq, pre in (("ld_general", "int8x3", False),
                           ("ld_general_unit", "unit", False),
                           ("ld_general_planes", "int8x3", True),
                           ("ld_general", "lo_int8", False),
                           ("ld_general_planes", "lo_int8", True),
                           ("ld_general", "split_bf16", False),
                           ("ld_general_planes", "split_bf16", True),
                           ("ld_general", "exact", False),
                           ("ld_general_planes", "exact", True)):
        name = _variant(entry, wq)
        codes, wr, ti, tj, em, kw = _general_case_inputs(
            31, (0, 1, 2, 3, 4), N_HEAD, S_TIMED, 256, 1024, wq, 0.0, None,
            dev, dirty_sites=S_TIMED // 100)
        em = torch.ones_like(em)
        src = G.build_planes_tiled(codes, tile=256, planes=kw["planes"]) \
            if pre else codes

        def grun(fn, step=ti.shape[0]):
            return [fn(src, wr, ti[lo:lo + step], tj[lo:lo + step],
                       em[lo:lo + step], preplaned=pre, **kw)
                    for lo in range(0, ti.shape[0], step)]

        # Least work: per output pair and sequence column the 2P count
        # MACs, then the four selected cells per weight pass (int8x3: 3
        # int8 levels; unit: 1; lo_int8: one int8 and one bf16; split_bf16:
        # two bf16; bf16-exact: one bf16) — the least work of the known
        # formulations, the table's bound.  Own work: this body's P^2 MACs
        # per pass (GENERAL_PASSES), the count pass included.
        p = len(kw["planes"])
        pairs = ti.shape[0] * 256 * 256
        n_pad = codes.shape[1]
        cells = {"int8x3": 12, "unit": 4, "lo_int8": 4}.get(wq, 0)
        cells16 = {"lo_int8": 4, "split_bf16": 8, "exact": 4}.get(wq, 0)
        nbytes = src.numel() + wr.numel() * 4 + 12 * ti.shape[0] + 13 * pairs
        bound[name] = _bound(2 * pairs * n_pad * (2 * p + cells),
                             2 * pairs * n_pad * cells16, nbytes)
        passes, kind = GENERAL_PASSES[wq]
        ops = 2 * pairs * n_pad * p * p * passes
        own[name] = _bound(ops if kind == "int8" else 0,
                           ops if kind == "bf16" else 0, nbytes)
        ms[name], (got,) = _time_cuda(lambda: grun(G.tile_stats_general), 5)
        plain_ms[name], ref = _time_cuda(
            lambda: grun(G.tile_stats_general_plain, step=batch), 1)
        err[name] = max(err.get(name, 0.0), _hold_pieces(
            got, ref, batch, f"{name} timed N={N_HEAD} S={S_TIMED} "
            f"chunk=1024", bitwise, name))
        shape[name] = f"{wq}, P={p}"
        log(f"[kernels] ok: {name} timed calls, {ti.shape[0]} tiles in "
            f"one launch, kernel == plain")
        del got, ref, codes, src

    n_pairs = S_TIMED * (S_TIMED - 1) // 2
    card = card_line()
    for name in ms:
        log(f"[kernels] {name}: {ms[name]:.3f} ms kernel vs "
            f"{plain_ms[name]:.3f} ms plain, bound {bound[name][0]:.4f} ms "
            f"({bound[name][1]}) for {ti.shape[0]} tiles (N={N_HEAD}, "
            f"S={S_TIMED}, T=256, {shape[name]}): "
            f"{n_pairs / (ms[name] / 1e3):.4g} pairs/s kernel | {card}")
    for name, old in GENERAL_DP4A_MS.items():
        log(f"[kernels] {name} on wgmma: {ms[name]:.3f} ms in one launch, "
            f"where the dp4a body took {old} ms (an H100 80GB HBM3 at 700 "
            f"W): {old / ms[name]:.2f}x; least-work bound "
            f"{bound[name][0]:.4f} ms ({bound[name][0] / ms[name]:.1%}), "
            f"this body's own-work bound {own[name][0]:.4f} ms "
            f"({own[name][0] / ms[name]:.1%}) | {card}")
    for name in ("ld_general_planes_split_bf16",
                 "ld_general_planes_bf16_exact"):
        log(f"[kernels] {name} on wgmma: {ms[name]:.3f} ms in one launch "
            f"(no dp4a time); least-work bound {bound[name][0]:.4f} ms "
            f"({bound[name][0] / ms[name]:.1%}), own-work bound "
            f"{own[name][0]:.4f} ms ({own[name][0] / ms[name]:.1%}) | {card}")
    log(f"[kernels] r2 bitwise equal, kernel vs plain: {bitwise}")
    unequal = [_variant(entry, wq) for entry in ("ld_majmin_codes",
                                                 "ld_majmin_planes")
               for wq in BIT_EQUAL_MODES
               if not bitwise[_variant(entry, wq)]]
    unequal += [_variant(entry, wq) for entry in ("ld_general",
                                                  "ld_general_planes")
                for wq in GENERAL_BIT_EQUAL_MODES
                if not bitwise[_variant(entry, wq)]]
    unequal += [] if bitwise["ld_general_unit"] else ["ld_general_unit"]
    if unequal:
        raise AssertionError(f"r2 not bit-equal to the plain version in "
                             f"{unequal}, whose weights keep every f32 "
                             f"partial sum exact")
    for name, old in DP4A_MS.items():
        log(f"[kernels] {name} int8x3 on wgmma: {ms[name]:.3f} ms in one "
            f"launch, {bound[name][0] / ms[name]:.1%} of its bound; "
            f"{ms_pieces[name]:.3f} ms in launches of <= {batch} tiles, "
            f"where the dp4a body took {old} ms (an H100 80GB HBM3 at "
            f"700 W) | {card}")
    phase_yardstick()                      # the same call, the same clock
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound": bound}


def phase_general() -> None:
    """Not in the default run: every general entry in every weight mode, on
    each of ``GENERAL_CASES`` and on one launch of the 528-tile timing plan,
    synchronized after each launch and held against the plain version, so
    that a fault shows at the launch that made it (run it under
    ``compute-sanitizer --tool memcheck`` where the toolkit has one)."""
    import torch

    from weightedld_tpu_torch.ops import cuda_general as G

    dev = torch.device("cuda")
    cases = [(seed, alpha, n, s, tile, chunk, wq, unk, planes, None)
             for seed, alpha, n, s, tile, chunk, _wq, unk, planes
             in GENERAL_CASES for wq in GENERAL_MODES]
    cases += [(31, (0, 1, 2, 3, 4), N_HEAD, S_TIMED, 256, 1024, wq, 0.0,
               None, S_TIMED // 100) for wq in GENERAL_MODES]
    for seed, alpha, n, s, tile, chunk, wq, unk, planes, dirty in cases:
        codes, wr, ti, tj, em, kw = _general_case_inputs(
            seed, alpha, n, s, tile, chunk, wq, unk, planes, dev,
            dirty_sites=dirty)
        for pre in (False, True):
            label = (f"{'planes' if pre else 'codes'} N={n} S={s} T={tile} "
                     f"chunk={chunk} {wq} planes={kw['planes']}")
            src = G.build_planes_tiled(codes, tile=tile, planes=kw["planes"]) \
                if pre else codes
            torch.cuda.synchronize()
            got = G.tile_stats_general(src, wr, ti, tj, em, preplaned=pre,
                                       **kw)
            torch.cuda.synchronize()
            step = 128
            ref = [G.tile_stats_general_plain(
                src, wr, ti[lo:lo + step], tj[lo:lo + step], em[lo:lo + step],
                preplaned=pre, **kw) for lo in range(0, ti.shape[0], step)]
            e = _hold_pieces(got, ref, step, label, {"x": True}, "x")
            log(f"[general] ok: {label}, {ti.shape[0]} tiles, max |kernel - "
                f"plain| {e}")
            del got, ref, src
    log(f"[general] every case passed | {card_line()}")


def phase_yardstick() -> None:
    """Two yardsticks on the timed plan (N=1,000 x S=8,192), each the
    factorized kernel's contraction alone, the whole square (twice the
    triangle the kernel computes), without the selection, the combine or
    the finalize — "contraction only", yardsticks and no function of the
    port: ``torch._int_mm`` over int8x3's three cascade levels
    (``xq_l [2*S_pad, N_pad]`` against the planes' transpose), and
    ``torch.mm`` over one bf16 float pass (the planes times bf16(w) against
    the planes' transpose, bf16 -> f32)."""
    import torch

    from weightedld_tpu_torch.ops import cuda_ld as K

    dev = torch.device("cuda")
    codes, wr, auxc, _ti, _tj, _em, _kw = _case_inputs(
        11, (0, 1, 4), N_HEAD, S_TIMED, 256, 1024, "int8x3", dev)
    planes = K.build_majmin_planes(codes, auxc, tile=256)
    xq = K.build_majmin_xq(planes, wr, 3)
    pt = planes.t()
    t_ms, _out = _time_cuda(lambda: [torch._int_mm(xq[lv], pt)
                                     for lv in range(3)], 3)
    del _out
    m, kdim = planes.shape
    ops = 3 * 2 * m * m * kdim
    log(f"[yardstick] torch._int_mm, 3 levels of [{m}, {kdim}] x [{kdim}, "
        f"{m}] int8 -> int32 (contraction only, whole square): {t_ms:.3f} "
        f"ms, {ops / (t_ms / 1e3):.4g} int8 ops/s | {card_line()}")
    del xq
    _c, wf, _a, _ti, _tj, _em, _kw = _case_inputs(
        11, (0, 1, 4), N_HEAD, S_TIMED, 256, 1024, "split_bf16", dev)
    xs = planes.to(torch.bfloat16) * wf[0].to(torch.bfloat16)
    yt = planes.to(torch.bfloat16).t()
    try:                       # f32 out where this torch offers it
        torch.mm(xs[:64], yt[:, :64], out_dtype=torch.float32)
        out = "bf16 -> f32"
        bf16_ms, _out = _time_cuda(
            lambda: torch.mm(xs, yt, out_dtype=torch.float32), 3)
    except TypeError:
        out = "bf16 -> bf16 (this torch.mm takes no out_dtype)"
        bf16_ms, _out = _time_cuda(lambda: torch.mm(xs, yt), 3)
    log(f"[yardstick] torch.mm, one float pass of [{m}, {kdim}] x [{kdim}, "
        f"{m}] {out} (contraction only, whole square): {bf16_ms:.3f} ms, "
        f"{2 * m * m * kdim / (bf16_ms / 1e3):.4g} bf16 FLOP/s | "
        f"{card_line()}")


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


def write_vcf(path: Path, aln: np.ndarray, pos=None, chrom=None) -> None:
    """Phased diploid VCF whose reader output is ``aln`` (rows are the
    reversed file-order haplotypes), POS = ``pos`` (default site index +
    1), CHROM = ``chrom`` (one name per site, default ``1``); text built
    with numpy, one genotype block per site."""
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
    pos = np.arange(1, s + 1) if pos is None else np.asarray(pos)
    chrom = ["1"] * s if chrom is None else chrom
    with open(path, "wb") as fh:
        fh.write(head.encode())
        for i in range(s):
            fh.write(f"{chrom[i]}\t{pos[i]}\trs{i + 1}\tA\tT\t100\tPASS\t.\t"
                     "GT\t".encode())
            fh.write(rows[i].tobytes())


def headline_vcf(tmp: Path, tag: str = "main") -> tuple[Path, np.ndarray,
                                                       np.ndarray]:
    """The headline VCF (1,000 haplotypes x 49,152 sites, seed 2024),
    written into ``tmp`` unless it is there: ``(path, alignment, planted
    triplets)``."""
    rng = np.random.default_rng(2024)
    t0 = time.monotonic()
    aln, seeds = loaded_alignment(rng, N_HEAD, S_HEAD, N_TRIPLETS)
    vcf = tmp / "headline.vcf"
    if not vcf.exists():
        write_vcf(vcf, aln)
        log(f"[{tag}] synthetic VCF {N_HEAD} x {S_HEAD}: "
            f"{vcf.stat().st_size / 1e6:.1f} MB in "
            f"{time.monotonic() - t0:.1f}s")
    return vcf, aln, seeds


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
    from weightedld_tpu_torch.ops import cuda_general, cuda_ld

    cuda_ld.reset_launches()
    cuda_general.reset_launches()
    out = fn(*args, **kwargs)
    return out, {**cuda_ld.launches, **cuda_general.launches}


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

    vcf, aln, seeds = headline_vcf(tmp)
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
    planted = planted_pairs(seeds, offset=1)         # VCF POS = index + 1
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
    np.save(tmp / "headline_aln.npy", aln[:, :MATRIX_SITES])
    np.save(tmp / "headline_seeds.npy", seeds)

    # The same input through the library entry with the codes entry, the
    # path of inputs whose planes do not fit the card (plane_budget).
    res = prepare(vcf)
    np.savez(tmp / "headline_prepared.npz", alignment=res.alignment,
             weights=res.weights, site_map=res.site_map)
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
        _name, err[name] = check_session_batch(sess, f"headline {name}")
        del sess
    return launches, err


def phase_cpu_vs_card(tmp: Path) -> tuple[str, float]:
    """The slice run on both devices; returns the kernel of the card run
    and the max abs error of its batch check."""
    from weightedld_tpu_torch.pipeline import prepare

    aln = (np.load(tmp / "headline_aln.npy") if (
        tmp / "headline_aln.npy").exists() else loaded_alignment(
            np.random.default_rng(2024), N_HEAD, S_HEAD, N_TRIPLETS
        )[0])[:, :SLICE_SITES]
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
    return check_session_batch(sess, "slice")


def _json_run(argv: list[str]) -> tuple[dict, dict]:
    """One CLI run of a JSON output mode: ``(its JSON, its launch
    counts)``."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        counts = _drive(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1]), counts


def _hold_records(got: dict, want: dict, label: str, rtol: float = 2e-5,
                  atol: float = 1e-6) -> float:
    """Assert two record maps (``read_records``) hold the same pairs with
    values within ``rtol`` / ``atol`` (equal non-finite patterns); returns
    the max abs difference."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: record sets differ ({len(got)} vs "
                             f"{len(want)})")
    worst = 0.0
    for key, w in want.items():
        g, w = np.asarray(got[key]), np.asarray(w)
        fin = np.isfinite(w)
        if not np.array_equal(np.isfinite(g), fin) or not np.allclose(
                g[fin], w[fin], rtol=rtol, atol=atol):
            raise AssertionError(f"{label} {key}: {g} vs {w}")
        if fin.any():
            worst = max(worst, float(np.abs(g[fin] - w[fin]).max()))
    return worst


def _stream_cells(sess) -> tuple:
    """``(i, j, {"d", "d_prime", "r2"})`` of every record of one stream of
    ``sess``: the 0-based sites (VCF POS - 1) and exact values."""
    parts = [r for _b, r in sess.stream()]
    ia = np.concatenate([r.pos_a for r in parts]) - 1
    ib = np.concatenate([r.pos_b for r in parts]) - 1
    return ia, ib, {f: np.concatenate([getattr(r, f) for r in parts])
                    for f in ("d", "d_prime", "r2")}


def _hold_matrices(mats: dict, cells: tuple, dtype: str, how: str) -> None:
    """Assert ``mats`` keep exactly the pairs of ``cells`` and hold their
    values: float32 exactly, float16 within 2^-10 relative (or its
    subnormal step)."""
    ia, ib, want = cells
    keep = mats["keep"]
    if int(keep.sum()) != len(ia) or not keep[ia, ib].all():
        raise AssertionError(f"{how} {dtype}: keep has {int(keep.sum())} "
                             f"pairs vs {len(ia)} records")
    for f, w in want.items():
        g = mats[f][ia, ib].astype(np.float32)
        if dtype == "float32":
            ok = np.array_equal(g, w, equal_nan=True)
        else:
            fin = np.isfinite(w)
            ok = np.array_equal(np.isfinite(g), fin) and bool(np.all(
                np.abs(g[fin] - w[fin])
                <= 2.0 ** -10 * np.abs(w[fin]) + 2.0 ** -24))
        if not ok or mats[f].dtype != np.dtype(dtype):
            raise AssertionError(f"{how} {dtype}: {f} differs from the "
                                 "stream's records")


def _hold_cli_modes(vcf: Path, sess) -> None:
    """The CLI's ``--r2-hist``, ``--ld-decay``, ``--top`` and
    ``--prune-r2`` on ``vcf``, each held against the method of ``sess``,
    the session the CLI builds for that input: equal counts, positions
    and bins, decay sums within rtol 1e-5, and for the top pairs the same
    r2 multiset and the same rows above the k-th value."""
    import io

    from weightedld_tpu_torch.io.writer import write_pairs

    def need(counts, flag):
        if not counts.get("ld_majmin_planes"):
            raise AssertionError(f"{flag} never launched ld_majmin_planes")

    t0 = time.monotonic()
    base = ["--file", str(vcf)]
    got, counts = _json_run(base + ["--r2-hist", HIST_EDGES])
    need(counts, "--r2-hist")
    if got["n_pairs"] != sess.r2_histogram(HIST_EDGES.split(","))["n_pairs"]:
        raise AssertionError(f"--r2-hist {got} differs from r2_histogram")
    got, counts = _json_run(base + ["--ld-decay", DECAY_EDGES])
    need(counts, "--ld-decay")
    want = sess.ld_decay(DECAY_EDGES.split(","))
    for key in ("n_pairs", "n_d_prime_finite"):
        if got[key] != want[key]:
            raise AssertionError(f"--ld-decay {key}: {got[key]} vs "
                                 f"{want[key]}")
    for key in ("r2_sum", "abs_d_prime_sum"):
        if not np.allclose(got[key], want[key], rtol=1e-5, atol=0):
            raise AssertionError(f"--ld-decay {key}: {got[key]} vs "
                                 f"{want[key]}")
    out = vcf.with_suffix(".top.tsv")
    need(_drive(base + ["--engine", "tiled", "--top", str(TOP_K),
                        "--pair-output", str(out)]), "--top")
    buf = io.StringIO()
    write_pairs(sess.top_pairs(TOP_K), buf)
    rows = {name: text.splitlines()[1:] for name, text in
            (("cli", out.read_text()), ("method", buf.getvalue()))}
    r2 = {k: sorted(float(x.rsplit("\t", 1)[1]) for x in v)
          for k, v in rows.items()}
    above = {k: {x for x in v if float(x.rsplit("\t", 1)[1]) > r2[k][0]}
             for k, v in rows.items()}
    if r2["cli"] != r2["method"] or above["cli"] != above["method"]:
        raise AssertionError("--top differs from top_pairs")
    out = vcf.with_suffix(".prune.txt")
    need(_drive(base + ["--prune-r2", "0.1", "--pair-output", str(out)]),
         "--prune-r2")
    kept = [int(x) for x in out.read_text().split()]
    if kept != sess.prune(0.1).tolist():
        raise AssertionError("--prune-r2 0.1 differs from prune(0.1)")
    log(f"[analytics] CLI --r2-hist, --ld-decay, --top {TOP_K}, --prune-r2 "
        f"0.1 on {vcf.name}: each equal to the session's method "
        f"({time.monotonic() - t0:.2f}s)")


def phase_analytics(tmp: Path) -> tuple[dict, dict]:
    """The analytics methods of one session on the prepared headline, each
    held against the records of the ``main`` phase; the matrix export and
    the CLI's analytics modes on slices, against the session's methods;
    then the lo_int8 weight mode through the headline CLI and the codes
    entry, and one batch of each lo_int8 factorized session, kernel against
    plain.  Returns the main-path launch counts of the lo_int8 factorized
    entries and the max abs errors of the batch checks."""
    from weightedld_tpu_torch.pipeline import prepare
    from weightedld_tpu_torch.runtime.driver import (DriverConfig, LdSession,
                                                     run_to_tsv)

    vcf, head_tsv = tmp / "headline.vcf", tmp / "headline.tsv"
    if not head_tsv.exists():
        raise RuntimeError("the analytics phase reads the main phase's "
                           "output: run it with the main phase")
    rec = read_records(head_tsv)                    # r2 > 0.1, 4 dp
    with np.load(tmp / "headline_prepared.npz") as f:   # the main phase's
        prep = (f["alignment"], f["weights"], f["site_map"])

    def need(counts, name, label):
        if not counts.get(name):
            raise AssertionError(f"{label} never launched {name}: {counts}")

    def timed(label, fn, *args):
        t0 = time.monotonic()
        out, counts = _counted(fn, *args)
        need(counts, "ld_majmin_planes", label)
        return out, f"{time.monotonic() - t0:.3f}s"

    sess = LdSession(*prep, DriverConfig(r2_threshold=0.1), device="cuda")
    summ, dt = timed("summarize", sess.summarize)
    if summ["n_over_threshold"] != len(rec):
        raise AssertionError(f"summarize: {summ['n_over_threshold']} over "
                             f"0.1 vs {len(rec)} records")
    n_pairs = summ["n_pairs"]
    log(f"[analytics] summarize: {summ} ({dt}); n_over_threshold == the "
        f"{len(rec)} records")

    hist, dt = timed("r2_histogram", sess.r2_histogram,
                     HIST_EDGES.split(","))
    if sum(hist["n_pairs"]) != n_pairs or sum(hist["n_pairs"][1:]) \
            < len(rec):
        raise AssertionError(f"r2_histogram: {hist['n_pairs']} vs n_pairs "
                             f"{n_pairs}, {len(rec)} records over 0.1")
    log(f"[analytics] r2_histogram: {hist['n_pairs']} sum to n_pairs ({dt})")

    decay, dt = timed("ld_decay", sess.ld_decay, DECAY_EDGES.split(","))
    if sum(decay["n_pairs"]) != n_pairs:
        raise AssertionError(f"ld_decay: {decay['n_pairs']} do not sum to "
                             f"n_pairs {n_pairs}")
    log(f"[analytics] ld_decay: n_pairs {decay['n_pairs']} sum to n_pairs, "
        f"r2_mean {decay['r2_mean']} ({dt})")

    top, dt = timed("top_pairs", sess.top_pairs, TOP_K)
    keys = set(zip(top.pos_a.tolist(), top.pos_b.tolist()))
    last = round(float(top.r2.min()), 4)            # the records' 4 dp
    outside = max(v[2] for k, v in rec.items() if k not in keys)
    if len(keys) != TOP_K or not keys <= set(rec) or outside > last:
        raise AssertionError(f"top_pairs({TOP_K}): {len(keys)} pairs, last "
                             f"r2 {last}, max r2 outside {outside}")
    log(f"[analytics] top_pairs({TOP_K}): every other record's r2 <= {last} "
        f"(max {outside}) ({dt})")

    kept, dt = timed("prune", sess.prune, 0.1)
    kept = set(kept.tolist())
    bad = [k for k in rec if k[0] in kept and k[1] in kept]
    if bad or len(kept) >= S_HEAD:
        raise AssertionError(f"prune(0.1): {len(bad)} records join kept "
                             f"sites, e.g. {bad[:3]}; {len(kept)} kept")
    log(f"[analytics] prune(0.1): {len(kept)} of {S_HEAD} sites kept, no "
        f"record joins two ({dt})")
    del sess

    # Matrices of an S = 8,192 slice from the session's method, float32
    # and float16, against the records of a stream; the CLI's other modes
    # on that slice (about 1 s of ingest each) against the same session's
    # methods; then the CLI's --matrix-output on a 2,048-site slice (its
    # .npz written compressed, as the JAX CLI writes it) against the
    # session method.
    aln = np.load(tmp / "headline_aln.npy")
    sl = tmp / "matrix_slice.vcf"
    write_vcf(sl, aln[:, :MATRIX_SITES])
    res = prepare(sl)
    sess = LdSession(res.alignment, res.weights, res.site_map,
                     DriverConfig(), device="cuda")
    cells = _stream_cells(sess)
    for dtype in ("float32", "float16"):
        mats, dt = timed("LdSession.matrices", sess.matrices,
                         np.dtype(dtype))
        _hold_matrices(mats, cells, dtype, "LdSession.matrices")
        log(f"[analytics] LdSession.matrices {dtype} (S={MATRIX_SITES}): "
            f"keep and the {len(cells[0])} kept cells equal the stream's "
            f"records ({dt})")
        del mats
    del cells
    _hold_cli_modes(sl, sess)
    del sess
    sl = tmp / "matrix_cli_slice.vcf"
    write_vcf(sl, aln[:, :MATRIX_CLI_SITES])
    res = prepare(sl)
    want = LdSession(res.alignment, res.weights, res.site_map,
                     DriverConfig(), device="cuda").matrices(np.float16)
    npz = tmp / "matrices_float16.npz"
    counts = _drive(["--file", str(sl), "--matrix-output", str(npz),
                     "--matrix-dtype", "float16"])
    need(counts, "ld_majmin_planes", "--matrix-output")
    with np.load(npz) as f:
        got = dict(f)
    for key, w in want.items():
        if got[key].dtype != w.dtype or not np.array_equal(
                got[key], w, equal_nan=True):
            raise AssertionError(f"--matrix-output float16: {key} differs "
                                 "from LdSession.matrices")
    log(f"[analytics] --matrix-output float16 (S={MATRIX_CLI_SITES}): equal "
        f"to LdSession.matrices(float16) of the same input")

    # lo_int8: the CLI's --stats-only (the preplaned entry) and the codes
    # entry, held to int8x3; then one batch of each lo_int8 session.
    t0 = time.monotonic()
    summ_lo, counts = _json_run(["--file", str(vcf), "--stats-only",
                                 "--r2-threshold", "0.1", "--weight-quant",
                                 "lo_int8"])
    need(counts, "ld_majmin_planes_lo_int8", "--weight-quant lo_int8")
    launches = {"ld_majmin_planes_lo_int8":
                counts["ld_majmin_planes_lo_int8"]}
    if summ_lo["n_over_threshold"] != len(rec) \
            or summ_lo["n_pairs"] != n_pairs:
        raise AssertionError(f"lo_int8 --stats-only: {summ_lo} vs int8x3 "
                             f"{summ}")
    log(f"[analytics] --stats-only --weight-quant lo_int8: {summ_lo}; "
        f"counts equal int8x3's; launches {counts} "
        f"({time.monotonic() - t0:.2f}s)")
    outs = {}
    for wq in ("none", "lo_int8"):
        outs[wq] = tmp / f"headline_codes_{wq}.tsv"
        _n, counts = _counted(
            run_to_tsv, *prep, outs[wq],
            DriverConfig(r2_threshold=0.1, preplaned="off", weight_quant=wq),
            device="cuda", ndigits=8)
    need(counts, "ld_majmin_codes_lo_int8", "run_to_tsv lo_int8")
    launches["ld_majmin_codes_lo_int8"] = counts["ld_majmin_codes_lo_int8"]
    lo_rec = read_records(outs["lo_int8"])
    seeds = np.load(tmp / "headline_seeds.npy")
    missing = planted_pairs(seeds, offset=1) - set(lo_rec)
    if missing:
        raise AssertionError(f"lo_int8: {len(missing)} planted pairs missing")
    worst = _hold_records(lo_rec, read_records(outs["none"]),
                          "lo_int8 vs int8x3 (codes entry)")
    log(f"[analytics] lo_int8 codes entry: {len(lo_rec)} records, every "
        f"planted pair, within rtol 2e-5 / atol 1e-6 of int8x3 (max abs "
        f"diff {worst}); launches {counts}")
    err = {}
    for name, pp in (("ld_majmin_planes_lo_int8", "auto"),
                     ("ld_majmin_codes_lo_int8", "off")):
        sess = LdSession(*prep, DriverConfig(r2_threshold=0.1, preplaned=pp,
                                             weight_quant="lo_int8"),
                         device="cuda")
        got, err[name] = check_session_batch(sess, f"headline {name}")
        if got != name:
            raise AssertionError(f"headline lo_int8 preplaned={pp} ran {got}")
        del sess

    # split_bf16, and the Henikoff weights rounded to bf16 (the bf16-exact
    # mode), on the prepared headline through both entries: summarize held
    # to int8x3's counts, then one full batch, kernel against plain.
    import torch

    w_bf16 = torch.from_numpy(prep[1]).to(torch.bfloat16).float().numpy()
    for wq, w, mode in (("split_bf16", prep[1], "split_bf16"),
                        ("none", w_bf16, "exact")):
        for pp, entry in (("on", "ld_majmin_planes"),
                          ("off", "ld_majmin_codes")):
            name = _variant(entry, mode)
            t0 = time.monotonic()
            sess = LdSession(prep[0], w, prep[2], DriverConfig(
                r2_threshold=0.1, preplaned=pp, weight_quant=wq),
                device="cuda")
            torch.cuda.synchronize()
            t1 = time.monotonic()
            summ_f, counts = _counted(sess.summarize)
            t_summ = time.monotonic() - t1
            need(counts, name, f"{mode} preplaned={pp} summarize")
            launches[name] = counts[name]
            if summ_f["n_over_threshold"] != len(rec) \
                    or summ_f["n_pairs"] != n_pairs:
                raise AssertionError(f"{mode} preplaned={pp}: {summ_f} vs "
                                     f"int8x3 {summ}")
            got, err[name] = check_session_batch(sess, f"headline {name}")
            if got != name:
                raise AssertionError(f"headline {mode} preplaned={pp} ran "
                                     f"{got}")
            log(f"[analytics] {mode} preplaned={pp} summarize: "
                f"n_over_threshold {summ_f['n_over_threshold']} == int8x3's;"
                f" launches {counts}; the session's first summarize "
                f"{t_summ:.3f}s ({time.monotonic() - t0:.2f}s with set-up "
                f"and the batch check)")
            del sess
    return launches, err


def ambiguous_alignment(rng, n_seqs, n_sites, n_groups, n_dirty):
    """Codes over A C G T - at 22 / 22 / 22 / 22 / 12 % (near-balanced
    counts, so small count margins), ``n_groups`` planted triplets (a seed
    column over A C G T at 45 / 35 / 8 / 6 % in a random order and - at
    6 %, so that its major and dominant minor are clear, plus two copies
    with 2 % of cells redrawn), then 1-2 UNKNOWN cells at ``n_dirty``
    columns, a quarter of them members of planted triplets.  Returns
    ``(codes, triplets, dirty columns)``."""
    r = rng.random((n_seqs, n_sites))
    aln = np.searchsorted(np.array([0.22, 0.44, 0.66, 0.88]), r,
                          side="right").astype(np.int8)
    trips = rng.choice(n_sites, size=(n_groups, 3), replace=False)
    skew = np.array([0.45, 0.80, 0.88, 0.94])
    for s0, s1, s2 in trips:
        order = np.append(rng.permutation(4), 4).astype(np.int8)
        aln[:, s0] = order[np.searchsorted(skew, rng.random(n_seqs),
                                           side="right")]
        for dst in (s1, s2):
            col = aln[:, s0].copy()
            mut = rng.random(n_seqs) < 0.02
            col[mut] = rng.integers(0, 5, size=int(mut.sum()))
            aln[:, dst] = col
    planted = trips.reshape(-1)
    others = np.setdiff1d(np.arange(n_sites), planted)
    dirty = np.concatenate([
        rng.choice(planted, n_dirty // 4, replace=False),
        rng.choice(others, n_dirty - n_dirty // 4, replace=False)])
    for s in dirty:
        aln[rng.choice(n_seqs, size=rng.integers(1, 3), replace=False), s] = 5
    return aln, trips, dirty


def write_fasta_codes(path: Path, aln: np.ndarray, rng) -> None:
    """FASTA text of ``aln``: codes 0..4 as A C G T -, UNKNOWN as one of
    N R Y."""
    lut = np.frombuffer(b"ACGT-N", np.uint8)
    ch = lut[aln]
    unk = aln == 5
    ch[unk] = np.frombuffer(b"NRY", np.uint8)[
        rng.integers(0, 3, size=int(unk.sum()))]
    with open(path, "wb") as fh:
        for i, row in enumerate(ch):
            fh.write(b">s%d\n" % i)
            fh.write(row.tobytes())
            fh.write(b"\n")


def read_records(path: Path) -> dict:
    """``{(pos_a, pos_b): (d, d', r2)}`` of a pair TSV."""
    out = {}
    with open(path) as fh:
        next(fh)
        for line in fh:
            a, b, d, dp, r2 = line.split("\t")
            out[(int(a), int(b))] = (float(d), float(dp), float(r2))
    return out


def planted_pairs(trips, offset: int = 0) -> set:
    """The site pairs of planted triplets, at positions index + offset."""
    out = set()
    for trip in trips:
        a, b, c = sorted(int(x) + offset for x in trip)
        out |= {(a, b), (a, c), (b, c)}
    return out


def ambiguous_fasta(tmp: Path, tag: str = "ambiguous"):
    """The ``ambiguous`` FASTA (1,024 x 16,384, seed 2026), written into
    ``tmp`` unless it is there: ``(path, codes, triplets, dirty
    columns)``."""
    rng = np.random.default_rng(2026)
    t0 = time.monotonic()
    aln, trips, dirty = ambiguous_alignment(rng, N_AMB, S_AMB, N_AMB_GROUPS,
                                            N_DIRTY)
    fasta = tmp / "ambiguous.fasta"
    if not fasta.exists():
        write_fasta_codes(fasta, aln, rng)
        log(f"[{tag}] synthetic FASTA {N_AMB} x {S_AMB}, {len(dirty)} "
            f"ambiguous columns, {len(trips)} planted triplets: "
            f"{fasta.stat().st_size / 1e6:.1f} MB in "
            f"{time.monotonic() - t0:.1f}s")
    return fasta, aln, trips, dirty


def phase_ambiguous(tmp: Path) -> tuple[dict, dict]:
    """The ambiguity-code path at full size; returns the main-path launch
    counts of the general entries and the max abs errors of the batch
    checks."""
    from weightedld_tpu_torch.pipeline import prepare
    from weightedld_tpu_torch.runtime.driver import (DriverConfig, LdSession,
                                                     run_to_tsv)
    from weightedld_tpu_torch.runtime.profiling import StageTimer

    fasta, aln, trips, dirty = ambiguous_fasta(tmp)
    planted = planted_pairs(trips)
    launches, err = {}, {}

    # (1) The CLI: the hybrid session.
    out1 = tmp / "ambiguous.tsv"
    timer = StageTimer()
    t0 = time.monotonic()
    counts = _drive(["--file", str(fasta), "--r2-threshold", "0.1",
                     "--ndigits", "8", "--pair-output", str(out1)],
                    timer=timer)
    wall = time.monotonic() - t0
    log(f"[ambiguous] (1) CLI kernel launches: {counts}; wall {wall:.3f}s")
    for name, sec in timer.spans.items():
        log(f"[ambiguous] stage {name:<12} {sec:.3f}s")
    if counts["ld_general"] == 0 or not (counts["ld_majmin_planes"]
                                         or counts["ld_majmin_codes"]):
        raise AssertionError("the ambiguous CLI run did not launch both "
                             "ld_general and a factorized entry")
    rec1 = read_records(out1)
    missing = planted - set(rec1)
    if missing:
        raise AssertionError(f"{len(missing)} of {len(planted)} planted "
                             f"pairs missing, e.g. {sorted(missing)[:5]}")
    n_pairs = S_AMB * (S_AMB - 1) // 2
    log(f"[ambiguous] (1) {len(rec1)} records, all {len(planted)} planted "
        f"pairs present; {n_pairs / timer.spans['scan+write']:.4g} pairs/s "
        f"over scan+write")
    launches["ld_general"] = counts["ld_general"]

    res = prepare(fasta)
    s_kept = res.alignment.shape[1]
    log(f"[ambiguous] post-mask S = {s_kept}")
    if s_kept != S_AMB:
        raise AssertionError(f"post-mask S {s_kept} != {S_AMB}")
    hyb = LdSession(res.alignment, res.weights, res.site_map,
                    DriverConfig(r2_threshold=0.1), device="cuda")
    tiles = hyb.phase_tiles
    log(f"[ambiguous] hybrid split: {tiles['majmin']} safe (factorized) and "
        f"{tiles['general']} unsafe (general) tile pairs of "
        f"{hyb.plan.n_tiles}; packed={hyb.site_perm is not None}; "
        f"batches={hyb.n_batches} {hyb.cfg}")
    if not tiles["majmin"] or not tiles["general"] or hyb.site_perm is None:
        raise AssertionError("the ambiguous input did not pack and split")
    # Both phases must emit records: planted pairs through ambiguous
    # columns lie in the packed dirty tiles.
    dirty_pairs = {p for p in planted if set(p) & set(dirty.tolist())}
    log(f"[ambiguous] {len(dirty_pairs)} planted pairs touch ambiguous "
        f"columns")
    name, err["ld_general"] = check_session_batch(
        hyb, "ambiguous hybrid, general phase", b=hyb.n_batches - 1)
    if name != "ld_general":
        raise AssertionError(f"the hybrid session's last batch ran {name}")
    del hyb

    # (2) The general kernel over the whole triangle, codes and preplaned.
    out2 = tmp / "ambiguous_general.tsv"
    _n, counts = _counted(
        run_to_tsv, res.alignment, res.weights, res.site_map, out2,
        DriverConfig(kernel="general", r2_threshold=0.1), device="cuda",
        ndigits=8)
    log(f"[ambiguous] (2) kernel='general' launches: {counts}")
    if counts["ld_general"] == 0 or sum(counts.values()) != \
            counts["ld_general"]:
        raise AssertionError("kernel='general' must launch ld_general only")
    rec2 = read_records(out2)
    if set(rec2) != set(rec1):
        raise AssertionError(f"record sets differ: {len(rec1)} hybrid vs "
                             f"{len(rec2)} general")
    worst = 0.0
    for key, want in rec2.items():
        got = np.asarray(rec1[key])
        want = np.asarray(want)
        fin = np.isfinite(want)
        if not np.array_equal(np.isfinite(got), fin) or not np.allclose(
                got[fin], want[fin], rtol=2e-5, atol=1e-6):
            raise AssertionError(f"{key}: hybrid {got} vs general {want}")
        if fin.any():
            worst = max(worst, float(np.abs(got[fin] - want[fin]).max()))
    log(f"[ambiguous] (2) record set equal to (1), values within rtol 2e-5 "
        f"/ atol 1e-6 (max |hybrid - general| {worst})")
    out2p = tmp / "ambiguous_general_planes.tsv"
    _n, counts = _counted(
        run_to_tsv, res.alignment, res.weights, res.site_map, out2p,
        DriverConfig(kernel="general", preplaned="on", r2_threshold=0.1),
        device="cuda", ndigits=8)
    log(f"[ambiguous] (2) kernel='general' preplaned='on' launches: {counts}")
    if counts["ld_general_planes"] == 0 or sum(counts.values()) != \
            counts["ld_general_planes"]:
        raise AssertionError("preplaned general must launch "
                             "ld_general_planes only")
    if out2p.read_bytes() != out2.read_bytes():
        raise AssertionError("the preplaned general TSV differs")
    log("[ambiguous] (2) preplaned general TSV byte-identical")
    launches["ld_general_planes"] = counts["ld_general_planes"]

    # (2b) lo_int8: the CLI (the hybrid's general phase on ld_general) and
    # kernel="general" on the preplaned entry, each held to its int8x3 twin.
    out_lo = tmp / "ambiguous_lo.tsv"
    counts = _drive(["--file", str(fasta), "--r2-threshold", "0.1",
                     "--ndigits", "8", "--weight-quant", "lo_int8",
                     "--pair-output", str(out_lo)])
    out_lo2 = tmp / "ambiguous_general_planes_lo.tsv"
    _n, counts2 = _counted(
        run_to_tsv, res.alignment, res.weights, res.site_map, out_lo2,
        DriverConfig(kernel="general", preplaned="on", r2_threshold=0.1,
                     weight_quant="lo_int8"), device="cuda", ndigits=8)
    log(f"[ambiguous] (2b) lo_int8 CLI launches: {counts}; kernel='general' "
        f"preplaned='on' lo_int8 launches: {counts2}")
    if not counts["ld_general_lo_int8"] \
            or not counts2["ld_general_planes_lo_int8"]:
        raise AssertionError("the lo_int8 runs did not launch "
                             "ld_general_lo_int8 / ld_general_planes_lo_int8")
    launches["ld_general_lo_int8"] = counts["ld_general_lo_int8"]
    launches["ld_general_planes_lo_int8"] = \
        counts2["ld_general_planes_lo_int8"]
    for out, want, label in ((out_lo, rec1, "hybrid"),
                             (out_lo2, rec2, "general preplaned")):
        got = read_records(out)
        missing = planted - set(got)
        if missing:
            raise AssertionError(f"lo_int8 {label}: {len(missing)} planted "
                                 "pairs missing")
        worst = _hold_records(got, want, f"lo_int8 {label} vs int8x3")
        log(f"[ambiguous] (2b) lo_int8 {label}: {len(got)} records, every "
            f"planted pair, within rtol 2e-5 / atol 1e-6 of int8x3 (max abs "
            f"diff {worst})")

    # (2c) split_bf16, and the weights rounded to bf16 (bf16-exact), through
    # kernel="general" on both entries: only the mode's general entry runs,
    # every planted pair is present, and one batch of each session holds to
    # the plain version.
    import torch

    w_bf16 = torch.from_numpy(res.weights).to(torch.bfloat16).float().numpy()
    for wq, w, mode in (("split_bf16", res.weights, "split_bf16"),
                        ("none", w_bf16, "exact")):
        for pp, entry in (("off", "ld_general"), ("on", "ld_general_planes")):
            name = _variant(entry, mode)
            out = tmp / f"ambiguous_general_{mode}_{pp}.tsv"
            cfg = DriverConfig(kernel="general", preplaned=pp,
                               r2_threshold=0.1, weight_quant=wq)
            _n, counts = _counted(run_to_tsv, res.alignment, w, res.site_map,
                                  out, cfg, device="cuda", ndigits=8)
            if not counts[name] or sum(counts.values()) != counts[name]:
                raise AssertionError(f"kernel='general' {mode} preplaned={pp}"
                                     f" must launch {name} only: {counts}")
            launches[name] = counts[name]
            missing = planted - set(read_pairs(out))
            if missing:
                raise AssertionError(f"{name}: {len(missing)} planted pairs "
                                     "missing")
            sess = LdSession(res.alignment, w, res.site_map, cfg,
                             device="cuda")
            got, err[name] = check_session_batch(
                sess, f"ambiguous general {mode} preplaned={pp}")
            if got != name:
                raise AssertionError(f"ambiguous {mode} preplaned={pp} ran "
                                     f"{got}")
            log(f"[ambiguous] (2c) {name}: launches {counts}, every planted "
                f"pair present")
            del sess

    # (3) The CLI with --unweighted.
    out3 = tmp / "ambiguous_unweighted.tsv"
    counts = _drive(["--file", str(fasta), "--r2-threshold", "0.1",
                     "--unweighted", "--pair-output", str(out3)])
    log(f"[ambiguous] (3) --unweighted launches: {counts}")
    if counts["ld_general_unit"] == 0:
        raise AssertionError("the --unweighted run never launched "
                             "ld_general_unit")
    missing = planted - set(read_pairs(out3))
    if missing:
        raise AssertionError(f"--unweighted: {len(missing)} planted pairs "
                             "missing")
    launches["ld_general_unit"] = counts["ld_general_unit"]

    # (4) CPU vs card on the first AMB_SLICE columns.
    sl = tmp / "ambiguous_slice.fasta"
    write_fasta_codes(sl, aln[:, :AMB_SLICE], np.random.default_rng(7))
    for uw in (False, True):
        outs, counts = {}, {}
        for device in ("cpu", "cuda"):
            out = tmp / f"ambiguous_slice_{device}_{uw}.tsv"
            t0 = time.monotonic()
            counts[device] = _drive(
                ["--file", str(sl), "--device", device, "--engine", "tiled",
                 "--tile", "256", "--seq-chunk", "256", "--r2-threshold",
                 "0.03", "--pair-output", str(out)]
                + (["--unweighted"] if uw else []))
            outs[device] = out.read_bytes()
            log(f"[ambiguous] (4) unweighted={uw} {device}: "
                f"{outs[device].count(b'\n') - 1} records in "
                f"{time.monotonic() - t0:.2f}s, launches {counts[device]}")
        general = "ld_general_unit" if uw else "ld_general"
        if any(counts["cpu"].values()):
            raise AssertionError(f"the CPU run launched kernels: "
                                 f"{counts['cpu']}")
        if counts["cuda"][general] == 0:
            raise AssertionError(f"the card run never launched {general}")
        if outs["cpu"] != outs["cuda"]:
            raise AssertionError(f"unweighted={uw}: CPU and CUDA TSVs differ")
        log(f"[ambiguous] (4) unweighted={uw}: TSVs byte-identical "
            f"({len(outs['cuda'])} bytes)")

    # (5) Batch 0 of the kernel="general" session and of its unit twin;
    # the general batch of the lo_int8 CLI's hybrid session and batch 0 of
    # the preplaned kernel="general" lo_int8 session.
    for w, cfg, b, label in (
            (res.weights, dict(kernel="general"), 0, "general weighted"),
            (np.ones_like(res.weights), dict(kernel="general"), 0,
             "general unit"),
            (res.weights, dict(weight_quant="lo_int8"), -1,
             "hybrid lo_int8, general phase"),
            (res.weights, dict(kernel="general", preplaned="on",
                               weight_quant="lo_int8"), 0,
             "general preplaned lo_int8")):
        sess = LdSession(res.alignment, w, res.site_map,
                         DriverConfig(r2_threshold=0.1, **cfg), device="cuda")
        name, e = check_session_batch(sess, f"ambiguous {label}",
                                      b=b % sess.n_batches)
        if "lo_int8" in label and not name.endswith("_lo_int8"):
            raise AssertionError(f"ambiguous {label} ran {name}")
        err[name] = max(err.get(name, 0.0), e)
        del sess
    return launches, err


# ---------------------------------------------------------------------------
# Phase 7: ingest (native reader, streaming sessions, device Henikoff)
# ---------------------------------------------------------------------------


def _native_status() -> bool:
    """Whether the native io library loaded.  Where it cannot be built
    because the host lacks zlib's header, say so on a line of its own and
    go on with the Python readers; any other failure raises."""
    from weightedld_tpu_torch.io import native

    if native.available():
        log(f"[ingest] native io library loaded: "
            f"{native.library_path().name}")
        return True
    err = native.build_error() or "WLD_NATIVE_IO=0 in the environment"
    lines = err.splitlines() or [err]
    first = next((ln for ln in lines if "error" in ln), lines[0])
    if "zlib.h" not in err:
        raise AssertionError(f"native io library unavailable: {err}")
    log(f"native_io unavailable: {first}")
    return False


def _stage_log(label: str, timer, wall: float, tag: str = "ingest") -> None:
    for name, sec in timer.spans.items():
        log(f"[{tag}] {label}: stage {name:<12} {sec:.3f}s")
    log(f"[{tag}] {label}: cli wall {wall:.3f}s | host cores "
        f"{os.cpu_count()} | {card_line()}")


def _timed_cli(label: str, argv: list[str], python_io: bool = False):
    """One CLI run with its stage times: ``(launch counts, wall)``;
    ``python_io`` forces the Python readers and formatter."""
    from weightedld_tpu_torch.runtime.profiling import StageTimer

    old = os.environ.get("WLD_NATIVE_IO")
    if python_io:
        os.environ["WLD_NATIVE_IO"] = "0"
    try:
        timer = StageTimer()
        t0 = time.monotonic()
        counts = _drive(argv, timer=timer)
        wall = time.monotonic() - t0
    finally:
        if python_io:
            if old is None:
                os.environ.pop("WLD_NATIVE_IO")
            else:
                os.environ["WLD_NATIVE_IO"] = old
    _stage_log(label, timer, wall)
    log(f"[ingest] {label}: kernel launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return counts, wall


def _time_sync(fn, reps: int = 3) -> list[float]:
    """Seconds of each of ``reps`` calls of ``fn``, the card synchronized
    around each."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        out.append(time.monotonic() - t0)
    return out


def phase_ingest(tmp: Path) -> None:
    """The ingest front: native against Python readers, the headline CLI
    with each reader and with ``--stream-ingest``, a streamed f32 session,
    the ambiguous FASTA streamed, and the 1000 Genomes-sized cohort."""
    import torch

    import weightedld_tpu_torch.pipeline as pipe
    from weightedld_tpu_torch.core.henikoff import (
        henikoff_weights_host_site_major, henikoff_weights_large,
        henikoff_weights_site_major)
    from weightedld_tpu_torch.io import native
    from weightedld_tpu_torch.io.vcf import read_vcf_python
    from weightedld_tpu_torch.ops.cuda_ld import pad_alignment_site_major
    from weightedld_tpu_torch.runtime.driver import DriverConfig
    from weightedld_tpu_torch.runtime.ingest import session_from_vcf

    lib_ok = _native_status()
    vcf, _aln, seeds = headline_vcf(tmp, "ingest")
    planted = planted_pairs(seeds, offset=1)

    # Readers on the headline VCF.
    t0 = time.monotonic()
    aln_py, pos_py = read_vcf_python(vcf)
    t_py = time.monotonic() - t0
    msg = f"python reader {t_py:.3f}s"
    if lib_ok:
        t0 = time.monotonic()
        aln_n, pos_n = native.read_vcf_native(vcf)
        t_n = time.monotonic() - t0
        if not (np.array_equal(aln_n, aln_py)
                and np.array_equal(pos_n, pos_py)):
            raise AssertionError("native and Python VCF readers differ")
        msg += f", native reader {t_n:.3f}s ({t_py / t_n:.2f}x), equal arrays"
    log(f"[ingest] headline {vcf.stat().st_size / 1e6:.1f} MB VCF: {msg} | "
        f"host cores {os.cpu_count()}")

    # The headline CLI with each reader and streamed.
    argv = ["--file", str(vcf), "--r2-threshold", "0.1"]
    outs = {}
    for label, extra, py in (("python reader", [], True),
                             ("native reader", [], False),
                             ("--stream-ingest", ["--stream-ingest"], False)):
        out = tmp / f"ingest_{len(outs)}.tsv"
        counts, _wall = _timed_cli(f"headline {label}",
                                   argv + extra + ["--pair-output", str(out)],
                                   python_io=py)
        if not counts["ld_majmin_planes"]:
            raise AssertionError(f"headline {label} never launched "
                                 "ld_majmin_planes")
        outs[label] = out.read_bytes()
    if len(set(outs.values())) != 1:
        raise AssertionError(f"headline TSVs differ between "
                             f"{list(outs)}")
    got = set(read_pairs(tmp / "ingest_0.tsv"))
    if planted - got:
        raise AssertionError("headline planted pairs missing")
    log(f"[ingest] headline TSVs byte-identical across {list(outs)} "
        f"({len(outs['native reader'])} bytes, all {len(planted)} planted "
        f"pairs)")

    # A streamed session with f32 Henikoff weights on the card.
    host_w = pipe.prepare(vcf).weights
    t0 = time.monotonic()
    sess = session_from_vcf(vcf, DriverConfig(r2_threshold=0.1),
                            device="cuda", weight_precision="f32")
    t_sess = time.monotonic() - t0
    rel = float(np.max(np.abs(sess.weights - host_w) / np.abs(host_w)))
    if not np.allclose(sess.weights, host_w, rtol=1e-6, atol=0.0):
        raise AssertionError(f"f32 session weights off the host f64 "
                             f"weights: max rel err {rel:.3g}")
    recs, counts = _counted(lambda: [r for _b, r in sess.stream()])
    pairs = {(int(a), int(b)) for r in recs
             for a, b in zip(r.pos_a, r.pos_b)}
    if not counts["ld_majmin_planes"] or planted - pairs:
        raise AssertionError(f"f32 session: launches {counts}, "
                             f"{len(planted - pairs)} planted pairs missing")
    log(f"[ingest] session_from_vcf(weight_precision='f32'): built in "
        f"{t_sess:.3f}s (two streaming passes, device Henikoff, upload), "
        f"weights max rel err {rel:.3g} vs host f64 (rtol 1e-6), "
        f"{len(pairs)} records, all planted pairs, ld_majmin_planes "
        f"x{counts['ld_majmin_planes']}")
    del sess
    codes = torch.from_numpy(pad_alignment_site_major(
        aln_py, 256, 1024)).cuda()
    t_hk = _time_sync(lambda: henikoff_weights_site_major(codes, N_HEAD))
    log(f"[ingest] henikoff_weights_site_major on the card, [{codes.shape[0]}"
        f", {codes.shape[1]}] int8: {[round(t, 6) for t in t_hk]} s | "
        f"{card_line()}")
    del codes, aln_py

    # The ambiguous FASTA: default run against --stream-ingest.
    fasta, _a, _t, _d = ambiguous_fasta(tmp, "ingest")
    argv = ["--file", str(fasta), "--r2-threshold", "0.1", "--ndigits", "8"]
    amb = {}
    for label, extra in (("default", []),
                         ("--stream-ingest", ["--stream-ingest"])):
        out = tmp / f"ingest_amb_{len(amb)}.tsv"
        counts, _wall = _timed_cli(f"ambiguous {label}",
                                   argv + extra + ["--pair-output", str(out)])
        if not counts["ld_general"]:
            raise AssertionError(f"ambiguous {label} never launched "
                                 "ld_general")
        amb[label] = out.read_bytes()
    if amb["default"] != amb["--stream-ingest"]:
        raise AssertionError("ambiguous --stream-ingest TSV differs from "
                             "the default run's")
    log(f"[ingest] ambiguous --stream-ingest TSV byte-identical to the "
        f"default run's ({len(amb['default'])} bytes)")

    # The 1000 Genomes-sized cohort through the default CLI.
    rng = np.random.default_rng(2504)
    t0 = time.monotonic()
    aln, seeds = loaded_alignment(rng, N_COHORT, S_COHORT, N_TRIPLETS)
    cvcf = tmp / "cohort.vcf"
    write_vcf(cvcf, aln)
    del aln
    log(f"[ingest] cohort VCF {N_COHORT} x {S_COHORT} "
        f"({N_COHORT * S_COHORT / 1e6:.1f}M cells): "
        f"{cvcf.stat().st_size / 1e6:.1f} MB in "
        f"{time.monotonic() - t0:.1f}s")
    seen = {}
    real = pipe.henikoff_weights_large

    def spy(alignment, **kw):
        seen["aln"] = alignment
        seen["w"] = real(alignment, **kw)
        return seen["w"]

    pipe.henikoff_weights_large = spy
    out = tmp / "cohort.tsv"
    try:
        counts, _wall = _timed_cli("cohort", [
            "--file", str(cvcf), "--r2-threshold", "0.1", "--pair-output",
            str(out)])
    finally:
        pipe.henikoff_weights_large = real
    if "w" not in seen or seen["w"].device.type != "cuda":
        raise AssertionError("the cohort was not weighted on the card")
    if not counts["ld_majmin_planes"]:
        raise AssertionError("the cohort never launched ld_majmin_planes")
    got = set(read_pairs(out))
    missing = planted_pairs(seeds, offset=1) - got
    if missing:
        raise AssertionError(f"cohort: {len(missing)} planted pairs "
                             f"missing, e.g. {sorted(missing)[:5]}")
    aln = seen.pop("aln")
    w32 = seen.pop("w").cpu().numpy()
    t0 = time.monotonic()
    sm = pad_alignment_site_major(aln, 256, 64)
    w64 = henikoff_weights_host_site_major(sm, S_COHORT, N_COHORT)
    t_host = time.monotonic() - t0
    del sm
    rel = float(np.max(np.abs(w32 - w64) / np.abs(w64)))
    if not np.allclose(w32, w64, rtol=1e-5, atol=0.0):
        raise AssertionError(f"cohort card weights off the host f64 "
                             f"weights: max rel err {rel:.3g}")
    t_large = _time_sync(lambda: henikoff_weights_large(aln, device="cuda"))
    log(f"[ingest] cohort: {len(got)} records, all planted pairs; card "
        f"weights max rel err {rel:.3g} vs henikoff_weights_host_site_major "
        f"(rtol 1e-5; host f64 {t_host:.3f}s); henikoff_weights_large on "
        f"the card ({-(-S_COHORT // 16384)} chunks of 16,384 sites, H2D "
        f"included) "
        f"{[round(t, 6) for t in t_large]} s | host cores {os.cpu_count()} "
        f"| {card_line()}")
    log(f"[ingest] summary: native io "
        f"{'loaded' if lib_ok else 'unavailable, Python readers throughout'}"
        f"; headline python == native == --stream-ingest TSVs; f32 session "
        f"and cohort weights within tolerance; ambiguous --stream-ingest == "
        f"default")


# ---------------------------------------------------------------------------
# Phase 8: windows (windowed, region-restricted and inter-region LD)
# ---------------------------------------------------------------------------


def window_positions(n_sites: int) -> np.ndarray:
    """POS of the windowed headline VCF: a seeded cumulative sum of
    geometric gaps with a mean of 200 bp (about 9.8 Mb over 49,152
    sites)."""
    gaps = np.random.default_rng(WIN_SEED).geometric(1 / WIN_GAP, n_sites)
    return np.cumsum(gaps).astype(np.int64)


def _tsv_rows(path: Path) -> tuple[str, list[str]]:
    lines = path.read_text().splitlines(keepends=True)
    return lines[0], lines[1:]


def _rows_within(rows: list[str], keep) -> list[str]:
    """The rows whose ``(pos_a, pos_b)`` pass ``keep``, in order."""
    out = []
    for ln in rows:
        a, b = ln.split("\t", 2)[:2]
        if keep(int(a), int(b)):
            out.append(ln)
    return out


def _win_log(msg: str) -> None:
    log(f"[windows] {msg}")


def _scan_rate(label: str, n_pairs: int, spans: dict, n_tiles: int,
               full_tiles: int | None = None) -> None:
    scan = spans.get("scan+write", spans.get("scan", float("nan")))
    tiles = f"plan {n_tiles} tiles" + (
        f" (full plan {full_tiles})" if full_tiles is not None else "")
    _win_log(f"{label}: {n_pairs} pairs kept in the pair set, "
             f"{n_pairs / scan:.4g} pairs/s over the scan "
             f"({scan:.3f}s); {tiles} | {card_line()}")


def _need(counts: dict, names: tuple, label: str) -> None:
    missing = [n for n in names if not counts.get(n)]
    if missing:
        raise AssertionError(f"{label} never launched {missing}: {counts}")


def _win_run(label: str, argv: list[str], json_out: bool = False):
    """One CLI run of the windows phase with its stage times and launches
    printed: ``(launch counts, stage spans, its JSON or None)``."""
    import contextlib
    import io

    from weightedld_tpu_torch.runtime.profiling import StageTimer

    timer = StageTimer()
    buf = io.StringIO()
    t0 = time.monotonic()
    with (contextlib.redirect_stdout(buf) if json_out
          else contextlib.nullcontext()):
        counts = _drive(argv, timer=timer)
    _stage_log(label, timer, time.monotonic() - t0, "windows")
    _win_log(f"{label}: kernel launches "
             f"{ {k: v for k, v in counts.items() if v} }")
    out = (json.loads(buf.getvalue().strip().splitlines()[-1])
           if json_out else None)
    return counts, dict(timer.spans), out


def _windowed_pairs(sess) -> int:
    """Kept pairs of a session's (windowed or cross) pair set."""
    return sess.summarize(r2_threshold=None)["n_pairs"]


def phase_windows(tmp: Path) -> dict:
    """Windowed, region-restricted and inter-region LD at the headline
    size; returns the max abs errors of the batch checks."""
    import contextlib
    import io

    import torch

    from weightedld_tpu_torch import cli
    from weightedld_tpu_torch.core.henikoff import henikoff_weights_host
    from weightedld_tpu_torch.io.writer import pair_header, write_pairs, \
        write_weights
    from weightedld_tpu_torch.pipeline import WldConfig, prepare
    from weightedld_tpu_torch.runtime.driver import (DriverConfig, LdSession,
                                                     run_to_tsv)

    err = {}
    _vcf_h, aln, seeds = headline_vcf(tmp, "windows")
    pos = window_positions(S_HEAD)
    vcf = tmp / "window.vcf"
    t0 = time.monotonic()
    write_vcf(vcf, aln, pos=pos, chrom=["20"] * S_HEAD)
    _win_log(f"VCF {N_HEAD} x {S_HEAD}, CHROM 20, POS {pos[0]}..{pos[-1]} "
             f"(mean gap {WIN_GAP} bp): {vcf.stat().st_size / 1e6:.1f} MB in "
             f"{time.monotonic() - t0:.1f}s")
    idx = {int(p): i for i, p in enumerate(pos)}
    planted = {(int(pos[a]), int(pos[b]))
               for a, b in planted_pairs(seeds)}

    # (1) The bp window at the headline size, PLINK's --ld-window-kb 1000.
    w = str(WIN_BP)
    full_out, win_out = tmp / "window_full.tsv", tmp / "window_bp.tsv"
    _counts, spans, _o = _win_run(
        "full triangle", ["--file", str(vcf), "--r2-threshold", "0.1",
                          "--pair-output", str(full_out)])
    n_full = S_HEAD * (S_HEAD - 1) // 2
    _win_log(f"full triangle: {n_full / spans['scan+write']:.4g} pairs/s "
             f"over the scan | {card_line()}")
    counts, spans, _o = _win_run(
        f"--max-distance-bp {w}",
        ["--file", str(vcf), "--max-distance-bp", w, "--r2-threshold", "0.1",
         "--pair-output", str(win_out)])
    _need(counts, ("ld_majmin_planes",), "the bp-window run")
    head, full_rows = _tsv_rows(full_out)
    want = head + "".join(_rows_within(full_rows,
                                       lambda a, b: b - a <= WIN_BP))
    got = win_out.read_text()
    if got != want:
        raise AssertionError("the bp-window TSV is not the full TSV's rows "
                             f"within {w} bp")
    pairs = set(read_pairs(win_out))
    in_win = {p for p in planted if p[1] - p[0] <= WIN_BP}
    if in_win - pairs:
        raise AssertionError(f"{len(in_win - pairs)} planted in-window "
                             "pairs missing")
    res = prepare(vcf)
    sess = _session(res, r2_threshold=0.1, max_bp_distance=WIN_BP)
    n_win = _windowed_pairs(sess)
    full_tiles = -(-S_HEAD // 256) * (-(-S_HEAD // 256) + 1) // 2
    _win_log(f"bp window: {len(pairs)} records = the full TSV's {len(full_rows)}"
             f" rows filtered to posb - posa <= {w}, byte for byte; all "
             f"{len(in_win)} planted in-window pairs present")
    _scan_rate(f"--max-distance-bp {w}", n_win, spans, sess.plan.n_tiles,
               full_tiles)
    name, err["ld_majmin_planes"] = check_session_batch(
        sess, "window bp", b=sess.n_batches - 1)
    del sess

    codes_out = tmp / "window_codes.tsv"
    n_rec, counts = _counted(
        run_to_tsv, res.alignment, res.weights, res.site_map, codes_out,
        DriverConfig(r2_threshold=0.1, max_bp_distance=WIN_BP,
                     preplaned="off"), device="cuda")
    _need(counts, ("ld_majmin_codes",), "the bp-window codes-entry run")
    if codes_out.read_bytes() != win_out.read_bytes():
        raise AssertionError("the bp-window codes entry's TSV differs")
    _win_log(f"bp window, run_to_tsv(preplaned='off'): ld_majmin_codes "
             f"x{counts['ld_majmin_codes']}, {n_rec} records, same bytes")

    both_out = tmp / "window_both.tsv"
    counts, _spans, _o = _win_run(
        f"--max-distance {WIN_SITES} --max-distance-bp {w}",
        ["--file", str(vcf), "--max-distance", str(WIN_SITES),
         "--max-distance-bp", w, "--r2-threshold", "0.1", "--pair-output",
         str(both_out)])
    _need(counts, ("ld_majmin_planes",), "the two-window run")
    want = head + "".join(_rows_within(
        full_rows, lambda a, b: b - a <= WIN_BP
        and idx[b] - idx[a] <= WIN_SITES))
    if both_out.read_text() != want:
        raise AssertionError("the two-window TSV is not the full TSV "
                             "filtered by both windows")
    _win_log(f"--max-distance {WIN_SITES} with the bp window: the full TSV "
             "filtered by both, byte for byte")

    edges = [int(e) for e in WIN_DECAY.split(",")]
    counts, _spans, out = _win_run(
        f"--max-distance-bp {w} --ld-decay",
        ["--file", str(vcf), "--max-distance-bp", w, "--ld-decay",
         WIN_DECAY], json_out=True)
    _need(counts, ("ld_majmin_planes",), "the windowed --ld-decay run")
    if sum(out["n_pairs"]) != n_win:
        raise AssertionError(f"--ld-decay {WIN_DECAY} counts sum to "
                             f"{sum(out['n_pairs'])}, not the window's "
                             f"{n_win} pairs")
    _win_log(f"--ld-decay {edges} under the window: counts {out['n_pairs']}"
             f" sum to the window's {n_win} pairs")

    prune_out = tmp / "window_prune.txt"
    counts, _spans, _o = _win_run(
        f"--max-distance-bp {w} --prune-r2 0.1",
        ["--file", str(vcf), "--max-distance-bp", w, "--prune-r2", "0.1",
         "--pair-output", str(prune_out)])
    _need(counts, ("ld_majmin_planes",), "the windowed --prune-r2 run")
    kept = {int(x) for x in prune_out.read_text().split()}
    joined = [p for p in pairs if p[0] in kept and p[1] in kept]
    if joined:
        raise AssertionError(f"{len(joined)} windowed records join two "
                             f"kept sites, e.g. {joined[:3]}")
    _win_log(f"--prune-r2 0.1 under the window: {len(kept)} of {S_HEAD} "
             "sites kept, no windowed record joins two of them")
    del res

    # (2) A region: the same bytes as the session on that column slice.
    lo, hi = WIN_REGION
    reg_out = tmp / "window_region.tsv"
    counts, spans, _o = _win_run(
        f"--region 20:{lo}-{hi} --max-distance-bp {w}",
        ["--file", str(vcf), "--region", f"20:{lo}-{hi}",
         "--max-distance-bp", w, "--r2-threshold", "0.1", "--pair-output",
         str(reg_out)])
    _need(counts, ("ld_majmin_planes",), "the region run")
    col = (pos >= lo) & (pos <= hi)
    sub = np.ascontiguousarray(aln[:, col])
    ref_out = tmp / "window_region_ref.tsv"
    run_to_tsv(sub, henikoff_weights_host(sub), pos[col], ref_out,
               DriverConfig(r2_threshold=0.1, max_bp_distance=WIN_BP),
               device="cuda")
    rsess = _session(prepare(vcf, WldConfig(region=f"20:{lo}-{hi}")),
                     r2_threshold=0.1, max_bp_distance=WIN_BP)
    _scan_rate(f"--region 20:{lo}-{hi}", _windowed_pairs(rsess), spans,
               rsess.plan.n_tiles)
    del rsess
    if reg_out.read_bytes() != ref_out.read_bytes():
        raise AssertionError("the region run differs from the session on "
                             "its column slice")
    _win_log(f"--region 20:{lo}-{hi}: {int(col.sum())} sites, the same "
             f"bytes as run_to_tsv on that column slice with its own "
             f"Henikoff weights ({reg_out.read_text().count(chr(10)) - 1} "
             "records)")

    # (3) Across two chromosomes: sites 0..SPLIT-1 on 1, the rest on 2.
    split = S_HEAD // 2
    cvcf = tmp / "window_two_chroms.vcf"
    local = np.concatenate([np.arange(1, split + 1),
                            np.arange(1, S_HEAD - split + 1)])
    write_vcf(cvcf, aln, pos=local,
              chrom=["1"] * split + ["2"] * (S_HEAD - split))
    cross_out = tmp / "window_cross.tsv"
    counts, spans, _o = _win_run(
        "--cross-regions 1 2",
        ["--file", str(cvcf), "--cross-regions", "1", "2", "--r2-threshold",
         "0.1", "--pair-output", str(cross_out)])
    _need(counts, ("ld_majmin_planes",), "the cross run")
    pre = prepare(_vcf_h)        # the same alignment, one chromosome
    full = LdSession(pre.alignment, pre.weights, np.arange(S_HEAD),
                     DriverConfig(r2_threshold=0.1), device="cuda")
    buf = io.StringIO()
    buf.write(pair_header() + "\n")
    n_rect = 0
    for b in range(full.n_batches):
        fn, _plain, args, kw = full.batch_kernel(b)
        ti, tj, em = full.batch_tiles(b)
        st = fn(*args, ti, tj, em, **kw)
        li = torch.arange(256, device=st.keep.device)
        gi = ti.long()[:, None] * 256 + li
        gj = tj.long()[:, None] * 256 + li
        n_rect += int((st.keep & (gi < split)[:, :, None]
                       & (gj >= split)[:, None, :]).sum())
    for _b, rec in full.stream():
        a, b = np.asarray(rec.pos_a), np.asarray(rec.pos_b)
        m = (a < split) & (b >= split)
        sel = type(rec)(pos_a=local[a[m]], pos_b=local[b[m]],
                        d=rec.d[m], d_prime=rec.d_prime[m], r2=rec.r2[m])
        write_pairs(sel, buf, header=False)
    del full
    if cross_out.read_text() != buf.getvalue():
        raise AssertionError("the cross rows differ from the full session's "
                             "rectangle")
    cross_pairs = read_pairs(cross_out)
    straddle = {(a, b) for a, b in planted_pairs(seeds)
                if a < split <= b}
    got_idx = {(a - 1, b - 1 + split) for a, b in cross_pairs}
    if straddle - got_idx:
        raise AssertionError(f"{len(straddle - got_idx)} planted pairs "
                             "across the split missing")
    _win_log(f"--cross-regions 1 2: {len(cross_pairs)} records = the full "
             f"session's rectangle i < {split} <= j, byte for byte; all "
             f"{len(straddle)} planted pairs across the split present")
    _scan_rate("--cross-regions 1 2", n_rect, spans,
               -(-split // 256) * -(-(S_HEAD - split) // 256), full_tiles)
    counts, _spans, out = _win_run(
        "--cross-regions 1 2 --stats-only",
        ["--file", str(cvcf), "--cross-regions", "1", "2", "--r2-threshold",
         "0.1", "--stats-only"], json_out=True)
    _need(counts, ("ld_majmin_planes",), "the cross --stats-only run")
    if (out["n_pairs"], out["n_over_threshold"]) != (n_rect,
                                                      len(cross_pairs)):
        raise AssertionError(f"cross --stats-only {out} != rectangle "
                             f"{n_rect} pairs, {len(cross_pairs)} records")
    _win_log(f"cross --stats-only: n_pairs {out['n_pairs']} (= {split}^2 "
             f"less the skipped pairs), n_over_threshold "
             f"{out['n_over_threshold']} = the records")
    with contextlib.redirect_stderr(io.StringIO()) as e:
        rc = cli.main(["--file", str(cvcf), "--cross-regions", "1", "2",
                       "--ld-decay", WIN_DECAY])
    if rc != 2 or "ONE chromosome" not in e.getvalue():
        raise AssertionError(f"cross --ld-decay across chromosomes exited "
                             f"{rc}: {e.getvalue()!r}")
    _win_log("cross --ld-decay across two chromosomes exits 2")

    # (4) The windowed unsafe-site packing on the ambiguous FASTA.
    fasta, amb, trips, _dirty = ambiguous_fasta(tmp, "windows")
    ares = prepare(fasta)
    kept_idx = {int(c): i for i, c in enumerate(ares.site_map)}
    wsess = _session(ares, r2_threshold=0.1, max_site_distance=WIN_AMB)
    if not wsess.windowed_packed:
        raise AssertionError("the ambiguous window did not pack")
    _win_log(f"ambiguous --max-distance {WIN_AMB}: windowed-packed, "
             f"{wsess.phase_tiles} tile pairs of {wsess.plan.n_tiles} "
             f"(full plan {-(-S_AMB // 256) * (-(-S_AMB // 256) + 1) // 2})")
    n_amb, amb_tiles = _windowed_pairs(wsess), wsess.plan.n_tiles
    for b, label in ((0, "factorized phase"),
                     (wsess.n_batches - 1, "general phase")):
        name, e = check_session_batch(wsess, f"ambiguous window {label}", b=b)
        err[name] = max(err.get(name, 0.0), e)
    del wsess
    argv = ["--file", str(fasta), "--r2-threshold", "0.1", "--ndigits", "8"]
    amb_full, amb_win = tmp / "window_amb_full.tsv", tmp / "window_amb.tsv"
    _win_run("ambiguous, no window", argv + ["--pair-output", str(amb_full)])
    counts, spans, _o = _win_run(
        f"ambiguous --max-distance {WIN_AMB}",
        argv + ["--max-distance", str(WIN_AMB), "--pair-output",
                str(amb_win)])
    _need(counts, ("ld_majmin_planes", "ld_general"),
          "the windowed-packed run")
    got, full_rec = read_records(amb_win), read_records(amb_full)
    want = {k: v for k, v in full_rec.items()
            if kept_idx[k[1]] - kept_idx[k[0]] <= WIN_AMB}
    if set(got) != set(want):
        raise AssertionError(f"windowed-packed records: "
                             f"{len(set(got) ^ set(want))} pairs differ "
                             "from the filtered full run")
    np.testing.assert_allclose(np.array([got[k] for k in want]),
                               np.array(list(want.values())), rtol=2e-5,
                               atol=1e-6)
    in_win = {p for p in planted_pairs(trips)
              if kept_idx[p[1]] - kept_idx[p[0]] <= WIN_AMB}
    if in_win - set(got):
        raise AssertionError("planted in-window ambiguous pairs missing")
    _scan_rate(f"ambiguous --max-distance {WIN_AMB}", n_amb, spans,
               amb_tiles)
    stream_out = tmp / "window_amb_stream.tsv"
    counts, _spans, _o = _win_run(
        f"ambiguous --max-distance {WIN_AMB} --stream-ingest",
        argv + ["--max-distance", str(WIN_AMB), "--stream-ingest",
                "--pair-output", str(stream_out)])
    _need(counts, ("ld_general",), "the streamed windowed run")
    if stream_out.read_bytes() != amb_win.read_bytes():
        raise AssertionError("the streamed windowed TSV differs")
    _win_log(f"ambiguous window: {len(got)} records = the full run's within "
             f"{WIN_AMB} kept sites (a set, rtol 2e-5 / atol 1e-6), all "
             f"{len(in_win)} planted in-window pairs; --stream-ingest "
             "writes the same bytes")
    del ares

    # (5) A population subset of the cohort, windowed.
    cvcf_c = tmp / "cohort.vcf"
    rng = np.random.default_rng(2504)
    caln, cseeds = loaded_alignment(rng, N_COHORT, S_COHORT, N_TRIPLETS)
    if not cvcf_c.exists():
        write_vcf(cvcf_c, caln)
    keep = [f"S{i}" for i in np.sort(np.random.default_rng(503).choice(
        N_COHORT // 2, N_SUBSET, replace=False))]
    keep_file = tmp / "subset.txt"
    keep_file.write_text("\n".join(keep) + "\n")
    sub_out, w_out = tmp / "cohort_subset.tsv", tmp / "cohort_subset_w.tsv"
    counts, _spans, _o = _win_run(
        f"cohort --keep-samples ({N_SUBSET}) --max-distance {WIN_SITES}",
        ["--file", str(cvcf_c), "--keep-samples", f"@{keep_file}",
         "--max-distance", str(WIN_SITES), "--r2-threshold", "0.1",
         "--pair-output", str(sub_out), "--weights-output", str(w_out)])
    _need(counts, ("ld_majmin_planes",), "the cohort subset run")
    kept_samples = {int(k[1:]) for k in keep}
    rows = np.array([(N_COHORT - 1 - k) // 2 in kept_samples
                     for k in range(N_COHORT)])
    sub = np.ascontiguousarray(caln[rows])
    del caln
    buf = io.StringIO()
    write_weights(henikoff_weights_host(sub), buf)
    if w_out.read_text() != buf.getvalue():
        raise AssertionError("cohort subset weights differ from "
                             "henikoff_weights_host of the row subset")
    n_h = w_out.read_text().count("\n") - 1
    if n_h != 2 * N_SUBSET:
        raise AssertionError(f"cohort subset has {n_h} haplotypes")
    got = set(read_pairs(sub_out))
    in_win = {p for p in planted_pairs(cseeds, offset=1)
              if p[1] - p[0] <= WIN_SITES}
    if in_win - got:
        raise AssertionError("planted in-window cohort pairs missing")
    _win_log(f"cohort subset: {n_h} haplotypes, weights equal to "
             f"henikoff_weights_host of the row subset, {len(got)} records,"
             f" all {len(in_win)} planted in-window pairs")
    del sub

    # (6) CPU against the card.
    sl = tmp / "window_slice.vcf"
    write_vcf(sl, aln[:, :SLICE_SITES], pos=pos[:SLICE_SITES],
              chrom=["20"] * SLICE_SITES)
    asl = tmp / "window_amb_slice.fasta"
    write_fasta_codes(asl, amb[:, :AMB_SLICE], np.random.default_rng(7))
    for label, path, extra, kernels in (
            ("VCF slice --max-distance-bp 200000", sl,
             ["--seq-chunk", "200", "--max-distance-bp", "200000",
              "--r2-threshold", "0.005"], ("ld_majmin_codes",)),
            (f"ambiguous slice --max-distance {WIN_AMB_SLICE}", asl,
             ["--seq-chunk", "256", "--max-distance", str(WIN_AMB_SLICE),
              "--r2-threshold", "0.03"], ("ld_general",))):
        outs, cnt = {}, {}
        for device in ("cpu", "cuda"):
            out = tmp / f"window_slice_{device}.tsv"
            cnt[device], _spans, _o = _win_run(
                f"cpu-vs-card {label} on {device}",
                ["--file", str(path), "--device", device, "--engine",
                 "tiled", "--tile", "256", "--pair-output", str(out)]
                + extra)
            outs[device] = out.read_bytes()
        if any(cnt["cpu"].values()):
            raise AssertionError(f"the CPU run launched kernels: {cnt['cpu']}")
        _need(cnt["cuda"], kernels, f"cpu-vs-card {label} on the card")
        if outs["cpu"] != outs["cuda"]:
            raise AssertionError(f"cpu-vs-card {label}: TSVs differ")
        _win_log(f"cpu-vs-card {label}: byte-identical "
                 f"({len(outs['cuda'])} bytes)")
    sres = prepare(asl)
    ssess = _session(sres, tile=256, seq_chunk=256,
                     max_site_distance=WIN_AMB_SLICE)
    if not ssess.windowed_packed:
        raise AssertionError("the ambiguous slice window did not pack")
    return err


# ---------------------------------------------------------------------------
# Phase 9: the flags of the last CLI slice
# ---------------------------------------------------------------------------

# The flags phase: the batch after which a checkpointed run is interrupted,
# the --compat rust threshold and digits, and the --engine reference slice.
FLAGS_STOP_AFTER, RUST_THR, RUST_NDIGITS = 3, 0.1, 3
REF_SEQS, REF_SITES = 64, 200
# The kernel a --profile-dir trace of the headline must name.
PROFILE_KERNEL = "ld_majmin_wgmma"


class _Stop(Exception):
    """The test-only interruption of a checkpointed scan."""


def _flags_log(msg: str) -> None:
    log(f"[flags] {msg}")


def _flags_run(label: str, argv: list[str], stderr: bool = False):
    """One CLI run of the flags phase with its stage times, wall and
    launches printed: ``(launch counts, stage spans, wall, stderr text)``."""
    import contextlib
    import io

    from weightedld_tpu_torch.runtime.profiling import StageTimer

    timer = StageTimer()
    buf = io.StringIO()
    t0 = time.monotonic()
    with (contextlib.redirect_stderr(buf) if stderr
          else contextlib.nullcontext()):
        counts = _drive(argv, timer=timer)
    wall = time.monotonic() - t0
    _stage_log(label, timer, wall, "flags")
    _flags_log(f"{label}: kernel launches "
               f"{ {k: v for k, v in counts.items() if v} }")
    return counts, dict(timer.spans), wall, buf.getvalue()


def _interrupted(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with ``LdSession.stream`` raising after
    ``FLAGS_STOP_AFTER`` batches of a scan that starts at batch 0 (a
    test-only patch of this script; the package has no such switch)."""
    import weightedld_tpu_torch.runtime.driver as drv

    orig = drv.LdSession.stream

    def limited(*a, **kw):
        n = 0
        for item in orig(*a, **kw):
            yield item
            n += 1
            if n >= FLAGS_STOP_AFTER and not kw.get("start_batch"):
                raise _Stop

    drv.LdSession.stream = limited
    try:
        fn(*args, **kwargs)
    except _Stop:
        pass
    else:
        raise AssertionError("the checkpointed run was not interrupted")
    finally:
        drv.LdSession.stream = orig


def _need_launch(counts: dict, names: tuple, label: str) -> None:
    missing = [n for n in names if not counts.get(n)]
    if missing:
        raise AssertionError(f"{label} launched no {missing}: {counts}")


def _tsv_lines(path: Path) -> list[str]:
    import gzip

    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as fh:
        return fh.read().splitlines()


def _hold_checkpoint(label: str, run, out: Path) -> None:
    """``run(out_path)`` interrupted after ``FLAGS_STOP_AFTER`` batches and
    run again must write the bytes of an uninterrupted checkpointed run."""
    ckpt = out.with_suffix(out.suffix + ".ckpt.json")
    part = out.with_name("part_" + out.name)
    part_ckpt = part.with_suffix(part.suffix + ".ckpt.json")
    t0 = time.monotonic()
    run(out)
    full_wall = time.monotonic() - t0
    if ckpt.exists():
        raise AssertionError(f"{label}: {ckpt.name} left after the run")
    _interrupted(run, part)
    state = json.loads(part_ckpt.read_text())
    if state["next_batch"] != FLAGS_STOP_AFTER \
            or state["byte_offset"] != part.stat().st_size:
        raise AssertionError(f"{label}: checkpoint state {state}")
    t0 = time.monotonic()
    run(part)
    resume_wall = time.monotonic() - t0
    if part_ckpt.exists():
        raise AssertionError(f"{label}: {part_ckpt.name} left after resume")
    if part.read_bytes() != out.read_bytes():
        raise AssertionError(f"{label}: the resumed file differs from the "
                             "uninterrupted checkpointed run")
    _flags_log(f"{label}: interrupted after batch {FLAGS_STOP_AFTER} "
               f"({state['n_records']} records, {state['byte_offset']} "
               f"bytes) and resumed: byte-identical to the uninterrupted "
               f"run ({out.stat().st_size} bytes); walls: uninterrupted "
               f"{full_wall:.3f}s, resume {resume_wall:.3f}s")


def _hold_paper_weights(res, aln: np.ndarray, label: str) -> None:
    """The card's paper weights within rtol 2e-6 of the CPU float32
    ones."""
    from weightedld_tpu_torch.core.henikoff import henikoff_weights_paper

    cpu = henikoff_weights_paper(aln, device="cpu").numpy()
    rel = float(np.max(np.abs(res.weights / cpu - 1.0)))
    if rel > 2e-6:
        raise AssertionError(f"{label}: card paper weights {rel:.3g} "
                             "relative from the CPU's")
    _flags_log(f"{label}: card paper weights within {rel:.3g} relative of "
               f"the CPU float32 ones ({int((res.weights != cpu).sum())} of "
               f"{len(cpu)} differ in bits)")


def phase_flags(tmp: Path) -> dict:
    """The flags of the last CLI slice at full size on the card; returns
    the launch counts of its runs."""
    import contextlib
    import io

    import torch

    from weightedld_tpu_torch import cli
    from weightedld_tpu_torch.pipeline import WldConfig, prepare, site_stats
    from weightedld_tpu_torch.runtime.cache import load_prepared
    from weightedld_tpu_torch.runtime.driver import DriverConfig, run_to_tsv

    vcf, aln, _seeds = headline_vcf(tmp, "flags")
    fasta, amb, _trips, _dirty = ambiguous_fasta(tmp, "flags")
    _flags_log(card_line())
    launches: dict = {}

    def add(counts: dict) -> None:
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    base = ["--file", str(vcf), "--r2-threshold", str(RUST_THR)]

    # (1) The default TSV at r2 > 0.1: the bytes every variant is held to.
    tsv = tmp / "flags_default.tsv"
    counts, spans_plain, wall_plain, _ = _flags_run(
        "default", base + ["--pair-output", str(tsv)])
    _need_launch(counts, ("ld_majmin_planes",), "the default run")
    add(counts)
    rows = _tsv_lines(tsv)

    # (2) --compat rust: paper weights on the card, 3 dp, r2 > 0.1; the TSV
    # equals run_to_tsv fed the same weights.  The headline, then the
    # ambiguous FASTA (the Rust reader: one row per line, the terminator an
    # UNKNOWN column; the hybrid split).
    for label, src, cfg in (
            ("compat-rust headline", vcf, WldConfig(weighting="paper")),
            ("compat-rust ambiguous", fasta,
             WldConfig(weighting="paper", fasta_reader="rust",
                       max_minor=0.5))):
        out = tmp / f"flags_{label.split()[1]}_rust.tsv"
        counts, _spans, _wall, _ = _flags_run(
            label, ["--file", str(src), "--compat", "rust",
                    "--pair-output", str(out)])
        add(counts)
        want_kernels = ("ld_majmin_planes",) if src == vcf \
            else ("ld_majmin_planes", "ld_general")
        _need_launch(counts, want_kernels, label)
        res = prepare(src, cfg, device="cuda")
        _hold_paper_weights(res, res.alignment, label)
        ref = tmp / "flags_rust_ref.tsv"
        run_to_tsv(res.alignment, res.weights, res.site_map, ref,
                   DriverConfig(r2_threshold=RUST_THR), device="cuda",
                   ndigits=RUST_NDIGITS, checkpoint=False)
        if ref.read_bytes() != out.read_bytes():
            raise AssertionError(f"{label}: the CLI's TSV differs from "
                                 "run_to_tsv fed the same weights")
        n_rec = len(_tsv_lines(out)) - 1
        _flags_log(f"{label}: {n_rec} records at 3 dp, byte-identical to "
                   f"run_to_tsv fed the card's paper weights "
                   f"(S = {res.alignment.shape[1]})")

    # (3) --out-format plink: the default TSV's pairs and values, row for
    # row, with CHROM 1 and the VCF's rs ids.
    ld = tmp / "flags.ld"
    counts, _spans, _wall, _ = _flags_run(
        "plink", base + ["--out-format", "plink", "--pair-output", str(ld)])
    add(counts)
    plink = _tsv_lines(ld)
    if plink[0] != "CHR_A\tBP_A\tSNP_A\tCHR_B\tBP_B\tSNP_B\tR2\tDP\tD" \
            or len(plink) != len(rows):
        raise AssertionError(f"plink: {len(plink)} lines against "
                             f"{len(rows)}, header {plink[0]!r}")
    for p_row, t_row in zip(plink[1:], rows[1:]):
        ca, ba, sa, cb, bb, sb, r2, dp, d = p_row.split("\t")
        pa, pb, d_t, dp_t, r2_t = t_row.split("\t")
        if (ca, cb, ba, bb, sa, sb, r2, dp, d) != (
                "1", "1", pa, pb, f"rs{pa}", f"rs{pb}", r2_t, dp_t, d_t):
            raise AssertionError(f"plink row {p_row!r} against {t_row!r}")
    _flags_log(f"plink: {len(plink) - 1} rows, the default TSV's pairs "
               "and values row for row")

    # (4) --sort: the default TSV's rows in (posa, posb) order.
    srt = tmp / "flags_sorted.tsv"
    counts, _spans, _wall, _ = _flags_run(
        "sort", base + ["--sort", "--pair-output", str(srt)])
    add(counts)
    body = rows[1:]
    key = np.lexsort((np.array([int(r.split("\t", 2)[1]) for r in body]),
                      np.array([int(r.split("\t", 1)[0]) for r in body])))
    if _tsv_lines(srt) != rows[:1] + [body[i] for i in key]:
        raise AssertionError("--sort: not the default TSV's rows lexsorted")
    _flags_log(f"sort: {len(body)} rows, the default TSV's lexsorted")

    # (5) --checkpoint through the CLI (the preplaned entry), plain and .gz,
    # and through run_to_tsv(preplaned="off") (the codes entry).
    ck_spans = {}
    for suffix in (".tsv", ".tsv.gz"):
        def cli_run(path, suffix=suffix):
            timer = None
            if suffix == ".tsv":
                from weightedld_tpu_torch.runtime.profiling import StageTimer

                timer = ck_spans.setdefault(path.name, StageTimer())
            rc = cli.main(base + ["--checkpoint", "--pair-output",
                                  str(path)], timer=timer)
            if rc != 0:
                raise RuntimeError(f"checkpointed CLI run exited {rc}")

        out = tmp / f"flags_ckpt{suffix}"
        _, counts = _counted(_hold_checkpoint, f"checkpoint CLI {suffix}",
                             cli_run, out)
        _need_launch(counts, ("ld_majmin_planes",),
                     f"the checkpointed CLI runs ({suffix})")
        add(counts)
        if suffix == ".tsv" and out.read_bytes() != tsv.read_bytes():
            raise AssertionError("the checkpointed TSV differs from the "
                                 "default run's")
    for name, timer in ck_spans.items():
        for stage, sec in timer.spans.items():
            _flags_log(f"checkpoint CLI {name}: stage {stage:<12} {sec:.3f}s")

    # (6) --save-prepared, then --load-prepared: the same bytes, without
    # the ingest and weights stages.
    cache = tmp / "flags_prepared.npz"
    saved = tmp / "flags_saved.tsv"
    _c, spans_save, wall_save, _ = _flags_run(
        "save-prepared", base + ["--save-prepared", str(cache),
                                 "--pair-output", str(saved)])
    loaded = tmp / "flags_loaded.tsv"
    counts, spans_load, wall_load, _ = _flags_run(
        "load-prepared", ["--load-prepared", str(cache), "--r2-threshold",
                          str(RUST_THR), "--pair-output", str(loaded)])
    add(counts)
    for out in (saved, loaded):
        if out.read_bytes() != tsv.read_bytes():
            raise AssertionError(f"{out.name} differs from the default TSV")
    skipped = {k: round(spans_plain.get(k, 0.0), 3)
               for k in ("ingest", "weights")}
    _flags_log(f"save/load: same bytes; walls: default {wall_plain:.3f}s, "
               f"--save-prepared {wall_save:.3f}s (cache "
               f"{cache.stat().st_size / 1e6:.1f} MB), --load-prepared "
               f"{wall_load:.3f}s; skipped spans {skipped}; load run's "
               f"stages {sorted(spans_load)}")
    if "ingest" in spans_load or "weights" in spans_load:
        raise AssertionError("--load-prepared ran an ingest or weights stage")

    res, _prep = load_prepared(cache)
    for suffix in (".tsv", ".tsv.gz"):
        def codes_run(path):
            run_to_tsv(res.alignment, res.weights, res.site_map, path,
                       DriverConfig(r2_threshold=RUST_THR,
                                    preplaned="off"),
                       device="cuda", checkpoint=True)

        out = tmp / f"flags_codes{suffix}"
        _, counts = _counted(_hold_checkpoint,
                             f"checkpoint run_to_tsv codes {suffix}",
                             codes_run, out)
        _need_launch(counts, ("ld_majmin_codes",),
                     f"the codes-entry checkpointed runs ({suffix})")
        add(counts)
        if suffix == ".tsv" and out.read_bytes() != tsv.read_bytes():
            raise AssertionError("the codes entry's checkpointed TSV differs "
                                 "from the default run's")

    # (7) --site-stats on the ambiguous FASTA: one row per column, the
    # verdicts of the pipeline's masks.
    stats_tsv = tmp / "flags_sites.tsv"
    _flags_run("site-stats", ["--file", str(fasta), "--site-stats",
                              str(stats_tsv)])
    st_rows = [r.split("\t") for r in _tsv_lines(stats_tsv)[1:]]
    st = site_stats(fasta, WldConfig())
    pres = prepare(fasta, WldConfig(), device="cuda")
    if len(st_rows) != S_AMB or [int(r[0]) for r in st_rows] \
            != list(range(S_AMB)) or not np.array_equal(
                np.array([r[5] == "1" for r in st_rows]), pres.ld_mask) \
            or not np.array_equal(st["hk"], pres.hk_mask):
        raise AssertionError("--site-stats rows disagree with the masks")
    cov = (amb < 4).mean(axis=0)
    if not np.allclose([float(r[1]) for r in st_rows], cov, atol=5e-5):
        raise AssertionError("--site-stats coverage disagrees")
    _flags_log(f"site-stats: {len(st_rows)} rows, {int(pres.ld_mask.sum())}"
               f" LD sites, hk/ld verdicts equal the pipeline's masks")

    # (8) --profile-dir: a trace that names the kernel, and the bytes of
    # the run without it.
    prof_dir = tmp / "flags_prof"
    prof = tmp / "flags_prof.tsv"
    counts, spans_prof, wall_prof, _ = _flags_run(
        "profile-dir", base + ["--profile-dir", str(prof_dir),
                               "--pair-output", str(prof)])
    add(counts)
    traces = list(prof_dir.glob("trace_*.json"))
    if len(traces) != 1 or PROFILE_KERNEL not in traces[0].read_text():
        raise AssertionError(f"--profile-dir: traces {traces} do not name "
                             f"{PROFILE_KERNEL}")
    if prof.read_bytes() != tsv.read_bytes():
        raise AssertionError("--profile-dir changed the output bytes")
    events = json.loads(traces[0].read_text())["traceEvents"]
    n_kern = sum(1 for e in events if PROFILE_KERNEL in
                 str(e.get("name", "")))
    _flags_log(f"profile-dir: trace {traces[0].stat().st_size / 1e6:.1f} MB"
               f", {n_kern} {PROFILE_KERNEL} events, same bytes; scan+write "
               f"{spans_prof.get('scan+write', 0.0):.3f}s against "
               f"{spans_plain.get('scan+write', 0.0):.3f}s unprofiled, "
               f"wall {wall_prof:.3f}s against {wall_plain:.3f}s")

    # (9) --progress-bar: one report at 100 %, on the last batch.
    counts, _spans, _wall, err = _flags_run(
        "progress-bar", base + ["--progress-bar", "--pair-output",
                                str(tmp / "flags_bar.tsv")], stderr=True)
    add(counts)
    bars = [ln for ln in err.splitlines() if ln.startswith("[")]
    if not bars or "100.0%" not in bars[-1] \
            or sum("100.0%" in b for b in bars) != 1:
        raise AssertionError(f"--progress-bar lines {bars}")
    _flags_log(f"progress-bar: {len(bars)} line(s), the last {bars[-1]!r}")

    # (10) --engine reference against the dense engine on a slice.
    small = tmp / "flags_ref.vcf"
    write_vcf(small, aln[:REF_SEQS, :REF_SITES])
    outs = {}
    for engine in ("reference", "dense"):
        buf = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            add(_drive(["--file", str(small), "--engine", engine]))
        outs[engine] = buf.getvalue().splitlines()
        _flags_log(f"engine {engine}: {len(outs[engine]) - 1} records in "
                   f"{time.monotonic() - t0:.3f}s")
    ref_rows = [r.split("\t") for r in outs["reference"][1:]]
    den_rows = [r.split("\t") for r in outs["dense"][1:]]
    if [r[:2] for r in ref_rows] != [r[:2] for r in den_rows] \
            or not ref_rows:
        raise AssertionError("--engine reference and dense keep different "
                             "pairs")
    worst = max(abs(float(a) - float(b)) for ra, rb in zip(ref_rows,
                                                           den_rows)
                for a, b in zip(ra[2:], rb[2:]))
    if worst > 1.0001e-4:
        raise AssertionError(f"reference vs dense: {worst} > one quantum")
    same = sum(ra == rb for ra, rb in zip(ref_rows, den_rows))
    _flags_log(f"engine reference vs dense on {REF_SEQS} x {REF_SITES}: "
               f"the same {len(ref_rows)} pairs, {same} rows byte-identical"
               f", the rest within {worst:.4g} (one 4-dp quantum)")

    # (11) CPU against card under --compat rust on a 4,096-site slice: the
    # same bytes where the two devices' paper weights are bit-equal, and
    # always when both are fed the card's weights.
    slice_vcf = tmp / "flags_slice.vcf"
    write_vcf(slice_vcf, aln[:, :SLICE_SITES])
    outs = {}
    for device in ("cpu", "cuda"):
        out = tmp / f"flags_slice_{device}.tsv"
        counts, _spans, _wall, _ = _flags_run(
            f"compat-rust slice {device}",
            ["--file", str(slice_vcf), "--compat", "rust", "--engine",
             "tiled", "--device", device, "--pair-output", str(out)])
        if device == "cuda":
            add(counts)
        elif any(counts.values()):
            raise AssertionError(f"the CPU run launched kernels: {counts}")
        outs[device] = out.read_bytes()
    w = {d: prepare(slice_vcf, WldConfig(weighting="paper"),
                    device=d).weights for d in ("cpu", "cuda")}
    if np.array_equal(w["cpu"], w["cuda"]):
        if outs["cpu"] != outs["cuda"]:
            raise AssertionError("CPU and card --compat rust TSVs differ "
                                 "with bit-equal weights")
        _flags_log("compat-rust slice: weights bit-equal, TSVs "
                   f"byte-identical ({len(outs['cuda'])} bytes)")
    else:
        fed = {}
        sres = prepare(slice_vcf, WldConfig(weighting="paper"),
                       device="cuda")
        for device in ("cpu", "cuda"):
            out = tmp / f"flags_slice_fed_{device}.tsv"
            run_to_tsv(sres.alignment, w["cuda"], sres.site_map, out,
                       DriverConfig(r2_threshold=RUST_THR), device=device,
                       ndigits=RUST_NDIGITS, checkpoint=False)
            fed[device] = out.read_bytes()
        if fed["cpu"] != fed["cuda"] or fed["cuda"] != outs["cuda"]:
            raise AssertionError("CPU and card TSVs differ when fed the "
                                 "same weights")
        _flags_log(f"compat-rust slice: {int((w['cpu'] != w['cuda']).sum())}"
                   " weights differ by float32 order between the devices; "
                   "fed the card's weights, the two TSVs are byte-identical "
                   f"({len(fed['cuda'])} bytes), and CPU vs card CLI bytes "
                   f"{'equal' if outs['cpu'] == outs['cuda'] else 'differ'}")
    torch.cuda.synchronize()
    _need_launch(launches, ("ld_majmin_planes", "ld_majmin_codes",
                            "ld_general"), "the flags phase")
    _flags_log(f"kernel launches over the phase: "
               f"{ {k: v for k, v in launches.items() if v} }")
    return launches


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
    times after a warm-up and summarized once (the first summarize, the
    sequence of earlier trees' profile phase), then by ``stream`` and
    ``summarize`` in three interleaved rounds (stream, summarize,
    summarize, stream); one batch's
    top-k selection (k = TOP_K) is timed with the tile-max prefilter
    (``topk_batch``) and as one flat ``torch.topk``, the same gather
    after each, beside that batch's kernel launch; then one scan runs
    under torch.profiler for the device time by kernel and the device idle
    share.  Then the same for the windowed headline (``--max-distance-bp
    1000000`` on the windows phase's positions), with the window and cross
    masks timed alone on a full batch beside its kernel launch."""
    import torch

    from weightedld_tpu_torch.core.henikoff import henikoff_weights_host
    from weightedld_tpu_torch.parallel.analytics import pair_rows, topk_batch
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

    def summarize_seconds():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        sess.summarize()
        return time.monotonic() - t0

    _scan_seconds(sess)                                # warm-up
    for _ in range(3):
        dt = _scan_seconds(sess)
        log(f"[profile] stream: {dt:.4f}s {n_pairs / dt:.4g} pairs/s | "
            f"{card_line()}")
    log(f"[profile] summarize: {summarize_seconds():.4f}s (the first)")
    times = {"stream": [], "summarize": []}
    for _ in range(3):
        for kind in ("stream", "summarize", "summarize", "stream"):
            times[kind].append(_scan_seconds(sess) if kind == "stream"
                               else summarize_seconds())
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"[profile] stream {times['stream']} s ({n_pairs / med['stream']:.4g} "
        f"pairs/s at the median), summarize {times['summarize']} s; median "
        f"summarize / stream {med['summarize'] / med['stream']:.4f} | "
        f"{card_line()}")

    st, ti, tj = sess._dispatch(0)
    t = sess.cfg.tile

    def flat():
        masked = torch.where(st.keep, st.r2,
                             torch.full_like(st.r2, -torch.inf))
        vals, idx = torch.topk(masked.reshape(-1), TOP_K)
        idx = idx[vals > -torch.inf]
        return pair_rows(st, ti, tj, idx // (t * t), idx % (t * t), tile=t)

    ms_kernel, _o = _time_cuda(lambda: sess._dispatch(0), 3)
    ms = {"prefilter": [], "flat": []}
    for kind in ("prefilter", "flat", "flat", "prefilter"):
        ms[kind].append(_time_cuda(
            (lambda: topk_batch(st, ti, tj, tile=t, k=TOP_K))
            if kind == "prefilter" else flat, 5)[0])
    a = topk_batch(st, ti, tj, tile=t, k=TOP_K)
    b = flat()
    if not torch.equal(a[:, 4], b[:, 4]):
        raise AssertionError("top-k with and without the prefilter differ")
    log(f"[profile] batch 0 ({ti.shape[0]} tiles): kernel launch "
        f"{ms_kernel:.3f} ms; top-{TOP_K} selection + gather, with the "
        f"tile-max prefilter {ms['prefilter']} ms, one flat torch.topk "
        f"{ms['flat']} ms | {card_line()}")
    del st, a, b

    _profile_scan(sess, "headline")
    del sess

    # The windowed headline: the scan, its breakdown, and each mask form
    # alone on a full batch of 2,520 tiles.
    pos = window_positions(S_HEAD)
    wsess = LdSession(aln, w, pos, DriverConfig(r2_threshold=0.1,
                                                max_bp_distance=WIN_BP))
    n_win = wsess.summarize(r2_threshold=None)["n_pairs"]
    _scan_seconds(wsess)                               # warm-up
    dts = [_scan_seconds(wsess) for _ in range(3)]
    log(f"[profile] windowed stream ({wsess.plan.n_tiles} tiles, "
        f"{wsess.n_batches} batches): {dts} s, {n_win / min(dts):.4g} "
        f"pairs/s over the window's {n_win} pairs | {card_line()}")
    fn, _plain, args, kw = wsess.batch_kernel(0)
    ti, tj, em = wsess.batch_tiles(0)
    ms_kernel, st = _time_cuda(lambda: fn(*args, ti, tj, em, **kw), 3)
    masks = {"bp window": wsess}
    masks["cross rectangle"] = LdSession(
        aln, w, pos, DriverConfig(r2_threshold=0.1, cross_split=S_HEAD // 2))
    masks["site window"] = LdSession(
        aln, w, pos, DriverConfig(r2_threshold=0.1, max_site_distance=5000))
    for label, ms_sess in masks.items():
        # Folding the same mask again leaves keep as it is: time in place.
        ms_mask = _time_cuda(lambda: ms_sess._mask_pairs(st.keep, ti, tj),
                             5)[0]
        log(f"[profile] {label} mask on batch 0 ({ti.shape[0]} tiles, "
            f"{ti.shape[0] * 65536} pairs): {ms_mask:.3f} ms beside the "
            f"kernel's {ms_kernel:.3f} ms ({ms_mask / ms_kernel:.4f}) | "
            f"{card_line()}")
    del masks, st
    _profile_scan(wsess, "windowed")


def _profile_scan(sess, label: str) -> None:
    """One ``stream`` scan of ``sess`` under torch.profiler: device kernel
    time by kernel and the device idle share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _scan_seconds(sess)
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_time_total > 0), key=lambda r: -r[1])
    kernels = [r for r in rows if not r[0].startswith(("aten::", "cuda"))]
    busy = sum(r[1] for r in kernels)
    log(f"[profile] {label} scan: device kernel time {busy:.3f} ms of "
        f"{wall * 1e3:.3f} ms wall: idle share {1 - busy / (wall * 1e3):.4f}")
    for name, ms_k, count in kernels[:12]:
        log(f"[profile]   {ms_k:10.3f} ms x{count:<4d} {name[:90]}")


def phase_entries() -> None:
    """Not in the default run: the codes entry against the preplaned entry,
    whole sessions on Henikoff-weighted loaded alignments at several N, S
    and seq chunks, in int8x3 (the default), lo_int8 and split_bf16 (set-up,
    then scans interleaved on, off, off, on after a warm-up of each), so
    that ``preplaned="auto"`` can be set from the card for each kind."""
    import torch

    from weightedld_tpu_torch.core.henikoff import henikoff_weights_host
    from weightedld_tpu_torch.runtime.driver import DriverConfig, LdSession

    for n, s, chunk in ENTRY_SHAPES:
        aln, _seeds = loaded_alignment(np.random.default_rng(n + s), n, s,
                                       N_TRIPLETS)
        w = henikoff_weights_host(aln)
        for wq in ENTRY_MODES:
            sessions, setup = {}, {}
            for pp in ("on", "off"):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                sessions[pp] = LdSession(aln, w, np.arange(1, s + 1),
                                         DriverConfig(r2_threshold=0.1,
                                                      seq_chunk=chunk,
                                                      preplaned=pp,
                                                      weight_quant=wq))
                setup[pp] = time.monotonic() - t0
            sess = sessions["on"]
            plane_bytes = sum(t.numel() for t in sess.operands
                              if t is not None)
            scans = {"on": [], "off": []}
            for pp in ("on", "off"):
                _scan_seconds(sessions[pp])                # warm-up
            for pp in ("on", "off", "off", "on"):
                scans[pp].append(_scan_seconds(sessions[pp]))
            best = {pp: min(v) for pp, v in scans.items()}
            log(f"[entries] {wq} N={n} S={s} {sess.cfg} planes+xq "
                f"{plane_bytes} B: set-up on {setup['on']:.4f}s off "
                f"{setup['off']:.4f}s; scans on {scans['on']} off "
                f"{scans['off']}; best off/on "
                f"{best['off'] / best['on']:.4f} | {card_line()}")
            del sessions, sess
            torch.cuda.empty_cache()


# Variants of csrc/ld_majmin.cu for the pace phase: name -> textual
# edits (old, new), each of which must match the source exactly once.
_WGMMA_STEPS = """\
          wgmma_levels<G::kPasses>(D, da, db, scale_d);
          wgmma_levels<G::kPasses>(D, da + 2, db + 2, 1);
          wgmma_levels<G::kPasses>(D, da + 4, db + 4, 1);
          wgmma_levels<G::kPasses>(D, da + 6, db + 6, 1);
"""
_BUILD_CALL = """\
    build_stage<G, R, PRE>(aux, at.width(p),
                           graw + slot * G::kRawBytes + kBase,
                           gst + cur.stage * G::kStageBytes, pt);
"""
_FETCH_CALL = """\
      fetch_raw<G, R, VEC16>(p, rows, ahead.k0, ahead.width(p),
                             raw + slot * G::kRawBytes + kBase, pt);
"""
# The epilogue reads the cells but runs no pair algebra or store.  Every
# variant that drops work drops the algebra too: cells of garbage operands
# (zeros, NaNs) send its IEEE divisions down their slow path, which would
# then set the pace.
_NO_ALGEBRA = ("""\
          store_pair(p, w.kt, ti, tj, li, lj, (poly >> m) & 1u, cell);""",
               """\
          if (c.x == -1.0f)
            store_pair(p, w.kt, ti, tj, li, lj, (poly >> m) & 1u, cell);""")
PACE_VARIANTS = {
    # The epilogue's pair algebra: the reference for the variants below.
    "no-algebra": (_NO_ALGEBRA,),
    # The consumers issue no wgmma: the producers' pace.
    "no-mma": (_NO_ALGEBRA, (_WGMMA_STEPS, "")),
    # The producers fetch their raw rows but build no operand: the
    # consumers' pace.
    "no-build": (_NO_ALGEBRA, (_BUILD_CALL, "")),
    # Neither: the stage ring's synchronization and the raw fetches.
    "no-mma-build": (_NO_ALGEBRA, (_WGMMA_STEPS, ""), (_BUILD_CALL, "")),
    # The builders fetch no raw rows and build from stale raw buffers: the
    # cost of the loads from L2.
    "no-fetch": (_NO_ALGEBRA, (_FETCH_CALL, "")),
    # None of the three: the stage ring's synchronization alone.
    "ring-only": (_NO_ALGEBRA, (_WGMMA_STEPS, ""), (_BUILD_CALL, ""),
                  (_FETCH_CALL, "")),
    # The builders skip their proxy fence before they arrive.
    "no-fence": (_NO_ALGEBRA, ("""\
    fence_proxy_async();  // generic-proxy writes -> wgmma reads
""", "")),
    # Two raw buffers instead of four: one load in flight, not three.
    "raw-depth-2": (("""\
  static constexpr int kRawDepth = kBuild ? 4 : 0;""", """\
  static constexpr int kRawDepth = kBuild ? 2 : 0;"""),),
    # Each try_wait may suspend its thread up to 10 ms (the phase's
    # completion still wakes it) instead of the system's default limit.
    "suspend-hint": (
        ("shared::cta.b64 p, [%1], %2;",
         "shared::cta.b64 p, [%1], %2, %3;"),
        (': "r"(bar), "r"(parity)',
         ': "r"(bar), "r"(parity), "r"(10000000u)')),
    # A waiter that finds the phase incomplete sleeps 64 ns before it
    # tries again.
    "backoff": (("""\
    if (done) return;
""", """\
    if (done) return;
    __nanosleep(64);
"""),),
    # 4 operand stages and still 4 raw buffers in the float modes where
    # shared memory holds them (all but the preplaned lo_int8 and
    # split_bf16 entries).
    "4-stages-4-raw": (("""\
  static constexpr int kStages = kBuild ? 3 : 4;""", """\
  static constexpr int kStages =
      kBuild && !(kBf16 && !(PRE && kPasses == 2)) ? 3 : 4;"""),),
    # The float modes' operand build on one producer warpgroup instead of
    # two (the A and the B sites).
    "1-builder": (("kBuilders = kBf16 ? 2 : 1;", "kBuilders = 1;"),),
    # The float modes with 4 operand stages and 3 raw buffers (one more
    # stage between producer and consumers, one less load in flight).
    "4-stages": (("""\
  static constexpr int kStages = kBuild ? 3 : 4;
  static constexpr int kRawDepth = kBuild ? 4 : 0;""", """\
  static constexpr int kStages = kBuild && !kBf16 ? 3 : 4;
  static constexpr int kRawDepth = kBuild ? (kBf16 ? 3 : 4) : 0;"""),),
}

# The variants that drop no work.
EXACT_PACE_VARIANTS = ("suspend-hint", "backoff", "4-stages-4-raw",
                       "raw-depth-2", "1-builder", "4-stages")


def _variant_libs(source: str, variants: dict, entries: tuple,
                  subdir: str) -> dict:
    """Compile each of ``variants`` (name -> textual edits (old, new) of
    ``csrc/<source>``, each matching the source exactly once) beside the
    committed libraries, one nvcc each, all started together; returns
    ``{"committed": library, name: library with ``entries`` replaced}``."""
    import ctypes
    from types import SimpleNamespace

    from weightedld_tpu_torch.ops import _build

    src = (_build.CSRC / source).read_text()
    out = _build.BUILD_DIR / subdir
    out.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    texts = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"variant {name}: edit matches "
                                     f"{text.count(old)} times")
            text = text.replace(old, new)
        texts[name] = text
    jobs = {}
    for name, text in texts.items():
        cu, so = out / f"{name}.cu", out / f"lib{name}.so"
        cu.write_text(text)
        jobs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        base = _build.load_library()
    finally:
        done = {name: (so, proc.communicate()[1], proc.returncode)
                for name, (so, proc) in jobs.items()}
    libs = {"committed": base}
    for name, (so, err, rc) in done.items():
        if rc != 0:
            raise RuntimeError(f"nvcc of variant {name}:\n{err}")
        lib = ctypes.CDLL(str(so))
        fns = {}
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = _build.ENTRIES[entry]
            fn.restype = ctypes.c_int
            fns[entry] = fn
        libs[name] = SimpleNamespace(**{**vars(base), **fns})
    return libs


def phase_pace() -> None:
    """Not in the default run: what sets the pace of the factorized body.
    Each variant of ``PACE_VARIANTS`` is compiled from the source beside
    the committed body (one nvcc each, started together) and timed through
    the wrappers on the kernel-timing plan (N=1,000 x S=8,192, 528 tiles
    in one launch), in turns: committed, variants, variants reversed,
    committed.  Variants that drop work compute nothing meaningful; those
    of ``EXACT_PACE_VARIANTS`` are held bit for bit to the committed
    body."""
    import torch

    from weightedld_tpu_torch.ops import _build
    from weightedld_tpu_torch.ops import cuda_ld as K

    dev = torch.device("cuda")
    libs = _variant_libs("ld_majmin.cu", PACE_VARIANTS,
                         ("ld_majmin_codes", "ld_majmin_planes"), "pace")
    base = libs["committed"]
    order = [*libs, *reversed(libs)]
    try:
        for wq in ("split_bf16", "lo_int8", "exact", "int8x3"):
            codes, wr, auxc, ti, tj, em, kw = _case_inputs(
                11, (0, 1, 4), N_HEAD, S_TIMED, 256, 1024, wq, dev)
            em = torch.ones_like(em)
            planes = K.build_majmin_planes(codes, auxc, tile=256)
            xq = K.build_majmin_xq(planes, wr, 3) if wq == "int8x3" else None
            for entry, fn, ops in (
                    ("codes", K.tile_stats_majmin, (codes,)),
                    ("planes", K.tile_stats_majmin_pre, (planes, xq))):
                ms, stats = {name: [] for name in libs}, {}
                for name in order:
                    _build._lib = libs[name]
                    t, stats[name] = _time_cuda(
                        lambda: fn(*ops, wr, auxc, ti, tj, em, **kw), 10)
                    ms[name].append(round(t, 4))
                ref = stats["committed"]
                for name in EXACT_PACE_VARIANTS:
                    got = stats[name]
                    if not (torch.equal(got.keep, ref.keep) and torch.equal(
                            got.r2[ref.keep], ref.r2[ref.keep])):
                        raise AssertionError(f"{name} {wq} {entry} differs "
                                             "from the committed body")
                log(f"[pace] {wq} {entry}: ms per launch of 528 tiles "
                    f"{ms} ({', '.join(EXACT_PACE_VARIANTS)} bit-equal to "
                    f"committed) | {card_line()}")
                del stats, ref, got
    finally:
        _build._lib = base


# Variants of csrc/ld_general.cu for the gpace phase, each also built for
# P = 5 alone (the timing plan's), like the committed body beside them.
_GENERAL_P5 = ("""\
    case 1: return by_mode<1, PRE>(p, k, nlev, nflt, unit, stream);
    case 2: return by_mode<2, PRE>(p, k, nlev, nflt, unit, stream);
    case 3: return by_mode<3, PRE>(p, k, nlev, nflt, unit, stream);
    case 4: return by_mode<4, PRE>(p, k, nlev, nflt, unit, stream);
""", "")
_GENERAL_MMA = ("""\
          wgmma<G::kN>(D, da, db, h == 0 ? scale_d : 1);
          wgmma<G::kN>(D, da + 2, db + 2, 1);
          wgmma<G::kN>(D, da + 4, db + 4, 1);
          wgmma<G::kN>(D, da + 6, db + 6, 1);
""", "")
_GENERAL_BUILD = ("""\
    build_stage<G, PRE, ROLE>(p, at.width(p),
                              graw + slot * G::kRawBytes + kBase,
                              gst + cur.stage * G::kStageBytes, pt);
""", "")
_GENERAL_FETCH = ("""\
      fetch_raw<G, PRE, ROLE>(p, ahead, raw + slot * G::kRawBytes + kBase,
                              pt);
""", "")
# Conditions that are false at run time keep the code compiled.
_GENERAL_COMBINE = ("for (int h = 0; h < 2; ++h) {",
                    "for (int h = 0; h < (p.tile < 0 ? 2 : 0); ++h) {")
_GENERAL_EPILOGUE = ("for (int q = ct; q < G::kSA * G::kSB; q += kConsumers) {",
                     "for (int q = ct; q < (p.tile < 0 ? 1 : 0); "
                     "q += kConsumers) {")
GENERAL_PACE_VARIANTS = {
    "p5": (_GENERAL_P5,),
    # One-atom stages (twice the stages); computes the same bits.
    "1-atom": (_GENERAL_P5, ("constexpr int kMaxHalves = 2;",
                             "constexpr int kMaxHalves = 1;")),
    # Two-atom bf16 stages stored in one chunk order in both halves (2-way
    # shared-memory bank conflicts on every build store); the same bits.
    "no-swap": (_GENERAL_P5, (
        "static constexpr bool kSwapOdd = kBf16 && H > 1;",
        "static constexpr bool kSwapOdd = false;")),
    "no-finalize": (_GENERAL_P5, _GENERAL_EPILOGUE),
    "no-combine": (_GENERAL_P5, _GENERAL_COMBINE, _GENERAL_EPILOGUE),
    "no-mma": (_GENERAL_P5, _GENERAL_MMA, _GENERAL_COMBINE,
               _GENERAL_EPILOGUE),
    "no-build": (_GENERAL_P5, _GENERAL_BUILD, _GENERAL_COMBINE,
                 _GENERAL_EPILOGUE),
    "no-fetch": (_GENERAL_P5, _GENERAL_FETCH, _GENERAL_COMBINE,
                 _GENERAL_EPILOGUE),
    "ring-only": (_GENERAL_P5, _GENERAL_MMA, _GENERAL_BUILD, _GENERAL_FETCH,
                  _GENERAL_COMBINE, _GENERAL_EPILOGUE),
}


def phase_gpace() -> None:
    """Not in the default run: what sets the pace of the general body.  Each
    variant of ``GENERAL_PACE_VARIANTS`` (built for P = 5 alone; those past
    ``p5`` drop parts of the work and compute nothing meaningful) is
    compiled beside the committed body (one nvcc each, started together)
    and timed through the wrapper on the 528-tile plan at P = 5, in turns:
    committed, variants, variants reversed, committed."""
    import torch

    from weightedld_tpu_torch.ops import _build
    from weightedld_tpu_torch.ops import cuda_general as G

    dev = torch.device("cuda")
    libs = _variant_libs("ld_general.cu", GENERAL_PACE_VARIANTS,
                         ("ld_general", "ld_general_unit"), "gpace")
    base = libs["committed"]
    order = [*libs, *reversed(libs)]
    try:
        for wq, pre in (("int8x3", False), ("int8x3", True),
                        ("lo_int8", False), ("unit", False),
                        ("exact", False)):
            codes, wr, ti, tj, em, kw = _general_case_inputs(
                31, (0, 1, 2, 3, 4), N_HEAD, S_TIMED, 256, 1024, wq, 0.0,
                None, dev, dirty_sites=S_TIMED // 100)
            em = torch.ones_like(em)
            srcs = G.build_planes_tiled(codes, tile=256, planes=kw["planes"]) \
                if pre else codes
            ms = {name: [] for name in libs}
            for name in order:
                _build._lib = libs[name]
                t, _stats = _time_cuda(lambda: G.tile_stats_general(
                    srcs, wr, ti, tj, em, preplaned=pre, **kw), 5)
                ms[name].append(round(t, 3))
            log(f"[gpace] {wq} {'planes' if pre else 'codes'}: ms per launch "
                f"of 528 tiles {ms} | {card_line()}")
    finally:
        _build._lib = base


DEFAULT_PHASES = ("build", "kernels", "main", "cpu-vs-card", "analytics",
                  "ambiguous", "ingest", "windows", "flags")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                    help="comma-separated subset of build, kernels, main, "
                    "cpu-vs-card, analytics, ambiguous, ingest, windows, "
                    "flags, profile, entries, pace, general, gpace and "
                    "yardstick (default: the first nine, which the result "
                    "line needs)")
    args = ap.parse_args()
    phases = args.phases.split(",")

    # The smoke test runs on one card: the first of those visible to it.
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = first or "0"
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
    t_start = time.monotonic()

    def done(phase: str, t0: float) -> None:
        log(f"[smoke] phase {phase}: {time.monotonic() - t0:.1f}s "
            f"(total {time.monotonic() - t_start:.1f}s)")

    with tempfile.TemporaryDirectory(prefix="wld_smoke_") as td:
        tmp = Path(td)
        if "build" in phases:
            t0 = time.monotonic()
            phase_build()
            done("build", t0)
        if "kernels" in phases:
            t0 = time.monotonic()
            res = phase_kernels()
            err = res["err"]
            done("kernels", t0)
        if "main" in phases:
            t0 = time.monotonic()
            launches, main_err = phase_main(tmp)
            for name, e in main_err.items():
                err[name] = max(err[name], e)
            done("main", t0)
        if "cpu-vs-card" in phases:
            t0 = time.monotonic()
            name, e = phase_cpu_vs_card(tmp)
            err[name] = max(err[name], e)
            done("cpu-vs-card", t0)
        if "analytics" in phases:
            t0 = time.monotonic()
            an_launches, an_err = phase_analytics(tmp)
            launches.update(an_launches)
            for name, e in an_err.items():
                err[name] = max(err[name], e)
            done("analytics", t0)
        if "ambiguous" in phases:
            t0 = time.monotonic()
            amb_launches, amb_err = phase_ambiguous(tmp)
            launches.update(amb_launches)
            for name, e in amb_err.items():
                err[name] = max(err[name], e)
            done("ambiguous", t0)
        if "ingest" in phases:
            t0 = time.monotonic()
            phase_ingest(tmp)
            done("ingest", t0)
        if "windows" in phases:
            t0 = time.monotonic()
            for name, e in phase_windows(tmp).items():
                err[name] = max(err[name], e)
            done("windows", t0)
        if "flags" in phases:
            t0 = time.monotonic()
            phase_flags(tmp)
            done("flags", t0)
        if "profile" in phases:
            phase_profile()
        if "entries" in phases:
            phase_entries()
        if "general" in phases:
            phase_general()
        if "gpace" in phases:
            phase_gpace()
        if "pace" in phases:
            phase_pace()
        if "yardstick" in phases and "kernels" not in phases:
            phase_yardstick()              # the kernels phase runs it too
    if set(phases) != set(DEFAULT_PHASES):
        log("[smoke] partial run: no result line")
        return 0
    log(f"[smoke] main-path launches: ld_majmin_planes from the headline "
        f"CLI run, ld_majmin_codes from the headline codes-entry run, "
        f"ld_general from the ambiguous CLI run, ld_general_planes from its "
        f"preplaned kernel='general' run, ld_general_unit from its "
        f"--unweighted CLI run; the lo_int8 variants from the headline "
        f"lo_int8 --stats-only CLI run (planes) and codes-entry run, the "
        f"ambiguous lo_int8 CLI run (ld_general) and its preplaned "
        f"kernel='general' lo_int8 run; the factorized split_bf16 and "
        f"bf16-exact variants from the headline summarize runs of each "
        f"entry, the general ones from the ambiguous kernel='general' runs: "
        f"{launches}")
    missing = [name for name in KERNELS if not launches.get(name)]
    if missing:
        raise AssertionError(f"no main-path launch of {missing}")
    # No single PyTorch call computes any of these functions (per-pair
    # major/dmin selection, the weighted combine and the pair algebra), so
    # library_ms is null.
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": res["ms"][name], "plain_ms": res["plain_ms"][name],
         "bound_ms": res["bound"][name][0], "bound_by": res["bound"][name][1],
         "library_ms": None}
        for name, (replaces, src) in KERNELS.items()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
