"""Command-line interface of the PyTorch / CUDA port.

    python -m weightedld_tpu_torch.cli --file X.vcf [--device cuda|cpu]

The dispatch of ``weightedld_tpu/cli.py``, every flag of its
``build_parser`` (``:26-257``) with the same choices, defaults, validations,
exit codes and first line of standard error on an error, and the same
output bytes: ingest (the native reader when it is built; the Rust
binary's FASTA framing with ``--fasta-reader rust``), masks and Henikoff
weights on the host (the ``paper`` formula and inputs over 200M cells on
the device), then the dense engine (S <= 2048 by default), the f64
``reference`` audit engine, or the tiled session with the CUDA kernels; the
4-dp TSV, the PLINK layout (``--out-format plink``), ``--sort``, the
checkpointed ``run_to_tsv`` (``--checkpoint``), the analytics modes, the
prepared cache (``--save-prepared`` / ``--load-prepared``), ``--site-stats``,
``--compat rust``, progress reports, ``--profile-dir`` (a
``torch.profiler`` trace) and ``-v``.  The port's ``--device`` (default
``cuda``; no card is an error, never a silent CPU run) picks the device
type.  ``--devices N`` shards the tiled session over the first N cards
(all by default; on ``--device cpu``, N CPU shards).  ``--coordinator``,
``--num-processes`` and ``--process-id`` (or the ``JAX_*`` variables, or
an ``srun`` step) bring up a gloo process group first
(``parallel/multihost.py``): every process runs the same command line,
drives its own shards, and only process 0 writes or prints output
(``cli.py:336-351`` and its ``emit`` gates).  The dense and reference
engines stay on one device, as in the JAX CLI.

Output order: the dense and reference engines emit pairs in (site_a,
site_b) row-major order like the Python reference; the tiled engine in tile
order like the Rust reference's PairStore (``lib.rs:523-576``), or sorted
by (posa, posb) with ``--sort``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from . import __version__

    p = argparse.ArgumentParser(
        prog="weightedld-tpu-torch",
        description="Weighted linkage disequilibrium (D, D', r2) with "
        "Henikoff sequence weighting, on PyTorch / CUDA")
    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("--file", type=Path, default=None,
                   help="input alignment: .fasta/.fa, or a multi-sample "
                   ".vcf / .vcf.gz; required unless --load-prepared is "
                   "given")
    p.add_argument("--min-acgt", type=float, default=0.8,
                   help="minimum fraction of A/C/G/T at a site (strict >) "
                   "[default 0.8]")
    p.add_argument("--min-variability", type=float, default=0.02,
                   help="minimum minor-symbol fraction (>=) for LD sites "
                   "[default 0.02]")
    p.add_argument("--unweighted", action="store_true",
                   help="use unit weights instead of Henikoff weights")
    p.add_argument("--max-minor", type=float, default=1.0,
                   help="maximum dominant-minor fraction for LD sites "
                   "(Rust-reference flag; 1.0 disables) [default 1.0]")
    p.add_argument("--r2-threshold", type=float, default=None,
                   help="only emit pairs with r2 strictly above this "
                   "(default: every surviving pair, as the Python "
                   "reference; the Rust reference's default is 0.1)")
    p.add_argument("--pair-output", type=Path, default=None,
                   help="pair TSV output path (default: stdout; '-' = "
                   "stdout; .gz compresses)")
    p.add_argument("--weights-output", type=Path, default=None,
                   help="optional per-sequence weights TSV")
    p.add_argument("--weight-mask", choices=("ld", "hk"), default="ld",
                   help="alignment trim used for weighting: 'ld' matches the "
                   "reference CLI, 'hk' its test-suite convention")
    p.add_argument("--compat", choices=("python", "rust"), default="python",
                   help="semantics preset: 'python' reproduces WeightedLD.py "
                   "(default); 'rust' the reference Rust binary (paper-"
                   "formula weights, dominant-minor site filter, r2 > 0.1 "
                   "output threshold, 3-dp TSV, its FASTA reader); explicit "
                   "flags still override")
    p.add_argument("--fasta-reader", choices=("python", "rust"),
                   default=None,  # None = follow --compat (explicit wins)
                   help="FASTA ingest semantics: 'python' = BioPython-style "
                   "(wrapped records concatenated, as WeightedLD.py); "
                   "'rust' = the Rust binary's line reader (every line its "
                   "own sequence, terminators kept as Unknown, ragged "
                   "lengths abort); --compat rust selects it")
    p.add_argument("--weighting", choices=("python", "paper"),
                   default="python",
                   help="Henikoff formula: 'python' = reference "
                   "WeightedLD.py semantics (default), 'paper' = the "
                   "Henikoff-1994 per-site-distinct formula (the "
                   "reference's Rust variant), computed in float32 on the "
                   "--device")
    p.add_argument("--engine",
                   choices=("auto", "dense", "tiled", "reference"),
                   default="auto",
                   help="dense: one all-pairs program (small S); tiled: "
                   "batched tile session with the CUDA kernels, for any "
                   "input including ambiguity codes; reference: the exact-"
                   "f64 Python audit engine (tiny inputs only) [default "
                   "auto: dense for S <= 2048]")
    p.add_argument("--tile", type=int, default=None,
                   help="site-tile side of the tiled engine (default 256)")
    p.add_argument("--seq-chunk", type=int, default=None,
                   help="sequence columns per f32 combine of the kernel, a "
                   "multiple of 4 (default: all of N in one chunk, rounded "
                   "up to 64; set it explicitly to resume a checkpoint "
                   "taken under another auto policy)")
    p.add_argument("--weight-quant",
                   choices=("none", "split_bf16", "lo_int8", "int8",
                            "int8x3"),
                   default="none",
                   help="weighted-pass arithmetic of the tiled kernel: none "
                   "= int8x3 (full accuracy), split_bf16, lo_int8 and int8 "
                   "(lossy)")
    p.add_argument("--devices", type=int, default=None,
                   help="use only the first N local devices (default: all "
                   "visible cards; on --device cpu, N CPU shards, default "
                   "1)")
    p.add_argument("--tiles-per-batch", type=int, default=None,
                   help="tiles per device per kernel launch (default: "
                   "auto)")
    p.add_argument("--checkpoint", action="store_true",
                   help="enable batch-level resume for --pair-output runs "
                   "(tiled engine; a .gz output is written as per-batch "
                   "gzip members so that resume stays byte-exact)")
    p.add_argument("--ndigits", type=int, default=4,
                   help="output rounding digits [default 4, as reference]")
    p.add_argument("--out-format", choices=("tsv", "plink"), default="tsv",
                   help="pair-record format: 'tsv' = the reference's "
                   "posa/posb/D/D'/R2 rows; 'plink' = PLINK --r2 dprime "
                   "columns (CHR_A BP_A SNP_A CHR_B BP_B SNP_B R2 DP, plus "
                   "a trailing D) with CHROM/ID from the VCF (FASTA sites "
                   "get chromosome 0 and site<idx> ids); needs --file (a "
                   "prepared cache stores no CHROM/ID columns)")
    p.add_argument("--stats-only", action="store_true",
                   help="print a JSON summary instead of per-pair records")
    p.add_argument("--matrix-output", type=Path, default=None,
                   help="write full square LD matrices (d, d_prime, r2 as "
                   "[S,S] with NaN off-pairs, keep mask, site_map) to this "
                   ".npz instead of per-pair records; O(S^2) host memory, "
                   "so bounded to S <= 32768")
    p.add_argument("--matrix-dtype", choices=("float32", "float16"),
                   default="float32",
                   help="matrix export precision: float16 halves the "
                   "device->host transfer and file size (values within "
                   "2^-11 relative of float32) [default float32]")
    p.add_argument("--save-prepared", type=Path, default=None,
                   help="save encoded alignment/masks/weights to an .npz "
                   "cache after ingest")
    p.add_argument("--load-prepared", type=Path, default=None,
                   help="skip ingest; load a prepared .npz cache (overrides "
                   "--file)")
    p.add_argument("--profile-dir", type=Path, default=None,
                   help="write a torch.profiler trace of the job, from "
                   "ingest to the last write (Chrome trace JSON; CUDA and "
                   "CPU activity on the card, the program's wld.* ranges) "
                   "to this directory")
    p.add_argument("--chrom", type=str, default=None,
                   help="VCF only: keep records of this chromosome (CHROM "
                   "column) — the reference ignores CHROM, so whole-genome "
                   "VCFs mix chromosomes into one position axis; required "
                   "for per-chromosome --ld-decay/--prune-r2 on such files")
    p.add_argument("--region", type=str, default=None, metavar="CHR[:LO-HI]",
                   help="VCF only: keep records of this samtools-style "
                   "region — a chromosome name, optionally with a 1-based "
                   "inclusive POS window (e.g. chr19:44890000-44890200). "
                   "Bare CHR equals --chrom CHR (the two flags are "
                   "mutually exclusive); composable with --stream-ingest")
    p.add_argument("--cross-regions", type=str, nargs=2, default=None,
                   metavar=("A", "B"),
                   help="VCF only: inter-region (rectangular) LD — compute "
                   "ONLY pairs with one site in region A and one in region "
                   "B (each a samtools-style CHR[:LO-HI]; disjoint, may be "
                   "different chromosomes).  Weights are Henikoff over the "
                   "combined A+B sites; posa comes from A, posb from B.  "
                   "O(|A|*|B|) work instead of the full triangle; forces "
                   "the tiled engine; exclusive with --chrom/--region and "
                   "the window flags")
    p.add_argument("--keep-samples", type=str, default=None, metavar="SPEC",
                   help="restrict the analysis to these sequences/samples "
                   "BEFORE masking and weighting: a comma-separated list "
                   "of FASTA record names or VCF header sample names, or "
                   "@FILE with one name per line (both haplotypes of a "
                   "kept VCF sample are kept); unknown names are an error")
    p.add_argument("--exclude-samples", type=str, default=None,
                   metavar="SPEC",
                   help="drop these sequences/samples (same SPEC form as "
                   "--keep-samples; applied after it)")
    p.add_argument("--site-stats", type=Path, default=None,
                   help="write a per-site diagnostic TSV (coverage, major "
                   "code, minor fraction, hk/ld mask verdicts) over ALL "
                   "input sites and exit ('-' = stdout; VCF rows are "
                   "informational: no mask is applied on that path, as in "
                   "the reference)")
    p.add_argument("--list-chroms", action="store_true",
                   help="VCF only: print the distinct CHROM values (one per "
                   "line, file order) and exit — the valid --chrom "
                   "arguments for a per-chromosome analysis loop")
    p.add_argument("--max-distance", type=int, default=None,
                   help="windowed LD: only compute pairs at most this many "
                   "kept sites apart (prunes the tile plan to an O(S*W) "
                   "band; forces the tiled engine)")
    p.add_argument("--max-distance-bp", type=int, default=None,
                   help="windowed LD in site_map units — base pairs for "
                   "VCF input (PLINK-style bp window; consistent with "
                   "--ld-decay's distance axis), original column indices "
                   "for FASTA.  Prunes the tile plan like --max-distance "
                   "(composable: intersection) and forces the tiled "
                   "engine; needs non-decreasing positions (use --chrom "
                   "on whole-genome VCFs)")
    p.add_argument("--ld-decay", type=str, default=None, metavar="EDGES",
                   help="print a JSON LD-decay curve (kept-pair count, mean "
                   "r2 and mean |D'| per distance bin) instead of pair "
                   "records; EDGES = comma-separated ascending bin edges in "
                   "site_map units (bp for VCF), e.g. 0,1000,10000,100000")
    p.add_argument("--r2-hist", type=str, default=None, metavar="EDGES",
                   help="print a JSON histogram of r2 over surviving pairs "
                   "(the way to pick a threshold); EDGES = comma-separated "
                   "ascending bin edges, e.g. 0,0.05,0.1,0.2,0.5,1.01")
    p.add_argument("--prune-r2", type=float, default=None, metavar="THR",
                   help="LD pruning: print the positions of a subset of "
                   "sites in which no surviving pair has r2 > THR (greedy, "
                   "PLINK --indep-pairwise style; combine with "
                   "--max-distance for windowed pruning)")
    p.add_argument("--prune-rule", choices=("maf", "first"), default="maf",
                   help="which endpoint of a conflicting pair to drop: "
                   "'maf' = the lower-minor-allele-frequency site "
                   "(default), 'first' = always the later site")
    p.add_argument("--top", type=int, default=None, metavar="K",
                   help="emit only the K strongest surviving pairs by r2 "
                   "(descending), threshold-free; the tiled engine selects "
                   "on the device, O(K) host traffic per batch")
    p.add_argument("--sort", action="store_true",
                   help="sort tiled-engine output by (posa, posb) like the "
                   "Python reference (collects all records in memory; the "
                   "default streams in tile order like the Rust reference)")
    p.add_argument("--stream-ingest", action="store_true",
                   help="two-pass streaming ingest straight into the "
                   "session's padded site-major layout (VCF, or FASTA with "
                   "the default reader/weight-mask): peak host memory is "
                   "one padded matrix.  Records equal the default "
                   "readers'; Henikoff weights run chunked in f64 (equal "
                   "to the default's up to summation order, ~1 ulp).  Runs "
                   "the tiled engine; incompatible with --save-prepared and "
                   "--weighting paper")
    p.add_argument("--coordinator", type=str, default=None,
                   metavar="HOST:PORT",
                   help="process-group coordinator address for manual "
                   "multi-process bring-up (an srun step is detected "
                   "without any flags; every process runs the SAME command "
                   "line and only process 0 writes output)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total process count for manual distributed "
                   "bring-up (with --coordinator/--process-id)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank for manual distributed bring-up "
                   "(with --coordinator/--num-processes)")
    p.add_argument("--progress", action="store_true",
                   help="log pairs/s progress to stderr")
    p.add_argument("--progress-bar", action="store_true",
                   help="live stderr progress bar with percent/rate/ETA "
                   "(the Rust binary's indicatif analog; in place on a TTY, "
                   "one line per update otherwise; overrides --progress)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; fails without a "
                   "card) or cpu (the kernels' plain PyTorch versions)")
    return p


def _chrom_range(args):
    """``(chrom, pos_range)`` from --chrom / --region (``cli.py:271-279``;
    their exclusivity is checked up front in :func:`main`)."""
    if args.region is not None:
        from .io.vcf import parse_region

        return parse_region(args.region)
    return args.chrom, None


def _parse_sample_spec(spec: str | None) -> tuple[str, ...] | None:
    """``--keep-samples`` / ``--exclude-samples`` SPEC -> names
    (``cli.py:282-297``): ``@FILE`` reads one name per line (blank lines
    and ``#`` comments skipped, the plink keep-file convention), anything
    else is a comma-separated list."""
    if spec is None:
        return None
    if spec.startswith("@"):
        with open(spec[1:], encoding="utf-8") as fh:
            names = [ln.strip() for ln in fh]
        names = [n for n in names if n and not n.startswith("#")]
    else:
        names = [n.strip() for n in spec.split(",") if n.strip()]
    if not names:
        raise ValueError(f"empty sample list: {spec!r}")
    return tuple(names)


def _is_vcf(path) -> bool:
    return str(path).endswith((".vcf", ".vcf.gz"))


def _prune_site_id(annot, pos: int) -> str:
    """SNP id of a ``--prune-r2`` output line (``cli.py:259-268``): a site
    can come from either block under --cross-regions, so both maps are
    consulted; a POS both blocks carry with different ids is ambiguous
    (``.``)."""
    a = annot.id_of.get(pos)
    b = (annot.id_of_b or {}).get(pos)
    if a is not None and b is not None and a != b:
        return "."
    return a if a is not None else (b if b is not None else ".")


def _arg_errors(args) -> str | None:
    """The region, cross and window conflicts the JAX CLI refuses before
    any ingest (``cli.py:420-464``), as the message of the first."""
    if args.chrom is not None and args.region is not None:
        return ("--chrom and --region are mutually exclusive (a region "
                "names its chromosome)")
    for flag, val in (("--chrom", args.chrom), ("--region", args.region),
                      ("--cross-regions", args.cross_regions)):
        if val is not None and args.file is not None \
                and not _is_vcf(args.file):
            return (f"{flag} only applies to VCF input (FASTA has no "
                    "chromosome column)")
    if args.cross_regions is None:
        return None
    conflicts = [f for f, on in (
        ("--chrom", args.chrom is not None),
        ("--region", args.region is not None),
        ("--max-distance", args.max_distance is not None),
        ("--max-distance-bp", args.max_distance_bp is not None),
        ("--stream-ingest", args.stream_ingest),
        ("--save-prepared", args.save_prepared is not None),
        ("--load-prepared", args.load_prepared is not None),
        ("--site-stats", args.site_stats is not None),
        ("--list-chroms", args.list_chroms),
    ) if on]
    if conflicts:
        return f"--cross-regions is exclusive with {conflicts[0]}"
    if args.engine in ("dense", "reference"):
        return ("--cross-regions needs the tiled engine (--engine "
                f"{args.engine} computes the full triangle)")
    if args.file is None:
        return "--cross-regions needs --file"
    if args.ld_decay is not None:
        from .io.vcf import parse_region

        if parse_region(args.cross_regions[0])[0] \
                != parse_region(args.cross_regions[1])[0]:
            return ("--ld-decay with --cross-regions needs both regions on "
                    "ONE chromosome (POS distance between chromosomes is "
                    "meaningless)")
    return None


def _mode_errors(args, modes: list[str]) -> str | None:
    """The output-mode, PLINK, prepared-cache and checkpoint conflicts the
    JAX CLI refuses first (``cli.py:362-405``)."""
    if len(modes) > 1:
        return f"{' and '.join(modes)} are mutually exclusive output modes"
    if args.out_format == "plink":
        # --top writes pair records and --prune-r2 a site list (SNP ids in
        # plink mode, the plink --extract format); the other modes write
        # JSON or TSV of their own shape.
        non_pair = [m for m in modes if m not in ("--top", "--prune-r2")]
        if non_pair:
            return (f"--out-format plink only applies to pair-record "
                    f"output, not {non_pair[0]}")
        if args.load_prepared is not None:
            return ("--out-format plink needs --file (a prepared cache "
                    "stores no CHROM/ID columns)")
    if (args.list_chroms or args.site_stats is not None) \
            and args.save_prepared is not None:
        return ("--save-prepared has no effect with a pre-analysis query "
                "mode (--list-chroms/--site-stats); run them separately")
    return None


def _apply_compat(args) -> None:
    """The ``--compat rust`` preset (``cli.py:406-418``): the reference
    Rust binary's defaults (``main.rs:19-68``), where the flag was left at
    its default; then ``--fasta-reader`` follows ``--compat`` unless
    given."""
    if args.compat == "rust":
        if args.weighting == "python":
            args.weighting = "paper"
        if args.r2_threshold is None:
            args.r2_threshold = 0.1
        if args.ndigits == 4:
            args.ndigits = 3
        if args.max_minor == 1.0:
            args.max_minor = 0.5
    if args.fasta_reader is None:
        args.fasta_reader = "rust" if args.compat == "rust" else "python"


def _stream_errors(args) -> str | None:
    """The refusals of ``--stream-ingest`` (``cli.py:562-592``)."""
    if not _is_vcf(args.file):
        if args.fasta_reader != "python":
            return ("--stream-ingest streams the default (python/"
                    "BioPython) FASTA framing only; drop --fasta-reader "
                    "rust / --compat rust")
        if args.weight_mask != "ld":
            return ("--stream-ingest weights the LD-trimmed buffer (the "
                    "reference CLI convention); --weight-mask hk needs the "
                    "row-major reader")
    if args.save_prepared is not None:
        return ("--save-prepared needs the sequence-major matrix; drop "
                "--stream-ingest to cache this input")
    if args.weighting != "python":
        return "--stream-ingest supports the default (python) weighting only"
    if args.engine in ("dense", "reference"):
        return (f"--stream-ingest requires the tiled engine (--engine "
                f"{args.engine} holds the matrix in sequence-major form)")
    return None


def _json_line(out: dict, t0: float) -> None:
    out["elapsed_s"] = time.monotonic() - t0
    print(json.dumps(out))


def _empty_output(args, res, n: int, s: int, annot) -> int:
    """Fewer than 2 sites: each output mode writes its own empty result
    (``weightedld_tpu/cli.py:749-818``)."""
    from .io.writer import open_text_output, pair_header
    from .runtime.driver import validate_decay_edges, validate_hist_edges

    if args.matrix_output is not None:
        np.savez_compressed(
            args.matrix_output, site_map=res.site_map,
            keep=np.zeros((s, s), dtype=bool),
            **{k: np.full((s, s), np.nan, dtype=np.float32)
               for k in ("d", "d_prime", "r2")})
        return 0
    if args.stats_only:
        print(json.dumps({"n_sequences": n, "n_sites": s, "n_pairs": 0,
                          "n_over_threshold": 0,
                          "r2_sum_over_threshold": 0.0, "r2_max": None}))
        return 0
    if args.ld_decay is not None:
        try:
            edges = validate_decay_edges(args.ld_decay.split(","))
        except ValueError as e:
            print(f"error: --ld-decay: {e}", file=sys.stderr)
            return 2
        nb = len(edges) - 1
        print(json.dumps({"edges": list(edges), "n_pairs": [0] * nb,
                          "r2_sum": [0.0] * nb, "r2_mean": [None] * nb,
                          "abs_d_prime_sum": [0.0] * nb,
                          "abs_d_prime_mean": [None] * nb,
                          "n_d_prime_finite": [0] * nb}))
        return 0
    if args.r2_hist is not None:
        try:
            edges = validate_hist_edges(args.r2_hist.split(","))
        except ValueError as e:
            print(f"error: --r2-hist: {e}", file=sys.stderr)
            return 2
        print(json.dumps({"edges": list(edges),
                          "n_pairs": [0] * (len(edges) - 1)}))
        return 0
    body = pair_header(annot) + "\n"
    if args.prune_r2 is not None:
        # A lone site is trivially conflict-free: its position (its SNP id
        # in plink mode).
        body = "".join(
            (_prune_site_id(annot, int(p)) if annot is not None
             else str(int(p))) + "\n" for p in res.site_map)
    with open_text_output(args.pair_output if args.pair_output
                          else "-") as fh:
        fh.write(body)
    return 0


def _prepare_streamed(args, timer):
    """The ``--stream-ingest`` preparation: ``(SiteMajorCodes, site_map,
    weights)`` as a ``PipelineResult``, the buffer sized for the session
    the output mode builds (the same ``--tile`` / ``--seq-chunk``)."""
    from .core.henikoff import henikoff_weights_host_site_major
    from .pipeline import PipelineResult
    from .runtime.driver import DriverConfig
    from .runtime.ingest import prepare_fasta_streamed, prepare_vcf_streamed
    from .runtime.profiling import annotate, span

    stream_cfg = DriverConfig(tile=args.tile, seq_chunk=args.seq_chunk)
    hk_mask = ld_mask = None
    if _is_vcf(args.file):
        chrom, pos_range = _chrom_range(args)
        with timer.stage("ingest"), span("ingest.read") as sp:
            sm, site_map = prepare_vcf_streamed(
                args.file, stream_cfg, chrom=chrom, pos_range=pos_range,
                keep_samples=args.keep_samples,
                exclude_samples=args.exclude_samples)
    else:
        with timer.stage("ingest"), span("ingest.read") as sp:
            sm, site_map, hk_mask, ld_mask = prepare_fasta_streamed(
                args.file, min_acgt=args.min_acgt,
                min_variability=args.min_variability,
                max_minor=args.max_minor, cfg=stream_cfg,
                keep_samples=args.keep_samples,
                exclude_samples=args.exclude_samples)
    if sp:
        sp.set(bytes=Path(args.file).stat().st_size, sites=sm.n_sites)
    with timer.stage("weights"):
        if args.unweighted:
            weights = np.ones(sm.n_seqs, dtype=np.float32)
        else:
            annotate(path="host_f64", cells=sm.n_seqs * sm.n_sites)
            weights = henikoff_weights_host_site_major(
                sm.codes, sm.n_sites, sm.n_seqs)
    return PipelineResult(alignment=sm, site_map=site_map, weights=weights,
                          hk_mask=hk_mask, ld_mask=ld_mask)


def _plink_annot(args, res):
    """The ``--out-format plink`` identity maps (``cli.py:666-735``): from
    the VCF's CHROM / ID columns (per block under --cross-regions, both in
    one pass), or chromosome 0 and ``site<idx>`` ids for a FASTA.  A POS on
    two chromosomes raises ``VcfError`` (the CHR columns would lie); a POS
    with two ids on one chromosome keeps the first id, with one warning."""
    from .io.writer import PairAnnot

    if not _is_vcf(args.file):
        sm = [int(p) for p in np.asarray(res.site_map)]
        return PairAnnot({p: "0" for p in sm}, {p: f"site{p}" for p in sm})
    from .io.vcf import (
        VcfError,
        parse_region,
        site_annotations,
        site_annotations_multi,
    )

    def maps(chrom, pos_range, ann=None):
        pos, chroms, ids = ann if ann is not None \
            else site_annotations(args.file, chrom, pos_range)
        co: dict[int, str] = {}
        io_: dict[int, str] = {}
        warned = False
        for p, c, i in zip(pos.tolist(), chroms, ids):
            if p in co and co[p] != c:
                raise VcfError(
                    f"--out-format plink: POS {p} appears on two "
                    f"chromosomes ({co[p]} and {c}) — whole-genome VCFs "
                    "mix chromosomes into one position axis; run per "
                    "chromosome with --chrom/--region")
            if p in co and io_[p] != i:
                if not warned:
                    print(f"warning: --out-format plink: multiple records "
                          f"share POS {p} ({io_[p]}, {i}); SNP id columns "
                          "use the first-seen id for such sites",
                          file=sys.stderr)
                    warned = True
                continue
            co[p] = c
            io_[p] = i
        return co, io_

    if args.cross_regions is not None:
        ca, ra = parse_region(args.cross_regions[0])
        cb, rb = parse_region(args.cross_regions[1])
        ann_a, ann_b = site_annotations_multi(args.file,
                                              [(ca, ra), (cb, rb)])
        return PairAnnot(*maps(ca, ra, ann_a), *maps(cb, rb, ann_b))
    return PairAnnot(*maps(*_chrom_range(args)))


def main(argv=None, timer=None) -> int:
    """CLI entry point; ``timer`` (a ``runtime.profiling.StageTimer``)
    collects the per-stage spans.  The job is the root span ``job``, with
    its exit code as the attribute ``rc``; ``--profile-dir`` traces it
    from its first stage to its last write."""
    from .runtime.profiling import span

    with span("job") as job, contextlib.ExitStack() as scope:
        rc = _main(argv, timer, scope)
        if job:
            job.set(rc=rc)
        return rc


def _main(argv, timer, scope: contextlib.ExitStack) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        format="[%(levelname)s] %(asctime)s %(message)s",
        level=logging.INFO if args.verbose else logging.ERROR,
        datefmt="%Y-%m-%d %H:%M:%S", stream=sys.stderr, force=True)
    log = logging.getLogger("weightedld_tpu_torch")

    # The process group first, before any device use: a launcher runs this
    # same command line in every process; each drives its shards and only
    # process 0 prints or writes (cli.py:336-351).
    from .parallel.multihost import initialize_distributed, is_output_process

    try:
        initialize_distributed(coordinator_address=args.coordinator,
                               num_processes=args.num_processes,
                               process_id=args.process_id)
    except (RuntimeError, ValueError) as e:
        print(f"error: distributed bring-up failed: {e}", file=sys.stderr)
        return 2
    emit = is_output_process()

    # One output mode per invocation, and the checks that come before any
    # other (weightedld_tpu/cli.py:362-405).
    modes = [name for name, on in (
        ("--matrix-output", args.matrix_output is not None),
        ("--stats-only", args.stats_only),
        ("--ld-decay", args.ld_decay is not None),
        ("--r2-hist", args.r2_hist is not None),
        ("--top", args.top is not None),
        ("--prune-r2", args.prune_r2 is not None),
        ("--site-stats", args.site_stats is not None),
        ("--list-chroms", args.list_chroms),
    ) if on]
    msg = _mode_errors(args, modes)
    if msg is not None:
        print(f"error: {msg}", file=sys.stderr)
        return 2
    if args.matrix_output is not None and args.r2_threshold is not None:
        print("warning: --matrix-output writes complete matrices; "
              "--r2-threshold is ignored in this mode", file=sys.stderr)
    if args.checkpoint and str(args.pair_output) == "-":
        print("error: --checkpoint needs a real --pair-output file "
              "(resume truncates to a recorded byte offset; stdout has "
              "none)", file=sys.stderr)
        return 2
    _apply_compat(args)
    msg = _arg_errors(args)
    if msg is not None:
        print(f"error: {msg}", file=sys.stderr)
        return 2
    try:
        args.keep_samples = _parse_sample_spec(args.keep_samples)
        args.exclude_samples = _parse_sample_spec(args.exclude_samples)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    import torch

    from .device import resolve_device
    from .io.writer import open_text_output, write_pairs, write_weights
    from .parallel.multihost import global_shard_count, local_devices
    from .pipeline import WldConfig, prepare
    from .runtime.profiling import StageTimer, device_trace

    try:
        device = resolve_device(args.device)
        # The tiled session's shard devices; every process must have as
        # many (checked across the group before any ingest).
        devices = local_devices(device, args.devices)
        global_shard_count(len(devices))
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 contractions
    timer = timer or StageTimer()
    scope.enter_context(device_trace(args.profile_dir, device))
    if args.list_chroms:
        # A query answered before any ingest (cli.py:469-485); like the JAX
        # CLI it ignores --region and the sample flags (ROADMAP queue 3).
        if args.file is None or not _is_vcf(args.file):
            print("error: --list-chroms needs a VCF --file (FASTA has no "
                  "chromosome column)", file=sys.stderr)
            return 2
        from .io.vcf import VcfError, list_chromosomes

        try:
            for c in list_chromosomes(args.file):
                if emit:
                    print(c)
        except (VcfError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        return 0

    cfg = WldConfig(min_acgt=args.min_acgt,
                    min_variability=args.min_variability,
                    unweighted=args.unweighted, max_minor=args.max_minor,
                    r2_threshold=args.r2_threshold,
                    weight_mask=args.weight_mask, weighting=args.weighting,
                    chrom=args.chrom, fasta_reader=args.fasta_reader,
                    region=args.region, keep_samples=args.keep_samples,
                    exclude_samples=args.exclude_samples)

    if args.site_stats is not None:
        # A report over the original (unmasked) sites: it needs the input
        # file, not a prepared cache, which holds the trimmed sites.
        if args.file is None:
            print("error: --site-stats needs --file (a prepared cache holds "
                  "only the trimmed sites)", file=sys.stderr)
            return 2
        from .io.writer import write_site_stats
        from .pipeline import site_stats

        try:
            stats = site_stats(args.file, cfg)
        except (ValueError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if not emit:
            return 0
        with open_text_output(args.site_stats) as fh:
            write_site_stats(stats, fh)
        return 0

    cross_split = None
    prep_keys = ("min_acgt", "min_variability", "unweighted", "max_minor",
                 "weight_mask", "weighting", "chrom", "fasta_reader",
                 "region", "keep_samples", "exclude_samples")
    t0 = time.monotonic()
    if args.load_prepared:
        from .runtime.cache import load_prepared

        res, prep = load_prepared(args.load_prepared)
        # The preparation happened at save time: warn where the flags given
        # now differ from it (they are not applied again).  Sample lists
        # are stored as JSON arrays; keys an older cache lacks take the
        # value its code used (cli.py:538-560).
        wanted = {k: (list(v) if isinstance(v := getattr(cfg, k), tuple)
                      else v) for k in prep_keys}
        legacy_defaults = {"chrom": None, "fasta_reader": "python",
                           "region": None, "keep_samples": None,
                           "exclude_samples": None}
        stored = {k: prep.get(k, legacy_defaults.get(k, wanted[k]))
                  for k in prep_keys}
        diffs = {k: (stored[k], wanted[k]) for k in prep_keys
                 if stored[k] != wanted[k]}
        if diffs:
            print("warning: --load-prepared ignores preparation flags; "
                  f"cached vs requested: {diffs}", file=sys.stderr)
    elif args.file is not None and args.stream_ingest:
        msg = _stream_errors(args)
        if msg is not None:
            print(f"error: {msg}", file=sys.stderr)
            return 2
        try:
            res = _prepare_streamed(args, timer)
        except (ValueError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    elif args.file is not None and args.cross_regions is not None:
        from .pipeline import prepare_vcf_cross

        try:
            res, cross_split = prepare_vcf_cross(
                args.file, cfg, args.cross_regions[0],
                args.cross_regions[1], timer=timer, device=device)
        except (ValueError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    elif args.file is not None:
        try:
            res = prepare(args.file, cfg, timer=timer, device=device)
        except (ValueError, OSError) as e:  # VcfError, ragged FASTA, missing
            print(f"error: {e}", file=sys.stderr)
            return 2
    else:
        print("error: --file or --load-prepared is required",
              file=sys.stderr)
        return 2
    if args.save_prepared and emit:
        from .runtime.cache import save_prepared

        save_prepared(args.save_prepared, res,
                      {k: getattr(cfg, k) for k in prep_keys})
    from .runtime.driver import SiteMajorCodes

    streamed = isinstance(res.alignment, SiteMajorCodes)
    if streamed:
        n, s = res.alignment.n_seqs, res.alignment.n_sites
    else:
        n, s = res.alignment.shape
    log.info("prepared %d sequences x %d LD sites in %.2fs", n, s,
             time.monotonic() - t0)

    annot = None
    if args.out_format == "plink":
        from .io.vcf import VcfError

        try:
            annot = _plink_annot(args, res)
        except (VcfError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    if args.max_distance_bp is not None:
        # Before any upload (cli.py:733-743): the session's own check
        # would raise after the set-up work.
        sm = np.asarray(res.site_map)
        if (np.diff(sm) < 0).any() or (
                sm.size and (sm.min() < 0
                             or sm.max() > np.iinfo(np.int32).max)):
            print("error: --max-distance-bp needs non-decreasing site "
                  "positions that fit int32 (multi-chromosome input? "
                  "run per chromosome with --chrom)", file=sys.stderr)
            return 2

    if args.weights_output and emit:
        with open_text_output(args.weights_output) as fh:
            write_weights(res.weights, fh)

    if s < 2:
        log.info("fewer than 2 sites of interest; nothing to do")
        if not emit:
            return 0
        return _empty_output(args, res, n, s, annot)

    engine = args.engine
    if engine == "auto":
        engine = "dense" if s <= 2048 else "tiled"
    if args.max_distance is not None or args.max_distance_bp is not None \
            or args.cross_regions is not None or streamed:
        # The window and rectangle masks live in the tiled session, and a
        # streamed buffer is laid out for it (cli.py:820-828).
        engine = "tiled"
    if args.weight_quant != "none" and engine != "tiled" \
            and args.matrix_output is None:
        print(f"warning: --weight-quant only applies to the tiled engine; "
              f"the '{engine}' engine runs the exact path (add --engine "
              "tiled to use it)", file=sys.stderr)

    on_progress = None
    if not emit:
        pass  # one progress reporter per run: the output process's
    elif args.progress_bar:
        from .io.progressbar import ProgressBar

        on_progress = ProgressBar(sys.stderr)
    elif args.progress:
        def on_progress(p):
            print(f"[progress] {p.pairs_done}/{p.pairs_total} pairs "
                  f"evaluated ({p.pairs_per_s:,.0f} pairs/s, "
                  f"{p.records_emitted} records)", file=sys.stderr)

    from .runtime.driver import (DriverConfig, LdSession, collect_ld_records,
                                 run_to_tsv, validate_decay_edges,
                                 validate_hist_edges)

    # Every tiled session of this run, records and analytics alike, takes
    # the window and cross fields from here (cli.py:300-324).
    dcfg = DriverConfig(tile=args.tile,
                        tiles_per_shard_batch=args.tiles_per_batch,
                        r2_threshold=args.r2_threshold,
                        seq_chunk=args.seq_chunk,
                        weight_quant=args.weight_quant,
                        max_site_distance=args.max_distance,
                        max_bp_distance=args.max_distance_bp,
                        cross_split=cross_split)

    def session(r2_threshold=None) -> LdSession:
        """The tiled session of the analytics modes, which set their own
        threshold."""
        with timer.stage("upload"):
            return LdSession(res.alignment, res.weights, res.site_map,
                             replace(dcfg, r2_threshold=r2_threshold),
                             devices=devices)

    def dense_stats():
        from .core.ld_dense import ld_all_pairs_dense

        return ld_all_pairs_dense(
            torch.from_numpy(np.ascontiguousarray(res.alignment)).to(device),
            torch.from_numpy(np.asarray(res.weights, np.float32)).to(device))

    def pair_out():
        return open_text_output(args.pair_output if args.pair_output
                                else "-")

    if args.matrix_output is not None:
        if s > 32768:
            print(f"error: --matrix-output needs O(S^2) host memory; "
                  f"S={s} > 32768 kept sites — use the record outputs",
                  file=sys.stderr)
            return 2
        sess = session()
        with timer.stage("scan"):
            mats = sess.matrices(dtype=np.dtype(args.matrix_dtype))
        if not emit:
            return 0
        with timer.stage("write"):
            np.savez_compressed(args.matrix_output, site_map=res.site_map,
                                **mats)
        log.info("wrote %s (%d x %d, %d surviving pairs) in %.2fs",
                 args.matrix_output, s, s, int(mats["keep"].sum()),
                 time.monotonic() - t0)
        return 0

    if args.stats_only:
        if engine == "dense":
            with timer.stage("scan"):
                st = dense_stats()
                # Only the upper triangle counts.
                keep = torch.triu(st.keep, diagonal=1)
                over = keep if args.r2_threshold is None \
                    else keep & (st.r2 > args.r2_threshold)
                out = {"n_sequences": n, "n_sites": s,
                       "n_pairs": int(keep.sum()),
                       "n_over_threshold": int(over.sum()),
                       "r2_sum_over_threshold": float(st.r2[over].sum()),
                       "r2_max": float(st.r2[keep].max()) if bool(keep.any())
                       else None}
        else:
            sess = session(args.r2_threshold)
            with timer.stage("scan"):
                out = sess.summarize()
        if emit:
            _json_line(out, t0)
        return 0

    if args.ld_decay is not None:
        if args.r2_threshold is not None:
            print("warning: --ld-decay is threshold-free; --r2-threshold "
                  "is ignored in this mode", file=sys.stderr)
        if args.engine in ("dense", "reference"):
            print(f"warning: --ld-decay always runs the tiled session "
                  f"engine (--engine {args.engine} ignored)",
                  file=sys.stderr)
        try:
            # Before the upload: a bad edge list costs nothing.
            edges = validate_decay_edges(args.ld_decay.split(","))
        except ValueError as e:
            print(f"error: --ld-decay: {e}", file=sys.stderr)
            return 2
        sess = session()
        try:
            with timer.stage("scan"):
                out = sess.ld_decay(edges)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if emit:
            _json_line(out, t0)
        return 0

    if args.r2_hist is not None:
        try:
            edges = validate_hist_edges(args.r2_hist.split(","))
        except ValueError as e:
            print(f"error: --r2-hist: {e}", file=sys.stderr)
            return 2
        sess = session()
        with timer.stage("scan"):
            out = sess.r2_histogram(edges)
        if emit:
            _json_line(out, t0)
        return 0

    if args.prune_r2 is not None:
        if not np.isfinite(args.prune_r2):
            print(f"error: --prune-r2 needs a finite threshold, got "
                  f"{args.prune_r2}", file=sys.stderr)
            return 2
        if args.r2_threshold is not None:
            print("warning: --prune-r2 supplies its own threshold; "
                  "--r2-threshold is ignored in this mode", file=sys.stderr)
        if args.engine in ("dense", "reference"):
            print(f"warning: --prune-r2 always runs the tiled session "
                  f"engine (--engine {args.engine} ignored)",
                  file=sys.stderr)
        if len(np.unique(res.site_map)) != s:
            print("error: --prune-r2 needs unique site positions "
                  "(multi-chromosome input? run per chromosome)",
                  file=sys.stderr)
            return 2
        sess = session()
        try:
            with timer.stage("scan"):
                kept = sess.prune(args.prune_r2, rule=args.prune_rule,
                                  on_progress=on_progress)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if not emit:
            return 0
        with pair_out() as fh:
            # plink mode writes SNP ids, the plink --extract format.
            fh.write("".join(
                (_prune_site_id(annot, int(p)) if annot is not None
                 else str(int(p))) + "\n" for p in kept))
        log.info("kept %d of %d sites (r2 <= %g) in %.2fs", len(kept), s,
                 args.prune_r2, time.monotonic() - t0)
        return 0

    from .core.ld_dense import LdRecords, extract_records

    if args.top is not None:
        if args.top <= 0:
            print("error: --top needs a positive K", file=sys.stderr)
            return 2
        if args.r2_threshold is not None:
            print("warning: --top is threshold-free; --r2-threshold is "
                  "ignored in this mode", file=sys.stderr)
        if engine in ("dense", "reference"):
            st = dense_stats()
            rec = extract_records(st, res.site_map)
            order = np.argsort(-np.asarray(rec.r2), kind="stable")[:args.top]
            rec = LdRecords(*(np.asarray(f)[order] for f in rec))
        else:
            sess = session()
            with timer.stage("scan"):
                rec = sess.top_pairs(args.top)
        if not emit:
            return 0
        with pair_out() as fh:
            write_pairs(rec, fh, ndigits=args.ndigits, annot=annot)
        log.info("wrote top-%d pairs in %.2fs", len(rec),
                 time.monotonic() - t0)
        return 0

    if engine == "reference":
        from .core.reference_impl import reference_ld

        rows = reference_ld(res.alignment,
                            np.asarray(res.weights, np.float64),
                            res.site_map)
        records = LdRecords(*(np.asarray([r[k] for r in rows])
                              for k in range(5)))
        if args.r2_threshold is not None:
            m = records.r2 > args.r2_threshold
            records = LdRecords(*(np.asarray(f)[m] for f in records))
        if emit:
            with pair_out() as fh:
                write_pairs(records, fh, ndigits=args.ndigits, annot=annot)
    elif engine == "dense":
        with timer.stage("scan"):
            records = extract_records(dense_stats(), res.site_map,
                                      args.r2_threshold)
        if emit:
            with timer.stage("write"), pair_out() as fh:
                write_pairs(records, fh, ndigits=args.ndigits, annot=annot)
        log.info("wrote %d pairs in %.2fs", len(records),
                 time.monotonic() - t0)
    elif args.sort:
        with timer.stage("scan"):
            rec = collect_ld_records(res.alignment, res.weights,
                                     res.site_map, dcfg, devices=devices)
        if emit:
            with timer.stage("write"):
                order = np.lexsort((rec.pos_b, rec.pos_a))
                rec = LdRecords(*(np.asarray(f)[order] for f in rec))
                with pair_out() as fh:
                    write_pairs(rec, fh, ndigits=args.ndigits, annot=annot)
        log.info("wrote %d pairs (sorted) in %.2fs", len(rec),
                 time.monotonic() - t0)
    else:
        # A checkpoint needs a real output file; on standard output
        # --checkpoint is ignored, as in the JAX CLI (ROADMAP queue 3,
        # ADVICE cli.py:401).
        nrec = run_to_tsv(
            res.alignment, res.weights, res.site_map,
            args.pair_output if args.pair_output else "-", dcfg,
            devices=devices,
            checkpoint=args.checkpoint and args.pair_output is not None,
            ndigits=args.ndigits, on_progress=on_progress, timer=timer,
            annot=annot)
        log.info("wrote %d pairs in %.2fs", nrec, time.monotonic() - t0)
    if args.verbose and emit:
        log.info("stage report:\n%s", timer.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
