"""Command-line interface of the PyTorch / CUDA port.

    python -m weightedld_tpu_torch.cli --file X.vcf [--device cuda|cpu]

The main-path dispatch of ``weightedld_tpu/cli.py``: ingest (the native
reader when it is built), masks and Henikoff weights on the host (inputs
over 200M cells are weighted on the device), then the dense engine (S <=
2048 by default) or the tiled session with the CUDA kernels, and the 4-dp
TSV.  ``--stream-ingest`` (``cli.py:226-236, 556-630``) reads the file in
two passes straight into the session's padded site-major buffer, with
chunked float64 host weights, and always runs the tiled session.  Both
engines take any input, FASTA with ambiguity characters included: the tiled
session runs the factorized kernel wherever it is exact and the general
kernel on the tile pairs whose UNKNOWN codes it does not cover.
Supported flags: ``--file``, ``--min-acgt``, ``--min-variability``,
``--unweighted``, ``--r2-threshold``, ``--pair-output``, ``--engine
{auto,dense,tiled}``, ``--tile``, ``--seq-chunk``, ``--tiles-per-batch``,
``--weight-quant``, ``--ndigits``, ``--weights-output``,
``--stream-ingest``, the port's
``--device`` (default ``cuda``; no card is an error, never a silent CPU
run), the analytics output modes of ``weightedld_tpu/cli.py:857-1058``,
one per run: ``--stats-only`` (JSON summary), ``--top K``, ``--ld-decay
EDGES``, ``--r2-hist EDGES``, ``--prune-r2 THR`` with ``--prune-rule``, and
``--matrix-output`` with ``--matrix-dtype``; windowed LD (``--max-distance``,
``--max-distance-bp``) and inter-region LD (``--cross-regions``), which
run the tiled session; the VCF record filters ``--chrom`` and ``--region``,
``--list-chroms``, and the sample flags ``--keep-samples`` /
``--exclude-samples``, with the JAX CLI's validations and exit codes
(``cli.py:271-324, 420-470, 632-639, 733-743, 823-826``).  Every other flag
of the JAX CLI exits 2 with "not yet ported".

Output order: the dense engine emits pairs in (site_a, site_b) row-major
order like the Python reference; the tiled engine in tile order like the
Rust reference's PairStore (``lib.rs:523-576``).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

# Flags of the JAX CLI that this port does not take yet -> ROADMAP item.
NOT_PORTED = {
    **dict.fromkeys(("--version", "-v", "--verbose", "--max-minor",
                     "--weight-mask", "--compat", "--fasta-reader",
                     "--weighting", "--out-format", "--save-prepared",
                     "--load-prepared", "--site-stats", "--sort",
                     "--progress", "--progress-bar"),
                    "queue 1 item 10 (full CLI parity)"),
    **dict.fromkeys(("--checkpoint", "--profile-dir"),
                    "queue 1 item 12 (checkpoint, profiling)"),
    **dict.fromkeys(("--devices", "--coordinator", "--num-processes",
                     "--process-id"), "queue 1 item 13 (multiple GPUs)"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="weightedld-tpu-torch",
        description="Weighted linkage disequilibrium (D, D', r2) with "
        "Henikoff sequence weighting, on PyTorch / CUDA")
    p.add_argument("--file", type=Path, default=None,
                   help="input alignment: .fasta/.fa, or a multi-sample "
                   ".vcf / .vcf.gz")
    p.add_argument("--min-acgt", type=float, default=0.8,
                   help="minimum fraction of A/C/G/T at a site (strict >) "
                   "[default 0.8]")
    p.add_argument("--min-variability", type=float, default=0.02,
                   help="minimum minor-symbol fraction (>=) for LD sites "
                   "[default 0.02]")
    p.add_argument("--unweighted", action="store_true",
                   help="use unit weights instead of Henikoff weights")
    p.add_argument("--r2-threshold", type=float, default=None,
                   help="only emit pairs with r2 strictly above this "
                   "(default: every surviving pair)")
    p.add_argument("--pair-output", type=Path, default=None,
                   help="pair TSV output path (default: stdout; '-' = "
                   "stdout; .gz compresses)")
    p.add_argument("--weights-output", type=Path, default=None,
                   help="optional per-sequence weights TSV")
    p.add_argument("--engine", choices=("auto", "dense", "tiled"),
                   default="auto",
                   help="dense: one all-pairs program (small S); tiled: "
                   "batched tile session with the CUDA kernels, for any "
                   "input including ambiguity codes [default auto: dense "
                   "for S <= 2048]")
    p.add_argument("--tile", type=int, default=None,
                   help="site-tile side of the tiled engine (default 256)")
    p.add_argument("--seq-chunk", type=int, default=None,
                   help="sequence columns per f32 combine of the kernel, a "
                   "multiple of 4 (default: all of N in one chunk, rounded "
                   "up to 64)")
    p.add_argument("--tiles-per-batch", type=int, default=None,
                   help="tiles per kernel launch (default: auto)")
    p.add_argument("--weight-quant",
                   choices=("none", "split_bf16", "lo_int8", "int8",
                            "int8x3"),
                   default="none",
                   help="weighted-pass arithmetic of the tiled kernel: none "
                   "= int8x3 (full accuracy), split_bf16, lo_int8 and int8 "
                   "(lossy)")
    p.add_argument("--ndigits", type=int, default=4,
                   help="output rounding digits [default 4, as reference]")
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
                   "PLINK --indep-pairwise style)")
    p.add_argument("--prune-rule", choices=("maf", "first"), default="maf",
                   help="which endpoint of a conflicting pair to drop: "
                   "'maf' = the lower-minor-allele-frequency site "
                   "(default), 'first' = always the later site")
    p.add_argument("--top", type=int, default=None, metavar="K",
                   help="emit only the K strongest surviving pairs by r2 "
                   "(descending), threshold-free; the tiled engine selects "
                   "on the device, O(K) host traffic per batch")
    p.add_argument("--stream-ingest", action="store_true",
                   help="two-pass streaming ingest straight into the "
                   "session's padded site-major layout (VCF, or FASTA): "
                   "peak host memory is one padded matrix.  Records equal "
                   "the default readers'; Henikoff weights run chunked in "
                   "f64 (equal to the default's up to summation order, ~1 "
                   "ulp).  Runs the tiled engine")
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
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; fails without a "
                   "card) or cpu (the kernels' plain PyTorch versions)")
    return p


def _not_ported(argv: list[str]) -> str | None:
    for a in argv:
        name = a.split("=", 1)[0]
        if name in NOT_PORTED:
            return name
    return None


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
        ("--list-chroms", args.list_chroms),
    ) if on]
    if conflicts:
        return f"--cross-regions is exclusive with {conflicts[0]}"
    if args.engine == "dense":
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


def _json_line(out: dict, t0: float) -> None:
    out["elapsed_s"] = time.monotonic() - t0
    print(json.dumps(out))


def _empty_mode_output(args, res, n: int, s: int) -> int:
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
    body = pair_header() + "\n"
    if args.prune_r2 is not None:
        # A lone site is trivially conflict-free.
        body = "".join(f"{int(p)}\n" for p in res.site_map)
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

    stream_cfg = DriverConfig(tile=args.tile, seq_chunk=args.seq_chunk)
    hk_mask = ld_mask = None
    if _is_vcf(args.file):
        chrom, pos_range = _chrom_range(args)
        with timer.stage("ingest"):
            sm, site_map = prepare_vcf_streamed(
                args.file, stream_cfg, chrom=chrom, pos_range=pos_range,
                keep_samples=args.keep_samples,
                exclude_samples=args.exclude_samples)
    else:
        with timer.stage("ingest"):
            sm, site_map, hk_mask, ld_mask = prepare_fasta_streamed(
                args.file, min_acgt=args.min_acgt,
                min_variability=args.min_variability, cfg=stream_cfg,
                keep_samples=args.keep_samples,
                exclude_samples=args.exclude_samples)
    with timer.stage("weights"):
        if args.unweighted:
            weights = np.ones(sm.n_seqs, dtype=np.float32)
        else:
            weights = henikoff_weights_host_site_major(
                sm.codes, sm.n_sites, sm.n_seqs)
    return PipelineResult(alignment=sm, site_map=site_map, weights=weights,
                          hk_mask=hk_mask, ld_mask=ld_mask)


def main(argv=None, timer=None) -> int:
    """CLI entry point; ``timer`` (a ``runtime.profiling.StageTimer``)
    collects the per-stage spans."""
    argv = sys.argv[1:] if argv is None else list(argv)
    flag = _not_ported(argv)
    if flag is not None:
        print(f"error: {flag} is not yet ported to weightedld_tpu_torch "
              f"(ROADMAP {NOT_PORTED[flag]})", file=sys.stderr)
        return 2
    args = build_parser().parse_args(argv)
    logging.basicConfig(format="[%(levelname)s] %(asctime)s %(message)s",
                        level=logging.ERROR, stream=sys.stderr)

    # One output mode per invocation (weightedld_tpu/cli.py:363-399).
    modes = [name for name, on in (
        ("--matrix-output", args.matrix_output is not None),
        ("--stats-only", args.stats_only),
        ("--ld-decay", args.ld_decay is not None),
        ("--r2-hist", args.r2_hist is not None),
        ("--top", args.top is not None),
        ("--prune-r2", args.prune_r2 is not None),
        ("--list-chroms", args.list_chroms),
    ) if on]
    if len(modes) > 1:
        print(f"error: {' and '.join(modes)} are mutually exclusive "
              "output modes", file=sys.stderr)
        return 2
    if args.matrix_output is not None and args.r2_threshold is not None:
        print("warning: --matrix-output writes complete matrices; "
              "--r2-threshold is ignored in this mode", file=sys.stderr)
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
    from .io.writer import open_text_output, pair_header, write_pairs, \
        write_weights
    from .pipeline import WldConfig, prepare
    from .runtime.profiling import StageTimer

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 contractions
    timer = timer or StageTimer()
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
                print(c)
        except (VcfError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        return 0
    if args.file is None:
        print("error: --file is required", file=sys.stderr)
        return 2
    if args.stream_ingest and args.engine == "dense":
        print(f"error: --stream-ingest requires the tiled engine "
              f"(--engine {args.engine} holds the matrix in sequence-"
              "major form)", file=sys.stderr)
        return 2
    cfg = WldConfig(min_acgt=args.min_acgt,
                    min_variability=args.min_variability,
                    unweighted=args.unweighted,
                    r2_threshold=args.r2_threshold,
                    chrom=args.chrom, region=args.region,
                    keep_samples=args.keep_samples,
                    exclude_samples=args.exclude_samples)
    t0 = time.monotonic()
    cross_split = None
    try:
        if args.stream_ingest:
            res = _prepare_streamed(args, timer)
        elif args.cross_regions is not None:
            from .pipeline import prepare_vcf_cross

            res, cross_split = prepare_vcf_cross(
                args.file, cfg, args.cross_regions[0],
                args.cross_regions[1], timer=timer, device=device)
        else:
            res = prepare(args.file, cfg, timer=timer, device=device)
    except (ValueError, OSError) as e:   # VcfError, ragged FASTA, missing
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.stream_ingest:
        n, s = res.alignment.n_seqs, res.alignment.n_sites
    else:
        n, s = res.alignment.shape

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

    if args.weights_output:
        with open_text_output(args.weights_output) as fh:
            write_weights(res.weights, fh)

    def pair_out():
        return open_text_output(args.pair_output if args.pair_output
                                else "-")

    if s < 2:
        if modes:
            return _empty_mode_output(args, res, n, s)
        with pair_out() as fh:
            fh.write(pair_header() + "\n")
        return 0

    engine = args.engine
    if engine == "auto":
        engine = "dense" if s <= 2048 else "tiled"
    if args.max_distance is not None or args.max_distance_bp is not None \
            or args.cross_regions is not None or args.stream_ingest:
        # The window and rectangle masks live in the tiled session, and a
        # streamed buffer is laid out for it (cli.py:823-828).
        engine = "tiled"
    if args.weight_quant != "none" and engine != "tiled" \
            and args.matrix_output is None:
        print(f"warning: --weight-quant only applies to the tiled engine; "
              f"the '{engine}' engine runs the exact path (add --engine "
              "tiled to use it)", file=sys.stderr)

    from .runtime.driver import (DriverConfig, LdSession, run_to_tsv,
                                 validate_decay_edges, validate_hist_edges)

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
                             device=device)

    def dense_stats():
        from .core.ld_dense import ld_all_pairs_dense

        return ld_all_pairs_dense(
            torch.from_numpy(np.ascontiguousarray(res.alignment)).to(device),
            torch.from_numpy(np.asarray(res.weights, np.float32)).to(device))

    if args.matrix_output is not None:
        if s > 32768:
            print(f"error: --matrix-output needs O(S^2) host memory; "
                  f"S={s} > 32768 kept sites — use the record outputs",
                  file=sys.stderr)
            return 2
        sess = session()
        with timer.stage("scan"):
            mats = sess.matrices(dtype=np.dtype(args.matrix_dtype))
        with timer.stage("write"):
            np.savez_compressed(args.matrix_output, site_map=res.site_map,
                                **mats)
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
        _json_line(out, t0)
        return 0

    if args.ld_decay is not None:
        if args.r2_threshold is not None:
            print("warning: --ld-decay is threshold-free; --r2-threshold "
                  "is ignored in this mode", file=sys.stderr)
        if args.engine == "dense":
            print("warning: --ld-decay always runs the tiled session engine "
                  "(--engine dense ignored)", file=sys.stderr)
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
        if args.engine == "dense":
            print("warning: --prune-r2 always runs the tiled session engine "
                  "(--engine dense ignored)", file=sys.stderr)
        if len(np.unique(res.site_map)) != s:
            print("error: --prune-r2 needs unique site positions "
                  "(multi-chromosome input? run per chromosome)",
                  file=sys.stderr)
            return 2
        sess = session()
        with timer.stage("scan"):
            kept = sess.prune(args.prune_r2, rule=args.prune_rule)
        with pair_out() as fh:
            fh.write("".join(f"{int(p)}\n" for p in kept))
        return 0

    if args.top is not None:
        if args.top <= 0:
            print("error: --top needs a positive K", file=sys.stderr)
            return 2
        if args.r2_threshold is not None:
            print("warning: --top is threshold-free; --r2-threshold is "
                  "ignored in this mode", file=sys.stderr)
        from .core.ld_dense import LdRecords, extract_records

        if engine == "dense":
            with timer.stage("scan"):
                rec = extract_records(dense_stats(), res.site_map)
            order = np.argsort(-np.asarray(rec.r2), kind="stable")[:args.top]
            rec = LdRecords(*(np.asarray(f)[order] for f in rec))
        else:
            sess = session()
            with timer.stage("scan"):
                rec = sess.top_pairs(args.top)
        with pair_out() as fh:
            write_pairs(rec, fh, ndigits=args.ndigits)
        return 0

    if engine == "dense":
        from .core.ld_dense import extract_records

        with timer.stage("scan"):
            records = extract_records(dense_stats(), res.site_map,
                                      args.r2_threshold)
        with timer.stage("write"), pair_out() as fh:
            write_pairs(records, fh, ndigits=args.ndigits)
        return 0

    run_to_tsv(res.alignment, res.weights, res.site_map,
               args.pair_output if args.pair_output else "-", dcfg,
               device=device, ndigits=args.ndigits, timer=timer)
    return 0


if __name__ == "__main__":
    sys.exit(main())
