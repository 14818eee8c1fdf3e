"""Command-line interface of the PyTorch / CUDA port.

    python -m weightedld_tpu_torch.cli --file X.vcf [--device cuda|cpu]

The main-path dispatch of ``weightedld_tpu/cli.py``: ingest, masks and
Henikoff weights on the host, then the dense engine (S <= 2048 by default)
or the tiled session with the CUDA kernels, and the 4-dp TSV.  Both engines
take any input, FASTA with ambiguity characters included: the tiled session
runs the factorized kernel wherever it is exact and the general kernel on
the tile pairs whose UNKNOWN codes it does not cover.
Supported flags: ``--file``, ``--min-acgt``, ``--min-variability``,
``--unweighted``, ``--r2-threshold``, ``--pair-output``, ``--engine
{auto,dense,tiled}``, ``--tile``, ``--seq-chunk``, ``--tiles-per-batch``,
``--weight-quant``, ``--ndigits``, ``--weights-output`` and the port's
``--device`` (default ``cuda``; no card is an error, never a silent CPU
run).  Every other flag of the JAX CLI exits 2 with "not yet ported".

Output order: the dense engine emits pairs in (site_a, site_b) row-major
order like the Python reference; the tiled engine in tile order like the
Rust reference's PairStore (``lib.rs:523-576``).
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import numpy as np

# Flags of the JAX CLI that this port does not take yet -> ROADMAP item.
NOT_PORTED = {
    **dict.fromkeys(("--stats-only", "--matrix-output", "--matrix-dtype",
                     "--ld-decay", "--r2-hist", "--prune-r2", "--prune-rule",
                     "--top"), "queue 1 item 8 (analytics)"),
    **dict.fromkeys(("--max-distance", "--max-distance-bp",
                     "--cross-regions"),
                    "queue 1 item 9 (windowed and cross plans)"),
    **dict.fromkeys(("--version", "-v", "--verbose", "--max-minor",
                     "--weight-mask", "--compat", "--fasta-reader",
                     "--weighting", "--out-format", "--save-prepared",
                     "--load-prepared", "--chrom", "--region",
                     "--keep-samples", "--exclude-samples", "--site-stats",
                     "--list-chroms", "--sort", "--progress",
                     "--progress-bar"),
                    "queue 1 item 10 (full CLI parity)"),
    "--stream-ingest": "queue 1 item 11 (streaming ingest)",
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
                   "= int8x3 (full accuracy), split_bf16, int8 (lossy); "
                   "lo_int8 is not ported yet")
    p.add_argument("--ndigits", type=int, default=4,
                   help="output rounding digits [default 4, as reference]")
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
    if args.file is None:
        print("error: --file is required", file=sys.stderr)
        return 2
    cfg = WldConfig(min_acgt=args.min_acgt,
                    min_variability=args.min_variability,
                    unweighted=args.unweighted,
                    r2_threshold=args.r2_threshold)
    try:
        res = prepare(args.file, cfg, timer=timer)
    except NotImplementedError as e:
        print(f"error: not yet ported: {e}", file=sys.stderr)
        return 2
    except (ValueError, OSError) as e:   # VcfError, ragged FASTA, missing
        print(f"error: {e}", file=sys.stderr)
        return 2
    n, s = res.alignment.shape

    if args.weights_output:
        with open_text_output(args.weights_output) as fh:
            write_weights(res.weights, fh)

    def pair_out():
        return open_text_output(args.pair_output if args.pair_output
                                else "-")

    if s < 2:
        with pair_out() as fh:
            fh.write(pair_header() + "\n")
        return 0

    engine = args.engine
    if engine == "auto":
        engine = "dense" if s <= 2048 else "tiled"
    if args.weight_quant != "none" and engine != "tiled":
        print(f"warning: --weight-quant only applies to the tiled engine; "
              f"the '{engine}' engine runs the exact path (add --engine "
              "tiled to use it)", file=sys.stderr)

    if engine == "dense":
        from .core.ld_dense import extract_records, ld_all_pairs_dense

        with timer.stage("scan"):
            stats = ld_all_pairs_dense(
                torch.from_numpy(np.ascontiguousarray(res.alignment)).to(
                    device),
                torch.from_numpy(np.asarray(res.weights, np.float32)).to(
                    device))
            records = extract_records(stats, res.site_map, args.r2_threshold)
        with timer.stage("write"), pair_out() as fh:
            write_pairs(records, fh, ndigits=args.ndigits)
        return 0

    from .runtime.driver import DriverConfig, run_to_tsv

    dcfg = DriverConfig(tile=args.tile,
                        tiles_per_shard_batch=args.tiles_per_batch,
                        r2_threshold=args.r2_threshold,
                        seq_chunk=args.seq_chunk,
                        weight_quant=args.weight_quant)
    try:
        run_to_tsv(res.alignment, res.weights, res.site_map,
                   args.pair_output if args.pair_output else "-", dcfg,
                   device=device, ndigits=args.ndigits, timer=timer)
    except NotImplementedError as e:
        print(f"error: not yet ported: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
