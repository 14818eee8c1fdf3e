"""End-to-end pipeline glue: ingest -> mask -> weight -> LD.

Counterpart of ``_weights_for`` (``weightedld_tpu/pipeline.py:37-51``),
``WldConfig``, the sample subsetting helpers, ``_read_fasta_subset`` with
its reader dispatch, ``_resolve_vcf_filters``, ``prepare_fasta``,
``prepare_vcf``, ``regions_overlap``, ``prepare_vcf_cross``, ``prepare``,
``run`` and ``site_stats`` (``:54-398``), mirroring the reference driver
(``WeightedLD.py:287-308, 382-402``):

* FASTA: both site masks on the host in float64, the alignment trimmed to
  the LD mask, Henikoff weights on the LD-trimmed alignment (the reference
  CLI convention) or, with ``weight_mask="hk"``, on the HK-masked one (the
  reference test suite's convention, ``test.py:43-44``); the Python
  (BioPython) framing or the Rust binary's line framing
  (``fasta_reader="rust"``);
* VCF: no site masking, weights on the full haplotype matrix;
* ``unweighted``: unit weights;
* a VCF read can keep one chromosome (``chrom``) or one samtools-style
  region (``region``), and both formats can keep or drop named samples
  (``keep_samples`` / ``exclude_samples``) before masks and weights.

Weights (``_weights_for``): the ``python`` formula in float64 on the host
(bit-equal to the reference), or on the pipeline's device (default cuda),
one chunk of sites at a time, above 200M cells
(``henikoff_weights_large``); the ``paper`` formula always on the
pipeline's device in float32 (``henikoff_weights_paper``; the JAX package
computes it in float32 on its device).  The pipeline's result holds host
weights, so a device result is copied back there.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .core.henikoff import (
    henikoff_weights_host,
    henikoff_weights_large,
    henikoff_weights_paper,
)
from .core.ld_dense import LdRecords, extract_records, ld_all_pairs_dense
from .core.sites import compute_variable_sites_host
from .device import resolve_device
from .io.fasta import read_fasta, read_fasta_with_names
from .io.vcf import read_vcf

# Above this many cells the weights are computed on the device in site
# chunks (the host float64 path would hold several [N, S] f64 temporaries).
_LARGE_CELLS = 200_000_000


def _weights_for(alignment: np.ndarray,
                 device: str | torch.device | None = None,
                 variant: str = "python") -> np.ndarray:
    if alignment.size > _LARGE_CELLS:
        return henikoff_weights_large(alignment, device=device,
                                      variant=variant).cpu().numpy()
    if variant == "paper":
        return henikoff_weights_paper(alignment, device=device).cpu().numpy()
    return henikoff_weights_host(alignment)


@dataclass
class WldConfig:
    """Union of the reference Python and Rust flag sets (SURVEY.md §5)."""

    min_acgt: float = 0.8          # WeightedLD.py:409
    min_variability: float = 0.02  # WeightedLD.py:412
    unweighted: bool = False       # WeightedLD.py:414
    max_minor: float = 1.0         # Rust-only, main.rs:37-42 (1.0 = off)
    r2_threshold: float | None = None  # Rust-only, main.rs:45-49 (None = all)
    weight_mask: str = "ld"        # "ld" (CLI parity) or "hk" (test.py parity)
    weighting: str = "python"      # "python" (WeightedLD.py) or "paper"
                                   # (Henikoff-1994 / Rust variant)
    chrom: str | None = None       # VCF only: keep one chromosome's records
                                   # (the reference ignores CHROM, mixing
                                   # whole-genome POS into one axis)
    fasta_reader: str = "python"   # "python" (BioPython semantics: wrapped
                                   # records concatenated) or "rust" (the
                                   # Rust binary's line reader,
                                   # io/fasta.py:read_fasta_rust)
    region: str | None = None      # VCF only: "CHR" or "CHR:START-END"
                                   # (1-based inclusive POS window,
                                   # io.vcf.parse_region); exclusive with
                                   # `chrom`
    keep_samples: tuple[str, ...] | None = None     # restrict the analysis
                                   # to these FASTA record names / VCF
                                   # header samples (both haplotypes of a
                                   # kept sample)
    exclude_samples: tuple[str, ...] | None = None  # drop these names
                                   # (applied after keep_samples)


def _sample_row_mask(row_names: list[str],
                     keep: tuple[str, ...] | None,
                     exclude: tuple[str, ...] | None) -> np.ndarray:
    """Boolean row mask from keep/exclude name sets (copy of
    ``pipeline.py:85-113``): every named sample must exist in the input;
    ``keep`` restricts, then ``exclude`` drops; row order is preserved;
    fewer than 2 surviving rows is an error."""
    known = set(row_names)
    for group, flag in ((keep, "keep_samples"), (exclude, "exclude_samples")):
        unknown = sorted(set(group or ()) - known)
        if unknown:
            raise ValueError(
                f"{flag}: unknown sample name(s): {', '.join(unknown)}")
    mask = np.ones(len(row_names), dtype=bool)
    if keep is not None:
        ks = set(keep)
        mask &= np.fromiter((n in ks for n in row_names), dtype=bool,
                            count=len(row_names))
    if exclude is not None:
        es = set(exclude)
        mask &= np.fromiter((n not in es for n in row_names), dtype=bool,
                            count=len(row_names))
    if int(mask.sum()) < 2:
        raise ValueError(
            "fewer than 2 sequences remain after sample subsetting")
    return mask


def _vcf_row_names(path: str | Path, n_haps: int) -> list[str]:
    """Per-row sample names of a VCF alignment (``pipeline.py:116-136``):
    row ``k`` belongs to sample ``(n_haps-1-k) // 2`` under the reference's
    rot90 order (phased diploid), or ``n_haps-1-k`` for a haploid file;
    mixed ploidy is refused."""
    from .io.vcf import vcf_sample_names

    names = vcf_sample_names(path)
    if n_haps == 2 * len(names):
        return [names[(n_haps - 1 - k) // 2] for k in range(n_haps)]
    if n_haps == len(names):
        return [names[n_haps - 1 - k] for k in range(n_haps)]
    raise ValueError(
        f"cannot map {n_haps} haplotype rows to {len(names)} header "
        "samples (mixed ploidy?); sample subsetting needs uniformly "
        "diploid or uniformly haploid records"
    )


def _wants_subset(cfg: WldConfig) -> bool:
    return cfg.keep_samples is not None or cfg.exclude_samples is not None


def _subset_vcf_rows(path: str | Path, alignment: np.ndarray,
                     cfg: WldConfig) -> np.ndarray:
    """``cfg``'s sample subsetting of a VCF haplotype matrix (no-op without
    one), the one definition the prepare and cross paths share."""
    if not _wants_subset(cfg):
        return alignment
    mask = _sample_row_mask(_vcf_row_names(path, alignment.shape[0]),
                            cfg.keep_samples, cfg.exclude_samples)
    return alignment[mask]


def _read_fasta_subset(path: str | Path, cfg: WldConfig) -> np.ndarray:
    """FASTA ingest with ``cfg.fasta_reader``'s framing and ``cfg``'s
    sample subsetting (``pipeline.py:151-173``; names are read only when
    subsetting)."""
    if cfg.fasta_reader == "rust":
        from .io.fasta import read_fasta_rust, read_fasta_rust_with_names

        if not _wants_subset(cfg):
            return read_fasta_rust(path)
        alignment, names = read_fasta_rust_with_names(path)
    elif cfg.fasta_reader == "python":
        if not _wants_subset(cfg):
            return read_fasta(path)
        alignment, names = read_fasta_with_names(path)
    else:
        raise ValueError(
            f"fasta_reader must be 'python' or 'rust', got "
            f"{cfg.fasta_reader!r}")
    return alignment[_sample_row_mask(names, cfg.keep_samples,
                                      cfg.exclude_samples)]


def _resolve_vcf_filters(cfg: WldConfig):
    """``(chrom, pos_range)`` from cfg.chrom / cfg.region (exclusive)."""
    if cfg.region is None:
        return cfg.chrom, None
    if cfg.chrom is not None:
        raise ValueError("chrom and region are mutually exclusive "
                         "(a region names its chromosome)")
    from .io.vcf import parse_region

    return parse_region(cfg.region)


@dataclass
class PipelineResult:
    alignment: np.ndarray          # LD-trimmed [N, S_kept] codes
    site_map: np.ndarray           # [S_kept] original site indices / positions
    weights: np.ndarray            # [N]
    hk_mask: np.ndarray | None = None
    ld_mask: np.ndarray | None = None
    records: LdRecords | None = None


def prepare_fasta(path: str | Path, cfg: WldConfig, timer=None,
                  device: str | torch.device | None = None) -> PipelineResult:
    from .runtime.profiling import StageTimer

    timer = timer or StageTimer()
    if cfg.region is not None:
        raise ValueError("region only applies to VCF input (FASTA has no "
                         "chromosome/position columns)")
    with timer.stage("ingest"):
        alignment = _read_fasta_subset(path, cfg)
    with timer.stage("mask"):
        hk_mask, ld_mask = compute_variable_sites_host(
            alignment, cfg.min_acgt, cfg.min_variability, cfg.max_minor)
        trimmed = alignment[:, ld_mask]
        site_map = np.where(ld_mask)[0].astype(np.int64)
    with timer.stage("weights"):
        if cfg.unweighted:
            weights = np.ones(alignment.shape[0], dtype=np.float32)
        elif cfg.weight_mask == "hk":
            weights = _weights_for(alignment[:, hk_mask], device,
                                   cfg.weighting)
        else:
            weights = _weights_for(trimmed, device, cfg.weighting)
    return PipelineResult(alignment=trimmed, site_map=site_map,
                          weights=weights, hk_mask=hk_mask, ld_mask=ld_mask)


def prepare_vcf(path: str | Path, cfg: WldConfig, timer=None,
                device: str | torch.device | None = None) -> PipelineResult:
    from .runtime.profiling import StageTimer

    timer = timer or StageTimer()
    chrom, pos_range = _resolve_vcf_filters(cfg)
    with timer.stage("ingest"):
        alignment, site_map = read_vcf(path, chrom=chrom, pos_range=pos_range)
        alignment = _subset_vcf_rows(path, alignment, cfg)
    with timer.stage("weights"):
        if cfg.unweighted:
            weights = np.ones(alignment.shape[0], dtype=np.float32)
        else:
            weights = _weights_for(alignment, device, cfg.weighting)
    return PipelineResult(alignment=alignment, site_map=site_map,
                          weights=weights)


def regions_overlap(spec_a: str, spec_b: str) -> bool:
    """Whether two ``CHR[:LO-HI]`` regions can share a site: the same
    chromosome with intersecting, or unbounded, POS windows."""
    from .io.vcf import parse_region

    ca, ra = parse_region(spec_a)
    cb, rb = parse_region(spec_b)
    if ca != cb:
        return False
    if ra is None or rb is None:
        return True
    return ra[0] <= rb[1] and rb[0] <= ra[1]


def prepare_vcf_cross(path: str | Path, cfg: WldConfig,
                      spec_a: str, spec_b: str, timer=None,
                      device: str | torch.device | None = None,
                      ) -> tuple[PipelineResult, int]:
    """Inter-region preparation for a rectangular LD scan (copy of
    ``pipeline.py:266-318``): regions A and B of one VCF, each read through
    the Python reader (one full file pass per region), laid out as A ++ B;
    returns ``(result, n_a)``, ``n_a`` the layout split for
    ``DriverConfig.cross_split``.  Henikoff weights over the combined
    matrix; sample subsetting applies to both blocks; overlapping regions
    are refused (their sites would pair with their own copies)."""
    from .io.vcf import parse_region
    from .runtime.profiling import StageTimer

    timer = timer or StageTimer()
    if cfg.chrom is not None or cfg.region is not None:
        raise ValueError("cross-regions is exclusive with chrom/region "
                         "(it names its own two regions)")
    if regions_overlap(spec_a, spec_b):
        raise ValueError(
            f"cross regions {spec_a!r} and {spec_b!r} overlap — their "
            "sites would pair against their own copies; pick disjoint "
            "POS windows (or different chromosomes)")
    ca, ra = parse_region(spec_a)
    cb, rb = parse_region(spec_b)
    with timer.stage("ingest"):
        aln_a, sm_a = read_vcf(path, chrom=ca, pos_range=ra)
        aln_b, sm_b = read_vcf(path, chrom=cb, pos_range=rb)
        if aln_a.shape[0] != aln_b.shape[0]:
            raise ValueError(
                f"regions decode different haplotype counts "
                f"({aln_a.shape[0]} vs {aln_b.shape[0]}) — mixed-ploidy "
                "records?")
        if _wants_subset(cfg):
            mask = _sample_row_mask(_vcf_row_names(path, aln_a.shape[0]),
                                    cfg.keep_samples, cfg.exclude_samples)
            aln_a, aln_b = aln_a[mask], aln_b[mask]
        alignment = np.concatenate([aln_a, aln_b], axis=1)
        site_map = np.concatenate([sm_a, sm_b])
    with timer.stage("weights"):
        if cfg.unweighted:
            weights = np.ones(alignment.shape[0], dtype=np.float32)
        else:
            weights = _weights_for(alignment, device, cfg.weighting)
    return PipelineResult(alignment=alignment, site_map=site_map,
                          weights=weights), int(aln_a.shape[1])


def prepare(path: str | Path, cfg: WldConfig | None = None, timer=None,
            device: str | torch.device | None = None) -> PipelineResult:
    """Dispatch on the file suffix like the reference (``WeightedLD.py:385``).
    ``device`` (default cuda) weights inputs over ``_LARGE_CELLS``; smaller
    ones never touch it."""
    cfg = cfg or WldConfig()
    if str(path).endswith((".vcf", ".vcf.gz")):
        return prepare_vcf(path, cfg, timer=timer, device=device)
    return prepare_fasta(path, cfg, timer=timer, device=device)


def run(path: str | Path, cfg: WldConfig | None = None,
        device: str | torch.device | None = None) -> PipelineResult:
    """Full pipeline with the dense engine on ``device`` (default cuda);
    fills ``result.records``."""
    cfg = cfg or WldConfig()
    dev = resolve_device(device)
    res = prepare(path, cfg, device=dev)
    stats = ld_all_pairs_dense(
        torch.from_numpy(np.ascontiguousarray(res.alignment)).to(dev),
        torch.from_numpy(np.asarray(res.weights, np.float32)).to(dev))
    res.records = extract_records(stats, res.site_map, cfg.r2_threshold)
    return res


def site_stats(path: str | Path, cfg: WldConfig | None = None) -> dict:
    """Per-site diagnostic report over all input sites, before any mask
    (copy of ``pipeline.py:343-398``): why each site was kept or dropped.
    A dict of equal-length arrays:

    - ``site``: original column index (FASTA) or POS (VCF; the chromosome,
      region and sample filters respected);
    - ``coverage``: concrete A/C/G/T fraction (gap excluded,
      ``WeightedLD.py:68``);
    - ``major_code``: most frequent code over 0..4, the smallest on ties;
    - ``minor_fraction``: all-minor fraction over codes 0..4
      (``WeightedLD.py:79-87``); 0.0 at invariant sites;
    - ``hk`` / ``ld``: the mask verdicts at ``cfg``'s thresholds; for a VCF
      informational only (no mask is applied on that path,
      ``WeightedLD.py:385-388``).
    """
    from .core.sites import site_fractions_host, site_histogram_host

    cfg = cfg or WldConfig()
    if str(path).endswith((".vcf", ".vcf.gz")):
        chrom, pos_range = _resolve_vcf_filters(cfg)
        alignment, site_map = read_vcf(path, chrom=chrom,
                                       pos_range=pos_range)
        alignment = _subset_vcf_rows(path, alignment, cfg)
    else:
        if cfg.region is not None:
            raise ValueError("region only applies to VCF input (FASTA has "
                             "no chromosome/position columns)")
        alignment = _read_fasta_subset(path, cfg)
        site_map = np.arange(alignment.shape[1], dtype=np.int64)
    n_seqs = alignment.shape[0]
    counts = site_histogram_host(alignment)              # one [S, 5] scan
    coverage, _major, _total, minor_fraction = site_fractions_host(
        counts, n_seqs)
    major_code = counts.argmax(axis=1)                   # ties -> low code
    hk, ld = compute_variable_sites_host(
        alignment, cfg.min_acgt, cfg.min_variability, cfg.max_minor,
        counts=counts)
    return {
        "site": np.asarray(site_map),
        "coverage": coverage,
        "major_code": major_code.astype(np.int64),
        "minor_fraction": minor_fraction,
        "hk": hk,
        "ld": ld,
    }
