"""End-to-end pipeline glue: ingest -> mask -> weight -> LD.

Counterpart of ``WldConfig`` (the fields this slice reads), ``prepare_fasta``,
``prepare_vcf``, ``prepare`` and ``run`` from ``weightedld_tpu/pipeline.py:
53-83, 187-249, 321-340``, mirroring the reference driver
(``WeightedLD.py:287-308, 382-402``):

* FASTA: both site masks on the host in float64, the alignment trimmed to
  the LD mask, Henikoff weights on the LD-trimmed alignment (the reference
  CLI convention);
* VCF: no site masking, weights on the full haplotype matrix;
* ``unweighted``: unit weights.

Weights are the float64 host Henikoff weights (bit-equal to the reference);
inputs above 200M cells are weighted on the pipeline's device (default
cuda), one chunk of sites at a time, by ``henikoff_weights_large``
(``weightedld_tpu/pipeline.py:33-49``).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .core.henikoff import henikoff_weights_host, henikoff_weights_large
from .core.ld_dense import LdRecords, extract_records, ld_all_pairs_dense
from .core.sites import compute_variable_sites_host
from .device import resolve_device
from .io.fasta import read_fasta
from .io.vcf import read_vcf

# Above this many cells the weights are computed on the device in site
# chunks (the host float64 path would hold several [N, S] f64 temporaries).
_LARGE_CELLS = 200_000_000


def _weights_for(alignment: np.ndarray,
                 device: str | torch.device | None = None) -> np.ndarray:
    if alignment.size > _LARGE_CELLS:
        return henikoff_weights_large(alignment, device=device).cpu().numpy()
    return henikoff_weights_host(alignment)


@dataclass
class WldConfig:
    """The reference Python flag set this slice supports (SURVEY.md §5)."""

    min_acgt: float = 0.8          # WeightedLD.py:409
    min_variability: float = 0.02  # WeightedLD.py:412
    unweighted: bool = False       # WeightedLD.py:414
    max_minor: float = 1.0         # Rust-only, main.rs:37-42 (1.0 = off)
    r2_threshold: float | None = None  # Rust-only, main.rs:45-49 (None = all)


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
    with timer.stage("ingest"):
        alignment = read_fasta(path)
    with timer.stage("mask"):
        hk_mask, ld_mask = compute_variable_sites_host(
            alignment, cfg.min_acgt, cfg.min_variability, cfg.max_minor)
        trimmed = alignment[:, ld_mask]
        site_map = np.where(ld_mask)[0].astype(np.int64)
    with timer.stage("weights"):
        if cfg.unweighted:
            weights = np.ones(alignment.shape[0], dtype=np.float32)
        else:
            weights = _weights_for(trimmed, device)
    return PipelineResult(alignment=trimmed, site_map=site_map,
                          weights=weights, hk_mask=hk_mask, ld_mask=ld_mask)


def prepare_vcf(path: str | Path, cfg: WldConfig, timer=None,
                device: str | torch.device | None = None) -> PipelineResult:
    from .runtime.profiling import StageTimer

    timer = timer or StageTimer()
    with timer.stage("ingest"):
        alignment, site_map = read_vcf(path)
    with timer.stage("weights"):
        if cfg.unweighted:
            weights = np.ones(alignment.shape[0], dtype=np.float32)
        else:
            weights = _weights_for(alignment, device)
    return PipelineResult(alignment=alignment, site_map=site_map,
                          weights=weights)


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
