"""Streaming ingest: a VCF or FASTA file straight into a session's padded
site-major buffer, with bounded host memory.

Copy of ``prepare_vcf_streamed``, ``session_from_vcf``,
``prepare_fasta_streamed`` and ``session_from_fasta`` from
``weightedld_tpu/runtime/ingest.py:50-236``, with the chromosome, region
and sample filters (``chrom``, ``pos_range``, ``keep_samples``,
``exclude_samples``; the FASTA twins take the sample ones) and the
session's ``device`` / ``devices`` (its local shard devices) in place of a
mesh; the streamed buffer is replicated to the shards like any matrix.
The chain:

* pass 1 (``io.vcf.scan_vcf`` / ``io.fasta.scan_fasta``) learns the shape
  of the records and samples kept (and, for a FASTA, the per-site
  histograms, from which the reference's masks come) without decoding the
  ``[N, S]`` matrix; the sample subset becomes a row mask;
* :meth:`LdSession.required_padding` sizes the buffer for the session's
  tile and seq chunk before any genotype is decoded;
* pass 2 (``read_vcf_site_major`` / ``read_fasta_site_major``) decodes
  each record straight into the buffer, allocated once;
* the weights: float64 on the host, chunked over site rows
  (``henikoff_weights_host_site_major``, equal to the default pipeline's
  up to summation order, about an ulp), or, for a VCF with
  ``weight_precision="f32"``, on the device from the uploaded codes;
* :class:`LdSession` with the :class:`SiteMajorCodes`, uploaded as it is.

Peak host memory is the one padded site-major matrix (plus a row block and
the ``[S, 5]`` histogram), where the batch readers hold the records, the
``[S, N]`` stack and its transpose.  The VCF path masks no site (reference
``WeightedLD.py:385-388``); the FASTA path keeps the LD-mask sites only and
weights them, the reference CLI's convention (``WeightedLD.py:303, 397``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..core.henikoff import henikoff_weights_host_site_major
from ..io.vcf import read_vcf_site_major, scan_vcf
from .driver import DriverConfig, LdSession, SiteMajorCodes


def prepare_vcf_streamed(path: str | Path, cfg: DriverConfig | None = None,
                         chrom: str | None = None,
                         pos_range: tuple[int, int] | None = None,
                         keep_samples: tuple[str, ...] | None = None,
                         exclude_samples: tuple[str, ...] | None = None,
                         ) -> tuple[SiteMajorCodes, np.ndarray]:
    """Two-pass streaming VCF ingest sized for ``cfg``:
    ``(SiteMajorCodes, site_map)`` for a session built with the same
    config.  ``chrom`` / ``pos_range`` are the ``--chrom`` / ``--region``
    filters (``io.vcf.parse_region``); the sample subset is resolved from
    the header names into a row mask before pass 2, which drops the other
    haplotypes while decoding, so the buffer holds the kept rows only."""
    n_haps, site_map = scan_vcf(path, chrom, pos_range)
    row_mask = None
    if keep_samples is not None or exclude_samples is not None:
        from ..pipeline import _sample_row_mask, _vcf_row_names

        row_mask = _sample_row_mask(_vcf_row_names(path, n_haps),
                                    keep_samples, exclude_samples)
    n_kept = n_haps if row_mask is None else int(row_mask.sum())
    s_pad, n_pad = LdSession.required_padding(n_kept, len(site_map), cfg)
    codes, site_map, n_kept = read_vcf_site_major(
        path, s_pad=s_pad, n_pad=n_pad, scan=(n_haps, site_map),
        chrom=chrom, pos_range=pos_range, row_mask=row_mask)
    return SiteMajorCodes(codes=codes, n_seqs=n_kept,
                          n_sites=len(site_map)), site_map


def session_from_vcf(path: str | Path, cfg: DriverConfig | None = None,
                     device: str | torch.device | None = None,
                     unweighted: bool = False,
                     weights: np.ndarray | None = None,
                     weight_precision: str = "f64",
                     chrom: str | None = None,
                     pos_range: tuple[int, int] | None = None,
                     keep_samples: tuple[str, ...] | None = None,
                     exclude_samples: tuple[str, ...] | None = None,
                     devices=None) -> LdSession:
    """A session on ``device`` (default cuda) from a VCF, possibly gzipped,
    with bounded host memory: the streaming twin of ``prepare_vcf`` plus
    ``LdSession``, with its filters.  Henikoff weights on the full
    haplotype matrix: ``weight_precision="f64"`` on the host (chunked),
    ``"f32"`` on the device from the uploaded codes.  ``weights`` or
    ``unweighted=True`` skip the weighting."""
    if weight_precision not in ("f64", "f32"):
        raise ValueError(f"weight_precision must be 'f64' or 'f32', got "
                         f"{weight_precision!r}")
    sm, site_map = prepare_vcf_streamed(
        path, cfg, chrom=chrom, pos_range=pos_range,
        keep_samples=keep_samples, exclude_samples=exclude_samples)
    if unweighted:
        weights = np.ones(sm.n_seqs, dtype=np.float32)
    elif weights is None and weight_precision == "f64":
        weights = henikoff_weights_host_site_major(sm.codes, sm.n_sites,
                                                   sm.n_seqs)
    return LdSession(sm, weights, site_map, cfg=cfg, device=device,
                     devices=devices)


def prepare_fasta_streamed(
    path: str | Path,
    min_acgt: float = 0.8,
    min_variability: float = 0.02,
    max_minor: float = 1.0,
    cfg: DriverConfig | None = None,
    keep_samples: tuple[str, ...] | None = None,
    exclude_samples: tuple[str, ...] | None = None,
) -> tuple[SiteMajorCodes, np.ndarray, np.ndarray, np.ndarray]:
    """Two-pass streaming FASTA ingest: ``(SiteMajorCodes, site_map,
    hk_mask, ld_mask)``, the buffer holding the LD-kept sites only.  The
    sample subset is decided per record in pass 1 (before the masks, as
    the pipeline does), whose row mask drives pass 2.  The masks come from
    pass 1's histograms with the reference's float64 semantics
    (``compute_variable_sites_from_counts``).  With no kept site the
    buffer has one all-UNKNOWN tile (``n_sites == 0``), which callers
    treat as the empty result before any session is built."""
    from ..core.sites import compute_variable_sites_from_counts
    from ..io.fasta import read_fasta_site_major, scan_fasta

    n_seqs, n_sites, counts, row_mask = scan_fasta(
        path, keep_samples=keep_samples, exclude_samples=exclude_samples)
    hk_mask, ld_mask = compute_variable_sites_from_counts(
        counts, n_seqs, min_acgt, min_variability, max_minor)
    site_map = np.flatnonzero(ld_mask).astype(np.int64)
    s_kept = len(site_map)
    s_pad, n_pad = LdSession.required_padding(n_seqs, max(s_kept, 1), cfg)
    codes = read_fasta_site_major(path, ld_mask, scan=(n_seqs, n_sites),
                                  s_pad=s_pad, n_pad=n_pad,
                                  row_mask=row_mask)
    return (SiteMajorCodes(codes=codes, n_seqs=n_seqs, n_sites=s_kept),
            site_map, hk_mask, ld_mask)


def session_from_fasta(path: str | Path, cfg: DriverConfig | None = None,
                       device: str | torch.device | None = None,
                       min_acgt: float = 0.8, min_variability: float = 0.02,
                       max_minor: float = 1.0, unweighted: bool = False,
                       weights: np.ndarray | None = None,
                       keep_samples: tuple[str, ...] | None = None,
                       exclude_samples: tuple[str, ...] | None = None,
                       devices=None) -> LdSession:
    """A session on ``device`` (default cuda) from a FASTA, possibly
    gzipped, with bounded host memory: the sample subset, the LD-mask trim
    and float64 host Henikoff weights on the trimmed sites, as the
    pipeline does."""
    sm, site_map, _hk, _ld = prepare_fasta_streamed(
        path, min_acgt=min_acgt, min_variability=min_variability,
        max_minor=max_minor, cfg=cfg, keep_samples=keep_samples,
        exclude_samples=exclude_samples)
    if unweighted:
        weights = np.ones(sm.n_seqs, dtype=np.float32)
    elif weights is None:
        weights = henikoff_weights_host_site_major(sm.codes, sm.n_sites,
                                                   sm.n_seqs)
    return LdSession(sm, weights, site_map, cfg=cfg, device=device,
                     devices=devices)
