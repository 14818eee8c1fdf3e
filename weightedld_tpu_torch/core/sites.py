"""Variable-site masking on the host, in float64.

Copies of ``site_histogram_host``, ``site_histogram_host_site_major``,
``site_fractions_host`` and ``compute_variable_sites_host`` (with
``compute_variable_sites_from_counts``) from
``weightedld_tpu/core/sites.py:89-190``.  Parity contract (reference
``WeightedLD.py:44-98``):

* coverage counts codes < 4 only; ``sufficient_data = coverage > min_acgt``
  (strict);
* the histogram runs over codes 0..4 (gap is an allele);
* ``minor`` is the sum of all non-major counts;
  ``has_min_variability = minor_fraction >= min_variability``;
* returns ``(hk_mask, ld_mask) = (sufficient_data, sufficient_data &
  has_min_variability)``;
* ``max_minor < 1.0`` adds the Rust variant's dominant-minor bound.

Float64 makes the masks bit-exact with the reference at threshold
boundaries (e.g. 36/40 = 0.9 > 0.9 is False in f64).
"""

from __future__ import annotations

import numpy as np

from .encode import N_ALLELES, N_CONCRETE


def site_histogram_host(alignment) -> np.ndarray:
    """``[S, 5]`` per-site allele counts over codes 0..4."""
    alignment = np.asarray(alignment)
    return np.stack(
        [(alignment == s).sum(axis=0) for s in range(N_ALLELES)], axis=1
    )


def site_histogram_host_site_major(codes_sm, n_sites: int, n_seqs: int,
                                   row_chunk: int = 4096) -> np.ndarray:
    """``[n_sites, 5]`` int64 per-site allele counts from a SITE-MAJOR,
    possibly padded, buffer (``sites.py:101-116``), in chunks of site rows
    so the temporaries stay bounded."""
    counts = np.zeros((n_sites, N_ALLELES), dtype=np.int64)
    for lo in range(0, n_sites, row_chunk):
        hi = min(lo + row_chunk, n_sites)
        blk = codes_sm[lo:hi, :n_seqs]
        for c in range(N_ALLELES):
            counts[lo:hi, c] = (blk == c).sum(axis=1)
    return counts


def site_fractions_host(counts, n_seqs: int):
    """Per-site float64 ``(coverage, major, total, minor_fraction)`` from
    ``[S, 5]`` allele counts (``WeightedLD.py:68, 79-87``)."""
    coverage = counts[:, :N_CONCRETE].sum(axis=1) / n_seqs
    major = counts.max(axis=1)
    total = counts.sum(axis=1)
    minor = total - major
    minor_fraction = np.zeros(counts.shape[0], dtype=np.float64)
    nz = minor > 0
    minor_fraction[nz] = minor[nz] / total[nz]   # major + minor == total
    return coverage, major, total, minor_fraction


def compute_variable_sites_host(alignment, min_acgt: float,
                                min_variability: float,
                                max_minor: float = 1.0, counts=None):
    """``(hk_mask, ld_mask)`` boolean site masks (see module docstring)."""
    alignment = np.asarray(alignment)
    n_seqs = alignment.shape[0]
    if counts is None:
        counts = site_histogram_host(alignment)
    return compute_variable_sites_from_counts(
        counts, n_seqs, min_acgt, min_variability, max_minor)


def compute_variable_sites_from_counts(counts, n_seqs: int, min_acgt: float,
                                       min_variability: float,
                                       max_minor: float = 1.0):
    """:func:`compute_variable_sites_host` from a ``[S, 5]`` histogram."""
    counts = np.asarray(counts)
    coverage, major, total, minor_fraction = site_fractions_host(
        counts, n_seqs)
    sufficient_data = coverage > min_acgt
    has_min_variability = minor_fraction >= min_variability

    ld_mask = sufficient_data & has_min_variability
    if max_minor < 1.0:
        nz = total - major > 0
        sorted_counts = np.sort(counts, axis=1)
        dom = sorted_counts[:, -2]
        dom_frac = np.zeros(counts.shape[0], dtype=np.float64)
        dom_frac[nz] = dom[nz] / np.maximum(major[nz] + dom[nz], 1)
        ld_mask = ld_mask & (dom_frac <= max_minor)
    return sufficient_data, ld_mask
