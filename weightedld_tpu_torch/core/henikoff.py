"""Henikoff position-based sequence weighting on the host, in float64.

Copy of ``henikoff_weights_host`` from
``weightedld_tpu/core/henikoff.py:69-117``, bit-equal to it and to the
executed reference's ``henikoff_weighting`` (``WeightedLD.py:101-151``):
every step runs in float64 with the reference's operand grouping, including
its quirk that ``unique_base`` is the number of unique ROWS of the 5 x S
count matrix (one global scalar that cancels under max-normalization but
takes part in each rounding).  Ambiguous cells (code 5) take the site's
mean contribution; a site with no concrete allele imputes 0 instead of the
reference's 0/0 NaN.  The weights are max-normalized.

The chunked ``henikoff_weights_large`` path (inputs over 200M cells) is not
ported; ``pipeline`` refuses such inputs.
"""

from __future__ import annotations

import numpy as np

from .encode import N_ALLELES, N_CODES, UNKNOWN


def henikoff_weights_host(alignment) -> np.ndarray:
    """``[N]`` float64 max-normalized Henikoff weights of an ``[N, S]`` int8
    code matrix (see module docstring)."""
    aln = np.asarray(alignment)
    n_sites = aln.shape[1]
    counts = np.stack(
        [(aln == s).sum(axis=0) for s in range(N_CODES)]
    ).astype(np.float64)                                       # [6, S]
    unique_base = float(len(np.unique(counts[:N_ALLELES], axis=0)))
    ok = aln != UNKNOWN
    own = counts[aln, np.arange(n_sites)[None, :]]             # [N, S]
    contrib = np.zeros(aln.shape, dtype=np.float64)
    np.divide(1.0, unique_base * own, out=contrib, where=ok)
    concrete_total = counts[:N_ALLELES].sum(axis=0)            # [S]
    site_avg = np.zeros(n_sites, dtype=np.float64)
    np.divide(contrib.sum(axis=0), concrete_total, out=site_avg,
              where=concrete_total > 0)
    contrib = np.where(ok, contrib, site_avg[None, :])
    weights = contrib.sum(axis=1)
    with np.errstate(invalid="ignore"):
        return weights / weights.max()
