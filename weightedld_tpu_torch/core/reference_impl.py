"""Audit engine: loop-based float64 NumPy implementation of the exact
reference semantics (``WeightedLD.py``), per-pair ``np.unique`` and all.

Host copy of ``weightedld_tpu/core/reference_impl.py:1-132`` (numpy only).
Purpose: an exact-f64 cross-check for small inputs (``--engine
reference``) and an executable spec for the tests.  O(S^2 * N) Python: use
it only for audits; the dense engine and the tiled session are the compute
path.
"""

from __future__ import annotations

import numpy as np


def reference_variable_sites(alignment, min_acgt, min_variability):
    n_seqs, n_sites = alignment.shape
    hk = np.zeros(n_sites, dtype=bool)
    ld = np.zeros(n_sites, dtype=bool)
    for j in range(n_sites):
        col = alignment[:, j]
        concrete = np.count_nonzero(col < 4) / n_seqs
        sufficient = concrete > min_acgt
        counts = np.array([np.count_nonzero(col == s) for s in range(5)])
        major = counts.max()
        minor = counts.sum() - major
        frac = minor / (major + minor) if minor > 0 else 0.0
        hk[j] = sufficient
        ld[j] = sufficient and frac >= min_variability
    return hk, ld


def reference_henikoff(alignment):
    n_seqs, n_sites = alignment.shape
    counts = np.zeros((6, n_sites))
    for s in range(6):
        counts[s] = (alignment == s).sum(axis=0)
    unique_base = len(np.unique(counts[:5], axis=0))

    contrib = np.zeros((n_seqs, n_sites))
    for i in range(n_seqs):
        for j in range(n_sites):
            sym = alignment[i, j]
            if sym != 5:
                contrib[i, j] = 1.0 / (unique_base * counts[sym, j])
    site_total = contrib.sum(axis=0)
    concrete_total = counts[:5].sum(axis=0)
    for i in range(n_seqs):
        for j in range(n_sites):
            if alignment[i, j] == 5:
                contrib[i, j] = site_total[j] / concrete_total[j]
    w = contrib.sum(axis=1)
    return w / w.max()


def reference_pair(col_a, col_b, weights):
    """LD stats for one site pair, or None if the pair is skipped."""
    good = (col_a < 5) & (col_b < 5)
    a, b, w = col_a[good], col_b[good], weights[good]
    if a.size == 0:
        return None

    majs, dmins = [], []
    for col in (a, b):
        uniq, counts = np.unique(col, return_counts=True)
        if len(uniq) <= 1:
            return None
        order = np.argsort(-counts, kind="stable")
        majs.append(uniq[order[0]])
        dmins.append(uniq[order[1]])

    is_maj_a, is_maj_b = a == majs[0], b == majs[1]
    keep = (is_maj_a | (a == dmins[0])) & (is_maj_b | (b == dmins[1]))
    a, b, w = a[keep], b[keep], w[keep]
    is_maj_a, is_maj_b = is_maj_a[keep], is_maj_b[keep]
    if w.size == 0:
        return None
    # No surviving major carrier at a site makes the reference's masked
    # PA/PB sum a MaskedConstant and its round(PA, 1) raise TypeError
    # (WeightedLD.py:227-235): such pairs have no defined output — skip.
    if not is_maj_a.any() or not is_maj_b.any():
        return None

    total = w.sum()
    pa_major = w[is_maj_a].sum() / total
    pb_major = w[is_maj_b].sum() / total
    pa_minor = w[~is_maj_a].sum() / total
    pb_minor = w[~is_maj_b].sum() / total
    # pa_major MUST stay a np.float64 here: np.float64.__round__ scales by
    # 10 before rounding, so round(double(0.95), 1) == 1.0 and the exact
    # PA == 19/20 boundary pair is skipped, matching the reference (whose
    # PA is also a np.float64).  Converting to a Python float first would
    # flip the boundary (float round(0.95, 1) == 0.9 — decimal-correct).
    if round(pa_major, 1) == 1.0 or round(pb_major, 1) == 1.0:
        return None

    obs_mm = w[is_maj_a & is_maj_b].sum() / total
    obs_md = w[is_maj_a & ~is_maj_b].sum() / total
    obs_dm = w[~is_maj_a & is_maj_b].sum() / total
    obs_dd = w[~is_maj_a & ~is_maj_b].sum() / total

    t0 = pa_major * pb_major - obs_mm
    t1 = pa_minor * pb_minor - obs_dd
    t2 = -(pa_major * pb_minor - obs_md)
    t3 = -(pa_minor * pb_major - obs_dm)
    d = (t0 + t1 + t2 + t3) / 4.0

    if d < 0:
        denom = max(-obs_dd, -obs_mm)
        if denom == 0:
            denom = min(-obs_dd, -obs_mm)
    else:
        denom = min(obs_dm, obs_md)
        if denom == 0:
            denom = max(obs_dm, obs_md)
    with np.errstate(divide="ignore", invalid="ignore"):
        d_prime = d / denom if denom != 0 else np.float64(np.inf) * np.sign(d)
        r2 = d * d / (pa_major * pa_minor * pb_major * pb_minor)
    return float(d), float(d_prime), float(r2)


def reference_ld(alignment, weights, site_map=None):
    """All-pairs oracle. Returns list of (pos_a, pos_b, D, D', r2)."""
    n_sites = alignment.shape[1]
    if site_map is None:
        site_map = np.arange(n_sites)
    out = []
    weights = np.asarray(weights, dtype=np.float64)
    for i in range(n_sites - 1):
        for j in range(i + 1, n_sites):
            res = reference_pair(alignment[:, i], alignment[:, j], weights)
            if res is not None:
                out.append((int(site_map[i]), int(site_map[j])) + res)
    return out
