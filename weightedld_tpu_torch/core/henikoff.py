"""Henikoff position-based sequence weighting: float64 on the host, and
torch on a device.

Copies from ``weightedld_tpu/core/henikoff.py``:

* ``henikoff_weights_host`` (``:69-117``): bit-equal to it and to the
  executed reference's ``henikoff_weighting`` (``WeightedLD.py:101-151``):
  every step in float64 with the reference's operand grouping, including
  its quirk that ``unique_base`` is the number of unique ROWS of the 5 x S
  count matrix (one global scalar that cancels under max-normalization but
  takes part in each rounding);
* ``henikoff_weights_host_site_major`` (``:207-260``): the same from a
  site-major buffer, chunked over site rows, bit-equal to the JAX function;
* ``henikoff_weights_paper`` (``:153-163``), ``_henikoff_partial_sums``
  (``:166-189``, both formulas), ``henikoff_weights_site_major``
  (``:192-228``) and ``henikoff_weights_large`` (``:289-307``, both
  formulas): plain torch ops on a device (XLA glue in the JAX package, not
  kernels).  The cell arithmetic runs in float32 as in JAX, with the
  one-hot selects of JAX in place of a gather; the per-sequence sums over
  sites accumulate in float64 and every variant is chunked over sites, so
  device memory stays bounded.  They are held to the host weights, and
  the ``paper`` weights to the JAX package's float32 ones, at a
  tolerance, not bits.

The ``paper`` formula is the Henikoff 1994 paper's, as the reference's Rust
binary computes it (``lib.rs:340-380``): per-site contribution ``1 /
(distinct_known * count[own symbol])`` with the per-site count of distinct
concrete symbols, and unknown cells imputed with ``site_total /
distinct_known``.

Ambiguous cells (code 5) take the site's mean contribution; a site with no
concrete allele imputes 0 instead of the reference's 0/0 NaN.  The weights
are max-normalized.
"""

from __future__ import annotations

import numpy as np
import torch

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


def henikoff_weights_host_site_major(codes_sm, n_sites: int, n_seqs: int,
                                     row_chunk: int = 4096) -> np.ndarray:
    """``[n_seqs]`` float64 weights from a SITE-MAJOR, possibly padded,
    buffer whose column ``k`` is alignment row ``k``: the arithmetic of
    :func:`henikoff_weights_host`, the global ``unique_base`` included, with
    the per-sequence totals accumulated over ``row_chunk``-site chunks, so
    they can differ from the whole-array sums in the last f64 ulp or two."""
    from .sites import site_histogram_host_site_major

    codes_sm = np.asarray(codes_sm)
    counts_all = site_histogram_host_site_major(
        codes_sm, n_sites, n_seqs, row_chunk=row_chunk)        # [S, 5]
    unique_base = float(
        len(np.unique(counts_all.T.astype(np.float64), axis=0)))
    total = np.zeros(n_seqs, dtype=np.float64)
    for lo in range(0, n_sites, row_chunk):
        hi = min(lo + row_chunk, n_sites)
        blk = codes_sm[lo:hi, :n_seqs]                         # [B, N] int8
        b = hi - lo
        cnt = np.stack(
            [(blk == c).sum(axis=1) for c in range(N_CODES)], axis=1
        ).astype(np.float64)                                   # [B, 6]
        ok = blk != UNKNOWN
        own = cnt[np.arange(b)[:, None], blk]                  # [B, N]
        contrib = np.zeros(blk.shape, dtype=np.float64)
        np.divide(1.0, unique_base * own, out=contrib, where=ok)
        concrete = cnt[:, :N_ALLELES].sum(axis=1)              # [B]
        site_avg = np.zeros(b, dtype=np.float64)
        np.divide(contrib.sum(axis=1), concrete, out=site_avg,
                  where=concrete > 0)
        contrib = np.where(ok, contrib, site_avg[:, None])
        total += contrib.sum(axis=0)
    with np.errstate(invalid="ignore"):
        return total / total.max()


def _henikoff_partial_sums(alignment: torch.Tensor,
                           variant: str = "python") -> torch.Tensor:
    """``[N]`` float64 un-normalized contribution sums of one site chunk
    ``[N, S]`` of int8 codes (any strides).  Both formulas are per-site
    additive, so chunking over sites is exact; ``python`` leaves out the
    global ``unique_base``, since it cancels under the max-normalization,
    and ``paper`` is the per-site formula of the module docstring."""
    counts = torch.stack([(alignment == c).sum(dim=0)
                          for c in range(N_CODES)]).float()      # [6, S]
    own = sum(counts[c][None, :] * (alignment == c)
              for c in range(N_CODES))                           # [N, S]
    ok = alignment != UNKNOWN
    zero = torch.zeros((), device=alignment.device)
    if variant == "paper":
        distinct = (counts[:N_ALLELES] > 0).sum(dim=0).float()   # [S]
        contrib = torch.where(ok, 1.0 / (distinct * own).clamp(min=1.0),
                              zero)
        imputed = contrib.sum(dim=0) / distinct.clamp(min=1.0)
        contrib = torch.where(ok, contrib, imputed[None, :])
        return contrib.sum(dim=1, dtype=torch.float64)
    contrib = torch.where(ok, 1.0 / own.clamp(min=1.0), zero)
    concrete = counts[:N_ALLELES].sum(dim=0)                     # [S]
    site_avg = contrib.sum(dim=0) / concrete.clamp(min=1.0)
    contrib = torch.where(ok, contrib, site_avg[None, :])
    return contrib.sum(dim=1, dtype=torch.float64)


def henikoff_weights_site_major(codes_sm: torch.Tensor, n_seqs: int,
                                site_chunk: int = 16384) -> torch.Tensor:
    """``[N_pad]`` float32 weights on ``codes_sm``'s device from the ``[S_pad,
    N_pad]`` site-major buffer a session uploaded (UNKNOWN padding on both
    axes).  Padded sites have no concrete allele and contribute nothing;
    padded sequences would take the imputed site means, so rows ``>=
    n_seqs`` are zeroed before the max."""
    total = torch.zeros(codes_sm.shape[1], dtype=torch.float64,
                        device=codes_sm.device)
    for lo in range(0, codes_sm.shape[0], site_chunk):
        total += _henikoff_partial_sums(codes_sm[lo:lo + site_chunk].T)
    total[n_seqs:] = 0.0
    return (total / total.max()).float()


def henikoff_weights_large(alignment: np.ndarray, site_chunk: int = 16384,
                           device: str | torch.device | None = None,
                           variant: str = "python") -> torch.Tensor:
    """``[N]`` float32 weights of a host ``[N, S]`` alignment, computed on
    ``device`` (default cuda) one ``site_chunk`` of sites at a time, so
    device memory holds one chunk: the weighting of inputs too large for
    the host float64 path, and of every ``paper`` weighting.  The result
    stays on ``device``."""
    from ..device import resolve_device

    if variant not in ("python", "paper"):
        raise ValueError(
            f"variant must be 'python' or 'paper', got {variant!r}")
    dev = resolve_device(device)
    n, s = alignment.shape
    total = torch.zeros(n, dtype=torch.float64, device=dev)
    for lo in range(0, s, site_chunk):
        chunk = np.ascontiguousarray(alignment[:, lo:lo + site_chunk])
        total += _henikoff_partial_sums(torch.from_numpy(chunk).to(dev),
                                        variant)
    return (total / total.max()).float()


def henikoff_weights_paper(alignment: np.ndarray,
                           device: str | torch.device | None = None,
                           ) -> torch.Tensor:
    """``[N]`` float32 max-normalized weights of the ``paper`` formula (the
    reference's Rust variant, module docstring), computed on ``device``
    (default cuda), where they stay."""
    return henikoff_weights_large(alignment, device=device, variant="paper")
