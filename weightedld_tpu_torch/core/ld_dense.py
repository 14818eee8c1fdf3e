"""Single-shot dense all-pairs LD (small / medium S), in PyTorch.

Counterpart of ``LdRecords``, ``ld_all_pairs_dense`` and
``extract_records`` (``weightedld_tpu/core/ld_dense.py:23-82``): the full
``[S, S]`` pair statistics from :func:`..core.paircore.ld_pair_tile`, then
the strict upper triangle of surviving pairs in (site_a, site_b) row-major
order — the reference's loop order (``WeightedLD.py:177-284``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .paircore import PairStats, ld_pair_tile


class LdRecords(NamedTuple):
    """Flat, host-side LD output records (upper triangle, surviving pairs)."""

    pos_a: np.ndarray   # int64 site positions (via site_map)
    pos_b: np.ndarray
    d: np.ndarray
    d_prime: np.ndarray
    r2: np.ndarray

    def __len__(self) -> int:
        return len(self.pos_a)


def ld_all_pairs_dense(alignment: torch.Tensor,
                       weights: torch.Tensor) -> PairStats:
    """All-pairs statistics ``[S, S]`` of an ``[N, S]`` int8 code matrix and
    ``[N]`` weights, on their device (callers take the upper triangle)."""
    return ld_pair_tile(alignment, alignment, weights)


def extract_records(stats: PairStats, site_map: np.ndarray,
                    r2_threshold: float | None = None) -> LdRecords:
    """Strict-upper-triangle surviving pairs as host arrays; with a
    threshold only ``r2 > r2_threshold`` (strict, ``lib.rs:659-667``)."""
    s = stats.d.shape[0]
    iu = torch.triu_indices(s, s, offset=1, device=stats.d.device)
    mask = stats.keep[iu[0], iu[1]]
    if r2_threshold is not None:
        mask = mask & (stats.r2[iu[0], iu[1]] > r2_threshold)
    ia, ib = iu[0][mask], iu[1][mask]
    site_map = np.asarray(site_map)
    ia_h, ib_h = ia.cpu().numpy(), ib.cpu().numpy()
    return LdRecords(
        pos_a=site_map[ia_h],
        pos_b=site_map[ib_h],
        d=stats.d[ia, ib].cpu().numpy(),
        d_prime=stats.d_prime[ia, ib].cpu().numpy(),
        r2=stats.r2[ia, ib].cpu().numpy(),
    )
